// Fused DenseNet layer, f32, for NVIDIA Hopper (sm_90a), in both forms of
// the Pallas kernels: fused_dense_taps_f32 and fused_dense_eo_f32.
//
// Replaces the Pallas TPU kernels fused_dense_layer (docs/archive/
// fused_dense.py:167, body _kernel_taps :84) and fused_dense_layer_eo (:216,
// body _kernel_eo :109) in f32, the dtype cli.test serves by default
// (--compute_dtype float32). Both compute one torchvision dense layer with
// the BatchNorms folded, at the rounding points of ops/fused_dense.py::
// fused_dense_reference and fused_dense_eo_reference:
//   y = relu(x*s1 + b1);  t = y . w1;  z = relu(t*s2 + b2), 0 at a halo pixel
//   outside the image;  out = sum over the 3x3 taps of z . w2.
// The eo form takes the even and odd columns (xe, xo) and the packed w2q
// (3, 4*Cmid, 2G): per kernel row dh, one product of [zo[u-1], ze[u], zo[u],
// ze[u+1]] with w2q[dh] gives output columns 2u and 2u+1, every block of w2q
// multiplied (fused_dense_taps_sm90.cu, the bf16 kernels, says more).
//
// Numerics: 3xTF32. One TF32 product keeps 10 mantissa bits, too few for f32.
// Each operand a is split into big = tf32_rna(a) and small = tf32_rna(a - big);
// every k step issues three wgmma .tf32 products, small.big + big.small +
// big.big (small.small, about 2^-22 relative, is dropped). B (w1, w2 or w2q)
// comes split from DenseLayer.folded (ops/fused_dense.py::pack_taps_kmajor,
// pack_eo_kmajor); A is split in registers (cvt.rna.tf32.f32, a subtract,
// cvt again). Promotion: the tensor cores' chained accumulation does not
// round to nearest, and over the hundreds of chained products of one output
// its error came close to the f32 tolerance, far above that of the same
// split summed in f32. So a run of chained wgmmas starts a fresh sum, which
// is then added, rounded to nearest, into the layer's f32 sum: every ring
// slot (taps 12 wgmmas, eo 12) in stage 2, in registers; every kPromote1
// slots (48 wgmmas) in stage 1, in the bottleneck tile's space (free until
// stage 1's epilogue; promoting at every slot there was clearly slower).
//
// Bound. Three TF32 products for each f32 one: 494.7 / 3 = 165 TFLOP/s of
// f32-accurate work on an H100 SXM, against 67 TFLOP/s for FMAs. At
// DenseNet161's shapes the layer is bound by these operations (C*192 +
// 9*192*48 MACs per pixel against 4*(C + 48) bytes; eo 12*192*48 for the
// 3x3).
//
// Taps design (tile and shared memory). f32 doubles every byte of the bf16
// design, whose 8x16 tile needs a 192 x 192 bottleneck tile: 144 KB in f32,
// plus 72 KB for one ring stage of x and w1 big and small. So the tile is
// 8 x 8 outputs:
// - halo 10 x 10 = 100 bottleneck pixels, computed as 128 rows (2 x 64, the
//   wgmma M; rows 100-127 are never stored); the 1x1 is recomputed for 1.56x
//   the pixels (2x counting the padding). CTAs at 480x640 input, per image:
//   300, 80, 20 and 6 for blocks 1-4 (x8 at batch 8).
// - Small grids. Where the tiles would fill at most a quarter of the SMs (on
//   an H100 at 480x640: blocks 3-4 at batch 1), a cluster of three CTAs
//   shares each tile (SPLIT = 3), as in the bf16 kernel: CTA r computes
//   bottleneck channels [64r, 64r + 64) for the whole halo, stores them into
//   the bottleneck tile of all three CTAs through distributed shared memory,
//   and after a cluster barrier computes output channels [16r, 16r + 16)
//   from the whole tile. Its stage-1 slot is 32 KB (4 slots), its stage-2
//   slot one tap's 192 channels (6 K blocks, 24 KB).
// - Stage-1 ring slot (K chunk of 32 channels, one 128-byte swizzle row):
//   x 128 rows x 128 B = 16 KB (the TMA box writes 100 rows) + w1 big and
//   small, Cmid x 128 B each = 2 x 24 KB: 64 KB. Two slots: 128 KB.
// - Bottleneck tile z in f32: 100 rows x (Cmid + 4) floats = 78,400 B (the 4
//   floats of padding put the 8 rows a warp reads on distinct banks).
// - Stage-2 ring: 4 slots over the stage-1 ring's memory (the producer waits
//   until both stage-1 slots are free), each one tap's w2 for 64 channels,
//   2 K blocks x (big, small) x G x 128 B = 24 KB (G 48).
// - s2, b2 1.5 KB, 12 mbarriers, up to 1 KB to align the ring to 1024 bytes:
//   212,128 bytes of the 232,448 (Cmid 192, G 48); Cmid 128, G 32: 160,320.
// - Warp roles: 2 consumer warpgroups (256 threads) and one producer
//   warpgroup, whose one thread issues every TMA load (setmaxnreg: 40 and 232
//   a thread, 2 * 232 + 40 <= 512). There is no __syncthreads inside either K
//   loop: slots are tracked by mbarriers (full: one arrive + the bytes;
//   empty: one arrive per consumer warp).
// - Stage 1 (M = 128 halo rows, N = Cmid, K = C): consumer warpgroup wg owns
//   halo rows [64 wg, 64 wg + 64). Each thread reads its A elements from the
//   swizzled x slot (ld.shared, conflict-free), applies BN1 and ReLU, splits
//   them, and issues m64nCmidk8 wgmmas with A from registers.
// - Stage-1 epilogue: BN2, ReLU and the out-of-image mask (per row) turn
//   the promoted sums into z in place.
// - Stage 2 (M = 64 outputs, N = G, K = 9 taps x Cmid): A again from
//   registers (a one-pixel shift is not a wgmma descriptor), gathered from
//   the shifted rows of z; warpgroup wg takes the K blocks wg, wg + 2, ...
//   of each slot, so the two warpgroups split K. Their partial sums meet in
//   z's space, are added and stored as 16-byte vectors.
//
// Eo design. An eo tile of 64 column pairs (8 rows x 8 pairs, as the bf16
// kernel's, so the 3x3's wgmma has all 64 rows) needs a halo of 180
// bottleneck pixels (ze[u0 .. u0+8] and zo[u0-1 .. u0+7] of 10 rows): 141 KB
// of f32 z for 192 channels, more than fits beside a ring. So a cluster of
// SPLIT CTAs shares each tile and splits K instead of N. SPLIT is 2, 3 where
// the tiles fill at most a quarter of the SMs (as the taps split), and 6
// where they fill at most a sixth; on an H100 at 480x640: 2 for blocks 1-3
// at batch 8 and blocks 1-2 at batch 1, 3 for block 4 at batch 8, 6 for
// blocks 3-4 at batch 1; DenseNet121's Cmid 128 always 2. (On an H100, at
// block 4, batch 8, SPLIT 6's 192 CTAs, two waves, measured slower than
// SPLIT 3; at block 2, batch 1, SPLIT 3's 120 CTAs slower than SPLIT 2's 80.)
// - CTA r computes bottleneck channels [r, r + 1) * Cmid / SPLIT of the whole
//   halo (M = 192 rows: ze's 90 at rows 0-89 and zo's at 96-185, two TMA
//   boxes, the second 1024-byte aligned; three consumer warpgroups) and keeps
//   them: z is 186 rows x (Cmid / SPLIT + 4) floats (74,400 B at SPLIT 2).
//   The 1x1 is recomputed for 1.41x the pixels (1.5x counting the padding),
//   against taps' 1.56x (2x).
// - Stage 2 (M = 64 pairs, N = 2G, K = 4 blocks x its Cmid / SPLIT
//   channels): warpgroup wg runs kernel row dh = wg; a stage-2 slot holds
//   one 32-channel K block of w2q[dh] big and small for the three dh (72 KB
//   at 2G = 96; 2 slots).
// - Epilogue: after a cluster barrier (every ring is free), each warpgroup
//   stores its promoted partial sums for output channels [j, j + 1) * 2G /
//   SPLIT into CTA j's ring space through distributed shared memory; after a
//   second barrier CTA j adds the 3 x SPLIT sums and stores its channels as
//   16-byte vectors (at SPLIT 2: CTA 0 the even columns, CTA 1 the odd).
// - Stage-1 ring: slots of x (24 KB) and w1 big and small (2 x Cmid /
//   SPLIT rows): 3 of 48 KB at SPLIT 2, 4 otherwise. 3 consumer warpgroups
//   at 152 registers (3 * 152 + 40 <= 512). Shared memory at (192, 48),
//   SPLIT 2: 224,496 bytes; SPLIT 3: 217,088; SPLIT 6: 176,896.
//
// Limits (the wrapper checks them too): (Cmid, G) = (192, 48) or (128, 32);
// C % 4 == 0; x channels contiguous, pixel strides multiples of 4 elements,
// x 16-byte aligned; out likewise (16-byte stores). w1s is (2, Cmid, C), w2s
// (2, 3, 3, G, Cmid) and, for eo, w2qs (2, 3, 2G, 4 Cmid): [0] big, [1]
// small, K-major, contiguous. Every launch returns the first CUDA error met.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kTH = 8, kTW = 8;                   // taps output tile
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kHaloP = kHaloH * kHaloW;           // 100 bottleneck pixels
constexpr int kPairs = 8;                         // eo: 8 rows x 8 column pairs
constexpr int kEoW = kPairs + 1;                  // eo: halo entries per parity and row
constexpr int kEoBox = kHaloH * kEoW;             // eo: 90 rows of one parity
constexpr int kOddRow = 96;                       // eo: first row of zo, 1024-byte aligned
constexpr int kM2 = 64;                           // outputs (eo: column pairs)
constexpr int kProducerRegs = 40;
constexpr int kKC = 32;                           // K chunk: 128 bytes, one swizzle row
constexpr int kRowB = kKC * 4;
constexpr int kPromote1 = 4;                      // stage-1 slots per promotion
static_assert(kTH * kTW == kM2 && kTH * kPairs == kM2 && kOddRow * kRowB % 1024 == 0 &&
                  kEoBox <= kOddRow,
              "tile geometry");

// Taps: SPLIT CTAs (a cluster) share one tile: CTA `rank` computes bottleneck
// channels [rank, rank + 1) * Cmid / SPLIT and output channels
// [rank, rank + 1) * G / SPLIT. Eo: CTA `rank` computes bottleneck channels
// [rank, rank + 1) * Cmid / SPLIT, the 3x3's K over them, and stores output
// channels [rank, rank + 1) * 2G / SPLIT.
template <int CMID, int G, int SPLIT, bool EO>
struct Cfg {
  static constexpr int kWGs = EO ? 3 : 2;                // consumer warpgroups
  static constexpr int kConsumers = kWGs * 128;
  static constexpr int kConsumerWarps = kConsumers / 32; // arrivals that free a slot
  static constexpr int kThreads = kConsumers + 128;      // + the producer warpgroup
  static constexpr int kConsumerRegs = EO ? 152 : 232;
  static constexpr int kM1 = 64 * kWGs;                  // halo rows as wgmma rows
  static constexpr int kZRows = EO ? kOddRow + kEoBox : kHaloP;  // rows of z
  static constexpr int kN1 = CMID / SPLIT;               // stage-1 N of this CTA
  static constexpr int kN2 = EO ? 2 * G : G / SPLIT;     // stage-2 N of this CTA
  static constexpr int kOut = EO ? 2 * G / SPLIT : kN2;  // output channels it stores
  static constexpr int kStages1 = EO ? (SPLIT == 2 ? 3 : 4) : (SPLIT == 1 ? 2 : 4);
  static constexpr int kStages2 = EO ? 2 : 4;            // stage-2 ring slots
  static constexpr int kXBytes = kM1 * kRowB;            // x chunk, kM1 rows
  static constexpr int kXTx = (EO ? 2 * kEoBox : kHaloP) * kRowB;  // what the x boxes write
  static constexpr int kW1Bytes = kN1 * kRowB;           // w1 chunk, big or small
  static constexpr int kSlot1 = kXBytes + 2 * kW1Bytes;
  // 32-channel K blocks a stage-2 slot (eo: of each dh)
  static constexpr int kKB2 = EO ? 1 : (SPLIT == 1 ? 2 : 6);
  static constexpr int kW2Bytes = kN2 * kRowB;           // w2 K block of one tap or dh, big or small
  static constexpr int kSlot2 = (EO ? 3 : 1) * 2 * kKB2 * kW2Bytes;  // K blocks x (big, small)
  static constexpr int kGroups2 = CMID / (kKB2 * kKC);   // taps: stage-2 slots per tap
  static constexpr int kBlocks2 = kN1 / kKC;             // eo: slots per block of w2q's K
  static constexpr int kSlots2 = EO ? 4 * kBlocks2 : 9 * kGroups2;
  static constexpr int kRing = kStages1 * kSlot1 > kStages2 * kSlot2 ? kStages1 * kSlot1
                                                                     : kStages2 * kSlot2;
  static constexpr int kZStride = (EO ? kN1 : CMID) + 4; // floats per bottleneck row
  static constexpr int kZ = kRing;                       // bottleneck tile offset
  static constexpr int kS2 = kZ + kZRows * kZStride * 4; // s2, b2
  static constexpr int kBar = kS2 + 2 * CMID * 4;        // full1, empty1, full2, empty2
  static constexpr int kBytes = kBar + 2 * (kStages1 + kStages2) * 8;
  static constexpr int kAlloc = kBytes + 1024;           // + alignment of the ring
  static_assert(kWGs * kConsumerRegs + kProducerRegs <= 512, "register files");
  static_assert(EO || kStages2 * kSlot2 <= kStages1 * kSlot1, "stage 2's ring fits stage 1's");
  static_assert(EO || kWGs * kM2 * kN2 <= kHaloP * kZStride,
                "stage-2 sums fit the bottleneck tile");
  static_assert(!EO || (SPLIT >= 2 && kWGs * SPLIT * kM2 * kOut * 4 <= kRing),
                "eo: the cluster's stage-2 sums fit the ring");
  static_assert(kXBytes % 1024 == 0 && kW1Bytes % 1024 == 0 && kW2Bytes % 1024 == 0 &&
                    kSlot1 % 1024 == 0 && kSlot2 % 1024 == 0,
                "128-byte swizzle atoms stay 1024-byte aligned");
  static_assert(CMID % (kKB2 * kKC) == 0 && (EO || kKB2 % kWGs == 0) && kN1 % kKC == 0 &&
                    kN2 % 8 == 0 && kOut % 4 == 0 && G % 4 == 0 && kBar % 8 == 0 &&
                    kAlloc <= 232448,
                "shapes");
};

struct TapsParams {
  CUtensorMap x;   // 4-D (C, W, H, B), box (32, 10, 10, 1); eo: over xe (C, U, H, B), box (32, 9, 10, 1)
  CUtensorMap xo;  // eo: over xo, as xe
  CUtensorMap w1;  // 2-D (C, 2 Cmid) over w1s, box (32, Cmid / SPLIT)
  CUtensorMap w2;  // 2-D (Cmid, 18 G) over w2s, box (32, G / SPLIT); eo: (4 Cmid, 12 G), box (32, 2G)
  const float *s1, *b1, *s2, *b2;
  float* out;
  int64_t so[4];   // out strides (b, h, w) in elements; eo: (b, h, u, parity)
  int H, W, C, tiles_h, tiles_w;  // eo: W is U, the column pairs
};

#define ACC8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 192, f32) += A (64 x 8 tf32, registers) * B (8 x 192 tf32, shared).
__device__ __forceinline__ void wgmma(float (&d)[96], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56),
        ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x 128) += A (64 x 8) * B (8 x 128).
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x 96) += A (64 x 8) * B (8 x 96).
__device__ __forceinline__ void wgmma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x 48) += A (64 x 8) * B (8 x 48).
__device__ __forceinline__ void wgmma(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x 32) += A (64 x 8) * B (8 x 32).
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x 64) += A (64 x 8) * B (8 x 64).
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D (64 x 16) += A (64 x 8) * B (8 x 16).
__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// big = tf32_rna(v), small = tf32_rna(v - big).
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// D (+)= A * B in 3xTF32 for one k step, the two small products first; D
// is overwritten, not added to, when scale_d is 0.
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], uint64_t bb, uint64_t bs,
                                       int scale_d) {
  wgmma(d, as, bb, scale_d);
  wgmma(d, ab, bs, 1);
  wgmma(d, ab, bb, 1);
}

// Is halo row r a row of z (taps: one of the 100 pixels; eo: of ze's or zo's 90)?
template <bool EO>
__device__ __forceinline__ bool z_row(int r) {
  return EO ? r < kEoBox || (r >= kOddRow && r < kOddRow + kEoBox) : r < kHaloP;
}

template <int CMID, int G, int SPLIT, bool EO>
__global__ void __launch_bounds__(Cfg<CMID, G, SPLIT, EO>::kThreads, 1)
    taps_f32_kernel(const __grid_constant__ TapsParams p) {
  using K = Cfg<CMID, G, SPLIT, EO>;
  constexpr int kStages1 = K::kStages1, kStages2 = K::kStages2;
  constexpr int kN1 = K::kN1, kN2 = K::kN2, kKB2 = K::kKB2, kWGs = K::kWGs;
  constexpr int kConsumers = K::kConsumers;
  // z holds this CTA's kN1 channels (eo) or all of them (taps).
  const int zcol0 = EO ? 0 : (SPLIT > 1 ? static_cast<int>(cluster_rank()) : 0) * kN1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* zs = reinterpret_cast<float*>(smem + K::kZ);
  float* s2s = reinterpret_cast<float*>(smem + K::kS2);
  float* b2s = s2s + CMID;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(smem + K::kBar);
  uint64_t* empty1 = full1 + kStages1;
  uint64_t* full2 = empty1 + kStages1;
  uint64_t* empty2 = full2 + kStages2;

  // Tile origin: row oy0, column ox0 (eo: column pair ox0).
  int blk = blockIdx.x / SPLIT;
  const int rank = SPLIT > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int ox0 = (blk % p.tiles_w) * (EO ? kPairs : kTW);
  blk /= p.tiles_w;
  const int oy0 = (blk % p.tiles_h) * kTH;
  const int b = blk / p.tiles_h;
  const int nk1 = (p.C + kKC - 1) / kKC;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], K::kConsumerWarps);
    }
    for (int s = 0; s < kStages2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], K::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < CMID; i += K::kThreads) {
    s2s[i] = p.s2[i];
    b2s[i] = p.b2[i];
  }
  if constexpr (SPLIT > 1) {  // every CTA of the cluster has started
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  if (tid >= kConsumers) {  // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      for (int kc = 0; kc < nk1; ++kc) {
        const int s = kc % kStages1;
        mbar_wait(&empty1[s], ((kc / kStages1) & 1) ^ 1);
        uint8_t* slot = smem + s * K::kSlot1;
        mbar_expect_tx(&full1[s], K::kXTx + 2 * K::kW1Bytes);
        if constexpr (EO) {  // ze[u0 ..], zo[u0 - 1 ..]
          tma_load_4d(slot, &p.x, &full1[s], kc * kKC, ox0, oy0 - 1, b);
          tma_load_4d(slot + kOddRow * kRowB, &p.xo, &full1[s], kc * kKC, ox0 - 1, oy0 - 1, b);
        } else {
          tma_load_4d(slot, &p.x, &full1[s], kc * kKC, ox0 - 1, oy0 - 1, b);
        }
        tma_load_2d(slot + K::kXBytes, &p.w1, &full1[s], kc * kKC, rank * kN1);
        tma_load_2d(slot + K::kXBytes + K::kW1Bytes, &p.w1, &full1[s], kc * kKC,
                    CMID + rank * kN1);
      }
      // The taps cluster barrier after stage 1 counts every thread; the
      // producer arrives before it waits for stage-2 slots the consumers free
      // after it.
      if (SPLIT > 1 && !EO) cluster_arrive_thread();
      // Stage 2's ring reuses stage 1's memory: wait until every slot is free.
      for (int kc = nk1; kc < nk1 + kStages1; ++kc) {
        mbar_wait(&empty1[kc % kStages1], ((kc / kStages1) & 1) ^ 1);
      }
      for (int q = 0; q < K::kSlots2; ++q) {
        const int s = q % kStages2;
        mbar_wait(&empty2[s], ((q / kStages2) & 1) ^ 1);
        uint8_t* slot = smem + s * K::kSlot2;
        mbar_expect_tx(&full2[s], K::kSlot2);
        if constexpr (EO) {
          // K block kb of w2q[dh] (channels [rank, rank + 1) * kN1 of block
          // q / kBlocks2), big and small, for the three dh
          const int k0 = (q / K::kBlocks2) * CMID + rank * kN1 + (q % K::kBlocks2) * kKC;
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
            for (int part = 0; part < 2; ++part) {
              tma_load_2d(slot + (2 * dh + part) * K::kW2Bytes, &p.w2, &full2[s], k0,
                          (part * 3 + dh) * 2 * G);
            }
          }
        } else {
          const int tap = q / K::kGroups2, cg = q % K::kGroups2;
#pragma unroll
          for (int kb = 0; kb < kKB2; ++kb) {
#pragma unroll
            for (int part = 0; part < 2; ++part) {
              tma_load_2d(slot + (2 * kb + part) * K::kW2Bytes, &p.w2, &full2[s],
                          (kKB2 * cg + kb) * kKC, (part * 9 + tap) * G + rank * kN2);
            }
          }
        }
      }
    } else if (SPLIT > 1 && !EO) {
      cluster_arrive_thread();
    }
    if constexpr (EO) {  // the two cluster barriers of the eo epilogue count every thread
      __syncwarp();
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
    }
    return;
  }

  // ---- consumers: warpgroup wg, warp w of it, lane l ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(K::kConsumerRegs));
  const int wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  {  // Stage 1: bottleneck channels [rank, rank + 1) * kN1 of halo rows
     // [64 wg, 64 wg + 64).
    float acc[kN1 / 2];  // products since the last promotion; their sum is in z's space
#pragma unroll
    for (int i = 0; i < kN1 / 2; ++i) acc[i] = 0.f;
    const int r0 = wg * 64 + w * 16 + g;  // A rows r0 and r0 + 8; r0 % 8 == g
    for (int kc = 0; kc < nk1; ++kc) {
      const int s = kc % kStages1;
      // s1, b1 of the channels this thread holds: [k8 step][t, t + 4]
      float sc[4][2], bc[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = kc * kKC + 8 * j + 4 * h + t;
          const bool in = c < p.C;
          sc[j][h] = in ? __ldg(p.s1 + c) : 0.f;
          bc[j][h] = in ? __ldg(p.b1 + c) : 0.f;
        }
      }
      mbar_wait(&full1[s], (kc / kStages1) & 1);
      const uint8_t* xs = smem + s * K::kSlot1;
      // A fragment of k step j: [0] (r0, t), [1] (r0 + 8, t), [2] (r0, t + 4),
      // [3] (r0 + 8, t + 4); column c of row r sits in 16-byte chunk
      // (c / 4) ^ (r % 8) of the swizzled row.
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = *reinterpret_cast<const float*>(
                xs + (r0 + 8 * e) * kRowB + (((2 * j + h) ^ g) << 4) + 4 * t);
            const float y = fmaxf(__fadd_rn(__fmul_rn(v, sc[j][h]), bc[j][h]), 0.f);
            split(y, ab[j][e + 2 * h], as[j][e + 2 * h]);
          }
        }
      }
      const uint32_t wb = smem_u32(xs + K::kXBytes), ws = wb + K::kW1Bytes;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma3(acc, ab[j], as[j], desc_sw128(wb + 32 * j), desc_sw128(ws + 32 * j),
               j > 0 || kc % kPromote1 > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep(ab[j]);
        keep(as[j]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty1[s]);
      if (kc % kPromote1 < kPromote1 - 1 && kc < nk1 - 1) continue;
      // Promotion: the run's sum joins the layer's in z's space (rows that are
      // no halo pixel are dropped), rounded to nearest in f32.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!z_row<EO>(r0 + 8 * e)) continue;
        float* row = zs + (r0 + 8 * e) * K::kZStride + zcol0 + 2 * t;
#pragma unroll
        for (int i = 0; i < kN1 / 8; ++i) {
          float2* sum = reinterpret_cast<float2*>(row + 8 * i);
          const float2 before = kc >= kPromote1 ? *sum : make_float2(0.f, 0.f);
          *sum = make_float2(before.x + acc[4 * i + 2 * e], before.y + acc[4 * i + 2 * e + 1]);
        }
      }
    }

    // Epilogue: z = relu(t*s2 + b2) in place of t, 0 on rows outside the
    // image; with the taps SPLIT, into the tile of every CTA of the cluster.
    // Each thread reads only its own elements.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e;
      if (!z_row<EO>(r)) continue;
      bool in;
      if constexpr (EO) {  // entry i of parity odd's box: halo row i / 9, pair column
        const int odd = r >= kOddRow, i = r - odd * kOddRow;
        const int gy = oy0 - 1 + i / kEoW, gu = ox0 - odd + i % kEoW;
        in = gy >= 0 && gy < p.H && gu >= 0 && gu < p.W;
      } else {
        const int gy = oy0 - 1 + r / kHaloW, gx = ox0 - 1 + r % kHaloW;
        in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      }
      float* zrow = zs + r * K::kZStride + zcol0 + 2 * t;
#pragma unroll
      for (int i = 0; i < kN1 / 8; ++i) {
        const int c = rank * kN1 + 8 * i + 2 * t;
        float2* z = reinterpret_cast<float2*>(zrow + 8 * i);
        const float2 tv = *z;
        const float z0 = in ? fmaxf(__fadd_rn(__fmul_rn(tv.x, s2s[c]), b2s[c]), 0.f) : 0.f;
        const float z1 =
            in ? fmaxf(__fadd_rn(__fmul_rn(tv.y, s2s[c + 1]), b2s[c + 1]), 0.f) : 0.f;
        if constexpr (SPLIT > 1 && !EO) {
          const uint32_t addr = smem_u32(z);
#pragma unroll
          for (int d = 0; d < SPLIT; ++d) {
            st_cluster(addr, d, __float_as_uint(z0));
            st_cluster(addr + 4, d, __float_as_uint(z1));
          }
        } else {
          *z = make_float2(z0, z1);
        }
      }
    }
  }
  if constexpr (SPLIT > 1 && !EO) {
    cluster_arrive();
    cluster_wait();
  } else {
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  }

  // Stage 2. Taps: output m0 = 16 w + g is pixel (2w, g) of the tile, m0 + 8
  // pixel (2w + 1, g); warpgroup wg takes K blocks wg, wg + 2, ... of each
  // slot, output channels [rank, rank + 1) * kN2. Eo: m0 is column pair
  // (2w, g), m0 + 8 pair (2w + 1, g); warpgroup wg takes kernel row dh = wg,
  // K over this CTA's kN1 channels of each of w2q's four blocks, all 2G
  // channels.
  constexpr int kSteps = EO ? 1 : kKB2 / kWGs;  // K blocks of a slot per warpgroup
  float acc[kN2 / 2], sum[kN2 / 2];  // one slot's products; the layer's sum
#pragma unroll
  for (int i = 0; i < kN2 / 2; ++i) acc[i] = sum[i] = 0.f;
  const int m0 = w * 16 + g;
  for (int q = 0; q < K::kSlots2; ++q) {
    const int s = q % kStages2;
    uint32_t ab[kSteps][4][4], as[kSteps][4][4];
#pragma unroll
    for (int kb = 0; kb < kSteps; ++kb) {
      const float* z0;  // bottleneck row of A row m0, at this K block's first channel
      if constexpr (EO) {
        // block blk = q / kBlocks2 reads zo[u-1], ze[u], zo[u], ze[u+1]
        const int blk2 = q / K::kBlocks2;
        const int zr = (blk2 % 2 == 0 ? kOddRow : 0) + (2 * w + wg) * kEoW + g + (blk2 >> 1);
        z0 = zs + zr * K::kZStride + (q % K::kBlocks2) * kKC + t;
      } else {
        const int tap = q / K::kGroups2, cg = q % K::kGroups2;
        z0 = zs + ((2 * w + tap / 3) * kHaloW + g + tap % 3) * K::kZStride + t +
             (kKB2 * cg + kWGs * kb + wg) * kKC;
      }
      const float* z1 = z0 + (EO ? kEoW : kHaloW) * K::kZStride;  // A row m0 + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * j + 4 * h;
          split(z0[c], ab[kb][j][2 * h], as[kb][j][2 * h]);
          split(z1[c], ab[kb][j][2 * h + 1], as[kb][j][2 * h + 1]);
        }
      }
    }
    mbar_wait(&full2[s], (q / kStages2) & 1);
    const uint8_t* slot = smem + s * K::kSlot2;
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kSteps; ++kb) {
      // big B of this K block (eo: of dh = wg), small right after it
      const uint32_t wb = smem_u32(slot + 2 * (EO ? wg : kWGs * kb + wg) * K::kW2Bytes);
      const uint32_t ws = wb + K::kW2Bytes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma3(acc, ab[kb][j], as[kb][j], desc_sw128(wb + 32 * j), desc_sw128(ws + 32 * j),
               j > 0 || kb > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(acc);
#pragma unroll
    for (int kb = 0; kb < kSteps; ++kb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep(ab[kb][j]);
        keep(as[kb][j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty2[s]);
#pragma unroll
    for (int i = 0; i < kN2 / 2; ++i) sum[i] += acc[i];  // promotion
  }

  if constexpr (EO) {
    // Epilogue: every CTA of the cluster has finished stage 2, so every ring
    // is free; warpgroup wg of CTA rank stores its sums for output channels
    // [j, j + 1) * kOut into CTA j's ring at slot (rank, wg).
    cluster_arrive();
    cluster_wait();
    const uint32_t red = smem_u32(smem);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int i = 0; i < kN2 / 8; ++i) {
        const int n = 8 * i + 2 * t, owner = n / K::kOut;
        const uint32_t addr =
            red + (((rank * kWGs + wg) * kM2 + m0 + 8 * e) * K::kOut + n % K::kOut) * 4;
        st_cluster(addr, owner, __float_as_uint(sum[4 * i + 2 * e]));
        st_cluster(addr + 4, owner, __float_as_uint(sum[4 * i + 2 * e + 1]));
      }
    }
    cluster_arrive();
    cluster_wait();
    const float* sums = reinterpret_cast<const float*>(smem);
    constexpr int kVecs = K::kOut / 4;  // 16-byte output vectors per pair
    for (int task = tid; task < kM2 * kVecs; task += kConsumers) {
      const int m = task / kVecs, v = task % kVecs;
      const int oy = oy0 + m / kPairs, ou = ox0 + m % kPairs;
      if (oy >= p.H || ou >= p.W) continue;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < SPLIT * kWGs; ++k) {
        const float4 part = *reinterpret_cast<const float4*>(sums + (k * kM2 + m) * K::kOut + 4 * v);
        o.x += part.x; o.y += part.y; o.z += part.z; o.w += part.w;
      }
      const int n = rank * K::kOut + 4 * v, odd = n >= G;  // of [even G | odd G]
      const int64_t off =
          b * p.so[0] + oy * p.so[1] + ou * p.so[2] + odd * p.so[3] + (n - odd * G);
      *reinterpret_cast<float4*>(p.out + off) = o;
    }
    return;
  }

  // Epilogue: the two warpgroups' partial sums meet in the bottleneck tile's
  // space (both have finished reading it at the barrier).
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  float* red = zs;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float* row = red + (wg * kM2 + m0 + 8 * e) * kN2 + 2 * t;
#pragma unroll
    for (int i = 0; i < kN2 / 8; ++i) {
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(sum[4 * i + 2 * e], sum[4 * i + 2 * e + 1]);
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  constexpr int kVecs = kN2 / 4;  // 16-byte output vectors per pixel
  for (int task = tid; task < kM2 * kVecs; task += kConsumers) {
    const int m = task / kVecs, v = task % kVecs;
    const int oy = oy0 + m / kTW, ox = ox0 + m % kTW;
    if (oy >= p.H || ox >= p.W) continue;
    const float4 lo = *reinterpret_cast<const float4*>(red + m * kN2 + 4 * v);
    const float4 hi = *reinterpret_cast<const float4*>(red + (kM2 + m) * kN2 + 4 * v);
    const int64_t off = b * p.so[0] + oy * p.so[1] + ox * p.so[2] + rank * kN2 + 4 * v;
    *reinterpret_cast<float4*>(p.out + off) =
        make_float4(lo.x + hi.x, lo.y + hi.y, lo.z + hi.z, lo.w + hi.w);
  }
}

// A 4-D f32 tensor map (C, W, H, B) over x through its element strides sx
// (b, h, w), box (32, bw, 10, 1).
bool map_x(CUtensorMap* map, const void* x, const long long* sx, int C, int W, int H, int B,
           int bw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sx[2]) * 4,
                                 static_cast<cuuint64_t>(sx[1]) * 4,
                                 static_cast<cuuint64_t>(sx[0]) * 4};
  const cuuint32_t box[4] = {kKC, static_cast<cuuint32_t>(bw), kHaloH, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 4, dims, strides, box);
}

// xo, sxo: the odd columns (eo only; null for taps).
template <int CMID, int G, int SPLIT, bool EO>
int launch(TapsParams& p, const void* x, const long long* sx, const void* xo,
           const long long* sxo, const void* w1s, const void* w2s, int B, cudaStream_t stream) {
  using K = Cfg<CMID, G, SPLIT, EO>;
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t w1dims[2] = {static_cast<cuuint64_t>(p.C), 2 * CMID};
  const cuuint64_t w1strides[1] = {static_cast<cuuint64_t>(p.C) * 4};
  const cuuint32_t w1box[2] = {kKC, K::kN1};
  // taps: w2s (2, 3, 3, G, Cmid); eo: w2qs (2, 3, 2G, 4 Cmid)
  const cuuint64_t w2dims[2] = {(EO ? 4 : 1) * CMID, (EO ? 12 : 18) * G};
  const cuuint64_t w2strides[1] = {(EO ? 4 : 1) * CMID * 4};
  const cuuint32_t w2box[2] = {kKC, K::kN2};
  const int bw = EO ? kEoW : kHaloW;
  if (!map_x(&p.x, x, sx, p.C, p.W, p.H, B, bw) ||
      (EO && !map_x(&p.xo, xo, sxo, p.C, p.W, p.H, B, bw)) ||
      !make_map(&p.w1, f32, w1s, 2, w1dims, w1strides, w1box) ||
      !make_map(&p.w2, f32, w2s, 2, w2dims, w2strides, w2box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(B) * p.tiles_h * p.tiles_w * SPLIT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = taps_f32_kernel<CMID, G, SPLIT, EO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(K::kThreads);
  cfg.dynamicSmemBytes = K::kAlloc;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = SPLIT;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

TapsParams params(const void* s1, const void* b1, const void* s2, const void* b2, void* out,
                  int H, int W, int C, int tile_w) {
  TapsParams p{};
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(out);
  p.H = H; p.W = W; p.C = C;
  p.tiles_h = (H + kTH - 1) / kTH;
  p.tiles_w = (W + tile_w - 1) / tile_w;
  return p;
}

}  // namespace

// x: (B,H,W,C) f32 through strides (sb, sh, sw), channels contiguous. s1, b1
// (C); w1s (2, Cmid, C); s2, b2 (Cmid); w2s (2, 3, 3, G, Cmid), all contiguous
// f32. out: (B,H,W,G) through strides (ob, oh, ow). Launches on `stream` and
// returns the first CUDA error (cudaErrorInvalidValue for shapes it cannot
// take).
extern "C" int fused_dense_taps_f32(const void* x, long long sb, long long sh, long long sw,
                                    const void* s1, const void* b1, const void* w1s,
                                    const void* s2, const void* b2, const void* w2s, void* out,
                                    long long ob, long long oh, long long ow, int B, int H, int W,
                                    int C, int Cmid, int G, void* stream) {
  const long long strides[6] = {sb, sh, sw, ob, oh, ow};
  for (long long s : strides) {
    if (s % 4) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 || !aligned16(x) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapsParams p = params(s1, b1, s2, b2, out, H, W, C, kTW);
  p.so[0] = ob; p.so[1] = oh; p.so[2] = ow;
  const long long sx[3] = {sb, sh, sw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cmid == 192 && G == 48) {
    // Tiles for at most a quarter of the SMs: three CTAs (a cluster) share each.
    const long long tiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w;
    if (4 * tiles <= sm_count()) {
      return launch<192, 48, 3, false>(p, x, sx, nullptr, nullptr, w1s, w2s, B, s);
    }
    return launch<192, 48, 1, false>(p, x, sx, nullptr, nullptr, w1s, w2s, B, s);
  }
  if (Cmid == 128 && G == 32) {
    return launch<128, 32, 1, false>(p, x, sx, nullptr, nullptr, w1s, w2s, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// xe, xo: (B,H,U,C) f32, the even and odd columns, each through its strides,
// channels contiguous. s1, b1 (C); w1s (2, Cmid, C); s2, b2 (Cmid); w2qs (2,
// 3, 2G, 4 Cmid), pack_w2_eo's kernel K-major and split; all contiguous f32.
// out: (B,H,U,2,G) through strides (pb, ph, pu, pp): [.., 0, :] the even
// output columns, [.., 1, :] the odd ones. Launches on `stream` and returns
// the first CUDA error (cudaErrorInvalidValue for shapes it cannot take).
extern "C" int fused_dense_eo_f32(const void* xe, long long eb, long long eh, long long eu,
                                  const void* xo, long long ob, long long oh, long long ou,
                                  const void* s1, const void* b1, const void* w1s, const void* s2,
                                  const void* b2, const void* w2qs, void* out, long long pb,
                                  long long ph, long long pu, long long pp, int B, int H, int U,
                                  int C, int Cmid, int G, void* stream) {
  const long long strides[10] = {eb, eh, eu, ob, oh, ou, pb, ph, pu, pp};
  for (long long s : strides) {
    if (s % 4) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || U <= 0 || C <= 0 || C % 4 || !aligned16(xe) || !aligned16(xo) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapsParams p = params(s1, b1, s2, b2, out, H, U, C, kPairs);
  p.so[0] = pb; p.so[1] = ph; p.so[2] = pu; p.so[3] = pp;
  const long long sxe[3] = {eb, eh, eu}, sxo[3] = {ob, oh, ou};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cmid == 192 && G == 48) {
    const long long tiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w;
    const int sms = sm_count();
    if (6 * tiles <= sms) return launch<192, 48, 6, true>(p, xe, sxe, xo, sxo, w1s, w2qs, B, s);
    if (4 * tiles <= sms) return launch<192, 48, 3, true>(p, xe, sxe, xo, sxo, w1s, w2qs, B, s);
    return launch<192, 48, 2, true>(p, xe, sxe, xo, sxo, w1s, w2qs, B, s);
  }
  if (Cmid == 128 && G == 32) return launch<128, 32, 2, true>(p, xe, sxe, xo, sxo, w1s, w2qs, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
