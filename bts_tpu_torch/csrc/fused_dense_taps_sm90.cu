// Fused DenseNet layer, bf16, for NVIDIA Hopper (sm_90a), in both forms of
// the Pallas kernels: fused_dense_taps_bf16 and fused_dense_eo_bf16.
//
// Replaces the Pallas TPU kernels fused_dense_layer (docs/archive/
// fused_dense.py:167, body _kernel_taps :84) and fused_dense_layer_eo (:216,
// body _kernel_eo :109) in bf16; f32 is fused_dense_taps_f32_sm90.cu, the PTX
// helpers are in sm90.cuh. Both compute one torchvision dense layer with the
// BatchNorms folded, at the rounding points of ops/fused_dense.py::
// fused_dense_reference and fused_dense_eo_reference:
//   y = bf16(relu(bf16(bf16(x*s1) + b1)));  t = f32(y . w1);
//   z = bf16(relu(t*s2 + b2)), 0 at a halo pixel outside the image;
//   out = bf16(sum over the 3x3 taps of z . w2).
// The eo form takes the feature map as its even and odd columns (xe, xo) and
// the 3x3 packed as w2q (3, 4*Cmid, 2G) (pack_w2_eo): per kernel row dh, one
// product of the four bottleneck columns [zo[u-1], ze[u], zo[u], ze[u+1]]
// (K = 4*Cmid) with w2q[dh] gives output columns 2u and 2u+1 (N = 2G). It
// multiplies every block of w2q, its zero blocks too: 12*Cmid*G MACs a pixel
// for the 3x3, against the taps form's 9*Cmid*G.
//
// Bound. At DenseNet161's shapes the layer is bound by operations (C*192 +
// 9*192*48 MACs per pixel against 2*(C + 48) bytes), so the design keeps the
// tensor cores fed. On an H100 80GB HBM3 at 700 W the taps form runs
// DenseNet161's layers at batch 8 at 58-285 TFLOP/s, 7-29% of the bound,
// about 4x faster than cuDNN's unfused chain (PERF.md). The two forms share
// everything below but the halo's layout in the x slot and stage 2:
//
// - Tile. A CTA computes one 8 x 16 output tile (eo: 8 rows x 8 column
//   pairs, the same 16 columns). Its bottleneck z is computed for the tile
//   plus a one-pixel halo, 10 x 18 = 180 pixels padded to 192 rows (3 x 64,
//   the wgmma M), and kept in shared memory; the 1x1 is thus recomputed for
//   1.41x the pixels (1.5x counting the padding). Taps keeps the halo in
//   image order (row 18 hy + hx); eo keeps it by parity: ze[u0 .. u0+8] of
//   the 10 halo rows at rows 9 hy + i, zo[u0-1 .. u0+7] at 96 + 9 hy + i
//   (row 96, not 90, keeps the second TMA box 1024-byte aligned, so both
//   boxes keep the 128-byte swizzle's pattern). Tiles at 480x640 input, per
//   image: 150, 40, 12 and 4 for blocks 1-4 (x8 at batch 8), one CTA per SM
//   (the shared memory below).
// - Small grids. Where the tiles would fill at most a quarter of the SMs (on
//   an H100 at 480x640: block 4 up to batch 8, block 3 up to batch 2), a
//   cluster of three CTAs shares each tile (SPLIT = 3): CTA r computes
//   bottleneck channels [64r, 64r + 64) for the whole halo, stores them into
//   the bottleneck tile of all three CTAs through distributed shared memory,
//   and after a cluster barrier computes a third of the output channels
//   (taps: [16r, 16r + 16); eo: [32r, 32r + 32) of the pair's 96) from the
//   whole tile.
//   CTAs per shape at batch 8: 1200, 320, 96 and 96 (32 tiles x 3); at batch
//   1: 150, 40, 36 (12 x 3) and 12 (4 x 3).
// - Warp roles. 3 consumer warpgroups (384 threads) and one producer
//   warpgroup, which gives its registers to the consumers (setmaxnreg: 40
//   and 152 a thread; the 96 f32 accumulators of stage 1 need them). One
//   producer thread keeps a ring of 3 shared-memory stages (4 when split)
//   filled by TMA, tracked by mbarriers (full: one arrive + the bytes;
//   empty: one arrive per consumer warp). There is no __syncthreads inside
//   either K loop.
// - Stage 1 (M = 192 halo rows, N = Cmid, K = C in 64-channel chunks). A
//   stage holds the chunk of x over the halo and the chunk of w1 (Cmid rows
//   of 64 channels, K-major), both with the 128-byte swizzle. Taps loads the
//   halo as one 4-D TMA box (64 channels x 18 x 10 x 1 over the strided
//   channel prefix), eo as two, one over xe and one over xo (64 x 9 x 10 x 1
//   each; zo's box starts at u0 - 1). The tensor maps zero-fill pixels
//   outside the image and channels past C. Each consumer warpgroup owns 64
//   halo rows: it loads them with ldmatrix, applies BN1, ReLU and the two
//   bf16 roundings to the fragments in registers (bf16x2 mul.rn / add.rn /
//   max), and issues wgmma m64nCmidk16 with A from registers and B from
//   shared memory.
// - Stage 1 epilogue, in registers: BN2 (s2, b2 read once per CTA into
//   shared memory), ReLU, the bf16 rounding and the out-of-image mask (decided
//   per row: the bottleneck of a zero input is not zero) go straight into the
//   bottleneck tile, rows XOR-swizzled by 16 bytes so ldmatrix and the stores
//   are free of bank conflicts.
// - Stage 2. A shift of one pixel cannot be written as a wgmma shared-memory
//   descriptor, so A comes from registers: ldmatrix takes one row address per
//   lane from the bottleneck tile. Consumer warpgroup wg takes kernel row
//   dh = wg, so the three warpgroups split K. Taps (M = 128 outputs, N = G,
//   K = 9 taps x Cmid): a stage holds one 64-channel chunk of one kernel
//   column dw for the three rows dh (K-major, G rows each); the warpgroup
//   runs the tap's shifted rows for both 64-row output blocks (wgmma
//   m64nGk16). Eo (M = 64 column pairs, N = 2G, K = 4 x Cmid): a stage holds
//   one 64-channel chunk of w2q[dh] for the three dh (K-major, 2G rows
//   each); block blk of K reads parity tile (o, e, o, e) at halo entry
//   9 (y + dh) + u + (0, 0, 1, 1) (wgmma m64n2Gk16).
// - Stage 2 epilogue: the three partial sums meet in shared memory (the
//   bottleneck tile's space, free by then), are added in f32, rounded, and
//   written as 16-byte vectors: each pixel's G channels are contiguous and
//   16-byte aligned in the block's NHWC buffer (eo: the even half of a pair's
//   sums to column 2u, the odd half to 2u + 1).
//
// Shared memory (Cmid 192, G 48): ring 3 x (24 KB x + 24 KB w1) = 144 KB,
// bottleneck tile 192 x 192 bf16 = 72 KB, s2/b2 1.5 KB, 6 mbarriers, and up
// to 1 KB to align the ring to 1024 bytes: 218.5 KB of the 227 KB. SPLIT 3:
// ring 4 x (24 KB + 8 KB) = 128 KB, the same tile: 202.5 KB. Cmid 128, G 32
// (DenseNet121, never split): ring 120 KB, tile 48 KB.
//
// Limits (the wrapper checks them too): (Cmid, G) = (192, 48) or (128, 32);
// C % 8 == 0; x channels contiguous, pixel strides multiples of 8 elements,
// x 16-byte aligned; out likewise (16-byte stores). w1t is the 1x1 kernel as
// (Cmid, C); w2t the 3x3 as (3, 3, G, Cmid) and, for eo, w2qt the packed
// kernel as (3, 2G, 4 Cmid), all contiguous: K-major, as wgmma reads B.
// Every launch returns the first CUDA error met.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kTH = 8, kTW = 16;                  // output tile
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kHaloP = kHaloH * kHaloW;           // 180 bottleneck pixels
constexpr int kPairs = kTW / 2;                   // eo: column pairs of a tile
constexpr int kEoW = kPairs + 1;                  // eo: halo entries per parity and row
constexpr int kEoBox = kHaloH * kEoW;             // eo: 90 rows of one parity
constexpr int kOddRow = 96;                       // eo: first row of zo, 1024-byte aligned
constexpr int kM1 = 192;                          // as 3 x 64 wgmma rows
constexpr int kWGs = 3;                           // consumer warpgroups
constexpr int kConsumers = kWGs * 128;
constexpr int kConsumerWarps = kConsumers / 32;   // arrivals that free a stage
constexpr int kThreads = kConsumers + 128;        // + the producer warpgroup
// Registers a thread after setmaxnreg: a warp of each warpgroup shares each of
// the SM's 4 register files (16384 each): 3 * 152 + 40 <= 512.
constexpr int kConsumerRegs = 152, kProducerRegs = 40;
constexpr int kKC = 64;                           // K chunk: 128 bytes, one swizzle row
constexpr int kRowB = kKC * 2;
static_assert(kHaloP <= kM1 && kM1 == 64 * kWGs && kOddRow + kEoBox <= kM1 &&
                  kOddRow * kRowB % 1024 == 0 && kEoBox <= kOddRow,
              "tile geometry");

// SPLIT CTAs (a cluster) share one tile: CTA `rank` computes bottleneck
// channels [rank, rank + 1) * Cmid / SPLIT and stage-2 channels
// [rank, rank + 1) * N / SPLIT (N = G, or 2G for eo).
template <int CMID, int G, int SPLIT, bool EO>
struct Cfg {
  static constexpr int kStages = SPLIT == 1 ? 3 : 4;    // ring stages
  static constexpr int kN1 = CMID / SPLIT;              // stage-1 N of this CTA
  static constexpr int kN2 = (EO ? 2 * G : G) / SPLIT;  // stage-2 N of this CTA
  static constexpr int kM2 = EO ? 64 : kTH * kTW;       // outputs (eo: column pairs)
  static constexpr int kMB = kM2 / 64;                  // 64-row wgmma blocks of them
  static constexpr int kXBytes = kM1 * kRowB;           // x chunk, 192 rows
  static constexpr int kXTx = (EO ? 2 * kEoBox : kHaloP) * kRowB;  // what the x boxes write
  static constexpr int kW1Bytes = kN1 * kRowB;          // w1t chunk, kN1 rows
  static constexpr int kW2Bytes = kN2 * kRowB;          // stage-2 chunk of one dh, kN2 rows
  static constexpr int kSlot = kXBytes + kW1Bytes;      // stage 2 fills 3 * kW2Bytes of it
  static constexpr int kChunks2 = CMID / kKC;           // chunks per tap (eo: per K block)
  static constexpr int kSlots2 = (EO ? 4 : 3) * kChunks2;  // stage-2 stages
  static constexpr int kZRow = CMID * 2;                // bytes per bottleneck row
  static constexpr int kZ = kStages * kSlot;            // bottleneck tile offset
  static constexpr int kS2 = kZ + kM1 * kZRow;          // s2, b2 as f32
  static constexpr int kBar = kS2 + 2 * CMID * 4;       // full[], empty[]
  static constexpr int kBytes = kBar + 2 * kStages * 8;
  static constexpr int kAlloc = kBytes + 1024;          // + alignment of the ring
  static_assert(kWGs * kM2 * kN2 * 4 <= kM1 * kZRow, "stage-2 sums fit the bottleneck tile");
  static_assert(3 * kW2Bytes <= kSlot, "a stage-2 chunk fits a stage");
  static_assert(kXBytes % 1024 == 0 && kW1Bytes % 1024 == 0 && kW2Bytes % 1024 == 0,
                "128-byte swizzle atoms stay 1024-byte aligned");
  static_assert(CMID % (kKC * SPLIT) == 0 && kN2 % 8 == 0 && G % 8 == 0 &&
                    kAlloc <= 232448,
                "shapes");
};

struct TapsParams {
  CUtensorMap x;   // 4-D (C, W, H, B), box (64, 18, 10, 1); eo: over xe (C, U, H, B), box (64, 9, 10, 1)
  CUtensorMap xo;  // eo: over xo, as xe
  CUtensorMap w1;  // 2-D (C, Cmid) over w1t, box (64, Cmid / SPLIT)
  CUtensorMap w2;  // 2-D (Cmid, 9G) over w2t, box (64, G / SPLIT); eo: (4 Cmid, 6G) over w2qt
  const bf16 *s1, *b1, *s2, *b2;
  bf16* out;
  int64_t so[4];   // out strides (b, h, w) in elements; eo: (b, h, u, parity)
  int H, W, C, tiles_h, tiles_w;  // eo: W is U, the column pairs
};

#define ACC8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 192, f32, 96 registers a thread) += A (64 x 16, registers) * B (16 x 192, shared).
__device__ __forceinline__ void wgmma(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56),
        ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32, 64 registers a thread) += A (64 x 16, registers) * B (16 x 128, shared).
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 96, f32, 48 registers a thread) += A (64 x 16, registers) * B (16 x 96, shared).
__device__ __forceinline__ void wgmma(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 48, f32, 24 registers a thread) += A (64 x 16, registers) * B (16 x 48, shared).
__device__ __forceinline__ void wgmma(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 32, f32, 16 registers a thread) += A (64 x 16, registers) * B (16 x 32, shared).
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, f32, 32 registers a thread) += A (64 x 16, registers) * B (16 x 64, shared).
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 16, f32, 8 registers a thread) += A (64 x 16, registers) * B (16 x 16, shared).
__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// y = bf16(relu(bf16(bf16(x*s) + b))) on two channels.
__device__ __forceinline__ uint32_t bn_relu(uint32_t x, uint32_t s, uint32_t b) {
  uint32_t y;
  asm("{\n"
      ".reg .b32 t;\n"
      "mul.rn.bf16x2 t, %1, %2;\n"
      "add.rn.bf16x2 t, t, %3;\n"
      "max.bf16x2 %0, t, %4;\n"
      "}\n"
      : "=r"(y)
      : "r"(x), "r"(s), "r"(b), "r"(0u));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int CMID, int G, int SPLIT, bool EO>
__global__ void __launch_bounds__(kThreads, 1)
    taps_sm90_kernel(const __grid_constant__ TapsParams p) {
  using K = Cfg<CMID, G, SPLIT, EO>;
  constexpr int kStages = K::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* zs = smem + K::kZ;
  float* s2s = reinterpret_cast<float*>(smem + K::kS2);
  float* b2s = s2s + CMID;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K::kBar);
  uint64_t* empty = full + kStages;

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
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < CMID; i += kThreads) {
    s2s[i] = __bfloat162float(p.s2[i]);
    b2s[i] = __bfloat162float(p.b2[i]);
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
      int q = 0;
      for (int kc = 0; kc < nk1; ++kc, ++q) {
        const int s = q % kStages;
        mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
        uint8_t* slot = smem + s * K::kSlot;
        mbar_expect_tx(&full[s], K::kXTx + K::kW1Bytes);
        if constexpr (EO) {  // ze[u0 ..], zo[u0 - 1 ..]
          tma_load_4d(slot, &p.x, &full[s], kc * kKC, ox0, oy0 - 1, b);
          tma_load_4d(slot + kOddRow * kRowB, &p.xo, &full[s], kc * kKC, ox0 - 1, oy0 - 1, b);
        } else {
          tma_load_4d(slot, &p.x, &full[s], kc * kKC, ox0 - 1, oy0 - 1, b);
        }
        tma_load_2d(slot + K::kXBytes, &p.w1, &full[s], kc * kKC, rank * K::kN1);
      }
      // The cluster barrier after stage 1 counts every thread; the producer
      // arrives before it waits for stage-2 slots the consumers free after it.
      if (SPLIT > 1) cluster_arrive_thread();
      for (int j = 0; j < K::kSlots2; ++j, ++q) {
        const int s = q % kStages;
        mbar_wait(&empty[s], ((q / kStages) & 1) ^ 1);
        uint8_t* slot = smem + s * K::kSlot;
        mbar_expect_tx(&full[s], 3 * K::kW2Bytes);
        // taps: chunk j % kChunks2 of kernel column dw = j / kChunks2;
        // eo: chunk j of w2q[dh]'s K.
        const int k0 = (EO ? j : j % K::kChunks2) * kKC;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const int row = EO ? dh * 2 * G : (dh * 3 + j / K::kChunks2) * G;
          tma_load_2d(slot + dh * K::kW2Bytes, &p.w2, &full[s], k0, row + rank * K::kN2);
        }
      }
    } else if (SPLIT > 1) {
      cluster_arrive_thread();
    }
    return;
  }

  // ---- consumers: warpgroup wg, warp w of it, lane l ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int lcol = lane >> 4;                           // and its 8-column half
  int q = 0;

  {  // Stage 1: the bottleneck of halo rows [64 wg, 64 wg + 64), channels
     // [rank, rank + 1) * kN1.
    float acc[K::kN1 / 2];
#pragma unroll
    for (int i = 0; i < K::kN1 / 2; ++i) acc[i] = 0.f;
    const int arow = wg * 64 + w * 16 + lrow;
    for (int kc = 0; kc < nk1; ++kc, ++q) {
      const int s = q % kStages;
      // s1, b1 of the channel pairs this thread holds: [k16 step][low / high 8]
      uint32_t sc[4][2], bc[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = kc * kKC + 16 * j + 8 * h + 2 * t;
          const bool in = c < p.C;
          sc[j][h] = in ? __ldg(reinterpret_cast<const unsigned int*>(p.s1 + c)) : 0u;
          bc[j][h] = in ? __ldg(reinterpret_cast<const unsigned int*>(p.b1 + c)) : 0u;
        }
      }
      mbar_wait(&full[s], (q / kStages) & 1);
      const uint32_t xs = smem_u32(smem + s * K::kSlot);
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ldsm_x4(xs + arow * kRowB + (((2 * j + lcol) ^ (arow & 7)) << 4), a[j]);
        a[j][0] = bn_relu(a[j][0], sc[j][0], bc[j][0]);
        a[j][1] = bn_relu(a[j][1], sc[j][0], bc[j][0]);
        a[j][2] = bn_relu(a[j][2], sc[j][1], bc[j][1]);
        a[j][3] = bn_relu(a[j][3], sc[j][1], bc[j][1]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma(acc, a[j], desc_sw128(xs + K::kXBytes + 32 * j));
      wgmma_commit();
      wgmma_wait_all();
      keep(acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) keep(a[j]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue: z = bf16(relu(acc*s2 + b2)) into the bottleneck tile, 0 on
    // rows outside the image (and on the padding rows); with SPLIT, into the
    // tile of every CTA of the cluster.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wg * 64 + w * 16 + g + 8 * half;
      bool in;
      if constexpr (EO) {  // entry e of parity odd's box: halo row e / 9, pair column
        const int odd = r >= kOddRow, e = r - odd * kOddRow;
        const int gy = oy0 - 1 + e / kEoW, gu = ox0 - odd + e % kEoW;
        in = e < kEoBox && gy >= 0 && gy < p.H && gu >= 0 && gu < p.W;
      } else {
        const int gy = oy0 - 1 + r / kHaloW, gx = ox0 - 1 + r % kHaloW;
        in = r < kHaloP && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      }
      const uint32_t zrow = smem_u32(zs + r * K::kZRow + 4 * t);
#pragma unroll
      for (int i = 0; i < K::kN1 / 8; ++i) {
        const int c = rank * K::kN1 + 8 * i + 2 * t;
        const float v0 = acc[4 * i + 2 * half], v1 = acc[4 * i + 2 * half + 1];
        const float z0 = fmaxf(__fadd_rn(__fmul_rn(v0, s2s[c]), b2s[c]), 0.f);
        const float z1 = fmaxf(__fadd_rn(__fmul_rn(v1, s2s[c + 1]), b2s[c + 1]), 0.f);
        const uint32_t addr = zrow + (((c / 8) ^ (r & 7)) << 4);
        const uint32_t z = in ? pack_bf16(z0, z1) : 0u;
        if constexpr (SPLIT > 1) {
#pragma unroll
          for (int d = 0; d < SPLIT; ++d) st_cluster(addr, d, z);
        } else {
          asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(z) : "memory");
        }
      }
    }
  }
  if constexpr (SPLIT > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  }

  // Stage 2: kernel row dh = wg, for every 64-output block, stage-2 channels
  // [rank, rank + 1) * kN2.
  float acc[K::kMB][K::kN2 / 2];
#pragma unroll
  for (int m = 0; m < K::kMB; ++m)
#pragma unroll
    for (int i = 0; i < K::kN2 / 2; ++i) acc[m][i] = 0.f;
  const uint32_t zs_u = smem_u32(zs);
  for (int j = 0; j < K::kSlots2; ++j, ++q) {
    const int s = q % kStages;
    const int kc = j % K::kChunks2;
    mbar_wait(&full[s], (q / kStages) & 1);
    uint32_t a[K::kMB][4][4];
#pragma unroll
    for (int m = 0; m < K::kMB; ++m) {
      int zr;  // the bottleneck row this lane's ldmatrix row reads
      if constexpr (EO) {
        // column pair (y, u) = (2w + lrow / 8, lrow % 8); K block kb =
        // j / kChunks2 reads zo[u-1], ze[u], zo[u], ze[u+1]
        const int kb = j / K::kChunks2;
        zr = (kb % 2 == 0 ? kOddRow : 0) + (2 * w + (lrow >> 3) + wg) * kEoW + (lrow & 7) +
             (kb >> 1);
      } else {
        // output row oy = 4m + w of the tile, column lrow, kernel column dw
        zr = (4 * m + w + wg) * kHaloW + lrow + j / K::kChunks2;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int chunk = kc * 8 + 2 * jj + lcol;
        ldsm_x4(zs_u + zr * K::kZRow + ((chunk ^ (zr & 7)) << 4), a[m][jj]);
      }
    }
    const uint32_t ws = smem_u32(smem + s * K::kSlot + wg * K::kW2Bytes);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int m = 0; m < K::kMB; ++m) wgmma(acc[m], a[m][jj], desc_sw128(ws + 32 * jj));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < K::kMB; ++m) {
      keep(acc[m]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) keep(a[m][jj]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: the three warpgroups' partial sums meet in the bottleneck
  // tile's space (every warpgroup has finished reading it at the barrier).
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  float* red = reinterpret_cast<float*>(zs);
#pragma unroll
  for (int m = 0; m < K::kMB; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* row = red + (wg * K::kM2 + m * 64 + w * 16 + g + 8 * half) * K::kN2 + 2 * t;
#pragma unroll
      for (int i = 0; i < K::kN2 / 8; ++i) {
        *reinterpret_cast<float2*>(row + 8 * i) =
            make_float2(acc[m][4 * i + 2 * half], acc[m][4 * i + 2 * half + 1]);
      }
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  constexpr int kVecs = K::kN2 / 8;  // 16-byte output vectors per pixel (eo: per pair)
  for (int task = tid; task < K::kM2 * kVecs; task += kConsumers) {
    const int m = task / kVecs, v = task % kVecs;
    int64_t off;
    if constexpr (EO) {  // pair (m / 8, m % 8); channel n of [even G | odd G]
      const int oy = oy0 + m / kPairs, ou = ox0 + m % kPairs;
      if (oy >= p.H || ou >= p.W) continue;
      const int n = rank * K::kN2 + 8 * v, odd = n >= G;
      off = b * p.so[0] + oy * p.so[1] + ou * p.so[2] + odd * p.so[3] + (n - odd * G);
    } else {
      const int oy = oy0 + m / kTW, ox = ox0 + m % kTW;
      if (oy >= p.H || ox >= p.W) continue;
      off = b * p.so[0] + oy * p.so[1] + ox * p.so[2] + rank * K::kN2 + 8 * v;
    }
    float sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] = 0.f;
#pragma unroll
    for (int k = 0; k < kWGs; ++k) {
      const float4* src =
          reinterpret_cast<const float4*>(red + (k * K::kM2 + m) * K::kN2 + 8 * v);
      const float4 lo = src[0], hi = src[1];
      sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
      sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
    }
    uint4 o;
    o.x = pack_bf16(sum[0], sum[1]);
    o.y = pack_bf16(sum[2], sum[3]);
    o.z = pack_bf16(sum[4], sum[5]);
    o.w = pack_bf16(sum[6], sum[7]);
    *reinterpret_cast<uint4*>(p.out + off) = o;
  }
}

// A 4-D tensor map (C, W, H, B) over x through its element strides sx (b, h,
// w), box (64, bw, 10, 1).
bool map_x(CUtensorMap* map, const void* x, const long long* sx, int C, int W, int H, int B,
           int bw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sx[2]) * 2,
                                 static_cast<cuuint64_t>(sx[1]) * 2,
                                 static_cast<cuuint64_t>(sx[0]) * 2};
  const cuuint32_t box[4] = {kKC, static_cast<cuuint32_t>(bw), kHaloH, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 4, dims, strides, box);
}

// xo, sxo: the odd columns (eo only; null for taps).
template <int CMID, int G, int SPLIT, bool EO>
int launch(TapsParams& p, const void* x, const long long* sx, const void* xo,
           const long long* sxo, const void* w1t, const void* w2t, int B, cudaStream_t stream) {
  using K = Cfg<CMID, G, SPLIT, EO>;
  const cuuint64_t w1dims[2] = {static_cast<cuuint64_t>(p.C), CMID};
  const cuuint64_t w1strides[1] = {static_cast<cuuint64_t>(p.C) * 2};
  const cuuint32_t w1box[2] = {kKC, K::kN1};
  // taps: w2t (3, 3, G, Cmid); eo: w2qt (3, 2G, 4 Cmid)
  const cuuint64_t w2dims[2] = {(EO ? 4 : 1) * CMID, (EO ? 6 : 9) * G};
  const cuuint64_t w2strides[1] = {(EO ? 4 : 1) * CMID * 2};
  const cuuint32_t w2box[2] = {kKC, K::kN2};
  const int bw = EO ? kEoW : kHaloW;
  if (!map_x(&p.x, x, sx, p.C, p.W, p.H, B, bw) ||
      (EO && !map_x(&p.xo, xo, sxo, p.C, p.W, p.H, B, bw)) ||
      !make_map(&p.w1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w1t, 2, w1dims, w1strides, w1box) ||
      !make_map(&p.w2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w2t, 2, w2dims, w2strides, w2box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(B) * p.tiles_h * p.tiles_w * SPLIT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = taps_sm90_kernel<CMID, G, SPLIT, EO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(kThreads);
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

// Picks the instantiation for (Cmid, G) and the grid: tiles for at most a
// quarter of the SMs are shared by three CTAs (a cluster). (At 40 taps tiles,
// 120 CTAs, the split measured slower on an H100.)
template <bool EO>
int dispatch(TapsParams& p, const void* x, const long long* sx, const void* xo,
             const long long* sxo, const void* w1t, const void* w2t, int B, int Cmid, int G,
             cudaStream_t s) {
  if (Cmid == 192 && G == 48) {
    const long long tiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w;
    if (4 * tiles <= sm_count()) return launch<192, 48, 3, EO>(p, x, sx, xo, sxo, w1t, w2t, B, s);
    return launch<192, 48, 1, EO>(p, x, sx, xo, sxo, w1t, w2t, B, s);
  }
  if (Cmid == 128 && G == 32) return launch<128, 32, 1, EO>(p, x, sx, xo, sxo, w1t, w2t, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

TapsParams params(const void* s1, const void* b1, const void* s2, const void* b2, void* out,
                  int H, int W, int C, int tile_w) {
  TapsParams p{};
  p.s1 = static_cast<const bf16*>(s1);
  p.b1 = static_cast<const bf16*>(b1);
  p.s2 = static_cast<const bf16*>(s2);
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.H = H; p.W = W; p.C = C;
  p.tiles_h = (H + kTH - 1) / kTH;
  p.tiles_w = (W + tile_w - 1) / tile_w;
  return p;
}

}  // namespace

// x: (B,H,W,C) bf16 through strides (sb, sh, sw), channels contiguous. s1, b1
// (C); w1t (Cmid, C); s2, b2 (Cmid); w2t (3,3,G,Cmid), all contiguous bf16.
// out: (B,H,W,G) through strides (ob, oh, ow). Launches on `stream` and
// returns the first CUDA error (cudaErrorInvalidValue for shapes it cannot
// take).
extern "C" int fused_dense_taps_bf16(const void* x, long long sb, long long sh, long long sw,
                                     const void* s1, const void* b1, const void* w1t,
                                     const void* s2, const void* b2, const void* w2t, void* out,
                                     long long ob, long long oh, long long ow, int B, int H,
                                     int W, int C, int Cmid, int G, void* stream) {
  const long long strides[6] = {sb, sh, sw, ob, oh, ow};
  for (long long s : strides) {
    if (s % 8) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || !aligned16(x) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapsParams p = params(s1, b1, s2, b2, out, H, W, C, kTW);
  p.so[0] = ob; p.so[1] = oh; p.so[2] = ow;
  const long long sx[3] = {sb, sh, sw};
  return dispatch<false>(p, x, sx, nullptr, nullptr, w1t, w2t, B, Cmid, G,
                         static_cast<cudaStream_t>(stream));
}

// xe, xo: (B,H,U,C) bf16, the even and odd columns, each through its strides,
// channels contiguous. s1, b1 (C); w1t (Cmid, C); s2, b2 (Cmid); w2qt (3, 2G,
// 4 Cmid), pack_w2_eo's kernel K-major; all contiguous bf16. out: (B,H,U,2,G)
// through strides (pb, ph, pu, pp): [.., 0, :] the even output columns,
// [.., 1, :] the odd ones. Launches on `stream` and returns the first CUDA
// error (cudaErrorInvalidValue for shapes it cannot take).
extern "C" int fused_dense_eo_bf16(const void* xe, long long eb, long long eh, long long eu,
                                   const void* xo, long long ob, long long oh, long long ou,
                                   const void* s1, const void* b1, const void* w1t,
                                   const void* s2, const void* b2, const void* w2qt, void* out,
                                   long long pb, long long ph, long long pu, long long pp, int B,
                                   int H, int U, int C, int Cmid, int G, void* stream) {
  const long long strides[10] = {eb, eh, eu, ob, oh, ou, pb, ph, pu, pp};
  for (long long s : strides) {
    if (s % 8) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || U <= 0 || C <= 0 || C % 8 || !aligned16(xe) || !aligned16(xo) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapsParams p = params(s1, b1, s2, b2, out, H, U, C, kPairs);
  p.so[0] = pb; p.so[1] = ph; p.so[2] = pu; p.so[3] = pp;
  const long long sxe[3] = {eb, eh, eu}, sxo[3] = {ob, oh, ou};
  return dispatch<true>(p, xe, sxe, xo, sxo, w1t, w2qt, B, Cmid, G,
                        static_cast<cudaStream_t>(stream));
}
