// Fused DenseNet layer, taps form, f32, for NVIDIA Hopper (sm_90a):
// fused_dense_taps_f32.
//
// Replaces the Pallas TPU kernel fused_dense_layer (docs/archive/fused_dense.py
// :167, body _kernel_taps :84) in f32, the dtype cli.test serves by default
// (--compute_dtype float32). It computes one torchvision dense layer with the
// BatchNorms folded, at the rounding points of
// ops/fused_dense.py::fused_dense_reference:
//   y = relu(x*s1 + b1);  t = y . w1;  z = relu(t*s2 + b2), 0 at a halo pixel
//   outside the image;  out = sum over the 3x3 taps of z . w2.
//
// Numerics: 3xTF32. One TF32 product keeps 10 mantissa bits, too few for f32.
// Each operand a is split into big = tf32_rna(a) and small = tf32_rna(a - big);
// every k step issues three wgmma .tf32 products, small.big + big.small +
// big.big (small.small, about 2^-22 relative, is dropped). B (w1, w2) comes
// split from DenseLayer.folded (ops/fused_dense.py::pack_taps_kmajor); A is
// split in registers (cvt.rna.tf32.f32, a subtract, cvt again). Promotion:
// the tensor cores' chained accumulation does not round to nearest, and over
// the hundreds of chained products of one output its error came close to
// the f32 tolerance, far above that of the same split summed in f32. So a
// run of chained wgmmas starts a fresh sum, which is then added, rounded to
// nearest, into the layer's f32 sum: every ring slot (12 wgmmas) in stage 2,
// in registers; every kPromote1 slots (48 wgmmas) in stage 1, in the
// bottleneck tile's space (free until stage 1's epilogue; promoting at
// every slot there was clearly slower).
//
// Bound. Three TF32 products for each f32 one: 494.7 / 3 = 165 TFLOP/s of
// f32-accurate work on an H100 SXM, against 67 TFLOP/s for FMAs. At
// DenseNet161's shapes the layer is bound by these operations (C*192 +
// 9*192*48 MACs per pixel against 4*(C + 48) bytes).
//
// Design (tile and shared memory). f32 doubles every byte of the bf16 design
// (fused_dense_taps_sm90.cu), whose 8x16 tile needs a 192 x 192 bottleneck
// tile: 144 KB in f32, plus 72 KB for one ring stage of x and w1 big and
// small. So the tile is 8 x 8 outputs:
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
// Limits (the wrapper checks them too): (Cmid, G) = (192, 48) or (128, 32);
// C % 4 == 0; x channels contiguous, pixel strides multiples of 4 elements,
// x 16-byte aligned; out likewise (16-byte stores). w1s is (2, Cmid, C) and
// w2s (2, 3, 3, G, Cmid): [0] big, [1] small, K-major, contiguous. Every
// launch returns the first CUDA error met.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kTH = 8, kTW = 8;                   // output tile
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kHaloP = kHaloH * kHaloW;           // 100 bottleneck pixels
constexpr int kM1 = 128;                          // as 2 x 64 wgmma rows
constexpr int kM2 = kTH * kTW;                    // 64 outputs
constexpr int kWGs = 2;                           // consumer warpgroups
constexpr int kConsumers = kWGs * 128;
constexpr int kConsumerWarps = kConsumers / 32;   // arrivals that free a slot
constexpr int kThreads = kConsumers + 128;        // + the producer warpgroup
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kKC = 32;                           // K chunk: 128 bytes, one swizzle row
constexpr int kRowB = kKC * 4;
constexpr int kPromote1 = 4;                      // stage-1 slots per promotion
static_assert(kHaloP <= kM1 && kM1 == 64 * kWGs && kM2 == 64, "tile geometry");
static_assert(kWGs * kConsumerRegs + kProducerRegs <= 512, "register files");

// SPLIT CTAs (a cluster) share one tile: CTA `rank` computes bottleneck
// channels [rank, rank + 1) * Cmid / SPLIT and output channels
// [rank, rank + 1) * G / SPLIT.
template <int CMID, int G, int SPLIT>
struct Cfg {
  static constexpr int kN1 = CMID / SPLIT;               // stage-1 N of this CTA
  static constexpr int kN2 = G / SPLIT;                  // stage-2 N of this CTA
  static constexpr int kStages1 = SPLIT == 1 ? 2 : 4;    // stage-1 ring slots
  static constexpr int kStages2 = 4;                     // stage-2 ring slots
  static constexpr int kXBytes = kM1 * kRowB;            // x chunk, 128 rows
  static constexpr int kXTx = kHaloP * kRowB;            // what the x box writes
  static constexpr int kW1Bytes = kN1 * kRowB;           // w1 chunk, big or small
  static constexpr int kSlot1 = kXBytes + 2 * kW1Bytes;
  static constexpr int kKB2 = SPLIT == 1 ? 2 : 6;        // 32-channel K blocks a stage-2 slot
  static constexpr int kW2Bytes = kN2 * kRowB;           // w2 K block of one tap, big or small
  static constexpr int kSlot2 = 2 * kKB2 * kW2Bytes;     // K blocks x (big, small)
  static constexpr int kGroups2 = CMID / (kKB2 * kKC);   // stage-2 slots per tap
  static constexpr int kZStride = CMID + 4;              // floats per bottleneck row
  static constexpr int kZ = kStages1 * kSlot1;           // bottleneck tile offset
  static constexpr int kS2 = kZ + kHaloP * kZStride * 4; // s2, b2
  static constexpr int kBar = kS2 + 2 * CMID * 4;        // full1, empty1, full2, empty2
  static constexpr int kBytes = kBar + 2 * (kStages1 + kStages2) * 8;
  static constexpr int kAlloc = kBytes + 1024;           // + alignment of the ring
  static_assert(kStages2 * kSlot2 <= kStages1 * kSlot1, "stage 2's ring fits stage 1's");
  static_assert(kWGs * kM2 * kN2 <= kHaloP * kZStride, "stage-2 sums fit the bottleneck tile");
  static_assert(kXBytes % 1024 == 0 && kW1Bytes % 1024 == 0 && kW2Bytes % 1024 == 0,
                "128-byte swizzle atoms stay 1024-byte aligned");
  static_assert(CMID % (kKB2 * kKC) == 0 && kKB2 % kWGs == 0 && kN1 % 8 == 0 &&
                kN2 % 8 == 0 && kBar % 8 == 0 && kAlloc <= 232448, "shapes");
};

struct TapsParams {
  CUtensorMap x;   // 4-D (C, W, H, B), box (32, 10, 10, 1)
  CUtensorMap w1;  // 2-D (C, 2 Cmid) over w1s, box (32, Cmid / SPLIT)
  CUtensorMap w2;  // 2-D (Cmid, 18 G) over w2s, box (32, G / SPLIT)
  const float *s1, *b1, *s2, *b2;
  float* out;
  int64_t so[3];   // out strides (b, h, w) in elements
  int H, W, C, tiles_h, tiles_w;
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

template <int CMID, int G, int SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    taps_f32_kernel(const __grid_constant__ TapsParams p) {
  using K = Cfg<CMID, G, SPLIT>;
  constexpr int kStages1 = K::kStages1, kStages2 = K::kStages2;
  constexpr int kN1 = K::kN1, kN2 = K::kN2, kKB2 = K::kKB2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* zs = reinterpret_cast<float*>(smem + K::kZ);
  float* s2s = reinterpret_cast<float*>(smem + K::kS2);
  float* b2s = s2s + CMID;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(smem + K::kBar);
  uint64_t* empty1 = full1 + kStages1;
  uint64_t* full2 = empty1 + kStages1;
  uint64_t* empty2 = full2 + kStages2;

  int blk = blockIdx.x / SPLIT;
  const int rank = SPLIT > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int ox0 = (blk % p.tiles_w) * kTW;
  blk /= p.tiles_w;
  const int oy0 = (blk % p.tiles_h) * kTH;
  const int b = blk / p.tiles_h;
  const int nk1 = (p.C + kKC - 1) / kKC;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], kConsumerWarps);
    }
    for (int s = 0; s < kStages2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < CMID; i += kThreads) {
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
        tma_load_4d(slot, &p.x, &full1[s], kc * kKC, ox0 - 1, oy0 - 1, b);
        tma_load_2d(slot + K::kXBytes, &p.w1, &full1[s], kc * kKC, rank * kN1);
        tma_load_2d(slot + K::kXBytes + K::kW1Bytes, &p.w1, &full1[s], kc * kKC,
                    CMID + rank * kN1);
      }
      // The cluster barrier after stage 1 counts every thread; the producer
      // arrives before it waits for stage-2 slots the consumers free after it.
      if (SPLIT > 1) cluster_arrive_thread();
      // Stage 2's ring reuses stage 1's memory: wait until every slot is free.
      for (int kc = nk1; kc < nk1 + kStages1; ++kc) {
        mbar_wait(&empty1[kc % kStages1], ((kc / kStages1) & 1) ^ 1);
      }
      int q = 0;
      for (int tap = 0; tap < 9; ++tap) {
        for (int cg = 0; cg < K::kGroups2; ++cg, ++q) {
          const int s = q % kStages2;
          mbar_wait(&empty2[s], ((q / kStages2) & 1) ^ 1);
          uint8_t* slot = smem + s * K::kSlot2;
          mbar_expect_tx(&full2[s], K::kSlot2);
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
    } else if (SPLIT > 1) {
      cluster_arrive_thread();
    }
    return;
  }

  // ---- consumers: warpgroup wg, warp w of it, lane l ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
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
      // Promotion: the run's sum joins the layer's in z's space (rows past
      // the 100 halo pixels are dropped), rounded to nearest in f32.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (r0 + 8 * e >= kHaloP) continue;
        float* row = zs + (r0 + 8 * e) * K::kZStride + rank * kN1 + 2 * t;
#pragma unroll
        for (int i = 0; i < kN1 / 8; ++i) {
          float2* sum = reinterpret_cast<float2*>(row + 8 * i);
          const float2 before = kc >= kPromote1 ? *sum : make_float2(0.f, 0.f);
          *sum = make_float2(before.x + acc[4 * i + 2 * e], before.y + acc[4 * i + 2 * e + 1]);
        }
      }
    }

    // Epilogue: z = relu(t*s2 + b2) in place of t, 0 on rows outside the
    // image; with SPLIT, into the tile of every CTA of the cluster. Each
    // thread reads only its own elements.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e;
      if (r >= kHaloP) continue;
      const int gy = oy0 - 1 + r / kHaloW, gx = ox0 - 1 + r % kHaloW;
      const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      float* zrow = zs + r * K::kZStride + rank * kN1 + 2 * t;
#pragma unroll
      for (int i = 0; i < kN1 / 8; ++i) {
        const int c = rank * kN1 + 8 * i + 2 * t;
        float2* z = reinterpret_cast<float2*>(zrow + 8 * i);
        const float2 tv = *z;
        const float z0 = in ? fmaxf(__fadd_rn(__fmul_rn(tv.x, s2s[c]), b2s[c]), 0.f) : 0.f;
        const float z1 =
            in ? fmaxf(__fadd_rn(__fmul_rn(tv.y, s2s[c + 1]), b2s[c + 1]), 0.f) : 0.f;
        if constexpr (SPLIT > 1) {
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
  if constexpr (SPLIT > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  }

  // Stage 2: output m0 = 16 w + g is pixel (2w, g) of the tile, m0 + 8 pixel
  // (2w + 1, g); warpgroup wg takes K blocks wg, wg + 2, ... of each slot,
  // output channels [rank, rank + 1) * kN2.
  float acc[kN2 / 2], sum[kN2 / 2];  // one slot's products; the layer's sum
#pragma unroll
  for (int i = 0; i < kN2 / 2; ++i) acc[i] = sum[i] = 0.f;
  const int m0 = w * 16 + g;
  int q = 0;
  for (int tap = 0; tap < 9; ++tap) {
    const float* z0 = zs + ((2 * w + tap / 3) * kHaloW + g + tap % 3) * K::kZStride + t;
    const float* z1 = z0 + kHaloW * K::kZStride;
    for (int cg = 0; cg < K::kGroups2; ++cg, ++q) {
      const int s = q % kStages2;
      uint32_t ab[kKB2 / kWGs][4][4], as[kKB2 / kWGs][4][4];
#pragma unroll
      for (int kb = 0; kb < kKB2 / kWGs; ++kb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = (kKB2 * cg + kWGs * kb + wg) * kKC + 8 * j + 4 * h;
            split(z0[c], ab[kb][j][2 * h], as[kb][j][2 * h]);
            split(z1[c], ab[kb][j][2 * h + 1], as[kb][j][2 * h + 1]);
          }
        }
      }
      mbar_wait(&full2[s], (q / kStages2) & 1);
      const uint8_t* slot = smem + s * K::kSlot2;
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kKB2 / kWGs; ++kb) {
        const uint32_t wb = smem_u32(slot + 2 * (kWGs * kb + wg) * K::kW2Bytes);
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
      for (int kb = 0; kb < kKB2 / kWGs; ++kb) {
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

template <int CMID, int G, int SPLIT>
int launch(TapsParams& p, const void* x, const long long* sx, const void* w1s,
           const void* w2s, int B, cudaStream_t stream) {
  using K = Cfg<CMID, G, SPLIT>;
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(p.C), static_cast<cuuint64_t>(p.W),
                               static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(sx[2]) * 4,
                                  static_cast<cuuint64_t>(sx[1]) * 4,
                                  static_cast<cuuint64_t>(sx[0]) * 4};
  const cuuint32_t xbox[4] = {kKC, kHaloW, kHaloH, 1};
  const cuuint64_t w1dims[2] = {static_cast<cuuint64_t>(p.C), 2 * CMID};
  const cuuint64_t w1strides[1] = {static_cast<cuuint64_t>(p.C) * 4};
  const cuuint32_t w1box[2] = {kKC, K::kN1};
  const cuuint64_t w2dims[2] = {CMID, 18 * G};
  const cuuint64_t w2strides[1] = {CMID * 4};
  const cuuint32_t w2box[2] = {kKC, K::kN2};
  if (!make_map(&p.x, f32, x, 4, xdims, xstrides, xbox) ||
      !make_map(&p.w1, f32, w1s, 2, w1dims, w1strides, w1box) ||
      !make_map(&p.w2, f32, w2s, 2, w2dims, w2strides, w2box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(B) * p.tiles_h * p.tiles_w * SPLIT;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = taps_f32_kernel<CMID, G, SPLIT>;
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
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapsParams p{};
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(out);
  p.so[0] = ob; p.so[1] = oh; p.so[2] = ow;
  p.H = H; p.W = W; p.C = C;
  p.tiles_h = (H + kTH - 1) / kTH;
  p.tiles_w = (W + kTW - 1) / kTW;
  const long long sx[3] = {sb, sh, sw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cmid == 192 && G == 48) {
    // Tiles for at most a quarter of the SMs: three CTAs (a cluster) share each.
    const long long tiles = static_cast<long long>(B) * p.tiles_h * p.tiles_w;
    if (4 * tiles <= sm_count()) return launch<192, 48, 3>(p, x, sx, w1s, w2s, B, s);
    return launch<192, 48, 1>(p, x, sx, w1s, w2s, B, s);
  }
  if (Cmid == 128 && G == 32) return launch<128, 32, 1>(p, x, sx, w1s, w2s, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
