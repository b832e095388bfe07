// Fused DenseNet layer (inference), even/odd form, for NVIDIA Hopper (sm_90a),
// f32 and bf16: fused_dense_eo_f32, fused_dense_eo_bf16.
//
// Replaces the Pallas TPU kernel fused_dense_layer_eo (docs/archive/
// fused_dense.py:216, body _kernel_eo :109). The taps form of the same layer
// (fused_dense_layer :167) is fused_dense_taps_sm90.cu (bf16) and
// fused_dense_taps_f32_sm90.cu (f32, the dtype cli.test serves by default);
// this file keeps the first design of both forms for eo alone (dense_impl
// "eo", on no default path) until eo is redesigned as taps was.
// It computes one torchvision dense layer with the BatchNorms folded:
//   y = dt(relu(x*s1 + b1)); t = f32(y . w1); z = dt(relu(t*s2 + b2));
//   out = dt(sum over the 3x3 taps of z . w2), z zero-padded by 1.
// The TPU kernel holds one whole image in VMEM (grid = B). Here a block holds
// one output tile: it computes the bottleneck z for the tile plus a one-pixel
// halo into shared memory, then runs the 3x3 from there. The 4g-wide
// bottleneck never reaches device memory.
//
// Bound. By its counts the layer is bound by operations: DenseNet161 at
// 480x640 does about 40.7 GMAC per image in these layers (1x1 22.2, 3x3
// 18.5) and reads about 0.23 GB of layer input in bf16. bf16 runs both
// products on the tensor cores through WMMA (16x16x16 bf16 fragments, f32
// accumulators held in registers across the whole K loop); f32 runs plain
// FMAs from shared memory (a register tile per thread).
// Both products are K loops over 32-wide chunks staged in shared memory with
// a __syncthreads on each side: no TMA, no wgmma, no double buffering. So
// this design is bound by latency, not by the tensor cores: each
// barrier-separated chunk holds only a few MMAs per warp, and loads and
// products never overlap. On an H100 80GB HBM3 at 700 W its bf16 form takes
// about 2.9x the time of cuDNN's unfused chain of the same layer (PERF.md).
//
// Geometry. A tile is 3 rows x 16 column pairs (32 output columns), halo
// 5 x 34; the halo is the interleaved image rebuilt from xe and xo, so local
// column 2u holds zo[u-1], 2u+1 ze[u], 2u+2 zo[u], 2u+3 ze[u+1]: the four
// taps of pack_w2_eo. One row of the 3x3 product's M dimension is 16 column pairs of
// one output row, so a 16-row WMMA tile of A is 16 rows of the bottleneck
// tile at a stride of 2 pixels. The 3x3 is one K loop over the packed
// (12*Cmid, 2G) kernel (4/3 the FLOPs, as on the TPU: its zero blocks are
// multiplied, not skipped). Pixels outside the image are 0 in z, not the
// bottleneck of a zero input.
//
// Limits (the wrapper checks them too): C % (16 bytes / element) == 0,
// Cmid % 32 == 0 and Cmid <= 192, G % 8 == 0 and G <= 64, channels
// contiguous, pixel strides multiples of 16 bytes, x 16-byte aligned.
// Every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;         // K chunk of both products
constexpr int kMaxCmid = 192;   // bottleneck channels
constexpr int kCols = 16;       // 3x3 product rows per output row of a tile
constexpr int kStLd = 20;       // per-warp f32 staging tile, 16 x 20 floats

struct Geom {
  static constexpr int TH = 3;                                 // output rows per tile
  static constexpr int kTW = 2 * kCols;                        // output columns per tile
  static constexpr int kHaloW = kTW + 2;
  static constexpr int kHaloP = (TH + 2) * kHaloW;             // bottleneck pixels
  static constexpr int kHaloPp = (kHaloP + 15) / 16 * 16;      // as rows of 16
  static constexpr int kM2 = TH * kCols;                       // 3x3 product rows
  static constexpr int kTapsPerRow = 4;                        // lane-concat blocks
  static constexpr int kColMul = 2;                            // pixels per pair
  static constexpr int kMaxN2 = 128;                           // 2G
  // WMMA warp grids: stage 1 (bottleneck, M = halo pixels, N = Cmid), stage 2
  // (3x3, M = kM2, N = N2). Each warp owns the tiles (wm + WM*i, wn + WN*j).
  static constexpr int kWM1 = 4, kWN1 = kWarps / kWM1;
  static constexpr int kMI1 = (kHaloPp / 16 + kWM1 - 1) / kWM1;
  static constexpr int kNI1 = (kMaxCmid / 16 + kWN1 - 1) / kWN1;
  static constexpr int kWM2 = 4, kWN2 = kWarps / kWM2;
  static constexpr int kMI2 = (TH + kWM2 - 1) / kWM2;
  static constexpr int kNI2 = (kMaxN2 / 16 + kWN2 - 1) / kWN2;
  // FMA thread grid (f32): 32 row groups x 16 column groups.
  static constexpr int kFI1 = kHaloPp / 32 + (kHaloPp % 32 ? 1 : 0);
  static constexpr int kFJ1 = kMaxCmid / 16;
  static constexpr int kFI2 = kM2 / 32 + (kM2 % 32 ? 1 : 0);
  static constexpr int kFJ2 = kMaxN2 / 16;
  static_assert(kHaloPp <= 192, "bottleneck tile too tall");
};

struct Params {
  const void* x0;  // xe
  const void* x1;  // xo
  int64_t sx0[3], sx1[3];  // b, h, w strides in elements
  const void *s1, *b1, *w1, *s2, *b2, *w2;
  void* out;
  int64_t so[4];  // b, h, column pair, parity
  int B, H, W;    // W: columns of the full image (2U)
  int C, Cmid, G, N2, N2p;
  int tiles_h, tiles_w;
};

struct Layout {
  int ldz, lda, ldb;
  int as_off, bs_off, st_off, bytes;
};

__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

// Shared memory: Zs (bottleneck tile), As (stage-1 A chunk), Bs (B chunk of
// either product), St (bf16 only: per-warp staging of accumulator tiles).
// bf16 leading dimensions keep every WMMA pointer 32-byte aligned.
__host__ __device__ inline Layout make_layout(int esize, int hpp, int cmid, int n2p) {
  Layout L;
  const bool half = esize == 2;
  L.ldz = cmid + (half ? 16 : 4);
  L.lda = kKC + (half ? 8 : 4);
  L.ldb = (cmid > n2p ? cmid : n2p) + (half ? 8 : 4);
  L.as_off = align128(hpp * L.ldz * esize);
  L.bs_off = L.as_off + align128(hpp * L.lda * esize);
  L.st_off = L.bs_off + align128(kKC * L.ldb * esize);
  L.bytes = L.st_off + (half ? kWarps * 16 * kStLd * 4 : 0);
  return L;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// Round to T and back: the rounding points of the plain version.
template <typename T>
__device__ __forceinline__ float rd(float v) { return to_f(from_f<T>(v)); }

// 16 bytes of T <-> floats.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  float v[N];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f(e[j]);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = 0.f;
  }
  __device__ __forceinline__ void store(T* p) const {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
struct Tile {
  using G = Geom;
  const Params& p;
  int b, oy0, ox0;

  // Is bottleneck-tile row r a pixel inside the image? Sets its pointer.
  __device__ __forceinline__ bool halo_pixel(int r, const T*& px) const {
    if (r >= G::kHaloP) return false;
    const int gy = oy0 - 1 + r / G::kHaloW;
    const int gx = ox0 - 1 + r % G::kHaloW;
    if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W) return false;
    if (gx & 1) {
      px = static_cast<const T*>(p.x1) + b * p.sx1[0] + gy * p.sx1[1] + (gx >> 1) * p.sx1[2];
    } else {
      const int col = gx >> 1;
      px = static_cast<const T*>(p.x0) + b * p.sx0[0] + gy * p.sx0[1] + col * p.sx0[2];
    }
    return true;
  }

  // Bottleneck-tile row read by 3x3-product row r at tap t.
  __device__ __forceinline__ int zrow(int r, int t) const {
    return (r / kCols + t / G::kTapsPerRow) * G::kHaloW + G::kColMul * (r % kCols) +
           t % G::kTapsPerRow;
  }

  // Writes 3x3-product element (r, n) to out if it lies inside the image.
  __device__ __forceinline__ void store_out(int r, int n, float v) const {
    if (n >= p.N2) return;
    const int oy = oy0 + r / kCols;
    const int col = ox0 / 2 + r % kCols;
    if (oy >= p.H || col >= p.W / 2) return;
    int64_t off = b * p.so[0] + oy * p.so[1] + col * p.so[2];
    off += (n >= p.G) * p.so[3] + (n >= p.G ? n - p.G : n);
    static_cast<T*>(p.out)[off] = from_f<T>(v);
  }
};

// Stage-1 chunk: As = y for channels [k0, k0+32) of every halo pixel,
// Bs = w1 rows [k0, k0+32). Zero where out of range.
template <typename T>
__device__ __forceinline__ void load_chunk1(const Tile<T>& tile, const Layout& L,
                                            T* As, T* Bs, int k0) {
  using G = Geom;
  constexpr int V = Vec<T>::N;
  constexpr int kVecs = kKC / V;
  const Params& p = tile.p;
  const T* s1 = static_cast<const T*>(p.s1);
  const T* b1 = static_cast<const T*>(p.b1);
  for (int idx = threadIdx.x; idx < G::kHaloPp * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = k0 + (idx % kVecs) * V;
    Vec<T> v;
    const T* px = nullptr;
    if (c < p.C && tile.halo_pixel(r, px)) {
      v.load(px + c);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xs = rd<T>(__fmul_rn(v.v[j], to_f(__ldg(s1 + c + j))));
        v.v[j] = fmaxf(rd<T>(__fadd_rn(xs, to_f(__ldg(b1 + c + j)))), 0.f);
      }
    } else {
      v.zero();
    }
    v.store(As + r * L.lda + (idx % kVecs) * V);
  }
  const int vecs_row = p.Cmid / V;
  const T* w1 = static_cast<const T*>(p.w1);
  for (int idx = threadIdx.x; idx < kKC * vecs_row; idx += kThreads) {
    const int k = idx / vecs_row;
    const int n = (idx % vecs_row) * V;
    Vec<T> v;
    if (k0 + k < p.C) {
      v.load(w1 + static_cast<int64_t>(k0 + k) * p.Cmid + n);
    } else {
      v.zero();
    }
    v.store(Bs + k * L.ldb + n);
  }
}

// Stage-2 chunk: Bs = rows [k0, k0+32) of the flattened 3x3 kernel, columns
// [0, N2p), zero beyond N2.
template <typename T>
__device__ __forceinline__ void load_chunk2(const Params& p, const Layout& L, T* Bs, int k0) {
  constexpr int V = Vec<T>::N;
  const int vecs_row = p.N2p / V;
  const T* w2 = static_cast<const T*>(p.w2);
  for (int idx = threadIdx.x; idx < kKC * vecs_row; idx += kThreads) {
    const int k = idx / vecs_row;
    const int n = (idx % vecs_row) * V;
    Vec<T> v;
    if (n < p.N2) {
      v.load(w2 + static_cast<int64_t>(k0 + k) * p.N2 + n);
    } else {
      v.zero();
    }
    v.store(Bs + k * L.ldb + n);
  }
}

// z = dt(relu(acc*s2 + b2)) for bottleneck row r, channel n; 0 outside the image.
template <typename T>
__device__ __forceinline__ float bottleneck_value(const Tile<T>& tile, int r, int n,
                                                  float acc) {
  const T* unused = nullptr;
  if (!tile.halo_pixel(r, unused)) return 0.f;
  const float s2 = to_f(__ldg(static_cast<const T*>(tile.p.s2) + n));
  const float b2 = to_f(__ldg(static_cast<const T*>(tile.p.b2) + n));
  return fmaxf(__fadd_rn(__fmul_rn(acc, s2), b2), 0.f);
}

// ---- bf16: both products on the tensor cores (WMMA) ----
__device__ __forceinline__ void run_wmma(const Tile<bf16>& tile, const Layout& L,
                                         bf16* Zs, bf16* As, bf16* Bs, float* St) {
  using G = Geom;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const Params& p = tile.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = St + warp * 16 * kStLd;

  {  // Stage 1: bottleneck of the halo tile.
    const int wm = warp / G::kWN1, wn = warp % G::kWN1;
    const int mt1 = G::kHaloPp / 16, nt1 = p.Cmid / 16;
    FragC acc[G::kMI1][G::kNI1];
#pragma unroll
    for (int i = 0; i < G::kMI1; ++i)
#pragma unroll
      for (int j = 0; j < G::kNI1; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < p.C; k0 += kKC) {
      __syncthreads();
      load_chunk1(tile, L, As, Bs, k0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        FragB bfr[G::kNI1];
#pragma unroll
        for (int j = 0; j < G::kNI1; ++j) {
          const int nt = wn + G::kWN1 * j;
          if (nt < nt1) wmma::load_matrix_sync(bfr[j], Bs + kk * L.ldb + nt * 16, L.ldb);
        }
#pragma unroll
        for (int i = 0; i < G::kMI1; ++i) {
          const int mt = wm + G::kWM1 * i;
          if (mt >= mt1) continue;
          FragA a;
          wmma::load_matrix_sync(a, As + mt * 16 * L.lda + kk, L.lda);
#pragma unroll
          for (int j = 0; j < G::kNI1; ++j) {
            if (wn + G::kWN1 * j < nt1) wmma::mma_sync(acc[i][j], a, bfr[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G::kMI1; ++i) {
#pragma unroll
      for (int j = 0; j < G::kNI1; ++j) {
        const int mt = wm + G::kWM1 * i, nt = wn + G::kWN1 * j;
        if (mt >= mt1 || nt >= nt1) continue;
        wmma::store_matrix_sync(st, acc[i][j], kStLd, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = mt * 16 + e / 16, n = nt * 16 + e % 16;
          Zs[r * L.ldz + n] =
              __float2bfloat16_rn(bottleneck_value(tile, r, n, st[(e / 16) * kStLd + e % 16]));
        }
        __syncwarp();
      }
    }
  }

  {  // Stage 2: the 3x3 from the bottleneck tile.
    const int wm = warp / G::kWN2, wn = warp % G::kWN2;
    const int nt2 = p.N2p / 16;
    const int k2 = G::kTapsPerRow * 3 * p.Cmid;
    FragC acc[G::kMI2][G::kNI2];
#pragma unroll
    for (int i = 0; i < G::kMI2; ++i)
#pragma unroll
      for (int j = 0; j < G::kNI2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < k2; k0 += kKC) {
      __syncthreads();
      load_chunk2(p, L, Bs, k0);
      __syncthreads();
      const int t = k0 / p.Cmid, m0 = k0 % p.Cmid;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        FragB bfr[G::kNI2];
#pragma unroll
        for (int j = 0; j < G::kNI2; ++j) {
          const int nt = wn + G::kWN2 * j;
          if (nt < nt2) wmma::load_matrix_sync(bfr[j], Bs + kk * L.ldb + nt * 16, L.ldb);
        }
#pragma unroll
        for (int i = 0; i < G::kMI2; ++i) {
          const int mt = wm + G::kWM2 * i;
          if (mt >= G::TH) continue;
          FragA a;
          wmma::load_matrix_sync(a, Zs + tile.zrow(mt * 16, t) * L.ldz + m0 + kk,
                                 G::kColMul * L.ldz);
#pragma unroll
          for (int j = 0; j < G::kNI2; ++j) {
            if (wn + G::kWN2 * j < nt2) wmma::mma_sync(acc[i][j], a, bfr[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G::kMI2; ++i) {
#pragma unroll
      for (int j = 0; j < G::kNI2; ++j) {
        const int mt = wm + G::kWM2 * i, nt = wn + G::kWN2 * j;
        if (mt >= G::TH || nt >= nt2) continue;
        wmma::store_matrix_sync(st, acc[i][j], kStLd, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          tile.store_out(mt * 16 + e / 16, nt * 16 + e % 16, st[(e / 16) * kStLd + e % 16]);
        }
        __syncwarp();
      }
    }
  }
}

// ---- f32: both products as FMAs from shared memory ----
__device__ __forceinline__ void run_fma(const Tile<float>& tile, const Layout& L,
                                        float* Zs, float* As, float* Bs) {
  using G = Geom;
  const Params& p = tile.p;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  {  // Stage 1: rows tr + 32i of the halo tile, channels tc + 16j.
    float acc[G::kFI1][G::kFJ1];
#pragma unroll
    for (int i = 0; i < G::kFI1; ++i)
#pragma unroll
      for (int j = 0; j < G::kFJ1; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < p.C; k0 += kKC) {
      __syncthreads();
      load_chunk1(tile, L, As, Bs, k0);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float a[G::kFI1], bv[G::kFJ1];
#pragma unroll
        for (int i = 0; i < G::kFI1; ++i) {
          const int r = tr + 32 * i;
          a[i] = r < G::kHaloPp ? As[r * L.lda + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < G::kFJ1; ++j) {
          const int n = tc + 16 * j;
          bv[j] = n < p.Cmid ? Bs[k * L.ldb + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < G::kFI1; ++i)
#pragma unroll
          for (int j = 0; j < G::kFJ1; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kFI1; ++i) {
#pragma unroll
      for (int j = 0; j < G::kFJ1; ++j) {
        const int r = tr + 32 * i, n = tc + 16 * j;
        if (r < G::kHaloPp && n < p.Cmid) Zs[r * L.ldz + n] = bottleneck_value(tile, r, n, acc[i][j]);
      }
    }
  }

  {  // Stage 2: 3x3-product rows tr + 32i, columns tc + 16j.
    const int k2 = G::kTapsPerRow * 3 * p.Cmid;
    float acc[G::kFI2][G::kFJ2];
#pragma unroll
    for (int i = 0; i < G::kFI2; ++i)
#pragma unroll
      for (int j = 0; j < G::kFJ2; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < k2; k0 += kKC) {
      __syncthreads();
      load_chunk2(p, L, Bs, k0);
      __syncthreads();
      const int t = k0 / p.Cmid, m0 = k0 % p.Cmid;
      int zr[G::kFI2];
#pragma unroll
      for (int i = 0; i < G::kFI2; ++i) {
        const int r = tr + 32 * i;
        zr[i] = r < G::kM2 ? tile.zrow(r, t) * L.ldz + m0 : -1;
      }
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float a[G::kFI2], bv[G::kFJ2];
#pragma unroll
        for (int i = 0; i < G::kFI2; ++i) a[i] = zr[i] >= 0 ? Zs[zr[i] + k] : 0.f;
#pragma unroll
        for (int j = 0; j < G::kFJ2; ++j) {
          const int n = tc + 16 * j;
          bv[j] = n < p.N2p ? Bs[k * L.ldb + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < G::kFI2; ++i)
#pragma unroll
          for (int j = 0; j < G::kFJ2; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kFI2; ++i) {
#pragma unroll
      for (int j = 0; j < G::kFJ2; ++j) {
        const int r = tr + 32 * i;
        if (r < G::kM2) tile.store_out(r, tc + 16 * j, acc[i][j]);
      }
    }
  }
}

template <typename T>
// __grid_constant__: Tile keeps a reference to p without a copy to local memory.
__global__ void __launch_bounds__(kThreads, 1)
    fused_dense_kernel(const __grid_constant__ Params p) {
  using G = Geom;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(sizeof(T), G::kHaloPp, p.Cmid, p.N2p);
  T* Zs = reinterpret_cast<T*>(smem);
  T* As = reinterpret_cast<T*>(smem + L.as_off);
  T* Bs = reinterpret_cast<T*>(smem + L.bs_off);

  int blk = blockIdx.x;
  const int tx = blk % p.tiles_w;
  blk /= p.tiles_w;
  const int ty = blk % p.tiles_h;
  const Tile<T> tile{p, blk / p.tiles_h, ty * G::TH, tx * G::kTW};
  if constexpr (std::is_same<T, bf16>::value) {
    run_wmma(tile, L, Zs, As, Bs, reinterpret_cast<float*>(smem + L.st_off));
  } else {
    run_fma(tile, L, Zs, As, Bs);
  }
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  using G = Geom;
  p.tiles_h = (p.H + G::TH - 1) / G::TH;
  p.tiles_w = (p.W + G::kTW - 1) / G::kTW;
  const int64_t blocks = static_cast<int64_t>(p.B) * p.tiles_h * p.tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(sizeof(T), G::kHaloPp, p.Cmid, p.N2p);
  cudaError_t err = cudaFuncSetAttribute(fused_dense_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_dense_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, L.bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shapes and fills the derived sizes; false on what the kernel cannot take.
template <typename T>
bool finish_params(Params& p) {
  constexpr int V = 16 / sizeof(T);
  p.N2 = 2 * p.G;
  p.N2p = (p.N2 + 15) / 16 * 16;
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || p.C <= 0) return false;
  if (p.C % V || p.Cmid % kKC || p.Cmid > kMaxCmid || p.G % 8 || p.G <= 0 || p.G > 64) return false;
  for (int i = 0; i < 3; ++i) {
    if (p.sx0[i] % V || p.sx1[i] % V) return false;
  }
  return true;
}

template <typename T>
int eo(const void* xe, long long eb, long long eh, long long eu, const void* xo, long long ob_,
       long long oh_, long long ou_, const void* s1, const void* b1, const void* w1,
       const void* s2, const void* b2, const void* w2q, void* out, long long pb, long long ph,
       long long pu, long long pp, int B, int H, int U, int C, int Cmid, int G, void* stream) {
  Params p{};
  p.x0 = xe; p.x1 = xo;
  p.sx0[0] = eb; p.sx0[1] = eh; p.sx0[2] = eu;
  p.sx1[0] = ob_; p.sx1[1] = oh_; p.sx1[2] = ou_;
  p.s1 = s1; p.b1 = b1; p.w1 = w1; p.s2 = s2; p.b2 = b2; p.w2 = w2q;
  p.out = out;
  p.so[0] = pb; p.so[1] = ph; p.so[2] = pu; p.so[3] = pp;
  p.B = B; p.H = H; p.W = 2 * U; p.C = C; p.Cmid = Cmid; p.G = G;
  if (!finish_params<T>(p)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

// xe, xo: (B,H,U,C) even / odd columns, each through its strides. w2q:
// (3, 4*Cmid, 2G) from pack_w2_eo. out: (B,H,U,2,G) through strides (pb, ph,
// pu, pp): [.., 0, :] the even output columns, [.., 1, :] the odd ones.
extern "C" int fused_dense_eo_f32(const void* xe, long long eb, long long eh, long long eu,
                                  const void* xo, long long ob, long long oh, long long ou,
                                  const void* s1, const void* b1, const void* w1, const void* s2,
                                  const void* b2, const void* w2q, void* out, long long pb,
                                  long long ph, long long pu, long long pp, int B, int H, int U,
                                  int C, int Cmid, int G, void* stream) {
  return eo<float>(xe, eb, eh, eu, xo, ob, oh, ou, s1, b1, w1, s2, b2, w2q, out, pb, ph, pu, pp,
                   B, H, U, C, Cmid, G, stream);
}

extern "C" int fused_dense_eo_bf16(const void* xe, long long eb, long long eh, long long eu,
                                   const void* xo, long long ob, long long oh, long long ou,
                                   const void* s1, const void* b1, const void* w1,
                                   const void* s2, const void* b2, const void* w2q, void* out,
                                   long long pb, long long ph, long long pu, long long pp, int B,
                                   int H, int U, int C, int Cmid, int G, void* stream) {
  return eo<bf16>(xe, eb, eh, eu, xo, ob, oh, ou, s1, b1, w1, s2, b2, w2q, out, pb, ph, pu, pp,
                  B, H, U, C, Cmid, G, stream);
}
