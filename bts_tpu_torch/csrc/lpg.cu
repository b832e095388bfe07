// Local Planar Guidance for NVIDIA Hopper (sm_90a): the forward with the
// decoder's scale and cast fused into the epilogue (lpg_forward), and its
// gradient with respect to the planes (lpg_backward, at the end of the file).
//
// Replaces the Pallas TPU kernel bts_tpu/ops/lpg_pallas.py::_lpg_kernel
// (launched by _lpg_pallas_fwd_impl with one program per image). That kernel
// widened the (H, W) plane grid to (H*r, W*r) with a one-hot matmul on the
// TPU's matrix unit; nothing here needs that: each thread reads its own cells.
//
//   depth[b, y, x] = n4 / ((n1*u + n2*v) + n3),  (n1..n4) = plane_eq[b, y/r, x/r]
//   u = ((x % r) - (r-1)/2) / r,  v = ((y % r) - (r-1)/2) / r
//   out = T(depth * inv_scale)
//
// with T f32 or bf16 (round to nearest even). The decoder's site is
// (lpg(plane_eq, r) / max_depth).to(dtype); PyTorch's CUDA division of a
// tensor by a Python float multiplies by the f32 reciprocal, so the wrapper
// passes inv_scale = f32(1 / f32(max_depth)) (1 for the bare LPG, which the
// multiply leaves exact) and the kernel gives the composition's bits.
//
// Bound: bytes. The kernel reads 16*B*H*W bytes and writes sizeof(T) *
// B*H*W*r^2. For the three NYU eval sites of one 480x640 image, (r, grid) =
// (8, 60x80), (4, 120x160), (2, 240x320), that is 1.6 MB read and 1.8 MB
// (bf16) or 3.7 MB (f32) written per image. With one output per thread, three
// IEEE divides and integer index math per output, a kernel is bound by
// instructions per output (on an H100, 28% of the f32 bound). This design:
// - each thread owns CPT neighbouring cells along W (CPT = 1, or 2-4 where r
//   and T make a cell row narrower than 16 bytes) and loads each cell's
//   float4 once;
// - the offsets u[i] = (i - (r-1)/2) / r are computed once (__fdiv_rn, the
//   plain version's bits), and with them n1*u[i] and n2*u[j] for the cell:
//   each output then costs two adds, one IEEE divide (__fdiv_rn) and the
//   epilogue, with no integer division;
// - neighbouring threads own neighbouring cells, so each of the r output rows
//   of a warp is one contiguous store of 32 x 16 bytes (32 bytes for f32 at r
//   = 8), written as 16-byte vectors where the row pitch and the pointer
//   allow, else element by element.
// The arithmetic keeps bts_tpu's order with __fmul_rn / __fadd_rn so nvcc
// cannot contract it into FMAs: den can come near 0 (at r = 8, |u|, |v| <=
// 7/16 and theta <= pi/3 give n3 >= 0.5 while |n1*u + n2*v| can reach about
// 0.54). No TMA, wgmma or shared memory: the kernel is memory-bound and
// simple.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// 16 bytes of T from floats.
__device__ __forceinline__ uint4 pack16(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint4 pack16(const float* v, bf16) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Cells per thread: enough for a 16-byte row segment.
template <int R, typename T>
__host__ __device__ constexpr int cells_per_thread() {
  return R * static_cast<int>(sizeof(T)) >= 16 ? 1 : 16 / (R * static_cast<int>(sizeof(T)));
}

// blockIdx.x: cell row b * H + cy; blockIdx.y * blockDim.x + threadIdx.x: the
// group of CPT cells along W.
template <int R, typename T>
__global__ void lpg_kernel(const float4* __restrict__ plane_eq, T* __restrict__ out, int W,
                           float inv_scale, bool vec) {
  constexpr int CPT = cells_per_thread<R, T>();
  constexpr int SEG = CPT * R;               // outputs of one thread in one row
  constexpr int V = 16 / sizeof(T);          // outputs per 16-byte vector
  const int cx0 = (blockIdx.y * blockDim.x + threadIdx.x) * CPT;
  if (cx0 >= W) return;
  const int row = blockIdx.x;  // b * H + cy
  const int cells = min(CPT, W - cx0);

  float u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    u[i] = __fdiv_rn(__fsub_rn(static_cast<float>(i), (R - 1) * 0.5f), static_cast<float>(R));
  }
  float4 n[CPT];
  float a[CPT][R];  // n1 * u[i]
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    n[k] = k < cells ? __ldg(&plane_eq[static_cast<int64_t>(row) * W + cx0 + k])
                     : make_float4(0.f, 0.f, 1.f, 0.f);
#pragma unroll
    for (int i = 0; i < R; ++i) a[k][i] = __fmul_rn(n[k].x, u[i]);
  }

  const int64_t wr = static_cast<int64_t>(W) * R;
  T* base = out + static_cast<int64_t>(row) * R * wr + static_cast<int64_t>(cx0) * R;
  const bool full = vec && cells == CPT;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float v[SEG];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const float bj = __fmul_rn(n[k].y, u[j]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float den = __fadd_rn(__fadd_rn(a[k][i], bj), n[k].z);
        v[k * R + i] = __fmul_rn(__fdiv_rn(n[k].w, den), inv_scale);
      }
    }
    T* dst = base + j * wr;
    if (full) {
#pragma unroll
      for (int s = 0; s < SEG / V; ++s) {
        reinterpret_cast<uint4*>(dst)[s] = pack16(v + s * V, T());
      }
    } else {
#pragma unroll
      for (int e = 0; e < SEG; ++e) {
        if (e < cells * R) put(dst + e, v[e]);
      }
    }
  }
}

template <int R, typename T>
int launch(const float* plane_eq, void* out, int B, int H, int W, float inv_scale,
           cudaStream_t stream) {
  constexpr int CPT = cells_per_thread<R, T>();
  const int64_t rows = static_cast<int64_t>(B) * H;
  const int64_t groups = (W + CPT - 1) / CPT;
  const int threads = static_cast<int>(groups >= 256 ? 256 : (groups + 31) / 32 * 32);
  const int64_t col_blocks = (groups + threads - 1) / threads;
  if (rows > 0x7fffffffLL || col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte stores need every row and every segment 16-byte aligned.
  const bool vec = (static_cast<int64_t>(W) * R * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(rows), static_cast<unsigned int>(col_blocks));
  lpg_kernel<R, T><<<grid, threads, 0, stream>>>(reinterpret_cast<const float4*>(plane_eq),
                                                  static_cast<T*>(out), W, inv_scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const float* plane_eq, void* out, int B, int H, int W, int r, float inv_scale,
             cudaStream_t stream) {
  switch (r) {
    case 2: return launch<2, T>(plane_eq, out, B, H, W, inv_scale, stream);
    case 4: return launch<4, T>(plane_eq, out, B, H, W, inv_scale, stream);
    case 8: return launch<8, T>(plane_eq, out, B, H, W, inv_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// plane_eq: (B, H, W, 4) f32, contiguous, 16-byte aligned. out: (B, H*r, W*r)
// contiguous, f32 (out_bf16 == 0) or bf16. r is 2, 4 or 8. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for what it
// cannot take).
extern "C" int lpg_forward(const float* plane_eq, void* out, int B, int H, int W, int r,
                           float inv_scale, int out_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch<bf16>(plane_eq, out, B, H, W, r, inv_scale, s)
                  : dispatch<float>(plane_eq, out, B, H, W, r, inv_scale, s);
}

// ---------------------------------------------------------------------------
// lpg_backward: the gradient of a decoder site with respect to its planes.
//
// Replaces bts_tpu/ops/lpg.py::_lpg_bwd (XLA; the VJP that the Pallas kernel's
// bts_tpu/ops/lpg_pallas.py::_bwd reuses). For the site
// out = T(lpg(plane_eq, r) * inv_scale), given dL/dout (bf16 or f32, any
// strides), per cell (b, cy, cx) and its r x r tile of pixels (y, x):
//
//   g    = f32(dout[b, y, x]) * inv_scale      (the cast and the scale)
//   den  = (n1*u + n2*v) + n3,  inv = 1 / den
//   c    = ((g * n4) * inv) * inv
//   d n1 = -sum c*u,  d n2 = -sum c*v,  d n3 = -sum c,  d n4 = sum g*inv
//
// with the n4 factor kept (the reference's own CUDA backward drops it). Every
// term is computed in the plain composition's order with __fmul_rn /
// __fadd_rn / __fdiv_rn (no FMA contraction), so each term has the plain
// version's bits; the four sums are taken in f32 in another order than
// PyTorch's reductions (row by row across the tile), which is the only
// difference.
//
// Bound: bytes. The kernel reads the gradient once (B*H*W*r^2 elements) and
// the planes once (16 B a cell) and writes 16 B a cell. At the train sites it
// is a few MB, about a microsecond at 3.35 TB/s, so a launch's floor is the
// practical limit. Design: one thread per cell; neighbouring threads own
// neighbouring cells of one cell row, so for each of the r gradient rows the
// warp reads one contiguous run of 32*r elements (as 16/8/4-byte vectors when
// the row is contiguous and aligned, else element by element with the given
// strides). The four sums stay in registers and leave as one float4.

namespace {

// r consecutive gradient values of one row, as f32.
template <int R, typename T>
__device__ __forceinline__ void load_row(const T* p, int64_t sx, bool vec, float* g) {
  constexpr int BYTES = R * static_cast<int>(sizeof(T));
  if (vec && BYTES % 4 == 0) {
    constexpr int W32 = BYTES / 4;  // 32-bit words in the row segment
    uint32_t w[W32];
    if constexpr (W32 % 4 == 0) {
#pragma unroll
      for (int k = 0; k < W32 / 4; ++k) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
        w[4 * k] = q.x; w[4 * k + 1] = q.y; w[4 * k + 2] = q.z; w[4 * k + 3] = q.w;
      }
    } else if constexpr (W32 % 2 == 0) {
#pragma unroll
      for (int k = 0; k < W32 / 2; ++k) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + k);
        w[2 * k] = q.x; w[2 * k + 1] = q.y;
      }
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
    const T* v = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int i = 0; i < R; ++i) g[i] = to_f32(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) g[i] = to_f32(p[i * sx]);
  }
}

template <int R, typename T>
__global__ void lpg_bwd_kernel(const float4* __restrict__ plane_eq, const T* __restrict__ grad,
                               float4* __restrict__ dplane, int H, int W, int64_t sb, int64_t sy,
                               int64_t sx, float inv_scale, bool scale, bool vec) {
  const int cx = blockIdx.y * blockDim.x + threadIdx.x;
  if (cx >= W) return;
  const int row = blockIdx.x;  // b * H + cy
  const int b = row / H, cy = row - b * H;
  const int64_t cell = static_cast<int64_t>(row) * W + cx;

  float u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    u[i] = __fdiv_rn(__fsub_rn(static_cast<float>(i), (R - 1) * 0.5f), static_cast<float>(R));
  }
  const float4 n = __ldg(&plane_eq[cell]);
  float a[R];  // n1 * u[i]
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = __fmul_rn(n.x, u[i]);

  const T* base = grad + b * sb + static_cast<int64_t>(cy) * R * sy +
                  static_cast<int64_t>(cx) * R * sx;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float g[R];
    load_row<R, T>(base + j * sy, sx, vec, g);
    const float bj = __fmul_rn(n.y, u[j]);
    float t1 = 0.f, t3 = 0.f, t4 = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float gi = scale ? __fmul_rn(g[i], inv_scale) : g[i];
      const float den = __fadd_rn(__fadd_rn(a[i], bj), n.z);
      const float inv = __fdiv_rn(1.0f, den);
      const float c = __fmul_rn(__fmul_rn(__fmul_rn(gi, n.w), inv), inv);
      t1 = __fadd_rn(t1, __fmul_rn(c, u[i]));
      s2 = __fadd_rn(s2, __fmul_rn(c, u[j]));
      t3 = __fadd_rn(t3, c);
      t4 = __fadd_rn(t4, __fmul_rn(gi, inv));
    }
    s1 = __fadd_rn(s1, t1);
    s3 = __fadd_rn(s3, t3);
    s4 = __fadd_rn(s4, t4);
  }
  dplane[cell] = make_float4(-s1, -s2, -s3, s4);
}

template <int R, typename T>
int launch_bwd(const float* plane_eq, const void* grad, float* dplane, int B, int H, int W,
               int64_t sb, int64_t sy, int64_t sx, float inv_scale, int scale,
               cudaStream_t stream) {
  constexpr int BYTES = R * static_cast<int>(sizeof(T));
  constexpr int ALIGN = BYTES >= 16 ? 16 : BYTES;
  const int64_t rows = static_cast<int64_t>(B) * H;
  const int threads = W >= 128 ? 128 : (W + 31) / 32 * 32;
  const int64_t col_blocks = (W + threads - 1) / threads;
  if (rows > 0x7fffffffLL || col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t esize = sizeof(T);
  // Vector loads need each tile row's r values contiguous and every segment
  // aligned to the vector: a unit x stride, and the pointer and both outer
  // strides (in bytes) multiples of the vector's size.
  const bool vec = BYTES % 4 == 0 && sx == 1 &&
                   reinterpret_cast<uintptr_t>(grad) % ALIGN == 0 &&
                   (sb * esize) % ALIGN == 0 && (sy * esize) % ALIGN == 0;
  const dim3 grid(static_cast<unsigned int>(rows), static_cast<unsigned int>(col_blocks));
  lpg_bwd_kernel<R, T><<<grid, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(plane_eq), static_cast<const T*>(grad),
      reinterpret_cast<float4*>(dplane), H, W, sb, sy, sx, inv_scale, scale != 0, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const float* plane_eq, const void* grad, float* dplane, int B, int H, int W,
                 int r, int64_t sb, int64_t sy, int64_t sx, float inv_scale, int scale,
                 cudaStream_t stream) {
  switch (r) {
    case 2:
      return launch_bwd<2, T>(plane_eq, grad, dplane, B, H, W, sb, sy, sx, inv_scale, scale, stream);
    case 4:
      return launch_bwd<4, T>(plane_eq, grad, dplane, B, H, W, sb, sy, sx, inv_scale, scale, stream);
    case 8:
      return launch_bwd<8, T>(plane_eq, grad, dplane, B, H, W, sb, sy, sx, inv_scale, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// plane_eq: (B, H, W, 4) f32, contiguous, 16-byte aligned. grad: (B, H*r, W*r)
// f32 (grad_bf16 == 0) or bf16, with element strides (sb, sy, sx). dplane:
// (B, H, W, 4) f32, contiguous, 16-byte aligned. The gradient is multiplied by
// inv_scale unless scale == 0. r is 2, 4 or 8. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what it cannot take).
extern "C" int lpg_backward(const float* plane_eq, const void* grad, float* dplane, int B, int H,
                            int W, int r, int64_t sb, int64_t sy, int64_t sx, float inv_scale,
                            int scale, int grad_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_bf16) {
    return dispatch_bwd<bf16>(plane_eq, grad, dplane, B, H, W, r, sb, sy, sx, inv_scale, scale, s);
  }
  return dispatch_bwd<float>(plane_eq, grad, dplane, B, H, W, r, sb, sy, sx, inv_scale, scale, s);
}
