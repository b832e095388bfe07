// Local Planar Guidance forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bts_tpu/ops/lpg_pallas.py::_lpg_kernel
// (launched by _lpg_pallas_fwd_impl with one program per image). That kernel
// widened the (H, W) plane grid to (H*r, W*r) with a one-hot matmul on the
// TPU's matrix unit; nothing here needs that: each thread reads its own cell.
//
//   depth[b, y, x] = n4 / ((n1*u + n2*v) + n3),  (n1..n4) = plane_eq[b, y/r, x/r]
//   u = ((x % r) - (r-1)/2) / r,  v = ((y % r) - (r-1)/2) / r
//
// Bound: bytes. The kernel reads 16*B*H*W bytes and writes 4*B*H*W*r^2; it
// does 2 multiplies, 2 adds and 1 divide per output float. For the three NYU
// eval sites of one 480x640 image, (r, grid) = (8, 60x80), (4, 120x160),
// (2, 240x320), that is about 1.6 MB read and 3.7 MB written per image: about
// 1.6 us per image at 3.35 TB/s. At small batch the launch overhead (a few us)
// dominates. As written, the kernel does not reach that bound: on an H100 it
// stores about 0.8 TB/s, because each output costs three IEEE divides and the
// integer index math (about 100 instructions); see PERF.md for the numbers
// and the next step (several outputs per thread, 16-byte stores).
//
// Design: a 2-D grid. blockIdx.x is one output row (b, y) of B*H*r rows;
// blockIdx.y and the thread index give x, fastest, so a warp stores 32
// consecutive floats (128 bytes). A block therefore needs no 64-bit division
// to find its row: the first version, one 1-D grid with 64-bit div/mod per
// thread, was 1.2x slower on the H100. Each thread loads its
// cell's four floats as one 16-byte float4 from the contiguous (B, H, W, 4)
// input (the wrapper checks 16-byte alignment); the r neighbours along x
// share that cell, so the load is served from L1. Only the flat offsets are
// 64-bit. The arithmetic uses __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc
// cannot contract it into FMAs or reassociate it: the result then equals the
// plain PyTorch version (separate multiply, add and IEEE divide) to the last
// bit. That matters because den can come near 0: at r = 8, |u|, |v| <= 7/16
// and theta <= pi/3 give n3 >= 0.5 while |n1*u + n2*v| can reach about 0.54.
// No TMA, wgmma or tiling: the kernel is memory-bound and simple.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void lpg_forward_kernel(const float4* __restrict__ plane_eq,
                                   float* __restrict__ out, int H, int W, int r) {
  const int wr = W * r;
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= wr) return;
  const int hr = H * r;
  const int row = blockIdx.x;  // b * hr + y
  const int b = row / hr;
  const int y = row - b * hr;
  const int cx = x / r;
  const int cy = y / r;

  const float4 n = __ldg(&plane_eq[(static_cast<int64_t>(b) * H + cy) * W + cx]);
  const float half = static_cast<float>(r - 1) * 0.5f;
  const float fr = static_cast<float>(r);
  const float u = __fdiv_rn(__fsub_rn(static_cast<float>(x - cx * r), half), fr);
  const float v = __fdiv_rn(__fsub_rn(static_cast<float>(y - cy * r), half), fr);
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(n.x, u), __fmul_rn(n.y, v)), n.z);
  out[static_cast<int64_t>(row) * wr + x] = __fdiv_rn(n.w, den);
}

}  // namespace

// plane_eq: (B, H, W, 4) f32, contiguous, 16-byte aligned. out: (B, H*r, W*r)
// f32, contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int lpg_forward_f32(const float* plane_eq, float* out, int B, int H,
                               int W, int r, void* stream) {
  const int64_t rows = static_cast<int64_t>(B) * H * r;
  const int64_t wr = static_cast<int64_t>(W) * r;
  if (rows <= 0 || wr <= 0) return static_cast<int>(cudaSuccess);
  const int64_t col_blocks = (wr + kThreads - 1) / kThreads;
  if (rows > 0x7fffffffLL || col_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(rows), static_cast<unsigned int>(col_blocks));
  lpg_forward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(plane_eq), out, H, W, r);
  return static_cast<int>(cudaGetLastError());
}
