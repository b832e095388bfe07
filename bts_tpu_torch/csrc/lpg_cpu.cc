// Local Planar Guidance on the CPU: the port's copy of native/lpg_cpu.cc's
// arithmetic (LpgForwardImpl, LpgBackwardImpl), as plain C functions on
// pointers for ctypes (ops/lpg_cpu.py), with no XLA headers.
//
// Forward: plane_eq (B, H, W, 4) f32 -> out (B, H*r, W*r) f32, each output
// written once in a row-major sweep, the cell's plane read once per run of r
// pixels. Backward: the analytic gradient of n4 / (n1 u + n2 v + n3), the n4
// factor included (the reference op drops it,
// tensorflow/custom_layer/local_planar_guidance.cc:291-293), each cell's
// r x r tile of the incoming gradient summed in row-major order.
//
// Built by ops/_build.py with g++ -O3 -fPIC -shared -std=c++17.

#include <cstdint>

extern "C" {

// plane_eq: (B, H, W, 4) f32; out: (B, H*r, W*r) f32. Returns 0.
int lpg_cpu_forward(const float* plane_eq, float* out, std::int64_t b, std::int64_t h,
                    std::int64_t w, std::int64_t r) {
  const std::int64_t wr = w * r;
  for (std::int64_t bi = 0; bi < b; ++bi) {
    const float* pe_img = plane_eq + bi * h * w * 4;
    float* o_img = out + bi * h * r * wr;
    for (std::int64_t y = 0; y < h * r; ++y) {
      const float* pe_row = pe_img + (y / r) * w * 4;
      const float v = (static_cast<float>(y % r) - (r - 1) * 0.5f) / static_cast<float>(r);
      float* o_row = o_img + y * wr;
      for (std::int64_t xc = 0; xc < w; ++xc) {
        const float n1 = pe_row[xc * 4 + 0];
        const float n2 = pe_row[xc * 4 + 1];
        const float n3 = pe_row[xc * 4 + 2];
        const float n4 = pe_row[xc * 4 + 3];
        const float base = n2 * v + n3;
        float* o_run = o_row + xc * r;
        for (std::int64_t dx = 0; dx < r; ++dx) {
          const float u = (static_cast<float>(dx) - (r - 1) * 0.5f) / static_cast<float>(r);
          o_run[dx] = n4 / (n1 * u + base);
        }
      }
    }
  }
  return 0;
}

// g: (B, H*r, W*r) f32 incoming gradient; plane_eq: (B, H, W, 4) f32;
// grad: (B, H, W, 4) f32 out. Returns 0.
int lpg_cpu_backward(const float* g, const float* plane_eq, float* grad, std::int64_t b,
                     std::int64_t h, std::int64_t w, std::int64_t r) {
  const std::int64_t wr = w * r;
  for (std::int64_t bi = 0; bi < b; ++bi) {
    for (std::int64_t yc = 0; yc < h; ++yc) {
      for (std::int64_t xc = 0; xc < w; ++xc) {
        const std::int64_t cell = ((bi * h + yc) * w + xc) * 4;
        const float n1 = plane_eq[cell + 0];
        const float n2 = plane_eq[cell + 1];
        const float n3 = plane_eq[cell + 2];
        const float n4 = plane_eq[cell + 3];
        float d1 = 0.f, d2 = 0.f, d3 = 0.f, d4 = 0.f;
        for (std::int64_t dy = 0; dy < r; ++dy) {
          const float v = (static_cast<float>(dy) - (r - 1) * 0.5f) / static_cast<float>(r);
          const float* g_row = g + (bi * h * r + yc * r + dy) * wr + xc * r;
          for (std::int64_t dx = 0; dx < r; ++dx) {
            const float u = (static_cast<float>(dx) - (r - 1) * 0.5f) / static_cast<float>(r);
            const float den = n1 * u + n2 * v + n3;
            const float inv = 1.0f / den;
            const float common = g_row[dx] * n4 * inv * inv;
            d1 -= common * u;
            d2 -= common * v;
            d3 -= common;
            d4 += g_row[dx] * inv;
          }
        }
        grad[cell + 0] = d1;
        grad[cell + 1] = d2;
        grad[cell + 2] = d3;
        grad[cell + 3] = d4;
      }
    }
  }
  return 0;
}

}  // extern "C"
