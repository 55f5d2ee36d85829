// A layout variant of goofer_tpu_torch/csrc/lpc_roots.cu, built and timed
// by tools/torch_lpc_kernel_variants.py and used nowhere else: one THREAD
// per row, all `order` roots of the row in registers, no shuffles.  The
// same Durand-Kerner iteration, complex products, division and guard as
// the kept kernel; instantiated for order 10 only (the formant tracker's
// order, and every timed case's), other orders are refused.

#include <cuda_runtime.h>

namespace {

constexpr int kOrder = 10;
constexpr int kThreads = 128;

struct Cx {
  float re, im;
};

__device__ __forceinline__ Cx cmul(Cx a, Cx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ __forceinline__ Cx cdiv(Cx a, Cx b) {
  const bool re_big = fabsf(b.re) >= fabsf(b.im);
  const float big = re_big ? b.re : b.im;
  const float small = re_big ? b.im : b.re;
  const float rat = small / big;
  const float scl = 1.0f / (big + small * rat);
  const float p = re_big ? a.re : a.im;
  const float q = re_big ? a.im : a.re;
  const float s = re_big ? a.im : -a.re;
  const float t = re_big ? -a.re : a.im;
  return {(p + q * rat) * scl, (s + t * rat) * scl};
}

__global__ void __launch_bounds__(kThreads)
lpc_roots_thread_kernel(const float* __restrict__ coeffs,
                        float* __restrict__ roots, int rows, int iters) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  float c[kOrder + 1];
#pragma unroll
  for (int i = 0; i <= kOrder; ++i) {
    c[i] = coeffs[static_cast<size_t>(row) * (kOrder + 1) + i];
  }
  Cx z[kOrder];
#pragma unroll
  for (int k = 0; k < kOrder; ++k) {
    const double angle = 2.0 * 3.14159265358979323846 * (k + 0.25) / kOrder;
    z[k] = {static_cast<float>(0.9 * cos(angle)),
            static_cast<float>(0.9 * sin(angle))};
  }
  for (int it = 0; it < iters; ++it) {
    Cx upd[kOrder];
#pragma unroll
    for (int k = 0; k < kOrder; ++k) {
      Cx p = {c[0], 0.0f};
#pragma unroll
      for (int i = 1; i <= kOrder; ++i) {
        p = cmul(p, z[k]);
        p.re += c[i];
      }
      Cx d = {(z[k].re - z[0].re) + (k == 0 ? 1.0f : 0.0f),
              z[k].im - z[0].im};
#pragma unroll
      for (int j = 1; j < kOrder; ++j) {
        d = cmul(d, Cx{(z[k].re - z[j].re) + (k == j ? 1.0f : 0.0f),
                       z[k].im - z[j].im});
      }
      if (hypotf(d.re, d.im) < 1e-20f) d = {1e-20f, 0.0f};
      upd[k] = cdiv(p, d);
    }
#pragma unroll
    for (int k = 0; k < kOrder; ++k) {
      z[k].re -= upd[k].re;
      z[k].im -= upd[k].im;
    }
  }
#pragma unroll
  for (int k = 0; k < kOrder; ++k) {
    float* out = roots + (static_cast<size_t>(row) * kOrder + k) * 2;
    out[0] = z[k].re;
    out[1] = z[k].im;
  }
}

}  // namespace

extern "C" int goofer_lpc_roots(const float* coeffs, float* roots, int rows,
                                int order, int iters, void* stream) {
  if (rows == 0) return 0;
  if (order != kOrder || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + kThreads - 1) / kThreads;
  lpc_roots_thread_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      coeffs, roots, rows, iters);
  return static_cast<int>(cudaGetLastError());
}
