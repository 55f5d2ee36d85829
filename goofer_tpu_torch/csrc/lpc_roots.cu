// Roots of monic LPC polynomials for Hopper (sm_90a): batched
// Durand-Kerner iteration, every iteration of a row in one launch.
//
// Replaces goofer_tpu/analysis/formants.py:_poly_roots_dk (non-Pallas JAX
// code: a fori_loop of 60 iterations, each a Horner evaluation and an
// (order x order) product of root differences over all frames at once).
// In eager PyTorch that loop is ~18 small launches per iteration.  Here
// row r of coeffs (rows, order + 1), c[0] = 1 leading, gives the `order`
// complex roots of  c[0] z^order + c[1] z^(order-1) + ... + c[order]:
//
//   z_k(0)   = 0.9 exp(i 2 pi (k + 0.25) / order)
//   p        = Horner(c, z_k)                       (complex64)
//   d        = prod_{j != k} (z_k - z_j);  d := 1e-20 where |d| < 1e-20
//   z_k(n+1) = z_k(n) - p / d                       `iters` times
//
// Design: one warp per row, root k on lane k, kWarps rows per CTA.  The
// row's coefficients sit in shared memory; all iterations run in
// registers and the lanes read each other's roots by shuffle.  Nothing
// but the coefficients in and the roots out touches device memory.
//
// What bounds it on the card: operations.  A row costs iters x order x
// (order Horner steps + order - 1 difference products + a division),
// about 8 flops each: ~1e5 flops per row at order 10, 60 iterations,
// against 124 bytes moved.  Only `order` of a warp's 32 lanes work, so the
// kernel cannot come near the float32 peak; three rows per warp would be
// the next step.
//
// Complex products are (ac - bd, ad + bc) and the division is the scaled
// form PyTorch's complex64 uses, so the roots agree with
// analysis/formants.py:poly_roots_dk_plain to rounding (FMA contraction
// differs); both converge to the same roots where they converge at all.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kMaxOrder = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Cx {
  float re, im;
};

__device__ __forceinline__ Cx cmul(Cx a, Cx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// a / b by the ratio of b's smaller part to its larger one
__device__ __forceinline__ Cx cdiv(Cx a, Cx b) {
  const float abs_c = fabsf(b.re);
  const float abs_d = fabsf(b.im);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0f && abs_d == 0.0f) return {a.re / abs_c, a.im / abs_d};
    const float rat = b.im / b.re;
    const float scl = 1.0f / (b.re + b.im * rat);
    return {(a.re + a.im * rat) * scl, (a.im - a.re * rat) * scl};
  }
  const float rat = b.re / b.im;
  const float scl = 1.0f / (b.re * rat + b.im);
  return {(a.re * rat + a.im) * scl, (a.im * rat - a.re) * scl};
}

__global__ void __launch_bounds__(kWarp* kWarps)
lpc_roots_kernel(const float* __restrict__ coeffs, float* __restrict__ roots,
                 int rows, int order, int iters) {
  __shared__ float c_all[kWarps][kMaxOrder + 1];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warps leave; no CTA barrier follows
  float* c = c_all[warp];
  for (int i = lane; i <= order; i += kWarp) {
    c[i] = coeffs[static_cast<size_t>(row) * (order + 1) + i];
  }
  __syncwarp();

  const double angle =
      2.0 * 3.14159265358979323846 * (lane + 0.25) / order;
  Cx z = {0.0f, 0.0f};
  if (lane < order) {
    z.re = static_cast<float>(0.9 * cos(angle));
    z.im = static_cast<float>(0.9 * sin(angle));
  }
  for (int it = 0; it < iters; ++it) {
    Cx p = {c[0], 0.0f};
    for (int i = 1; i <= order; ++i) {
      p = cmul(p, z);
      p.re += c[i];
    }
    Cx d = {1.0f, 0.0f};
    for (int j = 0; j < order; ++j) {
      const Cx zj = {__shfl_sync(kFull, z.re, j), __shfl_sync(kFull, z.im, j)};
      if (j != lane) d = cmul(d, Cx{z.re - zj.re, z.im - zj.im});
    }
    if (hypotf(d.re, d.im) < 1e-20f) d = {1e-20f, 0.0f};
    const Cx upd = cdiv(p, d);
    z.re -= upd.re;
    z.im -= upd.im;
  }
  if (lane < order) {
    float* out = roots + (static_cast<size_t>(row) * order + lane) * 2;
    out[0] = z.re;
    out[1] = z.im;
  }
}

}  // namespace

// coeffs: (rows, order + 1) float32, monic; roots: (rows, order, 2)
// float32 out, (real, imaginary) pairs.
extern "C" int goofer_lpc_roots(const float* coeffs, float* roots, int rows,
                                int order, int iters, void* stream) {
  if (rows == 0) return 0;
  if (order < 1 || order > kMaxOrder || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + kWarps - 1) / kWarps;
  lpc_roots_kernel<<<blocks, kWarp * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(coeffs, roots, rows,
                                                          order, iters);
  return static_cast<int>(cudaGetLastError());
}
