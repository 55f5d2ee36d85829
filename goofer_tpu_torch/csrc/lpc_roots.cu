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
//   p        = Horner(c, z_k)                             (complex64)
//   d        = prod_{j = 0 .. order-1} (z_k - z_j + delta_kj)
//   d       := 1e-20 where |d| < 1e-20
//   z_k(n+1) = z_k(n) - p / d                             `iters` times
//
// What bounds it on the card: operations.  A row costs iters x order x
// (order Horner steps + order - 1 difference products + a division),
// about 8 flops each: ~1e5 flops per row at order 10, 60 iterations,
// against 124 bytes moved.  What the work costs in practice is issue
// slots: every product factor needs two shuffles.
//
// Design: a warp holds floor(32 / order) rows, one root per lane: lane
// r * order + k iterates root k of the warp's row r (3 rows at order 10,
// 2 at 11-16, 1 at 17-32), and reads the other roots of ITS row only, by
// shuffles from lanes r * order + j, so nothing of a row (a NaN, the
// 1e-20 guard) reaches its warp-mates and a row's roots do not depend on
// the rows beside it.  kWarps warps share a CTA.  The kernel is compiled
// for each order 1-32, so that the Horner and product loops unroll: the
// coefficients sit in registers (staged through the warp's slice of
// shared memory by one coalesced read), the Horner chain and the
// product's shuffles interleave, and no loop counter is left in the 60
// iterations.  The product is branch-free: the factor j = k is the
// reference's own z_k - z_k + 1 = 1 (multiplying by it is exact), and the
// factors run j = 0 .. order - 1 as in the reference.  Lanes past the
// last whole row, and the rows past `rows` in the last warp, iterate
// harmless copies and store nothing.
//
// Complex products are (ac - bd, ad + bc) and the division is the scaled
// form PyTorch's complex64 uses (without its 0/0 branch, which the guard
// makes unreachable), so the roots agree with
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

// a / b by the ratio of b's smaller part to its larger one, with the two
// cases as selects of operands: (p + q rat) scl and (s + t rat) scl
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

template <int kOrder>
__global__ void __launch_bounds__(kWarp* kWarps)
lpc_roots_kernel(const float* __restrict__ coeffs, float* __restrict__ roots,
                 int rows, int iters) {
  constexpr int kPerWarp = kWarp / kOrder;
  constexpr int kWidth = kOrder + 1;
  __shared__ float c_all[kWarps][kPerWarp * kWidth];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int first = (blockIdx.x * kWarps + warp) * kPerWarp;
  if (first >= rows) return;  // whole warps leave; no CTA barrier follows
  const int warp_rows = min(kPerWarp, rows - first);
  float* c_warp = c_all[warp];
  for (int i = lane; i < warp_rows * kWidth; i += kWarp) {
    c_warp[i] = coeffs[static_cast<size_t>(first) * kWidth + i];
  }
  // lanes past the warp's rows borrow row 0's coefficients
  const int r = lane / kOrder;
  const int k = lane - r * kOrder;
  const bool live = r < warp_rows;
  const int base = r * kOrder;
  __syncwarp();
  float c[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) c[i] = c_warp[(live ? r : 0) * kWidth + i];

  const double angle = 2.0 * 3.14159265358979323846 * (k + 0.25) / kOrder;
  Cx z = {static_cast<float>(0.9 * cos(angle)),
          static_cast<float>(0.9 * sin(angle))};
  for (int it = 0; it < iters; ++it) {
    Cx p = {c[0], 0.0f};
#pragma unroll
    for (int i = 1; i < kWidth; ++i) {
      p = cmul(p, z);
      p.re += c[i];
    }
    const auto factor = [&](int j) -> Cx {
      const float zj_re = __shfl_sync(kFull, z.re, base + j);
      const float zj_im = __shfl_sync(kFull, z.im, base + j);
      return {(z.re - zj_re) + (j == k ? 1.0f : 0.0f), z.im - zj_im};
    };
    Cx d = factor(0);
#pragma unroll
    for (int j = 1; j < kOrder; ++j) d = cmul(d, factor(j));
    // |d| < 1e-20 needs both parts below 1e-20: hypotf only then
    if (fmaxf(fabsf(d.re), fabsf(d.im)) < 1e-20f
        && hypotf(d.re, d.im) < 1e-20f) {
      d = {1e-20f, 0.0f};
    }
    const Cx upd = cdiv(p, d);
    z.re -= upd.re;
    z.im -= upd.im;
  }
  if (live) {
    float* out = roots + (static_cast<size_t>(first) * kOrder + lane) * 2;
    out[0] = z.re;
    out[1] = z.im;
  }
}

// the kernel compiled for `order`
template <int kOrder>
cudaError_t launch(const float* coeffs, float* roots, int rows, int order,
                   int iters, cudaStream_t stream) {
  if constexpr (kOrder > kMaxOrder) {
    return cudaErrorInvalidValue;
  } else {
    if (order != kOrder) {
      return launch<kOrder + 1>(coeffs, roots, rows, order, iters, stream);
    }
    constexpr int kRowsPerCta = kWarps * (kWarp / kOrder);
    const int blocks = (rows + kRowsPerCta - 1) / kRowsPerCta;
    lpc_roots_kernel<kOrder><<<blocks, kWarp * kWarps, 0, stream>>>(
        coeffs, roots, rows, iters);
    return cudaGetLastError();
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
  return static_cast<int>(launch<1>(coeffs, roots, rows, order, iters,
                                    static_cast<cudaStream_t>(stream)));
}
