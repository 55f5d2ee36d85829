// Burg LPC recursion for Hopper (sm_90a): all `order` steps of every frame
// in one launch.
//
// Replaces goofer_tpu/analysis/formants.py:_burg_coeffs (non-Pallas JAX
// code: a fori_loop over the order, each step two masked dot products and
// two masked updates over all (frames, wlen) at once).  In eager PyTorch
// every step is ~15 elementwise passes over the whole (rows, wlen) array,
// ~150 launches and ~150 round trips of the frames through device memory.
// Per row of windowed frames x[0 .. wlen), with f = b = x and a = [1, 0, ...]:
//
//   for m = 1 .. order:
//     num = sum_{i >= m} f[i] b[i-1];  den = sum_{i >= m} f[i]^2 + b[i-1]^2
//     k   = -2 num / max(den, 1e-20)
//     f[i], b[i] = f[i] + k b[i-1], b[i-1] + k f[i]        (i >= m)
//     a[i] += k a[m - i]                                   (i = 0 .. m)
//
// Design: one CTA of kThreads per row; f and two copies of b (read the old
// one shifted by a sample, write the new one) stay in shared memory for
// all steps; the two sums are reduced by warp shuffles and one exchange
// through shared memory per step; thread 0 updates the `order + 1`
// coefficients.  A row is read from device memory once and `order + 1`
// floats are written.
//
// What bounds it on the card: bytes, 4 x rows x (wlen + order + 1): 0.03 ms
// for 45 000 rows of 551 samples at 3.35 TB/s.  The arithmetic (about
// 8 x order flops per sample) is a third of that at the float32 peak.
//
// The sums run in another order than torch.sum's, so coefficients agree
// with analysis/formants.py:burg_coeffs_plain to float32 rounding of
// wlen-term dot products, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarpsPerCta = kThreads / kWarp;
constexpr int kMaxOrder = 32;
// dynamic shared memory of a frame; the rest of a CTA's 48 KB holds the
// reduction scratch and the coefficients
constexpr int kMaxSharedBytes = 47 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
burg_lpc_kernel(const float* __restrict__ frames, float* __restrict__ coeffs,
                int wlen, int order) {
  extern __shared__ float smem[];
  __shared__ float part[2][kWarpsPerCta];
  __shared__ float a[kMaxOrder + 1];
  __shared__ float a_old[kMaxOrder + 1];
  __shared__ float k_shared;
  float* f = smem;
  float* b_old = smem + wlen;
  float* b_new = smem + 2 * wlen;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const float* x = frames + static_cast<size_t>(blockIdx.x) * wlen;

  for (int i = tid; i < wlen; i += kThreads) {
    const float v = x[i];
    f[i] = v;
    b_old[i] = v;
  }
  for (int i = tid; i <= order; i += kThreads) a[i] = i == 0 ? 1.0f : 0.0f;
  __syncthreads();

  for (int m = 1; m <= order; ++m) {
    float num = 0.0f, den = 0.0f;
    for (int i = m + tid; i < wlen; i += kThreads) {
      const float fi = f[i];
      const float bi = b_old[i - 1];
      num += fi * bi;
      den += fi * fi + bi * bi;
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      num += __shfl_down_sync(kFull, num, off);
      den += __shfl_down_sync(kFull, den, off);
    }
    if (lane == 0) {
      part[0][warp] = num;
      part[1][warp] = den;
    }
    __syncthreads();
    if (tid == 0) {
      float n_all = 0.0f, d_all = 0.0f;
      for (int w = 0; w < kWarpsPerCta; ++w) {
        n_all += part[0][w];
        d_all += part[1][w];
      }
      const float k = -2.0f * n_all / fmaxf(d_all, 1e-20f);
      k_shared = k;
      for (int i = 0; i <= m; ++i) a_old[i] = a[i];
      for (int i = 0; i <= m; ++i) a[i] = a_old[i] + k * a_old[m - i];
    }
    __syncthreads();
    const float k = k_shared;
    for (int i = m + tid; i < wlen; i += kThreads) {
      const float fi = f[i];
      const float bi = b_old[i - 1];
      f[i] = fi + k * bi;
      b_new[i] = bi + k * fi;
    }
    __syncthreads();
    float* swap = b_old;
    b_old = b_new;
    b_new = swap;
  }
  for (int i = tid; i <= order; i += kThreads) {
    coeffs[static_cast<size_t>(blockIdx.x) * (order + 1) + i] = a[i];
  }
}

}  // namespace

// frames: (rows, wlen) float32, windowed; coeffs: (rows, order + 1)
// float32 out, coeffs[:, 0] = 1.
extern "C" int goofer_burg_lpc(const float* frames, float* coeffs, int rows,
                               int wlen, int order, void* stream) {
  if (rows == 0) return 0;
  const size_t bytes = 3 * static_cast<size_t>(wlen) * sizeof(float);
  if (order < 1 || order > kMaxOrder || wlen < 1 || bytes > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  burg_lpc_kernel<<<rows, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(frames, coeffs, wlen,
                                                         order);
  return static_cast<int>(cudaGetLastError());
}
