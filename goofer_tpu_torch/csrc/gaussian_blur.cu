// Reflect-padded Gaussian blur for Hopper (sm_90a): one launch per blur of
// a whole batch, along one axis of a contiguous (outer, n, inner) array.
//
// Replaces goofer_tpu/ops/filters.py:_conv_valid_lastaxis (non-Pallas JAX
// code: a direct depthwise conv up to 33 taps, an FFT convolution above)
// behind gaussian_blur1d, which pads each row with np.pad(mode="reflect")
// and correlates it with symmetric, normalized taps.  The port's plain
// version is a cuDNN conv1d of the reflect-padded rows, and cuDNN picks
// another algorithm, and another summation order, at another batch size:
// a note rendered in a phrase then differs from the same note alone.  Here
// every output is one float32 accumulator that takes its taps in order,
// k = 0 .. ntaps - 1, by fmaf, whatever the batch, the row's place in it
// or the tile: a row's result does not depend on the rows beside it.
//
//   out[o, i, c] = sum_k taps[k] * x[o, reflect(i + k - radius), c]
//   reflect(j) = j mod 2(n - 1), mirrored past n - 1 (numpy's repeated
//                reflection; 0 when n == 1), radius = (ntaps - 1) / 2
//
// What bounds it on the card: operations for the long blurs of the note
// render (sigma 441, 3529 taps over 33075-sample rows: 2 x 3529 flops per
// output against 8 bytes), bytes for the short ones of the spectra.
//
// Design, inner == 1 (blurs along the sample axis): one CTA per (row, tile
// of kTile outputs).  The CTA stages its tile and the halo in shared
// memory, reflect-indexed from device memory, and the taps beside them.
// Each thread owns kRun adjacent outputs: per chunk of kRun taps it reads
// 2 kRun - 1 staged samples and kRun taps (a broadcast) into registers for
// kRun x kRun fmaf.  kRun is odd, so the 32 lanes of a warp, whose windows
// start kRun floats apart, read 32 distinct banks.  The outputs return
// through shared memory and leave in coalesced stores.
//
// Design, inner > 1 (blurs along the bin axis of (B, bins, frames)): one
// thread per (column, run of kColRun outputs), the columns fastest, so a
// warp's reads of one tap are adjacent floats; the taps in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 9;
constexpr int kTile = kThreads * kRun;
constexpr int kColThreads = 128;
constexpr int kColRun = 16;
constexpr int kMaxTaps = 16385;
constexpr int kDefaultShared = 48 * 1024;

__device__ __forceinline__ long long reflect(long long j, long long n) {
  if (n == 1) return 0;
  const long long period = 2 * (n - 1);
  long long m = j % period;
  if (m < 0) m += period;
  return m >= n ? period - m : m;
}

// taps, rounded up to whole chunks of kRun (zeros past ntaps, never read)
__host__ __device__ inline int padded_taps(int ntaps) {
  return (ntaps + kRun - 1) / kRun * kRun;
}

// staged samples of one tile: its outputs' windows and the last chunk's
// overhang
__host__ __device__ inline int staged(int ntaps) {
  return kTile + padded_taps(ntaps) + kRun;
}

__global__ void __launch_bounds__(kThreads)
blur_rows_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int n, int ntaps, int tiles) {
  extern __shared__ float smem[];
  const int wpad = padded_taps(ntaps);
  float* w = smem;
  float* s = smem + wpad;
  const long long row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kTile;
  const int radius = (ntaps - 1) / 2;
  const float* xr = x + row * n;

  for (int k = threadIdx.x; k < wpad; k += kThreads) {
    w[k] = k < ntaps ? taps[k] : 0.0f;
  }
  const int span = staged(ntaps);
  for (int j = threadIdx.x; j < span; j += kThreads) {
    long long src = static_cast<long long>(t0) - radius + j;
    if (src < 0 || src >= n) src = reflect(src, n);
    s[j] = xr[src];
  }
  __syncthreads();

  const int base = threadIdx.x * kRun;
  float acc[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc[i] = 0.0f;
  const int whole = ntaps / kRun * kRun;
  for (int kb = 0; kb < whole; kb += kRun) {
    float xs[2 * kRun - 1];
#pragma unroll
    for (int m = 0; m < 2 * kRun - 1; ++m) xs[m] = s[base + kb + m];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      const float wq = w[kb + q];
#pragma unroll
      for (int i = 0; i < kRun; ++i) acc[i] = fmaf(wq, xs[i + q], acc[i]);
    }
  }
  for (int k = whole; k < ntaps; ++k) {
    const float wk = w[k];
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = fmaf(wk, s[base + k + i], acc[i]);
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRun; ++i) s[base + i] = acc[i];
  __syncthreads();
  float* orow = out + row * n;
  for (int j = threadIdx.x; j < kTile && t0 + j < n; j += kThreads) {
    orow[t0 + j] = s[j];
  }
}

__global__ void __launch_bounds__(kColThreads)
blur_cols_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int n, long long inner, int ntaps,
                 long long blocks_per_slab) {
  extern __shared__ float w[];
  for (int k = threadIdx.x; k < ntaps; k += kColThreads) w[k] = taps[k];
  __syncthreads();

  const long long slab = blockIdx.x / blocks_per_slab;
  const long long idx = (blockIdx.x % blocks_per_slab) * kColThreads +
                        threadIdx.x;
  const long long col = idx % inner;
  const long long i0 = idx / inner * kColRun;
  if (i0 >= n) return;
  const long long i1 = i0 + kColRun < n ? i0 + kColRun : n;
  const float* xs = x + slab * n * inner + col;
  float* os = out + slab * n * inner + col;
  const int radius = (ntaps - 1) / 2;
  for (long long i = i0; i < i1; ++i) {
    float acc = 0.0f;
    for (int k = 0; k < ntaps; ++k) {
      long long src = i + k - radius;
      if (src < 0 || src >= n) src = reflect(src, n);
      acc = fmaf(w[k], xs[src * inner], acc);
    }
    os[i * inner] = acc;
  }
}

}  // namespace

// x and out: contiguous float32 (outer, n, inner); taps: ntaps float32,
// ntaps odd, 3 .. kMaxTaps.  Returns the launch's CUDA error code.
extern "C" int goofer_gaussian_blur(const float* x, const float* taps,
                                    float* out, long long outer, int n,
                                    long long inner, int ntaps,
                                    void* stream) {
  if (outer == 0 || n == 0 || inner == 0) return 0;
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (inner == 1) {
    const long long tiles = (n + kTile - 1) / kTile;
    const long long blocks = outer * tiles;
    if (blocks > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t shared =
        sizeof(float) * (padded_taps(ntaps) + staged(ntaps));
    if (shared > kDefaultShared) {
      const cudaError_t err = cudaFuncSetAttribute(
          blur_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    blur_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, shared, s>>>(
        x, taps, out, n, ntaps, static_cast<int>(tiles));
    return static_cast<int>(cudaGetLastError());
  }
  const long long runs = (n + kColRun - 1) / kColRun;
  const long long per_slab = (runs * inner + kColThreads - 1) / kColThreads;
  const long long blocks = outer * per_slab;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float) * ntaps;
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blur_cols_kernel<<<static_cast<unsigned>(blocks), kColThreads, shared, s>>>(
      x, taps, out, n, inner, ntaps, per_slab);
  return static_cast<int>(cudaGetLastError());
}
