// Reflect-padded Gaussian blur for Hopper (sm_90a): one launch per blur of
// a whole batch, along one axis of a contiguous (outer, n, inner) array.
//
// Replaces goofer_tpu/ops/filters.py:_conv_valid_lastaxis (non-Pallas JAX
// code: a direct depthwise conv up to 33 taps, an FFT convolution above)
// behind gaussian_blur1d, which pads each row with np.pad(mode="reflect")
// and correlates it with symmetric, normalized taps.  The port's plain
// version is a cuDNN conv1d of the reflect-padded rows.
//
//   out[o, i, c] = sum_k taps[k] * x[o, reflect(i + k - radius), c]
//   reflect(j) = j mod 2(n - 1), mirrored past n - 1 (numpy's repeated
//                reflection; 0 when n == 1), radius = (ntaps - 1) / 2
//
// Summation order.  The bits of an output depend on ntaps alone: never on
// outer, on the output's place in a tile, block or grid, or on any tile or
// grid size the launch picks.  So a note keeps its bits whether it is
// rendered alone or in a phrase of any size.
//   - Bin axis (inner > 1): one float32 accumulator per output takes the
//     taps in order, k = 0 .. ntaps - 1, by fmaf.
//   - Sample axis (inner == 1): the taps are cut into `parts` partitions
//     of `part_len` taps (a multiple of kTapChunk), both set by ntaps
//     alone (the wrapper's tap_partition: one partition below 512 taps,
//     so the same in-order fmaf sum; 3529 taps make 13 of 272).  Each partition is an in-order
//     fmaf sum from 0.0f; the partials are then added in partition order,
//     out = ((p0 + p1) + p2) + ...
//
// What bounds it on the card: operations for the long blurs of the note
// render (sigma 441, 3529 taps over 33075-sample rows: 2 x 3529 flops per
// output against 8 bytes), bytes for the short ones along the bins of the
// spectra (5 to 57 taps).
//
// Design, inner == 1 (blur_rows_kernel): one CTA per (row, tile), of
// `parts` x `groups` warps.  Warp w sums partition w % parts for the run
// group w / parts; each lane owns R adjacent outputs (R odd, so the 32
// lanes of a warp, whose windows start R floats apart, read 32 distinct
// banks).  The CTA stages its tile plus the ntaps - 1 halo samples in
// shared memory (the reflect index, in 32-bit arithmetic, only for the
// samples outside the row) and the taps beside them.  A lane keeps a
// window of R + 15 staged samples in registers; per chunk of 16 taps it
// reads 16 new samples and the 16 taps (four broadcast 16-byte loads)
// for 16 R fmaf, then slides the window: at R = 15, 20 shared loads per
// 240 fmaf, so the fmaf pipes and not shared memory set the pace.  The partials leave through
// shared memory: each output adds its partitions in order and is stored
// coalesced.  The wrapper picks R from {15, 7, 3, 1} and `groups` from the
// shape (ops/cuda/blur_kernel.py:rows_geometry), so that a single row of
// 48510 samples still spreads over the card's SMs and a row shorter than a
// tile gets a smaller one; none of it enters an output's sum.
//
// Design, inner > 1 (blur_cols_kernel, the bin axis of (B, bins, frames)
// and of a complex spectrum viewed as (B, bins, 2 frames) floats): one
// thread per (slab, run of R outputs along the bins, column), the columns
// fastest, so a warp's load of one bin reads adjacent floats.  The thread
// loads its window of R + ntaps - 1 bins of its column into registers,
// computing each bin's reflect index once, and slides the R outputs over
// it: each input is read from device memory about once (the windows of
// neighbouring runs overlap by ntaps - 1 bins, which the L2 serves).  R
// is 32 up to 17 taps, 16 above, and 4 where those would leave the card
// short of threads (the heavy note's B = 1 spectra) or where fewer than
// 32 columns would stride a warp's loads over 32 runs (a complex STFT
// spectrum, stored as (T, bins, 2) floats: its two columns are the real
// and imaginary parts).  The tap count is a template parameter for every
// odd count 3 .. 57 (the paths' 5, 15 and 17, and env_shape's blurs up to
// 57), so the window is registers and the loops unroll; any other count
// runs the generic instantiation (NT = 0) of the same kernel, which
// slides a window of 2R - 1 registers over chunks of R taps.
//
// Tensor cores are not used.  The blur must match its plain version to
// 1e-5 x max|x|; TF32 keeps about three digits, and a three-way TF32
// split of the Toeplitz product (hi*hi + hi*lo + lo*hi) costs twice the
// flops at three products each, no faster than the float32 cores.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRowThreads = 512;
// taps per chunk of the rows kernel; a partition starts at a multiple
constexpr int kTapChunk = 16;
constexpr int kColThreads = 128;
constexpr int kColRunShort = 32;   // runs along the bins for <= 17 taps
constexpr int kColRun = 16;        // and for more
constexpr int kColRunSmall = 4;    // for a grid too small to fill the card
constexpr int kColShortTaps = 17;
constexpr int kColUnrolledTaps = 57;
constexpr int kMaxTaps = 16385;
constexpr int kDefaultShared = 48 * 1024;

// numpy's repeated reflection of j into [0, n); n <= 2^30
__device__ __forceinline__ int reflect(int j, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = j % period;
  if (m < 0) m += period;
  return m >= n ? period - m : m;
}

__device__ __forceinline__ int clamp_reflect(int j, int n) {
  return (j < 0 || j >= n) ? reflect(j, n) : j;
}

template <int R>
__global__ void __launch_bounds__(kMaxRowThreads)
blur_rows_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int n, int ntaps, int parts,
                 int part_len, int tiles) {
  extern __shared__ float smem[];
  const int groups = blockDim.x / kWarp / parts;
  const int tile = kWarp * R * groups;
  const int span = tile + ntaps - 1;
  float* w = smem;
  float* s = smem + ntaps;
  const long long row = blockIdx.x / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * tile;
  const int radius = (ntaps - 1) / 2;
  const float* xr = x + row * n;

  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) w[k] = taps[k];
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    s[j] = xr[clamp_reflect(t0 - radius + j, n)];
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int p = warp % parts;
  const int base = (warp / parts * kWarp + lane) * R;
  const int k0 = p * part_len;
  const int k1 = min(ntaps, k0 + part_len);
  const int whole = k0 + (k1 - k0) / kTapChunk * kTapChunk;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  // xs[j] = s[base + kb + j]: the window slides kTapChunk samples a chunk
  float xs[R + kTapChunk - 1];
#pragma unroll
  for (int j = 0; j < R - 1; ++j) xs[j] = s[base + k0 + j];
  for (int kb = k0; kb < whole; kb += kTapChunk) {
#pragma unroll
    for (int j = 0; j < kTapChunk; ++j) {
      xs[R - 1 + j] = s[base + kb + R - 1 + j];
    }
    float wc[kTapChunk];
#pragma unroll
    for (int v = 0; v < kTapChunk / 4; ++v) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + kb + 4 * v);
      wc[4 * v] = w4.x;
      wc[4 * v + 1] = w4.y;
      wc[4 * v + 2] = w4.z;
      wc[4 * v + 3] = w4.w;
    }
#pragma unroll
    for (int q = 0; q < kTapChunk; ++q) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = fmaf(wc[q], xs[i + q], acc[i]);
    }
#pragma unroll
    for (int j = 0; j < R - 1; ++j) xs[j] = xs[j + kTapChunk];
  }
  for (int k = whole; k < k1; ++k) {
    const float wk = w[k];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = fmaf(wk, s[base + k + i], acc[i]);
  }

  // the partials, partition by partition, over the staged samples
  __syncthreads();
  float* part = s;
#pragma unroll
  for (int i = 0; i < R; ++i) part[p * tile + base + i] = acc[i];
  __syncthreads();
  float* orow = out + row * n;
  for (int j = threadIdx.x; j < tile && t0 + j < n; j += blockDim.x) {
    float v = part[j];
    for (int q = 1; q < parts; ++q) v += part[q * tile + j];
    orow[t0 + j] = v;
  }
}

// NT > 0: NT taps, the window in registers; NT == 0: ntaps taps, chunks
// of R taps over a sliding window of 2R - 1 registers, then the tail.
template <int NT, int R>
__global__ void __launch_bounds__(kColThreads)
blur_cols_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int n, int inner, int ntaps,
                 int runs, long long threads) {
  extern __shared__ float w[];
  for (int k = threadIdx.x; k < ntaps; k += kColThreads) w[k] = taps[k];
  __syncthreads();

  const long long idx =
      static_cast<long long>(blockIdx.x) * kColThreads + threadIdx.x;
  if (idx >= threads) return;
  const int col = static_cast<int>(idx % inner);
  const long long rest = idx / inner;
  const int i0 = static_cast<int>(rest % runs) * R;
  const long long slab = rest / runs;
  const float* xs = x + slab * n * inner + col;
  float* os = out + slab * n * inner + col;
  const int radius = (ntaps - 1) / 2;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;

  if constexpr (NT > 0) {
    float v[R + NT - 1];
#pragma unroll
    for (int m = 0; m < R + NT - 1; ++m) {
      v[m] = __ldg(xs + static_cast<long long>(
                            clamp_reflect(i0 - radius + m, n)) * inner);
    }
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = fmaf(wk, v[i + k], acc[i]);
    }
  } else {
    const int whole = ntaps / R * R;
    for (int kb = 0; kb < whole; kb += R) {
      float v[2 * R - 1];
#pragma unroll
      for (int m = 0; m < 2 * R - 1; ++m) {
        v[m] = __ldg(xs + static_cast<long long>(clamp_reflect(
                              i0 - radius + kb + m, n)) * inner);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float wq = w[kb + q];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = fmaf(wq, v[i + q], acc[i]);
      }
    }
    for (int k = whole; k < ntaps; ++k) {
      const float wk = w[k];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = fmaf(wk, __ldg(xs + static_cast<long long>(clamp_reflect(
                                         i0 - radius + k + i, n)) * inner),
                      acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i0 + i < n) os[static_cast<long long>(i0 + i) * inner] = acc[i];
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultShared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int R>
int launch_rows(const float* x, const float* taps, float* out,
                long long outer, int n, int ntaps, int groups, int parts,
                int part_len, cudaStream_t stream) {
  const int threads = kWarp * groups * parts;
  const int tile = kWarp * R * groups;
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = outer * tiles;
  if (threads > kMaxRowThreads || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int span = tile + ntaps - 1;
  const int staged = span > parts * tile ? span : parts * tile;
  const size_t shared = sizeof(float) * (ntaps + staged);
  const cudaError_t err = allow_shared(blur_rows_kernel<R>, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  blur_rows_kernel<R><<<static_cast<unsigned>(blocks), threads, shared,
                        stream>>>(x, taps, out, n, ntaps, parts, part_len,
                                  static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int R>
int launch_cols(const float* x, const float* taps, float* out,
                long long outer, int n, int inner, int ntaps,
                cudaStream_t stream) {
  const int runs = (n + R - 1) / R;
  const long long threads = outer * runs * inner;
  const long long blocks = (threads + kColThreads - 1) / kColThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float) * ntaps;
  const cudaError_t err = allow_shared(blur_cols_kernel<NT, R>, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  blur_cols_kernel<NT, R><<<static_cast<unsigned>(blocks), kColThreads,
                            shared, stream>>>(x, taps, out, n, inner, ntaps,
                                              runs, threads);
  return static_cast<int>(cudaGetLastError());
}

// run: the tap count's own run (kColRunShort up to kColShortTaps taps,
// else kColRun) or kColRunSmall
template <int NT>
int launch_cols_run(const float* x, const float* taps, float* out,
                    long long outer, int n, int inner, int ntaps, int run,
                    cudaStream_t stream) {
  constexpr int R = (NT > 0 && NT <= kColShortTaps) ? kColRunShort : kColRun;
  if (run == R) {
    return launch_cols<NT, R>(x, taps, out, outer, n, inner, ntaps, stream);
  }
  if (run == kColRunSmall) {
    return launch_cols<NT, kColRunSmall>(x, taps, out, outer, n, inner, ntaps,
                                         stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NT>
int dispatch_cols(const float* x, const float* taps, float* out,
                  long long outer, int n, int inner, int ntaps, int run,
                  cudaStream_t stream) {
  if constexpr (NT > kColUnrolledTaps) {
    return launch_cols_run<0>(x, taps, out, outer, n, inner, ntaps, run,
                              stream);
  } else {
    if (ntaps == NT) {
      return launch_cols_run<NT>(x, taps, out, outer, n, inner, ntaps, run,
                                 stream);
    }
    return dispatch_cols<NT + 2>(x, taps, out, outer, n, inner, ntaps, run,
                                 stream);
  }
}

}  // namespace

// x and out: contiguous float32 (outer, n, inner), n and inner <= 2^30;
// taps: ntaps float32, ntaps odd, 1 .. kMaxTaps.  The caller picks the
// layout.  For inner == 1: `run` outputs per lane (15, 7, 3 or 1),
// `groups` run groups of 32 lanes per CTA, and the tap partition,
// `parts` partitions of `part_len` taps (set by ntaps alone).  For
// inner > 1: `run` outputs per thread, the tap count's own or
// kColRunSmall.  Returns the launch's CUDA error code.
extern "C" int goofer_gaussian_blur(const float* x, const float* taps,
                                    float* out, long long outer, int n,
                                    long long inner, int ntaps, int run,
                                    int groups, int parts, int part_len,
                                    void* stream) {
  if (outer == 0 || n == 0 || inner == 0) return 0;
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0 || n < 1 ||
      n > (1 << 30) || inner > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (inner > 1) {
    return dispatch_cols<3>(x, taps, out, outer, n, static_cast<int>(inner),
                            ntaps, run, s);
  }
  if (groups < 1 || parts < 1 || part_len < 1 || part_len % kTapChunk ||
      static_cast<long long>(parts) * part_len < ntaps ||
      static_cast<long long>(parts - 1) * part_len >= ntaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (run) {
    case 15:
      return launch_rows<15>(x, taps, out, outer, n, ntaps, groups, parts,
                             part_len, s);
    case 7:
      return launch_rows<7>(x, taps, out, outer, n, ntaps, groups, parts,
                            part_len, s);
    case 3:
      return launch_rows<3>(x, taps, out, outer, n, ntaps, groups, parts,
                            part_len, s);
    case 1:
      return launch_rows<1>(x, taps, out, outer, n, ntaps, groups, parts,
                            part_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
