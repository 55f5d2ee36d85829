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
// What bounds it on the card: operations, about 10 flops per live sample
// and step (0.005 ms for 6090 frames of 551 samples at order 10 at the
// float32 peak; the frames' bytes take 0.004 ms).
//
// Design: one warp per frame, kWarps frames per CTA, and no CTA barrier.
// Lane l holds a contiguous stretch of `len` samples of f and b, the frame
// right-aligned in the warp's 32 x len positions (positions before sample
// 0 are zeros that no sum reads, and no position lies past the end).  A
// step is one shuffle (b[i - 1] at the stretch's first sample, from the
// lane below), the two sums over the lane's live samples, a butterfly of
// __shfl_xor_sync that leaves the same k in every lane, and the update in
// place with the old b carried in a register.  Samples below m are
// updated too, since no later step reads them.  Lane i holds a[i] and
// takes a[m - i] by one shuffle; a[32] at order 32 is the last k.
// Stretches of up to kMaxRegStretch samples (wlen <= 1152, every
// production analysis rate) stay in registers for all steps, the kernel
// instantiated per even stretch length; longer frames, up to kMaxWlen,
// keep their stretches in the warp's own slice of shared memory, with as
// many warps per CTA as fit in 48 KB.  Either way a frame is read
// coalesced into a warp-private staging buffer (a padded pitch per lane
// keeps the stretch reads free of bank conflicts) and `order + 1`
// coefficients are written.
//
// The sums run in another order than torch.sum's, so coefficients agree
// with analysis/formants.py:burg_coeffs_plain to float32 rounding of
// wlen-term dot products, not bit for bit.  A frame's coefficients do not
// depend on the frames beside it.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kMaxOrder = 32;
constexpr int kMaxRegStretch = 36;
constexpr int kMaxWlen = 4010;
constexpr int kSharedBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// A lane's stretch of the forward and backward errors: in registers for a
// compile-time length S ...
template <int S>
struct Errors {
  float f[S], b[S];
  __device__ __forceinline__ void load(float* staged, int, int) {
#pragma unroll
    for (int s = 0; s < S; ++s) f[s] = b[s] = staged[s];
  }
  __device__ __forceinline__ float& fw(int s) { return f[s]; }
  __device__ __forceinline__ float& bw(int s) { return b[s]; }
};

// ... or, for S = 0, in the warp's slice of shared memory: f where it was
// staged, b one slice further on
template <>
struct Errors<0> {
  float* f;
  float* b;
  __device__ __forceinline__ void load(float* staged, int len, int span) {
    f = staged;
    b = staged + span;
    for (int s = 0; s < len; ++s) b[s] = f[s];
  }
  __device__ __forceinline__ float& fw(int s) { return f[s]; }
  __device__ __forceinline__ float& bw(int s) { return b[s]; }
};

template <int S>
__global__ void __launch_bounds__(kWarp* kWarps)
burg_lpc_kernel(const float* __restrict__ frames, float* __restrict__ coeffs,
                int rows, int wlen, int order, int stretch, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * warps + warp;
  if (row >= rows) return;  // whole warps leave; no CTA barrier follows
  const int len = S > 0 ? S : stretch;
  const int pitch = len | 1;
  const int span = kWarp * pitch;
  float* stage = smem + warp * (S > 0 ? 1 : 2) * span;
  const int pad = kWarp * len - wlen;
  const float* x = frames + static_cast<size_t>(row) * wlen;
#pragma unroll
  for (int p = lane; p < kWarp * len; p += kWarp) {
    const int i = p - pad;
    stage[(p / len) * pitch + p % len] = i >= 0 ? x[i] : 0.0f;
  }
  __syncwarp();
  Errors<S> e;
  e.load(stage + lane * pitch, len, span);
  const int first = lane * len - pad;  // the sample at the stretch's s = 0

  float a = lane == 0 ? 1.0f : 0.0f;
  float k = 0.0f;
  for (int m = 1; m <= order; ++m) {
    // lane 0's is never live: its first sample is sample 0 or padding
    const float b_in = __shfl_up_sync(kFull, e.bw(len - 1), 1);
    const int lo = m - first;  // s >= lo: the samples i >= m
    float num = 0.0f, den = 0.0f, prev = b_in;
#pragma unroll
    for (int s = 0; s < len; ++s) {
      const float fs = e.fw(s);
      const float bp = prev;
      prev = e.bw(s);
      if (s >= lo) {
        num = fmaf(fs, bp, num);
        den = fmaf(fs, fs, fmaf(bp, bp, den));
      }
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      num += __shfl_xor_sync(kFull, num, off);
      den += __shfl_xor_sync(kFull, den, off);
    }
    k = -2.0f * num / fmaxf(den, 1e-20f);
    prev = b_in;
#pragma unroll
    for (int s = 0; s < len; ++s) {
      const float fs = e.fw(s);
      const float bp = prev;
      prev = e.bw(s);
      e.fw(s) = fmaf(k, bp, fs);
      e.bw(s) = fmaf(k, fs, bp);
    }
    // a[i] += k a[m - i] for i <= m; a[m - i] = a[32] = 0 at i = 0, m = 32
    const int src = m - lane;
    const float partner = __shfl_sync(kFull, a, src & (kWarp - 1));
    if (src >= 0 && src < kWarp) a = fmaf(k, partner, a);
  }
  float* out = coeffs + static_cast<size_t>(row) * (order + 1);
  if (lane <= order) out[lane] = a;
  if (order == kWarp && lane == 0) out[kWarp] = k;
}

template <int S>
cudaError_t launch(const float* frames, float* coeffs, int rows, int wlen,
                   int order, int stretch, int warps, cudaStream_t stream) {
  const int pitch = (S > 0 ? S : stretch) | 1;
  const size_t bytes = static_cast<size_t>(warps) * (S > 0 ? 1 : 2) * kWarp
                       * pitch * sizeof(float);
  const int blocks = (rows + warps - 1) / warps;
  burg_lpc_kernel<S><<<blocks, kWarp * warps, bytes, stream>>>(
      frames, coeffs, rows, wlen, order, stretch, warps);
  return cudaGetLastError();
}

// the register kernel of the shortest even stretch that holds `stretch`
template <int S>
cudaError_t launch_registers(const float* frames, float* coeffs, int rows,
                             int wlen, int order, int stretch,
                             cudaStream_t stream) {
  if constexpr (S > kMaxRegStretch) {
    return cudaErrorInvalidValue;
  } else {
    if (stretch <= S) {
      return launch<S>(frames, coeffs, rows, wlen, order, S, kWarps, stream);
    }
    return launch_registers<S + 2>(frames, coeffs, rows, wlen, order,
                                   stretch, stream);
  }
}

}  // namespace

// frames: (rows, wlen) float32, windowed; coeffs: (rows, order + 1)
// float32 out, coeffs[:, 0] = 1.
extern "C" int goofer_burg_lpc(const float* frames, float* coeffs, int rows,
                               int wlen, int order, void* stream) {
  if (rows == 0) return 0;
  if (order < 1 || order > kMaxOrder || wlen < 1 || wlen > kMaxWlen) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int stretch = (wlen + kWarp - 1) / kWarp;
  if (stretch <= kMaxRegStretch) {
    return static_cast<int>(launch_registers<2>(frames, coeffs, rows, wlen,
                                                order, stretch, s));
  }
  const int fit = kSharedBytes / (2 * kWarp * (stretch | 1) *
                                  static_cast<int>(sizeof(float)));
  const int warps = fit < kWarps ? fit : kWarps;
  return static_cast<int>(launch<0>(frames, coeffs, rows, wlen, order,
                                    stretch, warps, s));
}
