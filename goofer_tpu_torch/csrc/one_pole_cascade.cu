// Time-varying one-pole LP/HP cascade for Hopper (sm_90a).
//
// Replaces goofer_tpu/ops/scan_iir.py:dynamic_one_pole_cascade, whose
// stages run first_order_recurrence_pos (a non-Pallas JAX TPU workaround:
// log-domain cumsums over 32-sample blocks so that exp stays inside
// float32, plus a rolled lax.scan over the block carries).  One launch
// runs the whole cascade; each stage is
//
//   LP: y[i] = y[i-1] + alpha[i] * (x[i] - y[i-1])
//   HP: y[i] = alpha[i] * (y[i-1] + x[i] - x[i-1]),   x[-1] := x[0]
//
// with y[-1] = 0, and reads the previous stage's output (the reference
// loop, SillySampler.py:118-174).
//
// Design: one CTA per row; thread t owns the contiguous chunk
// [t*chunk, (t+1)*chunk).  A stage is the affine recurrence
// y[i] = a[i] y[i-1] + b[i], so per stage:
//   1. each thread runs its chunk from y = 0 (giving the chunk map's
//      offset B) and multiplies its a[i] (the map's slope A);
//   2. the CTA runs an exclusive scan of the maps (A, B): warp shuffles,
//      then one warp over the 32 warp totals in shared memory;
//   3. each thread re-runs its chunk from its carry-in, in the reference
//      loop's expression order, and writes the stage output.
// Stages ping-pong between ``out`` and ``scratch`` so the last one lands
// in ``out``; __syncthreads() separates them.  The maps compose in the
// linear domain: products of a in (0, 1) underflow harmlessly to 0, so
// no block bound like the TPU form's is needed.
//
// What bounds it on the card: the serial dependency inside a chunk
// (2 * order passes of ~n/1024 dependent FMAs per thread) and the CTA
// barriers, not bytes: a 40k-sample row is 160 KB and stays in L2 between
// passes.  B is 1 or 2 on the note path, so one CTA per row leaves most
// SMs idle; spreading a row over a thread-block cluster is later work.
// IEEE float32 throughout, no fast-math flags (nvcc's default FMA
// contraction stays on, as in PyTorch's own CUDA kernels).
//
// C interface for ctypes: goofer_one_pole_cascade launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// One stage over this thread's chunk [lo, hi), from carry-in y.  With
// ``store`` false it only returns the chunk's final y (step 1, y = 0);
// with ``store`` true it writes dst (step 3).
template <bool kHighpass, bool kStore>
__device__ __forceinline__ float run_chunk(const float* __restrict__ src,
                                           const float* __restrict__ alpha,
                                           float* __restrict__ dst, int lo,
                                           int hi, float y, float* slope) {
  float a_prod = 1.0f;
  if (kHighpass) {
    float x_prev = src[lo > 0 ? lo - 1 : 0];
    for (int i = lo; i < hi; ++i) {
      const float xi = src[i];
      const float al = alpha[i];
      y = al * (y + xi - x_prev);
      x_prev = xi;
      if (kStore) dst[i] = y; else a_prod *= al;
    }
  } else {
    for (int i = lo; i < hi; ++i) {
      const float al = alpha[i];
      y = y + al * (src[i] - y);
      if (kStore) dst[i] = y; else a_prod *= 1.0f - al;
    }
  }
  if (!kStore) *slope = a_prod;
  return y;
}

template <bool kHighpass>
__global__ void __launch_bounds__(kThreads)
one_pole_cascade_kernel(const float* __restrict__ x,
                        const float* __restrict__ alpha_base,
                        long long alpha_stride, float* out, float* scratch,
                        int n, int order) {
  __shared__ float s_a[kWarps];
  __shared__ float s_b[kWarps];
  const size_t row = blockIdx.x;
  const float* alpha = alpha_base + row * alpha_stride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * chunk);
  const int hi = min(n, lo + chunk);
  float* out_row = out + row * n;
  float* scr_row = scratch != nullptr ? scratch + row * n : nullptr;

  const float* src = x + row * n;
  // the last stage writes out; the one before it scratch, and so on
  float* dst = (order % 2 == 1) ? out_row : scr_row;
  for (int stage = 0; stage < order; ++stage) {
    // 1. this chunk's map y_end = A * y_in + B
    float a;
    float b = run_chunk<kHighpass, false>(src, alpha, nullptr, lo, hi, 0.0f,
                                          &a);

    // 2. exclusive scan of the maps over the CTA; combining an earlier
    //    map (a0, b0) with a later one (a1, b1) gives (a1 a0, a1 b0 + b1)
    for (int off = 1; off < 32; off <<= 1) {
      const float a_up = __shfl_up_sync(kFull, a, off);
      const float b_up = __shfl_up_sync(kFull, b, off);
      if (lane >= off) {
        b = a * b_up + b;
        a = a * a_up;
      }
    }
    if (lane == 31) {
      s_a[warp] = a;
      s_b[warp] = b;
    }
    // within-warp exclusive prefix of this thread
    float a_ex = __shfl_up_sync(kFull, a, 1);
    float b_ex = __shfl_up_sync(kFull, b, 1);
    if (lane == 0) {
      a_ex = 1.0f;
      b_ex = 0.0f;
    }
    __syncthreads();
    if (warp == 0) {
      float wa = s_a[lane];
      float wb = s_b[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const float a_up = __shfl_up_sync(kFull, wa, off);
        const float b_up = __shfl_up_sync(kFull, wb, off);
        if (lane >= off) {
          wb = wa * b_up + wb;
          wa = wa * a_up;
        }
      }
      // exclusive over warps: warp w reads the total of warps < w
      const float wb_ex = __shfl_up_sync(kFull, wb, 1);
      s_b[lane] = lane == 0 ? 0.0f : wb_ex;
    }
    __syncthreads();
    // y[-1] = 0, so the carry-in is the offset of the exclusive prefix
    const float carry = a_ex * s_b[warp] + b_ex;

    // 3. the stage output from the carry-in
    run_chunk<kHighpass, true>(src, alpha, dst, lo, hi, carry, nullptr);
    // dst complete before the next stage reads it, and s_b free again
    __syncthreads();
    src = dst;
    dst = (dst == out_row) ? scr_row : out_row;
  }
}

}  // namespace

extern "C" int goofer_one_pole_cascade(const float* x, const float* alpha,
                                       long long alpha_stride, float* out,
                                       float* scratch, int batch, int n,
                                       int order, int highpass,
                                       void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (order < 1 || (order > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (highpass) {
    one_pole_cascade_kernel<true><<<batch, kThreads, 0, s>>>(
        x, alpha, alpha_stride, out, scratch, n, order);
  } else {
    one_pole_cascade_kernel<false><<<batch, kThreads, 0, s>>>(
        x, alpha, alpha_stride, out, scratch, n, order);
  }
  return static_cast<int>(cudaGetLastError());
}
