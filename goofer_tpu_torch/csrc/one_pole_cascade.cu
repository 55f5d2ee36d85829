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
// Design: one row runs on one thread-block cluster of kCluster CTAs, and
// every stage stays on chip.  The cluster walks the row in tiles of
// kTile samples; CTA r of the cluster takes the tile's r-th segment of
// kSeg samples and thread t of the CTA the contiguous run of kRun
// samples at t * kRun.  Per tile:
//   1. x and alpha come in once, coalesced through shared memory (padded
//      one word in 32 so that the per-thread reads are free of bank
//      conflicts), into kRun registers each per thread;
//   2. each stage is one scan of affine maps y_end = a * y_in + b over
//      the cluster: each thread runs its samples from y = 0 (giving b) and
//      multiplies its slopes (a); warp shuffles scan the lanes, warp 0
//      scans the 32 warp totals from shared memory, and the kCluster CTA
//      totals are exchanged through distributed shared memory
//      (map_shared_rank) behind one cluster barrier; the tile's carry,
//      the stage's last output of the previous tile, enters at rank 0;
//   3. each thread then re-runs its samples from its carry-in, in the
//      reference loop's expression order, over its registers in place;
//   4. after the last stage the tile's output is written once, coalesced
//      through shared memory.  No stage goes back to device memory.
// The maps compose in the linear domain: products of a in (0, 1)
// underflow harmlessly to 0, so no block bound like the TPU form's is
// needed.
//
// The HP boundary value: a run's first sample needs the stage input one
// sample earlier, which is the previous stage's output at lo - 1.  That
// is exactly this thread's carry-in of the previous stage, so it needs no
// exchange of its own: stage 0 reads x[lo - 1] while loading, stage s > 0
// takes the carry-in of stage s - 1, and the row's first sample takes its
// own input (x[-1] := x[0]).  The per-stage tile carries hold the last
// outputs, which are the next tile's carry-ins and HP boundary values.
//
// What bounds it on the card: the bytes are (1 + 1) x 4 x B x n for x and
// out plus 4 x n for a shared alpha, or 3 x 4 x B x n for per-row alpha,
// 0.14 us at B = 1, n = 40000 and 3.35 TB/s; the arithmetic (3 flops per
// sample and stage) is smaller still.  In practice the floor is latency:
// per tile and stage one dependent pass of kRun samples twice, two CTA
// barriers and one cluster barrier, so the time grows with order x tiles
// and hardly with B until the clusters fill the card.  Measured by
// chip_smoke.py on an H100 80GB HBM3 (700 W), device time per launch:
// 0.027 ms at B = 1, n = 40000, order 12 (bound 0.14 us), 0.0073 ms at
// order 1, 0.100 ms at n = 262144, order 12 (four tiles).  B rows are B
// clusters; kCluster = 8 is the portable cluster size (16 would need the
// non-portable attribute and leaves fewer clusters resident).  kRun = 8
// keeps a 40k-50k sample note (the main path's 24696-48510) in one tile.
// IEEE float32 throughout, no fast-math flags (nvcc's default FMA
// contraction stays on, as in PyTorch's own CUDA kernels).
//
// C interface for ctypes: goofer_one_pole_cascade launches on the given
// stream, does not synchronise, and returns the launch's CUDA error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // CTAs per row
constexpr int kThreads = 1024;               // threads per CTA
constexpr int kRun = 8;                      // samples per thread
constexpr int kWarps = kThreads / 32;        // 32: one warp scans them
constexpr int kSeg = kThreads * kRun;        // samples per CTA and tile
constexpr int kTile = kCluster * kSeg;       // samples per tile
constexpr int kMaxOrder = 12;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarps == 32, "warp 0 scans one warp total per lane");

// shared-memory index of segment sample i: one pad word per 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// inclusive scan of maps (a, b) over the first `width` lanes; combining
// an earlier map (a0, b0) with a later one (a1, b1) gives
// (a1 a0, a1 b0 + b1)
__device__ __forceinline__ void scan_maps(float& a, float& b, int lane,
                                          int width) {
  for (int off = 1; off < width; off <<= 1) {
    const float a_up = __shfl_up_sync(kFull, a, off);
    const float b_up = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      b = a * b_up + b;
      a = a * a_up;
    }
  }
}

template <bool kHighpass>
__global__ void __launch_bounds__(kThreads, 1)
one_pole_cascade_kernel(const float* __restrict__ x,
                        const float* __restrict__ alpha_base,
                        long long alpha_stride, float* __restrict__ out,
                        int n, int order) {
  __shared__ float s_stage[kSeg + kSeg / 32];  // tile segment in and out
  __shared__ float s_wa[kWarps];               // warp totals, then the
  __shared__ float s_wb[kWarps];               // exclusive warp prefixes
  __shared__ float2 s_cta[2];   // this CTA's map, by step parity (DSMEM)
  __shared__ float s_yin;       // y before this CTA's segment, this stage
  __shared__ float s_carry[kMaxOrder];  // y before this tile, per stage

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x / kCluster;
  const float* x_row = x + row * n;
  const float* alpha = alpha_base + row * alpha_stride;
  float* out_row = out + row * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < kMaxOrder) s_carry[tid] = 0.0f;  // y[-1] = 0
  int step = 0;  // cluster barriers so far, for the s_cta parity

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int seg0 = t0 + rank * kSeg;
    const int lo = seg0 + tid * kRun;
    const int cnt = max(0, min(kRun, n - lo));
    float v[kRun];
    float al[kRun];

    // 1. x and alpha into registers, coalesced through shared memory
    for (int i = tid; i < kSeg; i += kThreads) {
      const int g = seg0 + i;
      s_stage[pad(i)] = g < n ? x_row[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = s_stage[pad(tid * kRun + k)];
    // stage 0's HP boundary value x[lo - 1], x[-1] := x[0]
    float xp = 0.0f;
    if (cnt > 0) {
      xp = lo == 0 ? v[0]
                   : (tid > 0 ? s_stage[pad(tid * kRun - 1)] : x_row[lo - 1]);
    }
    __syncthreads();
    for (int i = tid; i < kSeg; i += kThreads) {
      const int g = seg0 + i;
      s_stage[pad(i)] = g < n ? alpha[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRun; ++k) al[k] = s_stage[pad(tid * kRun + k)];

    for (int s = 0; s < order; ++s, ++step) {
      // 2. this run's map y_end = a * y_in + b
      float y = 0.0f;
      float a = 1.0f;
      float xq = xp;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (k < cnt) {
          if (kHighpass) {
            y = al[k] * (y + v[k] - xq);
            xq = v[k];
            a *= al[k];
          } else {
            y = y + al[k] * (v[k] - y);
            a *= 1.0f - al[k];
          }
        }
      }
      float b = y;
      scan_maps(a, b, lane, 32);
      if (lane == 31) {
        s_wa[warp] = a;
        s_wb[warp] = b;
      }
      // this lane's exclusive prefix within its warp
      float a_ex = __shfl_up_sync(kFull, a, 1);
      float b_ex = __shfl_up_sync(kFull, b, 1);
      if (lane == 0) {
        a_ex = 1.0f;
        b_ex = 0.0f;
      }
      __syncthreads();
      if (warp == 0) {
        float wa = s_wa[lane];
        float wb = s_wb[lane];
        scan_maps(wa, wb, lane, kWarps);
        const float wa_ex = __shfl_up_sync(kFull, wa, 1);
        const float wb_ex = __shfl_up_sync(kFull, wb, 1);
        s_wa[lane] = lane == 0 ? 1.0f : wa_ex;
        s_wb[lane] = lane == 0 ? 0.0f : wb_ex;
        if (lane == kWarps - 1) s_cta[step & 1] = make_float2(wa, wb);
      }
      cluster.sync();
      if (warp == 0) {
        // every CTA's map, scanned over the cluster's ranks
        float ca = 1.0f;
        float cb = 0.0f;
        if (lane < kCluster) {
          const float2 m = *cluster.map_shared_rank(&s_cta[step & 1], lane);
          ca = m.x;
          cb = m.y;
        }
        scan_maps(ca, cb, lane, kCluster);
        const int prev = rank > 0 ? rank - 1 : 0;
        const float ea = __shfl_sync(kFull, ca, prev);
        const float eb = __shfl_sync(kFull, cb, prev);
        const float ta = __shfl_sync(kFull, ca, kCluster - 1);
        const float tb = __shfl_sync(kFull, cb, kCluster - 1);
        if (lane == 0) {
          const float carry = s_carry[s];
          s_yin = rank == 0 ? carry : ea * carry + eb;
          s_carry[s] = ta * carry + tb;
        }
      }
      __syncthreads();

      // 3. re-run from the carry-in y[lo - 1], in place
      const float y_in = a_ex * (s_wa[warp] * s_yin + s_wb[warp]) + b_ex;
      y = y_in;
      xq = xp;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (k < cnt) {
          if (kHighpass) {
            const float xi = v[k];
            y = al[k] * (y + xi - xq);
            xq = xi;
          } else {
            y = y + al[k] * (v[k] - y);
          }
          v[k] = y;
        }
      }
      // the next stage's HP boundary value: this stage's output at lo - 1
      xp = lo == 0 ? v[0] : y_in;
    }

    // 4. the tile's output, coalesced through shared memory
#pragma unroll
    for (int k = 0; k < kRun; ++k) s_stage[pad(tid * kRun + k)] = v[k];
    __syncthreads();
    for (int i = tid; i < kSeg; i += kThreads) {
      const int g = seg0 + i;
      if (g < n) out_row[g] = s_stage[pad(i)];
    }
    __syncthreads();
  }
  // no CTA leaves while another may still read its s_cta
  cluster.sync();
}

template <bool kHighpass>
cudaError_t launch(const float* x, const float* alpha, long long alpha_stride,
                   float* out, int batch, int n, int order,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, one_pole_cascade_kernel<kHighpass>, x,
                            alpha, alpha_stride, out, n, order);
}

}  // namespace

extern "C" int goofer_one_pole_cascade(const float* x, const float* alpha,
                                       long long alpha_stride, float* out,
                                       int batch, int n, int order,
                                       int highpass, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (order < 1 || order > kMaxOrder || batch > (1 << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      highpass ? launch<true>(x, alpha, alpha_stride, out, batch, n, order, s)
               : launch<false>(x, alpha, alpha_stride, out, batch, n, order,
                               s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
