// LF glottal pulse accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel goofer_tpu/ops/pallas/pulse_kernel.py
// (_pulse_block_kernel under pulse_accumulate_pallas), which evaluates
// 8x512-sample output tiles against per-block slabs of onset rows held
// in SMEM.  This kernel computes the same sum without the TPU tiling:
//
//   out[b, i] = sum_{k < K, 0 <= j < M} lf((i - pos[j]) / T0[j], T[j]) / norm[j]
//               over j = row[b, i] - k with 0 <= i - pos[j] < T0[j]
//
// where row[b, i] is the compact-table row of the latest pulse onset at or
// before sample i (built in PyTorch, goofer_tpu_torch/ops/pulse.py), and
// the four (B, M) tables hold each onset's position, period in samples,
// period in seconds and closed-form grid peak.
//
// Design: one thread per output sample, looping over its K most recent
// onset rows.  What bounds it on the card is transcendental throughput,
// not bytes: every live (sample, row) pair costs one sinf (rise) or one
// expf plus one cosf (decay) in full precision, while the tables are a
// few KB per note that neighbouring threads read at the same or adjacent
// rows, so they are served from L1.  The branch per pair evaluates only
// the LF segment the sample lies in.  Math is IEEE float32 with no fast-
// math flags, in the operation order of the plain PyTorch version.
//
// C interface for ctypes: goofer_pulse_accumulate launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

struct LfParams {
  float ra;        // open-phase end, fraction of the period
  float uc;        // return-phase end: Ra + Rk (1 - Ra)
  float two_ra;    // 2 Ra
  float uc_m_ra;   // uc - Ra
  float neg_rg;    // -Rg
  int guard;       // 1: period-scaled epsilon guards of the Numba kernel
};

__device__ __forceinline__ float lf_pulse_value(float u, float T,
                                                const LfParams& p) {
  const float kPi = 3.14159265358979323846f;
  if (u < p.ra) {
    const float arg = p.guard ? kPi * u * T / (p.two_ra * T + 1e-12f)
                              : kPi * u / p.two_ra;
    const float s = sinf(arg);
    return s * s;
  }
  if (u < p.uc) {
    const float tau = p.guard ? (u - p.ra) * T / (p.uc_m_ra * T + 1e-12f)
                              : (u - p.ra) / p.uc_m_ra;
    return expf(p.neg_rg * tau) * cosf(kPi * tau / 2.0f);
  }
  return 0.0f;
}

__global__ void pulse_accumulate_kernel(
    const int* __restrict__ row, const float* __restrict__ pos_tab,
    const float* __restrict__ t0_tab, const float* __restrict__ t_tab,
    const float* __restrict__ norm_tab, float* __restrict__ out, int n,
    int m, int max_overlap, LfParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t b = blockIdx.y;
  const int r = row[b * n + i];
  const float* pos = pos_tab + b * m;
  const float* t0 = t0_tab + b * m;
  const float* ts = t_tab + b * m;
  const float* nrm = norm_tab + b * m;
  const float t = static_cast<float>(i);

  float acc = 0.0f;
  for (int k = 0; k < max_overlap; ++k) {
    const int j = r - k;
    if (j < 0) break;
    if (j >= m) continue;
    const float offs = t - pos[j];
    const float period = t0[j];
    if (offs >= 0.0f && offs < period) {
      // u < 1 follows from offs < period
      acc += lf_pulse_value(offs / period, ts[j], p) / nrm[j];
    }
  }
  out[b * n + i] = acc;
}

}  // namespace

extern "C" int goofer_pulse_accumulate(
    const int* row, const float* pos_tab, const float* t0_tab,
    const float* t_tab, const float* norm_tab, float* out, int batch, int n,
    int m, int max_overlap, double ra, double rg, double rk, int guard,
    void* stream) {
  if (batch == 0 || n == 0) return 0;
  const double uc = ra + rk * (1.0 - ra);
  LfParams p;
  p.ra = static_cast<float>(ra);
  p.uc = static_cast<float>(uc);
  p.two_ra = static_cast<float>(2.0 * ra);
  p.uc_m_ra = static_cast<float>(uc - ra);
  p.neg_rg = static_cast<float>(-rg);
  p.guard = guard;
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, batch);
  pulse_accumulate_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      row, pos_tab, t0_tab, t_tab, norm_tab, out, n, m, max_overlap, p);
  return static_cast<int>(cudaGetLastError());
}
