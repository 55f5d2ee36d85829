// LF glottal pulse pass for Hopper (sm_90a): f0 in, pulse train out.
//
// Replaces the Pallas TPU kernel goofer_tpu/ops/pallas/pulse_kernel.py
// (_pulse_block_kernel under pulse_accumulate_pallas) together with the
// table build that feeds it in goofer_tpu/ops/pulse.py: the phase scan
// (_phase_cumsum), the onsets (_onsets_from_phase) and the compact onset
// tables with the last_valid_f0 carry (_compact_onset_tables).  One launch
// computes, per row of f0 (B, n),
//
//   phase[i] = sum_{i' <= i, acc[i']} d[i'],  d = f0 s / sr  (float64 steps)
//   onset[i] = floor(phase[i]) > floor(phase[i-1]) and acc[i],  phase[-1] = 0
//   row[i]   = number of onsets at or before i, minus 1
//   table row r (the (r+1)-th onset, kept only if r < M = n // spacing + 2):
//     pos = its sample, T = 1 / max(f0 at the last valid sample <= pos, 1e-6)
//     (the fallback f0 if none), T0 = clamp(rint(sr T), 3, 8192), norm = the
//     closed-form grid peak of the LF pulse (ops/pulse.py:_grid_peak)
//   out[i]   = sum_{k < K, 0 <= j < M} lf((i - pos[j]) / T0[j], T[j]) / norm[j]
//              over j = row[i] - k with 0 <= i - pos[j] < T0[j]
//
// with s the f0 scale.  The main pass (gate == nullptr) advances the phase
// everywhere, acc = true and valid = f0 s > 1e-6; the gated subharmonic pass
// advances it only where acc = gate > 0 and f0 > 0 and f0 s >= 1e-2, which is
// also its validity.  The plain PyTorch version is
// ops/pulse.py:pulse_pass_plain.
//
// Design: one row runs on one thread-block cluster of kCluster CTAs (the
// launch scaffolding of csrc/one_pole_cascade.cu), and the cluster walks
// the row in the fewest tiles of at most kTile samples, each split evenly
// over the CTAs in whole warps' spans of 32 kRun samples: CTA r takes the
// tile's r-th segment of at most kSeg samples, thread t of the CTA the run
// of kRun samples at t * kRun, held in registers.  (A main-path note of
// 24696-48510 samples is one tile on all 8 CTAs.)  Per tile:
//   1. f0 (and the gate) come in coalesced through shared memory (padded
//      one word in 32, so that the per-thread reads are free of bank
//      conflicts);
//   2. scan 1: each thread sums its run's phase advance and takes its last
//      valid f0 (0 for none: valid values are positive); warp shuffles scan
//      the lanes, warp 0 scans the 32 warp totals from shared memory, and
//      the kCluster CTA totals are read through distributed shared memory
//      (map_shared_rank) behind cluster barrier A, with the tile's carry
//      entering at rank 0.  The last-valid operator keeps the later of two
//      values when it is valid, so a forward fill needs no index;
//   3. each thread re-runs its phases from its carry-in and marks its
//      onsets; scan 2 counts them the same way (barrier B), so every sample
//      knows its row;
//   4. each onset writes its table row (pos, T0, T, norm) into a (B, M)
//      float4 scratch in device memory; rows past M - 1 still count in row
//      but are never written or read (the j >= M skip);
//   5. after barrier C every row of the tile is in the table.  A CTA's
//      samples reach rows [gen_in - K, min(gen_end, M) - 1] (gen_in and
//      gen_end: onsets before and through its segment); when those fit in
//      the shared stage they are copied there through L2 (__ldcg), else the
//      accumulation reads them from L2 directly.  Rows written by other
//      CTAs, or in earlier tiles, need no exchange of their own, at any
//      onset density and however far back a pulse reaches;
//   6. each sample sums its K most recent rows, in the plain version's
//      expression order, and writes its output.  Here a warp's lanes take
//      neighbouring samples (their rows come from the owning lanes by
//      shuffle), so they walk the same rows through the same branch of
//      the LF pulse, and the warp's stores are coalesced.  Row positions
//      rise with the row, so i - pos[j] grows as a
//      sample reaches back: once it is at least the largest T0 of the
//      staged window (8192, the T0 clamp, when not staged) no older row
//      can sound, and the walk stops.  The rows it skips would each add
//      exactly 0, so the sum is unchanged; a voice of steady pitch walks 2
//      or 3 rows whatever K is.
// Carries across tiles: the phase, the last valid f0 and the onset count.
// Cluster barriers release and acquire the table's device-memory writes at
// cluster scope; reads go through L2 (__ldcg), never a stale L1 line.  Each
// DSMEM total is read between its own barrier and the next one, so no CTA
// rewrites it, or exits, while another may still read it.
//
// What bounds it on the card: bytes are 4 B per sample of f0, 4 more of
// gate for the gated pass and 4 of out, 0.17 us at n = 48510 and
// 3.35 TB/s; the operations (about 30 per live (sample, row) pair for the
// sinf or expf + cosf, 20 per sample of scan work, 60 per onset for the
// table row) are fewer.  In practice the floor is latency: per tile three
// cluster barriers and about ten CTA barriers around short dependent passes
// of kRun samples, as for the cascade kernel.  kRun = 8 keeps a note of the
// main path (24696-48510 samples) in one tile.  IEEE float32 and float64
// with no fast-math flags (nvcc's default FMA contraction stays on, as in
// PyTorch's own CUDA kernels); rintf rounds half to even, as torch.round.
//
// The phase is exact.  Each float64 step d (f0 s / sr, correctly rounded)
// is added as a 128-bit fixed-point number with 64 fraction bits (exact for
// |d| >= 2^-11, within 2^-64 below), so the sum is the same in every
// association order: a thread's last phase and the next thread's carry-in,
// which the scan computes by another path, are the same number.  (In
// float64 they differ by a rounding, and where a tie falls between them an
// onset is counted twice or not at all: the 220 Hz voice golden, whose
// phase comes within 1e-13 of an integer every 11 periods, lost a pulse in
// eleven.)  torch.cumsum rounds its float64 sum, so an onset can still move
// by one sample against the plain version where the phase lies within
// ~1e-13 of an integer; the checks keep their pitches off such ties.  A
// step of 2^32 cycles or more, or a non-finite one, ends the row's onsets
// (with one onset there if it is positive), as a float64 phase would for a
// non-finite step.
//
// C interface for ctypes: goofer_pulse_accumulate launches on the given
// stream, does not synchronise, and returns the launch's CUDA error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // CTAs per row
constexpr int kThreads = 1024;               // threads per CTA
constexpr int kRun = 8;                      // samples per thread
constexpr int kWarps = kThreads / 32;        // at most 32: warp 0 scans them
constexpr int kSeg = kThreads * kRun;        // most samples per CTA
constexpr int kTile = kCluster * kSeg;       // most samples per tile
constexpr int kSpan = 32 * kRun;             // samples per warp
constexpr int kStage = kSeg + kSeg / 32;     // padded stage, in floats
constexpr int kWindow = kStage / 4;          // table rows the stage holds
constexpr float kT0Max = 8192.0f;            // T0 clamp, ops/pulse.py
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarps <= 32, "warp 0 scans one warp total per lane");
static_assert(kStage % 4 == 0, "the stage holds whole float4 rows");

struct LfParams {
  float ra;        // open-phase end, fraction of the period
  float uc;        // return-phase end: Ra + Rk (1 - Ra)
  float two_ra;    // 2 Ra
  float uc_m_ra;   // uc - Ra
  float neg_rg;    // -Rg
  int guard;       // 1: period-scaled epsilon guards of the Numba kernel
};

struct PassParams {
  double sr;       // sample rate, for the float64 phase
  double inv_sr;   // 1 / sr, correctly rounded
  float sr_f;      // float32(sr), for T0 = rint(sr T)
  float scale;     // f0 scale (the subharmonic ratio; 1 for the main pass)
  float fallback;  // f0 before the first valid sample
  LfParams lf;
};

using Phase = __int128;   // cycles, fixed point with 64 fraction bits
constexpr double kStepMax = 4294967296.0;    // 2^32 cycles

// what scan 1 carries over a span of samples
struct Span {
  Phase phase;     // phase advance
  float last;      // last valid f0, 0 for none
  int dead;        // 1: a step of 2^32 cycles or more, or not finite
};

// shared-memory index of segment sample i: one pad word per 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// the last valid f0 of an earlier span followed by a later one
__device__ __forceinline__ float last_of(float earlier, float later) {
  return later > 0.0f ? later : earlier;
}

// an earlier span followed by a later one
__device__ __forceinline__ Span then(const Span& a, const Span& b) {
  return Span{a.phase + b.phase, last_of(a.last, b.last), a.dead | b.dead};
}

__device__ __forceinline__ long long cycles(Phase p) {
  return static_cast<long long>(p >> 64);  // floor
}

// lane `src` (shuffle_up: lane - src) of a warp's spans
template <bool kUp>
__device__ __forceinline__ Span shfl(const Span& x, int src) {
  const auto get = [src](long long v) {
    return kUp ? __shfl_up_sync(kFull, v, src) : __shfl_sync(kFull, v, src);
  };
  const auto get32 = [src](auto v) {
    return kUp ? __shfl_up_sync(kFull, v, src) : __shfl_sync(kFull, v, src);
  };
  using U = unsigned __int128;
  const auto lo = static_cast<unsigned long long>(
      get(static_cast<long long>(x.phase)));
  const auto hi = static_cast<unsigned long long>(
      get(static_cast<long long>(x.phase >> 64)));
  return Span{static_cast<Phase>((static_cast<U>(hi) << 64) | lo),
              get32(x.last), get32(x.dead)};
}

// inclusive scan over the first `width` lanes
__device__ __forceinline__ void scan_spans(Span& x, int lane, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const Span up = shfl<true>(x, off);
    if (lane >= off) x = then(up, x);
  }
}

// f / sr, correctly rounded, as one product and two FMAs: with inv_sr the
// correctly rounded 1 / sr, q0 = f inv_sr is within an ulp, r = f - q0 sr is
// exact, and q0 + r inv_sr rounds to the IEEE quotient (Markstein's
// correction; tests/test_torch_pulse.py:test_phase_step_matches_division
// holds it to division).  The double division it replaces, twice per
// sample, cost 4.7 us of a silent 40000-sample row on an H100 80GB HBM3 at
// 700 W (tools/pulse_kernel_variants.py).
__device__ __forceinline__ double phase_step(float f, double sr,
                                             double inv_sr) {
  const double a = static_cast<double>(f);
  const double q0 = a * inv_sr;
  if (!isfinite(q0)) return q0;
  return fma(fma(-q0, sr, a), inv_sr, q0);
}

// d 2^64 rounded toward zero, for |d| < 2^32: exact for |d| >= 2^-11, whose
// 53-bit mantissa lies above 2^-64
__device__ __forceinline__ Phase to_fixed(double d) {
  const long long bits = __double_as_longlong(d);
  const int ex = static_cast<int>((bits >> 52) & 0x7ff);
  if (ex == 0) return 0;  // zero or subnormal
  const unsigned long long m = (bits & 0xfffffffffffffull) | (1ull << 52);
  const int sh = ex - 1075 + 64;  // d = m 2^(ex - 1075)
  Phase v = 0;
  if (sh >= 0) {
    v = static_cast<Phase>(m) << sh;
  } else if (sh > -64) {
    v = static_cast<Phase>(m >> -sh);
  }
  return bits < 0 ? -v : v;
}

__device__ __forceinline__ void scan_count(int& c, int lane, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const int up = __shfl_up_sync(kFull, c, off);
    if (lane >= off) c += up;
  }
}

// LF pulse at u = t / T0 in [0, 1) (ops/pulse.py:lf_pulse_value)
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

// max_j lf(j / T0): on one of the two grid points straddling u = Ra
// (ops/pulse.py:_grid_peak)
__device__ __forceinline__ float grid_peak(float t0, float T,
                                           const LfParams& p) {
  const float j_lo = floorf(p.ra * t0);
  const float j_hi = fminf(j_lo + 1.0f, t0 - 1.0f);
  const float lo = lf_pulse_value(j_lo / t0, T, p);
  const float hi = lf_pulse_value(j_hi / t0, T, p);
  return fmaxf(fmaxf(lo, hi), 1e-12f);
}

__global__ void __launch_bounds__(kThreads, 1)
pulse_accumulate_kernel(const float* __restrict__ f0,
                        const float* __restrict__ gate,
                        float4* __restrict__ table, float* __restrict__ out,
                        int n, int m, int max_overlap, PassParams pp) {
  // tile segment in; then the CTA's window of table rows
  __shared__ __align__(16) float s_stage[kStage];
  __shared__ Span s_wspan[kWarps];   // warp totals, then exclusive prefixes
  __shared__ int s_wcnt[kWarps];
  __shared__ Span s_cta;             // this CTA's totals (DSMEM)
  __shared__ int s_cta_count;
  __shared__ Span s_in;              // carry into this CTA's segment
  __shared__ int s_gen_in;           // onsets before this CTA's segment
  __shared__ int s_gen_end;          // onsets through it
  __shared__ Span s_carry;           // carry into the tile
  __shared__ int s_gen_carry;
  __shared__ int s_t0_max;           // largest T0 of the window (its bits)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x / kCluster;
  const float* f0_row = f0 + row * n;
  const float* gate_row = gate != nullptr ? gate + row * n : nullptr;
  float4* tab = table + row * m;
  float* out_row = out + row * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const LfParams& lf = pp.lf;
  float4* s_win = reinterpret_cast<float4*>(s_stage);
  if (tid == 0) {
    s_carry = Span{0, 0.0f, 0};
    s_gen_carry = 0;
  }

  // the fewest tiles, each split evenly over the CTAs in warp spans
  const int tiles = (n + kTile - 1) / kTile;
  const int per_tile = (n + tiles - 1) / tiles;
  const int seg =
      (per_tile + kCluster * kSpan - 1) / (kCluster * kSpan) * kSpan;
  for (int t0 = 0; t0 < n; t0 += kCluster * seg) {
    const int seg0 = t0 + rank * seg;
    const int seg_end = min(n, seg0 + seg);
    const int lo = seg0 + tid * kRun;
    const int cnt = max(0, min(kRun, seg_end - lo));
    float v[kRun];
    unsigned acc_bits = 0;     // the phase advances
    unsigned valid_bits = 0;   // f0 counts as the last valid f0

    // 1. f0 and the gate into registers, coalesced through shared memory
    if (tid == 0) s_t0_max = 0;
    for (int i = tid; i < seg; i += kThreads) {
      const int g = seg0 + i;
      s_stage[pad(i)] = g < seg_end ? f0_row[g] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = s_stage[pad(tid * kRun + k)];
    if (gate_row != nullptr) {
      __syncthreads();
      for (int i = tid; i < seg; i += kThreads) {
        const int g = seg0 + i;
        s_stage[pad(i)] = g < seg_end ? gate_row[g] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const float sub = v[k] * pp.scale;
        if (k < cnt && s_stage[pad(tid * kRun + k)] > 0.0f && v[k] > 0.0f &&
            sub >= 1e-2f) {
          acc_bits |= 1u << k;
        }
        v[k] = sub;
      }
      valid_bits = acc_bits;
    } else {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        v[k] *= pp.scale;
        if (k < cnt) {
          acc_bits |= 1u << k;
          if (v[k] > 1e-6f) valid_bits |= 1u << k;
        }
      }
    }

    // 2. scan 1: phase advance and last valid f0 over the cluster
    Span x{0, 0.0f, 0};
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if ((acc_bits >> k) & 1u) {
        const double d = phase_step(v[k], pp.sr, pp.inv_sr);
        if (fabs(d) < kStepMax) {
          x.phase += to_fixed(d);
        } else {
          x.dead = 1;
        }
      }
      if ((valid_bits >> k) & 1u) x.last = v[k];
    }
    scan_spans(x, lane, 32);
    if (lane == 31) s_wspan[warp] = x;
    Span x_ex = shfl<true>(x, 1);  // this lane's exclusive prefix
    if (lane == 0) x_ex = Span{0, 0.0f, 0};
    __syncthreads();
    if (warp == 0) {
      Span w = lane < kWarps ? s_wspan[lane] : Span{0, 0.0f, 0};
      scan_spans(w, lane, kWarps);
      const Span e = shfl<true>(w, 1);
      if (lane < kWarps) s_wspan[lane] = lane == 0 ? Span{0, 0.0f, 0} : e;
      if (lane == kWarps - 1) s_cta = w;
    }
    cluster.sync();  // A
    if (warp == 0) {
      // every CTA's totals, scanned over the cluster's ranks
      Span c = lane < kCluster ? *cluster.map_shared_rank(&s_cta, lane)
                               : Span{0, 0.0f, 0};
      scan_spans(c, lane, kCluster);
      const Span e = shfl<false>(c, rank > 0 ? rank - 1 : 0);
      const Span t = shfl<false>(c, kCluster - 1);
      if (lane == 0) {
        const Span carry = s_carry;
        s_in = rank == 0 ? carry : then(carry, e);
        s_carry = then(carry, t);
      }
    }
    __syncthreads();

    // 3. phases and onsets of this run, from its carry-in
    const Span in = then(then(s_in, s_wspan[warp]), x_ex);
    unsigned onset_bits = 0;
    {
      Phase p = in.phase;
      long long fl = cycles(p);
      bool dead = in.dead != 0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (((acc_bits >> k) & 1u) && !dead) {
          const double d = phase_step(v[k], pp.sr, pp.inv_sr);
          if (fabs(d) < kStepMax) {
            p += to_fixed(d);
            const long long f = cycles(p);
            if (f > fl) onset_bits |= 1u << k;
            fl = f;
          } else {
            if (d > 0.0) onset_bits |= 1u << k;
            dead = true;
          }
        }
      }
    }

    // scan 2: onsets over the cluster
    int c = __popc(onset_bits);
    scan_count(c, lane, 32);
    if (lane == 31) s_wcnt[warp] = c;
    int c_ex = __shfl_up_sync(kFull, c, 1);
    if (lane == 0) c_ex = 0;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? s_wcnt[lane] : 0;
      scan_count(w, lane, kWarps);
      const int e = __shfl_up_sync(kFull, w, 1);
      if (lane < kWarps) s_wcnt[lane] = lane == 0 ? 0 : e;
      if (lane == kWarps - 1) s_cta_count = w;
    }
    cluster.sync();  // B
    if (warp == 0) {
      int cc = lane < kCluster ? *cluster.map_shared_rank(&s_cta_count, lane)
                               : 0;
      scan_count(cc, lane, kCluster);
      const int incl = __shfl_sync(kFull, cc, rank);
      const int e = __shfl_sync(kFull, cc, rank > 0 ? rank - 1 : 0);
      const int tot = __shfl_sync(kFull, cc, kCluster - 1);
      if (lane == 0) {
        const int g = s_gen_carry;
        s_gen_in = rank == 0 ? g : g + e;
        s_gen_end = g + incl;
        s_gen_carry = g + tot;
      }
    }
    __syncthreads();
    const int gen_in = s_gen_in + s_wcnt[warp] + c_ex;  // before this run

    // 4. table rows of this run's onsets
    {
      float last = in.last;
      int g = gen_in;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if ((valid_bits >> k) & 1u) last = v[k];
        if ((onset_bits >> k) & 1u) {
          if (g < m) {
            const float f0_at = last > 0.0f ? last : pp.fallback;
            const float t = 1.0f / fmaxf(f0_at, 1e-6f);
            const float t0 = fminf(fmaxf(rintf(pp.sr_f * t), 3.0f), kT0Max);
            tab[g] = make_float4(static_cast<float>(lo + k), t0, t,
                                 grid_peak(t0, t, lf));
          }
          ++g;
        }
      }
    }
    cluster.sync();  // C: the tile's rows are in the table

    // 5. the rows this CTA's samples reach, staged when they fit, and
    // their largest T0 (positive floats order as their bits)
    const int w_lo = max(0, s_gen_in - max_overlap);
    const int w_n = min(s_gen_end, m) - w_lo;
    const bool staged = w_n <= kWindow;
    if (staged) {
      int t0_bits = 0;
      for (int i = tid; i < w_n; i += kThreads) {
        const float4 e = __ldcg(tab + w_lo + i);
        s_win[i] = e;
        t0_bits = max(t0_bits, __float_as_int(e.y));
      }
      t0_bits = __reduce_max_sync(kFull, t0_bits);
      if (lane == 0 && t0_bits > 0) atomicMax(&s_t0_max, t0_bits);
      __syncthreads();
    }
    const float reach = staged ? __int_as_float(s_t0_max) : kT0Max;

    // 6. each sample's K most recent rows.  Lanes take neighbouring
    // samples here: lane l of warp w the samples 32 k + l of the warp's
    // 32 kRun, whose run belongs to lane (32 k + l) / kRun of the same warp,
    // so a warp's lanes walk the same rows through the same LF segment.
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int q = k * 32 + lane;
      const int owner_gen = __shfl_sync(kFull, gen_in, q / kRun);
      const unsigned owner_onsets = __shfl_sync(kFull, onset_bits, q / kRun);
      const int i = seg0 + warp * kSpan + q;
      if (i < seg_end) {
        const int r =
            owner_gen + __popc(owner_onsets & ((2u << (q % kRun)) - 1u)) - 1;
        const float t = static_cast<float>(i);
        float acc = 0.0f;
        for (int j = min(r, m - 1); j >= max(0, r - max_overlap + 1); --j) {
          const float4 e = staged ? s_win[j - w_lo] : __ldcg(tab + j);
          const float offs = t - e.x;
          if (offs >= reach) break;  // no older row sounds here
          if (offs >= 0.0f && offs < e.y) {
            // u < 1 follows from offs < T0
            acc += lf_pulse_value(offs / e.y, e.z, lf) / e.w;
          }
        }
        out_row[i] = acc;
      }
    }
    __syncthreads();  // the window is read before the next tile's load
  }
}

}  // namespace

extern "C" int goofer_pulse_accumulate(const float* f0, const float* gate,
                                       float* table, float* out, int batch,
                                       int n, int m, int max_overlap,
                                       double sr, double scale,
                                       double fallback_f0, double ra,
                                       double rg, double rk, int guard,
                                       void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (m < 1 || batch > (1 << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const double uc = ra + rk * (1.0 - ra);
  PassParams pp;
  pp.sr = sr;
  pp.inv_sr = 1.0 / sr;
  pp.sr_f = static_cast<float>(sr);
  pp.scale = static_cast<float>(scale);
  pp.fallback = static_cast<float>(fallback_f0);
  pp.lf.ra = static_cast<float>(ra);
  pp.lf.uc = static_cast<float>(uc);
  pp.lf.two_ra = static_cast<float>(2.0 * ra);
  pp.lf.uc_m_ra = static_cast<float>(uc - ra);
  pp.lf.neg_rg = static_cast<float>(-rg);
  pp.lf.guard = guard;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pulse_accumulate_kernel, f0, gate,
      reinterpret_cast<float4*>(table), out, n, m, max_overlap, pp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
