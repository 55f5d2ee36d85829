// Pitch-tracker Viterbi for Hopper (sm_90a): the max-sum path over the
// tracker's K = 6 voiced candidates + 1 unvoiced state per frame, one launch
// for a batch of files.
//
// Replaces goofer_tpu/analysis/pitch.py:_viterbi (non-Pallas JAX code).
// That function solves the path with two associative scans of (K+1)x(K+1)
// max-plus matrices and a marginal decode, a form chosen because one
// sequential step was expensive on the TPU.  Eager PyTorch has no
// counterpart of the scans, and the sequential solve as a Python loop is
// ~10 small launches per frame.  This kernel is the classic sequential
// solve with a backtrace, whole in one launch:
//
//   delta[0][j] = s[0][j]
//   back[t][j]  = first argmax_i (delta[t-1][i] - cost(f[t-1][i], f[t][j]))
//   delta[t][j] = s[t][j] + max_i (...)
//   state[nf-1] = first argmax_j delta[nf-1][j];  state[t-1] = back[t][state[t]]
//
// with cost = oj * |log2(max(f_prev, 1e-6) / max(f_next, 1e-6))| between
// two voiced states (f > 0), vu between a voiced and the unvoiced state,
// 0 between two unvoiced.  State K is the unvoiced one: frequency 0,
// strength unvoiced[t].  Row b stops at its own frame count nf[b]; past
// it f0 is 0 and the path -1.
//
// What bounds it on the card: the bytes (2K + 1 floats per frame read, two
// words written) are nanoseconds; the floor is the chain of nf - 1
// dependent steps, and it hardly grows with B until the CTAs fill the
// card.  So the design keeps everything that does not depend on the
// scores out of that chain.
//
// Design: one CTA of kThreads per row.  The transition costs (a division
// and a log2f each, (K+1)^2 per frame) depend on the candidates only, so
// warps 1.. compute them, and stage the strengths, a tile of frames ahead
// into one of two shared buffers while warp 0 walks the chain through the
// other: state j on lane j, the K+1 previous scores by shuffle, the costs
// from shared memory, a subtraction each, the first maximum (a compare
// tree, unrolled for the 7 states, whose left operand holds the lower
// indices and wins ties), one addition.  The state count is a compile-time
// constant; the entry point refuses any other K.  A backpointer is one
// byte, in shared memory while a row's frames x (K+1) bytes fit
// kSharedBackBytes, in a global scratch beyond that, which the backtrace
// stages through shared memory in blocks.  Thread 0 walks the backtrace,
// then the CTA writes f0.
//
// Every operation is IEEE float32 in the order of
// analysis/pitch.py:viterbi_plain; the products, sums and divisions are
// the _rn intrinsics, which the compiler never contracts into FMAs, so the
// kernel's path equals the plain version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kVoiced = 6;            // the tracker's candidates per frame
constexpr int kStates = kVoiced + 1;  // and the unvoiced state
constexpr int kPerFrame = kStates * (kStates + 1);
// one tile: per frame (K+1)^2 costs, [previous state][state], then the
// K+1 strengths
constexpr int kTileFloats = 2048;
constexpr int kTileFrames = kTileFloats / kPerFrame;
constexpr int kSharedBackBytes = 32 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float transition_cost(float f_prev, float f_next,
                                                 float vu, float oj) {
  const bool pv = f_prev > 0.0f;
  const bool nv = f_next > 0.0f;
  const float ratio = __fdiv_rn(fmaxf(f_prev, 1e-6f), fmaxf(f_next, 1e-6f));
  const float jump = __fmul_rn(oj, fabsf(log2f(ratio)));
  return (pv && nv) ? jump : ((pv != nv) ? vu : 0.0f);
}

// Threads first, first + stride, .. fill `tile` for frames [t_begin, t_end).
__device__ __forceinline__ void fill_tile(float* tile, int t_begin, int t_end,
                                          int first, int stride,
                                          const float* __restrict__ fr,
                                          const float* __restrict__ st,
                                          const float* __restrict__ uv,
                                          float vu, float oj) {
  const int total = (t_end - t_begin) * kPerFrame;
  for (int idx = first; idx < total; idx += stride) {
    const int f = idx / kPerFrame;
    const int rem = idx - f * kPerFrame;
    const int i = rem / kStates;
    const int j = rem - i * kStates;
    const size_t t = static_cast<size_t>(t_begin + f);
    float v;
    if (i < kStates) {
      const float f_prev = i < kVoiced ? fr[(t - 1) * kVoiced + i] : 0.0f;
      const float f_next = j < kVoiced ? fr[t * kVoiced + j] : 0.0f;
      v = transition_cost(f_prev, f_next, vu, oj);
    } else {
      v = j < kVoiced ? st[t * kVoiced + j] : uv[t];
    }
    tile[idx] = v;
  }
}

// One frame's update of lane j: the first maximum over the previous
// states i of delta[i] - cost[i][j], and its index.
__device__ __forceinline__ void best_previous(float delta,
                                              const float* cost_j,
                                              float& best, int& arg) {
  constexpr int kPadded = 8;
  static_assert(kStates <= kPadded, "the compare tree holds 8 states");
  float score[kPadded];
  int index[kPadded];
#pragma unroll
  for (int i = 0; i < kPadded; ++i) {
    index[i] = i;
    score[i] = i < kStates ? __fsub_rn(__shfl_sync(kFull, delta, i),
                                       cost_j[i * kStates])
                           : -INFINITY;
  }
#pragma unroll
  for (int w = 1; w < kPadded; w *= 2) {
#pragma unroll
    for (int a = 0; a + w < kPadded; a += 2 * w) {
      if (score[a + w] > score[a]) {
        score[a] = score[a + w];
        index[a] = index[a + w];
      }
    }
  }
  best = score[0];
  arg = index[0];
}

template <bool kSharedBack>
__global__ void __launch_bounds__(kThreads)
pitch_viterbi_kernel(const float* __restrict__ freqs,
                     const float* __restrict__ strengths,
                     const float* __restrict__ unvoiced,
                     const int* __restrict__ nf,
                     unsigned char* __restrict__ back_global,
                     float* __restrict__ f0, int* __restrict__ path,
                     int frames, float vu, float oj) {
  extern __shared__ unsigned char back_shared[];
  __shared__ float tiles[2][kTileFloats];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  constexpr int k = kVoiced;
  constexpr int states = kStates;
  constexpr int per_frame = kPerFrame;
  constexpr int tile_frames = kTileFrames;
  const size_t base = static_cast<size_t>(row) * frames;
  const float* fr = freqs + base * k;
  const float* st = strengths + base * k;
  const float* uv = unvoiced + base;
  unsigned char* back =
      kSharedBack ? back_shared : back_global + base * states;
  float* f0_row = f0 + base;
  int* path_row = path + base;
  const int n = min(max(nf[row], 0), frames);

  if (n > 0) {
    // warp 0's lane j carries state j's score; lanes past the states idle
    const int lane_c = min(lane, states - 1);
    float delta = -INFINITY;
    if (warp == 0 && lane < states) delta = lane < k ? st[lane] : uv[0];

    fill_tile(tiles[0], 1, min(1 + tile_frames, n), tid, kThreads, fr, st, uv,
              vu, oj);
    __syncthreads();
    for (int t0 = 1, buf = 0; t0 < n; t0 += tile_frames, buf ^= 1) {
      const int t1 = min(t0 + tile_frames, n);
      if (warp == 0) {
        for (int t = t0; t < t1; ++t) {
          const float* frame = tiles[buf] + (t - t0) * per_frame;
          float best;
          int arg;
          best_previous(delta, frame + lane_c, best, arg);
          delta = __fadd_rn(frame[states * states + lane_c], best);
          if (lane < states) {
            back[static_cast<size_t>(t) * states + lane] =
                static_cast<unsigned char>(arg);
          }
        }
      } else if (t1 < n) {
        fill_tile(tiles[buf ^ 1], t1, min(t1 + tile_frames, n), tid - kWarp,
                  kThreads - kWarp, fr, st, uv, vu, oj);
      }
      __syncthreads();
    }

    // the last frame's best state, the first of equal scores
    int state = 0;
    if (warp == 0) {
      float best = -INFINITY;
      for (int i = 0; i < states; ++i) {
        const float d_i = __shfl_sync(kFull, delta, i);
        if (d_i > best) {
          best = d_i;
          state = i;
        }
      }
    }
    if (kSharedBack) {
      if (tid == 0) {
        for (int t = n - 1; t >= 1; --t) {
          path_row[t] = state;
          state = back[static_cast<size_t>(t) * states + state];
        }
        path_row[0] = state;
      }
    } else {
      // blocks of the scratch's backpointers through the tile buffers
      unsigned char* stage = reinterpret_cast<unsigned char*>(tiles);
      const int stage_frames = static_cast<int>(sizeof(tiles)) / states;
      for (int hi = n; hi > 1;) {
        const int lo = max(1, hi - stage_frames);
        const unsigned char* src = back + static_cast<size_t>(lo) * states;
        for (int i = tid; i < (hi - lo) * states; i += kThreads) {
          stage[i] = src[i];
        }
        __syncthreads();
        if (tid == 0) {
          for (int t = hi - 1; t >= lo; --t) {
            path_row[t] = state;
            state = stage[(t - lo) * states + state];
          }
        }
        __syncthreads();
        hi = lo;
      }
      if (tid == 0) path_row[0] = state;
    }
    __syncthreads();
  }
  for (int t = tid; t < frames; t += kThreads) {
    float f = 0.0f;
    if (t < n) {
      const int s = path_row[t];
      if (s < k) f = fr[static_cast<size_t>(t) * k + s];
    } else {
      path_row[t] = -1;
    }
    f0_row[t] = f;
  }
}

}  // namespace

// freqs, strengths: (batch, frames, k) float32 with k = 6, any other k is
// refused; unvoiced: (batch, frames) float32; nf: (batch,) int32;
// back_scratch: (batch, frames, k + 1) bytes, used (and required) only when
// frames * (k + 1) > 32 KB; f0: (batch, frames) float32 out; path: (batch,
// frames) int32 out.
extern "C" int goofer_pitch_viterbi(const float* freqs,
                                    const float* strengths,
                                    const float* unvoiced, const int* nf,
                                    unsigned char* back_scratch, float* f0,
                                    int* path, int batch, int frames, int k,
                                    float vu, float oj, void* stream) {
  if (k != kVoiced) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || frames == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t back_bytes = static_cast<size_t>(frames) * kStates;
  const bool shared = back_bytes <= kSharedBackBytes;
  if (!shared && back_scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel =
      shared ? pitch_viterbi_kernel<true> : pitch_viterbi_kernel<false>;
  kernel<<<batch, kThreads, shared ? back_bytes : 0, s>>>(
      freqs, strengths, unvoiced, nf, back_scratch, f0, path, frames, vu, oj);
  return static_cast<int>(cudaGetLastError());
}
