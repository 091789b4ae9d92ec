// K1: greedy CTC decode, for sm_90a.
//
// Replaces the Pallas kernel vse_tpu/kernels/ctc_decode.py::_argmax_lse_kernel
// (pallas_call in ctc_greedy_decode_pallas) and the plain-XLA tail around it.
// For f32, f16 or bf16 logits [N, T, C] (each loaded value converted to
// f32 in registers, as the reference's body casts; no f32 copy of the
// logits is made) it writes
//   ids    [N, T] int32  the kept classes (not blank 0, not a repeat of the
//                        step before), left-packed, zero after them
//   mask   [N, T] bool   t < number kept
//   scores [N]    f32    mean softmax probability of the kept steps, 1.0
//                        when nothing is kept
// where each step's class is the FIRST max over C (as jnp.argmax) and its
// probability is exp(max - logsumexp).
//
// What bounds it on the H100: bytes. Every logit is read once (4*N*T*C
// bytes in f32, half that in f16/bf16) and 9 bytes per step plus 4 per
// sequence are written: at 3.35 TB/s the main path's f32 [64, 80, 69] call
// needs ~0.45 us and the 21,249-class heads' [64, 80, 21249] ~130 us. The arithmetic (one expf a
// logit) is far below the card's rate.
//
// Design:
// - Small C (the fused path, C <= 1024): one block per sequence, a group of
//   8, 16 or 32 consecutive lanes per step (8 at C = 69: a warp reduces four
//   steps at once, and a block of up to 16 warps all its steps in two
//   passes); the block keeps the steps' (class, prob) in shared memory and
//   warp 0 collapses, left-packs (__ballot_sync + __popc give the packed
//   slots) and scores them. The whole decode is one launch.
// - Large C: one block per step. 16-byte loads (4 f32 or 8 f16/bf16) after
//   a prologue that brings the row to a 16-byte boundary (rows start only
//   element-aligned at odd C), four loads in flight a thread; the max of
//   the loaded values first, then one rescale of the running sum, so one
//   expf a logit plus at most one per 16-32. A second kernel, one warp per
//   sequence, collapses.
// - Ties: each thread visits its classes in increasing order and keeps the
//   first max; every merge keeps the lower index when the maxima are equal.
// - Sums run in a fixed order, so the result is the same from run to run.
//   expf/logf (not __expf) keep it within 1e-5 of the plain version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FUSED_WARPS = 16;
constexpr int COLLAPSE_WARPS = 4;

// One logit, converted to f32 on load.
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __half* p) {
  return __half2float(
      __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// A 16-byte vector of logits as E = 16 / sizeof(T) f32 values, in order.
template <typename T>
struct Vec {
  static constexpr int E = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

template <typename H>
__device__ __forceinline__ float half_of(unsigned short b);
template <>
__device__ __forceinline__ float half_of<__half>(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}
template <>
__device__ __forceinline__ float half_of<__nv_bfloat16>(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

template <typename H>
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // little-endian: element 2k is the low half
    f[2 * k] = half_of<H>((unsigned short)(w[k] & 0xffffu));
    f[2 * k + 1] = half_of<H>((unsigned short)(w[k] >> 16));
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       const __half*) {
  unpack16<__half>(u, f);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       const __nv_bfloat16*) {
  unpack16<__nv_bfloat16>(u, f);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4],
                                       const float*) {
  unpack(u, f);
}

struct ArgState {
  float m;  // running max
  float s;  // sum of exp(x - m); 0 marks an empty state
  int i;    // index of the first max
};

__device__ __forceinline__ ArgState empty_state() {
  return ArgState{-INFINITY, 0.f, 0x7fffffff};
}

__device__ __forceinline__ void push(ArgState& st, float v, int c) {
  if (st.s == 0.f) {
    st.m = v;
    st.s = 1.f;
    st.i = c;
  } else if (v > st.m) {
    st.s = st.s * expf(st.m - v) + 1.f;
    st.m = v;
    st.i = c;
  } else {
    st.s += expf(v - st.m);  // an equal value keeps the earlier index
  }
}

__device__ __forceinline__ ArgState merge(ArgState a, ArgState b) {
  if (b.s == 0.f) return a;
  if (a.s == 0.f) return b;
  if (a.m > b.m) {
    a.s = a.s + b.s * expf(b.m - a.m);
    return a;
  }
  if (b.m > a.m) {
    b.s = b.s + a.s * expf(a.m - b.m);
    return b;
  }
  a.s = a.s + b.s;
  a.i = min(a.i, b.i);
  return a;
}

// Merge the states of each group of `width` lanes (a power of two <= 32);
// the group's first lane holds the result.
__device__ __forceinline__ ArgState warp_merge(ArgState st, int width = 32) {
  for (int d = width >> 1; d > 0; d >>= 1) {
    ArgState o;
    o.m = __shfl_down_sync(FULL, st.m, d, width);
    o.s = __shfl_down_sync(FULL, st.s, d, width);
    o.i = __shfl_down_sync(FULL, st.i, d, width);
    st = merge(st, o);
  }
  return st;
}

__device__ __forceinline__ float best_prob(const ArgState& st) {
  const float lse = st.m + logf(st.s);
  return expf(st.m - lse);
}

// One warp collapses one sequence of T steps (best/prob in shared or global
// memory): kept = not blank and not the previous step's class.
__device__ void collapse_warp(const int* best, const float* prob, int T,
                              int* __restrict__ ids, uint8_t* __restrict__ mask,
                              float* __restrict__ score) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  float psum = 0.f;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    bool keep = false;
    int b = 0;
    if (t < T) {
      b = best[t];
      keep = b != 0 && (t == 0 || b != best[t - 1]);
    }
    const unsigned bits = __ballot_sync(FULL, keep);
    if (keep) {
      ids[base + __popc(bits & ((1u << lane) - 1u))] = b;
      psum += prob[t];
    }
    base += __popc(bits);
  }
  for (int t = lane; t < T; t += 32) {
    mask[t] = t < base;
    if (t >= base) ids[t] = 0;
  }
  for (int d = 16; d > 0; d >>= 1) psum += __shfl_down_sync(FULL, psum, d);
  if (lane == 0) *score = base > 0 ? __fdiv_rn(psum, (float)base) : 1.0f;
}

// Fused path: block n decodes sequence n. A group of LANES consecutive
// lanes reduces one step (lane k of the group takes classes k, k+LANES, ...),
// so a warp works on 32 / LANES steps at once.
template <int LANES, typename LT>
__global__ void __launch_bounds__(FUSED_WARPS * 32)
ctc_decode_fused_kernel(const LT* __restrict__ logits, int T, int C,
                        int* __restrict__ ids, uint8_t* __restrict__ mask,
                        float* __restrict__ scores) {
  extern __shared__ int smem[];
  int* s_best = smem;
  float* s_prob = reinterpret_cast<float*>(smem + T);
  constexpr int GROUPS = 32 / LANES;
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES;
  const int n_groups = (blockDim.x >> 5) * GROUPS;
  // every lane of a warp runs the same number of passes (the shuffles)
  for (int t0 = (threadIdx.x >> 5) * GROUPS; t0 < T; t0 += n_groups) {
    const int t = t0 + lane / LANES;
    ArgState st = empty_state();
    if (t < T) {
      const LT* x = logits + ((size_t)n * T + t) * C;
#pragma unroll 4
      for (int c = sub; c < C; c += LANES) push(st, load1(x + c), c);
    }
    st = warp_merge(st, LANES);
    if (sub == 0 && t < T) {
      s_best[t] = st.i;
      s_prob[t] = best_prob(st);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    collapse_warp(s_best, s_prob, T, ids + (size_t)n * T, mask + (size_t)n * T,
                  scores + n);
  }
}

// Large-C path: block r reduces step r into best[r], prob[r].
template <typename LT>
__global__ void __launch_bounds__(256)
ctc_argmax_lse_rows_kernel(const LT* __restrict__ logits, int C,
                           int* __restrict__ best, float* __restrict__ prob) {
  constexpr int E = Vec<LT>::E;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int B = blockDim.x;
  const LT* x = logits + (size_t)row * C;
  ArgState st = empty_state();

  // prologue: the classes before the first 16-byte boundary
  int head = (int)(((16u - ((uintptr_t)x & 15u)) & 15u) / sizeof(LT));
  head = min(head, C);
  if (tid < head) push(st, load1(x + tid), tid);
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  const int nvec = (C - head) / E;

  // body: four 16-byte loads in flight, vectors tid, tid+B, tid+2B, tid+3B;
  // vector j holds classes head + E*j .. head + E*j + E - 1
  int j = tid;
  for (; j + 3 * B < nvec; j += 4 * B) {
    float a[4][E];
#pragma unroll
    for (int k = 0; k < 4; ++k) unpack(__ldg(v + j + k * B), a[k], x);
    float m = a[0][0];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) m = fmaxf(m, a[k][e]);
    if (st.s == 0.f || m > st.m) {
      int i = -1;  // the first of the loaded classes that holds the max
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (i < 0 && a[k][e] == m) i = head + E * (j + k * B) + e;
      st.s = st.s == 0.f ? 0.f : st.s * expf(st.m - m);
      st.m = m;
      st.i = i;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += expf(a[k][e] - st.m);
      st.s += s;
    }
  }
  // the vectors left over, one at a time
  for (; j < nvec; j += B) {
    float a[E];
    unpack(__ldg(v + j), a, x);
    float m = a[0];
#pragma unroll
    for (int e = 1; e < E; ++e) m = fmaxf(m, a[e]);
    if (st.s == 0.f || m > st.m) {
      int i = -1;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (i < 0 && a[e] == m) i = head + E * j + e;
      st.s = st.s == 0.f ? 0.f : st.s * expf(st.m - m);
      st.m = m;
      st.i = i;
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += expf(a[e] - st.m);
    st.s += s;
  }
  // tail: the classes after the last whole vector
  const int tail0 = head + E * nvec;
  if (tid < C - tail0) push(st, load1(x + tail0 + tid), tail0 + tid);

  st = warp_merge(st);
  __shared__ ArgState warp_states[32];
  const int lane = tid & 31, warp = tid >> 5, n_warps = B >> 5;
  if (lane == 0) warp_states[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < n_warps ? warp_states[lane] : empty_state();
    st = warp_merge(st);
    if (lane == 0) {
      best[row] = st.i;
      prob[row] = best_prob(st);
    }
  }
}

__global__ void __launch_bounds__(COLLAPSE_WARPS * 32)
ctc_collapse_kernel(const int* __restrict__ best, const float* __restrict__ prob,
                    int N, int T, int* __restrict__ ids,
                    uint8_t* __restrict__ mask, float* __restrict__ scores) {
  const int n = blockIdx.x * COLLAPSE_WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  collapse_warp(best + (size_t)n * T, prob + (size_t)n * T, T,
                ids + (size_t)n * T, mask + (size_t)n * T, scores + n);
}

template <typename LT>
int decode_typed(const LT* x, int N, int T, int C, int fused, int lanes,
                 int threads, void* best, void* prob, void* ids, void* mask,
                 void* scores, cudaStream_t s) {
  if (N > 0 && fused) {
    // enough warps for every step at once, up to FUSED_WARPS
    const int warps = max(1, min(FUSED_WARPS, (T * lanes + 31) / 32));
    const size_t smem = (size_t)T * 8;
    if (lanes == 8) {
      ctc_decode_fused_kernel<8, LT><<<N, warps * 32, smem, s>>>(
          x, T, C, (int*)ids, (uint8_t*)mask, (float*)scores);
    } else if (lanes == 16) {
      ctc_decode_fused_kernel<16, LT><<<N, warps * 32, smem, s>>>(
          x, T, C, (int*)ids, (uint8_t*)mask, (float*)scores);
    } else if (lanes == 32) {
      ctc_decode_fused_kernel<32, LT><<<N, warps * 32, smem, s>>>(
          x, T, C, (int*)ids, (uint8_t*)mask, (float*)scores);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else if (N > 0) {
    if (T > 0) {
      ctc_argmax_lse_rows_kernel<LT><<<N * T, threads, 0, s>>>(
          x, C, (int*)best, (float*)prob);
    }
    ctc_collapse_kernel<<<(N + COLLAPSE_WARPS - 1) / COLLAPSE_WARPS,
                          COLLAPSE_WARPS * 32, 0, s>>>(
        (const int*)best, (const float*)prob, N, T, (int*)ids, (uint8_t*)mask,
        (float*)scores);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// logits [N, T, C] of dtype 0 (f32), 1 (f16) or 2 (bf16); ids int32 [N, T];
// mask bool [N, T]; scores f32 [N]. fused != 0: one launch of the fused
// kernel, `lanes` (8, 16 or 32) a step, 8*T bytes of shared memory.
// Otherwise the row kernel (`threads` a block) into the workspace best int32
// [N*T], prob f32 [N*T], then the collapse kernel. The rule is
// kernels/ctc_decode.py::decode_plan.
extern "C" int vse_ctc_greedy_decode(const void* logits, int N, int T, int C,
                                     int dtype, int fused, int lanes,
                                     int threads, void* best, void* prob,
                                     void* ids, void* mask, void* scores,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return decode_typed((const float*)logits, N, T, C, fused, lanes, threads,
                          best, prob, ids, mask, scores, s);
    case 1:
      return decode_typed((const __half*)logits, N, T, C, fused, lanes,
                          threads, best, prob, ids, mask, scores, s);
    case 2:
      return decode_typed((const __nv_bfloat16*)logits, N, T, C, fused, lanes,
                          threads, best, prob, ids, mask, scores, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
