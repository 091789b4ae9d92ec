// K1: the greedy-CTC reduction over the class axis, for sm_90a.
//
// Replaces the Pallas kernel vse_tpu/kernels/ctc_decode.py::_argmax_lse_kernel
// (pallas_call in ctc_greedy_decode_pallas). For f32 logits [rows, C], one
// row per (sequence, time step), it writes
//   best[r] = argmax_c logits[r, c]   (the FIRST max on ties, as jnp.argmax)
//   prob[r] = exp(max - logsumexp)    (softmax probability of the best class)
// The collapse / left-pack / mean-score steps stay PyTorch ops in the wrapper
// (vse_tpu_torch/kernels/ctc_decode.py): they touch [rows] values only.
//
// What bounds it on the H100: bytes. Every logit is read once (4*rows*C
// bytes) and 8 bytes per row are written; at 3.35 TB/s the main path's
// [64*80, 69] call needs ~0.4 us and the 21,249-class heads ~130 us. The
// arithmetic (one expf per logit) is far below the card's rate.
//
// Design: one block per row. Each thread runs an online (max, argmax,
// sum-exp) over a strided slice of C, accumulating in f32, so the logits are
// read once with neighbouring threads on neighbouring addresses. The
// per-thread states merge by warp shuffles, then across warps in shared
// memory. A merge keeps the lower index when the two maxima are equal, which
// together with the in-order thread scan reproduces "first max". The block
// width scales with C (one warp for small heads, eight for the CJK heads).
// expf/logf (not __expf) keep the result within 1e-5 of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct ArgState {
  float m;  // running max
  float s;  // sum of exp(x - m); 0 marks an empty state
  int i;    // index of the first max
};

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

__device__ __forceinline__ ArgState shfl_down(ArgState v, int delta) {
  ArgState o;
  o.m = __shfl_down_sync(0xffffffffu, v.m, delta);
  o.s = __shfl_down_sync(0xffffffffu, v.s, delta);
  o.i = __shfl_down_sync(0xffffffffu, v.i, delta);
  return o;
}

__global__ void argmax_lse_kernel(const float* __restrict__ logits, int C,
                                  int* __restrict__ best,
                                  float* __restrict__ prob) {
  const int row = blockIdx.x;
  const float* x = logits + (size_t)row * C;
  ArgState st = {-INFINITY, 0.f, 0x7fffffff};
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = x[c];
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
  for (int d = 16; d > 0; d >>= 1) st = merge(st, shfl_down(st, d));

  __shared__ ArgState warp_states[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (n_warps > 1) {
    if (lane == 0) warp_states[warp] = st;
    __syncthreads();
    if (warp == 0) {
      st = lane < n_warps ? warp_states[lane] : ArgState{-INFINITY, 0.f, 0x7fffffff};
      for (int d = 16; d > 0; d >>= 1) st = merge(st, shfl_down(st, d));
    }
  }
  if (threadIdx.x == 0) {
    const float lse = st.m + logf(st.s);
    best[row] = st.i;
    prob[row] = expf(st.m - lse);
  }
}

}  // namespace

extern "C" int vse_ctc_argmax_lse(const void* logits, int rows, int C,
                                  int threads, void* best, void* prob,
                                  void* stream) {
  if (rows > 0) {
    argmax_lse_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
        (const float*)logits, C, (int*)best, (float*)prob);
  }
  return (int)cudaGetLastError();
}
