// K2: per-frame text-presence statistics of a subtitle band, for sm_90a.
//
// Replaces the Pallas kernel vse_tpu/kernels/keyframe.py::_keyframe_kernel
// (pallas_call in frame_stats_pallas). It takes the band in either of the
// two forms the reference feeds that kernel:
// - uint8 RGB [T, H, W, 3] (vse_keyframe_stats), the scan's form, with the
//   gray conversion and zero padding that _scan_stats_u8_jit fuses around
//   the kernel done here in registers;
// - f32 gray [T, H, W] (vse_keyframe_stats_gray), the kernel's own input
//   form, which the sync re-timer's make_keyframes feeds through
//   frame_stats (decimated 720p frames, [<= 33, 184, 384] padded); the
//   gray is loaded as it is.
// For either it writes f32 [T, 4]:
//   0 edge_energy   mean |g[x] - g[x-1]| with column 0 zeroed
//   1 text_cells    fraction of 4 x 8 cells whose edge density
//                   (gx > edge_thr) exceeds moderate_thr
//   2 temporal_diff mean |g - prev|; prev is the previous frame OF THE BATCH
//                   and frame 0 is its own prev (so the first diff of every
//                   batch is 0, as in the reference)
//   3 mean_lum      mean g
// where g is the f32 gray given, or for u8 RGB the gray of the reference's
// jitted scan,
//   g = fma(b', 0.114, fma(r', 0.299, g' * 0.587)),  x' = u8 * f32(1/255),
// each product and sum rounded once to f32 (XLA contracts the source's
// (r'*.299 + g'*.587) + b'*.114 into these two FMAs), and every mean runs
// over the band zero-padded to [Hp, Wp] (H to a multiple of 8, W to 128).
// When W < Wp the zero pad puts an edge at x = W; stats 0 and 1 count it,
// as the reference does.
//
// What bounds it on the H100: bytes. The band is read once (3*T*H*W bytes,
// 4*T*H*W for gray) and 16 bytes per frame are written: the main path's
// [32, 104, 1280, 3] batch needs 3.8 us at 3.35 TB/s, the sync path's
// [33, 184, 384] gray 2.8 us. The arithmetic is ~15 operations a pixel.
//
// Design (launch geometry in kernels/keyframe.py::launch_geometry):
// - Gray from one 256-entry f32 table in shared memory (scan_lut() in
//   kernels/keyframe.py: x' = u8 * f32(1/255) for every byte), then
//   __fmul_rn(g', .587f) and two __fmaf_rn: the jitted reference's gray bit
//   for bit, with no contraction left to the compiler, at 3 lookups, a
//   multiply and 2 FMAs a pixel. A one-ulp change in gray could flip
//   gx > 0.08 and move text_cells by a whole cell.
// - A strip is one cell row (4 rows) by 16 pixels, two whole cells. Four
//   consecutive lanes own its four rows, one each, so a warp covers 8
//   strips: 4 rows x 384 contiguous bytes, read as 16-byte loads when rows
//   start 16-byte aligned (W % 16 == 0 and an aligned band), otherwise by
//   bytes. A gray strip is 64 bytes: four 16-byte loads when W % 4 == 0 and
//   the tensor is 16-byte aligned (each 4-pixel quad is then wholly inside
//   the row or wholly pad), otherwise by floats. The cells' edge counts add up over the four lanes
//   (__shfl_xor_sync); the left neighbour of a strip's row comes from four
//   lanes before (__shfl_up_sync), and lanes 0-3 read their pixel. A
//   thread holds 16 pixels of gray and 16 of the previous frame's, which
//   keeps it near 64 registers and the SM full of warps.
// - A block takes `run` consecutive frames of a range of strips and keeps
//   the previous frame's gray of its rows in registers, so each pixel's
//   gray is computed once (plus once for the frame before the run).
// - Cross-block reduction without atomics on the data: each block writes
//   f64 partial sums per frame to partials[T][n_parts][4]; a ticket per
//   frame run elects the run's last block, which sums the parts in a fixed
//   order (the result is the same from run to run: warp sums are f32 over
//   512 pixels, everything above them f64), writes the frame stats and
//   resets its ticket to 0 for the next launch (no memset launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG_H = 4;     // cell rows: one strip's rows
constexpr int SEG_W = 8;     // cell width: a strip holds two cells
constexpr int STRIP = 16;    // pixels of a strip's row: a thread's
constexpr int RUN_MAX = 8;   // frames a block walks (kernels/keyframe.py)
constexpr int MAX_WARPS = 8; // threads per block <= 256
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float gray_px(const float* lut, unsigned r,
                                         unsigned g, unsigned b) {
  return __fmaf_rn(lut[b], 0.114f,
                   __fmaf_rn(lut[r], 0.299f, __fmul_rn(lut[g], 0.587f)));
}

// Gray of pixel x of a row (x < W).
template <bool GRAY>
__device__ __forceinline__ float pixel_gray(const uint8_t* __restrict__ row,
                                            int x, const float* lut) {
  if constexpr (GRAY) {
    return __ldg(reinterpret_cast<const float*>(row) + x);
  } else {
    const uint8_t* q = row + (size_t)x * 3;
    return gray_px(lut, __ldg(q), __ldg(q + 1), __ldg(q + 2));
  }
}

// Gray of one row of a strip (16 pixels); 0 for x >= W or an invalid row.
template <bool GRAY, bool VEC>
__device__ __forceinline__ void strip_gray(const uint8_t* __restrict__ row,
                                           bool row_ok, int x0, int W,
                                           const float* lut, float (&g)[STRIP]) {
  if constexpr (GRAY && VEC) {
    // W % 4 == 0: each quad of the strip is wholly inside the row or pad
    const float4* p = reinterpret_cast<const float4*>(row) + x0 / 4;
#pragma unroll
    for (int k = 0; k < STRIP / 4; ++k) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row_ok && x0 + 4 * k < W) v = __ldg(p + k);
      g[4 * k] = v.x;
      g[4 * k + 1] = v.y;
      g[4 * k + 2] = v.z;
      g[4 * k + 3] = v.w;
    }
  } else if constexpr (VEC) {
    // W % 16 == 0: a strip is either wholly inside the row or wholly pad
    uint32_t w[12];
    if (row_ok && x0 < W) {
      const uint4* p = reinterpret_cast<const uint4*>(row + (size_t)x0 * 3);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint4 v = __ldg(p + k);
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < STRIP; ++i) {
        const int k = 3 * i;
        const unsigned r = (w[k >> 2] >> ((k & 3) * 8)) & 0xffu;
        const unsigned gg = (w[(k + 1) >> 2] >> (((k + 1) & 3) * 8)) & 0xffu;
        const unsigned b = (w[(k + 2) >> 2] >> (((k + 2) & 3) * 8)) & 0xffu;
        g[i] = gray_px(lut, r, gg, b);
      }
    } else {
#pragma unroll
      for (int i = 0; i < STRIP; ++i) g[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < STRIP; ++i) {
      const int x = x0 + i;
      g[i] = 0.f;
      if (row_ok && x < W) g[i] = pixel_gray<GRAY>(row, x, lut);
    }
  }
}

// GRAY: frames are f32 gray [T, H, W] (lut unused), else u8 RGB [T, H, W, 3].
template <bool GRAY, bool VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
keyframe_stats_kernel(const uint8_t* __restrict__ frames,
                      const float* __restrict__ lut_g, int T, int H, int W,
                      int Hp, int Wp, int n_strips, int n_items, int run,
                      float edge_thr, float moderate_thr,
                      double* __restrict__ partials, int* __restrict__ tickets,
                      float* __restrict__ out) {
  __shared__ float lut[256];
  __shared__ double red[RUN_MAX][MAX_WARPS][4];
  __shared__ int is_last;

  if constexpr (!GRAY) {
    for (int k = threadIdx.x; k < 256; k += blockDim.x) lut[k] = lut_g[k];
    __syncthreads();
  }

  // four consecutive lanes own the four rows of one strip
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int part = blockIdx.x;
  const int n_parts = gridDim.x;
  const int item = part * (blockDim.x / SEG_H) + threadIdx.x / SEG_H;
  const int dy = threadIdx.x % SEG_H;
  const bool active = item < n_items;
  const int band = active ? item / n_strips : 0;
  const int strip = active ? item - band * n_strips : 0;
  const int y = band * SEG_H + dy;
  const bool row_ok = active && y < H;
  const int x0 = strip * STRIP;
  const size_t row_bytes = (size_t)W * (GRAY ? 4 : 3);
  const size_t frame_bytes = (size_t)H * row_bytes;
  const uint8_t* row0 = frames + (size_t)y * row_bytes;
  const int t0 = blockIdx.y * run;
  const int t1 = min(T, t0 + run);
  const float cell_px = (float)(SEG_H * SEG_W);

  // gray of the frame before the run (frame 0 is its own prev)
  float prevg[STRIP];
  strip_gray<GRAY, VEC>(row0 + (size_t)(t0 > 0 ? t0 - 1 : 0) * frame_bytes,
                        row_ok, x0, W, lut, prevg);

  for (int t = t0; t < t1; ++t) {
    const uint8_t* row = row0 + (size_t)t * frame_bytes;
    float g[STRIP];
    strip_gray<GRAY, VEC>(row, row_ok, x0, W, lut, g);
    // left neighbour: the previous strip's last pixel of the same row, from
    // four lanes before (every lane runs the shuffle); lanes 0-3 read it
    // themselves. Column 0 has no gradient: there the left neighbour is
    // the pixel itself.
    float left = __shfl_up_sync(FULL, g[STRIP - 1], SEG_H);
    if (x0 == 0) {
      left = g[0];
    } else if (lane < SEG_H) {
      left = 0.f;
      if (row_ok) left = pixel_gray<GRAY>(row, x0 - 1, lut);
    }
    float s_gx = 0.f, s_g = 0.f, s_diff = 0.f;
    int e0 = 0, e1 = 0;  // edges of this row of the strip's two cells
#pragma unroll
    for (int i = 0; i < STRIP; ++i) {
      const float gx = fabsf(__fsub_rn(g[i], i == 0 ? left : g[i - 1]));
      s_gx += gx;
      s_g += g[i];
      s_diff += fabsf(__fsub_rn(g[i], prevg[i]));
      const int e = gx > edge_thr ? 1 : 0;
      if (i < SEG_W) e0 += e; else e1 += e;
      prevg[i] = g[i];
    }
    // the cells' edges over their four rows (lanes 4s .. 4s+3)
    e0 += __shfl_xor_sync(FULL, e0, 1);
    e1 += __shfl_xor_sync(FULL, e1, 1);
    e0 += __shfl_xor_sync(FULL, e0, 2);
    e1 += __shfl_xor_sync(FULL, e1, 2);
    int n_text = 0;
    if (active && dy == 0) {
      n_text = (__fdiv_rn((float)e0, cell_px) > moderate_thr ? 1 : 0) +
               (__fdiv_rn((float)e1, cell_px) > moderate_thr ? 1 : 0);
    }
    // fixed-order warp sums (f32 over the warp's 512 pixels)
    float v[4] = {s_gx, (float)n_text, s_diff, s_g};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v[k] += __shfl_down_sync(FULL, v[k], d);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red[t - t0][warp][k] = (double)v[k];
    }
  }
  __syncthreads();

  // this block's part of each frame of the run, warps summed in order
  const int n_run = t1 - t0;
  if (threadIdx.x < n_run * 4) {
    const int f = threadIdx.x >> 2, k = threadIdx.x & 3;
    double s = 0.0;
    for (int w = 0; w < n_warps; ++w) s += red[f][w][k];
    partials[((size_t)(t0 + f) * n_parts + part) * 4 + k] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(&tickets[blockIdx.y], 1) == n_parts - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // the run's last block: every part is written. A warp per (frame, stat)
  // loads the parts in parallel and sums them in a fixed order.
  __threadfence();
  for (int pair = warp; pair < n_run * 4; pair += n_warps) {
    const int t = t0 + (pair >> 2), k = pair & 3;
    double s = 0.0;
    for (int q = lane; q < n_parts; q += 32)
      s += __ldcg(&partials[((size_t)t * n_parts + q) * 4 + k]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(FULL, s, d);
    if (lane == 0) {
      float r;
      if (k == 1) {
        // count * f32(1 / n_cells), exactly as the reference's mean
        const float n_cells = (float)((Hp / SEG_H) * (Wp / SEG_W));
        r = __fmul_rn((float)s, __fdiv_rn(1.0f, n_cells));
      } else {
        r = (float)(s / ((double)Hp * (double)Wp));
      }
      out[(size_t)t * 4 + k] = r;
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

}  // namespace

namespace {

template <bool GRAY>
void launch(const void* frames, const void* lut, int T, int H, int W, int Hp,
            int Wp, int n_strips, int n_items, int threads, int n_parts,
            int run, int n_runs, int vec, float edge_thr, float moderate_thr,
            void* partials, void* tickets, void* out, void* stream) {
  if (T <= 0 || n_items <= 0) return;
  const dim3 grid(n_parts, n_runs);
  cudaStream_t s = (cudaStream_t)stream;
  auto k = vec ? keyframe_stats_kernel<GRAY, true>
               : keyframe_stats_kernel<GRAY, false>;
  k<<<grid, threads, 0, s>>>((const uint8_t*)frames, (const float*)lut, T, H,
                             W, Hp, Wp, n_strips, n_items, run, edge_thr,
                             moderate_thr, (double*)partials, (int*)tickets,
                             (float*)out);
}

}  // namespace

// frames: u8 [T, H, W, 3]; lut: f32 [256] (scan_lut); partials: f64
// [T, n_parts, 4]; tickets: int32 [n_runs], zero on entry and on return;
// out: f32 [T, 4]. Grid (n_parts, n_runs) of `threads` threads; vec selects
// 16-byte loads (W % 16 == 0 and a 16-byte aligned band).
extern "C" int vse_keyframe_stats(const void* frames, const void* lut, int T,
                                  int H, int W, int Hp, int Wp, int n_strips,
                                  int n_items, int threads, int n_parts,
                                  int run, int n_runs, int vec, float edge_thr,
                                  float moderate_thr, void* partials,
                                  void* tickets, void* out, void* stream) {
  launch<false>(frames, lut, T, H, W, Hp, Wp, n_strips, n_items, threads,
                n_parts, run, n_runs, vec, edge_thr, moderate_thr, partials,
                tickets, out, stream);
  return (int)cudaGetLastError();
}

// The same for f32 gray frames [T, H, W] (no table); vec selects 16-byte
// loads (W % 4 == 0 and a 16-byte aligned tensor).
extern "C" int vse_keyframe_stats_gray(const void* frames, int T, int H,
                                       int W, int Hp, int Wp, int n_strips,
                                       int n_items, int threads, int n_parts,
                                       int run, int n_runs, int vec,
                                       float edge_thr, float moderate_thr,
                                       void* partials, void* tickets,
                                       void* out, void* stream) {
  launch<true>(frames, nullptr, T, H, W, Hp, Wp, n_strips, n_items, threads,
               n_parts, run, n_runs, vec, edge_thr, moderate_thr, partials,
               tickets, out, stream);
  return (int)cudaGetLastError();
}
