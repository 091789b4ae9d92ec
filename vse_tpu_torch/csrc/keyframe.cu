// K2: per-frame text-presence statistics of a uint8 subtitle band, for sm_90a.
//
// Replaces the Pallas kernel vse_tpu/kernels/keyframe.py::_keyframe_kernel
// (pallas_call in frame_stats_pallas), together with the gray conversion and
// zero padding that _scan_stats_u8_jit fuses around it. For a contiguous
// uint8 band [T, H, W, 3] it writes f32 [T, 4]:
//   0 edge_energy   mean |g[x] - g[x-1]| with column 0 zeroed
//   1 text_cells    fraction of seg_h x seg_w cells whose edge density
//                   (gx > edge_thr) exceeds moderate_thr
//   2 temporal_diff mean |g - prev|; prev is the previous frame OF THE BATCH
//                   and frame 0 is its own prev (so the first diff of every
//                   batch is 0, as in the reference)
//   3 mean_lum      mean g
// where g = (0.299 R + 0.587 G + 0.114 B) / 255 and every mean runs over the
// band zero-padded to [Hp, Wp] (H to a multiple of 8, W to 128). The zero pad
// puts an edge at the real right border; stats 0 and 1 count it, as the
// reference does.
//
// What bounds it on the H100: bytes. The band is read once (3*T*H*W bytes;
// the previous frame's re-read hits L2) and 16 bytes per frame are written:
// the main path's [32, 104, 1280, 3] batch needs ~3.8 us at 3.35 TB/s. The
// arithmetic is a few dozen flops per pixel.
//
// Design: one block per frame. Threads walk the frame's seg_h x seg_w cells;
// a thread reads its cell's pixels straight from the u8 band, converts them to
// gray in registers (the pad is a branch, never a float band in device
// memory), counts the cell's edges and accumulates the sums in f64. The block
// then reduces the sums and the text-cell count through warp shuffles and
// shared memory. Gray is computed in the reference's order of operations
// with round-to-nearest intrinsics (__fdiv_rn, __fmul_rn, __fadd_rn,
// __fsub_rn): nvcc would otherwise contract a*b+c into an FMA, and a
// one-ulp change in gray can flip gx > 0.08 and move text_cells by a whole
// cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float gray_of(const uint8_t* p) {
  const float r = __fdiv_rn((float)p[0], 255.0f);
  const float g = __fdiv_rn((float)p[1], 255.0f);
  const float b = __fdiv_rn((float)p[2], 255.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(r, 0.299f), __fmul_rn(g, 0.587f)),
                   __fmul_rn(b, 0.114f));
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__global__ void keyframe_stats_kernel(const uint8_t* __restrict__ frames,
                                      int H, int W, int Hp, int Wp, int seg_h,
                                      int seg_w, float edge_thr,
                                      float moderate_thr,
                                      float* __restrict__ out) {
  const int t = blockIdx.x;
  const size_t frame_px = (size_t)H * W;
  const uint8_t* cur = frames + (size_t)t * frame_px * 3;
  const uint8_t* prev = frames + (size_t)(t > 0 ? t - 1 : t) * frame_px * 3;
  const int cells_y = Hp / seg_h;
  const int cells_x = Wp / seg_w;
  const int n_cells = cells_y * cells_x;
  const float cell_px = (float)(seg_h * seg_w);

  double s_gx = 0.0, s_g = 0.0, s_diff = 0.0;
  int n_text = 0;
  for (int cell = threadIdx.x; cell < n_cells; cell += blockDim.x) {
    const int cy = cell / cells_x;
    const int cx = cell - cy * cells_x;
    const int x0 = cx * seg_w;
    int edges = 0;
    for (int dy = 0; dy < seg_h; ++dy) {
      const int y = cy * seg_h + dy;
      if (y >= H) break;  // padded rows: g = 0, so no gradient or edge
      const uint8_t* crow = cur + (size_t)y * W * 3;
      const uint8_t* prow = prev + (size_t)y * W * 3;
      float left = (x0 > 0 && x0 - 1 < W) ? gray_of(crow + (x0 - 1) * 3) : 0.f;
      for (int dx = 0; dx < seg_w; ++dx) {
        const int x = x0 + dx;
        float g = 0.f, gp = 0.f;
        if (x < W) {
          g = gray_of(crow + x * 3);
          gp = gray_of(prow + x * 3);
        }
        const float gx = x == 0 ? 0.f : fabsf(__fsub_rn(g, left));
        s_gx += gx;
        s_g += g;
        s_diff += fabsf(__fsub_rn(g, gp));
        edges += gx > edge_thr ? 1 : 0;
        left = g;
      }
    }
    n_text += __fdiv_rn((float)edges, cell_px) > moderate_thr ? 1 : 0;
  }

  __shared__ double sh_gx[32], sh_g[32], sh_diff[32];
  __shared__ int sh_text[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  s_gx = warp_sum(s_gx);
  s_g = warp_sum(s_g);
  s_diff = warp_sum(s_diff);
  n_text = warp_sum_int(n_text);
  if (lane == 0) {
    sh_gx[warp] = s_gx;
    sh_g[warp] = s_g;
    sh_diff[warp] = s_diff;
    sh_text[warp] = n_text;
  }
  __syncthreads();
  if (warp == 0) {
    s_gx = lane < n_warps ? sh_gx[lane] : 0.0;
    s_g = lane < n_warps ? sh_g[lane] : 0.0;
    s_diff = lane < n_warps ? sh_diff[lane] : 0.0;
    n_text = lane < n_warps ? sh_text[lane] : 0;
    s_gx = warp_sum(s_gx);
    s_g = warp_sum(s_g);
    s_diff = warp_sum(s_diff);
    n_text = warp_sum_int(n_text);
    if (lane == 0) {
      const double area = (double)Hp * (double)Wp;
      float* o = out + (size_t)t * 4;
      o[0] = (float)(s_gx / area);
      // count * f32(1 / n_cells), exactly as the reference's mean
      o[1] = __fmul_rn((float)n_text, __fdiv_rn(1.0f, (float)n_cells));
      o[2] = (float)(s_diff / area);
      o[3] = (float)(s_g / area);
    }
  }
}

}  // namespace

extern "C" int vse_keyframe_stats(const void* frames, int T, int H, int W,
                                  int Hp, int Wp, int seg_h, int seg_w,
                                  float edge_thr, float moderate_thr,
                                  int threads, void* out, void* stream) {
  if (T > 0) {
    keyframe_stats_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frames, H, W, Hp, Wp, seg_h, seg_w, edge_thr,
        moderate_thr, (float*)out);
  }
  return (int)cudaGetLastError();
}
