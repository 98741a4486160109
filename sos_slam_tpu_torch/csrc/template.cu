// K2: one tracker-template level — dilation of the scattered idepth and
// weight maps, normalisation and the good-pixel mask (the per-level tail
// of the reference's makeCoarseDepthL0, CoarseTracker.cpp:100-230).
//
// Replaces the TPU kernel sos_slam_tpu/ops/pallas_kernels.py
// template_level (_template_level_kernel), which held the five full maps
// as single VMEM blocks. Here it is a stencil: one thread per pixel reads
// its 4 neighbours (diagonal on levels 0-1, cross on coarser levels) of
// two maps, zero outside the map, and writes idn and good.
//
// Bound on the card: bytes. Level 0 at 640x480 reads 3 x 1.2 MB and writes
// 1.2 MB + 0.3 MB, ~1.5 us at 3.35 TB/s; ~40 flops per pixel. Neighbour
// reuse is served by L1; coalesced row-major access is the whole design.
//
// Summation order of the neighbours follows the JAX package's roll form
// (roll by (dy, dx) reads (y - dy, x - dx)), so in-border pixels round
// exactly like its CPU path; only the masked 2-px border differs from a
// wrap-around roll.
#include <cuda_runtime.h>

__global__ void template_level_kernel(const float* __restrict__ idm,
                                      const float* __restrict__ wm,
                                      const float* __restrict__ color, int h,
                                      int w, int diag, float* __restrict__ idn,
                                      bool* __restrict__ good) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int DIAG[4][2] = {{1, 1}, {-1, -1}, {1, -1}, {-1, 1}};
  const int CROSS[4][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}};
  float s = 0.f, c = 0.f, n = 0.f;
  for (int r = 0; r < 4; ++r) {
    const int dy = diag ? DIAG[r][0] : CROSS[r][0];
    const int dx = diag ? DIAG[r][1] : CROSS[r][1];
    const int yy = y - dy, xx = x - dx;
    float wn = 0.f, in = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      wn = wm[yy * w + xx];
      in = idm[yy * w + xx];
    }
    if (wn > 0.f) {
      s = s + in;
      c = c + wn;
      n = n + 1.f;
    }
  }
  const int i = y * w + x;
  float id = idm[i], wt = wm[i];
  if (wt <= 0.f && n > 0.f) {
    id = s / n;
    wt = c / n;
  }
  const float out = wt > 0.f ? id / fmaxf(wt, 1e-12f) : -1.f;
  idn[i] = out;
  const bool border = (x >= 2) && (x < w - 2) && (y >= 2) && (y < h - 2);
  good[i] = border && (out > 0.f) && isfinite(color[i]);
}

extern "C" int launch_template_level(const float* idm, const float* wm,
                                     const float* color, int h, int w,
                                     int diag, float* idn, bool* good,
                                     void* stream) {
  dim3 block(32, 8);
  dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  template_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      idm, wm, color, h, w, diag, idn, good);
  return (int)cudaGetLastError();
}
