// K2: the tracker template's maps of one keyframe in one launch — for
// every pyramid level the dilation of the scattered idepth and weight
// maps, the normalisation and the good-pixel mask (the per-level tail of
// the reference's makeCoarseDepthL0, CoarseTracker.cpp:100-230).
//
// Replaces the TPU kernel sos_slam_tpu/ops/pallas_kernels.py
// template_level (_template_level_kernel), which is called once per level
// and held the level's five full maps as single VMEM blocks.
//
// Bound on the card: bytes. Four levels of 640x480 read 3 x 1.6 MB and
// write 1.6 MB + 0.4 MB, ~2 us at 3.35 TB/s; ~40 flops per pixel. The
// levels do not depend on each other, so four launches (and four copies
// that made the colour plane contiguous) only paid four launch latencies.
// What the design does about it:
//   * one grid over the tiles of all levels: a table passed by value gives
//     each level's pointers, size, neighbourhood and first block, and a
//     block finds its level from blockIdx;
//   * 16-byte accesses: a thread takes four neighbouring pixels of a row,
//     reads the centre row and the rows above and below as float4 (the
//     block is a 128 x 8 tile, so L1 serves the rows its threads share),
//     and writes idn as one float4 and good as four bytes at once. A level
//     whose width is no multiple of 4 takes the same path with scalar
//     accesses;
//   * the colour plane is read where it lies, at its pixel stride (3 in an
//     interleaved [I, dx, dy] level), in the same trip to memory as the
//     maps.
//
// Summation order of the neighbours follows the JAX package's roll form
// (roll by (dy, dx) reads (y - dy, x - dx)) and the s / n, c / n,
// id / max(w, 1e-12) chain is that of the one-level form, so every pixel is
// bit for bit what one launch per level gave; in-border pixels round
// exactly like the JAX package's CPU path, and only the masked 2-px border
// differs from a wrap-around roll.
#include <cuda_runtime.h>
#include <stdint.h>

#define K2_MAX_LEVELS 6
#define K2_BX 32      // threads across a block: a tile is 4 * K2_BX pixels wide
#define K2_BY 8

struct TemplateTable {
  const float* idm[K2_MAX_LEVELS];
  const float* wm[K2_MAX_LEVELS];
  const float* color[K2_MAX_LEVELS];
  float* idn[K2_MAX_LEVELS];
  bool* good[K2_MAX_LEVELS];
  int h[K2_MAX_LEVELS];
  int w[K2_MAX_LEVELS];
  int diag[K2_MAX_LEVELS];          // diagonal (1) or cross (0) neighbours
  int color_stride[K2_MAX_LEVELS];  // floats between two pixels of color
  int first_block[K2_MAX_LEVELS];   // set by the launcher
};

// Columns x-1 .. x+4 of row y of a map, zero outside it; the two end
// columns only where `ends` asks for them.
__device__ __forceinline__ void load_row(const float* __restrict__ map, int y,
                                         int x, int h, int w, bool vec,
                                         bool ends, float o[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) o[k] = 0.f;
  if (y < 0 || y >= h) return;
  const float* r = map + ((size_t)y * w + x);
  if (vec) {
    const float4 v = *(const float4*)r;
    o[1] = v.x; o[2] = v.y; o[3] = v.z; o[4] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < w) o[1 + j] = r[j];
  }
  if (ends) {
    if (x > 0) o[0] = r[-1];
    if (x + 4 < w) o[5] = r[4];
  }
}

__device__ __forceinline__ void take(float wn, float in, float& s, float& c,
                                     float& n) {
  if (wn > 0.f) {
    s = s + in;
    c = c + wn;
    n = n + 1.f;
  }
}

__global__ void __launch_bounds__(K2_BX * K2_BY)
template_kernel(TemplateTable t, int n_levels) {
  int l = 0;
#pragma unroll
  for (int i = 1; i < K2_MAX_LEVELS; ++i)
    if (i < n_levels && (int)blockIdx.x >= t.first_block[i]) l = i;
  const float* __restrict__ idm = t.idm[l];
  const float* __restrict__ wm = t.wm[l];
  const float* __restrict__ color = t.color[l];
  float* __restrict__ idn = t.idn[l];
  bool* __restrict__ good = t.good[l];
  const int h = t.h[l], w = t.w[l], diag = t.diag[l];
  const int cs = t.color_stride[l], first = t.first_block[l];
  const int tiles_x = (w + 4 * K2_BX - 1) / (4 * K2_BX);
  const int b = (int)blockIdx.x - first;
  const int x = ((b % tiles_x) * K2_BX + threadIdx.x) * 4;
  const int y = (b / tiles_x) * K2_BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const bool vec = (w & 3) == 0
      && (((uintptr_t)idm | (uintptr_t)wm | (uintptr_t)idn) & 15) == 0
      && ((uintptr_t)good & 3) == 0;

  // index k of a row holds column x - 1 + k
  float wu[6], wc[6], wd[6], iu[6], ic[6], id_[6];
  load_row(wm, y - 1, x, h, w, vec, diag, wu);
  load_row(wm, y, x, h, w, vec, !diag, wc);
  load_row(wm, y + 1, x, h, w, vec, diag, wd);
  load_row(idm, y - 1, x, h, w, vec, diag, iu);
  load_row(idm, y, x, h, w, vec, !diag, ic);
  load_row(idm, y + 1, x, h, w, vec, diag, id_);

  // the colour with the maps, not after them: a load that waited for
  // `out > 0` would add a second trip to memory to nearly every warp
  const size_t i0 = (size_t)y * w + x;
  float col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    col[j] = x + j < w ? color[(i0 + j) * cs] : 0.f;
  const bool row_in = (y >= 2) && (y < h - 2);
  float out[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = 0.f, c = 0.f, n = 0.f;
    if (diag) {             // (dy, dx) = (1,1), (-1,-1), (1,-1), (-1,1)
      take(wu[j], iu[j], s, c, n);
      take(wd[j + 2], id_[j + 2], s, c, n);
      take(wu[j + 2], iu[j + 2], s, c, n);
      take(wd[j], id_[j], s, c, n);
    } else {                // (0,1), (0,-1), (1,0), (-1,0)
      take(wc[j], ic[j], s, c, n);
      take(wc[j + 2], ic[j + 2], s, c, n);
      take(wu[j + 1], iu[j + 1], s, c, n);
      take(wd[j + 1], id_[j + 1], s, c, n);
    }
    float id = ic[j + 1], wt = wc[j + 1];
    if (wt <= 0.f && n > 0.f) {
      id = s / n;
      wt = c / n;
    }
    out[j] = -1.f;
    if (wt > 0.f) out[j] = id / fmaxf(wt, 1e-12f);
    const int xj = x + j;
    ok[j] = row_in && (xj >= 2) && (xj < w - 2) && (out[j] > 0.f)
        && isfinite(col[j]);
  }
  if (vec) {
    *(float4*)(idn + i0) = make_float4(out[0], out[1], out[2], out[3]);
    *(uchar4*)(good + i0) = make_uchar4(ok[0], ok[1], ok[2], ok[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < w) {
        idn[i0 + j] = out[j];
        good[i0 + j] = ok[j];
      }
  }
}

// n_levels levels in one launch: level l reads the (h, w) maps idm, wm and
// the colour plane (pixel stride color_stride floats) and writes idn
// (h, w) f32 and good (h, w) bool. The table's first_block is filled here.
extern "C" int launch_template_levels(TemplateTable t, int n_levels,
                                      void* stream) {
  if (n_levels < 1 || n_levels > K2_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (t.h[l] < 1 || t.w[l] < 1 || t.color_stride[l] < 1)
      return (int)cudaErrorInvalidValue;
    t.first_block[l] = blocks;
    blocks += ((t.w[l] + 4 * K2_BX - 1) / (4 * K2_BX))
        * ((t.h[l] + K2_BY - 1) / K2_BY);
  }
  template_kernel<<<blocks, dim3(K2_BX, K2_BY), 0, (cudaStream_t)stream>>>(
      t, n_levels);
  return (int)cudaGetLastError();
}
