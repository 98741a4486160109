// K1: the image pyramid of one frame in one launch — for each of up to
// four levels the interleaved [I, dx, dy] map and |grad|^2, and on request
// the 2x2 box mean of the last level (the input of a further launch).
//
// Replaces the TPU kernel sos_slam_tpu/ops/pallas_kernels.py
// fused_pyramid_level (_pyramid_level_kernel), which is called once per
// level: there a whole level sat in VMEM, the downsample rode the MXU as
// two averaging matmuls, and level l+1 waited in device memory for level l.
//
// Bound on the card: bytes. Four levels of 640x480 read 1.2 MB and write
// 4.9 MB of [I, dx, dy] and 1.6 MB of |grad|^2: 7.76 MB, 2.3 us at 3.35 TB/s, a
// few flops per pixel. At that size a launch costs as much as the work,
// and a chain of four launches, the last two of them on 19200 and 4800
// pixels, is mostly launch latency. What the design does about it:
//   * one launch: a block owns a K1_TW x K1_TH tile of level 0 (32 x 16:
//     600 blocks of 128 threads at 640x480, four or five on each of the
//     132 SMs, so that one block's waits hide behind another's work). It
//     loads the tile once with a halo of 2^(n_levels-1) level-0 pixels
//     (one pixel of the coarsest level, which is what its gradient needs)
//     and forms the coarser levels of tile and halo in shared memory by
//     the 2x2 mean. A coarse pixel in a halo is computed by two blocks from the
//     same inputs by the same expressions, so it is the same float in
//     both: no block waits for another and nothing crosses device memory
//     between levels. Pixels outside the image are zero in shared memory
//     and reach no output (border gradients are zero by definition, and a
//     coarse pixel inside the image averages only pixels inside it);
//   * a short chain: what a block costs is its longest chain of waits, not
//     its arithmetic. A thread issues all its loads before its first
//     store; all coarser planes form between one pair of barriers (see
//     coarse_planes); then the gradients of every level are one list of
//     work, and the stores of every level another: three barriers and one
//     trip to device memory each way, whatever the number of levels;
//   * 16-byte accesses: the tile is loaded as float4, a thread takes four
//     neighbouring pixels of a row, writes their |grad|^2 as one float4 and
//     their twelve [I, dx, dy] floats into a shared-memory copy of the
//     interleaved tile row, which goes out as float4 with neighbouring
//     threads on neighbouring addresses. A level whose width is no multiple
//     of 4 (rows off 16 bytes) takes the same path with 4-byte accesses;
//   * no next level is written unless the caller asks for it.
// The expressions and their order are those of the one-level form
// (0.5f * (a - b), dx*dx + dy*dy, ((a + b) + (c + d)) * 0.25f), and the
// build keeps -fmad=false, so n levels in one launch equal n one-level
// launches chained through `down` bit for bit.
//
// Semantics (reference makeImages, HessianBlocks.cpp:121-176):
//   dx = 0.5 (I[x+1] - I[x-1]) on interior columns AND interior rows only,
//   dy = 0.5 (I[y+1] - I[y-1]) on interior rows, zero elsewhere;
//   next[y][x] = mean of the 2x2 block at (2y, 2x).
#include <cuda_runtime.h>
#include <stdint.h>

#define K1_MAX_LEVELS 4
#define K1_TW 32      // a block's tile of level 0, pixels
#define K1_TH 16
#define K1_NT 128     // threads a block
static_assert(K1_TW % 32 == 0 && K1_TH % 16 == 0,
              "the coarsest tile must be whole quads wide and two rows high");

struct PyramidOut {
  float* dI[K1_MAX_LEVELS];
  float* asg[K1_MAX_LEVELS];
};

// Shared memory: one plane per level holding the level's tile with its
// halo, the tile's first pixel at (oy, ox), then one interleaved
// [I, dx, dy] copy of each level's tile. Every pitch and offset is a
// multiple of 4 floats, so quads of the tile are 16-byte aligned.
__host__ __device__ constexpr int tw(int l) { return K1_TW >> l; }
__host__ __device__ constexpr int th(int l) { return K1_TH >> l; }
__host__ __device__ constexpr int ox(int l) { return l == 0 ? 8 : 4; }
__host__ __device__ constexpr int oy(int l) { return 8 >> l; }
__host__ __device__ constexpr int pitch(int l) { return tw(l) + 2 * ox(l); }
__host__ __device__ constexpr int plane_at(int l) {
  return l == 0 ? 0
                : plane_at(l - 1) + pitch(l - 1) * (th(l - 1) + 2 * oy(l - 1));
}
__host__ __device__ constexpr int stage_at(int l) {
  return l == 0 ? plane_at(K1_MAX_LEVELS)
                : stage_at(l - 1) + 3 * tw(l - 1) * th(l - 1);
}
constexpr int SMEM_FLOATS = stage_at(K1_MAX_LEVELS);
static_assert(SMEM_FLOATS * sizeof(float) <= 48 * 1024,
              "the tile must fit the shared memory a launch gets unasked");

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Halo, in pixels of level l, that a tile of an n-level pyramid carries.
__host__ __device__ constexpr int halo(int n, int l) {
  return (1 << (n - 1)) >> l;
}
// Pixels of level l's plane (tile and halo) in an n-level pyramid.
__host__ __device__ constexpr int plane_w(int n, int l) {
  return tw(l) + 2 * halo(n, l);
}
__host__ __device__ constexpr int plane_n(int n, int l) {
  return plane_w(n, l) * (th(l) + 2 * halo(n, l));
}

// Level 0 of the tile at (x0, y0) with its halo, zero outside the image:
// every load of a thread is issued before its first store.
template <int N>
__device__ __forceinline__ void load_tile(float* sm,
                                          const float* __restrict__ img,
                                          int h, int w, int x0, int y0) {
  constexpr int HY = halo(N, 0), HX = HY < 4 ? 4 : HY;   // whole quads
  constexpr int NX4 = (K1_TW + 2 * HX) / 4, NQ = NX4 * (K1_TH + 2 * HY);
  constexpr int ITER = (NQ + K1_NT - 1) / K1_NT;
  const bool vec = (w & 3) == 0 && aligned16(img);
  float4 v[ITER];
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int i = threadIdx.x + k * K1_NT;
    const int gx = x0 + (i % NX4) * 4 - HX, gy = y0 + i / NX4 - HY;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < NQ && gy >= 0 && gy < h) {
      const float* p = img + ((long long)gy * w + gx);
      if (vec) {
        if (gx >= 0 && gx < w) v[k] = *(const float4*)p;
      } else {
        if (gx >= 0 && gx < w) v[k].x = p[0];
        if (gx + 1 >= 0 && gx + 1 < w) v[k].y = p[1];
        if (gx + 2 >= 0 && gx + 2 < w) v[k].z = p[2];
        if (gx + 3 >= 0 && gx + 3 < w) v[k].w = p[3];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ITER; ++k) {
    const int i = threadIdx.x + k * K1_NT;
    if (i < NQ)
      *(float4*)(sm + (i / NX4 - HY + oy(0)) * pitch(0)
                 + (i % NX4) * 4 - HX + ox(0)) = v[k];
  }
}

// The pixel of level L whose first level-0 pixel is *p0, by the 2x2 mean
// level by level: the expression tree of L chained one-level downsamples.
template <int L>
__device__ __forceinline__ float mean_from_level0(const float* p0) {
  if constexpr (L == 0) {
    return *p0;
  } else {
    constexpr int S = 1 << (L - 1);
    const float a = mean_from_level0<L - 1>(p0);
    const float b = mean_from_level0<L - 1>(p0 + S);
    const float c = mean_from_level0<L - 1>(p0 + S * pitch(0));
    const float d = mean_from_level0<L - 1>(p0 + S * pitch(0) + S);
    return ((a + b) + (c + d)) * 0.25f;
  }
}

__device__ __forceinline__ float box4(const float* p, int pitch_) {
  return ((p[0] + p[1]) + (p[pitch_] + p[pitch_ + 1])) * 0.25f;
}

// The planes (tile and halo) of levels 1..N-1 between one pair of
// barriers. The halo halves with the level, so the plane of level l is
// exactly the children of the plane of level l+1: one thread takes a
// pixel of level 2, forms its four level-1 children from level 0, itself
// from them, and the four siblings of a level-3 pixel, in neighbouring
// lanes, hand it their values by shuffle.
template <int N>
__device__ __forceinline__ void coarse_planes(float* sm) {
  if constexpr (N == 2) {
    constexpr int H1 = halo(2, 1), W1 = plane_w(2, 1);
    for (int i = threadIdx.x; i < plane_n(2, 1); i += K1_NT) {
      const int X = i % W1 - H1, Y = i / W1 - H1;
      sm[plane_at(1) + (Y + oy(1)) * pitch(1) + X + ox(1)] =
          box4(sm + (2 * Y + oy(0)) * pitch(0) + 2 * X + ox(0), pitch(0));
    }
  } else if constexpr (N > 2) {
    constexpr int H2 = halo(N, 2), NU = plane_n(N, 2);
    constexpr int W3 = plane_w(N, 2) / 2;
    // every thread takes every turn: the shuffles name whole warps
    for (int first = 0; first < NU; first += K1_NT) {
      const int i = first + threadIdx.x;
      // level-3 pixel counted from the plane's corner, level-2 from the tile's
      const int X3 = (i >> 2) % W3, Y3 = (i >> 2) / W3;
      const int X = 2 * X3 + (i & 1) - H2, Y = 2 * Y3 + ((i >> 1) & 1) - H2;
      float v = 0.f;
      if (i < NU) {
        const float* p0 = sm + (4 * Y + oy(0)) * pitch(0) + 4 * X + ox(0);
        const float a = box4(p0, pitch(0));
        const float b = box4(p0 + 2, pitch(0));
        const float c = box4(p0 + 2 * pitch(0), pitch(0));
        const float d = box4(p0 + 2 * pitch(0) + 2, pitch(0));
        float* q = sm + plane_at(1) + (2 * Y + oy(1)) * pitch(1) + 2 * X
            + ox(1);
        q[0] = a;
        q[1] = b;
        q[pitch(1)] = c;
        q[pitch(1) + 1] = d;
        v = ((a + b) + (c + d)) * 0.25f;
        sm[plane_at(2) + (Y + oy(2)) * pitch(2) + X + ox(2)] = v;
      }
      if constexpr (N > 3) {
        const float b = __shfl_down_sync(0xffffffffu, v, 1);
        const float c = __shfl_down_sync(0xffffffffu, v, 2);
        const float d = __shfl_down_sync(0xffffffffu, v, 3);
        if (i < NU && (i & 3) == 0)
          sm[plane_at(3) + (Y3 - halo(N, 3) + oy(3)) * pitch(3) + X3
             - halo(N, 3) + ox(3)] = ((v + b) + (c + d)) * 0.25f;
      }
    }
  }
}

// What a block knows of one level: its size, the tile's first pixel, its
// outputs and whether their rows take 16-byte stores.
struct Level {
  int h, w, x0, y0;
  float* dI;
  float* asg;
  bool vec;
};

template <int L>
__device__ __forceinline__ Level level_of(const PyramidOut& out, int h0,
                                          int w0) {
  Level lv;
  lv.h = h0 >> L;
  lv.w = w0 >> L;
  lv.x0 = (blockIdx.x * K1_TW) >> L;
  lv.y0 = (blockIdx.y * K1_TH) >> L;
  lv.dI = out.dI[L];
  lv.asg = out.asg[L];
  lv.vec = (lv.w & 3) == 0 && aligned16(lv.dI) && aligned16(lv.asg);
  return lv;
}

// Gradients of quad q (four pixels of a row) of level L's tile: |grad|^2
// to device memory, [I, dx, dy] into the level's interleaved shared copy.
template <int L>
__device__ __forceinline__ void gradient_quad(float* sm, const Level& lv,
                                              int q) {
  constexpr int QW = tw(L) / 4;
  const int qy = q / QW, qx = (q % QW) * 4;
  const int gy = lv.y0 + qy, gx = lv.x0 + qx;
  if (gy >= lv.h || gx >= lv.w) return;
  const float* c = sm + plane_at(L) + (qy + oy(L)) * pitch(L) + qx + ox(L);
  const float4 m = *(const float4*)c;
  const float4 u = *(const float4*)(c - pitch(L));
  const float4 d = *(const float4*)(c + pitch(L));
  const float row[6] = {c[-1], m.x, m.y, m.z, m.w, c[4]};
  const float up[4] = {u.x, u.y, u.z, u.w};
  const float dn[4] = {d.x, d.y, d.z, d.w};
  const bool row_in = (gy > 0) && (gy < lv.h - 1);
  float o[12], a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = gx + j;
    float dx = 0.f, dy = 0.f;
    if (row_in && x > 0 && x < lv.w - 1) dx = 0.5f * (row[j + 2] - row[j]);
    if (row_in) dy = 0.5f * (dn[j] - up[j]);
    o[3 * j] = row[j + 1];
    o[3 * j + 1] = dx;
    o[3 * j + 2] = dy;
    a[j] = dx * dx + dy * dy;
  }
  float4* s4 = (float4*)(sm + stage_at(L) + (qy * tw(L) + qx) * 3);
  s4[0] = make_float4(o[0], o[1], o[2], o[3]);
  s4[1] = make_float4(o[4], o[5], o[6], o[7]);
  s4[2] = make_float4(o[8], o[9], o[10], o[11]);
  float* g = lv.asg + ((size_t)gy * lv.w + gx);
  if (lv.vec) {
    *(float4*)g = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gx + j < lv.w) g[j] = a[j];
  }
}

// Float4 k of the interleaved shared copy of level L's tile to device
// memory: neighbouring threads on neighbouring addresses of a row.
template <int L>
__device__ __forceinline__ void write_quad(const float* sm, const Level& lv,
                                           int k) {
  constexpr int RF = 3 * tw(L);                       // floats a tile row
  const int nf = 3 * (tw(L) < lv.w - lv.x0 ? tw(L) : lv.w - lv.x0);
  const int ry = k / (RF / 4), kf = (k % (RF / 4)) * 4;
  const int gy = lv.y0 + ry;
  if (gy >= lv.h || kf >= nf) return;                 // outside the image
  const float4 v = *(const float4*)(sm + stage_at(L) + ry * RF + kf);
  float* g = lv.dI + (((size_t)gy * lv.w + lv.x0) * 3 + kf);
  if (lv.vec) {
    *(float4*)g = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kf + i < nf) g[i] = e[i];
  }
}

// N levels of one tile. Three barriers: level 0 loaded; the coarser planes
// formed; every level's interleaved copy formed.
template <int N>
__global__ void __launch_bounds__(K1_NT)
pyramid_kernel(const float* __restrict__ img, int h, int w, PyramidOut out,
               float* __restrict__ down) {
  extern __shared__ __align__(16) float sm[];
  constexpr int Q0 = tw(0) * th(0) / 4;          // quads of a level's tile
  constexpr int Q1 = N > 1 ? tw(1) * th(1) / 4 : 0;
  constexpr int Q2 = N > 2 ? tw(2) * th(2) / 4 : 0;
  constexpr int Q3 = N > 3 ? tw(3) * th(3) / 4 : 0;
  const Level l0 = level_of<0>(out, h, w);
  const Level l1 = level_of<(N > 1 ? 1 : 0)>(out, h, w);
  const Level l2 = level_of<(N > 2 ? 2 : 0)>(out, h, w);
  const Level l3 = level_of<(N > 3 ? 3 : 0)>(out, h, w);

  load_tile<N>(sm, img, h, w, l0.x0, l0.y0);
  __syncthreads();
  if constexpr (N > 1) {
    coarse_planes<N>(sm);
    __syncthreads();
  }

  for (int q = threadIdx.x; q < Q0 + Q1 + Q2 + Q3; q += K1_NT) {
    if (q < Q0) {
      gradient_quad<0>(sm, l0, q);
    } else if (q < Q0 + Q1) {
      if constexpr (N > 1) gradient_quad<1>(sm, l1, q - Q0);
    } else if (q < Q0 + Q1 + Q2) {
      if constexpr (N > 2) gradient_quad<2>(sm, l2, q - Q0 - Q1);
    } else {
      if constexpr (N > 3) gradient_quad<3>(sm, l3, q - Q0 - Q1 - Q2);
    }
  }
  if (down != nullptr) {        // the 2x2 mean of the last level's tile
    constexpr int NX = tw(N - 1) / 2, NY = th(N - 1) / 2;
    const int hd = h >> N, wd = w >> N;
    for (int i = threadIdx.x; i < NX * NY; i += K1_NT) {
      const int X = i % NX, Y = i / NX;
      const int gx = ((blockIdx.x * K1_TW) >> N) + X;
      const int gy = ((blockIdx.y * K1_TH) >> N) + Y;
      if (gx < wd && gy < hd)
        down[(size_t)gy * wd + gx] = mean_from_level0<N>(
            sm + (Y * (1 << N) + oy(0)) * pitch(0) + X * (1 << N) + ox(0));
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < 3 * (Q0 + Q1 + Q2 + Q3); k += K1_NT) {
    if (k < 3 * Q0) {
      write_quad<0>(sm, l0, k);
    } else if (k < 3 * (Q0 + Q1)) {
      if constexpr (N > 1) write_quad<1>(sm, l1, k - 3 * Q0);
    } else if (k < 3 * (Q0 + Q1 + Q2)) {
      if constexpr (N > 2) write_quad<2>(sm, l2, k - 3 * (Q0 + Q1));
    } else {
      if constexpr (N > 3) write_quad<3>(sm, l3, k - 3 * (Q0 + Q1 + Q2));
    }
  }
}

template <int N>
static cudaError_t launch(const float* img, int h, int w, PyramidOut out,
                          float* down, cudaStream_t stream) {
  dim3 grid((w + K1_TW - 1) / K1_TW, (h + K1_TH - 1) / K1_TH);
  pyramid_kernel<N><<<grid, K1_NT, SMEM_FLOATS * sizeof(float), stream>>>(
      img, h, w, out, down);
  return cudaGetLastError();
}

// Levels 0..n_levels-1 of the (h, w) image: out.dI[l] is (h_l, w_l, 3),
// out.asg[l] is (h_l, w_l); down (or null) is (h_n, w_n). h and w must be
// multiples of 2^(n_levels-1), and of 2^n_levels where down is asked for.
extern "C" int launch_pyramid(const float* img, int h, int w, int n_levels,
                              PyramidOut out, float* down, void* stream) {
  if (n_levels < 1 || n_levels > K1_MAX_LEVELS || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const int halvings = n_levels - (down == nullptr ? 1 : 0);
  if ((h | w) & ((1 << halvings) - 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_levels) {
    case 1: return (int)launch<1>(img, h, w, out, down, st);
    case 2: return (int)launch<2>(img, h, w, out, down, st);
    case 3: return (int)launch<3>(img, h, w, out, down, st);
    default: return (int)launch<4>(img, h, w, out, down, st);
  }
}
