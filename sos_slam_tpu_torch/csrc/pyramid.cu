// K1: one pyramid level in one pass — gradients, |grad|^2 and the 2x2
// box-downsampled next level.
//
// Replaces the TPU kernel sos_slam_tpu/ops/pallas_kernels.py
// fused_pyramid_level (_pyramid_level_kernel). On the TPU the whole level
// sat in VMEM and the downsample rode the MXU as two averaging matmuls;
// here it is a plain stencil: one thread per pixel reads its +-1
// neighbours (L1/L2 serve the reuse) and writes the interleaved
// [I, dx, dy] level directly, so no separate stack pass is needed.
//
// Bound on the card: bytes. Level 0 at 640x480 reads 1.2 MB and writes
// 3.7 MB (dI) + 1.2 MB (|g|^2) + 0.3 MB (next level), ~2 us at 3.35 TB/s;
// a few flops per pixel. Coalesced row-major access is all the design
// needs; at these sizes the launch itself dominates.
//
// Semantics (reference makeImages, HessianBlocks.cpp:121-176):
//   dx = 0.5 (I[x+1] - I[x-1]) on interior columns AND interior rows only,
//   dy = 0.5 (I[y+1] - I[y-1]) on interior rows, zero elsewhere;
//   next[y][x] = mean of the 2x2 block at (2y, 2x).
#include <cuda_runtime.h>

__global__ void pyramid_level_kernel(const float* __restrict__ img, int h,
                                     int w, float* __restrict__ dI,
                                     float* __restrict__ asg,
                                     float* __restrict__ down) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  const float c = img[i];
  const bool row_in = (y > 0) && (y < h - 1);
  float dx = 0.f, dy = 0.f;
  if (row_in && x > 0 && x < w - 1) dx = 0.5f * (img[i + 1] - img[i - 1]);
  if (row_in) dy = 0.5f * (img[i + w] - img[i - w]);
  dI[3 * i] = c;
  dI[3 * i + 1] = dx;
  dI[3 * i + 2] = dy;
  asg[i] = dx * dx + dy * dy;
  const int h2 = h / 2, w2 = w / 2;
  if (x < w2 && y < h2) {
    const int j = (2 * y) * w + 2 * x;
    down[y * w2 + x] = ((img[j] + img[j + 1]) + (img[j + w] + img[j + w + 1]))
                       * 0.25f;
  }
}

extern "C" int launch_pyramid_level(const float* img, int h, int w, float* dI,
                                    float* asg, float* down, void* stream) {
  dim3 block(32, 8);
  dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  pyramid_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, h, w, dI, asg, down);
  return (int)cudaGetLastError();
}
