// K4: one activation-GN pass reduce for immature points (the inner loop of
// the reference's optimizeImmaturePoint / ImmaturePoint::linearizeResidual).
//
// Replaces the TPU kernel sos_slam_tpu/ops/ba_p.py act_pass
// (`_act_kernel`), which packed every tap into a lanes-last (F*48, N)
// block and reduced over sublanes.
//
// Bound on the card: bytes. At N=1024, F=8 it reads ~1.7 MB (taps, a, b,
// ok) and writes ~0.08 MB, ~0.5 us at 3.35 TB/s, against ~170 flops per
// (candidate, frame). The design therefore spreads the reads over the
// card and makes each one wide: one thread per (candidate, frame) PAIR,
// consecutive threads on consecutive pairs (8192 threads, 64 blocks at
// N=1024, F=8), and a pair's taps, 96 + 32 + 32 + 32 contiguous bytes of
// hit, a, b and okf, come in by 16-byte loads. The thread walks its 8
// taps serially in tap order: residual against the affine-mapped pattern
// color, Huber, the frame's energy, d_id = gx*a + gy*b, Hdd and bd, and
// the OOB update. The live-masked sums over a candidate's frames (energy
// clamped at energy_th when `clamp`) are taken through shared memory by
// the candidate's first thread in frame order f = 0..F-1, so they equal a
// serial walk over the frames bit for bit, whatever F is. Dead frames are
// skipped by a branch — the `where` of the TPU kernel — never multiplied,
// because their taps may be NaN. No atomics; one launch.
#include <cuda_runtime.h>

#define ACT_THREADS 128

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 x = ((const float4*)src)[0], y = ((const float4*)src)[1];
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  dst[4] = y.x; dst[5] = y.y; dst[6] = y.z; dst[7] = y.w;
}

__global__ void __launch_bounds__(ACT_THREADS) act_pass_kernel(
    const float* __restrict__ hit, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ okf,
    const float* __restrict__ color, const float* __restrict__ w2,
    const float* __restrict__ ap, const float* __restrict__ oob_in,
    const float* __restrict__ eth, int N, int F, int CB, int clamp,
    float huber, float* __restrict__ e_res, float* __restrict__ oob_out,
    float* __restrict__ sums) {
  // per pair of the block: clamped energy, Hdd, bd, oob
  __shared__ float red[ACT_THREADS * 4];
  const int t = threadIdx.x;
  const int nl = t / F, f = t - nl * F;
  const int n = blockIdx.x * CB + nl;       // CB candidates a block
  const bool valid = nl < CB && n < N;
  if (valid) {
    const int nf = n * F + f;
    float tap[24], av[8], bv[8], ok[8], col[8], ww[8];
    load8(hit + (size_t)nf * 24, tap);
    load8(hit + (size_t)nf * 24 + 8, tap + 8);
    load8(hit + (size_t)nf * 24 + 16, tap + 16);
    load8(a + (size_t)nf * 8, av);
    load8(b + (size_t)nf * 8, bv);
    load8(okf + (size_t)nf * 8, ok);
    load8(color + (size_t)n * 8, col);
    load8(w2 + (size_t)n * 8, ww);
    const float2 aff = ((const float2*)ap)[nf];
    const float a0 = aff.x, a1 = aff.y;
    float e = 0.f, H = 0.f, bd = 0.f, allok = 1.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float hi = tap[k * 3], gx = tap[k * 3 + 1], gy = tap[k * 3 + 2];
      const float r = hi - (a0 * col[k] + a1);
      const float ar = fabsf(r);
      const float hw = ar < huber ? 1.f : huber / fmaxf(ar, 1e-9f);
      e += ww[k] * hw * r * r * (2.f - hw);
      const float d_id = gx * av[k] + gy * bv[k];
      const float hww = hw * ww[k];
      H += hww * d_id * d_id;
      bd += hww * r * d_id;
      allok = fminf(allok, ok[k]);
    }
    const float oob = fmaxf(oob_in[nf], allok < 0.5f ? 1.f : 0.f);
    e_res[nf] = e;
    oob_out[nf] = oob;
    red[t * 4] = clamp ? fminf(e, eth[n]) : e;
    red[t * 4 + 1] = H;
    red[t * 4 + 2] = bd;
    red[t * 4 + 3] = oob;
  }
  __syncthreads();
  if (valid && f == 0) {
    float eN = 0.f, HN = 0.f, bN = 0.f;
    for (int g = 0; g < F; ++g) {
      const float* r4 = red + (t + g) * 4;
      if (r4[3] < 0.5f) {
        eN += r4[0];
        HN += r4[1];
        bN += r4[2];
      }
    }
    sums[n] = eN;
    sums[N + n] = HN;
    sums[2 * N + n] = bN;
  }
}

extern "C" int launch_act_pass(const float* hit, const float* a,
                               const float* b, const float* okf,
                               const float* color, const float* w2,
                               const float* ap, const float* oob_in,
                               const float* eth, int N, int F, int clamp,
                               float huber, float* e_res, float* oob_out,
                               float* sums, void* stream) {
  if (F < 1 || F > ACT_THREADS || N < 1) return (int)cudaErrorInvalidValue;
  const int CB = ACT_THREADS / F;           // whole candidates a block
  act_pass_kernel<<<(N + CB - 1) / CB, CB * F, 0, (cudaStream_t)stream>>>(
      hit, a, b, okf, color, w2, ap, oob_in, eth, N, F, CB, clamp, huber,
      e_res, oob_out, sums);
  return (int)cudaGetLastError();
}
