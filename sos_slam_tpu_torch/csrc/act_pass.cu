// K4: one activation-GN pass reduce for immature points (the inner loop of
// the reference's optimizeImmaturePoint / ImmaturePoint::linearizeResidual).
//
// Replaces the TPU kernel sos_slam_tpu/ops/ba_p.py act_pass
// (`_act_kernel`), which packed every tap into a lanes-last (F*48, N)
// block. Here one thread owns one candidate point and walks its F x 8
// taps: residual against the affine-mapped pattern color, Huber, the
// per-frame energy, d_id = gx*a + gy*b, per-frame Hdd and bd, the OOB
// update, and the live-masked sums over frames (energy clamped at
// energy_th when `clamp`). Dead frames are skipped by a branch — the
// `where` of the TPU kernel — never multiplied, because their taps may be
// NaN.
//
// Bound on the card: bytes. At N=2048, F=8 it reads ~1.3 MB (taps, a, b,
// ok) and writes ~0.15 MB, ~0.4 us at 3.35 TB/s; ~40 flops per tap. The
// per-thread reads of consecutive taps are contiguous per point; at this
// size the launch dominates.
#include <cuda_runtime.h>

__global__ void act_pass_kernel(
    const float* __restrict__ hit, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ okf,
    const float* __restrict__ color, const float* __restrict__ w2,
    const float* __restrict__ ap, const float* __restrict__ oob_in,
    const float* __restrict__ eth, int N, int F, int clamp, float huber,
    float* __restrict__ e_res, float* __restrict__ oob_out,
    float* __restrict__ sums) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float col[8], ww[8];
  for (int k = 0; k < 8; ++k) {
    col[k] = color[n * 8 + k];
    ww[k] = w2[n * 8 + k];
  }
  const float th = eth[n];
  float eN = 0.f, HN = 0.f, bN = 0.f;
  for (int f = 0; f < F; ++f) {
    const int nf = n * F + f;
    const float a0 = ap[nf * 2], a1 = ap[nf * 2 + 1];
    float e = 0.f, H = 0.f, bd = 0.f, allok = 1.f;
    for (int k = 0; k < 8; ++k) {
      const int q = nf * 8 + k;
      const float hi = hit[q * 3], gx = hit[q * 3 + 1], gy = hit[q * 3 + 2];
      const float r = hi - (a0 * col[k] + a1);
      const float ar = fabsf(r);
      const float hw = ar < huber ? 1.f : huber / fmaxf(ar, 1e-9f);
      e += ww[k] * hw * r * r * (2.f - hw);
      const float d_id = gx * a[q] + gy * b[q];
      const float hww = hw * ww[k];
      H += hww * d_id * d_id;
      bd += hww * r * d_id;
      allok = fminf(allok, okf[q]);
    }
    const float oob = fmaxf(oob_in[nf], allok < 0.5f ? 1.f : 0.f);
    e_res[nf] = e;
    oob_out[nf] = oob;
    if (oob < 0.5f) {
      eN += clamp ? fminf(e, th) : e;
      HN += H;
      bN += bd;
    }
  }
  sums[n] = eN;
  sums[N + n] = HN;
  sums[2 * N + n] = bN;
}

extern "C" int launch_act_pass(const float* hit, const float* a,
                               const float* b, const float* okf,
                               const float* color, const float* w2,
                               const float* ap, const float* oob_in,
                               const float* eth, int N, int F, int clamp,
                               float huber, float* e_res, float* oob_out,
                               float* sums, void* stream) {
  act_pass_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      hit, a, b, okf, color, w2, ap, oob_in, eth, N, F, clamp, huber, e_res,
      oob_out, sums);
  return (int)cudaGetLastError();
}
