// K3: one fused BA iteration — linearize + top-Hessian cells + Schur
// complement over the (P points x F frames) residual grid.
//
// Replaces the TPU kernel sos_slam_tpu/ops/ba_p.py fused_iteration
// (`_kernel`). That kernel walked point tiles IN ORDER on one core and
// accumulated H_sc, b_sc and the (host,target) 13x13 cells in output refs
// across grid steps. Hopper runs blocks in parallel and in no order, so
// the reductions are split out into fixed-order passes with no float
// atomics (the sums, and so the outlier and keyframe decisions that
// follow, are the same on every run):
//
//   pass A (one thread per point): FEJ geometry, the 10-column X rows,
//     residuals from the pre-gathered [I,dx,dy] taps, Huber and gradient
//     weights, energy / energy_raw, the OOB/outlier state machine, the
//     optional res_toZero FEJ shift (marginalization), the per-point Schur
//     pieces (Hdd, bd, HdiF, Hcd, JpJd) and the absolute cross column v.
//     It also writes each residual's gram row Y = [X^T JI (10) | Jab (2) |
//     resA (1)] to scratch, (P,F,8,13) f32.
//   pass B1 (block = one H_sc row x one range of SPLIT points, thread =
//     one column, b_sc as column D): sums HdiF * v_i * v_j over its points
//     in index order through shared-memory tiles of v; a final pass adds
//     the ranges' partial sums in range order.
//   pass B2 (block = one target frame x one range of SPLIT points, thread
//     = one (a, b) of the 13x13 cell): stages the ranges' gram rows in
//     shared memory and sums Y_a * Y_b into a per-host accumulator, points
//     in index order, taps in order; a final pass adds the ranges' partial
//     cells in range order.
// Splitting the point axis into ranges gives ~P/SPLIT-fold more blocks
// than one block per output row or cell (the first design, measured at
// 1.2 ms for B2 and 0.39 ms for B1 on the H100 at P=2048, F=8), and the
// fixed range order keeps every sum the same from run to run.
//
// Bound on the card: bytes and launch latency. At P=2048, F=8 (D=68) the
// inputs and outputs are ~3.3 MB (taps dominate, ~1 us at 3.35 TB/s) and
// the three passes do ~51 MFLOP (~0.76 us at 67 TFLOP/s fp32; the count
// is derived in chip_smoke.py:k3_flops); the
// scratch round trip adds 2 x 6.8 MB. The TPU design avoided HBM for the
// gram rows; this Hopper design spends that traffic (L2-resident at this
// size) to keep the reductions deterministic and simple. The projection
// and tap gather stay in PyTorch before the kernel, as they stayed in XLA
// in the JAX package.
//
// Every per-residual quantity is multiplied by its 0/1 mask (not
// branched on), exactly like the plain form, so non-finite values of
// masked residuals propagate the same way in both.
#include <cuda_runtime.h>

#define MAXF 16
#define TILE 32     // points per shared-memory tile of v (pass B1)
#define SPLIT 128   // points per range of the split reductions
#define STAGE 16    // points per shared-memory stage of gram rows (B2)
#define YROW 104    // 8 taps x 13 gram-row entries of one (point, frame)

struct Scal {
  float fx, fy, cx, cy, prior_fac, shift_flag, huber, oc, wlim, hlim;
  float dc[4];
};

__device__ __forceinline__ Scal load_scal(const float* s) {
  Scal r;
  r.fx = s[0]; r.fy = s[1]; r.cx = s[2]; r.cy = s[3];
  r.prior_fac = s[4]; r.shift_flag = s[5]; r.huber = s[6]; r.oc = s[7];
  r.wlim = s[8]; r.hlim = s[9];
  for (int c = 0; c < 4; ++c) r.dc[c] = s[12 + c];
  return r;
}

__global__ void ba_point_kernel(
    const float* __restrict__ hit, const float* __restrict__ okf,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ idep, const float* __restrict__ idz,
    const float* __restrict__ ptprior, const float* __restrict__ ptvalid,
    const float* __restrict__ pmask, const float* __restrict__ color,
    const float* __restrict__ wpat, const int* __restrict__ host,
    const float* __restrict__ res_exist, const float* __restrict__ prev_oob,
    const float* __restrict__ R0t, const float* __restrict__ t0t,
    const float* __restrict__ afft, const float* __restrict__ scal,
    int P, int F, int use_rz, const float* __restrict__ b0t,
    const float* __restrict__ etht, const float* __restrict__ fvalid,
    const float* __restrict__ dpt, const float* __restrict__ adH,
    const float* __restrict__ adT, float* __restrict__ yscr,
    float* __restrict__ vout, float* __restrict__ srows,
    float* __restrict__ energy, float* __restrict__ energy_raw,
    signed char* __restrict__ state) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const Scal S = load_scal(scal);
  const int hst = host[p];
  const float up = u[p], vp = v[p], id = idep[p], iz = idz[p];
  const float pr = ptprior[p], ptv = ptvalid[p], pm = pmask[p];
  float col[8], wp[8];
  for (int k = 0; k < 8; ++k) {
    col[k] = color[p * 8 + k];
    wp[k] = wpat[p * 8 + k];
  }
  const float k0 = (up - S.cx) / S.fx;
  const float k1 = (vp - S.cy) / S.fy;
  const float b0h = b0t[hst];
  const float thh = etht[hst];

  float Hdd = 0.f, bd = 0.f, hasr = 0.f;
  float Hcd[4] = {0.f, 0.f, 0.f, 0.f};
  float JpJd[MAXF][8];

  for (int f = 0; f < F; ++f) {
    const int hf = hst * F + f;
    const float* R = R0t + hf * 9;
    const float* t = t0t + hf * 3;
    const float* aff = afft + hf * 2;
    float ptp[3];
    for (int i = 0; i < 3; ++i)
      ptp[i] = ((R[3 * i] * k0 + R[3 * i + 1] * k1) + R[3 * i + 2])
               + t[i] * iz;
    const float drescale = 1.f / ptp[2];
    const float u_ = ptp[0] * drescale;
    const float v_ = ptp[1] * drescale;
    const float Ku = u_ * S.fx + S.cx;
    const float Kv = v_ * S.fy + S.cy;
    const bool geo_ok = (drescale > 0.f) && (Ku > 1.1f) && (Kv > 1.1f) &&
                        (Ku < S.wlim) && (Kv < S.hlim);
    const float nid = iz * drescale;
    float Jpdd0 = drescale * (t[0] - t[2] * u_) * S.fx;
    float Jpdd1 = drescale * (t[1] - t[2] * v_) * S.fy;
    const float A = drescale * (R[6] * u_ - R[0]);
    const float Bc = S.fx * drescale * (R[7] * u_ - R[1]) / S.fy;
    const float C = S.fy * drescale * (R[6] * v_ - R[3]) / S.fx;
    const float Dv = drescale * (R[7] * v_ - R[4]);
    float Xx[10] = {(k0 * A + u_) * 50.f, k1 * Bc * 50.f, (A + 1.f) * 50.f,
                    Bc * 50.f, nid * S.fx, 0.f, -nid * u_ * S.fx,
                    -u_ * v_ * S.fx, (1.f + u_ * u_) * S.fx, -v_ * S.fx};
    float Xy[10] = {k0 * C * 50.f, (k1 * Dv + v_) * 50.f, C * 50.f,
                    (Dv + 1.f) * 50.f, 0.f, nid * S.fy, -nid * v_ * S.fy,
                    -(1.f + v_ * v_) * S.fy, u_ * v_ * S.fy, u_ * S.fy};

    float JIx[8], JIy[8], resF[8], Jab0[8], Jab1[8];
    float eraw = 0.f, wJI2 = 0.f;
    bool allok = geo_ok;
    const int base = (p * F + f) * 8;
    for (int k = 0; k < 8; ++k) {
      const float hi = hit[(base + k) * 3];
      const float gx = hit[(base + k) * 3 + 1];
      const float gy = hit[(base + k) * 3 + 2];
      allok = allok && (okf[base + k] > 0.5f);
      const float r = hi - (aff[0] * col[k] + aff[1]);
      const float drdA = col[k] - b0h;
      const float g2 = gx * gx + gy * gy;
      const float wgrad = sqrtf(S.oc / (S.oc + g2));
      const float wgt = 0.5f * (wgrad + wp[k]);
      const float ar = fabsf(r);
      const float hw = ar < S.huber ? 1.f : S.huber / fmaxf(ar, 1e-9f);
      eraw += wgt * wgt * hw * r * r * (2.f - hw);
      const float hw2 = (hw < 1.f ? sqrtf(hw) : hw) * wgt;
      JIx[k] = gx * hw2;
      JIy[k] = gy * hw2;
      resF[k] = r * hw2;
      Jab0[k] = drdA * hw2;
      Jab1[k] = hw2;
      wJI2 += hw2 * hw2 * g2;
    }
    const float th = fmaxf(thh, etht[f]);
    const bool outlier = (eraw > th) || (wJI2 < 2.f);
    const bool oob = !allok || (prev_oob[p * F + f] > 0.5f);
    const int st = oob ? 1 : (outlier ? 2 : 0);
    energy[f * P + p] = outlier ? th : eraw;
    energy_raw[f * P + p] = eraw;
    state[f * P + p] = (signed char)st;
    const bool active = (res_exist[p * F + f] > 0.5f) && (ptv > 0.5f) &&
                        (fvalid[f] > 0.5f) && (st == 0);
    const float m = (active && pm > 0.5f) ? 1.f : 0.f;
    for (int k = 0; k < 8; ++k) {
      JIx[k] *= m; JIy[k] *= m; resF[k] *= m; Jab0[k] *= m; Jab1[k] *= m;
    }
    for (int i = 0; i < 10; ++i) { Xx[i] *= m; Xy[i] *= m; }
    Jpdd0 *= m;
    Jpdd1 *= m;

    float resA[8];
    if (use_rz) {
      const float* dp = dpt + hf * 8;
      const float dd = id - iz;
      float Jp0 = 0.f, Jp1 = 0.f;
      for (int c = 0; c < 4; ++c) {
        Jp0 += Xx[c] * S.dc[c];
        Jp1 += Xy[c] * S.dc[c];
      }
      for (int i = 0; i < 6; ++i) {
        Jp0 += Xx[4 + i] * dp[i];
        Jp1 += Xy[4 + i] * dp[i];
      }
      Jp0 += Jpdd0 * dd;
      Jp1 += Jpdd1 * dd;
      for (int k = 0; k < 8; ++k)
        resA[k] = resF[k] - (((JIx[k] * Jp0 + JIy[k] * Jp1) + Jab0[k] * dp[6])
                             + Jab1[k] * dp[7]);
    } else {
      for (int k = 0; k < 8; ++k) resA[k] = resF[k];
    }

    float a00 = 0.f, a01 = 0.f, a11 = 0.f, JIr0 = 0.f, JIr1 = 0.f;
    float ab00 = 0.f, ab01 = 0.f, ab10 = 0.f, ab11 = 0.f;
    for (int k = 0; k < 8; ++k) {
      a00 += JIx[k] * JIx[k];
      a01 += JIx[k] * JIy[k];
      a11 += JIy[k] * JIy[k];
      JIr0 += JIx[k] * resA[k];
      JIr1 += JIy[k] * resA[k];
      ab00 += Jab0[k] * JIx[k];
      ab01 += Jab0[k] * JIy[k];
      ab10 += Jab1[k] * JIx[k];
      ab11 += Jab1[k] * JIy[k];
    }
    const float Ji2Jp0 = a00 * Jpdd0 + a01 * Jpdd1;
    const float Ji2Jp1 = a01 * Jpdd0 + a11 * Jpdd1;
    Hdd += Ji2Jp0 * Jpdd0 + Ji2Jp1 * Jpdd1;
    bd += JIr0 * Jpdd0 + JIr1 * Jpdd1;
    for (int c = 0; c < 4; ++c) Hcd[c] += Xx[c] * Ji2Jp0 + Xy[c] * Ji2Jp1;
    for (int i = 0; i < 6; ++i)
      JpJd[f][i] = Xx[4 + i] * Ji2Jp0 + Xy[4 + i] * Ji2Jp1;
    JpJd[f][6] = ab00 * Jpdd0 + ab01 * Jpdd1;
    JpJd[f][7] = ab10 * Jpdd0 + ab11 * Jpdd1;
    hasr = fmaxf(hasr, m);

    float* y = yscr + (size_t)base * 13;
    for (int k = 0; k < 8; ++k) {
      for (int i = 0; i < 10; ++i)
        y[k * 13 + i] = Xx[i] * JIx[k] + Xy[i] * JIy[k];
      y[k * 13 + 10] = Jab0[k];
      y[k * 13 + 11] = Jab1[k];
      y[k * 13 + 12] = resA[k];
    }
  }

  const float prior = pr * S.prior_fac;
  float Hdd_full = Hdd + prior;
  if (Hdd_full < 1e-10f) Hdd_full = 1e-10f;
  const float HdiF = hasr > 0.5f ? 1.f / Hdd_full : 0.f;
  const float bd_full = S.shift_flag > 0.5f ? bd + prior * (id - iz) : bd;
  srows[p] = Hdd_full;
  srows[P + p] = HdiF;
  srows[2 * P + p] = bd_full;
  srows[3 * P + p] = hasr;

  // absolute cross column v = [Hcd, adjoint-stitched frame rows]
  for (int c = 0; c < 4; ++c) vout[c * P + p] = Hcd[c];
  float vH[8];
  for (int i = 0; i < 8; ++i) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) {
      const float* a = adH + (size_t)(hst * F + f) * 64;
      for (int r = 0; r < 8; ++r) s += a[r * 8 + i] * JpJd[f][r];
    }
    vH[i] = s;
  }
  for (int f = 0; f < F; ++f) {
    const float* a = adT + (size_t)(hst * F + f) * 64;
    const float oh = (f == hst) ? 1.f : 0.f;
    for (int i = 0; i < 8; ++i) {
      float s = 0.f;
      for (int r = 0; r < 8; ++r) s += a[r * 8 + i] * JpJd[f][r];
      vout[(4 + 8 * f + i) * P + p] = s + oh * vH[i];
    }
  }
}

// Partial H_sc / b_sc over one range of SPLIT points: block (row i,
// range s), thread j = column (j == D: b_sc). Tiles of TILE points of v
// staged in shared memory (coalesced loads); points in index order.
__global__ void schur_partial_kernel(const float* __restrict__ vin,
                                     const float* __restrict__ srows, int P,
                                     int D, float* __restrict__ part) {
  extern __shared__ float sm[];
  float* vt = sm;                    // (D, TILE)
  float* ht = sm + D * TILE;         // (TILE) HdiF
  float* bt = ht + TILE;             // (TILE) bd
  const int i = blockIdx.x;
  const int s = blockIdx.y;
  const int j = threadIdx.x;
  const int p_lo = s * SPLIT;
  const int p_hi = min(P, p_lo + SPLIT);
  float acc = 0.f;
  for (int p0 = p_lo; p0 < p_hi; p0 += TILE) {
    const int n = min(TILE, p_hi - p0);
#pragma unroll 4
    for (int q = threadIdx.x; q < D * TILE; q += blockDim.x) {
      const int row = q / TILE, c = q % TILE;
      vt[q] = c < n ? vin[(size_t)row * P + p0 + c] : 0.f;
    }
    for (int c = threadIdx.x; c < TILE; c += blockDim.x) {
      ht[c] = c < n ? srows[P + p0 + c] : 0.f;
      bt[c] = c < n ? srows[2 * P + p0 + c] : 0.f;
    }
    __syncthreads();
    if (j <= D) {
      for (int c = 0; c < n; ++c) {
        const float vw = vt[i * TILE + c] * ht[c];
        acc += vw * (j < D ? vt[j * TILE + c] : bt[c]);
      }
    }
    __syncthreads();
  }
  if (j <= D) part[((size_t)s * D + i) * (D + 1) + j] = acc;
}

// Partial top-Hessian cells over one range of SPLIT points: block
// (target f, range s), thread (a, b). acc_h[a][b] += sum_k Y[p][f][k][a] *
// Y[p][f][k][b] for each point p of the range (index order) into its
// host's accumulator; gram rows staged STAGE points at a time.
__global__ void top_partial_kernel(const float* __restrict__ yscr,
                                   const int* __restrict__ host, int P,
                                   int F, float* __restrict__ part) {
  __shared__ float ys[STAGE][YROW];
  __shared__ int hs[STAGE];
  const int f = blockIdx.x;
  const int s = blockIdx.y;
  const int t = threadIdx.x;
  const int a = t / 13, b = t % 13;
  const int p_lo = s * SPLIT;
  const int p_hi = min(P, p_lo + SPLIT);
  float acc[MAXF];
  for (int h = 0; h < MAXF; ++h) acc[h] = 0.f;
  for (int p0 = p_lo; p0 < p_hi; p0 += STAGE) {
    const int n = min(STAGE, p_hi - p0);
#pragma unroll 4
    for (int q = t; q < n * YROW; q += blockDim.x) {
      const int pp = q / YROW, r = q % YROW;
      ys[pp][r] = yscr[(size_t)((p0 + pp) * F + f) * YROW + r];
    }
    if (t < n) hs[t] = host[p0 + t];
    __syncthreads();
    if (t < 169) {
      for (int pp = 0; pp < n; ++pp) {
        const int h = hs[pp];
        float v = 0.f;
        for (int k = 0; k < 8; ++k) v += ys[pp][k * 13 + a] * ys[pp][k * 13 + b];
        if (h >= 0 && h < F) acc[h] += v;
      }
    }
    __syncthreads();
  }
  if (t < 169)
    for (int h = 0; h < F; ++h)
      part[(((size_t)s * F + h) * F + f) * 169 + t] = acc[h];
}

// out[idx] = sum over ranges s = 0..S-1, in order, of part[s][idx].
__global__ void range_sum_kernel(const float* __restrict__ part, int S, int n,
                                 float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * n + idx];
  out[idx] = acc;
}

extern "C" int launch_ba_fused(
    const float* hit, const float* okf, const float* u, const float* v,
    const float* idep, const float* idz, const float* ptprior,
    const float* ptvalid, const float* pmask, const float* color,
    const float* wpat, const int* host, const float* res_exist,
    const float* prev_oob, const float* R0, const float* t0,
    const float* affLL, const float* scal, int P, int F, int use_rz,
    const float* b0, const float* eth, const float* fvalid,
    const float* adHTdelta, const float* adHost, const float* adTarget,
    float* yscr, float* part, float* vout, float* srows, float* energy,
    float* energy_raw, signed char* state, float* acc, float* hsc,
    void* stream) {
  if (F > MAXF || F < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int D = 4 + 8 * F;
  const int S = (P + SPLIT - 1) / SPLIT;
  const int n_sc = D * (D + 1), n_top = F * F * 169;
  float* part_sc = part;                         // (S, D, D+1)
  float* part_top = part + (size_t)S * n_sc;     // (S, F, F, 169)
  cudaError_t err;
#define CHECK_LAUNCH()                                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  ba_point_kernel<<<(P + 127) / 128, 128, 0, st>>>(
      hit, okf, u, v, idep, idz, ptprior, ptvalid, pmask, color, wpat, host,
      res_exist, prev_oob, R0, t0, affLL, scal, P, F, use_rz, b0, eth,
      fvalid, adHTdelta, adHost, adTarget, yscr, vout, srows, energy,
      energy_raw, state);
  CHECK_LAUNCH();
  const int threads = ((D + 1 + 31) / 32) * 32;
  const size_t smem = (size_t)(D * TILE + 2 * TILE) * sizeof(float);
  schur_partial_kernel<<<dim3(D, S), threads, smem, st>>>(vout, srows, P, D,
                                                          part_sc);
  CHECK_LAUNCH();
  range_sum_kernel<<<(n_sc + 255) / 256, 256, 0, st>>>(part_sc, S, n_sc, hsc);
  CHECK_LAUNCH();
  top_partial_kernel<<<dim3(F, S), 192, 0, st>>>(yscr, host, P, F, part_top);
  CHECK_LAUNCH();
  range_sum_kernel<<<(n_top + 255) / 256, 256, 0, st>>>(part_top, S, n_top,
                                                        acc);
  CHECK_LAUNCH();
#undef CHECK_LAUNCH
  return 0;
}
