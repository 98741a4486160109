// K3: one fused BA iteration — linearize + top-Hessian cells + Schur
// complement over the (P points x F frames) residual grid.
//
// Replaces the TPU kernel sos_slam_tpu/ops/ba_p.py fused_iteration
// (`_kernel`). That kernel walked point tiles IN ORDER on one core and
// accumulated H_sc, b_sc and the (host,target) 13x13 cells in output refs
// across grid steps. Hopper runs blocks in parallel and in no order, so
// every block sums its own points and a second launch adds the blocks'
// partial sums in block order. No float atomics anywhere: the sums, and so
// the outlier and keyframe decisions that follow, repeat bit for bit.
//
// Bound on the card: bytes. At P=2048, F=8 (D=68) the inputs and outputs
// are ~3.3 MB (taps dominate, ~1 us at 3.35 TB/s) against ~51 MFLOP
// (~0.76 us at 67 TFLOP/s fp32; both counted in chip_smoke.py:k3_bytes /
// k3_flops). What the kernel really fights is latency: the work is a
// chain of short dependent phases. So the design moves each input once,
// keeps every intermediate on the SM, never waits on device memory after
// the first barrier, and spreads the residuals over the card:
//
//   launch 1, ba_block_kernel: block = PB consecutive points x F frames
//     (PB = 32 up to F = 8, else 8: at most 256 pairs; 64 blocks at
//     P=2048, F=8), 512 threads: one thread per (point, frame) RESIDUAL,
//     the rest help in the phases that are not per residual.
//       stage   cp.async, all in flight at once: the block's taps, one
//               contiguous range of hit (P,F,8,3) and okf (P,F,8), its
//               colors and pattern weights, 16 bytes a copy into rows
//               padded against bank conflicts; and every (host, target)
//               table whole (adHost, adTarget, R0, t0, affine, adHTdelta,
//               b0, energy_th): a read from L2 later in the kernel costs
//               ~700 cycles each time it is waited for. Meanwhile two
//               warps order the block's points by host with shuffles.
//       pairs   each pair thread: FEJ geometry, the 10-column X rows, its
//               8 taps SERIALLY in tap order (residual, Huber and gradient
//               weights, energy_raw and wJI2: the sums that decide the
//               state), the OOB/outlier state, the optional res_toZero
//               shift, its Schur terms, and its term of its (host, target)
//               cell: the 91 distinct entries of Y^T Y for the gram rows
//               Y = [X^T JI (10) | Jab (2) | resA (1)] x 8 taps, formed
//               from the tap sums (X^T (JI JI^T) X, X^T (JI Jab^T), ...)
//               as the plain form does. The 8 x 13 gram rows themselves
//               are never formed, in device memory or anywhere else; the
//               91 floats stay in shared memory (over the dead staging).
//       points  Hdd, bd, Hcd, has_res over the F frames of a point in
//               frame order f = 0..F-1 through shared memory; the adjoint
//               stitch of the cross column v: the pair threads take the
//               target part while 256 other threads take the host part.
//       write   v (D,P), srows, energy, energy_raw, state, active and
//               has_res leave through shared-memory tiles, a row of PB
//               consecutive points at a time.
//       cells   one thread per two (target, entry) items: the pairs' terms
//               summed over the block's points, grouped by host, in point
//               order -> partial cells (block, host, target, 91).
//       schur   one thread per 2 x 4 tile of H_sc on or above the diagonal
//               (6 rows of v read for 8 entries), then b_sc: sums of
//               v_i HdiF v_j over the block's points in point order ->
//               partial (block, D(D+1)/2 + D).
//   launch 2, block_sum_kernel: one thread per entry of acc (F,F,13,13),
//     [H_sc | b_sc] (D,D+1) and b_sc (D,): adds the blocks' partials in
//     block order and mirrors the symmetric halves.
//
// Between the launches only the partials cross device memory: 64 blocks x
// (64 x 91 + 2414) f32 = 2.1 MB at P=2048, F=8 (L2-resident).
//
// Against the first Hopper design (one thread per point, gram rows through
// a 6.8 MB scratch, ranges of 128 points, five launches): the per-residual
// arithmetic up to the state, and the per-point sums over frames in frame
// order, are unchanged operation for operation, so states, masks, has_res,
// energy, Hdd, bd and v are bit-identical. What changed its rounding: a
// cell entry is now summed from the pairs' factored terms (not from 8
// products a tap), the cells and H_sc / b_sc over ranges of PB points (was
// 128) before the range sum, and a mirrored H_sc entry (j, i) is the
// (i, j) product (v_i HdiF) v_j instead of (v_j HdiF) v_i. All are held to
// the plain form at 2e-4, the Hessians also on H_ij / sqrt(H_ii H_jj).
//
// Every per-residual quantity is multiplied by its 0/1 mask (not branched
// on), exactly like the plain form, so non-finite values of masked
// residuals propagate the same way in both. `host` is clamped for table
// reads and a host outside [0, F) owns no cell. The projection and tap
// gather stay in PyTorch before the kernel, as they stayed in XLA in the
// JAX package.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define MAXF 16
#define MAXPAIRS 256  // (point, frame) pairs of a block
#define NT 512        // threads of a block: the pairs, and helpers
#define NTAP 8
#define NG 13         // rows of a (host, target) cell
#define NE 91         // distinct entries of a symmetric 13x13 cell
#define HSTR 28       // staged [I,dx,dy] taps of a pair: 24 floats + 4
#define OSTR 12       // staged ok flags of a pair: 8 floats + 4
#define NCS 7         // per-pair Schur terms: Hdd, bd, Hcd[4], mask
#define ADS 68        // staged 8x8 adjoint cell: 64 floats + 4

struct K3Args {
  // inputs
  const float *hit, *okf, *u, *v, *idep, *idz, *ptprior;
  const unsigned char *ptvalid, *pmask;  // pmask may be null: all points
  const float *color, *wpat;
  const int* host;
  const unsigned char* res_exist;
  const signed char* res_state;
  const float *R0, *t0, *aff, *c, *c_zero, *b0, *eth;
  const unsigned char* fvalid;
  const float *dpt, *adH, *adT;
  int P, F, use_rz, shift_flag;
  float prior_fac, huber, oc, wlim, hlim;
  // partial sums and outputs
  float *part_top, *part_sc;
  float *vout, *srows, *energy, *energy_raw;
  signed char* state;
  unsigned char *active, *has_res;
};

// Points of a block: 32 up to F = 8 (256 pairs); 8 beyond, where the
// (host, target) tables take most of the shared memory.
__host__ __device__ inline int points_per_block(int F) {
  return F <= 8 ? 32 : 8;
}

// Index of entry (i, j), j >= i, in the row-major upper triangle of a
// matrix with `ncols` columns.
__host__ __device__ inline int tri(int i, int j, int ncols) {
  return i * ncols - i * (i - 1) / 2 + (j - i);
}

// The block's shared memory, in floats (every array starts on 16 bytes).
struct Smem {
  int gs, vt, jp, cs, vh, col, wp, sr, en, er, adh, adt, tab, ints,
      bytes_at, total;
};

__host__ __device__ inline Smem smem_layout(int F) {
  const int PB = points_per_block(F), NP = PB * F, D = 4 + 8 * F;
  Smem s;
  int o = 0;
  s.gs = o; o += NP * NE;              // cell terms; first the staged taps
  s.vt = o; o += (D * (PB + 1) + 3) / 4 * 4;  // v tile, row stride PB + 1
  s.jp = o; o += NP * 8;               // JpJd of each pair
  s.cs = o; o += NP * NCS;             // Schur terms of each pair
  s.vh = o; o += PB * 8;               // host part of v of each point
  s.col = o; o += PB * 8;
  s.wp = o; o += PB * 8;
  s.sr = o; o += PB * 4;               // Hdd_full, HdiF, bd_full, has_res
  s.en = o; o += NP;                   // energy, (F, PB)
  s.er = o; o += NP;                   // energy_raw, (F, PB)
  s.adh = o; o += F * F * ADS;         // adHost, every (host, target) cell
  s.adt = o; o += F * F * ADS;         // adTarget
  s.tab = o; o += (F * F * 22 + 2 * F + 3) / 4 * 4;  // R0, t0, aff, dpt, b0, eth
  s.ints = o; o += 2 * PB + MAXF + 4;  // host clamped, order, seg
  s.bytes_at = o; o += (2 * NP + PB + 3) / 4;  // state, active, has_res
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(NT) ba_block_kernel(const K3Args A) {
  extern __shared__ __align__(16) float sm[];
  const int P = A.P, F = A.F;
  const int PB = points_per_block(F), NP = PB * F, D = 4 + 8 * F;
  const int VS = PB + 1;
  const Smem L = smem_layout(F);
  float* gs = sm + L.gs;             // (NP, NE) cell terms of each pair
  float* tap_h = gs;                 // (NP, HSTR), dead once gs is written
  float* tap_o = gs + NP * HSTR;     // (NP, OSTR)
  float* vt = sm + L.vt;
  float* jp = sm + L.jp;
  float* cs = sm + L.cs;
  float* vh = sm + L.vh;
  float* cols = sm + L.col;
  float* wps = sm + L.wp;
  float* sr = sm + L.sr;
  float* en = sm + L.en;
  float* er = sm + L.er;
  float* adh_s = sm + L.adh;         // (F*F, ADS)
  float* adt_s = sm + L.adt;
  float* R0_s = sm + L.tab;          // (F*F, 9)
  float* t0_s = R0_s + F * F * 9;    // (F*F, 3)
  float* aff_s = t0_s + F * F * 3;   // (F*F, 2)
  float* dpt_s = aff_s + F * F * 2;  // (F*F, 8)
  float* b0_s = dpt_s + F * F * 8;   // (F)
  float* eth_s = b0_s + F;           // (F)
  int* h_tab = (int*)(sm + L.ints);  // host clamped to [0, F): table reads
  int* order = h_tab + PB;           // in-range points, stable by host
  int* seg = order + PB;             // (F + 1) starts of each host's run
  signed char* st_s = (signed char*)(sm + L.bytes_at);
  unsigned char* act_s = (unsigned char*)st_s + NP;
  unsigned char* has_s = act_s + NP;

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * PB;
  const int n = min(PB, P - p0);     // points of this block
  const int npairs = n * F;
  // threads [0, NP) own one (point, frame) pair each
  const int pl = t / F, f = t - pl * F;
  const bool valid = t < NP && pl < n;
  const int p = p0 + pl;

  // ---- stage: asynchronous copies (cp.async) of the block's contiguous
  // input ranges and of the (host, target) tables, which every block reads
  // whole; all in flight at once, no register in between. Taps, ok flags,
  // colors, weights and the two adjoints go 16 bytes a copy into padded
  // rows, the small tables 4 bytes a copy ----
  {
    const float* hsrc = A.hit + (size_t)p0 * F * 24;
    for (int q = t; q < npairs * 6; q += NT)
      __pipeline_memcpy_async(tap_h + (q / 6) * HSTR + (q % 6) * 4,
                              hsrc + q * 4, 16);
    const float* osrc = A.okf + (size_t)p0 * F * 8;
    for (int q = t; q < npairs * 2; q += NT)
      __pipeline_memcpy_async(tap_o + (q >> 1) * OSTR + (q & 1) * 4,
                              osrc + q * 4, 16);
    if (t < n * 2) {
      __pipeline_memcpy_async(cols + t * 4, A.color + (size_t)p0 * 8 + t * 4,
                              16);
      __pipeline_memcpy_async(wps + t * 4, A.wpat + (size_t)p0 * 8 + t * 4,
                              16);
    }
    for (int q = t; q < F * F * 16; q += NT) {
      const int dst = (q >> 4) * ADS + (q & 15) * 4;
      __pipeline_memcpy_async(adh_s + dst, A.adH + q * 4, 16);
      __pipeline_memcpy_async(adt_s + dst, A.adT + q * 4, 16);
    }
    for (int q = t; q < F * F * 9; q += NT)
      __pipeline_memcpy_async(R0_s + q, A.R0 + q, 4);
    for (int q = t; q < F * F * 8; q += NT)
      __pipeline_memcpy_async(dpt_s + q, A.dpt + q, 4);
    for (int q = t; q < F * F * 3; q += NT)
      __pipeline_memcpy_async(t0_s + q, A.t0 + q, 4);
    for (int q = t; q < F * F * 2; q += NT)
      __pipeline_memcpy_async(aff_s + q, A.aff + q, 4);
    if (t < F) {
      __pipeline_memcpy_async(b0_s + t, A.b0 + t, 4);
      __pipeline_memcpy_async(eth_s + t, A.eth + t, 4);
    }
    __pipeline_commit();
  }

  // the pair's own point and masks: only loaded here, used after the
  // barrier, so that their latency overlaps the staging
  int hraw = 0;
  float up = 0.f, vp = 0.f, id = 0.f, iz = 0.f;
  float c4[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned char m_exist = 0, m_pt = 0, m_fr = 0, m_in = 1;
  signed char prev_state = 0;
  if (valid) {
    hraw = A.host[p];
    up = A.u[p]; vp = A.v[p]; id = A.idep[p]; iz = A.idz[p];
#pragma unroll
    for (int i = 0; i < 4; ++i) c4[i] = A.c[i];
    m_exist = A.res_exist[p * F + f];
    m_pt = A.ptvalid[p];
    m_fr = A.fvalid[f];
    if (A.pmask != nullptr) m_in = A.pmask[p];
    prev_state = A.res_state[p * F + f];
  }

  // the block's points grouped by host (stable: point order inside a
  // host), for the cell sums; a host outside [0, F) owns no cell. Each
  // lane of warps 0 and 1 holds one point's host and the warp passes them
  // round by shuffles: lane q of warp 0 places point q, lane h <= F of
  // warp 1 counts the start of host h's run.
  if (t < 64) {
    const int lane = t & 31;
    const int mine = lane < n ? A.host[p0 + lane] : -1;
    const bool in_range = mine >= 0 && mine < F;
    int count = 0;
    for (int q = 0; q < n; ++q) {
      const int hq = __shfl_sync(0xffffffffu, mine, q);
      const bool counts = hq >= 0 && hq < F;
      if (t < 32)
        count += (counts && (hq < mine || (hq == mine && q < lane))) ? 1 : 0;
      else
        count += (counts && hq < lane) ? 1 : 0;
    }
    if (t < 32) {
      if (lane < n) {
        h_tab[lane] = min(max(mine, 0), F - 1);
        if (in_range) order[count] = lane;
      }
    } else if (lane <= F) {
      seg[lane] = count;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  const int hst = min(max(hraw, 0), F - 1);   // table reads stay in range

  float tap[24], okv[8];
  if (valid) {
    for (int q = 0; q < 6; ++q) {
      const float4 x = *(const float4*)(tap_h + t * HSTR + q * 4);
      tap[q * 4] = x.x; tap[q * 4 + 1] = x.y;
      tap[q * 4 + 2] = x.z; tap[q * 4 + 3] = x.w;
    }
    for (int q = 0; q < 2; ++q) {
      const float4 x = *(const float4*)(tap_o + t * OSTR + q * 4);
      okv[q * 4] = x.x; okv[q * 4 + 1] = x.y;
      okv[q * 4 + 2] = x.z; okv[q * 4 + 3] = x.w;
    }
  }
  __syncthreads();   // the staged taps are in registers: gs may overwrite

  // ---- pairs: one (point, frame) residual per thread ----
  float JpJd[8];
  if (valid) {
    const float fx = c4[0] * 50.f, fy = c4[1] * 50.f;
    const float cx = c4[2] * 50.f, cy = c4[3] * 50.f;
    const float* col = cols + pl * 8;
    const float* wp = wps + pl * 8;
    const float k0 = (up - cx) / fx;
    const float k1 = (vp - cy) / fy;
    const int hf = hst * F + f;
    const float* R = R0_s + hf * 9;
    const float* tt = t0_s + hf * 3;
    const float aff0 = aff_s[hf * 2], aff1 = aff_s[hf * 2 + 1];
    const float b0h = b0_s[hst];
    const float th = fmaxf(eth_s[hst], eth_s[f]);
    float ptp[3];
    for (int i = 0; i < 3; ++i)
      ptp[i] = ((R[3 * i] * k0 + R[3 * i + 1] * k1) + R[3 * i + 2])
               + tt[i] * iz;
    const float drescale = 1.f / ptp[2];
    const float u_ = ptp[0] * drescale;
    const float v_ = ptp[1] * drescale;
    const float Ku = u_ * fx + cx;
    const float Kv = v_ * fy + cy;
    const bool geo_ok = (drescale > 0.f) && (Ku > 1.1f) && (Kv > 1.1f) &&
                        (Ku < A.wlim) && (Kv < A.hlim);
    const float nid = iz * drescale;
    float Jpdd0 = drescale * (tt[0] - tt[2] * u_) * fx;
    float Jpdd1 = drescale * (tt[1] - tt[2] * v_) * fy;
    const float Ac = drescale * (R[6] * u_ - R[0]);
    const float Bc = fx * drescale * (R[7] * u_ - R[1]) / fy;
    const float Cc = fy * drescale * (R[6] * v_ - R[3]) / fx;
    const float Dv = drescale * (R[7] * v_ - R[4]);
    float Xx[10] = {(k0 * Ac + u_) * 50.f, k1 * Bc * 50.f, (Ac + 1.f) * 50.f,
                    Bc * 50.f, nid * fx, 0.f, -nid * u_ * fx,
                    -u_ * v_ * fx, (1.f + u_ * u_) * fx, -v_ * fx};
    float Xy[10] = {k0 * Cc * 50.f, (k1 * Dv + v_) * 50.f, Cc * 50.f,
                    (Dv + 1.f) * 50.f, 0.f, nid * fy, -nid * v_ * fy,
                    -(1.f + v_ * v_) * fy, u_ * v_ * fy, u_ * fy};

    // the 8 taps serially in tap order: eraw and wJI2 decide the state
    float JIx[8], JIy[8], resF[8], Jab0[8], Jab1[8];
    float eraw = 0.f, wJI2 = 0.f;
    bool allok = geo_ok;
#pragma unroll
    for (int k = 0; k < NTAP; ++k) {
      const float hi = tap[k * 3];
      const float gx = tap[k * 3 + 1];
      const float gy = tap[k * 3 + 2];
      allok = allok && (okv[k] > 0.5f);
      const float r = hi - (aff0 * col[k] + aff1);
      const float drdA = col[k] - b0h;
      const float g2 = gx * gx + gy * gy;
      const float wgrad = sqrtf(A.oc / (A.oc + g2));
      const float wgt = 0.5f * (wgrad + wp[k]);
      const float ar = fabsf(r);
      const float hw = ar < A.huber ? 1.f : A.huber / fmaxf(ar, 1e-9f);
      eraw += wgt * wgt * hw * r * r * (2.f - hw);
      const float hw2 = (hw < 1.f ? sqrtf(hw) : hw) * wgt;
      JIx[k] = gx * hw2;
      JIy[k] = gy * hw2;
      resF[k] = r * hw2;
      Jab0[k] = drdA * hw2;
      Jab1[k] = hw2;
      wJI2 += hw2 * hw2 * g2;
    }
    const bool outlier = (eraw > th) || (wJI2 < 2.f);
    const bool oob = !allok || (prev_state == 1);   // RES_OOB
    const int st = oob ? 1 : (outlier ? 2 : 0);
    en[f * PB + pl] = outlier ? th : eraw;
    er[f * PB + pl] = eraw;
    st_s[f * PB + pl] = (signed char)st;
    const bool active = (m_exist != 0) && (m_pt != 0) && (m_fr != 0) &&
                        (st == 0);
    act_s[f * PB + pl] = active ? 1 : 0;
    const float m = (active && m_in != 0) ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < NTAP; ++k) {
      JIx[k] *= m; JIy[k] *= m; resF[k] *= m; Jab0[k] *= m; Jab1[k] *= m;
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) { Xx[i] *= m; Xy[i] *= m; }
    Jpdd0 *= m;
    Jpdd1 *= m;

    float resA[8];
    if (A.use_rz) {
      const float* dp = dpt_s + hf * 8;
      const float dd = id - iz;
      float Jp0 = 0.f, Jp1 = 0.f;
      for (int c = 0; c < 4; ++c) {
        const float dc = c4[c] - A.c_zero[c];
        Jp0 += Xx[c] * dc;
        Jp1 += Xy[c] * dc;
      }
      for (int i = 0; i < 6; ++i) {
        Jp0 += Xx[4 + i] * dp[i];
        Jp1 += Xy[4 + i] * dp[i];
      }
      Jp0 += Jpdd0 * dd;
      Jp1 += Jpdd1 * dd;
#pragma unroll
      for (int k = 0; k < NTAP; ++k)
        resA[k] = resF[k] - (((JIx[k] * Jp0 + JIy[k] * Jp1) + Jab0[k] * dp[6])
                             + Jab1[k] * dp[7]);
    } else {
#pragma unroll
      for (int k = 0; k < NTAP; ++k) resA[k] = resF[k];
    }

    // the tap sums (the factors of RawResidualJacobian), taps in order
    float a00 = 0.f, a01 = 0.f, a11 = 0.f, JIr0 = 0.f, JIr1 = 0.f;
    float ab00 = 0.f, ab01 = 0.f, ab10 = 0.f, ab11 = 0.f;
    float s00 = 0.f, s01 = 0.f, s11 = 0.f, r0 = 0.f, r1 = 0.f, rr = 0.f;
#pragma unroll
    for (int k = 0; k < NTAP; ++k) {
      a00 += JIx[k] * JIx[k];
      a01 += JIx[k] * JIy[k];
      a11 += JIy[k] * JIy[k];
      JIr0 += JIx[k] * resA[k];
      JIr1 += JIy[k] * resA[k];
      ab00 += Jab0[k] * JIx[k];
      ab01 += Jab0[k] * JIy[k];
      ab10 += Jab1[k] * JIx[k];
      ab11 += Jab1[k] * JIy[k];
      s00 += Jab0[k] * Jab0[k];
      s01 += Jab0[k] * Jab1[k];
      s11 += Jab1[k] * Jab1[k];
      r0 += Jab0[k] * resA[k];
      r1 += Jab1[k] * resA[k];
      rr += resA[k] * resA[k];
    }
    const float Ji2Jp0 = a00 * Jpdd0 + a01 * Jpdd1;
    const float Ji2Jp1 = a01 * Jpdd0 + a11 * Jpdd1;
    float* c7 = cs + t * NCS;
    c7[0] = Ji2Jp0 * Jpdd0 + Ji2Jp1 * Jpdd1;
    c7[1] = JIr0 * Jpdd0 + JIr1 * Jpdd1;
    for (int c = 0; c < 4; ++c) c7[2 + c] = Xx[c] * Ji2Jp0 + Xy[c] * Ji2Jp1;
    c7[6] = m;
    for (int i = 0; i < 6; ++i)
      JpJd[i] = Xx[4 + i] * Ji2Jp0 + Xy[4 + i] * Ji2Jp1;
    JpJd[6] = ab00 * Jpdd0 + ab01 * Jpdd1;
    JpJd[7] = ab10 * Jpdd0 + ab11 * Jpdd1;
    for (int i = 0; i < 8; ++i) jp[t * 8 + i] = JpJd[i];

    // the pair's term of its (host, target) cell, the 91 distinct entries
    // of Y^T Y for the gram rows Y = [X^T JI (10) | Jab (2) | resA (1)] x
    // 8 taps, from the tap sums: X^T (JI JI^T) X and so on
    float* g = gs + t * NE;
    int e = 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const float T0 = a00 * Xx[i] + a01 * Xy[i];
      const float T1 = a01 * Xx[i] + a11 * Xy[i];
#pragma unroll
      for (int j = i; j < 10; ++j) g[e++] = Xx[j] * T0 + Xy[j] * T1;
      g[e++] = Xx[i] * ab00 + Xy[i] * ab01;
      g[e++] = Xx[i] * ab10 + Xy[i] * ab11;
      g[e++] = Xx[i] * JIr0 + Xy[i] * JIr1;
    }
    g[e++] = s00; g[e++] = s01; g[e++] = r0;
    g[e++] = s11; g[e++] = r1;
    g[e++] = rr;
  }
  __syncthreads();

  // ---- points: sums over a point's frames in frame order, and the
  // adjoint stitch of v; the pairs take the target part, threads
  // [256, 256 + NP) the host part at the same time ----
  float vtgt[8];
  if (t < NP) {
    if (valid) {
      // rows of the pair's adTarget cell by 16-byte loads, rows in order
      const float4* a4 = (const float4*)(adt_s + (hst * F + f) * ADS);
#pragma unroll
      for (int i = 0; i < 8; ++i) vtgt[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 lo = a4[2 * r], hi = a4[2 * r + 1];
        vtgt[0] += lo.x * JpJd[r]; vtgt[1] += lo.y * JpJd[r];
        vtgt[2] += lo.z * JpJd[r]; vtgt[3] += lo.w * JpJd[r];
        vtgt[4] += hi.x * JpJd[r]; vtgt[5] += hi.y * JpJd[r];
        vtgt[6] += hi.z * JpJd[r]; vtgt[7] += hi.w * JpJd[r];
      }
    }
    // task (point, c): c < 4 Hcd[c]; c == 4 Hdd, bd, has_res
    for (int task = t; task < 5 * n; task += NP) {
      const int q = task / 5, c = task - q * 5;
      const float* c7 = cs + q * F * NCS;
      if (c < 4) {
        float s = 0.f;
        for (int g = 0; g < F; ++g) s += c7[g * NCS + 2 + c];
        vt[c * VS + q] = s;
      } else {
        float Hdd = 0.f, bd = 0.f, hasr = 0.f;
        for (int g = 0; g < F; ++g) {
          Hdd += c7[g * NCS];
          bd += c7[g * NCS + 1];
          hasr = fmaxf(hasr, c7[g * NCS + 6]);
        }
        const float idq = A.idep[p0 + q], izq = A.idz[p0 + q];
        const float prior = A.ptprior[p0 + q] * A.prior_fac;
        float Hdd_full = Hdd + prior;
        if (Hdd_full < 1e-10f) Hdd_full = 1e-10f;
        sr[q] = Hdd_full;
        sr[PB + q] = hasr > 0.5f ? 1.f / Hdd_full : 0.f;
        sr[2 * PB + q] = A.shift_flag ? bd + prior * (idq - izq) : bd;
        sr[3 * PB + q] = hasr;
        has_s[q] = hasr > 0.5f ? 1 : 0;
      }
    }
  } else if (t >= MAXPAIRS && t < MAXPAIRS + NP) {
    // column i of a point's host part by thread (point, i mod F): frames
    // then rows in order
    const int t2 = t - MAXPAIRS;
    const int q = t2 / F, i0 = t2 - q * F;
    if (q < n) {
      const int hq = h_tab[q];
      for (int i = i0; i < 8; i += F) {
        float s = 0.f;
#pragma unroll 4
        for (int g = 0; g < F; ++g) {
          const float* a = adh_s + (hq * F + g) * ADS;
          const float* jg = jp + (q * F + g) * 8;
#pragma unroll
          for (int r = 0; r < 8; ++r) s += a[r * 8 + i] * jg[r];
        }
        vh[q * 8 + i] = s;
      }
    }
  }
  __syncthreads();
  if (valid) {
    const float oh = (f == hraw) ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      vt[(4 + 8 * f + i) * VS + pl] = vtgt[i] + oh * vh[pl * 8 + i];
  }
  __syncthreads();

  // ---- write: rows of consecutive points ----
  const int lg = PB == 32 ? 5 : 3;   // PB is 32 or 8
  for (int q = t; q < D * PB; q += NT) {
    const int d = q >> lg, c = q & (PB - 1);
    if (c < n) A.vout[(size_t)d * P + p0 + c] = vt[d * VS + c];
  }
  for (int q = t; q < 4 * PB; q += NT) {
    const int d = q >> lg, c = q & (PB - 1);
    if (c < n) A.srows[(size_t)d * P + p0 + c] = sr[q];
  }
  if (t < NP) {
    const int g = t >> lg, c = t & (PB - 1);
    if (c < n) {
      const size_t o = (size_t)g * P + p0 + c;
      A.energy[o] = en[t];
      A.energy_raw[o] = er[t];
      A.state[o] = st_s[t];
      A.active[o] = act_s[t];
    }
  }
  if (t < n) A.has_res[p0 + t] = has_s[t];

  // ---- cells: the pairs' terms summed over the block's points of each
  // host, in point order. Item w = target * 91 + entry is also its offset
  // in a point's row of gs; a thread walks the points once for two items,
  // w and w + NT: two independent chains of adds ----
  for (int w = t; w < NE * F; w += 2 * NT) {
    const bool two = w + NT < NE * F;
    const int w2 = two ? w + NT : w;
    float* out = A.part_top + (size_t)blockIdx.x * F * F * NE;
    for (int h = 0; h < F; ++h) {
      float acc1 = 0.f, acc2 = 0.f;
#pragma unroll 4
      for (int j = seg[h]; j < seg[h + 1]; ++j) {
        const float* row = gs + order[j] * F * NE;
        acc1 += row[w];
        acc2 += row[w2];
      }
      out[(size_t)h * F * NE + w] = acc1;
      if (two) out[(size_t)h * F * NE + w2] = acc2;
    }
  }

  // ---- schur: v_i HdiF v_j over the block's points in point order; one
  // thread per 2 x 4 tile of H_sc that reaches the diagonal or above (its
  // 6 rows of v and HdiF are read once for 8 entries), then b_sc ----
  {
    const int n_sc = D * (D + 1) / 2 + D;
    float* out = A.part_sc + (size_t)blockIdx.x * n_sc;
    const float* hdif = sr + PB;
    const float* bdf = sr + 2 * PB;
    // D = 4 + 8 F: TC whole tile columns; tile rows 2k and 2k + 1 start at
    // tile column k, so the tiles on or above the diagonal are TC (TC + 1)
    const int TC = D / 4;
    for (int task = t; task < TC * (TC + 1); task += NT) {
      int k = 0, rem = task;
      while (rem >= 2 * (TC - k)) { rem -= 2 * (TC - k); ++k; }
      const int second = rem < TC - k ? 0 : 1;   // tile row 2k or 2k + 1
      const int i0 = 2 * (2 * k + second);
      const int j0 = 4 * (k + rem - second * (TC - k));
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        const float hd = hdif[c];
        const float w0 = vt[i0 * VS + c] * hd;
        const float w1 = vt[(i0 + 1) * VS + c] * hd;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = vt[(j0 + q) * VS + c];
          acc[0][q] += w0 * x;
          acc[1][q] += w1 * x;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q >= i0 + r)
            out[tri(i0 + r, j0 + q, D + 1)] = acc[r][q];
    }
    for (int i = t; i < D; i += NT) {
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < n; ++c) acc += (vt[i * VS + c] * hdif[c]) * bdf[c];
      out[tri(i, D, D + 1)] = acc;
    }
  }
}

// One thread per entry of acc (F,F,13,13), then of [H_sc | b_sc] (D,D+1):
// the blocks' partial sums added in block order, symmetric halves
// mirrored; b_sc also lands in its own contiguous (D,) output.
__global__ void block_sum_kernel(const float* __restrict__ part_top,
                                 const float* __restrict__ part_sc, int NB,
                                 int F, float* __restrict__ acc,
                                 float* __restrict__ hsc,
                                 float* __restrict__ bsc) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int D = 4 + 8 * F;
  const int n_top = F * F * NG * NG;
  const int n_hsc = D * (D + 1);
  if (idx < n_top) {
    const int cell = idx / (NG * NG), r = idx - cell * NG * NG;
    const int a = r / NG, b = r - a * NG;
    const int lo = min(a, b), hi = max(a, b);
    const float* src = part_top + (size_t)cell * NE + tri(lo, hi, NG);
    const size_t stride = (size_t)F * F * NE;
    float s = 0.f;
#pragma unroll 32
    for (int k = 0; k < NB; ++k) s += src[k * stride];
    acc[idx] = s;
  } else if (idx < n_top + n_hsc) {
    const int q = idx - n_top;
    const int i = q / (D + 1), j = q - i * (D + 1);
    const int lo = j < D ? min(i, j) : i, hi = j < D ? max(i, j) : D;
    const size_t stride = (size_t)(D * (D + 1) / 2 + D);
    const float* src = part_sc + tri(lo, hi, D + 1);
    float s = 0.f;
#pragma unroll 32
    for (int k = 0; k < NB; ++k) s += src[k * stride];
    hsc[q] = s;
    if (j == D) bsc[i] = s;
  }
}

// Floats of the partial-sum scratch `part` at P points, F frames.
extern "C" int ba_fused_part_floats(int P, int F) {
  const int PB = points_per_block(F), D = 4 + 8 * F;
  const int NB = (P + PB - 1) / PB;
  return NB * (F * F * NE + D * (D + 1) / 2 + D);
}

extern "C" int launch_ba_fused(
    const float* hit, const float* okf, const float* u, const float* v,
    const float* idep, const float* idz, const float* ptprior,
    const unsigned char* ptvalid, const unsigned char* pmask,
    const float* color, const float* wpat, const int* host,
    const unsigned char* res_exist, const signed char* res_state,
    const float* R0, const float* t0, const float* affLL, const float* c,
    const float* c_zero, const float* b0, const float* eth,
    const unsigned char* fvalid, const float* adHTdelta, const float* adHost,
    const float* adTarget, int P, int F, int use_rz, int shift_flag,
    float prior_fac, float huber, float oc, float wlim, float hlim,
    float* part, float* vout, float* srows, float* energy, float* energy_raw,
    signed char* state, unsigned char* active, unsigned char* has_res,
    float* acc, float* hsc, float* bsc, void* stream) {
  if (F > MAXF || F < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int PB = points_per_block(F), D = 4 + 8 * F;
  const int NB = (P + PB - 1) / PB;
  K3Args A;
  A.hit = hit; A.okf = okf; A.u = u; A.v = v; A.idep = idep; A.idz = idz;
  A.ptprior = ptprior; A.ptvalid = ptvalid; A.pmask = pmask;
  A.color = color; A.wpat = wpat; A.host = host; A.res_exist = res_exist;
  A.res_state = res_state; A.R0 = R0; A.t0 = t0; A.aff = affLL; A.c = c;
  A.c_zero = c_zero; A.b0 = b0; A.eth = eth; A.fvalid = fvalid;
  A.dpt = adHTdelta; A.adH = adHost; A.adT = adTarget;
  A.P = P; A.F = F; A.use_rz = use_rz; A.shift_flag = shift_flag;
  A.prior_fac = prior_fac; A.huber = huber; A.oc = oc; A.wlim = wlim;
  A.hlim = hlim;
  A.part_top = part;
  A.part_sc = part + (size_t)NB * F * F * NE;
  A.vout = vout; A.srows = srows; A.energy = energy;
  A.energy_raw = energy_raw; A.state = state; A.active = active;
  A.has_res = has_res;
  const size_t smem = (size_t)smem_layout(F).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ba_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ba_block_kernel<<<NB, NT, smem, st>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_out = F * F * NG * NG + D * (D + 1);
  block_sum_kernel<<<(n_out + 127) / 128, 128, 0, st>>>(
      A.part_top, A.part_sc, NB, F, acc, hsc, bsc);
  return (int)cudaGetLastError();
}
