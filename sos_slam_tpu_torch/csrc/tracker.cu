// K5: the coarse tracker's Levenberg-Marquardt trip (ops/tracker.py
// track_level) as two kernels — `track_res_kernel`, the residual,
// Jacobian and normal sums of one pass over a level's template for K
// hypotheses, and `track_step_kernel`, the rest of the trip: the accept
// test, the lambda schedule, the selects, and the next trial's damped 8x8
// solve and SE(3) exponential (reference CoarseTracker::calcResPose /
// calcGSSSEPose / trackNewestCoarse, CoarseTracker.cpp:366-764).
//
// Replaces no TPU kernel: the JAX package's tracker is plain XLA, fused
// by its compiler. Its plain PyTorch form went out as ~300 separate
// kernels a trip (the residual pass ~140-200, the solve and exponential
// ~110, the selects and in-place copies ~40), each ~1.8 us on the card
// whatever its size, ~0.5 ms a trip, ~15 trips a frame, the whole track
// again in the 5-wide retry.
//
// Bound on the card: launches. A pass at level 0 reads at most 16,384
// template points (17 bytes each) and four bilinear taps of 12 bytes, ~1
// MB, ~0.3 us at 3.35 TB/s (the level's [I, dx, dy] map, 3.7 MB, stays in
// L2); the normal sums are ~45 multiply-adds a point. What the design does
// about it:
//   * one launch a pass: a block takes K5_THREADS x K5_PPT points of one
//     hypothesis (grid: point blocks x K), sums in registers, warp
//     shuffles and shared memory, and writes one row of partials; the last
//     block of a hypothesis to finish (an integer ticket, no float atomics)
//     sums the rows in block order and writes the hypothesis' record, so
//     every sum repeats bit for bit from run to run, eager or replayed;
//   * one launch for the rest of the trip: one block, a thread a
//     hypothesis, updates the LM state in place (a CUDA graph's WHILE body
//     keeps the buffers it captured), writes the loop's condition as one
//     device bool (no reduction kernel for it) and forms the next trial,
//     which the next pass reads;
//   * the affine transfer is formed inside the pass from the trial's
//     affine parameters, the reference's and the exposures.
// The arithmetic follows the plain form op for op (and -fmad=false keeps
// each rounding): the same masks, NaN rules (a NaN coordinate samples
// corner 0, a non-finite Jacobian spoils the normal sums as the plain
// product does, a singular system gives NaN and a non-finite increment
// becomes 0), thresholds and float32 throughout; only the order of the
// sums over points differs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// a track_res block: K5_THREADS threads of K5_PPT template points each;
// the track_step block
#define K5_THREADS 256
#define K5_PPT 2
#define K5_STEP_THREADS 128
// a block's row of partials: E, num_in, num_sat, active count, the 44
// entries (i <= j, i < 8, j <= 8) of [J r]^T W [J r], the two flow sums and
// the flow points
#define K5_PART 51
#define K5_P_M 4
#define K5_P_FLOW 48
// a hypothesis' record of one pass (floats)
#define K5_REC 80
#define K5_R_E 0
#define K5_R_IN 1
#define K5_R_SAT 2
#define K5_R_FT 3
#define K5_R_FRT 4
#define K5_R_B 5
#define K5_R_H 13
// a hypothesis' LM state (floats)
#define K5_ST 96
#define K5_S_IT 0
#define K5_S_DONE 1
#define K5_S_LAM 2
#define K5_S_E 3
#define K5_S_NUM 4
#define K5_S_RMS 5
#define K5_S_AFF 6
#define K5_S_T 8
#define K5_S_B 24
#define K5_S_H 32
// a hypothesis' trial: the pose and affine parameters the next pass
// reads, and the norm of the increment that made them
#define K5_TRI 20
#define K5_X_T 0
#define K5_X_AFF 16
#define K5_X_INC 18

__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// the squared pixel shift of point (u, v) moved to p (flow indicators)
__device__ __forceinline__ float shift2(float p0, float p1, float p2, float fx,
                                        float fy, float cx, float cy, float u,
                                        float v) {
  const float uu = fx * (p0 / p2) + cx;
  const float vv = fy * (p1 / p2) + cy;
  return sq(uu - u) + sq(vv - v);
}

__global__ void __launch_bounds__(K5_THREADS)
track_res_kernel(const float* __restrict__ dI, int h, int w,
                 const float* __restrict__ tu, const float* __restrict__ tv,
                 const float* __restrict__ tid_, const float* __restrict__ tc,
                 const bool* __restrict__ tvalid, int n,
                 const float* __restrict__ T, int t_stride,
                 const float* __restrict__ aff, int aff_stride,
                 const float* __restrict__ ref_aff,
                 const float* __restrict__ exposures, int transfer,
                 const float* __restrict__ cutoff, float fx, float fy,
                 float cx, float cy, float huber, float huber_sq, int flow,
                 float* __restrict__ partials, int* __restrict__ tickets,
                 float* __restrict__ rec) {
  const int k = blockIdx.y;
  const int nb = gridDim.x;
  const float* Tk = T + (size_t)k * t_stride;
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = Tk[i * 4 + j];
    t[i] = Tk[i * 4 + 3];
  }
  // the affine transfer [a, b] (aff_from_to), or given
  float a_t, b_t;
  const float* ak = aff + (size_t)k * aff_stride;
  if (transfer) {
    a_t = ak[0];
    b_t = ak[1];
  } else {
    float ef = exposures[0], et = exposures[1];
    ef = ef == 0.f ? 1.f : ef;
    et = et == 0.f ? 1.f : et;
    a_t = expf(ak[0] - ref_aff[0]) * et / ef;
    b_t = ak[1] - a_t * ref_aff[1];
  }
  const float ref_b0 = ref_aff[1];
  const float cut = cutoff[k];
  const float max_e = (2.f * huber) * cut - huber_sq;
  const float wmax = (float)(w - 3), hmax = (float)(h - 3);
  const float wc = (float)(w - 2), hc = (float)(h - 2);

  float acc[K5_PART];
#pragma unroll
  for (int i = 0; i < K5_PART; ++i) acc[i] = 0.f;

  const int base = blockIdx.x * (K5_THREADS * K5_PPT) + threadIdx.x;
#pragma unroll
  for (int q = 0; q < K5_PPT; ++q) {
    const int i = base + q * K5_THREADS;
    if (i >= n) break;
    const float u = tu[i], v = tv[i], id = tid_[i], col = tc[i];
    const bool valid = tvalid[i];
    const float xn0 = (u - cx) / fx, xn1 = (v - cy) / fy;
    const float r0 = R[0] * xn0 + R[1] * xn1 + R[2];
    const float r1 = R[3] * xn0 + R[4] * xn1 + R[5];
    const float r2 = R[6] * xn0 + R[7] * xn1 + R[8];
    const float d0 = t[0] * id, d1 = t[1] * id, d2 = t[2] * id;
    const float p0 = r0 + d0, p1 = r1 + d1, p2 = r2 + d2;
    const float u_ = p0 / p2, v_ = p1 / p2;
    const float Ku = fx * u_ + cx, Kv = fy * v_ + cy;
    const float nid = id / p2;
    bool inb = valid && Ku > 2.f && Kv > 2.f && Ku < wmax && Kv < hmax
        && nid > 0.f;
    // bilinear taps with image.py _corners' clamping (NaN -> corner 0)
    float fu = floorf(Ku), fv = floorf(Kv);
    fu = fu != fu ? 0.f : fu;
    fv = fv != fv ? 0.f : fv;
    const int x0 = (int)fminf(fmaxf(fu, 0.f), wc);
    const int y0 = (int)fminf(fmaxf(fv, 0.f), hc);
    const float dx = clamp_keep_nan(Ku - (float)x0, 0.f, 1.f);
    const float dy = clamp_keep_nan(Kv - (float)y0, 0.f, 1.f);
    const float* c0 = dI + ((size_t)y0 * w + x0) * 3;
    const float* c2 = c0 + (size_t)w * 3;
    float hit[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      hit[c] = c0[c] * (1.f - dx) * (1.f - dy) + c0[3 + c] * dx * (1.f - dy)
          + c2[c] * (1.f - dx) * dy + c2[3 + c] * dx * dy;
    inb = inb && isfinite(hit[0]);
    const float r = hit[0] - (a_t * col + b_t);
    const float abs_r = fabsf(r);
    const float hw = abs_r < huber ? 1.f
        : huber / (abs_r != abs_r ? abs_r : fmaxf(abs_r, 1e-9f));
    const bool sat = inb && abs_r > cut;
    const bool act = inb && !sat;
    acc[0] += sat ? max_e : (act ? hw * r * r * (2.f - hw) : 0.f);
    acc[1] += inb ? 1.f : 0.f;
    acc[2] += sat ? 1.f : 0.f;
    acc[3] += act ? 1.f : 0.f;

    const float dxf = hit[1] * fx, dyf = hit[2] * fy;
    float J[9];
    J[0] = nid * dxf;
    J[1] = nid * dyf;
    J[2] = -nid * (u_ * dxf + v_ * dyf);
    J[3] = -(u_ * v_ * dxf + dyf * (1.f + v_ * v_));
    J[4] = u_ * v_ * dyf + dxf * (1.f + u_ * u_);
    J[5] = u_ * dyf - v_ * dxf;
    J[6] = a_t * (ref_b0 - col);
    J[7] = -1.f;
    J[8] = r;
    const float wt = act ? hw : 0.f;
    int m = K5_P_M;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float wj = J[a] * wt;
#pragma unroll
      for (int b = a; b < 9; ++b) acc[m++] += wj * J[b];
    }
    if (flow) {
      const bool stride = valid && (i % 32) == 0;
      if (stride) {
        acc[K5_P_FLOW] += shift2(xn0 + d0, xn1 + d1, 1.f + d2, fx, fy, cx, cy,
                                 u, v)
            + shift2(xn0 - d0, xn1 - d1, 1.f - d2, fx, fy, cx, cy, u, v);
        acc[K5_P_FLOW + 1] += shift2(p0, p1, p2, fx, fy, cx, cy, u, v)
            + shift2(r0 - d0, r1 - d1, r2 - d2, fx, fy, cx, cy, u, v);
        acc[K5_P_FLOW + 2] += 1.f;
      }
    }
  }

  // the block's sums: warp trees, then the warps in order
  __shared__ float warp_sums[K5_THREADS / 32][K5_PART];
  __shared__ float sums[K5_PART];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < K5_PART; ++i) {
    float x = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) warp_sums[warp][i] = x;
  }
  __syncthreads();
  float* row = partials + ((size_t)k * nb + blockIdx.x) * K5_PART;
  if (threadIdx.x < K5_PART) {
    float x = warp_sums[0][threadIdx.x];
    for (int q = 1; q < K5_THREADS / 32; ++q) x += warp_sums[q][threadIdx.x];
    row[threadIdx.x] = x;
  }
  // the last block of hypothesis k sums the rows in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + k, 1) == nb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < K5_PART) {
    const float* col = partials + (size_t)k * nb * K5_PART + threadIdx.x;
    float x = __ldcg(col);
    for (int b = 1; b < nb; ++b) x += __ldcg(col + (size_t)b * K5_PART);
    sums[threadIdx.x] = x;
  }
  __syncthreads();
  float* out = rec + (size_t)k * K5_REC;
  const float n_act = fmaxf(sums[3], 1.f);
  const int tx = threadIdx.x;
  if (tx == 0) {
    out[K5_R_E] = sums[0];
    out[K5_R_IN] = sums[1];
    out[K5_R_SAT] = sums[2];
    tickets[k] = 0;     // ready for the next pass
  } else if (tx == 1 || tx == 2) {
    out[tx == 1 ? K5_R_FT : K5_R_FRT] = flow
        ? sums[K5_P_FLOW + tx - 1] / (2.f * sums[K5_P_FLOW + 2] + 0.1f) : 0.f;
  } else if (tx >= 32 + 44 && tx < 32 + 44 + K5_REC - (K5_R_H + 64)) {
    out[K5_R_H + 64 + tx - (32 + 44)] = 0.f;     // the record's padding
  } else if (tx >= 32 && tx < 32 + 44) {
    // entry (a, b) of the upper triangle, in the partials' order
    int m = tx - 32, a = 0;
    while (m >= 9 - a) {
      m -= 9 - a;
      ++a;
    }
    const int b = a + m;
    const float x = sums[K5_P_M + tx - 32] / n_act;
    if (b == 8) {
      out[K5_R_B + a] = x;
    } else {
      out[K5_R_H + a * 8 + b] = x;
      out[K5_R_H + b * 8 + a] = x;
    }
  }
}

// The damped, scaled, masked 8x8 solve and the step (tracker.py
// _solve_damped): step (scaled, masked) and the raw increment's norm.
__device__ void solve_damped(const float* H, const float* bv, float lam,
                             int fix_a, int fix_b, float step[8],
                             float* inc_norm) {
  const float S[8] = {1.f, 1.f, 1.f, .5f, .5f, .5f, 10.f, 1000.f};
  float mk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mk[i] = 1.f;
  mk[6] = fix_a ? 0.f : 1.f;
  mk[7] = fix_b ? 0.f : 1.f;
  float A[8][8], x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float hs = H[i * 8 + j] * S[i] * S[j];
      if (i == j) hs = hs + hs * lam;
      float hl = hs * mk[i] * mk[j];
      if (i == j) hl = hl + (1.f - mk[i]);
      A[i][j] = hl;
    }
    x[i] = -(bv[i] * S[i] * mk[i]);
  }
  // LU with partial pivoting (the first largest |pivot|), as getrf; an
  // exactly zero pivot makes the system singular: NaN
  bool singular = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int p = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 8; ++r)
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        p = r;
      }
    // the swap by a scan over the rows, so every index is known at
    // compile time (the matrix stays in registers)
#pragma unroll
    for (int r = c + 1; r < 8; ++r)
      if (r == p) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float tmp = A[c][j];
          A[c][j] = A[r][j];
          A[r][j] = tmp;
        }
        const float tmp = x[c];
        x[c] = x[r];
        x[r] = tmp;
      }
    if (A[c][c] == 0.f) {
      singular = true;
      continue;
    }
    const float inv = 1.f / A[c][c];
#pragma unroll
    for (int r = c + 1; r < 8; ++r) {
      const float l = A[r][c] * inv;
#pragma unroll
      for (int j = c + 1; j < 8; ++j) A[r][j] -= l * A[c][j];
      x[r] -= l * x[c];
    }
  }
#pragma unroll
  for (int c = 7; c >= 0; --c) {
    float s = x[c];
#pragma unroll
    for (int j = c + 1; j < 8; ++j) s -= A[c][j] * x[j];
    x[c] = s / A[c][c];
  }
  const float extrap = lam < 1e-3f ? sqrtf(sqrtf(1e-3f / fmaxf(lam, 1e-12f)))
                                   : 1.f;
  float nrm = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = singular ? __int_as_float(0x7fc00000) : x[i];
    v = v * extrap;
    v = isfinite(v) ? v : 0.f;
    nrm += v * v;
    step[i] = v * S[i] * mk[i];
  }
  *inc_norm = sqrtf(nrm);
}

// T_out = exp(xi) @ T (lie.py se3_exp: the same small-angle switches)
__device__ void exp_times(const float xi[6], const float* T, float* T_out) {
  const float v0 = xi[0], v1 = xi[1], v2 = xi[2];
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-6f;
  const float th = sqrtf(fmaxf(th2, 1e-24f));
  const float A = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float B = small ? .5f - th2 / 24.f
                        : (1.f - cosf(th)) / fmaxf(th2, 1e-24f);
  const float C = small ? (1.f / 6.f) - th2 / 120.f
                        : (1.f - A) / fmaxf(th2, 1e-24f);
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float WW[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      WW[i * 3 + j] = W[i * 3] * W[j] + W[i * 3 + 1] * W[3 + j]
          + W[i * 3 + 2] * W[6 + j];
  float E[16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float tv = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.f : 0.f;
      E[i * 4 + j] = I + A * W[i * 3 + j] + B * WW[i * 3 + j];
    }
    const float V0 = (i == 0 ? 1.f : 0.f) + B * W[i * 3] + C * WW[i * 3];
    const float V1 = (i == 1 ? 1.f : 0.f) + B * W[i * 3 + 1]
        + C * WW[i * 3 + 1];
    const float V2 = (i == 2 ? 1.f : 0.f) + B * W[i * 3 + 2]
        + C * WW[i * 3 + 2];
    tv = V0 * v0 + V1 * v1 + V2 * v2;
    E[i * 4 + 3] = tv;
  }
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      T_out[i * 4 + j] = E[i * 4] * T[j] + E[i * 4 + 1] * T[4 + j]
          + E[i * 4 + 2] * T[8 + j] + E[i * 4 + 3] * T[12 + j];
}

// mode 0 (open): the state from the pass `rec` at pose T_in, affine aff_in;
// mode 1 (trip): the trial's pass `rec` accepted or not. Both then write
// the loop's condition and the next trial.
__global__ void __launch_bounds__(K5_STEP_THREADS)
track_step_kernel(int mode, int K, const float* __restrict__ rec,
                  const float* __restrict__ T_in, int t_stride,
                  const float* __restrict__ aff_in, int aff_stride,
                  float* __restrict__ st, float* __restrict__ tri,
                  bool* __restrict__ go, int max_iters, int fix_a,
                  int fix_b) {
  const float nan = __int_as_float(0x7fc00000);
  const float cap = (float)max_iters;
  bool any = false;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float* s = st + (size_t)k * K5_ST;
    float* x = tri + (size_t)k * K5_TRI;
    const float* r = rec + (size_t)k * K5_REC;
    if (mode == 0) {
      s[K5_S_IT] = 0.f;
      s[K5_S_DONE] = 0.f;
      s[K5_S_LAM] = 0.01f;
      s[K5_S_E] = r[K5_R_E];
      s[K5_S_NUM] = r[K5_R_IN];
      for (int j = 0; j < 16; ++j)
        s[K5_S_T + j] = T_in[(size_t)k * t_stride + j];
      s[K5_S_AFF] = aff_in[(size_t)k * aff_stride];
      s[K5_S_AFF + 1] = aff_in[(size_t)k * aff_stride + 1];
      for (int j = 0; j < 64; ++j) s[K5_S_H + j] = r[K5_R_H + j];
      for (int j = 0; j < 8; ++j) s[K5_S_B + j] = r[K5_R_B + j];
    } else {
      const float it = s[K5_S_IT];
      const bool done = s[K5_S_DONE] != 0.f;
      const bool active = !done && it < cap;
      const float mean_new = r[K5_R_IN] > 0.f ? r[K5_R_E] / r[K5_R_IN] : nan;
      const float mean_old = s[K5_S_NUM] > 0.f ? s[K5_S_E] / s[K5_S_NUM]
                                               : nan;
      const bool accept = active && mean_new < mean_old;
      const float lam = s[K5_S_LAM];
      const float new_lam = accept ? lam * 0.5f : fmaxf(lam * 4.f, 1e-3f);
      s[K5_S_DONE] = (done || (active && x[K5_X_INC] <= 1e-3f)) ? 1.f : 0.f;
      s[K5_S_IT] = it + (active ? 1.f : 0.f);
      if (active) s[K5_S_LAM] = new_lam;
      if (accept) {
        for (int j = 0; j < 16; ++j) s[K5_S_T + j] = x[K5_X_T + j];
        s[K5_S_AFF] = x[K5_X_AFF];
        s[K5_S_AFF + 1] = x[K5_X_AFF + 1];
        s[K5_S_E] = r[K5_R_E];
        s[K5_S_NUM] = r[K5_R_IN];
        for (int j = 0; j < 64; ++j) s[K5_S_H + j] = r[K5_R_H + j];
        for (int j = 0; j < 8; ++j) s[K5_S_B + j] = r[K5_R_B + j];
      }
    }
    const float num = s[K5_S_NUM];
    s[K5_S_RMS] = num > 0.f ? sqrtf(s[K5_S_E] / fmaxf(num, 1.f)) : nan;
    any = any || (s[K5_S_DONE] == 0.f && s[K5_S_IT] < cap);
    // the next trial
    float step[8];
    solve_damped(s + K5_S_H, s + K5_S_B, s[K5_S_LAM], fix_a, fix_b, step,
                 x + K5_X_INC);
    exp_times(step, s + K5_S_T, x + K5_X_T);
    x[K5_X_AFF] = s[K5_S_AFF] + step[6];
    x[K5_X_AFF + 1] = s[K5_S_AFF + 1] + step[7];
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) *go = any;
}

// One pass over a level's template (n points: u, v, idepth, color, valid)
// on the interleaved (h, w, 3) [I, dx, dy] map dI for K hypotheses: pose k
// at T + k * t_stride (a row-major 4x4), affine parameters at aff + k *
// aff_stride (the transfer [a, b] itself where `transfer`, else formed
// from them, ref_aff (2) and exposures (2)), cutoff (K). Writes rec (K,
// K5_REC); partials (K, blocks, K5_PART) is scratch, tickets (K) ints that
// are 0 before and after.
extern "C" int launch_track_res(const float* dI, int h, int w, const float* u,
                                const float* v, const float* idepth,
                                const float* color, const bool* valid, int n,
                                const float* T, int t_stride, const float* aff,
                                int aff_stride, const float* ref_aff,
                                const float* exposures, int transfer,
                                const float* cutoff, int K, float fx, float fy,
                                float cx, float cy, float huber,
                                float huber_sq, int flow, float* partials,
                                int* tickets, float* rec, void* stream) {
  if (n < 1 || K < 1 || K > 65535 || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  // the partials' middle axis: blocks of K5_THREADS x K5_PPT points
  const dim3 grid((n + K5_THREADS * K5_PPT - 1) / (K5_THREADS * K5_PPT), K);
  track_res_kernel<<<grid, K5_THREADS, 0, (cudaStream_t)stream>>>(
      dI, h, w, u, v, idepth, color, valid, n, T, t_stride, aff, aff_stride,
      ref_aff, exposures, transfer, cutoff, fx, fy, cx, cy, huber, huber_sq,
      flow, partials, tickets, rec);
  return (int)cudaGetLastError();
}

// The rest of an LM trip for K hypotheses (mode 1), or the loop's opening
// from the pass `rec` at T_in / aff_in (mode 0): updates st (K, K5_ST) in
// place and writes tri (K, K5_TRI) and the loop's condition `go`.
extern "C" int launch_track_step(int mode, int K, const float* rec,
                                 const float* T_in, int t_stride,
                                 const float* aff_in, int aff_stride,
                                 float* st, float* tri, bool* go,
                                 int max_iters, int fix_a, int fix_b,
                                 void* stream) {
  if (K < 1 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  track_step_kernel<<<1, K5_STEP_THREADS, 0, (cudaStream_t)stream>>>(
      mode, K, rec, T_in, t_stride, aff_in, aff_stride, st, tri, go,
      max_iters, fix_a, fix_b);
  return (int)cudaGetLastError();
}
