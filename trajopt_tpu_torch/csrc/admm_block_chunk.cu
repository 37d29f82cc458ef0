// Fused block-banded prox-ADMM chunk for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel trajopt_tpu/qp/pallas_block.py
// (_build_chunk_fn, body _chunk_and_check over _iter_chunk): `n_iters`
// relaxed prox-ADMM iterations on the block-banded QP, then the OSQP
// residual statistics, in the same update order:
//
//   rhs = sigma x - q + C'(rho_c zc - yc) + b (rho_b zb - yb)
//   xt  = Minv rhs                     (dense [n, n])
//   ztc = C xt,  ztb = b xt
//   x   = alpha xt + (1 - alpha) x
//   zr  = alpha zt + (1 - alpha) z
//   zc' = softclamp(zrc + yc / rho_c; l, u, c / rho_c),  zb' = clip(zrb + yb / rho_b; lb, ub)
//   y   = y + rho (zr - z')
//
// stats[b] = (pri, dua, ||Ax||, ||z||, max(||Px||, ||A'y||)) in the scaled
// units of pallas_block._chunk_and_check.  Rows are in the block order of
// block_banded.py: C is Wb [T, R, K*D], row (t, r) covers columns
// [t*D, (t+K)*D).  The Mosaic-forced slot-major layout and one-hot segment
// matmuls of the TPU kernel are gone.
//
// Design: one thread block per problem, the n_iters loop inside the block.
// The banded weights (T*R*K*D floats, 76.8 KB at the flagship T=30, R=40,
// K*D=16) live in shared memory with an odd row stride so the row-owned
// C product is free of bank conflicts; the dual, rhs and xt vectors are
// shared too.  Row state (zc, yc, l, u, c/rho, rho) and column state
// (x, zb, yb, q, lb, ub, b) stay in registers of the thread that owns the
// row or column.  Three __syncthreads per iteration.
//
// What bounds it: Minv does not fit.  At n = 240 it is 230,400 B in f32
// and a block may use at most 232,448 B of shared memory, so it cannot
// sit beside the weights; it is re-read from global memory (L2 when it
// stays resident) on every iteration, one warp per row with coalesced
// loads.  At the flagship B = 256 that streams 150 x 59 MB per chunk,
// ~2.6 ms at 3.35 TB/s, against ~0.11 ms for the chunk's ~7.4 GFLOP
// (fused_block.chunk_flops) at the fp32 peak, which is the bound: the
// chunk is compute-bound once Minv stays on chip.  Keeping it there is
// later work: a 2-CTA cluster holding 120 rows each and exchanging xt
// halves through distributed shared memory, or Minv held in registers
// across the block.
//
// NaN: every max/min/clip propagates NaN (fmaxf/fminf would drop it), so
// a blown-up QP reports NaN statistics and reads as not converged, as the
// JAX version does.  Infinite c/rho on hard rows and inert padded rows
// (l = -inf, u = +inf, W = 0) stay exact: max(u, v - inf) = u and
// min(l, v + inf) = l.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_COLS = 2;      // columns per thread: n <= 512
constexpr int MAX_ROWS = 8;      // rows per thread: T*R <= 2048

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;   // NaN-propagating max
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;   // NaN-propagating min
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = pmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dst[i] = A[i, :] . v for the n rows of a row-major [n, n] matrix in
// global memory; one warp per row, lanes stride the columns.
__device__ __forceinline__ void dense_matvec(const float* __restrict__ A,
                                             const float* v, float* dst,
                                             int n, int warp, int lane) {
  for (int i = warp; i < n; i += NWARP) {
    const float* row = A + (size_t)i * n;
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += __ldg(row + j) * v[j];
    s = warp_sum(s);
    if (lane == 0) dst[i] = s;
  }
}

struct Args {
  const float *Minv, *Wb, *P, *q, *lc, *uc, *cr, *rho_c, *lb, *ub, *bd;
  const float *Ec, *Eb, *Dd, *cobj;
  const float *x, *zc, *zb, *yc, *yb;
  float *x_o, *zc_o, *zb_o, *yc_o, *yb_o, *stats;
  const int32_t* active;
  int T, D, K, R;
  float sigma, alpha, rho_b;
  int n_iters;
};

__global__ void __launch_bounds__(NT, 2) admm_block_chunk_kernel(Args a) {
  const int b = blockIdx.x;
  if (a.active != nullptr && a.active[b] == 0) return;
  const int T = a.T, D = a.D, K = a.K, R = a.R;
  const int KD = K * D, KDp = KD | 1;  // odd smem row stride
  const int n = T * D, m = T * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float sm[];
  float* sW = sm;                 // [m, KDp]
  float* sw = sW + (size_t)m * KDp;  // [m]  dual-side vector
  float* srhs = sw + m;           // [n]
  float* sxt = srhs + n;          // [n]
  float* sred = sxt + n;          // [NWARP, 5]

  const float* Wg = a.Wb + (size_t)b * m * KD;
  for (int i = tid; i < m * KD; i += NT) {
    const int r = i / KD, c = i - r * KD;
    sW[r * KDp + c] = Wg[i];
  }
  const float* Minv = a.Minv + (size_t)b * n * n;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;

  float cx[MAX_COLS], czb[MAX_COLS], cyb[MAX_COLS], cq[MAX_COLS];
  float clb[MAX_COLS], cub[MAX_COLS], cbd[MAX_COLS];
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    const int j = tid + c * NT;
    if (j < n) {
      cx[c] = a.x[bn + j]; czb[c] = a.zb[bn + j]; cyb[c] = a.yb[bn + j];
      cq[c] = a.q[bn + j]; clb[c] = a.lb[bn + j]; cub[c] = a.ub[bn + j];
      cbd[c] = a.bd[bn + j];
    }
  }
  float rzc[MAX_ROWS], ryc[MAX_ROWS], rl[MAX_ROWS], ru[MAX_ROWS];
  float rcr[MAX_ROWS], rrho[MAX_ROWS];
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    if (r < m) {
      rzc[k] = a.zc[bm + r]; ryc[k] = a.yc[bm + r]; rl[k] = a.lc[bm + r];
      ru[k] = a.uc[bm + r]; rcr[k] = a.cr[bm + r]; rrho[k] = a.rho_c[bm + r];
    }
  }
  const float sigma = a.sigma, alpha = a.alpha, rho_b = a.rho_b;
  const float inv_rho_b = 1.0f / rho_b, one_m_alpha = 1.0f - alpha;
  __syncthreads();

  for (int it = 0; it < a.n_iters; ++it) {
    // dual-side vector w = rho_c zc - yc (row-owned)
#pragma unroll
    for (int k = 0; k < MAX_ROWS; ++k) {
      const int r = tid + k * NT;
      if (r < m) sw[r] = rrho[k] * rzc[k] - ryc[k];
    }
    __syncthreads();
    // rhs (column-owned): column j = t*D + d is part k of step t - k
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
      const int j = tid + c * NT;
      if (j < n) {
        const int t = j / D, d = j - t * D;
        float acc = 0.f;
        for (int kk = 0; kk < K; ++kk) {
          const int tt = t - kk;
          if (tt < 0) break;
          const float* wrow = sW + (size_t)tt * R * KDp + kk * D + d;
          const float* wv = sw + tt * R;
          for (int rr = 0; rr < R; ++rr) acc += wrow[rr * KDp] * wv[rr];
        }
        srhs[j] = sigma * cx[c] - cq[c] + acc
                  + cbd[c] * (rho_b * czb[c] - cyb[c]);
      }
    }
    __syncthreads();
    dense_matvec(Minv, srhs, sxt, n, warp, lane);
    __syncthreads();
    // column updates: x, zb, yb
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
      const int j = tid + c * NT;
      if (j < n) {
        const float xt = sxt[j];
        const float ztb = cbd[c] * xt;
        cx[c] = alpha * xt + one_m_alpha * cx[c];
        const float zrb = alpha * ztb + one_m_alpha * czb[c];
        const float zbn = pmin(cub[c], pmax(clb[c], zrb + cyb[c] * inv_rho_b));
        cyb[c] = cyb[c] + rho_b * (zrb - zbn);
        czb[c] = zbn;
      }
    }
    // row updates: zc, yc (C xt through the row's K*D window)
#pragma unroll
    for (int k = 0; k < MAX_ROWS; ++k) {
      const int r = tid + k * NT;
      if (r < m) {
        const int t = r / R;
        const float* wr = sW + (size_t)r * KDp;
        const int c0 = t * D;
        const int cend = min(KD, n - c0);
        float ztc = 0.f;
        for (int cc = 0; cc < cend; ++cc) ztc += wr[cc] * sxt[c0 + cc];
        const float zrc = alpha * ztc + one_m_alpha * rzc[k];
        const float v = zrc + ryc[k] * (1.0f / rrho[k]);
        float zn;
        if (v > ru[k]) zn = pmax(ru[k], v - rcr[k]);
        else if (v < rl[k]) zn = pmin(rl[k], v + rcr[k]);
        else zn = v;
        ryc[k] = ryc[k] + rrho[k] * (zrc - zn);
        rzc[k] = zn;
      }
    }
    // next iteration's first write (sw) is ordered after this iteration's
    // reads of sw by the two barriers above; sxt likewise.
  }

  // ---- residual statistics ----
  __syncthreads();
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    const int j = tid + c * NT;
    if (j < n) sxt[j] = cx[c];
  }
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    if (r < m) sw[r] = ryc[k];
  }
  __syncthreads();
  dense_matvec(a.P + (size_t)b * n * n, sxt, srhs, n, warp, lane);  // Px
  __syncthreads();

  const float cobj = a.cobj[b];
  float pri = 0.f, dua = 0.f, axn = 0.f, zn = 0.f, pan = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    if (r < m) {
      const int t = r / R;
      const float* wr = sW + (size_t)r * KDp;
      const int c0 = t * D;
      const int cend = min(KD, n - c0);
      float cxr = 0.f;
      for (int cc = 0; cc < cend; ++cc) cxr += wr[cc] * sxt[c0 + cc];
      const float e = a.Ec[bm + r];
      pri = pmax(pri, fabsf((cxr - rzc[k]) / e));
      axn = pmax(axn, fabsf(cxr / e));
      zn = pmax(zn, fabsf(rzc[k] / e));
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    const int j = tid + c * NT;
    if (j < n) {
      const int t = j / D, d = j - t * D;
      float aty = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const int tt = t - kk;
        if (tt < 0) break;
        const float* wrow = sW + (size_t)tt * R * KDp + kk * D + d;
        const float* wv = sw + tt * R;
        for (int rr = 0; rr < R; ++rr) aty += wrow[rr * KDp] * wv[rr];
      }
      aty += cbd[c] * cyb[c];
      const float bx = cbd[c] * cx[c];
      const float eb = a.Eb[bn + j];
      const float inv_cD = 1.0f / (cobj * a.Dd[bn + j]);
      const float px = srhs[j];
      pri = pmax(pri, fabsf((bx - czb[c]) / eb));
      axn = pmax(axn, fabsf(bx / eb));
      zn = pmax(zn, fabsf(czb[c] / eb));
      dua = pmax(dua, fabsf((px + cq[c] + aty) * inv_cD));
      pan = pmax(pan, pmax(fabsf(px * inv_cD), fabsf(aty * inv_cD)));
    }
  }
  pri = warp_max(pri); dua = warp_max(dua); axn = warp_max(axn);
  zn = warp_max(zn); pan = warp_max(pan);
  if (lane == 0) {
    sred[warp * 5 + 0] = pri; sred[warp * 5 + 1] = dua;
    sred[warp * 5 + 2] = axn; sred[warp * 5 + 3] = zn;
    sred[warp * 5 + 4] = pan;
  }
  __syncthreads();
  if (tid < 5) {
    float v = sred[tid];
    for (int w = 1; w < NWARP; ++w) v = pmax(v, sred[w * 5 + tid]);
    a.stats[(size_t)b * 5 + tid] = v;
  }

#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    const int j = tid + c * NT;
    if (j < n) {
      a.x_o[bn + j] = cx[c]; a.zb_o[bn + j] = czb[c]; a.yb_o[bn + j] = cyb[c];
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    if (r < m) { a.zc_o[bm + r] = rzc[k]; a.yc_o[bm + r] = ryc[k]; }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs for a problem shape.
size_t admm_block_chunk_smem(int T, int D, int K, int R) {
  const int n = T * D, m = T * R, KDp = (K * D) | 1;
  return sizeof(float) * ((size_t)m * KDp + m + 2 * (size_t)n + NWARP * 5);
}

int admm_block_chunk_limits(int* threads, int* max_cols, int* max_rows) {
  *threads = NT; *max_cols = MAX_COLS; *max_rows = MAX_ROWS;
  return 0;
}

// Launch one chunk on `stream` for B problems.  `active` may be null; a
// problem with active[b] == 0 is skipped and its outputs are not written.
// Returns cudaGetLastError() after the launch.
int admm_block_chunk(const void* Minv, const void* Wb, const void* P,
                     const void* q, const void* lc, const void* uc,
                     const void* cr, const void* rho_c, const void* lb,
                     const void* ub, const void* bd, const void* Ec,
                     const void* Eb, const void* Dd, const void* cobj,
                     const void* x, const void* zc, const void* zb,
                     const void* yc, const void* yb, void* x_o, void* zc_o,
                     void* zb_o, void* yc_o, void* yb_o, void* stats,
                     const void* active, int B, int T, int D, int K, int R,
                     float sigma, float alpha, float rho_b, int n_iters,
                     void* stream) {
  Args a;
  a.Minv = (const float*)Minv; a.Wb = (const float*)Wb; a.P = (const float*)P;
  a.q = (const float*)q; a.lc = (const float*)lc; a.uc = (const float*)uc;
  a.cr = (const float*)cr; a.rho_c = (const float*)rho_c;
  a.lb = (const float*)lb; a.ub = (const float*)ub; a.bd = (const float*)bd;
  a.Ec = (const float*)Ec; a.Eb = (const float*)Eb; a.Dd = (const float*)Dd;
  a.cobj = (const float*)cobj;
  a.x = (const float*)x; a.zc = (const float*)zc; a.zb = (const float*)zb;
  a.yc = (const float*)yc; a.yb = (const float*)yb;
  a.x_o = (float*)x_o; a.zc_o = (float*)zc_o; a.zb_o = (float*)zb_o;
  a.yc_o = (float*)yc_o; a.yb_o = (float*)yb_o; a.stats = (float*)stats;
  a.active = (const int32_t*)active;
  a.T = T; a.D = D; a.K = K; a.R = R;
  a.sigma = sigma; a.alpha = alpha; a.rho_b = rho_b; a.n_iters = n_iters;
  const size_t smem = admm_block_chunk_smem(T, D, K, R);
  cudaError_t e = cudaFuncSetAttribute(
      admm_block_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  admm_block_chunk_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
