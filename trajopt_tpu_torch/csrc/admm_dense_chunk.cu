// Fused dense prox-ADMM chunk for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel trajopt_tpu/qp/pallas_admm.py
// (_admm_chunk_kernel, called by admm_chunk_pallas): `n_iters` relaxed
// prox-ADMM iterations on one dense QP per block, in the update order of
// admm_iter in trajopt_tpu/qp/admm.py:
//
//   rhs = sigma x - q + A'(rho z - y)
//   xt  = Minv rhs                     (Minv @ rhs, as admm_iter applies it)
//   zt  = A xt
//   x   = alpha xt + (1 - alpha) x
//   Ax  = alpha zt + (1 - alpha) Ax    (the carried relaxed A x, returned)
//   zr  = alpha zt + (1 - alpha) z
//   z'  = softclamp(zr + y / rho; l, u, c / rho)
//   y   = y + rho (zr - z')
//
// Shapes are unpadded: Minv [B, n, n], A [B, m, n], row vectors [B, m],
// column vectors [B, n].  The TPU kernel's padding to (8, 128) tiles is
// gone; the ragged edges (n not a multiple of 32) are masked.
//
// Design: one block of 512 threads per problem, the n_iters loop inside
// the block.  Row state (z, y, Ax, l, u, c/rho, rho) lives in shared
// memory, column state (x, q) in the register of the thread that owns the
// column.  Each iteration makes two passes over device memory:
//   1. xt = Minv rhs, one warp per row of Minv, coalesced loads;
//   2. one pass over the rows of A, one warp per row, that computes
//      zt_i = A_i . xt, applies the row's update, and at once adds
//      A_i' w_i (w_i = rho_i z_i - y_i, the next iteration's dual-side
//      vector) to per-lane column sums; the warps' partial sums meet in
//      shared memory.  So A is read once per iteration (and once before
//      the first, for A x and A'w), not twice as in the plain version.
// Three __syncthreads per iteration.
//
// What bounds it: neither matrix fits on chip.  At the arm7 shapes
// (n = 210, m = 449) A is 377,160 B and Minv 176,400 B in f32, against
// 232,448 B of shared memory per block, so both are streamed from device
// memory (L2 when it holds them) every iteration.  At B = 128 and 20
// iterations that is ~1.5 GB per chunk, ~0.44 ms at 3.35 TB/s, against a
// bound of ~0.02 ms (every input read once, ~71 MB; the FLOPs, ~1.2 GFLOP,
// take less at the fp32 peak).  Keeping the matrices on chip (a cluster of
// CTAs per problem sharing x~ through distributed shared memory) is later
// work.
//
// NaN: every max/min propagates NaN (fmaxf/fminf would drop it), so a
// blown-up QP stays NaN and reads as not converged, as the JAX version
// does.  Infinite c/rho on hard rows stays exact: max(u, v - inf) = u and
// min(l, v + inf) = l.  A lane with active[b] == 0 is skipped and its
// outputs are not written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int CPL = NT / 32;     // column slots per lane: n <= NT

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

// r[k] = v[lane + 32 k] (0 past n): a column vector spread over the lanes.
__device__ __forceinline__ void lane_cols(const float* v, float (&r)[CPL],
                                          int n, int lane) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    r[k] = j < n ? v[j] : 0.f;
  }
}

// dst[i] = M[i, :] . v for the rows of a row-major [rows, n] matrix in
// global memory; one warp per row, v spread over the lanes.
__device__ __forceinline__ void matvec(const float* __restrict__ M,
                                       const float (&v)[CPL], float* dst,
                                       int rows, int n, int warp, int lane) {
  for (int i = warp; i < rows; i += NWARP) {
    const float* row = M + (size_t)i * n;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      if (j < n) s += __ldg(row + j) * v[k];
    }
    s = warp_sum(s);
    if (lane == 0) dst[i] = s;
  }
}

struct Rows {            // row state in shared memory, [m] each
  float *z, *y, *ax;
  const float *l, *u, *cr, *rho;
};

// One pass over the rows of A, one warp per row: d_i = A_i . v.  With
// `first` it only sets Ax_i = d_i; otherwise d_i is zt_i and the row takes
// its relaxed update.  With `accumulate` the warp adds A_i' w_i, w_i the
// updated rho_i z_i - y_i, to its lanes' column sums, which land in
// part[warp * n + j].
__device__ __forceinline__ void row_pass(const float* __restrict__ A,
                                         const float (&v)[CPL], Rows r,
                                         float* part, int m, int n,
                                         float alpha, bool first,
                                         bool accumulate, int warp,
                                         int lane) {
  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
  const float oma = 1.f - alpha;
  for (int i = warp; i < m; i += NWARP) {
    const float* row = A + (size_t)i * n;
    float a[CPL];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      a[k] = j < n ? __ldg(row + j) : 0.f;
      s += a[k] * v[k];
    }
    float zi = r.z[i], yi = r.y[i], axi = r.ax[i];
    const float rho = r.rho[i];
    s = warp_sum(s);
    if (first) {
      axi = s;
    } else {
      axi = alpha * s + oma * axi;
      const float zr = alpha * s + oma * zi;
      const float vv = zr + yi / rho;
      const float lo = r.l[i], hi = r.u[i];
      float zn;
      if (vv > hi) zn = pmax(hi, vv - r.cr[i]);
      else if (vv < lo) zn = pmin(lo, vv + r.cr[i]);
      else zn = vv;
      yi = yi + rho * (zr - zn);
      zi = zn;
    }
    __syncwarp();        // every lane has read row i before lane 0 writes
    if (lane == 0) {
      r.ax[i] = axi;
      r.z[i] = zi;
      r.y[i] = yi;
    }
    if (accumulate) {
      const float w = rho * zi - yi;
#pragma unroll
      for (int k = 0; k < CPL; ++k) acc[k] += a[k] * w;
    }
  }
  if (accumulate) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      if (j < n) part[warp * n + j] = acc[k];
    }
  }
}

struct Args {
  const float *Minv, *A, *q, *l, *u, *cr, *rho, *x, *z, *y;
  float *x_o, *z_o, *y_o, *ax_o;
  const int32_t* active;
  int m, n;
  float sigma, alpha;
  int n_iters;
};

__global__ void __launch_bounds__(NT, 1) admm_dense_chunk_kernel(Args a) {
  const int b = blockIdx.x;
  if (a.active != nullptr && a.active[b] == 0) return;
  const int m = a.m, n = a.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float sm[];
  float* sz = sm;                 // [m] each: z, y, Ax, l, u, c/rho, rho
  float* sy = sz + m;
  float* sax = sy + m;
  float* sl = sax + m;
  float* su = sl + m;
  float* scr = su + m;
  float* srho = scr + m;
  float* srhs = srho + m;         // [n]
  float* sxt = srhs + n;          // [n]
  float* spart = sxt + n;         // [NWARP, n] per-warp column sums
  const Rows rows{sz, sy, sax, sl, su, scr, srho};

  const size_t bm = (size_t)b * m, bn = (size_t)b * n;
  const float* Minv = a.Minv + (size_t)b * n * n;
  const float* A = a.A + (size_t)b * m * n;
  for (int i = tid; i < m; i += NT) {
    sz[i] = a.z[bm + i]; sy[i] = a.y[bm + i]; sl[i] = a.l[bm + i];
    su[i] = a.u[bm + i]; scr[i] = a.cr[bm + i]; srho[i] = a.rho[bm + i];
  }
  // column j is owned by thread j
  const bool owner = tid < n;
  float cx = 0.f, cq = 0.f;
  if (owner) {
    cx = a.x[bn + tid];
    cq = a.q[bn + tid];
    sxt[tid] = cx;
  }
  const float sigma = a.sigma, alpha = a.alpha;
  float v[CPL];
  __syncthreads();

  // Ax = A x and the first A'(rho z - y)
  lane_cols(sxt, v, n, lane);
  row_pass(A, v, rows, spart, m, n, alpha, true, a.n_iters > 0, warp, lane);
  __syncthreads();

  for (int it = 0; it < a.n_iters; ++it) {
    if (owner) {
      float atw = 0.f;
      for (int w = 0; w < NWARP; ++w) atw += spart[w * n + tid];
      srhs[tid] = sigma * cx - cq + atw;
    }
    __syncthreads();
    lane_cols(srhs, v, n, lane);
    matvec(Minv, v, sxt, n, n, warp, lane);
    __syncthreads();
    if (owner) cx = alpha * sxt[tid] + (1.f - alpha) * cx;
    lane_cols(sxt, v, n, lane);
    row_pass(A, v, rows, spart, m, n, alpha, false, it + 1 < a.n_iters,
             warp, lane);
    __syncthreads();
  }

  if (owner) a.x_o[bn + tid] = cx;
  for (int i = tid; i < m; i += NT) {
    a.z_o[bm + i] = sz[i]; a.y_o[bm + i] = sy[i]; a.ax_o[bm + i] = sax[i];
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs for a problem shape.
size_t admm_dense_chunk_smem(int n, int m) {
  return sizeof(float) * (7 * (size_t)m + 2 * (size_t)n + NWARP * (size_t)n);
}

// Largest n the kernel takes (one column per thread).
int admm_dense_chunk_max_n() { return NT; }

// Launch one chunk on `stream` for B problems.  `active` may be null; a
// problem with active[b] == 0 is skipped and its outputs are not written.
// Returns cudaGetLastError() after the launch.
int admm_dense_chunk(const void* Minv, const void* A, const void* q,
                     const void* l, const void* u, const void* cr,
                     const void* rho, const void* x, const void* z,
                     const void* y, void* x_o, void* z_o, void* y_o,
                     void* ax_o, const void* active, int B, int m, int n,
                     float sigma, float alpha, int n_iters, void* stream) {
  Args a;
  a.Minv = (const float*)Minv; a.A = (const float*)A; a.q = (const float*)q;
  a.l = (const float*)l; a.u = (const float*)u; a.cr = (const float*)cr;
  a.rho = (const float*)rho; a.x = (const float*)x; a.z = (const float*)z;
  a.y = (const float*)y;
  a.x_o = (float*)x_o; a.z_o = (float*)z_o; a.y_o = (float*)y_o;
  a.ax_o = (float*)ax_o;
  a.active = (const int32_t*)active;
  a.m = m; a.n = n; a.sigma = sigma; a.alpha = alpha; a.n_iters = n_iters;
  const size_t smem = admm_dense_chunk_smem(n, m);
  cudaError_t e = cudaFuncSetAttribute(
      admm_dense_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  admm_dense_chunk_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
