// The convex narrowphase's discrete search on Hopper (sm_90a): GJK's best
// simplex and the SAT winner of one sphere-swept vertex-set pair a query.
//
// Replaces the search inside trajopt_tpu/collision/convex.py:255
// (convex_convex over _gjk_weights :121, _closest_on_simplex :90,
// _chol4_solve :57 and _sat_depth :199), which has no Pallas source: XLA
// fuses it into a few kernels on the TPU.  The plain PyTorch version is
// trajopt_tpu_torch/collision/fused_convex.py select_plain; the
// differentiable epilogue (witness distance, winning gap, certificate)
// stays PyTorch (collision/convex.py _epilogue) and reads this kernel's
// indices and weights.
//
// What it computes, per query q (arithmetic identical to the plain
// version, op for op):
//   GJK: a 4-slot simplex on the Minkowski difference of Va [A,3] and
//   Vb [B,3], ITERS support steps; each step evicts the least weight slot
//   (duplicate slots merged first), solves all 15 subset problems of the
//   closest point (4x4 Cholesky with a 1e-12 ridge and a 1e-30 pivot
//   floor, feasibility by lam >= -1e-9) and keeps the BEST iterate.  Then
//   the witness z = wa@Va - wb@Vb (weights at ascending vertex index).
//   SAT: over the K caller axes, the centroid axis cax and z, the largest
//   gap max(min_b - max_a, min_a - max_b) / |u| (masked rows -inf), its
//   side (flip) and extreme vertices (ia, ib).
//
// Ties decide subgradients, so the rounding is the plain version's: every
// dot product the plain version writes as a torch.addcmul chain is an
// explicit fma() chain in the same order here; the build passes
// --fmad=false so that no other multiply-add is contracted; divisions and
// square roots are IEEE-rounded.  Every argmin / argmax scans in ascending
// order with strict comparisons (the first extreme wins, a NaN wins as in
// torch), so edge-mode padded vertices and all-infeasible subset sets
// (index 0) resolve as torch resolves them.
//
// Bound: operations.  A query costs ~27 kflop at the flagship's swept
// shapes (fused_convex.select_flops: 16 steps x 15 subset solves of ~103
// flop dominate) against ~0.5 kB of inputs and outputs, so at 1.35 M
// queries the fp32 rate (67 TFLOP/s) bounds it near 0.5 ms and the bytes
// (3.35 TB/s) near 0.2 ms.  Design: one thread a query, no shared memory.
// The simplex, its Gram matrix, the slot indices and the best iterate live
// in registers; the 15 subsets are solved in an unrolled branch-free loop;
// the support scans and the SAT projections stream the query's vertices
// and axes through L1 (a query's rows are read ITERS times).  There is no
// early exit: the fixed ITERS steps and the best-iterate rule decide the
// result, as in the plain version.  Broadcast inputs (stride 0) are read
// through their strides.  The launch allocates nothing and does not
// synchronise, so it can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 4;
constexpr int THREADS = 128;
constexpr int N_TENSORS = 5;  // Va, Vb, axes, valid, cax

struct Layout {
  long long n;                           // queries
  int nd;                                // batch dims, outermost first
  long long size[MAX_DIMS];
  long long st[N_TENSORS][MAX_DIMS];     // batch strides, in elements
  long long va_v, va_c, vb_v, vb_c;      // vertex and coordinate strides
  long long ax_k, ax_c, val_k, cax_c;    // axis row / coordinate strides
  int A, B, K, iters;
};

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sqrt_(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_(double x) { return __dsqrt_rn(x); }

// _dot3: addcmul(addcmul(a0 * b0, a1, b1), a2, b2)
template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return fma_(a2, b2, fma_(a1, b1, a0 * b0));
}

// _sq3: (a0 * a0 + a1 * a1) + a2 * a2, no fma
template <typename T>
__device__ __forceinline__ T sq3(T a0, T a1, T a2) {
  return (a0 * a0 + a1 * a1) + a2 * a2;
}

// NaN and finiteness tests that stay exact without fast math
template <typename T>
__device__ __forceinline__ bool nan_(T x) {
  return x != x;
}
template <typename T>
__device__ __forceinline__ bool finite_(T x) {
  return x - x == (T)0;  // inf - inf and NaN - NaN are NaN
}

// torch's argmin / argmax order: v replaces the running extreme when it is
// strictly smaller (larger) or a NaN, unless the extreme is a NaN already.
template <typename T>
__device__ __forceinline__ bool before_min(T v, T best) {
  return !nan_(best) && (nan_(v) || v < best);
}
template <typename T>
__device__ __forceinline__ bool before_max(T v, T best) {
  return !nan_(best) && (nan_(v) || v > best);
}

// torch.clamp_min(x, lo): a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

template <typename T>
struct Rows {  // a query's [n, 3] rows
  const T* p;
  long long sv, sc;
  __device__ __forceinline__ T at(int j, int c) const {
    return p[j * sv + c * sc];
  }
};

// _closest_on_simplex: the weights of the least-norm feasible subset
// minimizer of the 15 subsets of the 4 points W.
template <typename T>
__device__ __forceinline__ void closest_on_simplex(const T (&W)[4][3],
                                                   T (&out)[4]) {
  const T tiny = (T)1e-30, ridge = (T)1e-12, neg = (T)-1e-9;
  T G[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      G[i][j] = dot3(W[i][0], W[i][1], W[i][2], W[j][0], W[j][1], W[j][2]);
      G[j][i] = G[i][j];
    }
  T best_n2 = (T)0;
  T best[4] = {(T)0, (T)0, (T)0, (T)0};
#pragma unroll
  for (int s = 0; s < 15; ++s) {
    const int m = s + 1;  // subset mask, slot 0 in the highest bit
    const T mk[4] = {(T)((m >> 3) & 1), (T)((m >> 2) & 1),
                     (T)((m >> 1) & 1), (T)(m & 1)};
    // padded system: G on the subset, identity off it, plus the ridge
    T g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T m2 = mk[i] * mk[j];
        const T e = (i == j) ? (T)1 : (T)0;
        g[i][j] = G[i][j] * m2 + e * ((T)1 - m2);
        g[i][j] = g[i][j] + ridge * e;
      }
    // _chol4_solve(g, mk)
    const T l11 = sqrt_(clamp_min(g[0][0], tiny));
    const T l21 = g[1][0] / l11;
    const T l31 = g[2][0] / l11;
    const T l41 = g[3][0] / l11;
    const T l22 = sqrt_(clamp_min(g[1][1] - l21 * l21, tiny));
    const T l32 = (g[2][1] - l31 * l21) / l22;
    const T l42 = (g[3][1] - l41 * l21) / l22;
    const T l33 = sqrt_(clamp_min(g[2][2] - l31 * l31 - l32 * l32, tiny));
    const T l43 = (g[3][2] - l41 * l31 - l42 * l32) / l33;
    const T l44 =
        sqrt_(clamp_min(g[3][3] - l41 * l41 - l42 * l42 - l43 * l43, tiny));
    const T y1 = mk[0] / l11;
    const T y2 = (mk[1] - l21 * y1) / l22;
    const T y3 = (mk[2] - l31 * y1 - l32 * y2) / l33;
    const T y4 = (mk[3] - l41 * y1 - l42 * y2 - l43 * y3) / l44;
    const T x4 = y4 / l44;
    const T x3 = (y3 - l43 * x4) / l33;
    const T x2 = (y2 - l32 * x3 - l42 * x4) / l22;
    const T x1 = (y1 - l21 * x2 - l31 * x3 - l41 * x4) / l11;
    T lam[4] = {x1 * mk[0], x2 * mk[1], x3 * mk[2], x4 * mk[3]};
    const T denom = ((lam[0] + lam[1]) + lam[2]) + lam[3];
    const bool nonzero = (denom < (T)0 ? -denom : denom) > tiny;
    const T dv = nonzero ? denom : (T)1;
    bool feasible = nonzero;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lam[i] = lam[i] / dv;
      feasible = feasible && lam[i] >= neg && finite_(lam[i]);
    }
    T p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = lam[0] * W[0][c];
#pragma unroll
      for (int i = 1; i < 4; ++i) p[c] = fma_(lam[i], W[i][c], p[c]);
    }
    const T n2 = feasible ? sq3(p[0], p[1], p[2]) : (T)CUDART_INF;
    if (s == 0 || before_min(n2, best_n2)) {
      best_n2 = n2;
#pragma unroll
      for (int i = 0; i < 4; ++i) best[i] = lam[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)  // torch.clamp(lam, 0, 1): a NaN stays NaN
    out[i] = best[i] < (T)0 ? (T)0 : (best[i] > (T)1 ? (T)1 : best[i]);
}

// _witness: w @ V with w = zeros(n).at[idx].add(lam), summed as an fma
// chain over the distinct indices in ascending order.
template <typename T>
__device__ __forceinline__ void witness(const Rows<T>& V, const int (&idx)[4],
                                        const T (&lam)[4], T (&out)[3]) {
  int o[4] = {idx[0], idx[1], idx[2], idx[3]};
#pragma unroll
  for (int i = 1; i < 4; ++i)
#pragma unroll
    for (int j = i; j > 0; --j)
      if (o[j] < o[j - 1]) {
        const int t = o[j];
        o[j] = o[j - 1];
        o[j - 1] = t;
      }
  T w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    T acc = (T)0;
#pragma unroll
    for (int s = 0; s < 4; ++s) acc = acc + (idx[s] == o[p] ? lam[s] : (T)0);
    w[p] = (p > 0 && o[p] == o[p - 1]) ? (T)0 : acc;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T acc = w[0] * V.at(o[0], c);
#pragma unroll
    for (int p = 1; p < 4; ++p) acc = fma_(w[p], V.at(o[p], c), acc);
    out[c] = acc;
  }
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(THREADS)
    convex_select_kernel(const T* __restrict__ Va, const T* __restrict__ Vb,
                         const T* __restrict__ axes,
                         const uint8_t* __restrict__ valid,
                         const T* __restrict__ cax, const Layout L,
                         long long* __restrict__ idA_out,
                         long long* __restrict__ idB_out,
                         T* __restrict__ lam_out, T* __restrict__ z_out,
                         long long* __restrict__ k_out,
                         uint8_t* __restrict__ flip_out,
                         long long* __restrict__ ia_out,
                         long long* __restrict__ ib_out) {
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= L.n) return;
  long long off[N_TENSORS] = {0, 0, 0, 0, 0};
  long long rem = q;
  for (int d = L.nd - 1; d >= 0; --d) {
    const long long i = rem % L.size[d];
    rem /= L.size[d];
#pragma unroll
    for (int t = 0; t < N_TENSORS; ++t) off[t] += i * L.st[t][d];
  }
  const Rows<T> A{Va + off[0], L.va_v, L.va_c};
  const Rows<T> B{Vb + off[1], L.vb_v, L.vb_c};
  const Rows<T> X{axes + off[2], L.ax_k, L.ax_c};
  const uint8_t* vmask = valid + off[3];
  const T* cx = cax + off[4];

  // ---- GJK (_gjk_slots) ----
  int ia[4] = {0, 0, 0, 0}, ib[4] = {0, 0, 0, 0};
  T lam[4] = {(T)1, (T)0, (T)0, (T)0};
  T W[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) W[s][c] = A.at(0, c) - B.at(0, c);
  T z[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    z[c] = lam[0] * W[0][c];
#pragma unroll
    for (int s = 1; s < 4; ++s) z[c] = fma_(lam[s], W[s][c], z[c]);
  }
  T bd2 = dot3(z[0], z[1], z[2], z[0], z[1], z[2]);
  int bia[4] = {0, 0, 0, 0}, bib[4] = {0, 0, 0, 0};
  T blam[4] = {lam[0], lam[1], lam[2], lam[3]};

  for (int it = 0; it < L.iters; ++it) {
    // z = lam @ W is the previous step's z2 (the same operands)
    int sa = 0, sb = 0;
    T va = dot3(A.at(0, 0), A.at(0, 1), A.at(0, 2), z[0], z[1], z[2]);
    for (int j = 1; j < L.A; ++j) {
      const T v = dot3(A.at(j, 0), A.at(j, 1), A.at(j, 2), z[0], z[1], z[2]);
      if (before_min(v, va)) va = v, sa = j;
    }
    T vb = dot3(B.at(0, 0), B.at(0, 1), B.at(0, 2), z[0], z[1], z[2]);
    for (int j = 1; j < L.B; ++j) {
      const T v = dot3(B.at(j, 0), B.at(j, 1), B.at(j, 2), z[0], z[1], z[2]);
      if (before_max(v, vb)) vb = v, sb = j;
    }
    // _merge_duplicates, then evict the first least-weight slot
    T ml[4] = {lam[0], lam[1], lam[2], lam[3]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = i + 1; j < 4; ++j) {
        const bool dup = ia[i] == ia[j] && ib[i] == ib[j];
        ml[i] = ml[i] + (dup ? ml[j] : (T)0);
        ml[j] = dup ? (T)0 : ml[j];
      }
    int slot = 0;
    T mv = ml[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (before_min(ml[i], mv)) mv = ml[i], slot = i;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s == slot) {
        ia[s] = sa;
        ib[s] = sb;
#pragma unroll
        for (int c = 0; c < 3; ++c) W[s][c] = A.at(sa, c) - B.at(sb, c);
      }
    closest_on_simplex(W, lam);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      z[c] = lam[0] * W[0][c];
#pragma unroll
      for (int s = 1; s < 4; ++s) z[c] = fma_(lam[s], W[s][c], z[c]);
    }
    const T d2 = dot3(z[0], z[1], z[2], z[0], z[1], z[2]);
    if (d2 < bd2) {  // the BEST iterate, not the last
      bd2 = d2;
#pragma unroll
      for (int s = 0; s < 4; ++s) bia[s] = ia[s], bib[s] = ib[s],
                                  blam[s] = lam[s];
    }
  }

  // ---- the witness vector, the last SAT axis ----
  T wa[3], wb[3], w[3];
  witness(A, bia, blam, wa);
  witness(B, bib, blam, wb);
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = wa[c] - wb[c];

  // ---- SAT winner (_sat_select) over [axes, cax, w] ----
  const T ninf = -(T)CUDART_INF;
  int kbest = 0;
  T gbest = (T)0, gab_k = (T)0, gba_k = (T)0;
  for (int k = 0; k < L.K + 2; ++k) {
    T u0, u1, u2;
    bool ok = true;
    if (k < L.K) {
      u0 = X.at(k, 0), u1 = X.at(k, 1), u2 = X.at(k, 2);
      ok = vmask[k * L.val_k] != 0;
    } else if (k == L.K) {
      u0 = cx[0], u1 = cx[L.cax_c], u2 = cx[2 * L.cax_c];
    } else {
      u0 = w[0], u1 = w[1], u2 = w[2];
    }
    T mna = dot3(A.at(0, 0), A.at(0, 1), A.at(0, 2), u0, u1, u2), mxa = mna;
    for (int j = 1; j < L.A; ++j) {
      const T v = dot3(A.at(j, 0), A.at(j, 1), A.at(j, 2), u0, u1, u2);
      if (nan_(v) || v < mna) mna = v;  // amin / amax propagate NaN
      if (nan_(v) || v > mxa) mxa = v;
    }
    T mnb = dot3(B.at(0, 0), B.at(0, 1), B.at(0, 2), u0, u1, u2), mxb = mnb;
    for (int j = 1; j < L.B; ++j) {
      const T v = dot3(B.at(j, 0), B.at(j, 1), B.at(j, 2), u0, u1, u2);
      if (nan_(v) || v < mnb) mnb = v;
      if (nan_(v) || v > mxb) mxb = v;
    }
    const T nrm = sqrt_(sq3(u0, u1, u2) + (T)1e-24);
    const T gba = (mnb - mxa) / nrm;
    const T gab = (mna - mxb) / nrm;
    // torch.maximum: a NaN wins
    T gap = (nan_(gba) || nan_(gab)) ? gba + gab : (gba > gab ? gba : gab);
    if (!(ok && nrm > (T)1e-9)) gap = ninf;
    if (k == 0 || before_max(gap, gbest)) {
      gbest = gap, kbest = k, gab_k = gab, gba_k = gba;
    }
  }
  const bool flip = gab_k > gba_k;  // a lies above b along the winner
  T u0, u1, u2;
  if (kbest < L.K) {
    u0 = X.at(kbest, 0), u1 = X.at(kbest, 1), u2 = X.at(kbest, 2);
  } else if (kbest == L.K) {
    u0 = cx[0], u1 = cx[L.cax_c], u2 = cx[2 * L.cax_c];
  } else {
    u0 = w[0], u1 = w[1], u2 = w[2];
  }
  // a's vertex: argmin of its projections if flipped, else argmax; b's the
  // other way round
  int sa = 0, sb = 0;
  T pa = dot3(A.at(0, 0), A.at(0, 1), A.at(0, 2), u0, u1, u2);
  for (int j = 1; j < L.A; ++j) {
    const T v = dot3(A.at(j, 0), A.at(j, 1), A.at(j, 2), u0, u1, u2);
    if (flip ? before_min(v, pa) : before_max(v, pa)) pa = v, sa = j;
  }
  T pb = dot3(B.at(0, 0), B.at(0, 1), B.at(0, 2), u0, u1, u2);
  for (int j = 1; j < L.B; ++j) {
    const T v = dot3(B.at(j, 0), B.at(j, 1), B.at(j, 2), u0, u1, u2);
    if (flip ? before_max(v, pb) : before_min(v, pb)) pb = v, sb = j;
  }

#pragma unroll
  for (int s = 0; s < 4; ++s) {
    idA_out[q * 4 + s] = bia[s];
    idB_out[q * 4 + s] = bib[s];
    lam_out[q * 4 + s] = blam[s];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) z_out[q * 3 + c] = w[c];
  k_out[q] = kbest;
  flip_out[q] = flip ? 1 : 0;
  ia_out[q] = sa;
  ib_out[q] = sb;
}

namespace {

template <typename T>
cudaError_t launch(const void* va, const void* vb, const void* ax,
                   const void* valid, const void* cax, const Layout& L,
                   void* idA, void* idB, void* lam, void* z, void* k,
                   void* flip, void* ia, void* ib, cudaStream_t stream) {
  const long long blocks = (L.n + THREADS - 1) / THREADS;
  convex_select_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)va, (const T*)vb, (const T*)ax, (const uint8_t*)valid,
      (const T*)cax, L, (long long*)idA, (long long*)idB, (T*)lam, (T*)z,
      (long long*)k, (uint8_t*)flip, (long long*)ia, (long long*)ib);
  return cudaGetLastError();
}

}  // namespace

// lay: n, nd, size[4], the batch strides of Va, Vb, axes, valid and cax
// (4 each), va_v, va_c, vb_v, vb_c, ax_k, ax_c, val_k, cax_c, A, B, K,
// iters (38 values; see fused_convex.select_cuda).  dtype 0: float32,
// 1: float64.  Returns the launch's CUDA error code.
extern "C" int convex_select(int dtype, const void* va, const void* vb,
                             const void* ax, const void* valid,
                             const void* cax, const long long* lay,
                             void* idA, void* idB, void* lam, void* z,
                             void* k, void* flip, void* ia, void* ib,
                             void* stream) {
  Layout L;
  int p = 0;
  L.n = lay[p++];
  L.nd = (int)lay[p++];
  for (int d = 0; d < MAX_DIMS; ++d) L.size[d] = lay[p++];
  for (int t = 0; t < N_TENSORS; ++t)
    for (int d = 0; d < MAX_DIMS; ++d) L.st[t][d] = lay[p++];
  L.va_v = lay[p++];
  L.va_c = lay[p++];
  L.vb_v = lay[p++];
  L.vb_c = lay[p++];
  L.ax_k = lay[p++];
  L.ax_c = lay[p++];
  L.val_k = lay[p++];
  L.cax_c = lay[p++];
  L.A = (int)lay[p++];
  L.B = (int)lay[p++];
  L.K = (int)lay[p++];
  L.iters = (int)lay[p++];
  if (L.nd < 0 || L.nd > MAX_DIMS || L.A < 1 || L.B < 1 || L.K < 0 ||
      L.iters < 0 || L.n / THREADS >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(va, vb, ax, valid, cax, L, idA, idB, lam, z, k,
                              flip, ia, ib, s);
  if (dtype == 1)
    return (int)launch<double>(va, vb, ax, valid, cax, L, idA, idB, lam, z,
                               k, flip, ia, ib, s);
  return (int)cudaErrorInvalidValue;
}
