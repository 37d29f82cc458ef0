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
// Bound: operations.  A query costs ~27 kflop at the unified flagship's
// swept shapes (fused_convex.select_flops: 16 steps x 15 subset solves of
// ~103 flop dominate) against ~0.5 kB of inputs and outputs.  Under
// --fmad=false and IEEE div.rn / sqrt.rn (each a multi-instruction
// sequence with a branch to its slow path) a subset solve issues a few
// hundred instructions in one dependent chain, so the kernel is bound by
// issue and latency, not by the flop count.
//
// Design: one thread a query, its simplex, Gram matrix, weights and best
// iterate in registers (measured against 2, 4, 8 and 16 lanes a query,
// whose replicated per-step work and shuffles cost more issue slots than
// their parallel subset solves saved: PERF.md section 6).
//   - The fixed point: a step whose slots and weights come out bit for bit
//     as they went in maps the state onto itself, so every later step
//     repeats it and leaves the best iterate alone; the thread stops its
//     query there (on the unified flagship most queries settle within a
//     few of the 16 steps).
//   - So that one slow query does not hold its warp, a thread takes
//     queries<T> queries of its block's chunk (fewer when a call is too
//     small to fill every SM's resident blocks) and runs their GJK steps
//     in one loop, starting the next query where the last settled; the
//     SAT phase then runs over the thread's queries in turn, from the
//     best simplices it stored.
//   - Vertex counts known at compile time ((A, B) = (4, 8), (2, 2) on the
//     unified flagship, (8, 8) on the mesh arm) get their own
//     instantiations, which stage the thread's vertex rows in shared
//     memory, interleaved over the block's threads (conflict-free), once
//     a query and phase.  Every other shape runs the run-time
//     instantiation, which reads the rows through their strides and so
//     takes any vertex count (a mesh link's hull of hundreds).
//   - The register budget is set per precision (__launch_bounds__ minimum
//     blocks), from measurement.
// The launch allocates nothing and does not synchronise, so it can be
// captured in a CUDA graph.  Registers and spills of each instantiation:
// PERF.md section 6 (-Xptxas -v through fused_convex.build(verbose=True)).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 4;
constexpr int THREADS = 128;
constexpr int N_TENSORS = 5;             // Va, Vb, axes, valid, cax
constexpr long long SMEM_LIMIT = 232448;
constexpr long long SMEM_DEFAULT = 48 * 1024;

// Queries a thread, and resident blocks an SM asked of the register
// allocator (__launch_bounds__), per precision: the fastest settings
// measured on phase 4b's calls (float: 80 registers; double: 168).
template <typename T>
constexpr int queries = sizeof(T) == 4 ? 8 : 16;
template <typename T>
constexpr int min_blocks = sizeof(T) == 4 ? 6 : 3;

struct Layout {
  long long n;                           // queries
  int nd;                                // batch dims, outermost first
  long long size[MAX_DIMS];
  long long st[N_TENSORS][MAX_DIMS];     // batch strides, in elements
  long long va_v, va_c, vb_v, vb_c;      // vertex and coordinate strides
  long long ax_k, ax_c, val_k, cax_c;    // axis row / coordinate strides
  int A, B, K, iters;
  int per_thread;                        // queries a thread (set at launch)
};

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sqrt_(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ unsigned long long bits_(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long bits_(double x) {
  return (unsigned long long)__double_as_longlong(x);
}

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

// A thread's vertex rows staged in shared memory, interleaved with the
// block's other threads (element (j, c) at p[(3 j + c) st]).
template <typename T>
struct Staged {
  T* p;
  int st;
  __device__ __forceinline__ T at(int j, int c) const {
    return p[(3 * j + c) * st];
  }
};

// A query's [n, 3] rows in device memory, read through their strides.
template <typename T>
struct Strided {
  const T* p;
  long long sv, sc;
  __device__ __forceinline__ T at(int j, int c) const {
    return p[j * sv + c * sc];
  }
};

// the per-query offsets of the five inputs
__device__ __forceinline__ void query_offsets(const Layout& L, long long q,
                                              long long (&off)[N_TENSORS]) {
#pragma unroll
  for (int t = 0; t < N_TENSORS; ++t) off[t] = 0;
  for (int d = L.nd - 1; d >= 0; --d) {
    const long long i = q % L.size[d];
    q /= L.size[d];
#pragma unroll
    for (int t = 0; t < N_TENSORS; ++t) off[t] += i * L.st[t][d];
  }
}

// Where a query's vertex rows are read: compile-time vertex counts stage
// them in shared memory (a thread's 3 (A + B) elements, interleaved over
// the block's threads), the run-time instantiation reads them through
// their strides in device memory, so that it takes any vertex count.
template <typename T, bool STAGED>
struct Rows;

template <typename T>
struct Rows<T, true> {
  Staged<T> a, b;
  __device__ __forceinline__ Rows(T* base, int st, int A)
      : a{base, st}, b{base + 3 * A * st, st} {}
  // query q's rows into the thread's staging rows
  __device__ __forceinline__ void bind(const Layout& L, const T* Va,
                                       const T* Vb, long long q, int A,
                                       int B) {
    long long off[N_TENSORS];
    query_offsets(L, q, off);
    for (int j = 0; j < A; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        a.p[(3 * j + c) * a.st] = Va[off[0] + j * L.va_v + c * L.va_c];
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        b.p[(3 * j + c) * b.st] = Vb[off[1] + j * L.vb_v + c * L.vb_c];
  }
};

template <typename T>
struct Rows<T, false> {
  Strided<T> a, b;
  __device__ __forceinline__ Rows(T*, int, int) {}
  __device__ __forceinline__ void bind(const Layout& L, const T* Va,
                                       const T* Vb, long long q, int, int) {
    long long off[N_TENSORS];
    query_offsets(L, q, off);
    a = Strided<T>{Va + off[0], L.va_v, L.va_c};
    b = Strided<T>{Vb + off[1], L.vb_v, L.vb_c};
  }
};

// _closest_on_simplex: the weights of the least-norm feasible subset
// minimizer of the 15 subsets of the 4 points W, given their Gram matrix.
template <typename T>
__device__ __forceinline__ void closest_on_simplex(const T (&G)[4][4],
                                                   const T (&W)[4][3],
                                                   T (&out)[4]) {
  const T tiny = (T)1e-30, ridge = (T)1e-12, neg = (T)-1e-9;
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
template <typename T, typename V>
__device__ __forceinline__ void witness(const V& rows,
                                        const int (&idx)[4],
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
    T acc = w[0] * rows.at(o[0], c);
#pragma unroll
    for (int p = 1; p < 4; ++p) acc = fma_(w[p], rows.at(o[p], c), acc);
    out[c] = acc;
  }
}

// The first extreme of the projections V[j] . u over n rows (argmin unless
// hi).
template <typename T, typename V>
__device__ __forceinline__ int arg_extreme(const V& rows, int n, bool hi,
                                           T u0, T u1, T u2) {
  T best = dot3(rows.at(0, 0), rows.at(0, 1), rows.at(0, 2), u0, u1, u2);
  int jb = 0;
  for (int j = 1; j < n; ++j) {
    const T v =
        dot3(rows.at(j, 0), rows.at(j, 1), rows.at(j, 2), u0, u1, u2);
    if (hi ? before_max(v, best) : before_min(v, best)) best = v, jb = j;
  }
  return jb;
}

// One query's GJK (_gjk_slots) state: the simplex, its Gram matrix and
// weights, the iterate z = lam @ W, and the best iterate.
template <typename T>
struct Gjk {
  int ia[4], ib[4];
  T lam[4], W[4][3], G[4][4], z[3];
  T bd2;
  int bia[4], bib[4];
  T blam[4];

  // z = lam @ W
  __device__ __forceinline__ void iterate() {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      z[c] = lam[0] * W[0][c];
#pragma unroll
      for (int s = 1; s < 4; ++s) z[c] = fma_(lam[s], W[s][c], z[c]);
    }
  }

  // the initial state: every slot at (a_0, b_0), all weight on slot 0
  template <typename V>
  __device__ __forceinline__ void start(const V& SA, const V& SB) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ia[s] = ib[s] = 0;
      lam[s] = s == 0 ? (T)1 : (T)0;
#pragma unroll
      for (int c = 0; c < 3; ++c) W[s][c] = SA.at(0, c) - SB.at(0, c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        G[i][j] = dot3(W[i][0], W[i][1], W[i][2], W[j][0], W[j][1], W[j][2]);
        G[j][i] = G[i][j];
      }
    iterate();
    bd2 = dot3(z[0], z[1], z[2], z[0], z[1], z[2]);
#pragma unroll
    for (int s = 0; s < 4; ++s) bia[s] = ia[s], bib[s] = ib[s],
                                blam[s] = lam[s];
  }

  // One support step; true when it left the slots and weights bit for bit
  // as they were (a fixed point: every later step repeats it).
  template <typename V>
  __device__ __forceinline__ bool step(const V& SA, int A, const V& SB,
                                       int B) {
    // z = lam @ W is the previous step's z2 (the same operands)
    const int sa = arg_extreme(SA, A, false, z[0], z[1], z[2]);
    const int sb = arg_extreme(SB, B, true, z[0], z[1], z[2]);
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
    bool same = true;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s == slot) {
        same = ia[s] == sa && ib[s] == sb;
        ia[s] = sa;
        ib[s] = sb;
#pragma unroll
        for (int c = 0; c < 3; ++c) W[s][c] = SA.at(sa, c) - SB.at(sb, c);
      }
    // the Gram matrix's row and column of the new slot (the others keep
    // their operands, so their values)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        if (i == slot || j == slot) {
          G[i][j] = dot3(W[i][0], W[i][1], W[i][2], W[j][0], W[j][1],
                         W[j][2]);
          G[j][i] = G[i][j];
        }
    T nl[4];
    closest_on_simplex(G, W, nl);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      same = same && bits_(nl[s]) == bits_(lam[s]);
      lam[s] = nl[s];
    }
    iterate();
    const T d2 = dot3(z[0], z[1], z[2], z[0], z[1], z[2]);
    if (d2 < bd2) {  // the BEST iterate, not the last
      bd2 = d2;
#pragma unroll
      for (int s = 0; s < 4; ++s) bia[s] = ia[s], bib[s] = ib[s],
                                  blam[s] = lam[s];
    }
    return same;
  }
};

}  // namespace

// CA, CB: the vertex counts when known at compile time, else 0 (read from
// the layout).  Thread t of block b takes the queries
// (b Q + m) blockDim.x + t, m < Q = L.per_thread; with compile-time counts
// 3 (A + B) elements of dynamic shared memory a thread, else none.
template <typename T, int CA, int CB>
__global__ void __launch_bounds__(THREADS, min_blocks<T>)
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int A = CA > 0 ? CA : L.A;
  const int B = CB > 0 ? CB : L.B;
  const int K = L.K;
  const int st = blockDim.x;
  Rows<T, (CA > 0)> R(reinterpret_cast<T*>(smem_raw) + threadIdx.x, st, A);
  const auto& SA = R.a;
  const auto& SB = R.b;
  const int Q = L.per_thread;
  const long long first = (long long)blockIdx.x * Q * st + threadIdx.x;

  // ---- GJK of the thread's queries, one step a pass: a query that
  // reaches its fixed point or ITERS steps stores its best simplex and
  // hands the loop to the next ----
  Gjk<T> g;
  int m = 0, it = 0;
  bool fresh = true;
  for (;;) {
    const long long q = first + (long long)m * st;
    if (fresh) {
      if (m >= Q || q >= L.n) break;
      R.bind(L, Va, Vb, q, A, B);
      g.start(SA, SB);
      it = 0;
      fresh = false;
    }
    bool done = it >= L.iters;
    if (!done) {
      done = g.step(SA, A, SB, B);
      done = done || ++it >= L.iters;
    }
    if (done) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        idA_out[q * 4 + s] = g.bia[s];
        idB_out[q * 4 + s] = g.bib[s];
        lam_out[q * 4 + s] = g.blam[s];
      }
      ++m;
      fresh = true;
    }
  }

  // ---- the witness vector and the SAT winner (_sat_select) over
  // [axes, cax, w] of each of the thread's queries ----
  const T ninf = -(T)CUDART_INF;
  for (int mm = 0; mm < Q; ++mm) {
    const long long q = first + (long long)mm * st;
    if (q >= L.n) break;
    R.bind(L, Va, Vb, q, A, B);
    int bia[4], bib[4];
    T blam[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      bia[s] = (int)idA_out[q * 4 + s];
      bib[s] = (int)idB_out[q * 4 + s];
      blam[s] = lam_out[q * 4 + s];
    }
    T wa[3], wb[3], w[3];
    witness(SA, bia, blam, wa);
    witness(SB, bib, blam, wb);
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = wa[c] - wb[c];
    long long off[N_TENSORS];
    query_offsets(L, q, off);
    const Strided<T> X{axes + off[2], L.ax_k, L.ax_c};
    const uint8_t* vmask = valid + off[3];
    const T* cx = cax + off[4];
    int kbest = 0;
    T gbest = (T)0, gab_k = (T)0, gba_k = (T)0;
    for (int k = 0; k < K + 2; ++k) {
      T u0, u1, u2;
      bool ok = true;
      if (k < K) {
        u0 = X.at(k, 0), u1 = X.at(k, 1), u2 = X.at(k, 2);
        ok = vmask[k * L.val_k] != 0;
      } else if (k == K) {
        u0 = cx[0], u1 = cx[L.cax_c], u2 = cx[2 * L.cax_c];
      } else {
        u0 = w[0], u1 = w[1], u2 = w[2];
      }
      T mna = dot3(SA.at(0, 0), SA.at(0, 1), SA.at(0, 2), u0, u1, u2);
      T mxa = mna;
      for (int j = 1; j < A; ++j) {
        const T v = dot3(SA.at(j, 0), SA.at(j, 1), SA.at(j, 2), u0, u1, u2);
        if (nan_(v) || v < mna) mna = v;  // amin / amax propagate NaN
        if (nan_(v) || v > mxa) mxa = v;
      }
      T mnb = dot3(SB.at(0, 0), SB.at(0, 1), SB.at(0, 2), u0, u1, u2);
      T mxb = mnb;
      for (int j = 1; j < B; ++j) {
        const T v = dot3(SB.at(j, 0), SB.at(j, 1), SB.at(j, 2), u0, u1, u2);
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
    if (kbest < K) {
      u0 = X.at(kbest, 0), u1 = X.at(kbest, 1), u2 = X.at(kbest, 2);
    } else if (kbest == K) {
      u0 = cx[0], u1 = cx[L.cax_c], u2 = cx[2 * L.cax_c];
    } else {
      u0 = w[0], u1 = w[1], u2 = w[2];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) z_out[q * 3 + c] = w[c];
    k_out[q] = kbest;
    flip_out[q] = flip ? 1 : 0;
    // a's vertex: argmin of its projections if flipped, else argmax; b's
    // the other way round
    ia_out[q] = arg_extreme(SA, A, !flip, u0, u1, u2);
    ib_out[q] = arg_extreme(SB, B, flip, u0, u1, u2);
  }
}

namespace {

template <typename T, int CA, int CB>
cudaError_t launch(const void* va, const void* vb, const void* ax,
                   const void* valid, const void* cax, const Layout& L,
                   void* idA, void* idB, void* lam, void* z, void* k,
                   void* flip, void* ia, void* ib, cudaStream_t stream) {
  static_assert(3LL * (CA + CB) * sizeof(T) * THREADS <= SMEM_LIMIT,
                "a compile-time shape's staged rows must fit a full block");
  const long long smem = 3LL * (CA + CB) * (long long)sizeof(T) * THREADS;
  auto kernel = convex_select_kernel<T, CA, CB>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // queries a thread: queries<T>, or fewer where that would leave an SM
  // short of the min_blocks<T> blocks its registers hold
  int dev = 0, sms = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Layout M = L;
  const long long slots = (long long)THREADS * sms * min_blocks<T>;
  const long long spread = (L.n + slots - 1) / slots;
  M.per_thread = (int)(spread < queries<T> ? spread : queries<T>);
  const long long chunk = (long long)THREADS * M.per_thread;
  const long long blocks = (L.n + chunk - 1) / chunk;
  kernel<<<(unsigned)blocks, THREADS, (size_t)smem, stream>>>(
      (const T*)va, (const T*)vb, (const T*)ax, (const uint8_t*)valid,
      (const T*)cax, M, (long long*)idA, (long long*)idB, (T*)lam, (T*)z,
      (long long*)k, (uint8_t*)flip, (long long*)ia, (long long*)ib);
  return cudaGetLastError();
}

// the instantiation of (A, B): compile-time vertex counts for the shapes
// the paths run, the run-time one for every other shape
template <typename T>
cudaError_t dispatch(const void* va, const void* vb, const void* ax,
                     const void* valid, const void* cax, const Layout& L,
                     void* idA, void* idB, void* lam, void* z, void* k,
                     void* flip, void* ia, void* ib, cudaStream_t s) {
  if (L.A == 4 && L.B == 8)
    return launch<T, 4, 8>(va, vb, ax, valid, cax, L, idA, idB, lam, z, k,
                           flip, ia, ib, s);
  if (L.A == 2 && L.B == 2)
    return launch<T, 2, 2>(va, vb, ax, valid, cax, L, idA, idB, lam, z, k,
                           flip, ia, ib, s);
  if (L.A == 8 && L.B == 8)
    return launch<T, 8, 8>(va, vb, ax, valid, cax, L, idA, idB, lam, z, k,
                           flip, ia, ib, s);
  return launch<T, 0, 0>(va, vb, ax, valid, cax, L, idA, idB, lam, z, k,
                         flip, ia, ib, s);
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
  if (L.n < 1 || L.nd < 0 || L.nd > MAX_DIMS || L.A < 1 || L.B < 1 ||
      L.K < 0 || L.iters < 0 || L.n >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(va, vb, ax, valid, cax, L, idA, idB, lam, z,
                                k, flip, ia, ib, s);
  if (dtype == 1)
    return (int)dispatch<double>(va, vb, ax, valid, cax, L, idA, idB, lam,
                                 z, k, flip, ia, ib, s);
  return (int)cudaErrorInvalidValue;
}
