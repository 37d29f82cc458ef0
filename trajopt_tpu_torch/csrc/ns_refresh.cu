// The Newton-Schulz refresh of the carried KKT inverse on Hopper (sm_90a):
// X <- X (2I - M X) per lane, M = P + sigma I + C'RC + diag(rho b^2) of the
// block QP, X ~ M^-1 carried from the previous SQP step.
//
// Replaces no Pallas kernel: trajopt_tpu/qp/inverse.py ns_inverse runs as
// XLA's GEMMs on the TPU, and the port ran it as torch.matmul and eager
// elementwise passes, with a host read every iteration.  Two kernels an
// iteration, in the order of the per-lane loop of qp/inverse.py:
//
//   ns_residual  E = I - M X from M's block band alone (rows of step I
//                read the columns of steps I - hb .. I + hb), r = ||E||_F,
//                then the stop test: r, k, active as the per-lane loop
//                sets them, and upd = 1 for the update that follows.
//   ns_update    X <- X + X E, a dense product, for lanes with upd = 1.
//
// Per-lane state st[b] = (k, kt, active, upd): k the phase's iterations,
// kt the refresh's (its parity says which of the two X buffers holds the
// lane's iterate: the update reads one and writes the other, since every
// tile reads whole rows of X), active the stop test's verdict, upd whether
// this iteration's residual ran.  A lane whose test failed leaves both
// kernels at once: its blocks read the flag and return, its state and X
// untouched.  So qp/inverse.py launches a phase's max_iter iterations
// back to back without reading anything, and each lane's arithmetic is
// that of a loop that stops on the lane's own test.  Mode FINAL (the stop
// test off) computes r for every lane, copies its iterate into Xout and
// stores the rescue test (non-finite r or r > 1) as the lane's active
// flag: the sums of st's kt and active columns are the one read the host
// makes per refresh.
//
// Bounds, at the flagship (B 512, n 240, D 8, hb 1), one iteration:
// 2 n^2 (2 hb + 1) D + 2 n^3 = 30.4 MFLOP a lane, 15.6 GFLOP, 0.232 ms at
// 67 TFLOP/s (fp32, no tensor cores: the configuration states float32
// with TF32 off); bytes: X read twice and written once, E written and
// read, M's band read: ~0.59 GB, 0.18 ms at 3.35 TB/s.  The update is
// 91 % of the operations, so it sets the time.
//
// Design.
//   - ns_residual: one cluster of 4 blocks a lane, each a contiguous
//     quarter of the row tiles; the norm is reduced in a fixed order
//     (warp shuffles, warp partials, then rank 0 sums the ranks' totals
//     through distributed shared memory), so the stop test needs no
//     second pass and is the same on every run.  A work item is 8 rows by
//     4 columns of E; its rows' band is the union of the 8 rows' bands
//     (exact zeros of M beyond a row's own band add nothing).  M is read
//     through the read-only cache: the 60 items of a row tile share its
//     addresses.  Where n is a multiple of 4, a step reads four columns
//     of M's 8 rows and four rows of X as 16-byte vectors, all issued
//     before the step's products (the range rounded out to multiples of 4
//     adds only zeros of M): the loop is bound by load latency, and a
//     value at a time left it at a third of the memory's rate.  The band
//     is in steps of D columns, so hb >= T - 1 is the dense product (the
//     fallback where the solver cannot derive the band).  One block a
//     lane (512 blocks at B 512, 1.3 waves) set the latency of the
//     phase's last, few-lane iterations.
//   - ns_update: 128 x 128 output tiles, 256 threads, each an 8 x 8
//     register tile (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, the same
//     for columns: conflict-free 16-byte shared loads), k in steps of 8,
//     double-buffered shared memory fed through registers from 16-byte
//     loads whose addresses are fixed but for k, one barrier a step.  X's
//     tile is stored transposed with a row stride of 132, consecutive
//     threads on consecutive rows, so the transposing stores meet 32
//     banks.  n = 240 takes 2 x 2 tiles a lane, the edge tiles 112 wide:
//     12 % of the products would be padding, so at an edge the warps
//     whose far half of rows (or columns: the tile's thread layout is
//     transposed where only its columns stop short) lies past n compute
//     their near half alone, which leaves 3 % (80-row tiles, padded 6.7 %,
//     ran slower: three blocks an SM, and spills).  The epilogue adds X:
//     X + (X E), as the loop does.
// Float and double instantiations (the card tests solve in float64).  A
// launch allocates nothing and does not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int RES_THREADS = 256;
constexpr int RES_CLUSTER = 4;  // blocks (a cluster) a lane
constexpr int RT = 8;  // rows of a residual work item
constexpr int CQ = 4;  // columns of a residual work item

constexpr int BM = 128, BN = 128, BK = 8, UPD_THREADS = 256;
constexpr int APAD = 4;

constexpr int START = 0, STEP = 1, FINAL = 2;          // residual modes
constexpr int S_K = 0, S_KT = 1, S_ACT = 2, S_UPD = 3;  // st[b] fields

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// Four consecutive values at p, of which the first `valid` exist; `vec`
// says p is 16-byte aligned (one float4, or two double2).
__device__ __forceinline__ void load4(const float* p, int valid, bool vec,
                                      float (&v)[4]) {
  if (vec && valid >= 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < valid ? __ldg(p + e) : 0.0f;
}

__device__ __forceinline__ void load4(const double* p, int valid, bool vec,
                                      double (&v)[4]) {
  if (vec && valid >= 4) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < valid ? __ldg(p + e) : 0.0;
}

__device__ __forceinline__ void store4(float* p, int valid, bool vec,
                                       const float (&v)[4]) {
  if (vec && valid >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < valid) p[e] = v[e];
}

__device__ __forceinline__ void store4(double* p, int valid, bool vec,
                                       const double (&v)[4]) {
  if (vec && valid >= 4) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < valid) p[e] = v[e];
}

// Four consecutive values of a 16-byte aligned shared array.
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void lds4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
__global__ void __cluster_dims__(RES_CLUSTER, 1, 1)
    __launch_bounds__(RES_THREADS)
    ns_residual_kernel(const T* __restrict__ M, const T* X0, const T* X1,
                       T* __restrict__ E, T* __restrict__ Xout,
                       T* __restrict__ r, int* __restrict__ st, int n,
                       int D, int hb, T tol, int budget, int mode, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / RES_CLUSTER;
  __shared__ int s_go, s_k, s_kt;
  __shared__ T s_part[RES_THREADS / 32];
  __shared__ T s_total;
  int* s = st + 4 * b;
  if (threadIdx.x == 0) {
    // every rank reads the same state: rank 0 writes it only after the
    // cluster's first barrier, or (upd, and k and active of a phase's
    // start) fields the other ranks do not read
    const int k = mode == START ? 0 : s[S_K];
    const int act = mode == START ? (T(INFINITY) > tol) && (0 < budget)
                                  : s[S_ACT];
    const int go = mode == FINAL || act;
    if (!go && rank == 0) {
      if (mode == START) {
        s[S_K] = 0;
        s[S_ACT] = 0;
      }
      s[S_UPD] = 0;
    }
    s_go = go;
    s_k = k;
    s_kt = s[S_KT];
  }
  __syncthreads();
  if (!s_go) return;  // the lane's every rank, before any cluster barrier

  const size_t nn = (size_t)n * n;
  const T* X = ((s_kt & 1) ? X1 : X0) + b * nn;
  const T* Mb = M + b * nn;
  const int nq = (n + CQ - 1) / CQ, nrt = (n + RT - 1) / RT;
  const int per = (nrt + RES_CLUSTER - 1) / RES_CLUSTER;
  const int rt0 = rank * per, rt1 = min(nrt, rt0 + per);
  const int span = (hb + 1) * D;  // hb <= n: no overflow
  const bool quad = vec && n % 4 == 0;
  T ss = 0;
  for (int w = rt0 * nq + threadIdx.x; w < rt1 * nq; w += RES_THREADS) {
    const int c0 = (w % nq) * CQ, i0 = (w / nq) * RT;
    const int cv = min(CQ, n - c0);
    const int lo = max(0, (i0 / D) * D - hb * D);
    const int hi = min(n, ((min(i0 + RT, n) - 1) / D) * D + span);
    T acc[RT][CQ];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr)
#pragma unroll
      for (int cc = 0; cc < CQ; ++cc) acc[rr][cc] = T(0);
    if (quad) {
      // four columns of M and four rows of X a step, every load issued
      // before the products; the range rounded out to multiples of 4 adds
      // only zeros of M, and rows past n are computed but not stored
      for (int j = lo & ~3; j < hi; j += 4) {
        T xv[4][CQ], mv[RT][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load4(X + (size_t)(j + u) * n + c0, CQ, true, xv[u]);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
          load4(Mb + (size_t)min(i0 + rr, n - 1) * n + j, 4, true, mv[rr]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int rr = 0; rr < RT; ++rr)
#pragma unroll
            for (int cc = 0; cc < CQ; ++cc)
              acc[rr][cc] = fma(mv[rr][u], xv[u][cc], acc[rr][cc]);
      }
    } else {
      for (int j = lo; j < hi; ++j) {
        T xv[CQ];
        load4(X + (size_t)j * n + c0, cv, vec, xv);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          const T m =
              i0 + rr < n ? __ldg(Mb + (size_t)(i0 + rr) * n + j) : T(0);
#pragma unroll
          for (int cc = 0; cc < CQ; ++cc)
            acc[rr][cc] = fma(m, xv[cc], acc[rr][cc]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      const int i = i0 + rr;
      if (i < n) {
        T e[CQ];
#pragma unroll
        for (int cc = 0; cc < CQ; ++cc) {
          e[cc] = (i == c0 + cc ? T(1) : T(0)) - acc[rr][cc];
          if (cc < cv) ss = fma(e[cc], e[cc], ss);
        }
        if (mode == FINAL) {
          T xv[CQ];
          load4(X + (size_t)i * n + c0, cv, vec, xv);
          store4(Xout + b * nn + (size_t)i * n + c0, cv, vec, xv);
        } else {
          store4(E + b * nn + (size_t)i * n + c0, cv, vec, e);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_down_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    T tot = 0;
#pragma unroll
    for (int q = 0; q < RES_THREADS / 32; ++q) tot += s_part[q];
    s_total = tot;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    T tot = 0;
#pragma unroll
    for (int q = 0; q < RES_CLUSTER; ++q)
      tot += *cluster.map_shared_rank(&s_total, q);
    const T rn = sqrt_(tot);
    r[b] = rn;
    if (mode == FINAL) {
      s[S_K] = 0;
      s[S_ACT] = !isfinite(rn) || rn > T(1);
      s[S_UPD] = 0;
    } else {
      const int k = s_k + 1;
      s[S_K] = k;
      s[S_KT] = s_kt + 1;
      s[S_ACT] = (rn > tol) && (k < budget);
      s[S_UPD] = 1;
    }
  }
  cluster.sync();  // the ranks keep their shared memory until rank 0 read it
}

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};
__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lane_of(const double2& v, int e) {
  return e == 0 ? v.x : v.y;
}

// A k-step of a thread's register tile: MR of its 8 rows (the near 4 or
// all) by MC of its 8 columns.
template <int MR, int MC, typename T>
__device__ __forceinline__ void tile_step(const T (*As)[BM + APAD],
                                          const T (*Bs)[BN], int ty, int tx,
                                          T (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    T a[8], bv[8];
    lds4(&As[kk][ty * 4], a);
    if constexpr (MR == 8) lds4(&As[kk][BM / 2 + ty * 4], a + 4);
    lds4(&Bs[kk][tx * 4], bv);
    if constexpr (MC == 8) lds4(&Bs[kk][BN / 2 + tx * 4], bv + 4);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MC; ++j) acc[i][j] = fma(a[i], bv[j], acc[i][j]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(UPD_THREADS, sizeof(T) == 4 ? 2 : 1)
    ns_update_kernel(T* X0, T* X1, const T* __restrict__ E,
                     const int* __restrict__ st, int n, int tiles_n) {
  const int b = blockIdx.y;
  const int* s = st + 4 * b;
  if (!s[S_UPD]) return;
  // the residual has counted this iteration: the iterate is in buffer
  // (kt - 1) & 1, the update goes to buffer kt & 1
  const int kt = s[S_KT];
  const size_t nn = (size_t)n * n;
  const T* __restrict__ src = ((kt & 1) ? X0 : X1) + b * nn;
  T* __restrict__ dst = ((kt & 1) ? X1 : X0) + b * nn;
  const T* __restrict__ Eb = E + b * nn;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;

  __shared__ __align__(16) T As[2][BK][BM + APAD];
  __shared__ __align__(16) T Bs[2][BK][BN];
  // An edge tile (112 of 128 rows or columns at n = 240) pads half the
  // products of the warps whose far half lies wholly past n.  A warp's
  // threads share a pair of ty (rows), or, in a tile whose columns alone
  // stop short, a pair of tx (columns: the layout is transposed there), so
  // such a warp computes its near half only (shape 1: rows, 2: columns).
  const int tid = threadIdx.x;
  const bool swap = col0 + BN > n && row0 + BM <= n;
  const int ty = swap ? tid & 15 : tid >> 4, tx = swap ? tid >> 4 : tid & 15;
  const int shape = swap ? (col0 + BN / 2 + (tx & ~1) * 4 < n ? 0 : 2)
                         : (row0 + BM / 2 + (ty & ~1) * 4 < n ? 0 : 1);
  // a tile step's loads: 16-byte vectors (or single values) of X's rows
  // (consecutive threads on consecutive rows, so the transposing stores
  // meet 32 banks) and of E's rows; each thread's addresses fixed but for
  // the step's k0
  using LT = typename std::conditional<VEC, typename Vec16<T>::type, T>::type;
  constexpr int V = VEC ? Vec16<T>::n : 1;
  constexpr int NA = BM * BK / V / UPD_THREADS;
  constexpr int NB = BK * BN / V / UPD_THREADS;
  const T* pa[NA];
  const T* pb[NB];
  int ka[NA], kb[NB];
  bool oka[NA], okb[NB];
#pragma unroll
  for (int q = 0; q < NA; ++q) {
    const int v = tid + UPD_THREADS * q, r = row0 + v % BM;
    ka[q] = (v / BM) * V;
    oka[q] = r < n;
    pa[q] = src + (size_t)min(r, n - 1) * n + ka[q];
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int v = tid + UPD_THREADS * q, c = col0 + (v % (BN / V)) * V;
    kb[q] = v / (BN / V);
    okb[q] = c < n;
    pb[q] = Eb + (size_t)kb[q] * n + min(c, n - V);
  }
  LT fa[NA], fb[NB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < NA; ++q)
      fa[q] = oka[q] && k0 + ka[q] < n
                  ? *reinterpret_cast<const LT*>(pa[q] + k0)
                  : LT{};
#pragma unroll
    for (int q = 0; q < NB; ++q)
      fb[q] = okb[q] && k0 + kb[q] < n
                  ? *reinterpret_cast<const LT*>(pb[q] + (size_t)k0 * n)
                  : LT{};
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int v = tid + UPD_THREADS * q, r = v % BM, k = (v / BM) * V;
      if constexpr (VEC) {
#pragma unroll
        for (int e = 0; e < V; ++e) As[buf][k + e][r] = lane_of(fa[q], e);
      } else {
        As[buf][k][r] = fa[q];
      }
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int v = tid + UPD_THREADS * q;
      *reinterpret_cast<LT*>(&Bs[buf][v / (BN / V)][(v % (BN / V)) * V]) =
          fb[q];
    }
  };

  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  const int nk = (n + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) fetch((t + 1) * BK);
    if (shape == 0)
      tile_step<8, 8>(As[cur], Bs[cur], ty, tx, acc);
    else if (shape == 1)
      tile_step<4, 8>(As[cur], Bs[cur], ty, tx, acc);
    else
      tile_step<8, 4>(As[cur], Bs[cur], ty, tx, acc);
    if (t + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (gr >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + h * (BN / 2) + tx * 4;
      if (gc >= n) continue;
      const int cv = min(4, n - gc);
      T xv[4], o[4];
      load4(src + (size_t)gr * n + gc, cv, VEC, xv);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = xv[e] + acc[i][h * 4 + e];
      store4(dst + (size_t)gr * n + gc, cv, VEC, o);
    }
  }
}

template <typename T>
int residual(const void* M, const void* X0, const void* X1, void* E,
             void* Xout, void* r, int* st, int B, int n, int D,
             int hb, double tol, int budget, int mode, int vec,
             cudaStream_t s) {
  ns_residual_kernel<T><<<B * RES_CLUSTER, RES_THREADS, 0, s>>>(
      (const T*)M, (const T*)X0, (const T*)X1, (T*)E, (T*)Xout, (T*)r, st, n,
      D, hb, (T)tol, budget, mode, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int update(void* X0, void* X1, const void* E, const int* st, int B, int n,
           int vec, cudaStream_t s) {
  const int tiles_m = (n + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const dim3 grid(tiles_m * tiles_n, B);
  if (vec)
    ns_update_kernel<T, true><<<grid, UPD_THREADS, 0, s>>>(
        (T*)X0, (T*)X1, (const T*)E, st, n, tiles_n);
  else
    ns_update_kernel<T, false><<<grid, UPD_THREADS, 0, s>>>(
        (T*)X0, (T*)X1, (const T*)E, st, n, tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One residual launch over B lanes (dtype 0 float, 1 double): see the
// file's head for the modes; E is unused in FINAL, Xout only there.  hb is the block half-bandwidth in steps of D columns, at most
// n.  vec: every pointer is 16-byte aligned and n a multiple of 4 (float)
// or 2 (double).  Returns a CUDA error code.
int ns_residual(int dtype, const void* M, const void* X0, const void* X1,
                void* E, void* Xout, void* r, int* st, int B, int n, int D,
                int hb, double tol, int budget, int mode, int vec,
                void* stream) {
  if (B < 0 || n < 1 || D < 1 || hb < 0 || hb > n || mode < START ||
      mode > FINAL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return residual<float>(M, X0, X1, E, Xout, r, st, B, n, D, hb, tol,
                           budget, mode, vec, s);
  if (dtype == 1)
    return residual<double>(M, X0, X1, E, Xout, r, st, B, n, D, hb, tol,
                            budget, mode, vec, s);
  return (int)cudaErrorInvalidValue;
}

// One update launch over B lanes (at most 65535): X_{kt & 1} = X + X E
// for the lanes whose residual ran.
int ns_update(int dtype, void* X0, void* X1, const void* E, const int* st,
              int B, int n, int vec, void* stream) {
  if (B < 0 || B > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return update<float>(X0, X1, E, st, B, n, vec, s);
  if (dtype == 1) return update<double>(X0, X1, E, st, B, n, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
