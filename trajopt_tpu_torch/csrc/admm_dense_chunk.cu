// Fused dense prox-ADMM chunk for Hopper (sm_90a): one thread-block cluster
// per problem, A and Minv held on chip across the cluster.
//
// Replaces the Pallas TPU kernel trajopt_tpu/qp/pallas_admm.py
// (_admm_chunk_kernel, called by admm_chunk_pallas): `n_iters` relaxed
// prox-ADMM iterations on one dense QP per problem, in the update order of
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
// Design.  Problem b is one cluster of cs blocks of 512 threads, launched
// with a runtime cluster size (cudaLaunchKernelEx), so one build serves
// every shape; fused_dense.cluster_plan picks the least cs in 1..8 whose
// block fits in shared memory (cs = 3 at arm7, n = 210, m = 449, where A
// is 377,160 B and Minv 176,400 B).  Rank r keeps rows [r mr, (r+1) mr) of
// A (mr = ceil(m / cs)) and rows [r nr, (r+1) nr) of Minv (nr = ceil(n /
// cs)) in its shared memory for the whole chunk, at a row stride of n
// rounded up to a multiple of 4 (the pad columns hold 0, so that every
// lane reads 16 bytes at a time), loaded once by cp.async (A first, so
// that the first pass over it overlaps the load of Minv), beside the state
// of its own rows (z, y, Ax, l, u, c/rho, rho, 1/rho).  Column j is owned
// by thread j on every rank (n <= 512); x and q are replicated.  Each
// iteration:
//   1. each rank sums its warps' column partials of A'w (w = rho z - y
//      over its own rows) into p_r and sends p_r into slot r of every
//      rank's partials buffer by st.async, which also counts its bytes on
//      that rank's transaction barrier (mbarrier); each rank waits, then
//      forms rhs = sigma x - q + sum_r p_r, summing the slots in rank order
//      0..cs-1, so rhs is bit-identical on every rank;
//   2. rank r's rows of xt = Minv rhs, a few rows a warp with a transposing
//      butterfly, go the same way into the xt buffer of every rank, and
//      each rank waits until all n values have arrived;
//   3. every rank updates its copy of x from the whole xt (the same
//      instructions on the same data, so the copies stay bit-identical
//      with no further exchange), then makes one pass over its own rows
//      of A, a few rows a warp at a time, that computes zt_i = A_i . xt;
//      the lane that ends with zt_i applies the row's update, and every
//      lane then adds A_i' w_i for the group's rows to its columns' sums
//      from the values of A still in its registers (except in the last
//      iteration).  So A is read once an iteration, and once before the
//      first for A x and A'w.
// Two exchanges and two barrier waits an iteration; no cluster.sync() in
// the loop (its release compiles to a GPU-scope fence, MEMBAR.ALL.GPU on
// sm_90a) and no atomics or rank-dependent summation order in any
// replicated value.  Both exchange buffers are double-buffered, so one
// wait per exchange is enough: a rank writes buffer it & 1 of a peer again
// only in iteration it + 2, after that peer has sent what it sends only
// after reading that buffer in iteration it.  An inactive lane's cluster
// returns before its first cluster barrier (every rank reads the same
// active[b]); every other block ends with a cluster barrier after its last
// access to a peer's shared memory.  y / rho is y * (1 / rho), 1 / rho
// taken once a launch, as the block kernel does.
//
// What bounds it: latency inside each block, then the waves, not device
// memory.  Device memory is read once a launch (A and Minv: 70.9 MB at
// arm7 and B = 128); the iterations read A and Minv from shared memory
// (1.465 GB a chunk at arm7 and B = 128, 0.044 ms at 128 B/clk on 132 SMs
// at 1980 MHz).  At ~212 KB a block one block fits on an SM, so B = 128
// problems run in about three to four waves of 3-block clusters.  Per
// iteration a block's 16 warps wait on each other at two barriers and two
// exchanges, and each pass over its rows of A or Minv is a chain of
// loads, a butterfly and a row update per group of rows.  The work's own
// bound is 0.0219 ms (bytes: every input read once, fused_dense.
// chunk_bytes); this design's floor, the shared-memory reads plus one load
// of A and Minv, is ~0.065 ms (chip_smoke.py phase 4 prints both and the
// measured time).
//
// The streaming kernel further down (one block of 512 threads per problem,
// A and Minv read from device memory every iteration) serves the shapes no
// cluster of 8 blocks holds (A and Minv together past 8 blocks' shared
// memory, such as n 400, m 1200), so that the dense path takes every shape
// with n <= 512: fused_dense.cluster_plan returns cs = 0 for them, and the
// launcher picks the kernel from that, before any launch.
//
// NaN: every max/min propagates NaN (fmaxf/fminf would drop it), so a
// blown-up QP stays NaN and reads as not converged, as the JAX version
// does.  Infinite c/rho on hard rows stays exact: max(u, v - inf) = u and
// min(l, v + inf) = l.  A lane with active[b] == 0 is skipped and its
// outputs are not written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_N = NT;        // one column per thread: n <= 512
constexpr int MAX_CS = 8;        // largest portable cluster
constexpr int STREAM_CPL = NT / 32;  // column slots per lane, streaming

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
__device__ __forceinline__ void lane_cols(const float* v,
                                          float (&r)[STREAM_CPL], int n,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < STREAM_CPL; ++k) {
    const int j = lane + 32 * k;
    r[k] = j < n ? v[j] : 0.f;
  }
}

// dst[i] = M[i, :] . v for the rows of a row-major [rows, n] matrix in
// global memory; one warp per row, v spread over the lanes.
__device__ __forceinline__ void matvec(const float* __restrict__ M,
                                       const float (&v)[STREAM_CPL],
                                       float* dst, int rows, int n, int warp,
                                       int lane) {
  for (int i = warp; i < rows; i += NWARP) {
    const float* row = M + (size_t)i * n;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < STREAM_CPL; ++k) {
      const int j = lane + 32 * k;
      if (j < n) s += __ldg(row + j) * v[k];
    }
    s = warp_sum(s);
    if (lane == 0) dst[i] = s;
  }
}

struct Rows {            // row state in shared memory, [m] each
  float *z, *y, *ax;
  const float *l, *u, *cr, *rho, *irho;   // irho: 1 / rho (cluster kernel)
};

// One pass over the rows of A in global memory, one warp per row:
// d_i = A_i . v.  With `first` it only sets Ax_i = d_i; otherwise d_i is
// zt_i and the row takes its relaxed update.  With `accumulate` the warp
// adds A_i' w_i (w_i = rho_i z_i - y_i, updated) to its lanes' column sums,
// which land in part[warp * n + j].  The streaming kernel's pass.
__device__ __forceinline__ void row_pass(const float* __restrict__ A,
                                         const float (&v)[STREAM_CPL], Rows r,
                                         float* part, int m, int n,
                                         float alpha, bool first,
                                         bool accumulate, int warp,
                                         int lane) {
  float acc[STREAM_CPL];
#pragma unroll
  for (int k = 0; k < STREAM_CPL; ++k) acc[k] = 0.f;
  const float oma = 1.f - alpha;
  for (int i = warp; i < m; i += NWARP) {
    const float* row = A + (size_t)i * n;
    float a[STREAM_CPL];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < STREAM_CPL; ++k) {
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
      for (int k = 0; k < STREAM_CPL; ++k) acc[k] += a[k] * w;
    }
  }
  if (accumulate) {
#pragma unroll
    for (int k = 0; k < STREAM_CPL; ++k) {
      const int j = lane + 32 * k;
      if (j < n) part[warp * n + j] = acc[k];
    }
  }
}

// Sums kR rows' lane partials s[0..kR) over the warp: a transposing
// butterfly that halves the rows a lane keeps at each step (lanes with the
// step's bit set keep the upper half), then sums the 32 / kR lanes left
// for each row; 9 shuffles for 8 rows instead of 40.  Returns, on every
// lane, the sum of row lane / (32 / kR).  Every lane of the warp calls it.
template <int kR>
__device__ __forceinline__ float fold_rows(float (&s)[kR], int lane) {
  const unsigned F = 0xffffffffu;
#pragma unroll
  for (int h = kR / 2, bit = 16; h > 0; h >>= 1, bit >>= 1) {
    const bool hi = lane & bit;
#pragma unroll
    for (int q = 0; q < h; ++q)
      s[q] = (hi ? s[q + h] : s[q])
             + __shfl_xor_sync(F, hi ? s[q] : s[q + h], bit);
  }
  float t = s[0];
#pragma unroll
  for (int bit = 16 / kR; bit > 0; bit >>= 1)
    t += __shfl_xor_sync(F, t, bit);
  return t;
}

// r[c] = v[4 lane + 128 c .. + 3] (0 from ns on): a row of ns floats (n
// rounded up to a multiple of 4, the pad columns 0) spread over the lanes,
// one float4 per 128-column chunk.
template <int kC4>
__device__ __forceinline__ void lane_cols4(const float* v, float4 (&r)[kC4],
                                           int ns, int lane) {
#pragma unroll
  for (int c = 0; c < kC4; ++c) {
    const int j = 4 * lane + 128 * c;
    r[c] = j < ns ? *reinterpret_cast<const float4*>(v + j)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 x, float s) {
  s += a.x * x.x;
  s += a.y * x.y;
  s += a.z * x.z;
  s += a.w * x.w;
  return s;
}

// M_i . x for the kR rows i = base .. base + kR - 1 of a row-major [*, ns]
// matrix in shared memory (rows from base + nq on count as 0), x spread
// over the lanes by lane_cols4.  Each lane loads 16 bytes a row and chunk
// (a warp reads 512 contiguous bytes, free of bank conflicts); the values
// stay in a.  Returns, on every lane, the value of row base + lane /
// (32 / kR).  Every lane of the warp calls it.
template <int kR, int kC4>
__device__ __forceinline__ float dot_group(const float* M, int ns, int base,
                                           int nq, const float4 (&x)[kC4],
                                           float4 (&a)[kR][kC4], int lane) {
  const float* m0 = M + (size_t)base * ns + 4 * lane;
  float s[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    s[q] = 0.f;
#pragma unroll
    for (int c = 0; c < kC4; ++c) {
      a[q][c] = q < nq && 4 * lane + 128 * c < ns
          ? *reinterpret_cast<const float4*>(m0 + q * ns + 128 * c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      s[q] = dot4(a[q][c], x[c], s[q]);
    }
  }
  return fold_rows<kR>(s, lane);
}

// One pass over the m rows of A in shared memory ([m, ns]), kR rows a warp
// at a time (warp w takes the groups starting at kR w, kR (w + NWARP),
// ...): d_i = A_i . v, v in shared memory ([ns]).  The lane that holds d_i
// after dot_group updates row i: with `first` only Ax_i = d_i, otherwise
// d_i is zt_i and the row takes its relaxed update.  With `accumulate`
// every lane then adds A_i' w_i (w_i = rho_i z_i - y_i, updated) for the
// group's rows to its columns' sums from the values of A dot_group left
// in its registers, so A is read once; the sums land in
// part[warp * ns + j].
template <int kR, int kC4>
__device__ __forceinline__ void group_pass(const float* A, int ns,
                                           const float* v, Rows r,
                                           float* part, int m, float alpha,
                                           bool first, bool accumulate,
                                           int warp, int lane) {
  constexpr int kLanes = 32 / kR;            // lanes that end with one row
  float4 x[kC4], acc[kC4];
  lane_cols4(v, x, ns, lane);
#pragma unroll
  for (int c = 0; c < kC4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float oma = 1.f - alpha;
  for (int base = kR * warp; base < m; base += kR * NWARP) {
    float4 a[kR][kC4];
    const float d = dot_group<kR, kC4>(A, ns, base, min(kR, m - base), x, a,
                                       lane);
    const int i = base + lane / kLanes;
    float w = 0.f;
    if (lane % kLanes == 0 && i < m) {
      float zi = r.z[i], yi = r.y[i], axi = d;
      const float rho = r.rho[i];
      if (!first) {
        axi = alpha * d + oma * r.ax[i];
        const float zr = alpha * d + oma * zi;
        const float vv = zr + yi * r.irho[i];
        const float lo = r.l[i], hi = r.u[i];
        float zn;
        if (vv > hi) zn = pmax(hi, vv - r.cr[i]);
        else if (vv < lo) zn = pmin(lo, vv + r.cr[i]);
        else zn = vv;
        yi = yi + rho * (zr - zn);
        zi = zn;
        r.z[i] = zi;
        r.y[i] = yi;
      }
      r.ax[i] = axi;
      w = rho * zi - yi;
    }
    if (accumulate) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const float wq = __shfl_sync(0xffffffffu, w, q * kLanes);
#pragma unroll
        for (int c = 0; c < kC4; ++c) {
          acc[c].x += a[q][c].x * wq;
          acc[c].y += a[q][c].y * wq;
          acc[c].z += a[q][c].z * wq;
          acc[c].w += a[q][c].w * wq;
        }
      }
    }
  }
  if (accumulate) {
#pragma unroll
    for (int c = 0; c < kC4; ++c) {
      const int j = 4 * lane + 128 * c;
      if (j < ns) *reinterpret_cast<float4*>(part + warp * ns + j) = acc[c];
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// One arrival that also expects `bytes` more of the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Until the phase of this parity completes; what its transaction wrote,
// from any rank, is then visible (acquire at cluster scope).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile("{\n"
               ".reg .pred P1;\n"
               "LAB_WAIT:\n"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
               "P1, [%0], %1;\n"
               "@P1 bra DONE;\n"
               "bra LAB_WAIT;\n"
               "DONE:\n"
               "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// *dst = v in rank q's shared memory, completing 4 bytes of the
// transaction on rank q's copy of bar (distributed shared memory).
__device__ __forceinline__ void st_async(float* dst, uint64_t* bar,
                                         unsigned q, float v) {
  uint32_t a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_u32(dst)), "r"(q));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(b) : "r"(smem_u32(bar)), "r"(q));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
               "[%0], %1, [%2];"
               :: "r"(a), "r"(__float_as_uint(v)), "r"(b) : "memory");
}
// *dst = *src, 4 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Until at most `kPending` of this thread's newest groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Floats rounded up to 16 bytes, so that every region is float4-aligned.
__host__ __device__ constexpr size_t round4(size_t x) {
  return (x + 3) & ~(size_t)3;
}

// Shared-memory floats of one block of a cs-block cluster, with rows of
// ns = round4(n) floats: four mbarriers (8 floats), A rows [mr, ns], Minv
// rows [nr, ns], the row state [8, mr], warp column sums [NWARP, ns],
// partials buffers [2, cs, n], xt buffers [2, ns], rhs [ns].
// fused_dense.cluster_plan repeats this layout to pick cs without a card;
// admm_dense_chunk_prepare checks the two agree, once per shape.
size_t cluster_smem_floats(int n, int m, int cs) {
  const size_t mr = (size_t)(m + cs - 1) / cs, nr = (size_t)(n + cs - 1) / cs;
  const size_t ns = round4(n);
  return 8 + (mr + nr + NWARP + 3) * ns + 8 * round4(mr)
         + round4(2 * (size_t)cs * n);
}

// Shared-memory floats of one block of the streaming kernel: the row state
// [7, m], rhs and xt [2, n], warp column sums [NWARP, n].
size_t stream_smem_floats(int n, int m) {
  return 7 * (size_t)m + 2 * (size_t)n + NWARP * (size_t)n;
}

struct Args {
  const float *Minv, *A, *q, *l, *u, *cr, *rho, *x, *z, *y;
  float *x_o, *z_o, *y_o, *ax_o;
  const int32_t* active;
  int m, n;
  float sigma, alpha;
  int n_iters;
};

// The cluster kernel; its passes over A and Minv take kR rows a warp at a
// time and kC4 chunks of 128 columns a warp (n <= 128 kC4).
template <int kR, int kC4>
__global__ void __launch_bounds__(NT, 1) admm_dense_chunk_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  if (a.active != nullptr && a.active[b] == 0) return;   // whole cluster
  const int m = a.m, n = a.n, ns = (int)round4(n);
  const int mr = (m + cs - 1) / cs, nr = (n + cs - 1) / cs;
  const int r0 = min(m, rank * mr), r1 = min(m, r0 + mr);  // its A rows
  const int i0 = min(n, rank * nr), i1 = min(n, i0 + nr);  // its Minv rows
  const int rows = r1 - r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) float sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);  // [2] partials, [2] xt
  float* sA = sm + 8;                           // [mr, ns]  A rows r0..r1
  float* sM = sA + (size_t)mr * ns;             // [nr, ns]  Minv rows i0..i1
  const size_t mr4 = round4(mr);
  float* sz = sM + (size_t)nr * ns;             // [mr] each: z, y, Ax, l,
  float* sy = sz + mr4;                         // u, c/rho, rho, 1/rho
  float* sax = sy + mr4;
  float* sl = sax + mr4;
  float* su = sl + mr4;
  float* scr = su + mr4;
  float* srho = scr + mr4;
  float* sirho = srho + mr4;
  float* spart = sirho + mr4;                   // [NWARP, ns]
  float* sxt = spart + (size_t)NWARP * ns;      // [2, ns]  xt
  float* srhs = sxt + 2 * (size_t)ns;           // [ns]  x, then rhs
  float* sp = srhs + ns;                        // [2, cs, n]  partials
  const Rows st{sz, sy, sax, sl, su, scr, srho, sirho};

  // A's rows, then Minv's, in two groups of asynchronous copies, a warp a
  // row; the pad columns n..ns-1 hold 0
  const float* Ag = a.A + ((size_t)b * m + r0) * n;
  for (int r = warp; r < rows; r += NWARP) {
    for (int c = lane; c < n; c += 32)
      cp_async4(sA + (size_t)r * ns + c, Ag + (size_t)r * n + c);
    if (lane < ns - n) sA[(size_t)r * ns + n + lane] = 0.f;
  }
  cp_async_commit();
  const float* Mg = a.Minv + ((size_t)b * n + i0) * n;
  for (int r = warp; r < i1 - i0; r += NWARP) {
    for (int c = lane; c < n; c += 32)
      cp_async4(sM + (size_t)r * ns + c, Mg + (size_t)r * n + c);
    if (lane < ns - n) sM[(size_t)r * ns + n + lane] = 0.f;
  }
  cp_async_commit();
  const size_t bm = (size_t)b * m + r0, bn = (size_t)b * n;
  for (int i = tid; i < rows; i += NT) {
    sz[i] = a.z[bm + i]; sy[i] = a.y[bm + i]; sl[i] = a.l[bm + i];
    su[i] = a.u[bm + i]; scr[i] = a.cr[bm + i]; srho[i] = a.rho[bm + i];
    sirho[i] = 1.f / srho[i];
  }
  // column j is owned by thread j
  const bool owner = tid < n;
  float cx = 0.f, cq = 0.f;
  if (owner) {
    cx = a.x[bn + tid];
    cq = a.q[bn + tid];
  }
  if (tid < ns) {
    srhs[tid] = cx;                      // 0 in the pad columns
    sxt[tid] = 0.f;
    sxt[ns + tid] = 0.f;
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) mbar_init(&bars[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float sigma = a.sigma, alpha = a.alpha, oma = 1.f - alpha;
  cp_async_wait<1>();      // this thread's copies of A have landed
  __syncthreads();

  // Ax = A x and the first A'(rho z - y), over this rank's rows
  group_pass<kR, kC4>(sA, ns, srhs, st, spart, rows, alpha, true,
                      a.n_iters > 0, warp, lane);
  cp_async_wait<0>();
  // Every rank has loaded Minv, set up its barriers and written its column
  // sums before the first remote write.
  cluster.sync();

  constexpr int kL = 32 / kR;                // lanes that end with one row
  for (int it = 0; it < a.n_iters; ++it) {
    const int par = it & 1;
    const unsigned phase = (it >> 1) & 1;
    uint64_t* barp = &bars[par];
    uint64_t* barx = &bars[2 + par];
    float* pbuf = sp + (size_t)par * cs * n;
    float* xbuf = sxt + (size_t)par * ns;
    if (tid == 0) {
      mbar_expect_tx(barp, 4u * n * cs);     // cs partials of n
      mbar_expect_tx(barx, 4u * n);          // all n values of xt
    }
    // exchange 1: this rank's partial of A'w into slot `rank` everywhere
    if (owner) {
      float p = 0.f;
      for (int w = 0; w < NWARP; ++w) p += spart[w * ns + tid];
      for (int q = 0; q < cs; ++q)
        st_async(pbuf + rank * n + tid, barp, q, p);
    }
    mbar_wait(barp, phase);
    if (owner) {
      float atw = 0.f;
      for (int q = 0; q < cs; ++q) atw += pbuf[q * n + tid];  // rank order
      srhs[tid] = sigma * cx - cq + atw;
    }
    __syncthreads();
    // exchange 2: this rank's rows of xt = Minv rhs, kR a warp at a time;
    // each value goes into the xt buffer of every rank
    {
      float4 v[kC4];
      lane_cols4(srhs, v, ns, lane);
      for (int base = i0 + kR * warp; base < i1; base += kR * NWARP) {
        float4 mv[kR][kC4];
        const float s = dot_group<kR, kC4>(sM, ns, base - i0,
                                           min(kR, i1 - base), v, mv, lane);
        const int i = base + lane / kL;
        if (i < i1)
          for (int q = lane % kL; q < cs; q += kL)
            st_async(xbuf + i, barx, q, s);
      }
    }
    mbar_wait(barx, phase);
    if (owner) cx = alpha * xbuf[tid] + oma * cx;
    group_pass<kR, kC4>(sA, ns, xbuf, st, spart, rows, alpha, false,
                        it + 1 < a.n_iters, warp, lane);
    __syncthreads();
  }

  if (rank == 0 && owner) a.x_o[bn + tid] = cx;
  for (int i = tid; i < rows; i += NT) {
    a.z_o[bm + i] = sz[i]; a.y_o[bm + i] = sy[i]; a.ax_o[bm + i] = sax[i];
  }
  // After the last access to a peer's shared memory: every block may exit.
  cluster.sync();
}

// The streaming kernel (see the note at the top): one block per problem.
// Row state (z, y, Ax, l, u, c/rho, rho) lives in shared memory, column
// state (x, q) in the register of the thread that owns the column.  Each
// iteration makes two passes over device memory: xt = Minv rhs, one warp
// per row of Minv; then one pass over the rows of A that computes
// zt_i = A_i . xt, the row's update and the next iteration's A_i' w_i.
// Three __syncthreads per iteration.
__global__ void __launch_bounds__(NT, 1) admm_dense_stream_kernel(Args a) {
  const int b = blockIdx.x;
  if (a.active != nullptr && a.active[b] == 0) return;
  const int m = a.m, n = a.n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) float sm[];
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
  const Rows rows{sz, sy, sax, sl, su, scr, srho, nullptr};

  const size_t bm = (size_t)b * m, bn = (size_t)b * n;
  const float* Minv = a.Minv + (size_t)b * n * n;
  const float* A = a.A + (size_t)b * m * n;
  for (int i = tid; i < m; i += NT) {
    sz[i] = a.z[bm + i]; sy[i] = a.y[bm + i]; sl[i] = a.l[bm + i];
    su[i] = a.u[bm + i]; scr[i] = a.cr[bm + i]; srho[i] = a.rho[bm + i];
  }
  const bool owner = tid < n;
  float cx = 0.f, cq = 0.f;
  if (owner) {
    cx = a.x[bn + tid];
    cq = a.q[bn + tid];
    sxt[tid] = cx;
  }
  const float sigma = a.sigma, alpha = a.alpha;
  float v[STREAM_CPL];
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
    row_pass(A, v, rows, spart, m, n, alpha, false, it + 1 < a.n_iters, warp,
             lane);
    __syncthreads();
  }

  if (owner) a.x_o[bn + tid] = cx;
  for (int i = tid; i < m; i += NT) {
    a.z_o[bm + i] = sz[i]; a.y_o[bm + i] = sy[i]; a.ax_o[bm + i] = sax[i];
  }
}

typedef void (*Kernel)(Args);

// The cluster kernel with the fewest 128-column chunks that cover n; the
// wider the rows, the fewer a group holds, so that its values of A stay in
// registers (32 floats a lane) with no spill.
Kernel cluster_kernel(int n) {
  if (n <= 128) return admm_dense_chunk_kernel<8, 1>;
  if (n <= 256) return admm_dense_chunk_kernel<4, 2>;
  return admm_dense_chunk_kernel<2, 4>;
}

// Launch configuration for cs-block clusters of a shape; its dynamic shared
// memory is this file's own layout (cluster_smem_floats).
cudaError_t configure(int n, int m, int cs, int grid, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (n < 1 || n > MAX_N || m < 0 || cs < 1 || cs > MAX_CS)
    return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = sizeof(float) * cluster_smem_floats(n, m, cs);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Once per device and shape, before the first launch: checks that `smem`,
// the bytes per block that fused_dense.cluster_plan computed for cs (0: the
// streaming kernel), is this file's layout, lets the kernel take the
// device's whole opt-in shared memory (enough for every shape) and stores
// in *resident how many problems the card runs at once: clusters of cs
// blocks (cudaOccupancyMaxActiveClusters), or streaming blocks.  Returns a
// CUDA error: cudaErrorInvalidValue when the shape or the layout does not
// fit.
int admm_dense_chunk_prepare(int n, int m, int cs, size_t smem,
                             int* resident) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (cs == 0) {
    if (n < 1 || n > MAX_N || m < 0
        || smem != sizeof(float) * stream_smem_floats(n, m))
      return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(admm_dense_stream_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, admm_dense_stream_kernel, NT, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *resident = per_sm * sms;
    return (int)e;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = configure(n, m, cs, cs, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  if (cfg.dynamicSmemBytes != smem) return (int)cudaErrorInvalidValue;
  const Kernel kernel = cluster_kernel(n);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(resident, (const void*)kernel,
                                             &cfg);
}

// Launch one chunk on `stream` for B problems, one cluster of cs blocks
// each (cs = 0: one streaming block each), after admm_dense_chunk_prepare
// for this device and shape.  `active` may be null; a problem with
// active[b] == 0 is skipped and its outputs are not written.  Returns the
// launch's CUDA error.
int admm_dense_chunk(const void* Minv, const void* A, const void* q,
                     const void* l, const void* u, const void* cr,
                     const void* rho, const void* x, const void* z,
                     const void* y, void* x_o, void* z_o, void* y_o,
                     void* ax_o, const void* active, int B, int m, int n,
                     int cs, float sigma, float alpha, int n_iters,
                     void* stream) {
  Args a;
  a.Minv = (const float*)Minv; a.A = (const float*)A; a.q = (const float*)q;
  a.l = (const float*)l; a.u = (const float*)u; a.cr = (const float*)cr;
  a.rho = (const float*)rho; a.x = (const float*)x; a.z = (const float*)z;
  a.y = (const float*)y;
  a.x_o = (float*)x_o; a.z_o = (float*)z_o; a.y_o = (float*)y_o;
  a.ax_o = (float*)ax_o;
  a.active = (const int32_t*)active;
  a.m = m; a.n = n; a.sigma = sigma; a.alpha = alpha; a.n_iters = n_iters;
  if (cs == 0) {
    if (n < 1 || n > MAX_N || m < 0) return (int)cudaErrorInvalidValue;
    admm_dense_stream_kernel<<<B, NT, sizeof(float) * stream_smem_floats(n, m),
                               (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(n, m, cs, B * cs, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = (cudaStream_t)stream;
  e = cudaLaunchKernelEx(&cfg, cluster_kernel(n), a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
