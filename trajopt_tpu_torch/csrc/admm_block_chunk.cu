// Fused block-banded prox-ADMM chunk for Hopper (sm_90a): one thread-block
// cluster per problem, Minv held on chip across the cluster.
//
// Replaces the Pallas TPU kernel trajopt_tpu/qp/pallas_block.py:182
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
// Design.  Problem b is one cluster of cs blocks of 512 threads, launched
// with a runtime cluster size (cudaLaunchKernelEx), so one build serves
// every shape; fused_block.cluster_plan picks the least cs in {1, 2, 4, 8}
// whose block fits in shared memory (cs = 2 at the flagship T 30, D 8, K 2,
// R 40, where Minv alone is 230,400 B).  Rank r keeps rows
// [r nr, (r+1) nr) of Minv (nr = ceil(n / cs); 115,200 B at the flagship)
// resident in its shared memory for the whole chunk, beside a full copy of
// the banded weights (odd row stride KD | 1, so the row-owned C product is
// free of bank conflicts), w, rhs and a double-buffered xt.  Each
// iteration every rank computes the whole w and rhs from its own copies
// (the banded work, replicated instead of exchanging halos), then its
// slice of xt = Minv rhs, eight rows a warp; each value goes into the xt
// buffer of every rank by st.async, which also counts its bytes on that
// rank's transaction barrier (mbarrier), and each rank waits until all n
// values of the iteration have arrived.  That is the one exchange per
// iteration.  Every rank then runs the same column (x, zb, yb) and row
// (zc, yc) updates on the same data, with no atomics and no rank-dependent
// order, so their copies of the state stay bit-identical with no second
// exchange.  The double buffer makes one wait per iteration enough: a rank
// can only write buffer it & 1 again after every peer has sent its rows of
// iteration it + 1, which each does after reading that buffer.  A
// cluster.sync() in place of the transaction barrier would put a GPU-scope
// fence into every iteration (its release compiles to MEMBAR.ALL.GPU on
// sm_90a); the wait on the barrier needs none.  Row state (zc, yc, l, u,
// c/rho, rho) and column state (x, zb, yb, q, lb, ub, b) stay in registers
// of the thread that owns the row or column.
//
// Statistics: rank r computes P x for its own rows (P read once from global
// memory) and evaluates the column terms of those columns and the row terms
// of its own share of rows, so the Px slices need no exchange; the five
// NaN-propagating maxima are reduced into rank 0 through distributed shared
// memory, and rank 0 writes the statistics and the state.  An inactive
// lane's cluster returns before its first cluster barrier (every rank reads
// the same active[b]); every other block ends after a cluster barrier that
// follows its last access to a peer's shared memory.
//
// What bounds it: shared-memory traffic and the waves, not device memory.
// Per iteration a flagship rank issues ~900 warp-wide loads of its Minv
// slice and ~2,400 for the replicated banded products C' w and C xt and
// their vectors; device memory is read once per launch (Minv, Wb, P:
// ~0.14 GB at B = 256).  At ~206 KB a block one block fits on an SM, so
// B = 256 problems run in 256 / 66 = 3.9 waves of 2-block clusters.  The
// work's own bound is 0.109 ms (7.30 GFLOP at the fp32 peak,
// fused_block.chunk_flops); this design's floor, Minv read from shared
// memory once per iteration at 128 B/clk on 132 SMs plus one load of Minv
// and Wb, is 0.288 ms.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 3): 2.158 ms per 150-iteration chunk on the
// flagship's first QP at B = 256, 7.5x this floor, against 9.62 ms for
// the earlier design that streamed Minv from device memory every
// iteration (its floor: 2.64 ms).
//
// NaN: every max/min/clip propagates NaN (fmaxf/fminf would drop it), so
// a blown-up QP reports NaN statistics and reads as not converged, as the
// JAX version does.  Infinite c/rho on hard rows and inert padded rows
// (l = -inf, u = +inf, W = 0) stay exact: max(u, v - inf) = u and
// min(l, v + inf) = l.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_N = NT;        // one column per thread: n <= 512
constexpr int MAX_ROWS = 4;      // rows per thread: T*R <= 2048
constexpr int MAX_CS = 8;        // largest portable cluster

__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;   // NaN-propagating max
}
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;   // NaN-propagating min
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = pmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A[i, :n] . v for the eight rows i = i_base .. i_base + 7 of a row-major
// [*, n] matrix (rows from i_end on count as 0), with v = v0 (+ v1 when
// kTwo) in shared memory.  Lanes stride the columns (coalesced, free of
// bank conflicts); the full 32-column chunks of eight full rows run
// without per-element tests, so each chunk's eight loads issue together.
// A transposing butterfly sums the eight rows in 9 shuffles instead of 40.
// Returns, on every lane, the value of row i_base + (lane >> 2).  Every
// lane of the warp calls it.
template <bool kGlobal, bool kTwo>
__device__ __forceinline__ float dot8(const float* __restrict__ A, int i_base,
                                      int i_end, const float* v0,
                                      const float* v1, int n, int lane) {
  float v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = 0.f;
  const int nq = min(8, i_end - i_base);
  const float* a0 = A + (size_t)i_base * n + lane;
  const int nfull = n >> 5;
  if (nq == 8) {
#pragma unroll 2
    for (int c = 0; c < nfull; ++c) {
      const int off = 32 * c;
      const float x = kTwo ? v0[lane + off] + v1[lane + off] : v0[lane + off];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] += (kGlobal ? __ldg(a0 + q * n + off) : a0[q * n + off]) * x;
    }
  } else {
    for (int c = 0; c < nfull; ++c) {
      const int off = 32 * c;
      const float x = kTwo ? v0[lane + off] + v1[lane + off] : v0[lane + off];
      for (int q = 0; q < nq; ++q)
        v[q] += (kGlobal ? __ldg(a0 + q * n + off) : a0[q * n + off]) * x;
    }
  }
  const int off = 32 * nfull;                // the last, partial chunk
  if (lane + off < n) {
    const float x = kTwo ? v0[lane + off] + v1[lane + off] : v0[lane + off];
    for (int q = 0; q < nq; ++q)
      v[q] += (kGlobal ? __ldg(a0 + q * n + off) : a0[q * n + off]) * x;
  }
  // lanes with bit 4 set keep rows 4..7, the others rows 0..3; then bit 3
  // halves those, bit 2 picks one; bits 1 and 0 sum the four lanes left.
  const unsigned F = 0xffffffffu;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w[4], u[2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = (b4 ? v[q + 4] : v[q])
           + __shfl_xor_sync(F, b4 ? v[q] : v[q + 4], 16);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    u[q] = (b3 ? w[q + 2] : w[q])
           + __shfl_xor_sync(F, b3 ? w[q] : w[q + 2], 8);
  float s = (b2 ? u[1] : u[0]) + __shfl_xor_sync(F, b2 ? u[0] : u[1], 4);
  s += __shfl_xor_sync(F, s, 2);
  s += __shfl_xor_sync(F, s, 1);
  return s;
}

// Rows rr in [rlo, rhi) of (C' v)[j] for column j = jt*D + jd, which is
// part kk of the window of step jt - kk (two accumulators, so consecutive
// products do not wait on each other).
__device__ __forceinline__ float ct_col(const float* sW, const float* v,
                                        int jt, int jd, int rlo, int rhi,
                                        int K, int R, int D, int KDp) {
  float a0 = 0.f, a1 = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    const int tt = jt - kk;
    if (tt < 0) break;
    const float* wc = sW + (size_t)tt * R * KDp + kk * D + jd;
    const float* wv = v + tt * R;
    int rr = rlo;
    if ((R & 3) == 0) {              // w four rows at a time (aligned)
#pragma unroll 2
      for (; rr < rhi; rr += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wv + rr);
        a0 += wc[rr * KDp] * w4.x;
        a1 += wc[(rr + 1) * KDp] * w4.y;
        a0 += wc[(rr + 2) * KDp] * w4.z;
        a1 += wc[(rr + 3) * KDp] * w4.w;
      }
    }
#pragma unroll 2
    for (; rr + 1 < rhi; rr += 2) {
      a0 += wc[rr * KDp] * wv[rr];
      a1 += wc[(rr + 1) * KDp] * wv[rr + 1];
    }
    if (rr < rhi) a0 += wc[rr * KDp] * wv[rr];
  }
  return a0 + a1;
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

// Floats rounded up to 16 bytes, so that every region is float4-aligned.
__host__ __device__ constexpr size_t round4(size_t x) {
  return (x + 3) & ~(size_t)3;
}

// Shared-memory floats of one block: two mbarriers (4 floats), Minv rows
// [nr, n], weights [m, KDp], w [m], rhs halves [2, n], xt buffers [2, n],
// warp maxima [NWARP, 5], cluster maxima [MAX_CS, 5].  fused_block.
// cluster_plan repeats this layout to pick cs without a card;
// admm_block_chunk_prepare checks the two agree, once per shape.
size_t smem_floats(int n, int m, int KDp, int cs) {
  const size_t nr = (size_t)(n + cs - 1) / cs;
  return 4 + round4(nr * n) + round4((size_t)m * KDp) + round4(m)
         + 2 * round4(2 * (size_t)n) + NWARP * 5 + MAX_CS * 5;
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

__global__ void __launch_bounds__(NT, 1) admm_block_chunk_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  if (a.active != nullptr && a.active[b] == 0) return;   // whole cluster
  const int T = a.T, D = a.D, K = a.K, R = a.R;
  const int KD = K * D, KDp = KD | 1;  // odd smem row stride
  const int n = T * D, m = T * R;
  const int nr = (n + cs - 1) / cs;
  const int i0 = rank * nr, i1 = min(n, i0 + nr);   // this rank's rows
  const int mr = (m + cs - 1) / cs;
  const int r0 = rank * mr, r1 = min(m, r0 + mr);   // its share of C's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) float sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);  // [2]  xt buffer full
  float* sM = sm + 4;                      // [nr, n]  Minv rows i0..i1
  float* sW = sM + round4((size_t)nr * n);   // [m, KDp]
  float* sw = sW + round4((size_t)m * KDp);  // [m]  w, then yc
  float* srhs = sw + round4(m);            // [2, n]  rhs halves, then x
  float* sxt = srhs + round4(2 * n);       // [2, n]  xt, then Px
  float* sred = sxt + round4(2 * n);       // [NWARP, 5]
  float* sclu = sred + NWARP * 5;          // [MAX_CS, 5]  on rank 0

  const float* Wg = a.Wb + (size_t)b * m * KD;
  for (int i = tid; i < m * KD; i += NT) {
    const int r = i / KD, c = i - r * KD;
    sW[r * KDp + c] = __ldg(Wg + i);
  }
  const float* Mg = a.Minv + ((size_t)b * n + i0) * n;
  for (int i = tid; i < (i1 - i0) * n; i += NT) sM[i] = __ldg(Mg + i);
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;

  // Thread j < n owns column j.  When the columns fit half the block
  // (2 n <= NT), C' w splits over the two halves: half h sums the rows
  // rr in [rlo, rhi) of each step for column jh into rhs half h.
  const int j = tid;
  const bool col = j < n;
  const int jt = col ? j / D : 0, jd = j - jt * D;
  const bool halves = 2 * n <= NT;
  const int h = halves && tid >= NT / 2 ? 1 : 0;
  const int jh = tid - h * (NT / 2);
  const bool in_h = jh < n;
  const int ht = in_h ? jh / D : 0, hd = jh - ht * D;
  const int Rh = min(R, (R + 7) / 8 * 4);  // about half of R, a multiple
  const int rlo = h * Rh, rhi = halves && h == 0 ? Rh : R;  // of 4 if R is
  float cx = 0.f, czb = 0.f, cyb = 0.f, cq = 0.f, clb = 0.f, cub = 0.f;
  float cbd = 0.f;
  if (col) {
    cx = a.x[bn + j]; czb = a.zb[bn + j]; cyb = a.yb[bn + j];
    cq = a.q[bn + j]; clb = a.lb[bn + j]; cub = a.ub[bn + j];
    cbd = a.bd[bn + j];
  }
  float rzc[MAX_ROWS], ryc[MAX_ROWS], rl[MAX_ROWS], ru[MAX_ROWS];
  float rcr[MAX_ROWS], rrho[MAX_ROWS];
  int rc0[MAX_ROWS];                       // first column of the window
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    rc0[k] = 0;
    if (r < m) {
      rzc[k] = a.zc[bm + r]; ryc[k] = a.yc[bm + r]; rl[k] = a.lc[bm + r];
      ru[k] = a.uc[bm + r]; rcr[k] = a.cr[bm + r]; rrho[k] = a.rho_c[bm + r];
      rc0[k] = (r / R) * D;
      sw[r] = rrho[k] * rzc[k] - ryc[k];
    }
  }
  const float sigma = a.sigma, alpha = a.alpha, rho_b = a.rho_b;
  const float inv_rho_b = 1.0f / rho_b, one_m_alpha = 1.0f - alpha;
  if (!halves && col) srhs[n + j] = 0.f;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every rank has started, loaded and set up its barriers before the
  // first remote write.
  cluster.sync();

  for (int it = 0; it < a.n_iters; ++it) {
    const int buf = (it & 1) * n;
    uint64_t* bar = &full[it & 1];
    if (tid == 0) mbar_expect_tx(bar, 4u * n);    // all n values of xt
    // rhs (column-owned; C' w in two halves)
    if (in_h) {
      const float part = ct_col(sW, sw, ht, hd, rlo, rhi, K, R, D, KDp);
      srhs[h * n + jh] = h ? part
          : sigma * cx - cq + part + cbd * (rho_b * czb - cyb);
    }
    __syncthreads();
    // this rank's rows of xt = Minv rhs, eight a warp at a time; each
    // value goes into the xt buffer of every rank
    for (int base = i0 + 8 * warp; base < i1; base += 8 * NWARP) {
      const float s = dot8<false, true>(sM, base - i0, i1 - i0, srhs,
                                        srhs + n, n, lane);
      const int i = base + (lane >> 2);
      if (i < i1)
        for (int q = lane & 3; q < cs; q += 4)
          st_async(sxt + buf + i, bar, q, s);
    }
    mbar_wait(bar, (it >> 1) & 1);
    const float* xt = sxt + buf;
    // column updates: x, zb, yb
    if (col) {
      const float xtj = xt[j];
      const float ztb = cbd * xtj;
      cx = alpha * xtj + one_m_alpha * cx;
      const float zrb = alpha * ztb + one_m_alpha * czb;
      const float zbn = pmin(cub, pmax(clb, zrb + cyb * inv_rho_b));
      cyb = cyb + rho_b * (zrb - zbn);
      czb = zbn;
    }
    // row updates: zc, yc (C xt through the row's K*D window), and the
    // next iteration's w
#pragma unroll
    for (int k = 0; k < MAX_ROWS; ++k) {
      const int r = tid + k * NT;
      if (r < m) {
        const float* wr = sW + (size_t)r * KDp;
        const float* xw = xt + rc0[k];
        const int cend = min(KD, n - rc0[k]);
        float ztc = 0.f;
        int cc = 0;
        if ((D & 3) == 0 && cend == KD) {  // xt four columns at a time
#pragma unroll 4
          for (; cc < KD; cc += 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(xw + cc);
            ztc += wr[cc] * x4.x;
            ztc += wr[cc + 1] * x4.y;
            ztc += wr[cc + 2] * x4.z;
            ztc += wr[cc + 3] * x4.w;
          }
        }
#pragma unroll 4
        for (; cc < cend; ++cc) ztc += wr[cc] * xw[cc];
        const float zrc = alpha * ztc + one_m_alpha * rzc[k];
        const float v = zrc + ryc[k] * (1.0f / rrho[k]);
        float zn;
        if (v > ru[k]) zn = pmax(ru[k], v - rcr[k]);
        else if (v < rl[k]) zn = pmin(rl[k], v + rcr[k]);
        else zn = v;
        ryc[k] = ryc[k] + rrho[k] * (zrc - zn);
        rzc[k] = zn;
        sw[r] = rrho[k] * rzc[k] - ryc[k];
      }
    }
    __syncthreads();
  }

  // ---- residual statistics ----
  // Every value sent into this block's xt buffers has arrived (the last
  // wait above); no peer writes its shared memory again until the gather
  // of the maxima into sclu below.
  if (col) srhs[j] = cx;
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    if (r < m) sw[r] = ryc[k];
  }
  __syncthreads();
  {
    const float* P = a.P + ((size_t)b * n + i0) * n;
    for (int base = i0 + 8 * warp; base < i1; base += 8 * NWARP) {
      const float s = dot8<true, false>(P, base - i0, i1 - i0, srhs,
                                        nullptr, n, lane);
      const int i = base + (lane >> 2);
      if (i < i1 && (lane & 3) == 0) sxt[i] = s;   // Px, this rank's rows
    }
  }
  __syncthreads();

  const float cobj = a.cobj[b];
  float pri = 0.f, dua = 0.f, axn = 0.f, zn = 0.f, pan = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    if (r >= r0 && r < r1) {
      const float* wr = sW + (size_t)r * KDp;
      const int cend = min(KD, n - rc0[k]);
      float cxr = 0.f;
      for (int cc = 0; cc < cend; ++cc) cxr += wr[cc] * srhs[rc0[k] + cc];
      const float e = a.Ec[bm + r];
      pri = pmax(pri, fabsf((cxr - rzc[k]) / e));
      axn = pmax(axn, fabsf(cxr / e));
      zn = pmax(zn, fabsf(rzc[k] / e));
    }
  }
  if (col && j >= i0 && j < i1) {          // this rank's columns
    const float aty = ct_col(sW, sw, jt, jd, 0, R, K, R, D, KDp) + cbd * cyb;
    const float bx = cbd * cx;
    const float eb = a.Eb[bn + j];
    const float inv_cD = 1.0f / (cobj * a.Dd[bn + j]);
    const float px = sxt[j];
    pri = pmax(pri, fabsf((bx - czb) / eb));
    axn = pmax(axn, fabsf(bx / eb));
    zn = pmax(zn, fabsf(czb / eb));
    dua = pmax(dua, fabsf((px + cq + aty) * inv_cD));
    pan = pmax(pan, pmax(fabsf(px * inv_cD), fabsf(aty * inv_cD)));
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
    cluster.map_shared_rank(sclu, 0)[rank * 5 + tid] = v;
  }
  // The last access to a peer's shared memory: after this barrier every
  // block may exit.
  cluster.sync();
  if (rank != 0) return;
  if (tid < 5) {
    float v = sclu[tid];
    for (int q = 1; q < cs; ++q) v = pmax(v, sclu[q * 5 + tid]);
    a.stats[(size_t)b * 5 + tid] = v;
  }
  if (col) {
    a.x_o[bn + j] = cx; a.zb_o[bn + j] = czb; a.yb_o[bn + j] = cyb;
  }
#pragma unroll
  for (int k = 0; k < MAX_ROWS; ++k) {
    const int r = tid + k * NT;
    if (r < m) { a.zc_o[bm + r] = rzc[k]; a.yc_o[bm + r] = ryc[k]; }
  }
}

// Launch configuration for cs-block clusters of a shape; its dynamic shared
// memory is this file's own layout (smem_floats).
cudaError_t configure(int T, int D, int K, int R, int cs, int grid,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int n = T * D, m = T * R;
  if (n > MAX_N || m > NT * MAX_ROWS || K < 1 || D < 1 || R < 1
      || (cs != 1 && cs != 2 && cs != 4 && cs != 8))
    return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = sizeof(float) * smem_floats(n, m, (K * D) | 1, cs);
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
// the bytes per block that fused_block.cluster_plan computed, is this
// file's layout, lets the kernel take the device's whole opt-in shared
// memory (enough for every shape) and stores in *clusters how many clusters
// of cs blocks can be resident at once (cudaOccupancyMaxActiveClusters).
// Returns a CUDA error: cudaErrorInvalidValue when the shape or the layout
// does not fit.
int admm_block_chunk_prepare(int T, int D, int K, int R, int cs,
                             size_t smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(T, D, K, R, cs, cs, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  if (cfg.dynamicSmemBytes != smem) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(admm_block_chunk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)admm_block_chunk_kernel, &cfg);
}

// Launch one chunk on `stream` for B problems, one cluster of cs blocks
// each, after admm_block_chunk_prepare for this device and shape.  `active`
// may be null; a problem with active[b] == 0 is skipped and its outputs are
// not written.  Returns the launch's CUDA error.
int admm_block_chunk(const void* Minv, const void* Wb, const void* P,
                     const void* q, const void* lc, const void* uc,
                     const void* cr, const void* rho_c, const void* lb,
                     const void* ub, const void* bd, const void* Ec,
                     const void* Eb, const void* Dd, const void* cobj,
                     const void* x, const void* zc, const void* zb,
                     const void* yc, const void* yb, void* x_o, void* zc_o,
                     void* zb_o, void* yc_o, void* yb_o, void* stats,
                     const void* active, int B, int T, int D, int K, int R,
                     int cs, float sigma, float alpha, float rho_b,
                     int n_iters, void* stream) {
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
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(T, D, K, R, cs, B * cs, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = (cudaStream_t)stream;
  e = cudaLaunchKernelEx(&cfg, admm_block_chunk_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
