// The primitive narrowphase on Hopper (sm_90a): signed distances of
// spheres, capsules and boxes, discrete and swept, and their joint-space
// Jacobians, one query a (lane, gap, sub-segment, pair).
//
// Replaces the per-pair functions of trajopt_tpu/collision/world.py
// swept_distances_and_jac (:969), swept_distances (:955),
// distances_and_jac (:711) and distances (:665) over
// trajopt_tpu/collision/geometry.py, which have no Pallas source: XLA fuses
// them on the TPU.  The per-query functions are in
// primitive_narrowphase.cuh (shared with the host build the CPU tests use);
// the plain PyTorch version is collision/fused_primitive.py.
//
// One instantiation a group key (MODE, KA, KB) and value / Jacobian, one
// launch a group: a query call launches its groups back to back on the
// current stream (fused_primitive.KEYS names the keys).  Link poses and
// joint axes are read straight from the FK outputs through their strides
// (stride-0 broadcasts included, up to 4 merged batch dims), and d, J0 and
// J1 are written straight into pair order.
//
// Bound: operations.  At the flagship's swept Jacobian call (B = 256, 29
// gaps x 2 sub-segments x 91 pairs = 1.35 M queries) the capsule-box
// queries dominate: four segment_box evaluations, each a 17-sample scan
// and 8 golden steps on plain values plus the value at t* with the 6
// tangent slots of its two points (fused_primitive.primitive_flops),
// against ~92 MB of outputs (0.03 ms at 3.35 TB/s).  A first design ran
// every key in one kernel, one thread a query, the swept capsule's four
// segments on 12 tangent slots: the worst key (capsule against a static
// box) set 255 registers and spills for every group.
//
// Design:
//   - Each key gets its own register budget: sphere and capsule keys stop
//     paying for the capsule-box sweep (min_blocks: a per-key hint, kept
//     where it does not spill).
//   - A capsule swept against static geometry (MODE 2, KA = CAP) takes
//     four lanes a query, one a segment, each on Dual<T, 6>; the four
//     values and the tied segments' tangents combine by shuffles in
//     amin_n's k order (amin_segments), and the lanes split the joint
//     columns of J0 and J1.  The ragged tail: a lane without a query
//     computes on the last query and stores nothing, so every shuffle runs
//     with its query's four lanes.
//   - Every other key: one thread a query, every value, tangent and pose
//     in registers, no shared memory, no early exit.
// Built with --fmad=false: the values round as the plain version's unfused
// torch ops.  A launch allocates nothing and does not synchronise, so a
// query call can be captured in a CUDA graph.  Registers and spills of
// each instantiation: PERF.md section 6 (-Xptxas -v through
// fused_primitive.build(verbose=True)).

#include <cuda_runtime.h>

#include <cstring>

#include "primitive_narrowphase.cuh"

namespace {

// Resident blocks an SM asked of the register allocator (__launch_bounds__)
// per instantiation, from measurement on the flagship's calls: 3 (168
// registers) for the float Jacobian keys that fit it without spilling;
// 1 for the rest (the box-capsule sweeps spill at 3, 4 spills on every
// heavy key, and the float64 instantiations run fastest at 1).
template <typename T, int MODE, int KA, int KB, bool JAC>
constexpr int min_blocks =
    sizeof(T) == 4 && JAC && !(MODE == 2 && KA == pn::BOX) &&
            !(MODE == 1 && KA == pn::CAP && KB == pn::BOX)
        ? 3
        : 1;

template <typename T, int MODE, int KA, int KB, bool JAC>
__global__ void __launch_bounds__(pn::THREADS,
                                  min_blocks<T, MODE, KA, KB, JAC>)
    primitive_narrowphase_kernel(pn::Layout L, pn::Ptrs<T> P, pn::Group G) {
  constexpr int LANES = pn::lanes_of<MODE, KA>;
  const long long n = L.n_batch * G.pg;
  const long long q0 = (long long)blockIdx.x * (pn::THREADS / LANES) +
                       threadIdx.x / LANES;
  if constexpr (LANES == 1) {
    if (q0 >= n) return;
    pn::query<T, MODE, KA, KB, JAC>(L, P, q0 / G.pg, G.row + q0 % G.pg);
  } else {
    const int lane = threadIdx.x % LANES;
    const unsigned mask = 0xFu << (threadIdx.x & 28);
    const bool live = q0 < n;
    const long long q = live ? q0 : n - 1;
    const long long b = q / G.pg, i = G.row + q % G.pg;
    long long off[pn::N_IN];
    pn::batch_offsets(L, b, off);
    const long long o = b * L.P + P.itab[i * 3 + 2];
    T pts[4][3], ra;
    pn::capsule_points(L, P, off, i, pts, ra);
    pn::Geo<T> gb;
    pn::geo(L, P, off, 0, 1, i, gb);
    const auto ds = pn::capsule_segment<T, KB, JAC>(pts, lane, ra, gb);
    T v[pn::SEGS];
#pragma unroll
    for (int k = 0; k < pn::SEGS; ++k)
      v[k] = __shfl_sync(mask, pn::val(ds), k, pn::SEGS);
    pn::capsule_static_finish<T, JAC>(
        L, P, off, i, o, pts, v,
        [&](int k, int s) {
          if constexpr (JAC)
            return __shfl_sync(mask, ds.d[s], k, pn::SEGS);
          else
            return T(0);
        },
        lane, LANES, live);
  }
}

template <typename T, int MODE, int KA, int KB, bool JAC>
cudaError_t launch(const pn::Layout& L, const pn::Ptrs<T>& P,
                   const pn::Group& G, cudaStream_t stream) {
  constexpr int LANES = pn::lanes_of<MODE, KA>;
  const long long threads = L.n_batch * G.pg * LANES;
  const long long blocks = (threads + pn::THREADS - 1) / pn::THREADS;
  if (blocks <= 0) return cudaSuccess;
  if (blocks >= 0x7fffffffLL) return cudaErrorInvalidValue;
  primitive_narrowphase_kernel<T, MODE, KA, KB, JAC>
      <<<(unsigned)blocks, pn::THREADS, 0, stream>>>(L, P, G);
  return cudaGetLastError();
}

template <typename T, bool JAC>
cudaError_t launch_group(const pn::Layout& L, const pn::Ptrs<T>& P,
                         const pn::Group& G, cudaStream_t stream) {
#define PN_CASE(MODE, KA, KB)                   \
  case MODE * 16 + pn::KA * 4 + pn::KB:         \
    return launch<T, MODE, pn::KA, pn::KB, JAC>(L, P, G, stream);
  switch ((int)G.code) { PN_KEYS(PN_CASE) }
#undef PN_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
int run(int jac, const pn::Layout& L, int n_groups, const long long* groups,
        const void* const* ptrs, cudaStream_t stream) {
  pn::Ptrs<T> P;
  for (int t = 0; t < pn::N_IN; ++t) P.in[t] = static_cast<const T*>(ptrs[t]);
  P.ftab = static_cast<const T*>(ptrs[10]);
  P.itab = static_cast<const int32_t*>(ptrs[11]);
  P.coef = static_cast<const T*>(ptrs[12]);
  P.rev = static_cast<const int32_t*>(ptrs[13]);
  P.d = static_cast<T*>(const_cast<void*>(ptrs[14]));
  P.J[0] = static_cast<T*>(const_cast<void*>(ptrs[15]));
  P.J[1] = static_cast<T*>(const_cast<void*>(ptrs[16]));
  for (int g = 0; g < n_groups; ++g) {
    const pn::Group G{groups[3 * g], groups[3 * g + 1], groups[3 * g + 2]};
    const cudaError_t err = jac ? launch_group<T, true>(L, P, G, stream)
                                : launch_group<T, false>(L, P, G, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

static_assert(sizeof(pn::Layout) == 70 * sizeof(long long),
              "Layout is the wrapper's list of 70 integers");

// dtype 0 float32, 1 float64; lay: the Layout's integers in order; groups:
// (code, pairs, first row) of each of the n_groups groups, one launch
// each, in order; ptrs: R0 p0 R1 p1 z0 o0 z1 o1 pla plb ftab itab coef rev
// d J0 J1.  Returns the first launch's CUDA error (0 on success).
extern "C" int primitive_narrowphase(int dtype, int jac, const long long* lay,
                                     int n_groups, const long long* groups,
                                     const void* const* ptrs, void* stream) {
  pn::Layout L;
  std::memcpy(&L, lay, sizeof(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run<float>(jac, L, n_groups, groups, ptrs, s)
                    : run<double>(jac, L, n_groups, groups, ptrs, s);
}
