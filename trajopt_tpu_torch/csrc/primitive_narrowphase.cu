// The primitive narrowphase on Hopper (sm_90a): signed distances of
// spheres, capsules and boxes, discrete and swept, and their joint-space
// Jacobians, one thread a query (lane, gap, sub-segment, pair).
//
// Replaces the per-pair functions of trajopt_tpu/collision/world.py
// swept_distances_and_jac (:969), swept_distances (:955),
// distances_and_jac (:711) and distances (:665) over
// trajopt_tpu/collision/geometry.py, which have no Pallas source: XLA fuses
// them on the TPU.  The per-query functions are in
// primitive_narrowphase.cuh (shared with the host build the CPU tests use);
// the plain PyTorch version is collision/fused_primitive.py.
//
// One launch takes every primitive group of a query whose key the kernel
// takes (fused_primitive.KEYS): the grid is the groups' query tiles laid
// end to end, a block never spans two groups, so a warp never mixes group
// keys and each block's key picks one instantiation.  Link poses and joint
// axes are read straight from the FK outputs through their strides
// (stride-0 broadcasts included, up to 4 merged batch dims), and d, J0 and
// J1 are written straight into pair order.
//
// Bound: operations.  At the flagship's swept Jacobian call (B = 256, 29
// gaps x 2 sub-segments x 91 pairs = 1.35 M queries) the capsule-box
// queries dominate: four segment_box evaluations, each a 17-sample scan
// and 8 golden steps on plain values plus the value at t* with 12 tangent
// slots; fused_primitive.primitive_flops counts ~10 GFLOP, 0.16 ms at the
// fp32 peak, against ~92 MB of outputs (0.03 ms at 3.35 TB/s).  Design: a
// first, simple kernel: every value, tangent and pose of a query in
// registers (spilling where the 12-slot tangents do not fit), no shared
// memory, no early exit.  Built with --fmad=false: the values round as the
// plain version's unfused torch ops.  The launch allocates nothing and
// does not synchronise, so it can be captured in a CUDA graph.

#include <cuda_runtime.h>

#include <cstring>

#include "primitive_narrowphase.cuh"

namespace {

template <typename T, bool SWEPT, bool JAC>
__global__ void __launch_bounds__(pn::THREADS)
    primitive_narrowphase_kernel(pn::Layout L, pn::Ptrs<T> P) {
  const long long blk = blockIdx.x;
  const int g = pn::group_of(L, blk);
  const long long qi =
      (blk - L.group[g].first_block) * pn::THREADS + threadIdx.x;
  pn::run_query<T, SWEPT, JAC>(L, P, g, qi);
}

template <typename T, bool SWEPT, bool JAC>
cudaError_t launch(const pn::Layout& L, const void* const* ptrs,
                   cudaStream_t stream) {
  pn::Ptrs<T> P;
  for (int t = 0; t < pn::N_IN; ++t) P.in[t] = static_cast<const T*>(ptrs[t]);
  P.ftab = static_cast<const T*>(ptrs[10]);
  P.itab = static_cast<const int32_t*>(ptrs[11]);
  P.coef = static_cast<const T*>(ptrs[12]);
  P.rev = static_cast<const int32_t*>(ptrs[13]);
  P.d = static_cast<T*>(const_cast<void*>(ptrs[14]));
  P.J[0] = static_cast<T*>(const_cast<void*>(ptrs[15]));
  P.J[1] = static_cast<T*>(const_cast<void*>(ptrs[16]));
  primitive_narrowphase_kernel<T, SWEPT, JAC>
      <<<(unsigned)L.blocks, pn::THREADS, 0, stream>>>(L, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int swept, int jac, const pn::Layout& L,
                     const void* const* ptrs, cudaStream_t stream) {
  if (swept)
    return jac ? launch<T, true, true>(L, ptrs, stream)
               : launch<T, true, false>(L, ptrs, stream);
  return jac ? launch<T, false, true>(L, ptrs, stream)
             : launch<T, false, false>(L, ptrs, stream);
}

}  // namespace

static_assert(sizeof(pn::Layout) == 136 * sizeof(long long),
              "Layout is the wrapper's list of 136 integers");

// dtype 0 float32, 1 float64; lay: the Layout's integers in order; ptrs:
// R0 p0 R1 p1 z0 o0 z1 o1 pla plb ftab itab coef rev d J0 J1.  Returns the
// launch's CUDA error (0 on success).
extern "C" int primitive_narrowphase(int dtype, int swept, int jac,
                                     const long long* lay,
                                     const void* const* ptrs, void* stream) {
  pn::Layout L;
  std::memcpy(&L, lay, sizeof(L));
  if (L.blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(swept, jac, L, ptrs, s)
                               : dispatch<double>(swept, jac, L, ptrs, s);
  return static_cast<int>(err);
}
