// Host build of the primitive narrowphase's per-query functions
// (primitive_narrowphase.cuh), for the CPU tests: the same C interface as
// primitive_narrowphase.cu without the stream, every block and thread of
// the launch run in a loop.  Build: g++ -O2 -ffp-contract=off -std=c++17
// -shared -fPIC (collision/fused_primitive.build_host).

#include <cstring>

#include "primitive_narrowphase.cuh"

namespace {

template <typename T, bool SWEPT, bool JAC>
void run(const pn::Layout& L, const void* const* ptrs) {
  pn::Ptrs<T> P;
  for (int t = 0; t < pn::N_IN; ++t) P.in[t] = static_cast<const T*>(ptrs[t]);
  P.ftab = static_cast<const T*>(ptrs[10]);
  P.itab = static_cast<const int32_t*>(ptrs[11]);
  P.coef = static_cast<const T*>(ptrs[12]);
  P.rev = static_cast<const int32_t*>(ptrs[13]);
  P.d = static_cast<T*>(const_cast<void*>(ptrs[14]));
  P.J[0] = static_cast<T*>(const_cast<void*>(ptrs[15]));
  P.J[1] = static_cast<T*>(const_cast<void*>(ptrs[16]));
  for (long long blk = 0; blk < L.blocks; ++blk) {
    const int g = pn::group_of(L, blk);
    for (int t = 0; t < pn::THREADS; ++t)
      pn::run_query<T, SWEPT, JAC>(
          L, P, g, (blk - L.group[g].first_block) * pn::THREADS + t);
  }
}

template <typename T>
void dispatch(int swept, int jac, const pn::Layout& L,
              const void* const* ptrs) {
  if (swept)
    jac ? run<T, true, true>(L, ptrs) : run<T, true, false>(L, ptrs);
  else
    jac ? run<T, false, true>(L, ptrs) : run<T, false, false>(L, ptrs);
}

}  // namespace

static_assert(sizeof(pn::Layout) == 136 * sizeof(long long),
              "Layout is the wrapper's list of 136 integers");

extern "C" int primitive_host(int dtype, int swept, int jac,
                              const long long* lay, const void* const* ptrs) {
  pn::Layout L;
  std::memcpy(&L, lay, sizeof(L));
  if (dtype == 0)
    dispatch<float>(swept, jac, L, ptrs);
  else
    dispatch<double>(swept, jac, L, ptrs);
  return 0;
}
