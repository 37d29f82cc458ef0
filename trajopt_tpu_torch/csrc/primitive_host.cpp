// Host build of the primitive narrowphase's per-query functions
// (primitive_narrowphase.cuh), for the CPU tests: the same C interface as
// primitive_narrowphase.cu without the stream, every query of every group
// run in a loop (a swept capsule's four segments in a loop of four,
// combined by the device's function).  Build: g++ -O2 -ffp-contract=off
// -std=c++17 -shared -fPIC (collision/fused_primitive.build_host).

#include <cstring>

#include "primitive_narrowphase.cuh"

namespace {

// Query q of group G on the host: every key's per-query functions, the
// capsule sweep's four segments in a loop.
template <typename T, int MODE, int KA, int KB, bool JAC>
void host_query(const pn::Layout& L, const pn::Ptrs<T>& P, const pn::Group& G,
                long long q) {
  const long long b = q / G.pg, i = G.row + q % G.pg;
  if constexpr (pn::lanes_of<MODE, KA> == 1) {
    pn::query<T, MODE, KA, KB, JAC>(L, P, b, i);
  } else {
    long long off[pn::N_IN];
    pn::batch_offsets(L, b, off);
    const long long o = b * L.P + P.itab[i * 3 + 2];
    T pts[4][3], ra;
    pn::capsule_points(L, P, off, i, pts, ra);
    pn::Geo<T> gb;
    pn::geo(L, P, off, 0, 1, i, gb);
    typename std::conditional<JAC, pn::Dual<T, 6>, T>::type ds[pn::SEGS];
    T v[pn::SEGS];
    for (int k = 0; k < pn::SEGS; ++k) {
      ds[k] = pn::capsule_segment<T, KB, JAC>(pts, k, ra, gb);
      v[k] = pn::val(ds[k]);
    }
    pn::capsule_static_finish<T, JAC>(
        L, P, off, i, o, pts, v,
        [&](int k, int s) {
          if constexpr (JAC)
            return ds[k].d[s];
          else
            return T(0);
        },
        0, 1, true);
  }
}

template <typename T, bool JAC>
int run_group(const pn::Layout& L, const pn::Ptrs<T>& P, const pn::Group& G) {
  const long long n = L.n_batch * G.pg;
#define PN_CASE(MODE, KA, KB)                                             \
  case MODE * 16 + pn::KA * 4 + pn::KB:                                   \
    for (long long q = 0; q < n; ++q)                                     \
      host_query<T, MODE, pn::KA, pn::KB, JAC>(L, P, G, q);               \
    return 0;
  switch ((int)G.code) { PN_KEYS(PN_CASE) }
#undef PN_CASE
  return 1;
}

template <typename T>
int run(int jac, const pn::Layout& L, int n_groups, const long long* groups,
        const void* const* ptrs) {
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
    const int err = jac ? run_group<T, true>(L, P, G)
                        : run_group<T, false>(L, P, G);
    if (err) return err;
  }
  return 0;
}

}  // namespace

static_assert(sizeof(pn::Layout) == 70 * sizeof(long long),
              "Layout is the wrapper's list of 70 integers");

extern "C" int primitive_host(int dtype, int jac, const long long* lay,
                              int n_groups, const long long* groups,
                              const void* const* ptrs) {
  pn::Layout L;
  std::memcpy(&L, lay, sizeof(L));
  return dtype == 0 ? run<float>(jac, L, n_groups, groups, ptrs)
                    : run<double>(jac, L, n_groups, groups, ptrs);
}
