// The primitive narrowphase's per-query functions: signed distances of
// spheres, capsules and boxes, discrete and swept, and their joint-space
// Jacobians.  Written once for the device (primitive_narrowphase.cu) and
// the host (primitive_host.cpp, the CPU tests' build).
//
// Counterpart of trajopt_tpu/collision/world.py swept_distances_and_jac
// (:969), swept_distances (:955), distances_and_jac (:711) and distances
// (:665) over trajopt_tpu/collision/geometry.py (:36-184), which have no
// Pallas source: XLA fuses them on the TPU.  The plain PyTorch version is
// trajopt_tpu_torch/collision/fused_primitive.py (discrete_plain,
// moving_plain, static_plain); the functions below follow
// trajopt_tpu_torch/collision/geometry.py op for op.
//
// Values.  Every value rounds as the plain version's: the same operations
// in the same order, each torch op one IEEE rounding (built with
// --fmad=false on the device and -ffp-contract=off on the host, so that no
// multiply-add is contracted), sums over 3 components in torch's order
// (sum3), IEEE division and square root.  The one product torch leaves to a
// library, the 3x3 Rl @ R_loc of a link geom's world rotation, is an fma
// chain on the device and unfused on the host; it is exact for the
// identity local rotations of primitive geoms built by the scene's
// add_link_* methods.  segment_box's 17-sample scan and golden refinement
// run on plain values, as the plain version runs them without gradient.
//
// Jacobians: forward mode.  The world points of one side of a pair (the
// sphere center, the capsule ends; never a box's) carry tangents, one slot
// a coordinate, in Dual<T, N>.  The tie rules of the plain version's
// autograd are the tangent rules here: min and max of two values split an
// exact tie evenly, clip = min(hi, max(lo, x)) too, amin / amax split
// evenly among all tied entries, abs has slope +1 at 0, norm has a zero
// tangent at 0.  A point's gradient g at world position x gives the side's
// twist gradient (sum x x g, sum g), and joint j's column is z_j . gw -
// (z_j x o_j) . gv (revolute) or z_j . gv (prismatic): the same linear map
// as the plain version's reverse composition (compose_pose_grads).  Since a
// distance does not change when both sides move together, the other
// side's twist gradient is the negative of the first's; each pair's
// coefficient row (mask of side a less mask of side b, or the moving
// side's mask) folds the two in.

#pragma once

#include <stdint.h>

#include <type_traits>

#ifdef __CUDACC__
#define PN_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define PN_HD inline
#endif

namespace pn {

constexpr int MAX_DIMS = 4;
constexpr int N_IN = 10;       // R0 p0 R1 p1 z0 o0 z1 o1 pla plb
constexpr int SPH = 0, CAP = 1, BOX = 2;
constexpr int THREADS = 128;
constexpr int SEGS = 4;        // lanes a query of a capsule swept against
                               // static geometry: one a segment

// The launch's shapes and strides, in elements (fused_primitive._launch
// writes them in this order).
struct Layout {
  long long n_batch;                 // batch elements (lanes x gaps x ...)
  long long nd;                      // merged batch dims, outermost first
  long long size[MAX_DIMS];
  long long st[N_IN][MAX_DIMS];      // each input's batch strides
  struct End {                       // one endpoint's FK outputs
    long long R_l, R_r, R_c, p_l, p_c, z_j, z_c, o_j, o_c;
  } end[2];
  long long pl_p[2], pl_c[2];        // each side's local centers
  long long P, n_dof;
};

// One group of a launch: its key, pairs and first pair row.
struct Group {
  long long code;                    // mode * 16 + ka * 4 + kb
  long long pg, row;
};

template <typename T>
struct Ptrs {
  const T* in[N_IN];
  const T* ftab;                     // [Pk, 2, 18]
  const int32_t* itab;               // [Pk, 3]
  const T* coef;                     // [Pk, n_dof]
  const int32_t* rev;                // [n_dof]
  T* d;                              // [n_batch, P]
  T* J[2];                           // [n_batch, P, n_dof]
};

// ----------------------------------------------------------- arithmetic

PN_HD float sqrt_(float x) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(x);
#else
  return std::sqrt(x);
#endif
}
PN_HD double sqrt_(double x) {
#ifdef __CUDA_ARCH__
  return __dsqrt_rn(x);
#else
  return std::sqrt(x);
#endif
}
// a * b + c as the device's batched GEMM accumulates it (fused), and as
// torch's CPU bmm does (unfused)
PN_HD float gemm_fma(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return a * b + c;
#endif
}
PN_HD double gemm_fma(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return __fma_rn(a, b, c);
#else
  return a * b + c;
#endif
}

template <typename T>
PN_HD bool nan_(T x) {
  return x != x;
}

// x0 + x1 + x2 as torch sums a contiguous last axis of 3: on the card its
// reduction splits the axis over two lanes (last_pow2(3)), lane 0 taking
// x0 and x2, so (x0 + x2) + x1; on the CPU in order.  An axis that is not
// the fastest (rmatvec's sum(-2)) is summed in order on both.
template <typename S>
PN_HD S sum3(const S& x0, const S& x1, const S& x2) {
#ifdef __CUDA_ARCH__
  return (x0 + x2) + x1;
#else
  return (x0 + x1) + x2;
#endif
}

// A value and its N tangents.
template <typename T, int N>
struct Dual {
  T v;
  T d[N];
  PN_HD Dual() {}
  PN_HD Dual(T x) : v(x) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = T(0);
  }
};

template <typename S>
struct Base {
  using type = S;
};
template <typename T, int N>
struct Base<Dual<T, N>> {
  using type = T;
};

template <typename T>
PN_HD T val(T x) {
  return x;
}
template <typename T, int N>
PN_HD T val(const Dual<T, N>& x) {
  return x.v;
}

template <typename T, int N>
PN_HD Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator+(const Dual<T, N>& a, T b) {
  Dual<T, N> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator-(const Dual<T, N>& a, T b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator-(T a, const Dual<T, N>& b) {
  Dual<T, N> r = -b;
  r.v = a - b.v;
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator*(T a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a * b.d[k];
  return r;
}
template <typename T, int N>
PN_HD Dual<T, N> operator*(const Dual<T, N>& a, T b) {
  Dual<T, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b;
  return r;
}

// the mean of two tangents (an exact tie)
template <typename T>
PN_HD T mean2(T a, T b) {
  return a;
}
template <typename T, int N>
PN_HD Dual<T, N> mean2(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = T(0.5) * (a.d[k] + b.d[k]);
  return r;
}

// torch.maximum / torch.minimum: a NaN wins; an exact tie splits the
// tangent evenly.
template <typename S>
PN_HD S max_(const S& a, const S& b) {
  if (nan_(val(a))) return a;
  if (nan_(val(b))) return b;
  if (val(a) > val(b)) return a;
  if (val(b) > val(a)) return b;
  return mean2(a, b);
}
template <typename S>
PN_HD S min_(const S& a, const S& b) {
  if (nan_(val(a))) return a;
  if (nan_(val(b))) return b;
  if (val(a) < val(b)) return a;
  if (val(b) < val(a)) return b;
  return mean2(a, b);
}

// jnp.clip(x, 0, 1) = minimum(1, maximum(0, x))
template <typename S>
PN_HD S clip01(const S& x) {
  using T = typename Base<S>::type;
  return min_(S(T(1)), max_(S(T(0)), x));
}

// abs_: slope +1 at 0
template <typename S>
PN_HD S abs_(const S& x) {
  using T = typename Base<S>::type;
  return val(x) >= T(0) ? x : -x;
}

template <typename T>
PN_HD T sqrt_d(T x) {
  return sqrt_(x);
}
template <typename T, int N>
PN_HD Dual<T, N> sqrt_d(const Dual<T, N>& x) {
  Dual<T, N> r;
  r.v = sqrt_(x.v);
  T two_r = T(2) * r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = x.d[k] / two_r;
  return r;
}

// torch.amin over n values: a NaN wins, else the minimum, its tangent the
// mean of all tied entries' tangents
template <typename T>
PN_HD T amin_n(const T* x, int n) {
  T m = x[0];
  for (int k = 1; k < n; ++k) {
    if (nan_(m)) break;
    if (nan_(x[k]) || x[k] < m) m = x[k];
  }
  return m;
}
template <typename T, int N>
PN_HD Dual<T, N> amin_n(const Dual<T, N>* x, int n) {
  T m = x[0].v;
  for (int k = 1; k < n; ++k) {
    if (nan_(m)) break;
    if (nan_(x[k].v) || x[k].v < m) m = x[k].v;
  }
  Dual<T, N> r(m);
  int count = 0;
  for (int k = 0; k < n; ++k)
    if (x[k].v == m) {
      ++count;
#pragma unroll
      for (int s = 0; s < N; ++s) r.d[s] = r.d[s] + x[k].d[s];
    }
  if (count > 1)
#pragma unroll
    for (int s = 0; s < N; ++s) r.d[s] = r.d[s] / T(count);
  return r;
}
// torch.amax over n values
template <typename T>
PN_HD T amax_n(const T* x, int n) {
  T m = x[0];
  for (int k = 1; k < n; ++k) {
    if (nan_(m)) break;
    if (nan_(x[k]) || x[k] > m) m = x[k];
  }
  return m;
}
template <typename T, int N>
PN_HD Dual<T, N> amax_n(const Dual<T, N>* x, int n) {
  Dual<T, N> neg[3];
  for (int k = 0; k < n; ++k) neg[k] = -x[k];
  return -amin_n(neg, n);
}

// ----------------------------------------------------------- 3-vectors

template <typename S>
struct V3 {
  S c[3];
};

template <typename S, typename T>
PN_HD V3<S> lift(const T (&x)[3]) {
  return V3<S>{{S(x[0]), S(x[1]), S(x[2])}};
}
template <typename S>
PN_HD V3<S> vsub(const V3<S>& a, const V3<S>& b) {
  return V3<S>{{a.c[0] - b.c[0], a.c[1] - b.c[1], a.c[2] - b.c[2]}};
}
template <typename S>
PN_HD V3<S> vadd(const V3<S>& a, const V3<S>& b) {
  return V3<S>{{a.c[0] + b.c[0], a.c[1] + b.c[1], a.c[2] + b.c[2]}};
}
// t[..., None] * v
template <typename S, typename U>
PN_HD V3<S> vscale(const U& t, const V3<S>& v) {
  return V3<S>{{t * v.c[0], t * v.c[1], t * v.c[2]}};
}
// (a * b).sum(-1)
template <typename S>
PN_HD S dot(const V3<S>& a, const V3<S>& b) {
  return sum3(a.c[0] * b.c[0], a.c[1] * b.c[1], a.c[2] * b.c[2]);
}
template <typename S>
PN_HD V3<S> cross(const V3<S>& a, const V3<S>& b) {
  return V3<S>{{a.c[1] * b.c[2] - a.c[2] * b.c[1],
                a.c[2] * b.c[0] - a.c[0] * b.c[2],
                a.c[0] * b.c[1] - a.c[1] * b.c[0]}};
}
// geometry.norm: sqrt of the sum of squares, 0 (and a zero tangent) at 0
template <typename S>
PN_HD S norm(const V3<S>& v) {
  using T = typename Base<S>::type;
  S ss = dot(v, v);
  if (val(ss) > T(0)) return sqrt_d(ss);
  return S(T(0));
}
// R^T v (rmatvec) for a plain rotation R (row-major) and any v
template <typename S, typename T>
PN_HD V3<S> rmatvec(const T* R, const V3<S>& v) {
  V3<S> r;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    r.c[j] = (R[j] * v.c[0] + R[3 + j] * v.c[1]) + R[6 + j] * v.c[2];
  return r;
}

// ----------------------------------------------------------- geometry

constexpr double EPS = 1e-12;

template <typename S>
PN_HD V3<S> point_segment_closest(const V3<S>& p, const V3<S>& a,
                                  const V3<S>& b) {
  using T = typename Base<S>::type;
  V3<S> ab = vsub(b, a);
  S t = clip01(dot(vsub(p, a), ab) / (dot(ab, ab) + T(EPS)));
  return vadd(a, vscale(t, ab));
}

template <typename S, typename T>
PN_HD S sphere_sphere(const V3<S>& c0, T r0, const V3<S>& c1, T r1) {
  return norm(vsub(c0, c1)) - (r0 + r1);
}

template <typename S, typename T>
PN_HD S sphere_capsule(const V3<S>& c, T r, const V3<S>& a, const V3<S>& b,
                       T rc) {
  V3<S> q = point_segment_closest(c, a, b);
  return norm(vsub(c, q)) - (r + rc);
}

template <typename S>
PN_HD void segment_segment_closest(const V3<S>& p1, const V3<S>& q1,
                                   const V3<S>& p2, const V3<S>& q2,
                                   V3<S>& u, V3<S>& v) {
  using T = typename Base<S>::type;
  V3<S> d1 = vsub(q1, p1), d2 = vsub(q2, p2), r = vsub(p1, p2);
  S a = dot(d1, d1) + T(EPS);
  S e = dot(d2, d2) + T(EPS);
  S b = dot(d1, d2);
  S c = dot(d1, r);
  S f = dot(d2, r);
  S denom = a * e - b * b;
  T ad = val(denom) >= T(0) ? val(denom) : -val(denom);
  S s = ad > T(EPS) ? clip01((b * f - c * e) / (denom + T(EPS))) : S(T(0));
  S t = (b * s + f) / e;
  S t_cl = clip01(t);
  s = clip01((b * t_cl - c) / a);
  t = clip01((b * s + f) / e);
  u = vadd(p1, vscale(s, d1));
  v = vadd(p2, vscale(t, d2));
}

template <typename S, typename T>
PN_HD S capsule_capsule(const V3<S>& a0, const V3<S>& b0, T r0,
                        const V3<S>& a1, const V3<S>& b1, T r1) {
  V3<S> u, v;
  segment_segment_closest(a0, b0, a1, b1, u, v);
  return norm(vsub(u, v)) - (r0 + r1);
}

template <typename S, typename T>
PN_HD S point_box_sdf(const V3<S>& pl, const T (&half)[3]) {
  S q[3], m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q[k] = abs_(pl.c[k]) - half[k];
    m[k] = max_(q[k], S(T(0)));
  }
  S outside = norm(V3<S>{{m[0], m[1], m[2]}});
  S inside = min_(amax_n(q, 3), S(T(0)));
  return outside + inside;
}

template <typename S, typename T>
PN_HD S sphere_box(const V3<S>& c, T r, const T* Rb, const T (&pb)[3],
                   const T (&half)[3]) {
  return point_box_sdf(rmatvec(Rb, vsub(c, lift<S>(pb))), half) - r;
}

// min over t of point_box_sdf(a + t (b - a)): a 17-sample bracket and 8
// golden steps on the plain values, then the value at t* with tangents
template <typename S, typename T>
PN_HD S segment_box_separation(const V3<S>& a_l, const V3<S>& b_l,
                               const T (&half)[3]) {
  V3<S> d = vsub(b_l, a_l);
  V3<T> a0{{val(a_l.c[0]), val(a_l.c[1]), val(a_l.c[2])}};
  V3<T> d0{{val(d.c[0]), val(d.c[1]), val(d.c[2])}};
  const T step = T(0.0625);           // linspace(0, 1, 17)
  T best = T(0);
  int ib = 0;
  for (int k = 0; k < 17; ++k) {
    T v = point_box_sdf(vadd(a0, vscale(T(k) * step, d0)), half);
    if (k == 0 || (!nan_(best) && (nan_(v) || v < best))) {
      best = v;
      ib = k;
    }
  }
  T ti = T(ib) * step;
  T lo = clip01(ti - step), hi = clip01(ti + step);
  const T gr = T(0.6180339887498949);
  for (int k = 0; k < 8; ++k) {
    T m1 = hi - gr * (hi - lo);
    T m2 = lo + gr * (hi - lo);
    bool take = point_box_sdf(vadd(a0, vscale(m1, d0)), half) <
                point_box_sdf(vadd(a0, vscale(m2, d0)), half);
    lo = take ? lo : m1;
    hi = take ? m2 : hi;
  }
  T t_star = T(0.5) * (lo + hi);
  return point_box_sdf(vadd(a_l, vscale(t_star, d)), half);
}

// exact SAT penetration depth of a segment in an origin-centered box
template <typename S, typename T>
PN_HD S segment_box_penetration(const V3<S>& a_l, const V3<S>& b_l,
                                const T (&half)[3]) {
  V3<S> u = vsub(b_l, a_l);
  V3<S> axes[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T e[3] = {T(0), T(0), T(0)};
    e[i] = T(1);
    axes[i] = lift<S>(e);
    V3<S> c = cross(u, axes[i]);
    S n = norm(c);
    if (val(n) > T(1e-9))
      axes[3 + i] = V3<S>{{c.c[0] / n, c.c[1] / n, c.c[2] / n}};
    else
      axes[3 + i] = axes[i];
  }
  S ov[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const V3<S>& ax = axes[k];
    S r_box = sum3(half[0] * abs_(ax.c[0]), half[1] * abs_(ax.c[1]),
                   half[2] * abs_(ax.c[2]));
    S pa = dot(ax, a_l), pb = dot(ax, b_l);
    S c = T(0.5) * (pa + pb);
    S hl = T(0.5) * abs_(pa - pb);
    ov[k] = (r_box + hl) - abs_(c);
  }
  return amin_n(ov, 6);
}

template <typename S, typename T>
PN_HD S segment_box(const V3<S>& a, const V3<S>& b, const T* Rb,
                    const T (&pb)[3], const T (&half)[3]) {
  V3<S> a_l = rmatvec(Rb, vsub(a, lift<S>(pb)));
  V3<S> b_l = rmatvec(Rb, vsub(b, lift<S>(pb)));
  S d_sep = segment_box_separation(a_l, b_l, half);
  S pen = segment_box_penetration(a_l, b_l, half);
  if (val(d_sep) > T(0)) return d_sep;
  return -max_(pen, S(T(0)));
}

template <typename S, typename T>
PN_HD S capsule_box(const V3<S>& a, const V3<S>& b, T r, const T* Rb,
                    const T (&pb)[3], const T (&half)[3]) {
  return segment_box(a, b, Rb, pb, half) - r;
}

// ----------------------------------------------------- world data, pairs

// One geom's world pose, capsule ends and params.
template <typename T>
struct Geo {
  T R[9];
  T p[3], ea[3], eb[3], prm[3];
};

PN_HD void batch_offsets(const Layout& L, long long b, long long (&off)[N_IN]) {
#pragma unroll
  for (int t = 0; t < N_IN; ++t) off[t] = 0;
  for (int k = (int)L.nd - 1; k >= 0; --k) {
    long long i = b % L.size[k];
    b /= L.size[k];
#pragma unroll
    for (int t = 0; t < N_IN; ++t) off[t] += i * L.st[t][k];
  }
}

// side s of pair row i at endpoint e: pose_geom(Rl, pl, R_loc, p_loc, ea,
// eb), Rl / pl the identity and zero for world geometry
template <typename T>
PN_HD void geo(const Layout& L, const Ptrs<T>& P, const long long (&off)[N_IN],
               int e, int s, long long i, Geo<T>& g) {
  const T* f = P.ftab + (i * 2 + s) * 18;
  const T* pl = P.in[8 + s] + off[8 + s] + i * L.pl_p[s];
  T ploc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ploc[k] = pl[k * L.pl_c[s]];
    g.prm[k] = f[15 + k];
  }
  int link = P.itab[i * 3 + s];
  if (link < 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) g.R[k] = f[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) g.p[k] = ploc[k];
  } else {
    const Layout::End& E = L.end[e];
    const T* Rp = P.in[2 * e] + off[2 * e] + link * E.R_l;
    const T* pp = P.in[2 * e + 1] + off[2 * e + 1] + link * E.p_l;
    T Rl[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) Rl[3 * r + c] = Rp[r * E.R_r + c * E.R_c];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        g.R[3 * r + c] = gemm_fma(
            Rl[3 * r + 2], f[6 + c],
            gemm_fma(Rl[3 * r + 1], f[3 + c], Rl[3 * r] * f[c]));
      g.p[r] = sum3(Rl[3 * r] * ploc[0], Rl[3 * r + 1] * ploc[1],
                    Rl[3 * r + 2] * ploc[2]) + pp[r * E.p_c];
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    g.ea[r] = sum3(g.R[3 * r] * f[9], g.R[3 * r + 1] * f[10],
                   g.R[3 * r + 2] * f[11]) + g.p[r];
    g.eb[r] = sum3(g.R[3 * r] * f[12], g.R[3 * r + 1] * f[13],
                   g.R[3 * r + 2] * f[14]) + g.p[r];
  }
}

// a point with tangent slots s0 .. s0 + 2
template <typename S, typename T>
PN_HD V3<S> seeded(const T (&x)[3], int s0) {
  V3<S> v = lift<S>(x);
  if constexpr (!std::is_same<S, T>::value) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v.c[k].d[s0 + k] = T(1);
  }
  return v;
}

// the discrete kernel of (KA, KB) with side a's points xa (a sphere's
// center; a capsule's ends) and side b's world data
template <int KA, int KB, typename S, typename T>
PN_HD S disc(const V3<S>* xa, T ra, const Geo<T>& b) {
  const T rb = b.prm[0];
  if constexpr (KA == SPH && KB == SPH)
    return sphere_sphere(xa[0], ra, lift<S>(b.p), rb);
  else if constexpr (KA == SPH && KB == CAP)
    return sphere_capsule(xa[0], ra, lift<S>(b.ea), lift<S>(b.eb), rb);
  else if constexpr (KA == SPH && KB == BOX)
    return sphere_box(xa[0], ra, b.R, b.p, b.prm);
  else if constexpr (KA == CAP && KB == CAP)
    return capsule_capsule(xa[0], xa[1], ra, lift<S>(b.ea), lift<S>(b.eb),
                           rb);
  else
    return capsule_box(xa[0], xa[1], ra, b.R, b.p, b.prm);
}

// side a's points of a sphere or capsule, seeded from slot s0 on
template <int K, typename S, typename T>
PN_HD void points(const Geo<T>& g, int s0, V3<S>* x) {
  if constexpr (K == SPH) {
    x[0] = seeded<S>(g.p, s0);
  } else {
    x[0] = seeded<S>(g.ea, s0);
    x[1] = seeded<S>(g.eb, s0 + 3);
  }
}

// torch.minimum's backward weights of (a, b)
template <typename T>
PN_HD void min_weights(T a, T b, T& wa, T& wb) {
  wa = a == b ? T(0.5) : (a > b ? T(0) : T(1));
  wb = a == b ? T(0.5) : (a < b ? T(0) : T(1));
}

// joint-space row w * coef_j * (z_j . gw - (z_j x o_j) . gv | z_j . gv)
// of the twist gradient (gw, gv) at endpoint e: columns j0, j0 + dj, ...
template <typename T>
PN_HD void jac_row(const Layout& L, const Ptrs<T>& P,
                   const long long (&off)[N_IN], int e, long long i,
                   const T (&gw)[3], const T (&gv)[3], T w, T* out,
                   int j0 = 0, int dj = 1) {
  const Layout::End& E = L.end[e];
  const T* zb = P.in[4 + 2 * e] + off[4 + 2 * e];
  const T* ob = P.in[5 + 2 * e] + off[5 + 2 * e];
  const T* coef = P.coef + i * L.n_dof;
  for (int j = j0; j < (int)L.n_dof; j += dj) {
    T c = coef[j];
    if (c == T(0) || w == T(0)) {
      out[j] = T(0);
      continue;
    }
    V3<T> z, o;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      z.c[k] = zb[j * E.z_j + k * E.z_c];
      o.c[k] = ob[j * E.o_j + k * E.o_c];
    }
    V3<T> gwv{{gw[0], gw[1], gw[2]}}, gvv{{gv[0], gv[1], gv[2]}};
    T s = P.rev[j] ? dot(z, gwv) - dot(cross(z, o), gvv) : dot(z, gvv);
    out[j] = (w * c) * s;
  }
}

// twist gradient of the n points at world positions pos, whose tangents
// are dd[3 m .. 3 m + 2]
template <typename T>
PN_HD void twist_of(const T* dd, const T (*pos)[3], int n, T sign,
                    T (&gw)[3], T (&gv)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) gw[k] = gv[k] = T(0);
  for (int m = 0; m < n; ++m) {
    V3<T> g{{dd[3 * m], dd[3 * m + 1], dd[3 * m + 2]}};
    V3<T> p{{pos[m][0], pos[m][1], pos[m][2]}};
    V3<T> pg = cross(p, g);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gw[k] += sign * pg.c[k];
      gv[k] += sign * g.c[k];
    }
  }
}

// twist gradient of the n points x whose tangent slots start at s0, from
// the value's tangents
template <typename T, int N>
PN_HD void twist(const Dual<T, N>& d, const V3<Dual<T, N>>* x, int n, int s0,
                 T sign, T (&gw)[3], T (&gv)[3]) {
  T pos[2][3];
  for (int m = 0; m < n; ++m)
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[m][k] = x[m].c[k].v;
  twist_of(d.d + s0, pos, n, sign, gw, gv);
}

// points that carry a sphere's (1) or a capsule's (2) tangents
template <int K>
constexpr int n_points = K == SPH ? 1 : 2;

// One query of a group of mode MODE (0 discrete, 1 swept with both sides
// moving, 2 swept against static side b) and key (KA, KB) for batch
// element b and pair row i.
template <typename T, int MODE, int KA, int KB, bool JAC>
PN_HD void query(const Layout& L, const Ptrs<T>& P, long long b, long long i) {
  long long off[N_IN];
  batch_offsets(L, b, off);
  const long long o = b * L.P + P.itab[i * 3 + 2];
  if constexpr (MODE == 0 || MODE == 1) {
    constexpr int NP = n_points<KA>;
    using S = typename std::conditional<JAC, Dual<T, 3 * NP>, T>::type;
    S d[2];
    V3<S> xa[2][NP];
    for (int e = 0; e <= MODE; ++e) {
      Geo<T> ga, gb;
      geo(L, P, off, e, 0, i, ga);
      geo(L, P, off, e, 1, i, gb);
      points<KA>(ga, 0, xa[e]);
      d[e] = disc<KA, KB>(xa[e], ga.prm[0], gb);
    }
    T w[2] = {T(1), T(0)};
    T value = val(d[0]);
    if constexpr (MODE == 1) {
      value = val(min_(d[0], d[1]));
      min_weights(val(d[0]), val(d[1]), w[0], w[1]);
    }
    P.d[o] = value;
    if constexpr (JAC) {
      for (int e = 0; e <= MODE; ++e) {
        T gw[3], gv[3];
        twist(d[e], xa[e], NP, 0, T(1), gw, gv);
        jac_row(L, P, off, e, i, gw, gv, w[e], P.J[e] + o * L.n_dof);
      }
    }
  } else if constexpr (KA == BOX) {
    // a box sweeping against a static sphere or capsule: the endpoint min
    // of the discrete (KB, box) kernel, the tangents on side b's points
    constexpr int NP = n_points<KB>;
    using S = typename std::conditional<JAC, Dual<T, 3 * NP>, T>::type;
    Geo<T> gb;
    geo(L, P, off, 0, 1, i, gb);
    V3<S> xb[NP];
    points<KB>(gb, 0, xb);
    S d[2];
    for (int e = 0; e < 2; ++e) {
      Geo<T> ga;
      geo(L, P, off, e, 0, i, ga);
      d[e] = disc<KB, BOX>(xb, gb.prm[0], ga);
    }
    P.d[o] = val(min_(d[0], d[1]));
    if constexpr (JAC) {
      T w[2];
      min_weights(val(d[0]), val(d[1]), w[0], w[1]);
      for (int e = 0; e < 2; ++e) {
        T gw[3], gv[3];
        twist(d[e], xb, NP, 0, T(1), gw, gv);
        jac_row(L, P, off, e, i, gw, gv, w[e], P.J[e] + o * L.n_dof);
      }
    }
  } else {
    // a sphere sweeping against static side b: the capsule of its two
    // centers (a capsule's four segments: capsule_static)
    static_assert(KA == SPH, "a swept capsule runs capsule_static");
    using S = typename std::conditional<JAC, Dual<T, 6>, T>::type;
    Geo<T> ga0, ga1, gb;
    geo(L, P, off, 0, 0, i, ga0);
    geo(L, P, off, 1, 0, i, ga1);
    geo(L, P, off, 0, 1, i, gb);
    V3<S> x[2][1];
    points<KA>(ga0, 0, x[0]);
    points<KA>(ga1, 3, x[1]);
    const T ra = ga0.prm[0], rb = gb.prm[0];
    S d;
    if constexpr (KB == SPH)
      d = sphere_capsule(lift<S>(gb.p), rb, x[0][0], x[1][0], ra);
    else if constexpr (KB == CAP)
      d = capsule_capsule(x[0][0], x[1][0], ra, lift<S>(gb.ea),
                          lift<S>(gb.eb), rb);
    else
      d = capsule_box(x[0][0], x[1][0], ra, gb.R, gb.p, gb.prm);
    P.d[o] = val(d);
    if constexpr (JAC) {
      for (int e = 0; e < 2; ++e) {
        T gw[3], gv[3];
        twist(d, x[e], 1, 3 * e, T(1), gw, gv);
        jac_row(L, P, off, e, i, gw, gv, T(1), P.J[e] + o * L.n_dof);
      }
    }
  }
}

// ------------------------------- a capsule swept against static geometry
//
// The swept capsule's distance is the amin over four segments: the sweeps
// of its two ends and the capsule at either endpoint.  Its four points
// p = 2 e + m (end m of endpoint e's capsule) carry the tangent slots
// 3 p .. 3 p + 2 of the value's 12; segment k runs from point
// seg_pt(k, 0) to seg_pt(k, 1) and touches only those 6 slots, so each
// segment is evaluated on its own with 6 slots (one lane each on the card,
// a loop of four on the host) and amin_segments adds the slots up.

// point m (0, 1) of segment k: {0, 2}, {1, 3}, {0, 1}, {2, 3}
PN_HD constexpr int seg_pt(int k, int m) {
  return k == 0 ? 2 * m : k == 1 ? 1 + 2 * m : k == 2 ? m : 2 + m;
}

// the four points' world positions of pair row i at batch offsets off
template <typename T>
PN_HD void capsule_points(const Layout& L, const Ptrs<T>& P,
                          const long long (&off)[N_IN], long long i,
                          T (&pts)[4][3], T& ra) {
  for (int e = 0; e < 2; ++e) {
    Geo<T> g;
    geo(L, P, off, e, 0, i, g);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pts[2 * e][k] = g.ea[k];
      pts[2 * e + 1][k] = g.eb[k];
    }
    if (e == 0) ra = g.prm[0];
  }
}

// segment k's distance to static side b (world data gb), its two points'
// tangents in slots 0-5 (the points picked by compile-time indices, so
// that a run-time k keeps them in registers)
template <typename T, int KB, bool JAC>
PN_HD typename std::conditional<JAC, Dual<T, 6>, T>::type capsule_segment(
    const T (&pts)[4][3], int k, T ra, const Geo<T>& gb) {
  using S = typename std::conditional<JAC, Dual<T, 6>, T>::type;
  T a[3], b[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a[c] = pts[seg_pt(0, 0)][c], b[c] = pts[seg_pt(0, 1)][c];
#pragma unroll
  for (int kk = 1; kk < SEGS; ++kk)
    if (kk == k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        a[c] = pts[seg_pt(kk, 0)][c], b[c] = pts[seg_pt(kk, 1)][c];
  const V3<S> s0 = seeded<S>(a, 0);
  const V3<S> s1 = seeded<S>(b, 3);
  const T rb = gb.prm[0];
  if constexpr (KB == SPH)
    return sphere_capsule(lift<S>(gb.p), rb, s0, s1, ra);
  else if constexpr (KB == CAP)
    return capsule_capsule(s0, s1, ra, lift<S>(gb.ea), lift<S>(gb.eb), rb);
  else
    return capsule_box(s0, s1, ra, gb.R, gb.p, gb.prm);
}

// amin_n over the four segments' values v with 12 slots: the minimum (a
// NaN wins), its tangents the sum over the tied segments in k order,
// divided by their count; get(k, s) is segment k's tangent s (0-5).  A
// segment adds only to the slots of its two points: the slots it does not
// touch would add exact zeros.
template <typename T, typename Get>
PN_HD Dual<T, 12> amin_segments(const T (&v)[SEGS], Get get) {
  const T m = amin_n(v, SEGS);
  Dual<T, 12> r(m);
  int count = 0;
#pragma unroll
  for (int k = 0; k < SEGS; ++k)
    if (v[k] == m) {
      ++count;
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const int slot = 3 * seg_pt(k, s / 3) + s % 3;
        r.d[slot] = r.d[slot] + get(k, s);
      }
    }
  if (count > 1)
#pragma unroll
    for (int s = 0; s < 12; ++s) r.d[s] = r.d[s] / T(count);
  return r;
}

// The rest of a query of a capsule swept against static geometry once the
// four segments' values v are known (get(k, s): segment k's tangent s):
// the distance and, with JAC, each endpoint's joint-space row, columns
// lane, lane + lanes, ...; stores only when live.
template <typename T, bool JAC, typename Get>
PN_HD void capsule_static_finish(const Layout& L, const Ptrs<T>& P,
                                 const long long (&off)[N_IN], long long i,
                                 long long o, const T (&pts)[4][3],
                                 const T (&v)[SEGS], Get get, int lane,
                                 int lanes, bool live) {
  if constexpr (!JAC) {
    if (live && lane == 0) P.d[o] = amin_n(v, SEGS);
  } else {
    const Dual<T, 12> d = amin_segments(v, get);
    if (!live) return;
    if (lane == 0) P.d[o] = d.v;
    for (int e = 0; e < 2; ++e) {
      T gw[3], gv[3];
      twist_of(d.d + 6 * e, pts + 2 * e, 2, T(1), gw, gv);
      jac_row(L, P, off, e, i, gw, gv, T(1), P.J[e] + o * L.n_dof, lane,
              lanes);
    }
  }
}

// the queries a group of n_batch x pg queries launches: one lane a query,
// SEGS for a capsule swept against static geometry
template <int MODE, int KA>
constexpr int lanes_of = MODE == 2 && KA == CAP ? SEGS : 1;

// Every group key the kernel takes: X(MODE, KA, KB) for each
#define PN_KEYS(X)                                                        \
  X(0, SPH, SPH) X(0, SPH, CAP) X(0, SPH, BOX) X(0, CAP, CAP)             \
  X(0, CAP, BOX) X(1, SPH, SPH) X(1, SPH, CAP) X(1, SPH, BOX)             \
  X(1, CAP, CAP) X(1, CAP, BOX) X(2, SPH, SPH) X(2, SPH, CAP)             \
  X(2, SPH, BOX) X(2, CAP, SPH) X(2, CAP, CAP) X(2, CAP, BOX)             \
  X(2, BOX, SPH) X(2, BOX, CAP)

}  // namespace pn
