// Native CPU QP backend: dense proximal ADMM with Ruiz equilibration.
//
// Role: the host-side counterpart of the reference's native QP backends
// (sco::ModelType OSQP/qpOASES/BPMPD, trajopt_sco/src/osqp_interface.cpp
// etc.) for our framework.  Implements the same prox-form QP the JAX/TPU
// ADMM solves (trajopt_tpu/qp/admm.py):
//
//   minimize 0.5 x'Px + q'x + sum_i c_i * dist(A_i x, [l_i, u_i])
//
// with c_i = +inf meaning a hard row.  Used for validation against the TPU
// path and as a low-latency single-problem fallback; exposed through a C
// ABI consumed via ctypes (no pybind11 in this image).
//
// Self-contained: no Eigen; dense row-major doubles; LDL^T-free plain
// Cholesky (the KKT matrix P + sigma I + A'RA is SPD by construction).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Work {
  int n, m;
  std::vector<double> P, q, A, l, u, c;  // scaled copies
  std::vector<double> D, E;              // Ruiz scalings
  double c_obj;
  std::vector<double> M;                 // KKT matrix / Cholesky factor
  std::vector<double> rho;
};

// In-place Cholesky (lower) of SPD matrix M[n*n]; returns false on failure.
bool cholesky(std::vector<double>& M, int n) {
  for (int j = 0; j < n; ++j) {
    double d = M[j * n + j];
    for (int k = 0; k < j; ++k) d -= M[j * n + k] * M[j * n + k];
    if (d <= 0.0 || !std::isfinite(d)) return false;
    const double Ljj = std::sqrt(d);
    M[j * n + j] = Ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = M[i * n + j];
      for (int k = 0; k < j; ++k) s -= M[i * n + k] * M[j * n + k];
      M[i * n + j] = s / Ljj;
    }
  }
  return true;
}

void cho_solve(const std::vector<double>& L, int n, double* b) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * b[k];
    b[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * b[k];
    b[i] = s / L[i * n + i];
  }
}

double inf_norm(const std::vector<double>& v) {
  double out = 0.0;
  for (double x : v) out = std::max(out, std::fabs(x));
  return out;
}

// Ruiz equilibration matching trajopt_tpu/qp/admm.py::ruiz_equilibrate.
void ruiz(Work& w, int iters) {
  const int n = w.n, m = w.m;
  w.D.assign(n, 1.0);
  w.E.assign(m, 1.0);
  w.c_obj = 1.0;
  std::vector<double> dcol(n), erow(m);
  for (int it = 0; it < iters; ++it) {
    for (int j = 0; j < n; ++j) {
      double nm = 0.0;
      for (int i = 0; i < n; ++i) nm = std::max(nm, std::fabs(w.P[i * n + j]));
      for (int i = 0; i < m; ++i) nm = std::max(nm, std::fabs(w.A[i * n + j]));
      dcol[j] = nm < 1e-12 ? 1.0 : 1.0 / std::sqrt(nm);
    }
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) w.P[i * n + j] *= dcol[i] * dcol[j];
    for (int j = 0; j < n; ++j) w.q[j] *= dcol[j];
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < n; ++j) w.A[i * n + j] *= dcol[j];
    for (int i = 0; i < m; ++i) {
      double nm = 0.0;
      for (int j = 0; j < n; ++j) nm = std::max(nm, std::fabs(w.A[i * n + j]));
      erow[i] = nm < 1e-12 ? 1.0 : 1.0 / std::sqrt(nm);
      for (int j = 0; j < n; ++j) w.A[i * n + j] *= erow[i];
    }
    double mean_col = 0.0;
    for (int j = 0; j < n; ++j) {
      double nm = 0.0;
      for (int i = 0; i < n; ++i) nm = std::max(nm, std::fabs(w.P[i * n + j]));
      mean_col += nm;
    }
    mean_col /= n;
    double qn = inf_norm(w.q);
    double den = std::max(mean_col, qn);
    double g = den < 1e-12 ? 1.0 : 1.0 / den;
    for (auto& v : w.P) v *= g;
    for (auto& v : w.q) v *= g;
    w.c_obj *= g;
    for (int j = 0; j < n; ++j) w.D[j] *= dcol[j];
    for (int i = 0; i < m; ++i) w.E[i] *= erow[i];
  }
  for (int i = 0; i < m; ++i) {
    w.l[i] *= w.E[i];
    w.u[i] *= w.E[i];
    if (std::isfinite(w.c[i])) w.c[i] = w.c_obj * w.c[i] / w.E[i];
  }
}

double prox_dist(double v, double l, double u, double c_over_rho) {
  if (v > u) return std::max(u, v - c_over_rho);
  if (v < l) return std::min(l, v + c_over_rho);
  return v;
}

}  // namespace

extern "C" {

// Returns 0 on convergence, 1 on max-iter, -1 on factorization failure.
// x/z/y are in/out warm starts (unscaled).  All matrices row-major.
int tpu_trajopt_qp_solve(
    int n, int m,
    const double* P, const double* q, const double* A,
    const double* l, const double* u, const double* c,
    double sigma, double alpha, double rho0, double rho_eq_scale,
    int max_iter, int check_every, double eps_abs, double eps_rel,
    double* x_io, double* z_io, double* y_io,
    int* iters_out, double* pri_out, double* dua_out) {
  Work w;
  w.n = n;
  w.m = m;
  w.P.assign(P, P + n * n);
  w.q.assign(q, q + n);
  w.A.assign(A, A + m * n);
  w.l.assign(l, l + m);
  w.u.assign(u, u + m);
  w.c.assign(c, c + m);
  ruiz(w, 10);

  // per-row rho (hard equality rows boosted, as in OSQP)
  w.rho.assign(m, rho0);
  for (int i = 0; i < m; ++i)
    if (!std::isfinite(w.c[i]) && (w.u[i] - w.l[i]) < 1e-10)
      w.rho[i] = rho0 * rho_eq_scale;

  std::vector<double> x(n), z(m), y(m);
  for (int j = 0; j < n; ++j) x[j] = x_io[j] / w.D[j];
  for (int i = 0; i < m; ++i) z[i] = z_io[i] * w.E[i];
  for (int i = 0; i < m; ++i) y[i] = y_io[i] * w.c_obj / w.E[i];

  double rho_scale = 1.0;
  const double q_norm_un = [&] {
    double nm = 0.0;
    for (int j = 0; j < n; ++j) nm = std::max(nm, std::fabs(q[j]));
    return nm;
  }();

  std::vector<double> rhs(n), xt(n), zt(m), Ax(m), Px(n), Aty(n);
  int iters = 0;
  double pri = kInf, dua = kInf;
  bool converged = false;

  while (!converged && iters < max_iter) {
    // (re)factor M = P + sigma I + A'RA with current rho
    std::vector<double> rho(m);
    for (int i = 0; i < m; ++i)
      rho[i] = std::min(std::max(w.rho[i] * rho_scale, 1e-6), 1e6);
    w.M.assign(n * n, 0.0);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) w.M[i * n + j] = w.P[i * n + j];
    for (int j = 0; j < n; ++j) w.M[j * n + j] += sigma;
    for (int k = 0; k < m; ++k) {
      const double* ak = &w.A[k * n];
      for (int i = 0; i < n; ++i) {
        const double r = rho[k] * ak[i];
        if (r == 0.0) continue;
        for (int j = 0; j < n; ++j) w.M[i * n + j] += r * ak[j];
      }
    }
    if (!cholesky(w.M, n)) return -1;

    for (int step = 0; step < check_every && iters < max_iter; ++step, ++iters) {
      for (int j = 0; j < n; ++j) rhs[j] = sigma * x[j] - w.q[j];
      for (int k = 0; k < m; ++k) {
        const double t = rho[k] * z[k] - y[k];
        const double* ak = &w.A[k * n];
        for (int j = 0; j < n; ++j) rhs[j] += ak[j] * t;
      }
      xt = rhs;
      cho_solve(w.M, n, xt.data());
      for (int k = 0; k < m; ++k) {
        double s = 0.0;
        const double* ak = &w.A[k * n];
        for (int j = 0; j < n; ++j) s += ak[j] * xt[j];
        zt[k] = s;
      }
      for (int j = 0; j < n; ++j) x[j] = alpha * xt[j] + (1 - alpha) * x[j];
      for (int k = 0; k < m; ++k) {
        const double zr = alpha * zt[k] + (1 - alpha) * z[k];
        const double v = zr + y[k] / rho[k];
        const double cr = std::isfinite(w.c[k]) ? w.c[k] / rho[k] : kInf;
        const double zn = prox_dist(v, w.l[k], w.u[k], cr);
        y[k] += rho[k] * (zr - zn);
        z[k] = zn;
      }
    }

    // unscaled residuals
    for (int k = 0; k < m; ++k) {
      double s = 0.0;
      const double* ak = &w.A[k * n];
      for (int j = 0; j < n; ++j) s += ak[j] * x[j];
      Ax[k] = s;
    }
    for (int i = 0; i < n; ++i) {
      double s = 0.0;
      for (int j = 0; j < n; ++j) s += w.P[i * n + j] * x[j];
      Px[i] = s;
    }
    for (int j = 0; j < n; ++j) {
      double s = 0.0;
      for (int k = 0; k < m; ++k) s += w.A[k * n + j] * y[k];
      Aty[j] = s;
    }
    double ax_un = 0, z_un = 0, px_un = 0, aty_un = 0;
    pri = 0;
    dua = 0;
    for (int k = 0; k < m; ++k) {
      const double axk = Ax[k] / w.E[k];
      const double zk = z[k] / w.E[k];
      pri = std::max(pri, std::fabs(axk - zk));
      ax_un = std::max(ax_un, std::fabs(axk));
      z_un = std::max(z_un, std::fabs(zk));
    }
    for (int j = 0; j < n; ++j) {
      const double sc = w.c_obj * w.D[j];
      dua = std::max(dua, std::fabs((Px[j] + w.q[j] + Aty[j]) / sc));
      px_un = std::max(px_un, std::fabs(Px[j] / sc));
      aty_un = std::max(aty_un, std::fabs(Aty[j] / sc));
    }
    const double eps_pri = eps_abs + eps_rel * std::max(ax_un, z_un);
    const double eps_dua =
        eps_abs + eps_rel * std::max(std::max(px_un, aty_un), q_norm_un);
    converged = pri <= eps_pri && dua <= eps_dua;

    if (!converged) {
      const double tiny = 1e-30;
      const double ratio = std::sqrt((pri / std::max(eps_pri, tiny)) /
                                     std::max(dua / std::max(eps_dua, tiny), tiny));
      const double r = std::min(std::max(std::isfinite(ratio) ? ratio : 1.0, 1e-2), 1e2);
      if (r > 5.0 || r < 0.2) rho_scale *= r;
    }
  }

  for (int j = 0; j < n; ++j) x_io[j] = x[j] * w.D[j];
  for (int i = 0; i < m; ++i) z_io[i] = z[i] / w.E[i];
  for (int i = 0; i < m; ++i) y_io[i] = y[i] * w.E[i] / w.c_obj;
  *iters_out = iters;
  *pri_out = pri;
  *dua_out = dua;
  return converged ? 0 : 1;
}

}  // extern "C"
