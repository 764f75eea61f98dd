// Native C++ OSQP-semantics ADMM oracle (dense, float64).
//
// Role in the framework: the reference drives OSQP's C solver
// (/root/reference/src/osqp-wrapper.h); OSQP itself is not vendorable here,
// so this self-contained implementation of the same algorithm — reduced-KKT
// ADMM with per-constraint rho, over-relaxation, residual termination at
// OSQP-default tolerances — serves as (a) the ground-truth oracle the JAX
// solver is cross-validated against in tests (tests/test_native_oracle.py),
// and (b) the single-thread CPU wall-clock anchor for BASELINE comparisons.
//
// Deliberately no external dependencies (no Eigen/OSQP): plain C++17,
// row-major dense storage, hand-written Cholesky. Scaling (Ruiz) is omitted;
// compare against the JAX solver with Settings(scaling=0), or rely on both
// meeting the same unscaled residual tolerances.
//
// Build:  g++ -O2 -shared -fPIC -o libosqp_oracle.so osqp_oracle.cpp
// ABI:    extern "C" osqp_oracle_solve(...) -> status int matching
//         osqp_solver_tpu.ops.status.ExitCode values.

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr double kInf = 1e30;
constexpr double kInfThresh = 1e25;
constexpr double kRhoMin = 1e-6;
constexpr double kRhoMax = 1e6;
constexpr double kRhoEqFactor = 1e3;
constexpr double kRhoTol = 1e-4;
constexpr double kDivTol = 1e-10;

enum Status {
  kOptimal = 0,
  kPrimalInfeasible = 1,
  kDualInfeasible = 2,
  kOptimalInaccurate = 3,
  kPrimalInfeasibleInaccurate = 4,
  kDualInfeasibleInaccurate = 5,
  kMaxIterations = 6,
  kNonConvex = 9,
  kUnknown = 10,
};

// Dense lower-triangular Cholesky, row-major. Returns false if not SPD.
bool cholesky(std::vector<double>& M, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = M[i * n + j];
      for (int k = 0; k < j; ++k) s -= M[i * n + k] * M[j * n + k];
      if (i == j) {
        if (s <= 0.0) return false;
        M[i * n + i] = std::sqrt(s);
      } else {
        M[i * n + j] = s / M[j * n + j];
      }
    }
    for (int j = i + 1; j < n; ++j) M[i * n + j] = 0.0;
  }
  return true;
}

void chol_solve(const std::vector<double>& L, std::vector<double>& b, int n) {
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

double inf_norm(const double* v, int n) {
  double m = 0.0;
  for (int i = 0; i < n; ++i) m = std::max(m, std::fabs(v[i]));
  return m;
}

}  // namespace

extern "C" {

// Solve min 0.5 x'Px + q'x  s.t. l <= Ax <= u.  Row-major dense P (n*n),
// A (m*n).  Outputs x (n), y (m). Returns Status.
int osqp_oracle_solve(int n, int m, const double* P, const double* q,
                      const double* A, const double* l, const double* u,
                      double* x_out, double* y_out, int* iters_out,
                      double* prim_res_out, double* dual_res_out,
                      int max_iter, int check_every, double eps_abs,
                      double eps_rel, double eps_prim_inf, double eps_dual_inf,
                      double rho0, double sigma, double alpha,
                      int adaptive_rho, const double* warm_x,
                      const double* warm_y, int stall_checks,
                      double stall_rtol) {
  std::vector<double> rho(m), x(n, 0.0), z(m, 0.0), y(m, 0.0);
  std::vector<double> dx(n, 0.0), dy(m, 0.0);
  double rho_bar = rho0;

  auto rho_vec = [&](double rb) {
    for (int i = 0; i < m; ++i) {
      bool loose = l[i] <= -kInfThresh && u[i] >= kInfThresh;
      bool eq = (u[i] - l[i]) < kRhoTol;
      double r = eq ? kRhoEqFactor * rb : rb;
      if (loose) r = kRhoMin;
      rho[i] = std::min(std::max(r, kRhoMin), kRhoMax);
    }
  };

  std::vector<double> K(n * n);
  auto factor = [&]() -> bool {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) K[i * n + j] = P[i * n + j];
    for (int i = 0; i < n; ++i) K[i * n + i] += sigma;
    for (int r = 0; r < m; ++r)
      for (int i = 0; i < n; ++i) {
        double ari = A[r * n + i];
        if (ari == 0.0) continue;
        double w = rho[r] * ari;
        for (int j = 0; j < n; ++j) K[i * n + j] += w * A[r * n + j];
      }
    return cholesky(K, n);
  };

  rho_vec(rho_bar);
  if (!factor()) return kNonConvex;

  if (warm_x) {
    std::memcpy(x.data(), warm_x, n * sizeof(double));
    for (int r = 0; r < m; ++r) {
      double s = 0.0;
      for (int j = 0; j < n; ++j) s += A[r * n + j] * x[j];
      z[r] = s;
    }
  }
  if (warm_y) std::memcpy(y.data(), warm_y, m * sizeof(double));

  std::vector<double> rhs(n), xt(n), zt(m), Ax(m), Px(n), ATy(n);
  int iter = 0;
  int status = kUnknown;
  double prim_res = 1e30, dual_res = 1e30;
  double stall_ref = 1e300;
  int stall_k = 0;

  // Infeasibility certificates (evaluated strict in-loop; the same
  // predicates run 10x-relaxed at max_iter -> k*InfeasibleInaccurate,
  // matching OSQP termination.c approximate mode).
  auto prim_inf_at = [&](double eps) -> bool {
    double ndy = inf_norm(dy.data(), m);
    if (ndy <= eps) return false;
    double nAtdy = 0, support = 0;
    bool dir_ok = true;
    for (int i = 0; i < n; ++i) {
      double s = 0.0;
      for (int r = 0; r < m; ++r) s += A[r * n + i] * dy[r];
      nAtdy = std::max(nAtdy, std::fabs(s));
    }
    for (int r = 0; r < m; ++r) {
      double dp = std::max(dy[r], 0.0), dn = std::min(dy[r], 0.0);
      if (u[r] >= kInfThresh) {
        if (dp > eps * ndy) dir_ok = false;
      } else {
        support += u[r] * dp;
      }
      if (l[r] <= -kInfThresh) {
        if (-dn > eps * ndy) dir_ok = false;
      } else {
        support += l[r] * dn;
      }
    }
    return dir_ok && nAtdy <= eps * ndy && support <= -eps * ndy;
  };
  auto dual_inf_at = [&](double eps) -> bool {
    double ndx = inf_norm(dx.data(), n);
    if (ndx <= eps) return false;
    double nPdx = 0, qdx = 0;
    bool cone_ok = true;
    for (int i = 0; i < n; ++i) {
      double s = 0.0;
      for (int j = 0; j < n; ++j) s += P[i * n + j] * dx[j];
      nPdx = std::max(nPdx, std::fabs(s));
      qdx += q[i] * dx[i];
    }
    for (int r = 0; r < m && cone_ok; ++r) {
      double s = 0.0;
      for (int j = 0; j < n; ++j) s += A[r * n + j] * dx[j];
      if (u[r] < kInfThresh && s > eps * ndx) cone_ok = false;
      if (l[r] > -kInfThresh && s < -eps * ndx) cone_ok = false;
    }
    return cone_ok && nPdx <= eps * ndx && qdx <= -eps * ndx;
  };

  while (iter < max_iter) {
    for (int step = 0; step < check_every && iter < max_iter; ++step, ++iter) {
      // rhs = sigma*x - q + A'(rho.*z - y)
      for (int i = 0; i < n; ++i) rhs[i] = sigma * x[i] - q[i];
      for (int r = 0; r < m; ++r) {
        double w = rho[r] * z[r] - y[r];
        if (w == 0.0) continue;
        for (int j = 0; j < n; ++j) rhs[j] += A[r * n + j] * w;
      }
      xt = rhs;
      chol_solve(K, xt, n);
      for (int r = 0; r < m; ++r) {
        double s = 0.0;
        for (int j = 0; j < n; ++j) s += A[r * n + j] * xt[j];
        zt[r] = s;
      }
      for (int i = 0; i < n; ++i) {
        double xn = alpha * xt[i] + (1 - alpha) * x[i];
        dx[i] = xn - x[i];
        x[i] = xn;
      }
      for (int r = 0; r < m; ++r) {
        double ztmp = alpha * zt[r] + (1 - alpha) * z[r];
        double zn = ztmp + y[r] / rho[r];
        zn = std::min(std::max(zn, l[r]), u[r]);
        double yn = y[r] + rho[r] * (ztmp - zn);
        dy[r] = yn - y[r];
        y[r] = yn;
        z[r] = zn;
      }
    }

    // Residuals (unscaled problem; no Ruiz here).
    double nAx = 0, nz = 0, nPx = 0, nATy = 0, nq = inf_norm(q, n);
    prim_res = 0;
    dual_res = 0;
    for (int r = 0; r < m; ++r) {
      double s = 0.0;
      for (int j = 0; j < n; ++j) s += A[r * n + j] * x[j];
      Ax[r] = s;
      nAx = std::max(nAx, std::fabs(s));
      nz = std::max(nz, std::fabs(z[r]));
      prim_res = std::max(prim_res, std::fabs(s - z[r]));
    }
    for (int i = 0; i < n; ++i) {
      double px = 0.0, aty = 0.0;
      for (int j = 0; j < n; ++j) px += P[i * n + j] * x[j];
      for (int r = 0; r < m; ++r) aty += A[r * n + i] * y[r];
      Px[i] = px;
      ATy[i] = aty;
      nPx = std::max(nPx, std::fabs(px));
      nATy = std::max(nATy, std::fabs(aty));
      dual_res = std::max(dual_res, std::fabs(px + q[i] + aty));
    }
    double eps_prim = eps_abs + eps_rel * std::max(nAx, nz);
    double eps_dual = eps_abs + eps_rel * std::max(std::max(nPx, nATy), nq);
    if ((m == 0 || prim_res <= eps_prim) && dual_res <= eps_dual) {
      status = kOptimal;
      break;
    }

    if (prim_inf_at(eps_prim_inf)) {
      status = kPrimalInfeasible;
      break;
    }
    if (dual_inf_at(eps_dual_inf)) {
      status = kDualInfeasible;
      break;
    }

    // In-solver stall detection (mirrors ops/admm.py::_stall_update): give
    // up through the max_iter ladder when the residual metric fails to
    // improve by stall_rtol over stall_checks consecutive checks.
    if (stall_checks > 0) {
      double metric = std::max(prim_res / std::max(eps_prim, 1e-30),
                               dual_res / std::max(eps_dual, 1e-30));
      if (metric < (1.0 - stall_rtol) * stall_ref) {
        stall_ref = metric;
        stall_k = 0;
      } else if (++stall_k >= stall_checks) {
        break;  // the post-loop block applies the 10x-relaxed re-check
      }
    }

    // Adaptive rho (interval = every termination check here).
    if (adaptive_rho) {
      double pr = prim_res / std::max(std::max(nAx, nz), kDivTol);
      double dr =
          dual_res / std::max(std::max(std::max(nPx, nATy), nq), kDivTol);
      double nr = rho_bar * std::sqrt(pr / std::max(dr, kDivTol));
      nr = std::min(std::max(nr, kRhoMin), kRhoMax);
      if (nr > 5.0 * rho_bar || nr < rho_bar / 5.0) {
        rho_bar = nr;
        rho_vec(rho_bar);
        if (!factor()) return kNonConvex;
        stall_ref = 1e300;  // residual trajectory restarts under the new rho
        stall_k = 0;
      }
    }
  }

  if (status == kUnknown) {
    status = kMaxIterations;
    // OSQP "inaccurate" check at 10x tolerance — BOTH residuals must pass
    // (OSQP termination.c; matches the JAX core at ops/admm.py::_termination).
    double nAx = 0, nz = 0, nPx = 0, nATy = 0, nq = inf_norm(q, n);
    for (int r = 0; r < m; ++r) {
      nAx = std::max(nAx, std::fabs(Ax[r]));
      nz = std::max(nz, std::fabs(z[r]));
    }
    for (int i = 0; i < n; ++i) {
      nPx = std::max(nPx, std::fabs(Px[i]));
      nATy = std::max(nATy, std::fabs(ATy[i]));
    }
    double eps_p10 = 10 * (eps_abs + eps_rel * std::max(nAx, nz));
    double eps_d10 =
        10 * (eps_abs + eps_rel * std::max(std::max(nPx, nATy), nq));
    if (prim_res <= eps_p10 && dual_res <= eps_d10)
      status = kOptimalInaccurate;
    else if (prim_inf_at(10 * eps_prim_inf))
      status = kPrimalInfeasibleInaccurate;
    else if (dual_inf_at(10 * eps_dual_inf))
      status = kDualInfeasibleInaccurate;
  }

  std::memcpy(x_out, x.data(), n * sizeof(double));
  std::memcpy(y_out, y.data(), m * sizeof(double));
  *iters_out = iter;
  *prim_res_out = prim_res;
  *dual_res_out = dual_res;
  return status;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse-A / banded-KKT variant: the qdldl-equivalent cost model.
//
// The dense path above is O(n^2 m) in assembly and O(n^3) in factorization —
// fine for the small cross-validation QPs, intractable at the reference
// example scale (solver-example.cpp: W=802 -> n=9,624).  OSQP's qdldl
// factors the sparse KKT in near-banded time for trajectory problems; this
// variant makes that explicit: A arrives in CSR, P in CSR, and the reduced
// KKT  P + sigma*I + A' diag(rho) A  is assembled and Cholesky-factored in
// LAPACK-style lower-band storage (half-bandwidth kb, given by the caller —
// 2N for the interleaved [q_t, v_t] trajectory ordering).  Factor cost
// O(n kb^2), solve O(n kb), per-iteration matvecs O(nnz): the honest
// single-thread CPU anchor for BASELINE.md.
// ---------------------------------------------------------------------------

namespace {

// Banded lower Cholesky: band[i*(kb+1)+d] = K[i, i-d], d = 0..kb.
bool band_cholesky(std::vector<double>& band, int n, int kb) {
  const int w = kb + 1;
  for (int i = 0; i < n; ++i) {
    const int j0 = std::max(0, i - kb);
    for (int j = j0; j <= i; ++j) {
      double s = band[i * w + (i - j)];
      const int k0 = std::max(j0, j - kb);
      for (int k = k0; k < j; ++k)
        s -= band[i * w + (i - k)] * band[j * w + (j - k)];
      if (i == j) {
        if (s <= 0.0) return false;
        band[i * w] = std::sqrt(s);
      } else {
        band[i * w + (i - j)] = s / band[j * w];
      }
    }
  }
  return true;
}

void band_chol_solve(const std::vector<double>& band, std::vector<double>& b,
                     int n, int kb) {
  const int w = kb + 1;
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    const int k0 = std::max(0, i - kb);
    for (int k = k0; k < i; ++k) s -= band[i * w + (i - k)] * b[k];
    b[i] = s / band[i * w];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    const int k1 = std::min(n - 1, i + kb);
    for (int k = i + 1; k <= k1; ++k) s -= band[k * w + (k - i)] * b[k];
    b[i] = s / band[i * w];
  }
}

struct Csr {
  const int* indptr;
  const int* indices;
  const double* data;
  int rows;
};

inline void csr_matvec(const Csr& M, const double* v, double* out) {
  for (int r = 0; r < M.rows; ++r) {
    double s = 0.0;
    for (int p = M.indptr[r]; p < M.indptr[r + 1]; ++p)
      s += M.data[p] * v[M.indices[p]];
    out[r] = s;
  }
}

inline void csr_matvec_T(const Csr& M, const double* v, double* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = 0.0;
  for (int r = 0; r < M.rows; ++r) {
    const double vr = v[r];
    if (vr == 0.0) continue;
    for (int p = M.indptr[r]; p < M.indptr[r + 1]; ++p)
      out[M.indices[p]] += M.data[p] * vr;
  }
}

}  // namespace

extern "C" {

// Same ADMM semantics as osqp_oracle_solve, but P/A in CSR and the KKT
// factored banded (half-bandwidth kb).  Returns kNonConvex if a KKT entry
// falls outside the declared band.
int osqp_oracle_solve_sparse(
    int n, int m, int kb, const int* P_indptr, const int* P_indices,
    const double* P_data, const double* q, const int* A_indptr,
    const int* A_indices, const double* A_data, const double* l,
    const double* u, double* x_out,
    double* y_out, int* iters_out, double* prim_res_out, double* dual_res_out,
    int max_iter, int check_every, double eps_abs, double eps_rel,
    double eps_prim_inf, double eps_dual_inf, double rho0, double sigma,
    double alpha, int adaptive_rho, const double* warm_x,
    const double* warm_y, int stall_checks, double stall_rtol) {
  const Csr P{P_indptr, P_indices, P_data, n};
  const Csr A{A_indptr, A_indices, A_data, m};
  std::vector<double> rho(m), x(n, 0.0), z(m, 0.0), y(m, 0.0);
  std::vector<double> dx(n, 0.0), dy(m, 0.0);
  double rho_bar = rho0;

  auto rho_vec = [&](double rb) {
    for (int i = 0; i < m; ++i) {
      bool loose = l[i] <= -kInfThresh && u[i] >= kInfThresh;
      bool eq = (u[i] - l[i]) < kRhoTol;
      double r = eq ? kRhoEqFactor * rb : rb;
      if (loose) r = kRhoMin;
      rho[i] = std::min(std::max(r, kRhoMin), kRhoMax);
    }
  };

  const int w = kb + 1;
  std::vector<double> band((size_t)n * w);
  bool band_ok = true;
  auto factor = [&]() -> bool {
    std::fill(band.begin(), band.end(), 0.0);
    for (int i = 0; i < n; ++i) {
      band[(size_t)i * w] = sigma;
      for (int p = P.indptr[i]; p < P.indptr[i + 1]; ++p) {
        int j = P.indices[p];
        if (j > i) continue;  // lower triangle only
        if (i - j > kb) { band_ok = false; return false; }
        band[(size_t)i * w + (i - j)] += P_data[p];
      }
    }
    for (int r = 0; r < m; ++r) {
      const double rr = rho[r];
      for (int p = A.indptr[r]; p < A.indptr[r + 1]; ++p) {
        const int i = A.indices[p];
        const double w_i = rr * A.data[p];
        for (int p2 = A.indptr[r]; p2 < A.indptr[r + 1]; ++p2) {
          const int j = A.indices[p2];
          if (j > i) continue;
          if (i - j > kb) { band_ok = false; return false; }
          band[(size_t)i * w + (i - j)] += w_i * A.data[p2];
        }
      }
    }
    return band_cholesky(band, n, kb);
  };

  rho_vec(rho_bar);
  if (!factor()) return kNonConvex;

  if (warm_x) {
    std::memcpy(x.data(), warm_x, n * sizeof(double));
    csr_matvec(A, x.data(), z.data());
  }
  if (warm_y) std::memcpy(y.data(), warm_y, m * sizeof(double));

  std::vector<double> rhs(n), xt(n), zt(m), Ax(m), Px(n), ATy(n), tmp_m(m);
  int iter = 0;
  int status = kUnknown;
  double prim_res = 1e30, dual_res = 1e30;
  double stall_ref = 1e300;
  int stall_k = 0;

  // Same certificates as the dense path, via CSR matvecs (strict in-loop,
  // 10x-relaxed at max_iter -> k*InfeasibleInaccurate).
  std::vector<double> cert_n(n), cert_m(m);
  auto prim_inf_at = [&](double eps) -> bool {
    double ndy = inf_norm(dy.data(), m);
    if (ndy <= eps) return false;
    csr_matvec_T(A, dy.data(), cert_n.data(), n);
    double nAtdy = inf_norm(cert_n.data(), n), support = 0;
    bool dir_ok = true;
    for (int r = 0; r < m; ++r) {
      double dp = std::max(dy[r], 0.0), dn = std::min(dy[r], 0.0);
      if (u[r] >= kInfThresh) {
        if (dp > eps * ndy) dir_ok = false;
      } else {
        support += u[r] * dp;
      }
      if (l[r] <= -kInfThresh) {
        if (-dn > eps * ndy) dir_ok = false;
      } else {
        support += l[r] * dn;
      }
    }
    return dir_ok && nAtdy <= eps * ndy && support <= -eps * ndy;
  };
  auto dual_inf_at = [&](double eps) -> bool {
    double ndx = inf_norm(dx.data(), n);
    if (ndx <= eps) return false;
    csr_matvec(P, dx.data(), cert_n.data());
    double nPdx = inf_norm(cert_n.data(), n), qdx = 0;
    for (int i = 0; i < n; ++i) qdx += q[i] * dx[i];
    csr_matvec(A, dx.data(), cert_m.data());
    bool cone_ok = true;
    for (int r = 0; r < m && cone_ok; ++r) {
      if (u[r] < kInfThresh && cert_m[r] > eps * ndx) cone_ok = false;
      if (l[r] > -kInfThresh && cert_m[r] < -eps * ndx) cone_ok = false;
    }
    return cone_ok && nPdx <= eps * ndx && qdx <= -eps * ndx;
  };

  while (iter < max_iter) {
    for (int step = 0; step < check_every && iter < max_iter; ++step, ++iter) {
      for (int r = 0; r < m; ++r) tmp_m[r] = rho[r] * z[r] - y[r];
      csr_matvec_T(A, tmp_m.data(), rhs.data(), n);
      for (int i = 0; i < n; ++i) rhs[i] += sigma * x[i] - q[i];
      xt = rhs;
      band_chol_solve(band, xt, n, kb);
      csr_matvec(A, xt.data(), zt.data());
      for (int i = 0; i < n; ++i) {
        double xn = alpha * xt[i] + (1 - alpha) * x[i];
        dx[i] = xn - x[i];
        x[i] = xn;
      }
      for (int r = 0; r < m; ++r) {
        double ztmp = alpha * zt[r] + (1 - alpha) * z[r];
        double zn = ztmp + y[r] / rho[r];
        zn = std::min(std::max(zn, l[r]), u[r]);
        double yn = y[r] + rho[r] * (ztmp - zn);
        dy[r] = yn - y[r];
        y[r] = yn;
        z[r] = zn;
      }
    }

    csr_matvec(A, x.data(), Ax.data());
    csr_matvec(P, x.data(), Px.data());
    csr_matvec_T(A, y.data(), ATy.data(), n);
    double nAx = inf_norm(Ax.data(), m), nz = inf_norm(z.data(), m);
    double nPx = inf_norm(Px.data(), n), nATy = inf_norm(ATy.data(), n);
    double nq = 0.0;
    prim_res = 0.0;
    dual_res = 0.0;
    for (int r = 0; r < m; ++r)
      prim_res = std::max(prim_res, std::fabs(Ax[r] - z[r]));
    for (int i = 0; i < n; ++i) {
      const double qi = q[i];
      nq = std::max(nq, std::fabs(qi));
      dual_res = std::max(dual_res, std::fabs(Px[i] + qi + ATy[i]));
    }
    double eps_prim = eps_abs + eps_rel * std::max(nAx, nz);
    double eps_dual = eps_abs + eps_rel * std::max(std::max(nPx, nATy), nq);
    if ((m == 0 || prim_res <= eps_prim) && dual_res <= eps_dual) {
      status = kOptimal;
      break;
    }

    if (prim_inf_at(eps_prim_inf)) {
      status = kPrimalInfeasible;
      break;
    }
    if (dual_inf_at(eps_dual_inf)) {
      status = kDualInfeasible;
      break;
    }

    // In-solver stall detection (mirrors ops/admm.py::_stall_update).
    if (stall_checks > 0) {
      double metric = std::max(prim_res / std::max(eps_prim, 1e-30),
                               dual_res / std::max(eps_dual, 1e-30));
      if (metric < (1.0 - stall_rtol) * stall_ref) {
        stall_ref = metric;
        stall_k = 0;
      } else if (++stall_k >= stall_checks) {
        break;  // the post-loop block applies the 10x-relaxed re-check
      }
    }

    if (adaptive_rho) {
      double pr = prim_res / std::max(std::max(nAx, nz), kDivTol);
      double dr =
          dual_res / std::max(std::max(std::max(nPx, nATy), nq), kDivTol);
      double nr = rho_bar * std::sqrt(pr / std::max(dr, kDivTol));
      nr = std::min(std::max(nr, kRhoMin), kRhoMax);
      if (nr > 5.0 * rho_bar || nr < rho_bar / 5.0) {
        rho_bar = nr;
        rho_vec(rho_bar);
        if (!factor()) return kNonConvex;
        stall_ref = 1e300;
        stall_k = 0;
      }
    }
  }

  if (status == kUnknown) {
    status = kMaxIterations;
    double nAx = inf_norm(Ax.data(), m), nz = inf_norm(z.data(), m);
    double nPx = inf_norm(Px.data(), n), nATy = inf_norm(ATy.data(), n);
    double nq = 0.0;
    for (int i = 0; i < n; ++i) nq = std::max(nq, std::fabs(q[i]));
    double eps_p10 = 10 * (eps_abs + eps_rel * std::max(nAx, nz));
    double eps_d10 =
        10 * (eps_abs + eps_rel * std::max(std::max(nPx, nATy), nq));
    if (prim_res <= eps_p10 && dual_res <= eps_d10)
      status = kOptimalInaccurate;
    else if (prim_inf_at(10 * eps_prim_inf))
      status = kPrimalInfeasibleInaccurate;
    else if (dual_inf_at(10 * eps_dual_inf))
      status = kDualInfeasibleInaccurate;
  }

  std::memcpy(x_out, x.data(), n * sizeof(double));
  std::memcpy(y_out, y.data(), m * sizeof(double));
  *iters_out = iter;
  *prim_res_out = prim_res;
  *dual_res_out = dual_res;
  return status;
}

}  // extern "C"
