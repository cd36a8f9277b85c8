// Native host-side kernel library for matlab_code_tpu.
//
// Native replacements for the reference's external native dependencies
// (L-BFGS-B-C, TV_Condat_v2, Proximity Operator Repository — README.md:7-10):
// exact 1-D total-variation prox (Condat's direct algorithm), isotonic (PAVA)
// and unimodal (Stout prefix-isotonic) regression, simplex projection, and a
// box-constrained limited-memory BFGS.  These run on the host CPU as the
// golden/validation path and for host-side pre/post-processing; the jit
// compute path uses the JAX implementations in matlab_code_tpu/ops/.
//
// C ABI, consumed via ctypes (native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Condat's direct 1-D TV denoising (exact prox), one column.
// Reference behavior: TV_Condat_v2.m as wrapped by functions/prox_TV.m.
// ---------------------------------------------------------------------------
void tv_denoise(const double* y, double* x, int64_t n, double lam) {
  if (n <= 0) return;
  if (n == 1 || lam <= 0) {
    std::memcpy(x, y, sizeof(double) * n);
    return;
  }
  int64_t k = 0, k0 = 0, km = 0, kp = 0;
  double vmin = y[0] - lam, vmax = y[0] + lam;
  double umin = lam, umax = -lam;
  for (;;) {
    if (k == n - 1) {
      // boundary handling (steps b/i/j/k of the paper)
      if (umin < 0) {
        for (int64_t i = k0; i <= km; ++i) x[i] = vmin;
        k = k0 = km = km + 1;
        vmin = y[k];
        umin = lam;
        umax = y[k] + lam - vmax;
        if (k == n - 1) { x[k] = vmin + umin; return; }
        continue;
      } else if (umax > 0) {
        for (int64_t i = k0; i <= kp; ++i) x[i] = vmax;
        k = k0 = kp = kp + 1;
        vmax = y[k];
        umax = -lam;
        umin = y[k] - lam - vmin;
        if (k == n - 1) { x[k] = vmin + umin; return; }
        continue;
      } else {
        double v = vmin + umin / static_cast<double>(k - k0 + 1);
        for (int64_t i = k0; i <= n - 1; ++i) x[i] = v;
        return;
      }
    }
    if (y[k + 1] + umin < vmin - lam) {          // negative jump
      for (int64_t i = k0; i <= km; ++i) x[i] = vmin;
      k = k0 = km = kp = km + 1;
      vmin = y[k];
      vmax = y[k] + 2 * lam;
      umin = lam;
      umax = -lam;
      if (k == n - 1) { x[k] = vmin + umin; return; }
    } else if (y[k + 1] + umax > vmax + lam) {   // positive jump
      for (int64_t i = k0; i <= kp; ++i) x[i] = vmax;
      k = k0 = km = kp = kp + 1;
      vmin = y[k] - 2 * lam;
      vmax = y[k];
      umin = lam;
      umax = -lam;
      if (k == n - 1) { x[k] = vmin + umin; return; }
    } else {                                      // no jump: extend segment
      k += 1;
      umin += y[k] - vmin;
      umax += y[k] - vmax;
      if (umin >= lam) {
        vmin += (umin - lam) / static_cast<double>(k - k0 + 1);
        umin = lam;
        km = k;
      }
      if (umax <= -lam) {
        vmax += (umax + lam) / static_cast<double>(k - k0 + 1);
        umax = -lam;
        kp = k;
      }
    }
  }
}

// column-wise over an (n x r) column-major-by-column buffer
void tv_denoise_cols(const double* Y, double* X, int64_t n, int64_t r,
                     double lam) {
  for (int64_t c = 0; c < r; ++c) tv_denoise(Y + c * n, X + c * n, n, lam);
}

// ---------------------------------------------------------------------------
// L2 isotonic regression (PAVA), nondecreasing, one vector.
// Reference behavior: project_monotone (constraints_to_prox.m:25-28).
// ---------------------------------------------------------------------------
void isotonic(const double* y, double* x, int64_t n) {
  std::vector<double> level(n), weight(n);
  std::vector<int64_t> len(n);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    level[m] = y[i];
    weight[m] = 1.0;
    len[m] = 1;
    while (m > 0 && level[m - 1] >= level[m]) {
      double w = weight[m - 1] + weight[m];
      level[m - 1] = (weight[m - 1] * level[m - 1] + weight[m] * level[m]) / w;
      weight[m - 1] = w;
      len[m - 1] += len[m];
      --m;
    }
    ++m;
  }
  int64_t pos = 0;
  for (int64_t b = 0; b < m; ++b)
    for (int64_t i = 0; i < len[b]; ++i) x[pos++] = level[b];
}

// ---------------------------------------------------------------------------
// Unimodal (optionally nonnegative) L2 regression, one vector —
// Stout 2008 prefix-isotonic algorithm; reference behavior:
// functions/project_unimodal_vector.m.
// ---------------------------------------------------------------------------
namespace {
struct PrefixIso {
  std::vector<double> level, err;
  std::vector<int64_t> idxr;  // slot of the leftmost member of the level set
};

PrefixIso prefix_isotonic(const double* y, int64_t n, bool nonneg) {
  PrefixIso out;
  // slot 0 is a sentinel (level -inf, err 0)
  std::vector<double> sumwy(n + 1, 0), sumwy2(n + 1, 0), sumw(n + 1, 0);
  out.level.assign(n + 1, -HUGE_VAL);
  out.err.assign(n + 1, 0.0);
  out.idxr.assign(n + 1, 0);
  std::vector<double> cum(n + 1, 0.0);
  std::vector<char> thresh(n + 1, 0);
  for (int64_t i = 1; i <= n; ++i) {
    sumwy[i] = y[i - 1];
    sumwy2[i] = y[i - 1] * y[i - 1];
    sumw[i] = 1.0;
    cum[i] = cum[i - 1] + sumwy2[i];
  }
  for (int64_t i = 1; i <= n; ++i) {
    out.level[i] = y[i - 1];
    out.idxr[i] = i;
    while (out.level[i] <= out.level[out.idxr[i] - 1]) {
      int64_t mg = out.idxr[i] - 1;
      sumwy[i] += sumwy[mg];
      sumwy2[i] += sumwy2[mg];
      sumw[i] += sumw[mg];
      out.level[i] = sumwy[i] / sumw[i];
      out.idxr[i] = out.idxr[mg];
    }
    double levelerror = sumwy2[i] - sumwy[i] * sumwy[i] / sumw[i];
    if (nonneg && out.level[i] < 0) {
      thresh[i] = 1;
      out.err[i] = cum[i - 1];  // replicates project_unimodal_vector.m:68-70
    } else {
      out.err[i] = levelerror + out.err[out.idxr[i] - 1];
    }
  }
  if (nonneg)
    for (int64_t i = 1; i <= n; ++i)
      if (thresh[i]) out.level[i] = 0.0;
  return out;
}

void reconstruct(const PrefixIso& p, int64_t mode_idx, double* x) {
  int64_t idx = mode_idx;
  while (idx >= 1) {
    int64_t left = p.idxr[idx];
    for (int64_t j = left; j <= idx; ++j) x[j - 1] = p.level[idx];
    idx = left - 1;
  }
}
}  // namespace

void unimodal(const double* y, double* x, int64_t n, int nonneg) {
  PrefixIso L = prefix_isotonic(y, n, nonneg != 0);
  std::vector<double> yr(n);
  for (int64_t i = 0; i < n; ++i) yr[i] = y[n - 1 - i];
  PrefixIso Rp = prefix_isotonic(yr.data(), n, nonneg != 0);
  // best peak index (1-based prefix length), first minimum wins
  int64_t best = 1;
  double best_err = L.err[1] + Rp.err[n];
  for (int64_t i = 2; i <= n; ++i) {
    double e = L.err[i] + Rp.err[n - i + 1];
    if (e < best_err) {
      best_err = e;
      best = i;
    }
  }
  std::vector<double> left(n, 0.0), right(n, 0.0);
  reconstruct(L, best, left.data());
  reconstruct(Rp, n - best, right.data());
  for (int64_t j = 0; j < n; ++j)
    x[j] = (j < best) ? left[j] : right[n - 1 - j];
}

// ---------------------------------------------------------------------------
// Euclidean projection of a vector onto {v >= 0, sum v = eta}.
// ---------------------------------------------------------------------------
void simplex_project(const double* y, double* x, int64_t n, double eta) {
  std::vector<double> u(y, y + n);
  std::sort(u.begin(), u.end(), std::greater<double>());
  double css = 0.0, tau = 0.0;
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    css += u[i];
    double t = (css - eta) / static_cast<double>(i + 1);
    if (u[i] - t > 0) {
      k = i + 1;
      tau = t;
    }
  }
  (void)k;
  for (int64_t i = 0; i < n; ++i) x[i] = std::max(y[i] - tau, 0.0);
}

// ---------------------------------------------------------------------------
// Box-constrained limited-memory BFGS (projected two-loop with active-set
// restriction + Armijo backtracking) — host-side counterpart of
// matlab_code_tpu/ops/lbfgsb.py; replaces the L-BFGS-B-C MEX dependency
// (cmtf_fun_AOADMM.m:1415) for host callers.
// fg: callback computing f and grad at x.
// ---------------------------------------------------------------------------
typedef double (*fg_fn)(const double* x, double* grad, int64_t n, void* ctx);

int64_t lbfgsb_minimize(fg_fn fg, void* ctx, double* x, int64_t n,
                        const double* lo, const double* hi, int m,
                        int maxiter, double pgtol, double factr) {
  const double eps = 2.220446049250313e-16;
  auto proj = [&](std::vector<double>& v) {
    for (int64_t i = 0; i < n; ++i) v[i] = std::min(std::max(v[i], lo[i]), hi[i]);
  };
  std::vector<double> xv(x, x + n);
  proj(xv);
  std::vector<double> g(n), gnew(n), d(n), xtry(n);
  double f = fg(xv.data(), g.data(), n, ctx);
  std::vector<std::vector<double>> S, Y;
  std::vector<double> rho;
  int64_t it = 0;
  for (; it < maxiter; ++it) {
    // projected-gradient stopping
    double pg = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      double step = std::min(std::max(xv[i] - g[i], lo[i]), hi[i]) - xv[i];
      pg = std::max(pg, std::fabs(step));
    }
    if (pg <= pgtol) break;
    // active-set restricted two-loop
    std::vector<char> active(n);
    for (int64_t i = 0; i < n; ++i)
      active[i] = (xv[i] <= lo[i] + 1e-10 && g[i] > 0) ||
                  (xv[i] >= hi[i] - 1e-10 && g[i] < 0);
    std::vector<double> q(n);
    for (int64_t i = 0; i < n; ++i) q[i] = active[i] ? 0.0 : g[i];
    int np = static_cast<int>(S.size());
    std::vector<double> alpha(np);
    for (int j = np - 1; j >= 0; --j) {
      double a = 0;
      for (int64_t i = 0; i < n; ++i) a += S[j][i] * q[i];
      a *= rho[j];
      alpha[j] = a;
      for (int64_t i = 0; i < n; ++i) q[i] -= a * Y[j][i];
    }
    double gamma = 1.0;
    if (np > 0) {
      double sy = 0, yy = 0;
      for (int64_t i = 0; i < n; ++i) {
        sy += S[np - 1][i] * Y[np - 1][i];
        yy += Y[np - 1][i] * Y[np - 1][i];
      }
      if (yy > 0) gamma = sy / yy;
    }
    for (int64_t i = 0; i < n; ++i) q[i] *= gamma;
    for (int j = 0; j < np; ++j) {
      double b = 0;
      for (int64_t i = 0; i < n; ++i) b += Y[j][i] * q[i];
      b *= rho[j];
      for (int64_t i = 0; i < n; ++i) q[i] += (alpha[j] - b) * S[j][i];
    }
    double desc = 0;
    for (int64_t i = 0; i < n; ++i) {
      d[i] = active[i] ? 0.0 : -q[i];
      desc += g[i] * d[i];
    }
    if (desc >= 0)
      for (int64_t i = 0; i < n; ++i) d[i] = active[i] ? 0.0 : -g[i];
    // line search
    double dn = 0;
    for (int64_t i = 0; i < n; ++i) dn += d[i] * d[i];
    dn = std::sqrt(dn);
    double a = (np == 0) ? std::min(1.0, 1.0 / std::max(dn, 1e-30)) : 1.0;
    bool ok = false;
    double ftry = f;
    for (int ls = 0; ls < 60; ++ls) {
      for (int64_t i = 0; i < n; ++i) xtry[i] = xv[i] + a * d[i];
      proj(xtry);
      ftry = fg(xtry.data(), gnew.data(), n, ctx);
      double dec = 0;
      for (int64_t i = 0; i < n; ++i) dec += g[i] * (xtry[i] - xv[i]);
      if (ftry <= f + 1e-4 * dec || (ls == 59 && ftry < f)) {
        ok = true;
        break;
      }
      a *= 0.5;
    }
    if (!ok) break;
    // curvature pair
    std::vector<double> s(n), yv(n);
    double sy = 0, sn = 0, yn = 0;
    for (int64_t i = 0; i < n; ++i) {
      s[i] = xtry[i] - xv[i];
      yv[i] = gnew[i] - g[i];
      sy += s[i] * yv[i];
      sn += s[i] * s[i];
      yn += yv[i] * yv[i];
    }
    if (sy > eps * std::sqrt(sn) * std::sqrt(yn)) {
      S.push_back(std::move(s));
      Y.push_back(std::move(yv));
      rho.push_back(1.0 / sy);
      if (static_cast<int>(S.size()) > m) {
        S.erase(S.begin());
        Y.erase(Y.begin());
        rho.erase(rho.begin());
      }
    }
    double df = f - ftry;
    xv.swap(xtry);
    g.swap(gnew);
    f = ftry;
    if (df <= factr * eps * std::max({std::fabs(f), std::fabs(f + df), 1.0}))
      { ++it; break; }
  }
  std::memcpy(x, xv.data(), sizeof(double) * n);
  return it;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MATLAB twister randn cross-validation oracle.
//
// INDEPENDENT reconstruction of MATLAB's mt19937ar + ziggurat
// NormalTransform, for cross-checking utils/matlab_rng.py (which has
// published anchors only for the fast path): classic sequential
// Matsumoto-Nishimura generate loop (vs the Python module's vectorized
// three-chunk twist), genrand_res53 uniforms, and the 256-region ziggurat
// with the x-table SOLVED AT RUNTIME in long double via bisection on the
// equal-area closure (vs the Python module's embedded 60-digit-precision
// hex table).  The accept/reject structure follows the MATLAB-Coder-emitted
// sampler shape (see matlab_rng.py module docstring): fast accept
// |u*W[idx]| <= A[idx]; edge wedge F[i+1] + U*(F[i]-F[i+1]) < f(x); tail
// x = -log(U1)/r accepted when -2 log(U2) >= x^2.  Agreement of the two
// implementations over >= 1e7 draws (tests/test_native.py) validates that
// the reconstruction is internally consistent and that neither carries an
// implementation slip — it cannot, by itself, prove fidelity to MATLAB's
// unpublished rejection paths (that boundary stays documented).
// ---------------------------------------------------------------------------

namespace matlab_rng_oracle {

struct MT {
  uint32_t mt[624];
  int mti;
  void seed(uint32_t s) {
    mt[0] = s;
    for (int i = 1; i < 624; ++i)
      mt[i] = 1812433253u * (mt[i - 1] ^ (mt[i - 1] >> 30)) +
              static_cast<uint32_t>(i);
    mti = 624;
  }
  uint32_t next() {
    if (mti >= 624) {
      for (int kk = 0; kk < 624; ++kk) {
        uint32_t y =
            (mt[kk] & 0x80000000u) | (mt[(kk + 1) % 624] & 0x7fffffffu);
        mt[kk] = mt[(kk + 397) % 624] ^ (y >> 1) ^
                 ((y & 1u) ? 0x9908b0dfu : 0u);
      }
      mti = 0;
    }
    uint32_t y = mt[mti++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }
  double rand53() {  // genrand_res53: two words per double
    uint32_t a = next() >> 5, b = next() >> 6;
    return (a * 67108864.0 + b) / 9007199254740992.0;
  }
};

struct Zig {
  double xs[256];   // x[0]=0 .. x[255]=r (increasing)
  double W[256];    // multiplier: x[i+1], base strip v/f(r)
  double A[256];    // accept bound: x[i], base strip r
  double F[256];    // f(x[i]) for the edge-wedge test
  double invr;      // 1/r as the rounded double constant
  bool built = false;

  static long double f(long double x) { return expl(-0.5L * x * x); }
  static long double tail_area(long double r) {
    return sqrtl(acosl(-1.0L) / 2.0L) * erfcl(r / sqrtl(2.0L));
  }
  // residual of the equal-area closure for a candidate r: descend
  // x[i-1] = sqrt(-2 ln(v/x[i] + f(x[i]))) from x[255]=r and report
  // v/x[1] + f(x[1]) - 1 (zero iff x[0] lands exactly at 0)
  static long double closure(long double r, long double* xs_out) {
    long double v = r * f(r) + tail_area(r);
    long double x = r;
    if (xs_out) xs_out[255] = r;
    for (int i = 254; i >= 1; --i) {
      long double arg = v / x + f(x);
      if (arg >= 1.0L) return 1.0L;  // chain collapsed: r too small
      x = sqrtl(-2.0L * logl(arg));
      if (xs_out) xs_out[i] = x;
    }
    return v / x + f(x) - 1.0L;
  }
  void build() {
    if (built) return;
    long double lo = 3.0L, hi = 4.0L;  // closure is +1 at 3.0, <0 at 4.0
    for (int it = 0; it < 200; ++it) {
      long double mid = 0.5L * (lo + hi);
      if (closure(mid, nullptr) > 0.0L) lo = mid;
      else hi = mid;
    }
    long double xl[256];
    long double r = 0.5L * (lo + hi);
    closure(r, xl);
    xl[0] = 0.0L;
    long double v = r * f(r) + tail_area(r);
    for (int i = 0; i < 256; ++i) {
      xs[i] = static_cast<double>(xl[i]);
      A[i] = xs[i];
      F[i] = static_cast<double>(f(xl[i]));
      W[i] = (i < 255) ? static_cast<double>(xl[i + 1])
                       : static_cast<double>(v / f(r));
    }
    A[255] = xs[255];
    invr = 1.0 / xs[255];
    built = true;
  }
};

static Zig g_zig;

static double randn1(MT& mt, const Zig& z, int64_t* edge, int64_t* tail) {
  for (;;) {
    uint32_t wA = mt.next(), wB = mt.next();
    int idx = wB >> 24;
    int64_t U = ((static_cast<int64_t>(wA >> 3) << 24) |
                 static_cast<int64_t>(wB & 0xFFFFFFu)) -
                (1LL << 52);
    double u = static_cast<double>(U) * 0x1p-52;
    double x = u * z.W[idx];
    if (std::fabs(x) <= z.A[idx]) return x;
    if (idx == 255) {
      ++*tail;
      const double r = z.A[255];
      for (;;) {
        double xx = -std::log(mt.rand53()) * z.invr;
        double yy = -std::log(mt.rand53());
        if (yy + yy >= xx * xx) return x > 0 ? r + xx : -(r + xx);
      }
    } else {
      ++*edge;
      double y = mt.rand53();
      if (z.F[idx + 1] + y * (z.F[idx] - z.F[idx + 1]) <
          std::exp(-0.5 * x * x))
        return x;
    }
  }
}

}  // namespace matlab_rng_oracle

extern "C" {

// n randn draws from a fresh twister seeded with `seed` (5489 = MATLAB
// rng("default")); counts[0/1] = edge/tail rejection events.
void matlab_randn_oracle(uint32_t seed, int64_t n, double* out,
                         int64_t* counts) {
  using namespace matlab_rng_oracle;
  g_zig.build();
  MT mt;
  mt.seed(seed);
  counts[0] = counts[1] = 0;
  for (int64_t i = 0; i < n; ++i)
    out[i] = randn1(mt, g_zig, &counts[0], &counts[1]);
}

// n genrand_res53 rand draws (for stream cross-checks).
void matlab_rand_oracle(uint32_t seed, int64_t n, double* out) {
  using namespace matlab_rng_oracle;
  MT mt;
  mt.seed(seed);
  for (int64_t i = 0; i < n; ++i) out[i] = mt.rand53();
}

// Variant with a caller-provided x-table (+ the two derived constants):
// runs the SAME sequential generator + accept/reject structure on an
// externally validated table, so table-rounding noise is excluded and the
// stream bookkeeping itself can be compared bit-exactly.
void matlab_randn_oracle_with_table(uint32_t seed, int64_t n, double* out,
                                    int64_t* counts, const double* xs,
                                    double w255, double invr) {
  using namespace matlab_rng_oracle;
  Zig z;
  for (int i = 0; i < 256; ++i) {
    z.xs[i] = xs[i];
    z.A[i] = xs[i];
    z.F[i] = std::exp(-0.5 * xs[i] * xs[i]);
    z.W[i] = (i < 255) ? xs[i + 1] : w255;
  }
  z.invr = invr;
  z.built = true;
  MT mt;
  mt.seed(seed);
  counts[0] = counts[1] = 0;
  for (int64_t i = 0; i < n; ++i)
    out[i] = randn1(mt, z, &counts[0], &counts[1]);
}

// Export the independently solved ziggurat table: xs[256], and the two
// derived constants (base-strip multiplier v/f(r), 1/r).
void matlab_zig_table(double* xs, double* w255, double* invr) {
  using namespace matlab_rng_oracle;
  g_zig.build();
  std::memcpy(xs, g_zig.xs, 256 * sizeof(double));
  *w255 = g_zig.W[255];
  *invr = g_zig.invr;
}

}  // extern "C"
