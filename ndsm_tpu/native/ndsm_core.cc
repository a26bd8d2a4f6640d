// Native CPU core: OpenMP implementations of the NDSM solver primitives.
//
// This plays the role the Fortran compute core plays in the reference
// (fortran/ndsm_optimized.f90, ndsm_poisson.f90): a shared-memory,
// loop-level implementation of the red-black Gauss-Seidel sweep, the
// Poisson residual, and the coordinate-based transfer operators.  Within
// ndsm_tpu it serves as (a) a fast independent differential-test oracle
// for the XLA kernels and (b) a no-JAX CPU backend.
//
// Array convention: C-ordered (row-major); axis `ndim-1` is the
// fastest-varying axis and corresponds to the reference's Fortran
// dimension 1 ("x").  BCs are passed as 2 chars ('N'/'D') per axis,
// (lower, upper), in axis order.
//
// Written from the algorithm spec in SURVEY.md; not a translation of the
// reference sources.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// 3D red-black Gauss-Seidel sweep (semantics of ndsm_optimized.f90:40):
// two color half-sweeps (first color parity depends on the last axis'
// lower BC), Neumann index reflection, Dirichlet faces frozen, global
// mean subtracted for all-Neumann.
// ---------------------------------------------------------------------
void ndsm_rb_sweep_3d(double* u, const double* rhs, const int64_t* shape,
                      const double* dq, const char* bcs) {
  const int64_t n0 = shape[0], n1 = shape[1], n2 = shape[2];
  const double w0 = 1.0 / (dq[0] * dq[0]);
  const double w1 = 1.0 / (dq[1] * dq[1]);
  const double w2 = 1.0 / (dq[2] * dq[2]);
  const double wd = 1.0 / (2.0 * (w0 + w1 + w2));
  int64_t lo[3] = {0, 0, 0}, hi[3] = {n0 - 1, n1 - 1, n2 - 1};
  for (int ax = 0; ax < 3; ++ax) {
    if (bcs[2 * ax] == 'D') lo[ax] += 1;
    if (bcs[2 * ax + 1] == 'D') hi[ax] -= 1;
  }
  const int red = (bcs[4] == 'N') ? 0 : 1;  // last axis lower BC
  const int64_t s0 = n1 * n2, s1 = n2;

  for (int pass = 0; pass < 2; ++pass) {
    const int parity = pass == 0 ? red : 1 - red;
#pragma omp parallel for schedule(static)
    for (int64_t i0 = lo[0]; i0 <= hi[0]; ++i0) {
      const int64_t i0m = (i0 == 0) ? 1 : i0 - 1;
      const int64_t i0p = (i0 == n0 - 1) ? n0 - 2 : i0 + 1;
      for (int64_t i1 = lo[1]; i1 <= hi[1]; ++i1) {
        const int64_t i1m = (i1 == 0) ? 1 : i1 - 1;
        const int64_t i1p = (i1 == n1 - 1) ? n1 - 2 : i1 + 1;
        const int64_t base = i0 * s0 + i1 * s1;
        int64_t i2 = lo[2] + (((parity - ((i0 + i1 + lo[2]) % 2)) % 2 + 2) % 2);
        for (; i2 <= hi[2]; i2 += 2) {
          const int64_t i2m = (i2 == 0) ? 1 : i2 - 1;
          const int64_t i2p = (i2 == n2 - 1) ? n2 - 2 : i2 + 1;
          const double s = (u[base + i2m] + u[base + i2p]) * w2 +
                           (u[i0 * s0 + i1m * s1 + i2] + u[i0 * s0 + i1p * s1 + i2]) * w1 +
                           (u[i0m * s0 + i1 * s1 + i2] + u[i0p * s0 + i1 * s1 + i2]) * w0;
          u[base + i2] = (s - rhs[base + i2]) * wd;
        }
      }
    }
  }

  bool all_n = true;
  for (int k = 0; k < 6; ++k) all_n = all_n && (bcs[k] == 'N');
  if (all_n) {
    const int64_t n = n0 * n1 * n2;
    double mean = 0.0;
#pragma omp parallel for reduction(+ : mean) schedule(static)
    for (int64_t i = 0; i < n; ++i) mean += u[i];
    mean /= (double)n;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) u[i] -= mean;
  }
}

// ---------------------------------------------------------------------
// 3D Poisson residual r = rhs - L[u], zero on Dirichlet faces
// (semantics of ndsm_optimized.f90:346).
// ---------------------------------------------------------------------
void ndsm_residual_3d(const double* u, const double* rhs, double* r,
                      const int64_t* shape, const double* dq, const char* bcs) {
  const int64_t n0 = shape[0], n1 = shape[1], n2 = shape[2];
  const double w0 = 1.0 / (dq[0] * dq[0]);
  const double w1 = 1.0 / (dq[1] * dq[1]);
  const double w2 = 1.0 / (dq[2] * dq[2]);
  const int64_t s0 = n1 * n2, s1 = n2;
#pragma omp parallel for schedule(static)
  for (int64_t i0 = 0; i0 < n0; ++i0) {
    const bool d0 = (i0 == 0 && bcs[0] == 'D') || (i0 == n0 - 1 && bcs[1] == 'D');
    const int64_t i0m = (i0 == 0) ? 1 : i0 - 1;
    const int64_t i0p = (i0 == n0 - 1) ? n0 - 2 : i0 + 1;
    for (int64_t i1 = 0; i1 < n1; ++i1) {
      const bool d1 = d0 || (i1 == 0 && bcs[2] == 'D') || (i1 == n1 - 1 && bcs[3] == 'D');
      const int64_t i1m = (i1 == 0) ? 1 : i1 - 1;
      const int64_t i1p = (i1 == n1 - 1) ? n1 - 2 : i1 + 1;
      const int64_t base = i0 * s0 + i1 * s1;
      for (int64_t i2 = 0; i2 < n2; ++i2) {
        const bool dd = d1 || (i2 == 0 && bcs[4] == 'D') || (i2 == n2 - 1 && bcs[5] == 'D');
        if (dd) {
          r[base + i2] = 0.0;
          continue;
        }
        const int64_t i2m = (i2 == 0) ? 1 : i2 - 1;
        const int64_t i2p = (i2 == n2 - 1) ? n2 - 2 : i2 + 1;
        const double c = u[base + i2];
        const double lap = (u[base + i2m] - 2.0 * c + u[base + i2p]) * w2 +
                           (u[i0 * s0 + i1m * s1 + i2] - 2.0 * c + u[i0 * s0 + i1p * s1 + i2]) * w1 +
                           (u[i0m * s0 + i1 * s1 + i2] - 2.0 * c + u[i0p * s0 + i1 * s1 + i2]) * w0;
        r[base + i2] = rhs[base + i2] - lap;
      }
    }
  }
}

// ---------------------------------------------------------------------
// Generic N-D red-black sweep with true sum-parity coloring (the
// library's deliberate choice for ndim != 3; coincides with the
// reference's generic rule in 2D — ndsm_poisson.f90:451-549, quirk Q8).
// ---------------------------------------------------------------------
void ndsm_rb_sweep_nd(double* u, const double* rhs, int64_t ndim,
                      const int64_t* shape, const double* dq, const char* bcs) {
  if (ndim < 1 || ndim > 16) return;  // idx[16] scratch below; see lib.py
  std::vector<int64_t> strides(ndim);
  strides[ndim - 1] = 1;
  for (int64_t ax = ndim - 2; ax >= 0; --ax)
    strides[ax] = strides[ax + 1] * shape[ax + 1];
  int64_t n = 1;
  for (int64_t ax = 0; ax < ndim; ++ax) n *= shape[ax];
  std::vector<double> w(ndim);
  double wsum = 0.0;
  for (int64_t ax = 0; ax < ndim; ++ax) {
    w[ax] = 1.0 / (dq[ax] * dq[ax]);
    wsum += w[ax];
  }
  const double wd = 1.0 / (2.0 * wsum);

  for (int parity = 0; parity < 2; ++parity) {
#pragma omp parallel for schedule(static)
    for (int64_t lin = 0; lin < n; ++lin) {
      int64_t rem = lin, psum = 0;
      bool dirichlet = false;
      int64_t idx[16];
      for (int64_t ax = 0; ax < ndim; ++ax) {
        idx[ax] = rem / strides[ax];
        rem -= idx[ax] * strides[ax];
        psum += idx[ax];
        dirichlet = dirichlet || (idx[ax] == 0 && bcs[2 * ax] == 'D') ||
                    (idx[ax] == shape[ax] - 1 && bcs[2 * ax + 1] == 'D');
      }
      if ((psum & 1) != parity || dirichlet) continue;
      double s = 0.0;
      for (int64_t ax = 0; ax < ndim; ++ax) {
        const int64_t im = (idx[ax] == 0) ? 1 : idx[ax] - 1;
        const int64_t ip = (idx[ax] == shape[ax] - 1) ? shape[ax] - 2 : idx[ax] + 1;
        s += (u[lin + (im - idx[ax]) * strides[ax]] +
              u[lin + (ip - idx[ax]) * strides[ax]]) *
             w[ax];
      }
      u[lin] = (s - rhs[lin]) * wd;
    }
  }

  bool all_n = true;
  for (int64_t k = 0; k < 2 * ndim; ++k) all_n = all_n && (bcs[k] == 'N');
  if (all_n) {
    double mean = 0.0;
#pragma omp parallel for reduction(+ : mean) schedule(static)
    for (int64_t i = 0; i < n; ++i) mean += u[i];
    mean /= (double)n;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) u[i] -= mean;
  }
}

// ---------------------------------------------------------------------
// Apply a per-axis matrix along one axis: y[..., i, ...] = sum_j M[i, j]
// x[..., j, ...] — the native form of the separable transfer operators.
// ---------------------------------------------------------------------
void ndsm_apply_axis_matrix(const double* x, double* y, const double* M,
                            int64_t outer, int64_t n_in, int64_t n_out,
                            int64_t inner) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t o = 0; o < outer; ++o) {
    for (int64_t i = 0; i < n_out; ++i) {
      const double* Mi = M + i * n_in;
      double* yo = y + (o * n_out + i) * inner;
      std::memset(yo, 0, sizeof(double) * inner);
      const double* xo = x + o * n_in * inner;
      for (int64_t j = 0; j < n_in; ++j) {
        const double m = Mi[j];
        if (m == 0.0) continue;
        const double* xj = xo + j * inner;
        for (int64_t k = 0; k < inner; ++k) yo[k] += m * xj[k];
      }
    }
  }
}

int ndsm_native_nthreads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
