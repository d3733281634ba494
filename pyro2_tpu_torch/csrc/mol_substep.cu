// mol_substep.cu -- the method-of-lines stage increment k of the
// compressible MOL solvers on Hopper.
//
// Replaces the fused Pallas TPU kernel
// pyro2_tpu/solvers/compressible_fv4/pallas_step.py::make_pallas_mol_substep
// through both of its builders:
//   mol_rk_substep_*  (make_pallas_rk_substep; compressible_rk):
//       density floor, cons -> prim, flattening, MC-limited PLM states
//       (no characteristic tracing), one Riemann pass (HLLC, HLLC_lm or
//       CGF with the solid-face clamps), Colella-Woodward artificial
//       viscosity, the flux divergence, gravity sources and the sponge;
//   mol_fv4_substep_* (make_pallas_fv4_substep; compressible_fv4, and
//       compressible_sdc through it): the McCorquodale-Colella pipeline --
//       averages -> centres with the positivity fallbacks, the 4th-order
//       cell-average primitives, flattening, the limited 4th-order face
//       states blended by the flattening coefficient, CGF on primitive
//       states, face-average <-> face-centre transverse Laplacians, the MC
//       Eq. 35-36 artificial viscosity, the divergence, sources taken at
//       centres and brought back to averages, and the sponge.
// U is the ghost-filled (nvar, qx, qy) state stack; k has its shape and is
// exactly zero on every ghost cell.  Unlike the TPU kernel these entries
// take solid walls (rk) and a positive density floor, both gated on the
// global interior, and any nx, ny.
//
// Layout and windows: as in ctu_step.cu, one thread per frame cell (or per
// interface) with threadIdx.x along y, every window decided by comparing
// the global index -- the TPU's row bands, 8-row halos, 128-aligned rows
// and DMA semaphores have no counterpart.  The shared device code (the
// Riemann solvers, slopes, flattening, cons <-> prim) is euler_common.cuh.
//
// What bounds it on the H100: ~620 (rk) and ~1580 (fv4) floating-point
// operations per zone (mol_kernel.FLOPS_PER_ZONE_BY_STAGE), many of them
// divides and square roots, against 2 nvar values read and written per
// zone: rk sits at the balance point of the fp32 rate and the memory rate
// (bytes bound it, barely), fv4 is bound by the fp32 rate.  This first
// design is simple instead: it stages its intermediates through device
// memory (rk: primitives, flattening, the four interface-state stacks and
// two flux stacks; fv4: two primitive stacks, the 4th-order averages, two
// interface-state stacks and two flux stacks), and the 4th-order face
// states recompute the limiter of each cell for both faces that read it.
// Shared-memory tiles with halos and fused stages are later work;
// chip_smoke.py prints its time beside the bound.
// The scratch is allocated by the wrapper (torch.empty) and nothing is
// allocated here.  The stages run in order on the caller's stream; each
// entry returns the first cudaGetLastError().
//
// Build (see compressible_fv4/mol_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libmol_substep.so mol_substep.cu
// -fmad=false keeps each multiply and add rounded on its own, as the plain
// PyTorch versions round them, so limiter branches do not flip on a fused
// rounding.

#include "euler_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// rk: PLM states, one Riemann pass, divergence
// ---------------------------------------------------------------------------

// store an interface state at (i, j) when it lies in the frame
template <typename T>
__device__ __forceinline__ void store(const Params& p, T* dst, const T* v,
                                      int i, int j) {
  if (i < 0 || i >= p.qx || j < 0 || j >= p.qy) return;
  for (int n = 0; n < p.nvar; ++n) dst[at(p, n, i, j)] = v[n];
}

// rk stage 3: cell (i, j) writes U_xr(i, j), U_xl(i+1, j), U_yr(i, j),
// U_yl(i, j+1): q -+ dq/2 inside the buf=2 window, zero outside it.  Row
// i = 0 / column j = 0 of U_xl / U_yl are zero.
template <typename T>
__global__ void k_rk_states(const T* __restrict__ Q, const T* __restrict__ XI,
                            T* __restrict__ UXL, T* __restrict__ UXR,
                            T* __restrict__ UYL, T* __restrict__ UYR,
                            Params p) {
  CELL_INDEX
  const size_t plane = (size_t)p.qx * p.qy;
  const size_t c = (size_t)i * p.qy + j;
  T ul[MAXVAR], ur[MAXVAR], zero[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) zero[n] = T(0);
  if (i == 0) store(p, UXL, zero, 0, j);
  if (j == 0) store(p, UYL, zero, i, 0);

  if (!inwin(p, i, j, 2, 2, 2, 2)) {
    store(p, UXR, zero, i, j);
    store(p, UXL, zero, i + 1, j);
    store(p, UYR, zero, i, j);
    store(p, UYL, zero, i, j + 1);
    return;
  }

  const T xi = flat_xi(p, Q, XI, i, j);
  T q[MAXVAR], ql[MAXVAR], qr[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) q[n] = Q[n * plane + c];
  for (int d = 1; d <= 2; ++d) {
    const int di = d == 1, dj = d == 2;
    for (int n = 0; n < p.nvar; ++n) {
      const T dq = xi * slope(p, Q + n * plane, i, j, di, dj);
      ql[n] = q[n] + T(0.5) * dq;
      qr[n] = q[n] - T(0.5) * dq;
    }
    prim_to_cons(p, ql, ul);
    prim_to_cons(p, qr, ur);
    if (d == 1) {
      store(p, UXR, ur, i, j);
      store(p, UXL, ul, i + 1, j);
    } else {
      store(p, UYR, ur, i, j);
      store(p, UYL, ul, i, j + 1);
    }
  }
}

// rk stage 4: the Riemann pair and the artificial viscosity on the faces
// the divergence reads: x faces i in [ilo, ihi+1], j in [jlo, jhi]; y faces
// i in [ilo, ihi], j in [jlo, jhi+1]
template <typename T>
__global__ void k_rk_flux(const T* __restrict__ U, const T* __restrict__ Q,
                          const T* __restrict__ UXL,
                          const T* __restrict__ UXR,
                          const T* __restrict__ UYL,
                          const T* __restrict__ UYR, T* __restrict__ FX,
                          T* __restrict__ FY, Params p) {
  CELL_INDEX
  T ul[MAXVAR], ur[MAXVAR], f[MAXVAR];
  if (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) && j <= jhi(p)) {
    for (int n = 0; n < p.nvar; ++n) {
      ul[n] = UXL[at(p, n, i, j)];
      ur[n] = UXR[at(p, n, i, j)];
    }
    riemann(p, 1, ul, ur, i, j, f);
    if (i <= ihi(p)) {
      const T divU = T(0.5) * (vertex_div(p, Q, i, j) +
                               vertex_div(p, Q, i, j + 1));
      const T av = T(p.cvisc) * fmax(-divU * T(p.dx), T(0));
      for (int n = 0; n < p.nvar; ++n)
        f[n] = f[n] + av * (ldU(U, p, n, i - 1, j) - ldU(U, p, n, i, j));
    }
    for (int n = 0; n < p.nvar; ++n) FX[at(p, n, i, j)] = f[n];
  }
  if (i >= ilo(p) && i <= ihi(p) && j >= jlo(p) && j <= jhi(p) + 1) {
    for (int n = 0; n < p.nvar; ++n) {
      ul[n] = UYL[at(p, n, i, j)];
      ur[n] = UYR[at(p, n, i, j)];
    }
    riemann(p, 2, ul, ur, i, j, f);
    if (j <= jhi(p)) {
      const T divU = T(0.5) * (vertex_div(p, Q, i, j) +
                               vertex_div(p, Q, i + 1, j));
      const T av = T(p.cvisc) * fmax(-divU * T(p.dy), T(0));
      for (int n = 0; n < p.nvar; ++n)
        f[n] = f[n] + av * (ldU(U, p, n, i, j - 1) - ldU(U, p, n, i, j));
    }
    for (int n = 0; n < p.nvar; ++n) FY[at(p, n, i, j)] = f[n];
  }
}

// the sponge terms of k at an interior cell, from the floored state
template <typename T>
__device__ __forceinline__ void add_sponge(const Params& p,
                                           const T* __restrict__ U, int i,
                                           int j, T* k) {
  const T rho = ldU(U, p, p.idens, i, j);
  const T kf = sponge_rate(p, rho);
  const T mx = ldU(U, p, p.ixmom, i, j);
  const T my = ldU(U, p, p.iymom, i, j);
  k[p.ixmom] = k[p.ixmom] + -kf * mx;
  k[p.iymom] = k[p.iymom] + -kf * my;
  k[p.iener] = k[p.iener] + -kf * (mx * mx / rho + my * my / rho);
}

// the flux divergence of an interior cell
template <typename T>
__device__ __forceinline__ void divergence(const Params& p,
                                           const T* __restrict__ FX,
                                           const T* __restrict__ FY, int i,
                                           int j, T* k) {
  for (int n = 0; n < p.nvar; ++n)
    k[n] = (FX[at(p, n, i, j)] - FX[at(p, n, i + 1, j)]) / T(p.dx) +
           (FY[at(p, n, i, j)] - FY[at(p, n, i, j + 1)]) / T(p.dy);
}

// rk stage 5: k = divergence + gravity sources (+ sponge) on the
// interior, exactly zero on the ghosts
template <typename T>
__global__ void k_rk_update(const T* __restrict__ U, const T* __restrict__ FX,
                            const T* __restrict__ FY, T* __restrict__ K,
                            Params p) {
  CELL_INDEX
  T k[MAXVAR];
  if (!inwin(p, i, j, 0, 0, 0, 0)) {
    for (int n = 0; n < p.nvar; ++n) K[at(p, n, i, j)] = T(0);
    return;
  }
  divergence(p, FX, FY, i, j, k);
  const T grav = T(p.grav);
  k[p.iymom] = k[p.iymom] + ldU(U, p, p.idens, i, j) * grav;
  k[p.iener] = k[p.iener] + ldU(U, p, p.iymom, i, j) * grav;
  if (p.do_sponge) add_sponge(p, U, i, j, k);
  for (int n = 0; n < p.nvar; ++n) K[at(p, n, i, j)] = k[n];
}

// ---------------------------------------------------------------------------
// fv4: the McCorquodale-Colella pipeline
// ---------------------------------------------------------------------------

// the 5-point Laplacian of a plane at (i, j), in the plain version's order
template <typename T, typename F>
__device__ __forceinline__ T lap5(const Params& p, F v, int i, int j) {
  const T c = v(i, j);
  return (v(i - 1, j) - T(2) * c + v(i + 1, j)) / T(p.dx2) +
         (v(i, j - 1) - T(2) * c + v(i, j + 1)) / T(p.dy2);
}

// fv4 stage 1, every frame cell: the cell-centre state of the floored
// averages (the buf=ng-1 window converted, the outer ring copied), the
// centred gravity sources SC of that state, the fallback to the averages
// where the centre is unphysical, and the primitives Q of the averages and
// QC of the (fallback) centres
template <typename T>
__global__ void k_fv4_prim(const T* __restrict__ U, T* __restrict__ Q,
                           T* __restrict__ QC, T* __restrict__ SC,
                           Params p) {
  CELL_INDEX
  T ua[MAXVAR], uc[MAXVAR], q[MAXVAR];
  const bool w = inwin(p, i, j, p.ng - 1, p.ng - 1, p.ng - 1, p.ng - 1);
  for (int n = 0; n < p.nvar; ++n) {
    ua[n] = ldU(U, p, n, i, j);
    uc[n] = ua[n];
    if (w) {
      auto v = [&](int a, int b) { return ldU(U, p, n, a, b); };
      uc[n] = ua[n] - T(p.dx2) * lap5<T>(p, v, i, j) / T(24);
    }
  }
  const T grav = T(p.grav);
  SC[at(p, 0, i, j)] = uc[p.idens] * grav;
  SC[at(p, 1, i, j)] = uc[p.iymom] * grav;

  const T rhoe = uc[p.iener] - T(0.5) *
                                   (uc[p.ixmom] * uc[p.ixmom] +
                                    uc[p.iymom] * uc[p.iymom]) /
                                   uc[p.idens];
  if (uc[p.idens] < T(0) || rhoe < T(0))
    for (int n = 0; n < p.nvar; ++n) uc[n] = ua[n];

  cons_to_prim(p, ua, q);
  for (int n = 0; n < p.nvar; ++n) Q[at(p, n, i, j)] = q[n];
  cons_to_prim(p, uc, q);
  for (int n = 0; n < p.nvar; ++n) QC[at(p, n, i, j)] = q[n];
}

// fv4 stage 3: the 4th-order cell-average primitives q_avg = q_cc +
// dx^2/24 lap(q_bar) on the buf=3 window with the rho / p positivity
// fallback to q_cc, zero outside the window
template <typename T>
__global__ void k_fv4_qavg(const T* __restrict__ Q, const T* __restrict__ QC,
                           T* __restrict__ QA, Params p) {
  CELL_INDEX
  const bool w = inwin(p, i, j, 3, 3, 3, 3);
  for (int n = 0; n < p.nvar; ++n) {
    T qa = T(0);
    if (w) {
      const T* qb = Q + (size_t)n * p.qx * p.qy;
      auto v = [&](int a, int b) { return qb[(size_t)a * p.qy + b]; };
      const T qc = QC[at(p, n, i, j)];
      qa = qc + T(p.dx2_24) * lap5<T>(p, v, i, j);
      if (n == IRHO || n == IP) qa = qa > T(0) ? qa : qc;
    }
    QA[at(p, n, i, j)] = qa;
  }
}

constexpr double C2 = 1.25;
constexpr double C3 = 0.1;

// copysign(1, x) with copysign(1, 0) == +1
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x >= T(0) ? T(1) : T(-1);
}

// The limited 4th-order states of one plane A (q_avg of one primitive,
// zero outside the buf=3 window) along direction d at a cell (i, j) of the
// m_W box (along d [lo-1, hi+1], across [lo-1, hi+1]): the right state
// ar_cell, which is ar at the cell's lower face, or the left state
// al_cell, which is al at its upper face.  The region masks are those of
// fourth_order.states: outside them a_int, d2ac and d3a are zero, and d3a
// reaches hi+3 along x but hi+2 along y.
template <typename T>
__device__ T fo_state(const Params& p, const T* __restrict__ A, int i, int j,
                      int d, bool left) {
  const int ax = d == 1 ? i : j;             // index along d
  const int tr = d == 1 ? j : i;             // index across d
  const int hi_a = d == 1 ? ihi(p) : jhi(p);
  const int hi_t = d == 1 ? jhi(p) : ihi(p);
  const int lo = p.ng;
  const bool across = tr >= lo - 1 && tr <= hi_t + 1;
  const ptrdiff_t s = d == 1 ? (ptrdiff_t)p.qy : 1;
  const T* a0p = A + (size_t)i * p.qy + j;
  auto a = [&](int k) { return a0p[k * s]; };
  auto box = [&](int k, int lo_off, int hi_off) {
    return across && ax + k >= lo + lo_off && ax + k <= hi_a + hi_off;
  };
  auto a_int = [&](int k) {
    return box(k, -2, 3) ? T(7.0 / 12.0) * (a(k - 1) + a(k)) -
                               T(1.0 / 12.0) * (a(k - 2) + a(k + 1))
                         : T(0);
  };
  auto d2ac = [&](int k) {
    return box(k, -3, 3) ? a(k - 1) - T(2) * a(k) + a(k + 1) : T(0);
  };
  const int d3a_hi = d == 1 ? 3 : 2;
  auto d3a = [&](int k) {
    return box(k, -2, d3a_hi) ? d2ac(k) - d2ac(k - 1) : T(0);
  };

  const T a0 = a(0);
  const bool m_int = box(0, -2, 3);
  const T ai0 = a_int(0), ai1 = a_int(1);
  const T dafm = m_int ? a0 - ai0 : T(0);
  const T dafp = m_int ? ai1 - a0 : T(0);
  const T d2af = m_int ? T(6) * (ai0 - T(2) * a0 + ai1) : T(0);
  const T d2acm = d2ac(-1), d2ac0 = d2ac(0), d2acp = d2ac(1);

  const bool extrema = (dafm * dafp <= T(0)) ||
                       ((a0 - a(-2)) * (a(2) - a0) <= T(0));

  const T sg = sgn(d2ac0);
  const bool samesign =
      sg == sgn(d2acm) && sg == sgn(d2acp) && sg == sgn(d2af);
  const T d2a_lim =
      samesign ? sg * fmin(fabs(d2af),
                           T(C2) * fmin(fabs(d2acm),
                                        fmin(fabs(d2ac0), fabs(d2acp))))
               : T(0);

  const T maxa = fmax(fmax(fabs(a(-2)), fabs(a(-1))),
                      fmax(fabs(a0), fmax(fabs(a(1)), fabs(a(2)))));
  const bool tiny = fabs(d2af) <= T(1.e-12) * maxa;
  const T rho = tiny ? T(0) : d2a_lim / (d2af == T(0) ? T(1) : d2af);

  const T d3m = d3a(-1), d30 = d3a(0), d3p = d3a(1), d3pp = d3a(2);
  const T d3a_min = fmin(fmin(d3m, d30), fmin(d3p, d3pp));
  const T d3a_max = fmax(fmax(d3m, d30), fmax(d3p, d3pp));
  const bool dolim =
      (rho < T(1.0 - 1.e-12)) &&
      (T(C3) * fmax(fabs(d3a_min), fabs(d3a_max)) <= d3a_max - d3a_min);

  const bool case1 = dafm * dafp < T(0);
  const bool case2 = !case1 && (fabs(dafm) >= T(2) * fabs(dafp));
  const bool case3 =
      !case1 && !case2 && (fabs(dafp) >= T(2) * fabs(dafm));

  if (!left) {
    // ar_cell: ar defaults to a_int at the cell
    const T ar_lim = case1   ? a0 - rho * dafm
                     : case2 ? a0 - T(2) * (T(1) - rho) * dafp - rho * dafm
                             : ai0;
    const T ar_ne = fabs(dafm) >= T(2) * fabs(dafp) ? a0 - T(2) * dafp : ai0;
    return extrema ? (dolim ? ar_lim : ai0) : ar_ne;
  }
  // al_cell: al defaults to a_int one cell up (al_up)
  const T al_lim = case1   ? a0 + rho * dafp
                   : case3 ? a0 + T(2) * (T(1) - rho) * dafm + rho * dafp
                           : ai1;
  const T al_ne = fabs(dafp) >= T(2) * fabs(dafm) ? a0 + T(2) * dafm : ai1;
  return extrema ? (dolim ? al_lim : ai1) : al_ne;
}

// is (i, j) in fourth_order.states' box [lo+lo_off, hi+hi_off] along d
// and [lo-1, hi+1] across it?
__device__ __forceinline__ bool fo_box(const Params& p, int i, int j, int d,
                                       int lo_off, int hi_off) {
  const int ax = d == 1 ? i : j, tr = d == 1 ? j : i;
  const int hi_a = d == 1 ? ihi(p) : jhi(p);
  const int hi_t = d == 1 ? jhi(p) : ihi(p);
  return tr >= p.ng - 1 && tr <= hi_t + 1 && ax >= p.ng + lo_off &&
         ax <= hi_a + hi_off;
}

// fv4 stage 4: per face normal to d, the limited 4th-order left and right
// states of every primitive, blended toward q_avg by the flattening
// coefficient -- the right state by the face's cell, the left state by the
// cell below it -- then CGF on primitive states.  x faces i in
// [ilo, ihi+1], j in [jlo-1, jhi+1]; y faces the transpose.  The
// transverse Laplacians of stage 5 read exactly these.
template <typename T>
__global__ void k_fv4_faces(const T* __restrict__ QA, const T* __restrict__ Q,
                            const T* __restrict__ XI, T* __restrict__ QIX,
                            T* __restrict__ QIY, Params p) {
  CELL_INDEX
  const size_t plane = (size_t)p.qx * p.qy;
  T ql[MAXVAR], qr[MAXVAR], qi[MAXVAR];
  for (int d = 1; d <= 2; ++d) {
    const bool face =
        d == 1 ? (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) - 1 &&
                  j <= jhi(p) + 1)
               : (j >= jlo(p) && j <= jhi(p) + 1 && i >= ilo(p) - 1 &&
                  i <= ihi(p) + 1);
    if (!face) continue;
    const int il = d == 1 ? i - 1 : i, jl = d == 1 ? j : j - 1;
    // the faces lie inside the buf=2 window on both sides, where the
    // blend applies, and inside the m_W / m_W_up boxes, where the
    // limited states replace a_int
    const T xi_r = flat_xi(p, Q, XI, i, j);
    const T xi_l = flat_xi(p, Q, XI, il, jl);
    for (int n = 0; n < p.nvar; ++n) {
      const T* A = QA + n * plane;
      const T ar = fo_state(p, A, i, j, d, false);
      const T al = fo_state(p, A, il, jl, d, true);
      qr[n] = xi_r * ar + (T(1) - xi_r) * A[(size_t)i * p.qy + j];
      ql[n] = xi_l * al + (T(1) - xi_l) * A[(size_t)il * p.qy + jl];
    }
    cgf_prim(p, d, ql, qr, qi);
    T* QI = d == 1 ? QIX : QIY;
    for (int n = 0; n < p.nvar; ++n) QI[at(p, n, i, j)] = qi[n];
  }
}

// the analytic conserved flux of a primitive state (flux_cons)
template <typename T>
__device__ __forceinline__ void flux_cons(const Params& p, int idir,
                                          const T* q, T* F) {
  const T rho = q[IRHO], u = q[IU], v = q[IV], pr = q[IP];
  const T un = idir == 1 ? u : v;
  F[p.idens] = rho * un;
  if (idir == 1) {
    F[p.ixmom] = rho * (u * u) + pr;
    F[p.iymom] = rho * v * u;
  } else {
    F[p.ixmom] = rho * u * v;
    F[p.iymom] = rho * (v * v) + pr;
  }
  F[p.iener] =
      (pr / T(p.gamma - 1.0) + T(0.5) * rho * (u * u + v * v) + pr) * un;
  for (int n = 4; n < p.nvar; ++n) F[n] = rho * q[n] * un;
}

// fv4 stage 5: per face that the divergence reads (x faces i in [ilo,
// ihi+1], j in [jlo, jhi]; y faces the transpose): face average -> face
// centre, F = F(q_fc) + lap_perp F(q_avg) / 24, plus the MC Eq. 35-36
// artificial viscosity
template <typename T>
__global__ void k_fv4_flux(const T* __restrict__ U, const T* __restrict__ Q,
                           const T* __restrict__ QIX,
                           const T* __restrict__ QIY, T* __restrict__ FX,
                           T* __restrict__ FY, Params p) {
  CELL_INDEX
  const size_t plane = (size_t)p.qx * p.qy;
  T qm[MAXVAR], q0[MAXVAR], qp[MAXVAR], qfc[MAXVAR];
  T fm[MAXVAR], f0[MAXVAR], fp[MAXVAR], F[MAXVAR];
  const T c24 = T(1.0 / 24.0);
  for (int d = 1; d <= 2; ++d) {
    const bool face =
        d == 1 ? (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) &&
                  j <= jhi(p))
               : (j >= jlo(p) && j <= jhi(p) + 1 && i >= ilo(p) &&
                  i <= ihi(p));
    if (!face) continue;
    const T* QI = d == 1 ? QIX : QIY;
    // the transverse neighbours
    const int ti = d == 1 ? 0 : 1, tj = d == 1 ? 1 : 0;
    for (int n = 0; n < p.nvar; ++n) {
      qm[n] = QI[at(p, n, i - ti, j - tj)];
      q0[n] = QI[at(p, n, i, j)];
      qp[n] = QI[at(p, n, i + ti, j + tj)];
      qfc[n] = q0[n] - c24 * (qp[n] - 2 * q0[n] + qm[n]);
    }
    flux_cons(p, d, qfc, F);
    flux_cons(p, d, qm, fm);
    flux_cons(p, d, q0, f0);
    flux_cons(p, d, qp, fp);

    // the artificial viscosity from the average primitives q_bar
    const T* u = Q + (size_t)IU * plane;
    const T* v = Q + (size_t)IV * plane;
    auto at2 = [&](const T* a, int a_i, int a_j) {
      return a[(size_t)a_i * p.qy + a_j];
    };
    T lam;
    if (d == 1)
      lam = (at2(u, i, j) - at2(u, i - 1, j)) / T(p.dx) +
            T(0.25) *
                (at2(v, i, j + 1) - at2(v, i, j - 1) + at2(v, i - 1, j + 1) -
                 at2(v, i - 1, j - 1)) /
                T(p.dy);
    else
      lam = (at2(v, i, j) - at2(v, i, j - 1)) / T(p.dy) +
            T(0.25) *
                (at2(u, i + 1, j) - at2(u, i - 1, j) + at2(u, i + 1, j - 1) -
                 at2(u, i - 1, j - 1)) /
                T(p.dx);
    const T dxl = T(p.dx) * lam;
    const T test = dxl * dxl / (T(p.beta_gamma) * Q[at(p, IP, i, j)] /
                                Q[at(p, IRHO, i, j)]);
    T nu = T(p.dx) * lam * fmin(test, T(1));
    nu = lam >= T(0) ? T(0) : nu;
    const T anu = T(p.alpha) * nu;

    T* FO = d == 1 ? FX : FY;
    for (int n = 0; n < p.nvar; ++n) {
      const T du = d == 1 ? ldU(U, p, n, i, j) - ldU(U, p, n, i - 1, j)
                          : ldU(U, p, n, i, j) - ldU(U, p, n, i, j - 1);
      FO[at(p, n, i, j)] =
          F[n] + c24 * (fp[n] - 2 * f0[n] + fm[n]) + anu * du;
    }
  }
}

// fv4 stage 6: k = divergence + sources brought back to averages
// (S + (-dx^2) lap(S) / 24, S the centred gravity sources) (+ sponge) on
// the interior, exactly zero on the ghosts
template <typename T>
__global__ void k_fv4_update(const T* __restrict__ U, const T* __restrict__ SC,
                             const T* __restrict__ FX,
                             const T* __restrict__ FY, T* __restrict__ K,
                             Params p) {
  CELL_INDEX
  T k[MAXVAR];
  if (!inwin(p, i, j, 0, 0, 0, 0)) {
    for (int n = 0; n < p.nvar; ++n) K[at(p, n, i, j)] = T(0);
    return;
  }
  divergence(p, FX, FY, i, j, k);
  for (int r = 0; r < 2; ++r) {
    const T* S = SC + (size_t)r * p.qx * p.qy;
    auto v = [&](int a, int b) { return S[(size_t)a * p.qy + b]; };
    const T s_avg = v(i, j) + T(p.mdx2) * lap5<T>(p, v, i, j) / T(24);
    const int n = r == 0 ? p.iymom : p.iener;
    k[n] = k[n] + s_avg;
  }
  if (p.do_sponge) add_sponge(p, U, i, j, k);
  for (int n = 0; n < p.nvar; ++n) K[at(p, n, i, j)] = k[n];
}

// ---------------------------------------------------------------------------
// entries
// ---------------------------------------------------------------------------

int check_params(const Params& p) {
  if (p.nvar < 4 || p.nvar > MAXVAR || p.ng != 4 || p.nx < 1 || p.ny < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int run_rk(const T* U, T* K, T* scratch, const int* ip, const double* dp,
           cudaStream_t st) {
  const Params p = load_params(ip, dp, true);
  if (int e = check_params(p)) return e;
  const size_t plane = (size_t)p.qx * p.qy;
  const size_t stack = (size_t)p.nvar * plane;
  T* Q = scratch;
  T* XI = Q + stack;
  T* UXL = XI + 2 * plane;
  T* UXR = UXL + stack;
  T* UYL = UXR + stack;
  T* UYR = UYL + stack;
  T* FX = UYR + stack;
  T* FY = FX + stack;

  const dim3 blk(64, 4);
  const dim3 grd((p.qy + blk.x - 1) / blk.x, (p.qx + blk.y - 1) / blk.y);
  k_prim<T><<<grd, blk, 0, st>>>(U, Q, p);
  LAUNCH_CHECK;
  if (p.flatten) {
    k_flatten<T><<<grd, blk, 0, st>>>(Q, XI, p);
    LAUNCH_CHECK;
  }
  k_rk_states<T><<<grd, blk, 0, st>>>(Q, XI, UXL, UXR, UYL, UYR, p);
  LAUNCH_CHECK;
  k_rk_flux<T><<<grd, blk, 0, st>>>(U, Q, UXL, UXR, UYL, UYR, FX, FY, p);
  LAUNCH_CHECK;
  k_rk_update<T><<<grd, blk, 0, st>>>(U, FX, FY, K, p);
  LAUNCH_CHECK;
  return 0;
}

template <typename T>
int run_fv4(const T* U, T* K, T* scratch, const int* ip, const double* dp,
            cudaStream_t st) {
  const Params p = load_params(ip, dp, true);
  if (int e = check_params(p)) return e;
  const size_t plane = (size_t)p.qx * p.qy;
  const size_t stack = (size_t)p.nvar * plane;
  T* Q = scratch;
  T* QC = Q + stack;
  T* QA = QC + stack;
  T* QIX = QA + stack;
  T* QIY = QIX + stack;
  T* FX = QIY + stack;
  T* FY = FX + stack;
  T* XI = FY + stack;
  T* SC = XI + 2 * plane;

  const dim3 blk(64, 4);
  const dim3 grd((p.qy + blk.x - 1) / blk.x, (p.qx + blk.y - 1) / blk.y);
  k_fv4_prim<T><<<grd, blk, 0, st>>>(U, Q, QC, SC, p);
  LAUNCH_CHECK;
  if (p.flatten) {
    k_flatten<T><<<grd, blk, 0, st>>>(Q, XI, p);
    LAUNCH_CHECK;
  }
  k_fv4_qavg<T><<<grd, blk, 0, st>>>(Q, QC, QA, p);
  LAUNCH_CHECK;
  k_fv4_faces<T><<<grd, blk, 0, st>>>(QA, Q, XI, QIX, QIY, p);
  LAUNCH_CHECK;
  k_fv4_flux<T><<<grd, blk, 0, st>>>(U, Q, QIX, QIY, FX, FY, p);
  LAUNCH_CHECK;
  k_fv4_update<T><<<grd, blk, 0, st>>>(U, SC, FX, FY, K, p);
  LAUNCH_CHECK;
  return 0;
}

}  // namespace

// scratch planes of (qx, qy) in the state's dtype: kind 0 (rk) 7 nvar + 2,
// kind 1 (fv4) 7 nvar + 4
extern "C" int mol_scratch_planes(int kind, int nvar) {
  return kind == 0 ? 7 * nvar + 2 : 7 * nvar + 4;
}

extern "C" int mol_rk_substep_f32(const float* U, float* K, float* scratch,
                                  const int* ip, const double* dp,
                                  void* stream) {
  return run_rk<float>(U, K, scratch, ip, dp, (cudaStream_t)stream);
}

extern "C" int mol_rk_substep_f64(const double* U, double* K,
                                  double* scratch, const int* ip,
                                  const double* dp, void* stream) {
  return run_rk<double>(U, K, scratch, ip, dp, (cudaStream_t)stream);
}

extern "C" int mol_fv4_substep_f32(const float* U, float* K, float* scratch,
                                   const int* ip, const double* dp,
                                   void* stream) {
  return run_fv4<float>(U, K, scratch, ip, dp, (cudaStream_t)stream);
}

extern "C" int mol_fv4_substep_f64(const double* U, double* K,
                                   double* scratch, const int* ip,
                                   const double* dp, void* stream) {
  return run_fv4<double>(U, K, scratch, ip, dp, (cudaStream_t)stream);
}
