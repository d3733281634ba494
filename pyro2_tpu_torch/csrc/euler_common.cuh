// euler_common.cuh -- device code shared by the compressible kernels
// (ctu_step.cu and mol_substep.cu): the parameter block, the density floor
// on the global interior, the Riemann solvers (HLLC, HLLC_lm, CGF on
// conserved and on primitive states, with the solid-face clamps), cons <->
// prim, the flattening coefficients and the vertex divergence of the
// artificial viscosity.  Indexing, window tests, the boxes of a tile in
// shared memory and the MC slopes come from grid_common.cuh, which
// swe_step.cu shares.  Everything sits in an anonymous namespace: each
// source that includes it compiles its own copy.
//
// The arithmetic follows the plain PyTorch versions operation by operation
// (compile with -fmad=false), so the kernels agree with them to the last
// bits the order of operations allows.
//
// Every per-cell helper is a template over the parameter block P and reads
// the variable count and indices as p.nvar, p.idens, ...: the fused kernels
// (ctu_step.cu, mol_substep.cu's rk and fv4 kernels) pass FixedParams,
// which fixes them at compile time, so their per-variable arrays are
// indexed by constants and stay in registers.  The stencil helpers read
// their planes through views a(i, j) (grid_common.cuh's BoxPlane for a
// tile's box in shared memory).

#pragma once

#include "grid_common.cuh"

namespace {

struct Params {
  int nvar, nx, ny, ng, qx, qy;
  int idens, ixmom, iymom, iener;
  int riemann;  // 0 HLLC, 1 HLLC_lm, 2 CGF
  int limiter;  // 0 none, 1 2nd-order MC, otherwise 4th-order MC
  int flatten, with_sources, do_sponge, has_floor;
  int solid_xl, solid_xr, solid_yl, solid_yr;
  // the domain-edge flags of the CTU step's and the rk stage's artificial
  // viscosity: 1 where the frame's edge is the domain's boundary (no
  // viscosity on its high face), 0 on a sharded block's seam (the face
  // takes it from the halo)
  int edge_xl, edge_xr, edge_yl, edge_yr;
  int spherical;  // SphericalPolar geometry
  // a problem's energy source rho e_rate w(x, y), w a plane in device
  // memory (every entry but the batched one)
  int problem;
  // the hydrostatic-subtracted y slope of the pressure (the rk
  // stage increment only)
  int well_balanced;
  // a batch of independent states (the CTU step's batched entry): member
  // blockIdx.z starts mstride elements into the state stacks; 0 for a
  // single state
  size_t mstride;
  double dx, dy, dt, gamma, z0, z1, delta, cvisc, floor, grav;
  double rho_begin, rho_full, tau;
  double e_rate;
  // method-of-lines constants, rounded on the host as the plain versions'
  // Python floats are: dx^2, dy^2, dx^2/24, -dx^2, and the fv4 artificial
  // viscosity's alpha and beta * gamma
  double dx2, dy2, dx2_24, mdx2, alpha, beta_gamma;
};

// the parameter block with the variables fixed at compile time: NV of them,
// density, energy, x-momentum and y-momentum first (the order in which the
// compressible solvers register them; the wrappers check it), so the
// kernels' per-variable arrays are indexed by constants and stay in
// registers
template <int NV>
struct FixedParams : Params {
  static constexpr int nvar = NV, idens = 0, iener = 1, ixmom = 2, iymom = 3;
};

// primitive order: rho, u, v, p, then the passive scalars
constexpr int IRHO = 0, IU = 1, IV = 2, IP = 3;

constexpr double SMALLC = 1.e-10;
constexpr double SMALLRHO = 1.e-10;
constexpr double SMALLP = 1.e-10;
constexpr double PI = 3.141592653589793;

// the state with the density floor applied on the global interior
template <typename T, typename P>
__device__ __forceinline__ T ldU(const T* __restrict__ U, const P& p,
                                 int n, int i, int j) {
  T v = U[at(p, n, i, j)];
  if (p.has_floor && n == p.idens && inwin(p, i, j, 0, 0, 0, 0))
    v = fmax(v, (T)p.floor);
  return v;
}

// ---------------------------------------------------------------------------
// Riemann solvers on one interface: Ul, Ur conserved states -> flux F
// ---------------------------------------------------------------------------

template <typename T>
struct Side {
  T rho, un, ut, rhoe, p;
};

template <typename T, typename P>
__device__ __forceinline__ Side<T> decompose(const P& p, int idir,
                                             const T* U) {
  Side<T> s;
  const int in = idir == 1 ? p.ixmom : p.iymom;
  const int it = idir == 1 ? p.iymom : p.ixmom;
  s.rho = U[p.idens];
  s.un = U[in] / s.rho;
  s.ut = U[it] / s.rho;
  s.rhoe = U[p.iener] - T(0.5) * s.rho * (s.un * s.un + s.ut * s.ut);
  s.p = fmax(s.rhoe * T(p.gamma - 1.0), T(SMALLP));
  return s;
}

// the flux of a conserved state; without the pressure term in the normal
// momentum when sph is set (CGF's interface state in spherical geometry;
// the HLLC solvers always take the Cartesian flux, as in JAX)
template <typename T, typename P>
__device__ __forceinline__ void cons_flux(const P& p, int idir, const T* U,
                                          T* F, bool sph) {
  const T rho = U[p.idens];
  const bool nz = rho != T(0);
  const T safe = nz ? rho : T(1);
  const T u = nz ? U[p.ixmom] / safe : T(0);
  const T v = nz ? U[p.iymom] / safe : T(0);
  const T pr = (U[p.iener] - T(0.5) * rho * (u * u + v * v)) *
               T(p.gamma - 1.0);
  const T vel = idir == 1 ? u : v;
  F[p.idens] = rho * vel;
  F[p.ixmom] = U[p.ixmom] * vel;
  F[p.iymom] = U[p.iymom] * vel;
  // pressure joins the normal-momentum flux only in Cartesian geometry
  if (!sph) {
    if (idir == 1)
      F[p.ixmom] = F[p.ixmom] + pr;
    else
      F[p.iymom] = F[p.iymom] + pr;
  }
  F[p.iener] = (U[p.iener] + pr) * vel;
  for (int n = 4; n < p.nvar; ++n) F[n] = U[n] * vel;
}

template <typename T, typename P>
__device__ __forceinline__ void wave_speeds(const P& p, T rho_l, T u_l,
                                            T p_l, T c_l, T rho_r, T u_r,
                                            T p_r, T c_r, T& S_l, T& S_r) {
  const double g = p.gamma;
  const T p_max = fmax(p_l, p_r);
  const T p_min = fmin(p_l, p_r);
  const T Q = p_max / p_min;

  const T rho_avg = T(0.5) * (rho_l + rho_r);
  const T c_avg = T(0.5) * (c_l + c_r);
  const T factor = rho_avg * c_avg;
  const T pstar0 = T(0.5) * (p_l + p_r) + T(0.5) * (u_l - u_r) * factor;

  const bool upgrade = (Q > T(2)) && ((pstar0 < p_min) || (pstar0 > p_max));
  T pstar = pstar0;
  if (upgrade && pstar0 < p_min) {
    // 2-rarefaction estimate
    const double z = (g - 1.0) / (2.0 * g);
    const T p_lr = pow(p_l / p_r, T(z));
    const T ustar_2r = (p_lr * u_l / c_l + u_r / c_r +
                        T(2) * (p_lr - T(1)) / T(g - 1.0)) /
                       (p_lr / c_l + T(1) / c_r);
    pstar = T(0.5) *
            (p_l * pow(T(1) + T(g - 1.0) * (u_l - ustar_2r) / (T(2) * c_l),
                       T(1.0 / z)) +
             p_r * pow(T(1) + T(g - 1.0) * (ustar_2r - u_r) / (T(2) * c_r),
                       T(1.0 / z)));
  } else if (upgrade) {
    // 2-shock estimate
    const T A_r = T(2) / (T(g + 1.0) * rho_r);
    const T B_r = p_r * T(g - 1.0) / T(g + 1.0);
    const T A_l = T(2) / (T(g + 1.0) * rho_l);
    const T B_l = p_l * T(g - 1.0) / T(g + 1.0);
    const T p_guess = fmax(T(0), pstar0);
    const T g_l = sqrt(A_l / (p_guess + B_l));
    const T g_r = sqrt(A_r / (p_guess + B_r));
    pstar = (g_l * p_l + g_r * p_r - (u_r - u_l)) / (g_l + g_r);
  }

  S_l = pstar <= p_l
            ? u_l - c_l
            : u_l - c_l * sqrt(T(1) + T((g + 1.0) / (2.0 * g)) *
                                          (pstar / p_l - T(1)));
  // (gamma + 1) / (2 / gamma), as the JAX package and upstream pyro2 write it
  S_r = pstar <= p_r
            ? u_r + c_r
            : u_r + c_r * sqrt(T(1) + T((g + 1.0) / (2.0 / g)) *
                                          (pstar / p_r - T(1)));
}

template <typename T, typename P>
__device__ __forceinline__ void hllc(const P& p, int idir, const T* Ul,
                                     const T* Ur, T* F) {
  const Side<T> L = decompose<T>(p, idir, Ul);
  const Side<T> R = decompose<T>(p, idir, Ur);
  const T g = T(p.gamma);
  const T c_l = fmax(T(SMALLC), sqrt(g * L.p / L.rho));
  const T c_r = fmax(T(SMALLC), sqrt(g * R.p / R.rho));
  T S_l, S_r;
  wave_speeds(p, L.rho, L.un, L.p, c_l, R.rho, R.un, R.p, c_r, S_l, S_r);
  const T S_c = (R.p - L.p + L.rho * L.un * (S_l - L.un) -
                 R.rho * R.un * (S_r - R.un)) /
                (L.rho * (S_l - L.un) - R.rho * (S_r - R.un));

  const int in = idir == 1 ? p.ixmom : p.iymom;
  const int it = idir == 1 ? p.iymom : p.ixmom;

  // region select, then only the flux that region needs
  int region;  // 0: F_r, 1: F*_r, 2: F*_l, 3: F_l
  if (S_r <= T(0))
    region = 0;
  else if (S_c <= T(0) && S_r > T(0))
    region = 1;
  else if (S_l < T(0) && S_c > T(0))
    region = 2;
  else
    region = 3;

  // the side's state, chosen value by value (a choice between the two
  // arrays themselves would put both in local memory)
  const bool right = region <= 1;
  T U[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) U[n] = right ? Ur[n] : Ul[n];
  const Side<T> s = right ? R : L;
  cons_flux(p, idir, U, F, false);
  if (region == 0 || region == 3) return;

  const T S = right ? S_r : S_l;
  if (p.riemann == 0) {
    // HLLC star state: F* = F + S (U* - U)
    T Us[MAXVAR];
    const T f = s.rho * (S - s.un) / (S - S_c);
    Us[p.idens] = f;
    Us[in] = f * S_c;
    Us[it] = f * s.ut;
    Us[p.iener] = f * (U[p.iener] / s.rho +
                       (S_c - s.un) * (S_c + s.p / (s.rho * (S - s.un))));
    for (int n = 4; n < p.nvar; ++n) Us[n] = f * U[n] / s.rho;
    for (int n = 0; n < p.nvar; ++n) F[n] = F[n] + S * (Us[n] - U[n]);
  } else {
    // HLLC_lm: Toro's alternate form with the low-Mach pressure fix
    const T vmag_l = sqrt(L.un * L.un + L.ut * L.ut);
    const T vmag_r = sqrt(R.un * R.un + R.ut * R.ut);
    const T cs_max = fmax(c_l, c_r);
    const T chi = fmin(T(1), fmax(vmag_l, vmag_r) / cs_max);
    const T phi = chi * (T(2) - chi);
    const T pstar_lr = T(0.5) * (L.p + R.p) +
                       T(0.5) * phi *
                           (L.rho * (S_l - L.un) * (S_c - L.un) +
                            R.rho * (S_r - R.un) * (S_c - R.un));
    T num[MAXVAR];
    for (int n = 0; n < p.nvar; ++n) num[n] = S_c * (S * U[n] - F[n]);
    num[in] = num[in] + S * pstar_lr;
    num[p.iener] = num[p.iener] + S * pstar_lr * S_c;
    for (int n = 0; n < p.nvar; ++n) F[n] = num[n] / (S - S_c);
  }
}

// CGF wave-region select for one side of the contact
template <typename T>
__device__ __forceinline__ T cgf_resolve(T outer, T star, T lam, T lamstar,
                                         T pstar, T p_s, bool left) {
  const T sigma = T(0.5) * (lam + lamstar);
  const T shock = left ? (sigma > T(0) ? outer : star)
                       : (sigma > T(0) ? star : outer);
  const T denom = lam - lamstar;
  const T alpha = lam / (denom == T(0) ? T(1) : denom);
  const T interp = alpha * star + (T(1) - alpha) * outer;
  const bool neg = lam < T(0) && lamstar < T(0);
  const bool pos = lam > T(0) && lamstar > T(0);
  const T raref = left ? (neg ? star : (pos ? outer : interp))
                       : (neg ? outer : (pos ? star : interp));
  return pstar > p_s ? shock : raref;
}

// the CGF star state and wave-region resolution on one interface, from
// each side's (rho, un, ut, rhoe, p); a solid face clamps the normal
// velocity
template <typename T>
struct CGFState {
  T rho, un, ut, p, rhoe, ustar;
};

template <typename T, typename P>
__device__ __forceinline__ CGFState<T> cgf_core(const P& p, const Side<T>& L,
                                                const Side<T>& R,
                                                bool solid) {
  const T g = T(p.gamma);

  const T W_l = fmax(T(SMALLRHO * SMALLC), sqrt(g * L.p * L.rho));
  const T W_r = fmax(T(SMALLRHO * SMALLC), sqrt(g * R.p * R.rho));
  const T c_l = fmax(T(SMALLC), sqrt(g * L.p / L.rho));
  const T c_r = fmax(T(SMALLC), sqrt(g * R.p / R.rho));

  const T pstar = fmax(
      (W_l * R.p + W_r * L.p + W_l * W_r * (L.un - R.un)) / (W_l + W_r),
      T(SMALLP));
  const T ustar = (W_l * L.un + W_r * R.un + (L.p - R.p)) / (W_l + W_r);

  const T rhostar_l = L.rho + (pstar - L.p) / (c_l * c_l);
  const T rhostar_r = R.rho + (pstar - R.p) / (c_r * c_r);
  const T rhoestar_l = L.rhoe + (pstar - L.p) *
                                    (L.rhoe / L.rho + L.p / L.rho) /
                                    (c_l * c_l);
  const T rhoestar_r = R.rhoe + (pstar - R.p) *
                                    (R.rhoe / R.rho + R.p / R.rho) /
                                    (c_r * c_r);
  const T cstar_l = fmax(T(SMALLC), sqrt(g * pstar / rhostar_l));
  const T cstar_r = fmax(T(SMALLC), sqrt(g * pstar / rhostar_r));

  const T lam_l = L.un - c_l;
  const T lamstar_l = ustar - cstar_l;
  const T lam_r = R.un + c_r;
  const T lamstar_r = ustar + cstar_r;

  auto pick = [&](T lo, T ls, T ro, T rs, T mid) {
    if (ustar > T(0))
      return cgf_resolve(lo, ls, lam_l, lamstar_l, pstar, L.p, true);
    if (ustar < T(0))
      return cgf_resolve(ro, rs, lam_r, lamstar_r, pstar, R.p, false);
    return mid;
  };

  CGFState<T> s;
  s.ustar = ustar;
  s.rho = pick(L.rho, rhostar_l, R.rho, rhostar_r,
               T(0.5) * (rhostar_l + rhostar_r));
  s.un = pick(L.un, ustar, R.un, ustar, ustar);
  s.p = pick(L.p, pstar, R.p, pstar, pstar);
  s.rhoe = pick(L.rhoe, rhoestar_l, R.rhoe, rhoestar_r,
                T(0.5) * (rhoestar_l + rhoestar_r));
  s.ut = ustar > T(0)   ? L.ut
         : ustar < T(0) ? R.ut
                        : T(0.5) * (L.ut + R.ut);
  if (solid) s.un = T(0);
  return s;
}

// CGF on conserved states: the flux of the interface state, which is
// also handed out through Us_out when that is not null
template <typename T, typename P>
__device__ __forceinline__ void cgf(const P& p, int idir, const T* Ul,
                                    const T* Ur, bool solid, T* F,
                                    T* Us_out) {
  const CGFState<T> s = cgf_core<T>(p, decompose<T>(p, idir, Ul),
                                    decompose<T>(p, idir, Ur), solid);
  const T rho_s = s.rho, un_s = s.un, ut_s = s.ut, ustar = s.ustar;

  const int in = idir == 1 ? p.ixmom : p.iymom;
  const int it = idir == 1 ? p.iymom : p.ixmom;
  T Us[MAXVAR];
  Us[p.idens] = rho_s;
  Us[in] = rho_s * un_s;
  Us[it] = rho_s * ut_s;
  Us[p.iener] = s.rhoe + T(0.5) * rho_s * (un_s * un_s + ut_s * ut_s);
  for (int n = 4; n < p.nvar; ++n) {
    const T xn_l = Ul[n] / Ul[p.idens];
    const T xn_r = Ur[n] / Ur[p.idens];
    const T xn = ustar > T(0)   ? xn_l
                 : ustar < T(0) ? xn_r
                                : T(0.5) * (xn_l + xn_r);
    Us[n] = xn * rho_s;
  }
  cons_flux(p, idir, Us, F, p.spherical != 0);
  if (Us_out)
    for (int n = 0; n < p.nvar; ++n) Us_out[n] = Us[n];
}

// CGF on primitive states (riemann_prim): the primitive interface state,
// without wall clamps (the 4th-order solver's)
template <typename T, typename P>
__device__ __forceinline__ void cgf_prim(const P& p, int idir, const T* ql,
                                         const T* qr, T* out) {
  const int iun = idir == 1 ? IU : IV;
  const int iut = idir == 1 ? IV : IU;
  Side<T> L, R;
  L.rho = ql[IRHO];
  L.un = ql[iun];
  L.ut = ql[iut];
  L.p = fmax(ql[IP], T(SMALLP));
  L.rhoe = L.p / T(p.gamma - 1.0);
  R.rho = qr[IRHO];
  R.un = qr[iun];
  R.ut = qr[iut];
  R.p = fmax(qr[IP], T(SMALLP));
  R.rhoe = R.p / T(p.gamma - 1.0);
  const CGFState<T> s = cgf_core<T>(p, L, R, false);
  out[IRHO] = s.rho;
  out[iun] = s.un;
  out[iut] = s.ut;
  out[IP] = s.p;
  for (int n = 4; n < p.nvar; ++n)
    out[n] = s.ustar > T(0)   ? ql[n]
             : s.ustar < T(0) ? qr[n]
                              : T(0.5) * (ql[n] + qr[n]);
}

// interface (i, j) normal to idir: is it a clamped solid wall?
template <typename P>
__device__ __forceinline__ bool solid_face(const P& p, int idir, int i,
                                           int j) {
  if (idir == 1)
    return (i == ilo(p) && p.solid_xl) || (i == ihi(p) + 1 && p.solid_xr);
  return (j == jlo(p) && p.solid_yl) || (j == jhi(p) + 1 && p.solid_yr);
}

// the flux F through interface (i, j); CGF also hands its interface state
// out through Us when that is not null (HLLC has none)
template <typename T, typename P>
__device__ __forceinline__ void riemann(const P& p, int idir,
                                        const T* Ul, const T* Ur, int i,
                                        int j, T* F, T* Us = nullptr) {
  if (p.riemann == 2)
    cgf(p, idir, Ul, Ur, solid_face(p, idir, i, j), F, Us);
  else
    hllc(p, idir, Ul, Ur, F);  // HLLC ignores solid walls, as in JAX
}

// ---------------------------------------------------------------------------
// cons <-> prim, flattening, the vertex divergence
// ---------------------------------------------------------------------------

// cons -> prim of one cell's conserved values u (the rho == 0 guard of
// the plain cons_to_prim)
template <typename T, typename P>
__device__ __forceinline__ void cons_to_prim(const P& p, const T* u, T* q) {
  const T rho = u[p.idens];
  const bool nz = rho != T(0);
  const T safe = nz ? rho : T(1);
  const T vx = nz ? u[p.ixmom] / safe : T(0);
  const T vy = nz ? u[p.iymom] / safe : T(0);
  const T e = nz ? (u[p.iener] - T(0.5) * rho * (vx * vx + vy * vy)) / safe
                 : T(0);
  q[IRHO] = rho;
  q[IU] = vx;
  q[IV] = vy;
  q[IP] = rho * e * T(p.gamma - 1.0);
  for (int n = 4; n < p.nvar; ++n) q[n] = nz ? u[n] / safe : T(0);
}

// the 1-D flattening coefficient of a buf=2-window cell (i, j) along
// (di, dj) from views of the pressure P and the normal velocity un (1
// outside the window)
template <typename T, typename P, typename A>
__device__ __forceinline__ T flat1d_of(const P& p, const A& P_, const A& un,
                                       int i, int j, int di, int dj) {
  if (!inwin(p, i, j, 2, 2, 2, 2)) return T(1);
  const T dp1 = fabs(P_(i + di, j + dj) - P_(i - di, j - dj));
  const T dp2 = fabs(P_(i + 2 * di, j + 2 * dj) - P_(i - 2 * di, j - 2 * dj));
  const T z = dp1 / fmax(dp2, T(1.0e-10));
  const T t2 = dp1 / fmin(P_(i + di, j + dj), P_(i - di, j - dj));
  const T t1 = un(i - di, j - dj) - un(i + di, j + dj);
  const T x = fmin(T(1), fmax(T(0), T(1) - (z - T(p.z0)) /
                                              T(p.z1 - p.z0)));
  return (t1 > T(0) && t2 > T(p.delta)) ? x : T(1);
}

template <typename T, typename P>
__device__ __forceinline__ void prim_to_cons(const P& p, const T* q, T* U) {
  U[p.idens] = q[IRHO];
  U[p.ixmom] = q[IU] * q[IRHO];
  U[p.iymom] = q[IV] * q[IRHO];
  U[p.iener] = q[IP] / T(p.gamma - 1.0) +
               T(0.5) * q[IRHO] * (q[IU] * q[IU] + q[IV] * q[IV]);
  for (int n = 4; n < p.nvar; ++n) U[n] = q[n] * q[IRHO];
}

// vertex divergence of the velocity views (u, v) at the lower-left corner
// of cell (i, j), zero outside the buf=1 window
template <typename T, typename P, typename A>
__device__ __forceinline__ T vertex_div_of(const P& p, const A& u, const A& v,
                                           int i, int j) {
  if (!inwin(p, i, j, 1, 1, 1, 1)) return T(0);
  const T ur = T(0.5) * (u(i, j) + u(i, j - 1));
  const T ul = T(0.5) * (u(i - 1, j) + u(i - 1, j - 1));
  const T vt = T(0.5) * (v(i, j) + v(i - 1, j));
  const T vb = T(0.5) * (v(i, j - 1) + v(i - 1, j - 1));
  return (ur - ul) / T(p.dx) + (vt - vb) / T(p.dy);
}

// the spherical vertex divergence of the velocity views (u, v) at the
// lower-left corner of cell (i, j), zero outside the buf=1 window; g gives
// the lines r (cell centre), rc (node), rl (r - dr) over i and sin(theta)
// at the node, the centre and the centre below over j
template <typename T, typename P, typename A, typename G>
__device__ __forceinline__ T sph_vertex_div(const P& p, const A& u,
                                            const A& v, const G& g, int i,
                                            int j) {
  if (!inwin(p, i, j, 1, 1, 1, 1)) return T(0);
  const T ur = T(0.5) * (u(i, j) + u(i, j - 1));
  const T ul = T(0.5) * (u(i - 1, j) + u(i - 1, j - 1));
  const T vt = T(0.5) * (v(i, j) + v(i - 1, j));
  const T vb = T(0.5) * (v(i, j - 1) + v(i - 1, j - 1));
  const T rr = g.r(i), rl = g.rl(i), rc = g.rc(i);
  const T ux = (ur * (rr * rr) - ul * (rl * rl)) / ((rc * rc) * T(p.dx));
  const T sinc = g.sinc(j);
  const T vy = (g.sint(j) * vt - g.sinb(j) * vb) /
               (rc * (sinc == T(0) ? T(1) : sinc) * T(p.dy));
  return ux + (sinc == T(0) ? T(0) : vy);
}

// the spherical external sources of a cell's state u at radius r: radial
// gravity, ymom^2 / (rho r) and -xmom ymom / rho (the plain
// get_external_sources, predictor form)
template <typename T, typename P>
__device__ __forceinline__ void sph_sources(const P& p, const T* u, T r,
                                            T& Sx, T& Sy, T& SE) {
  const T grav = T(p.grav);
  const T rho = u[p.idens], xm = u[p.ixmom], ym = u[p.iymom];
  Sx = rho * grav + (ym * ym) / (rho * r);
  Sy = T(0) - xm * ym / rho;
  SE = xm * grav;
}

// the multidimensional flattening coefficient of a buf=2-window cell from
// views of the pressure P and the 1-D coefficients xx, xy
template <typename T, typename P, typename A, typename B>
__device__ __forceinline__ T flat_xi_of(const P& p, const A& P_, const B& xx,
                                        const B& xy, int i, int j) {
  if (!p.flatten) return T(1);
  const T px = P_(i + 1, j) - P_(i - 1, j) > T(0) ? xx(i - 1, j)
                                                  : xx(i + 1, j);
  const T py = P_(i, j + 1) - P_(i, j - 1) > T(0) ? xy(i, j - 1)
                                                  : xy(i, j + 1);
  return fmin(fmin(xx(i, j), px), fmin(xy(i, j), py));
}

// the parameter block from the wrappers' int and double arrays (the order
// of CTUStep and MOLSubstep in Python: the ints end with the spherical and
// problem flags, and the MOL ones with the well-balanced flag; the doubles
// with e_rate, after the MOL constants)
inline Params load_params(const int* ip, const double* dp, bool mol) {
  Params p = {};
  p.nvar = ip[0];
  p.nx = ip[1];
  p.ny = ip[2];
  p.ng = ip[3];
  p.idens = ip[4];
  p.ixmom = ip[5];
  p.iymom = ip[6];
  p.iener = ip[7];
  p.riemann = ip[8];
  p.limiter = ip[9];
  p.flatten = ip[10];
  p.with_sources = ip[11];
  p.do_sponge = ip[12];
  p.has_floor = ip[13];
  p.solid_xl = ip[14];
  p.solid_xr = ip[15];
  p.solid_yl = ip[16];
  p.solid_yr = ip[17];
  // every edge a domain edge; the CTU step's single-state entries and the
  // rk entries read the flags (ctu_step.cu step_params, mol_substep.cu
  // rk_params)
  p.edge_xl = p.edge_xr = p.edge_yl = p.edge_yr = 1;
  p.dx = dp[0];
  p.dy = dp[1];
  p.dt = dp[2];
  p.gamma = dp[3];
  p.z0 = dp[4];
  p.z1 = dp[5];
  p.delta = dp[6];
  p.cvisc = dp[7];
  p.floor = dp[8];
  p.grav = dp[9];
  p.rho_begin = dp[10];
  p.rho_full = dp[11];
  p.tau = dp[12];
  p.spherical = ip[18];
  p.problem = ip[19];
  if (mol) {
    p.well_balanced = ip[20];
    p.dx2 = dp[13];
    p.dy2 = dp[14];
    p.dx2_24 = dp[15];
    p.mdx2 = dp[16];
    p.alpha = dp[17];
    p.beta_gamma = dp[18];
    p.e_rate = dp[19];
  } else {
    p.e_rate = dp[13];
  }
  p.qx = p.nx + 2 * p.ng;
  p.qy = p.ny + 2 * p.ng;
  return p;
}

// the sponge damping rate f / tau of density rho
template <typename T, typename P>
__device__ __forceinline__ T sponge_rate(const P& p, T rho) {
  const T f =
      rho > T(p.rho_begin)
          ? T(0)
          : (rho < T(p.rho_full)
                 ? T(1)
                 : T(0.5) * (T(1) - cos(T(PI) * (rho - T(p.rho_begin)) /
                                        T(p.rho_full - p.rho_begin))));
  return f / T(p.tau);
}

}  // namespace
