// ctu_step.cu -- one compressible CTU step on Hopper, Cartesian or
// spherical geometry, for one state or a batch of independent states.
//
// Replaces the fused Pallas TPU kernels of
// pyro2_tpu/solvers/compressible/pallas_step.py, which share one body,
// _local_step_fn:
//   * make_pallas_ctu_step_padded_general (the live Simulation's step):
//     ctu_step_{f32,f64} -- density floor, interface states (prim,
//     flattening, limited slopes, characteristic tracing), half-dt sources,
//     first Riemann pair + transverse corrections, final Riemann pair,
//     artificial viscosity, conservative update, (spherical pressure
//     gradients), predictor-corrector sources and sponge;
//   * make_pallas_ctu_step_padded (periodic frame), make_pallas_ctu_step
//     (pad in, pad out) and make_pallas_ctu_ensemble_step (a batch):
//     ctu_step_batched_{f32,f64}, the same stages with the floor, the
//     sources, the sponge and the walls forced off, as _local_step_fn's
//     defaults force them off there; member m of the batch is blockIdx.z.
// HLLC, HLLC_lm and CGF (spherical geometry: CGF only); limiter 0/1/2;
// flattening on or off; solid walls on any edge; passive scalars (nvar > 4,
// up to MAXVAR).
//
// Layout: the plain (nvar, nx + 2 ng, ny + 2 ng) state stack, y contiguous,
// members one after another.  Every kernel is one thread per cell or
// interface with threadIdx.x along y, so neighbouring threads touch
// neighbouring addresses.  Ragged edges are masked against the global
// index, so any nx, ny works.  Windows are compared against the global
// index too (the floor on the interior, the half-dt sources on the buf=1
// window, solid walls at ilo / ihi+1 and jlo / jhi+1), which reproduces the
// windowed semantics of the plain PyTorch step exactly.
//
// Spherical geometry (r = x, theta = y).  The geometry is one buffer G in
// the state's dtype, built once per step object from the grid's float64
// host arrays (ctu_kernel.geometry).  Where a quantity is separable it is a
// line, else a plane:
//   planes (qx, qy): Ax, Ay, V, dlogAy;
//   lines over i (qx): Ly = r dtheta, dlogAx = 2 / r, r (cell centre; the
//     sources' x2d and the divergence's rr), r at the node (rc), r - dr (rl);
//   lines over j (qy): sin(theta) at the node, the centre, the centre below.
// Lx is dr everywhere and is the scalar dx.  The terms: the d(log A) source
// of rho and p in the tracing (per-cell dt / Lx, dt / Ly), the area- and
// volume-weighted transverse corrections and update, the non-conservative
// pressure gradients from the CGF interface states (transverse: the first
// pair's, over the side of the unshifted cell; update: the final pair's),
// the spherical vertex divergence of the artificial viscosity, and the
// radial gravity and geometric momentum sources, which act with grav = 0
// too.  The geometry is a template argument of stages 3-6 (SPH), so the
// Cartesian stages compile without any of these terms.
//
// What bounds it on the H100: the step itself is arithmetic, ~1.1k
// floating-point operations per zone (many of them divides, square roots
// and pows) against 2 nvar values read and written per zone, so its bound
// is the fp32 rate.  This first design is simple instead: it stages its
// intermediates through device memory -- primitives, flattening
// coefficients, the four interface-state stacks and two flux pairs, about
// 28 nvar planes of traffic per zone over the six stages (spherical: four
// interface-pressure planes and the geometry reads on top) -- and keeps the
// per-variable arrays (MAXVAR long, indexed by run-time variable indices)
// in local memory.  chip_smoke.py prints its time beside the bound and a
// per-stage profile; fusing the stages into shared-memory tiles with 4-cell
// halos, and compile-time variable indices, are the next steps for speed.
// The scratch is allocated by the wrapper (torch.empty) and nothing is
// allocated here.  The stages run in order on the caller's stream; the
// entry points return the first cudaGetLastError().
//
// Build (see ctu_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libctu_step.so ctu_step.cu
// -fmad=false keeps each multiply and add rounded on its own, as the
// plain PyTorch step rounds them, so the two agree to the last bits that
// the order of operations allows.

#include "euler_common.cuh"

namespace {

// the spherical geometry buffer (see the header)
template <typename T>
struct Geom {
  const T* g;
  int qx, qy;
  __device__ size_t plane() const { return (size_t)qx * qy; }
  __device__ T pl(int k, int i, int j) const {
    return g[k * plane() + (size_t)i * qy + j];
  }
  __device__ T Ax(int i, int j) const { return pl(0, i, j); }
  __device__ T Ay(int i, int j) const { return pl(1, i, j); }
  __device__ T V(int i, int j) const { return pl(2, i, j); }
  __device__ T dlogAy(int i, int j) const { return pl(3, i, j); }
  __device__ T row(int k, int i) const { return g[4 * plane() + k * qx + i]; }
  __device__ T Ly(int i) const { return row(0, i); }
  __device__ T dlogAx(int i) const { return row(1, i); }
  __device__ T r(int i) const { return row(2, i); }
  __device__ T rc(int i) const { return row(3, i); }
  __device__ T rl(int i) const { return row(4, i); }
  __device__ T lane(int k, int j) const {
    return g[4 * plane() + 5 * (size_t)qx + k * qy + j];
  }
  __device__ T sinc(int j) const { return lane(0, j); }
  __device__ T sint(int j) const { return lane(1, j); }
  __device__ T sinb(int j) const { return lane(2, j); }
};

template <typename T>
__device__ __forceinline__ Geom<T> geom(const Params& p, const T* G) {
  return Geom<T>{G, p.qx, p.qy};
}

// trace cell-centred primitives q (slopes dq) to its two faces along idir.
// dtdx and dtdx4 are dt / L and dt / (4 L) for the cell's width L; dloga is
// the spherical d(log A) of the cell (unused in Cartesian geometry)
template <typename T, bool SPH>
__device__ void trace(const Params& p, int idir, const T* q, const T* dq,
                      T dtdx, T dtdx4, T dloga, T* ql, T* qr) {
  const int iun = idir == 1 ? IU : IV;
  const int iut = idir == 1 ? IV : IU;

  const T rho = q[IRHO];
  const T cs = sqrt(T(p.gamma) * q[IP] / rho);
  const T cs2 = cs * cs;
  const T un = q[iun];
  const T ev0 = un - cs;
  const T ev3 = un + cs;

  const T a0 = T(-0.5) * rho / cs * dq[iun] + T(0.5) / cs2 * dq[IP];
  const T a1 = dq[IRHO] - dq[IP] / cs2;
  const T a2 = dq[iut];
  const T a3 = T(0.5) * rho / cs * dq[iun] + T(0.5) / cs2 * dq[IP];

  // the gate tests ev >= 0 (copysign semantics): a stationary wave gates
  // fully left.  sign() would give it neither side.
  auto bl = [&](T ev, T asum) {
    return dtdx4 * (ev3 - ev) * (ev >= T(0) ? T(2) : T(0)) * asum;
  };
  auto br = [&](T ev, T asum) {
    return dtdx4 * (ev0 - ev) * (ev >= T(0) ? T(0) : T(2)) * asum;
  };
  const T bl0 = bl(ev0, a0), br0 = br(ev0, a0);
  const T bl1 = bl(un, a1), br1 = br(un, a1);
  const T bl2 = bl(un, a2), br2 = br(un, a2);
  const T bl3 = bl(ev3, a3), br3 = br(ev3, a3);

  const T factor_l = T(0.5) * (T(1) - dtdx * fmax(ev3, T(0)));
  const T factor_r = T(0.5) * (T(1) + dtdx * fmin(ev0, T(0)));

  T cl[MAXVAR], cr[MAXVAR];
  cl[IRHO] = bl0 + bl1 + bl3;
  cr[IRHO] = br0 + br1 + br3;
  cl[iun] = (cs / rho) * (bl3 - bl0);
  cr[iun] = (cs / rho) * (br3 - br0);
  cl[iut] = bl2;
  cr[iut] = br2;
  cl[IP] = cs2 * (bl0 + bl3);
  cr[IP] = cs2 * (br0 + br3);
  for (int n = 4; n < p.nvar; ++n) {
    cl[n] = bl(un, dq[n]);
    cr[n] = br(un, dq[n]);
  }
  for (int n = 0; n < p.nvar; ++n) {
    ql[n] = q[n] + factor_l * dq[n] + cl[n];
    qr[n] = q[n] - factor_r * dq[n] + cr[n];
  }
  if constexpr (SPH) {
    // geometric source: only rho and p pick it up
    const T rho_source = T(-0.5 * p.dt) * dloga * rho * un;
    ql[IRHO] = ql[IRHO] + rho_source;
    qr[IRHO] = qr[IRHO] + rho_source;
    ql[IP] = ql[IP] + rho_source * cs2;
    qr[IP] = qr[IP] + rho_source * cs2;
  }
}


// store an interface state at (i, j), adding 0.5 dt of the cell (si, sj)'s
// sources on the buf=1 window
template <typename T>
__device__ __forceinline__ void store_state(const Params& p, T* dst,
                                            const T* Uc, int i, int j,
                                            const T* __restrict__ S, int si,
                                            int sj) {
  if (i < 0 || i >= p.qx || j < 0 || j >= p.qy) return;
  T v[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) v[n] = Uc[n];
  if (p.with_sources && inwin(p, i, j, 1, 1, 1, 1)) {
    const T hdt = T(0.5 * p.dt);
    v[p.ixmom] = v[p.ixmom] + hdt * S[at(p, 1, si, sj)];
    v[p.iymom] = v[p.iymom] + hdt * S[at(p, 2, si, sj)];
    v[p.iener] = v[p.iener] + hdt * S[at(p, 3, si, sj)];
  }
  for (int n = 0; n < p.nvar; ++n) dst[at(p, n, i, j)] = v[n];
}

// the scratch of member blockIdx.z: Q, XI, the four interface-state
// stacks, the two flux pairs and the four interface-pressure planes
template <typename T>
struct Scratch {
  T *Q, *XI, *UXL, *UXR, *UYL, *UYR, *F1X, *F1Y, *F2X, *F2Y;
  T *P1X, *P1Y, *P2X, *P2Y;
};

template <typename T>
__device__ __host__ Scratch<T> carve(T* base, int nvar, size_t plane) {
  const size_t stack = (size_t)nvar * plane;
  Scratch<T> s;
  s.Q = base;
  s.XI = s.Q + stack;
  s.UXL = s.XI + 2 * plane;
  s.UXR = s.UXL + stack;
  s.UYL = s.UXR + stack;
  s.UYR = s.UYL + stack;
  s.F1X = s.UYR + stack;
  s.F1Y = s.F1X + stack;
  s.F2X = s.F1Y + stack;
  s.F2Y = s.F2X + stack;
  s.P1X = s.F2Y + stack;
  s.P1Y = s.P1X + plane;
  s.P2X = s.P1Y + plane;
  s.P2Y = s.P2X + plane;
  return s;
}

template <typename T>
__device__ __forceinline__ Scratch<T> member_scratch(T* scratch,
                                                     const Params& p) {
  return carve(scratch + blockIdx.z * p.sstride, p.nvar,
               (size_t)p.qx * p.qy);
}

// stage 3: interface states.  Cell (i, j) writes U_xr(i, j), U_xl(i+1, j),
// U_yr(i, j), U_yl(i, j+1): traced states inside the buf=2 window, zero
// outside it.  Row i = 0 / column j = 0 of U_xl / U_yl are zero.
template <typename T, bool SPH>
__global__ void k_states(T* scratch, const T* __restrict__ S,
                         const T* __restrict__ G, Params p) {
  CELL_INDEX
  const Scratch<T> s = member_scratch(scratch, p);
  const T* __restrict__ Q = s.Q;
  T* __restrict__ UXL = s.UXL;
  T* __restrict__ UXR = s.UXR;
  T* __restrict__ UYL = s.UYL;
  T* __restrict__ UYR = s.UYR;
  const size_t plane = (size_t)p.qx * p.qy;
  const size_t c = (size_t)i * p.qy + j;
  T ul[MAXVAR], ur[MAXVAR], zero[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) zero[n] = T(0);
  if (i == 0)
    for (int n = 0; n < p.nvar; ++n) UXL[at(p, n, 0, j)] = T(0);
  if (j == 0)
    for (int n = 0; n < p.nvar; ++n) UYL[at(p, n, i, 0)] = T(0);

  if (!inwin(p, i, j, 2, 2, 2, 2)) {
    store_state(p, UXR, zero, i, j, S, i, j);
    store_state(p, UXL, zero, i + 1, j, S, i, j);
    store_state(p, UYR, zero, i, j, S, i, j);
    store_state(p, UYL, zero, i, j + 1, S, i, j);
    return;
  }

  const T xi = flat_xi(p, Q, s.XI, i, j);

  T q[MAXVAR], dq[MAXVAR], ql[MAXVAR], qr[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) q[n] = Q[n * plane + c];
  for (int d = 1; d <= 2; ++d) {
    const int di = d == 1, dj = d == 2;
    for (int n = 0; n < p.nvar; ++n)
      dq[n] = xi * slope(p, Q + n * plane, i, j, di, dj);
    T dtdx, dtdx4, dloga = T(0);
    if constexpr (SPH) {
      // per-cell widths, as the plain step's dt / L: (1 / L) dt
      const Geom<T> g = geom(p, G);
      dtdx = (T(1) / (d == 1 ? T(p.dx) : g.Ly(i))) * T(p.dt);
      dtdx4 = T(0.25) * dtdx;
      dloga = d == 1 ? g.dlogAx(i) : g.dlogAy(i, j);
    } else {
      const double w = d == 1 ? p.dx : p.dy;
      dtdx = T(p.dt / w);
      dtdx4 = T(0.25 * (p.dt / w));
    }
    trace<T, SPH>(p, d, q, dq, dtdx, dtdx4, dloga, ql, qr);
    prim_to_cons(p, ql, ul);
    prim_to_cons(p, qr, ur);
    if (d == 1) {
      store_state(p, UXR, ur, i, j, S, i, j);
      store_state(p, UXL, ul, i + 1, j, S, i, j);
    } else {
      store_state(p, UYR, ur, i, j, S, i, j);
      store_state(p, UYL, ul, i, j + 1, S, i, j);
    }
  }
}

// the pressure of a conserved interface state (cons_to_prim's)
template <typename T>
__device__ __forceinline__ T pressure(const Params& p, const T* u) {
  T q[MAXVAR];
  cons_to_prim(p, u, q);
  return q[IP];
}

// stage 4: the first Riemann pair on the buf=1 window (zero outside); in
// spherical geometry also the pressures of the pair's CGF interface states
template <typename T, bool SPH>
__global__ void k_riemann1(T* scratch, Params p) {
  CELL_INDEX
  const Scratch<T> s = member_scratch(scratch, p);
  T ul[MAXVAR], ur[MAXVAR], f[MAXVAR], us[MAXVAR];
  const bool w1 = inwin(p, i, j, 1, 1, 1, 1);
  for (int d = 1; d <= 2; ++d) {
    const T* L = d == 1 ? s.UXL : s.UYL;
    const T* R = d == 1 ? s.UXR : s.UYR;
    T* F = d == 1 ? s.F1X : s.F1Y;
    T pr = T(0);
    if (w1) {
      for (int n = 0; n < p.nvar; ++n) {
        ul[n] = L[at(p, n, i, j)];
        ur[n] = R[at(p, n, i, j)];
      }
      riemann(p, d, ul, ur, i, j, f, SPH ? us : (T*)nullptr);
      if constexpr (SPH) pr = pressure(p, us);
    } else {
      for (int n = 0; n < p.nvar; ++n) f[n] = T(0);
    }
    for (int n = 0; n < p.nvar; ++n) F[at(p, n, i, j)] = f[n];
    if constexpr (SPH) (d == 1 ? s.P1X : s.P1Y)[at(p, 0, i, j)] = pr;
  }
}

// the spherical vertex divergence of (u, v) at the lower-left corner of
// cell (i, j), zero outside the buf=1 window
template <typename T>
__device__ __forceinline__ T sph_vertex_div(const Params& p, const T* Q,
                                            const Geom<T>& g, int i, int j) {
  if (!inwin(p, i, j, 1, 1, 1, 1)) return T(0);
  const T* u = Q + (size_t)IU * p.qx * p.qy;
  const T* v = Q + (size_t)IV * p.qx * p.qy;
  const size_t c = (size_t)i * p.qy + j;
  const size_t w = c - p.qy, s = c - 1, sw = c - p.qy - 1;
  const T ur = T(0.5) * (u[c] + u[s]);
  const T ul = T(0.5) * (u[w] + u[sw]);
  const T vt = T(0.5) * (v[c] + v[w]);
  const T vb = T(0.5) * (v[s] + v[sw]);
  const T rr = g.r(i), rl = g.rl(i), rc = g.rc(i);
  const T ux = (ur * (rr * rr) - ul * (rl * rl)) / ((rc * rc) * T(p.dx));
  const T sinc = g.sinc(j);
  const T vy = (g.sint(j) * vt - g.sinb(j) * vb) /
               (rc * (sinc == T(0) ? T(1) : sinc) * T(p.dy));
  return ux + (sinc == T(0) ? T(0) : vy);
}

template <typename T, bool SPH>
__device__ __forceinline__ T vdiv(const Params& p, const T* Q, const T* G,
                                  int i, int j) {
  if constexpr (SPH)
    return sph_vertex_div(p, Q, geom(p, G), i, j);
  else
    return vertex_div(p, Q, i, j);
}

// stage 5: transverse corrections, the final Riemann pair and artificial
// viscosity on the faces the update reads: x faces i in [ilo, ihi+1],
// y faces j in [jlo, jhi+1]; in spherical geometry also the pressures of
// the final pair's CGF interface states
template <typename T, bool SPH>
__global__ void k_riemann2(const T* __restrict__ U, T* scratch,
                           const T* __restrict__ G, Params p) {
  CELL_INDEX
  U += blockIdx.z * p.mstride;
  const Scratch<T> s = member_scratch(scratch, p);
  const T* __restrict__ Q = s.Q;
  const T* __restrict__ F1X = s.F1X;
  const T* __restrict__ F1Y = s.F1Y;
  const Geom<T> g = geom(p, G);
  const T hdt = T(0.5 * p.dt);
  T ul[MAXVAR], ur[MAXVAR], f[MAXVAR], us[MAXVAR];

  if (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) && j <= jhi(p)) {
    if constexpr (SPH) {
      const T mhdtV = -((T(1) / g.V(i, j)) * hdt);
      for (int n = 0; n < p.nvar; ++n) {
        ul[n] = s.UXL[at(p, n, i, j)] +
                mhdtV * (F1Y[at(p, n, i - 1, j + 1)] * g.Ay(i - 1, j + 1) -
                         F1Y[at(p, n, i - 1, j)] * g.Ay(i - 1, j));
        ur[n] = s.UXR[at(p, n, i, j)] +
                mhdtV * (F1Y[at(p, n, i, j + 1)] * g.Ay(i, j + 1) -
                         F1Y[at(p, n, i, j)] * g.Ay(i, j));
      }
      // transverse pressure gradients, over the unshifted cell's side
      const T* P1Y = s.P1Y;
      const T Ly = g.Ly(i);
      ul[p.iymom] = ul[p.iymom] +
                    (-hdt) * (P1Y[at(p, 0, i - 1, j + 1)] -
                              P1Y[at(p, 0, i - 1, j)]) / Ly;
      ur[p.iymom] = ur[p.iymom] +
                    (-hdt) * (P1Y[at(p, 0, i, j + 1)] -
                              P1Y[at(p, 0, i, j)]) / Ly;
    } else {
      const T mhdtV = T(-(0.5 * p.dt / (p.dx * p.dy)));
      const T Ay = T(p.dx);
      for (int n = 0; n < p.nvar; ++n) {
        ul[n] = s.UXL[at(p, n, i, j)] +
                mhdtV * (F1Y[at(p, n, i - 1, j + 1)] * Ay -
                         F1Y[at(p, n, i - 1, j)] * Ay);
        ur[n] = s.UXR[at(p, n, i, j)] +
                mhdtV * (F1Y[at(p, n, i, j + 1)] * Ay -
                         F1Y[at(p, n, i, j)] * Ay);
      }
    }
    riemann(p, 1, ul, ur, i, j, f, SPH ? us : (T*)nullptr);
    if constexpr (SPH) s.P2X[at(p, 0, i, j)] = pressure(p, us);
    if (i <= ihi(p)) {
      const T divU = T(0.5) * (vdiv<T, SPH>(p, Q, G, i, j) +
                               vdiv<T, SPH>(p, Q, G, i, j + 1));
      const T av = T(p.cvisc) * fmax(-divU * T(p.dx), T(0));
      for (int n = 0; n < p.nvar; ++n)
        f[n] = f[n] + av * (ldU(U, p, n, i - 1, j) - ldU(U, p, n, i, j));
    }
    for (int n = 0; n < p.nvar; ++n) s.F2X[at(p, n, i, j)] = f[n];
  }

  if (i >= ilo(p) && i <= ihi(p) && j >= jlo(p) && j <= jhi(p) + 1) {
    if constexpr (SPH) {
      const T mhdtV = -((T(1) / g.V(i, j)) * hdt);
      for (int n = 0; n < p.nvar; ++n) {
        ul[n] = s.UYL[at(p, n, i, j)] +
                mhdtV * (F1X[at(p, n, i + 1, j - 1)] * g.Ax(i + 1, j - 1) -
                         F1X[at(p, n, i, j - 1)] * g.Ax(i, j - 1));
        ur[n] = s.UYR[at(p, n, i, j)] +
                mhdtV * (F1X[at(p, n, i + 1, j)] * g.Ax(i + 1, j) -
                         F1X[at(p, n, i, j)] * g.Ax(i, j));
      }
      const T* P1X = s.P1X;
      const T Lx = T(p.dx);
      ul[p.ixmom] = ul[p.ixmom] +
                    (-hdt) * (P1X[at(p, 0, i + 1, j - 1)] -
                              P1X[at(p, 0, i, j - 1)]) / Lx;
      ur[p.ixmom] = ur[p.ixmom] +
                    (-hdt) * (P1X[at(p, 0, i + 1, j)] -
                              P1X[at(p, 0, i, j)]) / Lx;
    } else {
      const T mhdtV = T(-(0.5 * p.dt / (p.dx * p.dy)));
      const T Ax = T(p.dy);
      for (int n = 0; n < p.nvar; ++n) {
        ul[n] = s.UYL[at(p, n, i, j)] +
                mhdtV * (F1X[at(p, n, i + 1, j - 1)] * Ax -
                         F1X[at(p, n, i, j - 1)] * Ax);
        ur[n] = s.UYR[at(p, n, i, j)] +
                mhdtV * (F1X[at(p, n, i + 1, j)] * Ax -
                         F1X[at(p, n, i, j)] * Ax);
      }
    }
    riemann(p, 2, ul, ur, i, j, f, SPH ? us : (T*)nullptr);
    if constexpr (SPH) s.P2Y[at(p, 0, i, j)] = pressure(p, us);
    if (j <= jhi(p)) {
      const T divU = T(0.5) * (vdiv<T, SPH>(p, Q, G, i, j) +
                               vdiv<T, SPH>(p, Q, G, i + 1, j));
      const T L = SPH ? g.Ly(i) : T(p.dy);
      const T av = T(p.cvisc) * fmax(-divU * L, T(0));
      for (int n = 0; n < p.nvar; ++n)
        f[n] = f[n] + av * (ldU(U, p, n, i, j - 1) - ldU(U, p, n, i, j));
    }
    for (int n = 0; n < p.nvar; ++n) s.F2Y[at(p, n, i, j)] = f[n];
  }
}

// the spherical external sources of a cell's state u at radius r: radial
// gravity, ymom^2 / (rho r) and -xmom ymom / rho (the plain
// get_external_sources, predictor form)
template <typename T>
__device__ __forceinline__ void sph_sources(const Params& p, const T* u, T r,
                                            T& Sx, T& Sy, T& SE) {
  const T grav = T(p.grav);
  const T rho = u[p.idens], xm = u[p.ixmom], ym = u[p.iymom];
  Sx = rho * grav + (ym * ym) / (rho * r);
  Sy = T(0) - xm * ym / rho;
  SE = xm * grav;
}

// stage 6: conservative update, (spherical pressure gradients),
// predictor-corrector sources and sponge on the interior; ghosts are
// carried through from the input unchanged
template <typename T, bool SPH>
__global__ void k_update(const T* __restrict__ U, T* scratch,
                         const T* __restrict__ G, T* __restrict__ out,
                         Params p) {
  CELL_INDEX
  U += blockIdx.z * p.mstride;
  out += blockIdx.z * p.mstride;
  if (!inwin(p, i, j, 0, 0, 0, 0)) {
    for (int n = 0; n < p.nvar; ++n) out[at(p, n, i, j)] = U[at(p, n, i, j)];
    return;
  }
  const Scratch<T> s = member_scratch(scratch, p);
  const T* __restrict__ F2X = s.F2X;
  const T* __restrict__ F2Y = s.F2Y;
  T u[MAXVAR];
  if constexpr (SPH) {
    const Geom<T> g = geom(p, G);
    const T dtdV = (T(1) / g.V(i, j)) * T(p.dt);
    for (int n = 0; n < p.nvar; ++n) {
      const T upd = dtdV * (F2X[at(p, n, i, j)] * g.Ax(i, j) -
                            F2X[at(p, n, i + 1, j)] * g.Ax(i + 1, j) +
                            F2Y[at(p, n, i, j)] * g.Ay(i, j) -
                            F2Y[at(p, n, i, j + 1)] * g.Ay(i, j + 1));
      u[n] = ldU(U, p, n, i, j) + upd;
    }
    // non-conservative pressure gradients from the final pair
    const T mdt = T(-p.dt);
    u[p.ixmom] = u[p.ixmom] + mdt * (s.P2X[at(p, 0, i + 1, j)] -
                                     s.P2X[at(p, 0, i, j)]) / T(p.dx);
    u[p.iymom] = u[p.iymom] + mdt * (s.P2Y[at(p, 0, i, j + 1)] -
                                     s.P2Y[at(p, 0, i, j)]) / g.Ly(i);

    // predictor-corrector sources (always on: the geometric terms act
    // with grav = 0 too)
    const T r = g.r(i);
    const T dt = T(p.dt), hdt = T(0.5 * p.dt), grav = T(p.grav);
    T u0[MAXVAR];
    for (int n = 0; n < p.nvar; ++n) u0[n] = ldU(U, p, n, i, j);
    T Sx0, Sy0, SE0;
    sph_sources(p, u0, r, Sx0, Sy0, SE0);
    u[p.ixmom] = u[p.ixmom] + dt * Sx0;
    u[p.iymom] = u[p.iymom] + dt * Sy0;
    u[p.iener] = u[p.iener] + dt * SE0;
    // the corrector: the energy source time-centred with the corrected
    // radial momentum
    const T S_xmom = u[p.idens] * grav;
    const T S_old_xmom = u0[p.idens] * grav;
    const T xmom_new = u[p.ixmom] + hdt * (S_xmom - S_old_xmom);
    const T Sx1 = S_xmom + (u[p.iymom] * u[p.iymom]) / (u[p.idens] * r);
    const T Sy1 = T(0) - u[p.ixmom] * u[p.iymom] / u[p.idens];
    const T SE1 = xmom_new * grav;
    u[p.ixmom] = u[p.ixmom] + hdt * (Sx1 - Sx0);
    u[p.iymom] = u[p.iymom] + hdt * (Sy1 - Sy0);
    u[p.iener] = u[p.iener] + hdt * (SE1 - SE0);
  } else {
    const T dtdV = T(p.dt / (p.dx * p.dy));
    const T Ax = T(p.dy), Ay = T(p.dx);
    for (int n = 0; n < p.nvar; ++n) {
      const T upd = dtdV * (F2X[at(p, n, i, j)] * Ax -
                            F2X[at(p, n, i + 1, j)] * Ax +
                            F2Y[at(p, n, i, j)] * Ay -
                            F2Y[at(p, n, i, j + 1)] * Ay);
      u[n] = ldU(U, p, n, i, j) + upd;
    }

    if (p.with_sources) {
      const T grav = T(p.grav);
      const T dt = T(p.dt), hdt = T(0.5 * p.dt);
      const T S_old_ymom = ldU(U, p, p.idens, i, j) * grav;
      const T S_old_E = ldU(U, p, p.iymom, i, j) * grav;
      u[p.iymom] = u[p.iymom] + dt * S_old_ymom;
      u[p.iener] = u[p.iener] + dt * S_old_E;
      const T S_new_ymom = u[p.idens] * grav;
      const T ymom_new = u[p.iymom] + hdt * (S_new_ymom - S_old_ymom);
      const T S_new_E = ymom_new * grav;
      u[p.iymom] = u[p.iymom] + hdt * (S_new_ymom - S_old_ymom);
      u[p.iener] = u[p.iener] + hdt * (S_new_E - S_old_E);
    }
  }

  if (p.do_sponge) {
    const T damp = T(1) + T(p.dt) * sponge_rate(p, u[p.idens]);
    const T x = u[p.ixmom], y = u[p.iymom];
    const T nx = x / damp, ny = y / damp;
    u[p.ixmom] = nx;
    u[p.iymom] = ny;
    u[p.iener] = u[p.iener] + T(0.5) * ((nx * nx + ny * ny) - (x * x + y * y)) /
                                  u[p.idens];
  }
  for (int n = 0; n < p.nvar; ++n) out[at(p, n, i, j)] = u[n];
}

// the scratch planes of one member, in the state's dtype: 8 nvar + nvar
// (Q) + 2 (XI) + 4 (the spherical interface pressures)
int scratch_planes(int nvar) { return 9 * nvar + 6; }

// stages 3-6, with the geometry fixed at compile time (the Cartesian
// stages carry no spherical branch)
template <typename T, bool SPH>
int stages(const T* U, const T* S, const T* G, T* out, T* scratch,
           const Params& p, dim3 grd, dim3 blk, cudaStream_t st) {
  k_states<T, SPH><<<grd, blk, 0, st>>>(scratch, S, G, p);
  LAUNCH_CHECK;
  k_riemann1<T, SPH><<<grd, blk, 0, st>>>(scratch, p);
  LAUNCH_CHECK;
  k_riemann2<T, SPH><<<grd, blk, 0, st>>>(U, scratch, G, p);
  LAUNCH_CHECK;
  k_update<T, SPH><<<grd, blk, 0, st>>>(U, scratch, G, out, p);
  LAUNCH_CHECK;
  return 0;
}

template <typename T>
int run(const T* U, const T* S, const T* G, T* out, T* scratch, Params p,
        int n_members, cudaStream_t st) {
  if (p.nvar < 4 || p.nvar > MAXVAR || p.ng < 4 || p.nx < 1 || p.ny < 1 ||
      n_members < 1 || n_members > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.with_sources && S == nullptr) return (int)cudaErrorInvalidValue;
  if (p.spherical && (G == nullptr || p.riemann != 2))
    return (int)cudaErrorInvalidValue;

  const size_t plane = (size_t)p.qx * p.qy;
  p.mstride = n_members > 1 ? (size_t)p.nvar * plane : 0;
  p.sstride = n_members > 1 ? (size_t)scratch_planes(p.nvar) * plane : 0;
  const Scratch<T> s = carve(scratch, p.nvar, plane);

  const dim3 blk(64, 4);
  const dim3 grd((p.qy + blk.x - 1) / blk.x, (p.qx + blk.y - 1) / blk.y,
                 n_members);
  k_prim<T><<<grd, blk, 0, st>>>(U, s.Q, p);
  LAUNCH_CHECK;
  if (p.flatten) {
    k_flatten<T><<<grd, blk, 0, st>>>(s.Q, s.XI, p);
    LAUNCH_CHECK;
  }
  return p.spherical ? stages<T, true>(U, S, G, out, scratch, p, grd, blk, st)
                     : stages<T, false>(U, S, G, out, scratch, p, grd, blk,
                                        st);
}

// the padded entries' step: no floor, sources, sponge or walls, and
// Cartesian geometry, whatever the parameter arrays say
inline Params batched_params(const int* ip, const double* dp) {
  Params p = load_params(ip, dp, false);
  p.with_sources = p.do_sponge = p.has_floor = 0;
  p.solid_xl = p.solid_xr = p.solid_yl = p.solid_yr = 0;
  p.spherical = 0;
  return p;
}

}  // namespace

extern "C" int ctu_scratch_planes(int nvar) { return scratch_planes(nvar); }

extern "C" int ctu_step_f32(const float* U, const float* S, const float* G,
                            float* out, float* scratch, const int* ip,
                            const double* dp, void* stream) {
  return run<float>(U, S, G, out, scratch, load_params(ip, dp, false), 1,
                    (cudaStream_t)stream);
}

extern "C" int ctu_step_f64(const double* U, const double* S,
                            const double* G, double* out, double* scratch,
                            const int* ip, const double* dp, void* stream) {
  return run<double>(U, S, G, out, scratch, load_params(ip, dp, false), 1,
                     (cudaStream_t)stream);
}

// n_members independent states, one after another in U, out and scratch
// (scratch: n_members x ctu_scratch_planes(nvar) planes)
extern "C" int ctu_step_batched_f32(const float* U, float* out,
                                    float* scratch, int n_members,
                                    const int* ip, const double* dp,
                                    void* stream) {
  return run<float>(U, nullptr, nullptr, out, scratch, batched_params(ip, dp),
                    n_members, (cudaStream_t)stream);
}

extern "C" int ctu_step_batched_f64(const double* U, double* out,
                                    double* scratch, int n_members,
                                    const int* ip, const double* dp,
                                    void* stream) {
  return run<double>(U, nullptr, nullptr, out, scratch,
                     batched_params(ip, dp), n_members, (cudaStream_t)stream);
}
