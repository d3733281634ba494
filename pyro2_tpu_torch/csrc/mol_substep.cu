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
// global interior, and any nx, ny; and, in their extended instantiation
// (the template flag X), what the TPU kernel refuses: SphericalPolar grids,
// a problem's energy source and (rk) the well-balanced reconstruction.
//
// The extended instantiation.  On a SphericalPolar grid the sources are
// the spherical ones (radial gravity, ymom^2 / (rho r), 0 - xmom ymom /
// rho, xmom grav, with r of the cell's row from the lines buffer G), CGF's
// flux leaves the pressure out of the normal momentum (the HLLC solvers'
// does not), rk's artificial viscosity takes the spherical vertex
// divergence and Ly = r dtheta across the y faces, and the flux divergence
// stays the Cartesian one over dx and dy, as the JAX package's MOL stage
// has it.  A problem's energy source adds (rho e_rate) w to the energy row
// of the sources, w the plane W (rk: of the floored state; fv4: of the
// centres, before the sources go back to averages).  With
// compressible.well_balanced (rk, limiter 1) the y faces take the
// hydrostatic-subtracted MC slope of the pressure, which replaces the
// flattened one, and the pressures p -+ 0.5 dy rho grav -+ dp/2.  The
// Cartesian configuration without these keeps the plain instantiation.
//
// Layout and windows: the plain (nvar, qx, qy) stack, y contiguous, every
// window decided by comparing the global index -- the TPU's row bands,
// 8-row halos, 128-aligned rows and DMA semaphores have no counterpart.
// The shared device code (the Riemann solvers, slopes, flattening, cons <->
// prim) is euler_common.cuh.
//
// What bounds it on the H100: ~620 (rk) and ~1200 (fv4) floating-point
// operations per zone (mol_kernel.FLOPS_PER_ZONE_BY_STAGE), many of them
// divides and square roots, against 2 nvar values read and written per
// zone: rk sits at the balance point of the fp32 rate and the memory rate
// (bytes bound it, barely), fv4 is bound by the fp32 rate.
//
// rk is one launch a stage (k_rk): each block owns one output tile
// (mol_kernel.rk_plan picks its shape per dtype, lays out the block's shared
// memory and sizes the grid) and runs the first design's five staged
// kernels out of shared memory and registers, each stage over the box the
// next one reads:
//   1. the primitives of the floored state (halo 4: the flattening
//      coefficients read the pressure 2 cells out);
//   2. the 1-D flattening coefficients (halo 2: a state cell's
//      multidimensional coefficient reads them 1 cell out);
//   3. along x, the PLM states q -+ dq/2 of the cells the tile's x faces
//      take (1 cell beyond the tile along x), as conserved states;
//   4. the HLLC / HLLC_lm / CGF flux of each x face of the tile with the
//      artificial viscosity (the primitives' vertex divergence, the
//      floored state read through the caches); 3-4 again along y, the y
//      states over the x states;
//   5. the divergence with the gravity sources and the sponge on the
//      tile's cells, and k's zero ghosts from the tiles at the frame's
//      edges.
// __syncthreads() separates the stages.  Nothing goes to device memory but
// k, and there is no scratch; as for fv4, each cell's operations are the
// first design's, in its order.

// fv4 is one launch a stage (k_fv4): each block owns one output tile
// (mol_kernel.plan picks its shape per dtype, lays out the block's shared
// memory and sizes the grid), loads the floored state of the tile and a
// 5-cell halo once, and runs the first design's pipeline out of shared
// memory and registers, each stage over the box the next one reads:
//   1. primitives of the averages (halo 5); the centres with the
//      positivity fallback as primitives (halo 4); the centred sources
//      (halo 1);
//   2. the 1-D flattening coefficients (halo 2);
//   3. the 4th-order averages, in place of the centres (halo 4);
//   4. per direction, the limited 4th-order states of each cell (halo 1),
//      computed once and shared by the cell's two faces, blended by its
//      flattening coefficient; then CGF on the faces the transverse
//      Laplacians read;
//   5. the fluxes of the tile's faces, with the face-centre Laplacians and
//      the artificial viscosity (over the averages and states, done);
//   6. the divergence with the averaged sources and the sponge on the
//      tile's cells, and k's zero ghosts from the tiles at the frame's
//      edges.
// __syncthreads() separates the stages.  Near the frame's edges the boxes
// reach past it; the windows make every value read come from inside it.
// The variable count is a template argument (4..MAXVAR) and the conserved
// indices are fixed (FixedParams), so the per-variable arrays stay in
// registers.  Nothing goes to device memory but k, and there is no scratch.
// Each cell's operations are the first design's, in its order; only where
// the intermediates live changed.  Each entry returns the first
// cudaGetLastError().
//
// Build (see compressible_fv4/mol_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libmol_substep.so mol_substep.cu
// -fmad=false keeps each multiply and add rounded on its own, as the plain
// PyTorch versions round them, so limiter branches do not flip on a fused
// rounding.

#include "euler_common.cuh"

namespace {

// the lines of a SphericalPolar grid (mol_kernel.lines): over i the cell
// width Ly = r dtheta, the centre radius r, the node radius rc and r - dr;
// over j sin(theta) at the node, the centre and the centre below
template <typename T>
struct Lines {
  const T* g;
  int qx, qy;
  __device__ T Ly(int i) const { return g[i]; }
  __device__ T r(int i) const { return g[qx + i]; }
  __device__ T rc(int i) const { return g[2 * qx + i]; }
  __device__ T rl(int i) const { return g[3 * qx + i]; }
  __device__ T sinc(int j) const { return g[4 * qx + j]; }
  __device__ T sint(int j) const { return g[4 * qx + qy + j]; }
  __device__ T sinb(int j) const { return g[4 * qx + 2 * qy + j]; }
};

// the sources of the extended instantiation from a cell's state u at row i
// (the plain get_external_sources, predictor form, plus a problem's energy
// source): the xmom, ymom and ener rows; w is the cell's weight
template <typename T, typename P>
__device__ __forceinline__ void ext_sources(const P& p, const T* u,
                                            const Lines<T>& g, int i, T w,
                                            T& Sx, T& Sy, T& SE) {
  if (p.spherical) {
    sph_sources(p, u, g.r(i), Sx, Sy, SE);
  } else {
    const T grav = T(p.grav);
    Sx = T(0);
    Sy = u[p.idens] * grav;
    SE = u[p.iymom] * grav;
  }
  if (p.problem) SE = SE + (u[p.idens] * T(p.e_rate)) * w;
}

// the sponge terms of k at an interior cell, from the floored state
template <typename T, typename P>
__device__ __forceinline__ void add_sponge(const P& p,
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

// ---------------------------------------------------------------------------
// fv4: the McCorquodale-Colella pipeline, one fused launch
// ---------------------------------------------------------------------------

// the 5-point Laplacian of a view v at (i, j), in the plain version's order
template <typename T, typename P, typename F>
__device__ __forceinline__ T lap5(const P& p, const F& v, int i, int j) {
  const T c = v(i, j);
  return (v(i - 1, j) - T(2) * c + v(i + 1, j)) / T(p.dx2) +
         (v(i, j - 1) - T(2) * c + v(i, j + 1)) / T(p.dy2);
}

constexpr double C2 = 1.25;
constexpr double C3 = 0.1;

// copysign(1, x) with copysign(1, 0) == +1
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x >= T(0) ? T(1) : T(-1);
}

// The limited 4th-order states of one plane A (q_avg of one primitive,
// zero outside the buf=3 window; a view A(i, j)) along direction D at a
// cell (i, j) of the m_W box (along D [lo-1, hi+1], across [lo-1, hi+1]):
// the right state ar, which is ar at the cell's lower face, and the left
// state al, which is al at its upper face, from one evaluation of the
// limiter.  It reads A 3 cells either way along D.  The region masks are
// those of fourth_order.states: outside them a_int, d2ac and d3a are zero,
// and d3a reaches hi+3 along x but hi+2 along y.
template <typename T, int D, typename P, typename V>
__device__ __forceinline__ void fo_pair(const P& p, const V& A, int i, int j,
                                        T& ar, T& al) {
  const int ax = D == 1 ? i : j;             // index along D
  const int tr = D == 1 ? j : i;             // index across D
  const int hi_a = D == 1 ? ihi(p) : jhi(p);
  const int hi_t = D == 1 ? jhi(p) : ihi(p);
  const int lo = p.ng;
  const bool across = tr >= lo - 1 && tr <= hi_t + 1;
  auto a = [&](int k) { return D == 1 ? A(i + k, j) : A(i, j + k); };
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
  constexpr int d3a_hi = D == 1 ? 3 : 2;
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

  // ar defaults to a_int at the cell
  const T ar_lim = case1   ? a0 - rho * dafm
                   : case2 ? a0 - T(2) * (T(1) - rho) * dafp - rho * dafm
                           : ai0;
  const T ar_ne = fabs(dafm) >= T(2) * fabs(dafp) ? a0 - T(2) * dafp : ai0;
  ar = extrema ? (dolim ? ar_lim : ai0) : ar_ne;
  // al defaults to a_int one cell up (al_up)
  const T al_lim = case1   ? a0 + rho * dafp
                   : case3 ? a0 + T(2) * (T(1) - rho) * dafm + rho * dafp
                           : ai1;
  const T al_ne = fabs(dafp) >= T(2) * fabs(dafm) ? a0 + T(2) * dafm : ai1;
  al = extrema ? (dolim ? al_lim : ai1) : al_ne;
}

// the analytic conserved flux of a primitive state (flux_cons)
template <typename T, typename P>
__device__ __forceinline__ void flux_cons(const P& p, int idir, const T* q,
                                          T* F) {
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
#pragma unroll
  for (int n = 4; n < p.nvar; ++n) F[n] = rho * q[n] * un;
}

// the most threads a block of the fused kernel takes: 512 in float32 (at
// most 128 registers a thread), 256 in float64
template <typename T>
struct Fv4Launch {
  static constexpr int threads = 256;
};
template <>
struct Fv4Launch<float> {
  static constexpr int threads = 512;
};

// the launch plan of mol_kernel.plan: the output tile (tx rows along x, ty
// columns along y) and the block's threads; the halos of the boxes a block
// holds (the primitives of the averages, the centres and then the
// 4th-order averages, the flattening coefficients, and the centred sources
// and the cells whose face states are limited); where each array starts in
// the block's shared memory, in elements of T (xi -1 without flattening);
// the bytes it takes; and the grid of tiles
struct Fv4Plan {
  int tx, ty, threads;
  int hq, ha, hx, hs;
  int q, xi, sc, qix, qiy, r;
  int smem;    // bytes
  int bx, by;  // blocks along y (columns), along x (rows)
};

constexpr int FV4_PLAN_INTS = 16;

Fv4Plan load_fv4_plan(const int* t) {
  return Fv4Plan{t[0], t[1],  t[2],  t[3],  t[4],  t[5],  t[6],  t[7],
                 t[8], t[9],  t[10], t[11], t[12], t[13], t[14], t[15]};
}

// the boxes of a tile (the faces' by the cells below them)
struct Fv4Boxes {
  Box q, a, x, s;   // halos hq, ha, hx, hs
  Box ix, iy;       // the face states: x faces i in [i0, i0 + tx], j in
                    // [j0 - 1, j0 + ty]; y faces the transpose
  Box fx, fy;       // the fluxes the tile's divergence reads
};

__device__ __forceinline__ Fv4Boxes fv4_boxes(int i0, int j0,
                                              const Fv4Plan& t) {
  auto around = [&](int h) {
    return Box{i0 - h, j0 - h, t.tx + 2 * h, t.ty + 2 * h};
  };
  return Fv4Boxes{around(t.hq),
                  around(t.ha),
                  around(t.hx),
                  around(t.hs),
                  Box{i0, j0 - 1, t.tx + 1, t.ty + 2},
                  Box{i0 - 1, j0, t.tx + 2, t.ty + 1},
                  Box{i0, j0, t.tx + 1, t.ty},
                  Box{i0, j0, t.tx, t.ty + 1}};
}

// stage 4 along D: the limited 4th-order states of every cell of box s in
// the buf=1 window, blended toward q_avg by the cell's flattening
// coefficient (ST: NV planes of the right state at the cell's lower face,
// then NV of the left state at its upper face); then CGF on the primitive
// states of each face normal to D that the transverse Laplacians of stage 5
// read (x faces i in [ilo, ihi+1], j in [jlo-1, jhi+1]; y faces the
// transpose) into QI over box ix (iy)
template <typename T, int NV, int D>
__device__ __forceinline__ void fv4_faces(const FixedParams<NV>& p,
                                          const Fv4Boxes& b, const T* Q,
                                          const T* XI, const T* QA, T* ST,
                                          T* QI) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cs = b.s.cells();
  for (int k = tid; k < cs; k += nt) {
    const int i = b.s.i0 + k / b.s.w, j = b.s.j0 + k % b.s.w;
    if (!inwin(p, i, j, 1, 1, 1, 1)) continue;
    const T xi = flat_xi_of<T>(p, plane<T>(Q, b.q, IP), plane<T>(XI, b.x, 0),
                               plane<T>(XI, b.x, 1), i, j);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const BoxPlane<T> A = plane<T>(QA, b.a, n);
      T ar, al;
      fo_pair<T, D>(p, A, i, j, ar, al);
      const T a0 = A(i, j);
      ST[n * cs + k] = xi * ar + (T(1) - xi) * a0;
      ST[(NV + n) * cs + k] = xi * al + (T(1) - xi) * a0;
    }
  }
  __syncthreads();
  const Box& bi = D == 1 ? b.ix : b.iy;
  const int ci = bi.cells();
  for (int k = tid; k < ci; k += nt) {
    const int i = bi.i0 + k / bi.w, j = bi.j0 + k % bi.w;
    const bool face =
        D == 1 ? (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) - 1 &&
                  j <= jhi(p) + 1)
               : (j >= jlo(p) && j <= jhi(p) + 1 && i >= ilo(p) - 1 &&
                  i <= ihi(p) + 1);
    if (!face) continue;
    const int c = b.s.at(i, j), cl = D == 1 ? c - b.s.w : c - 1;
    T ql[NV], qr[NV], qi[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      ql[n] = ST[(NV + n) * cs + cl];
      qr[n] = ST[n * cs + c];
    }
    cgf_prim(p, D, ql, qr, qi);
#pragma unroll
    for (int n = 0; n < NV; ++n) QI[n * ci + k] = qi[n];
  }
  __syncthreads();
}

// stage 5 along D: per face that the divergence reads (x faces i in [ilo,
// ihi+1], j in [jlo, jhi]; y faces the transpose): face average -> face
// centre, F = F(q_fc) + lap_perp F(q_avg) / 24, plus the MC Eq. 35-36
// artificial viscosity, into FO over box fx (fy)
template <typename T, int NV, int D>
__device__ __forceinline__ void fv4_flux(const FixedParams<NV>& p,
                                         const Fv4Boxes& b,
                                         const T* __restrict__ U, const T* Q,
                                         const T* QI, T* FO) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Box& bi = D == 1 ? b.ix : b.iy;
  const Box& bf = D == 1 ? b.fx : b.fy;
  const int ci = bi.cells();
  const T c24 = T(1.0 / 24.0);
  // the transverse neighbours
  constexpr int ti = D == 1 ? 0 : 1, tj = D == 1 ? 1 : 0;
  const BoxPlane<T> u = plane<T>(Q, b.q, IU), v = plane<T>(Q, b.q, IV);
  for (int k = tid; k < bf.cells(); k += nt) {
    const int i = bf.i0 + k / bf.w, j = bf.j0 + k % bf.w;
    const bool face =
        D == 1 ? (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) &&
                  j <= jhi(p))
               : (j >= jlo(p) && j <= jhi(p) + 1 && i >= ilo(p) &&
                  i <= ihi(p));
    if (!face) continue;
    const int c0 = bi.at(i, j);
    const int cm = bi.at(i - ti, j - tj), cp = bi.at(i + ti, j + tj);
    T qm[NV], q0[NV], qp[NV], qfc[NV];
    T fm[NV], f0[NV], fp[NV], F[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      qm[n] = QI[n * ci + cm];
      q0[n] = QI[n * ci + c0];
      qp[n] = QI[n * ci + cp];
      qfc[n] = q0[n] - c24 * (qp[n] - 2 * q0[n] + qm[n]);
    }
    flux_cons(p, D, qfc, F);
    flux_cons(p, D, qm, fm);
    flux_cons(p, D, q0, f0);
    flux_cons(p, D, qp, fp);

    // the artificial viscosity from the average primitives q_bar
    T lam;
    if (D == 1)
      lam = (u(i, j) - u(i - 1, j)) / T(p.dx) +
            T(0.25) *
                (v(i, j + 1) - v(i, j - 1) + v(i - 1, j + 1) -
                 v(i - 1, j - 1)) /
                T(p.dy);
    else
      lam = (v(i, j) - v(i, j - 1)) / T(p.dy) +
            T(0.25) *
                (u(i + 1, j) - u(i - 1, j) + u(i + 1, j - 1) -
                 u(i - 1, j - 1)) /
                T(p.dx);
    const T dxl = T(p.dx) * lam;
    const T test = dxl * dxl / (T(p.beta_gamma) * Q[IP * b.q.cells() +
                                                    b.q.at(i, j)] /
                                Q[IRHO * b.q.cells() + b.q.at(i, j)]);
    T nu = T(p.dx) * lam * fmin(test, T(1));
    nu = lam >= T(0) ? T(0) : nu;
    const T anu = T(p.alpha) * nu;

#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const T du = D == 1 ? ldU(U, p, n, i, j) - ldU(U, p, n, i - 1, j)
                          : ldU(U, p, n, i, j) - ldU(U, p, n, i, j - 1);
      FO[n * bf.cells() + k] =
          F[n] + c24 * (fp[n] - 2 * f0[n] + fm[n]) + anu * du;
    }
  }
}

// One fv4 stage increment of the tile (blockIdx.y, blockIdx.x): the
// pipeline of the first design's six staged kernels, run out of shared
// memory and registers, each stage over the box the next one reads, with
// every window decided by the global index as before.  Nothing but k goes
// to device memory.
template <typename T, int NV, bool X>
__global__ void __launch_bounds__(Fv4Launch<T>::threads)
    k_fv4(const T* __restrict__ U, const T* __restrict__ G,
          const T* __restrict__ W, T* __restrict__ K,
          const FixedParams<NV> p, const Fv4Plan t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i0 = p.ng + blockIdx.y * t.tx, j0 = p.ng + blockIdx.x * t.ty;
  const Fv4Boxes b = fv4_boxes(i0, j0, t);
  const int cq = b.q.cells(), ca = b.a.cells(), cs = b.s.cells();
  T* Q = sm + t.q;      // NV planes over box q: the averages' primitives
  T* XI = sm + t.xi;    // xi_x, xi_y over box x
  T* SC = sm + t.sc;    // the centred sources of ymom, ener over box s
                        // (X: of xmom, ymom, ener)
  T* QIX = sm + t.qix;  // NV planes over box ix: the x faces' states
  T* QIY = sm + t.qiy;  // NV planes over box iy
  T* QA = sm + t.r;     // NV planes over box a: the centres' primitives,
                        // then the 4th-order averages
  T* ST = QA + NV * ca; // 2 NV planes over box s: the limited states;
  T* UB = ST;           // before them, NV planes over box q: the floored
                        // state
  T* FX = sm + t.r;     // after stage 4, over QA and ST: NV planes over
  T* FY = FX + NV * b.fx.cells();   // box fx, then NV over box fy
  const Lines<T> lines{G, p.qx, p.qy};
  auto inframe = [&](int i, int j) {
    return i >= 0 && i < p.qx && j >= 0 && j < p.qy;
  };

  // 1. the floored state over box q (UB, where the limited states go
  // later); then the averages' primitives Q over box q; over box a the
  // cell-centre state (the buf=ng-1 window converted, the outer ring
  // copied) with the fallback to the averages where it is unphysical, as
  // primitives; over box s the centred gravity sources of the centre
  // state before the fallback
  for (int k = tid; k < cq; k += nt) {
    const int i = b.q.i0 + k / b.q.w, j = b.q.j0 + k % b.q.w;
    if (!inframe(i, j)) continue;
#pragma unroll
    for (int n = 0; n < NV; ++n) UB[n * cq + k] = ldU(U, p, n, i, j);
  }
  __syncthreads();
  for (int k = tid; k < cq; k += nt) {
    const int i = b.q.i0 + k / b.q.w, j = b.q.j0 + k % b.q.w;
    if (!inframe(i, j)) continue;
    T ua[NV], uc[NV], q[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) ua[n] = UB[n * cq + k];
    cons_to_prim(p, ua, q);
#pragma unroll
    for (int n = 0; n < NV; ++n) Q[n * cq + k] = q[n];
    if (!b.a.has(i, j)) continue;
    const bool w = inwin(p, i, j, p.ng - 1, p.ng - 1, p.ng - 1, p.ng - 1);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      uc[n] = ua[n];
      if (w)
        uc[n] = ua[n] - T(p.dx2) * lap5<T>(p, plane<T>(UB, b.q, n), i, j) /
                            T(24);
    }
    if (b.s.has(i, j)) {
      if constexpr (X) {
        T Sx, Sy, SE;
        const T w = p.problem ? W[(size_t)i * p.qy + j] : T(0);
        ext_sources(p, uc, lines, i, w, Sx, Sy, SE);
        SC[b.s.at(i, j)] = Sx;
        SC[cs + b.s.at(i, j)] = Sy;
        SC[2 * cs + b.s.at(i, j)] = SE;
      } else {
        const T grav = T(p.grav);
        SC[b.s.at(i, j)] = uc[p.idens] * grav;
        SC[cs + b.s.at(i, j)] = uc[p.iymom] * grav;
      }
    }
    const T rhoe = uc[p.iener] - T(0.5) *
                                     (uc[p.ixmom] * uc[p.ixmom] +
                                      uc[p.iymom] * uc[p.iymom]) /
                                     uc[p.idens];
    if (uc[p.idens] < T(0) || rhoe < T(0)) {
#pragma unroll
      for (int n = 0; n < NV; ++n) uc[n] = ua[n];
    }
    cons_to_prim(p, uc, q);
#pragma unroll
    for (int n = 0; n < NV; ++n) QA[n * ca + b.a.at(i, j)] = q[n];
  }
  __syncthreads();

  // 2. the 1-D flattening coefficients over box x (1 outside buf=2); 3.
  // the 4th-order averages q_avg = q_cc + dx^2/24 lap(q_bar) over box a on
  // the buf=3 window, with the rho / p positivity fallback to q_cc, zero
  // outside it (in place of the centres)
  if (p.flatten) {
    const BoxPlane<T> P = plane<T>(Q, b.q, IP);
    for (int k = tid; k < b.x.cells(); k += nt) {
      const int i = b.x.i0 + k / b.x.w, j = b.x.j0 + k % b.x.w;
      if (!inframe(i, j)) continue;
      XI[k] = flat1d_of<T>(p, P, plane<T>(Q, b.q, IU), i, j, 1, 0);
      XI[b.x.cells() + k] =
          flat1d_of<T>(p, P, plane<T>(Q, b.q, IV), i, j, 0, 1);
    }
  }
  for (int k = tid; k < ca; k += nt) {
    const int i = b.a.i0 + k / b.a.w, j = b.a.j0 + k % b.a.w;
    if (!inframe(i, j)) continue;
    const bool w = inwin(p, i, j, 3, 3, 3, 3);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      T qa = T(0);
      if (w) {
        const T qc = QA[n * ca + k];
        qa = qc + T(p.dx2_24) * lap5<T>(p, plane<T>(Q, b.q, n), i, j);
        if (n == IRHO || n == IP) qa = qa > T(0) ? qa : qc;
      }
      QA[n * ca + k] = qa;
    }
  }
  __syncthreads();

  // 4. the limited face states and CGF, x faces then y faces
  fv4_faces<T, NV, 1>(p, b, Q, XI, QA, ST, QIX);
  fv4_faces<T, NV, 2>(p, b, Q, XI, QA, ST, QIY);

  // 5. the fluxes of the tile's faces (over QA and ST, which are done)
  fv4_flux<T, NV, 1>(p, b, U, Q, QIX, FX);
  fv4_flux<T, NV, 2>(p, b, U, Q, QIY, FY);
  __syncthreads();

  // 6. k = divergence + sources brought back to averages (S + (-dx^2)
  // lap(S) / 24) (+ sponge) on the tile's interior cells, and exactly zero
  // on the ghosts, which the tiles at the frame's edges write: this block
  // owns rows [r0, r1) x columns [c0, c1) of the frame
  const int r0 = blockIdx.y == 0 ? 0 : i0;
  const int r1 = blockIdx.y == gridDim.y - 1 ? p.qx : i0 + t.tx;
  const int c0 = blockIdx.x == 0 ? 0 : j0;
  const int c1 = blockIdx.x == gridDim.x - 1 ? p.qy : j0 + t.ty;
  const int ow = c1 - c0;
  const int cfx = b.fx.cells(), cfy = b.fy.cells();
  for (int k = tid; k < (r1 - r0) * ow; k += nt) {
    const int i = r0 + k / ow, j = c0 + k % ow;
    if (!inwin(p, i, j, 0, 0, 0, 0)) {
#pragma unroll
      for (int n = 0; n < NV; ++n) K[at(p, n, i, j)] = T(0);
      continue;
    }
    T kk[NV];
    const int x0 = b.fx.at(i, j), x1 = b.fx.at(i + 1, j);
    const int y0 = b.fy.at(i, j), y1 = b.fy.at(i, j + 1);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      kk[n] = (FX[n * cfx + x0] - FX[n * cfx + x1]) / T(p.dx) +
              (FY[n * cfy + y0] - FY[n * cfy + y1]) / T(p.dy);
    constexpr int ns = X ? 3 : 2;   // the source rows: [xmom,] ymom, ener
#pragma unroll
    for (int r = 0; r < ns; ++r) {
      const BoxPlane<T> S = plane<T>(SC, b.s, r);
      const T s_avg = S(i, j) + T(p.mdx2) * lap5<T>(p, S, i, j) / T(24);
      const int m = r + 3 - ns;
      const int n = m == 0 ? p.ixmom : (m == 1 ? p.iymom : p.iener);
      kk[n] = kk[n] + s_avg;
    }
    if (p.do_sponge) add_sponge(p, U, i, j, kk);
#pragma unroll
    for (int n = 0; n < NV; ++n) K[at(p, n, i, j)] = kk[n];
  }
}

// ---------------------------------------------------------------------------
// rk: PLM states, one Riemann pass, divergence; one fused launch
// ---------------------------------------------------------------------------

// the most threads a block of the fused rk kernel takes, and the blocks an
// SM holds: 512 in float32, two an SM (at most 64 registers a thread), 256
// in float64
template <typename T>
struct RkLaunch {
  static constexpr int threads = 256, blocks = 1;
};
template <>
struct RkLaunch<float> {
  static constexpr int threads = 512, blocks = 2;
};

// the launch plan of mol_kernel.rk_plan: the output tile (tx rows along x,
// ty columns along y) and the block's threads; the halos of the boxes of
// the primitives and of the flattening coefficients; where each array
// starts in the block's shared memory, in elements of T (xi -1 without
// flattening); the bytes it takes; and the grid of tiles
struct RkPlan {
  int tx, ty, threads;
  int hq, hx;
  int q, xi, s, fx, fy;
  int smem;    // bytes
  int bx, by;  // blocks along y (columns), along x (rows)
};

constexpr int RK_PLAN_INTS = 13;

RkPlan load_rk_plan(const int* t) {
  return RkPlan{t[0], t[1], t[2], t[3],  t[4],  t[5], t[6],
                t[7], t[8], t[9], t[10], t[11], t[12]};
}

// the boxes of a tile (the faces' by the cells above them)
struct RkBoxes {
  Box q, x;     // the primitives, the flattening coefficients: halos hq, hx
  Box sx, sy;   // the cells whose x (y) interface states the tile's x (y)
                // faces take: rows [i0 - 1, i0 + tx] x columns [j0, j0 +
                // ty); y the transpose
  Box fx, fy;   // the fluxes the tile's divergence reads
};

__device__ __forceinline__ RkBoxes rk_boxes(int i0, int j0, const RkPlan& t) {
  auto around = [&](int h) {
    return Box{i0 - h, j0 - h, t.tx + 2 * h, t.ty + 2 * h};
  };
  return RkBoxes{around(t.hq),
                 around(t.hx),
                 Box{i0 - 1, j0, t.tx + 2, t.ty},
                 Box{i0, j0 - 1, t.tx, t.ty + 2},
                 Box{i0, j0, t.tx + 1, t.ty},
                 Box{i0, j0, t.tx, t.ty + 1}};
}

// stage 3 along D: the MC-limited PLM states of every cell of box sx (sy)
// in the frame, q -+ dq/2 with dq the flattened slope along D, as conserved
// states into ST (NV planes of the right state at the cell's lower face,
// then NV of the left state at its upper face); zero outside the buf=2
// window.  Well-balanced (X, along y): the pressure's states are p -+ p0
// -+ dp/2, p0 = 0.5 dy rho grav, dp the MC slope of the deviations from
// the hydrostatic extrapolation, not flattened
template <typename T, int NV, int D, bool X>
__device__ __forceinline__ void rk_states(const FixedParams<NV>& p,
                                          const RkBoxes& b, const T* Q,
                                          const T* XI, T* ST) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Box& bs = D == 1 ? b.sx : b.sy;
  const int cs = bs.cells();
  constexpr int di = D == 1, dj = D == 2;
  for (int k = tid; k < cs; k += nt) {
    const int i = bs.i0 + k / bs.w, j = bs.j0 + k % bs.w;
    if (i >= p.qx || j >= p.qy) continue;
    T ul[NV], ur[NV];
    if (!inwin(p, i, j, 2, 2, 2, 2)) {
#pragma unroll
      for (int n = 0; n < NV; ++n) ul[n] = ur[n] = T(0);
    } else {
      const T xi = flat_xi_of<T>(p, plane<T>(Q, b.q, IP),
                                 plane<T>(XI, b.x, 0), plane<T>(XI, b.x, 1),
                                 i, j);
      T ql[NV], qr[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const BoxPlane<T> A = plane<T>(Q, b.q, n);
        const T q = A(i, j);
        const T dq = xi * slope_of<T>(p, A, i, j, di, dj);
        ql[n] = q + T(0.5) * dq;
        qr[n] = q - T(0.5) * dq;
      }
      if constexpr (X && D == 2) {
        if (p.well_balanced) {
          const BoxPlane<T> P_ = plane<T>(Q, b.q, IP);
          const BoxPlane<T> R = plane<T>(Q, b.q, IRHO);
          const T hdy = T(0.5 * p.dy), grav = T(p.grav);
          const T p0 = P_(i, j), r0 = R(i, j);
          const T p1u = P_(i, j + 1) - (p0 + hdy * (r0 + R(i, j + 1)) * grav);
          const T p1d = P_(i, j - 1) - (p0 - hdy * (r0 + R(i, j - 1)) * grav);
          const T dp = mc(T(0.5) * (p1u - p1d), p1u, -p1d);
          const T incr = hdy * r0 * grav;
          ql[IP] = p0 + incr + T(0.5) * dp;
          qr[IP] = p0 - incr - T(0.5) * dp;
        }
      }
      prim_to_cons(p, ql, ul);
      prim_to_cons(p, qr, ur);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      ST[n * cs + k] = ur[n];
      ST[(NV + n) * cs + k] = ul[n];
    }
  }
  __syncthreads();
}

// stage 4 along D: the Riemann flux of each face of box fx (fy) that the
// divergence reads (x faces i in [ilo, ihi+1], j in [jlo, jhi]; y faces the
// transpose) from the states of the cells on either side, plus the
// Colella-Woodward artificial viscosity from the primitives' vertex
// divergence and the floored state (not on the last face where it is the
// domain's edge; a seam's last face, edge flag 0, takes it from the halo),
// into FO; on a SphericalPolar grid (X) the spherical vertex divergence,
// and Ly across the y faces
template <typename T, int NV, int D, bool X>
__device__ __forceinline__ void rk_flux(const FixedParams<NV>& p,
                                        const RkBoxes& b,
                                        const T* __restrict__ U, const T* Q,
                                        const T* ST, T* FO,
                                        const Lines<T>& g) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Box& bs = D == 1 ? b.sx : b.sy;
  const Box& bf = D == 1 ? b.fx : b.fy;
  const int cs = bs.cells(), cf = bf.cells();
  const BoxPlane<T> u = plane<T>(Q, b.q, IU), v = plane<T>(Q, b.q, IV);
  for (int k = tid; k < cf; k += nt) {
    const int i = bf.i0 + k / bf.w, j = bf.j0 + k % bf.w;
    const bool face =
        D == 1 ? (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) &&
                  j <= jhi(p))
               : (j >= jlo(p) && j <= jhi(p) + 1 && i >= ilo(p) &&
                  i <= ihi(p));
    if (!face) continue;
    const int cr = bs.at(i, j), cl = D == 1 ? cr - bs.w : cr - 1;
    T ul[NV], ur[NV], f[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      ul[n] = ST[(NV + n) * cs + cl];
      ur[n] = ST[n * cs + cr];
    }
    riemann(p, D, ul, ur, i, j, f);
    if (D == 1 ? i <= ihi(p) || !p.edge_xr : j <= jhi(p) || !p.edge_yr) {
      auto vdiv = [&](int a, int c) -> T {
        if constexpr (X) {
          if (p.spherical) return sph_vertex_div<T>(p, u, v, g, a, c);
        }
        return vertex_div_of<T>(p, u, v, a, c);
      };
      const T divU = D == 1 ? T(0.5) * (vdiv(i, j) + vdiv(i, j + 1))
                            : T(0.5) * (vdiv(i, j) + vdiv(i + 1, j));
      T L = T(D == 1 ? p.dx : p.dy);
      if constexpr (X && D == 2) {
        if (p.spherical) L = g.Ly(i);
      }
      const T av = T(p.cvisc) * fmax(-divU * L, T(0));
#pragma unroll
      for (int n = 0; n < NV; ++n)
        f[n] = f[n] + av * (D == 1 ? ldU(U, p, n, i - 1, j) -
                                         ldU(U, p, n, i, j)
                                   : ldU(U, p, n, i, j - 1) -
                                         ldU(U, p, n, i, j));
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) FO[n * cf + k] = f[n];
  }
  __syncthreads();
}

// One rk stage increment of the tile (blockIdx.y, blockIdx.x): the
// pipeline of the first design's staged kernels, run out of shared memory
// and registers, each stage over the box the next one reads, with every
// window decided by the global index as before.  Nothing but k goes to
// device memory.
template <typename T, int NV, bool X>
__global__ void __launch_bounds__(RkLaunch<T>::threads, RkLaunch<T>::blocks)
    k_rk(const T* __restrict__ U, const T* __restrict__ G,
         const T* __restrict__ W, T* __restrict__ K,
         const FixedParams<NV> p, const RkPlan t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i0 = p.ng + blockIdx.y * t.tx, j0 = p.ng + blockIdx.x * t.ty;
  const RkBoxes b = rk_boxes(i0, j0, t);
  T* Q = sm + t.q;     // NV planes over box q: the floored state's
                       // primitives
  T* XI = sm + t.xi;   // xi_x, xi_y over box x
  T* ST = sm + t.s;    // 2 NV planes over box sx, then over box sy: the
                       // interface states
  T* FX = sm + t.fx;   // NV planes over box fx
  T* FY = sm + t.fy;   // NV planes over box fy
  const Lines<T> lines{G, p.qx, p.qy};
  auto inframe = [&](int i, int j) {
    return i >= 0 && i < p.qx && j >= 0 && j < p.qy;
  };

  // 1. the primitives of the floored state over box q
  const int cq = b.q.cells();
  for (int k = tid; k < cq; k += nt) {
    const int i = b.q.i0 + k / b.q.w, j = b.q.j0 + k % b.q.w;
    if (!inframe(i, j)) continue;
    T u[NV], q[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) u[n] = ldU(U, p, n, i, j);
    cons_to_prim(p, u, q);
#pragma unroll
    for (int n = 0; n < NV; ++n) Q[n * cq + k] = q[n];
  }
  __syncthreads();

  // 2. the 1-D flattening coefficients over box x (1 outside buf=2)
  if (p.flatten) {
    const BoxPlane<T> P = plane<T>(Q, b.q, IP);
    const int cx = b.x.cells();
    for (int k = tid; k < cx; k += nt) {
      const int i = b.x.i0 + k / b.x.w, j = b.x.j0 + k % b.x.w;
      if (!inframe(i, j)) continue;
      XI[k] = flat1d_of<T>(p, P, plane<T>(Q, b.q, IU), i, j, 1, 0);
      XI[cx + k] = flat1d_of<T>(p, P, plane<T>(Q, b.q, IV), i, j, 0, 1);
    }
    __syncthreads();
  }

  // 3-4. the states and fluxes of the x faces, then of the y faces (their
  // states over the x faces')
  rk_states<T, NV, 1, X>(p, b, Q, XI, ST);
  rk_flux<T, NV, 1, X>(p, b, U, Q, ST, FX, lines);
  rk_states<T, NV, 2, X>(p, b, Q, XI, ST);
  rk_flux<T, NV, 2, X>(p, b, U, Q, ST, FY, lines);

  // 5. k = divergence + gravity sources (+ sponge) on the tile's interior
  // cells, and exactly zero on the ghosts, which the tiles at the frame's
  // edges write: this block owns rows [r0, r1) x columns [c0, c1)
  const int r0 = blockIdx.y == 0 ? 0 : i0;
  const int r1 = blockIdx.y == gridDim.y - 1 ? p.qx : i0 + t.tx;
  const int c0 = blockIdx.x == 0 ? 0 : j0;
  const int c1 = blockIdx.x == gridDim.x - 1 ? p.qy : j0 + t.ty;
  const int ow = c1 - c0;
  const int cfx = b.fx.cells(), cfy = b.fy.cells();
  for (int k = tid; k < (r1 - r0) * ow; k += nt) {
    const int i = r0 + k / ow, j = c0 + k % ow;
    if (!inwin(p, i, j, 0, 0, 0, 0)) {
#pragma unroll
      for (int n = 0; n < NV; ++n) K[at(p, n, i, j)] = T(0);
      continue;
    }
    T kk[NV];
    const int x0 = b.fx.at(i, j), x1 = b.fx.at(i + 1, j);
    const int y0 = b.fy.at(i, j), y1 = b.fy.at(i, j + 1);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      kk[n] = (FX[n * cfx + x0] - FX[n * cfx + x1]) / T(p.dx) +
              (FY[n * cfy + y0] - FY[n * cfy + y1]) / T(p.dy);
    if constexpr (X) {
      T u[NV], Sx, Sy, SE;
#pragma unroll
      for (int n = 0; n < NV; ++n) u[n] = ldU(U, p, n, i, j);
      const T w = p.problem ? W[(size_t)i * p.qy + j] : T(0);
      ext_sources(p, u, lines, i, w, Sx, Sy, SE);
      kk[p.ixmom] = kk[p.ixmom] + Sx;
      kk[p.iymom] = kk[p.iymom] + Sy;
      kk[p.iener] = kk[p.iener] + SE;
    } else {
      const T grav = T(p.grav);
      kk[p.iymom] = kk[p.iymom] + ldU(U, p, p.idens, i, j) * grav;
      kk[p.iener] = kk[p.iener] + ldU(U, p, p.iymom, i, j) * grav;
    }
    if (p.do_sponge) add_sponge(p, U, i, j, kk);
#pragma unroll
    for (int n = 0; n < NV; ++n) K[at(p, n, i, j)] = kk[n];
  }
}

// ---------------------------------------------------------------------------
// entries
// ---------------------------------------------------------------------------

int check_params(const Params& p) {
  if (p.nvar < 4 || p.nvar > MAXVAR || p.ng != 4 || p.nx < 1 || p.ny < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// the extended instantiation's configurations, and the buffers they read
bool extended(const Params& p) {
  return p.spherical || p.problem || p.well_balanced;
}

template <typename T>
bool buffers_ok(const Params& p, const T* G, const T* W) {
  return (!p.spherical || G != nullptr) && (!p.problem || W != nullptr);
}

// the rk plan (mol_kernel.rk_plan) against the kernel: its block, halos
// that hold the stages' reads (mol_kernel.RK_HALO), a grid whose tiles
// cover the interior once, and arrays that lie one after another inside
// its shared memory
template <typename T>
bool rk_plan_ok(const Params& p, const RkPlan& t) {
  if (t.threads < 32 || t.threads > RkLaunch<T>::threads ||
      t.threads % 32 || t.tx < 1 || t.ty < 1)
    return false;
  if (t.hx < 2 || t.hq < t.hx + 2) return false;
  if (t.bx < 1 || t.by < 1 || (t.bx - 1) * t.ty >= p.ny ||
      t.bx * t.ty < p.ny || (t.by - 1) * t.tx >= p.nx || t.by * t.tx < p.nx)
    return false;
  auto box = [&](int h) { return (long)(t.tx + 2 * h) * (t.ty + 2 * h); };
  const long nv = p.nvar;
  const long sx = (long)(t.tx + 2) * t.ty, sy = (long)t.tx * (t.ty + 2);
  const struct {
    int off;
    long size;
  } arrays[] = {{t.q, nv * box(t.hq)},
                {t.xi, p.flatten ? 2 * box(t.hx) : 0},
                {t.s, 2 * nv * (sx > sy ? sx : sy)},
                {t.fx, nv * (t.tx + 1) * (long)t.ty},
                {t.fy, nv * t.tx * (long)(t.ty + 1)}};
  long end = 0;
  for (const auto& a : arrays) {
    if (a.size == 0) continue;
    if (a.off < end) return false;
    end = a.off + a.size;
  }
  return end * (long)sizeof(T) <= (long)t.smem;
}

// one launch of the NV-variable rk kernel with the plan's tile and shared
// memory (the opt-in above 48 KB is set once per kernel and size)
template <typename T, int NV, bool X>
int launch_rk(const T* U, const T* G, const T* W, T* K, const Params& base,
              const RkPlan& t, cudaStream_t st) {
  static int opted = 0;
  auto kernel = k_rk<T, NV, X>;
  if (t.smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        t.smem);
    if (e != cudaSuccess) return (int)e;
    opted = t.smem;
  }
  FixedParams<NV> p;
  static_cast<Params&>(p) = base;
  kernel<<<dim3(t.bx, t.by), t.threads, t.smem, st>>>(U, G, W, K, p, t);
  return (int)cudaGetLastError();
}

template <typename T, bool X>
int rk_by_nvar(const T* U, const T* G, const T* W, T* K, const Params& p,
               const RkPlan& t, cudaStream_t st) {
  switch (p.nvar) {
    case 4: return launch_rk<T, 4, X>(U, G, W, K, p, t, st);
    case 5: return launch_rk<T, 5, X>(U, G, W, K, p, t, st);
    case 6: return launch_rk<T, 6, X>(U, G, W, K, p, t, st);
    case 7: return launch_rk<T, 7, X>(U, G, W, K, p, t, st);
    case 8: return launch_rk<T, 8, X>(U, G, W, K, p, t, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the rk entries' parameter block: the shared layout, then the four
// domain-edge flags of the artificial viscosity (MOLSubstep's ints 21..24)
inline Params rk_params(const int* ip, const double* dp) {
  Params p = load_params(ip, dp, true);
  p.edge_xl = ip[21];
  p.edge_xr = ip[22];
  p.edge_yl = ip[23];
  p.edge_yr = ip[24];
  return p;
}

template <typename T>
int run_rk(const T* U, const T* G, const T* W, T* K, const int* ip,
           const double* dp, const int* tp, cudaStream_t st) {
  static_assert(MAXVAR == 8, "run_rk instantiates 4..8 variables");
  const Params p = rk_params(ip, dp);
  if (int e = check_params(p)) return e;
  if (p.idens != 0 || p.iener != 1 || p.ixmom != 2 || p.iymom != 3)
    return (int)cudaErrorInvalidValue;
  const RkPlan t = load_rk_plan(tp);
  if (!rk_plan_ok<T>(p, t) || !buffers_ok(p, G, W) ||
      (p.well_balanced && p.limiter != 1))
    return (int)cudaErrorInvalidValue;
  return extended(p) ? rk_by_nvar<T, true>(U, G, W, K, p, t, st)
                     : rk_by_nvar<T, false>(U, G, W, K, p, t, st);
}

// the plan (mol_kernel.plan) against the kernel: its block, the halos the
// stages read (mol_kernel.HALO), a grid whose tiles cover the interior
// once, and arrays that lie one after another inside its shared memory
template <typename T>
bool fv4_plan_ok(const Params& p, const Fv4Plan& t) {
  const long nsrc = extended(p) ? 3 : 2;   // the centred sources' planes
  if (t.threads < 32 || t.threads > Fv4Launch<T>::threads ||
      t.threads % 32 || t.tx < 1 || t.ty < 1)
    return false;
  if (t.hs < 1 || t.hx < t.hs + 1 || t.ha < t.hs + 3 || t.hq < t.ha + 1 ||
      t.hq < t.hx + 2)
    return false;
  if (t.bx < 1 || t.by < 1 || (t.bx - 1) * t.ty >= p.ny ||
      t.bx * t.ty < p.ny || (t.by - 1) * t.tx >= p.nx || t.by * t.tx < p.nx)
    return false;
  auto box = [&](int h) { return (long)(t.tx + 2 * h) * (t.ty + 2 * h); };
  const long nv = p.nvar;
  const long after = 2 * nv * box(t.hs) > nv * box(t.hq)
                         ? 2 * nv * box(t.hs)
                         : nv * box(t.hq);
  const long states = nv * box(t.ha) + after;
  const long fluxes = nv * ((long)(t.tx + 1) * t.ty + (long)t.tx * (t.ty + 1));
  const struct {
    int off;
    long size;
  } arrays[] = {{t.q, nv * box(t.hq)},
                {t.xi, p.flatten ? 2 * box(t.hx) : 0},
                {t.sc, nsrc * box(t.hs)},
                {t.qix, nv * (t.tx + 1) * (long)(t.ty + 2)},
                {t.qiy, nv * (t.tx + 2) * (long)(t.ty + 1)},
                {t.r, states > fluxes ? states : fluxes}};
  long end = 0;
  for (const auto& a : arrays) {
    if (a.size == 0) continue;
    if (a.off < end) return false;
    end = a.off + a.size;
  }
  return end * (long)sizeof(T) <= (long)t.smem;
}

// one launch of the NV-variable kernel with the plan's tile and shared
// memory (the opt-in above 48 KB is set once per kernel and size)
template <typename T, int NV, bool X>
int launch_fv4(const T* U, const T* G, const T* W, T* K, const Params& base,
               const Fv4Plan& t, cudaStream_t st) {
  static int opted = 0;
  auto kernel = k_fv4<T, NV, X>;
  if (t.smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        t.smem);
    if (e != cudaSuccess) return (int)e;
    opted = t.smem;
  }
  FixedParams<NV> p;
  static_cast<Params&>(p) = base;
  kernel<<<dim3(t.bx, t.by), t.threads, t.smem, st>>>(U, G, W, K, p, t);
  return (int)cudaGetLastError();
}

template <typename T, bool X>
int fv4_by_nvar(const T* U, const T* G, const T* W, T* K, const Params& p,
                const Fv4Plan& t, cudaStream_t st) {
  switch (p.nvar) {
    case 4: return launch_fv4<T, 4, X>(U, G, W, K, p, t, st);
    case 5: return launch_fv4<T, 5, X>(U, G, W, K, p, t, st);
    case 6: return launch_fv4<T, 6, X>(U, G, W, K, p, t, st);
    case 7: return launch_fv4<T, 7, X>(U, G, W, K, p, t, st);
    case 8: return launch_fv4<T, 8, X>(U, G, W, K, p, t, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run_fv4(const T* U, const T* G, const T* W, T* K, const int* ip,
            const double* dp, const int* tp, cudaStream_t st) {
  static_assert(MAXVAR == 8, "run_fv4 instantiates 4..8 variables");
  const Params p = load_params(ip, dp, true);
  if (int e = check_params(p)) return e;
  if (p.idens != 0 || p.iener != 1 || p.ixmom != 2 || p.iymom != 3)
    return (int)cudaErrorInvalidValue;
  const Fv4Plan t = load_fv4_plan(tp);
  // the fv4 pipeline has no well-balanced reconstruction (the plain
  // version reads no such parameter)
  if (!fv4_plan_ok<T>(p, t) || !buffers_ok(p, G, W) || p.well_balanced)
    return (int)cudaErrorInvalidValue;
  return extended(p) ? fv4_by_nvar<T, true>(U, G, W, K, p, t, st)
                     : fv4_by_nvar<T, false>(U, G, W, K, p, t, st);
}

}  // namespace

// the lengths of the plan arrays the rk and fv4 entries take
// (mol_kernel.rk_plan, mol_kernel.plan)
extern "C" int mol_rk_plan_ints() { return RK_PLAN_INTS; }
extern "C" int mol_fv4_plan_ints() { return FV4_PLAN_INTS; }

// U, the spherical lines G and the weight plane W (null when the
// configuration has none), k, the parameters, the plan and the stream
extern "C" int mol_rk_substep_f32(const float* U, const float* G,
                                  const float* W, float* K, const int* ip,
                                  const double* dp, const int* plan,
                                  void* stream) {
  return run_rk<float>(U, G, W, K, ip, dp, plan, (cudaStream_t)stream);
}

extern "C" int mol_rk_substep_f64(const double* U, const double* G,
                                  const double* W, double* K, const int* ip,
                                  const double* dp, const int* plan,
                                  void* stream) {
  return run_rk<double>(U, G, W, K, ip, dp, plan, (cudaStream_t)stream);
}

extern "C" int mol_fv4_substep_f32(const float* U, const float* G,
                                   const float* W, float* K, const int* ip,
                                   const double* dp, const int* plan,
                                   void* stream) {
  return run_fv4<float>(U, G, W, K, ip, dp, plan, (cudaStream_t)stream);
}

extern "C" int mol_fv4_substep_f64(const double* U, const double* G,
                                   const double* W, double* K, const int* ip,
                                   const double* dp, const int* plan,
                                   void* stream) {
  return run_fv4<double>(U, G, W, K, ip, dp, plan, (cudaStream_t)stream);
}
