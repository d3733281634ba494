// ctu_step.cu -- one compressible CTU step on Hopper, Cartesian or
// spherical geometry, for one state or a batch of independent states, in
// one kernel launch.
//
// Replaces the fused Pallas TPU kernels of
// pyro2_tpu/solvers/compressible/pallas_step.py, which share one body,
// _local_step_fn:
//   * make_pallas_ctu_step_padded_general (the live Simulation's step):
//     ctu_step_{f32,f64} -- density floor, interface states (prim,
//     flattening, limited slopes, characteristic tracing), half-dt sources,
//     first Riemann pair + transverse corrections, final Riemann pair,
//     artificial viscosity, conservative update, (spherical pressure
//     gradients), predictor-corrector sources (with a problem's energy
//     source, which the TPU kernel refuses) and sponge;
//   * make_pallas_ctu_step_padded (periodic frame), make_pallas_ctu_step
//     (pad in, pad out) and make_pallas_ctu_ensemble_step (a batch):
//     ctu_step_batched_{f32,f64}, the same pipeline with the floor, the
//     sources, the sponge and the walls forced off, as _local_step_fn's
//     defaults force them off there; member m of the batch is blockIdx.z;
//   * make_pallas_ctu_step_padded(..., stages=1..3), the pipeline cut short
//     after the interface states (1), the transverse corrections (2) or
//     the final Riemann pair (3), whose output sums the stage's live
//     intermediates (bench.py differences these prefixes to split the
//     step's time by stage): ctu_stage_batched_{f32,f64}, k_ctu's STAGES
//     argument, four variables (see "Stage prefixes" below).
// HLLC, HLLC_lm and CGF (spherical geometry: CGF only); limiter 0/1/2;
// flattening on or off; solid walls on any edge; passive scalars (nvar > 4,
// up to MAXVAR).
//
// Layout: the plain (nvar, nx + 2 ng, ny + 2 ng) state stack, y contiguous,
// members one after another.  Windows are compared against the global
// index (the floor on the interior, the flattening and the traced states on
// the buf=2 window, the half-dt sources and the first pair on buf=1, solid
// walls at ilo / ihi+1 and jlo / jhi+1), which reproduces the windowed
// semantics of the plain PyTorch step exactly.  Any nx, ny works.
//
// The frame may be one block of a sharded run (parallel/sharded.py), its
// ghosts filled by the halo exchange.  Its solid-wall flags are then 0 on
// the seams, and the single-state entries take four domain-edge flags
// (Params::edge_*, runtime ints, CTUStep's ints 20..23): where the high
// edge is a seam (flag 0) the artificial viscosity also acts on face
// ihi+1 / jhi+1, from the halo, as it does on that face of the serial
// grid.  With every flag 1 (a serial grid, and the batched entries) the
// step is unchanged.
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
// too.  The geometry is a template argument (SPH), so the Cartesian kernel
// compiles without any of these terms.
//
// What bounds it on the H100: the step is arithmetic, ~1.1k floating-point
// operations per zone (ctu_kernel.FLOPS_PER_ZONE; many of them divides,
// square roots and pows) against 2 nvar values read and written per zone,
// so its bound is the fp32 rate.  The design keeps everything between the
// state's read and its write on the chip: each block owns one output tile
// (ctu_kernel.plan picks its shape per dtype, lays out the block's shared
// memory and sizes the grid), loads the tile with its 4-cell halo of the
// state once, converting it to primitives (and keeping the floored state,
// the S stack, a problem source's weight plane and the geometry planes of
// the tile and its 1-cell halo), and runs the pipeline out of shared memory
// and registers:
//   1. floor and primitives (halo 4; the floored state, S, the weight and
//      the geometry planes, halo 1);
//   2. the 1-D flattening coefficients (halo 2);
//   3. the traced interface states of each cell with the half-dt sources
//      (halo 1: the four faces of every cell the fluxes below read);
//   4. the first Riemann pair (the faces of the halo-1 cells);
//   5. the transverse corrections, the final pair and the artificial
//      viscosity on the tile's faces (written over the states they used);
//   6. the update with the predictor-corrector sources and the sponge, and
//      the input's ghosts carried through by the tiles at the frame's edges.
// __syncthreads() separates the phases.  A float32 tile is 30 x 14 cells,
// so its traced cells are 32 x 16, one for each of the block's 512
// threads, and two blocks share an SM (Launch: at most 64 registers a
// thread); float64 takes 14 x 14 tiles on 256 threads.  Neighbouring blocks
// recompute the halos (the traced cells are 1.22x the tile's), which the
// arithmetic bound affords.  The variable count is a template argument
// (4..MAXVAR) and the conserved indices are fixed (FixedParams), so the
// per-variable arrays of the tracing and the Riemann solvers are indexed by
// constants and stay in registers.  Nothing is allocated here and there is
// no scratch in device memory.
//
// Problem sources.  A problem's source terms reach the step as the energy
// rate rho e_rate w(x, y) (the heating, convection and plume problems; the
// wrapper refuses any other form): the half-dt interface sources read it in
// S, which the wrapper fills with it, and the predictor-corrector adds
// (rho e_rate) w to S_old's and S_new's energy rows, with rho of U^n and of
// U^{n+1}, from the weight plane W (one plane of the state's dtype, made
// once on the device) and e_rate.
//
// Arithmetic: each cell's operations are the plain step's, in its order;
// only where the intermediates live changed.  The entry points return the
// launch's cudaGetLastError().
//
// The device-dt entries ctu_step_dev_{f32,f64} take dt as a pointer to one
// value of the state's dtype in device memory, which the kernel reads into
// its parameter block before anything else (DEVDT), so a launch reads no
// value from the host and can be captured into a CUDA graph whose replays
// each take the dt the graph computed (driver_loop.py).  For the same dt
// they give the host-dt entries' bits: the kernel converts the value to
// double, as the wrapper's float(dt) does, and the arithmetic is the same.
// They take nvar 4 (Cartesian or spherical), the compressible solver's
// state; the host-dt entries keep their own instantiations (DEVDT
// false).
//
// Stage prefixes (STAGES 1..3; 4 is the whole step, which the if-constexpr
// exits leave as it was).  Each emits, on the tile's interior cells, the sum
// _local_step_fn returns, in its order, and copies the input elsewhere over
// phase 6's ownership, so the output frame has no unwritten cell:
//   1. after phase 3: ((U_xl + U_xr) + U_yl) + U_yr of the traced states,
//      U_xl of face i being the high-x state of cell i - 1;
//   2. inside phase 5, before either Riemann solve: the same sum of the
//      transversely corrected states (phase 4, the first pair, runs);
//   3. inside phase 5: F_x + F_y, the final pair's fluxes before the
//      artificial viscosity.
// The x face's part stays in registers until the cell's y face, in the same
// iteration, completes the sum, which goes over the y face's right state
// (read by no other face).  Phase 4's vertex divergence and the floored
// state, which only the viscosity and the update read, are not formed.
// Plan's shared-memory layout is the whole step's.
//
// Build (see ctu_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libctu_step.so ctu_step.cu
// -fmad=false keeps each multiply and add rounded on its own, as the
// plain PyTorch step rounds them, so the two agree to the last bits that
// the order of operations allows.

#include "euler_common.cuh"

namespace {

// the block of each kernel: float32 blocks of 512 threads, two Cartesian
// ones to an SM (at most 64 registers a thread) and one spherical one;
// float64 blocks of 256, one to an SM (ctu_kernel.THREADS, with tiles that
// give each thread one traced cell)
template <typename T, bool SPH>
struct Launch {
  static constexpr int threads = 256, blocks = 1;
};
template <>
struct Launch<float, false> {
  static constexpr int threads = 512, blocks = 2;
};
template <>
struct Launch<float, true> {
  static constexpr int threads = 512, blocks = 1;
};

// the launch plan of ctu_kernel.plan: the output tile (tx rows along x, ty
// columns along y) and the block's threads; the halos of the boxes a block
// holds (primitives, flattening coefficients, traced cells); where each
// array of the box starts in the block's shared memory, in elements of T
// (-1: not held); and the grid of tiles
struct Plan {
  int tx, ty, threads;
  int hq, hx, ht;
  int q, xi, st, f1, u, dv, s, g, p1, p2;
  int smem;    // bytes
  int bx, by;  // blocks along y (columns), along x (rows)
};

constexpr int PLAN_INTS = 19;

Plan load_plan(const int* t) {
  return Plan{t[0],  t[1],  t[2],  t[3],  t[4],  t[5],  t[6],
              t[7],  t[8],  t[9],  t[10], t[11], t[12], t[13],
              t[14], t[15], t[16], t[17], t[18]};
}

__device__ __forceinline__ Box around(int i0, int j0, const Plan& t, int h) {
  return Box{i0 - h, j0 - h, t.tx + 2 * h, t.ty + 2 * h};
}

// the spherical geometry (see the header): the planes Ax, Ay, V, dlogAy of
// the traced box in shared memory, the lines from the buffer in device
// memory
template <typename T>
struct Geom {
  const T* pl;
  Box b;
  const T* g;
  int qx, qy;
  __device__ T pln(int k, int i, int j) const {
    return pl[k * b.cells() + b.at(i, j)];
  }
  __device__ T Ax(int i, int j) const { return pln(0, i, j); }
  __device__ T Ay(int i, int j) const { return pln(1, i, j); }
  __device__ T V(int i, int j) const { return pln(2, i, j); }
  __device__ T dlogAy(int i, int j) const { return pln(3, i, j); }
  __device__ T row(int k, int i) const {
    return g[4 * (size_t)qx * qy + k * qx + i];
  }
  __device__ T Ly(int i) const { return row(0, i); }
  __device__ T dlogAx(int i) const { return row(1, i); }
  __device__ T r(int i) const { return row(2, i); }
  __device__ T rc(int i) const { return row(3, i); }
  __device__ T rl(int i) const { return row(4, i); }
  __device__ T lane(int k, int j) const {
    return g[4 * (size_t)qx * qy + 5 * (size_t)qx + k * qy + j];
  }
  __device__ T sinc(int j) const { return lane(0, j); }
  __device__ T sint(int j) const { return lane(1, j); }
  __device__ T sinb(int j) const { return lane(2, j); }
};

// trace cell-centred primitives q (slopes dq) to its two faces along D (1:
// x, 2: y).  dtdx and dtdx4 are dt / L and dt / (4 L) for the cell's width
// L; dloga is the spherical d(log A) of the cell (unused in Cartesian
// geometry)
template <typename T, bool SPH, int D, typename P>
__device__ __forceinline__ void trace(const P& p, const T* q, const T* dq,
                                      T dtdx, T dtdx4, T dloga, T* ql,
                                      T* qr) {
  constexpr int iun = D == 1 ? IU : IV;
  constexpr int iut = D == 1 ? IV : IU;

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
#pragma unroll
  for (int n = 4; n < p.nvar; ++n) {
    cl[n] = bl(un, dq[n]);
    cr[n] = br(un, dq[n]);
  }
#pragma unroll
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

// the traced states of cell (a, b) on its two faces along D: lo on the low
// face (the right state of face (a, b)), hi on the high face (the left
// state of face (a + 1, b) or (a, b + 1)), both conserved
template <typename T, bool SPH, int D, typename P, typename QV>
__device__ __forceinline__ void trace_dir(const P& p, const QV& qv,
                                          const Geom<T>& g, const T* q, T xi,
                                          int a, int b, T* lo, T* hi) {
  constexpr int di = D == 1, dj = D == 2;
  T dq[MAXVAR], ql[MAXVAR], qr[MAXVAR];
#pragma unroll
  for (int n = 0; n < p.nvar; ++n)
    dq[n] = xi * slope_of<T>(p, qv(n), a, b, di, dj);
  T dtdx, dtdx4, dloga = T(0);
  if constexpr (SPH) {
    // per-cell widths, as the plain step's dt / L: (1 / L) dt
    dtdx = (T(1) / (D == 1 ? T(p.dx) : g.Ly(a))) * T(p.dt);
    dtdx4 = T(0.25) * dtdx;
    dloga = D == 1 ? g.dlogAx(a) : g.dlogAy(a, b);
  } else {
    const double w = D == 1 ? p.dx : p.dy;
    dtdx = T(p.dt / w);
    dtdx4 = T(0.25 * (p.dt / w));
  }
  trace<T, SPH, D>(p, q, dq, dtdx, dtdx4, dloga, ql, qr);
  prim_to_cons(p, ql, hi);
  prim_to_cons(p, qr, lo);
}

// add 0.5 dt of the sources S (xmom, ymom, ener) of the traced cell to a
// state whose face (i, j) lies on the buf=1 window
template <typename T, typename P>
__device__ __forceinline__ void half_sources(const P& p, T* v, int i, int j,
                                             T s1, T s2, T s3) {
  if (!inwin(p, i, j, 1, 1, 1, 1)) return;
  const T hdt = T(0.5 * p.dt);
  v[p.ixmom] = v[p.ixmom] + hdt * s1;
  v[p.iymom] = v[p.iymom] + hdt * s2;
  v[p.iener] = v[p.iener] + hdt * s3;
}

// the pressure of a conserved interface state (cons_to_prim's)
template <typename T, typename P>
__device__ __forceinline__ T pressure(const P& p, const T* u) {
  T q[MAXVAR];
  cons_to_prim(p, u, q);
  return q[IP];
}

template <typename T, bool SPH, typename P, typename A>
__device__ __forceinline__ T vdiv(const P& p, const A& u, const A& v,
                                  const Geom<T>& g, int i, int j) {
  if constexpr (SPH)
    return sph_vertex_div<T>(p, u, v, g, i, j);
  else
    return vertex_div_of<T>(p, u, v, i, j);
}

// the faces of the traced states (ST planes f * NV + n)
enum { LOX = 0, HIX = 1, LOY = 2, HIY = 3 };

// one CTU step of the tile (blockIdx.y, blockIdx.x) of member blockIdx.z;
// with DEVDT the step's dt is *dtp, in place of the parameter block's; with
// STAGES < 4 the step's prefix (see the header)
template <typename T, int NV, bool SPH, bool DEVDT, int STAGES = 4>
__global__ void __launch_bounds__(Launch<T, SPH>::threads,
                                  Launch<T, SPH>::blocks)
    k_ctu(const T* __restrict__ U, const T* __restrict__ S,
          const T* __restrict__ G, const T* __restrict__ W,
          T* __restrict__ out, const FixedParams<NV> pin, const Plan t,
          const T* __restrict__ dtp) {
  static_assert(STAGES == 4 || (STAGES >= 1 && !SPH && !DEVDT),
                "the prefixes are the Cartesian host-dt step's");
  FixedParams<NV> pdev = pin;
  if constexpr (DEVDT) pdev.dt = double(*dtp);
  const FixedParams<NV>& p = DEVDT ? pdev : pin;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  U += blockIdx.z * p.mstride;
  out += blockIdx.z * p.mstride;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i0 = p.ng + blockIdx.y * t.tx, j0 = p.ng + blockIdx.x * t.ty;
  const Box bq = around(i0, j0, t, t.hq);   // primitives
  const Box bx = around(i0, j0, t, t.hx);   // 1-D flattening coefficients
  const Box bt = around(i0, j0, t, t.ht);   // traced cells, their faces
  const int ct = bt.cells();
  T* Q = sm + t.q;     // NV planes over bq
  T* XI = sm + t.xi;   // xi_x, xi_y over bx
  T* ST = sm + t.st;   // 4 NV planes over bt: each cell's states by face
  T* F1 = sm + t.f1;   // 2 NV planes over bt: the first pair, x then y
  T* UB = sm + t.u;    // NV planes over bt: the floored state
  T* DV = sm + t.dv;   // over bt: the velocity's vertex divergence
  T* SS = sm + t.s;    // S's xmom, ymom, ener over bt (with sources),
                       // then the weight plane (with a problem source)
  T* P1 = sm + t.p1;   // spherical: the first pair's interface pressures
  T* P2 = sm + t.p2;   // spherical: the final pair's
  const Geom<T> g{sm + t.g, bt, G, p.qx, p.qy};
  auto qv = [&](int n) { return plane<T>(Q, bq, n); };
  auto st = [&](int f, int n, int k) -> T& {
    return ST[(f * NV + n) * ct + k];
  };
  auto f1 = [&](int d, int n, int k) -> T& {
    return F1[(d * NV + n) * ct + k];
  };
  auto ub = [&](int n, int i, int j) { return UB[n * ct + bt.at(i, j)]; };
  // a prefix's output: sum(n, c) on each interior cell this block owns (c
  // its place in bt), the input elsewhere; phase 6's ownership
  auto emit = [&](auto sum) {
    const int r0 = blockIdx.y == 0 ? 0 : i0;
    const int r1 = blockIdx.y == gridDim.y - 1 ? p.qx : i0 + t.tx;
    const int c0 = blockIdx.x == 0 ? 0 : j0;
    const int c1 = blockIdx.x == gridDim.x - 1 ? p.qy : j0 + t.ty;
    const int ow = c1 - c0;
    for (int k = tid; k < (r1 - r0) * ow; k += nt) {
      const int i = r0 + k / ow, j = c0 + k % ow;
      if (!inwin(p, i, j, 0, 0, 0, 0)) {
#pragma unroll
        for (int n = 0; n < NV; ++n) out[at(p, n, i, j)] = U[at(p, n, i, j)];
        continue;
      }
      const int c = bt.at(i, j);
#pragma unroll
      for (int n = 0; n < NV; ++n) out[at(p, n, i, j)] = sum(n, c);
    }
  };

  // 1. floor and primitives, and the floored state on bt; S, the weight
  // and the geometry planes
#pragma unroll 4
  for (int k = tid; k < bq.cells(); k += nt) {
    const int i = bq.i0 + k / bq.w, j = bq.j0 + k % bq.w;
    T u[MAXVAR], q[MAXVAR];
    if (i < p.qx && j < p.qy) {
#pragma unroll
      for (int n = 0; n < NV; ++n) u[n] = ldU(U, p, n, i, j);
      cons_to_prim(p, u, q);
    } else {
#pragma unroll
      for (int n = 0; n < NV; ++n) u[n] = q[n] = T(0);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) Q[n * bq.cells() + k] = q[n];
    if (STAGES == 4 && i >= bt.i0 && i < bt.i0 + bt.h && j >= bt.j0 &&
        j < bt.j0 + bt.w) {
#pragma unroll
      for (int n = 0; n < NV; ++n) UB[n * ct + bt.at(i, j)] = u[n];
    }
  }
  if (p.with_sources || SPH) {
    const size_t fp = (size_t)p.qx * p.qy;
    for (int k = tid; k < ct; k += nt) {
      const int i = bt.i0 + k / bt.w, j = bt.j0 + k % bt.w;
      const bool in = i < p.qx && j < p.qy;
      const size_t c = (size_t)i * p.qy + j;
      if (p.with_sources)
        for (int m = 0; m < 3; ++m)
          SS[m * ct + k] = in ? S[(m + 1) * fp + c] : T(0);
      if (p.problem) SS[3 * ct + k] = in ? W[c] : T(0);
      if constexpr (SPH)
        for (int m = 0; m < 4; ++m)
          sm[t.g + m * ct + k] = in ? G[m * fp + c] : T(0);
    }
  }
  __syncthreads();

  // 2. the 1-D flattening coefficients (1 outside buf=2)
  if (p.flatten) {
    const BoxPlane<T> P = qv(IP);
    for (int k = tid; k < bx.cells(); k += nt) {
      const int i = bx.i0 + k / bx.w, j = bx.j0 + k % bx.w;
      XI[k] = flat1d_of<T>(p, P, qv(IU), i, j, 1, 0);
      XI[bx.cells() + k] = flat1d_of<T>(p, P, qv(IV), i, j, 0, 1);
    }
    __syncthreads();
  }

  // 3. the traced states of every cell of bt (zero outside buf=2), with
  // 0.5 dt of the cell's sources on the faces of the buf=1 window
  for (int k = tid; k < ct; k += nt) {
    const int a = bt.i0 + k / bt.w, b = bt.j0 + k % bt.w;
    T lx[MAXVAR], hx[MAXVAR], ly[MAXVAR], hy[MAXVAR];
    if (inwin(p, a, b, 2, 2, 2, 2)) {
      const T xi = flat_xi_of<T>(p, qv(IP), plane<T>(XI, bx, 0),
                                 plane<T>(XI, bx, 1), a, b);
      T q[MAXVAR];
#pragma unroll
      for (int n = 0; n < NV; ++n) q[n] = Q[n * bq.cells() + bq.at(a, b)];
      trace_dir<T, SPH, 1>(p, qv, g, q, xi, a, b, lx, hx);
      trace_dir<T, SPH, 2>(p, qv, g, q, xi, a, b, ly, hy);
    } else {
#pragma unroll
      for (int n = 0; n < NV; ++n) lx[n] = hx[n] = ly[n] = hy[n] = T(0);
    }
    if (p.with_sources) {
      const T s1 = SS[k], s2 = SS[ct + k], s3 = SS[2 * ct + k];
      half_sources(p, lx, a, b, s1, s2, s3);
      half_sources(p, hx, a + 1, b, s1, s2, s3);
      half_sources(p, ly, a, b, s1, s2, s3);
      half_sources(p, hy, a, b + 1, s1, s2, s3);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      st(LOX, n, k) = lx[n];
      st(HIX, n, k) = hx[n];
      st(LOY, n, k) = ly[n];
      st(HIY, n, k) = hy[n];
    }
  }
  __syncthreads();

  if constexpr (STAGES == 1) {
    // the interface states of the cell's faces, in _local_step_fn's sum
    emit([&](int n, int c) {
      return ((st(HIX, n, c - bt.w) + st(LOX, n, c)) + st(HIY, n, c - 1)) +
             st(LOY, n, c);
    });
    return;
  }

  // 4. the first Riemann pair on the faces of bt's cells that have their
  // left neighbour in bt, zero outside buf=1; in spherical geometry also
  // the pressures of the pair's CGF interface states; and the vertex
  // divergence at each cell's lower-left corner, which the viscosity of
  // four faces reads
  for (int k = tid; k < ct; k += nt) {
    const int a = bt.i0 + k / bt.w, b = bt.j0 + k % bt.w;
    const bool w1 = inwin(p, a, b, 1, 1, 1, 1);
    if (STAGES == 4 && a > bt.i0 && b > bt.j0)
      DV[k] = vdiv<T, SPH>(p, qv(IU), qv(IV), g, a, b);
    T ul[MAXVAR], ur[MAXVAR], f[MAXVAR], us[MAXVAR];
    if (a > bt.i0) {
      T pr = T(0);
      if (w1) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          ul[n] = st(HIX, n, k - bt.w);
          ur[n] = st(LOX, n, k);
        }
        riemann(p, 1, ul, ur, a, b, f, SPH ? us : (T*)nullptr);
        if constexpr (SPH) pr = pressure(p, us);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) f[n] = T(0);
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) f1(0, n, k) = f[n];
      if constexpr (SPH) P1[k] = pr;
    }
    if (b > bt.j0) {
      T pr = T(0);
      if (w1) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          ul[n] = st(HIY, n, k - 1);
          ur[n] = st(LOY, n, k);
        }
        riemann(p, 2, ul, ur, a, b, f, SPH ? us : (T*)nullptr);
        if constexpr (SPH) pr = pressure(p, us);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) f[n] = T(0);
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) f1(1, n, k) = f[n];
      if constexpr (SPH) P1[ct + k] = pr;
    }
  }
  __syncthreads();

  // 5. transverse corrections, the final Riemann pair and artificial
  // viscosity on the tile's faces that the update reads -- x faces i in
  // [i0, i0 + tx] within [ilo, ihi+1], y faces j in [j0, j0 + ty] within
  // [jlo, jhi+1] -- written over the face's right state, which only this
  // face reads; in spherical geometry also the final pair's interface
  // pressures
  {
    const T hdt = T(0.5 * p.dt);
    for (int k = tid; k < ct; k += nt) {
      const int i = bt.i0 + k / bt.w, j = bt.j0 + k % bt.w;
      T ul[MAXVAR], ur[MAXVAR], f[MAXVAR], us[MAXVAR];
      T sx[MAXVAR];   // a prefix's x-face part of the cell's sum
      const bool in_tile_x = i >= i0 && i <= i0 + t.tx && j >= j0 &&
                             j < j0 + t.ty;
      const bool in_tile_y = i >= i0 && i < i0 + t.tx && j >= j0 &&
                             j <= j0 + t.ty;
      if (in_tile_x && i <= ihi(p) + 1 && j <= jhi(p)) {
        const int w0 = k - bt.w, w1 = w0 + 1;     // (i - 1, j), (i - 1, j + 1)
        if constexpr (SPH) {
          const T mhdtV = -((T(1) / g.V(i, j)) * hdt);
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            ul[n] = st(HIX, n, w0) +
                    mhdtV * (f1(1, n, w1) * g.Ay(i - 1, j + 1) -
                             f1(1, n, w0) * g.Ay(i - 1, j));
            ur[n] = st(LOX, n, k) +
                    mhdtV * (f1(1, n, k + 1) * g.Ay(i, j + 1) -
                             f1(1, n, k) * g.Ay(i, j));
          }
          // transverse pressure gradients, over the unshifted cell's side
          const T Ly = g.Ly(i);
          const T* P1Y = P1 + ct;
          ul[p.iymom] = ul[p.iymom] + (-hdt) * (P1Y[w1] - P1Y[w0]) / Ly;
          ur[p.iymom] = ur[p.iymom] + (-hdt) * (P1Y[k + 1] - P1Y[k]) / Ly;
        } else {
          const T mhdtV = T(-(0.5 * p.dt / (p.dx * p.dy)));
          const T Ay = T(p.dx);
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            ul[n] = st(HIX, n, w0) +
                    mhdtV * (f1(1, n, w1) * Ay - f1(1, n, w0) * Ay);
            ur[n] = st(LOX, n, k) +
                    mhdtV * (f1(1, n, k + 1) * Ay - f1(1, n, k) * Ay);
          }
        }
        if constexpr (STAGES < 4) {
          // stage 2 ends before this face's solve, stage 3 after it
          if constexpr (STAGES == 3)
            riemann(p, 1, ul, ur, i, j, f, (T*)nullptr);
#pragma unroll
          for (int n = 0; n < NV; ++n)
            sx[n] = STAGES == 2 ? ul[n] + ur[n] : f[n];
        } else {
          riemann(p, 1, ul, ur, i, j, f, SPH ? us : (T*)nullptr);
          if constexpr (SPH) P2[k] = pressure(p, us);
          if (i <= ihi(p) || !p.edge_xr) {
            const T divU = T(0.5) * (DV[k] + DV[k + 1]);
            const T av = T(p.cvisc) * fmax(-divU * T(p.dx), T(0));
#pragma unroll
            for (int n = 0; n < NV; ++n)
              f[n] = f[n] + av * (ub(n, i - 1, j) - ub(n, i, j));
          }
#pragma unroll
          for (int n = 0; n < NV; ++n) st(LOX, n, k) = f[n];
        }
      }
      if (in_tile_y && i <= ihi(p) && j <= jhi(p) + 1) {
        const int e0 = k + bt.w, e1 = e0 - 1;     // (i + 1, j), (i + 1, j - 1)
        if constexpr (SPH) {
          const T mhdtV = -((T(1) / g.V(i, j)) * hdt);
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            ul[n] = st(HIY, n, k - 1) +
                    mhdtV * (f1(0, n, e1) * g.Ax(i + 1, j - 1) -
                             f1(0, n, k - 1) * g.Ax(i, j - 1));
            ur[n] = st(LOY, n, k) +
                    mhdtV * (f1(0, n, e0) * g.Ax(i + 1, j) -
                             f1(0, n, k) * g.Ax(i, j));
          }
          const T Lx = T(p.dx);
          ul[p.ixmom] = ul[p.ixmom] + (-hdt) * (P1[e1] - P1[k - 1]) / Lx;
          ur[p.ixmom] = ur[p.ixmom] + (-hdt) * (P1[e0] - P1[k]) / Lx;
        } else {
          const T mhdtV = T(-(0.5 * p.dt / (p.dx * p.dy)));
          const T Ax = T(p.dy);
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            ul[n] = st(HIY, n, k - 1) +
                    mhdtV * (f1(0, n, e1) * Ax - f1(0, n, k - 1) * Ax);
            ur[n] = st(LOY, n, k) +
                    mhdtV * (f1(0, n, e0) * Ax - f1(0, n, k) * Ax);
          }
        }
        if constexpr (STAGES < 4) {
          if constexpr (STAGES == 3)
            riemann(p, 2, ul, ur, i, j, f, (T*)nullptr);
          // the cell's sum, on the tile's own cells (whose x face ran
          // above), in _local_step_fn's order
          if (j < j0 + t.ty && j <= jhi(p)) {
#pragma unroll
            for (int n = 0; n < NV; ++n)
              st(LOY, n, k) = STAGES == 2 ? (sx[n] + ul[n]) + ur[n]
                                          : sx[n] + f[n];
          }
        } else {
          riemann(p, 2, ul, ur, i, j, f, SPH ? us : (T*)nullptr);
          if constexpr (SPH) P2[ct + k] = pressure(p, us);
          if (j <= jhi(p) || !p.edge_yr) {
            const T divU = T(0.5) * (DV[k] + DV[k + bt.w]);
            const T L = SPH ? g.Ly(i) : T(p.dy);
            const T av = T(p.cvisc) * fmax(-divU * L, T(0));
#pragma unroll
            for (int n = 0; n < NV; ++n)
              f[n] = f[n] + av * (ub(n, i, j - 1) - ub(n, i, j));
          }
#pragma unroll
          for (int n = 0; n < NV; ++n) st(LOY, n, k) = f[n];
        }
      }
    }
  }
  __syncthreads();

  if constexpr (STAGES == 2 || STAGES == 3) {
    emit([&](int n, int c) { return st(LOY, n, c); });
    return;
  }

  // 6. the update on the tile's interior cells, and the input's ghosts
  // carried through by the tiles at the frame's edges: this block owns
  // rows [r0, r1) x columns [c0, c1) of the frame
  const int r0 = blockIdx.y == 0 ? 0 : i0;
  const int r1 = blockIdx.y == gridDim.y - 1 ? p.qx : i0 + t.tx;
  const int c0 = blockIdx.x == 0 ? 0 : j0;
  const int c1 = blockIdx.x == gridDim.x - 1 ? p.qy : j0 + t.ty;
  const int ow = c1 - c0;
  for (int k = tid; k < (r1 - r0) * ow; k += nt) {
    const int i = r0 + k / ow, j = c0 + k % ow;
    if (!inwin(p, i, j, 0, 0, 0, 0)) {
#pragma unroll
      for (int n = 0; n < NV; ++n) out[at(p, n, i, j)] = U[at(p, n, i, j)];
      continue;
    }
    const int c = bt.at(i, j);
    const int cx = c + bt.w, cy = c + 1;    // faces (i + 1, j), (i, j + 1)
    T u[MAXVAR];
    if constexpr (SPH) {
      const T dtdV = (T(1) / g.V(i, j)) * T(p.dt);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const T upd = dtdV * (st(LOX, n, c) * g.Ax(i, j) -
                              st(LOX, n, cx) * g.Ax(i + 1, j) +
                              st(LOY, n, c) * g.Ay(i, j) -
                              st(LOY, n, cy) * g.Ay(i, j + 1));
        u[n] = ub(n, i, j) + upd;
      }
      // non-conservative pressure gradients from the final pair
      const T mdt = T(-p.dt);
      u[p.ixmom] = u[p.ixmom] + mdt * (P2[cx] - P2[c]) / T(p.dx);
      u[p.iymom] = u[p.iymom] + mdt * (P2[ct + cy] - P2[ct + c]) / g.Ly(i);

      // predictor-corrector sources (always on: the geometric terms act
      // with grav = 0 too)
      const T r = g.r(i);
      const T dt = T(p.dt), hdt = T(0.5 * p.dt), grav = T(p.grav);
      T u0[MAXVAR];
#pragma unroll
      for (int n = 0; n < NV; ++n) u0[n] = ub(n, i, j);
      T Sx0, Sy0, SE0;
      sph_sources(p, u0, r, Sx0, Sy0, SE0);
      const T w = p.problem ? SS[3 * ct + c] : T(0);
      if (p.problem) SE0 = SE0 + (u0[p.idens] * T(p.e_rate)) * w;
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
      T SE1 = xmom_new * grav;
      if (p.problem) SE1 = SE1 + (u[p.idens] * T(p.e_rate)) * w;
      u[p.ixmom] = u[p.ixmom] + hdt * (Sx1 - Sx0);
      u[p.iymom] = u[p.iymom] + hdt * (Sy1 - Sy0);
      u[p.iener] = u[p.iener] + hdt * (SE1 - SE0);
    } else {
      const T dtdV = T(p.dt / (p.dx * p.dy));
      const T Ax = T(p.dy), Ay = T(p.dx);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const T upd = dtdV * (st(LOX, n, c) * Ax - st(LOX, n, cx) * Ax +
                              st(LOY, n, c) * Ay - st(LOY, n, cy) * Ay);
        u[n] = ub(n, i, j) + upd;
      }

      if (p.with_sources) {
        // gravity, and a problem's energy source (rho e_rate) w added to
        // each energy row, as the plain step adds its stack
        const T grav = T(p.grav);
        const T dt = T(p.dt), hdt = T(0.5 * p.dt);
        const T w = p.problem ? SS[3 * ct + c] : T(0);
        const T S_old_ymom = ub(p.idens, i, j) * grav;
        T S_old_E = ub(p.iymom, i, j) * grav;
        if (p.problem)
          S_old_E = S_old_E + (ub(p.idens, i, j) * T(p.e_rate)) * w;
        u[p.iymom] = u[p.iymom] + dt * S_old_ymom;
        u[p.iener] = u[p.iener] + dt * S_old_E;
        const T S_new_ymom = u[p.idens] * grav;
        const T ymom_new = u[p.iymom] + hdt * (S_new_ymom - S_old_ymom);
        T S_new_E = ymom_new * grav;
        if (p.problem) S_new_E = S_new_E + (u[p.idens] * T(p.e_rate)) * w;
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
      u[p.iener] = u[p.iener] +
                   T(0.5) * ((nx * nx + ny * ny) - (x * x + y * y)) /
                       u[p.idens];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) out[at(p, n, i, j)] = u[n];
  }
}

// one launch of the NV-variable kernel with the plan's tile and shared
// memory (the opt-in above 48 KB is set once per kernel and size)
template <typename T, int NV, bool SPH, bool DEVDT, int STAGES = 4>
int launch(const T* U, const T* S, const T* G, const T* W, T* out,
           const Params& base, const Plan& t, int n_members, const T* dtp,
           cudaStream_t st) {
  static int opted = 0;
  auto kernel = k_ctu<T, NV, SPH, DEVDT, STAGES>;
  if (t.smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        t.smem);
    if (e != cudaSuccess) return (int)e;
    opted = t.smem;
  }
  FixedParams<NV> p;
  static_cast<Params&>(p) = base;
  const dim3 grd(t.bx, t.by, n_members);
  kernel<<<grd, t.threads, t.smem, st>>>(U, S, G, W, out, p, t, dtp);
  return (int)cudaGetLastError();
}

template <typename T, bool SPH>
int by_nvar(const T* U, const T* S, const T* G, const T* W, T* out,
            const Params& p, const Plan& t, int n_members, cudaStream_t st) {
  const T* host_dt = nullptr;
  switch (p.nvar) {
    case 4:
      return launch<T, 4, SPH, false>(U, S, G, W, out, p, t, n_members,
                                      host_dt, st);
    case 5:
      return launch<T, 5, SPH, false>(U, S, G, W, out, p, t, n_members,
                                      host_dt, st);
    case 6:
      return launch<T, 6, SPH, false>(U, S, G, W, out, p, t, n_members,
                                      host_dt, st);
    case 7:
      return launch<T, 7, SPH, false>(U, S, G, W, out, p, t, n_members,
                                      host_dt, st);
    case 8:
      return launch<T, 8, SPH, false>(U, S, G, W, out, p, t, n_members,
                                      host_dt, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the geometry, where dt comes from and the stages, as template arguments;
// the device-dt step is instantiated for the compressible solver's four
// variables alone (the on-device loop's, driver_loop.py), and so are the
// prefixes (the periodic padded entry's, Cartesian, host dt)
template <typename T>
int by_kind(const T* U, const T* S, const T* G, const T* W, T* out,
            const Params& p, const Plan& t, int n_members, const T* dtp,
            cudaStream_t st, int stages) {
  if (stages != 4) {
    if (p.nvar != 4 || p.spherical || dtp != nullptr)
      return (int)cudaErrorInvalidValue;
    switch (stages) {
      case 1:
        return launch<T, 4, false, false, 1>(U, S, G, W, out, p, t,
                                             n_members, dtp, st);
      case 2:
        return launch<T, 4, false, false, 2>(U, S, G, W, out, p, t,
                                             n_members, dtp, st);
      case 3:
        return launch<T, 4, false, false, 3>(U, S, G, W, out, p, t,
                                             n_members, dtp, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtp != nullptr) {
    if (p.nvar != 4) return (int)cudaErrorInvalidValue;
    return p.spherical
               ? launch<T, 4, true, true>(U, S, G, W, out, p, t, n_members,
                                          dtp, st)
               : launch<T, 4, false, true>(U, S, G, W, out, p, t,
                                           n_members, dtp, st);
  }
  return p.spherical
             ? by_nvar<T, true>(U, S, G, W, out, p, t, n_members, st)
             : by_nvar<T, false>(U, S, G, W, out, p, t, n_members, st);
}

template <typename T>
int run(const T* U, const T* S, const T* G, const T* W, T* out, Params p,
        const int* tp, int n_members, const T* dtp, cudaStream_t st,
        int stages = 4) {
  static_assert(MAXVAR == 8, "by_nvar instantiates 4..8 variables");
  const Plan t = load_plan(tp);
  if (p.nvar < 4 || p.nvar > MAXVAR || p.nx < 1 || p.ny < 1 ||
      n_members < 1 || n_members > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.idens != 0 || p.iener != 1 || p.ixmom != 2 || p.iymom != 3)
    return (int)cudaErrorInvalidValue;
  // the block, the halos the pipeline reads (ctu_kernel.HALO) within the
  // frame's ghosts, and a grid whose tiles cover the interior once
  if (t.threads != (p.spherical ? Launch<T, true>::threads
                                 : Launch<T, false>::threads))
    return (int)cudaErrorInvalidValue;
  if (t.tx < 1 || t.ty < 1 || t.ht < 1 || t.hx < t.ht + 1 ||
      t.hq < t.hx + 2 || t.hq < t.ht + 2 || p.ng < t.hq || t.smem < 1)
    return (int)cudaErrorInvalidValue;
  if (t.bx < 1 || t.by < 1 || (t.bx - 1) * t.ty >= p.ny ||
      t.bx * t.ty < p.ny || (t.by - 1) * t.tx >= p.nx || t.by * t.tx < p.nx)
    return (int)cudaErrorInvalidValue;
  if ((p.with_sources && (S == nullptr || t.s < 0)) ||
      (p.flatten && t.xi < 0) ||
      (p.problem && (W == nullptr || !p.with_sources)))
    return (int)cudaErrorInvalidValue;
  if (p.spherical && (G == nullptr || p.riemann != 2 || t.g < 0 ||
                      t.p1 < 0 || t.p2 < 0))
    return (int)cudaErrorInvalidValue;
  p.mstride = n_members > 1 ? (size_t)p.nvar * p.qx * p.qy : 0;
  return by_kind<T>(U, S, G, W, out, p, t, n_members, dtp, st, stages);
}

// the single-state entries' parameter block: the shared layout, then the
// four domain-edge flags (CTUStep's ints 20..23)
inline Params step_params(const int* ip, const double* dp) {
  Params p = load_params(ip, dp, false);
  p.edge_xl = ip[20];
  p.edge_xr = ip[21];
  p.edge_yl = ip[22];
  p.edge_yr = ip[23];
  return p;
}

// the batched entries' step: no floor, sources, sponge or walls, and
// Cartesian geometry, whatever the parameter arrays say
inline Params batched_params(const int* ip, const double* dp) {
  Params p = load_params(ip, dp, false);
  p.with_sources = p.do_sponge = p.has_floor = p.problem = 0;
  p.solid_xl = p.solid_xr = p.solid_yl = p.solid_yr = 0;
  p.spherical = 0;
  return p;
}

}  // namespace

// the length of the plan array each entry takes (ctu_kernel.plan)
extern "C" int ctu_plan_ints() { return PLAN_INTS; }

extern "C" int ctu_step_f32(const float* U, const float* S, const float* G,
                            const float* W, float* out, const int* ip,
                            const double* dp, const int* plan, void* stream) {
  return run<float>(U, S, G, W, out, step_params(ip, dp), plan, 1,
                    nullptr, (cudaStream_t)stream);
}

extern "C" int ctu_step_f64(const double* U, const double* S,
                            const double* G, const double* W, double* out,
                            const int* ip, const double* dp, const int* plan,
                            void* stream) {
  return run<double>(U, S, G, W, out, step_params(ip, dp), plan, 1,
                     nullptr, (cudaStream_t)stream);
}

// the same step with dt read from device memory (dt: one value of the
// state's dtype; the dt in dp is not read)
extern "C" int ctu_step_dev_f32(const float* U, const float* S,
                                const float* G, const float* W, float* out,
                                const int* ip, const double* dp,
                                const int* plan, const float* dt,
                                void* stream) {
  if (dt == nullptr) return (int)cudaErrorInvalidValue;
  return run<float>(U, S, G, W, out, step_params(ip, dp), plan, 1, dt,
                    (cudaStream_t)stream);
}

extern "C" int ctu_step_dev_f64(const double* U, const double* S,
                                const double* G, const double* W,
                                double* out, const int* ip, const double* dp,
                                const int* plan, const double* dt,
                                void* stream) {
  if (dt == nullptr) return (int)cudaErrorInvalidValue;
  return run<double>(U, S, G, W, out, step_params(ip, dp), plan, 1,
                     dt, (cudaStream_t)stream);
}

// n_members independent states, one after another in U and out
extern "C" int ctu_step_batched_f32(const float* U, float* out,
                                    int n_members, const int* ip,
                                    const double* dp, const int* plan,
                                    void* stream) {
  return run<float>(U, nullptr, nullptr, nullptr, out,
                    batched_params(ip, dp), plan, n_members, nullptr,
                    (cudaStream_t)stream);
}

extern "C" int ctu_step_batched_f64(const double* U, double* out,
                                    int n_members, const int* ip,
                                    const double* dp, const int* plan,
                                    void* stream) {
  return run<double>(U, nullptr, nullptr, nullptr, out,
                     batched_params(ip, dp), plan, n_members, nullptr,
                     (cudaStream_t)stream);
}

// the batched step cut short after stage 1, 2 or 3 (four variables): the
// frame of each member holds the prefix's sum on its interior and the
// input's ghosts
extern "C" int ctu_stage_batched_f32(const float* U, float* out,
                                     int n_members, const int* ip,
                                     const double* dp, const int* plan,
                                     int stages, void* stream) {
  if (stages < 1 || stages > 3) return (int)cudaErrorInvalidValue;
  return run<float>(U, nullptr, nullptr, nullptr, out,
                    batched_params(ip, dp), plan, n_members, nullptr,
                    (cudaStream_t)stream, stages);
}

extern "C" int ctu_stage_batched_f64(const double* U, double* out,
                                     int n_members, const int* ip,
                                     const double* dp, const int* plan,
                                     int stages, void* stream) {
  if (stages < 1 || stages > 3) return (int)cudaErrorInvalidValue;
  return run<double>(U, nullptr, nullptr, nullptr, out,
                     batched_params(ip, dp), plan, n_members, nullptr,
                     (cudaStream_t)stream, stages);
}
