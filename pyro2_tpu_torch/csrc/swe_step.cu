// swe_step.cu -- one shallow-water CTU step on Hopper, in one kernel launch.
//
// Replaces the fused Pallas TPU kernel
// pyro2_tpu/solvers/swe/pallas_step.py::make_pallas_swe_step_padded (body
// _local_swe_step_fn), which runs the jnp step of
// pyro2_tpu/solvers/swe/simulation.py: cons -> prim, limited slopes
// (limiter 0, 1 or 2), characteristic tracing, prim -> cons, the first Roe
// or HLLC pass, the transverse corrections, the second pass and the
// conservative update.  No flattening and no artificial viscosity: the swe
// path applies neither.  The Riemann solvers ignore solid walls, as the
// JAX package's do (its dam break has reflecting y walls and no clamp).
// nvar 4 (height, momenta, fuel) and more passive scalars, up to MAXVAR.
//
// Layout: the plain (nvar, nx + 2 ng, ny + 2 ng) state stack, y contiguous;
// conserved and primitive stacks share the indices h = 0, x = 1, y = 2,
// scalars from 3.  Windows are compared against the global index (the
// traced states on the buf=2 window, the first pair on buf=1, the second
// pair on the faces the update reads), which reproduces the windowed
// semantics of the plain PyTorch step exactly, so any nx, ny works.  The
// TPU's row bands, 8-row halos, 128-aligned rows and DMA semaphores have no
// counterpart.
//
// What bounds it on the H100: the step is arithmetic, ~870 floating-point
// operations per zone with Roe (swe_kernel.flops_per_zone; many divides
// and square roots) against 2 nvar values read and written per zone, so
// its bound is the fp32 rate.  The design keeps everything between the
// state's read and its write on the chip: each block owns one output tile
// (swe_kernel.plan picks its shape per dtype, lays out the block's shared
// memory and sizes the grid), loads the tile with a 3-cell halo of the
// state once and runs the pipeline out of shared memory and registers:
//   1. primitives, with the h == 0 guard (halo 3: the 4th-order slope of a
//      traced cell reads two cells along each direction);
//   2. the limited slopes and the characteristic tracing of every cell of
//      the tile and its 1-cell halo (the four faces of every cell whose
//      first-pass fluxes the transverse corrections read), prim -> cons;
//   3. the first Riemann pair on the faces of those cells, over the
//      primitives, which nothing reads any more;
//   4. the transverse corrections and the second pair on the tile's faces,
//      written over the states they used;
//   5. the conservative update, and the input's ghosts carried through by
//      the tiles at the frame's edges.
// __syncthreads() separates the phases.  A float32 block has 512 threads
// and two blocks share an SM (SweLaunch: at most 64 registers a thread);
// its tile is 30 x 30 cells, so its traced cells are 32 x 32, two for each
// thread (14 x 30 with more than 4 variables, whose boxes would leave no
// room for a second block); float64 takes 14 x 14 tiles on 256 threads.
// Neighbouring blocks recompute the halos (the traced cells are 1.14x the
// tile's), which the arithmetic bound affords.  The variable count is a
// template argument (4..MAXVAR), the directions of the tracing and the
// Riemann solvers are template arguments and h, hu, hv sit at fixed
// indices, so the per-variable arrays are indexed by constants and stay in
// registers; the HLLC solver picks its side's state value by value.
// Nothing is allocated here and there is no scratch in device memory.
//
// Arithmetic: each cell's operations are the plain step's, in its order;
// only where the intermediates live changed.  The entry points return the
// launch's cudaGetLastError().
//
// The device-dt entries swe_step_dev_{f32,f64} take dt as a pointer to one
// value of the state's dtype in device memory, which the kernel reads into
// its parameter block before anything else (DEVDT), so a launch reads no
// value from the host and can be captured into a CUDA graph whose replays
// each take the dt the graph computed (driver_loop.py).  For the same dt
// they give the host-dt entries' bits: the kernel converts the value to
// double, as the wrapper's float(dt) does, and the arithmetic is the same.
// They take the host-dt entries' 4..MAXVAR variables, Riemann solvers and
// limiters; the host-dt entries keep their own instantiations (DEVDT
// false).
//
// Build (see swe_kernel.py and util/cuda_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libswe_step.so swe_step.cu
// -fmad=false keeps each multiply and add rounded on its own, as the plain
// PyTorch step rounds them, so the two agree to the last bits that order
// allows.

#include "grid_common.cuh"

namespace {

struct SweParams {
  int nvar, nx, ny, ng, qx, qy;
  int riemann;  // 0 Roe, 1 HLLC
  int limiter;  // 0 none, 1 2nd-order MC, otherwise 4th-order MC
  double dx, dy, dt, grav;
};

// the parameter block with the variable count fixed at compile time
template <int NV>
struct SweFixed : SweParams {
  static constexpr int nvar = NV;
};

// conserved (h, hu, hv, hX...) and primitive (h, u, v, X...) indices
constexpr int IH = 0, IU = 1, IV = 2, NFIX = 3;

constexpr double SMALLC = 1.e-10;
constexpr double ROE_TOL = 0.1e-1;  // the entropy fix's |lambda| threshold

// trace cell-centred primitives q (slopes dq) to its two faces along D (1:
// x, 2: y)
template <typename T, int D, typename P>
__device__ __forceinline__ void trace(const P& p, const T* q, const T* dq,
                                      T* ql, T* qr) {
  const double d = D == 1 ? p.dx : p.dy;
  const T dtdx = T(p.dt / d);
  const T dtdx3 = T(0.33333 * (p.dt / d));  // the reference's approximate 1/3
  constexpr int iun = D == 1 ? IU : IV;
  constexpr int iut = D == 1 ? IV : IU;

  const T h = q[IH];
  const T cs = sqrt(T(p.grav) * h);
  const T un = q[iun];
  const T ev0 = un - cs;
  const T ev2 = un + cs;

  const T d_h = dq[IH], d_un = dq[iun], d_ut = dq[iut];
  const T a0 = T(0.5) / (cs * h) * (cs * d_h - h * d_un);
  const T a1 = d_ut;
  const T a2 = T(-0.5) / (cs * h) * (cs * d_h + h * d_un);

  // the gate tests ev >= 0 (copysign semantics): a stationary wave gates
  // fully left
  auto bl = [&](T ev, T asum) {
    return dtdx3 * (ev2 - ev) * (ev >= T(0) ? T(2) : T(0)) * asum;
  };
  auto br = [&](T ev, T asum) {
    return dtdx3 * (ev0 - ev) * (ev >= T(0) ? T(0) : T(2)) * asum;
  };
  const T bl0 = bl(ev0, a0), br0 = br(ev0, a0);
  const T bl1 = bl(un, a1), br1 = br(un, a1);
  const T bl2 = bl(ev2, a2), br2 = br(ev2, a2);

  const T factor_l = T(0.5) * (T(1) - dtdx * fmax(ev2, T(0)));
  const T factor_r = T(0.5) * (T(1) + dtdx * fmin(ev0, T(0)));

#pragma unroll
  for (int n = 0; n < p.nvar; ++n) {
    ql[n] = q[n] + factor_l * dq[n];
    qr[n] = q[n] - factor_r * dq[n];
  }
  // right eigenvectors r0 = (h, -c, 0), r1 = the transverse unit,
  // r2 = (h, c, 0); scalars ride at un
  ql[IH] = ql[IH] + h * (bl0 + bl2);
  qr[IH] = qr[IH] + h * (br0 + br2);
  ql[iun] = ql[iun] + cs * (bl2 - bl0);
  qr[iun] = qr[iun] + cs * (br2 - br0);
  ql[iut] = ql[iut] + bl1;
  qr[iut] = qr[iut] + br1;
#pragma unroll
  for (int n = NFIX; n < p.nvar; ++n) {
    ql[n] = ql[n] + bl(un, dq[n]);
    qr[n] = qr[n] + br(un, dq[n]);
  }
}

template <typename T, typename P>
__device__ __forceinline__ void prim_to_cons(const P& p, const T* q, T* U) {
  U[IH] = q[IH];
#pragma unroll
  for (int n = 1; n < p.nvar; ++n) U[n] = q[n] * q[IH];
}

// ---------------------------------------------------------------------------
// Riemann solvers on one interface along D: Ul, Ur conserved states ->
// flux F.  Neither clamps a solid face.
// ---------------------------------------------------------------------------

// the analytic flux, without an h == 0 guard (as inside the JAX solvers)
template <typename T, int D, typename P>
__device__ __forceinline__ void swe_flux(const P& p, const T* U, T* F) {
  const T h = U[IH];
  const T u = U[IU] / h;
  const T v = U[IV] / h;
  const T vel = D == 1 ? u : v;
  F[IH] = h * vel;
  F[IU] = U[IU] * vel;
  F[IV] = U[IV] * vel;
  constexpr int in = D == 1 ? IU : IV;
  F[in] = F[in] + T(0.5 * p.grav) * (h * h);
#pragma unroll
  for (int n = NFIX; n < p.nvar; ++n) F[n] = U[n] * vel;
}

// Roe with the entropy fix (Toro / clawpack form)
template <typename T, int D, typename P>
__device__ __forceinline__ void roe(const P& p, const T* Ul, const T* Ur,
                                    T* F) {
  constexpr int iun = D == 1 ? IU : IV;
  constexpr int iut = D == 1 ? IV : IU;
  const T grav = T(p.grav);

  const T h_l = Ul[IH], h_r = Ur[IH];
  const T un_l = Ul[iun] / h_l;
  const T un_r = Ur[iun] / h_r;
  const T c_l = fmax(sqrt(grav * h_l), T(SMALLC));
  const T c_r = fmax(sqrt(grav * h_r), T(SMALLC));

  // Roe averages of the velocity components; h is the geometric mean
  const T sq_l = sqrt(h_l), sq_r = sqrt(h_r);
  const T sq = sq_l + sq_r;
  const T un_roe = (Ul[iun] / sq_l + Ur[iun] / sq_r) / sq;
  const T ut_roe = (Ul[iut] / sq_l + Ur[iut] / sq_r) / sq;
  const T h_roe = sqrt(h_l * h_r);
  const T c_roe = sqrt(T(0.5) * (c_l * c_l + c_r * c_r));

  const T dh = h_r - h_l;
  const T dun = Ur[iun] / h_r - Ul[iun] / h_l;
  const T dut = Ur[iut] / h_r - Ul[iut] / h_l;

  T lam0 = un_roe - c_roe;
  const T lam1 = un_roe;
  T lam2 = un_roe + c_roe;

  const T alpha0 = T(0.5) * (dh - h_roe / c_roe * dun);
  const T alpha1 = h_roe * dut;
  const T alpha2 = T(0.5) * (dh + h_roe / c_roe * dun);

  // entropy fix: widen transonic rarefactions
  const T hs = T(0.5) * (c_l + c_r) + T(0.25) * (un_l - un_r);
  const T h_star = T(1.0 / p.grav) * (hs * hs);
  const T u_star = T(0.5) * (un_l + un_r) + c_l - c_r;
  const T c_star = sqrt(grav * h_star);
  if (fabs(lam0) < T(ROE_TOL))
    lam0 = lam0 * (u_star - c_star - lam0) /
           (u_star - c_star - (un_l - c_l));
  if (fabs(lam2) < T(ROE_TOL))
    lam2 = lam2 * (u_star + c_star - lam2) /
           (u_star + c_star - (un_r + c_r));

  T Fl[MAXVAR], Fr[MAXVAR];
  swe_flux<T, D>(p, Ul, Fl);
  swe_flux<T, D>(p, Ur, Fr);
#pragma unroll
  for (int n = 0; n < p.nvar; ++n) F[n] = T(0.5) * (Fl[n] + Fr[n]);

  // subtract sum_m 0.5 alpha_m |lam_m| K_m, K0 = (1, un-c | ut),
  // K1 = the transverse unit, K2 = (1, un+c | ut), in the plain version's
  // order (its zero components included)
  const T t0 = T(0.5) * alpha0 * fabs(lam0);
  const T t1 = T(0.5) * alpha1 * fabs(lam1);
  const T t2 = T(0.5) * alpha2 * fabs(lam2);
  F[IH] = F[IH] - t0;
  F[iun] = F[iun] - t0 * (un_roe - c_roe);
  F[iut] = F[iut] - t0 * ut_roe;
  F[IH] = F[IH] - t1 * T(0);
  F[iun] = F[iun] - t1 * T(0);
  F[iut] = F[iut] - t1;
  F[IH] = F[IH] - t2;
  F[iun] = F[iun] - t2 * (un_roe + c_roe);
  F[iut] = F[iut] - t2 * ut_roe;

  // scalars ride at un_roe with alpha = h_roe * delta
#pragma unroll
  for (int n = NFIX; n < p.nvar; ++n) {
    const T delta = Ur[n] / h_r - Ul[n] / h_l;
    F[n] = F[n] + T(-0.5) * h_roe * delta * fabs(lam1);
  }
}

// HLLC (Toro), the region select in the plain version's nesting order
template <typename T, int D, typename P>
__device__ __forceinline__ void hllc(const P& p, const T* Ul, const T* Ur,
                                     T* F) {
  constexpr int iun = D == 1 ? IU : IV;
  constexpr int iut = D == 1 ? IV : IU;
  const T grav = T(p.grav);

  const T h_l = Ul[IH], h_r = Ur[IH];
  const T un_l = Ul[iun] / h_l;
  const T ut_l = Ul[iut] / h_l;
  const T un_r = Ur[iun] / h_r;
  const T ut_r = Ur[iut] / h_r;
  const T c_l = fmax(sqrt(grav * h_l), T(SMALLC));
  const T c_r = fmax(sqrt(grav * h_r), T(SMALLC));

  const T h_avg = T(0.5) * (h_l + h_r);
  const T c_avg = T(0.5) * (c_l + c_r);
  const T hstar = h_avg - T(0.25) * (un_r - un_l) * h_avg / c_avg;

  const T S_l = hstar <= h_l
                    ? un_l - c_l
                    : un_l - c_l * sqrt(T(0.5) * (hstar + h_l) * hstar) / h_l;
  const T S_r = hstar <= h_r
                    ? un_r + c_r
                    : un_r + c_r * sqrt(T(0.5) * (hstar + h_r) * hstar) / h_r;
  const T S_c = (S_l * h_r * (un_r - S_r) - S_r * h_l * (un_l - S_l)) /
                (h_r * (un_r - S_r) - h_l * (un_l - S_l));

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
#pragma unroll
  for (int n = 0; n < p.nvar; ++n) U[n] = right ? Ur[n] : Ul[n];
  swe_flux<T, D>(p, U, F);
  if (region == 0 || region == 3) return;

  // star state: F* = F + S (U* - U)
  const T h = right ? h_r : h_l;
  const T un = right ? un_r : un_l;
  const T ut = right ? ut_r : ut_l;
  const T S = right ? S_r : S_l;
  const T fac = h * (S - un) / (S - S_c);
  T Us[MAXVAR];
  Us[IH] = fac;
  Us[iun] = fac * S_c;
  Us[iut] = fac * ut;
#pragma unroll
  for (int n = NFIX; n < p.nvar; ++n) Us[n] = fac * U[n] / h;
#pragma unroll
  for (int n = 0; n < p.nvar; ++n) F[n] = F[n] + S * (Us[n] - U[n]);
}

template <typename T, int D, typename P>
__device__ __forceinline__ void riemann(const P& p, const T* Ul, const T* Ur,
                                        T* F) {
  if (p.riemann == 0)
    roe<T, D>(p, Ul, Ur, F);
  else
    hllc<T, D>(p, Ul, Ur, F);
}

// the traced states of cell (a, b) on its two faces along D: lo on the low
// face (the right state of face (a, b)), hi on the high face (the left
// state of face (a + 1, b) or (a, b + 1)), both conserved
template <typename T, int D, typename P, typename QV>
__device__ __forceinline__ void trace_dir(const P& p, const QV& qv,
                                          const T* q, int a, int b, T* lo,
                                          T* hi) {
  constexpr int di = D == 1, dj = D == 2;
  T dq[MAXVAR], ql[MAXVAR], qr[MAXVAR];
#pragma unroll
  for (int n = 0; n < p.nvar; ++n)
    dq[n] = slope_of<T>(p, qv(n), a, b, di, dj);
  trace<T, D>(p, q, dq, ql, qr);
  prim_to_cons(p, ql, hi);
  prim_to_cons(p, qr, lo);
}

// the block of each dtype: float32 blocks of 512 threads, two to an SM (at
// most 64 registers a thread); float64 blocks of 256, one to an SM
// (swe_kernel.THREADS, with tiles that give each thread one traced cell)
template <typename T>
struct SweLaunch {
  static constexpr int threads = 256, blocks = 1;
};
template <>
struct SweLaunch<float> {
  static constexpr int threads = 512, blocks = 2;
};

// the launch plan of swe_kernel.plan: the output tile (tx rows along x, ty
// columns along y) and the block's threads; the halos of the primitives'
// and the traced cells' boxes; where each array starts in the block's
// shared memory, in elements of T (the first pair may lie over the
// primitives, which phase 3 no longer reads); and the grid of tiles
struct Plan {
  int tx, ty, threads;
  int hq, ht;
  int q, st, f1;
  int smem;    // bytes
  int bx, by;  // blocks along y (columns), along x (rows)
};

constexpr int PLAN_INTS = 11;

Plan load_plan(const int* t) {
  return Plan{t[0], t[1], t[2], t[3], t[4], t[5],
              t[6], t[7], t[8], t[9], t[10]};
}

// the faces of the traced states (ST planes f * NV + n)
enum { LOX = 0, HIX = 1, LOY = 2, HIY = 3 };

// one step of the tile (blockIdx.y, blockIdx.x); with DEVDT the step's dt
// is *dtp, in place of the parameter block's
template <typename T, int NV, bool DEVDT>
__global__ void __launch_bounds__(SweLaunch<T>::threads,
                                  SweLaunch<T>::blocks)
    k_swe(const T* __restrict__ U, T* __restrict__ out,
          const SweFixed<NV> pin, const Plan t, const T* __restrict__ dtp) {
  SweFixed<NV> pdev = pin;
  if constexpr (DEVDT) pdev.dt = double(*dtp);
  const SweFixed<NV>& p = DEVDT ? pdev : pin;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int i0 = p.ng + blockIdx.y * t.tx, j0 = p.ng + blockIdx.x * t.ty;
  const Box bq{i0 - t.hq, j0 - t.hq, t.tx + 2 * t.hq, t.ty + 2 * t.hq};
  const Box bt{i0 - t.ht, j0 - t.ht, t.tx + 2 * t.ht, t.ty + 2 * t.ht};
  const int cq = bq.cells(), ct = bt.cells();
  T* Q = sm + t.q;     // NV planes over bq: the primitives
  T* ST = sm + t.st;   // 4 NV planes over bt: each cell's states by face
  T* F1 = sm + t.f1;   // 2 NV planes over bt: the first pair, x then y
  auto qv = [&](int n) { return plane<T>(Q, bq, n); };
  auto st = [&](int f, int n, int k) -> T& {
    return ST[(f * NV + n) * ct + k];
  };
  auto f1 = [&](int d, int n, int k) -> T& {
    return F1[(d * NV + n) * ct + k];
  };

  // 1. cons -> prim on bq, guarding h == 0 (zero past the frame's edge,
  // where no window reads)
#pragma unroll 2
  for (int k = tid; k < cq; k += nt) {
    const int i = bq.i0 + k / bq.w, j = bq.j0 + k % bq.w;
    T q[MAXVAR];
    if (i < p.qx && j < p.qy) {
      const T h = U[at(p, IH, i, j)];
      const bool nz = h != T(0);
      const T safe = nz ? h : T(1);
      q[IH] = h;
#pragma unroll
      for (int n = 1; n < NV; ++n)
        q[n] = nz ? U[at(p, n, i, j)] / safe : T(0);
    } else {
#pragma unroll
      for (int n = 0; n < NV; ++n) q[n] = T(0);
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) Q[n * cq + k] = q[n];
  }
  __syncthreads();

  // 2. the traced states of every cell of bt (zero outside buf=2)
  for (int k = tid; k < ct; k += nt) {
    const int a = bt.i0 + k / bt.w, b = bt.j0 + k % bt.w;
    T lx[MAXVAR], hx[MAXVAR], ly[MAXVAR], hy[MAXVAR];
    if (inwin(p, a, b, 2, 2, 2, 2)) {
      T q[MAXVAR];
#pragma unroll
      for (int n = 0; n < NV; ++n) q[n] = Q[n * cq + bq.at(a, b)];
      trace_dir<T, 1>(p, qv, q, a, b, lx, hx);
      trace_dir<T, 2>(p, qv, q, a, b, ly, hy);
    } else {
#pragma unroll
      for (int n = 0; n < NV; ++n) lx[n] = hx[n] = ly[n] = hy[n] = T(0);
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

  // 3. the first Riemann pair on the faces of bt's cells that have their
  // left neighbour in bt, zero outside buf=1
  for (int k = tid; k < ct; k += nt) {
    const int a = bt.i0 + k / bt.w, b = bt.j0 + k % bt.w;
    const bool w1 = inwin(p, a, b, 1, 1, 1, 1);
    T ul[MAXVAR], ur[MAXVAR], f[MAXVAR];
    if (a > bt.i0) {
      if (w1) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          ul[n] = st(HIX, n, k - bt.w);
          ur[n] = st(LOX, n, k);
        }
        riemann<T, 1>(p, ul, ur, f);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) f[n] = T(0);
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) f1(0, n, k) = f[n];
    }
    if (b > bt.j0) {
      if (w1) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          ul[n] = st(HIY, n, k - 1);
          ur[n] = st(LOY, n, k);
        }
        riemann<T, 2>(p, ul, ur, f);
      } else {
#pragma unroll
        for (int n = 0; n < NV; ++n) f[n] = T(0);
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) f1(1, n, k) = f[n];
    }
  }
  __syncthreads();

  // 4. the transverse corrections and the second Riemann pair on the
  // tile's faces that the update reads -- x faces i in [i0, i0 + tx]
  // within [ilo, ihi+1], j in [j0, j0 + ty) within [jlo, jhi]; y faces the
  // same with the axes swapped -- written over the face's right state,
  // which only this face reads
  {
    const T cy = T(-0.5 * (p.dt / p.dy)), cx = T(-0.5 * (p.dt / p.dx));
    for (int k = tid; k < ct; k += nt) {
      const int i = bt.i0 + k / bt.w, j = bt.j0 + k % bt.w;
      T ul[MAXVAR], ur[MAXVAR], f[MAXVAR];
      if (i >= i0 && i <= i0 + t.tx && j >= j0 && j < j0 + t.ty &&
          i <= ihi(p) + 1 && j <= jhi(p)) {
        const int w0 = k - bt.w, w1 = w0 + 1;     // (i - 1, j), (i - 1, j + 1)
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          ul[n] = st(HIX, n, w0) + cy * (f1(1, n, w1) - f1(1, n, w0));
          ur[n] = st(LOX, n, k) + cy * (f1(1, n, k + 1) - f1(1, n, k));
        }
        riemann<T, 1>(p, ul, ur, f);
#pragma unroll
        for (int n = 0; n < NV; ++n) st(LOX, n, k) = f[n];
      }
      if (i >= i0 && i < i0 + t.tx && j >= j0 && j <= j0 + t.ty &&
          i <= ihi(p) && j <= jhi(p) + 1) {
        const int e0 = k + bt.w, e1 = e0 - 1;     // (i + 1, j), (i + 1, j - 1)
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          ul[n] = st(HIY, n, k - 1) + cx * (f1(0, n, e1) - f1(0, n, k - 1));
          ur[n] = st(LOY, n, k) + cx * (f1(0, n, e0) - f1(0, n, k));
        }
        riemann<T, 2>(p, ul, ur, f);
#pragma unroll
        for (int n = 0; n < NV; ++n) st(LOY, n, k) = f[n];
      }
    }
  }
  __syncthreads();

  // 5. the update on the tile's interior cells, and the input's ghosts
  // carried through by the tiles at the frame's edges: this block owns
  // rows [r0, r1) x columns [c0, c1) of the frame
  const int r0 = blockIdx.y == 0 ? 0 : i0;
  const int r1 = blockIdx.y == gridDim.y - 1 ? p.qx : i0 + t.tx;
  const int c0 = blockIdx.x == 0 ? 0 : j0;
  const int c1 = blockIdx.x == gridDim.x - 1 ? p.qy : j0 + t.ty;
  const int ow = c1 - c0;
  const T dtdx = T(p.dt / p.dx), dtdy = T(p.dt / p.dy);
  for (int k = tid; k < (r1 - r0) * ow; k += nt) {
    const int i = r0 + k / ow, j = c0 + k % ow;
    if (!inwin(p, i, j, 0, 0, 0, 0)) {
#pragma unroll
      for (int n = 0; n < NV; ++n) out[at(p, n, i, j)] = U[at(p, n, i, j)];
      continue;
    }
    const int c = bt.at(i, j);
    const int cx = c + bt.w, cy = c + 1;    // faces (i + 1, j), (i, j + 1)
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const T upd = dtdx * (st(LOX, n, c) - st(LOX, n, cx)) +
                    dtdy * (st(LOY, n, c) - st(LOY, n, cy));
      out[at(p, n, i, j)] = U[at(p, n, i, j)] + upd;
    }
  }
}

// the parameter block from the wrapper's int and double arrays (the order
// of SWEStep in Python)
SweParams load_params(const int* ip, const double* dp) {
  SweParams p = {};
  p.nvar = ip[0];
  p.nx = ip[1];
  p.ny = ip[2];
  p.ng = ip[3];
  p.riemann = ip[4];
  p.limiter = ip[5];
  p.dx = dp[0];
  p.dy = dp[1];
  p.dt = dp[2];
  p.grav = dp[3];
  p.qx = p.nx + 2 * p.ng;
  p.qy = p.ny + 2 * p.ng;
  return p;
}

// [a, a + na) and [b, b + nb) do not overlap
bool apart(long a, long na, long b, long nb) {
  return a + na <= b || b + nb <= a;
}

// one launch of the NV-variable kernel with the plan's tile and shared
// memory (the opt-in above 48 KB is set once per kernel and size: the
// on-device loop's warm-up body sets the device-dt instance's before its
// capture)
template <typename T, int NV, bool DEVDT>
int launch(const T* U, T* out, const SweParams& base, const Plan& t,
           const T* dtp, cudaStream_t st) {
  static int opted = 0;
  auto kernel = k_swe<T, NV, DEVDT>;
  if (t.smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        t.smem);
    if (e != cudaSuccess) return (int)e;
    opted = t.smem;
  }
  SweFixed<NV> p;
  static_cast<SweParams&>(p) = base;
  kernel<<<dim3(t.bx, t.by), t.threads, t.smem, st>>>(U, out, p, t, dtp);
  return (int)cudaGetLastError();
}

// the variable count and where dt comes from, as template arguments
template <typename T, bool DEVDT>
int by_nvar(const T* U, T* out, const SweParams& p, const Plan& t,
            const T* dtp, cudaStream_t st) {
  switch (p.nvar) {
    case 4: return launch<T, 4, DEVDT>(U, out, p, t, dtp, st);
    case 5: return launch<T, 5, DEVDT>(U, out, p, t, dtp, st);
    case 6: return launch<T, 6, DEVDT>(U, out, p, t, dtp, st);
    case 7: return launch<T, 7, DEVDT>(U, out, p, t, dtp, st);
    case 8: return launch<T, 8, DEVDT>(U, out, p, t, dtp, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dtp: the device dt of the device-dt entries, nullptr for the host dt
template <typename T>
int run(const T* U, T* out, const int* ip, const double* dp, const int* tp,
        const T* dtp, cudaStream_t st) {
  static_assert(MAXVAR == 8, "by_nvar instantiates 4..8 variables");
  const SweParams p = load_params(ip, dp);
  const Plan t = load_plan(tp);
  if (p.nvar < 4 || p.nvar > MAXVAR || p.nx < 1 || p.ny < 1 ||
      p.riemann < 0 || p.riemann > 1)
    return (int)cudaErrorInvalidValue;
  // the block, the halos the pipeline reads (swe_kernel.HALO) within the
  // frame's ghosts, a grid whose tiles cover the interior once, and arrays
  // inside the shared memory, the states apart from the others
  if (t.threads != SweLaunch<T>::threads || t.tx < 1 || t.ty < 1 ||
      t.ht < 1 || t.hq < t.ht + 2 || p.ng < t.hq)
    return (int)cudaErrorInvalidValue;
  if (t.bx < 1 || t.by < 1 || (t.bx - 1) * t.ty >= p.ny ||
      t.bx * t.ty < p.ny || (t.by - 1) * t.tx >= p.nx || t.by * t.tx < p.nx)
    return (int)cudaErrorInvalidValue;
  const long cq = (long)(t.tx + 2 * t.hq) * (t.ty + 2 * t.hq);
  const long ct = (long)(t.tx + 2 * t.ht) * (t.ty + 2 * t.ht);
  const long nq = p.nvar * cq, nst = 4 * p.nvar * ct, nf1 = 2 * p.nvar * ct;
  const long end = (long)t.smem / (long)sizeof(T);
  if (t.q < 0 || t.st < 0 || t.f1 < 0 || t.q + nq > end ||
      t.st + nst > end || t.f1 + nf1 > end || !apart(t.st, nst, t.q, nq) ||
      !apart(t.st, nst, t.f1, nf1))
    return (int)cudaErrorInvalidValue;
  return dtp != nullptr ? by_nvar<T, true>(U, out, p, t, dtp, st)
                        : by_nvar<T, false>(U, out, p, t, nullptr, st);
}

}  // namespace

// the length of the plan array each entry takes (swe_kernel.plan)
extern "C" int swe_plan_ints() { return PLAN_INTS; }

extern "C" int swe_step_f32(const float* U, float* out, const int* ip,
                            const double* dp, const int* plan, void* stream) {
  return run<float>(U, out, ip, dp, plan, nullptr, (cudaStream_t)stream);
}

extern "C" int swe_step_f64(const double* U, double* out, const int* ip,
                            const double* dp, const int* plan, void* stream) {
  return run<double>(U, out, ip, dp, plan, nullptr, (cudaStream_t)stream);
}

// the same step with dt read from device memory (dt: one value of the
// state's dtype; the dt in dp is not read)
extern "C" int swe_step_dev_f32(const float* U, float* out, const int* ip,
                                const double* dp, const int* plan,
                                const float* dt, void* stream) {
  if (dt == nullptr) return (int)cudaErrorInvalidValue;
  return run<float>(U, out, ip, dp, plan, dt, (cudaStream_t)stream);
}

extern "C" int swe_step_dev_f64(const double* U, double* out, const int* ip,
                                const double* dp, const int* plan,
                                const double* dt, void* stream) {
  if (dt == nullptr) return (int)cudaErrorInvalidValue;
  return run<double>(U, out, ip, dp, plan, dt, (cudaStream_t)stream);
}
