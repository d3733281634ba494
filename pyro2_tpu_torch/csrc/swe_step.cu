// swe_step.cu -- one shallow-water CTU step on Hopper.
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
// scalars from 3.  Every kernel is one thread per cell or interface with
// threadIdx.x along y, every window decided by comparing the global index,
// so any nx, ny works.  The TPU's row bands, 8-row halos, 128-aligned rows
// and DMA semaphores have no counterpart.
//
// What bounds it on the H100: ~860 floating-point operations per zone
// (swe_kernel.FLOPS_PER_ZONE_BY_STAGE; many divides and square roots)
// against 2 nvar values read and written per zone, so the fp32 rate bounds
// it, as it does the CTU kernel.  This first design is simple instead: it
// stages its intermediates through device memory -- primitives, the four
// interface-state stacks and two flux pairs, about 20 nvar planes of
// traffic per zone over the five stages -- and keeps the per-variable
// arrays (MAXVAR long, indexed at run time) in local memory.  Shared-memory
// tiles and fused stages are the next steps for speed.  The scratch is
// allocated by the wrapper (torch.empty) and nothing is allocated here.
// The stages run in order on the caller's stream; the entry point returns
// the first cudaGetLastError().
//
// Build (see swe_kernel.py and util/cuda_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libswe_step.so swe_step.cu
// -fmad=false keeps each multiply and add rounded on its own, as the plain
// PyTorch step rounds them; the arithmetic follows its order of
// operations, so the two agree to the last bits that order allows.

#include "grid_common.cuh"

namespace {

struct SweParams {
  int nvar, nx, ny, ng, qx, qy;
  int riemann;  // 0 Roe, 1 HLLC
  int limiter;  // 0 none, 1 2nd-order MC, otherwise 4th-order MC
  double dx, dy, dt, grav;
};

// conserved (h, hu, hv, hX...) and primitive (h, u, v, X...) indices
constexpr int IH = 0, IU = 1, IV = 2, NFIX = 3;

constexpr double SMALLC = 1.e-10;
constexpr double ROE_TOL = 0.1e-1;  // the entropy fix's |lambda| threshold

// stage 1: cons -> prim on every cell, guarding h == 0
template <typename T>
__global__ void k_swe_prim(const T* __restrict__ U, T* __restrict__ Q,
                           SweParams p) {
  CELL_INDEX
  const T h = U[at(p, IH, i, j)];
  const bool nz = h != T(0);
  const T safe = nz ? h : T(1);
  Q[at(p, IH, i, j)] = h;
  for (int n = 1; n < p.nvar; ++n)
    Q[at(p, n, i, j)] = nz ? U[at(p, n, i, j)] / safe : T(0);
}

// trace cell-centred primitives q (slopes dq) to its two faces along idir
template <typename T>
__device__ void trace(const SweParams& p, int idir, const T* q, const T* dq,
                      T* ql, T* qr) {
  const double d = idir == 1 ? p.dx : p.dy;
  const T dtdx = T(p.dt / d);
  const T dtdx3 = T(0.33333 * (p.dt / d));  // the reference's approximate 1/3
  const int iun = idir == 1 ? IU : IV;
  const int iut = idir == 1 ? IV : IU;

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
  for (int n = NFIX; n < p.nvar; ++n) {
    ql[n] = ql[n] + bl(un, dq[n]);
    qr[n] = qr[n] + br(un, dq[n]);
  }
}

template <typename T>
__device__ __forceinline__ void prim_to_cons(const SweParams& p, const T* q,
                                             T* U) {
  U[IH] = q[IH];
  for (int n = 1; n < p.nvar; ++n) U[n] = q[n] * q[IH];
}

template <typename T>
__device__ __forceinline__ void store(const SweParams& p, T* dst, const T* v,
                                      int i, int j) {
  for (int n = 0; n < p.nvar; ++n) dst[at(p, n, i, j)] = v[n];
}

// stage 2: interface states.  A cell (i, j) of the buf=2 window writes
// U_xr(i, j), U_xl(i+1, j), U_yr(i, j) and U_yl(i, j+1).  Nothing is
// written outside: the Riemann stages read only [ilo-1, ihi+1]^2, which
// these cells cover.
template <typename T>
__global__ void k_swe_states(const T* __restrict__ Q, T* __restrict__ UXL,
                             T* __restrict__ UXR, T* __restrict__ UYL,
                             T* __restrict__ UYR, SweParams p) {
  CELL_INDEX
  if (!inwin(p, i, j, 2, 2, 2, 2)) return;
  const size_t plane = (size_t)p.qx * p.qy;
  const size_t c = (size_t)i * p.qy + j;
  T q[MAXVAR], dq[MAXVAR], ql[MAXVAR], qr[MAXVAR], ul[MAXVAR], ur[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) q[n] = Q[n * plane + c];
  for (int d = 1; d <= 2; ++d) {
    const int di = d == 1, dj = d == 2;
    for (int n = 0; n < p.nvar; ++n)
      dq[n] = slope(p, Q + n * plane, i, j, di, dj);
    trace(p, d, q, dq, ql, qr);
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

// ---------------------------------------------------------------------------
// Riemann solvers on one interface: Ul, Ur conserved states -> flux F.
// Neither clamps a solid face.
// ---------------------------------------------------------------------------

// the analytic flux, without an h == 0 guard (as inside the JAX solvers)
template <typename T>
__device__ __forceinline__ void swe_flux(const SweParams& p, int idir,
                                         const T* U, T* F) {
  const T h = U[IH];
  const T u = U[IU] / h;
  const T v = U[IV] / h;
  const T vel = idir == 1 ? u : v;
  F[IH] = h * vel;
  F[IU] = U[IU] * vel;
  F[IV] = U[IV] * vel;
  const int in = idir == 1 ? IU : IV;
  F[in] = F[in] + T(0.5 * p.grav) * (h * h);
  for (int n = NFIX; n < p.nvar; ++n) F[n] = U[n] * vel;
}

// Roe with the entropy fix (Toro / clawpack form)
template <typename T>
__device__ void roe(const SweParams& p, int idir, const T* Ul, const T* Ur,
                    T* F) {
  const int iun = idir == 1 ? IU : IV;
  const int iut = idir == 1 ? IV : IU;
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
  swe_flux(p, idir, Ul, Fl);
  swe_flux(p, idir, Ur, Fr);
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
  for (int n = NFIX; n < p.nvar; ++n) {
    const T delta = Ur[n] / h_r - Ul[n] / h_l;
    F[n] = F[n] + T(-0.5) * h_roe * delta * fabs(lam1);
  }
}

// HLLC (Toro), the region select in the plain version's nesting order
template <typename T>
__device__ void hllc(const SweParams& p, int idir, const T* Ul, const T* Ur,
                     T* F) {
  const int iun = idir == 1 ? IU : IV;
  const int iut = idir == 1 ? IV : IU;
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

  const bool right = region <= 1;
  const T* U = right ? Ur : Ul;
  swe_flux(p, idir, U, F);
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
  for (int n = NFIX; n < p.nvar; ++n) Us[n] = fac * U[n] / h;
  for (int n = 0; n < p.nvar; ++n) F[n] = F[n] + S * (Us[n] - U[n]);
}

template <typename T>
__device__ __forceinline__ void riemann(const SweParams& p, int idir,
                                        const T* Ul, const T* Ur, T* F) {
  if (p.riemann == 0)
    roe(p, idir, Ul, Ur, F);
  else
    hllc(p, idir, Ul, Ur, F);
}

// stage 3: the first Riemann pair on [ilo-1, ihi+1]^2, zero outside it
template <typename T>
__global__ void k_swe_riemann1(const T* __restrict__ UXL,
                               const T* __restrict__ UXR,
                               const T* __restrict__ UYL,
                               const T* __restrict__ UYR,
                               T* __restrict__ F1X, T* __restrict__ F1Y,
                               SweParams p) {
  CELL_INDEX
  T ul[MAXVAR], ur[MAXVAR], f[MAXVAR];
  const bool w1 = inwin(p, i, j, 1, 1, 1, 1);
  for (int d = 1; d <= 2; ++d) {
    const T* L = d == 1 ? UXL : UYL;
    const T* R = d == 1 ? UXR : UYR;
    T* Fd = d == 1 ? F1X : F1Y;
    if (w1) {
      for (int n = 0; n < p.nvar; ++n) {
        ul[n] = L[at(p, n, i, j)];
        ur[n] = R[at(p, n, i, j)];
      }
      riemann(p, d, ul, ur, f);
    } else {
      for (int n = 0; n < p.nvar; ++n) f[n] = T(0);
    }
    store(p, Fd, f, i, j);
  }
}

// stage 4: the transverse corrections and the second Riemann pair on the
// faces the update reads: x faces i in [ilo, ihi+1], j in [jlo, jhi]; y
// faces i in [ilo, ihi], j in [jlo, jhi+1].  These faces lie inside the
// corrections' window (lo 2, hi 1 on both axes), so every one is corrected.
template <typename T>
__global__ void k_swe_riemann2(const T* __restrict__ UXL,
                               const T* __restrict__ UXR,
                               const T* __restrict__ UYL,
                               const T* __restrict__ UYR,
                               const T* __restrict__ F1X,
                               const T* __restrict__ F1Y,
                               T* __restrict__ F2X, T* __restrict__ F2Y,
                               SweParams p) {
  CELL_INDEX
  T ul[MAXVAR], ur[MAXVAR], f[MAXVAR];

  if (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) && j <= jhi(p)) {
    const T cy = T(-0.5 * (p.dt / p.dy));
    for (int n = 0; n < p.nvar; ++n) {
      ul[n] = UXL[at(p, n, i, j)] +
              cy * (F1Y[at(p, n, i - 1, j + 1)] - F1Y[at(p, n, i - 1, j)]);
      ur[n] = UXR[at(p, n, i, j)] +
              cy * (F1Y[at(p, n, i, j + 1)] - F1Y[at(p, n, i, j)]);
    }
    riemann(p, 1, ul, ur, f);
    store(p, F2X, f, i, j);
  }

  if (i >= ilo(p) && i <= ihi(p) && j >= jlo(p) && j <= jhi(p) + 1) {
    const T cx = T(-0.5 * (p.dt / p.dx));
    for (int n = 0; n < p.nvar; ++n) {
      ul[n] = UYL[at(p, n, i, j)] +
              cx * (F1X[at(p, n, i + 1, j - 1)] - F1X[at(p, n, i, j - 1)]);
      ur[n] = UYR[at(p, n, i, j)] +
              cx * (F1X[at(p, n, i + 1, j)] - F1X[at(p, n, i, j)]);
    }
    riemann(p, 2, ul, ur, f);
    store(p, F2Y, f, i, j);
  }
}

// stage 5: the conservative update on the interior; ghosts are carried
// through from the input unchanged (stale until the next ghost fill)
template <typename T>
__global__ void k_swe_update(const T* __restrict__ U,
                             const T* __restrict__ F2X,
                             const T* __restrict__ F2Y, T* __restrict__ out,
                             SweParams p) {
  CELL_INDEX
  if (!inwin(p, i, j, 0, 0, 0, 0)) {
    for (int n = 0; n < p.nvar; ++n) out[at(p, n, i, j)] = U[at(p, n, i, j)];
    return;
  }
  const T dtdx = T(p.dt / p.dx), dtdy = T(p.dt / p.dy);
  for (int n = 0; n < p.nvar; ++n) {
    const T upd = dtdx * (F2X[at(p, n, i, j)] - F2X[at(p, n, i + 1, j)]) +
                  dtdy * (F2Y[at(p, n, i, j)] - F2Y[at(p, n, i, j + 1)]);
    out[at(p, n, i, j)] = U[at(p, n, i, j)] + upd;
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

template <typename T>
int run(const T* U, T* out, T* scratch, const int* ip, const double* dp,
        cudaStream_t st) {
  const SweParams p = load_params(ip, dp);
  if (p.nvar < 4 || p.nvar > MAXVAR || p.ng < 4 || p.nx < 1 || p.ny < 1 ||
      p.riemann < 0 || p.riemann > 1)
    return (int)cudaErrorInvalidValue;

  const size_t stack = (size_t)p.nvar * p.qx * p.qy;
  T* Q = scratch;
  T* UXL = Q + stack;
  T* UXR = UXL + stack;
  T* UYL = UXR + stack;
  T* UYR = UYL + stack;
  T* F1X = UYR + stack;
  T* F1Y = F1X + stack;
  T* F2X = F1Y + stack;
  T* F2Y = F2X + stack;

  const dim3 blk(64, 4);
  const dim3 grd((p.qy + blk.x - 1) / blk.x, (p.qx + blk.y - 1) / blk.y);
  k_swe_prim<T><<<grd, blk, 0, st>>>(U, Q, p);
  LAUNCH_CHECK;
  k_swe_states<T><<<grd, blk, 0, st>>>(Q, UXL, UXR, UYL, UYR, p);
  LAUNCH_CHECK;
  k_swe_riemann1<T><<<grd, blk, 0, st>>>(UXL, UXR, UYL, UYR, F1X, F1Y, p);
  LAUNCH_CHECK;
  k_swe_riemann2<T><<<grd, blk, 0, st>>>(UXL, UXR, UYL, UYR, F1X, F1Y, F2X,
                                         F2Y, p);
  LAUNCH_CHECK;
  k_swe_update<T><<<grd, blk, 0, st>>>(U, F2X, F2Y, out, p);
  LAUNCH_CHECK;
  return 0;
}

}  // namespace

// scratch holds 9 nvar planes of (qx, qy) in the state's dtype
extern "C" int swe_scratch_planes(int nvar) { return 9 * nvar; }

extern "C" int swe_step_f32(const float* U, float* out, float* scratch,
                            const int* ip, const double* dp, void* stream) {
  return run<float>(U, out, scratch, ip, dp, (cudaStream_t)stream);
}

extern "C" int swe_step_f64(const double* U, double* out, double* scratch,
                            const int* ip, const double* dp, void* stream) {
  return run<double>(U, out, scratch, ip, dp, (cudaStream_t)stream);
}
