// ctu_step.cu -- one compressible CTU step (Cartesian geometry) on Hopper.
//
// Replaces the fused Pallas TPU kernel
// pyro2_tpu/solvers/compressible/pallas_step.py::make_pallas_ctu_step_padded_general
// (body _local_step_fn): density floor, interface states (prim, flattening,
// limited slopes, characteristic tracing), half-dt sources, first Riemann
// pair + transverse corrections, final Riemann pair, artificial viscosity,
// conservative update, predictor-corrector sources and sponge.  HLLC,
// HLLC_lm and CGF; limiter 0/1/2; flattening on or off; solid walls on any
// edge; passive scalars (nvar > 4, up to MAXVAR).
//
// Layout: the plain (nvar, nx + 2 ng, ny + 2 ng) state stack, y contiguous.
// Every kernel is one thread per cell or interface with threadIdx.x along
// y, so neighbouring threads touch neighbouring addresses.  Ragged edges
// are masked against the global index, so any nx, ny works.  Windows are
// compared against the global index too (the floor on the interior, the
// half-dt sources on the buf=1 window, solid walls at ilo / ihi+1 and
// jlo / jhi+1), which reproduces the windowed semantics of the plain
// PyTorch step exactly.
//
// What bounds it on the H100: the step itself is arithmetic, ~1.1k
// floating-point operations per zone (many of them divides, square roots
// and pows) against 2 nvar values read and written per zone, so its bound
// is the fp32 rate.  This first design is simple instead: it stages its
// intermediates through device memory -- primitives, flattening
// coefficients, the four interface-state stacks and two flux pairs, about
// 28 nvar planes of traffic per zone over the six stages -- and keeps the
// per-variable arrays (MAXVAR long, indexed by run-time variable indices)
// in local memory.  chip_smoke.py prints its time beside the bound and a
// per-stage profile; fusing the stages into shared-memory tiles with 4-cell
// halos, and compile-time variable indices, are the next steps for speed.
// The scratch is allocated by the wrapper (torch.empty) and nothing is
// allocated here.  The stages run in order on the caller's stream; the
// entry point returns the first cudaGetLastError().
//
// Build (see ctu_kernel.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libctu_step.so ctu_step.cu
// -fmad=false keeps each multiply and add rounded on its own, as the
// plain PyTorch step rounds them, so the two agree to the last bits that
// the order of operations allows.

#include "euler_common.cuh"

namespace {

// trace cell-centred primitives q (slopes dq) to its two faces along idir
template <typename T>
__device__ void trace(const Params& p, int idir, const T* q, const T* dq,
                      T* ql, T* qr) {
  const T dtdx = T(p.dt / (idir == 1 ? p.dx : p.dy));
  const T dtdx4 = T(0.25 * (p.dt / (idir == 1 ? p.dx : p.dy)));
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

// stage 3: interface states.  Cell (i, j) writes U_xr(i, j), U_xl(i+1, j),
// U_yr(i, j), U_yl(i, j+1): traced states inside the buf=2 window, zero
// outside it.  Row i = 0 / column j = 0 of U_xl / U_yl are zero.
template <typename T>
__global__ void k_states(const T* __restrict__ Q, const T* __restrict__ XI,
                         const T* __restrict__ S, T* __restrict__ UXL,
                         T* __restrict__ UXR, T* __restrict__ UYL,
                         T* __restrict__ UYR, Params p) {
  CELL_INDEX
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

  const T xi = flat_xi(p, Q, XI, i, j);

  T q[MAXVAR], dq[MAXVAR], ql[MAXVAR], qr[MAXVAR];
  for (int n = 0; n < p.nvar; ++n) q[n] = Q[n * plane + c];
  for (int d = 1; d <= 2; ++d) {
    const int di = d == 1, dj = d == 2;
    for (int n = 0; n < p.nvar; ++n)
      dq[n] = xi * slope(p, Q + n * plane, i, j, di, dj);
    trace(p, d, q, dq, ql, qr);
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

// stage 4: the first Riemann pair on the buf=1 window (zero outside)
template <typename T>
__global__ void k_riemann1(const T* __restrict__ UXL,
                           const T* __restrict__ UXR,
                           const T* __restrict__ UYL,
                           const T* __restrict__ UYR, T* __restrict__ F1X,
                           T* __restrict__ F1Y, Params p) {
  CELL_INDEX
  T ul[MAXVAR], ur[MAXVAR], f[MAXVAR];
  const bool w1 = inwin(p, i, j, 1, 1, 1, 1);
  for (int d = 1; d <= 2; ++d) {
    const T* L = d == 1 ? UXL : UYL;
    const T* R = d == 1 ? UXR : UYR;
    T* F = d == 1 ? F1X : F1Y;
    if (w1) {
      for (int n = 0; n < p.nvar; ++n) {
        ul[n] = L[at(p, n, i, j)];
        ur[n] = R[at(p, n, i, j)];
      }
      riemann(p, d, ul, ur, i, j, f);
    } else {
      for (int n = 0; n < p.nvar; ++n) f[n] = T(0);
    }
    for (int n = 0; n < p.nvar; ++n) F[at(p, n, i, j)] = f[n];
  }
}


// stage 5: transverse corrections, the final Riemann pair and artificial
// viscosity on the faces the update reads: x faces i in [ilo, ihi+1],
// y faces j in [jlo, jhi+1]
template <typename T>
__global__ void k_riemann2(const T* __restrict__ U, const T* __restrict__ Q,
                           const T* __restrict__ UXL,
                           const T* __restrict__ UXR,
                           const T* __restrict__ UYL,
                           const T* __restrict__ UYR,
                           const T* __restrict__ F1X,
                           const T* __restrict__ F1Y, T* __restrict__ F2X,
                           T* __restrict__ F2Y, Params p) {
  CELL_INDEX
  const T mhdtV = T(-(0.5 * p.dt / (p.dx * p.dy)));
  const T Ax = T(p.dy), Ay = T(p.dx);
  T ul[MAXVAR], ur[MAXVAR], f[MAXVAR];

  if (i >= ilo(p) && i <= ihi(p) + 1 && j >= jlo(p) && j <= jhi(p)) {
    for (int n = 0; n < p.nvar; ++n) {
      ul[n] = UXL[at(p, n, i, j)] +
              mhdtV * (F1Y[at(p, n, i - 1, j + 1)] * Ay -
                       F1Y[at(p, n, i - 1, j)] * Ay);
      ur[n] = UXR[at(p, n, i, j)] +
              mhdtV * (F1Y[at(p, n, i, j + 1)] * Ay -
                       F1Y[at(p, n, i, j)] * Ay);
    }
    riemann(p, 1, ul, ur, i, j, f);
    if (i <= ihi(p)) {
      const T divU = T(0.5) * (vertex_div(p, Q, i, j) +
                               vertex_div(p, Q, i, j + 1));
      const T av = T(p.cvisc) * fmax(-divU * T(p.dx), T(0));
      for (int n = 0; n < p.nvar; ++n)
        f[n] = f[n] + av * (ldU(U, p, n, i - 1, j) - ldU(U, p, n, i, j));
    }
    for (int n = 0; n < p.nvar; ++n) F2X[at(p, n, i, j)] = f[n];
  }

  if (i >= ilo(p) && i <= ihi(p) && j >= jlo(p) && j <= jhi(p) + 1) {
    for (int n = 0; n < p.nvar; ++n) {
      ul[n] = UYL[at(p, n, i, j)] +
              mhdtV * (F1X[at(p, n, i + 1, j - 1)] * Ax -
                       F1X[at(p, n, i, j - 1)] * Ax);
      ur[n] = UYR[at(p, n, i, j)] +
              mhdtV * (F1X[at(p, n, i + 1, j)] * Ax -
                       F1X[at(p, n, i, j)] * Ax);
    }
    riemann(p, 2, ul, ur, i, j, f);
    if (j <= jhi(p)) {
      const T divU = T(0.5) * (vertex_div(p, Q, i, j) +
                               vertex_div(p, Q, i + 1, j));
      const T av = T(p.cvisc) * fmax(-divU * T(p.dy), T(0));
      for (int n = 0; n < p.nvar; ++n)
        f[n] = f[n] + av * (ldU(U, p, n, i, j - 1) - ldU(U, p, n, i, j));
    }
    for (int n = 0; n < p.nvar; ++n) F2Y[at(p, n, i, j)] = f[n];
  }
}

// stage 6: conservative update, predictor-corrector sources and sponge on
// the interior; ghosts are carried through from the input unchanged
template <typename T>
__global__ void k_update(const T* __restrict__ U, const T* __restrict__ F2X,
                         const T* __restrict__ F2Y, T* __restrict__ out,
                         Params p) {
  CELL_INDEX
  if (!inwin(p, i, j, 0, 0, 0, 0)) {
    for (int n = 0; n < p.nvar; ++n) out[at(p, n, i, j)] = U[at(p, n, i, j)];
    return;
  }
  const T dtdV = T(p.dt / (p.dx * p.dy));
  const T Ax = T(p.dy), Ay = T(p.dx);
  T u[MAXVAR];
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


template <typename T>
int run(const T* U, const T* S, T* out, T* scratch, const int* ip,
        const double* dp, cudaStream_t st) {
  const Params p = load_params(ip, dp, false);
  if (p.nvar < 4 || p.nvar > MAXVAR || p.ng < 4 || p.nx < 1 || p.ny < 1)
    return (int)cudaErrorInvalidValue;
  if (p.with_sources && S == nullptr) return (int)cudaErrorInvalidValue;

  const size_t plane = (size_t)p.qx * p.qy;
  const size_t stack = (size_t)p.nvar * plane;
  T* Q = scratch;
  T* XI = Q + stack;
  T* UXL = XI + 2 * plane;
  T* UXR = UXL + stack;
  T* UYL = UXR + stack;
  T* UYR = UYL + stack;
  T* F1X = UYR + stack;
  T* F1Y = F1X + stack;
  T* F2X = F1Y + stack;
  T* F2Y = F2X + stack;

  const dim3 blk(64, 4);
  const dim3 grd((p.qy + blk.x - 1) / blk.x, (p.qx + blk.y - 1) / blk.y);
  k_prim<T><<<grd, blk, 0, st>>>(U, Q, p);
  LAUNCH_CHECK;
  if (p.flatten) {
    k_flatten<T><<<grd, blk, 0, st>>>(Q, XI, p);
    LAUNCH_CHECK;
  }
  k_states<T><<<grd, blk, 0, st>>>(Q, XI, S, UXL, UXR, UYL, UYR, p);
  LAUNCH_CHECK;
  k_riemann1<T><<<grd, blk, 0, st>>>(UXL, UXR, UYL, UYR, F1X, F1Y, p);
  LAUNCH_CHECK;
  k_riemann2<T><<<grd, blk, 0, st>>>(U, Q, UXL, UXR, UYL, UYR, F1X, F1Y, F2X,
                                     F2Y, p);
  LAUNCH_CHECK;
  k_update<T><<<grd, blk, 0, st>>>(U, F2X, F2Y, out, p);
  LAUNCH_CHECK;
  return 0;
}

}  // namespace

// scratch holds 8 nvar + nvar + 2 planes of (qx, qy) in the state's dtype
extern "C" int ctu_scratch_planes(int nvar) { return 9 * nvar + 2; }

extern "C" int ctu_step_f32(const float* U, const float* S, float* out,
                            float* scratch, const int* ip, const double* dp,
                            void* stream) {
  return run<float>(U, S, out, scratch, ip, dp, (cudaStream_t)stream);
}

extern "C" int ctu_step_f64(const double* U, const double* S, double* out,
                            double* scratch, const int* ip, const double* dp,
                            void* stream) {
  return run<double>(U, S, out, scratch, ip, dp, (cudaStream_t)stream);
}
