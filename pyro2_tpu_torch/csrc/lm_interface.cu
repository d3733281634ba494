// lm_interface.cu -- the three interface stages of the low-Mach atmosphere
// solver (lm_atm) on Hopper.
//
// Replaces the Pallas TPU band kernels of
// pyro2_tpu/solvers/lm_atm/pallas_interface.py (`_band_call`, through
// LMInterfaceKernels.mac_vels, .rho_increment and .advect_terms), and
// computes what pyro2_tpu_torch/solvers/lm_atm/LM_atm_interface.py and the
// expressions of lm_atm/simulation.py around it compute:
//
//   lm_mac     u_MAC, v_MAC: hat states of u and v, Burgers Riemann and
//              upwind, the transverse + gradp + source corrections, then
//              Riemann and upwind again -- the full padded frames, zeros
//              outside the (lo-1, hi+2) window and the partially corrected
//              window-edge rows and columns exactly as the plain version
//              leaves them (each window is a test of the global index, so
//              no edge slabs are needed, unlike the TPU's);
//   lm_rho     the interior density increment -dt div(rho_int U_MAC): rho
//              hat states, upwind by the MAC velocities, the buf=2
//              transverse and divergence corrections, upwind again;
//   lm_states  the interior advective terms of u and v: the corrected
//              states again, upwinded by the MAC velocities, and their
//              centred differences.
//
// The MC slopes come in as planes, computed globally by
// mesh/reconstruction.limit (as the TPU kernels took them), so their window
// truncation is the global one.
//
// Stages.  Each entry is a chain of two one-thread-per-cell kernels:
// k_lm_hat (or k_lm_rho_hat) writes the first-pass interface values that
// the corrections read -- the Riemann velocities uhat, vhat and the four
// upwinded states (or rho's two) -- to scratch planes (zero outside the
// (lo-1, hi+2) window, as the plain version's), and the second kernel
// recomputes the cheap hat states of its own cell and of its neighbours'
// faces, forms the corrections of the two cells each face reads, and
// finishes.  lm_mac and lm_states both start with k_lm_hat, as the plain
// mac_vels and states both call get_interface_states.
//
// Arithmetic: the order of the plain PyTorch expressions, with -fmad=false.
// A Python float times a tensor rounds the float to T first, as here
// (T(dt / dx) * u); a tensor divided by a Python float is, on CUDA,
// PyTorch's product with the reciprocal T(1) / T(dx), which the kernels
// use too, so the kernel can equal the plain version bit for bit on the
// card.  That matters here: the bubble starts at rest, and the upwind and
// Riemann ties (s == 0, ql <= 0 <= qr) decide whole states.
//
// What bounds it on the H100: ~100-250 operations per cell against 9-11
// input planes, so the bytes (lm_kernel.work counts them: each input plane
// read once, each output written once).  This first design stages 6 (2 for
// rho) scratch planes through device memory and recomputes hat states and
// corrections per face; tiles in shared memory are the next step.
//
// Each entry point returns the first cudaGetLastError() of its chain.
//
// Build (see lm_kernel.py and util/cuda_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o liblm_interface.so lm_interface.cu

#include "grid_common.cuh"

namespace {

struct Params {
  int nx, ny, ng, qx, qy;
  double dt, dx, dy;
};

// the scalar factors, rounded to T as PyTorch rounds a Python float
template <typename T>
struct Consts {
  T dtdx, dtdy;            // dt / dx, dt / dy
  T inv_dx, inv_dy;        // the reciprocals a division by dx, dy uses
  T cx, cy;                // -0.5 dt/dx, -0.5 dt/dy
  T half_dt, mhalf_dt;     // 0.5 dt, -0.5 dt
  T mdt;                   // -dt
  __device__ explicit Consts(const Params& p)
      : dtdx(T(p.dt / p.dx)),
        dtdy(T(p.dt / p.dy)),
        inv_dx(T(1) / T(p.dx)),
        inv_dy(T(1) / T(p.dy)),
        cx(T(-0.5 * (p.dt / p.dx))),
        cy(T(-0.5 * (p.dt / p.dy))),
        half_dt(T(0.5 * p.dt)),
        mhalf_dt(T(-0.5 * p.dt)),
        mdt(T(-p.dt)) {}
};

__device__ __forceinline__ size_t ix(const Params& p, int i, int j) {
  return (size_t)i * p.qy + j;
}

// windows: buf=2, buf=1, and the (lo-1, hi+2) window of Riemann and upwind
__device__ __forceinline__ bool w2(const Params& p, int i, int j) {
  return inwin(p, i, j, 2, 2, 2, 2);
}
__device__ __forceinline__ bool w1(const Params& p, int i, int j) {
  return inwin(p, i, j, 1, 1, 1, 1);
}
__device__ __forceinline__ bool w12(const Params& p, int i, int j) {
  return inwin(p, i, j, 1, 2, 1, 2);
}
__device__ __forceinline__ bool interior(const Params& p, int i, int j) {
  return inwin(p, i, j, 0, 0, 0, 0);
}

// the Burgers Riemann velocity and the upwinded state
template <typename T>
__device__ __forceinline__ T riemann(T ql, T qr) {
  if (ql > T(0) && ql + qr > T(0)) return ql;
  if (ql <= T(0) && qr >= T(0)) return T(0);
  return qr;
}

template <typename T>
__device__ __forceinline__ T upwind(T ql, T qr, T s) {
  if (s > T(0)) return ql;
  if (s == T(0)) return T(0.5) * (ql + qr);
  return qr;
}

// hat states, predicted from cell (a, b) of the buf=2 window with normal
// velocity w and slope d: the left state (stored one zone up) and the right
template <typename T>
__device__ __forceinline__ T hat_l(T q, T w, T d, T dtdx) {
  return q + T(0.5) * (T(1) - dtdx * w) * d;
}
template <typename T>
__device__ __forceinline__ T hat_r(T q, T w, T d, T dtdx) {
  return q - T(0.5) * (T(1) + dtdx * w) * d;
}

// the input planes of the velocity stages
template <typename T>
struct Vel {
  const T *u, *v, *lux, *lvx, *luy, *lvy, *gpx, *gpy, *src;
};

// the hat states at frame cell (i, j): zero where the predicting cell lies
// outside the buf=2 window
template <typename T>
struct Hats {
  T u_xl, u_xr, v_xl, v_xr, u_yl, u_yr, v_yl, v_yr;
};

template <typename T>
__device__ Hats<T> hats(const Params& p, const Consts<T>& k, const Vel<T>& a,
                        int i, int j) {
  Hats<T> h;
  h.u_xl = h.v_xl = h.u_xr = h.v_xr = T(0);
  h.u_yl = h.v_yl = h.u_yr = h.v_yr = T(0);
  if (w2(p, i - 1, j)) {
    const size_t c = ix(p, i - 1, j);
    h.u_xl = hat_l(a.u[c], a.u[c], a.lux[c], k.dtdx);
    h.v_xl = hat_l(a.v[c], a.u[c], a.lvx[c], k.dtdx);
  }
  if (w2(p, i, j - 1)) {
    const size_t c = ix(p, i, j - 1);
    h.u_yl = hat_l(a.u[c], a.v[c], a.luy[c], k.dtdy);
    h.v_yl = hat_l(a.v[c], a.v[c], a.lvy[c], k.dtdy);
  }
  if (w2(p, i, j)) {
    const size_t c = ix(p, i, j);
    h.u_xr = hat_r(a.u[c], a.u[c], a.lux[c], k.dtdx);
    h.v_xr = hat_r(a.v[c], a.u[c], a.lvx[c], k.dtdx);
    h.u_yr = hat_r(a.u[c], a.v[c], a.luy[c], k.dtdy);
    h.v_yr = hat_r(a.v[c], a.v[c], a.lvy[c], k.dtdy);
  }
  return h;
}

// the first-pass planes of k_lm_hat
template <typename T>
struct First {
  T *uhat, *vhat, *uxi, *vxi, *uyi, *vyi;
};

// the four corrections of buf=1 window cell (i, j) (zero outside it), from
// the first-pass planes; names as in LM_atm_interface.get_interface_states
template <typename T>
__device__ __forceinline__ T du_x(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1(p, i, j)) return T(0);
  const size_t c = ix(p, i, j);
  const T vbar = T(0.5) * (s.vhat[c] + s.vhat[c + 1]);
  const T vu_y = vbar * (s.uyi[c + 1] - s.uyi[c]);
  return k.cy * vu_y - k.half_dt * a.gpx[c];
}

template <typename T>
__device__ __forceinline__ T dv_x(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1(p, i, j)) return T(0);
  const size_t c = ix(p, i, j);
  const T vbar = T(0.5) * (s.vhat[c] + s.vhat[c + 1]);
  const T vv_y = vbar * (s.vyi[c + 1] - s.vyi[c]);
  return k.cy * vv_y - k.half_dt * a.gpy[c] + k.half_dt * a.src[c];
}

template <typename T>
__device__ __forceinline__ T dv_y(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1(p, i, j)) return T(0);
  const size_t c = ix(p, i, j), cp = ix(p, i + 1, j);
  const T ubar = T(0.5) * (s.uhat[c] + s.uhat[cp]);
  const T uv_x = ubar * (s.vxi[cp] - s.vxi[c]);
  return k.cx * uv_x - k.half_dt * a.gpy[c] + k.half_dt * a.src[c];
}

template <typename T>
__device__ __forceinline__ T du_y(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1(p, i, j)) return T(0);
  const size_t c = ix(p, i, j), cp = ix(p, i + 1, j);
  const T ubar = T(0.5) * (s.uhat[c] + s.uhat[cp]);
  const T uu_x = ubar * (s.uxi[cp] - s.uxi[c]);
  return k.cx * uu_x - k.half_dt * a.gpx[c];
}

// -- k_lm_hat: hat states -> Riemann -> upwind, the first-pass planes ------

template <typename T>
__global__ void k_lm_hat(Params p, Vel<T> a, First<T> s) {
  CELL_INDEX
  const size_t c = ix(p, i, j);
  T uhat = T(0), vhat = T(0), uxi = T(0), vxi = T(0), uyi = T(0),
    vyi = T(0);
  if (w12(p, i, j)) {
    const Consts<T> k(p);
    const Hats<T> h = hats(p, k, a, i, j);
    uhat = riemann(h.u_xl, h.u_xr);
    vhat = riemann(h.v_yl, h.v_yr);
    uxi = upwind(h.u_xl, h.u_xr, uhat);
    vxi = upwind(h.v_xl, h.v_xr, uhat);
    uyi = upwind(h.u_yl, h.u_yr, vhat);
    vyi = upwind(h.v_yl, h.v_yr, vhat);
  }
  s.uhat[c] = uhat;
  s.vhat[c] = vhat;
  s.uxi[c] = uxi;
  s.vxi[c] = vxi;
  s.uyi[c] = uyi;
  s.vyi[c] = vyi;
}

// -- k_lm_mac: corrected u on x faces, v on y faces, Riemann and upwind ----

template <typename T>
__global__ void k_lm_mac(Params p, Vel<T> a, First<T> s, T* u_mac,
                         T* v_mac) {
  CELL_INDEX
  const size_t c = ix(p, i, j);
  T um = T(0), vm = T(0);
  if (w12(p, i, j)) {
    const Consts<T> k(p);
    const Hats<T> h = hats(p, k, a, i, j);
    const T uxl = h.u_xl + du_x(p, k, a, s, i - 1, j);
    const T uxr = h.u_xr + du_x(p, k, a, s, i, j);
    const T vyl = h.v_yl + dv_y(p, k, a, s, i, j - 1);
    const T vyr = h.v_yr + dv_y(p, k, a, s, i, j);
    um = upwind(uxl, uxr, riemann(uxl, uxr));
    vm = upwind(vyl, vyr, riemann(vyl, vyr));
  }
  u_mac[c] = um;
  v_mac[c] = vm;
}

// -- k_lm_states: the advective terms of the provisional update ------------

// the final states of u and v on x face (i, j) (upwind by u_MAC) or on y
// face (i, j) (upwind by v_MAC)
template <typename T>
__device__ void x_face(const Params& p, const Consts<T>& k, const Vel<T>& a,
                       const First<T>& s, const T* u_mac, int i, int j,
                       T& uf, T& vf) {
  const Hats<T> h = hats(p, k, a, i, j);
  const T ul = h.u_xl + du_x(p, k, a, s, i - 1, j);
  const T ur = h.u_xr + du_x(p, k, a, s, i, j);
  const T vl = h.v_xl + dv_x(p, k, a, s, i - 1, j);
  const T vr = h.v_xr + dv_x(p, k, a, s, i, j);
  const T w = w12(p, i, j) ? u_mac[ix(p, i, j)] : T(0);
  uf = w12(p, i, j) ? upwind(ul, ur, w) : T(0);
  vf = w12(p, i, j) ? upwind(vl, vr, w) : T(0);
}

template <typename T>
__device__ void y_face(const Params& p, const Consts<T>& k, const Vel<T>& a,
                       const First<T>& s, const T* v_mac, int i, int j,
                       T& uf, T& vf) {
  const Hats<T> h = hats(p, k, a, i, j);
  const T ul = h.u_yl + du_y(p, k, a, s, i, j - 1);
  const T ur = h.u_yr + du_y(p, k, a, s, i, j);
  const T vl = h.v_yl + dv_y(p, k, a, s, i, j - 1);
  const T vr = h.v_yr + dv_y(p, k, a, s, i, j);
  const T w = w12(p, i, j) ? v_mac[ix(p, i, j)] : T(0);
  uf = w12(p, i, j) ? upwind(ul, ur, w) : T(0);
  vf = w12(p, i, j) ? upwind(vl, vr, w) : T(0);
}

template <typename T>
__global__ void k_lm_states(Params p, Vel<T> a, First<T> s, const T* u_mac,
                            const T* v_mac, T* adv_x, T* adv_y) {
  CELL_INDEX
  if (!interior(p, i, j)) return;
  const Consts<T> k(p);
  T ux0, vx0, ux1, vx1, uy0, vy0, uy1, vy1;
  x_face(p, k, a, s, u_mac, i, j, ux0, vx0);
  x_face(p, k, a, s, u_mac, i + 1, j, ux1, vx1);
  y_face(p, k, a, s, v_mac, i, j, uy0, vy0);
  y_face(p, k, a, s, v_mac, i, j + 1, uy1, vy1);
  const size_t c = ix(p, i, j);
  const T ubar = T(0.5) * (u_mac[c] + u_mac[ix(p, i + 1, j)]);
  const T vbar = T(0.5) * (v_mac[c] + v_mac[c + 1]);
  const size_t o = (size_t)(i - p.ng) * p.ny + (j - p.ng);
  adv_x[o] = ubar * (ux1 - ux0) * k.inv_dx + vbar * (uy1 - uy0) * k.inv_dy;
  adv_y[o] = ubar * (vx1 - vx0) * k.inv_dx + vbar * (vy1 - vy0) * k.inv_dy;
}

// -- the density stages -----------------------------------------------------

template <typename T>
struct Rho {
  const T *rho, *um, *vm, *lrx, *lry;
};

// rho's hat states at frame cell (i, j), predicted with the MAC velocity of
// the face they sit on
template <typename T>
__device__ void rho_hats(const Params& p, const Consts<T>& k, const Rho<T>& a,
                         int i, int j, T& xl, T& xr, T& yl, T& yr) {
  const size_t c = ix(p, i, j);
  xl = xr = yl = yr = T(0);
  if (w2(p, i - 1, j)) {
    const size_t m = ix(p, i - 1, j);
    xl = hat_l(a.rho[m], a.um[c], a.lrx[m], k.dtdx);
  }
  if (w2(p, i, j - 1)) {
    const size_t m = ix(p, i, j - 1);
    yl = hat_l(a.rho[m], a.vm[c], a.lry[m], k.dtdy);
  }
  if (w2(p, i, j)) {
    xr = hat_r(a.rho[c], a.um[c], a.lrx[c], k.dtdx);
    yr = hat_r(a.rho[c], a.vm[c], a.lry[c], k.dtdy);
  }
}

template <typename T>
__global__ void k_lm_rho_hat(Params p, Rho<T> a, T* rxi, T* ryi) {
  CELL_INDEX
  const size_t c = ix(p, i, j);
  T x = T(0), y = T(0);
  if (w12(p, i, j)) {
    const Consts<T> k(p);
    T xl, xr, yl, yr;
    rho_hats(p, k, a, i, j, xl, xr, yl, yr);
    x = upwind(xl, xr, a.um[c]);
    y = upwind(yl, yr, a.vm[c]);
  }
  rxi[c] = x;
  ryi[c] = y;
}

// the buf=2 corrections of cell (i, j) (zero outside the window)
template <typename T>
__device__ __forceinline__ T dx_corr(const Params& p, const Consts<T>& k,
                                     const Rho<T>& a, const T* ryi, int i,
                                     int j) {
  if (!w2(p, i, j)) return T(0);
  const size_t c = ix(p, i, j), cp = ix(p, i + 1, j);
  const T u_x = (a.um[cp] - a.um[c]) * k.inv_dx;
  const T rhov_y = (ryi[c + 1] * a.vm[c + 1] - ryi[c] * a.vm[c]) * k.inv_dy;
  return k.mhalf_dt * (rhov_y + a.rho[c] * u_x);
}

template <typename T>
__device__ __forceinline__ T dy_corr(const Params& p, const Consts<T>& k,
                                     const Rho<T>& a, const T* rxi, int i,
                                     int j) {
  if (!w2(p, i, j)) return T(0);
  const size_t c = ix(p, i, j), cp = ix(p, i + 1, j);
  const T v_y = (a.vm[c + 1] - a.vm[c]) * k.inv_dy;
  const T rhou_x = (rxi[cp] * a.um[cp] - rxi[c] * a.um[c]) * k.inv_dx;
  return k.mhalf_dt * (rhou_x + a.rho[c] * v_y);
}

// the final rho states on x face (i, j) and y face (i, j)
template <typename T>
__device__ T rho_x_face(const Params& p, const Consts<T>& k, const Rho<T>& a,
                        const T* ryi, int i, int j) {
  T xl, xr, yl, yr;
  rho_hats(p, k, a, i, j, xl, xr, yl, yr);
  xl = xl + dx_corr(p, k, a, ryi, i - 1, j);
  xr = xr + dx_corr(p, k, a, ryi, i, j);
  return w12(p, i, j) ? upwind(xl, xr, a.um[ix(p, i, j)]) : T(0);
}

template <typename T>
__device__ T rho_y_face(const Params& p, const Consts<T>& k, const Rho<T>& a,
                        const T* rxi, int i, int j) {
  T xl, xr, yl, yr;
  rho_hats(p, k, a, i, j, xl, xr, yl, yr);
  yl = yl + dy_corr(p, k, a, rxi, i, j - 1);
  yr = yr + dy_corr(p, k, a, rxi, i, j);
  return w12(p, i, j) ? upwind(yl, yr, a.vm[ix(p, i, j)]) : T(0);
}

template <typename T>
__global__ void k_lm_rho(Params p, Rho<T> a, const T* rxi, const T* ryi,
                         T* inc) {
  CELL_INDEX
  if (!interior(p, i, j)) return;
  const Consts<T> k(p);
  const size_t c = ix(p, i, j), cp = ix(p, i + 1, j);
  const T rx0 = rho_x_face(p, k, a, ryi, i, j);
  const T rx1 = rho_x_face(p, k, a, ryi, i + 1, j);
  const T ry0 = rho_y_face(p, k, a, rxi, i, j);
  const T ry1 = rho_y_face(p, k, a, rxi, i, j + 1);
  const size_t o = (size_t)(i - p.ng) * p.ny + (j - p.ng);
  inc[o] = k.mdt * ((rx1 * a.um[cp] - rx0 * a.um[c]) * k.inv_dx +
                    (ry1 * a.vm[c + 1] - ry0 * a.vm[c]) * k.inv_dy);
}

// -- launches -----------------------------------------------------------------

Params make_params(const int* ints, const double* dbl) {
  Params p;
  p.nx = ints[0];
  p.ny = ints[1];
  p.ng = ints[2];
  p.qx = p.nx + 2 * p.ng;
  p.qy = p.ny + 2 * p.ng;
  p.dt = dbl[0];
  p.dx = dbl[1];
  p.dy = dbl[2];
  return p;
}

bool valid(const Params& p) { return p.nx > 0 && p.ny > 0 && p.ng >= 4; }

dim3 block() { return dim3(64, 4); }
dim3 grid(const Params& p) {
  const dim3 b = block();
  return dim3((p.qy + b.x - 1) / b.x, (p.qx + b.y - 1) / b.y);
}

// planes: u, v, lux, lvx, luy, lvy, gpx, gpy, src
template <typename T>
Vel<T> vel(const T* const* in) {
  return Vel<T>{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                in[8]};
}

// scratch holds 6 (qx, qy) planes
template <typename T>
First<T> first(T* scratch, const Params& p) {
  const size_t n = (size_t)p.qx * p.qy;
  return First<T>{scratch, scratch + n, scratch + 2 * n,
                  scratch + 3 * n, scratch + 4 * n, scratch + 5 * n};
}

template <typename T>
int mac(const T* const* in, T* u_mac, T* v_mac, T* scratch, const int* ints,
        const double* dbl, cudaStream_t st) {
  const Params p = make_params(ints, dbl);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const Vel<T> a = vel<T>(in);
  const First<T> s = first(scratch, p);
  k_lm_hat<T><<<grid(p), block(), 0, st>>>(p, a, s);
  LAUNCH_CHECK;
  k_lm_mac<T><<<grid(p), block(), 0, st>>>(p, a, s, u_mac, v_mac);
  LAUNCH_CHECK;
  return 0;
}

// in: the 9 velocity-stage planes, then u_MAC, v_MAC
template <typename T>
int states(const T* const* in, T* adv_x, T* adv_y, T* scratch,
           const int* ints, const double* dbl, cudaStream_t st) {
  const Params p = make_params(ints, dbl);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const Vel<T> a = vel<T>(in);
  const First<T> s = first(scratch, p);
  k_lm_hat<T><<<grid(p), block(), 0, st>>>(p, a, s);
  LAUNCH_CHECK;
  k_lm_states<T><<<grid(p), block(), 0, st>>>(p, a, s, in[9], in[10], adv_x,
                                             adv_y);
  LAUNCH_CHECK;
  return 0;
}

// in: rho, u_MAC, v_MAC, lrx, lry; scratch holds 2 (qx, qy) planes
template <typename T>
int rho(const T* const* in, T* inc, T* scratch, const int* ints,
        const double* dbl, cudaStream_t st) {
  const Params p = make_params(ints, dbl);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const Rho<T> a{in[0], in[1], in[2], in[3], in[4]};
  T* rxi = scratch;
  T* ryi = scratch + (size_t)p.qx * p.qy;
  k_lm_rho_hat<T><<<grid(p), block(), 0, st>>>(p, a, rxi, ryi);
  LAUNCH_CHECK;
  k_lm_rho<T><<<grid(p), block(), 0, st>>>(p, a, rxi, ryi, inc);
  LAUNCH_CHECK;
  return 0;
}

}  // namespace

// ints: nx, ny, ng; doubles: dt, dx, dy.  `in` is a host array of device
// plane pointers, each a contiguous (nx + 2 ng, ny + 2 ng) frame.
#define ENTRIES(T, SFX)                                                      \
  extern "C" int lm_mac_##SFX(const T* const* in, T* u_mac, T* v_mac,        \
                              T* scratch, const int* ints, const double* dbl, \
                              void* stream) {                                \
    return mac<T>(in, u_mac, v_mac, scratch, ints, dbl,                      \
                  (cudaStream_t)stream);                                     \
  }                                                                          \
  extern "C" int lm_states_##SFX(const T* const* in, T* adv_x, T* adv_y,     \
                                 T* scratch, const int* ints,                \
                                 const double* dbl, void* stream) {          \
    return states<T>(in, adv_x, adv_y, scratch, ints, dbl,                   \
                     (cudaStream_t)stream);                                  \
  }                                                                          \
  extern "C" int lm_rho_##SFX(const T* const* in, T* inc, T* scratch,        \
                              const int* ints, const double* dbl,            \
                              void* stream) {                                \
    return rho<T>(in, inc, scratch, ints, dbl, (cudaStream_t)stream);        \
  }

ENTRIES(float, f32)
ENTRIES(double, f64)
