// lm_interface.cu -- the three interface stages of the low-Mach atmosphere
// solver (lm_atm) on Hopper, one kernel launch each.
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
// The design.  Each entry is one launch of one kernel (k_lm_mac, k_lm_rho,
// k_lm_states); each block owns a tile of output cells (lm_kernel.plan
// hands it the tile, the layout of its shared memory and the grid) and
// runs three phases separated by block barriers:
//   1. load: the input planes (9 for mac, 5 for rho, 11 for states) over
//      the tile and a halo -- 2 cells below it, 1 above (2 for rho, whose
//      divergence corrections read the MAC velocity two cells up) -- into
//      shared memory with asynchronous copies (cp.async), all in flight at
//      once, zero beyond the frame's edge, where no window reads;
//   2. first pass: the values the corrections read, over the tile and a
//      1-cell ring, into shared memory -- the Riemann velocities uhat, vhat
//      and the four upwinded states (rho: its two), zero outside the
//      (lo-1, hi+2) window, as the plain version's;
//   3. finish: mac forms its cell's two corrected faces and writes them
//      (the tiles cover the whole frame, so the edge tiles write the
//      frame's zeros); rho and states first form the final states of every
//      x and y face of the tile once (faces), then the interior cells'
//      differences, and write only the (nx, ny) outputs.
// A first-pass value at (a, b) reads the inputs at (a-1, b), (a, b-1) and
// (a, b); a correction at (i, j) reads first-pass values at (i, j+1) or
// (i+1, j); a cell reads corrections at i-1 .. i+1, j-1 .. j+1.  Hence the
// ring of 1 and the input halo of 2 below and 1 above.  Nothing is
// allocated here and there is no scratch in device memory.
//
// The phases are bound by the instructions they issue, not by the bytes:
// each cell reads ~15-50 values from shared memory.  So each entry's
// kernel is compiled for its tile (LmTile: 16 x 32 for mac, 16 x 64 for
// rho, 8 x 64 for states, 256 threads; the fastest tiles and blocks timed
// on the H100), which makes every box's row pitch and every plane's place
// a constant and a neighbour's address an immediate offset; and a tile
// inside the interior (all but the edge tiles) runs its phases without
// the window tests, which all hold there.
//
// Arithmetic: the order of the plain PyTorch expressions, with -fmad=false.
// A Python float times a tensor rounds the float to T first, as here
// (T(dt / dx) * u); a tensor divided by a Python float is, on CUDA,
// PyTorch's product with the reciprocal T(1) / T(dx), which the kernels
// use too, so the kernel can equal the plain version bit for bit on the
// card.  That matters here: the bubble starts at rest, and the upwind and
// Riemann ties (s == 0, ql <= 0 <= qr) decide whole states.  Each value's
// operations are those of the first design (a chain of two one-thread-per-
// cell kernels through scratch planes); only where the intermediates live
// changed, so the bits are the same.
//
// What bounds it on the H100: ~100-130 operations per cell against 9-11
// input planes, so the bytes (lm_kernel.work counts them: each input plane
// read once, each output written once).  The tiles read each neighbour from
// shared memory; the halo and the ring are recomputed by the neighbouring
// blocks (1.1-1.2x the cells with these tiles).
//
// Each entry point returns the launch's cudaGetLastError() (or
// cudaErrorInvalidValue for a plan or frame the kernel does not take).
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

// windows: buf=2, buf=1, the (lo-1, hi+2) window of Riemann and upwind,
// and the interior.  W: the tile tests them by global index; a tile whose
// ring and faces lie inside every window (inner) takes W = false, where
// each test is true and compiles away
template <bool W>
__device__ __forceinline__ bool w2(const Params& p, int i, int j) {
  return !W || inwin(p, i, j, 2, 2, 2, 2);
}
template <bool W>
__device__ __forceinline__ bool w1(const Params& p, int i, int j) {
  return !W || inwin(p, i, j, 1, 1, 1, 1);
}
template <bool W>
__device__ __forceinline__ bool w12(const Params& p, int i, int j) {
  return !W || inwin(p, i, j, 1, 2, 1, 2);
}
template <bool W>
__device__ __forceinline__ bool interior(const Params& p, int i, int j) {
  return !W || inwin(p, i, j, 0, 0, 0, 0);
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

// -- the launch plan ---------------------------------------------------------

enum { MAC = 0, RHO = 1, STATES = 2 };

// the input planes each entry loads, its first-pass planes, its face planes
// and its input halo above the tile (lm_kernel.PLANES, FIRST, FACES, HALO)
__host__ __device__ constexpr int n_in(int e) {
  return e == MAC ? 9 : e == RHO ? 5 : 11;
}
__host__ __device__ constexpr int n_first(int e) { return e == RHO ? 2 : 6; }
__host__ __device__ constexpr int n_faces(int e) {
  return e == MAC ? 0 : e == RHO ? 2 : 4;
}
constexpr int HALO_LO = 2, RING = 1;
__host__ __device__ constexpr int halo_hi(int e) { return e == RHO ? 2 : 1; }

// lm_kernel.plan: the output tile (tx rows along x, ty columns along y),
// the block's threads, the input halo below and above the tile, where the
// input, first-pass and face planes start in the block's shared memory (in
// elements of T), its bytes, and the grid of tiles (blocks along y, along
// x).  mac's tiles cover the whole frame from its corner, rho's and
// states' the interior.
struct LmPlan {
  int tx, ty, threads;
  int lo, hi;
  int in, fp, fc;
  int smem;
  int gx, gy;
};

constexpr int LM_PLAN_INTS = 11;

// the block of entry E: 256 threads; the fewest blocks an SM should hold,
// which bounds the registers a thread may take (lm_kernel.THREADS, BLOCKS)
template <typename T, int E>
struct LmLaunch {
  static constexpr int threads = 256;
  static constexpr int blocks = E == STATES && sizeof(T) == 4 ? 4 : 2;
};

// the tile each entry's kernel is compiled for (lm_kernel.TILES, the
// fastest of those timed on the H100), so that every box's row pitch and
// every plane's place in shared memory are constants and a neighbour's
// address is an immediate offset
template <int E>
struct LmTile {
  static constexpr int tx = E == STATES ? 8 : 16;
  static constexpr int ty = E == MAC ? 32 : 64;
};

// the plan of entry E as its kernel sees it: the tile, the halos and the
// layout of the shared memory are fixed by the entry (lm_plan_ok holds
// the plan to them), so they are constants
template <int E>
__device__ __forceinline__ LmPlan geometry(const LmPlan& plan) {
  LmPlan t = plan;
  t.tx = LmTile<E>::tx;
  t.ty = LmTile<E>::ty;
  t.lo = HALO_LO;
  t.hi = halo_hi(E);
  t.in = 0;
  t.fp = n_in(E) * (t.tx + t.lo + t.hi) * (t.ty + t.lo + t.hi);
  t.fc = t.fp + n_first(E) * (t.tx + 2 * RING) * (t.ty + 2 * RING);
  return t;
}

// the boxes of the block whose tile starts at (I0, J0): the inputs, the
// first pass (the tile and its ring) and the faces (the tile and one more
// row and column: the x faces of row I0 + tx, the y faces of column J0 +
// ty)
__device__ __forceinline__ Box in_box(const LmPlan& t, int I0, int J0) {
  return Box{I0 - t.lo, J0 - t.lo, t.tx + t.lo + t.hi, t.ty + t.lo + t.hi};
}
__device__ __forceinline__ Box ring_box(const LmPlan& t, int I0, int J0) {
  return Box{I0 - RING, J0 - RING, t.tx + 2 * RING, t.ty + 2 * RING};
}
__device__ __forceinline__ Box face_box(const LmPlan& t, int I0, int J0) {
  return Box{I0, J0, t.tx + 1, t.ty + 1};
}

// the tile at (I0, J0) lies in the interior, so that its ring and faces,
// and the corrections they read, lie inside every window
__device__ __forceinline__ bool inner(const Params& p, const LmPlan& t, int I0,
                                      int J0) {
  return I0 >= p.ng && I0 + t.tx <= p.ng + p.nx && J0 >= p.ng &&
         J0 + t.ty <= p.ng + p.ny;
}

// the device pointers of an entry's input planes, each a contiguous
// (qx, qy) frame
template <typename T>
struct Inputs {
  const T* a[11];
};

// f(c, i, j) for the cells c = threadIdx.x, + blockDim.x, ... of box b,
// (i, j) their frame indices, found without a division a cell
template <typename F>
__device__ __forceinline__ void each_cell(const Box& b, F f) {
  const int nt = blockDim.x, di = nt / b.w, dj = nt - di * b.w;
  int c = threadIdx.x, i = c / b.w, j = c - i * b.w;
  for (; c < b.cells(); c += nt) {
    f(c, b.i0 + i, b.j0 + j);
    i += di;
    j += dj;
    if (j >= b.w) {
      j -= b.w;
      ++i;
    }
  }
}

// an asynchronous copy of one value from device memory into shared memory
// (cp.async), or a zero where `valid` is false; copy_wait() waits for the
// thread's copies
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
#else
  *dst = valid ? *src : T(0);
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
#endif
}

// phase 1: N planes over box b into dst (plane n at n * b.cells()), zero
// beyond the frame, every copy in flight at once
template <typename T, int N>
__device__ __forceinline__ void load(const Params& p, const Inputs<T>& g,
                                     T* dst, const Box& b) {
  const int cells = b.cells();
  each_cell(b, [&](int c, int i, int j) {
    const bool in = i >= 0 && i < p.qx && j >= 0 && j < p.qy;
    const size_t o = in ? (size_t)i * p.qy + j : 0;
#pragma unroll
    for (int n = 0; n < N; ++n) copy_async(dst + n * cells + c, g.a[n] + o, in);
  });
  copy_wait();
}

// -- the velocity stages -----------------------------------------------------

// the input planes of the velocity stages in shared memory
template <typename T>
struct Vel {
  BoxPlane<T> u, v, lux, lvx, luy, lvy, gpx, gpy, src;
};

template <typename T>
__device__ __forceinline__ Vel<T> vel(const T* s, const Box& b) {
  return Vel<T>{plane(s, b, 0), plane(s, b, 1), plane(s, b, 2),
                plane(s, b, 3), plane(s, b, 4), plane(s, b, 5),
                plane(s, b, 6), plane(s, b, 7), plane(s, b, 8)};
}

// the hat states at frame cell (i, j): zero where the predicting cell lies
// outside the buf=2 window
template <typename T>
struct Hats {
  T u_xl, u_xr, v_xl, v_xr, u_yl, u_yr, v_yl, v_yr;
};

template <bool W, typename T>
__device__ __forceinline__ Hats<T> hats(const Params& p, const Consts<T>& k,
                                        const Vel<T>& a, int i, int j) {
  Hats<T> h;
  h.u_xl = h.v_xl = h.u_xr = h.v_xr = T(0);
  h.u_yl = h.v_yl = h.u_yr = h.v_yr = T(0);
  if (w2<W>(p, i - 1, j)) {
    const T u = a.u(i - 1, j);
    h.u_xl = hat_l(u, u, a.lux(i - 1, j), k.dtdx);
    h.v_xl = hat_l(a.v(i - 1, j), u, a.lvx(i - 1, j), k.dtdx);
  }
  if (w2<W>(p, i, j - 1)) {
    const T v = a.v(i, j - 1);
    h.u_yl = hat_l(a.u(i, j - 1), v, a.luy(i, j - 1), k.dtdy);
    h.v_yl = hat_l(v, v, a.lvy(i, j - 1), k.dtdy);
  }
  if (w2<W>(p, i, j)) {
    const T u = a.u(i, j), v = a.v(i, j);
    h.u_xr = hat_r(u, u, a.lux(i, j), k.dtdx);
    h.v_xr = hat_r(v, u, a.lvx(i, j), k.dtdx);
    h.u_yr = hat_r(u, v, a.luy(i, j), k.dtdy);
    h.v_yr = hat_r(v, v, a.lvy(i, j), k.dtdy);
  }
  return h;
}

// the first-pass planes: hat states -> Riemann -> upwind
enum { UHAT = 0, VHAT = 1, UXI = 2, VXI = 3, UYI = 4, VYI = 5 };

template <typename T>
struct First {
  BoxPlane<T> uhat, vhat, uxi, vxi, uyi, vyi;
};

template <typename T>
__device__ __forceinline__ First<T> first(const T* s, const Box& b) {
  return First<T>{plane(s, b, UHAT), plane(s, b, VHAT), plane(s, b, UXI),
                  plane(s, b, VXI),  plane(s, b, UYI),  plane(s, b, VYI)};
}

// phase 2 of the velocity stages over the ring box r
template <bool W, typename T>
__device__ __forceinline__ void first_pass(const Params& p,
                                           const Consts<T>& k,
                                           const Vel<T>& a, T* dst,
                                           const Box& r) {
  const int cells = r.cells();
  each_cell(r, [&](int c, int i, int j) {
    T uhat = T(0), vhat = T(0), uxi = T(0), vxi = T(0), uyi = T(0),
      vyi = T(0);
    if (w12<W>(p, i, j)) {
      const Hats<T> h = hats<W>(p, k, a, i, j);
      uhat = riemann(h.u_xl, h.u_xr);
      vhat = riemann(h.v_yl, h.v_yr);
      uxi = upwind(h.u_xl, h.u_xr, uhat);
      vxi = upwind(h.v_xl, h.v_xr, uhat);
      uyi = upwind(h.u_yl, h.u_yr, vhat);
      vyi = upwind(h.v_yl, h.v_yr, vhat);
    }
    dst[UHAT * cells + c] = uhat;
    dst[VHAT * cells + c] = vhat;
    dst[UXI * cells + c] = uxi;
    dst[VXI * cells + c] = vxi;
    dst[UYI * cells + c] = uyi;
    dst[VYI * cells + c] = vyi;
  });
}

// the four corrections of buf=1 window cell (i, j) (zero outside it), from
// the first-pass planes; names as in LM_atm_interface.get_interface_states
template <bool W, typename T>
__device__ __forceinline__ T du_x(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1<W>(p, i, j)) return T(0);
  const T vbar = T(0.5) * (s.vhat(i, j) + s.vhat(i, j + 1));
  const T vu_y = vbar * (s.uyi(i, j + 1) - s.uyi(i, j));
  return k.cy * vu_y - k.half_dt * a.gpx(i, j);
}

template <bool W, typename T>
__device__ __forceinline__ T dv_x(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1<W>(p, i, j)) return T(0);
  const T vbar = T(0.5) * (s.vhat(i, j) + s.vhat(i, j + 1));
  const T vv_y = vbar * (s.vyi(i, j + 1) - s.vyi(i, j));
  return k.cy * vv_y - k.half_dt * a.gpy(i, j) + k.half_dt * a.src(i, j);
}

template <bool W, typename T>
__device__ __forceinline__ T dv_y(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1<W>(p, i, j)) return T(0);
  const T ubar = T(0.5) * (s.uhat(i, j) + s.uhat(i + 1, j));
  const T uv_x = ubar * (s.vxi(i + 1, j) - s.vxi(i, j));
  return k.cx * uv_x - k.half_dt * a.gpy(i, j) + k.half_dt * a.src(i, j);
}

template <bool W, typename T>
__device__ __forceinline__ T du_y(const Params& p, const Consts<T>& k,
                                  const Vel<T>& a, const First<T>& s, int i,
                                  int j) {
  if (!w1<W>(p, i, j)) return T(0);
  const T ubar = T(0.5) * (s.uhat(i, j) + s.uhat(i + 1, j));
  const T uu_x = ubar * (s.uxi(i + 1, j) - s.uxi(i, j));
  return k.cx * uu_x - k.half_dt * a.gpx(i, j);
}

// -- k_lm_mac: corrected u on x faces, v on y faces, Riemann and upwind ----

// phases 2 and 3 of the tile at (I0, J0), its inputs loaded into box bi
template <bool W, typename T>
__device__ __forceinline__ void mac_tile(const Params& p, const LmPlan& t,
                                         T* sm, const Box& bi, int I0,
                                         int J0, T* __restrict__ u_mac,
                                         T* __restrict__ v_mac) {
  const Box br = ring_box(t, I0, J0);
  const Consts<T> k(p);
  const Vel<T> a = vel(sm + t.in, bi);
  first_pass<W>(p, k, a, sm + t.fp, br);
  __syncthreads();
  const First<T> s = first(sm + t.fp, br);
  each_cell(Box{I0, J0, t.tx, t.ty}, [&](int, int i, int j) {
    if (i >= p.qx || j >= p.qy) return;
    T um = T(0), vm = T(0);
    if (w12<W>(p, i, j)) {
      const Hats<T> h = hats<W>(p, k, a, i, j);
      const T uxl = h.u_xl + du_x<W>(p, k, a, s, i - 1, j);
      const T uxr = h.u_xr + du_x<W>(p, k, a, s, i, j);
      const T vyl = h.v_yl + dv_y<W>(p, k, a, s, i, j - 1);
      const T vyr = h.v_yr + dv_y<W>(p, k, a, s, i, j);
      um = upwind(uxl, uxr, riemann(uxl, uxr));
      vm = upwind(vyl, vyr, riemann(vyl, vyr));
    }
    const size_t o = (size_t)i * p.qy + j;
    u_mac[o] = um;
    v_mac[o] = vm;
  });
}

template <typename T>
__global__ void __launch_bounds__(LmLaunch<T, MAC>::threads,
                                  LmLaunch<T, MAC>::blocks)
    k_lm_mac(const Params p, const Inputs<T> g, T* __restrict__ u_mac,
             T* __restrict__ v_mac, const LmPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LmPlan t = geometry<MAC>(plan);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int I0 = blockIdx.y * t.tx, J0 = blockIdx.x * t.ty;
  const Box bi = in_box(t, I0, J0);
  load<T, n_in(MAC)>(p, g, sm + t.in, bi);
  __syncthreads();
  if (inner(p, t, I0, J0))
    mac_tile<false>(p, t, sm, bi, I0, J0, u_mac, v_mac);
  else
    mac_tile<true>(p, t, sm, bi, I0, J0, u_mac, v_mac);
}

// -- k_lm_states: the advective terms of the provisional update ------------

// the face planes of the states: u and v on x face (a, b) (upwind by
// u_MAC) and on y face (a, b) (upwind by v_MAC)
enum { XU = 0, XV = 1, YU = 2, YV = 3 };

template <bool W, typename T>
__device__ __forceinline__ void states_tile(const Params& p, const LmPlan& t,
                                            T* sm, const Box& bi, int I0,
                                            int J0, T* __restrict__ adv_x,
                                            T* __restrict__ adv_y) {
  const Box br = ring_box(t, I0, J0), bf = face_box(t, I0, J0);
  const Consts<T> k(p);
  const Vel<T> a = vel(sm + t.in, bi);
  const BoxPlane<T> u_mac = plane(sm + t.in, bi, 9),
                    v_mac = plane(sm + t.in, bi, 10);
  first_pass<W>(p, k, a, sm + t.fp, br);
  __syncthreads();
  const First<T> s = first(sm + t.fp, br);
  // 3a. the final states of the tile's x faces (rows I0 .. I0 + tx) and y
  // faces (columns J0 .. J0 + ty), the hat states of a cell formed once
  T* F = sm + t.fc;
  const int fcells = bf.cells();
  each_cell(bf, [&](int c, int i, int j) {
    const Hats<T> h = hats<W>(p, k, a, i, j);
    if (j < J0 + t.ty) {
      const T ul = h.u_xl + du_x<W>(p, k, a, s, i - 1, j);
      const T ur = h.u_xr + du_x<W>(p, k, a, s, i, j);
      const T vl = h.v_xl + dv_x<W>(p, k, a, s, i - 1, j);
      const T vr = h.v_xr + dv_x<W>(p, k, a, s, i, j);
      const T w = w12<W>(p, i, j) ? u_mac(i, j) : T(0);
      F[XU * fcells + c] = w12<W>(p, i, j) ? upwind(ul, ur, w) : T(0);
      F[XV * fcells + c] = w12<W>(p, i, j) ? upwind(vl, vr, w) : T(0);
    }
    if (i < I0 + t.tx) {
      const T ul = h.u_yl + du_y<W>(p, k, a, s, i, j - 1);
      const T ur = h.u_yr + du_y<W>(p, k, a, s, i, j);
      const T vl = h.v_yl + dv_y<W>(p, k, a, s, i, j - 1);
      const T vr = h.v_yr + dv_y<W>(p, k, a, s, i, j);
      const T w = w12<W>(p, i, j) ? v_mac(i, j) : T(0);
      F[YU * fcells + c] = w12<W>(p, i, j) ? upwind(ul, ur, w) : T(0);
      F[YV * fcells + c] = w12<W>(p, i, j) ? upwind(vl, vr, w) : T(0);
    }
  });
  __syncthreads();
  // 3b. the centred differences of the tile's interior cells
  const BoxPlane<T> xu = plane<T>(F, bf, XU), xv = plane<T>(F, bf, XV),
                    yu = plane<T>(F, bf, YU), yv = plane<T>(F, bf, YV);
  each_cell(Box{I0, J0, t.tx, t.ty}, [&](int, int i, int j) {
    if (!interior<W>(p, i, j)) return;
    const T ubar = T(0.5) * (u_mac(i, j) + u_mac(i + 1, j));
    const T vbar = T(0.5) * (v_mac(i, j) + v_mac(i, j + 1));
    const size_t o = (size_t)(i - p.ng) * p.ny + (j - p.ng);
    adv_x[o] = ubar * (xu(i + 1, j) - xu(i, j)) * k.inv_dx +
               vbar * (yu(i, j + 1) - yu(i, j)) * k.inv_dy;
    adv_y[o] = ubar * (xv(i + 1, j) - xv(i, j)) * k.inv_dx +
               vbar * (yv(i, j + 1) - yv(i, j)) * k.inv_dy;
  });
}

template <typename T>
__global__ void __launch_bounds__(LmLaunch<T, STATES>::threads,
                                  LmLaunch<T, STATES>::blocks)
    k_lm_states(const Params p, const Inputs<T> g, T* __restrict__ adv_x,
                T* __restrict__ adv_y, const LmPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LmPlan t = geometry<STATES>(plan);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int I0 = p.ng + blockIdx.y * t.tx, J0 = p.ng + blockIdx.x * t.ty;
  const Box bi = in_box(t, I0, J0);
  load<T, n_in(STATES)>(p, g, sm + t.in, bi);
  __syncthreads();
  if (inner(p, t, I0, J0))
    states_tile<false>(p, t, sm, bi, I0, J0, adv_x, adv_y);
  else
    states_tile<true>(p, t, sm, bi, I0, J0, adv_x, adv_y);
}

// -- the density stage -------------------------------------------------------

template <typename T>
struct Rho {
  BoxPlane<T> rho, um, vm, lrx, lry;
};

// rho's hat states at frame cell (i, j), predicted with the MAC velocity of
// the face they sit on
template <bool W, typename T>
__device__ __forceinline__ void rho_hats(const Params& p, const Consts<T>& k,
                                         const Rho<T>& a, int i, int j, T& xl,
                                         T& xr, T& yl, T& yr) {
  xl = xr = yl = yr = T(0);
  if (w2<W>(p, i - 1, j))
    xl = hat_l(a.rho(i - 1, j), a.um(i, j), a.lrx(i - 1, j), k.dtdx);
  if (w2<W>(p, i, j - 1))
    yl = hat_l(a.rho(i, j - 1), a.vm(i, j), a.lry(i, j - 1), k.dtdy);
  if (w2<W>(p, i, j)) {
    xr = hat_r(a.rho(i, j), a.um(i, j), a.lrx(i, j), k.dtdx);
    yr = hat_r(a.rho(i, j), a.vm(i, j), a.lry(i, j), k.dtdy);
  }
}

// the buf=2 corrections of cell (i, j) (zero outside the window), from the
// first-pass planes rxi, ryi
template <bool W, typename T>
__device__ __forceinline__ T dx_corr(const Params& p, const Consts<T>& k,
                                     const Rho<T>& a, const BoxPlane<T>& ryi,
                                     int i, int j) {
  if (!w2<W>(p, i, j)) return T(0);
  const T u_x = (a.um(i + 1, j) - a.um(i, j)) * k.inv_dx;
  const T rhov_y =
      (ryi(i, j + 1) * a.vm(i, j + 1) - ryi(i, j) * a.vm(i, j)) * k.inv_dy;
  return k.mhalf_dt * (rhov_y + a.rho(i, j) * u_x);
}

template <bool W, typename T>
__device__ __forceinline__ T dy_corr(const Params& p, const Consts<T>& k,
                                     const Rho<T>& a, const BoxPlane<T>& rxi,
                                     int i, int j) {
  if (!w2<W>(p, i, j)) return T(0);
  const T v_y = (a.vm(i, j + 1) - a.vm(i, j)) * k.inv_dy;
  const T rhou_x =
      (rxi(i + 1, j) * a.um(i + 1, j) - rxi(i, j) * a.um(i, j)) * k.inv_dx;
  return k.mhalf_dt * (rhou_x + a.rho(i, j) * v_y);
}

enum { RXI = 0, RYI = 1 };   // rho's first-pass planes
enum { RX = 0, RY = 1 };     // its face planes

template <bool W, typename T>
__device__ __forceinline__ void rho_tile(const Params& p, const LmPlan& t,
                                         T* sm, const Box& bi, int I0,
                                         int J0, T* __restrict__ inc) {
  const Box br = ring_box(t, I0, J0), bf = face_box(t, I0, J0);
  const Consts<T> k(p);
  const Rho<T> a{plane(sm + t.in, bi, 0), plane(sm + t.in, bi, 1),
                 plane(sm + t.in, bi, 2), plane(sm + t.in, bi, 3),
                 plane(sm + t.in, bi, 4)};
  // 2. rho's hat states upwinded by the MAC velocities
  T* R = sm + t.fp;
  const int rcells = br.cells();
  each_cell(br, [&](int c, int i, int j) {
    T x = T(0), y = T(0);
    if (w12<W>(p, i, j)) {
      T xl, xr, yl, yr;
      rho_hats<W>(p, k, a, i, j, xl, xr, yl, yr);
      x = upwind(xl, xr, a.um(i, j));
      y = upwind(yl, yr, a.vm(i, j));
    }
    R[RXI * rcells + c] = x;
    R[RYI * rcells + c] = y;
  });
  __syncthreads();
  const BoxPlane<T> rxi = plane<T>(R, br, RXI), ryi = plane<T>(R, br, RYI);
  // 3a. the final rho states on the tile's x faces (rows I0 .. I0 + tx)
  // and y faces (columns J0 .. J0 + ty)
  T* F = sm + t.fc;
  const int fcells = bf.cells();
  each_cell(bf, [&](int c, int i, int j) {
    T xl, xr, yl, yr;
    rho_hats<W>(p, k, a, i, j, xl, xr, yl, yr);
    if (j < J0 + t.ty) {
      xl = xl + dx_corr<W>(p, k, a, ryi, i - 1, j);
      xr = xr + dx_corr<W>(p, k, a, ryi, i, j);
      F[RX * fcells + c] = w12<W>(p, i, j) ? upwind(xl, xr, a.um(i, j)) : T(0);
    }
    if (i < I0 + t.tx) {
      yl = yl + dy_corr<W>(p, k, a, rxi, i, j - 1);
      yr = yr + dy_corr<W>(p, k, a, rxi, i, j);
      F[RY * fcells + c] = w12<W>(p, i, j) ? upwind(yl, yr, a.vm(i, j)) : T(0);
    }
  });
  __syncthreads();
  // 3b. the increment of the tile's interior cells
  const BoxPlane<T> rx = plane<T>(F, bf, RX), ry = plane<T>(F, bf, RY);
  each_cell(Box{I0, J0, t.tx, t.ty}, [&](int, int i, int j) {
    if (!interior<W>(p, i, j)) return;
    const size_t o = (size_t)(i - p.ng) * p.ny + (j - p.ng);
    inc[o] = k.mdt * ((rx(i + 1, j) * a.um(i + 1, j) - rx(i, j) * a.um(i, j)) *
                          k.inv_dx +
                      (ry(i, j + 1) * a.vm(i, j + 1) - ry(i, j) * a.vm(i, j)) *
                          k.inv_dy);
  });
}

template <typename T>
__global__ void __launch_bounds__(LmLaunch<T, RHO>::threads,
                                  LmLaunch<T, RHO>::blocks)
    k_lm_rho(const Params p, const Inputs<T> g, T* __restrict__ inc,
             const LmPlan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LmPlan t = geometry<RHO>(plan);
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int I0 = p.ng + blockIdx.y * t.tx, J0 = p.ng + blockIdx.x * t.ty;
  const Box bi = in_box(t, I0, J0);
  load<T, n_in(RHO)>(p, g, sm + t.in, bi);
  __syncthreads();
  if (inner(p, t, I0, J0))
    rho_tile<false>(p, t, sm, bi, I0, J0, inc);
  else
    rho_tile<true>(p, t, sm, bi, I0, J0, inc);
}

// -- launches ----------------------------------------------------------------

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

LmPlan load_plan(const int* t) {
  return LmPlan{t[0], t[1], t[2], t[3], t[4], t[5],
                t[6], t[7], t[8], t[9], t[10]};
}

// the plan takes entry e of this frame: the boxes around the (lo-1, hi+2)
// window inside the frame's ghosts, the entry's block, tile and halos, a
// grid whose tiles cover the outputs once (mac: the frame; rho, states:
// the interior), and the planes laid out as geometry() lays them, inside
// the shared memory
template <typename T, int e>
bool lm_plan_ok(const Params& p, const LmPlan& t) {
  if (p.nx < 1 || p.ny < 1 || p.ng < 1 + HALO_LO ||
      t.threads != LmLaunch<T, e>::threads || t.tx != LmTile<e>::tx ||
      t.ty != LmTile<e>::ty || t.lo != HALO_LO || t.hi != halo_hi(e))
    return false;
  const int rows = e == MAC ? p.qx : p.nx, cols = e == MAC ? p.qy : p.ny;
  if (t.gx < 1 || t.gy < 1 || (t.gx - 1) * t.ty >= cols ||
      t.gx * t.ty < cols || (t.gy - 1) * t.tx >= rows || t.gy * t.tx < rows)
    return false;
  const long nin = (long)n_in(e) * (t.tx + t.lo + t.hi) * (t.ty + t.lo + t.hi);
  const long nfp = (long)n_first(e) * (t.tx + 2 * RING) * (t.ty + 2 * RING);
  const long nfc = (long)n_faces(e) * (t.tx + 1) * (t.ty + 1);
  return t.in == 0 && t.fp == nin && t.fc == nin + nfp &&
         (long)t.smem >= (nin + nfp + nfc) * (long)sizeof(T);
}

template <typename T>
Inputs<T> inputs(const T* const* in, int n) {
  Inputs<T> g{};
  for (int k = 0; k < n; ++k) g.a[k] = in[k];
  return g;
}

// launch entry E's kernel with the plan's grid, block and dynamic shared
// memory (the opt-in above 48 KB is set once per kernel and size), after
// checking the plan against the frame
template <typename T, int E, typename K, typename... A>
int launch(const Params& p, const int* plan, K kernel, cudaStream_t st,
           A... args) {
  const LmPlan t = load_plan(plan);
  if (!lm_plan_ok<T, E>(p, t)) return (int)cudaErrorInvalidValue;
  static int opted = 0;
  if (t.smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        t.smem);
    if (e != cudaSuccess) return (int)e;
    opted = t.smem;
  }
  kernel<<<dim3(t.gx, t.gy), t.threads, t.smem, st>>>(p, args..., t);
  return (int)cudaGetLastError();
}

// in: u, v, lux, lvx, luy, lvy, gpx, gpy, src
template <typename T>
int mac(const T* const* in, T* u_mac, T* v_mac, const int* ints,
        const double* dbl, const int* plan, cudaStream_t st) {
  return launch<T, MAC>(make_params(ints, dbl), plan, k_lm_mac<T>, st,
                        inputs(in, n_in(MAC)), u_mac, v_mac);
}

// in: the 9 velocity-stage planes, then u_MAC, v_MAC
template <typename T>
int states(const T* const* in, T* adv_x, T* adv_y, const int* ints,
           const double* dbl, const int* plan, cudaStream_t st) {
  return launch<T, STATES>(make_params(ints, dbl), plan, k_lm_states<T>, st,
                           inputs(in, n_in(STATES)), adv_x, adv_y);
}

// in: rho, u_MAC, v_MAC, lrx, lry
template <typename T>
int rho(const T* const* in, T* inc, const int* ints, const double* dbl,
        const int* plan, cudaStream_t st) {
  return launch<T, RHO>(make_params(ints, dbl), plan, k_lm_rho<T>, st,
                        inputs(in, n_in(RHO)), inc);
}

}  // namespace

// ints: nx, ny, ng; doubles: dt, dx, dy; plan: lm_kernel.plan's ints.  `in`
// is a host array of device plane pointers, each a contiguous (nx + 2 ng,
// ny + 2 ng) frame.
#define ENTRIES(T, SFX)                                                      \
  extern "C" int lm_mac_##SFX(const T* const* in, T* u_mac, T* v_mac,        \
                              const int* ints, const double* dbl,            \
                              const int* plan, void* stream) {               \
    return mac<T>(in, u_mac, v_mac, ints, dbl, plan, (cudaStream_t)stream);  \
  }                                                                          \
  extern "C" int lm_states_##SFX(const T* const* in, T* adv_x, T* adv_y,     \
                                 const int* ints, const double* dbl,         \
                                 const int* plan, void* stream) {            \
    return states<T>(in, adv_x, adv_y, ints, dbl, plan,                      \
                     (cudaStream_t)stream);                                  \
  }                                                                          \
  extern "C" int lm_rho_##SFX(const T* const* in, T* inc, const int* ints,   \
                              const double* dbl, const int* plan,            \
                              void* stream) {                                \
    return rho<T>(in, inc, ints, dbl, plan, (cudaStream_t)stream);           \
  }

// the length of the plan array the entries take (lm_kernel.plan)
extern "C" int lm_plan_ints() { return LM_PLAN_INTS; }

ENTRIES(float, f32)
ENTRIES(double, f64)
