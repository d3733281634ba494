// mg_deep.cu -- the sharded multigrid's kernels on Hopper
// (pyro2_tpu_torch/multigrid/sharded_mg_kernel.py), replacing
// pyro2_tpu/multigrid/pallas_sharded_mg.py:
//
//   mg_deep_smooth  <- build_deep_smooth_kernel: one smoothing round on a
//                      block's deep frame, (bx + 2 dpx) x (by + 2 dpy) cells
//                      around the owned bx x by block: the entry refresh of
//                      the physical ghosts, n_sweeps steps of the smoother,
//                      each step masked by the excess-distance eligibility and
//                      followed by the physical-ghost refresh, then by `emit`
//                      the frame alone (EMIT_V), the frame and the factor-2
//                      restricted interior residual on the one-ghost coarse
//                      frame, ghosts zero (EMIT_V_FC), or the frame and the
//                      residual on the frame, zero outside the interior
//                      (EMIT_V_R);
//   mg_correct      <- build_correct_kernel: v + prolong(vc) on the interior
//                      of a one-ghost block, the ghosts copied.
//
// The operators, the restriction and the prolongation are mg_ops.cuh's, as
// mg_vcycle.cu uses them: the TPU built the transfers as iota matmuls on the
// MXU, whose matrices have one non-zero term per output, so here they are the
// average of four and the centred slopes, with no matrix unit and no TF32.
//
// The frame.  Rows dpx .. dpx+bx-1 and columns dpy .. dpy+by-1 are the owned
// block; the rest is the halo, d cells deep toward a seam (a side with a
// neighbouring block) and one cell deep elsewhere.  A cell's excess on a side
// is how far it lies beyond the owned block there.  A step whose reads must
// be valid to depth lim+1 may update a cell only if its excess is <= lim on
// each seam side and 0 on each other side: red-black sweep s updates red at
// lim = d - (2s+1) and black at lim - 1, Jacobi and Chebyshev step s at
// d - (s+1).  The ghosts of the other sides are refreshed after every step.
//
// The refresh.  Each edge of the plan (`plan`: 0 none, 1 when the block owns
// that domain edge (flags 4..7), 2 always, an unsplit periodic axis) sets
// its ghost row or column to +-1 times one source row or column, x-lo, x-hi,
// y-lo, y-hi in that order over full rows, so a corner is the y rule applied
// to the x-filled row.  The entry refresh is a pass of its own (the input's
// ghosts are whatever the exchange left); after it, as in mg_vcycle.cu, the
// thread that writes a source cell also writes the ghosts that mirror it
// (`put`), which is race-free for the same reason: a ghost is read only by
// its own source cell or, across a periodic wrap, by a cell of the other
// colour.
//
// The smoothers.  Red-black Gauss-Seidel updates in place (a colour reads
// only the other colour).  Damped Jacobi (omega 0.8) and Chebyshev read only
// the old iterate, so they step between two buffers, the output and `w`; the
// wrapper picks the one to start in so that the last step lands in the
// output.  Chebyshev carries its step in `dk`.  theta, delta, sigma, rho are
// computed in the working type in the JAX package's order.
//
// One cooperative launch per round: grid-stride loops over the frame,
// cooperative_groups grid.sync() between phases (two for the entry refresh,
// one per half-sweep or step).  A 1024^2 float32 frame is 4.3 MB, far above
// the 227 KB of shared memory a block may use, so the frame stays in device
// memory and L2 (the TPU held it in VMEM).  What bounds it on the H100:
// 7-17 operations per cell update against 2 values and 2-5 coefficient
// planes, so the bytes of the frames over the memory rate
// (sharded_mg_kernel.work); this first design pays a grid barrier per
// half-sweep instead and reads neighbours from L2.  Tiles of several sweeps
// in shared memory are the next step.
//
// Each entry point returns the launch's cudaError_t (0 on success).
//
// Build (see sharded_mg_kernel.py and util/cuda_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libmg_deep.so mg_deep.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mg_ops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

// ghost-fill kind of an edge (as mg_vcycle.cu)
enum { COPY = 0, NEGATE = 1, PERIODIC = 2 };

// the smoother and what the round writes besides the frame
enum { RBGS = 0, JACOBI = 1, CHEBYSHEV = 2 };
enum { EMIT_V = 0, EMIT_V_FC = 1, EMIT_V_R = 2 };

// a block's deep frame: its geometry, operator and refresh
template <typename T>
struct Frame {
  int bx, by, dpx, dpy, Fx, Fy;
  int q;                 // row stride: Fy
  size_t qq;             // plane stride: Fx * Fy
  T xc, yc, den, dx2, dy2;
  const T* c;            // OP_VC / OP_GENERAL planes on the frame
  int lim0[4];           // 1 on a seam side (x-lo, x-hi, y-lo, y-hi), else 0
  bool on[4];            // the edge is refreshed
  int ghost[4], src[4];  // its ghost row / column and the one it mirrors
  T sgn[4];
};

// the excess-distance test: may cell (i, j) take an update at depth lim?
template <typename T>
__device__ __forceinline__ bool elig(const Frame<T>& F, int i, int j,
                                     int lim) {
  const int exl = max(F.dpx - i, 0), exr = max(i - (F.dpx + F.bx - 1), 0);
  const int eyl = max(F.dpy - j, 0), eyr = max(j - (F.dpy + F.by - 1), 0);
  return exl <= (F.lim0[0] ? lim : 0) && exr <= (F.lim0[1] ? lim : 0) &&
         eyl <= (F.lim0[2] ? lim : 0) && eyr <= (F.lim0[3] ? lim : 0);
}

template <typename T>
__device__ __forceinline__ bool is_ghost(const Frame<T>& F, int i, int j) {
  return (F.on[0] && i == F.ghost[0]) || (F.on[1] && i == F.ghost[1]) ||
         (F.on[2] && j == F.ghost[2]) || (F.on[3] && j == F.ghost[3]);
}

// write cell (i, j) and every refreshed ghost that mirrors it
template <typename T>
__device__ __forceinline__ void put(T* v, const Frame<T>& F, int i, int j,
                                    T val) {
  const int q = F.q;
  v[i * q + j] = val;
  const bool xl = F.on[0] && i == F.src[0], xh = F.on[1] && i == F.src[1];
  const bool yl = F.on[2] && j == F.src[2], yh = F.on[3] && j == F.src[3];
  const T vxl = F.sgn[0] * val, vxh = F.sgn[1] * val;
  if (xl) v[F.ghost[0] * q + j] = vxl;
  if (xh) v[F.ghost[1] * q + j] = vxh;
  if (yl) v[i * q + F.ghost[2]] = F.sgn[2] * val;
  if (yh) v[i * q + F.ghost[3]] = F.sgn[3] * val;
  if (xl && yl) v[F.ghost[0] * q + F.ghost[2]] = F.sgn[2] * vxl;
  if (xl && yh) v[F.ghost[0] * q + F.ghost[3]] = F.sgn[3] * vxl;
  if (xh && yl) v[F.ghost[1] * q + F.ghost[2]] = F.sgn[2] * vxh;
  if (xh && yh) v[F.ghost[1] * q + F.ghost[3]] = F.sgn[3] * vxh;
}

template <typename T>
struct DeepArgs {
  const T* vd;   // the exchanged frame (its physical ghosts are refreshed)
  const T* fd;   // the right-hand side on the frame
  T* vo;         // the smoothed frame
  T* ex;         // EMIT_V_FC: the coarse frame; EMIT_V_R: the residual frame
  T* w;          // JACOBI / CHEBYSHEV: the second iterate
  T* dk;         // CHEBYSHEV: its step
  Frame<T> F;
  T alpha, beta;
  int d, nsweeps;
};

template <int OP, int SM, int EMIT, typename T>
__global__ void __launch_bounds__(THREADS) k_deep(DeepArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const Frame<T>& F = a.F;
  const int Fy = F.Fy, nf = F.Fx * F.Fy;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;

  // the buffer the iterate starts in: the last step must land in vo
  T* cur = (SM == RBGS || a.nsweeps % 2 == 0) ? a.vo : a.w;
  T* nxt = cur == a.vo ? a.w : a.vo;

  // entry refresh: the x ghost rows gathered from the input, then the y
  // ghost columns over full rows
  for (int k = t0; k < nf; k += nt) {
    const int i = k / Fy, j = k - (k / Fy) * Fy;
    T val = a.vd[k];
    if (F.on[0] && i == F.ghost[0]) val = F.sgn[0] * a.vd[F.src[0] * Fy + j];
    if (F.on[1] && i == F.ghost[1]) val = F.sgn[1] * a.vd[F.src[1] * Fy + j];
    cur[k] = val;
  }
  grid.sync();
  for (int k = t0; k < nf; k += nt) {
    const int i = k / Fy, j = k - (k / Fy) * Fy;
    if (F.on[2] && j == F.ghost[2]) cur[k] = F.sgn[2] * cur[i * Fy + F.src[2]];
    if (F.on[3] && j == F.ghost[3]) cur[k] = F.sgn[3] * cur[i * Fy + F.src[3]];
  }
  grid.sync();

  if constexpr (SM == RBGS) {
    // the cells of one colour: Fy is even, so every row holds Fy/2 of each
    const int h = Fy >> 1;
    for (int s = 0; s < a.nsweeps; ++s) {
      const int lim = a.d - (2 * s + 1);
      for (int color = 0; color < 2; ++color) {
        for (int k = t0; k < nf / 2; k += nt) {
          const int i = k / h;
          const int j = 2 * (k - i * h) + ((color + i + F.dpx + F.dpy) & 1);
          if (elig(F, i, j, lim - color))
            put(cur, F, i, j, gs<OP>(cur, a.fd, F, i * Fy + j));
        }
        grid.sync();
      }
    }
  } else {
    const T omega = T(0.8);
    const T theta = T(1.25), delta = T(0.75);
    const T sigma = theta / delta;
    T rho = T(1) / sigma;
    for (int s = 0; s < a.nsweeps; ++s) {
      const int lim = a.d - (s + 1);
      T c1 = T(0), c2 = T(0), rho_new = T(0);
      if (SM == CHEBYSHEV && s > 0) {
        rho_new = T(1) / (T(2) * sigma - rho);
        c1 = rho_new * rho;
        c2 = T(2) * rho_new / delta;
      }
      for (int k = t0; k < nf; k += nt) {
        const int i = k / Fy, j = k - (k / Fy) * Fy;
        if (is_ghost(F, i, j)) continue;    // written by its source's put
        const bool e = elig(F, i, j, lim);
        const T x = cur[k];
        T val = x;
        if constexpr (SM == JACOBI) {
          if (e) val = x + omega * (gs<OP>(cur, a.fd, F, k) - x);
        } else {
          const T z = e ? gs<OP>(cur, a.fd, F, k) - x : T(0);
          const T step = s == 0 ? z / theta : c1 * a.dk[k] + c2 * z;
          a.dk[k] = step;
          if (e) val = x + step;
        }
        put(nxt, F, i, j, val);
      }
      grid.sync();
      T* t = cur;
      cur = nxt;
      nxt = t;
      if (SM == CHEBYSHEV && s > 0) rho = rho_new;
    }
  }

  if constexpr (EMIT == EMIT_V_FC) {
    const int ncx = F.bx / 2, ncy = F.by / 2, qc = ncy + 2;
    for (int k = t0; k < (ncx + 2) * qc; k += nt) {
      const int I = k / qc, J = k - (k / qc) * qc;
      a.ex[k] = (I >= 1 && I <= ncx && J >= 1 && J <= ncy)
                    ? restrict4<OP>(cur, a.fd, F, a.alpha, a.beta,
                                    (F.dpx + 2 * I - 2) * Fy + F.dpy + 2 * J -
                                        2)
                    : T(0);
    }
  } else if constexpr (EMIT == EMIT_V_R) {
    for (int k = t0; k < nf; k += nt) {
      const int i = k / Fy, j = k - (k / Fy) * Fy;
      a.ex[k] = (i >= F.dpx && i < F.dpx + F.bx && j >= F.dpy &&
                 j < F.dpy + F.by)
                    ? resid<OP>(cur, a.fd, F, a.alpha, a.beta, k)
                    : T(0);
    }
  }
}

// v + prolong(vc) on the interior of the one-ghost (bx+2) x (by+2) block
template <typename T>
__global__ void __launch_bounds__(THREADS) k_correct(const T* v, const T* vc,
                                                     T* vo, int bx, int by) {
  const int q = by + 2, qc = by / 2 + 2, n = (bx + 2) * q;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const int i = k / q, j = k - (k / q) * q;
    vo[k] = (i >= 1 && i <= bx && j >= 1 && j <= by)
                ? v[k] + prolong(vc, qc, i, j)
                : v[k];
  }
}

// -- launches -------------------------------------------------------------------

// blocks of a cooperative launch over `items` cells: no more than can be
// co-resident on the card (queried once per kernel)
int coop_blocks(const void* kernel, int& cached, int items) {
  if (cached < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0) !=
            cudaSuccess)
      return 0;
    cached = per_sm * sms;
  }
  const int want = (items + THREADS - 1) / THREADS;
  return want < cached ? want : cached;
}

template <int OP, int SM, int EMIT, typename T>
int launch_deep(const DeepArgs<T>& a, cudaStream_t st) {
  static int cached = -1;
  auto kernel = k_deep<OP, SM, EMIT, T>;
  const int blocks =
      coop_blocks((const void*)kernel, cached, a.F.Fx * a.F.Fy);
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  DeepArgs<T> args = a;
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(blocks), dim3(THREADS), params, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int OP, int SM, typename T>
int by_emit(int emit, const DeepArgs<T>& a, cudaStream_t st) {
  switch (emit) {
    case EMIT_V: return launch_deep<OP, SM, EMIT_V>(a, st);
    case EMIT_V_FC: return launch_deep<OP, SM, EMIT_V_FC>(a, st);
    case EMIT_V_R: return launch_deep<OP, SM, EMIT_V_R>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int OP, typename T>
int by_smoother(int smoother, int emit, const DeepArgs<T>& a,
                cudaStream_t st) {
  switch (smoother) {
    case RBGS: return by_emit<OP, RBGS>(emit, a, st);
    case JACOBI: return by_emit<OP, JACOBI>(emit, a, st);
    case CHEBYSHEV: return by_emit<OP, CHEBYSHEV>(emit, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// geom: bx, by, dpx, dpy, d, n_sweeps; flags: seam x-lo, x-hi, y-lo, y-hi,
// own x-lo, ..., y-hi; plan, kinds: per edge; coef: xc, yc, den, dx2, dy2;
// ab: alpha, beta
template <typename T>
int deep_smooth(const T* vd, const T* fd, const void* planes, T* vo, T* ex,
                T* w, T* dk, const int* geom, int op, int smoother, int emit,
                const int* flags, const int* plan, const int* kinds,
                const double* coef, const double* ab, cudaStream_t st) {
  DeepArgs<T> a;
  Frame<T>& F = a.F;
  F.bx = geom[0];
  F.by = geom[1];
  F.dpx = geom[2];
  F.dpy = geom[3];
  a.d = geom[4];
  a.nsweeps = geom[5];
  F.Fx = F.bx + 2 * F.dpx;
  F.Fy = F.by + 2 * F.dpy;
  if (F.bx < 2 || F.by < 2 || F.bx % 2 || F.by % 2 || F.dpx < 1 ||
      F.dpy < 1 || a.nsweeps < 0 || (op != OP_CONST && !planes) ||
      (emit != EMIT_V && !ex) || (smoother != RBGS && !w) ||
      (smoother == CHEBYSHEV && !dk))
    return (int)cudaErrorInvalidValue;
  F.q = F.Fy;
  F.qq = (size_t)F.Fx * F.Fy;
  F.xc = (T)coef[0];
  F.yc = (T)coef[1];
  F.den = (T)coef[2];
  F.dx2 = (T)coef[3];
  F.dy2 = (T)coef[4];
  F.c = static_cast<const T*>(planes);
  const int dp[2] = {F.dpx, F.dpy}, b[2] = {F.bx, F.by};
  for (int e = 0; e < 4; ++e) {
    const int axis = e / 2, hi = e % 2;
    F.lim0[e] = flags[e] != 0;
    F.on[e] = plan[e] == 2 || (plan[e] == 1 && flags[4 + e] != 0);
    F.ghost[e] = hi ? dp[axis] + b[axis] : dp[axis] - 1;
    if (kinds[e] == PERIODIC)      // an unsplit axis: dp = 1
      F.src[e] = hi ? 1 : b[axis];
    else
      F.src[e] = hi ? dp[axis] + b[axis] - 1 : dp[axis];
    F.sgn[e] = kinds[e] == NEGATE ? T(-1) : T(1);
  }
  a.vd = vd;
  a.fd = fd;
  a.vo = vo;
  a.ex = ex;
  a.w = w;
  a.dk = dk;
  a.alpha = (T)ab[0];
  a.beta = (T)ab[1];
  switch (op) {
    case OP_CONST: return by_smoother<OP_CONST>(smoother, emit, a, st);
    case OP_VC: return by_smoother<OP_VC>(smoother, emit, a, st);
    case OP_GENERAL: return by_smoother<OP_GENERAL>(smoother, emit, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int correct(const T* v, const T* vc, T* vo, int bx, int by, cudaStream_t st) {
  if (bx < 2 || by < 2 || bx % 2 || by % 2) return (int)cudaErrorInvalidValue;
  const int n = (bx + 2) * (by + 2);
  int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  k_correct<T><<<blocks, THREADS, 0, st>>>(v, vc, vo, bx, by);
  return (int)cudaGetLastError();
}

}  // namespace

#define ENTRIES(T, SFX)                                                       \
  extern "C" int mg_deep_smooth_##SFX(                                        \
      const T* vd, const T* fd, const void* planes, T* vo, T* ex, T* w,       \
      T* dk, const int* geom, int op, int smoother, int emit,                 \
      const int* flags, const int* plan, const int* kinds,                    \
      const double* coef, const double* ab, void* stream) {                   \
    return deep_smooth<T>(vd, fd, planes, vo, ex, w, dk, geom, op, smoother,  \
                          emit, flags, plan, kinds, coef, ab,                 \
                          (cudaStream_t)stream);                              \
  }                                                                           \
  extern "C" int mg_correct_##SFX(const T* v, const T* vc, T* vo, int bx,     \
                                  int by, void* stream) {                     \
    return correct<T>(v, vc, vo, bx, by, (cudaStream_t)stream);               \
  }

ENTRIES(float, f32)
ENTRIES(double, f64)
