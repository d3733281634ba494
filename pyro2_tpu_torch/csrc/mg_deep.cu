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
//                      of a one-ghost block, the ghosts copied;
//   mg_sweep        the card's form of the JAX package's jnp sweep smoother
//                      (no TPU kernel): on a block's one-ghost frame the
//                      refresh of the physical ghosts, one colour pass of
//                      red-black Gauss-Seidel (or none) and the refresh
//                      again, then by `emit` the frame alone (EMIT_V) or,
//                      after no pass, with the factor-2 restricted residual
//                      (EMIT_V_FC) or the residual on the frame, zero in
//                      the ghosts (EMIT_V_R).  The plain structure of the
//                      sharded multigrid runs its exchange-per-half-sweep
//                      smoothing and its unfused residual through it, one
//                      launch a colour pass with the seam exchange between.
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
// d - (s+1).  So the cells a step may update are a rectangle of the frame
// (`eligible`).  The ghosts of the other sides are refreshed after every
// step.
//
// The refresh.  Each edge of the plan (`plan`: 0 none, 1 when the block owns
// that domain edge (flags 4..7), 2 always, an unsplit periodic axis) sets
// its ghost row or column to +-1 times one source row or column, x-lo, x-hi,
// y-lo, y-hi in that order over full rows, so a corner is the y rule applied
// to the x-filled row.  A ghost thus always holds its sign times its source
// cell's current value, from the entry refresh on.
//
// The smoothers.  Red-black Gauss-Seidel updates in place (a colour reads
// only the other colour).  Damped Jacobi (omega 0.8) and Chebyshev read only
// the old iterate, so they step between two buffers.  Chebyshev carries its
// step dk.  theta, delta, sigma, rho are computed in the working type in the
// JAX package's order.
//
// The design: ordinary launches of tiles with deep halos in shared memory
// (mg_tiles.cuh, the boxes of mg_vcycle.cu's k_down and k_up), one launch a
// round at the solvers' sweeps.  The block grid tiles the owned block
// (sharded_mg_kernel.deep_plan picks the tile); the tiles at the frame's
// edges own its halo and ghosts too, unless the halo is deeper than their
// boxes' halo, when it has tiles of its own.  A block loads v and f over
// its cells and a halo of one cell per half-sweep (red-black) or step
// (Jacobi, Chebyshev) plus one for the residual, clipped to the frame, into
// shared memory -- on an unsplit periodic axis the box wraps, holding the
// cells
// its ghosts mirror, as k_up's does -- and runs every sweep there with
// block barriers only, updating a cell when it is eligible by its frame
// index and still exact in the box.  A refreshed ghost beside its source
// cell is never read from the box: a sweep reads it as its mirror (sign
// times the cell, nbrs), and the write-out gives each ghost its sign times
// its source cell's final value, which is what the entry refresh and every
// later refresh give it.  Jacobi's second iterate and Chebyshev's dk live
// in shared memory.  The block then writes its cells and the emit:
// EMIT_V_FC the restricted residual of its coarse cells (the tile is even
// and starts at an even excess, so it holds their children) and, from the
// tiles on the frame's edge, the coarse frame's zero ghosts, as k_down
// does; EMIT_V_R the residual of its owned cells, zero on its other cells.
// Where a halo for all the round's sweeps would not fit, the plan splits the
// round into sub-rounds of separate launches, each carrying its first
// sweep's index (lim and Chebyshev's scalars depend on it), alternating
// between the output and the scratch frame w (and Chebyshev's dk between
// two frames of dk) so that the last one ends in the output.
//
// What bounds it on the H100: 7-17 operations per cell update against 2
// values and 2-5 coefficient planes, so the bytes of the frames over the
// memory rate (sharded_mg_kernel.work).  The tiles read each neighbour from
// shared memory at the price of recomputing the halo (1.8x the cells of a
// 1024^2 frame with 64^2 tiles) and a block barrier a half-sweep.
//
// Each cell's arithmetic is the first design's, in its order, and the
// cells of a colour (or of a Jacobi step) do not read each other, so the
// results are the first design's bits whatever the tiling.  Each entry
// point returns the launch's cudaError_t (0 on success).
//
// k_sweep is a strided loop of one thread a frame cell, with no shared
// memory: the refresh is a function of the input (a refreshed ghost is its
// sign times its source cell, x's rule then y's, as k_deep's write-out), so
// a thread computes the entry value of any cell it reads, the colour's
// update of a cell it writes or mirrors, and a residual from the entry
// values.  Its colours are the block's local parity, which is the global
// one because the sharded levels' block offsets are even.
//
// Build (see sharded_mg_kernel.py and util/cuda_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libmg_deep.so mg_deep.cu

#include <cuda_runtime.h>
#include <stddef.h>

#include "mg_tiles.cuh"

namespace {

constexpr int THREADS = 256;       // k_correct's block
// k_deep's block: TILE_X threads (threadIdx.x) along a row, the plan's
// threads / TILE_X (threadIdx.y) over the rows, at most DEEP_THREADS
constexpr int TILE_X = 32, DEEP_THREADS = 512;

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
  bool wx, wy;           // an unsplit periodic axis: the box wraps
};

// the launch plan of sharded_mg_kernel.deep_plan: the tile (tx rows, ty
// columns; even), the halo, the sub-rounds and the sweeps of a full one,
// the block's threads, its shared memory (bytes), the grid (tiles along y,
// along x), the largest box (bh rows, bw columns) and the arrays of that
// size the block holds (v, f; Jacobi v's second iterate; Chebyshev dk)
struct DeepPlan {
  int tx, ty, halo, rounds, iters, threads, smem, gx, gy, bh, bw, arrays;
};

constexpr int DEEP_PLAN_INTS = 12;

// the arguments of one sub-round
template <typename T>
struct DeepArgs {
  const T* src;    // the sub-round's input frame (the caller's vd first)
  const T* fd;     // the right-hand side on the frame
  T* dst;          // its output frame
  T* ex;           // the last sub-round: EMIT_V_FC the coarse frame,
                   // EMIT_V_R the residual frame; else nullptr
  const T* dk_in;  // CHEBYSHEV after the first sub-round: its dk
  T* dk_out;       // CHEBYSHEV before the last sub-round: this one's dk
  Frame<T> F;
  T alpha, beta;
  int d, s0, iters;  // the round's sweeps s0 .. s0 + iters - 1
  DeepPlan t;
};

// the frame cells along one axis that a step at depth lim may update:
// excess <= lim toward a seam, 0 elsewhere; every cell on a wrapping axis
// (its cells are all owned)
__device__ __forceinline__ void eligible_span(int dp, int b, int seam_lo,
                                              int seam_hi, int lim,
                                              bool wrap, int& lo, int& hi) {
  lo = wrap ? INT_MIN : dp - (seam_lo ? lim : 0);
  hi = wrap ? INT_MAX : dp + b - 1 + (seam_hi ? lim : 0);
}

template <typename T>
__device__ __forceinline__ Rect eligible(const Frame<T>& F, int lim) {
  if (lim < 0 && (F.lim0[0] | F.lim0[1] | F.lim0[2] | F.lim0[3]))
    return Rect{0, -1, 0, -1};      // a seam side takes no cell at all
  Rect r;
  eligible_span(F.dpx, F.bx, F.lim0[0], F.lim0[1], lim, F.wx, r.i0, r.i1);
  eligible_span(F.dpy, F.by, F.lim0[2], F.lim0[3], lim, F.wy, r.j0, r.j1);
  return r;
}

// the tiles of the halo on each side of the owned block along an axis:
// none when the owned block's edge tiles can take it (it is no deeper than
// their boxes' halo h), else enough tiles of its own to cover it
__device__ __host__ inline int halo_tiles(int dp, int tile, int h) {
  return dp <= h ? 0 : (dp + tile - 1) / tile;
}

// the frame cells [o0, o1) along one axis that tile k of `tiles` writes:
// a tile of the halo below the owned block (the first one ragged), a share
// of the owned block (its edge tiles with the halo beside them when the
// halo has no tiles), or a tile of the halo above it (the last ragged)
__device__ __host__ inline void owned_span(int k, int tiles, int tile,
                                           int dp, int b, int h, int& o0,
                                           int& o1) {
  const int nl = halo_tiles(dp, tile, h), nb = tiles - 2 * nl;
  const int F = b + 2 * dp;
  if (k < nl) {
    o1 = dp - (nl - 1 - k) * tile;
    o0 = o1 - tile < 0 ? 0 : o1 - tile;
  } else if (k >= nl + nb) {
    o0 = dp + b + (k - nl - nb) * tile;
    o1 = o0 + tile > F ? F : o0 + tile;
  } else {
    const int m = k - nl;
    o0 = m == 0 && nl == 0 ? 0 : dp + m * tile;
    o1 = m == nb - 1 ? (nl == 0 ? F : dp + b) : dp + (m + 1) * tile;
  }
}

// the box of the owned span [o0, o1) and halo h along one axis: clipped to
// the frame, or wrapped around an unsplit periodic axis (whose owned cells
// are 1 .. b); the ghosts of refreshed edges mirror their source cells
__device__ __host__ inline BoxAxis deep_axis(int o0, int o1, int h, int F,
                                             int b, bool wrap, bool on_lo,
                                             bool on_hi, int src_lo,
                                             int src_hi) {
  if (wrap) return BoxAxis{o0 - h, o1 - o0 + 2 * h, 1, b, INT_MIN, INT_MAX,
                           b, true};
  const int e0 = o0 - h < 0 ? 0 : o0 - h;
  const int e1 = o1 + h > F ? F : o1 + h;
  return BoxAxis{e0, e1 - e0, 0, F - 1, on_lo ? src_lo : INT_MIN,
                 on_hi ? src_hi : INT_MAX, 0, false};
}

template <int OP, int SM, int EMIT, typename T>
__global__ void __launch_bounds__(DEEP_THREADS) k_deep(DeepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Frame<T>& F = a.F;
  const DeepPlan& p = a.t;
  const int q = F.q;
  int r0, r1, c0, c1;   // the frame rows and columns this block writes
  owned_span((int)blockIdx.y, p.gy, p.tx, F.dpx, F.bx, p.halo, r0, r1);
  owned_span((int)blockIdx.x, p.gx, p.ty, F.dpy, F.by, p.halo, c0, c1);
  const FrameBox t{
      deep_axis(r0, r1, p.halo, F.Fx, F.bx, F.wx, F.on[0], F.on[1],
                F.src[0], F.src[1]),
      deep_axis(c0, c1, p.halo, F.Fy, F.by, F.wy, F.on[2], F.on[3],
                F.src[2], F.src[3])};
  const int cells = p.bh * p.bw;
  T* b = reinterpret_cast<T*>(smem_raw);
  T* fb = b + cells;
  T* b2 = fb + cells;     // JACOBI, CHEBYSHEV: the second iterate
  T* dk = b2 + cells;     // CHEBYSHEV: its step
  load_box(b, fb, t, q, a.fd, [&](int c, int, int) { return a.src[c]; });

  T* cur = b;   // the box of the current iterate
  if constexpr (SM == RBGS) {
    // half-sweep s: sweep s0 + (s - 1) / 2, red (colour 0) then black,
    // red the cells whose excess distances from the owned block's first
    // row and column sum to an even number
    tile_smooth<OP>(b, fb, t, F, 2 * a.iters, (F.dpx + F.dpy) & 1,
                    [&](int s) {
                      const int sweep = a.s0 + (s - 1) / 2;
                      return eligible(F, a.d - (2 * sweep + 1) -
                                             ((s - 1) & 1));
                    });
  } else {
    if (SM == CHEBYSHEV && a.s0 > 0) {
      const int i1 = t.x.hi(), j1 = t.y.hi();
      for (int i = t.x.lo() + (int)threadIdx.y; i <= i1; i += blockDim.y) {
        const int it = t.x.wrap(i);
        for (int j = t.y.lo() + (int)threadIdx.x; j <= j1; j += blockDim.x)
          dk[t.at(i, j)] = a.dk_in[it * q + t.y.wrap(j)];
      }
      __syncthreads();
    }
    const T omega = T(0.8);
    const T theta = T(1.25), delta = T(0.75);
    const T sigma = theta / delta;
    T rho = T(1) / sigma;
    for (int s = 1; s < a.s0; ++s) rho = T(1) / (T(2) * sigma - rho);
    T* nxt = b2;
    for (int k = 1; k <= a.iters; ++k) {
      const int s = a.s0 + k - 1;        // the step of the round
      T c1 = T(0), c2 = T(0), rho_new = T(0);
      if (SM == CHEBYSHEV && s > 0) {
        rho_new = T(1) / (T(2) * sigma - rho);
        c1 = rho_new * rho;
        c2 = T(2) * rho_new / delta;
      }
      const Rect e = eligible(F, a.d - (s + 1));
      const int i0 = t.x.lo_s(k), i1 = t.x.hi_s(k);
      const int j0 = t.y.lo_s(k), j1 = t.y.hi_s(k);
      for (int i = i0 + (int)threadIdx.y; i <= i1; i += blockDim.y) {
        const int it = t.x.wrap(i);
        const bool ei = i >= e.i0 && i <= e.i1;
        for (int j = j0 + (int)threadIdx.x; j <= j1; j += blockDim.x) {
          const int o = t.at(i, j);
          const bool el = ei && j >= e.j0 && j <= e.j1;
          const T x = cur[o];
          T gsv = T(0);
          if (el) {
            const Nbrs<T> v = t.nbrs(cur, F, o, i, j, x);
            gsv = gs_val<OP>(v.xp, v.xm, v.yp, v.ym, fb[o], F,
                             it * q + t.y.wrap(j));
          }
          T val = x;
          if constexpr (SM == JACOBI) {
            if (el) val = x + omega * (gsv - x);
          } else {
            const T z = el ? gsv - x : T(0);
            const T step = s == 0 ? z / theta : c1 * dk[o] + c2 * z;
            dk[o] = step;
            if (el) val = x + step;
          }
          nxt[o] = val;
        }
      }
      __syncthreads();
      T* sw = cur;
      cur = nxt;
      nxt = sw;
      if (SM == CHEBYSHEV && s > 0) rho = rho_new;
    }
  }

  // the block's cells: a refreshed ghost its sign times its source cell
  // (x's rule, then y's over the x-filled row), every other cell its own
  for (int i = r0 + (int)threadIdx.y; i < r1; i += blockDim.y) {
    const bool gxl = !F.wx && F.on[0] && i == F.ghost[0];
    const bool gxh = !F.wx && F.on[1] && i == F.ghost[1];
    const int si = gxl ? F.src[0] : gxh ? F.src[1] : i;
    for (int j = c0 + (int)threadIdx.x; j < c1; j += blockDim.x) {
      const bool gyl = !F.wy && F.on[2] && j == F.ghost[2];
      const bool gyh = !F.wy && F.on[3] && j == F.ghost[3];
      T val = cur[t.at(si, gyl ? F.src[2] : gyh ? F.src[3] : j)];
      if (gxl) val = F.sgn[0] * val;
      if (gxh) val = F.sgn[1] * val;
      if (gyl) val = F.sgn[2] * val;
      if (gyh) val = F.sgn[3] * val;
      a.dst[i * q + j] = val;
      if (SM == CHEBYSHEV && a.dk_out) a.dk_out[i * q + j] = dk[t.at(i, j)];
    }
  }
  if (EMIT == EMIT_V || !a.ex) return;

  // the residual of owned cell (i, j) from the box
  auto res = [&](int i, int j) {
    const int o = t.at(i, j);
    const T v0 = cur[o];
    const Nbrs<T> v = t.nbrs(cur, F, o, i, j, v0);
    return resid_val<OP>(v0, v.xp, v.xm, v.yp, v.ym, fb[o], F, a.alpha,
                         a.beta, i * q + j);
  };
  if constexpr (EMIT == EMIT_V_R) {
    for (int i = r0 + (int)threadIdx.y; i < r1; i += blockDim.y) {
      const bool oi = i >= F.dpx && i < F.dpx + F.bx;
      for (int j = c0 + (int)threadIdx.x; j < c1; j += blockDim.x)
        a.ex[i * q + j] = oi && j >= F.dpy && j < F.dpy + F.by ? res(i, j)
                                                               : T(0);
    }
  } else {
    // this block's rows and columns of the coarse frame: its tile's coarse
    // cells, and the ghosts beside them on the frame's edge (a tile of the
    // halo has none)
    const int ncx = F.bx / 2, ncy = F.by / 2, qc = ncy + 2;
    const int mx = (int)blockIdx.y - halo_tiles(F.dpx, p.tx, p.halo);
    const int my = (int)blockIdx.x - halo_tiles(F.dpy, p.ty, p.halo);
    const int nbx = (F.bx + p.tx - 1) / p.tx, nby = (F.by + p.ty - 1) / p.ty;
    if (mx < 0 || mx >= nbx || my < 0 || my >= nby) return;
    const int I0 = 1 + mx * (p.tx / 2), J0 = 1 + my * (p.ty / 2);
    const int R0 = mx == 0 ? 0 : I0;
    const int R1 = mx == nbx - 1 ? ncx + 2 : I0 + p.tx / 2;
    const int C0 = my == 0 ? 0 : J0;
    const int C1 = my == nby - 1 ? ncy + 2 : J0 + p.ty / 2;
    for (int I = R0 + (int)threadIdx.y; I < R1; I += blockDim.y) {
      for (int J = C0 + (int)threadIdx.x; J < C1; J += blockDim.x) {
        T val = T(0);
        if (I >= 1 && I <= ncx && J >= 1 && J <= ncy) {
          const int i = F.dpx + 2 * I - 2, j = F.dpy + 2 * J - 2;
          val = T(0.25) * (((res(i, j) + res(i + 1, j)) + res(i, j + 1)) +
                           res(i + 1, j + 1));
        }
        a.ex[I * qc + J] = val;
      }
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

// the frame cell that cell (i, j) of a one-ghost frame mirrors after the
// physical refresh, x's rule then y's, and the product of the signs
template <typename T>
__device__ __forceinline__ int mirror(const Frame<T>& F, int i, int j,
                                      T& s) {
  if (F.on[0] && i == F.ghost[0]) {
    i = F.src[0];
    s = s * F.sgn[0];
  } else if (F.on[1] && i == F.ghost[1]) {
    i = F.src[1];
    s = s * F.sgn[1];
  }
  if (F.on[2] && j == F.ghost[2]) {
    j = F.src[2];
    s = s * F.sgn[2];
  } else if (F.on[3] && j == F.ghost[3]) {
    j = F.src[3];
    s = s * F.sgn[3];
  }
  return i * F.q + j;
}

// one colour pass (colour 0 red, 1 black, -1 none) on the one-ghost frame v
// of a bx x by block, and the emit (after no pass only)
template <int OP, int EMIT, typename T>
__global__ void __launch_bounds__(THREADS) k_sweep(const T* v, const T* f,
                                                   T* vo, T* ex, Frame<T> F,
                                                   T alpha, T beta,
                                                   int colour) {
  const int q = F.q, n = F.Fx * q;
  const int stride = gridDim.x * blockDim.x;
  const int k0 = blockIdx.x * blockDim.x + threadIdx.x;
  // the refreshed input at cell (i, j)
  auto entry = [&](int i, int j) {
    T s = T(1);
    const int c = mirror(F, i, j, s);
    return s * v[c];
  };
  auto inside = [&](int i, int j) {
    return i >= 1 && i <= F.bx && j >= 1 && j <= F.by;
  };
  // the value of cell (i, j) after the pass, before the second refresh
  auto swept = [&](int i, int j) {
    const int c = i * q + j;
    if (colour >= 0 && inside(i, j) && ((i + j) & 1) == colour)
      return gs_val<OP>(entry(i + 1, j), entry(i - 1, j), entry(i, j + 1),
                        entry(i, j - 1), f[c], F, c);
    return inside(i, j) ? v[c] : entry(i, j);
  };
  for (int k = k0; k < n; k += stride) {
    const int i = k / q, j = k - (k / q) * q;
    T s = T(1);
    const int c = mirror(F, i, j, s);
    const int si = c / q, sj = c - (c / q) * q;
    vo[k] = s * swept(si, sj);
  }
  if constexpr (EMIT == EMIT_V) return;
  // the residual of interior cell (i, j) of the refreshed frame
  auto res = [&](int i, int j) {
    const int c = i * q + j;
    return resid_val<OP>(v[c], entry(i + 1, j), entry(i - 1, j),
                         entry(i, j + 1), entry(i, j - 1), f[c], F, alpha,
                         beta, c);
  };
  if constexpr (EMIT == EMIT_V_R) {
    for (int k = k0; k < n; k += stride) {
      const int i = k / q, j = k - (k / q) * q;
      ex[k] = inside(i, j) ? res(i, j) : T(0);
    }
  } else {
    const int qc = F.by / 2 + 2, nc = (F.bx / 2 + 2) * qc;
    for (int k = k0; k < nc; k += stride) {
      const int I = k / qc, J = k - (k / qc) * qc;
      T val = T(0);
      if (I >= 1 && I <= F.bx / 2 && J >= 1 && J <= F.by / 2) {
        const int i = 2 * I - 1, j = 2 * J - 1;
        val = T(0.25) * (((res(i, j) + res(i + 1, j)) + res(i, j + 1)) +
                         res(i + 1, j + 1));
      }
      ex[k] = val;
    }
  }
}

// -- launches -------------------------------------------------------------------

// the largest box along one axis of the plan's tiles
int widest_box(int tiles, int tile, int h, int dp, int b, bool wrap) {
  int most = 0;
  for (int k = 0; k < tiles; ++k) {
    int o0, o1;
    owned_span(k, tiles, tile, dp, b, h, o0, o1);
    const BoxAxis x =
        deep_axis(o0, o1, h, b + 2 * dp, b, wrap, false, false, 0, 0);
    most = x.w > most ? x.w : most;
  }
  return most;
}

// the tiles along an axis of b owned cells tile a side, dp deep: the
// owned block's, and the halo's on each side
bool tiles_ok(int tiles, int tile, int dp, int b, int h) {
  const int nb = tiles - 2 * halo_tiles(dp, tile, h);
  return tile >= 2 && tile % 2 == 0 && nb >= 1 && (nb - 1) * tile < b &&
         nb * tile >= b;
}

// the plan (sharded_mg_kernel.deep_plan) against the kernel: even tiles
// whose grid covers the owned block once and the halo beside it, a halo
// as deep as a sub-round's reach plus the residual's ring, sub-rounds that
// take n_sweeps together, its block, and boxes that fit its arrays and
// shared memory
template <typename T>
bool deep_plan_ok(const Frame<T>& F, const DeepPlan& t, int sm, int nsweeps) {
  const int reach = sm == RBGS ? 2 : 1;
  const int arrays = sm == RBGS ? 2 : sm == JACOBI ? 3 : 4;
  const int rounds =
      nsweeps == 0 ? 1 : (nsweeps + t.iters - 1) / (t.iters > 0 ? t.iters : 1);
  if (!tiles_ok(t.gy, t.tx, F.dpx, F.bx, t.halo) ||
      !tiles_ok(t.gx, t.ty, F.dpy, F.by, t.halo))
    return false;
  if (t.iters < 0 || (nsweeps > 0 && t.iters < 1) || t.rounds != rounds ||
      t.halo < reach * t.iters + 1 || t.threads < TILE_X ||
      t.threads > DEEP_THREADS || t.threads % TILE_X || t.arrays != arrays)
    return false;
  if (t.bh < widest_box(t.gy, t.tx, t.halo, F.dpx, F.bx, F.wx) ||
      t.bw < widest_box(t.gx, t.ty, t.halo, F.dpy, F.by, F.wy))
    return false;
  return (long)t.smem >= (long)arrays * t.bh * t.bw * (long)sizeof(T);
}

template <int OP, int SM, int EMIT, typename T>
int launch_deep(const DeepArgs<T>& base, const T* vd, T* vo, T* ex, T* w,
                T* dk, int nsweeps, cudaStream_t st) {
  static int opted = 0;
  auto kernel = k_deep<OP, SM, EMIT, T>;
  const DeepPlan& t = base.t;
  if (t.smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        t.smem);
    if (e != cudaSuccess) return (int)e;
    opted = t.smem;
  }
  DeepArgs<T> a = base;
  const size_t nf = (size_t)base.F.Fx * base.F.Fy;
  const T* src = vd;
  for (int k = 0; k < t.rounds; ++k) {
    const bool last = k == t.rounds - 1;
    a.src = src;
    a.dst = round_dst(k, t.rounds, vo, w);
    a.ex = last ? ex : nullptr;
    a.s0 = k * t.iters;
    a.iters = min(t.iters, nsweeps - a.s0);
    a.dk_in = SM == CHEBYSHEV && k > 0 ? dk + ((k - 1) & 1) * nf : nullptr;
    a.dk_out = SM == CHEBYSHEV && !last ? dk + (k & 1) * nf : nullptr;
    kernel<<<dim3(t.gx, t.gy), dim3(TILE_X, t.threads / TILE_X), t.smem,
             st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = a.dst;
  }
  return 0;
}

template <int OP, int SM, typename T>
int by_emit(int emit, const DeepArgs<T>& a, const T* vd, T* vo, T* ex, T* w,
            T* dk, int nsweeps, cudaStream_t st) {
  switch (emit) {
    case EMIT_V:
      return launch_deep<OP, SM, EMIT_V>(a, vd, vo, ex, w, dk, nsweeps, st);
    case EMIT_V_FC:
      return launch_deep<OP, SM, EMIT_V_FC>(a, vd, vo, ex, w, dk, nsweeps,
                                            st);
    case EMIT_V_R:
      return launch_deep<OP, SM, EMIT_V_R>(a, vd, vo, ex, w, dk, nsweeps,
                                           st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int OP, typename T>
int by_smoother(int smoother, int emit, const DeepArgs<T>& a, const T* vd,
                T* vo, T* ex, T* w, T* dk, int nsweeps, cudaStream_t st) {
  switch (smoother) {
    case RBGS:
      return by_emit<OP, RBGS>(emit, a, vd, vo, ex, w, dk, nsweeps, st);
    case JACOBI:
      return by_emit<OP, JACOBI>(emit, a, vd, vo, ex, w, dk, nsweeps, st);
    case CHEBYSHEV:
      return by_emit<OP, CHEBYSHEV>(emit, a, vd, vo, ex, w, dk, nsweeps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the refresh of each edge of frame F (its geometry set) from the block's
// flags and the edges' plan and kinds; false if an axis would wrap that is
// split, deeper than one cell or (pow2: k_deep's boxes, whose
// BoxAxis::wrap masks) not a power of 2
template <typename T>
bool frame_edges(Frame<T>& F, const int* flags, const int* plan,
                 const int* kinds, bool pow2) {
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
  // an axis whose ghosts mirror the opposite side wraps: one cell of halo,
  // no seam, and a power-of-2 block
  for (int axis = 0; axis < 2; ++axis) {
    const int lo = 2 * axis, hi = lo + 1;
    const bool wrap = F.on[lo] && kinds[lo] == PERIODIC;
    if (wrap != (F.on[hi] && kinds[hi] == PERIODIC) ||
        (wrap && (dp[axis] != 1 || F.lim0[lo] || F.lim0[hi] ||
                  (pow2 && (b[axis] & (b[axis] - 1))))))
      return false;
    (axis == 0 ? F.wx : F.wy) = wrap;
  }
  return true;
}

// geom: bx, by, dpx, dpy, d, n_sweeps; flags: seam x-lo, x-hi, y-lo, y-hi,
// own x-lo, ..., y-hi; plan, kinds: per edge; coef: xc, yc, den, dx2, dy2;
// ab: alpha, beta; tiles: the launch plan (DeepPlan); w: the scratch frame
// of the sub-rounds (more than one); dk: Chebyshev's two frames of dk
// (more than one sub-round)
template <typename T>
int deep_smooth(const T* vd, const T* fd, const void* planes, T* vo, T* ex,
                T* w, T* dk, const int* geom, int op, int smoother, int emit,
                const int* flags, const int* plan, const int* kinds,
                const double* coef, const double* ab, const int* tiles,
                cudaStream_t st) {
  DeepArgs<T> a;
  Frame<T>& F = a.F;
  F.bx = geom[0];
  F.by = geom[1];
  F.dpx = geom[2];
  F.dpy = geom[3];
  a.d = geom[4];
  const int nsweeps = geom[5];
  F.Fx = F.bx + 2 * F.dpx;
  F.Fy = F.by + 2 * F.dpy;
  if (F.bx < 2 || F.by < 2 || F.bx % 2 || F.by % 2 || F.dpx < 1 ||
      F.dpy < 1 || nsweeps < 0 || (op != OP_CONST && !planes) ||
      (emit != EMIT_V && !ex) || smoother < RBGS || smoother > CHEBYSHEV)
    return (int)cudaErrorInvalidValue;
  F.q = F.Fy;
  F.qq = (size_t)F.Fx * F.Fy;
  F.xc = (T)coef[0];
  F.yc = (T)coef[1];
  F.den = (T)coef[2];
  F.dx2 = (T)coef[3];
  F.dy2 = (T)coef[4];
  F.c = static_cast<const T*>(planes);
  if (!frame_edges(F, flags, plan, kinds, true))
    return (int)cudaErrorInvalidValue;
  a.t = DeepPlan{tiles[0], tiles[1], tiles[2],  tiles[3],
                 tiles[4], tiles[5], tiles[6],  tiles[7],
                 tiles[8], tiles[9], tiles[10], tiles[11]};
  if (!deep_plan_ok(F, a.t, smoother, nsweeps) || (a.t.rounds > 1 && !w) ||
      (smoother == CHEBYSHEV && a.t.rounds > 1 && !dk))
    return (int)cudaErrorInvalidValue;
  a.fd = fd;
  a.alpha = (T)ab[0];
  a.beta = (T)ab[1];
  switch (op) {
    case OP_CONST:
      return by_smoother<OP_CONST>(smoother, emit, a, vd, vo, ex, w, dk,
                                   nsweeps, st);
    case OP_VC:
      return by_smoother<OP_VC>(smoother, emit, a, vd, vo, ex, w, dk,
                                nsweeps, st);
    case OP_GENERAL:
      return by_smoother<OP_GENERAL>(smoother, emit, a, vd, vo, ex, w, dk,
                                     nsweeps, st);
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

template <int OP, typename T>
int launch_sweep(int emit, const T* v, const T* f, T* vo, T* ex,
                 const Frame<T>& F, T alpha, T beta, int colour,
                 cudaStream_t st) {
  const int n = F.Fx * F.Fy;
  int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  switch (emit) {
    case EMIT_V:
      k_sweep<OP, EMIT_V, T><<<blocks, THREADS, 0, st>>>(v, f, vo, ex, F,
                                                          alpha, beta, colour);
      break;
    case EMIT_V_FC:
      k_sweep<OP, EMIT_V_FC, T><<<blocks, THREADS, 0, st>>>(
          v, f, vo, ex, F, alpha, beta, colour);
      break;
    case EMIT_V_R:
      k_sweep<OP, EMIT_V_R, T><<<blocks, THREADS, 0, st>>>(
          v, f, vo, ex, F, alpha, beta, colour);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// geom: bx, by; colour: 0 red, 1 black, -1 no pass (the only one an emit
// other than EMIT_V takes); flags, plan, kinds, coef, ab: as deep_smooth's
template <typename T>
int sweep(const T* v, const T* f, const void* planes, T* vo, T* ex,
          const int* geom, int op, int colour, int emit, const int* flags,
          const int* plan, const int* kinds, const double* coef,
          const double* ab, cudaStream_t st) {
  Frame<T> F;
  F.bx = geom[0];
  F.by = geom[1];
  F.dpx = F.dpy = 1;
  F.Fx = F.bx + 2;
  F.Fy = F.by + 2;
  if (F.bx < 2 || F.by < 2 || F.bx % 2 || F.by % 2 || colour < -1 ||
      colour > 1 || (op != OP_CONST && !planes) ||
      (emit != EMIT_V && (!ex || colour >= 0)))
    return (int)cudaErrorInvalidValue;
  F.q = F.Fy;
  F.qq = (size_t)F.Fx * F.Fy;
  F.xc = (T)coef[0];
  F.yc = (T)coef[1];
  F.den = (T)coef[2];
  F.dx2 = (T)coef[3];
  F.dy2 = (T)coef[4];
  F.c = static_cast<const T*>(planes);
  if (!frame_edges(F, flags, plan, kinds, false))
    return (int)cudaErrorInvalidValue;
  const T alpha = (T)ab[0], beta = (T)ab[1];
  switch (op) {
    case OP_CONST:
      return launch_sweep<OP_CONST>(emit, v, f, vo, ex, F, alpha, beta,
                                    colour, st);
    case OP_VC:
      return launch_sweep<OP_VC>(emit, v, f, vo, ex, F, alpha, beta, colour,
                                 st);
    case OP_GENERAL:
      return launch_sweep<OP_GENERAL>(emit, v, f, vo, ex, F, alpha, beta,
                                      colour, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define ENTRIES(T, SFX)                                                       \
  extern "C" int mg_deep_smooth_##SFX(                                        \
      const T* vd, const T* fd, const void* planes, T* vo, T* ex, T* w,       \
      T* dk, const int* geom, int op, int smoother, int emit,                 \
      const int* flags, const int* plan, const int* kinds,                    \
      const double* coef, const double* ab, const int* tiles,                 \
      void* stream) {                                                         \
    return deep_smooth<T>(vd, fd, planes, vo, ex, w, dk, geom, op, smoother,  \
                          emit, flags, plan, kinds, coef, ab, tiles,          \
                          (cudaStream_t)stream);                              \
  }                                                                           \
  extern "C" int mg_correct_##SFX(const T* v, const T* vc, T* vo, int bx,     \
                                  int by, void* stream) {                     \
    return correct<T>(v, vc, vo, bx, by, (cudaStream_t)stream);               \
  }                                                                           \
  extern "C" int mg_sweep_##SFX(                                              \
      const T* v, const T* f, const void* planes, T* vo, T* ex,               \
      const int* geom, int op, int colour, int emit, const int* flags,        \
      const int* plan, const int* kinds, const double* coef,                  \
      const double* ab, void* stream) {                                       \
    return sweep<T>(v, f, planes, vo, ex, geom, op, colour, emit, flags,      \
                    plan, kinds, coef, ab, (cudaStream_t)stream);             \
  }

// the length of the plan array the mg_deep_smooth entries take
// (sharded_mg_kernel.deep_plan)
extern "C" int mg_deep_plan_ints() { return DEEP_PLAN_INTS; }

ENTRIES(float, f32)
ENTRIES(double, f64)
