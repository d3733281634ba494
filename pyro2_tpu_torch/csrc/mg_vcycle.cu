// mg_vcycle.cu -- the multigrid V-cycle on Hopper, for the three operators
// of pyro2_tpu_torch/multigrid (OP_CONST, OP_VC, OP_GENERAL: MG.CellCenterMG2d,
// variable_coeff_MG.VarCoeffCCMG2d and general_MG.GeneralMG2d), whose stencils,
// restriction and prolongation live in mg_ops.cuh, shared with mg_deep.cu.
// OP_CONST replaces the JAX package's pallas_mg.py, the other two
// pyro2_tpu/multigrid/pallas_gen_mg.py, all on a square 2^k grid with one
// ghost cell and homogeneous standard BCs.  One template per kernel,
// instantiated for each operator (and for the constant operator's 64^2
// tiles, k_down and k_up overloaded on RegArgs, with its cells in
// registers):
//
//   mg_core  <- _make_core_kernel / _make_core_kernel_g: the whole
//               sub-V-cycle of the coarse levels 0..top (nsmooth_bottom
//               sweeps on 2x2), plus the residual when no level is peeled;
//   mg_down  <- _make_down_kernel(_g) and _make_down_banded(_g): nsmooth
//               red-black Gauss-Seidel sweeps, the residual, and its factor-2
//               restriction into the coarse f (ghosts zero), in tiles
//               (below);
//   mg_up    <- _make_up_kernel(_g) and _make_up_banded(_g): prolong and
//               correct, a ghost fill, nsmooth sweeps, and the residual on
//               the finest level, in tiles (below).
//
// The TPU cut levels above 512^2 into 128-row bands with deep halos only
// because a frame did not fit in VMEM (and so could not take periodic x
// edges there); here one mg_down and one mg_up serve every peeled level,
// whatever its size and edges.  Restriction and prolongation are plain
// stencils shared by the operators (the TPU built them as iota matmuls only
// because Mosaic could not lower strided ops): no tensor cores, no TF32.
//
// Coefficient planes.  A VC or GENERAL level carries a device pointer to its
// (ncoef, q, q) plane stack, built once per solver object in PyTorch.  They
// stay in device memory, read through the caches, in every kernel: the
// core's shared memory holds v and f of each core level as for OP_CONST, so
// the core keeps the same levels (up to 128^2 in float32, 64^2 in float64)
// for every operator.  The TPU kernel hoisted the shifted coefficients and
// the denominator out of its sweep loop because Mosaic recomputed them;
// here each cell update reads its four edge values (and alpha, gamma) and
// forms the denominator itself, which costs no extra traffic.
//
// Arithmetic: each stencil (mg_ops.cuh) is written in the order of the plain
// PyTorch version (MG.py, variable_coeff_MG.py, general_MG.py), and the build
// uses -fmad=false, so the two agree to a few roundings (the coefficient
// forms, which have no division by a Python scalar, bit for bit).
//
// Ghost fills.  A homogeneous fill sets every ghost cell to +-1 times one
// interior cell: x-lo, x-hi, y-lo, y-hi in that order, so a corner is the
// y-edge rule applied to the x-filled row, i.e. sx * sy * v[src_x, src_y].
// A ZERO edge (the cavity's moving lid, whose fill at multigrid level
// writes 0.0) has the sign 0, and the constant operator's kernels write
// its ghosts, corners included, as +0, as the plain fill leaves them
// (`mirror`); the coefficient operators take no ZERO edge.
// Periodic in a one-ghost frame reads ghost_lo <- a[q-2], ghost_hi <- a[1].
// Since a ghost depends on exactly one interior cell, the thread that
// writes an interior cell also writes the ghosts that mirror it (`put`).
// That keeps the ghosts consistent after every half-sweep without a
// separate fill pass.  It is race-free: in a red-black half-sweep a ghost
// is read only by the interior cell next to it, and that cell is either
// the ghost's own source (same thread, read before write) or, for periodic
// edges, a cell of the other colour (n is even), which is not updated in
// the same half-sweep.
//
// mg_down and mg_up: ordinary launches with no grid-wide barrier, one at
// the solvers' nsmooth (temporal blocking, as the TPU's banded kernels for
// levels above 512^2): each block owns a tile of the level and runs every
// half-sweep on a box of the tile and a halo as deep as the sweeps reach,
// with block barriers only -- the constant operator's 64^2 tiles with each
// thread's cells of the box in its registers (k_down / k_up on RegArgs,
// mg_tiles.cuh reg_smooth), smaller tiles and the coefficient operators
// with the box in shared memory, f beside it (tile_smooth, k_down<OP, T>,
// k_up<OP, T>); the descent's last round restricts the residual of its
// tile's cells from the box (a tile starts at an odd index and is even, so
// it holds the four children of each of its coarse cells).
// mg_kernel.tile_plan picks the tile per level and operator, and splits
// the sweeps into rounds of separate launches where a halo for all of them
// would not fit.
// mg_core: one launch of a thread-block cluster, each block holding v and
// f of every level 0..top in its shared memory (128^2 float32: 183 KB;
// 64^2 float64: 96 KB), laid out, scheduled and clustered as the launch's
// schedule array (mg_kernel.core_plan) says.
//
// What bounds it on the H100: a level's sweeps are a chain of dependent
// stencils, 7 (CONST), 13 (VC) or 17 (GENERAL) operations per cell update
// against 2 values and 2-5 coefficients in and one out, so a call's least
// time is the bytes of its frames and planes over the memory rate
// (mg_kernel.work counts them).  mg_down and mg_up are far from it: a
// round is 2 nsmooth dependent half-sweeps of a box, each ended by a block
// barrier, and each cell update's IEEE division branches to a slow path
// (taken for a zero or tiny numerator), which bounds how far a thread's
// updates overlap, so the time goes into the instructions and the
// shared-memory traffic of each update and into the halo swept again.
// Held in shared memory (tile_smooth), an update read its four neighbours
// and f there, with the stride-2 colour walk's 2-way bank conflict, and
// walked its box and frame indices and edge tests.  The constant
// operator's 64^2 tiles instead keep each thread's cells in registers
// (reg_smooth): an update reads its f from the thread's own
// slot, one neighbour from the next lane and, only at a run's first or
// last row or at a warp's edge, one from shared memory, with no index
// walk and no lane idle.  Without f's box in shared memory a float64
// block takes a 64^2 tile (box 106^2: it loads 2.74 and sweeps 1.80 times
// its tile) where it took 32^2 (5.35 and 2.87 times).  The registers bound
// the box (mg_kernel.TILE_ROWS, TILE_THREADS), and a smaller box gives the
// block fewer threads than tile_smooth's, whose slow-path divisions (the
// coarse levels' zero numerators) then run in series, so smaller tiles
// keep tile_smooth; the coefficient operators, whose updates also read
// their coefficients at the frame, spilled with their cells in registers
// and keep it too.  The core
// cannot approach its byte bound at all: it
// is a chain of ~400 dependent phases (a top of 128^2 at nsmooth 10 / 50
// bottom sweeps), most of them on levels of 4 to 256 cells, and on one
// block the 128^2 level's sweeps are bound by one SM's instruction
// throughput.  Its design:
//   * the levels of at least mg_kernel.CLUSTER_N cells a side are spread
//     by rows over the CORE_CTAS blocks of a cluster, one SM each; a sweep
//     reads the rows beside a block's own from its neighbours' shared
//     memory (distributed shared memory), a cluster barrier ends each
//     half-sweep, the halo rows are copied in once before the
//     restriction reads them, and a last cluster barrier keeps every
//     block resident until its neighbours have read its top-level rows;
//   * the levels below run on block 0 alone, each on the first warps(l)
//     warps of mg_kernel.core_schedule (enough that each lane updates at
//     least one cell of a colour), its phases ending in the barrier of just
//     those warps -- __syncwarp() for one warp (the levels up to 8^2, the
//     2x2 bottom's 100 half-sweeps among them), a named barrier
//     (bar.sync id, n) for 2..16 warps, __syncthreads() for the whole
//     block.  Warps whose level is done wait at their own level's next
//     barrier, so the groups nest: the descent hands each coarser level
//     to a prefix of the warps that restricted it, and the ascent takes
//     them back;
//   * a sweep writes interior cells only, reading a neighbour across the
//     edge as the sign times the interior cell its ghost mirrors, and a
//     level's colour is walked with shifts and masks of its power-of-2
//     width: no division, and no lane branching to write ghosts, in the
//     sweep; the ghosts are filled once a level, before the restriction,
//     the prolongation or the output reads them.
// Each cell's arithmetic is the first design's, and the cells of a colour
// do not read each other, so the core's results are the same bits
// whatever its schedule.
//
// Each entry point returns the launch's cudaError_t (0 on success).
//
// Build (see mg_kernel.py and util/cuda_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libmg_vcycle.so mg_vcycle.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mg_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXLEV = 16;        // levels of the core: 2^1 .. 2^16 per side
constexpr int CORE_THREADS = 1024;
constexpr int CORE_CTAS = 8;      // the cluster of a core with spread levels

// ghost-fill kind of an edge (mg_kernel.BC_KIND and mg_kernel.ZERO): a
// ghost is the interior cell it mirrors (COPY), its negative (NEGATE), the
// cell across the level (PERIODIC), or +0 (ZERO: the lid-driven cavity's
// moving lid at multigrid level)
enum { COPY = 0, NEGATE = 1, PERIODIC = 2, ZERO = 3 };

// one level: its size, stencil coefficients and ghost sources
template <typename T>
struct Lev {
  int n, q;                  // interior cells per side; frame side n + 2
  size_t qq;                 // cells of a frame: the planes' stride
  T xc, yc, den;             // CONST: beta/dx^2, beta/dy^2, alpha+2xc+2yc
  T dx2, dy2;                // CONST: dx^2, dy^2 of the residual's Laplacian
  int sxl, sxh, syl, syh;    // interior row / column each ghost edge mirrors
  T gxl, gxh, gyl, gyh;      // and its sign (0 on a ZERO edge)
  const T* c;                // VC / GENERAL: the (ncoef, q, q) plane stack
};

// the sign of an edge's ghosts: -1 NEGATE, 0 ZERO, else 1
template <typename T>
T sign_of(int kind) {
  return kind == NEGATE ? T(-1) : kind == ZERO ? T(0) : T(1);
}

// coef holds xc, yc, den, dx2, dy2; bc the kinds of x-lo, x-hi, y-lo, y-hi;
// planes the level's coefficient stack (nullptr for OP_CONST)
template <typename T>
Lev<T> make_level(int n, const double* coef, const int* bc,
                  const void* planes) {
  Lev<T> L;
  L.c = static_cast<const T*>(planes);
  L.n = n;
  L.q = n + 2;
  L.qq = (size_t)L.q * L.q;
  L.xc = (T)coef[0];
  L.yc = (T)coef[1];
  L.den = (T)coef[2];
  L.dx2 = (T)coef[3];
  L.dy2 = (T)coef[4];
  L.sxl = bc[0] == PERIODIC ? L.q - 2 : 1;
  L.sxh = bc[1] == PERIODIC ? 1 : L.q - 2;
  L.syl = bc[2] == PERIODIC ? L.q - 2 : 1;
  L.syh = bc[3] == PERIODIC ? 1 : L.q - 2;
  L.gxl = sign_of<T>(bc[0]);
  L.gxh = sign_of<T>(bc[1]);
  L.gyl = sign_of<T>(bc[2]);
  L.gyh = sign_of<T>(bc[3]);
  return L;
}

// the ghost that mirrors a cell of value val across an edge of sign g, as
// the kernels write it: g * val, and for the constant operator +0 on a
// ZERO edge (g = 0), where the product would be -0 for a negative val.
// The coefficient operators take no ZERO edge (mg_kernel.check), and
// their ghosts stay the bare product: the select changed the register
// allocation of k_up<general> and cost it 14% on the H100.  A sweep reads
// a neighbour across an edge as the product alone: a -0 there can only
// flip the sign of an exactly-zero update, and a select on every cell's
// read cost the sweeps 5-20%
template <int OP, typename T>
__device__ __forceinline__ T mirror(T g, T val) {
  if constexpr (OP == OP_CONST) {
    return g == T(0) ? T(0) : g * val;
  } else {
    return g * val;
  }
}

// write interior cell (i, j) and every ghost cell that mirrors it
template <int OP, typename T>
__device__ __forceinline__ void put(T* v, const Lev<T>& L, int i, int j,
                                    T val) {
  const int q = L.q;
  v[i * q + j] = val;
  const bool xl = i == L.sxl, xh = i == L.sxh;
  const bool yl = j == L.syl, yh = j == L.syh;
  auto gh = [](T g, T x) { return mirror<OP>(g, x); };
  if (xl) v[j] = gh(L.gxl, val);
  if (xh) v[(q - 1) * q + j] = gh(L.gxh, val);
  if (yl) v[i * q] = gh(L.gyl, val);
  if (yh) v[i * q + q - 1] = gh(L.gyh, val);
  if (xl && yl) v[0] = gh(L.gyl, gh(L.gxl, val));
  if (xl && yh) v[q - 1] = gh(L.gyh, gh(L.gxl, val));
  if (xh && yl) v[(q - 1) * q] = gh(L.gyl, gh(L.gxh, val));
  if (xh && yh) v[(q - 1) * q + q - 1] = gh(L.gyh, gh(L.gxh, val));
}

// the factor-2 average of the residual over the four children of coarse
// frame cell (I, J)
template <int OP, typename T>
__device__ __forceinline__ T restricted(const T* v, const T* f,
                                        const Lev<T>& L, T alpha, T beta,
                                        int I, int J) {
  return restrict4<OP>(v, f, L, alpha, beta, (2 * I - 1) * L.q + 2 * J - 1);
}

// -- mg_down and mg_up: tiles with deep halos ---------------------------------
//
// Ordinary launches with no grid-wide barrier: each block owns a tile of
// the level's interior and runs a round of sweeps on a box of the tile and
// a halo in shared memory (temporal blocking).  The halo is as deep as the
// round's sweeps reach, one cell a half-sweep, plus one for the residual;
// the prolongation reads the coarse frame where each box cell lies, so it
// needs no halo of its own.  mg_kernel.tile_plan picks the tile,
// the halo and the rounds (several launches when a halo for all nsmooth
// iterations would not fit the shared memory; one at the solvers'
// nsmooth).

// the block of the tiled kernels with boxes in shared memory: TILE_X
// threads (threadIdx.x) along a row's cells of a colour, the plan's
// threads / TILE_X (threadIdx.y) over the rows, at most TILE_THREADS
// threads
constexpr int TILE_X = 32, TILE_THREADS = 512;

// the constant operator's register-resident tiled kernels (mg_tiles.cuh
// RegCells): the rows of the box each thread holds in registers, the
// block's most threads and the blocks an SM the kernels are built for
// (launch bounds).
// mg_kernel.TILE_ROWS, TILE_THREADS and TILE_SM_BLOCKS hold the same
// numbers
template <typename T>
struct RegTile;
template <>
struct RegTile<float> {
  static constexpr int ROWS = 10, THREADS = 608, BLOCKS = 2;
};
template <>
struct RegTile<double> {
  static constexpr int ROWS = 6, THREADS = 960, BLOCKS = 1;
};


// the launch plan of mg_kernel.tile_plan: the owned tile's side, the halo,
// the rounds and the iterations of a full round, the block's threads, its
// shared memory (bytes: the register-resident kernels' slots of v and f
// for each thread, else the boxes of v and f), the tiles along a side and
// the rows of the box a thread holds (RegTile's for the register-resident
// kernels; 0 for tile_smooth's, which keep v in shared memory)
struct TilePlan {
  int tile, halo, rounds, iters, threads, smem, tiles, rows;
};

constexpr int TILE_PLAN_INTS = 8;

// the ghosts of frame r that mirror interior cell (i, j), set to zero
template <typename T>
__device__ __forceinline__ void zero_ghosts(T* r, const Lev<T>& L, int i,
                                            int j) {
  const int q = L.q;
  const bool xl = i == L.sxl, xh = i == L.sxh;
  const bool yl = j == L.syl, yh = j == L.syh;
  if (xl) r[j] = T(0);
  if (xh) r[(q - 1) * q + j] = T(0);
  if (yl) r[i * q] = T(0);
  if (yh) r[i * q + q - 1] = T(0);
  if (xl && yl) r[0] = T(0);
  if (xl && yh) r[q - 1] = T(0);
  if (xh && yl) r[(q - 1) * q] = T(0);
  if (xh && yh) r[(q - 1) * q + q - 1] = T(0);
}

// the arguments of one round of a tiled kernel
template <typename T>
struct TileArgs {
  const T* src;  // the round's input v: the caller's (first round; for
                 // mg_down nullptr is a zero guess), else the last round's
                 // output
  const T* f;
  const T* vc;   // mg_up: the coarse correction, ghosts filled (first
                 // round), or nullptr
  T* dst;        // this round's output, ghosts filled
  T* r;          // mg_up: the residual (last round, finest level); mg_down:
                 // the restricted residual on the coarse frame (last
                 // round); or nullptr
  Lev<T> L;
  T alpha, beta;
  int iters;     // red-black iterations of this round
  int tile, halo;
  bool px, py;   // periodic x edges, y edges
};

// the box of the block's tile (blockIdx.y, blockIdx.x) and its halo
template <typename T>
__device__ __forceinline__ LevelBox tile_box(const TileArgs<T>& a) {
  return LevelBox{1 + (int)blockIdx.y * a.tile - a.halo,
                  1 + (int)blockIdx.x * a.tile - a.halo,
                  a.tile + 2 * a.halo, a.L.n, a.px, a.py};
}

// fn(slot index m, extended i, j) for each of the thread's cells in the
// tile (cell (k, side) at m = 2 k + side of its slots), one at a time
template <typename T, int R, typename F>
__device__ __forceinline__ void tile_cells(const TileArgs<T>& a,
                                           const LevelBox& t,
                                           const RegPlace& o, F fn) {
  const int ti = t.ei + a.halo, tj = t.ej + a.halo;
#pragma unroll 1
  for (int m = 0; m < 2 * R; ++m) {
    const int i = t.ei + o.r0 + (m >> 1), j = t.ej + o.c0 + (m & 1);
    if (i >= ti && i < ti + a.tile && j >= tj && j < tj + a.tile)
      fn(m, i, j);
  }
}

// the residual of the thread's cell at extended (i, j), slot index m: v
// and its neighbours from the box b, f from the thread's slot
template <int OP, typename T>
__device__ __forceinline__ T tile_resid(const TileArgs<T>& a,
                                        const LevelBox& t, const RegPlace& o,
                                        const T* b, int m, int i, int j) {
  const int at = t.at(i, j);
  const T v0 = b[at];
  const Nbrs<T> v = t.nbrs(b, a.L, at, i, j, v0);
  return resid_val<OP>(v0, v.xp, v.xm, v.yp, v.ym, b[o.own + o.f + m], a.L,
                       a.alpha, a.beta, i * a.L.q + j);
}

// the residual of the tile's cells restricted to its tile / 2 coarse cells
// a side (the four children in restrict4's order, res(i, j) the residual
// of tile cell (i, j)) with the coarse frame's zero ghosts beside them on
// the level's edge, by the block's threads.  A tile starts at an odd index
// and is even, so its coarse cells' children are its own cells
template <typename T, typename Res>
__device__ __forceinline__ void restrict_tile(const TileArgs<T>& a,
                                              const LevelBox& t, Res res) {
  const int ti = t.ei + a.halo, tj = t.ej + a.halo;
  const int nc = a.L.n / 2, qc = nc + 2, h = a.tile / 2;
  const int I0 = (ti + 1) / 2, J0 = (tj + 1) / 2;
  const int R0 = blockIdx.y == 0 ? 0 : I0;
  const int R1 = blockIdx.y == gridDim.y - 1 ? qc : I0 + h;
  const int C0 = blockIdx.x == 0 ? 0 : J0;
  const int C1 = blockIdx.x == gridDim.x - 1 ? qc : J0 + h;
  const int nj = C1 - C0;
  for (int k = threadIdx.x; k < (R1 - R0) * nj; k += blockDim.x) {
    const int I = R0 + k / nj, J = C0 + k % nj;
    T val = T(0);
    if (I >= 1 && I <= nc && J >= 1 && J <= nc) {
      const int i = 2 * I - 1, j = 2 * J - 1;
      val = T(0.25) * (((res(i, j) + res(i + 1, j)) + res(i, j + 1)) +
                       res(i + 1, j + 1));
    }
    a.r[I * qc + J] = val;
  }
}

// write the tile's cells from the box b into the round's output, with the
// ghosts that mirror them (`put`), by the block's threads
template <int OP, typename T>
__device__ __forceinline__ void put_tile(const TileArgs<T>& a,
                                         const LevelBox& t, const T* b) {
  const int ti = t.ei + a.halo, tj = t.ej + a.halo;
  const int lt = __ffs(a.tile) - 1;  // the tile is a power of 2
  for (int k = threadIdx.x; k < a.tile * a.tile; k += blockDim.x) {
    const int i = ti + (k >> lt), j = tj + (k & (a.tile - 1));
    put<OP>(a.dst, a.L, i, j, b[t.at(i, j)]);
  }
}

// mg_down's round with the constant operator's cells in registers
// (reg_smooth)
template <typename T>
__device__ __forceinline__ void down_regs(const TileArgs<T>& a, T* b,
                                          const LevelBox& t) {
  constexpr int OP = OP_CONST;
  const Lev<T>& L = a.L;
  constexpr int R = RegTile<T>::ROWS;
  const RegPlace o = reg_place<R>(t);
  RegCells<T, R> c;
  reg_load(c, b, t, o, L.q, a.src, a.f,
           [](T v, int, int) { return v; });
  reg_smooth<OP>(c, b, t, L, o, 2 * a.iters);
  reg_store(c, b, t, o);
  put_tile<OP>(a, t, b);
  if (!a.r) return;
  // each tile cell's residual, over its f in the thread's slot, then
  // over its v in the box once every thread has read the box
  tile_cells<T, R>(a, t, o, [&](int m, int i, int j) {
    b[o.own + o.f + m] = tile_resid<OP>(a, t, o, b, m, i, j);
  });
  __syncthreads();
  tile_cells<T, R>(a, t, o, [&](int m, int i, int j) {
    b[t.at(i, j)] = b[o.own + o.f + m];
  });
  __syncthreads();
  restrict_tile(a, t, [&](int i, int j) { return b[t.at(i, j)]; });
}

// mg_up's round with the constant operator's cells in registers
// (reg_smooth)
template <typename T>
__device__ __forceinline__ void up_regs(const TileArgs<T>& a, T* b,
                                        const LevelBox& t) {
  constexpr int OP = OP_CONST;
  const Lev<T>& L = a.L;
  const int q = L.q, qc = L.n / 2 + 2;
  constexpr int R = RegTile<T>::ROWS;
  const RegPlace o = reg_place<R>(t);
  RegCells<T, R> c;
  reg_load(c, b, t, o, q, a.src, a.f, [&](T v, int it, int jt) {
    return a.vc ? v + prolong(a.vc, qc, it, jt) : v;
  });
  reg_smooth<OP>(c, b, t, L, o, 2 * a.iters);
  reg_store(c, b, t, o);
  put_tile<OP>(a, t, b);
  if (!a.r) return;
  tile_cells<T, R>(a, t, o, [&](int m, int i, int j) {
    a.r[i * q + j] = tile_resid<OP>(a, t, o, b, m, i, j);
    zero_ghosts(a.r, L, i, j);
  });
}

// one round of mg_down on the tile (blockIdx.y, blockIdx.x): load the
// boxes of v (zero for a zero guess) and f, smooth, write the tile's cells
// with the ghosts that mirror them (`put`) and, in the last round, the
// residual of the tile's cells restricted to its tile / 2 coarse cells a
// side (the four children in restrict4's order) with the coarse frame's
// zero ghosts beside them on the level's edge.  A tile starts at an odd
// index and is even, so its coarse cells' children are its own cells, and
// the halo leaves the ring around them exact for the residual
template <int OP, typename T>
__global__ void __launch_bounds__(TILE_THREADS) k_down(TileArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b = reinterpret_cast<T*>(smem_raw);
  const Lev<T>& L = a.L;
  const LevelBox t = tile_box(a);
  T* fb = b + t.w * t.w;
  load_box(b, fb, t, L.q, a.f,
           [&](int c, int, int) { return a.src ? a.src[c] : T(0); });
  tile_smooth<OP>(b, fb, t, L, 2 * a.iters, 0, AllCells{});

  const int ti = t.ei + a.halo, tj = t.ej + a.halo;
  for (int i = ti + (int)threadIdx.y; i < ti + a.tile; i += blockDim.y)
    for (int j = tj + (int)threadIdx.x; j < tj + a.tile; j += blockDim.x)
      put<OP>(a.dst, L, i, j, b[t.at(i, j)]);
  if (!a.r) return;

  // the residual of tile cell (i, j) from the box
  auto res = [&](int i, int j) {
    const int o = t.at(i, j);
    const T v0 = b[o];
    const Nbrs<T> v = t.nbrs(b, L, o, i, j, v0);
    return resid_val<OP>(v0, v.xp, v.xm, v.yp, v.ym, fb[o], L, a.alpha,
                         a.beta, i * L.q + j);
  };
  // this block's rows and columns of the coarse frame: its tile's coarse
  // cells, and the ghosts beside them on the level's edge
  const int nc = L.n / 2, qc = nc + 2, h = a.tile / 2;
  const int I0 = (ti + 1) / 2, J0 = (tj + 1) / 2;
  const int R0 = blockIdx.y == 0 ? 0 : I0;
  const int R1 = blockIdx.y == gridDim.y - 1 ? qc : I0 + h;
  const int C0 = blockIdx.x == 0 ? 0 : J0;
  const int C1 = blockIdx.x == gridDim.x - 1 ? qc : J0 + h;
  for (int I = R0 + (int)threadIdx.y; I < R1; I += blockDim.y) {
    for (int J = C0 + (int)threadIdx.x; J < C1; J += blockDim.x) {
      T val = T(0);
      if (I >= 1 && I <= nc && J >= 1 && J <= nc) {
        const int i = 2 * I - 1, j = 2 * J - 1;
        val = T(0.25) * (((res(i, j) + res(i + 1, j)) + res(i, j + 1)) +
                         res(i + 1, j + 1));
      }
      a.r[I * qc + J] = val;
    }
  }
}

// one round of mg_up on the tile (blockIdx.y, blockIdx.x): load the boxes
// of v (the guess plus the prolonged correction in the first round) and f,
// smooth, write the tile's cells with the ghosts that mirror them (`put`)
// and, in the last round of the finest level, the residual
template <int OP, typename T>
__global__ void __launch_bounds__(TILE_THREADS) k_up(TileArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b = reinterpret_cast<T*>(smem_raw);
  const Lev<T>& L = a.L;
  const int q = L.q, qc = L.n / 2 + 2;
  const LevelBox t = tile_box(a);
  T* fb = b + t.w * t.w;
  load_box(b, fb, t, q, a.f, [&](int c, int it, int jt) {
    return a.vc ? a.src[c] + prolong(a.vc, qc, it, jt) : a.src[c];
  });
  tile_smooth<OP>(b, fb, t, L, 2 * a.iters, 0, AllCells{});

  const int ti = t.ei + a.halo, tj = t.ej + a.halo;
  for (int i = ti + (int)threadIdx.y; i < ti + a.tile; i += blockDim.y) {
    for (int j = tj + (int)threadIdx.x; j < tj + a.tile; j += blockDim.x) {
      const int o = t.at(i, j);
      const T v0 = b[o];
      put<OP>(a.dst, L, i, j, v0);
      if (a.r) {
        const Nbrs<T> v = t.nbrs(b, L, o, i, j, v0);
        a.r[i * q + j] = resid_val<OP>(v0, v.xp, v.xm, v.yp, v.ym, fb[o], L,
                                       a.alpha, a.beta, i * q + j);
        zero_ghosts(a.r, L, i, j);
      }
    }
  }
}

// the arguments of a round of the constant operator's register-resident
// kernels: a round's (their own type, so that the kernels overload k_down
// and k_up by it)
template <typename T>
struct RegArgs {
  TileArgs<T> a;
};

// one round of mg_down of the constant operator's register-resident tiles
// (mg_kernel.tile_plan: the 64^2 tiles), as k_down<OP_CONST, T>
template <typename T>
__global__ void __launch_bounds__(RegTile<T>::THREADS, RegTile<T>::BLOCKS)
    k_down(RegArgs<T> r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  down_regs(r.a, reinterpret_cast<T*>(smem_raw), tile_box(r.a));
}

// one round of mg_up, the same way
template <typename T>
__global__ void __launch_bounds__(RegTile<T>::THREADS, RegTile<T>::BLOCKS)
    k_up(RegArgs<T> r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  up_regs(r.a, reinterpret_cast<T*>(smem_raw), tile_box(r.a));
}

// -- mg_core ------------------------------------------------------------------

template <typename T>
struct CoreArgs {
  const T* v;  // the guess of level top, or nullptr for zero
  const T* f;
  T* vo;
  T* r;        // the residual of level top, or nullptr
  Lev<T> lev[MAXLEV];
  int warps[MAXLEV];  // the warps that run each level (a power of 2)
  int off[MAXLEV];    // where v of each level starts in shared memory
  T alpha, beta;
  int top, nsmooth, nsmooth_bottom;
  int ctas;  // the cluster: levels dist.. top are spread over its CTAs
  int dist;
};

// the barrier of the first `warps` warps of the block: one warp syncs
// itself, the whole block __syncthreads(), a prefix of 2..16 warps the
// named barrier log2(warps) (ids 1..4; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int warps) {
  if (warps == 1) {
    __syncwarp();
  } else if (32 * warps >= (int)blockDim.x) {
    __syncthreads();
  } else {
#if defined(__CUDA_ARCH__)
    asm volatile("bar.sync %0, %1;" ::"r"(__ffs(warps) - 1), "r"(32 * warps)
                 : "memory");
#endif
  }
}

// nsmooth red-black iterations of core level l (n = 2^(l+1) cells a side)
// in place, by the group's threads t0 = 0 .. nt - 1: the k-th cell of a
// colour is in interior row k >> l (h = 2^l cells of a colour a row), at
// column 2 (k & (h - 1)) plus the colour's parity of that row.  The sweep
// writes interior cells only: a neighbour across the edge is read as the
// ghost holds it, the sign times the interior cell it mirrors (which is
// the cell itself or one of the other colour, as for `put`), so no lane
// branches to write ghosts; fill_ghosts brings them up to date before
// anything reads them
template <int OP, typename T>
__device__ void smooth_core(T* v, const T* f, const Lev<T>& L, int l,
                            int nsmooth, int t0, int nt, int warps) {
  const int half = 1 << (2 * l + 1);
  const int hmask = (1 << l) - 1;
  const int n = L.n, q = L.q;
  for (int it = 0; it < nsmooth; ++it) {
    for (int color = 0; color < 2; ++color) {
      for (int k = t0; k < half; k += nt) {
        const int ii = k >> l;
        const int i = ii + 1;
        const int j = 2 * (k & hmask) + ((ii + color) & 1) + 1;
        const int c = i * q + j;
        const T xm = i == 1 ? L.gxl * v[L.sxl * q + j] : v[c - q];
        const T xp = i == n ? L.gxh * v[L.sxh * q + j] : v[c + q];
        const T ym = j == 1 ? L.gyl * v[i * q + L.syl] : v[c - 1];
        const T yp = j == n ? L.gyh * v[i * q + L.syh] : v[c + 1];
        v[c] = gs_of<OP>(xp, xm, yp, ym, f, L, c);
      }
      group_sync(warps);
    }
  }
}

// every ghost of core level l from the interior cell it mirrors, as `put`
// writes them: the four edges, then the corners from the x-filled rows
template <int OP, typename T>
__device__ void fill_ghosts(T* v, const Lev<T>& L, int l, int t0, int nt) {
  const int n = L.n, q = L.q;
  auto gh = [](T g, T x) { return mirror<OP>(g, x); };
  for (int k = t0; k < 4 * n + 4; k += nt) {
    const int e = k >> (l + 1), m = (k & (n - 1)) + 1;
    if (e == 0) v[m] = gh(L.gxl, v[L.sxl * q + m]);
    else if (e == 1) v[(q - 1) * q + m] = gh(L.gxh, v[L.sxh * q + m]);
    else if (e == 2) v[m * q] = gh(L.gyl, v[m * q + L.syl]);
    else if (e == 3) v[m * q + q - 1] = gh(L.gyh, v[m * q + L.syh]);
    else if (k == 4 * n) v[0] = gh(L.gyl, gh(L.gxl, v[L.sxl * q + L.syl]));
    else if (k == 4 * n + 1)
      v[q - 1] = gh(L.gyh, gh(L.gxl, v[L.sxl * q + L.syh]));
    else if (k == 4 * n + 2)
      v[(q - 1) * q] = gh(L.gyl, gh(L.gxh, v[L.sxh * q + L.syl]));
    else
      v[(q - 1) * q + q - 1] = gh(L.gyh, gh(L.gxh, v[L.sxh * q + L.syh]));
  }
}

// a level spread over the cluster: this CTA's interior rows lo .. lo + R - 1
// and the frames of the CTAs holding the rows beside them (up: lo - 1,
// down: lo + R) and the interior rows the x ghosts mirror (sl: row sxl,
// sh: row sxh), own frame where this CTA holds them
template <typename T>
struct Slab {
  int lo, R;
  const T *up, *down, *sl, *sh;
  bool first, last;
};

// nsmooth red-black iterations of a spread level l, all threads of every
// CTA of the cluster, a cluster barrier after each half-sweep; as
// smooth_core, with the rows beside the slab read from the CTAs that hold
// them (distributed shared memory)
template <int OP, typename T, typename Cluster>
__device__ void smooth_dist(T* v, const T* f, const Lev<T>& L, int l,
                            const Slab<T>& s, int nsmooth, int t0, int nt,
                            Cluster& cl) {
  const int hmask = (1 << l) - 1;
  const int n = L.n, q = L.q;
  const int cells = s.R << l;          // R rows of 2^l cells of a colour
  for (int it = 0; it < nsmooth; ++it) {
    for (int color = 0; color < 2; ++color) {
      for (int k = t0; k < cells; k += nt) {
        const int i = s.lo + (k >> l);
        const int j = 2 * (k & hmask) + ((i - 1 + color) & 1) + 1;
        const int c = i * q + j;
        T xm, xp;
        if (i == 1)
          xm = L.gxl * s.sl[L.sxl * q + j];
        else if (i == s.lo)
          xm = s.up[c - q];
        else
          xm = v[c - q];
        if (i == n)
          xp = L.gxh * s.sh[L.sxh * q + j];
        else if (i == s.lo + s.R - 1)
          xp = s.down[c + q];
        else
          xp = v[c + q];
        const T ym = j == 1 ? L.gyl * v[i * q + L.syl] : v[c - 1];
        const T yp = j == n ? L.gyh * v[i * q + L.syh] : v[c + 1];
        v[c] = gs_of<OP>(xp, xm, yp, ym, f, L, c);
      }
      cl.sync();
    }
  }
}

// the rows of a spread level this CTA reads besides its own, after its
// sweeps: the halo rows from the CTAs beside it, the x-ghost rows of the
// frame's edges from the rows they mirror, then the y ghosts of every row
// it holds (put's rule, corners included)
template <int OP, typename T>
__device__ void fill_dist(T* v, const Lev<T>& L, const Slab<T>& s, int t0,
                          int nt) {
  const int n = L.n, q = L.q;
  for (int k = t0; k < 2 * n; k += nt) {
    const int j = (k < n ? k : k - n) + 1;
    if (k < n) {
      if (s.first) {
        v[j] = mirror<OP>(L.gxl, s.sl[L.sxl * q + j]);
      } else {
        const int c = (s.lo - 1) * q + j;
        v[c] = s.up[c];
      }
    } else {
      if (s.last) {
        v[(q - 1) * q + j] = mirror<OP>(L.gxh, s.sh[L.sxh * q + j]);
      } else {
        const int c = (s.lo + s.R) * q + j;
        v[c] = s.down[c];
      }
    }
  }
  __syncthreads();
  const int r0 = s.first ? 0 : s.lo - 1, r1 = s.last ? q - 1 : s.lo + s.R;
  for (int i = r0 + t0; i <= r1; i += nt) {
    v[i * q] = mirror<OP>(L.gyl, v[i * q + L.syl]);
    v[i * q + q - 1] = mirror<OP>(L.gyh, v[i * q + L.syh]);
  }
  __syncthreads();
}

template <int OP, typename T>
__global__ void __launch_bounds__(CORE_THREADS) k_core(CoreArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, nb = blockDim.x;
  const int top = a.top;
  // the threads of level l's group on CTA 0
  auto group = [&](int l) { return min(32 * a.warps[l], nb); };
  // frame p of CTA r: own shared memory, or the cluster's window onto r's
  auto at = [&](T* p, int r) -> const T* {
    return r == rank ? p : cl.map_shared_rank(p, r);
  };
  // this CTA's rows of spread level l
  auto slab = [&](int l) {
    const Lev<T>& L = a.lev[l];
    T* V = base + a.off[l];
    const int R = L.n / a.ctas;
    return Slab<T>{1 + rank * R, R,
                   at(V, rank > 0 ? rank - 1 : rank),
                   at(V, rank < a.ctas - 1 ? rank + 1 : rank),
                   at(V, (L.sxl - 1) / R), at(V, (L.sxh - 1) / R),
                   rank == 0, rank == a.ctas - 1};
  };

  {
    const Lev<T>& L = a.lev[top];
    T* V = base + a.off[top];
    T* F = V + L.q * L.q;
    if (top >= a.dist) {
      const Slab<T> s = slab(top);
      for (int k = tid; k < s.R * L.n; k += nb) {
        const int i = s.lo + (k >> (top + 1)), j = (k & (L.n - 1)) + 1;
        const int c = i * L.q + j;
        F[c] = a.f[c];
        put<OP>(V, L, i, j, a.v ? a.v[c] : T(0));
      }
      cl.sync();
    } else if (rank == 0 && tid < group(top)) {
      for (int k = tid; k < L.n * L.n; k += group(top)) {
        const int i = (k >> (top + 1)) + 1, j = (k & (L.n - 1)) + 1;
        const int c = i * L.q + j;
        F[c] = a.f[c];
        put<OP>(V, L, i, j, a.v ? a.v[c] : T(0));
      }
      group_sync(a.warps[top]);
    }
  }
  // descent: smooth, then restrict the residual into the next coarser f,
  // whose guess is zero (ghosts included).  A spread level restricts its
  // rows into its own coarse rows, or into CTA 0's frame below the spread
  // levels; below them CTA 0 runs alone, each level's group a prefix of
  // the one before
  for (int l = top; l >= 1; --l) {
    const Lev<T>& L = a.lev[l];
    const Lev<T>& C = a.lev[l - 1];
    T* V = base + a.off[l];
    T* F = V + L.q * L.q;
    T* Vc = base + a.off[l - 1];
    T* Fc = Vc + C.q * C.q;
    if (l >= a.dist) {
      const Slab<T> s = slab(l);
      smooth_dist<OP>(V, F, L, l, s, a.nsmooth, tid, nb, cl);
      fill_dist<OP>(V, L, s, tid, nb);
      if (l - 1 < a.dist) {
        Vc = cl.map_shared_rank(Vc, 0);
        Fc = cl.map_shared_rank(Fc, 0);
      }
      const int I0 = s.first ? 0 : (s.lo + 1) / 2;
      const int I1 = s.last ? C.q : (s.lo + s.R + 1) / 2;
      for (int k = tid; k < (I1 - I0) * C.q; k += nb) {
        const int I = I0 + k / C.q, J = k % C.q, c = I * C.q + J;
        Vc[c] = T(0);
        Fc[c] = (I >= 1 && I <= C.n && J >= 1 && J <= C.n)
                    ? restricted<OP>(V, F, L, a.alpha, a.beta, I, J)
                    : T(0);
      }
      cl.sync();
      continue;
    }
    const int nt = group(l);
    if (rank != 0 || tid >= nt) break;
    smooth_core<OP>(V, F, L, l, a.nsmooth, tid, nt, a.warps[l]);
    fill_ghosts<OP>(V, L, l, tid, nt);
    group_sync(a.warps[l]);
    for (int k = tid; k < C.q * C.q; k += nt) {
      const int I = k / C.q, J = k % C.q;
      Vc[k] = T(0);
      Fc[k] = (I >= 1 && I <= C.n && J >= 1 && J <= C.n)
                  ? restricted<OP>(V, F, L, a.alpha, a.beta, I, J)
                  : T(0);
    }
    group_sync(a.warps[l]);
  }
  if (rank == 0 && tid < group(0)) {
    T* V = base;
    smooth_core<OP>(V, V + a.lev[0].q * a.lev[0].q, a.lev[0], 0,
                    a.nsmooth_bottom, tid, group(0), a.warps[0]);
    fill_ghosts<OP>(V, a.lev[0], 0, tid, group(0));
    group_sync(a.warps[0]);
  }
  // ascent: once the coarser level is done, prolong and correct (the
  // ghosts follow), then smooth; a spread level reads the coarse frame of
  // CTA 0 when the level below is not spread
  for (int l = 1; l <= top; ++l) {
    const Lev<T>& L = a.lev[l];
    T* V = base + a.off[l];
    T* F = V + L.q * L.q;
    T* Vc = base + a.off[l - 1];
    const int qc = a.lev[l - 1].q;
    if (l >= a.dist) {
      const Slab<T> s = slab(l);
      cl.sync();
      const T* src = l - 1 < a.dist ? at(Vc, 0) : Vc;
      for (int k = tid; k < s.R * L.n; k += nb) {
        const int i = s.lo + (k >> (l + 1)), j = (k & (L.n - 1)) + 1;
        put<OP>(V, L, i, j, V[i * L.q + j] + prolong(src, qc, i, j));
      }
      cl.sync();
      smooth_dist<OP>(V, F, L, l, s, a.nsmooth, tid, nb, cl);
      fill_dist<OP>(V, L, s, tid, nb);
      continue;
    }
    const int nt = group(l);
    if (rank != 0 || tid >= nt) continue;
    group_sync(a.warps[l]);
    for (int k = tid; k < L.n * L.n; k += nt) {
      const int i = (k >> (l + 1)) + 1, j = (k & (L.n - 1)) + 1;
      put<OP>(V, L, i, j, V[i * L.q + j] + prolong(Vc, qc, i, j));
    }
    group_sync(a.warps[l]);
    smooth_core<OP>(V, F, L, l, a.nsmooth, tid, nt, a.warps[l]);
    fill_ghosts<OP>(V, L, l, tid, nt);
    group_sync(a.warps[l]);
  }
  // a spread top's last fill_dist reads the rows beside each slab from the
  // CTAs that hold them: no CTA may exit before every one has read them
  if (top >= a.dist) cl.sync();
  // the output: the frame rows this CTA holds (a spread top's rows, with
  // the ghost rows at the frame's edges), or all of them on CTA 0
  const Lev<T>& L = a.lev[top];
  int r0 = 0, r1 = L.q, nt = group(top);
  if (top >= a.dist) {
    const Slab<T> s = slab(top);
    r0 = s.first ? 0 : s.lo;
    r1 = s.last ? L.q : s.lo + s.R;
    nt = nb;
  } else if (rank != 0) {
    return;
  }
  if (tid >= nt) return;
  const T* V = base + a.off[top];
  const T* F = V + L.q * L.q;
  for (int k = r0 * L.q + tid; k < r1 * L.q; k += nt) {
    a.vo[k] = V[k];
    if (a.r) {
      const int i = k / L.q, j = k % L.q;
      a.r[k] = (i >= 1 && i <= L.n && j >= 1 && j <= L.n)
                   ? resid<OP>(V, F, L, a.alpha, a.beta, k)
                   : T(0);
    }
  }
}

// -- launches -------------------------------------------------------------------

bool valid_size(int n) { return n >= 2 && (n & (n - 1)) == 0; }

// the rounds of one mg_down or mg_up call on an n^2 level with
// plan (mg_kernel.tile_plan; see TilePlan) by `kernel` (boxes in shared
// memory) or, for a plan with rows, `regs` (the constant operator's cells
// in registers; nullptr for the coefficient operators), whose
// shared-memory opt-ins so far are opted[0], opted[1]: round k reads src
// (v in the first
// round, else the last round's output) and writes dst, the rounds
// alternating between scratch and vo so that the last one ends in vo; vc
// goes to the first round, r to the last.  scratch may be nullptr with one
// round.  The plan must hold a power-of-2 even tile that divides the
// level, rounds of `iters` iterations (the last one the rest) that take
// nsmooth together, a halo as deep as a round's half-sweeps plus the
// residual, and a box that fits its shared memory
template <typename T>
int tiled(void (*kernel)(TileArgs<T>), void (*regs)(RegArgs<T>),
          int* opted, const T* v, const T* f,
          const T* vc, T* vo, T* r, T* scratch, int n, int nsmooth,
          const int* bc, const double* coef, const double* ab,
          const int* plan, const void* planes, cudaStream_t st) {
  if (!valid_size(n) || n < 4 || nsmooth < 0)
    return (int)cudaErrorInvalidValue;
  // a periodic axis is periodic at both of its edges
  if ((bc[0] == PERIODIC) != (bc[1] == PERIODIC) ||
      (bc[2] == PERIODIC) != (bc[3] == PERIODIC))
    return (int)cudaErrorInvalidValue;
  const TilePlan t{plan[0], plan[1], plan[2], plan[3],
                   plan[4], plan[5], plan[6], plan[7]};
  const int rounds =
      nsmooth == 0 ? 1 : (nsmooth + t.iters - 1) / max(t.iters, 1);
  if (t.tile < 2 || (t.tile & (t.tile - 1)) || t.tile > n ||
      t.tiles * t.tile != n || t.iters < 0 ||
      (nsmooth > 0 && t.iters < 1) || t.rounds != rounds ||
      t.halo < 2 * t.iters + 1 || (rounds > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  const int w = t.tile + 2 * t.halo;
  if (t.smem < 1 || t.threads % 32 || t.threads < TILE_X)
    return (int)cudaErrorInvalidValue;
  if (t.rows == 0) {
    // the boxes of v and f in shared memory
    if (t.threads > TILE_THREADS ||
        (size_t)t.smem < 2 * (size_t)w * w * sizeof(T))
      return (int)cudaErrorInvalidValue;
  } else {
    // the cells in registers: every pair of the box's columns over every
    // run of `rows` rows has its thread, and each thread its slots
    constexpr int R = RegTile<T>::ROWS;
    if (!regs || t.rows != R || t.threads > RegTile<T>::THREADS ||
        t.threads < (w / 2) * ((w + R - 1) / R) ||
        (size_t)t.smem <
            2 * (size_t)t.threads * reg_slot<R>() * sizeof(T))
      return (int)cudaErrorInvalidValue;
  }
  const void* fn = t.rows ? (const void*)regs : (const void*)kernel;
  int& opt = opted[t.rows ? 1 : 0];
  if (t.smem > opt) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
    if (e != cudaSuccess) return (int)e;
    opt = t.smem;
  }
  TileArgs<T> a;
  a.f = f;
  a.L = make_level<T>(n, coef, bc, planes);
  a.alpha = (T)ab[0];
  a.beta = (T)ab[1];
  a.tile = t.tile;
  a.halo = t.halo;
  a.px = bc[0] == PERIODIC;
  a.py = bc[2] == PERIODIC;
  const T* src = v;
  for (int k = 0; k < rounds; ++k) {
    T* dst = round_dst(k, rounds, vo, scratch);
    a.src = src;
    a.vc = k == 0 ? vc : nullptr;
    a.dst = dst;
    a.r = k == rounds - 1 ? r : nullptr;
    a.iters = min(t.iters, nsmooth - k * t.iters);
    const dim3 grid(t.tiles, t.tiles), box(TILE_X, t.threads / TILE_X);
    if (t.rows)
      regs<<<grid, t.threads, t.smem, st>>>(RegArgs<T>{a});
    else
      kernel<<<grid, box, t.smem, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return 0;
}

// mg_down: v nullptr is a zero guess; fc the coarse frame the last round
// restricts the residual into
template <int OP, typename T>
int down(const T* v, const T* f, T* vo, T* fc, T* scratch, int n,
         int nsmooth, const int* bc, const double* coef, const double* ab,
         const int* plan, const void* planes, cudaStream_t st) {
  static int opted[2] = {0, 0};
  void (*regs)(RegArgs<T>) = nullptr;
  if constexpr (OP == OP_CONST) regs = k_down<T>;
  if (OP != OP_CONST && !planes) return (int)cudaErrorInvalidValue;
  return tiled<T>(k_down<OP, T>, regs, opted, v, f, nullptr, vo, fc,
                  scratch, n, nsmooth, bc, coef, ab, plan, planes, st);
}

// mg_up: vc the coarse correction; r the residual (nullptr: none)
template <int OP, typename T>
int up(const T* v, const T* f, const T* vc, T* vo, T* r, T* scratch, int n,
       int nsmooth, const int* bc, const double* coef, const double* ab,
       const int* plan, const void* planes, cudaStream_t st) {
  static int opted[2] = {0, 0};
  void (*regs)(RegArgs<T>) = nullptr;
  if constexpr (OP == OP_CONST) regs = k_up<T>;
  if (OP != OP_CONST && !planes) return (int)cudaErrorInvalidValue;
  return tiled<T>(k_up<OP, T>, regs, opted, v, f, vc, vo, r, scratch, n,
                  nsmooth, bc, coef, ab, plan, planes, st);
}

// planes: one plane-stack pointer per level 0..top (nullptr for OP_CONST);
// schedule (mg_kernel.core_plan): the warps of each level 0..top, powers
// of 2 up to the block's, never fewer than the next coarser level's; then
// the cluster's CTAs (1, or CORE_CTAS) and the first level spread over them
// (top + 1: none; each spread level at least 2 rows a CTA); then where v of
// each level 0..top starts in shared memory and where the layout ends, in
// elements of T (v then f of each one-ghost level frame)
template <int OP, typename T>
int core(const T* v, const T* f, T* vo, T* r, int top, int nsmooth,
         int nsmooth_bottom, const int* bc, const double* coef,
         const double* ab, const int* schedule, const void* const* planes,
         cudaStream_t st) {
  static int optin = -1;
  if (top < 0 || top >= MAXLEV || nsmooth < 0 || nsmooth_bottom < 0 ||
      (OP != OP_CONST && !planes))
    return (int)cudaErrorInvalidValue;
  const int* warps = schedule;
  const int ctas = schedule[top + 1], dist = schedule[top + 2];
  const int* off = schedule + top + 3;
  for (int l = 0; l <= top; ++l) {
    const int w = warps[l];
    if (w < 1 || 32 * w > CORE_THREADS || (w & (w - 1)) ||
        (l > 0 && w < warps[l - 1]))
      return (int)cudaErrorInvalidValue;
  }
  if ((ctas != 1 && ctas != CORE_CTAS) || dist < 1 || dist > top + 1 ||
      (ctas > 1) != (dist <= top) || (dist <= top && (2 << dist) < 2 * ctas))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= top; ++l) {
    const int q = (2 << l) + 2;
    if (off[0] != 0 || off[l + 1] < off[l] + 2 * q * q)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)off[top + 1] * sizeof(T);
  if (optin < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncSetAttribute((const void*)k_core<OP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin) != cudaSuccess) {
      optin = -1;
      return (int)cudaGetLastError();
    }
  }
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  CoreArgs<T> a;
  a.v = v;
  a.f = f;
  a.vo = vo;
  a.r = r;
  for (int l = 0; l <= top; ++l) {
    a.lev[l] = make_level<T>(2 << l, coef + 5 * l, bc,
                             planes ? planes[l] : nullptr);
    a.warps[l] = warps[l];
    a.off[l] = off[l];
  }
  a.ctas = ctas;
  a.dist = dist;
  a.alpha = (T)ab[0];
  a.beta = (T)ab[1];
  a.top = top;
  a.nsmooth = nsmooth;
  a.nsmooth_bottom = nsmooth_bottom;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(32 * warps[top]);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, k_core<OP, T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// the constant-coefficient entries: mg_core_f32, mg_down_f64, ...
#define CONST_ENTRIES(T, SFX)                                                 \
  extern "C" int mg_core_##SFX(const T* v, const T* f, T* vo, T* r, int top,  \
                               int nsmooth, int nsmooth_bottom,               \
                               const int* bc, const double* coef,             \
                               const double* ab, const int* schedule,         \
                               void* stream) {                                \
    return core<OP_CONST, T>(v, f, vo, r, top, nsmooth, nsmooth_bottom, bc,   \
                             coef, ab, schedule, nullptr,                   \
                             (cudaStream_t)stream);                           \
  }                                                                           \
  extern "C" int mg_down_##SFX(const T* v, const T* f, T* vo, T* fc,         \
                               T* scratch, int n, int nsmooth,                \
                               const int* bc, const double* coef,             \
                               const double* ab, const int* plan,             \
                               void* stream) {                                \
    return down<OP_CONST, T>(v, f, vo, fc, scratch, n, nsmooth, bc, coef, ab, \
                             plan, nullptr, (cudaStream_t)stream);            \
  }                                                                           \
  extern "C" int mg_up_##SFX(const T* v, const T* f, const T* vc, T* vo,      \
                             T* r, T* scratch, int n, int nsmooth,            \
                             const int* bc, const double* coef,               \
                             const double* ab, const int* plan,               \
                             void* stream) {                                  \
    return up<OP_CONST, T>(v, f, vc, vo, r, scratch, n, nsmooth, bc, coef,    \
                           ab, plan, nullptr, (cudaStream_t)stream);          \
  }

// the coefficient entries (mg_core_vc_f32, mg_up_general_f64, ...): the
// same arguments and the level's plane stack (per core level for the core)
#define COEF_ENTRIES(OP, NAME, T, SFX)                                        \
  extern "C" int mg_core_##NAME##_##SFX(                                      \
      const T* v, const T* f, T* vo, T* r, int top, int nsmooth,              \
      int nsmooth_bottom, const int* bc, const double* coef,                  \
      const double* ab, const int* schedule, const void* const* planes,       \
      void* stream) {                                                         \
    return core<OP, T>(v, f, vo, r, top, nsmooth, nsmooth_bottom, bc, coef,   \
                       ab, schedule, planes, (cudaStream_t)stream);           \
  }                                                                           \
  extern "C" int mg_down_##NAME##_##SFX(                                      \
      const T* v, const T* f, T* vo, T* fc, T* scratch, int n, int nsmooth,   \
      const int* bc, const double* coef, const double* ab, const int* plan,   \
      const void* planes, void* stream) {                                     \
    return down<OP, T>(v, f, vo, fc, scratch, n, nsmooth, bc, coef, ab, plan, \
                       planes, (cudaStream_t)stream);                         \
  }                                                                           \
  extern "C" int mg_up_##NAME##_##SFX(                                        \
      const T* v, const T* f, const T* vc, T* vo, T* r, T* scratch, int n,    \
      int nsmooth, const int* bc, const double* coef, const double* ab,       \
      const int* plan, const void* planes, void* stream) {                    \
    return up<OP, T>(v, f, vc, vo, r, scratch, n, nsmooth, bc, coef, ab,      \
                     plan, planes, (cudaStream_t)stream);                     \
  }

// the length of the plan array the mg_down and mg_up entries take
// (mg_kernel.tile_plan)
extern "C" int mg_tile_plan_ints() { return TILE_PLAN_INTS; }

CONST_ENTRIES(float, f32)
CONST_ENTRIES(double, f64)
COEF_ENTRIES(OP_VC, vc, float, f32)
COEF_ENTRIES(OP_VC, vc, double, f64)
COEF_ENTRIES(OP_GENERAL, general, float, f32)
COEF_ENTRIES(OP_GENERAL, general, double, f64)
