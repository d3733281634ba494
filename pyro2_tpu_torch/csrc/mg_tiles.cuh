// mg_tiles.cuh -- the tiles with deep halos that the multigrid smoothers
// run their sweeps on: mg_vcycle.cu's descent and ascent (k_down, k_up) on
// a square one-ghost level, and mg_deep.cu's deep smoothing round (k_deep)
// on a block's rectangular deep frame.
//
// A block owns a tile and sweeps a box of the tile and a halo, indexed by
// "extended" indices along each axis (LevelBox for a level, FrameBox for a
// deep frame): the frame's own indices, and beyond the frame, on a
// periodic axis whose ghosts mirror the opposite side, the frame's cells
// wrapped around.  Half-sweep s of a round may update a cell of the box
// only where it is still exact: s cells inside a box edge that has cells
// beyond it that the box does not hold (an "exposed" edge), or up to an
// edge beyond which nothing changes.  The halo is as deep as the round's
// sweeps reach plus one, so the tile and the ring around it are exact at
// the end.  A ghost that mirrors the cell beside it (sign times that cell)
// is never read from the box: a sweep reads it as its mirror (nbrs).
//
// Two smoothers share these boxes:
//   * tile_smooth holds the box of v with f's beside it in shared memory,
//     each cell update reading its neighbours and f there (k_deep, and
//     k_down and k_up of the coefficient operators and of the constant
//     operator's tiles below 64^2);
//   * reg_smooth (the constant operator's 64^2 tiles: k_down and k_up on
//     RegArgs) cuts the box among the block's threads, each keeping its
//     own cells' v in registers for the whole round; shared memory holds
//     only what threads exchange, and f, each thread's in a slot of its
//     own (below).
//
// Each cell's arithmetic is the untiled sweep's (mg_ops.cuh), so the exact
// cells of a box hold the untiled sweep's bits whichever smoother runs.

#pragma once

#include <limits.h>

#include <type_traits>
#include <utility>

#include "mg_ops.cuh"

namespace {

// the neighbours of a box cell: below and above along x (rows), along y
// (columns)
template <typename T>
struct Nbrs {
  T xm, xp, ym, yp;
};

// The box of a tile on a square one-ghost level of n^2 cells (mg_vcycle.cu),
// row-major: along each axis the extended interior indices e0 .. e0 + w -
// 1 (1 .. n the level's interior; beyond it, on a periodic axis, the
// interior wrapped around, and on any other axis nothing).  Across an edge
// that is not periodic a cell's neighbour is its ghost, which mirrors the
// cell itself (its value times the edge's sign, L.gxl ...).
struct LevelBox {
  int ei, ej, w, n;
  bool px, py;
  // the interior index of extended index e on a periodic axis (n is a
  // power of 2)
  __device__ int wrap(int e) const { return ((e - 1) & (n - 1)) + 1; }
  __device__ int row(int i) const { return px ? wrap(i) : i; }
  __device__ int col(int j) const { return py ? wrap(j) : j; }
  // extended index e held to the level's cells 1 .. n on an axis that is
  // not periodic
  __device__ int clamp(int e, bool per) const {
    return per ? e : min(max(e, 1), n);
  }
  // the first and last extended index of an axis that holds a cell
  __device__ int lo(int e0, bool per) const { return per ? e0 : max(1, e0); }
  __device__ int hi(int e0, bool per) const {
    return per ? e0 + w - 1 : min(n, e0 + w - 1);
  }
  __device__ int row_lo() const { return lo(ei, px); }
  __device__ int row_hi() const { return hi(ei, px); }
  __device__ int col_lo() const { return lo(ej, py); }
  __device__ int col_hi() const { return hi(ej, py); }
  // the first and last index of an axis that half-sweep s (1-based)
  // updates: s cells inside the box's edges, or up to a non-periodic edge
  // of the level, where a cell's outside neighbour is its mirror and so
  // never stale
  __device__ int lo_s(int e0, bool per, int s) const {
    return !per && e0 <= 1 ? 1 : e0 + s;
  }
  __device__ int hi_s(int e0, bool per, int s) const {
    return !per && e0 + w - 1 >= n ? n : e0 + w - 1 - s;
  }
  __device__ int row_lo_s(int s) const { return lo_s(ei, px, s); }
  __device__ int row_hi_s(int s) const { return hi_s(ei, px, s); }
  __device__ int col_lo_s(int s) const { return lo_s(ej, py, s); }
  __device__ int col_hi_s(int s) const { return hi_s(ej, py, s); }
  __device__ int at(int i, int j) const { return (i - ei) * w + (j - ej); }
  // the four neighbours of box cell o at extended (i, j), L the level
  template <typename T, typename Level>
  __device__ __forceinline__ Nbrs<T> nbrs(const T* b, const Level& L, int o,
                                          int i, int j, T v0) const {
    Nbrs<T> v;
    v.xm = !px && i == 1 ? L.gxl * v0 : b[o - w];
    v.xp = !px && i == n ? L.gxh * v0 : b[o + w];
    v.ym = !py && j == 1 ? L.gyl * v0 : b[o - 1];
    v.yp = !py && j == n ? L.gyh * v0 : b[o + 1];
    return v;
  }
};

// one axis of the box of a tile of a rectangular frame (mg_deep.cu): the
// box's memory holds extended indices e0 .. e0 + w - 1; the axis's cells
// are first .. last (beyond them, on a periodic axis, the cells wrapped
// around with period n, a power of 2, the cells 1 .. n); mlo / mhi the
// index whose neighbour below / above is a ghost that mirrors it (INT_MIN
// / INT_MAX: none)
struct BoxAxis {
  int e0, w, first, last, mlo, mhi, n;
  bool per;
  // the cell that extended index e holds (1 .. n on a periodic axis)
  __device__ int wrap(int e) const {
    return per ? ((e - 1) & (n - 1)) + 1 : e;
  }
  // the first and last index of the box that holds a cell
  __device__ int lo() const { return per ? e0 : max(first, e0); }
  __device__ int hi() const {
    return per ? e0 + w - 1 : min(last, e0 + w - 1);
  }
  // the first and last index whose cells are still exact after half-sweep
  // s (1-based): s inside an exposed edge, else the box's cells up to the
  // axis's edge, where a cell reads only cells the box holds or its mirror
  __device__ int lo_s(int s) const {
    return !per && e0 <= first ? lo() : e0 + s;
  }
  __device__ int hi_s(int s) const {
    return !per && e0 + w - 1 >= last ? hi() : e0 + w - 1 - s;
  }
};

// the box of a tile of a frame, row-major, with the interface of LevelBox;
// the signs of the mirrored ghosts are the frame's L.sgn (x-lo, x-hi,
// y-lo, y-hi)
struct FrameBox {
  BoxAxis x, y;
  __device__ int row(int i) const { return x.wrap(i); }
  __device__ int col(int j) const { return y.wrap(j); }
  __device__ int row_lo() const { return x.lo(); }
  __device__ int row_hi() const { return x.hi(); }
  __device__ int col_lo() const { return y.lo(); }
  __device__ int col_hi() const { return y.hi(); }
  __device__ int row_lo_s(int s) const { return x.lo_s(s); }
  __device__ int row_hi_s(int s) const { return x.hi_s(s); }
  __device__ int col_lo_s(int s) const { return y.lo_s(s); }
  __device__ int col_hi_s(int s) const { return y.hi_s(s); }
  __device__ int at(int i, int j) const {
    return (i - x.e0) * y.w + (j - y.e0);
  }
  template <typename T, typename Level>
  __device__ __forceinline__ Nbrs<T> nbrs(const T* b, const Level& L, int o,
                                          int i, int j, T v0) const {
    Nbrs<T> v;
    v.xm = i == x.mlo ? L.sgn[0] * v0 : b[o - y.w];
    v.xp = i == x.mhi ? L.sgn[1] * v0 : b[o + y.w];
    v.ym = j == y.mlo ? L.sgn[2] * v0 : b[o - 1];
    v.yp = j == y.mhi ? L.sgn[3] * v0 : b[o + 1];
    return v;
  }
};

// a rectangle of extended indices (the cells a half-sweep may update)
struct Rect {
  int i0, i1, j0, j1;
};

// every cell: no eligibility beyond the box's exactness
struct AllCells {
  __device__ Rect operator()(int) const {
    return Rect{INT_MIN, INT_MAX, INT_MIN, INT_MAX};
  }
};

// load the boxes of v and f of tile box t (a LevelBox or a FrameBox) by the
// block's threads (threadIdx.x along a row, threadIdx.y over rows): at each
// box cell that holds a cell of the frame (the wrapped cell across a
// periodic edge), v's value is val(frame index, row, column) and f's is
// read at the frame index, q the frame's row stride; a block barrier
// follows
template <typename T, typename Box, typename V>
__device__ __forceinline__ void load_box(T* b, T* fb, const Box& t, int q,
                                         const T* f, V val) {
  const int i1 = t.row_hi(), j1 = t.col_hi();
  for (int i = t.row_lo() + (int)threadIdx.y; i <= i1; i += blockDim.y) {
    const int it = t.row(i);
    for (int j = t.col_lo() + (int)threadIdx.x; j <= j1; j += blockDim.x) {
      const int jt = t.col(j);
      const int c = it * q + jt, o = t.at(i, j);
      b[o] = val(c, it, jt);
      fb[o] = f[c];
    }
  }
  __syncthreads();
}

// `halves` red-black half-sweeps on the box b of a tile in shared memory
// (a LevelBox or a FrameBox), with the right-hand side's box fb beside it,
// by the block's threads (threadIdx.x along a row's cells of the colour,
// threadIdx.y over rows), a block barrier after each.  Half-sweep s
// (1-based) updates the cells of colour (s - 1) & 1 -- red the cells whose
// frame row and column sum to par, mod 2 -- that are still exact (the
// box's lo_s, hi_s) and inside the rectangle elig(s).  Each cell reads f at
// its box cell, the operator's coefficients at its frame index (L.q the
// row stride) and its neighbours as the box's nbrs gives them; on a
// periodic axis the wrapped cells of the box are the neighbours the
// untiled sweep reads through the ghosts (n is even, so a wrapped cell
// keeps its colour).  The colour's first column in a row is found from the
// parity of i + j: no division.
template <int OP, typename T, typename Box, typename Level, typename Elig>
__device__ void tile_smooth(T* b, const T* fb, const Box& t, const Level& L,
                            int halves, int par, Elig elig) {
  const int q = L.q;
  for (int s = 1; s <= halves; ++s) {
    const int color = (s - 1) & 1;
    const Rect r = elig(s);
    const int i0 = max(t.row_lo_s(s), r.i0), i1 = min(t.row_hi_s(s), r.i1);
    const int j0 = max(t.col_lo_s(s), r.j0), j1 = min(t.col_hi_s(s), r.j1);
    for (int i = i0 + (int)threadIdx.y; i <= i1; i += blockDim.y) {
      const int it = t.row(i);
      const int jf = j0 + ((i + j0 + color + par) & 1);
      for (int j = jf + 2 * (int)threadIdx.x; j <= j1; j += 2 * blockDim.x) {
        const int jt = t.col(j);
        const int o = t.at(i, j);
        const T v0 = b[o];
        const Nbrs<T> v = t.nbrs(b, L, o, i, j, v0);
        b[o] = gs_val<OP>(v.xp, v.xm, v.yp, v.ym, fb[o], L, it * q + jt);
      }
    }
    __syncthreads();
  }
}

// -- the register-resident smoother of k_down and k_up (the constant
// operator's 64^2 tiles) ------------------------------------------------------
//
// A block's box of a level (LevelBox) is cut among its threads: thread tid
// owns the pair of box columns c0 = 2 (tid % P), c0 + 1 (P = w / 2 pairs)
// over the rows r0 .. r0 + R - 1 of run tid / P (r0 = R (tid / P), R even;
// rows beyond the box hold nothing).  It keeps v of those cells in
// registers (RegCells) for the whole round.  Shared memory holds, for
// each thread, a slot of 2 R + 1 values for its cells' v -- the exchange
// between threads -- and one for their f: cell (k, side) at 2 k + side, so
// every access is a slot's start and a constant, and the lanes of a warp,
// an odd slot apart, touch distinct banks.  The slots are filled by
// asynchronous copies (cp.async), which hold no register, so all of a
// thread's reads of the frame are in flight at once.
//
// At each row a half-sweep updates exactly one of the pair's cells, the
// one of its colour, so no lane idles.  Of that cell's neighbours, the two
// along x (rows r -+ 1, same column) and one along y (the pair's other
// column) are the thread's own registers; the other along y is the next
// pair's, read from the next lane (__shfl_*_sync).  Only at a run's first
// and last row (along x: the runs above and below) and at a warp's edge
// (along y: the thread beside it) does a neighbour come from another
// thread's slot, so a thread writes its cell there only on those rows and
// columns.  The periodic wrap is resolved once, when the slots are filled;
// a box that holds an edge of the level that is not periodic reads the
// mirrored neighbour there (the sign times the cell, as LevelBox::nbrs) in
// a variant of its own (EDGE), so the others test no edge.  After the
// sweeps the box of v is laid out by rows over the slots of v, for the
// tile's output and residual.
//
// The cells still exact after half-sweep s (LevelBox's lo_s, hi_s: s cells
// inside an exposed edge of the box, or up to an edge of the level that is
// not periodic) are a row range per thread and a flag per column; a
// half-sweep updates those alone, so no box cell beyond the level and no
// row beyond the box is ever divided.  Each update's arithmetic is
// tile_smooth's (gs_val with the same operands in the same order).

template <typename T, int R>
struct RegCells {
  T v[R][2];  // v of each cell: row r0 + k, column c0 + side
};

// the slot of a thread's cells: 2 R values and one more, so that
// consecutive threads' slots start in distinct banks
template <int R>
__host__ __device__ constexpr int reg_slot() {
  return 2 * R + 1;
}

// where the thread's cells lie in the box, and the slots it reads
struct RegPlace {
  int r0, c0;        // the first row and column
  int rows;          // its rows inside the box (0 .. R)
  int own, f;        // its slot of v; its slot of f is at own + f
  int up, down;      // the slots of the runs above and below it
  int west, east;    // the slots of the pairs beside it
  bool wl, el;       // the pair west (east) of it is another warp's: the
                     // y-neighbour there comes through its slot, and the
                     // pair's column beside it is written to its own
};

template <int R>
__device__ __forceinline__ RegPlace reg_place(const LevelBox& t) {
  constexpr int S = reg_slot<R>();
  const int P = t.w / 2, tid = (int)threadIdx.x, lane = tid & 31;
  RegPlace o;
  o.r0 = (tid / P) * R;
  o.c0 = 2 * (tid % P);
  o.rows = max(0, min(R, t.w - o.r0));
  o.own = tid * S;
  o.f = (int)blockDim.x * S;
  // read only for exact cells, whose neighbours the block's threads hold
  o.up = (tid - P) * S;
  o.down = (tid + P) * S;
  o.west = (tid - 1) * S;
  o.east = (tid + 1) * S;
  o.wl = lane == 0;
  o.el = lane == 31;
  return o;
}

// calls fn(std::integral_constant<int, k>) for k = 0 .. sizeof...(K) - 1:
// each row's register indices are compile-time constants
template <typename F, int... K>
__device__ __forceinline__ void each_row(F&& fn,
                                         std::integer_sequence<int, K...>) {
  (fn(std::integral_constant<int, K>{}), ...);
}

// copy one value of global memory into shared memory with cp.async, which
// holds no register until copy_wait (a plain copy where no card compiles)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}

// wait for the thread's copies
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// load the thread's cells of the box t into its slots and registers: at
// each box cell that holds a cell of the frame (the wrapped cell across a
// periodic edge) f is f's value at the frame index, and v is src's (zero
// for src nullptr) passed through adjust(v, row, column); zeros elsewhere.
// q is the frame's row stride; a block barrier follows.  Only the last
// step holds the cells in registers: the copies hold none, and the
// adjustment runs cell by cell through the slot
template <typename T, int R, typename A>
__device__ __forceinline__ void reg_load(RegCells<T, R>& c, T* x,
                                         const LevelBox& t,
                                         const RegPlace& o, int q,
                                         const T* src, const T* f,
                                         A adjust) {
  bool col[2];
  int jt[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = t.ej + o.c0 + s;
    col[s] = j >= t.col_lo() && j <= t.col_hi();
    jt[s] = t.col(t.clamp(j, t.py));
  }
  auto row = [&](int k) {             // the frame row of row k, or -1
    const int i = t.ei + o.r0 + k;
    return k < o.rows && i >= t.row_lo() && i <= t.row_hi() ? t.row(i)
                                                             : -1;
  };
  each_row([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    const int it = row(k);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (it >= 0 && col[s]) {
        copy_async(x + o.own + o.f + 2 * k + s, f + it * q + jt[s]);
        if (src) copy_async(x + o.own + 2 * k + s, src + it * q + jt[s]);
      }
    }
  }, std::make_integer_sequence<int, R>{});
  copy_wait();
#pragma unroll 1
  for (int m = 0; m < 2 * R; ++m) {
    const int it = row(m >> 1), s = m & 1;
    T* v = x + o.own + m;
    if (it >= 0 && col[s]) {
      *v = adjust(src ? *v : T(0), it, jt[s]);
    } else {
      *v = T(0);
      v[o.f] = T(0);
    }
  }
  each_row([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    c.v[k][0] = x[o.own + 2 * k];
    c.v[k][1] = x[o.own + 2 * k + 1];
  }, std::make_integer_sequence<int, R>{});
  __syncthreads();
}

// the rows (relative to r0) of the level's edges that are not periodic,
// whose neighbour across the edge is the cell's mirror, and whether each
// of the pair's columns lies on such an edge (EDGE boxes only)
struct RegEdges {
  int k1, kn;          // row of extended index 1, of n (or out of range)
  bool y1[2], yn[2];   // column c0 + side is the level's first, last
};

__device__ __forceinline__ RegEdges reg_edges(const LevelBox& t,
                                              const RegPlace& o) {
  RegEdges e;
  e.k1 = t.px ? INT_MIN / 2 : 1 - t.ei - o.r0;
  e.kn = t.px ? INT_MIN / 2 : t.n - t.ei - o.r0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int j = t.ej + o.c0 + s;
    e.y1[s] = !t.py && j == 1;
    e.yn[s] = !t.py && j == t.n;
  }
  return e;
}

// one half-sweep over the thread's rows: at row k the cell of column side
// (SIDE0 + k) & 1, where k0 <= k <= k1 and the column is still exact
// (ok[side]); the caller ends it with a block barrier
template <int OP, typename T, int R, bool EDGE, int SIDE0, typename Level>
__device__ __forceinline__ void reg_half(RegCells<T, R>& c, T* x,
                                         const LevelBox& t, const Level& L,
                                         const RegPlace& o,
                                         const RegEdges& e, int k0, int k1,
                                         const bool (&ok)[2]) {
  static_assert(OP == OP_CONST, "a coefficient operator's update reads its "
                                "coefficients at the frame: tile_smooth");
  each_row([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    constexpr int s = (SIDE0 + k) & 1;
    constexpr int km = k > 0 ? k - 1 : 0, kp = k < R - 1 ? k + 1 : R - 1;
    // the y-neighbour in the next pair: the west pair's east column, or
    // the east pair's west column (every lane takes part in the shuffle)
    T yn = s == 0 ? __shfl_up_sync(0xffffffffu, c.v[k][1], 1)
                  : __shfl_down_sync(0xffffffffu, c.v[k][0], 1);
    if (k >= k0 && k <= k1 && ok[s]) {
      if (s == 0 ? o.wl : o.el)
        yn = s == 0 ? x[o.west + 2 * k + 1] : x[o.east + 2 * k];
      const T v0 = c.v[k][s];
      T xm = k == 0 ? x[o.up + 2 * (R - 1) + s] : c.v[km][s];
      T xp = k == R - 1 ? x[o.down + s] : c.v[kp][s];
      T ym = s == 0 ? yn : c.v[k][0];
      T yp = s == 0 ? c.v[k][1] : yn;
      if constexpr (EDGE) {
        if (k == e.k1) xm = L.gxl * v0;
        if (k == e.kn) xp = L.gxh * v0;
        if (e.y1[s]) ym = L.gyl * v0;
        if (e.yn[s]) yp = L.gyh * v0;
      }
      const T val =
          gs_val<OP>(xp, xm, yp, ym, x[o.own + o.f + 2 * k + s], L, 0);
      c.v[k][s] = val;
      if (k == 0 || k == R - 1 || (s == 0 ? o.wl : o.el))
        x[o.own + 2 * k + s] = val;
    }
  }, std::make_integer_sequence<int, R>{});
}

// `halves` red-black half-sweeps of the thread's cells, a block barrier
// after each: half-sweep s (1-based) updates the cells of colour (s - 1) &
// 1 -- red the cells whose frame row and column sum to an even number --
// that are still exact.  r0 and c0 are even, so the colour's column at row
// k is side (ei + ej + colour + k) & 1
template <int OP, typename T, int R, bool EDGE, typename Level>
__device__ void reg_sweeps(RegCells<T, R>& c, T* x, const LevelBox& t,
                           const Level& L, const RegPlace& o, int halves) {
  const RegEdges e = reg_edges(t, o);
  const int par = (t.ei + t.ej) & 1;
  for (int s = 1; s <= halves; ++s) {
    const int k0 = t.row_lo_s(s) - t.ei - o.r0;
    const int k1 = t.row_hi_s(s) - t.ei - o.r0;
    const int j0 = t.col_lo_s(s) - t.ej, j1 = t.col_hi_s(s) - t.ej;
    const bool ok[2] = {o.c0 >= j0 && o.c0 <= j1,
                        o.c0 + 1 >= j0 && o.c0 + 1 <= j1};
    if ((par + s - 1) & 1)
      reg_half<OP, T, R, EDGE, 1>(c, x, t, L, o, e, k0, k1, ok);
    else
      reg_half<OP, T, R, EDGE, 0>(c, x, t, L, o, e, k0, k1, ok);
    __syncthreads();
  }
}

// the round's half-sweeps, in the variant that reads mirrored neighbours
// where the box holds an edge of the level that is not periodic
template <int OP, typename T, int R, typename Level>
__device__ __forceinline__ void reg_smooth(RegCells<T, R>& c, T* x,
                                           const LevelBox& t, const Level& L,
                                           const RegPlace& o, int halves) {
  const bool edge = (!t.px && (t.ei <= 1 || t.ei + t.w - 1 >= t.n)) ||
                    (!t.py && (t.ej <= 1 || t.ej + t.w - 1 >= t.n));
  if (edge)
    reg_sweeps<OP, T, R, true>(c, x, t, L, o, halves);
  else
    reg_sweeps<OP, T, R, false>(c, x, t, L, o, halves);
}

// every v of the thread's cells into the box b, laid out by rows over the
// slots of v (the sweeps' last barrier is behind every read of them); a
// block barrier follows
template <typename T, int R>
__device__ __forceinline__ void reg_store(const RegCells<T, R>& c, T* b,
                                          const LevelBox& t,
                                          const RegPlace& o) {
  each_row([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    if (k < o.rows) {
      b[(o.r0 + k) * t.w + o.c0] = c.v[k][0];
      b[(o.r0 + k) * t.w + o.c0 + 1] = c.v[k][1];
    }
  }, std::make_integer_sequence<int, R>{});
  __syncthreads();
}

// the buffer round k of `rounds` writes: they alternate between scratch
// and the output so that the last one ends in the output
template <typename T>
__host__ __device__ inline T* round_dst(int k, int rounds, T* out,
                                        T* scratch) {
  return ((rounds - 1 - k) & 1) ? scratch : out;
}

}  // namespace
