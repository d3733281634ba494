// mg_tiles.cuh -- the tiles with deep halos that the multigrid smoothers
// run their sweeps on in shared memory: mg_vcycle.cu's descent and ascent
// (k_down, k_up) on a square one-ghost level, and mg_deep.cu's deep
// smoothing round (k_deep) on a block's rectangular deep frame.
//
// A block owns a tile and holds a box of the tile and a halo in shared
// memory, v's box with f's beside it, indexed by "extended" indices along
// each axis (LevelBox for a level, FrameBox for a deep frame, which give
// the loops below one interface): the frame's own indices, and beyond the
// frame, on a periodic axis whose ghosts mirror the opposite side, the
// frame's cells wrapped around.  Half-sweep s of a round may update a cell
// of the box only where it is still exact: s cells inside a box edge that
// has cells beyond it that the box does not hold (an "exposed" edge), or
// up to an edge beyond which nothing changes.  The halo is as deep as the round's
// sweeps reach plus one, so the tile and the ring around it are exact at
// the end.  A ghost that mirrors the cell beside it (sign times that cell)
// is never read from the box: a sweep reads it as its mirror (nbrs).
//
// Each cell's arithmetic is the untiled sweep's (mg_ops.cuh), so the exact
// cells of a box hold the untiled sweep's bits.

#pragma once

#include <limits.h>

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

// the buffer round k of `rounds` writes: they alternate between scratch
// and the output so that the last one ends in the output
template <typename T>
__host__ __device__ inline T* round_dst(int k, int rounds, T* out,
                                        T* scratch) {
  return ((rounds - 1 - k) & 1) ? scratch : out;
}

}  // namespace
