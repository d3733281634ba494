// grid_common.cuh -- device code shared by the finite-volume kernels
// (ctu_step.cu and mol_substep.cu through euler_common.cuh, swe_step.cu
// and lm_interface.cu): indexing into the (nvar, qx, qy) stack, the
// interior bounds, window tests against the global index, and the
// MC-limited slopes of mesh/reconstruction.py, which read a plane through
// a view a(i, j) (BoxPlane for the fused kernels' boxes of a tile in
// shared memory).
//
// The helpers are templates over the parameter block P, so each kernel
// source keeps its own block; they read only its generic fields: nx, ny,
// ng, qx, qy and limiter.  Everything sits in an anonymous namespace: each
// source that includes it compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// the most variables a state stack may hold (the per-cell arrays' length)
#define MAXVAR 8

namespace {

template <typename P>
__device__ __forceinline__ size_t at(const P& p, int n, int i, int j) {
  return ((size_t)n * p.qx + i) * p.qy + j;
}

template <typename P>
__device__ __forceinline__ int ilo(const P& p) { return p.ng; }
template <typename P>
__device__ __forceinline__ int ihi(const P& p) { return p.ng + p.nx - 1; }
template <typename P>
__device__ __forceinline__ int jlo(const P& p) { return p.ng; }
template <typename P>
__device__ __forceinline__ int jhi(const P& p) { return p.ng + p.ny - 1; }

// (i, j) inside the window [ilo - bxlo, ihi + bxhi] x [jlo - bylo, jhi + byhi]
template <typename P>
__device__ __forceinline__ bool inwin(const P& p, int i, int j, int bxlo,
                                      int bxhi, int bylo, int byhi) {
  return i >= ilo(p) - bxlo && i <= ihi(p) + bxhi && j >= jlo(p) - bylo &&
         j <= jhi(p) + byhi;
}

// a box of frame cells held in shared memory, row-major: rows i0 .. i0 +
// h - 1, columns j0 .. j0 + w - 1
struct Box {
  int i0, j0, h, w;
  __device__ int cells() const { return h * w; }
  __device__ int at(int i, int j) const { return (i - i0) * w + (j - j0); }
  __device__ bool has(int i, int j) const {
    return i >= i0 && i < i0 + h && j >= j0 && j < j0 + w;
  }
};

// plane k of a stack of planes over a box, seen as a(i, j) in frame indices
template <typename T>
struct BoxPlane {
  const T* a;
  Box b;
  __device__ __forceinline__ T operator()(int i, int j) const {
    return a[b.at(i, j)];
  }
};

template <typename T>
__device__ __forceinline__ BoxPlane<T> plane(const T* a, const Box& b,
                                             int k) {
  return BoxPlane<T>{a + k * b.cells(), b};
}

// ---------------------------------------------------------------------------
// slopes
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T mc(T dc, T dl, T dr) {
  const T d1 = T(2) * (fabs(dl) < fabs(dr) ? dl : dr);
  const T d = fabs(dc) < fabs(d1) ? dc : d1;
  return dl * dr > T(0) ? d : T(0);
}

// 2nd-order MC slope of plane a (any a(i, j) view) at (i, j) along idir,
// zero outside the buf=2 window (the embed of the plain version)
template <typename T, typename P, typename A>
__device__ __forceinline__ T limit2_at(const P& p, const A& a, int i, int j,
                                       int di, int dj) {
  if (!inwin(p, i, j, 2, 2, 2, 2)) return T(0);
  const T ap = a(i + di, j + dj);
  const T a0 = a(i, j);
  const T am = a(i - di, j - dj);
  return mc(T(0.5) * (ap - am), ap - a0, a0 - am);
}

// the limited slope of plane a (any a(i, j) view) at a buf=2-window cell
// (i, j) along idir: limiter 0 centred, 1 2nd-order MC, otherwise 4th-order
// MC over the 2nd-order slopes (computed on the global window, never
// band-local)
template <typename T, typename P, typename A>
__device__ __forceinline__ T slope_of(const P& p, const A& a, int i, int j,
                                      int di, int dj) {
  const T ap = a(i + di, j + dj);
  const T a0 = a(i, j);
  const T am = a(i - di, j - dj);
  if (p.limiter == 0) return T(0.5) * (ap - am);
  if (p.limiter == 1) return mc(T(0.5) * (ap - am), ap - a0, a0 - am);
  const T tp = limit2_at<T>(p, a, i + di, j + dj, di, dj);
  const T tm = limit2_at<T>(p, a, i - di, j - dj, di, dj);
  const T dc = T(2.0 / 3.0) * (ap - am - T(0.25) * (tp + tm));
  return mc(dc, ap - a0, a0 - am);
}

}  // namespace
