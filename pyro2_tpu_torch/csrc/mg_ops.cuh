// mg_ops.cuh -- the multigrid operators' device code, shared by mg_vcycle.cu
// (the V-cycle of one frame) and mg_deep.cu (the sharded multigrid's deep-halo
// smoothing round and coarse-grid correction).
//
// The three operators of pyro2_tpu_torch/multigrid:
//
//   OP_CONST    (alpha - beta L) phi = f, L the 5-point Laplacian
//               (MG.CellCenterMG2d);
//   OP_VC       div(eta grad phi) = f with edge coefficients eta_x, eta_y
//               (variable_coeff_MG.VarCoeffCCMG2d);
//   OP_GENERAL  alpha phi + div(beta grad phi) + gamma.grad phi = f with
//               planes alpha, beta_x, beta_y and the 0.5/dx-prescaled
//               gamma_x, gamma_y (general_MG.GeneralMG2d).
//
// Every function reads a frame through a level descriptor `L` of any type
// that has
//   q                       the frame's row stride (cells in a row),
//   qq                      the stride between two coefficient planes,
//   xc, yc, den, dx2, dy2   OP_CONST: beta/dx^2, beta/dy^2,
//                           alpha + 2 xc + 2 yc, dx^2, dy^2,
//   c                       OP_VC / OP_GENERAL: the plane stack, laid out
//                           like the frame,
// so one stencil serves the square one-ghost levels of mg_vcycle.cu and the
// rectangular deep frames of mg_deep.cu.  Each stencil is written in the
// order of the plain PyTorch version (MG.py, variable_coeff_MG.py,
// general_MG.py); with -fmad=false the two round alike.

#pragma once

#include <stddef.h>

// the operator
enum { OP_CONST = 0, OP_VC = 1, OP_GENERAL = 2 };

// the Gauss-Seidel update of cell c from its neighbours' values -- xp at
// (i+1, j), xm at (i-1, j), yp at (i, j+1), ym at (i, j-1) -- and its
// right-hand side fc.  VC and GENERAL read their edge coefficients as the
// plain smoothers' views do: bxp = x-plane at i+1 (the high-x face), bx =
// at i, byp = y-plane at j+1, by = at j
template <int OP, typename T, typename Level>
__device__ __forceinline__ T gs_val(T xp, T xm, T yp, T ym, T fc,
                                    const Level& L, int c) {
  const int q = L.q;
  if constexpr (OP == OP_CONST) {
    return (fc + L.xc * (xp + xm) + L.yc * (yp + ym)) / L.den;
  } else if constexpr (OP == OP_VC) {
    const size_t qq = L.qq;
    const T *ex = L.c, *ey = L.c + qq;
    const T bxp = ex[c + q], bx = ex[c], byp = ey[c + 1], by = ey[c];
    const T den = bxp + bx + byp + by;
    return (-fc + bxp * xp + bx * xm + byp * yp + by * ym) / den;
  } else {
    const size_t qq = L.qq;
    const T *al = L.c, *ex = L.c + qq, *ey = L.c + 2 * qq;
    const T *gx = L.c + 3 * qq, *gy = L.c + 4 * qq;
    const T bxp = ex[c + q], bx = ex[c], byp = ey[c + 1], by = ey[c];
    const T den = al[c] - bxp - bx - byp - by;
    return (fc - (bxp + gx[c]) * xp - (bx - gx[c]) * xm -
            (byp + gy[c]) * yp - (by - gy[c]) * ym) / den;
  }
}

// the same with the right-hand side read from frame f
template <int OP, typename T, typename Level>
__device__ __forceinline__ T gs_of(T xp, T xm, T yp, T ym, const T* f,
                                   const Level& L, int c) {
  return gs_val<OP>(xp, xm, yp, ym, f[c], L, c);
}

// the Gauss-Seidel update of cell c of frame v
template <int OP, typename T, typename Level>
__device__ __forceinline__ T gs(const T* v, const T* f, const Level& L,
                                int c) {
  const int q = L.q;
  return gs_of<OP>(v[c + q], v[c - q], v[c + 1], v[c - 1], f, L, c);
}

// the residual fc - (operator) v at cell c from the cell's value v0, its
// neighbours' (as for gs_val) and its right-hand side fc (alpha, beta:
// OP_CONST only)
template <int OP, typename T, typename Level>
__device__ __forceinline__ T resid_val(T v0, T xp, T xm, T yp, T ym, T fc,
                                       const Level& L, T alpha, T beta,
                                       int c) {
  const int q = L.q;
  if constexpr (OP == OP_CONST) {
    const T lap =
        (xm + xp - T(2) * v0) / L.dx2 + (ym + yp - T(2) * v0) / L.dy2;
    return fc - alpha * v0 + beta * lap;
  } else if constexpr (OP == OP_VC) {
    const size_t qq = L.qq;
    const T *ex = L.c, *ey = L.c + qq;
    const T Lv = ex[c + q] * (xp - v0) - ex[c] * (v0 - xm) +
                 ey[c + 1] * (yp - v0) - ey[c] * (v0 - ym);
    return fc - Lv;
  } else {
    const size_t qq = L.qq;
    const T *al = L.c, *ex = L.c + qq, *ey = L.c + 2 * qq;
    const T *gx = L.c + 3 * qq, *gy = L.c + 4 * qq;
    const T Lv = al[c] * v0 + ex[c + q] * (xp - v0) - ex[c] * (v0 - xm) +
                 ey[c + 1] * (yp - v0) - ey[c] * (v0 - ym) +
                 gx[c] * (xp - xm) + gy[c] * (yp - ym);
    return fc - Lv;
  }
}

// the residual f - (operator) v at cell c of frame v
template <int OP, typename T, typename Level>
__device__ __forceinline__ T resid(const T* v, const T* f, const Level& L,
                                   T alpha, T beta, int c) {
  const int q = L.q;
  return resid_val<OP>(v[c], v[c + q], v[c - q], v[c + 1], v[c - 1], f[c],
                       L, alpha, beta, c);
}

// the factor-2 average of the residual over four children, c the one with
// the lowest row and column (mesh.patch.restrict_array's order)
template <int OP, typename T, typename Level>
__device__ __forceinline__ T restrict4(const T* v, const T* f, const Level& L,
                                       T alpha, T beta, int c) {
  const int q = L.q;
  return T(0.25) * (((resid<OP>(v, f, L, alpha, beta, c) +
                      resid<OP>(v, f, L, alpha, beta, c + q)) +
                     resid<OP>(v, f, L, alpha, beta, c + 1)) +
                    resid<OP>(v, f, L, alpha, beta, c + q + 1));
}

// the centred-slope prolongation of the one-ghost coarse frame vc (row
// stride qc) at cell (i, j) of the one-ghost fine frame
// (mesh.patch.prolong_array)
template <typename T>
__device__ __forceinline__ T prolong(const T* vc, int qc, int i, int j) {
  const int C = ((i + 1) >> 1) * qc + ((j + 1) >> 1);
  const T sx = ((i - 1) & 1) ? T(0.25) : T(-0.25);
  const T sy = ((j - 1) & 1) ? T(0.25) : T(-0.25);
  const T mx = T(0.5) * (vc[C + qc] - vc[C - qc]);
  const T my = T(0.5) * (vc[C + 1] - vc[C - 1]);
  return vc[C] + sx * mx + sy * my;
}
