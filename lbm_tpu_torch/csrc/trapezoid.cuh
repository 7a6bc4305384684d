// Shared device code of K5 (temporal.cu) and K6 (deep.cu): T steps of one
// tile's window on a shrinking trapezoid.
//
// The tile is B rows by P columns of the grid (the last tile of a row or
// column may be shorter: bi x pi cells). Its window holds the bi + 2T by
// pi + 2T cells around it, with wrapped global rows and columns, in two
// shared-memory copies (band_common.cuh's layout, two plane copies). Step s
// (1..T) computes only window rows [s, wh - s) and columns [s, ww - s): the
// cells whose inputs are all still valid, so no step recomputes garbage
// (the band kernels' fixed window does). After T steps exactly the central
// bi x pi cells remain. The trapezoid shrinks in x as well as y because the
// x halo is T columns of the input state, where the TPU kernels roll whole
// rows: no full row of a large grid fits the 227 KB of shared memory a
// block can use.
//
// The forcing of row ny-2 is fused into the pull, as in K1 and K9: a pull
// from a window row whose global row is ny-2 adds the delta, with the mask
// taken at the source cell from the read-only input copy. Every such row is
// forced, halo rows included, which takes any B, T, ragged tiles and a
// single tile that wraps onto itself (the TPU kernels force two static rows,
// which holds only for B >= 8 > T + 2).
//
// K5 and K6 differ only in where the window's halo rows come from (K5: the
// carried row packs; K6: the input state) and in K5's pack stores.
#pragma once

#include "band_common.cuh"

namespace trap {

// The tile's own rows and columns, and its window's height and width.
struct Tile {
  int y0, x0, bi, pi, wh, ww;
};

// Global row/column tables of the window (band::fill_tables) and the tile's
// extent; the caller syncs before reading the tables.
__device__ __forceinline__ Tile begin(const band::Geom& g, const band::Smem& s) {
  Tile t;
  band::fill_tables(g, s, t.y0, t.x0);
  t.bi = min(g.B, g.ny - t.y0);
  t.pi = min(g.P, g.nx - t.x0);
  t.wh = t.bi + 2 * g.T;
  t.ww = t.pi + 2 * g.T;
  return t;
}

// The T steps, from copy ``a`` (loaded, with s.nob) ping-ponging with
// ``b``; step partials go to s.red as in band_common.cuh. Returns the copy
// holding the central cells after step T.
__device__ __forceinline__ const float* steps(const band::Geom& g, const band::Smem& s,
                                              const Tile& tl, float* a, float* b, float w1a,
                                              float w2a, const lbm::Relax& rc) {
  const band::Central cen = band::central(g, tl.y0, tl.x0);
  const int frow = g.ny - 2;
  const int n = g.ncell;
  for (int st = 1; st <= g.T; ++st) {
    const float* in = (st & 1) ? a : b;
    float* out = (st & 1) ? b : a;
    float acc = 0.0f;
    band::for_cells(tl.wh - 2 * st, tl.ww - 2 * st, [&](int rr, int cc) {
      const int r = rr + st, c = cc + st;
      float t[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int sr = r - lbm::cy(k), sc = c - lbm::cx(k);
        const int si = sr * g.WW + sc;
        float v = in[k * n + si];
        if (band::forced(k) && s.grow[sr] == frow) {
          const float m = lbm::force_mask(in[3 * n + si], in[6 * n + si], in[7 * n + si],
                                          s.nob[si], w1a, w2a);
          v = v + band::force_weight(k, w1a, w2a) * m;
        }
        t[k] = v;
      }
      const int i = r * g.WW + c;
      const float nob = s.nob[i];
      const float usq = lbm::collide_fused(t, nob, rc);
#pragma unroll
      for (int k = 0; k < 9; ++k) out[k * n + i] = t[k];
      if (cen.has(r, c)) acc += nob * sqrtf(usq);
    });
    band::step_partial(s, st - 1, acc);
    __syncthreads();
  }
  return (g.T & 1) ? b : a;
}

}  // namespace trap
