// Shared device code of K5 (temporal.cu) and K6 (deep.cu): T steps of one
// tile's window on a shrinking trapezoid, in ONE shared-memory copy of the
// window stepped in place in the AA arrangement.
//
// The tile is B rows by P columns of the grid (the last tile of a row or
// column may be shorter: bi x pi cells). Its window holds the bi + 2T by
// pi + 2T cells around it, with wrapped global rows and columns, in one
// copy of the 9 planes (band_common.cuh's layout, one plane copy: 40 B of
// shared memory per cell with the not-obstacle plane, as K9 and K11). Step
// s (1..T) computes only window rows [s, wh - s) and columns [s, ww - s):
// the cells whose inputs are all still genuine, so no step recomputes
// garbage (K9's fixed window does). After T steps exactly the central
// bi x pi cells remain. The trapezoid shrinks in x as well as y because
// the x halo is T columns of the input state, where the TPU kernels roll
// whole rows: no full row of a large grid fits the 227 KB of shared memory
// a block can use.
//
// The AA arrangement is K9's (band2.cu): the loader writes each cell's R_k
// into its slot opp(k), the C space (the value leaving the cell along k),
// and adds at once the forcing of the cells on the ny-2 rows, cell-locally
// with the mask from the cell's own values (the forcing K1's pull adds to
// every value it takes from such a cell). Odd steps gather from
// (x - c_k, opp(k)), relax and scatter to (x + c_k, k) (C -> S); even steps
// relax in place (S -> C). Address (y, j) has one reader and one writer,
// the same cell y - c_j, and a thread finishes a cell's 9 reads before its
// 9 writes, so an in-place step on any region needs no barrier but the one
// after it. Step s's gathers and scatters reach one ring out, into step
// s - 1's region, all inside the window: nothing wraps, and every value a
// step reads was written by the step before it (or the load). A cell on a
// forcing row adds the next step's forcing to its outputs, but after the
// pass's last step. After an even T the central cells hold C, and the
// store reads R_k of cell x from its slot opp(k); after an odd T the last
// step scattered R_k of x to (x + c_k, k), one ring out and inside the
// window, and the store reads it there. Any T >= 1 is taken. The cell
// arithmetic is K1's in K1's order, so at f32 the state is bitwise K1's.
//
// The steps run an instruction-bound loop: a cell update's 18 shared-memory
// accesses take their addresses from the window's row and plane strides.
// For the windows of LBM_TRAP_WINDOWS, which the build sets to those of the
// driver's K5, K6 and K11 schedules (ops/_build.py), the kernels are
// compiled with those strides as constants (with_layout), so each access
// is a register plus an immediate offset; any other window runs with the
// strides of its geometry.
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

// The window's row stride and plane stride: compile-time constants where
// kWW and kN are not 0, else the geometry's (ww_, n_).
template <int kWW, int kN>
struct Lay {
  int ww_, n_;
  __device__ __forceinline__ int ww() const { return kWW ? kWW : ww_; }
  __device__ __forceinline__ int n() const { return kN ? kN : n_; }
};

// The windows compiled with constant strides: width, height, width,
// height, ... (the build passes them; none if it does not).
#ifndef LBM_TRAP_WINDOWS
#define LBM_TRAP_WINDOWS
#endif

template <class F>
inline int with_windows(const band::Geom& g, F&& f) {
  return f(Lay<0, 0>{g.WW, g.ncell});
}

template <int kWW, int kWH, int... kMore, class F>
inline int with_windows(const band::Geom& g, F&& f) {
  if (g.WW == kWW && g.WH == kWH) return f(Lay<kWW, kWW * kWH>{g.WW, g.ncell});
  return with_windows<kMore...>(g, f);
}

// Returns f(lay) with the layout of g's window: constant strides for a
// window of LBM_TRAP_WINDOWS, else the geometry's.
template <class F>
inline int with_layout(const band::Geom& g, F&& f) {
  return with_windows<LBM_TRAP_WINDOWS>(g, f);
}

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

// Loads the window into the C space: cell(r, c, v) puts window cell
// (r, c)'s 9 values R_k into v and returns its not-obstacle value; the
// cells on the forcing rows are forced. Ends with a barrier.
template <class L, class Cell>
__device__ __forceinline__ void load(const band::Geom& g, const band::Smem& s, const Tile& tl,
                                     const L& lay, float w1a, float w2a, Cell&& cell) {
  float* w = s.planes;
  const int n = lay.n();
  const int frow = g.ny - 2;
  band::for_cells(tl.wh, tl.ww, [&](int r, int c) {
    const int i = r * lay.ww() + c;
    float v[9];
    const float nob = cell(r, c, v);
    s.nob[i] = nob;
    if (s.grow[r] == frow) band::force_cell(v, nob, w1a, w2a);
#pragma unroll
    for (int k = 0; k < 9; ++k) w[lbm::opp(k) * n + i] = v[k];
  });
  __syncthreads();
}

// One step on window rows [inset, wh - inset) and columns [inset, ww -
// inset), in place: kOdd, gather-relax-scatter; else cell-local. ``force``:
// a cell on a forcing row adds the next step's forcing to its outputs. The
// step's sum of nob * |u| over the central cells goes to red[step]; a
// barrier ends the step. K5 and K6 run step st (1-based) at inset st, K11
// (band3.cu) step st (0-based) at inset st.
template <bool kOdd, class L>
__device__ __forceinline__ void aa_step(const band::Geom& g, const band::Smem& s, const Tile& tl,
                                        const L& lay, const band::Central& cen, bool force,
                                        float w1a, float w2a, const lbm::Relax& rc, int inset,
                                        int step) {
  float* w = s.planes;
  const int n = lay.n(), ww = lay.ww();
  const int frow = g.ny - 2;
  float acc = 0.0f;
  band::for_cells(tl.wh - 2 * inset, tl.ww - 2 * inset, [&](int rr, int cc) {
    const int r = rr + inset, c = cc + inset;
    const int i = r * ww + c;
    float t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      t[k] = kOdd ? w[lbm::opp(k) * n + i - lbm::cy(k) * ww - lbm::cx(k)] : w[k * n + i];
    }
    const float nob = s.nob[i];
    const float usq = lbm::collide_fused(t, nob, rc);
    if (force && s.grow[r] == frow) band::force_cell(t, nob, w1a, w2a);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (kOdd) {
        w[k * n + i + lbm::cy(k) * ww + lbm::cx(k)] = t[k];
      } else {
        w[lbm::opp(k) * n + i] = t[k];
      }
    }
    if (cen.has(r, c)) acc += nob * sqrtf(usq);
  });
  band::step_partial(s, step, acc);
  __syncthreads();
}

// The T steps, odd, even, odd, ...; the pass's last step adds no forcing.
template <class L>
__device__ __forceinline__ void steps(const band::Geom& g, const band::Smem& s, const Tile& tl,
                                      const L& lay, float w1a, float w2a, const lbm::Relax& rc) {
  const band::Central cen = band::central(g, tl.y0, tl.x0);
  for (int st = 1; st <= g.T; ++st) {
    if (st & 1) {
      aa_step<true>(g, s, tl, lay, cen, st < g.T, w1a, w2a, rc, st, st - 1);
    } else {
      aa_step<false>(g, s, tl, lay, cen, st < g.T, w1a, w2a, rc, st, st - 1);
    }
  }
}

// R_k of window cell i after the T steps: its slot opp(k) after an even T,
// (i + c_k, k) after an odd T.
template <class L>
__device__ __forceinline__ float result(const band::Geom& g, const L& lay, const float* w, int i,
                                        int k) {
  return (g.T & 1) ? w[k * lay.n() + i + lbm::cy(k) * lay.ww() + lbm::cx(k)]
                   : w[lbm::opp(k) * lay.n() + i];
}

// Stores the central cells to dst, each value encoded once;
// rows(r, x, e) then sees tile row r, grid column x and the 9 encoded
// values (K5 stores its pack rows from them).
template <class S, class L, class Rows>
__device__ __forceinline__ void store(const band::Geom& g, const band::Smem& s, const Tile& tl,
                                      const L& lay, typename S::T* __restrict__ dst, const S& io,
                                      Rows&& rows) {
  const size_t plane = (size_t)g.ny * g.nx;
  band::for_cells(tl.bi, tl.pi, [&](int r, int c) {
    const int i = (r + g.T) * lay.ww() + (c + g.T);
    const int x = tl.x0 + c;
    const size_t gi = (size_t)(tl.y0 + r) * g.nx + x;
    typename S::T e[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      e[k] = io.store(result(g, lay, s.planes, i, k), k);
      dst[k * plane + gi] = e[k];
    }
    rows(r, x, e);
  });
}

}  // namespace trap
