// Shared device code of the band kernels K7 (band.cu), K9 (band2.cu) and
// K11 (band3.cu): tile geometry, the window loader and store, and the
// deterministic per-step |u| sums.
//
// The schedule (ops/band_common.py): one thread block per output tile of
// B x P cells. Its window of (B+2T) x (P+2T) cells is loaded from device
// memory into dynamic shared memory through wrapped global row and column
// indices, so the periodic boundary costs nothing extra. The block advances
// T steps inside the window, with __syncthreads() between steps; streaming
// wraps at the WINDOW's edges, so garbage creeps in one cell per step from
// each edge and never reaches the central tile, which is stored where it
// lies inside the grid. The forcing of row ny-2 is applied at every window
// row whose global row is ny-2, at every step, halo rows included.
//
// Dynamic shared memory of a block, in this order (ops/band_common.py::
// smem_bytes must agree): the window planes (9 x ncell floats, once or
// twice), the not-obstacle plane (ncell floats), the global row of each
// window row and the global column of each window column (ints), and the
// per-warp partial sums of each step (kWarps x T floats).
//
// Per-step sums: a thread adds nob * |u| of its central cells in a fixed
// order, each warp reduces with a fixed shuffle tree into red[s][warp], and
// after the last step the block writes partials[s][tile]. The last block to
// finish (an integer ticket, no float atomics) reduces partials[s][0..ntiles)
// in a fixed order into av[s] * inv_tot, so two runs are bitwise equal.
//
// Storage: the window is f32 in shared memory; the loader decodes and the
// store encodes the planes of device memory through a storage type of
// lbm_common.cuh (F32, C16 for int16 codes, BF16 for bfloat16), so the
// 16-bit forms change only the bytes of the load and the store. The
// sharded halos carry the raw 16-bit elements.
//
// Sharded form (K8 in band.cu, K10 in band2.cu): a 1-D mesh of shards, each
// of ny rows of a grid of nyg rows, shard z starting at global row
// r0 + z * ny. The shards of one call sit in one (count, 9, ny, nx) array
// and one launch covers them (blockIdx.y = shard; r0 is the global row of
// the call's first shard). A tile's window rows come from three arrays
// instead of the wrapped grid: the previous shard's last T rows (halo_dn),
// the shard's own rows and the next shard's first T rows (halo_up), which
// halo_rows_kernel copies once per pass through a table of every shard's
// addresses, so a neighbour may sit in another call or on another card; x
// still wraps within the shard's full rows. The global row of every window
// row, for the forcing test, is (r0 + z * ny + y0 - T + r) mod nyg.
#pragma once

#include "lbm_common.cuh"

namespace band {

constexpr int kThreads = 512;  // one 1-D block per tile
constexpr int kWarps = kThreads / 32;

struct Geom {
  int ny, nx;    // grid (sharded: one shard's rows)
  int B, P, T;   // tile rows, tile columns, steps per pass
  int WH, WW;    // window rows B + 2T, columns P + 2T
  int ncell;     // WH * WW
  int nty, ntx;  // tiles down and across
  int nyg;       // global rows: the forcing row is nyg - 2
  int r0;        // global row of the first row (of shard 0 of the launch)
  int av_stride; // sharded: av values between two shards
  int flip;      // 1: the launch's blocks take the tiles from the last one back (tile_id)
};

inline Geom make_geom(int ny, int nx, int B, int T, int P) {
  Geom g;
  g.ny = ny;
  g.nx = nx;
  g.nyg = ny;
  g.r0 = 0;
  g.av_stride = 0;
  g.flip = 0;
  g.B = B;
  g.P = P;
  g.T = T;
  g.WH = B + 2 * T;
  g.WW = P + 2 * T;
  g.ncell = g.WH * g.WW;
  g.nty = (ny + B - 1) / B;
  g.ntx = (nx + P - 1) / P;
  return g;
}

inline size_t smem_bytes(const Geom& g, int plane_copies) {
  return sizeof(float) * ((9 * plane_copies + 1) * (size_t)g.ncell) +
         sizeof(int) * (size_t)(g.WH + g.WW) + sizeof(float) * (size_t)kWarps * g.T;
}

// The block's views of its dynamic shared memory.
struct Smem {
  float* planes;  // 9 * ncell (times plane_copies)
  float* nob;     // ncell
  int* grow;      // WH: global row of each window row
  int* gcol;      // WW: global column of each window column
  float* red;     // T * kWarps: per-step, per-warp partial sums
};

__device__ __forceinline__ Smem carve(float* base, const Geom& g, int plane_copies) {
  Smem s;
  s.planes = base;
  s.nob = base + (size_t)9 * plane_copies * g.ncell;
  s.grow = reinterpret_cast<int*>(s.nob + g.ncell);
  s.gcol = s.grow + g.WH;
  s.red = reinterpret_cast<float*>(s.gcol + g.WW);
  return s;
}

__device__ __forceinline__ int wrap_mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// One step inside the window: +-1 with wrap at the window's edge.
__device__ __forceinline__ int wrap1(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

// Calls f(r, c) for every cell of a rows x cols region, cells distributed
// over the block's threads in row-major order (consecutive threads on
// consecutive columns), stepping (r, c) without a division per cell.
template <class F>
__device__ __forceinline__ void for_cells(int rows, int cols, F&& f) {
  const int n = rows * cols;
  const int dr = kThreads / cols;
  const int dc = kThreads - dr * cols;
  int r = threadIdx.x / cols;
  int c = threadIdx.x - r * cols;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    f(r, c);
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// The block's tile, row-major: blockIdx.x, or with g.flip counted from the
// last tile, so that the launch's first blocks take the last tiles.
__device__ __forceinline__ int tile_id(const Geom& g) {
  return g.flip ? g.nty * g.ntx - 1 - (int)blockIdx.x : (int)blockIdx.x;
}

// The tile's origin and its window's global rows and columns; the caller
// syncs before reading them. Sharded, blockIdx.y is the shard.
__device__ __forceinline__ void fill_tables(const Geom& g, const Smem& s, int& y0, int& x0) {
  const int tile = tile_id(g);
  y0 = (tile / g.ntx) * g.B;
  x0 = (tile % g.ntx) * g.P;
  const int r0 = g.r0 + blockIdx.y * g.ny;
  for (int i = threadIdx.x; i < g.WH; i += kThreads) s.grow[i] = wrap_mod(r0 + y0 - g.T + i, g.nyg);
  for (int i = threadIdx.x; i < g.WW; i += kThreads) s.gcol[i] = wrap_mod(x0 - g.T + i, g.nx);
}

// Where the windows of a launch read: the grid (halo_dn null), or the
// shards' rows between their halos, each array with all shards of the
// launch stacked; the launch's shard blockIdx.y is picked by ``shard``.
// T is the storage's raw type (float, or int16_t codes).
template <class T>
struct SourceT {
  const T* cells;        // (9, ny, nx) per shard
  const float* nobst;    // (ny, nx) per shard
  const T* halo_dn;      // (9, T, nx) per shard: previous shard's last T rows
  const T* halo_up;      // (9, T, nx) per shard: next shard's first T rows
  const float* nob_dn;   // (T, nx) per shard
  const float* nob_up;   // (T, nx) per shard
};
using Source = SourceT<float>;

template <class T>
__device__ __forceinline__ SourceT<T> shard(const Geom& g, SourceT<T> src) {
  const size_t z = blockIdx.y;
  const size_t plane = (size_t)g.ny * g.nx, hplane = (size_t)g.T * g.nx;
  src.cells += z * 9 * plane;
  src.nobst += z * plane;
  if (src.halo_dn != nullptr) {
    src.halo_dn += z * 9 * hplane;
    src.halo_up += z * 9 * hplane;
    src.nob_dn += z * hplane;
    src.nob_up += z * hplane;
  }
  return src;
}

// Loads the 9 values of window cell (r, c) of the tile at row y0 into v
// and returns its not-obstacle value. Sharded, window row r is row y0 + r
// of the shard's rows with T halo rows on each side (wrapped within those
// ny + 2T rows: the rows beyond them only feed garbage that never reaches
// the central cells).
template <bool kSharded, class S = lbm::F32>
__device__ __forceinline__ float load_cell(const Geom& g, const Smem& s,
                                           const SourceT<typename S::T>& src, int y0, int r,
                                           int c, float v[9], const S& st = S()) {
  const typename S::T* base = src.cells;
  const float* nbase = src.nobst;
  size_t plane = (size_t)g.ny * g.nx;
  int row = s.grow[r];
  if (kSharded) {
    int q = y0 + r;
    const int ext = g.ny + 2 * g.T;
    q = q >= ext ? q - ext : q;
    if (q < g.T) {
      base = src.halo_dn;
      nbase = src.nob_dn;
      plane = (size_t)g.T * g.nx;
      row = q;
    } else if (q < g.T + g.ny) {
      row = q - g.T;
    } else {
      base = src.halo_up;
      nbase = src.nob_up;
      plane = (size_t)g.T * g.nx;
      row = q - g.T - g.ny;
    }
  }
  const size_t gi = (size_t)row * g.nx + s.gcol[c];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = st.load(base[k * plane + gi], k);
  return nbase[gi];
}

// Central cells inside the grid: window rows [rlo, rhi), columns [T, chi).
struct Central {
  int rlo, rhi, chi, T;
  __device__ __forceinline__ bool has(int r, int c) const {
    return r >= rlo && r < rhi && c >= T && c < chi;
  }
};

__device__ __forceinline__ Central central(const Geom& g, int y0, int x0) {
  return Central{g.T, g.T + min(g.B, g.ny - y0), g.T + min(g.P, g.nx - x0), g.T};
}

// The central cells of rows [lo, hi) of the grid only (the slab kernel's
// owned rows).
__device__ __forceinline__ Central central_rows(const Geom& g, int y0, int x0, int lo, int hi) {
  Central c = central(g, y0, x0);
  c.rlo = max(c.rlo, lo - y0 + g.T);
  c.rhi = min(c.rhi, hi - y0 + g.T);
  return c;
}

// Warp-reduces one thread's step sum in a fixed tree into red[s][warp].
// The caller's next __syncthreads() publishes it.
__device__ __forceinline__ void step_partial(const Smem& s, int step, float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) s.red[step * kWarps + (threadIdx.x >> 5)] = acc;
}

// Forcing delta of speed k (kernels.cl:21-41): +w on 1, 5, 8 and -w on 3, 6, 7.
__host__ __device__ constexpr bool forced(int k) {
  return k == 1 || k == 3 || k == 5 || k == 6 || k == 7 || k == 8;
}

__device__ __forceinline__ float force_weight(int k, float w1a, float w2a) {
  return k == 1 ? w1a : k == 3 ? -w1a : (k == 5 || k == 8) ? w2a : (k == 6 || k == 7) ? -w2a : 0.0f;
}

// Cell-local forcing of one cell's 9 values v (speed k in v[k]), with the
// joint mask from its own f3, f6, f7 before any change.
__device__ __forceinline__ void force_cell(float v[9], float nob, float w1a, float w2a) {
  const float m = lbm::force_mask(v[3], v[6], v[7], nob, w1a, w2a);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (forced(k)) v[k] = v[k] + force_weight(k, w1a, w2a) * m;
  }
}

// One step of the window ``w`` (9 x ncell, one copy) in the AA
// arrangement, in place (aa_steps below), its sum into red[step] and a
// barrier:
//   even (S -> C, kOdd false): cell-local; read the 9 slots of the cell,
//     relax, write the value travelling k into slot opp(k) of the cell;
//   odd (C -> S): gather t_k from (x - c_k, opp(k)), relax, scatter to
//     (x + c_k, k), wrapping at the window's edges.
// Address (w, j) has one reader and one writer, the same cell w - c_j (the
// window wrap keeps this), and each thread finishes a cell's 9 reads before
// its 9 writes, so a step needs no barrier but the one after it. ``force``:
// a cell on a forcing row (global row frow) adds the forcing of the next
// step to its own outputs, with the mask from them (an even step: the
// C-space forcing the odd step's gather reads; an odd step: the S-space
// forcing the even step's cell-local read takes).
template <bool kOdd>
__device__ __forceinline__ void aa_step(const Geom& g, const Smem& s, float* w, const Central& cen,
                                        int frow, bool force, float w1a, float w2a,
                                        const lbm::Relax& rc, int step) {
  const int n = g.ncell;
  float acc = 0.0f;
  for_cells(g.WH, g.WW, [&](int r, int c) {
    const int ru = wrap1(r - 1, g.WH), rd = wrap1(r + 1, g.WH);
    const int cl = wrap1(c - 1, g.WW), cr = wrap1(c + 1, g.WW);
    const int i = r * g.WW + c;
    float t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (kOdd) {
        const int sr = lbm::cy(k) == 1 ? ru : (lbm::cy(k) == -1 ? rd : r);
        const int sc = lbm::cx(k) == 1 ? cl : (lbm::cx(k) == -1 ? cr : c);
        t[k] = w[lbm::opp(k) * n + sr * g.WW + sc];
      } else {
        t[k] = w[k * n + i];
      }
    }
    const float nob = s.nob[i];
    const float usq = lbm::collide_fused(t, nob, rc);
    if (force && s.grow[r] == frow) force_cell(t, nob, w1a, w2a);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (kOdd) {
        const int dr = lbm::cy(k) == 1 ? rd : (lbm::cy(k) == -1 ? ru : r);
        const int dc = lbm::cx(k) == 1 ? cr : (lbm::cx(k) == -1 ? cl : c);
        w[k * n + dr * g.WW + dc] = t[k];
      } else {
        w[lbm::opp(k) * n + i] = t[k];
      }
    }
    if (cen.has(r, c)) acc += nob * sqrtf(usq);
  });
  step_partial(s, step, acc);
  __syncthreads();
}

// The one-window pass of K7, K8, K9, K10 and K13 (band.cu, band2.cu): the
// window in ONE copy of the 9 planes, stepped in place in the AA
// arrangement, any T >= 1.
//
// aa_load writes each window cell's R_k into its slot opp(k), the C space
// of the AA steps (the value leaving the cell along k), with the forcing of
// the cells on the forcing row added cell-locally (the mask from the
// cell's own values: the forcing K1's pull adds to every value it takes
// from such a cell). aa_steps then runs odd, even, odd, ...: an odd step
// gathers, relaxes and scatters (C -> S), an even one relaxes in place
// (S -> C), each adding the forcing of the step after it but for the
// pass's last. After an even T the window holds C and R_k of cell i is in
// its slot opp(k); after an odd T the last step scattered R_k of i to
// (i + c_k, k), one cell out, which for a central cell (T >= 1 cells from
// every edge) lies inside the window without a wrap (aa_result). The steps
// wrap at the window's edges; after step s the cells whose update is
// genuine are those at least s cells from every edge, so the central cells
// and their sums stay genuine. One barrier per step; the cell arithmetic
// is K1's in K1's order, so at f32 the state is bitwise K1's.

// Loads the window: cell(r, c, v) puts window cell (r, c)'s 9 values R_k
// into v and returns its not-obstacle value. Ends with a barrier.
template <class Cell>
__device__ __forceinline__ void aa_load(const Geom& g, const Smem& s, float w1a, float w2a,
                                        Cell&& cell) {
  float* w = s.planes;
  const int n = g.ncell;
  const int frow = g.nyg - 2;
  for_cells(g.WH, g.WW, [&](int r, int c) {
    const int i = r * g.WW + c;
    float v[9];
    const float nob = cell(r, c, v);
    s.nob[i] = nob;
    if (s.grow[r] == frow) force_cell(v, nob, w1a, w2a);
#pragma unroll
    for (int k = 0; k < 9; ++k) w[lbm::opp(k) * n + i] = v[k];
  });
  __syncthreads();
}

// The pass's T steps (any T >= 1), their sums over ``cen`` into red[0..T).
__device__ __forceinline__ void aa_steps(const Geom& g, const Smem& s, const Central& cen,
                                         float w1a, float w2a, const lbm::Relax& rc) {
  const int frow = g.nyg - 2;
  int st = 0;
  for (; st + 1 < g.T; st += 2) {
    aa_step<true>(g, s, s.planes, cen, frow, true, w1a, w2a, rc, st);
    aa_step<false>(g, s, s.planes, cen, frow, st + 2 < g.T, w1a, w2a, rc, st + 1);
  }
  if (st < g.T) aa_step<true>(g, s, s.planes, cen, frow, false, w1a, w2a, rc, st);
}

// R_k of window cell i after the T steps: its slot opp(k) after an even T,
// (i + c_k, k) after an odd T.
__device__ __forceinline__ float aa_result(const Geom& g, const float* w, int i, int k) {
  return (g.T & 1) ? w[k * g.ncell + i + lbm::cy(k) * g.WW + lbm::cx(k)]
                   : w[lbm::opp(k) * g.ncell + i];
}

// Stores the window cells of ``out`` (rows [rlo, rhi), columns [T, chi)),
// each value encoded once: window cell (r, c) goes to row r_off + r,
// column x0 + c - T of planes ``plane`` elements apart.
template <class S>
__device__ __forceinline__ void aa_store(const Geom& g, const float* w, const Central& out,
                                         typename S::T* __restrict__ dst, size_t plane, int r_off,
                                         int x0, const S& st) {
  for_cells(out.rhi - out.rlo, out.chi - g.T, [&](int rr, int cc) {
    const int r = rr + out.rlo, c = cc + g.T;
    const int i = r * g.WW + c;
    const size_t gi = (size_t)(r_off + r) * g.nx + (x0 + cc);
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k * plane + gi] = st.store(aa_result(g, w, i, k), k);
  });
}

// Fixed-order sum of one value per thread; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // scratch may still be read from a previous call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  return total;
}

// After the pass (and a __syncthreads() since the last step_partial):
// writes this tile's T partials (at its tile_id, so the order of the sum
// does not depend on g.flip), and the last block to finish reduces all
// tiles' partials into av[0..T) * inv_tot, or adds them to av with
// ``accumulate``. partials: T x ntiles floats; ticket: one zeroed unsigned
// int, reset to 0 for the next pass.
__device__ __forceinline__ void finish_sums(const Geom& g, const Smem& s, float* partials,
                                            unsigned int* ticket, float inv_tot, float* av,
                                            bool accumulate = false) {
  __shared__ float scratch[kWarps];
  __shared__ bool is_last;
  const int ntiles = g.nty * g.ntx;
  for (int st = threadIdx.x; st < g.T; st += kThreads) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc += s.red[st * kWarps + w];
    partials[(size_t)st * ntiles + tile_id(g)] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int t = atomicAdd(ticket, 1u);
    is_last = (t == (unsigned int)ntiles - 1u);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int st = 0; st < g.T; ++st) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < ntiles; i += kThreads) acc += __ldcg(partials + (size_t)st * ntiles + i);
    const float total = block_sum(acc, scratch);
    if (threadIdx.x == 0) av[st] = (accumulate ? av[st] : 0.0f) + total * inv_tot;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// The geometry of pass p of a run: its tiles in row-major order on even
// passes, from the last tile back on odd ones (tile_id). Blocks start
// about in blockIdx order, so each pass begins on the tiles that the pass
// before stored last, whose rows are still in the L2; on an H100 that
// took 6.8% off K6's pass at 1024^2, 3.3% at 1536^2 and 1.9% at 2048^2,
// and 7.7% off K5's at 1024^2 (PERF.md section 6). Each tile's cells and
// partial sums are the same in either order, so the results are bitwise
// those of one order.
inline Geom pass_order(Geom g, int p) {
  g.flip = p & 1;
  return g;
}

// Issues n_passes passes on one stream: launch(src, dst, av + p * T, p)
// with pass p reading buf[p % 2] and writing buf[(p + 1) % 2]. Returns the
// first launch error, or 0.
template <class E, class Launch>
inline int run_passes(int n_passes, int T, E* a, E* b, float* av, Launch&& launch) {
  for (int p = 0; p < n_passes; ++p) {
    launch((p & 1) ? b : a, (p & 1) ? a : b, av + (size_t)p * T, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Sharded: copies the halo rows of the launch's shards [s0, s0 + count)
// of a ring of nshards shards: halo_dn[z] = the last T rows of shard z - 1,
// halo_up[z] = the first T rows of shard z + 1. table holds, per shard,
// the addresses of its two (9, ny, nx) buffers; ``which`` picks the one
// read, on this card or another (peer addresses). E is the raw element
// (float, or the int16_t c16 codes or bfloat16 values, copied as they
// are: no decode, and half the bytes). (Internal linkage: every band
// source includes this header.)
template <class E>
static __global__ void halo_rows_kernel(const unsigned long long* __restrict__ table, int which,
                                        int s0, int count, int nshards, E* __restrict__ halo_dn,
                                        E* __restrict__ halo_up, int ny, int nx, int T) {
  const size_t per = (size_t)9 * T * nx;  // halo elements per shard and side
  const size_t n = 2 * per * count;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t side = i / (per * count);
    const size_t j = i - side * per * count;
    const int z = s0 + (int)(j / per);
    const size_t e = j - (size_t)(z - s0) * per;  // (k, row, col) within the halo
    const int k = (int)(e / ((size_t)T * nx));
    const size_t rc = e - (size_t)k * T * nx;
    const int nz = side == 0 ? (z == 0 ? nshards - 1 : z - 1) : (z == nshards - 1 ? 0 : z + 1);
    const E* cells = reinterpret_cast<const E*>(table[2 * nz + which]);
    const size_t row0 = side == 0 ? (size_t)(ny - T) * nx : 0;
    (side == 0 ? halo_dn : halo_up)[j] = cells[(size_t)k * ny * nx + row0 + rc];
  }
}

// Sharded: issues n_passes passes over the call's shards (ShardsT) stacked
// in a and b, each preceded by the halo copy from the pass's source
// buffer: pass p reads a when (parity + p) is even, else b.
// launch(src, dst, av + p * T, p) as run_passes. The halo copy reads the
// neighbour shards, so across calls the caller orders a pass after the
// neighbours' previous one. A null table: the caller has filled the halos
// (rows received from neighbour shards in other processes) and no copy
// runs. Returns the first launch error, or 0. E is the raw element of the
// state planes and halos (the not-obstacle halos stay f32).
template <class E>
struct ShardsT {
  const unsigned long long* table;  // 2 * nshards addresses: each shard's two buffers (or null)
  int s0, count, nshards;           // the call's shards [s0, s0 + count) of the ring
  int parity;                       // the first pass reads buffer a when even
  E* halo_dn;                       // (count, 9, T, nx)
  E* halo_up;                       // (count, 9, T, nx)
};

template <class E, class Launch>
inline int run_sharded_passes(const Geom& g, const ShardsT<E>& sh, int n_passes, E* a, E* b,
                              float* av, cudaStream_t st, Launch&& launch) {
  const size_t n = (size_t)2 * 9 * g.T * g.nx * sh.count;
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  for (int p = 0; p < n_passes; ++p) {
    const int w = (sh.parity + p) & 1;
    if (sh.table != nullptr) {
      lbm::count_launch();
      halo_rows_kernel<E><<<blocks, kThreads, 0, st>>>(sh.table, w, sh.s0, sh.count, sh.nshards,
                                                       sh.halo_dn, sh.halo_up, g.ny, g.nx, g.T);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch(w ? b : a, w ? a : b, av + (size_t)p * g.T, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The geometry of a sharded call: its shards' rows, the global rows of the
// ring of shards, and av_stride av values between two shards.
template <class E>
inline Geom make_sharded_geom(int ny, int nx, int B, int T, int P, const ShardsT<E>& sh,
                              int av_stride) {
  Geom g = make_geom(ny, nx, B, T, P);
  g.nyg = sh.nshards * ny;
  g.r0 = sh.s0 * ny;
  g.av_stride = av_stride;
  return g;
}

// Sets the opt-in dynamic shared memory of ``kernel`` when above 48 KB.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace band
