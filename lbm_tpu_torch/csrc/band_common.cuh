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
#pragma once

#include "lbm_common.cuh"

namespace band {

constexpr int kThreads = 512;  // one 1-D block per tile
constexpr int kWarps = kThreads / 32;

struct Geom {
  int ny, nx;    // grid
  int B, P, T;   // tile rows, tile columns, steps per pass
  int WH, WW;    // window rows B + 2T, columns P + 2T
  int ncell;     // WH * WW
  int nty, ntx;  // tiles down and across
};

inline Geom make_geom(int ny, int nx, int B, int T, int P) {
  Geom g;
  g.ny = ny;
  g.nx = nx;
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

// The tile's origin and its window's global rows and columns; the caller
// syncs before reading them.
__device__ __forceinline__ void fill_tables(const Geom& g, const Smem& s, int& y0, int& x0) {
  const int tile = blockIdx.x;
  y0 = (tile / g.ntx) * g.B;
  x0 = (tile % g.ntx) * g.P;
  for (int i = threadIdx.x; i < g.WH; i += kThreads) s.grow[i] = wrap_mod(y0 - g.T + i, g.ny);
  for (int i = threadIdx.x; i < g.WW; i += kThreads) s.gcol[i] = wrap_mod(x0 - g.T + i, g.nx);
}

// Loads the window's 9 planes into ``win`` (9 x ncell) and its
// not-obstacle plane into s.nob.
__device__ __forceinline__ void load_window(const Geom& g, const Smem& s, float* win,
                                            const float* __restrict__ src,
                                            const float* __restrict__ nobst) {
  const size_t plane = (size_t)g.ny * g.nx;
  for_cells(g.WH, g.WW, [&](int r, int c) {
    const size_t gi = (size_t)s.grow[r] * g.nx + s.gcol[c];
    const int i = r * g.WW + c;
#pragma unroll
    for (int k = 0; k < 9; ++k) win[k * g.ncell + i] = src[k * plane + gi];
    s.nob[i] = nobst[gi];
  });
}

// Stores the central cells of ``win`` that lie inside the grid.
__device__ __forceinline__ void store_tile(const Geom& g, const float* win, float* __restrict__ dst,
                                           int y0, int x0) {
  const size_t plane = (size_t)g.ny * g.nx;
  const int rows = min(g.B, g.ny - y0);
  const int cols = min(g.P, g.nx - x0);
  for_cells(rows, cols, [&](int r, int c) {
    const int i = (r + g.T) * g.WW + (c + g.T);
    const size_t gi = (size_t)(y0 + r) * g.nx + (x0 + c);
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k * plane + gi] = win[k * g.ncell + i];
  });
}

// Central cells inside the grid: window rows [T, rhi), columns [T, chi).
struct Central {
  int rhi, chi, T;
  __device__ __forceinline__ bool has(int r, int c) const {
    return r >= T && r < rhi && c >= T && c < chi;
  }
};

__device__ __forceinline__ Central central(const Geom& g, int y0, int x0) {
  return Central{g.T + min(g.B, g.ny - y0), g.T + min(g.P, g.nx - x0), g.T};
}

// Warp-reduces one thread's step sum in a fixed tree into red[s][warp].
// The caller's next __syncthreads() publishes it.
__device__ __forceinline__ void step_partial(const Smem& s, int step, float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) s.red[step * kWarps + (threadIdx.x >> 5)] = acc;
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
// writes this tile's T partials, and the last block to finish reduces all
// tiles' partials into av[0..T) * inv_tot. partials: T x ntiles floats;
// ticket: one zeroed unsigned int, reset to 0 for the next pass.
__device__ __forceinline__ void finish_sums(const Geom& g, const Smem& s, float* partials,
                                            unsigned int* ticket, float inv_tot, float* av) {
  __shared__ float scratch[kWarps];
  __shared__ bool is_last;
  const int ntiles = g.nty * g.ntx;
  for (int st = threadIdx.x; st < g.T; st += kThreads) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc += s.red[st * kWarps + w];
    partials[(size_t)st * ntiles + blockIdx.x] = acc;
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
    if (threadIdx.x == 0) av[st] = total * inv_tot;
  }
  if (threadIdx.x == 0) *ticket = 0u;
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

// Issues n_passes passes on one stream: launch(src, dst, av + p * T, p)
// with pass p reading buf[p % 2] and writing buf[(p + 1) % 2]. Returns the
// first launch error, or 0.
template <class Launch>
inline int run_passes(int n_passes, int T, float* a, float* b, float* av, Launch&& launch) {
  for (int p = 0; p < n_passes; ++p) {
    launch((p & 1) ? b : a, (p & 1) ? a : b, av + (size_t)p * T, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Sets the opt-in dynamic shared memory of ``kernel`` when above 48 KB.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace band
