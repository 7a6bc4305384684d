// K3 and K12: the fused step of a mesh of shards, each shard held with a
// one-cell ghost ring.
//
// Replaces: lbm_tpu/ops/pallas_step.py::_kernel with col_fix=True
// (_make_pallas_call_2d, _step_carry_2d), the fused step of one 2-D mesh
// shard whose x wrap is patched by its x neighbours' edge columns (K3; with
// one shard across it is K1's 1-D shard form), and
// lbm_tpu/ops/pallas_remote.py::_kernel_overlap, the 1-D shard step that
// sends its two shard-crossing halo row packs to the ring neighbours from
// inside the kernel (K12).
//
// Layout: shard z = i * px + j of a py x px mesh owns global rows
// [i*ry, (i+1)*ry) and columns [j*rx, (j+1)*rx). It is stored as
// (9, ry+2, pitch): its cells inside a ring of one ghost cell on every side
// that holds the neighbours' edge cells (rows, columns and the four
// corners), in two ping-pong buffers, with its not-obstacle plane padded
// the same way (the same lead and pitch, in elements). Cell (y, x) sits at
// row y + 1, column lead + x; the caller picks lead and pitch as multiples
// of one 128-byte line of the state's element (32 floats, or 64 int16
// codes at c16), so every row of cells starts on a line and a warp's
// stores of a row are whole lines (with lead 1 every store would straddle
// two lines); the 16-bit forms take four cells per thread, so a warp's
// access of a plane is two whole lines (shard_step_pair_kernel). A table on the
// device gives, per shard, the addresses of buffer 0, buffer 1 and the
// padded plane, so shards may live in one allocation or on several cards
// (peer addresses).
//
// The step body is K1's (lbm_common.cuh: the pull, the forcing of row
// ny-2 fused into it, collide_fused) with no modular wrap: every pull
// lands inside the ring. The forcing test takes the source cell's GLOBAL
// row, and the mask that cell's own planes 3, 6, 7 and not-obstacle value,
// ghost cells included. So the ring's raw values stand in for the TPU
// path's pre-forced outgoing edge columns (_force_edge_cols) and its corner
// splices (_exchange_and_align_cols), and the owner gate is not needed:
// only a cell on global row ny-2 is ever forced. The result is bitwise
// K1's on the whole grid.
//
// K3 before each step: ring_fill_kernel fills the rings of the launch's
// shards from their neighbours' cells (2 (ry + rx) + 4 cells per plane, 9
// planes), one launch for all of them; the neighbours may lie in another
// call's shards or on another card (peer addresses). A shard may be its own
// neighbour (px = 1, or a mesh of one): its ring then holds its own
// opposite edges. Across processes (lbm_shard_rows_run, a 1-D
// mesh with one shard per process): ring_fill_rows_kernel fills the ring
// from the two rows the caller received from the neighbour processes, the
// step kernel unchanged.
//
// K12: the threads that compute a shard's edge cells also store them
// straight into the ghost ring of every shard that reads them next step
// (the neighbour rows above and below, the shard's own wrapped columns), in
// the buffer those shards read next. No copy runs between steps. A write
// of step t lands in a buffer nobody reads during step t; on one stream the
// launch order puts it after the readers of step t-1 and before those of
// step t+1; across cards in one process the caller orders the streams with
// events; across processes (lbm_shard_ipc_run, one shard per process) the
// neighbours' buffers are mapped into this process with CUDA IPC and the
// streams wait on step counters (below). No block waits on another (no
// spin waits: a block that is not resident would hang the card). One card
// shows K12's result, not an overlap: its blocks run in parallel and in no
// order, so the TPU kernel's interior-first block order (_order) has no
// counterpart here.
//
// What bounds it on the H100: bytes, as K1: 76 B per cell per step (9
// planes in, 9 out, the mask), plus the ring, 2 (ry + rx) + 4 cells per
// shard per step, small beside the interior. One launch covers the shards
// of a call (blockIdx.z = shard). With every shard on one card, one C call
// issues a whole chunk; across cards the caller issues one call per step
// for each card's shards and orders the cards' streams with events.
// Per-step sums: raw (unscaled) sums per shard through
// lbm::grid_sum_last_block, reduced across shards by the caller in shard
// order, so two runs give equal bits.
//
// K3 at c16 (pallas_step.py:198-243 per row shard, ``dev=``; the JAX
// package runs it on 1-D meshes only, sharded.py:1172-1177): templated on
// the storage of lbm_common.cuh like K1. The buffers and rings hold int16
// codes; the step decodes each value it reads and encodes each value it
// writes (one rounding per step, K1's), and the ring fill copies codes
// untouched. 40 B per cell per step. The 16-bit forms run
// shard_step_pair_kernel: four cells per thread, every plane access an
// aligned 64-bit word, the x-1 and x+1 pulls rebuilt from the words of a
// lane and its neighbour. With one cell per thread a warp's 64-byte access
// of a 16-bit plane kept half the bytes of an f32 warp in flight for the
// same instructions, and halving the bytes barely moved the time. K12 takes f32 only (the JAX package
// refuses pallas-overlap at c16, sharded.py:1155-1156).
//
// K3 at bf16 (the JAX package's per-shard fused kernel on a bfloat16
// shard, 1-D meshes): the same template on lbm_common.cuh::BF16, one
// rounding per step; the ring fill copies raw bfloat16, and the lead and
// pitch are 64 elements as for int16. K12 has no bf16 form in the JAX
// package (its init_state casts the shard to f32, sharded.py:723-732):
// the sharded runner runs the f32 K12 between one cast in and one cast
// out per chunk (parallel/sharded.py), and this entry refuses bf16 in
// mode 2 as it refuses c16.
#include <cuda.h>  // libcuda's stream memory operations (lbm_shard_ipc_run)

#include <cstring>

#include "lbm_common.cuh"

namespace {

struct Mesh {
  int py, px;     // shards down and across
  int ry, rx;     // rows and columns of a shard
  int ny;         // global rows: the forcing row is ny - 2
  int pw;         // padded row pitch in elements (>= lead + rx + 1)
  int lead;       // padded column of the shard's column 0 (>= 1)
  size_t pplane;  // padded plane (ry + 2) * pw
};

// Entry p of shard z: 0 and 1 the ping-pong state buffers (elements E),
// 2 the padded not-obstacle plane (float).
template <class E>
__device__ __forceinline__ E* entry(const unsigned long long* __restrict__ table, int z, int p) {
  return reinterpret_cast<E*>(table[3 * z + p]);
}

__device__ __forceinline__ int wrap_shard(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

template <bool kDeliver, class S>
__global__ void __launch_bounds__(lbm::kThreads)
shard_step_kernel(const unsigned long long* __restrict__ table, int s0, int parity, Mesh m,
                  float* __restrict__ partials, unsigned int* __restrict__ ticket,
                  float* __restrict__ av, int av_stride, float w1a, float w2a, lbm::Relax rc,
                  S io) {
  using T = typename S::T;
  const int lz = blockIdx.z;
  const int z = s0 + lz;
  const T* __restrict__ src = entry<T>(table, z, parity);
  T* dst = entry<T>(table, z, parity ^ 1);
  const float* __restrict__ nob = entry<float>(table, z, 2);
  const int si = z / m.px, sj = z - (z / m.px) * m.px;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float u = 0.0f;
  if (x < m.rx && y < m.ry) {
    const int pr = y + 1, pc = m.lead + x;  // padded coordinates of the cell
    const int frow = m.ny - 2;
    const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
    auto rd = [&](int k, size_t s) { return io.load(src[k * m.pplane + s], k); };
    float t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int sr = pr - lbm::cy(k);
      const size_t s = (size_t)sr * m.pw + (pc - lbm::cx(k));
      float v = rd(k, s);
      if (fw[k] != 0.0f) {
        int g = si * m.ry + sr - 1;  // the source cell's global row
        g = g < 0 ? g + m.ny : (g >= m.ny ? g - m.ny : g);
        if (g == frow) {
          v = v + fw[k] * lbm::force_mask(rd(3, s), rd(6, s), rd(7, s), nob[s], w1a, w2a);
        }
      }
      t[k] = v;
    }
    const size_t c = (size_t)pr * m.pw + pc;
    const float usq = lbm::collide_fused(t, nob[c], rc);
    u = nob[c] * sqrtf(usq);
    T q[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      q[k] = io.store(t[k], k);
      dst[k * m.pplane + c] = q[k];
    }
    if (kDeliver && (y == 0 || y == m.ry - 1 || x == 0 || x == m.rx - 1)) {
      // The shard (i + ti, j + tj) sees this cell at padded
      // (pr - ti*ry, pc - tj*rx); store it where that lies on its ring
      // (row ry+1 or 0, column lead+rx or lead-1).
#pragma unroll
      for (int ti = -1; ti <= 1; ++ti) {
#pragma unroll
        for (int tj = -1; tj <= 1; ++tj) {
          if (ti == 0 && tj == 0) continue;
          const int qr = pr - ti * m.ry, qc = pc - tj * m.rx;
          const bool row_ok = ti == 0 ? true : (ti < 0 ? qr == m.ry + 1 : qr == 0);
          const bool col_ok = tj == 0 ? true : (tj < 0 ? qc == m.lead + m.rx : qc == m.lead - 1);
          if (!row_ok || !col_ok) continue;
          const int tz = wrap_shard(si + ti, m.py) * m.px + wrap_shard(sj + tj, m.px);
          T* out = entry<T>(table, tz, parity ^ 1);
          const size_t o = (size_t)qr * m.pw + qc;
#pragma unroll
          for (int k = 0; k < 9; ++k) out[k * m.pplane + o] = q[k];
        }
      }
    }
  }
  const unsigned int nblocks = gridDim.x * gridDim.y;
  lbm::grid_sum_last_block(u, partials + (size_t)lz * nblocks, ticket + lz, 1.0f,
                           av + (size_t)lz * av_stride);
}

// Cells per thread of K3's 16-bit forms: one 64-bit word of each plane
// (lbm_common.cuh::Word, shared with the word forms of K1 and K2).
constexpr int kPairCells = lbm::kWordCells;

// K3's 16-bit forms (c16, bf16): shard_step_kernel<false>'s step with
// kPairCells cells per thread along x, so a warp covers 128 columns, two
// whole 128-byte lines of each 16-bit plane, and every load and store of a
// plane is an aligned 64-bit word (two 32-bit halves, each an aligned pair
// of cells). The x-1 and x+1 pulls are built from the lane's own word and
// the neighbour lane's edge half (a shuffle, then Word::shifted_in_prev or
// shifted_in_next); lane 0 and lane 31 load the one half outside the warp's
// span (the ring column at lead-1 or lead+rx, or the next warp's first
// word). A warp is one row, so the forcing test is warp-uniform; the rare
// forcing row reads the mask's planes per cell as shard_step_kernel does. The cell arithmetic is
// shard_step_kernel's (the decode of each element, the forcing, collide_fused,
// the encode), so the state is bitwise K1's; a thread adds its cells' |u| in
// cell order before the block tree. A row whose last word holds the right
// ghost column (rx not a multiple of 4) stores its last cells one by one,
// never over the ghost. The launch bounds ask for four blocks per SM, which
// holds a thread to 64 registers.
template <class S>
__global__ void __launch_bounds__(lbm::kThreads, 4)
shard_step_pair_kernel(const unsigned long long* __restrict__ table, int s0, int parity, Mesh m,
                       float* __restrict__ partials, unsigned int* __restrict__ ticket,
                       float* __restrict__ av, int av_stride, float w1a, float w2a,
                       lbm::Relax rc, S io) {
  using T = typename S::T;
  static_assert(sizeof(T) == 2, "the paired step takes 16-bit storage");
  using W = lbm::Word;
  const int lz = blockIdx.z;
  const int z = s0 + lz;
  const T* __restrict__ src = entry<T>(table, z, parity);
  T* dst = entry<T>(table, z, parity ^ 1);
  const float* __restrict__ nob = entry<float>(table, z, 2);
  const int si = z / m.px;
  const int lane = threadIdx.x;
  const int x0 = kPairCells * (blockIdx.x * blockDim.x + lane);  // the thread's first cell
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float u = 0.0f;
  if (y < m.ry) {  // warp-uniform: a warp is one row of cells
    const int pr = y + 1, pc = m.lead + x0;  // padded coordinates of the first cell
    // The words hold a cell or the right ghost column; further words are
    // left unread (they may lie past the last row of the allocation).
    const bool loads = x0 <= m.rx;
    const int frow = m.ny - 2;
    const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
    float t[kPairCells][9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int sr = pr - lbm::cy(k);
      const T* row = src + k * m.pplane + (size_t)sr * m.pw;
      W w{};
      if (loads) w.load(row + pc);
      W pulled = w;  // elements pc - cx(k) .. pc - cx(k) + 3
      if (lbm::cx(k) == 1) {
        uint32_t prev = __shfl_up_sync(0xffffffffu, w.h[1], 1);
        if (lane == 0 && loads) prev = *reinterpret_cast<const uint32_t*>(row + pc - 2);
        pulled = w.shifted_in_prev(prev);
      } else if (lbm::cx(k) == -1) {
        uint32_t next = __shfl_down_sync(0xffffffffu, w.h[0], 1);
        if (lane == 31 && x0 + kPairCells <= m.rx) {
          next = *reinterpret_cast<const uint32_t*>(row + pc + kPairCells);
        }
        pulled = w.shifted_in_next(next);
      }
#pragma unroll
      for (int c = 0; c < kPairCells; ++c) t[c][k] = io.load(lbm::raw_of<T>(pulled.cell(c)), k);
      if (fw[k] != 0.0f) {
        int g = si * m.ry + sr - 1;  // the source cells' global row
        g = g < 0 ? g + m.ny : (g >= m.ny ? g - m.ny : g);
        if (g == frow) {
          auto rd = [&](int q, size_t s) { return io.load(src[q * m.pplane + s], q); };
#pragma unroll
          for (int c = 0; c < kPairCells; ++c) {
            if (x0 + c >= m.rx) continue;
            const size_t s = (size_t)sr * m.pw + (pc + c - lbm::cx(k));
            t[c][k] = t[c][k] + fw[k] * lbm::force_mask(rd(3, s), rd(6, s), rd(7, s), nob[s],
                                                        w1a, w2a);
          }
        }
      }
    }
    const size_t cidx = (size_t)pr * m.pw + pc;
    float nb[kPairCells] = {};
    if (loads) lbm::load_mask(nob + cidx, nb);
#pragma unroll
    for (int c = 0; c < kPairCells; ++c) {
      if (x0 + c < m.rx) {
        const float usq = lbm::collide_fused(t[c], nb[c], rc);
        u += nb[c] * sqrtf(usq);
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      T* drow = dst + k * m.pplane + cidx;
      if (x0 + kPairCells <= m.rx) {
        W out;
#pragma unroll
        for (int c = 0; c < kPairCells; ++c) out.set_cell(c, lbm::bits_of(io.store(t[c][k], k)));
        out.store(drow);
      } else {
#pragma unroll
        for (int c = 0; c < kPairCells; ++c) {
          if (x0 + c < m.rx) drow[c] = io.store(t[c][k], k);
        }
      }
    }
  }
  const unsigned int nblocks = gridDim.x * gridDim.y;
  lbm::grid_sum_last_block(u, partials + (size_t)lz * nblocks, ticket + lz, 1.0f,
                           av + (size_t)lz * av_stride);
}

// Fills the ring of entry p (0, 1: 9 planes of E; 2: the float
// not-obstacle plane) of shards [s0, s0 + gridDim.y) from their
// neighbours' cells, copying the raw elements.
template <class E>
__global__ void ring_fill_kernel(const unsigned long long* __restrict__ table, int s0, int p,
                                 Mesh m) {
  const int z = s0 + blockIdx.y;
  const int si = z / m.px, sj = z - (z / m.px) * m.px;
  const int planes = p == 2 ? 1 : 9;
  const int rw = m.rx + 2;  // ring row width
  const int nring = 2 * rw + 2 * m.ry;
  E* dst = entry<E>(table, z, p);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < planes * nring;
       i += gridDim.x * blockDim.x) {
    const int k = i / nring;
    const int e = i - k * nring;
    int pr, rc;  // padded row, ring column (0 = the left ghost, rx + 1 the right)
    if (e < rw) {
      pr = 0;
      rc = e;
    } else if (e < 2 * rw) {
      pr = m.ry + 1;
      rc = e - rw;
    } else {
      const int e2 = e - 2 * rw;
      pr = 1 + (e2 >> 1);
      rc = (e2 & 1) ? m.rx + 1 : 0;
    }
    const int di = pr == 0 ? -1 : (pr == m.ry + 1 ? 1 : 0);
    const int dj = rc == 0 ? -1 : (rc == m.rx + 1 ? 1 : 0);
    const int pc = m.lead - 1 + rc;
    const int nz = wrap_shard(si + di, m.py) * m.px + wrap_shard(sj + dj, m.px);
    const E* src = entry<E>(table, nz, p);
    const size_t from = (size_t)(pr - di * m.ry) * m.pw + (pc - dj * m.rx);
    dst[k * m.pplane + (size_t)pr * m.pw + pc] = src[k * m.pplane + from];
  }
}

// Fills the state ring of entry p (0 or 1) of shards [s0, s0 + gridDim.y)
// of a 1-D row mesh (px = 1) whose neighbours live in other processes:
// ``rows`` holds, per shard, (2, 9, rx) raw elements received from them,
// the previous shard's last row and the next shard's first row. They fill
// padded rows 0 and ry + 1, their columns wrapped (the corners are their
// last and first cells); the left and right ghost columns of rows 1..ry
// come from the shard's own cells, wrapped. The ring is ring_fill_kernel's
// for px = 1, element for element, with the neighbour rows read from the
// buffer in place of the neighbours' state. Like that fill it moves 9 x
// (2 (ry + rx) + 4) elements, a launch's latency more than its bytes; across
// processes the step's cost is the swap of the two rows around it.
template <class E>
__global__ void ring_fill_rows_kernel(const unsigned long long* __restrict__ table, int s0,
                                      int p, Mesh m, const E* __restrict__ rows) {
  const int lz = blockIdx.y;
  E* buf = entry<E>(table, s0 + lz, p);  // the ring is written, the cells read
  const E* __restrict__ got = rows + (size_t)lz * 2 * 9 * m.rx;
  const int rw = m.rx + 2;  // ring row width
  const int nring = 2 * rw + 2 * m.ry;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 9 * nring;
       i += gridDim.x * blockDim.x) {
    const int k = i / nring;
    const int e = i - k * nring;
    int pr, rc;  // padded row, ring column (0 = the left ghost, rx + 1 the right)
    if (e < rw) {
      pr = 0;
      rc = e;
    } else if (e < 2 * rw) {
      pr = m.ry + 1;
      rc = e - rw;
    } else {
      const int e2 = e - 2 * rw;
      pr = 1 + (e2 >> 1);
      rc = (e2 & 1) ? m.rx + 1 : 0;
    }
    const int col = rc == 0 ? m.rx - 1 : (rc == m.rx + 1 ? 0 : rc - 1);  // wrapped
    E v;
    if (pr == 0) {
      v = got[k * m.rx + col];
    } else if (pr == m.ry + 1) {
      v = got[(9 + k) * m.rx + col];
    } else {
      v = buf[k * m.pplane + (size_t)pr * m.pw + m.lead + col];
    }
    buf[k * m.pplane + (size_t)pr * m.pw + m.lead - 1 + rc] = v;
  }
}

// The state ring fill of entry p from received rows (ring_fill_rows_kernel).
template <class E>
int fill_rows(const unsigned long long* table, int s0, int count, int p, const Mesh& m,
              const E* rows, cudaStream_t st) {
  const int per = 9 * (2 * (m.rx + 2) + 2 * m.ry);
  const dim3 grid((per + lbm::kThreads - 1) / lbm::kThreads, count);
  lbm::count_launch();
  ring_fill_rows_kernel<E><<<grid, lbm::kThreads, 0, st>>>(table, s0, p, m, rows);
  return static_cast<int>(cudaGetLastError());
}

// The ring fill of entry p; E is the state's element.
template <class E>
int fill(const unsigned long long* table, int s0, int count, int p, const Mesh& m,
         cudaStream_t st) {
  const int nring = 2 * (m.rx + 2) + 2 * m.ry;
  const int per = (p == 2 ? 1 : 9) * nring;
  const dim3 grid((per + lbm::kThreads - 1) / lbm::kThreads, count);
  if (p == 2) {
    lbm::count_launch();
    ring_fill_kernel<float><<<grid, lbm::kThreads, 0, st>>>(table, s0, p, m);
  } else {
    lbm::count_launch();
    ring_fill_kernel<E><<<grid, lbm::kThreads, 0, st>>>(table, s0, p, m);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int run(const unsigned long long* table, int s0, int count, const Mesh& m, float* av,
        int av_stride, float* partials, unsigned int* ticket, int parity, int n_steps, int mode,
        int fill_first, float w1a, float w2a, const lbm::Relax& rc, cudaStream_t st,
        const S& io, const void* rows = nullptr) {
  using T = typename S::T;
  int err = 0;
  if (fill_first) {
    if ((err = fill<T>(table, s0, count, 2, m, st)) != 0) return err;
    if (mode == 2 && (err = fill<T>(table, s0, count, parity & 1, m, st)) != 0) return err;
  }
  dim3 grid = lbm::grid_for(m.ry, m.rx);
  grid.z = count;
  const dim3 block(lbm::kBlockX, lbm::kBlockY);
  for (int t = 0; t < n_steps; ++t) {
    const int p = (parity + t) & 1;
    if (mode == 2) {
      lbm::count_launch();
      shard_step_kernel<true, S><<<grid, block, 0, st>>>(table, s0, p, m, partials, ticket,
                                                         av + t, av_stride, w1a, w2a, rc, io);
    } else {
      err = rows != nullptr ? fill_rows<T>(table, s0, count, p, m, static_cast<const T*>(rows), st)
                            : fill<T>(table, s0, count, p, m, st);
      if (err != 0) return err;
      if constexpr (sizeof(T) == 2) {
        const int span = lbm::kBlockX * kPairCells;  // columns of a block
        lbm::count_launch();
        shard_step_pair_kernel<S><<<dim3((m.rx + span - 1) / span, grid.y, count), block, 0, st>>>(
            table, s0, p, m, partials, ticket, av + t, av_stride, w1a, w2a, rc, io);
      } else {
        lbm::count_launch();
        shard_step_kernel<false, S><<<grid, block, 0, st>>>(table, s0, p, m, partials, ticket,
                                                            av + t, av_stride, w1a, w2a, rc, io);
      }
    }
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  return 0;
}

}  // namespace

// Runs n_steps steps of shards [s0, s0 + count) of a py x px mesh of
// ry x rx shards (global ny rows), each buffer (9, ry + 2, pitch) with
// column 0 of the shard at padded column lead (both in elements). table:
// 3 * py * px addresses on the launching device (buffer 0, buffer 1, padded
// not-obstacle plane of each shard). Step t reads buffer (parity + t) % 2
// and writes the other. mode 1 (K3): fill the call's state rings from the
// neighbours' cells before each step; mode 2 (K12): the step kernel stores
// edge cells into the readers' rings. fill_first: fill the call's
// not-obstacle rings (and, in mode 2, its state rings) before the first
// step. A fill reads the neighbours' cells, so the caller orders a call
// after the previous step of the calls that hold its neighbours. av
// receives count x n_steps raw sums (shard-major, av_stride apart);
// partials count x lbm_step_num_blocks(ry, rx) floats; ticket count zeroed
// unsigned ints. storage: the buffers' storage (lbm_common.cuh::Storage:
// f32, c16 int16 codes or bf16; mode 1 only for the 16-bit ones). Returns
// the first CUDA error, or 0.
extern "C" int lbm_shard_run(const unsigned long long* table, int s0, int count, int py, int px,
                             int ry, int rx, int ny, int pitch, int lead, float* av,
                             int av_stride, float* partials,
                             unsigned int* ticket, int parity, int n_steps, int mode,
                             int fill_first, float w1a, float w2a, float beta, float ow0,
                             float ow1, float ow2, const lbm::Storage* storage, void* stream) {
  const Mesh m{py, px, ry, rx, ny, pitch, lead, (size_t)(ry + 2) * pitch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count < 1 || s0 < 0 || s0 + count > py * px || mode < 1 || mode > 2 || lead < 1 ||
      pitch < lead + rx + 1 || storage == nullptr ||
      (storage->kind != lbm::kStorageF32 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  return lbm::with_storage(storage, [&](const auto& io) {
    return run(table, s0, count, m, av, av_stride, partials, ticket, parity, n_steps, mode,
               fill_first, w1a, w2a, rc, st, io);
  });
}

// K3 on shards [s0, s0 + count) of a 1-D row mesh of py shards (px = 1)
// whose neighbour shards live in other processes: one step, its state ring
// filled from ``rows`` (per shard (2, 9, rx) raw elements: the previous
// shard's last row, the next shard's first row, received by the caller)
// and the shards' own wrapped columns, then K3's step. table, buffers,
// parity, av, partials, ticket and storage as lbm_shard_run (the table
// needs only the call's shards); the not-obstacle rings are the caller's
// (filled before the first call). Returns the first CUDA error, or 0.
extern "C" int lbm_shard_rows_run(const unsigned long long* table, int s0, int count, int py,
                                  int ry, int rx, int ny, int pitch, int lead, const void* rows,
                                  float* av, int av_stride, float* partials,
                                  unsigned int* ticket, int parity, float w1a, float w2a,
                                  float beta, float ow0, float ow1, float ow2,
                                  const lbm::Storage* storage, void* stream) {
  const Mesh m{py, 1, ry, rx, ny, pitch, lead, (size_t)(ry + 2) * pitch};
  if (count < 1 || s0 < 0 || s0 + count > py || lead < 1 || pitch < lead + rx + 1 ||
      rows == nullptr || storage == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  return lbm::with_storage(storage, [&](const auto& io) {
    return run(table, s0, count, m, av, av_stride, partials, ticket, parity, 1, 1, 0, w1a, w2a,
               rc, static_cast<cudaStream_t>(stream), io, rows);
  });
}

// Lets the current device read and write the memory of device ``peer``
// (K12's stores into a neighbour shard on another card). Returns 0 when
// access is on, else the CUDA error.
extern "C" int lbm_enable_peer(int device, int peer) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

// K12 across processes: a 1-D row mesh of `world` shards, one per process
// (parallel/multihost.py, --backend pallas-overlap; ops/shard_step.py::
// IpcRowShard). Each process holds its shard in one allocation of its own
// (cudaMalloc, not torch's caching allocator, whose blocks are
// sub-allocations that cudaIpcGetMemHandle cannot export on their own):
// buffer 0, buffer 1, the padded not-obstacle plane and an inbox of two
// step counters (lbm_shard_ipc_layout). It exports the allocation with
// cudaIpcGetMemHandle; its neighbours open the handle with
// cudaIpcOpenMemHandle(cudaIpcMemLazyEnablePeerAccess), so the table row of
// a neighbour shard holds that shard's buffers as mapped into this process,
// and K12's stores into the neighbours' rings, unchanged, reach the other
// processes' memory (on this card, or on a peer card over NVLink).
//
// The order between processes is kept on the streams, never by the host
// and never by a block: step s (numbered from 1 over the whole run) reads
// this shard's ring, which the neighbours wrote in their step s-1, and
// writes the neighbours' rings in the buffer they read in their step s-1.
// So before step s the stream waits until both neighbours have finished
// step s-1 (cuStreamWaitValue32, GEQ); after step s it tells them it has
// finished (cuStreamWriteValue32). Each process writes THE NEIGHBOURS'
// counters and waits on its OWN: inbox word 0 is written by the previous
// shard, word 1 by the next one (a rank writes word 0 of its next shard's
// inbox and word 1 of its previous one's). The wait thus polls this
// card's memory, also when the neighbour is on another card. With two shards the
// previous and the next are one process: it writes word 0 alone, and the
// stream waits on word 0 alone. The write is issued without
// CU_STREAM_WRITE_VALUE_NO_MEMORY_BARRIER, so it is preceded by a fence
// scoped to the stream with __threadfence_system()'s semantics: the
// kernel's remote ring stores are visible to the neighbour before the
// counter says step s is done. These waits run in the card's front end: no
// kernel polls a flag, so two processes that time-slice one card cannot
// deadlock on each other's kernels. A neighbour that stops leaves the
// stream waiting; the host waits for it with a deadline, then releases the
// stream (lbm_shard_ipc_release: the inbox set past every step, so the
// queued steps run out and the process can exit) and raises.
namespace {

struct IpcLayout {
  size_t buf0, buf1, nob, inbox, bytes;
};

IpcLayout ipc_layout(int ry, int pitch) {
  const size_t plane = (size_t)(ry + 2) * pitch * sizeof(float);
  auto up = [](size_t v) { return (v + 511) & ~size_t(511); };
  IpcLayout l;
  l.buf0 = 0;
  l.buf1 = up(9 * plane);
  l.nob = l.buf1 + up(9 * plane);
  l.inbox = l.nob + up(plane);
  l.bytes = l.inbox + 512;
  return l;
}

}  // namespace

// Byte offsets in one shard's allocation of buffer 0, buffer 1, the padded
// not-obstacle plane and the inbox (two unsigned ints), and its size, for
// f32 buffers of (9, ry + 2, pitch): out[0..4].
extern "C" int lbm_shard_ipc_layout(int ry, int pitch, unsigned long long* out) {
  if (ry < 1 || pitch < 1 || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const IpcLayout l = ipc_layout(ry, pitch);
  out[0] = l.buf0;
  out[1] = l.buf1;
  out[2] = l.nob;
  out[3] = l.inbox;
  out[4] = l.bytes;
  return 0;
}

// Allocates `bytes` on the current device, zeroes them (the inbox starts at
// step 0) and exports them: *base the address, handle the
// cudaIpcMemHandle_t (CUDA_IPC_HANDLE_SIZE bytes). The zeroing is queued
// on the legacy stream; the caller synchronises before it hands the handle
// out.
extern "C" int lbm_shard_ipc_alloc(unsigned long long bytes, unsigned long long* base,
                                   void* handle) {
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, bytes);
  if (err == cudaSuccess) err = cudaMemset(p, 0, bytes);
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, p);
  if (err != cudaSuccess) {
    if (p != nullptr) cudaFree(p);
    return static_cast<int>(err);
  }
  std::memcpy(handle, &h, sizeof(h));
  *base = reinterpret_cast<unsigned long long>(p);
  return 0;
}

// Maps another process's allocation into this one: *base its address here.
extern "C" int lbm_shard_ipc_open(const void* handle, unsigned long long* base) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  const cudaError_t err = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  *base = reinterpret_cast<unsigned long long>(p);
  return static_cast<int>(err);
}

// Unmaps an allocation that lbm_shard_ipc_open mapped.
extern "C" int lbm_shard_ipc_close(unsigned long long base) {
  return static_cast<int>(cudaIpcCloseMemHandle(reinterpret_cast<void*>(base)));
}

// Frees this process's allocation: only once every neighbour has unmapped it.
extern "C" int lbm_shard_ipc_free(unsigned long long base) {
  return static_cast<int>(cudaFree(reinterpret_cast<void*>(base)));
}

// Copies `bytes` between two device addresses on `stream` (the upload of
// the shard into the allocation, and its state out of it).
extern "C" int lbm_shard_ipc_copy(unsigned long long dst, unsigned long long src,
                                  unsigned long long bytes, void* stream) {
  return static_cast<int>(cudaMemcpyAsync(reinterpret_cast<void*>(dst),
                                          reinterpret_cast<const void*>(src), bytes,
                                          cudaMemcpyDeviceToDevice,
                                          static_cast<cudaStream_t>(stream)));
}

// Sets both words of this shard's inbox past every step number, from a
// stream of its own that does not wait for the shard's stream: the waits
// queued there pass, so the stream runs out. The error path of a rank
// whose neighbour stopped: the steps that run then compute nothing
// meaningful, and the caller raises. GEQ is a cyclic comparison
// ((int32_t)(*addr - value) >= 0), so the words become 0x7f7f7f7f, ahead
// of every step number below it, not 0xffffffff, which is behind them.
extern "C" int lbm_shard_ipc_release(unsigned long long inbox) {
  cudaStream_t side;
  cudaError_t err = cudaStreamCreateWithFlags(&side, cudaStreamNonBlocking);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(reinterpret_cast<void*>(inbox), 0x7f, 2 * sizeof(cuuint32_t), side);
  const cudaError_t sync = cudaStreamSynchronize(side);
  cudaStreamDestroy(side);
  return static_cast<int>(err != cudaSuccess ? err : sync);
}

// Issues steps done + 1 .. done + n_steps of shard `rank` of a 1-D row mesh
// of `world` shards (one per process) on `stream`, in one call: per step
// the waits on this shard's inbox (`inbox`: word 0; and word 1 when
// `to_prev` is not 0), K12 (shard_step_kernel<true>, its table rows of the
// neighbour shards mapped from the other processes), and the writes of the
// step's number to the neighbours' inboxes (`to_next`: word 0 of the next
// shard's; `to_prev`: word 1 of the previous shard's, 0 when the previous
// and the next shard are one). The first step of the run (done == 0) fills
// the not-obstacle ring and the state ring of buffer 0 first, reading the
// neighbours' cells through the table; every process has uploaded its
// shard before any of them calls this. av receives n_steps raw sums;
// table, partials, ticket and the scalars as lbm_shard_run (f32 only).
// Returns the first CUDA error (a libcuda error as its CUresult), or 0.
extern "C" int lbm_shard_ipc_run(const unsigned long long* table, int rank, int world, int ry,
                                 int rx, int ny, int pitch, int lead, unsigned long long inbox,
                                 unsigned long long to_next, unsigned long long to_prev, int done,
                                 int n_steps, float* av, float* partials, unsigned int* ticket,
                                 float w1a, float w2a, float beta, float ow0, float ow1,
                                 float ow2, void* stream) {
  const Mesh m{world, 1, ry, rx, ny, pitch, lead, (size_t)(ry + 2) * pitch};
  if (world < 1 || rank < 0 || rank >= world || lead < 1 || pitch < lead + rx + 1 || done < 0 ||
      n_steps < 0 || (long long)done + n_steps >= 0x7f7f7f7fLL || inbox == 0 || to_next == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUstream cs = static_cast<CUstream>(stream);
  for (int i = 0; i < n_steps; ++i) {
    const cuuint32_t s = static_cast<cuuint32_t>(done + i + 1);  // this step's number
    CUresult r = CUDA_SUCCESS;
    if (s > 1) {
      r = cuStreamWaitValue32(cs, inbox, s - 1, CU_STREAM_WAIT_VALUE_GEQ);
      if (r == CUDA_SUCCESS && to_prev != 0) {
        r = cuStreamWaitValue32(cs, inbox + sizeof(cuuint32_t), s - 1, CU_STREAM_WAIT_VALUE_GEQ);
      }
      if (r != CUDA_SUCCESS) return static_cast<int>(r);
    }
    const int err = run(table, rank, 1, m, av + i, 1, partials, ticket, (done + i) & 1, 1, 2,
                        done + i == 0, w1a, w2a, rc, st, lbm::F32());
    if (err != 0) return err;
    r = cuStreamWriteValue32(cs, to_next, s, CU_STREAM_WRITE_VALUE_DEFAULT);
    if (r == CUDA_SUCCESS && to_prev != 0) {
      r = cuStreamWriteValue32(cs, to_prev, s, CU_STREAM_WRITE_VALUE_DEFAULT);
    }
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  return 0;
}
