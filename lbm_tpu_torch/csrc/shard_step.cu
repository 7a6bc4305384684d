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
// two lines). At c16 a warp's 32 codes are half a line. A table on the
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
// opposite edges.
//
// K12: the threads that compute a shard's edge cells also store them
// straight into the ghost ring of every shard that reads them next step
// (the neighbour rows above and below, the shard's own wrapped columns), in
// the buffer those shards read next. No copy runs between steps. A write
// of step t lands in a buffer nobody reads during step t; on one stream the
// launch order puts it after the readers of step t-1 and before those of
// step t+1, and across cards the caller orders the streams with events.
// No block waits on another (no spin waits: a block that is not resident
// would hang the card). One card shows K12's result, not an overlap: its
// blocks run in parallel and in no order, so the TPU kernel's
// interior-first block order (_order) has no counterpart here.
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
// untouched. 40 B per cell per step. K12 takes f32 only (the JAX package
// refuses pallas-overlap at c16, sharded.py:1155-1156).
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

// The ring fill of entry p; E is the state's element.
template <class E>
int fill(const unsigned long long* table, int s0, int count, int p, const Mesh& m,
         cudaStream_t st) {
  const int nring = 2 * (m.rx + 2) + 2 * m.ry;
  const int per = (p == 2 ? 1 : 9) * nring;
  const dim3 grid((per + lbm::kThreads - 1) / lbm::kThreads, count);
  if (p == 2) {
    ring_fill_kernel<float><<<grid, lbm::kThreads, 0, st>>>(table, s0, p, m);
  } else {
    ring_fill_kernel<E><<<grid, lbm::kThreads, 0, st>>>(table, s0, p, m);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int run(const unsigned long long* table, int s0, int count, const Mesh& m, float* av,
        int av_stride, float* partials, unsigned int* ticket, int parity, int n_steps, int mode,
        int fill_first, float w1a, float w2a, const lbm::Relax& rc, cudaStream_t st,
        const S& io) {
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
      shard_step_kernel<true, S><<<grid, block, 0, st>>>(table, s0, p, m, partials, ticket,
                                                         av + t, av_stride, w1a, w2a, rc, io);
    } else {
      if ((err = fill<T>(table, s0, count, p, m, st)) != 0) return err;
      shard_step_kernel<false, S><<<grid, block, 0, st>>>(table, s0, p, m, partials, ticket,
                                                          av + t, av_stride, w1a, w2a, rc, io);
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
// unsigned ints. codec: null for f32 buffers, else the 12 floats of c16
// storage (DevSpec.codec) and int16 buffers (mode 1 only). Returns the
// first CUDA error, or 0.
extern "C" int lbm_shard_run(const unsigned long long* table, int s0, int count, int py, int px,
                             int ry, int rx, int ny, int pitch, int lead, float* av,
                             int av_stride, float* partials,
                             unsigned int* ticket, int parity, int n_steps, int mode,
                             int fill_first, float w1a, float w2a, float beta, float ow0,
                             float ow1, float ow2, const float* codec, void* stream) {
  const Mesh m{py, px, ry, rx, ny, pitch, lead, (size_t)(ry + 2) * pitch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count < 1 || s0 < 0 || s0 + count > py * px || mode < 1 || mode > 2 || lead < 1 ||
      pitch < lead + rx + 1 || (codec != nullptr && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  if (codec != nullptr) {
    return run(table, s0, count, m, av, av_stride, partials, ticket, parity, n_steps, mode,
               fill_first, w1a, w2a, rc, st, lbm::make_c16(codec));
  }
  return run(table, s0, count, m, av, av_stride, partials, ticket, parity, n_steps, mode,
             fill_first, w1a, w2a, rc, st, lbm::F32());
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
