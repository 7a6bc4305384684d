// K4: many whole-grid steps per launch, in one persistent cooperative grid.
//
// Replaces: lbm_tpu/ops/pallas_resident.py::_mega_kernel (with
// _make_mega_call), up to 255 steps per call with the whole state in VMEM,
// ping-ponging between the input and output windows.
//
// What bounds it on the H100: below ~590^2 cells a copy of the state is at
// most 12.5 MB, so both copies stay in the 50 MB L2 and a step costs its L2
// traffic (76 B per cell) plus one grid-wide barrier; above that it streams
// from HBM like K1. On small grids the barrier is the cost that matters:
// K1 pays a kernel launch per step instead.
//
// What the design does about it: one cooperative launch per chunk of steps,
// with the grid sized to what the card holds at once (occupancy x SMs,
// never more than one thread per cell). Each block keeps one fixed slab of
// consecutive cells for the whole chunk; every step it runs K1's cell body
// (lbm_common.cuh::pull_collide, the forcing fused into the pulls from row
// ny-2) from one buffer into the other, reading through L2 (another block
// wrote those lines since this SM last read them), then the whole grid
// meets at grid.sync(). No step writes the buffer it reads, so the forcing
// mask needs no extra pass. Per-step sums: each block writes its partial to
// partials[step][block]; after the chunk, block b reduces steps b, b + G,
// ... over all blocks in a fixed order, so two runs are bitwise equal (no
// float atomics). A grid larger than the card can hold at once is refused
// by cudaLaunchCooperativeKernel, and the error is returned, never a
// smaller grid.
#include <cooperative_groups.h>

#include "band_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// Fixed-order block sum of one value per thread; valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sm) {
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) sm[threadIdx.x] += sm[threadIdx.x + s];
    __syncthreads();
  }
  const float total = sm[0];
  __syncthreads();  // sm is reused by the next call
  return total;
}

__global__ void __launch_bounds__(kThreads)
resident_kernel(float* buf_a, float* buf_b, const float* __restrict__ nobst,
                float* __restrict__ partials, float* __restrict__ av, int ny, int nx, int steps,
                int first_parity, float w1a, float w2a, lbm::Relax rc, float inv_tot) {
  __shared__ float sm[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nblocks = gridDim.x;
  const long long ncell = (long long)ny * nx;
  const long long per = (ncell + nblocks - 1) / nblocks;
  const long long c0 = per * blockIdx.x;
  const long long c1 = c0 + per < ncell ? c0 + per : ncell;
  const size_t plane = (size_t)ncell;
  // The first cell of this thread, and the row/column step of a stride of
  // kThreads cells, so the loop needs no division per cell.
  const long long first = c0 + threadIdx.x;
  const int y_start = (int)(first / nx);
  const int x_start = (int)(first - (long long)y_start * nx);
  const int dy = kThreads / nx;
  const int dx = kThreads - dy * nx;
  for (int st = 0; st < steps; ++st) {
    const bool odd = ((first_parity + st) & 1) != 0;
    const float* src = odd ? buf_b : buf_a;
    float* dst = odd ? buf_a : buf_b;
    float acc = 0.0f;
    int y = y_start, x = x_start;
    for (long long c = first; c < c1; c += kThreads) {
      float t[9];
      const float usq = lbm::pull_collide<true>(src, nobst, ny, nx, y, x, w1a, w2a, rc, t);
#pragma unroll
      for (int k = 0; k < 9; ++k) dst[k * plane + c] = t[k];
      acc += nobst[c] * sqrtf(usq);
      x += dx;
      y += dy;
      if (x >= nx) {
        x -= nx;
        ++y;
      }
    }
    const float total = block_sum(acc, sm);
    if (threadIdx.x == 0) partials[(size_t)st * nblocks + blockIdx.x] = total;
    grid.sync();
  }
  // Every block's partials of every step are written: reduce each step's
  // row in a fixed order.
  for (int st = blockIdx.x; st < steps; st += nblocks) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < nblocks; b += kThreads) acc += __ldcg(partials + (size_t)st * nblocks + b);
    const float total = block_sum(acc, sm);
    if (threadIdx.x == 0) av[st] = total * inv_tot;
  }
}

// ---------------------------------------------------------------------------
// K4, shared-memory form: the state held on the SMs, one grid barrier per T
// steps.
//
// What bounds the form above on small grids is the barrier: every step
// reads the whole state from one global buffer, writes it to the other and
// meets the whole grid at grid.sync(), about 2 us per step whatever the
// grid's size (PERF.md). This form pays a barrier per T steps instead.
//
// Block b owns the whole rows [b*B, b*B + B) (the last block fewer). For
// the whole launch it keeps in dynamic shared memory its rows, T ghost rows
// above and T below (global rows wrapped), two f32 copies of the 9 planes
// (pull, ping-pong) and the not-obstacle values, 76 B per window cell. A
// pass of L <= T steps runs inside the window with __syncthreads() between
// steps; step s (1..L) updates only window rows [T-L+s, T+bi+L-s), the rows
// whose inputs are still valid (the trapezoid of csrc/trapezoid.cuh, in y
// only: a full row wraps exactly in x, so there is no x halo). After the
// pass the block writes its own rows within T of either edge to an exchange
// buffer laid out as the grid (9, ny, nx), double-buffered by pass parity,
// meets the grid at one grid.sync(), and reads its ghost rows back from it
// by global row, so a slab of fewer than T rows takes its ghosts from as
// many neighbours as hold them. Per T steps: one barrier and 2T rows per
// block through L2. The state leaves shared memory once per launch.
//
// The cell body is K1's (pull_collide with the forcing of row ny-2 fused
// into every pull from a window row whose global row is ny-2, ghost rows
// included); sums as the form above: each block adds its own rows'
// nob*|u| per step in a fixed order into partials[step][block], reduced
// after the chunk in a fixed order, so two runs are bitwise equal.
constexpr int kSmemThreads = 512;  // blocks of 768 or 1,024 threads ran slower on an H100
static_assert((kSmemThreads & (kSmemThreads - 1)) == 0, "smem_cells takes a power of 2");
constexpr int kSmemWarps = kSmemThreads / 32;

// Dynamic shared memory of a block (ops/resident.py::resident_smem_bytes
// must agree): two copies of 9 planes and the not-obstacle plane of a
// (rows + 2 depth) x nx window, the global row of each window row, and the
// per-step, per-warp partial sums.
inline size_t smem_form_bytes(int nx, int rows, int depth) {
  const size_t wh = (size_t)rows + 2 * depth;
  return sizeof(float) * (19 * wh * nx) + sizeof(int) * wh + sizeof(float) * kSmemWarps * depth;
}

// A thread's walk over the cells of whole rows of nx cells: the row/column
// step of a stride of kSmemThreads cells, computed once per launch.
struct Walk {
  int dr, dc, nx;
};

__device__ __forceinline__ Walk walk(int nx) {
  const int dr = kSmemThreads / nx;
  return Walk{dr, kSmemThreads - dr * nx, nx};
}

// Calls f(r, c) for the cells of window rows [r0, r0 + rows), cell (r, c)
// on thread ((r - anchor) * nx + c) mod kSmemThreads, each thread in
// increasing order: the cells of a row go to the same threads in the same
// order whatever r0, so a step's sum over the block's own rows (anchor T)
// adds its terms in one order however the passes fall (a run resumed
// mid-pass gives the uninterrupted av series bit for bit).
template <class F>
__device__ __forceinline__ void smem_cells(const Walk& w, int r0, int rows, int anchor, F&& f) {
  const int lo = (r0 - anchor) * w.nx, hi = lo + rows * w.nx;
  int j = lo + (((int)threadIdx.x - lo) & (kSmemThreads - 1));  // mod kSmemThreads, a power of 2
  if (j >= hi) return;
  const int q = j >= 0 ? j / w.nx : -((w.nx - 1 - j) / w.nx);  // floor(j / nx)
  int r = anchor + q, c = j - q * w.nx;
  for (; j < hi; j += kSmemThreads) {
    f(r, c);
    c += w.dc;
    r += w.dr;
    if (c >= w.nx) {
      c -= w.nx;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kSmemThreads, 1)
resident_smem_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     float* __restrict__ exch, const float* __restrict__ nobst,
                     float* __restrict__ partials, float* __restrict__ av, int ny, int nx,
                     int B, int T, int steps, float w1a, float w2a, lbm::Relax rc,
                     float inv_tot) {
  extern __shared__ float smem[];
  __shared__ float sm[kSmemWarps];
  cg::grid_group grid = cg::this_grid();
  const int whmax = B + 2 * T;
  const int wcells = whmax * nx;
  float* const cpa = smem;
  float* const cpb = smem + 9 * wcells;
  float* nob = smem + 18 * wcells;
  int* grow = reinterpret_cast<int*>(nob + wcells);
  float* red = reinterpret_cast<float*>(grow + whmax);
  const int tid = threadIdx.x;
  const int y0 = blockIdx.x * B;
  const int bi = min(B, ny - y0);
  const int wh = bi + 2 * T;
  const size_t plane = (size_t)ny * nx;
  const int frow = ny - 2;
  const Walk wk = walk(nx);
  for (int r = tid; r < wh; r += kSmemThreads) grow[r] = band::wrap_mod(y0 - T + r, ny);
  __syncthreads();
  smem_cells(wk, 0, wh, 0, [&](int r, int c) {
    const size_t g = (size_t)grow[r] * nx + c;
    const int i = r * nx + c;
#pragma unroll
    for (int k = 0; k < 9; ++k) cpa[k * wcells + i] = src[k * plane + g];
    nob[i] = nobst[g];
  });
  __syncthreads();
  int cur = 0;
  for (int done = 0, pass = 0; done < steps; ++pass) {
    const int len = min(T, steps - done);
    for (int s = 1; s <= len; ++s) {
      const float* in = cur ? cpb : cpa;
      float* out = cur ? cpa : cpb;
      const int r0 = T - len + s;
      float acc = 0.0f;
      smem_cells(wk, r0, bi + 2 * (len - s), T, [&](int r, int c) {
        float t[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int sr = r - lbm::cy(k);
          int sc = c - lbm::cx(k);
          sc = sc < 0 ? sc + nx : (sc >= nx ? sc - nx : sc);
          const int si = sr * nx + sc;
          float v = in[k * wcells + si];
          if (band::forced(k) && grow[sr] == frow) {
            const float m = lbm::force_mask(in[3 * wcells + si], in[6 * wcells + si],
                                            in[7 * wcells + si], nob[si], w1a, w2a);
            v = v + band::force_weight(k, w1a, w2a) * m;
          }
          t[k] = v;
        }
        const int i = r * nx + c;
        const float nb = nob[i];
        const float usq = lbm::collide_fused(t, nb, rc);
#pragma unroll
        for (int k = 0; k < 9; ++k) out[k * wcells + i] = t[k];
        if (r >= T && r < T + bi) acc += nb * sqrtf(usq);
      });
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if ((tid & 31) == 0) red[(s - 1) * kSmemWarps + (tid >> 5)] = acc;
      __syncthreads();
      cur ^= 1;
    }
    if (tid < len) {
      float acc = 0.0f;
      for (int w = 0; w < kSmemWarps; ++w) acc += red[tid * kSmemWarps + w];
      partials[(size_t)(done + tid) * gridDim.x + blockIdx.x] = acc;
    }
    done += len;
    if (done < steps) {
      // The exchange: own rows within T of either edge out, one barrier,
      // the ghost rows in.
      float* ex = exch + (size_t)(pass & 1) * 9 * plane;
      const float* w = cur ? cpb : cpa;
      smem_cells(wk, T, bi, T, [&](int r, int c) {
        if (r < 2 * T || r >= bi) {  // own rows within T of an edge
          const size_t g = (size_t)(y0 + r - T) * nx + c;
          const int i = r * nx + c;
#pragma unroll
          for (int k = 0; k < 9; ++k) ex[k * plane + g] = w[k * wcells + i];
        }
      });
      grid.sync();
      float* win = cur ? cpb : cpa;
      smem_cells(wk, 0, 2 * T, 0, [&](int q, int c) {
        const int r = q < T ? q : q + bi;
        const size_t g = (size_t)grow[r] * nx + c;
        const int i = r * nx + c;
#pragma unroll
        for (int k = 0; k < 9; ++k) win[k * wcells + i] = __ldcg(ex + k * plane + g);
      });
      __syncthreads();
    }
  }
  const float* w = cur ? cpb : cpa;
  smem_cells(wk, T, bi, T, [&](int r, int c) {
    const size_t g = (size_t)(y0 + r - T) * nx + c;
    const int i = r * nx + c;
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k * plane + g] = w[k * wcells + i];
  });
  grid.sync();
  // Every block's partials of every step are written: reduce each step's
  // row in a fixed order.
  const int nblocks = gridDim.x;
  for (int st = blockIdx.x; st < steps; st += nblocks) {
    float acc = 0.0f;
    for (int b = tid; b < nblocks; b += kSmemThreads) acc += __ldcg(partials + (size_t)st * nblocks + b);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((tid & 31) == 0) sm[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
      for (int w = 0; w < kSmemWarps; ++w) total += sm[w];
      av[st] = total * inv_tot;
    }
    __syncthreads();
  }
}

// The barrier floor: ``syncs`` grid.sync() calls and nothing else, to
// time what one barrier costs a persistent grid of a given size.
__global__ void grid_sync_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

}  // namespace

// The most blocks of resident_kernel the current device holds at once
// (occupancy x SMs), or minus a CUDA error.
extern "C" int lbm_resident_max_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// Runs n_steps steps in cooperative launches of ``chunk`` steps (the last
// one shorter) on ``blocks`` blocks. buf_a holds the initial state; global
// step t reads buf[t % 2] and writes buf[(t + 1) % 2], so the final state
// is in buf_a for even n_steps and in buf_b for odd. av receives n_steps
// values; partials needs chunk * blocks floats. Returns the first CUDA
// error (cudaErrorCooperativeLaunchTooLarge for a grid the card cannot
// hold at once), or 0.
extern "C" int lbm_resident_run(float* buf_a, float* buf_b, const float* nobst, float* av,
                                float* partials, int ny, int nx, int n_steps, int chunk,
                                int blocks, float w1a, float w2a, float beta, float ow0,
                                float ow1, float ow2, float inv_tot, void* stream) {
  lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int start = 0; start < n_steps; start += chunk) {
    int steps = n_steps - start < chunk ? n_steps - start : chunk;
    int parity = start & 1;
    float* av_c = av + start;
    void* args[] = {&buf_a, &buf_b, &nobst, &partials, &av_c, &ny, &nx, &steps, &parity,
                    &w1a, &w2a, &rc, &inv_tot};
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)resident_kernel, dim3(blocks),
                                                  dim3(kThreads), args, 0, s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear a launch-configuration error
      return static_cast<int>(err);
    }
  }
  return 0;
}

// Dynamic shared memory of the shared-memory form for a window of
// rows + 2 depth rows of nx cells.
extern "C" int lbm_resident_smem_bytes(int nx, int rows, int depth) {
  return (int)smem_form_bytes(nx, rows, depth);
}

// The shared-memory form: n_steps steps in cooperative launches of
// ``chunk`` steps (the last one shorter) on ``blocks`` blocks of ``rows``
// rows, ``depth`` steps per pass, with ``smem_bytes`` of dynamic shared
// memory each. Launch i reads buf[i % 2] and writes buf[(i + 1) % 2], so the
// final state is in buf_a for an even number of launches. exch holds 2 x 9 x
// ny x nx floats, partials chunk * blocks. The schedule comes from
// ops/resident.py::resident_smem_config: a blocks, rows or smem_bytes that
// does not match the grid and the carve, or more shared memory than a block
// may use, returns cudaErrorInvalidValue before any launch; a grid larger
// than the card holds at once is refused by the cooperative launch. Returns
// the first CUDA error, or 0.
extern "C" int lbm_resident_smem_run(float* buf_a, float* buf_b, float* exch, const float* nobst,
                                     float* av, float* partials, int ny, int nx, int n_steps,
                                     int chunk, int blocks, int rows, int depth, int smem_bytes,
                                     float w1a, float w2a, float beta, float ow0, float ow1,
                                     float ow2, float inv_tot, void* stream) {
  if (ny < 2 || nx < 1 || rows < 1 || depth < 1 || chunk < 1 ||
      blocks != (ny + rows - 1) / rows || (size_t)smem_bytes != smem_form_bytes(nx, rows, depth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // The kernel's static shared memory (kSmemWarps floats) counts against the opt-in.
  if (smem_bytes + (int)(sizeof(float) * kSmemWarps) > optin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(resident_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int start = 0, i = 0; start < n_steps; start += chunk, ++i) {
    int steps = n_steps - start < chunk ? n_steps - start : chunk;
    const float* src = (i & 1) ? buf_b : buf_a;
    float* dst = (i & 1) ? buf_a : buf_b;
    float* av_c = av + start;
    void* args[] = {&src, &dst, &exch, &nobst, &partials, &av_c, &ny, &nx, &rows, &depth,
                    &steps, &w1a, &w2a, &rc, &inv_tot};
    err = cudaLaunchCooperativeKernel((const void*)resident_smem_kernel, dim3(blocks),
                                      dim3(kSmemThreads), args, (size_t)smem_bytes, s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear a launch-configuration error
      return static_cast<int>(err);
    }
  }
  return 0;
}

// One cooperative launch of ``blocks`` blocks of ``threads`` threads that
// meets at ``syncs`` grid barriers and does nothing else (the barrier
// floor of K4, timed by the caller around the launch). Returns the first
// CUDA error, or 0.
extern "C" int lbm_grid_sync_probe(int blocks, int threads, int syncs, void* stream) {
  void* args[] = {&syncs};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)grid_sync_kernel, dim3(blocks),
                                                dim3(threads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
