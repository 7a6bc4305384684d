// K4: many whole-grid steps per launch, in one persistent cooperative grid.
//
// Replaces: lbm_tpu/ops/pallas_resident.py::_mega_kernel (with
// _make_mega_call), up to 255 steps per call with the whole state in VMEM,
// ping-ponging between the input and output windows.
//
// What bounds it on the H100, global-memory form: a step reads and writes
// the whole state (72 B per cell, and the not-obstacle plane) and meets the
// whole grid at one grid-wide barrier. Two copies of the state, ping-ponged,
// stay in the 50 MB L2 only below about 590^2 cells; ONE copy, stepped in
// place, fits it up to about 1100^2 (37.7 MB and the 4.2 MB mask at
// 1024^2), so a step can cost its L2 traffic instead of HBM's. On small
// grids the barrier is the cost that matters: K1 pays a kernel launch per
// step instead.
//
// What the design does about it: one cooperative launch per chunk of steps,
// with the grid sized to what the card holds at once (occupancy x SMs, at
// most 3 blocks per SM: ops/resident.py::grid_blocks; never more than one
// thread per cell). The state is ONE copy in K2's AA
// arrangement (aa.cu), stepped in place, and each block keeps one fixed
// slab of consecutive cells for the whole call, so the lines it touches
// are the same every step. With slot j of the AA arrangement kept in plane
// opp(j), the regular arrangement R is the C arrangement: a call starts on
// R with the gather step (t_k from plane k at x - c_k, relaxed, scattered to
// plane opp(k) at x + c_k), then the cell-local step (plane opp(k) of the
// cell in, plane k out), and so on; after an even number of steps the state
// is R again, after an odd number the S arrangement, which the wrapper
// turns into R as K2's exit does (ops/resident.py). Address (x, j) has one
// reader and one writer each step, the same cell, so a step needs no
// barrier but the one after it (the gather needs its neighbours' last
// writes). Forcing of row ny-2, K9's placement (band_common.cuh::aa_load):
// the call's first launch forces the cells of row ny-2 of R in place before
// its first step (one more barrier per call), and each step adds the
// forcing of the next to the outputs of its cells on row ny-2, but the
// call's last step. The cell arithmetic is K1's in K1's order, so the state
// is bitwise K1's. Reads go through L2 (__ldcg: other blocks wrote those
// lines since this SM last read them). A thread issues each cell's loads
// before the stores of the cell before it: with two cells' loads in
// flight a step from HBM took 0.75 of the time at 2048^2 (PERF.md).
//
// The not-obstacle plane is read as one byte per cell, built by the call's
// first launch in the caller's scratch (1 B instead of 4 per cell and step:
// 1-21% less time than the f32 plane at 512^2-4096^2 on an H100, PERF.md).
// Where the caller asks, a persisting-L2 access-policy window covers the
// state (set on the stream for the call's launches, reset after them).
// Per-step sums: each block writes its partial to partials[step][block];
// after the chunk, block b reduces steps b, b + G, ... over all blocks in a
// fixed order, so two runs are bitwise equal (no float atomics). A grid
// larger than the card can hold at once is refused by
// cudaLaunchCooperativeKernel, and the error is returned, never a smaller
// grid.
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

// The 9 values t_k of the cell at (y, x), index c, for a step of the
// global-memory form: kGather, from plane k at x - c_k; else from plane
// opp(k) of the cell.
template <bool kGather>
__device__ __forceinline__ void aa_global_load(const float* buf, size_t plane, int ny, int nx,
                                               long long c, int y, int x, float t[9]) {
  const int yu = y == 0 ? ny - 1 : y - 1, yd = y + 1 == ny ? 0 : y + 1;
  const int xl = x == 0 ? nx - 1 : x - 1, xr = x + 1 == nx ? 0 : x + 1;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (kGather) {
      const int sy = lbm::cy(k) == 1 ? yu : (lbm::cy(k) == -1 ? yd : y);
      const int sx = lbm::cx(k) == 1 ? xl : (lbm::cx(k) == -1 ? xr : x);
      t[k] = __ldcg(buf + k * plane + (size_t)sy * nx + sx);
    } else {
      t[k] = __ldcg(buf + lbm::opp(k) * plane + c);
    }
  }
}

// One step of the global-memory form over this thread's cells of its
// block's slab, cells [start, c1) at a stride of kThreads, starting at
// (y, x): kGather, t_k from plane k at x - c_k, relaxed, scattered to
// plane opp(k) at x + c_k; else t_k from plane opp(k) of the cell, written
// to plane k of the cell. ``force``: a cell on row ny-2 adds the next
// step's forcing to its outputs. Each cell's loads are issued before the
// stores of the cell before it (every address a step reads and writes
// belongs to one cell, so the two never meet), which keeps two cells'
// loads in flight per thread. Returns the thread's sum of nob * |u|.
template <bool kGather>
__device__ __forceinline__ float aa_global_step(float* buf, const unsigned char* nob8, int ny,
                                                int nx, long long start, long long c1, int y,
                                                int x, int dy, int dx, bool force, float w1a,
                                                float w2a, const lbm::Relax& rc) {
  const size_t plane = (size_t)ny * nx;
  const int frow = ny - 2;
  float acc = 0.0f;
  float t[9];
  if (start < c1) aa_global_load<kGather>(buf, plane, ny, nx, start, y, x, t);
  for (long long c = start; c < c1; c += kThreads) {
    int yn = y + dy, xn = x + dx;
    if (xn >= nx) {
      xn -= nx;
      ++yn;
    }
    float tn[9];
    if (c + kThreads < c1) aa_global_load<kGather>(buf, plane, ny, nx, c + kThreads, yn, xn, tn);
    const float nob = (float)nob8[c];
    const float usq = lbm::collide_fused(t, nob, rc);
    if (force && y == frow) band::force_cell(t, nob, w1a, w2a);
    const int yu = y == 0 ? ny - 1 : y - 1, yd = y + 1 == ny ? 0 : y + 1;
    const int xl = x == 0 ? nx - 1 : x - 1, xr = x + 1 == nx ? 0 : x + 1;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (kGather) {
        const int ty = lbm::cy(k) == 1 ? yd : (lbm::cy(k) == -1 ? yu : y);
        const int tx = lbm::cx(k) == 1 ? xr : (lbm::cx(k) == -1 ? xl : x);
        buf[lbm::opp(k) * plane + (size_t)ty * nx + tx] = t[k];
      } else {
        buf[k * plane + c] = t[k];
      }
    }
    acc += nob * sqrtf(usq);
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = tn[k];
    y = yn;
    x = xn;
  }
  return acc;
}

// ``steps`` steps of a call, the first of them the call's step ``first``
// (a gather step when even); ``last``: the launch ends the call. nob8: the
// one-byte not-obstacle plane, which the call's first launch builds from
// nobst.
__global__ void __launch_bounds__(kThreads)
resident_kernel(float* buf, const float* __restrict__ nobst, unsigned char* nob8,
                float* __restrict__ partials, float* __restrict__ av, int ny, int nx, int steps,
                int first, int last, float w1a, float w2a, lbm::Relax rc, float inv_tot) {
  __shared__ float sm[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nblocks = gridDim.x;
  const long long ncell = (long long)ny * nx;
  const long long per = (ncell + nblocks - 1) / nblocks;
  const long long c0 = per * blockIdx.x;
  const long long c1 = c0 + per < ncell ? c0 + per : ncell;
  const size_t plane = (size_t)ncell;
  const int frow = ny - 2;
  if (first == 0) {
    // The call's entry: its first forcing, cell-local on R, and the byte plane.
    const long long f0 = c0 > (long long)frow * nx ? c0 : (long long)frow * nx;
    const long long f1 = c1 < (long long)(frow + 1) * nx ? c1 : (long long)(frow + 1) * nx;
    for (long long c = f0 + threadIdx.x; c < f1; c += kThreads) {
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = buf[k * plane + c];
      band::force_cell(v, nobst[c], w1a, w2a);
#pragma unroll
      for (int k = 0; k < 9; ++k) buf[k * plane + c] = v[k];
    }
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) nob8[c] = nobst[c] > 0.0f;
    grid.sync();
  }
  // The first cell of this thread, and the row/column step of a stride of
  // kThreads cells, so the loop needs no division per cell.
  const long long start = c0 + threadIdx.x;
  const int y0 = (int)(start / nx);
  const int x0 = (int)(start - (long long)y0 * nx);
  const int dy = kThreads / nx;
  const int dx = kThreads - dy * nx;
  for (int st = 0; st < steps; ++st) {
    const bool force = !(last && st + 1 == steps);
    const float acc =
        ((first + st) & 1) == 0
            ? aa_global_step<true>(buf, nob8, ny, nx, start, c1, y0, x0, dy, dx, force, w1a,
                                   w2a, rc)
            : aa_global_step<false>(buf, nob8, ny, nx, start, c1, y0, x0, dy, dx, force, w1a,
                                    w2a, rc);
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
// reads and writes the whole state in global memory and meets the whole
// grid at grid.sync(), about 2 us per step whatever the grid's size
// (PERF.md). This form pays a barrier per T steps instead.
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
// one shorter) on ``blocks`` blocks, in place on ``buf``, which holds R on
// entry and, on return, R after an even n_steps and the S arrangement (slot
// k in plane opp(k)) after an odd one. nob8: scratch of ny * nx bytes for
// the one-byte not-obstacle plane. l2_bytes: the
// persisting-L2 access-policy window over the first l2_bytes of buf (0:
// none), set on the stream for these launches and reset after them, the
// call then waiting for them. av receives n_steps values; partials needs
// chunk * blocks floats. Returns the first CUDA error
// (cudaErrorCooperativeLaunchTooLarge for a grid the card cannot hold at
// once), or 0.
extern "C" int lbm_resident_run(float* buf, void* nob8, const float* nobst, float* av,
                                float* partials, int ny, int nx, int n_steps, int chunk,
                                int blocks, unsigned long long l2_bytes, float w1a, float w2a,
                                float beta, float ow0, float ow1, float ow2, float inv_tot,
                                void* stream) {
  lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  cudaStreamAttrValue window = {};
  if (l2_bytes > 0) {
    int dev = 0, max_window = 0, max_persist = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
    }
    const size_t bytes = l2_bytes < (size_t)max_window ? l2_bytes : (size_t)max_window;
    const size_t persist = bytes < (size_t)max_persist ? bytes : (size_t)max_persist;
    if (err == cudaSuccess) err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, persist);
    window.accessPolicyWindow.base_ptr = buf;
    window.accessPolicyWindow.num_bytes = bytes;
    window.accessPolicyWindow.hitRatio = bytes > 0 ? (float)((double)persist / bytes) : 0.0f;
    window.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    window.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    if (err == cudaSuccess) {
      err = cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &window);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unsigned char* bytes8 = static_cast<unsigned char*>(nob8);
  for (int start = 0; start < n_steps && err == cudaSuccess; start += chunk) {
    int steps = n_steps - start < chunk ? n_steps - start : chunk;
    int first = start;
    int last = start + steps == n_steps;
    float* av_c = av + start;
    void* args[] = {&buf, &nobst, &bytes8, &partials, &av_c, &ny, &nx, &steps, &first, &last,
                    &w1a, &w2a, &rc, &inv_tot};
    err = cudaLaunchCooperativeKernel((const void*)resident_kernel, dim3(blocks),
                                      dim3(kThreads), args, 0, s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) cudaGetLastError();  // clear a launch-configuration error
  }
  if (l2_bytes > 0) {
    // The window's lines stay persisting until reset: wait for the
    // launches, then give the L2 back.
    cudaError_t e = cudaStreamSynchronize(s);
    window.accessPolicyWindow.num_bytes = 0;
    window.accessPolicyWindow.hitRatio = 0.0f;
    if (e == cudaSuccess) e = cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &window);
    if (e == cudaSuccess) e = cudaCtxResetPersistingL2Cache();
    if (e == cudaSuccess) e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
    if (err == cudaSuccess) err = e;
  }
  return static_cast<int>(err);
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
