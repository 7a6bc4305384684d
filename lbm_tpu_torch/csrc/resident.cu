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

#include "lbm_common.cuh"

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
