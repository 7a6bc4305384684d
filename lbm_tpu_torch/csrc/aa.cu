// K2: the in-place AA-pattern D2Q9/BGK step on ONE copy of the state.
//
// Replaces: lbm_tpu/ops/pallas_aa.py::_aa_kernel, the single-copy
// VMEM-resident AA kernel (254 steps per call, row tiles, lane rolls).
//
// What bounds it on the H100: bytes. Each step reads and writes the 9 f32
// planes in place and reads the not-obstacle plane, about 76 B per cell, at
// ~60 flops per cell. One state copy at 1024^2 is 37.7 MB, which fits the
// 50 MB L2; whether the card keeps it resident there between steps is a
// measurement (PERF.md), not an assumption of this code.
//
// What the design does about it: one buffer instead of two halves the
// footprint, and every value is read once and written once per step. Steps
// alternate between two arrangements (pallas_aa.py:12-30):
//   S (before an even step): slot (x, i) holds the arrival t_i(x);
//   C (before an odd step):  slot (x, opp(i)) holds the post-collision f*_i(x).
// The even step is cell-local: read the 9 slots at x, relax, write the value
// travelling k into slot opp(k) at x (S -> C). The odd step gathers t_k from
// (x - c_k, opp(k)), relaxes and scatters to (x + c_k, k) (C -> S). Address
// (w, j) is read and written by the same cell, w - c_j, and each thread
// finishes its 9 reads before its 9 writes, so the update is race-free in
// place for any block order, the periodic wrap included. One thread per
// cell, threadIdx.x along x, so warps touch contiguous lines of one plane.
//
// The row-(ny-2) forcing is a separate one-row launch before each step:
//   even (S space, pallas_aa.py:297-307): thread x' is the PRE-stream lane;
//     it reads (3, ny-2, x'-1), (6, ny-1, x'-1), (7, ny-3, x'-1) and
//     nobst[ny-2, x'] and adds the delta of speed k at (ny-2+cy_k, x'+cx_k).
//     Every address a thread reads is written only by that thread.
//   odd (C space, pallas_aa.py:309-314): cell-local at row ny-2, slot opp(k).
// Entry (R -> S) and exit (S -> R or the opp permutation) are plain torch
// outside the loop (ops/aa.py). Needs ny >= 3.
#include "lbm_common.cuh"

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__global__ void force_even_kernel(float* __restrict__ s, const float* __restrict__ nobst,
                                  int ny, int nx, float w1a, float w2a) {
  const int xp = blockIdx.x * blockDim.x + threadIdx.x;  // pre-stream lane x'
  if (xp >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const int xm = wrap(xp - 1, nx);
  const int r = ny - 2;
  const float m = lbm::force_mask(s[3 * plane + (size_t)r * nx + xm],
                                  s[6 * plane + (size_t)(ny - 1) * nx + xm],
                                  s[7 * plane + (size_t)(ny - 3) * nx + xm],
                                  nobst[(size_t)r * nx + xp], w1a, w2a);
  const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    if (k == 2 || k == 4) continue;
    const size_t a = k * plane + (size_t)wrap(r + lbm::cy(k), ny) * nx + wrap(xp + lbm::cx(k), nx);
    s[a] = s[a] + m * fw[k];
  }
}

__global__ void force_odd_kernel(float* __restrict__ s, const float* __restrict__ nobst,
                                 int ny, int nx, float w1a, float w2a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t c = (size_t)(ny - 2) * nx + x;
  // Plane i lives in slot opp(i): f3 in slot 1, f6 in slot 8, f7 in slot 5.
  const float m = lbm::force_mask(s[1 * plane + c], s[8 * plane + c], s[5 * plane + c],
                                  nobst[c], w1a, w2a);
  const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    if (k == 2 || k == 4) continue;
    const size_t a = lbm::opp(k) * plane + c;
    s[a] = s[a] + m * fw[k];
  }
}

template <bool kOdd>
__global__ void __launch_bounds__(lbm::kThreads)
aa_step_kernel(float* s, const float* __restrict__ nobst, float* __restrict__ partials,
               unsigned int* __restrict__ ticket, float* __restrict__ av_out, int ny, int nx,
               lbm::Relax rc, float inv_tot) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = x < nx && y < ny;
  const size_t plane = (size_t)ny * nx;
  float u = 0.0f;
  if (inside) {
    float t[9];
    if (kOdd) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int sy = wrap(y - lbm::cy(k), ny);
        const int sx = wrap(x - lbm::cx(k), nx);
        t[k] = s[lbm::opp(k) * plane + (size_t)sy * nx + sx];
      }
    } else {
      const size_t c = (size_t)y * nx + x;
#pragma unroll
      for (int k = 0; k < 9; ++k) t[k] = s[k * plane + c];
    }
    const float nob = nobst[(size_t)y * nx + x];
    const float usq = lbm::collide_fused(t, nob, rc);
    u = nob * sqrtf(usq);
    if (kOdd) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int dy = wrap(y + lbm::cy(k), ny);
        const int dx = wrap(x + lbm::cx(k), nx);
        s[k * plane + (size_t)dy * nx + dx] = t[k];
      }
    } else {
      const size_t c = (size_t)y * nx + x;
#pragma unroll
      for (int k = 0; k < 9; ++k) s[lbm::opp(k) * plane + c] = t[k];
    }
  }
  lbm::grid_sum_last_block(u, partials, ticket, inv_tot, av_out);
}

}  // namespace

// Runs n_steps AA steps in place on ``state``, which must hold the S
// arrangement on entry. After an even n_steps it holds S, after an odd one
// C. av receives n_steps values; partials needs one float per block of
// grid_for(ny, nx); ticket one zeroed unsigned int. Returns the first CUDA
// error, or 0.
extern "C" int lbm_aa_run(float* state, const float* nobst, float* av, float* partials,
                          unsigned int* ticket, int ny, int nx, int n_steps, float w1a,
                          float w2a, float beta, float ow0, float ow1, float ow2,
                          float inv_tot, void* stream) {
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  const dim3 block(lbm::kBlockX, lbm::kBlockY);
  const dim3 grid = lbm::grid_for(ny, nx);
  const int fthreads = 256;
  const dim3 fgrid((nx + fthreads - 1) / fthreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < n_steps; ++t) {
    if (t & 1) {
      force_odd_kernel<<<fgrid, fthreads, 0, st>>>(state, nobst, ny, nx, w1a, w2a);
    } else {
      force_even_kernel<<<fgrid, fthreads, 0, st>>>(state, nobst, ny, nx, w1a, w2a);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t & 1) {
      aa_step_kernel<true><<<grid, block, 0, st>>>(state, nobst, partials, ticket, av + t, ny,
                                                   nx, rc, inv_tot);
    } else {
      aa_step_kernel<false><<<grid, block, 0, st>>>(state, nobst, partials, ticket, av + t, ny,
                                                    nx, rc, inv_tot);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" unsigned int lbm_aa_num_blocks(int ny, int nx) {
  const dim3 g = lbm::grid_for(ny, nx);
  return g.x * g.y;
}
