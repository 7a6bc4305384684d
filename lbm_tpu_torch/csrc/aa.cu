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
//
// c16 storage (pallas_aa.py:225-244): the planes are int16 codes, decoded
// on every read and encoded on every write, keyed by SLOT, which is right
// in both arrangements because bg[opp(k)] == bg[k]. The JAX kernel keeps
// the codes in VMEM and re-encodes each forcing row when it writes it back,
// so the forcing launches decode, add and encode exactly the rows and slots
// the JAX kernel stores (one row of each of the six forced slots). 40 B per
// cell per step; a warp reads 64 B of a plane, half a line.
//
// bf16 storage (pallas_aa.py:230-236, the loader and storer of a bfloat16
// state): the same loads and stores through lbm_common.cuh::BF16, so every
// value the step stores and every forcing row the forcing launches store
// is rounded once to bfloat16, as the JAX kernel's to_store rounds its
// forced rows when it writes them back (pallas_aa.py:297-314). Its 16-bit
// mask (:459-464) holds 0 and 1, exact in f32 too.
#include "lbm_common.cuh"

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <class S>
__global__ void force_even_kernel(typename S::T* __restrict__ s, const float* __restrict__ nobst,
                                  int ny, int nx, float w1a, float w2a, S st) {
  const int xp = blockIdx.x * blockDim.x + threadIdx.x;  // pre-stream lane x'
  if (xp >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const int xm = wrap(xp - 1, nx);
  const int r = ny - 2;
  const float m = lbm::force_mask(st.load(s[3 * plane + (size_t)r * nx + xm], 3),
                                  st.load(s[6 * plane + (size_t)(ny - 1) * nx + xm], 6),
                                  st.load(s[7 * plane + (size_t)(ny - 3) * nx + xm], 7),
                                  nobst[(size_t)r * nx + xp], w1a, w2a);
  const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    if (k == 2 || k == 4) continue;
    const size_t a = k * plane + (size_t)wrap(r + lbm::cy(k), ny) * nx + wrap(xp + lbm::cx(k), nx);
    s[a] = st.store(st.load(s[a], k) + m * fw[k], k);
  }
}

template <class S>
__global__ void force_odd_kernel(typename S::T* __restrict__ s, const float* __restrict__ nobst,
                                 int ny, int nx, float w1a, float w2a, S st) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t c = (size_t)(ny - 2) * nx + x;
  // Plane i lives in slot opp(i): f3 in slot 1, f6 in slot 8, f7 in slot 5.
  const float m = lbm::force_mask(st.load(s[1 * plane + c], 1), st.load(s[8 * plane + c], 8),
                                  st.load(s[5 * plane + c], 5), nobst[c], w1a, w2a);
  const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    if (k == 2 || k == 4) continue;
    const size_t a = lbm::opp(k) * plane + c;
    s[a] = st.store(st.load(s[a], lbm::opp(k)) + m * fw[k], lbm::opp(k));
  }
}

template <bool kOdd, class S>
__global__ void __launch_bounds__(lbm::kThreads)
aa_step_kernel(typename S::T* s, const float* __restrict__ nobst, float* __restrict__ partials,
               unsigned int* __restrict__ ticket, float* __restrict__ av_out, int ny, int nx,
               lbm::Relax rc, float inv_tot, S st) {
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
        t[k] = st.load(s[lbm::opp(k) * plane + (size_t)sy * nx + sx], lbm::opp(k));
      }
    } else {
      const size_t c = (size_t)y * nx + x;
#pragma unroll
      for (int k = 0; k < 9; ++k) t[k] = st.load(s[k * plane + c], k);
    }
    const float nob = nobst[(size_t)y * nx + x];
    const float usq = lbm::collide_fused(t, nob, rc);
    u = nob * sqrtf(usq);
    if (kOdd) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int dy = wrap(y + lbm::cy(k), ny);
        const int dx = wrap(x + lbm::cx(k), nx);
        s[k * plane + (size_t)dy * nx + dx] = st.store(t[k], k);
      }
    } else {
      const size_t c = (size_t)y * nx + x;
#pragma unroll
      for (int k = 0; k < 9; ++k) s[lbm::opp(k) * plane + c] = st.store(t[k], lbm::opp(k));
    }
  }
  lbm::grid_sum_last_block(u, partials, ticket, inv_tot, av_out);
}

template <class S>
int run(void* planes, const float* nobst, float* av, float* partials, unsigned int* ticket,
        int ny, int nx, int n_steps, float w1a, float w2a, const lbm::Relax& rc, float inv_tot,
        cudaStream_t st, const S& stor) {
  typename S::T* state = static_cast<typename S::T*>(planes);
  const dim3 block(lbm::kBlockX, lbm::kBlockY);
  const dim3 grid = lbm::grid_for(ny, nx);
  const int fthreads = 256;
  const dim3 fgrid((nx + fthreads - 1) / fthreads);
  for (int t = 0; t < n_steps; ++t) {
    if (t & 1) {
      force_odd_kernel<S><<<fgrid, fthreads, 0, st>>>(state, nobst, ny, nx, w1a, w2a, stor);
    } else {
      force_even_kernel<S><<<fgrid, fthreads, 0, st>>>(state, nobst, ny, nx, w1a, w2a, stor);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t & 1) {
      aa_step_kernel<true, S><<<grid, block, 0, st>>>(state, nobst, partials, ticket, av + t, ny,
                                                      nx, rc, inv_tot, stor);
    } else {
      aa_step_kernel<false, S><<<grid, block, 0, st>>>(state, nobst, partials, ticket, av + t, ny,
                                                       nx, rc, inv_tot, stor);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Runs n_steps AA steps in place on ``state``, which must hold the S
// arrangement on entry. After an even n_steps it holds S, after an odd one
// C. av receives n_steps values; partials needs one float per block of
// grid_for(ny, nx); ticket one zeroed unsigned int. storage: the planes'
// storage (lbm_common.cuh::Storage). Returns the first CUDA error, or 0.
extern "C" int lbm_aa_run(void* state, const float* nobst, float* av, float* partials,
                          unsigned int* ticket, int ny, int nx, int n_steps, float w1a,
                          float w2a, float beta, float ow0, float ow1, float ow2,
                          float inv_tot, const lbm::Storage* storage, void* stream) {
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& stor) {
    return run(state, nobst, av, partials, ticket, ny, nx, n_steps, w1a, w2a, rc, inv_tot, st,
               stor);
  });
}

extern "C" unsigned int lbm_aa_num_blocks(int ny, int nx) {
  const dim3 g = lbm::grid_for(ny, nx);
  return g.x * g.y;
}
