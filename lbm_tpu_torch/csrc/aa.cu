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
//
// The word form (c16 and bf16, nx a multiple of kWordCells):
// aa_word_kernel takes kWordCells cells of one row per thread, so a warp is
// one row and every access of a plane is one aligned word a thread
// (lbm_common.cuh::Word).
// The even step loads the 9 words at x and stores 9 words into slot
// opp(k) at x: cell-local. The odd step rebuilds its shifted gathers from
// the lane's word and its neighbour lane's edge half, as K1's word form
// does, and its shifted scatters likewise. The in-place rule then reads:
// address (w, j) belongs to cell w - c_j of the warp's row, so the aligned
// word at x0 of slot k with cx(k) = +1 holds one element of the cell left
// of the lane (x0 - 1) and, with cx(k) = -1, one of the cell right of its
// last (x0 + kWordCells). A lane stores that element as part of its word
// only when the owner is a lane of the same warp: every lane finishes its
// loads, then __syncwarp, then the stores, and the value comes from the
// owner through a shuffle. An element whose owner lies in another warp
// (the warp's first and last lane, and through the periodic wrap the
// row's first and last cell) is left out of the word and stored as one
// 16-bit value by the thread that owns it. So every address is written
// once, by its owner or by a lane of its owner's warp after the warp
// barrier, and read only by its owner: race-free in place for any block
// order. Other warps' elements that an edge lane's 32-bit load carries
// beside its own are never used.
//
// The word form's forcing is fused. The odd (C-space) forcing of step t+1
// runs in the epilogue of the even step t: the thread of cell (ny-2, x)
// holds its post-collision f3, f6, f7 and the values it stores in slot
// opp(k). The even (S-space) forcing of step t+1 runs in the scatter of
// the odd step t: the cell (ny-2, x') is the pre-stream lane x', and its
// thread holds the f3, f6, f7 the standalone launch would read and the
// values it stores at (ny-2+cy_k, x'+cx_k) in slot k. Either keeps the
// standalone launch's function: encode, decode (for the mask and the
// forced values), add the masked delta, encode. A call starts in S, so
// its first step keeps the standalone even launch, and its last step fuses
// nothing: the state it returns holds no forcing of a step that has not
// run. The result is bitwise the
// one-cell form's. The forcing launch cost the one-cell form 3.4
// microseconds a step at c16 and 2.9 at bf16 at 1024^2 on an H100
// (trials/k2_noforce.patch, PERF.md). Like K1's word form, it moves whole
// lines in less time than its instructions take to issue, the c16 codec's
// most of all. The one-cell form runs f32 and the widths the words do not
// tile.
#include "lbm_common.cuh"

namespace {

using lbm::kWordCells;
using lbm::wrap;

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

// The forcing delta on each speed (kernels.cl:21-41): +w on 1, 5, 8 and
// -w on 3, 6, 7; speeds 0, 2 and 4 are not forced.
__device__ __forceinline__ float force_delta(int k, float w1a, float w2a) {
  return k == 1 ? w1a : k == 3 ? -w1a : k == 5 || k == 8 ? w2a : k == 6 || k == 7 ? -w2a : 0.0f;
}

// The word form's step. The launch bounds ask for four blocks per SM,
// which holds a thread to 64 registers.
template <bool kOdd, class S>
__global__ void __launch_bounds__(lbm::kThreads, 4)
aa_word_kernel(typename S::T* s, const float* __restrict__ nobst, float* __restrict__ partials,
               unsigned int* __restrict__ ticket, float* __restrict__ av_out, int ny, int nx,
               lbm::Relax rc, float inv_tot, float w1a, float w2a, int force_next, S st) {
  using T = typename S::T;
  static_assert(sizeof(T) == 2, "the word form takes 16-bit storage");
  using W = lbm::Word;
  constexpr int kCells = kWordCells;
  const int lane = threadIdx.x;
  const int x0 = kCells * (blockIdx.x * blockDim.x + lane);  // the thread's first cell
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float u = 0.0f;
  if (y < ny) {  // warp-uniform: a warp is one row
    const size_t plane = (size_t)ny * nx;
    const bool active = x0 < nx;
    // The lanes whose accesses reach past the warp's span (K1's word form):
    // the row's first lane wraps to column nx - 2 (its own element nx - 1),
    // its last (x0 + kCells == nx) to column 0.
    const bool first = active && lane == 0;
    const bool last = active && (lane == 31 || x0 + kCells == nx);
    const int before = x0 == 0 ? nx - 2 : x0 - 2;
    const int after = x0 + kCells == nx ? 0 : x0 + kCells;
    // The slot a value is read from and the slot the value travelling k
    // goes to: k and opp(k) on the even step, opp(k) and k on the odd.
    auto slot_in = [](int k) { return kOdd ? lbm::opp(k) : k; };
    auto slot_out = [](int k) { return kOdd ? k : lbm::opp(k); };
    // The raw t_k of the thread's cells, held as words: each cell is
    // decoded where it is relaxed.
    W p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      W w{};
      if (kOdd) {  // gather t_k from (x - c_k, opp(k))
        const T* row = s + slot_in(k) * plane + (size_t)wrap(y - lbm::cy(k), ny) * nx;
        if (active) w.load(row + x0);
        p[k] = w;
        if (lbm::cx(k) == 1) {
          uint32_t prev = __shfl_up_sync(0xffffffffu, w.h[1], 1);
          if (first) prev = *reinterpret_cast<const uint32_t*>(row + before);
          p[k] = w.shifted_in_prev(prev);
        } else if (lbm::cx(k) == -1) {
          uint32_t next = __shfl_down_sync(0xffffffffu, w.h[0], 1);
          if (last) next = *reinterpret_cast<const uint32_t*>(row + after);
          p[k] = w.shifted_in_next(next);
        }
      } else {  // slot k at x
        if (active) w.load(s + k * plane + (size_t)y * nx + x0);
        p[k] = w;
      }
    }
    // The codes of the values travelling k, cell by cell; an idle lane past
    // the row's end only takes part in the shuffles.
    W o[9] = {};
    if (active) {
      float nb[kCells];
      lbm::load_mask(nobst + (size_t)y * nx + x0, nb);
      const bool force = force_next && y == ny - 2;  // the next step's forcing, fused
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        float t[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) t[k] = st.load(lbm::raw_of<T>(p[k].cell(c)), slot_in(k));
        const float usq = lbm::collide_fused(t, nb[c], rc);
        u += nb[c] * sqrtf(usq);
        uint32_t q[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) q[k] = lbm::bits_of(st.store(t[k], slot_out(k)));
        if (force) {
          auto dec = [&](int k) { return st.load(lbm::raw_of<T>(q[k]), slot_out(k)); };
          const float m = lbm::force_mask(dec(3), dec(6), dec(7), nb[c], w1a, w2a);
#pragma unroll
          for (int k = 1; k < 9; ++k) {
            if (k == 2 || k == 4) continue;
            q[k] = lbm::bits_of(st.store(dec(k) + m * force_delta(k, w1a, w2a), slot_out(k)));
          }
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) o[k].set_cell(c, q[k]);
      }
    }
    if (kOdd) __syncwarp();  // every lane of the row has loaded before any stores
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int dy = kOdd ? wrap(y + lbm::cy(k), ny) : y;
      T* row = s + slot_out(k) * plane + (size_t)dy * nx;
      const int cx = kOdd ? lbm::cx(k) : 0;
      if (cx == 0) {
        if (active) o[k].store(row + x0);
      } else if (cx == 1) {  // cells x0 - 1 .. x0 + kCells - 2 land in the word at x0
        const W w = o[k].shifted_in_prev(__shfl_up_sync(0xffffffffu, o[k].h[1], 1));
        if (active && !first) {
          w.store(row + x0);
        } else if (active) {  // element x0 belongs to another warp's cell
          row[x0 + 1] = lbm::raw_of<T>(o[k].cell(0));
          reinterpret_cast<uint32_t*>(row + x0)[1] = w.h[1];
        }
        if (last) row[after] = lbm::raw_of<T>(o[k].cell(kCells - 1));
      } else {  // cells x0 + 1 .. x0 + kCells land in the word at x0
        const W w = o[k].shifted_in_next(__shfl_down_sync(0xffffffffu, o[k].h[0], 1));
        if (active && !last) {
          w.store(row + x0);
        } else if (active) {  // element x0 + kCells - 1 belongs to another warp's cell
          reinterpret_cast<uint32_t*>(row + x0)[0] = w.h[0];
          row[x0 + kCells - 2] = lbm::raw_of<T>(o[k].cell(kCells - 1));
        }
        if (first) row[before + 1] = lbm::raw_of<T>(o[k].cell(0));
      }
    }
  }
  lbm::grid_sum_last_block(u, partials, ticket, inv_tot, av_out);
}

template <class S>
int run_words(typename S::T* state, const float* nobst, float* av, float* partials,
              unsigned int* ticket, int ny, int nx, int n_steps, float w1a, float w2a,
              const lbm::Relax& rc, float inv_tot, cudaStream_t st, const S& stor) {
  const dim3 block(lbm::kBlockX, lbm::kBlockY);
  const dim3 grid((nx / kWordCells + lbm::kBlockX - 1) / lbm::kBlockX,
                  (ny + lbm::kBlockY - 1) / lbm::kBlockY);
  const int fthreads = 256;
  force_even_kernel<S><<<(nx + fthreads - 1) / fthreads, fthreads, 0, st>>>(state, nobst, ny, nx,
                                                                            w1a, w2a, stor);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int t = 0; t < n_steps; ++t) {
    const int force_next = t + 1 < n_steps;
    if (t & 1) {
      aa_word_kernel<true, S><<<grid, block, 0, st>>>(
          state, nobst, partials, ticket, av + t, ny, nx, rc, inv_tot, w1a, w2a, force_next, stor);
    } else {
      aa_word_kernel<false, S><<<grid, block, 0, st>>>(
          state, nobst, partials, ticket, av + t, ny, nx, rc, inv_tot, w1a, w2a, force_next, stor);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <class S>
int run(void* planes, const float* nobst, float* av, float* partials, unsigned int* ticket,
        int ny, int nx, int n_steps, float w1a, float w2a, const lbm::Relax& rc, float inv_tot,
        int word, cudaStream_t st, const S& stor) {
  typename S::T* state = static_cast<typename S::T*>(planes);
  if (word) {
    if constexpr (sizeof(typename S::T) == 2) {
      if (nx % kWordCells == 0) {
        return run_words<S>(state, nobst, av, partials, ticket, ny, nx, n_steps, w1a, w2a, rc,
                            inv_tot, st, stor);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
// grid_for(ny, nx); ticket one zeroed unsigned int. word: 0 runs the
// one-cell form, 1 the word form (16-bit storage, nx a multiple of
// kWordCells, state and nobst 16-byte aligned). storage: the planes'
// storage (lbm_common.cuh::Storage). Returns the first CUDA error, or 0.
extern "C" int lbm_aa_run(void* state, const float* nobst, float* av, float* partials,
                          unsigned int* ticket, int ny, int nx, int n_steps, float w1a,
                          float w2a, float beta, float ow0, float ow1, float ow2,
                          float inv_tot, int word, const lbm::Storage* storage, void* stream) {
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& stor) {
    return run(state, nobst, av, partials, ticket, ny, nx, n_steps, w1a, w2a, rc, inv_tot, word,
               st, stor);
  });
}

// Registers per thread, local memory per thread (bytes) and resident
// blocks per SM of the step kernel of one form (word 0 or 1),
// step parity and storage kind, into out[0..2]. Returns the first CUDA
// error, or 0.
extern "C" int lbm_aa_attrs(int word, int odd, int kind, int* out) {
  const void* fn = nullptr;
  if (!word) {
    if (kind == lbm::kStorageF32) {
      fn = odd ? (const void*)aa_step_kernel<true, lbm::F32>
               : (const void*)aa_step_kernel<false, lbm::F32>;
    } else if (kind == lbm::kStorageC16) {
      fn = odd ? (const void*)aa_step_kernel<true, lbm::C16>
               : (const void*)aa_step_kernel<false, lbm::C16>;
    } else {
      fn = odd ? (const void*)aa_step_kernel<true, lbm::BF16>
               : (const void*)aa_step_kernel<false, lbm::BF16>;
    }
  } else if (kind == lbm::kStorageC16) {
    fn = odd ? (const void*)aa_word_kernel<true, lbm::C16>
             : (const void*)aa_word_kernel<false, lbm::C16>;
  } else if (kind == lbm::kStorageBF16) {
    fn = odd ? (const void*)aa_word_kernel<true, lbm::BF16>
             : (const void*)aa_word_kernel<false, lbm::BF16>;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return lbm::func_attrs(fn, out);
}

extern "C" unsigned int lbm_aa_num_blocks(int ny, int nx) {
  const dim3 g = lbm::grid_for(ny, nx);
  return g.x * g.y;
}
