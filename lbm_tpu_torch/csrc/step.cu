// K1: one fused D2Q9/BGK timestep per launch, ping-pong between two buffers.
//
// Replaces: lbm_tpu/ops/pallas_step.py::_kernel (with _physics), the fused
// Pallas step on row blocks (9, B, nx) with halo side outputs.
//
// What bounds it on the H100: bytes. A step reads 9 f32 planes and the f32
// not-obstacle plane and writes 9 planes, about 76 B per cell; the
// collision is ~60 flops per cell, far below the card's flop-per-byte
// balance. At 1024^2 the two copies of the state (75.5 MB) do not fit the
// 50 MB L2, so each step streams from HBM.
//
// c16 storage (pallas_step.py:198-243): the planes are int16 codes
// (lbm_common.cuh::C16), decoded as they are read and encoded as they are
// written, 40 B per cell per step; the physics and the mask stay f32. A
// warp then reads and writes 64 B of a plane, half a 128-byte line.
//
// bf16 storage (pallas_step.py:154-160 and :246-247 with a bfloat16
// state: _physics casts each result to out_dtype): the planes are bfloat16
// (lbm_common.cuh::BF16), widened as they are read and rounded to nearest
// even as they are written: one rounding per step, 40 B per cell per step,
// no codec arithmetic.
//
// The word form (16-bit storage, nx a multiple of kWordCells):
// step_word_kernel takes kWordCells cells of one row per thread, so a warp
// is one row and every access of a plane is one aligned word a thread
// (lbm_common.cuh::Word): a warp moves whole 128-byte lines. With one cell
// a thread a warp's access of a 16-bit plane is 64 B, half a line, and the
// 16-bit forms took 0.95 (c16) and 0.89 (bf16) of the f32 form's time for
// half its bytes. The x-1 and x+1 pulls are rebuilt from the lane's own
// word and its neighbour lane's edge half (a shuffle, then __byte_perm);
// the first lane of a warp loads the 32-bit half before its span and the
// last the half after it, through the periodic wrap at the row's ends
// (x - 1 of column 0 is column nx - 1). The forcing of row ny-2 stays in
// the pull, its joint mask taken at each SOURCE cell (x - cx_k, shifted
// for the diagonal pulls) from that cell's unforced planes 3, 6, 7, as
// pull_collide does; those rows are warp-uniform and rare, so the mask's
// values are read per cell. Decode, forcing, collide_fused and encode are
// K1's, so the state is bitwise the one-cell form's; each thread adds its
// cells' |u| in cell order before the block tree (another order than the
// one-cell form's, so av agrees to rounding). Four cells a thread at four
// blocks per SM took less time than eight cells at one or two
// (trials/k12_words8.patch). With whole lines the 16-bit forms move their
// bytes in less time than their instructions take to issue: at c16 most
// of those are the codec's (lbm_common.cuh::C16). The one-cell step_kernel
// stays: it is the f32 form and the 16-bit form of widths the words do
// not tile (a row would not start on a word). ops/step.py picks the form
// by shape.
#include "lbm_common.cuh"

namespace {

// The one-cell form. The launch bounds ask for eight blocks per SM, which
// holds a thread to 32 registers (the f32 form's count): its 16-bit forms
// took 0.90 (c16) and 0.83 (bf16) of their time at six blocks (40
// registers) at 1024^2 (PERF.md).
template <class S>
__global__ void __launch_bounds__(lbm::kThreads, 8)
step_kernel(const typename S::T* __restrict__ src, typename S::T* __restrict__ dst,
            const float* __restrict__ nobst, float* __restrict__ partials,
            unsigned int* __restrict__ ticket, float* __restrict__ av_out,
            int ny, int nx, float w1a, float w2a, lbm::Relax rc, float inv_tot, S st) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = x < nx && y < ny;
  const size_t plane = (size_t)ny * nx;
  float u = 0.0f;
  if (inside) {
    float t[9];
    const float usq = lbm::pull_collide<false>(src, nobst, ny, nx, y, x, w1a, w2a, rc, t, st);
    const size_t c = (size_t)y * nx + x;
    u = nobst[c] * sqrtf(usq);
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k * plane + c] = st.store(t[k], k);
  }
  lbm::grid_sum_last_block(u, partials, ticket, inv_tot, av_out);
}

// The word form. The launch bounds ask for four blocks per SM, which holds
// a thread to 64 registers.
template <class S>
__global__ void __launch_bounds__(lbm::kThreads, 4)
step_word_kernel(const typename S::T* __restrict__ src, typename S::T* __restrict__ dst,
                 const float* __restrict__ nobst, float* __restrict__ partials,
                 unsigned int* __restrict__ ticket, float* __restrict__ av_out, int ny, int nx,
                 float w1a, float w2a, lbm::Relax rc, float inv_tot, S st) {
  using T = typename S::T;
  static_assert(sizeof(T) == 2, "the word form takes 16-bit storage");
  using W = lbm::Word;
  constexpr int kCells = lbm::kWordCells;
  const int lane = threadIdx.x;
  const int x0 = kCells * (blockIdx.x * blockDim.x + lane);  // the thread's first cell
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float u = 0.0f;
  if (y < ny) {  // warp-uniform: a warp is one row
    const size_t plane = (size_t)ny * nx;
    const bool active = x0 < nx;
    // Lanes whose pulls reach past the warp's span, and the 32-bit halves
    // they load there: the row's first lane wraps to column nx - 2, its last
    // (x0 + kCells == nx) to column 0.
    const bool first = active && lane == 0;
    const bool last = active && (lane == 31 || x0 + kCells == nx);
    const int before = x0 == 0 ? nx - 2 : x0 - 2;
    const int after = x0 + kCells == nx ? 0 : x0 + kCells;
    const int frow = ny - 2;
    const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
    // The raw pulls, plane k's cells x0 - cx(k) .. x0 + kCells - 1 - cx(k)
    // of row y - cy(k), held as words: each cell is decoded where it is
    // relaxed, so a thread holds 9 words and one cell's values at a time.
    W p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T* row = src + k * plane + (size_t)lbm::wrap(y - lbm::cy(k), ny) * nx;
      W w{};
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
    }
    if (active) {
      const size_t c0 = (size_t)y * nx + x0;
      float nb[kCells];
      lbm::load_mask(nobst + c0, nb);
      W o[9];
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        float t[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          t[k] = st.load(lbm::raw_of<T>(p[k].cell(c)), k);
          const int sy = lbm::wrap(y - lbm::cy(k), ny);
          if (fw[k] != 0.0f && sy == frow) {  // warp-uniform and rare: read the mask per cell
            auto rd = [&](int q, size_t s) { return st.load(src[q * plane + s], q); };
            const size_t s = (size_t)sy * nx + lbm::wrap(x0 + c - lbm::cx(k), nx);
            t[k] = t[k] + fw[k] * lbm::force_mask(rd(3, s), rd(6, s), rd(7, s), nobst[s], w1a,
                                                  w2a);
          }
        }
        const float usq = lbm::collide_fused(t, nb[c], rc);
        u += nb[c] * sqrtf(usq);
#pragma unroll
        for (int k = 0; k < 9; ++k) o[k].set_cell(c, lbm::bits_of(st.store(t[k], k)));
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) o[k].store(dst + k * plane + c0);
    }
  }
  lbm::grid_sum_last_block(u, partials, ticket, inv_tot, av_out);
}

template <class S>
int run(void* buf_a, void* buf_b, const float* nobst, float* av, float* partials,
        unsigned int* ticket, int ny, int nx, int n_steps, float w1a, float w2a,
        const lbm::Relax& rc, float inv_tot, int word, cudaStream_t s, const S& st) {
  using T = typename S::T;
  const dim3 block(lbm::kBlockX, lbm::kBlockY);
  dim3 grid = lbm::grid_for(ny, nx);
  if (word) {
    if (sizeof(T) != 2 || nx % lbm::kWordCells != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    grid.x = (nx / lbm::kWordCells + lbm::kBlockX - 1) / lbm::kBlockX;
  }
  for (int t = 0; t < n_steps; ++t) {
    const T* src = static_cast<const T*>((t & 1) ? buf_b : buf_a);
    T* dst = static_cast<T*>((t & 1) ? buf_a : buf_b);
    if constexpr (sizeof(T) == 2) {
      if (word) {
        step_word_kernel<S><<<grid, block, 0, s>>>(src, dst, nobst, partials, ticket, av + t, ny,
                                                   nx, w1a, w2a, rc, inv_tot, st);
      }
    }
    if (!word) {
      step_kernel<S><<<grid, block, 0, s>>>(src, dst, nobst, partials, ticket, av + t, ny, nx,
                                            w1a, w2a, rc, inv_tot, st);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Runs n_steps steps. buf_a holds the initial state; step t reads
// buf[t % 2] and writes buf[(t + 1) % 2], so the final state is in
// buf_a for even n_steps and in buf_b for odd. av receives n_steps values.
// partials needs one float per block of grid_for(ny, nx); ticket one
// zeroed unsigned int. storage: the planes' storage (lbm_common.cuh::
// Storage: f32, c16 int16 codes or bf16). word: 0 runs the one-cell form,
// 1 the word form (16-bit storage, nx a multiple of lbm::kWordCells,
// buffers and nobst 16-byte aligned). Returns the first CUDA error, or 0.
extern "C" int lbm_step_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                            float* partials, unsigned int* ticket, int ny, int nx,
                            int n_steps, float w1a, float w2a, float beta, float ow0,
                            float ow1, float ow2, float inv_tot, int word,
                            const lbm::Storage* storage, void* stream) {
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& st) {
    return run(buf_a, buf_b, nobst, av, partials, ticket, ny, nx, n_steps, w1a, w2a, rc, inv_tot,
               word, s, st);
  });
}

// Registers per thread, local memory per thread (bytes) and resident
// blocks per SM of the step kernel of one form (word 0 or 1) and
// storage kind, into out[0..2]. Returns the first CUDA error, or 0.
extern "C" int lbm_step_attrs(int word, int kind, int* out) {
  const void* fn = nullptr;
  if (!word) {
    fn = kind == lbm::kStorageF32    ? (const void*)step_kernel<lbm::F32>
         : kind == lbm::kStorageC16 ? (const void*)step_kernel<lbm::C16>
                                    : (const void*)step_kernel<lbm::BF16>;
  } else if (kind != lbm::kStorageF32) {
    fn = kind == lbm::kStorageC16 ? (const void*)step_word_kernel<lbm::C16>
                                  : (const void*)step_word_kernel<lbm::BF16>;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return lbm::func_attrs(fn, out);
}

extern "C" unsigned int lbm_step_num_blocks(int ny, int nx) {
  const dim3 g = lbm::grid_for(ny, nx);
  return g.x * g.y;
}
