// K5: T steps per pass on a shrinking trapezoid, halo rows from carried
// row packs.
//
// Replaces: lbm_tpu/ops/pallas_temporal.py::_kernel (with _make_call), the
// temporally blocked kernel whose row blocks read their neighbours' first
// and last T rows from packed (nblk, 9T, nx) side arrays and write their
// own output's as the next pass's.
//
// The carried state is (cells, last_t, first_t). Packs are indexed by the
// block that produced them, plane k at pack rows [kT, kT + T): last_t[j]
// holds block j's last T rows, first_t[j] its first T. Tile (i, x) takes
// its window's top T rows from last_t[i - 1], its bottom T rows from
// first_t[i + 1] (both wrapped over the blocks, corners included: the packs
// are full width), its own rows and the x halo from the input state, which
// no block writes during the pass. After the T steps it stores its central
// cells to the other state buffer and its first and last T output rows to
// the other pack buffers. A block's packs are its own rows, so every block,
// the last one of a ragged grid included, has at least T rows.
//
// What bounds it on the H100: as K6 (deep.cu), the work inside the window
// and the shared memory that sizes the window; the packs add 2T rows read
// and 2T written per block of B rows, where K6 reads its halo from the
// state.
//
// What the design does about it: one block per B x P tile on the shared
// trapezoid in one window copy, stepped in place (trapezoid.cuh); the
// threads that store tile rows [0, T) and [bi - T, bi) store the pack rows
// from the same encoded values in the same loop; all passes
// of a run from one C call, the state and the packs ping-ponging between
// two buffers each; per-step sums in a fixed order
// (band_common.cuh::finish_sums).
//
// K5 at c16 (pallas_temporal.py:145-149, :200-210, ``dev=``): templated on
// the storage of lbm_common.cuh. The state and the packs hold int16 codes;
// each of the window's three sources (the pack above, the state, the pack
// below) is decoded as it is read, and the tile and both packs are encoded
// from the same f32 values, so a pack holds exactly the codes of the state
// rows it copies (the JAX kernel stores its encoded ``val`` into both). One
// rounding per pass of T steps; the window and the steps stay f32.
//
// K5 at bf16 (pallas_temporal.py:204, ``buf[k].astype(out_dtype)``, one
// ``val`` stored into the tile and both packs): the state and the packs
// hold bfloat16, widened as read and rounded once from the same f32
// values (lbm_common.cuh::BF16), so a pack is the bits of the state rows
// it copies.
#include "trapezoid.cuh"

namespace {

template <class L, class S>
__global__ void __launch_bounds__(band::kThreads)
temporal_kernel(const typename S::T* __restrict__ src, const typename S::T* __restrict__ last_in,
                const typename S::T* __restrict__ first_in, typename S::T* __restrict__ dst,
                typename S::T* __restrict__ last_out, typename S::T* __restrict__ first_out,
                const float* __restrict__ nobst, float* __restrict__ partials,
                unsigned int* __restrict__ ticket, float* __restrict__ av, band::Geom g, L lay,
                float w1a, float w2a, lbm::Relax rc, float inv_tot, S io) {
  using T = typename S::T;
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 1);
  const trap::Tile tl = trap::begin(g, s);
  __syncthreads();
  const int Tn = g.T;
  const size_t plane = (size_t)g.ny * g.nx;
  const int ty = band::tile_id(g) / g.ntx;
  const size_t pack = (size_t)9 * Tn * g.nx;  // one block's pack
  const T* above = last_in + (size_t)((ty + g.nty - 1) % g.nty) * pack;
  const T* below = first_in + (size_t)((ty + 1) % g.nty) * pack;
  trap::load(g, s, tl, lay, w1a, w2a, [&](int r, int c, float* v) {
    const int gc = s.gcol[c];
    if (r < Tn) {
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = io.load(above[(size_t)(k * Tn + r) * g.nx + gc], k);
    } else if (r < Tn + tl.bi) {
      const size_t gi = (size_t)(tl.y0 + r - Tn) * g.nx + gc;
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = io.load(src[k * plane + gi], k);
    } else {
      const int q = r - Tn - tl.bi;
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = io.load(below[(size_t)(k * Tn + q) * g.nx + gc], k);
    }
    return nobst[(size_t)s.grow[r] * g.nx + gc];
  });
  trap::steps(g, s, tl, lay, w1a, w2a, rc);
  // This block's packs: its first and last T output rows, its columns.
  T* first_o = first_out + (size_t)ty * pack;
  T* last_o = last_out + (size_t)ty * pack;
  const int lo = tl.bi - Tn;  // the first tile row of the last pack
  trap::store(g, s, tl, lay, dst, io, [&](int r, int x, const T* e) {
    if (r < Tn) {
#pragma unroll
      for (int k = 0; k < 9; ++k) first_o[(size_t)(k * Tn + r) * g.nx + x] = e[k];
    }
    if (r >= lo) {
#pragma unroll
      for (int k = 0; k < 9; ++k) last_o[(size_t)(k * Tn + r - lo) * g.nx + x] = e[k];
    }
  });
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

template <class S>
int run(void* const bufs[6], const float* nobst, float* av, float* partials,
        unsigned int* ticket, const band::Geom& g, int n_passes, float w1a, float w2a,
        const lbm::Relax& rc, float inv_tot, cudaStream_t st, const S& io) {
  using T = typename S::T;
  const size_t smem = band::smem_bytes(g, 1);
  T* last_a = static_cast<T*>(bufs[2]);
  T* first_a = static_cast<T*>(bufs[3]);
  T* last_b = static_cast<T*>(bufs[4]);
  T* first_b = static_cast<T*>(bufs[5]);
  return trap::with_layout(g, [&](auto lay) {
    using L = decltype(lay);
    const cudaError_t err = band::allow_smem(temporal_kernel<L, S>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return band::run_passes(n_passes, g.T, static_cast<T*>(bufs[0]), static_cast<T*>(bufs[1]),
                            av, [&](const T* src, T* dst, float* av_p, int p) {
      const bool odd = (p & 1) != 0;
      lbm::count_launch();
      temporal_kernel<L, S><<<g.nty * g.ntx, band::kThreads, smem, st>>>(
          src, odd ? last_b : last_a, odd ? first_b : first_a, dst, odd ? last_a : last_b,
          odd ? first_a : first_b, nobst, partials, ticket, av_p, band::pass_order(g, p), lay,
          w1a, w2a, rc, inv_tot, io);
    });
  });
}

}  // namespace

// Runs n_passes passes of ``depth`` steps (any depth >= 1) on B x P tiles.
// state_a, last_a and first_a hold the initial state and its packs ((nblk,
// 9 * depth, nx) each, nblk = ceil(ny / block)); pass p reads the [p % 2]
// buffers and writes the [(p + 1) % 2] ones. av receives n_passes * depth
// values; partials needs depth * lbm_band_num_tiles floats; ticket one
// zeroed unsigned int. storage: the storage of the state and the packs
// alike (lbm_common.cuh::Storage: f32, c16 int16 codes or bf16). Returns
// the first CUDA error, or 0.
extern "C" int lbm_temporal_run(void* state_a, void* state_b, void* last_a, void* first_a,
                                void* last_b, void* first_b, const float* nobst, float* av,
                                float* partials, unsigned int* ticket, int ny, int nx, int block,
                                int depth, int panel, int n_passes, float w1a, float w2a,
                                float beta, float ow0, float ow1, float ow2, float inv_tot,
                                const lbm::Storage* storage, void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* const bufs[6] = {state_a, state_b, last_a, first_a, last_b, first_b};
  return lbm::with_storage(storage, [&](const auto& io) {
    return run(bufs, nobst, av, partials, ticket, g, n_passes, w1a, w2a, rc, inv_tot, st, io);
  });
}
