// K6: T steps per pass on a shrinking trapezoid, halos read from the input
// state.
//
// Replaces: lbm_tpu/ops/pallas_deep.py::_kernel (with _make_call), the
// temporal kernel whose (9, T, nx) halo strips are views of the read-only
// input state, the output going to a fresh buffer.
//
// What bounds it on the H100: the work inside the window, not HBM. A pass
// reads each tile's window once (the 9 planes and the not-obstacle plane,
// 40 B per window cell) and writes its central cells once (36 B), so a
// step moves about 76 / T B per cell plus the halo's share, well under
// what the steps take; shared memory sizes the window, and the window's
// size sets the updates per output cell. A pull between two window copies
// (the TPU kernel's two VMEM buffers) takes 76 B of shared memory per
// window cell, which holds two blocks per SM to a 40 x 32 window.
//
// What the design does about it: one block per B x P tile on the
// trapezoid in ONE window copy, 40 B per cell, stepped in place in the AA
// arrangement (trapezoid.cuh), so two blocks per SM hold a window twice as
// large, which the trapezoid updates fewer times per output cell.
// The input state is read-only during a pass, so the window, halo rows and
// columns included, is loaded straight from it with wrapped global indices
// (the TPU kernel's strip BlockSpecs; T % 8 == 0 and B % T == 0 existed for
// them and do not apply). The central cells go to the other state buffer,
// every pass of a run is issued by one C call, odd passes taking the
// tiles from the last one back (band_common.cuh::pass_order: a pass
// starts where the one before ended, in the L2), and the per-step sums
// are reduced in a fixed order (band_common.cuh::finish_sums).
//
// K6 at c16 (pallas_deep.py:114-116, :157-163, ``dev=``): templated on the
// storage of lbm_common.cuh. The window, halos included, is decoded from
// the int16 input state as it is read and the tile encoded as it is stored:
// one rounding per pass of T steps, 40 B per cell per pass.
//
// K6 at bf16 (pallas_deep.py:161, ``buf[k].astype(out_dtype)``): the
// window is widened from the bfloat16 input state and the tile rounded
// to nearest even as it is stored (lbm_common.cuh::BF16), once per pass.
#include "trapezoid.cuh"

namespace {

template <class L, class S>
__global__ void __launch_bounds__(band::kThreads)
deep_kernel(const typename S::T* __restrict__ src, typename S::T* __restrict__ dst,
            const float* __restrict__ nobst, float* __restrict__ partials,
            unsigned int* __restrict__ ticket, float* __restrict__ av, band::Geom g, L lay,
            float w1a, float w2a, lbm::Relax rc, float inv_tot, S io) {
  using T = typename S::T;
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 1);
  const trap::Tile tl = trap::begin(g, s);
  __syncthreads();
  const band::SourceT<T> from{src, nobst, nullptr, nullptr, nullptr, nullptr};
  trap::load(g, s, tl, lay, w1a, w2a, [&](int r, int c, float* v) {
    return band::load_cell<false>(g, s, from, tl.y0, r, c, v, io);
  });
  trap::steps(g, s, tl, lay, w1a, w2a, rc);
  trap::store(g, s, tl, lay, dst, io, [](int, int, const T*) {});
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

template <class S>
int run(typename S::T* buf_a, typename S::T* buf_b, const float* nobst, float* av,
        float* partials, unsigned int* ticket, const band::Geom& g, int n_passes, float w1a,
        float w2a, const lbm::Relax& rc, float inv_tot, cudaStream_t st, const S& io) {
  using T = typename S::T;
  const size_t smem = band::smem_bytes(g, 1);
  return trap::with_layout(g, [&](auto lay) {
    using L = decltype(lay);
    const cudaError_t err = band::allow_smem(deep_kernel<L, S>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return band::run_passes(n_passes, g.T, buf_a, buf_b, av,
                            [&](const T* src, T* dst, float* av_p, int p) {
      lbm::count_launch();
      deep_kernel<L, S><<<g.nty * g.ntx, band::kThreads, smem, st>>>(
          src, dst, nobst, partials, ticket, av_p, band::pass_order(g, p), lay, w1a, w2a, rc,
          inv_tot, io);
    });
  });
}

}  // namespace

// Runs n_passes passes of ``depth`` steps (any depth >= 1) on B x P tiles.
// buf_a holds the initial state; pass p reads buf[p % 2] and writes
// buf[(p + 1) % 2]. av receives n_passes * depth values; partials needs
// depth * lbm_band_num_tiles floats; ticket one zeroed unsigned int.
// storage: the planes' storage (lbm_common.cuh::Storage: f32, c16 int16
// codes or bf16). Returns the first CUDA error, or 0.
extern "C" int lbm_deep_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                            float* partials, unsigned int* ticket, int ny, int nx, int block,
                            int depth, int panel, int n_passes, float w1a, float w2a, float beta,
                            float ow0, float ow1, float ow2, float inv_tot,
                            const lbm::Storage* storage, void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& io) {
    using T = lbm::Raw<decltype(io)>;
    return run(static_cast<T*>(buf_a), static_cast<T*>(buf_b), nobst, av, partials, ticket, g,
               n_passes, w1a, w2a, rc, inv_tot, st, io);
  });
}

// Registers per thread, local memory per thread (bytes) and resident blocks
// per SM of K6 on the window of a schedule, at its dynamic shared memory
// and its storage, into out[0..2]. Returns the first CUDA error, or 0.
extern "C" int lbm_deep_attrs(int ny, int nx, int block, int depth, int panel,
                              const lbm::Storage* storage, int* out) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const size_t smem = band::smem_bytes(g, 1);
  return lbm::with_storage(storage, [&](const auto& io) {
    using S = std::decay_t<decltype(io)>;
    return trap::with_layout(g, [&](auto lay) {
      const auto fn = deep_kernel<decltype(lay), S>;
      const cudaError_t err = band::allow_smem(fn, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      return lbm::func_attrs((const void*)fn, out, band::kThreads, smem);
    });
  });
}
