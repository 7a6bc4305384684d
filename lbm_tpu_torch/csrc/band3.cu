// K11: the band pass on ONE shared-memory window in the AA arrangement.
//
// Replaces: lbm_tpu/ops/pallas_band3.py::_kernel3 (:306) and
// ::_kernel3_panel (:408), the band schedule on one VMEM scratch buffer
// with the AA even/odd alternation. Full row and panel are one kernel here:
// every tile is B x P with a T-cell halo (band_common.cuh).
//
// The window holds the S arrangement on entry and exit (device memory keeps
// S between passes, in two copies, because neighbouring tiles read each
// other's halos). Steps alternate even (S -> C), odd (C -> S) as in K2
// (aa.cu), in place with one barrier each (band_common.cuh::aa_step, which
// K9 shares). Garbage creeps 0 + 2 cells per double step: T over T steps,
// so the central tile stays genuine.
//
// Forcing of the window rows whose global row is ny-2:
//   - the even step adds the C-space forcing of the odd step that follows
//     to the cell's own outputs before writing them (pallas_band3.py
//     applies it as a 1-row update at the start of the odd step: same
//     values, same arithmetic);
//   - the odd step fuses the NEXT even step's S-space forcing: the cell on
//     a forcing row adds the delta to its own scattered values, with the
//     mask from its own f*_3, f*_6, f*_7 (pallas_band3.py:261-280);
//   - the last odd step of a run's final pass is not fused, so the stored
//     state is unforced for the S -> R exit: the entry's fuse_last says
//     whether the last pass of a call fuses. The run's first forcing is
//     applied to the full S state before the first pass (ops/band3.py).
//     The TPU runs the final pass as two calls, (T-2, fused) + (2,
//     unfused), each storing the state: at f32 one pass computes the same,
//     at 16-bit storage the split is one more rounding, so ops/band3.py
//     issues those two calls at c16 and bf16 (pallas_band3.py:669-677).
//
// What bounds it on the H100: shared memory, at 40 B per window cell (one
// copy of 9 f32 planes and the not-obstacle value), about half of K9's, so
// a block holds ~5,800 cells and the halo redundancy (B+2T)(P+2T)/(BP) can
// be lower than K9's at the same footprint. Each step reads and writes 9
// values per window cell in shared memory, with one barrier; the odd step's
// accesses at +-1 rows and columns cost extra bank traffic at row ends.
// What the design does about it: one thread per window cell in each sweep,
// consecutive threads on consecutive columns; in place, so no second
// buffer. TMA, clusters and register tiling are later work.
//
// c16 storage (pallas_band3.py:330-372, :427-470): device memory holds int16
// codes of the S arrangement, keyed by slot; the window loader decodes and
// the tile store encodes (band_common.cuh), and the window stays f32. The
// run's first forcing decodes, forces and re-encodes rows ny-3..ny-1 outside
// the kernel (ops/band3.py::force_s). 40 B per cell per pass.
//
// bf16 storage (``mid.astype(out_dtype)`` at pallas_band3.py:370, :468):
// the same on lbm_common.cuh::BF16, one rounding per pass; the run's
// first forcing widens, forces and rounds rows ny-3..ny-1 once more
// outside the kernel (pallas_band3.py:558-561, ops/band3.py::force_s).
#include "band_common.cuh"

namespace {

template <class S>
__global__ void __launch_bounds__(band::kThreads)
band3_kernel(const typename S::T* __restrict__ src, typename S::T* __restrict__ dst,
             const float* __restrict__ nobst, float* __restrict__ partials,
             unsigned int* __restrict__ ticket, float* __restrict__ av, band::Geom g, float w1a,
             float w2a, lbm::Relax rc, float inv_tot, int fuse_last, S st) {
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 1);
  int y0, x0;
  band::fill_tables(g, s, y0, x0);
  __syncthreads();
  float* w = s.planes;
  band::load_window<false>(
      g, s, w, band::SourceT<typename S::T>{src, nobst, nullptr, nullptr, nullptr, nullptr}, 0, st);
  __syncthreads();
  const band::Central cen = band::central(g, y0, x0);
  const int frow = g.ny - 2;
  const int half = g.T / 2;
  for (int h = 0; h < half; ++h) {
    band::aa_step<false>(g, s, w, cen, frow, true, w1a, w2a, rc, 2 * h);
    band::aa_step<true>(g, s, w, cen, frow, fuse_last || h + 1 < half, w1a, w2a, rc, 2 * h + 1);
  }
  band::store_tile(g, w, dst, y0, x0, st);
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

template <class S>
int run(typename S::T* buf_a, typename S::T* buf_b, const float* nobst, float* av,
        float* partials, unsigned int* ticket, const band::Geom& g, int n_passes, int fuse_last,
        float w1a, float w2a, const lbm::Relax& rc, float inv_tot, cudaStream_t st,
        const S& stor) {
  const size_t smem = band::smem_bytes(g, 1);
  const cudaError_t err = band::allow_smem(band3_kernel<S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return band::run_passes(n_passes, g.T, buf_a, buf_b, av,
                          [&](const typename S::T* src, typename S::T* dst, float* av_p, int p) {
    band3_kernel<S><<<g.nty * g.ntx, band::kThreads, smem, st>>>(
        src, dst, nobst, partials, ticket, av_p, g, w1a, w2a, rc, inv_tot,
        fuse_last || p + 1 < n_passes, stor);
  });
}

}  // namespace

// Runs n_passes in-place AA band passes of ``depth`` steps (even) on B x P
// tiles. buf_a holds the forced S arrangement on entry; pass p reads
// buf[p % 2] and writes buf[(p + 1) % 2], both in S. Every pass but the
// last fuses the next pass's first forcing, the last too when fuse_last
// is not 0 (a call that another call of passes follows). av receives
// n_passes * depth values; partials needs depth * lbm_band_num_tiles
// floats; ticket one zeroed unsigned int. storage: the planes' storage
// (lbm_common.cuh::Storage: f32, c16 int16 codes or bf16). Returns the
// first CUDA error, or 0.
extern "C" int lbm_band3_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                             float* partials, unsigned int* ticket, int ny, int nx, int block,
                             int depth, int panel, int n_passes, int fuse_last, float w1a,
                             float w2a, float beta, float ow0, float ow1, float ow2,
                             float inv_tot, const lbm::Storage* storage, void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& stor) {
    using T = lbm::Raw<decltype(stor)>;
    return run(static_cast<T*>(buf_a), static_cast<T*>(buf_b), nobst, av, partials, ticket, g,
               n_passes, fuse_last, w1a, w2a, rc, inv_tot, st, stor);
  });
}
