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
// What bounds it on the H100: as K6 (deep.cu), device-memory bytes and the
// 76 B of shared memory per window cell; the packs add 2T rows read and 2T
// written per block of B rows, where K6 reads its halo from the state.
//
// What the design does about it: one block per B x P tile on the shared
// trapezoid (trapezoid.cuh); all passes of a run from one C call, the
// state and the packs ping-ponging between two buffers each; per-step sums
// in a fixed order (band_common.cuh::finish_sums).
#include "trapezoid.cuh"

namespace {

__global__ void __launch_bounds__(band::kThreads)
temporal_kernel(const float* __restrict__ src, const float* __restrict__ last_in,
                const float* __restrict__ first_in, float* __restrict__ dst,
                float* __restrict__ last_out, float* __restrict__ first_out,
                const float* __restrict__ nobst, float* __restrict__ partials,
                unsigned int* __restrict__ ticket, float* __restrict__ av, band::Geom g, float w1a,
                float w2a, lbm::Relax rc, float inv_tot) {
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 2);
  const trap::Tile tl = trap::begin(g, s);
  __syncthreads();
  float* a = s.planes;
  float* b = s.planes + 9 * g.ncell;
  const int T = g.T;
  const size_t plane = (size_t)g.ny * g.nx;
  const int ty = blockIdx.x / g.ntx;
  const size_t pack = (size_t)9 * T * g.nx;  // one block's pack
  const float* above = last_in + (size_t)((ty + g.nty - 1) % g.nty) * pack;
  const float* below = first_in + (size_t)((ty + 1) % g.nty) * pack;
  band::for_cells(tl.wh, tl.ww, [&](int r, int c) {
    const int gc = s.gcol[c];
    const int i = r * g.WW + c;
    if (r < T) {
#pragma unroll
      for (int k = 0; k < 9; ++k) a[k * g.ncell + i] = above[(size_t)(k * T + r) * g.nx + gc];
    } else if (r < T + tl.bi) {
      const size_t gi = (size_t)(tl.y0 + r - T) * g.nx + gc;
#pragma unroll
      for (int k = 0; k < 9; ++k) a[k * g.ncell + i] = src[k * plane + gi];
    } else {
      const int q = r - T - tl.bi;
#pragma unroll
      for (int k = 0; k < 9; ++k) a[k * g.ncell + i] = below[(size_t)(k * T + q) * g.nx + gc];
    }
    s.nob[i] = nobst[(size_t)s.grow[r] * g.nx + gc];
  });
  __syncthreads();
  const float* out = trap::steps(g, s, tl, a, b, w1a, w2a, rc);
  band::store_tile(g, out, dst, tl.y0, tl.x0);
  // This block's packs: its first and last T output rows, its columns.
  float* first_o = first_out + (size_t)ty * pack;
  float* last_o = last_out + (size_t)ty * pack;
  band::for_cells(T, tl.pi, [&](int q, int c) {
    const int x = tl.x0 + c;
    const int i_first = (T + q) * g.WW + (T + c);
    const int i_last = (tl.bi + q) * g.WW + (T + c);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      first_o[(size_t)(k * T + q) * g.nx + x] = out[k * g.ncell + i_first];
      last_o[(size_t)(k * T + q) * g.nx + x] = out[k * g.ncell + i_last];
    }
  });
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

}  // namespace

// Runs n_passes passes of ``depth`` steps on B x P tiles. state_a, last_a
// and first_a hold the initial state and its packs ((nblk, 9 * depth, nx)
// each, nblk = ceil(ny / block)); pass p reads the [p % 2] buffers and
// writes the [(p + 1) % 2] ones. av receives n_passes * depth values;
// partials needs depth * lbm_band_num_tiles floats; ticket one zeroed
// unsigned int. Returns the first CUDA error, or 0.
extern "C" int lbm_temporal_run(float* state_a, float* state_b, float* last_a, float* first_a,
                                float* last_b, float* first_b, const float* nobst, float* av,
                                float* partials, unsigned int* ticket, int ny, int nx, int block,
                                int depth, int panel, int n_passes, float w1a, float w2a,
                                float beta, float ow0, float ow1, float ow2, float inv_tot,
                                void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  const size_t smem = band::smem_bytes(g, 2);
  const cudaError_t err = band::allow_smem(temporal_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return band::run_passes(n_passes, depth, state_a, state_b, av,
                          [&](const float* src, float* dst, float* av_p, int p) {
    const bool odd = (p & 1) != 0;
    temporal_kernel<<<g.nty * g.ntx, band::kThreads, smem, st>>>(
        src, odd ? last_b : last_a, odd ? first_b : first_a, dst, odd ? last_a : last_b,
        odd ? first_a : first_b, nobst, partials, ticket, av_p, g, w1a, w2a, rc, inv_tot);
  });
}
