// K7: the band pass with each cell's 9 values carried in registers.
//
// Replaces: lbm_tpu/ops/pallas_band.py::_kernel (:172) and ::_kernel_panel
// (:387), the band creep with the 9 window planes carried as fori_loop
// values and shifted by whole-plane rolls. Full row and panel are one
// kernel here: every tile is B x P with a T-cell halo (band_common.cuh).
//
// The counterpart of "planes carried as values": each thread keeps the 9
// values of its window cells (at most MAXC of them) in registers across the
// T steps. Each step it applies the forcing of the ny-2 rows to its own
// cells, writes the values to one shared-memory exchange window, syncs,
// pulls its 9 streamed values from the neighbours' slots (wrapping at the
// window's edges, as the rolls wrap the TPU buffer), syncs, and collides.
// No in-place trick: one window of 36 B per cell plus the not-obstacle
// value, and two barriers per step.
//
// What bounds it on the H100: registers and barriers. 512 threads hold at
// most 8 cells each (72 values), so a window has at most 4,096 cells, and
// the halo redundancy (B+2T)(P+2T)/(BP) is the price of touching device
// memory once per T steps. Each step moves 9 values per cell through shared
// memory twice (write, pull) and pays two block-wide barriers. What the
// design does about it: the collision runs on registers, shared memory only
// carries the exchange, and the output is stored straight from registers.
// TMA, clusters and register tiling across warps are later work.
//
// K8: the same kernel on the shards of a 1-D mesh (kSharded). Replaces
// lbm_tpu/ops/pallas_band.py::_kernel_sharded (:574) and
// ::_kernel_sharded_panel (:776): one pass of T steps over one shard's rows,
// the window's y halo read from the neighbour shards' T edge rows, copied
// once per pass (band_common.cuh: Source, halo_rows_kernel), and the
// forcing at every window row whose global row is ny-2. Bound as K7: the
// halo copy adds 2T rows per shard per pass, 2T/ny_shard of the pass's
// bytes.
#include "band_common.cuh"

namespace {

template <int MAXC, bool kSharded>
__global__ void __launch_bounds__(band::kThreads)
band_kernel(band::Source src, float* __restrict__ dst, float* __restrict__ partials,
            unsigned int* __restrict__ ticket, float* __restrict__ av, band::Geom g, float w1a,
            float w2a, lbm::Relax rc, float inv_tot) {
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 1);
  const size_t plane = (size_t)g.ny * g.nx;
  const size_t z = blockIdx.y;  // the shard (0 on one grid)
  src = band::shard(g, src);
  dst += z * 9 * plane;
  partials += z * g.T * g.nty * g.ntx;
  ticket += z;
  av += z * g.av_stride;
  int y0, x0;
  band::fill_tables(g, s, y0, x0);
  __syncthreads();
  float* x = s.planes;
  const int n = g.ncell;
  float v[MAXC][9];
  int rr[MAXC], cc[MAXC];  // window row and column of each cell; rr < 0: none
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int i = threadIdx.x + j * band::kThreads;
    rr[j] = -1;
    cc[j] = 0;
    if (i < n) {
      rr[j] = i / g.WW;
      cc[j] = i - rr[j] * g.WW;
      s.nob[i] = band::load_cell<kSharded>(g, s, src, y0, rr[j], cc[j], v[j]);
    }
  }
  __syncthreads();
  const band::Central cen = band::central(g, y0, x0);
  const int frow = g.nyg - 2;
  for (int st = 0; st < g.T; ++st) {
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {  // force, then publish
      if (rr[j] < 0) continue;
      const int i = rr[j] * g.WW + cc[j];
      if (s.grow[rr[j]] == frow) band::force_cell(v[j], s.nob[i], w1a, w2a);
#pragma unroll
      for (int k = 0; k < 9; ++k) x[k * n + i] = v[j][k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {  // pull
      if (rr[j] < 0) continue;
      const int r = rr[j], c = cc[j];
      const int ru = band::wrap1(r - 1, g.WH), rd = band::wrap1(r + 1, g.WH);
      const int cl = band::wrap1(c - 1, g.WW), cr = band::wrap1(c + 1, g.WW);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int sr = lbm::cy(k) == 1 ? ru : (lbm::cy(k) == -1 ? rd : r);
        const int sc = lbm::cx(k) == 1 ? cl : (lbm::cx(k) == -1 ? cr : c);
        v[j][k] = x[k * n + sr * g.WW + sc];
      }
    }
    __syncthreads();
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {  // collide
      if (rr[j] < 0) continue;
      const float nob = s.nob[rr[j] * g.WW + cc[j]];
      const float usq = lbm::collide_fused(v[j], nob, rc);
      if (cen.has(rr[j], cc[j])) acc += nob * sqrtf(usq);
    }
    band::step_partial(s, st, acc);
  }
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {  // store the central cells from registers
    if (rr[j] < 0 || !cen.has(rr[j], cc[j])) continue;
    const size_t gi = (size_t)(y0 + rr[j] - g.T) * g.nx + (x0 + cc[j] - g.T);
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k * plane + gi] = v[j][k];
  }
  __syncthreads();
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

template <int MAXC, bool kSharded>
int run(const band::Geom& g, const band::Shards* sh, float* buf_a, float* buf_b,
        const band::Source& src, float* av, float* partials, unsigned int* ticket, int n_passes,
        float w1a, float w2a, const lbm::Relax& rc, float inv_tot, cudaStream_t st) {
  const size_t smem = band::smem_bytes(g, 1);
  const cudaError_t err = band::allow_smem(band_kernel<MAXC, kSharded>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.nty * g.ntx, kSharded ? sh->count : 1);
  auto launch = [&](const float* from, float* to, float* av_p, int) {
    band::Source s = src;
    s.cells = from;
    band_kernel<MAXC, kSharded><<<grid, band::kThreads, smem, st>>>(
        s, to, partials, ticket, av_p, g, w1a, w2a, rc, inv_tot);
  };
  if constexpr (kSharded) return band::run_sharded_passes(g, *sh, n_passes, buf_a, buf_b, av, st, launch);
  return band::run_passes(n_passes, g.T, buf_a, buf_b, av, launch);
}

template <bool kSharded>
int run_any(const band::Geom& g, const band::Shards* sh, float* buf_a, float* buf_b,
            const band::Source& src, float* av, float* partials, unsigned int* ticket,
            int n_passes, float w1a, float w2a, const lbm::Relax& rc, float inv_tot,
            cudaStream_t st) {
  if (g.ncell <= 4 * band::kThreads) {
    return run<4, kSharded>(g, sh, buf_a, buf_b, src, av, partials, ticket, n_passes, w1a, w2a,
                            rc, inv_tot, st);
  }
  if (g.ncell <= 8 * band::kThreads) {
    return run<8, kSharded>(g, sh, buf_a, buf_b, src, av, partials, ticket, n_passes, w1a, w2a,
                            rc, inv_tot, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Runs n_passes band passes of ``depth`` steps on B x P tiles; the window
// (B + 2T) x (P + 2T) may hold at most 8 * 512 cells. buf_a holds the
// initial state; pass p reads buf[p % 2] and writes buf[(p + 1) % 2]. av
// receives n_passes * depth values; partials needs depth *
// lbm_band_num_tiles floats; ticket one zeroed unsigned int. Returns the
// first CUDA error (cudaErrorInvalidValue for a window too large), or 0.
extern "C" int lbm_band_run(float* buf_a, float* buf_b, const float* nobst, float* av,
                            float* partials, unsigned int* ticket, int ny, int nx, int block,
                            int depth, int panel, int n_passes, float w1a, float w2a, float beta,
                            float ow0, float ow1, float ow2, float inv_tot, void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  const band::Source src{buf_a, nobst, nullptr, nullptr, nullptr, nullptr};
  return run_any<false>(g, nullptr, buf_a, buf_b, src, av, partials, ticket, n_passes, w1a, w2a,
                        rc, inv_tot, static_cast<cudaStream_t>(stream));
}

// K8: n_passes passes over shards [s0, s0 + count) of a 1-D mesh of
// nshards shards of ny rows (shard z holds global rows [z*ny, (z+1)*ny)),
// stacked in buf_a and buf_b (count, 9, ny, nx). The first pass reads
// buf_a when parity is even, else buf_b; the passes alternate. table holds
// 2 * nshards addresses on this card: each shard's two buffers, of this
// call or another, on this card or a peer. Each pass first copies the
// call's halo_dn, halo_up (count, 9, depth, nx) from the neighbour shards'
// edge rows of the pass's source buffer. nobst (count, ny, nx) and nob_dn,
// nob_up (count, depth, nx) hold the mask and its halos. av receives count
// x (n_passes * depth) values (shard-major, av_stride apart); partials
// count * depth * lbm_band_num_tiles floats; ticket count zeroed unsigned
// ints. Returns the first CUDA error, or 0.
extern "C" int lbm_band_sharded_run(const unsigned long long* table, int s0, int count,
                                    int nshards, float* buf_a, float* buf_b, float* halo_dn,
                                    float* halo_up, const float* nobst, const float* nob_dn,
                                    const float* nob_up, float* av, int av_stride,
                                    float* partials, unsigned int* ticket, int ny, int nx,
                                    int block, int depth, int panel, int parity, int n_passes,
                                    float w1a, float w2a, float beta, float ow0, float ow1,
                                    float ow2, float inv_tot, void* stream) {
  const band::Shards sh{table, s0, count, nshards, parity, halo_dn, halo_up};
  const band::Geom g = band::make_sharded_geom(ny, nx, block, depth, panel, sh, av_stride);
  if (depth > ny || count < 1 || s0 < 0 || s0 + count > nshards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  const band::Source src{buf_a, nobst, halo_dn, halo_up, nob_dn, nob_up};
  return run_any<true>(g, &sh, buf_a, buf_b, src, av, partials, ticket, n_passes, w1a, w2a, rc,
                       inv_tot, static_cast<cudaStream_t>(stream));
}

// Output tiles of a band schedule (all three band kernels): one block each.
extern "C" unsigned int lbm_band_num_tiles(int ny, int nx, int block, int panel) {
  return (unsigned int)(((ny + block - 1) / block) * ((nx + panel - 1) / panel));
}
