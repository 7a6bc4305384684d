// K9: the band pass in ONE shared-memory window, stepped in the AA
// arrangement.
//
// Replaces: lbm_tpu/ops/pallas_band2.py::_kernel2 (:90) and
// ::_kernel2_panel (:382), the band schedule with two VMEM scratch buffers
// and T/2 double-steps. Full row and panel are one kernel here: every tile
// is two-dimensional, B rows by P columns, with a T-cell halo on each side
// (band_common.cuh), because no full row of a large grid fits the 227 KB of
// shared memory a block can use.
//
// What bounds it on the H100: the work inside the window, not HBM (its time
// did not follow its bytes at 16 bits). The window's size sets the
// redundancy (B+2T)(P+2T)/(BP) of the recomputed halo, both in cell
// updates and in loads, and shared memory sets the window's size: the
// TPU kernel's pull between two f32 copies of the 9 planes costs 76 B per
// window cell, which holds two blocks per SM to a 32 x 32 window (1.78
// updates per output cell).
//
// What the design does about it: one copy, 40 B per window cell, as K11
// (band3.cu), so two blocks per SM hold a 40 x 64 window (1.52). The window
// steps in place in K11's AA arrangement, with device memory keeping the
// regular arrangement R of the state: the one-window pass of
// band_common.cuh (aa_load, aa_steps, aa_store), which K7, K8 and K13
// (band.cu) run too. K9 takes an even T (the JAX package's domain,
// ops/band2.py), so its passes end on the cell-local step and the store
// reads R_k of each central cell from its slot opp(k). One barrier per
// step; at f32 the state is bitwise K1's.
//
// K10: the same kernel on the shards of a 1-D mesh (kSharded). Replaces
// lbm_tpu/ops/pallas_band2.py::_kernel2_sharded (:584) and
// ::_kernel2_sharded_panel (:840), with K8's protocol (band.cu): the
// window's y halo from the neighbour shards' T edge rows, copied once per
// pass, the forcing at every window row whose global row is ny-2. The JAX
// package's two protocol variants (LBM_SHARD_LEAN, LBM_SHARD_FORCE) compute
// this same function in other TPU layouts; there is one here.
//
// K9 and K10 at c16 (pallas_band2.py:319-326 and :497-504, ``dev=``): the
// kernel is templated on the storage of lbm_common.cuh. Device memory holds
// int16 codes; the window loader decodes them and the tile store encodes
// (one rounding per pass of T steps, as the JAX kernels encode only at
// their tile store), the window and the steps stay f32, and K10's halo
// copy moves the neighbours' codes untouched. A pass then moves 40 B per
// cell instead of 76.
//
// K9 and K10 at bf16 (``mid.astype(out_dtype)`` at pallas_band2.py:324,
// :502, :763, :973): the same template on lbm_common.cuh::BF16, one
// rounding to nearest even per pass at the tile store, 40 B per cell per
// pass with no codec arithmetic; K10's halos move raw bfloat16.
//
// lbm_cluster_sync_probe: the floor of a thread-block cluster barrier
// (cluster.sync()), kept as the measurement behind the choice of one block
// per tile: a tile split over a cluster of blocks, each stepping a band of
// the window's rows and reaching its neighbours' edge rows, took more time
// (trials/k9_cluster.patch, PERF.md).
#include <cooperative_groups.h>

#include "band_common.cuh"

namespace {

template <bool kSharded, class S>
__global__ void __launch_bounds__(band::kThreads)
band2_kernel(band::SourceT<typename S::T> src, typename S::T* __restrict__ dst,
             float* __restrict__ partials, unsigned int* __restrict__ ticket,
             float* __restrict__ av, band::Geom g, float w1a, float w2a, lbm::Relax rc,
             float inv_tot, S io) {
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 1);
  const size_t z = blockIdx.y;  // the shard (0 on one grid)
  const size_t plane = (size_t)g.ny * g.nx;
  src = band::shard(g, src);
  dst += z * 9 * plane;
  partials += z * g.T * g.nty * g.ntx;
  ticket += z;
  av += z * g.av_stride;
  int y0, x0;
  band::fill_tables(g, s, y0, x0);
  __syncthreads();
  band::aa_load(g, s, w1a, w2a, [&](int r, int c, float* v) {
    return band::load_cell<kSharded>(g, s, src, y0, r, c, v, io);
  });
  const band::Central cen = band::central(g, y0, x0);
  band::aa_steps(g, s, cen, w1a, w2a, rc);
  band::aa_store(g, s.planes, cen, dst, plane, y0 - g.T, x0, io);
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

// The cluster barrier alone, ``syncs`` times (lbm_cluster_sync_probe).
__global__ void cluster_sync_loop(int syncs) {
  for (int i = 0; i < syncs; ++i) cooperative_groups::this_cluster().sync();
}

// K9 on storage S: lbm_band2_run below.
template <class S>
int run_grid(typename S::T* buf_a, typename S::T* buf_b, const float* nobst, float* av,
             float* partials, unsigned int* ticket, const band::Geom& g, int n_passes, float w1a,
             float w2a, const lbm::Relax& rc, float inv_tot, cudaStream_t st, const S& io) {
  using T = typename S::T;
  const size_t smem = band::smem_bytes(g, 1);
  const cudaError_t err = band::allow_smem(band2_kernel<false, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return band::run_passes(n_passes, g.T, buf_a, buf_b, av,
                          [&](const T* src, T* dst, float* av_p, int) {
    const band::SourceT<T> from{src, nobst, nullptr, nullptr, nullptr, nullptr};
    band2_kernel<false, S><<<g.nty * g.ntx, band::kThreads, smem, st>>>(
        from, dst, partials, ticket, av_p, g, w1a, w2a, rc, inv_tot, io);
  });
}

// K10 on storage S: lbm_band2_sharded_run below.
template <class S>
int run_sharded(const unsigned long long* table, int s0, int count, int nshards, void* buf_a,
                void* buf_b, void* halo_dn, void* halo_up, const float* nobst,
                const float* nob_dn, const float* nob_up, float* av, int av_stride,
                float* partials, unsigned int* ticket, int ny, int nx, int block, int depth,
                int panel, int parity, int n_passes, float w1a, float w2a, const lbm::Relax& rc,
                float inv_tot, cudaStream_t st, const S& io) {
  using T = typename S::T;
  const band::ShardsT<T> sh{table, s0, count, nshards, parity, static_cast<T*>(halo_dn),
                            static_cast<T*>(halo_up)};
  const band::Geom g = band::make_sharded_geom(ny, nx, block, depth, panel, sh, av_stride);
  const size_t smem = band::smem_bytes(g, 1);
  const cudaError_t err = band::allow_smem(band2_kernel<true, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.nty * g.ntx, count);
  return band::run_sharded_passes(g, sh, n_passes, static_cast<T*>(buf_a), static_cast<T*>(buf_b),
                                  av, st, [&](const T* src, T* dst, float* av_p, int) {
    const band::SourceT<T> from{src, nobst, sh.halo_dn, sh.halo_up, nob_dn, nob_up};
    band2_kernel<true, S><<<grid, band::kThreads, smem, st>>>(from, dst, partials, ticket, av_p,
                                                              g, w1a, w2a, rc, inv_tot, io);
  });
}

}  // namespace

// Runs n_passes band passes of ``depth`` steps (even) on B x P tiles.
// buf_a holds the initial state; pass p reads buf[p % 2] and writes
// buf[(p + 1) % 2]. av receives n_passes * depth values; partials needs
// depth * lbm_band_num_tiles floats; ticket one zeroed unsigned int.
// storage: the planes' storage (lbm_common.cuh::Storage: f32, c16 int16
// codes or bf16). Returns the first CUDA error, or 0.
extern "C" int lbm_band2_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                             float* partials, unsigned int* ticket, int ny, int nx, int block,
                             int depth, int panel, int n_passes, float w1a, float w2a, float beta,
                             float ow0, float ow1, float ow2, float inv_tot,
                             const lbm::Storage* storage, void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& io) {
    using T = lbm::Raw<decltype(io)>;
    return run_grid(static_cast<T*>(buf_a), static_cast<T*>(buf_b), nobst, av, partials, ticket,
                    g, n_passes, w1a, w2a, rc, inv_tot, st, io);
  });
}

// K10: lbm_band_sharded_run's contract (band.cu) with the band2 pass
// (depth even), storage included.
extern "C" int lbm_band2_sharded_run(const unsigned long long* table, int s0, int count,
                                     int nshards, void* buf_a, void* buf_b, void* halo_dn,
                                     void* halo_up, const float* nobst, const float* nob_dn,
                                     const float* nob_up, float* av, int av_stride,
                                     float* partials, unsigned int* ticket, int ny, int nx,
                                     int block, int depth, int panel, int parity, int n_passes,
                                     float w1a, float w2a, float beta, float ow0, float ow1,
                                     float ow2, float inv_tot, const lbm::Storage* storage,
                                     void* stream) {
  if (depth > ny || count < 1 || s0 < 0 || s0 + count > nshards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& io) {
    return run_sharded(table, s0, count, nshards, buf_a, buf_b, halo_dn, halo_up, nobst, nob_dn,
                       nob_up, av, av_stride, partials, ticket, ny, nx, block, depth, panel,
                       parity, n_passes, w1a, w2a, rc, inv_tot, st, io);
  });
}

// The floor of a cluster barrier: ``syncs`` cluster.sync() of an otherwise
// empty kernel on ``blocks`` blocks of ``threads`` threads in clusters of
// ``cluster`` (a divisor of blocks, at most 8). Returns the CUDA error of
// the launch, or 0.
extern "C" int lbm_cluster_sync_probe(int blocks, int threads, int cluster, int syncs,
                                      void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_sync_loop, syncs);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
