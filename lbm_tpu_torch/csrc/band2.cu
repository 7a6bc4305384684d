// K9: the band pass with two shared-memory windows, ping-ponged.
//
// Replaces: lbm_tpu/ops/pallas_band2.py::_kernel2 (:90) and
// ::_kernel2_panel (:382), the band schedule with two VMEM scratch buffers
// and T/2 double-steps. Full row and panel are one kernel here: every tile
// is two-dimensional, B rows by P columns, with a T-cell halo on each side
// (band_common.cuh), because no full row of a large grid fits the 227 KB of
// shared memory a block can use.
//
// What bounds it on the H100: shared memory. A window cell costs 76 B of it
// (two copies of 9 f32 planes plus the f32 not-obstacle value), so a block
// holds at most ~3,000 cells, and the redundancy (B+2T)(P+2T)/(BP) of the
// recomputed halo is what the schedule pays for touching device memory once
// per T steps instead of every step (76 B per cell each way per pass, where
// K1 moves 76 B per cell per step). Each step reads 9 values and writes 9
// per window cell in shared memory, with one barrier.
//
// What the design does about it: one thread per window cell in each
// sweep, consecutive threads on consecutive columns, so a warp reads
// consecutive words of a plane (no bank conflicts within a row); each step
// pulls from one buffer into the other, as _kernel2 does between a_ref and
// b_ref, so no step needs a second barrier. T is even, so the result ends
// in the first buffer. The forcing of the ny-2 rows is fused into the pull
// as in K1 (step.cu): a thread whose source cell lies on such a row adds
// the delta, with the mask taken at the source cell from the read-only
// buffer. TMA loads, clusters and register tiling are later work.
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
// their tile store), the windows and the steps stay f32, and K10's halo
// copy moves the neighbours' codes untouched. A pass then moves 40 B per
// cell instead of 76.
#include "band_common.cuh"

namespace {

template <bool kSharded, class S>
__global__ void __launch_bounds__(band::kThreads)
band2_kernel(band::SourceT<typename S::T> src, typename S::T* __restrict__ dst,
             float* __restrict__ partials, unsigned int* __restrict__ ticket,
             float* __restrict__ av, band::Geom g, float w1a, float w2a, lbm::Relax rc,
             float inv_tot, S io) {
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 2);
  const size_t z = blockIdx.y;  // the shard (0 on one grid)
  src = band::shard(g, src);
  dst += z * 9 * (size_t)g.ny * g.nx;
  partials += z * g.T * g.nty * g.ntx;
  ticket += z;
  av += z * g.av_stride;
  int y0, x0;
  band::fill_tables(g, s, y0, x0);
  __syncthreads();
  float* a = s.planes;
  float* b = s.planes + 9 * g.ncell;
  band::load_window<kSharded>(g, s, a, src, y0, io);
  __syncthreads();
  const band::Central cen = band::central(g, y0, x0);
  const int frow = g.nyg - 2;
  const int n = g.ncell;
  for (int st = 0; st < g.T; ++st) {
    const float* in = (st & 1) ? b : a;
    float* out = (st & 1) ? a : b;
    float acc = 0.0f;
    band::for_cells(g.WH, g.WW, [&](int r, int c) {
      const int ru = band::wrap1(r - 1, g.WH), rd = band::wrap1(r + 1, g.WH);
      const int cl = band::wrap1(c - 1, g.WW), cr = band::wrap1(c + 1, g.WW);
      float t[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int sr = lbm::cy(k) == 1 ? ru : (lbm::cy(k) == -1 ? rd : r);
        const int sc = lbm::cx(k) == 1 ? cl : (lbm::cx(k) == -1 ? cr : c);
        const int si = sr * g.WW + sc;
        float v = in[k * n + si];
        if (band::forced(k) && s.grow[sr] == frow) {
          const float m = lbm::force_mask(in[3 * n + si], in[6 * n + si], in[7 * n + si],
                                          s.nob[si], w1a, w2a);
          v = v + band::force_weight(k, w1a, w2a) * m;
        }
        t[k] = v;
      }
      const int i = r * g.WW + c;
      const float nob = s.nob[i];
      const float usq = lbm::collide_fused(t, nob, rc);
#pragma unroll
      for (int k = 0; k < 9; ++k) out[k * n + i] = t[k];
      if (cen.has(r, c)) acc += nob * sqrtf(usq);
    });
    band::step_partial(s, st, acc);
    __syncthreads();
  }
  band::store_tile(g, a, dst, y0, x0, io);
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

// K9 on storage S: lbm_band2_run below.
template <class S>
int run_grid(typename S::T* buf_a, typename S::T* buf_b, const float* nobst, float* av,
             float* partials, unsigned int* ticket, const band::Geom& g, int n_passes, float w1a,
             float w2a, const lbm::Relax& rc, float inv_tot, cudaStream_t st, const S& io) {
  using T = typename S::T;
  const size_t smem = band::smem_bytes(g, 2);
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
  const size_t smem = band::smem_bytes(g, 2);
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
// codec: null for f32 planes, else the 12 floats of c16 storage
// (DevSpec.codec) and int16 planes. Returns the first CUDA error, or 0.
extern "C" int lbm_band2_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                             float* partials, unsigned int* ticket, int ny, int nx, int block,
                             int depth, int panel, int n_passes, float w1a, float w2a, float beta,
                             float ow0, float ow1, float ow2, float inv_tot, const float* codec,
                             void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codec != nullptr) {
    return run_grid(static_cast<int16_t*>(buf_a), static_cast<int16_t*>(buf_b), nobst, av,
                    partials, ticket, g, n_passes, w1a, w2a, rc, inv_tot, st,
                    lbm::make_c16(codec));
  }
  return run_grid(static_cast<float*>(buf_a), static_cast<float*>(buf_b), nobst, av, partials,
                  ticket, g, n_passes, w1a, w2a, rc, inv_tot, st, lbm::F32());
}

// K10: lbm_band_sharded_run's contract (band.cu) with the band2 pass
// (depth even), codec included.
extern "C" int lbm_band2_sharded_run(const unsigned long long* table, int s0, int count,
                                     int nshards, void* buf_a, void* buf_b, void* halo_dn,
                                     void* halo_up, const float* nobst, const float* nob_dn,
                                     const float* nob_up, float* av, int av_stride,
                                     float* partials, unsigned int* ticket, int ny, int nx,
                                     int block, int depth, int panel, int parity, int n_passes,
                                     float w1a, float w2a, float beta, float ow0, float ow1,
                                     float ow2, float inv_tot, const float* codec, void* stream) {
  if (depth > ny || count < 1 || s0 < 0 || s0 + count > nshards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codec != nullptr) {
    return run_sharded(table, s0, count, nshards, buf_a, buf_b, halo_dn, halo_up, nobst, nob_dn,
                       nob_up, av, av_stride, partials, ticket, ny, nx, block, depth, panel,
                       parity, n_passes, w1a, w2a, rc, inv_tot, st, lbm::make_c16(codec));
  }
  return run_sharded(table, s0, count, nshards, buf_a, buf_b, halo_dn, halo_up, nobst, nob_dn,
                     nob_up, av, av_stride, partials, ticket, ny, nx, block, depth, panel, parity,
                     n_passes, w1a, w2a, rc, inv_tot, st, lbm::F32());
}
