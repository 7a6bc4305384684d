// K7: the band pass in ONE shared-memory window, stepped in place in the
// AA arrangement, at any T.
//
// Replaces: lbm_tpu/ops/pallas_band.py::_kernel (:172) and ::_kernel_panel
// (:387), the band creep with the 9 window planes carried as fori_loop
// values and shifted by whole-plane rolls: T steps per pass in a window of
// (B+2T) x (P+2T) cells whose edge garbage creeps inward one cell per
// step, the central B x P cells stored. Full row and panel are one kernel
// here: every tile is B x P with a T-cell halo (band_common.cuh).
//
// What bounds it on the H100: the work inside the window, not HBM (as K9,
// band2.cu: a pass moves 76 B per cell at f32, 40 at 16 bits, over T
// steps). Shared memory sets the window's size, and the window's size the
// redundancy (B+2T)(P+2T)/(BP) of the recomputed halo.
//
// What the design does about it: band_common.cuh's one-window pass, K9's
// body taken to K7's whole domain (any T >= 1, any tile, ragged grids): 40
// B of shared memory per window cell, one barrier per step, the loader
// writing R_k into slot opp(k) with the forcing row's forcing added
// cell-locally, odd steps gathering, relaxing and scattering, even ones
// cell-local. An odd T ends on a scatter step, and the tile store reads R_k
// of a central cell from (x + c_k, k), where that step left it. The cell
// arithmetic is K1's in K1's order, so at f32 the state is bitwise K1's at
// every T. (Before: each thread carried up to 8 cells x 9 values in
// registers and pulled them through a shared exchange window, two barriers
// a step, at most 4,096 window cells.)
//
// K8: the same kernel on the shards of a 1-D mesh (kSharded). Replaces
// lbm_tpu/ops/pallas_band.py::_kernel_sharded (:574) and
// ::_kernel_sharded_panel (:776): one pass of T steps over one shard's rows,
// the window's y halo read from the neighbour shards' T edge rows, copied
// once per pass (band_common.cuh: Source, halo_rows_kernel), and the
// forcing at every window row whose global row is ny-2. The halo copy adds
// 2T rows per shard per pass, 2T/ny_shard of the pass's bytes.
//
// K7 and K8 at c16 (pallas_band.py, ``dev=``) and bf16 (``mid.astype(
// out_dtype)`` at pallas_band.py:253, :480, :665, :882): the loader decodes
// (widens) and the tile store encodes (rounds to nearest even), once per
// pass, through the storage types of lbm_common.cuh; K8's halo copy moves
// the neighbours' raw int16 codes or bfloat16 values.
//
// K13: the same pass over a y-slab (kSlab). Replaces
// lbm_tpu/ops/pallas_slab.py::_kernel_slab (:76), at f32, c16 and bf16. A
// generation of K*T steps cuts the grid into ny/S slabs of S rows; slab j's
// buffer holds global rows [j*S - KT, j*S + S + KT), KT = K*T, and takes K
// passes over its whole height, the buffer's edge rows wrapping within the
// buffer (garbage creeps T rows per pass from each edge, so its S central
// rows stay genuine). Its first pass reads its rows straight from the state
// (global row (r0 + row) mod ny, r0 = j*S - KT, negative for slab 0), its
// last pass stores the S central rows straight into the next state, and the
// passes between them ping-pong between two slab buffers; so every slab of
// a generation reads the same input state and the slabs write disjoint rows
// (pallas_slab.py:295-325) without a copy of the state. The forcing is by
// global row at every window row, so the copies of row ny-2 in the
// neighbours' halo rows are forced too (:104-107); each slab sums only its
// owned rows [KT, KT + S) (:99-102), and slab j > 0 adds its sums to
// slab j-1's in slab order, so the series is deterministic. The slabs run
// one after another: the bet is that a slab's two buffers,
// 2 (S + 2KT) nx 36 B at f32, stay in the 50 MB L2 across its K passes, so
// HBM sees about 76 (S + 2KT) / S B per cell per K*T steps.
//
// K13 at c16 and bf16 rounds where the JAX slab kernel does: each pass
// call there writes a (9, S + 2KT, nx) buffer of the storage dtype
// (pallas_slab.py:171, :217), so every one of a slab's K passes rounds
// once, the inner passes into the two slab buffers (which hold the
// storage's raw elements) and the last into the next state.
#include "band_common.cuh"

namespace {

enum class Mode { kGrid, kSharded, kSlab };

// One pass of the slab kernel (K13): where it reads, which buffer rows it
// stores and where, and which rows it sums. Buffer row y is global row
// r0 + y (mod ny) of the grid.
struct SlabIO {
  int in_r0, in_rows;    // the source row of buffer row y: (in_r0 + y) mod in_rows
  int out_lo, out_hi;    // buffer rows stored, into destination row out_r0 + y
  int out_r0, out_rows;  // ... of a destination of out_rows rows
  int own_lo, own_hi;    // buffer rows whose |u| the pass sums
  int accumulate;        // add the sums to av (every slab but the first)
};

// One pass over a tile's window (band_common.cuh's one-window pass): K7 on
// the grid, K8 on a shard, K13 on a slab buffer.
template <Mode kMode, class S>
__global__ void __launch_bounds__(band::kThreads)
band_kernel(band::SourceT<typename S::T> src, typename S::T* __restrict__ dst,
            float* __restrict__ partials, unsigned int* __restrict__ ticket,
            float* __restrict__ av, band::Geom g, float w1a, float w2a, lbm::Relax rc,
            float inv_tot, SlabIO io, S st) {
  constexpr bool kSharded = kMode == Mode::kSharded;
  constexpr bool kSlab = kMode == Mode::kSlab;
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 1);
  const size_t plane = (size_t)g.ny * g.nx;
  const size_t z = blockIdx.y;  // the shard (0 on one grid and on a slab)
  src = band::shard(g, src);
  dst += z * 9 * plane;
  partials += z * g.T * g.nty * g.ntx;
  ticket += z;
  av += z * g.av_stride;
  int y0, x0;
  band::fill_tables(g, s, y0, x0);
  __syncthreads();
  band::aa_load(g, s, w1a, w2a, [&](int r, int c, float* v) {
    if constexpr (kSlab) {
      const int row = band::wrap_mod(io.in_r0 + y0 - g.T + r, io.in_rows);
      const size_t gi = (size_t)row * g.nx + s.gcol[c];
      const size_t in_plane = (size_t)io.in_rows * g.nx;
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = st.load(src.cells[k * in_plane + gi], k);
      return src.nobst[(size_t)s.grow[r] * g.nx + s.gcol[c]];
    } else {
      return band::load_cell<kSharded>(g, s, src, y0, r, c, v, st);
    }
  });
  const band::Central cen = kSlab ? band::central_rows(g, y0, x0, io.own_lo, io.own_hi)
                                  : band::central(g, y0, x0);
  band::aa_steps(g, s, cen, w1a, w2a, rc);
  // The central cells (the slab: rows [out_lo, out_hi) of the buffer, at
  // out_r0 + row of a destination of out_rows rows).
  if constexpr (kSlab) {
    band::aa_store(g, s.planes, band::central_rows(g, y0, x0, io.out_lo, io.out_hi), dst,
                   (size_t)io.out_rows * g.nx, io.out_r0 + y0 - g.T, x0, st);
  } else {
    band::aa_store(g, s.planes, cen, dst, plane, y0 - g.T, x0, st);
  }
  band::finish_sums(g, s, partials, ticket, inv_tot, av, kSlab && io.accumulate);
}

template <Mode kMode, class S>
int run(const band::Geom& g, const band::ShardsT<typename S::T>* sh, typename S::T* buf_a,
        typename S::T* buf_b, const band::SourceT<typename S::T>& src, float* av,
        float* partials, unsigned int* ticket, int n_passes, float w1a, float w2a,
        const lbm::Relax& rc, float inv_tot, cudaStream_t st, const S& stor) {
  using T = typename S::T;
  const size_t smem = band::smem_bytes(g, 1);
  const cudaError_t err = band::allow_smem(band_kernel<kMode, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.nty * g.ntx, kMode == Mode::kSharded ? sh->count : 1);
  auto launch = [&](const T* from, T* to, float* av_p, int) {
    band::SourceT<T> s = src;
    s.cells = from;
    band_kernel<kMode, S><<<grid, band::kThreads, smem, st>>>(
        s, to, partials, ticket, av_p, g, w1a, w2a, rc, inv_tot, SlabIO{}, stor);
  };
  if constexpr (kMode == Mode::kSharded) {
    return band::run_sharded_passes(g, *sh, n_passes, buf_a, buf_b, av, st, launch);
  }
  return band::run_passes(n_passes, g.T, buf_a, buf_b, av, launch);
}

// K13: n_gens generations of K passes over each of the ny / S slabs, slab
// after slab; see the top of the file.
template <class S>
int run_slab(typename S::T* state, typename S::T* next, typename S::T* slab_a,
             typename S::T* slab_b, const float* nobst, float* av, float* partials,
             unsigned int* ticket, int ny, int nx, int block, int depth, int panel, int kpasses,
             int sblock, int n_gens, float w1a, float w2a, const lbm::Relax& rc, float inv_tot,
             cudaStream_t st, const S& stor) {
  using T = typename S::T;
  const int kt = kpasses * depth;
  if (kpasses < 1 || sblock < 1 || ny % sblock != 0 || ny <= sblock || kt > sblock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  band::Geom g = band::make_geom(sblock + 2 * kt, nx, block, depth, panel);
  g.nyg = ny;
  const int rows = g.ny;
  const size_t smem = band::smem_bytes(g, 1);
  const cudaError_t err = band::allow_smem(band_kernel<Mode::kSlab, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  T* cur = state;
  T* nxt = next;
  T* bufs[2] = {slab_a, slab_b};
  for (int gen = 0; gen < n_gens; ++gen) {
    for (int j = 0; j < ny / sblock; ++j) {
      const int r0 = j * sblock - kt;
      g.r0 = r0;
      for (int p = 0; p < kpasses; ++p) {
        const bool first = p == 0, last = p == kpasses - 1;
        const SlabIO io{first ? r0 : 0, first ? ny : rows,
                        last ? kt : 0, last ? kt + sblock : rows,
                        last ? r0 : 0, last ? ny : rows,
                        kt, kt + sblock, j > 0};
        const band::SourceT<T> src{first ? cur : bufs[(p + 1) & 1], nobst,
                                   nullptr, nullptr, nullptr, nullptr};
        band_kernel<Mode::kSlab, S><<<g.nty * g.ntx, band::kThreads, smem, st>>>(
            src, last ? nxt : bufs[p & 1], partials, ticket,
            av + (size_t)gen * kt + (size_t)p * g.T, g, w1a, w2a, rc, inv_tot, io, stor);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
      }
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}

// K8 on storage S: lbm_band_sharded_run below.
template <class S>
int run_sharded(const unsigned long long* table, int s0, int count, int nshards, void* buf_a,
                void* buf_b, void* halo_dn, void* halo_up, const float* nobst,
                const float* nob_dn, const float* nob_up, float* av, int av_stride,
                float* partials, unsigned int* ticket, int ny, int nx, int block, int depth,
                int panel, int parity, int n_passes, float w1a, float w2a, const lbm::Relax& rc,
                float inv_tot, cudaStream_t st, const S& stor) {
  using T = typename S::T;
  const band::ShardsT<T> sh{table, s0, count, nshards, parity, static_cast<T*>(halo_dn),
                            static_cast<T*>(halo_up)};
  const band::Geom g = band::make_sharded_geom(ny, nx, block, depth, panel, sh, av_stride);
  T* a = static_cast<T*>(buf_a);
  const band::SourceT<T> src{a, nobst, sh.halo_dn, sh.halo_up, nob_dn, nob_up};
  return run<Mode::kSharded>(g, &sh, a, static_cast<T*>(buf_b), src, av, partials, ticket,
                             n_passes, w1a, w2a, rc, inv_tot, st, stor);
}

}  // namespace

// Runs n_passes band passes of ``depth`` steps (any depth >= 1) on B x P
// tiles, each (B + 2T) x (P + 2T) window in the shared memory of a block
// (band_common.cuh::smem_bytes, one copy of the planes). buf_a holds the
// initial state; pass p reads buf[p % 2] and writes buf[(p + 1) % 2]. av
// receives n_passes * depth values; partials needs depth *
// lbm_band_num_tiles floats; ticket one zeroed unsigned int. storage: the
// planes' storage (lbm_common.cuh::Storage: f32, c16 int16 codes or bf16).
// Returns the first CUDA error (cudaErrorInvalidValue for a window larger
// than a block's shared memory), or 0.
extern "C" int lbm_band_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                            float* partials, unsigned int* ticket, int ny, int nx, int block,
                            int depth, int panel, int n_passes, float w1a, float w2a, float beta,
                            float ow0, float ow1, float ow2, float inv_tot,
                            const lbm::Storage* storage, void* stream) {
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& stor) {
    using T = lbm::Raw<decltype(stor)>;
    T* a = static_cast<T*>(buf_a);
    const band::SourceT<T> src{a, nobst, nullptr, nullptr, nullptr, nullptr};
    return run<Mode::kGrid>(g, nullptr, a, static_cast<T*>(buf_b), src, av, partials, ticket,
                            n_passes, w1a, w2a, rc, inv_tot, st, stor);
  });
}

// K8: n_passes passes over shards [s0, s0 + count) of a 1-D mesh of
// nshards shards of ny rows (shard z holds global rows [z*ny, (z+1)*ny)),
// stacked in buf_a and buf_b (count, 9, ny, nx). The first pass reads
// buf_a when parity is even, else buf_b; the passes alternate. table holds
// 2 * nshards addresses on this card: each shard's two buffers, of this
// call or another, on this card or a peer. Each pass first copies the
// call's halo_dn, halo_up (count, 9, depth, nx) from the neighbour shards'
// edge rows of the pass's source buffer; with a null table the caller has
// filled them (rows received from shards in other processes), and a call
// takes one pass at a time. nobst (count, ny, nx) and nob_dn,
// nob_up (count, depth, nx) hold the mask and its halos. av receives count
// x (n_passes * depth) values (shard-major, av_stride apart); partials
// count * depth * lbm_band_num_tiles floats; ticket count zeroed unsigned
// ints. storage as lbm_band_run: the buffers and halos hold its raw
// elements. Returns the first CUDA error, or 0.
extern "C" int lbm_band_sharded_run(const unsigned long long* table, int s0, int count,
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
  return lbm::with_storage(storage, [&](const auto& stor) {
    return run_sharded(table, s0, count, nshards, buf_a, buf_b, halo_dn, halo_up, nobst, nob_dn,
                       nob_up, av, av_stride, partials, ticket, ny, nx, block, depth, panel,
                       parity, n_passes, w1a, w2a, rc, inv_tot, st, stor);
  });
}

// K13: n_gens generations of the slab schedule on a (9, ny, nx) grid, each
// kpasses passes of ``depth`` steps over every slab of sblock rows (ny a
// multiple of sblock larger than it, kpasses * depth <= sblock). state holds
// the initial state; generation g reads state when g is even, else next,
// and writes the other. slab_a and slab_b hold (9, sblock + 2 * kpasses *
// depth, nx) each. av receives n_gens * kpasses * depth values; partials
// needs depth * lbm_band_num_tiles(sblock + 2 * kpasses * depth, nx, block,
// panel) floats; ticket one zeroed unsigned int. storage as lbm_band_run:
// the state and both slab buffers hold its raw elements. Returns the first
// CUDA error (cudaErrorInvalidValue for a slab schedule the grid cannot
// take; a window larger than a block's shared memory is refused at its
// launch), or 0.
extern "C" int lbm_slab_run(void* state, void* next, void* slab_a, void* slab_b,
                            const float* nobst, float* av, float* partials, unsigned int* ticket,
                            int ny, int nx, int block, int depth, int panel, int kpasses,
                            int sblock, int n_gens, float w1a, float w2a, float beta, float ow0,
                            float ow1, float ow2, float inv_tot, const lbm::Storage* storage,
                            void* stream) {
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& stor) {
    using T = lbm::Raw<decltype(stor)>;
    return run_slab(static_cast<T*>(state), static_cast<T*>(next), static_cast<T*>(slab_a),
                    static_cast<T*>(slab_b), nobst, av, partials, ticket, ny, nx, block, depth,
                    panel, kpasses, sblock, n_gens, w1a, w2a, rc, inv_tot, st, stor);
  });
}

// Output tiles of a band schedule (all three band kernels): one block each.
extern "C" unsigned int lbm_band_num_tiles(int ny, int nx, int block, int panel) {
  return (unsigned int)(((ny + block - 1) / block) * ((nx + panel - 1) / panel));
}
