// K11: the band pass on ONE shared-memory window in the AA arrangement,
// the state kept in S between passes.
//
// Replaces: lbm_tpu/ops/pallas_band3.py::_kernel3 (:306) and
// ::_kernel3_panel (:408), the band schedule on one VMEM scratch buffer
// with the AA even/odd alternation. Full row and panel are one kernel here:
// every tile is B x P with a T-cell halo (band_common.cuh).
//
// What it computes (pallas_band3.py:39-59). Device memory holds the S
// arrangement between passes (slot (x, k) holds the arrival t_k(x)), in two
// copies, because neighbouring tiles read each other's halos. Steps
// alternate even (S -> C: relax the cell's 9 slots, write the value
// travelling k into its slot opp(k)) and odd (C -> S: gather t_k from
// (x - c_k, opp(k)), relax, scatter to (x + c_k, k)), as in K2 (aa.cu); T is
// even, so a pass maps S to S. Forcing of the cells whose global row is
// ny-2: the even step adds the C-space forcing of the odd step that follows
// to the cell's own outputs (pallas_band3.py applies it as a 1-row update at
// the start of the odd step: same values, same arithmetic); the odd step
// adds the NEXT even step's S-space forcing to the values it scatters, with
// the mask from its own f*_3, f*_6, f*_7 (pallas_band3.py:261-280), but the
// last odd step of a run's final pass, so that the stored state is unforced
// for the S -> R exit: the entry's fuse_last says whether the last pass of
// a call fuses. The run's first forcing is applied to the full S state
// before the first pass (ops/band3.py). The TPU runs the final pass as two
// calls, (T-2, fused) + (2, unfused), each storing the state: at f32 one
// pass computes the same, at 16-bit storage the split is one more rounding,
// so ops/band3.py issues those two calls at c16 and bf16
// (pallas_band3.py:669-677).
//
// What bounds it on the H100: the work inside the window, not HBM (the
// band kernels run at 4-6x their byte bound at 16 bits): each step reads
// and writes 9 values per window cell in shared memory, with a barrier, and
// the halo's cells are updated again by every tile that holds them.
//
// What the design does about it. The pass opens with the cell-local step,
// so the load IS step 0: each thread reads its window cell's 9 slots of S
// from device memory (wrapped global rows and columns, so the periodic
// boundary costs nothing), relaxes them in registers and writes C into the
// window: no separate load sweep and no barrier for it. It closes with the
// scatter step, so the store IS step T-1: each central S slot (y, k) has
// exactly one writer, the cell y - c_k, which sends its value straight to
// device memory: no store sweep, no barrier for it, and no window slot
// written for it. In between, step st (0-based) updates only the window
// cells at least st cells from every edge (csrc/trapezoid.cuh, K5's and
// K6's trapezoid): those whose inputs are still genuine, ending with the
// central cells and their one-cell ring, whose scatters fill every central
// slot. Nothing wraps inside the window. One copy of the window, 40 B per
// cell with the not-obstacle plane. Windows of the driver's schedules are
// compiled with constant row and plane strides (trapezoid.cuh::with_layout,
// the one list of K5, K6 and K11, ops/_build.py).
//
// c16 storage (pallas_band3.py:330-372, :427-470): device memory holds int16
// codes of the S arrangement, keyed by slot; step 0 decodes what it loads
// and step T-1 encodes what it stores (one rounding per pass), and the
// window stays f32. The run's first forcing decodes, forces and re-encodes
// rows ny-3..ny-1 outside the kernel (ops/band3.py::force_s). 40 B per cell
// per pass.
//
// bf16 storage (``mid.astype(out_dtype)`` at pallas_band3.py:370, :468):
// the same on lbm_common.cuh::BF16, one rounding per pass; the run's
// first forcing widens, forces and rounds rows ny-3..ny-1 once more
// outside the kernel (pallas_band3.py:558-561, ops/band3.py::force_s).
#include "trapezoid.cuh"

namespace {

template <class L, class S>
__global__ void __launch_bounds__(band::kThreads)
band3_kernel(const typename S::T* __restrict__ src, typename S::T* __restrict__ dst,
             const float* __restrict__ nobst, float* __restrict__ partials,
             unsigned int* __restrict__ ticket, float* __restrict__ av, band::Geom g, L lay,
             float w1a, float w2a, lbm::Relax rc, float inv_tot, int fuse_last, S io) {
  extern __shared__ float smem[];
  const band::Smem s = band::carve(smem, g, 1);
  const trap::Tile tl = trap::begin(g, s);
  __syncthreads();
  const band::SourceT<typename S::T> from{src, nobst, nullptr, nullptr, nullptr, nullptr};
  const band::Central cen = band::central(g, tl.y0, tl.x0);
  const int frow = g.ny - 2;
  const int n = lay.n(), ww = lay.ww();
  float* w = s.planes;
  // Step 0 (even, S -> C) is the load: relax the cell's slots as they
  // arrive, add the C-space forcing of step 1, write C.
  float acc = 0.0f;
  band::for_cells(tl.wh, tl.ww, [&](int r, int c) {
    const int i = r * ww + c;
    float t[9];
    const float nob = band::load_cell<false>(g, s, from, tl.y0, r, c, t, io);
    s.nob[i] = nob;
    const float usq = lbm::collide_fused(t, nob, rc);
    if (s.grow[r] == frow) band::force_cell(t, nob, w1a, w2a);
#pragma unroll
    for (int k = 0; k < 9; ++k) w[lbm::opp(k) * n + i] = t[k];
    if (cen.has(r, c)) acc += nob * sqrtf(usq);
  });
  band::step_partial(s, 0, acc);
  __syncthreads();
  // Steps 1 .. T-2 on the trapezoid, odd (scatter) first; all force.
  for (int st = 1; st + 1 < g.T; st += 2) {
    trap::aa_step<true>(g, s, tl, lay, cen, true, w1a, w2a, rc, st, st);
    trap::aa_step<false>(g, s, tl, lay, cen, true, w1a, w2a, rc, st + 1, st + 1);
  }
  // Step T-1 (odd, C -> S) is the store: the central cells and their ring
  // gather, relax and scatter each value whose slot is central to device
  // memory, encoded once.
  const int last = g.T - 1;
  const bool force = fuse_last != 0;
  const size_t plane = (size_t)g.ny * g.nx;
  acc = 0.0f;
  band::for_cells(tl.wh - 2 * last, tl.ww - 2 * last, [&](int rr, int cc) {
    const int r = rr + last, c = cc + last;
    const int i = r * ww + c;
    float t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = w[lbm::opp(k) * n + i - lbm::cy(k) * ww - lbm::cx(k)];
    const float nob = s.nob[i];
    const float usq = lbm::collide_fused(t, nob, rc);
    if (force && s.grow[r] == frow) band::force_cell(t, nob, w1a, w2a);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int dr = r + lbm::cy(k), dc = c + lbm::cx(k);
      if (cen.has(dr, dc)) {
        dst[k * plane + (size_t)(tl.y0 + dr - g.T) * g.nx + (tl.x0 + dc - g.T)] = io.store(t[k], k);
      }
    }
    if (cen.has(r, c)) acc += nob * sqrtf(usq);
  });
  band::step_partial(s, last, acc);
  __syncthreads();
  band::finish_sums(g, s, partials, ticket, inv_tot, av);
}

template <class S>
int run(typename S::T* buf_a, typename S::T* buf_b, const float* nobst, float* av,
        float* partials, unsigned int* ticket, const band::Geom& g, int n_passes, int fuse_last,
        float w1a, float w2a, const lbm::Relax& rc, float inv_tot, cudaStream_t st,
        const S& io) {
  using T = typename S::T;
  const size_t smem = band::smem_bytes(g, 1);
  return trap::with_layout(g, [&](auto lay) {
    using L = decltype(lay);
    const cudaError_t err = band::allow_smem(band3_kernel<L, S>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return band::run_passes(n_passes, g.T, buf_a, buf_b, av,
                            [&](const T* src, T* dst, float* av_p, int p) {
      lbm::count_launch();
      band3_kernel<L, S><<<g.nty * g.ntx, band::kThreads, smem, st>>>(
          src, dst, nobst, partials, ticket, av_p, g, lay, w1a, w2a, rc, inv_tot,
          fuse_last || p + 1 < n_passes, io);
    });
  });
}

}  // namespace

// Runs n_passes in-place AA band passes of ``depth`` steps (even, >= 2) on
// B x P tiles. buf_a holds the forced S arrangement on entry; pass p reads
// buf[p % 2] and writes buf[(p + 1) % 2], both in S. Every pass but the
// last fuses the next pass's first forcing, the last too when fuse_last
// is not 0 (a call that another call of passes follows). av receives
// n_passes * depth values; partials needs depth * lbm_band_num_tiles
// floats; ticket one zeroed unsigned int. storage: the planes' storage
// (lbm_common.cuh::Storage: f32, c16 int16 codes or bf16). Returns the
// first CUDA error (cudaErrorInvalidValue for an odd depth), or 0.
extern "C" int lbm_band3_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                             float* partials, unsigned int* ticket, int ny, int nx, int block,
                             int depth, int panel, int n_passes, int fuse_last, float w1a,
                             float w2a, float beta, float ow0, float ow1, float ow2,
                             float inv_tot, const lbm::Storage* storage, void* stream) {
  if (depth < 2 || depth % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const band::Geom g = band::make_geom(ny, nx, block, depth, panel);
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& io) {
    using T = lbm::Raw<decltype(io)>;
    return run(static_cast<T*>(buf_a), static_cast<T*>(buf_b), nobst, av, partials, ticket, g,
               n_passes, fuse_last, w1a, w2a, rc, inv_tot, st, io);
  });
}
