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
#include "lbm_common.cuh"

namespace {

template <class S>
__global__ void __launch_bounds__(lbm::kThreads)
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

template <class S>
int run(void* buf_a, void* buf_b, const float* nobst, float* av, float* partials,
        unsigned int* ticket, int ny, int nx, int n_steps, float w1a, float w2a,
        const lbm::Relax& rc, float inv_tot, cudaStream_t s, const S& st) {
  using T = typename S::T;
  const dim3 block(lbm::kBlockX, lbm::kBlockY);
  const dim3 grid = lbm::grid_for(ny, nx);
  for (int t = 0; t < n_steps; ++t) {
    const T* src = static_cast<const T*>((t & 1) ? buf_b : buf_a);
    T* dst = static_cast<T*>((t & 1) ? buf_a : buf_b);
    step_kernel<S><<<grid, block, 0, s>>>(src, dst, nobst, partials, ticket, av + t, ny, nx,
                                          w1a, w2a, rc, inv_tot, st);
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
// Storage: f32, c16 int16 codes or bf16). Returns the first CUDA error, or 0.
extern "C" int lbm_step_run(void* buf_a, void* buf_b, const float* nobst, float* av,
                            float* partials, unsigned int* ticket, int ny, int nx,
                            int n_steps, float w1a, float w2a, float beta, float ow0,
                            float ow1, float ow2, float inv_tot, const lbm::Storage* storage,
                            void* stream) {
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lbm::with_storage(storage, [&](const auto& st) {
    return run(buf_a, buf_b, nobst, av, partials, ticket, ny, nx, n_steps, w1a, w2a, rc, inv_tot,
               s, st);
  });
}

extern "C" unsigned int lbm_step_num_blocks(int ny, int nx) {
  const dim3 g = lbm::grid_for(ny, nx);
  return g.x * g.y;
}
