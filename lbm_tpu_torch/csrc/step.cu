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
// What the design does about it: one thread per cell with threadIdx.x along
// x, so each warp reads and writes whole 128-byte lines of one plane (the
// (9, ny, nx) structure-of-arrays layout); every value is read once and
// written once. Periodic wrap is modular row/column indexing in global
// memory: the halo rows of the TPU kernel are neighbour reads that L1/L2
// serve. The forcing of row ny-2 is fused into the pull: a thread whose
// source cell lies on row ny-2 adds the forcing delta to the value it pulls,
// with the joint mask computed at that source cell from the read-only input
// buffer, so no separate pass and no race. The per-step |u| sum is reduced
// in a fixed order (lbm_common.cuh) into av[t] on the device; the whole run
// is one C call that issues all launches on the caller's stream.
#include "lbm_common.cuh"

namespace {

__global__ void __launch_bounds__(lbm::kThreads)
step_kernel(const float* __restrict__ src, float* __restrict__ dst,
            const float* __restrict__ nobst, float* __restrict__ partials,
            unsigned int* __restrict__ ticket, float* __restrict__ av_out,
            int ny, int nx, float w1a, float w2a, lbm::Relax rc, float inv_tot) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = x < nx && y < ny;
  const size_t plane = (size_t)ny * nx;
  const int frow = ny - 2;
  float u = 0.0f;
  if (inside) {
    float t[9];
    // Forcing delta on each speed (kernels.cl:21-41): +w on 1, 5, 8 and -w on 3, 6, 7.
    const float fw[9] = {0.0f, w1a, 0.0f, -w1a, 0.0f, w2a, -w2a, -w2a, w2a};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      int sy = y - lbm::cy(k);
      sy = sy < 0 ? sy + ny : (sy >= ny ? sy - ny : sy);
      int sx = x - lbm::cx(k);
      sx = sx < 0 ? sx + nx : (sx >= nx ? sx - nx : sx);
      const size_t s = (size_t)sy * nx + sx;
      float v = src[k * plane + s];
      if (fw[k] != 0.0f && sy == frow) {
        const float m = lbm::force_mask(src[3 * plane + s], src[6 * plane + s],
                                        src[7 * plane + s], nobst[s], w1a, w2a);
        v = v + fw[k] * m;
      }
      t[k] = v;
    }
    const float nob = nobst[(size_t)y * nx + x];
    const float usq = lbm::collide_fused(t, nob, rc);
    u = nob * sqrtf(usq);
    const size_t c = (size_t)y * nx + x;
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k * plane + c] = t[k];
  }
  lbm::grid_sum_last_block(u, partials, ticket, inv_tot, av_out);
}

}  // namespace

// Runs n_steps steps. buf_a holds the initial state; step t reads
// buf[t % 2] and writes buf[(t + 1) % 2], so the final state is in
// buf_a for even n_steps and in buf_b for odd. av receives n_steps values.
// partials needs one float per block of grid_for(ny, nx); ticket one
// zeroed unsigned int. Returns the first CUDA error, or 0.
extern "C" int lbm_step_run(float* buf_a, float* buf_b, const float* nobst, float* av,
                            float* partials, unsigned int* ticket, int ny, int nx,
                            int n_steps, float w1a, float w2a, float beta, float ow0,
                            float ow1, float ow2, float inv_tot, void* stream) {
  const lbm::Relax rc{beta, ow0, ow1, ow2};
  const dim3 block(lbm::kBlockX, lbm::kBlockY);
  const dim3 grid = lbm::grid_for(ny, nx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < n_steps; ++t) {
    const float* src = (t & 1) ? buf_b : buf_a;
    float* dst = (t & 1) ? buf_a : buf_b;
    step_kernel<<<grid, block, 0, s>>>(src, dst, nobst, partials, ticket, av + t, ny, nx,
                                       w1a, w2a, rc, inv_tot);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" unsigned int lbm_step_num_blocks(int ny, int nx) {
  const dim3 g = lbm::grid_for(ny, nx);
  return g.x * g.y;
}
