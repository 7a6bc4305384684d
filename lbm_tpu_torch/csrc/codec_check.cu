// The c16 codec (lbm_common.cuh::C16) against the same arithmetic with the
// card's conversion instructions, over every input: encode over all 2^32
// f32 bit patterns and decode over all 2^16 codes, at each of the 9 keys
// of a run's constants. Not a step kernel: chip_smoke.py phase 29 runs it
// once per codec change, in well under a second on an H100.
#include "lbm_common.cuh"

namespace {

// C16 with the conversions that the card's instructions make: I2F for the
// code, FRND for rint and F2I for the int (the codec's earlier form).
struct C16Convert {
  lbm::C16 c;
  __device__ __forceinline__ float load(int16_t q, int k) const {
    const float r = __fmul_rn(static_cast<float>(q), c.inv_lim);
    return __fadd_rn(__fmul_rn(__fmul_rn(r, fabsf(r)), c.h), c.bg[k]);
  }
  __device__ __forceinline__ int16_t store(float v, int k) const {
    const float d = __fsub_rn(v, c.bg[k]);
    const float s = copysignf(sqrtf(__fmul_rn(fabsf(d), c.inv_h)), d);
    const float q = fminf(fmaxf(rintf(__fmul_rn(s, lbm::kLim)), -lbm::kLim), lbm::kLim);
    return static_cast<int16_t>(q);
  }
};

// bad[0] += the (input, key) pairs whose codes differ; bad[1] += the
// (code, key) pairs whose decoded values differ in any bit.
__global__ void codec_sweep_kernel(lbm::C16 c, unsigned long long* bad) {
  const C16Convert ref{c};
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  const unsigned long long first = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long codes = 0, values = 0;
  for (unsigned long long i = first; i < (1ull << 32); i += stride) {
    const float v = __uint_as_float(static_cast<uint32_t>(i));
#pragma unroll
    for (int k = 0; k < 9; ++k) codes += c.store(v, k) != ref.store(v, k);
  }
  for (unsigned long long i = first; i < (1ull << 16); i += stride) {
    const int16_t q = static_cast<int16_t>(static_cast<uint16_t>(i));
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      values += __float_as_uint(c.load(q, k)) != __float_as_uint(ref.load(q, k));
    }
  }
  if (codes) atomicAdd(bad, codes);
  if (values) atomicAdd(bad + 1, values);
}

}  // namespace

// Sweeps the codec of ``storage`` (kind c16) into bad[0..1], two zeroed
// unsigned 64-bit counters on the device. Returns the first CUDA error, or
// 0 (cudaErrorInvalidValue for another storage).
extern "C" int lbm_c16_sweep(const lbm::Storage* storage, unsigned long long* bad, void* stream) {
  if (storage == nullptr || storage->kind != lbm::kStorageC16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lbm::count_launch();
  codec_sweep_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lbm::make_c16(storage->codec), bad);
  return static_cast<int>(cudaGetLastError());
}
