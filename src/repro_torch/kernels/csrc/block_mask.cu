// Block zero-mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_mask.py::_kernel
// (block_zero_mask): x [M, K] -> int8 [M / bm, K / bk], 1 where the
// bm x bk block holds any nonzero (NaN counts as nonzero, as x != 0 does).
//
// Bound: it reads x once and writes one byte per block, so it is
// memory-bound (one compare per element read).  The design keeps the read
// coalesced for either layout: one CTA per block, consecutive threads on
// consecutive addresses along x's unit-stride dimension (columns of a
// row-major operand, rows of a transposed view such as lm_head.T), a
// strided scan that stops at a thread's first nonzero, and one
// __syncthreads_or to combine the CTA.  The grid is one-dimensional over
// the Mb * Kb blocks, so no grid extent limits Mb.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool nonzero(float v) { return v != 0.f; }
__device__ __forceinline__ bool nonzero(__nv_bfloat16 v) { return __bfloat162float(v) != 0.f; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
td_block_any_kernel(const T* x, long long s0, long long s1, int bm, int bk, int kb,
                    signed char* out) {
  const long long blk = blockIdx.x;
  const int i = (int)(blk / kb), j = (int)(blk - (long long)i * kb);
  const T* base = x + (long long)i * bm * s0 + (long long)j * bk * s1;
  const int n = bm * bk;
  int any = 0;
  if (s1 == 1 || s0 != 1) {  // row-major: consecutive threads along columns
    for (int l = threadIdx.x; l < n && !any; l += kThreads) {
      const int r = l / bk, c = l - r * bk;
      any = nonzero(base[r * s0 + c * s1]);
    }
  } else {  // column-major view: consecutive threads along rows
    for (int l = threadIdx.x; l < n && !any; l += kThreads) {
      const int c = l / bm, r = l - c * bm;
      any = nonzero(base[r + c * s1]);
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) out[blk] = (signed char)(any != 0);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  x [M, K] with strides (s0, s1); out is
// int8 [M / bm, K / bk], contiguous.  Returns the cudaError_t of the launch.
int td_block_zero_mask(int dtype, const void* x, long long s0, long long s1,
                       int M, int K, int bm, int bk, signed char* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kb = K / bk;
  const long long blocks = (long long)(M / bm) * kb;
  if (blocks == 0) return (int)cudaSuccess;
  if (dtype == 0) {
    td_block_any_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), s0, s1, bm, bk, kb, out);
  } else if (dtype == 1) {
    td_block_any_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), s0, s1, bm, bk, kb, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
