// The normal fill for Hopper (sm_90a): jax.random.normal's draws, bit for
// bit, straight into a parameter's storage.
//
// Replaces no Pallas kernel: it is what XLA runs for the JAX package's
// init_params (src/repro/models/common.py:51-73), one jax.random.normal(key,
// stacked_shape, float32) a leaf, times the leaf's std and cast to its dtype.
// One launch fills one block of one leaf: the whole leaf, one layer of a
// stacked leaf (the port keeps layers apart), or one rank's shard of either.
// For element i of the block, with flat index f in the (stacked) leaf:
//
//   bits  = x ^ y of threefry2x32(key, (f >> 32, f & 0xffffffff))
//   x     = max(lo, (float(0x3F800000 | bits >> 9) - 1) * 2 + lo),  lo = nextafter(-1, 0)
//   out_i = round_to_dtype(x * erf_inv(x) * sqrt(2) * std)
//
// erf_inv is XLA's float32 polynomial (two 9-term Horner chains split at w =
// -log1p(-x * x) = 5), and log1p is what XLA's CPU backend computes for it: a
// rational function below |t| = sqrt(2) - 1, Cephes' logf of 1 + t above.
// Every step is an explicit _rn intrinsic, fused (__fmaf_rn) exactly where
// the CPU backend's machine code fuses, so nvcc's contraction cannot move a
// bit; the plain version (normal_of_bits in repro_torch/prng.py) rounds the
// same steps the same way, and both equal JAX's draws on the CPU.
//
// Bound.  Operations: one 20-round Threefry hash (about 73 integer
// operations) and about 60 float operations a draw against 2 or 4 bytes
// stored; at bf16 the hash alone needs ~7x the time of the store at the
// card's INT32 rate (normal_bound in chip_smoke.py).
//
// Design.  A simple grid-stride loop: a fixed grid of about kCtasPerSm CTAs
// a SM (from the wrapper), each thread one element a step, consecutive
// threads on consecutive elements so every store coalesces, bf16 rounded in
// registers (no fp32 scratch tensor).  The wrapper merges the block's dims
// where they are contiguous in the leaf, so a whole leaf or a layer of a
// stack is one dim (flat = offset + i) and only a shard's block walks its
// multi-index with divisions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

constexpr int kMaxDims = 6;  // mirrored by MAX_DIMS in kernels/normal.py

// The launch arguments (NormalArgs in repro_torch/kernels/_build.py; keep
// the two in step).
struct TdNormalArgs {
  void* out;                    // the block, contiguous, bf16 or fp32
  long long n;                  // its elements
  long long offset;             // flat index in the leaf of its first element
  long long shape[kMaxDims];    // its dims (merged), outermost first
  long long stride[kMaxDims];   // each dim's stride in the leaf
  unsigned int k0, k1;          // the leaf's key
  float scale;                  // the leaf's std (1: embed)
  int ndim;
  int out_bf16;
  int grid;                     // CTAs
};

namespace {

constexpr int kThreads = 256;  // mirrored by NORMAL_THREADS in kernels/normal.py

using td_threefry::threefry2x32;

// XLA's constants (csrc and repro_torch/prng.py keep the same values)
constexpr float kLo = -0x1.fffffep-1f, kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f, kLog1pSmall = 0x1.a8279ap-2f;
constexpr float kLnLo = -0x1.bd0106p-13f, kLnHi = 0x1.63p-1f;
__constant__ float kLogA[3] = {0x1.204376p-4f, -0x1.d7a37p-4f, 0x1.de4a34p-4f};
__constant__ float kLogB[3] = {-0x1.fcba9ep-4f, 0x1.23d37ep-3f, -0x1.555ca0p-3f};
__constant__ float kLogC[3] = {0x1.999d58p-3f, -0x1.fffff8p-3f, 0x1.555554p-2f};
__constant__ float kP[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f, 0x1.e798ecp+5f,
                            0x1.c8e75ap+5f, 0x1.40a202p+4f};
__constant__ float kQ[7] = {0x1p+0f, 0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f, 0x1.351946p+8f,
                            0x1.b0db14p+7f, 0x1.e0f304p+5f};
__constant__ float kErfLt5[9] = {0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f, -0x1.26b582p-18f,
                                 0x1.ca65b6p-13f, -0x1.48a810p-10f, -0x1.11c9dep-8f, 0x1.f91ec6p-3f,
                                 0x1.805c5ep+0f};
__constant__ float kErfGe5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f, -0x1.e17bcep-9f,
                                 0x1.7824f6p-8f, -0x1.f38baep-8f, 0x1.354afcp-7f, 0x1.006db6p+0f,
                                 0x1.6a9efcp+1f};

__device__ __forceinline__ float poly3(float x, const float* c) {
  return __fmaf_rn(x, __fmaf_rn(x, c[0], c[1]), c[2]);
}

// XLA's CPU float32 log1p(t) for t in (-1, 0]: 1 + t is a positive normal
// float, so none of the log's special cases arise.
__device__ __forceinline__ float log1p_xla(float t) {
  const float u = __fadd_rn(t, 1.0f);
  const uint32_t bits = __float_as_uint(u);
  float e = __fadd_rn(__int2float_rn((int)(bits >> 23) - 127), 1.0f);
  const float m = __uint_as_float((bits & 0x7FFFFFu) | 0x3F000000u);  // u = m * 2^e, m in [0.5, 1)
  const bool low = m < kSqrtHalf;
  const float xm = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  if (low) e = __fsub_rn(e, 1.0f);
  const float z = __fmul_rn(xm, xm), z3 = __fmul_rn(z, xm);
  const float s = __fmaf_rn(z3, __fmaf_rn(z3, __fmaf_rn(z3, poly3(xm, kLogA), poly3(xm, kLogB)), poly3(xm, kLogC)),
                            __fmul_rn(e, kLnLo));
  const float big = __fmaf_rn(e, kLnHi, __fadd_rn(s, __fmaf_rn(-0.5f, z, xm)));
  const float t2 = __fmul_rn(t, t);
  float p = kP[0], q = 1.0f;
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    p = __fmaf_rn(t, p, kP[i]);
    q = __fmaf_rn(t, q, kQ[i]);
  }
  const float small = __fadd_rn(t, __fmaf_rn(-0.5f, t2, __fmul_rn(__fmul_rn(t, t2), __fdiv_rn(p, q))));
  return fabsf(t) < kLog1pSmall ? small : big;
}

// jax.random.normal's float32 draw from 32 random bits
__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float x = fmaxf(kLo, __fadd_rn(__fmul_rn(f, 2.0f), kLo));  // f * 2 exact: one rounding
  const float lg = log1p_xla(__fmul_rn(x, -x));  // -w
  const bool lt5 = lg > -5.0f;
  const float w = lt5 ? __fsub_rn(-2.5f, lg) : __fadd_rn(__fsqrt_rn(-lg), -3.0f);
  float p = lt5 ? kErfLt5[0] : kErfGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(w, p, lt5 ? kErfLt5[i] : kErfGe5[i]);  // a select, not a divergent load
  return __fmul_rn(__fmul_rn(x, p), kSqrt2);
}

template <bool kBf16, bool kFlat>  // kFlat: one dim of unit stride
__global__ void __launch_bounds__(kThreads) td_normal_kernel(TdNormalArgs a) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.n; i += step) {
    unsigned long long flat = (unsigned long long)a.offset;
    if (kFlat) {
      flat += (unsigned long long)i;
    } else {
      unsigned long long rest = (unsigned long long)i;
      for (int d = a.ndim - 1; d > 0; --d) {
        const unsigned long long n = (unsigned long long)a.shape[d];
        const unsigned long long q = rest / n;
        flat += (rest - q * n) * (unsigned long long)a.stride[d];
        rest = q;
      }
      flat += rest * (unsigned long long)a.stride[0];
    }
    const uint2 h = threefry2x32(a.k0, a.k1, (uint32_t)(flat >> 32), (uint32_t)flat);
    const float v = __fmul_rn(normal_of_bits(h.x ^ h.y), a.scale);
    if (kBf16) static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
    else static_cast<float*>(a.out)[i] = v;
  }
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t.
int td_normal(const TdNormalArgs* args, void* stream) {
  const TdNormalArgs& a = *args;
  if (a.n <= 0 || a.ndim < 1 || a.ndim > kMaxDims || a.grid <= 0 || a.out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool flat = a.ndim == 1 && a.stride[0] == 1;
  if (a.out_bf16) {
    if (flat) td_normal_kernel<true, true><<<a.grid, kThreads, 0, st>>>(a);
    else td_normal_kernel<true, false><<<a.grid, kThreads, 0, st>>>(a);
  } else {
    if (flat) td_normal_kernel<false, true><<<a.grid, kThreads, 0, st>>>(a);
    else td_normal_kernel<false, false><<<a.grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
