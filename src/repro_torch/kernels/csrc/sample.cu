// Per-slot sampling of one decode step for Hopper (sm_90a): JAX's key step
// and Gumbel-max draw, bit for bit.
//
// Replaces no Pallas kernel: it is the sampling that XLA fuses into the JAX
// serve engine's jitted decode scan (src/repro/serve/engine.py, _decode_chunk:
// jax.random.split of each slot's key, then jax.random.categorical of the
// temperature-scaled logits row under the subkey, :180-182, and the first
// token at admission, :535-540).  One launch a decode step does, for each
// slot row b of fp32 logits [B, V]:
//
//   (next, sub) = split(key[b])            threefry2x32(key, (0, 0)), (0, 1)
//   bits_i      = x ^ y of threefry2x32(sub, (0, i)),  i < V
//   u_i         = max(tiny, f_i + tiny), f_i = float(0x3F800000 | bits_i >> 9) - 1
//   score_i     = scaled(row[b, i]) + (-log(-log(u_i)))
//   token[b]    = good[b] ? first argmax_i score_i : pad_id
//   key[b]      = good[b] ? next : key[b]
//
// where scaled(x) is x / temperature (IEEE division: JAX's eager admission
// path) or x * inv with inv = 1 / temperature rounded to fp32 (the jitted
// decode step: XLA rewrites division by a constant into that product).  The
// argmax follows jnp.argmax: the first NaN wins, then the first of equal
// maxima (-0 equal to +0).  logf and the _rn intrinsics keep the arithmetic
// IEEE (the build has no fast-math), so the kernel equals its plain version
// (repro_torch/kernels/sample.py, sample_tokens_ref) on the card bit for bit.
//
// Bound.  Operations, not bytes: each draw is one 20-round Threefry hash
// (about 100 integer operations), two logf, a division and the compare; the
// logits row is read once (4 bytes a draw).  At 4 slots x 102400 that is
// 1.6 MB against ~50 M operations.
//
// Design.  At the served shapes the draws take about as long as a launch's
// fixed cost (the launch itself, the key and flag loads, two Threefry
// hashes of the key, the completion's round trips through L2), so the
// kernel is laid out to pay that cost once and in parallel:
// * The grid comes from the SM count (sample_geometry in kernels/sample.py):
//   about kCtasPerSm CTAs of kThreads threads a SM in all, each CTA a
//   contiguous chunk of a row, so every SM gets the same draws and no CTA
//   waits for a second wave.
// * Each thread asks for its first two logits before anything else; the
//   key and flag loads and both hashes of the key (sub for the draws, next
//   for the key the slot keeps) run while they are in flight, and each
//   step of the loop asks for the next two logits before it draws two
//   independent positions (two hash chains interleaved).
// * Indices are 32-bit (the wrapper keeps V below 2^31), and a unit column
//   stride is a separate instantiation.
// * Each CTA packs its best (score, index) into one 64-bit word ordered as
//   the argmax orders them (the score's bits made monotone, NaN above +inf,
//   the index complemented so a smaller index wins a tie), reduces it with
//   warp shuffles, and thread 0 takes atomicMax into the row's slot of a
//   workspace that is zero between launches, then arrives on the row's
//   counter with one acquire-release atomic (ordering its maximum before
//   the arrival, and the last arrival after every other CTA's maximum).
//   The last CTA reads and clears the slot, resets the counter and writes
//   the token and the key: one launch, no memset, nothing for a CUDA graph
//   to re-arm.  Every CTA of a row reads the key before it arrives, so the
//   last one may overwrite it.  A row whose good flag is clear draws
//   nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

// The launch arguments (SampleArgs in repro_torch/kernels/_build.py; keep
// the two in step).
struct TdSampleArgs {
  const float* rows;            // [B, V] fp32
  long long row_stride;         // elements between rows
  long long col_stride;         // elements between columns
  uint32_t* keys;               // [B, 2] in place
  const unsigned char* good;    // [B] bool
  long long* tokens;            // [B] out
  unsigned long long* best;     // [B] workspace, zero between launches
  unsigned int* arrived;        // [B] workspace, zero between launches
  float temperature;
  float inv;                    // fp32(1 / temperature)
  int reciprocal;               // 1: x * inv, 0: x / temperature
  int B, V, pad_id;
  int chunk;                    // positions a CTA: the grid is (ceil(V / chunk), B)
};

namespace {

constexpr int kThreads = 256;  // mirrored by SAMPLE_THREADS in kernels/sample.py
constexpr int kMaxV = 0x7FFFFC00;  // a row's positions: an index three steps past the end fits an int
constexpr float kTiny = 1.17549435e-38f;  // the smallest normal float

using td_threefry::threefry2x32;

// (score, index) as one word whose unsigned order is jnp.argmax's choice.
__device__ __forceinline__ unsigned long long pack(float s, uint32_t i) {
  uint32_t ord;
  if (s != s) {
    ord = 0xFFFFFFFFu;
  } else {
    uint32_t u = s == 0.0f ? 0u : __float_as_uint(s);
    ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)ord << 32) | (unsigned long long)(0xFFFFFFFFu - i);
}

// position i's packed score: its Gumbel draw under the subkey plus its scaled logit
__device__ __forceinline__ unsigned long long draw(const TdSampleArgs& a, uint2 sub, float x, int i) {
  const uint2 h = threefry2x32(sub.x, sub.y, 0u, (uint32_t)i);
  const uint32_t bits = h.x ^ h.y;
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  const float g = -logf(-logf(u));
  const float scaled = a.reciprocal ? __fmul_rn(x, a.inv) : __fdiv_rn(x, a.temperature);
  return pack(__fadd_rn(g, scaled), (uint32_t)i);
}

__device__ __forceinline__ unsigned long long umax(unsigned long long x, unsigned long long y) { return x > y ? x : y; }

// the row's arrival counter, +1: release (this CTA's maximum before it) and
// acquire (every earlier arrival's maximum after it)
__device__ __forceinline__ unsigned arrive(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

template <bool kUnit>  // kUnit: columns one element apart
__global__ void __launch_bounds__(kThreads) td_sample_kernel(TdSampleArgs a) {
  const int b = blockIdx.y;
  const int start = blockIdx.x * a.chunk, end = (int)min((long long)a.V, (long long)start + a.chunk);
  const float* row = a.rows + (long long)b * a.row_stride;
  auto logit = [&](int i) { return i < end ? (kUnit ? row[i] : row[(long long)i * a.col_stride]) : 0.0f; };
  int i = start + threadIdx.x;
  float x0 = logit(i), x1 = logit(i + kThreads);
  const bool good = a.good[b] != 0;
  const uint32_t k0 = a.keys[2 * b], k1 = a.keys[2 * b + 1];
  const uint2 sub = threefry2x32(k0, k1, 0u, 1u), next = threefry2x32(k0, k1, 0u, 0u);
  unsigned long long best = 0;  // below every packed draw
  if (good) {
    for (; i < end; i += 2 * kThreads) {
      const float y0 = logit(i + 2 * kThreads), y1 = logit(i + 3 * kThreads);
      best = umax(best, draw(a, sub, x0, i));
      if (i + kThreads < end) best = umax(best, draw(a, sub, x1, i + kThreads));
      x0 = y0;
      x1 = y1;
    }
  }
  __shared__ unsigned long long warp_best[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = umax(best, __shfl_down_sync(0xFFFFFFFFu, best, off));
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) best = umax(best, warp_best[w]);
  if (good) atomicMax(&a.best[b], best);
  if (arrive(&a.arrived[b]) != gridDim.x - 1) return;
  // the row's last CTA: every other one has reported and read the key
  const unsigned long long w = atomicExch(&a.best[b], 0ull);
  a.arrived[b] = 0u;
  if (!good) {
    a.tokens[b] = a.pad_id;
    return;
  }
  a.tokens[b] = (long long)(0xFFFFFFFFu - (uint32_t)(w & 0xFFFFFFFFull));
  a.keys[2 * b] = next.x;
  a.keys[2 * b + 1] = next.y;
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t.
int td_sample(const TdSampleArgs* args, void* stream) {
  const TdSampleArgs& a = *args;
  if (a.B <= 0 || a.B > 65535 || a.V <= 0 || a.V > kMaxV || a.chunk <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.V + a.chunk - 1) / a.chunk), (unsigned)a.B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.col_stride == 1) td_sample_kernel<true><<<grid, kThreads, 0, st>>>(a);
  else td_sample_kernel<false><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
