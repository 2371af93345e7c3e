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
// Design: simple first.  A grid of (ceil(V / kChunk), B) CTAs of kThreads
// threads, kItems draws a thread at coalesced positions.  Each CTA packs its
// best (score, index) into one 64-bit word ordered as the argmax orders them
// (the score's bits made monotone, NaN above +inf, the index complemented so
// a smaller index wins a tie), reduces it with warp shuffles, and thread 0
// takes atomicMax into the row's slot of a workspace that is zero between
// launches.  The last CTA of a row to arrive (an arrival counter) reads and
// clears the slot, resets the counter, and writes the token and the key:
// one launch, no memset, nothing for a CUDA graph to re-arm.  Every CTA of a
// row reads the key before it arrives, so the last one may overwrite it.
// A row whose good flag is clear draws nothing.

#include <cuda_runtime.h>
#include <stdint.h>

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
};

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;
constexpr float kTiny = 1.17549435e-38f;  // the smallest normal float

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Threefry-2x32, 20 rounds: JAX's threefry2x32 (jax/_src/prng.py).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

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

__global__ void __launch_bounds__(kThreads) td_sample_kernel(TdSampleArgs a) {
  const int b = blockIdx.y;
  const bool good = a.good[b] != 0;
  const uint32_t k0 = a.keys[2 * b], k1 = a.keys[2 * b + 1];
  unsigned long long best = 0;  // below every packed draw
  if (good) {
    const uint2 sub = threefry2x32(k0, k1, 0u, 1u);
    const float* row = a.rows + (long long)b * a.row_stride;
    const long long base = (long long)blockIdx.x * kChunk + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = base + j * kThreads;
      if (i < a.V) {
        const uint2 h = threefry2x32(sub.x, sub.y, 0u, (uint32_t)i);
        const uint32_t bits = h.x ^ h.y;
        const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
        const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
        const float g = -logf(-logf(u));
        const float x = row[i * a.col_stride];
        const float scaled = a.reciprocal ? __fmul_rn(x, a.inv) : __fdiv_rn(x, a.temperature);
        const unsigned long long p = pack(__fadd_rn(g, scaled), (uint32_t)i);
        best = p > best ? p : best;
      }
    }
  }
  __shared__ unsigned long long warp_best[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, best, off);
    best = o > best ? o : best;
  }
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) best = warp_best[w] > best ? warp_best[w] : best;
  if (good) atomicMax(&a.best[b], best);
  __threadfence();
  if (atomicAdd(&a.arrived[b], 1u) != gridDim.x - 1) return;
  // the row's last CTA: every other one has reported and read the key
  __threadfence();
  const unsigned long long w = atomicExch(&a.best[b], 0ull);
  a.arrived[b] = 0u;
  if (!good) {
    a.tokens[b] = a.pad_id;
    return;
  }
  a.tokens[b] = (long long)(0xFFFFFFFFu - (uint32_t)(w & 0xFFFFFFFFull));
  const uint2 next = threefry2x32(k0, k1, 0u, 0u);
  a.keys[2 * b] = next.x;
  a.keys[2 * b + 1] = next.y;
}

}  // namespace

extern "C" {

// One launch on `stream`; returns its cudaError_t.
int td_sample(const TdSampleArgs* args, void* stream) {
  const TdSampleArgs& a = *args;
  if (a.B <= 0 || a.B > 65535 || a.V <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.V + kChunk - 1) / kChunk), (unsigned)a.B);
  td_sample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
