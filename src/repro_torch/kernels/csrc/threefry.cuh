// JAX's Threefry-2x32 hash (20 rounds) for the port's kernels that replay
// jax.random: the sampler (sample.cu) and the normal fill (normal.cu).  Its
// plain version is threefry2x32 in repro_torch/prng.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace td_threefry {

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

}  // namespace td_threefry
