// TensorDash planned block-sparse matmul for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/tensordash_spmm.py:
//   * _ragged_kernel (tensordash_matmul_planned, compact_grid="ragged") and
//     _ragged_fused_kernel (tensordash_matmul_fused, "ragged"): the plan's
//     CSR work queue;
//   * _kernel and _fused_kernel (the same wrappers, compact_grid "v2"/"v1"):
//     the plan's idx[m, k] read directly over a K bound kdim, which is Kb
//     for v1 and max(max(nnz), 1) for v2.
// The fused kernels add the fp32 epilogue (bias -> none|relu|squared_relu
// -> residual) and the emitted int8 [Mb, Nb] output block-nonzero mask.
//
// What they compute: C = A @ B over the plan.  Block row m of A has the
// effectual K blocks idx[m, 0..nnz[m]) in ascending order; the ragged kernel
// finds them as queue items [row_starts[m], row_starts[m+1]) (item t
// contracts K block work_kblk[t]), the v1/v2 kernel as grid steps j < kdim
// that accumulate when j < nnz[m] (the TPU's gated K axis).  A row with
// nnz[m] == 0 contracts nothing, so its output is the epilogue of a zero
// accumulator.
//
// The three families are bit-identical: each CTA (n tile, block row m,
// split s) takes steps [s * per, (s + 1) * per) of its row's effectual list,
// per = ceil(max(nnz[m], 1) / S), with the same S for every family, adds
// one fp32 partial per block in ascending order, and td_reduce_kernel sums
// the S partials in split order.  v2's bound never reaches the host: each
// CTA reduces max(nnz) over the plan's rows itself (a few ints at decode),
// so no call syncs to size a grid.
//
// Bound at the main path's decode shapes (4 slots, bf16, H100 SXM at
// 3.35 TB/s): each product reads its weight once and does 2 FLOP per weight
// element, far below the ~295 FLOP/byte ridge, so all three are
// memory-bound: gate [4,4096]@[4096,11008] and w_down [4,11008]@[11008,4096]
// read 90.2 MB each (>= 27 us), the LM head lm_head.T [102400,4096] @ [4096,4]
// reads 839 MB (>= 250 us).  What the design does about it is to keep
// enough bytes in flight:
//
// * Grid.  The TPU walks the queue as a sequential grid axis and carries the
//   accumulator in VMEM.  Here the grid is static, (N / TN column tiles, Mb
//   block rows, S splits), and each CTA walks a contiguous share of its
//   row's queue segment in ascending order, so row_starts[-1] never reaches
//   the host.  At decode Mb is 1, so the splits (S > 1) are what fill the
//   132 SMs: each split writes its fp32 partial sum to a workspace and
//   td_reduce_kernel adds the S partials in ascending split order, applies
//   the epilogue and the mask, and stores.  With S == 1 the main kernel
//   does that itself.  The order of every sum is fixed, so results are
//   deterministic.
// * Loads.  Tiles of A [bm, KC] and B [KC, TN] are staged in shared memory
//   as fp32.  Consecutive threads take consecutive addresses along the
//   operand's unit-stride dimension, 16 bytes at a time when the wrapper
//   found the operand aligned for it, so both a row-major weight and the
//   strided lm_head.T view of the side-B LM head load coalesced without a
//   copy.
// * Arithmetic.  Each queue item's block product is summed in fp32 into
//   `part`, then added to the accumulator.  fp32 inputs use plain FMA on
//   CUDA cores (no TF32); bf16 is widened with __bfloat162float and stored
//   with __float2bfloat16_rn.  No tensor cores: at decode the products are
//   memory-bound; a TMA + wgmma version is later work.
// * Mask.  The column tile TN divides the plan's bn, so a CTA's tile lies
//   inside one mask block: the CTA reduces any(out32 != 0) with
//   __syncthreads_or and, when set, stores 1 into the mask (zeroed by the
//   wrapper; several CTAs may store the same 1).
//
// The epilogue uses __fadd_rn/__fmul_rn so nvcc cannot contract
// square-then-add into one FMA: the plain executor rounds twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 8;  // bm * TN <= kThreads * kMaxPerThread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16-byte vector of T, widened to fp32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
};

struct Args {
  const void* a; long long sam, sak;  // A [M, K] with strides (rows, cols)
  const void* b; long long sbk, sbn;  // B [K, N] with strides (rows, cols)
  void* out;                          // C [M, N], contiguous
  float* partial;                     // [S, M, N] fp32 workspace (S > 1) or null
  const int* nnz;                     // [Mb]
  const int* row_starts;              // [Mb + 1]      (ragged)
  const int* work_kblk;               // [Mb * Kb]     (ragged)
  const int* idx;                     // [Mb, Kb]      (v1/v2)
  int kdim;                           // v1/v2 K bound; 0: max(max(nnz), 1) (v2)
  int M, K, N, bm, bk, TN, KC, S;
  int vec_a, vec_b;                   // 16-byte loads along the unit-stride dim
  // fused epilogue (ignored by the planned kernel)
  const float* bias;                  // [N] fp32 or null
  const void* residual;               // [M, N] contiguous, A's dtype, or null
  int activation;                     // 0 none, 1 relu, 2 squared_relu
  signed char* mask;                  // [Mb, N / bn] int8, zero-filled
  int bn;
};

// Epilogue of one output element and its store; returns v != 0 (fused).
template <typename T, bool kFused>
__device__ __forceinline__ int finish(const Args& p, long long o, int col, float v) {
  int nz = 0;
  if (kFused) {
    if (p.bias) v = __fadd_rn(v, p.bias[col]);
    if (p.activation == 1) {
      v = fmaxf(v, 0.f);
    } else if (p.activation == 2) {
      v = fmaxf(v, 0.f);
      v = __fmul_rn(v, v);
    }
    if (p.residual) v = __fadd_rn(v, to_f32(static_cast<const T*>(p.residual)[o]));
    nz = (v != 0.f);
  }
  static_cast<T*>(p.out)[o] = from_f32<T>(v);
  return nz;
}

template <typename T>
__device__ __forceinline__ void stage_a(const Args& p, float* As, int KCp, int row0,
                                        long long kbase, int kc) {
  const T* A = static_cast<const T*>(p.a);
  constexpr int V = Vec<T>::n;
  const int tid = threadIdx.x;
  if (p.sak == 1) {  // row-major: consecutive threads along k
    if (p.vec_a && kc % V == 0) {
      const int per_row = kc / V, nv = p.bm * per_row;
      for (int l = tid; l < nv; l += kThreads) {
        const int r = l / per_row, kk = (l - r * per_row) * V;
        float f[V];
        Vec<T>::load(A + (long long)(row0 + r) * p.sam + kbase + kk, f);
#pragma unroll
        for (int i = 0; i < V; ++i) As[r * KCp + kk + i] = f[i];
      }
    } else {
      for (int l = tid; l < p.bm * kc; l += kThreads) {
        const int r = l / kc, kk = l - r * kc;
        As[r * KCp + kk] = to_f32(A[(long long)(row0 + r) * p.sam + kbase + kk]);
      }
    }
  } else {  // column-major view (lm_head.T): consecutive threads along rows
    if (p.vec_a && p.sam == 1 && p.bm % V == 0) {
      const int per_col = p.bm / V, nv = kc * per_col;
      for (int l = tid; l < nv; l += kThreads) {
        const int kk = l / per_col, r = (l - kk * per_col) * V;
        float f[V];
        Vec<T>::load(A + (long long)row0 + r + (kbase + kk) * p.sak, f);
#pragma unroll
        for (int i = 0; i < V; ++i) As[(r + i) * KCp + kk] = f[i];
      }
    } else {
      for (int l = tid; l < p.bm * kc; l += kThreads) {
        const int kk = l / p.bm, r = l - kk * p.bm;
        As[r * KCp + kk] = to_f32(A[(long long)(row0 + r) * p.sam + (kbase + kk) * p.sak]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_b(const Args& p, float* Bs, int TNp, int n0,
                                        long long kbase, int kc) {
  const T* B = static_cast<const T*>(p.b);
  constexpr int V = Vec<T>::n;
  const int tid = threadIdx.x;
  if (p.sbn == 1) {  // row-major: consecutive threads along n
    if (p.vec_b && p.TN % V == 0) {
      const int per_row = p.TN / V, nv = kc * per_row;
      for (int l = tid; l < nv; l += kThreads) {
        const int kk = l / per_row, c = (l - kk * per_row) * V;
        float f[V];
        Vec<T>::load(B + (kbase + kk) * p.sbk + n0 + c, f);
#pragma unroll
        for (int i = 0; i < V; ++i) Bs[kk * TNp + c + i] = f[i];
      }
    } else {
      for (int l = tid; l < kc * p.TN; l += kThreads) {
        const int kk = l / p.TN, c = l - kk * p.TN;
        Bs[kk * TNp + c] = to_f32(B[(kbase + kk) * p.sbk + n0 + c]);
      }
    }
  } else {  // transposed view (h.T of the side-B LM head): along k
    for (int l = tid; l < kc * p.TN; l += kThreads) {
      const int c = l / kc, kk = l - c * kc;
      Bs[kk * TNp + c] = to_f32(B[(kbase + kk) * p.sbk + (long long)(n0 + c) * p.sbn]);
    }
  }
}

// The v1/v2 K bound: v1 passes Kb; v2 passes 0 and every CTA reduces
// max(max(nnz), 1) over the plan's Mb rows from global memory.
__device__ __forceinline__ int grid_kdim(const Args& p) {
  __shared__ int s_kdim;
  if (p.kdim > 0) return p.kdim;
  if (threadIdx.x == 0) s_kdim = 1;
  __syncthreads();
  const int mb = p.M / p.bm;
  for (int i = threadIdx.x; i < mb; i += kThreads) atomicMax(&s_kdim, p.nnz[i]);
  __syncthreads();
  return s_kdim;
}

// kIdx: false walks the ragged work queue, true the v1/v2 grid over idx.
template <typename T, bool kFused, bool kIdx>
__global__ void __launch_bounds__(kThreads)
td_spmm_kernel(Args p) {
  extern __shared__ float smem[];
  const int KCp = p.KC + 1, TNp = p.TN + 1;
  float* As = smem;                   // [bm][KC + 1]
  float* Bs = smem + p.bm * KCp;      // [KC][TN + 1]

  const int tid = threadIdx.x;
  const int m = blockIdx.y;
  const int split = blockIdx.z;
  const int n0 = blockIdx.x * p.TN;
  const int row0 = m * p.bm;
  const int tile = p.bm * p.TN;

  float acc[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) acc[i] = 0.f;

  const int kdim = kIdx ? grid_kdim(p) : 0;
  if (p.nnz[m] > 0) {
    // this split's contiguous share of the row's effectual list: queue items
    // t0 + j (ragged) or grid steps j < kdim with j < nnz[m] (v1/v2)
    const int t0 = kIdx ? 0 : p.row_starts[m];
    const int cnt = kIdx ? p.nnz[m] : p.row_starts[m + 1] - t0;
    const int per = (cnt + p.S - 1) / p.S;
    const int j_beg = min(cnt, split * per);
    int j_end = min(cnt, (split + 1) * per);
    if (kIdx) j_end = min(j_end, kdim);
    const int* kblk = kIdx ? p.idx + (long long)m * (p.K / p.bk) : p.work_kblk + t0;
    for (int j = j_beg; j < j_end; ++j) {
      const int k_blk0 = kblk[j] * p.bk;
      float part[kMaxPerThread];
#pragma unroll
      for (int i = 0; i < kMaxPerThread; ++i) part[i] = 0.f;
      for (int kc0 = 0; kc0 < p.bk; kc0 += p.KC) {
        const int kc = min(p.KC, p.bk - kc0);
        stage_a<T>(p, As, KCp, row0, (long long)k_blk0 + kc0, kc);
        stage_b<T>(p, Bs, TNp, n0, (long long)k_blk0 + kc0, kc);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kMaxPerThread; ++i) {
          const int e = tid + i * kThreads;
          if (e < tile) {
            const int r = e / p.TN, c = e - r * p.TN;
            const float* ar = As + r * KCp;
            const float* bc = Bs + c;
            float s = part[i];
            for (int kk = 0; kk < kc; ++kk) s = fmaf(ar[kk], bc[kk * TNp], s);
            part[i] = s;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kMaxPerThread; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
  }

  int any_nz = 0;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < tile) {
      const int r = e / p.TN, c = e - r * p.TN;
      const long long o = (long long)(row0 + r) * p.N + n0 + c;
      if (p.S > 1) {
        p.partial[(long long)split * p.M * p.N + o] = acc[i];
      } else {
        any_nz |= finish<T, kFused>(p, o, n0 + c, acc[i]);
      }
    }
  }
  if (kFused && p.S == 1) {
    const int blk_any = __syncthreads_or(any_nz);
    if (tid == 0 && blk_any) p.mask[(long long)m * (p.N / p.bn) + n0 / p.bn] = 1;
  }
}

// Sum the S split partials in ascending order, then epilogue, store, mask.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
td_reduce_kernel(Args p) {
  const int tid = threadIdx.x;
  const int m = blockIdx.y;
  const int n0 = blockIdx.x * p.TN;
  const int row0 = m * p.bm;
  const int tile = p.bm * p.TN;
  const long long plane = (long long)p.M * p.N;
  int any_nz = 0;
  for (int e = tid; e < tile; e += kThreads) {
    const int r = e / p.TN, c = e - r * p.TN;
    const long long o = (long long)(row0 + r) * p.N + n0 + c;
    float v = 0.f;
    for (int s = 0; s < p.S; ++s) v = __fadd_rn(v, p.partial[s * plane + o]);
    any_nz |= finish<T, kFused>(p, o, n0 + c, v);
  }
  if (kFused) {
    const int blk_any = __syncthreads_or(any_nz);
    if (tid == 0 && blk_any) p.mask[(long long)m * (p.N / p.bn) + n0 / p.bn] = 1;
  }
}

template <typename T, bool kFused, bool kIdx>
int launch_t(const Args& p, cudaStream_t s) {
  const size_t shmem = sizeof(float) * ((size_t)p.bm * (p.KC + 1) + (size_t)p.KC * (p.TN + 1));
  auto k = td_spmm_kernel<T, kFused, kIdx>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<dim3(p.N / p.TN, p.M / p.bm, p.S), kThreads, shmem, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.S == 1) return (int)e;
  td_reduce_kernel<T, kFused><<<dim3(p.N / p.TN, p.M / p.bm), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool kFused, bool kIdx>
int launch(int dtype, const Args& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float, kFused, kIdx>(p, s);
  if (dtype == 1) return launch_t<__nv_bfloat16, kFused, kIdx>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  `partial` is an fp32 [S, M, N] workspace
// when S > 1 (else null).  Returns the cudaError_t of the launches.
int td_spmm_planned(int dtype,
                    const void* a, long long sam, long long sak,
                    const void* b, long long sbk, long long sbn,
                    void* out, void* partial, const int* nnz, const int* row_starts,
                    const int* work_kblk, int M, int K, int N,
                    int bm, int bk, int TN, int KC, int S, int vec_a, int vec_b,
                    void* stream) {
  Args p{a, sam, sak, b, sbk, sbn, out, static_cast<float*>(partial), nnz, row_starts,
         work_kblk, nullptr, 0, M, K, N, bm, bk, TN, KC, S, vec_a, vec_b,
         nullptr, nullptr, 0, nullptr, 1};
  return launch<false, false>(dtype, p, stream);
}

int td_spmm_fused(int dtype,
                  const void* a, long long sam, long long sak,
                  const void* b, long long sbk, long long sbn,
                  void* out, void* partial, const int* nnz, const int* row_starts,
                  const int* work_kblk, int M, int K, int N,
                  int bm, int bk, int TN, int KC, int S, int vec_a, int vec_b,
                  const float* bias, const void* residual, int activation,
                  signed char* mask, int bn, void* stream) {
  Args p{a, sam, sak, b, sbk, sbn, out, static_cast<float*>(partial), nnz, row_starts,
         work_kblk, nullptr, 0, M, K, N, bm, bk, TN, KC, S, vec_a, vec_b,
         bias, residual, activation, mask, bn};
  return launch<true, false>(dtype, p, stream);
}

// The v1/v2 grid: `idx` is the plan's [Mb, Kb] table and `kdim` the K
// bound (Kb for v1, 0 for v2's max(max(nnz), 1), reduced on the card).
int td_spmm_grid_planned(int dtype,
                         const void* a, long long sam, long long sak,
                         const void* b, long long sbk, long long sbn,
                         void* out, void* partial, const int* nnz, const int* idx,
                         int kdim, int M, int K, int N,
                         int bm, int bk, int TN, int KC, int S, int vec_a, int vec_b,
                         void* stream) {
  Args p{a, sam, sak, b, sbk, sbn, out, static_cast<float*>(partial), nnz, nullptr,
         nullptr, idx, kdim, M, K, N, bm, bk, TN, KC, S, vec_a, vec_b,
         nullptr, nullptr, 0, nullptr, 1};
  return launch<false, true>(dtype, p, stream);
}

int td_spmm_grid_fused(int dtype,
                       const void* a, long long sam, long long sak,
                       const void* b, long long sbk, long long sbn,
                       void* out, void* partial, const int* nnz, const int* idx,
                       int kdim, int M, int K, int N,
                       int bm, int bk, int TN, int KC, int S, int vec_a, int vec_b,
                       const float* bias, const void* residual, int activation,
                       signed char* mask, int bn, void* stream) {
  Args p{a, sam, sak, b, sbk, sbn, out, static_cast<float*>(partial), nnz, nullptr,
         nullptr, idx, kdim, M, K, N, bm, bk, TN, KC, S, vec_a, vec_b,
         bias, residual, activation, mask, bn};
  return launch<true, true>(dtype, p, stream);
}

}  // extern "C"
