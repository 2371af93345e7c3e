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
// The three families are bit-identical: one template, td_spmm_kernel<T,
// kFused, kIdx, MT, NT>, serves all of them.  Each CTA (column tile n,
// block row m, split s) takes steps [s * per, (s + 1) * per) of its row's
// effectual list, per = ceil(max(nnz[m], 1) / S), with the same S for every
// family (a function of the shapes, never of nnz), and walks them in
// ascending order; the S partials are summed in ascending split order.
// v2's bound never reaches the host: each CTA reduces max(nnz) over the
// plan's rows itself (a few ints at decode), so no call syncs to size a grid.
//
// Bound.  At the main path's decode shapes (4 slots, bf16, H100 SXM at
// 3.35 TB/s) each product reads its weight once and does 2 FLOP per weight
// element, far below the ~295 FLOP/byte ridge: gate [4,4096]@[4096,11008]
// and w_down [4,11008]@[11008,4096] read 90.2 MB each (>= 27 us), the LM
// head lm_head.T [102400,4096] @ [4096,4] reads 839 MB (>= 250 us).  At
// prefill (M = g * s rows, up to 128) the gate does 2 * 128 FLOP per weight
// element: 11.5 GFLOP, >= 11.7 us at 989 TFLOP/s on the tensor cores but
// >= 172 us at 67 TFLOP/s on CUDA cores, so it stays bound by its 27 us of
// bytes only if the products run on the tensor cores.  The design:
//
// * Tiles.  A CTA computes a rows x TN tile of C (TN columns, TN dividing
//   bn; rows = bm, the whole block row, up to 256, and a taller block row is
//   cut into slices of rows dividing bm, one CTA each, that share the row's
//   plan and its splits) on 8 warps.  The tile's wide side goes on the
//   MMA's row side (16-row steps) and the skinny side on its column side
//   (8-column steps, padded): for the gate and w_down (4 rows x 128 columns)
//   that is the weight's N, so the CTA computes C^T tiles (swap-AB); for
//   the LM head (lm_head.T's 128 rows x 4 columns) it is the rows.  A warp
//   holds MT x NT m16 x n8 tiles, one of three shapes built (1 x 1 at
//   decode, 1 x 4, 2 x 4; the host picks the smallest that covers the tile
//   with a power-of-two warp grid).  The padding and any row count (a prime
//   prefill bm = 29 included) are handled by zero-filled loads and
//   predicated stores.
// * Weight stream.  Both operands' K chunks (KC = 64 bf16 or 32 fp32
//   elements of one K block) go straight from global to shared memory
//   through a ring of 3-8 stages filled by 16-byte cp.async (zero-filling
//   past the tile's edge), in their own dtype: bf16 is never widened in
//   shared memory.  stages - 1 chunks are in flight while one is consumed,
//   one __syncthreads per chunk.  Each operand is staged in its global
//   orientation (its unit-stride dimension contiguous, rows padded by 16
//   bytes against bank conflicts), so the row-major weights and the
//   strided lm_head.T view both stream without a copy.  Shared memory is
//   sized against the 227 KB a block may use (cudaFuncSetAttribute); the
//   host keeps the ring near 72 KB, three CTAs to an SM, because more
//   resident CTAs moved more bytes on the card than deeper rings did.
//   Operands whose strides or base are off the 16-byte grid are staged by
//   plain loads into the same ring.
// * Tensor cores.  bf16 runs mma.sync.m16n8k16 (bf16 in, fp32 accumulate)
//   on fragments read with ldmatrix (.trans for an operand staged along its
//   own dimension), the next k16 step's fragments loaded while this step's
//   MMAs issue.  fp32 runs CUDA-core FMA (no TF32: the fp32 tolerance of
//   2e-4 forbids it) with the same fragment ownership, ring and epilogue.
// * One launch.  With S > 1 each split writes its fp32 partial (in
//   fragment order, so every thread reads back only what it owns), fences,
//   and counts itself in a per-tile arrival counter; the last CTA to arrive
//   sums the S partials in ascending split order, applies the epilogue,
//   stores, and resets the counter.  The counters live in a workspace per
//   device and stream that the wrapper allocates once.  At decode the splits are what
//   fill the 132 SMs (one block row, 86 gate or 32 w_down column tiles): S
//   is as many shares as one wave of three CTAs per SM holds, evened out so
//   no share of a dense row is empty, and capped so the partials stay below
//   1/8 of the bytes a tile streams.
// * Mask.  The CTA reduces any(out != 0) over its tile with
//   __syncthreads_or.  A tile that spans its mask block (TN == bn, one
//   slice) writes the byte, 0 or 1; otherwise the (bn / TN) x slices tiles
//   of the block count themselves and their nonzero flags in one counter,
//   and the last writes the byte and resets it.  The wrapper zero-fills nothing.
// * What still holds it back.  At decode the CTAs stream at well under the
//   card's rate each and the 344 gate CTAs fall unevenly on 132 SMs (two or
//   three each); at prefill the mma.sync loop from a three-stage ring is
//   latency-bound and the activation tile is re-read from L2 for every
//   64-column tile.  A persistent grid (even shares per SM) and a TMA +
//   wgmma main loop with warp specialisation are the next steps.
//
// The epilogue uses __fadd_rn/__fmul_rn so nvcc cannot contract
// square-then-add into one FMA: the plain executor rounds twice.
//
// Output type (out_type).  C is stored in the operands' type (0); for fp32
// operands in bf16 (1): the training backward runs both gradient products
// on fp32 operands and writes them in a bf16 model's dtype, the fp32
// accumulator (after the split-K sum and the epilogue, the mask taken on the
// fp32 value) rounded once to nearest even, as the plain executor's cast
// does, in the same launch; for bf16 operands in fp32 (2): the accumulator
// itself, as the K-sharded product's partials need it (each shard's fp32
// partial meets the others' in an fp32 sum before any rounding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

// The launch, as the wrapper fills it (mirrored by SpmmArgs, a
// ctypes.Structure in _build.py: keep the two in step).  At file scope, so
// the extern "C" entry point that takes it keeps external linkage.
struct TdSpmmArgs {
  const void* a; long long sam, sak;  // A [M, K] with strides (rows, cols)
  const void* b; long long sbk, sbn;  // B [K, N] with strides (rows, cols)
  void* out;                          // C [M, N], contiguous, in T or the out_type's type
  float* partial;                     // split partials (S > 1) or null
  int* counters;                      // [tiles] split arrivals, [Mb * N / bn] mask arrivals
  const int* nnz;                     // [Mb]
  const int* row_starts;              // [Mb + 1]      (ragged)
  const int* work_kblk;               // [Mb * Kb]     (ragged)
  const int* idx;                     // [Mb, Kb]      (v1/v2)
  const float* bias;                  // [N] fp32 or null   (fused)
  const void* residual;               // [M, N] contiguous, A's dtype, or null
  signed char* mask;                  // [Mb, N / bn] int8  (fused)
  int kdim;                           // v1/v2 K bound; 0: max(max(nnz), 1) (v2)
  int M, K, N, bm, bk, bn;
  int rows;                           // rows of a CTA's tile: bm, or a divisor of a taller bm
  int TN, KC, S, stages;
  int swap;                           // MMA rows run along C's columns (C^T tiles)
  int wp, wq, mt, nt;                 // warps along MMA rows / columns; m16 / n8 tiles a warp
  int a_kmaj, a_vec, b_kmaj, b_vec;   // staged K-contiguous; 16-byte cp.async
  int activation;                     // 0 none, 1 relu, 2 squared_relu
  int out_type;                       // 0: C in T; 1: bf16 (fp32 T only); 2: fp32 (bf16 T only)
};

namespace {

using Args = TdSpmmArgs;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinStages = 3, kMaxStages = 8;  // ring depth
constexpr size_t kMaxSmem = 232448;  // the 227 KB a block may use on Hopper

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One operand tile as it is staged: `ex` valid rows along its own dimension
// (padded to `xpad`) from `x0`, KC along K.  K-major tiles are [xpad][pitch]
// with K contiguous, the others [KC][pitch] with x contiguous.
struct Operand {
  const void* ptr;
  long long sx, sk;
  int x0, ex, xpad, kmaj, vec, pitch;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most n groups are pending (n clamped to the immediates used)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Elements of one staged tile in either orientation (the larger of the two,
// so the stage layout does not depend on the operands' strides).
__host__ __device__ __forceinline__ long long tile_elems(int xpad, int kc, int v) {
  return (long long)xpad * kc + (long long)v * (xpad > kc ? xpad : kc);
}
__host__ __device__ __forceinline__ long long align128(long long bytes) { return (bytes + 127) & ~127LL; }

// Stage the K chunk [kbase, kbase + kcv) of one operand tile, zeros past
// the tile's valid rows and past kcv, up to KC.  With 16-byte copies each
// thread keeps one 16-byte column of the tile (a K offset of a K-major tile,
// a row offset of the other) and walks the rows tid / per, + step, ... of
// the other axis: the extents are powers of two, so the walk needs no
// division per copy.  Plain loads stage the operands off the 16-byte grid.
template <typename T>
__device__ __forceinline__ void load_tile(const Operand& o, T* dst, int KC, long long kbase, int kcv) {
  constexpr int V = 16 / sizeof(T);
  const T* base = static_cast<const T*>(o.ptr);
  const int tid = threadIdx.x;
  if (o.vec) {
    const int per = (o.kmaj ? KC : o.xpad) / V, step = kThreads / per;
    const int col = (tid & (per - 1)) * V, lim = o.kmaj ? o.xpad : KC;
    const bool col_ok = col < (o.kmaj ? kcv : o.ex);
    const int rmax = o.kmaj ? o.ex : kcv;
    const long long rstride = o.kmaj ? o.sx : o.sk;  // source elements from one row to the next
    int r = tid >> (__ffs(per) - 1);
    const T* src = (o.kmaj ? base + (long long)o.x0 * o.sx + kbase : base + o.x0 + kbase * o.sk) + col +
                   r * rstride;
    uint32_t sdst = smem_u32(dst + r * o.pitch + col);
    const uint32_t sstep = step * o.pitch * sizeof(T);
    for (; r < lim; r += step, src += step * rstride, sdst += sstep) {
      const bool ok = col_ok && r < rmax;
      cp_async16(sdst, ok ? src : base, ok ? 16 : 0);  // a zero fill still needs a valid address
    }
    return;
  }
  for (int it = tid; it < o.xpad * KC; it += kThreads) {
    const int x = o.kmaj ? it / KC : it % o.xpad, k = o.kmaj ? it % KC : it / o.xpad;
    const bool ok = x < o.ex && k < kcv;
    dst[o.kmaj ? x * o.pitch + k : k * o.pitch + x] =
        ok ? base[(long long)(o.x0 + x) * o.sx + (kbase + k) * o.sk] : from_f32<T>(0.f);
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

// One warp's fragments of one k16 step: MT m16 x k16 tiles of P, NT
// k16 x n8 tiles of Q.  pk / qk: the operand is staged K-contiguous (plain
// ldmatrix) or along its own dimension (ldmatrix.trans); lp / lq: pitches.
template <int MT, int NT>
struct Frags {
  uint32_t a[MT][4];
  uint32_t b[NT][2];
};

template <int MT, int NT>
__device__ __forceinline__ void load_frags(Frags<MT, NT>& f, uint32_t uP, uint32_t uQ, bool pk, int lp,
                                           bool qk, int lq, int pw, int qw, int lane, int k0) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p0 = pw + i * 16;
    if (pk)
      ldsm_x4(f.a[i], uP + 2 * ((p0 + (lane & 15)) * lp + k0 + ((lane >> 4) << 3)));
    else
      ldsm_x4_t(f.a[i], uP + 2 * ((k0 + (lane & 7) + ((lane >> 4) << 3)) * lp + p0 + (((lane >> 3) & 1) << 3)));
  }
  if constexpr (NT == 1) {
    if (qk)
      ldsm_x2(f.b[0], uQ + 2 * ((qw + (lane & 7)) * lq + k0 + (((lane >> 3) & 1) << 3)));
    else
      ldsm_x2_t(f.b[0], uQ + 2 * ((k0 + (lane & 15)) * lq + qw));
  } else {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {  // two n8 tiles a load
      const int q0 = qw + j * 8;
      uint32_t r[4];
      if (qk)
        ldsm_x4(r, uQ + 2 * ((q0 + (lane & 7) + ((lane >> 4) << 3)) * lq + k0 + (((lane >> 3) & 1) << 3)));
      else
        ldsm_x4_t(r, uQ + 2 * ((k0 + (lane & 15)) * lq + q0 + ((lane >> 4) << 3)));
      f.b[j][0] = r[0];
      f.b[j][1] = r[1];
      f.b[j + 1][0] = r[2];
      f.b[j + 1][1] = r[3];
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_frags(float (&acc)[MT][NT][4], const Frags<MT, NT>& f) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], f.a[i], f.b[j]);
}

// One ring stage on the tensor cores: k16 steps over [0, kcv), the next
// step's fragments loaded while this step's MMAs issue.
template <int MT, int NT>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4], uint32_t uP, uint32_t uQ, bool pk, int lp,
                                          bool qk, int lq, int pw, int qw, int lane, int kcv) {
  Frags<MT, NT> f0, f1;
  load_frags(f0, uP, uQ, pk, lp, qk, lq, pw, qw, lane, 0);
  for (int k0 = 0; k0 < kcv; k0 += 32) {
    const bool two = k0 + 16 < kcv;
    if (two) load_frags(f1, uP, uQ, pk, lp, qk, lq, pw, qw, lane, k0 + 16);
    mma_frags(acc, f0);
    if (k0 + 32 < kcv) load_frags(f0, uP, uQ, pk, lp, qk, lq, pw, qw, lane, k0 + 32);
    if (two) mma_frags(acc, f1);
  }
}

// One ring stage on CUDA cores (fp32, no TF32), with the MMA's fragment
// ownership: lane (g, c4) holds rows g and g + 8 of each m16 tile, columns
// 2 c4 and 2 c4 + 1 of each n8 tile, summed in K order.
template <typename T, int MT, int NT>
__device__ __forceinline__ void fma_stage(float (&acc)[MT][NT][4], const T* sP, const T* sQ, bool pk, int lp,
                                          bool qk, int lq, int pw, int qw, int lane, int kcv) {
  const int g = lane >> 2, c4 = lane & 3;
  const int pp = pk ? lp : 1, pkk = pk ? 1 : lp, qq = qk ? lq : 1, qkk = qk ? 1 : lq;
  for (int kk = 0; kk < kcv; ++kk) {
    float av[MT][2], bv[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = pw + i * 16 + g;
      av[i][0] = to_f32(sP[r * pp + kk * pkk]);
      av[i][1] = to_f32(sP[(r + 8) * pp + kk * pkk]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int q = qw + j * 8 + 2 * c4;
      bv[j][0] = to_f32(sQ[q * qq + kk * qkk]);
      bv[j][1] = to_f32(sQ[(q + 1) * qq + kk * qkk]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[i][j][0] = fmaf(av[i][0], bv[j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(av[i][0], bv[j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(av[i][1], bv[j][0], acc[i][j][2]);
        acc[i][j][3] = fmaf(av[i][1], bv[j][1], acc[i][j][3]);
      }
  }
}

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
  if (sizeof(T) == 4 && p.out_type == 1)  // one round-to-nearest-even of the fp32 value
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
  else if (sizeof(T) == 2 && p.out_type == 2)  // the fp32 accumulator, unrounded
    static_cast<float*>(p.out)[o] = v;
  else
    static_cast<T*>(p.out)[o] = from_f32<T>(v);
  return nz;
}

// kIdx: false walks the ragged work queue, true the v1/v2 grid over idx.
// MT x NT: the m16 x n8 MMA tiles a warp holds (the launch's mt x nt).
// Resident CTAs per SM the registers must allow (the host's split rule,
// resident_ctas in tensordash_spmm.py, counts on them): 3 for the bf16
// decode warp tile, 2 for the others.
template <typename T, int MT, int NT>
constexpr int kMinBlocks = MT * NT == 1 && sizeof(T) == 2 ? 3 : 2;

template <typename T, bool kFused, bool kIdx, int MT, int NT>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, MT, NT>))
td_spmm_kernel(Args p) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = blockIdx.y, split = blockIdx.z;
  // blockIdx.x runs over the column tiles, each over the block row's slices
  const int slices = p.bm / p.rows, slice = blockIdx.x % slices;
  const int n0 = (blockIdx.x / slices) * p.TN, row0 = m * p.bm + slice * p.rows;

  // the MMA's row side P and column side Q
  const int p_pad = p.wp * 16 * MT, q_pad = p.wq * 8 * NT;
  Operand A{p.a, p.sam, p.sak, row0, p.rows, 0, p.a_kmaj, p.a_vec, 0};
  Operand B{p.b, p.sbn, p.sbk, n0, p.TN, 0, p.b_kmaj, p.b_vec, 0};
  Operand P = p.swap ? B : A, Q = p.swap ? A : B;
  P.xpad = p_pad;
  Q.xpad = q_pad;
  P.pitch = P.kmaj ? p.KC + V : p_pad + V;
  Q.pitch = Q.kmaj ? p.KC + V : q_pad + V;
  const long long p_bytes = align128(tile_elems(p_pad, p.KC, V) * (long long)sizeof(T));
  const long long stage_bytes = p_bytes + align128(tile_elems(q_pad, p.KC, V) * (long long)sizeof(T));

  // this warp's fragment: rows [pw, pw + 16 MT) of P, columns [qw, qw + 8 NT) of Q
  const bool active = warp < p.wp * p.wq;
  const int pw = (warp % p.wp) * 16 * MT, qw = (warp / p.wp) * 8 * NT;
  const int g = lane >> 2, c4 = lane & 3;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // this split's contiguous share of the row's effectual list: queue items
  // t0 + j (ragged) or grid steps j < kdim with j < nnz[m] (v1/v2)
  const int kdim = kIdx ? grid_kdim(p) : 0;
  int j_beg = 0, j_end = 0;
  const int* kblk = nullptr;
  if (p.nnz[m] > 0) {
    const int t0 = kIdx ? 0 : p.row_starts[m];
    const int cnt = kIdx ? p.nnz[m] : p.row_starts[m + 1] - t0;
    const int per = (cnt + p.S - 1) / p.S;
    j_beg = min(cnt, split * per);
    j_end = min(cnt, (split + 1) * per);
    if (kIdx) j_end = min(j_end, kdim);
    kblk = kIdx ? p.idx + (long long)m * (p.K / p.bk) : p.work_kblk + t0;
  }
  const int nchunk = (p.bk + p.KC - 1) / p.KC;
  const int steps = max(j_end - j_beg, 0) * nchunk;
  int ij = 0, ic = 0;  // the next step to stage: block j_beg + ij, chunk ic
  auto issue = [&](int t) {
    const long long kbase = (long long)__ldg(kblk + j_beg + ij) * p.bk + (long long)ic * p.KC;
    const int kcv = min(p.KC, p.bk - ic * p.KC);
    unsigned char* st = smem + (t % p.stages) * stage_bytes;
    load_tile<T>(P, reinterpret_cast<T*>(st), p.KC, kbase, kcv);
    load_tile<T>(Q, reinterpret_cast<T*>(st + p_bytes), p.KC, kbase, kcv);
    if (++ic == nchunk) ic = 0, ++ij;
  };

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  int c = 0;  // the chunk of the step being consumed
  for (int t = 0; t < steps; ++t) {
    cp_async_wait(p.stages - 2);  // step t has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and step t - 1's slot is free
    if (t + p.stages - 1 < steps) issue(t + p.stages - 1);
    cp_async_commit();
    const int kcv = min(p.KC, p.bk - c * p.KC);
    if (++c == nchunk) c = 0;
    if (!active) continue;
    const unsigned char* st = smem + (t % p.stages) * stage_bytes;
    const T* sP = reinterpret_cast<const T*>(st);
    const T* sQ = reinterpret_cast<const T*>(st + p_bytes);
    if constexpr (kMma)
      mma_stage<MT, NT>(acc, smem_u32(sP), smem_u32(sQ), P.kmaj, P.pitch, Q.kmaj, Q.pitch, pw, qw, lane, kcv);
    else
      fma_stage<T, MT, NT>(acc, sP, sQ, P.kmaj, P.pitch, Q.kmaj, Q.pitch, pw, qw, lane, kcv);
  }
  cp_async_wait(0);

  // split-K: publish this split's partial; the last CTA of the tile to
  // arrive sums all S of them in ascending split order
  if (p.S > 1) {
    float4* part = reinterpret_cast<float4*>(p.partial);
    const long long tile = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    constexpr int frags = MT * NT;
    const long long mine = (tile * p.S + split) * frags * kThreads + tid;
    if (active) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          part[mine + (i * NT + j) * kThreads] =
              make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&p.counters[tile], 1) == p.S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (active) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          for (int s = 0; s < p.S; ++s) {
            const long long at = (tile * p.S + s) * frags * kThreads + tid + (i * NT + j) * kThreads;
            const float4 x = s == split ? make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3])
                                        : __ldcg(part + at);
            v[0] = __fadd_rn(v[0], x.x);
            v[1] = __fadd_rn(v[1], x.y);
            v[2] = __fadd_rn(v[2], x.z);
            v[3] = __fadd_rn(v[3], x.w);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = v[r];
        }
    }
    if (tid == 0) p.counters[tile] = 0;
  }

  // epilogue and store of the valid elements this thread owns
  const int ep = p.swap ? p.TN : p.rows, eq = p.swap ? p.rows : p.TN;
  int any_nz = 0;
  if (active) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pl = pw + i * 16 + g + ((r >> 1) << 3), ql = qw + j * 8 + 2 * c4 + (r & 1);
          if (pl < ep && ql < eq) {
            const int ml = p.swap ? ql : pl, nl = p.swap ? pl : ql;
            const long long o = (long long)(row0 + ml) * p.N + n0 + nl;
            any_nz |= finish<T, kFused>(p, o, n0 + nl, acc[i][j][r]);
          }
        }
  }
  if (kFused) {
    const int blk_any = __syncthreads_or(any_nz);
    if (tid == 0) {
      const long long mi = (long long)m * (p.N / p.bn) + n0 / p.bn;
      const int per_block = p.bn / p.TN * (p.bm / p.rows);
      if (per_block == 1) {
        p.mask[mi] = blk_any ? 1 : 0;
      } else {
        int* mc = p.counters + (long long)gridDim.x * gridDim.y + mi;
        const int add = 1 + (blk_any ? 0x10000 : 0);
        const int old = atomicAdd(mc, add);
        if ((old & 0xffff) == per_block - 1) {
          p.mask[mi] = ((old + add) >> 16) ? 1 : 0;
          *mc = 0;
        }
      }
    }
  }
}

template <typename T, bool kFused, bool kIdx, int MT, int NT>
int launch_k(const Args& p, size_t smem, cudaStream_t s) {
  auto k = td_spmm_kernel<T, kFused, kIdx, MT, NT>;
  static size_t granted[64] = {};  // dynamic shared memory allowed so far, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = smem;
  }
  k<<<dim3(p.N / p.TN * (p.bm / p.rows), p.M / p.bm, p.S), kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool kFused, bool kIdx>
int launch_t(const Args& p, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int p_pad = p.wp * 16 * p.mt, q_pad = p.wq * 8 * p.nt;
  const int ep = p.swap ? p.TN : p.rows, eq = p.swap ? p.rows : p.TN;
  auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  // a built warp tile, and power-of-two extents: each loader thread keeps
  // one 16-byte column
  const bool built = (p.mt == 1 && (p.nt == 1 || p.nt == 4)) || (p.mt == 2 && p.nt == 4);
  if (!built || !pow2(p.wp) || !pow2(p.wq) || p.wp * p.wq > kWarps || p_pad < ep || q_pad < eq ||
      !pow2(p.KC) || p.KC < 16 || p.KC > 128 || p.stages < kMinStages || p.stages > kMaxStages ||
      p.rows < 1 || p.bm % p.rows || p.S < 1 || p.S > 65535 || p.TN < 1 || p.bn % p.TN ||
      (long long)(p.bn / p.TN) * (p.bm / p.rows) >= 0x8000 ||
      p.M / p.bm > 65535 || (p.S > 1 && (!p.partial || !p.counters)) ||
      (p.out_type != 0 && p.out_type != (sizeof(T) == 4 ? 1 : 2)))
    return (int)cudaErrorInvalidValue;
  const size_t stage = (size_t)(align128(tile_elems(p_pad, p.KC, V) * (long long)sizeof(T)) +
                                align128(tile_elems(q_pad, p.KC, V) * (long long)sizeof(T)));
  const size_t smem = stage * p.stages;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // three warp tiles: the decode tile (one m16 x n8), 16 x 32, 32 x 32
  if (p.nt == 1) return launch_k<T, kFused, kIdx, 1, 1>(p, smem, s);
  if (p.mt == 1) return launch_k<T, kFused, kIdx, 1, 4>(p, smem, s);
  return launch_k<T, kFused, kIdx, 2, 4>(p, smem, s);
}

template <bool kFused, bool kIdx>
int launch(int dtype, const Args& p, cudaStream_t s) {
  if (dtype == 0) return launch_t<float, kFused, kIdx>(p, s);
  if (dtype == 1) return launch_t<__nv_bfloat16, kFused, kIdx>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  fused: the epilogue and mask.  grid: 0
// the ragged work queue (row_starts, work_kblk), 1 the v1/v2 grid over idx
// with K bound kdim (Kb for v1, 0 for v2's max(max(nnz), 1), reduced on the
// card).  One launch on `stream`; returns its cudaError_t.
int td_spmm(int dtype, int fused, int grid, const TdSpmmArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused)
    return grid ? launch<true, true>(dtype, *args, s) : launch<true, false>(dtype, *args, s);
  return grid ? launch<false, true>(dtype, *args, s) : launch<false, false>(dtype, *args, s);
}

}  // extern "C"
