// One-launch block planner for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_mask.py::_kernel
// (block_zero_mask: x [M, K] -> int8 [M / bm, K / bk], 1 where the bm x bk
// block holds any nonzero) and, in the same launch, the plan compaction the
// JAX package jits around it into one dispatch per plan
// (src/repro/kernels/tensordash_spmm.py: plan_blocks_csr, plan_from_mask_csr,
// transpose_plan_csr).  One template, four modes, one launch per call, no
// memset and no second kernel:
//
//   mode 0 mask       x [M, K] fp32/bf16, any strides -> int8 mask [R, C]
//   mode 1 values     x [M, K] fp32/bf16, any strides -> the CSR plan
//   mode 2 emitted    an int8/bool mask [R, C * coarsen], any strides -> the CSR plan
//   mode 3 transpose  a forward plan (nnz [C], idx [C, R]) -> the CSR plan of its transpose
//
// where R = M / bm block rows and C = K / bk K blocks (R, C the output
// plan's).  The CSR plan is five int32 arrays, exactly the JAX package's:
// nnz [R]; idx [R, C] with row r's effectual K blocks ascending in
// idx[r, :nnz[r]] and the tail repeating the last one (a row with nnz 0 is
// all zero); row_starts [R + 1], the exclusive scan of max(nnz, 1) with the
// total last; work_row, work_kblk [R * C], item t of row r at row_starts[r]
// + t (an all-zero row keeps one item of K block 0), zero past the total.
// A block is effectual iff any element is != 0 (NaN counts, -0 does not); a
// coarse block iff any of its members is.
//
// Bound.  Reading the operand is the only real work: a block with a nonzero
// needs one element read, an all-zero block every element, and the plan is
// a few int32 per block (the LM-head weight plan, lm_head.T [102400, 4096]
// bf16 at 128 x 512: 6400 blocks, ~0.2 MB of plan).  Everything else is
// launch latency, which is what the design removes: the torch chain this
// replaces ran ~30 small kernels per plan.
//
// * Blocks (modes 0, 1): eight CTAs of 256 threads an SM (at most one per
//   block), each walking blocks blockIdx.x, + gridDim.x, ..., so a CTA's
//   fence and arrival are paid once, not once per block (the LM head has
//   6400).  Many small CTAs keep many zero blocks in flight an SM: one
//   1024-thread CTA an SM took twice as long on both dense and zero-heavy
//   operands.  A CTA reads a block along the operand's
//   unit-stride dimension (columns of a row-major operand, rows of a
//   transposed view such as lm_head.T or dlogits.T), so every warp's read
//   is coalesced.  Each warp first probes a block of its own (32 elements,
//   64 bytes of bf16), so a CTA decides eight blocks with a nonzero in one
//   round; a block the probe leaves open is read by the whole CTA, one
//   element a thread, then in 16-byte loads, four a thread per round, with
//   a CTA-wide early exit (__syncthreads_or) after every round.  The test is
//   on the bits (exponent and mantissa nonzero), so NaN is nonzero and -0
//   is zero, as x != 0.
// * Compaction in the same launch (modes 1-3): in mode 1 each CTA writes
//   its blocks' flags into idx (every entry, 0 or 1), fences, and counts
//   itself in an arrival counter; the last CTA to arrive resets the counter
//   and builds the plan.  Modes 2 and 3 have nothing to wait for and run as
//   one CTA.  The plan is built from flags staged in dynamic shared memory,
//   up to 24 KB of them (and 4096 rows) at a time, sized per launch (none
//   for mode 0) so the block CTAs keep their occupancy: mode 1 reads its
//   flags back from idx (L2), mode 2 ORs each coarse block's mask bytes, mode 3
//   scatters the forward plan's entries into the transposed flags (idx[j,
//   t] = k, t < nnz[j], sets flag (k, j)), so no plan_to_mask runs and no
//   workspace outside the CTA is written or cleared.  Then G lanes per row
//   (G the power of two at least C, at most 32; 32 / G rows a warp) count
//   each row with __ballot_sync and __popc, the CTA scans max(nnz, 1)
//   (warp shuffles, carried across stages), and a second pass over the
//   staged flags writes each effectual block's slot in idx and its queue
//   item, the ballot's lower lanes giving the slot; the tail of idx repeats
//   the highest effectual index, and the queue past the total is zeroed.
//   Every K-block count works (86 = 11008 / 128, 800).  Staging keeps
//   eight loads in flight a thread (a transpose entry's nnz and idx side by
//   side): one at a time took 7 us for the LM head's 6400.  What is left
//   is the one CTA's rows, chains of dependent steps (shared load, ballot,
//   stores): ~8 us to count and compact the LM head's 800 x 8 flags.
// * The arrival counter is slot 0 of the wrapper's counter workspace per
//   device and stream (the SpMM kernel's), zero between launches: launches
//   on one stream run one after another, and each leaves it zero.
// * No host read and static output sizes (R * C), so a CUDA graph can
//   capture it.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch, as the wrapper fills it (mirrored by PlanArgs, a
// ctypes.Structure in _build.py: keep the two in step).
struct TdPlanArgs {
  const void* x; long long s0, s1;  // modes 0-2: operand or mask, strides (rows, cols) in elements
  const int* fnnz;                  // mode 3: forward nnz [C], contiguous
  const int* fidx;                  // mode 3: forward idx [C, R], contiguous
  signed char* mask;                // mode 0: int8 [R, C]
  int* nnz;                         // [R]
  int* idx;                         // [R, C]
  int* row_starts;                  // [R + 1]
  int* work_row, *work_kblk;        // [R * C]
  int* counter;                     // mode 1: one arrival counter, zero between launches
  int mode;                         // 0 mask, 1 values, 2 emitted, 3 transpose
  int dtype;                        // modes 0-1: 0 float32, 1 bfloat16
  int R, C;                         // block rows and K blocks of the output
  int bm, bk;                       // modes 0-1: the block; mode 2: bk is coarsen
  int vec;                          // modes 0-1: 16-byte loads along the unit-stride dim
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 8;        // the block pass's grid: eight CTAs an SM
constexpr int kUnroll = 4;           // 16-byte loads in flight per thread and round
constexpr int kStageUnroll = 8;      // flag or plan loads in flight per thread while staging
constexpr int kStageFlags = 24576;   // flags staged in shared memory per pass (bytes)
constexpr int kStageRows = 4096;     // rows staged per pass

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
// rows of flags staged per pass, and the dynamic shared memory they take
// (flags, then one int per row, 16-byte aligned)
__host__ __device__ __forceinline__ int stage_rows(int R, int C) {
  return imin(imin(kStageRows, kStageFlags / C), R);
}
__host__ __device__ __forceinline__ int flag_bytes(int rows, int C) { return (rows * C + 15) / 16 * 16; }

// nonzero bits of one element (sign dropped: -0 is zero, NaN is not)
__device__ __forceinline__ bool nz_bits(uint32_t w) { return (w & 0x7fffffffu) != 0; }
__device__ __forceinline__ bool nz_bits(uint16_t w) { return (w & 0x7fffu) != 0; }
// nonzero elements in a 16-byte word
__device__ __forceinline__ bool nz_vec(uint4 v, uint32_t m) {
  return ((v.x & m) | (v.y & m) | (v.z & m) | (v.w & m)) != 0;
}

// Block blk of the operand as consecutive threads walk it: along the
// unit-stride dimension (the block's columns for a row-major operand, its
// rows for a transposed view), inner elements a line, outer lines.
template <typename U>
struct BlockView {
  const U* base;
  int inner, outer, n;
  long long so, si;  // strides between lines and along one
  __device__ BlockView(const TdPlanArgs& p, long long blk) {
    const int i = (int)blk / p.C, j = (int)blk - i * p.C;  // R * C < 2^31
    base = static_cast<const U*>(p.x) + (long long)i * p.bm * p.s0 + (long long)j * p.bk * p.s1;
    const bool cols = !(p.s1 != 1 && p.s0 == 1);
    inner = cols ? p.bk : p.bm;
    outer = cols ? p.bm : p.bk;
    so = cols ? p.s0 : p.s1;
    si = cols ? p.s1 : p.s0;
    n = inner * outer;
  }
  __device__ bool nz(int l) const {
    return l < n && nz_bits(__ldg(base + (long long)(l / inner) * so + (long long)(l % inner) * si));
  }
};

// The warp's guess at block blk: true if any of its first 32 elements (in
// the walking order) is nonzero, the same value in every lane.
template <typename U>
__device__ bool warp_probe(const TdPlanArgs& p, long long blk) {
  return __any_sync(0xffffffffu, BlockView<U>(p, blk).nz(threadIdx.x & 31));
}

// any(block != 0) for block blk of the operand, the same value in every
// thread.  U is the element's bit type: uint32_t (fp32) or uint16_t (bf16).
template <typename U>
__device__ bool block_any(const TdPlanArgs& p, long long blk) {
  const int tid = threadIdx.x;
  const BlockView<U> b(p, blk);
  const U* base = b.base;
  const int inner = b.inner, outer = b.outer, n = b.n;
  const long long so = b.so, si = b.si;
  int any = b.nz(tid);
  if (__syncthreads_or(any)) return true;
  if (p.vec) {  // the whole block in 16-byte loads (si == 1, every line and base aligned)
    constexpr int V = 16 / sizeof(U);
    constexpr uint32_t m = sizeof(U) == 4 ? 0x7fffffffu : 0x7fff7fffu;
    const int lines = inner / V, nv = outer * lines;
    for (int v0 = 0; v0 < nv; v0 += kThreads * kUnroll) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads + tid;
        w[u] = v < nv ? __ldg(reinterpret_cast<const uint4*>(base + (long long)(v / lines) * so + (v % lines) * V))
                      : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) any |= nz_vec(w[u], m);
      if (__syncthreads_or(any)) return true;
    }
  } else {  // element loads past the probe
    for (int l0 = kThreads; l0 < n; l0 += kThreads * kUnroll) {
      U w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = l0 + u * kThreads + tid;
        w[u] = l < n ? __ldg(base + (long long)(l / inner) * so + (long long)(l % inner) * si) : U(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) any |= nz_bits(w[u]);
      if (__syncthreads_or(any)) return true;
    }
  }
  return false;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Stage the flags of rows [r0, r0 + rc) into f[(r - r0) * C + j].
__device__ void stage_flags(const TdPlanArgs& p, int r0, int rc, unsigned char* f) {
  const int tid = threadIdx.x, C = p.C;
  const int n = rc * C;
  if (p.mode == 1) {  // the blocks' flags, written to idx by their CTAs
    const int* src = p.idx + (long long)r0 * C;
    for (int e0 = tid; e0 < n; e0 += kThreads * kStageUnroll) {
      int v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * kThreads;
        v[u] = e < n ? __ldcg(src + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u)
        if (e0 + u * kThreads < n) f[e0 + u * kThreads] = v[u] != 0;
    }
  } else if (p.mode == 2) {  // the emitted mask, coarse blocks ORed
    const unsigned char* mask = static_cast<const unsigned char*>(p.x);
    const int c = p.bk;
    for (int e = tid; e < n; e += kThreads) {
      const int r = r0 + e / C, j = e % C;
      const unsigned char* at = mask + (long long)r * p.s0 + (long long)j * c * p.s1;
      unsigned char any = 0;
      for (int t = 0; t < c; ++t) any |= at[(long long)t * p.s1];
      f[e] = any != 0;
    }
  } else {  // the transpose of the forward plan [C, R]: entry (j, t) sets flag (idx[j, t], j)
    for (int e = tid; e < n; e += kThreads) f[e] = 0;
    __syncthreads();
    const int R = p.R, total = C * R;  // R * C < 2^31: the wrapper checks it
    for (int e0 = tid; e0 < total; e0 += kThreads * kStageUnroll) {
      int k[kStageUnroll], j[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * kThreads;
        j[u] = e / R;
        const bool in = e < total;
        const int kk = in ? __ldg(p.fidx + e) : -1, live = in ? __ldg(p.fnnz + j[u]) : 0;
        k[u] = e - j[u] * R < live ? kk : -1;
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u)
        if (k[u] >= r0 && k[u] < r0 + rc) f[(k[u] - r0) * C + j[u]] = 1;
    }
  }
}

// Build the CSR plan from the flags, one CTA.
__device__ void compact(const TdPlanArgs& p) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, C = p.C;
  // G lanes per row: the power of two at least C, at most 32
  int G = 1;
  while (G < C && G < 32) G <<= 1;
  const int gpw = 32 / G, sub = lane % G, shift = lane / G * G;
  const unsigned gmask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  const unsigned below = (1u << sub) - 1u;
  const int rows = stage_rows(R, C);
  unsigned char* s_flag = s_dyn;
  int* s_start = reinterpret_cast<int*>(s_dyn + flag_bytes(rows, C));
  if (tid == 0) s_carry = 0;
  for (int r0 = 0; r0 < R; r0 += rows) {
    const int rc = min(rows, R - r0);
    __syncthreads();  // the previous stage is done with s_flag, s_start and s_carry
    stage_flags(p, r0, rc, s_flag);
    __syncthreads();
    // count each row: nnz, and max(nnz, 1) items into s_start
    for (int rb = warp * gpw; rb < rc; rb += kWarps * gpw) {
      const int rl = rb + lane / G;
      const bool ok = rl < rc;
      int cnt = 0;
      for (int j0 = 0; j0 < C; j0 += G) {
        const int j = j0 + sub;
        const bool f = ok && j < C && s_flag[rl * C + j];
        cnt += __popc((__ballot_sync(0xffffffffu, f) >> shift) & gmask);
      }
      if (ok && sub == 0) {
        p.nnz[r0 + rl] = cnt;
        s_start[rl] = max(cnt, 1);
      }
    }
    __syncthreads();
    // exclusive scan of the items over the stage's rows, after s_carry
    const int per = (rc + kThreads - 1) / kThreads;
    const int lo = min(tid * per, rc), hi = min(lo + per, rc);
    int sum = 0;
    for (int r = lo; r < hi; ++r) sum += s_start[r];
    const int incl = warp_inclusive_scan(sum, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? s_warp[lane] : 0;
      w = warp_inclusive_scan(w, lane);
      if (lane < kWarps) s_warp[lane] = w;
    }
    __syncthreads();
    int run = s_carry + (warp ? s_warp[warp - 1] : 0) + incl - sum;
    for (int r = lo; r < hi; ++r) {
      const int w = s_start[r];
      s_start[r] = run;
      p.row_starts[r0 + r] = run;
      run += w;
    }
    __syncthreads();
    if (tid == 0) s_carry += s_warp[kWarps - 1];
    // compact: each effectual block's slot in idx and its queue item
    for (int rb = warp * gpw; rb < rc; rb += kWarps * gpw) {
      const int rl = rb + lane / G;
      const bool ok = rl < rc;
      const int row = r0 + rl;
      int* idx = p.idx + (long long)row * C;
      const int start = ok ? s_start[rl] : 0;
      int base = 0, last = 0;
      for (int j0 = 0; j0 < C; j0 += G) {
        const int j = j0 + sub;
        const bool f = ok && j < C && s_flag[rl * C + j];
        const unsigned grp = (__ballot_sync(0xffffffffu, f) >> shift) & gmask;
        if (f) {
          const int slot = base + __popc(grp & below);
          idx[slot] = j;
          p.work_row[start + slot] = row;
          p.work_kblk[start + slot] = j;
        }
        if (grp) last = j0 + 31 - __clz(grp);
        base += __popc(grp);
      }
      if (ok) {
        for (int t = max(base, 1) + sub; t < C; t += G) idx[t] = last;  // the tail repeats the last
        if (base == 0 && sub == 0) {  // an all-zero row: idx 0, one gated item
          idx[0] = 0;
          p.work_row[start] = row;
          p.work_kblk[start] = 0;
        }
      }
    }
  }
  __syncthreads();
  const int total = s_carry;
  if (tid == 0) p.row_starts[R] = total;
  const long long flat = (long long)R * C;
  for (long long t = total + tid; t < flat; t += kThreads) {
    p.work_row[t] = 0;
    p.work_kblk[t] = 0;
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads) td_plan_kernel(const TdPlanArgs p) {
  if (p.mode >= 2) {  // one CTA: nothing to wait for
    compact(p);
    return;
  }
  // warp w of CTA c takes blocks c + (k * kWarps + w) * gridDim.x: each
  // warp probes its block, then the CTA reads whole the blocks whose probe
  // found no nonzero
  const long long blocks = (long long)p.R * p.C;
  const int warp = threadIdx.x >> 5;
  __shared__ int s_hit[kWarps];
  for (long long b0 = blockIdx.x; b0 < blocks; b0 += (long long)gridDim.x * kWarps) {
    const long long mine = b0 + (long long)warp * gridDim.x;
    const bool hit = mine < blocks && warp_probe<U>(p, mine);
    if ((threadIdx.x & 31) == 0) s_hit[warp] = hit;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      const long long blk = b0 + (long long)w * gridDim.x;
      if (blk >= blocks) break;
      const int any = s_hit[w] || block_any<U>(p, blk);
      if (threadIdx.x == 0) {
        if (p.mode == 0) p.mask[blk] = (signed char)any;
        else p.idx[blk] = any;
      }
    }
    __syncthreads();  // s_hit is rewritten next round
  }
  if (p.mode == 0) return;
  __shared__ int s_last;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(p.counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) *p.counter = 0;
  compact(p);
}

}  // namespace

extern "C" {

// One launch on `stream` of the planner in args->mode; returns its
// cudaError_t.  Modes 0-1 launch kCtasPerSm CTAs an SM (at most one per
// block), modes 2-3 one.
int td_plan(const TdPlanArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TdPlanArgs& p = *args;
  const long long blocks = (long long)p.R * p.C;
  if (p.mode < 0 || p.mode > 3 || blocks <= 0 || blocks > 0x7fffffffLL || (p.mode >= 1 && p.C > kStageFlags))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long wave = (long long)sms * kCtasPerSm;
  const long long grid = p.mode >= 2 ? 1 : blocks < wave ? blocks : wave;
  // the compaction's staging (none for the mask): at most 40 KB, under the
  // 48 KB a launch may take without an opt-in
  const int rows = p.mode == 0 ? 0 : stage_rows(p.R, p.C);
  const size_t smem = rows ? flag_bytes(rows, p.C) + sizeof(int) * rows : 0;
  if (p.mode <= 1 && p.dtype == 1) {
    td_plan_kernel<uint16_t><<<(unsigned)grid, kThreads, smem, s>>>(p);
  } else if (p.mode >= 2 || p.dtype == 0) {
    td_plan_kernel<uint32_t><<<(unsigned)grid, kThreads, smem, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
