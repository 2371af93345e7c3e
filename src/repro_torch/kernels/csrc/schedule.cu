// The TensorDash scheduler over whole streams, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this schedule as one
// lax.scan over a stream's rows (src/repro/core/compress.py:52-80, the
// scheduled-form codec of paper §3.6/3.7), and the port's plain version is
// a host loop of core/scheduler.py's make_schedule_step, ~1.6 ms a row.  A
// pruned deepseek-7b w_down [11008, 4096] is one stream of 2 818 048 rows
// of 16 lanes: over an hour on the host.  This kernel walks it on the card.
//
//   z [S, T, N] 0/1 bytes  ->  sel [S, T, N] int8, advance [S, T] int8, n_cycles [S] int32
//
// per stream, exactly the JAX model's schedule: each cycle schedules the
// lookahead + 1 rows of the window starting at the stream pointer p
// (clamped at T + lookahead - depth, as dynamic_slice clamps; it never
// binds on a cycle that is emitted, since cycles run while p < T), every
// lane picking its first effectual option in priority order, lanes taken
// in the hierarchical scheduler's level order; the cycle's sel is each
// lane's option (n_options: idle) and advance the number of leading
// drained rows (AS, 1 to depth).  Rows past n_cycles are left as the
// wrapper fills them (sel = n_options, advance = 0).
//
// Bound.  The bytes are z read once and sel written once (~90 MB for the
// w_down, 0.03 ms at 3.35 TB/s), but each cycle needs the window the last
// one left: T dependent steps a stream.  That serial chain, not memory, is
// what limits it, and the design keeps each step short:
//
// * One thread a stream, 32 streams a warp, a warp a CTA.  The window's
//   rows are 32-bit words in registers (bit i = lane i; for a lane count
//   that divides 32, the default 16 among them, replicated across the word,
//   so that a rotation of the lanes is one funnel shift), and a step is
//   branch-free bit arithmetic: for each level (lanes whose option sets are
//   disjoint), for each option o in priority order, the lanes still available
//   whose option-o source (row step[o], lane i + rot[o] mod N) is set are
//   rot(window[step[o]], rot[o]) & avail; they take it, leave the available set
//   and their sources are cleared at the level's end (disjoint option sets
//   make that the same as clearing lane by lane).  Each lane's option is
//   kept as four bit planes and written as bytes with a multiply spread.
// * The connectivity tables are arguments, not constants of the source:
//   each option's row step and lane rotation, each level's lane mask, as
//   repro_torch/kernels/schedule.py derives them from core/scheduler.py.
// * Rows are staged ahead: the warp loads each live stream's next 256 rows
//   (16-byte rows as four 32-bit loads, packed to a word by a multiply) into
//   shared memory, then every thread steps its stream until its stage runs
//   out, so a step reads shared memory, not a dependent global load.
// * No host read and static output sizes, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch, as the wrapper fills it (mirrored by ScheduleArgs, a
// ctypes.Structure in _build.py: keep the two in step).
struct TdScheduleArgs {
  const uint8_t* z;    // [S, T, N], contiguous, 0 or 1
  int8_t* sel;         // [S, T, N], n_options in every entry on entry
  int8_t* advance;     // [S, T], 0 on entry
  int* n_cycles;       // [S]
  long long T;
  int S, N, depth, n_options, n_levels;
  int vec;             // 1: N % 4 == 0 and z, sel 4-byte aligned
  int opt_step[8];     // option o reads window row opt_step[o] ...
  int opt_rot[8];      // ... lane (i + opt_rot[o]) % N, for lane i
  unsigned level_mask[16];
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kStage = 256;  // rows staged a stream
constexpr int kMaxOptions = 8;
constexpr int kMaxLevels = 16;

// Rotations of an n-lane word: bit i of rot_down(x, r) is bit (i + r) % n of
// x, rot_up inverts it (r in [0, n)).  kRep: n divides 32 and every word is
// held replicated (lane i at bits i, i + n, ...), so a rotation of the n
// lanes is one 32-bit funnel shift and the result stays replicated.
template <bool kRep>
__device__ __forceinline__ uint32_t rot_down(uint32_t x, int r, int n, uint32_t full) {
  if (kRep) return __funnelshift_r(x, x, r);
  const uint64_t xx = (uint64_t)x | ((uint64_t)x << n);
  return (uint32_t)(xx >> r) & full;
}

template <bool kRep>
__device__ __forceinline__ uint32_t rot_up(uint32_t x, int r, int n, uint32_t full) {
  if (kRep) return __funnelshift_l(x, x, r);
  return rot_down<false>(x, r == 0 ? 0 : n - r, n, full);
}

// an n-lane word replicated across 32 bits (n divides 32)
__device__ __forceinline__ uint32_t replicate(uint32_t x, int n) {
  for (int sh = n; sh < 32; sh <<= 1) x |= x << sh;
  return x;
}

// one row of z as a word, bit i = lane i
__device__ __forceinline__ uint32_t load_row(const uint8_t* row, int n, int vec) {
  uint32_t w = 0;
  if (vec) {
    const uint32_t* r4 = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (4 * k < n) {
        // bytes b0..b3, each 0 or 1, to bits 24..27 (no two terms collide)
        const uint32_t v = __ldg(r4 + k) & 0x01010101u;
        w |= (((v * 0x01020408u) >> 24) & 0xfu) << (4 * k);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) w |= (uint32_t)(__ldg(row + i) != 0) << i;
  }
  return w;
}

// bits 0..3 of x to the low bit of bytes 0..3
__device__ __forceinline__ uint32_t spread4(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

// one cycle's sel row from its bit planes: lane i's option is
// q0_i + 2 q1_i + 4 q2_i + 8 q3_i
__device__ __forceinline__ void store_sel(int8_t* out, uint32_t q0, uint32_t q1, uint32_t q2,
                                          uint32_t q3, int n, int vec) {
  if (vec) {
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (4 * k < n) {
        const int sh = 4 * k;
        o4[k] = spread4((q0 >> sh) & 0xfu) | (spread4((q1 >> sh) & 0xfu) << 1) |
                (spread4((q2 >> sh) & 0xfu) << 2) | (spread4((q3 >> sh) & 0xfu) << 3);
      }
    }
  } else {
    for (int i = 0; i < n; ++i)
      out[i] = (int8_t)(((q0 >> i) & 1u) | (((q1 >> i) & 1u) << 1) | (((q2 >> i) & 1u) << 2) |
                        (((q3 >> i) & 1u) << 3));
  }
}

template <bool kRep>
__global__ void __launch_bounds__(kWarp) td_schedule_kernel(const TdScheduleArgs a) {
  __shared__ uint32_t stage[kWarp][kStage + 1];  // +1: a step's reads hit 32 banks
  __shared__ uint32_t levels[kMaxLevels];           // the level masks, as the steps use them
  const int lane = threadIdx.x;
  const long long first = (long long)blockIdx.x * kWarp;
  const long long s = first + lane;
  const long long T = a.T;
  const int n = a.N, depth = a.depth;
  const uint32_t full = (kRep || n == 32) ? kFull : ((1u << n) - 1u);
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)  // constant indices: the struct stays in parameter space
    if (lane == i) levels[i] = kRep ? replicate(a.level_mask[i], n) : a.level_mask[i];
  __syncwarp();
  long long p = 0, nxt = 0, base = 0, c = 0;  // pointer, next row to stage in, stage start, cycles
  uint32_t w0 = 0, w1 = 0, w2 = 0;            // the window's rows p .. p + depth - 1
  bool live = s < a.S, started = false;
  for (;;) {
    const unsigned want = __ballot_sync(kFull, live);
    if (!want) break;
    // stage each live stream's rows [nxt, nxt + kStage); rows >= T are zero
    base = nxt;
    for (int j = 0; j < kWarp; ++j) {
      const long long bj = __shfl_sync(kFull, base, j);
      if (!((want >> j) & 1u)) continue;
      const uint8_t* zs = a.z + (first + j) * T * n;
      for (int r = lane; r < kStage; r += kWarp) {
        const long long row = bj + r;
        const uint32_t w = row < T ? load_row(zs + row * n, n, a.vec) : 0u;
        stage[j][r] = kRep ? replicate(w, n) : w;
      }
    }
    __syncwarp();
    if (live) {
      if (!started) {
        w0 = stage[lane][0];
        w1 = stage[lane][1];
        w2 = depth > 2 ? stage[lane][2] : 0u;
        nxt = depth;
        started = true;
      }
      while (p < T && nxt + depth <= base + kStage) {
        uint32_t q0 = 0, q1 = 0, q2 = 0, q3 = 0, picked = 0;
        // one level body, looped (not unrolled): the step's code stays small
        // enough for the instruction cache
#pragma unroll 1
        for (int L = 0; L < a.n_levels; ++L) {
          uint32_t avail = levels[L];
          uint32_t c0 = 0, c1 = 0, c2 = 0;
          // every option slot runs, branch-free (a slot past n_options
          // takes nothing), so the compiler can overlap the rotations of
          // all eight: only the open-lane mask chains one to the next
#pragma unroll
          for (int o = 0; o < kMaxOptions; ++o) {
            const int st = a.opt_step[o], r = a.opt_rot[o];
            const uint32_t src = st == 0 ? w0 : st == 1 ? w1 : w2;
            const uint32_t take = rot_down<kRep>(src, r, n, full) & avail & (o < a.n_options ? kFull : 0u);
            avail &= ~take;
            picked |= take;
            if (o & 1) q0 |= take;
            if (o & 2) q1 |= take;
            if (o & 4) q2 |= take;
            const uint32_t gone = rot_up<kRep>(take, r, n, full);
            c0 |= st == 0 ? gone : 0u;
            c1 |= st == 1 ? gone : 0u;
            c2 |= st == 2 ? gone : 0u;
          }
          w0 &= ~c0;
          w1 &= ~c1;
          w2 &= ~c2;
        }
        const uint32_t idle = full & ~picked;  // sel = n_options
        if (a.n_options & 1) q0 |= idle;
        if (a.n_options & 2) q1 |= idle;
        if (a.n_options & 4) q2 |= idle;
        if (a.n_options & 8) q3 |= idle;
        int adv = 1;  // AS: the leading drained rows
        if (w0 == 0 && w1 == 0) adv = (depth > 2 && w2 == 0) ? 3 : 2;
        const long long at = s * T + c;
        store_sel(a.sel + at * n, q0, q1, q2, q3, n, a.vec);
        a.advance[at] = (int8_t)adv;
        ++c;
        p += adv;
        const int off = (int)(nxt - base);
        const uint32_t r0 = stage[lane][off], r1 = stage[lane][off + 1];
        if (depth > 2) {
          const uint32_t r2 = stage[lane][off + 2];
          if (adv == 1) { w0 = w1; w1 = w2; w2 = r0; }
          else if (adv == 2) { w0 = w2; w1 = r0; w2 = r1; }
          else { w0 = r0; w1 = r1; w2 = r2; }
        } else {
          if (adv == 1) { w0 = w1; w1 = r0; }
          else { w0 = r0; w1 = r1; }
        }
        nxt += adv;
      }
      live = p < T;
    }
    __syncwarp();
  }
  if (s < a.S) a.n_cycles[s] = (int)c;
}

}  // namespace

extern "C" {

// One launch on `stream`: one warp a 32 streams; returns its cudaError_t.
int td_schedule(const TdScheduleArgs* args, void* stream) {
  const TdScheduleArgs& a = *args;
  if (a.S <= 0 || a.T <= 0 || a.N < 1 || a.N > 32 || (a.depth != 2 && a.depth != 3) ||
      a.n_options < 1 || a.n_options > kMaxOptions || a.n_levels < 1 || a.n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  for (int o = 0; o < a.n_options; ++o)
    if (a.opt_step[o] < 0 || a.opt_step[o] >= a.depth || a.opt_rot[o] < 0 || a.opt_rot[o] >= a.N)
      return (int)cudaErrorInvalidValue;
  const long long grid = ((long long)a.S + kWarp - 1) / kWarp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (32 % a.N == 0)
    td_schedule_kernel<true><<<(unsigned)grid, kWarp, 0, s>>>(a);
  else
    td_schedule_kernel<false><<<(unsigned)grid, kWarp, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
