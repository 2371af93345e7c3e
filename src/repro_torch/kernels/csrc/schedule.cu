// The TensorDash scheduler over whole streams and over lockstep tiles, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package runs the scheduler as
// lax.scans: the scheduled-form codec's schedule of a stream
// (src/repro/core/compress.py:52-80, paper §3.6/3.7), and the paper's cycle
// model, one PE's stream (src/repro/core/pe.py:63-89) and R rows of a tile
// in lockstep (pe.py:92-121, vmapped over groups at core/perf_model.py:158).
// The port's plain versions are host loops of core/scheduler.py's
// make_schedule_step (kernels/schedule.py).
//
// Stream mode, td_schedule:
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
// Tile mode, td_tile: G tiles, tile g R rows of t[g] rows of N lanes at
// z + offset[g]  ->  cycles [G] int32.  Each row schedules its own window,
// the tile advances by the minimum advance over its rows, and every row
// shifts its window by that minimum (rows that could drain further keep
// their cleared bits); cycles count until the pointer passes t[g].  One
// launch takes a ragged batch (each tile its own t and offset), so the
// perf model's convolutions go in one launch.  At R <= 32 a warp walks one
// tile or a few on rows staged in shared memory; at R > 32 a CTA walks a
// tile over its warps.  A tile is one chain: the cycle model's tiles are
// short (at most 688 rows), and splitting them as a stream is split (below)
// lost on the card, because their dense tiles' heads are seldom met.
//
// Bound.  The bytes are z read once and sel written once, but each cycle
// needs the window the last one left: a stream (or a tile) is a chain of
// dependent cycles, and within a cycle each level's picks need the bits
// the levels before it took.  That chain limits both modes.  The design:
//
// * A cycle is branch-free bit arithmetic on 32-bit words, one a window
//   row (bit i = lane i; for a lane count that divides 32 replicated across
//   the word, so that a rotation of the lanes is one funnel shift): for
//   each level (lanes whose option sets are disjoint), for each option o in
//   priority order, the lanes still open whose option-o source (row
//   step[o], lane i + rot[o] mod N) is set take it; the taken sources are
//   cleared at the level's end (disjoint option sets make that the same as
//   clearing lane by lane).  Each lane's option is kept as four bit planes.
// * A cycle is a chain of dependent instructions issued in order by one
//   thread, so its cost is its instruction count.  The connectivity tables
//   the port uses (16 lanes, lookahead 2 and 1) are compiled in (Tab16x3,
//   Tab16x2): levels and options unroll into constant rotations and masks,
//   row 0 (drained by every lane's own dense option) is never cleared, a
//   row of 0/1 bytes becomes a word by four multiplies, and a cycle stores
//   its four bit planes and its advance into its sel row in one 16-byte
//   store, which a second pass (td_expand_kernel, a thread a row) turns into
//   the 16 option bytes and the advance byte.  The host functions take that
//   path when the launch's tables equal them and rows are 16-byte aligned;
//   any other table (lane counts up to 32) runs the same arithmetic on
//   tables read from the launch, the level loop kept rolled, and stores
//   bytes.
// * Stream rows come from a ring in shared memory (16-lane rows): each thread's
//   next rows are copied in by cp.async at least eight cycles before it
//   reads them, so a cycle never waits on device memory (a 16-byte load of
//   a row when the cycle needs it waits a round trip at most cycles: the L1
//   fills 32-byte sectors, two rows).  Other lane counts load a row when
//   the cycle needs it.
// * One long stream is split (td_schedule with n_segs > 0).  A stream's
//   future from the start of a cycle depends only on the pointer p and the
//   window's words: two runs in the same state at the same p go on
//   identically (a fresh window, none of its bits taken yet, is the state
//   of a run that starts at p).  So the stream is cut into n_segs segments
//   of seg_rows rows, one thread each, in four launches:
//     1. head: segment k starts fresh at its first row b_k and records its
//        state at every row of [b_k, b_k + overlap) it visits (its head);
//     2. main: segment k runs on from there, past its end, until its state
//        at some row equals a later segment j's head record there; from
//        that row j's run is the true one.  A segment that meets no head
//        record walks on to the end of the stream (the sequential walk);
//     3. stitch (a CTA a stream): from segment 0, follow the matches; each
//        segment on that chain owns the cycles from the row it was entered
//        at to the row it hands over at, and a running sum of those counts
//        gives its output offset and n_cycles;
//     4. replay: each segment on the chain runs again from its entry state
//        (its head record there) and writes sel and advance at its offset.
//   Segment 0 starts at the stream's start, so the chain is true from its
//   first cycle, and every hand-over is to a run in the same state: the
//   schedule is bit for bit the one-thread walk's.
// * No host read and static output sizes, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

// The launches, as the wrapper fills them (mirrored by ScheduleArgs and
// TileArgs, ctypes.Structures in _build.py: keep them in step).
struct TdScheduleArgs {
  const uint8_t* z;    // [S, T, N], contiguous, 0 or 1
  int8_t* sel;         // [S, T, N], n_options in every entry on entry
  int8_t* advance;     // [S, T], 0 on entry
  int* n_cycles;       // [S]
  void* work;          // the split's workspace, split_bytes(S * n_segs, overlap) bytes
  long long T;
  int S, N, depth, n_options, n_levels;
  int vec;             // 1: N % 4 == 0 and z, sel 4-byte aligned
  int n_segs, seg_rows, overlap;  // the split (n_segs 0: one thread a stream)
  int opt_step[8];     // option o reads window row opt_step[o] ...
  int opt_rot[8];      // ... lane (i + opt_rot[o]) % N, for lane i
  unsigned level_mask[16];
};

struct TdTileArgs {
  const uint8_t* z;          // tile g's rows [R, t[g], N] at z + offset[g], 0 or 1; z 16-byte aligned
  const long long* offset;   // [G] bytes, multiples of 16
  const int* t;              // [G] rows a PE row's stream
  int* cycles;               // [G]
  int G, R, N, depth, n_options, n_levels;
  int pack;         // R <= 32: tiles a warp (a CTA), 1 to 32 / R
  int stage_words;  // R <= 32: shared words a tile's rows may take (R * (t[g] | 1) of them), 0: none staged
  int opt_step[8];
  int opt_rot[8];
  unsigned level_mask[16];
};

// The compiled-in tables: core/scheduler.py's connectivity and levels at 16
// lanes (kernels/schedule.py's schedule_tables; a CPU test holds them equal).
#define TD_STEP_16X3 0, 1, 2, 1, 1, 2, 2, 1
#define TD_ROT_16X3 0, 0, 0, 15, 1, 14, 2, 13
#define TD_STEP_16X2 0, 1, 1, 1, 1
#define TD_ROT_16X2 0, 0, 15, 1, 13
#define TD_LEVELS_16 0x421u, 0x842u, 0x1084u, 0x2108u, 0x4210u, 0x8000u

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxOptions = 8;
constexpr int kMaxLevels = 16;
constexpr int kStreamBlock = 32;   // threads a CTA of the stream launches
constexpr int kTileSmem = 227 * 1024;  // shared bytes a CTA of the tile launch may ask for
constexpr int kStitchBlock = 256;
constexpr int kMaxSegs = 2048;     // segments a stream (the stitch holds their ends in shared memory)
constexpr int kMaxRows = 1024;     // rows a tile (a CTA)
constexpr long long kMaxT = 0x7ffffff0LL;  // rows a stream: a row index past the end still fits an int

// Rotations of an n-lane word: bit i of rot_down(x, r) is bit (i + r) % n of
// x, rot_up inverts it (r in [0, n)).  kRep: n divides 32 and every word is
// held replicated (lane i at bits i, i + n, ...), so a rotation of the n
// lanes is one 32-bit funnel shift and the result stays replicated.
template <bool kRep>
__device__ __forceinline__ uint32_t rot_down(uint32_t x, int r, int n, uint32_t full) {
  if (r == 0) return x;
  if (kRep) return __funnelshift_r(x, x, r);
  const uint64_t xx = (uint64_t)x | ((uint64_t)x << n);
  return (uint32_t)(xx >> r) & full;
}

template <bool kRep>
__device__ __forceinline__ uint32_t rot_up(uint32_t x, int r, int n, uint32_t full) {
  if (r == 0) return x;
  if (kRep) return __funnelshift_l(x, x, r);
  return rot_down<false>(x, n - r, n, full);
}

// an n-lane word replicated across 32 bits (n divides 32)
__device__ __forceinline__ uint32_t replicate(uint32_t x, int n) {
  for (int sh = n; sh < 32; sh <<= 1) x |= x << sh;
  return x;
}

// bytes b0..b3 of v, each 0 or 1, to bits 0..3 (no two product terms collide)
__device__ __forceinline__ uint32_t gather4(uint32_t v) {
  return (((v & 0x01010101u) * 0x01020408u) >> 24) & 0xfu;
}

// one row of z as a word, bit i = lane i
__device__ __forceinline__ uint32_t load_row(const uint8_t* row, int n, int vec) {
  uint32_t w = 0;
  if (vec) {
    const uint32_t* r4 = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (4 * k < n) w |= gather4(__ldg(r4 + k)) << (4 * k);
  } else {
    for (int i = 0; i < n; ++i) w |= (uint32_t)(__ldg(row + i) != 0) << i;
  }
  return w;
}

// a 16-lane row's 16 bytes (each 0 or 1, so no mask) as a word: a
// multiply and a shift gather four bytes, and the nibbles do not overlap
__device__ __forceinline__ uint32_t word16(const uint4 v) {
  const uint32_t k = 0x01020408u;
  return ((v.x * k) >> 24) + (((v.y * k) >> 24) << 4) + (((v.z * k) >> 24) << 8) + (((v.w * k) >> 24) << 12);
}

// a 16-lane row, 16-byte aligned: one load
__device__ __forceinline__ uint32_t load_row16(const uint8_t* row) {
  return word16(__ldg(reinterpret_cast<const uint4*>(row)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending)); }

// bits 0..3 of x to the low bit of bytes 0..3
__device__ __forceinline__ uint32_t spread4(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

// four lanes' options from their bit planes, lanes sh .. sh + 3
__device__ __forceinline__ uint32_t sel_word(uint32_t q0, uint32_t q1, uint32_t q2, uint32_t q3, int sh) {
  return spread4((q0 >> sh) & 0xfu) | (spread4((q1 >> sh) & 0xfu) << 1) |
         (spread4((q2 >> sh) & 0xfu) << 2) | (spread4((q3 >> sh) & 0xfu) << 3);
}

// one cycle's sel row from its bit planes: lane i's option is
// q0_i + 2 q1_i + 4 q2_i + 8 q3_i
__device__ __forceinline__ void store_sel(int8_t* out, uint32_t q0, uint32_t q1, uint32_t q2,
                                          uint32_t q3, int n, int vec) {
  if (vec) {
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (4 * k < n) o4[k] = sel_word(q0, q1, q2, q3, 4 * k);
  } else {
    for (int i = 0; i < n; ++i)
      out[i] = (int8_t)(((q0 >> i) & 1u) | (((q1 >> i) & 1u) << 1) | (((q2 >> i) & 1u) << 2) |
                        (((q3 >> i) & 1u) << 3));
  }
}

__device__ __forceinline__ void store_sel16(int8_t* out, uint32_t q0, uint32_t q1, uint32_t q2, uint32_t q3) {
  uint4 v;
  v.x = sel_word(q0, q1, q2, q3, 0);
  v.y = sel_word(q0, q1, q2, q3, 4);
  v.z = sel_word(q0, q1, q2, q3, 8);
  v.w = sel_word(q0, q1, q2, q3, 12);
  *reinterpret_cast<uint4*>(out) = v;
}

// ---------------------------------------------------------------------------
// the tables: compiled in, or read from the launch

template <int kDepth>
struct Tab16 {  // 16 lanes, lookahead kDepth - 1, replicated words
  static constexpr bool kFixed = true;
  static constexpr int kOptions = kDepth == 3 ? 8 : 5;
  static constexpr int kLevels = 6;
  __device__ __forceinline__ int n() const { return 16; }
  __device__ __forceinline__ int depth() const { return kDepth; }
  __device__ __forceinline__ int n_options() const { return kOptions; }
  __device__ __forceinline__ uint32_t full() const { return kFull; }
  __device__ __forceinline__ int step(int o) const {
    constexpr int s3[8] = {TD_STEP_16X3};
    constexpr int s2[5] = {TD_STEP_16X2};
    return kDepth == 3 ? s3[o] : s2[o < 5 ? o : 0];
  }
  __device__ __forceinline__ int rot(int o) const {
    constexpr int r3[8] = {TD_ROT_16X3};
    constexpr int r2[5] = {TD_ROT_16X2};
    return kDepth == 3 ? r3[o] : r2[o < 5 ? o : 0];
  }
  __device__ __forceinline__ uint32_t level(int L) const {
    constexpr uint32_t m[6] = {TD_LEVELS_16};
    return m[L] | (m[L] << 16);
  }
  __device__ __forceinline__ uint32_t row(const uint8_t* zs, long long r) const {
    return load_row16(zs + r * 16) * 0x10001u;
  }
  // the cycle's four bit planes and its advance into its 16-byte sel row,
  // one store; td_expand_kernel turns them into the row's 16 option bytes
  // and the advance byte
  __device__ __forceinline__ void store(int8_t* out, int8_t*, uint32_t q0, uint32_t q1, uint32_t q2, uint32_t q3,
                                        int adv) const {
    *reinterpret_cast<uint4*>(out) =
        make_uint4((q0 & 0xffffu) | (q1 << 16), (q2 & 0xffffu) | (q3 << 16), (uint32_t)adv, 0u);
  }
};
using Tab16x3 = Tab16<3>;
using Tab16x2 = Tab16<2>;

template <bool kRepT>
struct TabRt {  // the launch's tables; level masks in shared memory
  static constexpr bool kFixed = false, kRep = kRepT;
  static constexpr int kOptions = kMaxOptions;
  int n_, depth_, n_options_, n_levels_, vec_;
  uint32_t full_;
  int step_[kMaxOptions], rot_[kMaxOptions];
  const uint32_t* levels_;
  __device__ __forceinline__ int n() const { return n_; }
  __device__ __forceinline__ int depth() const { return depth_; }
  __device__ __forceinline__ int n_options() const { return n_options_; }
  __device__ __forceinline__ uint32_t full() const { return full_; }
  __device__ __forceinline__ int step(int o) const { return step_[o]; }
  __device__ __forceinline__ int rot(int o) const { return rot_[o]; }
  __device__ __forceinline__ uint32_t level(int L) const { return levels_[L]; }
  __device__ __forceinline__ uint32_t row(const uint8_t* zs, long long r) const {
    const uint32_t w = load_row(zs + r * n_, n_, vec_);
    return kRep ? replicate(w, n_) : w;
  }
  __device__ __forceinline__ void store(int8_t* out, int8_t* adv_out, uint32_t q0, uint32_t q1, uint32_t q2,
                                        uint32_t q3, int adv) const {
    store_sel(out, q0, q1, q2, q3, n_, vec_);
    *adv_out = (int8_t)adv;
  }
};

// The launch's tables into a TabRt (the level masks into `levels`, a
// shared array; constant indices keep the argument struct in parameter
// space).  Every thread of the CTA calls it; the CTA syncs after.
template <class Tab, class Args>
__device__ __forceinline__ Tab make_tab(const Args& a, int vec, uint32_t* levels) {
  Tab tb{};
  if constexpr (!Tab::kFixed) {
    tb.n_ = a.N;
    tb.depth_ = a.depth;
    tb.n_options_ = a.n_options;
    tb.n_levels_ = a.n_levels;
    tb.vec_ = vec;
    tb.full_ = (Tab::kRep || a.N == 32) ? kFull : ((1u << a.N) - 1u);
#pragma unroll
    for (int o = 0; o < kMaxOptions; ++o) {
      tb.step_[o] = a.opt_step[o];
      tb.rot_[o] = a.opt_rot[o];
    }
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i)
      if ((int)threadIdx.x == i) levels[i] = Tab::kRep ? replicate(a.level_mask[i], a.N) : a.level_mask[i];
    tb.levels_ = levels;
  }
  return tb;
}

// one level of the hierarchical scheduler on the window (w0, w1, w2);
// kPlanes: also each lane's option as bit planes (the tile mode needs only
// the cleared window)
template <class Tab, bool kPlanes>
__device__ __forceinline__ void sched_level(const Tab& tb, int L, uint32_t& w0, uint32_t& w1, uint32_t& w2,
                                            uint32_t& q0, uint32_t& q1, uint32_t& q2, uint32_t& picked) {
  uint32_t avail = tb.level(L);
  uint32_t c0 = 0, c1 = 0, c2 = 0;
  // every option slot runs, branch-free (for launch tables a slot past
  // n_options takes nothing), so the rotations of all of them can overlap:
  // only the open-lane mask chains one to the next
#pragma unroll
  for (int o = 0; o < Tab::kOptions; ++o) {
    const int st = tb.step(o), r = tb.rot(o);
    const uint32_t src = st == 0 ? w0 : st == 1 ? w1 : w2;
    uint32_t take = rot_down<Tab::kRep>(src, r, tb.n(), tb.full()) & avail;
    if constexpr (!Tab::kFixed) take &= o < tb.n_options() ? kFull : 0u;
    avail &= ~take;
    if constexpr (kPlanes) {
      picked |= take;
      if (o & 1) q0 |= take;
      if (o & 2) q1 |= take;
      if (o & 4) q2 |= take;
    }
    const uint32_t gone = rot_up<Tab::kRep>(take, r, tb.n(), tb.full());
    c0 |= st == 0 ? gone : 0u;
    c1 |= st == 1 ? gone : 0u;
    c2 |= st == 2 ? gone : 0u;
  }
  w0 &= ~c0;
  w1 &= ~c1;
  w2 &= ~c2;
}

// One level with the compiled-in tables, the same picks in fewer
// instructions: the open-lane mask chains through the options (a lane
// keeps its first option whose source is set), the lanes that took one are
// the level's lanes left closed, and the takes fold into the option planes
// and the cleared sources afterwards.  Row 0's bits are read by option 0
// alone (each lane's own dense option, always open at its level), so every
// one drains and row 0 needs no clearing: the shift drops it.
template <class Tab, bool kPlanes>
__device__ __forceinline__ void sched_level_fixed(const Tab& tb, int L, uint32_t w0, uint32_t& w1, uint32_t& w2,
                                                  uint32_t& q0, uint32_t& q1, uint32_t& q2, uint32_t& picked) {
  const uint32_t lvl = tb.level(L);
  uint32_t take[Tab::kOptions];
  uint32_t avail = lvl;
#pragma unroll
  for (int o = 0; o < Tab::kOptions; ++o) {
    const int st = tb.step(o);
    const uint32_t src = rot_down<true>(st == 0 ? w0 : st == 1 ? w1 : w2, tb.rot(o), 16, kFull);
    take[o] = src & avail;
    avail &= ~src;
  }
  if constexpr (kPlanes) picked |= lvl & ~avail;
  uint32_t c1 = 0, c2 = 0;
#pragma unroll
  for (int o = 1; o < Tab::kOptions; ++o) {
    if constexpr (kPlanes) {
      if (o & 1) q0 |= take[o];
      if (o & 2) q1 |= take[o];
      if (o & 4) q2 |= take[o];
    }
    const uint32_t gone = rot_up<true>(take[o], tb.rot(o), 16, kFull);
    if (tb.step(o) == 1) c1 |= gone;
    else c2 |= gone;
  }
  w1 &= ~c1;
  w2 &= ~c2;
}

// One scheduler cycle on the window: clears the taken bits, returns the
// advance (AS, the leading drained rows) and, with kPlanes, the lanes'
// options as bit planes.
template <class Tab, bool kPlanes = true>
__device__ __forceinline__ int sched_cycle(const Tab& tb, uint32_t& w0, uint32_t& w1, uint32_t& w2,
                                           uint32_t& q0, uint32_t& q1, uint32_t& q2, uint32_t& q3) {
  uint32_t picked = 0;
  q0 = q1 = q2 = q3 = 0;
  if constexpr (Tab::kFixed) {
#pragma unroll
    for (int L = 0; L < Tab::kLevels; ++L) sched_level_fixed<Tab, kPlanes>(tb, L, w0, w1, w2, q0, q1, q2, picked);
  } else {
    // looped, not unrolled: the step's code stays small enough for the
    // instruction cache at any table
#pragma unroll 1
    for (int L = 0; L < tb.n_levels_; ++L) sched_level<Tab, kPlanes>(tb, L, w0, w1, w2, q0, q1, q2, picked);
  }
  if constexpr (kPlanes) {
    const uint32_t idle = tb.full() & ~picked;  // sel = n_options
    const int no = tb.n_options();
    if (no & 1) q0 |= idle;
    if (no & 2) q1 |= idle;
    if (no & 4) q2 |= idle;
    if (no & 8) q3 |= idle;
  }
  if ((Tab::kFixed || w0 == 0) && w1 == 0) return (tb.depth() > 2 && w2 == 0) ? 3 : 2;
  return 1;
}

// the window after an advance of `adv` rows; r0.. are the rows after it
// (selects, not branches: the lanes of a warp advance by different counts)
__device__ __forceinline__ void shift(int depth, int adv, uint32_t& w0, uint32_t& w1, uint32_t& w2,
                                      uint32_t r0, uint32_t r1, uint32_t r2) {
  const uint32_t n0 = adv == 1 ? w1 : depth > 2 && adv == 2 ? w2 : r0;
  const uint32_t n1 = adv == 1 ? (depth > 2 ? w2 : r0) : depth > 2 && adv == 2 ? r0 : r1;
  const uint32_t n2 = adv == 1 ? r0 : adv == 2 ? r1 : r2;
  w0 = n0;
  w1 = n1;
  w2 = depth > 2 ? n2 : 0u;
}

// ---------------------------------------------------------------------------
// the rows after a thread's window

constexpr int kRing = 32;        // rows a thread's ring
constexpr int kAhead = 24;       // a cycle at row nxt copies rows nxt + kAhead .. + 2
constexpr int kInFlight = 7;     // cycles' copies still in flight when a cycle reads its rows
constexpr int kRingStride = kRing + 1;  // uint4s a thread (+1: neighbours' slots in other banks)

// Each cycle reads the `depth` rows after the window (rows >= T are zero).
// Direct: a load of each when the cycle needs it.  Ring (16-lane rows): the
// thread's rows stream into its slice of shared memory by cp.async, the
// same few instructions every cycle on every lane (no lane waits on
// another's refill): each cycle copies the three rows kAhead past its
// first and commits them as one group (a row is copied as often as the
// window stays on it: the same bytes again); a row is read at least eight
// cycles after its copy was issued (the window moves at most 3 rows a
// cycle), so waiting for all but the last kInFlight groups never stalls,
// and a copy in flight never lands on a slot still to be read (it is 1 to
// 26 rows ahead of every row read, in a ring of 32).
template <class Tab, bool kRingRows>
struct Rows {
  const uint8_t* zs;
  int T;
  uint4* ring;  // this thread's kRing rows, row r at ring[r % kRing] (kRingRows)

  __device__ __forceinline__ void copy(int r) const {
    if (r < T) cp_async16(ring + (r & (kRing - 1)), zs + (long long)r * 16);
  }

  __device__ __forceinline__ void start(int nxt) const {
    if constexpr (kRingRows) {
      for (int i = 0; i < kAhead + 3; ++i) copy(nxt + i);
      cp_async_commit();
      cp_async_wait<0>();
    }
  }

  __device__ __forceinline__ uint32_t at(const Tab& tb, int r) const {
    if constexpr (kRingRows) {  // the slot is read either way (no branch), its word kept below T
      const uint32_t w = word16(ring[r & (kRing - 1)]) * 0x10001u;
      return r < T ? w : 0u;
    } else {
      return r < T ? tb.row(zs, r) : 0u;
    }
  }

  // rows nxt .. nxt + depth - 1
  __device__ __forceinline__ void next(const Tab& tb, int nxt, int depth, uint32_t& r0, uint32_t& r1,
                                       uint32_t& r2) const {
    if constexpr (kRingRows) cp_async_wait<kInFlight>();
    r0 = at(tb, nxt);
    r1 = at(tb, nxt + 1);
    r2 = depth > 2 ? at(tb, nxt + 2) : 0u;
    if constexpr (kRingRows) {
      copy(nxt + kAhead);
      copy(nxt + kAhead + 1);
      copy(nxt + kAhead + 2);
      cp_async_commit();
    }
  }
};

// ---------------------------------------------------------------------------
// stream mode

// the split's records (workspace layout: split_bytes in kernels/schedule.py)
struct HeadRec { uint32_t w0, w1, w2; int c; };      // a head row's state when visited; c < 0: not visited
struct Resume { long long p, c; uint32_t w0, w1, w2, pad; };
struct SegEnd { int j, q, c_end, c_enter; };         // handed to segment j at row q (j == n_segs: ran to
                                                     // the end), own cycles there, j's head cycles there
struct SegPlan { long long out; int p, n; };          // entry row, cycles (-1: off the chain), output offset

struct Work {
  HeadRec* head;
  Resume* resume;
  SegEnd* ends;
  SegPlan* plan;
};

__host__ __device__ inline Work carve(void* base, long long segs, int overlap) {
  char* b = static_cast<char*>(base);
  Work w;
  w.head = reinterpret_cast<HeadRec*>(b);
  b += segs * overlap * (long long)sizeof(HeadRec);
  w.resume = reinterpret_cast<Resume*>(b);
  b += segs * (long long)sizeof(Resume);
  w.ends = reinterpret_cast<SegEnd*>(b);
  b += segs * (long long)sizeof(SegEnd);
  w.plan = reinterpret_cast<SegPlan*>(b);
  return w;
}

enum Mode { kWhole = 0, kHead = 1, kMain = 2, kReplay = 3 };

// kWhole: one thread a stream, from its start to its end.  The split's
// passes: kHead, kMain, kReplay (one thread a segment; see the top).
template <class Tab, int kMode>
__global__ void __launch_bounds__(kStreamBlock) td_schedule_kernel(const TdScheduleArgs a) {
  constexpr bool kRingRows = Tab::kFixed;
  __shared__ uint32_t levels[kMaxLevels];
  __shared__ uint4 rings[kRingRows ? kStreamBlock * kRingStride : 1];
  const Tab tb = make_tab<Tab>(a, a.vec, levels);
  __syncthreads();
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int T = (int)a.T;  // < 2^31 - 16: rows, cycles and pointers fit an int
  const int n = tb.n(), depth = tb.depth();
  const int K = a.n_segs, seg = a.seg_rows, overlap = a.overlap;
  long long s, out = 0;
  int k = 0, b = 0, p = 0, c = 0, stop = T, n_run = 0;
  uint32_t w0 = 0, w1 = 0, w2 = 0;
  Work wk{};
  if constexpr (kMode == kWhole) {
    if (id >= a.S) return;
    s = id;
  } else {
    if (id >= (long long)a.S * K) return;
    wk = carve(a.work, (long long)a.S * K, overlap);
    s = id / K;
    k = (int)(id - s * K);
    b = k * seg;
  }
  const uint8_t* zs = a.z + s * a.T * n;
  if constexpr (kMode == kWhole || kMode == kHead) {  // a fresh window at b
    p = b;
    w0 = b < T ? tb.row(zs, b) : 0u;
    w1 = b + 1 < T ? tb.row(zs, b + 1) : 0u;
    w2 = depth > 2 && b + 2 < T ? tb.row(zs, b + 2) : 0u;
    if constexpr (kMode == kHead) stop = b + overlap < T ? b + overlap : T;
  } else if constexpr (kMode == kMain) {
    const Resume r = wk.resume[id];
    p = (int)r.p;
    c = (int)r.c;
    w0 = r.w0;
    w1 = r.w1;
    w2 = r.w2;
  } else {  // kReplay
    const SegPlan pl = wk.plan[id];
    if (pl.n < 0) return;
    p = pl.p;
    n_run = pl.n;
    out = pl.out;
    const HeadRec h = wk.head[id * overlap + (p - b)];
    w0 = h.w0;
    w1 = h.w1;
    w2 = h.w2;
  }
  int8_t* sel = a.sel + (s * a.T + out) * n;
  int8_t* adv_out = a.advance + s * a.T + out;
  HeadRec* head = kMode == kHead ? wk.head + id * overlap : nullptr;  // row b + i at head[i]
  SegEnd end{K, T, 0, 0};
  int nxt = p + depth;
  Rows<Tab, kRingRows> rows{zs, T, rings + (kRingRows ? threadIdx.x * kRingStride : 0)};
  rows.start(nxt);
  for (;;) {
    if (kMode == kReplay ? c >= n_run : p >= stop) break;
    if constexpr (kMode == kMain) {  // a later segment's head row: the same state hands over
      const int j = p / seg;
      if (j > k && p - j * seg < overlap) {
        const HeadRec h = wk.head[(s * K + j) * overlap + (p - j * seg)];
        if (h.c >= 0 && h.w0 == w0 && h.w1 == w1 && h.w2 == w2) {
          end = SegEnd{j, p, c, h.c};
          break;
        }
      }
    }
    if constexpr (kMode == kHead) head[p - b] = HeadRec{w0, w1, w2, c};
    uint32_t r0, r1, r2;  // the rows after the window, read before the cycle needs them
    rows.next(tb, nxt, depth, r0, r1, r2);
    uint32_t q0, q1, q2, q3;
    const int adv = sched_cycle(tb, w0, w1, w2, q0, q1, q2, q3);
    if constexpr (kMode == kWhole || kMode == kReplay) {
      tb.store(sel, adv_out, q0, q1, q2, q3, adv);
      sel += n;
      ++adv_out;
    }
    if constexpr (kMode == kHead) {  // the head rows this cycle skips
      for (int d = 1; d < adv; ++d)
        if (p + d < stop) head[p + d - b] = HeadRec{0u, 0u, 0u, -1};
    }
    shift(depth, adv, w0, w1, w2, r0, r1, r2);
    p += adv;
    nxt += adv;
    ++c;
  }
  if constexpr (kMode == kWhole) a.n_cycles[s] = c;
  if constexpr (kMode == kHead) wk.resume[id] = Resume{p, c, w0, w1, w2, 0u};
  if constexpr (kMode == kMain) {
    if (end.j == K) end.c_end = c;
    wk.ends[id] = end;
  }
}

// After a 16-lane schedule: each cycle's bit planes and advance (its sel
// row as Tab16::store left it) into its 16 option bytes and its advance
// byte, a thread a row.
__global__ void td_expand_kernel(const TdScheduleArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.S * a.T) return;
  const long long s = i / a.T;
  if (i - s * a.T >= a.n_cycles[s]) return;
  int8_t* row = a.sel + i * 16;
  const uint4 v = *reinterpret_cast<const uint4*>(row);
  store_sel16(row, v.x & 0xffffu, v.x >> 16, v.y & 0xffffu, v.y >> 16);
  a.advance[i] = (int8_t)v.z;
}

// The split's pass 3, a CTA a stream: the chain of hand-overs from segment
// 0, each segment's entry row, cycle count and output offset; n_cycles.
__global__ void __launch_bounds__(kStitchBlock) td_stitch_kernel(const TdScheduleArgs a) {
  __shared__ SegEnd ends[kMaxSegs];
  const int K = a.n_segs;
  const long long s = blockIdx.x;
  const Work wk = carve(a.work, (long long)a.S * K, a.overlap);
  SegPlan* plan = wk.plan + s * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    ends[i] = wk.ends[s * K + i];
    plan[i] = SegPlan{0, 0, -1};
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long out = 0;
  int j = 0, entry = 0, c_entry = 0;  // segment 0 enters at row 0, its head cycle 0
  for (;;) {
    const SegEnd e = ends[j];
    const int nc = e.c_end - c_entry;
    plan[j] = SegPlan{out, entry, nc};
    out += nc;
    if (e.j >= K) break;
    entry = e.q;
    c_entry = e.c_enter;
    j = e.j;
  }
  a.n_cycles[s] = (int)out;
}

// ---------------------------------------------------------------------------
// tile mode

// The narrow mode (R <= 32), td_tile_kernel: a CTA of one warp walks
// `pack` tiles (the host picks the fewest that keep a scheduler to one warp:
// tile_launch_shape), tile kk's PE row r on lane kk R + r, the tile's
// advance one __reduce_min_sync over its R lanes.  The warp first stages
// its tiles' rows as words in shared memory (a slot of stage_words a tile;
// a tile that does not fit loads each row when a cycle needs it), so a
// cycle never waits on device memory.  A cycle's cost is its instruction
// stream: the cycle keeps none of the stream's bit planes, and a warp's
// tiles walk together (its lanes leave the loop as their tile ends).
template <class Tab>
__global__ void __launch_bounds__(32) td_tile_kernel(const TdTileArgs a) {
  extern __shared__ uint32_t words[];  // [pack][stage_words]
  __shared__ uint32_t levels[kMaxLevels];
  const Tab tb = make_tab<Tab>(a, a.N % 4 == 0, levels);
  const int R = a.R, n = tb.n(), depth = tb.depth(), lane = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * a.pack;
  for (int s = 0; s < a.pack && g0 + s < a.G; ++s) {
    const int T = a.t[g0 + s], ts = T | 1;  // odd: a tile's PE rows in different banks
    if ((long long)R * ts > a.stage_words) continue;
    const uint8_t* zt = a.z + a.offset[g0 + s];
    uint32_t* slot = words + (size_t)s * a.stage_words;
    for (int i = lane; i < R * T; i += 32) {
      const int r = i / T, row = i - r * T;
      slot[r * ts + row] = tb.row(zt + (long long)r * T * n, row);
    }
  }
  __syncthreads();
  const int kk = lane / R, r = lane - kk * R;
  const long long g = g0 + kk;
  if (kk >= a.pack || g >= a.G) return;
  const unsigned mask = R == 32 ? kFull : ((1u << R) - 1u) << (kk * R);
  const int T = a.t[g], ts = T | 1;
  const bool staged = (long long)R * ts <= a.stage_words;
  const uint32_t* mine = words + (size_t)kk * a.stage_words + r * ts;
  const uint8_t* zs = a.z + a.offset[g] + (long long)r * T * n;
  // this lane's PE row, row `row` (zero past the tile's end)
  auto at = [&](int row) -> uint32_t {
    if (row >= T) return 0u;
    return staged ? mine[row] : tb.row(zs, row);
  };
  uint32_t w0 = at(0), w1 = at(1), w2 = depth > 2 ? at(2) : 0u;
  int p = 0, c = 0;
  while (p < T) {  // the same trip count on every lane of the tile
    // one lockstep cycle: the rows after the window read first, the tile's advance the minimum over its rows
    const uint32_t r0 = at(p + depth), r1 = at(p + depth + 1), r2 = depth > 2 ? at(p + depth + 2) : 0u;
    uint32_t q0, q1, q2, q3;
    const int own = sched_cycle<Tab, false>(tb, w0, w1, w2, q0, q1, q2, q3);
    const int adv = (int)__reduce_min_sync(mask, (unsigned)own);
    shift(depth, adv, w0, w1, w2, r0, r1, r2);
    p += adv;
    ++c;
  }
  if (r == 0) a.cycles[g] = c;
}

// R > 32, td_tile_wide_kernel: a CTA a tile, one chain: ceil(R / 32) warps,
// the rows past R all-zero windows, the minimum taken over the warps
// through shared memory every cycle, each row loaded when a cycle needs it.
template <class Tab>
__global__ void __launch_bounds__(kMaxRows) td_tile_wide_kernel(const TdTileArgs a) {
  __shared__ uint32_t levels[kMaxLevels];
  __shared__ unsigned warp_min[2][kMaxRows / 32];
  const Tab tb = make_tab<Tab>(a, a.N % 4 == 0, levels);
  __syncthreads();
  const int n = tb.n(), depth = tb.depth();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = threadIdx.x;
  const long long g = blockIdx.x;
  const int T = a.t[g];
  const int rows = r < a.R ? T : 0;  // a padding row reads nothing: all zero
  const uint8_t* zs = rows ? a.z + a.offset[g] + (long long)r * T * n : a.z;
  uint32_t w0 = rows > 0 ? tb.row(zs, 0) : 0u;
  uint32_t w1 = rows > 1 ? tb.row(zs, 1) : 0u;
  uint32_t w2 = depth > 2 && rows > 2 ? tb.row(zs, 2) : 0u;
  int p = 0, nxt = depth, c = 0;
  const Rows<Tab, false> next_rows{zs, rows, nullptr};
  while (p < T) {
    uint32_t r0, r1, r2;
    next_rows.next(tb, nxt, depth, r0, r1, r2);
    uint32_t q0, q1, q2, q3;
    unsigned adv = __reduce_min_sync(kFull, (unsigned)sched_cycle<Tab, false>(tb, w0, w1, w2, q0, q1, q2, q3));
    if (lane == 0) warp_min[c & 1][warp] = adv;
    __syncthreads();
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) adv = min(adv, warp_min[c & 1][i]);
    shift(depth, (int)adv, w0, w1, w2, r0, r1, r2);
    p += adv;
    nxt += adv;
    ++c;
  }
  if (r == 0) a.cycles[g] = c;
}

// ---------------------------------------------------------------------------
// host side

template <class Args>
bool tables_ok(const Args& a) {
  if (a.N < 1 || a.N > 32 || (a.depth != 2 && a.depth != 3) || a.n_options < 1 ||
      a.n_options > kMaxOptions || a.n_levels < 1 || a.n_levels > kMaxLevels)
    return false;
  for (int o = 0; o < a.n_options; ++o)
    if (a.opt_step[o] < 0 || a.opt_step[o] >= a.depth || a.opt_rot[o] < 0 || a.opt_rot[o] >= a.N)
      return false;
  return true;
}

// 0: the launch's tables; 3 / 2: they are the compiled-in Tab16x3 / Tab16x2
template <class Args>
int compiled_tables(const Args& a) {
  static const int s3[] = {TD_STEP_16X3}, r3[] = {TD_ROT_16X3}, s2[] = {TD_STEP_16X2}, r2[] = {TD_ROT_16X2};
  static const unsigned lv[] = {TD_LEVELS_16};
  if (a.N != 16 || a.n_levels != 6) return 0;
  const int* st = a.depth == 3 ? s3 : s2;
  const int* rt = a.depth == 3 ? r3 : r2;
  if (a.n_options != (a.depth == 3 ? 8 : 5)) return 0;
  for (int o = 0; o < a.n_options; ++o)
    if (a.opt_step[o] != st[o] || a.opt_rot[o] != rt[o]) return 0;
  for (int i = 0; i < 6; ++i)
    if (a.level_mask[i] != lv[i]) return 0;
  return a.depth;
}

// the narrow tile launch's dynamic shared memory: its tiles' staged words
size_t tile_smem_bytes(const TdTileArgs& a) { return 4 * (size_t)a.pack * a.stage_words; }

// the packing and staging td_tile takes (tile_launch_shape in kernels/schedule.py makes them)
bool tile_shape_ok(const TdTileArgs& a) {
  if (a.R > 32) return a.pack == 1 && a.stage_words == 0;  // a CTA a tile, rows loaded as needed
  return a.pack >= 1 && a.pack <= 32 / a.R && a.stage_words >= 0 && tile_smem_bytes(a) <= (size_t)kTileSmem - 64;
}

unsigned blocks(long long threads, int per) { return (unsigned)((threads + per - 1) / per); }

template <class Tab>
int launch_schedule(const TdScheduleArgs& a, cudaStream_t st) {
  if (a.n_segs == 0) {
    td_schedule_kernel<Tab, kWhole><<<blocks(a.S, kStreamBlock), kStreamBlock, 0, st>>>(a);
  } else {
    const unsigned grid = blocks((long long)a.S * a.n_segs, kStreamBlock);
    td_schedule_kernel<Tab, kHead><<<grid, kStreamBlock, 0, st>>>(a);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    td_schedule_kernel<Tab, kMain><<<grid, kStreamBlock, 0, st>>>(a);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    td_stitch_kernel<<<(unsigned)a.S, kStitchBlock, 0, st>>>(a);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    td_schedule_kernel<Tab, kReplay><<<grid, kStreamBlock, 0, st>>>(a);
  }
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if constexpr (Tab::kFixed) td_expand_kernel<<<blocks((long long)a.S * a.T, 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <class Tab>
int launch_tile(const TdTileArgs& a, cudaStream_t st) {
  if (a.R > 32) {
    td_tile_wide_kernel<Tab><<<(unsigned)a.G, (unsigned)((a.R + 31) / 32 * 32), 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t bytes = tile_smem_bytes(a);
  if (bytes > 48 * 1024) {  // past the default: ask for it (once a size is granted it stays)
    static size_t granted = 48 * 1024;
    if (bytes > granted) {
      if (cudaError_t e = cudaFuncSetAttribute(td_tile_kernel<Tab>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes))
        return (int)e;
      granted = bytes;
    }
  }
  td_tile_kernel<Tab><<<blocks(a.G, a.pack), 32u, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One schedule on `stream`: one thread a stream (n_segs 0) or the split's
// four launches; returns the first cudaError_t.
int td_schedule(const TdScheduleArgs* args, void* stream) {
  const TdScheduleArgs& a = *args;
  if (a.S <= 0 || a.T <= 0 || a.T > kMaxT || !tables_ok(a)) return (int)cudaErrorInvalidValue;
  if (a.n_segs != 0 &&
      (a.n_segs < 1 || a.n_segs > kMaxSegs || a.work == nullptr || a.seg_rows < 2 || a.overlap < 1 ||
       a.overlap > a.seg_rows / 2 || (long long)a.n_segs * a.seg_rows < a.T ||
       (long long)(a.n_segs - 1) * a.seg_rows >= a.T))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((uintptr_t)a.z % 16 == 0) && ((uintptr_t)a.sel % 16 == 0);
  switch (aligned ? compiled_tables(a) : 0) {
    case 3: return launch_schedule<Tab16x3>(a, st);
    case 2: return launch_schedule<Tab16x2>(a, st);
    default: return 32 % a.N == 0 ? launch_schedule<TabRt<true>>(a, st) : launch_schedule<TabRt<false>>(a, st);
  }
}

// The cycles of every tile of a ragged batch on `stream`: one launch.
int td_tile(const TdTileArgs* args, void* stream) {
  const TdTileArgs& a = *args;
  if (a.G < 0 || a.R < 1 || a.R > kMaxRows || !tables_ok(a) || !tile_shape_ok(a) || (uintptr_t)a.z % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (a.G == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (compiled_tables(a)) {
    case 3: return launch_tile<Tab16x3>(a, st);
    case 2: return launch_tile<Tab16x2>(a, st);
    default: return 32 % a.N == 0 ? launch_tile<TabRt<true>>(a, st) : launch_tile<TabRt<false>>(a, st);
  }
}

}  // extern "C"
