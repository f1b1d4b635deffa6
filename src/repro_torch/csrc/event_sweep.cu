// The plain event sweep of Pond's provisioning loop, for sm_90a (K1).
//
// Replaces src/repro/core/sweep_core.py:138 build_sweep, a lax.scan (not a
// Pallas kernel) whose step `body` (l.174) replays one trace event for
// every candidate lane (server_gb, pool_gb) at once.  It computes exactly
// that step, event after event:
//
//   ARRIVE   best fit by free cores, first minimum, among servers with
//            fc >= c, um + l <= sgb and up[group] + p <= pgb; when the
//            pool is short, the all-local fallback among servers with
//            fc >= c and um + m <= sgb; else a reject.
//   DEPART   returns the cores, the local memory (m if migrated, else l)
//            and the pool memory (if not migrated); the slot empties.
//   MIGRATE  moves p from pool to local when um[s] + p <= sgb, also for a
//            VM the fallback placed (the scalar oracle's quirk, which can
//            drive used pool negative; not clamped).
//   PAD, FAIL, RECOVER are no-ops.
//
// Slot values pack server * 2 + migrated, -1 for empty.  State is int16 or
// int32 (template T); events and the reject counters are int32.  Wider
// arithmetic in registers is exact under the host's packing rules
// (core/sweep_core.py::pick_state_dtype: no int16 intermediate can
// overflow), and every value is stored back in T.
//
//   events    kind, slot, cores, local, pool, mem: six int32 (E,)
//   group_of  (S,) int32
//   fc, um    (C, S) free cores, used local GB         T, in/out
//   up        (C, G) used pool GB per group            T, in/out
//   slots     (n_slots, C) packed placement            T, in/out
//   sgb, pgb  (C,) capacities                          T
//   rejects   (C,) int32, added to                     in/out
//
// Trace axis.  One launch replays T event streams side by side (a batch of
// traces priced in lockstep, the reference's vmapped build_sweep): the
// six event arrays hold the traces one after another, trace t's events at
// [start[t], start[t] + count[t]) with every start a multiple of 4 events
// (so every row is 16-byte aligned), and the C = T * n_cand lanes are
// trace-major, lane t * n_cand + j being candidate j of trace t.  The
// slot column is sized by the largest trace's peak.  A block replays one
// trace (blockIdx.y): its warps share each staged tile of that trace's
// events, so a block never holds lanes of two traces; the grid is (blocks
// a trace, T).  Each kernel is built twice (template kBatched).  T = 1
// runs the single-trace build: start 0, its event count a scalar parameter
// (E_one) and the lane the candidate, as before the axis.  On the H100 a
// single trace through the batched build (count and start read from the
// table) took 7-8 % longer with int16 state (17.4 against 16.1 ms at the
// full trace, 16 lanes; int32 unchanged), and so do the batched launches.
//
// The final state is written back into the state arguments in place, so
// a sweep over a trace cut in pieces is the sweep over the whole trace.
// Indices the state or the events give outside their range (a group, a
// slot, a packed server) are clamped into it to keep every access inside
// the arrays; the result is then not defined.
//
// Bound.  A sweep cannot take less than E sequential steps: each event
// reads the state the previous one left (a best fit depends on every
// earlier placement).  The card's rates give a far lower floor — about
// 18 int32 operations per (ARRIVE event, lane, server) over 132 SMs x 64
// int32 lanes a clock, and 24 bytes an event plus the state once — so
// the time is that of the per-event dependency chain, times E.
//
// Two variants, one warp a candidate lane in both, blocks independent
// (nothing carries between them):
//
//  * registers (S <= 32 * 16, the rule): thread t owns the K = S / 32
//    (rounded up to a power of two) contiguous servers [t K, t K + K) and
//    holds their free cores, used local memory, group id and a copy of
//    up[group] in int32 registers for the whole sweep (K is a template
//    parameter, every loop over a thread's servers is unrolled and indexes
//    its arrays with constants, so nothing goes to local memory).  A lone
//    warp issues an integer instruction every two cycles at best (its
//    sub-partition has 16 integer lanes), so a server costs few
//    instructions: the bounds sgb - l, sgb - m, pgb - p are computed once
//    an event, a mask is three compares (& of bools, never a branch), and
//    with int16 state a server's free cores are kept as its key
//    (f + 2^15) << 9 | server, so f >= c is one compare and the least key
//    of a mask is its first minimum (exact for every int16 f and
//    S <= 2^9; keys below 2^25).  A tree over the thread's K servers and
//    one redux.sync a mask give the warp's minimum.  int32 scores do not
//    fit such a key: a thread's tree keeps its first minimum (score,
//    server), and two redux.sync a mask give the least score, then the
//    least server holding it.  The pooled and the fallback reductions are
//    issued together.  Every value an update needs after them (the chosen
//    server, its group, the deltas) is the same across the warp, so each
//    thread updates its own registers, the group copies included, by
//    predicated adds, and no state write has to be made visible to
//    another thread.  Only thread 0 reads and writes the lane's slot
//    column (shared memory, too large for registers) and broadcasts a
//    slot by shuffle, so the loop has no __syncwarp.  The next event is
//    read from the stage while the current one is replayed.
//  * shared (any S that fits a block's shared memory): the kernel of the
//    first port, kept as it was.  Server s belongs to thread s % 32; the
//    lane's fc, um, up and slot column live in shared memory.  Per ARRIVE
//    each thread scans its servers for both masks and a __shfl_xor_sync
//    reduction over (score, index) packed in 64 bits gives the first
//    minimum; the fallback's reduction runs only when no server passes
//    the pooled mask.  One __syncwarp an event orders the owner thread's
//    writes.
//
// Both stage events in shared memory in tiles of 1024, two stages filled
// by cp.async: tile n+1 is in flight while tile n is replayed.  Every warp
// of the block reads the same tile, so the block barrier comes twice a
// tile, not once an event.
//
// The slot column.  Both variants keep a lane's slot column in shared
// memory while it fits beside the stages (and, for the shared variant,
// the lane's fc, um and up).  Past that (at 256 servers, 45,568 slots in
// int32 and 91,136 in int16) it stays where it lies, in its column of
// `slots` (stride C) in global memory, and thread 0 reads and writes it
// there: no copy in or out, and a DEPART's or MIGRATE's slot read becomes
// a dependent global load (template kGlobalSlots, both builds of the
// trace axis).  kernel.py::plan chooses; only the shared variant's fc, um
// and up must still fit.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kArrive = 0, kDepart = 1, kMigrate = 2;
constexpr int kTile = 1024;        // events a stage
constexpr int kStages = 2;
constexpr int kMaxLanesPerBlock = 8;
constexpr int kMaxTraces = 256;     // traces a launch (the table below)
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr int kMaxK = 16;           // servers a thread, registers variant
constexpr int kIndexBits = 9;       // packed key: server index bits
constexpr int kScoreOffset = 1 << 15;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kShared = 0, kRegisters = 1 };

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of a block: the event stages, group_of, then one region a
// lane in T: its fc, um, up and slot column for the shared variant, its
// slot column alone for the registers variant; no slot column when it
// lies in global memory.  kernel.py::shared_bytes computes the same.
__host__ __device__ size_t lane_bytes(int variant, int S, int G, int n_slots,
                                      int item, bool global_slots) {
  const size_t n = variant == kShared ? static_cast<size_t>(2 * S + G) : 0;
  return round16((n + (global_slots ? 0 : n_slots)) * item);
}
__host__ __device__ size_t shared_bytes(int variant, int S, int G,
                                        int n_slots, int item, int lanes,
                                        bool global_slots) {
  return static_cast<size_t>(kStages) * 6 * kTile * 4 +
         round16(static_cast<size_t>(S) * 4) +
         lanes * lane_bytes(variant, S, G, n_slots, item, global_slots);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Events {
  const int* a[6];  // kind, slot, cores, local, pool, mem
};

// Where each trace's events lie in the event arrays; a kernel parameter
// (__grid_constant__: indexed by blockIdx.y without a local copy).
struct Traces {
  int start[kMaxTraces];  // multiples of 4
  int count[kMaxTraces];
};

// Stage events [e0, e0 + n) of the six arrays into dst[6][kTile]; e0 (a
// trace's start plus a multiple of kTile) is a multiple of 4 and every
// array 16-byte aligned (the wrapper checks).
// The registers variant's; the shared one keeps its own (load_tile_flat).
__device__ __forceinline__ void load_tile(const Events& ev, int* dst, int e0,
                                          int n) {
  const int n4 = n >> 2;
  // constant array indices: a dynamic one would copy ev to local memory
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    for (int v = threadIdx.x; v < n4; v += blockDim.x)
      cp_async16(dst + a * kTile + 4 * v, ev.a[a] + e0 + 4 * v);
    for (int v = 4 * n4 + threadIdx.x; v < n; v += blockDim.x)
      cp_async4(dst + a * kTile + v, ev.a[a] + e0 + v);
  }
}

// Tile t of the registers variant's event loop: stages tile t + 1 while
// tile t is replayed, waits for tile t and returns it.  The caller ends
// each tile with a block barrier (every warp is done with the stage).
__device__ __forceinline__ const int* next_tile(const Events& ev, int* stage,
                                                int e_base, int E, int t) {
  const int e1 = (t + 1) * kTile;
  if (e1 < E) {
    load_tile(ev, stage + ((t + 1) & 1) * 6 * kTile, e_base + e1,
              min(kTile, E - e1));
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // tile t (and, at t = 0, the lane state) is in place
  return stage + (t & 1) * 6 * kTile;
}

__device__ __forceinline__ void first_tile(const Events& ev, int* stage,
                                           int e_base, int E) {
  if (E > 0) load_tile(ev, stage, e_base, min(kTile, E));
  cp_async_commit();
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (score, server) as one key whose minimum is the first minimum: exact for
// int16 scores and servers below 2^kIndexBits
__host__ __device__ constexpr unsigned packed_key(int score, int server) {
  return static_cast<unsigned>(score + kScoreOffset) << kIndexBits |
         static_cast<unsigned>(server);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi - 1);
}

// ------------------------------------------------------------ registers --
// u + x <= cap as u <= bound(cap, x): one compare a server with a bound
// that is the same for the whole warp.  Exact: int16 operands cannot
// overflow int32, and with int32 ones the difference saturates.
template <typename T>
__device__ __forceinline__ int bound(int cap, int x) {
  if constexpr (sizeof(T) == 2) {
    return cap - x;
  } else {
    const int d = static_cast<int>(static_cast<unsigned>(cap) -
                                   static_cast<unsigned>(x));
    const bool overflow = ((cap ^ x) & (cap ^ d)) < 0;
    return overflow ? (cap < 0 ? INT_MIN : INT_MAX) : d;
  }
}

// x += dx and y += dy where a == b: one compare and two predicated adds
// (written as C++, each add compiles to a select and an add)
__device__ __forceinline__ void add2_where(int& x, int& y, int a, int b,
                                           int dx, int dy) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %2, %3;\n\t"
      "@p add.s32 %0, %0, %4;\n\t@p add.s32 %1, %1, %5;\n\t}"
      : "+r"(x), "+r"(y)
      : "r"(a), "r"(b), "r"(dx), "r"(dy));
}
__device__ __forceinline__ void add_where(int& x, int a, int b, int dx) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, %3;\n\t}"
      : "+r"(x)
      : "r"(a), "r"(b), "r"(dx));
}

// Reads event i of a staged tile into registers.
__device__ __forceinline__ void read_event(const int* tk, int i, int& kind,
                                           int& slot, int& c, int& l,
                                           int& p, int& m) {
  kind = tk[i];
  slot = tk[kTile + i];
  c = tk[2 * kTile + i];
  l = tk[3 * kTile + i];
  p = tk[4 * kTile + i];
  m = tk[5 * kTile + i];
}

template <typename T, int K, bool kBatched, bool kGlobalSlots>
__global__ void __launch_bounds__(32 * kMaxLanesPerBlock)
    sweep_regs_kernel(Events ev, const int* __restrict__ group_of,
                      T* __restrict__ fc, T* __restrict__ um,
                      T* __restrict__ up, T* __restrict__ slots,
                      const T* __restrict__ sgb, const T* __restrict__ pgb,
                      int* __restrict__ rejects, int E_one, int C, int S,
                      int G, int n_slots, int lanes_per_block, int n_cand,
                      const __grid_constant__ Traces tr) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  int* grp_s = stage + kStages * 6 * kTile;
  const size_t stride =
      lane_bytes(kRegisters, S, G, n_slots, sizeof(T), kGlobalSlots) /
      sizeof(T);
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  T* s_sl = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(grp_s) +
                                 round16(static_cast<size_t>(S) * 4)) +
            warp * stride;
  // this block's trace, and this warp's candidate within it
  const int trace = kBatched ? blockIdx.y : 0;
  const int e_base = kBatched ? tr.start[trace] : 0;
  const int E = kBatched ? tr.count[trace] : E_one;
  const int cand = blockIdx.x * lanes_per_block + warp;
  const bool active = cand < (kBatched ? n_cand : C);
  const int lane = kBatched ? trace * n_cand + cand : cand;
  // the lane's slot column: slot j at sl_col[j * sl_stride]
  T* const sl_col = kGlobalSlots ? slots + (active ? lane : 0) : s_sl;
  const size_t sl_stride = kGlobalSlots ? static_cast<size_t>(C) : 1;
  constexpr int big = sizeof(T) == 2 ? (1 << 14) : (1 << 30);
  // int16 scores take the packed key, int32 ones the two-step reduction
  constexpr bool kPacked = sizeof(T) == 2;
  static_assert(32 * kMaxK <= (1 << kIndexBits), "packed key's index bits");
  // packed keys at or above this mark an empty mask
  constexpr unsigned kNone = packed_key(big, 0);
  const int base = tid * K;

  first_tile(ev, stage, e_base, E);
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    grp_s[i] = clampi(group_of[i], G);

  // Thread tid's servers base .. base + K - 1.  fk is the server's free
  // cores f, or with kPacked its key packed_key(f, server): a strict
  // order by (f, server), so f >= c is fk >= packed_key(c, 0) and the
  // least key of a mask is its first minimum.  A server past S is a pad
  // that never fits (f = big) and belongs to no group.
  int fk[K], u[K], g[K], q[K];
  int sg = 0, pg = 0, rej = 0;
  const size_t row = static_cast<size_t>(lane);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = base + j;
    int f = big;
    u[j] = 0;
    g[j] = -1;
    q[j] = 0;
    if (active && s < S) {
      f = fc[row * S + s];
      u[j] = um[row * S + s];
      g[j] = clampi(group_of[s], G);
      q[j] = up[row * G + g[j]];
    }
    fk[j] = kPacked ? static_cast<int>(packed_key(f, s)) : f;
  }
  if (active) {
    if (!kGlobalSlots)
      for (int j = tid; j < n_slots; j += 32)
        s_sl[j] = slots[static_cast<size_t>(j) * C + lane];
    sg = sgb[lane];
    pg = pgb[lane];
    rej = rejects[lane];
  }

  for (int t = 0; t * kTile < E; ++t) {
    const int* tk = next_tile(ev, stage, e_base, E, t);
    const int n = active ? min(kTile, E - t * kTile) : 0;
    // event i + 1 is read while event i is replayed: inside each branch,
    // after work of its own, so the copy into the loop's registers comes
    // at the end of the event and waits on no load
    int kind, sl, ec, el, ep, em;
    read_event(tk, 0, kind, sl, ec, el, ep, em);
    for (int i = 0; i < n; ++i) {
      const int cur_kind = kind, slot = clampi(sl, n_slots);
      // payloads in the state's type, as the reference casts them
      const int c = static_cast<T>(ec), l = static_cast<T>(el),
                p = static_cast<T>(ep), m = static_cast<T>(em);
      const int nx = min(i + 1, n - 1);
      // the change of fk when c cores leave or return
      const int dk = kPacked ? c * (1 << kIndexBits) : c;
      if (cur_kind == kArrive) {
        const int need = kPacked ? static_cast<int>(packed_key(c, 0)) : c;
        const int room_l = bound<T>(sg, l), room_m = bound<T>(sg, m),
                  room_p = bound<T>(pg, p);
        read_event(tk, nx, kind, sl, ec, el, ep, em);
        // masks by & (no branch a server), then a tree over the thread's
        // servers (depth log2 K)
        int sel, feas1, place;
        if constexpr (kPacked) {
          unsigned k1[K], k2[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const bool fits = fk[j] >= need;
            const unsigned key = static_cast<unsigned>(fk[j]);
            k1[j] = fits & (u[j] <= room_l) & (q[j] <= room_p) ? key
                                                                : UINT_MAX;
            k2[j] = fits & (u[j] <= room_m) ? key : UINT_MAX;
          }
#pragma unroll
          for (int w = 1; w < K; w *= 2) {
#pragma unroll
            for (int j = 0; j < K; j += 2 * w) {
              k1[j] = min(k1[j], k1[j + w]);
              k2[j] = min(k2[j], k2[j + w]);
            }
          }
          const unsigned r1 = __reduce_min_sync(kFull, k1[0]);
          const unsigned r2 = __reduce_min_sync(kFull, k2[0]);
          feas1 = r1 < kNone;
          place = feas1 | (r2 < kNone);
          sel = static_cast<int>((feas1 ? r1 : r2) &
                                 ((1u << kIndexBits) - 1));
        } else {
          int b1[K], i1[K], b2[K], i2[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const bool fits = fk[j] >= need;
            b1[j] = fits & (u[j] <= room_l) & (q[j] <= room_p) ? fk[j] : big;
            b2[j] = fits & (u[j] <= room_m) ? fk[j] : big;
            i1[j] = i2[j] = base + j;
          }
          // neighbours pair up, so the left always holds the lower
          // servers and a tie keeps it (strict: the first minimum)
#pragma unroll
          for (int w = 1; w < K; w *= 2) {
#pragma unroll
            for (int j = 0; j < K; j += 2 * w) {
              const bool r1 = b1[j + w] < b1[j], r2 = b2[j + w] < b2[j];
              b1[j] = r1 ? b1[j + w] : b1[j];
              i1[j] = r1 ? i1[j + w] : i1[j];
              b2[j] = r2 ? b2[j + w] : b2[j];
              i2[j] = r2 ? i2[j + w] : i2[j];
            }
          }
          const int m1 = __reduce_min_sync(kFull, b1[0]);
          const int m2 = __reduce_min_sync(kFull, b2[0]);
          const int x1 =
              __reduce_min_sync(kFull, b1[0] == m1 ? i1[0] : INT_MAX);
          const int x2 =
              __reduce_min_sync(kFull, b2[0] == m2 ? i2[0] : INT_MAX);
          feas1 = m1 < big;
          place = feas1 | (m2 < big);
          sel = feas1 ? x1 : x2;
        }
        // the same for every thread: the chosen server (as an offset from
        // this thread's first, out of range when nothing is placed), its
        // group (none when the pool is not used) and the deltas
        const int gs = place & feas1 ? grp_s[sel] : INT_MIN;
        const int hit = place ? sel - base : -1;
        const int dl = feas1 ? l : m;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          add2_where(fk[j], u[j], hit, j, -dk, dl);
          add_where(q[j], g[j], gs, p);
        }
        rej += place ? 0 : 1;
        if (tid == 0)
          sl_col[slot * sl_stride] =
              static_cast<T>(place ? sel * 2 + (feas1 ? 0 : 1) : -1);
      } else if (cur_kind == kDepart || cur_kind == kMigrate) {
        // only thread 0 touches the slot column; the warp gets the slot
        // by shuffle
        int val = 0;
        if (tid == 0) val = sl_col[slot * sl_stride];
        val = __shfl_sync(kFull, val, 0);
        read_event(tk, nx, kind, sl, ec, el, ep, em);
        const int s = clampi(val >> 1, S);
        const int gs = grp_s[s];
        const int hit = val >= 0 ? s - base : -1;
        if (cur_kind == kDepart) {
          const bool mg = (val & 1) == 1;
          const int dm = mg ? m : l;
          const int gp = val >= 0 && !mg ? gs : INT_MIN;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            add2_where(fk[j], u[j], hit, j, dk, -dm);
            add_where(q[j], g[j], gp, -p);
          }
          if (tid == 0) sl_col[slot * sl_stride] = static_cast<T>(-1);
        } else {  // MIGRATE: pool -> local when the local memory takes it
          const int room = bound<T>(sg, p);
          bool fits = false;
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (hit == j) fits = u[j] <= room;
          const bool act = __any_sync(kFull, fits);
          const int gp = act ? gs : INT_MIN;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (act && hit == j) u[j] += p;
            if (g[j] == gp) q[j] -= p;
          }
          if (tid == 0 && act)
            sl_col[slot * sl_stride] = static_cast<T>(val | 1);
        }
      } else {
        read_event(tk, nx, kind, sl, ec, el, ep, em);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = base + j;
      if (s < S) {
        const int f = kPacked ? (fk[j] >> kIndexBits) - kScoreOffset : fk[j];
        fc[row * S + s] = static_cast<T>(f);
        um[row * S + s] = static_cast<T>(u[j]);
        // every server of a group holds the same copy of its pool
        up[row * G + g[j]] = static_cast<T>(q[j]);
      }
    }
    if (!kGlobalSlots)
      for (int j = tid; j < n_slots; j += 32)
        slots[static_cast<size_t>(j) * C + lane] = s_sl[j];
    if (tid == 0) rejects[lane] = rej;
  }
}

// --------------------------------------------------------------- shared --
// load_tile as the first port wrote it: one flat loop over (array,
// vector), whose dynamic array index puts ev in a 48-byte stack frame.
// This kernel is faster with it than with load_tile (at the full trace,
// 16 lanes, one call on the H100: 50.6 against 58.3 ms with int32 state,
// 56.5 against 59.5 ms with int16), so it keeps it.
__device__ __forceinline__ void load_tile_flat(const Events& ev, int* dst,
                                               int e0, int n) {
  const int n4 = n >> 2;
  for (int j = threadIdx.x; j < 6 * n4; j += blockDim.x) {
    const int a = j / n4, v = j - a * n4;
    cp_async16(dst + a * kTile + 4 * v, ev.a[a] + e0 + 4 * v);
  }
  const int rest = n - 4 * n4;
  for (int j = threadIdx.x; j < 6 * rest; j += blockDim.x) {
    const int a = j / rest, v = 4 * n4 + (j - a * rest);
    cp_async4(dst + a * kTile + v, ev.a[a] + e0 + v);
  }
}

template <typename T, bool kBatched, bool kGlobalSlots>
__global__ void __launch_bounds__(32 * kMaxLanesPerBlock)
    sweep_shared_kernel(Events ev, const int* __restrict__ group_of,
                        T* __restrict__ fc, T* __restrict__ um,
                        T* __restrict__ up, T* __restrict__ slots,
                        const T* __restrict__ sgb, const T* __restrict__ pgb,
                        int* __restrict__ rejects, int E_one, int C, int S,
                        int G, int n_slots, int lanes_per_block, int n_cand,
                        const __grid_constant__ Traces tr) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  int* grp = stage + kStages * 6 * kTile;
  const size_t stride =
      lane_bytes(kShared, S, G, n_slots, sizeof(T), kGlobalSlots) /
      sizeof(T);
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  T* mine = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(grp) +
                                 round16(static_cast<size_t>(S) * 4)) +
            warp * stride;
  T* s_fc = mine;
  T* s_um = mine + S;
  T* s_up = mine + 2 * S;
  T* s_sl = mine + 2 * S + G;
  const int trace = kBatched ? blockIdx.y : 0;
  const int e_base = kBatched ? tr.start[trace] : 0;
  const int E = kBatched ? tr.count[trace] : E_one;
  const int cand = blockIdx.x * lanes_per_block + warp;
  const bool active = cand < (kBatched ? n_cand : C);
  const int lane = kBatched ? trace * n_cand + cand : cand;
  // the lane's slot column: slot j at sl_col[j * sl_stride]
  T* const sl_col = kGlobalSlots ? slots + (active ? lane : 0) : s_sl;
  const size_t sl_stride = kGlobalSlots ? static_cast<size_t>(C) : 1;
  const int big = sizeof(T) == 2 ? (1 << 14) : (1 << 30);

  const int n_tiles = (E + kTile - 1) / kTile;
  if (n_tiles > 0) load_tile_flat(ev, stage, e_base, min(kTile, E));
  cp_async_commit();

  for (int i = threadIdx.x; i < S; i += blockDim.x)
    grp[i] = clampi(group_of[i], G);
  int sg = 0, pg = 0, rej = 0;
  if (active) {
    const size_t row = static_cast<size_t>(lane);
    for (int s = tid; s < S; s += 32) {
      s_fc[s] = fc[row * S + s];
      s_um[s] = um[row * S + s];
    }
    for (int g = tid; g < G; g += 32) s_up[g] = up[row * G + g];
    if (!kGlobalSlots)
      for (int j = tid; j < n_slots; j += 32)
        s_sl[j] = slots[static_cast<size_t>(j) * C + lane];
    sg = sgb[lane];
    pg = pgb[lane];
    rej = rejects[lane];
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int e0 = t * kTile;
    if (t + 1 < n_tiles) {
      load_tile_flat(ev, stage + ((t + 1) & 1) * 6 * kTile,
                     e_base + e0 + kTile, min(kTile, E - e0 - kTile));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, the lane state) is in place
    const int* tk = stage + (t & 1) * 6 * kTile;
    const int n = min(kTile, E - e0);
    if (active) {
      for (int i = 0; i < n; ++i) {
        const int kind = tk[i];
        if (kind != kArrive && kind != kDepart && kind != kMigrate) continue;
        const int sl = clampi(tk[kTile + i], n_slots);
        // payloads in the state's type, as the reference casts them
        const int c = static_cast<T>(tk[2 * kTile + i]);
        const int l = static_cast<T>(tk[3 * kTile + i]);
        const int p = static_cast<T>(tk[4 * kTile + i]);
        const int m = static_cast<T>(tk[5 * kTile + i]);
        if (kind == kArrive) {
          long long best1 = LLONG_MAX, best2 = LLONG_MAX;
          for (int s = tid; s < S; s += 32) {
            const int f = s_fc[s], u = s_um[s];
            const bool fits = f >= c;
            const bool ok1 =
                fits && u + l <= sg && static_cast<int>(s_up[grp[s]]) + p <= pg;
            const bool ok2 = fits && u + m <= sg;
            best1 = min(best1, static_cast<long long>(ok1 ? f : big) *
                                       4294967296LL + s);
            best2 = min(best2, static_cast<long long>(ok2 ? f : big) *
                                       4294967296LL + s);
          }
          best1 = warp_min(best1);
          bool feas1 = (best1 >> 32) < big, place = feas1;
          int sel = static_cast<int>(best1 & 0xffffffffLL);
          if (!feas1) {  // pool short -> the all-local fallback
            best2 = warp_min(best2);
            place = (best2 >> 32) < big;
            sel = static_cast<int>(best2 & 0xffffffffLL);
          }
          if (place && (sel & 31) == tid) {
            s_fc[sel] = static_cast<T>(s_fc[sel] - c);
            s_um[sel] = static_cast<T>(s_um[sel] + (feas1 ? l : m));
            if (feas1) {
              const int g = grp[sel];
              s_up[g] = static_cast<T>(s_up[g] + p);
            }
          }
          if (tid == 0)
            sl_col[sl * sl_stride] =
                static_cast<T>(place ? sel * 2 + (feas1 ? 0 : 1) : -1);
          rej += place ? 0 : 1;
        } else {
          const int val = sl_col[sl * sl_stride];
          __syncwarp();  // every thread has read the slot before it changes
          const int s = clampi(val >> 1, S);
          if (val >= 0 && (s & 31) == tid) {
            if (kind == kDepart) {
              const bool mg = (val & 1) == 1;
              s_fc[s] = static_cast<T>(s_fc[s] + c);
              s_um[s] = static_cast<T>(s_um[s] - (mg ? m : l));
              if (!mg) s_up[grp[s]] = static_cast<T>(s_up[grp[s]] - p);
            } else if (s_um[s] + p <= sg) {  // MIGRATE: pool -> local
              s_um[s] = static_cast<T>(s_um[s] + p);
              s_up[grp[s]] = static_cast<T>(s_up[grp[s]] - p);
              sl_col[sl * sl_stride] = static_cast<T>(val | 1);
            }
          }
          if (kind == kDepart && tid == 0)
            sl_col[sl * sl_stride] = static_cast<T>(-1);
        }
        __syncwarp();  // the owner's writes before the next event's reads
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  if (active) {
    const size_t row = static_cast<size_t>(lane);
    for (int s = tid; s < S; s += 32) {
      fc[row * S + s] = s_fc[s];
      um[row * S + s] = s_um[s];
    }
    for (int g = tid; g < G; g += 32) up[row * G + g] = s_up[g];
    if (!kGlobalSlots)
      for (int j = tid; j < n_slots; j += 32)
        slots[static_cast<size_t>(j) * C + lane] = s_sl[j];
    if (tid == 0) rejects[lane] = rej;
  }
}

// ----------------------------------------------------------------- launch --
struct Args {
  Events ev;
  Traces tr;
  int n_traces;
  const void *group_of, *sgb, *pgb;
  void *fc, *um, *up, *slots, *rejects;
  int C, n_cand, S, G, n_slots, lanes_per_block;
  bool global_slots;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
int launch(Kernel kern, int variant, const Args& a) {
  const size_t smem = shared_bytes(variant, a.S, a.G, a.n_slots, sizeof(T),
                                   a.lanes_per_block, a.global_slots);
  if (smem > kMaxShared) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks a trace x traces: a block never holds lanes of two traces
  const dim3 grid((a.n_cand + a.lanes_per_block - 1) / a.lanes_per_block,
                  a.n_traces);
  kern<<<grid, 32 * a.lanes_per_block, smem, a.stream>>>(
      a.ev, static_cast<const int*>(a.group_of), static_cast<T*>(a.fc),
      static_cast<T*>(a.um), static_cast<T*>(a.up), static_cast<T*>(a.slots),
      static_cast<const T*>(a.sgb), static_cast<const T*>(a.pgb),
      static_cast<int*>(a.rejects), a.tr.count[0], a.C, a.S, a.G, a.n_slots,
      a.lanes_per_block, a.n_cand, a.tr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBatched, bool kG>
int dispatch(int variant, int k, const Args& a) {
  if (variant == kShared)
    return launch<T>(sweep_shared_kernel<T, kBatched, kG>, kShared, a);
  if (variant != kRegisters || 32 * k < a.S) return -1;
  switch (k) {
    case 1:
      return launch<T>(sweep_regs_kernel<T, 1, kBatched, kG>, kRegisters, a);
    case 2:
      return launch<T>(sweep_regs_kernel<T, 2, kBatched, kG>, kRegisters, a);
    case 4:
      return launch<T>(sweep_regs_kernel<T, 4, kBatched, kG>, kRegisters, a);
    case 8:
      return launch<T>(sweep_regs_kernel<T, 8, kBatched, kG>, kRegisters, a);
    case 16:
      return launch<T>(sweep_regs_kernel<T, 16, kBatched, kG>, kRegisters, a);
    default: return -1;
  }
}

// the single-trace build when one trace starts at event 0, else the
// batched one; the slot column in shared or in global memory
template <typename T>
int dispatch_traces(int variant, int k, const Args& a) {
  const bool one = a.n_traces == 1 && a.tr.start[0] == 0;
  if (a.global_slots)
    return one ? dispatch<T, false, true>(variant, k, a)
               : dispatch<T, true, true>(variant, k, a);
  return one ? dispatch<T, false, false>(variant, k, a)
             : dispatch<T, true, false>(variant, k, a);
}

}  // namespace

// trace_start, trace_count: T host ints (trace t's events are rows
// [trace_start[t], trace_start[t] + trace_count[t]) of the E-row event
// arrays); C lanes, C / T a trace.
extern "C" int event_sweep_launch(
    const void* kind, const void* slot, const void* cores, const void* local,
    const void* pool, const void* mem, const int* trace_start,
    const int* trace_count, int T, const void* group_of, void* fc, void* um,
    void* up, void* slots, const void* sgb, const void* pgb, void* rejects,
    int E, int C, int S, int G, int n_slots, int state_bytes, int variant,
    int k, int lanes_per_block, int global_slots, void* stream) {
  if (E < 0 || T <= 0 || T > kMaxTraces || C <= 0 || C % T != 0 || S <= 0 ||
      G <= 0 || n_slots <= 0 || lanes_per_block <= 0 ||
      lanes_per_block > kMaxLanesPerBlock ||
      (global_slots != 0 && global_slots != 1))
    return -1;
  Args a{{{static_cast<const int*>(kind), static_cast<const int*>(slot),
           static_cast<const int*>(cores), static_cast<const int*>(local),
           static_cast<const int*>(pool), static_cast<const int*>(mem)}},
         {}, T, group_of, sgb, pgb, fc, um, up, slots, rejects,
         C, C / T, S, G, n_slots, lanes_per_block, global_slots == 1,
         static_cast<cudaStream_t>(stream)};
  for (int t = 0; t < T; ++t) {
    const int s = trace_start[t], n = trace_count[t];
    if (s < 0 || s % 4 != 0 || n < 0 || s > E - n) return -3;
    a.tr.start[t] = s;
    a.tr.count[t] = n;
  }
  switch (state_bytes) {
    case 2: return dispatch_traces<int16_t>(variant, k, a);
    case 4: return dispatch_traces<int32_t>(variant, k, a);
    default: return -1;
  }
}

extern "C" const char* event_sweep_error_string(int code) {
  if (code == -1)
    return "unsupported extent, trace count, lanes per block, variant, "
           "servers a thread or state type";
  if (code == -2)
    return "lane state too large for a block's shared memory (the shared "
           "variant's fc, um and up, or the slot column where it is kept "
           "in shared memory)";
  if (code == -3)
    return "a trace's events lie outside the event arrays or start off a "
           "multiple of 4 events";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
