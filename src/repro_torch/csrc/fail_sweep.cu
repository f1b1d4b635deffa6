// The failure-aware event sweep of Pond's failure layer, for sm_90a (K5).
//
// Replaces src/repro/core/sweep_core.py:333 build_fail_sweep, a lax.scan
// (not a Pallas kernel) whose step `body` (l.381) replays one trace event
// for every candidate lane (server_gb, pool_gb) at once: the plain sweep
// (K1, csrc/event_sweep.cu, whose header states ARRIVE, DEPART and MIGRATE)
// plus the Pond §4.2 failure model:
//
//   ARRIVE   as K1, but while a domain is down a pool-bearing arrival (its
//            int32 pool > 0) skips the domain's servers in the pooled test;
//            the all-local fallback is unchanged.
//   FAIL(d)  after the step's ordinary update (none: a FAIL carries VM 0's
//            slot and writes nothing there), the blast radius: every live,
//            non-migrated slot whose VM holds pool (int32 p > 0) on a server
//            of group d is affected.  "kill" frees each affected VM's cores
//            and local memory and empties its slot; "remigrate" decides per
//            server, all or nothing: when um[s] + (the int32 sum of the
//            server's affected pool) <= sgb, with um before any change of
//            this FAIL, the server's affected VMs become migrated (slot | 1,
//            um += p), else they are killed.  Then up[d] = 0 (the pool comes
//            back empty) and d is down.  Counters: affected, killed,
//            remigrated, VM-minutes lost (sum of max(dep - x, 0) over kills,
//            int32, x the FAIL's minute); optionally the affected count of
//            the f-th FAIL into row f of `dist`.
//   RECOVER(d)  d is up again.   PAD: no-op.
//
//   events    kind, slot, cores, local, pool, mem, x, dmn: eight int32 (E,)
//             (x: the VM's departure minute at ARRIVE, the failure minute at
//             FAIL; dmn: the domain at FAIL and RECOVER)
//   group_of  (S,) int32
//   fc, um    (C, S) free cores, used local GB         T, in/out
//   up        (C, G) used pool GB per group            T, in/out
//   slots     (n_slots, C) packed placement            T, in/out
//   down      (C, G) int32 down flags                  in/out
//   sgb, pgb  (C,) capacities                          T
//   arrivals  (C, n_slots) int32 scratch: the event that placed each slot
//   out       (5, C) int32 rejects, affected, killed, remigrated, lost;
//             added to
//   dist      (n_dist, C) int32 per-FAIL affected rows, or none
//
// Trace axis, state types, the in-place final state and clamped indices are
// K1's (see its header); the batched build writes no per-FAIL rows.
//
// Design: K1's registers variant (PR 15), one warp a candidate lane, thread
// t owning the K = S / 32 servers [t K, t K + K) in registers (free cores,
// or with int16 state the packed key (f + 2^15) << 9 | server; used local;
// group; a copy of up[group]), the first minimum by redux.sync with ties to
// the lowest server, predicated updates, events staged by 2-stage cp.async
// tiles, the slot column in shared memory by thread 0 (in its column of
// `slots` in global memory past shared memory's limit, kGlobalSlots).  What
// K5 adds, and why:
//
//  * The per-slot payload.  The reference carries each slot's cores, local,
//    pool and departure minute, shared by the lanes and written at every
//    ARRIVE.  Here the warps of a block walk their events independently,
//    with no barrier an event, so a block-shared payload table written
//    during the walk would race: one warp may still need a slot's earlier
//    VM while a faster one has overwritten it.  Instead thread 0 writes, at
//    ARRIVE, the arriving event's index into the lane's own column of
//    `arrivals` (a store, off the event's dependent chain), and a FAIL pass
//    reads cores, local, pool and x from the event arrays at that index.
//    A lane's live slot always holds the VM of the slot's last ARRIVE (a
//    DEPART empties the slot in every lane), so the index is the payload's.
//  * The FAIL pass reads the lane's whole slot column, so all 32 threads
//    stride over it (FAIL is warp-uniform; the pass runs at FAIL events
//    only, not at every event as in the scan), kScan slots a thread at a
//    time with all their loads issued before any test.  On the H100 (256
//    servers, 1,517 slots, 6 lanes) that took a FAIL from ~12 to ~7.5 us
//    with remigrate (two strides) and from ~7 to ~5 us with kill (one);
//    also gathering the affected slots' payload loads a batch at a time
//    was slower (scripts/torch_k1_ab.py --kernel k5, against copies).
//    Remigrate sums each server's affected pool into a per-lane int32
//    array in shared memory by atomicAdd (integer sums: the order does not
//    matter); each server's
//    owner decides "fits" from its own um (before any change) and writes the
//    flag back; a second stride applies kill or remigrate to the slots and
//    sums the cores and local-memory deltas per server the same way; the
//    owners fold them into their registers.  __syncwarp orders the stages
//    and makes thread 0's slot and arrival writes visible to the warp.
//  * Down flags are the same in every lane but, again, the warps are not in
//    step, so each thread keeps them as one bit a server of its own (a
//    K-bit mask), set at FAIL and cleared at RECOVER for the servers of the
//    domain: no bound on the number of groups.  They start from the lane's
//    row of `down`, which thread 0 keeps up to date at FAIL and RECOVER (so
//    a group without servers ends as the plain version leaves it).
//  * The counters are per-thread partial sums, reduced by __reduce_add_sync
//    once at the end (and once a FAIL for a per-FAIL row).
//
// Bound.  As K1: a sweep takes E dependent steps (each best fit reads every
// earlier placement), and the card's rates give a far lower floor: K1's 18
// int32 operations a (ARRIVE, lane, server) plus, a FAIL, the two passes
// over the slot column (a few operations a (slot, lane)); bytes: the events
// and the state once.  So the time is the per-event dependency chain's,
// plus n_FAIL passes of n_slots / 32 slots a thread.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kArrive = 0, kDepart = 1, kMigrate = 2, kFail = 4, kRecover = 5;
constexpr int kTile = 1024;        // events a stage
constexpr int kStages = 2;
constexpr int kStaged = 6;         // arrays staged: kind .. mem (not x, dmn)
constexpr int kMaxLanesPerBlock = 8;
constexpr int kMaxTraces = 256;     // traces a launch (the table below)
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr int kMaxK = 16;           // servers a thread
constexpr int kIndexBits = 9;       // packed key: server index bits
constexpr int kScoreOffset = 1 << 15;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of a block: the event stages, group_of, then one region a
// lane: its slot column in T (none when it lies in global memory), then
// three int32 arrays of S for the FAIL pass.  kernel.py::shared_bytes
// computes the same.
__host__ __device__ size_t lane_bytes(int S, int n_slots, int item,
                                      bool global_slots) {
  return round16(static_cast<size_t>(global_slots ? 0 : n_slots) * item) +
         round16(static_cast<size_t>(3) * S * 4);
}
__host__ __device__ size_t shared_bytes(int S, int n_slots, int item,
                                        int lanes, bool global_slots) {
  return static_cast<size_t>(kStages) * kStaged * kTile * 4 +
         round16(static_cast<size_t>(S) * 4) +
         lanes * lane_bytes(S, n_slots, item, global_slots);
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
  const int* a[8];  // kind, slot, cores, local, pool, mem, x, dmn
};

// Where each trace's events lie in the event arrays (as K1's).
struct Traces {
  int start[kMaxTraces];  // multiples of 4
  int count[kMaxTraces];
};

// Stage events [e0, e0 + n) of the first six arrays into dst[6][kTile]; e0
// is a multiple of 4 and every array 16-byte aligned (the wrapper checks).
__device__ __forceinline__ void load_tile(const Events& ev, int* dst, int e0,
                                          int n) {
  const int n4 = n >> 2;
#pragma unroll
  for (int a = 0; a < kStaged; ++a) {
    for (int v = threadIdx.x; v < n4; v += blockDim.x)
      cp_async16(dst + a * kTile + 4 * v, ev.a[a] + e0 + 4 * v);
    for (int v = 4 * n4 + threadIdx.x; v < n; v += blockDim.x)
      cp_async4(dst + a * kTile + v, ev.a[a] + e0 + v);
  }
}

__device__ __forceinline__ const int* next_tile(const Events& ev, int* stage,
                                                int e_base, int E, int t) {
  const int e1 = (t + 1) * kTile;
  if (e1 < E) {
    load_tile(ev, stage + ((t + 1) & 1) * kStaged * kTile, e_base + e1,
              min(kTile, E - e1));
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // tile t (and, at t = 0, the lane state) is in place
  return stage + (t & 1) * kStaged * kTile;
}

__host__ __device__ constexpr unsigned packed_key(int score, int server) {
  return static_cast<unsigned>(score + kScoreOffset) << kIndexBits |
         static_cast<unsigned>(server);
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi - 1);
}

// u + x <= cap as u <= bound(cap, x), exact (see K1)
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

// A FAIL pass reads a lane's slot column kScan slots a thread at a time
// (slots j, j + 32, ..., j + 32 (kScan - 1)): every slot's value and then
// its server's group are loaded before any is tested, so the loads of a
// batch are in flight together instead of one dependent pair a slot.
// Returns the batch's slots that hold a live, non-migrated VM on a server
// of group d, as bits; their values and servers in v and srv.
constexpr int kScan = 8;
template <typename T>
__device__ __forceinline__ unsigned scan_batch(const T* sl_col,
                                               size_t stride,
                                               const int* grp_s, int S,
                                               int n_slots, int j, int d,
                                               int (&v)[kScan],
                                               int (&srv)[kScan]) {
#pragma unroll
  for (int b = 0; b < kScan; ++b) {
    const int jb = j + 32 * b;
    v[b] = jb < n_slots ? static_cast<int>(sl_col[jb * stride]) : -1;
  }
  unsigned hit = 0;
#pragma unroll
  for (int b = 0; b < kScan; ++b) {
    srv[b] = clampi(v[b] >> 1, S);
    const int gb = grp_s[srv[b]];
    hit |= (v[b] >= 0 && !(v[b] & 1) && gb == d ? 1u : 0u) << b;
  }
  return hit;
}

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
    fail_sweep_kernel(Events ev, const int* __restrict__ group_of,
                      T* __restrict__ fc, T* __restrict__ um,
                      T* __restrict__ up, T* __restrict__ slots,
                      int* __restrict__ down, const T* __restrict__ sgb,
                      const T* __restrict__ pgb, int* __restrict__ arrivals,
                      int* __restrict__ out, int* __restrict__ dist,
                      int n_dist, int remigrate, int E_one, int C, int S,
                      int G, int n_slots, int lanes_per_block, int n_cand,
                      const __grid_constant__ Traces tr) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  int* grp_s = stage + kStages * kStaged * kTile;
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  unsigned char* mine = reinterpret_cast<unsigned char*>(grp_s) +
                        round16(static_cast<size_t>(S) * 4) +
                        warp * lane_bytes(S, n_slots, sizeof(T), kGlobalSlots);
  T* s_sl = reinterpret_cast<T*>(mine);
  // the FAIL pass's per-server int32 sums: pool demand (then the "fits"
  // flag), cores and local memory returned
  int* dem = reinterpret_cast<int*>(
      mine + round16(static_cast<size_t>(kGlobalSlots ? 0 : n_slots) *
                     sizeof(T)));
  int* dcs = dem + S;
  int* dls = dcs + S;
  const int trace = kBatched ? blockIdx.y : 0;
  const int e_base = kBatched ? tr.start[trace] : 0;
  const int E = kBatched ? tr.count[trace] : E_one;
  const int cand = blockIdx.x * lanes_per_block + warp;
  const bool active = cand < (kBatched ? n_cand : C);
  const int lane = kBatched ? trace * n_cand + cand : cand;
  T* const sl_col = kGlobalSlots ? slots + (active ? lane : 0) : s_sl;
  const size_t sl_stride = kGlobalSlots ? static_cast<size_t>(C) : 1;
  int* const arr_col =
      arrivals + static_cast<size_t>(active ? lane : 0) * n_slots;
  constexpr int big = sizeof(T) == 2 ? (1 << 14) : (1 << 30);
  constexpr bool kPacked = sizeof(T) == 2;
  static_assert(32 * kMaxK <= (1 << kIndexBits), "packed key's index bits");
  static_assert(kMaxK <= 32, "a thread's down flags are one 32-bit mask");
  constexpr unsigned kNone = packed_key(big, 0);
  const int base = tid * K;
  const int* const cores_ev = ev.a[2];
  const int* const local_ev = ev.a[3];
  const int* const pool_ev = ev.a[4];
  const int* const x_ev = ev.a[6];
  const int* const dmn_ev = ev.a[7];

  if (E > 0) load_tile(ev, stage, e_base, min(kTile, E));
  cp_async_commit();
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    grp_s[i] = clampi(group_of[i], G);

  // Thread tid's servers base .. base + K - 1 (see K1); dn bit j: server
  // base + j's domain is down.  A pad server past S never fits and belongs
  // to no group.
  int fk[K], u[K], g[K], q[K];
  unsigned dn = 0;
  int sg = 0, pg = 0, rej = 0;
  // partial counters of this thread: affected, killed, remigrated, lost
  unsigned n_aff = 0, n_kill = 0, n_rem = 0, lost = 0;
  int n_fail = 0;  // FAIL events so far (warp-uniform): the dist row
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
      dn |= (down[row * G + g[j]] != 0 ? 1u : 0u) << j;
    }
    fk[j] = kPacked ? static_cast<int>(packed_key(f, s)) : f;
  }
  if (active) {
    if (!kGlobalSlots)
      for (int j = tid; j < n_slots; j += 32)
        s_sl[j] = slots[static_cast<size_t>(j) * C + lane];
    sg = sgb[lane];
    pg = pgb[lane];
    rej = out[lane];
  }

  for (int t = 0; t * kTile < E; ++t) {
    const int* tk = next_tile(ev, stage, e_base, E, t);
    const int n = active ? min(kTile, E - t * kTile) : 0;
    int kind, sl, ec, el, ep, em;
    read_event(tk, 0, kind, sl, ec, el, ep, em);
    for (int i = 0; i < n; ++i) {
      const int cur_kind = kind, slot = clampi(sl, n_slots);
      const int pi = ep;  // the int32 pool: the down-domain test's
      const int c = static_cast<T>(ec), l = static_cast<T>(el),
                p = static_cast<T>(ep), m = static_cast<T>(em);
      const int nx = min(i + 1, n - 1);
      const int dk = kPacked ? c * (1 << kIndexBits) : c;
      const int e = e_base + t * kTile + i;  // this event's index
      if (cur_kind == kArrive) {
        const int need = kPacked ? static_cast<int>(packed_key(c, 0)) : c;
        const int room_l = bound<T>(sg, l), room_m = bound<T>(sg, m),
                  room_p = bound<T>(pg, p);
        // servers a pool-bearing arrival may take: those whose domain is up
        const unsigned up_ok = pi == 0 ? 0xffffffffu : ~dn;
        read_event(tk, nx, kind, sl, ec, el, ep, em);
        int sel, feas1, place;
        if constexpr (kPacked) {
          unsigned k1[K], k2[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const bool fits = fk[j] >= need;
            const unsigned key = static_cast<unsigned>(fk[j]);
            k1[j] = fits & (u[j] <= room_l) & (q[j] <= room_p) &
                            ((up_ok >> j) & 1u)
                        ? key
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
            b1[j] = fits & (u[j] <= room_l) & (q[j] <= room_p) &
                            ((up_ok >> j) & 1u)
                        ? fk[j]
                        : big;
            b2[j] = fits & (u[j] <= room_m) ? fk[j] : big;
            i1[j] = i2[j] = base + j;
          }
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
        const int gs = place & feas1 ? grp_s[sel] : INT_MIN;
        const int hit = place ? sel - base : -1;
        const int dl = feas1 ? l : m;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          add2_where(fk[j], u[j], hit, j, -dk, dl);
          add_where(q[j], g[j], gs, p);
        }
        rej += place ? 0 : 1;
        if (tid == 0) {
          sl_col[slot * sl_stride] =
              static_cast<T>(place ? sel * 2 + (feas1 ? 0 : 1) : -1);
          arr_col[slot] = e;  // the slot's payload lies at event e
        }
      } else if (cur_kind == kDepart || cur_kind == kMigrate) {
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
      } else if (cur_kind == kFail) {
        const int d = dmn_ev[e], xf = x_ev[e];
        read_event(tk, nx, kind, sl, ec, el, ep, em);
        for (int s = tid; s < S; s += 32) dem[s] = dcs[s] = dls[s] = 0;
        __syncwarp();  // thread 0's slot and arrival writes, the zeros
        // the affected slots: live, not migrated, pool > 0, on group d
        unsigned aff = 0;
        if (remigrate) {
          for (int j0 = 0; j0 < n_slots; j0 += 32 * kScan) {
            int v[kScan], srv[kScan];
            const unsigned hit = scan_batch(sl_col, sl_stride, grp_s, S,
                                            n_slots, j0 + tid, d, v, srv);
#pragma unroll
            for (int b = 0; b < kScan; ++b) {
              if (!((hit >> b) & 1u)) continue;
              const int pp = pool_ev[arr_col[j0 + 32 * b + tid]];
              if (pp > 0) atomicAdd(&dem[srv[b]], pp);
            }
          }
          __syncwarp();
          // each owner: does the server's free local memory (um before
          // this FAIL) take its whole affected pool?  int32, as the
          // reference sums it
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int s = base + j;
            if (s < S)
              dem[s] = static_cast<int>(static_cast<unsigned>(u[j]) +
                                        static_cast<unsigned>(dem[s])) <= sg;
          }
          __syncwarp();
        }
        for (int j0 = 0; j0 < n_slots; j0 += 32 * kScan) {
          int v[kScan], srv[kScan];
          const unsigned hit = scan_batch(sl_col, sl_stride, grp_s, S,
                                          n_slots, j0 + tid, d, v, srv);
#pragma unroll
          for (int b = 0; b < kScan; ++b) {
            if (!((hit >> b) & 1u)) continue;
            const int j = j0 + 32 * b + tid, s = srv[b];
            const int a = arr_col[j];
            const int pp = pool_ev[a];
            if (pp <= 0) continue;
            ++aff;
            if (remigrate && dem[s]) {
              sl_col[j * sl_stride] = static_cast<T>(v[b] | 1);
              atomicAdd(&dls[s], pp);
              ++n_rem;
            } else {
              sl_col[j * sl_stride] = static_cast<T>(-1);
              atomicAdd(&dcs[s], cores_ev[a]);
              atomicAdd(&dls[s], -local_ev[a]);
              ++n_kill;
              lost += static_cast<unsigned>(max(x_ev[a] - xf, 0));
            }
          }
        }
        __syncwarp();
        if (tid == 0 && d >= 0 && d < G) down[row * G + d] = 1;
        // the owners fold the deltas in; the domain's pool comes back
        // empty and the domain is down
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = base + j;
          if (s < S) {
            fk[j] += kPacked ? dcs[s] * (1 << kIndexBits) : dcs[s];
            u[j] += dls[s];
          }
          if (g[j] == d) {
            q[j] = 0;
            dn |= 1u << j;
          }
        }
        n_aff += aff;
        if (n_dist > 0) {
          const unsigned tot = __reduce_add_sync(kFull, aff);
          if (tid == 0 && n_fail < n_dist)
            dist[static_cast<size_t>(n_fail) * C + lane] =
                static_cast<int>(tot);
        }
        ++n_fail;
        __syncwarp();  // every read of the scratch before the next FAIL
      } else if (cur_kind == kRecover) {
        const int d = dmn_ev[e];
        read_event(tk, nx, kind, sl, ec, el, ep, em);
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (g[j] == d) dn &= ~(1u << j);
        if (tid == 0 && d >= 0 && d < G) down[row * G + d] = 0;
      } else {
        read_event(tk, nx, kind, sl, ec, el, ep, em);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  const unsigned aff_all = __reduce_add_sync(kFull, n_aff);
  const unsigned kill_all = __reduce_add_sync(kFull, n_kill);
  const unsigned rem_all = __reduce_add_sync(kFull, n_rem);
  const unsigned lost_all = __reduce_add_sync(kFull, lost);
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
    if (tid == 0) {
      out[lane] = rej;
      out[C + lane] += static_cast<int>(aff_all);
      out[2 * C + lane] += static_cast<int>(kill_all);
      out[3 * C + lane] += static_cast<int>(rem_all);
      out[4 * C + lane] = static_cast<int>(
          static_cast<unsigned>(out[4 * C + lane]) + lost_all);
    }
  }
}

// ----------------------------------------------------------------- launch --
struct Args {
  Events ev;
  Traces tr;
  int n_traces;
  const void *group_of, *sgb, *pgb;
  void *fc, *um, *up, *slots, *down, *arrivals, *out, *dist;
  int n_dist, remigrate;
  int C, n_cand, S, G, n_slots, lanes_per_block;
  bool global_slots;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
int launch(Kernel kern, const Args& a) {
  const size_t smem = shared_bytes(a.S, a.n_slots, sizeof(T),
                                   a.lanes_per_block, a.global_slots);
  if (smem > kMaxShared) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n_cand + a.lanes_per_block - 1) / a.lanes_per_block,
                  a.n_traces);
  kern<<<grid, 32 * a.lanes_per_block, smem, a.stream>>>(
      a.ev, static_cast<const int*>(a.group_of), static_cast<T*>(a.fc),
      static_cast<T*>(a.um), static_cast<T*>(a.up), static_cast<T*>(a.slots),
      static_cast<int*>(a.down), static_cast<const T*>(a.sgb),
      static_cast<const T*>(a.pgb), static_cast<int*>(a.arrivals),
      static_cast<int*>(a.out), static_cast<int*>(a.dist), a.n_dist,
      a.remigrate, a.tr.count[0], a.C, a.S, a.G, a.n_slots,
      a.lanes_per_block, a.n_cand, a.tr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBatched, bool kG>
int dispatch(int k, const Args& a) {
  if (32 * k < a.S) return -1;
  switch (k) {
    case 1: return launch<T>(fail_sweep_kernel<T, 1, kBatched, kG>, a);
    case 2: return launch<T>(fail_sweep_kernel<T, 2, kBatched, kG>, a);
    case 4: return launch<T>(fail_sweep_kernel<T, 4, kBatched, kG>, a);
    case 8: return launch<T>(fail_sweep_kernel<T, 8, kBatched, kG>, a);
    case 16: return launch<T>(fail_sweep_kernel<T, 16, kBatched, kG>, a);
    default: return -1;
  }
}

// the single-trace build when one trace starts at event 0, else the
// batched one; the slot column in shared or in global memory
template <typename T>
int dispatch_traces(int k, const Args& a) {
  const bool one = a.n_traces == 1 && a.tr.start[0] == 0;
  if (a.global_slots)
    return one ? dispatch<T, false, true>(k, a)
               : dispatch<T, true, true>(k, a);
  return one ? dispatch<T, false, false>(k, a)
             : dispatch<T, true, false>(k, a);
}

}  // namespace

// events: eight (E,) int32 arrays; trace_start, trace_count: T host ints;
// C lanes, C / T a trace.  dist may be null (n_dist 0); the batched build
// takes none.
extern "C" int fail_sweep_launch(
    const void* kind, const void* slot, const void* cores, const void* local,
    const void* pool, const void* mem, const void* x, const void* dmn,
    const int* trace_start, const int* trace_count, int T,
    const void* group_of, void* fc, void* um, void* up, void* slots,
    void* down, const void* sgb, const void* pgb, void* arrivals, void* out,
    void* dist, int n_dist, int remigrate, int E, int C, int S, int G,
    int n_slots, int state_bytes, int k, int lanes_per_block,
    int global_slots, void* stream) {
  if (E < 0 || T <= 0 || T > kMaxTraces || C <= 0 || C % T != 0 || S <= 0 ||
      G <= 0 || n_slots <= 0 || lanes_per_block <= 0 ||
      lanes_per_block > kMaxLanesPerBlock || k > kMaxK ||
      (global_slots != 0 && global_slots != 1) ||
      (remigrate != 0 && remigrate != 1) || n_dist < 0 ||
      (n_dist > 0 && (dist == nullptr || T != 1)))
    return -1;
  Args a{{{static_cast<const int*>(kind), static_cast<const int*>(slot),
           static_cast<const int*>(cores), static_cast<const int*>(local),
           static_cast<const int*>(pool), static_cast<const int*>(mem),
           static_cast<const int*>(x), static_cast<const int*>(dmn)}},
         {}, T, group_of, sgb, pgb, fc, um, up, slots, down, arrivals, out,
         dist, n_dist, remigrate, C, C / T, S, G, n_slots, lanes_per_block,
         global_slots == 1, static_cast<cudaStream_t>(stream)};
  for (int t = 0; t < T; ++t) {
    const int s = trace_start[t], n = trace_count[t];
    if (s < 0 || s % 4 != 0 || n < 0 || s > E - n) return -3;
    a.tr.start[t] = s;
    a.tr.count[t] = n;
  }
  switch (state_bytes) {
    case 2: return dispatch_traces<int16_t>(k, a);
    case 4: return dispatch_traces<int32_t>(k, a);
    default: return -1;
  }
}

extern "C" const char* fail_sweep_error_string(int code) {
  if (code == -1)
    return "unsupported extent, trace count, lanes per block, servers a "
           "thread, state type, mitigation or per-failure rows";
  if (code == -2)
    return "lane state too large for a block's shared memory (the slot "
           "column where it is kept in shared memory, or the FAIL pass's "
           "per-server sums)";
  if (code == -3)
    return "a trace's events lie outside the event arrays or start off a "
           "multiple of 4 events";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
