// The multi-pod fleet sweep of Pond's topology study, for sm_90a (K4).
//
// Replaces src/repro/core/sweep_core.py:566 build_pod_sweep, a lax.scan
// (not a Pallas kernel) whose step `body` (l.610) replays one trace event
// for every candidate lane at once.  A lane is a (server_gb, per-pod
// pool_gb, topology) triple: the plain sweep (K1, csrc/event_sweep.cu) with
// the per-group used pool replaced by a per-POD one and the group map by a
// per-lane incidence `inc`, row (c, s) listing the pods server s reaches in
// lane c's topology, in preference order, -1 padded:
//
//   ARRIVE   a server is pool-admissible when fc >= c, um + l <= sgb and
//            (the int32 pool is 0, or some listed pod has up + p <= pgb);
//            best fit by free cores, first minimum, ties to the lowest
//            server; else the all-local fallback (um + m <= sgb); else a
//            reject.  The granting pod is the FIRST listed pod with room on
//            the chosen server, recorded only for a pooled admission of a
//            VM whose int32 pool is > 0 (else -1).
//   DEPART   returns cores and local memory (m if migrated, else l), and p
//            to the RECORDED pod (nothing for a migrated VM or one the
//            fallback placed); the slot and its pod empty.
//   MIGRATE  the scalar oracle's quirk: a placed VM with um[s] + p <= sgb
//            moves p to local memory, with no migrated-set check; p goes
//            back to the recorded pod, or, with none, to the server's FIRST
//            listed pod; an orphan server (no pod) pays nothing, the local
//            move still happens.  Used pool may go negative (not clamped);
//            the slot keeps its pod, so a second MIGRATE pays it again.
//   PAD, FAIL, RECOVER are no-ops.
//
//   events    kind, slot, cores, local, pool, mem: six int32 (E,)
//   inc       (C, S, F) int32 per-lane incidence, -1 padded
//   fc, um    (C, S) free cores, used local GB         T, in/out
//   up        (C, P) used pool GB per pod              T, in/out
//   slots     (n_slots, C) packed placement            T, in/out
//   pods      (n_slots, C) each slot's granting pod    T, in/out
//   sgb       (C,) server capacities                   T
//   pgb       (C, P) pod capacities                    T
//   rejects   (C,) int32, added to                     in/out
//
// Slot values pack server * 2 + migrated, -1 for empty.  The trace axis,
// the state types, the in-place final state and clamped indices are K1's
// (see its header).  Incidence entries outside [0, P) are treated as -1
// (the wrapper refuses them).
//
// Design: K1's registers variant (PR 15), as K5's: one warp a candidate
// lane, thread t owning the K = S / 32 servers [t K, t K + K) in registers
// (free cores, or with int16 state the packed key (f + 2^15) << 9 | server;
// used local), the first minimum by redux.sync with ties to the lowest
// server, warp-uniform predicated updates, events staged by 2-stage
// cp.async tiles.  What K4 adds, and why:
//
//  * A table of the thread's distinct pods.  A thread's K servers
//    list few distinct pods (at most 6 at 256 servers in fig_topology's
//    eight topologies, against K x F = 24 entries), so each thread keeps
//    one entry a distinct pod: its id (-1 empty) and its FREE pool, pgb -
//    up, in int32, D entries (template D: 1, 8 or the catch-all kMaxF x K,
//    the least that holds the launch's widest thread; the wrapper counts it
//    and the kernel traps past D, never writing a wrong result).  For each
//    server it keeps its row as table entries in list order, packed in one
//    word (Row): with 3 D <= 30 a D-bit one-hot field a listed pod, the
//    first listed in the top field, and bit 31 set; else an 8-bit index a
//    listed pod, beside a mask of the row's entries.  In int32 the free
//    pool is exact while |pgb|, |up| <= 2^30 (the host clips capacities
//    there).
//  * ARRIVE builds the fit mask (free >= p; one-hot rows: copied into
//    each field), and a server is pool-admissible when its row meets it
//    (bit 31 meets a pool-free VM's all-ones mask): one logical op a
//    server before the best fit.  After the redux.sync only the chosen
//    server's row is decoded, by its owner: the first listed entry with
//    room is the highest set bit of row & fit (one FLO), its id a tree of
//    selects over the table, broadcast by one __shfl_sync.  MIGRATE
//    decodes the row's first entry the same way.  A grant, a DEPART's
//    return and a MIGRATE's return add to the D entries whose id is the
//    warp-uniform target pod, so every copy of a pod in the warp stays
//    equal.  The design before it kept the id and the free pool of
//    every (server, fanout entry), K x F of each, tested them all at an
//    ARRIVE and updated them all at every event; finding each server's
//    grant before the best fit, as it did, costs more instructions than
//    the decode after it saves (scripts/torch_k1_ab.py --kernel k4 on an
//    H100; PERF.md section 6).
//  * DEPART and MIGRATE read the slot and its pod (thread 0) and broadcast
//    both in one __shfl_sync with int16 state (two halves of a word).
//  * The recorded pod.  Per-slot data that a lane reads later cannot sit in
//    a block-shared table, because a block's warps are not in step (K5's
//    lesson), so each lane keeps a second column beside its slot column,
//    written and read by thread 0: in shared memory while both fit, in the
//    lane's columns of `slots` and `pods` in global memory past the limit
//    (kGlobalSlots).
//
// Bound.  As K1: a sweep takes E dependent steps (each best fit reads every
// earlier placement); the card's rates give a far lower floor, K1's 18
// int32 operations a (ARRIVE, lane, server) plus the F pod fits, and the
// events and the state once in bytes.  So the time is the per-event
// dependency chain's and the instructions it issues.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kArrive = 0, kDepart = 1, kMigrate = 2;
constexpr int kTile = 1024;        // events a stage
constexpr int kStages = 2;
constexpr int kStaged = 6;         // arrays staged: kind .. mem
constexpr int kMaxLanesPerBlock = 8;
constexpr int kMaxTraces = 256;     // traces a launch (the table below)
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr int kMaxK = 16;           // servers a thread
constexpr int kMaxF = 3;            // pods a server's row lists
constexpr int kMidD = 8;            // the table build between 1 and kMaxF K
constexpr int kIndexBits = 9;       // packed key: server index bits
constexpr int kScoreOffset = 1 << 15;
constexpr int kNoPod = INT_MIN;     // a target that no entry's id equals
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of a block: the event stages, then one region a lane: its
// slot column and its pod column in T, each rounded to 16 bytes (none when
// they lie in global memory).  kernel.py::shared_bytes computes the same.
__host__ __device__ size_t lane_bytes(int n_slots, int item,
                                      bool global_slots) {
  return global_slots ? 0
                      : 2 * round16(static_cast<size_t>(n_slots) * item);
}
__host__ __device__ size_t shared_bytes(int n_slots, int item, int lanes,
                                        bool global_slots) {
  return static_cast<size_t>(kStages) * kStaged * kTile * 4 +
         lanes * lane_bytes(n_slots, item, global_slots);
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

// Where each trace's events lie in the event arrays (as K1's).
struct Traces {
  int start[kMaxTraces];  // multiples of 4
  int count[kMaxTraces];
};

// Stage events [e0, e0 + n) into dst[6][kTile]; e0 is a multiple of 4 and
// every array 16-byte aligned (the wrapper checks).
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

// v[j] for 0 <= j < N by a tree of selects on j's bits (depth log2 N, not
// a chain of N): registers cannot be indexed by a value the warp computes
template <typename V, int N>
__device__ __forceinline__ V pick(const V (&v)[N], int j) {
  V t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) t[i] = (j & w) ? t[i + w] : t[i];
  return t[0];
}

// v[0] | ... | v[N - 1] by a tree (depth log2 N, not a chain of N)
template <typename V, int N>
__device__ __forceinline__ V or_all(const V (&v)[N]) {
  V t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) t[i] |= t[i + w];
  return t[0];
}

// A server's row as table entries in list order (see the design note).
// With kOneHot a D-bit one-hot field a listed pod, the first listed in the
// top field (field q at bit (kMaxF - 1 - q) D), so the first listed field
// with room holds the highest set bit of row & fit; bit 31 is set in every
// row (it admits a pool-free VM on any server).  Else an 8-bit entry index
// a listed pod, field q at bit 8 q, 0xff none.
template <int D>
struct Row {
  static constexpr bool kOneHot = kMaxF * D <= 30;
  static constexpr unsigned kAny = 1u << 31;
  static constexpr unsigned kEmpty = kOneHot ? kAny : 0xffffffu;
  // the fit mask copied into each field (no carries: fit < 2^D)
  static constexpr unsigned kRepeat = kOneHot
      ? (1u | 1u << D % 32 | 1u << (2 * D) % 32) : 0u;

  __device__ static unsigned with(unsigned row, int q, int at) {
    if constexpr (kOneHot)
      return row | (1u << at) << ((kMaxF - 1 - q) * D);
    else
      return (row & ~(0xffu << (8 * q))) | static_cast<unsigned>(at)
                                               << (8 * q);
  }
  // The first listed entry with room (`fits`: with kOneHot the fit mask
  // copied into each field, else the mask itself); `found` says whether
  // there is one.  The index is in [0, D) either way, so the caller
  // selects after the table lookup instead of branching around it.
  template <typename Mask>
  __device__ static int first_fit(unsigned row, Mask fits, bool& found) {
    if constexpr (kOneHot) {
      const unsigned hits = row & static_cast<unsigned>(fits);
      found = hits != 0;
      // the highest set bit's place within its field is the entry
      // (31 - __clz(0) wraps to an index in range)
      return static_cast<unsigned>(31 - __clz(hits)) % D;
    } else {
      int g = -1;
#pragma unroll
      for (int q = kMaxF - 1; q >= 0; --q) {
        const int at = (row >> (8 * q)) & 0xff;
        const bool ok = at < D && ((fits >> (at < D ? at : 0)) & 1);
        g = ok ? at : g;
      }
      found = g >= 0;
      return max(g, 0);
    }
  }
  // the row's first listed entry, as first_fit
  __device__ static int first(unsigned row, bool& found) {
    if constexpr (kOneHot) {
      const unsigned f0 = (row >> ((kMaxF - 1) * D)) & ((1u << D) - 1);
      found = f0 != 0;
      return static_cast<unsigned>(31 - __clz(f0)) % D;
    } else {
      const int at = row & 0xff;
      found = at < D;
      return found ? at : 0;
    }
  }
};

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

// (a minimum of one block an SM: ptxas may then give a thread all 255
// registers, where it otherwise holds some builds to 128 with spills)
template <typename T, int K, int D, bool kBatched, bool kGlobalSlots>
__global__ void __launch_bounds__(32 * kMaxLanesPerBlock, 1)
    pod_sweep_kernel(Events ev, const int* __restrict__ inc,
                     T* __restrict__ fc, T* __restrict__ um,
                     T* __restrict__ up, T* __restrict__ slots,
                     T* __restrict__ pods, const T* __restrict__ sgb,
                     const T* __restrict__ pgb, int* __restrict__ rejects,
                     int E_one, int C, int S, int P, int F_in, int n_slots,
                     int lanes_per_block, int n_cand,
                     const __grid_constant__ Traces tr) {
  using Mask = std::conditional_t<(D < 32), unsigned, unsigned long long>;
  using R = Row<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  unsigned char* mine = smem +
                        static_cast<size_t>(kStages) * kStaged * kTile * 4 +
                        warp * lane_bytes(n_slots, sizeof(T), kGlobalSlots);
  T* s_sl = reinterpret_cast<T*>(mine);
  T* s_pod = reinterpret_cast<T*>(
      mine + round16(static_cast<size_t>(n_slots) * sizeof(T)));
  const int trace = kBatched ? blockIdx.y : 0;
  const int e_base = kBatched ? tr.start[trace] : 0;
  const int E = kBatched ? tr.count[trace] : E_one;
  const int cand = blockIdx.x * lanes_per_block + warp;
  const bool active = cand < (kBatched ? n_cand : C);
  const int lane = kBatched ? trace * n_cand + cand : cand;
  T* const sl_col = kGlobalSlots ? slots + (active ? lane : 0) : s_sl;
  T* const pod_col = kGlobalSlots ? pods + (active ? lane : 0) : s_pod;
  const size_t stride = kGlobalSlots ? static_cast<size_t>(C) : 1;
  constexpr int big = sizeof(T) == 2 ? (1 << 14) : (1 << 30);
  constexpr bool kPacked = sizeof(T) == 2;
  static_assert(32 * kMaxK <= (1 << kIndexBits), "packed key's index bits");
  static_assert(D >= 1 && D <= kMaxF * kMaxK && D < 64, "table entries");
  constexpr unsigned kNone = packed_key(big, 0);
  const int base = tid * K;

  if (E > 0) load_tile(ev, stage, e_base, min(kTile, E));
  cp_async_commit();

  // Thread tid's servers base .. base + K - 1 (see K1), the table of the
  // distinct pods their rows list (id, free pool) and, for each server,
  // its row in list order (Row) and, for rows of 8-bit indices, a mask of
  // the entries it lists (bit D admits a pool-free VM anywhere).  A pad
  // server past S never fits and lists no pod.
  int fk[K], u[K], did[D], dfree[D];
  Mask pm[K];
  unsigned row[K];
  int sg = 0, rej = 0, n_distinct = 0;
  const size_t lrow = static_cast<size_t>(lane);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    did[d] = -1;
    dfree[d] = 0;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = base + j;
    int f = big;
    u[j] = 0;
    pm[j] = Mask(1) << D;
    row[j] = R::kEmpty;
    if (active && s < S) {
      f = fc[lrow * S + s];
      u[j] = um[lrow * S + s];
#pragma unroll
      for (int q = 0; q < kMaxF; ++q) {
        const int id =
            q < F_in ? inc[(lrow * S + s) * static_cast<size_t>(F_in) + q]
                     : -1;
        if (id >= 0 && id < P) {
          int at = -1;
#pragma unroll
          for (int d = 0; d < D; ++d) at = did[d] == id ? d : at;
          if (at < 0) {
            // more distinct pods than the build holds: stop rather than
            // drop one (the wrapper picks D from the incidence)
            if (n_distinct >= D) __trap();
            const int free = static_cast<int>(pgb[lrow * P + id]) -
                             static_cast<int>(up[lrow * P + id]);
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const bool here = d == n_distinct;
              did[d] = here ? id : did[d];
              dfree[d] = here ? free : dfree[d];
            }
            at = n_distinct++;
          }
          pm[j] |= Mask(1) << at;
          row[j] = R::with(row[j], q, at);
        }
      }
    }
    fk[j] = kPacked ? static_cast<int>(packed_key(f, s)) : f;
  }
  if (active) {
    if (!kGlobalSlots)
      for (int j = tid; j < n_slots; j += 32) {
        s_sl[j] = slots[static_cast<size_t>(j) * C + lane];
        s_pod[j] = pods[static_cast<size_t>(j) * C + lane];
      }
    sg = sgb[lane];
    rej = rejects[lane];
  }

  for (int t = 0; t * kTile < E; ++t) {
    const int* tk = next_tile(ev, stage, e_base, E, t);
    const int n = active ? min(kTile, E - t * kTile) : 0;
    int kind, sl, ec, el, ep, em;
    read_event(tk, 0, kind, sl, ec, el, ep, em);
    for (int i = 0; i < n; ++i) {
      const int cur_kind = kind, slot = clampi(sl, n_slots);
      const int pi = ep;  // the int32 pool: the pool-free and grant tests'
      const int c = static_cast<T>(ec), l = static_cast<T>(el),
                p = static_cast<T>(ep), m = static_cast<T>(em);
      const int nx = min(i + 1, n - 1);
      const int dk = kPacked ? c * (1 << kIndexBits) : c;
      if (cur_kind == kArrive) {
        const int need = kPacked ? static_cast<int>(packed_key(c, 0)) : c;
        const int room_l = bound<T>(sg, l), room_m = bound<T>(sg, m);
        read_event(tk, nx, kind, sl, ec, el, ep, em);
        // the table entries with room for the whole demand; a server is
        // pool-admissible when its row lists one (any server for a
        // pool-free VM): one logical op a server, before the best fit
        // (kOneHot: copied into each of a row's fields)
        Mask fit;
        if constexpr (R::kOneHot) {
          unsigned b[D];
#pragma unroll
          for (int d = 0; d < D; ++d)
            b[d] = dfree[d] >= p ? R::kRepeat << d : 0u;
          fit = or_all(b);
        } else {
          Mask b[D];
#pragma unroll
          for (int d = 0; d < D; ++d)
            b[d] = dfree[d] >= p ? Mask(1) << d : Mask(0);
          fit = or_all(b);
        }
        const Mask admit = pi == 0 ? ~Mask(0) : fit;
        bool pok[K];
#pragma unroll
        for (int j = 0; j < K; ++j)
          pok[j] = R::kOneHot ? (row[j] & static_cast<unsigned>(admit)) != 0
                              : (pm[j] & admit) != 0;
        int sel, feas1, place;
        if constexpr (kPacked) {
          unsigned k1[K], k2[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const bool fits = fk[j] >= need;
            const unsigned key = static_cast<unsigned>(fk[j]);
            k1[j] = fits & (u[j] <= room_l) & pok[j] ? key : UINT_MAX;
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
            b1[j] = fits & (u[j] <= room_l) & pok[j] ? fk[j] : big;
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
        const int hit = place ? sel - base : -1;
        // the granting pod: the chosen server's first listed entry with
        // room, decoded by its owner alone and broadcast (a pooled
        // admission's server lists one, so `found` needs no test; with
        // one entry a thread it is the table's)
        int pod = did[0];
        if constexpr (D > 1) {
          bool found;
          pod = pick(did, R::first_fit(pick(row, hit), fit, found));
        }
        int grant = __shfl_sync(kFull, pod, sel / K);
        grant = feas1 && pi > 0 ? grant : kNoPod;
        const int dl = feas1 ? l : m;
#pragma unroll
        for (int j = 0; j < K; ++j) add2_where(fk[j], u[j], hit, j, -dk, dl);
#pragma unroll
        for (int d = 0; d < D; ++d) add_where(dfree[d], did[d], grant, -p);
        rej += place ? 0 : 1;
        if (tid == 0) {
          sl_col[slot * stride] =
              static_cast<T>(place ? sel * 2 + (feas1 ? 0 : 1) : -1);
          pod_col[slot * stride] = static_cast<T>(grant == kNoPod ? -1 : grant);
        }
      } else if (cur_kind == kDepart || cur_kind == kMigrate) {
        // thread 0 reads the slot and its pod; one broadcast with int16
        // state (both halves of one word), two with int32
        int val = 0, pv = 0;
        if (tid == 0) {
          val = sl_col[slot * stride];
          pv = pod_col[slot * stride];
        }
        if constexpr (sizeof(T) == 2) {
          const int w = __shfl_sync(
              kFull,
              static_cast<int>((static_cast<unsigned>(val) & 0xffffu) |
                               static_cast<unsigned>(pv) << 16),
              0);
          val = static_cast<int16_t>(w & 0xffff);
          pv = w >> 16;
        } else {
          val = __shfl_sync(kFull, val, 0);
          pv = __shfl_sync(kFull, pv, 0);
        }
        read_event(tk, nx, kind, sl, ec, el, ep, em);
        const int s = clampi(val >> 1, S);
        const int hit = val >= 0 ? s - base : -1;
        if (cur_kind == kDepart) {
          const bool mg = (val & 1) == 1;
          const int dm = mg ? m : l;
          const int tgt = val >= 0 && !mg && pv >= 0 ? pv : kNoPod;
#pragma unroll
          for (int j = 0; j < K; ++j) add2_where(fk[j], u[j], hit, j, dk, -dm);
#pragma unroll
          for (int d = 0; d < D; ++d) add_where(dfree[d], did[d], tgt, p);
          if (tid == 0) {
            sl_col[slot * stride] = static_cast<T>(-1);
            pod_col[slot * stride] = static_cast<T>(-1);
          }
        } else {  // MIGRATE: pool -> local when the local memory takes it
          const int room = bound<T>(sg, p);
          // the owner's (first listed pod << 1) | local room, broadcast
          bool found;
          const int at = R::first(pick(row, hit), found);
          const int pod = pick(did, at);
          const int info = (found ? pod : -1) * 2 +
                           (pick(u, hit) <= room ? 1 : 0);
          const int got = __shfl_sync(kFull, info, s / K);
          const bool act = val >= 0 && (got & 1);
          const int first = got >> 1;  // arithmetic: -1 stays -1
          const int tgt = !act ? kNoPod
                          : pv >= 0 ? pv
                          : first >= 0 ? first
                                       : kNoPod;
#pragma unroll
          for (int j = 0; j < K; ++j) add_where(u[j], act ? hit : -1, j, p);
#pragma unroll
          for (int d = 0; d < D; ++d) add_where(dfree[d], did[d], tgt, p);
          if (tid == 0 && act)
            sl_col[slot * stride] = static_cast<T>(val | 1);
        }
      } else {  // PAD, FAIL, RECOVER
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
        fc[lrow * S + s] = static_cast<T>(f);
        um[lrow * S + s] = static_cast<T>(u[j]);
      }
    }
    // every thread listing a pod holds the same copy of its free pool
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (did[d] >= 0)
        up[lrow * P + did[d]] = static_cast<T>(
            static_cast<int>(pgb[lrow * P + did[d]]) - dfree[d]);
    if (!kGlobalSlots)
      for (int j = tid; j < n_slots; j += 32) {
        slots[static_cast<size_t>(j) * C + lane] = s_sl[j];
        pods[static_cast<size_t>(j) * C + lane] = s_pod[j];
      }
    if (tid == 0) rejects[lane] = rej;
  }
}

// ----------------------------------------------------------------- launch --
struct Args {
  Events ev;
  Traces tr;
  int n_traces;
  const void *inc, *sgb, *pgb;
  void *fc, *um, *up, *slots, *pods, *rejects;
  int C, n_cand, S, P, F, n_slots, lanes_per_block;
  bool global_slots;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
int launch(Kernel kern, const Args& a) {
  const size_t smem = shared_bytes(a.n_slots, sizeof(T), a.lanes_per_block,
                                   a.global_slots);
  if (smem > kMaxShared) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n_cand + a.lanes_per_block - 1) / a.lanes_per_block,
                  a.n_traces);
  kern<<<grid, 32 * a.lanes_per_block, smem, a.stream>>>(
      a.ev, static_cast<const int*>(a.inc), static_cast<T*>(a.fc),
      static_cast<T*>(a.um), static_cast<T*>(a.up), static_cast<T*>(a.slots),
      static_cast<T*>(a.pods), static_cast<const T*>(a.sgb),
      static_cast<const T*>(a.pgb), static_cast<int*>(a.rejects),
      a.tr.count[0], a.C, a.S, a.P, a.F, a.n_slots, a.lanes_per_block,
      a.n_cand, a.tr);
  return static_cast<int>(cudaGetLastError());
}

// the table builds: 1 entry (a pod a thread: partitioned rows of 8 or
// more servers, one pool), kMidD (fig_topology's mixed grid) and the
// catch-all kMaxF x K, which holds any thread
template <typename T, int K, bool kBatched, bool kG>
int by_distinct(int kd, const Args& a) {
  constexpr int kAll = kMaxF * K;
  if (kd == 1) return launch<T>(pod_sweep_kernel<T, K, 1, kBatched, kG>, a);
  if constexpr (kMidD < kAll)
    if (kd == kMidD)
      return launch<T>(pod_sweep_kernel<T, K, kMidD, kBatched, kG>, a);
  if (kd == kAll)
    return launch<T>(pod_sweep_kernel<T, K, kAll, kBatched, kG>, a);
  return -1;
}

template <typename T, bool kBatched, bool kG>
int dispatch(int k, int kd, const Args& a) {
  if (32 * k < a.S) return -1;
  switch (k) {
    case 1: return by_distinct<T, 1, kBatched, kG>(kd, a);
    case 2: return by_distinct<T, 2, kBatched, kG>(kd, a);
    case 4: return by_distinct<T, 4, kBatched, kG>(kd, a);
    case 8: return by_distinct<T, 8, kBatched, kG>(kd, a);
    case 16: return by_distinct<T, 16, kBatched, kG>(kd, a);
    default: return -1;
  }
}

// the single-trace build when one trace starts at event 0, else the
// batched one; the slot and pod columns in shared or in global memory
template <typename T>
int dispatch_traces(int k, int kd, const Args& a) {
  const bool one = a.n_traces == 1 && a.tr.start[0] == 0;
  if (a.global_slots)
    return one ? dispatch<T, false, true>(k, kd, a)
               : dispatch<T, true, true>(k, kd, a);
  return one ? dispatch<T, false, false>(k, kd, a)
             : dispatch<T, true, false>(k, kd, a);
}

}  // namespace

// events: six (E,) int32 arrays; trace_start, trace_count: T host ints;
// C lanes, C / T a trace; inc (C, S, F) int32; kd the table build (entries
// a thread).
extern "C" int pod_sweep_launch(
    const void* kind, const void* slot, const void* cores, const void* local,
    const void* pool, const void* mem, const int* trace_start,
    const int* trace_count, int T, const void* inc, void* fc, void* um,
    void* up, void* slots, void* pods, const void* sgb, const void* pgb,
    void* rejects, int E, int C, int S, int P, int F, int n_slots,
    int state_bytes, int k, int kd, int lanes_per_block, int global_slots,
    void* stream) {
  if (E < 0 || T <= 0 || T > kMaxTraces || C <= 0 || C % T != 0 || S <= 0 ||
      P <= 0 || F <= 0 || F > kMaxF || n_slots <= 0 ||
      lanes_per_block <= 0 || lanes_per_block > kMaxLanesPerBlock ||
      k > kMaxK || (global_slots != 0 && global_slots != 1))
    return -1;
  Args a{{{static_cast<const int*>(kind), static_cast<const int*>(slot),
           static_cast<const int*>(cores), static_cast<const int*>(local),
           static_cast<const int*>(pool), static_cast<const int*>(mem)}},
         {}, T, inc, sgb, pgb, fc, um, up, slots, pods, rejects, C, C / T, S,
         P, F, n_slots, lanes_per_block, global_slots == 1,
         static_cast<cudaStream_t>(stream)};
  for (int t = 0; t < T; ++t) {
    const int s = trace_start[t], n = trace_count[t];
    if (s < 0 || s % 4 != 0 || n < 0 || s > E - n) return -3;
    a.tr.start[t] = s;
    a.tr.count[t] = n;
  }
  switch (state_bytes) {
    case 2: return dispatch_traces<int16_t>(k, kd, a);
    case 4: return dispatch_traces<int32_t>(k, kd, a);
    default: return -1;
  }
}

extern "C" const char* pod_sweep_error_string(int code) {
  if (code == -1)
    return "unsupported extent, trace count, lanes per block, servers a "
           "thread, fanout, table build or state type";
  if (code == -2)
    return "the slot and pod columns too large for a block's shared memory";
  if (code == -3)
    return "a trace's events lie outside the event arrays or start off a "
           "multiple of 4 events";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
