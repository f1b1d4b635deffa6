// The zNUMA spill sweep of Pond's latency engine, for sm_90a (K6).
//
// Replaces src/repro/core/latency_engine.py:253 _build_spill_sweep, a
// lax.scan (not a Pallas kernel) whose step `body` (l.258) replays one
// alloc/free event of a paged memory stream for every config lane
// (num_local, num_pool) at once, K streams batched.  It computes exactly
// that step, event after event:
//
//   ALLOC  takes local memory while the lane has some (free_l > 0), else
//          the pool while it has some (free_p > 0), else fails and leaves
//          the key's tier as it was; the key's tier becomes 0 or 1.
//   FREE   returns the key's tier (0 local, 1 pool) and unbinds the key
//          (-1); a FREE of an unbound key changes no counter.
//   PAD and any other kind are no-ops.
//
// Counters: allocs (successful), pool_allocs, failed; local_in_use and
// pool_in_use are the tier sizes less the free counts at the end.  All
// state is integer, so the kernel is exact (held with ==).
//
// The linked form.  A key's tier before event i is its tier after the
// previous ALLOC or FREE of the same key in the stream, prev[i], or -1
// when there is none.  prev depends on the stream alone, not on a lane,
// so the links pass (spill_links_kernel, after a stable sort of each
// stream's keys) computes it once a launch, with last[key], the index of
// a key's last ALLOC or FREE.  The sweep then keeps out[i], the key's
// tier after event i, for every event, and never addresses a tier map:
//
//   in = prev[i] >= 0 ? out[prev[i]] : -1
//   ALLOC  out[i] = took local ? 0 : took pool ? 1 : in
//   FREE   free_l += in == 0, free_p += in == 1, out[i] = -1
//
// and the final map is out[last[key]], written by spill_map_kernel in
// one parallel pass (-1 where last is -1).
//
// Design.  One warp a (stream, group of 32 lanes): the free counters and
// counters live in registers, one lane a thread.  A warp replays one
// stream, so an event's kind is the same on every thread.  out[i] of a
// warp is two ballot words, (bound, pool): tier -1 is (0, 0), 0 is
// (1, 0), 1 is (1, 1); lanes past C have no memory and vote 0.  A block
// holds warps of one stream (blockIdx.y) and stages that stream's kinds
// and links in shared memory in tiles of `tile` events, two stages filled
// by 16-byte cp.async (K1's staging).  For each tile, each warp:
//   1. fetches, by cp.async with all 32 threads and no dependent load,
//      the words of every link that lies before the tile from its row of
//      the word array `words` (K, groups, E) in global memory into its
//      buffer's second half (a zero word for no link);
//   2. walks the tile serially: event j reads `in` from shared memory,
//      the fetched word or the word an earlier event of the tile wrote
//      into the buffer's first half, and writes its own word there;
//   3. copies the tile's words to `words`, coalesced, for later tiles.
// So no load in the walk goes to global memory, and none is on the
// chain: a block pass turns each event's link into its word's slot in
// the warp's buffer, and the walk reads event j + 3's kind, j + 4's slot
// and j + 1's word while it replays event j, before event j stores its
// word, taking event j's word from registers when it is the link (the one
// case such an early read misses).  The event's logic is
// PTX (step, pick): predicates, predicated adds, two ballots.
//
// Bound.  Each event reads the free counters the previous one left, so a
// lane is a chain of E steps, but the chain of one step is short: three
// dependent instructions a free counter (a compare, then two predicated
// adds); spill_chain_kernel replays that chain alone, and chip_smoke.py
// times it as the chain floor.  What bounds the walk is instruction
// throughput: a lone warp starts an integer instruction every two cycles
// (an SM sub-partition has 16 INT32 lanes), and the walk's loop is 260 SASS
// instructions for 8 events (compares, predicate logic, predicated adds,
// two ballots, the staged reads and the store), ~65 cycles an event on the
// H100; a stream of PADs alone takes as long, so the kind of event does
// not matter.  The card's rates (a few int32 operations per event and
// lane; the events and the tier map moved once) allow far less.  A design
// that addresses a tier map in device memory instead puts a dependent L2
// load on the chain at every FREE (~280 cycles an event on the H100): the
// reason for the linked form.
//
//   kind, prev  (K, E) int32 event kinds and links, E a multiple of 4
//   last        (K, n_keys) int32
//   num_local, num_pool   (C,) int32 config lanes
//   words       (K, groups, E) uint2 scratch, groups = ceil(C / 32)
//   tier        (K, n_keys, C) int8: each key's tier on exit
//   out         (5, K, C) int32: allocs, pool_allocs, failed,
//               local_in_use, pool_in_use

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlloc = 0, kFree = 1;
constexpr int kMaxTile = 2048;  // events a stage
constexpr int kStages = 2;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxStreams = 65535;  // gridDim.y
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

constexpr int kAhead = 4;  // events the walk reads ahead (slack after a tile)

// Shared memory of a block: two stages of kinds and links (int32), each
// event's word slot (int32, tile + kAhead), then a buffer of 2 tile words
// (8 bytes) a warp.  kernel.py::shared_bytes computes the same.
__host__ __device__ size_t shared_bytes(int tile, int warps) {
  return static_cast<size_t>(kStages) * 2 * tile * 4 +
         static_cast<size_t>(tile + kAhead) * 4 +
         static_cast<size_t>(warps) * 2 * tile * 8;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
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

// Stage events [e0, e0 + n) of a stream's kind and prev rows into
// dst[0 .. tile) and dst[tile .. 2 tile); e0 is a multiple of 4 and the
// rows 16-byte aligned (E a multiple of 4, the wrapper's layout).
__device__ __forceinline__ void load_tile(const int* kind, const int* prev,
                                          int* dst, int tile, int e0, int n) {
  const int n4 = n >> 2;
  for (int v = threadIdx.x; v < n4; v += blockDim.x) {
    cp_async16(dst + 4 * v, kind + e0 + 4 * v);
    cp_async16(dst + tile + 4 * v, prev + e0 + 4 * v);
  }
  for (int v = 4 * n4 + threadIdx.x; v < n; v += blockDim.x) {
    cp_async4(dst + v, kind + e0 + v);
    cp_async4(dst + tile + v, prev + e0 + v);
  }
}

// One event of one lane, in PTX so that every condition stays a predicate
// and every update is one predicated add: kd is the event's kind (the
// warp's), (wx, wy) the key's tier before it as a word pair of which this
// lane reads its `bit`; updates the free counters and the lane's local and
// pool allocations; returns the warp's word pair after the event.
//   ALLOC  tl = free_l > 0, tp = !tl & free_p > 0; out (1, tp) if either,
//          else the old tier
//   FREE   returns the old tier's memory; out (0, 0)
//   other  out is not defined (a no-op is never a link)
__device__ __forceinline__ uint2 step(int kd, unsigned wx, unsigned wy,
                                      unsigned bit, int& free_l, int& free_p,
                                      int& local, int& pool) {
  unsigned ox, oy;
  asm("{\n\t"
      ".reg .pred pa, pf, pb, pq, tl, nt, tp, fl, fq, nb, nq;\n\t"
      ".reg .b32 t;\n\t"
      "setp.eq.s32 pa, %6, %10;\n\t"
      "setp.eq.s32 pf, %6, %11;\n\t"
      "and.b32 t, %7, %9;\n\t"
      "setp.ne.b32 pb, t, 0;\n\t"
      "and.b32 t, %8, %9;\n\t"
      "setp.ne.b32 pq, t, 0;\n\t"
      "setp.gt.and.s32 tl|nt, %2, 0, pa;\n\t"
      "setp.gt.and.s32 tp, %3, 0, nt;\n\t"
      "and.pred fl, pf, pb;\n\t"
      "and.pred fl, fl, !pq;\n\t"
      "and.pred fq, pf, pq;\n\t"
      "@tl sub.s32 %2, %2, 1;\n\t"
      "@fl add.s32 %2, %2, 1;\n\t"
      "@tp sub.s32 %3, %3, 1;\n\t"
      "@fq add.s32 %3, %3, 1;\n\t"
      "@tl add.s32 %4, %4, 1;\n\t"
      "@tp add.s32 %5, %5, 1;\n\t"
      // nb = !FREE & (old bound | took); nq = !FREE & (tp | old pool & !tl)
      "or.pred nb, pb, tl;\n\t"
      "or.pred nb, nb, tp;\n\t"
      "and.pred nb, nb, !pf;\n\t"
      "and.pred nq, pq, !tl;\n\t"
      "or.pred nq, nq, tp;\n\t"
      "and.pred nq, nq, !pf;\n\t"
      "vote.sync.ballot.b32 %0, nb, 0xffffffff;\n\t"
      "vote.sync.ballot.b32 %1, nq, 0xffffffff;\n\t"
      "}"
      : "=r"(ox), "=r"(oy), "+r"(free_l), "+r"(free_p), "+r"(local),
        "+r"(pool)
      : "r"(kd), "r"(wx), "r"(wy), "r"(bit), "n"(kAlloc), "n"(kFree));
  return make_uint2(ox, oy);
}

// The word of a link: this event's word o when the link's slot is j (the
// event just replayed), else the word read early, raw; selects, not a
// branch.
__device__ __forceinline__ uint2 pick(int slot, int j, uint2 o, uint2 raw) {
  uint2 w;
  asm("{\n\t.reg .pred a;\n\t"
      "setp.eq.s32 a, %2, %3;\n\t"
      "selp.b32 %0, %4, %6, a;\n\t"
      "selp.b32 %1, %5, %7, a;\n\t}"
      : "=&r"(w.x), "=&r"(w.y)
      : "r"(slot), "r"(j), "r"(o.x), "r"(o.y), "r"(raw.x), "r"(raw.y));
  return w;
}

__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
    spill_sweep_kernel(const int* __restrict__ kind,
                       const int* __restrict__ prev,
                       const int* __restrict__ num_local,
                       const int* __restrict__ num_pool,
                       uint2* __restrict__ words, int* __restrict__ out,
                       int E, int C, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  // each event's word slot in a warp's buffer; this warp's buffer: [0,
  // tile) the tile's words, [tile, 2 tile) the fetched words of its links
  // before the tile
  int* slot = stage + kStages * 2 * tile;
  uint2* buf = reinterpret_cast<uint2*>(slot + tile + kAhead) +
               static_cast<size_t>(warp) * 2 * tile;
  const int stream = blockIdx.y;
  const int groups = (C + 31) / 32;
  const int group = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool live = group < groups;  // the same for the whole warp
  const int lane = group * 32 + tid;
  const bool active = live && lane < C;
  const int* kind_s = kind + static_cast<size_t>(stream) * E;
  const int* prev_s = prev + static_cast<size_t>(stream) * E;
  uint2* wrow = words + (static_cast<size_t>(stream) * groups +
                         (live ? group : 0)) * E;
  const unsigned bit = 1u << tid;

  if (E > 0) load_tile(kind_s, prev_s, stage, tile, 0, min(tile, E));
  cp_async_commit();

  // lanes past C have no memory: every ALLOC fails, every word bit is 0
  const int nl = active ? num_local[lane] : 0;
  const int np = active ? num_pool[lane] : 0;
  int free_l = nl, free_p = np, local_allocs = 0, pool_allocs = 0;
  int attempts = 0;  // this thread's share of the stream's ALLOCs
  uint2 o1 = make_uint2(0u, 0u);

  const int n_tiles = (E + tile - 1) / tile;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * tile;
    const int n = min(tile, E - t0);
    cp_async_wait<0>();
    __syncthreads();  // tile t is in place, every warp is done with t - 1
    const int* tk = stage + (t & 1) * 2 * tile;
    const int* tp = tk + tile;
    // each event's word slot: its link's own slot when the link lies in
    // the tile, else the slot its fetched word goes to; 0 (any word) for
    // the walk's reads past the tile's last event
    for (int j = threadIdx.x; j < tile + kAhead; j += blockDim.x) {
      const int p = j < n ? tp[j] : 0;
      slot[j] = j >= n ? 0 : p >= t0 ? p - t0 : tile + j;
    }
    __syncthreads();  // the slots are in place
    if (live) {
      // 1. the words of the links before the tile (group 1 of this thread)
      for (int j = tid; j < n; j += 32) {
        attempts += tk[j] == kAlloc;
        const int p = tp[j];
        if (p >= 0 && p < t0)
          cp_async8(buf + tile + j, wrow + p);
        else if (p < 0)
          buf[tile + j] = make_uint2(0u, 0u);
      }
    }
    cp_async_commit();
    // tile t + 1 into the other stage (group 2), in flight during the walk
    if (t + 1 < n_tiles)
      load_tile(kind_s, prev_s, stage + ((t + 1) & 1) * 2 * tile, tile,
                t0 + tile, min(tile, E - t0 - tile));
    cp_async_commit();
    cp_async_wait<1>();
    if (live) {
      __syncwarp();  // every thread's fetched words are in place
      // 2. the walk, software-pipelined: event j + 3's kind, event j + 4's
      // slot and event j + 1's word are read while event j is replayed,
      // all before event j stores its word (the stage holds kAhead words
      // of slack past a tile: kinds read there are the links', never
      // replayed).  A word read so early misses event j's own, so event
      // j + 1's word is event j's (registers) when its slot is j, else the
      // one read.
      int kd0 = tk[0], kd1 = tk[1], kd2 = tk[2];
      int s1 = slot[1], s2 = slot[2], s3 = slot[3];
      uint2 w = buf[slot[0]];
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const int kd3 = tk[j + 3], s4 = slot[j + 4];
        const uint2 raw1 = buf[s1];
        const uint2 o = step(kd0, w.x, w.y, bit, free_l, free_p,
                             local_allocs, pool_allocs);
        buf[j] = o;  // every thread stores the same word: each reads its own
        w = pick(s1, j, o, raw1);
        kd0 = kd1; kd1 = kd2; kd2 = kd3;
        s1 = s2; s2 = s3; s3 = s4;
      }
      __syncwarp();
      // 3. the tile's words to the word array, 16 bytes (two words) a
      // thread: E, t0 and n are multiples of 4, so a row and a tile's
      // part of it start 32-byte aligned
      uint4* dst = reinterpret_cast<uint4*>(wrow + t0);
      const uint4* mine = reinterpret_cast<const uint4*>(buf);
      for (int v = tid; v < (n >> 1); v += 32) dst[v] = mine[v];
      __syncwarp();  // the stores before the next tile's fetches
    }
  }
  cp_async_wait<0>();
  if (live) attempts = __reduce_add_sync(kFull, attempts);

  if (active) {
    const size_t kc = static_cast<size_t>(gridDim.y) * C;
    const size_t o = static_cast<size_t>(stream) * C + lane;
    out[o] = local_allocs + pool_allocs;
    out[kc + o] = pool_allocs;
    out[2 * kc + o] = attempts - local_allocs - pool_allocs;
    out[3 * kc + o] = nl - free_l;
    out[4 * kc + o] = np - free_p;
  }
}

// tier[s][key][c] = the tier of word words[s][c / 32][last[s][key]] at bit
// c % 32, -1 where last is -1: one warp a (stream, key) row.
__global__ void __launch_bounds__(256)
    spill_map_kernel(const int* __restrict__ last,
                     const uint2* __restrict__ words,
                     int8_t* __restrict__ tier, long long rows, int n_keys,
                     int C, int E) {
  const int groups = (C + 31) / 32;
  const int tid = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       r < rows; r += warps) {
    const int e = last[r];
    const long long s = r / n_keys;
    int8_t* row = tier + r * C;
    for (int g = 0; g < groups; ++g) {
      const int c = g * 32 + tid;
      int8_t v = -1;
      if (e >= 0) {
        const uint2 w = words[(s * groups + g) * E + e];
        if ((w.x >> tid) & 1u) v = static_cast<int8_t>((w.y >> tid) & 1u);
      }
      if (c < C) row[c] = v;
    }
  }
}

// The links from a stable sort of each stream's keys (no-ops sorted as
// n_keys, after every key): skey the sorted keys, order the events'
// indices in that order.  prev[s][order[j]] is order[j - 1] when the two
// share a live key, else -1; last[s][key] is the order of a key's last
// position (last is -1 on entry).  One thread a (stream, position).
__global__ void __launch_bounds__(256)
    spill_links_kernel(const int* __restrict__ skey,
                       const long long* __restrict__ order,
                       int* __restrict__ prev, int* __restrict__ last, int E,
                       int n_keys) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= E) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * E;
  const int k = skey[row + j];
  const int o = static_cast<int>(order[row + j]);
  const bool live = k < n_keys;
  prev[row + o] = live && j > 0 && skey[row + j - 1] == k
                      ? static_cast<int>(order[row + j - 1])
                      : -1;
  if (live && (j == E - 1 || skey[row + j + 1] != k))
    last[static_cast<size_t>(blockIdx.y) * n_keys + k] = o;
}

// The chain floor's probe, on no path: one warp replays `steps` steps of
// the walk's free counter chain alone, as `step` chains it (free_l > 0
// under an ALLOC's predicate, then the take and a FREE's return as
// predicated adds; both predicates true at run time, so each step takes
// and returns a page), 8 steps a pass of a PTX loop with nothing else to
// issue.  Its time is the dependent latency of `steps` steps on the card.
#define SPILL_CHAIN_STEP              \
  "setp.gt.and.s32 tl, %0, 0, pa;\n\t" \
  "@tl sub.s32 %0, %0, 1;\n\t"         \
  "@pf add.s32 %0, %0, 1;\n\t"
__global__ void __launch_bounds__(32)
    spill_chain_kernel(int steps, int take, int give, int* __restrict__ out) {
  int f = 1;
  asm volatile(
      "{\n\t"
      ".reg .pred pa, pf, tl, more;\n\t"
      ".reg .b32 n;\n\t"
      "setp.ne.s32 pa, %1, 0;\n\t"
      "setp.ne.s32 pf, %2, 0;\n\t"
      "mov.b32 n, %3;\n"
      "CHAIN_8:\n\t" SPILL_CHAIN_STEP SPILL_CHAIN_STEP SPILL_CHAIN_STEP
          SPILL_CHAIN_STEP SPILL_CHAIN_STEP SPILL_CHAIN_STEP SPILL_CHAIN_STEP
              SPILL_CHAIN_STEP
      "sub.s32 n, n, 8;\n\t"
      "setp.gt.s32 more, n, 0;\n\t"
      "@more bra CHAIN_8;\n\t"
      "}"
      : "+r"(f)
      : "r"(take), "r"(give), "r"(steps));
  out[threadIdx.x] = f;
}
#undef SPILL_CHAIN_STEP

}  // namespace

// K streams of E events (E a multiple of 4), C lanes, n_keys keys; the
// grid (blocks a stream, K) of warps_per_block warps, tiles of `tile`
// events; then the final map over the card's sm_count SMs.
extern "C" int spill_sweep_launch(const void* kind, const void* prev,
                                  const void* last, const void* num_local,
                                  const void* num_pool, void* words,
                                  void* tier, void* out, int K, int E, int C,
                                  int n_keys, int warps_per_block, int tile,
                                  int sm_count, void* stream) {
  const int groups = (C + 31) / 32;
  if (K <= 0 || K > kMaxStreams || E < 0 || E % 4 != 0 || C <= 0 ||
      n_keys <= 0 || warps_per_block <= 0 ||
      warps_per_block > kMaxWarpsPerBlock || tile <= 0 || tile % 4 != 0 ||
      tile > kMaxTile || sm_count <= 0)
    return -1;
  const size_t smem = shared_bytes(tile, warps_per_block);
  if (smem > kMaxShared) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      spill_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((groups + warps_per_block - 1) / warps_per_block, K);
  spill_sweep_kernel<<<grid, 32 * warps_per_block, smem, st>>>(
      static_cast<const int*>(kind), static_cast<const int*>(prev),
      static_cast<const int*>(num_local), static_cast<const int*>(num_pool),
      static_cast<uint2*>(words), static_cast<int*>(out), E, C, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the map: a warp a (stream, key) row, at most 32 blocks an SM (a
  // grid-stride loop takes the rest)
  const long long rows = static_cast<long long>(K) * n_keys;
  const long long blocks = (rows + 7) / 8;
  const long long most = 32LL * sm_count;
  spill_map_kernel<<<static_cast<int>(blocks < most ? blocks : most), 256, 0,
                     st>>>(
      static_cast<const int*>(last), static_cast<const uint2*>(words),
      static_cast<int8_t*>(tier), rows, n_keys, C, E);
  return static_cast<int>(cudaGetLastError());
}

// The links pass of K streams of E events, after the stable sort.
extern "C" int spill_links_launch(const void* skey, const void* order,
                                  void* prev, void* last, int K, int E,
                                  int n_keys, void* stream) {
  if (K <= 0 || K > kMaxStreams || E < 0 || n_keys <= 0) return -1;
  if (E == 0) return 0;  // no event, no link
  const dim3 grid((E + 255) / 256, K);
  spill_links_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(skey), static_cast<const long long*>(order),
      static_cast<int*>(prev), static_cast<int*>(last), E, n_keys);
  return static_cast<int>(cudaGetLastError());
}

// The chain probe: one warp, `steps` (a positive multiple of 8) steps;
// out (32,) int32.
extern "C" int spill_chain_launch(int steps, void* out, void* stream) {
  if (steps <= 0 || steps % 8 != 0) return -1;
  spill_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, 1, 1, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spill_sweep_error_string(int code) {
  if (code == -1)
    return "unsupported extent: streams, events (a multiple of 4), lanes, "
           "keys, warps a block or tile";
  if (code == -2)
    return "the tile and warps a block need more shared memory than a "
           "block has";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
