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
//   kind, key   (K, E) int32 event streams, E a multiple of 4
//   num_local, num_pool   (C,) int32 config lanes
//   tier        (K, n_keys, C) int8 scratch: set to -1 here, each key's
//               tier on exit
//   out         (5, K, C) int32: allocs, pool_allocs, failed,
//               local_in_use, pool_in_use
//
// Keys of ALLOC and FREE events lie in [0, n_keys): the wrapper refuses
// others (the reference's dynamic_update_index_in_dim clamps them).
//
// Design (a first kernel, simple and right).  One thread a (stream, lane):
// there is no choice among servers, so nothing to reduce.  The two free
// counters and three counters live in registers.  A block holds lanes of
// one stream (blockIdx.y) and stages that stream's events in shared
// memory in tiles of kTile, two stages filled by 16-byte cp.async (K1's
// staging), so every warp of the block reads the same tile and the block
// barrier comes twice a tile.  The tier map lives in global memory as
// [stream][key][lane] int8, so a warp's 32 lanes touch 32 contiguous
// bytes at one key; each thread writes -1 into its own column first, and
// reads back only what it wrote itself, so no barrier orders the map.
// The event kind is the same for every lane of a block, so the branch on
// it never diverges; an ALLOC's outcome differs by lane and is a select.
//
// Bound.  Each event reads the free counters the previous one left, so a
// lane is a chain of E steps.  A FREE's tier read is a dependent global
// load on that chain (an L2 hit at best: the map of the Fig 16 grid,
// 23.6 MB, fits the 50 MB L2), so this design is bound by load latency,
// far above what the card's rates allow (a few int32 operations per event
// and lane, the events and the map moved once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlloc = 0, kFree = 1;
constexpr int kTile = 2048;  // events a stage
constexpr int kStages = 2;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxStreams = 65535;  // gridDim.y

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

// Stage events [e0, e0 + n) of a stream's kind and key rows into
// dst[0 .. kTile) and dst[kTile .. 2 kTile); e0 is a multiple of 4 and
// the rows 16-byte aligned (E a multiple of 4, the wrapper's layout).
__device__ __forceinline__ void load_tile(const int* kind, const int* key,
                                          int* dst, int e0, int n) {
  const int n4 = n >> 2;
  for (int v = threadIdx.x; v < n4; v += blockDim.x) {
    cp_async16(dst + 4 * v, kind + e0 + 4 * v);
    cp_async16(dst + kTile + 4 * v, key + e0 + 4 * v);
  }
  for (int v = 4 * n4 + threadIdx.x; v < n; v += blockDim.x) {
    cp_async4(dst + v, kind + e0 + v);
    cp_async4(dst + kTile + v, key + e0 + v);
  }
}

__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
    spill_sweep_kernel(const int* __restrict__ kind,
                       const int* __restrict__ key,
                       const int* __restrict__ num_local,
                       const int* __restrict__ num_pool,
                       int8_t* __restrict__ tier, int* __restrict__ out,
                       int E, int C, int n_keys) {
  __shared__ __align__(16) int stage[kStages][2 * kTile];
  const int stream = blockIdx.y;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < C;
  const int* kind_s = kind + static_cast<size_t>(stream) * E;
  const int* key_s = key + static_cast<size_t>(stream) * E;
  // this thread's column of the tier map: key k at col[k * C]
  int8_t* col = tier + static_cast<size_t>(stream) * n_keys * C +
                (active ? lane : 0);

  if (E > 0) load_tile(kind_s, key_s, stage[0], 0, min(kTile, E));
  cp_async_commit();

  const int nl = active ? num_local[lane] : 0;
  const int np = active ? num_pool[lane] : 0;
  int free_l = nl, free_p = np, allocs = 0, pool_allocs = 0, failed = 0;
  if (active)
    for (int k = 0; k < n_keys; ++k) col[static_cast<size_t>(k) * C] = -1;

  const int n_tiles = (E + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int e1 = (t + 1) * kTile;
    if (e1 < E) {
      load_tile(kind_s, key_s, stage[(t + 1) & 1], e1, min(kTile, E - e1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in place for every warp
    const int* tk = stage[t & 1];
    const int n = min(kTile, E - t * kTile);
    if (active) {
      for (int i = 0; i < n; ++i) {
        const int kd = tk[i];
        if (kd == kAlloc) {
          int8_t* at = col + static_cast<size_t>(tk[kTile + i]) * C;
          const bool take_l = free_l > 0;
          const bool take_p = !take_l && free_p > 0;
          free_l -= take_l;
          free_p -= take_p;
          allocs += take_l || take_p;
          pool_allocs += take_p;
          failed += !(take_l || take_p);
          if (take_l || take_p) *at = take_p ? 1 : 0;
        } else if (kd == kFree) {
          int8_t* at = col + static_cast<size_t>(tk[kTile + i]) * C;
          const int r = *at;
          free_l += r == 0;
          free_p += r == 1;
          *at = -1;
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  if (active) {
    const size_t kc = static_cast<size_t>(gridDim.y) * C;
    const size_t o = static_cast<size_t>(stream) * C + lane;
    out[o] = allocs;
    out[kc + o] = pool_allocs;
    out[2 * kc + o] = failed;
    out[3 * kc + o] = nl - free_l;
    out[4 * kc + o] = np - free_p;
  }
}

}  // namespace

// K streams of E events (E a multiple of 4), C lanes, n_keys keys;
// warps_per_block warps of lanes a block, the grid (blocks a stream, K).
extern "C" int spill_sweep_launch(const void* kind, const void* key,
                                  const void* num_local,
                                  const void* num_pool, void* tier,
                                  void* out, int K, int E, int C, int n_keys,
                                  int warps_per_block, void* stream) {
  if (K <= 0 || K > kMaxStreams || E < 0 || E % 4 != 0 || C <= 0 ||
      n_keys < 0 || warps_per_block <= 0 ||
      warps_per_block > kMaxWarpsPerBlock)
    return -1;
  const int threads = 32 * warps_per_block;
  const dim3 grid((C + threads - 1) / threads, K);
  spill_sweep_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(kind), static_cast<const int*>(key),
      static_cast<const int*>(num_local), static_cast<const int*>(num_pool),
      static_cast<int8_t*>(tier), static_cast<int*>(out), E, C, n_keys);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spill_sweep_error_string(int code) {
  if (code == -1)
    return "unsupported extent: streams, events (a multiple of 4), lanes, "
           "keys or warps a block";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
