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
// the time is that of the per-event dependency chain: shared-memory
// latency, a scan over S / 32 servers a thread and a five-step shuffle
// reduction, times E.
//
// What the design does about it:
//  * One warp per candidate lane, a few lanes a block, blocks independent
//    (nothing carries between them).  Server s belongs to thread s % 32;
//    the lane's fc, um, up and slot column live in shared memory for the
//    whole sweep, the block's group_of beside them.
//  * Per ARRIVE each thread scans its servers for both masks and one
//    __shfl_xor_sync reduction over (score, index) packed in 64 bits gives
//    the first minimum (ties to the lower index, as jnp.argmin and the
//    oracle).  The fallback's reduction runs only when no server passes
//    the pooled mask.  One __syncwarp an event orders the owner thread's
//    writes; there is no block barrier per event.
//  * Events are staged in shared memory in tiles of 1024, two stages
//    filled by cp.async: tile n+1 is in flight while tile n is replayed.
//    Every warp of the block reads the same tile, so the block barrier
//    comes twice a tile, not once an event.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kArrive = 0, kDepart = 1, kMigrate = 2;
constexpr int kTile = 1024;        // events a stage
constexpr int kStages = 2;
constexpr int kMaxLanesPerBlock = 8;
constexpr int kMaxShared = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of a block: the event stages, group_of, then one state
// region a lane.  kernel.py::shared_bytes computes the same.
__host__ __device__ size_t lane_bytes(int S, int G, int n_slots, int item) {
  return round16(static_cast<size_t>(2 * S + G + n_slots) * item);
}
__host__ __device__ size_t shared_bytes(int S, int G, int n_slots, int item,
                                        int lanes) {
  return static_cast<size_t>(kStages) * 6 * kTile * 4 +
         round16(static_cast<size_t>(S) * 4) +
         lanes * lane_bytes(S, G, n_slots, item);
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

// Stage events [e0, e0 + n) of the six arrays into dst[6][kTile]; e0 is a
// multiple of kTile and every array 16-byte aligned (the wrapper checks).
__device__ __forceinline__ void load_tile(const Events& ev, int* dst, int e0,
                                          int n) {
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

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi - 1);
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxLanesPerBlock)
    event_sweep_kernel(Events ev, const int* __restrict__ group_of,
                       T* __restrict__ fc, T* __restrict__ um,
                       T* __restrict__ up, T* __restrict__ slots,
                       const T* __restrict__ sgb, const T* __restrict__ pgb,
                       int* __restrict__ rejects, int E, int C, int S, int G,
                       int n_slots, int lanes_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  int* grp = stage + kStages * 6 * kTile;
  const size_t stride = lane_bytes(S, G, n_slots, sizeof(T)) / sizeof(T);
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  T* mine = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(grp) +
                                 round16(static_cast<size_t>(S) * 4)) +
            warp * stride;
  T* s_fc = mine;
  T* s_um = mine + S;
  T* s_up = mine + 2 * S;
  T* s_sl = mine + 2 * S + G;
  const int lane = blockIdx.x * lanes_per_block + warp;
  const bool active = lane < C;
  const int big = sizeof(T) == 2 ? (1 << 14) : (1 << 30);

  const int n_tiles = (E + kTile - 1) / kTile;
  if (n_tiles > 0) load_tile(ev, stage, 0, min(kTile, E));
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
    for (int j = tid; j < n_slots; j += 32)
      s_sl[j] = slots[static_cast<size_t>(j) * C + lane];
    sg = sgb[lane];
    pg = pgb[lane];
    rej = rejects[lane];
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int e0 = t * kTile;
    if (t + 1 < n_tiles) {
      load_tile(ev, stage + ((t + 1) & 1) * 6 * kTile, e0 + kTile,
                min(kTile, E - e0 - kTile));
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
            s_sl[sl] = static_cast<T>(place ? sel * 2 + (feas1 ? 0 : 1) : -1);
          rej += place ? 0 : 1;
        } else {
          const int val = s_sl[sl];
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
              s_sl[sl] = static_cast<T>(val | 1);
            }
          }
          if (kind == kDepart && tid == 0) s_sl[sl] = static_cast<T>(-1);
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
    for (int j = tid; j < n_slots; j += 32)
      slots[static_cast<size_t>(j) * C + lane] = s_sl[j];
    if (tid == 0) rejects[lane] = rej;
  }
}

template <typename T>
int launch(const Events& ev, const void* group_of, void* fc, void* um,
           void* up, void* slots, const void* sgb, const void* pgb,
           void* rejects, int E, int C, int S, int G, int n_slots,
           int lanes_per_block, cudaStream_t stream) {
  const size_t smem = shared_bytes(S, G, n_slots, sizeof(T), lanes_per_block);
  if (smem > kMaxShared) return -2;
  auto kern = event_sweep_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (C + lanes_per_block - 1) / lanes_per_block;
  kern<<<blocks, 32 * lanes_per_block, smem, stream>>>(
      ev, static_cast<const int*>(group_of), static_cast<T*>(fc),
      static_cast<T*>(um), static_cast<T*>(up), static_cast<T*>(slots),
      static_cast<const T*>(sgb), static_cast<const T*>(pgb),
      static_cast<int*>(rejects), E, C, S, G, n_slots, lanes_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int event_sweep_launch(
    const void* kind, const void* slot, const void* cores, const void* local,
    const void* pool, const void* mem, const void* group_of, void* fc,
    void* um, void* up, void* slots, const void* sgb, const void* pgb,
    void* rejects, int E, int C, int S, int G, int n_slots, int state_bytes,
    int lanes_per_block, void* stream) {
  if (E < 0 || C <= 0 || S <= 0 || G <= 0 || n_slots <= 0 ||
      lanes_per_block <= 0 || lanes_per_block > kMaxLanesPerBlock)
    return -1;
  Events ev{{static_cast<const int*>(kind), static_cast<const int*>(slot),
             static_cast<const int*>(cores), static_cast<const int*>(local),
             static_cast<const int*>(pool), static_cast<const int*>(mem)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (state_bytes) {
    case 2:
      return launch<int16_t>(ev, group_of, fc, um, up, slots, sgb, pgb,
                             rejects, E, C, S, G, n_slots, lanes_per_block, s);
    case 4:
      return launch<int32_t>(ev, group_of, fc, um, up, slots, sgb, pgb,
                             rejects, E, C, S, G, n_slots, lanes_per_block, s);
    default:
      return -1;
  }
}

extern "C" const char* event_sweep_error_string(int code) {
  if (code == -1) return "unsupported extent, lanes per block or state type";
  if (code == -2) return "lane state too large for a block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
