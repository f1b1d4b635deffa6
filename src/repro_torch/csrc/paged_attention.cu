// Single-token decode attention over a paged KV pool, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_kernel / _kernel).  It computes what that kernel
// computes, not its grid: the TPU version walks a sequential grid axis
// over pages with its running softmax carried in scratch, and has the
// page ids prefetched as scalars; here one thread block owns a
// (batch row, KV head) pair, loops over that row's ceil(seq_len / page)
// pages itself, reads each page id from block_table[b, pi], and keeps
// (m, l, acc) for the g query heads of its KV head in shared memory.
//
//   q           (B, Hq, D)              Hq = Hkv * g, head h*g+gi -> KV head h
//   k/v_pages   (Hkv, P, page, D)
//   block_table (B, pages_per_seq) int32, padded with page 0
//   seq_lens    (B,) int32, >= 1
//   out         (B, Hq, D) in q's type; fp32 arithmetic throughout
//
// Bound: with g rows per KV head the work is about g FLOP per byte of K/V
// (6 at g = 6 in bf16), far below the ~295 FLOP/byte where the card's
// tensor cores would limit it, so the bound is bytes:
//   2 * sum_b(seq_len_b) * Hkv * D * itemsize / 3.35 TB/s   per call.
// What the design does about that: each K/V element is read from device
// memory exactly once, in 16-byte loads with neighbouring threads on
// neighbouring addresses along D; a tile of TILE_TOKENS tokens (several
// pages) is staged in shared memory per iteration so that many loads are
// in flight; all g heads of the group share the tile.  What it does not
// do yet: a batch of 8 rows x 2 KV heads is 16 blocks on 132 SMs, and a
// block waits for its tile before it computes.  Splitting the KV range
// across blocks (with a second-stage merge) and overlapping the next
// tile's loads with the current tile's arithmetic are left to a later
// change.
//
// Built without --use_fast_math: expf must stay the accurate one for the
// fp32 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as in the reference
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;
constexpr int kMaxSmemBytes = 232448;      // 227 KB opt-in limit on sm_90

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats:
//   q_s   [g * D]            the group's queries
//   acc_s [g * D]            running numerator
//   k_s   [TILE * (D + 1)]   K tile, rows padded by one float so that the
//                            logits' threads (one token each) hit 32 banks
//   v_s   [TILE * D]         V tile
//   p_s   [g * TILE]         logits, then probabilities, of the tile
//   m_s, l_s, corr_s [g]     running max, running sum, this tile's rescale
__host__ __device__ inline size_t smem_floats(int g, int d) {
  return (size_t)2 * g * d + (size_t)kTileTokens * (d + 1) +
         (size_t)kTileTokens * d + (size_t)g * kTileTokens + (size_t)3 * g;
}

template <typename T, int D, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_attention_fwd(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int g, int num_pages, int pages_per_seq, float scale) {
  constexpr int kTilePages = kTileTokens / PAGE;
  constexpr int kVec = Vec16<T>::kElems;
  constexpr int kKStride = D + 1;
  static_assert(kTileTokens % PAGE == 0, "tile must hold whole pages");
  static_assert(D % kVec == 0, "rows must be whole 16-byte vectors");

  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + g * D;
  float* k_s = acc_s + g * D;
  float* v_s = k_s + kTileTokens * kKStride;
  float* p_s = v_s + kTileTokens * D;
  float* m_s = p_s + g * kTileTokens;
  float* l_s = m_s + g;
  float* corr_s = l_s + g;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hkv = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int seq_len = seq_lens[b];
  const int n_pages = min((seq_len + PAGE - 1) / PAGE, pages_per_seq);
  const int* table = block_table + (size_t)b * pages_per_seq;
  const T* q_row = q + ((size_t)b * hkv + h) * g * D;

  for (int e = tid; e < g * D; e += kThreads) {
    q_s[e] = to_float(q_row[e]);
    acc_s[e] = 0.0f;
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    m_s[gi] = kNegInf;
    l_s[gi] = 0.0f;
  }
  __syncthreads();

  // Pages wholly beyond seq_len are never visited (the table pads them
  // with page 0).
  for (int p0 = 0; p0 < n_pages; p0 += kTilePages) {
    const int tile_pages = min(kTilePages, n_pages - p0);
    const int ntok = tile_pages * PAGE;

    // ---- stage the tile: every K/V element is read once, 16 bytes a thread
    const int nvec = ntok * (D / kVec);
    for (int i = tid; i < nvec; i += kThreads) {
      const int j = i / (D / kVec);            // token within the tile
      const int d = (i % (D / kVec)) * kVec;
      const int page_id = table[p0 + j / PAGE];
      const size_t src =
          (((size_t)h * num_pages + page_id) * PAGE + (j % PAGE)) * D + d;
      float kv[kVec];
      Vec16<T>::load(k_pages + src, kv);
#pragma unroll
      for (int u = 0; u < kVec; ++u) k_s[j * kKStride + d + u] = kv[u];
      Vec16<T>::load(v_pages + src, kv);
#pragma unroll
      for (int u = 0; u < kVec; ++u) v_s[j * D + d + u] = kv[u];
    }
    __syncthreads();

    // ---- logits (g, ntok): one (head, token) pair per thread at a time
    const int pos0 = p0 * PAGE;
    for (int e = tid; e < g * ntok; e += kThreads) {
      const int gi = e / ntok;
      const int j = e % ntok;
      const float* qv = q_s + gi * D;
      const float* kr = k_s + j * kKStride;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qv[d], kr[d], s);
      s *= scale;
      p_s[gi * kTileTokens + j] = (pos0 + j < seq_len) ? s : kNegInf;
    }
    __syncthreads();

    // ---- running softmax, one warp per head: rescale factor first
    for (int gi = warp; gi < g; gi += kWarps) {
      float* pr = p_s + gi * kTileTokens;
      float mx = kNegInf;
      for (int j = lane; j < ntok; j += 32) mx = fmaxf(mx, pr[j]);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
      for (int j = lane; j < ntok; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[gi] = corr;
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = acc * corr + p @ V: rescale, then accumulate
    for (int e = tid; e < g * D; e += kThreads) {
      const int gi = e / D;
      const int d = e % D;
      const float* pr = p_s + gi * kTileTokens;
      float a = acc_s[e] * corr_s[gi];
      for (int j = 0; j < ntok; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  T* out_row = out + ((size_t)b * hkv + h) * g * D;
  for (int e = tid; e < g * D; e += kThreads) {
    const float l = fmaxf(l_s[e / D], 1e-30f);
    store(out_row + e, acc_s[e] / l);
  }
}

template <typename T, int D, int PAGE>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_table, const int* seq_lens, void* out, int batch,
           int hkv, int g, int num_pages, int pages_per_seq, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(g, D) * sizeof(float);
  if (bytes > (size_t)kMaxSmemBytes) return -2;
  auto kernel = paged_attention_fwd<T, D, PAGE>;
  // The attribute belongs to the current device, so it is set on every
  // call rather than remembered per process.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hkv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_table, seq_lens,
      static_cast<T*>(out), g, num_pages, pages_per_seq, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_page(int page, const void* q, const void* k, const void* v,
                const int* tbl, const int* lens, void* out, int batch,
                int hkv, int g, int num_pages, int pps, float scale,
                cudaStream_t stream) {
  switch (page) {
    case 4:
      return launch<T, D, 4>(q, k, v, tbl, lens, out, batch, hkv, g,
                             num_pages, pps, scale, stream);
    case 8:
      return launch<T, D, 8>(q, k, v, tbl, lens, out, batch, hkv, g,
                             num_pages, pps, scale, stream);
    case 16:
      return launch<T, D, 16>(q, k, v, tbl, lens, out, batch, hkv, g,
                              num_pages, pps, scale, stream);
    default:
      return -1;
  }
}

template <typename T>
int launch_dim(int d, int page, const void* q, const void* k, const void* v,
               const int* tbl, const int* lens, void* out, int batch, int hkv,
               int g, int num_pages, int pps, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_page<T, 16>(page, q, k, v, tbl, lens, out, batch, hkv, g,
                                num_pages, pps, scale, stream);
    case 32:
      return launch_page<T, 32>(page, q, k, v, tbl, lens, out, batch, hkv, g,
                                num_pages, pps, scale, stream);
    case 64:
      return launch_page<T, 64>(page, q, k, v, tbl, lens, out, batch, hkv, g,
                                num_pages, pps, scale, stream);
    case 128:
      return launch_page<T, 128>(page, q, k, v, tbl, lens, out, batch, hkv, g,
                                 num_pages, pps, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C interface.  dtype: 0 = float32, 1 = bfloat16.  Returns 0 on a
// successful launch, a positive cudaError_t if the launch was refused,
// -1 for a head_dim / page_size / dtype the kernel is not built for and -2
// if the group needs more shared memory than a block can have.  Enqueues
// on `stream` and does not synchronise.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* seq_lens, void* out,
                                      int batch, int hkv, int g, int head_dim,
                                      int num_pages, int page_size,
                                      int pages_per_seq, float scale,
                                      int dtype, void* stream) {
  const int* tbl = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || hkv <= 0 || g <= 0 || pages_per_seq <= 0) return -1;
  switch (dtype) {
    case 0:
      return launch_dim<float>(head_dim, page_size, q, k_pages, v_pages, tbl,
                               lens, out, batch, hkv, g, num_pages,
                               pages_per_seq, scale, s);
    case 1:
      return launch_dim<__nv_bfloat16>(head_dim, page_size, q, k_pages,
                                       v_pages, tbl, lens, out, batch, hkv, g,
                                       num_pages, pages_per_seq, scale, s);
    default:
      return -1;
  }
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code == -1) return "unsupported head_dim, page_size, dtype or extent";
  if (code == -2) return "group too large for a block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
