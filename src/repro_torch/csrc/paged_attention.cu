// Single-token decode attention over a paged KV pool, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_kernel / _kernel).  It computes what that kernel
// computes, not its grid: the TPU version walks a sequential grid axis
// over pages with its running softmax carried in scratch, and has the
// page ids prefetched as scalars.  Here the KV range of each (batch row,
// KV head) is split across blocks (split-KV), and a second kernel merges
// the splits' partial softmaxes.
//
//   q           (B, Hq, D)              Hq = Hkv * g, head h*g+gi -> KV head h
//   k/v_pages   (Hkv, P, page, D)
//   block_table (B, pages_per_seq) int32, padded with page 0
//   seq_lens    (B,) int32, >= 1
//   out         (B, Hq, D) in q's type; fp32 arithmetic throughout
//   scratch     fp32 partials: (m, l) then acc, for every
//               (row, KV head, split, head of the group)
//
// Bound: with g rows per KV head the work is about g FLOP per byte of K/V
// (6 at g = 6 in bf16), far below the ~295 FLOP/byte where the card's
// tensor cores would limit it, so the bound is bytes:
//   2 * sum_b(seq_len_b) * Hkv * D * itemsize / 3.35 TB/s   per call.
// A decode batch is small (B 8 x Hkv 2 = 16 pairs on 132 SMs), so reaching
// that bound is a matter of having enough loads in flight.
//
// What the design does about it:
//  * Split-KV.  The grid is (Hkv, B, splits).  The wrapper chooses the
//    split count from the table's width (kernel.py::num_splits, never from
//    the lengths, which live on the device): whole 64-token tiles a split,
//    about two blocks an SM, one split when B * Hkv already fills the
//    card.  Each block walks only its split's pages and writes a partial
//    (m, l, acc[g * D]) in fp32; a split that starts at or beyond seq_len
//    writes (NEG_INF, 0, 0).  The merge kernel, one block per (KV head,
//    row, head of the group), computes
//    out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,  M = max_s m_s,
//    so an empty split weighs e^(NEG_INF - M) = 0.
//  * Overlap.  K/V tiles are staged in shared memory in their own dtype
//    by 16-byte cp.async copies into two stages: tile n+1 is in flight
//    while tile n is computed.  Three barriers a tile.
//  * Logits.  A group of D / (16 / itemsize) neighbouring threads owns one
//    token: each reads one 16-byte vector of the K row and all g query
//    vectors (fp32, shared), and the group's partial dot products meet in
//    a shuffle reduction.
//  * p @ V.  One thread per output element, four independent sums over
//    the tile's tokens.
// What it leaves: the logits and p @ V run on the CUDA cores in fp32 (at
// g 6 the tensor cores would idle most of a tile), and the merge is a
// second launch on the same stream.  On the serving path the wrapper's
// eager call takes more host time than both kernels take on the device.
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
constexpr int kMergeThreads = 128;          // >= the largest D, and >= 32
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory: two stages of (K tile, V tile), TILE x D each in T, then
// in floats:
//   q_s   [g * D]            the group's queries
//   acc_s [g * D]            running numerator
//   p_s   [g * TILE]         logits, then probabilities, of the tile
//   m_s, l_s, corr_s [g]     running max, running sum, this tile's rescale
__host__ __device__ inline size_t smem_bytes(int g, int d, int itemsize) {
  return (size_t)4 * kTileTokens * d * itemsize +
         sizeof(float) * ((size_t)2 * g * d + (size_t)g * kTileTokens +
                          (size_t)3 * g);
}

template <typename T, int D, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_attention_split(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ block_table,
                      const int* __restrict__ seq_lens,
                      float* __restrict__ part, int g, int num_pages,
                      int pages_per_seq, int split_tokens, float scale) {
  constexpr int kVec = Vec16<T>::kElems;
  constexpr int kChunks = D / kVec;          // 16-byte vectors a row
  constexpr int kTileElems = kTileTokens * D;
  static_assert(kTileTokens % PAGE == 0, "a tile holds whole pages");
  static_assert(D % kVec == 0, "rows must be whole 16-byte vectors");
  static_assert(32 % kChunks == 0, "a token's threads share one warp");
  static_assert((kTileTokens * kChunks) % 32 == 0, "whole warps a tile");

  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);      // [stage][K | V][TILE * D]
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * kTileElems);
  float* acc_s = q_s + g * D;
  float* p_s = acc_s + g * D;
  float* m_s = p_s + g * kTileTokens;
  float* l_s = m_s + g;
  float* corr_s = l_s + g;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int hkv = gridDim.x;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // partials of this (row, KV head, split): (m, l) pairs, then acc rows
  const size_t slot = ((size_t)b * hkv + h) * splits + split;
  float* ml_out = part + slot * g * 2;
  float* acc_out = part + (size_t)gridDim.y * hkv * splits * g * 2 +
                   slot * g * D;

  const int seq_len = min(seq_lens[b], pages_per_seq * PAGE);
  const int start = split * split_tokens;
  const int end = min(start + split_tokens, seq_len);
  if (start >= end) {                        // empty split: weighs 0
    for (int gi = tid; gi < g; gi += kThreads) {
      ml_out[2 * gi] = kNegInf;
      ml_out[2 * gi + 1] = 0.0f;
    }
    for (int e = tid; e < g * D; e += kThreads) acc_out[e] = 0.0f;
    return;
  }
  const int n_tiles = (end - start + kTileTokens - 1) / kTileTokens;
  const int* table = block_table + (size_t)b * pages_per_seq;

  // tokens t0 .. t0 + ntok of the split, ntok rounded up to whole pages
  auto tile_tokens = [&](int t0) {
    return min(kTileTokens, (end - t0 + PAGE - 1) / PAGE * PAGE);
  };
  auto load_tile = [&](int stage, int t0) {
    T* k_s = kv_s + 2 * stage * kTileElems;
    T* v_s = k_s + kTileElems;
    const int n = tile_tokens(t0) * kChunks;
    for (int i = tid; i < n; i += kThreads) {
      const int j = i / kChunks;
      const int c = (i % kChunks) * kVec;
      const int page_id = table[(t0 + j) / PAGE];
      const size_t src =
          (((size_t)h * num_pages + page_id) * PAGE + (t0 + j) % PAGE) * D + c;
      cp_async16(k_s + j * D + c, k_pages + src);
      cp_async16(v_s + j * D + c, v_pages + src);
    }
    cp_async_commit();
  };

  load_tile(0, start);
  const T* q_row = q + ((size_t)b * hkv + h) * g * D;
  for (int e = tid; e < g * D; e += kThreads) {
    q_s[e] = to_float(q_row[e]);
    acc_s[e] = 0.0f;
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    m_s[gi] = kNegInf;
    l_s[gi] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = start + it * kTileTokens;
    const int ntok = tile_tokens(t0);
    const T* k_s = kv_s + 2 * (it & 1) * kTileElems;
    const T* v_s = k_s + kTileElems;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; every thread is done with tile it-1
    if (it + 1 < n_tiles) load_tile((it + 1) & 1, t0 + kTileTokens);

    // ---- logits (g, ntok): kChunks neighbouring threads own a token
    for (int i = tid; i < kTileTokens * kChunks; i += kThreads) {
      const int j = i / kChunks;
      const int c = (i % kChunks) * kVec;
      float kx[kVec];
      Vec16<T>::load(k_s + j * D + c, kx);
      for (int gi = 0; gi < g; ++gi) {
        const float* qv = q_s + gi * D + c;
        float s = 0.0f;
#pragma unroll
        for (int u = 0; u < kVec; u += 4) {
          const float4 qf = *reinterpret_cast<const float4*>(qv + u);
          s = fmaf(qf.x, kx[u], s);
          s = fmaf(qf.y, kx[u + 1], s);
          s = fmaf(qf.z, kx[u + 2], s);
          s = fmaf(qf.w, kx[u + 3], s);
        }
#pragma unroll
        for (int o = kChunks / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (c == 0 && j < ntok)
          p_s[gi * kTileTokens + j] = (t0 + j < end) ? s * scale : kNegInf;
      }
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

    // ---- acc = acc * corr + p @ V: four independent sums over the tokens
    for (int e = tid; e < g * D; e += kThreads) {
      const int gi = e / D;
      const int d = e % D;
      const float* pr = p_s + gi * kTileTokens;
      const T* vc = v_s + d;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int j = 0; j < ntok; j += 4) {  // ntok is a multiple of PAGE >= 4
        a0 = fmaf(pr[j], to_float(vc[j * D]), a0);
        a1 = fmaf(pr[j + 1], to_float(vc[(j + 1) * D]), a1);
        a2 = fmaf(pr[j + 2], to_float(vc[(j + 2) * D]), a2);
        a3 = fmaf(pr[j + 3], to_float(vc[(j + 3) * D]), a3);
      }
      acc_s[e] = acc_s[e] * corr_s[gi] + ((a0 + a1) + (a2 + a3));
    }
  }
  __syncthreads();
  for (int gi = tid; gi < g; gi += kThreads) {
    ml_out[2 * gi] = m_s[gi];
    ml_out[2 * gi + 1] = l_s[gi];
  }
  for (int e = tid; e < g * D; e += kThreads) acc_out[e] = acc_s[e];
}

// out[b, h*g+gi, d] = sum_s w_s acc_s[d] / sum_s w_s l_s,  w_s = e^(m_s - M):
// one block per (KV head, row, head of the group); its first warp computes
// the weights into shared memory, then a thread per column sums.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads)
paged_attention_merge(const float* __restrict__ part, T* __restrict__ out,
                      int splits) {
  extern __shared__ float w_s[];             // [splits] weights, then the sum
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int gi = blockIdx.z;
  const int hkv = gridDim.x;
  const int g = gridDim.z;
  const size_t first = ((size_t)b * hkv + h) * splits;
  const float* ml = part + first * g * 2;
  const float* acc = part + (size_t)gridDim.y * hkv * splits * g * 2 +
                     first * g * D;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = kNegInf;
    for (int s = lane; s < splits; s += 32)
      mx = fmaxf(mx, ml[2 * (s * g + gi)]);
    mx = warp_max(mx);
    float den = 0.0f;
    for (int s = lane; s < splits; s += 32) {
      const float w = expf(ml[2 * (s * g + gi)] - mx);
      w_s[s] = w;
      den = fmaf(w, ml[2 * (s * g + gi) + 1], den);
    }
    den = warp_sum(den);
    if (lane == 0) w_s[splits] = den;
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= D) return;
  float num = 0.0f;
  for (int s = 0; s < splits; ++s)
    num = fmaf(w_s[s], acc[((size_t)s * g + gi) * D + d], num);
  store(out + (((size_t)b * hkv + h) * g + gi) * D + d,
        num / fmaxf(w_s[splits], 1e-30f));
}

template <typename T, int D, int PAGE>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_table, const int* seq_lens, void* out,
           float* scratch, int batch, int hkv, int g, int num_pages,
           int pages_per_seq, int splits, int split_tokens, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(g, D, sizeof(T));
  if (bytes > (size_t)kMaxSmemBytes) return -2;
  auto kernel = paged_attention_split<T, D, PAGE>;
  // The attribute belongs to the current device, so it is set on every
  // call rather than remembered per process.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(hkv, batch, splits), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_table, seq_lens, scratch, g,
      num_pages, pages_per_seq, split_tokens, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attention_merge<T, D>
      <<<dim3(hkv, batch, g), D < 32 ? 32 : D, (splits + 1) * sizeof(float),
         stream>>>(scratch, static_cast<T*>(out), splits);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_page(int page, const void* q, const void* k, const void* v,
                const int* tbl, const int* lens, void* out, float* scratch,
                int batch, int hkv, int g, int num_pages, int pps, int splits,
                int split_tokens, float scale, cudaStream_t stream) {
  switch (page) {
    case 4:
      return launch<T, D, 4>(q, k, v, tbl, lens, out, scratch, batch, hkv, g,
                             num_pages, pps, splits, split_tokens, scale,
                             stream);
    case 8:
      return launch<T, D, 8>(q, k, v, tbl, lens, out, scratch, batch, hkv, g,
                             num_pages, pps, splits, split_tokens, scale,
                             stream);
    case 16:
      return launch<T, D, 16>(q, k, v, tbl, lens, out, scratch, batch, hkv, g,
                              num_pages, pps, splits, split_tokens, scale,
                              stream);
    default:
      return -1;
  }
}

template <typename T>
int launch_dim(int d, int page, const void* q, const void* k, const void* v,
               const int* tbl, const int* lens, void* out, float* scratch,
               int batch, int hkv, int g, int num_pages, int pps, int splits,
               int split_tokens, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_page<T, 16>(page, q, k, v, tbl, lens, out, scratch, batch,
                                hkv, g, num_pages, pps, splits, split_tokens,
                                scale, stream);
    case 32:
      return launch_page<T, 32>(page, q, k, v, tbl, lens, out, scratch, batch,
                                hkv, g, num_pages, pps, splits, split_tokens,
                                scale, stream);
    case 64:
      return launch_page<T, 64>(page, q, k, v, tbl, lens, out, scratch, batch,
                                hkv, g, num_pages, pps, splits, split_tokens,
                                scale, stream);
    case 128:
      return launch_page<T, 128>(page, q, k, v, tbl, lens, out, scratch,
                                 batch, hkv, g, num_pages, pps, splits,
                                 split_tokens, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C interface.  scratch: fp32, batch * hkv * splits * g *
// (head_dim + 2) elements; split_tokens: tokens a split covers, a multiple
// of 64.  dtype: 0 = float32, 1 = bfloat16.  Returns 0 on a successful
// launch of both kernels, a positive cudaError_t if a launch was refused,
// -1 for a head_dim / page_size / dtype / extent the kernel is not built
// for and -2 if the group needs more shared memory than a block can have.
// Enqueues the split kernel and the merge on `stream`, in that order, and
// does not synchronise.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* seq_lens, void* out, void* scratch,
    int batch, int hkv, int g, int head_dim, int num_pages, int page_size,
    int pages_per_seq, int splits, int split_tokens, float scale, int dtype,
    void* stream) {
  const int* tbl = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(seq_lens);
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || hkv <= 0 || g <= 0 || pages_per_seq <= 0 || splits <= 0 ||
      split_tokens <= 0 || split_tokens % kTileTokens != 0)
    return -1;
  if (batch > 65535 || g > 65535 || splits > 4096) return -1;
  switch (dtype) {
    case 0:
      return launch_dim<float>(head_dim, page_size, q, k_pages, v_pages, tbl,
                               lens, out, part, batch, hkv, g, num_pages,
                               pages_per_seq, splits, split_tokens, scale, s);
    case 1:
      return launch_dim<__nv_bfloat16>(head_dim, page_size, q, k_pages,
                                       v_pages, tbl, lens, out, part, batch,
                                       hkv, g, num_pages, pages_per_seq,
                                       splits, split_tokens, scale, s);
    default:
      return -1;
  }
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code == -1) return "unsupported head_dim, page_size, dtype or extent";
  if (code == -2) return "group too large for a block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
