// Causal / sliding-window GQA attention over a whole sequence, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel / _kernel).  It computes what that kernel
// computes, not its grid: the TPU version walks a sequential grid axis over
// every KV block of a (batch, query head, query block) with its running
// softmax carried in scratch, on head-major inputs padded to 128 lanes and
// 512-row blocks.  Here one thread block owns a (batch row, KV head, query
// tile) triple, holds the g query heads of that KV head for the tile's
// positions, and loops over only the 64-key tiles that meet the tile's
// causal / window band.  It reads q, k, v in the model's (B, S, H, D)
// layout through their strides; nothing is transposed or padded.
//
//   q    (B, Sq, Hq, D)     Hq = Hkv * g, query head h*g+gi -> KV head h
//   k/v  (B, Skv, Hkv, D)
//   out  (B, Sq, Hq, D) contiguous, in q's type; fp32 arithmetic throughout
//   key j is attended by query i iff j < Skv, (causal) j <= i and
//   (window) j > i - window; positions start at 0 for both.
//
// Work split: a block has 256 threads and 128 rows, a row being one
// (query position, query head) pair: the tile holds 128 / g positions times
// the g heads, so each K/V tile is read once for the whole group.  Threads
// form 16 row groups of 8 rows; the 16 threads of a row group (one half
// warp) split the tile's 64 keys four each for the logits, and the D
// columns of the output for p @ V, so the row-wise max and sum are half-warp
// shuffles.  The running (m, l) and the output rows live in registers.
//
// Band: the block visits the KV tiles from the one holding
// max(0, first_position - window + 1) to the one holding
// min(Skv, last_position + 1) (causal).  This is exact: a row for which a
// visited tile is wholly masked before its first valid key gets m = NEG_INF,
// l = 64 and acc = sum(v), and its first valid tile wipes them through
// corr = exp(NEG_INF - m) = 0 in fp32; a masked key after the first valid
// one gives p = exp(NEG_INF - m) = 0.  The rescale-then-accumulate order of
// the reference is kept.
//
// Bound: at the serving shape (B 2, S 8192, Hq 32, Hkv 8, D 80, window
// 4096) the two products need ~2.1e11 FLOP against ~2e8 bytes, far above
// the card's ~295 FLOP/byte, so the bound is operations (tensor-core rate
// for bf16).  What the design does about it: every K/V element is read from
// device memory once per block (16-byte loads) and reused for 128 rows from
// shared memory; the logits are a register-tiled 8x4 outer product per
// thread with float4 shared-memory reads.  What it does not do yet: it runs
// on the CUDA cores in fp32 (no mma/wgmma, no TMA, no overlap of the next
// tile's loads with this tile's arithmetic).  Making it fast is left to a
// later change.
//
// Built without --use_fast_math: expf must stay the accurate one for the
// fp32 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as in the reference
constexpr int kThreads = 256;
constexpr int kColThreads = 16;             // threads sharing a row (half warp)
constexpr int kRowGroups = kThreads / kColThreads;
constexpr int kRowsPerThread = 8;
constexpr int kRows = kRowGroups * kRowsPerThread;  // 128 rows a block
constexpr int kTileK = 64;                  // keys a KV tile
constexpr int kKeysPerThread = kTileK / kColThreads;
constexpr int kMaxSmemBytes = 232448;       // 227 KB opt-in limit on sm_90

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  long long q_sb, q_ss, q_sh;  // strides in elements; the last dim is dense
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int sq, skv, hkv, g, tile_q, causal, window;  // window <= 0: none
  float scale;
};

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N floats (a multiple of 4) into shared memory as 16-byte stores.
template <int N>
__device__ __forceinline__ void store_smem(float* dst, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = kColThreads / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kColThreads / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats:
//   q_s [kRows * D]            the tile's query rows
//   k_s [kTileK * (D + 4)]     K tile; rows padded by 4 floats so that the
//                              float4 reads of 8 neighbouring keys fall in
//                              distinct banks
//   v_s [kTileK * D]           V tile
//   p_s [kRows * kTileK]       probabilities of the tile
__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)kRows * d + (size_t)kTileK * (d + 4) + (size_t)kTileK * d +
         (size_t)kRows * kTileK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const Params<T> p) {
  constexpr int kVec = Vec16<T>::kElems;
  constexpr int kChunks = D / kVec;          // 16-byte chunks a row
  constexpr int kKS = D + 4;
  constexpr int kCols = (D + kColThreads - 1) / kColThreads;
  static_assert(D % kVec == 0, "rows must be whole 16-byte vectors");
  static_assert(D % 4 == 0, "shared rows must be whole float4s");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kRows * D;
  float* v_s = k_s + kTileK * kKS;
  float* p_s = v_s + kTileK * D;

  const int tid = threadIdx.x;
  const int rg = tid / kColThreads;
  const int cg = tid % kColThreads;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = p.g;
  const int q0 = blockIdx.x * p.tile_q;
  const int rows = p.tile_q * g;              // rows in use, <= kRows
  const int q_last = min(q0 + p.tile_q, p.sq) - 1;

  // ---- the tile's query rows; rows beyond the tile or Sq are zeros
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int d = (i % kChunks) * kVec;
    const int qi = q0 + r / g;
    float x[kVec];
    if (r < rows && qi < p.sq) {
      Vec16<T>::load(p.q + b * p.q_sb + qi * p.q_ss +
                         (long long)(h * g + r % g) * p.q_sh + d, x);
    } else {
#pragma unroll
      for (int u = 0; u < kVec; ++u) x[u] = 0.0f;
    }
    store_smem<kVec>(q_s + r * D + d, x);
  }

  // query position of each of this thread's rows
  int qpos[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    qpos[j] = q0 + (rg * kRowsPerThread + j) / g;
    m[j] = kNegInf;
    l[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.0f;
  }

  // ---- the KV tiles that meet the band of positions q0 .. q_last
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int k_end = p.causal ? min(p.skv, q_last + 1) : p.skv;
  for (int k0 = (k_begin / kTileK) * kTileK; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous tile's k_s, v_s, p_s are read
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int j = i / kChunks;
      const int d = (i % kChunks) * kVec;
      const int kp = k0 + j;
      float kx[kVec], vx[kVec];
      if (kp < p.skv) {
        Vec16<T>::load(p.k + b * p.k_sb + kp * p.k_ss + h * p.k_sh + d, kx);
        Vec16<T>::load(p.v + b * p.v_sb + kp * p.v_ss + h * p.v_sh + d, vx);
      } else {  // beyond Skv: zeros, masked below
#pragma unroll
        for (int u = 0; u < kVec; ++u) kx[u] = vx[u] = 0.0f;
      }
      store_smem<kVec>(k_s + j * kKS + d, kx);
      store_smem<kVec>(v_s + j * D + d, vx);
    }
    __syncthreads();

    // ---- logits: rows rg*8 .. rg*8+7 x keys cg, cg+16, cg+32, cg+48
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) s[j][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kf[kKeysPerThread];
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c)
        kf[c] = *reinterpret_cast<const float4*>(
            k_s + (cg + kColThreads * c) * kKS + d);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float4 qf = *reinterpret_cast<const float4*>(
            q_s + (rg * kRowsPerThread + j) * D + d);
#pragma unroll
        for (int c = 0; c < kKeysPerThread; ++c) {
          float a = s[j][c];
          a = fmaf(qf.x, kf[c].x, a);
          a = fmaf(qf.y, kf[c].y, a);
          a = fmaf(qf.z, kf[c].z, a);
          a = fmaf(qf.w, kf[c].w, a);
          s[j][c] = a;
        }
      }
    }

    // ---- running softmax per row: rescale factor first
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) {
        const int kp = k0 + cg + kColThreads * c;
        const bool ok = kp < p.skv && (!p.causal || kp <= qpos[j]) &&
                        (p.window <= 0 || kp > qpos[j] - p.window);
        s[j][c] = ok ? s[j][c] * p.scale : kNegInf;
        mx = fmaxf(mx, s[j][c]);
      }
      const float m_new = fmaxf(m[j], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) {
        s[j][c] = expf(s[j][c] - m_new);
        sum += s[j][c];
      }
      sum = half_warp_sum(sum);
      const float corr = expf(m[j] - m_new);
      l[j] = l[j] * corr + sum;
      m[j] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[j][c] *= corr;
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c)
        p_s[(rg * kRowsPerThread + j) * kTileK + cg + kColThreads * c] =
            s[j][c];
    }
    __syncthreads();

    // ---- acc += p @ V: columns cg, cg+16, ... of the thread's rows
#pragma unroll 2
    for (int kk = 0; kk < kTileK; kk += 4) {
      float4 pf[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        pf[j] = *reinterpret_cast<const float4*>(
            p_s + (rg * kRowsPerThread + j) * kTileK + kk);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = cg + kColThreads * c;
        if (D % kColThreads != 0 && col >= D) continue;
        const float v0 = v_s[(kk + 0) * D + col];
        const float v1 = v_s[(kk + 1) * D + col];
        const float v2 = v_s[(kk + 2) * D + col];
        const float v3 = v_s[(kk + 3) * D + col];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          float a = acc[j][c];
          a = fmaf(pf[j].x, v0, a);
          a = fmaf(pf[j].y, v1, a);
          a = fmaf(pf[j].z, v2, a);
          a = fmaf(pf[j].w, v3, a);
          acc[j][c] = a;
        }
      }
    }
  }

  // ---- out = acc / l for the rows that are real
  const int hq = p.hkv * g;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = rg * kRowsPerThread + j;
    if (r >= rows || qpos[j] >= p.sq) continue;
    const float lj = fmaxf(l[j], 1e-30f);
    T* dst = p.out + (((long long)b * p.sq + qpos[j]) * hq + h * g + r % g) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = cg + kColThreads * c;
      if (D % kColThreads != 0 && col >= D) continue;
      store(dst + col, acc[j][c] / lj);
    }
  }
}

template <typename T, int D>
int launch(const Params<T>& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  if (bytes > (size_t)kMaxSmemBytes) return -2;
  auto kernel = flash_attention_fwd<T, D>;
  // The attribute belongs to the current device, so it is set on every
  // call rather than remembered per process.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + p.tile_q - 1) / p.tile_q, p.hkv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(int d, Params<T>& p, int batch, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 24: return launch<T, 24>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 80: return launch<T, 80>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return -1;
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int batch, int sq, int skv, int hkv, int g, int head_dim,
                 const long long* strides, int causal, int window,
                 float scale, cudaStream_t stream) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<T*>(out);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.sq = sq;
  p.skv = skv;
  p.hkv = hkv;
  p.g = g;
  p.tile_q = kRows / g;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return launch_dim<T>(head_dim, p, batch, stream);
}

}  // namespace

// Plain C interface.  strides: the (batch, sequence, head) strides of q, k
// and v, in elements, nine in all; the head_dim stride is 1.  window <= 0
// means no window.  dtype: 0 = float32, 1 = bfloat16.  Returns 0 on a
// successful launch, a positive cudaError_t if the launch was refused, -1
// for a head_dim / dtype / extent the kernel is not built for and -2 if the
// group is larger than a block's rows.  Enqueues on `stream` and does not
// synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int sq, int skv, int hkv, int g,
                                      int head_dim, const long long* strides,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || g <= 0) return -1;
  if (batch > 65535 || hkv > 65535) return -1;
  if (g > kRows) return -2;
  switch (dtype) {
    case 0:
      return launch_typed<float>(q, k, v, out, batch, sq, skv, hkv, g,
                                 head_dim, strides, causal, window, scale, s);
    case 1:
      return launch_typed<__nv_bfloat16>(q, k, v, out, batch, sq, skv, hkv, g,
                                         head_dim, strides, causal, window,
                                         scale, s);
    default:
      return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == -1) return "unsupported head_dim, dtype or extent";
  if (code == -2) return "query group larger than a block's 128 rows";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
