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
//   out  (B, Sq, Hq, D) contiguous, in q's type; sums in fp32
//   key j is attended by query i iff j < Skv, (causal) j <= i and
//   (window) j > i - window; positions start at 0 for both.
//
// Rows: a block has 256 threads and 128 rows, a row being one (query
// position, query head) pair: the tile holds 128 / g positions times the g
// heads, so each 64-key K/V tile is read once for the whole group.
//
// Band: the block visits the KV tiles from the one holding
// max(0, first_position - window + 1) to the one holding
// min(Skv, last_position + 1) (causal).  This is exact: a row for which a
// visited tile is wholly masked before its first valid key gets m = NEG_INF,
// l = 64 and acc = sum(v), and its first valid tile wipes them through
// corr = exp(NEG_INF - m) = 0 in fp32; a masked key after the first valid
// one gives p = exp(NEG_INF - m) = 0.  The rescale-then-accumulate order of
// the reference is kept.  Keys are masked with the true Skv.
//
// Bound: at the serving shape (B 2, S 8192, Hq 32, Hkv 8, D 80, window
// 4096) the two products need ~5.2e11 FLOP against ~2.1e8 bytes, far above
// the card's ~295 FLOP/byte, so the bound is operations: the tensor cores'
// bf16 rate.
//
// Two kernels, chosen by dtype:
//
// * bf16, flash_attention_tc (the serving path): FlashAttention-2 on the
//   tensor cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  Each of
//   the 8 warps owns 16 rows.  Q's A fragments are loaded once by ldmatrix
//   and stay in registers; S = Q K^T for a 64-key tile accumulates in fp32
//   registers; mask, running max and sum are quad shuffles on the
//   accumulator layout, in log2 units (exp2f); P is rounded to bf16 in
//   registers and used directly as the A operand of P V (V's B fragments by
//   ldmatrix.trans); O accumulates in fp32 and is rounded to bf16 once at
//   the end.  K/V tiles go through a two-stage ring in shared memory by
//   16-byte cp.async copies, so tile n+1 loads while tile n computes, with
//   one barrier a tile.  Rows are padded by 16 bytes, so the 8 rows an
//   ldmatrix reads fall in 8 distinct bank groups (D 80 has 160-byte rows).
//   D 24 has its contraction zero-padded to 32 in shared memory (and so in
//   Q's fragments); P V needs only multiples of 8.  Shared memory is
//   2 x 128 x (D_pad + 8) bf16: 45 KB at D 80, 68 KB at D 128, so two
//   blocks share an SM.  Tiles that lie inside the band for every position
//   of the block skip the mask.  Rounding p to bf16 before P V moves an
//   output by at most 2^-9 * sum(p |v|), as SDPA's does; chip_smoke.py holds
//   the kernel to that bound (kernels/flash_attention/ref.py::bf16_bound).
//   What it leaves: mma.sync reaches a fraction of the tensor cores' rate;
//   wgmma with TMA copies and warp-specialised producer / consumer warps
//   is the next step, a larger change than this one.
//
// * fp32, flash_attention_fwd: kept on the CUDA cores, because an fp32
//   product on the tensor cores would be TF32 and break the 2e-6 fp32
//   tolerance.  Threads form 16 row groups of 8 rows; the 16 threads of a
//   row group (one half warp) split the tile's 64 keys four each for the
//   logits, and the D columns of the output for p @ V, so the row-wise max
//   and sum are half-warp shuffles; (m, l) and the output rows live in
//   registers.  Every K/V element is read from device memory once per block
//   (16-byte loads) and reused for 128 rows from shared memory.
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ------------------------------------------------ bf16 on the tensor cores --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned addr, unsigned& r0,
                                              unsigned& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the bf16 kernel: two stages of 128 rows of D_pad + 8
// bf16 (the 16 bytes of padding put the 8 rows an ldmatrix reads in 8
// distinct bank groups).  A stage holds the K tile in rows 0-63 and the V
// tile in rows 64-127; stage 1 first holds the query tile, which goes into
// registers before stage 1 gets its first K/V tile.
template <int D>
struct TcShape {
  static constexpr int kDp = (D + 15) / 16 * 16;  // contraction, padded
  static constexpr int kStride = kDp + 8;         // bf16 a shared row
  static constexpr int kStage = kRows * kStride;  // bf16 a stage
  static constexpr size_t kSmemBytes = 2 * kStage * sizeof(__nv_bfloat16);
};

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 80 ? 2 : 1)
flash_attention_tc(const Params<__nv_bfloat16> p) {
  using S = TcShape<D>;
  constexpr int kKSteps = S::kDp / 16;       // k-steps of Q.K^T
  constexpr int kNTiles = D / 8;             // 8-wide column tiles of out
  constexpr int kChunks = D / 8;             // 16-byte vectors a row
  static_assert(D % 8 == 0, "rows must be whole 16-byte vectors");
  static_assert(kRows == 16 * (kThreads / 32), "16 rows a warp");

  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = p.g;
  const int q0 = blockIdx.x * p.tile_q;
  const int rows = p.tile_q * g;              // rows in use, <= kRows
  const int q_last = min(q0 + p.tile_q, p.sq) - 1;

  // ---- D 24: the contraction's padding columns are zeros in every row
  if (S::kDp != D) {
    for (int r = tid; r < 2 * kRows; r += kThreads)
      for (int c = D; c < S::kDp; c += 8)
        *reinterpret_cast<uint4*>(sm + r * S::kStride + c) =
            make_uint4(0, 0, 0, 0);
  }

  // ---- the query tile into stage 1; rows beyond the tile or Sq are zeros
  __nv_bfloat16* q_s = sm + S::kStage;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int qi = q0 + r / g;
    const bool ok = r < rows && qi < p.sq;
    const __nv_bfloat16* src =
        ok ? p.q + b * p.q_sb + qi * p.q_ss + (long long)(h * g + r % g) * p.q_sh + c
           : p.q;
    cp_async16(smem_addr(q_s + r * S::kStride + c), src, ok);
  }
  cp_async_commit();

  // ---- the KV tiles that meet the band of positions q0 .. q_last
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int k_end = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int kt0 = (k_begin / kTileK) * kTileK;
  const int n_tiles = max(0, (k_end - kt0 + kTileK - 1) / kTileK);

  // K rows 0-63, V rows 64-127 of a stage; keys beyond Skv are zeros
  auto load_tile = [&](int stage, int k0) {
    __nv_bfloat16* base = sm + stage * S::kStage;
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int j = i / kChunks;
      const int c = (i % kChunks) * 8;
      const int kp = k0 + j;
      const bool ok = kp < p.skv;
      const long long kr = ok ? b * p.k_sb + kp * p.k_ss + h * p.k_sh + c : 0;
      const long long vr = ok ? b * p.v_sb + kp * p.v_ss + h * p.v_sh + c : 0;
      cp_async16(smem_addr(base + j * S::kStride + c), p.k + kr, ok);
      cp_async16(smem_addr(base + (kTileK + j) * S::kStride + c), p.v + vr,
                 ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, kt0);

  cp_async_wait_all();
  __syncthreads();
  // Q's A fragments for every k-step stay in registers
  unsigned qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldsm_x4(smem_addr(q_s + (warp * 16 + lane % 16) * S::kStride + kk * 16 +
                      (lane / 16) * 8),
            qf[kk]);

  // this thread's two rows of the accumulator layout: r, r + 8
  const int r0 = warp * 16 + lane / 4;
  const int qpos[2] = {q0 + r0 / g, q0 + (r0 + 8) / g};
  const int t2 = 2 * (lane % 4);             // first of its two columns
  const float scale_log2 = p.scale * kLog2e;
  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};                 // this thread's share of the row

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kt0 + it * kTileK;
    if (it > 0) cp_async_wait_all();
    // tile it is in; every warp is done with tile it-1 (and with Q)
    __syncthreads();
    if (it + 1 < n_tiles) load_tile((it + 1) & 1, k0 + kTileK);
    const __nv_bfloat16* k_s = sm + (it & 1) * S::kStage;
    const __nv_bfloat16* v_s = k_s + kTileK * S::kStride;

    // ---- S = Q K^T over the 64 keys: 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kb[4];
        ldsm_x4(smem_addr(k_s +
                          (np * 16 + lane % 8 + (lane / 16) * 8) * S::kStride +
                          kk * 16 + ((lane / 8) % 2) * 8),
                kb);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // ---- scale to log2 units; mask unless the tile lies inside the band
    // for every position of the block
    const bool inside = k0 + kTileK <= p.skv &&
                        (!p.causal || k0 + kTileK - 1 <= q0) &&
                        (p.window <= 0 || k0 > q_last - p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!inside) {
          const int kp = k0 + 8 * j + t2 + (e & 1);
          const int qp = qpos[e / 2];
          const bool ok = kp < p.skv && (!p.causal || kp <= qp) &&
                          (p.window <= 0 || kp > qp - p.window);
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }

    // ---- running softmax of the two rows: rescale first
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx));
      const float corr = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= corr;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        o[n][2 * hr] *= corr;
        o[n][2 * hr + 1] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - m_new);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - m_new);
        l[hr] += s[j][2 * hr] + s[j][2 * hr + 1];
      }
    }

    // ---- O += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v_row =
          v_s + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * S::kStride;
#pragma unroll
      for (int n = 0; n + 1 < kNTiles; n += 2) {
        unsigned vb[4];
        ldsm_x4_trans(smem_addr(v_row + n * 8 + (lane / 16) * 8), vb);
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
      if (kNTiles % 2) {
        unsigned v0, v1;
        ldsm_x2_trans(smem_addr(v_row + (kNTiles - 1) * 8), v0, v1);
        mma_bf16(o[kNTiles - 1], pa, v0, v1);
      }
    }
  }

  // ---- out = O / l for the rows that are real, rounded to bf16 once
  const int hq = p.hkv * g;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.0f / fmaxf(quad_sum(l[hr]), 1e-30f);
    const int r = r0 + 8 * hr;
    if (r >= rows || qpos[hr] >= p.sq) continue;
    __nv_bfloat16* dst =
        p.out + (((long long)b * p.sq + qpos[hr]) * hq + h * g + r % g) * D + t2;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
}

template <int D>
int launch(const Params<float>& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  if (bytes > (size_t)kMaxSmemBytes) return -2;
  auto kernel = flash_attention_fwd<float, D>;
  // The attribute belongs to the current device, so it is set on every
  // call rather than remembered per process.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + p.tile_q - 1) / p.tile_q, p.hkv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Params<__nv_bfloat16>& p, int batch, cudaStream_t stream) {
  const size_t bytes = TcShape<D>::kSmemBytes;
  auto kernel = flash_attention_tc<D>;
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
    case 16: return launch<16>(p, batch, stream);
    case 24: return launch<24>(p, batch, stream);
    case 32: return launch<32>(p, batch, stream);
    case 64: return launch<64>(p, batch, stream);
    case 80: return launch<80>(p, batch, stream);
    case 128: return launch<128>(p, batch, stream);
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
