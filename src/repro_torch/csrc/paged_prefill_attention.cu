// Paged-context chunk-prefill GQA attention, over a bf16 pool or an int8
// pool with fp32 per-token scales.
//
// Replaces the TPU kernel repro/kernels/paged_prefill_attention.py
// `_paged_prefill_chunk_kernel` (:54, bf16 pools; wrapper
// `paged_prefill_chunk_attention`, pallas_call at :294) with the entry
// point `paged_prefill_chunk_attention_bf16`, and its int8-pool variant
// `_paged_prefill_chunk_kernel_int8` (:128) with
// `paged_prefill_chunk_attention_int8`: the prefix streams in as int8 with
// its scale pools (Hkv, num_blocks, bs) on the same table walk; the chunk's
// own K/V stay bf16 with scale 1.0. The k scale multiplies the scores
// before the softcap, the v scale multiplies p before the PV product (l
// sums the unscaled p), as the TPU kernel does.
// Same contract: one chunk's queries q (C, H, hd) sit
// at global positions [P, P+C), P = nb·bs; they attend over the sequence's
// first nb pool blocks (block_table (nb,) into the head-major pools
// (Hkv, num_blocks, bs, hd)) and then over the chunk's own k/v (C, Hkv, hd),
// under per-row causal / sliding-window / sink masks and the optional logit
// softcap. Writes out (C, H, hd) in q's dtype.
//
// What bounds it on an H100: a 512-token chunk over a 1.5k-token prefix does
// ~500 flops per byte of K/V read — above the ridge, so it is bound by
// operations. This first version computes in fp32 on the CUDA cores (no
// tensor cores), so its own ceiling is the fp32 rate, far below the bf16
// tensor-core peak the bound is stated against (PERF.md).
//
// What the design does about it:
//  * one CTA per (kv head, tile of query rows). A tile is 64 rows = G heads ×
//    64/G positions, so every K/V tile loaded into shared memory serves all
//    G query heads of the group; q, k_chunk and v_chunk are read in place
//    through their strides (no pad copy, no transpose in the wrapper).
//  * keys stream in tiles of 32: first the prefix through the block table,
//    then the chunk's own keys. The walk stops at the tile's last query
//    position (causal) and skips tiles that lie wholly outside every row's
//    window and hold no sink — both exact.
//  * each thread owns a 4×4 block of scores and a 4×(hd/8) block of the
//    output; fp32 online softmax per row, row statistics reduced across the
//    8 lanes that share the rows.
//  * masks select, never multiply: p = 0 where (row, key) is masked, and k,
//    v are zero-filled (never loaded) for keys past P + C.
//  * int8 prefix rows are converted to fp32 as they are staged into shared
//    memory (8-byte loads, half the bytes of bf16), with the tile's k and v
//    scale vectors staged beside them; nothing dequantized reaches device
//    memory.

#include <cmath>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int BR = 64;       // query rows per CTA, g-major: row = g·(BR/G) + t
constexpr int BK = 32;       // keys per tile
constexpr int PS = BR + 4;   // padded row stride of the P tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * BR + HD * BK + BK * HD + BK * PS + 2 * BK);
}

// 8 pool elements -> 8 floats (16-byte bf16 load, 8-byte int8 load).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  bf16x8_to_float(ldg16(p), f);
}
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  int8x8_to_float(ldg8(p), f);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int32_t* __restrict__ block_table,
                           const __nv_bfloat16* __restrict__ k_chunk,
                           const __nv_bfloat16* __restrict__ v_chunk,
                           __nv_bfloat16* __restrict__ out,
                           int C, int H, int Hkv, int G, int num_blocks,
                           int bs, int nb, int sliding_window, int sinks,
                           float softcap, float scale) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int NJ = HD / 32;            // output float4 columns per row
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                      // [HD][BR]  q·scale, transposed
  float* Kt = Qt + HD * BR;              // [HD][BK]  k, transposed
  float* Vs = Kt + HD * BK;              // [BK][HD]
  float* Ps = Vs + BK * HD;              // [BK][PS]  probabilities
  float* Ksc = Ps + BK * PS;             // [BK]      k scales (int8 pools)
  float* Vsc = Ksc + BK;                 // [BK]      v scales (int8 pools)

  const int BT = BR / G;                 // positions per tile
  const int t0 = blockIdx.x * BT;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;               // rows rg·4 .. rg·4+3
  const int cg = tid & 7;                // score cols cg·4.., out cols cg·4+32j..
  const int P = nb * bs;
  const int total = P + C;

  for (int idx = tid; idx < BR * (HD / 8); idx += kThreads) {
    const int row = idx % BR;
    const int ch = idx / BR;
    const int t = t0 + row % BT;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t < C)
      bf16x8_to_float(ldg16(q + (static_cast<size_t>(t) * H + kvh * G +
                                 row / BT) * HD + ch * 8), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) Qt[(ch * 8 + e) * BR + row] = f[e] * scale;
  }

  float m[4], l[4], acc[4][NJ * 4];
  int pos_q[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + (rg * 4 + i) % BT;
    row_ok[i] = t < C;
    pos_q[i] = P + t;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ * 4; ++c) acc[i][c] = 0.f;
  }

  const int key_end = P + min(t0 + BT, C);         // causal stop (exclusive)
  const int win_first = P + t0 - sliding_window;   // keys <= this: outside
  for (int k0 = 0; k0 < key_end; k0 += BK) {
    // tile outside every row's window and holding no sink (CTA-uniform)
    if (sliding_window > 0 && k0 + BK - 1 <= win_first &&
        !(sinks > 0 && k0 < sinks)) continue;
    __syncthreads();   // the previous tile's readers are done

    // K tile, transposed: consecutive lanes take consecutive keys
    for (int idx = tid; idx < BK * (HD / 8); idx += kThreads) {
      const int key = idx % BK;
      const int ch = idx / BK;
      const int kp = k0 + key;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kp < P) {
        const size_t row = (static_cast<size_t>(kvh) * num_blocks +
                            block_table[kp / bs]) * bs + kp % bs;
        load8(k_pool + row * HD + ch * 8, f);
      } else if (kp < total) {
        bf16x8_to_float(ldg16(k_chunk + (static_cast<size_t>(kp - P) * Hkv +
                                         kvh) * HD + ch * 8), f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) Kt[(ch * 8 + e) * BK + key] = f[e];
    }
    // V tile, row-major: consecutive lanes take consecutive hd slices
    for (int idx = tid; idx < BK * (HD / 8); idx += kThreads) {
      const int key = idx / (HD / 8);
      const int ch = idx % (HD / 8);
      const int kp = k0 + key;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kp < P) {
        const size_t row = (static_cast<size_t>(kvh) * num_blocks +
                            block_table[kp / bs]) * bs + kp % bs;
        load8(v_pool + row * HD + ch * 8, f);
      } else if (kp < total) {
        bf16x8_to_float(ldg16(v_chunk + (static_cast<size_t>(kp - P) * Hkv +
                                         kvh) * HD + ch * 8), f);
      }
      float4* dst = reinterpret_cast<float4*>(Vs + key * HD + ch * 8);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    // the tile's scale vectors: the prefix's own, 1.0 for chunk keys
    if constexpr (kQuant) {
      for (int key = tid; key < BK; key += kThreads) {
        const int kp = k0 + key;
        float ks = 1.f, vs = 1.f;
        if (kp < P) {
          const size_t row = (static_cast<size_t>(kvh) * num_blocks +
                              block_table[kp / bs]) * bs + kp % bs;
          ks = __ldg(k_scale + row);
          vs = __ldg(v_scale + row);
        }
        Ksc[key] = ks;
        Vsc[key] = vs;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * BR + rg * 4);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + d * BK + cg * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float ksj[4], vsj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ksj[j] = kQuant ? Ksc[cg * 4 + j] : 1.f;
      vsj[j] = kQuant ? Vsc[cg * 4 + j] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg * 4 + j;
        bool v = row_ok[i] && kp < total && kp <= pos_q[i];
        if (sliding_window > 0)
          v = v && (kp > pos_q[i] - sliding_window || (sinks > 0 && kp < sinks));
        ok[j] = v;
        float x = kQuant ? s[i][j] * ksj[j] : s[i][j];   // fused k dequant
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = v ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Ps[(cg * 4 + j) * PS + rg * 4 + i] =
            kQuant ? (ok[j] ? p * vsj[j] : 0.f) : p;       // fused v dequant
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + k * PS + rg * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + k * HD + jj * 32 + cg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] = fmaf(pa[i], vv.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pa[i], vv.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pa[i], vv.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pa[i], vv.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int row = rg * 4 + i;
    const int t = t0 + row % BT;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* dst = out + (static_cast<size_t>(t) * H + kvh * G +
                                row / BT) * HD;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][jj * 4 + 0] * inv,
                                                acc[i][jj * 4 + 1] * inv);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][jj * 4 + 2] * inv,
                                                acc[i][jj * 4 + 3] * inv);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + jj * 32 + cg * 4) = packed;
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_table, const void* k_chunk,
                   const void* v_chunk, void* out, int C, int H, int Hkv,
                   int num_blocks, int bs, int nb, int sliding_window,
                   int sinks, float softcap, cudaStream_t stream) {
  const int G = H / Hkv;
  const int BT = BR / G;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_chunk_kernel<HD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((C + BT - 1) / BT, Hkv);
  paged_prefill_chunk_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(block_table),
      static_cast<const __nv_bfloat16*>(k_chunk),
      static_cast<const __nv_bfloat16*>(v_chunk),
      static_cast<__nv_bfloat16*>(out), C, H, Hkv, G, num_blocks, bs, nb,
      sliding_window, sinks, softcap,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale,
             const void* block_table, const void* k_chunk,
             const void* v_chunk, void* out, int C, int H, int Hkv,
             int head_dim, int num_blocks, int block_size, int nb,
             int sliding_window, int attention_sinks, float logit_softcap,
             void* stream) {
  if (Hkv < 1 || H % Hkv || BR % (H / Hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, T>(q, k_pool, v_pool, k_scale, v_scale, block_table,
                           k_chunk, v_chunk, out, C, H, Hkv, num_blocks,
                           block_size, nb, sliding_window, attention_sinks,
                           logit_softcap, s);
    case 128:
      return launch<128, T>(q, k_pool, v_pool, k_scale, v_scale,
                            block_table, k_chunk, v_chunk, out, C, H, Hkv,
                            num_blocks, block_size, nb, sliding_window,
                            attention_sinks, logit_softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry points (bound with ctypes). q, k_chunk, v_chunk, out are
// contiguous bf16 (C, H|Hkv, hd); both launch on `stream` and return
// cudaGetLastError() as an int (0 = launched); cudaErrorInvalidValue for a
// head_dim or group size (H / Hkv must divide 64) the kernel does not take.
// The bf16 entry ignores k_scale / v_scale; the int8 entry needs both.
extern "C" int paged_prefill_chunk_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* block_table, const void* k_chunk, const void* v_chunk,
    void* out, int C, int H, int Hkv, int head_dim, int num_blocks,
    int block_size, int nb, int sliding_window, int attention_sinks,
    float logit_softcap, void* stream) {
  return repro_torch::dispatch<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, block_table, k_chunk, v_chunk,
      out, C, H, Hkv, head_dim, num_blocks, block_size, nb, sliding_window,
      attention_sinks, logit_softcap, stream);
}

extern "C" int paged_prefill_chunk_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* block_table, const void* k_chunk, const void* v_chunk,
    void* out, int C, int H, int Hkv, int head_dim, int num_blocks,
    int block_size, int nb, int sliding_window, int attention_sinks,
    float logit_softcap, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::dispatch<int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, block_table, k_chunk, v_chunk,
      out, C, H, Hkv, head_dim, num_blocks, block_size, nb, sliding_window,
      attention_sinks, logit_softcap, stream);
}
