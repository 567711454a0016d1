// Paged flash-decode GQA attention over the head-major KV block pool, for
// bf16 pools and for int8 pools with fp32 per-token scales.
//
// Replaces the TPU kernel repro/kernels/paged_decode_attention.py
// `_paged_decode_kernel` (bf16 pools; pallas_call at :273) with the entry
// point `paged_decode_attention_bf16`, and its int8-pool variant
// `_paged_decode_kernel_int8` (:119) with `paged_decode_attention_int8`.
// Same contract: q (B, Hkv, G, hd) bf16; pools (Hkv, num_blocks, bs, hd);
// int8 pools add scale pools (Hkv, num_blocks, bs) fp32 walked through the
// same table; block_tables (B, nb) int32; optional block_positions (B, nb)
// int32 (each slot's global base position, POS_PAD on slots to ignore);
// cache_len (B,). Writes o (B, Hkv, G, hd) in q's dtype and the §4.2.2
// partial l, m as fp32 (B, Hkv, G). The int8 kernel multiplies the scores
// by the k scale after q·k and before the softcap, and p by the v scale
// before the PV product (l sums the unscaled p), as the TPU kernel does;
// nothing dequantized is written anywhere.
//
// What bounds it on an H100: decode reads every live K/V row once and does
// 2·G flops per element read — a few flops per byte against the card's
// ~295 flop/byte ridge — so it is bound by device-memory bytes. int8 pools
// halve those bytes (hd + 4 per token-head instead of 2·hd).
//
// What the design does about it:
//  * one CTA per (sequence, kv head) walks the block table in a loop (the
//    TPU's sequential kb grid axis). Warp w takes table slots w, w+4, ...;
//    inside a pool block, each group of hd/EPL lanes owns one key row and
//    reads EPL elements of it per lane, so one read of a K row serves all G
//    query heads of the group (GQA reuse). bf16: EPL = 8 (16-byte loads).
//    int8: EPL = 16 (16-byte loads, twice the rows per warp load) for
//    G <= 4; at G = 8 the q and accumulator registers (2·G·EPL floats per
//    lane) would spill, so EPL = 8 (8-byte loads).
//  * U rows per lane are loaded before any arithmetic, keeping U row loads
//    of K and V (and their scales) in flight per lane.
//  * every row group keeps its own fp32 online-softmax state per query
//    head; the states are merged once at the end in shared memory by the
//    §4.2.2 rule.
//  * masks select, never multiply: a masked row is never loaded (its k, v
//    and scales stay 0) and its p is 0, so stale or NaN memory behind a
//    padded table slot or past cache_len — values or scales — cannot reach
//    the accumulator; a table slot whose rows are all masked is skipped
//    without a load, which is exact.
//  * not done yet: splitting one sequence's KV across CTAs. With B·Hkv CTAs
//    (64 at B=8, Hkv=8) on 132 SMs the card is under-occupied (PERF.md).

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// The raw vector one lane loads per key row: EPL elements of T.
template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };

__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const __nv_bfloat16*) {
  bf16x8_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const int8_t*) {
  int8x16_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint2& r, float* out,
                                       const int8_t*) {
  int8x8_to_float(r, out);
}
__device__ __forceinline__ uint4 load_raw(const void* p, uint4*) {
  return ldg16(p);
}
__device__ __forceinline__ uint2 load_raw(const void* p, uint2*) {
  return ldg8(p);
}

template <typename T, int HD, int G, int U, int EPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ block_positions,
                    const int32_t* __restrict__ cache_len,
                    __nv_bfloat16* __restrict__ o,
                    float* __restrict__ l_out,
                    float* __restrict__ m_out,
                    int Hkv, int num_blocks, int bs, int nb,
                    int sliding_window, int sinks, float softcap,
                    float scale) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  using Raw = typename RawVec<static_cast<int>(EPL * sizeof(T))>::type;
  constexpr int LPR = HD / EPL;          // lanes per key row
  constexpr int RPW = 32 / LPR;          // key rows one warp load covers
  constexpr int NGROUPS = kWarps * RPW;  // independent softmax states

  __shared__ float sm_m[NGROUPS][G];
  __shared__ float sm_l[NGROUPS][G];
  __shared__ float sm_acc[NGROUPS][G][HD];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;            // which row of a warp load
  const int cl = lane % LPR;             // which EPL-element slice of hd
  const int group = warp * RPW + sub;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < EPL / 8; ++c)
      bf16x8_to_float(ldg16(q + (bh * G + g) * HD + cl * EPL + c * 8),
                      qf[g] + c * 8);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] *= scale;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int len = cache_len[b];
  const int win_lo = len - sliding_window;   // first in-window position
  const int32_t* table = block_tables + static_cast<size_t>(b) * nb;
  const int32_t* bpos = block_positions
      ? block_positions + static_cast<size_t>(b) * nb : nullptr;

  for (int kb = warp; kb < nb; kb += kWarps) {
    const int base = bpos ? bpos[kb] : kb * bs;
    // whole-slot skip (uniform over the warp): every row is masked
    if (base >= len) continue;
    if (sliding_window > 0 && base + bs <= win_lo &&
        !(sinks > 0 && base < sinks)) continue;
    const size_t tile = (static_cast<size_t>(h) * num_blocks + table[kb]) * bs;
    const T* kt = k_pool + tile * HD + cl * EPL;
    const T* vt = v_pool + tile * HD + cl * EPL;

    for (int r0 = 0; r0 < bs; r0 += U * RPW) {
      Raw kraw[U], vraw[U];
      float ksc[U], vsc[U];
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * RPW + sub;
        const int pos = base + r;
        bool ok = r < bs && pos < len;
        if (sliding_window > 0)
          ok = ok && (pos >= win_lo || (sinks > 0 && pos < sinks));
        valid[u] = ok;
        kraw[u] = Raw{};
        vraw[u] = Raw{};
        ksc[u] = kQuant ? 0.f : 1.f;
        vsc[u] = ksc[u];
        if (ok) {
          kraw[u] = load_raw(kt + static_cast<size_t>(r) * HD, &kraw[u]);
          vraw[u] = load_raw(vt + static_cast<size_t>(r) * HD, &vraw[u]);
          if constexpr (kQuant) {
            ksc[u] = __ldg(k_scale + tile + r);
            vsc[u] = __ldg(v_scale + tile + r);
          }
        }
      }

      float s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[EPL];
        unpack(kraw[u], kf, k_pool);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          if (kQuant) d *= ksc[u];          // fused k dequant, pre-cap
          if (softcap > 0.f) d = softcap * tanhf(d / softcap);
          s[u][g] = valid[u] ? d : NEG_INF;
        }
      }

#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = __expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u][g] = valid[u] ? __expf(s[u][g] - m_new) : 0.f;   // p
          psum += s[u][g];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      }

#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[EPL];
        unpack(vraw[u], vf, v_pool);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pw = kQuant ? s[u][g] * vsc[u] : s[u][g];  // v dequant
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pw, vf[e], acc[g][e]);
        }
      }
    }
  }

  // merge the row groups' partials (§4.2.2) and normalise
  if (cl == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[group][g] = m[g];
      sm_l[group][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[group][g][cl * EPL + e] = acc[g][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float M = NEG_INF;
#pragma unroll
    for (int i = 0; i < NGROUPS; ++i) M = fmaxf(M, sm_m[i][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int i = 0; i < NGROUPS; ++i) {
      const float w = __expf(sm_m[i][g] - M);
      L = fmaf(sm_l[i][g], w, L);
      A = fmaf(sm_acc[i][g][d], w, A);
    }
    o[(bh * G + g) * HD + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    if (d == 0) {
      l_out[bh * G + g] = L;
      m_out[bh * G + g] = M;
    }
  }
}

struct Args {
  const __nv_bfloat16* q;
  const void *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int32_t *tables, *positions, *cache_len;
  __nv_bfloat16* o;
  float *l, *m;
  int B, Hkv, num_blocks, bs, nb, sliding_window, sinks;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int HD, int G>
cudaError_t launch(const Args& a) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  // bf16: 8 elements (16 bytes) per lane. int8: 16 elements (16 bytes) per
  // lane while the q + accumulator registers (2·G·EPL) fit, else 8.
  constexpr int EPL = (kQuant && G <= 4) ? 16 : 8;
  constexpr int U = (kQuant || G > 4) ? 4 : 8;
  const dim3 grid(a.B, a.Hkv);
  paged_decode_kernel<T, HD, G, U, EPL><<<grid, kThreads, 0, a.stream>>>(
      a.q, static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      a.k_scale, a.v_scale, a.tables, a.positions, a.cache_len, a.o, a.l,
      a.m, a.Hkv, a.num_blocks, a.bs, a.nb, a.sliding_window, a.sinks,
      a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    case 8: return launch<T, HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int head_dim, int G, const Args& a) {
  switch (head_dim) {
    case 64: return static_cast<int>(dispatch_group<T, 64>(G, a));
    case 128: return static_cast<int>(dispatch_group<T, 128>(G, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale,
               const void* block_tables, const void* block_positions,
               const void* cache_len, void* o, void* l, void* m, int B,
               int Hkv, int head_dim, int num_blocks, int block_size, int nb,
               int sliding_window, int attention_sinks, float logit_softcap,
               void* stream) {
  return Args{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
              static_cast<const float*>(k_scale),
              static_cast<const float*>(v_scale),
              static_cast<const int32_t*>(block_tables),
              static_cast<const int32_t*>(block_positions),
              static_cast<const int32_t*>(cache_len),
              static_cast<__nv_bfloat16*>(o), static_cast<float*>(l),
              static_cast<float*>(m), B, Hkv, num_blocks, block_size, nb,
              sliding_window, attention_sinks, logit_softcap,
              1.0f / sqrtf(static_cast<float>(head_dim)),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace
}  // namespace repro_torch

// Plain C entry points (bound with ctypes). Both launch on `stream` and
// return cudaGetLastError() as an int (0 = launched); cudaErrorInvalidValue
// for a head_dim / group size the kernel is not instantiated for. The bf16
// entry ignores k_scale / v_scale; the int8 entry needs both.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* block_tables, const void* block_positions,
    const void* cache_len, void* o, void* l, void* m,
    int B, int Hkv, int G, int head_dim, int num_blocks, int block_size,
    int nb, int sliding_window, int attention_sinks, float logit_softcap,
    void* stream) {
  using namespace repro_torch;
  const Args a = make_args(q, k_pool, v_pool, nullptr, nullptr, block_tables,
                           block_positions, cache_len, o, l, m, B, Hkv,
                           head_dim, num_blocks, block_size, nb,
                           sliding_window, attention_sinks, logit_softcap,
                           stream);
  return dispatch<__nv_bfloat16>(head_dim, G, a);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* block_tables, const void* block_positions,
    const void* cache_len, void* o, void* l, void* m,
    int B, int Hkv, int G, int head_dim, int num_blocks, int block_size,
    int nb, int sliding_window, int attention_sinks, float logit_softcap,
    void* stream) {
  using namespace repro_torch;
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                           block_positions, cache_len, o, l, m, B, Hkv,
                           head_dim, num_blocks, block_size, nb,
                           sliding_window, attention_sinks, logit_softcap,
                           stream);
  return dispatch<int8_t>(head_dim, G, a);
}
