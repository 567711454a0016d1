// Flash-decode GQA attention over a DENSE head-major KV cache, bf16 or
// int8 with fp32 per-token scales.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// `_decode_attn_kernel` (wrapper `decode_attention`, pallas_call at :118)
// with the entry point `decode_attention_bf16`. Same contract: q (B, Hkv,
// G, hd) bf16; k/v cache (B, Hkv, S, hd) bf16, head-major; cache_len (B,)
// int32. A slot is attended when pos < cache_len and, with a window w > 0,
// pos >= cache_len - w or pos < sinks. The optional tanh softcap applies to
// the scores before the mask. Writes o (B, Hkv, G, hd) bf16 and the §4.2.2
// partial l, m as fp32 (B, Hkv, G); an all-masked row gives l = 0,
// m = NEG_INF, o = 0.
//
// `decode_attention_int8` is the same kernel over an int8 cache (B, Hkv, S,
// hd) with fp32 per-token scales (B, Hkv, S): the k scale multiplies the
// score after q·k and before the softcap, the v scale multiplies p before
// the PV product, and l sums the unscaled p (the rule of the int8 paged
// kernel). The reference's Pallas kernel takes no scales; its int8 dense
// caches run the jnp partial (repro/models/attention.py:175, with
// k_scale), of which this entry is the device form. Nothing dequantized is
// written anywhere.
//
// What bounds it on an H100: decode reads every live K/V row once and does
// 2·G flops per element read — a few flops per byte against the card's
// ~295 flop/byte ridge — so it is bound by device-memory bytes (int8 caches
// read hd + 4 bytes per token-head for K and for V instead of 2·hd).
//
// What the design does about it (the paged decode kernel's design, with
// dense addressing in place of the block-table walk):
//  * one CTA per (sequence, kv head) walks the sequence in tiles of
//    U·RPW rows (the TPU's sequential kb grid axis); warp w takes tiles
//    w, w+4, ... Inside a tile each group of LPR lanes owns one key row
//    and reads EPL elements of it per lane (16-byte loads; 8 bytes at
//    G = 16, where the 2·G·EPL q and accumulator floats a lane must fit the
//    registers), so one read of a K row serves all G query heads of the
//    group (GQA reuse). LPR is hd/EPL rounded up to a power of two: at
//    hd = 112 the last lanes of a row hold no data, load nothing and add
//    0, so the xor shuffles stay inside the row.
//  * U rows per lane are loaded before any arithmetic, keeping U row loads
//    of K and V in flight per lane.
//  * every row group keeps its own fp32 online-softmax state per query
//    head; the states are merged once at the end in shared memory by the
//    §4.2.2 rule.
//  * masks select, never multiply: a masked row is never loaded (its k and
//    v, and for int8 its scales, stay 0) and its p is 0, so stale or NaN
//    memory past cache_len cannot reach the accumulator; a tile whose rows
//    are all masked (before the window, or past cache_len) is skipped
//    without a load, which is exact.
//  * not done yet: splitting one sequence across CTAs. With B·Hkv CTAs
//    (64 at llama3-8b's B=8, Hkv=8; 16 at glm4-9b's Hkv=2) on 132 SMs the
//    card is under-occupied.

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T, int HD, int G>
struct Cfg {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int EPL = G > 8 ? 4 : (kQuant && G <= 4) ? 16 : 8;
  static constexpr int CHUNK = EPL * static_cast<int>(sizeof(T));  // bytes
  static constexpr int LPR_HD = HD / EPL;       // lanes holding data
  static constexpr int LPR = pow2_ceil(LPR_HD); // lanes per key row
  static constexpr int RPW = 32 / LPR;          // key rows one warp load covers
  static constexpr int NGROUPS = kWarps * RPW;  // independent softmax states
  // rows loaded ahead per lane: 8; fewer where the q and accumulator
  // registers (2·G·EPL floats a lane) would otherwise spill
  static constexpr int U = G * EPL >= 64 ? (G > 8 ? 2 : 4) : 8;
  static constexpr int TILE = U * RPW;          // rows a warp takes per tile
  static_assert(HD % EPL == 0 && LPR <= 32, "whole chunks, one warp a row");
};

template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = uint32_t; };

template <typename R>
__device__ __forceinline__ R load_raw(const void* p) {
  return __ldg(reinterpret_cast<const R*>(p));
}

__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const __nv_bfloat16*) {
  bf16x8_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint2& r, float* out,
                                       const __nv_bfloat16*) {
  bf16x4_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const int8_t*) {
  int8x16_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint2& r, float* out,
                                       const int8_t*) {
  int8x8_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint32_t& r, float* out,
                                       const int8_t*) {
  int8x4_to_float(r, out);
}

template <typename R>
__device__ __forceinline__ R zero_raw();
template <> __device__ __forceinline__ uint4 zero_raw<uint4>() {
  return make_uint4(0, 0, 0, 0);
}
template <> __device__ __forceinline__ uint2 zero_raw<uint2>() {
  return make_uint2(0, 0);
}
template <> __device__ __forceinline__ uint32_t zero_raw<uint32_t>() {
  return 0u;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ cache_len,
                    __nv_bfloat16* __restrict__ o,
                    float* __restrict__ l_out,
                    float* __restrict__ m_out,
                    int Hkv, int S, int64_t bstride, int sliding_window,
                    int sinks, float softcap, float scale) {
  using C = Cfg<T, HD, G>;
  constexpr bool kQuant = C::kQuant;
  constexpr int EPL = C::EPL, LPR = C::LPR, LPR_HD = C::LPR_HD;
  constexpr int RPW = C::RPW, NGROUPS = C::NGROUPS, U = C::U;
  constexpr int TILE = C::TILE;
  using Raw = typename RawVec<C::CHUNK>::type;

  __shared__ float sm_m[NGROUPS][G];
  __shared__ float sm_l[NGROUPS][G];
  __shared__ float sm_acc[NGROUPS][G][HD];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;            // which row of a warp load
  const int cl = lane % LPR;             // which EPL-element slice of hd
  const bool has_data = cl < LPR_HD;     // pad lanes of a row load nothing
  const int cd = has_data ? cl : 0;
  const int group = warp * RPW + sub;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* src = q + (bh * G + g) * HD + cd * EPL;
    if constexpr (EPL == 4) {
      bf16x4_to_float(__ldg(reinterpret_cast<const uint2*>(src)), qf[g]);
    } else {
#pragma unroll
      for (int c = 0; c < EPL / 8; ++c)
        bf16x8_to_float(ldg16(src + c * 8), qf[g] + c * 8);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] = has_data ? qf[g][e] * scale
                                                      : 0.f;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int len = min(cache_len[b], S);
  const int win_lo = cache_len[b] - sliding_window;  // first in-window pos
  // the caches' sequence b starts bstride elements after b - 1 (a head
  // slice of a wider cache: the head partition's worker reads in place)
  const size_t kv0 = static_cast<size_t>(b) * bstride +
                     static_cast<size_t>(h) * S * HD;
  const T* kt = k_cache + kv0 + cd * EPL;
  const T* vt = v_cache + kv0 + cd * EPL;
  const float* kst = kQuant ? k_scale + kv0 / HD : nullptr;
  const float* vst = kQuant ? v_scale + kv0 / HD : nullptr;
  const int ntiles = (len + TILE - 1) / TILE;

  for (int tile = warp; tile < ntiles; tile += kWarps) {
    const int base = tile * TILE;
    // whole-tile skip (uniform over the warp): every row is masked
    if (sliding_window > 0 && base + TILE <= win_lo &&
        !(sinks > 0 && base < sinks)) continue;

    Raw kraw[U], vraw[U];
    float ksc[U], vsc[U];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u * RPW + sub;
      bool ok = pos < len;
      if (sliding_window > 0)
        ok = ok && (pos >= win_lo || (sinks > 0 && pos < sinks));
      valid[u] = ok;
      kraw[u] = zero_raw<Raw>();
      vraw[u] = zero_raw<Raw>();
      ksc[u] = 0.f;
      vsc[u] = 0.f;
      if (ok && has_data) {
        kraw[u] = load_raw<Raw>(kt + static_cast<size_t>(pos) * HD);
        vraw[u] = load_raw<Raw>(vt + static_cast<size_t>(pos) * HD);
      }
      if (kQuant && ok) {                 // masked rows' scales: never read
        ksc[u] = __ldg(kst + pos);
        vsc[u] = __ldg(vst + pos);
      }
    }

    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack(kraw[u], kf, k_cache);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if constexpr (kQuant) d *= ksc[u];        // k dequant, pre-cap
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
      unpack(vraw[u], vf, v_cache);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = kQuant ? s[u][g] * vsc[u] : s[u][g];  // v dequant
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
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
  if (has_data) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[group][g][cl * EPL + e] = acc[g][e];
    }
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
  const void *k, *v;
  const float *k_scale, *v_scale;
  const int32_t* cache_len;
  __nv_bfloat16* o;
  float *l, *m;
  int B, Hkv, S;
  int64_t bstride;
  int sliding_window, sinks;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int HD, int G>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.B, a.Hkv);
  dense_decode_kernel<T, HD, G><<<grid, kThreads, 0, a.stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.k_scale, a.v_scale, a.cache_len, a.o, a.l, a.m, a.Hkv, a.S,
      a.bstride, a.sliding_window, a.sinks, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    case 8: return launch<T, HD, 8>(a);
    case 16: return launch<T, HD, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int entry(const void* q, const void* k_cache, const void* v_cache,
          const void* k_scale, const void* v_scale, const void* cache_len,
          void* o, void* l, void* m, int B, int Hkv, int G, int head_dim,
          int S, long long batch_stride, int sliding_window,
          int attention_sinks, float logit_softcap, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (Hkv > 65535 ||                                  // grid.y
      batch_stride < static_cast<long long>(Hkv) * S * head_dim)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int32_t*>(cache_len),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(l),
               static_cast<float*>(m), B, Hkv, S, batch_stride,
               sliding_window, attention_sinks, logit_softcap,
               1.0f / sqrtf(static_cast<float>(head_dim)),
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64: return static_cast<int>(dispatch_group<T, 64>(G, a));
    case 112: return static_cast<int>(dispatch_group<T, 112>(G, a));
    case 128: return static_cast<int>(dispatch_group<T, 128>(G, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched);
// cudaErrorInvalidValue for a head_dim / group size the kernel is not
// instantiated for. The caches are (Hkv, S, head_dim) contiguous within a
// sequence, sequences `batch_stride` elements apart (>= Hkv·S·head_dim;
// more for a head slice of a wider cache); an int8 cache's scales are
// laid out alike, batch_stride / head_dim apart. The int8 entry needs both
// scale arrays.
extern "C" int decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* cache_len, void* o, void* l, void* m,
    int B, int Hkv, int G, int head_dim, int S, long long batch_stride,
    int sliding_window, int attention_sinks, float logit_softcap,
    void* stream) {
  return repro_torch::entry<__nv_bfloat16>(
      q, k_cache, v_cache, nullptr, nullptr, cache_len, o, l, m, B, Hkv, G,
      head_dim, S, batch_stride, sliding_window, attention_sinks,
      logit_softcap, stream);
}

extern "C" int decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* cache_len,
    void* o, void* l, void* m, int B, int Hkv, int G, int head_dim, int S,
    long long batch_stride, int sliding_window, int attention_sinks,
    float logit_softcap, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::entry<int8_t>(
      q, k_cache, v_cache, k_scale, v_scale, cache_len, o, l, m, B, Hkv, G,
      head_dim, S, batch_stride, sliding_window, attention_sinks,
      logit_softcap, stream);
}
