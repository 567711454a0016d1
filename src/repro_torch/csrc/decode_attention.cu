// Flash-decode GQA attention over a DENSE head-major KV cache (bf16).
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
// What bounds it on an H100: decode reads every live K/V row once and does
// 2·G flops per element read — a few flops per byte against the card's
// ~295 flop/byte ridge — so it is bound by device-memory bytes.
//
// What the design does about it (the paged decode kernel's design, with
// dense addressing in place of the block-table walk):
//  * one CTA per (sequence, kv head) walks the sequence in tiles of
//    U·RPW rows (the TPU's sequential kb grid axis); warp w takes tiles
//    w, w+4, ... Inside a tile each group of hd/8 lanes owns one key row
//    and reads 8 elements of it per lane (16-byte loads), so one read of a
//    K row serves all G query heads of the group (GQA reuse).
//  * U rows per lane are loaded before any arithmetic, keeping U row loads
//    of K and V in flight per lane.
//  * every row group keeps its own fp32 online-softmax state per query
//    head; the states are merged once at the end in shared memory by the
//    §4.2.2 rule.
//  * masks select, never multiply: a masked row is never loaded (its k and
//    v stay 0) and its p is 0, so stale or NaN memory past cache_len cannot
//    reach the accumulator; a tile whose rows are all masked (before the
//    window, or past cache_len) is skipped without a load, which is exact.
//  * not done yet: splitting one sequence across CTAs. With B·Hkv CTAs
//    (64 at llama3-8b's B=8, Hkv=8) on 132 SMs the card is under-occupied.

#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int EPL = 8;                 // bf16 elements per lane per row

template <int HD, int G, int U>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_cache,
                    const __nv_bfloat16* __restrict__ v_cache,
                    const int32_t* __restrict__ cache_len,
                    __nv_bfloat16* __restrict__ o,
                    float* __restrict__ l_out,
                    float* __restrict__ m_out,
                    int Hkv, int S, int sliding_window, int sinks,
                    float softcap, float scale) {
  constexpr int LPR = HD / EPL;          // lanes per key row
  constexpr int RPW = 32 / LPR;          // key rows one warp load covers
  constexpr int TILE = U * RPW;          // rows a warp takes per iteration
  constexpr int NGROUPS = kWarps * RPW;  // independent softmax states

  __shared__ float sm_m[NGROUPS][G];
  __shared__ float sm_l[NGROUPS][G];
  __shared__ float sm_acc[NGROUPS][G][HD];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;            // which row of a warp load
  const int cl = lane % LPR;             // which 8-element slice of hd
  const int group = warp * RPW + sub;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    bf16x8_to_float(ldg16(q + (bh * G + g) * HD + cl * EPL), qf[g]);
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

  const int len = min(cache_len[b], S);
  const int win_lo = cache_len[b] - sliding_window;  // first in-window pos
  const __nv_bfloat16* kt = k_cache + bh * S * HD + cl * EPL;
  const __nv_bfloat16* vt = v_cache + bh * S * HD + cl * EPL;
  const int ntiles = (len + TILE - 1) / TILE;

  for (int tile = warp; tile < ntiles; tile += kWarps) {
    const int base = tile * TILE;
    // whole-tile skip (uniform over the warp): every row is masked
    if (sliding_window > 0 && base + TILE <= win_lo &&
        !(sinks > 0 && base < sinks)) continue;

    uint4 kraw[U], vraw[U];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u * RPW + sub;
      bool ok = pos < len;
      if (sliding_window > 0)
        ok = ok && (pos >= win_lo || (sinks > 0 && pos < sinks));
      valid[u] = ok;
      kraw[u] = make_uint4(0, 0, 0, 0);
      vraw[u] = make_uint4(0, 0, 0, 0);
      if (ok) {
        kraw[u] = ldg16(kt + static_cast<size_t>(pos) * HD);
        vraw[u] = ldg16(vt + static_cast<size_t>(pos) * HD);
      }
    }

    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      bf16x8_to_float(kraw[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
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
      bf16x8_to_float(vraw[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
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
  const __nv_bfloat16 *q, *k, *v;
  const int32_t* cache_len;
  __nv_bfloat16* o;
  float *l, *m;
  int B, Hkv, S, sliding_window, sinks;
  float softcap, scale;
  cudaStream_t stream;
};

template <int HD, int G>
cudaError_t launch(const Args& a) {
  // 8 row loads in flight per lane; 4 at G = 8, where the q and
  // accumulator registers (2·G·8 floats per lane) would otherwise spill
  constexpr int U = G > 4 ? 4 : 8;
  const dim3 grid(a.B, a.Hkv);
  dense_decode_kernel<HD, G, U><<<grid, kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.cache_len, a.o, a.l, a.m, a.Hkv, a.S,
      a.sliding_window, a.sinks, a.softcap, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_group(int G, const Args& a) {
  switch (G) {
    case 1: return launch<HD, 1>(a);
    case 2: return launch<HD, 2>(a);
    case 4: return launch<HD, 4>(a);
    case 8: return launch<HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched); cudaErrorInvalidValue for a
// head_dim / group size the kernel is not instantiated for.
extern "C" int decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* cache_len, void* o, void* l, void* m,
    int B, int Hkv, int G, int head_dim, int S, int sliding_window,
    int attention_sinks, float logit_softcap, void* stream) {
  using namespace repro_torch;
  if (B == 0 || Hkv == 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k_cache),
               static_cast<const __nv_bfloat16*>(v_cache),
               static_cast<const int32_t*>(cache_len),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(l),
               static_cast<float*>(m), B, Hkv, S, sliding_window,
               attention_sinks, logit_softcap,
               1.0f / sqrtf(static_cast<float>(head_dim)),
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64: return static_cast<int>(dispatch_group<64>(G, a));
    case 128: return static_cast<int>(dispatch_group<128>(G, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
