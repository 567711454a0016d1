// Paged flash-decode GQA attention over the head-major KV block pool.
//
// Replaces the TPU kernel repro/kernels/paged_decode_attention.py
// `_paged_decode_kernel` (wrapper `paged_decode_attention`, pallas_call at
// :273). Same contract: q (B, Hkv, G, hd); pools (Hkv, num_blocks, bs, hd);
// block_tables (B, nb) int32; optional block_positions (B, nb) int32 (each
// slot's global base position, POS_PAD on slots to ignore); cache_len (B,).
// Writes o (B, Hkv, G, hd) in q's dtype and the §4.2.2 partial l, m as fp32
// (B, Hkv, G).
//
// What bounds it on an H100: decode reads every live K/V row once and does
// 2·G flops per bf16 element read — a few flops per byte against the card's
// ~295 flop/byte ridge — so it is bound by device-memory bytes.
//
// What the design does about it:
//  * one CTA per (sequence, kv head) walks the block table in a loop (the
//    TPU's sequential kb grid axis). Warp w takes table slots w, w+4, ...;
//    inside a pool block, each group of hd/8 lanes owns one key row and
//    reads it with 16-byte loads, so one read of a K row serves all G query
//    heads of the group (GQA reuse).
//  * U rows per lane are loaded before any arithmetic, keeping 2·U·16 bytes
//    per lane in flight.
//  * every row group keeps its own fp32 online-softmax state per query
//    head; the states are merged once at the end in shared memory by the
//    §4.2.2 rule.
//  * masks select, never multiply: a masked row is never loaded (its k and
//    v stay 0) and its p is 0, so stale or NaN memory behind a padded table
//    slot or past cache_len cannot reach the accumulator; a table slot whose
//    rows are all masked is skipped without a load, which is exact.
//  * not done yet: splitting one sequence's KV across CTAs. With B·Hkv CTAs
//    (64 at B=8, Hkv=8) on 132 SMs the card is under-occupied (PERF.md).

#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int HD, int G, int U>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ block_positions,
                    const int32_t* __restrict__ cache_len,
                    __nv_bfloat16* __restrict__ o,
                    float* __restrict__ l_out,
                    float* __restrict__ m_out,
                    int Hkv, int num_blocks, int bs, int nb,
                    int sliding_window, int sinks, float softcap,
                    float scale) {
  constexpr int LPR = HD / 8;            // lanes per key row, 8 bf16 each
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
  const int cl = lane % LPR;             // which 8-element slice of hd
  const int group = warp * RPW + sub;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    bf16x8_to_float(ldg16(q + (bh * G + g) * HD + cl * 8), qf[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] *= scale;
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
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
    const __nv_bfloat16* kt = k_pool + tile * HD + cl * 8;
    const __nv_bfloat16* vt = v_pool + tile * HD + cl * 8;

    for (int r0 = 0; r0 < bs; r0 += U * RPW) {
      uint4 kraw[U], vraw[U];
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * RPW + sub;
        const int pos = base + r;
        bool ok = r < bs && pos < len;
        if (sliding_window > 0)
          ok = ok && (pos >= win_lo || (sinks > 0 && pos < sinks));
        valid[u] = ok;
        kraw[u] = make_uint4(0u, 0u, 0u, 0u);
        vraw[u] = kraw[u];
        if (ok) {
          kraw[u] = ldg16(kt + static_cast<size_t>(r) * HD);
          vraw[u] = ldg16(vt + static_cast<size_t>(r) * HD);
        }
      }

      float s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        bf16x8_to_float(kraw[u], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
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
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      }

#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        bf16x8_to_float(vraw[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
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
    for (int e = 0; e < 8; ++e) sm_acc[group][g][cl * 8 + e] = acc[g][e];
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
  const __nv_bfloat16 *q, *k_pool, *v_pool;
  const int32_t *tables, *positions, *cache_len;
  __nv_bfloat16* o;
  float *l, *m;
  int B, Hkv, num_blocks, bs, nb, sliding_window, sinks;
  float softcap, scale;
  cudaStream_t stream;
};

template <int HD, int G>
cudaError_t launch(const Args& a) {
  constexpr int U = G <= 4 ? 8 : 4;
  const dim3 grid(a.B, a.Hkv);
  paged_decode_kernel<HD, G, U><<<grid, kThreads, 0, a.stream>>>(
      a.q, a.k_pool, a.v_pool, a.tables, a.positions, a.cache_len, a.o, a.l,
      a.m, a.Hkv, a.num_blocks, a.bs, a.nb, a.sliding_window, a.sinks,
      a.softcap, a.scale);
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
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* block_positions,
    const void* cache_len, void* o, void* l, void* m,
    int B, int Hkv, int G, int head_dim, int num_blocks, int block_size,
    int nb, int sliding_window, int attention_sinks, float logit_softcap,
    void* stream) {
  using namespace repro_torch;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k_pool),
               static_cast<const __nv_bfloat16*>(v_pool),
               static_cast<const int32_t*>(block_tables),
               static_cast<const int32_t*>(block_positions),
               static_cast<const int32_t*>(cache_len),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(l),
               static_cast<float*>(m), B, Hkv, num_blocks, block_size, nb,
               sliding_window, attention_sinks, logit_softcap,
               1.0f / sqrtf(static_cast<float>(head_dim)),
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64: return static_cast<int>(dispatch_group<64>(G, a));
    case 128: return static_cast<int>(dispatch_group<128>(G, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
