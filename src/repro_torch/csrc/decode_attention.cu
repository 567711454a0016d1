// Flash-decode GQA attention over a DENSE head-major KV cache, bf16 or
// int8 with fp32 per-token scales: split-KV over the SMs, one launch that
// merges its own partials, and the G query heads of a kv head on the
// tensor cores at G >= 8.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// `_decode_attn_kernel` (wrapper `decode_attention`, pallas_call at :118)
// with the entry point `decode_attention_bf16`. Same contract: q (B, Hkv,
// G, hd) bf16; k/v cache (B, Hkv, S, hd) bf16, head-major, sequences
// `batch_stride` elements apart (a head slice of a wider cache is read in
// place); cache_len (B,) int32. A slot is attended when pos < cache_len
// and, with a window w > 0, pos >= cache_len - w or pos < sinks. The
// optional tanh softcap applies to the scores before the mask. Writes o
// (B, Hkv, G, hd) bf16 and the §4.2.2 partial l, m as fp32 (B, Hkv, G); an
// all-masked row gives l = 0, m = NEG_INF, o = 0.
//
// `decode_attention_int8` is the same kernel over an int8 cache (B, Hkv, S,
// hd) with fp32 per-token scales (B, Hkv, S): the k scale multiplies the
// score after q·k and before the softcap, the v scale multiplies p before
// the PV product, and l sums the unscaled p (the rule of the int8 paged
// kernel). The reference's Pallas kernel takes no scales; its int8 dense
// caches run the jnp partial (repro/models/attention.py:175, with
// k_scale), of which this entry is the device form. Nothing dequantized is
// written to device memory.
//
// What bounds it on an H100: decode reads every live K/V row once and does
// 2·G flops per element read — a few flops per byte against the card's
// ~295 flop/byte ridge — so it is bound by device-memory bytes (int8 caches
// read hd + 4 bytes per token-head for K and for V instead of 2·hd). To
// move 3.35 TB/s the card needs some 25 KB in flight on each of its SMs.
//
// What the design does about it:
//  * split-KV: one CTA per (b, h, split), launched as grid (S, Hkv, B) with
//    the splits fastest, so one sequence's splits go to different SMs.
//    The wrapper plans S from B, Hkv, the cache length, G and the SM
//    count only (plan_splits: 2 CTAs an SM, 1 split once the B·Hkv pairs
//    alone give every SM a CTA), never from cache_len, so it needs no host
//    sync and a CUDA graph can capture the call. The live rows (before
//    cache_len; in the window or among the sinks) are at most two runs of
//    positions, numbered 0..N-1 from cache_len on the device; split j
//    walks live rows [j·U/S, (j+1)·U/S) of them in 16-row units (U = N /
//    16, rounded up), so a split with none writes the empty partial
//    without a load, no load is spent on rows before the window, and a
//    window's rows spread over the splits (cut from the cache's rows, a
//    window of 8192 at the end of 524,288 falls in 1-3 splits, and a few
//    CTAs stream it while the other SMs idle).
//  * one launch: each split writes its fp32 (acc, m, l) partial to a
//    workspace; the last CTA of a (b, h) to arrive (an atomic ticket after
//    a __threadfence) merges the S partials by the §4.2.2 rule, writes o,
//    l and m, and resets the ticket to 0 for the next call. It stages the
//    live splits' acc into shared memory by cp.async, as many at a time as
//    fit, so it waits for a few rounds of loads rather than one a split.
//    With S = 1 the CTA writes o, l, m itself.
//  * G >= 8 (dense_tc_kernel): the G query heads of the kv head are the M
//    rows of mma.sync.m16n8k16 (bf16 in, fp32 accumulate; G = 8 fills half
//    the tile). Each warp owns 16-row chunks (chunks w, w + 4, ...) and
//    streams them through its own 3-stage ring in shared memory, filled by
//    16-byte cp.async (so a strided head slice needs nothing more). S = QKᵀ
//    takes hd/16 k-steps (4, 7 or 8: 112 = 7·16, so no column is padding)
//    with K's B fragments by ldmatrix from the row-major tile; PV takes
//    hd/8 n-tiles with V's B fragments by ldmatrix.trans, so V is never
//    transposed by a copy. The accumulator of 16 × hd fp32 (64 floats a
//    lane at hd 128) stays in one warp's registers: rows are split across
//    the 4 warps, whose online-softmax states are merged in shared memory
//    at the end. Tile rows are padded by 16 bytes, so ldmatrix's 8 rows
//    fall on distinct banks.
//  * G <= 4 (dense_lanes_kernel): the CUDA-core lanes of the paged decode
//    kernel (at G = 8 they were slower than the mma on the card). Each
//    group of LPR lanes owns one key row, EPL elements a lane (16-byte
//    loads), so one read of a K row serves all G query heads; a
//    per-thread 4-stage cp.async ring; the G partial dot products are
//    reduce-scattered over the row's lanes (G - 1 + log2(LPR/G) shuffles,
//    not G·log2(LPR)), each lane runs the softmax of one query head, and a
//    query head's reference max moves only when a score exceeds it by more
//    than 8 (lazy rescale).
//
// Traps the design steps around:
//  * NaN past cache_len. Callers may leave NaN (values and int8 scales) in
//    the slots past cache_len. In an mma a masked column's weight of 0
//    times a NaN V element is NaN, so a masked row is never loaded: it is
//    copied with src-size 0, which zero-fills its K, V and scales in shared
//    memory. Its score is then selected to NEG_INF and its p to 0: masks
//    select, never multiply.
//  * The softmax scale. 1/√128 and 1/√112 are not powers of two, so
//    scaling bf16 q before the mma would round it: the mma takes q as
//    stored and the scale multiplies the fp32 scores.
//  * P in bf16. One bf16 P would lose bits against the fp32 twin, so P is
//    split into hi = bf16(p) and lo = bf16(p - hi) and PV runs on both
//    (the chunked scans' hi + lo, csrc/ssm_scan.cu): P is kept to 2^-17 of
//    itself. For int8 the split is of p · v_scale; l sums the unscaled p.
//  * int8 on the tensor cores. A converted int8 byte is exact in bf16
//    (|b| <= 128), so each warp converts its chunk's K and V bytes into a
//    bf16 tile of its own (2^23 trick of common.cuh, then one F2FP a pair)
//    and the mma path is the bf16 one. The k scale multiplies the fp32
//    score before the softcap, as in the lanes path.
//  * Registers. 16 × hd fp32 accumulators (64 a lane at hd 128) plus Q's
//    A fragments (32 at hd 128) in one warp: rows, not hd, are split
//    across warps, so each warp holds one accumulator and no Q·K product is
//    repeated. chip_smoke logs registers and spills per instantiation.
//  * Tickets under capture. The wrapper's tickets are allocated before a
//    capture (kernels/_cuda.py private_tickets) and every launch leaves
//    them 0, so a replayed graph finds them as the capture did.

#include <atomic>
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnit = 16;          // rows: splits cut the cache in units
constexpr int kMaxSplits = 512;    // splits of one (b, h)
// The least G that runs on the tensor cores (at G = 8 the lanes timed
// slower than the mma on an H100).
constexpr int kTcMinG = 8;
constexpr float kLazy = 8.0f;      // reference-max headroom (natural log)

// The most splits of one (b, h): the last CTA's merge keeps S·G (m, l)
// pairs in shared memory, so G = 16 takes half as many.
__host__ __device__ constexpr int max_splits(int G) {
  return G > 8 ? kMaxSplits / 2 : kMaxSplits;
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

struct Params {
  const __nv_bfloat16* q;
  const void *k, *v;
  const float *k_scale, *v_scale;
  const int32_t* cache_len;
  __nv_bfloat16* o;
  float *l, *m;
  float* ws;          // S > 1: acc (B·Hkv·S·G·HD) then (m, l) pairs
  int* tickets;       // S > 1: one per (b, h), 0 between calls
  int Hkv, S;
  long long bstride;  // elements between sequences of the caches
  int sliding_window, sinks;
  float softcap, scale;
};

// The live rows of one split, numbered 0..n-1: rows j < na sit at a0 + j,
// the rest at b0 + (j - na) (the sinks, then the window).
struct LiveRows {
  int a0, na, b0, n;
  __device__ __forceinline__ int pos(int j) const {
    return j < na ? a0 + j : b0 + (j - na);
  }
};

// Split `split` of S's share of a sequence's live rows: before len (and
// the cache's S rows), in the window or among the sinks. They are the runs
// [0, a1) and [b0, end), N rows in all; the split takes live rows
// [lo, hi) of them, whole 16-row units of N.
__device__ __forceinline__ LiveRows live_rows(const Params& p, int len,
                                              int S, int split) {
  const int end = max(min(len, p.S), 0);
  int a1 = end, b0 = end;
  if (p.sliding_window > 0) {
    const int win_lo = len - p.sliding_window;  // first in-window position
    const int sinks = max(p.sinks, 0);
    if (sinks < win_lo) {                       // two runs
      a1 = min(sinks, end);
      b0 = min(win_lo, end);
    }
  }
  const int rows = a1 + (end - b0);
  const long long units = (rows + kUnit - 1) / kUnit;
  const int lo = min(static_cast<int>(split * units / S) * kUnit, rows);
  const int hi = min(static_cast<int>((split + 1) * units / S) * kUnit, rows);
  const int na = max(min(a1, hi) - lo, 0);
  return {lo, na, b0 + max(lo - a1, 0), hi - lo};
}

// One element (query head idx / HD, column idx % HD) of the CTA's merged
// partial: with one split the normalised o (and l, m), else the split's
// fp32 (acc, m, l) in the workspace.
template <int G, int HD>
__device__ __forceinline__ void put_partial(const Params& p, size_t bh,
                                            size_t BHkv, int S, int split,
                                            int idx, float A, float L,
                                            float M) {
  const int g = idx / HD;
  if (S == 1) {
    p.o[bh * G * HD + idx] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    if (idx % HD == 0) {
      p.l[bh * G + g] = L;
      p.m[bh * G + g] = M;
    }
  } else {
    const size_t part = bh * S + split;
    p.ws[part * G * HD + idx] = A;
    if (idx % HD == 0) {
      float* ml = p.ws + BHkv * S * G * HD + (part * G + g) * 2;
      ml[0] = M;
      ml[1] = L;
    }
  }
}

// Nothing of this split is live: the empty partial (o = 0, l = 0,
// m = NEG_INF); with S > 1 only (m, l) is written, and the merge skips the
// acc of a partial whose l is 0.
template <int G, int HD>
__device__ void put_empty(const Params& p, size_t bh, size_t BHkv, int S,
                          int split) {
  if (S == 1) {
    for (int idx = threadIdx.x; idx < G * HD; idx += kThreads)
      put_partial<G, HD>(p, bh, BHkv, 1, 0, idx, 0.f, 0.f, NEG_INF);
  } else if (threadIdx.x < G) {
    float* ml = p.ws + BHkv * S * G * HD + ((bh * S + split) * G +
                                            threadIdx.x) * 2;
    ml[0] = NEG_INF;
    ml[1] = 0.f;
  }
}

// Shared memory the last CTA's merge needs at most: the S splits' (m, l)
// and a list of the splits with live rows, then room to stage at least one
// split's acc.
__host__ __device__ constexpr int merge_bytes(int G, int HD) {
  return ((2 * G + 1) * max_splits(G) + 4 + G * HD) * 4;
}

// The last split of (b, h) to finish merges all S partials (S > 1). Its
// reads are the merge's cost: the splits with live rows are listed, and
// their acc is staged into `scratch` (the CTA's `scratch_bytes` of shared
// memory) by cp.async as many at a time as fit, so the merge waits for a
// few rounds of loads, not one a split.
template <int G, int HD>
__device__ void merge_splits(const Params& p, size_t bh, size_t BHkv, int S,
                             unsigned char* scratch, int scratch_bytes) {
  constexpr int PART = G * HD;                     // floats of a split's acc
  constexpr int EPT = (PART + kThreads - 1) / kThreads;
  __shared__ float sm_gm[G], sm_gl[G];
  __shared__ int sm_last, sm_nlive;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(p.tickets + bh, 1) == S - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  const float* ws_acc = p.ws + bh * S * PART;
  const float* ws_part = p.ws + BHkv * S * PART + bh * S * G * 2;
  float* sp_w = reinterpret_cast<float*>(scratch);  // [S][G]: m, then weight
  float* sp_l = sp_w + S * G;                       // [S][G]
  int* live = reinterpret_cast<int*>(sp_l + S * G); // [S]
  float* stage = sp_w + ((2 * G + 1) * S + 3) / 4 * 4;    // 16-byte aligned
  const int batch = (scratch_bytes / 4 - static_cast<int>(stage - sp_w)) /
                    PART;                           // >= 1 by merge_bytes
  for (int idx = tid; idx < S * G; idx += kThreads) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(ws_part) + idx);
    sp_w[idx] = ml.x;
    sp_l[idx] = ml.y;
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float M = NEG_INF;
    for (int i = lane; i < S; i += 32)
      if (sp_l[i * G + g] > 0.f) M = fmaxf(M, sp_w[i * G + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int i = lane; i < S; i += 32) {
      const float li = sp_l[i * G + g];
      const float w = li > 0.f ? __expf(sp_w[i * G + g] - M) : 0.f;
      sp_w[i * G + g] = w;
      L = fmaf(li, w, L);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) {
      sm_gm[g] = M;
      sm_gl[g] = L;
    }
  }
  // the splits with live rows, in split order (an empty split's acc was
  // never written: it is never read)
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < S; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < S && sp_l[i * G] > 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) live[n + __popc(bal & ((1u << lane) - 1u))] = i;
      n += __popc(bal);
    }
    if (lane == 0) sm_nlive = n;
  }
  __syncthreads();
  const int n_live = sm_nlive;
  float A[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) A[k] = 0.f;
  for (int j0 = 0; j0 < n_live; j0 += batch) {
    const int nb = min(batch, n_live - j0);
    for (int c = tid; c < nb * (PART / 4); c += kThreads) {
      const int j = c / (PART / 4), piece = c % (PART / 4);
      cp_async16(stage + j * PART + piece * 4,
                 ws_acc + static_cast<size_t>(live[j0 + j]) * PART +
                     piece * 4);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const float* w = sp_w + live[j0 + j] * G;
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int idx = tid + k * kThreads;
        if (idx < PART) A[k] = fmaf(w[idx / HD], stage[j * PART + idx], A[k]);
      }
    }
    __syncthreads();                 // the stage is refilled next round
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = tid + k * kThreads;
    if (idx >= PART) continue;
    const int g = idx / HD;
    p.o[bh * PART + idx] = __float2bfloat16(A[k] / fmaxf(sm_gl[g], 1e-30f));
    if (idx % HD == 0) {
      p.l[bh * G + g] = sm_gl[g];
      p.m[bh * G + g] = sm_gm[g];
    }
  }
  if (tid == 0) p.tickets[bh] = 0;   // ready for the next call
}

// ---------------------------------------------------------------------------
// G >= 8: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
struct Tc {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int kStages = 3;            // chunks in flight + 1
  static constexpr int LD = HD + 8;            // bf16 a padded tile row
  static constexpr int KSTEPS = HD / 16;       // QKᵀ k-steps
  static constexpr int NT = HD / 8;            // PV n-tiles
  static constexpr int CPR = HD * static_cast<int>(sizeof(T)) / 16;
  static constexpr int COPIES = 16 * CPR;      // 16-byte pieces of a tile
  // bytes of a ring row: bf16 rows are the padded tile rows ldmatrix
  // reads; int8 rows are converted into the warp's bf16 tile first
  static constexpr int RAW_LD = kQuant ? HD + 16 : 2 * LD;
  static constexpr int STAGE = 2 * 16 * RAW_LD + (kQuant ? 2 * 16 * 4 : 0);
  static constexpr int TILE = kQuant ? 2 * 16 * LD * 2 : 0;
  static constexpr int WARP = kStages * STAGE + TILE;
  static constexpr int RING = kWarps * WARP;
  static constexpr int MERGE = (kWarps * 16 * HD + 2 * kWarps * 16) * 4;
  static constexpr int SMEM = cmax(cmax(RING, MERGE), merge_bytes(G, HD));
  static_assert(HD % 16 == 0 && (G == 8 || G == 16), "m16n8k16 tiles");
  static_assert(STAGE % 16 == 0 && WARP % 16 == 0, "16-byte copies");
};

// 16 int8 values -> 16 bf16, exactly (|b| <= 128 needs 8 significant
// bits): the 2^23 trick of common.cuh, then one F2FP a pair.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& raw,
                                                uint4& lo, uint4& hi) {
  float f[16];
  int8x16_to_float(raw, f);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
dense_tc_kernel(const Params p) {
  using C = Tc<T, HD, G>;
  constexpr bool kQuant = C::kQuant;
  constexpr int kStages = C::kStages, LD = C::LD, CPR = C::CPR;
  constexpr int RAW_LD = C::RAW_LD;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x;         // splits fastest: see launch()
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = gridDim.x;
  const size_t BHkv = static_cast<size_t>(gridDim.z) * p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;               // fragment row: query head g, g + 8
  const int c = lane % 4;               // fragment column pair
  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;

  const int len = p.cache_len[b];
  const LiveRows lv = live_rows(p, len, S, split);
  if (lv.n == 0) {                      // uniform over the CTA
    put_empty<G, HD>(p, bh, BHkv, S, split);
    if (S > 1) merge_splits<G, HD>(p, bh, BHkv, S, smem, C::SMEM);
    return;
  }

  // Q as A fragments, bf16 as stored: (row g, k 2c..2c+1), (g+8, ...),
  // (g, 2c+8..), (g+8, 2c+8..); rows past G are 0
  uint32_t qa[C::KSTEPS][4];
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(p.q + bh * G * HD);
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    const int col = kk * 16 + 2 * c;
    qa[kk][0] = __ldg(q32 + (g * HD + col) / 2);
    qa[kk][2] = __ldg(q32 + (g * HD + col + 8) / 2);
    qa[kk][1] = G > 8 ? __ldg(q32 + ((g + 8) * HD + col) / 2) : 0u;
    qa[kk][3] = G > 8 ? __ldg(q32 + ((g + 8) * HD + col + 8) / 2) : 0u;
  }

  const size_t kv0 = static_cast<size_t>(b) * p.bstride +
                     static_cast<size_t>(h) * p.S * HD;
  const T* kb = static_cast<const T*>(p.k) + kv0;
  const T* vb = static_cast<const T*>(p.v) + kv0;
  const float* ksb = kQuant ? p.k_scale + kv0 / HD : nullptr;
  const float* vsb = kQuant ? p.v_scale + kv0 / HD : nullptr;
  unsigned char* ring = smem + warp * C::WARP;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(
      ring + kStages * C::STAGE);                       // int8 only

  const int n_chunks = (lv.n + 15) / 16;
  const int mine = warp < n_chunks ? (n_chunks - 1 - warp) / kWarps + 1 : 0;

  // chunk t of this warp (rows 16·(warp + 4t) ..) into stage t % kStages;
  // rows past n copy nothing and are zero-filled
  auto issue = [&](int t) {
    if (t < mine) {
      const int j0 = (warp + t * kWarps) * 16;
      unsigned char* st = ring + (t % kStages) * C::STAGE;
#pragma unroll
      for (int i = 0; i < (C::COPIES + 31) / 32; ++i) {
        const int idx = lane + 32 * i;
        if (C::COPIES % 32 == 0 || idx < C::COPIES) {
          const int r = idx / CPR, piece = idx % CPR;
          const bool ok = j0 + r < lv.n;
          const size_t off = static_cast<size_t>(ok ? lv.pos(j0 + r) : 0) *
                             HD + piece * (16 / sizeof(T));
          cp_async16_zfill(st + r * RAW_LD + piece * 16, kb + off, ok);
          cp_async16_zfill(st + (16 + r) * RAW_LD + piece * 16, vb + off,
                           ok);
        }
      }
      if constexpr (kQuant) {           // lanes 0-15 k scales, 16-31 v
        const int r = lane & 15;
        const bool ok = j0 + r < lv.n;
        const int pos = ok ? lv.pos(j0 + r) : 0;
        float* sc = reinterpret_cast<float*>(st + 2 * 16 * RAW_LD);
        cp_async4_zfill(sc + lane, (lane < 16 ? ksb : vsb) + pos, ok);
      }
    }
    cp_async_commit();
  };

  // ldmatrix row addresses: K (non-trans) matrices rows 0-7 / 8-15 ×
  // columns 0-7 / 8-15 of a k-step -> b0, b1 of n-tiles 0 and 1; V (trans)
  // matrices keys 0-7 / 8-15 × columns 0-7 / 8-15 of an n-tile pair
  const int krow = (lane >> 4) * 8 + (lane & 7);
  const int kcol = ((lane >> 3) & 1) * 8;
  const int vrow = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int vcol = (lane >> 4) * 8;

  float acc[C::NT][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};   // rows g, g + 8
  float l_run[2] = {0.f, 0.f};           // this lane's share of l

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < mine; ++t) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                       // the chunk's copies by every lane
    issue(t + kStages - 1);             // into the stage read at t - 1
    const unsigned char* st = ring + (t % kStages) * C::STAGE;
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const float* sc = reinterpret_cast<const float*>(st + 2 * 16 * RAW_LD);
    if constexpr (kQuant) {
      // int8 -> bf16 (exact) into the warp's tile
#pragma unroll
      for (int i = 0; i < (C::COPIES + 31) / 32; ++i) {
        const int idx = lane + 32 * i;
        if (C::COPIES % 32 == 0 || idx < C::COPIES) {
          const int r = idx / CPR, piece = idx % CPR;
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                st + (kv * 16 + r) * RAW_LD + piece * 16);
            uint4* dst = reinterpret_cast<uint4*>(
                tile + (kv * 16 + r) * LD + piece * 16);
            int8x16_to_bf16(raw, dst[0], dst[1]);
          }
        }
      }
      __syncwarp();
      kt = tile;
      vt = tile + 16 * LD;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(st);
      vt = reinterpret_cast<const __nv_bfloat16*>(st + 16 * RAW_LD);
    }

    // S = Q·Kᵀ: s[n][e] is (row g + 8·(e / 2), key 8n + 2c + e % 2)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, kt + krow * LD + kk * 16 + kcol);
      mma_bf16(s[0], qa[kk], kf[0], kf[1]);
      mma_bf16(s[1], qa[kk], kf[2], kf[3]);
    }

    // scale in fp32, k dequant, softcap, mask; the chunk's row maxima
    const int j0 = (warp + t * kWarps) * 16;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * c + (e & 1);
        float x = s[n][e] * p.scale;
        if constexpr (kQuant) x *= sc[key];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        x = j0 + key < lv.n ? x : NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // p (selected to 0 under the mask); PV's A operand is p, or
    // p · v_scale, split into bf16 hi + lo
    float pw[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * c + (e & 1);
        const float pr = j0 + key < lv.n ? __expf(s[n][e] - m_run[e >> 1])
                                         : 0.f;
        l_run[e >> 1] += pr;
        pw[n][e] = kQuant ? pr * sc[16 + key] : pr;
      }
    uint32_t ph[4], pl[4];
    split_bf16x2(pw[0][0], pw[0][1], ph[0], pl[0]);
    split_bf16x2(pw[0][2], pw[0][3], ph[1], pl[1]);
    split_bf16x2(pw[1][0], pw[1][1], ph[2], pl[2]);
    split_bf16x2(pw[1][2], pw[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // acc += P·V, lo then hi
#pragma unroll
    for (int np = 0; np < C::NT / 2; ++np) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, vt + vrow * LD + np * 16 + vcol);
      mma_bf16(acc[2 * np], pl, vf[0], vf[1]);
      mma_bf16(acc[2 * np + 1], pl, vf[2], vf[3]);
      mma_bf16(acc[2 * np], ph, vf[0], vf[1]);
      mma_bf16(acc[2 * np + 1], ph, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __syncthreads();                      // the ring becomes the merge scratch

  // merge the 4 warps' partials (§4.2.2) in shared memory
  float* sm_acc = reinterpret_cast<float*>(smem);           // [4][16][HD]
  float* sm_m = sm_acc + kWarps * 16 * HD;                  // [4][16]
  float* sm_l = sm_m + kWarps * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r == 1 && G <= 8) break;
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
      *reinterpret_cast<float2*>(sm_acc + row * HD + n * 8 + 2 * c) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    if (c == 0) {
      sm_m[row] = m_run[r];
      sm_l[row] = l_run[r];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int gg = idx / HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * 16 + gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = __expf(sm_m[w * 16 + gg] - M);
      L = fmaf(sm_l[w * 16 + gg], wt, L);
      A = fmaf(sm_acc[(w * 16 + gg) * HD + idx % HD], wt, A);
    }
    put_partial<G, HD>(p, bh, BHkv, S, split, idx, A, L, M);
  }
  if (S > 1) merge_splits<G, HD>(p, bh, BHkv, S, smem, C::SMEM);
}

// ---------------------------------------------------------------------------
// G <= 4: CUDA-core lanes
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
struct Lanes {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int kStages = 4;             // ring depth
  static constexpr int kRows = 2;               // rows a row group an item
  static constexpr int EPL = kQuant ? 16 : 8;    // a lane's 16 bytes of a row
  static constexpr int LPR_HD = HD / EPL;       // lanes holding data
  // lanes per key row, a power of two so the shuffles stay in the row
  // (hd = 112: 14 or 7 lanes hold data, the rest load nothing, hold 0)
  static constexpr int LPR = pow2_ceil(LPR_HD);
  static constexpr int RPW = 32 / LPR;          // rows one warp load covers
  static constexpr int NGROUPS = kWarps * RPW;  // row groups of the CTA
  static constexpr int ROWS = kRows * NGROUPS;  // rows per item
  static constexpr int LPG = LPR / G;           // lanes per query head
  static_assert(HD % EPL == 0 && LPR <= 32, "whole chunks, one warp a row");
  static_assert(G <= LPR && G < kTcMinG, "the reduce-scatter needs G <= LPR");
  static_assert(NGROUPS * G <= kThreads, "one thread per group weight");
  // shared memory, one union: the ring while the split runs, then the row
  // groups' partials, then the last CTA's merge
  static constexpr int RING = kStages * kRows * 2 * kThreads * 16;
  static constexpr int SCALES = kQuant ? kStages * kRows * 2 * kThreads * 4
                                       : 0;
  static constexpr int MERGE = (NGROUPS * G * (HD + 4) + G) * 4;
  static constexpr int UNION = cmax(cmax(RING + SCALES, MERGE),
                                    merge_bytes(G, HD));
};

__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const __nv_bfloat16*) {
  bf16x8_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const int8_t*) {
  int8x16_to_float(r, out);
}

// Sum G partial dot products over the LPR lanes of a row: the first
// log2(G) steps halve the heads each lane keeps (it sends the other half
// to its partner), the rest all-reduce. Lane cl ends with the full dot of
// query head cl / (LPR / G).
template <int G, int LPR>
__device__ __forceinline__ float reduce_scatter(float (&d)[G], int cl) {
#pragma unroll
  for (int n = G, off = LPR / 2; n > 1; n /= 2, off /= 2) {
    const bool upper = (cl & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = upper ? d[n / 2 + i] : d[i];
      const float send = upper ? d[i] : d[n / 2 + i];
      d[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float v = d[0];
#pragma unroll
  for (int off = LPR / (2 * G); off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
dense_lanes_kernel(const Params p) {
  using C = Lanes<T, HD, G>;
  constexpr bool kQuant = C::kQuant;
  constexpr int EPL = C::EPL, LPR = C::LPR, RPW = C::RPW;
  constexpr int NGROUPS = C::NGROUPS, LPG = C::LPG, LPR_HD = C::LPR_HD;
  constexpr int kStages = C::kStages, kRows = C::kRows;
  __shared__ alignas(16) unsigned char sm_raw[C::UNION];

  const int split = blockIdx.x;         // splits fastest: see launch()
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = gridDim.x;
  const size_t BHkv = static_cast<size_t>(gridDim.z) * p.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane / LPR;            // which row of a warp load
  const int cl = lane % LPR;             // which EPL-element slice of hd
  const bool has_data = cl < LPR_HD;     // pad lanes of a row load nothing
  const int cd = has_data ? cl : 0;      // ... and address slice 0
  const int group = warp * RPW + sub;
  const int g_own = cl / LPG;            // this lane's query head
  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;

  const int len = p.cache_len[b];
  const LiveRows lv = live_rows(p, len, S, split);
  float* scratch = reinterpret_cast<float*>(sm_raw);
  if (lv.n == 0) {                      // uniform over the CTA
    put_empty<G, HD>(p, bh, BHkv, S, split);
    if (S > 1) merge_splits<G, HD>(p, bh, BHkv, S, sm_raw, C::UNION);
    return;
  }

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; e += 8)
      bf16x8_to_float(ldg16(p.q + (bh * G + g) * HD + cd * EPL + e),
                      qf[g] + e);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] = has_data ? qf[g][e] * p.scale
                                                      : 0.f;
  }

  const size_t kv0 = static_cast<size_t>(b) * p.bstride +
                     static_cast<size_t>(h) * p.S * HD;
  const T* kb = static_cast<const T*>(p.k) + kv0 + cd * EPL;
  const T* vb = static_cast<const T*>(p.v) + kv0 + cd * EPL;
  const float* ksb = kQuant ? p.k_scale + kv0 / HD : nullptr;
  const float* vsb = kQuant ? p.v_scale + kv0 / HD : nullptr;
  uint4* ring = reinterpret_cast<uint4*>(sm_raw);
  float* sc_ring = reinterpret_cast<float*>(sm_raw + C::RING);
  const int n_items = (lv.n + C::ROWS - 1) / C::ROWS;

  // live row (t·kRows + u)·NGROUPS + group of item t; rows past n copy
  // nothing and are zero-filled. Each lane reads back only what it copied.
  auto issue = [&](int t) {
    if (t < n_items) {
      const int st = t % kStages;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int j = (t * kRows + u) * NGROUPS + group;
        const bool ok = j < lv.n;
        const size_t pos = ok ? lv.pos(j) : 0;
        const int slot = (st * kRows + u) * 2 * kThreads + tid;
        const bool ld = ok && has_data;
        cp_async16_zfill(ring + slot, kb + pos * HD, ld);
        cp_async16_zfill(ring + slot + kThreads, vb + pos * HD, ld);
        if constexpr (kQuant) {
          cp_async4_zfill(sc_ring + slot, ksb + pos, ok);
          cp_async4_zfill(sc_ring + slot + kThreads, vsb + pos, ok);
        }
      }
    }
    cp_async_commit();
  };

  float m_true = NEG_INF;          // the split's max score, head g_own
  float l_sum = 0.f;               // its sum of p against m_ref below
  float m_ref = NEG_INF;           // reference max of head g_own
  float acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < n_items; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int st = t % kStages;
    float s[kRows];
    bool valid[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int slot = (st * kRows + u) * 2 * kThreads + tid;
      valid[u] = (t * kRows + u) * NGROUPS + group < lv.n;
      float kf[EPL];
      unpack(ring[slot], kf, kb);
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qf[g][e], kf[e], a);
        d[g] = a;
      }
      float dot = reduce_scatter<G, LPR>(d, cl);
      if constexpr (kQuant) dot *= sc_ring[slot];   // k dequant, pre-cap
      if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
      s[u] = valid[u] ? dot : NEG_INF;
    }
    float mx = s[0];
#pragma unroll
    for (int u = 1; u < kRows; ++u) mx = fmaxf(mx, s[u]);
    m_true = fmaxf(m_true, mx);
    const bool need = mx > m_ref + kLazy;
    if (__any_sync(0xffffffffu, need)) {   // rare: rescale to a new max
      const float alpha = need ? __expf(m_ref - mx) : 1.f;
      m_ref = need ? mx : m_ref;
      l_sum *= alpha;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a = G == 1 ? alpha
            : __shfl_sync(0xffffffffu, alpha, sub * LPR + g * LPG);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= a;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int slot = (st * kRows + u) * 2 * kThreads + tid;
      const float pr = valid[u] ? __expf(s[u] - m_ref) : 0.f;
      l_sum += pr;
      const float pw = kQuant ? pr * sc_ring[slot + kThreads] : pr;
      float vf[EPL];
      unpack(ring[slot + kThreads], vf, vb);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = G == 1 ? pw
            : __shfl_sync(0xffffffffu, pw, sub * LPR + g * LPG);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring becomes the merge scratch

  // merge the row groups' partials (§4.2.2) in shared memory
  float* sm_acc = scratch;                                 // [NG][G][HD]
  float* sm_mref = sm_acc + NGROUPS * G * HD;              // [NG][G]
  float* sm_mtrue = sm_mref + NGROUPS * G;
  float* sm_l = sm_mtrue + NGROUPS * G;
  float* sm_w = sm_l + NGROUPS * G;                        // [NG][G]
  float* sm_M = sm_w + NGROUPS * G;                        // [G]
  if (cl % LPG == 0) {
    sm_mref[group * G + g_own] = m_ref;
    sm_mtrue[group * G + g_own] = m_true;
    sm_l[group * G + g_own] = l_sum;
  }
  if (has_data) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPL; e += 4)
        *reinterpret_cast<float4*>(sm_acc + (group * G + g) * HD +
                                   cl * EPL + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                        acc[g][e + 3]);
  }
  __syncthreads();
  if (tid < NGROUPS * G) {         // one weight per (group, head)
    const int g = tid % G;
    float M = NEG_INF;
#pragma unroll
    for (int i = 0; i < NGROUPS; ++i) M = fmaxf(M, sm_mtrue[i * G + g]);
    sm_w[tid] = __expf(sm_mref[tid] - M);                 // <= 1
    if (tid < G) sm_M[tid] = M;
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int i = 0; i < NGROUPS; ++i) {
      const float w = sm_w[i * G + g];
      L = fmaf(sm_l[i * G + g], w, L);
      A = fmaf(sm_acc[(i * G + g) * HD + idx % HD], w, A);
    }
    put_partial<G, HD>(p, bh, BHkv, S, split, idx, A, L, sm_M[g]);
  }
  if (S > 1) merge_splits<G, HD>(p, bh, BHkv, S, sm_raw, C::UNION);
}

// The kernel of an instantiation and its dynamic shared memory.
template <typename T, int HD, int G>
void (*kernel_of())(const Params) {
  if constexpr (G >= kTcMinG) return dense_tc_kernel<T, HD, G>;
  else return dense_lanes_kernel<T, HD, G>;
}

template <typename T, int HD, int G>
constexpr int dynamic_smem() {
  if constexpr (G >= kTcMinG) return Tc<T, HD, G>::SMEM;
  else return 0;
}

// Allow the kernel its dynamic shared memory and the largest shared-memory
// carveout (so as many CTAs fit an SM as their shared memory allows), once
// per device.
template <typename T, int HD, int G>
cudaError_t prepare() {
  static std::atomic<uint64_t> done{0};   // a bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_of<T, HD, G>(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic_smem<T, HD, G>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_of<T, HD, G>(),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int HD, int G>
cudaError_t launch(const Params& prm, int B, int splits,
                   cudaStream_t stream) {
  // the splits of one (b, h) are neighbours in launch order, so the block
  // scheduler spreads a long sequence's splits over different SMs
  const dim3 grid(splits, prm.Hkv, B);
  const cudaError_t err = prepare<T, HD, G>();
  if (err != cudaSuccess) return err;
  kernel_of<T, HD, G>()<<<grid, kThreads, dynamic_smem<T, HD, G>(),
                          stream>>>(prm);
  return cudaGetLastError();
}

// CTAs of an instantiation one SM holds at once (its occupancy).
template <typename T, int HD, int G>
int ctas_per_sm() {
  int n = 0;
  if (prepare<T, HD, G>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of<T, HD, G>(), kThreads, dynamic_smem<T, HD, G>()) !=
          cudaSuccess)
    return -1;
  return n;
}

template <typename T, int HD>
int occupancy(int G) {
  switch (G) {
    case 1: return ctas_per_sm<T, HD, 1>();
    case 2: return ctas_per_sm<T, HD, 2>();
    case 4: return ctas_per_sm<T, HD, 4>();
    case 8: return ctas_per_sm<T, HD, 8>();
    case 16: return ctas_per_sm<T, HD, 16>();
    default: return -1;
  }
}

template <typename T>
int occupancy_of(int head_dim, int G) {
  switch (head_dim) {
    case 64: return occupancy<T, 64>(G);
    case 112: return occupancy<T, 112>(G);
    case 128: return occupancy<T, 128>(G);
    default: return -1;
  }
}

template <typename T, int HD>
cudaError_t dispatch_group(int G, const Params& prm, int B, int splits,
                           cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, HD, 1>(prm, B, splits, stream);
    case 2: return launch<T, HD, 2>(prm, B, splits, stream);
    case 4: return launch<T, HD, 4>(prm, B, splits, stream);
    case 8: return launch<T, HD, 8>(prm, B, splits, stream);
    case 16: return launch<T, HD, 16>(prm, B, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int entry(const void* q, const void* k_cache, const void* v_cache,
          const void* k_scale, const void* v_scale, const void* cache_len,
          void* o, void* l, void* m, void* workspace, void* tickets, int B,
          int Hkv, int G, int head_dim, int S, long long batch_stride,
          int splits, int sliding_window, int attention_sinks,
          float logit_softcap, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  // the split plan the kernel can hold: S' in [1, max_splits(G)], no split
  // without a 16-row unit (one split of an empty cache); a workspace and
  // tickets when S' > 1
  const int units = S > 0 ? (S + kUnit - 1) / kUnit : 0;
  if (B > 65535 || Hkv > 65535 || S < 0 ||           // grid.z and grid.y
      batch_stride < static_cast<long long>(Hkv) * S * head_dim ||
      splits < 1 || splits > max_splits(G) ||
      (units > 0 && splits > units) || (units == 0 && splits != 1) ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
                   static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale),
                   static_cast<const int32_t*>(cache_len),
                   static_cast<__nv_bfloat16*>(o), static_cast<float*>(l),
                   static_cast<float*>(m), static_cast<float*>(workspace),
                   static_cast<int*>(tickets), Hkv, S, batch_stride,
                   sliding_window, attention_sinks, logit_softcap,
                   1.0f / sqrtf(static_cast<float>(head_dim))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(dispatch_group<T, 64>(G, prm, B, splits,
                                                           s));
    case 112: return static_cast<int>(dispatch_group<T, 112>(G, prm, B,
                                                             splits, s));
    case 128: return static_cast<int>(dispatch_group<T, 128>(G, prm, B,
                                                             splits, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry points (bound with ctypes). Each launches one kernel on
// `stream` and returns cudaGetLastError() as an int (0 = launched);
// cudaErrorInvalidValue for a head_dim / group size the kernel is not
// instantiated for, or a split plan it cannot hold. The caches are (Hkv,
// S, head_dim) contiguous within a sequence, sequences `batch_stride`
// elements apart (>= Hkv·S·head_dim; more for a head slice of a wider
// cache); an int8 cache's scales are laid out alike, batch_stride /
// head_dim apart. `splits` is S' of the grid (S', Hkv, B); with S' > 1,
// `workspace` holds B·Hkv·S'·G·(head_dim + 2) fp32 and `tickets` B·Hkv
// int32 that are 0 (the kernel leaves them 0). The int8 entry needs both
// scale arrays.
extern "C" int decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* cache_len, void* o, void* l, void* m, void* workspace,
    void* tickets, int B, int Hkv, int G, int head_dim, int S,
    long long batch_stride, int splits, int sliding_window,
    int attention_sinks, float logit_softcap, void* stream) {
  return repro_torch::entry<__nv_bfloat16>(
      q, k_cache, v_cache, nullptr, nullptr, cache_len, o, l, m, workspace,
      tickets, B, Hkv, G, head_dim, S, batch_stride, splits, sliding_window,
      attention_sinks, logit_softcap, stream);
}

extern "C" int decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* cache_len,
    void* o, void* l, void* m, void* workspace, void* tickets, int B,
    int Hkv, int G, int head_dim, int S, long long batch_stride, int splits,
    int sliding_window, int attention_sinks, float logit_softcap,
    void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::entry<int8_t>(
      q, k_cache, v_cache, k_scale, v_scale, cache_len, o, l, m, workspace,
      tickets, B, Hkv, G, head_dim, S, batch_stride, splits, sliding_window,
      attention_sinks, logit_softcap, stream);
}

// CTAs of the kernel for (int8 or bf16 cache, head_dim, G) one SM of the
// current device holds at once; -1 for a shape it is not instantiated for.
extern "C" int decode_attention_ctas_per_sm(int int8, int head_dim, int G) {
  return int8 ? repro_torch::occupancy_of<int8_t>(head_dim, G)
              : repro_torch::occupancy_of<__nv_bfloat16>(head_dim, G);
}
