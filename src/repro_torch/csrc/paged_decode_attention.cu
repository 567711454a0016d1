// Paged flash-decode GQA attention over the head-major KV block pool, for
// bf16 pools and for int8 pools with fp32 per-token scales: split-KV over
// the SMs, one launch that merges its own partials, and the G query heads
// of a kv head on the tensor cores for bf16 pools at G >= 8.
//
// Replaces the TPU kernel repro/kernels/paged_decode_attention.py
// `_paged_decode_kernel` (:55, bf16 pools) with the entry point
// `paged_decode_attention_bf16`, and its int8-pool variant
// `_paged_decode_kernel_int8` (:119) with `paged_decode_attention_int8`;
// both are called there by pallas_call at :273. Same contract: q (B, Hkv, G, hd) bf16; pools (Hkv, num_blocks, bs,
// hd); int8 pools add scale pools (Hkv, num_blocks, bs) fp32 walked through
// the same table; block_tables (B, nb) int32; optional block_positions
// (B, nb) int32 (each slot's global base position, POS_PAD on slots to
// ignore); cache_len (B,). Writes o (B, Hkv, G, hd) in q's dtype and the
// §4.2.2 partial l, m as fp32 (B, Hkv, G). The int8 kernel multiplies the
// scores by the k scale after q·k and before the softcap, and p by the v
// scale before the PV product (l sums the unscaled p), as the TPU kernel
// does; nothing dequantized is written anywhere.
//
// What bounds it on an H100: decode reads every live K/V row once and does
// 2·G flops per element read — a few flops per byte against the card's
// ~295 flop/byte ridge — so it is bound by device-memory bytes (int8 pools
// read hd + 4 bytes per token-head for K and for V instead of 2·hd). To move
// 3.35 TB/s the card needs ~25 KB in flight on every one of its 132 SMs,
// and each SM must consume 12.8-14.5 bytes a clock. On the CUDA cores the
// G query heads cost 2·G FP32 FMAs per element read: at G = 16 that is 8
// FMAs a byte (bf16), beside 2·G shuffles a row for the reduce-scatter and
// the p gather, more than an SM issues at the byte rate, so the lanes are
// issue-bound there (10.8 % of the byte bound at glm4-9b's G = 16). On the
// tensor cores the G heads are the M rows of one mma: the math per byte no
// longer grows with G, and bytes bound the kernel again.
//
// What the design does about it:
//  * split-KV: one CTA per (b, h, split), launched as grid (S, Hkv, B)
//    with the splits fastest, so a long sequence's splits go to different
//    SMs. The wrapper picks S on the host from nb, B·Hkv and the SM count
//    (plan_splits: 4 CTAs an SM, >= 2 wherever the table has the slots),
//    never from cache_len, so it needs no sync. The CTAs share out the
//    sequence's live slots, which they find from cache_len: those before
//    it, in the window or among the sinks, at most two runs of the table
//    (split_slots), so a window's slots spread over the splits: cut from
//    the whole table, a window of 8192 tokens at the end of a
//    524,288-token one falls in 2 of its 66 splits, and a few CTAs stream
//    it while the other SMs idle. With block positions (the block
//    partition's shards) a slot's position is known only from the table,
//    and split j takes slots [j·nb/S, (j+1)·nb/S). A CTA first compacts
//    its slice of the table into shared memory (slots with a live row only:
//    past cache_len, outside the window or POS_PAD drop out), so a split
//    with nothing live does no load and no math. The rows of the live
//    slots, in order, are the split's rows; row j is row j % bs of live
//    slot j / bs (an exact multiply-high division), so any block size
//    works in both designs below.
//  * one launch: each split writes its fp32 (m, l, acc) partial to a
//    workspace; the last CTA of a (b, h) to arrive (an atomic ticket after
//    a __threadfence) merges the S partials by the §4.2.2 rule, writes o,
//    l and m, and resets the ticket to 0 for the next call (so a replayed
//    CUDA graph finds its tickets as the capture did). With S = 1 the CTA
//    writes o, l, m itself. A second combine kernel would add a launch to
//    each of a decode step's 32 (bf16) or 64 (int8, head partition)
//    host-bound calls.
//  * masked rows: a row no mask keeps (past cache_len, outside the window
//    and sinks, behind a POS_PAD slot, past the split's rows) is copied
//    with src-size 0: nothing is read from device memory and its k, v and
//    scales are zero in shared memory, so stale or NaN memory — values or
//    scales — never reaches the math (in an mma a weight of 0 times a NaN
//    V element would be NaN); its score is selected to NEG_INF and its p
//    to 0 (masks select, never multiply).
//
// bf16 pools at G >= 8 (paged_decode_kernel_tc; row 5's dense_tc_kernel
// over the pool):
//  * the G query heads of the kv head are the M rows of
//    mma.sync.m16n8k16 (bf16 in, fp32 accumulate; G = 8 fills half the
//    tile). Each of the 4 warps owns 16-row chunks of the split's rows
//    (chunks w, w + 4, ...) and streams them through its own 3-stage ring
//    in shared memory by 16-byte cp.async, two chunks ahead. Lanes r and
//    r + 16 place row r of a chunk (its slot from the compacted list, its
//    masks); a ballot gives the chunk's 16-bit row mask and a shuffle each
//    copy's row, so a chunk may straddle blocks (at block size 16 it is
//    one block: 256 contiguous bytes a row). S = QKᵀ takes hd/16 k-steps
//    with K's B fragments by ldmatrix from the row-major tile; PV takes
//    hd/8 n-tiles with V's B fragments by ldmatrix.trans, so V is never
//    transposed by a copy. Tile rows are padded by 16 bytes, so ldmatrix's
//    8 rows fall on distinct banks. The 16 × hd fp32 accumulator stays in
//    one warp's registers; the 4 warps' online-softmax states are merged
//    in shared memory at the end. ~104 KB of ring at hd 128: 2 CTAs an SM,
//    ~130 KB of loads in flight on each.
//  * q goes into the mma as stored (1/√128 and 1/√112 are not powers of
//    two: scaling bf16 q would round it) and the scale multiplies the fp32
//    scores. P is split into hi = bf16(p) and lo = bf16(p - hi) and PV
//    runs on both, so P is kept to 2^-17 of itself against the fp32 twin;
//    l sums the unscaled fp32 p.
//  * math a chunk (16 rows, 8 KB at hd 128): 2·hd/16 + 2·hd/8 mma (48),
//    hd/8 ldmatrix, 2·CPR cp.async a lane and one row placement: ~0.06
//    warp instructions a byte, against the ~4 an SM issues a clock.
//
// bf16 pools at G <= 4, and int8 pools (paged_decode_kernel, the CUDA-core
// lanes):
//  * loads in flight while the CTA computes: a 4-stage ring in shared
//    memory, filled by per-thread 16-byte cp.async (4-byte for the scales)
//    three items ahead of the one being computed. Each lane reads back only
//    what it copied itself, so the ring needs no barrier. An item is 2 rows
//    for each row group (16-64 rows of the split's live rows).
//  * lane layout: each group of LPR lanes owns one key row, EPL elements a
//    lane (bf16: 8, one 16-byte load; int8: 16 for G <= 4, else 8; both 4
//    at G = 16, where 2·G·EPL q and accumulator floats a lane must fit the
//    registers), so one read of a K row serves all G query heads (GQA
//    reuse). LPR is hd/EPL rounded up to a power of two: at hd = 112 the
//    last 2 of 16 lanes (or 1 of 8, 4 of 32) of a row hold no data, load
//    nothing and add 0, so the xor shuffles stay inside the row. The
//    G partial dot products are reduce-scattered over the group's lanes
//    (G - 1 + log2(LPR/G) shuffles instead of G·log2(LPR)), so each lane
//    runs the online softmax of one query head; the G weights p then reach
//    every lane of the group by G shuffles for PV.
//  * lazy rescale: a query head's reference max moves only when a score
//    exceeds it by more than 8 (p <= e^8 in fp32), so the G·EPL
//    accumulator rescale runs a few times per split instead of at every
//    row; the true max is tracked beside it and the partial written with
//    it, exactly.
//  * int8 conversion without I2F: x ^ 0x80808080 turns each byte into
//    b + 128; __byte_perm places it in the low mantissa of 2^23, and one
//    FADD of -(2^23 + 128) leaves b exactly (common.cuh). Per byte of K or
//    V that is 1/4 LOP3 + 1 PRMT + 1 FADD on full-rate pipes, against one
//    I2F a byte on the 16-a-clock conversion pipe before (~80 % of that
//    pipe at the bandwidth bound).
//
// CUDA-core instructions per byte read, estimated from this source (per
// lane, per row of 2·EPL bytes of K and V, G = 4; the SM issues 128 thread
// instructions a clock, and 3.35 TB/s over 132 SMs at 1.755-1.98 GHz is
// 12.8-14.5 bytes a clock):
//   int8 (EPL 16, LPR 8): convert 2 × 33, QK FMA 64, reduce-scatter 4 SHFL
//   + 4 FADD + 6 SEL, own-head softmax ~10, p gather 4 SHFL, PV FMA 64,
//   v scale 1, cp.async + addressing + validity ~26: ~249 / 32 bytes = 7.8
//   a byte, 100-113 of the 128 issue slots a clock at the bandwidth
//   bound: the int8 entry meets the issue limit about where it would meet
//   the byte limit (the FMAs alone are 4 a byte at G = 4), and at G = 16
//   far above it. Its tensor-core form (K/V converted to bf16 exactly in
//   shared memory, as row 5's int8 entry does) is not written yet.
//   bf16 (EPL 8, LPR 16): convert 2 × 4, FMA 2 × 32, reduce-scatter 5 SHFL
//   + 5 FADD + 6 SEL, softmax ~10, gather 4, cp.async + addressing ~22:
//   ~124 / 32 bytes = 3.9 a byte -> 50-57 of 128 slots at the bound.

#include <atomic>
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;        // ring depth: items in flight + 1
constexpr int kRows = 2;          // rows of each row group in one item
constexpr int kMaxSlots = 512;    // table slots of one split (shared list)
constexpr int kMaxSplits = 512;   // splits of one (b, h)
constexpr int kMaxBlockSize = 1024;   // exact row -> slot by mul-hi below
constexpr float kLazy = 8.0f;     // reference-max headroom (natural log)
// The least G whose query heads run on the tensor cores over a bf16 pool
// (row 5's kTcMinG).
constexpr int kTcMinG = 8;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The most splits of one (b, h): the last CTA's merge keeps S·G (m, l)
// pairs in static shared memory, so G = 16 takes half as many.
__host__ __device__ constexpr int max_splits(int G) {
  return G > 8 ? kMaxSplits / 2 : kMaxSplits;
}

template <typename T, int HD, int G>
struct Cfg {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  // elements a lane loads of a row: 16 bytes where the registers allow;
  // at G = 16 the q and accumulator registers (2·G·EPL floats) allow 4
  static constexpr int EPL = G > 8 ? 4 : (kQuant && G <= 4) ? 16 : 8;
  static constexpr int CHUNK = EPL * static_cast<int>(sizeof(T));  // bytes
  static constexpr int LPR_HD = HD / EPL;       // lanes holding data
  // lanes per key row, a power of two so the shuffles stay in the row
  // (hd = 112: 14 or 7 lanes hold data, the rest load nothing, hold 0)
  static constexpr int LPR = pow2_ceil(LPR_HD);
  static constexpr int RPW = 32 / LPR;          // rows one warp load covers
  static constexpr int NGROUPS = kWarps * RPW;  // row groups of the CTA
  static constexpr int ROWS = kRows * NGROUPS;  // rows per item
  static constexpr int LPG = LPR / G;           // lanes per query head
  static_assert(HD % EPL == 0 && LPR <= 32, "whole chunks, one warp a row");
  static_assert(G <= LPR, "the reduce-scatter needs G <= lanes per row");
  // shared memory, one union: the ring while the split runs, then the row
  // groups' partials, then the S splits' (m, l) in the last CTA
  static constexpr int RING = kStages * kRows * 2 * kThreads * CHUNK;
  static constexpr int SCALES = kQuant ? kStages * kRows * 2 * kThreads * 4
                                       : 0;
  static_assert(NGROUPS * G <= kThreads, "one thread per group weight");
  static constexpr int MERGE = (NGROUPS * G * (HD + 4) + G) * 4;
  static constexpr int SPLITS = 2 * max_splits(G) * G * 4;
  static constexpr int UNION_ = (RING + SCALES > MERGE ? RING + SCALES
                                                       : MERGE);
  static constexpr int UNION = UNION_ > SPLITS ? UNION_ : SPLITS;
};

struct Params {
  const __nv_bfloat16* q;
  const void *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int32_t *tables, *positions, *cache_len;
  __nv_bfloat16* o;
  float *l, *m;
  float* ws;          // S > 1: acc (B·Hkv·S·G·HD) then (m, l) pairs
  int* tickets;       // S > 1: one per (b, h), 0 between calls
  int Hkv, num_blocks, bs, nb, sliding_window, sinks;
  float softcap, scale;
};

// The raw vector one lane copies per key row: EPL elements of T.
template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = uint32_t; };

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
__device__ __forceinline__ void unpack(const uint2& r, float* out,
                                       const __nv_bfloat16*) {
  bf16x4_to_float(r, out);
}
__device__ __forceinline__ void unpack(const uint32_t& r, float* out,
                                       const int8_t*) {
  int8x4_to_float(r, out);
}

// EPL bf16 elements of q (8-byte loads for EPL 4, else 16-byte ones).
template <int EPL>
__device__ __forceinline__ void load_q(const __nv_bfloat16* src,
                                       float* out) {
  if constexpr (EPL == 4) {
    bf16x4_to_float(__ldg(reinterpret_cast<const uint2*>(src)), out);
  } else {
#pragma unroll
    for (int c = 0; c < EPL / 8; ++c) bf16x8_to_float(ldg16(src + c * 8),
                                                      out + c * 8);
  }
}

template <int BYTES>
__device__ __forceinline__ void copy_row(void* smem, const void* gmem,
                                         bool ok) {
  if constexpr (BYTES == 16) cp_async16_zfill(smem, gmem, ok);
  else if constexpr (BYTES == 8) cp_async8_zfill(smem, gmem, ok);
  else cp_async4_zfill(smem, gmem, ok);
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

// The table slots of one split: entries v0 .. v0 + n - 1 of the
// sequence's list of live slots, entry v at table slot v below a1, else
// at b0 + (v - a1).
struct SplitSlots {
  int v0, n, a1, b0;
  __device__ __forceinline__ int slot(int v) const {
    return v < a1 ? v : b0 + (v - a1);
  }
};

// Split `split` of S's share of the live slots of a sequence of `len`
// tokens. Without block positions slot i holds positions [i·bs, i·bs +
// bs): the slots before len are [0, hi), of which a window keeps the
// sink slots [0, sa) and [wlo, hi), the slots it reaches; the S splits
// share those evenly. With positions every slot is listed.
__device__ __forceinline__ SplitSlots split_slots(const Params& p, int len,
                                                  int S, int split) {
  int total = p.nb, a1 = p.nb, b0 = p.nb;
  if (!p.positions) {
    const int hi = min(p.nb, (max(len, 0) + p.bs - 1) / p.bs);
    a1 = b0 = hi;
    if (p.sliding_window > 0) {
      const int win_lo = len - p.sliding_window;  // first in-window position
      const int wlo = win_lo > 0 ? win_lo / p.bs : 0;
      const int sa = p.sinks > 0 ? (p.sinks + p.bs - 1) / p.bs : 0;
      if (wlo > sa) {                              // two runs
        a1 = min(sa, hi);
        b0 = min(wlo, hi);
      }
    }
    total = a1 + (hi - b0);
  }
  const int v0 = static_cast<int>(static_cast<int64_t>(split) * total / S);
  const int v1 =
      static_cast<int>(static_cast<int64_t>(split + 1) * total / S);
  return {v0, v1 - v0, a1, b0};
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Params p) {
  using C = Cfg<T, HD, G>;
  constexpr bool kQuant = C::kQuant;
  constexpr int EPL = C::EPL, LPR = C::LPR, RPW = C::RPW;
  constexpr int NGROUPS = C::NGROUPS, LPG = C::LPG, LPR_HD = C::LPR_HD;
  using Raw = typename RawVec<C::CHUNK>::type;
  constexpr int kSlotsPerThread = kMaxSlots / kThreads;

  __shared__ alignas(16) unsigned char sm_raw[C::UNION];
  __shared__ int sm_tile[kMaxSlots];
  __shared__ int sm_base[kMaxSlots];
  __shared__ int sm_wcount[kWarps];
  __shared__ float sm_gm[G], sm_gl[G];
  __shared__ int sm_last;

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
  const int bs = p.bs;

  // every load the prologue needs, issued together (after cache_len,
  // which places the split)
  const int len = p.cache_len[b];
  const SplitSlots sp = split_slots(p, len, S, split);
  const int n = sp.n;
  const int32_t* table = p.tables + static_cast<size_t>(b) * p.nb;
  const int32_t* bpos = p.positions
      ? p.positions + static_cast<size_t>(b) * p.nb : nullptr;
  int tile_r[kSlotsPerThread], base_r[kSlotsPerThread];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    const int s = i * kThreads + tid;
    tile_r[i] = 0;
    base_r[i] = 0;
    if (s < n) {
      const int slot = sp.slot(sp.v0 + s);
      tile_r[i] = __ldg(table + slot);
      base_r[i] = bpos ? __ldg(bpos + slot) : slot * bs;
    }
  }
  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_q<EPL>(p.q + (bh * G + g) * HD + cd * EPL, qf[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] = has_data ? qf[g][e] * p.scale
                                                      : 0.f;
  }

  // compact the split's live slots (any row unmasked) into shared memory,
  // in table order
  const int sw = p.sliding_window, sinks = p.sinks;
  const int win_lo = len - sw;               // first in-window position
  int n_live = 0;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    if (i * kThreads >= n) break;            // uniform over the CTA
    const int base = base_r[i];
    const bool live = i * kThreads + tid < n && base < len &&
        !(sw > 0 && base + bs <= win_lo && !(sinks > 0 && base < sinks));
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sm_wcount[warp] = __popc(bal);
    __syncthreads();
    int off = n_live, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sm_wcount[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (live) {
      const int at = off + __popc(bal & ((1u << lane) - 1u));
      sm_tile[at] = tile_r[i];
      sm_base[at] = base;
    }
    n_live += total;
    __syncthreads();
  }

  float m_true = NEG_INF;          // the split's max score, head g_own
  float l_sum = 0.f;               // its sum of p against m_ref below

  if (n_live > 0) {
    Raw* ring = reinterpret_cast<Raw*>(sm_raw);
    float* sc_ring = reinterpret_cast<float*>(sm_raw + C::RING);
    const T* k_pool = static_cast<const T*>(p.k_pool);
    const T* v_pool = static_cast<const T*>(p.v_pool);
    const size_t head_rows = static_cast<size_t>(h) * p.num_blocks;
    const int n_items = (n_live * bs + C::ROWS - 1) / C::ROWS;
    // exact floor(j / bs) for j · bs < 2^32 (j < (kMaxSlots + 1) · bs)
    const uint64_t magic = ((1ull << 32) + bs - 1) / bs;
    uint32_t vbits = 0;                      // valid bit per (stage, row)

    auto issue = [&](int t) {
      if (t < n_items) {
        const int st = t % kStages;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const uint32_t j = static_cast<uint32_t>((t * kRows + u) * NGROUPS
                                                   + group);
          const uint32_t k = static_cast<uint32_t>((j * magic) >> 32);
          const int r = static_cast<int>(j - k * bs);
          bool ok = false;
          int tile = 0;
          if (k < static_cast<uint32_t>(n_live)) {
            const int pos = sm_base[k] + r;
            ok = pos < len &&
                 (sw <= 0 || pos >= win_lo || (sinks > 0 && pos < sinks));
            tile = sm_tile[k];
          }
          const size_t row = (head_rows + tile) * bs + (ok ? r : 0);
          const int slot = (st * kRows + u) * 2 * kThreads + tid;
          const bool ld = ok && has_data;
          copy_row<C::CHUNK>(ring + slot, k_pool + row * HD + cd * EPL, ld);
          copy_row<C::CHUNK>(ring + slot + kThreads,
                             v_pool + row * HD + cd * EPL, ld);
          if constexpr (kQuant) {
            cp_async4_zfill(sc_ring + slot, p.k_scale + row, ok);
            cp_async4_zfill(sc_ring + slot + kThreads, p.v_scale + row, ok);
          }
          const int bit = st * kRows + u;
          vbits = (vbits & ~(1u << bit)) | (static_cast<uint32_t>(ok) << bit);
        }
      }
      cp_async_commit();
    };

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
        valid[u] = (vbits >> (st * kRows + u)) & 1u;
        float kf[EPL];
        unpack(ring[slot], kf, k_pool);
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
        unpack(ring[slot + kThreads], vf, v_pool);
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
    float* sm_acc = reinterpret_cast<float*>(sm_raw);        // [NG][G][HD]
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
      const float M = sm_M[g];
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int i = 0; i < NGROUPS; ++i) {
        const float w = sm_w[i * G + g];
        L = fmaf(sm_l[i * G + g], w, L);
        A = fmaf(sm_acc[(i * G + g) * HD + idx % HD], w, A);
      }
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
    if (S == 1) return;
  } else {
    // nothing live in this split: the empty partial (o = 0, l = 0,
    // m = NEG_INF); with S > 1 only (m, l) is written, and the merge skips
    // the acc of a partial whose l is 0
    if (S == 1) {
      for (int idx = tid; idx < G * HD; idx += kThreads) {
        p.o[bh * G * HD + idx] = __float2bfloat16(0.f);
        if (idx % HD == 0) {
          p.l[bh * G + idx / HD] = 0.f;
          p.m[bh * G + idx / HD] = NEG_INF;
        }
      }
      return;
    }
    if (tid < G) {
      float* ml = p.ws + BHkv * S * G * HD
          + ((bh * S + split) * G + tid) * 2;
      ml[0] = NEG_INF;
      ml[1] = 0.f;
    }
  }

  // the last split of (b, h) to finish merges all S partials
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(p.tickets + bh, 1) == S - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  const float* ws_acc = p.ws + bh * S * G * HD;
  const float* ws_part = p.ws + BHkv * S * G * HD + bh * S * G * 2;
  // each thread sums its EPT elements over the S splits, kBatch splits'
  // loads in flight at a time (the first batch's beside the (m, l) loads);
  // an empty split's acc was never written, so its weight 0 selects it away
  constexpr int EPT = (G * HD + kThreads - 1) / kThreads;
  constexpr int kBatch = EPT >= 32 ? 1 : 32 / EPT;
  float v[kBatch][EPT];
  auto load_batch = [&](int i0) {
#pragma unroll
    for (int c = 0; c < kBatch; ++c)
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int idx = tid + k * kThreads;
        v[c][k] = i0 + c < S && idx < G * HD
            ? __ldcg(ws_acc + (i0 + c) * G * HD + idx) : 0.f;
      }
  };
  load_batch(0);
  float* sp_w = reinterpret_cast<float*>(sm_raw);   // [S][G]: m, then weight
  float* sp_l = sp_w + max_splits(G) * G;           // [S][G]
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
  __syncthreads();
  float A[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) A[k] = 0.f;
  for (int i0 = 0; i0 < S; i0 += kBatch) {
    if (i0 > 0) load_batch(i0);
#pragma unroll
    for (int c = 0; c < kBatch; ++c)
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int idx = tid + k * kThreads;
        const float w = i0 + c < S && idx < G * HD
            ? sp_w[(i0 + c) * G + idx / HD] : 0.f;
        A[k] = w != 0.f ? fmaf(w, v[c][k], A[k]) : A[k];
      }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = tid + k * kThreads;
    if (idx >= G * HD) continue;
    const int g = idx / HD;
    p.o[bh * G * HD + idx] = __float2bfloat16(A[k] /
                                              fmaxf(sm_gl[g], 1e-30f));
    if (idx % HD == 0) {
      p.l[bh * G + g] = sm_gl[g];
      p.m[bh * G + g] = sm_gm[g];
    }
  }
  if (tid == 0) p.tickets[bh] = 0;   // ready for the next call
}

// ---------------------------------------------------------------------------
// bf16 pools at G >= kTcMinG: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
// The tensor-core kernel's prologue and epilogue: the lanes kernel's table
// compaction, partial writes and split merge, as functions. The lanes kernel
// keeps its inline copy: calling these in its place changed its code, and it
// timed 7-18 % slower on an H100 at G = 4.
constexpr int kSlotsPerThread = kMaxSlots / kThreads;

// The split's table slots s = i·kThreads + tid below sp.n: each one's pool
// block and base position (0 past the split's slots).
__device__ __forceinline__ void load_slots(const Params& p,
                                           const SplitSlots& sp, int b,
                                           int (&tile_r)[kSlotsPerThread],
                                           int (&base_r)[kSlotsPerThread]) {
  const int32_t* table = p.tables + static_cast<size_t>(b) * p.nb;
  const int32_t* bpos = p.positions
      ? p.positions + static_cast<size_t>(b) * p.nb : nullptr;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    const int s = i * kThreads + threadIdx.x;
    tile_r[i] = 0;
    base_r[i] = 0;
    if (s < sp.n) {
      const int slot = sp.slot(sp.v0 + s);
      tile_r[i] = __ldg(table + slot);
      base_r[i] = bpos ? __ldg(bpos + slot) : slot * p.bs;
    }
  }
}

// Compact the split's n slots that hold a live row (any row unmasked) into
// sm_tile / sm_base, in table order; returns how many. The whole CTA calls
// it (barriers).
__device__ __forceinline__ int compact_slots(
    const Params& p, int len, int n, const int (&tile_r)[kSlotsPerThread],
    const int (&base_r)[kSlotsPerThread], int* sm_tile, int* sm_base,
    int* sm_wcount) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bs = p.bs, sw = p.sliding_window, sinks = p.sinks;
  const int win_lo = len - sw;               // first in-window position
  int n_live = 0;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    if (i * kThreads >= n) break;            // uniform over the CTA
    const int base = base_r[i];
    const bool live = i * kThreads + tid < n && base < len &&
        !(sw > 0 && base + bs <= win_lo && !(sinks > 0 && base < sinks));
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sm_wcount[warp] = __popc(bal);
    __syncthreads();
    int off = n_live, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sm_wcount[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (live) {
      const int at = off + __popc(bal & ((1u << lane) - 1u));
      sm_tile[at] = tile_r[i];
      sm_base[at] = base;
    }
    n_live += total;
    __syncthreads();
  }
  return n_live;
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

// Nothing in this split is live: the empty partial (o = 0, l = 0,
// m = NEG_INF); with S > 1 only (m, l) is written, and the merge skips the
// acc of a partial whose l is 0.
template <int G, int HD>
__device__ __forceinline__ void put_empty(const Params& p, size_t bh,
                                          size_t BHkv, int S, int split) {
  const int tid = threadIdx.x;
  if (S == 1) {
    for (int idx = tid; idx < G * HD; idx += kThreads) {
      p.o[bh * G * HD + idx] = __float2bfloat16(0.f);
      if (idx % HD == 0) {
        p.l[bh * G + idx / HD] = 0.f;
        p.m[bh * G + idx / HD] = NEG_INF;
      }
    }
  } else if (tid < G) {
    float* ml = p.ws + BHkv * S * G * HD + ((bh * S + split) * G + tid) * 2;
    ml[0] = NEG_INF;
    ml[1] = 0.f;
  }
}

// The last split of (b, h) to finish merges all S partials (S > 1), with
// 2·max_splits(G)·G floats of shared `scratch`; the others return.
template <int G, int HD>
__device__ __forceinline__ void merge_splits(const Params& p, size_t bh,
                                             size_t BHkv, int S,
                                             unsigned char* scratch) {
  __shared__ float sm_gm[G], sm_gl[G];
  __shared__ int sm_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(p.tickets + bh, 1) == S - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  const float* ws_acc = p.ws + bh * S * G * HD;
  const float* ws_part = p.ws + BHkv * S * G * HD + bh * S * G * 2;
  // each thread sums its EPT elements over the S splits, kBatch splits'
  // loads in flight at a time (the first batch's beside the (m, l) loads);
  // an empty split's acc was never written, so its weight 0 selects it away
  constexpr int EPT = (G * HD + kThreads - 1) / kThreads;
  constexpr int kBatch = EPT >= 32 ? 1 : 32 / EPT;
  float v[kBatch][EPT];
  auto load_batch = [&](int i0) {
#pragma unroll
    for (int c = 0; c < kBatch; ++c)
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int idx = tid + k * kThreads;
        v[c][k] = i0 + c < S && idx < G * HD
            ? __ldcg(ws_acc + (i0 + c) * G * HD + idx) : 0.f;
      }
  };
  load_batch(0);
  float* sp_w = reinterpret_cast<float*>(scratch);  // [S][G]: m, then weight
  float* sp_l = sp_w + max_splits(G) * G;           // [S][G]
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
  __syncthreads();
  float A[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) A[k] = 0.f;
  for (int i0 = 0; i0 < S; i0 += kBatch) {
    if (i0 > 0) load_batch(i0);
#pragma unroll
    for (int c = 0; c < kBatch; ++c)
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int idx = tid + k * kThreads;
        const float w = i0 + c < S && idx < G * HD
            ? sp_w[(i0 + c) * G + idx / HD] : 0.f;
        A[k] = w != 0.f ? fmaf(w, v[c][k], A[k]) : A[k];
      }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int idx = tid + k * kThreads;
    if (idx >= G * HD) continue;
    const int g = idx / HD;
    p.o[bh * G * HD + idx] = __float2bfloat16(A[k] /
                                              fmaxf(sm_gl[g], 1e-30f));
    if (idx % HD == 0) {
      p.l[bh * G + g] = sm_gl[g];
      p.m[bh * G + g] = sm_gm[g];
    }
  }
  if (tid == 0) p.tickets[bh] = 0;   // ready for the next call
}

template <int HD, int G>
struct Tc {
  static constexpr int STAGES = 3;             // chunks in flight + 1
  static constexpr int LD = HD + 8;            // bf16 a padded tile row
  static constexpr int KSTEPS = HD / 16;       // QKᵀ k-steps
  static constexpr int NT = HD / 8;            // PV n-tiles
  static constexpr int CPR = HD / 8;           // 16-byte pieces of a row
  static constexpr int COPIES = 16 * CPR;      // ... of a chunk's K tile
  static constexpr int STAGE = 2 * 16 * LD * 2;    // K then V tile, bytes
  static constexpr int RING = kWarps * STAGES * STAGE;
  static constexpr int MERGE = (kWarps * 16 * HD + 2 * kWarps * 16) * 4;
  static constexpr int SPLITS = 2 * max_splits(G) * G * 4;
  static constexpr int SMEM = cmax(cmax(RING, MERGE), SPLITS);
  static_assert(HD % 16 == 0 && (G == 8 || G == 16), "m16n8k16 tiles");
  static_assert(COPIES % 32 == 0, "whole rounds of copies a lane");
};

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel_tc(const Params p) {
  using C = Tc<HD, G>;
  constexpr int STAGES = C::STAGES, LD = C::LD, CPR = C::CPR;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sm_tile[kMaxSlots];
  __shared__ int sm_base[kMaxSlots];
  __shared__ int sm_wcount[kWarps];

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
  const int bs = p.bs;

  // every load the prologue needs, issued together (after cache_len,
  // which places the split)
  const int len = p.cache_len[b];
  const SplitSlots sp = split_slots(p, len, S, split);
  int tile_r[kSlotsPerThread], base_r[kSlotsPerThread];
  load_slots(p, sp, b, tile_r, base_r);
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

  const int sw = p.sliding_window, sinks = p.sinks;
  const int win_lo = len - sw;               // first in-window position
  const int n_live = compact_slots(p, len, sp.n, tile_r, base_r, sm_tile,
                                   sm_base, sm_wcount);
  if (n_live == 0) {                    // uniform over the CTA
    put_empty<G, HD>(p, bh, BHkv, S, split);
    if (S > 1) merge_splits<G, HD>(p, bh, BHkv, S, smem);
    return;
  }

  const size_t head = static_cast<size_t>(h) * p.num_blocks * bs * HD;
  const __nv_bfloat16* kh = static_cast<const __nv_bfloat16*>(p.k_pool) +
                            head;
  const __nv_bfloat16* vh = static_cast<const __nv_bfloat16*>(p.v_pool) +
                            head;
  unsigned char* ring = smem + warp * STAGES * C::STAGE;
  const int n_chunks = (n_live * bs + 15) / 16;
  const int mine = warp < n_chunks ? (n_chunks - 1 - warp) / kWarps + 1 : 0;
  // exact floor(j / bs) for j · bs < 2^32 (j < (kMaxSlots + 1) · bs)
  const uint64_t magic = ((1ull << 32) + bs - 1) / bs;
  uint64_t keep = 0;                    // 16 bits a stage: rows kept

  // chunk t of this warp (the split's rows 16·(warp + 4t) ..) into stage
  // t % STAGES. Lanes r and r + 16 place row r: row j of the split is row
  // j % bs of live slot j / bs; its pool row within the head, and whether
  // a mask keeps it. Rows no mask keeps copy nothing and are zero-filled.
  auto issue = [&](int t) {
    if (t < mine) {
      const int st = t % STAGES;
      const uint32_t j = static_cast<uint32_t>((warp + t * kWarps) * 16 +
                                               (lane & 15));
      const uint32_t k = static_cast<uint32_t>((j * magic) >> 32);
      const int r = static_cast<int>(j - k * bs);
      bool ok = false;
      uint32_t row = 0;
      if (k < static_cast<uint32_t>(n_live)) {
        const int pos = sm_base[k] + r;
        ok = pos < len &&
             (sw <= 0 || pos >= win_lo || (sinks > 0 && pos < sinks));
        row = ok ? static_cast<uint32_t>(sm_tile[k]) * bs + r : 0u;
      }
      const uint32_t rows = __ballot_sync(0xffffffffu, ok) & 0xffffu;
      keep = (keep & ~(0xffffull << (16 * st))) |
             (static_cast<uint64_t>(rows) << (16 * st));
      unsigned char* stg = ring + st * C::STAGE;
#pragma unroll
      for (int i = 0; i < C::COPIES / 32; ++i) {
        const int idx = lane + 32 * i;
        const int rr = idx / CPR, piece = idx % CPR;
        const size_t off =
            static_cast<size_t>(__shfl_sync(0xffffffffu, row, rr)) * HD +
            piece * 8;
        const bool ld = (rows >> rr) & 1u;
        cp_async16_zfill(stg + rr * 2 * LD + piece * 16, kh + off, ld);
        cp_async16_zfill(stg + (16 + rr) * 2 * LD + piece * 16, vh + off,
                         ld);
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
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  for (int t = 0; t < mine; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();                       // the chunk's copies by every lane
    issue(t + STAGES - 1);              // into the stage read at t - 1
    const int st = t % STAGES;
    const __nv_bfloat16* kt =
        reinterpret_cast<const __nv_bfloat16*>(ring + st * C::STAGE);
    const __nv_bfloat16* vt = kt + 16 * LD;
    const uint32_t rows = static_cast<uint32_t>(keep >> (16 * st));

    // S = Q·Kᵀ: s[n][e] is (row g + 8·(e / 2), key 8n + 2c + e % 2)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, kt + krow * LD + kk * 16 + kcol);
      mma_bf16(s[0], qa[kk], kf[0], kf[1]);
      mma_bf16(s[1], qa[kk], kf[2], kf[3]);
    }

    // scale in fp32, softcap, mask; the chunk's row maxima
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * c + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        x = (rows >> key) & 1u ? x : NEG_INF;
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
    // p (selected to 0 under the mask), PV's A operand as bf16 hi + lo
    float pw[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * c + (e & 1);
        const float pr = (rows >> key) & 1u
            ? __expf(s[n][e] - m_run[e >> 1]) : 0.f;
        l_run[e >> 1] += pr;
        pw[n][e] = pr;
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
  if (S > 1) merge_splits<G, HD>(p, bh, BHkv, S, smem);
}

// Whether an instantiation runs on the tensor cores (bf16 pools at G >=
// kTcMinG) or on the CUDA-core lanes.
template <typename T, int G>
constexpr bool on_tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value && G >= kTcMinG;
}

// Allow the tensor-core kernel its dynamic shared memory and the largest
// shared-memory carveout (so two CTAs fit an SM), once per device.
template <int HD, int G>
cudaError_t prepare_tc() {
  static std::atomic<uint64_t> done{0};   // a bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_decode_kernel_tc<HD, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tc<HD, G>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(paged_decode_kernel_tc<HD, G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int HD, int G>
cudaError_t launch(const Params& prm, int B, int splits, cudaStream_t stream) {
  // the splits of one (b, h) are neighbours in launch order, so the block
  // scheduler spreads a long sequence's splits over different SMs (with
  // b fastest, a 132-SM round robin stacks one sequence's CTAs on a few)
  const dim3 grid(splits, prm.Hkv, B);
  if constexpr (on_tensor_cores<T, G>()) {
    const cudaError_t err = prepare_tc<HD, G>();
    if (err != cudaSuccess) return err;
    paged_decode_kernel_tc<HD, G><<<grid, kThreads, Tc<HD, G>::SMEM,
                                    stream>>>(prm);
  } else {
    paged_decode_kernel<T, HD, G><<<grid, kThreads, 0, stream>>>(prm);
  }
  return cudaGetLastError();
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
int entry(const void* q, const void* k_pool, const void* v_pool,
          const void* k_scale, const void* v_scale, const void* block_tables,
          const void* block_positions, const void* cache_len, void* o,
          void* l, void* m, void* workspace, void* tickets, int B, int Hkv,
          int G, int head_dim, int num_blocks, int block_size, int nb,
          int splits, int sliding_window, int attention_sinks,
          float logit_softcap, void* stream) {
  // the split plan the kernel can hold: S in [1, max_splits(G)], no split
  // longer than kMaxSlots slots, S <= nb unless the table is empty; a
  // workspace and tickets when S > 1
  const int max_part = nb > 0 ? (nb + splits - 1) / splits : 0;
  if (B > 65535 || Hkv > 65535 ||       // grid.z and grid.y
      splits < 1 || splits > max_splits(G) || (nb > 0 && splits > nb) ||
      (nb == 0 && splits != 1) || max_part > kMaxSlots || block_size < 1 ||
      block_size > kMaxBlockSize ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                   static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale),
                   static_cast<const int32_t*>(block_tables),
                   static_cast<const int32_t*>(block_positions),
                   static_cast<const int32_t*>(cache_len),
                   static_cast<__nv_bfloat16*>(o), static_cast<float*>(l),
                   static_cast<float*>(m), static_cast<float*>(workspace),
                   static_cast<int*>(tickets), Hkv, num_blocks, block_size,
                   nb, sliding_window, attention_sinks, logit_softcap,
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

// Plain C entry points (bound with ctypes). Both launch one kernel on
// `stream` and return cudaGetLastError() as an int (0 = launched);
// cudaErrorInvalidValue for a head_dim / group size the kernel is not
// instantiated for, or a split plan it cannot hold. `splits` is S of the
// grid (B, Hkv, S); with S > 1, `workspace` holds B·Hkv·S·G·(head_dim + 2)
// fp32 and `tickets` B·Hkv int32 that are 0 (the kernel leaves them 0).
// The bf16 entry ignores k_scale / v_scale; the int8 entry needs both.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* block_tables, const void* block_positions,
    const void* cache_len, void* o, void* l, void* m, void* workspace,
    void* tickets, int B, int Hkv, int G, int head_dim, int num_blocks,
    int block_size, int nb, int splits, int sliding_window,
    int attention_sinks, float logit_softcap, void* stream) {
  return repro_torch::entry<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, block_tables, block_positions,
      cache_len, o, l, m, workspace, tickets, B, Hkv, G, head_dim,
      num_blocks, block_size, nb, splits, sliding_window, attention_sinks,
      logit_softcap, stream);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* block_tables, const void* block_positions,
    const void* cache_len, void* o, void* l, void* m, void* workspace,
    void* tickets, int B, int Hkv, int G, int head_dim, int num_blocks,
    int block_size, int nb, int splits, int sliding_window,
    int attention_sinks, float logit_softcap, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro_torch::entry<int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, block_positions,
      cache_len, o, l, m, workspace, tickets, B, Hkv, G, head_dim,
      num_blocks, block_size, nb, splits, sliding_window, attention_sinks,
      logit_softcap, stream);
}
