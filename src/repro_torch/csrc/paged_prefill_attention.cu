// Paged-context chunk-prefill GQA attention, over a bf16 pool or an int8
// pool with fp32 per-token scales, on Hopper's tensor cores (wgmma).
//
// Replaces the TPU kernel repro/kernels/paged_prefill_attention.py
// `_paged_prefill_chunk_kernel` (:54, bf16 pools; wrapper
// `paged_prefill_chunk_attention`, pallas_call at :294) with the entry
// point `paged_prefill_chunk_attention_bf16`, and its int8-pool variant
// `_paged_prefill_chunk_kernel_int8` (:128) with
// `paged_prefill_chunk_attention_int8`. Same contract: one chunk's queries
// q (C, H, hd) sit at global positions [P, P+C), P = nb·bs; they attend
// over the sequence's first nb pool blocks (block_table (nb,) into the
// head-major pools (Hkv, num_blocks, bs, hd)) and then over the chunk's own
// k/v (C, Hkv, hd), under per-row causal / sliding-window / sink masks and
// the optional logit softcap. For int8 pools the fp32 per-token k scale
// multiplies the scores before the softcap and the v scale multiplies p
// before the PV product (l sums the unscaled p); the chunk's own K/V have
// scale 1.0. Writes out (C, H, hd) in q's dtype. No dequantized or
// gathered slab reaches device memory.
//
// What bounds it on an H100: a 512-token chunk over a 1.5k-token prefix
// (llama3-8b, H=32, Hkv=8, hd=128) does 4·hd operations per (query head,
// key) pair the causal mask keeps, 1.5e10 in all, on ~17 MB of q, K, V and
// out: ~900 per byte, above the bf16 ridge of ~295, so it is bound by
// operations (0.0152 ms at 989 TFLOP/s). Only the bf16 tensor cores reach
// that; fp32 FMAs alone would take 0.22 ms.
//
// What this design does about it:
//  * both products run on the bf16 tensor cores with fp32 accumulation:
//    S = Q·Kᵀ as wgmma m64n64k16 with Q as register A fragments (read once)
//    and K from shared memory; O += P·V as wgmma m64n{hd}k16 with P in
//    registers (the S accumulator's layout is the A fragment's) and V read
//    MN-major ([key][hd]). P goes in as two bf16 terms, hi = bf16(p) and
//    lo = bf16(p - hi): one term alone rounds each weight by up to 2^-9,
//    which on short rows exceeds the rtol 8e-3 / atol 1e-3 the plain twin
//    is held to. 1/√hd scales the fp32 scores (or rides on the exponent's
//    multiply), as the TPU kernel scales q in fp32.
//  * a CTA is 3 warpgroups: two consumers, each owning 64 packed query
//    rows of one kv head (G heads × 64/G positions, g-major, so every K/V
//    tile serves all G heads), and a producer whose one thread keeps a
//    4-stage ring of 64-key K/V tiles filled by TMA, on full/empty
//    mbarriers. 128 CTAs at the main shape, one per SM, launched
//    longest-first since causal work grows with the position.
//  * TMA boxes of up to 64 rows (the largest power of two dividing the
//    block size, so any block size works; a box of fewer than 8 rows lands
//    inside a swizzle atom, which the unit swizzles by shared address) and
//    64 columns land in the 128-byte-swizzled layout the wgmma descriptors
//    name: the prefix one pool block at a time through the block table,
//    the chunk's own K/V through a (C, Hkv, hd) map whose rows past C the
//    TMA unit zero-fills. No row that is not a key of this sequence is ever
//    read: a tensor-core PV would turn 0 × NaN into NaN.
//  * int8 pools: the prefix rows arrive by TMA into a staging area, and a
//    second producer warp loads their k and v scales beside them; the
//    rows are converted to bf16 in the K and V tiles (exact: |x| <= 127,
//    by integer byte moves and one bf16 subtraction per pair), a quarter
//    (hd 128; half at hd 64) by the producer's last two warps as the rows
//    land and the rest by the consumers one tile ahead, while the tensor
//    cores run the current tile's PV.
//  * hd = 112 (7 × 16, the K-steps of QKᵀ) runs the tiles and PV at 128:
//    the tensor maps describe rows of 112, so TMA fills columns 112-127 of
//    each bf16 box's second panel with zeros; QKᵀ takes 7 K-steps (no pad
//    column is read), PV's N is 128 and only columns < 112 are written.
//    An int8 prefix row of 112 bytes converts into columns < 112; the pad
//    columns of V then hold whatever the stage held, which reaches only
//    the unwritten O columns (a product never mixes columns). Int8 boxes
//    of fewer than 8 rows start on 128 bytes each (I8Rows).
//  * the PV of tile i runs on while the warpgroup waits for tile i + 1 and
//    issues its QKᵀ; one wait covers both.
//  * masks select, never multiply, and only where needed: a tile inside
//    every row's causal and window range runs unmasked; tiles outside
//    every window that hold no sink are skipped (CTA-uniform), and the
//    walk stops at the CTA's last query position (a warpgroup whose rows
//    all precede a tile skips it).
//  * fp32 online softmax per row in registers, the row max reduced over
//    the 4 lanes that share a row of the accumulator, the row sum once at
//    the end; O is rescaled only where a row max moved.
//
// History: the first design computed both products as fp32 FMAs on the
// CUDA cores over 32-key tiles loaded synchronously; at the main shape it
// took 0.81–0.92 ms (bf16) and 0.82–0.87 ms (int8) on an H100 80GB HBM3
// at 700 W, 7.5–11× slower than SDPA (PERF.md §6).

#include <cuda.h>   // CUtensorMap and its enums only: the encoder is looked
                    // up at run time, so nothing links libcuda

#include <atomic>
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kConsumers = 2;   // consumer warpgroups per CTA
constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer
constexpr int BW = 64;          // query rows per warpgroup, g-major:
                                // row = g·(BW/G) + t
constexpr int BK = 64;          // keys per tile
constexpr int kStages = 4;      // K/V ring depth
constexpr int kPanel = BK * 128;   // one 64-column panel of a 64-row tile

// The width the tiles and the PV product run at: hd rounded up to whole
// 64-column panels (hd = 112 runs at 128; TMA fills columns 112-127 of
// every bf16 box with zeros, and only columns < hd are ever written out).
__host__ __device__ constexpr int padded_hd(int hd) {
  return (hd + 63) / 64 * 64;
}

// Shared memory, per stage of the ring: a K tile and a V tile (HDP/64
// panels of 64 key rows × 128 B, 128B-swizzled) and, for int8 pools, the
// tile's int8 prefix rows (K then V, boxes placed by I8Rows) as they
// arrive and its k and v scale vectors (fp32, one per key). Every stage
// is 1024-aligned.
template <int HD, bool kQuant>
struct Smem {
  static constexpr int HDP = padded_hd(HD);
  static constexpr int kTile = HDP * 128;         // 64 rows × HDP bf16
  static constexpr int kV = kTile;                // offsets within a stage
  static constexpr int kI8 = 2 * kTile;           // int8 rows: K, then V
  // bytes of staging a row at most (I8Rows): V's rows start BK of them
  // after K's
  static constexpr int kI8Pitch = HD < 128 ? 128 : HD;
  static constexpr int kKs = kI8 + (kQuant ? 2 * BK * kI8Pitch : 0);
  static constexpr int kVs = kKs + BK * 4;
  static constexpr int kStage = kQuant ? (kVs + BK * 4 + 1023) / 1024 * 1024
                                       : kKs;
  // mbarriers: full[], empty[], raw[] (int8 pools)
  static constexpr int kBar = kStages * kStage;
  // + 1024 to align the dynamic base to the swizzle atom
  static constexpr int kBytes = kBar + 3 * kStages * 8 + 1024;
};

// Rows per TMA box: the largest power of two dividing the block size, at
// most a key tile, so that no box straddles a pool block or a key tile.
__host__ __device__ __forceinline__ int box_rows(int bs) {
  return (bs & -bs) < BK ? (bs & -bs) : BK;
}

// Where int8 prefix row r of a key tile lands in the staging area: TMA
// writes a box of boxr rows hd bytes apart, and every box must start on
// 128 bytes, so box j starts at j·stride with stride = boxr·hd rounded up
// to 128 (hd = 64 or 128: rows stay evenly spaced; hd = 112 with fewer
// than 8 rows a box: a gap after each box). At most kI8Pitch bytes a row.
struct I8Rows {
  int shift;    // log2(boxr)
  int mask;     // boxr - 1
  int stride;   // bytes from one box to the next
  int hd;
  __device__ __forceinline__ I8Rows(int hd_, int boxr)
      : shift(0), mask(boxr - 1), stride((boxr * hd_ + 127) / 128 * 128),
        hd(hd_) {
    while ((1 << shift) < boxr) ++shift;     // boxr is a power of two
  }
  __device__ __forceinline__ int operator()(int r) const {
    return (r >> shift) * stride + (r & mask) * hd;
  }
};

// Byte offset of 16-byte chunk c (8 bf16 along hd) of row r in a tile of
// 64-column panels with the 128-byte swizzle (chunk index ^= row % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * kPanel + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Make this thread's generic-proxy shared-memory writes (the int8
// conversion) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor for a 128B-swizzled tile: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// mbarriers in shared memory: init (one thread), arrive, and wait until
// the phase of the given parity has completed.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// TMA tile loads (one thread), completing on an mbarrier with their bytes.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar) : "memory");
}

// D (64 × N fp32, the warpgroup's accumulators) += A (64 × 16 bf16, this
// thread's four registers of the A fragment) · B (16 × N bf16, a shared-
// memory descriptor; TB = 1: B is MN-major, e.g. V read as [key][hd]).
#define WG_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128, "wgmma_rs takes N = 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
  } else {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
  }
}
#undef WG_D8

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (what __expf uses after its multiply).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two probabilities as the sum of two bf16 pairs: hi = bf16(p) and
// lo = bf16(p - hi), so the tensor-core PV sees p to 16 significant bits.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                          uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Pool row of prefix key kp (< P) for kv head kvh, through the table.
__device__ __forceinline__ int pool_row(const int32_t* __restrict__ bt,
                                        int kvh, int num_blocks, int bs,
                                        int kp) {
  return (kvh * num_blocks + __ldg(bt + kp / bs)) * bs + kp % bs;
}

// One thread issues the TMA loads of the key tile starting at k0 into the
// stage at shared address `st`, completing on `bar`: boxes of `boxr` rows
// (boxr divides the block size), the prefix through the block table
// (int8 pools: as int8 rows into the staging area, placed by `i8`),
// then the chunk's own keys; a box past row C of the chunk is zero-filled
// by the TMA unit.
template <int HD, bool kQuant>
__device__ __forceinline__ void issue_tile(
    uint32_t st, int k0, const CUtensorMap* k_pool, const CUtensorMap* v_pool,
    const CUtensorMap* k_chunk, const CUtensorMap* v_chunk,
    const int32_t* __restrict__ bt, int kvh, int num_blocks, int bs,
    int boxr, const I8Rows& i8, int P, uint32_t bar) {
  using S = Smem<HD, kQuant>;
  for (int r0 = 0; r0 < BK; r0 += boxr) {
    const int kp = k0 + r0;
    if (kp < P) {
      const int row = pool_row(bt, kvh, num_blocks, bs, kp);
      if constexpr (kQuant) {
        tma_2d(st + S::kI8 + i8(r0), k_pool, 0, row, bar);
        tma_2d(st + S::kI8 + BK * S::kI8Pitch + i8(r0), v_pool, 0, row,
               bar);
      } else {
#pragma unroll
        for (int c = 0; c < S::HDP / 64; ++c) {
          tma_2d(st + c * kPanel + r0 * 128, k_pool, c * 64, row, bar);
          tma_2d(st + S::kV + c * kPanel + r0 * 128, v_pool, c * 64, row,
                 bar);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < S::HDP / 64; ++c) {
        tma_3d(st + c * kPanel + r0 * 128, k_chunk, c * 64, kvh, kp - P, bar);
        tma_3d(st + S::kV + c * kPanel + r0 * 128, v_chunk, c * 64, kvh,
               kp - P, bar);
      }
    }
  }
}

// One warp writes the k and v scales of the key tile starting at k0, one
// fp32 per key: the prefix keys' from the scale pools through the block
// table, k's times `scale` (1/√hd, so the scores need one multiply); the
// chunk's keys and the keys past it get `scale` and 1.0.
__device__ __forceinline__ void load_scales(
    float* ks, float* vs, int k0, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ bt,
    int kvh, int num_blocks, int bs, int P, float scale, int lane) {
#pragma unroll
  for (int r = lane; r < BK; r += 32) {
    const int kp = k0 + r;
    float a = scale, b = 1.f;
    if (kp < P) {
      const int row = pool_row(bt, kvh, num_blocks, bs, kp);
      a = __ldg(k_scale + row) * scale;
      b = __ldg(v_scale + row);
    }
    ks[r] = a;
    vs[r] = b;
  }
}

// Two of a word's four int8 values (the bytes `sel` picks from lo7 = w &
// 0x7F7F7F7F and sign = w & 0x80808080) as an exact bf16 pair, with no
// conversion instruction: m = 0x4300 | (b & 0x7F) is the bf16 128 +
// (b & 0x7F) and s = 0x4300 | (b & 0x80) is 128, or 256 for a negative
// byte, so m - s is b as a signed int8.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t lo7,
                                                     uint32_t sign,
                                                     uint32_t sel) {
  const uint32_t m = __byte_perm(lo7, 0x43434343u, sel);
  const uint32_t s = __byte_perm(sign, 0x43434343u, sel);
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                             *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Int8 conversion work per tile, in 16-byte chunks (16 values) of its K
// rows, then V rows: the producer warpgroup's last two warps take the last
// 256 (a quarter at hd 128, half at hd 64; 384 of 896 at hd 112, so the
// consumers' share is whole rounds) as the rows land, off the consumers'
// critical path; the consumer warpgroups take the rest one tile ahead. A
// larger producer share was no faster (64 threads, few registers).
template <int HD>
struct Convert {
  static constexpr int kChunks = 2 * BK * HD / 16;
  static constexpr int kProd = 256 + kChunks % 256;
  static constexpr int kCons = kChunks - kProd;
  static_assert(kCons > 0 && kCons % 256 == 0, "whole consumer rounds");
};
constexpr int kConverters = 128 * kConsumers;   // consumer threads
constexpr int kProdConverters = 64;             // producer warps 2 and 3

// Convert chunks [kFirst, kFirst + kCount) of the int8 prefix rows staged
// in a stage to bf16 in its K and V tiles, swizzled: thread ct of kN takes
// chunks kFirst + ct + j·kN. Exact: |x| <= 127 fits bf16's significand.
template <int HD, int kFirst, int kCount, int kN>
__device__ __forceinline__ void convert_int8(uint8_t* stage, int k0, int P,
                                             const I8Rows& i8, int ct) {
  constexpr int NC8 = HD / 16;
  using S = Smem<HD, true>;
  const int n_pre = min(max(P - k0, 0), BK);
#pragma unroll
  for (int j = 0; j < kCount / kN; ++j) {
    const int idx = kFirst + ct + j * kN;
    const int kv = idx / (BK * NC8);
    const int r = idx % (BK * NC8) / NC8;
    const int c = idx % NC8;
    if (r >= n_pre) continue;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        stage + S::kI8 + kv * BK * S::kI8Pitch + i8(r) + c * 16);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo7 = w[i] & 0x7F7F7F7Fu;
      const uint32_t sign = w[i] & 0x80808080u;
      b[2 * i] = int8x2_to_bf16x2(lo7, sign, 0x7170u);       // bytes 0, 1
      b[2 * i + 1] = int8x2_to_bf16x2(lo7, sign, 0x7372u);   // bytes 2, 3
    }
    uint8_t* tile = stage + kv * S::kV;
    *reinterpret_cast<uint4*>(tile + swz(r, 2 * c)) =
        make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(tile + swz(r, 2 * c + 1)) =
        make_uint4(b[4], b[5], b[6], b[7]);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
paged_prefill_chunk_kernel(const __grid_constant__ CUtensorMap k_pool,
                           const __grid_constant__ CUtensorMap v_pool,
                           const __grid_constant__ CUtensorMap k_chunk,
                           const __grid_constant__ CUtensorMap v_chunk,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const __nv_bfloat16* __restrict__ q,
                           const int32_t* __restrict__ block_table,
                           __nv_bfloat16* __restrict__ out,
                           int C, int H, int Hkv, int G, int num_blocks,
                           int bs, int nb, int sliding_window, int sinks,
                           float softcap, float scale, int row_tiles) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  using S = Smem<HD, kQuant>;
  constexpr int HDP = S::HDP;           // the PV product's width
  constexpr int NO = HDP / 2;           // O accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle-atom aligned
  uint8_t* gbase = smem_raw + (base - raw);

  // A CTA takes BT = kConsumers·BW/G positions of one kv head; consumer
  // warpgroup w owns positions [t0 + w·BTW, t0 + (w+1)·BTW) of all G heads.
  const int BTW = BW / G;
  const int BT = kConsumers * BTW;
  const int t0 = (row_tiles - 1 - static_cast<int>(blockIdx.x) / Hkv) * BT;
  const int kvh = blockIdx.x % Hkv;     // longest row tiles launch first
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int P = nb * bs;
  const int boxr = box_rows(bs);
  const I8Rows i8(HD, boxr);

  // Key tiles walked: the causal stop at the CTA's last position; with a
  // window, the tiles holding sinks, then from the first tile inside some
  // row's window (tiles in between are outside every window: skipped).
  const int key_end = P + min(t0 + BT, C);
  const int n_tiles = (key_end + BK - 1) / BK;
  int j_min = 0, ns = 0;
  if (sliding_window > 0) {
    const int win_first = P + t0 - sliding_window;   // keys <= this: outside
    if (win_first >= BK - 1) j_min = min((win_first - (BK - 1)) / BK + 1,
                                         n_tiles);
    if (sinks > 0) ns = min((sinks + BK - 1) / BK, j_min);
  }
  const int n_iter = ns + n_tiles - j_min;
  auto tile_k0 = [&](int i) { return (i < ns ? i : j_min + i - ns) * BK; };
  auto stage = [&](int i) { return base + (i % kStages) * S::kStage; };
  // full[s]: the stage's tile is in shared memory as bf16 (bf16 pools:
  // the TMA bytes landed; int8 pools: all its converters are done);
  // empty[s]: the 4·kConsumers consumer warps are done reading it;
  // raw[s]: an int8 tile's TMA bytes landed and its scales were written
  auto full = [&](int i) { return base + S::kBar + (i % kStages) * 8; };
  auto empty = [&](int i) { return full(i) + kStages * 8; };
  auto raw_bar = [&](int i) { return full(i) + 2 * kStages * 8; };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), !kQuant ? 1
                         : kConverters + kProdConverters);
      mbar_init(empty(i), 4 * kConsumers);
      mbar_init(raw_bar(i), 1 + 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues the TMA loads and keeps
    // the ring full; for int8 pools its second warp writes the scales and
    // its last two convert their share of each tile as it lands ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pt = tid - 128 * kConsumers;
    if (pt == 0) {
      for (int i = 0; i < n_iter; ++i) {
        if (i >= kStages)                 // stage released by tile i - S
          mbar_wait(empty(i), ((i / kStages) + 1) & 1);
        const int k0 = tile_k0(i);
        const int n_pre = min(max(P - k0, 0), BK);
        // bf16: the K and V tiles; int8: the prefix rows as int8, the
        // chunk's rows as bf16
        mbar_expect_tx(kQuant ? raw_bar(i) : full(i),
                       kQuant ? 2 * (n_pre * HD + (BK - n_pre) * HDP * 2)
                              : 2 * S::kTile);
        issue_tile<HD, kQuant>(stage(i), k0, &k_pool, &v_pool, &k_chunk,
                               &v_chunk, block_table, kvh, num_blocks, bs,
                               boxr, i8, P,
                               kQuant ? raw_bar(i) : full(i));
      }
    } else if (kQuant && pt >= 32 && pt < 64) {
      for (int i = 0; i < n_iter; ++i) {
        if (i >= kStages)
          mbar_wait(empty(i), ((i / kStages) + 1) & 1);
        uint8_t* st = gbase + (stage(i) - base);
        load_scales(reinterpret_cast<float*>(st + S::kKs),
                    reinterpret_cast<float*>(st + S::kVs), tile_k0(i),
                    k_scale, v_scale, block_table, kvh, num_blocks, bs, P,
                    scale, pt - 32);
        mbar_arrive(raw_bar(i));          // releases this lane's writes
      }
    } else if (kQuant && pt >= 64) {
      for (int i = 0; i < n_iter; ++i) {
        mbar_wait(raw_bar(i), (i / kStages) & 1);
        convert_int8<HD, Convert<HD>::kCons, Convert<HD>::kProd,
                     kProdConverters>(gbase + (stage(i) - base), tile_k0(i),
                                      P, i8, pt - 64);
        fence_proxy_async();
        mbar_arrive(full(i));
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  // the registers the producer gave back: 2·128·224 + 128·56 = 384·168
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  // this warpgroup's positions, and this thread's two accumulator rows
  const int tw_first = t0 + wg * BTW;
  const int tw_last = min(tw_first + BTW, C) - 1;   // < tw_first: no rows
  const int r0 = (tid >> 5 & 3) * 16 + (lane >> 2);
  int pos_q[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = tw_first + (r0 + 8 * h) % BTW;
    row_ok[h] = t < C;
    pos_q[h] = P + t;
  }
  // Q (bf16, unscaled) as the QKᵀ wgmma's A fragments, read once: k-step
  // kk holds columns 16·kk + (lane & 3)·2 (+1, +8, +9) of rows r0, r0 + 8
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const __nv_bfloat16* row =
        q + (static_cast<size_t>(row_ok[h] ? pos_q[h] - P : 0) * H +
             kvh * G + r / BTW) * HD + (lane & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][h] = row_ok[h] ? __ldg(reinterpret_cast<const uint32_t*>(
                                  row + kk * 16)) : 0u;
      qa[kk][h + 2] = row_ok[h] ? __ldg(reinterpret_cast<const uint32_t*>(
                                      row + kk * 16 + 8)) : 0u;
    }
  }
  // m is kept in the units the scores are in when they are exponentiated
  const float ex2_scale = kQuant || softcap > 0.f ? kLog2e : scale * kLog2e;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};             // this thread's columns only
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  // PV of tile `pending` may still run while the next tile's QKᵀ is
  // issued; its stage is released once a wgmma wait has covered it
  int pending = -1;
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty(i));
  };
  // int8 pools: the consumers convert their share of tile i + 1 while the
  // tensor cores run tile i's PV (tile 0 before the loop); full[] counts
  // their arrivals and those of the producer's two converter warps
  auto convert = [&](int i) {
    if constexpr (kQuant) {
      if (i >= n_iter) return;
      mbar_wait(raw_bar(i), (i / kStages) & 1);
      convert_int8<HD, 0, Convert<HD>::kCons, kConverters>(
          gbase + (stage(i) - base), tile_k0(i), P, i8, tid);
      fence_proxy_async();
      mbar_arrive(full(i));
    }
  };
  convert(0);
  for (int i = 0; i < n_iter; ++i) {
    const int k0 = tile_k0(i);
    const uint32_t st = stage(i);
    mbar_wait(full(i), (i / kStages) & 1);
    // a warpgroup whose rows all precede the tile skips it (uniform)
    if (k0 > P + tw_last) {
      convert(i + 1);
      if (pending >= 0) {
        wgmma_wait_all();
        release(pending);
        pending = -1;
      }
      release(i);
      continue;
    }
    // S = Q·Kᵀ on the tensor cores (K K-major from shared memory), fp32
    // accumulators
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_rs<64, 0>(
          s, qa[kk], desc(st + (kk >> 2) * kPanel + (kk & 3) * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();                 // QKᵀ of tile i and PV of i - 1
    fence_regs(s);
    fence_regs(o);
    if (pending >= 0) release(pending);

    // accumulator element j: row r0 + 8·((j >> 1) & 1), key column
    // (j >> 2)·8 + (lane & 3)·2 + (j & 1); for int8 pools its k and v
    // scales are the float2 of the pair's first column
    const uint8_t* scales = gbase + (st - base);
    auto scale2 = [&](int n8, int which) {
      return *reinterpret_cast<const float2*>(
          scales + (which ? S::kVs : S::kKs) +
          (n8 * 8 + (lane & 3) * 2) * 4);
    };
    // a tile inside every row's causal and window range needs no mask
    const bool full =
        k0 + BK - 1 <= P + tw_first &&
        (sliding_window <= 0 || k0 > P + tw_last - sliding_window);
    // scores in the exponent's units: with int8 pools or a softcap the
    // scores are scaled here (int8: by the k scale times 1/√hd, the fused
    // k dequant); else 1/√hd rides on the exponent's multiply (ex2_scale)
    if constexpr (kQuant) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float2 k2 = scale2(n8, 0);
        s[n8 * 4] *= k2.x;
        s[n8 * 4 + 1] *= k2.y;
        s[n8 * 4 + 2] *= k2.x;
        s[n8 * 4 + 3] *= k2.y;
      }
    } else if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= scale;
    }
    if (softcap > 0.f) {
      const float inv_cap = 1.f / softcap;
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = softcap * tanhf(s[j] * inv_cap);
    }
    if (!full) {                      // select, never multiply
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j >> 1) & 1;
        const int kp = k0 + (j >> 2) * 8 + (lane & 3) * 2 + (j & 1);
        bool v = row_ok[h] && kp <= pos_q[h];
        if (sliding_window > 0)
          v = v && (kp > pos_q[h] - sliding_window || kp < sinks);
        s[j] = v ? s[j] : NEG_INF;
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
        mx = fmaxf(mx, fmaxf(s[n8 * 4 + h * 2], s[n8 * 4 + h * 2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // a row with no key yet keeps m = NEG_INF: subtracting 0 instead
      // sends its masked scores (and alpha) to exp(-1e30) = 0
      const float ml = (m_new == NEG_INF ? 0.f : m_new) * ex2_scale;
      alpha[h] = ex2(fmaf(m[h], ex2_scale, -ml));
      float psum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n8 * 4 + h * 2 + e;
          s[j] = ex2(fmaf(s[j], ex2_scale, -ml));
          psum += s[j];
        }
      }
      l[h] = l[h] * alpha[h] + psum;
      m[h] = m_new;
    }
    if constexpr (kQuant) {             // fused v dequant (l sums p)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float2 v2 = scale2(n8, 1);
        s[n8 * 4] *= v2.x;
        s[n8 * 4 + 1] *= v2.y;
        s[n8 * 4 + 2] *= v2.x;
        s[n8 * 4 + 3] *= v2.y;
      }
    }
    // rescale O only where a row max moved (alpha == 1 exactly otherwise);
    // the vote keeps the branch warp-uniform
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
    }

    // O += P·V: P from registers as hi + lo bf16 terms, V MN-major
    // from shared memory
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        split_bf16(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1], hi[a], lo[a]);
      const uint64_t dv = desc(st + S::kV + kk * 16 * 128, kPanel, 1024);
      wgmma_rs<HDP, 1>(o, hi, dv);
      wgmma_rs<HDP, 1>(o, lo, dv);
    }
    wgmma_commit();                   // runs on into the next tile
    pending = i;
    convert(i + 1);
  }
  wgmma_wait_all();
  fence_regs(o);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (!row_ok[h]) continue;
    const int r = r0 + 8 * h;
    const int t = tw_first + r % BTW;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst = out + (static_cast<size_t>(t) * H + kvh * G +
                                r / BTW) * HD + (lane & 3) * 2;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8)
      *reinterpret_cast<__nv_bfloat162*>(dst + n8 * 8) = __floats2bfloat162_rn(
          o[n8 * 4 + h * 2] * inv, o[n8 * 4 + h * 2 + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over `rank` dims (innermost first) with byte strides for
// dims 1.., a box, and the 128-byte swizzle or none; OOB reads are zeros.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
            const void* base, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, bool swizzle) {
  const EncodeTiled fn = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One call's grid: CTAs of kConsumers·BW/G positions of one kv head.
struct Grid {
  int positions;   // per CTA
  int row_tiles;   // per kv head
  int ctas;
};
Grid grid_for(int C, int H, int Hkv) {
  const int positions = kConsumers * BW / (H / Hkv);
  const int row_tiles = (C + positions - 1) / positions;
  return {positions, row_tiles, row_tiles * Hkv};
}

// Allow the kernel its dynamic shared memory, once per device.
template <int HD, typename T>
cudaError_t allow_smem(int smem) {
  static std::atomic<uint64_t> done{0};   // a bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_prefill_chunk_kernel<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_table, const void* k_chunk,
                   const void* v_chunk, void* out, int C, int H, int Hkv,
                   int num_blocks, int bs, int nb, int sliding_window,
                   int sinks, float softcap, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const Grid grid = grid_for(C, H, Hkv);
  if (grid.ctas == 0) return cudaSuccess;
  const int boxr = box_rows(bs);
  // pools as (Hkv·num_blocks·bs, hd) rows; the chunk's K/V as (C, Hkv, hd)
  CUtensorMap maps[4] = {};
  const cuuint64_t rows = static_cast<cuuint64_t>(Hkv) * num_blocks * bs;
  const cuuint64_t pool_dims[2] = {HD, rows};
  const cuuint64_t pool_stride[1] = {HD * sizeof(T)};
  const cuuint32_t pool_box[2] = {kQuant ? HD : 64,
                                  static_cast<cuuint32_t>(boxr)};
  const cuuint64_t chunk_dims[3] = {HD, static_cast<cuuint64_t>(Hkv),
                                    static_cast<cuuint64_t>(C)};
  const cuuint64_t chunk_stride[2] = {HD * 2, static_cast<cuuint64_t>(Hkv) *
                                                  HD * 2};
  const cuuint32_t chunk_box[3] = {64, 1, static_cast<cuuint32_t>(boxr)};
  const CUtensorMapDataType pool_type = kQuant
      ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(&maps[0], pool_type, 2, k_pool, pool_dims, pool_stride,
              pool_box, !kQuant) ||
      !encode(&maps[1], pool_type, 2, v_pool, pool_dims, pool_stride,
              pool_box, !kQuant) ||
      !encode(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k_chunk,
              chunk_dims, chunk_stride, chunk_box, true) ||
      !encode(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v_chunk,
              chunk_dims, chunk_stride, chunk_box, true))
    return cudaErrorInvalidValue;
  const int smem = Smem<HD, kQuant>::kBytes;
  const cudaError_t err = allow_smem<HD, T>(smem);
  if (err != cudaSuccess) return err;
  paged_prefill_chunk_kernel<HD, T><<<grid.ctas, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3],
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int32_t*>(block_table),
      static_cast<__nv_bfloat16*>(out), C, H, Hkv, H / Hkv, num_blocks, bs,
      nb, sliding_window, sinks, softcap,
      1.0f / sqrtf(static_cast<float>(HD)), grid.row_tiles);
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
  if (Hkv < 1 || H % Hkv || BW % (H / Hkv) || block_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, T>(q, k_pool, v_pool, k_scale, v_scale, block_table,
                           k_chunk, v_chunk, out, C, H, Hkv, num_blocks,
                           block_size, nb, sliding_window, attention_sinks,
                           logit_softcap, s);
    case 112:
      return launch<112, T>(q, k_pool, v_pool, k_scale, v_scale,
                            block_table, k_chunk, v_chunk, out, C, H, Hkv,
                            num_blocks, block_size, nb, sliding_window,
                            attention_sinks, logit_softcap, s);
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
// head_dim (64, 112 or 128) or group size (H / Hkv must divide 64) the
// kernel does not take. The bf16 entry ignores k_scale / v_scale; the int8 entry needs
// both.
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

// The launch of one call, for reports, from the code `launch` runs:
// threads and packed query rows per CTA, keys per tile, ring stages,
// dynamic shared memory (bytes) and CTAs, for a chunk of C queries, H / Hkv
// heads, head_dim and the pool type (int8 != 0). Returns
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_prefill_chunk_geometry(int C, int H, int Hkv,
                                            int head_dim, int int8,
                                            int* out6) {
  using namespace repro_torch;
  if (Hkv < 1 || H % Hkv || BW % (H / Hkv) ||
      (head_dim != 64 && head_dim != 112 && head_dim != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  out6[0] = kThreads;
  out6[1] = kConsumers * BW;
  out6[2] = BK;
  out6[3] = kStages;
  out6[4] = head_dim == 64
      ? (int8 ? Smem<64, true>::kBytes : Smem<64, false>::kBytes)
      : head_dim == 112
      ? (int8 ? Smem<112, true>::kBytes : Smem<112, false>::kBytes)
      : (int8 ? Smem<128, true>::kBytes : Smem<128, false>::kBytes);
  out6[5] = grid_for(C, H, Hkv).ctas;
  return 0;
}
