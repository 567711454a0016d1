// RWKV6 (Finch) recurrence, bf16 or fp32 inputs, fp32 state and output: a
// chunked scan whose products run on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py `_rwkv6_kernel`
// (wrapper `rwkv6_scan`, pallas_call at :62) with the entry points
// `rwkv6_scan_bf16` and `rwkv6_scan_f32`. Same contract: r, k, v, w
// (B, S, H, P) in the model dtype, u (H, P) fp32; writes y (B, S, H, P)
// fp32 with
//     y_t = r_t · S + (r_t · (u ⊙ k_t)) v_t ;   S <- diag(w_t) S + k_t ⊗ v_t
// and one (P, P) fp32 state per (batch, head) starting at zero. The TPU
// wrapper pads S to whole VMEM chunks with w = 1; this kernel masks the
// ragged last tile itself and reads or writes nothing past S. One launch
// per call.
//
// The chunked form. Per (batch, head) the sequence is cut into tiles of
// L = 16 steps starting at b; y_t reads the state before step t, so the
// decay between s < t is E(s, t) = Π_{s<m<t} w_m (a vector over the key
// channel p). With the reference point at the tile start,
//     y_t = r̃_t · S_b + Σ_{b≤s<t} G[t, s] v_s + (r_t·(u⊙k_t)) v_t
//     S_{b+16} = diag(T) S_b + Σ_s k̃_s ⊗ v_s
// where r̃_t = r_t ⊙ Π_{b≤m<t} w_m, k̃_s = k_s ⊙ Π_{s<m<b+16} w_m, T the
// tile's product of w, and G[t, s] = Σ_p r_t[p] k_s[p] E(s, t)[p] inside the
// tile. Every factor is a product of decays in [0, 1] taken in fp32 (no
// ratio, no exp of log differences): a decay of exactly 0 gives 0 and 1.0
// gives 1. The sequential chain is S/16 state updates instead of S steps.
//
// What bounds it on an H100: bytes. Each input is read once and y written
// once: 4·P elements in, P fp32 out per (batch, step, head), 805.3 MB at
// rwkv6's prefill (B=8, S=2048, H=64, P=64, bf16), 0.240 ms at 3.35 TB/s.
// The tensor-core products are 4·P² + 40·P flops per step and head (r̃·S,
// k̃ᵀv, G v, G's cross block), 19.9 GFLOP there (0.020 ms at the bf16
// peak); G's diagonal blocks take about 12·P fp32 flops per step and head
// on the CUDA cores. The three bf16 passes on mma.sync (half of Hopper's
// wgmma rate), the per-tile conversion and those CUDA-core blocks, not the
// bytes, are what the kernel spends most of its time on.
//
// What the design does about it:
//  * one CTA per (batch, head, slice of 16·W value columns q): the columns
//    of the state evolve independently, so a CTA of W warps owns 16·W of
//    them (W = 4 at P = 64: 512 CTAs of 128 threads at rwkv6's B=8, H=64);
//    narrower CTAs over more slices when B·H is small (pick_warps).
//  * each warp keeps Sᵀ for its 16 columns (16 x P fp32) in mma
//    accumulators for the whole sequence; split into bf16 hi + lo they are
//    the A operand of r̃·S directly (common.cuh), so the state never touches
//    memory.
//  * precision: r̃, k̃ and the state are fp32, so their products run three
//    bf16 passes (common.cuh `mma_bf16x3`, ~1e-5 of each product); v is
//    exact in bf16 for the bf16 entry, so its products take two.
//  * the tile's diagonal block G (16 x 16 over P channels; its decay is not
//    a rank-one factor) is split at b+8. Its cross block (t ≥ b+8 > s) is
//    r̂ k̂ᵀ with the reference point at b+8 (r̂_t = r_t ⊙ Π_{b+8≤m<t} w_m,
//    k̂_s = k_s ⊙ Π_{s<m<b+8} w_m), on the tensor cores, once per CTA by
//    one warp while the others start on r̃·S; the two 8 x 8 diagonal
//    blocks run on the CUDA cores in fp32: a group of lanes takes
//    rows a and 7-a of a block (7 steps between them, none idle) and walks
//    s = t-1 down to the block's start, multiplying its running
//    r_t ⊙ E(s, t) by w_s; the channel groups are summed with shuffles; the
//    u bonus is the diagonal. These run beside the r̃ / k̃ conversion, on
//    the other half of the CTA.
//  * r, k, v, w of tile i+2 are copied into shared memory with cp.async
//    (double-buffered) while tile i is computed; each tile is converted
//    once into hi / lo rows (r̃, k̃, v, G; padded by 16 bytes, so ldmatrix
//    has no bank conflict). Three barriers per tile. y is stored straight
//    from the accumulators (whole 32-byte sectors).

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int L = 16;     // steps per tile: one k-step of mma.m16n8k16

// two consecutive elements of shared memory as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// n (a multiple of 8) consecutive elements of shared memory as fp32
template <int n>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x;
    out[i + 1] = v.y;
    out[i + 2] = v.z;
    out[i + 3] = v.w;
  }
}

template <int n>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < n; i += 8)
    bf16x8_to_float(*reinterpret_cast<const uint4*>(p + i), out + i);
}

template <typename E, int P, int W>
struct RwkvSmem {
  static constexpr int QS = 16 * W;    // value columns q of the CTA
  // staging, double-buffered, as loaded (zero past S)
  E rs[2][L][P], ks[2][L][P], ws[2][L][P];
  E vs[2][L][QS];
  // one tile converted to bf16 hi / lo; rows padded by 8 elements
  __nv_bfloat16 rh[L][P + 8], rl[L][P + 8];     // r̃ [t][p]
  __nv_bfloat16 kh[L][P + 8], kl[L][P + 8];     // k̃ [s][p]
  __nv_bfloat16 vh[L][QS + 8], vl[L][QS + 8];   // v  [s][q]
  __nv_bfloat16 gh[L][L + 8], gl[L][L + 8];     // G  [t][s], 0 for s > t
  __nv_bfloat16 rch[L][P + 8], rcl[L][P + 8];   // r̂ [t][p], rows t < 8 zero
  __nv_bfloat16 kch[L / 2][P + 8], kcl[L / 2][P + 8];   // k̂ [s][p], s < 8
  float T[P];                                   // Π of the tile's w
  float u[P];
};

// The two 8 x 8 diagonal blocks of G (the cross block is r̂ k̂ᵀ, on the
// tensor cores): G[t, s] = Σ_p r_t[p] k_s[p] Π_{s<m<t} w_m[p] for s < t
// in t's block, the u bonus at s = t, by GT threads (rwkv_prepare's). A
// pair of rows (a, 7 - a) of a block takes LPT lanes, CPL channels a lane:
// the rows need a and 7 - a steps, so a pair walks 7 steps, each one live.
template <typename E, int P, int NT, typename Sm>
__device__ __forceinline__ void rwkv_diag_blocks(Sm& sm, int buf) {
  constexpr bool kSplitRoles = NT >= 2 * P;
  constexpr int GT = kSplitRoles ? P : NT;
  constexpr int LPT = GT / 8;
  constexpr int CPL = P / LPT;
  constexpr int J = L / 2;
  const int tid = threadIdx.x;
  const int gt = kSplitRoles ? tid - P : tid;
  const int pair = gt / LPT, cg = gt % LPT, pc = cg * CPL;
  const int a = pair & 3;
  const int ta = J * (pair >> 2) + a, tb = J * (pair >> 2) + J - 1 - a;
  auto lanes_sum = [](float x) {   // over the pair's LPT lanes
#pragma unroll
    for (int off = 1; off < LPT; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  };
  float rp[CPL], rb[CPL], kv[CPL], wv[CPL];
  load_f32<CPL>(&sm.rs[buf][ta][pc], rp);
  load_f32<CPL>(&sm.rs[buf][tb][pc], rb);
  float ba = 0.f, bb = 0.f;
  load_f32<CPL>(&sm.ks[buf][ta][pc], kv);
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    ba = fmaf(rp[i] * sm.u[pc + i], kv[i], ba);
  load_f32<CPL>(&sm.ks[buf][tb][pc], kv);
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    bb = fmaf(rb[i] * sm.u[pc + i], kv[i], bb);
  ba = lanes_sum(ba);
  bb = lanes_sum(bb);
  if (cg == 0) {
    store_split1(&sm.gh[ta][ta], &sm.gl[ta][ta], ba);
    store_split1(&sm.gh[tb][tb], &sm.gl[tb][tb], bb);
  }
#pragma unroll
  for (int i = 0; i < J - 1; ++i) {
    const bool on_a = i < a;       // row a first, then row 7 - a
    if (i == a) {
#pragma unroll
      for (int e = 0; e < CPL; ++e) rp[e] = rb[e];
    }
    const int t = on_a ? ta : tb;
    const int s = on_a ? ta - 1 - i : tb - 1 - (i - a);
    load_f32<CPL>(&sm.ks[buf][s][pc], kv);
    load_f32<CPL>(&sm.ws[buf][s][pc], wv);
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      acc = fmaf(rp[e], kv[e], acc);
      rp[e] *= wv[e];
    }
    acc = lanes_sum(acc);
    if (cg == 0) store_split1(&sm.gh[t][s], &sm.gl[t][s], acc);
  }
}

// One tile from the staging buffers into what the products read: r̃, k̃
// (and r̂, k̂, T) and v as hi / lo rows, and the two 8 x 8 diagonal blocks of
// G on the CUDA cores (its cross block is rwkv_cross). Shared by the forward
// and the backward kernel, whose shared memory has these members; with
// kScores false only k̃, T and v (the backward's first pass). With NT ≥ 2P
// threads the r̃ / k̃ jobs (threads [0, P)) and G's diagonal blocks
// (threads [P, 2P)) run side by side; else one after the other on every
// thread.
template <typename E, int P, int QS, int NT, bool kScores, typename Sm>
__device__ __forceinline__ void rwkv_prepare(Sm& sm, int buf, int nt) {
  constexpr bool kSplitRoles = NT >= 2 * P;
  const int tid = threadIdx.x;
  constexpr int J = L / 2;
  const float2 one = make_float2(1.f, 1.f);
  // r̃ and k̃ (and r̂, k̂, T), a job per (r or k, two channels): prod runs
  // from the tile's edge, half from its middle b + 8
  if (!kSplitRoles || tid < P) {
    for (int job = tid; job < P; job += kSplitRoles ? P : NT) {
      const int p = (job % (P / 2)) * 2;
      float2 prod = one, half = one;
      if (job < P / 2) {             // r̃_t = r_t Π_{b≤m<t} w_m; for
        if constexpr (kScores) {     // t ≥ b+8 r̂_t = r_t Π_{b+8≤m<t} w_m
#pragma unroll
          for (int t = 0; t < L; ++t) {
            if (t == J) half = one;
            const float2 rv = load2(&sm.rs[buf][t][p]);
            store_split2(&sm.rh[t][p], &sm.rl[t][p], rv.x * prod.x,
                         rv.y * prod.y);
            if (t >= J)
              store_split2(&sm.rch[t][p], &sm.rcl[t][p], rv.x * half.x,
                           rv.y * half.y);
            const float2 wv = t < nt ? load2(&sm.ws[buf][t][p]) : one;
            prod.x *= wv.x;
            prod.y *= wv.y;
            half.x *= wv.x;
            half.y *= wv.y;
          }
        }
      } else {                       // k̃_s = k_s Π_{s<m<b+16} w_m; for
#pragma unroll                       // s < b+8 k̂_s = k_s Π_{s<m<b+8} w_m
        for (int s = L - 1; s >= 0; --s) {
          if (s == J - 1) half = one;
          const float2 kv = load2(&sm.ks[buf][s][p]);
          store_split2(&sm.kh[s][p], &sm.kl[s][p], kv.x * prod.x,
                       kv.y * prod.y);
          if constexpr (kScores)
            if (s < J)
              store_split2(&sm.kch[s][p], &sm.kcl[s][p], kv.x * half.x,
                           kv.y * half.y);
          const float2 wv = s < nt ? load2(&sm.ws[buf][s][p]) : one;
          prod.x *= wv.x;
          prod.y *= wv.y;
          half.x *= wv.x;
          half.y *= wv.y;
        }
        sm.T[p] = prod.x;            // T = Π of the tile's w
        sm.T[p + 1] = prod.y;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < (L * QS / 4 + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (L * QS / 4 % NT == 0 || i < L * QS / 4) {
      const int s = i / (QS / 4), q4 = (i % (QS / 4)) * 4;
      const float2 v0 = load2(&sm.vs[buf][s][q4]);
      const float2 v1 = load2(&sm.vs[buf][s][q4 + 2]);
      store_split4(&sm.vh[s][q4], &sm.vl[s][q4], v0.x, v0.y, v1.x, v1.y);
    }
  }
  if constexpr (kScores)
    if (!kSplitRoles || tid >= P) rwkv_diag_blocks<E, P, NT>(sm, buf);
}

// G's cross block r̂ k̂ᵀ (M = t, N = s < 8, K = p; rows t ≥ 8) into shared
// memory as hi / lo, by one warp.
template <int P, typename Sm>
__device__ __forceinline__ void rwkv_cross(Sm& sm) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int mi = lane >> 3, r8 = lane & 7;
  float xa[2][4] = {};             // even and odd k-steps apart
#pragma unroll
  for (int kk = 0; kk < P / 16; kk += 2) {
    uint32_t bh4[4], bl4[4];
    const int br = r8, bc = 16 * (kk + (mi >> 1)) + (mi & 1) * 8;
    ldsm_x4(bh4, &sm.kch[br][bc]);
    ldsm_x4(bl4, &sm.kcl[br][bc]);
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      uint32_t ah[4], al[4];
      const int ar = (mi & 1) * 8 + r8;
      const int ac = 16 * (kk + k2) + (mi >> 1) * 8;
      ldsm_x4(ah, &sm.rch[ar][ac]);
      ldsm_x4(al, &sm.rcl[ar][ac]);
      const uint32_t bh2[2] = {bh4[2 * k2], bh4[2 * k2 + 1]};
      const uint32_t bl2[2] = {bl4[2 * k2], bl4[2 * k2 + 1]};
      mma_bf16x3<1>(&xa[k2], ah, al, bh2, bl2);
    }
  }
  store_split2(&sm.gh[L / 2 + g][c2], &sm.gl[L / 2 + g][c2],
               xa[0][2] + xa[1][2], xa[0][3] + xa[1][3]);
}

template <typename E, int P, int W>
__global__ void __launch_bounds__(32 * W, W == 1 ? 8 : 16 / W)
rwkv6_scan_kernel(const E* __restrict__ r, const E* __restrict__ k,
                  const E* __restrict__ v, const E* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ y, int S,
                  int H, int nslices) {
  using Sm = RwkvSmem<E, P, W>;
  constexpr int QS = Sm::QS, NT = 32 * W;
  constexpr int EPV = 16 / sizeof(E);  // elements per 16-byte copy
  constexpr bool kExactV = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int slice = blockIdx.x % nslices;
  const int bh = blockIdx.x / nslices;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = slice * QS;                     // first value column
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int mi = lane >> 3, r8 = lane & 7;       // ldmatrix matrix, row
  const int qw = 16 * warp;                      // warp's columns in the slice
  const size_t row0 = static_cast<size_t>(b) * S;
  const int ntiles = (S + L - 1) / L;

  // a thread's copies are the same in every tile: a 64-bit offset per tile,
  // then 32-bit offsets the compiler keeps out of the tile loop
  const int HP = H * P;
  auto load = [&](int c, int buf) {
    const int t0 = c * L;
    const int nt = min(L, S - t0);
    const size_t base = ((row0 + t0) * H + h) * P;
    constexpr int VPR = P / EPV, VV = QS / EPV;   // 16-byte copies per row
#pragma unroll
    for (int it = 0; it < (L * VPR + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * VPR % NT == 0 || i < L * VPR) {
        const int row = i / VPR, e = (i % VPR) * EPV;
        const bool ok = row < nt;
        const int off = row * HP + e;
        cp_async16_zfill(&sm.rs[buf][row][e], ok ? r + base + off : r, ok);
        cp_async16_zfill(&sm.ks[buf][row][e], ok ? k + base + off : k, ok);
        cp_async16_zfill(&sm.ws[buf][row][e], ok ? w + base + off : w, ok);
      }
    }
#pragma unroll
    for (int it = 0; it < (L * VV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * VV % NT == 0 || i < L * VV) {
        const int row = i / VV, e = (i % VV) * EPV;
        const bool ok = row < nt;
        cp_async16_zfill(&sm.vs[buf][row][e],
                         ok ? v + base + row * HP + q0 + e : v, ok);
      }
    }
  };

  // Sᵀ for the warp's 16 columns: rows qw + g (+8), key channels 8j + c2 (+1)
  float st[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;

  for (int i = tid; i < L * (L + 8); i += NT) {   // G above the diagonal
    (&sm.gh[0][0])[i] = __float2bfloat16_rn(0.f);
    (&sm.gl[0][0])[i] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < L / 2 * (P + 8); i += NT) {   // r̂ rows t < 8
    (&sm.rch[0][0])[i] = __float2bfloat16_rn(0.f);
    (&sm.rcl[0][0])[i] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < P; i += NT) sm.u[i] = u[h * P + i];
  load(0, 0);
  cp_async_commit();
  if (ntiles > 1) load(1, 1);
  cp_async_commit();
  for (int c = 0; c < ntiles; ++c) {
    const int buf = c & 1;
    cp_async_wait<1>();
    __syncthreads();                 // tile c staged; tile c-1 fully read
    rwkv_prepare<E, P, QS, NT, true>(sm, buf, min(L, S - c * L));
    __syncthreads();                 // tile c converted; staging[buf] free
    if (c + 2 < ntiles) load(c + 2, buf);
    cp_async_commit();

    // the cross block of G once per CTA by its last warp; the other warps
    // start on Sᵀ r̃ᵀ
    if (warp == W - 1) rwkv_cross<P>(sm);

    // yᵀ[q, t]: Sᵀ r̃ᵀ (M = q, K = p, N = t) ...
    float yk[2][2][4] = {};          // even and odd k-steps apart
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      uint32_t ah[4], al[4], bh4[4], bl4[4];
      split_bf16x2(st[2 * kk][0], st[2 * kk][1], ah[0], al[0]);
      split_bf16x2(st[2 * kk][2], st[2 * kk][3], ah[1], al[1]);
      split_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1], ah[2], al[2]);
      split_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3], ah[3], al[3]);
      const int br = (mi >> 1) * 8 + r8, bc = 16 * kk + (mi & 1) * 8;
      ldsm_x4(bh4, &sm.rh[br][bc]);
      ldsm_x4(bl4, &sm.rl[br][bc]);
      mma_bf16x3<2>(yk[kk & 1], ah, al, bh4, bl4);
    }
    float ya[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[j][e] = yk[0][j][e] + yk[1][j][e];
    __syncthreads();                 // G's cross block in shared memory
    // ... plus vᵀ Gᵀ (M = q, K = s, N = t)
    uint32_t vah[4], val[4] = {};
    {
      const int ar = (mi >> 1) * 8 + r8, ac = qw + (mi & 1) * 8;
      ldsm_x4_trans(vah, &sm.vh[ar][ac]);
      if (!kExactV) ldsm_x4_trans(val, &sm.vl[ar][ac]);
      uint32_t gb[4], gl4[4];
      const int br = (mi >> 1) * 8 + r8, bc = (mi & 1) * 8;
      ldsm_x4(gb, &sm.gh[br][bc]);
      ldsm_x4(gl4, &sm.gl[br][bc]);
      if (kExactV)
        mma_bf16x2<2>(ya, vah, gb, gl4);
      else
        mma_bf16x3<2>(ya, vah, val, gb, gl4);
    }
    const int t0 = c * L;
    const int nt = min(L, S - t0);
    float* yt = y + ((row0 + t0) * H + h) * P + q0 + qw + g;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * j + c2 + (e & 1);
        if (t < nt) yt[t * HP + 8 * (e >> 1)] = ya[j][e];
      }

    // Sᵀ <- Sᵀ diag(T) + vᵀ k̃ (M = q, K = s, N = p)
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const float w0 = sm.T[8 * j + c2], w1 = sm.T[8 * j + c2 + 1];
      st[j][0] *= w0;
      st[j][1] *= w1;
      st[j][2] *= w0;
      st[j][3] *= w1;
    }
#pragma unroll
    for (int nn = 0; nn < P / 16; ++nn) {
      uint32_t bh4[4], bl4[4];
      const int br = (mi & 1) * 8 + r8, bc = 16 * nn + (mi >> 1) * 8;
      ldsm_x4_trans(bh4, &sm.kh[br][bc]);
      ldsm_x4_trans(bl4, &sm.kl[br][bc]);
      if (kExactV)
        mma_bf16x2<2>(&st[2 * nn], vah, bh4, bl4);
      else
        mma_bf16x3<2>(&st[2 * nn], vah, val, bh4, bl4);
    }
  }
}

// Warps per CTA (16 value columns each): P / 16, then narrower while
// B·H·slices would leave fewer than two CTAs an SM.
int pick_warps(int BH, int P) {
  int w = P / 16;
  const long want = 2L * sm_count();
  while (w > 1 && static_cast<long>(BH) * (P / (16 * w)) < want) w /= 2;
  return w;
}

template <typename E, int P, int W>
cudaError_t launch(const E* r, const E* k, const E* v, const E* w,
                   const float* u, float* y, int B, int S, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(RwkvSmem<E, P, W>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<E, P, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nslices = P / (16 * W);
  rwkv6_scan_kernel<E, P, W><<<B * H * nslices, 32 * W, smem, stream>>>(
      r, k, v, w, u, y, S, H, nslices);
  return cudaGetLastError();
}

template <typename E>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, int B, int S, int H, int P,
             void* stream) {
  if (P != 32 && P != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* re = static_cast<const E*>(r);
  const auto* ke = static_cast<const E*>(k);
  const auto* ve = static_cast<const E*>(v);
  const auto* we = static_cast<const E*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* yf = static_cast<float*>(y);
  const int W = pick_warps(B * H, P);
  cudaError_t err;
  if (P == 32)
    err = W == 2 ? launch<E, 32, 2>(re, ke, ve, we, uf, yf, B, S, H, st)
                 : launch<E, 32, 1>(re, ke, ve, we, uf, yf, B, S, H, st);
  else
    err = W == 4 ? launch<E, 64, 4>(re, ke, ve, we, uf, yf, B, S, H, st)
        : W == 2 ? launch<E, 64, 2>(re, ke, ve, we, uf, yf, B, S, H, st)
                 : launch<E, 64, 1>(re, ke, ve, we, uf, yf, B, S, H, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace repro_torch

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched); cudaErrorInvalidValue
// for a head size P the kernel is not instantiated for.
extern "C" int rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* y, int B,
                               int S, int H, int P, void* stream) {
  return repro_torch::dispatch<__nv_bfloat16>(r, k, v, w, u, y, B, S, H, P,
                                              stream);
}

extern "C" int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, void* y, int B,
                              int S, int H, int P, void* stream) {
  return repro_torch::dispatch<float>(r, k, v, w, u, y, B, S, H, P, stream);
}

// ===========================================================================
// The backward: rwkv6_scan_bwd_bf16 / rwkv6_scan_bwd_f32
//
// Replaces no TPU kernel: the reference differentiates its lax.scan
// (repro/models/ssm.py, rwkv_time_mix_forward with use_pallas_kernels=False)
// and has no backward kernel. The port's forward is the kernel above, so its
// gradient is this second kernel, behind the autograd Function of
// kernels/rwkv6_scan.py. The forward reads the state before the update,
// y_t = r_t·S_{t-1} + (r_t·(u⊙k_t)) v_t, so with G_t = dL/dS_t (G_{S-1} = 0)
// and c_t = ⟨v_t, dy_t⟩, in fp32:
//     G_{t-1} = diag(w_t) G_t + r_t ⊗ dy_t
//     dr_t = S_{t-1} dy_t + u ⊙ k_t c_t ;  dk_t = G_t v_t + r_t ⊙ u c_t
//     dv_t = G_tᵀ k_t + (r_t·(u⊙k_t)) dy_t
//     dw_t = Σ_q G_t ⊙ S_{t-1} ;  du = Σ_{b,t} r_t ⊙ k_t c_t
//
// The chunked form, on the forward's tiles [b, e] of L = 16 steps. With
// S0 = S_{b-1}, Gc = G_e, E(s, t) = Π_{s<m<t} w_m (per key channel p),
// pre(t) = E(b-1, t), F(t) = E(t, e+1) (so r̃ = r ⊙ pre and k̃ = k ⊙ F are
// the forward's) and A[s, s'] = dy_s·v_{s'}:
//     dr_t = pre(t) ⊙ S0 dy_t + Σ_{s<t} A[t, s] E(s, t) ⊙ k_s + u⊙k_t c_t
//     dk_t = F(t) ⊙ Gc v_t + Σ_{s>t} A[s, t] E(t, s) ⊙ r_s + r_t⊙u c_t
//     dv_t = k̃_t Gc + Σ_{s≥t} G[s, t] dy_s   (G the forward's scores)
//     the tile before's Gc = diag(pre(e+1)) Gc + Σ_s r̃_s ⊗ dy_s
// and dw_t expanded over the tile per channel into four terms:
//     F(t) pre(t) Σ_q Gc ⊙ S0 + F(t) Σ_{s'<t} E(s', t) k_{s'} (Gc v_{s'})
//     + pre(t) Σ_{s>t} E(t, s) r_s (S0 dy_s)
//     + Σ_{s>t>s'} E(t, s) E(s', t) r_s k_{s'} A[s, s']
// Every factor is a running product of decays in [0, 1]: no decay is ever
// divided out (bf16 decays round to exactly 0 and 1.0; the GLA-style
// reverse cumsum of r⊙dr − k⊙dk would need it). kernels/rwkv6_scan.py
// `rwkv6_scan_bwd_chunked_plain` is this algorithm in plain PyTorch, which
// the CPU tests hold against the step loop and jax.grad.
//
// What bounds it on an H100: bytes. r, k, v, w and dr, dk, dv, dw in the
// model dtype and dy in fp32, each read or written once: 1.34 GB at
// rwkv6's B=8, S=2048, H=64, P=64 in bf16 (0.401 ms at 3.35 TB/s), 2.42 GB
// in fp32 (0.721 ms). The products are 10·P² + 12·16·P flops a step and
// head, 56 GFLOP there (0.057 ms at the bf16 peak, one pass). Beyond those
// bytes the kernel writes the state before every tile to scratch in pass 1
// and reads it back in pass 2 (1.07 GB each way there), and pass 2 is one
// dependent chain of S / 16 tiles a CTA at two CTAs an SM.
//
// What the design does about it:
//  * one CTA of P / 16 warps per (batch, head): each warp owns 16 key rows
//    p of the state (all P value columns), and keeps S (pass 1) and Gc
//    (pass 2) for them in mma accumulators. The CTA holds every row and
//    column, so dr, dk, dw and dv are its own and only du (over the batch)
//    leaves partials, added in a fixed order by a third launch
//    (sum_partials): no atomics, two calls agree bit for bit.
//  * pass 1 is its own launch with the forward's small footprint (four or
//    more CTAs an SM): the forward without y, S <- diag(T) S + K̃ᵀ V, the
//    state before each tile stored straight from the accumulators
//    (fragment order, whole lines); pass 2 walks the tiles in reverse,
//    each thread reading back what the same thread of pass 1 wrote.
//  * per tile of pass 2 the forward's own preparation (rwkv_prepare,
//    rwkv_cross: r̃, k̃, r̂, k̂, T, v and the score matrix G with its cross
//    block on the tensor cores), then per warp S0 dyᵀ and Gc vᵀ (its rows)
//    and per CTA dY Vᵀ, on the tensor cores; dv = K̃ Gc + Gᵀ dY over all
//    rows (Gc in shared memory as hi / lo for it), the upper half of the
//    warps taking 16 columns at a time; Gc <- diag(T) Gc + R̃ᵀ dY.
//  * the in-tile terms of dr, dk and dw, whose decays are per channel and
//    not rank one, on the CUDA cores in fp32: one thread a channel p (the
//    lower half of the warps, beside dv) walks the tile once, keeping the
//    prefix sums Σ_{s'<t} E(s', t) k_{s'} A[s, s'] for every later s in
//    registers, so each pair (s > t) costs a few FMAs and one broadcast
//    read of A.
//  * precision: every operand but an exact bf16 v is fp32 and runs three
//    bf16 passes (mma_bf16x3), as the forward's.
//  * r, k, v, w and dy of the tile after next are copied with cp.async
//    (double-buffered, as the forward's) once a tile is converted (the
//    channel threads keep their r, k, w in registers); S0 is read into
//    registers while the tile's last products run. Three barriers a tile.
// ===========================================================================
namespace repro_torch {
namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename E, int P>
struct RwkvBwdSmem {
  // staging, double-buffered, as loaded (zero past S)
  E rs[2][L][P], ks[2][L][P], ws[2][L][P], vs[2][L][P];
  float dys[2][L][P];
  // one tile converted to bf16 hi / lo; rows padded by 8 elements; the
  // members rwkv_prepare and rwkv_cross write, then dy and Gc
  __nv_bfloat16 rh[L][P + 8], rl[L][P + 8];     // r̃ [t][p]
  __nv_bfloat16 kh[L][P + 8], kl[L][P + 8];     // k̃ [s][p]
  __nv_bfloat16 vh[L][P + 8], vl[L][P + 8];     // v  [s][q]
  __nv_bfloat16 gh[L][L + 8], gl[L][L + 8];     // G  [t][s], 0 for s > t
  __nv_bfloat16 rch[L][P + 8], rcl[L][P + 8];   // r̂ [t][p], rows t < 8 zero
  __nv_bfloat16 kch[L / 2][P + 8], kcl[L / 2][P + 8];   // k̂ [s][p], s < 8
  __nv_bfloat16 yh[L][P + 8], yl[L][P + 8];     // dy [s][q]
  __nv_bfloat16 gch[P][P + 8], gcl[P][P + 8];   // Gc [p][q]
  float drc[L][P + 4], dkc[L][P + 4];           // (S0 dy_t)[p], (Gc v_t)[p]
  float amat[L][L + 1];                         // A = dy_s·v_{s'} [s][s']
  float T[P];                                   // Π of the tile's w
  float u[P];
  float gs[P];                                  // Σ_q Gc ⊙ S0 per row p
};

// Pass 1's shared memory: k, w, v of two tiles as staged, one converted.
template <typename E, int P>
struct RwkvStatesSmem {
  E ks[2][L][P], ws[2][L][P], vs[2][L][P];
  __nv_bfloat16 kh[L][P + 8], kl[L][P + 8];     // k̃ [s][p]
  __nv_bfloat16 vh[L][P + 8], vl[L][P + 8];     // v  [s][q]
  float T[P];                                   // Π of the tile's w
};

// One tile's staging copies (cp.async; zero past S) of k, w, v, and with
// kBwd also r and dy.
template <typename E, int P, bool kBwd, typename Sm>
__device__ __forceinline__ void rwkv_bwd_load(
    Sm& sm, const E* __restrict__ r, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ w,
    const float* __restrict__ dy, int c, int buf, size_t row0, int h, int S,
    int H) {
  constexpr int NT = 2 * P, EPV = 16 / sizeof(E);  // elements a copy
  constexpr int VPR = P / EPV, FPR = P / 4;      // 16-byte copies per row
  const int tid = threadIdx.x;
  const int HP = H * P;
  const int t0 = c * L;
  const int nt = min(L, S - t0);
  const size_t base = ((row0 + t0) * H + h) * P;
#pragma unroll
  for (int it = 0; it < (L * VPR + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (L * VPR % NT == 0 || i < L * VPR) {
      const int row = i / VPR, e = (i % VPR) * EPV;
      const bool ok = row < nt;
      const int off = row * HP + e;
      if constexpr (kBwd)
        cp_async16_zfill(&sm.rs[buf][row][e], ok ? r + base + off : r, ok);
      cp_async16_zfill(&sm.ks[buf][row][e], ok ? k + base + off : k, ok);
      cp_async16_zfill(&sm.ws[buf][row][e], ok ? w + base + off : w, ok);
      cp_async16_zfill(&sm.vs[buf][row][e], ok ? v + base + off : v, ok);
    }
  }
  if constexpr (kBwd) {
#pragma unroll
    for (int it = 0; it < (L * FPR + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * FPR % NT == 0 || i < L * FPR) {
        const int row = i / FPR, e = (i % FPR) * 4;
        const bool ok = row < nt;
        cp_async16_zfill(&sm.dys[buf][row][e],
                         ok ? dy + base + row * HP + e : dy, ok);
      }
    }
  }
}

// Pass 1, its own launch (the forward's footprint, so the forward's
// occupancy): the forward recurrence without y, S <- diag(T) S + K̃ᵀ V tile
// by tile, storing the state before every tile to `states` in fragment
// order. Same CTAs and warps as pass 2, whose threads read back what the
// same-numbered threads wrote. The warp's rows of S: key rows pw + g (+8),
// value columns 8j + c2 (+1).
template <typename E, int P>
__global__ void __launch_bounds__(2 * P, P == 64 ? 4 : 8)
rwkv6_scan_bwd_states_kernel(const E* __restrict__ k,
                             const E* __restrict__ v,
                             const E* __restrict__ w,
                             float* __restrict__ states, int S, int H) {
  using Sm = RwkvStatesSmem<E, P>;
  constexpr int NT = 2 * P, LP = P + 8;
  constexpr bool kExactV = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int pw = 16 * warp;
  const size_t row0 = static_cast<size_t>(blockIdx.x / H) * S;
  const int ntiles = (S + L - 1) / L;
  float* const st = states + static_cast<size_t>(blockIdx.x) * ntiles * P * P +
                    warp * 16 * P;
  auto load = [&](int c, int buf) {
    rwkv_bwd_load<E, P, false>(sm, nullptr, k, v, w, nullptr, c, buf, row0,
                               h, S, H);
  };

  float sa[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
  load(0, 0);
  cp_async_commit();
  if (ntiles > 1) load(1, 1);
  cp_async_commit();
  for (int c = 0; c < ntiles; ++c) {
    const int buf = c & 1;
    cp_async_wait<1>();
    __syncthreads();                 // tile c staged; tile c-1 done with smem
    state_store<P>(st + static_cast<size_t>(c) * P * P, sa);
    if (c + 1 == ntiles) break;      // the state after the last tile: unused
    rwkv_prepare<E, P, P, NT, false>(sm, buf, min(L, S - c * L));
    __syncthreads();                 // tile c converted; staging[buf] free
    if (c + 2 < ntiles) load(c + 2, buf);
    cp_async_commit();
    // S <- diag(T) S + K̃ᵀ V (M = p, K = s, N = q)
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const float w0 = sm.T[pw + g], w1 = sm.T[pw + g + 8];
      sa[j][0] *= w0;
      sa[j][1] *= w0;
      sa[j][2] *= w1;
      sa[j][3] *= w1;
    }
    uint32_t ah[4], al[4];
    lda_t(ah, &sm.kh[0][0], LP, pw, 0);
    lda_t(al, &sm.kl[0][0], LP, pw, 0);
#pragma unroll
    for (int nn = 0; nn < P / 16; ++nn) {
      uint32_t bh4[4], bl4[4];
      ldb2_t(bh4, &sm.vh[0][0], LP, 16 * nn, 0);
      if (kExactV) {
        mma_bf16x2_b<2>(&sa[2 * nn], ah, al, bh4);
      } else {
        ldb2_t(bl4, &sm.vl[0][0], LP, 16 * nn, 0);
        mma_bf16x3<2>(&sa[2 * nn], ah, al, bh4, bl4);
      }
    }
  }
}

// Pass 2: the tiles in reverse (after rwkv6_scan_bwd_states_kernel).
template <typename E, int P>
__global__ void __launch_bounds__(2 * P, 2)
rwkv6_scan_bwd_kernel(const E* __restrict__ r, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ dy, E* __restrict__ dr,
                      E* __restrict__ dk, E* __restrict__ dv,
                      E* __restrict__ dw, float* __restrict__ pdu,
                      const float* __restrict__ states, int S, int H) {
  using Sm = RwkvBwdSmem<E, P>;
  constexpr int W = P / 16, NT = 2 * P;
  constexpr int LP = P + 8, LL = L + 8;          // bf16 row strides
  constexpr bool kExactV = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int pw = 16 * warp;                      // warp's key rows
  const size_t row0 = static_cast<size_t>(b) * S;
  const int ntiles = (S + L - 1) / L;
  const int HP = H * P;
  // the warp's rows of the state before tile c: st + c · P · P
  const float* const st = states +
                          static_cast<size_t>(blockIdx.x) * ntiles * P * P +
                          warp * 16 * P;
  auto load = [&](int c, int buf) {
    rwkv_bwd_load<E, P, true>(sm, r, k, v, w, dy, c, buf, row0, h, S, H);
  };

  for (int i = tid; i < L * (L + 8); i += NT) {   // G above the diagonal
    (&sm.gh[0][0])[i] = __float2bfloat16_rn(0.f);
    (&sm.gl[0][0])[i] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < L / 2 * (P + 8); i += NT) {   // r̂ rows t < 8
    (&sm.rch[0][0])[i] = __float2bfloat16_rn(0.f);
    (&sm.rcl[0][0])[i] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < P; i += NT) sm.u[i] = u[h * P + i];

  // sa holds S0 (the warp's rows of S), gc the incoming adjoint
  float sa[P / 8][4];
  float gc[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gc[j][e] = 0.f;
  float du_acc = 0.f;                // channel tid's Σ_t r k c_t
  state_load<P>(sa, st + static_cast<size_t>(ntiles - 1) * P * P);
  load(ntiles - 1, 0);
  cp_async_commit();
  if (ntiles > 1) load(ntiles - 2, 1);
  cp_async_commit();
  for (int c = ntiles - 1, buf = 0; c >= 0; --c, buf ^= 1) {
    const int t0 = c * L;
    const int nt = min(L, S - t0);
    cp_async_wait<1>();
    __syncthreads();                 // tile c staged; tile c+1 done with smem
    // the forward's r̃, k̃, r̂, k̂, T, v and G's diagonal blocks; dy and Gc as
    // hi / lo rows; Σ_q Gc ⊙ S0 for each of the warp's rows; channel tid's
    // r, k and w into registers (threads < P)
    rwkv_prepare<E, P, P, NT, true>(sm, buf, nt);
    float rr[L], kq[L], wq[L];
    if (tid < P) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        rr[t] = to_f(sm.rs[buf][t][tid]);
        kq[t] = to_f(sm.ks[buf][t][tid]);
        wq[t] = t < nt ? to_f(sm.ws[buf][t][tid]) : 1.f;
      }
    }
#pragma unroll
    for (int it = 0; it < (L * P / 4 + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * P / 4 % NT == 0 || i < L * P / 4) {
        const int s = i / (P / 4), q4 = (i % (P / 4)) * 4;
        const float4 d = *reinterpret_cast<const float4*>(&sm.dys[buf][s][q4]);
        store_split4(&sm.yh[s][q4], &sm.yl[s][q4], d.x, d.y, d.z, d.w);
      }
    }
    {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        const int q = 8 * j + c2;
        store_split2(&sm.gch[pw + g][q], &sm.gcl[pw + g][q], gc[j][0],
                     gc[j][1]);
        store_split2(&sm.gch[pw + g + 8][q], &sm.gcl[pw + g + 8][q], gc[j][2],
                     gc[j][3]);
        a0 = fmaf(gc[j][0], sa[j][0], fmaf(gc[j][1], sa[j][1], a0));
        a1 = fmaf(gc[j][2], sa[j][2], fmaf(gc[j][3], sa[j][3], a1));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        a0 += __shfl_xor_sync(0xffffffffu, a0, off);
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      }
      if ((lane & 3) == 0) {
        sm.gs[pw + g] = a0;
        sm.gs[pw + g + 8] = a1;
      }
    }
    __syncthreads();                 // tile c converted; staging[buf] free
    if (c >= 2) load(c - 2, buf);
    cp_async_commit();

    // G's cross block (the last warp); A = dY Vᵀ (M = s, K = q, N = s',
    // warp 0); per warp S0 dyᵀ and Gc vᵀ (M = p, K = q, N = t)
    if (warp == W - 1) rwkv_cross<P>(sm);
    if (warp == 0) {
      float acc[2][2][4] = {};         // even and odd k-steps apart
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t ah[4], al[4], bh4[4], bl4[4];
        lda(ah, &sm.yh[0][0], LP, 0, 16 * kk);
        lda(al, &sm.yl[0][0], LP, 0, 16 * kk);
        ldb2(bh4, &sm.vh[0][0], LP, 0, 16 * kk);
        if (kExactV) {
          mma_bf16x2_b<2>(acc[kk & 1], ah, al, bh4);
        } else {
          ldb2(bl4, &sm.vl[0][0], LP, 0, 16 * kk);
          mma_bf16x3<2>(acc[kk & 1], ah, al, bh4, bl4);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.amat[g + 8 * (e >> 1)][8 * j + c2 + (e & 1)] =
              acc[0][j][e] + acc[1][j][e];
    }
    {
      float ar[2][4] = {}, ak[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t ah[4], al[4], bh4[4], bl4[4];
        acc_to_a<P>(sa, kk, ah, al);
        ldb2(bh4, &sm.yh[0][0], LP, 0, 16 * kk);
        ldb2(bl4, &sm.yl[0][0], LP, 0, 16 * kk);
        mma_bf16x3<2>(ar, ah, al, bh4, bl4);
        acc_to_a<P>(gc, kk, ah, al);
        ldb2(bh4, &sm.vh[0][0], LP, 0, 16 * kk);
        if (kExactV) {
          mma_bf16x2_b<2>(ak, ah, al, bh4);
        } else {
          ldb2(bl4, &sm.vl[0][0], LP, 0, 16 * kk);
          mma_bf16x3<2>(ak, ah, al, bh4, bl4);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * j + c2 + (e & 1), p = pw + g + 8 * (e >> 1);
          sm.drc[t][p] = ar[j][e];
          sm.dkc[t][p] = ak[j][e];
        }
    }
    __syncthreads();

    // the next tile's S0, in flight during this tile's last products
    if (c > 0) state_load<P>(sa, st + static_cast<size_t>(c - 1) * P * P);
    if (tid < P) {
      // dr, dk and dw of channel p at every step of the tile, on the CUDA
      // cores; R[s] = Σ_{s'<t} E(s', t) k_{s'} A[s, s'] for s > t, Z the
      // same sum of k_{s'} (Gc v_{s'}), epre = pre(t), e = E(t, s) → F(t)
      const int p = tid;
      float dq[L], R[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        dq[t] = sm.drc[t][p];
        R[t] = 0.f;
      }
      const float up = sm.u[p], gsp = sm.gs[p];
      float Z = 0.f, epre = 1.f;
      const size_t o = ((row0 + t0) * H + h) * P + p;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float ct = sm.amat[t][t];
        const float kc = sm.dkc[t][p];
        float e = 1.f, ak = 0.f, ay = 0.f, a4 = 0.f;
        const float rt = R[t];
#pragma unroll
        for (int s = t + 1; s < L; ++s) {
          const float as = sm.amat[s][t];
          const float re = e * rr[s];
          ak = fmaf(re, as, ak);
          ay = fmaf(re, dq[s], ay);
          a4 = fmaf(re, R[s], a4);
          R[s] = fmaf(wq[t], R[s], kq[t] * as);
          e *= wq[s];
        }
        if (t < nt) {
          const size_t ot = o + static_cast<size_t>(t) * HP;
          store_f(dr + ot, fmaf(up * kq[t], ct, fmaf(epre, dq[t], rt)));
          store_f(dk + ot, fmaf(rr[t] * up, ct, fmaf(e, kc, ak)));
          store_f(dw + ot, fmaf(e, fmaf(epre, gsp, Z), fmaf(epre, ay, a4)));
        }
        du_acc = fmaf(rr[t] * kq[t], ct, du_acc);
        Z = fmaf(wq[t], Z, kq[t] * kc);
        epre *= wq[t];
      }
    } else {
      // dv = K̃ Gc + Gᵀ dY (M = t, N = q; K = p, then s), the upper half of
      // the warps 16 columns at a time
      for (int n16 = warp - W / 2; n16 < P / 16; n16 += W / 2) {
        float acc[2][2][4] = {};       // even and odd k-steps apart
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {
          uint32_t ah[4], al[4], bh4[4], bl4[4];
          lda(ah, &sm.kh[0][0], LP, 0, 16 * kk);
          lda(al, &sm.kl[0][0], LP, 0, 16 * kk);
          ldb2_t(bh4, &sm.gch[0][0], LP, 16 * n16, 16 * kk);
          ldb2_t(bl4, &sm.gcl[0][0], LP, 16 * n16, 16 * kk);
          mma_bf16x3<2>(acc[kk & 1], ah, al, bh4, bl4);
        }
        uint32_t ah[4], al[4], bh4[4], bl4[4];
        lda_t(ah, &sm.gh[0][0], LL, 0, 0);
        lda_t(al, &sm.gl[0][0], LL, 0, 0);
        ldb2_t(bh4, &sm.yh[0][0], LP, 16 * n16, 0);
        ldb2_t(bl4, &sm.yl[0][0], LP, 16 * n16, 0);
        mma_bf16x3<2>(acc[0], ah, al, bh4, bl4);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = g + 8 * half;
            if (t < nt)
              store2(dv + ((row0 + t0 + t) * H + h) * P + 16 * n16 + 8 * j +
                         c2,
                     acc[0][j][2 * half] + acc[1][j][2 * half],
                     acc[0][j][2 * half + 1] + acc[1][j][2 * half + 1]);
          }
      }
    }
    {   // Gc <- diag(T) Gc + R̃ᵀ dY (M = p, K = s, N = q)
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        const float w0 = sm.T[pw + g], w1 = sm.T[pw + g + 8];
        gc[j][0] *= w0;
        gc[j][1] *= w0;
        gc[j][2] *= w1;
        gc[j][3] *= w1;
      }
      uint32_t ah[4], al[4];
      lda_t(ah, &sm.rh[0][0], LP, pw, 0);
      lda_t(al, &sm.rl[0][0], LP, pw, 0);
#pragma unroll
      for (int nn = 0; nn < P / 16; ++nn) {
        uint32_t bh4[4], bl4[4];
        ldb2_t(bh4, &sm.yh[0][0], LP, 16 * nn, 0);
        ldb2_t(bl4, &sm.yl[0][0], LP, 16 * nn, 0);
        mma_bf16x3<2>(&gc[2 * nn], ah, al, bh4, bl4);
      }
    }
  }
  if (tid < P) pdu[static_cast<size_t>(blockIdx.x) * P + tid] = du_acc;
}

// The backward's scratch, one fp32 buffer: the state before every tile of
// every CTA (at 0), then the per-(batch, head) partials of du (B, H, P).
// Offsets and size in floats.
struct RwkvBwdScratch {
  int64_t pdu, floats;
};

inline RwkvBwdScratch rwkv_bwd_scratch(int64_t B, int64_t S, int64_t H,
                                       int P) {
  RwkvBwdScratch s;
  s.pdu = B * H * ((S + L - 1) / L) * P * P;
  s.floats = s.pdu + B * H * P;
  return s;
}

template <typename E, int P>
cudaError_t launch_bwd(const E* r, const E* k, const E* v, const E* w,
                       const float* u, const float* dy, E* dr, E* dk, E* dv,
                       E* dw, float* du, float* scratch, int B, int S, int H,
                       cudaStream_t stream) {
  const RwkvBwdScratch sc = rwkv_bwd_scratch(B, S, H, P);
  const size_t smem = sizeof(RwkvBwdSmem<E, P>);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<E, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* pdu = scratch + sc.pdu;
  rwkv6_scan_bwd_states_kernel<E, P>
      <<<B * H, 2 * P, sizeof(RwkvStatesSmem<E, P>), stream>>>(k, v, w,
                                                              scratch, S, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rwkv6_scan_bwd_kernel<E, P><<<B * H, 2 * P, smem, stream>>>(
      r, k, v, w, u, dy, dr, dk, dv, dw, pdu, scratch, S, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_partials(pdu, du, 1L, B, H * P, stream);
}

template <typename E>
int dispatch_bwd(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* dy, void* dr, void* dk, void* dv,
                 void* dw, void* du, void* scratch, int64_t scratch_floats,
                 int B, int S, int H, int P, void* stream) {
  if ((P != 32 && P != 64) ||
      scratch_floats < rwkv_bwd_scratch(B, S, H, P).floats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define REPRO_RWKV_BWD(PP)                                                   \
  launch_bwd<E, PP>(                                                         \
      static_cast<const E*>(r), static_cast<const E*>(k),                    \
      static_cast<const E*>(v), static_cast<const E*>(w),                    \
      static_cast<const float*>(u), static_cast<const float*>(dy),           \
      static_cast<E*>(dr), static_cast<E*>(dk), static_cast<E*>(dv),         \
      static_cast<E*>(dw), static_cast<float*>(du),                          \
      static_cast<float*>(scratch), B, S, H, st)
  const cudaError_t err = P == 32 ? REPRO_RWKV_BWD(32) : REPRO_RWKV_BWD(64);
#undef REPRO_RWKV_BWD
  return static_cast<int>(err);
}

// The occupancy of the backward's two launches: out[0] warps, out[2] /
// out[3] pass 2's dynamic shared bytes / CTAs an SM, out[5] / out[6]
// pass 1's.
template <typename E, int P>
int bwd_design(int64_t* out) {
  const size_t smem = sizeof(RwkvBwdSmem<E, P>);
  const size_t smem1 = sizeof(RwkvStatesSmem<E, P>);
  int per_sm = 0, per_sm1 = 0;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<E, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rwkv6_scan_bwd_kernel<E, P>, 2 * P, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm1, rwkv6_scan_bwd_states_kernel<E, P>, 2 * P, smem1);
  out[0] = P / 16;
  out[2] = static_cast<int64_t>(smem);
  out[3] = per_sm;
  out[5] = static_cast<int64_t>(smem1);
  out[6] = per_sm1;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace repro_torch

// The fp32 scratch the backward needs for these sizes (floats), or -1 for a
// P it is not instantiated for.
extern "C" int64_t rwkv6_scan_bwd_scratch_floats(int B, int S, int H, int P) {
  if (P != 32 && P != 64) return -1;
  return repro_torch::rwkv_bwd_scratch(B, S, H, P).floats;
}

// The backward's launches at these sizes, for reports (bf16 != 0: the bf16
// entry's kernels): out[0..6] = warps a CTA, CTAs (the grid, both passes),
// pass 2's dynamic shared bytes a CTA and CTAs an SM (occupancy query), the
// scratch floats kept for the states, pass 1's shared bytes and CTAs an
// SM. cudaErrorInvalidValue for a P it is not instantiated for.
extern "C" int rwkv6_scan_bwd_design(int B, int S, int H, int P, int bf16,
                                     int64_t* out) {
  using namespace repro_torch;
  if (P != 32 && P != 64) return static_cast<int>(cudaErrorInvalidValue);
  out[1] = static_cast<int64_t>(B) * H;
  out[4] = rwkv_bwd_scratch(B, S, H, P).pdu;
  if (bf16)
    return P == 32 ? bwd_design<__nv_bfloat16, 32>(out)
                   : bwd_design<__nv_bfloat16, 64>(out);
  return P == 32 ? bwd_design<float, 32>(out) : bwd_design<float, 64>(out);
}

// Plain C entry points of the backward (bound with ctypes): gradients dr,
// dk, dv, dw (B, S, H, P) in the inputs' dtype and du (H, P) fp32 of the
// forward above for dy (B, S, H, P) fp32. `scratch` holds `scratch_floats`
// fp32 values, at least rwkv6_scan_bwd_scratch_floats(B, S, H, P).
// Launches on `stream` (pass 1, pass 2, then one fixed-order sum) and returns
// cudaGetLastError() as an int; cudaErrorInvalidValue for a P the forward
// is not instantiated for, or too small a scratch.
extern "C" int rwkv6_scan_bwd_bf16(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, const void* dy, void* dr,
                                   void* dk, void* dv, void* dw, void* du,
                                   void* scratch, int64_t scratch_floats,
                                   int B, int S, int H, int P, void* stream) {
  return repro_torch::dispatch_bwd<__nv_bfloat16>(
      r, k, v, w, u, dy, dr, dk, dv, dw, du, scratch, scratch_floats, B, S,
      H, P, stream);
}

extern "C" int rwkv6_scan_bwd_f32(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, const void* dy,
                                  void* dr, void* dk, void* dv, void* dw,
                                  void* du, void* scratch,
                                  int64_t scratch_floats, int B, int S, int H,
                                  int P, void* stream) {
  return repro_torch::dispatch_bwd<float>(r, k, v, w, u, dy, dr, dk, dv, dw,
                                          du, scratch, scratch_floats, B, S,
                                          H, P, stream);
}
