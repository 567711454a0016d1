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

template <typename E, int P, int W>
__global__ void __launch_bounds__(32 * W, W == 1 ? 8 : 16 / W)
rwkv6_scan_kernel(const E* __restrict__ r, const E* __restrict__ k,
                  const E* __restrict__ v, const E* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ y, int S,
                  int H, int nslices) {
  using Sm = RwkvSmem<E, P, W>;
  constexpr int QS = Sm::QS, NT = 32 * W;
  constexpr int EPV = 16 / sizeof(E);  // elements per 16-byte copy
  // With 2P threads or more the r̃ / k̃ jobs (threads [0, P)) and G's
  // diagonal blocks (threads [P, 2P)) run side by side; else one after the
  // other on every thread. G takes pairs of rows (t, 7 - t) of an 8 x 8
  // block, LPT lanes a pair, CPL channels a lane.
  constexpr bool kSplitRoles = NT >= 2 * P;
  constexpr int GT = kSplitRoles ? P : NT;
  constexpr int LPT = GT / 8;
  constexpr int CPL = P / LPT;
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

  // staging -> r̃, k̃, v as hi / lo rows, T, and G on the CUDA cores
  auto prepare = [&](int c, int buf) {
    const int nt = min(L, S - c * L);
    constexpr int J = L / 2;
    const float2 one = make_float2(1.f, 1.f);
    // r̃ and k̃ (and r̂, k̂, T), a job per (r or k, two channels): prod runs
    // from the tile's edge, half from its middle b + 8
    if (!kSplitRoles || tid < P) {
      for (int job = tid; job < P; job += kSplitRoles ? P : NT) {
        const int p = (job % (P / 2)) * 2;
        float2 prod = one, half = one;
        if (job < P / 2) {             // r̃_t = r_t Π_{b≤m<t} w_m; for
#pragma unroll                         // t ≥ b+8 r̂_t = r_t Π_{b+8≤m<t} w_m
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
        } else {                       // k̃_s = k_s Π_{s<m<b+16} w_m; for
#pragma unroll                         // s < b+8 k̂_s = k_s Π_{s<m<b+8} w_m
          for (int s = L - 1; s >= 0; --s) {
            if (s == J - 1) half = one;
            const float2 kv = load2(&sm.ks[buf][s][p]);
            store_split2(&sm.kh[s][p], &sm.kl[s][p], kv.x * prod.x,
                         kv.y * prod.y);
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
    // the two 8 x 8 diagonal blocks of G (the cross block is r̂ k̂ᵀ, on the
    // tensor cores): G[t, s] = Σ_p r_t[p] k_s[p] Π_{s<m<t} w_m[p] for s < t
    // in t's block, the u bonus at s = t. Rows a and 7 - a of a block
    // need a and 7 - a steps, so a pair walks 7 steps, each one live.
    if (!kSplitRoles || tid >= P) {
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
    prepare(c, buf);
    __syncthreads();                 // tile c converted; staging[buf] free
    if (c + 2 < ntiles) load(c + 2, buf);
    cp_async_commit();

    // the cross block of G, r̂ k̂ᵀ (M = t, N = s < 8, K = p; rows t ≥ 8),
    // once per CTA by its last warp into shared memory; the other warps
    // start on Sᵀ r̃ᵀ
    if (warp == W - 1) {
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
// and ⟨v_t, dy_t⟩ = Σ_q v_t dy_t, in fp32:
//     G_{t-1} = diag(w_t) G_t + r_t ⊗ dy_t
//     dr_t = S_{t-1} dy_t + u ⊙ k_t ⟨v_t, dy_t⟩
//     dk_t = G_t v_t + r_t ⊙ u ⟨v_t, dy_t⟩
//     dv_t = G_tᵀ k_t + (r_t·(u⊙k_t)) dy_t
//     dw_t = Σ_q G_t ⊙ S_{t-1} ;  du = Σ_{b,t} r_t ⊙ k_t ⟨v_t, dy_t⟩
// The design is the Mamba2 backward's (ssm_scan.cu): one CTA of 256 threads
// per (batch, head, slice of R = 1024 / P key rows p) over all P value
// columns, each thread one column and 4 rows; pass 1 stores the state before
// every 8-step tile in global scratch; pass 2 walks the tiles in reverse,
// recomputes each tile's states from its boundary (never S_t / w_t: bf16
// decays round to exactly 0), runs the adjoint back through the tile into
// shared memory and computes the tile's outputs as dot products there; the
// next tile's operands load into registers while a tile is computed. dr,
// dk and dw are the CTA's own rows; dv (a sum over all rows) and du (a sum
// over the batch) leave per-CTA partials that a second launch adds in a
// fixed order (no atomics: two calls agree bit for bit). Outputs in the
// inputs' dtype, du in fp32.
// What bounds it: bytes, 1.34 GB of bf16 operands and fp32 dy at rwkv6's
// B=8, S=2048, H=64 (0.40 ms), under the forward's rule: the chunked form's
// products on the tensor cores (10·P² + 12·16·P a batch, step and head,
// 56 GFLOP: 0.06 ms at 989 TFLOP/s). This design runs the sequential form,
// ~14·P² fp32 flops a (batch, step, head) (0.90 ms at 67 TFLOP/s).
// ===========================================================================
namespace repro_torch {
namespace {

__host__ __device__ constexpr size_t rwkv_bwd_smem_floats(int R, int P) {
  return static_cast<size_t>(2 * BWD_L) * R * (P + 1) + 3 * BWD_L * R +
         2 * BWD_L * P + 2 * BWD_L;
}

// One tile's operands, loaded into registers ahead of their use: the
// thread's share of r, k and w (BWD_L x R rows) and of v and dy (BWD_L x P
// columns).
template <int P>
struct RwkvTileRegs {
  static constexpr int R = bwd_rows(P, P);
  static constexpr int RR = (BWD_L * R + BWD_THREADS - 1) / BWD_THREADS;
  static constexpr int CR = (BWD_L * P + BWD_THREADS - 1) / BWD_THREADS;
  float r[RR], k[RR], w[RR], v[CR], dy[CR];
};

template <typename E, int P>
__device__ __forceinline__ void rwkv_tile_load(
    RwkvTileRegs<P>& t, const E* __restrict__ r, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ w,
    const float* __restrict__ dy, int b, int h, int S, int H, int p0,
    int t0, bool bwd) {
  constexpr int R = RwkvTileRegs<P>::R;
  const int tid = threadIdx.x;
  const int nt = min(BWD_L, S - t0);
#pragma unroll
  for (int j = 0; j < RwkvTileRegs<P>::RR; ++j) {
    const int e = tid + j * BWD_THREADS, i = e / R, rr = e - i * R;
    t.r[j] = t.k[j] = t.w[j] = 0.f;
    if (i < nt) {
      const long idx = ((static_cast<long>(b) * S + t0 + i) * H + h) * P +
                       p0 + rr;
      t.k[j] = load_f(k + idx);
      t.w[j] = load_f(w + idx);
      if (bwd) t.r[j] = load_f(r + idx);
    }
  }
#pragma unroll
  for (int j = 0; j < RwkvTileRegs<P>::CR; ++j) {
    const int e = tid + j * BWD_THREADS, i = e / P, q = e - i * P;
    t.v[j] = t.dy[j] = 0.f;
    if (i < nt) {
      const long idx = ((static_cast<long>(b) * S + t0 + i) * H + h) * P + q;
      t.v[j] = load_f(v + idx);
      if (bwd) t.dy[j] = __ldg(dy + idx);
    }
  }
}

template <int P>
__device__ __forceinline__ void rwkv_tile_store(const RwkvTileRegs<P>& t,
                                                float* rs, float* ks,
                                                float* ws, float* vs,
                                                float* dys) {
  constexpr int R = RwkvTileRegs<P>::R;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < RwkvTileRegs<P>::RR; ++j) {
    const int e = tid + j * BWD_THREADS;
    if (e < BWD_L * R) {
      rs[e] = t.r[j];
      ks[e] = t.k[j];
      ws[e] = t.w[j];
    }
  }
#pragma unroll
  for (int j = 0; j < RwkvTileRegs<P>::CR; ++j) {
    const int e = tid + j * BWD_THREADS;
    if (e < BWD_L * P) {
      vs[e] = t.v[j];
      dys[e] = t.dy[j];
    }
  }
}

template <typename E, int P>
__global__ void __launch_bounds__(BWD_THREADS)
rwkv6_scan_bwd_kernel(const E* __restrict__ r, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ dy, E* __restrict__ dr,
                      E* __restrict__ dk, E* __restrict__ dw,
                      float* __restrict__ pdv, float* __restrict__ pdu,
                      float* hb, int S, int H, int slices) {
  constexpr int L = BWD_L, QP = P + 1, RSTEP = BWD_THREADS / P;
  constexpr int K = BWD_ELEMS / BWD_THREADS;      // rows a thread owns
  constexpr int R = RwkvTileRegs<P>::R;
  extern __shared__ float sm[];
  float* hs = sm;                       // [L][R][QP]: S_{t-1}, t in the tile
  float* gs = hs + L * R * QP;          // [L][R][QP]: G_t
  float* rs = gs + L * R * QP;          // [L][R]
  float* ks = rs + L * R;               // [L][R]
  float* ws = ks + L * R;               // [L][R]
  float* vs = ws + L * R;               // [L][P]
  float* dys = vs + L * P;              // [L][P]
  float* vdy = dys + L * P;             // [L]: ⟨v_t, dy_t⟩
  float* ruk = vdy + L;                 // [L]: Σ_{slice rows} r u k

  const int sl = blockIdx.x % slices;
  const int bh = blockIdx.x / slices;
  const int h = bh % H, b = bh / H;
  const int p0 = sl * R;
  const int nc = (S + L - 1) / L;
  const int tid = threadIdx.x, q = tid % P, r0 = tid / P;
  float* hbase = hb + static_cast<long>(blockIdx.x) * nc * R * P;
  const float* uh = u + static_cast<long>(h) * P + p0;
  RwkvTileRegs<P> next;

  // pass 1: the forward recurrence; the state before every tile to hb
  float st[K];
#pragma unroll
  for (int j = 0; j < K; ++j) st[j] = 0.f;
  rwkv_tile_load<E, P>(next, r, k, v, w, dy, b, h, S, H, p0, 0, false);
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, nt = min(L, S - t0);
    __syncthreads();                    // the last tile is done with smem
    rwkv_tile_store<P>(next, rs, ks, ws, vs, dys);
    __syncthreads();
    if (c + 1 < nc)                     // in flight during this tile
      rwkv_tile_load<E, P>(next, r, k, v, w, dy, b, h, S, H, p0, t0 + L,
                           false);
    float* dst = hbase + static_cast<long>(c) * R * P;
#pragma unroll
    for (int j = 0; j < K; ++j) dst[(r0 + j * RSTEP) * P + q] = st[j];
    for (int i = 0; i < nt; ++i) {
      const float vq = vs[i * P + q];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int rr = r0 + j * RSTEP;
        st[j] = fmaf(ws[i * R + rr], st[j], ks[i * R + rr] * vq);
      }
    }
  }

  // pass 2: the tiles in reverse
  float G[K];
#pragma unroll
  for (int j = 0; j < K; ++j) G[j] = 0.f;
  float du_acc = 0.f;                   // row tid's Σ_t r k ⟨v, dy⟩
  const int warp = tid / 32, lane = tid % 32;
  rwkv_tile_load<E, P>(next, r, k, v, w, dy, b, h, S, H, p0, (nc - 1) * L,
                       true);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, nt = min(L, S - t0);
    __syncthreads();                    // the last tile's products are done
    rwkv_tile_store<P>(next, rs, ks, ws, vs, dys);
    __syncthreads();
    if (c > 0)                          // in flight during this tile
      rwkv_tile_load<E, P>(next, r, k, v, w, dy, b, h, S, H, p0, t0 - L,
                           true);
    // per step: ⟨v_t, dy_t⟩ and the slice's Σ r u k, one warp a step
    for (int i = warp; i < nt; i += BWD_THREADS / 32) {
      float a1 = 0.f, a2 = 0.f;
      for (int e = lane; e < P; e += 32)
        a1 = fmaf(vs[i * P + e], dys[i * P + e], a1);
      for (int e = lane; e < R; e += 32)
        a2 = fmaf(rs[i * R + e] * __ldg(uh + e), ks[i * R + e], a2);
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (lane == 0) {
        vdy[i] = a1;
        ruk[i] = a2;
      }
    }
    // the tile's states S_{t-1}, recomputed from its boundary
    const float* src = hbase + static_cast<long>(c) * R * P;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int rr = r0 + j * RSTEP;
      st[j] = src[rr * P + q];
      hs[rr * QP + q] = st[j];
    }
    for (int i = 0; i + 1 < nt; ++i) {
      const float vq = vs[i * P + q];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int rr = r0 + j * RSTEP;
        st[j] = fmaf(ws[i * R + rr], st[j], ks[i * R + rr] * vq);
        hs[((i + 1) * R + rr) * QP + q] = st[j];
      }
    }
    // the adjoint, back through the tile: G_t, then G_{t-1}
    for (int i = nt - 1; i >= 0; --i) {
      const float dq = dys[i * P + q];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int rr = r0 + j * RSTEP;
        gs[(i * R + rr) * QP + q] = G[j];
        G[j] = fmaf(ws[i * R + rr], G[j], rs[i * R + rr] * dq);
      }
    }
    __syncthreads();
    // dr, dk, dw: the CTA's own rows
    for (int e = tid; e < nt * R; e += BWD_THREADS) {
      const int i = e / R, rr = e - i * R;
      const float* sp = hs + (i * R + rr) * QP;
      const float* gp = gs + (i * R + rr) * QP;
      const float* vv = vs + i * P;
      const float* dd = dys + i * P;
      float a_r = 0.f, a_k = 0.f, a_w = 0.f;
#pragma unroll 8
      for (int qq = 0; qq < P; ++qq) {
        a_r = fmaf(sp[qq], dd[qq], a_r);
        a_k = fmaf(gp[qq], vv[qq], a_k);
        a_w = fmaf(gp[qq], sp[qq], a_w);
      }
      const float ur = __ldg(uh + rr);
      const long idx = ((static_cast<long>(b) * S + t0 + i) * H + h) * P +
                       p0 + rr;
      store_f(dr + idx, fmaf(ur * ks[e], vdy[i], a_r));
      store_f(dk + idx, fmaf(rs[e] * ur, vdy[i], a_k));
      store_f(dw + idx, a_w);
    }
    // dv over the slice's rows: partials (B, S, H, slices, P)
    for (int e = tid; e < nt * P; e += BWD_THREADS) {
      const int i = e / P, qq = e - i * P;
      float acc = 0.f;
      for (int rr = 0; rr < R; ++rr)
        acc = fmaf(ks[i * R + rr], gs[(i * R + rr) * QP + qq], acc);
      acc = fmaf(ruk[i], dys[e], acc);
      pdv[(((static_cast<long>(b) * S + t0 + i) * H + h) * slices + sl) * P +
          qq] = acc;
    }
    // du: each row's own running sum over the batch's steps
    if (tid < R)
      for (int i = 0; i < nt; ++i)
        du_acc = fmaf(rs[i * R + tid] * ks[i * R + tid], vdy[i], du_acc);
  }
  if (tid < R) pdu[(static_cast<long>(b) * H + h) * P + p0 + tid] = du_acc;
}

// The backward's scratch, one fp32 buffer: the state before every tile of
// every CTA (at 0), then the per-CTA partials of dv (B, S, H, slices, P) and
// of du (B, H, P). Offsets and size in floats.
struct RwkvBwdScratch {
  int64_t pdv, pdu, floats;
};

inline RwkvBwdScratch rwkv_bwd_scratch(int64_t B, int64_t S, int64_t H,
                                       int P) {
  RwkvBwdScratch s;
  s.pdv = bwd_state_floats(B, S, H, P, P);
  s.pdu = s.pdv + B * S * H * bwd_slices(P, P) * P;
  s.floats = s.pdu + B * H * P;
  return s;
}

template <typename E, int P>
cudaError_t launch_bwd(const E* r, const E* k, const E* v, const E* w,
                       const float* u, const float* dy, E* dr, E* dk, E* dv,
                       E* dw, float* du, float* scratch, int B, int S, int H,
                       cudaStream_t stream) {
  constexpr int R = bwd_rows(P, P), slices = bwd_slices(P, P);
  const RwkvBwdScratch sc = rwkv_bwd_scratch(B, S, H, P);
  float *pdv = scratch + sc.pdv, *pdu = scratch + sc.pdu;
  const size_t smem = rwkv_bwd_smem_floats(R, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<E, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rwkv6_scan_bwd_kernel<E, P><<<B * H * slices, BWD_THREADS, smem, stream>>>(
      r, k, v, w, u, dy, dr, dk, dw, pdv, pdu, scratch, S, H, slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_partials(pdv, dv, static_cast<long>(B) * S * H, slices, P,
                          stream)) != cudaSuccess)
    return err;
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

}  // namespace
}  // namespace repro_torch

// The fp32 scratch the backward needs for these sizes (floats), or -1 for a
// P it is not instantiated for.
extern "C" int64_t rwkv6_scan_bwd_scratch_floats(int B, int S, int H, int P) {
  if (P != 32 && P != 64) return -1;
  return repro_torch::rwkv_bwd_scratch(B, S, H, P).floats;
}

// Plain C entry points of the backward (bound with ctypes): gradients dr,
// dk, dv, dw (B, S, H, P) in the inputs' dtype and du (H, P) fp32 of the
// forward above for dy (B, S, H, P) fp32. `scratch` holds `scratch_floats`
// fp32 values, at least rwkv6_scan_bwd_scratch_floats(B, S, H, P).
// Launches on `stream` (the kernel, then two fixed-order sums) and returns
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
