// Mamba2 scalar-decay selective scan, fp32: a chunked scan whose products
// run on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py `_ssm_kernel` (wrapper
// `ssm_scan`, pallas_call at :60) with the entry point `ssm_scan_f32`.
// Same contract: x (B, S, H, P) dt-scaled inputs, B_in / C_in (B, S, N)
// shared by every head, decay (B, S, H), all fp32; writes y (B, S, H, P)
// fp32 with
//     h_t = decay_t · h_{t-1} + x_t ⊗ B_t ;   y_t = h_t · C_t
// and the (P, N) state of each (batch, head) starting at zero. The TPU
// wrapper pads S to whole VMEM chunks with decay 1.0; this kernel masks the
// ragged last tile itself and reads or writes nothing past S. One launch
// per call.
//
// The chunked form (SSD). Per (batch, head) the sequence is cut into tiles
// of L = 16 steps starting at b. With D(s, t) = Π_{s<m≤t} a_m,
//     y_t = pre(t) · (h_{b-1} · C_t) + Σ_{b≤s≤t} (C_t·B_s) D(s, t) x_s
//     h_{b+15} = T · h_{b-1} + Σ_s suf(s) x_s ⊗ B_s
// with pre(t) = D(b-1, t), suf(s) = D(s, b+15) and T = pre(b+15): four
// products per tile (C Bᵀ, (C Bᵀ ∘ D) X, h Cᵀ, X̃ᵀ B), and the sequential
// chain is S/16 state updates instead of S steps. Every decay factor is a
// product of factors in [0, 1] taken in fp32 (never a ratio or an exp of
// log differences), so a decay that is exactly 0 gives 0 and 1.0 gives 1.
//
// What bounds it on an H100: bytes. Each input is read once and y written
// once: (2·H·P + 2·N + H)·4 bytes per (batch, step), 549.5 MB at zamba2's
// prefill (B=8, S=2048, H=64, P=N=64), 0.164 ms at 3.35 TB/s. The products
// are 4·P·N + 32·P flops per step and head (h·Cᵀ, X̃ᵀB, the diagonal block)
// plus 32·N per step for C·Bᵀ, 21.5 GFLOP there (0.022 ms at the bf16
// tensor-core peak), which the split below runs in three bf16 passes on
// mma.sync, at half of Hopper's wgmma rate: those passes and the per-tile
// conversion, not the bytes, are what the kernel spends most of its time
// on. (The sequential form needed ~5·P·N fp32 FMAs per step on the CUDA
// cores and one dependent chain of S steps.)
//
// What the design does about it:
//  * one CTA per (batch, head, slice of 16·W state rows p): the rows of h
//    evolve independently, so a CTA of W warps owns 16·W of them (W = 4 at
//    P = 64: 512 CTAs of 128 threads at zamba2's B=8, H=64, one wave at four
//    CTAs an SM); when B·H is small, narrower CTAs over more slices keep
//    two CTAs an SM busy (pick_warps). P up to 256 in slices of 64.
//  * each warp keeps its 16 rows of h (16 x N fp32) in mma accumulators for
//    the whole sequence. After a bf16 hi + lo split they are the A operand
//    of y's h·Cᵀ directly (common.cuh), so the state never touches memory.
//  * precision: every operand is fp32, so every product runs three bf16
//    passes (hi·hi + hi·lo + lo·hi, common.cuh `mma_bf16x3`), ~1e-5 of each
//    product; one bf16 or TF32 pass would miss the 1e-4 gate.
//  * x, B, C and the decays of tile i+2 are copied into shared memory with
//    cp.async (double-buffered) while tile i is computed; each tile is
//    converted once into hi / lo rows (x, x·suf(s), B, C) that every warp
//    reads with ldmatrix (rows padded by 16 bytes: no bank conflict). The
//    tile's 16 x 16 C·Bᵀ is computed once per CTA (its two column halves by
//    two warps, while the others start on h·Cᵀ), masked with the tile's D
//    table and shared as hi / lo rows, so no warp spends products on
//    another's share.
//  * the tile's decay table is one running product per row t, in
//    registers (a chain of 16 multiplies); four barriers per tile. y is
//    stored straight from the accumulators: each store instruction writes
//    four whole 32-byte sectors.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int L = 16;     // steps per tile: one k-step of mma.m16n8k16

template <int N, int W>
struct SsmSmem {
  static constexpr int PS = 16 * W;    // state rows p of the CTA
  // staging, double-buffered, fp32 as loaded (zero past S and past P)
  float xs[2][L][PS];
  float bs[2][L][N + 4];
  float cs[2][L][N + 4];
  float as[2][L];
  // one tile converted to bf16 hi / lo; rows padded by 8 elements
  __nv_bfloat16 xh[L][PS + 8], xl[L][PS + 8];    // x          [s][p]
  __nv_bfloat16 th[L][PS + 8], tl[L][PS + 8];    // x · suf(s) [s][p]
  __nv_bfloat16 bh[L][N + 8], bl[L][N + 8];      // B          [s][n]
  __nv_bfloat16 ch[L][N + 8], cl[L][N + 8];      // C          [t][n]
  __nv_bfloat16 gh[L][L + 8], gl[L][L + 8];      // (C Bᵀ ∘ D) [t][s]
  float dmask[L][L];                             // D(s, t) at [t][s]; 0 if s > t
  float pre[L];                                  // Π_{b≤m≤t} a_m
};

template <int N, int W>
__global__ void __launch_bounds__(32 * W, (N <= 64 ? 16 : 8) / W)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ B_in,
                const float* __restrict__ C_in,
                const float* __restrict__ decay, float* __restrict__ y,
                int S, int H, int P, int nslices) {
  using Sm = SsmSmem<N, W>;
  constexpr int PS = Sm::PS, NT = 32 * W;
  constexpr int XV = PS / 4, NV = N / 4;         // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int slice = blockIdx.x % nslices;
  const int bh = blockIdx.x / nslices;
  const int b = bh / H;
  const int h = bh % H;
  const int p0 = slice * PS;                     // first state row of the CTA
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int mi = lane >> 3, r8 = lane & 7;       // ldmatrix matrix, row
  const int pw = 16 * warp;                      // warp's rows in the slice
  const size_t row0 = static_cast<size_t>(b) * S;
  const int ntiles = (S + L - 1) / L;

  // a thread's copies are the same in every tile: a 64-bit base per tile,
  // then 32-bit offsets the compiler keeps out of the tile loop
  const int HP = H * P;
  auto load = [&](int c, int buf) {
    const int t0 = c * L;
    const int nt = min(L, S - t0);
    const float* xt = x + ((row0 + t0) * H + h) * P + p0;
    const float* bt = B_in + (row0 + t0) * N;
    const float* ct = C_in + (row0 + t0) * N;
#pragma unroll
    for (int it = 0; it < (L * XV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * XV % NT == 0 || i < L * XV) {
        const int r = i / XV, c4 = (i % XV) * 4;
        const bool ok = r < nt && p0 + c4 < P;
        cp_async16_zfill(&sm.xs[buf][r][c4], ok ? xt + r * HP + c4 : x, ok);
      }
    }
#pragma unroll
    for (int it = 0; it < (L * NV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * NV % NT == 0 || i < L * NV) {
        const int r = i / NV, c4 = (i % NV) * 4;
        const bool ok = r < nt;
        cp_async16_zfill(&sm.bs[buf][r][c4], ok ? bt + r * N + c4 : B_in, ok);
        cp_async16_zfill(&sm.cs[buf][r][c4], ok ? ct + r * N + c4 : C_in, ok);
      }
    }
    if (tid < L)
      cp_async4_zfill(&sm.as[buf][tid],
                      tid < nt ? decay + (row0 + t0 + tid) * H + h : decay,
                      tid < nt);
  };

  // the tile's decays: D(s, t) = Π_{s<m≤t} a_m at dmask[t][s] and
  // pre(t) = Π_{b≤m≤t} a_m, one row t a thread, a running product down s
  auto decays = [&](int c, int buf) {
    const int nt = min(L, S - c * L);
    const int t = tid;
    if (t < L) {
      float a[L];
#pragma unroll
      for (int m = 0; m < L; ++m) a[m] = m < nt ? sm.as[buf][m] : 1.f;
      float d = 1.f;
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {
        sm.dmask[t][s] = s <= t ? d : 0.f;
        if (s <= t) d *= a[s];
      }
      sm.pre[t] = d;
    }
  };
  // staging -> hi / lo rows: x, x·suf(s) with suf(s) = D(s, b+15), B, C
  auto convert = [&](int buf) {
#pragma unroll
    for (int it = 0; it < (L * XV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * XV % NT == 0 || i < L * XV) {
        const int s = i / XV, c4 = (i % XV) * 4;
        const float suf = sm.dmask[L - 1][s];
        const float4 v = *reinterpret_cast<const float4*>(&sm.xs[buf][s][c4]);
        store_split4(&sm.xh[s][c4], &sm.xl[s][c4], v.x, v.y, v.z, v.w);
        store_split4(&sm.th[s][c4], &sm.tl[s][c4], v.x * suf, v.y * suf,
                     v.z * suf, v.w * suf);
      }
    }
#pragma unroll
    for (int it = 0; it < (L * NV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * NV % NT == 0 || i < L * NV) {
        const int r = i / NV, c4 = (i % NV) * 4;
        const float4 vb = *reinterpret_cast<const float4*>(&sm.bs[buf][r][c4]);
        const float4 vc = *reinterpret_cast<const float4*>(&sm.cs[buf][r][c4]);
        store_split4(&sm.bh[r][c4], &sm.bl[r][c4], vb.x, vb.y, vb.z, vb.w);
        store_split4(&sm.ch[r][c4], &sm.cl[r][c4], vc.x, vc.y, vc.z, vc.w);
      }
    }
  };

  // the warp's 16 rows of h: rows pw + g (+8), columns 8j + c2 (+1)
  float hs[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hs[j][e] = 0.f;

  load(0, 0);
  cp_async_commit();
  if (ntiles > 1) load(1, 1);
  cp_async_commit();
  for (int c = 0; c < ntiles; ++c) {
    const int buf = c & 1;
    cp_async_wait<1>();
    __syncthreads();                 // tile c staged; tile c-1 fully read
    decays(c, buf);
    __syncthreads();
    convert(buf);
    __syncthreads();                 // tile c converted; staging[buf] free
    if (c + 2 < ntiles) load(c + 2, buf);
    cp_async_commit();

    // G = (C Bᵀ) ∘ D (M = t, N = s, K = n) once per CTA, the s half jh by
    // warp jh (both by warp 0 when W = 1), into shared memory as the hi / lo
    // B operand of the diagonal product; the other warps start on h·Cᵀ
    for (int jh = warp; jh < 2; jh += W) {
      float ga[2][4] = {};             // even and odd k-steps apart
#pragma unroll
      for (int kk = 0; kk < N / 16; kk += 2) {
        uint32_t bh4[4], bl4[4];
        const int br = 8 * jh + r8, bc = 16 * (kk + (mi >> 1)) + (mi & 1) * 8;
        ldsm_x4(bh4, &sm.bh[br][bc]);  // k-steps kk, kk + 1 (past N at
        ldsm_x4(bl4, &sm.bl[br][bc]);  // N = 16: read, never used)
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          if (kk + k2 >= N / 16) break;
          uint32_t ah[4], al[4];
          const int ar = (mi & 1) * 8 + r8;
          const int ac = 16 * (kk + k2) + (mi >> 1) * 8;
          ldsm_x4(ah, &sm.ch[ar][ac]);
          ldsm_x4(al, &sm.cl[ar][ac]);
          const uint32_t bh2[2] = {bh4[2 * k2], bh4[2 * k2 + 1]};
          const uint32_t bl2[2] = {bl4[2 * k2], bl4[2 * k2 + 1]};
          mma_bf16x3<1>(&ga[k2], ah, al, bh2, bl2);
        }
      }
      const int s = 8 * jh + c2;
      store_split2(&sm.gh[g][s], &sm.gl[g][s],
                   (ga[0][0] + ga[1][0]) * sm.dmask[g][s],
                   (ga[0][1] + ga[1][1]) * sm.dmask[g][s + 1]);
      store_split2(&sm.gh[g + 8][s], &sm.gl[g + 8][s],
                   (ga[0][2] + ga[1][2]) * sm.dmask[g + 8][s],
                   (ga[0][3] + ga[1][3]) * sm.dmask[g + 8][s + 1]);
    }

    // yᵀ[p, t]: h·Cᵀ (M = p, K = n, N = t), scaled by pre(t) ...
    float yk[2][2][4] = {};          // even and odd k-steps apart
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t ah[4], al[4], bh4[4], bl4[4];
      split_bf16x2(hs[2 * kk][0], hs[2 * kk][1], ah[0], al[0]);
      split_bf16x2(hs[2 * kk][2], hs[2 * kk][3], ah[1], al[1]);
      split_bf16x2(hs[2 * kk + 1][0], hs[2 * kk + 1][1], ah[2], al[2]);
      split_bf16x2(hs[2 * kk + 1][2], hs[2 * kk + 1][3], ah[3], al[3]);
      const int br = (mi >> 1) * 8 + r8, bc = 16 * kk + (mi & 1) * 8;
      ldsm_x4(bh4, &sm.ch[br][bc]);
      ldsm_x4(bl4, &sm.cl[br][bc]);
      mma_bf16x3<2>(yk[kk & 1], ah, al, bh4, bl4);
    }
    float ya[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float q0 = sm.pre[8 * j + c2], q1 = sm.pre[8 * j + c2 + 1];
      ya[j][0] = (yk[0][j][0] + yk[1][j][0]) * q0;
      ya[j][1] = (yk[0][j][1] + yk[1][j][1]) * q1;
      ya[j][2] = (yk[0][j][2] + yk[1][j][2]) * q0;
      ya[j][3] = (yk[0][j][3] + yk[1][j][3]) * q1;
    }
    __syncthreads();                 // G in shared memory
    // ... plus the diagonal block Xᵀ (C Bᵀ ∘ D)ᵀ (M = p, K = s, N = t)
    {
      uint32_t xah[4], xal[4], gbh[4], gbl[4];
      const int ar = (mi >> 1) * 8 + r8, ac = pw + (mi & 1) * 8;
      ldsm_x4_trans(xah, &sm.xh[ar][ac]);
      ldsm_x4_trans(xal, &sm.xl[ar][ac]);
      const int br = (mi >> 1) * 8 + r8, bc = (mi & 1) * 8;
      ldsm_x4(gbh, &sm.gh[br][bc]);
      ldsm_x4(gbl, &sm.gl[br][bc]);
      mma_bf16x3<2>(ya, xah, xal, gbh, gbl);
    }
    const int t0 = c * L;
    const int nt = min(L, S - t0);
    float* yt = y + ((row0 + t0) * H + h) * P + p0 + pw + g;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * j + c2 + (e & 1);
        if (t < nt && p0 + pw + g + 8 * (e >> 1) < P)
          yt[t * HP + 8 * (e >> 1)] = ya[j][e];
      }

    // h <- T h + X̃ᵀ B (M = p, K = s, N = n)
    const float T = sm.pre[L - 1];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[j][e] *= T;
    uint32_t tah[4], tal[4];
    {
      const int ar = (mi >> 1) * 8 + r8, ac = pw + (mi & 1) * 8;
      ldsm_x4_trans(tah, &sm.th[ar][ac]);
      ldsm_x4_trans(tal, &sm.tl[ar][ac]);
    }
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t bh4[4], bl4[4];
      const int br = (mi & 1) * 8 + r8, bc = 16 * nn + (mi >> 1) * 8;
      ldsm_x4_trans(bh4, &sm.bh[br][bc]);
      ldsm_x4_trans(bl4, &sm.bl[br][bc]);
      mma_bf16x3<2>(&hs[2 * nn], tah, tal, bh4, bl4);
    }
  }
}

// Warps per CTA (16 state rows each): enough for P (1, 2 or 4), then
// narrower while B·H·slices would leave fewer than two CTAs an SM.
int pick_warps(int BH, int P) {
  int w = P <= 16 ? 1 : P <= 32 ? 2 : 4;
  const long want = 2L * sm_count();
  while (w > 1 && static_cast<long>(BH) * ((P + 16 * w - 1) / (16 * w)) < want)
    w /= 2;
  return w;
}

template <int N, int W>
cudaError_t launch(const float* x, const float* B_in, const float* C_in,
                   const float* decay, float* y, int B, int S, int H, int P,
                   cudaStream_t stream) {
  const size_t smem = sizeof(SsmSmem<N, W>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<N, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nslices = (P + 16 * W - 1) / (16 * W);
  ssm_scan_kernel<N, W><<<B * H * nslices, 32 * W, smem, stream>>>(
      x, B_in, C_in, decay, y, S, H, P, nslices);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const float* x, const float* B_in, const float* C_in,
                     const float* decay, float* y, int B, int S, int H, int P,
                     cudaStream_t stream) {
  switch (pick_warps(B * H, P)) {
    case 1: return launch<N, 1>(x, B_in, C_in, decay, y, B, S, H, P, stream);
    case 2: return launch<N, 2>(x, B_in, C_in, decay, y, B, S, H, P, stream);
    default: return launch<N, 4>(x, B_in, C_in, decay, y, B, S, H, P, stream);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched); cudaErrorInvalidValue for a
// state size N the kernel is not instantiated for, or P not a multiple of 8
// in [8, 256].
extern "C" int ssm_scan_f32(const void* x, const void* B_in, const void* C_in,
                            const void* decay, void* y, int B, int S, int H,
                            int P, int N, void* stream) {
  using namespace repro_torch;
  if (P % 8 != 0 || P < 8 || P > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(B_in);
  const auto* cf = static_cast<const float*>(C_in);
  const auto* af = static_cast<const float*>(decay);
  auto* yf = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return static_cast<int>(launch_n<16>(xf, bf, cf, af, yf, B, S, H, P, st));
    case 32: return static_cast<int>(launch_n<32>(xf, bf, cf, af, yf, B, S, H, P, st));
    case 64: return static_cast<int>(launch_n<64>(xf, bf, cf, af, yf, B, S, H, P, st));
    case 128: return static_cast<int>(launch_n<128>(xf, bf, cf, af, yf, B, S, H, P, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ===========================================================================
// The backward: ssm_scan_bwd_f32
//
// Replaces no TPU kernel: the reference differentiates its lax.scan
// (repro/models/ssm.py, mamba_forward with use_pallas_kernels=False) and
// has no backward kernel. The port's forward is the kernel above, so its
// gradient is this second kernel, behind the autograd Function of
// kernels/ssm_scan.py. With g_t = dL/dh_t (g_S = 0) and dy the gradient
// of y, all fp32:
//     g_t = decay_{t+1} g_{t+1} + dy_t ⊗ C_t
//     dx_t = g_t B_t ;  dB_t = Σ_{h,p} g_t x_t ;  dC_t = Σ_{h,p} h_t dy_t
//     ddecay_t = Σ_{p,n} g_t ⊙ h_{t-1}
// Both recurrences are elementwise over the (P, N) state; only the four
// outputs reduce. A simple design, right first:
//  * one CTA of 256 threads per (batch, head, slice of R = min(1024 / N, P)
//    state rows); each thread owns one column n and 4 rows of the slice.
//  * pass 1 runs the forward recurrence and stores the state before every
//    tile of L = 8 steps in global scratch (4 KB a CTA and tile).
//  * pass 2 walks the tiles in reverse: it reloads the tile's boundary
//    state, recomputes the tile's 8 states into shared memory (never
//    h_t / decay_t: a decay may be exactly 0), runs the adjoint recurrence
//    back through the tile into shared memory, then computes the tile's
//    outputs as dot products over shared memory: dx (its rows are the
//    CTA's own), and per-CTA partials of dB, dC and ddecay.
//  * in both passes the next tile's operands are loaded into registers
//    while the current tile is computed, then staged in shared memory.
//  * a second launch (sum_partials) adds the partials over heads and
//    slices in a fixed order: no atomics, so two calls agree bit for bit.
// What bounds it: bytes, 0.83 GB of operands at zamba2's B=8, S=2048
// (0.25 ms), under the same rule as the forward: the chunked form's
// products on the tensor cores (12·P·N + 8·16·P a batch, step and head,
// 60 GFLOP: 0.06 ms at 989 TFLOP/s). This design runs the sequential form
// instead, ~14·P·N fp32 flops a (batch, step, head) on the CUDA cores
// (0.90 ms at 67 TFLOP/s): the chunked tensor-core form is its redesign.
// It also recomputes the forward once, moves every product through shared
// memory and runs each CTA's steps in one dependent chain; its 76 KB of
// shared memory allow three CTAs an SM, whose chains hide each other's
// latency.
// ===========================================================================
namespace repro_torch {
namespace {

// Shared floats of a backward CTA of R rows over N columns: the states and
// adjoints of a tile (rows padded to N + 1: conflict-free row reads), then
// the staged operands.
__host__ __device__ constexpr size_t ssm_bwd_smem_floats(int R, int N) {
  return static_cast<size_t>(2 * BWD_L + 1) * R * (N + 1) +
         2 * BWD_L * R + 2 * BWD_L * N + BWD_L + 1;
}

// One tile's operands, loaded into registers ahead of their use: the
// thread's share of x and dy (BWD_L x R), of B and C (BWD_L x N), and a
// decay (threads 0..BWD_L).
template <int N>
struct SsmTileRegs {
  static constexpr int XR = (BWD_L * (BWD_ELEMS / N) + BWD_THREADS - 1) /
                            BWD_THREADS;
  static constexpr int BR = (BWD_L * N + BWD_THREADS - 1) / BWD_THREADS;
  float x[XR], dy[XR], b[BR], c[BR], a;
};

template <int N>
__device__ __forceinline__ void ssm_tile_load(
    SsmTileRegs<N>& t, const float* __restrict__ x,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ a, const float* __restrict__ dy, int b, int h,
    int S, int H, int P, int p0, int R, int rows, int t0, bool bwd) {
  const int tid = threadIdx.x;
  const int nt = min(BWD_L, S - t0);
#pragma unroll
  for (int j = 0; j < SsmTileRegs<N>::XR; ++j) {
    const int e = tid + j * BWD_THREADS, i = e / R, r = e - i * R;
    t.x[j] = t.dy[j] = 0.f;
    if (i < nt && r < rows) {
      const long row = ((static_cast<long>(b) * S + t0 + i) * H + h) * P +
                       p0 + r;
      t.x[j] = __ldg(x + row);
      if (bwd) t.dy[j] = __ldg(dy + row);
    }
  }
#pragma unroll
  for (int j = 0; j < SsmTileRegs<N>::BR; ++j) {
    const int e = tid + j * BWD_THREADS, i = e / N, n = e - i * N;
    t.b[j] = t.c[j] = 0.f;
    if (i < nt) {
      const long bt = static_cast<long>(b) * S + t0 + i;
      t.b[j] = __ldg(Bm + bt * N + n);
      if (bwd) t.c[j] = __ldg(Cm + bt * N + n);
    }
  }
  // a_{t0} .. a_{t0+L}: the step after the tile is the next tile's first
  // (0 past the sequence)
  t.a = tid <= BWD_L && t0 + tid < S
            ? __ldg(a + (static_cast<long>(b) * S + t0 + tid) * H + h)
            : 0.f;
}

template <int N>
__device__ __forceinline__ void ssm_tile_store(const SsmTileRegs<N>& t,
                                               float* xs, float* dys,
                                               float* bs, float* cs,
                                               float* as, int R) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < SsmTileRegs<N>::XR; ++j) {
    const int e = tid + j * BWD_THREADS;
    if (e < BWD_L * R) {
      xs[e] = t.x[j];
      dys[e] = t.dy[j];
    }
  }
#pragma unroll
  for (int j = 0; j < SsmTileRegs<N>::BR; ++j) {
    const int e = tid + j * BWD_THREADS;
    if (e < BWD_L * N) {
      bs[e] = t.b[j];
      cs[e] = t.c[j];
    }
  }
  if (tid <= BWD_L) as[tid] = t.a;
}

template <int N>
__global__ void __launch_bounds__(BWD_THREADS)
ssm_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ a,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ pdB, float* __restrict__ pdC,
                    float* __restrict__ pdd, float* hb, int S, int H, int P,
                    int R, int slices) {
  constexpr int L = BWD_L, NP = N + 1, RSTEP = BWD_THREADS / N;
  constexpr int K = BWD_ELEMS / BWD_THREADS;      // rows a thread owns
  extern __shared__ float sm[];
  float* hs = sm;                          // [L+1][R][NP]: h_{t0-1} .. h_{t1-1}
  float* gs = hs + (L + 1) * R * NP;       // [L][R][NP]:  g_{t0} .. g_{t1-1}
  float* xs = gs + L * R * NP;             // [L][R]
  float* dys = xs + L * R;                 // [L][R]
  float* bs = dys + L * R;                 // [L][N]
  float* cs = bs + L * N;                  // [L][N]
  float* as = cs + L * N;                  // [L+1]: a_{t0} .. a_{t0+L}

  const int s = blockIdx.x % slices;
  const int bh = blockIdx.x / slices;
  const int h = bh % H, b = bh / H;
  const int p0 = s * R, rows = min(R, P - p0);
  const int nc = (S + L - 1) / L;
  const int tid = threadIdx.x, n = tid % N, r0 = tid / N;
  const long HS = static_cast<long>(H) * slices;
  float* hbase = hb + static_cast<long>(blockIdx.x) * nc * R * N;
  SsmTileRegs<N> next;

  // pass 1: the forward recurrence; the state before every tile to hb
  float hr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) hr[k] = 0.f;
  ssm_tile_load<N>(next, x, Bm, Cm, a, dy, b, h, S, H, P, p0, R, rows, 0,
                   false);
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L, nt = min(L, S - t0);
    __syncthreads();                 // the last tile is done with smem
    ssm_tile_store<N>(next, xs, dys, bs, cs, as, R);
    __syncthreads();
    if (c + 1 < nc)                  // in flight during this tile
      ssm_tile_load<N>(next, x, Bm, Cm, a, dy, b, h, S, H, P, p0, R, rows,
                       t0 + L, false);
    float* dst = hbase + static_cast<long>(c) * R * N;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = r0 + k * RSTEP;
      if (r < rows) dst[r * N + n] = hr[k];
    }
    for (int i = 0; i < nt; ++i) {
      const float at = as[i], bn = bs[i * N + n];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = r0 + k * RSTEP;
        if (r < rows) hr[k] = fmaf(at, hr[k], xs[i * R + r] * bn);
      }
    }
  }

  // pass 2: the tiles in reverse
  float gr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) gr[k] = 0.f;
  const int warp = tid / 32, lane = tid % 32;
  ssm_tile_load<N>(next, x, Bm, Cm, a, dy, b, h, S, H, P, p0, R, rows,
                   (nc - 1) * L, true);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L, nt = min(L, S - t0);
    __syncthreads();                 // the last tile's products are done
    ssm_tile_store<N>(next, xs, dys, bs, cs, as, R);
    __syncthreads();
    if (c > 0)                       // in flight during this tile
      ssm_tile_load<N>(next, x, Bm, Cm, a, dy, b, h, S, H, P, p0, R, rows,
                       t0 - L, true);
    // the tile's states, recomputed from its boundary
    const float* src = hbase + static_cast<long>(c) * R * N;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = r0 + k * RSTEP;
      if (r < rows) {
        hr[k] = src[r * N + n];
        hs[r * NP + n] = hr[k];
      }
    }
    for (int i = 0; i < nt; ++i) {
      const float at = as[i], bn = bs[i * N + n];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = r0 + k * RSTEP;
        if (r < rows) {
          hr[k] = fmaf(at, hr[k], xs[i * R + r] * bn);
          hs[((i + 1) * R + r) * NP + n] = hr[k];
        }
      }
    }
    // the adjoint, back through the tile
    for (int i = nt - 1; i >= 0; --i) {
      const float an = as[i + 1], cn = cs[i * N + n];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = r0 + k * RSTEP;
        if (r < rows) {
          gr[k] = fmaf(an, gr[k], dys[i * R + r] * cn);
          gs[(i * R + r) * NP + n] = gr[k];
        }
      }
    }
    __syncthreads();
    // dx_t[p] = Σ_n g_t[p, n] B_t[n]: the CTA's own rows (two chains,
    // added in a fixed order)
    for (int e = tid; e < nt * rows; e += BWD_THREADS) {
      const int i = e / rows, r = e - i * rows;
      const float* g = gs + (i * R + r) * NP;
      const float* bb = bs + i * N;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int nn = 0; nn < N; nn += 2) {
        a0 = fmaf(g[nn], bb[nn], a0);
        a1 = fmaf(g[nn + 1], bb[nn + 1], a1);
      }
      dx[((static_cast<long>(b) * S + t0 + i) * H + h) * P + p0 + r] =
          a0 + a1;
    }
    // dB and dC over the slice's rows: partials (B, S, H, slices, N)
    for (int e = tid; e < nt * N; e += BWD_THREADS) {
      const int i = e / N, nn = e - i * N;
      float db = 0.f, dc = 0.f;
      for (int r = 0; r < rows; ++r) {
        db = fmaf(gs[(i * R + r) * NP + nn], xs[i * R + r], db);
        dc = fmaf(hs[((i + 1) * R + r) * NP + nn], dys[i * R + r], dc);
      }
      const long o = ((static_cast<long>(b) * S + t0 + i) * HS +
                      static_cast<long>(h) * slices + s) * N + nn;
      pdB[o] = db;
      pdC[o] = dc;
    }
    // ddecay over the slice: one warp a step, partials (B, S, H, slices)
    for (int i = warp; i < nt; i += BWD_THREADS / 32) {
      float acc = 0.f;
      for (int e = lane; e < rows * N; e += 32) {
        const int r = e / N, nn = e - r * N;
        acc = fmaf(gs[(i * R + r) * NP + nn], hs[(i * R + r) * NP + nn], acc);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0)
        pdd[((static_cast<long>(b) * S + t0 + i) * H + h) * slices + s] = acc;
    }
  }
}

// The backward's scratch, one fp32 buffer: the state before every tile of
// every CTA (at 0), then the per-(head, slice) partials of dB and dC (B, S,
// H, slices, N) and of ddecay (B, S, H, slices). Offsets and size in floats.
struct SsmBwdScratch {
  int64_t pdB, pdC, pdd, floats;
};

inline SsmBwdScratch ssm_bwd_scratch(int64_t B, int64_t S, int64_t H, int P,
                                     int N) {
  const int64_t parts = B * S * H * bwd_slices(P, N);
  SsmBwdScratch s;
  s.pdB = bwd_state_floats(B, S, H, P, N);
  s.pdC = s.pdB + parts * N;
  s.pdd = s.pdC + parts * N;
  s.floats = s.pdd + parts;
  return s;
}

template <int N>
cudaError_t launch_bwd(const float* x, const float* Bm, const float* Cm,
                       const float* a, const float* dy, float* dx, float* dB,
                       float* dC, float* dd, float* scratch, int B, int S,
                       int H, int P, cudaStream_t stream) {
  const int R = bwd_rows(P, N), slices = bwd_slices(P, N);
  const SsmBwdScratch sc = ssm_bwd_scratch(B, S, H, P, N);
  float *pdB = scratch + sc.pdB, *pdC = scratch + sc.pdC,
        *pdd = scratch + sc.pdd;
  const size_t smem = ssm_bwd_smem_floats(R, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<N><<<B * H * slices, BWD_THREADS, smem, stream>>>(
      x, Bm, Cm, a, dy, dx, pdB, pdC, pdd, scratch, S, H, P, R, slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long BS = static_cast<long>(B) * S;
  if ((err = sum_partials(pdB, dB, BS, H * slices, N, stream)) != cudaSuccess)
    return err;
  if ((err = sum_partials(pdC, dC, BS, H * slices, N, stream)) != cudaSuccess)
    return err;
  return sum_partials(pdd, dd, BS * H, slices, 1, stream);
}

}  // namespace
}  // namespace repro_torch

// The fp32 scratch the backward needs for these sizes (floats), or -1 for a
// P or N it is not instantiated for.
extern "C" int64_t ssm_scan_bwd_scratch_floats(int B, int S, int H, int P,
                                               int N) {
  if (P % 8 != 0 || P < 8 || P > 256 ||
      (N != 16 && N != 32 && N != 64 && N != 128))
    return -1;
  return repro_torch::ssm_bwd_scratch(B, S, H, P, N).floats;
}

// Plain C entry point of the backward (bound with ctypes): gradients dx
// (B, S, H, P), dB / dC (B, S, N) and ddecay (B, S, H), fp32, of the
// forward above for dy (B, S, H, P). `scratch` holds `scratch_floats`
// fp32 values, at least ssm_scan_bwd_scratch_floats(B, S, H, P, N).
// Launches on `stream` (the kernel, then three fixed-order sums) and
// returns cudaGetLastError() as an int; cudaErrorInvalidValue for an N or
// P the forward is not instantiated for, or too small a scratch.
extern "C" int ssm_scan_bwd_f32(const void* x, const void* B_in,
                                const void* C_in, const void* decay,
                                const void* dy, void* dx, void* dB, void* dC,
                                void* ddecay, void* scratch,
                                int64_t scratch_floats, int B, int S, int H,
                                int P, int N, void* stream) {
  using namespace repro_torch;
  const int64_t need = ssm_scan_bwd_scratch_floats(B, S, H, P, N);
  if (need < 0 || scratch_floats < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(B_in);
  const auto* cf = static_cast<const float*>(C_in);
  const auto* af = static_cast<const float*>(decay);
  const auto* gy = static_cast<const float*>(dy);
  auto* o_dx = static_cast<float*>(dx);
  auto* o_db = static_cast<float*>(dB);
  auto* o_dc = static_cast<float*>(dC);
  auto* o_dd = static_cast<float*>(ddecay);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_SSM_BWD(NN)                                                    \
  launch_bwd<NN>(xf, bf, cf, af, gy, o_dx, o_db, o_dc, o_dd, sc, B, S, H, P, \
                 st)
  switch (N) {
    case 16: return static_cast<int>(REPRO_SSM_BWD(16));
    case 32: return static_cast<int>(REPRO_SSM_BWD(32));
    case 64: return static_cast<int>(REPRO_SSM_BWD(64));
    default: return static_cast<int>(REPRO_SSM_BWD(128));
  }
#undef REPRO_SSM_BWD
}
