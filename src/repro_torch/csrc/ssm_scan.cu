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
//
// The chunked form, on the forward's tiles [b, e] of L = 16 steps. With
// H0 = h_{b-1}, Gc = decay_{e+1} g_{e+1}, D(s, t), pre(t) = D(b-1, t) and
// suf(t) = D(t, e) as in the forward, and V[t, s] = (dy_t·x_s) D(s, t):
//     dx_t = suf(t) Gc B_t + Σ_{s≥t} (C_s·B_t) D(t, s) dy_s
//     dB_t = suf(t) x_t Gc + Σ_{s≥t} V[s, t] C_s     (then over h and p)
//     dC_t = pre(t) dy_t H0 + Σ_{s≤t} V[t, s] B_s
//     the tile before's Gc = pre(e) Gc + Σ_s pre(s) dy_s ⊗ C_s
// and ddecay_t = ⟨g_t, h_{t-1}⟩ expanded over the tile into four terms:
//     suf(t) pre(t-1) ⟨Gc, H0⟩ + suf(t) Σ_{s'<t} D(s', t-1) x_{s'}·(Gc B_{s'})
//     + pre(t-1) Σ_{s≥t} D(t, s) dy_s·(H0 C_s)
//     + Σ_{s≥t>s'} D(t, s) D(s', t-1) (dy_s·x_{s'}) (C_s·B_{s'})
// Every factor is a running product of decays in [0, 1]: no decay is ever
// divided out (a decay may be exactly 0). kernels/ssm_scan.py
// `ssm_scan_bwd_chunked_plain` is this algorithm in plain PyTorch, which
// the CPU tests hold against the step loop and jax.grad.
//
// What bounds it on an H100: bytes. x, dy, dx (B, S, H, P), B, C, dB, dC
// (B, S, N) and decay, ddecay (B, S, H), each read or written once: 0.83 GB
// at zamba2's B=8, S=2048, H=64, P=N=64, 0.248 ms at 3.35 TB/s. The
// products above are 12·P·N + 8·16·P flops a step and head plus 2·16·N a
// step, 60 GFLOP there (0.061 ms at the bf16 peak, one pass). Beyond those
// bytes the kernel writes the state before every tile to scratch in pass 1
// and reads it back in pass 2 (1.07 GB each way there), and writes and
// sums the per-CTA partials of dB, dC and ddecay (0.54 GB): ~4.3 GB in
// all, which with pass 2's latency chain is what it spends its time on.
//
// What the design does about it:
//  * one CTA per (batch, head, slice of 16·W state rows p), W = P / 16 up
//    to 4 (bwd_warps); each warp keeps its 16 rows of h (pass 1) and of the
//    adjoint Gc (pass 2) in mma accumulators, split into bf16 hi + lo where
//    they are an A operand; every product runs the forward's three bf16
//    passes (mma_bf16x3).
//  * pass 1 is its own launch with the forward's small footprint (four
//    CTAs an SM): the forward without y, h <- pre(e) h + X̃ᵀ B tile by
//    tile, the state before each tile stored straight from the
//    accumulators in fragment order (whole lines). Pass 2 walks the tiles
//    in reverse, each thread reading back what the same thread of pass 1
//    wrote.
//  * per tile of pass 2, per warp (its rows): Gc Bᵀ and H0 Cᵀ, then dx =
//    suf ∘ Gc Bᵀ + dYᵀ G from the accumulators; the row sums of X ∘ Gc Bᵀ
//    and dY ∘ H0 Cᵀ for ddecay; Gc <- pre(e) Gc + dỸᵀ C. Per CTA: C Bᵀ and
//    dY Xᵀ (16 x 16: raw in fp32, masked with D as hi / lo), and dB, dC
//    over all its rows (K = p: H0 and Gc go to shared memory as hi / lo
//    rows for it), the warps taking the N columns 16 at a time; ddecay's
//    four terms on the CUDA cores in one warp, the double sum through a
//    16-step recursion per row, every factor read from the tile's decay
//    table.
//  * x, dy, B, C and the decays of the tile after next are copied with
//    cp.async (double-buffered, as the forward's) once a tile is converted;
//    H0 is read into registers while the tile's last products run. Four
//    barriers a tile.
//  * dx is the CTA's own rows; dB and dC (over heads and slices) and
//    ddecay (over slices) leave per-CTA partials that a third launch adds
//    in a fixed order (sum_partials): no atomics, so two calls agree bit
//    for bit.
// ===========================================================================
namespace repro_torch {
namespace {

template <int N, int W>
struct SsmBwdSmem {
  static constexpr int PS = 16 * W;    // state rows p of the CTA
  // staging, double-buffered, fp32 as loaded (zero past S and past P)
  float xs[2][L][PS], dys[2][L][PS];
  float bs[2][L][N], cs[2][L][N];
  float as[2][L];
  // one tile converted to bf16 hi / lo; rows padded by 8 elements
  __nv_bfloat16 xh[L][PS + 8], xl[L][PS + 8];    // x [s][p]; pass 1 x·suf(s)
  __nv_bfloat16 yh[L][PS + 8], yl[L][PS + 8];    // dy [s][p]
  __nv_bfloat16 th[L][PS + 8], tl[L][PS + 8];    // dy·pre(s) [s][p]
  __nv_bfloat16 bh[L][N + 8], bl[L][N + 8];      // B [s][n]
  __nv_bfloat16 ch[L][N + 8], cl[L][N + 8];      // C [s][n]
  __nv_bfloat16 hh[PS][N + 8], hl[PS][N + 8];    // H0 [p][n]
  __nv_bfloat16 gch[PS][N + 8], gcl[PS][N + 8];  // Gc [p][n]
  __nv_bfloat16 gh[L][L + 8], gl[L][L + 8];      // C Bᵀ ∘ D [t][s]
  __nv_bfloat16 vh[L][L + 8], vl[L][L + 8];      // V = dY Xᵀ ∘ D [t][s]
  float cb[L][L + 1], dyx[L][L + 1];             // C Bᵀ, dY Xᵀ [s][s']
  float rt[L][L + 1];                            // R_t[s] for ddecay, [t][s]
  float dmask[L][L];                             // D(s, t) at [t][s]; 0 if s > t
  float pre[L];                                  // Π_{b≤m≤t} a_m
  float q1[W][L], q2[W][L], gh0[W];              // per-warp sums for ddecay
};

// One tile's staging copies (cp.async; zero past S and past P): x, B and
// the decays, and with kBwd also dy and C.
template <int N, int W, bool kBwd, typename Sm>
__device__ __forceinline__ void ssm_bwd_load(
    Sm& sm, const float* __restrict__ x, const float* __restrict__ B_in,
    const float* __restrict__ C_in, const float* __restrict__ decay,
    const float* __restrict__ dy, int c, int buf, size_t row0, int h, int p0,
    int S, int H, int P) {
  constexpr int PS = 16 * W, NT = 32 * W;
  constexpr int XV = PS / 4, NV = N / 4;         // 16-byte vectors per row
  const int tid = threadIdx.x;
  const int HP = H * P;
  const int t0 = c * L;
  const int nt = min(L, S - t0);
  const float* xt = x + ((row0 + t0) * H + h) * P + p0;
  const float* bt = B_in + (row0 + t0) * N;
#pragma unroll
  for (int it = 0; it < (L * XV + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (L * XV % NT == 0 || i < L * XV) {
      const int r = i / XV, c4 = (i % XV) * 4;
      const bool ok = r < nt && p0 + c4 < P;
      cp_async16_zfill(&sm.xs[buf][r][c4], ok ? xt + r * HP + c4 : x, ok);
      if constexpr (kBwd) {
        const float* yt = dy + ((row0 + t0) * H + h) * P + p0;
        cp_async16_zfill(&sm.dys[buf][r][c4], ok ? yt + r * HP + c4 : dy,
                         ok);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < (L * NV + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (L * NV % NT == 0 || i < L * NV) {
      const int r = i / NV, c4 = (i % NV) * 4;
      const bool ok = r < nt;
      cp_async16_zfill(&sm.bs[buf][r][c4], ok ? bt + r * N + c4 : B_in, ok);
      if constexpr (kBwd) {
        const float* ct = C_in + (row0 + t0) * N;
        cp_async16_zfill(&sm.cs[buf][r][c4], ok ? ct + r * N + c4 : C_in,
                         ok);
      }
    }
  }
  if (tid < L)
    cp_async4_zfill(&sm.as[buf][tid],
                    tid < nt ? decay + (row0 + t0 + tid) * H + h : decay,
                    tid < nt);
}

// The tile's decays, as the forward's (threads < L): D(s, t) at
// dmask[t][s] and pre(t); decays past S count as 1.
template <typename Sm>
__device__ __forceinline__ void ssm_bwd_decays(Sm& sm, int buf, int nt) {
  const int t = threadIdx.x;
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
}

// Pass 1's shared memory: x, B and the decays of two tiles as staged, one
// converted.
template <int N, int W>
struct SsmStatesSmem {
  static constexpr int PS = 16 * W;    // state rows p of the CTA
  float xs[2][L][PS];
  float bs[2][L][N];
  float as[2][L];
  __nv_bfloat16 xh[L][PS + 8], xl[L][PS + 8];    // x·suf(s) [s][p]
  __nv_bfloat16 bh[L][N + 8], bl[L][N + 8];      // B [s][n]
  float dmask[L][L];                             // D(s, t) at [t][s]
  float pre[L];                                  // Π_{b≤m≤t} a_m
};

// Pass 1, its own launch (the forward's footprint, so the forward's
// occupancy): the forward recurrence without y, h <- pre(e) h + X̃ᵀ B tile
// by tile, storing the state before every tile to `states` in fragment
// order. Same CTAs and warps as pass 2, whose threads read back what the
// same-numbered threads wrote.
template <int N, int W>
__global__ void __launch_bounds__(32 * W, (N <= 64 ? 16 : 8) / W)
ssm_scan_bwd_states_kernel(const float* __restrict__ x,
                           const float* __restrict__ B_in,
                           const float* __restrict__ decay,
                           float* __restrict__ states, int S, int H, int P,
                           int nslices) {
  using Sm = SsmStatesSmem<N, W>;
  constexpr int PS = Sm::PS, NT = 32 * W;
  constexpr int XV = PS / 4, NV = N / 4;         // 16-byte vectors per row
  constexpr int LX = PS + 8, LN = N + 8;         // bf16 row strides
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int slice = blockIdx.x % nslices;
  const int bh = blockIdx.x / nslices;
  const int h = bh % H;
  const int p0 = slice * PS;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int pw = 16 * warp;
  const size_t row0 = static_cast<size_t>(bh / H) * S;
  const int ntiles = (S + L - 1) / L;
  float* const st = states +
                    static_cast<size_t>(blockIdx.x) * ntiles * PS * N +
                    warp * 16 * N;
  auto load = [&](int c, int buf) {
    ssm_bwd_load<N, W, false>(sm, x, B_in, nullptr, decay, nullptr, c, buf,
                              row0, h, p0, S, H, P);
  };

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
    __syncthreads();                 // tile c staged; tile c-1 done with smem
    state_store<N>(st + static_cast<size_t>(c) * PS * N, hs);
    if (c + 1 == ntiles) break;      // the state after the last tile: unused
    ssm_bwd_decays(sm, buf, min(L, S - c * L));
    __syncthreads();
#pragma unroll
    for (int it = 0; it < (L * XV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * XV % NT == 0 || i < L * XV) {
        const int s = i / XV, c4 = (i % XV) * 4;
        const float suf = sm.dmask[L - 1][s];
        const float4 v = *reinterpret_cast<const float4*>(&sm.xs[buf][s][c4]);
        store_split4(&sm.xh[s][c4], &sm.xl[s][c4], v.x * suf, v.y * suf,
                     v.z * suf, v.w * suf);
      }
    }
#pragma unroll
    for (int it = 0; it < (L * NV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * NV % NT == 0 || i < L * NV) {
        const int r = i / NV, c4 = (i % NV) * 4;
        const float4 v = *reinterpret_cast<const float4*>(&sm.bs[buf][r][c4]);
        store_split4(&sm.bh[r][c4], &sm.bl[r][c4], v.x, v.y, v.z, v.w);
      }
    }
    __syncthreads();                 // tile c converted; staging[buf] free
    if (c + 2 < ntiles) load(c + 2, buf);
    cp_async_commit();
    // h <- pre(e) h + X̃ᵀ B (M = p, K = s, N = n)
    const float T = sm.pre[L - 1];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[j][e] *= T;
    uint32_t ah[4], al[4];
    lda_t(ah, &sm.xh[0][0], LX, pw, 0);
    lda_t(al, &sm.xl[0][0], LX, pw, 0);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t bh4[4], bl4[4];
      ldb2_t(bh4, &sm.bh[0][0], LN, 16 * nn, 0);
      ldb2_t(bl4, &sm.bl[0][0], LN, 16 * nn, 0);
      mma_bf16x3<2>(&hs[2 * nn], ah, al, bh4, bl4);
    }
  }
}

// Pass 2: the tiles in reverse (after ssm_scan_bwd_states_kernel).
template <int N, int W>
__global__ void __launch_bounds__(32 * W, N <= 64 ? 2 : 1)
ssm_scan_bwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ B_in,
                    const float* __restrict__ C_in,
                    const float* __restrict__ decay,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ pdB, float* __restrict__ pdC,
                    float* __restrict__ pdd,
                    const float* __restrict__ states, int S, int H, int P,
                    int nslices) {
  using Sm = SsmBwdSmem<N, W>;
  constexpr int PS = Sm::PS, NT = 32 * W;
  constexpr int XV = PS / 4, NV = N / 4;         // 16-byte vectors per row
  constexpr int LX = PS + 8, LN = N + 8, LL = L + 8;   // bf16 row strides
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
  const int pw = 16 * warp;                      // warp's rows in the slice
  const size_t row0 = static_cast<size_t>(b) * S;
  const int ntiles = (S + L - 1) / L;
  const int HP = H * P;
  // the warp's rows of the state before tile c: st + c · PS · N
  const float* const st = states +
                          static_cast<size_t>(blockIdx.x) * ntiles * PS * N +
                          warp * 16 * N;
  auto load = [&](int c, int buf) {
    ssm_bwd_load<N, W, true>(sm, x, B_in, C_in, decay, dy, c, buf, row0, h,
                             p0, S, H, P);
  };

  // hs holds H0, gc the incoming adjoint
  float hs[N / 8][4];
  float gc[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gc[j][e] = 0.f;
  state_load<N>(hs, st + static_cast<size_t>(ntiles - 1) * PS * N);
  load(ntiles - 1, 0);
  cp_async_commit();
  if (ntiles > 1) load(ntiles - 2, 1);
  cp_async_commit();
  for (int c = ntiles - 1, buf = 0; c >= 0; --c, buf ^= 1) {
    const int t0 = c * L;
    const int nt = min(L, S - t0);
    cp_async_wait<1>();
    __syncthreads();                 // tile c staged; tile c+1 done with smem
    ssm_bwd_decays(sm, buf, nt);
    {   // H0 and Gc as hi / lo rows of the CTA; ⟨Gc, H0⟩ over the warp's rows
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + c2;
        store_split2(&sm.hh[pw + g][n], &sm.hl[pw + g][n], hs[j][0], hs[j][1]);
        store_split2(&sm.hh[pw + g + 8][n], &sm.hl[pw + g + 8][n], hs[j][2],
                     hs[j][3]);
        store_split2(&sm.gch[pw + g][n], &sm.gcl[pw + g][n], gc[j][0],
                     gc[j][1]);
        store_split2(&sm.gch[pw + g + 8][n], &sm.gcl[pw + g + 8][n],
                     gc[j][2], gc[j][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc = fmaf(gc[j][e], hs[j][e], acc);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sm.gh0[warp] = acc;
    }
    __syncthreads();                 // the decay table
    // x, dy, dy·pre(s), B and C as hi / lo rows
#pragma unroll
    for (int it = 0; it < (L * XV + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (L * XV % NT == 0 || i < L * XV) {
        const int s = i / XV, c4 = (i % XV) * 4;
        const float q = sm.pre[s];
        const float4 vx = *reinterpret_cast<const float4*>(&sm.xs[buf][s][c4]);
        const float4 vy =
            *reinterpret_cast<const float4*>(&sm.dys[buf][s][c4]);
        store_split4(&sm.xh[s][c4], &sm.xl[s][c4], vx.x, vx.y, vx.z, vx.w);
        store_split4(&sm.yh[s][c4], &sm.yl[s][c4], vy.x, vy.y, vy.z, vy.w);
        store_split4(&sm.th[s][c4], &sm.tl[s][c4], vy.x * q, vy.y * q,
                     vy.z * q, vy.w * q);
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
    __syncthreads();                 // tile c converted; staging[buf] free
    if (c >= 2) load(c - 2, buf);
    cp_async_commit();

    // per CTA: C Bᵀ (jobs 0, 1: the s halves, K = n) and dY Xᵀ (jobs 2, 3,
    // K = p), raw in fp32 and masked with D as hi / lo; job j by warp j % W
    for (int job = warp; job < 4; job += W) {
      const int jh = job & 1;
      float acc[2][4] = {};            // even and odd k-steps apart
      if (job < 2) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t ah[4], al[4], bh2[2], bl2[2];
          lda(ah, &sm.ch[0][0], LN, 0, 16 * kk);
          lda(al, &sm.cl[0][0], LN, 0, 16 * kk);
          ldb1(bh2, &sm.bh[0][0], LN, 8 * jh, 16 * kk);
          ldb1(bl2, &sm.bl[0][0], LN, 8 * jh, 16 * kk);
          mma_bf16x3<1>(&acc[kk & 1], ah, al, bh2, bl2);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < PS / 16; ++kk) {
          uint32_t ah[4], al[4], bh2[2], bl2[2];
          lda(ah, &sm.yh[0][0], LX, 0, 16 * kk);
          lda(al, &sm.yl[0][0], LX, 0, 16 * kk);
          ldb1(bh2, &sm.xh[0][0], LX, 8 * jh, 16 * kk);
          ldb1(bl2, &sm.xl[0][0], LX, 8 * jh, 16 * kk);
          mma_bf16x3<1>(&acc[kk & 1], ah, al, bh2, bl2);
        }
      }
      float(*raw)[L + 1] = job < 2 ? sm.cb : sm.dyx;
      __nv_bfloat16(*mh)[L + 8] = job < 2 ? sm.gh : sm.vh;
      __nv_bfloat16(*ml)[L + 8] = job < 2 ? sm.gl : sm.vl;
      const int s = 8 * jh + c2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = g + 8 * half;
        const float v0 = acc[0][2 * half] + acc[1][2 * half];
        const float v1 = acc[0][2 * half + 1] + acc[1][2 * half + 1];
        raw[t][s] = v0;
        raw[t][s + 1] = v1;
        store_split2(&mh[t][s], &ml[t][s], v0 * sm.dmask[t][s],
                     v1 * sm.dmask[t][s + 1]);
      }
    }

    // per warp: Gc Bᵀ and H0 Cᵀ (M = p, K = n, N = t)
    float gb[2][4] = {}, hc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t ah[4], al[4], bh4[4], bl4[4];
      acc_to_a<N>(gc, kk, ah, al);
      ldb2(bh4, &sm.bh[0][0], LN, 0, 16 * kk);
      ldb2(bl4, &sm.bl[0][0], LN, 0, 16 * kk);
      mma_bf16x3<2>(gb, ah, al, bh4, bl4);
      acc_to_a<N>(hs, kk, ah, al);
      ldb2(bh4, &sm.ch[0][0], LN, 0, 16 * kk);
      ldb2(bl4, &sm.cl[0][0], LN, 0, 16 * kk);
      mma_bf16x3<2>(hc, ah, al, bh4, bl4);
    }
    // their row sums over the warp's p for ddecay: x_t·(Gc B_t) and
    // dy_t·(H0 C_t), x and dy as hi + lo (lanes g = 0 hold steps
    // 8j + c2 + e)
    auto f2 = [](const __nv_bfloat16& hi, const __nv_bfloat16& lo) {
      return __bfloat162float(hi) + __bfloat162float(lo);
    };
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * j + c2 + e, p = pw + g;
        float s1 = gb[j][e] * f2(sm.xh[t][p], sm.xl[t][p]) +
                   gb[j][2 + e] * f2(sm.xh[t][p + 8], sm.xl[t][p + 8]);
        float s2 = hc[j][e] * f2(sm.yh[t][p], sm.yl[t][p]) +
                   hc[j][2 + e] * f2(sm.yh[t][p + 8], sm.yl[t][p + 8]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (g == 0) {
          sm.q1[warp][t] = s1;
          sm.q2[warp][t] = s2;
        }
      }
    __syncthreads();                 // C Bᵀ, dY Xᵀ, the row sums

    // the next tile's H0, in flight during this tile's last products
    if (c > 0) state_load<N>(hs, st + static_cast<size_t>(c - 1) * PS * N);
    {   // dx = suf(t) Gc Bᵀ + dYᵀ G (M = p, K = s, N = t), the warp's rows
      float da[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          da[j][e] = gb[j][e] * sm.dmask[L - 1][8 * j + c2 + (e & 1)];
      uint32_t ah[4], al[4], bh4[4], bl4[4];
      lda_t(ah, &sm.yh[0][0], LX, pw, 0);
      lda_t(al, &sm.yl[0][0], LX, pw, 0);
      ldb2_t(bh4, &sm.gh[0][0], LL, 0, 0);
      ldb2_t(bl4, &sm.gl[0][0], LL, 0, 0);
      mma_bf16x3<2>(da, ah, al, bh4, bl4);
      float* dxt = dx + ((row0 + t0) * H + h) * P + p0 + pw + g;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * j + c2 + (e & 1);
          if (t < nt && p0 + pw + g + 8 * (e >> 1) < P)
            dxt[t * HP + 8 * (e >> 1)] = da[j][e];
        }
    }
    // dC = pre(t) dY H0 + V B and dB = suf(t) X Gc + Vᵀ C over the CTA's
    // rows (M = t, N = n; K = p, then s), 16 columns per warp in turn
    for (int n16 = warp; n16 < N / 16; n16 += W) {
      float dc[2][2][4] = {}, db[2][2][4] = {};   // even and odd k-steps
#pragma unroll
      for (int kk = 0; kk < PS / 16; ++kk) {
        uint32_t ah[4], al[4], bh4[4], bl4[4];
        lda(ah, &sm.yh[0][0], LX, 0, 16 * kk);
        lda(al, &sm.yl[0][0], LX, 0, 16 * kk);
        ldb2_t(bh4, &sm.hh[0][0], LN, 16 * n16, 16 * kk);
        ldb2_t(bl4, &sm.hl[0][0], LN, 16 * n16, 16 * kk);
        mma_bf16x3<2>(dc[kk & 1], ah, al, bh4, bl4);
        lda(ah, &sm.xh[0][0], LX, 0, 16 * kk);
        lda(al, &sm.xl[0][0], LX, 0, 16 * kk);
        ldb2_t(bh4, &sm.gch[0][0], LN, 16 * n16, 16 * kk);
        ldb2_t(bl4, &sm.gcl[0][0], LN, 16 * n16, 16 * kk);
        mma_bf16x3<2>(db[kk & 1], ah, al, bh4, bl4);
      }
      float oc[2][4], ob[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = g + 8 * (e >> 1);
          oc[j][e] = (dc[0][j][e] + dc[1][j][e]) * sm.pre[t];
          ob[j][e] = (db[0][j][e] + db[1][j][e]) * sm.dmask[L - 1][t];
        }
      uint32_t ah[4], al[4], bh4[4], bl4[4];
      lda(ah, &sm.vh[0][0], LL, 0, 0);
      lda(al, &sm.vl[0][0], LL, 0, 0);
      ldb2_t(bh4, &sm.bh[0][0], LN, 16 * n16, 0);
      ldb2_t(bl4, &sm.bl[0][0], LN, 16 * n16, 0);
      mma_bf16x3<2>(oc, ah, al, bh4, bl4);
      lda_t(ah, &sm.vh[0][0], LL, 0, 0);
      lda_t(al, &sm.vl[0][0], LL, 0, 0);
      ldb2_t(bh4, &sm.ch[0][0], LN, 16 * n16, 0);
      ldb2_t(bl4, &sm.cl[0][0], LN, 16 * n16, 0);
      mma_bf16x3<2>(ob, ah, al, bh4, bl4);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = g + 8 * half;
          if (t < nt) {
            const size_t o = (((row0 + t0 + t) * H + h) * nslices + slice) *
                                 N + 16 * n16 + 8 * j + c2;
            *reinterpret_cast<float2*>(pdC + o) =
                make_float2(oc[j][2 * half], oc[j][2 * half + 1]);
            *reinterpret_cast<float2*>(pdB + o) =
                make_float2(ob[j][2 * half], ob[j][2 * half + 1]);
          }
        }
    }
    // ddecay over the CTA's rows (the last warp): the four terms of the
    // header, the per-warp sums added in a fixed order. The double sum
    // through R_t[s] = Σ_{s'<t} D(s', t-1) (dy_s·x_{s'}) (C_s·B_{s'}), one
    // lane s a row: R_{t+1}[s] = a_t R_t[s] + (dy_s·x_t) (C_s·B_t); then
    // lanes t (< 16) take the terms with q1, q2 and lanes 16 + t the double
    // sum, added by one shuffle.
    if (warp == W - 1) {
      if (lane < L) {
        const int s = lane;
        float R = 0.f, q1 = 0.f, q2 = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          q1 += sm.q1[w][s];
          q2 += sm.q2[w][s];
        }
        sm.q1[0][s] = q1;
        sm.q2[0][s] = q2;
#pragma unroll
        for (int t = 0; t < L; ++t) {
          sm.rt[t][s] = R;
          R = fmaf(t > 0 ? sm.dmask[t][t - 1] : 0.f, R,
                   sm.dyx[s][t] * sm.cb[s][t]);
        }
      }
      __syncwarp();
      const int t = lane & (L - 1);
      float acc = 0.f;
      if (lane < L) {
        float gsum = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) gsum += sm.gh0[w];
        const float suf = sm.dmask[L - 1][t];
        const float pm1 = t > 0 ? sm.pre[t - 1] : 1.f;
        float t2 = 0.f, t3 = 0.f;
#pragma unroll
        for (int s = 0; s < L; ++s) {
          if (s < t) t2 = fmaf(sm.dmask[t - 1][s], sm.q1[0][s], t2);
          if (s >= t) t3 = fmaf(sm.dmask[s][t], sm.q2[0][s], t3);
        }
        acc = suf * pm1 * gsum + suf * t2 + pm1 * t3;
      } else {
#pragma unroll
        for (int s = 0; s < L; ++s)
          if (s >= t) acc = fmaf(sm.dmask[s][t], sm.rt[t][s], acc);
      }
      acc += __shfl_down_sync(0xffffffffu, acc, L);
      if (lane < nt)
        pdd[((row0 + t0 + lane) * H + h) * nslices + slice] = acc;
    }
    {   // Gc <- pre(e) Gc + dỸᵀ C (M = p, K = s, N = n)
      const float T = sm.pre[L - 1];
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gc[j][e] *= T;
      uint32_t ah[4], al[4];
      lda_t(ah, &sm.th[0][0], LX, pw, 0);
      lda_t(al, &sm.tl[0][0], LX, pw, 0);
#pragma unroll
      for (int nn = 0; nn < N / 16; ++nn) {
        uint32_t bh4[4], bl4[4];
        ldb2_t(bh4, &sm.ch[0][0], LN, 16 * nn, 0);
        ldb2_t(bl4, &sm.cl[0][0], LN, 16 * nn, 0);
        mma_bf16x3<2>(&gc[2 * nn], ah, al, bh4, bl4);
      }
    }
  }
}

// Warps per backward CTA (16 state rows each): enough for P, up to 4. Not
// narrowed at small B·H as the forward's: a CTA's time is its chain of
// tiles, whose per-CTA products the warps share, so a wider CTA covers
// more rows in the same time.
int bwd_warps(int P) { return P <= 16 ? 1 : P <= 32 ? 2 : 4; }

// The backward's geometry and scratch, one fp32 buffer: the state before
// every tile of every CTA (at 0), then the per-(head, slice) partials of dB
// and dC (B, S, H, slices, N) and of ddecay (B, S, H, slices). Offsets and
// size in floats.
struct SsmBwdScratch {
  int warps, slices;
  int64_t pdB, pdC, pdd, floats;
};

inline SsmBwdScratch ssm_bwd_scratch(int64_t B, int64_t S, int64_t H, int P,
                                     int N) {
  SsmBwdScratch s;
  s.warps = bwd_warps(P);
  s.slices = (P + 16 * s.warps - 1) / (16 * s.warps);
  const int64_t parts = B * S * H * s.slices;
  s.pdB = B * H * s.slices * ((S + L - 1) / L) * 16 * s.warps * N;
  s.pdC = s.pdB + parts * N;
  s.pdd = s.pdC + parts * N;
  s.floats = s.pdd + parts;
  return s;
}

template <int N, int W>
cudaError_t launch_bwd(const float* x, const float* Bm, const float* Cm,
                       const float* a, const float* dy, float* dx, float* dB,
                       float* dC, float* dd, float* scratch,
                       const SsmBwdScratch& sc, int B, int S, int H, int P,
                       cudaStream_t stream) {
  const size_t smem = sizeof(SsmBwdSmem<N, W>);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const size_t smem1 = sizeof(SsmStatesSmem<N, W>);
  if (smem1 > 48 * 1024 &&
      (err = cudaFuncSetAttribute(ssm_scan_bwd_states_kernel<N, W>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem1))) != cudaSuccess)
    return err;
  float *pdB = scratch + sc.pdB, *pdC = scratch + sc.pdC,
        *pdd = scratch + sc.pdd;
  const int ctas = B * H * sc.slices;
  ssm_scan_bwd_states_kernel<N, W><<<ctas, 32 * W, smem1, stream>>>(
      x, Bm, a, scratch, S, H, P, sc.slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssm_scan_bwd_kernel<N, W><<<ctas, 32 * W, smem, stream>>>(
      x, Bm, Cm, a, dy, dx, pdB, pdC, pdd, scratch, S, H, P, sc.slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long BS = static_cast<long>(B) * S;
  if ((err = sum_partials(pdB, dB, BS, H * sc.slices, N, stream)) !=
      cudaSuccess)
    return err;
  if ((err = sum_partials(pdC, dC, BS, H * sc.slices, N, stream)) !=
      cudaSuccess)
    return err;
  return sum_partials(pdd, dd, BS * H, sc.slices, 1, stream);
}

template <int N>
cudaError_t launch_bwd_n(const float* x, const float* Bm, const float* Cm,
                         const float* a, const float* dy, float* dx,
                         float* dB, float* dC, float* dd, float* scratch,
                         const SsmBwdScratch& sc, int B, int S, int H, int P,
                         cudaStream_t stream) {
  switch (sc.warps) {
    case 1: return launch_bwd<N, 1>(x, Bm, Cm, a, dy, dx, dB, dC, dd, scratch,
                                    sc, B, S, H, P, stream);
    case 2: return launch_bwd<N, 2>(x, Bm, Cm, a, dy, dx, dB, dC, dd, scratch,
                                    sc, B, S, H, P, stream);
    default: return launch_bwd<N, 4>(x, Bm, Cm, a, dy, dx, dB, dC, dd,
                                     scratch, sc, B, S, H, P, stream);
  }
}

// The occupancy of the backward's two launches at W warps: out[2] / out[3]
// pass 2's dynamic shared bytes / CTAs an SM, out[5] / out[6] pass 1's.
template <int N, int W>
cudaError_t bwd_design(int64_t* out) {
  const size_t smem = sizeof(SsmBwdSmem<N, W>);
  const size_t smem1 = sizeof(SsmStatesSmem<N, W>);
  int per_sm = 0, per_sm1 = 0;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssm_scan_bwd_kernel<N, W>, 32 * W, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_scan_bwd_states_kernel<N, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm1, ssm_scan_bwd_states_kernel<N, W>, 32 * W, smem1);
  out[2] = static_cast<int64_t>(smem);
  out[3] = per_sm;
  out[5] = static_cast<int64_t>(smem1);
  out[6] = per_sm1;
  return err;
}

template <int N>
cudaError_t bwd_design_n(int W, int64_t* out) {
  return W == 1 ? bwd_design<N, 1>(out) : W == 2 ? bwd_design<N, 2>(out)
                                                 : bwd_design<N, 4>(out);
}

bool bwd_shape_ok(int P, int N) {
  return P % 8 == 0 && P >= 8 && P <= 256 &&
         (N == 16 || N == 32 || N == 64 || N == 128);
}

}  // namespace
}  // namespace repro_torch

// The fp32 scratch the backward needs for these sizes (floats), or -1 for a
// P or N it is not instantiated for.
extern "C" int64_t ssm_scan_bwd_scratch_floats(int B, int S, int H, int P,
                                               int N) {
  if (!repro_torch::bwd_shape_ok(P, N)) return -1;
  return repro_torch::ssm_bwd_scratch(B, S, H, P, N).floats;
}

// The backward's launches at these sizes, for reports: out[0..6] = warps a
// CTA, CTAs (the grid, both passes), pass 2's dynamic shared bytes a CTA
// and CTAs an SM (occupancy query), the scratch floats kept for the
// states, pass 1's shared bytes and CTAs an SM. Returns
// cudaErrorInvalidValue for a P or N it is not instantiated for.
extern "C" int ssm_scan_bwd_design(int B, int S, int H, int P, int N,
                                   int64_t* out) {
  using namespace repro_torch;
  if (!bwd_shape_ok(P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const SsmBwdScratch sc = ssm_bwd_scratch(B, S, H, P, N);
  out[0] = sc.warps;
  out[1] = static_cast<int64_t>(B) * H * sc.slices;
  out[4] = sc.pdB;
  const cudaError_t err =
      N == 16 ? bwd_design_n<16>(sc.warps, out)
      : N == 32 ? bwd_design_n<32>(sc.warps, out)
      : N == 64 ? bwd_design_n<64>(sc.warps, out)
                : bwd_design_n<128>(sc.warps, out);
  return static_cast<int>(err);
}

// Plain C entry point of the backward (bound with ctypes): gradients dx
// (B, S, H, P), dB / dC (B, S, N) and ddecay (B, S, H), fp32, of the
// forward above for dy (B, S, H, P). `scratch` holds `scratch_floats`
// fp32 values, at least ssm_scan_bwd_scratch_floats(B, S, H, P, N).
// Launches on `stream` (pass 1, pass 2, then three fixed-order sums) and
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
  const SsmBwdScratch sc = ssm_bwd_scratch(B, S, H, P, N);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(B_in);
  const auto* cf = static_cast<const float*>(C_in);
  const auto* af = static_cast<const float*>(decay);
  const auto* gy = static_cast<const float*>(dy);
  auto* o_dx = static_cast<float*>(dx);
  auto* o_db = static_cast<float*>(dB);
  auto* o_dc = static_cast<float*>(dC);
  auto* o_dd = static_cast<float*>(ddecay);
  auto* scr = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_SSM_BWD(NN)                                                   \
  launch_bwd_n<NN>(xf, bf, cf, af, gy, o_dx, o_db, o_dc, o_dd, scr, sc, B, \
                   S, H, P, st)
  switch (N) {
    case 16: return static_cast<int>(REPRO_SSM_BWD(16));
    case 32: return static_cast<int>(REPRO_SSM_BWD(32));
    case 64: return static_cast<int>(REPRO_SSM_BWD(64));
    default: return static_cast<int>(REPRO_SSM_BWD(128));
  }
#undef REPRO_SSM_BWD
}
