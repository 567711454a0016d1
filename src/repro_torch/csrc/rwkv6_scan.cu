// RWKV6 (Finch) recurrence, bf16 or fp32 inputs, fp32 state and output.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py `_rwkv6_kernel`
// (wrapper `rwkv6_scan`, pallas_call at :62) with the entry points
// `rwkv6_scan_bf16` and `rwkv6_scan_f32`. Same contract: r, k, v, w
// (B, S, H, P) in the model dtype, u (H, P) fp32; writes y (B, S, H, P)
// fp32 with
//     y_t = r_t · S + (r_t · (u ⊙ k_t)) v_t ;   S <- diag(w_t) S + k_t ⊗ v_t
// and one (P, P) fp32 state per (batch, head) starting at zero. The TPU
// wrapper pads S to whole VMEM chunks with w = 1; this kernel loops to S
// and needs no padding.
//
// What bounds it on an H100: every input is read once and y written once
// (4·P elements in, P fp32 out per (batch, step, head)), and every step
// does about 5·P² fp32 operations per head on the CUDA cores (r·S, the
// decay and the outer-product update), so the fp32 operation rate bounds
// it (~10–20 flop per byte against fp32's ~20 flop/byte ridge). The
// recurrence is sequential in t: each (batch, head) is one chain of S
// dependent steps.
//
// What the design does about it:
//  * one CTA per (batch, head): the TPU's sequential chunk grid axis
//    becomes the CTA's loop over t, and the B·H chains run in parallel
//    (512 CTAs at rwkv6's B=8, H=64, about 4 per SM).
//  * the (P, P) state lives in registers: 4·P threads, thread (q, s) holds
//    S[s + 4j, q] for j < P/4 (a quarter of column q), so y_t[q] is a
//    reduction over the column's 4 lanes with two warp shuffles, and the
//    bonus term folds into the same reduction (Σ_s (r·S + (r·u·k)_s v_q)).
//  * r_t, k_t, v_t and w_t are staged through shared memory in chunks of T
//    steps with cp.async, double-buffered, in the model dtype, converted to
//    fp32 as they are read (conflict-free broadcasts); one barrier serves T
//    steps.
//  * y_t rows are gathered in shared memory and written once per chunk
//    with 16-byte stores.

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int T = 16;                  // steps per staged chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E, int P>
__global__ void __launch_bounds__(4 * P)
rwkv6_scan_kernel(const E* __restrict__ r, const E* __restrict__ k,
                  const E* __restrict__ v, const E* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ y, int S,
                  int H) {
  constexpr int NT = 4 * P;            // threads
  constexpr int PPT = P / 4;           // state rows per thread
  constexpr int EPV = 16 / sizeof(E);  // elements per 16-byte copy
  constexpr int VPR = P / EPV;         // 16-byte copies per row
  __shared__ __align__(16) E stage[2][4][T][P];   // r, k, v, w
  __shared__ __align__(16) float ys[T][P];
  __shared__ float us[P];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int qc = tid >> 2;             // column q
  const int s = tid & 3;               // rows s, s + 4, ...
  const size_t row0 = static_cast<size_t>(b) * S;
  const E* src[4] = {r, k, v, w};

  auto load_chunk = [&](int c, int buf) {
    const int t0 = c * T;
    const int nt = min(T, S - t0);
    for (int i = tid; i < 4 * nt * VPR; i += NT) {
      const int which = i / (nt * VPR);
      const int rem = i % (nt * VPR);
      const int row = rem / VPR, e = (rem % VPR) * EPV;
      cp_async16(&stage[buf][which][row][e],
                 src[which] + ((row0 + t0 + row) * H + h) * P + e);
    }
  };

  if (tid < P) us[tid] = u[h * P + tid];
  float st[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) st[j] = 0.f;

  const int nchunks = (S + T - 1) / T;
  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load_chunk(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int buf = c & 1;
    const int nt = min(T, S - c * T);
    for (int i = 0; i < nt; ++i) {
      const float vq = to_float(stage[buf][2][i][qc]);
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int p = s + 4 * j;
        const float rp = to_float(stage[buf][0][i][p]);
        const float kp = to_float(stage[buf][1][i][p]);
        const float wp = to_float(stage[buf][3][i][p]);
        acc = fmaf(rp, st[j], acc);
        bonus = fmaf(rp * us[p], kp, bonus);
        st[j] = fmaf(wp, st[j], kp * vq);
      }
      float yq = fmaf(bonus, vq, acc);
      yq += __shfl_xor_sync(0xffffffffu, yq, 1);
      yq += __shfl_xor_sync(0xffffffffu, yq, 2);
      if (s == 0) ys[i][qc] = yq;
    }
    __syncthreads();

    const int t0 = c * T;
    for (int i = tid; i < nt * (P / 4); i += NT) {
      const int row = i / (P / 4), c4 = (i % (P / 4)) * 4;
      *reinterpret_cast<float4*>(y + ((row0 + t0 + row) * H + h) * P + c4) =
          *reinterpret_cast<const float4*>(&ys[row][c4]);
    }
  }
}

template <typename E>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, int B, int S, int H, int P,
             void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* re = static_cast<const E*>(r);
  const auto* ke = static_cast<const E*>(k);
  const auto* ve = static_cast<const E*>(v);
  const auto* we = static_cast<const E*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* yf = static_cast<float*>(y);
  switch (P) {
    case 32:
      rwkv6_scan_kernel<E, 32><<<B * H, 128, 0, st>>>(re, ke, ve, we, uf, yf,
                                                      S, H);
      break;
    case 64:
      rwkv6_scan_kernel<E, 64><<<B * H, 256, 0, st>>>(re, ke, ve, we, uf, yf,
                                                      S, H);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
