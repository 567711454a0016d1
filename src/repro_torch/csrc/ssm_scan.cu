// Mamba2 scalar-decay selective scan, fp32.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py `_ssm_kernel` (wrapper
// `ssm_scan`, pallas_call at :60) with the entry point `ssm_scan_f32`.
// Same contract: x (B, S, H, P) dt-scaled inputs, B_in / C_in (B, S, N)
// shared by every head, decay (B, S, H), all fp32; writes y (B, S, H, P)
// fp32 with
//     h_t = decay_t · h_{t-1} + x_t ⊗ B_t ;   y_t = h_t · C_t
// and the (P, N) state of each (batch, head) starting at zero. The TPU
// wrapper pads S to whole VMEM chunks with decay 1.0; this kernel loops to
// S and needs no padding.
//
// What bounds it on an H100: every input is read once and y written once
// (about (2·H·P + 2·N + H)·4 bytes per (batch, step)), and every step does
// about 5·P·N fp32 operations per head on the CUDA cores (decay, outer
// product, dot with C), so the fp32 operation rate bounds it (~3 flop per
// byte moved against fp32's ~20 flop/byte ridge). The recurrence is
// sequential in t: each (batch, head) is one chain of S dependent steps.
//
// What the design does about it:
//  * one CTA per (batch, head): the TPU's sequential chunk grid axis
//    becomes the CTA's loop over t, and the B·H chains run in parallel
//    (512 CTAs at zamba2's B=8, H=64, about 4 per SM).
//  * the (P, N) state lives in registers: 4·P threads, thread (p, q) holds
//    h[p, q + 4j] for j < N/4 and reduces y_t[p] over its 4 lanes with two
//    warp shuffles. Nothing of the state touches memory until the end
//    (and not then: the final state is the model layer's closed form).
//  * x_t, B_t, C_t and decay_t are staged through shared memory in chunks
//    of T steps with cp.async, double-buffered, so the next chunk's loads
//    are in flight while this chunk's steps run; within a chunk every read
//    is a conflict-free shared-memory broadcast, and one barrier serves T
//    steps.
//  * y_t rows are gathered in shared memory and written once per chunk
//    with 16-byte stores.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int T = 16;                  // steps per staged chunk

template <int N>
__global__ void ssm_scan_kernel(const float* __restrict__ x,
                                const float* __restrict__ B_in,
                                const float* __restrict__ C_in,
                                const float* __restrict__ decay,
                                float* __restrict__ y, int S, int H, int P) {
  constexpr int NPT = N / 4;           // state entries per thread
  extern __shared__ __align__(16) float smem[];
  const int stage = T * (P + 2 * N + 4);
  float* ys = smem + 2 * stage;        // (T, P) outputs of one chunk

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;     // 4·P
  const int p = tid >> 2;
  const int q = tid & 3;
  const size_t row0 = static_cast<size_t>(b) * S;   // (b, t = 0)

  auto load_chunk = [&](int c, float* buf) {
    const int t0 = c * T;
    const int nt = min(T, S - t0);
    float* xs = buf;
    float* bs = xs + T * P;
    float* cs = bs + T * N;
    float* as = cs + T * N;
    const int xv = P / 4, nv = N / 4;
    for (int i = tid; i < nt * xv; i += nthreads) {
      const int r = i / xv, c4 = (i % xv) * 4;
      cp_async16(xs + r * P + c4,
                 x + ((row0 + t0 + r) * H + h) * P + c4);
    }
    for (int i = tid; i < nt * nv; i += nthreads) {
      const int r = i / nv, c4 = (i % nv) * 4;
      cp_async16(bs + r * N + c4, B_in + (row0 + t0 + r) * N + c4);
      cp_async16(cs + r * N + c4, C_in + (row0 + t0 + r) * N + c4);
    }
    for (int i = tid; i < nt; i += nthreads)
      cp_async4(as + i, decay + (row0 + t0 + i) * H + h);
  };

  float hs[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) hs[j] = 0.f;

  const int nchunks = (S + T - 1) / T;
  load_chunk(0, smem);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load_chunk(c + 1, smem + ((c + 1) & 1) * stage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* xs = smem + (c & 1) * stage;
    const float* bs = xs + T * P;
    const float* cs = bs + T * N;
    const float* as = cs + T * N;
    const int nt = min(T, S - c * T);
    for (int i = 0; i < nt; ++i) {
      const float a = as[i];
      const float xp = xs[i * P + p];
      float yp = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = q + 4 * j;
        hs[j] = fmaf(hs[j], a, xp * bs[i * N + n]);
        yp = fmaf(hs[j], cs[i * N + n], yp);
      }
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (q == 0) ys[i * P + p] = yp;
    }
    __syncthreads();

    const int t0 = c * T;
    const int xv = P / 4;
    for (int i = tid; i < nt * xv; i += nthreads) {
      const int r = i / xv, c4 = (i % xv) * 4;
      *reinterpret_cast<float4*>(y + ((row0 + t0 + r) * H + h) * P + c4) =
          *reinterpret_cast<const float4*>(ys + r * P + c4);
    }
  }
}

template <int N>
cudaError_t launch(const float* x, const float* B_in, const float* C_in,
                   const float* decay, float* y, int B, int S, int H, int P,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * T * (P + 2 * N + 4) + T * P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ssm_scan_kernel<N><<<B * H, 4 * P, smem, stream>>>(x, B_in, C_in, decay,
                                                     y, S, H, P);
  return cudaGetLastError();
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
    case 16: return static_cast<int>(launch<16>(xf, bf, cf, af, yf, B, S, H, P, st));
    case 32: return static_cast<int>(launch<32>(xf, bf, cf, af, yf, B, S, H, P, st));
    case 64: return static_cast<int>(launch<64>(xf, bf, cf, af, yf, B, S, H, P, st));
    case 128: return static_cast<int>(launch<128>(xf, bf, cf, af, yf, B, S, H, P, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
