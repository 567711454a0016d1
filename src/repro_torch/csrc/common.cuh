// Helpers shared by the kernels: bf16 / int8 -> fp32 in 8- and 16-byte
// vectors, read-only loads, and cp.async copies into shared memory (with a
// zero-fill form for masked rows).
// Included by every csrc/*.cu; compiled for sm_90a.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Masked score / empty-partial max: the kernels' finite -inf, so that an
// empty partial (m = NEG_INF, l = 0) merges as the identity and exp() of a
// difference of two sentinels is exp(0) = 1, never NaN.
constexpr float NEG_INF = -1e30f;

// 8 bf16 values packed in one 16-byte word -> 8 floats.
__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One 32-bit word of 4 int8 values -> 4 floats, exactly and without I2F:
// x = w ^ 0x80808080 holds b + 128 in each byte; __byte_perm puts byte i
// under 0x4B0000 (the float 2^23, whose ulp is 1), and subtracting
// 2^23 + 128 leaves b. One LOP3 per word, one PRMT and one FADD per value.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* out) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + i)) -
             8388736.0f;
}

// 16 int8 values packed in one 16-byte word -> 16 floats.
__device__ __forceinline__ void int8x16_to_float(const uint4& raw,
                                                 float* out) {
  int8x4_to_float(raw.x, out);
  int8x4_to_float(raw.y, out + 4);
  int8x4_to_float(raw.z, out + 8);
  int8x4_to_float(raw.w, out + 12);
}

// 8 int8 values packed in one 8-byte word -> 8 floats.
__device__ __forceinline__ void int8x8_to_float(const uint2& raw,
                                                float* out) {
  int8x4_to_float(raw.x, out);
  int8x4_to_float(raw.y, out + 4);
}

// 16-byte read-only global load.
__device__ __forceinline__ uint4 ldg16(const void* ptr) {
  return __ldg(reinterpret_cast<const uint4*>(ptr));
}

// Asynchronous global -> shared copies (cp.async, sm_80+): 16 bytes
// (bypassing L1) or 4 bytes. Completion is per thread, in commit groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// The same copies with a source size of 0 when !ok: nothing is read from
// global memory and the shared bytes are zero-filled (masked rows).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async8_zfill(void* smem, const void* gmem,
                                                bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro_torch
