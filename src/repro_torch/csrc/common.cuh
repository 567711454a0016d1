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

// 4 bf16 values packed in one 8-byte word -> 4 floats.
__device__ __forceinline__ void bf16x4_to_float(const uint2& raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The smallest power of two >= n (n >= 1): lanes per key row, so that a
// row's shuffles stay inside it when hd / EPL is not a power of two.
__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
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

// The current device's SM count, read once (132 on an H100 SXM if the
// query fails). Host code: the scans size their CTAs with it.
inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// ---------------------------------------------------------------------------
// The scans' backward kernels (ssm_scan.cu, rwkv6_scan.cu): scalar loads and
// stores of a bf16 or fp32 operand in fp32, and the fixed-order sum of
// per-CTA partials that follows each of them (deterministic: no atomics).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// out[o · inner + i] = Σ_{j < nsum} in[(o · nsum + j) · inner + i], j
// ascending: one thread per output, grid-stride.
template <typename T>
__global__ void sum_partials_kernel(const float* __restrict__ in,
                                    T* __restrict__ out, long outer,
                                    int nsum, int inner) {
  const long total = outer * inner;
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long>(gridDim.x) * blockDim.x) {
    const long o = e / inner;
    const int i = static_cast<int>(e - o * inner);
    const float* src = in + o * nsum * inner + i;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < nsum; ++j) acc += src[static_cast<long>(j) * inner];
    store_f(out + e, acc);
  }
}

template <typename T>
cudaError_t sum_partials(const float* in, T* out, long outer, int nsum,
                         int inner, cudaStream_t stream) {
  const long total = outer * inner;
  const long blocks = (total + 255) / 256;
  const int grid = static_cast<int>(blocks < 8L * sm_count()
                                        ? blocks : 8L * sm_count());
  if (grid > 0)
    sum_partials_kernel<T><<<grid, 256, 0, stream>>>(in, out, outer, nsum,
                                                     inner);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core products (mma.sync m16n8k16, bf16 in, fp32
// accumulate) and fp32 operands carried as bf16 hi + lo. Used by the
// chunked scans (ssm_scan.cu, rwkv6_scan.cu).
//
// Fragments of one warp, g = lane / 4, c = lane % 4:
//   A (16 x 16, row-major) a[0..3]: (g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..),
//       (g+8, 2c+8..);  B (16 x 8) b0: (k = 2c..2c+1, n = g), b1: (k = 2c+8..);
//   C (16 x 8, fp32) d[0..3]: (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1).
// So the accumulators of two neighbouring n-tiles are, after the split, the
// A fragment of one k-step (the state kept in registers feeds the next
// product without shared memory).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices: lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i (row g, columns 2c, 2c+1; .trans: rows 2c,
// 2c+1 of column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a · b (m16n8k16, bf16 operands, fp32 accumulators). Registers only,
// so not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += (ah + al) · (bh + bl)[j] for NJ neighbouring n-tiles (b0, b1 of
// tile j at 2j, 2j+1) without the al · bl term: three passes, each operand
// split into its bf16 rounding and the bf16 rounding of the rest, so each
// operand is kept to 2^-17 of itself and a product to ~1e-5 of |a·b| (one
// pass alone is 2^-8). Small terms first; pass by pass, so consecutive
// products go to different accumulators and do not wait on each other.
template <int NJ>
__device__ __forceinline__ void mma_bf16x3(float (*d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2 * NJ],
                                           const uint32_t (&bl)[2 * NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(d[j], al, bh[2 * j], bh[2 * j + 1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(d[j], ah, bl[2 * j], bl[2 * j + 1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(d[j], ah, bh[2 * j], bh[2 * j + 1]);
}

// The same with an exact A (bf16 inputs): two passes.
template <int NJ>
__device__ __forceinline__ void mma_bf16x2(float (*d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&bh)[2 * NJ],
                                           const uint32_t (&bl)[2 * NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(d[j], a, bl[2 * j], bl[2 * j + 1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(d[j], a, bh[2 * j], bh[2 * j + 1]);
}

// (x0, x1) -> packed bf16x2 hi = bf16(x) and lo = bf16(x - hi); x0 in the
// low half.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The split of four consecutive values, stored to 8-byte aligned hi and lo
// rows in shared memory.
__device__ __forceinline__ void store_split4(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float x0,
                                             float x1, float x2, float x3) {
  uint2 h, l;
  split_bf16x2(x0, x1, h.x, l.x);
  split_bf16x2(x2, x3, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

__device__ __forceinline__ void store_split2(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float x0,
                                             float x1) {
  uint32_t h, l;
  split_bf16x2(x0, x1, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

__device__ __forceinline__ void store_split1(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

// Fragments of mma.m16n8k16 operands from bf16 rows in shared memory (ld:
// the row stride in elements; 16-byte aligned rows). A (16 x 16) at rows
// m0.., columns k0.. of an [m][k] array, or of the transpose of a [k][m]
// array (_t). B of two neighbouring n-tiles (16 x 16, registers as
// mma_bf16x3<2> takes them) or of one (8 x 16) at n0.., k0.. of an [n][k]
// array, or of the transpose of a [k][n] array (_t).
__device__ __forceinline__ void lda(uint32_t (&r)[4],
                                    const __nv_bfloat16* a, int ld, int m0,
                                    int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ldsm_x4(r, a + (m0 + (mi & 1) * 8 + r8) * ld + k0 + (mi >> 1) * 8);
}
__device__ __forceinline__ void lda_t(uint32_t (&r)[4],
                                      const __nv_bfloat16* a, int ld, int m0,
                                      int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ldsm_x4_trans(r, a + (k0 + (mi >> 1) * 8 + r8) * ld + m0 + (mi & 1) * 8);
}
__device__ __forceinline__ void ldb2(uint32_t (&r)[4],
                                     const __nv_bfloat16* b, int ld, int n0,
                                     int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ldsm_x4(r, b + (n0 + (mi >> 1) * 8 + r8) * ld + k0 + (mi & 1) * 8);
}
__device__ __forceinline__ void ldb2_t(uint32_t (&r)[4],
                                       const __nv_bfloat16* b, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ldsm_x4_trans(r, b + (k0 + (mi & 1) * 8 + r8) * ld + n0 + (mi >> 1) * 8);
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldb1(uint32_t (&r)[2],
                                     const __nv_bfloat16* b, int ld, int n0,
                                     int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ldsm_x2(r, b + (n0 + r8) * ld + k0 + (mi & 1) * 8);
}
__device__ __forceinline__ void ldb1_t(uint32_t (&r)[2],
                                       const __nv_bfloat16* b, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ldsm_x2_trans(r, b + (k0 + (mi & 1) * 8 + r8) * ld + n0);
}

// The same as mma_bf16x2 with an exact B (bf16 inputs) and A as hi + lo.
template <int NJ>
__device__ __forceinline__ void mma_bf16x2_b(float (*d)[4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const uint32_t (&b)[2 * NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(d[j], al, b[2 * j], b[2 * j + 1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_bf16(d[j], ah, b[2 * j], b[2 * j + 1]);
}

// Sixteen accumulator rows (mma fragments of N columns, rows g and g + 8)
// split into the hi / lo A operand of k-step kk (columns 16kk..16kk+15).
template <int NC>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NC / 8][4],
                                         int kk, uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  split_bf16x2(acc[2 * kk][0], acc[2 * kk][1], ah[0], al[0]);
  split_bf16x2(acc[2 * kk][2], acc[2 * kk][3], ah[1], al[1]);
  split_bf16x2(acc[2 * kk + 1][0], acc[2 * kk + 1][1], ah[2], al[2]);
  split_bf16x2(acc[2 * kk + 1][2], acc[2 * kk + 1][3], ah[3], al[3]);
}

// A warp's sixteen state rows (NC columns in mma fragments) to and from
// global scratch in fragment order: a float4 per lane and 8-column n-tile,
// 512 contiguous bytes per n-tile, so both are whole coalesced lines and
// each thread reads back what it wrote.
template <int NC>
__device__ __forceinline__ void state_store(float* dst,
                                            const float (&acc)[NC / 8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
    *reinterpret_cast<float4*>(dst + j * 128 + lane * 4) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}
template <int NC>
__device__ __forceinline__ void state_load(float (&acc)[NC / 8][4],
                                           const float* src) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(src + j * 128 +
                                                      lane * 4);
    acc[j][0] = v.x;
    acc[j][1] = v.y;
    acc[j][2] = v.z;
    acc[j][3] = v.w;
  }
}

}  // namespace repro_torch
