// Helpers shared by flash_attention.cu and paged_attention.cu: warp
// reductions, 16-byte cp.async copies, element loads and stores widened
// to or narrowed from fp32, the hi/lo TF32 split and the TF32 mma.sync of
// the 3xTF32 tensor-core bodies, and the bf16 mma.sync, ldmatrix.trans
// and two-term bf16 split of the bf16 tensor-core bodies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;      // the TPU kernels' mask constant
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// the same; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo for 3xTF32.  hi = tf32(x) rounded to nearest, ties away
// from zero: the bits cvt.rna.tf32.f32 gives for every finite x, in two
// integer ops at full rate where cvt is slower.  lo = x - hi is exact
// in fp32 and goes to the mma as it is: the tensor core reads the top
// 19 bits of a .tf32 operand, so lo is truncated to TF32 there
// (|lo| <= 2^-11 |x|, the truncation <= 2^-21 |x|, next to the lo.lo
// term left out).  tests/test_torch_flash_tf32.py emulates this split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b on one m16n8k8 tile, TF32 inputs, fp32 accumulator.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g);
// d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element loads widened to fp32, and the output narrowed to its type
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// bf16 element e (0: low half) of a little-endian word, widened
__device__ __forceinline__ float bf16_at(uint32_t word, int e) {
  return __uint_as_float(e == 0 ? word << 16 : word & 0xffff0000u);
}

// 4 consecutive elements from shared memory, widened to fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_at(w.x, 0), bf16_at(w.x, 1), bf16_at(w.y, 0),
                     bf16_at(w.y, 1));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// d += a . b on one m16n8k16 tile, bf16 inputs, fp32 accumulator.
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register, the lower
// index in the low half: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g,
// 2t+8..2t+9), a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8..,
// n g); d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the 16-byte
// rows of matrix i, and r[i] receives its elements (rows 2t, 2t+1;
// column g): with rows = keys and columns = V's columns, the B fragment
// of P.V.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// (a, b) as a bf16 pair hi = bf16(x) and lo = bf16(x - hi), a in the low
// halves: P's two terms for the bf16 P.V
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 w =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&w);
}

}  // namespace
