// The tensor-core GEMV pieces of kernels A (q4_gemv.cu) and K
// (ffn_fused.cu, `ffn_fused_xe`) on Hopper (sm_90a): exact integer weights
// times bf16 activation operands on mma.sync m16n8k16 bf16 -> f32.
//
// - A operand: 16 weight rows of integers, exact in bf16.  Q4: the nibble
//   goes into the mantissa of the bf16 constant 128 (0x4300 | n = 128 + n)
//   and one bf16x2 subtraction of 136 gives n - 8.  Q8: X = 0x4300 | (v &
//   0x7f) = 128 + (v & 127) and C = 0x4300 | (v & 0x80) = 128 or 256 are
//   exact bf16 values with X - C = v.  The scale stays out of the operand:
//   a segment of k within one scale group sums in a fresh fragment, then
//   acc = fmaf(s, part, acc), in increasing k order.
// - A thread reads one contiguous piece of its rows a segment: the k slots
//   of an m16n8k16 step are permuted so that they name the piece's bytes
//   (the callers say how), and B is staged in the same order.  Every
//   column of the n8 tile holds its own row of activations, so a column's
//   result depends on that column alone: a row of a T-row call equals, bit
//   for bit, the row computed alone.
// - Split K: a thread-block cluster shares a row range; each rank pushes
//   its partial sums into the inbox of the rank that owns them (distributed
//   shared memory), and after one cluster barrier the owner adds the ranks'
//   sums in rank order (no atomics, the same bits every call).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace lmrs_gemv {
namespace {

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t hsub2_bits(uint32_t a, uint32_t b) {
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return bf16x2_bits(v);
}

// the low nibbles of the two bytes of `sp` (spread to 16-bit halves) as
// exact bf16 integers n - 8; the high nibbles (top bit biased) likewise
__device__ __forceinline__ uint32_t dq4_lo(uint32_t sp) {
  return hsub2_bits((sp & 0x000F000Fu) | 0x43004300u, 0x43084308u);
}
__device__ __forceinline__ uint32_t dq4_hi(uint32_t sp) {
  return hsub2_bits(((sp >> 4) & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

// (a & b) | c and (a & b) ^ c in one instruction each
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Word-level forms (kernel K): bytes 0 and 2 of a 32-bit word w (bytes 1
// and 3 after w >> 8) as the two halves of one register, with no byte
// permute.  Q4 runtime bytes: their low nibbles, and their high nibbles
// (top bit biased), as exact bf16 integers n - 8.  Q8: their int8 values.
__device__ __forceinline__ uint32_t dq4_even_lo(uint32_t w) {
  return hsub2_bits(and_or(w, 0x000F000Fu, 0x43004300u), 0x43084308u);
}
__device__ __forceinline__ uint32_t dq4_even_hi(uint32_t w) {
  return hsub2_bits(and_xor(w >> 4, 0x000F000Fu, 0x43084308u), 0x43084308u);
}
__device__ __forceinline__ uint32_t dq8_even(uint32_t w) {
  return hsub2_bits(and_or(w, 0x007F007Fu, 0x43004300u),
                    and_or(w, 0x00800080u, 0x43004300u));
}

// 64 bits of shared memory at a shared-window address, and the like
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts64(uint32_t addr, uint32_t a,
                                      uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n"
               :: "r"(addr), "r"(a), "r"(b) : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// 16 bytes (4 where !vec) from src into shared memory at dst, or zeros
// where !in (src is then not read)
__device__ __forceinline__ void cp_async_scale(uint32_t dst, const float* src,
                                               bool vec, bool in) {
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// the generic address of `p` (this rank's shared memory) in rank `owner`'s
__device__ __forceinline__ uint64_t map_rank(const void* p, uint32_t owner) {
  uint64_t dst;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(dst) : "l"(p), "r"(owner));
  return dst;
}

}  // namespace
}  // namespace lmrs_gemv
