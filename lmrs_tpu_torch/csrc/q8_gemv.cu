// Kernel E — Q8_0 W8A16 GEMV for T <= 8 rows of f32 activations.
//
//   y[t, o] = sum_g s[o, g] * sum_{k in g} float(wq[o, k]) * x[t, k]
//
// f32 activations, f32 accumulation, no activation quantization.  Replaces
// the TPU kernels lmrs_tpu/kernels/vpu_matvec.py:_vm_q8_kernel (T = 1,
// K-major tiles), dequant_matmul.py:_q8_xe_stacked_kernel (T <= 8,
// row-major stacked, W8A8 switched off) and dequant_matmul.py:_q8_xe_kernel
// (T <= 8, unstacked: the classifier, whatever the W8A8 switch says): one
// function in three TPU layouts, one row-major layout here.
//
// Bound on an H100: device-memory bytes (1 byte per weight, 4/gs bytes of
// scale, read once for all T rows); x is tiny and stays in L1/L2.  Design,
// as kernel A's: one warp per kRowsPerWarp output rows; lanes stride
// 16-byte chunks (16 int8 weights) along K, one 128-bit load per row per
// chunk, several chunks' loads issued before any is used.  A chunk lies
// inside one group, so it needs one scale.  The chunk's x values are loaded
// once and serve all the warp's rows.  A weight byte becomes a float
// without an int->float convert: one byte permute builds 0x4B0000uu, the
// float 2^23 + u, from the biased byte u = w ^ 0x80 = w + 128.  Per-lane
// partial sums are reduced across the warp with shuffles at the end.
//
// Later: a split along K for the short-O shapes, fewer instructions per
// byte at T = 8 (tensor cores on bf16-split activations).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // warps per block
constexpr int kRowsPerWarp = 2;  // output rows per warp (x reuse)
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

template <int B>
__device__ __forceinline__ float byte_f(uint32_t biased) {
  // byte B of `biased` holds w + 128; returns float(w), exactly
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + B)) -
         8388736.0f;
}

__device__ __forceinline__ float dot_word(uint32_t w, float4 xv) {
  const uint32_t b = w ^ 0x80808080u;
  float p = byte_f<0>(b) * xv.x;
  p = fmaf(byte_f<1>(b), xv.y, p);
  p = fmaf(byte_f<2>(b), xv.z, p);
  p = fmaf(byte_f<3>(b), xv.w, p);
  return p;
}

template <int T>
__global__ void __launch_bounds__(kWarps * 32)
q8_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, float* __restrict__ y, int O,
               int K, int gs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  if (row0 >= O) return;
  const int n_chunks = K / 16;    // 16-byte chunks per row
  const int n_groups = K / gs;

  float acc[kRowsPerWarp][T];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < T; ++t) acc[r][t] = 0.f;

  constexpr int kUnroll = T <= 2 ? 4 : 2;
  for (int c0 = lane; c0 < n_chunks; c0 += 32 * kUnroll) {
    uint4 wq[kUnroll][kRowsPerWarp];
    float sc[kUnroll][kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      const int g = (c * 16) / gs;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int o = row0 + r;
        wq[u][r] = make_uint4(0u, 0u, 0u, 0u);
        sc[u][r] = 0.f;
        if (o < O && c < n_chunks) {
          wq[u][r] = __ldg(reinterpret_cast<const uint4*>(
              q + (size_t)o * K + (size_t)c * 16));
          sc[u][r] = __ldg(s + (size_t)o * n_groups + g);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      if (c >= n_chunks) break;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float4* xp =
            reinterpret_cast<const float4*>(x + (size_t)t * K + (size_t)c * 16);
        const float4 x0 = __ldg(xp), x1 = __ldg(xp + 1), x2 = __ldg(xp + 2),
                     x3 = __ldg(xp + 3);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          float p = dot_word(wq[u][r].x, x0);
          p += dot_word(wq[u][r].y, x1);
          p += dot_word(wq[u][r].z, x2);
          p += dot_word(wq[u][r].w, x3);
          acc[r][t] = fmaf(sc[u][r], p, acc[r][t]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = acc[r][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][t] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      if (row0 + r < O)
#pragma unroll
        for (int t = 0; t < T; ++t) y[(size_t)t * O + row0 + r] = acc[r][t];
  }
}

template <int T>
void launch(const float* x, const int8_t* q, const float* s, float* y, int O,
            int K, int gs, cudaStream_t stream) {
  const int blocks = (O + kRowsPerBlock - 1) / kRowsPerBlock;
  q8_gemv_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(x, q, s, y, O, K, gs);
}

}  // namespace

// x (T, K) f32, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32.  Needs
// 1 <= T <= 8, gs % 16 == 0, K % gs == 0, 16-byte aligned x and q rows (the
// Python wrapper checks).  Returns cudaGetLastError().
extern "C" int lmrs_q8_gemv(const float* x, const int8_t* q, const float* s,
                            float* y, int T, int O, int K, int gs,
                            cudaStream_t stream) {
  switch (T) {
    case 1: launch<1>(x, q, s, y, O, K, gs, stream); break;
    case 2: launch<2>(x, q, s, y, O, K, gs, stream); break;
    case 3: launch<3>(x, q, s, y, O, K, gs, stream); break;
    case 4: launch<4>(x, q, s, y, O, K, gs, stream); break;
    case 5: launch<5>(x, q, s, y, O, K, gs, stream); break;
    case 6: launch<6>(x, q, s, y, O, K, gs, stream); break;
    case 7: launch<7>(x, q, s, y, O, K, gs, stream); break;
    case 8: launch<8>(x, q, s, y, O, K, gs, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
