// Kernel A — Q4_0 GEMV for T <= 8 rows of f32 activations.
//
//   y[t, o] = sum_g s[o, g] * sum_{k in g} w[o, k] * x[t, k]
//
// f32 activations, f32 accumulation.  Replaces the TPU kernels
// lmrs_tpu/kernels/vpu_matvec.py:_vm_q4_kernel (T=1, K-major tiles),
// vpu_matvec.py:_xe_q4_km_kernel (2 <= T <= 8, K-major),
// dequant_matmul.py:_q4_xe_stacked_kernel (T <= 8, row-major stacked) and
// dequant_matmul.py:_q4_xe_kernel (T <= 8, unstacked classifier): one
// function in four TPU layouts, one row-major layout here.
//
// Weights: one layer's (O, K/2) runtime Q4 bytes and (O, K/gs) f32 scales.
// A byte holds element j of a group (low nibble) and element j + gs/2 (high
// nibble), XOR 0x80:  b = u ^ 0x80, lo = (b & 15) - 8, hi = (b >> 4) - 8.
//
// Bound on an H100: device-memory bytes.  Each weight byte is read once for
// all T rows (0.5 byte per value, ~1/32 byte of scale); x is tiny and stays
// in L1/L2.  Design: one warp per kRowsPerWarp output rows; lanes stride
// 16-byte chunks along K (one 128-bit load per row per chunk, neighbouring
// lanes on neighbouring addresses, so a warp streams 512 contiguous bytes
// of each row per step), several chunks' loads issued before any is used.
// A chunk lies inside one half-group, so it needs one scale.  The chunk's x values are loaded once and serve all the
// warp's rows.  Nibbles become floats without an int->float convert
// (0x4B000000 | n is the float 2^23 + n).  Per-lane partial sums are
// reduced across the warp with shuffles at the end.  No dequantized weight
// is ever written to memory.
//
// Later: more rows per warp at T=1, wider loads of the scales, a split
// along K for the short-O shapes (wo, w2) so more SMs take part.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // warps per block
constexpr int kRowsPerWarp = 2;  // output rows per warp (x reuse)
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__device__ __forceinline__ float nib(uint32_t w, int shift) {
  // ((w >> shift) & 15) - 8 as float, exactly
  return __uint_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.0f;
}

__device__ __forceinline__ uint4 ldg_stream(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float dot_word(uint32_t w, float4 xl, float4 xh) {
  // word w holds 4 bytes: low nibbles pair with xl, high nibbles with xh
  float p = nib(w, 0) * xl.x;
  p = fmaf(nib(w, 4), xh.x, p);
  p = fmaf(nib(w, 8), xl.y, p);
  p = fmaf(nib(w, 12), xh.y, p);
  p = fmaf(nib(w, 16), xl.z, p);
  p = fmaf(nib(w, 20), xh.z, p);
  p = fmaf(nib(w, 24), xl.w, p);
  p = fmaf(nib(w, 28), xh.w, p);
  return p;
}

template <int T>
__global__ void __launch_bounds__(kWarps * 32)
q4_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ s, float* __restrict__ y, int O,
               int K, int gs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  if (row0 >= O) return;
  const int kb = K / 2;           // packed bytes per row
  const int n_chunks = kb / 16;   // 16-byte chunks per row
  const int half = gs / 2;
  const int n_groups = K / gs;

  float acc[kRowsPerWarp][T];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < T; ++t) acc[r][t] = 0.f;

  // kUnroll chunks per lane per step: all their weight loads are issued
  // before any is used, so each warp keeps kUnroll * kRowsPerWarp 512-byte
  // row stripes in flight
  constexpr int kUnroll = T <= 2 ? 4 : 2;
  for (int c0 = lane; c0 < n_chunks; c0 += 32 * kUnroll) {
    uint4 wq[kUnroll][kRowsPerWarp];
    float sc[kUnroll][kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      const int g = (c * 16) / half;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int o = row0 + r;
        if (o < O && c < n_chunks) {
          wq[u][r] = ldg_stream(q + (size_t)o * kb + c * 16);
          sc[u][r] = __ldg(s + (size_t)o * n_groups + g);
        } else {
          wq[u][r] = make_uint4(0x80808080u, 0x80808080u, 0x80808080u,
                                0x80808080u);
          sc[u][r] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      if (c >= n_chunks) break;
      const int byte0 = c * 16;
      const int g = byte0 / half;
      const int klo = g * gs + (byte0 - g * half);  // element of the low nibbles
      const int khi = klo + half;                     // element of the high ones
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        wq[u][r].x ^= 0x80808080u;
        wq[u][r].y ^= 0x80808080u;
        wq[u][r].z ^= 0x80808080u;
        wq[u][r].w ^= 0x80808080u;
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float4* xl =
            reinterpret_cast<const float4*>(x + (size_t)t * K + klo);
        const float4* xh =
            reinterpret_cast<const float4*>(x + (size_t)t * K + khi);
        const float4 l0 = __ldg(xl), l1 = __ldg(xl + 1), l2 = __ldg(xl + 2),
                     l3 = __ldg(xl + 3);
        const float4 h0 = __ldg(xh), h1 = __ldg(xh + 1), h2 = __ldg(xh + 2),
                     h3 = __ldg(xh + 3);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          float p = dot_word(wq[u][r].x, l0, h0);
          p += dot_word(wq[u][r].y, l1, h1);
          p += dot_word(wq[u][r].z, l2, h2);
          p += dot_word(wq[u][r].w, l3, h3);
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
void launch(const float* x, const uint8_t* q, const float* s, float* y,
            int O, int K, int gs, cudaStream_t stream) {
  const int blocks = (O + kRowsPerBlock - 1) / kRowsPerBlock;
  q4_gemv_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(x, q, s, y, O, K, gs);
}

}  // namespace

// x (T, K) f32, q (O, K/2) u8 runtime layout, s (O, K/gs) f32 -> y (T, O)
// f32.  Needs 1 <= T <= 8, gs % 32 == 0, K % gs == 0, 16-byte aligned x
// and q rows (the Python wrapper checks).  Returns cudaGetLastError().
extern "C" int lmrs_q4_gemv(const float* x, const uint8_t* q, const float* s,
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
