// Kernel D — Q8_0 W8A8 GEMV for T <= 8 rows, with its activation quantizer.
//
//   y[t, o] = sum_g  (float(sum_{k in g} wq[o, k] * xq[t, k]) * ws[o, g]) * xs[t, g]
//
// the reference's own integer scheme: activations are group-quantized to
// int8 (scale = absmax / 127, round half away from zero), the dot of one
// group is exact in int32 (128 products of |127 * 127| need 21 bits), and
// the two scales multiply the converted integer in f32, weight scale
// first.  Replaces the TPU kernels
// lmrs_tpu/kernels/dequant_matmul.py:_q8_xei8_stacked_kernel (T <= 8,
// row-major stacked) and vpu_matvec.py:_xe_i8_km_kernel (2 <= T <= 8,
// K-major tiles): one function in two TPU layouts, one row-major layout
// here.  The only difference from those kernels is the f32 order of the sum
// over groups.
//
// Two kernels, launched back to back on the caller's stream by one entry
// point:
//  1. q8_act_quant_kernel: x f32 (T, K) -> xq int8 (T, K), xs f32 (T, G).
//     One warp per (row, group).  The quotient is an IEEE division and the
//     rounding is trunc(v + copysign(0.5, v)) as lmrs_tpu_torch.quant.
//     quantize_q8_act computes it: roundf() differs at v = 0.49999997f
//     (v + 0.5 rounds up to 1.0 in f32), and a reciprocal multiply changes
//     quotients next to .5.  All-zero groups give q = 0, s = 0.
//  2. q8_gemv_i8_kernel: one warp per kRowsPerWarp output rows; lanes
//     stride 16-byte chunks (16 int8 weights) along K, several chunks'
//     loads issued before any is used.  A chunk's four words meet the
//     matching words of each xq row in __dp4a; the gs/16 lanes that share
//     a group add their int32 partials with shuffles, and the group's
//     leader lane applies the scales in f32.
//
// Bound on an H100: device-memory bytes (1 byte per weight, 4/gs bytes of
// scale, read once for all T rows); xq and xs are tiny and stay in L1/L2.
//
// Later: a split along K for the short-O shapes (wo, w2), int8 tensor-core
// products for T = 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // warps per block
constexpr int kRowsPerWarp = 2;  // output rows per warp (xq reuse)
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__global__ void __launch_bounds__(kWarps * 32)
q8_act_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                    float* __restrict__ xs, int n_groups_total, int gs) {
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (t, g) flat
  if (grp >= n_groups_total) return;
  const int per_lane = gs / 32;
  const float* src = x + (size_t)grp * gs + lane * per_lane;
  float v[8];                      // gs <= 256
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = i < per_lane ? src[i] : 0.f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(amax, 127.0f);
  const float safe = scale == 0.f ? 1.0f : scale;
  int8_t* dst = xq + (size_t)grp * gs + lane * per_lane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i >= per_lane) break;
    const float quo = __fdiv_rn(v[i], safe);
    const float r = truncf(__fadd_rn(quo, quo >= 0.f ? 0.5f : -0.5f));
    dst[i] = scale == 0.f ? (int8_t)0 : (int8_t)(int)r;
  }
  if (lane == 0) xs[grp] = scale;
}

__device__ __forceinline__ int dot16(uint4 w, uint4 a) {
  int p = __dp4a((int)w.x, (int)a.x, 0);
  p = __dp4a((int)w.y, (int)a.y, p);
  p = __dp4a((int)w.z, (int)a.z, p);
  return __dp4a((int)w.w, (int)a.w, p);
}

template <int T>
__global__ void __launch_bounds__(kWarps * 32)
q8_gemv_i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ y, int O, int K, int gs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  if (row0 >= O) return;           // the whole warp leaves together
  const int n_chunks = K / 16;     // 16-byte chunks per row
  const int n_groups = K / gs;
  const int lpg = gs / 16;         // lanes that share one group: 2, 4, 8, 16
  const bool leader = (lane & (lpg - 1)) == 0;

  float acc[kRowsPerWarp][T];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < T; ++t) acc[r][t] = 0.f;

  // the loop bounds are the same for every lane (the shuffles below need
  // the whole warp); a lane past the end of the row carries zeros
  constexpr int kUnroll = T <= 2 ? 4 : 2;
  for (int c0 = 0; c0 < n_chunks; c0 += 32 * kUnroll) {
    uint4 wq[kUnroll][kRowsPerWarp];
    float sc[kUnroll][kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u + lane;
      const int g = c / lpg;
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
      if (c0 + 32 * u >= n_chunks) break;    // uniform over the warp
      const int c = c0 + 32 * u + lane;
      const bool ok = c < n_chunks;
      const int g = c / lpg;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        uint4 a = make_uint4(0u, 0u, 0u, 0u);
        float xsc = 0.f;
        if (ok) {
          a = __ldg(reinterpret_cast<const uint4*>(
              xq + (size_t)t * K + (size_t)c * 16));
          xsc = __ldg(xs + (size_t)t * n_groups + g);
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          int p = dot16(wq[u][r], a);
          for (int off = lpg >> 1; off > 0; off >>= 1)
            p += __shfl_xor_sync(0xffffffffu, p, off);
          // (float(p) * ws) * xs, each product rounded, as the reference
          if (leader)
            acc[r][t] = __fadd_rn(
                acc[r][t], __fmul_rn(__fmul_rn((float)p, sc[u][r]), xsc));
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
void launch(const int8_t* xq, const float* xs, const int8_t* q,
            const float* s, float* y, int O, int K, int gs,
            cudaStream_t stream) {
  const int blocks = (O + kRowsPerBlock - 1) / kRowsPerBlock;
  q8_gemv_i8_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(xq, xs, q, s, y, O,
                                                          K, gs);
}

}  // namespace

// The quantizer alone: x (T, K) f32 -> xq (T, K) int8, xs (T, K/gs) f32.
// Needs gs in {32, 64, 128, 256} and K % gs == 0.  Returns
// cudaGetLastError().
extern "C" int lmrs_q8_act_quant(const float* x, int8_t* xq, float* xs, int T,
                                 int K, int gs, cudaStream_t stream) {
  if (gs % 32 || gs > 256 || K % gs) return (int)cudaErrorInvalidValue;
  const int n = T * (K / gs);
  q8_act_quant_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      x, xq, xs, n, gs);
  return (int)cudaGetLastError();
}

// x (T, K) f32, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32; xq (T, K)
// int8 and xs (T, K/gs) f32 are scratch the caller allocates.  Needs
// 1 <= T <= 8, gs in {32, 64, 128, 256}, K % gs == 0, 16-byte aligned q and
// xq rows (the Python wrapper checks).  Returns cudaGetLastError().
extern "C" int lmrs_q8_gemv_i8(const float* x, int8_t* xq, float* xs,
                               const int8_t* q, const float* s, float* y,
                               int T, int O, int K, int gs,
                               cudaStream_t stream) {
  int err = lmrs_q8_act_quant(x, xq, xs, T, K, gs, stream);
  if (err != 0) return err;
  switch (T) {
    case 1: launch<1>(xq, xs, q, s, y, O, K, gs, stream); break;
    case 2: launch<2>(xq, xs, q, s, y, O, K, gs, stream); break;
    case 3: launch<3>(xq, xs, q, s, y, O, K, gs, stream); break;
    case 4: launch<4>(xq, xs, q, s, y, O, K, gs, stream); break;
    case 5: launch<5>(xq, xs, q, s, y, O, K, gs, stream); break;
    case 6: launch<6>(xq, xs, q, s, y, O, K, gs, stream); break;
    case 7: launch<7>(xq, xs, q, s, y, O, K, gs, stream); break;
    case 8: launch<8>(xq, xs, q, s, y, O, K, gs, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
