// Kernel F — Q8_0 GEMM for prefill chunks (9 <= T <= 512 rows).
//
//   y = x_bf16 . W_deq^T,   W_deq = bf16(bf16(wq) * bf16(s)),   f32 accumulate
//
// the rounding of lmrs_tpu/kernels/dequant_matmul.py:_q8_se_stacked_kernel
// (an int8 value is exact in bf16, and the f32 product of two bf16 values
// is exact, so one round-to-nearest-even gives the same bits).  Replaces
// that kernel and vpu_matvec.py:_se_q8_km_kernel (the same function on
// K-major tiles); the unstacked dequant_matmul.py:_q8_kernel computes it
// too, with K tiling, but is not on the serving path.
//
// Bound on an H100: tensor-core operations at T = 256 (2*T*O*K FLOP against
// O*K weight bytes: 512 FLOP per byte, above the card's ~295 bf16 FLOP/byte
// balance point); bytes at the small-T end of the range.  Design, as kernel
// B's: a 64x64 output tile per block of four warps (each warp 32x32 = 2x2
// WMMA 16x16x16 bf16 fragments with f32 accumulators).  Each K step of 128
// elements stores the x tile into shared memory and dequantizes the int8
// weight tile straight into a bf16 tile in shared memory — one group scale
// per 16-byte chunk — so dequantized weights never touch device memory.
// The next step's global loads are issued into registers before the
// current step's products (one stage of software pipelining).  The output
// tile is staged through shared memory for a bounds-masked store.
//
// Later: a wgmma/TMA pipeline with a ring of stages and a producer warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;          // token rows per block
constexpr int BN = 64;          // output features per block
constexpr int BK = 128;         // K elements (and weight bytes) per step
constexpr int LDT = BK + 8;     // bf16 row stride of the smem tiles
constexpr int LDC = BN + 4;     // f32 row stride of the staged output
constexpr int kThreads = 128;   // 4 warps, 2x2 of 32x32 warp tiles

__global__ void __launch_bounds__(kThreads)
q8_gemm_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ y, int T, int O, int K, int gs) {
  __shared__ __align__(128) __nv_bfloat16 xs[BM * LDT];
  __shared__ __align__(128) __nv_bfloat16 ws[BN * LDT];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_groups = K / gs;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // The next K step's x chunks, weight chunks and scales are loaded into
  // registers while the tensor cores work on the current one, then
  // dequantized into shared memory after the step's barrier.
  constexpr int kXLoads = BM * (BK / 8) / kThreads;    // 16-byte x chunks
  constexpr int kWLoads = BN * (BK / 16) / kThreads;   // 16-byte q chunks
  static_assert(BM * (BK / 8) % kThreads == 0 && BN * (BK / 16) % kThreads == 0,
                "tile chunks must split evenly over the threads");
  uint4 xr[kXLoads], wr[kWLoads];
  float sr[kWLoads];

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      xr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < T)
        xr[j] = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + k0 + c));
    }
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const int n = n0 + r;
      wr[j] = make_uint4(0u, 0u, 0u, 0u);
      sr[j] = 0.f;
      if (n < O) {
        wr[j] = __ldg(reinterpret_cast<const uint4*>(
            q + (size_t)n * K + k0 + c));
        sr[j] = __ldg(s + (size_t)n * n_groups + (k0 + c) / gs);
      }
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + r * LDT + c) = xr[j];
    }
    // int8 -> bf16(float(w) * bf16(s)), 16 values per chunk
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const float sb = __bfloat162float(__float2bfloat16_rn(sr[j]));
      const uint32_t words[4] = {wr[j].x, wr[j].y, wr[j].z, wr[j].w};
      __align__(16) __nv_bfloat162 out[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int b0 = (int)(int8_t)(words[w] & 0xFFu);
        const int b1 = (int)(int8_t)((words[w] >> 8) & 0xFFu);
        const int b2 = (int)(int8_t)((words[w] >> 16) & 0xFFu);
        const int b3 = (int)(int8_t)(words[w] >> 24);
        out[2 * w] = __floats2bfloat162_rn((float)b0 * sb, (float)b1 * sb);
        out[2 * w + 1] = __floats2bfloat162_rn((float)b2 * sb, (float)b3 * sb);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + r * LDT + c);
      dst[0] = *reinterpret_cast<const uint4*>(&out[0]);
      dst[1] = *reinterpret_cast<const uint4*>(&out[4]);
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);   // in flight during the products

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + (wn * 32 + j * 16) * LDT + kk, LDT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // stage the 64x64 f32 tile in the (now free) x tile and store masked
  float* cs = reinterpret_cast<float*>(xs);
  static_assert(BM * LDC * sizeof(float) <= BM * LDT * sizeof(__nv_bfloat16),
                "output staging must fit the x tile");
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < T && n0 + c < O)
      y[(size_t)(m0 + r) * O + n0 + c] = cs[r * LDC + c];
  }
}

}  // namespace

// x (T, K) bf16, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32.  Needs
// K % 128 == 0, gs % 16 == 0 and K % gs == 0 (the Python wrapper checks).
// Returns cudaGetLastError().
extern "C" int lmrs_q8_gemm(const void* x, const int8_t* q, const float* s,
                            float* y, int T, int O, int K, int gs,
                            cudaStream_t stream) {
  const dim3 grid((O + BN - 1) / BN, (T + BM - 1) / BM);
  q8_gemm_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), q, s, y, T, O, K, gs);
  return (int)cudaGetLastError();
}
