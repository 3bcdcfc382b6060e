// Kernel B — Q4_0 GEMM for prefill chunks (9 <= T <= 512 rows).
//
//   y = x_bf16 . W_deq^T,   W_deq = bf16(bf16(w) * bf16(s)),   f32 accumulate
//
// the rounding of lmrs_tpu/kernels/dequant_matmul.py:_q4_se_stacked_kernel.
// Replaces that kernel and vpu_matvec.py:_se_q4_km_kernel (the same
// function on K-major tiles); the unstacked dequant_matmul.py:_q4_kernel
// computes it too but is not on the serving path.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): bytes at T = 9 — a
// Gemma-2-9B layer's four matrices are 105.3 MB of packed weights and
// scales, 31.4 us; tensor-core operations at T = 256 — 2*T*O*K = 101.5
// GFLOP a layer, 102.6 us (~512 FLOP per weight byte, above the card's
// ~295 FLOP/byte balance point).
//
// Design (qgemm_sm90.cuh, shared with kernel F): y^T = W_deq . x^T with
// wgmma m64nNk16, the weights dequantized once per call in registers
// straight into wgmma's A fragment (two packed bf16x2 operations per pair
// of values), x the B operand from a ring of shared-memory stages that one
// producer warp fills with TMA (128 K elements, 64 weight bytes a row, a
// stage), two consumer warpgroups of 64 features each, split-K over a
// cluster with a fixed-order reduction through distributed shared memory.
// Grid: ceil(O/128) tiles x S blocks x ceil(T/256) halves, S the largest
// (<= 8) for which the card holds every tile's cluster at once.  N = 16 for
// T = 9..16, 64 for the scheduler's 64-row chunks, 128 for 80-row verify
// steps, 256 for 256-row prefill chunks.  Gemma-2-9B's wqkv, wo, w13, w2 on
// an H100 80GB HBM3 at 700 W (scripts/torch_gemm_split.py): T = 9, 16
// 64 x 3, 28 x 8, 224 x 1, 28 x 8 blocks; T = 64 and 256 64 x 2, 28 x 4,
// 224 x 1, 28 x 4.

#include "qgemm_sm90.cuh"

// x (T, K) bf16, q (O, K/2) u8 runtime layout, s (O, K/gs) f32 -> y (T, O)
// f32.  Needs 9 <= T <= 512, K % 128 == 0, gs in (32, 64, 128) and 16-byte
// aligned x and q (the Python wrapper checks).  Returns a CUDA error code
// (0 on success).
extern "C" int lmrs_q4_gemm(const void* x, const uint8_t* q, const float* s,
                            float* y, int T, int O, int K, int gs,
                            cudaStream_t stream) {
  return lmrs_sm90::launch<lmrs_sm90::Quant::Q4>(x, q, s, y, T, O, K, gs,
                                                  stream);
}
