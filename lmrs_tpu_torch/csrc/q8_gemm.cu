// Kernel F — Q8_0 GEMM for prefill chunks (9 <= T <= 512 rows).
//
//   y = x_bf16 . W_deq^T,   W_deq = bf16(bf16(wq) * bf16(s)),   f32 accumulate
//
// the rounding of lmrs_tpu/kernels/dequant_matmul.py:_q8_se_stacked_kernel
// (an int8 value is exact in bf16, and the f32 product of two bf16 values
// is exact, so one round-to-nearest-even gives the same bits).  Replaces
// that kernel and vpu_matvec.py:_se_q8_km_kernel (the same function on
// K-major tiles); the unstacked dequant_matmul.py:_q8_kernel and, at T > 8,
// the group-loop _q8_kernel_gl compute it too.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): bytes at T = 9 — a
// Llama-3.2-3B layer's four matrices are 103.8 MB of int8 weights and
// scales, 31.0 us; tensor-core operations at T = 256 — 2*T*O*K = 51.5
// GFLOP a layer, 52.1 us (512 FLOP per weight byte, above the card's ~295
// FLOP/byte balance point).
//
// Design (qgemm_sm90.cuh, shared with kernel B): y^T = W_deq . x^T with
// wgmma m64nNk16, the weights dequantized once per call in registers
// straight into wgmma's A fragment (three packed bf16x2 operations per pair
// of values), x the B operand from a ring of shared-memory stages that one
// producer warp fills with TMA (64 K elements, 64 weight bytes a row, a
// stage), two consumer warpgroups of 64 features each, split-K over a
// cluster with a fixed-order reduction through distributed shared memory.
// Grid: ceil(O/128) tiles x S blocks x ceil(T/256) halves, S the largest
// (<= 8) for which the card holds every tile's cluster at once.
// Llama-3.2-3B's wqkv, wo, w13, w2 on an H100 80GB HBM3 at 700 W
// (scripts/torch_gemm_split.py): T = 9, 16 40 x 5, 24 x 8, 128 x 2, 24 x 8
// blocks; T = 64 and 256 40 x 2, 24 x 4, 128 x 1, 24 x 4.

#include "qgemm_sm90.cuh"

// x (T, K) bf16, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32.  Needs
// 9 <= T <= 512, K % 128 == 0, gs % 16 == 0, K % gs == 0 and 16-byte
// aligned x and q (the Python wrapper checks).  Returns a CUDA error code
// (0 on success).
extern "C" int lmrs_q8_gemm(const void* x, const int8_t* q, const float* s,
                            float* y, int T, int O, int K, int gs,
                            cudaStream_t stream) {
  return lmrs_sm90::launch<lmrs_sm90::Quant::Q8>(x, q, s, y, T, O, K, gs,
                                                  stream);
}
