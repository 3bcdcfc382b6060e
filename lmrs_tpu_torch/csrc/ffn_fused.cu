// Kernels K and L — one layer's whole GLU FFN from one C call:
//
//   [gate; up] = W13 . bf16(x),  g = bf16(act(gate) * up),  y = W2 . g
//
// K `ffn_fused_xe` (1 <= T <= 8) takes the numerics of
// lmrs_tpu/kernels/fused_ffn.py:_ffn_xe_kernel (ffn_fused_xe_stacked, the
// pallas_call at fused_ffn.py:526): the exact integer weights times the
// bf16 activations, f32 sums, times the f32 group scale, f32 across groups.
// The TPU kernel offsets Q4's unsigned nibbles by -8 through its corr1 and
// suml matrices; here each nibble is offset directly.
// L `ffn_fused` (9 <= T <= 16) takes those of fused_ffn.py:_ffn_kernel
// (ffn_fused_pallas, the pallas_call at fused_ffn.py:242): weights
// dequantized as bf16(bf16(q) * bf16(s)) times the bf16 activations, f32
// sums.  Both: the GLU in f32 (the formulas of fused_ffn.py:105-110), g
// rounded to bf16 once, y in f32 (T, D).  Q4_0 (runtime bytes: byte j of a
// group holds element j in its low nibble and j + gs/2 in its high one,
// XOR 0x80) or Q8_0 (int8) weights, f32 scales (O, K/gs).
//
// Bound on an H100: device-memory bytes.  Every weight byte and scale is
// read once per call for all T rows (Gemma-2-9B Q4_0: 81.9 MB a layer,
// Llama-3.2-3B Q8_0: 77.9 MB); x, g and y are a few hundred KB at most.
//
// K: ONE cooperative launch per layer (cudaLaunchCooperativeKernel, a
// persistent grid of as many blocks as fit on the card at once, one
// grid-wide barrier between the stages), so the layer's FFN costs one
// launch and no intermediate but g reaches device memory.
// - Stage A: a warp owns gate row j and up row H + j of W13, so the GLU is
//   local to the warp: the two f32 sums meet in its lanes after a shuffle
//   reduction, and lane t writes g[t, j] to a (T, H) bf16 scratch that the
//   wrapper allocates.  y13 never reaches device memory.
// - Stage B: a warp owns two rows of W2 against g, read back through L1.
// - Each lane streams 16-byte chunks of both rows (neighbouring lanes on
//   neighbouring addresses: 512 contiguous bytes a row per load
//   instruction), several chunks' loads issued before any is used.  A chunk
//   lies inside one (half-)group, so it needs one scale.  Q4 chunk bytes
//   pair with two runs of 16 activations, the group's first and second
//   halves (as kernel A indexes x), so g needs no permutation.
// - Integer weights become floats without a convert instruction
//   (0x4B000000 | n is the float 2^23 + n).  Every multiply-add is an
//   explicit fmaf in one fixed order whatever T is, so a row of a call of
//   T rows equals the row computed alone, bit for bit (speculative greedy
//   decoding stays exact).
//
// L: its function is kernels B's and F's followed by the GLU, so it runs on
// their Hopper template (qgemm_sm90.cuh: wgmma m64n16k16 over TMA-fed
// tiles, the weights dequantized once per call in registers), two launches
// from one C call on the caller's stream.  What held the CUDA-core L back:
// 16 rows of sums, weights and activations in registers (152-176 a thread)
// left one block an SM and a latency-bound loop of 16 f32 FMAs a weight.
// Stage A (Epi::Glu): a tile's 128 rows are 64 gate rows of W13 and their
// 64 up rows, read through two TMA maps of H rows each; after the split-K
// sum in cluster rank order the block forms g in f32 and writes it as bf16
// (T, H), so [gate; up] never reaches device memory.  Stage B (Epi::Down):
// g . W2^T into y.  9..16 rows take the N = 16 width, the rows past T read
// as zeros.  g is the only intermediate in device memory.
//
// Later: K's stage B split along H so that every warp has work when D / 2
// < the warps in flight; more rows per warp at T > 1.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qgemm_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDevices = 16;

enum Quant { kQ4 = 0, kQ8 = 1 };
enum Numerics { kXe = 0, kDeq = 1 };

struct Args {
  const __nv_bfloat16* x;  // (T, D) bf16
  const uint8_t* w13;      // (2H, D/2) Q4 runtime bytes or (2H, D) int8
  const float* s13;        // (2H, D/gs)
  const uint8_t* w2;       // (D, H/2) or (D, H)
  const float* s2;         // (D, H/gs)
  __nv_bfloat16* g;        // (T, H) scratch
  float* y;                // (T, D)
  int T, D, H, gs, act;
};

__device__ __forceinline__ float nib(uint32_t w, int shift) {
  // ((w >> shift) & 15) - 8 as float, exactly (w already XOR 0x80808080)
  return __uint_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.0f;
}

__device__ __forceinline__ float sbyte(uint32_t w, int shift) {
  // the int8 value of byte `shift` of a word XOR 0x80808080 (q + 128),
  // as float, exactly
  return __uint_as_float(0x4B000000u | ((w >> shift) & 0xFFu)) - 8388736.0f;
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// Eight bf16 activations.  x is read-only for the whole call (__ldg); g is
// written in stage A of this call, so it is read with an ordinary caching
// load, after the grid barrier.
template <bool kScratch>
__device__ __forceinline__ uint4 ld_act(const __nv_bfloat16* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  return kScratch ? __ldca(q) : __ldg(q);
}

// Per-lane partial sums of two weight rows r0, r1 (K values each) against
// the T activation rows a (T, K) bf16.
template <int Q, int T, bool kScratch>
__device__ __forceinline__ void dot_pair(const uint8_t* __restrict__ w,
                                         const float* __restrict__ s,
                                         int r0, int r1, int K, int gs,
                                         const __nv_bfloat16* a, int lane,
                                         float (&acc)[2][T]) {
  const int kb = Q == kQ4 ? K / 2 : K;   // bytes per row
  const int n_chunks = kb / 16;
  const int n_groups = K / gs;
  const int half = gs / 2;
  const int rows[2] = {r0, r1};
  constexpr int kUnroll = T <= 2 ? 4 : 2;
  constexpr int kVals = Q == kQ4 ? 16 : 8;  // values a row in half a chunk

  for (int c0 = lane; c0 < n_chunks; c0 += 32 * kUnroll) {
    uint4 wq[kUnroll][2];
    float sc[kUnroll][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      const int grp = Q == kQ4 ? (c * 16) / half : (c * 16) / gs;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (c < n_chunks) {
          wq[u][r] = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)rows[r] * kb + c * 16));
          sc[u][r] = __ldg(s + (size_t)rows[r] * n_groups + grp);
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
      int e_lo;                 // element of the chunk's first value
      if (Q == kQ4) {
        const int grp = (c * 16) / half;
        e_lo = grp * gs + (c * 16 - grp * half);
      } else {
        e_lo = c * 16;
      }
      const int e_hi = e_lo + half;   // Q4: element of the high nibbles
      float part[2][T];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 0; t < T; ++t) part[r][t] = 0.f;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the weight values of half the chunk (8 bytes a row): Q4 lo
        // nibbles 0..7 then hi nibbles 0..7, Q8 values 0..7
        float wv[2][kVals];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t w0 = (h ? wq[u][r].z : wq[u][r].x) ^ 0x80808080u;
          const uint32_t w1 = (h ? wq[u][r].w : wq[u][r].y) ^ 0x80808080u;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint32_t word = i < 4 ? w0 : w1;
            const int sh = 8 * (i & 3);
            if constexpr (Q == kQ4) {
              wv[r][i] = nib(word, sh);
              wv[r][8 + i] = nib(word, sh + 4);
            } else {
              wv[r][i] = sbyte(word, sh);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const __nv_bfloat16* at = a + (size_t)t * K;
          const uint4 al = ld_act<kScratch>(at + e_lo + 8 * h);
          uint4 ah = make_uint4(0u, 0u, 0u, 0u);
          if (Q == kQ4) ah = ld_act<kScratch>(at + e_hi + 8 * h);
          float av[kVals];
          av[0] = bf_lo(al.x); av[1] = bf_hi(al.x);
          av[2] = bf_lo(al.y); av[3] = bf_hi(al.y);
          av[4] = bf_lo(al.z); av[5] = bf_hi(al.z);
          av[6] = bf_lo(al.w); av[7] = bf_hi(al.w);
          if constexpr (Q == kQ4) {
            av[8] = bf_lo(ah.x); av[9] = bf_hi(ah.x);
            av[10] = bf_lo(ah.y); av[11] = bf_hi(ah.y);
            av[12] = bf_lo(ah.z); av[13] = bf_hi(ah.z);
            av[14] = bf_lo(ah.w); av[15] = bf_hi(ah.w);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = part[r][t];
#pragma unroll
            for (int i = 0; i < kVals; ++i) p = fmaf(wv[r][i], av[i], p);
            part[r][t] = p;
          }
        }
      }
      // the chunk's exact-product sum times its group's f32 scale
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 0; t < T; ++t)
          acc[r][t] = fmaf(sc[u][r], part[r][t], acc[r][t]);
    }
  }
}

template <int T>
__device__ __forceinline__ void warp_sum(float (&acc)[2][T]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = acc[r][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][t] = v;
    }
}

template <int Q, int T>
__global__ void __launch_bounds__(kThreads) ffn_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;

  // ---- stage A: gate row j and up row H + j, then the GLU
  for (int j = warp; j < p.H; j += n_warps) {
    float acc[2][T];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < T; ++t) acc[r][t] = 0.f;
    dot_pair<Q, T, false>(p.w13, p.s13, j, p.H + j, p.D, p.gs, p.x, lane,
                          acc);
    warp_sum<T>(acc);
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (lane == t)
        p.g[(size_t)t * p.H + j] = lmrs_sm90::glu(acc[0][t], acc[1][t],
                                                  p.act);
  }

  cg::this_grid().sync();     // all of g is written

  // ---- stage B: rows 2i and 2i + 1 of W2 against g
  for (int i = warp; 2 * i < p.D; i += n_warps) {
    float acc[2][T];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < T; ++t) acc[r][t] = 0.f;
    dot_pair<Q, T, true>(p.w2, p.s2, 2 * i, 2 * i + 1, p.H, p.gs, p.g, lane,
                         acc);
    warp_sum<T>(acc);
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (lane == t) {
        p.y[(size_t)t * p.D + 2 * i] = acc[0][t];
        p.y[(size_t)t * p.D + 2 * i + 1] = acc[1][t];
      }
  }
}

template <int Q, int T>
int launch(const Args& args, cudaStream_t stream) {
  // the persistent grid: every block resident at once, which a grid-wide
  // barrier needs; computed once per device
  static int blocks[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ffn_kernel<Q, T>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    blocks[dev] = per_sm * sms;
  }
  Args a = args;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)ffn_kernel<Q, T>,
                                  dim3(blocks[dev]), dim3(kThreads), params,
                                  0, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it; the caller raises
    return (int)e;
  }
  return (int)cudaGetLastError();
}

template <int Q>
int launch_xe(const Args& a, cudaStream_t stream) {
  switch (a.T) {
    case 1: return launch<Q, 1>(a, stream);
    case 2: return launch<Q, 2>(a, stream);
    case 3: return launch<Q, 3>(a, stream);
    case 4: return launch<Q, 4>(a, stream);
    case 5: return launch<Q, 5>(a, stream);
    case 6: return launch<Q, 6>(a, stream);
    case 7: return launch<Q, 7>(a, stream);
    case 8: return launch<Q, 8>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// L: the GLU stage, then the down stage, on the caller's stream
template <lmrs_sm90::Quant Q>
int launch_deq(const Args& a, cudaStream_t stream) {
  using lmrs_sm90::Epi;
  const size_t wcols = Q == lmrs_sm90::Quant::Q4 ? a.D / 2 : a.D;
  const int err = lmrs_sm90::launch_n<Q, 16, Epi::Glu>(
      a.x, a.w13, a.s13, nullptr, a.T, a.H, a.D, a.gs, stream, 0,
      a.w13 + a.H * wcols, a.s13 + (size_t)a.H * (a.D / a.gs), a.g, a.act);
  if (err != 0) return err;
  return lmrs_sm90::launch_n<Q, 16, Epi::Down>(a.g, a.w2, a.s2, a.y, a.T,
                                               a.D, a.H, a.gs, stream, 0);
}

}  // namespace

// x (T, D) bf16; w13 (2H, D/2) u8 Q4 runtime bytes (quant 0) or (2H, D)
// int8 (quant 1); s13 (2H, D/gs) f32; w2 (D, H/2) or (D, H); s2 (D, H/gs)
// f32; g (T, H) bf16 scratch; y (T, D) f32.  numerics 0: K (1 <= T <= 8,
// one launch), 1: L (9 <= T <= 16, two launches).  act 0: silu, 1:
// tanh-GELU.  Needs gs % 32 == 0 (L: gs in 32, 64, 128), D % gs == 0,
// H % gs == 0 and 16-byte aligned x, w13 and w2 (the Python wrapper
// checks).  Returns the first launch error or cudaGetLastError().
extern "C" int lmrs_ffn_fused(int numerics, int quant, const void* x,
                              const uint8_t* w13, const float* s13,
                              const uint8_t* w2, const float* s2, void* g,
                              float* y, int T, int D, int H, int gs, int act,
                              cudaStream_t stream) {
  const Args a{static_cast<const __nv_bfloat16*>(x), w13, s13, w2, s2,
               static_cast<__nv_bfloat16*>(g), y, T, D, H, gs, act};
  if (numerics == kXe) {
    if (quant == kQ4) return launch_xe<kQ4>(a, stream);
    if (quant == kQ8) return launch_xe<kQ8>(a, stream);
  } else if (numerics == kDeq && T >= 9 && T <= 16 && gs >= 32 &&
             128 % gs == 0) {
    if (quant == kQ4) return launch_deq<lmrs_sm90::Quant::Q4>(a, stream);
    if (quant == kQ8) return launch_deq<lmrs_sm90::Quant::Q8>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}
