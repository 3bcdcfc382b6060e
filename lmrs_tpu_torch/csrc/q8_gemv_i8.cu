// Kernel D — Q8_0 W8A8 GEMV for T <= 8 rows, its activation quantizer
// inside, on the int8 tensor cores (sm_90a, mma.sync m16n8k32 s8 -> s32).
//
//   xq, xs = quantize_q8_act(x)
//   y[t, o] = sum_g (float(sum_{k in g} wq[o, k] * xq[t, k]) * ws[o, g]) * xs[t, g]
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
// over groups (here: increasing group order, then the K split's partial
// sums in rank order).
//
// Bound on an H100: device-memory bytes, the same at every T (1 byte a
// weight and 4/gs of scale; Llama-3.2-3B: 0.87 ms a token's layer matmuls
// at 3.35 TB/s).  What held the CUDA-core design back: two launches a call
// (a quantizer pre-pass wrote xq and xs to device memory for the GEMV to
// read back); 64-128 bytes of weights in flight a lane (one warp over two
// rows), so a short layer (O = 3,072) gave each SM little in flight; T x
// (4 dp4a + 3 shuffles + 2 multiplies) a 16-byte chunk on the CUDA cores,
// so the work grew with T; and at K = 3,072 half the lanes idle on a row's
// second step.
//
// Design: one launch; the weights stream through shared memory by TMA and
// the products run on the tensor cores, so their cost does not grow with T.
// - A block is 8 consumer warps over 128 output rows (one m16 tile a warp)
//   and one K range; a ninth warp is the producer: one thread asks TMA for
//   the block's weight tile a stage at a time (256 bytes of its 128 rows:
//   two boxes of 128 bytes, 128-byte swizzle, conflict-free reads; rows
//   past O and columns past K read as zeros) and for the next stage's
//   columns of x (T rows of f32), into a ring of up to kMaxStages stages,
//   each completing on its "full" mbarrier and handed back on its "empty"
//   one.  The ring fills the block's share of shared memory (two blocks an
//   SM), so 64-128 KB of weights are in flight an SM from the first cycle.
// - The consumers copy the rows' scales for the K range once (cp.async)
//   and quantize the first stage's x from device memory while its weights
//   are on their way; then, stage by stage, they run its products and
//   quantize the next stage's x, which came with it (one warp a row and
//   group, two buffers, one barrier a stage), with the standalone
//   quantizer's arithmetic (one device function, quant_group, for both).
//   xq and xs never reach device memory, the wrapper allocates only y, and
//   the quantizer's work rides along the weight stream (quantizing a
//   block's whole K range before its first product delayed the stream at
//   T = 8; quantizing each stage's x after it landed delayed each stage at
//   T = 1).
// - Products: mma.sync m16n8k32 s8.s8 -> s32.  A = 16 weight rows, B = xq,
//   column t of the n8 tile holding row t of x (zeros past T), so one tile
//   serves every T <= 8.  The k slots of a group's steps are permuted so
//   that each thread reads one contiguous gs/4-byte piece of its rows and
//   of its row of xq (an integer sum is the same in any order): step j
//   takes bytes 8j .. 8j+7 of the piece, the low four as k slots 4t4..4t4+3,
//   the high four as 16+4t4..16+4t4+3.  A group's steps sum exactly in a
//   fresh int32 fragment; then acc += (float(c) * ws) * xs, each product
//   rounded, in increasing group order.  A column depends on its own row
//   of x only, and every (t, o) takes the same operations in the same
//   order whatever T is: a row of a T-row call equals, bit for bit, the row
//   computed alone (speculative greedy decoding stays exact).
// - Short-O shapes (wo, w2: O = 3,072-3,584) split K over a thread-block
//   cluster: S is the largest of 1, 2, 3, 4, 6 and 8 whose clusters the
//   card holds for every row tile at once (and at least K / kKMax, so that
//   a rank's scales fit their budget), from O and K only, never from T.  Each rank pushes its
//   sums into the inbox of the rank that owns those rows (distributed
//   shared memory); after one cluster barrier the owner adds them in rank
//   order, as kernel A does (q4_gemv.cu): no atomics, the same bits every
//   call.  The mbarrier, TMA and cluster helpers are kernels B and F's
//   (qgemm_sm90.cuh).
//
// What bounds it now (PERF.md §6, on an H100): at T = 1 each call's
// ramp and tail, ~6 us a call over the byte bound: a Llama token's 112
// calls take ~1.8x their byte bound in a decode step, about the two-launch
// kernel's time.  T = 8 costs ~1.1x T = 1 (the old kernel ~2x).  Later: a
// persistent grid, or calls that overlap the previous kernel's tail, to
// hide the ramp.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qgemm_sm90.cuh"

namespace {

namespace sm90 = lmrs_sm90;

constexpr int kWarps = 8;                    // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kRows = kWarps * 16;           // output rows a block
constexpr int kBox = 128;                    // bytes a row a TMA box
constexpr int kSB = 256;   // bytes of K a stage, at least (two boxes: a
                           // stage of 128 bytes, twice the barriers, was
                           // slower on an H100)
constexpr int kBoxBytes = kRows * kBox;      // 16 KB
constexpr int kMaxT = 8;
constexpr int kMaxSplit = 8;                 // portable cluster size
constexpr int kMaxStages = 8;
constexpr int kKMax = 4096;   // bytes of K a rank covers: its scales' budget
constexpr int kRedLd = kRows + 4;            // f32 stride of the sum tile
// two blocks an SM: the SM's 228 KB, 1 KB reserved a block
constexpr int kBudget = 233472 / 2 - 1024;

// ---- the quantizer: one group of gs = 32 * PL values, PL a lane (v), into
// q; returns the group's scale (every lane).  The quotient is an IEEE
// division and the rounding trunc(v + copysign(0.5, v)) as
// lmrs_tpu_torch.quant.quantize_q8_act computes it: roundf() differs at
// v = 0.49999997f (v + 0.5 rounds up to 1.0 in f32), and a reciprocal
// multiply changes quotients next to .5.  An all-zero group gives q = 0,
// s = 0.
template <int PL>
__device__ __forceinline__ float quant_group(const float (&v)[PL],
                                             int8_t (&q)[PL]) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(amax, 127.0f);
  const float safe = scale == 0.f ? 1.0f : scale;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const float quo = __fdiv_rn(v[i], safe);
    const float r = truncf(__fadd_rn(quo, quo >= 0.f ? 0.5f : -0.5f));
    q[i] = scale == 0.f ? (int8_t)0 : (int8_t)(int)r;
  }
  return scale;
}

// PL consecutive f32 values at src (aligned to 4 * PL bytes)
template <int PL>
__device__ __forceinline__ void load_lane(const float* src, float (&v)[PL]) {
  if constexpr (PL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PL; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src + i));
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  } else if constexpr (PL == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = __ldg(src);
  }
}

// PL bytes to dst (aligned to PL bytes)
template <int PL>
__device__ __forceinline__ void store_lane(int8_t* dst, const int8_t (&q)[PL]) {
  uint32_t w[(PL + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < PL; ++i)
    w[i / 4] |= (uint32_t)(uint8_t)q[i] << (8 * (i % 4));
  if constexpr (PL == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else if constexpr (PL == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (PL == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)w[0];
  } else {
    *dst = (int8_t)w[0];
  }
}

// the standalone quantizer: one warp a (row, group)
template <int PL>
__global__ void __launch_bounds__(128)
q8_act_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                    float* __restrict__ xs, int n_groups_total) {
  constexpr int gs = 32 * PL;
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x * 4 + (threadIdx.x >> 5);   // (t, g) flat
  if (grp >= n_groups_total) return;
  float v[PL];
  int8_t q[PL];
  load_lane<PL>(x + (size_t)grp * gs + lane * PL, v);
  const float scale = quant_group<PL>(v, q);
  store_lane<PL>(xq + (size_t)grp * gs + lane * PL, q);
  if (lane == 0) xs[grp] = scale;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the shared memory of one launch, byte offsets from the 1024-aligned base
// (host-computed: they depend on the split and the group size)
struct Plan {
  int stages;    // ring stages: weight boxes, then x's box, each
  int stage;     // bytes a stage
  int tx;        // bytes of x a stage brings (its box holds T rows)
  int xq;        // two xq buffers (kMaxT, xstride) int8
  int xs;        // two xs buffers (kMaxT, groups a stage) f32
  int ws;        // weight scales (kRows, sstride) f32
  int sstride;
  int inbox;     // the other ranks' sums of the rows this rank owns
  int per;       // quads of 4 sums each rank owns
  int bars;      // full[stages], empty[stages]
};

// the 16 bytes at byte `off` of row r of a stage (128-byte swizzle: chunk c
// of a row's 128 bytes of a box lies at chunk c ^ (r % 8))
__device__ __forceinline__ uint32_t ring_addr(uint32_t stage, int r, int off) {
  const int box = off >> 7, chunk = (off >> 4) & 7;
  return stage + box * kBoxBytes + r * kBox +
         (((chunk ^ (r & 7)) << 4) | (off & 15));
}

// PL consecutive f32 values of shared memory at src (aligned to 4 * PL)
template <int PL>
__device__ __forceinline__ void load_smem_lane(const float* src,
                                               float (&v)[PL]) {
  if constexpr (PL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PL; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(src + i);
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  } else if constexpr (PL == 2) {
    const float2 f = *reinterpret_cast<const float2*>(src);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *src;
  }
}

// GS: the group size; a thread reads W = GS/4 bytes of a group of its rows
template <int GS>
__global__ void __launch_bounds__(kThreads, 2)
q8_gemv_i8_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap,
                  const float* __restrict__ x, const float* __restrict__ s,
                  float* __restrict__ y, int T, int O, int K, Plan p) {
  constexpr int PL = GS / 32;          // x values a lane quantizes
  constexpr int W = GS / 4;            // bytes a thread reads a group a row
  constexpr int kWords = W / 4;
  constexpr int kSteps = GS / 32;      // k32 steps a group
  constexpr int SB = GS > kSB ? GS : kSB;     // bytes of K a stage
  constexpr int NB = SB / kBox;               // weight boxes a stage
  constexpr int kGps = SB / GS;               // groups a stage
  constexpr int kXStride = SB + 16;    // xq rows 16 bytes apart: no conflict
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t base = sm90::smem_u32(smem);

  uint32_t rank, nsplit;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nsplit));
  // the first phase of the cluster barrier: every block has started (so
  // that its shared memory may be written by the others) once all arrive
  if (nsplit > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (blockIdx.x / nsplit) * kRows;
  const int ng = K / GS;
  const int g0 = ng * rank / nsplit, g1 = ng * (rank + 1) / nsplit;
  const int ngr = g1 - g0;
  const int nst = (ngr + kGps - 1) / kGps;
  const int D = p.stages;
  auto full = [&](int i) { return base + p.bars + 8 * i; };
  auto empty = [&](int i) { return base + p.bars + 8 * (D + i); };

  // ---- producer: a stage at a time, the weight tile's boxes and the
  // next stage's columns of x (T rows); the first D stages go out before
  // the block's first barrier
  const bool producer = warp == kWarps && lane == 0;
  auto issue = [&](int i) {
    const int slot = i % D;
    const bool next = i + 1 < nst;
    sm90::mbar_expect_tx(full(slot), NB * kBoxBytes + (next ? p.tx : 0));
    const uint32_t st = base + slot * p.stage;
    const int col = (g0 + i * kGps) * GS;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      sm90::tma_load_2d(st + b * kBoxBytes, &wmap, full(slot),
                        col + b * kBox, row0);
    if (next)
      sm90::tma_load_2d(st + NB * kBoxBytes, &xmap, full(slot), col + SB, 0);
  };
  if (producer) {
    for (int i = 0; i < D; ++i) {
      sm90::mbar_init(full(i), 1);
      sm90::mbar_init(empty(i), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < D && i < nst; ++i) issue(i);
  }

  // ---- consumers, before the block's first barrier: the rows' scales of
  // the K range (one cp.async group, 16 bytes a copy where the rows allow:
  // an aligned window [w_lo, w_hi)), and stage 0's x quantized
  const bool vec = (ng & 3) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  const int w_lo = vec ? (g0 & ~3) : g0;
  const int w_hi = vec ? ((g1 + 3) & ~3) : g1;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = warp * 16 + g;              // this thread's rows r_lo, +8
  const int c0 = 2 * t4, c1 = 2 * t4 + 1;      // this thread's columns
  const bool has_x = g < T, has0 = c0 < T, has1 = c1 < T;
  // xq and xs of a stage: two buffers, stage i in buffer i % 2
  auto xq_buf = [&](int i) {
    return reinterpret_cast<int8_t*>(smem + p.xq) + (i & 1) * kMaxT * kXStride;
  };
  auto xs_buf = [&](int i) {
    return reinterpret_cast<float*>(smem + p.xs) + (i & 1) * kMaxT * kGps;
  };
  // stage i's columns of x quantized into its buffers, one warp a (row,
  // group); src(t, j) the group's values of row t
  auto quantize = [&](int i, auto&& src) {
    const int gn = min(kGps, ngr - i * kGps);
    int8_t* xq = xq_buf(i);
    float* xsc = xs_buf(i);
    for (int it = warp; it < T * gn; it += kWarps) {   // uniform a warp
      const int t = it / gn, j = it - t * gn;
      float v[PL];
      int8_t q[PL];
      src(t, j, v);
      const float scale = quant_group<PL>(v, q);
      store_lane<PL>(xq + t * kXStride + j * GS + lane * PL, q);
      if (lane == 0) xsc[t * kGps + j] = scale;
    }
  };
  if (warp < kWarps) {
    const int per_row = vec ? (w_hi - w_lo) / 4 : w_hi - w_lo;
    const uint32_t dst0 = base + p.ws;
    for (int e = tid; e < kRows * per_row; e += kConsumers) {
      const int r = e / per_row, c = (vec ? 4 : 1) * (e - r * per_row);
      const bool in = row0 + r < O;
      const float* src = s + (size_t)min(row0 + r, O - 1) * ng + w_lo + c;
      const uint32_t dst = dst0 + 4 * (r * p.sstride + c);
      if (vec)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // stage 0's x from device memory (L2) while its weights are on their
    // way; each later stage's arrives by TMA with the stage before
    quantize(0, [&](int t, int j, float (&v)[PL]) {
      load_lane<PL>(x + (size_t)t * K + (size_t)(g0 + j) * GS + lane * PL,
                    v);
    });
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();   // the barriers, scales and stage 0's xq are ready

  if (warp == kWarps) {
    if (producer) {
      for (int i = D; i < nst; ++i) {
        sm90::mbar_wait(empty(i % D), ((i / D) - 1) & 1);
        issue(i);
      }
    }
    __syncwarp();
    if (nsplit > 1) {      // the consumers' cluster barriers
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      sm90::cluster_sync();
    }
    return;
  }

  // ---- consumers: the products, a group at a time in increasing order
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < nst; ++i) {
    const int slot = i % D;
    const uint32_t stage = base + slot * p.stage;
    const int gn = min(kGps, ngr - i * kGps);
    const float* xsc = xs_buf(i);
    sm90::mbar_wait(full(slot), (i / D) & 1);
    const float* ws_lo = reinterpret_cast<const float*>(smem + p.ws) +
                         r_lo * p.sstride - w_lo;
    const float* ws_hi = ws_lo + 8 * p.sstride;
    const uint32_t xq_row = sm90::smem_u32(xq_buf(i)) + g * kXStride + t4 * W;
#pragma unroll 1
    for (int j = 0; j < gn; ++j) {
      uint32_t a_lo[kWords], a_hi[kWords], b[kWords];
#pragma unroll
      for (int u = 0; u < kWords; u += 4) {
        if constexpr (kWords >= 4) {
          const int off = j * GS + t4 * W + 4 * u;
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(a_lo[u]), "=r"(a_lo[u + 1]), "=r"(a_lo[u + 2]),
                         "=r"(a_lo[u + 3])
                       : "r"(ring_addr(stage, r_lo, off)));
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(a_hi[u]), "=r"(a_hi[u + 1]), "=r"(a_hi[u + 2]),
                         "=r"(a_hi[u + 3])
                       : "r"(ring_addr(stage, r_lo + 8, off)));
          if (has_x)
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(b[u]), "=r"(b[u + 1]), "=r"(b[u + 2]),
                           "=r"(b[u + 3])
                         : "r"(xq_row + j * GS + 4 * u));
          else
            b[u] = b[u + 1] = b[u + 2] = b[u + 3] = 0u;
        }
      }
      if constexpr (kWords == 2) {            // GS = 32: 8 bytes a row
        const int off = j * GS + t4 * W;
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(a_lo[0]), "=r"(a_lo[1])
                     : "r"(ring_addr(stage, r_lo, off)));
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(a_hi[0]), "=r"(a_hi[1])
                     : "r"(ring_addr(stage, r_lo + 8, off)));
        if (has_x)
          asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                       : "=r"(b[0]), "=r"(b[1])
                       : "r"(xq_row + j * GS));
        else
          b[0] = b[1] = 0u;
      }
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        mma_s8(c, a_lo[2 * st], a_hi[2 * st], a_lo[2 * st + 1],
               a_hi[2 * st + 1], b[2 * st], b[2 * st + 1]);
      // (float(c) * ws) * xs, each product rounded, as the reference
      const int gg = g0 + i * kGps + j;
      const float s_lo = ws_lo[gg], s_hi = ws_hi[gg];
      const float x0 = has0 ? xsc[c0 * kGps + j] : 0.f;
      const float x1 = has1 ? xsc[c1 * kGps + j] : 0.f;
      acc[0] = __fadd_rn(acc[0], __fmul_rn(__fmul_rn((float)c[0], s_lo), x0));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn((float)c[1], s_lo), x1));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn((float)c[2], s_hi), x0));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(__fmul_rn((float)c[3], s_hi), x1));
    }
    // the next stage's x, which came with this one
    if (i + 1 < nst) {
      const float* xf = reinterpret_cast<const float*>(
          smem + slot * p.stage + NB * kBoxBytes);
      quantize(i + 1, [&](int t, int j, float (&v)[PL]) {
        load_smem_lane<PL>(xf + t * SB + j * GS + lane * PL, v);
      });
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(slot));
    // stage i + 1's buffers written, stage i's read by every warp
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  }

  const int o_lo = row0 + r_lo, o_hi = o_lo + 8;
  if (nsplit == 1) {
    if (has0) {
      if (o_lo < O) y[(size_t)c0 * O + o_lo] = acc[0];
      if (o_hi < O) y[(size_t)c0 * O + o_hi] = acc[2];
    }
    if (has1) {
      if (o_lo < O) y[(size_t)c1 * O + o_lo] = acc[1];
      if (o_hi < O) y[(size_t)c1 * O + o_hi] = acc[3];
    }
    return;
  }

  // ---- split K: the sums [col][row] in the ring (every stage has been
  // read), each quad of 4 rows of one column pushed into the inbox of the
  // rank that owns it; after the barrier the owner adds the ranks' sums in
  // rank order
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  float* red = reinterpret_cast<float*>(smem);
  if (has0) {
    red[c0 * kRedLd + r_lo] = acc[0];
    red[c0 * kRedLd + r_lo + 8] = acc[2];
  }
  if (has1) {
    red[c1 * kRedLd + r_lo] = acc[1];
    red[c1 * kRedLd + r_lo + 8] = acc[3];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  float4* inbox = reinterpret_cast<float4*>(smem + p.inbox);
  const int total = T * (kRows / 4);
  const int per = p.per;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < total; e += kConsumers) {
    const int n = e / (kRows / 4), r = 4 * (e % (kRows / 4));
    const float4 v = *reinterpret_cast<const float4*>(red + n * kRedLd + r);
    const uint32_t owner = e / per;
    uint64_t dst;
    asm("mapa.u64 %0, %1, %2;\n"
        : "=l"(dst) : "l"(inbox + rank * per + (e - owner * per)),
          "r"(owner));
    *reinterpret_cast<float4*>(dst) = v;
  }
  sm90::cluster_sync();
  for (int j = tid; j < per && (int)rank * per + j < total; j += kConsumers) {
    const int e = rank * per + j;
    const int n = e / (kRows / 4), r = 4 * (e % (kRows / 4));
    float4 sum = inbox[j];
    for (uint32_t c = 1; c < nsplit; ++c) {
      const float4 w = inbox[c * per + j];
      sum.x += w.x; sum.y += w.y; sum.z += w.z; sum.w += w.w;
    }
    const int o = row0 + r;
    float* dst = y + (size_t)n * O + o;
    if ((O & 3) == 0) {
      if (o < O) *reinterpret_cast<float4*>(dst) = sum;
    } else {
      const float w[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int i = 0; i < 4 && o + i < O; ++i) dst[i] = w[i];
    }
  }
}

constexpr int kMaxDevices = 16;

// the shared memory of a launch; false if it does not fit
bool plan(int T, int K, int gs, int split, Plan& p, int& bytes) {
  const int ng = K / gs;
  const int gmax = (ng + split - 1) / split;   // the most groups a rank has
  const int sb = gs > kSB ? gs : kSB;           // bytes of K a stage
  // weight boxes, then x's (up to kMaxT rows of sb f32): 1024-aligned
  p.stage = sb / kBox * kBoxBytes + kMaxT * sb * 4;
  p.tx = T * sb * 4;
  const int nst_max = (gmax * gs + sb - 1) / sb;   // stages of a rank
  auto up = [](int v, int a) { return (v + a - 1) / a * a; };
  int sstride = gmax + 6;          // an aligned window around the groups
  sstride = up(sstride, 4);
  if (sstride % 8 == 0) sstride += 4;   // 4 (mod 8): 8 rows, 8 bank groups
  p.sstride = sstride;
  p.per = (T * (kRows / 4) + split - 1) / split;
  int rest = 0;
  p.xq = rest;
  rest = up(rest + 2 * kMaxT * (sb + 16), 16);
  p.xs = rest;
  rest = up(rest + 2 * 4 * kMaxT * (sb / gs), 16);
  p.ws = rest;
  rest = up(rest + 4 * kRows * sstride, 16);
  p.inbox = rest;
  rest += split > 1 ? 16 * split * p.per : 0;
  rest = up(rest, 8);
  const int fixed = 1024 + rest + 16 * kMaxStages;   // align slack, barriers
  int stages = (kBudget - fixed) / p.stage;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages > nst_max) stages = nst_max;
  if (stages < 1) return false;
  // the ring first, everything else after it
  const int ring = stages * p.stage;
  if (ring < 4 * kMaxT * kRedLd) return false;   // the sum tile lives there
  p.stages = stages;
  p.xq += ring; p.xs += ring; p.ws += ring; p.inbox += ring;
  p.bars = ring + rest;
  bytes = 1024 + p.bars + 16 * stages;
  return bytes <= kBudget;
}

template <int GS>
int prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        q8_gemv_i8_kernel<GS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBudget);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

// clusters of `split` blocks the card holds at once (a cluster lives in one
// GPC, so fewer fit than SMs / split); 0 if unknown
template <int GS>
int max_clusters(int dev, int split) {
  static int known[kMaxDevices][kMaxSplit + 1] = {};
  if (known[dev][split] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kBudget;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = split;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, q8_gemv_i8_kernel<GS>, &cfg) !=
        cudaSuccess)
      n = 0;
    known[dev][split] = n > 0 ? n : -1;
  }
  return known[dev][split] > 0 ? known[dev][split] : 0;
}

// the K split S from O and K only (never from T): at least what keeps a
// rank's K range within kKMax bytes, at most 8 and one group a rank, and
// of those the largest whose clusters the card holds for every row tile at
// once (a second wave of clusters costs more than the split saves), leaving
// out 5 and 7: on an H100 both were slower than a neighbouring size at
// every layer shape measured (scripts/torch_q8_gemv_split.py)
template <int GS>
int split_of(int dev, int O, int K) {
  const int tiles = (O + kRows - 1) / kRows;
  const int ng = K / GS;
  int lo = (K + kKMax - 1) / kKMax;
  const int hi = ng < kMaxSplit ? ng : kMaxSplit;
  if (lo > hi) lo = hi;
  int split = lo;
  for (int c = lo; c <= hi; ++c)
    if ((c == lo || (c != 5 && c != 7)) &&
        tiles <= max_clusters<GS>(dev, c))
      split = c;
  return split;
}

template <int GS>
int launch(const float* x, const int8_t* q, const float* s, float* y, int T,
           int O, int K, int split, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int ready = prepare<GS>();
  if (ready != 0) return ready;
  const int ng = K / GS;
  if (split <= 0) split = split_of<GS>(dev, O, K);
  if (split > kMaxSplit || split > ng || (ng + split - 1) / split * GS > kKMax)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int bytes = 0;
  if (!plan(T, K, GS, split, p, bytes)) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, xmap;
  const int sb = GS > kSB ? GS : kSB;
  if (!sm90::make_map(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, K,
                      kRows, kBox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, T, K, T,
                      sb, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + kRows - 1) / kRows * split, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, q8_gemv_i8_kernel<GS>, wmap, xmap, x, s, y,
                         T, O, K, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// The quantizer alone: x (T, K) f32 -> xq (T, K) int8, xs (T, K/gs) f32,
// with kernel D's own arithmetic (quant_group).  Needs gs in {32, 64, 128,
// 256}, K % gs == 0 and x aligned to 4 * gs / 32 bytes.  Returns
// cudaGetLastError().
extern "C" int lmrs_q8_act_quant(const float* x, int8_t* xq, float* xs, int T,
                                 int K, int gs, cudaStream_t stream) {
  if (K % gs) return (int)cudaErrorInvalidValue;
  const int n = T * (K / gs);
  const dim3 grid((n + 3) / 4);
  switch (gs) {
    case 32: q8_act_quant_kernel<1><<<grid, 128, 0, stream>>>(x, xq, xs, n); break;
    case 64: q8_act_quant_kernel<2><<<grid, 128, 0, stream>>>(x, xq, xs, n); break;
    case 128: q8_act_quant_kernel<4><<<grid, 128, 0, stream>>>(x, xq, xs, n); break;
    case 256: q8_act_quant_kernel<8><<<grid, 128, 0, stream>>>(x, xq, xs, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

namespace {

int launch_gs(const float* x, const int8_t* q, const float* s, float* y,
              int T, int O, int K, int gs, int split, cudaStream_t stream) {
  if (T < 1 || T > kMaxT || O < 1 || K % gs || K > kMaxSplit * kKMax)
    return (int)cudaErrorInvalidValue;
  switch (gs) {
    case 32: return launch<32>(x, q, s, y, T, O, K, split, stream);
    case 64: return launch<64>(x, q, s, y, T, O, K, split, stream);
    case 128: return launch<128>(x, q, s, y, T, O, K, split, stream);
    case 256: return launch<256>(x, q, s, y, T, O, K, split, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (T, K) f32, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32, one launch,
// the K split of split_of.  Needs 1 <= T <= 8, gs in {32, 64, 128, 256},
// K % gs == 0, K <= 8 * 4096, a 16-byte aligned q and x (the Python
// wrapper checks).  Returns a CUDA error code (0 on success).
extern "C" int lmrs_q8_gemv_i8(const float* x, const int8_t* q,
                               const float* s, float* y, int T, int O, int K,
                               int gs, cudaStream_t stream) {
  return launch_gs(x, q, s, y, T, O, K, gs, 0, stream);
}

// For the split sweep (scripts/torch_q8_gemv_split.py), never the wrapper:
// lmrs_q8_gemv_i8 at a K split of 1..8 ranks that the caller picks, as
// long as each rank's groups fit the scales' budget.
extern "C" int lmrs_q8_gemv_i8_at_split(const float* x, const int8_t* q,
                                        const float* s, float* y, int T,
                                        int O, int K, int gs, int split,
                                        cudaStream_t stream) {
  if (split < 1) return (int)cudaErrorInvalidValue;
  return launch_gs(x, q, s, y, T, O, K, gs, split, stream);
}

// For the split sweep: the K split lmrs_q8_gemv_i8 takes at (O, K, gs) on
// the current device, or a negative CUDA error code.
extern "C" int lmrs_q8_gemv_i8_split(int O, int K, int gs) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev >= kMaxDevices || O < 1 || K % gs)
    return -(int)cudaErrorInvalidValue;
  switch (gs) {
    case 32: return prepare<32>() ? -1 : split_of<32>(dev, O, K);
    case 64: return prepare<64>() ? -1 : split_of<64>(dev, O, K);
    case 128: return prepare<128>() ? -1 : split_of<128>(dev, O, K);
    case 256: return prepare<256>() ? -1 : split_of<256>(dev, O, K);
    default: return -(int)cudaErrorInvalidValue;
  }
}
