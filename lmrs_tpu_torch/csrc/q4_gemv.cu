// Kernel A — Q4_0 GEMV for T <= 8 rows of f32 activations, on the tensor
// cores (sm_90a, mma.sync m16n8k16 bf16 -> f32).
//
//   y[t, o] = sum_g s[o, g] * sum_{k in g} w[o, k] * x[t, k]
//
// f32 activations, exact integer weights, f32 sums.  Replaces the TPU
// kernels lmrs_tpu/kernels/vpu_matvec.py:_vm_q4_kernel (T=1, K-major tiles),
// vpu_matvec.py:_xe_q4_km_kernel (2 <= T <= 8, K-major),
// dequant_matmul.py:_q4_xe_stacked_kernel (T <= 8, row-major stacked) and
// dequant_matmul.py:_q4_xe_kernel (T <= 8, unstacked classifier): one
// function in four TPU layouts, one row-major layout here.
//
// Weights: one layer's (O, K/2) runtime Q4 bytes and (O, K/gs) f32 scales.
// A byte holds element j of a group (low nibble) and element j + gs/2 (high
// nibble), XOR 0x80:  b = u ^ 0x80, lo = (b & 15) - 8, hi = (b >> 4) - 8.
//
// Bound on an H100: device-memory bytes, the same at every T (Gemma-2-9B:
// 1.47 ms a token's matmuls at 3.35 TB/s).  What kept the CUDA-core design
// (a warp over 2 rows, f32 FMAs) from it: the multiply-adds grew with T (at
// T = 8 they alone take longer than the weight bytes), every 16-byte weight
// chunk re-read T rows of f32 x from L2, and a short layer matrix gave
// each warp one or two steps, so a launch was mostly ramp and tail.
//
// Design: the products run on the tensor cores, so that their cost does
// not grow with T; each block stages x once.
// - A operand: the integer weights, exact in bf16 (the nibble into the
//   mantissa of bf16 128, one bf16x2 subtraction of 136).  The scale stays
//   out of the operand: each segment's products are summed in a fresh
//   fragment, then acc = fmaf(s[o, g], part, acc).
// - B operand: x split exactly into three bf16 slices, x = x0 + x1 + x2
//   (x0 = bf16(x), x1 = bf16(x - x0), x2 = x - x0 - x1; exact for |x| >=
//   2^-110, and below that off by less than 2^-133): every product is
//   exact and x keeps its f32 value.  Column 3t + i of the n8 tiles holds
//   slice i of row t, so T <= 2 takes one tile (a T = 1 call does a third
//   of the products of a slice-a-tile layout), T <= 5 two, T <= 8 three.
//   Each column keeps its own sums; y = (acc_0 + acc_1) + acc_2.  A
//   column's result depends on that column alone, and every (t, o) takes
//   the same operations in the same order whatever T is, so a row of a
//   T-row call equals, bit for bit, the row computed alone (speculative
//   greedy decoding stays exact).
// - The k slots of an m16n8k16 step are permuted so that each thread's
//   weights come from one contiguous W-byte piece of its rows (W = 16 for
//   gs % 128 == 0: one 128-bit copy a row covers 8 steps): step s takes
//   bytes 2s and 2s+1 of the piece, their low nibbles as k slots 2t4,
//   2t4+1 and their high nibbles as 2t4+8, 2t4+9; the x slices are staged
//   in that order.  A segment (the 4W bytes of a row the four threads of a
//   quad load) lies in one half-group, so one scale serves it.
// - A block is 8 warps over 256 output rows (2 m16 tiles a warp, so each x
//   fragment serves both) and one range of K.  The blocks of one row range
//   form a thread-block cluster of S <= 8 that splits K; S comes from O and
//   K only (never from T): the x slices of a block's range fit kXBudget,
//   and of those S the one whose waves of blocks (two an SM) take least.
// - A block's loads start at once, in this order: its first x values (L2
//   hits, which the products wait on), its rows' scales (one cp.async
//   group, 16 bytes a copy), the weights of its first segment (cp.async
//   into a ring of kDepth stages); each warp then keeps the next segment
//   in flight under the current one's products.
// - Partial sums: each rank adds a row's three columns and pushes the sum
//   into the inbox of the rank that owns those rows (distributed shared
//   memory); after one cluster barrier the owner adds the ranks' sums in
//   rank order (no atomics, the same bits every call).  No dequantized
//   weight is written anywhere.
//
// What bounds it now: at T = 1 it takes 1.5-3.7x its byte bound at
// Gemma-2-9B's shapes (the classifier least, wo most: a short launch is
// mostly its first loads' latency and the cluster's sum).  At K = 3,072
// and T = 1 a CUDA-core warp per two rows, all of a row's loads in flight
// at once, is still ahead (Llama-3.2-3B w13 and wo as Q4).  A deeper ring
// at T <= 2 (3-5 stages, where x takes a third of the shared memory) was
// no faster.
//
// Later: more weight bytes in flight a block at T = 1 without a third of
// the x slices' shared memory; a persistent grid that walks row ranges
// with its staged x, so that the classifier's 1,000 row ranges restage
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "gemv_sm90.cuh"

namespace {

namespace gv = lmrs_gemv;

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kTiles = 2;                  // m16 tiles a warp
constexpr int kRows = kWarps * kTiles * 16;  // output rows a block
constexpr int kDepth = 2;                  // segments in flight a warp
constexpr int kStage = 8;                  // x items a thread loads at once
constexpr int kSlices = 3;                 // bf16 slices of x
constexpr int kMaxT = 8;                   // rows of x a call
constexpr int kMaxNT = (kSlices * kMaxT + 7) / 8;  // n8 tiles at kMaxT
constexpr int kRedLd = kRows + 4;          // f32 stride of the partial tile
constexpr int kMaxSplit = 8;               // portable cluster size
constexpr int kTileStepBytes = 32 * 8;     // one n8 tile's B of a k16 step
constexpr int kXBudget = 48 * 1024;        // x slices a block: two an SM
constexpr int kFixedSegs = 4;              // a block's fixed cost, segments
constexpr int kSmemMax = 227 * 1024;

// (a, b) -> three bf16x2 slices whose sums are a and b exactly (a in the low
// half: the lower k slot)
__device__ __forceinline__ void split3(float a, float b, uint32_t& s0,
                                       uint32_t& s1, uint32_t& s2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b);
  const float2 f0 = __bfloat1622float2(h0);
  const float ra = __fsub_rn(a, f0.x), rb = __fsub_rn(b, f0.y);   // exact
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 =
      __floats2bfloat162_rn(__fsub_rn(ra, f1.x), __fsub_rn(rb, f1.y));
  s0 = gv::bf16x2_bits(h0);
  s1 = gv::bf16x2_bits(h1);
  s2 = gv::bf16x2_bits(h2);
}

// W bytes of a weight row into this thread's slot of the ring, or W zero
// bytes where !in (src is then not read)
template <int W>
__device__ __forceinline__ void copy_piece(uint32_t dst, const void* src,
                                           bool in) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(W), "r"(in ? W : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// W: bytes of a row a thread loads per segment (16 where gs % 128 == 0, 8
// where gs % 64 == 0, else 4), so that a segment of 4W bytes lies in one
// half-group.  sstride: the f32 stride of the staged scale rows.
template <int W, int NT>
__global__ void __launch_bounds__(kThreads)
q4_gemv_mma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ y, int T,
                   int O, int K, int gs, int sstride) {
  constexpr int kSteps = W / 2;       // k16 steps a segment
  constexpr int kWords = W / 4;
  constexpr int kStepBytes = NT * kTileStepBytes;   // x slices a k16 step
  constexpr int kCols = 8 * NT;                     // B columns
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);

  uint32_t rank, nsplit;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nsplit));
  // the first phase of the cluster barrier: every block has started (so
  // that its shared memory may be written by the others) once all arrive
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = (blockIdx.x / nsplit) * kRows;
  const int kb = K / 2;                        // bytes a row
  const int half = gs / 2;                     // bytes a group
  const int ngroups = K / gs;
  const int nseg = kb / (4 * W);
  const int seg0 = nseg * rank / nsplit, seg1 = nseg * (rank + 1) / nsplit;
  const int nsg = seg1 - seg0;
  // the staged scales: an aligned window of groups [w_lo, w_hi)
  const bool vec = (ngroups & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  const int g_lo = seg0 * 4 * W / half;
  const int g_hi = nsg > 0 ? ((seg1 * 4 * W - 1) / half + 1) : g_lo;
  const int w_lo = vec ? (g_lo & ~3) : g_lo;
  const int w_hi = vec ? ((g_hi + 3) & ~3) : g_hi;

  // every rank lays its shared memory out for the most segments a rank
  // has, so that the partial tile sits at one offset in all of them
  const int cap = (nseg + nsplit - 1) / nsplit;
  uint2* xs = reinterpret_cast<uint2*>(smem);             // [step][tile][32]
  float* ss = reinterpret_cast<float*>(smem + cap * kSteps * kStepBytes);
  // the partial tile [col][row] takes the place of x and the scales once
  // the products are done
  float* red = reinterpret_cast<float*>(smem);
  const int region = max(cap * kSteps * kStepBytes + 4 * kRows * sstride,
                         4 * kCols * kRedLd);
  // the weight ring: kDepth stages of each thread's own 16-byte slots
  // [stage][tile][row g, g + 8][thread]
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
      ((region + 15) & ~15);
  // each rank's inbox: the other ranks' sums of the quads of rows it owns
  float4* inbox = reinterpret_cast<float4*>(
      smem + ((region + 15) & ~15) + 16 * kDepth * kTiles * 2 * kThreads);
  auto slot = [&](int stage, int i, int h) {
    return ring + 16 * (((stage * kTiles + i) * 2 + h) * kThreads + tid);
  };

  // ---- the first kDepth - 1 segments' weights, before anything waits; a
  // row past O copies zeros (its sums are never stored)
  auto issue = [&](int seg) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = row0 + (warp * kTiles + i) * 16 + g + 8 * h;
        copy_piece<W>(slot((seg - seg0) % kDepth, i, h),
                      q + (size_t)min(o, O - 1) * kb + seg * 4 * W + t4 * W,
                      o < O);
      }
  };
  // the rows' scales: one cp.async group, 16 bytes a copy where the rows
  // allow, committed before the first kDepth - 1 segments' weights
  auto issue_first = [&]() {
    const int per_row = vec ? (w_hi - w_lo) / 4 : w_hi - w_lo;
    const uint32_t ss_addr =
        static_cast<uint32_t>(__cvta_generic_to_shared(ss));
    for (int e = tid; e < kRows * per_row; e += kThreads) {
      const int r = e / per_row, c = (vec ? 4 : 1) * (e - r * per_row);
      const float* src =
          s + (size_t)min(row0 + r, O - 1) * ngroups + w_lo + c;
      const uint32_t dst = ss_addr + 4 * (r * sstride + c);
      const bool in = row0 + r < O;
      gv::cp_async_scale(dst, src, vec, in);
    }
    gv::cp_async_commit();
#pragma unroll
    for (int d = 0; d < kDepth - 1; ++d) {
      if (d < nsg) issue(seg0 + d);
      gv::cp_async_commit();
    }
  };

  // ---- x as three bf16 slices in fragment order: column c of the B tiles
  // holds slice c % 3 of row t = c / 3 of x (columns past 3T are zeros), so
  // T <= 2 takes one n8 tile, T <= 5 two, T <= 8 three.  Entry (step,
  // tile, lane) of xs holds lane's B fragment: column 8 * tile + lane / 4
  // at the k slots of t4 = lane % 4.  An item (step, t, t4) splits row t's
  // four values once and writes its three slices (zeros for t >= T up to
  // the last column); kStage items a thread at a time, their loads issued
  // together (the first batch before the weights' loads)
  constexpr int kRowsB = (8 * NT + kSlices - 1) / kSlices;   // rows of B
  const int n_items = nsg * kSteps * kRowsB * 4;
  bool first = true;
  for (int i0 = tid; i0 < n_items || first; i0 += kStage * kThreads) {
    float2 vl[kStage], vh[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int it = i0 + u * kThreads, q4 = it & 3;
      const int t = (it >> 2) % kRowsB, st = (it >> 2) / kRowsB;
      vl[u] = vh[u] = make_float2(0.f, 0.f);
      if (it < n_items && t < T) {
        const int b = (seg0 + st / kSteps) * 4 * W + q4 * W +
                      2 * (st % kSteps);        // the step's byte in a row
        const int grp = b / half;
        const int e_lo = grp * gs + (b - grp * half);
        const float* xt = x + (size_t)t * K;
        vl[u] = __ldg(reinterpret_cast<const float2*>(xt + e_lo));
        vh[u] = __ldg(reinterpret_cast<const float2*>(xt + e_lo + half));
      }
    }
    if (first) {
      issue_first();
      first = false;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int it = i0 + u * kThreads;
      if (it < n_items) {
        const int q4 = it & 3;
        const int t = (it >> 2) % kRowsB, st = (it >> 2) / kRowsB;
        uint32_t lo[kSlices], hi[kSlices];
        split3(vl[u].x, vl[u].y, lo[0], lo[1], lo[2]);
        split3(vh[u].x, vh[u].y, hi[0], hi[1], hi[2]);
#pragma unroll
        for (int i = 0; i < kSlices; ++i) {
          const int col = kSlices * t + i;
          if (col < 8 * NT)
            xs[(st * NT + col / 8) * 32 + (col % 8) * 4 + q4] =
                make_uint2(lo[i], hi[i]);
        }
      }
    }
  }
  gv::cp_async_wait<kDepth - 1>();     // the scales have landed
  __syncthreads();

  // ---- the products: a fresh fragment a segment, then times its scale;
  // a sum for each column (each slice of each row of x) apart
  float acc[kTiles][NT][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

  auto compute = [&](const uint32_t (&d)[kTiles][2][kWords], int seg,
                     int st0) {
    float part[kTiles][NT][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][n][c] = 0.f;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      uint2 b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        b[n] = xs[((st0 + j) * NT + n) * 32 + lane];
      const uint32_t sel = (j & 1) ? 0x4342u : 0x4140u;
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        const uint32_t s0 = __byte_perm(d[i][0][j >> 1], 0u, sel);
        const uint32_t s1 = __byte_perm(d[i][1][j >> 1], 0u, sel);
        const uint32_t a0 = gv::dq4_lo(s0), a1 = gv::dq4_lo(s1);
        const uint32_t a2 = gv::dq4_hi(s0), a3 = gv::dq4_hi(s1);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          gv::mma16816(part[i][n], a0, a1, a2, a3, b[n]);
      }
    }
    const int grp = seg * 4 * W / half - w_lo;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int r = (warp * kTiles + i) * 16 + g;
      const float sg = ss[r * sstride + grp];
      const float sg8 = ss[(r + 8) * sstride + grp];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[i][n][0] = fmaf(sg, part[i][n][0], acc[i][n][0]);
        acc[i][n][1] = fmaf(sg, part[i][n][1], acc[i][n][1]);
        acc[i][n][2] = fmaf(sg8, part[i][n][2], acc[i][n][2]);
        acc[i][n][3] = fmaf(sg8, part[i][n][3], acc[i][n][3]);
      }
    }
  };

#pragma unroll 1
  for (int i = 0; i < nsg; ++i) {
    // the stage read in the last iteration takes segment i + kDepth - 1
    if (i + kDepth - 1 < nsg) issue(seg0 + i + kDepth - 1);
    gv::cp_async_commit();
    gv::cp_async_wait<kDepth - 1>();        // segment i has landed
    uint32_t d[kTiles][2][kWords];
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a = slot(i % kDepth, t, h);
        if constexpr (W == 16) {
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(d[t][h][0]), "=r"(d[t][h][1]),
                         "=r"(d[t][h][2]), "=r"(d[t][h][3]) : "r"(a));
        } else if constexpr (W == 8) {
          asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                       : "=r"(d[t][h][0]), "=r"(d[t][h][1]) : "r"(a));
        } else {
          asm volatile("ld.shared.u32 %0, [%1];\n"
                       : "=r"(d[t][h][0]) : "r"(a));
        }
      }
    compute(d, seg0 + i, i * kSteps);
  }

  // ---- partial tile [col][row], then the cluster's sum in rank order:
  // each rank's (slice 0 + slice 1) + slice 2, added rank by rank
  __syncthreads();    // every warp's products are done with x and scales
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int r = (warp * kTiles + i) * 16 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t4;
      red[c * kRedLd + r] = acc[i][n][0];
      red[(c + 1) * kRedLd + r] = acc[i][n][1];
      red[c * kRedLd + r + 8] = acc[i][n][2];
      red[(c + 1) * kRedLd + r + 8] = acc[i][n][3];
    }
  }
  __syncthreads();
  // each quad of rows (of one row of x): this rank's (slice 0 + slice 1) +
  // slice 2, pushed into the inbox of the rank that owns the quad; after
  // the barrier the owner adds the ranks' sums in rank order
  const int total = T * (kRows / 4);         // quads of 4 rows
  const int per = (total + nsplit - 1) / nsplit;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < total; e += kThreads) {
    const int n = e / (kRows / 4), r = 4 * (e % (kRows / 4));
    const float* v = red + kSlices * n * kRedLd + r;
    const float4 v0 = *reinterpret_cast<const float4*>(v);
    const float4 v1 = *reinterpret_cast<const float4*>(v + kRedLd);
    const float4 v2 = *reinterpret_cast<const float4*>(v + 2 * kRedLd);
    const float4 w = make_float4((v0.x + v1.x) + v2.x, (v0.y + v1.y) + v2.y,
                                 (v0.z + v1.z) + v2.z, (v0.w + v1.w) + v2.w);
    const uint32_t owner = e / per;
    *reinterpret_cast<float4*>(
        gv::map_rank(inbox + rank * per + (e - owner * per), owner)) = w;
  }
  cluster_sync();
  for (int j = tid; j < per && (int)rank * per + j < total; j += kThreads) {
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

template <int W, int NT>
int launch(const float* x, const uint8_t* q, const float* s, float* y, int T,
           int O, int K, int gs, cudaStream_t stream) {
  static bool ready = false;
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready) {
    e = cudaFuncSetAttribute(q4_gemv_mma_kernel<W, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  // the K split S, from O and K only (sized for kMaxNT tiles of x), so the
  // same for every T: the x slices of a block within its share of shared
  // memory, each block at least one segment, and of those the S whose
  // waves of blocks take least: waves x (segments a block + kFixedSegs)
  const int nseg = K / 2 / (4 * W);
  const int half = gs / 2;
  const int ranges = (O + kRows - 1) / kRows;
  auto smem_of = [&](int split, int nt) {
    const int segs = (nseg + split - 1) / split;   // the most a block has
    // scale window: the groups of `segs` segments, widened to 4-aligned ends
    // 4 (mod 8) floats: 16-byte rows, and the 8 rows a warp reads at once
    // hit 8 banks
    int sstride = (segs * 4 * W + half - 1) / half + 1 + 6;
    sstride = ((sstride + 3) & ~3) | 4;
    size_t region = (size_t)segs * (W / 2) * nt * kTileStepBytes +
                    4 * (size_t)kRows * sstride;
    if (region < 4 * (size_t)8 * nt * kRedLd)
      region = 4 * (size_t)8 * nt * kRedLd;
    const size_t bytes = ((region + 15) & ~(size_t)15) +
                         16 * (size_t)kDepth * kTiles * 2 * kThreads;
    return std::make_pair(bytes, sstride);
  };
  const int seg_bytes = (W / 2) * kMaxNT * kTileStepBytes;
  int lo = (nseg * seg_bytes + kXBudget - 1) / kXBudget;
  int hi = nseg < kMaxSplit ? nseg : kMaxSplit;
  if (lo > hi) lo = hi;
  if (lo < 1) lo = 1;
  int split = lo;
  long best = -1;
  for (int c = lo; c <= hi; ++c) {
    const size_t bytes = smem_of(c, kMaxNT).first +
                         16 * (size_t)(kMaxT * (kRows / 4) + c);
    if (bytes > (size_t)kSmemMax) continue;
    int per_sm = (int)((228 * 1024) / (bytes + 1024));
    if (per_sm > 2) per_sm = 2;
    if (per_sm < 1) per_sm = 1;
    const long slots = (long)per_sm * sms[dev];
    const long waves = ((long)ranges * c + slots - 1) / slots;
    const long cost = waves * ((nseg + c - 1) / c + kFixedSegs);
    if (best < 0 || cost < best) {
      best = cost;
      split = c;
    }
  }
  auto [smem, sstride] = smem_of(split, NT);
  const int quads = T * (kRows / 4);
  smem += 16 * (size_t)split * ((quads + split - 1) / split);   // inboxes
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranges * split, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, q4_gemv_mma_kernel<W, NT>, x, q, s, y, T, O,
                         K, gs, sstride);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int W>
int launch_t(const float* x, const uint8_t* q, const float* s, float* y,
             int T, int O, int K, int gs, cudaStream_t stream) {
  // n8 tiles of B: the 3T columns of x's slices
  if (kSlices * T <= 8) return launch<W, 1>(x, q, s, y, T, O, K, gs, stream);
  if (kSlices * T <= 16) return launch<W, 2>(x, q, s, y, T, O, K, gs, stream);
  return launch<W, 3>(x, q, s, y, T, O, K, gs, stream);
}

}  // namespace

// x (T, K) f32, q (O, K/2) u8 runtime layout, s (O, K/gs) f32 -> y (T, O)
// f32.  Needs 1 <= T <= 8, gs % 32 == 0, K % gs == 0, K <= 16,384 and
// 16-byte aligned x and q rows (the Python wrapper checks).  Returns a CUDA
// error code (0 on success).
extern "C" int lmrs_q4_gemv(const float* x, const uint8_t* q, const float* s,
                            float* y, int T, int O, int K, int gs,
                            cudaStream_t stream) {
  if (T < 1 || T > kMaxT || gs % 32 || K % gs || O < 1)
    return (int)cudaErrorInvalidValue;
  const int half = gs / 2;
  if (half % 64 == 0) return launch_t<16>(x, q, s, y, T, O, K, gs, stream);
  if (half % 32 == 0) return launch_t<8>(x, q, s, y, T, O, K, gs, stream);
  return launch_t<4>(x, q, s, y, T, O, K, gs, stream);
}
