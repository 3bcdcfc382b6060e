// The template of kernels B (q4_gemm.cu) and F (q8_gemm.cu): a quantized
// GEMM for 9 <= T <= 512 rows on Hopper (sm_90a).
//
//   y (T, O) f32 = x_bf16 (T, K) . W_deq^T,  W_deq = bf16(bf16(w) * bf16(s))
//
// computed transposed, y^T = W_deq . x^T, with wgmma m64nNk16: A is the
// dequantized weight tile, built in registers straight in wgmma's A-fragment
// layout; B is the x tile in shared memory (K-major, 128-byte swizzle); N
// is T rounded up to 16, 32, 64, 128 or 256 (T > 256: two N halves, a
// grid row each).
//
// A block is three warpgroups over 128 output features.  The first warp of
// the last warpgroup is the producer: for each K chunk it waits for a free
// stage of the shared-memory ring and asks TMA for the x chunk (rows past T
// read as zeros), the 128 rows of packed weight bytes (64 bytes a row,
// 64-byte swizzle; rows past O read as zeros) and the rows' group scales
// (an aligned window of four groups; cp.async copies where the scale rows
// are not 16-byte aligned); all complete on the stage's "full" mbarrier.
// The first two warpgroups consume, 64 features each: every thread reads
// its 2-byte pieces of the weight rows from shared memory, dequantizes them
// in packed form (below) into wgmma A fragments and issues the wgmmas, one
// a commit group, one in flight (three at N <= 32, where a product is
// short).  A stage goes back to the producer once the products that read
// it are done.  The producer warpgroup hands its registers to the consumers
// (setmaxnreg, 40 / 232) where one block runs an SM; tiles of N <= 32 run
// two blocks an SM instead.  Each weight element is dequantized once per
// call for T <= 256.
//
// Packed dequant (two values per 32-bit register, bit for bit
// kernels/q{4,8}_gemm.dequant_bf16):
//   Q4  a 4-bit value n (0..15, w = n - 8) goes into the mantissa of the
//       bf16 constant 128 (0x4300 | n = 128 + n, exact); one bf16x2
//       subtraction of 136 gives w exactly, one bf16x2 multiply by bf16(s)
//       rounds once to nearest even.  The runtime layout pairs element j
//       (low nibble) with element j + gs/2 (high nibble, its top bit
//       XOR-biased): a thread's two bytes give the A fragment of a k16 step
//       in a group's first half and, from their high nibbles, of the step
//       gs/2 further on, so the kernel issues the two steps back to back (a
//       reordering of the sum over K, nothing else).
//   Q8  an int8 v: X = 0x4300 | (v & 0x7f) = 128 + (v & 127) and C =
//       0x4300 | (v & 0x80) = 128 or 256 are exact bf16 values with X - C =
//       v; one subtraction and one multiply as for Q4.
// The f32 product of two bf16 values is exact, so the one rounding of the
// multiply gives the bits of bf16(f32(w) * f32(bf16(s))).
//
// Split-K for small grids: a cluster of S blocks shares one output tile,
// each block a contiguous range of K chunks; S <= 8 is the largest for which
// the card holds the clusters of all tiles at once (split_k).  Each block
// stages its partial tile in its own shared memory; after a cluster barrier
// block r sums a 1/S slice of the tile over blocks 0..S-1 in that fixed
// order (distributed shared memory) and writes it: no atomics, the same
// bits on every run.  With S = 1 the same path stages the tile for
// coalesced stores.  Nothing dequantized leaves the SM.
//
// The epilogue is a template parameter (Epi).  Store writes y (kernels B
// and F).  Glu is the first stage of kernel L (ffn_fused.cu): a block's 128
// rows are 64 gate rows j0..j0+63 of W13 (consumer warpgroup 0) and the 64
// matching up rows H+j0.. (warpgroup 1), from two weight maps of H rows
// each (a box past row H reads zeros, never the other half); after the
// cluster's sum the block forms g = bf16(act(gate) * up) in f32 and writes
// bf16 g (T, H): [gate; up] never reaches device memory.  Down is Store
// under another name: L's second stage, g . W2^T, told apart from F in a
// profile.  K need not be a multiple of the chunk: TMA reads the columns
// past K as zeros and the scales past the last group are copied as zeros.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_sm90.cuh"

// internal linkage throughout: two libraries built from this header (a
// kernel and its variant) must not share the host-side statics
namespace lmrs_sm90 {
namespace {

enum class Quant { Q4, Q8 };
enum class Epi { Store, Glu, Down };

constexpr int kRows = 128;         // output features per block
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's
constexpr int kWBytes = 64;        // weight bytes a row per stage
constexpr int kSteps = 4;          // k16 steps (Q8) or step pairs (Q4)
constexpr int kScaleCols = 4;      // scale groups a row per stage (16 B)
constexpr int kSmemLimit = 232448; // a block's dynamic shared memory
constexpr int kSmemPerSM = 233472;
constexpr int kMaxStages = 8;
constexpr int kMaxSplit = 8;       // portable cluster size
constexpr int kRedLd = kRows + 4;  // f32 row stride of the staged tile
static_assert(kRows == 128, "the epilogue indexes quads of 4 features");

template <Quant Q, int N>
struct Layout {
  static constexpr int BK = Q == Quant::Q4 ? 128 : 64;  // K elements/stage
  static constexpr int kAtoms = BK / 64;        // 128-byte x columns
  static constexpr int kXBytes = N * BK * 2;
  static constexpr int kWTile = kRows * kWBytes;
  static constexpr int kSBytes = kRows * kScaleCols * 4;
  static constexpr int kStage =
      (kXBytes + kWTile + kSBytes + 1023) / 1024 * 1024;
  static constexpr int kRed = N * kRedLd * 4;
  // narrow tiles run two blocks an SM (the SM's 228 KB, 1 KB reserved per
  // block), so that more weight bytes are in flight
  static constexpr int kBlocks = N <= 32 ? 2 : 1;
  static constexpr int kBudget =
      kBlocks == 1 ? kSmemLimit : (kSmemPerSM / kBlocks - 1024);
  static constexpr int kFit = (kBudget - 1024 - 256) / kStage;
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kBody =
      kStages * kStage > kRed ? kStages * kStage : kRed;
  static constexpr int kSmem = 1024 + kBody + 256;  // align slack, barriers
  // wgmma groups in flight (one wgmma a group): narrow tiles keep three,
  // so that short products overlap; from N = 64 one (more measured slower)
  static constexpr int kDepth = N <= 32 ? 3 : 1;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kSmem <= kBudget, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// waits for the phase of `bar` with this parity to complete; a ring that
// never completes (a fault) ends the launch with an error rather than
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1) : "memory");
}

// 4 bytes from src, or 4 zero bytes where !in (src is not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// a fragment's definition stays ahead of the fence that follows (volatile
// asm statements keep their order) and of the products that read it
__device__ __forceinline__ void wg_pin(const uint32_t (&a)[4]) {
  asm volatile("" :: "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n"
               :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// descriptor of a K-major, 128-byte-swizzled B tile: rows of 128 bytes, 8-row
// groups 1,024 bytes apart (the leading offset is unused in this mode)
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t bf16x2_splat(float s) {
  const uint32_t u = __bfloat16_as_ushort(__float2bfloat16_rn(s));
  return u | (u << 16);
}

__device__ __forceinline__ uint32_t sub_mul(uint32_t x, uint32_t c,
                                            uint32_t s) {
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
                             *reinterpret_cast<__nv_bfloat162*>(&c));
  v = __hmul2(v, *reinterpret_cast<__nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bytes of a 16-bit load into the low bytes of two 16-bit halves
__device__ __forceinline__ uint32_t spread(uint32_t w) {
  return __byte_perm(w, 0u, 0x4140);
}

// low nibbles: elements 2t, 2t+1 of a step in a group's first half
__device__ __forceinline__ uint32_t dq4_lo(uint32_t sp, uint32_t s2) {
  return sub_mul((sp & 0x000F000Fu) | 0x43004300u, 0x43084308u, s2);
}

// high nibbles (top bit biased): the same elements gs/2 further on
__device__ __forceinline__ uint32_t dq4_hi(uint32_t sp, uint32_t s2) {
  return sub_mul(((sp >> 4) & 0x000F000Fu) ^ 0x43084308u, 0x43084308u, s2);
}

__device__ __forceinline__ uint32_t dq8(uint32_t sp, uint32_t s2) {
  return sub_mul((sp & 0x007F007Fu) | 0x43004300u,
                 (sp & 0x00800080u) | 0x43004300u, s2);
}

// first K element (within a stage) of step p, and its distance to the
// paired step: Q4 pairs byte offset 16p's low and high nibbles
template <Quant Q>
__device__ __forceinline__ int step_elem(int p, int half) {
  return Q == Quant::Q4 ? 16 * p + ((16 * p) & ~(half - 1)) : 16 * p;
}

// the Glu epilogue's operands: the up rows' maps (W13 rows [H, 2H)), their
// scales for the cp.async path, g (T, H) bf16 out, the activation
struct GluArgs {
  CUtensorMap umap, usmap;
  const float* su;
  __nv_bfloat16* g;
  int act;                    // 0: silu, 1: tanh-GELU
};

// The GLU of lmrs_tpu/kernels/fused_ffn.py:105-110 in f32, in its order of
// operations (no contraction into fma), rounded to bf16 once.
__device__ __forceinline__ __nv_bfloat16 glu(float gate, float up, int act) {
  float a;
  if (act == 0) {
    a = __fmul_rn(gate, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gate))));
  } else {
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, gate), gate),
                                 gate);
    const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(gate, cube));
    a = __fmul_rn(__fmul_rn(0.5f, gate), __fadd_rn(1.0f, tanhf(inner)));
  }
  return __float2bfloat16_rn(__fmul_rn(a, up));
}

template <Quant Q, int N, Epi E>
__global__ void __launch_bounds__(kThreads, (Layout<Q, N>::kBlocks))
qgemm_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap smap,
             const float* __restrict__ s, float* __restrict__ y, int T, int O,
             int K, int gs, int scale_tma,
             const __grid_constant__ GluArgs glu_args) {
  using L = Layout<Q, N>;
  // output rows a tile: Glu pairs 64 gate rows with their 64 up rows
  constexpr int kTileRows = E == Epi::Glu ? kRows / 2 : kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBody);
  auto full = [&](int i) { return smem_u32(bars + i); };
  auto empty = [&](int i) { return smem_u32(bars + L::kStages + i); };

  const int tid = threadIdx.x;
  // the cluster: the nsplit blocks of one output tile, along K
  uint32_t rank, nsplit;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nsplit));
  const int o0 = (blockIdx.x / nsplit) * kTileRows;
  const int n0 = blockIdx.y * N;
  const int nchunks = (K + L::BK - 1) / L::BK;
  const int c0 = nchunks * rank / nsplit;
  const int c1 = nchunks * (rank + 1) / nsplit;

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      // expect_tx, and the producer's 32 lanes when cp.async copies scales
      mbar_init(full(i), scale_tma ? 1 : 33);
      mbar_init(empty(i), 2);     // one thread per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: the last warpgroup gives its registers to the
    // consumers; its first warp fills the ring
    if constexpr (L::kBlocks == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int lane = tid - kConsumers;
    const int ngroups = K / gs;
    int stage = 0;
    uint32_t phase = 0;
    for (int c = c0; c < (lane < 32 ? c1 : c0); ++c) {
      mbar_wait(empty(stage), phase ^ 1);
      const uint32_t xs = smem_u32(smem + stage * L::kStage);
      const uint32_t ws = xs + L::kXBytes;
      const uint32_t ss = ws + L::kWTile;
      const int g0 = c * L::BK / gs;     // first group of the chunk
      if (!scale_tma) {
        // scale rows not 16-byte aligned: [row][4] by 4-byte copies, zeros
        // past the last row or group
        for (int i = lane; i < kRows * kScaleCols; i += 32) {
          const int r = i / kScaleCols, g = g0 + i % kScaleCols;
          const bool up = E == Epi::Glu && r >= kTileRows;
          const int o = o0 + (up ? r - kTileRows : r);
          const bool in = o < O && g < ngroups;
          cp_async4(ss + 4 * i,
                    (up ? glu_args.su : s) + (in ? (size_t)o * ngroups + g
                                                 : 0),
                    in);
        }
        cp_async_arrive(full(stage));
      }
      if (lane == 0) {
        mbar_expect_tx(full(stage), L::kXBytes + L::kWTile +
                                    (scale_tma ? L::kSBytes : 0));
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load_2d(xs + a * N * 128, &xmap, full(stage),
                      c * L::BK + a * 64, n0);
        tma_load_2d(ws, &wmap, full(stage), c * kWBytes, o0);
        if constexpr (E == Epi::Glu)
          tma_load_2d(ws + kTileRows * kWBytes, &glu_args.umap, full(stage),
                      c * kWBytes, o0);
        // the aligned window of 4 groups holding the chunk's (in bounds:
        // a box past the last column faults)
        if (scale_tma) {
          tma_load_2d(ss, &smap, full(stage), g0 & ~3, o0);
          if constexpr (E == Epi::Glu)
            tma_load_2d(ss + kTileRows * kScaleCols * 4, &glu_args.usmap,
                        full(stage), g0 & ~3, o0);
        }
      }
      if (++stage == L::kStages) { stage = 0; phase ^= 1; }
      __syncwarp();
    }
    cluster_sync();   // partial tiles staged
    cluster_sync();   // slices summed: the shared memory may go
    return;
  }

  // ---- consumers: two warpgroups of 64 features
  if constexpr (L::kBlocks == 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ltid = tid & 127;
  const int warp = ltid / 32, lane = ltid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = (tid / 128) * 64 + warp * 16 + g;    // tile row, and r0 + 8
  const int swz = ((r0 >> 1) & 3) << 4;              // 64-byte swizzle
  const int half = gs / 2;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int c = c0; c < c1; ++c) {
    mbar_wait(full(stage), phase);
    __syncwarp();     // the warpgroup's instructions below are .aligned
    const uint8_t* st = smem + stage * L::kStage;
    const uint32_t xs = smem_u32(st);
    const uint8_t* w0 = st + L::kXBytes + r0 * kWBytes;
    const uint8_t* w1 = w0 + 8 * kWBytes;
    const float* sc = reinterpret_cast<const float*>(st + L::kXBytes +
                                                     L::kWTile);
    const int lead = c * L::BK % gs;   // the chunk's offset in its group
    // the column of the chunk's first group in the staged [row][4] scales
    const int gcol = scale_tma ? (c * L::BK / gs) & 3 : 0;
    auto desc = [&](int k) {
      return x_desc(xs + (k >> 6) * (N * 128) + (k & 63) * 2);
    };
    // the A fragments of step p (Q8: f0) or of step pair p (Q4: f0 the
    // low nibbles, step e; f1 the high nibbles, step e + gs/2)
    auto build = [&](int p, uint32_t (&f0)[4], uint32_t (&f1)[4]) {
      const int b = 16 * p + 2 * t4;
      const uint32_t b00 =
          spread(*reinterpret_cast<const uint16_t*>(w0 + (b ^ swz)));
      const uint32_t b01 =
          spread(*reinterpret_cast<const uint16_t*>(w0 + ((b + 8) ^ swz)));
      const uint32_t b10 =
          spread(*reinterpret_cast<const uint16_t*>(w1 + (b ^ swz)));
      const uint32_t b11 =
          spread(*reinterpret_cast<const uint16_t*>(w1 + ((b + 8) ^ swz)));
      const int at = lead + step_elem<Q>(p, half);  // 0..3 groups past g0
      const int gi = gcol + (at >= gs) + (at >= 2 * gs) + (at >= 3 * gs);
      const uint32_t s0 = bf16x2_splat(sc[r0 * kScaleCols + gi]);
      const uint32_t s1 = bf16x2_splat(sc[(r0 + 8) * kScaleCols + gi]);
      if constexpr (Q == Quant::Q4) {
        f0[0] = dq4_lo(b00, s0); f0[1] = dq4_lo(b10, s1);
        f0[2] = dq4_lo(b01, s0); f0[3] = dq4_lo(b11, s1);
        f1[0] = dq4_hi(b00, s0); f1[1] = dq4_hi(b10, s1);
        f1[2] = dq4_hi(b01, s0); f1[3] = dq4_hi(b11, s1);
      } else {
        f0[0] = dq8(b00, s0); f0[1] = dq8(b10, s1);
        f0[2] = dq8(b01, s0); f0[3] = dq8(b11, s1);
      }
    };
    // one wgmma a commit group; once kDepth + 1 groups of this chunk are
    // issued, the previous chunk's products are done and its stage goes back
    // to the producer
#pragma unroll
    for (int p = 0; p < kSteps; ++p) {
      uint32_t f0[4], f1[4];
      build(p, f0, f1);
#pragma unroll
      for (int h = 0; h < (Q == Quant::Q4 ? 2 : 1); ++h) {
        const int j = Q == Quant::Q4 ? 2 * p + h : p;
        const uint32_t (&f)[4] = h == 0 ? f0 : f1;
        wg_pin(f);
        wg_fence();
        WgmmaRS<N>::run(acc, f, desc(step_elem<Q>(p, half) + h * half));
        wg_commit();
        wg_wait<L::kDepth>();
        if (j == L::kDepth && c > c0 && ltid == 0) mbar_arrive(empty(prev));
        __syncwarp();
      }
    }
    prev = stage;
    if (++stage == L::kStages) { stage = 0; phase ^= 1; }
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");

  // stage the partial tile [token][feature] over the ring, once both
  // consumer warpgroups are done with it
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
    red[col * kRedLd + row] = acc[i];
  }
  cluster_sync();
  const int tn = min(N, T - n0);
  if constexpr (E == Epi::Glu) {
    // block r takes quads of 4 gate rows [e0, e1) and their up rows, each
    // summed over the cluster's blocks 0..S-1 in that order, then the GLU
    const int total = tn * (kTileRows / 4);
    const int e0 = total * rank / nsplit, e1 = total * (rank + 1) / nsplit;
    const uint32_t red_addr = smem_u32(red);
    for (int e = e0 + tid; e < e1; e += kConsumers) {
      const int n = e / (kTileRows / 4), r = 4 * (e % (kTileRows / 4));
      const int j = o0 + r;
      float4 sum[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t local =
            red_addr + 4 * (n * kRedLd + r + h * kTileRows);
        for (uint32_t q = 0; q < nsplit; ++q) {
          uint32_t remote;
          float4 v;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(remote) : "r"(local), "r"(q));
          asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                       : "r"(remote) : "memory");
          if (q == 0) {
            sum[h] = v;
          } else {
            sum[h].x += v.x; sum[h].y += v.y;
            sum[h].z += v.z; sum[h].w += v.w;
          }
        }
      }
      if (j < O) {     // O = H, a multiple of 4: the quad is all in or out
        const __nv_bfloat16 out[4] = {
            glu(sum[0].x, sum[1].x, glu_args.act),
            glu(sum[0].y, sum[1].y, glu_args.act),
            glu(sum[0].z, sum[1].z, glu_args.act),
            glu(sum[0].w, sum[1].w, glu_args.act)};
        *reinterpret_cast<uint2*>(glu_args.g + (size_t)(n0 + n) * O + j) =
            *reinterpret_cast<const uint2*>(out);
      }
    }
    cluster_sync();
    return;
  }
  // block r sums quads of 4 features [e0, e1) over the cluster's blocks
  // 0..S-1 in that order; four quads' loads in flight a thread
  const int total = tn * (kRows / 4);
  const int e0 = total * rank / nsplit, e1 = total * (rank + 1) / nsplit;
  const uint32_t red_addr = smem_u32(red);
  constexpr int kU = 4;
  for (int e = e0 + tid; e < e1; e += kU * kConsumers) {
    float4 sum[kU];
    for (uint32_t q = 0; q < nsplit; ++q) {
      float4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int eu = min(e + u * kConsumers, e1 - 1);
        const uint32_t local =
            red_addr + 4 * ((eu >> 5) * kRedLd + (eu & 31) * 4);
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote) : "r"(local), "r"(q));
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z), "=f"(v[u].w)
                     : "r"(remote) : "memory");
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (q == 0) {
          sum[u] = v[u];
        } else {
          sum[u].x += v[u].x; sum[u].y += v[u].y;
          sum[u].z += v[u].z; sum[u].w += v[u].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int eu = e + u * kConsumers;
      if (eu >= e1) break;
      const int n = eu >> 5, o = o0 + (eu & 31) * 4;
      float* dst = y + (size_t)(n0 + n) * O + o;
      if ((O & 3) == 0) {
        if (o < O) *reinterpret_cast<float4*>(dst) = sum[u];
      } else {
        const float w[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
        for (int i = 0; i < 4 && o + i < O; ++i) dst[i] = w[i];
      }
    }
  }
  cluster_sync();
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no link
// against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map over a row-major (rows, cols) array of `elem`-byte values read
// in boxes of (box_rows, box_cols); out-of-range rows read as zeros
inline bool make_map(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type,
                     int elem, int rows, int cols, int box_rows, int box_cols,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// output rows a tile of epilogue E
template <Epi E>
constexpr int tile_rows() {
  return E == Epi::Glu ? kRows / 2 : kRows;
}

// the kernel's shared-memory size, set once (launches and occupancy
// queries need it)
template <Quant Q, int N, Epi E = Epi::Store>
int prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t err =
        cudaFuncSetAttribute(qgemm_kernel<Q, N, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<Q, N>::kSmem);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

// clusters of `split` blocks of this kernel that the card holds at once (a
// cluster lives in one GPC, so fewer fit than SMs / split); 0 if unknown
template <Quant Q, int N, Epi E = Epi::Store>
int max_clusters(int split) {
  static int known[kMaxSplit + 1] = {};
  if (known[split] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = Layout<Q, N>::kSmem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = split;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (prepare<Q, N, E>() != 0 ||
        cudaOccupancyMaxActiveClusters(&n, qgemm_kernel<Q, N, E>, &cfg) !=
            cudaSuccess)
      n = 0;
    known[split] = n > 0 ? n : -1;
  }
  return known[split] > 0 ? known[split] : 0;
}

// blocks sharing one output tile: the most, up to 8 (a portable cluster) and
// one per K chunk, for which the clusters of all tiles are resident at once.
// A second wave of clusters costs more than the split saves
// (scripts/torch_gemm_split.py)
template <Quant Q, int N, Epi E = Epi::Store>
int split_k(int T, int O, int K) {
  const int rows = tile_rows<E>();
  const int tiles = (O + rows - 1) / rows * ((T + N - 1) / N);
  const int nchunks = (K + Layout<Q, N>::BK - 1) / Layout<Q, N>::BK;
  int split = 1;
  for (int s = 2; s <= kMaxSplit && s <= nchunks; ++s)
    if (tiles <= max_clusters<Q, N, E>(s)) split = s;
  return split;
}

// split <= 0: split_k's choice.  Glu: q, s are the gate rows [0, O) of W13
// and uq, us the up rows (O of each), g the (T, O) bf16 output (y unused)
template <Quant Q, int N, Epi E = Epi::Store>
int launch_n(const void* x, const void* q, const float* s, float* y, int T,
             int O, int K, int gs, cudaStream_t stream, int split,
             const void* uq = nullptr, const float* us = nullptr,
             __nv_bfloat16* g = nullptr, int act = 0) {
  using L = Layout<Q, N>;
  constexpr int rows = tile_rows<E>();
  const int ready = prepare<Q, N, E>();
  if (ready != 0) return ready;
  // scales through TMA where their rows are 16-byte aligned and a chunk's
  // groups lie in one aligned window of four (power-of-two group sizes:
  // every model shape); else the producer copies them with cp.async
  const int ngroups = K / gs;
  const int scale_tma =
      ngroups % kScaleCols == 0 && (gs & (gs - 1)) == 0 &&
      reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
      (E != Epi::Glu || reinterpret_cast<uintptr_t>(us) % 16 == 0);

  CUtensorMap xmap, wmap, smap = {};
  GluArgs glu_args = {};
  const int wcols = Q == Quant::Q4 ? K / 2 : K;
  if (!make_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, T, K, N, 64,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, wcols, rows,
                kWBytes, CU_TENSOR_MAP_SWIZZLE_64B) ||
      (scale_tma &&
       !make_map(&smap, s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, O, ngroups,
                 rows, kScaleCols, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  if constexpr (E == Epi::Glu) {
    if (!make_map(&glu_args.umap, uq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O,
                  wcols, rows, kWBytes, CU_TENSOR_MAP_SWIZZLE_64B) ||
        (scale_tma &&
         !make_map(&glu_args.usmap, us, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   O, ngroups, rows, kScaleCols, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return (int)cudaErrorInvalidValue;
    glu_args.su = us;
    glu_args.g = g;
    glu_args.act = act;
  }
  if (split <= 0) split = split_k<Q, N, E>(T, O, K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + rows - 1) / rows * split, (T + N - 1) / N, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, qgemm_kernel<Q, N, E>, xmap, wmap, smap, s, y,
                         T, O, K, gs, scale_tma, glu_args);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// calls f with std::integral_constant<int, N>: N the rows of one half (T >
// 256 takes two) rounded up to a width
template <typename F>
int with_width(int T, F&& f) {
  const int halves = (T + 255) / 256;
  const int rows = (T + halves - 1) / halves;
  if (rows <= 16) return f(std::integral_constant<int, 16>{});
  if (rows <= 32) return f(std::integral_constant<int, 32>{});
  if (rows <= 64) return f(std::integral_constant<int, 64>{});
  if (rows <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

template <Quant Q>
int launch(const void* x, const void* q, const float* s, float* y, int T,
           int O, int K, int gs, cudaStream_t stream, int split = 0) {
  return with_width(T, [&](auto n) {
    return launch_n<Q, decltype(n)::value>(x, q, s, y, T, O, K, gs, stream,
                                           split);
  });
}

}  // namespace
}  // namespace lmrs_sm90
