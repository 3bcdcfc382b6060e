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
// 24.4 us at 3.35 TB/s; Llama-3.2-3B Q8_0: 77.9 MB, 23.3 us); x, g and y
// are a few hundred KB at most.
//
// K: two launches from one C call, the GLU stage then the down stage, on
// the tensor cores (gemv_sm90.cuh: mma.sync m16n8k16 on the exact integer
// weights, as kernel A).  What held the CUDA-core K back: its products (T
// f32 FMAs a weight, T rows of activations reloaded a 16-byte chunk) grew
// with T; its down stage gave work to only D / 2 warps, so most of the card
// idled through it; one grid-wide barrier kept every W2 byte waiting for
// the last gate/up row; and a lane had 64-128 bytes of two rows in flight.
// - A block is 256 weight rows and a producer warp: one thread asks TMA
//   for the block's rows a stage at a time (128 bytes of each row, two
//   128-row boxes, 128-byte swizzle) into a ring of up to kMaxStages 32 KB
//   stages that fills the SM's shared memory (one block an SM), each
//   completing on its "full" mbarrier and handed back on its "empty" one.
//   16 consumer warps: two for each 16-row slice of the boxes (two m16
//   tiles a warp), one taking the even segments of every stage and one the
//   odd (with 8 warps an SM the products, not the stream, set the pace).
// - B operand: bf16(x) (the GLU stage) or g (the down stage), one slice:
//   column t of the n8 tile holds row t (zeros past T), so one tile serves
//   every T <= 8.  The consumers copy their rank's columns of it into shared
//   memory once, each aligned 4 values e .. e+3 as the words (e, e+2) and
//   (e+1, e+3), its rows 2 (mod 32) words apart, so that the 8-byte loads
//   of a half warp hit 32 banks.
// - k slots: a thread reads one contiguous W-byte piece of its two rows of
//   a tile a segment (4W bytes of a row a quad, inside one scale group).
//   Q4: step 2q + o takes bytes 4q + o and 4q + 2 + o of the piece, their
//   low nibbles as k slots 2t4, 2t4+1 and their high nibbles (gs/2
//   elements further on) as 2t4+8, 2t4+9; Q8: the same bytes as slots 2t4,
//   2t4+1 and their partners W/2 bytes further on as 2t4+8, 2t4+9.  So a
//   register of A comes from one word (shifted by 8 bits for odd steps)
//   with one lop3 and one bf16x2 subtraction, no byte permute, and B's
//   slots name the same elements: one 8-byte load of each of x's two runs
//   serves two steps.  A segment sums in a fresh fragment, then acc =
//   fmaf(s, part, acc), in increasing k order for each warp of a slice; the
//   even segments' sum plus the odd segments' sum, in that order.
// - The GLU stage: a warp's two tiles are gate rows j..j+15 of W13 and
//   their up rows H+j..H+j+15, so the m16n8 accumulator layout puts gate(t,
//   j) and up(t, j) in the same registers of one thread: g = bf16(act(gate)
//   * up) is formed there (after the cluster's sum where D is split) and
//   written as bf16 (T, H).  [gate; up] never reaches device memory.
// - The down stage splits H over a thread-block cluster so that every SM
//   has work: each rank pushes its sums into the inbox of the rank that
//   owns those rows (distributed shared memory) and the owner adds them in
//   rank order after one cluster barrier (no atomics).  Each stage's split
//   S comes from its rows and K only, never from T: the largest of 1, 2, 3,
//   4, 6 and 8 whose clusters the card holds for every row range at once
//   (clusters of 5 and 7 were slow for kernel D).  Every (t, o) takes the
//   same operations in the same order whatever T is, so a row of a T-row
//   call equals, bit for bit, the row computed alone (speculative greedy
//   decoding stays exact).
// - The down stage is a programmatic dependent launch
//   (cudaLaunchAttributeProgrammaticStreamSerialization): the GLU stage's
//   threads execute griddepcontrol.launch_dependents once its last weight
//   loads are issued, so the down stage's blocks start on the SMs that free
//   up; they set up their barriers and start their scales and first W2
//   stages (which do not depend on g) and execute griddepcontrol.wait, which
//   returns once the GLU stage has completed and flushed, before they read
//   g.  The two launches cost one host call; no cooperative launch and no
//   grid barrier.
//
// What bounds it now (an H100 80GB HBM3 at 700 W, each call after a 128 MB
// L2 flush; PERF.md §6, scripts/torch_ffn_xe_timeline.py): the weight
// stream runs at ~2.2 TB/s while the flush's dirty lines are written back,
// a stage's products take ~0.9 us against ~1.6 us of stream a stage, and
// the down stage waits ~5 us past the GLU stage's last block (its own W2
// stages fill the memory system meanwhile), then its products set the pace
// (its W2 is mostly in shared memory by then).  Tried and measured no
// faster: per-range flags in place of griddepcontrol.wait (a down block
// waiting only for the GLU blocks of its columns of g: its polls queue
// behind the same W2 traffic), fewer W2 stages before the wait, and bf16
// operands offset by 136 with a correcting product of ones.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_sm90.cuh"
#include "qgemm_sm90.cuh"

namespace {

namespace sm90 = lmrs_sm90;
namespace gv = lmrs_gemv;

enum Quant { kQ4 = 0, kQ8 = 1 };
enum Numerics { kXe = 0, kDeq = 1 };
enum Stage { kGlu = 0, kDown = 1 };   // K's two launches

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

// ---- kernel K
constexpr int kWarps = 8;                    // warps of a row range
constexpr int kHalves = 2;    // warps a row range: each takes every other
                              // segment of a stage
constexpr int kConsumerWarps = kHalves * kWarps;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kTiles = 2;                    // m16 tiles a warp
constexpr int kBoxRows = kWarps * 16;        // a box: tile i of every warp
constexpr int kRows = kTiles * kBoxRows;     // weight rows a block
constexpr int kBox = 128;                    // bytes of a row a stage
constexpr int kBoxBytes = kBoxRows * kBox;   // 16 KB
constexpr int kStageBytes = kTiles * kBoxBytes;
constexpr int kMaxT = 8;
constexpr int kMaxSplit = 8;                 // portable cluster size
constexpr int kMaxStages = 8;
constexpr int kRedLd = kRows + 4;            // f32 stride of the sum tile
constexpr int kSmem = 232448;                // one block an SM
constexpr int kLoadBatch = 8;                // activation loads in flight
constexpr int kMaxDevices = 16;

// the shared memory of one launch, byte offsets from the 1024-aligned base
// (host-computed: they depend on the split, the group size and T)
struct Plan {
  int stages;    // ring stages of kStageBytes
  int xs;        // the rank's activations: T rows of xstride words
  int xstride;   // 1 (mod 8) words: a fragment load hits 32 banks
  int ss;        // weight scales (kRows, sstride) f32
  int sstride;
  int inbox;     // the other ranks' sums of the quads this rank owns
  int per;       // quads each rank owns (even: a gate quad and its up quad)
  int bars;      // full[stages], empty[stages]
};

// byte `off` (< kBox) of row r of tile `tile`'s box in a stage (128-byte
// swizzle: chunk c of a row lies at chunk c ^ (r % 8))
__device__ __forceinline__ uint32_t ring_addr(uint32_t stage, int tile, int r,
                                              int off) {
  return stage + tile * kBoxBytes + r * kBox +
         (((((off >> 4) & 7) ^ (r & 7)) << 4) | (off & 15));
}

// W bytes of shared memory at addr into d
template <int W>
__device__ __forceinline__ void ld_piece(uint32_t addr, uint32_t (&d)[W / 4]) {
  if constexpr (W == 16) {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(addr));
  } else if constexpr (W == 8) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(d[0]), "=r"(d[1]) : "r"(addr));
  } else {
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(d[0]) : "r"(addr));
  }
}

// One stage of K.  kGlu: rows [j0, j0 + 128) of W13's gate half and their
// up rows (O = H output rows, K = D), out = g (T, H) bf16.  kDown: rows
// [row0, row0 + 256) of W2 (O = D, K = H), out = y (T, D) f32.  a: the
// activations (T, K) bf16, x or g.  W: bytes a thread reads a row a
// segment.
template <int Q, int W, int S>
__global__ void __launch_bounds__(kThreads, 1)
ffn_xe_kernel(const __grid_constant__ CUtensorMap wmap,
              const __nv_bfloat16* a, const float* __restrict__ s, void* out,
              int T, int O, int K, int gs, int act, Plan p) {
  constexpr int kSegBytes = 4 * W;             // a quad's bytes of a row
  constexpr int kSegs = kBox / kSegBytes;      // segments a stage
  constexpr int kWords = W / 4;
  constexpr int kSteps = Q == kQ4 ? W / 2 : W / 4;   // k16 steps a segment
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
  const int range = blockIdx.x / nsplit;
  const int row0 = range * (S == kGlu ? kBoxRows : kRows);
  // the weight row at the top of box i, and the rows of the map
  auto first = [&](int i) {
    return S == kGlu ? row0 + i * O : row0 + i * kBoxRows;
  };
  const int wrows = S == kGlu ? 2 * O : O;
  // row r of the block's 256 (box r / 128) is an output row of the call
  auto live = [&](int r) {
    return (S == kGlu ? row0 + r % kBoxRows : row0 + r) < O;
  };
  const int gb = Q == kQ4 ? gs / 2 : gs;       // bytes of a group
  const int ng = K / gs;
  const int g0 = ng * rank / nsplit, g1 = ng * (rank + 1) / nsplit;
  const int c0 = g0 * gb;                      // the rank's first byte
  const bool gpow2 = (gb & (gb - 1)) == 0;
  const int gshift = __ffs(gb) - 1;
  const int nseg = (g1 - g0) * (gb / kSegBytes);
  const int nst = (nseg + kSegs - 1) / kSegs;
  const int D = p.stages;
  auto full = [&](int i) { return base + p.bars + 8 * i; };
  auto empty = [&](int i) { return base + p.bars + 8 * (D + i); };

  // ---- the loads of the prologue, in this order: the rows' scales and the
  // first activations (the GLU stage; the down stage reads g after
  // griddepcontrol.wait), then the first D weight stages.  A request queued
  // behind the whole card's weight stream takes several microseconds, and
  // the products wait on these.
  const bool producer = warp == kConsumerWarps && lane == 0;
  auto issue = [&](int i) {
    const int slot = i % D;
    sm90::mbar_expect_tx(full(slot), kStageBytes);
    const uint32_t st = base + slot * kStageBytes;
#pragma unroll
    for (int b = 0; b < kTiles; ++b)
      sm90::tma_load_2d(st + b * kBoxBytes, &wmap, full(slot), c0 + i * kBox,
                        first(b));
  };
  if (producer) {
    for (int i = 0; i < D; ++i) {
      sm90::mbar_init(full(i), 1);
      sm90::mbar_init(empty(i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the scales of the rank's groups (one cp.async group, 16 bytes a copy
  // where the rows allow: an aligned window [w_lo, w_hi)), two threads a
  // row; then the rank's columns of the activations, kLoadBatch 16-byte
  // loads a thread in flight at a time
  static_assert(kConsumers == 2 * kRows, "two threads a row of scales");
  const bool vec = (ng & 3) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  const int w_lo = vec ? (g0 & ~3) : g0;
  const int w_hi = vec ? ((g1 + 3) & ~3) : g1;
  const uint32_t xs = base + p.xs;      // the activations' rows
  if (warp < kConsumerWarps) {
    const int r = tid >> 1, step = vec ? 4 : 1;
    const int wr = first(r / kBoxRows) + r % kBoxRows;
    const float* srow = s + (size_t)min(wr, wrows - 1) * ng;
    for (int c = step * (tid & 1); c < w_hi - w_lo; c += 2 * step)
      gv::cp_async_scale(base + p.ss + 4 * (r * p.sstride + c),
                         srow + w_lo + c, vec, live(r));
    gv::cp_async_commit();
    const int chunks = (g1 - g0) * gs / 8;     // 16 bytes each, a row
    const int n = T * chunks;
    uint4 v[kLoadBatch];
    auto load = [&](int i0) {
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kConsumers;
        if (i < n) {
          const int t = i / chunks, c = i - t * chunks;
          const uint4* src = reinterpret_cast<const uint4*>(
              a + (size_t)t * K + (size_t)g0 * gs) + c;
          // g was written by the GLU stage: read it through L2 only
          v[u] = S == kGlu ? __ldg(src) : __ldcg(src);
        }
      }
    };
    // each aligned 4 values (e .. e+3) as the words (e, e+2), (e+1, e+3):
    // the B register of a step names 2 values 2 apart (see the k slots)
    auto store = [&](int i0) {
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kConsumers;
        if (i < n) {
          const int t = i / chunks, c = i - t * chunks;
          const uint32_t d = xs + 4 * (t * p.xstride + 4 * c);
          gv::sts64(d, __byte_perm(v[u].x, v[u].y, 0x5410),
                    __byte_perm(v[u].x, v[u].y, 0x7632));
          gv::sts64(d + 8, __byte_perm(v[u].z, v[u].w, 0x5410),
                    __byte_perm(v[u].z, v[u].w, 0x7632));
        }
      }
    };
    if (S == kGlu) load(tid);
    // the producer may issue the weights now
    asm volatile("bar.arrive 2, %0;\n" :: "n"(kThreads) : "memory");
    if (S == kDown) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      load(tid);
    }
    store(tid);
    for (int i0 = tid + kLoadBatch * kConsumers; i0 < n;
         i0 += kLoadBatch * kConsumers) {
      load(i0);
      store(i0);
    }
    gv::cp_async_wait<0>();
  } else {
    asm volatile("bar.sync 2, %0;\n" :: "n"(kThreads) : "memory");
    if (producer)
      for (int i = 0; i < D && i < nst; ++i) issue(i);
  }
  __syncthreads();   // the barriers, scales and activations are ready

  if (warp == kConsumerWarps) {
    if (producer) {
      for (int i = D; i < nst; ++i) {
        sm90::mbar_wait(empty(i % D), ((i / D) - 1) & 1);
        issue(i);
      }
      if (S == kGlu)   // every weight load of the block is issued
        asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    }
    __syncwarp();
    if (nsplit > 1) {      // the consumers' cluster barriers
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      sm90::cluster_sync();
    }
    return;
  }

  // ---- consumers: the products, a segment at a time in increasing k order
  // (half 0 the even segments of each stage, half 1 the odd ones)
  const int half = warp / kWarps;
  const int rw = warp % kWarps;                // the warp's rows of a box
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_x = g < T;                    // column g holds row g
  // fragment rows g and g + 8 are the slice's rows pg and pg + 8: the rows
  // of lanes g = 2q and 2q + 1 (a quarter warp's 16-byte loads) then differ
  // in bit 2 of their swizzle, so the quarter warp reads 8 different
  // 16-byte chunks, one wavefront for each
  const int pg = rw * 16 + (((g & 1) << 2) | (g >> 1));
  const uint32_t xrow = xs + 4 * g * p.xstride;
  const uint32_t ss = base + p.ss;
  float acc[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 1
  for (int i = 0; i < nst; ++i) {
    const int slot = i % D;
    const uint32_t stage = base + slot * kStageBytes;
    sm90::mbar_wait(full(slot), (i / D) & 1);
    if (S == kGlu && i == nst - 1)   // the block's last stage has landed
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int nsg = min(kSegs, nseg - i * kSegs);
#pragma unroll
    for (int j = 0; j < kSegs; ++j) {
      if (j % kHalves != half) continue;
      if (j >= nsg) break;
      const int seg = c0 + i * kBox + j * kSegBytes;   // its first byte
      const int grp = gpow2 ? seg >> gshift : seg / gb;   // its group
      // the rank's element of k slot 2t4 at step 0 (Q4: the low nibble of
      // the piece's first byte)
      const int e_piece = Q == kQ4
                              ? (grp - g0) * gs + (seg - grp * gb) + t4 * W
                              : seg - c0 + t4 * W;
      // the B words of slots 2t4 (x0) and 2t4+8 (x1) at step 0; step st
      // takes word st of each (8-byte loads: two steps a load)
      const uint32_t x0 = xrow + 2 * e_piece;
      const uint32_t x1 = x0 + 2 * (Q == kQ4 ? gb : W / 2);
      uint32_t d[kTiles][2][kWords];
#pragma unroll
      for (int tile = 0; tile < kTiles; ++tile)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ld_piece<W>(ring_addr(stage, tile, pg + 8 * h,
                                j * kSegBytes + t4 * W),
                      d[tile][h]);
      float part[kTiles][4];
#pragma unroll
      for (int tile = 0; tile < kTiles; ++tile)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[tile][c] = 0.f;
      uint2 b0 = make_uint2(0u, 0u), b1 = make_uint2(0u, 0u);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        // step st: bytes 4q + o and 4q + 2 + o of word q = st / 2, o = st %
        // 2 (Q4: their low nibbles at k slots 2t4, 2t4+1, their high ones at
        // 2t4+8, 2t4+9; Q8: at 2t4, 2t4+1 and, from word q of the piece's
        // second half, at 2t4+8, 2t4+9)
        const int q = st >> 1, o = st & 1;
        if (o == 0 && has_x) {
          b0 = gv::lds64(x0 + 4 * st);
          b1 = gv::lds64(x1 + 4 * st);
        }
        const uint2 b = o ? make_uint2(b0.y, b1.y) : make_uint2(b0.x, b1.x);
#pragma unroll
        for (int tile = 0; tile < kTiles; ++tile) {
          uint32_t a0, a1, a2, a3;
          if constexpr (Q == kQ4) {
            const uint32_t s0 = d[tile][0][q] >> (8 * o);
            const uint32_t s1 = d[tile][1][q] >> (8 * o);
            a0 = gv::dq4_even_lo(s0);
            a1 = gv::dq4_even_lo(s1);
            a2 = gv::dq4_even_hi(s0);
            a3 = gv::dq4_even_hi(s1);
          } else {
            a0 = gv::dq8_even(d[tile][0][q] >> (8 * o));
            a1 = gv::dq8_even(d[tile][1][q] >> (8 * o));
            a2 = gv::dq8_even(d[tile][0][W / 8 + q] >> (8 * o));
            a3 = gv::dq8_even(d[tile][1][W / 8 + q] >> (8 * o));
          }
          gv::mma16816(part[tile], a0, a1, a2, a3, b);
        }
      }
      // the segment's exact sum times its group's scale
      const int gi = grp - w_lo;
#pragma unroll
      for (int tile = 0; tile < kTiles; ++tile) {
        const int r = tile * kBoxRows + pg;
        const float sg = gv::lds_f32(ss + 4 * (r * p.sstride + gi));
        const float sg8 = gv::lds_f32(ss + 4 * ((r + 8) * p.sstride + gi));
        acc[tile][0] = fmaf(sg, part[tile][0], acc[tile][0]);
        acc[tile][1] = fmaf(sg, part[tile][1], acc[tile][1]);
        acc[tile][2] = fmaf(sg8, part[tile][2], acc[tile][2]);
        acc[tile][3] = fmaf(sg8, part[tile][3], acc[tile][3]);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(slot));
  }

  // acc[tile][2h + cc]: row pg + 8h of box `tile`, column 2t4 + cc.
  // The halves' sums [col][row] meet in the ring (every stage has been
  // read): half 0's + half 1's, in that order
  float* red = reinterpret_cast<float*>(smem);
  auto red_at = [&](int tile, int k) {
    return red + (2 * t4 + (k & 1)) * kRedLd + tile * kBoxRows + pg +
           8 * (k >> 1);
  };
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  if (half == 1) {
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (2 * t4 + (k & 1) < T) *red_at(tile, k) = acc[tile][k];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  if (half == 0) {
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (2 * t4 + (k & 1) < T) {
          acc[tile][k] += *red_at(tile, k);
          *red_at(tile, k) = acc[tile][k];
        }
  }

  if (nsplit == 1) {
    if (half == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 2 * t4 + cc, r = pg + 8 * h;
        if (c >= T) continue;
        if constexpr (S == kGlu) {
          if (row0 + r < O)
            static_cast<__nv_bfloat16*>(out)[(size_t)c * O + row0 + r] =
                sm90::glu(acc[0][2 * h + cc], acc[1][2 * h + cc], act);
        } else {
#pragma unroll
          for (int tile = 0; tile < kTiles; ++tile) {
            const int o = row0 + tile * kBoxRows + r;
            if (o < O)
              static_cast<float*>(out)[(size_t)c * O + o] =
                  acc[tile][2 * h + cc];
          }
        }
      }
    return;
  }

  // ---- split K: each quad of 4 rows of one column of the sum tile pushed
  // into the inbox of the rank that owns it (the GLU stage: a gate quad and
  // its up quad together); after the barrier the owner adds the ranks'
  // sums in rank order
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  float4* inbox = reinterpret_cast<float4*>(smem + p.inbox);
  constexpr int kQuads = kRows / 4;            // a column's quads
  const int total = T * kQuads;
  const int per = p.per;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < total; e += kConsumers) {
    const int n = e / kQuads, q = e % kQuads;
    const int r = S == kGlu ? (q & 1) * kBoxRows + 4 * (q >> 1) : 4 * q;
    const float4 v = *reinterpret_cast<const float4*>(red + n * kRedLd + r);
    const uint32_t owner = e / per;
    *reinterpret_cast<float4*>(
        gv::map_rank(inbox + rank * per + (e - owner * per), owner)) = v;
  }
  sm90::cluster_sync();
  auto sum = [&](int j) {
    float4 v = inbox[j];
    for (uint32_t c = 1; c < nsplit; ++c) {
      const float4 w = inbox[c * per + j];
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    return v;
  };
  const int mine = min(per, total - (int)rank * per);
  if constexpr (S == kGlu) {
    for (int j = 2 * tid; j < mine; j += 2 * kConsumers) {
      const int e = rank * per + j;
      const int n = e / kQuads, row = row0 + 4 * ((e % kQuads) >> 1);
      const float4 gt = sum(j), up = sum(j + 1);
      const __nv_bfloat16 v[4] = {sm90::glu(gt.x, up.x, act),
                                  sm90::glu(gt.y, up.y, act),
                                  sm90::glu(gt.z, up.z, act),
                                  sm90::glu(gt.w, up.w, act)};
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + (size_t)n * O;
      for (int k = 0; k < 4 && row + k < O; ++k) dst[row + k] = v[k];
    }
  } else {
    for (int j = tid; j < mine; j += kConsumers) {
      const int e = rank * per + j;
      const int n = e / kQuads, o = row0 + 4 * (e % kQuads);
      const float4 v = sum(j);
      float* dst = static_cast<float*>(out) + (size_t)n * O + o;
      if ((O & 3) == 0) {
        if (o < O) *reinterpret_cast<float4*>(dst) = v;
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
        for (int k = 0; k < 4 && o + k < O; ++k) dst[k] = w[k];
      }
    }
  }
}

// the shared memory of a launch (the ring takes what the activations of T
// rows and the scales leave); false if it gets fewer than two stages
bool plan(int T, int K, int gs, bool q4, int split, Plan& p) {
  auto up = [](int v, int a) { return (v + a - 1) / a * a; };
  const int ng = K / gs;
  const int gmax = (ng + split - 1) / split;   // the most groups a rank has
  const int nst_max = (gmax * (q4 ? gs / 2 : gs) + kBox - 1) / kBox;
  p.xstride = up(gmax * gs / 2, 32) + 2;
  int sstride = up(gmax + 6, 4);     // an aligned window around the groups
  if (sstride % 8 == 0) sstride += 4;   // 4 (mod 8): 8 rows, 8 bank groups
  p.sstride = sstride;
  p.per = 2 * ((T * (kRows / 8) + split - 1) / split);
  const int per_max = 2 * ((kMaxT * (kRows / 8) + split - 1) / split);
  int rest = up(4 * T * p.xstride, 16);
  p.ss = rest;
  rest = up(rest + 4 * kRows * sstride, 16);
  p.inbox = rest;
  rest = up(rest + (split > 1 ? 16 * split * per_max : 0), 8);
  const int fixed = 1024 + rest + 16 * kMaxStages;   // align slack, barriers
  int stages = (kSmem - fixed) / kStageBytes;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages > nst_max) stages = nst_max;
  if (stages < (nst_max < 2 ? nst_max : 2) || stages < 1) return false;
  const int ring = stages * kStageBytes;     // the sum tile lives there too
  if (ring < 4 * kMaxT * kRedLd) return false;
  p.stages = stages;
  p.xs = ring;
  p.ss += ring;
  p.inbox += ring;
  p.bars = ring + rest;
  return 1024 + p.bars + 16 * stages <= kSmem;
}

template <int Q, int W, int S>
int prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        ffn_xe_kernel<Q, W, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

// clusters of `split` blocks the card holds at once (a cluster lives in one
// GPC, so fewer fit than SMs / split); 0 if unknown
template <int Q, int W, int S>
int max_clusters(int dev, int split) {
  static int known[kMaxDevices][kMaxSplit + 1] = {};
  if (known[dev][split] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = split;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, ffn_xe_kernel<Q, W, S>, &cfg) !=
        cudaSuccess)
      n = 0;
    known[dev][split] = n > 0 ? n : -1;
  }
  return known[dev][split] > 0 ? known[dev][split] : 0;
}

// the K split of a stage from its row ranges and K only (never from T): of
// the sizes whose shared memory fits, the largest whose clusters the card
// holds for every row range at once, leaving out 5 and 7 (slower than a
// neighbour at every shape measured for kernel D); the smallest that fits
// where none does; 0 if none fits
template <int Q, int W, int S>
int split_of(int dev, int ranges, int K, int gs) {
  const int ng = K / gs;
  int split = 0;
  Plan p;
  for (int c = 1; c <= kMaxSplit && c <= ng; ++c) {
    if (!plan(kMaxT, K, gs, Q == kQ4, c, p)) continue;
    if (split == 0 || (c != 5 && c != 7 &&
                       ranges <= max_clusters<Q, W, S>(dev, c)))
      split = c;
  }
  return split;
}

// one stage: wq (wrows, K/2) or (wrows, K) weights, s their scales, a the
// activations (T, K) bf16, out (T, O); the down stage as a programmatic
// dependent launch
template <int Q, int W, int S>
int launch_stage(const uint8_t* wq, int wrows, const __nv_bfloat16* a,
                 const float* s, void* out, int T, int O, int K, int gs,
                 int act, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int ready = prepare<Q, W, S>();
  if (ready != 0) return ready;
  const int ranges = (O + (S == kGlu ? kBoxRows : kRows) - 1) /
                     (S == kGlu ? kBoxRows : kRows);
  const int split = split_of<Q, W, S>(dev, ranges, K, gs);
  Plan p;
  if (split < 1 || !plan(T, K, gs, Q == kQ4, split, p))
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  if (!sm90::make_map(&wmap, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wrows,
                      Q == kQ4 ? K / 2 : K, kBoxRows, kBox,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranges * split, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = S == kDown ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, ffn_xe_kernel<Q, W, S>, wmap, a, s, out, T, O,
                         K, gs, act, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int Q, int W>
int launch_xe_w(const Args& a, cudaStream_t stream) {
  const int err = launch_stage<Q, W, kGlu>(a.w13, 2 * a.H, a.x, a.s13, a.g,
                                           a.T, a.H, a.D, a.gs, a.act,
                                           stream);
  if (err != 0) return err;
  return launch_stage<Q, W, kDown>(a.w2, a.D, a.g, a.s2, a.y, a.T, a.D, a.H,
                                   a.gs, a.act, stream);
}

// W: 16 bytes a thread a row where a segment of 64 bytes lies in one group
// (Q4: gs % 128 == 0, Q8: gs % 64 == 0), else 8, else (Q4) 4
int launch_xe(const Args& a, int quant, cudaStream_t stream) {
  if (a.T < 1 || a.T > kMaxT || a.gs % 32 || a.D % a.gs || a.H % a.gs)
    return (int)cudaErrorInvalidValue;
  if (quant == kQ4) {
    if (a.gs % 128 == 0)
      return launch_xe_w<kQ4, 16>(a, stream);
    if (a.gs % 64 == 0)
      return launch_xe_w<kQ4, 8>(a, stream);
    return launch_xe_w<kQ4, 4>(a, stream);
  }
  if (quant == kQ8) {
    if (a.gs % 64 == 0)
      return launch_xe_w<kQ8, 16>(a, stream);
    return launch_xe_w<kQ8, 8>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
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
// f32; g (T, H) bf16 scratch; y (T, D) f32.  numerics 0: K (1 <= T <= 8),
// 1: L (9 <= T <= 16); both two launches.  act 0: silu, 1: tanh-GELU.
// Needs gs % 32 == 0 (L: gs in 32, 64, 128), D % gs == 0, H % gs == 0 and
// 16-byte aligned x, w13 and w2 (the Python wrapper checks).  Returns the
// first launch error or cudaGetLastError().
extern "C" int lmrs_ffn_fused(int numerics, int quant, const void* x,
                              const uint8_t* w13, const float* s13,
                              const uint8_t* w2, const float* s2, void* g,
                              float* y, int T, int D, int H, int gs, int act,
                              cudaStream_t stream) {
  const Args a{static_cast<const __nv_bfloat16*>(x), w13, s13, w2, s2,
               static_cast<__nv_bfloat16*>(g), y, T, D, H, gs, act};
  if (numerics == kXe) return launch_xe(a, quant, stream);
  if (numerics == kDeq && T >= 9 && T <= 16 && gs >= 32 && 128 % gs == 0) {
    if (quant == kQ4) return launch_deq<lmrs_sm90::Quant::Q4>(a, stream);
    if (quant == kQ8) return launch_deq<lmrs_sm90::Quant::Q8>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

