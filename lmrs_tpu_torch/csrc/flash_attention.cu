// Kernels C, G and H — flash attention over one layer of the KV cache (t_q
// <= 256 query tokens: decode steps, speculative verify windows and prefill
// chunks).  C reads a bf16 or an f32 cache, G an int8 cache with one f32
// scale per (kv head, row), H an int4 cache (two values per byte, the same
// scales); they are instantiations of one kernel template and share
// everything but the tile load and two multiplies.
//
// Kernel C.
// Computes ops.attention.attention(q, k[l, :n], v[l, :n], pos,
// precision="fast"): q rounded to bf16, K/V bf16, f32 scores * scale,
// tanh(s / cap) * cap, Gemma's sliding window (q_pos - t > window masked),
// causal mask (t > q_pos masked), online softmax in f32, p rounded to bf16
// for p.V with f32 accumulation, output f32 (T, H, hd).  Replaces
// lmrs_tpu/kernels/flash_attention.py:_flash_kernel (bf16 variant, via
// flash_decode_stacked).
//
// Bound on an H100: device-memory bytes at decode (every live K/V row is
// read once per layer, ~2 FLOP per byte); tensor-core operations for long
// prefill chunks.  Design: the cache is read in its merged (S, KH*hd)
// layout with the row stride passed in.  A block owns one KV head and 64
// query rows (row r = token r / G, head r % G of the G = H/KH query heads
// that share the KV head; 16 rows where G*T <= 16, see "Flash-decoding"),
// so every K/V tile read from memory serves all G query heads.  The block
// walks 64-row K/V tiles from the window start of its first query,
// max(pos + t_lo - window, 0), to its last live row, pos + t_hi: the
// window skip and the live clamp of the TPU kernel.  QK^T and PV run as
// WMMA bf16 16x16x16 products with f32 accumulators; scores, the bf16 p
// tile and the f32 output accumulator live in shared memory.  Each thread
// issues its K/V tile loads in batches of eight 16-byte loads into
// registers before storing any, so a block keeps many loads in flight.
// The QK^T and PV fragment jobs of the 16-row groups that hold real query
// rows are spread over all four warps, and the softmax gives every query
// row 8 threads: at decode (G*T = 2 real rows) every warp stays busy.
// Masked entries get p = 0 and take no part in the running max, so a tile
// in which a row has no live key adds exactly nothing to that row (the
// TPU kernel instead adds exp(MASK-MASK) = 1 and relies on a later rescale
// to cancel it).  K/V rows outside [window start, last live] are
// zero-filled in shared memory, so stale cache rows never reach p.V.
//
// Kernel G.  The cache holds int8 rows (S, KH*hd) and f32 scales (KH, S),
// one per (kv head, row): k = k_int * ks, v = v_int * vs.  Replaces
// _flash_kernel with quantized=True (_head_block_update): the key scale
// multiplies the score column, s = ((bf16(q) . k_int) * scale) * ks[j], and
// the value scale folds into the softmax weight before its bf16 rounding,
// o += bf16(p * vs[j]) . v_int, while the running sum takes p itself.  An
// int8 value is exact in bf16, so the tile is converted on its way into
// shared memory and both products run on the same WMMA path as C: no float
// K/V tile is ever written to device memory.  The scales are laid out with
// the sequence last, so a block, which owns one kv head, reads a contiguous
// run of them per tile.  Scales of rows outside [window start, last live]
// are never read (a stale scale may hold anything): they are set to 0 in
// shared memory beside the zero-filled rows.  Bound: bytes at decode, half
// of C's (1 byte per cached value plus 4/hd of scale).
//
// Kernel C, f32 cache.  The TPU kernel rounds an f32 K/V tile to bf16 on
// load (_head_block_update's load(): blk.astype(bfloat16)), so an f32 cache
// gives the bf16 cache's result bit for bit at twice the bytes.  Here too:
// four f32 values per 16-byte load are rounded to bf16 (RNE) on their way
// into shared memory, and everything after the tile load is C.
//
// Kernel H.  The cache holds nibble-packed rows (S, KH*hd/2) of int8 bytes
// v = 16*q_hi + q_lo + 8 with q_lo, q_hi in [-8, 7], and the (KH, S) f32
// scales of G.  Replaces _flash_kernel with packed4=True
// (_head_block_update's load(), both packings).  A byte unpacks on its way
// into shared memory as q_hi = v >> 4 (arithmetic shift of the signed
// byte: the TPU kernel's floor(v / 16)) and q_lo = (v & 15) - 8, both
// exact in bf16.  "half" packing (hd % 256 == 0, or an odd kv-head count):
// head kh owns hd/2 bytes of a row, the low nibbles are its channels
// [0, hd/2) and the high nibbles [hd/2, hd).  "pair" packing (every other
// geometry): heads 2p and 2p+1 share hd bytes, head 2p in the low nibbles
// and head 2p+1 in the high ones; a block owns one kv head, so the two
// blocks of a pair read the same bytes (later: one block per pair).  After
// the tile load everything is G: no float or int8 K/V tile is written to
// device memory.  Rows outside [window start, last live] are filled with
// the byte 8, which unpacks to (0, 0).  Bound: bytes at decode, a quarter
// of C's (half a byte per cached value plus 4/hd of scale).
//
// Kernels I and J — the same kernel over many sequences at once, the
// continuous-batching step (B slots, each at its own position).  Replace
// lmrs_tpu/kernels/flash_attention.py:_flash_kernel_batched, called
// through flash_decode_batched (I) and flash_decode_paged (J); its body is
// _head_block_update, the body of _flash_kernel, so for each slot I and J
// compute what C, G and H compute for one sequence, bit for bit when the
// walk is the same.  Only the row address differs, and it is passed at
// run time (struct Walk) rather than as a template axis, so the fifteen
// instantiations above serve all three kernels:
// - one sequence (C, G, H): row r of a layer at base + r*stride;
// - per slot (I): slot b's (S, stride) block at base + b*slot_stride, its
//   (KH, S) scale planes at scales + b*scale_slot_stride;
// - paged (J): a (B, maxp) page table maps the slot's virtual row r to
//   page table[b*maxp + r/psz], row r%psz of the layer's (P, psz, stride)
//   pool, and its scales to [page, kh, r%psz] of the (P, KH, psz) planes.
//   A 64-row tile may span several pages (psz is any multiple of 8), so
//   each tile's rows are translated once, by 64 threads, into shared
//   memory before the tile loads.
// The grid gains a slot axis (blockIdx.z); each block reads its slot's
// position from a device array (no host read), and walks from the slot's
// window start to its last live row as C does.  Rows outside that range,
// the pages of other slots, table entries past the slot's pages and
// window-freed pages (all 0, the trash page, which any lane may have
// written) are never read: they are zero-filled with zero scales in
// shared memory.  Bound: bytes, the sum over slots of C's (G's, H's).
//
// Flash-decoding (the split pass and kernel M).  Walked whole, a decode
// call had only KH blocks per sequence (8 for Gemma-2-9B and Llama-3.2-3B)
// on 132 SMs, each walking every live tile of its head in turn.  A call
// with one query block per kv head (G*T <= 64: decode steps and verify
// windows) now splits along the sequence: the grid gains a split axis, and
// split s of a block owns the cache rows [(f + s) * SPLIT, (f + s + 1) *
// SPLIT) of its live range, f the split of its first live row.  SPLIT is a
// fixed number of rows, a multiple of the 64-row tile (the wrappers'
// constant, measured on the card): the split boundaries fall on the same rows
// whatever the position, T or B, and the tiles never cross them.  A split
// walks its tiles with the arithmetic above unchanged and writes its raw
// online-softmax pieces, acc (f32, unnormalized), m and l, for its query
// rows to a workspace that the wrapper allocates; a split with no live row
// writes m = -inf and l = 0 and exits.  Kernel M (flash_merge_kernel)
// then merges each query row's splits in increasing split order: m_g =
// max m_s, w_s = exp(m_s - m_g), out = sum acc_s w_s / sum l_s w_s, a split
// at m_s = -inf skipped (so it adds exactly nothing).  The host makes one
// call for both launches (lmrs_flash_decode) over a workspace of one
// allocation: M called on its own from Python, with its own allocations
// and checks, about doubled the host's time per decode call (PERF.md).  A
// row therefore sees the same operations in the same order in any call
// that holds it: a row of a T = 5 call equals the row alone, and slot b of
// I or J equals C (G, H) on its rows, bit for bit.  One sequence (C, G, H) sizes its split
// axis from its host position; I and J size it from S (or, under a window,
// from window + T) and the splits past a slot's live range exit at once,
// so no position is read on the host.  Prefill chunks (several query
// blocks per kv head) fill the card already and are walked whole.  Where
// G*T <= 16 a block holds 16 query rows instead of 64: a quarter of the q,
// score, p and output tiles in shared memory, so two blocks share an SM at
// hd 256 (four at hd 128) and one block's loads overlap another's products;
// a row sees the same operations in either size of block.
//
// What bounds kernel M is not its bytes (a Gemma-2-9B row's splits at pos
// 6,000 are ~50 KB, read from L2) but its place as a second, dependent
// launch: its blocks start only after the split pass's last block ends,
// 3-8 us of device time a decode call for reads worth 0.2 us.  Folding the
// merge into the split pass (the last block of each group to finish, found
// by a ticket from an int32 counter, merging in split order) was measured
// on an H100 and cost more than it saved: one block a group then runs the
// merge's L2 round trips in series, where M's own grid spreads them over
// 64-128 blocks, and a decode call took 1.05-1.32x the device time of the
// two launches (PERF.md §6).  So M stays a launch of its own, behind the
// split pass in the same host call, and is a programmatic dependent launch
// (cudaLaunchAttributeProgrammaticStreamSerialization): the split pass's
// blocks execute griddepcontrol.launch_dependents once their tiles are
// walked, before their epilogue writes, so M's blocks are resident by the
// time the split pass ends; each executes griddepcontrol.wait (which
// returns once the split pass has completed and its writes are visible)
// before its first load of m, l or acc.  A decode call's span, from the
// split pass's start to M's end, is its measure (PERF.md §6).
//
// The cp partials (B1).  _flash_kernel_batched with lse=True and seq_base
// (the batched cp step's shard of the sequence) is the split pass with a
// row base: the operand's row 0 is the global row seq_base (struct Walk),
// every mask compares global positions, and kernel M merges the shard's
// splits without the division (raw), a row with no live key in the shard
// at m = -FLT_MAX (the JAX kernel's _MASK_NEG), acc = l = 0.  Shards then
// merge as splits do (lmrs_tpu/models/transformer.py:1033-1037).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per block (prefill)
constexpr int BQ_DECODE = 16;   // query rows per block where G*T <= 16
constexpr int BKV = 64;         // K/V rows per tile
constexpr int kWarps = 4;
constexpr int kRowThreads = 8;  // threads of one query row's softmax
constexpr int LDP = BKV + 8;    // bf16 stride of the p tile
constexpr int LDS = BKV + 4;    // f32 stride of the score tile

// how a cache row stores one kv head's values
enum class Cache { BF16, I8, F32, I4_HALF, I4_PAIR };

// caches of integers with one f32 scale per (kv head, row)
__host__ __device__ constexpr bool quantized(Cache c) {
  return c == Cache::I8 || c == Cache::I4_HALF || c == Cache::I4_PAIR;
}

// the shared memory of a block of QR query rows
template <int HD, bool Q, int QR>
struct Smem {
  static constexpr int LDH = HD + 8;   // bf16 stride of the q/k/v tiles
  static constexpr int LDO = HD + 4;   // f32 stride of the output tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * QR * LDH;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BKV * LDH;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BKV * LDH;
  static constexpr size_t p_off = s_off + sizeof(float) * QR * LDS;
  static constexpr size_t o_off = p_off + sizeof(__nv_bfloat16) * QR * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * QR * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * QR;
  // the tile's scales: quantized caches only
  static constexpr size_t ks_off = l_off + sizeof(float) * QR;
  static constexpr size_t vs_off = ks_off + sizeof(float) * BKV;
  static constexpr size_t bytes = Q ? vs_off + sizeof(float) * BKV : ks_off;
};

// One kv head's stripe of a cache row, in bytes and 16-byte chunks.  A
// pair-packed int4 stripe holds two heads (kh / 2 picks it), every other
// one head.
template <int HD, Cache C>
struct Stripe {
  // a value of the cache's type (a byte of an integer cache)
  using Elem = std::conditional_t<
      C == Cache::BF16, __nv_bfloat16,
      std::conditional_t<C == Cache::F32, float, int8_t>>;
  static constexpr int elem = sizeof(Elem);
  static constexpr int bytes = C == Cache::BF16   ? HD * 2
                               : C == Cache::F32  ? HD * 4
                               : C == Cache::I4_HALF ? HD / 2
                                                     : HD;   // I8, I4_PAIR
  static constexpr int chunks = bytes / 16;
  // the byte a row outside the live range is filled with: 8 unpacks to the
  // nibble values (0, 0), 0 is zero in every other type
  static constexpr unsigned fill =
      (C == Cache::I4_HALF || C == Cache::I4_PAIR) ? 0x08080808u : 0u;
};

// Where a block finds its sequence's rows (see the header note).  One
// sequence: pos = nullptr, table = nullptr, strides 0.
struct Walk {
  const int* pos;               // (B,) positions of each slot's query 0
  int pos0;                     // the position when pos is nullptr
  long long slot_stride;        // cache values between slots' blocks
  long long scale_slot_stride;  // f32 scales between slots' planes
  const int* table;             // (B, maxp) page table, or nullptr
  int maxp, psz;                // table columns, rows per page
  int seq_base;                 // the global row of the operand's row 0
};

// The split pass (see the header note).  rows = 0: no split, the block
// writes out = acc / l.  rows > 0: split s of a block owns the rows
// [(f + s) * rows, (f + s + 1) * rows), f the split of its first live row,
// and writes the raw (acc, m, l) of its query rows to the workspace: acc
// (B, n, T, H, HD), m and l (B, n, T, H) f32.
struct Split {
  int rows;                     // rows per split, a multiple of BKV; or 0
  int n;                        // splits per block (the grid's split axis)
  float* acc;
  float* m;
  float* l;
};

// 16 int8 values -> 16 bf16 values (exact) at dst, 16-byte aligned
__device__ __forceinline__ void store16_i8_as_bf16(__nv_bfloat16* dst,
                                                   uint4 v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  __align__(16) __nv_bfloat162 out[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int b0 = (int)(int8_t)(words[w] & 0xFFu);
    const int b1 = (int)(int8_t)((words[w] >> 8) & 0xFFu);
    const int b2 = (int)(int8_t)((words[w] >> 16) & 0xFFu);
    const int b3 = (int)(int8_t)(words[w] >> 24);
    out[2 * w] = __floats2bfloat162_rn((float)b0, (float)b1);
    out[2 * w + 1] = __floats2bfloat162_rn((float)b2, (float)b3);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = *reinterpret_cast<const uint4*>(&out[0]);
  d[1] = *reinterpret_cast<const uint4*>(&out[4]);
}

// the low (HIGH = false) or high nibble values of 16 biased bytes
// v = 16*q_hi + q_lo + 8 -> 16 bf16 values (exact) at dst, 16-byte aligned
template <bool HIGH>
__device__ __forceinline__ void store16_nibbles_as_bf16(__nv_bfloat16* dst,
                                                        uint4 v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  __align__(16) __nv_bfloat162 out[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the signed byte first: >> is arithmetic only on a signed type
      const int b = (int)(int8_t)((words[w] >> (8 * i)) & 0xFFu);
      f[i] = (float)(HIGH ? (b >> 4) : ((b & 15) - 8));
    }
    out[2 * w] = __floats2bfloat162_rn(f[0], f[1]);
    out[2 * w + 1] = __floats2bfloat162_rn(f[2], f[3]);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = *reinterpret_cast<const uint4*>(&out[0]);
  d[1] = *reinterpret_cast<const uint4*>(&out[4]);
}

// 16-byte chunk c of a head's stripe -> its bf16 values in the shared
// memory row `dst` (HD values).  `high`: the block's head is the odd one of
// its pair (I4_PAIR only).
template <int HD, Cache C>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, int c,
                                            uint4 v, bool high) {
  if constexpr (C == Cache::BF16) {
    *reinterpret_cast<uint4*>(dst + c * 8) = v;
  } else if constexpr (C == Cache::F32) {
    __align__(8) __nv_bfloat162 out[2] = {
        __floats2bfloat162_rn(__uint_as_float(v.x), __uint_as_float(v.y)),
        __floats2bfloat162_rn(__uint_as_float(v.z), __uint_as_float(v.w))};
    *reinterpret_cast<uint2*>(dst + c * 4) =
        *reinterpret_cast<const uint2*>(out);
  } else if constexpr (C == Cache::I8) {
    store16_i8_as_bf16(dst + c * 16, v);
  } else if constexpr (C == Cache::I4_HALF) {
    store16_nibbles_as_bf16<false>(dst + c * 16, v);
    store16_nibbles_as_bf16<true>(dst + HD / 2 + c * 16, v);
  } else {
    if (high)
      store16_nibbles_as_bf16<true>(dst + c * 16, v);
    else
      store16_nibbles_as_bf16<false>(dst + c * 16, v);
  }
}

// kc, vc: one layer of the cache, (S, row_stride) values of the cache's
// type (bf16, f32, int8, or the bytes of an int4 cache) — of slot 0 for a
// per-slot cache, the layer's (P, psz, row_stride) pool for a paged one;
// kscale, vscale: the layer's (KH, S) f32 scales of a quantized cache
// ((P, KH, psz) for a pool), else unused.  q and out are (B, T, H, HD);
// S is the rows a slot can hold (maxp * psz for a paged one).  A block
// holds QR query rows (BQ, or BQ_DECODE where G*T <= 16).
template <int HD, Cache C, int QR>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const float* __restrict__ q, const void* __restrict__ kc_raw,
             const void* __restrict__ vc_raw,
             const float* __restrict__ kscale,
             const float* __restrict__ vscale, float* __restrict__ out,
             int T, int H, int KH, int S, int row_stride, Walk w, Split sp,
             float scale, float softcap, int window) {
  constexpr bool Q = quantized(C);
  using L = Smem<HD, Q, QR>;
  using St = Stripe<HD, C>;
  constexpr int LDH = L::LDH, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* ms = reinterpret_cast<float*>(smem + L::m_off);
  float* ls = reinterpret_cast<float*>(smem + L::l_off);
  float* ksc = reinterpret_cast<float*>(smem + L::ks_off);   // Q only
  float* vsc = reinterpret_cast<float*>(smem + L::vs_off);   // Q only

  // paged: each tile row's physical row in the pool and the index of its
  // scale, translated once per tile
  __shared__ int tile_row[BKV];
  __shared__ int tile_srow[BKV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int kh = blockIdx.y;
  const int slot = blockIdx.z;
  // query 0's position counted in the operand's rows: every mask below
  // compares rows of the operand, global row = row + seq_base
  const int pos = (w.pos ? __ldg(w.pos + slot) : w.pos0) - w.seq_base;
  const bool paged = w.table != nullptr;
  q += (size_t)slot * T * H * HD;
  out += (size_t)slot * T * H * HD;
  kc_raw = static_cast<const char*>(kc_raw) +
           (size_t)slot * w.slot_stride * Stripe<HD, C>::elem;
  vc_raw = static_cast<const char*>(vc_raw) +
           (size_t)slot * w.slot_stride * Stripe<HD, C>::elem;
  if constexpr (quantized(C)) {
    kscale += (size_t)slot * w.scale_slot_stride;
    vscale += (size_t)slot * w.scale_slot_stride;
  }
  const int G = H / KH;
  const int n_rows = G * T;
  const int n_qblk = (n_rows + QR - 1) / QR;
  const int split = blockIdx.x / n_qblk;   // 0 without a split
  const int r_first = (blockIdx.x % n_qblk) * QR;
  const int r_last = min(r_first + QR, n_rows) - 1;

  const int t_lo = r_first / G, t_hi = r_last / G;
  int kv_lo = window >= 0 ? max(pos + t_lo - window, 0) : 0;
  int kv_hi = min(pos + t_hi, S - 1);   // last live row (inclusive)
  if (sp.rows > 0) {
    // this split's rows of [kv_lo, kv_hi]; its bounds are multiples of
    // BKV, so the tiles below never cross them
    const int s0 = (kv_lo / sp.rows + split) * sp.rows;
    kv_lo = max(kv_lo, s0);
    kv_hi = min(kv_hi, s0 + sp.rows - 1);
  }
  // (slot, split) offset of this block's rows in the workspace
  const size_t ws_row0 = ((size_t)slot * sp.n + split) * T * H;
  if (sp.rows > 0 && kv_lo > kv_hi) {
    // no live row in this split: m = -inf and l = 0 for every query row,
    // which the merge skips without reading acc
    for (int r = r_first + tid; r <= r_last; r += kWarps * 32) {
      const size_t i = ws_row0 + (size_t)(r / G) * H + kh * G + r % G;
      sp.m[i] = -INFINITY;
      sp.l[i] = 0.f;
    }
    return;
  }

  // q tile -> bf16; running max / sum / output accumulator
  for (int i = tid; i < QR * (HD / 4); i += kWarps * 32) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    const int R = r_first + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (R < n_rows) {
      const int t = R / G, h = kh * G + R % G;
      v = *reinterpret_cast<const float4*>(q + ((size_t)t * H + h) * HD + d);
    }
    __nv_bfloat16* dst = qs + r * LDH + d;
    dst[0] = __float2bfloat16_rn(v.x);
    dst[1] = __float2bfloat16_rn(v.y);
    dst[2] = __float2bfloat16_rn(v.z);
    dst[3] = __float2bfloat16_rn(v.w);
  }
  for (int i = tid; i < QR * LDO; i += kWarps * 32) os[i] = 0.f;
  for (int i = tid; i < QR; i += kWarps * 32) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }


  // 16-row groups of this block holding at least one real query row
  const int live_groups = (r_last - r_first) / 16 + 1;

  for (int kv0 = (kv_lo / BKV) * BKV; kv0 <= kv_hi; kv0 += BKV) {
    __syncthreads();   // previous tile's readers are done with ks/vs
    if (paged) {
      // virtual row -> (page, row in page); rows outside the live range
      // are never looked up (their table entries may be anything)
      if (tid < BKV) {
        const int row = kv0 + tid;
        int phys = 0, srow = 0;
        if (row >= kv_lo && row <= kv_hi) {
          const int vp = row / w.psz, off = row - vp * w.psz;
          const int pg = __ldg(w.table + (size_t)slot * w.maxp + vp);
          phys = pg * w.psz + off;
          srow = (pg * KH + kh) * w.psz + off;
        }
        tile_row[tid] = phys;
        tile_srow[tid] = srow;
      }
      __syncthreads();
    }
    // K/V tile: 16-byte chunks of each per thread, loaded into registers
    // before any is converted and stored, so that many loads are in flight
    // at once (one block per SM has little else to hide memory latency
    // with).  `d` counts a chunk's offset in its head's stripe in values
    // of the cache's type (bytes for the integer caches).
    constexpr int kPerChunk = 16 / St::elem;
    constexpr int kChunks = BKV * St::chunks;
    constexpr int kLoadsPerThread = kChunks / (kWarps * 32);
    static_assert(kChunks % (kWarps * 32) == 0,
                  "tile chunks must split evenly over the threads");
    const size_t head_off =
        (size_t)(C == Cache::I4_PAIR ? kh / 2 : kh) * (St::bytes / St::elem);
    const bool high = C == Cache::I4_PAIR && (kh & 1);
    if constexpr (Q) {
      // integer tile: all chunks of a thread at once (at most 8 of K and
      // of V); the tile's scales go to shared memory beside it
      const int8_t* kc = static_cast<const int8_t*>(kc_raw);
      const int8_t* vc = static_cast<const int8_t*>(vc_raw);
      uint4 kr[kLoadsPerThread], vr[kLoadsPerThread];
#pragma unroll
      for (int b = 0; b < kLoadsPerThread; ++b) {
        const int i = tid + b * kWarps * 32;
        const int r = i / St::chunks, d = (i % St::chunks) * kPerChunk;
        const int row = kv0 + r;
        kr[b] = vr[b] = make_uint4(St::fill, St::fill, St::fill, St::fill);
        if (row >= kv_lo && row <= kv_hi) {
          const size_t off = (size_t)(paged ? tile_row[r] : row) *
                                 row_stride + head_off + d;
          kr[b] = __ldg(reinterpret_cast<const uint4*>(kc + off));
          vr[b] = __ldg(reinterpret_cast<const uint4*>(vc + off));
        }
      }
      if (tid < BKV) {
        // scales of rows outside the live range are never read from the
        // cache (a stale one may hold anything)
        const int row = kv0 + tid;
        const bool in = row >= kv_lo && row <= kv_hi;
        const size_t si =
            paged ? (size_t)tile_srow[tid] : (size_t)kh * S + row;
        ksc[tid] = in ? __ldg(kscale + si) : 0.f;
        vsc[tid] = in ? __ldg(vscale + si) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kLoadsPerThread; ++b) {
        const int i = tid + b * kWarps * 32;
        const int r = i / St::chunks, c = i % St::chunks;
        store_chunk<HD, C>(ks + r * LDH, c, kr[b], high);
        store_chunk<HD, C>(vs + r * LDH, c, vr[b], high);
      }
    } else {
      // float tile: kBatch chunks at a time
      using Elem = typename St::Elem;
      const Elem* kc = static_cast<const Elem*>(kc_raw);
      const Elem* vc = static_cast<const Elem*>(vc_raw);
      constexpr int kBatch = kLoadsPerThread < 8 ? kLoadsPerThread : 8;
      static_assert(kLoadsPerThread % kBatch == 0,
                    "a thread's chunks must split evenly into batches");
#pragma unroll
      for (int b0 = 0; b0 < kLoadsPerThread; b0 += kBatch) {
        uint4 kr[kBatch], vr[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = tid + (b0 + b) * kWarps * 32;
          const int r = i / St::chunks, d = (i % St::chunks) * kPerChunk;
          const int row = kv0 + r;
          kr[b] = vr[b] = make_uint4(0u, 0u, 0u, 0u);
          if (row >= kv_lo && row <= kv_hi) {
            const size_t off = (size_t)(paged ? tile_row[r] : row) *
                                   row_stride + head_off + d;
            kr[b] = __ldg(reinterpret_cast<const uint4*>(kc + off));
            vr[b] = __ldg(reinterpret_cast<const uint4*>(vc + off));
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = tid + (b0 + b) * kWarps * 32;
          const int r = i / St::chunks, c = i % St::chunks;
          store_chunk<HD, C>(ks + r * LDH, c, kr[b], high);
          store_chunk<HD, C>(vs + r * LDH, c, vr[b], high);
        }
      }
    }
    __syncthreads();

    // scores: (16-row group, 16-key tile) fragment jobs of the live row
    // groups, spread over all warps — at decode (G*T = 2 rows) the one
    // live group's jobs still keep every warp busy
#pragma unroll 1
    for (int job = warp; job < live_groups * (BKV / 16); job += kWarps) {
      const int rg = job / (BKV / 16), j = job % (BKV / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + rg * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(b, ks + j * 16 * LDH + kk, LDH);
        wmma::mma_sync(sacc, a, b, sacc);
      }
      wmma::store_matrix_sync(ss + rg * 16 * LDS + j * 16, sacc, LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax update: every thread takes part whatever T is.
    // kRowThreads threads a query row (row g*16 + tid/8 of live group g),
    // each with the score columns part, part + 8, ..., one fixed shuffle
    // tree over the 8: every row sees the same operations in the same
    // order in any call, so a row of a T = 5 call is the row alone
    for (int g = 0; g < live_groups; ++g) {
      const int row = g * 16 + tid / kRowThreads;
      const int part = tid % kRowThreads;
      const int R = r_first + row;
      const bool row_ok = R < n_rows;
      const int q_pos = pos + (row_ok ? R / G : 0);
      float* srow = ss + row * LDS;
      float mx = -INFINITY;
#pragma unroll
      for (int col = part; col < BKV; col += kRowThreads) {
        const int key = kv0 + col;
        float sv = srow[col] * scale;
        if constexpr (Q) sv *= ksc[col];
        if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
        const bool live = row_ok && key <= q_pos && key >= kv_lo &&
                          (window < 0 || q_pos - key <= window);
        sv = live ? sv : -INFINITY;
        srow[col] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int o = 1; o < kRowThreads; o *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[row];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
      __nv_bfloat16* prow = ps + row * LDP;
#pragma unroll
      for (int col = part; col < BKV; col += kRowThreads) {
        const float sv = srow[col];
        const float p = (sv == -INFINITY) ? 0.f : expf(sv - m_new);
        sum += p;
        if constexpr (Q)   // in-range scales are finite, the others 0
          prow[col] = __float2bfloat16_rn(p * vsc[col]);
        else
          prow[col] = __float2bfloat16_rn(p);
      }
      // every lane of the row ends with the same sum (m_old is read by
      // all of them before these shuffles, written after them)
#pragma unroll
      for (int o = 1; o < kRowThreads; o *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (part == 0) {
        ms[row] = m_new;
        ls[row] = ls[row] * alpha + sum;
      }
      float* orow = os + row * LDO;
#pragma unroll 8
      for (int d = part; d < HD; d += kRowThreads) orow[d] *= alpha;
    }
    __syncthreads();

    // o += p . v: (16-row group, 16-column tile of hd) jobs over all warps
#pragma unroll 1
    for (int job = warp; job < live_groups * (HD / 16); job += kWarps) {
      const int rg = job / (HD / 16), j = job % (HD / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, os + rg * 16 * LDO + j * 16, LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + rg * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(b, vs + kk * LDH + j * 16, LDH);
        wmma::mma_sync(oacc, a, b, oacc);
      }
      wmma::store_matrix_sync(os + rg * 16 * LDO + j * 16, oacc, LDO,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  if (sp.rows > 0) {
    // the tiles are walked: kernel M's blocks may start (they wait for
    // this grid to complete before they read the workspace)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    // the split's raw pieces for the valid rows of this block
    for (int i = tid; i < QR * HD; i += kWarps * 32) {
      const int r = i / HD, d = i % HD;
      const int R = r_first + r;
      if (R >= n_rows) continue;
      const size_t row = ws_row0 + (size_t)(R / G) * H + kh * G + R % G;
      sp.acc[row * HD + d] = os[r * LDO + d];
      if (d == 0) {
        sp.m[row] = ms[r];
        sp.l[row] = ls[r];
      }
    }
    return;
  }
  // out = o / l for the valid rows of this block
  for (int i = tid; i < QR * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    const int R = r_first + r;
    if (R >= n_rows) continue;
    const int t = R / G, h = kh * G + R % G;
    out[((size_t)t * H + h) * HD + d] = os[r * LDO + d] / ls[r];
  }
}

// Kernel M: one query row (r = t*H + h = blockIdx.x, slot b =
// blockIdx.y) of the split pass's workspace merged over its n splits, 64
// of its hd values a block (blockIdx.z): m_g = max m_s, w_s = exp(m_s -
// m_g), out = sum acc_s w_s / sum l_s w_s, the sums taken in increasing
// split order.  A split with m_s = -inf holds no live key for the row: its
// weight is 0, its acc (which may hold anything) is never read, and it
// adds exactly nothing.  raw (out_m != nullptr): out = sum acc_s w_s,
// out_m = m_g, out_l = sum l_s w_s, and a row with no live key anywhere
// gets m = -FLT_MAX (the JAX kernel's _MASK_NEG), acc = l = 0.  The
// weights are found by all threads at once and kept in shared memory, so
// the sums' loads do not wait on m.
constexpr int kMergeThreads = 64;

__global__ void __launch_bounds__(kMergeThreads)
flash_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                   const float* __restrict__ l, float* __restrict__ out,
                   float* __restrict__ out_m, float* __restrict__ out_l,
                   int n, int rows, int hd) {
  extern __shared__ float wsplit[];   // n split weights
  __shared__ float warp_m[kMergeThreads / 32];
  __shared__ int warp_end[kMergeThreads / 32];
  const int r = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t first = (size_t)b * n * rows + r;   // split s at s * rows
  // a programmatic dependent launch: the split pass has completed and its
  // writes are visible once this returns
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // the largest m, and the end of the live splits
  float mg = -INFINITY;
  int end = 0;
  for (int s = tid; s < n; s += kMergeThreads) {
    const float ms = __ldg(m + first + (size_t)s * rows);
    if (ms != -INFINITY) {
      mg = fmaxf(mg, ms);
      end = s + 1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, o));
    end = max(end, __shfl_xor_sync(0xffffffffu, end, o));
  }
  if (tid % 32 == 0) {
    warp_m[tid / 32] = mg;
    warp_end[tid / 32] = end;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMergeThreads / 32; ++i) {
    mg = fmaxf(mg, warp_m[i]);
    end = max(end, warp_end[i]);
  }
  for (int s = tid; s < end; s += kMergeThreads) {
    const float ms = __ldg(m + first + (size_t)s * rows);
    wsplit[s] = ms == -INFINITY ? 0.f : expf(ms - mg);
  }
  __syncthreads();
  const int d = blockIdx.z * kMergeThreads + tid;
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < end; ++s) {
    const float ws = wsplit[s];
    const size_t i = first + (size_t)s * rows;
    // a zero weight adds exactly nothing: fmaf(0, 0, x) = x
    const float a = ws != 0.f && d < hd ? __ldg(acc + i * hd + d) : 0.f;
    const float ls = ws != 0.f ? __ldg(l + i) : 0.f;
    den = fmaf(ls, ws, den);
    num = fmaf(a, ws, num);
  }
  const size_t o = (size_t)b * rows + r;
  if (d < hd) out[o * hd + d] = out_m ? num : num / den;
  if (out_m && blockIdx.z == 0 && tid == 0) {
    out_m[o] = end ? mg : -FLT_MAX;
    out_l[o] = den;
  }
}

template <int HD, Cache C, int QR>
int launch_rows(const float* q, const void* k, const void* v,
                const float* ks, const float* vs, float* out, int B, int T,
                int H, int KH, int S, int row_stride, const Walk& w,
                const Split& sp, float scale, float softcap, int window,
                cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD, quantized(C), QR>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, C, QR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KH;
  const long long blocks_x =
      (long long)((G * T + QR - 1) / QR) * (sp.rows > 0 ? sp.n : 1);
  if (blocks_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_x, KH, B);
  flash_kernel<HD, C, QR><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, ks, vs, out, T, H, KH, S, row_stride, w, sp, scale, softcap,
      window);
  return (int)cudaGetLastError();
}

// a block of BQ_DECODE query rows where they hold all G*T: a quarter of
// the q, score, p and output tiles, so two blocks share an SM at hd 256
// (four at hd 128) and the loads of one overlap the other's products
template <int HD, Cache C>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, float* out, int B, int T, int H, int KH, int S,
           int row_stride, const Walk& w, const Split& sp, float scale,
           float softcap, int window, cudaStream_t stream) {
  if ((H / KH) * T <= BQ_DECODE)
    return launch_rows<HD, C, BQ_DECODE>(q, k, v, ks, vs, out, B, T, H, KH,
                                         S, row_stride, w, sp, scale,
                                         softcap, window, stream);
  return launch_rows<HD, C, BQ>(q, k, v, ks, vs, out, B, T, H, KH, S,
                                row_stride, w, sp, scale, softcap, window,
                                stream);
}

template <Cache C>
int dispatch(const float* q, const void* k, const void* v, const float* ks,
             const float* vs, float* out, int B, int T, int H, int KH,
             int hd, int S, int row_stride, const Walk& w,
             const Split& sp, float scale, float softcap, int window,
             cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64, C>(q, k, v, ks, vs, out, B, T, H, KH, S, row_stride,
                            w, sp, scale, softcap, window, stream);
    case 128:
      return launch<128, C>(q, k, v, ks, vs, out, B, T, H, KH, S,
                             row_stride, w, sp, scale, softcap, window, stream);
    case 256:
      return launch<256, C>(q, k, v, ks, vs, out, B, T, H, KH, S,
                             row_stride, w, sp, scale, softcap, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the cache types by number, as the batched entry point takes them
int dispatch_type(int cache, const float* q, const void* k, const void* v,
                  const float* ks, const float* vs, float* out, int B, int T,
                  int H, int KH, int hd, int S, int row_stride, const Walk& w,
                  const Split& sp, float scale, float softcap, int window,
                  cudaStream_t stream) {
  switch (cache) {
    case 0:
      return dispatch<Cache::BF16>(q, k, v, ks, vs, out, B, T, H, KH, hd, S,
                                   row_stride, w, sp, scale, softcap, window,
                                   stream);
    case 1:
      return dispatch<Cache::F32>(q, k, v, ks, vs, out, B, T, H, KH, hd, S,
                                  row_stride, w, sp, scale, softcap, window,
                                  stream);
    case 2:
      return dispatch<Cache::I8>(q, k, v, ks, vs, out, B, T, H, KH, hd, S,
                                 row_stride, w, sp, scale, softcap, window,
                                 stream);
    case 3:
      return dispatch<Cache::I4_HALF>(q, k, v, ks, vs, out, B, T, H, KH, hd,
                                      S, row_stride, w, sp, scale, softcap,
                                      window, stream);
    case 4:
      return dispatch<Cache::I4_PAIR>(q, k, v, ks, vs, out, B, T, H, KH, hd,
                                      S, row_stride, w, sp, scale, softcap,
                                      window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// one sequence at `pos`
Walk one(int pos) { return Walk{nullptr, pos, 0, 0, nullptr, 0, 0, 0}; }

// no split: each block walks its whole range and writes out = acc / l
constexpr Split kWhole{0, 1, nullptr, nullptr, nullptr};

}  // namespace

// Kernel C: q (T, H, hd) f32; k, v point at one layer of the cache, (S,
// row_stride) bf16 with head kh at columns [kh*hd, (kh+1)*hd) -> out (T, H,
// hd) f32.
// softcap <= 0 means none, window < 0 means none.  Needs hd in {64, 128,
// 256}, H % KH == 0, pos + T <= S, 16-byte aligned rows (the Python wrapper
// checks).  Returns a cudaError_t value.
extern "C" int lmrs_flash_attention(const float* q, const void* k,
                                    const void* v, float* out, int T, int H,
                                    int KH, int hd, int S, int row_stride,
                                    int pos, float scale, float softcap,
                                    int window, cudaStream_t stream) {
  return dispatch<Cache::BF16>(q, k, v, nullptr, nullptr, out, 1, T, H, KH,
                               hd, S, row_stride, one(pos), kWhole, scale,
                               softcap, window, stream);
}

// Kernel C on an f32 cache: as above with (S, row_stride) f32 rows, each
// value rounded to bf16 on load.
extern "C" int lmrs_flash_attention_f32(const float* q, const void* k,
                                        const void* v, float* out, int T,
                                        int H, int KH, int hd, int S,
                                        int row_stride, int pos, float scale,
                                        float softcap, int window,
                                        cudaStream_t stream) {
  return dispatch<Cache::F32>(q, k, v, nullptr, nullptr, out, 1, T, H, KH,
                              hd, S, row_stride, one(pos), kWhole, scale,
                              softcap, window, stream);
}

// Kernel G: as above with k, v pointing at one layer of an int8 cache,
// (S, row_stride) bytes, and ks, vs at the layer's (KH, S) f32 scales.
extern "C" int lmrs_flash_attention_i8(const float* q, const void* k,
                                       const void* v, const float* ks,
                                       const float* vs, float* out, int T,
                                       int H, int KH, int hd, int S,
                                       int row_stride, int pos, float scale,
                                       float softcap, int window,
                                       cudaStream_t stream) {
  return dispatch<Cache::I8>(q, k, v, ks, vs, out, 1, T, H, KH, hd, S,
                             row_stride, one(pos), kWhole, scale, softcap,
                             window, stream);
}

// Kernel H: k, v point at one layer of an int4 cache, (S, row_stride) bytes
// with row_stride = KH*hd/2, and ks, vs at the layer's (KH, S) f32 scales.
// pair != 0: head-pair packing (KH even), else half packing.
extern "C" int lmrs_flash_attention_i4(const float* q, const void* k,
                                       const void* v, const float* ks,
                                       const float* vs, float* out, int T,
                                       int H, int KH, int hd, int S,
                                       int row_stride, int pos, float scale,
                                       float softcap, int window, int pair,
                                       cudaStream_t stream) {
  if (pair)
    return dispatch<Cache::I4_PAIR>(q, k, v, ks, vs, out, 1, T, H, KH, hd,
                                    S, row_stride, one(pos), kWhole, scale,
                                    softcap, window, stream);
  return dispatch<Cache::I4_HALF>(q, k, v, ks, vs, out, 1, T, H, KH, hd, S,
                                  row_stride, one(pos), kWhole, scale,
                                  softcap, window, stream);
}

// Kernels I and J: B sequences at once.  q (B, T, H, hd) f32 -> out (B, T,
// H, hd) f32; pos (B,) int32 on the device, the position of each slot's
// query 0.  cache: 0 bf16, 1 f32, 2 int8, 3 int4 half, 4 int4 pair
// packing; ks, vs are unused for 0 and 1.
// I (table == nullptr): k, v point at slot 0's layer of a (B, L, S,
// row_stride) cache, slot b's block slot_stride values further; ks, vs at
// slot 0's layer of the (B, L, KH, S) scales, scale_slot_stride apart.
// J (table != nullptr): k, v point at the layer's (P, psz, row_stride)
// pool, ks, vs at its (P, KH, psz) scales; table is (B, maxp) int32 and
// S = maxp * psz.  The wrappers check shapes and types.
extern "C" int lmrs_flash_attention_batched(
    const float* q, const void* k, const void* v, const float* ks,
    const float* vs, float* out, int B, int T, int H, int KH, int hd, int S,
    int row_stride, const int* pos, long long slot_stride,
    long long scale_slot_stride, const int* table, int maxp, int psz,
    float scale, float softcap, int window, int cache, cudaStream_t stream) {
  if (B < 1 || B > 65535 || (table && (psz < 8 || maxp * psz != S)))
    return (int)cudaErrorInvalidValue;
  const Walk w{pos, 0, slot_stride, scale_slot_stride, table, maxp, psz, 0};
  return dispatch_type(cache, q, k, v, ks, vs, out, B, T, H, KH, hd, S,
                       row_stride, w, kWhole, scale, softcap, window, stream);
}

// The split pass of C, G, H, I and J, and the cp partials (B1): the
// batched entry's arguments (pos may be nullptr for one sequence at pos0,
// B = 1), the operand's row base seq_base (its row 0 is the global row
// seq_base; masks compare global positions), `split` rows per split (a
// positive multiple of 64) and n_split splits per block, counted from the
// split of the block's first live row.  Writes acc (B, n_split, T, H, hd),
// m and l (B, n_split, T, H) f32: the raw online-softmax pieces of each
// split (m = -inf, l = 0 and acc unwritten where a split holds no live
// key for a row).
extern "C" int lmrs_flash_partials(
    const float* q, const void* k, const void* v, const float* ks,
    const float* vs, float* acc, float* m, float* l, int B, int T, int H,
    int KH, int hd, int S, int row_stride, const int* pos, int pos0,
    int seq_base, long long slot_stride, long long scale_slot_stride,
    const int* table, int maxp, int psz, int split, int n_split, float scale,
    float softcap, int window, int cache, cudaStream_t stream) {
  if (B < 1 || B > 65535 || (table && (psz < 8 || maxp * psz != S)) ||
      split <= 0 || split % BKV || n_split < 1)
    return (int)cudaErrorInvalidValue;
  const Walk w{pos, pos0, slot_stride, scale_slot_stride, table, maxp, psz,
               seq_base};
  const Split sp{split, n_split, acc, m, l};
  return dispatch_type(cache, q, k, v, ks, vs, nullptr, B, T, H, KH, hd, S,
                       row_stride, w, sp, scale, softcap, window, stream);
}

// Kernel M: the workspace of lmrs_flash_partials, acc (B, n, rows, hd) and
// m, l (B, n, rows) with rows = T*H, merged over its n splits -> out (B,
// rows, hd) = sum acc w / sum l w; raw (out_m != nullptr): out = sum acc
// w, out_m and out_l (B, rows) = m_g and sum l w.  hd <= 256, n <= 12,288.
extern "C" int lmrs_flash_merge(const float* acc, const float* m,
                                const float* l, float* out, float* out_m,
                                float* out_l, int B, int n, int rows, int hd,
                                cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)n;
  if (B < 1 || B > 65535 || n < 1 || rows < 1 || hd < 1 || hd > 256 ||
      smem > 48 * 1024 || (out_m == nullptr) != (out_l == nullptr))
    return (int)cudaErrorInvalidValue;
  // a programmatic dependent launch: M's blocks start once every block of
  // the split pass before it has walked its tiles, and wait in the kernel
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows, B, (hd + kMergeThreads - 1) / kMergeThreads);
  cfg.blockDim = dim3(kMergeThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_merge_kernel, acc, m,
                                           l, out, out_m, out_l, n, rows, hd);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// A decode call of C, G, H, I or J: lmrs_flash_partials into the workspace
// ws of B * n_split * T * H * (hd + 2) floats (acc, then m, then l), then
// kernel M into out (B, T, H, hd): two launches, one call from the host.
extern "C" int lmrs_flash_decode(
    const float* q, const void* k, const void* v, const float* ks,
    const float* vs, float* ws, float* out, int B, int T, int H, int KH,
    int hd, int S, int row_stride, const int* pos, int pos0, int seq_base,
    long long slot_stride, long long scale_slot_stride, const int* table,
    int maxp, int psz, int split, int n_split, float scale, float softcap,
    int window, int cache, cudaStream_t stream) {
  const size_t rows = (size_t)B * n_split * T * H;
  float* acc = ws;
  float* m = ws + rows * hd;
  float* l = m + rows;
  const int err = lmrs_flash_partials(
      q, k, v, ks, vs, acc, m, l, B, T, H, KH, hd, S, row_stride, pos, pos0,
      seq_base, slot_stride, scale_slot_stride, table, maxp, psz, split,
      n_split, scale, softcap, window, cache, stream);
  if (err != 0) return err;
  return lmrs_flash_merge(acc, m, l, out, nullptr, nullptr, B, n_split,
                          T * H, hd, stream);
}
