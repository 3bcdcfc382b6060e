// Kernels C and G — flash attention over one layer of the KV cache (t_q <=
// 256 query tokens: decode steps and prefill chunks).  C reads a bf16 cache,
// G an int8 cache with one f32 scale per (kv head, row); they are the two
// instantiations of one kernel template and share everything but the tile
// load and two multiplies.
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
// that share the KV head), so every K/V tile read from memory serves all G
// query heads.  The block walks 64-row K/V tiles from the window start of
// its first query, max(pos + t_lo - window, 0), to its last live row,
// pos + t_hi: the window skip and the live clamp of the TPU kernel.  QK^T
// and PV run as WMMA bf16 16x16x16 products with f32 accumulators; scores,
// the bf16 p tile and the f32 output accumulator live in shared memory.
// Each thread issues its K/V tile loads in batches of eight 16-byte loads
// into registers before storing any, so a block keeps many loads in flight.
// The QK^T and PV fragment jobs of the 16-row groups that hold real query
// rows are spread over all four warps: at decode (G*T = 2 of the 64 rows
// are real) the block's one live group still keeps every warp busy.
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
// Later: at T = 1 there are only KH blocks (8 for Gemma-2-9B and
// Llama-3.2-3B) on 132 SMs; a split along the sequence (flash-decoding)
// with a merge pass fills the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // K/V rows per tile
constexpr int kWarps = 4;       // each warp owns 16 query rows
constexpr int LDP = BKV + 8;    // bf16 stride of the p tile
constexpr int LDS = BKV + 4;    // f32 stride of the score tile

template <int HD, bool I8>
struct Smem {
  static constexpr int LDH = HD + 8;   // bf16 stride of the q/k/v tiles
  static constexpr int LDO = HD + 4;   // f32 stride of the output tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BKV * LDH;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BKV * LDH;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t ks_off = l_off + sizeof(float) * BQ;   // I8 only
  static constexpr size_t vs_off = ks_off + sizeof(float) * BKV;  // I8 only
  static constexpr size_t bytes = I8 ? vs_off + sizeof(float) * BKV : ks_off;
};

// 16 int8 values -> 16 bf16 values (exact) at dst, 32-byte aligned
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

// kc, vc: one layer of the cache, (S, row_stride) bf16 (C) or int8 (G);
// kscale, vscale: the layer's (KH, S) f32 scales (G), unused for C.
template <int HD, bool I8>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const float* __restrict__ q, const void* __restrict__ kc_raw,
             const void* __restrict__ vc_raw,
             const float* __restrict__ kscale,
             const float* __restrict__ vscale, float* __restrict__ out,
             int T, int H, int KH, int S, int row_stride, int pos,
             float scale, float softcap, int window) {
  using L = Smem<HD, I8>;
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
  float* ksc = reinterpret_cast<float*>(smem + L::ks_off);   // I8 only
  float* vsc = reinterpret_cast<float*>(smem + L::vs_off);   // I8 only

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int n_rows = G * T;
  const int r_first = blockIdx.x * BQ;
  const int r_last = min(r_first + BQ, n_rows) - 1;

  // q tile -> bf16; running max / sum / output accumulator
  for (int i = tid; i < BQ * (HD / 4); i += kWarps * 32) {
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
  for (int i = tid; i < BQ * LDO; i += kWarps * 32) os[i] = 0.f;
  for (int i = tid; i < BQ; i += kWarps * 32) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }

  const int t_lo = r_first / G, t_hi = r_last / G;
  const int kv_lo = window >= 0 ? max(pos + t_lo - window, 0) : 0;
  const int kv_hi = min(pos + t_hi, S - 1);   // last live row (inclusive)

  // 16-row groups of this block holding at least one real query row
  const int live_groups = (r_last - r_first) / 16 + 1;
  // softmax ownership: two lanes per query row, 32 score columns each
  const int my_row = warp * 16 + (lane >> 1);
  const int my_col0 = (lane & 1) * (BKV / 2);
  const int my_R = r_first + my_row;
  const bool row_ok = my_R < n_rows;
  const int q_pos = pos + (row_ok ? my_R / G : 0);

  for (int kv0 = (kv_lo / BKV) * BKV; kv0 <= kv_hi; kv0 += BKV) {
    __syncthreads();   // previous tile's readers are done with ks/vs
    if constexpr (I8) {
      // int8 K/V tile: HD / 32 16-byte chunks (16 values) of each per
      // thread, all issued before any is converted and stored; the tile's
      // scales go to shared memory beside it
      const int8_t* kc = static_cast<const int8_t*>(kc_raw);
      const int8_t* vc = static_cast<const int8_t*>(vc_raw);
      constexpr int kChunks = BKV * (HD / 16);
      constexpr int kLoadsPerThread = kChunks / (kWarps * 32);
      static_assert(kChunks % (kWarps * 32) == 0,
                    "tile chunks must split evenly over the threads");
      uint4 kr[kLoadsPerThread], vr[kLoadsPerThread];
#pragma unroll
      for (int b = 0; b < kLoadsPerThread; ++b) {
        const int i = tid + b * kWarps * 32;
        const int r = i / (HD / 16), d = (i % (HD / 16)) * 16;
        const int row = kv0 + r;
        kr[b] = vr[b] = make_uint4(0u, 0u, 0u, 0u);
        if (row >= kv_lo && row <= kv_hi) {
          const size_t off = (size_t)row * row_stride + (size_t)kh * HD + d;
          kr[b] = __ldg(reinterpret_cast<const uint4*>(kc + off));
          vr[b] = __ldg(reinterpret_cast<const uint4*>(vc + off));
        }
      }
      if (tid < BKV) {
        const int row = kv0 + tid;
        const bool in = row >= kv_lo && row <= kv_hi;
        ksc[tid] = in ? __ldg(kscale + (size_t)kh * S + row) : 0.f;
        vsc[tid] = in ? __ldg(vscale + (size_t)kh * S + row) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kLoadsPerThread; ++b) {
        const int i = tid + b * kWarps * 32;
        const int r = i / (HD / 16), d = (i % (HD / 16)) * 16;
        store16_i8_as_bf16(ks + r * LDH + d, kr[b]);
        store16_i8_as_bf16(vs + r * LDH + d, vr[b]);
      }
    } else {
      const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(kc_raw);
      const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(vc_raw);
      // K/V tile: kLoadsPerThread 16-byte chunks of each per thread, issued
      // kBatch at a time into registers before any is stored, so that many
      // loads are in flight at once (one block per SM has little else to
      // hide memory latency with)
      constexpr int kChunks = BKV * (HD / 8);
      constexpr int kLoadsPerThread = kChunks / (kWarps * 32);
      constexpr int kBatch = kLoadsPerThread < 8 ? kLoadsPerThread : 8;
      static_assert(kChunks % (kWarps * 32) == 0 &&
                        kLoadsPerThread % kBatch == 0,
                    "tile chunks must split evenly over the threads");
#pragma unroll
      for (int b0 = 0; b0 < kLoadsPerThread; b0 += kBatch) {
        uint4 kr[kBatch], vr[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = tid + (b0 + b) * kWarps * 32;
          const int r = i / (HD / 8), d = (i % (HD / 8)) * 8;
          const int row = kv0 + r;
          kr[b] = vr[b] = make_uint4(0u, 0u, 0u, 0u);
          if (row >= kv_lo && row <= kv_hi) {
            const size_t off = (size_t)row * row_stride + (size_t)kh * HD + d;
            kr[b] = __ldg(reinterpret_cast<const uint4*>(kc + off));
            vr[b] = __ldg(reinterpret_cast<const uint4*>(vc + off));
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = tid + (b0 + b) * kWarps * 32;
          const int r = i / (HD / 8), d = (i % (HD / 8)) * 8;
          *reinterpret_cast<uint4*>(ks + r * LDH + d) = kr[b];
          *reinterpret_cast<uint4*>(vs + r * LDH + d) = vr[b];
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

    // online softmax update of my half row (warp w owns rows 16w..16w+15)
    if (warp < live_groups) {
      float* srow = ss + my_row * LDS + my_col0;
      float mx = -INFINITY;
#pragma unroll 8
      for (int c = 0; c < BKV / 2; ++c) {
        const int key = kv0 + my_col0 + c;
        float sv = srow[c] * scale;
        if constexpr (I8) sv *= ksc[my_col0 + c];
        if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
        const bool live = row_ok && key <= q_pos && key >= kv_lo &&
                          (window < 0 || q_pos - key <= window);
        sv = live ? sv : -INFINITY;
        srow[c] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_old = ms[my_row];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_old, mx);
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
      __nv_bfloat16* prow = ps + my_row * LDP + my_col0;
#pragma unroll 8
      for (int c = 0; c < BKV / 2; ++c) {
        const float sv = srow[c];
        const float p = (sv == -INFINITY) ? 0.f : expf(sv - m_new);
        sum += p;
        if constexpr (I8)   // in-range scales are finite, the others 0
          prow[c] = __float2bfloat16_rn(p * vsc[my_col0 + c]);
        else
          prow[c] = __float2bfloat16_rn(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((lane & 1) == 0) {
        ms[my_row] = m_new;
        ls[my_row] = ls[my_row] * alpha + sum;
      }
      float* orow = os + my_row * LDO + (lane & 1) * (HD / 2);
#pragma unroll 8
      for (int d = 0; d < HD / 2; ++d) orow[d] *= alpha;
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

  // out = o / l for the valid rows of this block
  for (int i = tid; i < BQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    const int R = r_first + r;
    if (R >= n_rows) continue;
    const int t = R / G, h = kh * G + R % G;
    out[((size_t)t * H + h) * HD + d] = os[r * LDO + d] / ls[r];
  }
}

template <int HD, bool I8>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, float* out, int T, int H, int KH, int S,
           int row_stride, int pos, float scale, float softcap, int window,
           cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD, I8>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KH;
  const dim3 grid((G * T + BQ - 1) / BQ, KH);
  flash_kernel<HD, I8><<<grid, kWarps * 32, bytes, stream>>>(
      q, k, v, ks, vs, out, T, H, KH, S, row_stride, pos, scale, softcap,
      window);
  return (int)cudaGetLastError();
}

template <bool I8>
int dispatch(const float* q, const void* k, const void* v, const float* ks,
             const float* vs, float* out, int T, int H, int KH, int hd, int S,
             int row_stride, int pos, float scale, float softcap, int window,
             cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64, I8>(q, k, v, ks, vs, out, T, H, KH, S, row_stride,
                            pos, scale, softcap, window, stream);
    case 128:
      return launch<128, I8>(q, k, v, ks, vs, out, T, H, KH, S, row_stride,
                             pos, scale, softcap, window, stream);
    case 256:
      return launch<256, I8>(q, k, v, ks, vs, out, T, H, KH, S, row_stride,
                             pos, scale, softcap, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (T, H, hd) f32; k, v point at one layer of the cache, (S, row_stride)
// bf16 with head kh at columns [kh*hd, (kh+1)*hd) -> out (T, H, hd) f32.
// softcap <= 0 means none, window < 0 means none.  Needs hd in {64, 128,
// 256}, H % KH == 0, pos + T <= S, 16-byte aligned rows (the Python wrapper
// checks).  Returns a cudaError_t value.
extern "C" int lmrs_flash_attention(const float* q, const void* k,
                                    const void* v, float* out, int T, int H,
                                    int KH, int hd, int S, int row_stride,
                                    int pos, float scale, float softcap,
                                    int window, cudaStream_t stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, out, T, H, KH, hd, S,
                         row_stride, pos, scale, softcap, window, stream);
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
  return dispatch<true>(q, k, v, ks, vs, out, T, H, KH, hd, S, row_stride,
                        pos, scale, softcap, window, stream);
}
