// Paged attention for Hopper (sm_90a): decode and chunk prefill over a
// block-table page pool.
//
// Replaces the two Pallas TPU kernels of
// distributed_inference_demo_tpu/ops/paged_attention.py:
//
// - decode replaces _paged_kernel (via _paged_call): paged_decode_kernel
//   for f32 q, paged_decode_split_kernel + paged_decode_merge_kernel for
//   bf16 q.  One query token per row.  For kv head h of row b, the g query heads
//   h*g .. h*g+g-1 attend to every key position s < kv_len[b] (which is
//   the causal bound: the query sits at kv_len - 1), with an optional
//   ALiBi bias -slope * (kv_len - 1 - s);
// - prefill replaces _paged_prefill_kernel (via _paged_prefill_call):
//   paged_prefill_kernel for f32 q, paged_prefill_mma_kernel for bf16 q.
//   A contiguous chunk of queries per row.  Row r
//   of the regrouped [chunk*g] rows of kv head h is position
//   starts[b] + r/g of q head h*g + r%g and attends to every s <= its own
//   position (the chunk's own K/V is already in the pages), with ALiBi
//   -slope * (q_pos - s).
//
// Both read K/V through the block table: position s of row b lives in
// page tables[b][s / bt] at offset s % bt of the pool [num_pages, nkv,
// bt, hd].  Table entries past the pool (sentinels) are clamped into it,
// as the reference's index maps clamp them: such pages are only ever
// read for masked positions of freed slots, whose output is discarded.
// Positions past the table (s >= W*bt) are never visited.  The softmax
// is the reference's: f32, scale 1/sqrt(hd) on q, masked scores -1e30,
// masked probabilities exactly 0, final division by max(l, 1e-30).
//
// What bounds them on the H100.  Decode does 4*nh*hd operations per
// live key over 2*nkv*hd page elements per key: about g operations per
// byte, far below the card's ~295 bf16 operations per byte, so decode is
// bound by the bytes of the live pages, and at the serving shapes (8
// rows, ~3000 live keys, 1.5 MB of bf16 pages) that bound is ~1 us: what
// is left is latency, so the design is about putting every SM to work at
// once and overlapping the page copies with the math.  Prefill chunks of
// 16-64 tokens over short prefixes are bound by bytes too (~30 operations
// per byte at a 64-token chunk after 200 tokens); long prefixes turn
// them toward operations, where the tensor cores' rate matters.
//
// Design of the bf16-q instances (bf16 or int8 pages).
//
// - Decode: split-KV (flash-decoding).  The grid is (splits, nkv, b) with
//   splits = ceil(W*bt / KV_SPLIT), known from the table's shape, so the
//   host reads no kv_lens.  Split s of row b covers positions
//   [s*KV_SPLIT, (s+1)*KV_SPLIT) clipped to the row's kv_end; a split past
//   kv_end exits at once.  At the 8-slot serving shape about 116 blocks
//   have work where one block per (row, kv head) gave 32.  Split
//   boundaries sit at fixed positions and each warp owns fixed 16-key
//   slices of every 64-key tile, so a row's output depends only on its own
//   kv_len and pages, never on b or the other rows: the batch
//   invariance that greedy identity across batch compositions needs.
//   The g <= 16 q heads of the kv head are the rows of one m16n8k16 A
//   tile (zero-padded to 16), read once from q into registers.  Each warp
//   keeps its own running (m, l, acc); the four merge in shared memory at
//   the end of the block, which writes its unnormalised partial (acc, m,
//   l) in f32 to scratch the wrapper allocates.  A second small kernel on
//   the same stream merges each row's live splits in split order and
//   writes out in q's dtype (0 for a row with kv_end = 0).
// - Prefill: a tensor-core flash tile over the table.  A block of four
//   warps owns PREFILL_ROWS of the chunk*g regrouped rows of one (kv head,
//   row), 16 per row-warp: at 64 rows each warp walks every key of every
//   tile; at 32 or 16 rows the 2 or 4 warps of a row group split each
//   tile's keys and merge in shared memory at the end, which shortens
//   each warp's serial chain and puts 2 or 4 times as many blocks on the
//   card.  Q is read once, in the projection layout, into registers as A
//   fragments, and the output is written back in that layout (no regroup
//   transpose in the wrapper).  Tiles past the block's causal frontier
//   are never loaded, tiles past a row group's are not computed, and the
//   diagonal tile is masked per row.
// - Both: K/V arrive in 64-key tiles through the table by cp.async
//   16-byte copies (8 bf16 values or 16 int8 codes, plus each token's f32
//   scale) into a ring in shared memory (decode: a whole split of up to 4
//   tiles; prefill: 4 stages, 3 for bf16 pages at hd 256), so later
//   tiles' copies overlap tile t's math.  Each key row's page is looked
//   up once; keys past the bound are zero-filled.  S = Q K^T and O += P V are
//   mma.sync.m16n8k16 with bf16 operands (bf16 pages' fragments come by
//   ldmatrix) and f32 accumulation; the scale 1/sqrt(hd), ALiBi, the
//   masks and the online softmax run in f32 on the accumulator layout, in
//   the log2 domain (exp2f of scores scaled by log2 e); P is rounded to
//   bf16 in registers as P V's A fragment (the TPU kernel's f32 dots at
//   default precision also run in bf16 passes on the MXU).
// - int8 pages, bf16 q: a code is exact in bf16, and a token's scale is
//   one factor for its whole K or V row, so the dequantize code * scale
//   is applied in f32 where it is one multiply per key instead of one per
//   element: the K scale to the key's score column after Q K^T (the
//   products of bf16 q and exact codes sum in f32), the V scale to the
//   key's probability before it is rounded to bf16 for P V.  That is one
//   bf16 rounding fewer per operand than rounding code * scale to bf16,
//   and fewer instructions while the fragments are built.
//
// - Head dims: an instance for each head dim of the catalog's models (64,
//   80, 96, 128, 256).  At 256 a warp's f32 accumulator alone takes 128
//   registers a lane, so Q does not stay in registers: the block's rows
//   go by cp.async into a tile in shared memory after the ring, in the
//   first tile's copy group, and each k step's fragments are read from
//   it by ldmatrix (QFrags, hopper_tile.cuh); bf16 stages are 66 KB there,
//   so both rings take three.  The merge pass runs one thread per output
//   column, a partial last warp at 80 and 96; it has no warp-level step.
//
// Why not wgmma or TMA here: a decode tile has g <= 16 rows where wgmma
// takes 64; at these shapes both kernels are bound by bytes and launch
// latency (bounds of 0.2-0.9 us), so wgmma's full rate buys nothing yet;
// and a per-key-row paged gather is simpler with cp.async than with one
// TMA box per page.
//
// The f32-q instances (f32 pages, or int8 pages under f32 q) keep full
// f32 math on the CUDA cores, with no TF32, as the f32 cross-checks of
// the serving paths need: one block per (row, kv head) for decode and
// per (64-row tile, kv head, row) for prefill, looping over 32- or
// 64-key tiles and looking each key's page up as they load.
//
// float8 e4m3 pages (a kv_cache_dtype pool).  The Pallas kernels upcast a
// page of any dtype to f32 after its load; here a third page type streams
// one byte a value through the same ring (the same odd pitch of 16-byte
// pieces as int8) and converts each value where it is read: to f32 in the
// f32-q kernels, and in the bf16-q kernels pairwise (one e4m3x2 -> f16x2
// cvt) to the bf16 fragments mma.sync takes.  Every e4m3 value, the
// subnormals included, is exact in f16, f32 and bf16, so the conversion
// rounds nothing, and e4m3 pages need no scale.
//
// int8 pages.  The Pallas kernels' quantized instance streams int8 pages
// with an f32 [bt, 1] scale block riding the same page index map and
// dequantizes right after the load; here every instance reads the codes
// and the scale through the same clamped page id and dequantizes code *
// scale in f32.  An int8 page moves hd + 4 bytes per (token, kv head)
// where a bf16 page moves 2 * hd.  Int4 pages have no kernel: the
// reference sends them to the gather path on purpose, and so does the
// port.
//
// Tile constants (below): KV_SPLIT, the keys per decode split (the
// wrapper's KV_SPLIT in ops/paged_attention.py; a launch whose split
// count does not match it is refused), and PREFILL_ROWS, the query rows
// per prefill block.  Both were chosen by timing the alternatives at the
// serving shapes (PERF.md): 128 against 256 keys, 16 against 32 and 64
// rows.
//
// Plain C interface, loaded with ctypes: each launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tile.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int KV_SPLIT = 128;     // keys per decode split
constexpr int PREFILL_ROWS = 16;  // regrouped query rows per prefill block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);   // exact: e4m3 -> f16 -> f32
}
__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Token row of (position pos, kv head h) in a pool [num_pages, nkv, bt,
// .] through the table row `tab`, the page id clamped into the pool:
// element d of the page data is at row * hd + d, the token's int8 scale
// at row.
__device__ __forceinline__ size_t page_row(const int* tab, int pos, int bt,
                                           int nkv, int h, int num_pages) {
  const int j = pos / bt;
  const int page = min(max(tab[j], 0), num_pages - 1);
  return ((size_t)page * nkv + h) * bt + (pos - j * bt);
}

// Element d of a token row as f32: a full-width or e4m3 page converts,
// an int8 page multiplies its code by the token's scale (sc is unused
// for the others).
template <typename P>
__device__ __forceinline__ float load_kv(const P* __restrict__ p,
                                         const float* __restrict__ sc,
                                         size_t row, int hd, int d) {
  if constexpr (std::is_same<P, int8_t>::value) {
    return (float)p[row * hd + d] * sc[row];
  } else {
    return to_f32(p[row * hd + d]);
  }
}

// ---------------------------------------------------------------------
// Decode

constexpr int D_NT = 128;     // threads per block
constexpr int D_TK = 32;      // keys per tile: one lane each in the softmax
constexpr int D_GMAX = 16;    // q heads per kv head

template <int HD>
constexpr size_t decode_smem_bytes() {
  // qs [GMAX][HD] + ks [TK][HD+1] + vs [TK][HD] + ps [GMAX][TK]
  // + running max, sum and rescale factor [GMAX] each, all f32; the +1
  // pad keeps the lanes of a warp on distinct banks in the score loop
  return sizeof(float) * (D_GMAX * HD + D_TK * (HD + 1) + D_TK * HD +
                          D_GMAX * D_TK + 3 * D_GMAX);
}

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(D_NT)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                    const float* __restrict__ ksc,
                    const P* __restrict__ vp,
                    const float* __restrict__ vsc,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_lens,
                    const float* __restrict__ slopes, T* __restrict__ out,
                    int nh, int nkv, int bt, int num_pages, int W,
                    float scale) {
  constexpr int KP = HD + 1;
  constexpr int OPT = D_GMAX * HD / D_NT;   // accumulator cells per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [GMAX][HD]
  float* ks = qs + D_GMAX * HD;       // [TK][KP]
  float* vs = ks + D_TK * KP;         // [TK][HD]
  float* ps = vs + D_TK * HD;         // [GMAX][TK]
  float* m_s = ps + D_GMAX * D_TK;    // [GMAX]
  float* l_s = m_s + D_GMAX;          // [GMAX]
  float* a_s = l_s + D_GMAX;          // [GMAX]

  const int g = nh / nkv;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* tab = tables + (size_t)bi * W;
  const int kv_len = kv_lens[bi];
  // the query sits at kv_len - 1; keys past the table do not exist
  const int kv_end = max(0, min(kv_len, W * bt));
  const int qpos = kv_len - 1;

  // q pre-scaled in f32 as the reference does (q * 1/sqrt(hd))
  for (int i = tid; i < D_GMAX * HD; i += D_NT) {
    const int r = i / HD, d = i - r * HD;
    qs[i] = r < g ? to_f32(q[((size_t)bi * nh + h * g + r) * HD + d]) *
                        scale
                  : 0.f;
  }
  if (tid < D_GMAX) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) acc[o] = 0.f;

  for (int t0 = 0; t0 < kv_end; t0 += D_TK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < D_TK * HD; i += D_NT) {
      const int r = i / HD, d = i - r * HD;
      const int pos = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (pos < kv_end) {
        const size_t row = page_row(tab, pos, bt, nkv, h, num_pages);
        kx = load_kv(kp, ksc, row, HD, d);
        vx = load_kv(vp, vsc, row, HD, d);
      }
      ks[r * KP + d] = kx;
      vs[r * HD + d] = vx;
    }
    __syncthreads();

    // scores of (q row, key) pairs
    for (int i = tid; i < g * D_TK; i += D_NT) {
      const int r = i / D_TK, c = i - r * D_TK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d)
        s = fmaf(qs[r * HD + d], ks[c * KP + d], s);
      ps[r * D_TK + c] = s;
    }
    __syncthreads();

    // online softmax: one warp per q row, one lane per key
    for (int r = warp; r < g; r += D_NT / 32) {
      const int kpos = t0 + lane;
      const bool ok = kpos < kv_end;
      float sv = ps[r * D_TK + lane];
      if (slopes != nullptr) sv -= slopes[h * g + r] * (float)(qpos - kpos);
      sv = ok ? sv : NEG;
      float mx = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = ok ? expf(sv - m_new) : 0.f;
      float rs = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      ps[r * D_TK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + rs;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    const int cols = min(D_TK, kv_end - t0);
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const int i = tid + o * D_NT;
      const int r = i / HD, d = i - r * HD;
      if (r < g) {
        float a = acc[o] * a_s[r];
        for (int c = 0; c < cols; ++c)
          a = fmaf(ps[r * D_TK + c], vs[c * HD + d], a);
        acc[o] = a;
      }
    }
  }
  __syncthreads();  // l_s is final (and initialized when no tile ran)

#pragma unroll
  for (int o = 0; o < OPT; ++o) {
    const int i = tid + o * D_NT;
    const int r = i / HD, d = i - r * HD;
    if (r < g)
      store_val(out + ((size_t)bi * nh + h * g + r) * HD + d,
                acc[o] / fmaxf(l_s[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------
// Prefill

constexpr int P_BR = 64;               // query rows per block
constexpr int P_BK = 64;               // keys per tile
constexpr int P_NT = 128;              // threads per block
constexpr int P_RPT = P_BR / (P_NT / 16);   // rows per thread (8)
constexpr int P_CPT = P_BK / 16;       // score columns per thread (4)

template <int HD>
constexpr size_t prefill_smem_bytes() {
  // qs [BR][HD+1] + ks [BK][HD+1] + vs [BK][HD] + ps [BR][BK+1], f32;
  // the +1 pads keep the row-broadcast reads on distinct banks
  return sizeof(float) * (P_BR * (HD + 1) + P_BK * (HD + 1) + P_BK * HD +
                          P_BR * (P_BK + 1));
}

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(P_NT)
paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                     const float* __restrict__ ksc,
                     const P* __restrict__ vp,
                     const float* __restrict__ vsc,
                     const int* __restrict__ tables,
                     const int* __restrict__ starts,
                     const float* __restrict__ slopes, T* __restrict__ out,
                     int chunk, int nh, int nkv, int bt, int num_pages,
                     int W, float scale) {
  constexpr int QP = HD + 1;
  constexpr int KP = HD + 1;
  constexpr int PP = P_BK + 1;
  constexpr int DPT = HD / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [BR][QP]
  float* ks = qs + P_BR * QP;     // [BK][KP]
  float* vs = ks + P_BK * KP;     // [BK][HD]
  float* ps = vs + P_BK * HD;     // [BR][PP]

  const int g = nh / nkv;
  const int rows = chunk * g;
  const int row0 = blockIdx.x * P_BR;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;        // column lane within a half-warp
  const int ty = tid >> 4;        // row group; one half-warp per group
  const int* tab = tables + (size_t)bi * W;
  const int start = starts[bi];

  for (int i = tid; i < P_BR * HD; i += P_NT) {
    const int r = i / HD, d = i - r * HD;
    const int row = row0 + r;
    float val = 0.f;
    if (row < rows) {
      const int c = row / g, m = row - c * g;
      const size_t off =
          (((size_t)bi * chunk + c) * nh + (size_t)h * g + m) * HD + d;
      val = to_f32(q[off]) * scale;
    }
    qs[r * QP + d] = val;
  }

  float m_i[P_RPT], l_i[P_RPT], acc[P_RPT][DPT], slope[P_RPT];
  int qpos[P_RPT];
#pragma unroll
  for (int r = 0; r < P_RPT; ++r) {
    const int row = row0 + ty * P_RPT + r;
    qpos[r] = start + row / g;
    slope[r] = slopes != nullptr ? slopes[h * g + row % g] : 0.f;
    m_i[r] = NEG;
    l_i[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[r][j] = 0.f;
  }

  // the tile's causal frontier, and never past the table
  const int last_row = min(row0 + P_BR, rows) - 1;
  const int kv_end = max(0, min(start + last_row / g + 1, W * bt));

  for (int t0 = 0; t0 < kv_end; t0 += P_BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < P_BK * HD; i += P_NT) {
      const int r = i / HD, d = i - r * HD;
      const int pos = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (pos < kv_end) {
        const size_t row = page_row(tab, pos, bt, nkv, h, num_pages);
        kx = load_kv(kp, ksc, row, HD, d);
        vx = load_kv(vp, vsc, row, HD, d);
      }
      ks[r * KP + d] = kx;
      vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[P_RPT][P_CPT];
#pragma unroll
    for (int r = 0; r < P_RPT; ++r)
#pragma unroll
      for (int j = 0; j < P_CPT; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float kr[P_CPT];
#pragma unroll
      for (int j = 0; j < P_CPT; ++j) kr[j] = ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int r = 0; r < P_RPT; ++r) {
        const float qv = qs[(ty * P_RPT + r) * QP + d];
#pragma unroll
        for (int j = 0; j < P_CPT; ++j) s[r][j] = fmaf(qv, kr[j], s[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < P_RPT; ++r) {
      float mx = NEG;
      unsigned valid = 0;
#pragma unroll
      for (int j = 0; j < P_CPT; ++j) {
        const int kpos = t0 + tx + 16 * j;
        const bool ok = kpos <= qpos[r] && kpos < kv_end;
        float sv = s[r][j] - slope[r] * (float)(qpos[r] - kpos);
        sv = ok ? sv : NEG;
        valid |= (ok ? 1u : 0u) << j;
        s[r][j] = sv;
        mx = fmaxf(mx, sv);
      }
      // the 16 lanes of this half-warp hold the row's 64 columns
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < P_CPT; ++j) {
        const float p = (valid >> j) & 1u ? expf(s[r][j] - m_new) : 0.f;
        rs += p;
        ps[(ty * P_RPT + r) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[r] = l_i[r] * alpha + rs;
      m_i[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();  // a row's probabilities come from its own half-warp

    const int cols = min(P_BK, kv_end - t0);
    for (int c = 0; c < cols; ++c) {
      float vr[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vr[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < P_RPT; ++r) {
        const float p = ps[(ty * P_RPT + r) * PP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[r][j] = fmaf(p, vr[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < P_RPT; ++r) {
    const int row = row0 + ty * P_RPT + r;
    if (row >= rows) continue;
    const int c = row / g, m = row - c * g;
    const size_t off =
        (((size_t)bi * chunk + c) * nh + (size_t)h * g + m) * HD;
    const float denom = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      store_val(out + off + tx + 16 * j, acc[r][j] / denom);
  }
}

// ---------------------------------------------------------------------
// The bf16-q instances: tensor cores, cp.async ring, split-KV decode

using hopper_tile::cp_async16;
using hopper_tile::cp_async4;
using hopper_tile::mma_bf16;
using hopper_tile::pack_bf16;
using hopper_tile::QFrags;
using bf16 = __nv_bfloat16;

constexpr int TK = 64;        // keys per K/V tile, one stage of the ring
constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on sm_90
static_assert(KV_SPLIT % TK == 0 && KV_SPLIT > 0,
              "KV_SPLIT must be a positive multiple of the 64-key tile");
static_assert(PREFILL_ROWS == 16 || PREFILL_ROWS == 32 ||
                  PREFILL_ROWS == 64,
              "PREFILL_ROWS: 16, 32 or 64 rows per block of four warps");

// One ring stage for page type P: K and V rows of TK keys (and, for int8
// pages, each key's two f32 scales; e4m3 pages have none).  The row pitch is an odd count of
// 16-byte pieces, 16 or 32 bytes over the row: every row stays 16-byte
// aligned for cp.async, and the 8 rows one fragment load touches fall on
// distinct banks (an even count would put rows r and r + 4, or for int8
// V reads r and r + 2, on the same banks: int8 pages at hd 80, whose
// 80-byte rows take 32 bytes of padding where the others take 16).
template <typename P, int HD>
struct Stage {
  static constexpr bool Q8 = std::is_same<P, int8_t>::value;
  static constexpr bool BYTE = sizeof(P) == 1;   // int8 or e4m3 values
  static constexpr int PITCH =
      ((HD * (int)sizeof(P) / 16 + 1) | 1) * 16 / (int)sizeof(P);
  static constexpr size_t KV = (size_t)TK * PITCH * sizeof(P);
  static constexpr size_t BYTES = 2 * KV + (Q8 ? 2 * TK * sizeof(float) : 0);
  static __device__ P* k(char* st) { return reinterpret_cast<P*>(st); }
  static __device__ P* v(char* st) { return reinterpret_cast<P*>(st + KV); }
  static __device__ float* ks(char* st) {
    return reinterpret_cast<float*>(st + 2 * KV);
  }
  static __device__ float* vs(char* st) { return ks(st) + TK; }
};

// Q's A fragments (QFrags): held in registers up to hd 128; at hd 256
// read at each k step from a tile of the block's ROWS query rows (bf16,
// pitch QT_PITCH) in shared memory after the ring, BYTES long (0 where
// the fragments are held).
template <int HD>
constexpr int QT_PITCH = HD + 8;
template <int HD, int ROWS>
constexpr size_t QT_BYTES =
    QFrags<HD, QT_PITCH<HD>>::HELD
        ? 0
        : (size_t)ROWS * QT_PITCH<HD> * sizeof(bf16);

// Ring stages: decode issues a whole split's copies at once (up to 3
// tiles), prefill keeps 3 tiles' copies in flight beside the one being
// computed, so copy latency hides behind earlier tiles' math; fewer where
// that many do not fit beside Q's tile (bf16 pages at hd 256: 66 KB
// stages, three of them).
template <typename P, int HD, int ROWS>
__host__ __device__ constexpr int stages(int want) {
  const int fit = (int)((SMEM_MAX - QT_BYTES<HD, ROWS>) / Stage<P, HD>::BYTES);
  return fit < want ? fit : want;
}
template <typename P, int HD>
constexpr int D_STAGES =
    stages<P, HD, 16>(KV_SPLIT / TK + 1 < 4 ? KV_SPLIT / TK + 1 : 4);
template <typename P, int HD>
constexpr int P_STAGES = stages<P, HD, PREFILL_ROWS>(4);

// The ring's copies.  A block has T_NT = 128 threads and a tile TK = 64
// key rows, so thread tid copies half of key row tid / 2: it looks the
// row's page up once (tile_row, a table load issued a tile ahead of its
// use) and issues its 16-byte pieces (issue_tile); keys at or past kend
// are zero-filled, so their products stay finite (their probabilities
// are exactly 0).
constexpr int T_NT = 128;

// The token row of this thread's key in the tile at t0, or -1 past kend.
__device__ __forceinline__ long long tile_row(const int* tab, int t0,
                                              int kend, int bt, int nkv,
                                              int h, int num_pages) {
  const int pos = t0 + (threadIdx.x >> 1);
  return pos < kend ? (long long)page_row(tab, pos, bt, nkv, h, num_pages)
                    : -1;
}

template <typename P, int HD>
__device__ __forceinline__ void issue_tile(char* st, long long row,
                                           const P* __restrict__ kp,
                                           const float* __restrict__ ksc,
                                           const P* __restrict__ vp,
                                           const float* __restrict__ vsc) {
  using S = Stage<P, HD>;
  constexpr int E = 16 / (int)sizeof(P);          // elements per copy
  constexpr int CH = HD / E;                      // copies per key row
  const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
  const bool ok = row >= 0;
  const size_t src = ok ? (size_t)row : 0;
  P* kd = S::k(st) + r * S::PITCH;
  P* vd = S::v(st) + r * S::PITCH;
#pragma unroll
  for (int c = part; c < CH; c += 2) {
    cp_async16(kd + c * E, kp + src * HD + c * E, ok);
    cp_async16(vd + c * E, vp + src * HD + c * E, ok);
  }
  if constexpr (S::Q8) {
    if (part == 0) {
      cp_async4(S::ks(st) + r, ksc + src, ok);
      cp_async4(S::vs(st) + r, vsc + src, ok);
    }
  }
}

// Stream the tiles at first + t * TK, t < ntiles, below kend through a
// ring of NS stages and call math(t, stage) on each once it has landed.
// One barrier per tile: it publishes tile t and frees the stage of tile
// t - 1, which takes tile t + NS - 1's copy; the table load of the tile
// after that is issued before tile t's math, which hides its latency.
template <typename P, int HD, int NS, typename Math>
__device__ __forceinline__ void stream_tiles(char* ring, const P* kp,
                                             const float* ksc, const P* vp,
                                             const float* vsc, const int* tab,
                                             int first, int ntiles, int kend,
                                             int bt, int nkv, int h,
                                             int num_pages, Math&& math) {
  using S = Stage<P, HD>;
  static_assert(NS >= 2, "the ring needs two stages");
  // the prologue's table loads first, all in flight at once
  long long rows[NS - 1];
#pragma unroll
  for (int t = 0; t < NS - 1; ++t)
    rows[t] = t < ntiles ? tile_row(tab, first + t * TK, kend, bt, nkv, h,
                                    num_pages)
                         : -1;
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles)
      issue_tile<P, HD>(ring + t * S::BYTES, rows[t], kp, ksc, vp, vsc);
    hopper_tile::cp_async_commit();
  }
  long long next = NS - 1 < ntiles
                       ? tile_row(tab, first + (NS - 1) * TK, kend, bt, nkv,
                                  h, num_pages)
                       : -1;
  for (int t = 0; t < ntiles; ++t) {
    hopper_tile::cp_async_wait<NS - 2>();   // tile t has landed
    __syncthreads();
    const int tn = t + NS - 1;
    if (tn < ntiles)
      issue_tile<P, HD>(ring + (tn % NS) * S::BYTES, next, kp, ksc, vp, vsc);
    hopper_tile::cp_async_commit();         // (empty past the last tile)
    if (tn + 1 < ntiles)
      next = tile_row(tab, first + (tn + 1) * TK, kend, bt, nkv, h,
                      num_pages);
    math(t, ring + (t % NS) * S::BYTES);
  }
  hopper_tile::cp_async_wait<0>();   // (Q's tile copies, where no tile ran)
  __syncthreads();   // every warp is done with the ring
}

// Two adjacent byte-wide values of a stage row as a bf16 pair: int8
// codes and e4m3 values are both exact in bf16.
__device__ __forceinline__ uint32_t pair_bf16(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return pack_bf16((float)c.x, (float)c.y);
}
__device__ __forceinline__ uint32_t pair_bf16(const __nv_fp8_e4m3* p) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      *reinterpret_cast<const __nv_fp8x2_storage_t*>(p), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack_bf16(f.x, f.y);
}

// The B operands of S = Q K^T for 16 keys from stage row `key` at head
// columns [d, d + 16): b[0], b[1] for keys key .. key + 7 and b[2], b[3]
// for key + 8 .. key + 15 (B[d][n] = K[n][d]).  bf16 pages: one ldmatrix;
// int8 pages: the codes, exact in bf16 (the key's scale multiplies its
// score column in f32, see attend); e4m3 pages: the values, exact too.
template <typename P, int HD>
__device__ __forceinline__ void k_frags(char* st, int key, int d,
                                        uint32_t (&b)[4]) {
  using S = Stage<P, HD>;
  const int lane = threadIdx.x & 31;
  if constexpr (S::BYTE) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const P* kr = S::k(st) + (key + 8 * j + gid) * S::PITCH + d + 2 * tig;
      b[2 * j] = pair_bf16(kr);
      b[2 * j + 1] = pair_bf16(kr + 8);
    }
  } else {
    const int row = key + (lane & 7) + ((lane >> 4) << 3);
    hopper_tile::ldmatrix_x4(
        b, S::k(st) + row * S::PITCH + d + (((lane >> 3) & 1) << 3));
  }
}

// The B operands of O += P V for the 16 keys from stage row `key` at
// head columns [d, d + 16): b[0], b[1] for columns d .. d + 7 and b[2],
// b[3] for d + 8 .. d + 15 (B[k][n] = V[key + k][n]).  bf16 pages: one
// ldmatrix.trans; int8 pages: the codes (the key's scale multiplies its
// probability in f32, see attend); e4m3 pages: the values.
template <typename P, int HD>
__device__ __forceinline__ void v_frags(char* st, int key, int d,
                                        uint32_t (&b)[4]) {
  using S = Stage<P, HD>;
  constexpr int PI = S::PITCH;
  const int lane = threadIdx.x & 31;
  if constexpr (S::BYTE) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const P* vr = S::v(st) + (key + 2 * tig) * PI + d + 8 * j + gid;
      b[2 * j] = pack_bf16((float)vr[0], (float)vr[PI]);
      b[2 * j + 1] = pack_bf16((float)vr[8 * PI], (float)vr[9 * PI]);
    }
  } else {
    // matrices: (keys 0-7, cols 0-7), (keys 8-15, cols 0-7), (keys 0-7,
    // cols 8-15), (keys 8-15, cols 8-15)
    const int row = key + (lane & 7) + (((lane >> 3) & 1) << 3);
    hopper_tile::ldmatrix_x4_trans(
        b, S::v(st) + row * PI + d + ((lane >> 4) << 3));
  }
}

// Q's A fragments for the warp's rows gid (lo) and gid + 8 (hi), read
// from global memory once; a null row is zero padding.
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HD / 16][4],
                                       const bf16* lo, const bf16* hi) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d = kk * 16 + 2 * tig;
    qa[kk][0] = lo ? *reinterpret_cast<const uint32_t*>(lo + d) : 0u;
    qa[kk][1] = hi ? *reinterpret_cast<const uint32_t*>(hi + d) : 0u;
    qa[kk][2] = lo ? *reinterpret_cast<const uint32_t*>(lo + d + 8) : 0u;
    qa[kk][3] = hi ? *reinterpret_cast<const uint32_t*>(hi + d + 8) : 0u;
  }
}

// The block's ROWS query rows into Q's tile (hd 256) by 4-byte cp.async
// (q's rows are 4-byte aligned), joining the ring's first copy group:
// row r comes from row_ptr(r), null for zero padding.
template <int HD, int ROWS, typename RowPtr>
__device__ __forceinline__ void issue_q_tile(bf16* tile, const bf16* q,
                                             RowPtr row_ptr) {
  constexpr int WORDS = HD / 2;
  for (int i = threadIdx.x; i < ROWS * WORDS; i += T_NT) {
    const int r = i / WORDS, w = i - r * WORDS;
    const bf16* src = row_ptr(r);
    cp_async4(tile + r * QT_PITCH<HD> + 2 * w, src ? src + 2 * w : q,
              src != nullptr);
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// One warp's online-softmax step over the KW keys at stage rows
// [kb, kb + KW) of the tile starting at position t0: S = Q K^T for its 16
// rows; in f32, the scale, the int8 keys' scales, ALiBi and the mask (key
// < kend and key <= the row's position), all in the log2 domain (sl2 =
// scale * log2 e, the slopes times log2 e), so exp2f(s - m) is the
// softmax's exp(s - m); the running max m and this lane's share of the
// sum l for rows gid and gid + 8; then O += P V with P rounded to bf16 in
// registers (for int8 pages, P times each key's V scale).
template <typename P, int HD, int KW>
__device__ __forceinline__ void attend(char* st,
                                       const QFrags<HD, QT_PITCH<HD>>& qf,
                                       int kb, int t0, float sl2, int kend,
                                       const int (&qpos)[2],
                                       const float (&slope2)[2],
                                       float (&m)[2], float (&l)[2],
                                       float (&o)[HD / 8][4]) {
  using S = Stage<P, HD>;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  float s[KW / 8][4];
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    qf.get(kk, a);
#pragma unroll
    for (int jj = 0; jj < KW / 16; ++jj) {
      uint32_t b[4];
      k_frags<P, HD>(st, kb + 16 * jj, kk * 16, b);
      mma_bf16(s[2 * jj], a, b[0], b[1]);
      mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
    }
  }

  static_assert(KW / 8 * 4 <= 32, "validity mask bits");
  unsigned valid = 0;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      const int c = kb + 8 * j + 2 * tig + (e & 1);   // stage row
      const int key = t0 + c;
      const bool ok = key < kend && key <= qpos[hr];
      float v = s[j][e];
      if constexpr (S::Q8) v *= S::ks(st)[c];
      v = v * sl2 - slope2[hr] * (float)(qpos[hr] - key);
      s[j][e] = ok ? v : NEG;
      valid |= (ok ? 1u : 0u) << (j * 4 + e);
      mx[hr] = fmaxf(mx[hr], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    // the quad's four lanes hold the row's columns
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr]);
    alpha[hr] = exp2f(m[hr] - m_new);
    m[hr] = m_new;
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      float p = (valid >> (j * 4 + e)) & 1u ? exp2f(s[j][e] - m[hr]) : 0.f;
      l[hr] += p;
      if constexpr (S::Q8) p *= S::vs(st)[kb + 8 * j + 2 * tig + (e & 1)];
      s[j][e] = p;
    }
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      uint32_t b[4];
      v_frags<P, HD>(st, kb + 16 * kk, 16 * nn, b);
      mma_bf16(o[2 * nn], pa, b[0], b[1]);
      mma_bf16(o[2 * nn + 1], pa, b[2], b[3]);
    }
  }
}

// The row sums: each lane holds a share of its rows' columns.
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
}

// The four warps' running states, parked in shared memory once the ring
// is free: m and l (summed over the quad) of rows gid and gid + 8, and the
// f32 accumulators, [warp][16 rows] and [warp][16 rows][HD].
template <int HD>
__device__ __forceinline__ void stash_state(char* ring, const float (&m)[2],
                                            const float (&l)[2],
                                            const float (&o)[HD / 8][4]) {
  float* wm = reinterpret_cast<float*>(ring);
  float* wl = wm + 4 * 16;
  float* wo = wl + 4 * 16;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int r = (threadIdx.x >> 5) * 16 + gid;
  if (tig == 0) {
    wm[r] = m[0];
    wm[r + 8] = m[1];
    wl[r] = l[0];
    wl[r + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    wo[r * HD + c] = o[n][0];
    wo[r * HD + c + 1] = o[n][1];
    wo[(r + 8) * HD + c] = o[n][2];
    wo[(r + 8) * HD + c + 1] = o[n][3];
  }
}

// Row r of warps w0 .. w0 + n - 1 merged in warp order: the common max
// mm, and l and column d of the accumulator rescaled to it.
template <int HD>
__device__ __forceinline__ void merge_state(const char* ring, int w0, int n,
                                            int r, int d, float& mm,
                                            float& ll, float& acc) {
  const float* wm = reinterpret_cast<const float*>(ring);
  const float* wl = wm + 4 * 16;
  const float* wo = wl + 4 * 16;
  mm = NEG;
  for (int w = w0; w < w0 + n; ++w) mm = fmaxf(mm, wm[w * 16 + r]);
  ll = 0.f;
  acc = 0.f;
  for (int w = w0; w < w0 + n; ++w) {
    const float e = exp2f(wm[w * 16 + r] - mm);
    ll += wl[w * 16 + r] * e;
    acc += wo[(w * 16 + r) * HD + d] * e;
  }
}

// The ring, reused at the end for the four warps' states; Q's tile
// (hd 256) follows it.
template <typename P, int HD, int NS>
__host__ __device__ constexpr size_t ring_bytes() {
  constexpr size_t ring = NS * Stage<P, HD>::BYTES;
  constexpr size_t merge = sizeof(float) * 4 * 16 * (2 + HD);
  return ring > merge ? ring : merge;
}

template <typename P, int HD, int NS, int ROWS>
constexpr size_t ring_smem_bytes() {
  constexpr size_t bytes = ring_bytes<P, HD, NS>() + QT_BYTES<HD, ROWS>;
  static_assert(bytes <= SMEM_MAX, "over the SM's 227 KB");
  return bytes;
}

// Decode, split s of (kv head h, row bi): the unnormalised partial (acc,
// m, l; m in the log2 domain of attend) of the keys [s*KV_SPLIT, (s+1)*KV_SPLIT) below kv_end, written to
// part_acc [b, splits, nh, HD] and part_m / part_l [b, splits, nh].  Warp
// w owns keys [16 w, 16 w + 16) of every tile.
template <typename P, int HD>
__global__ void __launch_bounds__(T_NT)
paged_decode_split_kernel(const bf16* __restrict__ q,
                          const P* __restrict__ kp,
                          const float* __restrict__ ksc,
                          const P* __restrict__ vp,
                          const float* __restrict__ vsc,
                          const int* __restrict__ tables,
                          const int* __restrict__ kv_lens,
                          const float* __restrict__ slopes,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l, int nh, int nkv,
                          int bt, int num_pages, int W, int splits,
                          float scale) {
  extern __shared__ __align__(16) char ring[];
  const int s = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int kv_len = kv_lens[bi];
  const int kv_end = max(0, min(kv_len, W * bt));
  const int s0 = s * KV_SPLIT;
  if (s0 >= kv_end) return;          // a dead split: the merge skips it
  const int s1 = min(s0 + KV_SPLIT, kv_end);
  const int g = nh / nkv;
  const int* tab = tables + (size_t)bi * W;
  const int tid = threadIdx.x, warp = tid >> 5, gid = (tid & 31) >> 2;

  // the g q heads of kv head h are the A tile's rows, zero-padded to 16
  constexpr int NS = D_STAGES<P, HD>;
  const bf16* qb = q + ((size_t)bi * nh + (size_t)h * g) * HD;
  QFrags<HD, QT_PITCH<HD>> qf;
  if constexpr (QFrags<HD, QT_PITCH<HD>>::HELD) {
    load_q<HD>(qf.a, gid < g ? qb + (size_t)gid * HD : nullptr,
               gid + 8 < g ? qb + (size_t)(gid + 8) * HD : nullptr);
  } else {
    bf16* qt = reinterpret_cast<bf16*>(ring + ring_bytes<P, HD, NS>());
    issue_q_tile<HD, 16>(qt, q, [&](int r) {
      return r < g ? qb + (size_t)r * HD : nullptr;
    });
    qf.tile = qt;
  }
  const int qpos[2] = {kv_len - 1, kv_len - 1};
  const float slope2[2] = {
      slopes != nullptr && gid < g ? slopes[h * g + gid] * LOG2E : 0.f,
      slopes != nullptr && gid + 8 < g ? slopes[h * g + gid + 8] * LOG2E
                                       : 0.f};
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  stream_tiles<P, HD, NS>(
      ring, kp, ksc, vp, vsc, tab, s0, (s1 - s0 + TK - 1) / TK, s1, bt, nkv,
      h, num_pages, [&](int t, char* st) {
        const int t0 = s0 + t * TK;
        if (t0 + warp * 16 < s1)      // warp-uniform
          attend<P, HD, 16>(st, qf, warp * 16, t0, scale * LOG2E, s1, qpos,
                            slope2, m, l, o);
      });
  quad_sum(l);
  stash_state<HD>(ring, m, l, o);
  __syncthreads();
  for (int i = tid; i < g * HD; i += T_NT) {
    const int r = i / HD, d = i - r * HD;
    float mm, ll, acc;
    merge_state<HD>(ring, 0, 4, r, d, mm, ll, acc);
    const size_t pr = ((size_t)bi * splits + s) * nh + (size_t)h * g + r;
    part_acc[pr * HD + d] = acc;
    if (d == 0) {
      part_m[pr] = mm;
      part_l[pr] = ll;
    }
  }
}

// Decode, second pass: row bi, q head blockIdx.x merges its live splits
// in split order and writes out [b, 1, nh, HD]; kv_end = 0 writes 0.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const int* __restrict__ kv_lens,
                          T* __restrict__ out, int nh, int bt, int W,
                          int splits) {
  const int qh = blockIdx.x, bi = blockIdx.y, d = threadIdx.x;
  const int kv_end = max(0, min(kv_lens[bi], W * bt));
  const int live = (kv_end + KV_SPLIT - 1) / KV_SPLIT;
  const size_t base = (size_t)bi * splits * nh + qh;
  float mm = NEG;
  for (int s = 0; s < live; ++s) mm = fmaxf(mm, part_m[base + (size_t)s * nh]);
  float ll = 0.f, acc = 0.f;
  for (int s = 0; s < live; ++s) {
    const size_t pr = base + (size_t)s * nh;
    const float e = exp2f(part_m[pr] - mm);
    ll += part_l[pr] * e;
    acc += part_acc[pr * HD + d] * e;
  }
  store_val(out + ((size_t)bi * nh + qh) * HD + d, acc / fmaxf(ll, 1e-30f));
}

// Prefill: PREFILL_ROWS regrouped rows of one (kv head h, row bi) per
// block of four warps, 16 rows per row-warp; the KWARPS = 4 * 16 /
// PREFILL_ROWS warps of a row group share each tile's keys, TK / KWARPS
// each, and merge in shared memory at the end.
constexpr int P_KWARPS = 4 * 16 / PREFILL_ROWS;

template <typename P, int HD>
__global__ void __launch_bounds__(T_NT)
paged_prefill_mma_kernel(const bf16* __restrict__ q,
                         const P* __restrict__ kp,
                         const float* __restrict__ ksc,
                         const P* __restrict__ vp,
                         const float* __restrict__ vsc,
                         const int* __restrict__ tables,
                         const int* __restrict__ starts,
                         const float* __restrict__ slopes,
                         bf16* __restrict__ out, int chunk, int nh, int nkv,
                         int bt, int num_pages, int W, float scale) {
  constexpr int KWS = P_KWARPS;
  constexpr int KW = TK / KWS;        // keys of a tile per warp
  extern __shared__ __align__(16) char ring[];
  const int g = nh / nkv;
  const int rows = chunk * g;
  const int row0 = blockIdx.x * PREFILL_ROWS, h = blockIdx.y,
            bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rw = warp / KWS, kw = warp - rw * KWS;
  const int* tab = tables + (size_t)bi * W;
  const int start = starts[bi];

  // the block's causal frontier, and never past the table
  const int last_row = min(row0 + PREFILL_ROWS, rows) - 1;
  const int kv_end = max(0, min(start + last_row / g + 1, W * bt));

  // regrouped row r is position start + r / g of q head h*g + r % g
  const int wr0 = row0 + rw * 16;
  const int rr[2] = {wr0 + gid, wr0 + gid + 8};
  const bf16* qr[2];
  int qpos[2];
  float slope2[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = rr[hr] / g, mh = rr[hr] - c * g;
    qr[hr] = rr[hr] < rows
                 ? q + (((size_t)bi * chunk + c) * nh + (size_t)h * g + mh) *
                           HD
                 : nullptr;
    qpos[hr] = start + c;
    slope2[hr] = slopes != nullptr ? slopes[h * g + mh] * LOG2E : 0.f;
  }
  constexpr int NS = P_STAGES<P, HD>;
  QFrags<HD, QT_PITCH<HD>> qf;
  if constexpr (QFrags<HD, QT_PITCH<HD>>::HELD) {
    load_q<HD>(qf.a, qr[0], qr[1]);
  } else {
    bf16* qt = reinterpret_cast<bf16*>(ring + ring_bytes<P, HD, NS>());
    issue_q_tile<HD, PREFILL_ROWS>(qt, q, [&](int r) -> const bf16* {
      const int row = row0 + r;
      if (row >= rows) return nullptr;
      const int c = row / g, mh = row - c * g;
      return q + (((size_t)bi * chunk + c) * nh + (size_t)h * g + mh) * HD;
    });
    qf.tile = qt + rw * 16 * QT_PITCH<HD>;
  }
  // the row-warp's own frontier: its last real row's position + 1
  const int wlast = min(wr0 + 15, rows - 1);
  const int wend = wlast >= wr0 ? min(start + wlast / g + 1, kv_end) : 0;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  stream_tiles<P, HD, NS>(
      ring, kp, ksc, vp, vsc, tab, 0, (kv_end + TK - 1) / TK, kv_end, bt,
      nkv, h, num_pages, [&](int t, char* st) {
        if (t * TK + kw * KW < wend)  // warp-uniform: past the frontier
          attend<P, HD, KW>(st, qf, kw * KW, t * TK, scale * LOG2E, kv_end,
                            qpos, slope2, m, l, o);
      });
  quad_sum(l);

  if constexpr (KWS == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (qr[hr] == nullptr) continue;
      const size_t off = qr[hr] - q;  // out shares q's layout
      const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + off + 8 * n + 2 * tig) =
            pack_bf16(o[n][2 * hr] / den, o[n][2 * hr + 1] / den);
    }
  } else {
    stash_state<HD>(ring, m, l, o);
    __syncthreads();
    for (int i = tid; i < PREFILL_ROWS * HD; i += T_NT) {
      const int r = i / HD, d = i - r * HD;
      const int row = row0 + r;
      if (row >= rows) break;
      float mm, ll, acc;
      merge_state<HD>(ring, (r / 16) * KWS, KWS, r % 16, d, mm, ll, acc);
      const int c = row / g, mh = row - c * g;
      out[(((size_t)bi * chunk + c) * nh + (size_t)h * g + mh) * HD + d] =
          __float2bfloat16(acc / fmaxf(ll, 1e-30f));
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool shapes_ok(int b, int chunk, int nh, int nkv, int bt, int num_pages,
               int W) {
  return b > 0 && chunk > 0 && nkv > 0 && nh % nkv == 0 && bt > 0 &&
         num_pages > 0 && W > 0;
}

// The pages of one launch: data and, for int8, the scale sidecars
// (null for full-width and e4m3 pages).
struct Pages {
  const void* k;
  const float* ks;
  const void* v;
  const float* vs;
};

// The f32-q decode: one block per (kv head, row).
template <typename T, typename P, int HD>
cudaError_t launch_decode(const void* q, Pages pg, const int* tables,
                          const int* kv_lens, const float* slopes,
                          void* out, int b, int nh, int nkv, int bt,
                          int num_pages, int W, float scale,
                          cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<HD>();
  auto kern = paged_decode_kernel<T, P, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nkv, b);
  kern<<<grid, D_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pg.k), pg.ks,
      static_cast<const P*>(pg.v), pg.vs, tables, kv_lens, slopes,
      static_cast<T*>(out), nh, nkv, bt, num_pages, W, scale);
  return cudaGetLastError();
}

// The bf16-q decode: the split kernel, then the merge, on one stream.
template <typename P, int HD>
cudaError_t launch_decode_split(const void* q, Pages pg, const int* tables,
                                const int* kv_lens, const float* slopes,
                                void* out, float* part_acc, float* part_ml,
                                int b, int nh, int nkv, int bt,
                                int num_pages, int W, int splits,
                                float scale, cudaStream_t stream) {
  constexpr size_t smem = ring_smem_bytes<P, HD, D_STAGES<P, HD>, 16>();
  auto kern = paged_decode_split_kernel<P, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  float* part_m = part_ml;
  float* part_l = part_ml + (size_t)b * splits * nh;
  kern<<<dim3(splits, nkv, b), T_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const P*>(pg.k), pg.ks,
      static_cast<const P*>(pg.v), pg.vs, tables, kv_lens, slopes, part_acc,
      part_m, part_l, nh, nkv, bt, num_pages, W, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_merge_kernel<bf16, HD><<<dim3(nh, b), HD, 0, stream>>>(
      part_acc, part_m, part_l, kv_lens, static_cast<bf16*>(out), nh, bt, W,
      splits);
  return cudaGetLastError();
}

// The f32-q prefill: one block per (64-row tile, kv head, row).
template <typename T, typename P, int HD>
cudaError_t launch_prefill(const void* q, Pages pg, const int* tables,
                           const int* starts, const float* slopes, void* out,
                           int b, int chunk, int nh, int nkv, int bt,
                           int num_pages, int W, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<HD>();
  auto kern = paged_prefill_kernel<T, P, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int rows = chunk * (nh / nkv);
  dim3 grid((rows + P_BR - 1) / P_BR, nkv, b);
  kern<<<grid, P_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pg.k), pg.ks,
      static_cast<const P*>(pg.v), pg.vs, tables, starts, slopes,
      static_cast<T*>(out), chunk, nh, nkv, bt, num_pages, W, scale);
  return cudaGetLastError();
}

// The bf16-q prefill: one block per (PREFILL_ROWS rows, kv head, row).
template <typename P, int HD>
cudaError_t launch_prefill_mma(const void* q, Pages pg, const int* tables,
                               const int* starts, const float* slopes,
                               void* out, int b, int chunk, int nh, int nkv,
                               int bt, int num_pages, int W, float scale,
                               cudaStream_t stream) {
  constexpr size_t smem =
      ring_smem_bytes<P, HD, P_STAGES<P, HD>, PREFILL_ROWS>();
  constexpr int BR = PREFILL_ROWS;
  auto kern = paged_prefill_mma_kernel<P, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int rows = chunk * (nh / nkv);
  dim3 grid((rows + BR - 1) / BR, nkv, b);
  kern<<<grid, T_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const P*>(pg.k), pg.ks,
      static_cast<const P*>(pg.v), pg.vs, tables, starts, slopes,
      static_cast<bf16*>(out), chunk, nh, nkv, bt, num_pages, W, scale);
  return cudaGetLastError();
}

// The page types: full width (q's dtype), int8 codes with f32 scales,
// float8 e4m3 values.
enum PageKind { FULL = 0, INT8 = 1, FP8 = 2 };
template <int KIND, typename T>
struct PageOf {
  using type = T;
};
template <typename T>
struct PageOf<INT8, T> {
  using type = int8_t;
};
template <typename T>
struct PageOf<FP8, T> {
  using type = __nv_fp8_e4m3;
};

// One decode launch, dispatched on q's dtype (0 = float32, 1 =
// bfloat16), the page type (KIND) and the head dim.  bf16 q needs the partials' scratch: part_acc [b, splits, nh, hd]
// and part_ml [2, b, splits, nh] (m, then l), f32, with splits =
// ceil(W * bt / KV_SPLIT).
template <int KIND>
int decode_fwd(const void* q, Pages pg, const void* tables,
               const void* kv_lens, const void* slopes, void* out,
               void* part_acc, void* part_ml, int b, int nh, int nkv,
               int hd, int bt, int num_pages, int W, int splits, float scale,
               int dtype, void* stream) {
  if (!shapes_ok(b, 1, nh, nkv, bt, num_pages, W) || nh / nkv > D_GMAX)
    return (int)cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(kv_lens);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (part_acc == nullptr || part_ml == nullptr ||
        (long long)splits * KV_SPLIT < (long long)W * bt ||
        (long long)(splits - 1) * KV_SPLIT >= (long long)W * bt)
      return (int)cudaErrorInvalidValue;
    using P = typename PageOf<KIND, bf16>::type;
    float* pa = static_cast<float*>(part_acc);
    float* pm = static_cast<float*>(part_ml);
#define PD_SPLIT(HD)                                                        \
  return (int)launch_decode_split<P, HD>(q, pg, tab, lens, sl, out, pa, pm, \
                                         b, nh, nkv, bt, num_pages, W,      \
                                         splits, scale, st)
    if (hd == 64) PD_SPLIT(64);
    if (hd == 80) PD_SPLIT(80);
    if (hd == 96) PD_SPLIT(96);
    if (hd == 128) PD_SPLIT(128);
    if (hd == 256) PD_SPLIT(256);
#undef PD_SPLIT
    return (int)cudaErrorInvalidValue;
  }
#define PD_CASE(T, HD)                                                  \
  return (int)launch_decode<T, typename PageOf<KIND, T>::type, HD>(     \
      q, pg, tab, lens, sl, out, b, nh, nkv, bt, num_pages, W, scale, st)
  if (dtype == 0 && hd == 64) PD_CASE(float, 64);
  if (dtype == 0 && hd == 80) PD_CASE(float, 80);
  if (dtype == 0 && hd == 96) PD_CASE(float, 96);
  if (dtype == 0 && hd == 128) PD_CASE(float, 128);
  if (dtype == 0 && hd == 256) PD_CASE(float, 256);
#undef PD_CASE
  return (int)cudaErrorInvalidValue;
}

template <int KIND>
int prefill_fwd(const void* q, Pages pg, const void* tables,
                const void* starts, const void* slopes, void* out, int b,
                int chunk, int nh, int nkv, int hd, int bt, int num_pages,
                int W, float scale, int dtype, void* stream) {
  if (!shapes_ok(b, chunk, nh, nkv, bt, num_pages, W))
    return (int)cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* st0 = static_cast<const int*>(starts);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using P = typename PageOf<KIND, bf16>::type;
#define PP_MMA(HD)                                                         \
  return (int)launch_prefill_mma<P, HD>(q, pg, tab, st0, sl, out, b, chunk, \
                                        nh, nkv, bt, num_pages, W, scale,   \
                                        st)
    if (hd == 64) PP_MMA(64);
    if (hd == 80) PP_MMA(80);
    if (hd == 96) PP_MMA(96);
    if (hd == 128) PP_MMA(128);
    if (hd == 256) PP_MMA(256);
#undef PP_MMA
    return (int)cudaErrorInvalidValue;
  }
#define PP_CASE(T, HD)                                                     \
  return (int)launch_prefill<T, typename PageOf<KIND, T>::type, HD>(       \
      q, pg, tab, st0, sl, out, b, chunk, nh, nkv, bt, num_pages, W, scale, \
      st)
  if (dtype == 0 && hd == 64) PP_CASE(float, 64);
  if (dtype == 0 && hd == 80) PP_CASE(float, 80);
  if (dtype == 0 && hd == 96) PP_CASE(float, 96);
  if (dtype == 0 && hd == 128) PP_CASE(float, 128);
  if (dtype == 0 && hd == 256) PP_CASE(float, 256);
#undef PP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
// q/out [b, 1, nh, hd]; pages [num_pages, nkv, bt, hd]; tables [b, W]
// int32; kv_lens [b] int32; slopes [nh] float32 ALiBi slopes or null.
// part_acc / part_ml: the split partials' f32 scratch for bf16 q (see
// decode_fwd; null for f32 q), splits = ceil(W * bt / KV_SPLIT).
// Returns a cudaError_t; the caller raises on anything but 0.
int paged_decode_fwd(const void* q, const void* k_pages,
                     const void* v_pages, const void* tables,
                     const void* kv_lens, const void* slopes, void* out,
                     void* part_acc, void* part_ml, int b, int nh, int nkv,
                     int hd, int bt, int num_pages, int W, int splits,
                     float scale, int dtype, void* stream) {
  return decode_fwd<FULL>(q, Pages{k_pages, nullptr, v_pages, nullptr},
                           tables, kv_lens, slopes, out, part_acc, part_ml,
                           b, nh, nkv, hd, bt, num_pages, W, splits, scale,
                           dtype, stream);
}

// As paged_decode_fwd over int8 pages [num_pages, nkv, bt, hd] with their
// float32 scales [num_pages, nkv, bt, 1]; dtype is q's and out's.
int paged_decode_int8_fwd(const void* q, const void* k_pages,
                          const void* k_scale, const void* v_pages,
                          const void* v_scale, const void* tables,
                          const void* kv_lens, const void* slopes, void* out,
                          void* part_acc, void* part_ml, int b, int nh,
                          int nkv, int hd, int bt, int num_pages, int W,
                          int splits, float scale, int dtype, void* stream) {
  return decode_fwd<INT8>(
      q,
      Pages{k_pages, static_cast<const float*>(k_scale), v_pages,
            static_cast<const float*>(v_scale)},
      tables, kv_lens, slopes, out, part_acc, part_ml, b, nh, nkv, hd, bt,
      num_pages, W, splits, scale, dtype, stream);
}

// As paged_decode_fwd, with q/out [b, chunk, nh, hd] and starts [b]
// int32: the position of each row's first chunk token.
int paged_prefill_fwd(const void* q, const void* k_pages,
                      const void* v_pages, const void* tables,
                      const void* starts, const void* slopes, void* out,
                      int b, int chunk, int nh, int nkv, int hd, int bt,
                      int num_pages, int W, float scale, int dtype,
                      void* stream) {
  return prefill_fwd<FULL>(q, Pages{k_pages, nullptr, v_pages, nullptr},
                            tables, starts, slopes, out, b, chunk, nh, nkv,
                            hd, bt, num_pages, W, scale, dtype, stream);
}

// As paged_prefill_fwd over int8 pages with their float32 scales.
int paged_prefill_int8_fwd(const void* q, const void* k_pages,
                           const void* k_scale, const void* v_pages,
                           const void* v_scale, const void* tables,
                           const void* starts, const void* slopes, void* out,
                           int b, int chunk, int nh, int nkv, int hd, int bt,
                           int num_pages, int W, float scale, int dtype,
                           void* stream) {
  return prefill_fwd<INT8>(
      q,
      Pages{k_pages, static_cast<const float*>(k_scale), v_pages,
            static_cast<const float*>(v_scale)},
      tables, starts, slopes, out, b, chunk, nh, nkv, hd, bt, num_pages, W,
      scale, dtype, stream);
}

// As paged_decode_fwd over float8 e4m3 pages [num_pages, nkv, bt, hd]
// (one byte a value, no scales); dtype is q's and out's.
int paged_decode_fp8_fwd(const void* q, const void* k_pages,
                         const void* v_pages, const void* tables,
                         const void* kv_lens, const void* slopes, void* out,
                         void* part_acc, void* part_ml, int b, int nh,
                         int nkv, int hd, int bt, int num_pages, int W,
                         int splits, float scale, int dtype, void* stream) {
  return decode_fwd<FP8>(q, Pages{k_pages, nullptr, v_pages, nullptr},
                         tables, kv_lens, slopes, out, part_acc, part_ml, b,
                         nh, nkv, hd, bt, num_pages, W, splits, scale, dtype,
                         stream);
}

// As paged_prefill_fwd over float8 e4m3 pages.
int paged_prefill_fp8_fwd(const void* q, const void* k_pages,
                          const void* v_pages, const void* tables,
                          const void* starts, const void* slopes, void* out,
                          int b, int chunk, int nh, int nkv, int hd, int bt,
                          int num_pages, int W, float scale, int dtype,
                          void* stream) {
  return prefill_fwd<FP8>(q, Pages{k_pages, nullptr, v_pages, nullptr},
                          tables, starts, slopes, out, b, chunk, nh, nkv, hd,
                          bt, num_pages, W, scale, dtype, stream);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
