// The f32-q prefill tile for Hopper (sm_90a), shared by the dense-cache
// flash kernel (flash_attention.cu) and the paged prefill kernel
// (paged_attention.cu): causal GQA attention of ROWS regrouped query rows
// of one (kv head, batch row) over 64-key tiles of K/V, in full f32 on
// the CUDA cores (no TF32), for the f32 cross-checks of the serving paths,
// which hold f32 streams token for token and so must differ from the
// plain version by summation order alone.
//
// What bounds it.  At the serving shapes (a 64-token chunk, 512 rows per
// kv head) the work is a few MFLOP over a few hundred KB: bound by bytes
// at ~0.3 us, so the time is the serial chain of each block (copy -> S
// -> softmax -> P V -> merge -> store) and how many SMs share it.  Past a
// few hundred keys a row it turns to the card's 67 TFLOP/s of f32 FFMA,
// and an FFMA fed from shared memory needs its operands at well under one
// load per multiply-add.  The design:
//
// - Blocks.  ROWS = 16: the four warps share the block's 16 rows and each
//   takes fixed 16-key slices of every 64-key tile with its own running
//   (m, l, acc), merged in shared memory in warp order at the end, so a
//   serving chunk gets 4x the blocks that 64-row blocks give (128 against
//   32 at TinyLlama's 64-token chunk).  ROWS = 64 (full-width f32 K/V,
//   hd <= 128): each warp owns 16 rows and walks every key, so one K/V
//   tile in shared memory feeds 64 rows; on long chunks 16-row blocks each
//   re-read their whole prefix from L2.  The wrappers pick it once its
//   blocks fill one and a half waves of the SMs (f32_rows_per_block,
//   ops/flash_attention.py).
// - Fixed summation order.  A warp's keys sit at fixed positions of every
//   tile, each score is one FFMA chain over the head columns in order,
//   P V sums a warp's keys in order, and the merge runs in warp order.  A
//   tile or a slice wholly past a row's position is either skipped or
//   masked to an exact no-op (alpha = 1, p = 0), so a row's output depends
//   only on its own q, position and keys, never on b or on its block's
//   other rows.
// - Copies.  K and V arrive as chunks of 64 key rows x HDP head columns
//   (HDP = hd, or 128 at hd 256, whose K and V take two chunks each) by
//   16-byte cp.async (4 f32 values, or 16 int8 codes / e4m3 values plus
//   each token's f32 scale; a dense f32 cache that is only 4-byte
//   aligned, by 4-byte copies) into a ring of NS chunk slots (stages()),
//   one barrier a chunk: the copies of the next chunks run beside the
//   math of this one.
//   Each thread copies half of key row tid / 2 and looks its token row up
//   once a tile, one tile ahead (for pages: one table load, one divide).
//   Keys past the block's causal frontier are zero-filled, never read.
// - Byte pages (int8, e4m3): each warp turns its own 16 key rows of a
//   chunk into f32 in a tile of its own, once (int8: code * scale in f32
//   per element, as the plain version computes it; e4m3: exact), so the
//   inner loops read f32 either way.
// - Registers.  A 16-byte shared-memory load is served a quarter-warp at
//   a time, one wavefront a quarter at best however many lanes share an
//   address, so its cost is the loads a lane makes.  Lane (gid = lane /
//   8, tig = lane % 8) owns rows gid + 4 i (i < 4) of its warp's 16: of S
//   the keys tig + 8 j of its slice, of O the 16-byte column groups tig +
//   8 j (a ragged last group at hd 80), so the softmax's row state stays
//   in the lane.  S reads 4 Q and KW / 8 K rows as float4 per 4 head
//   columns, P V a key's four P values and its V row's groups: wavefronts
//   per FFMA, S 0.75 (16 rows: 8 scores a lane) or 0.375 (64 rows: 32),
//   P V 0.375 at hd 64, 0.31 at hd 128 (a 2 x 4 micro-tile with 2-row O
//   slices was 0.56 for the 64-row S and P V, and 1.2-1.4x slower on the
//   card).  Row pitches are an odd number of 16-byte pieces, so the 8 key
//   rows a quarter reads fall on distinct banks.
// - Softmax: f32 online softmax in the log2 domain (scores times log2 e,
//   ALiBi slopes times log2 e, exp2f), masked scores -1e30, masked
//   probabilities exactly 0, division by max(l, 1e-30); Q is scaled by
//   1/sqrt(hd) in f32 as it lands; a row with no keys writes 0.
//
// The kernels around it supply the token row of a key (the dense plane's
// row, or the page table's) and the bounds.
//
// The f32 paged decode (paged_decode_f32_split_kernel) runs the same tile
// over one split of a row's keys: its g <= 16 q heads are the block's 16
// rows (chunk 1), the tiles start at the split's first key, and the block
// writes its unnormalised partial (acc, m, l; m in the log2 domain) for a
// second pass that merges the splits in split order.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "hopper_tile.cuh"

namespace f32_tile {

constexpr int NT = 128;                 // four warps
constexpr int TK = 64;                  // keys per tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_MAX = 232448;     // a block's shared memory on sm_90

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// Instance (P = the K/V element type: float, int8_t or __nv_fp8_e4m3; HD;
// ROWS query rows a block; NS chunk slots in the ring).  Shared memory:
// the Q tile [ROWS][QP] f32, the warps' P tiles [4][KW keys][PT] (a key's
// 16 rows, lane-ordered), for byte pages the warps' converted K/V rows
// [4][16][KP], then the ring (reused at the end for the 16-row merge: m,
// l [4][16], acc [4][16][MP]).
template <typename P, int HD, int ROWS, int NS>
struct Inst {
  static constexpr bool BYTE = sizeof(P) == 1;
  static constexpr bool Q8 = std::is_same<P, int8_t>::value;
  static constexpr int HDP = HD > 128 ? 128 : HD;   // head columns a chunk
  static constexpr int PARTS = HD / HDP;            // chunks of K (of V)
  static constexpr int CHUNKS = 2 * PARTS;          // a tile's: K, then V
  static constexpr int KP = HDP + 4;                // f32 pitch, K/V rows
  static constexpr int QP = HD + 4;                 // f32 pitch, Q rows
  static constexpr int KWS = 64 / ROWS;             // warps on one row group
  static constexpr int KW = TK / KWS;               // a warp's keys a tile
  static constexpr int NJ = KW / 8;                 // a lane's keys a tile
  static constexpr int PT = 16 + 4;                 // pitch, a key's P
  static constexpr int MP = HD + 4;                 // pitch, parked acc rows
  static constexpr int G = HD / 4;                  // 16-byte groups a row
  static constexpr int GP = HDP / 4;                // ... a chunk's row
  static constexpr int NG = (G + 7) / 8;            // a lane's groups
  static constexpr int NGP = (GP + 7) / 8;          // ... of a chunk
  static constexpr size_t Q_BYTES = sizeof(float) * ROWS * QP;
  static constexpr size_t P_BYTES = sizeof(float) * 4 * KW * PT;
  static constexpr size_t W_BYTES = BYTE ? sizeof(float) * 4 * 16 * KP : 0;
  // a chunk slot: 64 rows of HDP f32 (pitch KP), or of HDP bytes
  // (unpadded: the conversion reads consecutive words) and, for int8,
  // the 64 rows' f32 scales
  static constexpr size_t SLOT =
      BYTE ? (size_t)TK * HDP + (Q8 ? sizeof(float) * TK : 0)
           : sizeof(float) * TK * KP;
  static constexpr size_t MERGE =
      KWS > 1 ? sizeof(float) * 4 * 16 * (2 + MP) : 0;
  static constexpr size_t REGION = cmax((size_t)NS * SLOT, MERGE);
  static constexpr size_t SMEM = Q_BYTES + P_BYTES + W_BYTES + REGION;
  static_assert(HD % 16 == 0 && HD % HDP == 0, "head dim");
  static_assert(PARTS == 1 || GP % 8 == 0, "whole groups a lane a chunk");
  static_assert(ROWS == 16 || ROWS == 64, "16 or 64 rows a block");
  static_assert(!(BYTE && ROWS == 64), "byte pages: 16-row blocks only");
  static_assert(NS >= 2, "the ring needs two slots");
  static_assert(SLOT % 16 == 0 && (KP / 4) % 2 == 1 && (PT / 4) % 2 == 1 &&
                    (MP / 4) % 2 == 1,
                "16-byte rows on distinct banks");
  static_assert(SMEM <= SMEM_MAX, "over the SM's 227 KB");
};

// Ring slots of instance (P, HD, ROWS): byte pages' chunks are small, so
// six; f32 chunks four in 16-row blocks (at hd 256, 34 KB each), two in
// 64-row blocks, whose blocks are many: a smaller block puts three on an
// SM at hd 64.
template <typename P, int HD, int ROWS>
__host__ __device__ constexpr int stages() {
  return sizeof(P) == 1 ? 6 : ROWS == 64 ? 2 : HD > 128 ? 4 : 3;
}

// Blocks an SM should hold (__launch_bounds__): three 64-row blocks at
// hd 64 (168 registers a thread: their shared memory allows three), else
// one, which leaves ptxas every register it wants (at hd 80 and 96 a cap
// of 168 spilled; the 16-row blocks' registers hold a lane's O slice,
// 128 of them at hd 256).
template <int HD, int ROWS>
__host__ __device__ constexpr int min_blocks() {
  return ROWS == 64 && HD == 64 ? 3 : 1;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// o += p * v, four lanes of a 16-byte group.
__device__ __forceinline__ void fma4(float4& o, float p, const float4& v) {
  o.x = fmaf(p, v.x, o.x);
  o.y = fmaf(p, v.y, o.y);
  o.z = fmaf(p, v.z, o.z);
  o.w = fmaf(p, v.w, o.w);
}

// Four byte-wide values of a slot row as f32: int8 codes times the
// token's scale (one f32 product each, as the plain version's), e4m3
// values exactly (e4m3 -> f16 -> f32).
__device__ __forceinline__ float4 decode4(uint32_t w, const int8_t*,
                                          float sc) {
  return make_float4((float)(int8_t)(w & 0xff) * sc,
                     (float)(int8_t)((w >> 8) & 0xff) * sc,
                     (float)(int8_t)((w >> 16) & 0xff) * sc,
                     (float)(int8_t)(w >> 24) * sc);
}
__device__ __forceinline__ float4 decode4(uint32_t w, const __nv_fp8_e4m3*,
                                          float) {
  const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(w & 0xffff), __NV_E4M3);
  const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&lo));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&hi));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The block's arguments: q and out in the projection layout [b, chunk,
// nh, hd] (out written there too), the K/V element arrays (token row r's
// HD values at r * HD) and, for int8, their f32 scales (at r), the ALiBi
// slopes [nh] or null; kv head h, batch row bi, regrouped rows [row0,
// row0 + ROWS) of `rows`; a row's position is qstart + row / g, and it
// attends to keys at or before it, at or past `kstart` and below
// `bound`.  vec16: the K/V arrays are 16-byte aligned (else f32 K/V rows
// come by 4-byte copies).  With part_acc set (16-row blocks only), the
// block writes regrouped row r's unnormalised partial to part_acc[(part_row
// + r) * HD ..], part_m and part_l[part_row + r] instead of out.
template <typename P>
struct Args {
  const float* q;
  float* out;
  const P* k;
  const float* ksc;
  const P* v;
  const float* vsc;
  const float* slopes;
  int g, rows, chunk, nh, h, bi, row0, qstart, bound;
  float scale;
  bool vec16;
  int kstart = 0;
  float* part_acc = nullptr;
  float* part_m = nullptr;
  float* part_l = nullptr;
  size_t part_row = 0;
};

// The sum (or max) over the eight lanes of a row group.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

// One warp's online-softmax step over its slice of tile keys [kbase,
// kbase + 8 NJ): lane (gid, tig) holds the scores of rows gid + 4 i and
// keys kbase + tig + 8 j.  In the log2 domain: the scores times log2 e,
// ALiBi (slopes times log2 e), the mask where the slice is not wholly
// below both bounds (key < kend and key <= the row's position); the
// running max m, this lane's share of the sum l and the accumulator
// rescaled; the probabilities (masked: exactly 0) into the warp's P tile,
// a key's four values of this lane's rows in one 16-byte store.
template <int NJ, int NG>
__device__ __forceinline__ void softmax_step(
    float (&s)[4][NJ], int kbase, int kend, int wfirst,
    const int (&qpos)[4], const float (&slope2)[4], float (&m)[4],
    float (&l)[4], float4 (&acc)[4][NG], float* ps) {
  constexpr int PT = 16 + 4;
  const int lane = threadIdx.x & 31, gid = lane >> 3, tig = lane & 7;
  const bool masked =
      !(kbase + 8 * NJ <= kend && kbase + 8 * NJ - 1 <= wfirst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int key = kbase + tig + 8 * j;
      float v = s[i][j] * LOG2E - slope2[i] * (float)(qpos[i] - key);
      if (masked && !(key < kend && key <= qpos[i])) v = NEG;
      s[i][j] = v;
      mx = fmaxf(mx, v);
    }
    const float m_new = fmaxf(m[i], row_max(mx));
    const float alpha = exp2f(m[i] - m_new);
    l[i] *= alpha;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      acc[i][j].x *= alpha;
      acc[i][j].y *= alpha;
      acc[i][j].z *= alpha;
      acc[i][j].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      // a masked score is NEG: exactly 0, never exp2(0) where m is NEG
      const float pr = s[i][j] > 0.5f * NEG ? exp2f(s[i][j] - m_new) : 0.f;
      l[i] += pr;
      s[i][j] = pr;
    }
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    *reinterpret_cast<float4*>(ps + (tig + 8 * j) * PT + 4 * gid) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  __syncwarp();   // P comes from the whole warp
}

// f(std::integral_constant<int, 0>{}), ..., f(... N - 1 ...): a loop
// whose index is a constant in each call.
template <typename F, int... Is>
__device__ __forceinline__ void each(F&& f, std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}

// The whole block.  row_of(t0, kend) is this thread's key row of the
// tile at position t0 (position t0 + threadIdx.x / 2) as a token row of
// the K/V arrays, or -1 at or past kend.
template <typename P, int HD, int ROWS, int NS, typename RowOf>
__device__ __forceinline__ void run(const Args<P>& a, char* smem,
                                    const RowOf& row_of) {
  using I = Inst<P, HD, ROWS, NS>;
  constexpr int HDP = I::HDP, PARTS = I::PARTS, CHUNKS = I::CHUNKS,
                KP = I::KP, QP = I::QP, KWS = I::KWS, KW = I::KW,
                NJ = I::NJ, PT = I::PT, G = I::G, GP = I::GP, NG = I::NG,
                NGP = I::NGP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 3, tig = lane & 7;
  const int rw = warp / KWS, kw = warp - rw * KWS;
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + I::Q_BYTES) + warp * KW * PT;
  float* ws = reinterpret_cast<float*>(smem + I::Q_BYTES + I::P_BYTES) +
              warp * 16 * KP;
  char* ring = smem + I::Q_BYTES + I::P_BYTES + I::W_BYTES;

  const int g = a.g;
  auto offset = [&](int row) {   // regrouped row -> q / out element offset
    const int t = row / g, m = row - t * g;
    return (((size_t)a.bi * a.chunk + t) * a.nh + (size_t)a.h * g + m) * HD;
  };
  // the block's causal frontier: tiles past it are never copied
  const int last_row = min(a.row0 + ROWS, a.rows) - 1;
  const int kv_end = max(0, min(a.bound, a.qstart + last_row / g + 1));
  const int ntiles = max(0, kv_end - a.kstart + TK - 1) / TK;
  const int nchunks = ntiles * CHUNKS;

  // chunk c (tile c / CHUNKS; parts 0 .. PARTS - 1 of K, then of V) into
  // slot c % NS: this thread's half of key row tid / 2
  int cur_t = -1;
  long long cur_row = -1,
            nxt_row = ntiles > 0 ? row_of(a.kstart, kv_end) : -1;
  auto issue = [&](int c) {
    const int t = c / CHUNKS, p = c - t * CHUNKS;
    if (t != cur_t) {   // chunks go out in order: the next tile's row
      cur_t = t;
      cur_row = nxt_row;
      nxt_row =
          t + 1 < ntiles ? row_of(a.kstart + (t + 1) * TK, kv_end) : -1;
    }
    const bool isv = p >= PARTS;
    const P* base = isv ? a.v : a.k;
    char* slot = ring + (size_t)(c % NS) * I::SLOT;
    const int r = tid >> 1, half = tid & 1;
    const bool ok = cur_row >= 0;
    const size_t src =
        ok ? (size_t)cur_row * HD + (isv ? p - PARTS : p) * HDP : 0;
    if constexpr (I::BYTE) {
      P* dst = reinterpret_cast<P*>(slot) + r * HDP;
#pragma unroll
      for (int c2 = half; c2 < HDP / 16; c2 += 2)
        hopper_tile::cp_async16(dst + 16 * c2, base + src + 16 * c2, ok);
      if constexpr (I::Q8) {
        if (half == 0)
          hopper_tile::cp_async4(
              reinterpret_cast<float*>(slot + TK * HDP) + r,
              (isv ? a.vsc : a.ksc) + (ok ? cur_row : 0), ok);
      }
    } else {
      float* dst = reinterpret_cast<float*>(slot) + r * KP;
      if (a.vec16) {
#pragma unroll
        for (int c2 = half; c2 < HDP / 4; c2 += 2)
          hopper_tile::cp_async16(dst + 4 * c2, base + src + 4 * c2, ok);
      } else {
#pragma unroll
        for (int c2 = half; c2 < HDP / 4; c2 += 2)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hopper_tile::cp_async4(dst + 4 * c2 + e, base + src + 4 * c2 + e,
                                   ok);
      }
    }
  };

  // the prologue: NS - 1 chunks in flight while Q lands
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nchunks) issue(c);
    hopper_tile::cp_async_commit();
  }
  // Q, scaled by 1/sqrt(hd) in f32; rows past the chunk are 0
  for (int i = tid; i < ROWS * HD; i += NT) {
    const int r = i / HD, d = i - r * HD;
    const int row = a.row0 + r;
    qs[r * QP + d] = row < a.rows ? a.q[offset(row) + d] * a.scale : 0.f;
  }

  // this lane's rows gid + 4 i of its warp's 16: positions, slopes (log2
  // domain)
  const int wr0 = a.row0 + rw * 16;
  int qpos[4];
  float slope2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = wr0 + gid + 4 * i;
    const int t = row / g;
    qpos[i] = a.qstart + t;
    slope2[i] =
        a.slopes != nullptr ? a.slopes[a.h * g + row - t * g] * LOG2E : 0.f;
  }
  // the warp's frontier (its last real row's position + 1), and its
  // lowest position: a slice wholly at or below it needs no mask
  const int wlast = min(wr0 + 15, a.rows - 1);
  const int wend = wlast >= wr0 ? min(a.qstart + wlast / g + 1, kv_end) : 0;
  const int wfirst = a.qstart + wr0 / g;

  float m[4], l[4];
  float4 acc[4][NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float s[4][NJ];

  const float* q0 = qs + (rw * 16 + gid) * QP;
  for (int t = 0; t < ntiles; ++t) {
    const int kbase = a.kstart + t * TK + kw * KW;   // the slice's row 0
    const bool active = kbase < wend;     // warp-uniform
    each([&](auto pc) {
      constexpr int p = decltype(pc)::value;
      const int c = t * CHUNKS + p;
      hopper_tile::cp_async_wait<NS - 2>();   // chunk c has landed
      __syncthreads();   // ... for every thread; slot c - 1 is free
      if (c + NS - 1 < nchunks) issue(c + NS - 1);
      hopper_tile::cp_async_commit();         // (empty past the last)
      if (!active) return;
      const char* slot = ring + (size_t)(c % NS) * I::SLOT;
      // the warp's KW key rows of the chunk as f32, pitch KP
      const float* kv;
      if constexpr (I::BYTE) {
        const P* raw = reinterpret_cast<const P*>(slot) + kw * KW * HDP;
        const float* sc =
            reinterpret_cast<const float*>(slot + TK * HDP) + kw * KW;
#pragma unroll
        for (int i = lane; i < KW * GP; i += 32) {
          const int r = i / GP, c4 = i - r * GP;
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(raw + r * HDP + 4 * c4);
          *reinterpret_cast<float4*>(ws + r * KP + 4 * c4) =
              decode4(w, raw, I::Q8 ? sc[r] : 0.f);
        }
        __syncwarp();
        kv = ws;
      } else {
        kv = reinterpret_cast<const float*>(slot) + kw * KW * KP;
      }

      if constexpr (p < PARTS) {
        // S += Q K^T over this chunk's head columns
        if constexpr (p == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
        }
        const float* qa = q0 + p * HDP;
        const float* kr = kv + tig * KP;
#pragma unroll 2
        for (int d = 0; d < HDP; d += 4) {
          float4 x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = ld4(qa + 4 * i * QP + d);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 k = ld4(kr + 8 * j * KP + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s[i][j] = fmaf(x[i].x, k.x, s[i][j]);
              s[i][j] = fmaf(x[i].y, k.y, s[i][j]);
              s[i][j] = fmaf(x[i].z, k.z, s[i][j]);
              s[i][j] = fmaf(x[i].w, k.w, s[i][j]);
            }
          }
        }
        if constexpr (p == PARTS - 1)
          softmax_step<NJ, NG>(s, kbase, kv_end, wfirst, qpos, slope2, m, l,
                               acc, ps);
      } else {
        // O[:, this chunk's groups] += P V, the slice's keys in order
        constexpr int J0 = (p - PARTS) * NGP;
        const float* pa = ps + 4 * gid;
        const float* vr = kv + 4 * tig;
#pragma unroll 4
        for (int k = 0; k < KW; ++k) {
          const float4 pk = ld4(pa + k * PT);
          const float* row = vr + k * KP;
#pragma unroll
          for (int j = 0; j < NGP; ++j) {
            if (GP % 8 != 0 && tig + 8 * j >= GP) continue;   // hd 80
            const float4 vv = ld4(row + 32 * j);
            fma4(acc[0][J0 + j], pk.x, vv);
            fma4(acc[1][J0 + j], pk.y, vv);
            fma4(acc[2][J0 + j], pk.z, vv);
            fma4(acc[3][J0 + j], pk.w, vv);
          }
        }
      }
    }, std::make_integer_sequence<int, CHUNKS>{});
  }
  hopper_tile::cp_async_wait<0>();   // (nothing left in flight)
  __syncthreads();                   // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = row_sum(l[i]);

  if constexpr (KWS == 1) {
    // each warp normalises and stores its own 16 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wr0 + gid + 4 * i;
      if (row >= a.rows) continue;
      const float den = fmaxf(l[i], 1e-30f);
      float* o = a.out + offset(row) + 4 * tig;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (G % 8 != 0 && tig + 8 * j >= G) continue;
        *reinterpret_cast<float4*>(o + 32 * j) =
            make_float4(acc[i][j].x / den, acc[i][j].y / den,
                        acc[i][j].z / den, acc[i][j].w / den);
      }
    }
  } else {
    // park the four warps' states in the ring, then merge each row in
    // warp order: thread (row r, group c) makes 4 outputs, one store
    constexpr int MP = I::MP;
    float* wm = reinterpret_cast<float*>(ring);
    float* wl = wm + 4 * 16;
    float* wo = wl + 4 * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + gid + 4 * i;
      if (tig == 0) {
        wm[r] = m[i];
        wl[r] = l[i];
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (G % 8 != 0 && tig + 8 * j >= G) continue;
        *reinterpret_cast<float4*>(wo + r * MP + 32 * j + 4 * tig) =
            acc[i][j];
      }
    }
    __syncthreads();
    for (int i = tid; i < 16 * G; i += NT) {
      const int rr = i / G, c4 = i - rr * G;
      if (a.row0 + rr >= a.rows) break;
      float mm = NEG;
#pragma unroll
      for (int w = 0; w < 4; ++w) mm = fmaxf(mm, wm[w * 16 + rr]);
      float ll = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float e = exp2f(wm[w * 16 + rr] - mm);
        ll += wl[w * 16 + rr] * e;
        fma4(o, e, ld4(wo + (w * 16 + rr) * MP + 4 * c4));
      }
      if (a.part_acc != nullptr) {   // a split's partial, unnormalised
        const size_t pr = a.part_row + a.row0 + rr;
        *reinterpret_cast<float4*>(a.part_acc + pr * HD + 4 * c4) = o;
        if (c4 == 0) {
          a.part_m[pr] = mm;
          a.part_l[pr] = ll;
        }
        continue;
      }
      const float den = fmaxf(ll, 1e-30f);
      *reinterpret_cast<float4*>(a.out + offset(a.row0 + rr) + 4 * c4) =
          make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
    }
  }
}

}  // namespace f32_tile
