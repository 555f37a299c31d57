// Dense-cache causal GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// distributed_inference_demo_tpu/ops/flash_attention.py::_kernel (grid
// (b, nkv, row blocks, kv blocks) with VMEM scratch carried along the
// sequential kv axis).  It computes the same function: for kv head h,
// query row r of the regrouped [chunk*g] rows is the query at position
// q_start + r/g of q head h*g + r%g, and it attends to every cache column
// s with s <= q_start + r/g and s < kv_len, with an optional ALiBi bias
// -slope * (q_pos - s), an f32 online softmax (scale 1/sqrt(hd), masked
// scores -1e30, masked probabilities exactly 0) and a final division by
// max(l, 1e-30).  Queries are read from the projection layout
// [b, chunk, nh, hd] and the output is written in it, so the wrapper does
// no regroup transpose.
//
// What bounds it on the H100.  The work is 4*nh*hd operations per
// (query, live key) pair over the bytes of q, out and the live K/V
// prefix, each moved once.  At the serve prefill (b=1, a 64-token chunk
// from position 0, TinyLlama's 32/4 heads, hd 64) that is ~17 MFLOP over
// ~590 KB, ~29 operations per byte against the card's ~295 bf16
// operations per byte: bound by bytes, at 0.18 us, so what is left is
// latency.  Once queries see a few hundred live keys it turns to
// operations: the longest plain-serve prompt (2048 tokens from 0) is
// 17.2 GFLOP over 18.9 MB, bound at 17.4 us by the tensor cores' rate.
//
// Design of the bf16-q instances.  A block of four warps owns ROWS
// regrouped rows of one (kv head, batch row) and streams that pair's K/V
// in 64-key tiles up to its causal frontier min(kv_len, q_start +
// last_row/g + 1): tiles past it are never copied, and the diagonal tile
// is masked per row.  Two instances, because no one tile fits both
// shapes above:
// - ROWS = 16: the four warps share the block's 16 rows and each takes
//   fixed 16-key slices of every tile with its own running (m, l, acc);
//   the four merge in shared memory in warp order.  At the serve prefill
//   (512 rows per kv head) this gives 128 blocks where 64-row blocks give
//   32, and every block sees one tile: the time is the serial chain
//   copy -> S -> softmax -> P V -> merge -> store, and 4x the blocks cut
//   each block's share of it.
// - ROWS = 64: each warp owns 16 rows and walks every key (as
//   flash-attention 2), so one K/V tile in shared memory feeds 64 rows.
//   On long prompts 16-row blocks would each re-read their whole K/V
//   prefix from L2 (~1 GB of L2 traffic at 2048 tokens against ~0.25 GB).
// The wrapper picks the instance (flash_rows_per_block in
// ops/flash_attention.py): 64 rows when those blocks alone fill one wave
// of the card's SMs, else 16.  Far from that line one instance wins by
// 1.4-2.4x; near it the two are within ~20% and either may win (a
// partly filled last 64-row block walks the longest prefix with one
// warp).  Row blocks are launched heaviest first (last rows, longest
// prefixes), so the causal tail is short.
// - Copies: K/V tiles arrive by 16-byte cp.async into a ring of stages
//   (row pitch padded by 16 bytes: the 8 rows one ldmatrix reads sit on
//   distinct banks); the ring keeps the next tiles' copies in flight
//   beside tile t's math, one barrier per tile.  Q's 16-byte copies go
//   out in the same group as the first tile's, so their latencies
//   overlap; Q then moves into m16n8k16 A fragments by ldmatrix once.
// - Head dims: an instance for each head dim of the catalog's models (64,
//   80, 96, 128, 256).  At 256 a warp's f32 accumulator alone takes 128
//   registers a lane, so Q's fragments stay in the Q tile and are read by
//   ldmatrix at each k step (QFrags, hopper_tile.cuh), the 64-row
//   instance's warps take each tile in two 32-key steps, and a stage is
//   66 KB, so the 16-row instance's ring has three stages there, not four.
// - Math: S = Q K^T and O += P V on mma.sync.m16n8k16 with bf16 operands
//   (ldmatrix / ldmatrix.trans for K and V) and f32 accumulation.  The
//   scale, ALiBi, the masks and the online softmax run in f32 on the
//   accumulator layout in the log2 domain; a warp's slice wholly below
//   its rows' positions skips the mask.  P is rounded to bf16 in
//   registers as P V's A operand, as in the paged kernels (the TPU
//   kernel's f32 dots at default precision run in bf16 passes too).
// - Output: normalised in f32, rounded once to bf16, staged in shared
//   memory and stored in 16-byte pieces.
// Why no wgmma or TMA yet: wgmma wants a 64-row warpgroup tile fed from
// shared memory with a producer/consumer split, which the 16-row
// instance cannot use and which only pays at the long shape's operation
// bound; at the serve shape the kernel is bound by latency, not by the
// tensor cores' rate.  A tile per (kv head, row) plane is a plain strided
// copy that cp.async does without TMA descriptors.  Both are the next
// step for the 64-row instance, which on long prompts is well short of
// its operation bound.
//
// Design of the f32-q instances (flash_f32_kernel<HD, ROWS>, the tile of
// f32_tile.cuh, shared with the paged prefill kernel).  They serve the
// f32 configurations and the f32 cross-checks of the serving paths, which
// hold f32 streams token for token, so the math stays full f32 FFMA on
// the CUDA cores (no TF32): the card's 67 TFLOP/s of f32 bounds them past
// a few hundred keys a row, and at the serving chunk (64 tokens from 0)
// they are bound by latency like the bf16 instances.  So the same shape:
// 16-row blocks whose four warps take fixed 16-key slices of every tile
// (128 blocks at the serving chunk where 64-row blocks give 32), a
// 64-row instance (up to hd 128) once its blocks fill one and a half
// waves of the card, K/V by
// 16-byte cp.async into a ring of chunk slots beside the math, register
// micro-tiles of S and O fed by 16-byte shared-memory reads, the online
// softmax in the log2 domain; a row's output depends on its own keys
// only (fixed key slices, merge in warp order).  An f32 cache that is
// only 4-byte aligned comes by 4-byte copies.
//
// Plain C interface, loaded with ctypes: the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "f32_tile.cuh"
#include "hopper_tile.cuh"

namespace {

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------
// The f32-q instances: CUDA cores, cp.async ring (f32_tile.cuh)

// One block: ROWS regrouped rows of (kv head h, batch row bi) over the
// dense plane of that pair.  The grid is one-dimensional, nrb row blocks
// x nkv x b, the last row block (the longest prefix) first.
template <int HD, int ROWS>
__global__ void __launch_bounds__(f32_tile::NT,
                                  (f32_tile::min_blocks<HD, ROWS>()))
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ slopes, float* __restrict__ out,
                 int chunk, int nh, int nkv, int max_seq, int q_start,
                 int kv_len, int nrb, float scale, bool vec16) {
  extern __shared__ __align__(16) char f32_tiles[];
  const int g = nh / nkv;
  const int planes = (int)gridDim.x / nrb;       // nkv * b
  const int lin = (int)blockIdx.x;
  const int rb = nrb - 1 - lin / planes;
  const int h = lin % planes % nkv, bi = lin % planes / nkv;
  const f32_tile::Args<float> a{q, out, k, nullptr, v, nullptr, slopes, g,
                                chunk * g, chunk, nh, h, bi, rb * ROWS,
                                q_start, kv_len, scale, vec16};
  // token row of position pos: the (bi, h) plane's row pos
  const long long plane = ((long long)bi * nkv + h) * max_seq;
  f32_tile::run<float, HD, ROWS, f32_tile::stages<float, HD, ROWS>()>(
      a, f32_tiles, [&](int t0, int kend) -> long long {
        const int pos = t0 + (int)(threadIdx.x >> 1);
        return pos < kend ? plane + pos : -1;
      });
}

// ---------------------------------------------------------------------
// The bf16-q instances: tensor cores, cp.async ring

using hopper_tile::cp_async16;
using hopper_tile::mma_bf16;
using hopper_tile::pack_bf16;
using hopper_tile::QFrags;
using bf16 = __nv_bfloat16;

constexpr int TK = 64;         // keys per K/V tile
constexpr int T_NT = 128;      // four warps
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of instance (HD, ROWS): the Q tile [ROWS][PITCH] bf16
// (later the output tile), then a ring of NS stages, each a K and a V
// tile [TK][PITCH] bf16, which the 16-row instance reuses at the end for
// the four warps' states (m, l [4][16] and acc [4][16][HD + 8] f32).
// PITCH adds 16 bytes to a row: every row stays 16-byte aligned for
// cp.async, and the 8 rows one ldmatrix reads fall on distinct banks.
// Ring depth: the 16-row instance keeps three tiles' copies in flight
// beside the one it computes where four stages fit (two at hd 256, whose
// 66 KB stages fit three times); the 64-row instance, whose blocks do 4x
// the math per tile, double-buffers, and at hd 64 its registers are
// capped (MIN_BLOCKS) so that three blocks share an SM (one or two at the
// other head dims, where the cap would spill): on the card this beat
// deeper rings and the uncapped kernel at the long shapes (PERF.md).
template <int HD, int ROWS>
struct Inst {
  static constexpr int PITCH = HD + 8;
  static constexpr int KWS = 64 / ROWS;    // warps sharing a row group
  static constexpr int KW = TK / KWS;      // keys of a tile per warp
  // keys per online-softmax step: at hd 256 the 64-row instance takes
  // its 64 keys in two steps (a 64-key step's scores beside the 128
  // accumulator registers spilled)
  static constexpr int KS = HD > 128 && KW > 32 ? 32 : KW;
  static constexpr int MIN_BLOCKS = ROWS == 64 && HD == 64 ? 3 : 1;
  static constexpr size_t Q_BYTES = (size_t)ROWS * PITCH * sizeof(bf16);
  static constexpr size_t TILE = (size_t)TK * PITCH * sizeof(bf16);
  static constexpr size_t STAGE = 2 * TILE;
  static constexpr int FIT = (int)((232448 - Q_BYTES) / STAGE);
  static constexpr int NS = ROWS == 16 ? (FIT < 4 ? FIT : 4) : 2;
  static constexpr int WOP = HD + 8;       // f32 pitch of a parked acc row
  static constexpr size_t MERGE = sizeof(float) * 4 * 16 * (2 + WOP);
  static constexpr size_t RING =
      KWS > 1 && MERGE > NS * STAGE ? MERGE : NS * STAGE;
  static constexpr size_t SMEM = Q_BYTES + RING;
  static_assert(ROWS == 16 || ROWS == 64, "16 or 64 rows per block");
  static_assert(NS >= 2, "the ring needs two stages");
  static_assert(SMEM <= 232448, "over the SM's 227 KB");
};

// This thread's 16-byte pieces of K/V rows [t0, t0 + TK) of the
// (batch row, kv head) plane into a stage, consecutive threads on
// consecutive pieces; rows at or past kend are zero-filled, unread, so
// their products stay finite (their probabilities are exactly 0).
template <int HD, int PITCH>
__device__ __forceinline__ void issue_kv(bf16* ks, bf16* vs,
                                         const bf16* __restrict__ kp,
                                         const bf16* __restrict__ vp,
                                         int t0, int kend) {
  constexpr int CH = HD / 8;                 // pieces per row
  static_assert(TK * CH % T_NT == 0, "whole pieces per thread");
#pragma unroll
  for (int j = 0; j < TK * CH / T_NT; ++j) {
    const int i = threadIdx.x + j * T_NT;
    const int r = i / CH, c = i % CH;
    const bool ok = t0 + r < kend;
    const size_t src = ok ? (size_t)(t0 + r) * HD + c * 8 : 0;
    cp_async16(ks + r * PITCH + c * 8, kp + src, ok);
    cp_async16(vs + r * PITCH + c * 8, vp + src, ok);
  }
}

// The block's Q rows [row0, row0 + ROWS) from the projection layout into
// shared memory; rows past the chunk are zero-filled.  The last round of
// pieces is partial where ROWS * HD / 8 is not a multiple of the block's
// threads (16 rows at hd 80 and 96).
template <int HD, int ROWS, int PITCH>
__device__ __forceinline__ void issue_q(bf16* qs, const bf16* __restrict__ q,
                                        int bi, int h, int row0, int rows,
                                        int g, int chunk, int nh) {
  constexpr int CH = HD / 8;
  constexpr int N = ROWS * CH;               // pieces of the tile
#pragma unroll
  for (int j = 0; j < (N + T_NT - 1) / T_NT; ++j) {
    const int i = threadIdx.x + j * T_NT;
    if (N % T_NT != 0 && i >= N) break;
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    size_t src = 0;
    if (row < rows) {
      const int t = row / g, m = row - t * g;
      src = (((size_t)bi * chunk + t) * nh + (size_t)h * g + m) * HD + c * 8;
    }
    cp_async16(qs + r * PITCH + c * 8, q + src, row < rows);
  }
}

// One warp's online-softmax step over the KW keys at tile rows
// [kb, kb + KW) of the tile at position t0: S = Q K^T for its 16 rows
// (K by ldmatrix: B[d][n] = K[n][d]); in f32 the scale, ALiBi and, where
// MASKED, the mask (key < kend and key <= the row's position), in the
// log2 domain (sl2 = scale * log2 e, the slopes times log2 e), so
// exp2f(s - m) is the softmax's exp(s - m); the running max m and this
// lane's share of the sum l for rows gid and gid + 8; then O += P V with
// P rounded to bf16 in registers (V by ldmatrix.trans).
template <int HD, int PITCH, int KW, bool MASKED>
__device__ __forceinline__ void attend(const bf16* ks, const bf16* vs,
                                       const QFrags<HD, PITCH>& qf,
                                       int kb, int t0, float sl2, int kend,
                                       const int (&qpos)[2],
                                       const float (&slope2)[2],
                                       float (&m)[2], float (&l)[2],
                                       float (&o)[HD / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  float s[KW / 8][4];
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // K: b[0], b[1] for keys key .. key + 7, b[2], b[3] for key + 8 .. + 15
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    qf.get(kk, a);
#pragma unroll
    for (int jj = 0; jj < KW / 16; ++jj) {
      uint32_t b[4];
      hopper_tile::ldmatrix_x4(
          b, ks + (kb + 16 * jj + krow) * PITCH + kk * 16 + kcol);
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
      const int key = t0 + kb + 8 * j + 2 * tig + (e & 1);
      float v = s[j][e] * sl2 - slope2[hr] * (float)(qpos[hr] - key);
      if constexpr (MASKED) {
        const bool ok = key < kend && key <= qpos[hr];
        v = ok ? v : NEG;
        valid |= (ok ? 1u : 0u) << (j * 4 + e);
      }
      s[j][e] = v;
      mx[hr] = fmaxf(mx[hr], v);
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
      float p = exp2f(s[j][e] - m[hr]);
      if constexpr (MASKED) p = (valid >> (j * 4 + e)) & 1u ? p : 0.f;
      l[hr] += p;
      s[j][e] = p;
    }
  // V: b[0], b[1] for columns d .. d + 7, b[2], b[3] for d + 8 .. + 15
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vcol = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      uint32_t b[4];
      hopper_tile::ldmatrix_x4_trans(
          b, vs + (kb + 16 * kk + vrow) * PITCH + 16 * nn + vcol);
      mma_bf16(o[2 * nn], pa, b[0], b[1]);
      mma_bf16(o[2 * nn + 1], pa, b[2], b[3]);
    }
  }
}

// Row `row` of the regrouped rows: its offset in q / out [b, chunk, nh,
// HD].
__device__ __forceinline__ size_t row_offset(int row, int bi, int h, int g,
                                             int chunk, int nh, int hd) {
  const int t = row / g, m = row - t * g;
  return (((size_t)bi * chunk + t) * nh + (size_t)h * g + m) * hd;
}

// One block: ROWS regrouped rows of (kv head h, batch row bi).  The grid
// is one-dimensional, nrb row blocks x nkv x b, the last row block (the
// longest prefix) first.
template <int HD, int ROWS>
__global__ void __launch_bounds__(T_NT, (Inst<HD, ROWS>::MIN_BLOCKS))
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const float* __restrict__ slopes, bf16* __restrict__ out,
                 int chunk, int nh, int nkv, int max_seq, int q_start,
                 int kv_len, int nrb, float scale) {
  using I = Inst<HD, ROWS>;
  constexpr int PITCH = I::PITCH, KWS = I::KWS, KW = I::KW, KS = I::KS,
                NS = I::NS;
  extern __shared__ __align__(16) char tiles[];
  bf16* qs = reinterpret_cast<bf16*>(tiles);
  char* ring = tiles + I::Q_BYTES;

  const int g = nh / nkv;
  const int rows = chunk * g;
  const int planes = (int)gridDim.x / nrb;       // nkv * b
  const int lin = (int)blockIdx.x;
  const int rb = nrb - 1 - lin / planes;
  const int h = lin % planes % nkv, bi = lin % planes / nkv;
  const int row0 = rb * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rw = warp / KWS, kw = warp - rw * KWS;

  // the block's causal frontier: tiles past it are never copied
  const int last_row = min(row0 + ROWS, rows) - 1;
  const int kv_end = max(0, min(kv_len, q_start + last_row / g + 1));
  const int ntiles = (kv_end + TK - 1) / TK;
  const size_t plane = ((size_t)bi * nkv + h) * (size_t)max_seq * HD;
  const bf16* kp = k + plane;
  const bf16* vp = v + plane;
  auto kst = [&](int s) {
    return reinterpret_cast<bf16*>(ring + (size_t)s * I::STAGE);
  };
  auto vst = [&](int s) {
    return reinterpret_cast<bf16*>(ring + (size_t)s * I::STAGE + I::TILE);
  };

  // the prologue: Q's copies in one group with the first tile's, then
  // the next NS - 2 tiles', all in flight at once
  issue_q<HD, ROWS, PITCH>(qs, q, bi, h, row0, rows, g, chunk, nh);
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) issue_kv<HD, PITCH>(kst(t), vst(t), kp, vp, t * TK, kv_end);
    hopper_tile::cp_async_commit();
  }

  // this warp's 16 rows: positions, ALiBi slopes (log2 domain), frontier
  const int wr0 = row0 + rw * 16;
  int qpos[2];
  float slope2[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wr0 + gid + 8 * hr;
    const int t = row / g;
    qpos[hr] = q_start + t;
    slope2[hr] = slopes != nullptr ? slopes[h * g + row - t * g] * LOG2E
                                   : 0.f;
  }
  const int wlast = min(wr0 + 15, rows - 1);
  const int wend = wlast >= wr0 ? min(q_start + wlast / g + 1, kv_end) : 0;
  const int wfirst = q_start + wr0 / g;   // the warp's lowest position
  const float sl2 = scale * LOG2E;
  QFrags<HD, PITCH> qf;
  qf.tile = qs + rw * 16 * PITCH;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // one barrier per tile: it publishes tile t (and, at t = 0, Q) and
  // frees the stage of tile t - 1, which takes tile t + NS - 1's copies
  for (int t = 0; t < ntiles; ++t) {
    hopper_tile::cp_async_wait<NS - 2>();
    __syncthreads();
    const int tn = t + NS - 1;
    if (tn < ntiles)
      issue_kv<HD, PITCH>(kst(tn % NS), vst(tn % NS), kp, vp, tn * TK,
                          kv_end);
    hopper_tile::cp_async_commit();        // (empty past the last tile)
    if (t == 0) qf.hold();
#pragma unroll
    for (int ks = 0; ks < KW; ks += KS) {
      const int k0 = t * TK + kw * KW + ks;  // this step's first key
      if (k0 < wend) {                       // warp-uniform
        if (k0 + KS <= kv_end && k0 + KS - 1 <= wfirst)
          attend<HD, PITCH, KS, false>(kst(t % NS), vst(t % NS), qf,
                                       kw * KW + ks, t * TK, sl2, kv_end,
                                       qpos, slope2, m, l, o);
        else
          attend<HD, PITCH, KS, true>(kst(t % NS), vst(t % NS), qf,
                                      kw * KW + ks, t * TK, sl2, kv_end,
                                      qpos, slope2, m, l, o);
      }
    }
  }
  hopper_tile::cp_async_wait<0>();   // (Q's copies, where there was no tile)
  __syncthreads();                   // every warp is done with Q and the ring
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {   // the row sums over the quad
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }

  constexpr int CH = HD / 8;         // 16-byte pieces of an output row
  if constexpr (KWS == 1) {
    // each warp normalises its own rows into its rows of the Q tile,
    // then stores them in 16-byte pieces
    bf16* ow = qs + rw * 16 * PITCH;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(ow + (gid + 8 * hr) * PITCH + 8 * n +
                                     2 * tig) =
            pack_bf16(o[n][2 * hr] / den, o[n][2 * hr + 1] / den);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      if (wr0 + r < rows)
        *reinterpret_cast<uint4*>(
            out + row_offset(wr0 + r, bi, h, g, chunk, nh, HD) + c * 8) =
            *reinterpret_cast<const uint4*>(ow + r * PITCH + c * 8);
    }
  } else {
    // park the four warps' states in the ring, then merge each row in
    // warp order: thread (row r, piece c) makes 8 outputs, one store
    constexpr int WOP = I::WOP;
    float* wm = reinterpret_cast<float*>(ring);
    float* wl = wm + 4 * 16;
    float* wo = wl + 4 * 16;
    const int r = warp * 16 + gid;
    if (tig == 0) {
      wm[r] = m[0];
      wm[r + 8] = m[1];
      wl[r] = l[0];
      wl[r + 8] = l[1];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(wo + r * WOP + 8 * n + 2 * tig) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(wo + (r + 8) * WOP + 8 * n + 2 * tig) =
          make_float2(o[n][2], o[n][3]);
    }
    __syncthreads();
#pragma unroll
    for (int i = tid; i < 16 * CH; i += T_NT) {
      const int rr = i / CH, c = i % CH;
      if (row0 + rr >= rows) continue;
      float mm = NEG;
#pragma unroll
      for (int w = 0; w < 4; ++w) mm = fmaxf(mm, wm[w * 16 + rr]);
      float ll = 0.f, acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float sc = exp2f(wm[w * 16 + rr] - mm);
        ll += wl[w * 16 + rr] * sc;
        const float* src = wo + (w * 16 + rr) * WOP + c * 8;
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        acc[0] += a.x * sc;
        acc[1] += a.y * sc;
        acc[2] += a.z * sc;
        acc[3] += a.w * sc;
        acc[4] += b.x * sc;
        acc[5] += b.y * sc;
        acc[6] += b.z * sc;
        acc[7] += b.w * sc;
      }
      const float den = fmaxf(ll, 1e-30f);
      const uint4 pk = {pack_bf16(acc[0] / den, acc[1] / den),
                        pack_bf16(acc[2] / den, acc[3] / den),
                        pack_bf16(acc[4] / den, acc[5] / den),
                        pack_bf16(acc[6] / den, acc[7] / den)};
      *reinterpret_cast<uint4*>(
          out + row_offset(row0 + rr, bi, h, g, chunk, nh, HD) + c * 8) = pk;
    }
  }
}

template <int HD, int ROWS>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* slopes, void* out, int b, int chunk,
                       int nh, int nkv, int max_seq, int q_start, int kv_len,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem =
      f32_tile::Inst<float, HD, ROWS,
                     f32_tile::stages<float, HD, ROWS>()>::SMEM;
  auto kern = flash_f32_kernel<HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)chunk * (nh / nkv);
  const long long nrb = (rows + ROWS - 1) / ROWS;
  const long long blocks = nrb * nkv * b;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, f32_tile::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), slopes, static_cast<float*>(out), chunk,
      nh, nkv, max_seq, q_start, kv_len, (int)nrb, scale,
      ((uintptr_t)k | (uintptr_t)v) % 16 == 0);
  return cudaGetLastError();
}

template <int HD, int ROWS>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* slopes, void* out, int b, int chunk,
                       int nh, int nkv, int max_seq, int q_start, int kv_len,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = Inst<HD, ROWS>::SMEM;
  auto kern = flash_mma_kernel<HD, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)chunk * (nh / nkv);
  const long long nrb = (rows + ROWS - 1) / ROWS;
  const long long blocks = nrb * nkv * b;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, T_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), slopes, static_cast<bf16*>(out), chunk,
      nh, nkv, max_seq, q_start, kv_len, (int)nrb, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
// slopes: [nh] float32 ALiBi slopes on the device, or null.
// rows_per_block: the instance, regrouped query rows per block: 16 or 64
// (bfloat16: 16-byte aligned q, caches and out; float32: 4-byte aligned
// q and caches, 16-byte aligned out, 64 rows up to hd 128).
// Returns a cudaError_t (cudaErrorInvalidValue for a shape, dtype, head
// dim or rows_per_block without an instance); the caller raises on
// anything but 0.
int flash_attention_fwd(const void* q, const void* k_cache,
                        const void* v_cache, const void* slopes, void* out,
                        int b, int chunk, int nh, int nkv, int hd,
                        int max_seq, int q_start, int kv_len, float scale,
                        int dtype, int rows_per_block, void* stream) {
  if (b <= 0 || chunk <= 0 || nkv <= 0 || nh % nkv != 0)
    return (int)cudaErrorInvalidValue;
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_F32(HD, ROWS)                                                 \
  return (int)launch_f32<HD, ROWS>(q, k_cache, v_cache, sl, out, b,      \
                                   chunk, nh, nkv, max_seq, q_start,     \
                                   kv_len, scale, st)
#define FA_MMA(HD, ROWS)                                                 \
  return (int)launch_mma<HD, ROWS>(q, k_cache, v_cache, sl, out, b,      \
                                   chunk, nh, nkv, max_seq, q_start,     \
                                   kv_len, scale, st)
  // the head dims of the catalog's models: 64 (llama, bloom-560m), 80
  // (bloom3b), 96 (bloom1b1), 128 (llama-3-8b, bloom7b1), 256 (gemma)
#define FA_HD(HD)                                                        \
  if (hd == HD) {                                                        \
    if (dtype == 0 && rows_per_block == 16) FA_F32(HD, 16);              \
    if (dtype == 1 && rows_per_block == 16) FA_MMA(HD, 16);              \
    if (dtype == 1 && rows_per_block == 64) FA_MMA(HD, 64);              \
  }
  // the f32 64-row instance: up to hd 128
  if (dtype == 0 && rows_per_block == 64) {
    if (hd == 64) FA_F32(64, 64);
    if (hd == 80) FA_F32(80, 64);
    if (hd == 96) FA_F32(96, 64);
    if (hd == 128) FA_F32(128, 64);
  }
  FA_HD(64)
  FA_HD(80)
  FA_HD(96)
  FA_HD(128)
  FA_HD(256)
#undef FA_HD
#undef FA_MMA
#undef FA_F32
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
