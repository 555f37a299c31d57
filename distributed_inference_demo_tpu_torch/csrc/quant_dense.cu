// Weight-only int8 / int4 dense product for Hopper (sm_90a):
// y[M, N] = x[M, K] . deq(W)[K, N], in x's dtype, f32 accumulation.
//
// No Pallas kernel computes this.  It is the counterpart of an XLA
// fusion: distributed_inference_demo_tpu/ops/quant.py::dense dequantizes
// a QuantizedArray / QuantizedArray4 to the activation dtype right at the
// einsum, and XLA fuses the unpack + convert + scale into the matmul's
// operand feed, so device memory sees only the quantized bytes.  PyTorch
// has no such fusion: w.dequantize() then a matmul writes a bf16 copy of
// every weight and reads it back.  Here the dequantized weight never
// leaves the SM.
//
// Weights, as the reference lays them out:
// - int8: q int8 [K, N], scale f32 [N] (per output channel);
// - int4: q uint8 [K/2, N], byte (k/2, n) holding k even in its low
//   nibble and k odd in its high one, each code offset by 8; scale f32
//   [K/group, N], with group a multiple of 64 (the reference's group is 64
//   wherever K >= 64), so every 32- or 64-row K step needs one scale row.
// Each element is dequantized exactly as the reference does it, f32(code)
// * scale, then rounded once to bf16 (round-to-nearest-even), so W's
// rounding is the plain version's and only the order of the sums differs.
// f32(code) is built with bit operations, not I2F: the byte or nibble
// goes into the low mantissa bits of 2^23 (prmt onto 0x4B000000) and one
// fsub removes 2^23 and the code's offset, exactly; pairs are packed with
// one cvt.rn.bf16x2.f32.
//
// Four kernels; the wrapper (ops/quant_dense.py) picks one by dtype and M.
//
// quant_dense_decode_kernel<BITS, NT8>: bf16 x, M <= 16 (decode: M = 1
// plain, M = 8 the 8-slot batch).  Every code byte feeds at most 32
// operations, far under the card's ~295 a byte, so bytes bound it: the
// design streams the codes at the card's bandwidth.
// - Swapped operands: y^T = deq(W)^T . x^T with mma.sync.m16n8k16.  W's
//   columns are the m16 side, x's rows the n8 side (NT8 = 1 tile up to 8
//   rows, 2 up to 16), so M = 1 pads to 8, not 16, and an output's k order
//   does not depend on M.
// - A lane (gid, tig) owns 16 neighbouring columns of the block's 128 and
//   k rows 4 tig .. 4 tig + 3 of each 16-row k step: m16 tile j's rows gid
//   and gid + 8 are its columns 2j and 2j + 1, and the tile's k pairs
//   (2 tig, 2 tig + 1), (2 tig + 8, 2 tig + 9) are its k rows (4 tig, +1),
//   (4 tig + 2, +3).  Any bijection of k within the step is a valid mma
//   as long as x's B fragments follow it: they are the 8 bytes
//   x[row][4 tig .. 4 tig + 3].  So a lane's A fragments come from its own
//   16-byte row chunks (int4: a byte's two nibbles are one k pair).
// - A warp-stage is 32 k rows: one TMA box of codes ([32][128] bytes
//   int8, [16][128] int4) into the warp's ring (3 deep int8, 4 int4),
//   completing on the slot's mbarrier, beside each lane's own cp.async of
//   its x (and int4 scale) chunks.  Boxes, not per-lane 16-byte copies:
//   on the H100, per-lane cp.async streamed this layout well below the
//   rate TMA boxes reach (about the rate of torch.matmul's bf16 GEMV over
//   the same layout), whatever the ring depth or tile width.  The lane
//   mapping reads four box rows an instruction, free of bank conflicts,
//   and dequantizes straight from the stage into A fragments: no W tile
//   in shared memory and no block barrier in the main loop (one
//   __syncwarp a stage).
// - The block's four warps take interleaved 32-row steps of the block's K
//   range and are summed in shared memory in warp order.  The K split
//   over blocks depends on (K, N, bits) and the SM count, never on M, so
//   a row's result is bit-equal at M = 1 and inside M = 8.
//
// quant_dense_prefill_kernel<BITS>: bf16 x, M > 16 (prefill chunks, the
// mixed slab).  Operations bound it from a few hundred rows; the design
// dequantizes each W tile once per 128 rows and multiplies with wgmma fed
// by TMA.
// - A 128 x 128 output tile a block, 64-row K steps; one producer warp
//   keeps TMA loads of x ([128, 64] bf16, K-major, 128-byte swizzle) and
//   of the raw code tile (and int4's scale row) in flight through a
//   7-stage mbarrier ring (a stage is refilled only once the products that
//   read its x tile are done, so the ring runs six steps ahead of them).
// - Two consumer warpgroups dequantize each stage once, together, into a
//   bf16 W tile in wgmma's MN-major 128-byte-swizzled layout (three such
//   tiles rotate, so the dequantization of step k+1 overlaps the
//   asynchronous wgmma of step k), then each issues wgmma.m64n128k16 over
//   its 64 rows (B's transpose bit set); a warpgroup whose rows are all
//   past M skips the product.
//
// The f32 kernels: f32 x (the f32 cross-checks of the -int8 / -int4
// configs), full f32 FFMA on the CUDA cores, no TF32, each element
// dequantized as the plain version does it, f32(code) * scale, in f32;
// split at M = 16 as the bf16 kernels are.
//
// quant_dense_f32_decode_kernel<BITS, MR>: M <= 16, bound by the codes'
// bytes as the bf16 decode kernel is, and built the same way: the same
// warp stages (a TMA box of 32 code rows into each warp's own ring, x and
// int4's scale row by each lane's cp.async), the same interleaved 32-row
// steps of the four warps summed in warp order, the same K split (it
// depends on K, N, bits and the SM count, never on M).  (Tried on the
// H100 and no faster: splits summed in a cluster's shared memory,
// 16-column blocks, eight warps on half steps, codes streamed by plain
// loads into registers.)  A lane owns 4
// neighbouring columns of the block's 128: per 4 k rows it reads one code
// word a row, dequantizes straight into registers (no W tile in shared
// memory, no block barrier in the main loop) and takes the MR rows of x
// (1, 8 or 16, zero-padded past M) as broadcast float4s: 16 MR FFMA for
// 4 + MR loads.  Each (row, column) sum is one FFMA chain over k in
// order, whatever MR is, so a row's result is bit-equal at M = 1 and
// inside M = 8 or 16.
//
// quant_dense_f32_tile_kernel<BITS>: M > 16, bound by operations from a
// few hundred rows (67 TFLOP/s of f32 FFMA): an SGEMM tile.  A block of
// 256 threads owns 128 x 128 outputs, a thread an 8 x 8 micro-tile (rows
// 4 ty .. + 3 and 64 + 4 ty .., columns 4 tx .. + 3 and 64 + 4 tx ..), fed
// by float4 loads from shared memory: per 4 k, 8 x and 8 W loads for 256
// FFMA (1/16 a FFMA: a 16-byte load takes a wavefront a quarter-warp,
// and the SM serves one wavefront for four warp FFMAs).  x ([128][64]
// f32 a step) and the raw codes arrive by cp.async into a 3-stage ring;
// each 64-row code step is dequantized once per block into one of two f32
// W tiles, the step after the one being multiplied, so one barrier a
// step separates them.
//
// Split K (every kernel): a product whose tiles do not fill the card
// splits its K steps over blockIdx.y (decode kernels) / .z (prefill and
// tile kernels).
// Each split writes f32 partials to a scratch the wrapper allocates; the
// last block of a tile to arrive (a per-tile arrival counter, which that
// block resets to 0 for the next launch and the next graph replay) sums
// them in split order (and rounds once, to bf16).  Deterministic: no
// float atomics.
// The counters are zeroed buffers allocated by the wrapper outside any
// capture (ops/quant_dense.arrival_counters): one per (device, stream) for
// eager products, so two products running at once on two streams of one
// device never share a counter, and one per engine for its captured
// graphs, which replay one at a time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper_tile::cp_async16;
using hopper_tile::cp_async_commit;
using hopper_tile::cp_async_wait;
using hopper_tile::mma_bf16;
using hopper_tile::pack_bf16;

constexpr int BN = 128;             // output columns a block (all kernels)
constexpr int BK = 64;              // K rows a step (f32 tile, prefill)
constexpr int COUNTERS = 1 << 16;   // arrival counters (ints) a device

// ---------------------------------------------------------------------------
// shared pieces

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 bytes global -> shared (through L1); pred false zero-fills.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A word of four codes, one a byte, made ready for code_f32: int8 codes
// XORed to code + 128; int4's low (HI false) or high nibbles, code + 8.
template <int BITS>
__device__ __forceinline__ uint32_t biased(uint32_t w, bool hi) {
  return BITS == 8 ? w ^ 0x80808080u : ((hi ? w >> 4 : w) & 0x0F0F0F0Fu);
}

// f32(code) of byte i of a biased word: 2^23 + byte, minus 2^23 + the
// offset.  Exact; i is a constant wherever it is called (unrolled loops).
// `magic` is 2^23's bits, 0x4B000000.  The decode and prefill kernels take
// it as an argument: with both it and the byte selector constant, ptxas
// encoded the magic as the permute's immediate and spent a move on the
// selector of every permute, a fifth of the decode loop.
constexpr uint32_t MAGIC = 0x4B000000u;

template <int BITS>
__device__ __forceinline__ float code_f32(uint32_t b, int i,
                                          uint32_t magic) {
  return __int_as_float(__byte_perm(b, magic, 0x7650 | i)) -
         (BITS == 8 ? 8388736.f : 8388616.f);
}

__device__ __forceinline__ void load_scales16(float (&s)[16], const float* p,
                                              bool ok) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p) + j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    s[4 * j] = v.x;
    s[4 * j + 1] = v.y;
    s[4 * j + 2] = v.z;
    s[4 * j + 3] = v.w;
  }
}

// The 16 floats at p (shared memory, 16-byte aligned).
__device__ __forceinline__ void smem_scales16(float (&s)[16],
                                              const char* p) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = reinterpret_cast<const float4*>(p)[j];
    s[4 * j] = v.x;
    s[4 * j + 1] = v.y;
    s[4 * j + 2] = v.z;
    s[4 * j + 3] = v.w;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// phase that never completes (a lost TMA transaction) traps after ~2^26
// tries, seconds, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One 2-D TMA box (coordinates innermost first) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int bar, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(nthreads) : "memory");
}

// After a group of `nthreads` threads (named barrier `bar`) wrote a
// tile's partials: whether this block is the tile's last split to arrive,
// the same in every thread of the group.  The leader's arrival is one
// acquire-release atomic: release publishes the group's partials (the
// barrier orders them before it), acquire makes every earlier split's
// visible to the last block.  The last one resets the counter to 0 (every
// split has arrived) and may read every partial.
__device__ __forceinline__ bool last_to_arrive(int* counter, int splits,
                                               int* flag, bool leader,
                                               int bar, int nthreads) {
  named_sync(bar, nthreads);
  if (leader) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    const int last = old == splits - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  named_sync(bar, nthreads);
  return *reinterpret_cast<volatile int*>(flag) != 0;
}

// Four outputs at p: bf16 (rounded once) or f32.
__device__ __forceinline__ void store4(bf16* p, const float4& v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The last split of a tile sums the tile's partials, part[z][M][N] for z
// = 0 .. splits - 1 in that order, into out (x's dtype T): rows [m0, m1)
// by columns [n0, n0 + BN), as float4 slots spread over `nthreads`
// threads, eight splits' loads in flight at a time.
template <typename T>
__device__ __forceinline__ void sum_tile(const float* part, T* out, int M,
                                         int N, int m0, int m1, int n0,
                                         int splits, int tid, int nthreads) {
  const size_t stride = (size_t)M * N / 4;   // float4s a split
  for (int e = tid; e < (m1 - m0) * (BN / 4); e += nthreads) {
    const int row = m0 + e / (BN / 4), col = n0 + (e % (BN / 4)) * 4;
    if (row >= M || col >= N) continue;   // N % 16 == 0: all 4 or none
    const float4* p =
        reinterpret_cast<const float4*>(part + (size_t)row * N + col);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < splits; z0 += 8) {
      float4 q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        q[u] = z0 + u < splits ? __ldcg(p + (size_t)(z0 + u) * stride)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (z0 + u < splits) {
          v.x += q[u].x;
          v.y += q[u].y;
          v.z += q[u].z;
          v.w += q[u].w;
        }
    }
    store4(out + (size_t)row * N + col, v);
  }
}

// ---------------------------------------------------------------------------
// the decode kernel: bf16 x, M <= 16

constexpr int DEC_WARPS = 4;
constexpr int DEC_NT = DEC_WARPS * 32;
constexpr int DEC_BLOCKS_PER_SM = 4;
constexpr int DEC_STEP = 32;   // K rows a stage

// sum_tile for the decode kernel's M <= 16 rows: each of its DEC_NT threads
// owns up to SLOTS float4 slots of the [M][BN] tile and keeps 16 loads in
// flight over them, so a sum costs splits / (16 / SLOTS) round trips
// whatever M is.
template <int SLOTS, typename T>
__device__ __forceinline__ void sum_rows(const float* part, T* out, int M,
                                         int N, int n0, int splits,
                                         int tid) {
  constexpr int B = 16 / SLOTS;
  const size_t stride = (size_t)M * N / 4;
  const float4* p[SLOTS];
  bool ok[SLOTS];
  float4 v[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e = tid + i * DEC_NT;
    const int row = e / (BN / 4), col = n0 + (e % (BN / 4)) * 4;
    ok[i] = row < M && col < N;
    p[i] = reinterpret_cast<const float4*>(part + (size_t)row * N + col);
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int z0 = 0; z0 < splits; z0 += B) {
    float4 q[SLOTS][B];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i)
#pragma unroll
      for (int u = 0; u < B; ++u)
        q[i][u] = ok[i] && z0 + u < splits
                      ? __ldcg(p[i] + (size_t)(z0 + u) * stride)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < SLOTS; ++i)
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (z0 + u < splits) {
          v[i].x += q[i][u].x;
          v[i].y += q[i][u].y;
          v[i].z += q[i][u].z;
          v[i].w += q[i][u].w;
        }
  }
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (!ok[i]) continue;
    const int e = tid + i * DEC_NT;
    const int row = e / (BN / 4), col = n0 + (e % (BN / 4)) * 4;
    store4(out + (size_t)row * N + col, v[i]);
  }
}

template <int BITS, int NT8>
struct Dec {
  // one warp's stage: the W box [W_ROWS][BN] bytes (int8 k rows, or int4
  // packed rows) as TMA lays it down, [chunk][lane] 8-byte x chunks,
  // int4's [lane] 16-byte scale chunks; every offset a multiple of 128
  static constexpr int W_ROWS = BITS == 8 ? DEC_STEP : DEC_STEP / 2;
  static constexpr int X_CHUNKS = 2 * NT8;
  static constexpr int X_OFF = W_ROWS * BN;
  static constexpr int S_OFF = X_OFF + X_CHUNKS * 256;
  static constexpr int STAGE = S_OFF + (BITS == 4 ? 512 : 0);
  static constexpr int DEPTH = BITS == 8 ? 3 : 4;
  static constexpr int RING = DEC_WARPS * DEPTH * STAGE;
  // after the loop the ring holds each warp's sums [16 rows][BN + 1]
  static constexpr int RED = DEC_WARPS * 16 * (BN + 1) * 4;
  // then each warp's DEPTH W barriers, the split flag, and slack to align
  // the base to 128 bytes (TMA's destinations)
  static constexpr int BARS = RING > RED ? RING : RED;
  static constexpr int FLAG = BARS + DEC_WARPS * DEPTH * 8;
  static constexpr int SMEM = FLAG + 16 + 128;
};

// Issue one warp's copies of the stage at K row k0 into slot st: the W
// box (columns n0 .., past N zero-filled) by one TMA completing on `bar`,
// issued by lane 0 once every lane is done with the slot; x (and int4's
// scale row) by each lane's own cp.async.
template <int BITS, int NT8>
__device__ __forceinline__ void dec_load(char* st, uint64_t* bar,
                                         const CUtensorMap* wmap,
                                         const bf16* x, const float* scale,
                                         int M, int N, int K, int group,
                                         int n0, int k0, int lane) {
  using C = Dec<BITS, NT8>;
  if (lane == 0) {
    // the slot's earlier reads (generic proxy) before the TMA's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, C::X_OFF);
    tma_load_2d(st, wmap, n0, BITS == 8 ? k0 : k0 / 2, bar);
  }
  const int g = lane >> 2, t = lane & 3;
  const int n = n0 + 16 * g;
  const bool ok = n < N;   // N % 16 == 0: a chunk is all in or all out
#pragma unroll
  for (int c = 0; c < C::X_CHUNKS; ++c) {
    // x row 8 (c / 2) + g, k0 + 16 (c % 2) + 4 t .. + 3
    const int row = 8 * (c >> 1) + g;
    const bool xok = row < M;
    const int k = k0 + 16 * (c & 1) + 4 * t;
    cp_async8(st + C::X_OFF + c * 256 + lane * 8,
              xok ? x + (size_t)row * K + k : x, xok);
  }
  if constexpr (BITS == 4) {
    // the stage's scale row at columns n + 4 t .. + 3; the lane reads
    // those of lanes 4 g .. 4 g + 3
    const float* src = scale + (size_t)(k0 / group) * N + n + 4 * t;
    cp_async16(st + C::S_OFF + lane * 16, ok ? src : scale, ok);
  }
}

// One stage's products into acc[m16 tile][n8 tile][4].
template <int BITS, int NT8>
__device__ __forceinline__ void dec_compute(const char* st,
                                            float (&acc)[8][NT8][4],
                                            const float (&sc8)[16],
                                            int lane, uint32_t magic) {
  using C = Dec<BITS, NT8>;
  float s[16];
  if constexpr (BITS == 8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = sc8[j];
  } else {
    smem_scales16(s, st + C::S_OFF + (lane >> 2) * 64);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the stage's two 16-row k steps
    uint32_t b[NT8][2];
#pragma unroll
    for (int jn = 0; jn < NT8; ++jn) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          st + C::X_OFF + (2 * jn + h) * 256 + lane * 8);
      b[jn][0] = v.x;
      b[jn][1] = v.y;
    }
    // rw[r][q]: biased word q (columns 4q .. 4q + 3) of k row 4 tig + r
    // of the step: box row 16 h + 4 tig + r (int8) or packed row 8 h +
    // 2 tig + r / 2 (int4), bytes 16 gid .. (four box rows a load
    // instruction: no bank conflict)
    const int g = lane >> 2, t = lane & 3;
    uint32_t rw[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row =
          BITS == 8 ? 16 * h + 4 * t + r : 8 * h + 2 * t + (r >> 1);
      const uint4 v =
          *reinterpret_cast<const uint4*>(st + row * BN + 16 * g);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rw[r][q] = biased<BITS>(word(v, q), BITS == 4 && (r & 1));
    }
    // m16 tile j: a[0] = (col 2j; k 4t, 4t+1), a[1] = (col 2j+1; k 4t,
    // 4t+1), a[2] = (col 2j; k 4t+2, 4t+3), a[3] = (col 2j+1; k 4t+2,
    // 4t+3); the lower k in each register's low half
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j >> 1, i0 = (2 * j) & 3;
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * (e >> 1), i = i0 + (e & 1);
        const float sc = s[2 * j + (e & 1)];
        a[e] = pack_bf16(code_f32<BITS>(rw[r][q], i, magic) * sc,
                         code_f32<BITS>(rw[r + 1][q], i, magic) * sc);
      }
#pragma unroll
      for (int jn = 0; jn < NT8; ++jn)
        mma_bf16(acc[j][jn], a, b[jn][0], b[jn][1]);
    }
  }
}

// grid (ceil(N / BN), splits); split y takes 32-row steps [y per, min(K /
// 32, (y + 1) per)); its warp w takes every fourth of them from the w-th.
// One split writes out; with more, f32 partials part[y][M][N], and the
// tile's last split sums them.
template <int BITS, int NT8>
__global__ void __launch_bounds__(DEC_NT, DEC_BLOCKS_PER_SM)
    quant_dense_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                              const bf16* __restrict__ x,
                              const float* __restrict__ scale,
                              bf16* __restrict__ out,
                              float* __restrict__ part,
                              int* __restrict__ counters, int M, int N,
                              int K, int group, int per, uint32_t magic) {
  using C = Dec<BITS, NT8>;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.y * per;
  const int left = min(K / DEC_STEP, kt0 + per) - kt0 - warp;
  const int mine = left > 0 ? (left + DEC_WARPS - 1) / DEC_WARPS : 0;
  char* ring = smem + warp * C::DEPTH * C::STAGE;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + C::BARS) + warp * C::DEPTH;
  if (lane == 0) {
    for (int s = 0; s < C::DEPTH; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  float sc8[16];
  if constexpr (BITS == 8) {
    const int n = n0 + 16 * (lane >> 2);
    load_scales16(sc8, scale + n, n < N);
  }
  float acc[8][NT8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int jn = 0; jn < NT8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][jn][e] = 0.f;

  auto k_of = [&](int i) { return (kt0 + warp + i * DEC_WARPS) * DEC_STEP; };
#pragma unroll
  for (int s = 0; s < C::DEPTH - 1; ++s) {
    if (s < mine)
      dec_load<BITS, NT8>(ring + s * C::STAGE, bars + s, &wmap, x, scale, M,
                          N, K, group, n0, k_of(s), lane);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<C::DEPTH - 2>();   // this lane's copies of stage i
    mbar_wait(bars + i % C::DEPTH, (i / C::DEPTH) & 1);   // its W box
    // the other lanes' (int4's shared scale row), and every lane done
    // with stage i - 1's slot, which the next copies refill
    __syncwarp();
    const int nxt = i + C::DEPTH - 1;
    if (nxt < mine)
      dec_load<BITS, NT8>(ring + (nxt % C::DEPTH) * C::STAGE,
                          bars + nxt % C::DEPTH, &wmap, x, scale, M, N, K,
                          group, n0, k_of(nxt), lane);
    cp_async_commit();
    dec_compute<BITS, NT8>(ring + (i % C::DEPTH) * C::STAGE, acc, sc8,
                           lane, magic);
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp done with its ring: it takes the sums

  // [warp][16][P]: the row pitch P = BN + 1 spreads a fragment's stores
  constexpr int P = BN + 1;
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int jn = 0; jn < NT8; ++jn) {
      // c[0], c[1]: column 16 g + 2 j, x rows 8 jn + 2 t, + 1; c[2], c[3]:
      // the next column
      float* r = red + (warp * 16 + 8 * jn + 2 * t) * P + 16 * g + 2 * j;
      r[0] = acc[j][jn][0];
      r[P] = acc[j][jn][1];
      r[1] = acc[j][jn][2];
      r[P + 1] = acc[j][jn][3];
    }
  __syncthreads();
  const int n = n0 + threadIdx.x;   // DEC_NT == BN: a thread a column
  const bool split = gridDim.y > 1;
  for (int m = 0; m < M; ++m) {
    float v = red[m * P + threadIdx.x];
#pragma unroll
    for (int ww = 1; ww < DEC_WARPS; ++ww)
      v += red[(ww * 16 + m) * P + threadIdx.x];
    if (n < N) {
      if (split)
        part[((size_t)blockIdx.y * M + m) * N + n] = v;
      else
        out[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
  if (!split) return;
  int* flag = reinterpret_cast<int*>(smem + C::FLAG);
  if (!last_to_arrive(counters + blockIdx.x, gridDim.y, flag,
                      threadIdx.x == 0, 1, DEC_NT))
    return;
  // M rows of BN / 4 float4 slots over DEC_NT threads
  if (M <= 4)
    sum_rows<1>(part, out, M, N, n0, gridDim.y, threadIdx.x);
  else if (M <= 8)
    sum_rows<2>(part, out, M, N, n0, gridDim.y, threadIdx.x);
  else
    sum_rows<4>(part, out, M, N, n0, gridDim.y, threadIdx.x);
}

// ---------------------------------------------------------------------------
// the prefill kernel: bf16 x, any M (routed M > 16), wgmma fed by TMA

constexpr int PF_CONSUMERS = 256;             // two warpgroups
constexpr int PF_NT = PF_CONSUMERS + 32;      // and one producer warp
constexpr int PF_BM = 128;
constexpr int PF_STAGES = 7;
constexpr int PF_BBUF = 3;

template <int BITS>
struct Pf {
  // a stage: x [128][64] bf16, 128-byte swizzled (the TMA box's layout);
  // the raw code tile [64 or 32][128] bytes; int4's scale row [128] f32
  static constexpr int X_BYTES = PF_BM * BK * 2;
  static constexpr int RAW_ROWS = BITS == 8 ? BK : BK / 2;
  static constexpr int RAW_BYTES = RAW_ROWS * BN;
  static constexpr int SC_BYTES = BITS == 4 ? BN * 4 : 0;
  static constexpr int TX = X_BYTES + RAW_BYTES + SC_BYTES;
  static constexpr int STAGE = (TX + 1023) / 1024 * 1024;
  // a dequantized W tile: [2 column atoms][8 k groups][8 k][64 cols] bf16,
  // each 128-byte row's 16-byte chunks XORed with k % 8
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int B_OFF = PF_STAGES * STAGE;
  static constexpr int BAR_OFF = B_OFF + PF_BBUF * B_BYTES;
  // barriers and the split flag, then slack to align the base to 1024
  static constexpr int SMEM = BAR_OFF + 256 + 1024;
};


// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A K-major, B MN-major
// (transposed), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// A 16-byte chunk of 8 bf16 of the W tile at k row `k`, columns 8 q ..
// 8 q + 7 (q = 0..15): atom q / 8, chunk q % 8 XORed with k % 8.
__device__ __forceinline__ uint4* w_chunk(char* tile, int k, int q) {
  return reinterpret_cast<uint4*>(tile + (q >> 3) * 8192 + (k >> 3) * 1024 +
                                  (k & 7) * 128 +
                                  (((q & 7) ^ (k & 7)) << 4));
}

// Stage st's raw codes -> the W tile: thread tid (of 256) takes 16 columns
// 16 (tid % 8) .. of int8 k rows tid / 8 and tid / 8 + 32, or of int4's
// packed row tid / 8 (k rows 2 r, 2 r + 1).
template <int BITS>
__device__ __forceinline__ void pf_dequant(const char* st, char* tile,
                                           const float (&sc8)[16], int tid,
                                           uint32_t magic) {
  using C = Pf<BITS>;
  const char* raw = st + C::X_BYTES;
  const int c = tid & 7;
  float s[16];
  if constexpr (BITS == 8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = sc8[j];
  } else {
    smem_scales16(s, raw + C::RAW_BYTES + c * 64);
  }
  constexpr int ROWS = BITS == 8 ? 2 : 1;
#pragma unroll
  for (int h = 0; h < ROWS; ++h) {
    const int r = (tid >> 3) + 32 * h;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * BN + c * 16);
#pragma unroll
    for (int hi = 0; hi < (BITS == 8 ? 1 : 2); ++hi) {
      const int k = BITS == 8 ? r : 2 * r + hi;
      uint32_t o[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t b = biased<BITS>(word(v, q), hi);
        o[2 * q] = pack_bf16(code_f32<BITS>(b, 0, magic) * s[4 * q],
                             code_f32<BITS>(b, 1, magic) * s[4 * q + 1]);
        o[2 * q + 1] = pack_bf16(code_f32<BITS>(b, 2, magic) * s[4 * q + 2],
                                 code_f32<BITS>(b, 3, magic) * s[4 * q + 3]);
      }
      *w_chunk(tile, k, 2 * c) = make_uint4(o[0], o[1], o[2], o[3]);
      *w_chunk(tile, k, 2 * c + 1) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
}

// grid (ceil(N / BN), ceil(M / 128), splits); split z takes 64-row steps
// [z per, min(K / 64, (z + 1) per)).  One split writes out; with more, f32
// partials part[z][M][N], and the tile's last split sums them.
template <int BITS>
__global__ void __launch_bounds__(PF_NT, 1)
    quant_dense_prefill_kernel(const __grid_constant__ CUtensorMap tmap_x,
                               const __grid_constant__ CUtensorMap tmap_w,
                               const __grid_constant__ CUtensorMap tmap_s,
                               const float* __restrict__ scale,
                               bf16* __restrict__ out,
                               float* __restrict__ part,
                               int* __restrict__ counters, int M, int N,
                               int K, int group, int per, uint32_t magic) {
  using C = Pf<BITS>;
  extern __shared__ __align__(16) char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + PF_STAGES;
  int* flag = reinterpret_cast<int*>(empty + PF_STAGES);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * PF_BM;
  const int kt0 = blockIdx.z * per;
  const int nsteps = min(K / BK - kt0, per);

  if (threadIdx.x == 0) {
    for (int s = 0; s < PF_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);   // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PF_CONSUMERS) {
    // the producer: one thread keeps the ring's TMA loads in flight
    if (threadIdx.x == PF_CONSUMERS) {
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % PF_STAGES;
        if (i >= PF_STAGES) mbar_wait(empty + s, (i / PF_STAGES - 1) & 1);
        char* st = smem + s * C::STAGE;
        const int k0 = (kt0 + i) * BK;
        mbar_expect_tx(full + s, C::TX);
        tma_load_2d(st, &tmap_x, k0, m0, full + s);
        tma_load_2d(st + C::X_BYTES, &tmap_w, n0, BITS == 8 ? k0 : k0 / 2,
                    full + s);
        if constexpr (BITS == 4)
          tma_load_2d(st + C::X_BYTES + C::RAW_BYTES, &tmap_s, n0,
                      k0 / group, full + s);
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows m0 + 64 wg .. + 63
  const int tid = threadIdx.x, wg = tid >> 7;
  const bool rows = m0 + 64 * wg < M;
  float sc8[16];
  if constexpr (BITS == 8) {
    const int n = n0 + 16 * (tid & 7);
    load_scales16(sc8, scale + n, n < N);
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint32_t sbase = smem_u32(smem);

  for (int i = 0; i < nsteps; ++i) {
    const int s = i % PF_STAGES;
    mbar_wait(full + s, (i / PF_STAGES) & 1);
    const char* st = smem + s * C::STAGE;
    char* tile = smem + C::B_OFF + (i % PF_BBUF) * C::B_BYTES;
    // tile was last read by step i - 3's products, which both warpgroups
    // waited for before the barrier of step i - 1
    pf_dequant<BITS>(st, tile, sc8, tid, magic);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1, PF_CONSUMERS);
    if (rows) {
      fence_operands(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t xa = sbase + s * C::STAGE + wg * 64 * 128;
      const uint32_t wb = sbase + C::B_OFF + (i % PF_BBUF) * C::B_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: +32 bytes a 16-wide k step inside the swizzled 128-byte rows;
        // B: two 8-row k groups (1024 bytes each) a k step, column atoms
        // 8 k groups apart
        wgmma_m64n128k16(d, gmma_desc(xa + kk * 32, 16, 1024),
                         gmma_desc(wb + kk * 2048, 8192, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_operands(d);
    }
    // step i - 1's products are done: its stage may be refilled
    if (i > 0 && (tid & 127) == 0) mbar_arrive(empty + (i - 1) % PF_STAGES);
  }
  if (rows) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(d);
  }

  // d[4 nb + e]: row 16 (warp % 4) + lane / 4 + 8 (e / 2) of the
  // warpgroup's 64, column 8 nb + 2 (lane % 4) + e % 2
  const int lane = tid & 31, wl = (tid >> 5) & 3;
  const int rbase = m0 + 64 * wg + 16 * wl + (lane >> 2);
  const int cbase = n0 + 2 * (lane & 3);
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rbase + 8 * hh, col = cbase + 8 * nb;
      if (row >= M || col >= N) continue;
      const float a = d[4 * nb + 2 * hh], b = d[4 * nb + 2 * hh + 1];
      if (split)
        *reinterpret_cast<float2*>(
            part + ((size_t)blockIdx.z * M + row) * N + col) =
            make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
            pack_bf16(a, b);
    }
  if (!split) return;
  if (!last_to_arrive(counters + blockIdx.y * gridDim.x + blockIdx.x,
                      gridDim.z, flag, tid == 0, 2, PF_CONSUMERS))
    return;
  sum_tile(part, out, M, N, m0, min(M, m0 + PF_BM), n0, gridDim.z, tid,
           PF_CONSUMERS);
}

// ---------------------------------------------------------------------------
// the f32 decode kernel: f32 x, M <= 16, weight streaming on the CUDA cores

template <int BITS, int MR>
struct F32Dec {
  // one warp's stage: the W box [W_ROWS][BN] bytes as TMA lays it down,
  // x rows [MR][32] f32, int4's scale row [BN] f32; every offset a
  // multiple of 128
  static constexpr int W_ROWS = BITS == 8 ? DEC_STEP : DEC_STEP / 2;
  static constexpr int X_OFF = W_ROWS * BN;
  static constexpr int S_OFF = X_OFF + MR * DEC_STEP * 4;
  static constexpr int STAGE = S_OFF + (BITS == 4 ? BN * 4 : 0);
  static constexpr int DEPTH = BITS == 8 ? 3 : 4;
  static constexpr int RING = DEC_WARPS * DEPTH * STAGE;
  // after the loop the ring holds each warp's sums [MR rows][BN]
  static constexpr int RED = DEC_WARPS * MR * BN * 4;
  // then each warp's DEPTH W barriers, the split flag, and slack to align
  // the base to 128 bytes (TMA's destinations)
  static constexpr int BARS = RING > RED ? RING : RED;
  static constexpr int FLAG = BARS + DEC_WARPS * DEPTH * 8;
  static constexpr int SMEM = FLAG + 16 + 128;
  static_assert(MR == 1 || MR == 8 || MR == 16, "1, 8 or 16 rows");
};

// Issue one warp's copies of the stage at K row k0 into slot st: the W
// box by one TMA completing on `bar` (lane 0, once every lane is done
// with the slot); x rows [0, MR) (past M zero-filled) and int4's scale
// row at this lane's columns by each lane's own cp.async.
template <int BITS, int MR>
__device__ __forceinline__ void f32d_load(char* st, uint64_t* bar,
                                          const CUtensorMap* wmap,
                                          const float* x, const float* scale,
                                          int M, int N, int K, int group,
                                          int n0, int k0, int lane) {
  using C = F32Dec<BITS, MR>;
  if (lane == 0) {
    // the slot's earlier reads (generic proxy) before the TMA's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, C::X_OFF);
    tma_load_2d(st, wmap, n0, BITS == 8 ? k0 : k0 / 2, bar);
  }
  // x row c / 8, k0 + 4 (c % 8) .. + 3
#pragma unroll
  for (int c = lane; c < MR * 8; c += 32) {
    const int row = c >> 3;
    const bool ok = row < M;
    cp_async16(st + C::X_OFF + c * 16,
               ok ? x + (size_t)row * K + k0 + 4 * (c & 7) : x, ok);
  }
  if constexpr (BITS == 4) {
    const int n = n0 + 4 * lane;
    const bool ok = n < N;   // N % 16 == 0: a lane's 4 are all in or out
    cp_async16(st + C::S_OFF + lane * 16,
               ok ? scale + (size_t)(k0 / group) * N + n : scale, ok);
  }
}

// One stage's products into acc[row][column]: per 4 k rows, the lane's
// code word of each row dequantized to w[k][column] (f32(code) * scale),
// then every row of x times it, k in order.
template <int BITS, int MR>
__device__ __forceinline__ void f32d_compute(const char* st,
                                             float (&acc)[MR][4],
                                             const float (&sc8)[4], int lane,
                                             uint32_t magic) {
  using C = F32Dec<BITS, MR>;
  float s[4];
  if constexpr (BITS == 8) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = sc8[c];
  } else {
    const float4 v = *reinterpret_cast<const float4*>(st + C::S_OFF +
                                                      lane * 16);
    s[0] = v.x;
    s[1] = v.y;
    s[2] = v.z;
    s[3] = v.w;
  }
  const float* xs = reinterpret_cast<const float*>(st + C::X_OFF);
#pragma unroll 2
  for (int kq = 0; kq < DEC_STEP; kq += 4) {
    float w[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // int8: box row kq + r; int4: packed row (kq + r) / 2, the low
      // nibbles for even k, the high ones for odd
      const int row = BITS == 8 ? kq + r : (kq + r) >> 1;
      const uint32_t b = biased<BITS>(
          *reinterpret_cast<const uint32_t*>(st + row * BN + 4 * lane),
          BITS == 4 && (r & 1));
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[r][c] = code_f32<BITS>(b, c, magic) * s[c];
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + m * DEC_STEP +
                                                         kq);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[m][c] = fmaf(xv.x, w[0][c], acc[m][c]);
        acc[m][c] = fmaf(xv.y, w[1][c], acc[m][c]);
        acc[m][c] = fmaf(xv.z, w[2][c], acc[m][c]);
        acc[m][c] = fmaf(xv.w, w[3][c], acc[m][c]);
      }
    }
  }
}

// grid (ceil(N / BN), splits); split y takes 32-row steps [y per, min(K /
// 32, (y + 1) per)); its warp w takes every fourth of them from the w-th.
// One split writes out; with more, f32 partials part[y][M][N], and the
// tile's last split sums them.
template <int BITS, int MR>
__global__ void __launch_bounds__(DEC_NT, 3)
    quant_dense_f32_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                                  const float* __restrict__ x,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out,
                                  float* __restrict__ part,
                                  int* __restrict__ counters, int M, int N,
                                  int K, int group, int per,
                                  uint32_t magic) {
  using C = F32Dec<BITS, MR>;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.y * per;
  const int left = min(K / DEC_STEP, kt0 + per) - kt0 - warp;
  const int mine = left > 0 ? (left + DEC_WARPS - 1) / DEC_WARPS : 0;
  char* ring = smem + warp * C::DEPTH * C::STAGE;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + C::BARS) + warp * C::DEPTH;
  if (lane == 0) {
    for (int s = 0; s < C::DEPTH; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  float sc8[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (BITS == 8) {
    const int n = n0 + 4 * lane;
    if (n < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(scale + n));
      sc8[0] = v.x;
      sc8[1] = v.y;
      sc8[2] = v.z;
      sc8[3] = v.w;
    }
  }
  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  auto k_of = [&](int i) { return (kt0 + warp + i * DEC_WARPS) * DEC_STEP; };
#pragma unroll
  for (int s = 0; s < C::DEPTH - 1; ++s) {
    if (s < mine)
      f32d_load<BITS, MR>(ring + s * C::STAGE, bars + s, &wmap, x, scale, M,
                          N, K, group, n0, k_of(s), lane);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<C::DEPTH - 2>();   // this lane's copies of stage i
    mbar_wait(bars + i % C::DEPTH, (i / C::DEPTH) & 1);   // its W box
    // the other lanes' x pieces, and every lane done with stage i - 1's
    // slot, which the next copies refill
    __syncwarp();
    const int nxt = i + C::DEPTH - 1;
    if (nxt < mine)
      f32d_load<BITS, MR>(ring + (nxt % C::DEPTH) * C::STAGE,
                          bars + nxt % C::DEPTH, &wmap, x, scale, M, N, K,
                          group, n0, k_of(nxt), lane);
    cp_async_commit();
    f32d_compute<BITS, MR>(ring + (i % C::DEPTH) * C::STAGE, acc, sc8, lane,
                           magic);
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp done with its ring: it takes the sums

  // [warp][MR][BN]: lane's 4 columns as one float4 a row
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MR; ++m)
    *reinterpret_cast<float4*>(red + (warp * MR + m) * BN + 4 * lane) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = n0 + threadIdx.x;   // DEC_NT == BN: a thread a column
  const bool split = gridDim.y > 1;
  for (int m = 0; m < M; ++m) {
    float v = red[m * BN + threadIdx.x];
#pragma unroll
    for (int ww = 1; ww < DEC_WARPS; ++ww)
      v += red[(ww * MR + m) * BN + threadIdx.x];
    if (n < N) {
      if (split)
        part[((size_t)blockIdx.y * M + m) * N + n] = v;
      else
        out[(size_t)m * N + n] = v;
    }
  }
  if (!split) return;
  int* flag = reinterpret_cast<int*>(smem + C::FLAG);
  if (!last_to_arrive(counters + blockIdx.x, gridDim.y, flag,
                      threadIdx.x == 0, 1, DEC_NT))
    return;
  if (M <= 4)
    sum_rows<1>(part, out, M, N, n0, gridDim.y, threadIdx.x);
  else if (M <= 8)
    sum_rows<2>(part, out, M, N, n0, gridDim.y, threadIdx.x);
  else
    sum_rows<4>(part, out, M, N, n0, gridDim.y, threadIdx.x);
}

// ---------------------------------------------------------------------------
// the f32 tile kernel: f32 x, M > 16, an SGEMM tile on the CUDA cores

constexpr int FT_BM = 128;                    // rows a block
constexpr int FT_NT = 256;                    // threads: 8 x 8 outputs each
constexpr int FT_STAGES = 3;

template <int BITS>
struct Ft {
  // a stage: x [FT_BM][BK] f32, the raw codes [64 or 32][BN] bytes,
  // int4's scale row [BN] f32; then two dequantized W tiles [BK][BN] f32
  // and the split flag
  static constexpr int X_BYTES = FT_BM * BK * 4;
  static constexpr int RAW_ROWS = BITS == 8 ? BK : BK / 2;
  static constexpr int RAW_BYTES = RAW_ROWS * BN;
  static constexpr int SC_BYTES = BITS == 4 ? BN * 4 : 0;
  static constexpr int STAGE = X_BYTES + RAW_BYTES + SC_BYTES;
  static constexpr int W_BYTES = BK * BN * 4;
  static constexpr int W_OFF = FT_STAGES * STAGE;
  static constexpr int FLAG = W_OFF + 2 * W_BYTES;
  static constexpr int SMEM = FLAG + 16;
  static_assert(SMEM <= 232448, "over the SM's 227 KB");
};

// Issue stage st's copies of K step kt: x rows [m0, m0 + FT_BM) (past M
// zero-filled), the step's code rows at columns [n0, n0 + BN) (past N
// zero-filled) and, for int4, its scale row.
template <int BITS>
__device__ __forceinline__ void ft_load(char* st, const float* x,
                                        const uint8_t* w, const float* scale,
                                        int M, int N, int K, int group,
                                        int m0, int n0, int kt) {
  using C = Ft<BITS>;
  const int k0 = kt * BK;
#pragma unroll
  for (int c = threadIdx.x; c < FT_BM * (BK / 4); c += FT_NT) {
    const int r = c / (BK / 4), p = c % (BK / 4);
    const bool ok = m0 + r < M;
    cp_async16(st + c * 16, ok ? x + (size_t)(m0 + r) * K + k0 + 4 * p : x,
               ok);
  }
  const int wr0 = BITS == 8 ? k0 : k0 / 2;
#pragma unroll
  for (int c = threadIdx.x; c < C::RAW_ROWS * (BN / 16); c += FT_NT) {
    const int r = c / (BN / 16), n = n0 + 16 * (c % (BN / 16));
    const bool ok = n < N;
    cp_async16(st + C::X_BYTES + c * 16,
               ok ? w + (size_t)(wr0 + r) * N + n : w, ok);
  }
  if constexpr (BITS == 4) {
    if (threadIdx.x < BN / 4) {
      const int n = n0 + 4 * threadIdx.x;
      const bool ok = n < N;
      cp_async16(st + C::X_BYTES + C::RAW_BYTES + 16 * threadIdx.x,
                 ok ? scale + (size_t)(k0 / group) * N + n : scale, ok);
    }
  }
}

// Stage st's codes -> the W tile wt [BK][BN] f32, f32(code) * scale: a
// thread takes the 4 columns 4 (tid % 32) .. of every eighth code row,
// one code word and one or two float4 stores a row.
template <int BITS>
__device__ __forceinline__ void ft_dequant(const char* st, float* wt,
                                           const float (&sc8)[4],
                                           uint32_t magic) {
  using C = Ft<BITS>;
  const char* raw = st + C::X_BYTES;
  const int c4 = threadIdx.x & 31;
  float s[4];
  if constexpr (BITS == 8) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = sc8[c];
  } else {
    const float4 v =
        *reinterpret_cast<const float4*>(raw + C::RAW_BYTES + 16 * c4);
    s[0] = v.x;
    s[1] = v.y;
    s[2] = v.z;
    s[3] = v.w;
  }
#pragma unroll
  for (int r = threadIdx.x >> 5; r < C::RAW_ROWS; r += FT_NT / 32) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(raw + r * BN +
                                                          4 * c4);
#pragma unroll
    for (int hi = 0; hi < (BITS == 8 ? 1 : 2); ++hi) {
      const uint32_t b = biased<BITS>(v, hi);
      *reinterpret_cast<float4*>(wt + (BITS == 8 ? r : 2 * r + hi) * BN +
                                 4 * c4) =
          make_float4(code_f32<BITS>(b, 0, magic) * s[0],
                      code_f32<BITS>(b, 1, magic) * s[1],
                      code_f32<BITS>(b, 2, magic) * s[2],
                      code_f32<BITS>(b, 3, magic) * s[3]);
    }
  }
}

// acc += x[rows][step] . wt over the step's BK k, in order: thread (ty,
// tx) reads its 8 rows' x as float4s of 4 k and its 8 columns of each W
// row as two float4s.
__device__ __forceinline__ void ft_compute(const float* xs, const float* wt,
                                           float (&acc)[8][8], int ty,
                                           int tx) {
#pragma unroll 2
  for (int kq = 0; kq < BK; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(
          xs + ((i >> 2) * (FT_BM / 2) + 4 * ty + (i & 3)) * BK + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = wt + (kq + kk) * BN + 4 * tx;
      const float4 b0 = *reinterpret_cast<const float4*>(wr);
      const float4 b1 = *reinterpret_cast<const float4*>(wr + BN / 2);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

// grid (ceil(N / BN), ceil(M / FT_BM), splits); split z takes 64-row
// steps [z per, min(K / 64, (z + 1) per)).  One split writes out; with
// more, f32 partials part[z][M][N], and the tile's last split sums them.
template <int BITS>
__global__ void __launch_bounds__(FT_NT, 1)
    quant_dense_f32_tile_kernel(const float* __restrict__ x,
                                const uint8_t* __restrict__ w,
                                const float* __restrict__ scale,
                                float* __restrict__ out,
                                float* __restrict__ part,
                                int* __restrict__ counters, int M, int N,
                                int K, int group, int per, uint32_t magic) {
  using C = Ft<BITS>;
  extern __shared__ __align__(16) char smem[];
  float* wts = reinterpret_cast<float*>(smem + C::W_OFF);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * FT_BM;
  const int kt0 = blockIdx.z * per;
  const int nsteps = min(K / BK - kt0, per);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  float sc8[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (BITS == 8) {
    const int n = n0 + 4 * (tid & 31);
    if (n < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(scale + n));
      sc8[0] = v.x;
      sc8[1] = v.y;
      sc8[2] = v.z;
      sc8[3] = v.w;
    }
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < FT_STAGES - 1; ++s) {
    if (s < nsteps)
      ft_load<BITS>(smem + s * C::STAGE, x, w, scale, M, N, K, group, m0, n0,
                    kt0 + s);
    cp_async_commit();
  }
  cp_async_wait<FT_STAGES - 2>();   // step 0 has landed
  __syncthreads();
  if (nsteps > 0) ft_dequant<BITS>(smem, wts, sc8, magic);
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<FT_STAGES - 3>();   // step i + 1 has landed
    // ... for every thread; W tile i is whole; step i - 1's stage and W
    // tile are free
    __syncthreads();
    const int nxt = i + FT_STAGES - 1;
    if (nxt < nsteps)
      ft_load<BITS>(smem + (nxt % FT_STAGES) * C::STAGE, x, w, scale, M, N,
                    K, group, m0, n0, kt0 + nxt);
    cp_async_commit();   // (empty past the last step)
    if (i + 1 < nsteps)
      ft_dequant<BITS>(smem + ((i + 1) % FT_STAGES) * C::STAGE,
                       wts + ((i + 1) & 1) * BK * BN, sc8, magic);
    ft_compute(reinterpret_cast<const float*>(smem +
                                              (i % FT_STAGES) * C::STAGE),
               wts + (i & 1) * BK * BN, acc, ty, tx);
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  float* dst = split ? part + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i >> 2) * (FT_BM / 2) + 4 * ty + (i & 3);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * (BN / 2) + 4 * tx;
      if (col < N)   // N % 16 == 0: all 4 or none
        *reinterpret_cast<float4*>(dst + (size_t)row * N + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
  if (!split) return;
  int* flag = reinterpret_cast<int*>(smem + C::FLAG);
  if (!last_to_arrive(counters + blockIdx.y * gridDim.x + blockIdx.x,
                      gridDim.z, flag, tid == 0, 1, FT_NT))
    return;
  sum_tile(part, out, M, N, m0, min(M, m0 + FT_BM), n0, gridDim.z, tid,
           FT_NT);
}

// ---------------------------------------------------------------------------
// launches

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (the
// runtime has libcuda loaded already), so the library links no libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major 2-D tensor [outer][inner] (row pitch `pitch` bytes) cut in
// boxes [box_outer][box_inner]; out-of-bounds elements read as zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                uint64_t inner, uint64_t outer, uint64_t pitch,
                uint32_t box_inner, uint32_t box_outer,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BITS, int NT8>
cudaError_t launch_decode(const void* x, const void* w, const void* scale,
                          void* out, void* part, void* counters, int M,
                          int N, int K, int group, int splits, int per,
                          cudaStream_t stream) {
  using C = Dec<BITS, NT8>;
  CUtensorMap wmap{};
  if (!tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                  BITS == 8 ? K : K / 2, N, BN, C::W_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  auto kern = quant_dense_decode_kernel<BITS, NT8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  // all of the SM's unified memory as shared memory: four blocks an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, splits);
  kern<<<grid, DEC_NT, C::SMEM, stream>>>(
      wmap, static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), M, N, K, group,
      per, MAGIC);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_prefill(const void* x, const void* w, const void* scale,
                           void* out, void* part, void* counters, int M,
                           int N, int K, int group, int splits, int per,
                           cudaStream_t stream) {
  using C = Pf<BITS>;
  CUtensorMap tx{}, tw{}, ts{};
  if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                  (uint64_t)K * 2, BK, PF_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                  BITS == 8 ? K : K / 2, N, BN, C::RAW_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (BITS == 4 &&
       !tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / group,
                   (uint64_t)N * 4, BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  auto kern = quant_dense_prefill_kernel<BITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + PF_BM - 1) / PF_BM, splits);
  kern<<<grid, PF_NT, C::SMEM, stream>>>(
      tx, tw, ts, static_cast<const float*>(scale), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), M, N, K, group,
      per, MAGIC);
  return cudaGetLastError();
}

template <int BITS, int MR>
cudaError_t launch_f32_decode(const void* x, const void* w,
                              const void* scale, void* out, void* part,
                              void* counters, int M, int N, int K, int group,
                              int splits, int per, cudaStream_t stream) {
  using C = F32Dec<BITS, MR>;
  CUtensorMap wmap{};
  if (!tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                  BITS == 8 ? K : K / 2, N, BN, C::W_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  auto kern = quant_dense_f32_decode_kernel<BITS, MR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, splits);
  kern<<<grid, DEC_NT, C::SMEM, stream>>>(
      wmap, static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), M, N, K, group, per, MAGIC);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_f32_tile(const void* x, const void* w, const void* scale,
                            void* out, void* part, void* counters, int M,
                            int N, int K, int group, int splits, int per,
                            cudaStream_t stream) {
  constexpr int smem = Ft<BITS>::SMEM;
  auto kern = quant_dense_f32_tile_kernel<BITS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + FT_BM - 1) / FT_BM, splits);
  kern<<<grid, FT_NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), M, N, K, group,
      per, MAGIC);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] (dtype 0 = float32, 1 = bfloat16), out [M, N] in x's dtype,
// w: bits 8 -> int8 [K, N] with scale f32 [N]; bits 4 -> uint8 [K/2, N]
// with scale f32 [K/group, N], group a multiple of 64 dividing K.
// kernel: 0 the f32 tile kernel (dtype 0), 1 the decode kernel (dtype 1,
// M <= 16), 2 the prefill kernel (dtype 1), 3 the f32 decode kernel
// (dtype 0, M <= 16).  splits: K-step splits (32-row steps for kernels 1
// and 3, 64-row for 0 and 2); every split must hold at least one step
// (splits == ceil(steps / ceil(steps / splits))).  With more than one,
// part is f32 scratch [splits, M, N], and `counters` the device's zeroed
// arrival counters (1 << 16 ints, one a tile).  Every pointer 16-byte
// aligned, N % 16 == 0, K % 64 == 0.
// Returns a cudaError_t (cudaErrorInvalidValue for anything without an
// instance); the caller raises on anything but 0.
int quant_dense_fwd(const void* x, const void* w, const void* scale,
                    void* out, void* part, void* counters, int M, int N,
                    int K, int bits, int group, int dtype, int kernel,
                    int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % BK)
    return (int)cudaErrorInvalidValue;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group <= 0 || group % BK || K % group))
    return (int)cudaErrorInvalidValue;
  const bool f32 = kernel == 0 || kernel == 3;
  const bool dec = kernel == 1 || kernel == 3;
  if (kernel < 0 || kernel > 3 || dtype != (f32 ? 0 : 1) || (dec && M > 16))
    return (int)cudaErrorInvalidValue;
  const int steps = K / (dec ? DEC_STEP : BK);
  if (splits < 1 || splits > steps || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (steps + splits - 1) / splits;
  if ((steps + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (N + BN - 1) / BN;
  const long long row_tiles = kernel == 2   ? (M + PF_BM - 1) / PF_BM
                              : kernel == 0 ? (M + FT_BM - 1) / FT_BM
                                            : 1;
  if (splits > 1 &&
      (counters == nullptr || n_tiles * row_tiles > COUNTERS))
    return (int)cudaErrorInvalidValue;
  if (row_tiles > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return (int)(bits == 8
                     ? launch_f32_tile<8>(x, w, scale, out, part, counters,
                                          M, N, K, group, splits, per, st)
                     : launch_f32_tile<4>(x, w, scale, out, part, counters,
                                          M, N, K, group, splits, per, st));
  if (kernel == 3) {
#define F32_DEC(MR)                                                         \
  return (int)(bits == 8                                                    \
                   ? launch_f32_decode<8, MR>(x, w, scale, out, part,       \
                                              counters, M, N, K, group,     \
                                              splits, per, st)              \
                   : launch_f32_decode<4, MR>(x, w, scale, out, part,       \
                                              counters, M, N, K, group,     \
                                              splits, per, st))
    if (M == 1) F32_DEC(1);
    if (M <= 8) F32_DEC(8);
    F32_DEC(16);
#undef F32_DEC
  }
  if (kernel == 2)
    return (int)(bits == 8
                     ? launch_prefill<8>(x, w, scale, out, part, counters, M,
                                         N, K, group, splits, per, st)
                     : launch_prefill<4>(x, w, scale, out, part, counters, M,
                                         N, K, group, splits, per, st));
  if (M <= 8)
    return (int)(bits == 8
                     ? launch_decode<8, 1>(x, w, scale, out, part, counters,
                                           M, N, K, group, splits, per, st)
                     : launch_decode<4, 1>(x, w, scale, out, part, counters,
                                           M, N, K, group, splits, per, st));
  return (int)(bits == 8
                   ? launch_decode<8, 2>(x, w, scale, out, part, counters, M,
                                         N, K, group, splits, per, st)
                   : launch_decode<4, 2>(x, w, scale, out, part, counters, M,
                                         N, K, group, splits, per, st));
}

const char* quant_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
