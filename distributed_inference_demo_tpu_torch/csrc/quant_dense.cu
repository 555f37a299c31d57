// Weight-only int8 / int4 dense product for Hopper (sm_90a):
// y[M, N] = x[M, K] . deq(W)[K, N], in x's dtype, f32 accumulation.
//
// No Pallas kernel computes this.  It is the counterpart of an XLA
// fusion: distributed_inference_demo_tpu/ops/quant.py::dense dequantizes
// a QuantizedArray / QuantizedArray4 to the activation dtype right at the
// einsum, and XLA fuses the unpack + convert + scale into the matmul's
// operand feed, so device memory sees only the quantized bytes.  PyTorch
// has no such fusion: w.dequantize() then a matmul writes a bf16 copy of
// every weight and reads it back.  Here the dequantized tile lives only
// in shared memory.
//
// Weights, as the reference lays them out:
// - int8: q int8 [K, N], scale f32 [N] (per output channel);
// - int4: q uint8 [K/2, N], byte (k/2, n) holding k even in its low
//   nibble and k odd in its high one, each code offset by 8; scale f32
//   [K/group, N], with group a multiple of the 64-row K step (the
//   reference's group is 64 wherever K >= 64), so a step needs one
//   scale row.
// Each element is dequantized exactly as the reference does it, f32(code)
// * scale, then rounded once to x's dtype (bf16 round-to-nearest-even),
// so W's rounding is the plain version's and only the order of the sums
// differs.
//
// What bounds it on the H100.  At decode (M = 1 to 8) every weight byte
// is read once for 2 M operations: ~2-16 operations a byte against the
// card's ~295 bf16 operations a byte, so bytes bound it (TinyLlama's
// int8 w_up: 11.5 MB, 3.4 us at 3.35 TB/s).  At prefill chunks of
// hundreds of rows it turns to operations.
//
// Design (simple and right first; wgmma, TMA and a GEMV path for M <= 16
// are later work).  A block of four warps owns a BM x 128 output tile
// and walks its K range in 64-row steps:
// - the quantized W tile (64 x 128 int8, or 32 x 128 packed bytes with
//   the step's int4 scale row) and the x tile arrive by 16-byte cp.async
//   into a ring of three stages, so two steps' copies are in flight
//   beside one step's math;
// - the block dequantizes the stage into one bf16 (or f32) W tile in
//   shared memory, each thread 16 neighbouring columns of a row, with
//   its columns' int8 scales held in registers, int4's read from the
//   stage;
// - bf16 x: the warps multiply with mma.sync.m16n8k16 (x's A fragments
//   by ldmatrix, W's B fragments by ldmatrix.trans from the row-major
//   tile).  BM = 16 for M <= 16 (the four warps split the 128 columns),
//   BM = 64 above (2 x 2 warps of 32 x 64).  f32 x: full f32 on the
//   CUDA cores, BM = 16, a thread per column; it serves the f32 checks;
// - split K: where the tiles of a small-M product do not fill the card
//   (TinyLlama's wk / wv have N = 256, two tiles), the wrapper splits
//   the K steps over blockIdx.z; each split writes f32 partials to a
//   scratch the wrapper allocates, and a second kernel sums them in
//   split order (deterministic: no atomics) and rounds once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "hopper_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper_tile::cp_async16;
using hopper_tile::cp_async_commit;
using hopper_tile::cp_async_wait;
using hopper_tile::ldmatrix_x4;
using hopper_tile::ldmatrix_x4_trans;
using hopper_tile::mma_bf16;
using hopper_tile::pack_bf16;

constexpr int NT = 128;     // threads a block: four warps
constexpr int BN = 128;     // output columns a block
constexpr int BK = 64;      // K rows a stage
constexpr int STAGES = 3;

template <typename T, int BITS, int BM>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // x tile [BM][X_PITCH]: bf16 rows padded by 16 bytes so the 8 rows one
  // ldmatrix reads sit on distinct banks; f32 rows are read as
  // broadcasts and need no pad
  static constexpr int X_PITCH = F32 ? BK : BK + 8;
  static constexpr int X_BYTES = BM * X_PITCH * (int)sizeof(T);
  static constexpr int RAW_ROWS = BITS == 8 ? BK : BK / 2;
  static constexpr int RAW_BYTES = RAW_ROWS * BN;
  // int4: the step's scale row, BN f32
  static constexpr int SCALE_BYTES = BITS == 4 ? BN * 4 : 0;
  static constexpr int STAGE_BYTES = X_BYTES + RAW_BYTES + SCALE_BYTES;
  static constexpr int W_PITCH = F32 ? BN : BN + 8;
  static constexpr int W_BYTES = BK * W_PITCH * (int)sizeof(T);
  static constexpr int SMEM = STAGES * STAGE_BYTES + W_BYTES;
  // bf16 warp grid: BM = 16 -> 1 x 4 warps of 16 x 32; BM = 64 -> 2 x 2
  // warps of 32 x 64
  static constexpr int WARPS_M = BM == 16 ? 1 : 2;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / 16 / WARPS_M;   // m16 tiles a warp
  static constexpr int WN = BN / 8 / WARPS_N;    // n8 tiles a warp
  static_assert(X_BYTES % 16 == 0 && RAW_BYTES % 16 == 0, "alignment");
  static_assert(!F32 || BM == 16, "the f32 instance has 16-row tiles");
};

// Issue stage `st`'s copies: x rows [m0, m0 + BM) and W rows of K step kt,
// and for int4 the step's scale row (rows past M and columns past N are
// zero-filled).
template <typename T, int BITS, int BM>
__device__ __forceinline__ void load_stage(char* st, const T* x,
                                           const uint8_t* w,
                                           const float* scale, int M, int N,
                                           int K, int group, int m0, int n0,
                                           int kt) {
  using C = Cfg<T, BITS, BM>;
  T* sx = reinterpret_cast<T*>(st);
  uint8_t* sw = reinterpret_cast<uint8_t*>(st + C::X_BYTES);
  const int k0 = kt * BK;
  constexpr int EPC = 16 / (int)sizeof(T);       // elements a 16-byte copy
  constexpr int XCR = BK / EPC;                  // copies an x row
#pragma unroll
  for (int c = threadIdx.x; c < BM * XCR; c += NT) {
    const int r = c / XCR, cc = c % XCR;
    const bool ok = m0 + r < M;
    const T* src = ok ? x + (size_t)(m0 + r) * K + k0 + cc * EPC : x;
    cp_async16(sx + r * C::X_PITCH + cc * EPC, src, ok);
  }
  const int wr0 = BITS == 8 ? k0 : k0 / 2;
#pragma unroll
  for (int c = threadIdx.x; c < C::RAW_ROWS * 8; c += NT) {
    const int r = c >> 3, n = n0 + (c & 7) * 16;
    const bool ok = n < N;
    const uint8_t* src = ok ? w + (size_t)(wr0 + r) * N + n : w;
    cp_async16(sw + r * BN + (c & 7) * 16, src, ok);
  }
  if constexpr (BITS == 4) {
    float* ss = reinterpret_cast<float*>(st + C::X_BYTES + C::RAW_BYTES);
    const float* row = scale + (size_t)(k0 / group) * N;
    if (threadIdx.x < BN / 4) {
      const int n = n0 + threadIdx.x * 4;
      const bool ok = n < N;
      cp_async16(ss + threadIdx.x * 4, ok ? row + n : scale, ok);
    }
  }
}

// 16 f32 values of one W row, stored to the tile in T at dst.
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float (&v)[16]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reinterpret_cast<float4*>(dst)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
    uint4 o[2];
    uint32_t* u = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
    reinterpret_cast<uint4*>(dst)[0] = o[0];
    reinterpret_cast<uint4*>(dst)[1] = o[1];
  }
}

__device__ __forceinline__ void load_scales16(float (&s)[16],
                                              const float* p, bool ok) {
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

// Dequantize stage `st`'s raw W into the tile sw: f32(code) * scale,
// rounded to T.  A thread takes 16 neighbouring columns, (threadIdx.x %
// 8) * 16, of every 16th row.
template <typename T, int BITS, int BM>
__device__ __forceinline__ void dequant(const char* st, T* sw,
                                        const float (&sc8)[16]) {
  using C = Cfg<T, BITS, BM>;
  const uint8_t* raw = reinterpret_cast<const uint8_t*>(st + C::X_BYTES);
  const int col = (threadIdx.x & 7) * 16;
  float v[16];
  if constexpr (BITS == 8) {
#pragma unroll
    for (int r = threadIdx.x >> 3; r < BK; r += NT / 8) {
      const uint4 b4 = *reinterpret_cast<const uint4*>(raw + r * BN + col);
      const int8_t* b = reinterpret_cast<const int8_t*>(&b4);
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = (float)b[j] * sc8[j];
      store16<T>(sw + r * C::W_PITCH + col, v);
    }
  } else {
    // the step's scale row (one group spans the whole step)
    const float4* sr = reinterpret_cast<const float4*>(
        st + C::X_BYTES + C::RAW_BYTES) + col / 4;
    float s[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = sr[j];
      s[4 * j] = f.x;
      s[4 * j + 1] = f.y;
      s[4 * j + 2] = f.z;
      s[4 * j + 3] = f.w;
    }
#pragma unroll
    for (int pr = threadIdx.x >> 3; pr < BK / 2; pr += NT / 8) {
      const uint4 b4 = *reinterpret_cast<const uint4*>(raw + pr * BN + col);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&b4);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = (float)((int)(b[j] & 0xF) - 8) * s[j];
      store16<T>(sw + (2 * pr) * C::W_PITCH + col, v);
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = (float)((int)(b[j] >> 4) - 8) * s[j];
      store16<T>(sw + (2 * pr + 1) * C::W_PITCH + col, v);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_out2(T* out, float a, float b) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(out) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(a, b);
  }
}

// grid (ceil(N / BN), ceil(M / BM), splits); split z takes K steps
// [z * steps_per_split, min(K / BK, (z + 1) * steps_per_split)).  With
// one split the block writes out; with more, f32 partials part[z][M][N].
template <typename T, int BITS, int BM>
__global__ void __launch_bounds__(NT)
    quant_dense_kernel(const T* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ scale, T* __restrict__ out,
                       float* __restrict__ part, int M, int N, int K,
                       int group, int steps_per_split) {
  using C = Cfg<T, BITS, BM>;
  extern __shared__ __align__(16) char smem[];
  T* sw = reinterpret_cast<T*>(smem + STAGES * C::STAGE_BYTES);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * steps_per_split;
  const int nsteps = min(K / BK - kt0, steps_per_split);

  float sc8[16];
  if constexpr (BITS == 8) {
    const int col = n0 + (threadIdx.x & 7) * 16;
    load_scales16(sc8, scale + col, col < N);
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps)
      load_stage<T, BITS, BM>(smem + s * C::STAGE_BYTES, x, w, scale, M, N,
                              K, group, m0, n0, kt0 + s);
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // bf16: acc[m16 tile][n8 tile][4]; f32: acc[0][0][r] for rows r < 4, ...
  constexpr int WM = C::F32 ? 1 : C::WM;
  constexpr int WN = C::F32 ? 4 : C::WN;
  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;

  for (int i = 0; i < nsteps; ++i) {
    if (i + STAGES - 1 < nsteps)
      load_stage<T, BITS, BM>(
          smem + ((i + STAGES - 1) % STAGES) * C::STAGE_BYTES, x, w, scale,
          M, N, K, group, m0, n0, kt0 + i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const char* st = smem + (i % STAGES) * C::STAGE_BYTES;
    dequant<T, BITS, BM>(st, sw, sc8);
    __syncthreads();
    const T* sx = reinterpret_cast<const T*>(st);
    if constexpr (C::F32) {
      // thread = column; 16 rows of running sums in full f32
      float* a = &acc[0][0][0];
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float wv = sw[kk * C::W_PITCH + threadIdx.x];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          a[r] = fmaf(sx[r * C::X_PITCH + kk], wv, a[r]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[WM][4];
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          const int row = (wm * WM + mt) * 16 + (lane & 7) +
                          (((lane >> 3) & 1) << 3);
          ldmatrix_x4(af[mt], sx + row * C::X_PITCH + kk * 16 +
                                  ((lane >> 4) << 3));
        }
#pragma unroll
        for (int np = 0; np < WN / 2; ++np) {
          // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
          // (k 8-15, n 8-15): b[0], b[1] of n tile 2 np, b[2], b[3] of
          // 2 np + 1
          uint32_t b[4];
          const int row = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(b, sw + row * C::W_PITCH + wn * WN * 8 +
                                   np * 16 + ((lane >> 4) << 3));
#pragma unroll
          for (int mt = 0; mt < WM; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();   // the stage and the W tile are rewritten next step
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  float* pz = part + (size_t)blockIdx.z * M * N;
  if constexpr (C::F32) {
    const int n = n0 + threadIdx.x;
    if (n < N) {
      const float* a = &acc[0][0][0];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (m0 + r >= M) break;
        const size_t o = (size_t)(m0 + r) * N + n;
        if (split)
          pz[o] = a[r];
        else
          out[o] = a[r];
      }
    }
  } else {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
        const int n = n0 + (wn * WN + nt) * 8 + 2 * tig;
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + (wm * WM + mt) * 16 + gid + 8 * h;
          if (m >= M) continue;
          const size_t o = (size_t)m * N + n;
          if (split)
            *reinterpret_cast<float2*>(pz + o) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          else
            store_out2<T>(out + o, acc[mt][nt][2 * h],
                          acc[mt][nt][2 * h + 1]);
        }
      }
  }
}

// out[i] = sum over splits, in split order, of part[s][i], rounded once.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ part,
                              T* __restrict__ out, size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * mn + i];
  if constexpr (std::is_same<T, float>::value)
    out[i] = s;
  else
    out[i] = __float2bfloat16_rn(s);
}

template <typename T, int BITS, int BM>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   void* out, void* part, int M, int N, int K, int group,
                   int splits, cudaStream_t stream) {
  using C = Cfg<T, BITS, BM>;
  auto kern = quant_dense_kernel<T, BITS, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int steps = K / BK;
  const int per = (steps + splits - 1) / splits;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, NT, C::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(part), M, N, K, group, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  reduce_splits<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), mn, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] (dtype 0 = float32, 1 = bfloat16), out [M, N] in x's dtype,
// w: bits 8 -> int8 [K, N] with scale f32 [N]; bits 4 -> uint8 [K/2, N]
// with scale f32 [K/group, N], group a multiple of 64.  block_rows: the
// instance, 16 or 64 for
// bfloat16, 16 for float32.  splits: K-step splits over blockIdx.z; with
// more than one, part is f32 scratch [splits, M, N], and every split must
// hold at least one step (splits == ceil(steps / ceil(steps / splits))).
// Every pointer 16-byte aligned, N % 16 == 0, K % 64 == 0; for int4 the
// group divides K.  Returns a cudaError_t
// (cudaErrorInvalidValue for anything without an instance); the caller
// raises on anything but 0.
int quant_dense_fwd(const void* x, const void* w, const void* scale,
                    void* out, void* part, int M, int N, int K, int bits,
                    int group, int dtype, int block_rows, int splits,
                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % BK)
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group <= 0 || group % BK || K % group))
    return (int)cudaErrorInvalidValue;
  const int steps = K / BK;
  if (splits < 1 || splits > steps || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (steps + splits - 1) / splits;
  if ((steps + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  if ((long long)((M + 15) / 16) > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QD_CASE(T, BITS, BM)                                               \
  if (bits == BITS && block_rows == BM)                                    \
    return (int)launch<T, BITS, BM>(x, w, scale, out, part, M, N, K,      \
                                    group, splits, st)
  if (dtype == 0) {
    QD_CASE(float, 8, 16);
    QD_CASE(float, 4, 16);
  }
  if (dtype == 1) {
    QD_CASE(bf16, 8, 16);
    QD_CASE(bf16, 8, 64);
    QD_CASE(bf16, 4, 16);
    QD_CASE(bf16, 4, 64);
  }
#undef QD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* quant_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
