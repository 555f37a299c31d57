// Paged attention for Hopper (sm_90a): decode and chunk prefill over a
// block-table page pool.
//
// Replaces the two Pallas TPU kernels of
// distributed_inference_demo_tpu/ops/paged_attention.py:
//
// - paged_decode_kernel replaces _paged_kernel (via _paged_call): one
//   query token per row.  For kv head h of row b, the g query heads
//   h*g .. h*g+g-1 attend to every key position s < kv_len[b] (which is
//   the causal bound: the query sits at kv_len - 1), with an optional
//   ALiBi bias -slope * (kv_len - 1 - s);
// - paged_prefill_kernel replaces _paged_prefill_kernel (via
//   _paged_prefill_call): a contiguous chunk of queries per row.  Row r
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
// Design.  Hopper has no sequential grid axis to carry the online softmax
// across pages, so each thread block loops over the keys itself and keeps
// the running max, sum and f32 accumulator for the whole loop.
//
// - Decode: one block per (kv head, row).  The g query heads of the kv
//   head are the block's rows (at most 16), so each K/V tile is loaded
//   from device memory once and shared by the whole group (8 q heads for
//   TinyLlama).  A tile is 32 consecutive key positions, which may span
//   several pages (bt is any multiple of 8): each key's page is looked up
//   in the table as the tile is loaded.  One warp owns one query row in
//   the softmax, one lane per key.  The block stops at its row's own
//   kv_len, so a short sequence costs O(kv_len), never O(W*bt).
// - Prefill: the structure of csrc/flash_attention.cu, with the cache
//   addressed through the table: one block per (64-row tile of the
//   chunk*g rows, kv head, row), looping over 64-key tiles up to the
//   tile's causal frontier starts[b] + last_row/g + 1.  q is read and the
//   output written in the projection layout [b, chunk, nh, hd] by index
//   arithmetic, so the wrapper does no regroup transpose.
//
// Bound on the H100.  Decode does 4*nh*hd operations per live key over
// the live K/V pages (2*nkv*hd elements per key) plus q and out: about g
// operations per byte, far below the card's ~295 bf16 operations per
// byte, so decode is bound by the bytes of the live pages.  What the
// design does about it: every page is read once per (row, kv head) and
// shared by the g query heads, and pages past kv_len are not read.
// Prefill chunks of 16-64 tokens over short prefixes are bound by bytes
// too; long prefixes turn them toward operations.  This first version
// computes on the CUDA cores in f32 (no mma.sync/wgmma, no TMA) and
// splits no row's keys across blocks: at 8 rows x 4 kv heads the decode
// launch has only 32 blocks for 132 SMs.  Splitting along the pages
// (flash-decoding) and tensor-core math are later work.
//
// Plain C interface, loaded with ctypes: each launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Offset of (position pos, kv head h, lane d) of one row through its
// table row `tab`, the page id clamped into the pool.
__device__ __forceinline__ size_t page_offset(const int* tab, int pos,
                                              int bt, int nkv, int h,
                                              int num_pages, int hd,
                                              int d) {
  const int j = pos / bt;
  const int page = min(max(tab[j], 0), num_pages - 1);
  return (((size_t)page * nkv + h) * bt + (pos - j * bt)) * hd + d;
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

template <typename T, int HD>
__global__ void __launch_bounds__(D_NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
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
        const size_t off = page_offset(tab, pos, bt, nkv, h, num_pages,
                                       HD, d);
        kx = to_f32(kp[off]);
        vx = to_f32(vp[off]);
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

template <typename T, int HD>
__global__ void __launch_bounds__(P_NT)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp,
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
        const size_t off = page_offset(tab, pos, bt, nkv, h, num_pages,
                                       HD, d);
        kx = to_f32(kp[off]);
        vx = to_f32(vp[off]);
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

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp,
                          const int* tables, const int* kv_lens,
                          const float* slopes, void* out, int b, int nh,
                          int nkv, int bt, int num_pages, int W,
                          float scale, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<HD>();
  auto kern = paged_decode_kernel<T, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nkv, b);
  kern<<<grid, D_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, kv_lens, slopes,
      static_cast<T*>(out), nh, nkv, bt, num_pages, W, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_prefill(const void* q, const void* kp, const void* vp,
                           const int* tables, const int* starts,
                           const float* slopes, void* out, int b, int chunk,
                           int nh, int nkv, int bt, int num_pages, int W,
                           float scale, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<HD>();
  auto kern = paged_prefill_kernel<T, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int rows = chunk * (nh / nkv);
  dim3 grid((rows + P_BR - 1) / P_BR, nkv, b);
  kern<<<grid, P_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, starts, slopes,
      static_cast<T*>(out), chunk, nh, nkv, bt, num_pages, W, scale);
  return cudaGetLastError();
}

bool shapes_ok(int b, int chunk, int nh, int nkv, int bt, int num_pages,
               int W) {
  return b > 0 && chunk > 0 && nkv > 0 && nh % nkv == 0 && bt > 0 &&
         num_pages > 0 && W > 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
// q/out [b, 1, nh, hd]; pages [num_pages, nkv, bt, hd]; tables [b, W]
// int32; kv_lens [b] int32; slopes [nh] float32 ALiBi slopes or null.
// Returns a cudaError_t; the caller raises on anything but 0.
int paged_decode_fwd(const void* q, const void* k_pages,
                     const void* v_pages, const void* tables,
                     const void* kv_lens, const void* slopes, void* out,
                     int b, int nh, int nkv, int hd, int bt, int num_pages,
                     int W, float scale, int dtype, void* stream) {
  if (!shapes_ok(b, 1, nh, nkv, bt, num_pages, W) || nh / nkv > D_GMAX)
    return (int)cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(kv_lens);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PD_CASE(T, HD)                                                    \
  return (int)launch_decode<T, HD>(q, k_pages, v_pages, tab, lens, sl, out, \
                                   b, nh, nkv, bt, num_pages, W, scale, st)
  if (dtype == 0 && hd == 64) PD_CASE(float, 64);
  if (dtype == 0 && hd == 128) PD_CASE(float, 128);
  if (dtype == 1 && hd == 64) PD_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PD_CASE(__nv_bfloat16, 128);
#undef PD_CASE
  return (int)cudaErrorInvalidValue;
}

// As paged_decode_fwd, with q/out [b, chunk, nh, hd] and starts [b]
// int32: the position of each row's first chunk token.
int paged_prefill_fwd(const void* q, const void* k_pages,
                      const void* v_pages, const void* tables,
                      const void* starts, const void* slopes, void* out,
                      int b, int chunk, int nh, int nkv, int hd, int bt,
                      int num_pages, int W, float scale, int dtype,
                      void* stream) {
  if (!shapes_ok(b, chunk, nh, nkv, bt, num_pages, W))
    return (int)cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* st0 = static_cast<const int*>(starts);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PP_CASE(T, HD)                                                     \
  return (int)launch_prefill<T, HD>(q, k_pages, v_pages, tab, st0, sl, out, \
                                    b, chunk, nh, nkv, bt, num_pages, W,    \
                                    scale, st)
  if (dtype == 0 && hd == 64) PP_CASE(float, 64);
  if (dtype == 0 && hd == 128) PP_CASE(float, 128);
  if (dtype == 1 && hd == 64) PP_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PP_CASE(__nv_bfloat16, 128);
#undef PP_CASE
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
