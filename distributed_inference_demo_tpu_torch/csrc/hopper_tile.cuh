// Warp-level building blocks for the port's Hopper (sm_90a) attention
// kernels: asynchronous 16-byte (and 4-byte) global-to-shared copies,
// the bf16 tensor-core product mma.sync.m16n8k16 with f32 accumulation,
// the packing of two f32 values into one bf16x2 operand register, and
// Q's A fragments held in registers or read from shared memory (QFrags).
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with gid = lane / 4 and tig = lane % 4:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a[0] = A[gid][2 tig .. +1]      a[1] = A[gid + 8][2 tig .. +1]
//     a[2] = A[gid][2 tig + 8 .. +1]  a[3] = A[gid + 8][2 tig + 8 .. +1]
//   B (16 x 8, k x n), two registers:
//     b0 = B[2 tig .. +1][gid]        b1 = B[2 tig + 8 .. +1][gid]
//   C/D (16 x 8, f32), four values:
//     c[0..1] = C[gid][2 tig .. +1]   c[2..3] = C[gid + 8][2 tig .. +1]
// So the accumulator of two neighbouring n-tiles (16 columns) is, packed
// to bf16, exactly the A operand of the next product over those 16
// columns: a softmax's probabilities feed P V without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper_tile {

// Copy 16 bytes global -> shared, bypassing L1; with pred false the 16
// destination bytes are zero-filled and nothing is read (src must still
// be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// The same for 4 bytes (through L1: cg takes only 16).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += A B: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, one register each; lane L
// gives the address of row L % 8 of matrix L / 8 (16-byte aligned).  A
// lane receives row gid, columns 2 tig .. +1 of each matrix, or with
// .trans row 2 tig .. +1 of column gid: a B operand either way.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two f32 values rounded to bf16 and packed, lo in the low half (the
// element at the lower index of the fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a warp's 16 query rows over HD head columns, for
// S = Q K^T.  Up to HD = 128 a lane holds them all (HD / 4 registers)
// for the whole key loop.  At HD = 256 it would hold 64 of them beside
// the 128 of its f32 accumulator, over what a thread can keep without
// spilling, so the fragments of each 16-column k step are read again
// from the rows' tile in shared memory (row pitch PITCH elements) by
// ldmatrix where they are used.
template <int HD, int PITCH>
struct QFrags {
  static constexpr bool HELD = HD <= 128;
  uint32_t a[HELD ? HD / 16 : 1][4];
  const __nv_bfloat16* tile;   // the warp's 16 rows in shared memory

  // matrices (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7,
  // cols 8-15), (rows 8-15, cols 8-15) of head columns [16 kk, 16 kk + 16)
  __device__ __forceinline__ void read(int kk, uint32_t (&r)[4]) const {
    const int lane = threadIdx.x & 31;
    const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
    ldmatrix_x4(r, tile + row * PITCH + kk * 16 + ((lane >> 4) << 3));
  }

  // Held fragments: read every k step's from the tile once.
  __device__ __forceinline__ void hold() {
    if constexpr (HELD) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) read(kk, a[kk]);
    }
  }

  __device__ __forceinline__ void get(int kk, uint32_t (&r)[4]) const {
    if constexpr (HELD) {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = a[kk][e];
    } else {
      read(kk, r);
    }
  }
};

}  // namespace hopper_tile
