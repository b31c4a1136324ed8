// Tile helpers of the attention kernels on the tensor cores, shared by K2
// (flash_attention.cu) and the bf16 body of K2b (flash_attention_bwd.cu):
// XOR-swizzled [row][D] tiles in shared memory filled by 16-byte cp.async
// (or element by element where an operand breaks 16-byte alignment), the
// score product S = A B^T of a warp's 16 rows by mma.sync from two such
// tiles, and the product O += P V with P from the accumulator fragments
// and V by ldmatrix.trans.
#pragma once

#include "common.cuh"

namespace {

// Physical 16-byte chunk of logical chunk c in row r (rows are >= 8 chunks).
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

// Wait until at most stages - 2 groups of this thread are pending.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  switch (stages) {
    case 2: cp_async_wait<0>(); break;
    case 3: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// Rows [0, rows) of a [rows][D] tile, swizzled; row r comes from row_ptr(r)
// (nullptr: zero), columns at or past d are zero.
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void load_rows(T* s, int rows, int d, bool vec,
                                          const T* any, RowPtr row_ptr) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int W = D / EPC;                   // chunks a row, a power of 2
  if (vec) {
    for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
      const int r = i / W, c = i % W;
      const T* src = row_ptr(r);
      const bool ok = src != nullptr && c * EPC < d;
      cp_async16(s + (r * W + swz(r, c)) * EPC, ok ? src + c * EPC : any, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, e = i % D;
      const T* src = row_ptr(r);
      s[(r * W + swz(r, e / EPC)) * EPC + e % EPC] =
          (src != nullptr && e < d) ? src[e] : T(0.f);
    }
  }
}

// Fragments of m16n8k16 (g = lane / 4, q = lane % 4): a thread holds rows g
// and g + 8 of its warp's 16, and of each n8 tile of S (keys) or O (dims)
// the columns 2q and 2q + 1: x[t][0..1] on row g, x[t][2..3] on row g + 8.
// A warp scores the nt n8 tiles of keys kofs.. of the kv tile (its slice;
// nt even, at most BKV / 8).

// bf16: S[16][8 nt] = Q K^T from the [bq][D] Q tile and the [BKV][D] K
// tile (nt <= NTMAX).  Fragments load ahead of their products: each k step's
// Q fragment and K fragments, and for a warp's slice of two n8 tiles (decode)
// four k steps' at once, so that the products wait on one another and not on
// each load.
template <int D, int BKV, int NTMAX>
__device__ __forceinline__ void scores(const __nv_bfloat16* Ks, int kofs,
                                       int nt, int w0,
                                       const __nv_bfloat16* Qs, int lane,
                                       float (&s)[BKV / 8][4]) {
  constexpr int W = D / 8, KB = NTMAX == 2 ? 4 : 1;
  const int j = lane >> 3, rr = lane & 7;
  const int qrow = w0 + (j & 1) * 8 + rr;
#pragma unroll
  for (int k0 = 0; k0 < D / 16; k0 += KB) {
    unsigned a[KB][4], b[KB][NTMAX / 2][4];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int kk = k0 + u;
      ldmatrix_x4(a[u], Qs + (qrow * W + swz(qrow, kk * 2 + (j >> 1))) * 8);
#pragma unroll
      for (int t = 0; t < NTMAX; t += 2) {
        if (t >= nt) break;
        const int key = kofs + (t + (j >> 1)) * 8 + rr;
        ldmatrix_x4(b[u][t / 2],
                    Ks + (key * W + swz(key, kk * 2 + (j & 1))) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < KB; ++u)
#pragma unroll
      for (int t = 0; t < NTMAX; t += 2) {
        if (t >= nt) break;
        mma_bf16(s[t], a[u], b[u][t / 2][0], b[u][t / 2][1]);
        mma_bf16(s[t + 1], a[u], b[u][t / 2][2], b[u][t / 2][3]);
      }
  }
}

// bf16: O[16][D] += P V over the warp's keys, P from the score fragments
// (rounded to bf16), V by ldmatrix.trans from the [BKV][D] tile, up to four
// fragment loads ahead of their products.
template <int D, int BKV>
__device__ __forceinline__ void pv(const float (&p)[BKV / 8][4],
                                   const __nv_bfloat16* Vs, int kofs, int nt,
                                   float*, int lane, float (&acc)[D / 8][4]) {
  constexpr int W = D / 8, PAIRS = D / 16, BATCH = PAIRS < 4 ? PAIRS : 4;
  const int j = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    if (2 * kk >= nt) break;
    const unsigned a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const int key = kofs + kk * 16 + (j & 1) * 8 + rr;
#pragma unroll
    for (int c0 = 0; c0 < PAIRS; c0 += BATCH) {
      unsigned b[BATCH][4];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        ldmatrix_x4_trans(
            b[u], Vs + (key * W + swz(key, 2 * (c0 + u) + (j >> 1))) * 8);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        mma_bf16(acc[2 * (c0 + u)], a, b[u][0], b[u][1]);
        mma_bf16(acc[2 * (c0 + u) + 1], a, b[u][2], b[u][3]);
      }
    }
  }
}

// Two neighbouring columns (col even) of an output row: one 4- or 8-byte
// store where d is even, else element by element.
template <typename T>
__device__ __forceinline__ void store2(T* o, int col, int d, float x,
                                       float y) {
  if ((d & 1) == 0 && col + 1 < d) {
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(o + col) =
          __floats2bfloat162_rn(x, y);
    else
      *reinterpret_cast<float2*>(o + col) = make_float2(x, y);
  } else {
    if (col < d) from_f32(x, o + col);
    if (col + 1 < d) from_f32(y, o + col + 1);
  }
}

}  // namespace
