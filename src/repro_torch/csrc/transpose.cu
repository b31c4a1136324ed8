// K4 transpose_h100: B[N,M] = A[M,N]^T for elements of 2 or 4 bytes, moved
// as raw bits (bit-exact for f32 and bf16).
//
// Replaces the TPU kernel pallas_transpose (src/repro/kernels/transpose.py,
// _tr_kernel_cached / _tr_kernel_uncached), the paper's Fig. 8 / Table 3.
// The TPU pads A to whole (bm, s*bn) tiles and slices the result back; here
// the ragged edge is masked in the kernel and nothing is padded.
//
// Bound on the card: no arithmetic, so bound by bytes: 2 * M * N * size over
// 3.35 TB/s.  HBM3 reaches that rate only with some 25-40 KB of loads in
// flight an SM and with whole 32-byte sectors written, so the design moves
// up to 16 bytes an access on both sides and keeps a block small enough that
// several share an SM.
//
// Layout: grid (ceil(M/bm), ceil(N/(s*bn)), E), bm*bn threads a block (bm,
// bn and s powers of two, bn >= 32, bm*bn <= 1024); past 65,535 column
// blocks, one launch for each 65,535 (kMaxGridY).  A block owns the tile
// A[e][i0 : i0+bm, j0 : j0+s*bn] and its image B[e][j0.., i0..], e =
// blockIdx.z: the 2-D entry runs E = 1, the batched entry (a mixture of
// experts' weights and activations, B[e] = A[e]^T for A [E, M, N]) one
// expert a z, as K1's batched entry does.
//   cached (the paper's case 1 and, at s = 1, case 2):
//     - loads: thread (ty, tx) owns the run of s neighbouring elements
//       A[i0+ty, j0 + tx*s ..], read in accesses of lw bytes, all issued
//       before the barrier (16 bytes a thread at bf16 and s 8; a warp then
//       reads 512 neighbouring bytes of one row);
//     - staging at the element's width: bm * s*bn * size bytes, no padding
//       (under the family's smem counter 4*bm*(s*bn+1)).  Each tile row is
//       cut into 16-byte chunks and chunk c of row r is kept at c ^ swz(r):
//       one warp step of the transposed read below touches G rows (sv
//       apart) of 32/G neighbouring columns, and swz sends those G rows to
//       distinct banks, while a row's own chunks only change places;
//     - one barrier, then each store access gathers sv = sw/size elements
//       of one tile column (tile rows r0 .. r0+sv-1, one swizzle) and
//       writes them as one sw-byte access along a row of B: 16 bytes where
//       bm >= 16/size, narrower for the small bm of the domain.  All index
//       arithmetic is shifts and masks of the powers of two.
//     A 1024-thread block leaves room for two on an SM, a 256-thread one
//     for eight, so one block's loads overlap another's stores; the napkin
//     (kernels/transpose.py) picks the leaf.
//   uncached (the paper's case 3): the same loads, then each element stored
//     straight to its transposed place B[j, i]: stores M elements apart.
// Access widths: lw (loads) and sw (stores) are chosen per launch by the
// entry point (access_bytes): the widest power of two up to 16 bytes, and
// up to the thread's run (lw) or the tile's bm rows (sw), that divides the
// base address, the row's bytes (N*size for A, M*size for B) and the
// expert's stride (M*N*size, a multiple of either row: it adds no
// constraint, but says why expert e's rows start where expert 0's do).  A
// view
// one element into its buffer, or a row of 4097 bf16, takes narrower
// accesses, down to one element; an access is then always whole or wholly
// past the ragged edge.
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// A thread's run of S elements of one tile row, in 32-bit words (element k
// of a bf16 run in bits 16*(k&1) of word k/2).
template <typename T, int S>
struct Run {
  static constexpr int kBytes = S * static_cast<int>(sizeof(T));
  uint32_t w[(kBytes + 3) / 4];
};

// Loads a run from src, of which `left` elements lie before the row's end,
// in accesses of lw bytes, into a run of zeros; what lies past the end
// stays 0.
template <typename T, int S>
__device__ __forceinline__ void load_run(Run<T, S>& run, const T* src,
                                         int left, int lw) {
  constexpr int E = sizeof(T), kB = Run<T, S>::kBytes;
  if constexpr (kB >= 16) {
    if (lw == 16) {
#pragma unroll
      for (int q = 0; q < kB / 16; ++q)
        if (q * (16 / E) < left) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
          run.w[4 * q] = v.x;
          run.w[4 * q + 1] = v.y;
          run.w[4 * q + 2] = v.z;
          run.w[4 * q + 3] = v.w;
        }
      return;
    }
  }
  if constexpr (kB >= 8) {
    if (lw == 8) {
#pragma unroll
      for (int q = 0; q < kB / 8; ++q)
        if (q * (8 / E) < left) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + q);
          run.w[2 * q] = v.x;
          run.w[2 * q + 1] = v.y;
        }
      return;
    }
  }
  if constexpr (kB >= 4) {
    if (lw == 4) {
#pragma unroll
      for (int q = 0; q < kB / 4; ++q)
        if (q * (4 / E) < left)
          run.w[q] = __ldg(reinterpret_cast<const unsigned int*>(src) + q);
      return;
    }
  }
  if constexpr (E == 2) {                         // lw == 2: one element
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k < left)
        run.w[k >> 1] |= static_cast<uint32_t>(__ldg(
                             reinterpret_cast<const unsigned short*>(src) + k))
                         << (16 * (k & 1));
  }
}

// Element k of a run, as raw bits.
template <typename T, int S>
__device__ __forceinline__ T run_element(const Run<T, S>& run, int k) {
  if constexpr (sizeof(T) == 2)
    return static_cast<T>(run.w[k >> 1] >> (16 * (k & 1)));
  else
    return static_cast<T>(run.w[k]);
}

// Stores a run at byte column c0b of a staged tile row, chunk c at c ^ swz.
template <typename T, int S>
__device__ __forceinline__ void stage_run(unsigned char* row, int c0b,
                                          int swz, const Run<T, S>& run) {
  constexpr int kB = Run<T, S>::kBytes;
  if constexpr (kB >= 16) {
#pragma unroll
    for (int q = 0; q < kB / 16; ++q)
      *reinterpret_cast<uint4*>(row + ((((c0b >> 4) + q) ^ swz) << 4)) =
          make_uint4(run.w[4 * q], run.w[4 * q + 1], run.w[4 * q + 2],
                     run.w[4 * q + 3]);
  } else {
    unsigned char* p = row + (((c0b >> 4) ^ swz) << 4) + (c0b & 15);
    if constexpr (kB == 8)
      *reinterpret_cast<uint2*>(p) = make_uint2(run.w[0], run.w[1]);
    else if constexpr (kB == 4)
      *reinterpret_cast<uint32_t*>(p) = run.w[0];
    else
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(run.w[0]);
  }
}

// sw bytes from the words v to dst.
__device__ __forceinline__ void put(void* dst, const uint32_t (&v)[4],
                                    int sw) {
  if (sw == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  else if (sw == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  else if (sw == 4)
    *reinterpret_cast<uint32_t*>(dst) = v[0];
  else
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v[0]);
}

// lbm, lbn: log2 of bm and bn; lw, sw: load and store access bytes; cb0: the
// launch's first column block.
template <typename T, int S>
__global__ void __launch_bounds__(1024)
    transpose_cached(const T* __restrict__ A, T* __restrict__ B, int M, int N,
                     int lbm, int lbn, int lw, int sw, int cb0) {
  extern __shared__ __align__(16) unsigned char tile[];   // [bm][S*bn]
  constexpr int E = sizeof(T);
  constexpr int kLogChunksAStep = E == 2 ? 2 : 3;   // 32 elements, in chunks
  const int W = S << lbn;                            // tile columns
  const int row_bytes = W * E;                       // a multiple of 64
  const int i0 = blockIdx.x << lbm;
  const int j0 = (cb0 + blockIdx.y) * W;
  A += (size_t)blockIdx.z * M * N;                   // expert e's A and B
  B += (size_t)blockIdx.z * M * N;
  const int tx = threadIdx.x & ((1 << lbn) - 1);
  const int ty = threadIdx.x >> lbn;
  // a store access covers sv = 2^lsv tile rows, a B row 2^lg accesses; a
  // warp step reads 2^lg rows (sv apart) of 32 / 2^lg columns, that is
  // 2^(kLogChunksAStep - lg) chunks a row: swz(r) spaces the rows by it
  const int lsv = ilog2(sw / E);
  const int lg = lbm - lsv;
  const int lstep = max(kLogChunksAStep - lg, 0);
  const int cmask = min(8, row_bytes >> 4) - 1;

  Run<T, S> run = {};
  const int c0 = tx * S;
  if (i0 + ty < M)
    load_run(run, A + (size_t)(i0 + ty) * N + j0 + c0, N - j0 - c0, lw);
  stage_run(tile + ty * row_bytes, c0 * E, ((ty >> lsv) << lstep) & cmask,
            run);
  __syncthreads();

  const int accesses = W << lg;                      // store accesses a tile
  const int nthreads = 1 << (lbm + lbn);
  for (int v = threadIdx.x; v < accesses; v += nthreads) {
    const int c = v >> lg;                           // B row j0 + c
    const int r0 = (v & ((1 << lg) - 1)) << lsv;     // B column i0 + r0
    if (j0 + c >= N || i0 + r0 >= M) continue;
    const int swz = ((r0 >> lsv) << lstep) & cmask;
    const unsigned char* p = tile + r0 * row_bytes +
                             ((((c * E) >> 4) ^ swz) << 4) + ((c * E) & 15);
    uint32_t out[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16 / E; ++k) {
      if (k < (sw / E)) {
        if constexpr (E == 2)
          out[k >> 1] |= static_cast<uint32_t>(*reinterpret_cast<
                             const uint16_t*>(p + k * row_bytes))
                         << (16 * (k & 1));
        else
          out[k] = *reinterpret_cast<const uint32_t*>(p + k * row_bytes);
      }
    }
    put(B + (size_t)(j0 + c) * M + i0 + r0, out, sw);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(1024)
    transpose_uncached(const T* __restrict__ A, T* __restrict__ B, int M,
                       int N, int lbm, int lbn, int lw, int cb0) {
  const int i = (blockIdx.x << lbm) + (threadIdx.x >> lbn);
  if (i >= M) return;
  A += (size_t)blockIdx.z * M * N;
  B += (size_t)blockIdx.z * M * N;
  const int j0 = ((cb0 + blockIdx.y) * S << lbn) +
                 (threadIdx.x & ((1 << lbn) - 1)) * S;
  Run<T, S> run = {};
  load_run(run, A + (size_t)i * N + j0, N - j0, lw);
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (j0 + k < N) B[(size_t)(j0 + k) * M + i] = run_element(run, k);
}

template <typename T, int S>
cudaError_t launch(const void* a, void* b, int E, int M, int N, int lbm,
                   int lbn, bool cached, int lw, int sw,
                   cudaStream_t stream) {
  const T* src = static_cast<const T*>(a);
  T* dst = static_cast<T*>(b);
  // at most 1024 threads of at most 8 elements of 4 bytes: 32 KB, under the
  // 48 KB a block gets without opting in
  const size_t smem = cached ? ((size_t)S << (lbm + lbn)) * sizeof(T) : 0;
  const long long wide = (long long)S << lbn;
  const long long col_blocks = ((long long)N + wide - 1) / wide;
  for (long long cb0 = 0; cb0 < col_blocks; cb0 += kMaxGridY) {
    const long long cols = col_blocks - cb0;
    dim3 grid((unsigned)(((long long)M + (1 << lbm) - 1) >> lbm),
              (unsigned)(cols < kMaxGridY ? cols : kMaxGridY), (unsigned)E);
    const int threads = 1 << (lbm + lbn);
    if (cached)
      transpose_cached<T, S><<<grid, threads, smem, stream>>>(
          src, dst, M, N, lbm, lbn, lw, sw, (int)cb0);
    else
      transpose_uncached<T, S><<<grid, threads, 0, stream>>>(
          src, dst, M, N, lbm, lbn, lw, (int)cb0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_s(const void* a, void* b, int E, int M, int N, int lbm,
                     int lbn, int s, bool cached, int lw, int sw,
                     cudaStream_t st) {
  switch (s) {
    case 1: return launch<T, 1>(a, b, E, M, N, lbm, lbn, cached, lw, sw, st);
    case 2: return launch<T, 2>(a, b, E, M, N, lbm, lbn, cached, lw, sw, st);
    case 4: return launch<T, 4>(a, b, E, M, N, lbm, lbn, cached, lw, sw, st);
    case 8: return launch<T, 8>(a, b, E, M, N, lbm, lbn, cached, lw, sw, st);
  }
  return cudaErrorInvalidValue;
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

int log2i(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The widest access, a power of two from one element up to min(16, cap)
// bytes, that divides the address, the row's bytes and the expert's
// stride: every row of every expert then starts on such a boundary, and an
// access is whole or wholly past the row's end.
int access_bytes(const void* p, long long row_bytes, long long stride,
                 int esize, int cap) {
  int w = 16;
  while (w > esize && (w > cap || reinterpret_cast<uintptr_t>(p) % w ||
                       row_bytes % w || stride % w))
    w >>= 1;
  return w;
}

}  // namespace

// Formats it takes (kernels/transpose.py: format_error mirrors these
// checks): E in 1..65,535, M, N > 0, bm, bn and s powers of two, bn >= 32,
// bm, bn <= 1024, bm*bn <= 1024, s <= 8, elements of 2 or 4 bytes.
static int run(const void* a, void* b, int E, int M, int N, int bm, int bn,
               int s, int cached, int esize, void* stream) {
  if (E <= 0 || E > kMaxGridY || M <= 0 || N <= 0 || !pow2(bm) ||
      !pow2(bn) || bn < 32 || bm > 1024 || bn > 1024 || bm * bn > 1024 ||
      !pow2(s) || s > 8 || (esize != 2 && esize != 4))
    return cudaErrorInvalidValue;
  const long long stride = (long long)M * N * esize;
  // an uncached launch stores single elements
  const int lw = access_bytes(a, (long long)N * esize, stride, esize,
                              s * esize);
  const int sw = access_bytes(b, (long long)M * esize, stride, esize,
                              cached ? bm * esize : esize);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lbm = log2i(bm), lbn = log2i(bn);
  if (esize == 4)
    return launch_s<uint32_t>(a, b, E, M, N, lbm, lbn, s, cached, lw, sw, st);
  return launch_s<uint16_t>(a, b, E, M, N, lbm, lbn, s, cached, lw, sw, st);
}

// B [N, M] = A [M, N]^T; esize: bytes an element (2 or 4).
extern "C" int transpose_h100_launch(const void* a, void* b, int M, int N,
                                     int bm, int bn, int s, int cached,
                                     int esize, void* stream) {
  return run(a, b, 1, M, N, bm, bn, s, cached, esize, stream);
}

// B [E, N, M]: B[e] = A[e]^T for A [E, M, N], one launch.
extern "C" int transpose_h100_batched_launch(const void* a, void* b, int E,
                                             int M, int N, int bm, int bn,
                                             int s, int cached, int esize,
                                             void* stream) {
  return run(a, b, E, M, N, bm, bn, s, cached, esize, stream);
}
