// K4 transpose_h100: B[N,M] = A[M,N]^T for elements of 2 or 4 bytes, moved
// as raw bits (bit-exact for f32 and bf16).
//
// Replaces the TPU kernel pallas_transpose (src/repro/kernels/transpose.py,
// _tr_kernel_cached / _tr_kernel_uncached), the paper's Fig. 8 / Table 3.
// The TPU pads A to whole (bm, s*bn) tiles and slices the result back; here
// the ragged edge is masked in the kernel and nothing is padded.
//
// Layout: grid (ceil(M/bm), ceil(N/(s*bn))), bm*bn threads a block; past
// 65,535 column blocks, one launch for each 65,535 (kMaxGridY).  A block
// owns the tile A[i0 : i0+bm, j0 : j0+s*bn] and its image B[j0.., i0..].
//   cached   : the classic shared-memory transpose (the paper's case 1 and,
//              at s = 1, case 2).  Thread (ty, tx) reads A[i0+ty, j0+tx+t*bn],
//              t < s: a warp reads 32 neighbouring elements of one row.  The
//              tile is stored in shared memory as 32-bit words (both element
//              sizes) with one padding column, so that the column reads that
//              follow do not hit one bank 32 times.  After a barrier, element
//              e of the block's image goes to B row e / bm, column e % bm: a
//              warp writes bm neighbouring elements of each output row.
//   uncached : each thread writes its elements straight to their transposed
//              place, B[j, i] = A[i, j]: the loads are coalesced, the stores
//              M elements apart (the paper's case 3).
// Shared bytes of the cached kernel: 4 * bm * (s*bn + 1), which is the
// family's smem counter (kernels/transpose.py).
//
// Bound on the card: no arithmetic, so bound by bytes: 2 * M * N * size over
// 3.35 TB/s.  The cached design keeps both the reads and the writes coalesced
// at the cost of one trip through shared memory and a barrier a tile; vector
// accesses and TMA are later work.
#include <stdint.h>

#include "common.cuh"

template <typename E>
__global__ void transpose_cached(const E* __restrict__ A, E* __restrict__ B,
                                 int M, int N, int bm, int bn, int s,
                                 int cb0) {
  extern __shared__ uint32_t tile[];               // [bm][s*bn + 1]
  const int wide = s * bn;
  const int pitch = wide + 1;
  const int tx = threadIdx.x % bn;
  const int ty = threadIdx.x / bn;
  const int i0 = blockIdx.x * bm;
  const int j0 = (cb0 + blockIdx.y) * wide;
  const int nthreads = bm * bn;
  if (i0 + ty < M) {
    const E* arow = A + (size_t)(i0 + ty) * N;
    for (int t = 0; t < s; ++t) {
      const int c = tx + t * bn;
      if (j0 + c < N) tile[ty * pitch + c] = arow[j0 + c];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < wide * bm; e += nthreads) {
    const int r = e / bm, c = e % bm;             // B row j0+r, column i0+c
    if (j0 + r < N && i0 + c < M)
      B[(size_t)(j0 + r) * M + i0 + c] = static_cast<E>(tile[c * pitch + r]);
  }
}

template <typename E>
__global__ void transpose_uncached(const E* __restrict__ A, E* __restrict__ B,
                                   int M, int N, int bm, int bn, int s,
                                   int cb0) {
  const int tx = threadIdx.x % bn;
  const int ty = threadIdx.x / bn;
  const int i = blockIdx.x * bm + ty;
  if (i >= M) return;
  const int j0 = (cb0 + blockIdx.y) * (s * bn) + tx;
  for (int t = 0; t < s; ++t) {
    const int j = j0 + t * bn;
    if (j < N) B[(size_t)j * M + i] = A[(size_t)i * N + j];
  }
}

template <typename E>
static cudaError_t launch(const void* a, void* b, int M, int N, int bm, int bn,
                          int s, bool cached, cudaStream_t stream) {
  const E* src = static_cast<const E*>(a);
  E* dst = static_cast<E*>(b);
  auto kernel = cached ? transpose_cached<E> : transpose_uncached<E>;
  const size_t smem =
      cached ? sizeof(uint32_t) * (size_t)bm * ((size_t)s * bn + 1) : 0;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long col_blocks = ((long long)N + s * bn - 1) / (s * bn);
  for (long long cb0 = 0; cb0 < col_blocks; cb0 += kMaxGridY) {
    const long long cols = col_blocks - cb0;
    dim3 grid((M + bm - 1) / bm, (unsigned)(cols < kMaxGridY ? cols
                                                             : kMaxGridY));
    kernel<<<grid, bm * bn, smem, stream>>>(src, dst, M, N, bm, bn, s,
                                            (int)cb0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// esize: bytes an element (2 or 4).
extern "C" int transpose_h100_launch(const void* a, void* b, int M, int N,
                                     int bm, int bn, int s, int cached,
                                     int esize, void* stream) {
  if (M <= 0 || N <= 0 || bm <= 0 || bn <= 0 || s <= 0 || bm * bn > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (esize == 4) return launch<uint32_t>(a, b, M, N, bm, bn, s, cached, st);
  if (esize == 2) return launch<uint16_t>(a, b, M, N, bm, bn, s, cached, st);
  return cudaErrorInvalidValue;
}
