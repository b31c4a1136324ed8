// K5 matadd_h100: C[M,N] = A[M,N] + B[M,N], all f32 or all bf16.
//
// Replaces the TPU kernel pallas_matadd (src/repro/kernels/matadd.py,
// _add_kernel), the paper's introductory example (Fig. 1/2).  The TPU pads A
// and B to whole (bm, s*bn) tiles with jnp.pad and slices the sum back: a
// full extra read and write of the data.  Here the ragged edge is masked in
// the kernel and nothing is padded.
//
// Layout: grid (ceil(M/bm), ceil(N/(s*bn))), bm*bn threads a block; past
// 65,535 column blocks, one launch for each 65,535 (kMaxGridY).
// Thread (ty, tx) owns the paper's grain: the s elements C[i0+ty, j0+tx+t*bn],
// t < s, spaced bn apart (the source plan has s = 2, the paper's two halves;
// reduce_granularity gives s = 1), so a warp's loads and stores cover 32
// neighbouring elements of one row.
//
// bf16 adds in f32 and rounds once to bf16, as `a + b` does on the card, so
// the kernel equals the plain version bit for bit in both types.
//
// Bound on the card: one add for every 12 bytes (f32) moved, so bound by
// bytes: 3 * M * N * size bytes over 3.35 TB/s.  The design reads each input
// once and writes each output once with coalesced accesses and no shared
// memory; vector loads (16 bytes a thread) and a persistent grid are later
// work.
#include "common.cuh"

template <typename T>
__global__ void matadd_kernel(const T* __restrict__ A, const T* __restrict__ B,
                              T* __restrict__ C, int M, int N, int bm, int bn,
                              int s, int cb0) {
  const int tx = threadIdx.x % bn;
  const int ty = threadIdx.x / bn;
  const int row = blockIdx.x * bm + ty;
  if (row >= M) return;
  const size_t base = (size_t)row * N;
  const int col0 = (cb0 + blockIdx.y) * (s * bn) + tx;
  for (int t = 0; t < s; ++t) {
    const int col = col0 + t * bn;
    if (col < N)
      from_f32(to_f32(A[base + col]) + to_f32(B[base + col]), &C[base + col]);
  }
}

template <typename T>
static cudaError_t launch(const void* a, const void* b, void* c, int M, int N,
                          int bm, int bn, int s, cudaStream_t stream) {
  const long long col_blocks = ((long long)N + s * bn - 1) / (s * bn);
  for (long long cb0 = 0; cb0 < col_blocks; cb0 += kMaxGridY) {
    const long long cols = col_blocks - cb0;
    dim3 grid((M + bm - 1) / bm, (unsigned)(cols < kMaxGridY ? cols
                                                             : kMaxGridY));
    matadd_kernel<T><<<grid, bm * bn, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), M, N, bm, bn, s, (int)cb0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" int matadd_h100_launch(const void* a, const void* b, void* c, int M,
                                  int N, int bm, int bn, int s, int elem,
                                  void* stream) {
  if (M <= 0 || N <= 0 || bm <= 0 || bn <= 0 || s <= 0 || bm * bn > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == ELEM_F32) return launch<float>(a, b, c, M, N, bm, bn, s, st);
  if (elem == ELEM_BF16)
    return launch<__nv_bfloat16>(a, b, c, M, N, bm, bn, s, st);
  return cudaErrorInvalidValue;
}
