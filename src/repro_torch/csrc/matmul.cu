// K1 matmul_h100: C[M,N] (f32) = A[M,K] @ B[K,N], A and B both f32 or bf16.
//
// Replaces the TPU kernel pallas_matmul (src/repro/kernels/matmul.py,
// _mm_kernel_cached / _mm_kernel_uncached).  The TPU walks k as the last,
// sequential grid axis and carries the sum in VMEM scratch; blocks on the card
// run in no order, so here the k loop runs inside the block and the sum lives
// in registers.
//
// Layout: grid (ceil(M/bm), ceil(N/(s*bn))), bm*bn threads a block.  Thread
// (ty, tx) owns the paper's grain: the s outputs C[i0+ty, j0+tx+t*bn],
// t < s, spaced bn apart, so a warp's stores and B loads are coalesced.
//   cached   : each k step stages an A tile [bm x bk] and a B tile
//              [bk x s*bn] in dynamic shared memory (the paper's cache(a)).
//   uncached : operands are read from global memory directly (L1/L2 only).
// Ragged edges are masked in the kernel: nothing is padded.
//
// Bound on the card: at the serving shapes (M = 4..32 rows against weight
// matrices of 4096 x 4096..128256) the product reads every weight byte once
// and does 2*M flops per weight, far below the ~295 flop/byte at which the
// H100's bf16 rate would bind, so it is bound by bytes.  The design reads
// each weight once per row block (bm >= M keeps it to one pass) with
// coalesced loads; it does not use the tensor cores (wgmma) or TMA yet.
// What holds it far from that bound at decode is parallelism: the grid has
// only M*N/s working threads, each walking all of K in order, so at M = 1..4
// a few thousand threads must keep 3.35 TB/s of loads in flight.  Splitting
// K across blocks (a second pass or atomics to combine) is the next step.
#include "common.cuh"

template <typename T, int S, bool CACHED>
__global__ void matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                              float* __restrict__ C, int M, int N, int K,
                              int bm, int bn, int bk) {
  extern __shared__ unsigned char smem_raw[];
  const int tx = threadIdx.x % bn;
  const int ty = threadIdx.x / bn;
  const int row = blockIdx.x * bm + ty;
  const int col0 = blockIdx.y * (S * bn) + tx;
  float acc[S];
#pragma unroll
  for (int t = 0; t < S; ++t) acc[t] = 0.f;

  if (CACHED) {
    T* As = reinterpret_cast<T*>(smem_raw);          // [bm][bk]
    T* Bs = As + bm * bk;                            // [bk][S*bn]
    const int nthreads = bm * bn;
    const int wide = S * bn;
    const int arow0 = blockIdx.x * bm;
    const int bcol0 = blockIdx.y * wide;
    for (int k0 = 0; k0 < K; k0 += bk) {
      for (int i = threadIdx.x; i < bm * bk; i += nthreads) {
        const int r = i / bk, c = i % bk;
        const int gr = arow0 + r, gc = k0 + c;
        As[i] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : T(0.f);
      }
      for (int i = threadIdx.x; i < bk * wide; i += nthreads) {
        const int r = i / wide, c = i % wide;
        const int gr = k0 + r, gc = bcol0 + c;
        Bs[i] = (gr < K && gc < N) ? B[(size_t)gr * N + gc] : T(0.f);
      }
      __syncthreads();
      const int kn = min(bk, K - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float a = to_f32(As[ty * bk + kk]);
#pragma unroll
        for (int t = 0; t < S; ++t)
          acc[t] += a * to_f32(Bs[kk * wide + tx + t * bn]);
      }
      __syncthreads();
    }
  } else if (row < M) {
    const T* arow = A + (size_t)row * K;
    for (int k = 0; k < K; ++k) {
      const float a = to_f32(arow[k]);
      const T* brow = B + (size_t)k * N;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int col = col0 + t * bn;
        if (col < N) acc[t] += a * to_f32(brow[col]);
      }
    }
  }

  if (row < M) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int col = col0 + t * bn;
      if (col < N) C[(size_t)row * N + col] = acc[t];
    }
  }
}

template <typename T, int S, bool CACHED>
static cudaError_t launch(const void* a, const void* b, float* c, int M, int N,
                          int K, int bm, int bn, int bk, cudaStream_t stream) {
  auto kernel = matmul_kernel<T, S, CACHED>;
  const size_t smem =
      CACHED ? (size_t)(bm * bk + bk * S * bn) * sizeof(T) : 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + bm - 1) / bm, (N + S * bn - 1) / (S * bn));
  kernel<<<grid, bm * bn, smem, stream>>>(static_cast<const T*>(a),
                                          static_cast<const T*>(b), c, M, N, K,
                                          bm, bn, bk);
  return cudaGetLastError();
}

template <typename T, bool CACHED>
static cudaError_t by_grain(const void* a, const void* b, float* c, int M,
                            int N, int K, int bm, int bn, int bk, int s,
                            cudaStream_t st) {
  switch (s) {
    case 1: return launch<T, 1, CACHED>(a, b, c, M, N, K, bm, bn, bk, st);
    case 2: return launch<T, 2, CACHED>(a, b, c, M, N, K, bm, bn, bk, st);
    case 4: return launch<T, 4, CACHED>(a, b, c, M, N, K, bm, bn, bk, st);
    case 8: return launch<T, 8, CACHED>(a, b, c, M, N, K, bm, bn, bk, st);
    case 16: return launch<T, 16, CACHED>(a, b, c, M, N, K, bm, bn, bk, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int matmul_h100_launch(const void* a, const void* b, void* c, int M,
                                  int N, int K, int bm, int bn, int bk, int s,
                                  int cached, int elem, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      bm * bn > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  if (elem == ELEM_F32)
    return cached ? by_grain<float, true>(a, b, out, M, N, K, bm, bn, bk, s, st)
                  : by_grain<float, false>(a, b, out, M, N, K, bm, bn, bk, s, st);
  if (elem == ELEM_BF16)
    return cached
        ? by_grain<__nv_bfloat16, true>(a, b, out, M, N, K, bm, bn, bk, s, st)
        : by_grain<__nv_bfloat16, false>(a, b, out, M, N, K, bm, bn, bk, s, st);
  return cudaErrorInvalidValue;
}
