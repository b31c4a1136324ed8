// K6 jacobi1d_h100: one sweep of the 1D Jacobi stencil with fixed ends,
//   y[i] = ((x[i-1] + x[i]) + x[i+1]) / 3   for 0 < i < n-1,  f32.
//
// Replaces the TPU kernel pallas_jacobi1d (src/repro/kernels/jacobi1d.py,
// _jacobi_kernel_cached / _jacobi_kernel_uncached), the paper's Fig. 7 /
// Table 2.  One launch is one sweep; the paper's t-loop stays outside, in the
// wrapper, which ping-pongs two buffers that both hold the fixed ends.  The
// TPU pads x to whole blocks and writes the interior back with a scatter;
// here the last block is cut at n - 2 and each sweep writes the interior of
// the other buffer in place.
//
// Layout: grid ceil((n-2) / (B*s)), B threads a block; a block computes the
// B*s interior points base+1 .. base+B*s, thread tid the points spaced B
// apart (tid + t*B, t < s), so a warp's stores are coalesced.
//   cached   : the block first stages its window x[base .. base+B*s+1] (B*s+2
//              values) in shared memory with coalesced loads, then reads the
//              three neighbours from there (the paper's case 1 and, at s = 1,
//              case 2).  Shared bytes: 4 * (B*s + 2), the family's smem
//              counter (kernels/jacobi1d.py).
//   uncached : each thread reads its three neighbours from device memory
//              (L1/L2 serve the overlap; the paper's case 3).
// The arithmetic is the oracle's: the left sum first, then a true division
// by 3.  Built without -use_fast_math, the division rounds as IEEE says, so
// the kernel equals the plain version bit for bit.
//
// Bound on the card: 3 flops a point on 8 bytes moved, so bound by bytes:
// 2 * 4 * n bytes a sweep over 3.35 TB/s.  At the paper's n = 2^15 + 2 that
// is 0.08 us, far below a launch, so a sweep costs its launch; fusing sweeps
// (temporal blocking) or a CUDA graph is later work.
#include "common.cuh"

__device__ __forceinline__ float mean3(float l, float m, float r) {
  return (l + m + r) / 3.0f;
}

__global__ void jacobi_cached(const float* __restrict__ X,
                              float* __restrict__ Y, int inner, int B, int s) {
  extern __shared__ float win[];                   // [B*s + 2]
  const int bs = B * s;
  const int base = blockIdx.x * bs;
  const int span = min(bs, inner - base) + 2;     // window values in range
  for (int e = threadIdx.x; e < span; e += B) win[e] = X[base + e];
  __syncthreads();
  for (int t = 0; t < s; ++t) {
    const int k = threadIdx.x + t * B;             // interior offset
    if (base + k < inner)
      Y[base + k + 1] = mean3(win[k], win[k + 1], win[k + 2]);
  }
}

__global__ void jacobi_uncached(const float* __restrict__ X,
                                float* __restrict__ Y, int inner, int B,
                                int s) {
  const int base = blockIdx.x * B * s;
  for (int t = 0; t < s; ++t) {
    const int i = base + threadIdx.x + t * B;
    if (i < inner) Y[i + 1] = mean3(X[i], X[i + 1], X[i + 2]);
  }
}

// x, y: n floats; writes y[1 .. n-2] from x.  The caller keeps y's ends.
extern "C" int jacobi1d_h100_launch(const void* x, void* y, int n, int B,
                                    int s, int cached, void* stream) {
  const int inner = n - 2;
  if (inner <= 0 || B <= 0 || B > 1024 || s <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bs = B * s;
  const int blocks = (int)(((long long)inner + bs - 1) / bs);
  const float* src = static_cast<const float*>(x);
  float* dst = static_cast<float*>(y);
  if (!cached) {
    jacobi_uncached<<<blocks, B, 0, st>>>(src, dst, inner, B, s);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * ((size_t)bs + 2);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(jacobi_cached, smem);
  if (err != cudaSuccess) return err;
  jacobi_cached<<<blocks, B, smem, st>>>(src, dst, inner, B, s);
  return cudaGetLastError();
}
