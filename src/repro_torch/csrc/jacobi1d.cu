// K6 jacobi1d_h100: up to F sweeps of the 1D Jacobi stencil with fixed ends
// in one launch,
//   y[i] = ((x[i-1] + x[i]) + x[i+1]) / 3   for 0 < i < n-1,  f32.
//
// Replaces the TPU kernel pallas_jacobi1d (src/repro/kernels/jacobi1d.py,
// _jacobi_kernel_cached / _jacobi_kernel_uncached), the paper's Fig. 7 /
// Table 2.  The TPU runs one sweep a pallas_call and the paper's t-loop
// outside it; here a call of `steps` sweeps is ceil(steps / F) launches, each
// running `depth` <= F sweeps on a window held in shared memory (the wrapper's
// launch_plan).  Blocks cover the interior in runs of W = B*s points, the last
// cut at n - 2; no padding copies, x is never written.
//
// Layout: grid ceil((n-2) / W), B threads a block.  Block b owns the outputs
// y[base+1 .. base+W] (base = b*W).  Kernels:
//   jacobi_fused (F > 1): stages the window that `depth` sweeps need,
//     x[base+1-depth .. base+W+depth], clamped at the vector's two ends, with
//     one 1-D bulk copy (cp.async.bulk, completing on an mbarrier) of its
//     16-byte aligned run; threads load the head and tail of fewer than 16
//     bytes.  A window slot keeps its element's address modulo 16 bytes, so
//     the bulk copy's source and destination are both aligned.  Then
//     depth - 1 sweeps ping-pong between two shared buffers, one barrier a
//     sweep, the valid range shrinking by one point on each side a sweep
//     (not at an end of the vector, whose fixed point stays valid: points 0
//     and n-1 keep x's values in both buffers).  The last sweep writes the W
//     outputs once, four a thread as a 16-byte store where y is aligned,
//     scalars at the unaligned head and tail; the block holding an end of
//     the vector writes that end.  The halo points are recomputed by each
//     neighbouring block with the same operations, so every depth gives the
//     same bits.  Shared bytes: two buffers of W + 2F + 4 values (the window
//     and up to 3 slots of alignment) and the 8-byte mbarrier,
//     8 * (W + 2F + 4) + 8, the family's smem counter (kernels/jacobi1d.py).
//   jacobi_cached (F = 1): one sweep a launch, the window x[base .. base+W+1]
//     (W + 2 values, 4 * (W + 2) bytes) staged with coalesced loads, then
//     the three neighbours read from there (the paper's case 1 and, at
//     s = 1, case 2).
//   jacobi_uncached: one sweep a launch, each thread reading its three
//     neighbours from device memory (L1/L2 serve the overlap; case 3).
// The arithmetic is the oracle's: the left sum first, then a true division
// by 3.  Built without -use_fast_math, the division rounds as IEEE says, so
// every kernel at every depth equals the plain version bit for bit.
//
// Bound on the card: 3 flops a point a sweep on 8 bytes a point a launch, so
// bound by bytes: a launch reads x once and writes y once, 2 * 4 * n bytes
// over 3.35 TB/s, whatever its depth (5.0 us at n = 2^21 + 2, 0.08 us at the
// paper's n = 2^15 + 2, where a launch costs more than its bytes).  Fusing
// the sweeps divides both the bytes and the launches of a call by up to F;
// the halo costs 2 * depth / W more loads and sweeps.
#include "hopper.cuh"

__device__ __forceinline__ float mean3(float l, float m, float r) {
  return (l + m + r) / 3.0f;
}

// `bytes` (a multiple of 16) from src in global memory to dst in shared
// memory, both 16-byte aligned, in one bulk copy counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The element offset of p within its 16 bytes (p 4-byte aligned).
__device__ __forceinline__ int quad_offset(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__global__ void jacobi_fused(const float* __restrict__ X,
                             float* __restrict__ Y, int n, int W, int depth,
                             int stride) {
  extern __shared__ __align__(16) float buf[];     // [2][stride], mbarrier
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 2 * stride);
  const int tid = threadIdx.x, B = blockDim.x;
  const int base = blockIdx.x * W;
  const int lo = max(0, base + 1 - depth);          // window x[lo, hi)
  const int hi = min(n, base + W + 1 + depth);
  // x[g] sits in slot g - org, with g - org = g + xo (mod 4): the slot of a
  // 16-byte aligned element is 16-byte aligned
  const int xo = quad_offset(X);
  const int org = ((lo + xo) & ~3) - xo;            // lo - 3 <= org <= lo
  int a0 = ((lo + xo + 3) & ~3) - xo;               // the aligned run
  int a1 = ((hi + xo) & ~3) - xo;                   //   x[a0, a1)
  if (a1 <= a0) a0 = a1 = hi;                       // none: threads load all
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const bool bulk = a1 > a0;
  if (tid == 0 && bulk) {
    const unsigned bytes = 4u * static_cast<unsigned>(a1 - a0);
    mbar_expect_tx(bar, bytes);
    bulk_load(buf + (a0 - org), X + a0, bytes, bar);
  }
  float* cur = buf;
  float* nxt = buf + stride;
  for (int g = lo + tid; g < a0; g += B) cur[g - org] = X[g];   // head
  for (int g = a1 + tid; g < hi; g += B) cur[g - org] = X[g];   // tail
  if (bulk) mbar_wait(bar, 0);
  __syncthreads();
  if (tid == 0 && depth > 1) {                      // the fixed ends
    if (lo == 0) nxt[-org] = cur[-org];
    if (hi == n) nxt[n - 1 - org] = cur[n - 1 - org];
  }
  for (int k = 1; k < depth; ++k) {
    const int first = lo == 0 ? 1 : lo + k;
    const int last = hi == n ? n - 2 : hi - 1 - k;
    for (int g = first + tid; g <= last; g += B) {
      const float* c = cur + (g - org);
      nxt[g - org] = mean3(c[-1], c[0], c[1]);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // the last sweep: y[o_lo .. o_hi], 16-byte stores over y[v0, v1)
  if (tid == 0 && blockIdx.x == 0) Y[0] = cur[-org];
  if (tid == 0 && blockIdx.x == gridDim.x - 1) Y[n - 1] = cur[n - 1 - org];
  const int o_lo = base + 1, o_hi = min(base + W, n - 2);
  const int yo = quad_offset(Y);
  const int v0 = ((o_lo + yo + 3) & ~3) - yo;
  const int groups = max(0, (o_hi + 1 - v0) / 4);
  const int v1 = v0 + 4 * groups;
  const bool paired = yo == xo;                     // slots aligned with y
  for (int j = tid; j < groups; j += B) {
    const int g = v0 + 4 * j;
    const float* c = cur + (g - org);
    float4 m;
    if (paired) {
      m = *reinterpret_cast<const float4*>(c);
    } else {
      m = make_float4(c[0], c[1], c[2], c[3]);
    }
    const float l = c[-1], r = c[4];
    *reinterpret_cast<float4*>(Y + g) =
        make_float4(mean3(l, m.x, m.y), mean3(m.x, m.y, m.z),
                    mean3(m.y, m.z, m.w), mean3(m.z, m.w, r));
  }
  for (int g = o_lo + tid; g < min(v0, o_hi + 1); g += B) {
    const float* c = cur + (g - org);
    Y[g] = mean3(c[-1], c[0], c[1]);
  }
  for (int g = max(v0, v1) + tid; g <= o_hi; g += B) {
    const float* c = cur + (g - org);
    Y[g] = mean3(c[-1], c[0], c[1]);
  }
}

__global__ void jacobi_cached(const float* __restrict__ X,
                              float* __restrict__ Y, int inner, int B, int s) {
  extern __shared__ float win[];                   // [B*s + 2]
  const int bs = B * s;
  const int base = blockIdx.x * bs;
  const int span = min(bs, inner - base) + 2;     // window values in range
  if (blockIdx.x == 0 && threadIdx.x == 0) {       // the fixed ends
    Y[0] = X[0];
    Y[inner + 1] = X[inner + 1];
  }
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
  if (blockIdx.x == 0 && threadIdx.x == 0) {       // the fixed ends
    Y[0] = X[0];
    Y[inner + 1] = X[inner + 1];
  }
  for (int t = 0; t < s; ++t) {
    const int i = base + threadIdx.x + t * B;
    if (i < inner) Y[i + 1] = mean3(X[i], X[i + 1], X[i + 2]);
  }
}

// x, y: n floats (4-byte aligned); writes y from `depth` sweeps of x, at most
// F (the format's most sweeps a launch, which sizes shared memory).  F = 1
// runs jacobi_cached or, uncached, jacobi_uncached; F > 1 jacobi_fused.
extern "C" int jacobi1d_h100_launch(const void* x, void* y, int n, int B,
                                    int s, int F, int depth, int cached,
                                    void* stream) {
  const int inner = n - 2;
  if (inner <= 0 || B <= 0 || B > 1024 || s <= 0 || F <= 0 || depth <= 0 ||
      depth > F || (!cached && F != 1) || (long long)B * s >= (1LL << 30))
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
  if (F == 1) {
    const size_t smem = sizeof(float) * ((size_t)bs + 2);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    static size_t granted[kMaxDevices] = {};
    cudaError_t err = allow_smem_once(jacobi_cached, smem, granted);
    if (err != cudaSuccess) return err;
    jacobi_cached<<<blocks, B, smem, st>>>(src, dst, inner, B, s);
    return cudaGetLastError();
  }
  // a buffer's slots, rounded to 16 bytes (W + 2F + 4 for B a multiple of
  // 4 and F even, as the family's domains give)
  const long long stride = ((long long)bs + 2LL * F + 6) & ~3LL;
  const size_t smem = sizeof(float) * 2 * stride + sizeof(uint64_t);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static size_t granted[kMaxDevices] = {};
  cudaError_t err = allow_smem_once(jacobi_fused, smem, granted);
  if (err != cudaSuccess) return err;
  jacobi_fused<<<blocks, B, smem, st>>>(src, dst, n, bs, depth, (int)stride);
  return cudaGetLastError();
}
