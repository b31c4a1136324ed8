// K5 matadd_h100: C[M,N] = A[M,N] + B[M,N], all f32 or all bf16.
//
// Replaces the TPU kernel pallas_matadd (src/repro/kernels/matadd.py,
// _add_kernel), the paper's introductory example (Fig. 1/2).  The TPU pads A
// and B to whole (bm, s*bn) tiles with jnp.pad and slices the sum back: a
// full extra read and write of the data.  Here the ragged edge is masked in
// the kernel and nothing is padded.
//
// Bound on the card: one add for every 12 bytes (f32) moved, so bound by
// bytes: 3 * M * N * size bytes over 3.35 TB/s.  To reach that rate the card
// needs ~3.4 MB of loads in flight; one 4-byte load a thread (the first
// kernel) left it at 77 % of the bound.  The design moves 16 bytes a load:
//   - a thread's grain is s 16-byte vectors of each operand (W = 4 f32 or 8
//     bf16 values each), all s loads of A and B issued before any add, so
//     2*s*16 bytes a thread are in flight (ld.global.nc.v4 / st.global.v4);
//   - thread (ty, tx) of a bm x bn block owns the vectors at columns
//     j0 + (tx + t*bn)*W, t < s, so a warp's accesses cover 512 neighbouring
//     bytes of one row;
//   - grid (ceil(N/(s*bn*W)), ceil(M/bm)): column blocks on x, so that
//     blocks the scheduler starts together read neighbouring addresses of
//     a row (row blocks on x, 32 KB apart at 8192 f32 columns, cost 7 % at
//     8192^2); x takes 2^31 - 1 blocks, and past 65,535 row blocks the
//     kernel is launched once for each 65,535 (kMaxGridY).
// The vector path runs when N is a multiple of W and A, B and C start on a
// 16-byte boundary: then every row starts on one and every vector that
// begins before N is whole.  Otherwise (a row length of 700 bf16, a view
// one element into a buffer) the same grid covers the same W-element groups
// with masked scalar loads, which also cover a row's tail past the last
// whole vector.  The vector width is a property of the kernel, not a
// program parameter: the paper's grain s keeps its meaning (vectors a
// thread), and its case discussion on R is unchanged.
//
// Each element is added in f32 and rounded once to the element type, as
// `a + b` does on the card, so the kernel equals the plain version bit for
// bit in both types.
#include "common.cuh"

#include <cstdint>

namespace {

__device__ __forceinline__ uint4 add16(uint4 a, uint4 b, float) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  const float4 z = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  return *reinterpret_cast<const uint4*>(&z);
}

__device__ __forceinline__ uint4 add16(uint4 a, uint4 b, __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 out;
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    z[i] = __floats2bfloat162_rn(u.x + v.x, u.y + v.y);
  }
  return out;
}

template <typename T, bool VEC, int S>
__global__ void matadd_kernel(const T* __restrict__ A, const T* __restrict__ B,
                              T* __restrict__ C, int M, int N, int bm, int bn,
                              int rb0) {
  constexpr int W = 16 / sizeof(T);            // elements a 16-byte vector
  const int tx = threadIdx.x % bn;
  const int ty = threadIdx.x / bn;
  const int row = (rb0 + blockIdx.y) * bm + ty;
  if (row >= M) return;
  const size_t base = (size_t)row * N;
  const long long col0 = ((long long)blockIdx.x * S * bn + tx) * W;
  if constexpr (VEC) {
    uint4 va[S], vb[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const long long col = col0 + (long long)t * bn * W;
      if (col < N) {
        va[t] = __ldg(reinterpret_cast<const uint4*>(A + base + col));
        vb[t] = __ldg(reinterpret_cast<const uint4*>(B + base + col));
      }
    }
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const long long col = col0 + (long long)t * bn * W;
      if (col < N)
        *reinterpret_cast<uint4*>(C + base + col) = add16(va[t], vb[t], T());
    }
  } else {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const long long col = col0 + (long long)t * bn * W;
      T xa[W], xb[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const bool ok = col + e < N;
        xa[e] = ok ? A[base + col + e] : T(0.f);
        xb[e] = ok ? B[base + col + e] : T(0.f);
      }
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (col + e < N)
          from_f32(to_f32(xa[e]) + to_f32(xb[e]), &C[base + col + e]);
    }
  }
}

template <typename T, bool VEC, int S>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N,
                   int bm, int bn, cudaStream_t stream) {
  constexpr long long W = 16 / sizeof(T);
  const long long span = (long long)S * bn * W;
  const long long col_blocks = ((long long)N + span - 1) / span;
  const long long row_blocks = ((long long)M + bm - 1) / bm;
  for (long long rb0 = 0; rb0 < row_blocks; rb0 += kMaxGridY) {
    const long long rows = row_blocks - rb0;
    dim3 grid((unsigned)col_blocks,
              (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
    matadd_kernel<T, VEC, S><<<grid, bm * bn, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(c), M, N, bm, bn, (int)rb0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t by_grain(const void* a, const void* b, void* c, int M, int N,
                     int bm, int bn, int s, cudaStream_t st) {
  switch (s) {
    case 1: return launch<T, VEC, 1>(a, b, c, M, N, bm, bn, st);
    case 2: return launch<T, VEC, 2>(a, b, c, M, N, bm, bn, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_path(const void* a, const void* b, void* c, int M, int N,
                    int bm, int bn, int s, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = N % W == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  return vec ? by_grain<T, true>(a, b, c, M, N, bm, bn, s, st)
             : by_grain<T, false>(a, b, c, M, N, bm, bn, s, st);
}

}  // namespace

// Formats it takes: bm, bn >= 1 with bm*bn <= 1024 threads; s (16-byte
// vectors a thread) in {1, 2}, the tree's grains.
extern "C" int matadd_h100_launch(const void* a, const void* b, void* c, int M,
                                  int N, int bm, int bn, int s, int elem,
                                  void* stream) {
  if (M <= 0 || N <= 0 || bm <= 0 || bn <= 0 || bm * bn > 1024 ||
      (s != 1 && s != 2))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == ELEM_F32) return by_path<float>(a, b, c, M, N, bm, bn, s, st);
  if (elem == ELEM_BF16)
    return by_path<__nv_bfloat16>(a, b, c, M, N, bm, bn, s, st);
  return cudaErrorInvalidValue;
}
