// Tile helpers of the SSD scan's tensor-core bodies, shared by K3's bf16
// body (ssd_scan.cu) and K3b's (ssd_scan_bwd.cu): an f32 value fed to
// mma.sync as a high and a low bf16 part, and bf16 tiles in shared memory
// whose rows are padded to an odd number of 16-byte chunks (pitch = width + 8
// elements, width a multiple of 8), so that the 8 rows an ldmatrix reads fall
// in 8 different bank groups.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// v as a high and a low bf16 part, hi + lo = v to ~16 bits.
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// The two bf16 of a packed pair, each times its weight, split in two.
__device__ __forceinline__ void scale_split(unsigned pair, float w0, float w1,
                                            unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&pair);
  split2(__low2float(t) * w0, __high2float(t) * w1, hi, lo);
}

// Rows [0, rows) of a padded tile s (row pitch `pitch` elements, `width`
// columns, a multiple of 8): row t < n comes from src + t * stride with its
// columns at or past `valid` zero; rows t >= n are zero.  16-byte cp.async
// when vec (src and stride on 16 bytes, valid a multiple of 8), else element
// by element; the caller commits the copies.
__device__ __forceinline__ void load_padded(bf16* s, int pitch, int rows,
                                            int width, int n, int valid,
                                            const bf16* src, long long stride,
                                            bool vec) {
  if (vec) {
    const int cw = width / 8;
    for (int i = threadIdx.x; i < rows * cw; i += blockDim.x) {
      const int t = i / cw, c = i % cw;
      const bool ok = t < n && c * 8 < valid;
      cp_async16(s + t * pitch + c * 8, ok ? src + t * stride + c * 8 : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int t = i / width, c = i % width;
      s[t * pitch + c] = (t < n && c < valid) ? src[t * stride + c]
                                              : __float2bfloat16(0.f);
    }
  }
}

// ar[t] = a[t * stride] for t < n by cp.async, 1 for n <= t < rows (a decay
// of 1 leaves the state and the log-decay prefix as they are).
__device__ __forceinline__ void load_decays(float* ar, int rows, int n,
                                            const float* a,
                                            long long stride) {
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    if (t < n)
      cp_async4(ar + t, a + t * stride);
    else
      ar[t] = 1.f;
  }
}

}  // namespace
