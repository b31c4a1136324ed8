// K2 flash_attention_h100: online-softmax attention over q [h, sq, d] and
// k, v [h, sk, d] (sq <= sk, ends aligned: query i sits at key position
// i + sk - sq), causal and sliding-window masks, scale 1/sqrt(d) by default;
// output [h, sq, d] in q's type.  d <= 128.
//
// Replaces the TPU kernel pallas_flash_attention
// (src/repro/kernels/flash_attention.py, _fa_kernel).  The TPU walks kv tiles
// as the last, sequential grid axis and carries m, l and acc in VMEM scratch;
// here each block walks its kv tiles in order in a loop and keeps m, l and
// acc in registers.  Keys at or past sk are never read, so padded keys cannot
// enter the softmax even without a causal mask (the TPU kernel lets them in
// when causal=False).
//
// Layout: grid (h, ceil(sq/bq)), one warp per query row (32*bq threads).
// Each kv tile of bkv keys is staged in shared memory as f32 (K rows padded
// to d+1 floats so that lanes reading different keys hit different banks).
// Lane j scores keys j, j+32, ...; the tile max and sum are warp reductions;
// the probabilities go through a per-warp row of shared memory, and lane j
// then accumulates output dims j, j+32, j+64, j+96.  Tiles wholly past the
// causal limit, or wholly before the window, of every row of the block are
// skipped.
//
// Bound on the card: the prefill chunk (h 32, sq 32, sk <= 256, d 128) does
// 4*h*sq*sk*d flops on 2*h*sk*d*2 bytes of K and V, about sq flops a byte,
// and decode (sq 1) about one: both below the ~295 flop/byte where the bf16
// tensor-core rate would bind, so it is bound by bytes.  This first kernel
// runs on the CUDA cores in f32 and reads K/V once per block of bq rows.
#include "common.cuh"

#define WARP 32
#define DMAX 128

template <typename T>
__global__ void flash_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                             const T* __restrict__ V, T* __restrict__ O, int sq,
                             int sk, int d, int bq, int bkv, float scale,
                             int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [bq][d], pre-scaled
  float* Ks = Qs + bq * d;               // [bkv][d+1]
  float* Vs = Ks + bkv * (d + 1);        // [bkv][d]
  float* Ps = Vs + bkv * d;              // [bq][bkv]

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * bq;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int nthreads = blockDim.x;
  const int offset = sk - sq;
  const size_t qbase = (size_t)h * sq * d;
  const size_t kbase = (size_t)h * sk * d;

  for (int i = threadIdx.x; i < bq * d; i += nthreads) {
    const int r = i / d, c = i % d;
    Qs[i] = (q0 + r < sq) ? to_f32(Q[qbase + (size_t)(q0 + r) * d + c]) * scale
                          : 0.f;
  }

  // key range any row of this block can see
  const int last_row = min(q0 + bq, sq) - 1;
  const int kend = causal ? min(sk, last_row + offset + 1) : sk;
  const int kbeg = window > 0 ? max(0, q0 + offset - window + 1) : 0;

  const int qi = q0 + warp;                 // this warp's query row
  const bool live = qi < sq;
  const int qpos = qi + offset;
  const int klo = window > 0 ? qpos - window + 1 : 0;   // first visible key
  const int khi = causal ? qpos : sk - 1;               // last visible key

  float m = -INFINITY, l = 0.f;
  float acc[DMAX / WARP];
#pragma unroll
  for (int t = 0; t < DMAX / WARP; ++t) acc[t] = 0.f;
  float* prow = Ps + warp * bkv;
  const float* qrow = Qs + warp * d;

  for (int k0 = kbeg; k0 < kend; k0 += bkv) {
    const int n = min(bkv, kend - k0);
    __syncthreads();                        // previous tile fully consumed
    for (int i = threadIdx.x; i < n * d; i += nthreads) {
      const int r = i / d, c = i % d;
      const size_t g = kbase + (size_t)(k0 + r) * d + c;
      Ks[r * (d + 1) + c] = to_f32(K[g]);
      Vs[r * d + c] = to_f32(V[g]);
    }
    __syncthreads();
    if (!live) continue;
    if (k0 > khi || k0 + n - 1 < klo) continue;   // whole tile masked

    float sc[8];                            // bkv <= 256 keys, 8 per lane
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = lane + i * WARP;
      sc[i] = -INFINITY;
      if (j < n) {
        const int kp = k0 + j;
        if (kp >= klo && kp <= khi) {
          const float* krow = Ks + j * (d + 1);
          float s = 0.f;
          for (int c = 0; c < d; ++c) s += qrow[c] * krow[c];
          sc[i] = s;
          mx = fmaxf(mx, s);
        }
      }
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (mx == -INFINITY) continue;          // no visible key for this row
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);     // m = -inf on the first tile: 0
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = lane + i * WARP;
      if (j < n) {
        const float p = sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
        prow[j] = p;
        psum += p;
      }
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int t = 0; t < DMAX / WARP; ++t) {
      const int c = lane + t * WARP;
      if (c < d) {
        float a = acc[t] * corr;
        for (int j = 0; j < n; ++j) a += prow[j] * Vs[j * d + c];
        acc[t] = a;
      }
    }
    __syncwarp();
  }

  if (live) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int t = 0; t < DMAX / WARP; ++t) {
      const int c = lane + t * WARP;
      if (c < d) from_f32(acc[t] * inv, &O[qbase + (size_t)qi * d + c]);
    }
  }
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                          int h, int sq, int sk, int d, int bq, int bkv,
                          float scale, int causal, int window,
                          cudaStream_t stream) {
  auto kernel = flash_kernel<T>;
  const size_t smem =
      sizeof(float) * ((size_t)bq * d + (size_t)bkv * (d + 1) +
                       (size_t)bkv * d + (size_t)bq * bkv);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(h, (sq + bq - 1) / bq);
  kernel<<<grid, bq * WARP, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, bq, bkv, scale,
      causal, window);
  return cudaGetLastError();
}

extern "C" int flash_attention_h100_launch(const void* q, const void* k,
                                           const void* v, void* o, int h,
                                           int sq, int sk, int d, int bq,
                                           int bkv, float scale, int causal,
                                           int window, int elem,
                                           void* stream) {
  if (h <= 0 || sq <= 0 || sk < sq || d <= 0 || d > DMAX || bq <= 0 ||
      bq * WARP > 1024 || bkv <= 0 || bkv > 8 * WARP)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == ELEM_F32)
    return launch<float>(q, k, v, o, h, sq, sk, d, bq, bkv, scale, causal,
                         window, st);
  if (elem == ELEM_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, h, sq, sk, d, bq, bkv, scale,
                                 causal, window, st);
  return cudaErrorInvalidValue;
}
