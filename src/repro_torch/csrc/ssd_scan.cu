// K3 ssd_scan_h100: the Mamba-2 SSD scan with the state carried in and out.
// Per (row r, head h):  S_t = a_t * S_{t-1} + b_t (x) x_t ;  y_t = c_t . S_t
// over x [rows, seq, heads, hd], a [rows, seq, heads] (the decay itself, in
// (0, 1), f32), b and c [rows, seq, heads, state] given by strides (the model
// passes one [rows, seq, state] projection expanded over heads with head
// stride 0), state S0 [rows, heads, state, hd] in f32 or none (zero).
// Writes y [rows, seq, heads, hd] in x's type and the final state S1
// [rows, heads, state, hd] in f32.
//
// Replaces the TPU kernel pallas_ssd_scan (src/repro/kernels/ssd_scan.py,
// _ssd_kernel over ssd_chunk).  The TPU walks chunks as the last, sequential
// grid axis with the state in VMEM scratch, starts from a zero state, pads
// seq with a = 1 and x = b = c = 0, and returns only y.  Here one block walks
// its chunks in order in a loop with its state tile resident in shared
// memory; it starts from S0 and writes S1, so chunked prefill resumes from
// the previous chunk and a decode step is the same kernel at seq 1.  The
// last chunk is cut at seq: nothing is padded.
//
// Layout: grid (rows * heads, ceil(hd / bd)), NT threads.  The columns of S
// (over hd) are independent, so a block owns one hd tile of bd columns; this
// raises the block count (a one-row prefill chunk has only heads pairs for
// 132 SMs).  Per chunk of n <= ck steps, in shared memory (f32):
//   cum[t] = sum_{i<=t} log a_i                          (warp 0 scan)
//   G[t][i] = (c_t . b_i) exp(cum_t - cum_i), i <= t     (masked BEFORE exp:
//             the differences above the diagonal are positive and would
//             overflow; inf * 0 would give NaN)
//   y[t] = sum_{i<=t} G[t][i] x_i + exp(cum_t) c_t . S
//   S    = exp(cum_{n-1}) S + sum_i exp(cum_{n-1} - cum_i) b_i (x) x_i
// The b and c rows are padded to state+1 floats so that lanes reading
// different rows hit different banks.  Shared bytes:
//   4 * (state*bd + ck*bd + 2*ck*(state+1) + ck*ck + ck)
// which is the family's smem counter (kernels/ssd_scan.py).
//
// Bound on the card: a decode step reads and writes the f32 state (state x hd
// a head), a few flops a byte: bound by bytes.  A prefill chunk does about
// 5*state*hd flops a token and head on 2*hd bytes of x and y, so at state 128
// it is bound by operations.  This first kernel runs on the CUDA cores in
// f32; G is recomputed by every hd tile, and b, c are re-read by every
// (head, tile) block from L2.  Tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

#define NT 256
#define WARP 32

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ X, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ S0, T* __restrict__ Y,
           float* __restrict__ S1, int seq, int heads, int hd, int N, int ck,
           int bd, long long sb_r, long long sb_t, long long sb_h,
           long long sc_r, long long sc_t, long long sc_h) {
  extern __shared__ float smem[];
  const int NP = N + 1;                  // padded b / c row
  float* Ss = smem;                      // [N][bd]   state tile
  float* Xs = Ss + N * bd;               // [ck][bd]  x tile
  float* Bs = Xs + ck * bd;              // [ck][NP]
  float* Cs = Bs + ck * NP;              // [ck][NP]
  float* Gs = Cs + ck * NP;              // [ck][ck]
  float* cum = Gs + ck * ck;             // [ck]

  const int r = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int j0 = blockIdx.y * bd;
  const int w = min(bd, hd - j0);        // columns of this tile
  const int tid = threadIdx.x;

  const size_t sbase = ((size_t)r * heads + h) * N * hd + j0;
  for (int e = tid; e < N * bd; e += NT) {
    const int s = e / bd, j = e % bd;
    Ss[e] = (S0 != nullptr && j < w) ? S0[sbase + (size_t)s * hd + j] : 0.f;
  }
  const size_t xstep = (size_t)heads * hd;            // x, y: one step
  const size_t xbase = (size_t)r * seq * xstep + (size_t)h * hd + j0;
  const size_t abase = (size_t)r * seq * heads + h;
  const long long bbase = r * sb_r + h * sb_h;
  const long long cbase = r * sc_r + h * sc_h;

  for (int t0 = 0; t0 < seq; t0 += ck) {
    const int n = min(ck, seq - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = tid; e < n * bd; e += NT) {
      const int t = e / bd, j = e % bd;
      Xs[e] = j < w ? to_f32(X[xbase + (size_t)(t0 + t) * xstep + j]) : 0.f;
    }
    for (int e = tid; e < n * N; e += NT) {
      const int t = e / N, s = e % N;
      Bs[t * NP + s] = to_f32(Bm[bbase + (t0 + t) * sb_t + s]);
      Cs[t * NP + s] = to_f32(Cm[cbase + (t0 + t) * sc_t + s]);
    }
    if (tid < WARP) {                    // inclusive scan of log a
      const int per = (n + WARP - 1) / WARP;
      const int lo = min(n, tid * per), hi = min(n, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += logf(A[abase + (size_t)(t0 + t) * heads]);
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < WARP; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.f;
      for (int t = lo; t < hi; ++t) cum[t] += before;
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += NT) {
      const int t = e / n, i = e % n;
      float g = 0.f;
      if (i <= t) {
        const float* cr = Cs + t * NP;
        const float* br = Bs + i * NP;
        float dot = 0.f;
        for (int s = 0; s < N; ++s) dot += cr[s] * br[s];
        g = dot * expf(cum[t] - cum[i]);
      }
      Gs[t * ck + i] = g;
    }
    __syncthreads();
    const float clast = cum[n - 1];
    for (int e = tid; e < n * N; e += NT) {   // fold the decays into c and b
      const int t = e / N, s = e % N;
      Cs[t * NP + s] *= expf(cum[t]);
      Bs[t * NP + s] *= expf(clast - cum[t]);
    }
    __syncthreads();
    for (int e = tid; e < n * bd; e += NT) {
      const int t = e / bd, j = e % bd;
      if (j >= w) continue;
      float acc = 0.f;
      const float* gr = Gs + t * ck;
      for (int i = 0; i <= t; ++i) acc += gr[i] * Xs[i * bd + j];
      const float* cr = Cs + t * NP;
      for (int s = 0; s < N; ++s) acc += cr[s] * Ss[s * bd + j];
      from_f32(acc, &Y[xbase + (size_t)(t0 + t) * xstep + j]);
    }
    __syncthreads();                     // every y read the old state
    const float atot = expf(clast);
    for (int e = tid; e < N * bd; e += NT) {
      const int s = e / bd, j = e % bd;
      float acc = atot * Ss[e];
      for (int i = 0; i < n; ++i) acc += Bs[i * NP + s] * Xs[i * bd + j];
      Ss[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * bd; e += NT) {
    const int s = e / bd, j = e % bd;
    if (j < w) S1[sbase + (size_t)s * hd + j] = Ss[e];
  }
}

template <typename T>
static cudaError_t launch(const void* x, const float* a, const void* b,
                          const void* c, const float* s0, void* y, float* s1,
                          int rows, int seq, int heads, int hd, int N, int ck,
                          int bd, long long sb_r, long long sb_t,
                          long long sb_h, long long sc_r, long long sc_t,
                          long long sc_h, cudaStream_t stream) {
  auto kernel = ssd_kernel<T>;
  const size_t smem = sizeof(float) *
      ((size_t)N * bd + (size_t)ck * bd + 2 * (size_t)ck * (N + 1) +
       (size_t)ck * ck + ck);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(rows * heads, (hd + bd - 1) / bd);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b),
      static_cast<const T*>(c), s0, static_cast<T*>(y), s1, seq, heads, hd,
      N, ck, bd, sb_r, sb_t, sb_h, sc_r, sc_t, sc_h);
  return cudaGetLastError();
}

extern "C" int ssd_scan_h100_launch(const void* x, const void* a,
                                    const void* b, const void* c,
                                    const void* s0, void* y, void* s1,
                                    int rows, int seq, int heads, int hd,
                                    int state, int ck, int bd,
                                    long long sb_r, long long sb_t,
                                    long long sb_h, long long sc_r,
                                    long long sc_t, long long sc_h, int elem,
                                    void* stream) {
  if (rows <= 0 || seq <= 0 || heads <= 0 || hd <= 0 || state <= 0 ||
      ck <= 0 || ck > seq || bd <= 0 || (long long)rows * heads > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* s0f = static_cast<const float*>(s0);
  float* s1f = static_cast<float*>(s1);
  if (elem == ELEM_F32)
    return launch<float>(x, af, b, c, s0f, y, s1f, rows, seq, heads, hd,
                         state, ck, bd, sb_r, sb_t, sb_h, sc_r, sc_t, sc_h,
                         st);
  if (elem == ELEM_BF16)
    return launch<__nv_bfloat16>(x, af, b, c, s0f, y, s1f, rows, seq, heads,
                                 hd, state, ck, bd, sb_r, sb_t, sb_h, sc_r,
                                 sc_t, sc_h, st);
  return cudaErrorInvalidValue;
}
