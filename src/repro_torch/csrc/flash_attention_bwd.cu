// K2b flash_attention_bwd_h100: the gradients dQ, dK, dV of K2's function
// (online-softmax attention, grouped-query heads, ends aligned, causal and
// sliding-window masks, keys at or past a row's length masked) over the
// layout of a training forward: q, o, dO [rows, h, sq, d] and k, v [rows,
// page, hk, d] (a pool of one block a row, K2's paged entry with the table
// [[b]]), the rows' lengths [rows] (int32) read on the device.  Query i of
// row b sits at key position i + len[b] - sq; a row of length 0 gets zero
// gradients.  Inputs f32 or bf16, every sum in f32, outputs in the inputs'
// type; lse and delta come out as f32 [rows, h, sq].  d <= 128.
//
// The TPU package has no kernel backward: its train step differentiates
// einsum attention (ROADMAP F3), so this kernel replaces no Pallas kernel.
// It is the backward of K2 (csrc/flash_attention.cu), the TPU kernel
// pallas_flash_attention (src/repro/kernels/flash_attention.py:75).
//
// Bound on the card: a training layer does 2.5x the forward's 4*h*pairs*d
// flops on 4 * rows*h*sq*d + 4 * rows*page*hk*d elements, hundreds of flops a
// byte at sq 1024: bound by operations.  This first kernel is simple and
// right: f32 tiles in shared memory and FMA, no tensor cores, no TMA.
//
// Two kernels, no atomics, so two launches give the same bits:
//   (i)  dq: one block per (row, query head, tile of bq queries).  A first
//        sweep over the visible key tiles recomputes each query's
//        log-sum-exp with the online max and sum; delta = rowsum(dO * O);
//        a second sweep forms P = exp(s - lse), dP = dO V^T and
//        dS = P * (dP - delta) a tile at a time and sums dQ = scale * dS K
//        in registers.  It writes dQ, lse and delta.
//   (ii) dkdv: one block per (row, KV head, tile of bkv keys).  It keeps
//        the tile's K and V in shared memory and dK, dV in registers, and
//        walks the group's query heads and their query tiles in order,
//        skipping tiles no query of which sees a key of the block:
//        dV += P^T dO, dK += scale * dS^T Q, each written once.
// A block is 16 x 16 threads.  Thread (ty, tx) owns the score entries of
// rows ty + 16a and columns tx + 16b of a tile, and the output entries of
// rows ty + 16a and columns tx + 16c; a row's reductions run over the 16
// lanes of a half-warp by xor shuffles, which give every lane the same bits.
// Tiles are f32 [rows][D + 1] (one padding word, so the 16 lanes that walk
// 16 key rows at one column fall in 16 banks); columns at or past d are 0.
#include "common.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridYZ = 65535;
constexpr int kMaxR = 4;          // bq / 16 and bkv / 16 are at most 4

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int* lens;     // [rows]
  void* dq;
  void* dk;
  void* dv;
  float* lse;          // [rows, h, sq]
  float* delta;        // [rows, h, sq]
  int rows, h, hk, group, sq, page, d;
  int bq, bkv;
  float scale;
  int causal, window;  // window 0: none
};

__device__ __forceinline__ float hmax16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float hsum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float wsum32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [0, n) of a [n][D + 1] f32 tile from rows of `stride` elements at
// `base`: rows at or past `valid` and columns at or past d are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* base,
                                          long long stride, int n, int valid,
                                          int d) {
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (r < valid && c < d) x = to_f32(base[(long long)r * stride + c]);
    s[r * (D + 1) + c] = x;
  }
}

// s[a][b] = sum over c of A[ty + 16a][c] * B[tx + 16b][c], in order of c.
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[kMaxR][kMaxR],
                                         const float* A, const float* B,
                                         int ri, int rj, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < kMaxR; ++a)
#pragma unroll
    for (int b = 0; b < kMaxR; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float av[kMaxR], bv[kMaxR];
#pragma unroll
    for (int a = 0; a < kMaxR; ++a)
      av[a] = a < ri ? A[(ty + 16 * a) * (D + 1) + c] : 0.f;
#pragma unroll
    for (int b = 0; b < kMaxR; ++b)
      bv[b] = b < rj ? B[(tx + 16 * b) * (D + 1) + c] : 0.f;
#pragma unroll
    for (int a = 0; a < kMaxR; ++a)
#pragma unroll
      for (int b = 0; b < kMaxR; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

// Whether query i (position qpos) sees key j of a row of `len` keys.
__device__ __forceinline__ bool visible(const Args& p, int i, int qpos, int j,
                                        int len) {
  return i < p.sq && j < len && (!p.causal || j <= qpos) &&
         (p.window <= 0 || j > qpos - p.window);
}

// P and dS of a score tile: p = exp(scale * s - lse) where visible, else
// 0; ds = p * (dp - delta).  Rows are q0 + ty + 16a, keys k0 + tx + 16b.
__device__ __forceinline__ void probs(const Args& p, float (&s)[kMaxR][kMaxR],
                                      float (&dp)[kMaxR][kMaxR],
                                      const float* lse_s, const float* dl_s,
                                      int q0, int k0, int off, int len,
                                      int ri, int rj, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < kMaxR; ++a) {
    if (a >= ri) continue;
    const int r = ty + 16 * a, i = q0 + r;
    const float lse = lse_s[r], dl = dl_s[r];
#pragma unroll
    for (int b = 0; b < kMaxR; ++b) {
      if (b >= rj) continue;
      const int j = k0 + tx + 16 * b;
      const float pr =
          visible(p, i, i + off, j, len) ? expf(s[a][b] * p.scale - lse) : 0.f;
      s[a][b] = pr;
      dp[a][b] = pr * (dp[a][b] - dl);
    }
  }
}

__device__ __forceinline__ int row_len(const Args& p, int b) {
  return min(max(__ldg(p.lens + b), 0), p.page);
}

// ---------------------------------------------------------------------------
// (i) dQ, lse, delta: block (query tile, query head, row)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const Args p) {
  extern __shared__ float sm[];
  const int BQ = p.bq, BKV = p.bkv, ri = BQ / 16, rj = BKV / 16;
  constexpr int DP = D + 1;
  const int SP = BKV + 1;
  float* Qs = sm;
  float* dOs = Qs + BQ * DP;
  float* Ks = dOs + BQ * DP;
  float* Vs = Ks + BKV * DP;
  float* Ss = Vs + BKV * DP;
  float* lse_s = Ss + BQ * SP;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int g = hh / p.group;
  const int len = row_len(p, b);
  const int nq = min(BQ, p.sq - q0);
  const long long qrow0 = ((long long)b * p.h + hh) * p.sq + q0;
  const T* Q = static_cast<const T*>(p.q) + qrow0 * p.d;
  const T* O = static_cast<const T*>(p.o) + qrow0 * p.d;
  const T* dO = static_cast<const T*>(p.dout) + qrow0 * p.d;
  T* dQ = static_cast<T*>(p.dq) + qrow0 * p.d;
  const long long kstride = (long long)p.hk * p.d;
  const long long kbase = ((long long)b * p.page * p.hk + g) * p.d;
  const T* K = static_cast<const T*>(p.k) + kbase;
  const T* Vg = static_cast<const T*>(p.v) + kbase;
  const int off = len - p.sq;

  // the keys some query of the tile sees
  int kbeg = 0, kend = len;
  if (p.causal) kend = min(kend, q0 + nq - 1 + off + 1);
  if (p.window > 0) kbeg = max(0, q0 + off - p.window + 1);
  const int t0 = (kbeg / BKV) * BKV;

  load_tile<T, D>(Qs, Q, p.d, BQ, nq, p.d);
  load_tile<T, D>(dOs, dO, p.d, BQ, nq, p.d);
  // delta = rowsum(dO * O), a warp a row, in f32
  for (int r = warp; r < BQ; r += kThreads / 32) {
    float acc = 0.f;
    if (r < nq)
      for (int c = lane; c < p.d; c += 32)
        acc = fmaf(to_f32(dO[(long long)r * p.d + c]),
                   to_f32(O[(long long)r * p.d + c]), acc);
    acc = wsum32(acc);
    if (lane == 0) dl_s[r] = acc;
  }

  // sweep 1: the log-sum-exp of every query's visible scores
  float m[kMaxR], l[kMaxR];
#pragma unroll
  for (int a = 0; a < kMaxR; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  float s[kMaxR][kMaxR], dp[kMaxR][kMaxR];
  for (int k0 = t0; k0 < kend; k0 += BKV) {
    __syncthreads();
    load_tile<T, D>(Ks, K + k0 * kstride, kstride, BKV, len - k0, p.d);
    __syncthreads();
    dot_tile<D>(s, Qs, Ks, ri, rj, ty, tx);
#pragma unroll
    for (int a = 0; a < kMaxR; ++a) {
      if (a >= ri) continue;           // uniform over the block
      const int i = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int bb = 0; bb < kMaxR; ++bb) {
        if (bb >= rj) continue;
        const int j = k0 + tx + 16 * bb;
        s[a][bb] = visible(p, i, i + off, j, len) ? s[a][bb] * p.scale
                                                  : -INFINITY;
        mx = fmaxf(mx, s[a][bb]);
      }
      mx = hmax16(mx);
      const float mn = fmaxf(m[a], mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int bb = 0; bb < kMaxR; ++bb)
        if (bb < rj) sum += expf(s[a][bb] - base);
      sum = hsum16(sum);
      l[a] = l[a] * expf(m[a] - base) + sum;
      m[a] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < kMaxR; ++a)
      if (a < ri)
        lse_s[ty + 16 * a] = l[a] > 0.f ? m[a] + logf(l[a]) : -INFINITY;
  }

  // sweep 2: dQ = scale * sum over key tiles of dS K
  float acc[kMaxR][D / 16];
#pragma unroll
  for (int a = 0; a < kMaxR; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[a][c] = 0.f;
  for (int k0 = t0; k0 < kend; k0 += BKV) {
    __syncthreads();
    load_tile<T, D>(Ks, K + k0 * kstride, kstride, BKV, len - k0, p.d);
    load_tile<T, D>(Vs, Vg + k0 * kstride, kstride, BKV, len - k0, p.d);
    __syncthreads();
    dot_tile<D>(s, Qs, Ks, ri, rj, ty, tx);
    dot_tile<D>(dp, dOs, Vs, ri, rj, ty, tx);
    probs(p, s, dp, lse_s, dl_s, q0, k0, off, len, ri, rj, ty, tx);
#pragma unroll
    for (int a = 0; a < kMaxR; ++a)
#pragma unroll
      for (int bb = 0; bb < kMaxR; ++bb)
        if (a < ri && bb < rj) Ss[(ty + 16 * a) * SP + tx + 16 * bb] = dp[a][bb];
    __syncthreads();
    for (int j = 0; j < BKV; ++j) {
      float kv[D / 16];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) kv[c] = Ks[j * DP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kMaxR; ++a) {
        if (a >= ri) continue;
        const float sv = Ss[(ty + 16 * a) * SP + j];
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[a][c] = fmaf(sv, kv[c], acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kMaxR; ++a) {
    const int r = ty + 16 * a;
    if (a >= ri || r >= nq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) from_f32(acc[a][c] * p.scale, dQ + (long long)r * p.d + col);
    }
  }
  __syncthreads();
  if (tid < nq) {
    p.lse[qrow0 + tid] = lse_s[tid];
    p.delta[qrow0 + tid] = dl_s[tid];
  }
}

// ---------------------------------------------------------------------------
// (ii) dK, dV: block (key tile, KV head, row)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkdv_kernel(const Args p) {
  extern __shared__ float sm[];
  const int BQ = p.bq, BKV = p.bkv, ri = BQ / 16, rj = BKV / 16;
  constexpr int DP = D + 1;
  const int SP = BKV + 1;
  float* Ks = sm;
  float* Vs = Ks + BKV * DP;
  float* Qs = Vs + BKV * DP;
  float* dOs = Qs + BQ * DP;
  float* Ps = dOs + BQ * DP;
  float* Ss = Ps + BQ * SP;
  float* lse_s = Ss + BQ * SP;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BKV, g = blockIdx.y, b = blockIdx.z;
  const int len = row_len(p, b);
  const int nk = max(0, min(BKV, len - k0));
  const int nrows = min(BKV, p.page - k0);        // key rows this block owns
  const long long kstride = (long long)p.hk * p.d;
  const long long kbase = ((long long)b * p.page * p.hk + g) * p.d +
                          k0 * kstride;
  T* dK = static_cast<T*>(p.dk) + kbase;
  T* dV = static_cast<T*>(p.dv) + kbase;
  const int off = len - p.sq;

  float acck[kMaxR][D / 16], accv[kMaxR][D / 16];
#pragma unroll
  for (int a = 0; a < kMaxR; ++a)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acck[a][c] = accv[a][c] = 0.f;

  if (nk > 0) {
    load_tile<T, D>(Ks, static_cast<const T*>(p.k) + kbase, kstride, BKV, nk,
                    p.d);
    load_tile<T, D>(Vs, static_cast<const T*>(p.v) + kbase, kstride, BKV, nk,
                    p.d);
    // the queries that see some key k0 .. k0 + nk - 1
    const int qlo = p.causal ? max(0, k0 - off) : 0;
    const int qhi = p.window > 0 ? min(p.sq, k0 + nk - 1 + p.window - off)
                                 : p.sq;
    float s[kMaxR][kMaxR], dp[kMaxR][kMaxR];
    for (int hh = g * p.group; hh < (g + 1) * p.group; ++hh) {
      const long long hrow = ((long long)b * p.h + hh) * p.sq;
      for (int q0 = (qlo / BQ) * BQ; q0 < qhi; q0 += BQ) {
        const int nq = min(BQ, p.sq - q0);
        __syncthreads();
        load_tile<T, D>(Qs, static_cast<const T*>(p.q) + (hrow + q0) * p.d,
                        p.d, BQ, nq, p.d);
        load_tile<T, D>(dOs,
                        static_cast<const T*>(p.dout) + (hrow + q0) * p.d,
                        p.d, BQ, nq, p.d);
        if (tid < BQ) {
          lse_s[tid] = tid < nq ? p.lse[hrow + q0 + tid] : -INFINITY;
          dl_s[tid] = tid < nq ? p.delta[hrow + q0 + tid] : 0.f;
        }
        __syncthreads();
        dot_tile<D>(s, Qs, Ks, ri, rj, ty, tx);
        dot_tile<D>(dp, dOs, Vs, ri, rj, ty, tx);
        probs(p, s, dp, lse_s, dl_s, q0, k0, off, len, ri, rj, ty, tx);
#pragma unroll
        for (int a = 0; a < kMaxR; ++a)
#pragma unroll
          for (int bb = 0; bb < kMaxR; ++bb)
            if (a < ri && bb < rj) {
              Ps[(ty + 16 * a) * SP + tx + 16 * bb] = s[a][bb];
              Ss[(ty + 16 * a) * SP + tx + 16 * bb] = dp[a][bb];
            }
        __syncthreads();
        for (int i = 0; i < BQ; ++i) {
          float dov[D / 16], qv[D / 16];
#pragma unroll
          for (int c = 0; c < D / 16; ++c) {
            dov[c] = dOs[i * DP + tx + 16 * c];
            qv[c] = Qs[i * DP + tx + 16 * c];
          }
#pragma unroll
          for (int a = 0; a < kMaxR; ++a) {
            if (a >= rj) continue;
            const float pv = Ps[i * SP + ty + 16 * a];
            const float sv = Ss[i * SP + ty + 16 * a];
#pragma unroll
            for (int c = 0; c < D / 16; ++c) {
              accv[a][c] = fmaf(pv, dov[c], accv[a][c]);
              acck[a][c] = fmaf(sv, qv[c], acck[a][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kMaxR; ++a) {
    const int r = ty + 16 * a;
    if (a >= rj || r >= nrows) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col >= p.d) continue;
      from_f32(acck[a][c] * p.scale, dK + r * kstride + col);
      from_f32(accv[a][c], dV + r * kstride + col);
    }
  }
}

size_t dq_smem(int bq, int bkv, int D) {
  return sizeof(float) *
         (size_t)(2 * bq * (D + 1) + 2 * bkv * (D + 1) + bq * (bkv + 1) +
                  2 * bq);
}

size_t dkdv_smem(int bq, int bkv, int D) {
  return sizeof(float) *
         (size_t)(2 * bkv * (D + 1) + 2 * bq * (D + 1) +
                  2 * bq * (bkv + 1) + 2 * bq);
}

template <typename T, int D>
cudaError_t launch_typed(const Args& p, cudaStream_t stream) {
  static size_t granted_dq[kMaxDevices] = {};
  static size_t granted_kv[kMaxDevices] = {};
  const size_t s1 = dq_smem(p.bq, p.bkv, D), s2 = dkdv_smem(p.bq, p.bkv, D);
  cudaError_t err = allow_smem_once(fa_bwd_dq_kernel<T, D>, s1, granted_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem_once(fa_bwd_dkdv_kernel<T, D>, s2, granted_kv);
  if (err != cudaSuccess) return err;
  const dim3 g1((p.sq + p.bq - 1) / p.bq, p.h, p.rows);
  fa_bwd_dq_kernel<T, D><<<g1, kThreads, s1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((p.page + p.bkv - 1) / p.bkv, p.hk, p.rows);
  fa_bwd_dkdv_kernel<T, D><<<g2, kThreads, s2, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dq, dk, dv (the inputs' type) and lse, delta (f32 [rows, h, sq]) of K2's
// function at q, o, dout [rows, h, sq, d], k, v [rows, page, hk, d] and lens
// [rows]; two launches on `stream`.  Returns a cudaError_t: the format
// checks (kernels/flash_attention_bwd.py format_error mirrors them) give
// cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_h100_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const int* lens, void* dq, void* dk, void* dv,
    float* lse, float* delta, int rows, int h, int hk, int sq, int page,
    int d, int bq, int bkv, float scale, int causal, int window, int elem,
    void* stream) {
  const bool tiles_ok = (bq == 16 || bq == 32 || bq == 64) &&
                        (bkv == 16 || bkv == 32 || bkv == 64);
  if (rows <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sq <= 0 ||
      page <= 0 || d <= 0 || d > 128 || !tiles_ok || rows > kMaxGridYZ ||
      h > kMaxGridYZ || window < 0 || (elem != ELEM_F32 && elem != ELEM_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = d <= 64 ? 64 : 128;
  if (dkdv_smem(bq, bkv, D) > kMaxSmem || dq_smem(bq, bkv, D) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{q,     k,    v,     o,     dout, lens, dq, dk, dv,  lse,
         delta, rows, h,     hk,    h / hk, sq, page, d, bq, bkv,
         scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem == ELEM_F32)
    err = D == 64 ? launch_typed<float, 64>(p, st)
                  : launch_typed<float, 128>(p, st);
  else
    err = D == 64 ? launch_typed<__nv_bfloat16, 64>(p, st)
                  : launch_typed<__nv_bfloat16, 128>(p, st);
  return static_cast<int>(err);
}
