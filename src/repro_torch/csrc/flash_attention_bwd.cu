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
// byte at sq 1024: bound by operations, which in bf16 only the tensor cores
// reach.  No atomics anywhere, so two launches give the same bits.  Two
// bodies:
//
// bf16, on the tensor cores (three launches):
//   (o)  lse: one block per (query tile of bq, query head, row), a warp a 16
//        queries.  S = Q K^T by mma.sync m16n8k16 from XOR-swizzled [row][D]
//        bf16 tiles (attention_tiles.cuh, K2's scores), K tiles of bkv keys
//        through a two-stage cp.async ring; each thread keeps a running max
//        and sum of its own score columns, combined over the quad of lanes
//        of a row at the end: lse = m + log l.  delta = rowsum(dO * O), a
//        warp a row.  It writes lse and delta.
//   (i)  dq: the same blocks.  Q and dO tiles loaded once; K and V tiles of
//        bkv keys through the ring; for each 16 keys of a tile that some
//        query of the warp sees: S = Q K^T and dP = dO V^T by mma.sync,
//        P = exp(scale S - lse) and dS = P (dP - delta) on the f32
//        fragments, dS rounded to bf16 as the A operand of dQ += dS K (K by
//        ldmatrix.trans, K2's pv); dQ in f32 registers, scaled and written
//        once.
//   (ii) dkdv: one block per (key tile of bkv, KV head, row), a warp a 16
//        keys.  K and V stay in shared memory (their fragments are loaded by
//        ldmatrix for each product: the dK and dV sums alone take 128
//        registers a thread at d 128); the group's query heads and their
//        visible query tiles of bq come through the ring with their lse and
//        delta, and for each 16 queries: S^T = K Q^T, dP^T = V dO^T,
//        P^T and dS^T on the fragments, dV += P^T dO and dK += dS^T Q (dO
//        and Q by ldmatrix.trans).
//   Masks are evaluated only on the 16 x 16 blocks that a causal limit, a
//   window or a row's length cuts, and blocks no query sees are skipped.
//   Operands whose d or base breaks 16-byte alignment are loaded element by
//   element, masked, synchronously.
//
// f32, FMA on f32 tiles (two launches; never TF32, as K2 runs f32):
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
#include "attention_tiles.cuh"

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
  int vec;             // bf16 body: 16-byte copies allowed for q, k, v, dO
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
// The f32 body.  (i) dQ, lse, delta: block (query tile, query head, row)
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

// ---------------------------------------------------------------------------
// The bf16 body on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kMaxTcThreads = 128;      // 16 rows a warp, at most 64 rows

// Whether no pair (none) or every pair (all) of queries i0 .. i0 + 15 and
// keys k0 .. k0 + 15 of a row of `len` keys is visible (off = len - sq).
struct Cut {
  bool none, all;
};

__device__ __forceinline__ Cut cut16(const Args& p, int i0, int k0, int len,
                                     int off) {
  const int lo = i0 + off, hi = i0 + 15 + off;    // the queries' positions
  Cut c;
  c.none = i0 >= p.sq || k0 >= len || (p.causal && k0 > hi) ||
           (p.window > 0 && k0 + 15 <= lo - p.window);
  c.all = i0 + 16 <= p.sq && k0 + 16 <= len && (!p.causal || k0 + 15 <= lo) &&
          (p.window <= 0 || k0 > hi - p.window);
  return c;
}

// The keys some query q0 .. q0 + nq - 1 sees: tiles of bkv from t0, ntiles.
__device__ __forceinline__ void key_tiles(const Args& p, int q0, int nq,
                                          int len, int& t0, int& ntiles) {
  const int off = len - p.sq;
  int kbeg = 0, kend = len;
  if (p.causal) kend = min(kend, q0 + nq - 1 + off + 1);
  if (p.window > 0) kbeg = max(0, q0 + off - p.window + 1);
  t0 = (kbeg / p.bkv) * p.bkv;
  ntiles = kend > t0 ? (kend - t0 + p.bkv - 1) / p.bkv : 0;
}

// (o) lse and delta: block (query tile, query head, row)
template <int D>
__global__ void __launch_bounds__(kMaxTcThreads)
    fa_bwd_lse_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int BQ = p.bq, BKV = p.bkv;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);        // [BQ][D]
  bf16* ring = Qs + BQ * D;                             // [2][BKV][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int len = row_len(p, b), off = len - p.sq;
  const int nq = min(BQ, p.sq - q0);
  const long long qrow0 = ((long long)b * p.h + hh) * p.sq + q0;
  const bf16* Q = static_cast<const bf16*>(p.q) + qrow0 * p.d;
  const long long kstride = (long long)p.hk * p.d;
  const bf16* K = static_cast<const bf16*>(p.k) +
                  ((long long)b * p.page * p.hk + hh / p.group) * p.d;
  int t0, ntiles;
  key_tiles(p, q0, nq, len, t0, ntiles);
  auto load_k = [&](int i) {
    const int k0 = t0 + i * BKV;
    load_rows<bf16, D>(ring + (i & 1) * BKV * D, BKV, p.d, p.vec, K,
                       [&](int r) -> const bf16* {
                         return k0 + r < len ? K + (k0 + r) * kstride
                                             : nullptr;
                       });
  };
  load_rows<bf16, D>(Qs, BQ, p.d, p.vec, Q, [&](int r) -> const bf16* {
    return r < nq ? Q + (long long)r * p.d : nullptr;
  });
  if (ntiles > 0) load_k(0);
  cp_async_commit();

  // delta = rowsum(dO * O) in f32, while the tiles land: D / 8 lanes a
  // row, 8 columns a lane (the loads of a lane independent), then the
  // row's lanes sum by xor shuffles (D / 8 divides 32, and every warp runs
  // the loop the same number of times)
  {
    constexpr int CH = D / 8;
    const bf16* O = static_cast<const bf16*>(p.o) + qrow0 * p.d;
    const bf16* dO = static_cast<const bf16*>(p.dout) + qrow0 * p.d;
    for (int idx = threadIdx.x; idx < BQ * CH; idx += blockDim.x) {
      const int r = idx / CH, c0 = (idx % CH) * 8;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long at = (long long)r * p.d + c0 + e;
        if (r < nq && c0 + e < p.d)
          acc = fmaf(to_f32(dO[at]), to_f32(O[at]), acc);
      }
#pragma unroll
      for (int o = CH / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (c0 == 0 && r < nq) p.delta[qrow0 + r] = acc;
    }
  }

  const int w0 = warp * 16, g = lane >> 2, q2 = 2 * (lane & 3);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();                    // tile i (and Q) landed, here
    __syncthreads();                       // ... everywhere; slot i-1 free
    if (i + 1 < ntiles) load_k(i + 1);
    cp_async_commit();
    const bf16* Ks = ring + (i & 1) * BKV * D;
    const int k0 = t0 + i * BKV;
    for (int u = 0; u < BKV / 16; ++u) {
      const Cut c = cut16(p, q0 + w0, k0 + 16 * u, len, off);
      if (c.none) continue;                // uniform over the warp
      float s[2][4] = {};
      scores<D, 16, 2>(Ks, 16 * u, 2, w0, Qs, lane, s);
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int iq = q0 + w0 + g + 8 * r2;
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = k0 + 16 * u + 8 * t + q2 + e;
            float& x = s[t][2 * r2 + e];
            x = (c.all || visible(p, iq, iq + off, j, len)) ? x * p.scale
                                                            : -INFINITY;
            mx = fmaxf(mx, x);
          }
        if (mx > m[r2]) {                  // m = -inf at first: l is 0
          l[r2] *= __expf(m[r2] - mx);
          m[r2] = mx;
        }
        if (m[r2] != -INFINITY) {
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              l[r2] += __expf(s[t][2 * r2 + e] - m[r2]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // the quad of lanes that share a row combines its columns' (m, l)
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r2], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r2], o);
      const float mn = fmaxf(m[r2], m2);
      if (mn != -INFINITY)
        l[r2] = l[r2] * __expf(m[r2] - mn) + l2 * __expf(m2 - mn);
      m[r2] = mn;
    }
    const int r = w0 + g + 8 * r2;
    if ((lane & 3) == 0 && r < nq)
      p.lse[qrow0 + r] = l[r2] > 0.f ? m[r2] + __logf(l[r2]) : -INFINITY;
  }
}

// (i) dQ: block (query tile, query head, row)
template <int D>
__global__ void __launch_bounds__(kMaxTcThreads)
    fa_bwd_dq_tc_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int BQ = p.bq, BKV = p.bkv;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);        // [BQ][D]
  bf16* dOs = Qs + BQ * D;                              // [BQ][D]
  bf16* ring = dOs + BQ * D;                            // [2][K, V][BKV][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int len = row_len(p, b), off = len - p.sq;
  const int nq = min(BQ, p.sq - q0);
  const long long qrow0 = ((long long)b * p.h + hh) * p.sq + q0;
  const bf16* Q = static_cast<const bf16*>(p.q) + qrow0 * p.d;
  const bf16* dO = static_cast<const bf16*>(p.dout) + qrow0 * p.d;
  const long long kstride = (long long)p.hk * p.d;
  const long long kbase =
      ((long long)b * p.page * p.hk + hh / p.group) * p.d;
  const bf16* K = static_cast<const bf16*>(p.k) + kbase;
  const bf16* V = static_cast<const bf16*>(p.v) + kbase;
  int t0, ntiles;
  key_tiles(p, q0, nq, len, t0, ntiles);
  auto load_kv = [&](int i) {
    const int k0 = t0 + i * BKV;
    bf16* Ks = ring + (i & 1) * 2 * BKV * D;
    load_rows<bf16, D>(Ks, BKV, p.d, p.vec, K, [&](int r) -> const bf16* {
      return k0 + r < len ? K + (k0 + r) * kstride : nullptr;
    });
    load_rows<bf16, D>(Ks + BKV * D, BKV, p.d, p.vec, V,
                       [&](int r) -> const bf16* {
                         return k0 + r < len ? V + (k0 + r) * kstride
                                             : nullptr;
                       });
  };
  load_rows<bf16, D>(Qs, BQ, p.d, p.vec, Q, [&](int r) -> const bf16* {
    return r < nq ? Q + (long long)r * p.d : nullptr;
  });
  load_rows<bf16, D>(dOs, BQ, p.d, p.vec, dO, [&](int r) -> const bf16* {
    return r < nq ? dO + (long long)r * p.d : nullptr;
  });
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  const int w0 = warp * 16, g = lane >> 2, q2 = 2 * (lane & 3);
  float lse[2], dl[2];
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int r = w0 + g + 8 * r2;
    lse[r2] = r < nq ? p.lse[qrow0 + r] : 0.f;
    dl[r2] = r < nq ? p.delta[qrow0 + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < ntiles) load_kv(i + 1);
    cp_async_commit();
    const bf16* Ks = ring + (i & 1) * 2 * BKV * D;
    const bf16* Vs = Ks + BKV * D;
    const int k0 = t0 + i * BKV;
    for (int u = 0; u < BKV / 16; ++u) {
      const Cut c = cut16(p, q0 + w0, k0 + 16 * u, len, off);
      if (c.none) continue;
      float s[2][4] = {}, dp[2][4] = {};
      scores<D, 16, 2>(Ks, 16 * u, 2, w0, Qs, lane, s);
      scores<D, 16, 2>(Vs, 16 * u, 2, w0, dOs, lane, dp);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r2 = e >> 1, iq = q0 + w0 + g + 8 * r2;
          const int j = k0 + 16 * u + 8 * t + q2 + (e & 1);
          const float pr = c.all || visible(p, iq, iq + off, j, len)
                               ? __expf(s[t][e] * p.scale - lse[r2])
                               : 0.f;
          dp[t][e] = pr * (dp[t][e] - dl[r2]);
        }
      pv<D, 16>(dp, Ks, 16 * u, 2, nullptr, lane, acc);
    }
  }
  cp_async_wait<0>();
  bf16* dQ = static_cast<bf16*>(p.dq) + qrow0 * p.d;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int r = w0 + g + 8 * r2;
    if (r >= nq) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store2(dQ + (long long)r * p.d, c * 8 + q2, p.d,
             acc[c][2 * r2] * p.scale, acc[c][2 * r2 + 1] * p.scale);
  }
}

// (ii) dK, dV: block (key tile, KV head, row)
template <int D>
__global__ void __launch_bounds__(kMaxTcThreads)
    fa_bwd_dkdv_tc_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int BQ = p.bq, BKV = p.bkv;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);        // [BKV][D]
  bf16* Vs = Ks + BKV * D;                              // [BKV][D]
  // the ring: [2] x (Q [BQ][D], dO [BQ][D] bf16, lse [BQ], delta [BQ] f32)
  unsigned char* ring = reinterpret_cast<unsigned char*>(Vs + BKV * D);
  const int stage = 2 * BQ * D * (int)sizeof(bf16) + 2 * BQ * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BKV, g = blockIdx.y, b = blockIdx.z;
  const int len = row_len(p, b), off = len - p.sq;
  const int nk = max(0, min(BKV, len - k0));
  const int nrows = min(BKV, p.page - k0);        // key rows this block owns
  const long long kstride = (long long)p.hk * p.d;
  const long long kbase =
      ((long long)b * p.page * p.hk + g) * p.d + k0 * kstride;
  const bf16* Kg = static_cast<const bf16*>(p.k) + kbase;
  const bf16* Vg = static_cast<const bf16*>(p.v) + kbase;
  const bf16* Qg = static_cast<const bf16*>(p.q);
  const bf16* dOg = static_cast<const bf16*>(p.dout);

  // the query tiles that see some key k0 .. k0 + nk - 1, in each of the
  // group's heads: tile t is head g * group + t / nqt, queries qs + (t %
  // nqt) * BQ
  const int qlo = p.causal ? max(0, k0 - off) : 0;
  const int qhi = p.window > 0 ? min(p.sq, k0 + nk - 1 + p.window - off)
                               : p.sq;
  const int qs = (qlo / BQ) * BQ;
  const int nqt = nk > 0 && qhi > qs ? (qhi - qs + BQ - 1) / BQ : 0;
  const int ntiles = p.group * nqt;
  auto tile_row = [&](int t, int& q0) -> long long {
    q0 = qs + (t % nqt) * BQ;
    return ((long long)b * p.h + g * p.group + t / nqt) * p.sq + q0;
  };
  auto load_q = [&](int t) {
    int q0;
    const long long row0 = tile_row(t, q0);
    const int nq = min(BQ, p.sq - q0);
    unsigned char* st = ring + (t & 1) * stage;
    bf16* Qs = reinterpret_cast<bf16*>(st);
    load_rows<bf16, D>(Qs, BQ, p.d, p.vec, Qg, [&](int r) -> const bf16* {
      return r < nq ? Qg + (row0 + r) * p.d : nullptr;
    });
    load_rows<bf16, D>(Qs + BQ * D, BQ, p.d, p.vec, dOg,
                       [&](int r) -> const bf16* {
                         return r < nq ? dOg + (row0 + r) * p.d : nullptr;
                       });
    float* ls = reinterpret_cast<float*>(Qs + 2 * BQ * D);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      if (r < nq) {
        cp_async4(ls + r, p.lse + row0 + r);
        cp_async4(ls + BQ + r, p.delta + row0 + r);
      } else {
        ls[r] = 0.f;
        ls[BQ + r] = 0.f;
      }
    }
  };
  if (ntiles > 0) {
    load_rows<bf16, D>(Ks, BKV, p.d, p.vec, Kg, [&](int r) -> const bf16* {
      return r < nk ? Kg + r * kstride : nullptr;
    });
    load_rows<bf16, D>(Vs, BKV, p.d, p.vec, Vg, [&](int r) -> const bf16* {
      return r < nk ? Vg + r * kstride : nullptr;
    });
    load_q(0);
  }
  cp_async_commit();

  const int w0 = warp * 16, gq = lane >> 2, q2 = 2 * (lane & 3);
  const int kw = k0 + w0;                  // the warp's first key
  float acck[D / 8][4], accv[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[c][e] = accv[c][e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < ntiles) load_q(t + 1);
    cp_async_commit();
    int q0;
    tile_row(t, q0);
    const bf16* Qs = reinterpret_cast<const bf16*>(ring + (t & 1) * stage);
    const bf16* dOs = Qs + BQ * D;
    const float* ls = reinterpret_cast<const float*>(dOs + BQ * D);
    const float* dls = ls + BQ;
    for (int u = 0; u < BQ / 16; ++u) {
      const Cut c = cut16(p, q0 + 16 * u, kw, len, off);
      if (c.none) continue;
      float st[2][4] = {}, dpt[2][4] = {};
      scores<D, 16, 2>(Qs, 16 * u, 2, w0, Ks, lane, st);
      scores<D, 16, 2>(dOs, 16 * u, 2, w0, Vs, lane, dpt);
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        const int col = 16 * u + 8 * t2 + q2;          // even
        const float2 lv = *reinterpret_cast<const float2*>(ls + col);
        const float2 dv = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kw + gq + 8 * (e >> 1), iq = q0 + col + (e & 1);
          const float pr = c.all || visible(p, iq, iq + off, j, len)
                               ? __expf(st[t2][e] * p.scale -
                                        ((e & 1) ? lv.y : lv.x))
                               : 0.f;
          st[t2][e] = pr;
          dpt[t2][e] = pr * (dpt[t2][e] - ((e & 1) ? dv.y : dv.x));
        }
      }
      pv<D, 16>(st, dOs, 16 * u, 2, nullptr, lane, accv);
      pv<D, 16>(dpt, Qs, 16 * u, 2, nullptr, lane, acck);
    }
  }
  cp_async_wait<0>();
  bf16* dK = static_cast<bf16*>(p.dk) + kbase;
  bf16* dV = static_cast<bf16*>(p.dv) + kbase;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int r = w0 + gq + 8 * r2;
    if (r >= nrows) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      store2(dK + r * kstride, c * 8 + q2, p.d, acck[c][2 * r2] * p.scale,
             acck[c][2 * r2 + 1] * p.scale);
      store2(dV + r * kstride, c * 8 + q2, p.d, accv[c][2 * r2],
             accv[c][2 * r2 + 1]);
    }
  }
}

// Shared bytes of the bf16 body's kernels (kernels/flash_attention_bwd.py
// tc_smem_bytes mirrors them).
size_t lse_tc_smem(int bq, int bkv, int D) {
  return sizeof(bf16) * (size_t)(bq * D + 2 * bkv * D);
}

size_t dq_tc_smem(int bq, int bkv, int D) {
  return sizeof(bf16) * (size_t)(2 * bq * D + 4 * bkv * D);
}

size_t dkdv_tc_smem(int bq, int bkv, int D) {
  return sizeof(bf16) * (size_t)(2 * bkv * D + 4 * bq * D) + 16 * (size_t)bq;
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

// f32: the FMA body's two kernels
template <int D>
cudaError_t launch_f32(const Args& p, cudaStream_t stream) {
  static size_t granted_dq[kMaxDevices] = {};
  static size_t granted_kv[kMaxDevices] = {};
  const size_t s1 = dq_smem(p.bq, p.bkv, D), s2 = dkdv_smem(p.bq, p.bkv, D);
  cudaError_t err =
      allow_smem_once(fa_bwd_dq_kernel<float, D>, s1, granted_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem_once(fa_bwd_dkdv_kernel<float, D>, s2, granted_kv);
  if (err != cudaSuccess) return err;
  const dim3 g1((p.sq + p.bq - 1) / p.bq, p.h, p.rows);
  fa_bwd_dq_kernel<float, D><<<g1, kThreads, s1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((p.page + p.bkv - 1) / p.bkv, p.hk, p.rows);
  fa_bwd_dkdv_kernel<float, D><<<g2, kThreads, s2, stream>>>(p);
  return cudaGetLastError();
}

// bf16: the tensor-core body's three kernels, a warp a 16 rows of the block
template <int D>
cudaError_t launch_tc(const Args& p, cudaStream_t stream) {
  static size_t granted_l[kMaxDevices] = {};
  static size_t granted_q[kMaxDevices] = {};
  static size_t granted_kv[kMaxDevices] = {};
  const size_t s0 = lse_tc_smem(p.bq, p.bkv, D);
  const size_t s1 = dq_tc_smem(p.bq, p.bkv, D);
  const size_t s2 = dkdv_tc_smem(p.bq, p.bkv, D);
  cudaError_t err = allow_smem_once(fa_bwd_lse_kernel<D>, s0, granted_l);
  if (err != cudaSuccess) return err;
  err = allow_smem_once(fa_bwd_dq_tc_kernel<D>, s1, granted_q);
  if (err != cudaSuccess) return err;
  err = allow_smem_once(fa_bwd_dkdv_tc_kernel<D>, s2, granted_kv);
  if (err != cudaSuccess) return err;
  const dim3 g1((p.sq + p.bq - 1) / p.bq, p.h, p.rows);
  fa_bwd_lse_kernel<D><<<g1, 2 * p.bq, s0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq_tc_kernel<D><<<g1, 2 * p.bq, s1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((p.page + p.bkv - 1) / p.bkv, p.hk, p.rows);
  fa_bwd_dkdv_tc_kernel<D><<<g2, 2 * p.bkv, s2, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// dq, dk, dv (the inputs' type) and lse, delta (f32 [rows, h, sq]) of K2's
// function at q, o, dout [rows, h, sq, d], k, v [rows, page, hk, d] and lens
// [rows]; two launches on `stream` in f32, three in bf16.  Returns a
// cudaError_t: the format checks (kernels/flash_attention_bwd.py
// format_error mirrors them) give cudaErrorInvalidValue.
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
         scale, causal, window,
         d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(dout)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem == ELEM_F32)
    err = D == 64 ? launch_f32<64>(p, st) : launch_f32<128>(p, st);
  else
    err = D == 64 ? launch_tc<64>(p, st) : launch_tc<128>(p, st);
  return static_cast<int>(err);
}
