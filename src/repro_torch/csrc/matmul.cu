// K1 matmul_h100: C[M,N] (f32) = A[M,K] @ B[K,N], A and B both bf16 or both
// f32, B row-major [K, N] as the model stores its weights.
//
// Replaces the TPU kernel pallas_matmul (src/repro/kernels/matmul.py:73,
// _mm_kernel_cached / _mm_kernel_uncached).  The TPU walks k as the last,
// sequential grid axis and carries the sum in VMEM scratch; blocks on the card
// run in no order, so a block walks its k tiles in a loop and keeps the sum in
// registers, and a sum split across blocks is combined in a fixed order.
//
// Bound on the card: every main-path call has M <= 256 rows, so the product
// does at most M flops a byte of bf16 weight, at or below the H100's ridge of
// ~295 flop/byte: it is bound by the bytes of B, read once when bm >= M.  At
// M = 1..32 the card needs ~3.35 TB/s x ~1 us = ~3.4 MB of loads in flight
// to reach that bound, from a grid of a few column blocks.  The design:
//   - ring: `stages` A/B tiles in dynamic shared memory, filled by 16-byte
//     cp.async copies; the loads of tile k+stages-1 are in flight while tile
//     k is computed (the paper's cache(a), Z_B = stages*(bm*bk + bk*bn)*DIN).
//     Uncached leaves run one stage: load, barrier, compute.
//   - split-K: kb blocks an output tile, each over a contiguous run of k
//     tiles, grid (ceil(M/bm), ceil(N/bn), kb), so a decode step still puts
//     hundreds of blocks on the 132 SMs.  The combine is deterministic: each
//     split writes its f32 partial to a workspace [kb, M, N]; the last block
//     of a tile to take its ticket sums the partials in split order 0..kb-1,
//     writes C and resets the ticket to 0.  No float atomics.
//   - tensor cores for bf16: mma.sync m16n8k16 with f32 accumulators, A
//     fragments by ldmatrix, B fragments by ldmatrix.trans from the [k][n]
//     tile.  A warp owns a 16 x 8s tile of C (s, the paper's grain, is the
//     n8 tiles a warp owns, 4s f32 a thread); (bm/16)*(bn/(8s)) warps a
//     block.  f32 runs the same tiles, ring and split with FMA from shared
//     memory, never TF32.  Tiles are XOR-swizzled by 16-byte chunk, so the
//     8 rows an ldmatrix reads fall in 8 different bank groups.
// Batched entry (the experts of a mixture-of-experts layer): E independent
// products C[e] = A[e] @ B[e] over A [E, M, K], B [E, K, N], C [E, M, N], one
// launch, the grid's z carrying E x kb blocks (expert-major); each block runs
// the same body on its expert's operands, partials and tickets, so E = 1 is
// the plain entry.  Every expert's weights are read, whether or not a token
// reached it, as the JAX einsum over the capacity-padded dispatch reads them.
// Ragged edges: rows, columns and k past the matrix are zero-filled in
// shared memory (cp.async with a source size of 0) and never stored.  The
// 16-byte copies need N (for B) and K (for A) multiples of 8 bf16 or 4 f32
// and 16-byte-aligned bases; an operand that breaks this is loaded element
// by element, masked and synchronously (no overlap, never past the end).
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxGridYZ = 65535;

struct Args {
  const void* a;
  const void* b;
  float* c;
  float* ws;           // [kb, M, N] partials (kb > 1)
  int* tickets;        // one a (row block, column block), 0 at rest
  int E, M, N, K, bm, bn, bk, kb;
  int per;             // k tiles a split
  int a_vec, b_vec;    // 16-byte copies allowed for A, for B
};

// Physical 16-byte chunk of logical chunk c in row r of a tile w chunks
// wide (w a power of two >= 4).
__device__ __forceinline__ int swz(int r, int c, int w) {
  return w >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));
}

// A tile [rows][cols] of g (leading dimension ld) from (r0, c0), swizzled,
// zero outside [nrows, ncols).  cols is a power of two, a whole number of
// 16-byte chunks.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, T* s,
                                          int rows, int cols, int r0, int c0,
                                          int nrows, int ncols, int ld,
                                          bool vec) {
  constexpr int EPC = 16 / sizeof(T);           // elements a chunk
  const int w = cols / EPC;
  const int lw = __ffs(w) - 1;
  if (vec) {
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int r = i >> lw, c = i & (w - 1);
      const int gr = r0 + r, gc = c0 + c * EPC;
      const bool ok = gr < nrows && gc < ncols;
      const T* src = ok ? g + (size_t)gr * ld + gc : g;
      cp_async16(s + (r * w + swz(r, c, w)) * EPC, src, ok);
    }
  } else {
    // element by element, eight loads in flight a thread before any store
    constexpr int kBatch = 8;
    const int lc = __ffs(cols) - 1, total = rows * cols;
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
      T v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * blockDim.x;
        const int gr = r0 + (i >> lc), gc = c0 + (i & (cols - 1));
        v[j] = (i < total && gr < nrows && gc < ncols)
                   ? g[(size_t)gr * ld + gc] : T(0.f);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * blockDim.x;
        const int r = i >> lc, e = i & (cols - 1);
        if (i < total) s[(r * w + swz(r, e / EPC, w)) * EPC + e % EPC] = v[j];
      }
    }
  }
}

// One k tile on the tensor cores: the warp's 16 x 8S tile of C.
// Fragments of m16n8k16 (g = lane / 4, q = lane % 4): a thread holds
// A[g | g+8][2q, 2q+1 | +8], B[2q, 2q+1 | +8][g], C[g | g+8][2q, 2q+1].
template <int S>
__device__ __forceinline__ void compute(const __nv_bfloat16* As,
                                        const __nv_bfloat16* Bs, int bk,
                                        int bn, int wm, int wn, int lane,
                                        float (&acc)[S][4]) {
  const int wa = bk / 8, wb = bn / 8;
  const int j = lane >> 3, rr = lane & 7;
  const int ar = wm * 16 + (j & 1) * 8 + rr;   // A row this lane addresses
  for (int kk = 0; kk < bk; kk += 16) {
    unsigned a[4];
    const int ac = (kk >> 3) + (j >> 1);
    ldmatrix_x4(a, As + (ar * wa + swz(ar, ac, wa)) * 8);
    const int k = kk + (j & 1) * 8 + rr;       // B row this lane addresses
    if constexpr (S == 1) {
      unsigned b[2];
      const int c = wn;
      ldmatrix_x2_trans(b, Bs + (k * wb + swz(k, c, wb)) * 8);
      mma_bf16(acc[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int t = 0; t < S; t += 2) {          // two n8 tiles a load
        unsigned b[4];
        const int c = wn * S + t + (j >> 1);
        ldmatrix_x4_trans(b, Bs + (k * wb + swz(k, c, wb)) * 8);
        mma_bf16(acc[t], a, b[0], b[1]);
        mma_bf16(acc[t + 1], a, b[2], b[3]);
      }
    }
  }
}

// One k tile in f32 FMA, the same fragment layout, k in order.
template <int S>
__device__ __forceinline__ void compute(const float* As, const float* Bs,
                                        int bk, int bn, int wm, int wn,
                                        int lane, float (&acc)[S][4]) {
  const int wa = bk / 4, wb = bn / 4;
  const int r0 = wm * 16 + (lane >> 2), r1 = r0 + 8;
  const int q2 = 2 * (lane & 3);
  for (int k = 0; k < bk; ++k) {
    const int c = k >> 2, e = k & 3;
    const float a0 = As[(r0 * wa + swz(r0, c, wa)) * 4 + e];
    const float a1 = As[(r1 * wa + swz(r1, c, wa)) * 4 + e];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int n = (wn * S + t) * 8 + q2;     // even: n, n+1 in one chunk
      const float2 bv = *reinterpret_cast<const float2*>(
          Bs + (k * wb + swz(k, n >> 2, wb)) * 4 + (n & 3));
      acc[t][0] = fmaf(a0, bv.x, acc[t][0]);
      acc[t][1] = fmaf(a0, bv.y, acc[t][1]);
      acc[t][2] = fmaf(a1, bv.x, acc[t][2]);
      acc[t][3] = fmaf(a1, bv.y, acc[t][3]);
    }
  }
}

template <typename T, int S, int STAGES>
__global__ void __launch_bounds__(kMaxThreads) matmul_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int a_elems = p.bm * p.bk, b_elems = p.bk * p.bn;
  T* As = reinterpret_cast<T*>(smem_raw);       // [STAGES][bm][bk]
  T* Bs = As + STAGES * a_elems;                // [STAGES][bk][bn]
  // blockIdx.z = expert * kb + split: the expert's operands, output,
  // partials [kb, M, N] and tickets
  const int split = blockIdx.z % p.kb, ex = blockIdx.z / p.kb;
  const size_t MN = (size_t)p.M * p.N;
  const T* A = static_cast<const T*>(p.a) + ex * (size_t)p.M * p.K;
  const T* B = static_cast<const T*>(p.b) + ex * (size_t)p.K * p.N;
  float* C = p.c + ex * MN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wcols = p.bn / (8 * S);
  const int wm = warp / wcols, wn = warp % wcols;
  const int m0 = blockIdx.x * p.bm, n0 = blockIdx.y * p.bn;
  const int nkt = (p.K + p.bk - 1) / p.bk;
  const int kt0 = split * p.per;
  const int nt = max(0, min(nkt, kt0 + p.per) - kt0);
  // a warp whose rows or columns all lie past the matrix only loads
  const bool live = m0 + wm * 16 < p.M && n0 + wn * 8 * S < p.N;
  float acc[S][4];
#pragma unroll
  for (int t = 0; t < S; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  auto load = [&](int kt, int slot) {
    const int k0 = (kt0 + kt) * p.bk;
    load_tile(A, As + slot * a_elems, p.bm, p.bk, m0, k0, p.M, p.K, p.K,
              p.a_vec);
    load_tile(B, Bs + slot * b_elems, p.bk, p.bn, k0, n0, p.K, p.N, p.N,
              p.b_vec);
  };
  if constexpr (STAGES == 1) {
    for (int i = 0; i < nt; ++i) {
      __syncthreads();
      load(i, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (live) compute<S>(As, Bs, p.bk, p.bn, wm, wn, lane, acc);
    }
  } else {
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nt) load(i, i);
      cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      cp_async_wait<STAGES - 2>();    // tile i has landed (this thread)
      __syncthreads();                // ... every thread's; slot i-1 free
      if (i + STAGES - 1 < nt) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      cp_async_commit();
      const int slot = i % STAGES;
      if (live)
        compute<S>(As + slot * a_elems, Bs + slot * b_elems, p.bk, p.bn, wm,
                   wn, lane, acc);
    }
    cp_async_wait<0>();
  }

  const int r0 = m0 + wm * 16 + (lane >> 2);
  const int cq = n0 + wn * 8 * S + 2 * (lane & 3);
  float* ws = p.kb == 1 ? nullptr : p.ws + (size_t)ex * p.kb * MN;
  float* out = p.kb == 1 ? C : ws + split * MN;
#pragma unroll
  for (int t = 0; t < S; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >> 1) * 8, c = cq + t * 8 + (e & 1);
      if (live && r < p.M && c < p.N) out[(size_t)r * p.N + c] = acc[t][e];
    }
  if (p.kb == 1) return;

  // split-K: the last of the tile's kb blocks sums the partials in order
  __threadfence();                     // this thread's partials, then ...
  __syncthreads();                     // ... every thread's, before the ticket
  const int tile = (ex * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  int ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(&p.tickets[tile], 1);
  if (!__syncthreads_or(threadIdx.x == 0 && ticket == p.kb - 1)) return;
  __threadfence();
#pragma unroll
  for (int t = 0; t < S; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >> 1) * 8, c = cq + t * 8 + (e & 1);
      if (!(live && r < p.M && c < p.N)) continue;
      const size_t at = (size_t)r * p.N + c;
      float v = 0.f;
      for (int z = 0; z < p.kb; ++z)
        v += z == split ? acc[t][e] : __ldcg(ws + z * MN + at);
      C[at] = v;
    }
  if (threadIdx.x == 0) p.tickets[tile] = 0;
}

template <typename T, int S, int STAGES>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  auto kernel = matmul_kernel<T, S, STAGES>;
  const size_t smem = (size_t)STAGES * (p.bm * p.bk + p.bk * p.bn) * sizeof(T);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static size_t granted[kMaxDevices] = {};
  const cudaError_t err = allow_smem_once(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + p.bm - 1) / p.bm, (p.N + p.bn - 1) / p.bn,
                  p.E * p.kb);
  const int threads = 32 * (p.bm / 16) * (p.bn / (8 * S));
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t by_stages(const Args& p, int stages, cudaStream_t st) {
  switch (stages) {
    case 1: return launch<T, S, 1>(p, st);
    case 2: return launch<T, S, 2>(p, st);
    case 4: return launch<T, S, 4>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_grain(const Args& p, int s, int stages, cudaStream_t st) {
  switch (s) {
    case 1: return by_stages<T, 1>(p, stages, st);
    case 2: return by_stages<T, 2>(p, stages, st);
    default: return cudaErrorInvalidValue;
  }
}

bool pow2_at_least(int x, int lo) { return x >= lo && (x & (x - 1)) == 0; }

}  // namespace

// Formats it takes (kernels/matmul.py: format_error mirrors these checks):
// bm a multiple of 16; bn and bk powers of two >= 32; s in {1, 2};
// stages in {1, 2, 4} (an uncached leaf runs 1); kb >= 1 with a workspace
// and tickets when kb > 1; at most 1024 threads, 65,535 column blocks and
// 65,535 experts x splits; the ring within 232,448 bytes of shared memory.
static int run(const void* a, const void* b, void* c, void* ws,
               void* tickets, int E, int M, int N, int K, int bm, int bn,
               int bk, int s, int kb, int stages, int cached, int elem,
               void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || bm < 16 || bm % 16 != 0 ||
      !pow2_at_least(bn, 32) || !pow2_at_least(bk, 32) ||
      (s != 1 && s != 2) || kb < 1 || (long long)E * kb > kMaxGridYZ ||
      (stages != 1 && stages != 2 && stages != 4) ||
      32 * (bm / 16) * (bn / (8 * s)) > kMaxThreads ||
      (N + bn - 1) / bn > kMaxGridYZ ||
      (kb > 1 && (ws == nullptr || tickets == nullptr)) ||
      (elem != ELEM_F32 && elem != ELEM_BF16))
    return cudaErrorInvalidValue;
  const int epc = elem == ELEM_BF16 ? 8 : 4;
  const int nkt = (K + bk - 1) / bk;
  Args p{a, b, static_cast<float*>(c), static_cast<float*>(ws),
         static_cast<int*>(tickets), E, M, N, K, bm, bn, bk, kb,
         (nkt + kb - 1) / kb,
         K % epc == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0,
         N % epc == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0};
  const int run = cached ? stages : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem == ELEM_BF16 ? by_grain<__nv_bfloat16>(p, s, run, st)
                           : by_grain<float>(p, s, run, st);
}

// C [M, N] = A [M, K] @ B [K, N].
extern "C" int matmul_h100_launch(const void* a, const void* b, void* c,
                                  void* ws, void* tickets, int M, int N, int K,
                                  int bm, int bn, int bk, int s, int kb,
                                  int stages, int cached, int elem,
                                  void* stream) {
  return run(a, b, c, ws, tickets, 1, M, N, K, bm, bn, bk, s, kb, stages,
             cached, elem, stream);
}

// C [E, M, N] = A [E, M, K] @ B [E, K, N], one launch; ws holds E x kb
// partials [M, N] and tickets E x the tiles of one product.
extern "C" int matmul_h100_batched_launch(const void* a, const void* b,
                                          void* c, void* ws, void* tickets,
                                          int E, int M, int N, int K, int bm,
                                          int bn, int bk, int s, int kb,
                                          int stages, int cached, int elem,
                                          void* stream) {
  return run(a, b, c, ws, tickets, E, M, N, K, bm, bn, bk, s, kb, stages,
             cached, elem, stream);
}
