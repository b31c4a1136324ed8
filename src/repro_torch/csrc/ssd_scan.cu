// K3 ssd_scan_h100: the Mamba-2 SSD scan with the state carried in and out.
// Per (row r, head h):  S_t = a_t * S_{t-1} + b_t (x) x_t ;  y_t = c_t . S_t
// over x [rows, seq, heads, hd], a [rows, seq, heads] (the decay itself, in
// (0, 1), f32), b and c [rows, seq, heads, state] given by strides (the model
// passes one [rows, seq, state] projection expanded over heads with head
// stride 0), state S0 [rows, heads, state, hd] in f32 or none (zero).
// Writes y [rows, seq, heads, hd] in x's type and the final state S1
// [rows, heads, state, hd] in f32.  S1 may be S0 itself: a block reads its
// whole (row, head, hd tile) of S0 before it writes any of it, and no other
// block touches that tile, so the state is updated in place.  An optional
// mask [rows] (bytes, 0 = left out) skips rows: a row left out keeps S1 as
// it was and gets y = 0.  An optional state_rows [rows] (int32) maps row r
// of x to row state_rows[r] of S0 and S1, which then hold srows rows; the
// indices must differ (each names the one block set that touches its
// tiles), and one outside [0, srows) leaves its row out as the mask does.
// A prefill chunk passes its layer's whole per-slot state with the slot as
// the one index, read on the device.
//
// Replaces the TPU kernel pallas_ssd_scan (src/repro/kernels/ssd_scan.py:70,
// _ssd_kernel over ssd_chunk).  The TPU walks chunks as the last, sequential
// grid axis with the state in VMEM scratch, starts from a zero state, pads
// seq with a = 1 and x = b = c = 0, and returns only y.  Here one block walks
// its chunks in order in a loop with its state tile resident in shared
// memory; it starts from S0 and writes S1, so chunked prefill resumes from
// the previous chunk.  The last chunk is cut at seq: nothing is padded in
// device memory.
//
// Bound on the card: a decode step reads and writes the f32 state (state x hd
// a head, 32 KB at mamba2-130m's 128 x 64) for 5 flops an element: bound by
// bytes.  A prefill chunk does about 5*state*hd flops a token and head on
// 2*hd bytes of x and y, so at state 128 it is bound by operations.  Three
// bodies, all on a grid (rows * heads, ceil(hd / bd)), a block owning bd
// columns of one (row, head) (the columns of S are independent):
//
//   step (seq <= 8, any type, when a thread's rows hold the state): the
//     recurrence itself, step by step, with no scan, no score tile and no
//     chunk loop, so the state is read and written once.  Thread (group g,
//     column vector v) holds up to kRows 16-byte vectors of S in registers
//     (rows g, g + groups, ...), all loaded before use, and its part of
//     each step's y; then y is reduced over the state dim in a fixed order
//     (shuffles within a warp, then the warps in order through shared
//     memory), with no atomics.  Every decode step runs it; so do prefill
//     chunks of up to 8 steps, where the chunk bodies' fixed cost (the
//     scan, five barriers) dominated.
//   tensor cores (bf16, longer): per chunk of n <= ck steps, with
//     cum_t = sum_{i<=t} log a_i (warp 0 scan, f32),
//       y   = exp(cum_t) * (c S) + G x,  G[t][i] = (c_t . b_i) exp(cum_t - cum_i)
//             for i <= t (masked BEFORE exp: the differences above the
//             diagonal are positive and would overflow)
//       S   = exp(cum_last) S + (w (.) b)^T x,  w_i = exp(cum_last - cum_i)
//     on mma.sync m16n8k16 with f32 accumulators.  Rounding points: c b^T
//     takes the model's bf16 c and b as they are; G, S and w (.) b are f32
//     values, each fed as a high and a low bf16 part (two products), which
//     keeps ~16 bits: one bf16 rounding of G alone puts ~1 % of a 256-step
//     mamba chunk's y outside the 1e-2 tolerance of the plain version, one of
//     S or w (.) b breaks the state's 1e-3.  exp(cum_t) scales rows of the f32
//     product.  The x, b, c tiles (and the decays) of chunk k+1 arrive by
//     cp.async while chunk k is computed (two slots); every tile's rows are
//     padded to an odd number of 16-byte chunks, so the 8 rows an ldmatrix
//     reads fall in 8 different bank groups.  8 warps share each phase's
//     (16-row, 32-column) items.
//   FMA (f32, longer): the same chunk math on the CUDA cores from shared
//     memory, never TF32, one hd tile of bd columns a block, b and c rows
//     padded to state + 1 floats.
//
// Shared bytes (ck16 = ck rounded up to 16, np = state rounded up to 16):
//   tensor cores  4*ck16*(bd+8) + 8*ck16*(np+8) + 8*np*(bd+8) + 20*ck16
//   FMA           4*(state*bd + ck*bd + 2*ck*(state+1) + ck*ck + ck)
// which are the family's two smem counters (kernels/ssd_scan.py).  The
// opt-in above 48 KB is made once a kernel instance and device.
#include "common.cuh"
#include "ssd_tiles.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;           // every body
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kRows = 8;                // S vectors a step thread holds
constexpr int kStepSeq = 8;             // steps the step body takes

struct Args {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  const float* s0;                      // may alias s1
  void* y;
  float* s1;
  const unsigned char* mask;            // [rows] or nullptr
  const int* srow;                      // [rows] state row of each, or nullptr
  int srows;                            // rows of S0 / S1 when srow is given
  int seq, heads, hd, N, ck, bd;
  long long sb_r, sb_t, sb_h, sc_r, sc_t, sc_h;
  int vec_x, vec_bc;                    // 16-byte copies allowed (bf16)
};

size_t tc_smem(int ck, int N, int bd) {
  const size_t ck16 = (ck + 15) / 16 * 16, np = (N + 15) / 16 * 16;
  return 4 * ck16 * (bd + 8) + 8 * ck16 * (np + 8) + 8 * np * (bd + 8) +
         20 * ck16;
}

size_t fma_smem(int ck, int N, int bd) {
  return sizeof(float) * ((size_t)N * bd + (size_t)ck * bd +
                          2 * (size_t)ck * (N + 1) + (size_t)ck * ck + ck);
}

// The state row x row r reads and writes: state_rows[r] when given, else r;
// -1 for a row left out (by the mask, or by an index outside the state).
__device__ __forceinline__ int state_row(const Args& p, int r) {
  if (p.mask != nullptr && !p.mask[r]) return -1;
  if (p.srow == nullptr) return r;
  const int s = p.srow[r];
  return s >= 0 && s < p.srows ? s : -1;
}

// y = 0 for every step of a row left out (its columns j0..j0+w).
template <typename T>
__device__ void zero_y(const Args& p, int r, int h, int j0, int w) {
  T* Y = static_cast<T*>(p.y);
  const size_t xstep = (size_t)p.heads * p.hd;
  const size_t base = (size_t)r * p.seq * xstep + (size_t)h * p.hd + j0;
  for (int e = threadIdx.x; e < p.seq * w; e += blockDim.x)
    from_f32(0.f, &Y[base + (size_t)(e / w) * xstep + e % w]);
}

// ---------------------------------------------------------------------------
// step body: seq <= kStepSeq
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *src;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *dst = v[0];
}

// V columns a thread (4: 16-byte vectors of S; 1 when hd or a base breaks
// the alignment), NV = BD / V column vectors, GROUPS = kThreads / NV state
// groups: thread (g, v) holds rows g, g + GROUPS, ... (kr <= kRows of them)
// of its columns in registers, all loaded before use.  The steps' x, b, c
// (rows padded with zeros to kr * GROUPS) and decays are staged in shared
// memory while those loads are in flight, behind one barrier: a barrier
// inside the steps would wait for every load in flight, and the step loop
// then reads shared memory with no condition.  A step's y is summed over
// the state dim in a fixed order: the groups of a warp by shuffles (xor NV,
// 2 NV, ...) into the step's own slot, then, after one barrier, the warps'
// sums in warp order, one thread group a step.
template <typename T, int V, int BD>
__global__ void __launch_bounds__(kThreads) ssd_step_kernel(const Args p) {
  constexpr int NV = BD / V, GROUPS = kThreads / NV;
  constexpr int GPW = NV < 32 ? 32 / NV : 1;      // groups a warp
  constexpr int LEADS = GROUPS / GPW;
  __shared__ float red[kStepSeq][LEADS][BD];
  __shared__ T xst[kStepSeq][BD];
  __shared__ T bst[kStepSeq][GROUPS * kRows];
  __shared__ T cst[kStepSeq][GROUPS * kRows];
  __shared__ float ast[kStepSeq];
  const int r = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int j0 = blockIdx.y * BD;
  const int w = min(BD, p.hd - j0);
  const int sr = state_row(p, r);
  if (sr < 0) {
    zero_y<T>(p, r, h, j0, w);
    return;
  }
  const int v = threadIdx.x % NV, g = threadIdx.x / NV;
  const bool live = v * V < w;
  const int kr = (p.N + GROUPS - 1) / GROUPS;     // rows a thread holds
  const int np = kr * GROUPS;
  const size_t xstep = (size_t)p.heads * p.hd;
  const size_t x0 = (size_t)r * p.seq * xstep + (size_t)h * p.hd + j0;
  const size_t so = ((size_t)sr * p.heads + h) * p.N * p.hd + j0 + v * V;

  float sv[kRows][V];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {               // every load before use
    const int s = g + k * GROUPS;
#pragma unroll
    for (int e = 0; e < V; ++e) sv[k][e] = 0.f;
    if (live && s < p.N && p.s0 != nullptr)
      load_vec<V>(p.s0 + so + (size_t)s * p.hd, sv[k]);
  }
  {
    const T* X = static_cast<const T*>(p.x) + x0;
    const T* B = static_cast<const T*>(p.b) + r * p.sb_r + h * p.sb_h;
    const T* C = static_cast<const T*>(p.c) + r * p.sc_r + h * p.sc_h;
    for (int i = threadIdx.x; i < p.seq * BD; i += kThreads) {
      const int t = i / BD, c = i % BD;
      xst[t][c] = c < w ? X[(size_t)t * xstep + c] : T(0.f);
    }
    for (int i = threadIdx.x; i < p.seq * np; i += kThreads) {
      const int t = i / np, s = i % np;
      bst[t][s] = s < p.N ? B[t * p.sb_t + s] : T(0.f);
      cst[t][s] = s < p.N ? C[t * p.sc_t + s] : T(0.f);
    }
    if (threadIdx.x < p.seq)
      ast[threadIdx.x] =
          p.a[((size_t)r * p.seq + threadIdx.x) * p.heads + h];
  }
  __syncthreads();
  for (int t = 0; t < p.seq; ++t) {
    const float av = ast[t];
    float xv[V], yv[V] = {};
#pragma unroll
    for (int e = 0; e < V; ++e) xv[e] = to_f32(xst[t][v * V + e]);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k >= kr) break;
      const float bk = to_f32(bst[t][g + k * GROUPS]);
      const float ck = to_f32(cst[t][g + k * GROUPS]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sv[k][e] = av * sv[k][e] + bk * xv[e];
        yv[e] += ck * sv[k][e];
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
#pragma unroll
      for (int o = NV; o < 32; o <<= 1)
        yv[e] += __shfl_xor_sync(0xffffffffu, yv[e], o);
      if (g % GPW == 0) red[t][g / GPW][v * V + e] = yv[e];
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int s = g + k * GROUPS;
    if (live && s < p.N) store_vec<V>(p.s1 + so + (size_t)s * p.hd, sv[k]);
  }
  __syncthreads();
  if (!live) return;
  for (int t = g; t < p.seq; t += GROUPS) {       // group g sums step g, ...
    T* Y = static_cast<T*>(p.y) + x0 + (size_t)t * xstep + v * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < LEADS; ++l) acc += red[t][l][v * V + e];
      if (v * V + e < w) from_f32(acc, &Y[e]);
    }
  }
}

template <typename T>
cudaError_t launch_step(const Args& p, bool v4, dim3 grid, cudaStream_t st) {
  if (v4 && p.bd == 32) ssd_step_kernel<T, 4, 32><<<grid, kThreads, 0, st>>>(p);
  else if (v4) ssd_step_kernel<T, 4, 64><<<grid, kThreads, 0, st>>>(p);
  else if (p.bd == 32) ssd_step_kernel<T, 1, 32><<<grid, kThreads, 0, st>>>(p);
  else ssd_step_kernel<T, 1, 64><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core body: bf16, seq > 1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_tc_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ck16 = (p.ck + 15) / 16 * 16, np = (p.N + 15) / 16 * 16;
  const int PX = p.bd + 8, PB = np + 8;      // row pitches, in elements
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [2][ck16][PX]
  bf16* Bs = Xs + 2 * ck16 * PX;                 // [2][ck16][PB]
  bf16* Cs = Bs + 2 * ck16 * PB;                 // [2][ck16][PB]
  bf16* Shi = Cs + 2 * ck16 * PB;                // [np][PX]
  bf16* Slo = Shi + np * PX;                     // [np][PX]
  float* Sf = reinterpret_cast<float*>(Slo + np * PX);  // [np][PX]
  float* Ar = Sf + np * PX;                      // [2][ck16] decays
  float* cum = Ar + 2 * ck16;                    // [ck16]
  float* ecum = cum + ck16;                      // exp(cum_t)
  float* wdec = ecum + ck16;                     // exp(cum_last - cum_i)

  const int r = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int j0 = blockIdx.y * p.bd;
  const int w = min(p.bd, p.hd - j0);
  const int sr = state_row(p, r);
  if (sr < 0) {
    zero_y<bf16>(p, r, h, j0, w);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, j = lane >> 3, rr = lane & 7;
  const size_t xstep = (size_t)p.heads * p.hd;
  const size_t xbase = (size_t)r * p.seq * xstep + (size_t)h * p.hd + j0;
  const bf16* X = static_cast<const bf16*>(p.x) + xbase;
  bf16* Y = static_cast<bf16*>(p.y) + xbase;
  const float* A = p.a + (size_t)r * p.seq * p.heads + h;
  const bf16* B = static_cast<const bf16*>(p.b) + r * p.sb_r + h * p.sb_h;
  const bf16* C = static_cast<const bf16*>(p.c) + r * p.sc_r + h * p.sc_h;
  const size_t sbase = ((size_t)sr * p.heads + h) * p.N * p.hd + j0;

  // chunk k's x, b, c and decays into slot k & 1; rows past its n steps
  // (and columns past w or N) zero, decays past n one
  auto load_chunk = [&](int k) {
    const int slot = k & 1, t0 = k * p.ck, n = min(p.ck, p.seq - t0);
    load_padded(Xs + slot * ck16 * PX, PX, ck16, p.bd, n, w,
                X + (size_t)t0 * xstep, (long long)xstep, p.vec_x);
    load_padded(Bs + slot * ck16 * PB, PB, ck16, np, n, p.N,
                B + t0 * p.sb_t, p.sb_t, p.vec_bc);
    load_padded(Cs + slot * ck16 * PB, PB, ck16, np, n, p.N,
                C + t0 * p.sc_t, p.sc_t, p.vec_bc);
    load_decays(Ar + slot * ck16, ck16, n, A + (size_t)t0 * p.heads,
                p.heads);
  };

  const int nchunks = (p.seq + p.ck - 1) / p.ck;
  const int cgroups = p.bd / 32;             // 32-column groups
  load_chunk(0);
  cp_async_commit();
  // the state tile while chunk 0's copies are in flight; rows past N and
  // columns past w zero
  for (int e0 = threadIdx.x; e0 < np * p.bd; e0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {            // four loads in flight
      const int e = e0 + u * kThreads, s = e / p.bd, c = e % p.bd;
      v[u] = (p.s0 != nullptr && s < p.N && c < w)
                 ? p.s0[sbase + (size_t)s * p.hd + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kThreads, s = e / p.bd, c = e % p.bd;
      if (s >= np) break;
      const bf16 hi = __float2bfloat16(v[u]);
      Sf[s * PX + c] = v[u];
      Shi[s * PX + c] = hi;
      Slo[s * PX + c] = __float2bfloat16(v[u] - __bfloat162float(hi));
    }
  }
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) load_chunk(k + 1);
    cp_async_commit();
    cp_async_wait<1>();                       // chunk k has landed (here)
    __syncthreads();                          // ... for every thread
    const int slot = k & 1, t0 = k * p.ck, n = min(p.ck, p.seq - t0);
    const bf16* xs = Xs + slot * ck16 * PX;
    const bf16* bs = Bs + slot * ck16 * PB;
    const bf16* cs = Cs + slot * ck16 * PB;
    if (warp == 0) {                          // inclusive scan of log a
      const float* ar = Ar + slot * ck16;
      const int per = (ck16 + 31) / 32;
      const int lo = min(ck16, lane * per), hi = min(ck16, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += logf(ar[t]);
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      for (int t = lo; t < hi; ++t) cum[t] += before;
      __syncwarp();
      const float last = cum[ck16 - 1];       // = cum[n-1]: decays past n are 1
      for (int t = lane; t < ck16; t += 32) {
        ecum[t] = expf(cum[t]);
        wdec[t] = expf(last - cum[t]);
      }
    }
    __syncthreads();

    // y: items (16 rows of t, 32 columns)
    const int mts = (n + 15) / 16;
    for (int it = warp; it < mts * cgroups; it += kWarps) {
      const int mt = it / cgroups, c0 = (it % cgroups) * 32, m0 = mt * 16;
      float acc[4][4] = {};
      const int arow = m0 + (j & 1) * 8 + rr;          // c row this lane reads
      for (int ks = 0; ks < np / 16; ++ks) {           // c . S, S = hi + lo
        unsigned af[4];
        ldmatrix_x4(af, cs + arow * PB + ks * 16 + (j >> 1) * 8);
        const int krow = ks * 16 + (j & 1) * 8 + rr;
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          const int col = c0 + (nt + (j >> 1)) * 8;
          unsigned bh[4], bl[4];
          ldmatrix_x4_trans(bh, Shi + krow * PX + col);
          ldmatrix_x4_trans(bl, Slo + krow * PX + col);
          mma_bf16(acc[nt], af, bh[0], bh[1]);
          mma_bf16(acc[nt + 1], af, bh[2], bh[3]);
          mma_bf16(acc[nt], af, bl[0], bl[1]);
          mma_bf16(acc[nt + 1], af, bl[2], bl[3]);
        }
      }
      const float e0 = ecum[m0 + g], e1 = ecum[m0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[nt][0] *= e0; acc[nt][1] *= e0;
        acc[nt][2] *= e1; acc[nt][3] *= e1;
      }
      for (int kk = 0; kk <= mt; ++kk) {               // G x, 16 i at a time
        float sc[2][4] = {};
        const int key = kk * 16 + (j >> 1) * 8 + rr;   // b row this lane reads
        for (int ks = 0; ks < np / 16; ++ks) {
          unsigned af[4], bf[4];
          ldmatrix_x4(af, cs + arow * PB + ks * 16 + (j >> 1) * 8);
          ldmatrix_x4(bf, bs + key * PB + ks * 16 + (j & 1) * 8);
          mma_bf16(sc[0], af, bf[0], bf[1]);
          mma_bf16(sc[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = m0 + g + (e >> 1) * 8;
            const int i = kk * 16 + u * 8 + 2 * q + (e & 1);
            sc[u][e] = i <= t ? sc[u][e] * expf(cum[t] - cum[i]) : 0.f;
          }
        unsigned gh[4], gl[4];
        split2(sc[0][0], sc[0][1], gh[0], gl[0]);
        split2(sc[0][2], sc[0][3], gh[1], gl[1]);
        split2(sc[1][0], sc[1][1], gh[2], gl[2]);
        split2(sc[1][2], sc[1][3], gh[3], gl[3]);
        const int krow = kk * 16 + (j & 1) * 8 + rr;
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          unsigned bx[4];
          ldmatrix_x4_trans(bx, xs + krow * PX + c0 + (nt + (j >> 1)) * 8);
          mma_bf16(acc[nt], gh, bx[0], bx[1]);
          mma_bf16(acc[nt + 1], gh, bx[2], bx[3]);
          mma_bf16(acc[nt], gl, bx[0], bx[1]);
          mma_bf16(acc[nt + 1], gl, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m0 + g + (e >> 1) * 8;
          const int col = c0 + nt * 8 + 2 * q + (e & 1);
          if (t < n && col < w)
            Y[(size_t)(t0 + t) * xstep + col] = __float2bfloat16(acc[nt][e]);
        }
    }
    __syncthreads();                           // every y read the old state

    // S: items (16 state rows, 32 columns)
    const float atot = ecum[ck16 - 1];
    const int nslab = (n + 15) / 16;
    for (int it = warp; it < (np / 16) * cgroups; it += kWarps) {
      const int s0 = (it / cgroups) * 16, c0 = (it % cgroups) * 32;
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] = atot * Sf[(s0 + g + (e >> 1) * 8) * PX + c0 + nt * 8 +
                                 2 * q + (e & 1)];
      for (int kk = 0; kk < nslab; ++kk) {
        // A[s][i] = w_i b[i][s]: b^T by ldmatrix.trans, scaled, split
        unsigned ab[4], ah[4], al[4];
        ldmatrix_x4_trans(ab, bs + (kk * 16 + (j >> 1) * 8 + rr) * PB + s0 +
                                  (j & 1) * 8);
        const int i0 = kk * 16 + 2 * q;
        const float w0 = wdec[i0], w1 = wdec[i0 + 1];
        const float w2 = wdec[i0 + 8], w3 = wdec[i0 + 9];
        scale_split(ab[0], w0, w1, ah[0], al[0]);
        scale_split(ab[1], w0, w1, ah[1], al[1]);
        scale_split(ab[2], w2, w3, ah[2], al[2]);
        scale_split(ab[3], w2, w3, ah[3], al[3]);
        const int krow = kk * 16 + (j & 1) * 8 + rr;
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          unsigned bx[4];
          ldmatrix_x4_trans(bx, xs + krow * PX + c0 + (nt + (j >> 1)) * 8);
          mma_bf16(acc[nt], ah, bx[0], bx[1]);
          mma_bf16(acc[nt + 1], ah, bx[2], bx[3]);
          mma_bf16(acc[nt], al, bx[0], bx[1]);
          mma_bf16(acc[nt + 1], al, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (s0 + g + (e >> 1) * 8) * PX + c0 + nt * 8 + 2 * q +
                         (e & 1);
          const float v = acc[nt][e];
          const bf16 hi = __float2bfloat16(v);
          Sf[at] = v;
          Shi[at] = hi;
          Slo[at] = __float2bfloat16(v - __bfloat162float(hi));
        }
    }
    __syncthreads();                           // slot k & 1 is free again
  }
  cp_async_wait<0>();
  for (int e = threadIdx.x; e < p.N * w; e += kThreads) {
    const int s = e / w, c = e % w;
    p.s1[sbase + (size_t)s * p.hd + c] = Sf[s * PX + c];
  }
}

// ---------------------------------------------------------------------------
// FMA body: f32, seq > 1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_fma_kernel(const Args p) {
  extern __shared__ float smem[];
  const int N = p.N, ck = p.ck, bd = p.bd;
  const int NP = N + 1;                  // padded b / c row
  float* Ss = smem;                      // [N][bd]   state tile
  float* Xs = Ss + N * bd;               // [ck][bd]  x tile
  float* Bs = Xs + ck * bd;              // [ck][NP]
  float* Cs = Bs + ck * NP;              // [ck][NP]
  float* Gs = Cs + ck * NP;              // [ck][ck]
  float* cum = Gs + ck * ck;             // [ck]

  const int r = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int j0 = blockIdx.y * bd;
  const int w = min(bd, p.hd - j0);      // columns of this tile
  const int sr = state_row(p, r);
  if (sr < 0) {
    zero_y<float>(p, r, h, j0, w);
    return;
  }
  const int tid = threadIdx.x;
  const float* X = static_cast<const float*>(p.x);
  const float* Bm = static_cast<const float*>(p.b);
  const float* Cm = static_cast<const float*>(p.c);
  float* Y = static_cast<float*>(p.y);

  const size_t sbase = ((size_t)sr * p.heads + h) * N * p.hd + j0;
  for (int e = tid; e < N * bd; e += kThreads) {
    const int s = e / bd, j = e % bd;
    Ss[e] = (p.s0 != nullptr && j < w) ? p.s0[sbase + (size_t)s * p.hd + j]
                                       : 0.f;
  }
  const size_t xstep = (size_t)p.heads * p.hd;        // x, y: one step
  const size_t xbase = (size_t)r * p.seq * xstep + (size_t)h * p.hd + j0;
  const size_t abase = (size_t)r * p.seq * p.heads + h;
  const long long bbase = r * p.sb_r + h * p.sb_h;
  const long long cbase = r * p.sc_r + h * p.sc_h;

  for (int t0 = 0; t0 < p.seq; t0 += ck) {
    const int n = min(ck, p.seq - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = tid; e < n * bd; e += kThreads) {
      const int t = e / bd, j = e % bd;
      Xs[e] = j < w ? X[xbase + (size_t)(t0 + t) * xstep + j] : 0.f;
    }
    for (int e = tid; e < n * N; e += kThreads) {
      const int t = e / N, s = e % N;
      Bs[t * NP + s] = Bm[bbase + (t0 + t) * p.sb_t + s];
      Cs[t * NP + s] = Cm[cbase + (t0 + t) * p.sc_t + s];
    }
    if (tid < 32) {                      // inclusive scan of log a
      const int per = (n + 31) / 32;
      const int lo = min(n, tid * per), hi = min(n, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += logf(p.a[abase + (size_t)(t0 + t) * p.heads]);
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.f;
      for (int t = lo; t < hi; ++t) cum[t] += before;
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += kThreads) {
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
    for (int e = tid; e < n * N; e += kThreads) {   // fold the decays in
      const int t = e / N, s = e % N;
      Cs[t * NP + s] *= expf(cum[t]);
      Bs[t * NP + s] *= expf(clast - cum[t]);
    }
    __syncthreads();
    for (int e = tid; e < n * bd; e += kThreads) {
      const int t = e / bd, j = e % bd;
      if (j >= w) continue;
      float acc = 0.f;
      const float* gr = Gs + t * ck;
      for (int i = 0; i <= t; ++i) acc += gr[i] * Xs[i * bd + j];
      const float* cr = Cs + t * NP;
      for (int s = 0; s < N; ++s) acc += cr[s] * Ss[s * bd + j];
      Y[xbase + (size_t)(t0 + t) * xstep + j] = acc;
    }
    __syncthreads();                     // every y read the old state
    const float atot = expf(clast);
    for (int e = tid; e < N * bd; e += kThreads) {
      const int s = e / bd, j = e % bd;
      float acc = atot * Ss[e];
      for (int i = 0; i < n; ++i) acc += Bs[i * NP + s] * Xs[i * bd + j];
      Ss[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * bd; e += kThreads) {
    const int s = e / bd, j = e % bd;
    if (j < w) p.s1[sbase + (size_t)s * p.hd + j] = Ss[e];
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename Kernel>
cudaError_t launch_smem(Kernel kernel, size_t smem,
                        size_t (&granted)[kMaxDevices], dim3 grid,
                        cudaStream_t st, const Args& p) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem_once(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Formats it takes (kernels/ssd_scan.py: format_error mirrors these checks):
// rows, seq, heads, hd, state > 0; 1 <= ck <= min(seq, 128); bd 32 or 64;
// rows * heads and srows * heads < 2^31, srows >= 0 (0 without state_rows);
// f32 or bf16; s1 given; the chunk body's shared
// memory within 232,448 bytes.  Up to 8 steps run the step body whatever
// ck is, when a thread's rows hold the state (state <= 8 * 256 / (bd / 4),
// or 8 * 256 / bd without 16-byte vectors).
extern "C" int ssd_scan_h100_launch(const void* x, const void* a,
                                    const void* b, const void* c,
                                    const void* s0, void* y, void* s1,
                                    const void* mask, const void* srow,
                                    int rows, int srows, int seq,
                                    int heads, int hd, int state, int ck,
                                    int bd, long long sb_r, long long sb_t,
                                    long long sb_h, long long sc_r,
                                    long long sc_t, long long sc_h, int elem,
                                    void* stream) {
  if (rows <= 0 || seq <= 0 || heads <= 0 || hd <= 0 || state <= 0 ||
      ck <= 0 || ck > seq || ck > kMaxChunk || (bd != 32 && bd != 64) ||
      (long long)rows * heads > 0x7fffffff || srows < 0 ||
      (long long)srows * heads > 0x7fffffff || s1 == nullptr ||
      (elem != ELEM_F32 && elem != ELEM_BF16))
    return cudaErrorInvalidValue;
  Args p{x, static_cast<const float*>(a), b, c,
         static_cast<const float*>(s0), y, static_cast<float*>(s1),
         static_cast<const unsigned char*>(mask),
         static_cast<const int*>(srow), srows, seq, heads, hd, state, ck, bd,
         sb_r, sb_t, sb_h, sc_r, sc_t, sc_h, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows * heads, (hd + bd - 1) / bd);
  // the step body while a thread's rows hold the state, with 16-byte
  // vectors of S when every row of it starts on 16 bytes
  const bool v4 = hd % 4 == 0 && aligned(s1, 16) &&
                  (s0 == nullptr || aligned(s0, 16));
  const int groups = kThreads / (v4 ? bd / 4 : bd);
  if (seq <= kStepSeq && state <= groups * kRows)
    return elem == ELEM_BF16 ? launch_step<bf16>(p, v4, grid, st)
                             : launch_step<float>(p, v4, grid, st);
  if (elem == ELEM_F32) {
    static size_t granted[kMaxDevices] = {};
    return launch_smem(ssd_fma_kernel, fma_smem(ck, state, bd), granted,
                       grid, st, p);
  }
  // 16-byte copies: x rows when hd is a multiple of 8 and x starts on 16
  // bytes; b and c rows when state and every stride are
  p.vec_x = hd % 8 == 0 && aligned(x, 16);
  p.vec_bc = state % 8 == 0 && aligned(b, 16) && aligned(c, 16) &&
             sb_r % 8 == 0 && sb_t % 8 == 0 && sb_h % 8 == 0 &&
             sc_r % 8 == 0 && sc_t % 8 == 0 && sc_h % 8 == 0;
  static size_t granted[kMaxDevices] = {};
  return launch_smem(ssd_tc_kernel, tc_smem(ck, state, bd), granted, grid, st,
                     p);
}
