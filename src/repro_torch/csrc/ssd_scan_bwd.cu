// K3b ssd_scan_bwd_h100: the gradients of K3's SSD scan (csrc/ssd_scan.cu).
// K3 computes, per (row r, head h),  S_t = a_t * S_{t-1} + b_t (x) x_t  and
// y_t = c_t . S_t  from S_0 = state0 (zero when absent), over x [rows, seq,
// heads, hd], a [rows, seq, heads] (the decay itself, in (0, 1), f32), b and
// c [rows, seq, heads, state] given by strides (head stride 0 when the model
// shares one projection across heads).  Given dy (x's shape and type) and
// the final state's gradient dsf [rows, heads, state, hd] f32 (zero when
// absent), this computes dx (x's type), da (f32), db and dc (b's type: each
// head's summed over the heads in head order when b and c are shared,
// hsum = heads; per head when hsum = 1) and ds0, the gradient of state0
// [rows, heads, state, hd] f32, written only where ds0 is given (a call
// from a zero state passes none).
//
// Replaces no TPU kernel: the JAX package differentiates the einsum math of
// ssd_chunk (src/repro/kernels/ssd_scan.py:31) under jax.value_and_grad
// (ROADMAP F3), and the port's forward runs K3 through ctypes, which
// autograd cannot see.
//
// Per chunk of n <= ck steps, cum_t = sum_{i<=t} log a_i (warp 0 scan),
// L[t][i] = exp(cum_t - cum_i) for i <= t (masked before the exp),
// M = (C B^T) (.) L, P = dY X^T, w_i = exp(cum_last - cum_i),
// A = exp(cum_last), S_in the state entering the chunk, dS_out the gradient
// of the state leaving it:
//   dX = M^T dY + (w (.) B) dS_out
//   dC = (P (.) L) B + diag(exp cum) dY S_in^T
//   dB = (P (.) L)^T C + diag(w) X dS_out^T
//   dS_in = A dS_out + (diag(exp cum) C)^T dY     (the chunk before's dS_out)
//   dcum_t = sum_i Q[t][i] - sum_t' Q[t'][t] + exp(cum_t) <dY_t, (C S_in)_t>
//            - r_t  (+ A <dS_out, S_in> + sum_i r_i at the last step)
// with Q = P (.) M and r_i = w_i <B_i, (X dS_out^T)_i>; dlog a is the
// reverse cumsum of dcum within the chunk and da = dlog a / a.
//
// Two bodies, each three kernels of 256 threads, every sum in f32 in a
// fixed order and with no atomics, so two launches give the same bits:
//
// bf16, on the tensor cores (mma.sync m16n8k16, f32 accumulators; chunks up
// to 128 steps):
//   walk (grid rows*heads x ceil(hd/32) x 2): a block owns 32 columns of one
//     (row, head) and walks its chunks in order as K3's bf16 body does, the
//     state tile in the warps' f32 accumulators (a warp a run of up to 4 n8
//     tiles of it up to a state of 128, two blocks an SM; 8 up to 256); the
//     next chunk's x (or dy) and b (or c) arrive by cp.async in a second
//     slot while this one is computed, and warp 0 loads the next chunk's
//     decays before its products and takes their log-prefix after them, so
//     a chunk costs one barrier.  z = 0 forward from S0, S <- A S +
//     (w (.) B)^T X, storing the state entering each chunk (K3's recurrence
//     again: K3's serve kernels keep no states); z = 1 in reverse from dsf,
//     dS <- A dS + (e^cum (.) C)^T dY, storing each chunk's dS_out, then
//     ds0.  Both into the workspace ws, [rows, heads, chunks, state, hd] f32
//     each.
//   chunks (grid rows*heads x chunks): a block owns one chunk and all of hd
//     (<= 128), so dcum needs no sum across blocks; up to 4 items a warp
//     (chunk_tc_items) two blocks an SM, else 8 and one.  x, dy, b, c by
//     cp.async into padded tiles (ssd_tiles.cuh), dS_out's high part staged
//     from the workspace by 16-byte loads (and <dS_out, S_in> summed on the
//     way); then by 8 warps,
//     a barrier between phases: G = C B^T and P = dY X^T by (t slab, i slab)
//     items, L, M, P (.) L and Q on the fragments (the masks before every
//     exp), M and P (.) L to shared memory in bf16, Q's row and column sums
//     by slab; dX = diag(w) (B dS_out) + M^T dY; dC = diag(e^cum) U +
//     (P (.) L) B with U = dY S_in^T and <C_t, U_t>; dB = diag(w) V +
//     (P (.) L)^T C with V = X dS_out^T and <B_i, V_i> (S_in's and dS_out's
//     fragments read from the workspace one k step ahead); then by warp 0 the
//     dcum terms, the last step's, the reverse cumsum and da (a shuffle
//     scan).  db and dc of each head into the workspace [rows, seq, heads,
//     state] f32 each.
//   Rounding points: x, dy, b and c enter as the model's bf16.  f32 operands
//   fed as a high and a low bf16 part (two products, ~16 bits): w (.) b and
//   e^cum (.) c in the walks (K3's scale_split), S_in in U and dS_out in V.
//   Each split holds da (and d(state0)) to the f32 tolerance of 1e-4 of
//   their largest element: one bf16 rounding of S_in in U, or of dS_out in
//   V, puts da 5.7e-4-9.0e-4 off, and of w (.) b or e^cum (.) c da 4.2e-4-
//   7.4e-4 and d(state0) 1.3e-3-1.6e-3 off (the kernel's arithmetic emulated
//   in f32 with that one operand rounded, at mamba2-130m's and hymba-1.5b's
//   training widths over 1024 and 2048 steps, chunk 64; the card holds the
//   split kernel, chip_smoke.py 13 (f)).  Fed as one bf16 part: M in
//   M^T dY, P (.) L in both its products and dS_out in B dS_out (its rows
//   scaled by w afterwards in f32, so no product has two f32 sides), which
//   bear only on dx, db and dc, rounded to bf16 and held at 2e-2: one
//   rounding of each puts them at most 3.5e-3 off (the same emulation).
//   Every elementwise term stays f32 on the fragments: L, Q, the dcum rows,
//   the reverse cumsum, da = dlog a / a.
//
// f32, on the CUDA cores (FMA, never TF32; chunks up to 64 steps), kept as
// it was first written: every kernel is bounded as one block an SM
// (__launch_bounds__'s second argument): with the thread count alone ptxas
// held the chunk kernel at 64 registers and the states kernel at 48, and
// both spilled.
//   states (grid rows*heads x ceil(hd/32) x 2): the walks above with the
//     state tile in shared memory and every product by FMA.
//   chunks (grid rows*heads x chunks): a block owns all hd (<= 128) of one
//     chunk: M, P(.)L and Q in shared memory, dx written, each row's dc and
//     db by a warp (lanes over the state, the row's dcum terms summed by
//     shuffles in a fixed tree) into the workspace, then thread 0 the last
//     step's terms, the reverse cumsum and da.
// Both: heads (grid over db and dc's elements x 2): db and dc summed over
// hsum heads in order, rounded once to b's type.
//
// Shared bytes (kernels/ssd_scan_bwd.py's counters; c16 = ck, np = state
// and hp = hd, each rounded up to 16):
//   bf16 chunks  2*(2*c16*(hp+8) + 2*c16*(np+8) + np*(hp+8) + 2*c16*(c16+8))
//                + 4*(6*c16 + 2*c16*c16/16 + 2*np*c16/16 + 8)
//   bf16 walk    2*(2*c16*40 + 2*c16*(np+8)) + 4*(3*c16 + 2)
//   f32 chunks   4*(2*ck*(hd+1) + 2*ck*(state+1) + 2*state*(hd+1)
//                   + 3*ck*(ck+1) + 6*ck + 8)
//   f32 states   4*(state*32 + ck*32 + ck*(state+1) + ck)
// The opt-in above 48 KB is made once a kernel instance and device.
//
// Bound on the card: a chunk does about 10*n*state*hd + n^2*(3*state + 2*hd)
// flops over 2*(hd + state) input elements a step, hundreds of flops a byte:
// bound by operations, at the tensor cores' rate for the bf16 body (which
// adds the split parts' products) and at the f32 rate for the FMA body.
#include "common.cuh"
#include "ssd_tiles.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;           // every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;           // the f32 body
constexpr int kMaxChunkTc = 128;        // the bf16 body
constexpr int kMaxHd = 128;
constexpr int kBd = 32;                 // hd columns a states block (f32)
constexpr int kWalkBd = 32;             // hd columns a walk block (bf16)
constexpr int kMaxTiles = 8;            // n8 tiles, or items, a warp holds
constexpr int kRun = kMaxChunkTc / 32;  // steps of a lane's log-decay run
constexpr int kHeadsBlocks = 4096;      // the heads kernel's grid-stride cap

struct Args {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  const float* s0;                      // [rows, heads, N, hd] or nullptr
  const void* dy;
  const float* dsf;                     // [rows, heads, N, hd] or nullptr
  void* dx;
  float* da;
  void* db;
  void* dc;
  float* ds0;
  float* sin;                           // [rows, heads, nc, N, hd]
  float* dsout;                         // [rows, heads, nc, N, hd]
  float* dbw;                           // [rows, seq, heads, N]
  float* dcw;                           // [rows, seq, heads, N]
  int rows, seq, heads, hd, N, ck, nc, hsum;
  long long sb_r, sb_t, sb_h, sc_r, sc_t, sc_h;
  int vec_x, vec_bc;                    // 16-byte copies allowed (bf16)
};

size_t chunk_smem(int ck, int hd, int N) {
  return sizeof(float) *
         (2 * (size_t)ck * (hd + 1) + 2 * (size_t)ck * (N + 1) +
          2 * (size_t)N * (hd + 1) + 3 * (size_t)ck * (ck + 1) +
          6 * (size_t)ck + kWarps);
}

size_t states_smem(int ck, int N) {
  return sizeof(float) * ((size_t)N * kBd + (size_t)ck * kBd +
                          (size_t)ck * (N + 1) + ck);
}

// By warp 0: cum[t] = sum_{i<=t} log a_i over the chunk's n steps (t0 on),
// each lane a run of consecutive steps, then an inclusive scan of the runs'
// sums by shuffles; av[t] = a_t when av is given.  abase = r*seq*heads + h.
__device__ void log_prefix(const float* a, size_t abase, int heads, int t0,
                           int n, float* cum, float* av) {
  const int lane = threadIdx.x;
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per), hi = min(n, lo + per);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    const float v = a[abase + (size_t)(t0 + t) * heads];
    if (av != nullptr) av[t] = v;
    run += logf(v);
    cum[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  for (int t = lo; t < hi; ++t) cum[t] += before;
}

// A warp's sum, the same butterfly every time; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// states: S_in of each chunk (z = 0), dS_out of each chunk and ds0 (z = 1)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_states_kernel(const Args p) {
  extern __shared__ float smem[];
  const int N = p.N, ck = p.ck, NP = N + 1;
  constexpr int bd = kBd;
  float* Ss = smem;                      // [N][bd]  the state, or dS
  float* Vs = Ss + N * bd;               // [ck][bd] x, or dy in reverse
  float* Ws = Vs + ck * bd;              // [ck][NP] b, or c, weighted
  float* cum = Ws + ck * NP;             // [ck]

  const int r = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int j0 = blockIdx.y * bd;
  const int w = min(bd, p.hd - j0);      // columns of this tile
  const bool rev = blockIdx.z == 1;
  const int tid = threadIdx.x;
  const T* Vg = static_cast<const T*>(rev ? p.dy : p.x);
  const T* Wg = static_cast<const T*>(rev ? p.c : p.b);
  const long long wbase =
      rev ? r * p.sc_r + h * p.sc_h : r * p.sb_r + h * p.sb_h;
  const long long wt = rev ? p.sc_t : p.sb_t;
  const float* init = rev ? p.dsf : p.s0;
  float* out = rev ? p.dsout : p.sin;

  const size_t pair = (size_t)r * p.heads + h;
  const size_t sbase = pair * N * p.hd + j0;
  for (int e = tid; e < N * bd; e += kThreads) {
    const int s = e / bd, j = e % bd;
    Ss[e] = (init != nullptr && j < w) ? init[sbase + (size_t)s * p.hd + j]
                                       : 0.f;
  }
  const size_t xstep = (size_t)p.heads * p.hd;        // x, dy: one step
  const size_t xbase = (size_t)r * p.seq * xstep + (size_t)h * p.hd + j0;
  const size_t abase = (size_t)r * p.seq * p.heads + h;

  for (int kk = 0; kk < p.nc; ++kk) {
    const int k = rev ? p.nc - 1 - kk : kk;
    const int t0 = k * ck, n = min(ck, p.seq - t0);
    __syncthreads();                     // Ss settled, the last chunk read
    float* o = out + (pair * p.nc + k) * N * p.hd + j0;
    for (int e = tid; e < N * bd; e += kThreads) {
      const int s = e / bd, j = e % bd;
      if (j < w) o[(size_t)s * p.hd + j] = Ss[e];
    }
    if (!rev && kk == p.nc - 1) break;   // the final state is not needed
    for (int e = tid; e < n * bd; e += kThreads) {
      const int t = e / bd, j = e % bd;
      Vs[e] = j < w ? to_f32(Vg[xbase + (size_t)(t0 + t) * xstep + j]) : 0.f;
    }
    for (int e = tid; e < n * N; e += kThreads) {
      const int t = e / N, s = e % N;
      Ws[t * NP + s] = to_f32(Wg[wbase + (t0 + t) * wt + s]);
    }
    if (tid < 32) log_prefix(p.a, abase, p.heads, t0, n, cum, nullptr);
    __syncthreads();
    const float clast = cum[n - 1];
    for (int e = tid; e < n * N; e += kThreads) {   // w_i b_i, or e^cum_t c_t
      const int t = e / N, s = e % N;
      Ws[t * NP + s] *= expf(rev ? cum[t] : clast - cum[t]);
    }
    __syncthreads();
    const float atot = expf(clast);
    for (int e = tid; e < N * bd; e += kThreads) {
      const int s = e / bd, j = e % bd;
      float acc = atot * Ss[e];
      for (int i = 0; i < n; ++i) acc += Ws[i * NP + s] * Vs[i * bd + j];
      Ss[e] = acc;
    }
  }
  if (rev && p.ds0 != nullptr) {
    __syncthreads();
    for (int e = tid; e < N * bd; e += kThreads) {
      const int s = e / bd, j = e % bd;
      if (j < w) p.ds0[sbase + (size_t)s * p.hd + j] = Ss[e];
    }
  }
}

// ---------------------------------------------------------------------------
// chunks: dx, da, and each head's db and dc
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_kernel(const Args p) {
  extern __shared__ float smem[];
  const int N = p.N, ck = p.ck, hd = p.hd;
  const int HP = hd + 1, NP = N + 1, CP = ck + 1;
  float* Xs = smem;                      // [ck][HP]
  float* Ds = Xs + ck * HP;              // [ck][HP] dy
  float* Bs = Ds + ck * HP;               // [ck][NP]
  float* Cs = Bs + ck * NP;              // [ck][NP]
  float* Si = Cs + ck * NP;              // [N][HP]  S_in
  float* Do = Si + N * HP;               // [N][HP]  dS_out
  float* Ms = Do + N * HP;               // [ck][CP] M = (C B^T) (.) L
  float* PL = Ms + ck * CP;              // [ck][CP] P (.) L
  float* Qs = PL + ck * CP;              // [ck][CP] Q = P (.) M
  float* cum = Qs + ck * CP;             // [ck]
  float* ecum = cum + ck;                // exp(cum_t)
  float* wv = ecum + ck;                 // w_t = exp(cum_last - cum_t)
  float* dcum = wv + ck;
  float* av = dcum + ck;                 // a_t
  float* rv = av + ck;                   // r_t
  float* red = rv + ck;                  // [kWarps]

  const int r = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int k = blockIdx.y;
  const int t0 = k * ck, n = min(ck, p.seq - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* X = static_cast<const T*>(p.x);
  const T* DY = static_cast<const T*>(p.dy);
  const T* Bg = static_cast<const T*>(p.b);
  const T* Cg = static_cast<const T*>(p.c);
  T* DX = static_cast<T*>(p.dx);

  const size_t pair = (size_t)r * p.heads + h;
  const size_t xstep = (size_t)p.heads * hd;
  const size_t xbase = ((size_t)r * p.seq + t0) * xstep + (size_t)h * hd;
  const size_t abase = (size_t)r * p.seq * p.heads + h;
  const long long bbase = r * p.sb_r + h * p.sb_h + t0 * p.sb_t;
  const long long cbase = r * p.sc_r + h * p.sc_h + t0 * p.sc_t;
  const float* sin = p.sin + (pair * p.nc + k) * N * hd;
  const float* dso = p.dsout + (pair * p.nc + k) * N * hd;

  for (int e = tid; e < n * hd; e += kThreads) {
    const int t = e / hd, j = e % hd;
    const size_t g = xbase + (size_t)t * xstep + j;
    Xs[t * HP + j] = to_f32(X[g]);
    Ds[t * HP + j] = to_f32(DY[g]);
  }
  for (int e = tid; e < n * N; e += kThreads) {
    const int t = e / N, s = e % N;
    Bs[t * NP + s] = to_f32(Bg[bbase + t * p.sb_t + s]);
    Cs[t * NP + s] = to_f32(Cg[cbase + t * p.sc_t + s]);
  }
  for (int e = tid; e < N * hd; e += kThreads) {
    const int s = e / hd, j = e % hd;
    Si[s * HP + j] = sin[e];
    Do[s * HP + j] = dso[e];
  }
  if (tid < 32) log_prefix(p.a, abase, p.heads, t0, n, cum, av);
  __syncthreads();

  const float clast = cum[n - 1];
  for (int t = tid; t < n; t += kThreads) {
    ecum[t] = expf(cum[t]);
    wv[t] = expf(clast - cum[t]);
  }
  for (int e = tid; e < n * n; e += kThreads) {
    const int t = e / n, i = e % n;
    float m = 0.f, pl = 0.f, q = 0.f;
    if (i <= t) {
      float g = 0.f, pp = 0.f;
      for (int s = 0; s < N; ++s) g += Cs[t * NP + s] * Bs[i * NP + s];
      for (int j = 0; j < hd; ++j) pp += Ds[t * HP + j] * Xs[i * HP + j];
      const float l = expf(cum[t] - cum[i]);
      m = g * l;
      pl = pp * l;
      q = pp * m;
    }
    Ms[t * CP + i] = m;
    PL[t * CP + i] = pl;
    Qs[t * CP + i] = q;
  }
  __syncthreads();

  // dx = M^T dY + (w (.) B) dS_out
  for (int e = tid; e < n * hd; e += kThreads) {
    const int i = e / hd, j = e % hd;
    float acc = 0.f, inter = 0.f;
    for (int t = i; t < n; ++t) acc += Ms[t * CP + i] * Ds[t * HP + j];
    for (int s = 0; s < N; ++s) inter += Bs[i * NP + s] * Do[s * HP + j];
    from_f32(acc + wv[i] * inter, &DX[xbase + (size_t)i * xstep + j]);
  }
  // <dS_out, S_in>: each warp's part
  float part = 0.f;
  for (int e = tid; e < N * hd; e += kThreads) {
    const int s = e / hd, j = e % hd;
    part += Do[s * HP + j] * Si[s * HP + j];
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  // a warp a row q: dc_q, db_q over the lanes' state columns, and dcum_q
  for (int q = warp; q < n; q += kWarps) {
    float qs = 0.f, pc = 0.f, pb = 0.f;
    for (int i = lane; i < n; i += 32) qs += Qs[q * CP + i] - Qs[i * CP + q];
    for (int s = lane; s < N; s += 32) {
      float u = 0.f, v = 0.f;           // (dY S_in^T)[q][s], (X dS_out^T)
      for (int j = 0; j < hd; ++j) {
        u += Ds[q * HP + j] * Si[s * HP + j];
        v += Xs[q * HP + j] * Do[s * HP + j];
      }
      float dcv = ecum[q] * u, dbv = wv[q] * v;
      for (int i = 0; i <= q; ++i) dcv += PL[q * CP + i] * Bs[i * NP + s];
      for (int t = q; t < n; ++t) dbv += PL[t * CP + q] * Cs[t * NP + s];
      pc += Cs[q * NP + s] * u;
      pb += Bs[q * NP + s] * v;
      const size_t wo = (((size_t)r * p.seq + t0 + q) * p.heads + h) * N + s;
      p.dcw[wo] = dcv;
      p.dbw[wo] = dbv;
    }
    qs = warp_sum(qs);
    pc = warp_sum(pc);
    pb = warp_sum(pb);
    if (lane == 0) {
      const float rq = wv[q] * pb;
      rv[q] = rq;
      dcum[q] = qs + ecum[q] * pc - rq;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float dot = 0.f, rsum = 0.f;
    for (int i = 0; i < kWarps; ++i) dot += red[i];
    for (int i = 0; i < n; ++i) rsum += rv[i];
    dcum[n - 1] += expf(clast) * dot + rsum;
    float run = 0.f;
    for (int t = n - 1; t >= 0; --t) {
      run += dcum[t];
      p.da[abase + (size_t)(t0 + t) * p.heads] = run / av[t];
    }
  }
}

// ---------------------------------------------------------------------------
// heads: db, dc = each head's, summed over hsum heads in order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_heads_kernel(const Args p, long long total) {
  const float* src = blockIdx.y == 0 ? p.dbw : p.dcw;
  T* dst = static_cast<T*>(blockIdx.y == 0 ? p.db : p.dc);
  const int N = p.N, hs = p.hsum, ho = p.heads / hs;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const int s = (int)(e % N);
    const long long rest = e / N;        // (r * seq + t) * ho + g
    const long long g = rest % ho, rt = rest / ho;
    const float* q = src + (rt * p.heads + g * hs) * N + s;
    float acc = 0.f;
    for (int kh = 0; kh < hs; ++kh) acc += q[(long long)kh * N];
    from_f32(acc, &dst[e]);
  }
}

// ---------------------------------------------------------------------------
// the bf16 body on the tensor cores
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int up16(int v) {
  return (v + 15) / 16 * 16;
}

size_t walk_tc_smem(int ck, int N) {
  const size_t c16 = up16(ck), np = up16(N);
  return 2 * (2 * c16 * (kWalkBd + 8) + 2 * c16 * (np + 8)) +
         4 * (3 * c16 + 2);
}

size_t chunk_tc_smem(int ck, int hd, int N) {
  const size_t c16 = up16(ck), np = up16(N), hp = up16(hd);
  return 2 * (2 * c16 * (hp + 8) + 2 * c16 * (np + 8) + np * (hp + 8) +
              2 * c16 * (c16 + 8)) +
         4 * (6 * c16 + 2 * (c16 / 16) * c16 + 2 * (np / 16) * c16 + kWarps);
}

// Items a warp of the chunk kernel holds at most in its linear phases:
// (16-row slab, 16 columns) pairs of dX [ck][hd] and of dC, dB [ck][state].
int chunk_tc_items(int ck, int hd, int N) {
  const int ts = up16(ck) / 16;
  const int most = ts * (up16(N) > up16(hd) ? up16(N) : up16(hd)) / 16;
  return (most + kWarps - 1) / kWarps;
}

// A lane's run of a chunk's decays for the log-decay prefix (warp 0): steps
// lane * per.. of the chunk's c16, per = c16 / 32 rounded up, a_t =
// a[t * stride] for t < n and 1 past them.  Loaded apart from the prefix,
// so that the loads are in flight while the warp computes.
__device__ __forceinline__ void decay_run(const float* a, long long stride,
                                          int n, int c16, float (&v)[kRun]) {
  const int lane = threadIdx.x & 31, per = (c16 + 31) / 32;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int t = lane * per + u;
    v[u] = (u < per && t < n) ? a[t * stride] : 1.f;
  }
}

// By warp 0, from each lane's run: cum[t] = sum_{i<=t} log a_i over the
// chunk's c16 steps (the runs' sums scanned by shuffles); then each vector
// given: av[t] = a_t, ecum[t] = exp(cum_t), wdec[t] = exp(cum_last - cum_t),
// and *atot = exp(cum_last).
__device__ __forceinline__ void prefix_of_run(const float (&v)[kRun],
                                              int c16, float* cum, float* av,
                                              float* ecum, float* wdec,
                                              float* atot) {
  const int lane = threadIdx.x & 31, per = (c16 + 31) / 32;
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int t = lane * per + u;
    if (u >= per || t >= c16) break;
    if (av != nullptr) av[t] = v[u];
    run += logf(v[u]);
    cum[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int t = lane * per + u;
    if (u >= per || t >= c16) break;
    cum[t] += before;
  }
  __syncwarp();
  const float last = cum[c16 - 1];
  for (int t = lane; t < c16; t += 32) {
    if (ecum != nullptr) ecum[t] = expf(cum[t]);
    if (wdec != nullptr) wdec[t] = expf(last - cum[t]);
  }
  if (atot != nullptr && lane == 0) *atot = expf(last);
}

// m[s][c], m[s][c + 1] of an f32 [N][hd] matrix, zero past N or hd.
__device__ __forceinline__ float2 ld2(const float* m, int s, int c, int N,
                                      int hd) {
  if (s >= N) return make_float2(0.f, 0.f);
  const float* row = m + (size_t)s * hd;
  if ((hd & 1) == 0 && c + 1 < hd)
    return *reinterpret_cast<const float2*>(row + c);
  return make_float2(c < hd ? row[c] : 0.f, c + 1 < hd ? row[c + 1] : 0.f);
}

// The B fragments of two n8 tiles (rows s0.., s0 + 8..) of an f32 [N][hd]
// matrix read as B[k = column][n = row], k from c0, as loaded ...
__device__ __forceinline__ void frag_load(const float* m, int s0, int c0,
                                          int N, int hd, int g, int q,
                                          float2 (&v)[2][2]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    v[nt][0] = ld2(m, s0 + nt * 8 + g, c0 + 2 * q, N, hd);
    v[nt][1] = ld2(m, s0 + nt * 8 + g, c0 + 2 * q + 8, N, hd);
  }
}

// ... and each as a high and a low bf16 part.
__device__ __forceinline__ void frag_split(const float2 (&v)[2][2],
                                           unsigned (&hi)[2][2],
                                           unsigned (&lo)[2][2]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      split2(v[nt][hf].x, v[nt][hf].y, hi[nt][hf], lo[nt][hf]);
}

// Two neighbouring columns (col even) of a bf16 row: one 4-byte store where
// the row length d is even, else element by element.
__device__ __forceinline__ void put2(bf16* o, int col, int d, float x,
                                     float y) {
  if ((d & 1) == 0 && col + 1 < d) {
    *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < d) o[col] = __float2bfloat16(x);
    if (col + 1 < d) o[col + 1] = __float2bfloat16(y);
  }
}

// The tiles of a walk block's state: a warp holds per n8 tiles (per a power
// of two, per * 8 >= the tiles np/16 * 4), from tile warp * per on.  MT = 4
// (per <= 4, a state up to 128): all in state rows slab0 * 16.., columns
// c0 + 8u; MT = 8 (per = 8, a state up to 256): rows (slab0 + u / 4) * 16..,
// columns (u % 4) * 8, so that every tile's offset is a constant step.
constexpr int kWalkCt = kWalkBd / 8;
template <int MT>
__device__ __forceinline__ int walk_row(int slab0, int u) {
  return (MT == 8 ? slab0 + u / kWalkCt : slab0) * 16;
}
template <int MT>
__device__ __forceinline__ int walk_col(int c0, int u) {
  return MT == 8 ? u % kWalkCt * 8 : c0 + u * 8;
}

// A thread's two neighbouring columns of each of its tiles into dst (this
// block's columns of one state), in one 8-byte store where hd is even.
template <int MT>
__device__ __forceinline__ void walk_store(const float (&acc)[MT][4],
                                           float* dst, int per, int slab0,
                                           int c0, int N, int hd, int w,
                                           int g, int q) {
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    if (u >= per) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = walk_row<MT>(slab0, u) + g + hf * 8;
      const int col = walk_col<MT>(c0, u) + 2 * q;
      if (s >= N) continue;
      float* o = dst + (size_t)s * hd + col;
      if ((hd & 1) == 0 && col + 1 < w) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[u][2 * hf], acc[u][2 * hf + 1]);
      } else {
        if (col < w) o[0] = acc[u][2 * hf];
        if (col + 1 < w) o[1] = acc[u][2 * hf + 1];
      }
    }
  }
}

// The walks (grid rows*heads x ceil(hd/32) x 2), MT n8 tiles of the state a
// warp at most: 4 up to a state of 128, two blocks an SM; 8 up to 256.  The
// next chunk's log-decay prefix is warp 0's: its decays loaded before its
// products, the prefix after them, into the other slot of the vectors; one
// barrier a chunk.
template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 4 ? 2 : 1)
    ssd_bwd_walk_tc_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int c16 = up16(p.ck), np = up16(p.N);
  constexpr int PV = kWalkBd + 8;
  const int PW = np + 8;                           // row pitches, elements
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw);    // [2][c16][PV] x, or dy
  bf16* Ws = Vs + 2 * c16 * PV;                    // [2][c16][PW] b, or c
  float* sc = reinterpret_cast<float*>(Ws + 2 * c16 * PW);  // [2][c16]
  float* cum = sc + 2 * c16;                       // [c16], warp 0's
  float* at = cum + c16;                           // [2] exp(cum_last)

  const int r = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int j0 = blockIdx.y * kWalkBd;
  const int w = min(kWalkBd, p.hd - j0);
  const bool rev = blockIdx.z == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, j = lane >> 3, rr = lane & 7;
  const size_t xstep = (size_t)p.heads * p.hd;
  const bf16* V = static_cast<const bf16*>(rev ? p.dy : p.x) +
                  (size_t)r * p.seq * xstep + (size_t)h * p.hd + j0;
  const bf16* W = static_cast<const bf16*>(rev ? p.c : p.b) +
                  (rev ? r * p.sc_r + h * p.sc_h : r * p.sb_r + h * p.sb_h);
  const long long wt = rev ? p.sc_t : p.sb_t;
  const float* A = p.a + (size_t)r * p.seq * p.heads + h;
  const size_t pair = (size_t)r * p.heads + h;
  const size_t tile = (size_t)p.N * p.hd;          // one state
  const float* init = rev ? p.dsf : p.s0;
  float* out = (rev ? p.dsout : p.sin) + pair * p.nc * tile + j0;

  const int tiles = np / 16 * kWalkCt;
  int per = 1;
  while (per * kWarps < tiles) per <<= 1;
  if (warp * per >= tiles) per = 0;                // a warp with no tiles
  const int slab0 = warp * per / kWalkCt, c0 = warp * per % kWalkCt * 8;
  float acc[MT][4];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = walk_row<MT>(slab0, u) + g + (e >> 1) * 8;
      const int col = walk_col<MT>(c0, u) + 2 * q + (e & 1);
      acc[u][e] = (init != nullptr && u < per && s < p.N && col < w)
                      ? init[pair * tile + (size_t)s * p.hd + j0 + col]
                      : 0.f;
    }

  // chunk k's x (or dy) and b (or c) into slot `slot`: rows past its n
  // steps, and columns past w or N, zero
  auto load_chunk = [&](int k, int slot) {
    const int t0 = k * p.ck, n = min(p.ck, p.seq - t0);
    load_padded(Vs + slot * c16 * PV, PV, c16, kWalkBd, n, w,
                V + (size_t)t0 * xstep, (long long)xstep, p.vec_x);
    load_padded(Ws + slot * c16 * PW, PW, c16, np, n, p.N, W + t0 * wt, wt,
                p.vec_bc);
  };
  float dec[kRun];                                 // warp 0's next decays

  const int nc = p.nc, steps = rev ? nc : nc - 1;  // chunks walked through
  if (steps > 0) {
    load_chunk(rev ? nc - 1 : 0, 0);
    if (warp == 0) {
      const int k = rev ? nc - 1 : 0;
      decay_run(A + (size_t)k * p.ck * p.heads, p.heads,
                min(p.ck, p.seq - k * p.ck), c16, dec);
      prefix_of_run(dec, c16, cum, nullptr, rev ? sc : nullptr,
                    rev ? nullptr : sc, at);
    }
  }
  cp_async_commit();
  for (int kk = 0; kk <= steps; ++kk) {
    const int k = rev ? nc - 1 - kk : kk;
    // the state entering chunk k, or the gradient leaving it
    if (kk < nc)
      walk_store<MT>(acc, out + (size_t)k * tile, per, slab0, c0, p.N, p.hd,
                     w, g, q);
    if (kk == steps) break;
    cp_async_wait<0>();
    __syncthreads();     // chunk kk's tiles and prefix in, kk - 1's slot free
    const int nk = rev ? k - 1 : k + 1;
    if (kk + 1 < steps) {
      load_chunk(nk, (kk + 1) & 1);
      if (warp == 0)
        decay_run(A + (size_t)nk * p.ck * p.heads, p.heads,
                  min(p.ck, p.seq - nk * p.ck), c16, dec);
    }
    cp_async_commit();
    const int slot = kk & 1, n = min(p.ck, p.seq - k * p.ck);
    const float atot = at[slot];
    const float* scs = sc + slot * c16;
    const bf16* vs = Vs + slot * c16 * PV;
    const bf16* ws = Ws + slot * c16 * PW;
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] *= atot;
    // S += (w (.) b)^T x, or dS += (e^cum (.) c)^T dy: A[s][i] = sc_i w[i][s]
    // by ldmatrix.trans of the b (or c) tile, scaled and split in two
    for (int ks = 0; ks < (n + 15) / 16; ++ks) {
      const int i0 = ks * 16 + 2 * q;
      const float w0 = scs[i0], w1 = scs[i0 + 1];
      const float w2 = scs[i0 + 8], w3 = scs[i0 + 9];
      unsigned ah[4], al[4];
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        if (u >= per) break;
        if (u % kWalkCt == 0) {                    // the tile's slab begins
          unsigned ab[4];
          ldmatrix_x4_trans(ab, ws + (ks * 16 + (j >> 1) * 8 + rr) * PW +
                                    walk_row<MT>(slab0, u) + (j & 1) * 8);
          scale_split(ab[0], w0, w1, ah[0], al[0]);
          scale_split(ab[1], w0, w1, ah[1], al[1]);
          scale_split(ab[2], w2, w3, ah[2], al[2]);
          scale_split(ab[3], w2, w3, ah[3], al[3]);
        }
        unsigned bx[2];
        ldmatrix_x2_trans(bx, vs + (ks * 16 + (lane & 15)) * PV +
                                  walk_col<MT>(c0, u));
        mma_bf16(acc[u], ah, bx[0], bx[1]);
        mma_bf16(acc[u], al, bx[0], bx[1]);
      }
    }
    // the next chunk's prefix into the other slot, which every warp last
    // read before this chunk's barrier
    if (warp == 0 && kk + 1 < steps) {
      const int ns = (kk + 1) & 1;
      prefix_of_run(dec, c16, cum, nullptr, rev ? sc + ns * c16 : nullptr,
                    rev ? nullptr : sc + ns * c16, at + ns);
    }
  }
  cp_async_wait<0>();
  if (rev && p.ds0 != nullptr)
    walk_store<MT>(acc, p.ds0 + pair * tile + j0, per, slab0, c0, p.N, p.hd,
                   w, g, q);
}

// Fragments of m16n8k16 (g = lane / 4, q = lane % 4): a thread holds
// A[g | g+8][2q, 2q+1 | +8], B[2q, 2q+1 | +8][g], D[g | g+8][2q, 2q+1].  A
// warp's items in the linear phases are consecutive (it = warp * per + u), so
// those that share an operand load it once.
template <int MP>
__global__ void __launch_bounds__(kThreads, MP == 4 ? 2 : 1)
    ssd_bwd_chunk_tc_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int N = p.N, hd = p.hd;
  const int c16 = up16(p.ck), np = up16(N), hp = up16(hd);
  const int PH = hp + 8, PN = np + 8, PC = c16 + 8;   // row pitches
  const int TS = c16 / 16, NI = np / 16, HI = hp / 16;  // 16-wide slabs
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);       // [c16][PH]
  bf16* Ds = Xs + c16 * PH;                           // [c16][PH] dy
  bf16* Bs = Ds + c16 * PH;                           // [c16][PN]
  bf16* Cs = Bs + c16 * PN;                           // [c16][PN]
  bf16* Dh = Cs + c16 * PN;                           // [np][PH] dS_out, high
  bf16* Mh = Dh + np * PH;                            // [c16][PC] M
  bf16* PLh = Mh + c16 * PC;                          // [c16][PC] P (.) L
  float* cum = reinterpret_cast<float*>(PLh + c16 * PC);  // [c16]
  float* ecum = cum + c16;                            // exp(cum_t)
  float* wv = ecum + c16;                             // exp(cum_last - cum_t)
  float* av = wv + c16;                               // a_t
  float* dcum = av + c16;
  float* rv = dcum + c16;                             // r_t
  float* qrow = rv + c16;                             // [TS][c16] by i slab
  float* qcol = qrow + TS * c16;                      // [TS][c16] by t slab
  float* pcp = qcol + TS * c16;                       // [NI][c16] <C_t, U_t>
  float* rp = pcp + NI * c16;                         // [NI][c16] <B_i, V_i>
  float* red = rp + NI * c16;                         // [kWarps]

  const int r = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int k = blockIdx.y;
  const int t0 = k * p.ck, n = min(p.ck, p.seq - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, j = lane >> 3, rr = lane & 7;
  const size_t pair = (size_t)r * p.heads + h;
  const size_t xstep = (size_t)p.heads * hd;
  const size_t xbase = ((size_t)r * p.seq + t0) * xstep + (size_t)h * hd;
  const size_t abase = (size_t)r * p.seq * p.heads + h;
  const float* sin = p.sin + (pair * p.nc + k) * N * hd;
  const float* dso = p.dsout + (pair * p.nc + k) * N * hd;
  bf16* DX = static_cast<bf16*>(p.dx) + xbase;
  const size_t wrow = ((size_t)r * p.seq + t0) * p.heads + h;  // db, dc rows

  load_padded(Xs, PH, c16, hp, n, hd, static_cast<const bf16*>(p.x) + xbase,
              (long long)xstep, p.vec_x);
  load_padded(Ds, PH, c16, hp, n, hd, static_cast<const bf16*>(p.dy) + xbase,
              (long long)xstep, p.vec_x);
  load_padded(Bs, PN, c16, np, n, N,
              static_cast<const bf16*>(p.b) + r * p.sb_r + h * p.sb_h +
                  t0 * p.sb_t,
              p.sb_t, p.vec_bc);
  load_padded(Cs, PN, c16, np, n, N,
              static_cast<const bf16*>(p.c) + r * p.sc_r + h * p.sc_h +
                  t0 * p.sc_t,
              p.sc_t, p.vec_bc);
  cp_async_commit();
  if (warp == 0) {                      // the decays and their log-prefix
    float dec[kRun];
    decay_run(p.a + abase + (size_t)t0 * p.heads, p.heads, n, c16, dec);
    prefix_of_run(dec, c16, cum, av, ecum, wv, nullptr);
  }
  // dS_out's high part, zero past N and hd, and each thread's part of
  // <dS_out, S_in> in f32 from the workspace: 16-byte loads, four of each
  // in flight, where hd is a multiple of 4 (else element by element)
  float part = 0.f;
  if (hd % 4 == 0) {
    const int q4 = hp / 4, total = np * q4;
    for (int e0 = tid; e0 < total; e0 += 4 * kThreads) {
      float4 dv[4], sv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, s = e / q4, c = e % q4 * 4;
        const bool ok = e < total && s < N && c < hd;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        dv[u] = ok ? *reinterpret_cast<const float4*>(dso + (size_t)s * hd + c)
                   : zero;
        sv[u] = ok ? *reinterpret_cast<const float4*>(sin + (size_t)s * hd + c)
                   : zero;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, s = e / q4, c = e % q4 * 4;
        if (e >= total) break;
        part += dv[u].x * sv[u].x + dv[u].y * sv[u].y + dv[u].z * sv[u].z +
                dv[u].w * sv[u].w;
        uint2 packed;
        packed.x = pack_bf16(dv[u].x, dv[u].y);
        packed.y = pack_bf16(dv[u].z, dv[u].w);
        *reinterpret_cast<uint2*>(Dh + s * PH + c) = packed;
      }
    }
  } else {
    for (int e = tid; e < np * hp; e += kThreads) {
      const int s = e / hp, c = e % hp;
      float v = 0.f;
      if (s < N && c < hd) {
        v = dso[(size_t)s * hd + c];
        part += v * sin[(size_t)s * hd + c];
      }
      Dh[s * PH + c] = __float2bfloat16(v);
    }
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  cp_async_wait<0>();
  __syncthreads();

  // G = C B^T and P = dY X^T by (t slab mt, i slab kt <= mt) items; L, M,
  // P (.) L and Q on the fragments (L masked before the exp)
  const int citems = TS * (TS + 1) / 2;
  for (int it = warp; it < citems; it += kWarps) {
    int mt = 0;
    while ((mt + 1) * (mt + 2) / 2 <= it) ++mt;
    const int kt = it - mt * (mt + 1) / 2;
    float gs[2][4] = {}, ps[2][4] = {};
    const int arow = mt * 16 + (j & 1) * 8 + rr;     // the t row addressed
    const int key = kt * 16 + (j >> 1) * 8 + rr;     // the i row addressed
    for (int ks = 0; ks < NI; ++ks) {
      unsigned af[4], bf[4];
      ldmatrix_x4(af, Cs + arow * PN + ks * 16 + (j >> 1) * 8);
      ldmatrix_x4(bf, Bs + key * PN + ks * 16 + (j & 1) * 8);
      mma_bf16(gs[0], af, bf[0], bf[1]);
      mma_bf16(gs[1], af, bf[2], bf[3]);
    }
    for (int ks = 0; ks < HI; ++ks) {
      unsigned af[4], bf[4];
      ldmatrix_x4(af, Ds + arow * PH + ks * 16 + (j >> 1) * 8);
      ldmatrix_x4(bf, Xs + key * PH + ks * 16 + (j & 1) * 8);
      mma_bf16(ps[0], af, bf[0], bf[1]);
      mma_bf16(ps[1], af, bf[2], bf[3]);
    }
    float rsum[2] = {0.f, 0.f}, csum[2][2] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = mt * 16 + g + (e >> 1) * 8;
        const int i = kt * 16 + u * 8 + 2 * q + (e & 1);
        const float l = i <= t ? expf(cum[t] - cum[i]) : 0.f;
        const float m = gs[u][e] * l, pl = ps[u][e] * l;
        const float qv = ps[u][e] * m;
        gs[u][e] = m;
        ps[u][e] = pl;
        rsum[e >> 1] += qv;
        csum[u][e & 1] += qv;
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = mt * 16 + g, i = kt * 16 + u * 8 + 2 * q;
      *reinterpret_cast<unsigned*>(Mh + t * PC + i) =
          pack_bf16(gs[u][0], gs[u][1]);
      *reinterpret_cast<unsigned*>(Mh + (t + 8) * PC + i) =
          pack_bf16(gs[u][2], gs[u][3]);
      *reinterpret_cast<unsigned*>(PLh + t * PC + i) =
          pack_bf16(ps[u][0], ps[u][1]);
      *reinterpret_cast<unsigned*>(PLh + (t + 8) * PC + i) =
          pack_bf16(ps[u][2], ps[u][3]);
    }
    // Q's row sums over the quad, its column sums over the 8 row groups
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rsum[0] += __shfl_xor_sync(0xffffffffu, rsum[0], o);
      rsum[1] += __shfl_xor_sync(0xffffffffu, rsum[1], o);
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        csum[u][0] += __shfl_xor_sync(0xffffffffu, csum[u][0], o);
        csum[u][1] += __shfl_xor_sync(0xffffffffu, csum[u][1], o);
      }
    if (q == 0) {
      qrow[kt * c16 + mt * 16 + g] = rsum[0];
      qrow[kt * c16 + mt * 16 + g + 8] = rsum[1];
    }
    if (g == 0)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        qcol[mt * c16 + kt * 16 + u * 8 + 2 * q] = csum[u][0];
        qcol[mt * c16 + kt * 16 + u * 8 + 2 * q + 1] = csum[u][1];
      }
  }
  __syncthreads();

  // dX = diag(w) (B dS_out) + M^T dY by (i slab, 16 hd columns) items
  {
    const int items = TS * HI, per = (items + kWarps - 1) / kWarps;
    float acc[MP][2][4] = {};
    for (int ks = 0; ks < NI; ++ks) {
      unsigned af[4];
      int slab = -1;
#pragma unroll
      for (int u = 0; u < MP; ++u) {
        const int it = warp * per + u;
        if (u >= per || it >= items) break;
        const int mt = it / HI, c0 = it % HI * 16;
        if (mt != slab) {
          slab = mt;
          ldmatrix_x4(af, Bs + (mt * 16 + (j & 1) * 8 + rr) * PN + ks * 16 +
                              (j >> 1) * 8);
        }
        unsigned bh[4];
        ldmatrix_x4_trans(bh, Dh + (ks * 16 + (j & 1) * 8 + rr) * PH + c0 +
                                  (j >> 1) * 8);
        mma_bf16(acc[u][0], af, bh[0], bh[1]);
        mma_bf16(acc[u][1], af, bh[2], bh[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < MP; ++u) {
      const int it = warp * per + u;
      if (u >= per || it >= items) break;
      const int mt = it / HI;
      const float w0 = wv[mt * 16 + g], w1 = wv[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[u][nt][0] *= w0;
        acc[u][nt][1] *= w0;
        acc[u][nt][2] *= w1;
        acc[u][nt][3] *= w1;
      }
    }
    for (int kt = 0; kt < TS; ++kt) {          // t slabs at or after i's
      unsigned af[4];
      int slab = -1;
#pragma unroll
      for (int u = 0; u < MP; ++u) {
        const int it = warp * per + u;
        if (u >= per || it >= items) break;
        const int mt = it / HI, c0 = it % HI * 16;
        if (kt < mt) continue;
        if (mt != slab) {                       // M^T by ldmatrix.trans
          slab = mt;
          ldmatrix_x4_trans(af, Mh + (kt * 16 + (j >> 1) * 8 + rr) * PC +
                                    mt * 16 + (j & 1) * 8);
        }
        unsigned bd[4];
        ldmatrix_x4_trans(bd, Ds + (kt * 16 + (j & 1) * 8 + rr) * PH + c0 +
                                  (j >> 1) * 8);
        mma_bf16(acc[u][0], af, bd[0], bd[1]);
        mma_bf16(acc[u][1], af, bd[2], bd[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < MP; ++u) {
      const int it = warp * per + u;
      if (u >= per || it >= items) break;
      const int mt = it / HI, c0 = it % HI * 16;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = mt * 16 + g + hf * 8;
          if (i < n)
            put2(DX + (size_t)i * xstep, c0 + nt * 8 + 2 * q, hd,
                 acc[u][nt][2 * hf], acc[u][nt][2 * hf + 1]);
        }
    }
  }

  // dC = diag(e^cum) U + (P (.) L) B, U = dY S_in^T, by (t slab, 16 state
  // columns) items, the t slab fastest (S_in's fragments shared); and
  // dB = diag(w) V + (P (.) L)^T C, V = X dS_out^T, by (i slab, 16 state
  // columns) items.  S_in and dS_out come from the workspace as high and low
  // parts; <C_t, U_t> and <B_i, V_i> by state slab before the row scales.
  const int items = TS * NI, per = (items + kWarps - 1) / kWarps;
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {       // 0: dC, 1: dB
    const bool dcs = side == 0;
    const bf16* As = dcs ? Ds : Xs;             // dY, or X
    const float* Sm = dcs ? sin : dso;          // S_in, or dS_out
    const bf16* Es = dcs ? Cs : Bs;             // C_t . U_t, or B_i . V_i
    const bf16* Os = dcs ? Bs : Cs;             // B in (P (.) L) B, or C
    const float* scale = dcs ? ecum : wv;
    float* part_out = dcs ? pcp : rp;
    float acc[MP][2][4] = {};
    // the first item's slab of S_in (or dS_out), its fragments read one k
    // step ahead of their products; an item of another slab reads its own
    const int si0 = warp * per / TS;
    float2 ahead[2][2];
    frag_load(Sm, si0 * 16, 0, N, hd, g, q, ahead);
    for (int ks = 0; ks < HI; ++ks) {
      unsigned sh[2][2], sl[2][2];
      frag_split(ahead, sh, sl);
      if (ks + 1 < HI)
        frag_load(Sm, si0 * 16, (ks + 1) * 16, N, hd, g, q, ahead);
      int slab = si0;
#pragma unroll
      for (int u = 0; u < MP; ++u) {
        const int it = warp * per + u;
        if (u >= per || it >= items) break;
        const int mt = it % TS, si = it / TS;
        if (si != slab) {
          slab = si;
          float2 own[2][2];
          frag_load(Sm, si * 16, ks * 16, N, hd, g, q, own);
          frag_split(own, sh, sl);
        }
        unsigned af[4];
        ldmatrix_x4(af, As + (mt * 16 + (j & 1) * 8 + rr) * PH + ks * 16 +
                            (j >> 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(acc[u][nt], af, sh[nt][0], sh[nt][1]);
          mma_bf16(acc[u][nt], af, sl[nt][0], sl[nt][1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MP; ++u) {
      const int it = warp * per + u;
      if (u >= per || it >= items) break;
      const int mt = it % TS, si = it / TS;
      float d[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = mt * 16 + g + (e >> 1) * 8;
          const int s = si * 16 + nt * 8 + 2 * q + (e & 1);
          d[e >> 1] += __bfloat162float(Es[t * PN + s]) * acc[u][nt][e];
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        d[0] += __shfl_xor_sync(0xffffffffu, d[0], o);
        d[1] += __shfl_xor_sync(0xffffffffu, d[1], o);
      }
      if (q == 0) {
        part_out[si * c16 + mt * 16 + g] = d[0];
        part_out[si * c16 + mt * 16 + g + 8] = d[1];
      }
      const float e0 = scale[mt * 16 + g], e1 = scale[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[u][nt][0] *= e0;
        acc[u][nt][1] *= e0;
        acc[u][nt][2] *= e1;
        acc[u][nt][3] *= e1;
      }
    }
    // dC: + sum over i slabs kt <= mt of (P (.) L)[t][i] B[i][s];
    // dB: + sum over t slabs kt >= mt of (P (.) L)^T[i][t] C[t][s]
    for (int kt = 0; kt < TS; ++kt) {
#pragma unroll
      for (int u = 0; u < MP; ++u) {
        const int it = warp * per + u;
        if (u >= per || it >= items) break;
        const int mt = it % TS, si = it / TS;
        if (dcs ? kt > mt : kt < mt) continue;
        unsigned af[4], bo[4];
        if (dcs)
          ldmatrix_x4(af, PLh + (mt * 16 + (j & 1) * 8 + rr) * PC + kt * 16 +
                              (j >> 1) * 8);
        else
          ldmatrix_x4_trans(af, PLh + (kt * 16 + (j >> 1) * 8 + rr) * PC +
                                    mt * 16 + (j & 1) * 8);
        ldmatrix_x4_trans(bo, Os + (kt * 16 + (j & 1) * 8 + rr) * PN +
                                  si * 16 + (j >> 1) * 8);
        mma_bf16(acc[u][0], af, bo[0], bo[1]);
        mma_bf16(acc[u][1], af, bo[2], bo[3]);
      }
    }
    float* wout = dcs ? p.dcw : p.dbw;
#pragma unroll
    for (int u = 0; u < MP; ++u) {
      const int it = warp * per + u;
      if (u >= per || it >= items) break;
      const int mt = it % TS, si = it / TS;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = mt * 16 + g + hf * 8;
          const int s = si * 16 + nt * 8 + 2 * q;
          if (t >= n) continue;
          float* o = wout + (wrow + (size_t)t * p.heads) * N + s;
          if ((N & 1) == 0 && s + 1 < N) {
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[u][nt][2 * hf], acc[u][nt][2 * hf + 1]);
          } else {
            if (s < N) o[0] = acc[u][nt][2 * hf];
            if (s + 1 < N) o[1] = acc[u][nt][2 * hf + 1];
          }
        }
    }
  }
  __syncthreads();

  // dcum_t, a thread a step; then warp 0: the last step's terms, the
  // reverse cumsum (each lane a run of steps, the runs by shuffles) and da
  for (int t = tid; t < n; t += kThreads) {
    float qs = 0.f, pc = 0.f, rs = 0.f;
    for (int kt = 0; kt <= t / 16; ++kt) qs += qrow[kt * c16 + t];
    for (int mt = t / 16; mt < TS; ++mt) qs -= qcol[mt * c16 + t];
    for (int si = 0; si < NI; ++si) {
      pc += pcp[si * c16 + t];
      rs += rp[si * c16 + t];
    }
    rv[t] = wv[t] * rs;
    dcum[t] = qs + ecum[t] * pc - rv[t];
  }
  __syncthreads();
  if (warp == 0) {
    const int run_len = (n + 31) / 32;
    const int lo = min(n, lane * run_len), hi = min(n, lo + run_len);
    float rs = 0.f;
    for (int t = lo; t < hi; ++t) rs += rv[t];
    rs = warp_sum(rs);
    float dot = 0.f;
    for (int i = 0; i < kWarps; ++i) dot += red[i];
    if (lane == 0) dcum[n - 1] += expf(cum[c16 - 1]) * dot + rs;
    __syncwarp();
    float run = 0.f;
    for (int t = lo; t < hi; ++t) run += dcum[t];
    float incl = run;                           // runs from this lane on
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += v;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      after += dcum[t];
      p.da[abase + (size_t)(t0 + t) * p.heads] = after / av[t];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, size_t (&granted)[kMaxDevices],
                   dim3 grid, cudaStream_t st, const Args& p) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem_once(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_heads(const Args& p, cudaStream_t st) {
  const long long total =
      (long long)p.rows * p.seq * (p.heads / p.hsum) * p.N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ssd_bwd_heads_kernel<T>
      <<<dim3((unsigned)(blocks < kHeadsBlocks ? blocks : kHeadsBlocks), 2),
         kThreads, 0, st>>>(p, total);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Args& p, cudaStream_t st) {
  static size_t granted_states[kMaxDevices] = {};
  static size_t granted_chunks[kMaxDevices] = {};
  cudaError_t err = launch(ssd_bwd_states_kernel<float>,
                           states_smem(p.ck, p.N), granted_states,
                           dim3(p.rows * p.heads, (p.hd + kBd - 1) / kBd, 2),
                           st, p);
  if (err != cudaSuccess) return err;
  err = launch(ssd_bwd_chunk_kernel<float>, chunk_smem(p.ck, p.hd, p.N),
               granted_chunks, dim3(p.rows * p.heads, p.nc), st, p);
  if (err != cudaSuccess) return err;
  return launch_heads<float>(p, st);
}

cudaError_t launch_tc(const Args& p, cudaStream_t st) {
  static size_t granted_w4[kMaxDevices] = {};
  static size_t granted_w8[kMaxDevices] = {};
  static size_t granted_c4[kMaxDevices] = {};
  static size_t granted_c8[kMaxDevices] = {};
  // the walk: up to 4 n8 tiles of the state a warp up to a state of 128,
  // else 8
  const dim3 wgrid(p.rows * p.heads, (p.hd + kWalkBd - 1) / kWalkBd, 2);
  const size_t wsmem = walk_tc_smem(p.ck, p.N);
  cudaError_t err =
      up16(p.N) <= 128
          ? launch(ssd_bwd_walk_tc_kernel<4>, wsmem, granted_w4, wgrid, st, p)
          : launch(ssd_bwd_walk_tc_kernel<8>, wsmem, granted_w8, wgrid, st,
                   p);
  if (err != cudaSuccess) return err;
  const size_t smem = chunk_tc_smem(p.ck, p.hd, p.N);
  const dim3 grid(p.rows * p.heads, p.nc);
  err = chunk_tc_items(p.ck, p.hd, p.N) <= 4
            ? launch(ssd_bwd_chunk_tc_kernel<4>, smem, granted_c4, grid, st, p)
            : launch(ssd_bwd_chunk_tc_kernel<8>, smem, granted_c8, grid, st,
                     p);
  if (err != cudaSuccess) return err;
  return launch_heads<bf16>(p, st);
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// Formats it takes (kernels/ssd_scan_bwd.py: format_error mirrors these
// checks): rows, seq, heads, hd, state > 0; hd <= 128; hsum 1 or heads;
// rows * heads < 2^31; at most 65,535 chunks; f32 or bf16.  f32: 1 <= ck
// <= min(seq, 64), both FMA kernels' shared memory within 232,448 bytes.
// bf16: 1 <= ck <= min(seq, 128), state <= 256, at most 8 items a warp
// (chunk_tc_items), both tensor-core kernels' shared memory within 232,448
// bytes.  ds0 may be null (no d(state0) written).
// ws holds 2 * rows * heads * chunks * state * hd + 2 * rows * seq * heads
// * state floats.
extern "C" int ssd_scan_bwd_h100_launch(
    const void* x, const void* a, const void* b, const void* c,
    const void* s0, const void* dy, const void* dsf, void* dx, void* da,
    void* db, void* dc, void* ds0, void* ws, int rows, int seq, int heads,
    int hd, int state, int ck, int hsum, long long sb_r,
    long long sb_t, long long sb_h, long long sc_r, long long sc_t,
    long long sc_h, int elem, void* stream) {
  if (rows <= 0 || seq <= 0 || heads <= 0 || hd <= 0 || state <= 0 ||
      ck <= 0 || ck > seq || hd > kMaxHd ||
      (hsum != 1 && hsum != heads) ||
      (long long)rows * heads > 0x7fffffff ||
      (seq + ck - 1) / ck > kMaxGridY ||
      (elem != ELEM_F32 && elem != ELEM_BF16) || x == nullptr ||
      a == nullptr || b == nullptr || c == nullptr || dy == nullptr ||
      dx == nullptr || da == nullptr || db == nullptr || dc == nullptr ||
      ws == nullptr)
    return cudaErrorInvalidValue;
  if (elem == ELEM_F32
          ? ck > kMaxChunk || chunk_smem(ck, hd, state) > (size_t)kMaxSmem ||
                states_smem(ck, state) > (size_t)kMaxSmem
          : ck > kMaxChunkTc || state > 256 ||
                chunk_tc_items(ck, hd, state) > kMaxTiles ||
                chunk_tc_smem(ck, hd, state) > (size_t)kMaxSmem ||
                walk_tc_smem(ck, state) > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  const int nc = (seq + ck - 1) / ck;
  float* w = static_cast<float*>(ws);
  const size_t states = (size_t)rows * heads * nc * state * hd;
  const size_t per_head = (size_t)rows * seq * heads * state;
  Args p{x, static_cast<const float*>(a), b, c,
         static_cast<const float*>(s0), dy, static_cast<const float*>(dsf),
         dx, static_cast<float*>(da), db, dc, static_cast<float*>(ds0),
         w, w + states, w + 2 * states, w + 2 * states + per_head,
         rows, seq, heads, hd, state, ck, nc, hsum,
         sb_r, sb_t, sb_h, sc_r, sc_t, sc_h, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == ELEM_F32) return launch_f32(p, st);
  // 16-byte copies: x and dy rows when hd is a multiple of 8 and both start
  // on 16 bytes; b and c rows when state and every stride are
  p.vec_x = hd % 8 == 0 && aligned(x, 16) && aligned(dy, 16);
  p.vec_bc = state % 8 == 0 && aligned(b, 16) && aligned(c, 16) &&
             sb_r % 8 == 0 && sb_t % 8 == 0 && sb_h % 8 == 0 &&
             sc_r % 8 == 0 && sc_t % 8 == 0 && sc_h % 8 == 0;
  return launch_tc(p, st);
}
