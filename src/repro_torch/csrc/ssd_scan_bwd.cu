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
// Three kernels of 256 threads, every sum in f32 on the CUDA cores (FMA,
// never TF32), in a fixed order and with no atomics, so two launches give
// the same bits.  Each is bounded as one block an SM (__launch_bounds__'s
// second argument): with the thread count alone ptxas held the chunk
// kernel at 64 registers and the states kernel at 48, and both spilled.
// Registers (ptxas, sm_90a, CUDA 12.8): chunks 128 (f32) and 119 (bf16),
// states 96, heads 48 (f32) and 40 (bf16); none spills.
//   states (grid rows*heads x ceil(hd/32) x 2): a block owns 32 columns of
//     one (row, head) and walks its chunks in order with the state tile in
//     shared memory: z = 0 forward from S0, storing the state entering each
//     chunk (K3's recurrence again: K3's serve kernels keep no states), z =
//     1 in reverse from dsf, storing each chunk's dS_out, then ds0.  Both
//     into the workspace ws, [rows, heads, chunks, state, hd] each.
//   chunks (grid rows*heads x chunks): a block owns all hd (<= 128) of one
//     chunk, so dcum needs no sum across blocks: M, P(.)L and Q in shared
//     memory, dx written, each row's dc and db by a warp (lanes over the
//     state, the row's dcum terms summed by shuffles in a fixed tree) into
//     the workspace [rows, seq, heads, state] each, then thread 0 the last
//     step's terms, the reverse cumsum and da.
//   heads (grid over db and dc's elements x 2): db and dc summed over hsum
//     heads in order, rounded once to b's type.
//
// Shared bytes (kernels/ssd_scan_bwd.py's two counters):
//   chunks  4*(2*ck*(hd+1) + 2*ck*(state+1) + 2*state*(hd+1)
//              + 3*ck*(ck+1) + 6*ck + 8)
//   states  4*(state*32 + ck*32 + ck*(state+1) + ck)
// Rows are padded by one word, so that a warp reading down a column of
// x, dy, b, c, S_in or dS_out hits 32 banks.  The opt-in above 48 KB is made
// once a kernel instance and device.
//
// Bound on the card: a chunk does about 10*n*state*hd + n^2*(3*state + 2*hd)
// flops over 2*(hd + state) input elements a step, hundreds of flops a byte:
// bound by operations, which this FMA body reaches only at the f32 rate (the
// tensor cores are a later redesign).
#include "common.cuh"

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;           // every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr int kMaxHd = 128;
constexpr int kBd = 32;                 // hd columns a states block
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
cudaError_t launch_all(const Args& p, cudaStream_t st) {
  static size_t granted_states[kMaxDevices] = {};
  static size_t granted_chunks[kMaxDevices] = {};
  cudaError_t err = launch(ssd_bwd_states_kernel<T>,
                           states_smem(p.ck, p.N), granted_states,
                           dim3(p.rows * p.heads, (p.hd + kBd - 1) / kBd, 2),
                           st, p);
  if (err != cudaSuccess) return err;
  err = launch(ssd_bwd_chunk_kernel<T>, chunk_smem(p.ck, p.hd, p.N),
               granted_chunks, dim3(p.rows * p.heads, p.nc), st, p);
  if (err != cudaSuccess) return err;
  const long long total =
      (long long)p.rows * p.seq * (p.heads / p.hsum) * p.N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ssd_bwd_heads_kernel<T>
      <<<dim3((unsigned)(blocks < kHeadsBlocks ? blocks : kHeadsBlocks), 2),
         kThreads, 0, st>>>(p, total);
  return cudaGetLastError();
}

}  // namespace

// Formats it takes (kernels/ssd_scan_bwd.py: format_error mirrors these
// checks): rows, seq, heads, hd, state > 0; 1 <= ck <= min(seq, 64);
// hd <= 128; hsum 1 or heads; rows * heads < 2^31; at most 65,535 chunks;
// f32 or bf16; both kernels' shared memory within 232,448 bytes.  ds0 may
// be null (no d(state0) written).
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
      ck <= 0 || ck > seq || ck > kMaxChunk || hd > kMaxHd || (hsum != 1 && hsum != heads) ||
      (long long)rows * heads > 0x7fffffff ||
      (seq + ck - 1) / ck > kMaxGridY ||
      (elem != ELEM_F32 && elem != ELEM_BF16) || x == nullptr ||
      a == nullptr || b == nullptr || c == nullptr || dy == nullptr ||
      dx == nullptr || da == nullptr || db == nullptr || dc == nullptr ||
      ws == nullptr)
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
         sb_r, sb_t, sb_h, sc_r, sc_t, sc_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem == ELEM_BF16 ? launch_all<bf16>(p, st)
                           : launch_all<float>(p, st);
}
