// K2 flash_attention_h100: online-softmax attention over q [h, sq, d] and
// k, v [hk, sk, d] with h % hk == 0 (grouped-query attention: query head i
// reads KV head i / (h/hk)); sq <= sk, ends aligned (query i sits at key
// position i + sk - sq); causal and sliding-window masks; scale 1/sqrt(d) by
// default; m, l and acc in f32; output [h, sq, d] in q's type.  d <= 128.
//
// Replaces the TPU kernel pallas_flash_attention
// (src/repro/kernels/flash_attention.py:75, _fa_kernel).  The TPU walks kv
// tiles as the last, sequential grid axis and carries m, l and acc in VMEM
// scratch, over K/V broadcast to every query head.  Here a block walks its kv
// tiles in a loop and keeps m, l and acc in registers, and reads each K/V
// tile once for the whole group of query heads that shares it.  Keys at or
// past sk are never read, so padded keys cannot enter the softmax even
// without a causal mask (the TPU kernel lets them in when causal=False).
//
// Bound on the card: a decode step (sq 1) does 4*h*sk*d flops on 2*hk*sk*d
// bf16 bytes of K and V, 4*group flops a byte, and a prefill chunk sq times
// that: far below the ~295 flop/byte where the bf16 tensor cores would bind
// until sq*group reaches the hundreds.  So it is bound by the bytes of K/V,
// which must be read once and with enough of them in flight (~3.4 MB over
// the card).  The design:
//   - GQA packed into M: a block owns one KV head and bq "packed rows", row
//     r = query (r / group) of query head (kvh*group + r % group); a warp
//     owns 16 of them, the tensor-core M.  Decode of llama3-8b puts its 4
//     query heads into one warp's 16 rows and reads K/V 4x less than with
//     the heads broadcast.
//   - a ring of `stages` K/V tiles of bkv keys in shared memory, in the
//     inputs' own type, filled by 16-byte cp.async and XOR-swizzled by
//     16-byte chunk so that the 8 rows an ldmatrix reads fall in 8 bank
//     groups; the copies of tile i+stages-1 are in flight while tile i is
//     computed, and are issued between its products (K after the scores, V
//     after the softmax), since issuing a tile's 16-byte copies takes the
//     SM's load unit about as long as a decode block's products of a tile.
//     Operands whose d or base breaks 16-byte alignment are loaded element
//     by element, masked, synchronously.
//   - bf16 on the tensor cores: S = Q K^T by mma.sync m16n8k16 (Q and K
//     fragments by ldmatrix from their [row][d] tiles), the online
//     softmax on the f32 accumulator fragments (row max and sum over the
//     quad of lanes that share a row), P rounded to bf16 and fed from the
//     registers as the A operand of O += P V (V by ldmatrix.trans).  f32
//     runs the same tiles, ring and fragments with FMA from shared memory
//     (P through a per-warp row of shared memory), never TF32.
//   - key warps: a decode block's few packed rows (bq 16 or 32) would be
//     one or two warps, each alone on its scheduler and waiting on every
//     latency; 64 / bq warps a row warp each take a slice (>= 16 keys) of
//     every tile with their own m, l and acc, combined in key-warp order at
//     the end through shared memory, so that a decode block has 4 warps.
//   - split-KV: the keys are cut into runs of kv_chunk; grid (row blocks,
//     hk, ceil(sk/kv_chunk)), so a decode step over a long cache still puts
//     a hundred blocks on the 132 SMs.  Each split writes its rows' m, l and
//     unnormalised acc to a workspace; a second small launch combines them
//     per output element in split order 0..n-1 (no float atomics: two
//     launches give the same bits).  One split writes O directly.
//   - a block skips the tiles no row of it can see (causal limit, window),
//     and a split that no row of the block can see returns at once, so a
//     windowed decode reads only the window's keys.
//
// The paged entry (flash_attention_h100_paged_launch) is the same kernel
// over the serve path's KV pool: q [rows, h, sq, d], one layer's pools k, v
// [num_blocks, page, hk, d] read in place through the block tables [rows,
// nblk] (int32), and the rows' lengths [rows] (int32) read on the device,
// so one launch covers every row of a layer and a CUDA graph can replay it
// while the lengths and tables change.  Row r attends over its keys 0 ..
// len[r] - 1, its sq queries ending at len[r] - 1; a row of length 0 reads
// nothing and gives zeros.  The grid's y runs over (row, KV head); a key
// tile's rows are gathered page by page through the table, each row by
// 16-byte cp.async as in the dense entry.  The number of splits comes from
// the pool (ceil(nblk * page / kv_chunk)), not from the lengths: a split
// past a row's length returns at once and the combine reads only the splits
// the row's own length reaches.  With f32 q and a bf16 pool (the f32 model
// serves from the bf16 pool) the tiles are f32 and the pool's elements are
// upcast as they are loaded.
#include "attention_tiles.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxGridYZ = 65535;
constexpr int kCombineThreads = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;           // [nsplit][batch·h·sq][D] acc, then [..][2] m, l
  int h, hk, group, sq, sk, d;   // paged: sk is the pool's nblk * page
  int bq, kv_chunk, stages, nsplit;
  float scale, inv_group;
  int causal, window;  // window 0: none
  int vec;             // 16-byte copies allowed for q, k, v
  // paged entry only (dense: batch 1, no tables)
  const int* tables;   // [batch][nblk]
  const int* lens;     // [batch]
  int batch, page, nblk, num_blocks;
};

// A row's key count: the dense entry's sk, or the paged row's length read
// on the device, within 0 .. nblk * page.
template <bool PAGED>
__device__ __forceinline__ int row_keys(const Args& p, int b) {
  if constexpr (PAGED) return min(max(__ldg(p.lens + b), 0), p.sk);
  else return p.sk;
}

template <typename T, typename S>
__device__ __forceinline__ T convert(S x) {
  if constexpr (std::is_same<T, S>::value) {
    return x;
  } else {
    T y;
    from_f32(to_f32(x), &y);
    return y;
  }
}

// f32: the S of the bf16 scores (attention_tiles.cuh) by FMA, Q read from
// its shared tile (warp rows w0..w0+15).
template <int D, int BKV, int NTMAX>
__device__ __forceinline__ void scores(const float* Ks, int kofs, int nt,
                                       int w0, const float* Qs, int lane,
                                       float (&s)[BKV / 8][4]) {
  constexpr int W = D / 4;
  const int r0 = w0 + (lane >> 2), r1 = r0 + 8, q2 = 2 * (lane & 3);
  for (int c = 0; c < W; ++c) {
    const float4 a0 =
        *reinterpret_cast<const float4*>(Qs + (r0 * W + swz(r0, c)) * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(Qs + (r1 * W + swz(r1, c)) * 4);
#pragma unroll
    for (int t = 0; t < BKV / 8; ++t) {
      if (t >= nt) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kofs + t * 8 + q2 + e;
        const float4 b =
            *reinterpret_cast<const float4*>(Ks + (key * W + swz(key, c)) * 4);
        float x = s[t][e], y = s[t][2 + e];
        x = fmaf(a0.x, b.x, x); x = fmaf(a0.y, b.y, x);
        x = fmaf(a0.z, b.z, x); x = fmaf(a0.w, b.w, x);
        y = fmaf(a1.x, b.x, y); y = fmaf(a1.y, b.y, y);
        y = fmaf(a1.z, b.z, y); y = fmaf(a1.w, b.w, y);
        s[t][e] = x;
        s[t][2 + e] = y;
      }
    }
  }
}

// f32: the O of the bf16 pv (attention_tiles.cuh) by FMA, P through the
// warp's [16][BKV + 4] row of shared memory.
template <int D, int BKV>
__device__ __forceinline__ void pv(const float (&p)[BKV / 8][4],
                                   const float* Vs, int kofs, int nt,
                                   float* Ps, int lane,
                                   float (&acc)[D / 8][4]) {
  constexpr int W = D / 4, LD = BKV + 4;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int t = 0; t < BKV / 8; ++t) {
    if (t >= nt) break;
    Ps[g * LD + t * 8 + q2] = p[t][0];
    Ps[g * LD + t * 8 + q2 + 1] = p[t][1];
    Ps[(g + 8) * LD + t * 8 + q2] = p[t][2];
    Ps[(g + 8) * LD + t * 8 + q2 + 1] = p[t][3];
  }
  __syncwarp();
  for (int i = 0; i < nt * 8; ++i) {
    const int key = kofs + i;
    const float p0 = Ps[g * LD + i], p1 = Ps[(g + 8) * LD + i];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = c * 8 + q2;             // even: col, col+1 in a chunk
      const float2 v = *reinterpret_cast<const float2*>(
          Vs + (key * W + swz(key, col >> 2)) * 4 + (col & 3));
      acc[c][0] = fmaf(p0, v.x, acc[c][0]);
      acc[c][1] = fmaf(p0, v.y, acc[c][1]);
      acc[c][2] = fmaf(p1, v.x, acc[c][2]);
      acc[c][3] = fmaf(p1, v.y, acc[c][3]);
    }
  }
}

// Key warps a block gives each row warp: decode's few rows (bq 16 or 32)
// take 64 / bq warps each on a slice of every kv tile, at least 16 keys.
__host__ __device__ __forceinline__ int key_warps(int bq, int bkv) {
  if (bq >= 64) return 1;
  const int kw = 64 / bq;
  return kw < bkv / 16 ? kw : bkv / 16;
}

// r / group for a packed row r < 2^24 (its head in the group is r - q *
// group): a float product and one correction step in place of an integer
// division.
__device__ __forceinline__ int div_group(int r, const Args& p) {
  int q = __float2int_rz((float)r * p.inv_group);
  if ((q + 1) * p.group <= r) ++q;
  else if (q * p.group > r) --q;
  return q;
}

template <typename T, typename KV, int D, int BKV, bool PAGED>
__global__ void __launch_bounds__(256) flash_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int EPC = 16 / sizeof(T), W = D / EPC;  // chunks a tile row
  constexpr bool SAME = std::is_same<T, KV>::value;
  const int kvh = PAGED ? blockIdx.y % p.hk : blockIdx.y;
  const int b = PAGED ? blockIdx.y / p.hk : 0;     // the paged row
  const int sk = row_keys<PAGED>(p, b);
  const size_t rb = (size_t)b * p.h * p.sq;        // the row's first q row
  const T* Q = static_cast<const T*>(p.q) + rb * p.d;
  const KV* K = static_cast<const KV*>(p.k);
  const KV* V = static_cast<const KV*>(p.v);
  T* Qs = reinterpret_cast<T*>(smem_raw);                  // [bq][D]
  T* ring = Qs + p.bq * D;                                 // [stages][2][BKV][D]
  float* Ps = reinterpret_cast<float*>(ring + p.stages * 2 * BKV * D);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrw = p.bq / 16, nkw = key_warps(p.bq, BKV);
  const int rw = warp % nrw, kw = warp / nrw;   // row warp, key warp
  const int nt = BKV / 8 / nkw, kofs = kw * nt * 8;
  const int rows = p.group * p.sq;
  const int r0 = blockIdx.x * p.bq;
  const int z = blockIdx.z;
  const int off = sk - p.sq;

  // keys any row of the block can see, within this split
  const int qi_lo = div_group(r0, p);
  const int qi_hi = div_group(min(r0 + p.bq, rows) - 1, p);
  const int kend = p.causal ? min(sk, qi_hi + off + 1) : sk;
  const int kbeg = p.window > 0 ? max(0, qi_lo + off - p.window + 1) : 0;
  const int zs = z * p.kv_chunk;
  const int lo = max(kbeg, zs);
  const int hi = min(kend, min(sk, zs + p.kv_chunk));
  if (p.nsplit > 1 && lo >= hi) return;     // the combine skips this split
  const int ntiles = hi > lo ? (hi - lo + BKV - 1) / BKV : 0;

  // this thread's two rows
  const int w0 = rw * 16;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  int head[2], qi[2], klo[2], khi[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + w0 + g + 8 * i;
    live[i] = r < rows;
    qi[i] = div_group(r, p);
    head[i] = kvh * p.group + (r - qi[i] * p.group);
    const int qpos = qi[i] + off;
    klo[i] = p.window > 0 ? qpos - p.window + 1 : 0;
    khi[i] = p.causal ? qpos : sk - 1;
  }

  // element offset of key kp's row of this KV head in K and V: dense
  // [hk][sk][d], paged [num_blocks][page][hk][d] through the row's table
  // (an entry out of the pool is clamped into it, as a gather clamps)
  const int* table = PAGED ? p.tables + (size_t)b * p.nblk : nullptr;
  auto key_row = [&](int kp) -> size_t {
    if constexpr (PAGED) {
      const int blk = min(max(__ldg(table + kp / p.page), 0),
                          p.num_blocks - 1);
      return (((size_t)blk * p.page + kp % p.page) * p.hk + kvh) * p.d;
    } else {
      return ((size_t)kvh * p.sk + kp) * p.d;
    }
  };

  // a thread copies chunk lc of tile rows lr0, lr0 + rstep, ... (blockDim
  // is a multiple of W)
  const int lc = threadIdx.x % W, lr0 = threadIdx.x / W;
  const int rstep = blockDim.x / W;
  const bool lc_ok = lc * EPC < p.d;
  // tile i's K (part 1), V (part 2) or both (3) into its ring slot
  auto load_tile = [&](int i, int part) {
    const int k0 = lo + i * BKV;
    T* Ks = ring + (i % p.stages) * 2 * BKV * D;
    const int n = hi - k0;
    if constexpr (SAME) {
      if (p.vec) {
        for (int r = lr0; r < BKV; r += rstep) {
          const bool ok = lc_ok && r < n;
          const size_t at = ok ? key_row(k0 + r) + lc * EPC : 0;
          const int dst = (r * W + (lc ^ (r & 7))) * EPC;
          if (part & 1) cp_async16(Ks + dst, K + at, ok);
          if (part & 2) cp_async16(Ks + BKV * D + dst, V + at, ok);
        }
        return;
      }
    }
    // element by element, upcast to the tiles' type where the pool's
    // differs, masked, synchronously
    for (int e = threadIdx.x; e < BKV * D; e += blockDim.x) {
      const int r = e / D, c = e % D;
      const bool ok = r < n && c < p.d;
      const size_t at = ok ? key_row(k0 + r) + c : 0;
      const int dst = (r * W + swz(r, c / EPC)) * EPC + c % EPC;
      if (part & 1) Ks[dst] = ok ? convert<T>(K[at]) : T(0.f);
      if (part & 2) Ks[BKV * D + dst] = ok ? convert<T>(V[at]) : T(0.f);
    }
  };

  load_rows<T, D>(Qs, p.bq, p.d, p.vec, Q, [&](int r) -> const T* {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int qq = div_group(rr, p);
    const int hq = kvh * p.group + (rr - qq * p.group);
    return Q + ((size_t)hq * p.sq + qq) * p.d;
  });
  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < ntiles) load_tile(i, 3);
    cp_async_commit();                      // group 0 also holds Q
  }

  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] =
      acc[c][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float* Pw = Ps + warp * 16 * (BKV + 4);

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait_ring(p.stages);           // tile i (and Q) landed, here
    __syncthreads();                        // ... everywhere; slot i-1 free
    const bool more = i + p.stages - 1 < ntiles;
    const T* Ks = ring + (i % p.stages) * 2 * BKV * D;
    const T* Vs = Ks + BKV * D;
    const int k0 = lo + i * BKV + kofs;     // this warp's first key

    float s[BKV / 8][4];
#pragma unroll
    for (int t = 0; t < BKV / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] =
        0.f;
    if (nt == 2)
      scores<D, BKV, 2>(Ks, kofs, nt, w0, Qs, lane, s);
    else
      scores<D, BKV, BKV / 8>(Ks, kofs, nt, w0, Qs, lane, s);
    if (more) load_tile(i + p.stages - 1, 1);       // next K, behind them

    // scale and mask (no mask where every live row of the warp sees all of
    // its keys); the rows' maxima over the warp's keys
    const int k1 = k0 + nt * 8;             // past the warp's last key
    bool all = k1 <= hi;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
      all = all && (!live[i2] || (klo[i2] <= k0 && k1 - 1 <= khi[i2]));
    all = __all_sync(0xffffffffu, all);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < BKV / 8; ++t) {
      if (t >= nt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1;
        const int kp = k0 + t * 8 + q2 + (e & 1);
        const bool ok = all || (live[i2] && kp < hi && kp >= klo[i2] &&
                                kp <= khi[i2]);
        s[t][e] = ok ? s[t][e] * p.scale : -INFINITY;
        mx[i2] = fmaxf(mx[i2], s[t][e]);
      }
    }
    float corr[2], ms[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      const float m_new = fmaxf(m[i2], mx[i2]);
      ms[i2] = m_new == -INFINITY ? 0.f : m_new;
      corr[i2] = __expf(m[i2] - ms[i2]);    // m = -inf on the first tile: 0
      m[i2] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < BKV / 8; ++t) {
      if (t >= nt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1;
        s[t][e] = __expf(s[t][e] - ms[i2]);   // masked: exp(-inf) = 0
        sum[i2] += s[t][e];
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      sum[i2] += __shfl_xor_sync(0xffffffffu, sum[i2], 1);
      sum[i2] += __shfl_xor_sync(0xffffffffu, sum[i2], 2);
      l[i2] = l[i2] * corr[i2] + sum[i2];
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[c][0] *= corr[0];
        acc[c][1] *= corr[0];
        acc[c][2] *= corr[1];
        acc[c][3] *= corr[1];
      }
    }
    if (more) load_tile(i + p.stages - 1, 2);       // next V
    cp_async_commit();
    pv<D, BKV>(s, Vs, kofs, nt, Pw, lane, acc);
  }
  cp_async_wait<0>();

  const size_t hsq = (size_t)p.batch * p.h * p.sq;
  float* wacc = p.ws + (size_t)z * hsq * D;
  float* wml = p.ws + (size_t)p.nsplit * hsq * D + (size_t)z * hsq * 2;
  T* const O = static_cast<T*>(p.o);
  if (nkw == 1) {
    // one split: O = acc / l; else this split's m, l and acc to the
    // workspace
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      if (!live[i2]) continue;
      const size_t row = rb + (size_t)head[i2] * p.sq + qi[i2];
      if (p.nsplit == 1) {
        const float inv = l[i2] > 0.f ? 1.f / l[i2] : 0.f;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          store2(O + row * p.d, c * 8 + q2, p.d, acc[c][2 * i2] * inv,
                 acc[c][2 * i2 + 1] * inv);
      } else {
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          store2(wacc + row * D, c * 8 + q2, D, acc[c][2 * i2],
                 acc[c][2 * i2 + 1]);
        if ((lane & 3) == 0)
          *reinterpret_cast<float2*>(wml + row * 2) =
              make_float2(m[i2], l[i2]);
      }
    }
    return;
  }

  // key warps: every warp's slice partials (m, l, acc) go to shared memory,
  // then the block combines them in key-warp order, row by row, and stores
  // the rows with neighbouring threads on neighbouring columns
  __syncthreads();                          // the ring is free
  const int prow = nrw * 16;                // the block's packed rows
  float* cacc = reinterpret_cast<float*>(ring);           // [warps][16][D]
  float* cml = cacc + nrw * nkw * 16 * D;                 // [warps][16][2]
  float* cw = cml + nrw * nkw * 16 * 2;                   // [prow][nkw]
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int row = warp * 16 + g + 8 * i2;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(cacc + row * D + c * 8 + q2) =
          make_float2(acc[c][2 * i2], acc[c][2 * i2 + 1]);
    if ((lane & 3) == 0)
      *reinterpret_cast<float2*>(cml + row * 2) = make_float2(m[i2], l[i2]);
  }
  __syncthreads();
  // a row's weights e^(m_k - M) (over l for one split), M and L
  for (int rl = threadIdx.x; rl < prow; rl += blockDim.x) {
    const int rwi = rl / 16, rr = rl % 16;
    float top = -INFINITY;
    for (int k = 0; k < nkw; ++k)
      top = fmaxf(top, cml[((k * nrw + rwi) * 16 + rr) * 2]);
    float big = 0.f;
    for (int k = 0; k < nkw; ++k) {
      const float2 ml = *reinterpret_cast<const float2*>(
          cml + ((k * nrw + rwi) * 16 + rr) * 2);
      const float e = ml.x == -INFINITY ? 0.f : __expf(ml.x - top);
      cw[rl * nkw + k] = e;
      big += ml.y * e;
    }
    const int r = r0 + rl;
    if (p.nsplit == 1) {
      const float inv = big > 0.f ? 1.f / big : 0.f;
      for (int k = 0; k < nkw; ++k) cw[rl * nkw + k] *= inv;
    } else if (r < rows) {
      const int qq = div_group(r, p);
      const size_t row =
          rb + (size_t)(kvh * p.group + (r - qq * p.group)) * p.sq + qq;
      *reinterpret_cast<float2*>(wml + row * 2) = make_float2(top, big);
    }
  }
  __syncthreads();
  const int cols = p.nsplit == 1 ? p.d : D;
  for (int idx = threadIdx.x; idx < prow * (D / 2); idx += blockDim.x) {
    const int rl = idx / (D / 2), col = 2 * (idx % (D / 2));
    const int r = r0 + rl;
    if (r >= rows || col >= cols) continue;
    const int rwi = rl / 16, rr = rl % 16;
    float x = 0.f, y = 0.f;
    for (int k = 0; k < nkw; ++k) {
      const float e = cw[rl * nkw + k];
      const float2 a = *reinterpret_cast<const float2*>(
          cacc + ((k * nrw + rwi) * 16 + rr) * D + col);
      x += a.x * e;
      y += a.y * e;
    }
    const int qq = div_group(r, p);
    const size_t row =
        rb + (size_t)(kvh * p.group + (r - qq * p.group)) * p.sq + qq;
    if (p.nsplit == 1)
      store2(O + row * p.d, col, p.d, x, y);
    else
      *reinterpret_cast<float2*>(wacc + row * D + col) = make_float2(x, y);
  }
}

// The splits' partials of one output element, combined in split order.  A
// split none of whose keys the row can see was never written and is skipped.
// Loads go B splits at a time, ahead of their maxima and sums (B = 32 when
// the row sees more than 16 splits, 16 when more than 4, else 4: a decode
// over 32 splits waits for two round trips to the L2, a prefill chunk's few
// splits of many rows issue few idle loads).
template <int D, int B>
__device__ __forceinline__ float2 combine_splits(const float* wacc,
                                                 const float* wml, size_t hsq,
                                                 size_t row, int col, int z0,
                                                 int z1) {
  float mx = -INFINITY;
  for (int zb = z0; zb < z1; zb += B) {
    float mv[B];
#pragma unroll
    for (int u = 0; u < B; ++u)
      mv[u] = zb + u < z1 ? __ldg(wml + ((size_t)(zb + u) * hsq + row) * 2)
                          : -INFINITY;
#pragma unroll
    for (int u = 0; u < B; ++u) mx = fmaxf(mx, mv[u]);
  }
  float L = 0.f, acc = 0.f;
  for (int zb = z0; zb < z1; zb += B) {
    float2 ml[B];
    float a[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const bool in = zb + u < z1;
      const size_t at = (size_t)(zb + u) * hsq + row;
      ml[u] = in ? __ldg(reinterpret_cast<const float2*>(wml + at * 2))
                 : make_float2(-INFINITY, 0.f);
      a[u] = in ? __ldg(wacc + at * D + col) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const float e = ml[u].x == -INFINITY ? 0.f : __expf(ml[u].x - mx);
      L += ml[u].y * e;
      acc += a[u] * e;
    }
  }
  return make_float2(L, acc);
}

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const Args p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t hsq = (size_t)p.batch * p.h * p.sq;
  if (idx >= (long long)hsq * p.d) return;
  const size_t row = idx / p.d;            // [batch][h][sq]
  const int col = (int)(idx % p.d);
  const int sk = row_keys<PAGED>(p, (int)(row / ((size_t)p.h * p.sq)));
  const int qpos = (int)(row % p.sq) + sk - p.sq;
  const int klo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
  const int khi = min(p.causal ? qpos : sk - 1, sk - 1);
  T* out = static_cast<T*>(p.o) + row * p.d + col;
  if (khi < klo) {                         // a paged row that sees no key
    from_f32(0.f, out);
    return;
  }
  const float* wml = p.ws + (size_t)p.nsplit * hsq * D;
  // the splits the row sees: z0 <= z < z1
  const int z0 = klo / p.kv_chunk, z1 = min(p.nsplit, khi / p.kv_chunk + 1);
  const int n = z1 - z0;
  const float2 la =
      n > 16  ? combine_splits<D, 32>(p.ws, wml, hsq, row, col, z0, z1)
      : n > 4 ? combine_splits<D, 16>(p.ws, wml, hsq, row, col, z0, z1)
              : combine_splits<D, 4>(p.ws, wml, hsq, row, col, z0, z1);
  from_f32(la.x > 0.f ? la.y / la.x : 0.f, out);
}

// Shared memory: the Q tile, then the ring (and for f32 each warp's row of
// probabilities), which the key warps' combine reuses at the end.
template <typename T, int D, int BKV>
size_t smem_bytes(int bq, int stages) {
  const size_t warps = (size_t)(bq / 16) * key_warps(bq, BKV);
  const size_t ring =
      sizeof(T) * (size_t)stages * 2 * BKV * D +
      (sizeof(T) == 4 ? sizeof(float) * warps * 16 * (BKV + 4) : 0);
  const size_t combine =
      key_warps(bq, BKV) > 1 ? sizeof(float) * warps * 16 * (D + 6) : 0;
  return sizeof(T) * (size_t)bq * D + (ring > combine ? ring : combine);
}

template <typename T, typename KV, int D, int BKV, bool PAGED>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  auto kernel = flash_kernel<T, KV, D, BKV, PAGED>;
  const size_t smem = smem_bytes<T, D, BKV>(p.bq, p.stages);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static size_t granted[kMaxDevices] = {};
  cudaError_t err = allow_smem_once(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.group * p.sq + p.bq - 1) / p.bq, p.hk * p.batch,
                  p.nsplit);
  kernel<<<grid, 32 * (p.bq / 16) * key_warps(p.bq, BKV), smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  const long long n = (long long)p.batch * p.h * p.sq * p.d;
  combine_kernel<T, D, PAGED><<<(unsigned)((n + kCombineThreads - 1) /
                                           kCombineThreads),
                                kCombineThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV, bool PAGED, int D>
cudaError_t by_bkv(const Args& p, int bkv, cudaStream_t st) {
  switch (bkv) {
    case 32: return launch<T, KV, D, 32, PAGED>(p, st);
    case 64: return launch<T, KV, D, 64, PAGED>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV, bool PAGED>
cudaError_t by_dim(const Args& p, int bkv, cudaStream_t st) {
  return p.d <= 64 ? by_bkv<T, KV, PAGED, 64>(p, bkv, st)
                   : by_bkv<T, KV, PAGED, 128>(p, bkv, st);
}

bool format_ok(int h, int hk, int sq, int d, int bq, int bkv, int kv_chunk,
               int stages, int elem) {
  return h > 0 && hk > 0 && h % hk == 0 && sq > 0 && d > 0 && d <= 128 &&
         (bq == 16 || bq == 32 || bq == 64 || bq == 128) &&
         (bkv == 32 || bkv == 64) && kv_chunk > 0 && kv_chunk % bkv == 0 &&
         stages >= 2 && stages <= 4 &&
         (elem == ELEM_F32 || elem == ELEM_BF16) &&
         (long long)(h / hk) * sq < (1 << 24);
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// Formats it takes (kernels/flash_attention.py: format_error mirrors these
// checks): h a multiple of hk; 1 <= sq <= sk; (h / hk) * sq packed rows
// below 2^24; 1 <= d <= 128; bq in {16, 32, 64, 128} (packed rows a block,
// 16 a warp); bkv in {32, 64}; kv_chunk a positive multiple of bkv; stages
// in {2, 3, 4}; at most 65,535 KV heads and splits, and a workspace when
// there is more than one split; the tiles within 232,448 bytes of shared
// memory.
extern "C" int flash_attention_h100_launch(
    const void* q, const void* k, const void* v, void* o, void* ws, int h,
    int hk, int sq, int sk, int d, int bq, int bkv, int kv_chunk, int stages,
    float scale, int causal, int window, int elem, void* stream) {
  if (!format_ok(h, hk, sq, d, bq, bkv, kv_chunk, stages, elem) || sk < sq ||
      hk > kMaxGridYZ)
    return cudaErrorInvalidValue;
  const int nsplit = (sk + kv_chunk - 1) / kv_chunk;
  if (nsplit > kMaxGridYZ || (nsplit > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const int epc = elem == ELEM_BF16 ? 8 : 4;
  Args p{q, k, v, o, static_cast<float*>(ws), h, hk, h / hk, sq, sk, d, bq,
         kv_chunk, stages, nsplit, scale, 1.f / (h / hk), causal,
         window > 0 ? window : 0,
         d % epc == 0 && aligned16(q) && aligned16(k) && aligned16(v),
         nullptr, nullptr, 1, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem == ELEM_BF16 ? by_dim<__nv_bfloat16, __nv_bfloat16, false>(
                                 p, bkv, st)
                           : by_dim<float, float, false>(p, bkv, st);
}

// The paged entry: q, o [rows][h][sq][d] (elem), the pools k, v
// [num_blocks][page][hk][d] (kv_elem: bf16 under either q, or f32 under
// f32 q), tables [rows][nblk] and lens [rows] int32 on the device.  Takes
// the dense entry's formats with sq <= nblk * page in place of sq <= sk,
// at most 65,535 (row, KV head) pairs, and a pool of at most 2^31 - 1
// positions (kernels/flash_attention.py: format_error mirrors the checks).
extern "C" int flash_attention_h100_paged_launch(
    const void* q, const void* k, const void* v, void* o, void* ws,
    const void* tables, const void* lens, int rows, int h, int hk, int sq,
    int d, int num_blocks, int page, int nblk, int bq, int bkv, int kv_chunk,
    int stages, float scale, int causal, int window, int elem, int kv_elem,
    void* stream) {
  if (!format_ok(h, hk, sq, d, bq, bkv, kv_chunk, stages, elem) ||
      rows <= 0 || num_blocks <= 0 || page <= 0 || nblk <= 0 ||
      (long long)nblk * page > 0x7fffffffLL || sq > nblk * page ||
      (long long)hk * rows > kMaxGridYZ || tables == nullptr ||
      lens == nullptr || (kv_elem != ELEM_F32 && kv_elem != ELEM_BF16) ||
      (elem == ELEM_BF16 && kv_elem != ELEM_BF16))
    return cudaErrorInvalidValue;
  const int keys = nblk * page;
  const int nsplit = (keys + kv_chunk - 1) / kv_chunk;
  if (nsplit > kMaxGridYZ || (nsplit > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const int epc = elem == ELEM_BF16 ? 8 : 4;
  Args p{q, k, v, o, static_cast<float*>(ws), h, hk, h / hk, sq, keys, d,
         bq, kv_chunk, stages, nsplit, scale, 1.f / (h / hk), causal,
         window > 0 ? window : 0,
         d % epc == 0 && aligned16(q) && aligned16(k) && aligned16(v),
         static_cast<const int*>(tables), static_cast<const int*>(lens), rows,
         page, nblk, num_blocks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == ELEM_BF16)
    return by_dim<__nv_bfloat16, __nv_bfloat16, true>(p, bkv, st);
  return kv_elem == ELEM_BF16 ? by_dim<float, __nv_bfloat16, true>(p, bkv, st)
                              : by_dim<float, float, true>(p, bkv, st);
}
