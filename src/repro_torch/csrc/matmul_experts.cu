// K1b matmul_experts_h100: the experts' batched product of a mixture-of-
// experts layer, C[e] = op(A[e]) @ op(B[e]) for e < E in one launch, bf16
// in, f32 accumulation, bf16 out (rounded once, to nearest even, as
// .to(torch.bfloat16) rounds).  op is the identity or, by the layout flags,
// a transpose read in place: ta says A is stored [E, K, M], tb that B is
// stored [E, N, K]; otherwise A is [E, M, K] and B [E, K, N] (the model's
// weight layout).  C is [E, M, N].
//
// Replaces the TPU kernel pallas_matmul (src/repro/kernels/matmul.py:73)
// over the experts, as the JAX MoE layer's per-expert einsum traces it
// (src/repro/plans/trace.py:150-154).  On the TPU the experts' products are
// E matmuls of the same (M, N, K); here they are one launch over the
// E * ceil(M / bm) * ceil(N / bn) tiles of every expert's C.
//
// Bound on the card: at the serve keys (M = 4..32 rows an expert) the bytes
// of B, every expert's weights read once; at the training keys (M = 80..
// 8192, K = 27..8192) the bytes at small K and the tensor cores at large.
// K1's batched entry ran these keys on mma.sync from 16-row warp tiles with
// f32 output, reading the weights ceil(M / 64) times and writing twice the
// output's bytes, and a transposed operand needed a K4b copy first.  The
// design:
//   - persistent blocks: as many as the SMs hold (the occupancy of the
//     format), each walking the tiles t = blockIdx.x, + gridDim.x, ... in
//     (column, row, expert) order, so a tile's epilogue overlaps the next
//     tile's loads: at the dB keys (K = 27..320, one to five k tiles a
//     tile) the epilogue is most of a tile's time.
//   - TMA ring: one producer warp keeps `stages` slots of A and B tiles in
//     flight across the block's tiles (64 of K a slot: one 128-byte
//     swizzled row of bf16), each slot with a "full" mbarrier (TMA
//     transactions) and an "empty" one (the consumer warps' releases).
//     Every tile is a box of a 3-D tensor map [E, rows, cols]: a box past
//     an expert's last row or column is zero-filled inside that expert and
//     never reads the next one's.
//   - wgmma: bm / 64 consumer warpgroups (bm 64 or 128), each owning 64
//     rows x bn columns (bn 64, 128 or 256) of C in bn / 2 f32 registers a
//     thread, issue wgmma.mma_async m64nbnk16 from the swizzled tiles, one
//     group of four (a k tile) kept in flight while the next slot is
//     awaited.  A transposed operand is the same box read MN-major: the
//     descriptor's transpose bit, 64-element blocks 8 KB apart (lbo), so
//     dA = dC B^T reads the stored weight and dB = A^T dC the stored
//     activations with no copy.
//   - epilogue: each consumer warpgroup rounds its tile to bf16 into a
//     shared staging tile in the same 128-byte swizzle (conflict-free
//     4-byte writes), once the previous tile's stores have read it, and
//     one thread writes it with TMA stores, which clip rows and columns
//     past the matrix.
//   - determinism: each output element is one thread's sum over the k tiles
//     in order, the same order every launch (whichever block takes the
//     tile); no split-K, no atomics.
// The tensor maps are kernel parameters (__grid_constant__), so a CUDA
// graph captures them by value; the launch allocates nothing.  The driver's
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint (the
// library links no -lcuda).
#include "hopper.cuh"

#include <cuda.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBk = 64;              // k a tile: one 128-byte bf16 row
constexpr int kBox = 64 * 64 * 2;    // bytes of a 64 x 64 bf16 box
constexpr int kMaxThreads = 2 * 128 + 32;

struct Args {
  int E, M, N, K;
  int nc;       // consumer warpgroups: bm / 64
  int stages;   // ring slots
};

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64<TA, TB>(d, da, db);
  } else if constexpr (BN == 128) {
    wgmma_n128<TA, TB>(d, da, db);
  } else {
    wgmma_n256<TA, TB>(d, da, db);
  }
}

template <int BN, int TA, int TB>
__global__ void __launch_bounds__(kMaxThreads, 1)
    experts_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_c, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles repeat every 1024 bytes: align the ring to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int a_bytes = p.nc * kBox, b_bytes = (BN / 64) * kBox;
  unsigned char* ring_a = smem;                          // [stages][bm][64]
  unsigned char* ring_b = ring_a + p.stages * a_bytes;   // [stages][..]
  unsigned char* tile_c = ring_b + p.stages * b_bytes;   // [nc][bn/64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(tile_c + p.nc * 64 * BN * 2);
  uint64_t* empty = full + p.stages;

  const int bm = 64 * p.nc;
  const int tiles_n = (p.N + BN - 1) / BN, tiles_m = (p.M + bm - 1) / bm;
  const int tiles = tiles_n * tiles_m * p.E;
  const int nk = (p.K + kBk - 1) / kBk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * p.nc);   // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * p.nc) {
    // the producer warp: lane 0 keeps the ring's loads in flight across
    // the block's tiles
    if (lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % tiles_n) * BN;
      const int m0 = (t / tiles_n % tiles_m) * bm;
      const int ex = t / tiles_n / tiles_m;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % p.stages;
        if (it >= p.stages) mbar_wait(empty + s, ((it / p.stages) - 1) & 1);
        mbar_expect_tx(full + s, a_bytes + b_bytes);
        const int k0 = kt * kBk;
        unsigned char* ta = ring_a + s * a_bytes;
        unsigned char* tb = ring_b + s * b_bytes;
        for (int c = 0; c < p.nc; ++c) {
          if (TA)
            tma_load_3d(ta + c * kBox, &map_a, m0 + 64 * c, k0, ex, full + s);
          else
            tma_load_3d(ta + c * kBox, &map_a, k0, m0 + 64 * c, ex, full + s);
        }
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          if (TB)
            tma_load_3d(tb + c * kBox, &map_b, k0, n0 + 64 * c, ex, full + s);
          else
            tma_load_3d(tb + c * kBox, &map_b, n0 + 64 * c, k0, ex, full + s);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 w .. + 63 of each of the block's
  // tiles
  const int w = warp >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* tc = tile_c + w * 64 * BN * 2;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (warp & 3) + g;
  float acc[BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % tiles_n) * BN;
    const int m0 = (t / tiles_n % tiles_m) * bm;
    const int ex = t / tiles_n / tiles_m;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_operands(acc);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % p.stages;
      mbar_wait(full + s, (it / p.stages) & 1);
      __syncwarp();                    // wgmma's .aligned: the warp whole
      const unsigned char* ta = ring_a + s * a_bytes + w * kBox;
      const unsigned char* tb = ring_b + s * b_bytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        // K-major: 16 of k are 32 bytes along a row; MN-major: 16 rows
        const uint64_t da = TA ? wgmma_desc(ta + kk * 2048, kBox, 1024)
                               : wgmma_desc(ta + kk * 32, 16, 1024);
        const uint64_t db = TB ? wgmma_desc(tb + kk * 32, 16, 1024)
                               : wgmma_desc(tb + kk * 2048, kBox, 1024);
        // wgmma's transpose bits say MN-major: A stored [K, M] (ta), B
        // stored [K, N] (not tb)
        wgmma_tile<BN, TA, 1 - TB>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();                 // the previous k tile's products
      if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % p.stages);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(empty + (it - 1) % p.stages);
    if (m0 + 64 * w >= p.M) continue;  // every row of this warpgroup past M

    // epilogue: once the previous tile's stores have read the staging
    // tile, bf16 into it in the 128-byte swizzle, then TMA stores of its
    // 64 x 64 boxes.  Accumulator j of a thread (g = lane / 4, q = lane %
    // 4, r = 16 (warp % 4) + g): rows r | r + 8, columns 8 (j / 4) + 2q,
    // +1.
    if (leader) tma_store_wait_read();
    named_barrier(1 + w, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int chunk = (j & 7) ^ (r & 7);
        *reinterpret_cast<unsigned*>(tc + (j >> 3) * kBox + r * 128 +
                                     chunk * 16 + q * 4) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + w, 128);
    if (leader) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        if (n0 + 64 * c < p.N)
          tma_store_3d(&map_c, tc + c * kBox, n0 + 64 * c, m0 + 64 * w, ex);
      tma_store_commit();
    }
  }
  if (leader) tma_store_wait_all();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (resolved
// once a process).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor [E, outer, inner] (inner contiguous) as a 3-D tensor map
// of 64 x 64 boxes in the 128-byte swizzle; false when the driver refuses.
bool make_map(CUtensorMap* map, const void* base, int inner, int outer,
              int E) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(inner), cuuint64_t(outer),
                              cuuint64_t(E)};
  const cuuint64_t strides[2] = {cuuint64_t(inner) * 2,
                                 cuuint64_t(inner) * outer * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_bytes(int bm, int bn, int stages) {
  return 1024 + size_t(stages) * (bm + bn) * kBk * 2 + size_t(bm) * bn * 2 +
         2 * size_t(stages) * sizeof(uint64_t);
}

template <int BN, int TA, int TB>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                   const CUtensorMap& mc, const Args& p, int E,
                   cudaStream_t stream) {
  auto kernel = experts_kernel<BN, TA, TB>;
  const size_t smem = smem_bytes(64 * p.nc, BN, p.stages);
  static size_t granted[kMaxDevices] = {};
  cudaError_t err = allow_smem_once(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const int threads = 128 * p.nc + 32;
  // persistent: as many blocks as the SMs hold, each walking its tiles;
  // that count is asked once a device and format (stages 2-4, nc 1-2)
  static int resident[kMaxDevices][3][2] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int* slot = dev < kMaxDevices ? &resident[dev][p.stages - 2][p.nc - 1]
                                : nullptr;
  int blocks = slot != nullptr ? *slot : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, smem)) != cudaSuccess)
      return err;
    blocks = sms * per_sm;
    if (slot != nullptr) *slot = blocks;
  }
  const long long tiles = (long long)((p.N + BN - 1) / BN) *
                          ((p.M + 64 * p.nc - 1) / (64 * p.nc)) * E;
  const long long grid = tiles < blocks ? tiles : blocks;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(ma, mb, mc, p);
  return cudaGetLastError();
}

template <int TA, int TB>
cudaError_t by_width(const CUtensorMap& ma, const CUtensorMap& mb,
                     const CUtensorMap& mc, const Args& p, int E, int bn,
                     cudaStream_t st) {
  switch (bn) {
    case 64: return launch<64, TA, TB>(ma, mb, mc, p, E, st);
    case 128: return launch<128, TA, TB>(ma, mb, mc, p, E, st);
    case 256: return launch<256, TA, TB>(ma, mb, mc, p, E, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C [E, M, N] (bf16) = op(A) @ op(B), A [E, M, K] or, with ta, [E, K, M];
// B [E, K, N] or, with tb, [E, N, K]; all bf16 and contiguous.
// Formats it takes (kernels/matmul_experts.py: format_error mirrors these
// checks): bm in {64, 128}, bn in {64, 128, 256}, stages in {2, 3, 4}, not
// both ta and tb; 16-byte-aligned bases; each operand's contiguous dim and
// N multiples of 8 (16-byte rows for TMA); at most 2^31 - 1 tiles; the
// ring and the staging tile within 232,448 bytes.
extern "C" int matmul_experts_h100_launch(const void* a, const void* b,
                                          void* c, int E, int M, int N, int K,
                                          int ta, int tb, int bm, int bn,
                                          int stages, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || K <= 0 || (bm != 64 && bm != 128) ||
      (bn != 64 && bn != 128 && bn != 256) || stages < 2 || stages > 4 ||
      (ta && tb) || !aligned16(a) || !aligned16(b) || !aligned16(c) ||
      (ta ? M : K) % 8 != 0 || (tb ? K : N) % 8 != 0 || N % 8 != 0 ||
      (long long)E * ((M + bm - 1) / bm) * ((N + bn - 1) / bn) > INT_MAX ||
      smem_bytes(bm, bn, stages) > size_t(kMaxSmem))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mc;
  if (!(ta ? make_map(&ma, a, M, K, E) : make_map(&ma, a, K, M, E)) ||
      !(tb ? make_map(&mb, b, K, N, E) : make_map(&mb, b, N, K, E)) ||
      !make_map(&mc, c, N, M, E))
    return cudaErrorInvalidValue;
  const Args p{E, M, N, K, bm / 64, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ta) return by_width<1, 0>(ma, mb, mc, p, E, bn, st);
  if (tb) return by_width<0, 1>(ma, mb, mc, p, E, bn, st);
  return by_width<0, 0>(ma, mb, mc, p, E, bn, st);
}
