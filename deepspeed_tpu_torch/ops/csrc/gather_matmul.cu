// Blocked GEMM of the ZeRO-3 fused gather-matmul MLP, Hopper: C = A @ B.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/gather_matmul.py
// `_matmul_kernel` (:71, launched by `_matmul_impl` at :133).  That kernel
// computes [M, K] @ [K, N] -> [M, N] in 256x256x256 blocks, zero-padding the
// operands to block multiples and carrying an fp32 VMEM accumulator over the
// sequential K grid axis; the result has x's dtype.  Here every route sums
// the products in fp32 and rounds the sums once to the operands' type; the
// ragged edges are masked (or zero-filled by TMA) instead of padded copies.
//
// Each operand comes with its two element strides, so the backward's
// dx = g @ w^T and dw = x^T @ g read w and x in place (a transposed view has
// unit stride along its rows instead of its columns).
//
// Bound: the operations at every shape of the path (gpt2-350m MLP at
// micro 8 x seq 1024: M 8192, K 1024, N 4096 is 68.7 GFLOP, 0.069 ms at
// 989 TFLOP/s bf16, against 0.027 ms for its 92 MB at 3.35 TB/s).
//
// Three routes, chosen by the caller from the operands before the launch
// (ops/gather_matmul.py `route`):
//  * wgmma (bf16 operands TMA can read: one unit stride, the other a
//    multiple of 8 elements, 16-byte-aligned bases).  A persistent kernel,
//    one block per SM walking output tiles of 128 x 256 (128 x 128 when
//    N <= 128), grouped 8 tiles down M so that neighbouring tiles share
//    their B panel in L2.  One producer thread keeps TMA loads of 64-deep
//    A and B chunks in flight through a ring of 4 (6) stages guarded by
//    mbarriers; two consumer warpgroups, 64 output rows each, issue
//    wgmma.m64nNk16 on the swizzled tiles with the fp32 sums in registers
//    (setmaxnreg moves the producer's registers to them), keep one chunk's
//    products in flight while the next chunk's are issued, and store the
//    rounded sums through shared memory in 64-column chunks (whole
//    128-byte row segments a warp, masked at the edges) while the producer
//    already loads the next tile.  A transposed operand is
//    loaded as its storage lies (unit-stride axis innermost) and read
//    MN-major through wgmma's transpose bit: no transposed copy.
//  * mma (bf16 that TMA cannot take: a stride-0 gradient, a row pitch that
//    is not a multiple of 8 elements, a misaligned base).  One 256-thread
//    block a 128x128 output tile, K in 64-deep chunks staged through shared
//    memory, 8 warps each owning a 64x32 sub-tile as 4x2 wmma 16x16x16
//    fragments; the next chunk's global loads are issued into registers
//    before the current chunk's products.  The loads take the unit-stride
//    axis: 16-byte vectors where aligned and inside, masked scalars
//    elsewhere, element by element for a view with no unit stride.
//  * fma (fp32, the card-vs-CPU reference): FMA loops in full fp32 (never
//    TF32) over 64x64 tiles, 4x4 outputs a thread.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for operands the route does
// not take, or a tensor map cuTensorMapEncodeTiled refuses).  Route codes: 0 fma,
// 1 mma, 2 wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

// One operand: a logical rows x cols matrix, element (r, c) at
// p[r * sr + c * sc].  mode 0: sc == 1 (rows contiguous), mode 1: sr == 1
// (columns contiguous), mode 2: neither.  vec: 16-byte vector loads along
// the unit-stride axis are aligned wherever the vector starts on a multiple
// of 8 elements.
struct Operand {
  const void* p;
  long long sr, sc;
  int rows, cols, mode, vec;
};

// ---- tensor-core path (bf16) -------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 64;  // output tile, K chunk
constexpr int kWarpM = 64, kWarpN = 32;        // a warp's sub-tile: 8 warps as 2 (M) x 4 (N)
constexpr int kLdA = kBK + 8;                  // smem row pitches (elements), 16-byte multiples
constexpr int kLdB = kBN + 8;
constexpr int kVecs = kBM * kBK / 8 / kThreads;  // 8-element vectors a thread and operand: 4
static_assert(kBM * kBK == kBK * kBN, "both tiles hold as many elements");

// The vectors of an R x C tile at (r0, c0) that thread `tid` loads: its
// i-th vector starts at (row, col) and runs 8 elements along the operand's
// unit-stride axis (down the column in mode 1, along the row otherwise).
template <int R, int C>
__device__ __forceinline__ void vec_pos(int mode, int lin, int& row, int& col) {
  if (mode == 1) {
    col = lin / (R / 8);
    row = (lin % (R / 8)) * 8;
  } else {
    row = lin / (C / 8);
    col = (lin % (C / 8)) * 8;
  }
}

template <int R, int C>
__device__ __forceinline__ void fetch_tile(const Operand& o, int r0, int c0, int tid,
                                           uint4 (&v)[kVecs]) {
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(o.p);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    int row, col;
    vec_pos<R, C>(o.mode, tid + kThreads * i, row, col);
    const int gr = r0 + row, gc = c0 + col;
    // the vector's step between elements and how many of its 8 lie inside
    const long long step = o.mode == 1 ? o.sr : o.sc;
    const int inside = o.mode == 1 ? (gc < o.cols ? o.rows - gr : 0)
                                   : (gr < o.rows ? o.cols - gc : 0);
    uint4 w = make_uint4(0, 0, 0, 0);
    if (inside > 0) {
      const __nv_bfloat16* src = base + gr * o.sr + gc * o.sc;
      if (o.mode != 2 && o.vec && inside >= 8) {
        w = *reinterpret_cast<const uint4*>(src);
      } else {
        __align__(16) __nv_bfloat16 e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = j < inside ? src[j * step] : zero;
        w = *reinterpret_cast<uint4*>(e);
      }
    }
    v[i] = w;
  }
}

// registers -> the tile in shared memory, row-major with pitch `ld`
template <int R, int C>
__device__ __forceinline__ void stage_tile(int mode, int tid, const uint4 (&v)[kVecs],
                                           __nv_bfloat16* s, int ld) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    int row, col;
    vec_pos<R, C>(mode, tid + kThreads * i, row, col);
    if (mode == 1) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[(row + j) * ld + col] = e[j];
    } else {
      *reinterpret_cast<uint4*>(s + row * ld + col) = v[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_mma_kernel(Operand a, Operand b, __nv_bfloat16* out, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kLdB];
  __shared__ __align__(128) float scratch[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  uint4 va[kVecs], vb[kVecs];

  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kWarpM / 16][kWarpN / 16];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch_tile<kBM, kBK>(a, m0, 0, tid, va);
  fetch_tile<kBK, kBN>(b, 0, n0, tid, vb);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    stage_tile<kBM, kBK>(a.mode, tid, va, As, kLdA);
    stage_tile<kBK, kBN>(b.mode, tid, vb, Bs, kLdB);
    __syncthreads();
    if (k0 + kBK < K) {  // in flight during the products
      fetch_tile<kBM, kBK>(a, m0, k0 + kBK, tid, va);
      fetch_tile<kBK, kBN>(b, k0 + kBK, n0, tid, vb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[kWarpM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[kWarpN / 16];
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * kWarpM + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kWarpN / 16; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + wn * kWarpN + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 16; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with this chunk's tiles
  }

  // epilogue: per fragment through the warp's scratch, round once, store
  float* sc = scratch[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < kWarpN / 16; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * kWarpM + 16 * i + r;
      const int gn0 = n0 + wn * kWarpN + 16 * j + c0;
      if (gm < M) {
        __nv_bfloat16* dst = out + static_cast<long long>(gm) * N;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (gn0 + c < N) dst[gn0 + c] = __float2bfloat16_rn(sc[r * 16 + c0 + c]);
      }
      __syncwarp();
    }
  }
}

// ---- fp32 path ----------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;  // tile and K chunk; 256 threads, 4x4 outputs each

// element `lin` of an R x C tile, consecutive threads along the unit-stride axis
template <int R, int C>
__device__ __forceinline__ void elem_pos(int mode, int lin, int& row, int& col) {
  if (mode == 1) {
    col = lin / R;
    row = lin % R;
  } else {
    row = lin / C;
    col = lin % C;
  }
}

template <int R, int C>
__device__ __forceinline__ float load_elem(const Operand& o, int r0, int c0, int row, int col) {
  const int gr = r0 + row, gc = c0 + col;
  return (gr < o.rows && gc < o.cols) ? static_cast<const float*>(o.p)[gr * o.sr + gc * o.sc] : 0.f;
}

__global__ void __launch_bounds__(kThreads)
gemm_fma_kernel(Operand a, Operand b, float* out, int M, int N, int K) {
  __shared__ float As[kFK][kFM + 4];  // K-major: As[k][m]
  __shared__ float Bs[kFK][kFN + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFM * kFK / kThreads; ++i) {
      int row, col;
      elem_pos<kFM, kFK>(a.mode, tid + kThreads * i, row, col);
      As[col][row] = load_elem<kFM, kFK>(a, m0, k0, row, col);
      elem_pos<kFK, kFN>(b.mode, tid + kThreads * i, row, col);
      Bs[row][col] = load_elem<kFK, kFN>(b, k0, n0, row, col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

// ---- wgmma path (bf16 operands TMA can read) ----------------------------
namespace wg {

constexpr int kBM = 128, kBK = 64;         // tile rows, K chunk
constexpr int kConsumers = 2;              // warpgroups of 64 output rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // the consumers, then the producer
constexpr int kGroupM = 8;                 // tiles walked down M before stepping along N
constexpr int kABytes = kBM * kBK * 2;     // 16 KB: 128 rows x 128 bytes, or two 64x64 boxes
constexpr uint32_t kBox = 64 * 64 * 2;     // one 64 x 64 box of an MN-major operand
constexpr uint32_t kAtomRows = 1024;       // bytes of 8 swizzled 128-byte rows (SBO)

constexpr int kEpiPitch = 72;             // bf16 a staged output row: 64 + 8 spreads the banks
constexpr int kEpiBytes = 64 * kEpiPitch * 2;  // one consumer's 64 x 64 output chunk

template <int BN>
struct Tile {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  // 1024 bytes to align the ring; the ring; each consumer's output staging; the barriers
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + kConsumers * kEpiBytes +
                                  2 * kStages * sizeof(uint64_t);
};

template <int BN, int TA, int TB>
__device__ __forceinline__ void tile_mma(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    hopper::wgmma_ss_n256<TA, TB>(acc, da, db, 1);
  else
    hopper::wgmma_ss_n128<TA, TB>(acc, da, db, 1);
}

// A_MN: A is M-major (a transposed view, sam == 1), else K-major (sak == 1);
// B_MN: B is N-major (sbn == 1), else K-major (sbk == 1).
template <int BN, int A_MN, int B_MN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, __nv_bfloat16* __restrict__ out,
                  int M, int N, int K) {
  using L = Tile<BN>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* staging = ring + L::kStages * L::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * kEpiBytes);
  uint64_t* empty = full + L::kStages;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int ntm = (M + kBM - 1) / kBM, ntn = (N + BN - 1) / BN, ntiles = ntm * ntn;
  const int nk = (K + kBK - 1) / kBK;
  if (wgi == kConsumers) {
    // producer: one thread issues every load; the warpgroup gives its registers away
    reg_dealloc<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int m0, n0;
        grouped_tile(t, ntm, ntn, kGroupM, kBM, BN, m0, n0);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = ring + stage * L::kStageBytes;
          unsigned char* b = a + kABytes;
          mbar_expect_tx(&full[stage], L::kStageBytes);
          const int k0 = kc * kBK;
          if (A_MN) {
            tma_load_2d(a, &map_a, &full[stage], m0, k0);
            tma_load_2d(a + kBox, &map_a, &full[stage], m0 + 64, k0);
          } else {
            tma_load_2d(a, &map_a, &full[stage], k0, m0);
          }
          if (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(b + j * kBox, &map_b, &full[stage], n0 + 64 * j, k0);
          } else {
            tma_load_2d(b, &map_b, &full[stage], k0, n0);
          }
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroup wgi: rows 64 wgi .. 64 wgi + 63 of every tile
    reg_alloc<232>();
    const int w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
    const bool vec = (N % 8) == 0;  // 16-byte vectors of a row are aligned
    __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(staging + wgi * kEpiBytes);
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int m0, n0;
      grouped_tile(t, ntm, ntn, kGroupM, kBM, BN, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(&full[stage], phase);
        // this warpgroup's 64 rows of A: one 8 KB half of the A tile either way
        const uint32_t a = smem_addr(ring + stage * L::kStageBytes) + wgi * 8192;
        const uint32_t b = smem_addr(ring + stage * L::kStageBytes + kABytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = A_MN ? desc_sw128(a + kk * 2048, kBox, kAtomRows)
                                   : desc_sw128(a + kk * 32, 16, kAtomRows);
          const uint64_t db = B_MN ? desc_sw128(b + kk * 2048, kBox, kAtomRows)
                                   : desc_sw128(b + kk * 32, 16, kAtomRows);
          tile_mma<BN, A_MN, B_MN>(acc, da, db);
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // the previous chunk's products are done: free its stage
        fence_regs(acc);
        if (prev >= 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(&empty[prev]);

      // epilogue: round once; each 64-column chunk goes through shared
      // memory so that a warp stores whole 128-byte row segments
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * c + jj;
          __nv_bfloat16* e = epi + (w * 16 + g) * kEpiPitch + 8 * jj + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(e) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(e + 8 * kEpiPitch) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
        named_sync(1 + wgi, 128);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // 64 rows x 8 vectors of 8 columns
          const int v = tid + 128 * i, r = v / 8, cv = (v % 8) * 8;
          const int row = m0 + wgi * 64 + r, col = n0 + 64 * c + cv;
          if (row < M && col < N) {
            const __nv_bfloat16* src = epi + r * kEpiPitch + cv;
            __nv_bfloat16* dst = out + static_cast<long long>(row) * N + col;
            if (vec && col + 8 <= N) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
              for (int x = 0; x < 8 && col + x < N; ++x) dst[x] = src[x];
            }
          }
        }
        named_sync(1 + wgi, 128);
      }
    }
  }
}

// The tensor map of one operand: a logical rows x cols matrix whose unit
// stride runs along its columns (along_rows = false) or down its rows
// (along_rows = true), `pitch` elements between its lines; the box is
// `inner` (along the unit stride) x `outer` elements.
bool operand_map(CUtensorMap* map, const void* p, int rows, int cols, bool along_rows,
                 long long pitch, uint32_t inner, uint32_t outer) {
  const uint64_t dims[2] = {static_cast<uint64_t>(along_rows ? rows : cols),
                            static_cast<uint64_t>(along_rows ? cols : rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(pitch) * 2};
  const uint32_t box[2] = {inner, outer};
  return hopper_host::encode_bf16(map, p, 2, dims, strides, box);
}

template <int BN, int A_MN, int B_MN>
int launch(const void* a, const void* b, __nv_bfloat16* c, int M, int N, int K, long long pa,
           long long pb, cudaStream_t s) {
  CUtensorMap ma, mb;
  // A is M x K: K-major boxes are 64 (K) x 128 (M), M-major 64 (M) x 64 (K)
  if (!operand_map(&ma, a, M, K, A_MN, pa, 64, A_MN ? 64 : kBM) ||
      !operand_map(&mb, b, K, N, !B_MN, pb, 64, B_MN ? 64 : BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = gemm_wgmma_kernel<BN, A_MN, B_MN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Tile<BN>::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const int grid = std::min(tiles, hopper_host::sm_count());
  kern<<<grid, kThreads, Tile<BN>::kSmem, s>>>(ma, mb, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Operands TMA can read: unit stride along one axis, the other stride a
// multiple of 8 elements (16 bytes), a 16-byte-aligned base.
bool tma_ok(const void* p, long long s_unit, long long s_other) {
  return s_unit == 1 && s_other > 0 && s_other % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int run(const void* a, const void* b, __nv_bfloat16* c, int M, int N, int K, long long sam,
        long long sak, long long sbk, long long sbn, cudaStream_t s) {
  const bool a_mn = !tma_ok(a, sak, sam);  // K-major unless only M-major fits
  const bool b_mn = tma_ok(b, sbn, sbk);   // the plain [K, N] layout is N-major
  if (K <= 0 || !(a_mn ? tma_ok(a, sam, sak) : true) || !(b_mn || tma_ok(b, sbk, sbn)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pa = a_mn ? sak : sam, pb = b_mn ? sbk : sbn;
  auto pick = [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    if (a_mn) return b_mn ? launch<BN, 1, 1>(a, b, c, M, N, K, pa, pb, s)
                          : launch<BN, 1, 0>(a, b, c, M, N, K, pa, pb, s);
    return b_mn ? launch<BN, 0, 1>(a, b, c, M, N, K, pa, pb, s)
                : launch<BN, 0, 0>(a, b, c, M, N, K, pa, pb, s);
  };
  return N > 128 ? pick(std::integral_constant<int, 256>{})
                 : pick(std::integral_constant<int, 128>{});
}

}  // namespace wg

Operand make_operand(const void* p, long long sr, long long sc, int rows, int cols, int elem) {
  Operand o{p, sr, sc, rows, cols, 2, 0};
  if (sc == 1) {
    o.mode = 0;
  } else if (sr == 1) {
    o.mode = 1;
  }
  const long long other = o.mode == 1 ? sc : sr;
  o.vec = o.mode != 2 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && (other * elem) % 16 == 0;
  return o;
}

}  // namespace

// C[M, N] (contiguous, the operands' dtype) = A[M, K] @ B[K, N], with
// A(m, k) = a[m * sam + k * sak] and B(k, n) = b[k * sbk + n * sbn], by
// route 0 (fma, fp32), 1 (mma, bf16) or 2 (wgmma, bf16 TMA can read).
extern "C" int gather_matmul(int route, const void* a, const void* b, void* c, int M, int N,
                             int K, long long sam, long long sak, long long sbk, long long sbn,
                             void* stream) {
  if (M < 0 || N < 0 || K < 0 || sam < 0 || sak < 0 || sbk < 0 || sbn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = route == 0 ? 4 : 2;
  const Operand oa = make_operand(a, sam, sak, M, K, elem);
  const Operand ob = make_operand(b, sbk, sbn, K, N, elem);
  switch (route) {
    case 0: {
      const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
      if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
      gemm_fma_kernel<<<grid, kThreads, 0, s>>>(oa, ob, static_cast<float*>(c), M, N, K);
      break;
    }
    case 1: {
      const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
      if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
      gemm_mma_kernel<<<grid, kThreads, 0, s>>>(oa, ob, static_cast<__nv_bfloat16*>(c), M, N, K);
      break;
    }
    case 2:
      return wg::run(a, b, static_cast<__nv_bfloat16*>(c), M, N, K, sam, sak, sbk, sbn, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
