// FP6 (e3m2) packed-weight GEMM, Hopper: out = x @ W with W stored as 6-bit codes.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fp6_linear.py `_mm_kernel`
// (:132, launched by `fp6_matmul` at :206).  It computes
//   out[m, n] = cast_T(scale[n] * sum_k x[m, k] * decode(code[k, n]))
// with fp32 accumulation, where code[4r + p, n] is unpacked from the three
// byte planes packed[0..2, r, n] (ops/fp6_linear.py `fp6_quantize`):
//   B0 = v0<<2 | v1>>4;  B1 = (v1&15)<<4 | v2>>2;  B2 = (v2&3)<<6 | v3.
// That is the Pallas kernel's function, not its plane-split layout: the
// TPU kernel pre-splits x into 4 K-strided planes because its tiles cannot
// interleave along sublanes; here the packed bytes are decoded into a
// K-by-N tile in shared memory, so x is read in place.
//
// Bound: the operations at the training path's shapes (M 4096: 481 GFLOP
// for 4096 -> 14336, 0.49 ms at 989 TFLOP/s bf16), the packed bytes at
// decode shapes (M 16: 44 MB of weight, 0.013 ms at 3.35 TB/s).
//
// Three routes, chosen by the caller before the launch (ops/fp6_linear.py
// `route`):
//  * wgmma (bf16 x, K % 8 == 0, N % 16 == 0, 16-byte-aligned x and
//    packed): a persistent kernel, one block per SM walking output tiles of
//    256 x 128, grouped 8 tiles down M so that neighbouring tiles share a
//    packed panel in L2.  One producer thread keeps TMA loads of 64-deep
//    chunks in flight through a ring of 4 stages, each behind its own
//    mbarrier: x through a 2-D bf16 tensor map (128-byte swizzle, the
//    K-major A operand of wgmma as it lands) and the chunk's 16 packed rows
//    of all three planes through one 3-D uint8 tensor map over
//    [3, K/4, N].  TMA's zero fill gives the tails: rows past M, columns
//    past K, and packed rows past K/4, whose zero bytes decode to +0.  The
//    two consumer warpgroups (128 output rows each, as two m64n128 wgmma
//    products sharing each k16 step's B) decode every chunk's packed bytes
//    into a bf16 tile of 64 K rows x 128 columns laid out exactly as TMA
//    lays out an MN-major operand with 128-byte swizzle, so wgmma reads it
//    through the same descriptor as a TMA-loaded one (transpose bit set).
//    The decode is word arithmetic, not table lookups: a thread takes one
//    packed row and 8 columns (three 8-byte loads), spreads each column
//    pair's bytes into the two halves of a word, and places each code's
//    sign, exponent and mantissa bits into bf16's sign, low exponent and
//    high mantissa bits; one bf16x2 multiply by 2^124 then gives the exact
//    e3m2 value (the four subnormal codes included), and each K row of 8
//    columns leaves as one conflict-free 16-byte store.  Decode runs K * N
//    * ceil(M / 256) times, so the tile is tall (256 x 128 rather than
//    128 x 256: each code is decoded half as often, for the same 128
//    accumulator registers a thread).  Three decoded tiles rotate: chunk
//    c + 1 is decoded while chunk c's wgmma runs, every thread fences its
//    stores to the async proxy (fence.proxy.async) and one named barrier
//    over the consumers a chunk publishes the tile; the third buffer lets
//    that one barrier also guarantee that both warpgroups have finished
//    the products that last read the buffer being overwritten.  The
//    epilogue loads each column's scale once a tile, computes
//    __fmul_rn(sum, scale), rounds once to bf16 and stores whole 128-byte
//    row segments through a padded staging tile.  What the decode costs is
//    shared-memory bandwidth, not arithmetic: a 64-deep chunk of a plain
//    GEMM moves about 134 KB through shared memory (wgmma's operand reads
//    and the TMA writes), and the decode's packed loads and decoded stores
//    add 22 KB to it.  Swap-AB (out^T = W^T x^T with the decoded W^T as a
//    register operand) would drop the decoded tile, but the plane layout
//    makes each thread gather bytes from rows 128 bytes apart (bank
//    conflicts); it stays later work, as does split-K for decode-sized M.
//  * mma (fp16 x, and bf16 that the wgmma route does not take): one
//    256-thread block per 128x128 output tile walks K in 64-deep chunks;
//    each chunk's x tile is copied and its packed bytes decoded (through a
//    64-entry table in shared memory; e3m2 values are exact in bf16 and
//    fp16) into shared memory, and 8 warps, each owning a 64x32 sub-tile
//    as 4x2 wmma 16x16x16 fragments, multiply with fp32 accumulation.  The
//    next chunk's global loads are issued into registers before the
//    current chunk's products.  Tails in M, N and K are masked.
//  * fma (fp32 x, the card-vs-CPU reference): FMA loops over 64x64 tiles
//    (4x4 outputs a thread).
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for operands the route does
// not take, or a tensor map cuTensorMapEncodeTiled refuses).  Route codes:
// 0 fma, 1 mma, 2 wgmma; dtype codes: 0 fp32, 1 bf16, 2 fp16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

// ---- tensor-core path (bf16 / fp16 x) ----------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 64;  // output tile, K chunk
constexpr int kThreads = 256;                  // 8 warps: 2 (M) x 4 (N)
constexpr int kWarpM = 64, kWarpN = 32;        // a warp's sub-tile
constexpr int kLdA = kBK + 8;                  // smem row pitches (elements), 16-byte multiples
constexpr int kLdB = kBN + 8;
constexpr int kAVecs = kBM * kBK / 8 / kThreads;        // 16-byte x vectors a thread: 4
constexpr int kBItems = (kBK / 4) * (kBN / 4) / kThreads;  // (packed row, 4 columns) a thread: 2

__device__ __forceinline__ float decode_e3m2(int v) {
  const int e = (v >> 2) & 7;
  const float m = static_cast<float>(v & 3);
  const float mag = e == 0 ? m * 0.0625f : ldexpf(1.f + 0.25f * m, e - 3);  // exact
  return (v >> 5) ? -mag : mag;
}

template <typename T> __device__ __forceinline__ T from_float(float f);
template <> __device__ __forceinline__ __nv_bfloat16 from_float(float f) { return __float2bfloat16_rn(f); }
template <> __device__ __forceinline__ __half from_float(float f) { return __float2half_rn(f); }

struct Fp6Args {
  const void* x;
  const uint8_t* packed;
  const float* scale;
  void* out;
  int M, N, K;
};

// the bytes packed[p, r, n .. n+3] of the three planes, one word a plane,
// zero outside the matrix; `wide`: N % 4 == 0, so the 4 bytes load as one word
__device__ __forceinline__ void load_codes(const Fp6Args& a, int r, int n, bool wide,
                                           uint32_t (&w)[3]) {
  const int k4 = a.K / 4;
  const long long plane = static_cast<long long>(k4) * a.N;
#pragma unroll
  for (int p = 0; p < 3; ++p) w[p] = 0;
  if (r >= k4) return;
  const uint8_t* row = a.packed + static_cast<long long>(r) * a.N + n;
  if (wide && n + 4 <= a.N) {
#pragma unroll
    for (int p = 0; p < 3; ++p) w[p] = *reinterpret_cast<const uint32_t*>(row + p * plane);
  } else {
#pragma unroll
    for (int p = 0; p < 3; ++p)
      for (int c = 0; c < 4; ++c)
        if (n + c < a.N) w[p] |= static_cast<uint32_t>(row[p * plane + c]) << (8 * c);
  }
}

// the 4 codes v0..v3 (k rows 4r .. 4r+3) of column byte c of the planes
__device__ __forceinline__ void unpack4(const uint32_t (&w)[3], int c, int (&v)[4]) {
  const int b0 = (w[0] >> (8 * c)) & 255, b1 = (w[1] >> (8 * c)) & 255,
            b2 = (w[2] >> (8 * c)) & 255;
  v[0] = b0 >> 2;
  v[1] = ((b0 & 3) << 4) | (b1 >> 4);
  v[2] = ((b1 & 15) << 2) | (b2 >> 6);
  v[3] = b2 & 63;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fp6_mma_kernel(Fp6Args a) {
  __shared__ __align__(128) T As[kBM * kLdA];
  __shared__ __align__(128) T Bs[kBK * kLdB];
  __shared__ __align__(128) float scratch[kThreads / 32][16 * 16];
  __shared__ T table[64];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* x = static_cast<const T*>(a.x);
  if (tid < 64) table[tid] = from_float<T>(decode_e3m2(tid));

  const bool x_vec = (a.K % 8 == 0) && (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
  const bool wide = (a.N % 4 == 0) && (reinterpret_cast<uintptr_t>(a.packed) % 4 == 0);

  uint4 xa[kAVecs];
  uint32_t wb[kBItems][3];

  // global -> registers for the chunk starting at k0
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int lin = tid + kThreads * i, row = lin / (kBK / 8), col = (lin % (kBK / 8)) * 8;
      const int gm = m0 + row, gk = k0 + col;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < a.M) {
        const T* src = x + static_cast<long long>(gm) * a.K + gk;
        if (x_vec && gk + 8 <= a.K) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) T e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = gk + j < a.K ? src[j] : from_float<T>(0.f);
          v = *reinterpret_cast<uint4*>(e);
        }
      }
      xa[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kBItems; ++i) {
      const int lin = tid + kThreads * i, r = lin / (kBN / 4), c4 = (lin % (kBN / 4)) * 4;
      load_codes(a, k0 / 4 + r, n0 + c4, wide, wb[i]);
    }
  };
  // registers -> shared memory (the packed codes decoded)
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int lin = tid + kThreads * i, row = lin / (kBK / 8), col = (lin % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + row * kLdA + col) = xa[i];
    }
#pragma unroll
    for (int i = 0; i < kBItems; ++i) {
      const int lin = tid + kThreads * i, r = lin / (kBN / 4), c4 = (lin % (kBN / 4)) * 4;
      __align__(16) T vals[4][4];  // [k row within the 4][column]
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int v[4];
        unpack4(wb[i], c, v);
#pragma unroll
        for (int p = 0; p < 4; ++p) vals[p][c] = table[v[p]];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
        *reinterpret_cast<uint2*>(Bs + (4 * r + p) * kLdB + c4) = *reinterpret_cast<uint2*>(vals[p]);
    }
  };

  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kWarpM / 16][kWarpN / 16];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  __syncthreads();  // the decode table
  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    stage();
    __syncthreads();
    if (k0 + kBK < a.K) fetch(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[kWarpM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[kWarpN / 16];
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

  // epilogue: per fragment through the warp's scratch, scale, round, store
  T* out = static_cast<T*>(a.out);
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
      if (gm < a.M) {
        T* dst = out + static_cast<long long>(gm) * a.N;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int gn = gn0 + c;
          if (gn < a.N) dst[gn] = from_float<T>(__fmul_rn(sc[r * 16 + c0 + c], a.scale[gn]));
        }
      }
      __syncwarp();
    }
  }
}

// ---- fp32 path ----------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;  // tile and K chunk; 256 threads, 4x4 outputs each

__global__ void __launch_bounds__(kThreads)
fp6_fma_kernel(Fp6Args a) {
  __shared__ float As[kFK][kFM + 4];  // K-major: As[k][m]
  __shared__ float Bs[kFK][kFN + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const float* x = static_cast<const float*>(a.x);
  const int k4 = a.K / 4;
  const long long plane = static_cast<long long>(k4) * a.N;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.K; k0 += kFK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFM * kFK / kThreads; ++i) {
      const int lin = tid + kThreads * i, row = lin / kFK, col = lin % kFK;
      const int gm = m0 + row, gk = k0 + col;
      As[col][row] = (gm < a.M && gk < a.K) ? x[static_cast<long long>(gm) * a.K + gk] : 0.f;
    }
    {  // one (packed row, column) per thread: 4 k rows of one column
      const int r = tid / kFN, col = tid % kFN;
      const int gr = k0 / 4 + r, gn = n0 + col;
      int b[3] = {0, 0, 0};
      if (gr < k4 && gn < a.N) {
        const uint8_t* src = a.packed + static_cast<long long>(gr) * a.N + gn;
        b[0] = src[0];
        b[1] = src[plane];
        b[2] = src[2 * plane];
      }
      const int v[4] = {b[0] >> 2, ((b[0] & 3) << 4) | (b[1] >> 4), ((b[1] & 15) << 2) | (b[2] >> 6),
                        b[2] & 63};
#pragma unroll
      for (int p = 0; p < 4; ++p) Bs[4 * r + p][col] = (gr < k4 && gn < a.N) ? decode_e3m2(v[p]) : 0.f;
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
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < a.N) out[static_cast<long long>(gm) * a.N + gn] = __fmul_rn(acc[i][j], a.scale[gn]);
    }
  }
}

// ---- wgmma path (bf16 x that TMA can read) ------------------------------
namespace wg {

constexpr int kBM = 256, kBN = 128, kBK = 64;  // output tile, K chunk
constexpr int kConsumers = 2;                  // warpgroups of 128 output rows
constexpr int kThreads = 128 * (kConsumers + 1);  // the consumers, then the producer
constexpr int kStages = 4;                     // chunks in flight
constexpr int kDecBufs = 3;                    // decoded B tiles
constexpr int kGroupM = 8;                     // tiles walked down M before stepping along N
constexpr int kABytes = kBM * kBK * 2;         // 32 KB: 256 rows x 128 bytes
constexpr int kPRows = kBK / 4;                // packed rows a chunk: 16
constexpr int kPlane = kPRows * kBN;           // 2 KB: one plane's bytes of a chunk
constexpr int kPBytes = 3 * kPlane;            // 6 KB
constexpr int kStageBytes = kABytes + kPBytes;  // 38 KB, a multiple of 1024
constexpr uint32_t kBox = 64 * 64 * 2;         // 64 K rows x 64 columns of the decoded tile
constexpr int kDecBytes = kBK * kBN * 2;       // 16 KB: two boxes
constexpr uint32_t kAtomRows = 1024;           // bytes of 8 swizzled 128-byte rows (SBO)
constexpr int kEpiPitch = 72;                  // bf16 a staged output row: 64 + 8 spreads the banks
constexpr int kEpiBytes = 64 * kEpiPitch * 2;  // one consumer's 64 x 64 output chunk
// 1024 to align; the ring; the decoded tiles; the staging tiles; the barriers
constexpr size_t kSmem = 1024 + kStages * kStageBytes + kDecBufs * kDecBytes +
                         kConsumers * kEpiBytes + 2 * kStages * sizeof(uint64_t);
static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
static_assert(kSmem <= 232448, "fits a block's shared memory");

// e3m2 codes in the low 6 bits of each 16-bit half -> their bf16 values:
// sign to bit 15, exponent and mantissa to bits 9..5 (bf16's low exponent
// and high mantissa bits), then times 2^124 (bias 127 -> 3), exact for
// every code, the subnormal ones (exponent 0) included
__device__ __forceinline__ uint32_t e3m2_bf16x2(uint32_t v) {
  const uint32_t bits = ((v & 0x00200020u) << 10) | ((v & 0x001F001Fu) << 5);
  const uint32_t two124 = 0x7D807D80u;  // 2^124 in both bf16 halves
  const __nv_bfloat162 y = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                   *reinterpret_cast<const __nv_bfloat162*>(&two124));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// One packed row of 4 columns (b_p: the 4 bytes of plane p) -> the bf16
// pairs of columns (0, 1) and (2, 3) of its 4 K rows: o[i][h], i the K row
// within the 4, h the column pair
__device__ __forceinline__ void decode4(uint32_t b0, uint32_t b1, uint32_t b2,
                                        uint32_t (&o)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // byte 2h to bits 0..7 and byte 2h + 1 to bits 16..23
    const uint32_t sel = h == 0 ? 0x4140u : 0x4342u;
    const uint32_t x0 = __byte_perm(b0, 0, sel), x1 = __byte_perm(b1, 0, sel),
                   x2 = __byte_perm(b2, 0, sel);
    o[0][h] = e3m2_bf16x2((x0 >> 2) & 0x003F003Fu);
    o[1][h] = e3m2_bf16x2(((x0 & 0x00030003u) << 4) | ((x1 >> 4) & 0x000F000Fu));
    o[2][h] = e3m2_bf16x2(((x1 & 0x000F000Fu) << 2) | ((x2 >> 6) & 0x00030003u));
    o[3][h] = e3m2_bf16x2(x2 & 0x003F003Fu);
  }
}

// A chunk's packed bytes (planes [3][16][128] at shared address p) -> its
// decoded bf16 tile at shared address d (64 K rows x 128 columns, two
// 64-column boxes of 64 rows x 128 bytes, 16-byte chunk c of row k at
// chunk c ^ (k % 8)).  Thread u of the 256 consumers decodes packed row
// u / 16, columns 8 (u % 16) .. + 7.
__device__ __forceinline__ void decode_chunk(uint32_t p, uint32_t d, int u) {
  const int r = u / 16, cg = u % 16;
  const uint32_t src = p + r * kBN + 8 * cg;
  const uint2 w0 = hopper::lds_v2(src), w1 = hopper::lds_v2(src + kPlane),
              w2 = hopper::lds_v2(src + 2 * kPlane);
  uint32_t lo[4][2], hi[4][2];
  decode4(w0.x, w1.x, w2.x, lo);
  decode4(w0.y, w1.y, w2.y, hi);
  const uint32_t box = d + (cg / 8) * kBox;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * r + i;
    hopper::sts_v4(box + k * 128 + (((cg % 8) ^ (k % 8)) * 16),
                   make_uint4(lo[i][0], lo[i][1], hi[i][0], hi[i][1]));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fp6_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_p, const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned by an offset from smem_raw, so accesses stay shared ones
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* dec = ring + kStages * kStageBytes;
  unsigned char* staging = dec + kDecBufs * kDecBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * kEpiBytes);
  uint64_t* empty = full + kStages;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int ntm = (M + kBM - 1) / kBM, ntn = (N + kBN - 1) / kBN, ntiles = ntm * ntn;
  const int nk = (K + kBK - 1) / kBK;
  if (wgi == kConsumers) {
    // producer: one thread issues every load; the warpgroup gives its registers away
    reg_dealloc<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int m0, n0;
        grouped_tile(t, ntm, ntn, kGroupM, kBM, kBN, m0, n0);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(a, &map_x, &full[stage], kc * kBK, m0);
          tma_load_3d(a + kABytes, &map_p, &full[stage], n0, kc * kPRows, 0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wgi: rows 128 wgi .. 128 wgi + 127 of every tile,
  // as two m64 products; chunks are numbered across this block's tiles
  reg_alloc<232>();
  const int w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(staging + wgi * kEpiBytes);
  const int total = (ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * nk;
  // decode chunk c of the stream once its stage has landed
  auto decode = [&](int c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    decode_chunk(smem_addr(ring + s * kStageBytes + kABytes),
                 smem_addr(dec + (c % kDecBufs) * kDecBytes), threadIdx.x);
    fence_proxy_async();
  };
  if (total > 0) decode(0);
  named_sync(1, kConsumers * 128);

  float acc[2][kBN / 2];
  int c = 0, prev = -1;  // c: the chunk's number in this block's stream
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int m0, n0;
    grouped_tile(t, ntm, ntn, kGroupM, kBM, kBN, m0, n0);
    for (int kc = 0; kc < nk; ++kc, ++c) {
      const int s = c % kStages;
      const uint32_t a = smem_addr(ring + s * kStageBytes) + wgi * 16384;
      const uint32_t b = smem_addr(dec + (c % kDecBufs) * kDecBytes);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
      // a tile's first product overwrites the sums (scale-d 0)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = desc_sw128(b + kk * 2048, kBox, kAtomRows);
        const int keep = kc > 0 || kk > 0;
        wgmma_ss_n128<0, 1>(acc[0], desc_sw128(a + kk * 32, 16, kAtomRows), db, keep);
        wgmma_ss_n128<0, 1>(acc[1], desc_sw128(a + 8192 + kk * 32, 16, kAtomRows), db, keep);
      }
      wgmma_commit();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_wait<1>();  // the previous chunk's products are done: free its stage
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (c + 1 < total) decode(c + 1);  // while this chunk's products run
      named_sync(1, kConsumers * 128);   // chunk c + 1's tile is written and fenced
    }

    // the tile's products are done: epilogue
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    mbar_arrive(&empty[prev]);
    prev = -1;
#pragma unroll
    for (int cc = 0; cc < kBN / 64; ++cc) {
      float2 sc[8];  // each column's scale once a tile
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = n0 + 64 * cc + 8 * jj + 2 * tq;
        sc[jj] = col < N ? *reinterpret_cast<const float2*>(scale + col) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int ms = 0; ms < 2; ++ms) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * cc + jj;
          __nv_bfloat16* e = epi + (w * 16 + g) * kEpiPitch + 8 * jj + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(e) =
              __floats2bfloat162_rn(__fmul_rn(acc[ms][4 * j], sc[jj].x),
                                    __fmul_rn(acc[ms][4 * j + 1], sc[jj].y));
          *reinterpret_cast<__nv_bfloat162*>(e + 8 * kEpiPitch) =
              __floats2bfloat162_rn(__fmul_rn(acc[ms][4 * j + 2], sc[jj].x),
                                    __fmul_rn(acc[ms][4 * j + 3], sc[jj].y));
        }
        named_sync(2 + wgi, 128);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // 64 rows x 8 vectors of 8 columns
          const int v = tid + 128 * i, r = v / 8, cv = (v % 8) * 8;
          const int row = m0 + wgi * 128 + ms * 64 + r, col = n0 + 64 * cc + cv;
          if (row < M && col < N)  // N % 16 == 0: a vector is inside or outside whole
            *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * N + col) =
                *reinterpret_cast<const uint4*>(epi + r * kEpiPitch + cv);
        }
        named_sync(2 + wgi, 128);
      }
    }
  }
}

// x [M, K] bf16 contiguous, packed uint8 [3, K/4, N] contiguous
int run(const void* x, const void* packed, const float* scale, __nv_bfloat16* out, int M, int N,
        int K, cudaStream_t s) {
  if (K <= 0 || K % 8 != 0 || N % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mp;
  const uint64_t xd[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t xs[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t xb[2] = {static_cast<uint32_t>(kBK), static_cast<uint32_t>(kBM)};
  const uint64_t pd[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K / 4), 3};
  const uint64_t ps[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K / 4) * N};
  const uint32_t pb[3] = {static_cast<uint32_t>(kBN), static_cast<uint32_t>(kPRows), 3};
  if (!hopper_host::encode_bf16(&mx, x, 2, xd, xs, xb) ||
      !hopper_host::encode_u8(&mp, packed, 3, pd, ps, pb))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(fp6_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = std::min(tiles, hopper_host::sm_count());
  fp6_wgmma_kernel<<<grid, kThreads, kSmem, s>>>(mx, mp, scale, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// x [M, K] (dtype), packed uint8 [3, K/4, N], scale fp32 [N] -> out [M, N]
// (dtype), by route 0 (fma: fp32), 1 (mma: bf16 or fp16) or 2 (wgmma: bf16
// that TMA can read)
extern "C" int fp6_matmul(int route, int dtype, const void* x, const void* packed,
                          const void* scale, void* out, int M, int N, int K, void* stream) {
  if (M < 0 || N < 0 || K < 0 || K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool dtype_ok = route == 0 ? dtype == 0 : route == 1 ? (dtype == 1 || dtype == 2)
                                                 : route == 2 && dtype == 1;
  if (!dtype_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const Fp6Args a{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scale), out, M,
                  N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0: {
      const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
      if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
      fp6_fma_kernel<<<grid, kThreads, 0, s>>>(a);
      break;
    }
    case 1: {
      const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
      if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
      if (dtype == 1) {
        fp6_mma_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
      } else {
        fp6_mma_kernel<__half><<<grid, kThreads, 0, s>>>(a);
      }
      break;
    }
    default:
      return wg::run(x, packed, static_cast<const float*>(scale),
                     static_cast<__nv_bfloat16*>(out), M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
