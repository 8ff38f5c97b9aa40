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
// interleave along sublanes; here each block decodes its packed bytes into
// a K-major tile in shared memory, so x is read in place.
//
// Bound: the operations at the training path's shapes (M 4096: 481 GFLOP
// for 4096 -> 14336, 0.49 ms at 989 TFLOP/s bf16), the packed bytes at
// decode shapes (M 16: 44 MB of weight, 0.013 ms at 3.35 TB/s).  The
// design is the simple one: one 256-thread block per 128x128 output tile
// walks K in 64-deep chunks; each chunk's x tile is copied and its packed
// bytes decoded (through a 64-entry table in shared memory; e3m2 values are
// exact in bf16 and fp16) into shared memory, and 8 warps, each owning a
// 64x32 sub-tile as 4x2 wmma 16x16x16 fragments, multiply with fp32
// accumulation.  The next chunk's global loads are issued into registers
// before the current chunk's products, so loads overlap the tensor cores.
// The epilogue multiplies by the column scale in fp32 and rounds once to x's
// type.  fp32 x takes FMA loops over 64x64 tiles (4x4 outputs a thread).
// Tails in M, N and K are masked: rows past M and codes past N or K read as
// zero and are never stored.  Split-K for decode-sized M, cp.async/TMA and
// wgmma are later work.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().  dtype codes: 0 fp32, 1 bf16, 2 fp16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

}  // namespace

// x [M, K] (dtype), packed uint8 [3, K/4, N], scale fp32 [N] -> out [M, N] (dtype)
extern "C" int fp6_matmul(int dtype, const void* x, const void* packed, const void* scale,
                          void* out, int M, int N, int K, void* stream) {
  if (M < 0 || N < 0 || K < 0 || K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const Fp6Args a{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scale), out, M,
                  N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((M + kFM - 1) / kFM > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  switch (dtype) {
    case 0: {
      const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
      fp6_fma_kernel<<<grid, kThreads, 0, s>>>(a);
      break;
    }
    case 1:
    case 2: {
      const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
      if (dtype == 1) {
        fp6_mma_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
      } else {
        fp6_mma_kernel<__half><<<grid, kThreads, 0, s>>>(a);
      }
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
