// Blocked GEMM of the ZeRO-3 fused gather-matmul MLP, Hopper: C = A @ B.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/gather_matmul.py
// `_matmul_kernel` (:71, launched by `_matmul_impl` at :133).  That kernel
// computes [M, K] @ [K, N] -> [M, N] in 256x256x256 blocks, zero-padding the
// operands to block multiples and carrying an fp32 VMEM accumulator over the
// sequential K grid axis; the result has x's dtype.  Here each thread block
// owns one output tile and walks K itself (blocks run in parallel and in no
// order, so nothing carries over between them), and the ragged edges are
// masked in the loads and the stores instead of padded copies.
//
// Each operand comes with its two element strides, so the backward's
// dx = g @ w^T and dw = x^T @ g read w and x in place (a transposed view has
// unit stride along its rows instead of its columns).  The loads take the
// unit-stride axis: 16-byte vectors along it where the vector is aligned and
// wholly inside the matrix, masked scalars elsewhere; a view with no unit
// stride (an expanded gradient) loads element by element.
//
// Bound: the operations at every shape of the path (gpt2-350m MLP at
// micro 8 x seq 1024: M 8192, K 1024, N 4096 is 68.7 GFLOP, 0.069 ms at
// 989 TFLOP/s bf16, against 0.027 ms for its 92 MB at 3.35 TB/s).  The
// design is the simple one, as the FP6 GEMM of ops/csrc/fp6_linear.cu:
// bf16 operands take tensor cores, one 256-thread block a 128x128 output
// tile, K in 64-deep chunks staged through shared memory, 8 warps each
// owning a 64x32 sub-tile as 4x2 wmma 16x16x16 fragments with fp32
// accumulators; the next chunk's global loads are issued into registers
// before the current chunk's products.  fp32 operands take FMA loops in
// full fp32 (never TF32) over 64x64 tiles, 4x4 outputs a thread.  The
// epilogue rounds the fp32 sums once to the operands' type.  wgmma, TMA and
// a deeper pipeline are later work.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().  dtype codes: 0 fp32, 1 bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
// A(m, k) = a[m * sam + k * sak] and B(k, n) = b[k * sbk + n * sbn].
extern "C" int gather_matmul(int dtype, const void* a, const void* b, void* c, int M, int N,
                             int K, long long sam, long long sak, long long sbk, long long sbn,
                             void* stream) {
  if (M < 0 || N < 0 || K < 0 || sam < 0 || sak < 0 || sbk < 0 || sbn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const Operand oa = make_operand(a, sam, sak, M, K, elem);
  const Operand ob = make_operand(b, sbk, sbn, K, N, elem);
  switch (dtype) {
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
