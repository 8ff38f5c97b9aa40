// Tiled attention for training, Hopper: forward, backward dq, backward dk/dv.
//
// The kernels of flash_attention.cu (dense: causal and sliding-window masks),
// block_sparse_attention.cu (a DeepSpeed block layout) and
// ring_attention.cu (one ring hop: causal/window on global positions given
// by offsets and strides) are the same tile walk; they differ only in which
// tiles a block visits and which (query, key) pairs inside a tile count.  A
// `Mask` policy, passed by value, gives all three:
//   k_begin(h, iq), k_end(h, iq), k_tile(t): the key tiles (t in
//       [k_begin, k_end)) visited by query tile iq of query head h (fwd, dq);
//   q_begin(h, ik), q_end(h, ik), q_tile(t): the query tiles visited by key
//       tile ik for query head h (dk/dv);
//   ok(h, row, col): whether query row `row` sees key `col` (rows and
//       columns at or past S never do).
// Tiles are kTile = 64 rows on both sides.
//
// Accumulate mode (template flag ACC, the ring hops): the walk starts from
// fp32 state in device memory and writes it back, in place, instead of
// starting from zero and writing a finished result.  Forward: (m, l, acc)
// seed the online softmax and are stored unnormalised (no division, no
// lse); dq and dk/dv: the incoming fp32 buffers seed the accumulators and
// receive the sums in fp32.  The arithmetic of a tile is the same in both
// modes, and ACC = false compiles the code it always did.
//
// Arithmetic (the TPU kernels' blocked variants): fp32 scores, an online
// softmax over 64-key tiles (forward), p = exp(s - lse) against the saved
// log-sum-exp (backward), p rounded to v's dtype before p.v and to do's
// before p^T.do, ds rounded to k's dtype for dq and to q's for dk, the -1e30
// mask with p zeroed on masked entries, safe_l = l > 0 ? l : 1.  A query row
// that sees no key ends with acc = 0, so its o is 0 and its lse -1e30.
//
// Design (simple and right first):
//  * 256 threads, one block per (q tile, head, batch) for fwd and dq and per
//    (k tile, KV head, batch) for dk/dv: independent blocks, a loop inside
//    the block in place of the TPU's sequential grid axis.  GQA folds
//    h -> h / group in the index arithmetic; the dk/dv block walks its
//    group's query heads itself (the TPU's static `for g in range(group)`),
//    so it owns its output tile and needs no atomics.
//  * dead tiles are never visited: the policy's loop bounds (dense) or
//    live-tile lists (block-sparse) replace the TPU's clamped index maps.
//  * a sequence tail (S % 64 != 0) is masked in-kernel (cols < S, rows < S);
//    tail rows load as zeros and are never stored: no padding copy.
//  * operands are [B, H, S, D] views with any (b, h, s) strides and a
//    contiguous D, copied to shared memory with 16-byte vector loads.
//  * products: bf16 tiles through the tensor cores (nvcuda::wmma 16x16x16,
//    fp32 accumulation); fp32 tiles (the card-vs-CPU reference) by plain
//    FMA loops.  The forward's o accumulator lives in shared memory in
//    fp32, so the online softmax can rescale it by rows between products;
//    the backward's dq, dk, dv need no rescale and stay in wmma registers
//    for the whole loop (bf16), which also frees the shared memory for two
//    dk/dv blocks per SM at d = 64.
//    No wgmma/TMA/warp specialisation and no cp.async double buffer: those
//    are for the PRs that make it fast.
//
// Each launcher runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // query and key rows per tile (the online softmax step)
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Padded row length, in elements, of a shared tile with n columns: keeps
// rows 16-byte aligned and wmma tile starts 32-byte aligned while shifting
// banks from row to row.
template <typename T> __host__ __device__ constexpr int ld(int n) {
  return n + (sizeof(T) == 2 ? 8 : 4);
}
__host__ __device__ constexpr size_t r128(size_t x) { return (x + 127) / 128 * 128; }

// Bump allocator over dynamic shared memory; every array 128-byte aligned.
struct Smem {
  unsigned char* p;
  template <typename U> __device__ U* take(int n) {
    U* r = reinterpret_cast<U*>(p);
    p += r128(static_cast<size_t>(n) * sizeof(U));
    return r;
  }
};

// dst[r][:] = row (row0 + r) of src for r < ROWS; rows at or past S are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride, int row0,
                                          int S) {
  constexpr int kPerVec = 16 / sizeof(T);
  constexpr int kVecs = D / kPerVec;
  constexpr int LD = ld<T>(D);
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * kPerVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// dst[r][:] (row length ldd) = fp32 row (row0 + r) of src for r < ROWS;
// rows at or past S are zero.  Rows are D contiguous floats, 16-byte aligned.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, int ldd, const float* src,
                                              long long row_stride, int row0, int S) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      val = *reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ldd + c) = val;
  }
}

// C[M x N] (fp32, row-major, ldc) = (acc ? C : 0) + A[M x K] . B[K x N] over
// shared memory.  A_ROW: A(m, k) = A[m * lda + k], else A[k * lda + m];
// B_ROW: B(k, n) = B[k * ldb + n], else B[n * ldb + k].
template <typename T, int M, int N, int K, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void block_gemm(const T* A, int lda, const T* B, int ldb, float* C,
                                           int ldc, bool acc) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using LA = typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
    using LB = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
    constexpr int kTilesN = N / 16;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * kTilesN; t += kWarps) {
      const int m0 = (t / kTilesN) * 16, n0 = (t % kTilesN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (acc)
        wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, A_ROW ? A + m0 * lda + k0 : A + k0 * lda + m0, lda);
        wmma::load_matrix_sync(b, B_ROW ? B + k0 * ldb + n0 : B + n0 * ldb + k0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < M * N; e += kThreads) {
      const int m = e / N, n = e % N;
      float s = acc ? C[m * ldc + n] : 0.f;
      for (int k = 0; k < K; ++k)
        s += to_f(A_ROW ? A[m * lda + k] : A[k * lda + m]) *
             to_f(B_ROW ? B[k * ldb + n] : B[n * ldb + k]);
      C[m * ldc + n] = s;
    }
  }
}

// An [M x N] fp32 accumulator summed over a loop of products.  bf16: warp w
// holds its output tiles (w, w + kWarps, ...) as wmma fragments in
// registers for the whole loop; `stage` writes them to a shared buffer for
// the epilogue.  fp32: the accumulator is a shared buffer and the products
// are the FMA loops of block_gemm.
template <typename T, int M, int N>
struct Acc {
  float* c;  // fp32 path: the accumulator itself; [M x ldc]
  int ldc;
  __device__ Acc(float* c_, int ldc_) : c(c_), ldc(ldc_) {}
  __device__ void zero() {
    for (int i = threadIdx.x; i < M * ldc; i += kThreads) c[i] = 0.f;
  }
  // accumulate mode: start from fp32 rows row0.. of src (0 past S); the
  // staging buffer is not needed, the accumulator is shared memory already
  __device__ void seed(float*, int, const float* src, long long row_stride, int row0, int S) {
    load_rows_f32<N, M>(c, ldc, src, row_stride, row0, S);
  }
  template <int K, bool A_ROW, bool B_ROW>
  __device__ void mma(const T* A, int lda, const T* B, int ldb) {
    block_gemm<T, M, N, K, A_ROW, B_ROW>(A, lda, B, ldb, c, ldc, true);
  }
  __device__ const float* stage(float*, int) const { return c; }
};

template <int M, int N>
struct Acc<bf16, M, N> {
  static constexpr int kTilesN = N / 16;
  static constexpr int kPerWarp = (M / 16) * kTilesN / kWarps;
  static_assert((M / 16) * kTilesN % kWarps == 0, "tiles must split evenly over the warps");
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[kPerWarp];
  __device__ Acc(float*, int) {}
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) nvcuda::wmma::fill_fragment(f[i], 0.f);
  }
  // accumulate mode: fp32 rows row0.. of src (0 past S) through the free
  // shared buffer buf [M x ld] into the fragments; buf is free again on return
  __device__ void seed(float* buf, int ld, const float* src, long long row_stride, int row0,
                       int S) {
    load_rows_f32<N, M>(buf, ld, src, row_stride, row0, S);
    __syncthreads();
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int t = warp + i * kWarps;
      nvcuda::wmma::load_matrix_sync(f[i], buf + (t / kTilesN) * 16 * ld + (t % kTilesN) * 16, ld,
                                     nvcuda::wmma::mem_row_major);
    }
    __syncthreads();
  }
  template <int K, bool A_ROW, bool B_ROW>
  __device__ void mma(const bf16* A, int lda, const bf16* B, int ldb) {
    using namespace nvcuda;
    using LA = typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
    using LB = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int t = warp + i * kWarps;
      const int m0 = (t / kTilesN) * 16, n0 = (t % kTilesN) * 16;
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, A_ROW ? A + m0 * lda + k0 : A + k0 * lda + m0, lda);
        wmma::load_matrix_sync(b, B_ROW ? B + k0 * ldb + n0 : B + n0 * ldb + k0, ldb);
        wmma::mma_sync(f[i], a, b, f[i]);
      }
    }
  }
  // store to buf [M x ld]; the caller syncs before reading it
  __device__ const float* stage(float* buf, int ld) const {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int t = warp + i * kWarps;
      nvcuda::wmma::store_matrix_sync(buf + (t / kTilesN) * 16 * ld + (t % kTilesN) * 16, f[i],
                                      ld, nvcuda::wmma::mem_row_major);
    }
    return buf;
  }
};

template <typename T> constexpr bool kRegAcc = std::is_same<T, bf16>::value;

// Rows row0.. of an accumulator, rounded to out's type T, into out (rows
// past S are not stored); stage: a free shared buffer of [ROWS x ld] fp32.
template <int D, int ROWS, typename A, typename T>
__device__ __forceinline__ void store_acc(const A& acc, float* stage, int ld, T* out,
                                          long long row_stride, int row0, int S) {
  __syncthreads();  // every warp is done with the buffer the stage reuses
  const float* src = acc.stage(stage, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (row0 + r < S) out[static_cast<long long>(row0 + r) * row_stride + c] = from_f<T>(src[r * ld + c]);
  }
}

// lse/delta rows of one q tile into shared memory (0 past S)
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows, int S) {
  for (int r = threadIdx.x; r < rows; r += kThreads) dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T, int D>
struct FwdLayout {
  static constexpr int BQ = kTile, BK = kTile;
  static constexpr int LDT = ld<T>(D), LDS = ld<float>(BK), LDP = ld<T>(BK), LDO = ld<float>(D);
  static constexpr size_t bytes() {
    return r128(BQ * LDT * sizeof(T)) + 2 * r128(BK * LDT * sizeof(T)) +
           r128(BQ * LDS * sizeof(float)) + r128(BQ * LDP * sizeof(T)) +
           r128(BQ * LDO * sizeof(float)) + 3 * r128(BQ * sizeof(float));
  }
};

// ACC: m_io (in lse's slot), l_io [B, Hq, S] and acc_io (strides so, in
// o's) carry the running state in and out; o is not written.
template <typename T, int D, typename Mask, bool ACC = false>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, float* __restrict__ l_io,
                float* __restrict__ acc_io, Strides sq, Strides sk, Strides sv, Strides so,
                int Hq, int Hkv, int S, float scale, Mask mask) {
  using L = FwdLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  const int nq = (S + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = iq * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem sm{smem_raw};
  T* qs = sm.take<T>(BQ * L::LDT);
  T* ks = sm.take<T>(BK * L::LDT);
  T* vs = sm.take<T>(BK * L::LDT);
  float* ss = sm.take<float>(BQ * L::LDS);
  T* ps = sm.take<T>(BQ * L::LDP);
  float* os = sm.take<float>(BQ * L::LDO);
  float* m_s = sm.take<float>(BQ);
  float* l_s = sm.take<float>(BQ);
  float* a_s = sm.take<float>(BQ);

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  load_tile<T, D, BQ>(qs, qb, sq.s, q0, S);
  if constexpr (ACC) {
    const long long row_off = (static_cast<long long>(b) * Hq + h) * S;
    load_rows_f32<D, BQ>(os, L::LDO, acc_io + b * so.b + h * so.h, so.s, q0, S);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      m_s[r] = q0 + r < S ? lse[row_off + q0 + r] : kNegInf;
      l_s[r] = q0 + r < S ? l_io[row_off + q0 + r] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) os[i] = 0.f;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
  }

  const int t_end = mask.k_end(h, iq);
  for (int t = mask.k_begin(h, iq); t < t_end; ++t) {
    const int k0 = mask.k_tile(t) * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, D, BK>(ks, kb, sk.s, k0, S);
    load_tile<T, D, BK>(vs, vb, sv.s, k0, S);
    __syncthreads();
    block_gemm<T, BQ, BK, D, true, false>(qs, L::LDT, ks, L::LDT, ss, L::LDS, false);
    __syncthreads();
    // online softmax, one warp per row, two columns per lane
    for (int r = warp; r < BQ; r += kWarps) {
      const int row = q0 + r;
      float s[BK / 32];
      bool ok[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        // tail rows (row >= S) see no valid key: o = 0, never stored
        ok[j] = mask.ok(h, row, k0 + c);
        s[j] = ok[j] ? ss[r * L::LDS + c] * scale : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
        sum += p;
        ps[r * L::LDP + lane + 32 * j] = from_f<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      os[r * L::LDO + c] *= a_s[r];
    }
    __syncthreads();
    block_gemm<T, BQ, D, BK, true, true>(ps, L::LDP, vs, L::LDT, os, L::LDO, true);
  }
  __syncthreads();

  if constexpr (ACC) {
    const long long row_off = (static_cast<long long>(b) * Hq + h) * S;
    float* ab = acc_io + b * so.b + h * so.h;
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      if (q0 + r < S) ab[static_cast<long long>(q0 + r) * so.s + c] = os[r * L::LDO + c];
    }
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      if (q0 + r < S) {
        lse[row_off + q0 + r] = m_s[r];
        l_io[row_off + q0 + r] = l_s[r];
      }
    }
    return;
  }
  T* ob = o + b * so.b + h * so.h;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < S) {
      const float l = l_s[r];
      ob[static_cast<long long>(q0 + r) * so.s + c] = from_f<T>(os[r * L::LDO + c] / (l > 0.f ? l : 1.f));
    }
  }
  float* lb = lse + (static_cast<long long>(b) * Hq + h) * S;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    if (q0 + r < S) {
      const float l = l_s[r];
      lb[q0 + r] = m_s[r] + logf(l > 0.f ? l : 1.f);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DqLayout {
  static constexpr int BQ = kTile, BK = kTile;
  static constexpr int LDT = ld<T>(D), LDS = ld<float>(BK), LDP = ld<T>(BK), LDO = ld<float>(D);
  // bf16 keeps dq in registers and stages it over the two score buffers
  static constexpr size_t kAccBytes = kRegAcc<T> ? 0 : r128(BQ * LDO * sizeof(float));
  static_assert(!kRegAcc<T> || BQ * LDO * sizeof(float) <= 2 * r128(BQ * LDS * sizeof(float)),
                "dq staging must fit the score buffers");
  static constexpr size_t bytes() {
    return 2 * r128(BQ * LDT * sizeof(T)) + 2 * r128(BK * LDT * sizeof(T)) +
           2 * r128(BQ * LDS * sizeof(float)) + r128(BQ * LDP * sizeof(T)) + kAccBytes +
           2 * r128(BQ * sizeof(float));
  }
};

// ACC: dq is fp32 and carries the running sum in and out.
template <typename T, int D, typename Mask, bool ACC = false>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   typename std::conditional<ACC, float, T>::type* __restrict__ dq, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq, int Hq, int Hkv, int S,
                   float scale, Mask mask) {
  using L = DqLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  const int nq = (S + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = iq * BQ;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem sm{smem_raw};
  T* qs = sm.take<T>(BQ * L::LDT);
  T* dos = sm.take<T>(BQ * L::LDT);
  T* ks = sm.take<T>(BK * L::LDT);
  T* vs = sm.take<T>(BK * L::LDT);
  float* ss = sm.take<float>(BQ * L::LDS);
  float* dps = sm.take<float>(BQ * L::LDS);
  T* dss = sm.take<T>(BQ * L::LDP);
  Acc<T, BQ, D> dq_acc(kRegAcc<T> ? nullptr : sm.take<float>(BQ * L::LDO), L::LDO);
  float* lse_s = sm.take<float>(BQ);
  float* dl_s = sm.take<float>(BQ);

  const long long row_off = (static_cast<long long>(b) * Hq + h) * S;
  load_tile<T, D, BQ>(qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<T, D, BQ>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  load_rows(lse_s, lse + row_off, q0, BQ, S);
  load_rows(dl_s, delta + row_off, q0, BQ, S);
  if constexpr (ACC)
    dq_acc.seed(ss, L::LDO, dq + b * sdq.b + h * sdq.h, sdq.s, q0, S);  // ss is free yet
  else
    dq_acc.zero();
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  const int t_end = mask.k_end(h, iq);
  for (int t = mask.k_begin(h, iq); t < t_end; ++t) {
    const int k0 = mask.k_tile(t) * BK;
    __syncthreads();
    load_tile<T, D, BK>(ks, kb, sk.s, k0, S);
    load_tile<T, D, BK>(vs, vb, sv.s, k0, S);
    __syncthreads();
    block_gemm<T, BQ, BK, D, true, false>(qs, L::LDT, ks, L::LDT, ss, L::LDS, false);
    block_gemm<T, BQ, BK, D, true, false>(dos, L::LDT, vs, L::LDT, dps, L::LDS, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const bool ok = mask.ok(h, q0 + r, k0 + c);
      const float p = ok ? expf(ss[r * L::LDS + c] * scale - lse_s[r]) : 0.f;
      const float ds = p * (dps[r * L::LDS + c] - dl_s[r]) * scale;
      dss[r * L::LDP + c] = from_f<T>(ds);
    }
    __syncthreads();
    dq_acc.template mma<BK, true, true>(dss, L::LDP, ks, L::LDT);
  }
  // the score buffers are free: stage dq over them
  store_acc<D, BQ>(dq_acc, ss, L::LDO, dq + b * sdq.b + h * sdq.h, sdq.s, q0, S);
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DkvLayout {
  // fp32 tiles at d = 128 would overrun shared memory with 64-row q tiles:
  // fp32 walks each 64-row q tile as two 32-row halves
  static constexpr int BQ = sizeof(T) == 4 ? kTile / 2 : kTile, BK = kTile;
  static constexpr int LDT = ld<T>(D), LDS = ld<float>(BK), LDP = ld<T>(BK), LDO = ld<float>(D);
  // bf16 keeps dk, dv in registers and stages each over the score buffers
  static constexpr size_t kAccBytes = kRegAcc<T> ? 0 : 2 * r128(BK * LDO * sizeof(float));
  static_assert(!kRegAcc<T> || BK * LDO * sizeof(float) <= 2 * r128(BQ * LDS * sizeof(float)),
                "dk/dv staging must fit the score buffers");
  static constexpr size_t bytes() {
    return 2 * r128(BK * LDT * sizeof(T)) + kAccBytes + 2 * r128(BQ * LDT * sizeof(T)) +
           2 * r128(BQ * LDS * sizeof(float)) + 2 * r128(BQ * LDP * sizeof(T)) +
           2 * r128(BQ * sizeof(float));
  }
};

// bf16 at d = 64 fits two blocks' shared memory on an SM; ask ptxas for the
// registers to match (<= 128 a thread)
// ACC: dk and dv are fp32 and carry the running sums in and out.
template <typename T, int D, typename Mask, bool ACC = false>
__global__ void __launch_bounds__(kThreads, kRegAcc<T> && D == 64 ? 2 : 1)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    typename std::conditional<ACC, float, T>::type* __restrict__ dk,
                    typename std::conditional<ACC, float, T>::type* __restrict__ dv,
                    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                    int Hq, int Hkv, int S, float scale, Mask mask) {
  using L = DkvLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  const int ik = blockIdx.x;  // low k tiles have the longest causal walks: first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = ik * BK;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem sm{smem_raw};
  T* ks = sm.take<T>(BK * L::LDT);
  T* vs = sm.take<T>(BK * L::LDT);
  Acc<T, BK, D> dk_acc(kRegAcc<T> ? nullptr : sm.take<float>(BK * L::LDO), L::LDO);
  Acc<T, BK, D> dv_acc(kRegAcc<T> ? nullptr : sm.take<float>(BK * L::LDO), L::LDO);
  T* qs = sm.take<T>(BQ * L::LDT);
  T* dos = sm.take<T>(BQ * L::LDT);
  float* ss = sm.take<float>(BQ * L::LDS);
  float* dps = sm.take<float>(BQ * L::LDS);
  T* pts = sm.take<T>(BQ * L::LDP);
  T* dss = sm.take<T>(BQ * L::LDP);
  float* lse_s = sm.take<float>(BQ);
  float* dl_s = sm.take<float>(BQ);

  load_tile<T, D, BK>(ks, k + b * sk.b + hk * sk.h, sk.s, k0, S);
  load_tile<T, D, BK>(vs, v + b * sv.b + hk * sv.h, sv.s, k0, S);
  if constexpr (ACC) {  // the score buffers are free yet: stage through them
    dk_acc.seed(ss, L::LDO, dk + b * sdk.b + hk * sdk.h, sdk.s, k0, S);
    dv_acc.seed(ss, L::LDO, dv + b * sdv.b + hk * sdv.h, sdv.s, k0, S);
  } else {
    dk_acc.zero();
    dv_acc.zero();
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long row_off = (static_cast<long long>(b) * Hq + h) * S;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    const int t_end = mask.q_end(h, ik);
    for (int t = mask.q_begin(h, ik); t < t_end; ++t) {
      const int tile0 = mask.q_tile(t) * kTile;
      const int tile1 = min(tile0 + kTile, S);
      for (int q0 = tile0; q0 < tile1; q0 += BQ) {
        __syncthreads();  // the previous q tile is consumed
        load_tile<T, D, BQ>(qs, qb, sq.s, q0, S);
        load_tile<T, D, BQ>(dos, dob, sdo.s, q0, S);
        load_rows(lse_s, lse + row_off, q0, BQ, S);
        load_rows(dl_s, delta + row_off, q0, BQ, S);
        __syncthreads();
        block_gemm<T, BQ, BK, D, true, false>(qs, L::LDT, ks, L::LDT, ss, L::LDS, false);
        block_gemm<T, BQ, BK, D, true, false>(dos, L::LDT, vs, L::LDT, dps, L::LDS, false);
        __syncthreads();
        for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
          const int r = i / BK, c = i % BK;
          // pad query rows carry lse = 0: the row check kills them
          const bool ok = mask.ok(h, q0 + r, k0 + c);
          const float p = ok ? expf(ss[r * L::LDS + c] * scale - lse_s[r]) : 0.f;
          pts[r * L::LDP + c] = from_f<T>(p);
          dss[r * L::LDP + c] = from_f<T>(p * (dps[r * L::LDS + c] - dl_s[r]) * scale);
        }
        __syncthreads();
        dv_acc.template mma<BQ, false, true>(pts, L::LDP, dos, L::LDT);
        dk_acc.template mma<BQ, false, true>(dss, L::LDP, qs, L::LDT);
      }
    }
  }
  // the score buffers are free: stage dk, then dv, over them
  store_acc<D, BK>(dk_acc, ss, L::LDO, dk + b * sdk.b + hk * sdk.h, sdk.s, k0, S);
  store_acc<D, BK>(dv_acc, ss, L::LDO, dv + b * sdv.b + hk * sdv.h, sdv.s, k0, S);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// The operands of one call.  strides: (b, h, s) of each [B, H, S, D]
// operand in order (q, k, v, then o (acc in accumulate mode) for the
// forward, do and dq for dq, do, dk and dv for dk/dv).  Accumulate mode:
// lse_out is m, l_io is l, dq/dk/dv are fp32.
struct AttnCall {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float *lse_out, *l_io, *acc_io;
  const long long* st;
  int B, Hq, Hkv, S;
  float scale;
  cudaStream_t stream;
  Strides at(int i) const { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }
};

// q, k, v, strides, shape and stream; the caller sets the rest
AttnCall attn_call(const void* q, const void* k, const void* v, const long long* strides,
                   int B, int Hq, int Hkv, int S, float scale, void* stream) {
  AttnCall a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.st = strides;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, typename Mask, bool ACC>
int launch_fwd(const AttnCall& a, Mask mask) {
  using L = FwdLayout<T, D>;
  auto kern = attn_fwd_kernel<T, D, Mask, ACC>;
  cudaError_t e = allow_smem(kern, L::bytes());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.S + L::BQ - 1) / L::BQ, a.Hq, a.B);
  kern<<<grid, kThreads, L::bytes(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse_out, a.l_io, a.acc_io, a.at(0), a.at(1), a.at(2), a.at(3),
      a.Hq, a.Hkv, a.S, a.scale, mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, typename Mask, bool ACC>
int launch_bwd_dq(const AttnCall& a, Mask mask) {
  using L = DqLayout<T, D>;
  using Out = typename std::conditional<ACC, float, T>::type;
  auto kern = attn_bwd_dq_kernel<T, D, Mask, ACC>;
  cudaError_t e = allow_smem(kern, L::bytes());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.S + L::BQ - 1) / L::BQ, a.Hq, a.B);
  kern<<<grid, kThreads, L::bytes(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<Out*>(a.dq), a.at(0),
      a.at(1), a.at(2), a.at(3), a.at(4), a.Hq, a.Hkv, a.S, a.scale, mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, typename Mask, bool ACC>
int launch_bwd_dkv(const AttnCall& a, Mask mask) {
  using L = DkvLayout<T, D>;
  using Out = typename std::conditional<ACC, float, T>::type;
  auto kern = attn_bwd_dkv_kernel<T, D, Mask, ACC>;
  cudaError_t e = allow_smem(kern, L::bytes());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.S + L::BK - 1) / L::BK, a.Hkv, a.B);
  kern<<<grid, kThreads, L::bytes(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<Out*>(a.dk),
      static_cast<Out*>(a.dv), a.at(0), a.at(1), a.at(2), a.at(3), a.at(4), a.at(5), a.Hq, a.Hkv,
      a.S, a.scale, mask);
  return static_cast<int>(cudaGetLastError());
}

enum class Role { kFwd, kBwdDq, kBwdDkv };

template <typename T> struct Tag { using type = T; };

// Check the shape, then launch `role` for dtype code (0 = float32,
// 1 = bfloat16) and head_dim D (64 or 128); ACC: accumulate mode.
template <bool ACC = false, typename Mask>
int launch(Role role, int dtype, int D, const AttnCall& a, Mask mask) {
  if (a.B < 0 || a.S < 0 || a.Hkv <= 0 || a.Hq <= 0 || a.Hq % a.Hkv != 0 ||
      (D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0 || a.S == 0) return 0;
  auto run = [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    switch (role) {
      case Role::kFwd: return launch_fwd<T, kD, Mask, ACC>(a, mask);
      case Role::kBwdDq: return launch_bwd_dq<T, kD, Mask, ACC>(a, mask);
      default: return launch_bwd_dkv<T, kD, Mask, ACC>(a, mask);
    }
  };
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (dtype == 1)
    return D == 64 ? run(Tag<bf16>{}, D64{}) : run(Tag<bf16>{}, D128{});
  return D == 64 ? run(Tag<float>{}, D64{}) : run(Tag<float>{}, D128{});
}

}  // namespace
