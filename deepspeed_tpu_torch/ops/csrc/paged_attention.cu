// Paged (block-table) GQA attention for the ragged serving forward, Hopper.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py
// `paged_decode_attention` (bodies `_kernel`, bf16/fp32 pages, and
// `_kernel_quant`, int8 pages with one fp32 scale per (head, row)).
//
// What it computes: for each query token t and KV head h, the `group`
// query heads of h attend over the token's pages j in [j_lo, pos/bs]
// (j_lo > 0 only under a sliding window) through the block table
// pages[t, j], with an online softmax of q.k^T*scale masked by
// c <= pos && c < ctx_len && pos - c < window.  Masked scores are -1e30,
// not -inf, so a row with every key masked (padding tokens only) averages
// its page instead of producing NaN, exactly as the TPU kernel does.
//
// Bound: bytes.  Every live K/V page row is read once per (token, head);
// the arithmetic is 4*group*d flops per key, far below the ~295 flop/byte
// the H100 needs before its tensor cores bind.  The least time is the live
// K/V bytes (plus q, out and the tables) over 3.35 TB/s.
//
// Design (simple and right first):
//  * grid (T, nkv), 128 threads: one block per (token, KV head), as the TPU
//    grid; blocks are independent, so the TPU's sequential grid needs no
//    rework.  A decode step of 32 tokens on llama3-8b is 256 blocks.
//  * the block loads its own page ids (no scalar prefetch on a GPU); a
//    page's K and V rows [bs, d] are one contiguous run in the [nkv, P, d]
//    layout, copied to shared memory with 16-byte vector loads.  Latency is
//    hidden by occupancy (about 12 KB of shared memory a block), not by a
//    cp.async double buffer: that is for the PR that makes it fast.
//  * scores: each warp takes page rows; its lanes split d, so the K row is
//    read conflict-free and reduced with shuffles.  m, l, acc are fp32; acc
//    lives in registers (group*d <= 1024 over 128 threads).
//  * rounding points follow the TPU kernel: fp32 scores, probabilities cast
//    to the page dtype before p.v (bf16 body), and in the int8 body the k
//    scale multiplies score columns and the v scale multiplies the fp32
//    probabilities before p.v.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAccPerThread = 8;  // group * d <= 1024
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy `bytes` (a multiple of 16, 16-byte aligned) from global to shared.
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

// TQ: query/output type; TKV: page type; QUANT: int8 pages with scales.
template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ pages, const int* __restrict__ token_pos,
                       const int* __restrict__ token_ctx_len, TQ* __restrict__ out,
                       int nh, int nkv, int p_rows, int nb, int d, int bs,
                       float sm_scale, int window) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nh / nkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // shared layout: k, v pages first (16-byte aligned), then fp32 arrays
  extern __shared__ __align__(16) unsigned char smem[];
  const int page_bytes = bs * d * static_cast<int>(sizeof(TKV));
  TKV* k_s = reinterpret_cast<TKV*>(smem);
  TKV* v_s = reinterpret_cast<TKV*>(smem + page_bytes);
  float* q_s = reinterpret_cast<float*>(smem + 2 * page_bytes);  // [group, d]
  float* s_s = q_s + group * d;                                   // [group, bs]
  float* m_s = s_s + group * bs;                                  // [group]
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;
  float* ks_s = alpha_s + group;                                  // [bs]
  float* vs_s = ks_s + bs;

  const int pos = token_pos[t];
  const int clen = token_ctx_len[t];
  int j_lo = 0;
  if (window > 0) j_lo = max((pos - (window - 1)) / bs, 0);  // <0 clamps
  const int j_hi = min(pos / bs + 1, nb);

  const TQ* q_t = q + (static_cast<int64_t>(t) * nh + h * group) * d;
  for (int i = threadIdx.x; i < group * d; i += blockDim.x) q_s[i] = to_f(q_t[i]);
  for (int g = threadIdx.x; g < group; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAccPerThread];
#pragma unroll
  for (int k = 0; k < kMaxAccPerThread; ++k) acc[k] = 0.f;

  const int64_t head_off = static_cast<int64_t>(h) * p_rows;
  for (int j = j_lo; j < j_hi; ++j) {
    const int64_t row0 = head_off + static_cast<int64_t>(pages[t * nb + j]) * bs;
    __syncthreads();  // previous page fully consumed
    copy16(k_s, k_pages + row0 * d, page_bytes);
    copy16(v_s, v_pages + row0 * d, page_bytes);
    if constexpr (QUANT) {
      for (int r = threadIdx.x; r < bs; r += blockDim.x) {
        ks_s[r] = k_scales[row0 + r];
        vs_s[r] = v_scales[row0 + r];
      }
    }
    __syncthreads();

    // scores s[g, r] = (q_g . k_r) * scale (* k scale), masked
    for (int r = warp; r < bs; r += kWarps) {
      const int c = j * bs + r;
      const bool valid = c <= pos && c < clen && (window <= 0 || pos - c < window);
      float col = sm_scale;
      if constexpr (QUANT) col = sm_scale * ks_s[r];
      for (int g = 0; g < group; ++g) {
        float part = 0.f;
        for (int i = lane; i < d; i += 32) part += q_s[g * d + i] * to_f(k_s[r * d + i]);
        part = warp_sum(part);
        if (lane == 0) s_s[g * bs + r] = valid ? part * col : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics, one thread per query head of the group
    for (int g = threadIdx.x; g < group; g += blockDim.x) {
      const float m_prev = m_s[g];
      float m_cur = kNegInf;
      for (int r = 0; r < bs; ++r) m_cur = fmaxf(m_cur, s_s[g * bs + r]);
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int r = 0; r < bs; ++r) {
        const float p = expf(s_s[g * bs + r] - m_new);
        sum += p;
        // the value p.v multiplies: v-scaled (int8) or rounded to the page
        // dtype (the TPU kernel's p.astype(v.dtype))
        if constexpr (QUANT) {
          s_s[g * bs + r] = p * vs_s[r];
        } else {
          s_s[g * bs + r] = to_f(from_f<TKV>(p));
        }
      }
      l_s[g] = l_s[g] * alpha + sum;
      alpha_s[g] = alpha;
      m_s[g] = m_new;
    }
    __syncthreads();

    // acc[g, i] = acc * alpha + sum_r p[g, r] * v[r, i]
#pragma unroll
    for (int k = 0; k < kMaxAccPerThread; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < group * d) {
        const int g = e / d, i = e % d;
        float pv = 0.f;
        for (int r = 0; r < bs; ++r) pv += s_s[g * bs + r] * to_f(v_s[r * d + i]);
        acc[k] = acc[k] * alpha_s[g] + pv;
      }
    }
  }
  __syncthreads();

  TQ* o_t = out + (static_cast<int64_t>(t) * nh + h * group) * d;
#pragma unroll
  for (int k = 0; k < kMaxAccPerThread; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < group * d) {
      const float l = l_s[e / d];
      o_t[e] = from_f<TQ>(acc[k] / (l > 0.f ? l : 1.f));
    }
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* pages, const int* pos, const int* clen,
           void* out, int t, int nh, int nkv, int p_rows, int nb, int d, int bs,
           float sm_scale, int window, cudaStream_t stream) {
  const int group = nh / nkv;
  const size_t smem = 2 * static_cast<size_t>(bs) * d * sizeof(TKV) +
                      sizeof(float) * (static_cast<size_t>(group) * d +
                                       static_cast<size_t>(group) * bs + 3 * group + 2 * bs);
  auto kern = paged_attention_kernel<TQ, TKV, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (t == 0) return 0;
  dim3 grid(t, nkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks, vs,
      pages, pos, clen, static_cast<TQ*>(out), nh, nkv, p_rows, nb, d, bs, sm_scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int paged_attention_fwd(int q_dtype, int kv_dtype, const void* q, const void* k_pages,
                                   const void* v_pages, const int* pages, const int* token_pos,
                                   const int* token_ctx_len, void* out, int t, int nh, int nkv,
                                   int p_rows, int nb, int d, int bs, float sm_scale, int window,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k_pages, v_pages, nullptr, nullptr,
                                                       pages, token_pos, token_ctx_len, out, t,
                                                       nh, nkv, p_rows, nb, d, bs, sm_scale,
                                                       window, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16, false>(q, k_pages, v_pages, nullptr, nullptr, pages,
                                               token_pos, token_ctx_len, out, t, nh, nkv, p_rows,
                                               nb, d, bs, sm_scale, window, s);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k_pages, v_pages, nullptr, nullptr, pages, token_pos,
                                       token_ctx_len, out, t, nh, nkv, p_rows, nb, d, bs,
                                       sm_scale, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int paged_attention_int8_fwd(int q_dtype, const void* q, const void* k_pages,
                                        const void* v_pages, const float* k_scales,
                                        const float* v_scales, const int* pages,
                                        const int* token_pos, const int* token_ctx_len, void* out,
                                        int t, int nh, int nkv, int p_rows, int nb, int d, int bs,
                                        float sm_scale, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, pages,
                                               token_pos, token_ctx_len, out, t, nh, nkv, p_rows,
                                               nb, d, bs, sm_scale, window, s);
  if (q_dtype == 0)
    return launch<float, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, pages, token_pos,
                                       token_ctx_len, out, t, nh, nkv, p_rows, nb, d, bs, sm_scale,
                                       window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
