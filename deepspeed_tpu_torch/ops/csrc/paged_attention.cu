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
// its pages instead of producing NaN, exactly as the TPU kernel does.
//
// Bound: bytes.  Every live K/V page row is read once per (token, head);
// the arithmetic is 4*group*d flops per key, far below the ~295 flop/byte
// the H100 needs before its tensor cores bind.  The least time is the live
// K/V bytes (plus q, out and the tables) over 3.35 TB/s.  A decode step
// (32 tokens of llama3-8b) is only T * nkv = 256 (token, head) pairs, each
// a walk over up to 128 pages of 4 KB (K) and 4 KB (V): one block a pair
// leaves half the card idle and each block waiting on one page at a time.
//
// Design:
//  * split context (flash-decoding): the grid is (token, KV head, split).
//    Split s of a token walks pages [j_lo + s*c, j_lo + (s+1)*c) of its
//    span, c = ceil(span / splits), so the blocks of a token share its
//    pages evenly; the wrapper picks `splits` from T * nkv, the SM count
//    and the table width (ops/paged_attention.py split_plan).  With one
//    split a block writes the output; otherwise it writes its fp32 partial
//    state (m, l, unnormalised acc) to scratch the wrapper allocates, and
//    paged_attention_merge_kernel combines the splits of each (token, query
//    head): M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s /
//    safe(sum w_s l_s).  A split whose every entry is masked carries m =
//    -1e30 and weighs nothing beside a live one; beside only masked splits
//    it weighs 1, the sequential walk's average; an empty split (a span
//    shorter than the split count) carries l = 0 and acc = 0.
//  * pages in flight: a ring of kStages pages (K, V and, int8, their scale
//    rows) in shared memory, each stage filled by the bulk copy engine
//    (cp.async.bulk: a page's K rows are one contiguous run of the
//    [nkv, P, d] layout, 4 KB at bs 16, d 128, bf16) behind a `full`
//    mbarrier; the warps release a stage through an `empty` mbarrier, and
//    thread 0 refills the stage of the page before the current one, so
//    kStages - 1 pages load while a page is read.  The split's page ids
//    are read into shared memory once.  No block-wide barrier per page.
//  * the softmax in registers, spread over warps: the 4 warps take 4 rows
//    each of every 16-row group of a page and keep their own running (m,
//    l, acc); they merge once, at the end, through shared memory.  Within
//    a warp the lanes split into one sub-group per query head of the group
//    (8 lanes a head at group 4); a lane holds EL elements of its head's q
//    and acc in registers (16 at d 128), in chunks of one 16-byte (or
//    narrower) shared load, chunk c of lane j covering elements
//    (c * sub + j) * CE .. + CE - 1, so that a sub-group's loads of a row
//    are conflict-free.  A score is the lane's partial dot product reduced
//    over the sub-group by shuffles; 4 rows at a time take one running-max
//    update.  int8 rows widen to fp32 by a byte permute and one subtract.
//  * two routes, chosen by the caller (ops/paged_attention.py route) on
//    paged_attention_plan, which holds both routes' rules and layouts: the
//    serving path's bf16 queries over bf16 or int8 pages take tensor cores
//    (mma, paged_attention_mma_kernel below: a warp a page, 16 heads by 16
//    keys a product, pages loaded by TMA into swizzled boxes), since on
//    CUDA cores the conversions and dot products of a page cost more issue
//    slots than its bytes take to arrive; the fp32-query and fp32-page
//    lanes, which the card-vs-CPU reference holds at fp32 tolerances, keep
//    the walk above on CUDA cores (fma), as do other geometries.
//  * rounding points follow the TPU kernel: fp32 scores, probabilities cast
//    to the page dtype before p.v (bf16 body), and in the int8 body the k
//    scale multiplies score columns and the v scale multiplies the fp32
//    probabilities before p.v.  Splitting and the warps' own running maxima
//    change the max p is rounded against, not the points.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a lane plan or shared
// memory the kernel cannot take).

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupRows = 4;     // rows a warp takes of each 16-row group of a page
constexpr int kStages = 4;        // pages in the ring
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p as p.v multiplies it: rounded to the page dtype (the TPU kernel's
// p.astype(v.dtype))
template <typename TKV> __device__ __forceinline__ float round_p(float p) {
  if constexpr (std::is_same<TKV, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(p));
  else
    return p;
}

// exp: exact for the fp32-query lanes (the card-vs-CPU reference), the
// fast approximation otherwise
template <bool EXACT> __device__ __forceinline__ float ex(float x) {
  if constexpr (EXACT)
    return expf(x);
  else
    return __expf(x);
}

// A lane's share of a row: EL elements in chunks of kBytes (one shared
// load each), kCE elements a chunk, kNV chunks.
template <typename T, int EL>
struct Lanes {
  static constexpr int kBytes = EL * static_cast<int>(sizeof(T)) < 16
                                    ? EL * static_cast<int>(sizeof(T)) : 16;
  static constexpr int kCE = kBytes / static_cast<int>(sizeof(T));
  static constexpr int kNV = EL / kCE;
};

// kCE elements of type T at shared address p (kBytes aligned) as floats
template <typename T, int B>
__device__ __forceinline__ void load_chunk(const unsigned char* p, float* out) {
  uint32_t w[B / 4];
  if constexpr (B == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (B == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < B / 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      out[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {  // int8: byte b + 128 into the mantissa of 2^23, less 2^23 + 128
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + b)) - 8388736.f;
    }
  }
}

__host__ __device__ constexpr int round128(int x) { return (x + 127) / 128 * 128; }

// shared memory: the barriers (128 bytes), the split's page ids, then the
// ring of pages, which the warps' merge reuses after the walk
__host__ __device__ inline int ids_bytes(int max_chunk) { return round128(4 * max_chunk); }
__host__ __device__ inline int stage_bytes(int page_bytes, int bs, bool quant) {
  return round128(2 * page_bytes + (quant ? 8 * bs : 0));
}
inline size_t smem_bytes(int page_bytes, int bs, bool quant, int max_chunk, int el) {
  const int ring = kStages * stage_bytes(page_bytes, bs, quant);
  const int merge = kWarps * 32 * (el + 2) * 4;
  return 128 + ids_bytes(max_chunk) + (ring > merge ? ring : merge);
}

// TQ: query/output type; TKV: page type (int8_t with QUANT); EL: elements a
// lane holds of its head's q and acc; sub: lanes a query head (32 / the
// group rounded up to a power of two)
template <typename TQ, typename TKV, bool QUANT, int EL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int* __restrict__ pages,
                       const int* __restrict__ token_pos, const int* __restrict__ token_ctx_len,
                       TQ* __restrict__ out, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int nh, int nkv, int p_rows, int nb, int d,
                       int bs, float sm_scale, int window, int sub, int max_chunk) {
  using L = Lanes<TKV, EL>;
  constexpr bool kExact = std::is_same<TQ, float>::value;
  using hopper::mbar_arrive;
  using hopper::mbar_wait;
  const int t = blockIdx.x, h = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int group = nh / nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / sub, j = lane % sub;  // the lane's head in the group, its place there
  const int hq = h * group + (g < group ? g : group - 1);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int* ids = reinterpret_cast<int*>(smem + 128);
  unsigned char* ring = smem + 128 + ids_bytes(max_chunk);
  const int page_bytes = bs * d * static_cast<int>(sizeof(TKV));
  const int stage = stage_bytes(page_bytes, bs, QUANT);
  const int row_bytes = d * static_cast<int>(sizeof(TKV));

  // this split's pages of the token's span [j_lo, j_hi)
  const int pos = token_pos[t];
  const int clen = token_ctx_len[t];
  const int j_lo = window > 0 ? max((pos - (window - 1)) / bs, 0) : 0;  // <0 clamps
  const int j_hi = min(pos / bs + 1, nb);
  const int span = max(j_hi - j_lo, 0);
  const int chunk = (span + splits - 1) / splits;
  const int p0 = j_lo + split * chunk;
  const int n_pages = max(min(p0 + chunk, j_hi) - p0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    ids[i] = pages[static_cast<long long>(t) * nb + p0 + i];
  __syncthreads();

  const long long head_row = static_cast<long long>(h) * p_rows;
  const uint32_t tx = 2 * page_bytes + (QUANT ? 8 * bs : 0);
  auto issue = [&](int n) {  // thread 0: page n of the split into its stage
    const int s = n % kStages;
    const long long row0 = head_row + static_cast<long long>(ids[n]) * bs;
    unsigned char* st = ring + s * stage;
    hopper::mbar_expect_tx(&full[s], tx);
    hopper::bulk_load(st, k_pages + row0 * d, page_bytes, &full[s]);
    hopper::bulk_load(st + page_bytes, v_pages + row0 * d, page_bytes, &full[s]);
    if constexpr (QUANT) {
      hopper::bulk_load(st + 2 * page_bytes, k_scales + row0, 4 * bs, &full[s]);
      hopper::bulk_load(st + 2 * page_bytes + 4 * bs, v_scales + row0, 4 * bs, &full[s]);
    }
  };
  if (threadIdx.x == 0)
    for (int n = 0; n < min(kStages, n_pages); ++n) issue(n);

  float qv[EL], acc[EL];
  const TQ* q_h = q + (static_cast<long long>(t) * nh + hq) * d;
#pragma unroll
  for (int c = 0; c < L::kNV; ++c)
#pragma unroll
    for (int e = 0; e < L::kCE; ++e) {
      const int i = (c * sub + j) * L::kCE + e;
      qv[c * L::kCE + e] = g < group && i < d ? to_f(q_h[i]) : 0.f;
      acc[c * L::kCE + e] = 0.f;
    }
  float m_run = kNegInf, l_run = 0.f;

  for (int n = 0; n < n_pages; ++n) {
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    const unsigned char* kt = ring + s * stage;
    const unsigned char* vt = kt + page_bytes;
    const float* kst = reinterpret_cast<const float*>(kt + 2 * page_bytes);
    const float* vst = kst + bs;
    const int c0 = (p0 + n) * bs;
    for (int r0 = kGroupRows * warp; r0 < bs; r0 += kGroupRows * kWarps) {
      float sc[kGroupRows];
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        const int r = r0 + i;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < L::kNV; ++c) {
          const int off = (c * sub + j) * L::kCE;
          if (off < d) {
            float kf[L::kCE];
            load_chunk<TKV, L::kBytes>(kt + r * row_bytes + off * sizeof(TKV), kf);
#pragma unroll
            for (int e = 0; e < L::kCE; ++e) part = fmaf(qv[c * L::kCE + e], kf[e], part);
          }
        }
        for (int o = sub / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const int col = c0 + r;
        const bool valid = col <= pos && col < clen && (window <= 0 || pos - col < window);
        float cs = sm_scale;
        if constexpr (QUANT) cs *= kst[r];
        sc[i] = valid ? part * cs : kNegInf;
      }
      float m_new = m_run;
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) m_new = fmaxf(m_new, sc[i]);
      const float alpha = ex<kExact>(m_run - m_new);
      float pv[kGroupRows], sum = 0.f;
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        const float p = ex<kExact>(sc[i] - m_new);
        sum += p;
        if constexpr (QUANT)
          pv[i] = p * vst[r0 + i];
        else
          pv[i] = round_p<TKV>(p);
      }
      l_run = l_run * alpha + sum;
      m_run = m_new;
#pragma unroll
      for (int x = 0; x < EL; ++x) acc[x] *= alpha;
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
#pragma unroll
        for (int c = 0; c < L::kNV; ++c) {
          const int off = (c * sub + j) * L::kCE;
          if (off < d) {
            float vf[L::kCE];
            load_chunk<TKV, L::kBytes>(vt + (r0 + i) * row_bytes + off * sizeof(TKV), vf);
#pragma unroll
            for (int e = 0; e < L::kCE; ++e)
              acc[c * L::kCE + e] = fmaf(pv[i], vf[e], acc[c * L::kCE + e]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    // refill the stage of the page before this one: its readers are done
    // by now, so thread 0 seldom waits, and kStages - 1 pages stay in flight
    if (threadIdx.x == 0 && n >= 1 && n + kStages - 1 < n_pages) {
      mbar_wait(&empty[(n - 1) % kStages], ((n - 1) / kStages) & 1);
      issue(n + kStages - 1);
    }
  }

  // the warps' states merge once, through the free ring
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);  // [kWarps][32]
  float* wl = wm + kWarps * 32;                // [kWarps][32]
  float* wa = wl + kWarps * 32;                // [kWarps][EL][32]
  wm[warp * 32 + lane] = m_run;
  wl[warp * 32 + lane] = l_run;
#pragma unroll
  for (int x = 0; x < EL; ++x) wa[(warp * EL + x) * 32 + lane] = acc[x];
  __syncthreads();
  if (warp != 0 || g >= group) return;
  float m = wm[lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wm[w * 32 + lane]);
  float wt[kWarps], l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = ex<kExact>(wm[w * 32 + lane] - m);
    l += wt[w] * wl[w * 32 + lane];
  }
#pragma unroll
  for (int x = 0; x < EL; ++x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(wt[w], wa[(w * EL + x) * 32 + lane], a);
    acc[x] = a;
  }
  const long long row = static_cast<long long>(t) * nh + hq;
  if (splits == 1) {
    const float safe_l = l > 0.f ? l : 1.f;
    TQ* o_h = out + row * d;
#pragma unroll
    for (int c = 0; c < L::kNV; ++c)
#pragma unroll
      for (int e = 0; e < L::kCE; ++e) {
        const int i = (c * sub + j) * L::kCE + e;
        if (i < d) o_h[i] = from_f<TQ>(acc[c * L::kCE + e] / safe_l);
      }
    return;
  }
  const long long slot = row * splits + split;
  if (j == 0) {
    part_ml[2 * slot] = m;
    part_ml[2 * slot + 1] = l;
  }
  float* pa = part_acc + slot * d;
#pragma unroll
  for (int c = 0; c < L::kNV; ++c)
#pragma unroll
    for (int e = 0; e < L::kCE; ++e) {
      const int i = (c * sub + j) * L::kCE + e;
      if (i < d) pa[i] = acc[c * L::kCE + e];
    }
}

// ---- the bf16 lane on tensor cores ------------------------------------
constexpr int kMmaStages = 2 * kWarps;  // two pages in flight a warp

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__host__ __device__ constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }
// a stage of the mma lane: the K boxes, the V boxes (128-byte rows: 64 bf16
// columns a box, or the whole 128-byte int8 row), then, int8, the K and V
// scale rows; 1024-aligned for the swizzle
__host__ __device__ inline int mma_stage_bytes(int d, int bs, bool quant) {
  return round1024(2 * (quant ? 1 : d / 64) * bs * 128 + (quant ? 8 * bs : 0));
}
// shared memory of the mma lane: 1024 to align, the barriers and the page
// ids, then the ring, reused by the warps' merge
inline size_t mma_smem_bytes(int d, int bs, bool quant, int max_chunk) {
  const int ring = kMmaStages * mma_stage_bytes(d, bs, quant);
  const int merge = kWarps * 32 * (d / 2 + 4) * 4;
  return 1024 + round1024(128 + ids_bytes(max_chunk)) + (ring > merge ? ring : merge);
}

// int8 bytes lo, hi (as the low 16 bits of x) to a bf16 pair, exactly: each
// byte plus 128 into the mantissa of 2^23, less 2^23 + 128, then packed
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t x) {
  x ^= 0x8080u;
  const float lo = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - 8388736.f;
  return pack_bf16(lo, hi);
}
// the address of byte (row, col) of a 128-byte-row box with 128-byte swizzle
__device__ __forceinline__ const unsigned char* swz8(const unsigned char* box, int row, int col) {
  return box + row * 128 + ((((col >> 4) ^ (row & 7))) << 4) + (col & 15);
}

// The bf16-query lanes on mma.sync (bf16 pages, and int8 pages at d 128):
// each warp walks whole pages (pages w, w + 4, ... of the split) through
// two stages of its own, each page's K and V loaded by TMA in boxes of
// 128-byte rows with 128-byte swizzle (so the 8 rows an ldmatrix reads fall
// in 8 banks), and computes, for each 16-row part of the page, S^T = Q .
// K^T (16 query heads, the group's padded with zeros, by 16 keys; Q's
// fragments stay in registers) and O += P . V, with P taken straight from
// S's accumulator.  A head's 16 scores of a part live in the 4 threads of a
// quad: its max and sum are two shuffles each.  bf16 pages: P rounded to
// bf16 as the TPU kernel rounds it, fragments by ldmatrix.  int8 pages
// (QUANT): the fragments are gathered from the swizzled bytes and widened
// to bf16 exactly, so q.k is the fp32 dot product of the TPU body; the k
// scale multiplies score columns; the v scale multiplies the fp32
// probabilities, which then enter P . V as two bf16 parts (hi and the
// remainder lo, two products), so p.v keeps about 16 bits of p, not 8.
template <int D, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __nv_bfloat16* __restrict__ q, const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales, const int* __restrict__ pages,
                           const int* __restrict__ token_pos,
                           const int* __restrict__ token_ctx_len, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ part_ml, float* __restrict__ part_acc, int nh,
                           int nkv, int p_rows, int nb, int bs, float sm_scale, int window,
                           int max_chunk) {
  static_assert(!QUANT || D == 128, "int8 pages: one 128-byte box a row");
  constexpr int kBoxes = QUANT ? 1 : D / 64, kKSteps = D / 16, kNT = D / 8;
  using hopper::mbar_wait;
  using hopper::smem_addr;
  const int t = blockIdx.x, h = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int group = nh / nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* ids = reinterpret_cast<int*>(smem + 128);
  unsigned char* ring = smem + round1024(128 + ids_bytes(max_chunk));
  const int box_bytes = bs * 128, stage = mma_stage_bytes(D, bs, QUANT);
  const uint32_t tx = 2 * kBoxes * box_bytes + (QUANT ? 8 * bs : 0);

  const int pos = token_pos[t];
  const int clen = token_ctx_len[t];
  const int j_lo = window > 0 ? max((pos - (window - 1)) / bs, 0) : 0;  // <0 clamps
  const int j_hi = min(pos / bs + 1, nb);
  const int span = max(j_hi - j_lo, 0);
  const int chunk = (span + splits - 1) / splits;
  const int p0 = j_lo + split * chunk;
  const int n_pages = max(min(p0 + chunk, j_hi) - p0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMmaStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    ids[i] = pages[static_cast<long long>(t) * nb + p0 + i];
  __syncthreads();

  // page n of the split: warp n % 4's, in its stage n % 4 + 4 * ((n / 4) % 2)
  auto issue = [&](int n) {  // lane 0 of the page's warp
    const int s = warp + kWarps * ((n / kWarps) & 1);
    unsigned char* st = ring + s * stage;
    const int row0 = ids[n] * bs;
    hopper::mbar_expect_tx(&full[s], tx);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) {
      hopper::tma_load_3d(st + b * box_bytes, &map_k, &full[s], 64 * b, row0, h);
      hopper::tma_load_3d(st + (kBoxes + b) * box_bytes, &map_v, &full[s], 64 * b, row0, h);
    }
    if constexpr (QUANT) {
      const long long srow = static_cast<long long>(h) * p_rows + row0;
      unsigned char* sc = st + 2 * box_bytes;
      hopper::bulk_load(sc, k_scales + srow, 4 * bs, &full[s]);
      hopper::bulk_load(sc + 4 * bs, v_scales + srow, 4 * bs, &full[s]);
    }
  };
  if (lane == 0)
    for (int n = warp; n < n_pages && n < warp + kMmaStages; n += kWarps) issue(n);

  // Q's A fragments: a0 (head g, cols 2tq), a1 (head g + 8), a2 and a3 the
  // same 8 columns on; heads past the group are zeros
  uint32_t qa[kKSteps][4];
  const __nv_bfloat16* qh = q + (static_cast<long long>(t) * nh + h * group) * D;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int head = g + 8 * (x % 2), col = 16 * kk + 8 * (x / 2) + 2 * tq;
      qa[kk][x] = head < group ? *reinterpret_cast<const uint32_t*>(qh + head * D + col) : 0u;
    }
  float o[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int i = 0, n = warp; n < n_pages; ++i, n += kWarps) {
    const int s = warp + kWarps * (i & 1);
    mbar_wait(&full[s], (i >> 1) & 1);
    const unsigned char* kp = ring + s * stage;
    const unsigned char* vp = kp + kBoxes * box_bytes;
    const float* kst = reinterpret_cast<const float*>(kp + 2 * box_bytes);  // QUANT
    const float* vst = kst + bs;
    const uint32_t kb = smem_addr(kp), vb = smem_addr(vp);
    const int c_page = (p0 + n) * bs;
    for (int r0 = 0; r0 < bs; r0 += 16) {
      // S^T = Q . K^T: sc[nt][e] is head g + 8 (e / 2), key r0 + 8 nt + 2 tq + e % 2
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t b[4];
        if constexpr (QUANT) {  // key r0 + 8 nt + g, columns 16 kk + 2 tq (+ 8)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const unsigned char* p = swz8(kp, r0 + 8 * (x / 2) + g, 16 * kk + 8 * (x % 2) + 2 * tq);
            b[x] = s8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p));
          }
        } else {
          const int mat = lane / 8, r = r0 + (mat / 2) * 8 + lane % 8, c = 2 * (kk % 4) + mat % 2;
          ldsm_x4<false>(b, kb + (kk / 4) * box_bytes + r * 128 + ((c ^ (r & 7)) << 4));
        }
        mma_bf16(sc[0], qa[kk], b[0], b[1]);
        mma_bf16(sc[1], qa[kk], b[2], b[3]);
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 8 * nt + 2 * tq + e % 2, col = c_page + r;
          const bool valid = col <= pos && col < clen && (window <= 0 || pos - col < window);
          float cs = sm_scale;
          if constexpr (QUANT) cs *= kst[r];
          sc[nt][e] = valid ? sc[nt][e] * cs : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float m_new = fmaxf(m_run[x], quad_max(mx[x]));
        alpha[x] = __expf(m_run[x] - m_new);
        m_run[x] = m_new;
      }
      // P's A fragments: (head g, keys 2tq..), (head g + 8, ..), 8 keys on;
      // int8: the v-scaled probabilities in two bf16 parts, pa and pl
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float p0v = __expf(sc[nt][2 * x] - m_run[x]);
          float p1v = __expf(sc[nt][2 * x + 1] - m_run[x]);
          sum[x] += p0v + p1v;
          if constexpr (QUANT) {
            const int r = r0 + 8 * nt + 2 * tq;
            p0v *= vst[r];
            p1v *= vst[r + 1];
            pa[2 * nt + x] = pack_bf16(p0v, p1v);
            const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&pa[2 * nt + x]);
            pl[2 * nt + x] = pack_bf16(p0v - __low2float(hi), p1v - __high2float(hi));
          } else {
            pa[2 * nt + x] = pack_bf16(p0v, p1v);
          }
        }
#pragma unroll
      for (int x = 0; x < 2; ++x) l_run[x] = l_run[x] * alpha[x] + quad_sum(sum[x]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += P . V: V's B fragments (keys 2tq, 2tq + 1, and 8 on, of column
      // 8j + g) by ldmatrix.trans, two 8-column tiles a load; int8: gathered
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b[4];
        if constexpr (QUANT) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = r0 + 2 * tq + 8 * (x % 2), c = 8 * (j + x / 2) + g;
            b[x] = s8x2_to_bf16x2(*swz8(vp, r, c) | (uint32_t{*swz8(vp, r + 1, c)} << 8));
          }
          mma_bf16(o[j], pl, b[0], b[1]);
          mma_bf16(o[j + 1], pl, b[2], b[3]);
        } else {
          const int mat = lane / 8, r = r0 + (mat % 2) * 8 + lane % 8, jj = j + mat / 2;
          ldsm_x4<true>(b, vb + (jj / 8) * box_bytes + r * 128 + (((jj % 8) ^ (r & 7)) << 4));
        }
        mma_bf16(o[j], pa, b[0], b[1]);
        mma_bf16(o[j + 1], pa, b[2], b[3]);
      }
    }
    __syncwarp();  // every lane's reads of the stage are done
    if (lane == 0 && n + kMmaStages < n_pages) issue(n + kMmaStages);
  }

  // the warps' states merge once, through the free ring
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);  // [kWarps][2][32]
  float* wl = wm + kWarps * 64;                // [kWarps][2][32]
  float* wa = wl + kWarps * 64;                // [kWarps][kNT * 4][32]
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    wm[(warp * 2 + x) * 32 + lane] = m_run[x];
    wl[(warp * 2 + x) * 32 + lane] = l_run[x];
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) wa[(warp * kNT * 4 + 4 * j + e) * 32 + lane] = o[j][e];
  __syncthreads();
  if (warp != 0) return;
  float wt[2][kWarps], l[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float m = wm[x * 32 + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wm[(w * 2 + x) * 32 + lane]);
    l[x] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wt[x][w] = __expf(wm[(w * 2 + x) * 32 + lane] - m);
      l[x] += wt[x][w] * wl[(w * 2 + x) * 32 + lane];
    }
    m_run[x] = m;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a = fmaf(wt[e / 2][w], wa[(w * kNT * 4 + 4 * j + e) * 32 + lane], a);
      o[j][e] = a;
    }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int head = g + 8 * x;
    if (head >= group) continue;
    const long long row = static_cast<long long>(t) * nh + h * group + head;
    if (splits == 1) {
      const float safe_l = l[x] > 0.f ? l[x] : 1.f;
      __nv_bfloat16* o_h = out + row * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o_h + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * x] / safe_l, o[j][2 * x + 1] / safe_l);
    } else {
      const long long slot = row * splits + split;
      if (tq == 0) {
        part_ml[2 * slot] = m_run[x];
        part_ml[2 * slot + 1] = l[x];
      }
      float* pa = part_acc + slot * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        *reinterpret_cast<float2*>(pa + 8 * j) = make_float2(o[j][2 * x], o[j][2 * x + 1]);
    }
  }
}

// The splits of each (token, query head), one block a row: part_ml [rows,
// splits, 2] (m, l), part_acc [rows, splits, d].  Warp 0 finds M and the
// denominator; every thread weighs its elements' splits by exp(m_s - M).
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc, TQ* __restrict__ out, int d,
                             int splits) {
  __shared__ float big, den;
  const long long row = blockIdx.x;
  const float* ml = part_ml + row * splits * 2;
  if (threadIdx.x < 32) {
    float m = kNegInf;
    for (int s = threadIdx.x; s < splits; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int s = threadIdx.x; s < splits; s += 32) l += expf(ml[2 * s] - m) * ml[2 * s + 1];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (threadIdx.x == 0) {
      big = m;
      den = l > 0.f ? l : 1.f;
    }
  }
  __syncthreads();
  const float* pa = part_acc + row * splits * d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a = fmaf(expf(ml[2 * s] - big), pa[static_cast<long long>(s) * d + i], a);
    out[row * d + i] = from_f<TQ>(a / den);
  }
}

// the merge of the splits, when there is more than one
template <typename TQ>
int merge(const float* part_ml, const float* part_acc, void* out, int t, int nh, int d,
          int splits, cudaStream_t stream) {
  if (splits == 1) return 0;
  paged_attention_merge_kernel<TQ><<<t * nh, kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<TQ*>(out), d, splits);
  return static_cast<int>(cudaGetLastError());
}

// A call's launch plan on one route: whether the route takes it, the fma
// walk's lane plan (sub: lanes a query head, 32 over the group rounded up
// to a power of two; el: elements a lane holds of its head's q and acc, a
// power of two from 4 to 32 that, times sub, covers d, read in chunks of
// min(16, el * kv_elem) bytes whose elements d must be a multiple of) and
// the dynamic shared memory.  The only place the routes' geometry rules and
// shared-memory layouts are decided: the wrapper asks paged_attention_plan
// before it picks the route, and the entries launch on the same plan.
struct Plan {
  bool ok = false;
  int sub = 0, el = 0;
  size_t smem = 0;
};

// kv_dtype: 0 float32, 1 bfloat16, 2 int8 (scaled pages)
Plan make_plan(int route, int q_dtype, int kv_dtype, int d, int group, int bs, int nb,
               int splits) {
  Plan p;
  const bool quant = kv_dtype == 2;
  const int kv_elem = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  if (q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 2 || d <= 0 || group <= 0 ||
      bs <= 0 || bs % 8 != 0 || nb <= 0 || splits < 1)
    return p;
  const int max_chunk = (nb + splits - 1) / splits;
  if (route == 1) {  // mma: bf16 queries over bf16 pages at d 64/128 or int8 pages at d 128
    const bool dims = (kv_dtype == 1 && (d == 64 || d == 128)) || (quant && d == 128);
    if (q_dtype != 1 || !dims || group > 16 || bs % 16 != 0)
      return p;
    p.smem = mma_smem_bytes(d, bs, quant, max_chunk);
  } else if (route == 0) {  // fma: the lane walk on CUDA cores
    int heads = 1;
    while (heads < group) heads *= 2;
    if (heads > 32) return p;
    p.sub = 32 / heads;
    for (int e = 4; e <= 32 && !p.el; e *= 2)
      if (e * p.sub >= d) p.el = e;
    const int chunk = (p.el * kv_elem < 16 ? p.el * kv_elem : 16) / kv_elem;
    if (p.el == 0 || d % chunk != 0) return p;
    p.smem = smem_bytes(bs * d * kv_elem, bs, quant, max_chunk, p.el);
  } else {
    return p;
  }
  p.ok = p.smem <= static_cast<size_t>(kMaxSmem);
  return p;
}

template <typename TQ, typename TKV, bool QUANT, int EL>
int launch_el(const void* q, const void* k, const void* v, const float* ks, const float* vs,
              const int* pages, const int* pos, const int* clen, void* out, float* part_ml,
              float* part_acc, int t, int nh, int nkv, int p_rows, int nb, int d, int bs,
              float sm_scale, int window, int splits, const Plan& plan, cudaStream_t stream) {
  const int max_chunk = (nb + splits - 1) / splits;
  auto kern = paged_attention_kernel<TQ, TKV, QUANT, EL>;
  cudaError_t e;
  if (plan.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(t, nkv, splits);
  kern<<<grid, kThreads, plan.smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks, vs,
      pages, pos, clen, static_cast<TQ*>(out), part_ml, part_acc, nh, nkv, p_rows, nb, d, bs,
      sm_scale, window, plan.sub, max_chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return merge<TQ>(part_ml, part_acc, out, t, nh, d, splits, stream);
}

template <int D, bool QUANT>
int launch_mma(const void* q, const void* k, const void* v, const float* ks, const float* vs,
               const int* pages, const int* pos, const int* clen, void* out, float* part_ml,
               float* part_acc, int t, int nh, int nkv, int p_rows, int nb, int bs,
               float sm_scale, int window, int splits, const Plan& plan, cudaStream_t stream) {
  const int max_chunk = (nb + splits - 1) / splits;
  // the page pools [nkv, P, D] as 3-D maps, boxes of 128-byte rows (64 bf16
  // columns, or the whole int8 row) x bs rows, 128-byte swizzle
  CUtensorMap mk, mv;
  const uint64_t elem = QUANT ? 1 : 2;
  const uint64_t dims[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(p_rows),
                            static_cast<uint64_t>(nkv)};
  const uint64_t strides[2] = {static_cast<uint64_t>(D) * elem,
                               static_cast<uint64_t>(p_rows) * D * elem};
  const uint32_t box[3] = {static_cast<uint32_t>(128 / elem), static_cast<uint32_t>(bs), 1};
  const CUtensorMapDataType type =
      QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hopper_host::encode(&mk, type, CU_TENSOR_MAP_SWIZZLE_128B, k, 3, dims, strides, box) ||
      !hopper_host::encode(&mv, type, CU_TENSOR_MAP_SWIZZLE_128B, v, 3, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  if (QUANT && (reinterpret_cast<uintptr_t>(ks) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(vs) % 16 != 0))  // bulk copies of scale rows
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_attention_mma_kernel<D, QUANT>;
  cudaError_t e;
  if (plan.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(t, nkv, splits), kThreads, plan.smem, stream>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q), ks, vs, pages, pos, clen,
      static_cast<__nv_bfloat16*>(out), part_ml, part_acc, nh, nkv, p_rows, nb, bs, sm_scale,
      window, max_chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return merge<__nv_bfloat16>(part_ml, part_acc, out, t, nh, D, splits, stream);
}

// the fma walk at the plan's elements a lane
template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* pages, const int* pos, const int* clen, void* out, float* part_ml,
           float* part_acc, int t, int nh, int nkv, int p_rows, int nb, int d, int bs,
           float sm_scale, int window, int splits, const Plan& plan, cudaStream_t stream) {
#define PAGED_LAUNCH(E)                                                                       \
  launch_el<TQ, TKV, QUANT, E>(q, k, v, ks, vs, pages, pos, clen, out, part_ml, part_acc, t, \
                               nh, nkv, p_rows, nb, d, bs, sm_scale, window, splits, plan,   \
                               stream)
  switch (plan.el) {
    case 4: return PAGED_LAUNCH(4);
    case 8: return PAGED_LAUNCH(8);
    case 16: return PAGED_LAUNCH(16);
    case 32: return PAGED_LAUNCH(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_LAUNCH
}

// the plan of a call, or why not: the shapes' own checks and scratch for the
// splits' partial states past one split
Plan entry_plan(int route, int q_dtype, int kv_dtype, int nh, int nkv, int d, int bs, int nb,
                int splits, const float* part_ml, const float* part_acc) {
  if (nkv <= 0 || nh % nkv != 0 || (splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return Plan{};
  return make_plan(route, q_dtype, kv_dtype, d, nh / nkv, bs, nb, splits);
}

}  // namespace

// The launch plan of a call on `route` (0 fma, 1 mma): 0 when the route
// takes it, with the fma walk's lane plan in *sub, *el (0 on mma) and the
// dynamic shared memory in *smem; cudaErrorInvalidValue otherwise.  dtype
// codes: q 0 float32, 1 bfloat16; kv 0 float32, 1 bfloat16, 2 int8.
// ops/paged_attention.py route asks it before the launch.
extern "C" int paged_attention_plan(int route, int q_dtype, int kv_dtype, int d, int group,
                                    int bs, int nb, int splits, int* sub, int* el, int* smem) {
  const Plan p = make_plan(route, q_dtype, kv_dtype, d, group, bs, nb, splits);
  *sub = p.sub;
  *el = p.el;
  *smem = static_cast<int>(p.smem);
  return p.ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// route: 0 fma (the lane walk on CUDA cores, every dtype), 1 mma (bf16
// queries over bf16 pages, d 64 or 128, a group of at most 16, bs a
// multiple of 16; chosen by ops/paged_attention.py route).  dtype codes: 0
// = float32, 1 = bfloat16.  part_ml [T, nh, splits, 2] and part_acc [T, nh,
// splits, d] fp32: the splits' partial states (null with one split).
extern "C" int paged_attention_fwd(int route, int q_dtype, int kv_dtype, const void* q,
                                   const void* k_pages, const void* v_pages, const int* pages,
                                   const int* token_pos, const int* token_ctx_len, void* out,
                                   float* part_ml, float* part_acc, int t, int nh, int nkv,
                                   int p_rows, int nb, int d, int bs, float sm_scale, int window,
                                   int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan =
      entry_plan(route, q_dtype, kv_dtype, nh, nkv, d, bs, nb, splits, part_ml, part_acc);
  if (!plan.ok) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return 0;
  if (route == 1) {
    if (d == 64)
      return launch_mma<64, false>(q, k_pages, v_pages, nullptr, nullptr, pages, token_pos,
                                   token_ctx_len, out, part_ml, part_acc, t, nh, nkv, p_rows, nb,
                                   bs, sm_scale, window, splits, plan, s);
    return launch_mma<128, false>(q, k_pages, v_pages, nullptr, nullptr, pages, token_pos,
                                  token_ctx_len, out, part_ml, part_acc, t, nh, nkv, p_rows, nb,
                                  bs, sm_scale, window, splits, plan, s);
  }
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, pages, token_pos, token_ctx_len, out, part_ml,
        part_acc, t, nh, nkv, p_rows, nb, d, bs, sm_scale, window, splits, plan, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16, false>(q, k_pages, v_pages, nullptr, nullptr, pages,
                                               token_pos, token_ctx_len, out, part_ml, part_acc,
                                               t, nh, nkv, p_rows, nb, d, bs, sm_scale, window,
                                               splits, plan, s);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k_pages, v_pages, nullptr, nullptr, pages, token_pos,
                                       token_ctx_len, out, part_ml, part_acc, t, nh, nkv, p_rows,
                                       nb, d, bs, sm_scale, window, splits, plan, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// route: 0 fma, 1 mma (bf16 queries, d 128, a group of at most 16, bs a
// multiple of 16).
extern "C" int paged_attention_int8_fwd(int route, int q_dtype, const void* q,
                                        const void* k_pages, const void* v_pages,
                                        const float* k_scales, const float* v_scales,
                                        const int* pages, const int* token_pos,
                                        const int* token_ctx_len, void* out, float* part_ml,
                                        float* part_acc, int t, int nh, int nkv, int p_rows,
                                        int nb, int d, int bs, float sm_scale, int window,
                                        int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan plan = entry_plan(route, q_dtype, 2, nh, nkv, d, bs, nb, splits, part_ml, part_acc);
  if (!plan.ok) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return 0;
  if (route == 1)
    return launch_mma<128, true>(q, k_pages, v_pages, k_scales, v_scales, pages, token_pos,
                                 token_ctx_len, out, part_ml, part_acc, t, nh, nkv, p_rows, nb,
                                 bs, sm_scale, window, splits, plan, s);
  if (q_dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, pages,
                                               token_pos, token_ctx_len, out, part_ml, part_acc,
                                               t, nh, nkv, p_rows, nb, d, bs, sm_scale, window,
                                               splits, plan, s);
  return launch<float, int8_t, true>(q, k_pages, v_pages, k_scales, v_scales, pages, token_pos,
                                     token_ctx_len, out, part_ml, part_acc, t, nh, nkv, p_rows,
                                     nb, d, bs, sm_scale, window, splits, plan, s);
}
