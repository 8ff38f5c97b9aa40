// Attention forward on wgmma and TMA, Hopper: the dense `flash_fwd` at bf16.
//
// Computes what attn_fwd_kernel of attention_tiles.cuh computes (and what
// the TPU kernels _fwd_kernel / _fwd_kernel_blocked of
// deepspeed_tpu/ops/pallas/flash_mha.py compute): o [B, Hq, S, D] in bf16
// and lse [B, Hq, S] in fp32, by an online softmax over key tiles with fp32
// scores, p rounded to bf16 before p.v, the -1e30 mask with p zeroed on
// masked entries, safe_l = l > 0 ? l : 1; a row that sees no key ends with
// o = 0 and lse = -1e30.  Only the walk and where the numbers live differ.
//
// Bound: q, k, v and o read or written once, and lse (gpt2-350m at micro
// 8, S 1024, D 64, causal: 67.6 MB, 0.0202 ms at 3.35 TB/s), against the
// two products' 4 * pairs * D flops a head (17.2 GFLOP, 0.0174 ms at
// 989 TFLOP/s): the two are close, so the design keeps the tensor cores fed
// and every score tile out of shared and device memory:
//  * a persistent kernel: one block an SM walks work items (128-row query
//    tile, query head, batch), longest causal walks first, so no block
//    pays a launch and a cold pipeline per item: three warpgroups.  The
//    producer (one thread; setmaxnreg hands its registers to the others)
//    loads an item's Q tile, then each key tile's K and V (128 keys)
//    through TMA into a ring (4 stages at D 64, 2 at D 128), each behind
//    its own mbarrier, so S can start before V lands; the consumers free
//    Q after an item's last S, and the next item's Q and tiles load while
//    they finish its softmax, P.V and epilogue.  Q, K, V are
//    4-D tensor maps over the [B, H, S, D] views in place (any strides TMA
//    takes), in 64-column boxes with 128-byte swizzle; GQA addresses K/V
//    head h / group; the S % 128 tail is TMA's zero fill plus the mask.
//  * two consumer warpgroups, 64 query rows each.  Per key tile:
//    S = Q.K^T by wgmma (both from shared memory, K-major) into 64 fp32
//    registers a thread; the online softmax in registers (each row lives
//    in the 4 threads of a quad: row max and row sum are two shuffles);
//    the o accumulator (32 or 64 registers) is rescaled in registers; p is
//    rounded to bf16 in registers, where the S accumulator's layout is
//    already the A fragment of the next product; O += P.V by wgmma with A
//    from registers and V as an MN-major B from shared memory.  The tile
//    is released to the producer by an mbarrier, with no __syncthreads.
//    The two warpgroups interleave on their own: one's softmax runs while
//    the other's products do.  The output leaves through a staging tile in
//    shared memory, whole 128-byte row segments a warp.
//  * the mask policy is the walk's as in attention_tiles.cuh: k_begin,
//    k_end, k_tile bound the key tiles (dead tiles are never visited), ok
//    masks the diagonal and window-edge tiles in registers, and `full`
//    (every pair of a 64-row by 128-key tile visible) sends interior tiles
//    down a softmax compiled without the test (one FFMA and one exp2 an
//    entry: a predicated-off mask test still costs its issue slots).
//    Tiles are 128 rows on both sides: the policy is instantiated with
//    these tile sizes.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a view TMA cannot take or
// a tensor map cuTensorMapEncodeTiled refuses).

#pragma once

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace flash_wg {

constexpr int kBQ = 128, kBK = 128;   // query rows a block, keys a tile
constexpr int kConsumers = 2;         // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // the consumers, then the producer
constexpr uint32_t kBox = 128 * 128;  // one 64-column box of 128 rows, bytes
constexpr uint32_t kAtomRows = 1024;  // 8 swizzled 128-byte rows (SBO)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kBoxes = D / 64;              // 64-column boxes of a row tile
  static constexpr uint32_t kTileBytes = kBoxes * kBox;  // Q, K or V tile: 128 rows x D
  static constexpr int kStages = D == 64 ? 4 : 2;    // K/V tiles in flight
  // 1024 to align; Q; the ring of K and V; the output's staging tile; the
  // Q-full, Q-empty, K-full, V-full and empty barriers
  static constexpr size_t kSmem = 1024 + (2 + 2 * kStages) * kTileBytes +
                                  (2 + 3 * kStages) * sizeof(uint64_t);
};

struct Strides4 {
  long long b, h, s;
};

template <int D>
__device__ __forceinline__ void pv_mma(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128)
    hopper::wgmma_rs_n128<1>(o, a, db, 1);
  else
    hopper::wgmma_rs_n64<1>(o, a, db, 1);
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

// Work item i (of nq * Hq * B): query tile nq - 1 - i / (Hq * B), head
// (i % (Hq * B)) % Hq, batch (i % (Hq * B)) / Hq: the longest causal walks
// first, and neighbouring items share a query tile's length.
struct Item {
  int iq, h, b;
  __device__ Item(int i, int nq, int Hq, int B)
      : iq(nq - 1 - i / (Hq * B)), h((i % (Hq * B)) % Hq), b((i % (Hq * B)) / Hq) {}
};

template <int D, typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, Strides4 so, int B, int Hq, int Hkv, int S,
                      float scale, Mask mask) {
  using L = Layout<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ks = qs + L::kTileBytes;             // stage s: ks + s * kTileBytes
  unsigned char* vs = ks + L::kStages * L::kTileBytes;
  unsigned char* os = vs + L::kStages * L::kTileBytes;  // the output's staging tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(os + L::kTileBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;

  const int nq = (S + kBQ - 1) / kBQ, items = nq * Hq * B;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 128);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // producer: one thread issues every load, item after item; the next
    // item's Q and first tiles load while the consumers finish this one
    reg_dealloc<24>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
        const Item it(i, nq, Hq, B);
        const int hk = it.h / (Hq / Hkv);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j)
          tma_load_4d(qs + j * kBox, &map_q, q_full, 64 * j, it.iq * kBQ, it.h, it.b);
        const int t_end = mask.k_end(it.h, it.iq);
        for (int t = mask.k_begin(it.h, it.iq); t < t_end; ++t) {
          const int k0 = mask.k_tile(t) * kBK;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* kt = ks + stage * L::kTileBytes;
          unsigned char* vt = vs + stage * L::kTileBytes;
          mbar_expect_tx(&k_full[stage], L::kTileBytes);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            tma_load_4d(kt + j * kBox, &map_k, &k_full[stage], 64 * j, k0, hk, it.b);
          mbar_expect_tx(&v_full[stage], L::kTileBytes);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            tma_load_4d(vt + j * kBox, &map_v, &v_full[stage], 64 * j, k0, hk, it.b);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wgi: query rows 64 wgi .. 64 wgi + 63 of each item
  reg_alloc<240>();
  const int w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_addr(qs) + wgi * 8192;  // this warpgroup's 64 rows of each box
  unsigned char* stage_o = os + wgi * 8192;            // likewise in the staging tile
  float s_acc[kBK / 2];
  float o_acc[D / 2];
  uint32_t p[kBK / 16][4];  // p in bf16: the A fragments of the k16 steps of P.V
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s_acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const Item it(i, nq, Hq, B);
    const int h = it.h;
    const int rq0 = it.iq * kBQ + 64 * wgi;  // this warpgroup's first row
    const int row[2] = {rq0 + 16 * w + g, rq0 + 16 * w + g + 8};
    const int t_begin = mask.k_begin(h, it.iq), t_end = mask.k_end(h, it.iq);
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o_acc[x] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

    // The online softmax of the finished S of key tile k0, in registers:
    // s_acc[4j + e] is row row[e / 2], key k0 + 8j + 2tq + (e % 2).  Writes
    // p, updates m and l, returns each row's rescale of o in alpha.
    // MASKED (diagonal and window-edge tiles) tests every entry against the
    // mask; an interior tile takes the lean path, where a row's max of the
    // raw scores times scale is the max of the scaled ones.  That holds for
    // scale > 0 only, so any other scale takes the masked path throughout.
    auto softmax = [&](auto masked, int k0, float (&alpha)[2]) {
      constexpr bool MASKED = decltype(masked)::value;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[4 * j + e];
          if constexpr (MASKED) {
            x = mask.ok(h, row[e / 2], k0 + 8 * j + 2 * tq + (e % 2)) ? x * scale : kNegInf;
            s_acc[4 * j + e] = x;
          }
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_tile = MASKED ? quad_max(mx[r]) : quad_max(mx[r]) * scale;
        const float m_new = fmaxf(m_run[r], m_tile);
        alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);
        m_run[r] = m_new;
        ml[r] = m_new * kLog2e;
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s_acc[4 * j + e];
          if constexpr (MASKED)  // a masked entry holds exactly kNegInf and contributes nothing
            pe[e] = x == kNegInf ? 0.f : exp2f(fmaf(x, kLog2e, -ml[e / 2]));
          else
            pe[e] = exp2f(fmaf(x, scale_log2, -ml[e / 2]));
          sum[e / 2] += pe[e];
        }
        p[j / 2][2 * (j % 2)] = pack_bf16(pe[0], pe[1]);
        p[j / 2][2 * (j % 2) + 1] = pack_bf16(pe[2], pe[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(sum[r]);
    };

    mbar_wait(q_full, n & 1);
    if (t_begin >= t_end) mbar_arrive(q_empty);
    for (int t = t_begin; t < t_end; ++t) {
      const int k0 = mask.k_tile(t) * kBK;
      // S = Q . K^T: both K-major, D/16 steps of 16 along the head dim
      mbar_wait(&k_full[stage], phase);
      const uint32_t k_addr = smem_addr(ks + stage * L::kTileBytes);
      fence_regs(s_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_n128<0, 0>(s_acc, desc_sw128(q_addr + off, 16, kAtomRows),
                            desc_sw128(k_addr + off, 16, kAtomRows), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (t + 1 == t_end) mbar_arrive(q_empty);  // Q is read: the next item's may load

      float alpha[2];
      if (scale > 0.f && mask.full(h, rq0, 64, k0, kBK))
        softmax(std::false_type{}, k0, alpha);
      else
        softmax(std::true_type{}, k0, alpha);
      fence_regs(o_acc);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= alpha[0];
        o_acc[4 * j + 1] *= alpha[0];
        o_acc[4 * j + 2] *= alpha[1];
        o_acc[4 * j + 3] *= alpha[1];
      }

      // O += P . V: V is MN-major (rows are keys, D contiguous), 16 keys a step
      mbar_wait(&v_full[stage], phase);
      const uint32_t v_addr = smem_addr(vs + stage * L::kTileBytes);
      fence_regs(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc)
        pv_mma<D>(o_acc, p[kc], desc_sw128(v_addr + kc * 2048, kBox, kAtomRows));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      mbar_arrive(&empty[stage]);  // K and V of this tile are consumed
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: o times the rounded reciprocal of safe_l, rounded once;
    // lse = m + log(safe_l).  The bf16 rows go through this warpgroup's
    // part of the staging tile, 16-byte chunks XOR-ed by row % 8, so that
    // each row leaves as whole 128-byte segments; rows past S are never
    // stored.
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float safe_l = l_run[r] > 0.f ? l_run[r] : 1.f;
      inv_l[r] = __frcp_rn(safe_l);
      if (tq == 0 && row[r] < S)
        lse[(static_cast<long long>(it.b) * Hq + h) * S + row[r]] = m_run[r] + logf(safe_l);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = 16 * w + g + 8 * r;  // row within the warpgroup's 64
        const int chunk = (j % 8) ^ (lr % 8);
        *reinterpret_cast<__nv_bfloat162*>(stage_o + (j / 8) * kBox + lr * 128 + chunk * 16 +
                                           4 * tq) =
            __floats2bfloat162_rn(o_acc[4 * j + 2 * r] * inv_l[r],
                                  o_acc[4 * j + 2 * r + 1] * inv_l[r]);
      }
    }
    named_sync(1 + wgi, 128);
    __nv_bfloat16* ob = o + it.b * so.b + h * so.h;
#pragma unroll
    for (int x = 0; x < D / 16; ++x) {  // 64 rows x D/8 chunks of 16 bytes, D/16 a thread
      const int v = tid + 128 * x, lr = v / (D / 8), c = v % (D / 8);
      if (rq0 + lr < S)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(rq0 + lr) * so.s + 8 * c) =
            *reinterpret_cast<const uint4*>(stage_o + (c / 8) * kBox + lr * 128 +
                                            ((c % 8) ^ (lr % 8)) * 16);
    }
    named_sync(1 + wgi, 128);  // the staging tile is free for the next item
  }
}

// A 4-D tensor map over one [B, H, S, D] operand (element strides st: b,
// h, s; D contiguous), boxes of 64 columns x 128 rows of one head.  A dim
// of size one is never stepped: it gets the packed stride.
inline bool attn_map(CUtensorMap* map, const void* p, int B, int H, int S, int D,
                     const long long* st) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  uint64_t strides[3];
  const uint64_t packed_s = static_cast<uint64_t>(D) * 2;
  strides[0] = S > 1 ? static_cast<uint64_t>(st[2]) * 2 : packed_s;
  strides[1] = H > 1 ? static_cast<uint64_t>(st[1]) * 2 : strides[0] * S;
  strides[2] = B > 1 ? static_cast<uint64_t>(st[0]) * 2 : strides[1] * H;
  for (uint64_t x : strides)
    if (x == 0 || x % 16 != 0) return false;
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const uint32_t box[4] = {64, static_cast<uint32_t>(kBQ), 1, 1};
  return hopper_host::encode_bf16(map, p, 4, dims, strides, box);
}

// strides: (b, h, s) of q, k, v, o in that order
template <int D, typename Mask>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* strides, int B, int Hq, int Hkv, int S, float scale, Mask mask,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!attn_map(&mq, q, B, Hq, S, D, strides) || !attn_map(&mk, k, B, Hkv, S, D, strides + 3) ||
      !attn_map(&mv, v, B, Hkv, S, D, strides + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_fwd_wgmma_kernel<D, Mask>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Layout<D>::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides4 so{strides[9], strides[10], strides[11]};
  const int items = (S + kBQ - 1) / kBQ * Hq * B;  // persistent: one block an SM at most
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, Layout<D>::kSmem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o),
                                                     lse, so, B, Hq, Hkv, S, scale, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_wg
