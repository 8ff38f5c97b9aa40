// Attention backward on wgmma and TMA, Hopper: the ring hop's `ring_bwd_dq`
// and `ring_bwd_dkv` at bf16, in accumulate mode.
//
// Computes what attn_bwd_dq_kernel / attn_bwd_dkv_kernel of
// attention_tiles.cuh compute under ACC (and what the TPU kernels
// _ring_dq_kernel / _ring_dkv_kernel of deepspeed_tpu/ops/pallas/
// flash_mha.py compute): fp32 scores, p = exp(s * scale - lse) against the
// shard's final lse, zeroed where the mask says no, ds = p * (dp - delta) *
// scale, p rounded to bf16 before p^T.do, ds rounded to bf16 before ds.k
// and ds^T.q; the incoming fp32 dq [B, Hq, S, D] and the traveling fp32
// dk, dv [B, Hkv, S, D] seed the sums and receive them in place.  Only the
// walk and where the numbers live differ.
//
// Bound: the products, 3 (dq) and 4 (dk/dv) of pairs x D a head (a causal
// hop of the ring at llama3-8b, S 4096 a rank: 0.21 and 0.28 ms at 989
// TFLOP/s), far above the bytes of q, k, v, do and the fp32 sums.  So the
// design keeps the tensor cores fed and every score tile in registers:
//  * persistent kernels of three warpgroups, one block an SM walking work
//    items; rounds of items alternate direction over the blocks (`snake`),
//    so a block that took one of the longest walks first takes one of the
//    shortest next.  The producer (one thread; setmaxnreg hands its
//    registers to the consumers) loads through TMA what the item keeps for
//    its whole walk once, and the walked tiles into a ring of stages, each
//    behind its own mbarrier; the consumers release a stage by an mbarrier,
//    with no __syncthreads.  Operands are 4-D tensor maps over the
//    [B, H, S, D] views in place, 64-column boxes with 128-byte swizzle;
//    rows past S are TMA's zero fill, and the mask zeroes their p.
//  * dq (attn_bwd_dq_wgmma_kernel): an item is a 128-row query tile (two
//    consumer warpgroups of 64 rows) of one query head and batch, taken
//    longest causal walk first; it keeps Q and dO and walks 64-key tiles of
//    K and V.  Per key tile, each consumer: S = Q.K^T and dP = dO.V^T by
//    wgmma from shared memory (both K-major) into registers; p and ds in
//    registers against its two rows' lse and delta (held for the item); ds
//    rounded to bf16 in registers, where the accumulator's layout is
//    already the A fragment; dQ += dS.K by wgmma with K read MN-major from
//    the same shared tile (the transpose bit: no second copy of K).  dq
//    lives in registers for the item, seeded from and written back to the
//    fp32 buffer as 8-byte accesses in the fragment's layout.  Registers a
//    consumer thread at D 128: S 32 + dP 32 + dq 64 + dS 16 fp32/bf16x2.
//  * dk/dv (attn_bwd_dkv_wgmma_kernel): an item is a 128-key tile (two
//    consumer warpgroups of 64 keys) of one KV head and batch, low key
//    tiles (the longest causal walks) first; it keeps K and V and walks its
//    GQA group's query heads and their live 64-row query tiles itself, so
//    the block owns its output tile: no atomics.  Per query tile, each
//    consumer: S^T = K.Q^T and dP^T = V.dO^T by wgmma (K-major) with the
//    query tile as wgmma's N; P^T and dS^T in registers against the query
//    columns' lse and delta, which the producer loads beside the Q tile
//    (1-D tensor maps over the flat [B * Hq * S] rows: the columns of a
//    tail tile past S read the next head's values, finite, and the mask
//    zeroes their p; past the array's end TMA fills zeros); dV += P^T.dO
//    and dK += dS^T.Q by
//    wgmma with dO and Q read MN-major from the tiles that fed the first
//    two products.  Registers a consumer thread at D 128: dK 64 + dV 64 +
//    S^T 32 + dP^T 32 + P^T 16 + dS^T 16; the score products zero their
//    accumulators by wgmma's scale-d (wgmma_ss_n64 without ACC), so no
//    score register is live across the dK/dV products, and the query tile
//    is 64 wide to stay inside the 240 registers setmaxnreg gives.
//  * the mask policy is the walk's, as in the forward: k_begin/k_end (dq)
//    and q_begin/q_end (dk/dv) bound the tiles, dead tiles are never
//    visited, ok masks diagonal and edge tiles in registers, and `full`
//    sends interior tiles down a body compiled without the test.  An item
//    with no live tile reads and writes nothing, so its rows of dq, dk, dv
//    stay bit for bit as they were.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a view TMA cannot take or
// a tensor map cuTensorMapEncodeTiled refuses).

#pragma once

#include "attention_wgmma.cuh"

namespace flash_wg {

constexpr int kBKd = 64;                // dq: keys a tile
constexpr int kBQd = 64;                // dk/dv: query rows a tile
constexpr uint32_t kBox64 = 64 * 128;   // one 64-column box of 64 rows, bytes

template <int D>
struct BwdLayout {
  static constexpr int kBoxes = D / 64;
  static constexpr uint32_t kWide = kBoxes * kBox;      // a 128-row tile
  static constexpr uint32_t kNarrow = kBoxes * kBox64;  // a 64-row tile
  static constexpr int kStages = 4;
  // 1024 to align; Q and dO (128 rows); the ring of K and V (64 rows); the
  // Q-full, Q-empty, K-full, V-full and empty barriers
  static constexpr size_t kDqSmem =
      1024 + 2 * kWide + 2 * kStages * kNarrow + (2 + 3 * kStages) * sizeof(uint64_t);
  // 1024 to align; K and V (128 rows); the ring of Q and dO (64 rows) and
  // of the query rows' lse and delta; the KV-full, KV-empty, full and
  // empty barriers
  static constexpr size_t kDkvSmem = 1024 + 2 * kWide + 2 * kStages * kNarrow +
                                     kStages * 2 * kBQd * sizeof(float) +
                                     (2 + 2 * kStages) * sizeof(uint64_t);
};

// item of round r for block x of G: even rounds run up, odd rounds down
__device__ __forceinline__ int snake(int r, int x, int G) {
  return r * G + ((r & 1) ? G - 1 - x : x);
}

// Work item i (of nk * Hkv * B) of dk/dv: key tile i / (Hkv * B), KV head
// (i % (Hkv * B)) % Hkv, batch (i % (Hkv * B)) / Hkv: low key tiles, the
// longest causal walks, first.
struct KvItem {
  int ik, hk, b;
  __device__ KvItem(int i, int Hkv, int B)
      : ik(i / (Hkv * B)), hk((i % (Hkv * B)) % Hkv), b((i % (Hkv * B)) / Hkv) {}
};

// dX += A . B for the fp32 sums of the backward: A (bf16, 64 x 16) from
// registers, B MN-major from shared memory (the D/64 boxes of a 64-row tile)
template <int D>
__device__ __forceinline__ void sum_mma(float (&d)[D / 2], const uint32_t (&a)[4], uint32_t addr) {
  const uint64_t db = hopper::desc_sw128(addr, kBox64, kAtomRows);
  if constexpr (D == 128)
    hopper::wgmma_rs_n128<1>(d, a, db, 1);
  else
    hopper::wgmma_rs_n64<1>(d, a, db, 1);
}

// C[64 x 64] = A . B^T over the D columns of two K-major tiles in shared
// memory: A's rows in boxes of a_box bytes, B's 64 rows in boxes of kBox64
template <int D>
__device__ __forceinline__ void scores(float (&c)[32], uint32_t a, uint32_t a_box, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(a + (kk / 4) * a_box + (kk % 4) * 32, 16, kAtomRows);
    const uint64_t db = hopper::desc_sw128(b + (kk / 4) * kBox64 + (kk % 4) * 32, 16, kAtomRows);
    if (kk == 0)
      hopper::wgmma_ss_n64<0, 0, false>(c, da, db);
    else
      hopper::wgmma_ss_n64<0, 0, true>(c, da, db);
  }
}

// Loads the fp32 rows `row` of a [.., S, D] sum into the accumulator
// fragment (columns 8j + 2t, + 1), 0 past S; and stores them back.
template <int D>
__device__ __forceinline__ void seed_rows(float (&acc)[D / 2], const float* base, long long ss,
                                          const int (&row)[2], int S, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* src = base + static_cast<long long>(row[r]) * ss + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 a = row[r] < S ? *reinterpret_cast<const float2*>(src + 8 * j)
                                  : make_float2(0.f, 0.f);
      acc[4 * j + 2 * r] = a.x;
      acc[4 * j + 2 * r + 1] = a.y;
    }
  }
}
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float* base, long long ss,
                                           const int (&row)[2], int S, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    float* dst = base + static_cast<long long>(row[r]) * ss + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
template <int D, typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, Strides4 sdq,
                         int B, int Hq, int Hkv, int S, float scale, Mask mask) {
  using L = BwdLayout<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* dos = qs + L::kWide;
  unsigned char* ks = dos + L::kWide;  // stage s: ks + s * kNarrow
  unsigned char* vs = ks + L::kStages * L::kNarrow;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + L::kStages * L::kNarrow);
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
    // producer: one thread issues every load; the next item's Q, dO and
    // first tiles load while the consumers finish this one
    reg_dealloc<24>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0, n = 0;; ++r) {
        const int i = snake(r, blockIdx.x, gridDim.x);
        if (i >= items) break;
        const Item it(i, nq, Hq, B);
        const int t_begin = mask.k_begin(it.h, it.iq), t_end = mask.k_end(it.h, it.iq);
        if (t_begin >= t_end) continue;  // a dead item reads nothing
        const int hk = it.h / (Hq / Hkv);
        mbar_wait(q_empty, (n++ & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::kWide);
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j) {
          tma_load_4d(qs + j * kBox, &map_q, q_full, 64 * j, it.iq * kBQ, it.h, it.b);
          tma_load_4d(dos + j * kBox, &map_do, q_full, 64 * j, it.iq * kBQ, it.h, it.b);
        }
        for (int t = t_begin; t < t_end; ++t) {
          const int k0 = mask.k_tile(t) * kBKd;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* kt = ks + stage * L::kNarrow;
          unsigned char* vt = vs + stage * L::kNarrow;
          mbar_expect_tx(&k_full[stage], L::kNarrow);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            tma_load_4d(kt + j * kBox64, &map_k, &k_full[stage], 64 * j, k0, hk, it.b);
          mbar_expect_tx(&v_full[stage], L::kNarrow);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            tma_load_4d(vt + j * kBox64, &map_v, &v_full[stage], 64 * j, k0, hk, it.b);
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
  const uint32_t do_addr = smem_addr(dos) + wgi * 8192;
  float s_acc[kBKd / 2], dp_acc[kBKd / 2], dq_acc[D / 2];
  uint32_t ds[kBKd / 16][4];  // dS in bf16: the A fragments of the k16 steps of dS.K
  int stage = 0;
  uint32_t phase = 0;
  for (int r = 0, n = 0;; ++r) {
    const int i = snake(r, blockIdx.x, gridDim.x);
    if (i >= items) break;
    const Item it(i, nq, Hq, B);
    const int h = it.h;
    const int t_begin = mask.k_begin(h, it.iq), t_end = mask.k_end(h, it.iq);
    if (t_begin >= t_end) continue;  // nothing read, nothing written
    const int rq0 = it.iq * kBQ + 64 * wgi;  // this warpgroup's first row
    const int row[2] = {rq0 + 16 * w + g, rq0 + 16 * w + g + 8};
    const long long row_off = (static_cast<long long>(it.b) * Hq + h) * S;
    float lse2[2], dl[2];  // each row's lse * log2 e and delta; 0 past S
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      lse2[x] = row[x] < S ? lse[row_off + row[x]] * kLog2e : 0.f;
      dl[x] = row[x] < S ? delta[row_off + row[x]] : 0.f;
    }
    float* dq_b = dq + it.b * sdq.b + h * sdq.h;
    seed_rows<D>(dq_acc, dq_b, sdq.s, row, S, tq);

    // p and ds of the finished S and dP of key tile k0, in registers:
    // s_acc[4j + e] is row row[e / 2], key k0 + 8j + 2tq + (e % 2).  MASKED
    // (diagonal, edge and tail tiles) tests every entry against the mask.
    auto dscore = [&](auto masked, int k0) {
      constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < kBKd / 8; ++j) {
        float de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s_acc[4 * j + e], scale_log2, -lse2[e / 2]));
          if constexpr (MASKED)
            p = mask.ok(h, row[e / 2], k0 + 8 * j + 2 * tq + (e % 2)) ? p : 0.f;
          de[e] = p * (dp_acc[4 * j + e] - dl[e / 2]) * scale;
        }
        ds[j / 2][2 * (j % 2)] = pack_bf16(de[0], de[1]);
        ds[j / 2][2 * (j % 2) + 1] = pack_bf16(de[2], de[3]);
      }
    };

    mbar_wait(q_full, n++ & 1);
    for (int t = t_begin; t < t_end; ++t) {
      const int k0 = mask.k_tile(t) * kBKd;
      const uint32_t k_addr = smem_addr(ks + stage * L::kNarrow);
      const uint32_t v_addr = smem_addr(vs + stage * L::kNarrow);
      // S = Q . K^T and dP = dO . V^T, D/16 steps of 16 each
      mbar_wait(&k_full[stage], phase);
      mbar_wait(&v_full[stage], phase);
      wgmma_fence();
      scores<D>(s_acc, q_addr, kBox, k_addr);
      scores<D>(dp_acc, do_addr, kBox, v_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (t + 1 == t_end) mbar_arrive(q_empty);  // Q and dO are read: the next item's may load

      if (mask.full(h, rq0, 64, k0, kBKd))
        dscore(std::false_type{}, k0);
      else
        dscore(std::true_type{}, k0);

      // dQ += dS . K: K is MN-major (rows are keys, D contiguous), 16 keys a step
      fence_regs(ds);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBKd / 16; ++kc) sum_mma<D>(dq_acc, ds[kc], k_addr + kc * 2048);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(ds);
      mbar_arrive(&empty[stage]);  // K and V of this tile are consumed
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_rows<D>(dq_acc, dq_b, sdq.s, row, S, tq);
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------
template <int D, typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_lse,
                          const __grid_constant__ CUtensorMap map_delta, float* __restrict__ dk,
                          float* __restrict__ dv, Strides4 sdk, Strides4 sdv, int B, int Hq,
                          int Hkv, int S, float scale, Mask mask) {
  using L = BwdLayout<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* vs = ks + L::kWide;
  unsigned char* qs = vs + L::kWide;  // stage s: qs + s * kNarrow
  unsigned char* dos = qs + L::kStages * L::kNarrow;
  float* lds = reinterpret_cast<float*>(dos + L::kStages * L::kNarrow);  // stage s: lds + 2 s kBQd
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lds + L::kStages * 2 * kBQd);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + L::kStages;

  const int nk = (S + kBK - 1) / kBK, items = nk * Hkv * B, group = Hq / Hkv;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  // an item with no live query tile in any head of its group is dead
  auto live = [&](const KvItem& it) {
    for (int g = 0; g < group; ++g) {
      const int h = it.hk * group + g;
      if (mask.q_begin(h, it.ik) < mask.q_end(h, it.ik)) return true;
    }
    return false;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers * 128);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // producer: one thread issues every load; the next item's K and V
    // load while the consumers finish this one
    reg_dealloc<24>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0, n = 0;; ++r) {
        const int i = snake(r, blockIdx.x, gridDim.x);
        if (i >= items) break;
        const KvItem it(i, Hkv, B);
        if (!live(it)) continue;  // a dead item reads nothing
        mbar_wait(kv_empty, (n++ & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * L::kWide);
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j) {
          tma_load_4d(ks + j * kBox, &map_k, kv_full, 64 * j, it.ik * kBK, it.hk, it.b);
          tma_load_4d(vs + j * kBox, &map_v, kv_full, 64 * j, it.ik * kBK, it.hk, it.b);
        }
        for (int g = 0; g < group; ++g) {
          const int h = it.hk * group + g;
          const int row_off = (it.b * Hq + h) * S;  // < 2^31: the launcher checks
          const int t_end = mask.q_end(h, it.ik);
          for (int t = mask.q_begin(h, it.ik); t < t_end; ++t) {
            const int q0 = mask.q_tile(t) * kBQd;
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], 2 * L::kNarrow + 2 * kBQd * sizeof(float));
            unsigned char* qt = qs + stage * L::kNarrow;
            unsigned char* dt = dos + stage * L::kNarrow;
#pragma unroll
            for (int j = 0; j < L::kBoxes; ++j) {
              tma_load_4d(qt + j * kBox64, &map_q, &full[stage], 64 * j, q0, h, it.b);
              tma_load_4d(dt + j * kBox64, &map_do, &full[stage], 64 * j, q0, h, it.b);
            }
            float* ld = lds + stage * 2 * kBQd;
            tma_load_1d(ld, &map_lse, &full[stage], row_off + q0);
            tma_load_1d(ld + kBQd, &map_delta, &full[stage], row_off + q0);
            if (++stage == L::kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wgi: keys 64 wgi .. 64 wgi + 63 of each item
  reg_alloc<240>();
  const int w = tid / 32, lane = tid % 32, g8 = lane / 4, tq = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_addr = smem_addr(ks) + wgi * 8192;  // this warpgroup's 64 rows of each box
  const uint32_t v_addr = smem_addr(vs) + wgi * 8192;
  float st[kBQd / 2], dpt[kBQd / 2], dk_acc[D / 2], dv_acc[D / 2];
  uint32_t pf[kBQd / 16][4], dsf[kBQd / 16][4];  // P^T, dS^T in bf16: A fragments
  int stage = 0;
  uint32_t phase = 0;
  for (int r = 0, n = 0;; ++r) {
    const int i = snake(r, blockIdx.x, gridDim.x);
    if (i >= items) break;
    const KvItem it(i, Hkv, B);
    if (!live(it)) continue;  // nothing read, nothing written
    const int kr0 = it.ik * kBK + 64 * wgi;  // this warpgroup's first key
    const int key[2] = {kr0 + 16 * w + g8, kr0 + 16 * w + g8 + 8};
    float* dk_b = dk + it.b * sdk.b + it.hk * sdk.h;
    float* dv_b = dv + it.b * sdv.b + it.hk * sdv.h;
    seed_rows<D>(dk_acc, dk_b, sdk.s, key, S, tq);
    seed_rows<D>(dv_acc, dv_b, sdv.s, key, S, tq);
    mbar_wait(kv_full, n++ & 1);

    for (int g = 0; g < group; ++g) {
      const int h = it.hk * group + g;
      // P^T and dS^T of the finished S^T and dP^T of query tile q0:
      // st[4j + e] is key key[e / 2], query q0 + 8j + 2tq + (e % 2), whose
      // lse and delta the producer left in ld
      auto dscore = [&](auto masked, int q0, const float* ld) {
        constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < kBQd / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const float2 l2 = *reinterpret_cast<const float2*>(ld + c);
          const float2 d2 = *reinterpret_cast<const float2*>(ld + kBQd + c);
          const float lq2[2] = {l2.x * kLog2e, l2.y * kLog2e};
          float pe[4], de[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lq = lq2[e % 2], dq_ = e % 2 ? d2.y : d2.x;
            float p = exp2f(fmaf(st[4 * j + e], scale_log2, -lq));
            if constexpr (MASKED) p = mask.ok(h, q0 + c + (e % 2), key[e / 2]) ? p : 0.f;
            pe[e] = p;
            de[e] = p * (dpt[4 * j + e] - dq_) * scale;
          }
          pf[j / 2][2 * (j % 2)] = pack_bf16(pe[0], pe[1]);
          pf[j / 2][2 * (j % 2) + 1] = pack_bf16(pe[2], pe[3]);
          dsf[j / 2][2 * (j % 2)] = pack_bf16(de[0], de[1]);
          dsf[j / 2][2 * (j % 2) + 1] = pack_bf16(de[2], de[3]);
        }
      };

      const int t_end = mask.q_end(h, it.ik);
      for (int t = mask.q_begin(h, it.ik); t < t_end; ++t) {
        const int q0 = mask.q_tile(t) * kBQd;
        const uint32_t q_addr = smem_addr(qs + stage * L::kNarrow);
        const uint32_t do_addr = smem_addr(dos + stage * L::kNarrow);
        // S^T = K . Q^T and dP^T = V . dO^T, D/16 steps of 16 each
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        scores<D>(st, k_addr, kBox, q_addr);
        scores<D>(dpt, v_addr, kBox, do_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        const float* ld = lds + stage * 2 * kBQd;
        if (mask.full(h, q0, kBQd, kr0, 64))
          dscore(std::false_type{}, q0, ld);
        else
          dscore(std::true_type{}, q0, ld);

        // dV += P^T . dO and dK += dS^T . Q: dO and Q MN-major, 16 query rows a step
        fence_regs(pf);
        fence_regs(dsf);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kBQd / 16; ++kc) sum_mma<D>(dv_acc, pf[kc], do_addr + kc * 2048);
#pragma unroll
        for (int kc = 0; kc < kBQd / 16; ++kc) sum_mma<D>(dk_acc, dsf[kc], q_addr + kc * 2048);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pf);
        fence_regs(dsf);
        mbar_arrive(&empty[stage]);  // Q, dO, lse and delta of this tile are consumed
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    mbar_arrive(kv_empty);  // K and V are read: the next item's may load
    store_rows<D>(dk_acc, dk_b, sdk.s, key, S, tq);
    store_rows<D>(dv_acc, dv_b, sdv.s, key, S, tq);
  }
}

// strides: (b, h, s) of q, k, v, do, dq in that order
template <int D, typename Mask>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* delta, float* dq, const long long* strides, int B, int Hq, int Hkv,
                  int S, float scale, Mask mask, cudaStream_t stream) {
  if (B < 0 || S < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  CUtensorMap mq, mk, mv, mdo;
  if (!attn_map(&mq, q, B, Hq, S, D, strides, kBQ) ||
      !attn_map(&mk, k, B, Hkv, S, D, strides + 3, kBKd) ||
      !attn_map(&mv, v, B, Hkv, S, D, strides + 6, kBKd) ||
      !attn_map(&mdo, dout, B, Hq, S, D, strides + 9, kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dq) % 8 != 0)  // 8-byte sum loads
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_bwd_dq_wgmma_kernel<D, Mask>;
  constexpr size_t smem = BwdLayout<D>::kDqSmem;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides4 sdq{strides[12], strides[13], strides[14]};
  const int items = (S + kBQ - 1) / kBQ * Hq * B;  // persistent: one block an SM at most
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, lse, delta, dq, sdq, B, Hq, Hkv, S,
                                         scale, mask);
  return static_cast<int>(cudaGetLastError());
}

// strides: (b, h, s) of q, k, v, do, dk, dv in that order
template <int D, typename Mask>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, float* dk, float* dv, const long long* strides, int B,
                   int Hq, int Hkv, int S, float scale, Mask mask, cudaStream_t stream) {
  if (B < 0 || S < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  CUtensorMap mq, mk, mv, mdo;
  if (!attn_map(&mq, q, B, Hq, S, D, strides, kBQd) ||
      !attn_map(&mk, k, B, Hkv, S, D, strides + 3, kBK) ||
      !attn_map(&mv, v, B, Hkv, S, D, strides + 6, kBK) ||
      !attn_map(&mdo, dout, B, Hq, S, D, strides + 9, kBQd))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dk) % 8 != 0 || reinterpret_cast<uintptr_t>(dv) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // lse and delta: 1-D maps over the B * Hq * S rows, 64 a box, 32-bit coordinates
  const long long rows = static_cast<long long>(B) * Hq * S;
  if (rows + kBQd >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ml, md;
  const uint64_t dims[1] = {static_cast<uint64_t>(rows)};
  const uint64_t unused[1] = {0};
  const uint32_t box[1] = {static_cast<uint32_t>(kBQd)};
  if (!hopper_host::encode_f32(&ml, lse, 1, dims, unused, box) ||
      !hopper_host::encode_f32(&md, delta, 1, dims, unused, box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_bwd_dkv_wgmma_kernel<D, Mask>;
  constexpr size_t smem = BwdLayout<D>::kDkvSmem;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides4 sdk{strides[12], strides[13], strides[14]};
  const Strides4 sdv{strides[15], strides[16], strides[17]};
  const int items = (S + kBK - 1) / kBK * Hkv * B;
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, ml, md, dk, dv, sdk, sdv, B, Hq, Hkv, S,
                                         scale, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_wg
