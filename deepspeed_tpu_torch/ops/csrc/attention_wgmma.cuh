// Attention forward on wgmma and TMA, Hopper: the dense `flash_fwd`, the
// ring hop's `ring_carry` and the block-sparse `bsa_fwd` at bf16, and the
// ring hop's int8 K/V lane `ring_carry_s8` (bf16 q).
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
//    these tile sizes.  A policy with a per-tile view (`tile`, the
//    block-sparse layout's words) is asked for it once a tile, before the
//    tile's product, and the view answers `ok` and `full` for that tile.
//  * accumulate mode (template flag ACC, `ring_carry`, the counterpart of
//    the tile walk's ACC in attention_tiles.cuh): an item starts from the
//    fp32 state of its rows, m and l [B, Hq, S] and acc [B, Hq, S, D]
//    (each consumer thread loads its rows' m and l and its accumulator
//    fragment, columns 8j + 2t and + 1, as 8-byte loads), walks its live
//    key tiles and writes the state back unnormalised: no o, no lse.  m is
//    kept in the tile walk's units (the running max of the scaled scores,
//    natural log), so hops on either route compose.  Rows at or past S are
//    never read or written, and an item with no live key tile leaves its
//    rows untouched.
//  * the int8 K/V lane (template flag Q8, attn_fwd_wgmma_s8_kernel,
//    `ring_carry_s8` on the quantized ring wire; accumulate mode only): K/V
//    arrive as int8 payload rows with one fp32 scale a row, and the
//    products still read bf16 tiles from the same swizzled stages, so the
//    producer warpgroup widens them.  Its first thread loads by TMA each
//    tile's K, then V, as int8 rows (boxes of D bytes x 128 rows) with the
//    tile's row scales (a 1-D box from the 16-byte boundary at or before
//    the tile's first row, as the dk/dv walk's lse boxes) into a ring of
//    slots; its other three warps widen a slot into the bf16 stage, in the
//    layout TMA's 128-byte swizzle gives the bf16 lane (exact: an int8 is
//    the low mantissa byte of a magic fp32, whose high half is its bf16),
//    copy the scales beside it, fence the proxy and arrive on the stage's
//    K-full or V-full barrier, which counts those 96 threads where the bf16
//    lane counts TMA's bytes.  The consumers are the bf16 lane's but for
//    the scales, which sit on the key axis: each S accumulator column is
//    multiplied by its key's K scale before the online softmax (l sums p as
//    it is), and P.V takes p times its key's V scale as two bf16 parts, hi
//    = bf16(x) and lo = bf16(x - hi), two wgmma_rs products on the same V
//    tile, about 16 bits of the fp32 factor the JAX lane keeps.  Shared
//    memory: Q, the bf16 stages and, in the output staging tile's room and
//    beyond, the stages' scales and 3 slots of 16.6 KiB at D 128 (213 KiB;
//    4 slots of 8.6 KiB at D 64); registers: the producer warpgroup keeps 56
//    a thread for the widening (at 40 or 48 ptxas spills there), the
//    consumers 224 (S 64 + o 64 + p hi and lo 64 fp32/bf16x2 at D 128).
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
  static constexpr uint32_t kBars = (2 + 2 * kStages) * kTileBytes;  // from the aligned base
  static constexpr size_t kSmem = 1024 + kBars + (2 + 3 * kStages) * sizeof(uint64_t);
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

// What a walked tile's `full` and `ok` are asked of: the policy narrowed to
// tile t (its `tile` member, see
// block_sparse_attention.cu's BlockLayoutT) or the policy itself
template <typename M, typename = void>
struct HasTile : std::false_type {};
template <typename M>
struct HasTile<M, std::void_t<decltype(&M::tile)>> : std::true_type {};

template <typename Mask>
__device__ __forceinline__ decltype(auto) tile_of(const Mask& mask, int h, int t, int walk0,
                                                  int sub0, const int (&fixed)[2]) {
  if constexpr (HasTile<Mask>::value)
    return mask.tile(h, t, walk0, sub0, fixed);
  else
    return (mask);
}

// Work item i (of nq * Hq * B): query tile nq - 1 - i / (Hq * B), head
// (i % (Hq * B)) % Hq, batch (i % (Hq * B)) / Hq: the longest causal walks
// first, and neighbouring items share a query tile's length.
struct Item {
  int iq, h, b;
  __device__ Item(int i, int nq, int Hq, int B)
      : iq(nq - 1 - i / (Hq * B)), h((i % (Hq * B)) % Hq), b((i % (Hq * B)) / Hq) {}
};

// The int8 K/V lane (Q8): shared memory of the forward over int8 payloads
// in accumulate mode.  The bf16 ring of K/V stages stays (the tiles the
// consumers' products read, widened there by the producer warpgroup); the
// output's staging tile is not needed (accumulate mode writes fp32 from
// registers), so its room and more holds the tiles' key scales and a ring
// of int8 slots that TMA fills: one operand (K or V) of one key tile each,
// kBK payload rows of D bytes and the tile's row scales (a 1-D box of kScBox
// floats from the 16-byte boundary at or before the tile's first row).
template <int D>
struct LayoutS8 : Layout<D> {
  using Layout<D>::kTileBytes;
  using Layout<D>::kStages;
  static constexpr int kSlots = D == 64 ? 4 : 3;     // int8 operands in flight
  static constexpr int kScBox = kBK + 4;
  static constexpr uint32_t kSlotRows = kBK * D;     // payload bytes of a slot
  static constexpr uint32_t kSlotBytes = kSlotRows + 640;  // + the scale box, 128-byte aligned
  // byte offsets from the aligned base: Q; the ring of K and V; the stages'
  // key scales (K's, then V's, kBK floats a stage); the slots; the Q-full,
  // Q-empty, K-full, V-full, empty, slot-full and slot-empty barriers
  static constexpr uint32_t kScales = (1 + 2 * kStages) * kTileBytes;
  static constexpr uint32_t kSlotBase = kScales + 2 * kStages * kBK * sizeof(float);
  static constexpr uint32_t kBars = kSlotBase + kSlots * kSlotBytes;
  static constexpr size_t kSmem = 1024 + kBars + (2 + 3 * kStages + 2 * kSlots) * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "the int8 forward overruns shared memory");
};

// threads of the producer warpgroup that widen int8 tiles (its warps 1-3;
// warp 0's first thread issues the loads)
constexpr int kWideners = 96;

// Four int8 (a word, byte 0 first) widened to bf16, exactly: each byte,
// offset by 128, is the low mantissa byte of the fp32 2^23 + (x + 128), less
// 2^23 + 128 that is x; an integer of at most 8 bits has a zero low half in
// fp32, so its high half is its bf16.  Returns (x0, x1) and (x2, x3) packed.
__device__ __forceinline__ uint2 widen_s8x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}

// 16 int8 of a row, columns 16c .. 16c + 15, widened into row r of a tile of
// 64-column bf16 boxes with 128-byte swizzle at shared address dst (what
// TMA writes: the 16-byte chunk j of a box row at chunk j ^ (r % 8)); box_bytes
// is the box's size (its rows x 128)
__device__ __forceinline__ void store_widened(uint32_t dst, uint32_t box_bytes, int r, int c,
                                              uint4 raw) {
  const uint2 a = widen_s8x4(raw.x), b = widen_s8x4(raw.y), e = widen_s8x4(raw.z),
              f = widen_s8x4(raw.w);
  const int ch = 2 * (c % 4);  // the first column's 8-column chunk within its box
  const uint32_t row = dst + (c / 4) * box_bytes + r * 128;
  hopper::sts_v4(row + ((ch ^ (r & 7)) << 4), make_uint4(a.x, a.y, b.x, b.y));
  hopper::sts_v4(row + (((ch + 1) ^ (r & 7)) << 4), make_uint4(e.x, e.y, f.x, f.y));
}

// An int8 lane's slot (Q8): one operand (K or V) of one key tile of ROWS
// keys, its payload rows (D bytes each) and after them its row scales, a
// 1-D box of ROWS + 4 floats from the 16-byte boundary at or before the
// tile's first row (c0), since TMA faults on any other start.  load_slot:
// one thread loads both by TMA onto the slot's full barrier.  widen_slot:
// thread u of the kWideners widens the rows into the tile's bf16 stage at
// shared address dst (64-column boxes of ROWS rows, 128-byte swizzle) and
// copies the tile's scales, `off` floats into the box, to sd.
template <int D, int ROWS>
__device__ __forceinline__ void load_slot(unsigned char* sb, const CUtensorMap* map,
                                          const CUtensorMap* map_sc, uint64_t* full, int k0,
                                          int hk, int b, int c0) {
  hopper::mbar_expect_tx(full, ROWS * D + (ROWS + 4) * sizeof(float));
  hopper::tma_load_4d(sb, map, full, 0, k0, hk, b);
  hopper::tma_load_1d(sb + ROWS * D, map_sc, full, c0);
}
template <int D, int ROWS>
__device__ __forceinline__ void widen_slot(const unsigned char* sb, uint32_t dst, float* sd,
                                           int off, int u) {
  constexpr int kPerRow = D / 16;
  const uint32_t src = hopper::smem_addr(sb);
  for (int x = u; x < ROWS * kPerRow; x += kWideners)
    store_widened(dst, ROWS * 128, x / kPerRow, x % kPerRow, hopper::lds_v4(src + 16 * x));
  const float* sc = reinterpret_cast<const float*>(sb + ROWS * D) + off;
  for (int c = u; c < ROWS; c += kWideners) sd[c] = sc[c];
}

// x in two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), for a pair: the
// A-fragment words (a, b) of the hi and of the lo product
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// ACC: lse is m, and l_io, acc_io (strides so, in o's place) carry the
// running state in and out; o is not written.  Q8 (accumulate mode only):
// map_k, map_v are int8 maps over the payloads (boxes of D bytes x kBK rows)
// and map_ks, map_vs 1-D fp32 maps over the row scales (kScBox a box).
template <int D, typename Mask, bool ACC, bool Q8>
__device__ __forceinline__ void attn_fwd_wgmma_body(
    const CUtensorMap* map_q, const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_ks, const CUtensorMap* map_vs, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, float* __restrict__ l_io, float* __restrict__ acc_io, Strides4 so,
    int B, int Hq, int Hkv, int S, float scale, Mask mask) {
  static_assert(ACC || !Q8, "the int8 lane runs in accumulate mode");
  using L = std::conditional_t<Q8, LayoutS8<D>, Layout<D>>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ks = qs + L::kTileBytes;             // stage s: ks + s * kTileBytes
  unsigned char* vs = ks + L::kStages * L::kTileBytes;
  unsigned char* os = vs + L::kStages * L::kTileBytes;  // the output's staging tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(qs + L::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;
  // Q8: stage s's key scales at ksc + s * kBK (K's) and vsc + s * kBK (V's);
  // the int8 slots and their full and empty barriers
  float* ksc = reinterpret_cast<float*>(os);
  float* vsc = ksc + L::kStages * kBK;
  uint64_t* slot_full = empty + L::kStages;
  uint64_t* slot_empty = nullptr;
  unsigned char* slots = nullptr;
  if constexpr (Q8) {
    slot_empty = slot_full + L::kSlots;
    slots = qs + L::kSlotBase;
  }

  const int nq = (S + kBQ - 1) / kBQ, items = nq * Hq * B;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 128);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&k_full[s], Q8 ? kWideners : 1);
      mbar_init(&v_full[s], Q8 ? kWideners : 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    if constexpr (Q8) {
      for (int s = 0; s < L::kSlots; ++s) {
        mbar_init(&slot_full[s], 1);
        mbar_init(&slot_empty[s], kWideners);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // producer: one thread issues every load, item after item; the next
    // item's Q and first tiles load while the consumers finish this one
    reg_dealloc<Q8 ? 56 : 24>();
    if constexpr (Q8) {
      if (tid == 0) {
        // Q as bf16; each key tile's K, then V, as int8 rows and their
        // scales into the slots
        int slot = 0;
        uint32_t sphase = 0;
        for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
          const Item it(i, nq, Hq, B);
          const int hk = it.h / (Hq / Hkv);
          const int kv_row0 = (it.b * Hkv + hk) * S;  // < 2^31: the launcher checks
          mbar_wait(q_empty, (n & 1) ^ 1);
          mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            tma_load_4d(qs + j * kBox, map_q, q_full, 64 * j, it.iq * kBQ, it.h, it.b);
          const int t_end = mask.k_end(it.h, it.iq);
          for (int t = mask.k_begin(it.h, it.iq); t < t_end; ++t) {
            const int k0 = mask.k_tile(t) * kBK;
            const int c0 = (kv_row0 + k0) & ~3;  // 16-byte aligned
#pragma unroll
            for (int op = 0; op < 2; ++op) {
              mbar_wait(&slot_empty[slot], sphase ^ 1);
              load_slot<D, kBK>(slots + slot * L::kSlotBytes, op ? map_v : map_k,
                                op ? map_vs : map_ks, &slot_full[slot], k0, hk, it.b, c0);
              if (++slot == L::kSlots) {
                slot = 0;
                sphase ^= 1;
              }
            }
          }
        }
      } else if (tid >= 32) {
        // widening warps: each slot's int8 rows into the bf16 stage of its
        // tile, in the swizzled layout TMA gives the bf16 lane, and its
        // scales beside; the stage's K-full (V-full) barrier counts these
        // threads' arrivals, each after its proxy fence
        const int u = tid - 32;
        int stage = 0, slot = 0;
        uint32_t phase = 0, sphase = 0;
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
          const Item it(i, nq, Hq, B);
          const int hk = it.h / (Hq / Hkv);
          const int kv_row0 = (it.b * Hkv + hk) * S;
          const int t_end = mask.k_end(it.h, it.iq);
          for (int t = mask.k_begin(it.h, it.iq); t < t_end; ++t) {
            const int off = (kv_row0 + mask.k_tile(t) * kBK) & 3;  // the tile's first row in its box
            mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
            for (int op = 0; op < 2; ++op) {
              mbar_wait(&slot_full[slot], sphase);
              widen_slot<D, kBK>(slots + slot * L::kSlotBytes,
                                 smem_addr((op ? vs : ks) + stage * L::kTileBytes),
                                 (op ? vsc : ksc) + stage * kBK, off, u);
              fence_proxy_async();
              mbar_arrive(op ? &v_full[stage] : &k_full[stage]);
              mbar_arrive(&slot_empty[slot]);  // the slot is read
              if (++slot == L::kSlots) {
                slot = 0;
                sphase ^= 1;
              }
            }
            if (++stage == L::kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
        const Item it(i, nq, Hq, B);
        const int hk = it.h / (Hq / Hkv);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j)
          tma_load_4d(qs + j * kBox, map_q, q_full, 64 * j, it.iq * kBQ, it.h, it.b);
        const int t_end = mask.k_end(it.h, it.iq);
        for (int t = mask.k_begin(it.h, it.iq); t < t_end; ++t) {
          const int k0 = mask.k_tile(t) * kBK;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* kt = ks + stage * L::kTileBytes;
          unsigned char* vt = vs + stage * L::kTileBytes;
          mbar_expect_tx(&k_full[stage], L::kTileBytes);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            tma_load_4d(kt + j * kBox, map_k, &k_full[stage], 64 * j, k0, hk, it.b);
          mbar_expect_tx(&v_full[stage], L::kTileBytes);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j)
            tma_load_4d(vt + j * kBox, map_v, &v_full[stage], 64 * j, k0, hk, it.b);
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
  reg_alloc<Q8 ? 224 : 240>();
  const int w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_addr(qs) + wgi * 8192;  // this warpgroup's 64 rows of each box
  unsigned char* stage_o = os + wgi * 8192;            // likewise in the staging tile
  float s_acc[kBK / 2];
  float o_acc[D / 2];
  uint32_t p[kBK / 16][4];  // p in bf16: the A fragments of the k16 steps of P.V
  // Q8: p vs[j] is split, p holding its hi parts and p_lo its lo parts
  uint32_t p_lo[Q8 ? kBK / 16 : 1][4];
  const float* vsc_t = vsc;  // Q8: the V scales of the tile in hand
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
    const long long row_off = (static_cast<long long>(it.b) * Hq + h) * S;
    float* acc_b = ACC ? acc_io + it.b * so.b + h * so.h : nullptr;
    if constexpr (ACC) {
      if (t_begin < t_end) {  // seed from the carried state
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (row[r] >= S) continue;
          m_run[r] = lse[row_off + row[r]];
          l_run[r] = l_io[row_off + row[r]];
          const float* src = acc_b + static_cast<long long>(row[r]) * so.s + 2 * tq;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const float2 a = *reinterpret_cast<const float2*>(src + 8 * j);
            o_acc[4 * j + 2 * r] = a.x;
            o_acc[4 * j + 2 * r + 1] = a.y;
          }
        }
      }
    }

    // The online softmax of the finished S of key tile k0, in registers:
    // s_acc[4j + e] is row row[e / 2], key k0 + 8j + 2tq + (e % 2).  Writes
    // p, updates m and l, returns each row's rescale of o in alpha.
    // MASKED (diagonal and window-edge tiles) tests every entry against the
    // mask (tm: the tile's view of it); an interior tile takes the lean
    // path, where a row's max of the raw scores times scale is the max of
    // the scaled ones.  That holds for scale > 0 only, so any other scale
    // takes the masked path throughout.  Q8: l sums p, and P.V takes p
    // times its key's V scale in two parts.
    auto softmax = [&](auto masked, int k0, float (&alpha)[2], const auto& tm) {
      constexpr bool MASKED = decltype(masked)::value;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[4 * j + e];
          if constexpr (MASKED) {
            x = tm.ok(h, row[e / 2], k0 + 8 * j + 2 * tq + (e % 2)) ? x * scale : kNegInf;
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
        if constexpr (Q8) {
          const float2 vc = *reinterpret_cast<const float2*>(vsc_t + 8 * j + 2 * tq);
          split_pack(pe[0] * vc.x, pe[1] * vc.y, p[j / 2][2 * (j % 2)], p_lo[j / 2][2 * (j % 2)]);
          split_pack(pe[2] * vc.x, pe[3] * vc.y, p[j / 2][2 * (j % 2) + 1],
                     p_lo[j / 2][2 * (j % 2) + 1]);
        } else {
          p[j / 2][2 * (j % 2)] = pack_bf16(pe[0], pe[1]);
          p[j / 2][2 * (j % 2) + 1] = pack_bf16(pe[2], pe[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(sum[r]);
    };

    mbar_wait(q_full, n & 1);
    if (t_begin >= t_end) mbar_arrive(q_empty);
    for (int t = t_begin; t < t_end; ++t) {
      const int k0 = mask.k_tile(t) * kBK;
      // a policy's per-tile view loads its words here, ahead of the product
      const auto& tm = tile_of(mask, h, t, k0, rq0, row);
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
      if constexpr (Q8) {
        // the payload's dot products times their key's scale; the V
        // scales, which the softmax reads, land with V
        const float* kc = ksc + stage * kBK + 2 * tq;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float2 f = *reinterpret_cast<const float2*>(kc + 8 * j);
          s_acc[4 * j] *= f.x;
          s_acc[4 * j + 1] *= f.y;
          s_acc[4 * j + 2] *= f.x;
          s_acc[4 * j + 3] *= f.y;
        }
        vsc_t = vsc + stage * kBK;
        mbar_wait(&v_full[stage], phase);
      }

      float alpha[2];
      if (scale > 0.f && tm.full(h, rq0, 64, k0, kBK))
        softmax(std::false_type{}, k0, alpha, tm);
      else
        softmax(std::true_type{}, k0, alpha, tm);
      fence_regs(o_acc);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= alpha[0];
        o_acc[4 * j + 1] *= alpha[0];
        o_acc[4 * j + 2] *= alpha[1];
        o_acc[4 * j + 3] *= alpha[1];
      }

      // O += P . V: V is MN-major (rows are keys, D contiguous), 16 keys a
      // step; Q8: the hi parts' products, then the lo parts'
      if constexpr (!Q8) mbar_wait(&v_full[stage], phase);
      const uint32_t v_addr = smem_addr(vs + stage * L::kTileBytes);
      fence_regs(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc)
        pv_mma<D>(o_acc, p[kc], desc_sw128(v_addr + kc * 2048, kBox, kAtomRows));
      if constexpr (Q8) {
#pragma unroll
        for (int kc = 0; kc < kBK / 16; ++kc)
          pv_mma<D>(o_acc, p_lo[kc], desc_sw128(v_addr + kc * 2048, kBox, kAtomRows));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      if constexpr (Q8) fence_regs(p_lo);
      mbar_arrive(&empty[stage]);  // K and V of this tile are consumed
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if constexpr (ACC) {  // the state back, unnormalised; a dead item wrote nothing
      if (t_begin < t_end) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (row[r] >= S) continue;
          if (tq == 0) {
            lse[row_off + row[r]] = m_run[r];
            l_io[row_off + row[r]] = l_run[r];
          }
          float* dst = acc_b + static_cast<long long>(row[r]) * so.s + 2 * tq;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(o_acc[4 * j + 2 * r], o_acc[4 * j + 2 * r + 1]);
        }
      }
    } else {
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
        if (tq == 0 && row[r] < S) lse[row_off + row[r]] = m_run[r] + logf(safe_l);
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
}

template <int D, typename Mask, bool ACC = false>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, float* __restrict__ l_io,
                      float* __restrict__ acc_io, Strides4 so, int B, int Hq, int Hkv, int S,
                      float scale, Mask mask) {
  attn_fwd_wgmma_body<D, Mask, ACC, false>(&map_q, &map_k, &map_v, nullptr, nullptr, o, lse,
                                           l_io, acc_io, so, B, Hq, Hkv, S, scale, mask);
}

// the int8 K/V lane (accumulate mode): m in lse's place, l and acc in place
template <int D, typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_wgmma_s8_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_ks,
                         const __grid_constant__ CUtensorMap map_vs, float* __restrict__ m,
                         float* __restrict__ l_io, float* __restrict__ acc_io, Strides4 so, int B,
                         int Hq, int Hkv, int S, float scale, Mask mask) {
  attn_fwd_wgmma_body<D, Mask, true, true>(&map_q, &map_k, &map_v, &map_ks, &map_vs, nullptr, m,
                                           l_io, acc_io, so, B, Hq, Hkv, S, scale, mask);
}

// A 4-D tensor map over one [B, H, S, D] operand (element strides st: b,
// h, s; D contiguous), boxes of 64 columns x `rows` rows of one head.  A
// dim of size one is never stepped: it gets the packed stride.
inline bool attn_map(CUtensorMap* map, const void* p, int B, int H, int S, int D,
                     const long long* st, int rows = kBQ) {
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
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return hopper_host::encode_bf16(map, p, 4, dims, strides, box);
}

// attn_map for the int8 lane's payloads: a 4-D uint8 map over one
// [B, H, S, D] int8 operand, unswizzled boxes of D bytes x `rows` rows
inline bool s8_map(CUtensorMap* map, const void* p, int B, int H, int S, int D,
                   const long long* st, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  uint64_t strides[3];
  strides[0] = S > 1 ? static_cast<uint64_t>(st[2]) : static_cast<uint64_t>(D);
  strides[1] = H > 1 ? static_cast<uint64_t>(st[1]) : strides[0] * S;
  strides[2] = B > 1 ? static_cast<uint64_t>(st[0]) : strides[1] * H;
  for (uint64_t x : strides)
    if (x == 0 || x % 16 != 0) return false;
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const uint32_t box[4] = {static_cast<uint32_t>(D), static_cast<uint32_t>(rows), 1, 1};
  return hopper_host::encode_u8(map, p, 4, dims, strides, box);
}

// A 1-D fp32 map over `rows` contiguous floats (the row scales, lse,
// delta), `box` floats a box; false past 32-bit coordinates
inline bool rows_map(CUtensorMap* map, const float* p, long long rows, int box) {
  if (rows + box >= (1ll << 31)) return false;
  const uint64_t dims[1] = {static_cast<uint64_t>(rows)};
  const uint64_t unused[1] = {0};
  const uint32_t b[1] = {static_cast<uint32_t>(box)};
  return hopper_host::encode_f32(map, p, 1, dims, unused, b);
}

// strides: (b, h, s) of q, k, v, o (acc under ACC) in that order; ACC: lse
// is m, and o is unused
template <int D, bool ACC, typename Mask>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, float* l_io,
           float* acc_io, const long long* strides, int B, int Hq, int Hkv, int S, float scale,
           Mask mask, cudaStream_t stream) {
  if (B < 0 || S < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  CUtensorMap mq, mk, mv;
  if (!attn_map(&mq, q, B, Hq, S, D, strides) || !attn_map(&mk, k, B, Hkv, S, D, strides + 3) ||
      !attn_map(&mv, v, B, Hkv, S, D, strides + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ACC && reinterpret_cast<uintptr_t>(acc_io) % 8 != 0)  // 8-byte state loads
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_fwd_wgmma_kernel<D, Mask, ACC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Layout<D>::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides4 so{strides[9], strides[10], strides[11]};
  const int items = (S + kBQ - 1) / kBQ * Hq * B;  // persistent: one block an SM at most
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, Layout<D>::kSmem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o),
                                                     lse, l_io, acc_io, so, B, Hq, Hkv, S, scale,
                                                     mask);
  return static_cast<int>(cudaGetLastError());
}

// The int8 K/V lane of the forward in accumulate mode (ring_carry_s8): k, v
// int8 payloads, ks, vs their fp32 row scales [B, Hkv, S] contiguous; the
// rest as launch<D, true>: strides (b, h, s) of q, k, v, acc; m, l [B, Hq,
// S] and acc updated in place.
template <int D, typename Mask>
int launch_s8(const void* q, const void* k, const void* v, const float* ks, const float* vs,
              float* m, float* l_io, float* acc_io, const long long* strides, int B, int Hq,
              int Hkv, int S, float scale, Mask mask, cudaStream_t stream) {
  using L = LayoutS8<D>;
  if (B < 0 || S < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  CUtensorMap mq, mk, mv, mks, mvs;
  const long long rows = static_cast<long long>(B) * Hkv * S;
  if (!attn_map(&mq, q, B, Hq, S, D, strides) ||
      !s8_map(&mk, k, B, Hkv, S, D, strides + 3, kBK) ||
      !s8_map(&mv, v, B, Hkv, S, D, strides + 6, kBK) || !rows_map(&mks, ks, rows, L::kScBox) ||
      !rows_map(&mvs, vs, rows, L::kScBox))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(acc_io) % 8 != 0)  // 8-byte state loads
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_fwd_wgmma_s8_kernel<D, Mask>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides4 so{strides[9], strides[10], strides[11]};
  const int items = (S + kBQ - 1) / kBQ * Hq * B;
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, L::kSmem, stream>>>(mq, mk, mv, mks, mvs, m, l_io, acc_io, so, B, Hq,
                                             Hkv, S, scale, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_wg
