// Attention backward on wgmma and TMA, Hopper: the dense `flash_bwd_dq`
// and `flash_bwd_dkv`, the ring hop's `ring_bwd_dq` and `ring_bwd_dkv` and
// the block-sparse `bsa_bwd_dq` and `bsa_bwd_dkv` at bf16, and the ring
// hop's int8 K/V lanes of both, `ring_bwd_dq_s8` and `ring_bwd_dkv_s8`
// (bf16 q and do).
//
// Computes what attn_bwd_dq_kernel / attn_bwd_dkv_kernel of
// attention_tiles.cuh compute (and what the TPU kernels _dq_kernel(_blocked)
// / _dkv_kernel(_blocked) and _ring_dq_kernel / _ring_dkv_kernel of
// deepspeed_tpu/ops/pallas/flash_mha.py compute): fp32 scores, p =
// exp(s * scale - lse) against the final lse, zeroed where the mask says
// no, ds = p * (dp - delta) * scale, p rounded to bf16 before p^T.do, ds
// rounded to bf16 before ds.k and ds^T.q.  Only the walk and where the
// numbers live differ.  The output's type is the mode, a template
// parameter of the kernels and their launchers:
//  * fp32 (accumulate, the ring): the incoming fp32 dq [B, Hq, S, D] and
//    the traveling fp32 dk, dv [B, Hkv, S, D] seed the sums and receive
//    them in place;
//  * bf16 (store, flash): the sums start at zero and the item's rows are
//    written once, rounded to bf16 (as the TPU kernels cast their fp32
//    scratch at the last tile); rows past S are not written.
//
// Bound: the products, 3 (dq) and 4 (dk/dv) of pairs x D a head (llama3-8b
// causal at S 4096, or a causal hop of the ring there: 0.21 and 0.28 ms at
// 989 TFLOP/s), far above the bytes of q, k, v, do and the sums.  So the
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
//    lives in registers for the item and leaves (or, accumulating, is
//    seeded) as 8-byte fp32 or 4-byte bf16 accesses in the fragment's
//    layout.  Registers a consumer thread at D 128: S 32 + dP 32 + dq 64 +
//    dS 16 fp32/bf16x2.
//  * dk/dv (attn_bwd_dkv_wgmma_kernel): an item is a 128-key tile (two
//    consumer warpgroups of 64 keys) of one KV head and batch, low key
//    tiles (the longest causal walks) first; it keeps K and V and walks its
//    GQA group's query heads and their live 64-row query tiles itself, so
//    the block owns its output tile: no atomics.  Per query tile, each
//    consumer: S^T = K.Q^T and dP^T = V.dO^T by wgmma (K-major) with the
//    query tile as wgmma's N; P^T and dS^T in registers against the query
//    columns' lse and delta, which the producer loads beside the Q tile
//    (1-D tensor maps over the flat [B * Hq * S] rows; a box starts at the
//    16-byte boundary at or before the tile's first row, since TMA faults
//    on any other start, and is 4 floats wider, the consumers reading it
//    from that offset; the columns of a tail tile past S read the next
//    head's values, finite, and the mask zeroes their p; past the array's
//    end TMA fills zeros); dV += P^T.dO
//    and dK += dS^T.Q by
//    wgmma with dO and Q read MN-major from the tiles that fed the first
//    two products.  Registers a consumer thread at D 128: dK 64 + dV 64 +
//    S^T 32 + dP^T 32 + P^T 16 + dS^T 16; the score products zero their
//    accumulators by wgmma's scale-d (wgmma_ss_n64 without ACC), so no
//    score register is live across the dK/dV products, and the query tile
//    is 64 wide to stay inside the 240 registers setmaxnreg gives.
//  * the store mode's epilogue writes bf16 pairs straight from the
//    accumulator fragment (a quad's four threads cover 16 contiguous bytes
//    of a row), the layout the accumulate mode reads and writes.  A staged
//    epilogue (whole 128-byte rows through shared memory, as the forward's)
//    has no room: at D 128 the dk/dv kernel's K, V and 4 stages of Q, dO
//    take about 196 of the 227 KiB, and the K/V tiles it could reuse are
//    the next item's as soon as KV-empty is released, so staging there
//    would hold that release, and with it the next item's K/V and first
//    Q/dO loads, until the rows are out: a TMA round trip exposed at every
//    item instead of hidden behind the epilogue.  The direct store keeps
//    that overlap and costs the consumers D / 4 stores a thread an output.
//    What an epilogue costs here follows its bytes: at llama3-8b causal
//    (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W) the accumulate mode,
//    which reads and writes fp32 where store mode writes bf16 once (96 and
//    48 MB more for dq and dk/dv), runs the same walk 0.029 and 0.020 ms
//    slower, about those bytes at the HBM rate; at that rate the bf16 rows
//    take about 0.01 ms of the 0.36 / 0.46, the most a staged epilogue
//    could hide.
//  * the mask policy is the walk's, as in the forward: k_begin/k_end (dq)
//    and q_begin/q_end (dk/dv) bound the tiles, dead tiles are never
//    visited, ok masks diagonal and edge tiles in registers, and `full`
//    sends interior tiles down a body compiled without the test.  A policy
//    with a `tile` member (the block layout's) narrows itself to each
//    visited tile before the tile's products are issued: `tile(h, t,
//    walk0, sub0, fixed)` (list entry t, the walked tile's first row or
//    key, the warpgroup's first fixed one, the thread's two fixed rows or
//    keys) returns what `full` and `ok` are asked for that tile, so its
//    loads from device memory overlap the wait for the tile and the
//    products; every other policy answers for itself.  An item
//    with no live tile reads nothing; accumulating, it writes nothing, so
//    its rows of dq, dk, dv stay bit for bit as they were; storing, it
//    writes zeros, so no row of the output is left unwritten.
//  * the int8 K/V lane of dk/dv (template flag Q8,
//    attn_bwd_dkv_wgmma_s8_kernel, `ring_bwd_dkv_s8` on the quantized ring
//    wire; accumulate mode only).  K and V arrive as int8 payload rows with
//    one fp32 scale a row and stay resident for the item, so they are
//    widened once an item, straight from device memory into the two bf16
//    tiles, with no int8 copy in shared memory: each consumer warpgroup
//    widens its own 64 keys (the rows its products read as A), all its
//    16-byte loads issued before the first store, in the layout TMA's
//    128-byte swizzle gives the bf16 lane, then fences the proxy and meets
//    at a named barrier of its 128 threads; the producer loads only Q, dO,
//    lse and delta.  The widened rows are free when the item starts: the
//    warpgroup's products of the previous item have been waited for.  The
//    scales sit on the key axis, the M rows of S^T and dP^T: the warpgroup
//    leaves its 64 keys' K and V scales in shared memory beside the tiles,
//    and each thread multiplies its S^T and dP^T rows by its two keys'
//    before p and ds; p and ds enter dV += P^T.dO and dK += dS^T.Q as two
//    bf16 parts each, hi = bf16(x) and lo = bf16(x - hi) (about 16 bits of
//    the fp32 factors the JAX lane keeps), so each sum takes two wgmma_rs
//    products a step on the same dO or Q tile, issued in one group.
//    Registers a consumer thread at D 128: dK 64 + dV 64 + the four A
//    fragments 64, S^T and dP^T (32 each) dead once the fragments are
//    packed, inside setmaxnreg's 240 with nothing to spare: K's and V's
//    descriptors are rebuilt each tile and the epilogue's row addresses
//    after the walk (held across it, with the scales in registers, ptxas
//    spilled 64 bytes).  Shared memory: the bf16 lane's and the scales'
//    1 KiB.
//  * the int8 K/V lane of dq (template flag Q8, attn_bwd_dq_wgmma_s8_kernel,
//    `ring_bwd_dq_s8`; accumulate mode only).  The dq walk streams its
//    64-key K and V tiles through the ring of stages, so a consumer that
//    widened them from device memory would wait on a load every tile:
//    the forward's int8 lane's design (attention_wgmma.cuh) is taken
//    instead.  The producer warpgroup's first thread loads Q and dO as
//    bf16 and each live tile's K, then V, as int8 rows (boxes of D bytes x
//    64 rows) with the tile's row scales (a 1-D box from the 16-byte
//    boundary at or before the tile's first row) into a ring of slots; its
//    warps 1-3 widen each slot into the tile's swizzled bf16 stage, copy
//    the scales beside it, fence the proxy and arrive on K-full or V-full
//    (96 arrivals).  All four warps walk the items in `snake` order and
//    skip the same dead items.  The consumers are the bf16 lane's but for
//    the scales, on the key axis, the N columns of S and dP: S = Q.K^T is
//    issued as soon as K is widened, ahead of dP = dO.V^T; each S column is
//    multiplied by its key's K scale and each dP column by its V scale
//    before p and ds, and ds, times its key's K scale, enters dQ += dS.K as
//    two bf16 parts (hi, lo), two wgmma_rs products a step on the same K
//    tile in one group.  Registers: the producer warpgroup 56 a thread, the
//    consumers 224 (at D 128: S 32 + dP 32 + dq 64 + dS hi and lo 32).
//    Shared memory at D 128: the bf16 lane's 192 KiB, the stages' scales
//    2 KiB and 3 slots of 8.4 KiB (220.3 KiB; 4 slots at D 64).
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a view TMA cannot take, a
// tensor map cuTensorMapEncodeTiled refuses or an output the 8-byte (fp32)
// or 4-byte (bf16) accesses cannot take).

#pragma once

#include "attention_wgmma.cuh"

namespace flash_wg {

constexpr int kBKd = 64;                // dq: keys a tile
constexpr int kBQd = 64;                // dk/dv: query rows a tile
// dk/dv: a query tile's lse (or delta) box, floats: the tile's rows from the
// 16-byte boundary at or before its first, and the box's pitch in shared
// memory (128-byte aligned)
constexpr int kLdBox = kBQd + 4, kLdPitch = 96;
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
                                     kStages * 2 * kLdPitch * sizeof(float) +
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

// The mode of an output type: fp32 sums accumulate in place (the ring),
// bf16 outputs are written once (flash, block-sparse)
template <typename Out>
constexpr bool kAccumulate = std::is_same<Out, float>::value;

// Loads the fp32 rows `row` of a [.., S, D] sum into the accumulator
// fragment (columns 8j + 2t, + 1), 0 past S; and stores them back, as fp32
// or rounded to bf16.
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
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], __nv_bfloat16* base,
                                           long long ss, const int (&row)[2], int S, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    __nv_bfloat16* dst = base + static_cast<long long>(row[r]) * ss + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// The start of an item's sums: seeded from the fp32 rows (accumulate) or 0
template <int D, typename Out>
__device__ __forceinline__ void start_rows(float (&acc)[D / 2], const Out* base, long long ss,
                                           const int (&row)[2], int S, int tq) {
  if constexpr (kAccumulate<Out>) {
    seed_rows<D>(acc, base, ss, row, S, tq);
  } else {
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
// The int8 K/V lane of the dq walk (Q8): shared memory of the bf16 lane
// (Q, dO and the ring of bf16 K/V stages the products read, widened there
// by the producer warpgroup), then the stages' key scales (K's, then V's,
// kBKd floats a stage) and a ring of int8 slots that TMA fills: one operand
// (K or V) of one key tile each, kBKd payload rows of D bytes and the tile's
// row scales (a 1-D box of kScBox floats from the 16-byte boundary at or
// before the tile's first row).  3 slots at D 128 (a fourth overruns the
// 227 KiB), 4 at D 64.
template <int D>
struct DqLayoutS8 : BwdLayout<D> {
  using BwdLayout<D>::kWide;
  using BwdLayout<D>::kNarrow;
  using BwdLayout<D>::kStages;
  static constexpr int kSlots = D == 64 ? 4 : 3;
  static constexpr int kScBox = kBKd + 4;
  static constexpr uint32_t kSlotRows = kBKd * D;            // payload bytes of a slot
  static constexpr uint32_t kSlotBytes = kSlotRows + 384;   // + the scale box, 128-byte aligned
  // byte offsets from the aligned base: Q, dO, the K and V stages; the
  // stages' scales; the slots; the Q-full, Q-empty, K-full, V-full, empty,
  // slot-full and slot-empty barriers
  static constexpr uint32_t kScales = 2 * kWide + 2 * kStages * kNarrow;
  static constexpr uint32_t kSlotBase = kScales + 2 * kStages * kBKd * sizeof(float);
  static constexpr uint32_t kBars = kSlotBase + kSlots * kSlotBytes;
  static constexpr size_t kSmem = 1024 + kBars + (2 + 3 * kStages + 2 * kSlots) * sizeof(uint64_t);
  static_assert(kScBox * sizeof(float) <= 384, "the scale box overruns its slot");
  static_assert(kSmem <= 232448, "the int8 dq walk overruns shared memory");
};

// Q8: map_k, map_v are int8 maps over the payloads (boxes of D bytes x kBKd
// rows) and map_ks, map_vs 1-D fp32 maps over the row scales (kScBox a box)
template <int D, typename Mask, typename Out, bool Q8>
__device__ __forceinline__ void attn_bwd_dq_wgmma_body(
    const CUtensorMap* map_q, const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_do, const CUtensorMap* map_ks, const CUtensorMap* map_vs,
    const float* __restrict__ lse, const float* __restrict__ delta, Out* __restrict__ dq,
    Strides4 sdq, int B, int Hq, int Hkv, int S, float scale, Mask mask) {
  static_assert(kAccumulate<Out> || !Q8, "the int8 lane runs in accumulate mode");
  using L = std::conditional_t<Q8, DqLayoutS8<D>, BwdLayout<D>>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* dos = qs + L::kWide;
  unsigned char* ks = dos + L::kWide;  // stage s: ks + s * kNarrow
  unsigned char* vs = ks + L::kStages * L::kNarrow;
  // Q8: stage s's key scales at ksc + s * kBKd (K's) and vsc + s * kBKd
  // (V's), then the int8 slots; the barriers after them
  float* ksc = reinterpret_cast<float*>(vs + L::kStages * L::kNarrow);
  float* vsc = ksc + L::kStages * kBKd;
  unsigned char* slots = nullptr;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ksc);
  if constexpr (Q8) {
    slots = qs + L::kSlotBase;
    q_full = reinterpret_cast<uint64_t*>(qs + L::kBars);
  }
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;
  uint64_t* slot_full = empty + L::kStages;
  uint64_t* slot_empty = nullptr;
  if constexpr (Q8) slot_empty = slot_full + L::kSlots;

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
    // producer: one thread issues every load; the next item's Q, dO and
    // first tiles load while the consumers finish this one.  Q8: that
    // thread loads each tile's K, then V, as int8 rows and their scales
    // into the slots, and warps 1-3 widen them into the bf16 stages.  All
    // of them walk the items in the consumers' order (`snake`) and skip the
    // same dead items, so their stage, slot and phase counters agree.
    reg_dealloc<Q8 ? 56 : 24>();
    if (tid == 0) {
      int stage = 0, slot = 0;
      uint32_t phase = 0, sphase = 0;
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
          tma_load_4d(qs + j * kBox, map_q, q_full, 64 * j, it.iq * kBQ, it.h, it.b);
          tma_load_4d(dos + j * kBox, map_do, q_full, 64 * j, it.iq * kBQ, it.h, it.b);
        }
        for (int t = t_begin; t < t_end; ++t) {
          const int k0 = mask.k_tile(t) * kBKd;
          if constexpr (Q8) {
            const int kv_row0 = (it.b * Hkv + hk) * S;  // < 2^31: the launcher checks
            const int c0 = (kv_row0 + k0) & ~3;         // 16-byte aligned
#pragma unroll
            for (int op = 0; op < 2; ++op) {
              mbar_wait(&slot_empty[slot], sphase ^ 1);
              load_slot<D, kBKd>(slots + slot * L::kSlotBytes, op ? map_v : map_k,
                                 op ? map_vs : map_ks, &slot_full[slot], k0, hk, it.b, c0);
              if (++slot == L::kSlots) {
                slot = 0;
                sphase ^= 1;
              }
            }
          } else {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* kt = ks + stage * L::kNarrow;
            unsigned char* vt = vs + stage * L::kNarrow;
            mbar_expect_tx(&k_full[stage], L::kNarrow);
#pragma unroll
            for (int j = 0; j < L::kBoxes; ++j)
              tma_load_4d(kt + j * kBox64, map_k, &k_full[stage], 64 * j, k0, hk, it.b);
            mbar_expect_tx(&v_full[stage], L::kNarrow);
#pragma unroll
            for (int j = 0; j < L::kBoxes; ++j)
              tma_load_4d(vt + j * kBox64, map_v, &v_full[stage], 64 * j, k0, hk, it.b);
            if (++stage == L::kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if constexpr (Q8) {
      // widening warps: each slot's int8 rows into the bf16 stage of its
      // tile, in the swizzled layout TMA gives the bf16 lane, and its
      // scales beside; the stage's K-full (V-full) barrier counts these
      // threads' arrivals, each after its proxy fence
      if (tid < 32) return;
      const int u = tid - 32;
      int stage = 0, slot = 0;
      uint32_t phase = 0, sphase = 0;
      for (int r = 0;; ++r) {
        const int i = snake(r, blockIdx.x, gridDim.x);
        if (i >= items) break;
        const Item it(i, nq, Hq, B);
        const int t_begin = mask.k_begin(it.h, it.iq), t_end = mask.k_end(it.h, it.iq);
        if (t_begin >= t_end) continue;  // as the loading thread
        const int kv_row0 = (it.b * Hkv + it.h / (Hq / Hkv)) * S;
        for (int t = t_begin; t < t_end; ++t) {
          const int off = (kv_row0 + mask.k_tile(t) * kBKd) & 3;  // the tile's first row in its box
          mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
          for (int op = 0; op < 2; ++op) {
            mbar_wait(&slot_full[slot], sphase);
            widen_slot<D, kBKd>(slots + slot * L::kSlotBytes,
                                smem_addr((op ? vs : ks) + stage * L::kNarrow),
                                (op ? vsc : ksc) + stage * kBKd, off, u);
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
    return;
  }

  // consumer warpgroup wgi: query rows 64 wgi .. 64 wgi + 63 of each item
  reg_alloc<Q8 ? 224 : 240>();
  const int w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_addr(qs) + wgi * 8192;  // this warpgroup's 64 rows of each box
  const uint32_t do_addr = smem_addr(dos) + wgi * 8192;
  float s_acc[kBKd / 2], dp_acc[kBKd / 2], dq_acc[D / 2];
  uint32_t ds[kBKd / 16][4];  // dS in bf16: the A fragments of the k16 steps of dS.K
  // Q8: ds times its key's K scale, split: ds holding the hi parts, ds_lo the lo
  uint32_t ds_lo[Q8 ? kBKd / 16 : 1][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int r = 0, n = 0;; ++r) {
    const int i = snake(r, blockIdx.x, gridDim.x);
    if (i >= items) break;
    const Item it(i, nq, Hq, B);
    const int h = it.h;
    const int t_begin = mask.k_begin(h, it.iq), t_end = mask.k_end(h, it.iq);
    if (kAccumulate<Out> && t_begin >= t_end) continue;  // nothing read, nothing written
    const int rq0 = it.iq * kBQ + 64 * wgi;  // this warpgroup's first row
    const int row[2] = {rq0 + 16 * w + g, rq0 + 16 * w + g + 8};
    const long long row_off = (static_cast<long long>(it.b) * Hq + h) * S;
    float lse2[2], dl[2];  // each row's lse * log2 e and delta; 0 past S
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      lse2[x] = row[x] < S ? lse[row_off + row[x]] * kLog2e : 0.f;
      dl[x] = row[x] < S ? delta[row_off + row[x]] : 0.f;
    }
    Out* dq_b = dq + it.b * sdq.b + h * sdq.h;
    start_rows<D>(dq_acc, dq_b, sdq.s, row, S, tq);
    if constexpr (!kAccumulate<Out>) {
      if (t_begin >= t_end) {  // nothing read; zeros written
        store_rows<D>(dq_acc, dq_b, sdq.s, row, S, tq);
        continue;
      }
    }

    // p and ds of the finished S and dP of key tile k0, in registers:
    // s_acc[4j + e] is row row[e / 2], key k0 + 8j + 2tq + (e % 2).  MASKED
    // (diagonal, edge and tail tiles) tests every entry against the mask.
    // Q8: S and dP columns times their key's K and V scale (kst, vst: the
    // tile's scales from this thread's first column) first, and ds times
    // its key's K scale in two bf16 parts.
    auto dscore = [&](auto masked, int k0, const auto& tm, const float* kst, const float* vst) {
      constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < kBKd / 8; ++j) {
        float2 fk = make_float2(1.f, 1.f), fv = fk;
        if constexpr (Q8) {
          fk = *reinterpret_cast<const float2*>(kst + 8 * j);
          fv = *reinterpret_cast<const float2*>(vst + 8 * j);
        }
        float de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = s_acc[4 * j + e], dpv = dp_acc[4 * j + e];
          if constexpr (Q8) {
            sv *= e % 2 ? fk.y : fk.x;
            dpv *= e % 2 ? fv.y : fv.x;
          }
          float p = exp2f(fmaf(sv, scale_log2, -lse2[e / 2]));
          if constexpr (MASKED)
            p = tm.ok(h, row[e / 2], k0 + 8 * j + 2 * tq + (e % 2)) ? p : 0.f;
          de[e] = p * (dpv - dl[e / 2]) * scale;
          if constexpr (Q8) de[e] *= e % 2 ? fk.y : fk.x;
        }
        if constexpr (Q8) {
          split_pack(de[0], de[1], ds[j / 2][2 * (j % 2)], ds_lo[j / 2][2 * (j % 2)]);
          split_pack(de[2], de[3], ds[j / 2][2 * (j % 2) + 1], ds_lo[j / 2][2 * (j % 2) + 1]);
        } else {
          ds[j / 2][2 * (j % 2)] = pack_bf16(de[0], de[1]);
          ds[j / 2][2 * (j % 2) + 1] = pack_bf16(de[2], de[3]);
        }
      }
    };

    mbar_wait(q_full, n++ & 1);
    for (int t = t_begin; t < t_end; ++t) {
      const int k0 = mask.k_tile(t) * kBKd;
      const auto& tm = tile_of(mask, h, t, k0, rq0, row);
      const uint32_t k_addr = smem_addr(ks + stage * L::kNarrow);
      const uint32_t v_addr = smem_addr(vs + stage * L::kNarrow);
      // S = Q . K^T and dP = dO . V^T, D/16 steps of 16 each; Q8: S is
      // issued on K alone while V is still being widened
      mbar_wait(&k_full[stage], phase);
      if constexpr (Q8) {
        wgmma_fence();
        scores<D>(s_acc, q_addr, kBox, k_addr);
        wgmma_commit();
        mbar_wait(&v_full[stage], phase);
        wgmma_fence();
      } else {
        mbar_wait(&v_full[stage], phase);
        wgmma_fence();
        scores<D>(s_acc, q_addr, kBox, k_addr);
      }
      scores<D>(dp_acc, do_addr, kBox, v_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (t + 1 == t_end) mbar_arrive(q_empty);  // Q and dO are read: the next item's may load

      const float* kst = ksc + stage * kBKd + 2 * tq;
      const float* vst = vsc + stage * kBKd + 2 * tq;
      if (tm.full(h, rq0, 64, k0, kBKd))
        dscore(std::false_type{}, k0, tm, kst, vst);
      else
        dscore(std::true_type{}, k0, tm, kst, vst);

      // dQ += dS . K: K is MN-major (rows are keys, D contiguous), 16 keys a
      // step; Q8: the hi parts' products, then the lo parts', one group
      fence_regs(ds);
      if constexpr (Q8) fence_regs(ds_lo);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBKd / 16; ++kc) sum_mma<D>(dq_acc, ds[kc], k_addr + kc * 2048);
      if constexpr (Q8) {
#pragma unroll
        for (int kc = 0; kc < kBKd / 16; ++kc) sum_mma<D>(dq_acc, ds_lo[kc], k_addr + kc * 2048);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(ds);
      if constexpr (Q8) fence_regs(ds_lo);
      mbar_arrive(&empty[stage]);  // K and V of this tile are consumed
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_rows<D>(dq_acc, dq_b, sdq.s, row, S, tq);
  }
}

template <int D, typename Mask, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                         const float* __restrict__ delta, Out* __restrict__ dq, Strides4 sdq,
                         int B, int Hq, int Hkv, int S, float scale, Mask mask) {
  attn_bwd_dq_wgmma_body<D, Mask, Out, false>(&map_q, &map_k, &map_v, &map_do, nullptr, nullptr,
                                              lse, delta, dq, sdq, B, Hq, Hkv, S, scale, mask);
}

// the int8 K/V lane (accumulate mode): dq fp32, updated in place
template <int D, typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_wgmma_s8_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const __grid_constant__ CUtensorMap map_ks,
                            const __grid_constant__ CUtensorMap map_vs,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, Strides4 sdq, int B, int Hq, int Hkv, int S,
                            float scale, Mask mask) {
  attn_bwd_dq_wgmma_body<D, Mask, float, true>(&map_q, &map_k, &map_v, &map_do, &map_ks, &map_vs,
                                               lse, delta, dq, sdq, B, Hq, Hkv, S, scale, mask);
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------
// The int8 K/V lane's operands of the dk/dv walk, read by the consumers
// themselves: payload rows [B, Hkv, S, D] (element strides sk, sv: b, h, s;
// D contiguous, rows 16-byte aligned) and fp32 row scales [B, Hkv, S]
// contiguous
struct KvS8 {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  Strides4 sk, sv;
};

// Keys key0 .. key0 + 63 of the int8 K and V (row strides sk, sv bytes)
// widened into this warpgroup's 64 rows of the two bf16 tiles at shared
// addresses kd, vd (128-row boxes with 128-byte swizzle, what TMA writes for
// the bf16 lane; the rows start 64 wgi into each box); keys at or past S
// are zero.  Thread t of the warpgroup widens 16-byte chunks t, t + 128, ...
// of the 64 rows, every load issued before the first store.
template <int D>
__device__ __forceinline__ void widen_kv_rows(uint32_t kd, uint32_t vd, const int8_t* k,
                                              const int8_t* v, long long sk, long long sv,
                                              int key0, int S, int t) {
  constexpr int kPerRow = D / 16, kPer = 64 * kPerRow / 128;
  uint4 raw[2][kPer];
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int i = t + 128 * x, r = i / kPerRow, c = i % kPerRow;
    const bool in = key0 + r < S;
    raw[0][x] = in ? __ldg(reinterpret_cast<const uint4*>(k + (key0 + r) * sk + 16 * c))
                   : make_uint4(0u, 0u, 0u, 0u);
    raw[1][x] = in ? __ldg(reinterpret_cast<const uint4*>(v + (key0 + r) * sv + 16 * c))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int i = t + 128 * x, r = i / kPerRow, c = i % kPerRow;
    store_widened(kd, kBox, r, c, raw[0][x]);
    store_widened(vd, kBox, r, c, raw[1][x]);
  }
}

// Q8: the int8 K/V lane (accumulate mode only), K and V from kv (map_k and
// map_v unused)
template <int D, typename Mask, typename Out, bool Q8>
__device__ __forceinline__ void attn_bwd_dkv_wgmma_body(
    const CUtensorMap* map_q, const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_do, const CUtensorMap* map_lse, const CUtensorMap* map_delta,
    const KvS8& kv, Out* __restrict__ dk, Out* __restrict__ dv, Strides4 sdk, Strides4 sdv, int B,
    int Hq, int Hkv, int S, float scale, Mask mask) {
  static_assert(kAccumulate<Out> || !Q8, "the int8 lane runs in accumulate mode");
  using L = BwdLayout<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* vs = ks + L::kWide;
  unsigned char* qs = vs + L::kWide;  // stage s: qs + s * kNarrow
  unsigned char* dos = qs + L::kStages * L::kNarrow;
  // stage s: lse at lds + 2 s kLdPitch, delta kLdPitch after it
  float* lds = reinterpret_cast<float*>(dos + L::kStages * L::kNarrow);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lds + L::kStages * 2 * kLdPitch);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + L::kStages;
  // Q8: the item's keys' K scales, then their V scales (kBK floats each)
  float* kv_sc = reinterpret_cast<float*>(empty + L::kStages);

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
    // load while the consumers finish this one (Q8: the consumers widen K
    // and V themselves)
    reg_dealloc<24>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0, n = 0;; ++r) {
        const int i = snake(r, blockIdx.x, gridDim.x);
        if (i >= items) break;
        const KvItem it(i, Hkv, B);
        if (!live(it)) continue;  // a dead item reads nothing
        if constexpr (!Q8) {
          mbar_wait(kv_empty, (n++ & 1) ^ 1);
          mbar_expect_tx(kv_full, 2 * L::kWide);
#pragma unroll
          for (int j = 0; j < L::kBoxes; ++j) {
            tma_load_4d(ks + j * kBox, map_k, kv_full, 64 * j, it.ik * kBK, it.hk, it.b);
            tma_load_4d(vs + j * kBox, map_v, kv_full, 64 * j, it.ik * kBK, it.hk, it.b);
          }
        }
        for (int g = 0; g < group; ++g) {
          const int h = it.hk * group + g;
          const int row_off = (it.b * Hq + h) * S;  // < 2^31: the launcher checks
          const int t_end = mask.q_end(h, it.ik);
          for (int t = mask.q_begin(h, it.ik); t < t_end; ++t) {
            const int q0 = mask.q_tile(t) * kBQd;
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], 2 * L::kNarrow + 2 * kLdBox * sizeof(float));
            unsigned char* qt = qs + stage * L::kNarrow;
            unsigned char* dt = dos + stage * L::kNarrow;
#pragma unroll
            for (int j = 0; j < L::kBoxes; ++j) {
              tma_load_4d(qt + j * kBox64, map_q, &full[stage], 64 * j, q0, h, it.b);
              tma_load_4d(dt + j * kBox64, map_do, &full[stage], 64 * j, q0, h, it.b);
            }
            float* ld = lds + stage * 2 * kLdPitch;
            const int c0 = (row_off + q0) & ~3;  // 16-byte aligned
            tma_load_1d(ld, map_lse, &full[stage], c0);
            tma_load_1d(ld + kLdPitch, map_delta, &full[stage], c0);
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
  // Q8: P^T and dS^T split, pf and dsf holding the hi parts, these the lo
  uint32_t pf_lo[Q8 ? kBQd / 16 : 1][4], dsf_lo[Q8 ? kBQd / 16 : 1][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int r = 0, n = 0;; ++r) {
    const int i = snake(r, blockIdx.x, gridDim.x);
    if (i >= items) break;
    const KvItem it(i, Hkv, B);
    const bool alive = live(it);
    if (kAccumulate<Out> && !alive) continue;  // nothing read, nothing written
    const int kr0 = it.ik * kBK + 64 * wgi;  // this warpgroup's first key
    const int key[2] = {kr0 + 16 * w + g8, kr0 + 16 * w + g8 + 8};
    // Q8: the warpgroup's last products of the previous item read these
    // rows and are done (wgmma_wait), so they are free; its 64 keys' K and
    // V scales (0 past S) go to shared memory beside them, read a query
    // tile at a time (held in registers for the item they cost the walk
    // spills at D 128)
    const float* k_sc = kv_sc + 64 * wgi + 16 * w + g8;  // key[0]'s; key[1]'s 8 on
    if constexpr (Q8) {
      named_sync(1 + wgi, 128);  // every warp of the warpgroup is past the previous item
      widen_kv_rows<D>(k_addr, v_addr, kv.k + it.b * kv.sk.b + it.hk * kv.sk.h,
                       kv.v + it.b * kv.sv.b + it.hk * kv.sv.h, kv.sk.s, kv.sv.s, kr0, S, tid);
      const long long kv_row0 = (static_cast<long long>(it.b) * Hkv + it.hk) * S;
      const int c = tid % 64, key_c = kr0 + c;
      const float* src = tid < 64 ? kv.ks : kv.vs;
      kv_sc[(tid < 64 ? 0 : kBK) + 64 * wgi + c] = key_c < S ? src[kv_row0 + key_c] : 0.f;
      fence_proxy_async();
      named_sync(1 + wgi, 128);  // the warpgroup's rows are written: its products may read them
    }
    Out* dk_b = dk + it.b * sdk.b + it.hk * sdk.h;
    Out* dv_b = dv + it.b * sdv.b + it.hk * sdv.h;
    start_rows<D>(dk_acc, dk_b, sdk.s, key, S, tq);
    start_rows<D>(dv_acc, dv_b, sdv.s, key, S, tq);
    if constexpr (!kAccumulate<Out>) {
      if (!alive) {  // nothing read; zeros written
        store_rows<D>(dk_acc, dk_b, sdk.s, key, S, tq);
        store_rows<D>(dv_acc, dv_b, sdv.s, key, S, tq);
        continue;
      }
    }
    if constexpr (!Q8) mbar_wait(kv_full, n++ & 1);

    for (int g = 0; g < group; ++g) {
      const int h = it.hk * group + g;
      const int row_off = (it.b * Hq + h) * S;
      // P^T and dS^T of the finished S^T and dP^T of query tile q0:
      // st[4j + e] is key key[e / 2], query q0 + 8j + 2tq + (e % 2), whose
      // lse and delta the producer left in ld (lse at ld[c], delta at
      // ld[kLdPitch + c] for column c of the tile).  Q8: S^T and dP^T rows
      // times their key's K and V scale first, and p and ds each in two
      // bf16 parts
      auto dscore = [&](auto masked, int q0, const float* ld, const auto& tm) {
        constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < kBQd / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const float lq2[2] = {ld[c] * kLog2e, ld[c + 1] * kLog2e};
          const float dl2[2] = {ld[kLdPitch + c], ld[kLdPitch + c + 1]};
          float pe[4], de[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lq = lq2[e % 2], dq_ = dl2[e % 2];
            float sv = st[4 * j + e], dpv = dpt[4 * j + e];
            if constexpr (Q8) {
              sv *= k_sc[8 * (e / 2)];
              dpv *= k_sc[kBK + 8 * (e / 2)];
            }
            float p = exp2f(fmaf(sv, scale_log2, -lq));
            if constexpr (MASKED) p = tm.ok(h, q0 + c + (e % 2), key[e / 2]) ? p : 0.f;
            pe[e] = p;
            de[e] = p * (dpv - dq_) * scale;
          }
          if constexpr (Q8) {
            split_pack(pe[0], pe[1], pf[j / 2][2 * (j % 2)], pf_lo[j / 2][2 * (j % 2)]);
            split_pack(pe[2], pe[3], pf[j / 2][2 * (j % 2) + 1], pf_lo[j / 2][2 * (j % 2) + 1]);
            split_pack(de[0], de[1], dsf[j / 2][2 * (j % 2)], dsf_lo[j / 2][2 * (j % 2)]);
            split_pack(de[2], de[3], dsf[j / 2][2 * (j % 2) + 1],
                       dsf_lo[j / 2][2 * (j % 2) + 1]);
          } else {
            pf[j / 2][2 * (j % 2)] = pack_bf16(pe[0], pe[1]);
            pf[j / 2][2 * (j % 2) + 1] = pack_bf16(pe[2], pe[3]);
            dsf[j / 2][2 * (j % 2)] = pack_bf16(de[0], de[1]);
            dsf[j / 2][2 * (j % 2) + 1] = pack_bf16(de[2], de[3]);
          }
        }
      };

      const int t_end = mask.q_end(h, it.ik);
      for (int t = mask.q_begin(h, it.ik); t < t_end; ++t) {
        const int q0 = mask.q_tile(t) * kBQd;
        const auto& tm = tile_of(mask, h, t, q0, kr0, key);
        const uint32_t q_addr = smem_addr(qs + stage * L::kNarrow);
        const uint32_t do_addr = smem_addr(dos + stage * L::kNarrow);
        // S^T = K . Q^T and dP^T = V . dO^T, D/16 steps of 16 each.  Q8:
        // K's and V's descriptors anew each tile from opaque addresses (a
        // few integer operations): hoisted out of the walk, they are what
        // ptxas spills at D 128
        uint32_t ka = k_addr, va = v_addr;
        if constexpr (Q8) asm volatile("" : "+r"(ka), "+r"(va));
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        scores<D>(st, ka, kBox, q_addr);
        scores<D>(dpt, va, kBox, do_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // the box starts (row_off + q0) % 4 rows before the tile
        const float* ld = lds + stage * 2 * kLdPitch + ((row_off + q0) & 3);
        if (tm.full(h, q0, kBQd, kr0, 64))
          dscore(std::false_type{}, q0, ld, tm);
        else
          dscore(std::true_type{}, q0, ld, tm);

        // dV += P^T . dO and dK += dS^T . Q: dO and Q MN-major, 16 query
        // rows a step; Q8: each hi part's products, then the lo part's
        fence_regs(pf);
        fence_regs(dsf);
        if constexpr (Q8) {
          fence_regs(pf_lo);
          fence_regs(dsf_lo);
        }
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kBQd / 16; ++kc) sum_mma<D>(dv_acc, pf[kc], do_addr + kc * 2048);
        if constexpr (Q8) {
#pragma unroll
          for (int kc = 0; kc < kBQd / 16; ++kc)
            sum_mma<D>(dv_acc, pf_lo[kc], do_addr + kc * 2048);
        }
#pragma unroll
        for (int kc = 0; kc < kBQd / 16; ++kc) sum_mma<D>(dk_acc, dsf[kc], q_addr + kc * 2048);
        if constexpr (Q8) {
#pragma unroll
          for (int kc = 0; kc < kBQd / 16; ++kc)
            sum_mma<D>(dk_acc, dsf_lo[kc], q_addr + kc * 2048);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pf);
        fence_regs(dsf);
        if constexpr (Q8) {
          fence_regs(pf_lo);
          fence_regs(dsf_lo);
        }
        mbar_arrive(&empty[stage]);  // Q, dO, lse and delta of this tile are consumed
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if constexpr (Q8) {
      // the rows' addresses anew from opaque copies of the item's indices:
      // the seed's, kept across the walk, cost it spills at D 128
      int eb = it.b, ehk = it.hk, ekey[2] = {key[0], key[1]};
      asm volatile("" : "+r"(eb), "+r"(ehk), "+r"(ekey[0]), "+r"(ekey[1]));
      store_rows<D>(dk_acc, dk + eb * sdk.b + ehk * sdk.h, sdk.s, ekey, S, tq);
      store_rows<D>(dv_acc, dv + eb * sdv.b + ehk * sdv.h, sdv.s, ekey, S, tq);
    } else {
      mbar_arrive(kv_empty);  // K and V are read: the next item's may load
      store_rows<D>(dk_acc, dk_b, sdk.s, key, S, tq);
      store_rows<D>(dv_acc, dv_b, sdv.s, key, S, tq);
    }
  }
}

template <int D, typename Mask, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_lse,
                          const __grid_constant__ CUtensorMap map_delta, Out* __restrict__ dk,
                          Out* __restrict__ dv, Strides4 sdk, Strides4 sdv, int B, int Hq,
                          int Hkv, int S, float scale, Mask mask) {
  attn_bwd_dkv_wgmma_body<D, Mask, Out, false>(&map_q, &map_k, &map_v, &map_do, &map_lse,
                                               &map_delta, KvS8{}, dk, dv, sdk, sdv, B, Hq, Hkv,
                                               S, scale, mask);
}

// the int8 K/V lane (accumulate mode): dk, dv fp32, updated in place
template <int D, typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkv_wgmma_s8_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_lse,
                             const __grid_constant__ CUtensorMap map_delta, const KvS8 kv,
                             float* __restrict__ dk, float* __restrict__ dv, Strides4 sdk,
                             Strides4 sdv, int B, int Hq, int Hkv, int S, float scale,
                             Mask mask) {
  attn_bwd_dkv_wgmma_body<D, Mask, float, true>(&map_q, nullptr, nullptr, &map_do, &map_lse,
                                                &map_delta, kv, dk, dv, sdk, sdv, B, Hq, Hkv, S,
                                                scale, mask);
}

// An output the epilogue's accesses take: 8-byte fp32 pairs, or 4-byte
// bf16 pairs on even strides
template <typename Out>
bool out_ok(const Out* p, const Strides4& st) {
  if (kAccumulate<Out>) return reinterpret_cast<uintptr_t>(p) % 8 == 0;
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && st.b % 2 == 0 && st.h % 2 == 0 &&
         st.s % 2 == 0;
}

// strides: (b, h, s) of q, k, v, do, dq in that order.  Out: float
// accumulates into dq, __nv_bfloat16 writes it.
template <int D, typename Mask, typename Out>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* delta, Out* dq, const long long* strides, int B, int Hq, int Hkv,
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
  const Strides4 sdq{strides[12], strides[13], strides[14]};
  if (!out_ok(dq, sdq)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_bwd_dq_wgmma_kernel<D, Mask, Out>;
  constexpr size_t smem = BwdLayout<D>::kDqSmem;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (S + kBQ - 1) / kBQ * Hq * B;  // persistent: one block an SM at most
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, lse, delta, dq, sdq, B, Hq, Hkv, S,
                                         scale, mask);
  return static_cast<int>(cudaGetLastError());
}

// The int8 K/V lane of the dq walk (ring_bwd_dq_s8): k, v int8 payloads,
// ks, vs their fp32 row scales [B, Hkv, S] contiguous; the rest as
// launch_bwd_dq<D, Mask, float>: strides (b, h, s) of q, k, v, do, dq (k's
// and v's in bytes, the elements' size), dq accumulated in place.
template <int D, typename Mask>
int launch_bwd_dq_s8(const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const void* dout, const float* lse, const float* delta,
                     float* dq, const long long* strides, int B, int Hq, int Hkv, int S,
                     float scale, Mask mask, cudaStream_t stream) {
  using L = DqLayoutS8<D>;
  if (B < 0 || S < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  CUtensorMap mq, mk, mv, mdo, mks, mvs;
  const long long rows = static_cast<long long>(B) * Hkv * S;
  if (!attn_map(&mq, q, B, Hq, S, D, strides, kBQ) ||
      !s8_map(&mk, k, B, Hkv, S, D, strides + 3, kBKd) ||
      !s8_map(&mv, v, B, Hkv, S, D, strides + 6, kBKd) ||
      !attn_map(&mdo, dout, B, Hq, S, D, strides + 9, kBQ) ||
      !rows_map(&mks, ks, rows, L::kScBox) || !rows_map(&mvs, vs, rows, L::kScBox))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides4 sdq{strides[12], strides[13], strides[14]};
  if (!out_ok(dq, sdq)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_bwd_dq_wgmma_s8_kernel<D, Mask>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (S + kBQ - 1) / kBQ * Hq * B;
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, L::kSmem, stream>>>(mq, mk, mv, mdo, mks, mvs, lse, delta, dq, sdq, B, Hq,
                                             Hkv, S, scale, mask);
  return static_cast<int>(cudaGetLastError());
}

// strides: (b, h, s) of q, k, v, do, dk, dv in that order.  Out: float
// accumulates into dk and dv, __nv_bfloat16 writes them.
template <int D, typename Mask, typename Out>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, Out* dk, Out* dv, const long long* strides, int B,
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
  const Strides4 sdk{strides[12], strides[13], strides[14]};
  const Strides4 sdv{strides[15], strides[16], strides[17]};
  if (!out_ok(dk, sdk) || !out_ok(dv, sdv)) return static_cast<int>(cudaErrorInvalidValue);
  // lse and delta: 1-D maps over the B * Hq * S rows, kLdBox a box, 32-bit
  // coordinates
  const long long rows = static_cast<long long>(B) * Hq * S;
  CUtensorMap ml, md;
  if (!rows_map(&ml, lse, rows, kLdBox) || !rows_map(&md, delta, rows, kLdBox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_bwd_dkv_wgmma_kernel<D, Mask, Out>;
  constexpr size_t smem = BwdLayout<D>::kDkvSmem;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (S + kBK - 1) / kBK * Hkv * B;
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, ml, md, dk, dv, sdk, sdv, B, Hq, Hkv, S,
                                         scale, mask);
  return static_cast<int>(cudaGetLastError());
}

// The int8 K/V lane of the dk/dv walk (ring_bwd_dkv_s8): k, v int8
// payloads (rows 16-byte aligned), ks, vs their fp32 row scales [B, Hkv, S]
// contiguous; the rest as launch_bwd_dkv<D, Mask, float>: strides (b, h, s)
// of q, k, v, do, dk, dv (k's and v's in bytes, the elements' size), dk and
// dv accumulated in place.
template <int D, typename Mask>
int launch_bwd_dkv_s8(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const void* dout, const float* lse, const float* delta,
                      float* dk, float* dv, const long long* strides, int B, int Hq, int Hkv,
                      int S, float scale, Mask mask, cudaStream_t stream) {
  if (B < 0 || S < 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  CUtensorMap mq, mdo, ml, md;
  const long long rows = static_cast<long long>(B) * Hq * S;
  if (!attn_map(&mq, q, B, Hq, S, D, strides, kBQd) ||
      !attn_map(&mdo, dout, B, Hq, S, D, strides + 9, kBQd) || !rows_map(&ml, lse, rows, kLdBox) ||
      !rows_map(&md, delta, rows, kLdBox))
    return static_cast<int>(cudaErrorInvalidValue);
  const KvS8 kv{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ks, vs,
                Strides4{strides[3], strides[4], strides[5]},
                Strides4{strides[6], strides[7], strides[8]}};
  auto rows_ok = [](const void* p, const Strides4& st) {  // 16-byte row loads
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 16 == 0 && st.h % 16 == 0 &&
           st.s % 16 == 0;
  };
  if (!rows_ok(k, kv.sk) || !rows_ok(v, kv.sv)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides4 sdk{strides[12], strides[13], strides[14]};
  const Strides4 sdv{strides[15], strides[16], strides[17]};
  if (!out_ok(dk, sdk) || !out_ok(dv, sdv)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = attn_bwd_dkv_wgmma_s8_kernel<D, Mask>;
  constexpr size_t smem = BwdLayout<D>::kDkvSmem + 2 * kBK * sizeof(float);  // + the scales
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (S + kBK - 1) / kBK * Hkv * B;
  const int grid = std::min(items, hopper_host::sm_count());
  kern<<<grid, kThreads, smem, stream>>>(mq, mdo, ml, md, kv, dk, dv, sdk, sdv, B, Hq, Hkv, S,
                                         scale, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_wg
