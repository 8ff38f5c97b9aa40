// Block-sparse attention for training, Hopper: forward, backward dq,
// backward dk/dv under a DeepSpeed block layout.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_mha.py:
//   bsa_fwd     <- _fwd_kernel (:119, launched at :300)
//   bsa_bwd_dq  <- _dq_kernel  (:171, launched at :347)
//   bsa_bwd_dkv <- _dkv_kernel (:211, launched at :380)
// A layout [Hq, S/block, S/block] of 0/1 blocks, block 16 to 256 tokens (any
// block that divides S), gates which (query, key) pairs attend; causal
// composes on top.  The kernels are the tile walks of attention_tiles.cuh,
// attention_wgmma.cuh and attention_wgmma_bwd.cuh (the flash kernels'
// arithmetic) under the layout masks below.
//
// What differs from the TPU kernels:
//  * the TPU runs every grid step and skips dead tiles with pl.when, its
//    K/V DMAs clamped to the last live tile (_kv_pick).  Here a block walks
//    only its live tiles, from lists the host builds once per layout
//    (ops/block_sparse_mha.py SparseLayout), at each walk's tile shape.  A
//    dead tile costs nothing, and a dk/dv item skips a head of its group
//    for which the tile is dead (the TPU runs it under an all-false mask
//    when another head of the group is live: the same sums).
//  * inside a live tile the TPU expands the [tq, tk] layout slab to a token
//    mask with two 0/1 matmuls (_expand_mask).  Here the 64 x 64 walk reads
//    each (row, col)'s layout byte, and the wgmma walks test a bit held in
//    registers (below).
//
// Routes: each kernel takes a route code, chosen by the caller before the
// launch (ops/block_sparse_mha.py): 0 fma and 1 mma, the 64 x 64 walk; 2
// wgmma, for bf16 views TMA reads, D 64 or 128 and layout blocks of at
// least 16: bsa_fwd runs the persistent forward of attention_wgmma.cuh and
// bsa_bwd_dq / bsa_bwd_dkv the persistent walks of attention_wgmma_bwd.cuh,
// all in store mode (o or the sums written once in bf16) under BlockLayoutT.
//
// Bound, and what the wgmma design does about it: the work is the live
// tiles' products.  At the gpt2-350m training shape (B 8, H 16, S 1024, D
// 64, BSLongformer block 16, 3 window blocks, global block 0, causal) the
// layout keeps 40,704 of a head's 524,800 causal pairs, and the bytes of q,
// k, v (and do) and the outputs bound every role (forward 0.020 ms,
// backward pair 0.025 / 0.030 ms at 3.35 TB/s) above its products.  The
// 64 x 64 walk visited 45 tiles a head with a block a tile and a layout
// byte read from device memory, with a division by the block, for every
// score entry: every tile of that layout is masked (none is full at block
// 16).  The wgmma walks visit 21 (forward: 128-row items over 128-key
// tiles), 30 (dq: 128-row items over 64-key tiles, at most 4 an item) and
// 36 (dk/dv: 128-key items over 64-row query tiles; the item holding
// global key block 0 walks 16) live tiles a head, one persistent block an
// SM, and test the mask in registers: the host stores with each list entry
// the tile's layout as 64-bit words, one per layout block of the item's
// fixed side (a forward or dq item's rows, a dk/dv item's keys; at most 9
// blocks of at least 16 span 128 rows) and per 64 of the walked side (two
// for the forward's 128-key tiles), bit c set where column (forward, dq)
// or row (dk/dv) c of the walked tile lies in a live block.  A thread loads
// its two rows' (keys') words when the tile is taken, before its products,
// shifts them to its own columns, and then pays one bit test and the causal
// compare for each entry (word and bit index fold to immediates; the
// forward clears the columns past each row in its words once a tile, and
// pays the bit test alone).  A
// host-built flag for each 64 x 64 tile (every block live, inside S, below
// the diagonal when causal) sends tiles whose every 64 x 64 part is full
// down the maskless body.  Blocks under 16 would need more words than a
// thread keeps: the caller routes them to the 64 x 64 walk.  What the mask
// test costs shows in chip_smoke.py's sparse rows beside the kernel's time
// (all_tiles_maskless_ms: the same walks with every full flag set, wrong
// numbers, timed only; PERF.md §6 records both).

#include "attention_tiles.cuh"
#include "attention_wgmma_bwd.cuh"

namespace {

struct BlockLayout {
  int S, causal, block, nb, n_tiles;
  const uint8_t* layout;  // [Hq, nb, nb], nb = S / block
  const int* k_ptr;       // [Hq * n_tiles + 1]: live k tiles of (h, iq) at k_idx[k_ptr[.]..]
  const int* k_idx;
  const int* q_ptr;       // [Hq * n_tiles + 1]: live q tiles of (h, ik) at q_idx[q_ptr[.]..]
  const int* q_idx;

  __device__ int k_begin(int h, int iq) const { return k_ptr[h * n_tiles + iq]; }
  __device__ int k_end(int h, int iq) const { return k_ptr[h * n_tiles + iq + 1]; }
  __device__ int k_tile(int t) const { return k_idx[t]; }
  __device__ int q_begin(int h, int ik) const { return q_ptr[h * n_tiles + ik]; }
  __device__ int q_end(int h, int ik) const { return q_ptr[h * n_tiles + ik + 1]; }
  __device__ int q_tile(int t) const { return q_idx[t]; }
  __device__ bool ok(int h, int row, int col) const {
    return row < S && col < S && (!causal || col <= row) &&
           layout[(static_cast<long long>(h) * nb + row / block) * nb + col / block] != 0;
  }
};

int sparse(Role role, int dtype, int D, AttnCall a, const void* layout, const void* k_ptr,
           const void* k_idx, const void* q_ptr, const void* q_idx, int block, int causal) {
  if (block <= 0 || a.S % block != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BlockLayout mask{a.S,
                         causal,
                         block,
                         a.S / block,
                         (a.S + kTile - 1) / kTile,
                         static_cast<const uint8_t*>(layout),
                         static_cast<const int*>(k_ptr),
                         static_cast<const int*>(k_idx),
                         static_cast<const int*>(q_ptr),
                         static_cast<const int*>(q_idx)};
  return launch(role, dtype, D, a, mask);
}

// layout words a list entry of the wgmma walks holds: the layout blocks a
// 128-row (or 128-key) item spans at blocks of at least kMinBlock
constexpr int kSlots = 9, kMinBlock = 16;

// The block layout on the wgmma walks' TQ x TK tiles: 128 x 128 for the
// forward and 128 x 64 for dq (an item holds 128 query rows and walks key
// tiles), 64 x 128 for dk/dv (an item holds 128 keys and walks 64-row query
// tiles).  ptr/idx list the live walked tiles of each (query head, item);
// bits holds kSlots * kWords words an entry, kWords (one a 64 rows or
// columns of the walked tile) for each layout block first + j of the
// item's fixed side, bit c of word w for row or column 64 w + c of the
// walked tile; full64 [Hq, n64, n64] flags the 64 x 64 tiles whose every
// pair is visible.
template <int TQ, int TK>
struct BlockLayoutT {
  static constexpr bool kRowsFixed = TQ >= TK;  // forward and dq: the item's side is rows
  static constexpr int kItem = kRowsFixed ? TQ : TK;
  static constexpr int kWords = (kRowsFixed ? TK : TQ) / 64;
  static_assert(kWords == 1 || kWords == 2, "a walked tile of 64 or 128");
  int S, causal, block, n_items, n64;
  const int* ptr;
  const int* idx;
  const unsigned long long* bits;
  const uint8_t* full64;

  __device__ int k_begin(int h, int iq) const { return ptr[h * n_items + iq]; }
  __device__ int k_end(int h, int iq) const { return ptr[h * n_items + iq + 1]; }
  __device__ int k_tile(int t) const { return idx[t]; }
  __device__ int q_begin(int h, int ik) const { return ptr[h * n_items + ik]; }
  __device__ int q_end(int h, int ik) const { return ptr[h * n_items + ik + 1]; }
  __device__ int q_tile(int t) const { return idx[t]; }

  // One walked tile as a thread sees it: its two fixed rows' (keys') words,
  // shifted to the thread's first column (row) of the walked tile, 2 * (lane
  // % 4) past the tile's first, where every walk's fragments start; w for
  // the first 64 of the walked side, x for the next 64 (kWords 2, the
  // forward, whose words also carry the causal test: the columns past the
  // row are cleared when the tile is taken, so an entry's test is one bit).
  // After unrolling, a fragment's offset from c0 is a constant, so the
  // choice of word and the bit index fold to immediates.
  struct Tile {
    unsigned long long w0, w1, x0, x1;
    int f0, c0, causal;
    bool all;
    __device__ bool full(int, int, int, int, int) const { return all; }
    __device__ bool ok(int, int row, int col) const {
      const int fixed = kRowsFixed ? row : col, walked = kRowsFixed ? col : row;
      if constexpr (kWords == 1) {
        const unsigned long long w = fixed == f0 ? w0 : w1;
        return (static_cast<unsigned>(w >> (walked - c0)) & 1u) != 0 && (!causal || col <= row);
      } else {
        const int c = walked - c0;
        const unsigned long long w = fixed == f0 ? (c < 64 ? w0 : x0) : (c < 64 ? w1 : x1);
        const unsigned half = (c & 63) < 32 ? static_cast<unsigned>(w)
                                            : static_cast<unsigned>(w >> 32);
        return ((half >> (c & 31)) & 1u) != 0;
      }
    }
  };
  // bits 0..lim of a word (none below 0, all from 63)
  __device__ static unsigned long long prefix(int lim) {
    return lim < 0 ? 0ull : lim >= 63 ? ~0ull : (2ull << lim) - 1ull;
  }
  // t: the list entry; walk0: the walked tile's first column (row); sub0:
  // the warpgroup's first fixed row (key); fixed: the thread's two
  __device__ Tile tile(int h, int t, int walk0, int sub0, const int (&fixed)[2]) const {
    const int first = (sub0 - sub0 % kItem) / block;  // the item's first layout block
    const int lane2 = 2 * (static_cast<int>(threadIdx.x) & 3);
    const unsigned long long* e = bits + static_cast<long long>(t) * (kSlots * kWords);
    Tile r;
    if constexpr (kWords == 1) {
      r.w0 = fixed[0] < S ? e[fixed[0] / block - first] >> lane2 : 0ull;
      r.w1 = fixed[1] < S ? e[fixed[1] / block - first] >> lane2 : 0ull;
      r.x0 = r.x1 = 0ull;
    } else {
      const unsigned long long* e0 = e + 2 * (fixed[0] / block - first);
      const unsigned long long* e1 = e + 2 * (fixed[1] / block - first);
      r.w0 = fixed[0] < S ? e0[0] >> lane2 : 0ull;
      r.x0 = fixed[0] < S ? e0[1] >> lane2 : 0ull;
      r.w1 = fixed[1] < S ? e1[0] >> lane2 : 0ull;
      r.x1 = fixed[1] < S ? e1[1] >> lane2 : 0ull;
      if (causal) {  // keep offsets c with walk0 + lane2 + c <= row
        const int lim0 = fixed[0] - walk0 - lane2, lim1 = fixed[1] - walk0 - lane2;
        r.w0 &= prefix(lim0);
        r.x0 &= prefix(lim0 - 64);
        r.w1 &= prefix(lim1);
        r.x1 &= prefix(lim1 - 64);
      }
    }
    r.f0 = fixed[0];
    r.c0 = walk0 + lane2;
    r.causal = causal;
    const int q64 = (kRowsFixed ? sub0 : walk0) / 64, k64 = (kRowsFixed ? walk0 : sub0) / 64;
    const uint8_t* f = full64 + (static_cast<long long>(h) * n64 + q64) * n64 + k64;
    if constexpr (kWords == 1)
      r.all = sub0 < S && *f != 0;
    else  // the forward asks about 64 rows x 128 keys: the two 64 x 64 tiles
      r.all = sub0 < S && k64 + 1 < n64 && f[0] != 0 && f[1] != 0;
    return r;
  }
};

// The wgmma route of bsa_fwd: the persistent forward of attention_wgmma.cuh
// (store mode: o and lse written once) at D 64 or 128 under BlockLayoutT
// on 128 x 128 tiles.
int sparse_wgmma_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                     const long long* strides, int B, int Hq, int Hkv, int S, int D, int block,
                     float scale, int causal, const void* ptr, const void* idx, const void* bits,
                     const void* full, cudaStream_t stream) {
  if ((D != 64 && D != 128) || block < kMinBlock || S % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using Mask = BlockLayoutT<flash_wg::kBQ, flash_wg::kBK>;
  const Mask mask{S,
                  causal,
                  block,
                  (S + flash_wg::kBQ - 1) / flash_wg::kBQ,
                  (S + 63) / 64,
                  static_cast<const int*>(ptr),
                  static_cast<const int*>(idx),
                  static_cast<const unsigned long long*>(bits),
                  static_cast<const uint8_t*>(full)};
  return D == 64 ? flash_wg::launch<64, false>(q, k, v, o, lse, nullptr, nullptr, strides, B, Hq,
                                               Hkv, S, scale, mask, stream)
                 : flash_wg::launch<128, false>(q, k, v, o, lse, nullptr, nullptr, strides, B, Hq,
                                                Hkv, S, scale, mask, stream);
}

// The wgmma route of bsa_bwd_dq (DQ) or bsa_bwd_dkv: the store-mode walks
// of attention_wgmma_bwd.cuh at D 64 or 128 under BlockLayoutT.
template <bool DQ>
int sparse_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* out0, void* out1, const long long* strides, int B,
                 int Hq, int Hkv, int S, int D, int block, float scale, int causal,
                 const void* ptr, const void* idx, const void* bits, const void* full,
                 cudaStream_t stream) {
  if ((D != 64 && D != 128) || block < kMinBlock || S % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const int n_items = (S + 127) / 128, n64 = (S + 63) / 64;
  const auto* p = static_cast<const int*>(ptr);
  const auto* ix = static_cast<const int*>(idx);
  const auto* w = static_cast<const unsigned long long*>(bits);
  const auto* f = static_cast<const uint8_t*>(full);
  if constexpr (DQ) {
    using Mask = BlockLayoutT<flash_wg::kBQ, flash_wg::kBKd>;
    const Mask mask{S, causal, block, n_items, n64, p, ix, w, f};
    auto* g = static_cast<bf*>(out0);
    return D == 64 ? flash_wg::launch_bwd_dq<64>(q, k, v, dout, lse, delta, g, strides, B, Hq,
                                                 Hkv, S, scale, mask, stream)
                   : flash_wg::launch_bwd_dq<128>(q, k, v, dout, lse, delta, g, strides, B, Hq,
                                                  Hkv, S, scale, mask, stream);
  } else {
    using Mask = BlockLayoutT<flash_wg::kBQd, flash_wg::kBK>;
    const Mask mask{S, causal, block, n_items, n64, p, ix, w, f};
    auto *gk = static_cast<bf*>(out0), *gv = static_cast<bf*>(out1);
    return D == 64 ? flash_wg::launch_bwd_dkv<64>(q, k, v, dout, lse, delta, gk, gv, strides, B,
                                                  Hq, Hkv, S, scale, mask, stream)
                   : flash_wg::launch_bwd_dkv<128>(q, k, v, dout, lse, delta, gk, gv, strides,
                                                   B, Hq, Hkv, S, scale, mask, stream);
  }
}

}  // namespace

// route: 0 fma (fp32), 1 mma (bf16), the 64 x 64 walk; 2 wgmma (bf16 TMA
// reads, D 64 or 128, block >= 16), chosen by the caller
// (ops/block_sparse_mha.py fwd_route / bwd_route).  strides: (b, h, s) of
// each [B, H, S, D] operand in argument order (q, k, v, o / do, dq / dk,
// dv).  layout: uint8 [Hq, S/block, S/block]; k_ptr/k_idx and q_ptr/q_idx:
// int32 live-tile lists over 64 x 64 tiles (see BlockLayout);
// wg_ptr/wg_idx/wg_bits/wg_full: the wgmma walk's lists, uint64 layout
// words and uint8 64 x 64 full flags (see BlockLayoutT; the forward's at
// 128 x 128, two words a slot, dq's at 128 x 64, dk/dv's at 64 x 128), read
// on route 2 only.
extern "C" int bsa_fwd(int route, const void* q, const void* k, const void* v, void* o, void* lse,
                       const long long* strides, const void* layout, const void* k_ptr,
                       const void* k_idx, const void* q_ptr, const void* q_idx,
                       const void* wg_ptr, const void* wg_idx, const void* wg_bits,
                       const void* wg_full, int B, int Hq, int Hkv, int S, int D, int block,
                       float scale, int causal, void* stream) {
  if (route == 2)
    return sparse_wgmma_fwd(q, k, v, o, static_cast<float*>(lse), strides, B, Hq, Hkv, S, D,
                            block, scale, causal, wg_ptr, wg_idx, wg_bits, wg_full,
                            static_cast<cudaStream_t>(stream));
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.o = o;
  a.lse_out = static_cast<float*>(lse);
  return sparse(Role::kFwd, route, D, a, layout, k_ptr, k_idx, q_ptr, q_idx, block, causal);
}

extern "C" int bsa_bwd_dq(int route, const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta, void* dq,
                          const long long* strides, const void* layout, const void* k_ptr,
                          const void* k_idx, const void* q_ptr, const void* q_idx,
                          const void* wg_ptr, const void* wg_idx, const void* wg_bits,
                          const void* wg_full, int B, int Hq, int Hkv, int S, int D, int block,
                          float scale, int causal, void* stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  if (route == 2)
    return sparse_wgmma<true>(q, k, v, dout, ls, dl, dq, nullptr, strides, B, Hq, Hkv, S, D,
                              block, scale, causal, wg_ptr, wg_idx, wg_bits, wg_full,
                              static_cast<cudaStream_t>(stream));
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = ls;
  a.delta = dl;
  a.dq = dq;
  return sparse(Role::kBwdDq, route, D, a, layout, k_ptr, k_idx, q_ptr, q_idx, block, causal);
}

extern "C" int bsa_bwd_dkv(int route, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dk,
                           void* dv, const long long* strides, const void* layout,
                           const void* k_ptr, const void* k_idx, const void* q_ptr,
                           const void* q_idx, const void* wg_ptr, const void* wg_idx,
                           const void* wg_bits, const void* wg_full, int B, int Hq, int Hkv,
                           int S, int D, int block, float scale, int causal, void* stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  if (route == 2)
    return sparse_wgmma<false>(q, k, v, dout, ls, dl, dk, dv, strides, B, Hq, Hkv, S, D, block,
                               scale, causal, wg_ptr, wg_idx, wg_bits, wg_full,
                               static_cast<cudaStream_t>(stream));
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = ls;
  a.delta = dl;
  a.dk = dk;
  a.dv = dv;
  return sparse(Role::kBwdDkv, route, D, a, layout, k_ptr, k_idx, q_ptr, q_idx, block, causal);
}
