// Block-sparse attention for training, Hopper: forward, backward dq,
// backward dk/dv under a DeepSpeed block layout.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_mha.py:
//   bsa_fwd     <- _fwd_kernel (:119, launched at :300)
//   bsa_bwd_dq  <- _dq_kernel  (:171, launched at :347)
//   bsa_bwd_dkv <- _dkv_kernel (:211, launched at :380)
// A layout [Hq, S/block, S/block] of 0/1 blocks, block 16 to 256 tokens (any
// block that divides S), gates which (query, key) pairs attend; causal
// composes on top.  The kernels are the tile walk of attention_tiles.cuh
// (the flash kernels' arithmetic) under the layout mask below.
//
// What differs from the TPU kernels:
//  * the TPU runs every grid step and skips dead tiles with pl.when, its
//    K/V DMAs clamped to the last live tile (_kv_pick).  Here a block walks
//    only its live tiles, from lists the host builds once per layout
//    (ops/block_sparse_mha.py SparseLayout): per (query head, q tile) the
//    live k tiles (fwd, dq), per (query head, k tile) the live q tiles
//    (dk/dv).  A dead tile costs nothing, and a dk/dv block skips a head of
//    its group for which the tile is dead (the TPU runs it under an
//    all-false mask when another head of the group is live: the same sums).
//  * inside a live tile the TPU expands the [tq, tk] layout slab to a token
//    mask with two 0/1 matmuls (_expand_mask); here each (row, col) reads
//    its layout block directly.  A 64-token tile may hold several layout
//    blocks or lie inside one, so any block size works.
//
// Bound: the work is the live tiles' products.  At the gpt2-350m training
// shape (S = 1024, d = 64, BSLongformer block 16, 3 window blocks, global
// block 0, causal) 45 of the 136 causal 64 x 64 tiles are live, so the
// kernels read q, k, v, do about as often as flash attention does for a
// third of the tiles; the scores stay in shared memory as in flash.

#include "attention_tiles.cuh"

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

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  strides: (b, h, s) of each
// [B, H, S, D] operand in argument order (q, k, v, o / do, dq / dk, dv).
// layout: uint8 [Hq, S/block, S/block]; k_ptr/k_idx and q_ptr/q_idx: int32
// live-tile lists over 64-row tiles (see BlockLayout).
extern "C" int bsa_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                       const long long* strides, const void* layout, const void* k_ptr,
                       const void* k_idx, const void* q_ptr, const void* q_idx, int B, int Hq,
                       int Hkv, int S, int D, int block, float scale, int causal, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.o = o;
  a.lse_out = static_cast<float*>(lse);
  return sparse(Role::kFwd, dtype, D, a, layout, k_ptr, k_idx, q_ptr, q_idx, block, causal);
}

extern "C" int bsa_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta, void* dq,
                          const long long* strides, const void* layout, const void* k_ptr,
                          const void* k_idx, const void* q_ptr, const void* q_idx, int B, int Hq,
                          int Hkv, int S, int D, int block, float scale, int causal,
                          void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return sparse(Role::kBwdDq, dtype, D, a, layout, k_ptr, k_idx, q_ptr, q_idx, block, causal);
}

extern "C" int bsa_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dk,
                           void* dv, const long long* strides, const void* layout,
                           const void* k_ptr, const void* k_idx, const void* q_ptr,
                           const void* q_idx, int B, int Hq, int Hkv, int S, int D, int block,
                           float scale, int causal, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return sparse(Role::kBwdDkv, dtype, D, a, layout, k_ptr, k_idx, q_ptr, q_idx, block, causal);
}
