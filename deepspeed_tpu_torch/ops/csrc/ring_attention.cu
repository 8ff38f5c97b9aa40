// Ring-attention hop kernels, Hopper: the forward carry, backward dq and
// backward dk/dv of one ring hop.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_mha.py:
//   ring_carry   <- _carry_kernel    (:471, via flash_carry_block :611)
//   ring_bwd_dq  <- _ring_dq_kernel  (:699, via flash_ring_dq_block :896)
//   ring_bwd_dkv <- _ring_dkv_kernel (:765, via flash_ring_dkv_block :955)
// A hop attends the rank's query block against a visiting K/V block.  Both
// blocks hold global positions off + stride * i (contiguous placement:
// stride 1, off = shard * S; striped placement: stride sp, off = shard), so
// the causal and window tests run on positions, not indices.  The kernels
// are the tile walk of attention_tiles.cuh in accumulate mode under the
// offset mask below:
//   * ring_carry reads the running (m, l, acc) of its query tile, walks the
//     live key tiles with the online softmax and writes (m, l, acc) back in
//     place, unnormalised (the caller divides once after the last hop);
//   * ring_bwd_dq adds the hop's dq into the incoming fp32 dq in place,
//     from p = exp(s - lse) against the shard's final lse;
//   * ring_bwd_dkv adds the visiting block's dk/dv into the traveling fp32
//     dk/dv in place; a block walks its GQA group's query heads itself, so
//     it owns its output tile and needs no atomics.
// The TPU passes the offsets as traced scalars in SMEM and skips dead tiles
// with pl.when (their DMAs still run); here the offsets are host ints given
// at launch and a dead tile is never visited: the policy's loop bounds come
// from the offsets.  The TPU's m/l carry is 128-lane replicated; here it is
// plain [B, Hq, S] fp32, and the tail (S % 64 != 0) is masked in the kernel
// with no padding copy.
//
// Bound: per hop the same products as a flash pass over the hop's live
// pairs (2, 3 and 4 pair x d products per head for carry, dq and dk/dv).
// At the training shape (S = 4096 a rank, d = 128, 32 query heads over 8 KV
// heads, bf16) a causal hop keeps about half of its S x S pairs under both
// placements, so the kernels are bound by their matrix products; the score
// tiles stay in shared memory, and the carry and fp32 accumulators are read
// and written once per hop.

#include "attention_tiles.cuh"

namespace {

// floor(a / d) and ceil(a / d) for d > 0 and a of either sign
__device__ __forceinline__ long long floor_div(long long a, long long d) {
  return a >= 0 ? a / d : -((-a + d - 1) / d);
}
__device__ __forceinline__ long long ceil_div(long long a, long long d) {
  return -floor_div(-a, d);
}

// Causal and sliding-window masking on global positions: query row r sits
// at q_off + q_stride * r, key col c at k_off + k_stride * c; key visible
// iff kpos <= qpos (causal) and qpos - kpos < window (window > 0).
struct RingOffsets {
  int S, causal, window, q_off, k_off, q_stride, k_stride;

  __device__ int n_tiles() const { return (S + kTile - 1) / kTile; }
  __device__ long long qpos(int r) const { return q_off + static_cast<long long>(q_stride) * r; }
  __device__ long long kpos(int c) const { return k_off + static_cast<long long>(k_stride) * c; }

  // key tiles of query tile iq: from the first column inside the window of
  // its first row to the last column the causal triangle of its last row keeps
  __device__ int k_begin(int, int iq) const {
    if (window <= 0) return 0;
    const long long c = ceil_div(qpos(iq * kTile) - window + 1 - k_off, k_stride);
    return c <= 0 ? 0 : static_cast<int>(min(c, static_cast<long long>(S)) / kTile);
  }
  __device__ int k_end(int, int iq) const {
    if (!causal) return n_tiles();
    const long long c = floor_div(qpos(min(iq * kTile + kTile - 1, S - 1)) - k_off, k_stride);
    return c < 0 ? 0 : static_cast<int>(min(c / kTile + 1, static_cast<long long>(n_tiles())));
  }
  __device__ int k_tile(int t) const { return t; }
  // query tiles of key tile ik: from the first row the causal triangle lets
  // see its first column to the last row whose window reaches its last column
  __device__ int q_begin(int, int ik) const {
    if (!causal) return 0;
    const long long r = ceil_div(kpos(ik * kTile) - q_off, q_stride);
    return r <= 0 ? 0 : static_cast<int>(min(r, static_cast<long long>(S)) / kTile);
  }
  __device__ int q_end(int, int ik) const {
    if (window <= 0) return n_tiles();
    const long long r =
        floor_div(kpos(min(ik * kTile + kTile - 1, S - 1)) + window - 1 - q_off, q_stride);
    return r < 0 ? 0 : static_cast<int>(min(r / kTile + 1, static_cast<long long>(n_tiles())));
  }
  __device__ int q_tile(int t) const { return t; }
  // per element: 32-bit positions (the wrapper checks that every global
  // position of the hop fits an int)
  __device__ bool ok(int, int row, int col) const {
    if (row >= S || col >= S) return false;
    const int qp = q_off + q_stride * row, kp = k_off + k_stride * col;
    return (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
  }
};

int ring(Role role, int dtype, int D, const AttnCall& a, int causal, int window, int q_off,
         int k_off, int q_stride, int k_stride) {
  if (q_stride <= 0 || k_stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(role, dtype, D, a,
                      RingOffsets{a.S, causal, window, q_off, k_off, q_stride, k_stride});
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, do).  m, l: fp32
// [B, Hq, S] contiguous; acc, dq: fp32 [B, Hq, S, D]; dk, dv: fp32
// [B, Hkv, S, D]; all updated in place.  strides: (b, h, s) of each
// [B, H, S, D] operand in argument order (q, k, v, acc / do, dq / do, dk,
// dv).  lse, delta: fp32 [B, Hq, S] contiguous.
extern "C" int ring_carry(int dtype, const void* q, const void* k, const void* v, void* m,
                          void* l, void* acc, const long long* strides, int B, int Hq, int Hkv,
                          int S, int D, float scale, int causal, int window, int q_off, int k_off,
                          int q_stride, int k_stride, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.lse_out = static_cast<float*>(m);
  a.l_io = static_cast<float*>(l);
  a.acc_io = static_cast<float*>(acc);
  return ring(Role::kFwd, dtype, D, a, causal, window, q_off, k_off, q_stride, k_stride);
}

extern "C" int ring_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq,
                           const long long* strides, int B, int Hq, int Hkv, int S, int D,
                           float scale, int causal, int window, int q_off, int k_off,
                           int q_stride, int k_stride, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return ring(Role::kBwdDq, dtype, D, a, causal, window, q_off, k_off, q_stride, k_stride);
}

extern "C" int ring_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, const long long* strides, int B, int Hq, int Hkv, int S,
                            int D, float scale, int causal, int window, int q_off, int k_off,
                            int q_stride, int k_stride, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return ring(Role::kBwdDkv, dtype, D, a, causal, window, q_off, k_off, q_stride, k_stride);
}
