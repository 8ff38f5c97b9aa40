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
// are the tile walks of attention_tiles.cuh (and, at bf16, the wgmma walks
// of attention_wgmma.cuh and attention_wgmma_bwd.cuh) in accumulate mode
// under the offset mask below:
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
// tiles stay on chip (shared memory on the tile walk, registers on the
// wgmma route), and the carry and fp32 accumulators are read and written
// once per hop.
//
// Each kernel has three routes, chosen by the caller (ops/flash_mha.py,
// by `fwd_route`'s rule for the carry and `bwd_route`'s, which adds do,
// for the backward): 2 (wgmma) for bf16 views TMA can read, 1 (mma) for
// other bf16 views and 0 (fma) for fp32.  On the wgmma route ring_carry is
// the persistent wgmma/TMA forward of attention_wgmma.cuh in accumulate
// mode on 128 x 128 tiles, ring_bwd_dq the dq walk of
// attention_wgmma_bwd.cuh on 128-row query by 64-key tiles and
// ring_bwd_dkv its dk/dv walk on 128-key by 64-row query tiles, whose
// interior tiles (every pair visible, `full`) skip the mask test; the
// other two routes are the kernels of attention_tiles.cuh on 64 x 64
// tiles.  Every route keeps m in natural units and the sums in fp32, so
// the hops of one ring may take any of them.
// The int8 K/V lanes of the quantized ring wire are ring_attention_int8.cu
// (a library of their own, built beside this one).

#include "attention_tiles.cuh"
#include "attention_wgmma_bwd.cuh"
#include "ring_offsets.cuh"

namespace {

int ring(Role role, int dtype, int D, const AttnCall& a, int causal, int window, int q_off,
         int k_off, int q_stride, int k_stride) {
  if (q_stride <= 0 || k_stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(role, dtype, D, a,
                      RingOffsets{a.S, causal, window, q_off, k_off, q_stride, k_stride});
}

// what the wgmma route takes beyond its launchers' own checks
bool wgmma_args_ok(int D, int q_stride, int k_stride) {
  return (D == 64 || D == 128) && q_stride > 0 && k_stride > 0;
}

}  // namespace

// route: 0 fma (fp32), 1 mma (bf16), 2 wgmma (bf16 TMA reads); D 64 or 128
// on every route, 256 on routes 0 and 1 (sequence/ring.py pads any other D
// before its hops).  m, l: fp32
// [B, Hq, S] contiguous; acc, dq: fp32 [B, Hq, S, D]; dk, dv: fp32
// [B, Hkv, S, D]; all updated in place.  strides: (b, h, s) of each
// [B, H, S, D] operand in argument order (q, k, v, acc / do, dq / do, dk,
// dv).  lse, delta: fp32 [B, Hq, S] contiguous.
extern "C" int ring_carry(int route, const void* q, const void* k, const void* v, void* m,
                          void* l, void* acc, const long long* strides, int B, int Hq, int Hkv,
                          int S, int D, float scale, int causal, int window, int q_off, int k_off,
                          int q_stride, int k_stride, void* stream) {
  if (route != 2) {  // the 64 x 64 tile walk: its route code is its dtype code
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.lse_out = static_cast<float*>(m);
    a.l_io = static_cast<float*>(l);
    a.acc_io = static_cast<float*>(acc);
    return ring(Role::kFwd, route, D, a, causal, window, q_off, k_off, q_stride, k_stride);
  }
  if (!wgmma_args_ok(D, q_stride, k_stride)) return static_cast<int>(cudaErrorInvalidValue);
  using Wide = RingOffsetsT<flash_wg::kBQ, flash_wg::kBK>;
  const Wide mask{S, causal, window, q_off, k_off, q_stride, k_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *mm = static_cast<float*>(m), *ll = static_cast<float*>(l), *aa = static_cast<float*>(acc);
  return D == 64 ? flash_wg::launch<64, true>(q, k, v, nullptr, mm, ll, aa, strides, B, Hq, Hkv,
                                              S, scale, mask, s)
                 : flash_wg::launch<128, true>(q, k, v, nullptr, mm, ll, aa, strides, B, Hq, Hkv,
                                               S, scale, mask, s);
}

extern "C" int ring_bwd_dq(int route, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq,
                           const long long* strides, int B, int Hq, int Hkv, int S, int D,
                           float scale, int causal, int window, int q_off, int k_off,
                           int q_stride, int k_stride, void* stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  if (route != 2) {
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.dout = dout;
    a.lse_in = ls;
    a.delta = dl;
    a.dq = dq;
    return ring(Role::kBwdDq, route, D, a, causal, window, q_off, k_off, q_stride, k_stride);
  }
  if (!wgmma_args_ok(D, q_stride, k_stride)) return static_cast<int>(cudaErrorInvalidValue);
  using Mask = RingOffsetsT<flash_wg::kBQ, flash_wg::kBKd>;
  const Mask mask{S, causal, window, q_off, k_off, q_stride, k_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(dq);
  return D == 64 ? flash_wg::launch_bwd_dq<64>(q, k, v, dout, ls, dl, g, strides, B, Hq, Hkv, S,
                                               scale, mask, s)
                 : flash_wg::launch_bwd_dq<128>(q, k, v, dout, ls, dl, g, strides, B, Hq, Hkv, S,
                                                scale, mask, s);
}

extern "C" int ring_bwd_dkv(int route, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, const long long* strides, int B, int Hq, int Hkv, int S,
                            int D, float scale, int causal, int window, int q_off, int k_off,
                            int q_stride, int k_stride, void* stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  if (route != 2) {
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.dout = dout;
    a.lse_in = ls;
    a.delta = dl;
    a.dk = dk;
    a.dv = dv;
    return ring(Role::kBwdDkv, route, D, a, causal, window, q_off, k_off, q_stride, k_stride);
  }
  if (!wgmma_args_ok(D, q_stride, k_stride)) return static_cast<int>(cudaErrorInvalidValue);
  using Mask = RingOffsetsT<flash_wg::kBQd, flash_wg::kBK>;
  const Mask mask{S, causal, window, q_off, k_off, q_stride, k_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *gk = static_cast<float*>(dk), *gv = static_cast<float*>(dv);
  return D == 64 ? flash_wg::launch_bwd_dkv<64>(q, k, v, dout, ls, dl, gk, gv, strides, B, Hq,
                                                Hkv, S, scale, mask, s)
                 : flash_wg::launch_bwd_dkv<128>(q, k, v, dout, ls, dl, gk, gv, strides, B, Hq,
                                                 Hkv, S, scale, mask, s);
}
