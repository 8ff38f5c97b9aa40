// Ring-attention hop kernels, Hopper: the int8 K/V lanes of the forward
// carry, backward dq and backward dk/dv (the quantized ring wire).
//
// Replaces the quantized lanes of the TPU kernels of
// deepspeed_tpu/ops/pallas/flash_mha.py:
//   ring_carry_s8   <- _carry_kernel    (:471; its int8 lane :505-510)
//   ring_bwd_dq_s8  <- _ring_dq_kernel  (:699; :729-732)
//   ring_bwd_dkv_s8 <- _ring_dkv_kernel (:765; :795-797)
// With comm_quantization.ring_rotation "int8" (sequence/ring.py), a
// visiting hop's K/V arrive as int8 payload rows with one fp32 scale a row.
// The TPU kernels dequantize them in the tile load (wire_dequant_rows,
// :460: int8 to fp32 times the row scale) and compute the tile in fp32: q
// and do promoted, p and ds kept in fp32.  No fp32 or bf16 K/V copy exists
// in device memory here either.
//
// Three routes, chosen by the caller (ops/flash_mha.py, `ring_route`, per
// kernel), all in accumulate mode under the ring's mask (ring_offsets.cuh):
//   * 2, wgmma_s8 (bf16 q and do at D 64 and 128, every operand a view TMA
//     can read): the bf16 lane's wgmma walks with their int8 lane (template
//     flag Q8).  The carry is the persistent forward of attention_wgmma.cuh
//     and dq the dq walk of attention_wgmma_bwd.cuh, whose producer
//     warpgroups load the int8 tiles by TMA and widen them into the
//     swizzled bf16 stages their K/V tiles stream through; dk/dv is the
//     dk/dv walk of attention_wgmma_bwd.cuh, whose consumers widen their
//     resident K and V rows once an item straight from device memory.
//     Those headers say how.
//   * 1, mma_s8 (other bf16: D 256, expanded views): the 64 x 64 tile walks
//     of attention_tiles.cuh with Q8 set (see that header's note); D 256
//     has no wgmma walk in any lane, and a zero-stride view no tensor map.
//   * 0, fma_s8 (fp32 q): a row decodes to fp32 on load, the TPU's dequant
//     bit for bit, and the fp32 walk runs as it always does.
// On the bf16 routes the payload widens to bf16 exactly and the row scales
// act on the key axis, s = ks[j] (q . kp_j), dp = vs[j] (do . vp_j), p vs[j]
// into P.V and ds ks[j] into dS.K, and p and ds as themselves into P^T.dO
// and dS^T.Q, each fp32 factor in two bf16 parts (hi, lo), about 16 bits of
// it.  Position masks, dead tiles never visited, the sequence tail, GQA K/V
// unrepeated, int8 rows of D bytes (16-byte aligned) and the in-place fp32
// state are the walks' own; so is m's unit, so hops of one ring may take
// any route.
//
// Bound: the bf16 lane's products (2, 3 and 4 pair x d products a head for
// carry, dq and dk/dv over the hop's live pairs) with K/V bytes halved: at
// the training shape the hop is bound by its products.  The lanes run more
// than those: the lo parts' second product of P.V, dS.K, P^T.dO and dS^T.Q.

#include "attention_tiles.cuh"
#include "attention_wgmma_bwd.cuh"
#include "ring_offsets.cuh"

namespace {

int ring_s8(Role role, int route, int D, AttnCall a, const void* k_scale,
            const void* v_scale, int causal, int window, int q_off, int k_off, int q_stride,
            int k_stride) {
  if (q_stride <= 0 || k_stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  // the 64 x 64 tile walk: its route code is its dtype code
  return launch<true, true>(role, route, D, a,
                            RingOffsets{a.S, causal, window, q_off, k_off, q_stride, k_stride});
}

// what the wgmma_s8 route takes beyond its launchers' own checks
bool wgmma_args_ok(int D, const void* k_scale, const void* v_scale, int q_stride, int k_stride) {
  return (D == 64 || D == 128) && k_scale != nullptr && v_scale != nullptr && q_stride > 0 &&
         k_stride > 0;
}

}  // namespace

// route: 0 fma_s8 (fp32 q and do), 1 mma_s8 (bf16), 2 wgmma_s8 (bf16 TMA
// reads at D 64 and 128); k, v: int8
// [B, Hkv, S, D] views with a contiguous D; k_scale, v_scale: fp32
// [B, Hkv, S] contiguous; D 64, 128 or 256.  The rest as the entries of
// ring_attention.cu: m, l fp32 [B, Hq, S] contiguous; acc, dq fp32
// [B, Hq, S, D]; dk, dv fp32 [B, Hkv, S, D]; all updated in place; strides
// (b, h, s) of each [B, H, S, D] operand in argument order (q, k, v, acc /
// do, dq / do, dk, dv); lse, delta fp32 [B, Hq, S] contiguous.
extern "C" int ring_carry_s8(int route, const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale, void* m, void* l,
                             void* acc, const long long* strides, int B, int Hq, int Hkv, int S,
                             int D, float scale, int causal, int window, int q_off, int k_off,
                             int q_stride, int k_stride, void* stream) {
  if (route != 2) {
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.lse_out = static_cast<float*>(m);
    a.l_io = static_cast<float*>(l);
    a.acc_io = static_cast<float*>(acc);
    return ring_s8(Role::kFwd, route, D, a, k_scale, v_scale, causal, window, q_off, k_off,
                   q_stride, k_stride);
  }
  if (!wgmma_args_ok(D, k_scale, v_scale, q_stride, k_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  using Wide = RingOffsetsT<flash_wg::kBQ, flash_wg::kBK>;
  const Wide mask{S, causal, window, q_off, k_off, q_stride, k_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *ks = static_cast<const float*>(k_scale), *vs = static_cast<const float*>(v_scale);
  float *mm = static_cast<float*>(m), *ll = static_cast<float*>(l), *aa = static_cast<float*>(acc);
  return D == 64 ? flash_wg::launch_s8<64>(q, k, v, ks, vs, mm, ll, aa, strides, B, Hq, Hkv, S,
                                           scale, mask, s)
                 : flash_wg::launch_s8<128>(q, k, v, ks, vs, mm, ll, aa, strides, B, Hq, Hkv, S,
                                            scale, mask, s);
}

extern "C" int ring_bwd_dq_s8(int route, const void* q, const void* k, const void* v,
                              const void* k_scale, const void* v_scale, const void* dout,
                              const void* lse, const void* delta, void* dq,
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
    return ring_s8(Role::kBwdDq, route, D, a, k_scale, v_scale, causal, window, q_off, k_off,
                   q_stride, k_stride);
  }
  if (!wgmma_args_ok(D, k_scale, v_scale, q_stride, k_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  using Mask = RingOffsetsT<flash_wg::kBQ, flash_wg::kBKd>;
  const Mask mask{S, causal, window, q_off, k_off, q_stride, k_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *ks = static_cast<const float*>(k_scale), *vs = static_cast<const float*>(v_scale);
  float* g = static_cast<float*>(dq);
  return D == 64 ? flash_wg::launch_bwd_dq_s8<64>(q, k, v, ks, vs, dout, ls, dl, g, strides, B,
                                                  Hq, Hkv, S, scale, mask, s)
                 : flash_wg::launch_bwd_dq_s8<128>(q, k, v, ks, vs, dout, ls, dl, g, strides, B,
                                                   Hq, Hkv, S, scale, mask, s);
}

extern "C" int ring_bwd_dkv_s8(int route, const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv,
                               const long long* strides, int B, int Hq, int Hkv, int S, int D,
                               float scale, int causal, int window, int q_off, int k_off,
                               int q_stride, int k_stride, void* stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  if (route != 2) {
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.dout = dout;
    a.lse_in = ls;
    a.delta = dl;
    a.dk = dk;
    a.dv = dv;
    return ring_s8(Role::kBwdDkv, route, D, a, k_scale, v_scale, causal, window, q_off, k_off,
                   q_stride, k_stride);
  }
  if (!wgmma_args_ok(D, k_scale, v_scale, q_stride, k_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  using Mask = RingOffsetsT<flash_wg::kBQd, flash_wg::kBK>;
  const Mask mask{S, causal, window, q_off, k_off, q_stride, k_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *ks = static_cast<const float*>(k_scale), *vs = static_cast<const float*>(v_scale);
  float *gk = static_cast<float*>(dk), *gv = static_cast<float*>(dv);
  return D == 64 ? flash_wg::launch_bwd_dkv_s8<64>(q, k, v, ks, vs, dout, ls, dl, gk, gv, strides,
                                                   B, Hq, Hkv, S, scale, mask, s)
                 : flash_wg::launch_bwd_dkv_s8<128>(q, k, v, ks, vs, dout, ls, dl, gk, gv,
                                                    strides, B, Hq, Hkv, S, scale, mask, s);
}
