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
// The kernels are the 64 x 64 tile walks of attention_tiles.cuh in
// accumulate mode under the ring's mask (ring_offsets.cuh), with Q8 set
// (see that header's note):
//   * dtype 1 (bf16 q and do; route mma_s8): the payload widens to bf16
//     exactly and the row scales act on the key axis, s = ks[j] (q . kp_j),
//     dp = vs[j] (do . vp_j), p vs[j] into P.V and ds ks[j] into dS.K, and
//     p and ds as themselves into P^T.dO and dS^T.Q, each fp32 factor in
//     two bf16 parts (hi, lo), about 16 bits of it;
//   * dtype 0 (fp32 q; route fma_s8): a row decodes to fp32 on load, the
//     TPU's dequant bit for bit, and the fp32 walk runs as it always does.
// Position masks, dead tiles never visited, the S % 64 tail, GQA K/V
// unrepeated, D 64/128/256 (int8 rows of 64/128/256 bytes, 16-byte
// aligned) and the in-place fp32 state are the tile walk's own.
//
// Bound: the bf16 lane's products (2, 3 and 4 pair x d products a head for
// carry, dq and dk/dv over the hop's live pairs) with K/V bytes halved: at
// the training shape the hop is bound by its products.  The lanes run more
// than those (the lo parts' second product of P.V, dS.K, P^T.dO, dS^T.Q)
// on the wmma walk, not the wgmma walks: wgmma's B operand must be bf16 in
// shared memory, so an int8 lane there needs a widening pass (speed work).

#include "attention_tiles.cuh"
#include "ring_offsets.cuh"

namespace {

int ring_s8(Role role, int dtype, int D, AttnCall a, const void* k_scale,
            const void* v_scale, int causal, int window, int q_off, int k_off, int q_stride,
            int k_stride) {
  if (q_stride <= 0 || k_stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  return launch<true, true>(role, dtype, D, a,
                            RingOffsets{a.S, causal, window, q_off, k_off, q_stride, k_stride});
}

}  // namespace

// dtype: 0 fp32 q (and do), 1 bf16; k, v: int8 [B, Hkv, S, D] views with a
// contiguous D; k_scale, v_scale: fp32 [B, Hkv, S] contiguous; D 64, 128 or
// 256.  The rest as the entries of ring_attention.cu: m, l fp32 [B, Hq, S]
// contiguous; acc, dq fp32 [B, Hq, S, D]; dk, dv fp32 [B, Hkv, S, D]; all
// updated in place; strides (b, h, s) of each [B, H, S, D] operand in
// argument order (q, k, v, acc / do, dq / do, dk, dv); lse, delta fp32
// [B, Hq, S] contiguous.
extern "C" int ring_carry_s8(int dtype, const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale, void* m, void* l,
                             void* acc, const long long* strides, int B, int Hq, int Hkv, int S,
                             int D, float scale, int causal, int window, int q_off, int k_off,
                             int q_stride, int k_stride, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.lse_out = static_cast<float*>(m);
  a.l_io = static_cast<float*>(l);
  a.acc_io = static_cast<float*>(acc);
  return ring_s8(Role::kFwd, dtype, D, a, k_scale, v_scale, causal, window, q_off, k_off,
                 q_stride, k_stride);
}

extern "C" int ring_bwd_dq_s8(int dtype, const void* q, const void* k, const void* v,
                              const void* k_scale, const void* v_scale, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              const long long* strides, int B, int Hq, int Hkv, int S, int D,
                              float scale, int causal, int window, int q_off, int k_off,
                              int q_stride, int k_stride, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return ring_s8(Role::kBwdDq, dtype, D, a, k_scale, v_scale, causal, window, q_off, k_off,
                 q_stride, k_stride);
}

extern "C" int ring_bwd_dkv_s8(int dtype, const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv,
                               const long long* strides, int B, int Hq, int Hkv, int S, int D,
                               float scale, int causal, int window, int q_off, int k_off,
                               int q_stride, int k_stride, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return ring_s8(Role::kBwdDkv, dtype, D, a, k_scale, v_scale, causal, window, q_off, k_off,
                 q_stride, k_stride);
}
