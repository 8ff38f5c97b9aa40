// Flash attention for training, Hopper: forward, backward dq, backward dk/dv.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_mha.py:
//   flash_fwd     <- _fwd_kernel (:147, K/V resident) + _fwd_kernel_blocked (:286)
//   flash_bwd_dq  <- _dq_kernel (:172)  + _dq_kernel_blocked (:346)
//   flash_bwd_dkv <- _dkv_kernel (:192) + _dkv_kernel_blocked (:390)
// The TPU file splits each role into a VMEM-resident and a KV-blocked
// variant for its VMEM budget; one kernel per role serves every sequence
// length here and follows the blocked kernels' arithmetic.  The kernels are
// the tile walk of attention_tiles.cuh under the dense mask below.
//
// Bound: at the training shapes (S = 1024, d = 64, causal) the forward is
// just below the bytes line and the backward kernels are bound by their
// matrix products (2.5 to 4 causal S x S x d products per head), so the
// design keeps every score tile out of device memory: q, k, v, do are read
// once per tile pair into shared memory and the [64 x 64] score, p and ds
// tiles live only there.
//
// Dead tiles are loop bounds (the TPU's _clamped_kv_index): fwd/dq stop the
// key walk at the diagonal and start it at the window's edge, dk/dv start
// the query walk at the diagonal and stop it past the window.

#include "attention_tiles.cuh"

namespace {

// Causal and sliding-window masking: key visible iff col <= row (causal)
// and row - col < window (window > 0).
struct CausalWindow {
  int S, causal, window;

  __device__ int k_begin(int, int iq) const {
    return window > 0 ? max(0, iq * kTile - window + 1) / kTile : 0;
  }
  __device__ int k_end(int, int iq) const {
    const int n = (S + kTile - 1) / kTile;
    return causal ? min(n, iq + 1) : n;
  }
  __device__ int k_tile(int t) const { return t; }
  __device__ int q_begin(int, int ik) const { return causal ? ik : 0; }
  __device__ int q_end(int, int ik) const {
    const int n = (S + kTile - 1) / kTile;
    return window > 0 ? min(n, (ik * kTile + kTile - 1 + window - 1) / kTile + 1) : n;
  }
  __device__ int q_tile(int t) const { return t; }
  __device__ bool ok(int, int row, int col) const {
    return row < S && col < S && (!causal || col <= row) && (window <= 0 || row - col < window);
  }
};

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  strides: (b, h, s) of each
// [B, H, S, D] operand in argument order (q, k, v, o / do, dq / dk, dv).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                         void* lse, const long long* strides, int B, int Hq, int Hkv, int S, int D,
                         float scale, int causal, int window, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.o = o;
  a.lse_out = static_cast<float*>(lse);
  return launch(Role::kFwd, dtype, D, a, CausalWindow{S, causal, window});
}

extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            const long long* strides, int B, int Hq, int Hkv, int S, int D,
                            float scale, int causal, int window, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return launch(Role::kBwdDq, dtype, D, a, CausalWindow{S, causal, window});
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, const long long* strides, int B, int Hq, int Hkv, int S,
                             int D, float scale, int causal, int window, void* stream) {
  AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return launch(Role::kBwdDkv, dtype, D, a, CausalWindow{S, causal, window});
}
