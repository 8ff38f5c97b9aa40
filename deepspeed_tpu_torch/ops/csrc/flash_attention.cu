// Flash attention for training, Hopper: forward, backward dq, backward dk/dv.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_mha.py:
//   flash_fwd     <- _fwd_kernel (:147, K/V resident) + _fwd_kernel_blocked (:286)
//   flash_bwd_dq  <- _dq_kernel (:172)  + _dq_kernel_blocked (:346)
//   flash_bwd_dkv <- _dkv_kernel (:192) + _dkv_kernel_blocked (:390)
// The TPU file splits each role into a VMEM-resident and a KV-blocked
// variant for its VMEM budget; one kernel per role serves every sequence
// length here and follows the blocked kernels' arithmetic.  The kernels are
// the tile walks of attention_tiles.cuh, attention_wgmma.cuh and
// attention_wgmma_bwd.cuh under the dense mask below.
//
// Bound: at the training shapes (S = 1024, d = 64, causal) the forward is
// just below the bytes line and the backward kernels are bound by their
// matrix products (2.5 to 4 causal S x S x d products per head), so the
// design keeps every score tile out of device memory.
//
// Each kernel has three routes, chosen by the caller (ops/flash_mha.py:
// `fwd_route` for the forward, `bwd_route`, which adds do, for the
// backward): 2 (wgmma) for bf16 views TMA can read, 1 (mma) for other bf16
// views and 0 (fma) for fp32.  On the wgmma route flash_fwd is the
// wgmma/TMA forward of attention_wgmma.cuh on 128 x 128 tiles, and
// flash_bwd_dq / flash_bwd_dkv are the persistent walks of
// attention_wgmma_bwd.cuh in store mode (sums from zero, written once in
// bf16): dq on 128-row query by 64-key tiles, dk/dv on 128-key by 64-row
// query tiles, interior tiles (every pair visible, `full`) without the mask
// test.  The other two routes run attn_fwd_kernel, attn_bwd_dq_kernel and
// attn_bwd_dkv_kernel of attention_tiles.cuh on 64 x 64 tiles, whose route
// code is their dtype code (0 fp32, 1 bf16).
//
// Dead tiles are loop bounds (the TPU's _clamped_kv_index): fwd/dq stop the
// key walk at the diagonal and start it at the window's edge, dk/dv start
// the query walk at the diagonal and stop it past the window.

#include "attention_tiles.cuh"
#include "attention_wgmma_bwd.cuh"

namespace {

// Causal and sliding-window masking: key visible iff col <= row (causal)
// and row - col < window (window > 0).  TQ, TK: the walk's query and key
// tile rows (64 x 64 for attention_tiles.cuh, 128 x 128 for the wgmma
// forward, 128 x 64 for the wgmma dq and 64 x 128 for the wgmma dk/dv).
template <int TQ, int TK>
struct CausalWindowT {
  int S, causal, window;

  __device__ int k_begin(int, int iq) const {
    return window > 0 ? max(0, iq * TQ - window + 1) / TK : 0;
  }
  __device__ int k_end(int, int iq) const {
    const int n = (S + TK - 1) / TK;
    return causal ? min(n, (iq * TQ + TQ - 1) / TK + 1) : n;
  }
  __device__ int k_tile(int t) const { return t; }
  __device__ int q_begin(int, int ik) const { return causal ? ik * TK / TQ : 0; }
  __device__ int q_end(int, int ik) const {
    const int n = (S + TQ - 1) / TQ;
    return window > 0 ? min(n, (ik * TK + TK - 1 + window - 1) / TQ + 1) : n;
  }
  __device__ int q_tile(int t) const { return t; }
  __device__ bool ok(int, int row, int col) const {
    return row < S && col < S && (!causal || col <= row) && (window <= 0 || row - col < window);
  }
  // every (row, col) of rows [r0, r0 + rows) x cols [c0, c0 + cols) visible
  __device__ bool full(int, int r0, int rows, int c0, int cols) const {
    return r0 + rows <= S && c0 + cols <= S && (!causal || c0 + cols - 1 <= r0) &&
           (window <= 0 || r0 + rows - 1 - c0 < window);
  }
};
using CausalWindow = CausalWindowT<kTile, kTile>;

}  // namespace

// route: 0 fma (fp32), 1 mma (bf16), 2 wgmma (bf16 TMA reads).  D: 64 or 128 on
// every route, 256 on routes 0 and 1 (ops/flash_mha.py pads any other D).
// strides: (b, h, s) of each [B, H, S, D] operand in argument order (q, k,
// v, o / do, dq / dk, dv).  lse, delta: fp32 [B, Hq, S] contiguous.
extern "C" int flash_fwd(int route, const void* q, const void* k, const void* v, void* o,
                         void* lse, const long long* strides, int B, int Hq, int Hkv, int S, int D,
                         float scale, int causal, int window, void* stream) {
  if (route != 2) {
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.o = o;
    a.lse_out = static_cast<float*>(lse);
    return launch(Role::kFwd, route, D, a, CausalWindow{S, causal, window});
  }
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  using Wide = CausalWindowT<flash_wg::kBQ, flash_wg::kBK>;
  const Wide mask{S, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return D == 64 ? flash_wg::launch<64, false>(q, k, v, o, l, nullptr, nullptr, strides, B, Hq,
                                               Hkv, S, scale, mask, s)
                 : flash_wg::launch<128, false>(q, k, v, o, l, nullptr, nullptr, strides, B, Hq,
                                                Hkv, S, scale, mask, s);
}

extern "C" int flash_bwd_dq(int route, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            const long long* strides, int B, int Hq, int Hkv, int S, int D,
                            float scale, int causal, int window, void* stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  if (route != 2) {
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.dout = dout;
    a.lse_in = ls;
    a.delta = dl;
    a.dq = dq;
    return launch(Role::kBwdDq, route, D, a, CausalWindow{S, causal, window});
  }
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  using Mask = CausalWindowT<flash_wg::kBQ, flash_wg::kBKd>;
  const Mask mask{S, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<__nv_bfloat16*>(dq);
  return D == 64 ? flash_wg::launch_bwd_dq<64>(q, k, v, dout, ls, dl, g, strides, B, Hq, Hkv, S,
                                               scale, mask, s)
                 : flash_wg::launch_bwd_dq<128>(q, k, v, dout, ls, dl, g, strides, B, Hq, Hkv, S,
                                                scale, mask, s);
}

extern "C" int flash_bwd_dkv(int route, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, const long long* strides, int B, int Hq, int Hkv, int S,
                             int D, float scale, int causal, int window, void* stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  if (route != 2) {
    AttnCall a = attn_call(q, k, v, strides, B, Hq, Hkv, S, scale, stream);
    a.dout = dout;
    a.lse_in = ls;
    a.delta = dl;
    a.dk = dk;
    a.dv = dv;
    return launch(Role::kBwdDkv, route, D, a, CausalWindow{S, causal, window});
  }
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  using Mask = CausalWindowT<flash_wg::kBQd, flash_wg::kBK>;
  const Mask mask{S, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto *gk = static_cast<__nv_bfloat16*>(dk), *gv = static_cast<__nv_bfloat16*>(dv);
  return D == 64 ? flash_wg::launch_bwd_dkv<64>(q, k, v, dout, ls, dl, gk, gv, strides, B, Hq,
                                                Hkv, S, scale, mask, s)
                 : flash_wg::launch_bwd_dkv<128>(q, k, v, dout, ls, dl, gk, gv, strides, B, Hq,
                                                 Hkv, S, scale, mask, s);
}
