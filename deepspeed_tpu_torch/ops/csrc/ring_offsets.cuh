// The ring hop's mask policy on global positions, shared by the ring
// kernels' libraries (ring_attention.cu: the fp32/bf16 routes;
// ring_attention_int8.cu: the int8 K/V lanes).  Query row r of a hop sits at
// q_off + q_stride * r and key col c at k_off + k_stride * c; the policy
// gives the tile walks of attention_tiles.cuh, attention_wgmma.cuh and
// attention_wgmma_bwd.cuh their live tiles and per-element test.

#pragma once

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
// iff kpos <= qpos (causal) and qpos - kpos < window (window > 0).  TQ, TK:
// the walk's query and key tile rows (64 x 64 for attention_tiles.cuh,
// 128 x 128 for the wgmma carry, 128 x 64 for the wgmma dq and 64 x 128
// for the wgmma dk/dv).
template <int TQ, int TK>
struct RingOffsetsT {
  int S, causal, window, q_off, k_off, q_stride, k_stride;

  __device__ int n_q() const { return (S + TQ - 1) / TQ; }
  __device__ int n_k() const { return (S + TK - 1) / TK; }
  __device__ long long qpos(int r) const { return q_off + static_cast<long long>(q_stride) * r; }
  __device__ long long kpos(int c) const { return k_off + static_cast<long long>(k_stride) * c; }

  // key tiles of query tile iq: from the first column inside the window of
  // its first row to the last column the causal triangle of its last row keeps
  __device__ int k_begin(int, int iq) const {
    if (window <= 0) return 0;
    const long long c = ceil_div(qpos(iq * TQ) - window + 1 - k_off, k_stride);
    return c <= 0 ? 0 : static_cast<int>(min(c, static_cast<long long>(S)) / TK);
  }
  __device__ int k_end(int, int iq) const {
    if (!causal) return n_k();
    const long long c = floor_div(qpos(min(iq * TQ + TQ - 1, S - 1)) - k_off, k_stride);
    return c < 0 ? 0 : static_cast<int>(min(c / TK + 1, static_cast<long long>(n_k())));
  }
  __device__ int k_tile(int t) const { return t; }
  // query tiles of key tile ik: from the first row the causal triangle lets
  // see its first column to the last row whose window reaches its last column
  __device__ int q_begin(int, int ik) const {
    if (!causal) return 0;
    const long long r = ceil_div(kpos(ik * TK) - q_off, q_stride);
    return r <= 0 ? 0 : static_cast<int>(min(r, static_cast<long long>(S)) / TQ);
  }
  __device__ int q_end(int, int ik) const {
    if (window <= 0) return n_q();
    const long long r =
        floor_div(kpos(min(ik * TK + TK - 1, S - 1)) + window - 1 - q_off, q_stride);
    return r < 0 ? 0 : static_cast<int>(min(r / TQ + 1, static_cast<long long>(n_q())));
  }
  __device__ int q_tile(int t) const { return t; }
  // per element: 32-bit positions (the wrapper checks that every global
  // position of the hop fits an int)
  __device__ bool ok(int, int row, int col) const {
    if (row >= S || col >= S) return false;
    const int qp = q_off + q_stride * row, kp = k_off + k_stride * col;
    return (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
  }
  // every (row, col) of rows [r0, r0 + rows) x cols [c0, c0 + cols)
  // visible.  Positions rise with the index (positive strides), so the
  // causal test takes the last column against the first row and the window
  // test the last row against the first column.
  __device__ bool full(int, int r0, int rows, int c0, int cols) const {
    return r0 + rows <= S && c0 + cols <= S && (!causal || kpos(c0 + cols - 1) <= qpos(r0)) &&
           (window <= 0 || qpos(r0 + rows - 1) - kpos(c0) < window);
  }
};
using RingOffsets = RingOffsetsT<kTile, kTile>;

}  // namespace
