// Fused multi-tensor AdamW step, Hopper.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_optimizer.py
// `_adamw_kernel` (:77, launched per leaf by `fused_adamw_leaf`).  One
// launch steps every fp32 leaf of the param tree: a device table holds each
// leaf's p, g, m, v pointers and size, and a chunk table gives each thread
// block one (leaf, first element) run of up to 65536 elements (the role of
// the reference's csrc/adam/multi_tensor_adam.cu).  The JAX kernel serves
// only leaves whose last dim is a multiple of 128 lanes; this one serves
// every fp32 leaf with the same numbers.
//
// Bound: bytes.  Each element reads p, g, m, v and writes p, m, v (28 bytes)
// for about 15 flops: far below the ~295 flop/byte the H100 needs before its
// arithmetic binds, so the least time is 28 bytes x elements / 3.35 TB/s.
// The design streams each array once with 16-byte vector accesses (scalar
// for a misaligned leaf or a leaf's last < 4 elements) and keeps many blocks
// in flight; there is no reduction and no shared memory.
//
// Arithmetic, in the JAX kernel's order, each step rounded to fp32 and none
// contracted into a fused multiply-add (the __f*_rn intrinsics), so the
// result equals the plain PyTorch version bit for bit:
//   m = b1*m + (1-b1)*g;  v = b2*v + ((1-b2)*g)*g;
//   u = (m/bc1) / (sqrt(v/bc2) + eps);  u += wd*p;  p = p - lr*u
// with bc1 = 1 - b1^t, bc2 = 1 - b2^t formed on the host in fp32.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 1LL << 16;  // elements per block (ops/fused_optimizer.py CHUNK)

struct Hyper {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

// leaves: [n_leaves, 5] int64 (p, g, m, v, numel); chunks: [n_chunks, 2]
// int64 (leaf, first element)
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const long long* __restrict__ leaves, const long long* __restrict__ chunks,
                   Hyper h) {
  const long long leaf = chunks[2 * blockIdx.x];
  const long long start = chunks[2 * blockIdx.x + 1];
  const long long* row = leaves + 5 * leaf;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  float* m = reinterpret_cast<float*>(row[2]);
  float* v = reinterpret_cast<float*>(row[3]);
  const long long end = min(start + kChunk, row[4]);
  long long tail = start;
  if (((row[0] | row[1] | row[2] | row[3]) & 15) == 0) {  // start is a multiple of 4
    const long long n4 = (end - start) / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const long long e = start + 4 * i;
      float4 P = *reinterpret_cast<float4*>(p + e);
      const float4 G = *reinterpret_cast<const float4*>(g + e);
      float4 M = *reinterpret_cast<float4*>(m + e);
      float4 V = *reinterpret_cast<float4*>(v + e);
      adamw(P.x, G.x, M.x, V.x, h);
      adamw(P.y, G.y, M.y, V.y, h);
      adamw(P.z, G.z, M.z, V.z, h);
      adamw(P.w, G.w, M.w, V.w, h);
      *reinterpret_cast<float4*>(p + e) = P;
      *reinterpret_cast<float4*>(m + e) = M;
      *reinterpret_cast<float4*>(v + e) = V;
    }
    tail = start + 4 * n4;
  }
  for (long long e = tail + threadIdx.x; e < end; e += kThreads) {
    float pe = p[e], me = m[e], ve = v[e];
    adamw(pe, g[e], me, ve, h);
    p[e] = pe;
    m[e] = me;
    v[e] = ve;
  }
}

}  // namespace

extern "C" int fused_adamw(const void* leaves, const void* chunks, int n_chunks, float lr,
                           float bc1, float bc2, float b1, float omb1, float b2, float omb2,
                           float eps, float wd, void* stream) {
  if (n_chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  const Hyper h{lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd};
  fused_adamw_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(leaves), static_cast<const long long*>(chunks), h);
  return static_cast<int>(cudaGetLastError());
}
