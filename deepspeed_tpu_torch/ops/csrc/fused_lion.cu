// Fused multi-tensor Lion step, Hopper.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/fused_optimizer.py
// `_lion_kernel` (:133, launched per leaf by `fused_lion_leaf`, :146).  One
// launch steps every fp32 leaf of the param tree, from the same device
// tables as fused_adamw.cu: a leaf table of (p, g, m) pointers and sizes and
// a chunk table giving each thread block one (leaf, first element) run of up
// to 65536 elements (the role of the reference's csrc/lion/).
//
// Bound: bytes.  Each element reads p, g, m and writes p, m (20 bytes) for
// about 10 flops, so the least time is 20 bytes x elements / 3.35 TB/s.  The
// design streams each array once with 16-byte vector accesses (scalar for a
// misaligned leaf or a leaf's last < 4 elements); no reduction, no shared
// memory.
//
// Arithmetic, in the JAX kernel's order, each step rounded to fp32 and none
// contracted into a fused multiply-add (the __f*_rn intrinsics), so the
// result equals the plain PyTorch version bit for bit:
//   u = sign(b1*m + (1-b1)*g);  u += wd*p (wd != 0);  p = p - lr*u;
//   m = b2*m + (1-b2)*g
// sign as jnp.sign: +-1, and 0, -0 and NaN unchanged.  A sum next to 0 is
// where a contraction would flip u and move p by 2 lr: hence the intrinsics.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 1LL << 16;  // elements per block (ops/fused_optimizer.py CHUNK)

struct Hyper {
  float lr, b1, omb1, b2, omb2, wd;
};

__device__ __forceinline__ void lion(float& p, float g, float& m, const Hyper& h) {
  const float c = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  float u = c > 0.f ? 1.f : (c < 0.f ? -1.f : c);
  if (h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
  m = __fadd_rn(__fmul_rn(h.b2, m), __fmul_rn(h.omb2, g));
}

// leaves: [n_leaves, 4] int64 (p, g, m, numel); chunks: [n_chunks, 2]
// int64 (leaf, first element)
__global__ void __launch_bounds__(kThreads)
fused_lion_kernel(const long long* __restrict__ leaves, const long long* __restrict__ chunks,
                  Hyper h) {
  const long long leaf = chunks[2 * blockIdx.x];
  const long long start = chunks[2 * blockIdx.x + 1];
  const long long* row = leaves + 4 * leaf;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  float* m = reinterpret_cast<float*>(row[2]);
  const long long end = min(start + kChunk, row[3]);
  long long tail = start;
  if (((row[0] | row[1] | row[2]) & 15) == 0) {  // start is a multiple of 4
    const long long n4 = (end - start) / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const long long e = start + 4 * i;
      float4 P = *reinterpret_cast<float4*>(p + e);
      const float4 G = *reinterpret_cast<const float4*>(g + e);
      float4 M = *reinterpret_cast<float4*>(m + e);
      lion(P.x, G.x, M.x, h);
      lion(P.y, G.y, M.y, h);
      lion(P.z, G.z, M.z, h);
      lion(P.w, G.w, M.w, h);
      *reinterpret_cast<float4*>(p + e) = P;
      *reinterpret_cast<float4*>(m + e) = M;
    }
    tail = start + 4 * n4;
  }
  for (long long e = tail + threadIdx.x; e < end; e += kThreads) {
    float pe = p[e], me = m[e];
    lion(pe, g[e], me, h);
    p[e] = pe;
    m[e] = me;
  }
}

}  // namespace

extern "C" int fused_lion(const void* leaves, const void* chunks, int n_chunks, float lr, float b1,
                          float omb1, float b2, float omb2, float wd, void* stream) {
  if (n_chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  const Hyper h{lr, b1, omb1, b2, omb2, wd};
  fused_lion_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(leaves), static_cast<const long long*>(chunks), h);
  return static_cast<int>(cudaGetLastError());
}
