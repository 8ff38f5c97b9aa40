// Blockwise symmetric int8/int4 quantize, dequantize and fake-quantize, Hopper.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/quantize.py:
// `_quant_kernel` (:78, launched by `quantize`), `_dequant_kernel` (:125,
// `dequantize`) and `_fake_quant_kernel` (:158, `fake_quantize`).  The
// tensor is viewed as [M, N] rows whose last axis splits into `group`-wide
// groups (group a multiple of 128 dividing N: ops/quantize.py `supports`);
// each group has one fp32 scale, stored [M, N / group].
//
// Bound: bytes.  Quantize reads x once and writes the int8 payload and the
// scales once; dequantize reads payload and scales and writes the output
// once; fake-quantize reads x and writes the round trip, never the payload.
// A few flops per element, far below the ~295 flop/byte the H100 needs
// before its arithmetic binds.  The design: one warp per group.  Each lane
// reads 4 consecutive elements per vector load (8 or 16 bytes), so a warp
// reads 128 consecutive elements per instruction; for groups of up to 1024
// elements the group stays in registers between the absmax reduction
// (warp shuffles) and the quantize pass, so x is read from device memory
// once.  Larger groups read the group again in the second pass (an L1/L2
// hit: the warp read it just before).  Dequantize is elementwise, 4
// elements a thread, grid-stride.
//
// Arithmetic, the JAX kernel's, so the result equals the plain PyTorch
// version (and the JAX package) bit for bit: x is turned into fp32 first;
// scale = absmax / qmax (IEEE division, __fdiv_rn), 1.0 where 0;
// q = clip(rint(x / scale), -qmax - 1, qmax) with round-half-even (rintf);
// dequantize = q * scale (__fmul_rn) rounded once to the output type.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().  dtype codes: 0 fp32, 1 bf16, 2 fp16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // groups (warps) per block of the quantize kernels
constexpr int kRegVecs = 8;     // 4-element vectors a lane keeps in registers
constexpr int kThreads = 256;   // dequantize threads per block

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y);
  __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))), fabsf(v.w));
}

// clip(rint(x / scale), -qmax - 1, qmax), jnp.clip's order: max, then min
__device__ __forceinline__ float quant1(float x, float scale, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax - 1.f), qmax);
}

__device__ __forceinline__ float4 quant4(float4 v, float scale, float qmax) {
  return make_float4(quant1(v.x, scale, qmax), quant1(v.y, scale, qmax),
                     quant1(v.z, scale, qmax), quant1(v.w, scale, qmax));
}

__device__ __forceinline__ char4 to_char4(float4 q) {
  return make_char4(static_cast<signed char>(q.x), static_cast<signed char>(q.y),
                    static_cast<signed char>(q.z), static_cast<signed char>(q.w));
}

__device__ __forceinline__ float4 scale4(float4 q, float s) {
  return make_float4(__fmul_rn(q.x, s), __fmul_rn(q.y, s), __fmul_rn(q.z, s), __fmul_rn(q.w, s));
}

// One warp per (row, group).  FAKE: write q * scale in T to `out` and
// neither payload nor scales; otherwise the int8 payload to `q` and the
// scale to `scales`.
template <typename T, bool FAKE>
__global__ void __launch_bounds__(kWarps * 32)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
             T* __restrict__ out, long long groups, int n, int group, float qmax) {
  const int lane = threadIdx.x & 31;
  const long long gid = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (gid >= groups) return;
  const int ng = n / group;
  const long long base = (gid / ng) * n + static_cast<long long>(gid % ng) * group;
  const T* xg = x + base;
  const int nvec = group / 4;
  const bool resident = nvec <= 32 * kRegVecs;

  float4 v[kRegVecs];
  float amax = 0.f;
  if (resident) {
#pragma unroll
    for (int i = 0; i < kRegVecs; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) {
        v[i] = load4(xg + 4 * j);
        amax = absmax4(amax, v[i]);
      }
    }
  } else {
    for (int j = lane; j < nvec; j += 32) amax = absmax4(amax, load4(xg + 4 * j));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  float scale = __fdiv_rn(amax, qmax);
  if (scale == 0.f) scale = 1.f;
  if (!FAKE && lane == 0) scales[gid] = scale;

  auto emit = [&](int j, float4 xv) {
    const float4 qv = quant4(xv, scale, qmax);
    if (FAKE) {
      store4(out + base + 4 * j, scale4(qv, scale));
    } else {
      *reinterpret_cast<char4*>(q + base + 4 * j) = to_char4(qv);
    }
  };
  if (resident) {
#pragma unroll
    for (int i = 0; i < kRegVecs; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) emit(j, v[i]);
    }
  } else {
    for (int j = lane; j < nvec; j += 32) emit(j, load4(xg + 4 * j));
  }
}

// out[e] = q[e] * scales[row, col / group], 4 elements a thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               T* __restrict__ out, long long nvec, int n, int group) {
  const int ng = n / group;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < nvec;
       j += static_cast<long long>(gridDim.x) * kThreads) {
    const long long e = 4 * j;
    const long long row = e / n;
    const int col = static_cast<int>(e - row * n);
    const float s = scales[row * ng + col / group];
    const char4 c = *reinterpret_cast<const char4*>(q + e);
    store4(out + e, scale4(make_float4(c.x, c.y, c.z, c.w), s));
  }
}

template <typename T, bool FAKE>
int launch_quant(const void* x, void* q, void* scales, void* out, long long m, int n,
                 int group, float qmax, cudaStream_t stream) {
  const long long groups = m * (n / group);
  if (groups == 0) return 0;
  const long long blocks = (groups + kWarps - 1) / kWarps;
  quant_kernel<T, FAKE><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales),
      static_cast<T*>(out), groups, n, group, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequant(const void* q, const void* scales, void* out, long long m, int n, int group,
                   cudaStream_t stream) {
  const long long nvec = m * n / 4;
  if (nvec == 0) return 0;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks an SM
  dequant_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<T*>(out),
      nvec, n, group);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long m, int n, int group) {
  return m < 0 || n <= 0 || group <= 0 || group % 4 != 0 || n % group != 0;
}

}  // namespace

// x [m, n] (dtype) -> q int8 [m, n] and scales fp32 [m, n / group]
extern "C" int quantize(int dtype, const void* x, void* q, void* scales, long long m, int n,
                        int group, float qmax, void* stream) {
  if (bad_shape(m, n, group)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_quant<float, false>(x, q, scales, nullptr, m, n, group, qmax, s);
    case 1: return launch_quant<__nv_bfloat16, false>(x, q, scales, nullptr, m, n, group, qmax, s);
    case 2: return launch_quant<__half, false>(x, q, scales, nullptr, m, n, group, qmax, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [m, n] (dtype) -> out [m, n] (dtype), the quantize-dequantize round trip
extern "C" int fake_quantize(int dtype, const void* x, void* out, long long m, int n, int group,
                             float qmax, void* stream) {
  if (bad_shape(m, n, group)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_quant<float, true>(x, nullptr, nullptr, out, m, n, group, qmax, s);
    case 1: return launch_quant<__nv_bfloat16, true>(x, nullptr, nullptr, out, m, n, group, qmax, s);
    case 2: return launch_quant<__half, true>(x, nullptr, nullptr, out, m, n, group, qmax, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q int8 [m, n] and scales fp32 [m, n / group] -> out [m, n] (out_dtype)
extern "C" int dequantize(int out_dtype, const void* q, const void* scales, void* out,
                          long long m, int n, int group, void* stream) {
  if (bad_shape(m, n, group)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch_dequant<float>(q, scales, out, m, n, group, s);
    case 1: return launch_dequant<__nv_bfloat16>(q, scales, out, m, n, group, s);
    case 2: return launch_dequant<__half>(q, scales, out, m, n, group, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
