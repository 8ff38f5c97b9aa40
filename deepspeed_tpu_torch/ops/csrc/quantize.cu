// Blockwise symmetric int8/int4 quantize, dequantize and fake-quantize, Hopper.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/quantize.py:
// `_quant_kernel` (:78, launched by `quantize`), `_dequant_kernel` (:125,
// `dequantize`) and `_fake_quant_kernel` (:158, `fake_quantize`).  The
// tensor is viewed as [M, N] rows whose last axis splits into `group`-wide
// groups (group dividing N and a whole number of the 16-byte vectors the
// kernels read: ops/quantize.py `supports`); each group has one fp32
// scale, stored [M, N / group].
//
// Bound: bytes.  Quantize reads x once and writes the int8 payload and the
// scales once; dequantize reads payload and scales and writes the output
// once; fake-quantize reads x and writes the round trip, never the payload.
// A few flops per element, far below the ~295 flop/byte the H100 needs
// before its arithmetic binds.  So the design keeps loads in flight:
//  * quantize and fake-quantize (quant_kernel): a grid of the blocks the
//    card holds at once, each warp walking groups a grid's warps apart.
//    Lanes read 16-byte vectors, a warp 512 contiguous bytes an
//    instruction; a lane keeps its vectors of a group in registers (up to
//    8), and the warp issues the next group's loads before it reduces
//    (warp shuffles) and quantizes this one's, so x is read once and a
//    warp never waits on its loads with nothing in flight.  Larger groups
//    read the group again in a second pass (an L2 hit).  Stores are whole
//    vectors: the payload's 8 or 4 bytes a lane, fake-quantize's 16.
//  * the quotient x / scale is the IEEE one, but by a multiply with the
//    group's rounded reciprocal wherever that provably rounds to the same
//    integer (quant1): in the kernel before this design (one group a warp,
//    8-byte loads, a division an element) the division took about a sixth
//    of the time at the LoRA path's [4096, 14336] bf16, group 512 (H100
//    80GB HBM3, 700 W; tools/ring_int8_ablate.py quantize).  The grid is
//    the resident blocks: a block for every 8 warps' steps instead costs
//    quantize a quarter more there (fake-quantize, whose stores are as
//    large as its loads, a few percent less).
//  * few wide groups (the whole-row groups of qgZ's gradient chunks: 2
//    groups of 177M fp32 elements at gpt2-350m over two ranks) would leave
//    the one-warp-a-group walk two warps on the card (1373 ms against a
//    0.53 ms bound there).  When a group is read twice and the groups are
//    fewer than 4 a streaming multiprocessor, quantize spreads each group
//    over blocks instead: a grid over (chunk, group) takes each group's
//    absmax into its scale slot (atomicMax over the bits of non-negative
//    floats, which order as the floats do), one thread a group turns it
//    into the scale, and a second grid quantizes with it, element for
//    element the arithmetic of the walk.  (fake-quantize keeps the walk:
//    it has no scale slots, and no path runs it on such groups.)
//  * dequantize is elementwise, 4 elements a thread, grid-stride.
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

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarps = 8;       // warps per block of the quantize kernels
constexpr int kMaxVecs = 8;     // 16-byte vectors of a group a lane keeps in registers
constexpr int kThreads = 256;   // dequantize threads per block
// the reciprocal's fast path: scales in [2^-100, 2^100] (1 / scale and
// x / scale normal), quotients more than kTieGuard from a half-integer
constexpr float kScaleLo = 0x1p-100f, kScaleHi = 0x1p100f;
constexpr float kTieGuard = 0x1p-12f;

// lanes that take a group of nv 16-byte vectors: nv where it divides the
// warp (1, 2, 4, 8, 16 vectors: 32 / nv groups a warp step), else the
// whole warp (lanes past the group's last vector idle on it)
__host__ __device__ constexpr int lanes_of(int nv) {
  return nv < 32 && (nv & (nv - 1)) == 0 ? nv : 32;
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

__device__ __forceinline__ float4 scale4(float4 q, float s) {
  return make_float4(__fmul_rn(q.x, s), __fmul_rn(q.y, s), __fmul_rn(q.z, s), __fmul_rn(q.w, s));
}

// 16 bytes of T: kElems elements, as fp32 and back (rounded once)
template <typename T>
constexpr int kElems = 16 / static_cast<int>(sizeof(T));

template <typename T>
__device__ __forceinline__ void to_f32(uint4 raw, float (&f)[kElems<T>]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else {
      const float2 v = std::is_same<T, __half>::value
                           ? __half22float2(*reinterpret_cast<const __half2*>(&w[i]))
                           : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}
template <typename T>
__device__ __forceinline__ uint4 to_t(const float (&f)[kElems<T>]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      w[i] = __float_as_uint(f[i]);
    } else if constexpr (std::is_same<T, __half>::value) {
      const __half2 v = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    } else {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// four integer-valued floats in [-128, 127] as int8, byte 0 first
__device__ __forceinline__ uint32_t pack_s8x4(const float* q) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (static_cast<uint32_t>(static_cast<int>(q[i])) & 0xffu) << (8 * i);
  return w;
}

// clip(rint(x / scale), -qmax - 1, qmax), jnp.clip's order: max, then min;
// x / scale the IEEE quotient (__fdiv_rn).  fast (scale in [kScaleLo,
// kScaleHi], inv = 1 / scale rounded): x * inv is within 2^-15 of the
// rounded quotient (|x / scale| <= qmax + 1, two roundings of 2^-24
// relative each, plus the quotient's own half ulp), so where it lies more
// than kTieGuard from every half-integer both round to the same integer;
// nearer, the quotient is taken.
__device__ __forceinline__ float quant1(float x, float scale, float inv, bool fast, float qmax) {
  float r;
  if (fast) {
    const float y = __fmul_rn(x, inv);
    r = rintf(y);
    if (!(fabsf(fabsf(__fsub_rn(y, r)) - 0.5f) > kTieGuard)) r = rintf(__fdiv_rn(x, scale));
  } else {
    r = rintf(__fdiv_rn(x, scale));
  }
  return fminf(fmaxf(r, -qmax - 1.f), qmax);
}

// Groups are contiguous runs of `group` elements (x is [M, N] contiguous
// and N splits into whole groups): group g is x[g * group ..].  A group is
// V = group / E 16-byte vectors (E elements each); lg = lanes_of(V) lanes
// take it, lane l its vectors l, l + lg, ...: each load instruction of a
// warp reads up to 512 contiguous bytes (two groups side by side when lg
// is 16).
// A warp walks groups (pairs of groups) a grid's warps apart and issues
// the next step's loads before it reduces and quantizes this step's.  NV:
// vectors a lane keeps of a group (at least ceil(V / lg), at most
// kMaxVecs); 0: larger groups, read twice (absmax, then quantize; the
// second read hits L2).  FAKE: write q * scale in T to `out` and neither
// payload nor scales; otherwise the int8 payload to `q` and the scale to
// `scales`.
template <typename T, bool FAKE, int NV>
__global__ void __launch_bounds__(kWarps * 32)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
             T* __restrict__ out, long long groups, int group, float qmax) {
  constexpr int E = kElems<T>;
  const int lane = threadIdx.x & 31;
  const int nv = group / E, lg = lanes_of(nv);        // vectors of a group; lanes a group
  const int per = 32 / lg, gl = lane % lg;           // groups a step; this lane's place
  const int nvec = (nv + lg - 1) / lg;                // vectors a lane of a group
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long stride = (static_cast<long long>(gridDim.x) * blockDim.x >> 5) * per;
  long long g0 = warp * per;  // this step's first group
  const int sub = lane / lg;
  if (g0 >= groups) return;

  // the group's absmax over its lanes, its scale (1.0 where 0) and the
  // reciprocal's fast path; lane gl 0 writes the scale
  auto scale_of = [&](float amax, long long gid, float& scale, float& inv, bool& fast) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      if (off < lg) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    scale = __fdiv_rn(amax, qmax);
    if (scale == 0.f) scale = 1.f;
    inv = __frcp_rn(scale);
    fast = scale >= kScaleLo && scale <= kScaleHi;
    if (!FAKE && gl == 0 && gid < groups) scales[gid] = scale;
  };
  // vector j of group gid, quantized: the payload's E bytes, or q * scale
  auto emit = [&](long long gid, int j, uint4 raw, float scale, float inv, bool fast) {
    float f[E];
    to_f32<T>(raw, f);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = quant1(f[e], scale, inv, fast, qmax);
    const long long at = gid * group + static_cast<long long>(j) * E;
    if constexpr (FAKE) {
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = __fmul_rn(f[e], scale);
      __stcs(reinterpret_cast<uint4*>(out + at), to_t<T>(f));
    } else if constexpr (E == 8) {
      __stcs(reinterpret_cast<uint2*>(q + at), make_uint2(pack_s8x4(f), pack_s8x4(f + 4)));
    } else {
      __stcs(reinterpret_cast<unsigned int*>(q + at), pack_s8x4(f));
    }
  };

  if constexpr (NV > 0) {
    uint4 cur[NV], nxt[NV];
    auto load = [&](long long gid, uint4 (&v)[NV]) {
      const uint4* p = reinterpret_cast<const uint4*>(x + gid * group);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = gl + lg * i;
        v[i] = gid < groups && i < nvec && j < nv ? __ldcs(p + j) : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    load(g0 + sub, cur);
    for (; g0 < groups; g0 += stride) {
      const long long gid = g0 + sub;
      if (g0 + stride < groups) load(g0 + stride + sub, nxt);  // in flight while this step runs
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float f[E];
        to_f32<T>(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
      float scale, inv;
      bool fast;
      scale_of(amax, gid, scale, inv, fast);
      if (gid < groups) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int j = gl + lg * i;
          if (i < nvec && j < nv) emit(gid, j, cur[i], scale, inv, fast);
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
    }
  } else {
    for (; g0 < groups; g0 += stride) {
      const long long gid = g0 + sub;
      const uint4* p = reinterpret_cast<const uint4*>(x + gid * group);
      float amax = 0.f;
      if (gid < groups) {
#pragma unroll 4
        for (int j = gl; j < nv; j += lg) {
          float f[E];
          to_f32<T>(p[j], f);
#pragma unroll
          for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
        }
      }
      float scale, inv;
      bool fast;
      scale_of(amax, gid, scale, inv, fast);
      if (gid < groups) {
#pragma unroll 4
        for (int j = gl; j < nv; j += lg) emit(gid, j, p[j], scale, inv, fast);
      }
    }
  }
}

// the wide-group route (see the header).  Group blockIdx.y, its vectors
// blockIdx.x * kThreads + threadIdx.x, ... a grid's x threads apart.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_absmax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax_bits, int nv) {
  constexpr int E = kElems<T>;
  const uint4* p = reinterpret_cast<const uint4*>(x + static_cast<long long>(blockIdx.y) * nv * E);
  float amax = 0.f;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < nv; j += gridDim.x * kThreads) {
    float f[E];
    to_f32<T>(__ldcs(p + j), f);
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
    atomicMax(amax_bits + blockIdx.y, __float_as_uint(amax));
  }
}

// scale = absmax / qmax, 1.0 where 0, in place over the absmax bits
__global__ void wide_scale_kernel(float* __restrict__ scales, long long groups, float qmax) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= groups) return;
  float scale = __fdiv_rn(__uint_as_float(reinterpret_cast<unsigned*>(scales)[g]), qmax);
  if (scale == 0.f) scale = 1.f;
  scales[g] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  const float* __restrict__ scales, int nv, float qmax) {
  constexpr int E = kElems<T>;
  const long long base = static_cast<long long>(blockIdx.y) * nv * E;
  const uint4* p = reinterpret_cast<const uint4*>(x + base);
  const float scale = scales[blockIdx.y];
  const float inv = __frcp_rn(scale);
  const bool fast = scale >= kScaleLo && scale <= kScaleHi;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < nv; j += gridDim.x * kThreads) {
    float f[E];
    to_f32<T>(__ldcs(p + j), f);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = quant1(f[e], scale, inv, fast, qmax);
    const long long at = base + static_cast<long long>(j) * E;
    if constexpr (E == 8) {
      __stcs(reinterpret_cast<uint2*>(q + at), make_uint2(pack_s8x4(f), pack_s8x4(f + 4)));
    } else {
      __stcs(reinterpret_cast<unsigned int*>(q + at), pack_s8x4(f));
    }
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

// blocks of `kern` resident on the card at once (the quantize grid: a
// warp walks its groups a grid apart)
template <typename K>
int resident_blocks(K kern) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kWarps * 32, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, bool FAKE, int NV>
int launch_quant_nv(const T* x, int8_t* q, float* scales, T* out, long long groups, int group,
                    float qmax, cudaStream_t stream) {
  auto kern = quant_kernel<T, FAKE, NV>;
  static const int resident = resident_blocks(kern);
  const int per = 32 / lanes_of(group / kElems<T>);
  const long long warps = (groups + per - 1) / per;
  const long long blocks = std::min<long long>((warps + kWarps - 1) / kWarps, resident);
  kern<<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(x, q, scales, out, groups,
                                                                   group, qmax);
  return static_cast<int>(cudaGetLastError());
}

// the wide-group route: groups * nv vectors, at most 65535 groups (a grid's y)
template <typename T>
int launch_wide_quant(const T* x, int8_t* q, float* scales, long long groups, int nv,
                      float qmax, int sms, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(scales, 0, groups * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about 8 blocks an SM in all, each a group's chunk
  const long long per_group = std::max<long long>(1, 8LL * sms / groups);
  const unsigned bx = static_cast<unsigned>(
      std::min<long long>(per_group, (nv + kThreads - 1) / kThreads));
  const dim3 grid(bx, static_cast<unsigned>(groups));
  wide_absmax_kernel<T><<<grid, kThreads, 0, stream>>>(x, reinterpret_cast<unsigned*>(scales), nv);
  wide_scale_kernel<<<static_cast<unsigned>((groups + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(scales, groups, qmax);
  wide_quant_kernel<T><<<grid, kThreads, 0, stream>>>(x, q, scales, nv, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FAKE>
int launch_quant(const void* x, void* q, void* scales, void* out, long long m, int n,
                 int group, float qmax, cudaStream_t stream) {
  constexpr int E = kElems<T>;
  if (group % E != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(FAKE ? out : q) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = m * (n / group);
  if (groups == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  T* ot = static_cast<T*>(out);
  const int nv = group / E, nvec = nv < 32 ? 1 : (nv + 31) / 32;
  if (nvec == 1) return launch_quant_nv<T, FAKE, 1>(xt, qt, st, ot, groups, group, qmax, stream);
  if (nvec == 2) return launch_quant_nv<T, FAKE, 2>(xt, qt, st, ot, groups, group, qmax, stream);
  if (nvec <= 4) return launch_quant_nv<T, FAKE, 4>(xt, qt, st, ot, groups, group, qmax, stream);
  if (nvec <= kMaxVecs)
    return launch_quant_nv<T, FAKE, kMaxVecs>(xt, qt, st, ot, groups, group, qmax, stream);
  if constexpr (!FAKE) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (groups < 4LL * sms)   // too few groups to fill the card a warp each
      return launch_wide_quant<T>(xt, qt, st, groups, nv, qmax, sms, stream);
  }
  return launch_quant_nv<T, FAKE, 0>(xt, qt, st, ot, groups, group, qmax, stream);
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
