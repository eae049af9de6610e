// Image-domain pointwise kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of mvtb_tpu/ops/pallas_kernels.py:
//
//   sap_kernel    <- _sap_kernel (salt & pepper with an in-kernel PRNG);
//   polar_kernel  <- _polar_kernel (whole-volume polar round trip).
//
// sap_kernel. Each thread takes 4 consecutive elements e = 4t..4t+3 and one
// Philox4x32-10 block: counter (t low, t high, 0, 0), key (uint32(seed), 0);
// word j gives element 4t+j the uniform u = (w >> 8) * 2^-24, the TPU
// kernel's 24-bit rule. The stream depends on (seed, element index) only,
// never on the launch shape, and the plain PyTorch version
// (ops/pallas_kernels.py:sap_uniform) reproduces it bit for bit. The select
// is the JAX kernel's, in float32: lo where u <= p/2 (inclusive: at p = 0 a
// voxel whose u is exactly 0 still turns to pepper), hi where p/2 < u <= p,
// else x. lo = min(x)/2 and hi = max(x)/2 come from the global extrema,
// which the wrapper reduces first (torch.aminmax) and passes as device
// pointers, so nothing waits on the host.
//
// polar_kernel. r = sqrt(re*re + im*im), mag = exp(log(r + 1e-10)),
// out = (mag*(re/r), mag*(im/r)) where r > 0, else (mag, 0): -0.0 and NaN
// take the second branch as in the JAX kernel. IEEE sqrtf, logf, expf and
// '/' (no fast-math intrinsics); re*re + im*im is written with
// __fmul_rn/__fadd_rn so that it is never contracted into an FMA that the
// plain version does not do.
//
// What bounds them on this card. Both are one pass over memory: sap reads
// and writes 4 bytes per element (8 B), polar reads 8 and writes 8 (16 B).
// At 4x240x240x155 (35.7 M elements) that is 286 MB and 571 MB, 0.085 ms
// and 0.171 ms at the H100 SXM data sheet's 3.35 TB/s; the arithmetic
// (10 Philox rounds per 4 elements; one logf and expf per element) is
// smaller than that. chip_smoke.py computes the bounds from its inputs and
// times the kernels beside them (PERF.md).
//
// Design (first, simple version): a grid-stride loop over groups of 4
// elements, 16-byte float4 loads and stores when every pointer is 16-byte
// aligned, scalar accesses otherwise and for the ragged last group. No
// padding to (rows, 128): that layout is the TPU's, not the contract's.
// The C entry points launch on the given stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr long long MAX_BLOCKS = 65535;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += PHILOX_W0;
    k.y += PHILOX_W1;
  }
  return c;
}

__device__ __forceinline__ float u24(uint32_t w) {
  return (float)(w >> 8) * 5.9604644775390625e-08f;  // 2^-24, exact
}

struct SapArgs {
  float p, half, lo, hi;
};

__device__ __forceinline__ float sap1(float x, uint32_t w, const SapArgs& a) {
  const float u = u24(w);
  const float o = (u <= a.half) ? a.lo : x;
  return (u > a.half && u <= a.p) ? a.hi : o;
}

__device__ __forceinline__ void polar1(float re, float im, float& ore, float& oim) {
  const float r = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  const float mag = expf(logf(r + 1e-10f));
  if (r > 0.f) {
    ore = mag * (re / r);
    oim = mag * (im / r);
  } else {
    ore = mag * 1.f;
    oim = mag * 0.f;
  }
}

__global__ void __launch_bounds__(NT)
sap_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
           uint32_t seed, float p, const float* __restrict__ mn,
           const float* __restrict__ mx, int vec) {
  const SapArgs a{p, p * 0.5f, *mn * 0.5f, *mx * 0.5f};
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * NT;
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < groups; t += stride) {
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)t, (uint32_t)((unsigned long long)t >> 32), 0u, 0u),
        make_uint2(seed, 0u));
    const long long e = 4 * t;
    if (vec && e + 4 <= n) {
      float4 v = reinterpret_cast<const float4*>(x)[t];
      v.x = sap1(v.x, w.x, a);
      v.y = sap1(v.y, w.y, a);
      v.z = sap1(v.z, w.z, a);
      v.w = sap1(v.w, w.w, a);
      reinterpret_cast<float4*>(out)[t] = v;
    } else {
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < n) out[e + j] = sap1(x[e + j], ws[j], a);
    }
  }
}

__global__ void __launch_bounds__(NT)
polar_kernel(const float* __restrict__ re, const float* __restrict__ im,
             float* __restrict__ ore, float* __restrict__ oim, long long n, int vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * NT;
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < groups; t += stride) {
    const long long e = 4 * t;
    if (vec && e + 4 <= n) {
      const float4 r4 = reinterpret_cast<const float4*>(re)[t];
      const float4 i4 = reinterpret_cast<const float4*>(im)[t];
      float4 o_re, o_im;
      polar1(r4.x, i4.x, o_re.x, o_im.x);
      polar1(r4.y, i4.y, o_re.y, o_im.y);
      polar1(r4.z, i4.z, o_re.z, o_im.z);
      polar1(r4.w, i4.w, o_re.w, o_im.w);
      reinterpret_cast<float4*>(ore)[t] = o_re;
      reinterpret_cast<float4*>(oim)[t] = o_im;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < n) polar1(re[e + j], im[e + j], ore[e + j], oim[e + j]);
    }
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

unsigned blocks_for(long long n) {
  const long long groups = (n + 3) / 4;
  const long long b = (groups + NT - 1) / NT;
  return (unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// Salt & pepper over n contiguous float32 elements; mn and mx point at the
// tensor's global min and max on the device.
extern "C" int mvtb_sap(const float* x, float* out, long long n, uint32_t seed,
                        float p, const float* mn, const float* mx, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(x) && aligned16(out);
  sap_kernel<<<blocks_for(n), NT, 0, (cudaStream_t)stream>>>(x, out, n, seed, p, mn, mx, vec);
  return (int)cudaGetLastError();
}

// Polar round trip over n contiguous float32 (re, im) pairs.
extern "C" int mvtb_polar(const float* re, const float* im, float* ore, float* oim,
                          long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(re) && aligned16(im) && aligned16(ore) && aligned16(oim);
  polar_kernel<<<blocks_for(n), NT, 0, (cudaStream_t)stream>>>(re, im, ore, oim, n, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* mvtb_pointwise_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
