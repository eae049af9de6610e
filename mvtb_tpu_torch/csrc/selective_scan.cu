// The selective scan of Mamba (Gu and Dao, arXiv:2312.00752) for Hopper
// (sm_90a), forward and backward, as SegMamba's tri-orientated layers run it.
//
// Replaces no TPU kernel: the JAX package has no sequence model. It was
// added because SegMamba's first stage scans 262,144 tokens a volume, three
// orders a layer, and neither a loop over positions nor a log-depth scan in
// plain PyTorch (states of B * d * N * L floats, 3.2 GB at stage 1, b2) is a
// path.
//
// Function, per batch row b and channel c (d channels, N = 16 states, L
// positions; u, delta, z of (B, d, L) with unit position stride; Bm, Cm of
// (B, L, N) contiguous; A (d, N), D (d), bias (d) float32):
//
//   dt_t = softplus(delta_t + bias)          (threshold 20, as torch's)
//   h_t  = exp(dt_t A) * h_{t-1} + dt_t u_t Bm_t,   h_{-1} = 0, float32
//   y_t  = sum_n Cm_tn h_tn + D u_t
//   out_t = y_t * silu(z_t)
//
// and its gradient with respect to u, delta, z, Bm, Cm, A, D and bias.
//
// What bounds it on this card. Each input and output element is read or
// written once: (3 + 1) bf16 of (B, d, L) and 2 of (B, L, N) forward, and
// the backward's 4 in and 3 out of (B, d, L) plus the five gradients. At
// stage 1, b2, a forward reads and writes ~0.44 GB (0.13 ms at 3.35 TB/s).
// The arithmetic is B*d*L*N state updates, each an exp and two or three
// FMAs; the exp runs on the SFU at 16 a clock an SM, about 0.2 ms per scan
// pass at stage 1, b2. So the kernel sits between the two bounds, and how
// the sequence is cut up decides how near it comes.
//
// Design. The sequence is cut into chunks of LC = 32 positions. One thread
// owns one (b, c, chunk) and all 16 states of it in registers; a warp is 32
// channels of one chunk, so the Bm and Cm rows it reads are the same for
// every lane (broadcast loads). Forward, three launches:
//   1. each chunk from a zero state: its end state and sum_t dt_t;
//   2. the carry: per (b, c, n), chunk start states by the affine recurrence
//      x_{k+1} = exp(A * sum dt_k) x_k + hloc_k, a block per (b, c) with 64
//      segments of chunks scanned in three steps (segment, segments, segment
//      again), written in place of the local end states;
//   3. each chunk again from its start state: y and the gated output.
// Nothing of size B*d*L*N is written; the chunk start states (B, K, d, N)
// float32, K = ceil(L / LC), as many bytes as one bf16 (B, d, L) tensor,
// are what the backward keeps. Backward, three launches:
//   1. each chunk's adjoint from a zero carry, right to left:
//      lam_t = g_t Cm_t + exp(dt_{t+1} A) lam_{t+1}, g = dout * silu(z);
//   2. the same carry kernel, right to left, gives each chunk's incoming
//      adjoint;
//   3. per chunk: the states forward from the saved start, kept at every
//      G = 4th position in shared memory; then right to left a group of 4
//      at a time, the group's states recomputed into registers, the adjoint
//      and every gradient. dBm and dCm sum over channels: a warp's 32 lanes
//      are reduced by a transposing butterfly (16 values in 16 shuffles) and
//      written per 32-channel group, (B, ceil(d/32), L, N), summed by the
//      caller; dA, dD and dbias per chunk, (B, K, d, ...), summed by the
//      caller. No atomics: the result does not depend on scheduling.
// The C entry points launch on the given stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 16;    // states a channel
constexpr int LC = 32;    // positions a chunk
constexpr int G = 4;      // positions a load group; the backward's group
constexpr int CH = 2;     // chunks (warps) a block
constexpr int CARRY_SEGS = 64;   // segments of chunks a carry block walks
constexpr int CARRY_BATCH = 8;   // chunks a segment's walk loads at once
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* u;
  const void* delta;
  const void* z;
  const void* Bm;
  const void* Cm;
  const float* A;
  const float* D;
  const float* bias;
  long long u_sb, u_sc, d_sb, d_sc, z_sb, z_sc;
  int batch, d, L, K, vec;
  void* out;      // forward output (B, d, L)
  float* state;   // (B, K, d, N): local results, then the carries, in place
  float* dsum;    // (B, K, d): sum of dt over each chunk
  const void* dout;
  const float* hstart;  // (B, K, d, N): the forward's chunk start states
  void* du;
  void* ddelta;
  void* dz;
  float* dBp;  // (B, ceil(d / 32), L, N)
  float* dCp;
  float* dAp;  // (B, K, d, N)
  float* dDp;  // (B, K, d)
  float* dbp;  // (B, K, d)
};

// G consecutive elements from p, n of them valid (the rest read as 0);
// one 8- or 16-byte load where the caller vouches for alignment
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float f[G]) {
  if (vec && n == G) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) f[j] = j < n ? p[j] : 0.f;
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float f[G]) {
  if (vec && n == G) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) f[j] = j < n ? __bfloat162float(p[j]) : 0.f;
  }
}
__device__ __forceinline__ void store4(float* p, int n, bool vec, const float f[G]) {
  if (vec && n == G) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < n) p[j] = f[j];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, bool vec, const float f[G]) {
  if (vec && n == G) {
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < n) p[j] = __float2bfloat16_rn(f[j]);
  }
}

// one position's 16 values of Bm or Cm (contiguous, aligned: the wrapper
// hands rows that start on 16 bytes)
__device__ __forceinline__ void load16(const float* p, float f[NS]) {
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float f[NS]) {
#pragma unroll
  for (int i = 0; i < NS / 8; ++i) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
      f[8 * i + 2 * q] = v.x;
      f[8 * i + 2 * q + 1] = v.y;
    }
  }
}

__device__ __forceinline__ float softplus(float x) { return x <= 20.f ? log1pf(expf(x)) : x; }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// the sum over a warp's 32 lanes of v[lane >> 1], in every lane: a butterfly
// that halves the values it carries at each step (8 + 4 + 2 + 1 + 1 shuffles)
__device__ __forceinline__ float reduce16(float v[NS], int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool up = lane & 16;
    const float send = up ? v[i] : v[i + 8], keep = up ? v[i + 8] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = lane & 8;
    const float send = up ? v[i] : v[i + 4], keep = up ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool up = lane & 4;
    const float send = up ? v[i] : v[i + 2], keep = up ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  {
    const bool up = lane & 2;
    const float send = up ? v[0] : v[1], keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(FULL, send, 2);
  }
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

__device__ __forceinline__ long long state_row(const Args& a, int b, int k, int c) {
  return ((long long)b * a.K + k) * a.d + c;
}

// Forward 1 (OUT false): each chunk from a zero state; its end state and
// sum of dt into state / dsum. Forward 3 (OUT true): each chunk from its
// start state (state, after the carry); y and the gated output.
template <typename T, bool OUT>
__global__ void __launch_bounds__(32 * CH) selective_scan_fwd_kernel(const Args a) {
  const int lane = threadIdx.x, c = blockIdx.x * 32 + lane;
  const int k = blockIdx.y * CH + threadIdx.y, b = blockIdx.z;
  if (c >= a.d || k >= a.K) return;
  const T* u = static_cast<const T*>(a.u) + b * a.u_sb + c * a.u_sc;
  const T* dl = static_cast<const T*>(a.delta) + b * a.d_sb + c * a.d_sc;
  const T* z = static_cast<const T*>(a.z) + b * a.z_sb + c * a.z_sc;
  const T* Bm = static_cast<const T*>(a.Bm) + (long long)b * a.L * NS;
  const T* Cm = static_cast<const T*>(a.Cm) + (long long)b * a.L * NS;
  T* out = static_cast<T*>(a.out) + ((long long)b * a.d + c) * a.L;
  float A2[NS], h[NS];
  float* st = a.state + state_row(a, b, k, c) * NS;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A2[n] = a.A[c * NS + n] * LOG2E;
    h[n] = OUT ? st[n] : 0.f;
  }
  const float bias = a.bias[c], Dc = a.D[c];
  const bool vec = a.vec;
  float s = 0.f;
  const int t0 = k * LC, t1 = min(a.L, t0 + LC);
  for (int t = t0; t < t1; t += G) {
    const int n_ = min(G, t1 - t);
    float uu[G], dd[G], zz[G], o[G];
    load4(u + t, n_, vec, uu);
    load4(dl + t, n_, vec, dd);
    if (OUT) load4(z + t, n_, vec, zz);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < n_) {
        const float dt = softplus(dd[j] + bias), x = dt * uu[j];
        s += dt;
        float Bv[NS];
        load16(Bm + (long long)(t + j) * NS, Bv);
        if (OUT) {
          float Cv[NS];
          load16(Cm + (long long)(t + j) * NS, Cv);
          float y = 0.f;
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            h[n] = exp2f(dt * A2[n]) * h[n] + x * Bv[n];
            y += Cv[n] * h[n];
          }
          o[j] = (y + Dc * uu[j]) * (zz[j] * sigmoid(zz[j]));
        } else {
#pragma unroll
          for (int n = 0; n < NS; ++n) h[n] = exp2f(dt * A2[n]) * h[n] + x * Bv[n];
        }
      }
    }
    if (OUT) store4(out + t, n_, vec, o);
  }
  if (!OUT) {
#pragma unroll
    for (int n = 0; n < NS; n += 4)
      *reinterpret_cast<float4*>(st + n) = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
    a.dsum[state_row(a, b, k, c)] = s;
  }
}

// The carry between chunks, in place: per (b, c, n), over the chunks in
// order (reverse: right to left) x_0 = 0, x_{j+1} = exp(A sum dt_j) x_j +
// loc_j; each loc_j is replaced by x_j. A block per (b, c): 16 states by 64
// segments of consecutive chunks; each segment's aggregate, the segments'
// exclusive scan in shared memory, each segment again. A segment's walk
// loads CARRY_BATCH chunks before it uses any, so that enough bytes are in
// flight: the walk is a chain of dependent steps, and one load at a time
// left it waiting on memory (3.5 ms a call at stage 1, b2, on an H100).
__global__ void __launch_bounds__(NS * CARRY_SEGS)
selective_scan_carry_kernel(const Args a, int reverse) {
  __shared__ float agg_h[CARRY_SEGS][NS];
  __shared__ float agg_s[CARRY_SEGS];
  const int n = threadIdx.x, seg = threadIdx.y, c = blockIdx.x, b = blockIdx.y;
  const int per = (a.K + CARRY_SEGS - 1) / CARRY_SEGS;
  const int j0 = min(a.K, seg * per), j1 = min(a.K, j0 + per);
  const float A2 = a.A[c * NS + n] * LOG2E;
  float x = 0.f, s = 0.f;
  for (int j = j0; j < j1; j += CARRY_BATCH) {
    float dsv[CARRY_BATCH], loc[CARRY_BATCH];
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      dsv[q] = 0.f;
      loc[q] = 0.f;
      if (j + q < j1) {
        const long long r = state_row(a, b, reverse ? a.K - 1 - j - q : j + q, c);
        dsv[q] = a.dsum[r];
        loc[q] = a.state[r * NS + n];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      x = exp2f(A2 * dsv[q]) * x + loc[q];  // a chunk past the end adds nothing
      s += dsv[q];
    }
  }
  agg_h[seg][n] = x;
  if (n == 0) agg_s[seg] = s;
  __syncthreads();
  if (seg == 0) {
    float run = 0.f;
    for (int q = 0; q < CARRY_SEGS; ++q) {
      const float hq = agg_h[q][n];
      agg_h[q][n] = run;
      run = exp2f(A2 * agg_s[q]) * run + hq;
    }
  }
  __syncthreads();
  x = agg_h[seg][n];
  for (int j = j0; j < j1; j += CARRY_BATCH) {
    float dsv[CARRY_BATCH], loc[CARRY_BATCH];
    long long rows[CARRY_BATCH];
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      rows[q] = state_row(a, b, reverse ? a.K - 1 - j - q : j + q, c);
      if (j + q < j1) {
        dsv[q] = a.dsum[rows[q]];
        loc[q] = a.state[rows[q] * NS + n];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      if (j + q < j1) {
        a.state[rows[q] * NS + n] = x;
        x = exp2f(A2 * dsv[q]) * x + loc[q];
      }
    }
  }
}

// Backward 1: each chunk's adjoint from a zero carry, right to left;
// mu = exp(dt_s A) lam_s at its first position s into state, sum dt into dsum.
template <typename T>
__global__ void __launch_bounds__(32 * CH) selective_scan_bwd_local_kernel(const Args a) {
  const int lane = threadIdx.x, c = blockIdx.x * 32 + lane;
  const int k = blockIdx.y * CH + threadIdx.y, b = blockIdx.z;
  if (c >= a.d || k >= a.K) return;
  const T* dl = static_cast<const T*>(a.delta) + b * a.d_sb + c * a.d_sc;
  const T* z = static_cast<const T*>(a.z) + b * a.z_sb + c * a.z_sc;
  const T* dy = static_cast<const T*>(a.dout) + ((long long)b * a.d + c) * a.L;
  const T* Cm = static_cast<const T*>(a.Cm) + (long long)b * a.L * NS;
  float A2[NS], mu[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A2[n] = a.A[c * NS + n] * LOG2E;
    mu[n] = 0.f;
  }
  const float bias = a.bias[c];
  const bool vec = a.vec;
  float s = 0.f;
  const int t0 = k * LC, t1 = min(a.L, t0 + LC);
  for (int t = t0 + ((t1 - t0 - 1) / G) * G; t >= t0; t -= G) {
    const int n_ = min(G, t1 - t);
    float dd[G], zz[G], gy[G];
    load4(dl + t, n_, vec, dd);
    load4(z + t, n_, vec, zz);
    load4(dy + t, n_, vec, gy);
#pragma unroll
    for (int j = G - 1; j >= 0; --j) {
      if (j < n_) {
        const float dt = softplus(dd[j] + bias), g = gy[j] * zz[j] * sigmoid(zz[j]);
        s += dt;
        float Cv[NS];
        load16(Cm + (long long)(t + j) * NS, Cv);
#pragma unroll
        for (int n = 0; n < NS; ++n) mu[n] = exp2f(dt * A2[n]) * (g * Cv[n] + mu[n]);
      }
    }
  }
  float* st = a.state + state_row(a, b, k, c) * NS;
#pragma unroll
  for (int n = 0; n < NS; n += 4)
    *reinterpret_cast<float4*>(st + n) = make_float4(mu[n], mu[n + 1], mu[n + 2], mu[n + 3]);
  a.dsum[state_row(a, b, k, c)] = s;
}

// Backward 3: per chunk, every gradient. Lanes past the last channel run
// with zeros, since the warp's reductions need all 32.
template <typename T>
__global__ void __launch_bounds__(32 * CH) selective_scan_bwd_kernel(const Args a) {
  __shared__ float hs[LC / G][NS][CH][32];  // states at each group's start
  const int lane = threadIdx.x, w = threadIdx.y, c = blockIdx.x * 32 + lane;
  const int k = blockIdx.y * CH + w, b = blockIdx.z;
  if (k >= a.K) return;
  const bool valid = c < a.d;
  const int cc = valid ? c : 0;
  const T* u = static_cast<const T*>(a.u) + b * a.u_sb + cc * a.u_sc;
  const T* dl = static_cast<const T*>(a.delta) + b * a.d_sb + cc * a.d_sc;
  const T* z = static_cast<const T*>(a.z) + b * a.z_sb + cc * a.z_sc;
  const long long row = ((long long)b * a.d + cc) * a.L;
  const T* dy = static_cast<const T*>(a.dout) + row;
  const T* Bm = static_cast<const T*>(a.Bm) + (long long)b * a.L * NS;
  const T* Cm = static_cast<const T*>(a.Cm) + (long long)b * a.L * NS;
  const int cw = blockIdx.x, CW = gridDim.x;
  float* dBp = a.dBp + ((long long)b * CW + cw) * a.L * NS;
  float* dCp = a.dCp + ((long long)b * CW + cw) * a.L * NS;
  const long long sr = state_row(a, b, k, cc);
  float A2[NS], h[NS], mu[NS], dA[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A2[n] = valid ? a.A[cc * NS + n] * LOG2E : 0.f;
    h[n] = valid ? a.hstart[sr * NS + n] : 0.f;
    mu[n] = valid ? a.state[sr * NS + n] : 0.f;
    dA[n] = 0.f;
  }
  const float bias = valid ? a.bias[cc] : 0.f, Dc = valid ? a.D[cc] : 0.f;
  const bool vec = a.vec;
  const int t0 = k * LC, t1 = min(a.L, t0 + LC), groups = (t1 - t0 + G - 1) / G;

  for (int gi = 0; gi < groups; ++gi) {
    const int t = t0 + gi * G, n_ = min(G, t1 - t);
#pragma unroll
    for (int n = 0; n < NS; ++n) hs[gi][n][w][lane] = h[n];
    float uu[G], dd[G];
    load4(u + t, n_, vec && valid, uu);
    load4(dl + t, n_, vec && valid, dd);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < n_) {
        const float dt = softplus((valid ? dd[j] : 0.f) + bias), x = valid ? dt * uu[j] : 0.f;
        float Bv[NS];
        load16(Bm + (long long)(t + j) * NS, Bv);
#pragma unroll
        for (int n = 0; n < NS; ++n) h[n] = exp2f(dt * A2[n]) * h[n] + x * Bv[n];
      }
    }
  }

  float dD = 0.f, db = 0.f;
  for (int gi = groups - 1; gi >= 0; --gi) {
    const int t = t0 + gi * G, n_ = min(G, t1 - t);
    float uu[G], dd[G], zz[G], gy[G], dt[G];
    load4(u + t, n_, vec && valid, uu);
    load4(dl + t, n_, vec && valid, dd);
    load4(z + t, n_, vec && valid, zz);
    load4(dy + t, n_, vec && valid, gy);
    if (!valid) {
#pragma unroll
      for (int j = 0; j < G; ++j) uu[j] = dd[j] = zz[j] = gy[j] = 0.f;
    }
    // the group's states: H[j] after position t + j
    float H[G][NS];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      dt[j] = softplus(dd[j] + bias);
      if (j < n_) {
        const float x = dt[j] * uu[j];
        float Bv[NS];
        load16(Bm + (long long)(t + j) * NS, Bv);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float prev = j == 0 ? hs[gi][n][w][lane] : H[j - 1][n];
          H[j][n] = exp2f(dt[j] * A2[n]) * prev + x * Bv[n];
        }
      }
    }
    float du[G], ddl[G], dz[G];
#pragma unroll
    for (int j = G - 1; j >= 0; --j) {
      if (j < n_) {
        const float zs = sigmoid(zz[j]), g = gy[j] * zz[j] * zs, x = dt[j] * uu[j];
        float Bv[NS], Cv[NS], rb[NS], rc[NS];
        load16(Bm + (long long)(t + j) * NS, Bv);
        load16(Cm + (long long)(t + j) * NS, Cv);
        float sB = 0.f, sA = 0.f, y = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float lam = g * Cv[n] + mu[n];
          const float ea = exp2f(dt[j] * A2[n]);
          const float prev = j == 0 ? hs[gi][n][w][lane] : H[j - 1][n];
          const float wgt = lam * ea * prev;
          y += Cv[n] * H[j][n];
          rb[n] = lam * x;
          rc[n] = g * H[j][n];
          sB += lam * Bv[n];
          sA += wgt * A2[n];
          dA[n] += wgt * dt[j];
          mu[n] = ea * lam;
        }
        const float ddt = sB * uu[j] + sA * LN2;
        du[j] = sB * dt[j] + g * Dc;
        ddl[j] = ddt * sigmoid(dd[j] + bias);
        dz[j] = gy[j] * (y + Dc * uu[j]) * zs * (1.f + zz[j] * (1.f - zs));
        dD += g * uu[j];
        db += ddl[j];
        const float sb = reduce16(rb, lane), sc = reduce16(rc, lane);
        if (!(lane & 1)) {
          dBp[(long long)(t + j) * NS + (lane >> 1)] = sb;
          dCp[(long long)(t + j) * NS + (lane >> 1)] = sc;
        }
      }
    }
    if (valid) {
      store4(static_cast<T*>(a.du) + row + t, n_, vec, du);
      store4(static_cast<T*>(a.ddelta) + row + t, n_, vec, ddl);
      store4(static_cast<T*>(a.dz) + row + t, n_, vec, dz);
    }
  }
  if (valid) {
    float* dAp = a.dAp + sr * NS;
#pragma unroll
    for (int n = 0; n < NS; n += 4)
      *reinterpret_cast<float4*>(dAp + n) = make_float4(dA[n], dA[n + 1], dA[n + 2], dA[n + 3]);
    a.dDp[sr] = dD;
    a.dbp[sr] = db;
  }
}

dim3 chunk_grid(const Args& a) {
  return dim3((a.d + 31) / 32, (a.K + CH - 1) / CH, a.batch);
}

Args make_args(const void* u, const void* delta, const void* z, const void* Bm, const void* Cm,
               const float* A, const float* D, const float* bias, long long u_sb,
               long long u_sc, long long d_sb, long long d_sc, long long z_sb, long long z_sc,
               int batch, int d, int L, int vec) {
  Args a = {};
  a.u = u; a.delta = delta; a.z = z; a.Bm = Bm; a.Cm = Cm; a.A = A; a.D = D; a.bias = bias;
  a.u_sb = u_sb; a.u_sc = u_sc; a.d_sb = d_sb; a.d_sc = d_sc; a.z_sb = z_sb; a.z_sc = z_sc;
  a.batch = batch; a.d = d; a.L = L; a.K = (L + LC - 1) / LC; a.vec = vec;
  return a;
}

bool bad_shape(const Args& a) {
  return a.batch <= 0 || a.d <= 0 || a.L <= 0 || a.batch > 65535 ||
         (a.K + CH - 1) / CH > 65535;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (u, delta, z, Bm, Cm and the outputs)
extern "C" int mvtb_selective_scan_fwd(int dtype, const void* u, const void* delta,
                                       const void* z, const void* Bm, const void* Cm,
                                       const float* A, const float* D, const float* bias,
                                       long long u_sb, long long u_sc, long long d_sb,
                                       long long d_sc, long long z_sb, long long z_sc,
                                       int batch, int d, int L, int vec, void* out,
                                       float* state, float* dsum, void* stream) {
  Args a = make_args(u, delta, z, Bm, Cm, A, D, bias, u_sb, u_sc, d_sb, d_sc, z_sb, z_sc,
                     batch, d, L, vec);
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  a.out = out; a.state = state; a.dsum = dsum;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = chunk_grid(a), block(32, CH);
  if (dtype == 1) selective_scan_fwd_kernel<__nv_bfloat16, false><<<grid, block, 0, s>>>(a);
  else selective_scan_fwd_kernel<float, false><<<grid, block, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  selective_scan_carry_kernel<<<dim3(d, batch), dim3(NS, CARRY_SEGS), 0, s>>>(a, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) selective_scan_fwd_kernel<__nv_bfloat16, true><<<grid, block, 0, s>>>(a);
  else selective_scan_fwd_kernel<float, true><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mvtb_selective_scan_bwd(int dtype, const void* u, const void* delta,
                                       const void* z, const void* Bm, const void* Cm,
                                       const float* A, const float* D, const float* bias,
                                       long long u_sb, long long u_sc, long long d_sb,
                                       long long d_sc, long long z_sb, long long z_sc,
                                       int batch, int d, int L, int vec, const void* dout,
                                       const float* hstart, float* state, float* dsum,
                                       void* du, void* ddelta, void* dz, float* dBp,
                                       float* dCp, float* dAp, float* dDp, float* dbp,
                                       void* stream) {
  Args a = make_args(u, delta, z, Bm, Cm, A, D, bias, u_sb, u_sc, d_sb, d_sc, z_sb, z_sc,
                     batch, d, L, vec);
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  a.dout = dout; a.hstart = hstart; a.state = state; a.dsum = dsum;
  a.du = du; a.ddelta = ddelta; a.dz = dz;
  a.dBp = dBp; a.dCp = dCp; a.dAp = dAp; a.dDp = dDp; a.dbp = dbp;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = chunk_grid(a), block(32, CH);
  if (dtype == 1) selective_scan_bwd_local_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(a);
  else selective_scan_bwd_local_kernel<float><<<grid, block, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  selective_scan_carry_kernel<<<dim3(d, batch), dim3(NS, CARRY_SEGS), 0, s>>>(a, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) selective_scan_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(a);
  else selective_scan_bwd_kernel<float><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* mvtb_selective_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
