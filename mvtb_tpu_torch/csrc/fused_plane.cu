// Fused k-space plane kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of mvtb_tpu/ops/fused_plane.py (_build_kernel ->
// kernel, launched by _plane_pallas through plane_stylize_half). For each
// (channel*batch, half-H) plane of the H-axis half spectrum it computes
//
//   forward DFT over W -> forward DFT over D -> multiplicative weights
//   (Gibbs with the even-size mirror average, disk, wrap parity) -> up to two
//   sequential polar point writes (spike, then plane wave) -> inverse DFT
//   over D -> inverse DFT over W
//
// with Gauss's 3-product complex contraction against the same float32
// matrices (built on the host by mvtb_tpu_torch/ops/dft.py):
//   k1 = cos.(re+im),  re' = k1 - (cos+sin).im,  im' = k1 + (sin-cos).re.
//
// What bounds it on this card. Per plane the four contractions are
// 12*W*D*(W+D) flops; at the bench shape (4x4x240x240x155: 1,936 planes of
// 240x155) that is 341 GFLOP, against 4 x 16x121x240x155 x 4 B = 1.15 GB of
// input plus output. On the H100 SXM data-sheet peaks that is 0.34 ms of
// bf16 tensor-core time and 0.34 ms of HBM time, but 5.1 ms on the 67 TFLOP/s
// float32 CUDA cores this kernel uses: it is bound by operations.
//
// Design (first, simple version). One CTA of 256 threads per plane, grid
// N*Hh. A 240x160 complex float32 plane is 307 KB, more than the 227 KB a
// block may use, so the CTA streams its plane through a per-plane scratch in
// device memory (mostly L2-resident while the CTA runs): each contraction is
// a shared-memory-tiled SGEMM (64x64 output tiles, depth 16, 4x4 outputs per
// thread, three accumulators per output for the three Gauss products) from
// one buffer into the other, with __syncthreads() between the phases:
//   in -W-> scratch -D,weights-> out -points-> out -D^-1-> scratch -W^-1-> out
// The weights are applied in the epilogue of the D contraction. One thread
// does the two sequential point writes, with the masked-read semantics of
// the TPU kernel: a signed zero reads as +0, and the delta is added to the
// raw value. The DFT matrices are symmetric, so a transposed operand is read
// along contiguous rows. Data buffers are written and re-read inside the
// kernel, so they are never read through the non-coherent read-only path.
//
// Precision tiers (template FAST): false = float32 operands, float32 FMA
// accumulation; true = operands rounded to bf16 (__float2bfloat16_rn; the
// matrices arrive pre-rounded), float32 accumulation, as the TPU's
// single-pass bf16 tier. Tensor cores (wgmma), TMA and 3xTF32 are later work.
//
// The C entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // output rows (W) per tile
constexpr int BN = 64;   // output columns (D) per tile
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int NT = 256;  // threads per CTA: 16 x 16, 4 x 4 outputs each

enum : int {
  F_GIBBS = 1, F_GIBBS_SYM = 2, F_DISK = 4, F_INSIDE_OFF = 8, F_WRAP = 16,
};

struct Params {
  const float* k_re; const float* k_im;
  float* o_re; float* o_im;
  float* s_re; float* s_im;
  const float* mats;
  const float* wparams;
  const int* locs;
  const float* vals; const float* gates; const float* conjs; const float* scales;
  int N, Hh, H, W, D, n_stages, flags;
};

struct Weight {
  int H, W, D, hh, flags;
  float r2g, gg, r2d, gd, alpha;
};

struct Smem {
  float a[3][BK][BM];
  float b[3][BK][BN];
};

template <bool FAST>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (FAST) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float off_of(int i, int n) {
  return (float)(i < n - n / 2 ? i : i - n);
}

__device__ __forceinline__ float mirror_off(float off, int n) {
  return (n % 2 == 0 && off == -(float)(n / 2)) ? off : -off;
}

__device__ __forceinline__ int shifted(int s, int n) {
  const int c = n / 2;
  return s < n - c ? s + c : s + c - n;
}

// Sum of three squares, rounded exactly as the reference's ((a+b)+c) order
// (no FMA contraction).
__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

__device__ float weight_at(const Weight& p, int iw, int id) {
  const float oh = off_of(p.hh, p.H), ow = off_of(iw, p.W), od = off_of(id, p.D);
  float w = 1.f;
  if (p.flags & F_GIBBS) {
    const float gh = (p.H % 2 == 0) ? -0.5f : 0.f;
    const float gw = (p.W % 2 == 0) ? -0.5f : 0.f;
    const float gdd = (p.D % 2 == 0) ? -0.5f : 0.f;
    float m = sq3(oh - gh, ow - gw, od - gdd) <= p.r2g ? 1.f : 0.f;
    if (p.flags & F_GIBBS_SYM) {
      const float mm = sq3(mirror_off(oh, p.H) - gh, mirror_off(ow, p.W) - gw,
                           mirror_off(od, p.D) - gdd) <= p.r2g ? 1.f : 0.f;
      m = (m + mm) * 0.5f;
    }
    w = __fmul_rn(w, __fadd_rn(__fmul_rn(p.gg, m), 1.f - p.gg));
  }
  if (p.flags & F_DISK) {
    const bool inside = sq3(oh, ow, od) < p.r2d;
    const float m = ((p.flags & F_INSIDE_OFF) ? !inside : inside) ? 1.f : 0.f;
    w = __fmul_rn(w, __fadd_rn(__fmul_rn(p.gd, m), 1.f - p.gd));
  }
  if (p.flags & F_WRAP) {
    const float offs[3] = {oh, ow, od};
    const int ns[3] = {p.H, p.W, p.D};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int s = (int)offs[a] + (offs[a] < 0.f ? ns[a] : 0);
      w = __fmul_rn(w, (shifted(s, ns[a]) % 2 == 1) ? p.alpha : 1.f);
    }
  }
  return w;
}

// One Gauss contraction over a W x D plane (row-major, D contiguous).
// MAT_LEFT: out[i][j] = sum_k M[i][k] X[k][j] (contract W, n = W);
// else:     out[i][j] = sum_k X[i][k] M[k][j] (contract D, n = D).
// Accumulator t pairs matrix t of (cos, cos+sin, sin-cos) with data operand
// t of (re+im, im, re).
template <bool FAST, bool MAT_LEFT, bool WEIGHT>
__device__ void gauss_pass(Smem& sm, const float* xre, const float* xim,
                           const float* __restrict__ mcos,
                           const float* __restrict__ mcps,
                           const float* __restrict__ msmc,
                           float* yre, float* yim, int W, int D, const Weight& wt) {
  const int K = MAT_LEFT ? W : D;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int i0 = 0; i0 < W; i0 += BM) {
    for (int j0 = 0; j0 < D; j0 += BN) {
      float acc[3][4][4];
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t][r][c] = 0.f;

      for (int k0 = 0; k0 < K; k0 += BK) {
        // A side: a[t][kk][ii] = A_t[i0 + ii][k0 + kk]
        for (int e = tid; e < BK * BM; e += NT) {
          if (MAT_LEFT) {
            const int ii = e % BM, kk = e / BM;
            const int i = i0 + ii, k = k0 + kk;
            const bool ok = i < W && k < K;
            const size_t o = (size_t)k * W + i;  // M[i][k] == M[k][i]
            sm.a[0][kk][ii] = ok ? mcos[o] : 0.f;
            sm.a[1][kk][ii] = ok ? mcps[o] : 0.f;
            sm.a[2][kk][ii] = ok ? msmc[o] : 0.f;
          } else {
            const int kk = e % BK, ii = e / BK;
            const int i = i0 + ii, k = k0 + kk;
            const bool ok = i < W && k < K;
            const size_t o = (size_t)i * D + k;
            const float r = ok ? xre[o] : 0.f, m = ok ? xim[o] : 0.f;
            sm.a[0][kk][ii] = rnd<FAST>(r + m);
            sm.a[1][kk][ii] = rnd<FAST>(m);
            sm.a[2][kk][ii] = rnd<FAST>(r);
          }
        }
        // B side: b[t][kk][jj] = B_t[k0 + kk][j0 + jj]
        for (int e = tid; e < BK * BN; e += NT) {
          const int jj = e % BN, kk = e / BN;
          const int j = j0 + jj, k = k0 + kk;
          const bool ok = j < D && k < K;
          const size_t o = (size_t)k * D + j;
          if (MAT_LEFT) {
            const float r = ok ? xre[o] : 0.f, m = ok ? xim[o] : 0.f;
            sm.b[0][kk][jj] = rnd<FAST>(r + m);
            sm.b[1][kk][jj] = rnd<FAST>(m);
            sm.b[2][kk][jj] = rnd<FAST>(r);
          } else {
            sm.b[0][kk][jj] = ok ? mcos[o] : 0.f;
            sm.b[1][kk][jj] = ok ? mcps[o] : 0.f;
            sm.b[2][kk][jj] = ok ? msmc[o] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[3][4], b[3][4];
#pragma unroll
          for (int t = 0; t < 3; ++t) {
#pragma unroll
            for (int r = 0; r < 4; ++r) a[t][r] = sm.a[t][kk][ty + 16 * r];
#pragma unroll
            for (int c = 0; c < 4; ++c) b[t][c] = sm.b[t][kk][tx + 16 * c];
          }
#pragma unroll
          for (int t = 0; t < 3; ++t)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[t][r][c] = fmaf(a[t][r], b[t][c], acc[t][r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
          if (i < W && j < D) {
            const float k1 = acc[0][r][c];
            float ore = k1 - acc[1][r][c];
            float oim = k1 + acc[2][r][c];
            if (WEIGHT) {
              const float w = weight_at(wt, i, j);
              ore *= w;
              oim *= w;
            }
            yre[(size_t)i * D + j] = ore;
            yim[(size_t)i * D + j] = oim;
          }
        }
      }
    }
  }
}

// Sequential polar point writes into this CTA's plane (one thread).
__device__ void point_writes(const Params& p, int c, int hh, float* yre, float* yim) {
  for (int s = 0; s < p.n_stages; ++s) {
    const size_t sc = (size_t)s * p.N + c;
    const int* loc = p.locs + sc * 3;
    if (loc[0] != hh || loc[1] < 0 || loc[1] >= p.W || loc[2] < 0 || loc[2] >= p.D)
      continue;
    const size_t e = (size_t)loc[1] * p.D + loc[2];
    const float raw_re = yre[e], raw_im = yim[e];
    const float pr = (raw_re == 0.f) ? 0.f : raw_re;  // masked-sum read: -0 -> +0
    const float pi = (raw_im == 0.f) ? 0.f : raw_im;
    const float sgn = p.conjs[sc];
    const float old_re = pr, old_im = sgn * pi;
    const float r = sqrtf(__fadd_rn(__fmul_rn(old_re, old_re), __fmul_rn(old_im, old_im)));
    const float cos_t = r > 0.f ? old_re / r : 1.f;
    const float sin_t = r > 0.f ? old_im / r : 0.f;
    const float mag = p.vals[sc];
    const float scale = p.scales[sc] * p.gates[sc];
    const float d_re = (mag * cos_t - old_re) * scale;
    const float d_im = (mag * sin_t - old_im) * scale * sgn;
    yre[e] = raw_re + d_re;
    yim[e] = raw_im + d_im;
  }
}

template <bool FAST>
__global__ void __launch_bounds__(NT) fused_plane_kernel(Params p) {
  __shared__ Smem sm;
  const int plane = blockIdx.x;
  const int c = plane / p.Hh, hh = plane % p.Hh;
  const int W = p.W, D = p.D;
  const size_t po = (size_t)plane * W * D;
  const float* xre = p.k_re + po;
  const float* xim = p.k_im + po;
  float* yre = p.o_re + po;
  float* yim = p.o_im + po;
  float* sre = p.s_re + po;
  float* sim = p.s_im + po;

  const size_t w2 = (size_t)W * W, d2 = (size_t)D * D;
  const float* wf = p.mats;
  const float* df = wf + 3 * w2;
  const float* wi = df + 3 * d2;
  const float* di = wi + 3 * w2;

  const float* wp = p.wparams + (size_t)c * 5;
  const Weight wt{p.H, W, D, hh, p.flags, wp[0], wp[1], wp[2], wp[3], wp[4]};

  gauss_pass<FAST, true, false>(sm, xre, xim, wf, wf + w2, wf + 2 * w2, sre, sim, W, D, wt);
  __syncthreads();
  if (p.flags & (F_GIBBS | F_DISK | F_WRAP)) {
    gauss_pass<FAST, false, true>(sm, sre, sim, df, df + d2, df + 2 * d2, yre, yim, W, D, wt);
  } else {
    gauss_pass<FAST, false, false>(sm, sre, sim, df, df + d2, df + 2 * d2, yre, yim, W, D, wt);
  }
  __syncthreads();
  if (threadIdx.x == 0) point_writes(p, c, hh, yre, yim);
  __syncthreads();
  gauss_pass<FAST, false, false>(sm, yre, yim, di, di + d2, di + 2 * d2, sre, sim, W, D, wt);
  __syncthreads();
  gauss_pass<FAST, true, false>(sm, sre, sim, wi, wi + w2, wi + 2 * w2, yre, yim, W, D, wt);
}

}  // namespace

extern "C" int mvtb_fused_plane(
    const float* k_re, const float* k_im, float* o_re, float* o_im,
    float* s_re, float* s_im, const float* mats, const float* wparams,
    const int* locs, const float* vals, const float* gates, const float* conjs,
    const float* scales, int N, int Hh, int H, int W, int D, int n_stages,
    int flags, int fast, void* stream) {
  Params p{k_re, k_im, o_re, o_im, s_re, s_im, mats, wparams, locs,
           vals, gates, conjs, scales, N, Hh, H, W, D, n_stages, flags};
  const dim3 grid((unsigned)N * (unsigned)Hh);
  cudaStream_t st = (cudaStream_t)stream;
  if (fast) {
    fused_plane_kernel<true><<<grid, NT, 0, st>>>(p);
  } else {
    fused_plane_kernel<false><<<grid, NT, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mvtb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
