// Matmul-DFT axis kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of mvtb_tpu/ops/pallas_dft.py: _r2c_kernel,
// _c2c_kernel and _c2r_kernel, each in both orientations of _lane_call and
// _sub_call. One kernel body per function, templated on the orientation and
// the precision tier:
//
//   r2c: re = x.cos, im = x.sin                         (2 products)
//   c2c: k1 = (re+im).cos, re' = k1 - im.(cos+sin),
//        im' = k1 + re.(sin-cos)                        (Gauss, 3 products)
//   c2r: out = re.cos - im.sin                          (2 products)
//
// Every matrix arrives as (n_in, n_out), out[k] = sum_j x[j] mat[j][k]:
//   lane    (transform axis last):  view (len, n_in) -> (len, n_out),
//           out[m][k] = sum_j in[m][j] mat[j][k];
//   sublane (transform axis inner): view (batch, n_in, len) -> (batch, n_out, len),
//           out[a][k][b] = sum_j mat[j][k] in[a][j][b].
// The full DFT matrices are symmetric, so the sublane form equals the TPU
// kernel's mat @ tile.
//
// What bounds it on this card. A c2c pass is 6 n flops per complex output
// element, r2c and c2r 4 n_in n_out per row. One stylize call of the train
// batch (2x4x128x128x64) is 15.5 GFLOP against 0.41 GB moved: at the H100
// SXM data sheet's 67 TFLOP/s float32 CUDA-core and 3.35 TB/s HBM peaks
// (700 W), 0.23 ms of operations against 0.12 ms of memory, so the float32
// tier is bound by operations. chip_smoke.py computes these bounds from the
// views it runs and measures the kernel beside them (PERF.md).
//
// Design (first, simple version). The TPU kernel keeps each whole n x n
// matrix resident in VMEM (three 230 KB float32 matrices at n = 240); that
// does not fit the 227 KB of shared memory a block may use, so this kernel
// is a shared-memory-tiled SGEMM with a loop over the contraction axis
// instead: 64 x 64 output tiles, depth 16 per stage, 256 threads with a
// 4 x 4 register tile of EVERY product of the body (three accumulators per
// output for c2c, two for r2c and c2r). The re+im sum of c2c is formed once
// per loaded element. Every edge is masked (n = 33, 78, 155 and the sublane
// extents are multiples of nothing), and offsets are 64-bit. The grid is one
// flat index over (batch, row tiles, column tiles).
//
// Precision tiers (template FAST): false = float32 operands with float32
// FMA accumulation (the port's "highest", and JAX's HIGH, whose in-kernel
// bf16x3 split is less accurate); true = every operand, the re+im sum
// included, rounded to bf16 (__float2bfloat16_rn) and accumulated in float32,
// as the TPU kernel's single-pass "1x" dots. Tensor cores (wgmma), TMA and a
// split-bf16 or 3xTF32 tier are later work.
//
// The C entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // output rows per tile
constexpr int BN = 64;   // output columns per tile
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int PAD = 4;   // row padding of the tiles (keeps float4 alignment)
constexpr int NT = 256;  // threads per CTA: 16 x 16, 4 x 4 outputs each

enum Body : int { R2C = 0, C2C = 1, C2R = 2 };

// ND data operands per loaded element, NP products (one matrix each).
template <int BODY> struct Arity;
template <> struct Arity<R2C> { static constexpr int ND = 1, NP = 2; };
template <> struct Arity<C2C> { static constexpr int ND = 3, NP = 3; };
template <> struct Arity<C2R> { static constexpr int ND = 2, NP = 2; };

// The data operand that product t multiplies.
template <int BODY>
__host__ __device__ constexpr int data_of(int t) { return BODY == R2C ? 0 : t; }

struct Args {
  const float* in0; const float* in1;
  const float* mat0; const float* mat1; const float* mat2;
  float* out0; float* out1;
  long long n_in, n_out, len;
  long long tiles_r, tiles_c;
};

template <bool FAST>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (FAST) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// The data operands of one element at offset o, in product order:
// r2c (x); c2c (re+im, im, re); c2r (re, im).
template <int BODY, bool FAST>
__device__ __forceinline__ void load_data(const Args& p, size_t o, bool ok,
                                          float (&d)[Arity<BODY>::ND]) {
  if constexpr (BODY == R2C) {
    d[0] = ok ? rnd<FAST>(p.in0[o]) : 0.f;
  } else {
    const float re = ok ? p.in0[o] : 0.f;
    const float im = ok ? p.in1[o] : 0.f;
    if constexpr (BODY == C2C) {
      d[0] = rnd<FAST>(re + im);
      d[1] = rnd<FAST>(im);
      d[2] = rnd<FAST>(re);
    } else {
      d[0] = rnd<FAST>(re);
      d[1] = rnd<FAST>(im);
    }
  }
}

template <int BODY, bool FAST>
__device__ __forceinline__ void load_mats(const Args& p, size_t o, bool ok,
                                          float (&m)[Arity<BODY>::NP]) {
  const float* mats[3] = {p.mat0, p.mat1, p.mat2};
#pragma unroll
  for (int t = 0; t < Arity<BODY>::NP; ++t) m[t] = ok ? rnd<FAST>(mats[t][o]) : 0.f;
}

// One output tile. The A operand (rows of the tile) and the B operand
// (columns) sit in shared memory as [depth][row or column]:
//   lane:    A = data rows m, B = matrices;
//   sublane: A = matrices read along n_out, B = data columns b.
template <int BODY, bool LANE, bool FAST>
__global__ void __launch_bounds__(NT) axis_dft_kernel(Args p) {
  constexpr int ND = Arity<BODY>::ND, NP = Arity<BODY>::NP;
  constexpr int NA = LANE ? ND : NP;
  constexpr int NB = LANE ? NP : ND;
  __shared__ __align__(16) float sa[NA][BK][BM + PAD];
  __shared__ __align__(16) float sb[NB][BK][BN + PAD];

  long long bid = blockIdx.x;
  const long long tc = bid % p.tiles_c;
  bid /= p.tiles_c;
  const long long tr = bid % p.tiles_r;
  const long long a = bid / p.tiles_r;
  const long long r0 = tr * BM, c0 = tc * BN;
  const long long R = LANE ? p.len : p.n_out;   // output rows
  const long long C = LANE ? p.n_out : p.len;   // output columns
  const long long K = p.n_in;
  const size_t in_base = LANE ? 0 : (size_t)a * (size_t)K * (size_t)p.len;
  const size_t out_base = LANE ? 0 : (size_t)a * (size_t)p.n_out * (size_t)p.len;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[NP][4][4];
#pragma unroll
  for (int t = 0; t < NP; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][r][c] = 0.f;

  for (long long k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM rows x BK depth
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int e = tid + i * NT;
      if constexpr (LANE) {  // data: in[m][j], contiguous along j
        const int kk = e % BK, ii = e / BK;
        const long long m = r0 + ii, j = k0 + kk;
        float d[ND];
        load_data<BODY, FAST>(p, (size_t)m * (size_t)K + (size_t)j, m < R && j < K, d);
#pragma unroll
        for (int t = 0; t < ND; ++t) sa[t][kk][ii] = d[t];
      } else {  // matrices: mat[j][k], contiguous along the output row k
        const int ii = e % BM, kk = e / BM;
        const long long k = r0 + ii, j = k0 + kk;
        float mv[NP];
        load_mats<BODY, FAST>(p, (size_t)j * (size_t)p.n_out + (size_t)k, k < R && j < K, mv);
#pragma unroll
        for (int t = 0; t < NP; ++t) sa[t][kk][ii] = mv[t];
      }
    }
    // B tile: BK depth x BN columns, contiguous along the column
#pragma unroll
    for (int i = 0; i < BN * BK / NT; ++i) {
      const int e = tid + i * NT;
      const int jj = e % BN, kk = e / BN;
      const long long c = c0 + jj, j = k0 + kk;
      const bool ok = c < C && j < K;
      if constexpr (LANE) {  // matrices: mat[j][c]
        float mv[NP];
        load_mats<BODY, FAST>(p, (size_t)j * (size_t)p.n_out + (size_t)c, ok, mv);
#pragma unroll
        for (int t = 0; t < NP; ++t) sb[t][kk][jj] = mv[t];
      } else {  // data: in[a][j][c]
        float d[ND];
        load_data<BODY, FAST>(p, in_base + (size_t)j * (size_t)p.len + (size_t)c, ok, d);
#pragma unroll
        for (int t = 0; t < ND; ++t) sb[t][kk][jj] = d[t];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float4 av[NA], bv[NB];
#pragma unroll
      for (int t = 0; t < NA; ++t)
        av[t] = *reinterpret_cast<const float4*>(&sa[t][kk][ty * 4]);
#pragma unroll
      for (int t = 0; t < NB; ++t)
        bv[t] = *reinterpret_cast<const float4*>(&sb[t][kk][tx * 4]);
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        const float4 a4 = av[LANE ? data_of<BODY>(t) : t];
        const float4 b4 = bv[LANE ? t : data_of<BODY>(t)];
        const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t][r][c] = fmaf(ar[r], bc[c], acc[t][r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = r0 + ty * 4 + r;
    if (row >= R) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long col = c0 + tx * 4 + c;
      if (col >= C) continue;
      const size_t o = out_base + (size_t)row * (size_t)C + (size_t)col;
      if constexpr (BODY == R2C) {
        p.out0[o] = acc[0][r][c];
        p.out1[o] = acc[1][r][c];
      } else if constexpr (BODY == C2C) {
        p.out0[o] = acc[0][r][c] - acc[1][r][c];
        p.out1[o] = acc[0][r][c] + acc[2][r][c];
      } else {
        p.out0[o] = acc[0][r][c] - acc[1][r][c];
      }
    }
  }
}

template <int BODY>
void launch(bool lane, bool fast, const Args& p, unsigned blocks, cudaStream_t st) {
  if (lane) {
    if (fast) axis_dft_kernel<BODY, true, true><<<blocks, NT, 0, st>>>(p);
    else      axis_dft_kernel<BODY, true, false><<<blocks, NT, 0, st>>>(p);
  } else {
    if (fast) axis_dft_kernel<BODY, false, true><<<blocks, NT, 0, st>>>(p);
    else      axis_dft_kernel<BODY, false, false><<<blocks, NT, 0, st>>>(p);
  }
}

}  // namespace

// body: 0 r2c, 1 c2c, 2 c2r. lane: 1 for the (len, n_in) view, 0 for the
// (batch, n_in, len) view (batch must be 1 for lane). Inputs in0 (x or re)
// and in1 (im, unused by r2c); matrices mat0..mat2 (n_in, n_out), mat2 used
// by c2c only; outputs out0 and out1 (unused by c2r).
extern "C" int mvtb_axis_dft(int body, int lane, int fast,
                             const float* in0, const float* in1,
                             const float* mat0, const float* mat1, const float* mat2,
                             float* out0, float* out1,
                             long long batch, long long n_in, long long n_out,
                             long long len, void* stream) {
  Args p{in0, in1, mat0, mat1, mat2, out0, out1, n_in, n_out, len, 0, 0};
  const long long R = lane ? len : n_out;
  const long long C = lane ? n_out : len;
  p.tiles_r = (R + BM - 1) / BM;
  p.tiles_c = (C + BN - 1) / BN;
  const long long blocks = batch * p.tiles_r * p.tiles_c;
  if (blocks <= 0 || n_in <= 0) return (int)cudaErrorInvalidValue;
  if (blocks > INT_MAX || (lane && batch != 1)) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body) {
    case R2C: launch<R2C>(lane != 0, fast != 0, p, (unsigned)blocks, st); break;
    case C2C: launch<C2C>(lane != 0, fast != 0, p, (unsigned)blocks, st); break;
    case C2R: launch<C2R>(lane != 0, fast != 0, p, (unsigned)blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mvtb_axis_dft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
