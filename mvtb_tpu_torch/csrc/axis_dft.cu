// Matmul-DFT axis kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of mvtb_tpu/ops/pallas_dft.py: _r2c_kernel,
// _c2c_kernel and _c2r_kernel, each in both orientations of _lane_call and
// _sub_call:
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
// Precision tiers, the TPU kernels' _fast: float32 (the port's "highest",
// JAX HIGHEST), bf16x3 ("high", JAX HIGH: x = hi + lo with hi = bf16_rn(x),
// lo = bf16_rn(x - hi), the residual with float32 denormals flushed as XLA
// computes it, and hi.hi + hi.lo + lo.hi), bf16 ("default", JAX DEFAULT:
// every operand rounded to bf16 once). All accumulate in float32; the re+im
// sum of c2c is formed in float32 before it is rounded or split.
//
// Two bodies, one kernel per (body, tier):
//
// 1. axis_tc_kernel: every body at bf16x3 and bf16, on the tensor cores.
//    What bounds it on this card: bytes. At bf16x3 a c2c pass at the bench
//    shape (16 x 240 x 240 x 78 complex) is 1.15 GB of data and 0.31 TFLOP of
//    bf16 products: 0.34 ms at 3.35 TB/s against 0.31 ms at 989 TFLOP/s; r2c
//    and c2r at the bench shape move 1.15 GB against 0.13 TFLOP; at the train
//    shape 68 MB against 3 GFLOP. So the design keeps bytes in flight and
//    does the split in their shadow; the tensor cores' rate is not the
//    lever. It is a GEMM with the data as the wgmma A operand and the matrix
//    as B: output rows are data points c (lane: the rows m of the (len, n_in)
//    view; sublane: the flat column q = a * len + b of the (batch, n_in, len)
//    view, so one tile spans several slabs when len is narrow, 33 or 78 at
//    the path's W pass), output columns the transform's outputs r, the
//    contraction the transform axis j. A block of two warpgroups (256
//    threads) owns 128 data points (64 a warpgroup) and one group of output
//    columns: 80 for c2c (three Gauss accumulators of 64 x 80 a warpgroup,
//    120 registers a thread); 80 or 160 for r2c, whose one matrix is
//    [cos | sin] (2 n_out columns, 66 at D = 64, 156 at D = 155) in one or
//    two 80-wide accumulators; 80 or 160 for c2r (n_out columns, 64 or 155 on
//    the path's lane), one or two 80-wide accumulators fed by two terms,
//    re . cos and im . (-sin), the sign folded into the packed matrix
//    (negation is exact in both bf16 splits). c2r keeps two terms of n_in
//    depth rather than one term [re | im] of 2 n_in: both inputs are copied
//    at the same contraction step, as c2c's are, so a stage carries twice the
//    bytes (more in flight for the same ring) and the stages, each a round of
//    barriers, are half as many (5 at the bench's n_in = 78, 3 at the train's
//    33, against 10 and 5 or 6); the cost is a second fragment set of 8
//    registers a part. The block is persistent: it walks its items (tile,
//    group) with the stage loop flattened over them, so the next item's
//    copies are in flight while an item's epilogue stores; its indices are
//    32-bit counters (a 64-bit division once a stage a thread cost about a
//    third of the time). Per 16-deep stage, through a ring of 4
//    shared-memory slots, 2 stages ahead:
//      - one thread asks the copy engine for the stage's matrix block (every
//        term and part, pre-lowered on the host in the wgmma core-matrix
//        layout, ops/pallas_dft.py:pack_mats, one contiguous block), counted
//        on the slot's mbarrier; every thread issues cp.async copies of the
//        float32 data, 16 bytes a copy where rows and bases allow it (lane:
//        n_in % 4 == 0; sublane: len % 4 == 0), 8 where they are even (the
//        bench W pass and c2r's bench rows, 78), else 4, coalesced along the
//        view's contiguous axis. TMA tensor maps need 16-byte strides, which
//        the path's views (33, 78, 155 floats) do not have;
//      - every thread loads its A fragments from the staged data (two data
//        points, four contraction steps of each), forms c2c's re+im in
//        float32 and splits (split8, sub.rn.ftz) straight into the registers
//        wgmma reads A from: the converted operand never goes through shared
//        memory, and the tensor cores read only the matrix there. The
//        fragments alternate between two register sets, so a stage is
//        converted while the tensor cores still run the one before;
//      - each warpgroup issues its 3 (bf16) or 9 (bf16x3) wgmma m64n80k16 for
//        c2c, 1 or 3 per chunk and term for r2c and c2r, waiting only for the
//        stage before.
//    The epilogue stores each accumulator element scalar in the sublane
//    view (a warp's stores of one output column are 8 consecutive data
//    points, one 32-byte sector); on the lane, r2c and c2r stage their tile
//    through shared memory so rows leave as contiguous runs (r2c all of
//    [cos | sin] at once, c2r one 80-column chunk at a time, which keeps its
//    two-input ring of 4 slots inside the 227 KB a block may use).
//    ptxas: c2c at bf16x3 takes 255 registers with a few bytes of spills;
//    c2r on the lane at bf16x3 128 registers with one chunk (train) and 228
//    with two (bench), no spills; every instantiation reports (C7517) a
//    wgmma wait ptxas injects to protect registers the tensor cores write
//    (PERF.md).
//
// 2. axis_dft_kernel: the float32 tier of every body, on CUDA cores: it has
//    no tensor-core form at float32 accuracy. What bounds it: operations
//    (the four c2c passes of one stylize call at the bench shape are 0.41
//    TFLOP of float32 FMA, 6.2 ms at 67 TFLOP/s, against 1.4 ms of bytes). A
//    shared-memory-tiled SGEMM: 64 x 64 output tiles, depth 16 per stage,
//    256 threads with a 4 x 4 register tile of every product of the body
//    (three accumulators per output for c2c, two for r2c and c2r). Every
//    edge is masked, offsets are 64-bit, the grid is one flat index over
//    (batch, row tiles, column tiles).
//
// The C entry points launch on the given stream, allocate nothing and
// return cudaGetLastError() (or the error of a refused configuration).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "gauss_wgmma.cuh"

namespace {

enum Body : int { R2C = 0, C2C = 1, C2R = 2 };

// ---------------------------------------------------------------------------
// 1. The float32 tier: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int BM = 64;   // output rows per tile
constexpr int BN = 64;   // output columns per tile
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int PAD = 4;   // row padding of the tiles (keeps float4 alignment)
constexpr int NT = 256;  // threads per CTA: 16 x 16, 4 x 4 outputs each

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

// The data operands of one element at offset o, in product order:
// r2c (x); c2c (re+im, im, re); c2r (re, im).
template <int BODY>
__device__ __forceinline__ void load_data(const Args& p, size_t o, bool ok,
                                          float (&d)[Arity<BODY>::ND]) {
  if constexpr (BODY == R2C) {
    d[0] = ok ? p.in0[o] : 0.f;
  } else {
    const float re = ok ? p.in0[o] : 0.f;
    const float im = ok ? p.in1[o] : 0.f;
    if constexpr (BODY == C2C) {
      d[0] = re + im;
      d[1] = im;
      d[2] = re;
    } else {
      d[0] = re;
      d[1] = im;
    }
  }
}

template <int BODY>
__device__ __forceinline__ void load_mats(const Args& p, size_t o, bool ok,
                                          float (&m)[Arity<BODY>::NP]) {
  const float* mats[3] = {p.mat0, p.mat1, p.mat2};
#pragma unroll
  for (int t = 0; t < Arity<BODY>::NP; ++t) m[t] = ok ? mats[t][o] : 0.f;
}

// One output tile. The A operand (rows of the tile) and the B operand
// (columns) sit in shared memory as [operand][depth][row or column]:
//   lane:    A = data rows m, B = matrices;
//   sublane: A = matrices read along n_out, B = data columns b.
template <int BODY, bool LANE>
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
      float v[NA];
      int kk, ii;
      if constexpr (LANE) {  // data: in[m][j], contiguous along j
        kk = e % BK, ii = e / BK;
        const long long m = r0 + ii, j = k0 + kk;
        load_data<BODY>(p, (size_t)m * (size_t)K + (size_t)j, m < R && j < K, v);
      } else {  // matrices: mat[j][k], contiguous along the output row k
        ii = e % BM, kk = e / BM;
        const long long k = r0 + ii, j = k0 + kk;
        load_mats<BODY>(p, (size_t)j * (size_t)p.n_out + (size_t)k, k < R && j < K, v);
      }
#pragma unroll
      for (int t = 0; t < NA; ++t) sa[t][kk][ii] = v[t];
    }
    // B tile: BK depth x BN columns, contiguous along the column
#pragma unroll
    for (int i = 0; i < BN * BK / NT; ++i) {
      const int e = tid + i * NT;
      const int jj = e % BN, kk = e / BN;
      const long long c = c0 + jj, j = k0 + kk;
      const bool ok = c < C && j < K;
      float v[NB];
      if constexpr (LANE) {  // matrices: mat[j][c]
        load_mats<BODY>(p, (size_t)j * (size_t)p.n_out + (size_t)c, ok, v);
      } else {  // data: in[a][j][c]
        load_data<BODY>(p, in_base + (size_t)j * (size_t)p.len + (size_t)c, ok, v);
      }
#pragma unroll
      for (int t = 0; t < NB; ++t) sb[t][kk][jj] = v[t];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float4 av[NA], bv[NB];
#pragma unroll
      for (int t = 0; t < NA; ++t) av[t] = *reinterpret_cast<const float4*>(&sa[t][kk][ty * 4]);
#pragma unroll
      for (int t = 0; t < NB; ++t) bv[t] = *reinterpret_cast<const float4*>(&sb[t][kk][tx * 4]);
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        const int ta = LANE ? data_of<BODY>(t) : t, tb = LANE ? t : data_of<BODY>(t);
        const float ah[4] = {av[ta].x, av[ta].y, av[ta].z, av[ta].w};
        const float bh[4] = {bv[tb].x, bv[tb].y, bv[tb].z, bv[tb].w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[t][r][c] = fmaf(ah[r], bh[c], acc[t][r][c]);
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
void launch_simt(bool lane, const Args& p, unsigned blocks, cudaStream_t st) {
  if (lane) axis_dft_kernel<BODY, true><<<blocks, NT, 0, st>>>(p);
  else      axis_dft_kernel<BODY, false><<<blocks, NT, 0, st>>>(p);
}

// ---------------------------------------------------------------------------
// 2. bf16x3 and bf16: tensor cores.
// ---------------------------------------------------------------------------

namespace tc {

using namespace gauss_wgmma;

constexpr int NWG = 2;              // warpgroups a block
constexpr int NTC = NWG * 128;      // threads a block
constexpr int CT = NWG * TM;        // data points a tile (output rows)
constexpr int STAGES = 4;           // ring depth
constexpr int AHEAD = STAGES - 2;   // stages in flight beyond the one consumed
// Row pitches (floats) of the staged data: lane [point][k], read as float2
// pairs along k by 16 lanes at a time (24: rows g = 0..3 start on banks 0,
// 24, 16, 8); sublane [k][point], read as scalars by (point g, k 2t) lanes
// (132: bank 4k + point covers 32 banks).
constexpr int LPITCH = 24;
constexpr int SPITCH = CT + 4;

// T terms (data operand x matrix), ND data inputs.
template <int BODY> struct Terms;
template <> struct Terms<R2C> { static constexpr int T = 1, ND = 1; };
template <> struct Terms<C2C> { static constexpr int T = 3, ND = 2; };
template <> struct Terms<C2R> { static constexpr int T = 2, ND = 2; };

// NCH 80-wide output chunks of one warpgroup: r2c's [cos | sin], c2r's
// outputs (both terms summed into the same chunk).
template <int NCH> struct Chunks {
  float k[NCH][ACC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < NCH; ++t)
#pragma unroll
      for (int i = 0; i < ACC; ++i) k[t][i] = 0.f;
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int t = 0; t < NCH; ++t) fence_operands(k[t]);
  }
};
// Accumulators of one warpgroup: the three Gauss products (c2c), else chunks.
template <int BODY, int NCH> struct AccOf { using type = Chunks<NCH>; };
template <int NCH> struct AccOf<C2C, NCH> { using type = Acc; };

struct TcArgs {
  const float* in0; const float* in1;
  const __nv_bfloat16* mats;
  float* out0; float* out1;
  int Q;                // data points: lane rows, or batch * len
  int K, n_out, len;    // contraction, outputs, trailing extent (sublane)
  int groups, nk, vec;  // output-column groups, 16-deep steps, floats a copy (4, 2, 1)
  int items;            // tiles * groups
};

template <int BODY, bool LANE, int P, int NCH>
struct TcSmem {
  static constexpr int T = Terms<BODY>::T, ND = Terms<BODY>::ND;
  static constexpr int B_STEP = NCH * B_TILE_BYTES;  // bytes between B term parts
  static constexpr int MAT = T * P * B_STEP;         // a stage of the matrix
  static constexpr int STG = ND * (LANE ? CT * LPITCH : TK * SPITCH) * 4;  // a stage of data
  // the lane's output tile is staged here for row-contiguous stores: r2c's
  // whole [cos | sin], c2r's one 80-column chunk at a time
  static constexpr bool STAGED_OUT = BODY != C2C && LANE;
  static constexpr int OPITCH = (BODY == R2C ? NCH * TN : TN) + 8;
  static constexpr int OUT = STAGED_OUT ? CT * OPITCH * 4 : 0;
  static constexpr int BARS = 128;  // the ring's mbarriers, one a slot
  static constexpr int BYTES = BARS + STAGES * (MAT + STG) + OUT;
};

// The A operand fragments of one stage: per term, per part, 4 registers.
template <int T, int P> struct Frag { uint32_t r[T][P][4]; };

template <int BODY, bool LANE, int P, int NCH>
__global__ void __launch_bounds__(NTC, 1) axis_tc_kernel(const __grid_constant__ TcArgs p) {
  using S = TcSmem<BODY, LANE, P, NCH>;
  constexpr int T = S::T, ND = S::ND;
  constexpr int GR = NCH * TN;  // output columns a group
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* mat_ring = smem + S::BARS;
  float* stg_ring = reinterpret_cast<float*>(mat_ring + STAGES * S::MAT);
  float* out_tile = reinterpret_cast<float*>(mat_ring + STAGES * (S::MAT + S::STG));
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int Q = p.Q, K = p.K, nk = p.nk, len = p.len;
  // this block's items are blockIdx.x, + gridDim.x, ...; its stages run over
  // them in order, nk a item. Indices are 32-bit and advance by counting:
  // a 64-bit division costs some hundred instructions, once a stage a thread.
  const int total = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nk;
  const float* ins[2] = {p.in0, p.in1};

  // A position in the block's stage stream: item, its first data point
  // and output group, the 16-deep step, and (sublane) the offset of this
  // thread's copy column in the input (-1 past Q).
  struct Pos {
    int it, c0, g, kk;
    long long col;
  };
  auto start = [&](Pos& q, int it) {
    q.it = it;
    q.c0 = it / p.groups * CT;
    q.g = it % p.groups;
    q.kk = 0;
    if constexpr (!LANE) {
      const int c = (tid % (CT / p.vec)) * p.vec;
      const int x = q.c0 + c;
      q.col = x < Q ? (long long)(x / len) * K * len + x % len : -1;
    }
  };
  auto advance = [&](Pos& q) {
    if (++q.kk == nk) start(q, q.it + (int)gridDim.x);
  };

  // Issues the copies of the next stage into its slot; elements past Q or K
  // are not copied (the fragment loads zero them).
  Pos pq;
  start(pq, blockIdx.x);
  int issued = 0;
  auto issue = [&]() {
    if (issued < total) {
      const int k0 = pq.kk * TK, c0 = pq.c0;
      const int slot = issued % STAGES;
      const uint8_t* msrc = reinterpret_cast<const uint8_t*>(p.mats) +
                            ((size_t)pq.g * nk + pq.kk) * S::MAT;
      float* sd = stg_ring + slot * (S::STG / 4);
      if (tid == NTC - 1) {  // one request of the copy engine for the matrix block
        mbar_expect_tx(bars + slot, S::MAT);
        bulk_load(mat_ring + slot * S::MAT, msrc, S::MAT, bars + slot);
      }
      if constexpr (LANE) {  // [d][c][LPITCH]; in[c][k], contiguous along k
        if (p.vec == 4) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = tid / 4 + 64 * i, kq = (tid % 4) * 4;
            if (c0 + c < Q && k0 + kq < K) {
              const size_t o = (size_t)(c0 + c) * K + k0 + kq;
#pragma unroll
              for (int d = 0; d < ND; ++d)
                cp_async16(sd + (d * CT + c) * LPITCH + kq, ins[d] + o);
            }
          }
        } else if (p.vec == 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = tid / 8 + 32 * i, kq = (tid % 8) * 2;
            if (c0 + c < Q && k0 + kq < K) {
              const size_t o = (size_t)(c0 + c) * K + k0 + kq;
#pragma unroll
              for (int d = 0; d < ND; ++d)
                cp_async8(sd + (d * CT + c) * LPITCH + kq, ins[d] + o);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = tid / 16 + 16 * i, k = tid % 16;
            if (c0 + c < Q && k0 + k < K) {
              const size_t o = (size_t)(c0 + c) * K + k0 + k;
#pragma unroll
              for (int d = 0; d < ND; ++d) cp_async4(sd + (d * CT + c) * LPITCH + k, ins[d] + o);
            }
          }
        }
      } else if (pq.col >= 0) {  // [d][k][SPITCH]; in[a][k][b], contiguous along b
        const size_t base = (size_t)pq.col + (size_t)k0 * len;
        if (p.vec == 4) {  // len % 4 == 0: four columns never straddle a slab
          const int c4 = (tid % 32) * 4;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int k = tid / 32 + 8 * i;
            if (k0 + k < K) {
#pragma unroll
              for (int d = 0; d < ND; ++d)
                cp_async16(sd + (d * TK + k) * SPITCH + c4, ins[d] + base + (size_t)k * len);
            }
          }
        } else if (p.vec == 2) {  // len % 2 == 0: two columns never straddle a slab
          const int c2 = (tid % 64) * 2;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = tid / 64 + 4 * i;
            if (k0 + k < K) {
#pragma unroll
              for (int d = 0; d < ND; ++d)
                cp_async8(sd + (d * TK + k) * SPITCH + c2, ins[d] + base + (size_t)k * len);
            }
          }
        } else {
          const int c = tid % CT;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int k = tid / CT + 2 * i;
            if (k0 + k < K) {
#pragma unroll
              for (int d = 0; d < ND; ++d)
                cp_async4(sd + (d * TK + k) * SPITCH + c, ins[d] + base + (size_t)k * len);
            }
          }
        }
      }
      advance(pq);
      ++issued;
    }
    cp_async_commit();
  };

  // Stage s into this thread's A fragments: data points c = wg*64 + warp*16
  // + g8 (+8), contraction 2*t4, 2*t4 + 1 (+8); the terms (r2c: x; c2c:
  // re+im, im, re; c2r: re, im) formed in float32, then rounded or split
  // (split8 packs the pairs in the fragment's register order).
  auto load_frag = [&](int s, const Pos& q, Frag<T, P>& f) {
    const int k0 = q.kk * TK;
    const float* sd = stg_ring + (s % STAGES) * (S::STG / 4);
    const int cr = wg * TM + warp * 16 + g8;
    float v[ND][8];  // element 2j + e: row cr + 8 (j & 1), k 2 t4 + e + 8 (j >> 1)
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cr + 8 * (j & 1), k = 2 * t4 + 8 * (j >> 1);
        float2 x;
        if constexpr (LANE) {
          x = *reinterpret_cast<const float2*>(sd + (d * CT + c) * LPITCH + k);
        } else {
          x = make_float2(sd[(d * TK + k) * SPITCH + c], sd[(d * TK + k + 1) * SPITCH + c]);
        }
        const bool okc = q.c0 + c < Q;
        v[d][2 * j] = okc && k0 + k < K ? x.x : 0.f;
        v[d][2 * j + 1] = okc && k0 + k + 1 < K ? x.y : 0.f;
      }
    auto put = [&](int t, const float (&x)[8]) {
      uint4 hi, lo;
      split8<P>(x, hi, lo);
      f.r[t][0][0] = hi.x; f.r[t][0][1] = hi.y; f.r[t][0][2] = hi.z; f.r[t][0][3] = hi.w;
      if constexpr (P == 2) {
        f.r[t][P - 1][0] = lo.x; f.r[t][P - 1][1] = lo.y;
        f.r[t][P - 1][2] = lo.z; f.r[t][P - 1][3] = lo.w;
      }
    };
    if constexpr (BODY == C2C) {
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = v[0][e] + v[1][e];
      put(0, sum);   // (re+im) . cos
      put(1, v[1]);  // im . (cos+sin)
      put(2, v[0]);  // re . (sin-cos)
    } else {
#pragma unroll
      for (int d = 0; d < ND; ++d) put(d, v[d]);  // r2c: x . [cos|sin]; c2r: re . cos, im . (-sin)
    }
  };

  using AccT = typename AccOf<BODY, NCH>::type;
  // Accumulator 4q + 2h + e of this thread: data point (row) warp*16 +
  // lane/4 + 8h of the warpgroup's 64, output column 8q + 2*(lane%4) + e of
  // its 80-wide chunk (acc_row, acc_col).
  auto epilogue = [&](const AccT& acc, const Pos& q) {
    const int n_out = p.n_out;
    if constexpr (S::STAGED_OUT) {
      // the tile through shared memory, so rows c of the outputs leave as
      // contiguous runs: r2c's [cos | sin] at once (out0 and out1), c2r's
      // chunks one after another (runs of 80 columns)
      if (p.groups == 1) {
        const int rows = min(Q - q.c0, CT);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int base = BODY == R2C ? ch * TN : 0;
#pragma unroll
          for (int i4 = 0; i4 < ACC / 4; ++i4)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * i4 + 2 * h;
              const int row = wg * TM + acc_row(i, warp, lane);
              *reinterpret_cast<float2*>(out_tile + row * S::OPITCH + base + acc_col(i, lane)) =
                  make_float2(acc.k[ch][i], acc.k[ch][i + 1]);
            }
          if constexpr (BODY == C2R) {
            __syncthreads();
            const int width = min(n_out - ch * TN, TN);
            float* dst = p.out0 + (size_t)q.c0 * n_out + ch * TN;
            for (int c = tid / 32; c < rows; c += NTC / 32)
              for (int r = lane; r < width; r += 32)
                dst[(size_t)c * n_out + r] = out_tile[c * S::OPITCH + r];
            __syncthreads();
          }
        }
        if constexpr (BODY == R2C) {
          __syncthreads();
          for (int o = 0; o < 2; ++o) {
            float* dst = (o ? p.out1 : p.out0) + (size_t)q.c0 * n_out;
            for (int c = tid / 32; c < rows; c += NTC / 32)
              for (int r = lane; r < n_out; r += 32)
                dst[(size_t)c * n_out + r] = out_tile[c * S::OPITCH + o * n_out + r];
          }
          __syncthreads();
        }
        return;
      }
    }
    const int cb = q.c0 + wg * TM + acc_row(0, warp, lane);
    const int rb = q.g * GR + acc_col(0, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cb + 8 * h;
      if (c >= Q) continue;
      size_t ob, rs;
      if constexpr (LANE) {
        ob = (size_t)c * n_out;
        rs = 1;
      } else {
        ob = (size_t)(c / len) * n_out * len + c % len;
        rs = len;
      }
#pragma unroll
      for (int ch = 0; ch < (BODY == C2C ? 1 : NCH); ++ch)
#pragma unroll
        for (int i4 = 0; i4 < ACC / 4; ++i4)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * i4 + 2 * h + e;
            const int r = rb + ch * TN + 8 * i4 + e;
            if constexpr (BODY == C2C) {
              if (r < n_out) {
                const float2 y = gauss_out(acc, i);
                p.out0[ob + r * rs] = y.x;
                p.out1[ob + r * rs] = y.y;
              }
            } else if constexpr (BODY == R2C) {
              if (r < n_out) p.out0[ob + r * rs] = acc.k[ch][i];
              else if (r < 2 * n_out) p.out1[ob + (r - n_out) * rs] = acc.k[ch][i];
            } else {
              if (r < n_out) p.out0[ob + r * rs] = acc.k[ch][i];
            }
          }
    }
  };

  AccT acc;
  acc.zero();
  Pos cq;  // the stage being consumed
  start(cq, blockIdx.x);
  // One stage: its copies have landed (this thread's data, the matrix block,
  // then everyone's data), the copies of stage s + AHEAD start, the A
  // fragments are loaded and split while the tensor cores still run stage
  // s - 1, and this stage's wgmma are issued. The fragments alternate
  // between two register sets (the loop is unrolled by two), so stage s's
  // never overwrite the set stage s - 1's wgmma still read.
  auto stage = [&](int s, Frag<T, P>& f) {
    cp_async_wait<AHEAD - 1>();                         // this thread's data copies
    mbar_wait(bars + s % STAGES, (s / STAGES) & 1);     // the matrix block
    __syncthreads();  // everyone's data; stage s - 2's wgmma are done: its slot is free
    issue();
    load_frag(s, cq, f);
    const uint64_t b0 = make_desc(mat_ring + (s % STAGES) * S::MAT);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int ch = 0; ch < (BODY == C2C ? 1 : NCH); ++ch) {
        // term t against chunk ch of its matrix, into c2c's Gauss product t,
        // else into chunk ch (c2r sums both terms there)
        float(&d)[ACC] = acc.k[BODY == C2C ? t : ch];
        const uint64_t bh = desc_add(b0, t * P * S::B_STEP + ch * B_TILE_BYTES);
        wgmma_m64n80k16_rs(d, f.r[t][0], bh);
        if constexpr (P == 2) {
          wgmma_m64n80k16_rs(d, f.r[t][0], desc_add(bh, S::B_STEP));
          wgmma_m64n80k16_rs(d, f.r[t][P - 1], bh);
        }
      }
    wgmma_commit();
    if (cq.kk == nk - 1) {
      wgmma_wait<0>();
      acc.fence();
      epilogue(acc, cq);
      acc.zero();
    } else {
      wgmma_wait<1>();
    }
    advance(cq);
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) issue();
  Frag<T, P> fa, fb;
  for (int s = 0; s < total; s += 2) {
    stage(s, fa);
    if (s + 1 < total) stage(s + 1, fb);
  }
  cp_async_wait<0>();
}

template <int BODY, bool LANE, int P, int NCH>
cudaError_t launch(const TcArgs& p, cudaStream_t st) {
  constexpr int bytes = TcSmem<BODY, LANE, P, NCH>::BYTES;
  auto kernel = axis_tc_kernel<BODY, LANE, P, NCH>;
  // the grid's size (blocks resident on every SM) of each device, found once:
  // the host's share of a call is on the path, beside kernels of 0.05 ms
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    bytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTC, bytes)) !=
            cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const int grid = p.items < resident[dev] ? p.items : resident[dev];
  kernel<<<(unsigned)grid, NTC, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int BODY, int P, int NCH>
cudaError_t launch_or(bool lane, const TcArgs& p, cudaStream_t st) {
  return lane ? launch<BODY, true, P, NCH>(p, st) : launch<BODY, false, P, NCH>(p, st);
}

}  // namespace tc

}  // namespace

// The float32 tier of every body. body: 0 r2c, 1 c2c, 2 c2r. lane: 1 for
// the (len, n_in) view, 0 for the (batch, n_in, len) view (batch must be 1
// for lane). Inputs in0 (x or re) and in1 (im, unused by r2c); matrices
// mat0..mat2 (n_in, n_out), mat2 used by c2c only; outputs out0 and out1
// (unused by c2r).
extern "C" int mvtb_axis_dft(int body, int lane,
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
  const unsigned nb = (unsigned)blocks;
  if (body == R2C) launch_simt<R2C>(lane != 0, p, nb, st);
  else if (body == C2C) launch_simt<C2C>(lane != 0, p, nb, st);
  else if (body == C2R) launch_simt<C2R>(lane != 0, p, nb, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Every body at bf16 (parts 1) and bf16x3 (parts 2) on the tensor cores.
// mats: the packed bf16 matrices of ops/pallas_dft.py:pack_mats for
// (body, parts, nch); nch: 80-wide chunks a group (1, or 2 for r2c and
// c2r). cols: the data points (lane: rows of the (cols, n_in) view;
// sublane: batch * len of the (batch, n_in, len) view, len = 1 for lane).
extern "C" int mvtb_axis_dft_tc(int body, int lane, int parts, int nch,
                                const float* in0, const float* in1, const void* mats,
                                float* out0, float* out1, long long cols,
                                long long n_in, long long n_out, long long len,
                                void* stream) {
  using namespace tc;
  if (cols <= 0 || n_in <= 0 || n_out <= 0 || len <= 0 || (lane && len != 1))
    return (int)cudaErrorInvalidValue;
  if (n_in > INT_MAX / 4 || n_out > INT_MAX / 4 || len > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const int rows = body == R2C ? 2 * (int)n_out : (int)n_out;
  const int group = nch * TN;
  // floats a copy: 4 where the view's rows and the bases allow 16 bytes,
  // 2 where they allow 8, else 1
  auto aligned = [&](int bytes) {
    return (uintptr_t)in0 % bytes == 0 && (in1 == nullptr || (uintptr_t)in1 % bytes == 0);
  };
  const long long row = lane ? n_in : len;
  const int vec = row % 4 == 0 && aligned(16) ? 4 : row % 2 == 0 && aligned(8) ? 2 : 1;
  const int groups = (rows + group - 1) / group, nk = (int)((n_in + TK - 1) / TK);
  const long long items = (cols + CT - 1) / CT * groups;
  // 32-bit indices: data points, items, stages and each input's offsets
  if (cols >= INT_MAX - CT || items * nk >= INT_MAX) return (int)cudaErrorInvalidConfiguration;
  TcArgs p{in0, in1, static_cast<const __nv_bfloat16*>(mats), out0, out1, (int)cols,
           (int)n_in, (int)n_out, (int)len, groups, nk,
           vec, (int)items};
  if (parts != 1 && parts != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == C2C && nch == 1) {
    err = parts == 2 ? launch_or<C2C, 2, 1>(lane, p, st) : launch_or<C2C, 1, 1>(lane, p, st);
  } else if (body == R2C && nch == 1) {
    err = parts == 2 ? launch_or<R2C, 2, 1>(lane, p, st) : launch_or<R2C, 1, 1>(lane, p, st);
  } else if (body == R2C && nch == 2) {
    err = parts == 2 ? launch_or<R2C, 2, 2>(lane, p, st) : launch_or<R2C, 1, 2>(lane, p, st);
  } else if (body == C2R && nch == 1) {
    err = parts == 2 ? launch_or<C2R, 2, 1>(lane, p, st) : launch_or<C2R, 1, 1>(lane, p, st);
  } else if (body == C2R && nch == 2) {
    err = parts == 2 ? launch_or<C2R, 2, 2>(lane, p, st) : launch_or<C2R, 1, 2>(lane, p, st);
  }
  return (int)err;
}

extern "C" const char* mvtb_axis_dft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
