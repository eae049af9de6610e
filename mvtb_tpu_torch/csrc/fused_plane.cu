// Fused k-space plane kernel for Hopper (sm_90a), on the tensor cores.
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
// with Gauss's 3-product complex contraction against the matrices of
// mvtb_tpu_torch/ops/dft.py:
//   k1 = cos.(re+im),  re' = k1 - (cos+sin).im,  im' = k1 + (sin-cos).re.
//
// Precision tiers, the TPU kernel's own: P = 2 (`plane`) splits every
// operand into bf16 (hi, lo) and sums hi.hi + hi.lo + lo.hi (bf16x3); P = 1
// (`plane_fast`) rounds every operand to bf16 once. Both accumulate in
// float32. The matrices arrive pre-lowered from the host (ops/fused_plane.py:
// _kernel_mats) in the shared-memory layout the wgmma descriptors read;
// the data is split or rounded here, after re+im is formed in float32.
//
// What bounds it on this card. Per plane the four contractions are
// 12*W*D*(W+D) flops, times 3 for bf16x3. At the eval slice (968 planes of
// 240x160) that is 178 GFLOP: 0.54 ms (bf16x3) or 0.18 ms (bf16) at the
// 989 TFLOP/s bf16 tensor-core peak, against 0.60 GB of input and output,
// 0.18 ms at 3.35 TB/s. The TPU kernel keeps a plane in VMEM; here a
// 240x160 complex float32 plane (307 KB) exceeds the 227 KB a block may
// use, so each pass streams it through a scratch that stays mostly in L2.
// Three float32 accumulators of 64x80 a warpgroup (120 registers a thread)
// cap a block at two warpgroups and one block a SM, so the time goes to
// the instruction stream around the tensor cores: the float32 -> bf16
// conversion, the wgmma themselves (the issuing warps wait on them) and the
// epilogue's stores, one after the other; the copies arrive in time
// (plane_profile.py measures each phase).
//
// Design. One CTA of two warpgroups per plane. Each of the four passes is a
// tiled GEMM over the plane (the wgmma Gauss step of `gauss_wgmma.cuh`, a
// 64 x 80 tile a warpgroup): a W contraction in output tiles of 128 rows x
// 80 columns, the warpgroups on the two row halves of one data tile, so
// each data tile is converted once per 128 output rows; a D contraction in
// tiles of 64 rows x 160 columns, the warpgroups on the two column halves.
// The K loop runs in 16-deep stages through a ring of 4 shared-memory slots:
//   - the copy engine (TMA) fills a slot: one thread asks for the stage's
//     matrix box (every term and part, laid out as the wgmma descriptors
//     read it) and its float32 data boxes through tensor maps, completion
//     counted in bytes on the slot's mbarrier; only an input whose rows are
//     not 16-byte aligned (D % 4 != 0, first pass) is copied 4 bytes a thread
//     with cp.async. Stage s+2 is in flight while stage s is converted and
//     s-1 is on the tensor cores;
//   - all 256 threads convert the data tile into the wgmma operand layout
//     (bf16, or the (hi, lo) pair), fence it for the async proxy, and each
//     warpgroup issues 3 (bf16) or 9 (bf16x3) wgmma per stage;
//   - the epilogue writes re = k1 - k2, im = k1 + k3 as float2 pairs, times
//     the weight in the D-forward pass (its row terms computed once a row);
//     the tile loop is flattened into the stage loop, so the next tile's
//     copies start before a tile's epilogue.
// Pass order: in -W-> A -D,weights-> B -points-> B -D^-1-> A -W^-1-> out.
// When one D tile spans all of D (D <= 160), the D passes run in place
// (B == A), so a plane keeps one scratch buffer live; wider planes take a
// second buffer. One thread does the sequential point writes, with the
// masked-read semantics of the TPU kernel: a signed zero reads as +0, and
// the delta is added to the raw value. Weights use the reference's rounding
// order (no FMA contraction) so they agree bit for bit.
//
// The C entry point launches on the given stream, allocates nothing, sets
// the dynamic shared memory it needs, and returns cudaGetLastError().

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gauss_wgmma.cuh"

// Cycle counters of the stage loop, compiled in only with
// -DMVTB_PLANE_PROFILE (plane_profile.py): thread 0 of each block adds, per
// pass kind (0: W contraction, 1: D), the cycles of a stage spent waiting for
// its copies, issuing the next copies, converting, at the second barrier,
// issuing and waiting for wgmma, in tile epilogues, and the stage count.
#ifdef MVTB_PLANE_PROFILE
__device__ unsigned long long g_plane_profile[8192][2][8];
#define PROFILE_STAMP(v) const long long v = clock64()
#define PROFILE_ADD(i, cycles) \
  if (threadIdx.x == 0) g_plane_profile[blockIdx.x % 8192][MAT_LEFT ? 0 : 1][i] += (cycles)
#else
#define PROFILE_STAMP(v)
#define PROFILE_ADD(i, cycles)
#endif

namespace {

using namespace gauss_wgmma;

constexpr int NT = 256;            // threads: two warpgroups
constexpr int NWG = NT / 128;
// Output tiles: a W contraction's 128 rows x 80 columns (a warpgroup a
// 64-row half; both read one 80-column data tile, converted once), a D
// contraction's 64 rows x 160 columns (a warpgroup an 80-column half).
constexpr int WR = NWG * TM, WC = TN;
constexpr int DR = TM, DC = NWG * TN;
constexpr int BK = TK;             // depth of one ring stage
constexpr int STAGES = 4;          // ring depth
constexpr int AHEAD = STAGES - 2;  // stages in flight beyond the one consumed
constexpr int BAR_BYTES = 128;     // the ring's mbarriers, one a slot

enum : int {
  F_GIBBS = 1, F_GIBBS_SYM = 2, F_DISK = 4, F_INSIDE_OFF = 8, F_WRAP = 16,
};

struct Params {
  const float* k_re; const float* k_im;
  float* o_re; float* o_im;
  float* scratch;
  const __nv_bfloat16* mats;
  const float* wparams;
  const int* locs;
  const float* vals; const float* gates; const float* conjs; const float* scales;
  int N, Hh, H, W, D, Dp, n_stages, flags, in_vec, out_vec;
};

struct Weight {
  int H, W, D, hh, flags;
  float r2g, gg, r2d, gd, alpha;
};

// The kernel's tensor maps (TMA descriptors, built by the entry point):
// for each data source of a pass, its (re, im) rows as 2-D float32 tensors
// of D columns and N*Hh*W rows with the source's pitch, boxed as the pass
// reads them (WC x BK for a W contraction, BK x DR for a D one); for each
// matrix section, its bf16 parts as a 3-D tensor of 256-element units
// ([3P][Kp*Rp/256][256]), boxed as one stage's tiles of every part.
struct Maps {
  CUtensorMap x_re, x_im;      // the input, W box (only if its rows are aligned)
  CUtensorMap ad_re, ad_im;    // scratch A, D box
  CUtensorMap aw_re, aw_im;    // scratch A, W box
  CUtensorMap bd_re, bd_im;    // scratch B, D box
  CUtensorMap wf, df, wi, di;  // the matrix sections
};

// A plane of (re, im) rows with `pitch` floats between rows, starting at
// row `row0` of its tensor maps; `vec`: copied by the tensor maps (rows
// and bases 16-byte aligned), else 4 bytes a thread.
struct Src {
  const float* re; const float* im; int pitch; int vec;
  const CUtensorMap* re_map; const CUtensorMap* im_map; int row0;
};
// `vec`: rows and bases are 8-byte aligned (float2 stores).
struct Dst { float* re; float* im; int pitch; int vec; };

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

// Wrap factor of one axis: alpha where the shifted index is odd.
__device__ __forceinline__ float wrap_factor(float off, int n, float alpha) {
  const int s = (int)off + (off < 0.f ? n : 0);
  return (shifted(s, n) % 2 == 1) ? alpha : 1.f;
}

__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }

// The weight's terms that depend on the plane and the row (W index): the
// first two squares of each distance, summed in the reference's ((a+b)+c)
// order (no FMA contraction), and the wrap factors of H and W.
struct RowWeight {
  float g, gm, d, fh, fw;
};

__device__ __forceinline__ RowWeight row_weight(const Weight& p, int iw) {
  const float oh = off_of(p.hh, p.H), ow = off_of(iw, p.W);
  const float gh = (p.H % 2 == 0) ? -0.5f : 0.f;
  const float gw = (p.W % 2 == 0) ? -0.5f : 0.f;
  RowWeight r;
  r.g = __fadd_rn(sq(oh - gh), sq(ow - gw));
  r.gm = __fadd_rn(sq(mirror_off(oh, p.H) - gh), sq(mirror_off(ow, p.W) - gw));
  r.d = __fadd_rn(sq(oh), sq(ow));
  r.fh = wrap_factor(oh, p.H, p.alpha);
  r.fw = wrap_factor(ow, p.W, p.alpha);
  return r;
}

// The weight at column id of a row, in the reference's order.
__device__ __forceinline__ float weight_at(const Weight& p, const RowWeight& r, int id) {
  const float od = off_of(id, p.D);
  float w = 1.f;
  if (p.flags & F_GIBBS) {
    const float gdd = (p.D % 2 == 0) ? -0.5f : 0.f;
    float m = __fadd_rn(r.g, sq(od - gdd)) <= p.r2g ? 1.f : 0.f;
    if (p.flags & F_GIBBS_SYM) {
      const float mm = __fadd_rn(r.gm, sq(mirror_off(od, p.D) - gdd)) <= p.r2g ? 1.f : 0.f;
      m = (m + mm) * 0.5f;
    }
    w = __fmul_rn(w, __fadd_rn(__fmul_rn(p.gg, m), 1.f - p.gg));
  }
  if (p.flags & F_DISK) {
    const bool inside = __fadd_rn(r.d, sq(od)) < p.r2d;
    const float m = ((p.flags & F_INSIDE_OFF) ? !inside : inside) ? 1.f : 0.f;
    w = __fmul_rn(w, __fadd_rn(__fmul_rn(p.gd, m), 1.f - p.gd));
  }
  if (p.flags & F_WRAP) {
    w = __fmul_rn(w, r.fh);
    w = __fmul_rn(w, r.fw);
    w = __fmul_rn(w, wrap_factor(od, p.D, p.alpha));
  }
  return w;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one pass: the ring's barriers, the ring (matrix tile +
// float32 data tile per slot) and two converted data operands.
template <int P, bool MAT_LEFT>
struct PassSmem {
  static constexpr int MAT = 3 * P * NWG * (MAT_LEFT ? A_TILE_BYTES : B_TILE_BYTES);
  static constexpr int STG = 4 * 2 * BK * (MAT_LEFT ? WC : DR);
  static constexpr int OP = 3 * P * (MAT_LEFT ? B_TILE_BYTES : A_TILE_BYTES);
  static constexpr int BYTES = BAR_BYTES + STAGES * (MAT + STG) + 2 * OP;
};

template <int P>
constexpr int smem_bytes() {
  return PassSmem<P, true>::BYTES > PassSmem<P, false>::BYTES ? PassSmem<P, true>::BYTES
                                                              : PassSmem<P, false>::BYTES;
}

// bf16 parts of 8 values (one core-matrix row, uint4) or 4 (half, uint2).
template <int P>
__device__ __forceinline__ void split(const float (&x)[8], uint4& hi, uint4& lo) {
  split8<P>(x, hi, lo);
}
template <int P>
__device__ __forceinline__ void split(const float (&x)[4], uint2& hi, uint2& lo) {
  split4<P>(x, hi, lo);
}

// The three data terms (re+im, im, re) of N = 8 or 4 values along K, each
// rounded (P = 1) or split (P = 2), written at byte offset `off` of operand
// tiles `step` bytes apart (part p of term t at (t*P + p) * step).
template <int P, int N, typename V>
__device__ __forceinline__ void put_terms(uint8_t* op, int step, int off,
                                          const float (&re)[N], const float (&im)[N]) {
  float s[N];
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] = re[e] + im[e];
  V hi, lo;
  split<P>(s, hi, lo);
  *reinterpret_cast<V*>(op + (0 * P) * step + off) = hi;
  if constexpr (P == 2) *reinterpret_cast<V*>(op + 1 * step + off) = lo;
  split<P>(im, hi, lo);
  *reinterpret_cast<V*>(op + (1 * P) * step + off) = hi;
  if constexpr (P == 2) *reinterpret_cast<V*>(op + 3 * step + off) = lo;
  split<P>(re, hi, lo);
  *reinterpret_cast<V*>(op + (2 * P) * step + off) = hi;
  if constexpr (P == 2) *reinterpret_cast<V*>(op + 5 * step + off) = lo;
}

// One Gauss contraction over a W x D plane (rows W, columns D).
// MAT_LEFT: out = M . X (contract W; A = matrix rows, B = data columns);
// else:     out = X . M (contract D; A = data rows, B = matrix columns).
// `mat` maps the pass's pre-lowered matrix: for term t and part p, the tile
// of 16-deep chunk kk and rows r0.. sits at (t*P + p)*Kp*Rp + kk*Rp*16 +
// r0*16 elements, in the K-major core-matrix layout. `g0` numbers the
// pass's first stage within the kernel (the ring's barrier phases run on
// across passes); returns the number after its last.
template <int P, bool MAT_LEFT, bool WEIGHT>
__device__ int gauss_pass(uint8_t* smem, int g0, const Src src, const Dst dst,
                          const CUtensorMap* mat, int W, int D,
                          const Weight& wt) {
  using S = PassSmem<P, MAT_LEFT>;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int K = MAT_LEFT ? W : D;
  constexpr int TR = MAT_LEFT ? WR : DR;         // output rows per tile
  constexpr int TC = MAT_LEFT ? WC : DC;         // output columns per tile
  constexpr int MROWS = MAT_LEFT ? WR : DC;      // matrix rows per tile
  constexpr int MAT_TILE = MROWS * BK * 2;       // bytes of one term part
  constexpr int NR = MAT_LEFT ? BK : DR;         // data rows per stage
  constexpr int NC = MAT_LEFT ? WC : BK;         // data columns per stage
  // bytes between operand tiles of successive term parts
  constexpr int A_STEP = MAT_LEFT ? MAT_TILE : A_TILE_BYTES;
  constexpr int B_STEP = MAT_LEFT ? B_TILE_BYTES : MAT_TILE;
  const int Rp = round_up(MAT_LEFT ? W : D, MROWS);
  const int Kp = round_up(K, BK);
  const int ncol = (D + TC - 1) / TC;
  const int nk = Kp / BK;
  const int total = ((W + TR - 1) / TR) * ncol * nk;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* mat_ring = smem + BAR_BYTES;
  float* stg_ring = reinterpret_cast<float*>(mat_ring + STAGES * S::MAT);
  uint8_t* ops = mat_ring + STAGES * (S::MAT + S::STG);

  // Starts the copies of stage s into its slot: one thread asks the copy
  // engine for the matrix box and the data boxes (rows r0.., columns c0..
  // of `src`); an unaligned input is copied 4 bytes a thread. Rows past W
  // hold the next plane's rows or zeros, columns past D zeros or stale
  // values: the converter zeroes them.
  auto issue = [&](int s) {
    // only the thread that asks for the boxes, or every thread when an
    // unaligned input is copied 4 bytes a thread, has anything to compute
    if (s < total && (tid == NT - 1 || !src.vec)) {
      const int tile = s / nk, kk = s % nk;
      const int i0 = (tile / ncol) * TR, j0 = (tile % ncol) * TC;
      const int r0 = MAT_LEFT ? kk * BK : i0, c0 = MAT_LEFT ? j0 : kk * BK;
      const int slot = (g0 + s) % STAGES;
      float* sd = stg_ring + slot * (S::STG / 4);
      if (tid == NT - 1) {  // a thread of the last warp, whose conversion share is smallest
        uint64_t* bar = bars + slot;
        mbar_expect_tx(bar, 3 * P * MAT_TILE + (src.vec ? S::STG : 0));
        tma_load_3d(mat_ring + slot * S::MAT, mat, 0, (kk * Rp + (MAT_LEFT ? i0 : j0)) / 16, 0, bar);
        if (src.vec) {
          tma_load_2d(sd, src.re_map, c0, src.row0 + r0, bar);
          tma_load_2d(sd + NR * NC, src.im_map, c0, src.row0 + r0, bar);
        }
      }
      if (!src.vec) {
        const int nrows = min(NR, W - r0);
        for (int e = tid; e < 2 * NR * NC; e += NT) {
          const int c = e / (NR * NC), rem = e % (NR * NC);
          const int r = rem / NC, q = rem % NC;
          if (r < nrows && c0 + q < D)
            cp_async4(sd + (c * NR + r) * NC + q,
                      (c ? src.im : src.re) + (size_t)(r0 + r) * src.pitch + c0 + q);
        }
      }
    }
    cp_async_commit();
  };

  auto convert = [&](int s) {
    const int tile = s / nk, kk = s % nk;
    const int i0 = (tile / ncol) * TR, j0 = (tile % ncol) * TC, k0 = kk * BK;
    const float* sd = stg_ring + ((g0 + s) % STAGES) * (S::STG / 4);
    uint8_t* op = ops + (s & 1) * S::OP;
    if (MAT_LEFT) {  // data = B: WC rows (columns of the plane) x BK, 8 values an item
      for (int it = tid; it < 2 * WC; it += NT) {
        const int n = it % WC, kc = it / WC;
        const bool okn = j0 + n < D;
        float re[8], im[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = kc * 8 + e;
          const bool ok = okn && k0 + k < W;
          re[e] = ok ? sd[k * WC + n] : 0.f;
          im[e] = ok ? sd[(BK + k) * WC + n] : 0.f;
        }
        put_terms<P, 8, uint4>(op, B_STEP, tile_offset(n, kc * 8), re, im);
      }
    } else {  // data = A: DR rows x BK, 4 values an item, one item a thread
      static_assert(NT == 4 * DR, "one item a thread");
      const int r = tid / 4, kq = tid % 4;
      const bool okr = i0 + r < W;
      const float4 a4 = *reinterpret_cast<const float4*>(sd + r * BK + kq * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(sd + (DR + r) * BK + kq * 4);
      const float ra[4] = {a4.x, a4.y, a4.z, a4.w}, ia[4] = {b4.x, b4.y, b4.z, b4.w};
      float re[4], im[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = okr && k0 + kq * 4 + e < D;
        re[e] = ok ? ra[e] : 0.f;
        im[e] = ok ? ia[e] : 0.f;
      }
      put_terms<P, 4, uint2>(op, A_STEP, tile_offset(r, kq * 4), re, im);
    }
  };

  // Accumulators 4q + 2h + e of this thread sit at row warp*16 + lane/4 + 8h
  // and column 8q + 2*(lane%4) + e of the warpgroup's 64 x 80 tile (acc_row,
  // acc_col): two adjacent columns per (q, h), stored as one float2.
  auto epilogue = [&](const Acc& acc, int tile) {
    const int rb = (tile / ncol) * TR + (MAT_LEFT ? wg * TM : 0) + acc_row(0, warp, lane);
    const int cb = (tile % ncol) * TC + (MAT_LEFT ? 0 : wg * TN) + acc_col(0, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rb + 8 * h;
      if (r >= W) continue;
      const RowWeight rw = WEIGHT ? row_weight(wt, r) : RowWeight{};
      float* yre = dst.re + (size_t)r * dst.pitch;
      float* yim = dst.im + (size_t)r * dst.pitch;
#pragma unroll
      for (int q = 0; q < ACC / 4; ++q) {
        const int c = cb + 8 * q;
        float2 v0 = gauss_out(acc, 4 * q + 2 * h), v1 = gauss_out(acc, 4 * q + 2 * h + 1);
        if (WEIGHT) {
          const float w0 = weight_at(wt, rw, c), w1 = weight_at(wt, rw, c + 1);
          v0.x *= w0;
          v0.y *= w0;
          v1.x *= w1;
          v1.y *= w1;
        }
        if (dst.vec && c + 1 < D) {
          *reinterpret_cast<float2*>(yre + c) = make_float2(v0.x, v1.x);
          *reinterpret_cast<float2*>(yim + c) = make_float2(v0.y, v1.y);
        } else {
          if (c < D) {
            yre[c] = v0.x;
            yim[c] = v0.y;
          }
          if (c + 1 < D) {
            yre[c + 1] = v1.x;
            yim[c + 1] = v1.y;
          }
        }
      }
    }
  };

  Acc acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    PROFILE_STAMP(t0);
    cp_async_wait<AHEAD - 1>();  // this thread's 4-byte copies of stage s
    mbar_wait(bars + (g0 + s) % STAGES, ((g0 + s) / STAGES) & 1);  // the tensor copies
    __syncthreads();  // everyone's; stage s-2's wgmma are done (its slot is free)
    PROFILE_STAMP(t1);
    issue(s + AHEAD);
    PROFILE_STAMP(t2);
    convert(s);
    fence_async_smem();
    PROFILE_STAMP(t3);
    __syncthreads();
    PROFILE_STAMP(t4);
    const uint8_t* md = mat_ring + ((g0 + s) % STAGES) * S::MAT;
    const uint8_t* op = ops + (s & 1) * S::OP;
    if (MAT_LEFT) {  // this warpgroup's 64 matrix rows, the shared data tile
      gauss_step<P, A_STEP, B_STEP>(acc, make_desc(md + wg * A_TILE_BYTES), make_desc(op));
    } else {  // the shared data tile, this warpgroup's 80 matrix columns
      gauss_step<P, A_STEP, B_STEP>(acc, make_desc(op), make_desc(md + wg * B_TILE_BYTES));
    }
    if (s % nk == nk - 1) {
      wgmma_wait<0>();
      acc.fence();
      PROFILE_STAMP(t5);
      epilogue(acc, s / nk);
      acc.zero();
      PROFILE_STAMP(t6);
      PROFILE_ADD(4, t5 - t4);
      PROFILE_ADD(5, t6 - t5);
    } else {
      wgmma_wait<1>();
      PROFILE_STAMP(t5);
      PROFILE_ADD(4, t5 - t4);
    }
    PROFILE_ADD(0, t1 - t0);
    PROFILE_ADD(1, t2 - t1);
    PROFILE_ADD(2, t3 - t2);
    PROFILE_ADD(3, t4 - t3);
    PROFILE_ADD(6, 1);
  }
  cp_async_wait<0>();
  // the next pass reads what this one wrote with tensor copies (async proxy)
  fence_proxy_async();
  return g0 + total;
}

// Sequential polar point writes into this CTA's plane (one thread).
__device__ void point_writes(const Params& p, int c, int hh, const Dst& y) {
  for (int s = 0; s < p.n_stages; ++s) {
    const size_t sc = (size_t)s * p.N + c;
    const int* loc = p.locs + sc * 3;
    if (loc[0] != hh || loc[1] < 0 || loc[1] >= p.W || loc[2] < 0 || loc[2] >= p.D)
      continue;
    const size_t e = (size_t)loc[1] * y.pitch + loc[2];
    const float raw_re = y.re[e], raw_im = y.im[e];
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
    y.re[e] = raw_re + d_re;
    y.im[e] = raw_im + d_im;
  }
  fence_proxy_async();
}

template <int P>
__global__ void __launch_bounds__(NT, 1) fused_plane_kernel(const __grid_constant__ Params p,
                                                            const __grid_constant__ Maps m) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(reinterpret_cast<uint64_t*>(smem) + i, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int plane = blockIdx.x;
  const int c = plane / p.Hh, hh = plane % p.Hh;
  const int W = p.W, D = p.D, Dp = p.Dp;
  const size_t po = (size_t)plane * W * D;
  const size_t ps = (size_t)plane * W * Dp;
  const size_t nsc = (size_t)p.N * p.Hh * W * Dp;
  const bool inplace = D <= DC;

  const int row0 = plane * W;
  const Src x{p.k_re + po, p.k_im + po, D, p.in_vec, &m.x_re, &m.x_im, row0};
  const Dst a{p.scratch + ps, p.scratch + nsc + ps, Dp, 1};
  const Dst b = inplace ? a : Dst{p.scratch + 2 * nsc + ps, p.scratch + 3 * nsc + ps, Dp, 1};
  // scratch A as a W pass (aw) and a D pass (ad) reads it; scratch B as a D pass
  const Src aw{a.re, a.im, Dp, 1, &m.aw_re, &m.aw_im, row0};
  const Src ad{a.re, a.im, Dp, 1, &m.ad_re, &m.ad_im, row0};
  const Src bd = inplace ? ad : Src{b.re, b.im, Dp, 1, &m.bd_re, &m.bd_im, row0};
  const Dst out{p.o_re + po, p.o_im + po, D, p.out_vec};

  const float* wp = p.wparams + (size_t)c * 5;
  const Weight wt{p.H, W, D, hh, p.flags, wp[0], wp[1], wp[2], wp[3], wp[4]};

  int g = gauss_pass<P, true, false>(smem, 0, x, a, &m.wf, W, D, wt);
  __syncthreads();
  if (p.flags & (F_GIBBS | F_DISK | F_WRAP)) {
    g = gauss_pass<P, false, true>(smem, g, ad, b, &m.df, W, D, wt);
  } else {
    g = gauss_pass<P, false, false>(smem, g, ad, b, &m.df, W, D, wt);
  }
  __syncthreads();
  if (threadIdx.x == 0) point_writes(p, c, hh, b);
  __syncthreads();
  g = gauss_pass<P, false, false>(smem, g, bd, a, &m.di, W, D, wt);
  __syncthreads();
  gauss_pass<P, true, false>(smem, g, aw, out, &m.wi, W, D, wt);
}

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// A float32 plane stack (rows of `cols` valid floats, `pitch` apart) boxed
// box_cols x box_rows; columns past `cols` read as zeros.
bool data_map(CUtensorMap* m, const float* base, int cols, long long rows, int pitch,
              int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_fn()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A matrix section of 3P parts of Kp x Rp bf16 each, as 256-element units,
// boxed as the `mrows` rows of one 16-deep chunk of every part.
bool mat_map(CUtensorMap* m, const __nv_bfloat16* base, int parts, int Kp, int Rp, int mrows) {
  const cuuint64_t dims[3] = {256, (cuuint64_t)Kp * Rp / 256, (cuuint64_t)parts};
  const cuuint64_t strides[2] = {512, (cuuint64_t)Kp * Rp * 2};
  const cuuint32_t box[3] = {256, (cuuint32_t)(mrows * BK / 256), (cuuint32_t)parts};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_fn()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                     const_cast<__nv_bfloat16*>(base), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P>
cudaError_t launch(const Params& p, cudaStream_t st) {
  if (!encode_fn()) return cudaErrorNotSupported;
  const long long rows = (long long)p.N * p.Hh * p.W;
  const size_t nsc = (size_t)rows * p.Dp;
  const float* a_re = p.scratch;
  const float* a_im = a_re + nsc;
  const bool inplace = p.D <= DC;
  const float* b_re = inplace ? a_re : a_re + 2 * nsc;
  const float* b_im = inplace ? a_im : a_re + 3 * nsc;
  const int Kw = round_up(p.W, BK), Rw = round_up(p.W, WR);
  const int Kd = round_up(p.D, BK), Rd = round_up(p.D, DC);
  const __nv_bfloat16* wf = p.mats;
  const __nv_bfloat16* df = wf + (size_t)3 * P * Kw * Rw;
  const __nv_bfloat16* wi = df + (size_t)3 * P * Kd * Rd;
  const __nv_bfloat16* di = wi + (size_t)3 * P * Kw * Rw;
  Maps m = {};
  bool ok = (!p.in_vec || (data_map(&m.x_re, p.k_re, p.D, rows, p.D, WC, BK) &&
                           data_map(&m.x_im, p.k_im, p.D, rows, p.D, WC, BK))) &&
            data_map(&m.ad_re, a_re, p.D, rows, p.Dp, BK, DR) &&
            data_map(&m.ad_im, a_im, p.D, rows, p.Dp, BK, DR) &&
            data_map(&m.aw_re, a_re, p.D, rows, p.Dp, WC, BK) &&
            data_map(&m.aw_im, a_im, p.D, rows, p.Dp, WC, BK) &&
            data_map(&m.bd_re, b_re, p.D, rows, p.Dp, BK, DR) &&
            data_map(&m.bd_im, b_im, p.D, rows, p.Dp, BK, DR) &&
            mat_map(&m.wf, wf, 3 * P, Kw, Rw, WR) && mat_map(&m.df, df, 3 * P, Kd, Rd, DC) &&
            mat_map(&m.wi, wi, 3 * P, Kw, Rw, WR) && mat_map(&m.di, di, 3 * P, Kd, Rd, DC);
  if (!ok) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<P>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_plane_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  fused_plane_kernel<P><<<dim3((unsigned)p.N * (unsigned)p.Hh), NT, bytes, st>>>(p, m);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the kernel needs: (re, im) planes with rows padded to a
// multiple of 4 floats, one buffer when a tile spans all of D, else two.
extern "C" long long mvtb_fused_plane_scratch_floats(int N, int Hh, int W, int D) {
  const long long per = 2LL * N * Hh * W * round_up(D, 4);
  return D <= DC ? per : 2 * per;
}

extern "C" int mvtb_fused_plane(
    const float* k_re, const float* k_im, float* o_re, float* o_im,
    float* scratch, const void* mats, const float* wparams,
    const int* locs, const float* vals, const float* gates, const float* conjs,
    const float* scales, int N, int Hh, int H, int W, int D, int n_stages,
    int flags, int fast, void* stream) {
  const int in_vec = D % 4 == 0 && (uintptr_t)k_re % 16 == 0 && (uintptr_t)k_im % 16 == 0;
  const int out_vec = D % 2 == 0 && (uintptr_t)o_re % 8 == 0 && (uintptr_t)o_im % 8 == 0;
  Params p{k_re, k_im, o_re, o_im, scratch,
           static_cast<const __nv_bfloat16*>(mats), wparams, locs,
           vals, gates, conjs, scales, N, Hh, H, W, D, round_up(D, 4),
           n_stages, flags, in_vec, out_vec};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(fast ? launch<1>(p, st) : launch<2>(p, st));
}

extern "C" const char* mvtb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#ifdef MVTB_PLANE_PROFILE
// Copies the counters to `host` ([8192][2][8] uint64) and zeroes them.
extern "C" int mvtb_plane_profile_take(void* host) {
  static unsigned long long zero[8192][2][8];
  cudaError_t err = cudaMemcpyFromSymbol(host, g_plane_profile, sizeof(g_plane_profile));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_plane_profile, zero, sizeof(zero));
  return (int)err;
}
#endif
