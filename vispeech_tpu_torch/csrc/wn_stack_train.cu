// Trainable dilation-1 WaveNet stack: forward and backward, f32 accumulators.
//
// Replaces vispeech_tpu/ops/pallas/wn_stack_train.py::wn_stack_train (custom
// VJP, bodies _fwd_kernel and _bwd_kernel).  The TPU kernels keep one batch
// item's [T, C] state in VMEM and walk the layers as a sequential grid axis.
// Here each layer is its own launch over tiles of frames with a halo of k//2
// frames, so any depth fits and no halo is recomputed:
//
//   forward, layer l:   a  = cond[b, l] + Σ_tap x_l[t + tap − k//2] · W_in[l, tap]
//                       z  = tanh(a[:C]) · sigmoid(a[C:])
//                       rs = z · W_rs[l] + b_rs[l]
//                       l < L−1: x_{l+1} = (x_l + rs[:C]) · m,  skip += rs[C:]
//                       l = L−1: out = (skip + rs[:C]) · m
//   xs[b, l] = x_l is kept for the backward.
//
//   backward, layer l (reverse order), g = dout · m:
//     bwd_act: rematerialize a from xs; d_rs = [l = L−1 ? g : dx_{l+1}·m |
//              l = L−1 ? 0 : g]; dz = d_rs · W_rs[l]ᵀ;
//              dacts = [dz·σ·(1−tanh²) | dz·tanh·σ·(1−σ)]; per-tile column
//              sums of d_rs (→ db_rs) and of dacts (→ dcond)
//     bwd_dx:  dx_l = Σ_tap dacts[t − tap + k//2] · W_in[l, tap]ᵀ
//                     + (l < L−1 ? dx_{l+1}·m : 0)
//     wgrad:   dW_in[l, tap] = Σ_rows x_l[t + tap − k//2]ᵀ · dacts,
//              dW_rs[l] = Σ_rows zᵀ · d_rs, as per-split partial sums
//   The wrapper sums every partial in a fixed order: no atomics, so the
//   gradients are the same bit for bit from run to run.
//
// BF16 rounds every matmul operand to bf16 (x_l, z, d_rs, dacts and the
// weights); accumulators, the gate, the residual carry, the skip sum and the
// column sums stay f32, as the TPU kernel's bf16_compute does.
//
// The f32 forward and the f32 backward: every product on mma.sync m16n8k8
// TF32 in the 3-pass split a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi (kernel
// B's), which keeps f32 accuracy.  A block's 8 warps split its
// BM = 32 frames in two m16 tiles and the output columns in 4 groups; warp
// (m, n) owns n8 tiles n, n+4, ... of each C-wide half, so the tanh and
// sigmoid halves of a gate column, and dz of the same column, land in the
// same thread's registers.  Shared rows are padded (C + 4, 2C + 4, N + 8
// floats) so fragment loads hit 32 banks.
//
// The bf16 backward (namespace wg) runs every product on wgmma bf16 with f32
// accumulators in registers.  What bounds it: at B = 12, T = 1024, C = 192,
// k = 5 a layer is 30.8 GFLOP (31 µs at the bf16 peak) against ~60 MB of
// intermediates and their reads; bwd_act and bwd_dx also stream the layer's
// weights (0.9 and 0.7 MB) through every block of 128 frames.  Its design:
// - z, d_rs, dacts and a bf16 copy of x_l are kept as [B][ch/8][Tp][8]
//   columns of 16-byte rows with zero halo rows, so the 8 rows from any
//   row on, shifted by any tap, are one core matrix of wgmma, K-major for
//   the products over channels and MN-major for the weight gradients,
//   whose K is the rows.
// - bwd_act and bwd_dx: a block owns TR = 128 frames, one 64-row tile per
//   consumer warpgroup; the weights come prepared once a call
//   (ops/kernels/wn_stack_train.py::prepare_bwd_weights) as core-matrix k
//   blocks that a producer warp streams by bulk copies into an mbarrier
//   ring.  bwd_act walks the three 64-column chunks of C: the gate's 64
//   tanh and 64 sigmoid columns in one m64n128k16 product so that both
//   halves of a column meet in one thread, dz (m64n64k16) beside them, and
//   z, dacts and their column sums in registers; three loader warps build
//   d_rs while the gate's products run.  bwd_dx: m64n192k16 over k·2C.
// - wgrad: the k + 1 products (a tap each, and dW_rs) three to a block, one
//   consumer warpgroup each (m64n128k16, both operands MN-major), 64 rows a
//   stage copied by a loader warpgroup with 16-byte cp.async into an
//   8-stage ring, over fixed row splits.
// - ptxas serializes every wgmma of a kernel that branches divergently
//   between two of them or moves their accumulators: the warpgroup index
//   goes through a shuffle, ring arrivals are predicated inside their asm,
//   and the gate's column sums are stored under no branch.
//
// The bf16 forward (namespace wf) runs on wgmma bf16 too, one launch a
// layer, every layer of a call in one library call.  What bounds it: at
// B = 12, T = 1024, k = 5 a layer is 10.9 GFLOP (11 µs at the bf16 peak)
// against ~38 MB of f32 x_l, x_{l+1} and skip sums read and written (11 µs
// at 3.35 TB/s); every block of 128 frames also streams the layer's 0.88 MB
// of bf16 weights from L2.  Its design is bwd_act's: a block owns 128
// frames of one batch item, one 64-row tile per warpgroup, x_l's window in
// bf16 in shared memory; the weights come prepared once a call
// (ops/kernels/wn_stack_train.py::prepare_fwd_weights) as core-matrix k
// blocks that warp 0 streams by bulk copies into an mbarrier ring.  Per
// 64-column chunk of C the gate's 64 tanh and 64 sigmoid columns are one
// m64n128k16 product, so z of a column lands in one thread, and goes in
// bf16 to a shared z tile; then rs = z·W_rs as two m64n192k16 halves
// (residual, then skip: 2C columns of f32 accumulators do not fit beside
// the rest), each with its epilogue.  A block runs its phases one after
// another, so what is not a product is on the critical path: the epilogue's
// f32 operand (x_l, or the skip sum) arrives by cp.async into shared memory
// while the half's products run, and tanh and sigmoid take one special
// function instruction each.  Stores past T are predicated inside their
// asm, so no branch sits between the two halves' products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 192;
constexpr int C2 = 2 * C;
constexpr int LDX = C + 4;       // padded shared row of C
constexpr int LDD = C2 + 4;      // padded shared row of 2C
constexpr int BM = 32;           // frames per block: two m16 tiles
constexpr int THREADS = 256;     // 8 warps
constexpr int KC = 32;           // depth of one staged weight chunk
constexpr int HALF_TILES = C / 8;  // n8 tiles in C columns (24)
constexpr int NJ1 = HALF_TILES / 4;  // n8 tiles a warp owns over C (6)
constexpr int NJ2 = 2 * NJ1;         // ... over 2C (12)
constexpr int MAXPAD = 3;        // k ≤ 7
constexpr int WT = 64;           // wgrad output tile
constexpr int LDW = WT + 8;      // padded wgrad staging row
constexpr int RC = 64;           // wgrad rows per staged chunk

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// v as TF32 parts: exact in one part for a bf16 value, hi + lo otherwise
template <bool BF16>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (BF16) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
    const float rest = v - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool BF16>
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], float b0f, float b1f) {
  uint32_t bh0, bl0, bh1, bl1;
  split<BF16>(b0f, bh0, bl0);
  split<BF16>(b1f, bh1, bl1);
  if (!BF16) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

struct Frag {  // this thread's place in its warp's tiles
  int g, tq, mt, ng;
  __device__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    tq = lane & 3;
    mt = warp & 1;
    ng = warp >> 1;
  }
  // the warp's j-th n8 tile: ng + 4j in the first C columns, then the same
  // tiles of the second C columns
  __device__ int tile(int j) const { return (j / NJ1) * HALF_TILES + ng + 4 * (j % NJ1); }
  __device__ int col(int j, int e) const { return 8 * tile(j) + 2 * tq + (e & 1); }
  __device__ int row(int e) const { return 16 * mt + g + 8 * (e >> 1); }
};

// acc[j] += A[block rows][0, K) · B[0, K)[tile(j) columns], N = 32·NJ.
// A: shared, already rounded, rows lda apart; B: global rows ldb apart
// (16-byte aligned), staged KC rows at a time through `bs` (rows N + 8
// apart, 16-byte aligned), rounded on the way.  K a multiple of KC.  Starts
// and ends with a block barrier.
template <int NJ, bool BF16>
__device__ __forceinline__ void gemm(float (&acc)[NJ][4], const float* A, int lda,
                                     const float* __restrict__ B, int ldb, int K, float* bs) {
  constexpr int N = 32 * NJ, LDB = N + 8;
  const Frag f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * N / 4; i += THREADS) {
      const int kk = i / (N / 4), n = 4 * (i - kk * (N / 4));
      float4 v = __ldg(reinterpret_cast<const float4*>(B + (size_t)(k0 + kk) * ldb + n));
      v.x = rnd<BF16>(v.x);
      v.y = rnd<BF16>(v.y);
      v.z = rnd<BF16>(v.z);
      v.w = rnd<BF16>(v.w);
      *reinterpret_cast<float4*>(bs + kk * LDB + n) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k8 = 0; k8 < KC; k8 += 8) {
      const float* ar = A + (16 * f.mt + f.g) * lda + k0 + k8 + f.tq;
      uint32_t ah[4], al[4];
      split<BF16>(ar[0], ah[0], al[0]);
      split<BF16>(ar[8 * lda], ah[1], al[1]);
      split<BF16>(ar[4], ah[2], al[2]);
      split<BF16>(ar[8 * lda + 4], ah[3], al[3]);
      const float* br = bs + (k8 + f.tq) * LDB + f.g;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = 8 * f.tile(j);
        mma_step<BF16>(acc[j], ah, al, br[n], br[4 * LDB + n]);
      }
    }
  }
  __syncthreads();
}

// The window of rows [t0 − pad, t0 + BM + pad) of a [T, width] slice into
// shared rows ld apart, rounded; zeros outside [0, T).
template <bool BF16>
__device__ __forceinline__ void load_window(float* dst, int ld, const float* __restrict__ src,
                                            int t0, int pad, int T, int width) {
  for (int i = threadIdx.x; i < (BM + 2 * pad) * width; i += THREADS) {
    const int r = i / width, c = i - r * width, t = t0 + r - pad;
    dst[r * ld + c] = (t >= 0 && t < T) ? rnd<BF16>(src[(size_t)t * width + c]) : 0.f;
  }
}

// acts of this block's rows: cond + Σ_tap window · W_in[tap]
template <bool BF16>
__device__ __forceinline__ void gate_acts(float (&acc)[NJ2][4], const float* xw,
                                          const float* __restrict__ cl,
                                          const float* __restrict__ w_in, int K, float* bs) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = cl[f.col(j, e)];
  for (int tap = 0; tap < K; ++tap)
    gemm<NJ2, BF16>(acc, xw + tap * LDX, LDX, w_in + (size_t)tap * C * C2, C2, C, bs);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
fwd_layer(float* __restrict__ xs, float* __restrict__ skip, float* __restrict__ out,
          const float* __restrict__ mask, const float* __restrict__ cond,
          const float* __restrict__ w_in, const float* __restrict__ w_rs,
          const float* __restrict__ b_rs, int T, int L, int l, int K) {
  extern __shared__ float smem[];
  float* xw = smem;                          // [BM + 2·pad][LDX]
  float* zs = xw + (BM + 2 * MAXPAD) * LDX;  // [BM][LDX]
  float* bs = zs + BM * LDX;                 // [KC][2C + 8]
  const Frag f;
  const int b = blockIdx.y, t0 = blockIdx.x * BM, pad = K / 2;
  const size_t layer = (size_t)T * C;
  const float* xl = xs + ((size_t)b * L + l) * layer;
  load_window<BF16>(xw, LDX, xl, t0, pad, T, C);

  float acc[NJ2][4];
  gate_acts<BF16>(acc, xw, cond + ((size_t)b * L + l) * C2, w_in, K, bs);
#pragma unroll
  for (int j = 0; j < NJ1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      zs[f.row(e) * LDX + f.col(j, e)] =
          rnd<BF16>(tanhf(acc[j][e]) * sigmoidf(acc[j + NJ1][e]));

#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = b_rs[f.col(j, e)];
  gemm<NJ2, BF16>(acc, zs, LDX, w_rs, C2, C, bs);

  float* xn = xs + ((size_t)b * L + l + 1) * layer;  // written only when l < L−1
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = t0 + f.row(e);
    if (t >= T) continue;
    const float m = mask[(size_t)b * T + t];
#pragma unroll
    for (int j = 0; j < NJ1; ++j) {
      const int c = f.col(j, e);
      const size_t o = ((size_t)b * T + t) * C + c;
      const float sk = l == 0 ? 0.f : skip[o];
      if (l < L - 1) {
        xn[(size_t)t * C + c] = (xl[(size_t)t * C + c] + acc[j][e]) * m;
        skip[o] = sk + acc[j + NJ1][e];
      } else {
        out[o] = (sk + acc[j][e]) * m;
      }
    }
  }
}

// Column sums of a [BM][LDD] shared tile over its first `rows` rows.
__device__ __forceinline__ void column_sums(const float* tile, float* dst) {
  for (int col = threadIdx.x; col < C2; col += THREADS) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += tile[r * LDD + col];
    dst[col] = s;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
bwd_act(const float* __restrict__ xs, const float* __restrict__ mask,
        const float* __restrict__ cond, const float* __restrict__ w_in,
        const float* __restrict__ w_rs_t, const float* __restrict__ dout,
        const float* __restrict__ dx_next, float* __restrict__ z, float* __restrict__ d_rs,
        float* __restrict__ dacts, float* __restrict__ part_dcond,
        float* __restrict__ part_db, int T, int L, int l, int K) {
  extern __shared__ float smem[];
  float* xw = smem;                          // [BM + 2·pad][LDX]
  float* ds = xw + (BM + 2 * MAXPAD) * LDX;  // [BM][LDD]: d_rs rows, then dacts rows
  float* bs = ds + BM * LDD;                 // [KC][2C + 8]
  const Frag f;
  const int b = blockIdx.y, t0 = blockIdx.x * BM, pad = K / 2;
  const bool last = l == L - 1;
  const size_t tile = (size_t)b * gridDim.x + blockIdx.x;
  load_window<BF16>(xw, LDX, xs + ((size_t)b * L + l) * T * C, t0, pad, T, C);

  float acc[NJ2][4];
  gate_acts<BF16>(acc, xw, cond + ((size_t)b * L + l) * C2, w_in, K, bs);
  float tv[NJ1][4], sv[NJ1][4];
#pragma unroll
  for (int j = 0; j < NJ1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tv[j][e] = tanhf(acc[j][e]);
      sv[j][e] = sigmoidf(acc[j + NJ1][e]);
      const int t = t0 + f.row(e);
      if (t < T) z[((size_t)b * T + t) * C + f.col(j, e)] = tv[j][e] * sv[j][e];
    }

  for (int i = threadIdx.x; i < BM * C; i += THREADS) {
    const int r = i / C, c = i - r * C, t = t0 + r;
    float dres = 0.f, dskip = 0.f;
    if (t < T) {
      const float m = mask[(size_t)b * T + t];
      const size_t o = ((size_t)b * T + t) * C + c;
      const float g = dout[o] * m;
      dres = last ? g : dx_next[o] * m;
      dskip = last ? 0.f : g;
      d_rs[((size_t)b * T + t) * C2 + c] = dres;
      d_rs[((size_t)b * T + t) * C2 + C + c] = dskip;
    }
    ds[r * LDD + c] = dres;
    ds[r * LDD + C + c] = dskip;
  }
  __syncthreads();
  column_sums(ds, part_db + tile * C2);
  if (BF16) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * C2; i += THREADS) {
      const int r = i / C2, c = i - r * C2;
      ds[r * LDD + c] = rnd<BF16>(ds[r * LDD + c]);
    }
  }

  float dz[NJ1][4];
#pragma unroll
  for (int j = 0; j < NJ1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dz[j][e] = 0.f;
  gemm<NJ1, BF16>(dz, ds, LDD, w_rs_t, C, C2, bs);   // ends with a barrier: ds is free

#pragma unroll
  for (int j = 0; j < NJ1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float tt = tv[j][e], ss = sv[j][e];
      const int r = f.row(e), c = f.col(j, e);
      ds[r * LDD + c] = dz[j][e] * ss * (1.f - tt * tt);
      ds[r * LDD + C + c] = dz[j][e] * tt * ss * (1.f - ss);
    }
  __syncthreads();
  // rows past T hold zeros: their d_rs, so their dz, was zero
  for (int i = threadIdx.x; i < BM * C2; i += THREADS) {
    const int r = i / C2, c = i - r * C2, t = t0 + r;
    if (t < T) dacts[((size_t)b * T + t) * C2 + c] = ds[r * LDD + c];
  }
  column_sums(ds, part_dcond + tile * C2);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
bwd_dx(const float* __restrict__ dacts, const float* __restrict__ w_in_t,
       const float* __restrict__ dx_next, const float* __restrict__ mask,
       float* __restrict__ dx, int T, int K, int last) {
  extern __shared__ float smem[];
  float* dw = smem;                          // [BM + 2·pad][LDD] dacts window
  float* bs = dw + (BM + 2 * MAXPAD) * LDD;  // [KC][C + 8]
  const Frag f;
  const int b = blockIdx.y, t0 = blockIdx.x * BM, pad = K / 2;
  load_window<BF16>(dw, LDD, dacts + (size_t)b * T * C2, t0, pad, T, C2);

  float acc[NJ1][4];
#pragma unroll
  for (int j = 0; j < NJ1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // acts[t] read x[t + tap − pad], so dx[t] collects dacts[t − tap + pad],
  // window row r + 2·pad − tap
  for (int tap = 0; tap < K; ++tap)
    gemm<NJ1, BF16>(acc, dw + (2 * pad - tap) * LDD, LDD, w_in_t + (size_t)tap * C2 * C, C,
                    C2, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = t0 + f.row(e);
    if (t >= T) continue;
    const float m = mask[(size_t)b * T + t];
#pragma unroll
    for (int j = 0; j < NJ1; ++j) {
      const size_t o = ((size_t)b * T + t) * C + f.col(j, e);
      dx[o] = last ? acc[j][e] : acc[j][e] + dx_next[o] * m;
    }
  }
}

// out[s][m][n] = Σ_{rows of split s} P(row, m) · Q[row][n], rows = (b, t);
// P(row, tap·Cp + c) = P[b, t + tap − taps//2, c], zero outside [0, T).
// Block: a 64 × 64 output tile, inside one tap (Cp is a multiple of 64), so
// each staged row of P and of Q is 64 contiguous floats; warp w owns m16
// tile w & 3 and the n8 tiles (w >> 2) + 2j.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
wgrad(const float* __restrict__ P, const float* __restrict__ Q, float* __restrict__ out,
      int p_bstride, int taps, int Cp, int N, int B, int T, int rows_per_split,
      int out_sstride) {
  __shared__ float ps[RC * LDW];
  __shared__ float qs[RC * LDW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, mt = warp & 3, nh = warp >> 2;
  const int m0 = blockIdx.x * WT, n0 = blockIdx.y * WT, s = blockIdx.z;
  const int shift = m0 / Cp - taps / 2, c0 = m0 % Cp;
  const int row0 = s * rows_per_split, row1 = min(B * T, row0 + rows_per_split);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int base = row0; base < row1; base += RC) {
    __syncthreads();
    for (int i = threadIdx.x; i < RC * WT / 4; i += THREADS) {
      const int rr = i / (WT / 4), mm = 4 * (i - rr * (WT / 4)), row = base + rr;
      float4 pv = make_float4(0.f, 0.f, 0.f, 0.f), qv = pv;
      if (row < row1) {
        const int b = row / T, t = row - b * T, tt = t + shift;
        if (tt >= 0 && tt < T)
          pv = __ldg(reinterpret_cast<const float4*>(
              P + (size_t)b * p_bstride + (size_t)tt * Cp + c0 + mm));
        qv = __ldg(reinterpret_cast<const float4*>(Q + (size_t)row * N + n0 + mm));
      }
      float* pd = ps + rr * LDW + mm;
      float* qd = qs + rr * LDW + mm;
      pd[0] = rnd<BF16>(pv.x); pd[1] = rnd<BF16>(pv.y); pd[2] = rnd<BF16>(pv.z);
      pd[3] = rnd<BF16>(pv.w);
      qd[0] = rnd<BF16>(qv.x); qd[1] = rnd<BF16>(qv.y); qd[2] = rnd<BF16>(qv.z);
      qd[3] = rnd<BF16>(qv.w);
    }
    __syncthreads();
#pragma unroll
    for (int k8 = 0; k8 < RC; k8 += 8) {
      // A = Pᵀ: A[m][k] = ps[k][m]
      const float* ar = ps + (k8 + tq) * LDW + 16 * mt + g;
      uint32_t ah[4], al[4];
      split<BF16>(ar[0], ah[0], al[0]);
      split<BF16>(ar[8], ah[1], al[1]);
      split<BF16>(ar[4 * LDW], ah[2], al[2]);
      split<BF16>(ar[4 * LDW + 8], ah[3], al[3]);
      const float* br = qs + (k8 + tq) * LDW + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * (nh + 2 * j);
        mma_step<BF16>(acc[j], ah, al, br[n], br[4 * LDW + n]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 16 * mt + g + 8 * (e >> 1);
      const int n = n0 + 8 * (nh + 2 * j) + 2 * tq + (e & 1);
      out[(size_t)s * out_sstride + (size_t)m * N + n] = acc[j][e];
    }
}

const size_t FWD_SMEM = ((size_t)(BM + 2 * MAXPAD) * LDX + BM * LDX + KC * (C2 + 8)) * sizeof(float);
const size_t ACT_SMEM = ((size_t)(BM + 2 * MAXPAD) * LDX + BM * LDD + KC * (C2 + 8)) * sizeof(float);
const size_t DX_SMEM = ((size_t)(BM + 2 * MAXPAD) * LDD + KC * (C + 8)) * sizeof(float);

bool bad_k(int K) { return K % 2 == 0 || K / 2 > MAXPAD; }

// ------------------------------------------------------ bf16 backward, wgmma
//
// The intermediates of a layer (x_l as read, z, d_rs, dacts) are kept in
// bf16 as [B][channels/8][Tp][8]: each 8-channel chunk of a batch item is a
// column of Tp rows of 16 bytes, so the 8 rows from any row on are one
// contiguous core matrix of wgmma, whatever a tap's row shift, and one bulk
// copy moves a chunk's rows.  Rows [HP, HP + T) hold t = 0 .. T−1, the rows
// up to a whole number of TR-row tiles are written as zeros, and the HP
// halo rows on each side stay zero (the wrapper allocates with zeros).

namespace wg {

constexpr int TR = 128;              // rows a block owns: one 64-row tile per warpgroup
constexpr int NCT = 256;             // consumer threads (two warpgroups)
constexpr int NT = NCT + 32;         // and the producer warp
constexpr int HP = 8;                // zero halo rows on each side of a tiled intermediate
constexpr int PAD = 2;               // k ≤ 5
constexpr int XWR = TR + 2 * PAD + 1;  // rows per chunk of a shared window (odd: the
constexpr int DSR = TR + 1;            // stores across chunks hit distinct banks)
constexpr int ACT_SLOT = 8192;       // bf16 per ring slot of bwd_act: 16 KB
constexpr int ACT_NS = 4;
constexpr int ACT_LOADERS = 96;      // bwd_act's loader threads: 3 warps
constexpr int ACT_NT = NT + ACT_LOADERS;
constexpr int DX_SLOT = 64 * C;      // a 64-deep k block of W_inᵀ: 24 KB
constexpr int DX_NS = 4;
constexpr int RK = 64;               // wgrad: rows a stage carries
constexpr int PWR = RK + 2 * PAD;    // wgrad: rows per chunk of the P window
constexpr int WG_STAGES = 8;         // wgrad ring: 8 stages of P, Q (4 of P, Q, Z, D)
constexpr int WGRAD_SPLITS = 7;      // wgrad row splits: 2 · 9 · 7 = 126 blocks at k = 5
constexpr int TAPG = 3;              // wgrad: products a block takes, one warpgroup each
constexpr int WG_NT = TAPG * 128 + 128;   // and a loader warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the consumers' barrier (named barrier 1): the producer warp never joins it
__device__ __forceinline__ void consumer_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// an arrival by the threads where `pred` holds, predicated inside the asm:
// a branch around it would be a divergent path between two wgmma, and
// ptxas serializes every wgmma of a kernel that has one
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile("{\n.reg .pred p;\n.reg .b64 state;\nsetp.ne.b32 p, %1, 0;\n"
               "@p mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               ::"r"(smem_addr(bar)), "r"((int)pred) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
// one bulk copy (the tensor memory accelerator) global → shared, its bytes
// completing on bar (announced there by mbar_expect)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// × 16 contiguous bytes; lbo bytes between core matrices along K, sbo along
// M or N (for a K-major operand the 16 bytes run along K, for an MN-major
// one along M or N)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// the compiler keeps the accumulators' reads and writes on their side of
// the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 rows × n columns, f32) += A (64 × 16) · B (16 × n), bf16, both from
// shared memory by descriptor; the _mn form reads A and B MN-major
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128_mn(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


__device__ __forceinline__ float sigmoid_fast(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, __expf(2.f * v) + 1.f);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}
__device__ __forceinline__ void load8(float (&v)[8], const float* __restrict__ p, float scale) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x * scale; v[1] = a.y * scale; v[2] = a.z * scale; v[3] = a.w * scale;
  v[4] = c.x * scale; v[5] = c.y * scale; v[6] = c.z * scale; v[7] = c.w * scale;
}

// element (b, channel c, row t) of a tiled intermediate with `chunks` 8-channel chunks
__device__ __forceinline__ size_t tiled(int b, int chunks, int c, int t, int Tp) {
  return (((size_t)b * chunks + (c >> 3)) * Tp + HP + t) * 8 + (c & 7);
}

constexpr int RED = 3 * 8 * 128 + 128;   // bwd_act's column-sum scratch, floats

// bwd_act for one layer: a block owns TR rows of one batch item and walks the
// three 64-column chunks of C.  Per chunk, warpgroup wg's 64-row tile gets
//   a  = Σ_tap x_l window (shifted by the tap) · W_in[tap][:, tanh and sigmoid columns]
//        (wgmma m64n128k16: 64 tanh columns, then the same 64 sigmoid columns)
//   dz = d_rs · W_rs[:, chunk]ᵀ (m64n64k16 over 2C)
// and the gate, z and dacts in registers; the weights arrive prepared, k
// block by k block, through the ring.
__global__ void __launch_bounds__(ACT_NT, 1)
act_kernel(const float* __restrict__ xs, const float* __restrict__ mask,
           const float* __restrict__ cond, const __nv_bfloat16* __restrict__ w,
           const float* __restrict__ dout, const float* __restrict__ dx_next,
           __nv_bfloat16* __restrict__ xb, __nv_bfloat16* __restrict__ z,
           __nv_bfloat16* __restrict__ d_rs, __nv_bfloat16* __restrict__ dacts,
           float* __restrict__ part_dcond, float* __restrict__ part_db, int T, int L, int l,
           int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem);         // [C/8][XWR][8]
  __nv_bfloat16* ds = xw + (C / 8) * XWR * 8;                         // [2C/8][DSR][8]
  __nv_bfloat16* slots = ds + (C2 / 8) * DSR * 8;                     // the weight ring
  float* red = reinterpret_cast<float*>(slots + ACT_NS * ACT_SLOT);   // column sums
  uint64_t* full = reinterpret_cast<uint64_t*>(red + RED);
  uint64_t* empty = full + ACT_NS;
  uint64_t* dready = empty + ACT_NS;   // d_rs is in ds
  const int tid = threadIdx.x, pad = K / 2, b = blockIdx.y, tile = blockIdx.x, t0 = tile * TR;
  const int Tp = gridDim.x * TR + 2 * HP;
  const int per_chunk = 3 * K + 3;   // ring loads a chunk: K taps × 3 k blocks, 3 of W_rsᵀ
  if (tid == 0) {
    for (int s = 0; s < ACT_NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NCT / 32);
    }
    mbar_init(dready, ACT_LOADERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (warp_id == NCT / 32) {
    // the producer warp: every k block of the three chunks, ACT_NS ahead
    if (tid == NCT) {
      for (int i = 0; i < 3 * per_chunk; ++i) {
        const int slot = i % ACT_NS;
        if (i >= ACT_NS) mbar_wait(empty + slot, ((i / ACT_NS) - 1) & 1);
        mbar_expect(full + slot, ACT_SLOT * 2);
        bulk_copy(slots + slot * ACT_SLOT, w + (size_t)i * ACT_SLOT, ACT_SLOT * 2, full + slot);
      }
    }
    return;
  }
  // x_l's window [t0 − pad, t0 + TR + pad) in bf16, zeros outside [0, T), by
  // the consumers and the loader warps; its own rows also to the tiled copy
  // the weight gradient reads
  const float* xl = xs + ((size_t)b * L + l) * T * C;
  const int li = tid < NCT ? tid : tid - 32;   // 0 .. NCT + ACT_LOADERS − 1
  // (XU pieces a thread in flight at once: the window comes from device memory)
  constexpr int XU = 4, NL = NCT + ACT_LOADERS;
  for (int base = li; base < (TR + 2 * pad) * (C / 8); base += XU * NL) {
    float v[XU][8];
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int i = base + u * NL, r = i / (C / 8), t = t0 - pad + r;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
      if (r < TR + 2 * pad && t >= 0 && t < T)
        load8(v[u], xl + (size_t)t * C + 8 * (i % (C / 8)), 1.f);
    }
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int i = base + u * NL, j = i % (C / 8), r = i / (C / 8), t = t0 - pad + r;
      if (r >= TR + 2 * pad) break;
      const uint4 pk = pack8(v[u]);
      *reinterpret_cast<uint4*>(xw + (j * XWR + r) * 8) = pk;
      if (r >= pad && r < pad + TR)
        *reinterpret_cast<uint4*>(xb + tiled(b, C / 8, 8 * j, t, Tp)) = pk;
    }
  }
  fence_async_smem();
  asm volatile("bar.sync 2, %0;\n" ::"n"(NCT + ACT_LOADERS) : "memory");
  if (warp_id > NCT / 32) {
    // the loader warps, while the consumers run the gate's products: d_rs =
    // [last ? g : dx_{l+1}·m | last ? 0 : g], g = dout·m, its f32 column sums
    // (→ db_rs), bf16 into shared memory (dz's A) and the tiled copy
    const int lt = tid - NCT - 32;
    const bool last = l == L - 1;
    const int j = lt % (C2 / 8), rg = lt / (C2 / 8);
    const float* src = j < C / 8 && !last ? dx_next : dout;
    const bool zero = j >= C / 8 && last;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int r = rg; r < TR; r += ACT_LOADERS / (C2 / 8)) {
      const int t = t0 + r;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (t < T && !zero)
        load8(v, src + ((size_t)b * T + t) * C + 8 * (j % (C / 8)), mask[(size_t)b * T + t]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] += v[e];
      const uint4 pk = pack8(v);
      *reinterpret_cast<uint4*>(ds + (j * DSR + r) * 8) = pk;
      *reinterpret_cast<uint4*>(d_rs + tiled(b, C2 / 8, 8 * j, t, Tp)) = pk;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[rg * C2 + 8 * j + e] = sum[e];
    asm volatile("bar.sync 3, %0;\n" ::"n"(ACT_LOADERS) : "memory");
    const size_t part = ((size_t)b * gridDim.x + tile) * C2;
    for (int col = lt; col < C2; col += ACT_LOADERS)
      part_db[part + col] = red[col] + red[C2 + col];
    fence_async_smem();
    mbar_arrive_if(dready, true);
    return;
  }

  // the warpgroup index through a shuffle, so the compiler knows it is the
  // same in every thread of a warp and the wgmma below sit on no divergent path
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const float* cl = cond + ((size_t)b * L + l) * C2;
  uint32_t it = 0;
  for (int jc = 0; jc < 3; ++jc) {
    float acc[64], dz[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dz[i] = 0.f;
    fence_acc(acc);
    fence_acc(dz);
    int prev = -1;
    // tap q / 3, input channels [64·(q % 3), +64): window row 64·wg + tap
    for (int q = 0; q < 3 * K; ++q, ++it) {
      const int slot = it % ACT_NS;
      mbar_wait(full + slot, (it / ACT_NS) & 1);
      const __nv_bfloat16* a = xw + (8 * (q % 3) * XWR + 64 * wg + q / 3) * 8;
      const __nv_bfloat16* bw = slots + slot * ACT_SLOT;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n128(acc, smem_desc(a + 2 * ks * XWR * 8, XWR * 16, 128),
                   smem_desc(bw + 2 * ks * 64, 128, 1024));
      wg_commit();
      // the k block before is done with its slot once at most this one is pending
      wg_wait<1>();
      mbar_arrive_if(empty + max(prev, 0), prev >= 0 && lane == 0);
      prev = slot;
    }
    // d_rs columns [128·kb, +128), once the loaders have written them
    mbar_wait(dready, 0);
    for (int kb = 0; kb < 3; ++kb, ++it) {
      const int slot = it % ACT_NS;
      mbar_wait(full + slot, (it / ACT_NS) & 1);
      const __nv_bfloat16* a = ds + (16 * kb * DSR + 64 * wg) * 8;
      const __nv_bfloat16* bw = slots + slot * ACT_SLOT;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_n64(dz, smem_desc(a + 2 * ks * DSR * 8, DSR * 16, 128),
                  smem_desc(bw + 2 * ks * 64, 128, 2048));
      wg_commit();
      wg_wait<1>();
      mbar_arrive_if(empty + prev, lane == 0);
      prev = slot;
    }
    wg_wait<0>();
    fence_acc(acc);
    fence_acc(dz);
    mbar_arrive_if(empty + prev, lane == 0);

    // the gate, z and dacts of this thread's rows and columns
    float s1[16], s2[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 64 * jc + 8 * i + 2 * tq;
      const float2 ct = *reinterpret_cast<const float2*>(cl + c);
      const float2 cs = *reinterpret_cast<const float2*>(cl + C + c);
      s1[2 * i] = s1[2 * i + 1] = s2[2 * i] = s2[2 * i + 1] = 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + 64 * wg + 16 * warp + g + 8 * hr;
        const float valid = t < T ? 1.f : 0.f;
        float zz[2], d1[2], d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float th = tanh_fast(acc[4 * i + 2 * hr + e] + (e ? ct.y : ct.x));
          const float sg = sigmoid_fast(acc[32 + 4 * i + 2 * hr + e] + (e ? cs.y : cs.x));
          const float d = dz[4 * i + 2 * hr + e];
          zz[e] = th * sg * valid;
          d1[e] = d * sg * (1.f - th * th);
          d2[e] = d * th * sg * (1.f - sg);
          s1[2 * i + e] += d1[e];
          s2[2 * i + e] += d2[e];
        }
        *reinterpret_cast<uint32_t*>(z + tiled(b, C / 8, c, t, Tp)) = pack2(zz[0], zz[1]);
        *reinterpret_cast<uint32_t*>(dacts + tiled(b, C2 / 8, c, t, Tp)) = pack2(d1[0], d1[1]);
        *reinterpret_cast<uint32_t*>(dacts + tiled(b, C2 / 8, C + c, t, Tp)) = pack2(d2[0], d2[1]);
      }
    }
    // column sums over the warp's 16 rows (lanes of one tq), then into
    // red[chunk][warp]; lanes other than g = 0 write to a spare row (a store
    // under no branch, so the wgmma of the next chunk sit on no divergent path)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], sh);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], sh);
      }
    float* row = red + (g == 0 ? (jc * 8 + (tid >> 5)) * 128 : 3 * 8 * 128);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        row[8 * i + 2 * tq + e] = s1[2 * i + e];
        row[64 + 8 * i + 2 * tq + e] = s2[2 * i + e];
      }
  }
  // dcond's per-tile partial: the 8 warps' sums in a fixed order
  consumer_sync(NCT);
  for (int col = tid; col < 3 * 128; col += NCT) {
    const int jc = col >> 7, cc = col & 127;
    float s = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) s += red[(jc * 8 + w8) * 128 + cc];
    part_dcond[((size_t)b * gridDim.x + tile) * C2 + (cc >> 6) * C + 64 * jc + (cc & 63)] = s;
  }
}

// bwd_dx for one layer: dx_l = Σ_tap dacts window (shifted) · W_in[tap]ᵀ
// (+ dx_{l+1}·m below the last layer).  The block's dacts window comes by
// 48 bulk copies, one per chunk, the prepared W_in[tap]ᵀ in 64-deep k blocks
// through the ring; wgmma m64n192k16 over 2C per tap.
__global__ void __launch_bounds__(NT, 1)
dx_kernel(const __nv_bfloat16* __restrict__ dacts, const __nv_bfloat16* __restrict__ w,
          const float* __restrict__ dx_next, const float* __restrict__ mask,
          float* __restrict__ dx, int T, int K, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* dw = reinterpret_cast<__nv_bfloat16*>(smem);   // [2C/8][XWR][8]
  __nv_bfloat16* slots = dw + (C2 / 8) * XWR * 8;
  uint64_t* win = reinterpret_cast<uint64_t*>(slots + DX_NS * DX_SLOT);
  uint64_t* full = win + 1;
  uint64_t* empty = full + DX_NS;
  const int tid = threadIdx.x, pad = K / 2, b = blockIdx.y, t0 = blockIdx.x * TR;
  const int Tp = gridDim.x * TR + 2 * HP;
  if (tid == 0) {
    mbar_init(win, 1);
    for (int s = 0; s < DX_NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NCT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (__shfl_sync(0xffffffffu, tid >> 5, 0) == NCT / 32) {
    if (tid == NCT) {
      const uint32_t rows = TR + 2 * pad;
      mbar_expect(win, (C2 / 8) * rows * 16);
      for (int j = 0; j < C2 / 8; ++j)
        bulk_copy(dw + j * XWR * 8, dacts + tiled(b, C2 / 8, 8 * j, t0 - pad, Tp), rows * 16, win);
      for (int i = 0; i < 6 * K; ++i) {
        const int slot = i % DX_NS;
        if (i >= DX_NS) mbar_wait(empty + slot, ((i / DX_NS) - 1) & 1);
        mbar_expect(full + slot, DX_SLOT * 2);
        bulk_copy(slots + slot * DX_SLOT, w + (size_t)i * DX_SLOT, DX_SLOT * 2, full + slot);
      }
    }
    return;
  }
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  mbar_wait(win, 0);
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  fence_acc(acc);
  int prev = -1;
  for (int q = 0; q < 6 * K; ++q) {
    const int slot = q % DX_NS;
    mbar_wait(full + slot, (q / DX_NS) & 1);
    // acts[t] read x[t + tap − pad], so dx[t] collects dacts[t − tap + pad]:
    // window row 64·wg + 2·pad − tap; dacts columns [64·(q % 6), +64)
    const __nv_bfloat16* a = dw + (8 * (q % 6) * XWR + 64 * wg + 2 * pad - q / 6) * 8;
    const __nv_bfloat16* bw = slots + slot * DX_SLOT;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n192(acc, smem_desc(a + 2 * ks * XWR * 8, XWR * 16, 128),
                 smem_desc(bw + 2 * ks * 64, 128, 1024));
    wg_commit();
    wg_wait<1>();
    mbar_arrive_if(empty + max(prev, 0), prev >= 0 && lane == 0);
    prev = slot;
  }
  wg_wait<0>();
  fence_acc(acc);
  mbar_arrive_if(empty + prev, lane == 0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = t0 + 64 * wg + 16 * warp + g + 8 * hr;
    if (t >= T) continue;
    const float m = last ? 0.f : mask[(size_t)b * T + t];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const size_t o = ((size_t)b * T + t) * C + 8 * i + 2 * tq;
      float2 v = make_float2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
      if (!last) {
        const float2 nx = *reinterpret_cast<const float2*>(dx_next + o);
        v.x += nx.x * m;
        v.y += nx.y * m;
      }
      *reinterpret_cast<float2*>(dx + o) = v;
    }
  }
}

// wgrad: the weight gradients of a layer as sums over row splits s,
//   out_in[s][tap·pch + c][n] = Σ_{rows of s} P[b, t + tap − taps/2, c] · Q[b, t, n]
//   out_rs[s][c][n]           = Σ_{rows of s} Z[b, t, c] · D[b, t, n]
// (P = x_l, Q = dacts, Z = z, D = d_rs, all tiled), rows taken RK at a time.
// The taps + 1 products go to blocks NWG at a time (at k = 5: taps 0–2, then
// taps 3–4 and dW_rs); a block owns 64 channels of P and Z and 128 of Q and
// D, one consumer warpgroup a product.  A loader warpgroup copies each
// stage (the P window with the taps' halo, Q rows, and Z, D rows where the
// block has dW_rs) by cp.async, 16 bytes a thread, into a ring of stages.
// Both operands are read MN-major: the K of the products is the rows, and
// the 8 rows of a chunk from any row on are one core matrix.  Fixed
// splits, summed by the wrapper in a fixed order.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// an arrival on bar once this thread's cp.async so far have landed
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__global__ void __launch_bounds__(WG_NT, 1)
wgrad_kernel(const __nv_bfloat16* __restrict__ P, const __nv_bfloat16* __restrict__ Q,
             const __nv_bfloat16* __restrict__ Z, const __nv_bfloat16* __restrict__ D,
             float* __restrict__ out_in, float* __restrict__ out_rs, int pch, int taps, int B,
             int n_rk, size_t in_sstride, size_t rs_sstride) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SP = 8 * PWR * 8, SQ = 16 * RK * 8, SZ = 8 * RK * 8;   // bf16 per part
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + WG_STAGES * (SP + SQ));
  uint64_t* empty = full + WG_STAGES;
  const int tid = threadIdx.x, pad = taps / 2, nc = pch / 64;
  const int v0 = TAPG * (blockIdx.x / nc), nv = min(TAPG, taps + 1 - v0);
  const bool has_rs = v0 + nv == taps + 1;
  // stages of P and Q, or of P, Q, Z and D: the same bytes in all
  const int stage = has_rs ? 2 * (SP + SQ) : SP + SQ, nst = has_rs ? WG_STAGES / 2 : WG_STAGES;
  const int c0 = (blockIdx.x % nc) * 64, n0 = blockIdx.y * 128, s = blockIdx.z;
  const int Tp = n_rk * RK + 2 * HP, items = B * n_rk;
  const int i0 = (int)((long long)s * items / WGRAD_SPLITS);
  const int n = (int)((long long)(s + 1) * items / WGRAD_SPLITS) - i0;
  if (tid == 0) {
    for (int k = 0; k < nst; ++k) {
      mbar_init(full + k, 128);
      mbar_init(empty + k, nv * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == TAPG) {
    // the loader warpgroup: thread lt copies row lt % 64 of every other
    // chunk, from chunk lt / 64 on (consecutive threads on consecutive rows),
    // and one row of the P window's halo where lt < 16·pad
    const int lt = tid - TAPG * 128, r = lt & 63, h = lt >> 6;
    const size_t pstep = (size_t)2 * Tp * 8, pb = (size_t)(pch / 8) * Tp * 8,
                 qb = (size_t)(C2 / 8) * Tp * 8;
    const __nv_bfloat16* pk = P + ((size_t)(c0 / 8 + h) * Tp + HP + r) * 8;
    const __nv_bfloat16* qk = Q + ((size_t)(n0 / 8 + h) * Tp + HP + r) * 8;
    const __nv_bfloat16* zk = Z + ((size_t)(c0 / 8 + h) * Tp + HP + r) * 8;
    const __nv_bfloat16* dk = D + ((size_t)(n0 / 8 + h) * Tp + HP + r) * 8;
    const bool halo = lt < 16 * pad;
    const int hc = halo ? lt / (2 * pad) : 0, hj = halo ? lt % (2 * pad) : 0;
    const int hw = hj < pad ? hj : RK + hj;   // the window row: t0 − pad + hw
    const __nv_bfloat16* hk = P + ((size_t)(c0 / 8 + hc) * Tp + HP - pad + hw) * 8;
    for (int k = 0; k < n; ++k) {
      const int item = i0 + k, bb = item / n_rk, t0 = (item % n_rk) * RK, st = k % nst;
      if (k >= nst) mbar_wait(empty + st, ((k / nst) - 1) & 1);
      __nv_bfloat16* sp = stages + st * stage;
      const size_t po = bb * pb + (size_t)t0 * 8, qo = bb * qb + (size_t)t0 * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp16(sp + ((h + 2 * i) * PWR + pad + r) * 8, pk + po + i * pstep);
      if (halo) cp16(sp + (hc * PWR + hw) * 8, hk + po);
#pragma unroll
      for (int i = 0; i < 8; ++i) cp16(sp + SP + ((h + 2 * i) * RK + r) * 8, qk + qo + i * pstep);
      if (has_rs) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp16(sp + SP + SQ + ((h + 2 * i) * RK + r) * 8, zk + po + i * pstep);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          cp16(sp + SP + SQ + SZ + ((h + 2 * i) * RK + r) * 8, dk + qo + i * pstep);
      }
      cp_arrive(full + st);
    }
    return;
  }
  if (wg >= nv) return;
  // product v: tap v reads P's window from row v (t + v − pad) with Q; v = taps is dW_rs
  const int v = v0 + wg;
  const bool rs = v == taps;
  const int a_off = rs ? SP + SQ : v * 8, b_off = rs ? SP + SQ + SZ : SP;
  const uint32_t a_sbo = rs ? RK * 16 : PWR * 16;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  int prev = -1;
  for (int k = 0; k < n; ++k) {
    const int st = k % nst;
    mbar_wait(full + st, (k / nst) & 1);
    fence_async_smem();   // the loaders' cp.async writes, seen by wgmma
    const __nv_bfloat16* sp = stages + st * stage;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n128_mn(acc, smem_desc(sp + a_off + 16 * ks * 8, 128, a_sbo),
                    smem_desc(sp + b_off + 16 * ks * 8, 128, RK * 16));
    wg_commit();
    wg_wait<1>();
    mbar_arrive_if(empty + max(prev, 0), prev >= 0 && lane == 0);
    prev = st;
  }
  wg_wait<0>();
  fence_acc(acc);
  mbar_arrive_if(empty + max(prev, 0), prev >= 0 && lane == 0);
  float* o = rs ? out_rs + (size_t)s * rs_sstride + (size_t)c0 * C2 + n0
                : out_in + (size_t)s * in_sstride + (size_t)(v * pch + c0) * C2 + n0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = 16 * warp + g + 8 * hr;
      *reinterpret_cast<float2*>(o + (size_t)m * C2 + 8 * i + 2 * tq) =
          make_float2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
    }
}

constexpr size_t ACT_SMEM = ((size_t)(C / 8) * XWR * 8 + (size_t)(C2 / 8) * DSR * 8 +
                             (size_t)ACT_NS * ACT_SLOT) * 2 + RED * 4 + (2 * ACT_NS + 1) * 8;
constexpr size_t DX_SMEM = ((size_t)(C2 / 8) * XWR * 8 + (size_t)DX_NS * DX_SLOT) * 2 +
                           (1 + 2 * DX_NS) * 8;
constexpr size_t WG_SMEM = (size_t)WG_STAGES * (8 * PWR + 16 * RK) * 16 + 2 * WG_STAGES * 8;

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace wg

// ------------------------------------------------------- bf16 forward, wgmma

namespace wf {
using namespace wg;

constexpr int FWD_SLOT = ACT_SLOT;   // bf16 per ring slot (16 KB): a gate k block, or a
constexpr int RS_BLOCK = 32 * C;     // 32-deep k block of a W_rs half (12 KB)
constexpr int EQ = C / 4;            // columns of an epilogue quarter
constexpr int SLD = EQ + 8;          // padded row of an epilogue stage, floats (the 4 rows
                                     // a half-warp reads in one float2 load hit distinct banks)

// A block of WGS warpgroups, 64 rows each (no producer warp: warp 0
// refills the ring).  WGS = 1 fits two blocks on an SM, so one block's
// window load, gate and epilogue could overlap the other's products; WGS = 2
// streams the weights once for twice the rows.  At B = 12 and T = 640 and
// 1024 the two came within 2 % of each other (PERF.md §6):
constexpr int FWD_WGS = 2;

template <int WGS>
struct Tile {
  static constexpr int ROWS = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NS = WGS == 2 ? 6 : 3;      // ring slots
  static constexpr int XR = ROWS + 2 * PAD + 1;    // rows per chunk of the window (odd: the
  static constexpr int ZR = ROWS + 1;              // stores across chunks hit distinct banks)
  // the first region: x_l's window, then the epilogue's two stages
  static constexpr size_t WIN = (size_t)(C / 8) * XR * 16, STAGES = (size_t)2 * ROWS * SLD * 4;
  static constexpr size_t R1 = WIN > STAGES ? WIN : STAGES;
  static constexpr size_t SMEM = R1 + ((size_t)(C / 8) * ZR * 8 + (size_t)NS * FWD_SLOT) * 2 +
                                 2 * NS * 8;
};

// out[0], out[1] = a, b where pred holds: a store under no branch
__device__ __forceinline__ void st2_if(float* out, float a, float b, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
               "@p st.global.v2.f32 [%0], {%1, %2};\n}\n"
               ::"l"(out), "f"(a), "f"(b), "r"((int)pred) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// tanh on the special function unit (one instruction, relative error ~2^-11,
// below z's bf16 rounding); sigmoid(v) = (1 + tanh(v/2)) / 2
__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block i of the layer's weight stream (9K gate blocks, then the W_rs
// halves' blocks) into its slot of an ns-slot ring, by the thread where pred
// holds; its bytes complete on the slot's full barrier
__device__ __forceinline__ void stream_block(__nv_bfloat16* ring, uint64_t* full,
                                             const __nv_bfloat16* __restrict__ w, int i,
                                             int n_gate, int ns, bool pred) {
  const bool gate = i < n_gate;
  const uint32_t bytes = (gate ? ACT_SLOT : RS_BLOCK) * 2;
  const size_t from = gate ? (size_t)i * ACT_SLOT
                           : (size_t)n_gate * ACT_SLOT + (size_t)(i - n_gate) * RS_BLOCK;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n}\n"
      ::"r"(smem_addr(ring + (i % ns) * FWD_SLOT)), "l"(w + from), "r"(bytes),
        "r"(smem_addr(full + i % ns)), "r"((int)pred)
      : "memory");
}

// Layer l of the bf16 forward: a block owns Tile<WGS>::ROWS rows of one
// batch item, 64 a warpgroup.
//   per chunk jc of C: a = cond + Σ_tap x_l window (shifted by the tap) ·
//     W_in[tap][:, tanh and sigmoid columns of jc] (m64n128k16),
//     z[:, jc] = tanh · sigmoid, bf16 into the z tile
//   rs half h (residual, then skip unless LAST) = z · W_rs[:, h] + b_rs
//     (m64n192k16), then its epilogue:
//     LAST: out = (skip + rs_res)·m; else x_{l+1} = (x_l + rs_res)·m and
//     skip += rs_skip, x_l re-read in f32.
// The weights of the layer come prepared, k block by k block, through the
// ring: 9K gate blocks (chunk, tap, 64 input channels), then 6 k blocks of
// 32 channels a half; warp 0 copies block i − 1 + NS into the slot block
// i − 1 leaves while block i's products run.  An epilogue's f32 operand
// (x_l, or the skip sum) comes in four column quarters through two stages
// in the window's space, copied by cp.async while the half's products run.
// The skip sum starts at zero (the caller zeroes it).
template <int WGS, bool LAST>
__global__ void __launch_bounds__(Tile<WGS>::THREADS, 3 - WGS)
layer_kernel(float* __restrict__ xs, float* __restrict__ skip, float* __restrict__ out,
             const float* __restrict__ mask, const float* __restrict__ cond,
             const __nv_bfloat16* __restrict__ w, const float* __restrict__ b_rs, int T, int L,
             int l, int K) {
  using Tl = Tile<WGS>;
  constexpr int ROWS = Tl::ROWS, NTH = Tl::THREADS, NS = Tl::NS, XR = Tl::XR, ZR = Tl::ZR;
  constexpr int HALVES = LAST ? 1 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem);   // [C/8][XR][8]
  float* stage = reinterpret_cast<float*>(smem);                // [2][ROWS][SLD], after the gate
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem + Tl::R1);   // [C/8][ZR][8]
  __nv_bfloat16* ring = zs + (C / 8) * ZR * 8;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * FWD_SLOT);
  uint64_t* empty = full + NS;
  const int tid = threadIdx.x, pad = K / 2, b = blockIdx.y, t0 = blockIdx.x * ROWS;
  const int n_gate = 9 * K, total = n_gate + 6 * HALVES;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NTH / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS; ++i) stream_block(ring, full, w, i, n_gate, NS, tid == 0);

  // x_l's window [t0 − pad, t0 + ROWS + pad) in bf16, zeros outside [0, T)
  const float* xl = xs + ((size_t)b * L + l) * T * C;
  {
    constexpr int XU = 8;
    const int pieces = (ROWS + 2 * pad) * (C / 8);
    for (int base = tid; base < pieces; base += XU * NTH) {
      float v[XU][8];
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int i = base + u * NTH, r = i / (C / 8), t = t0 - pad + r;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
        if (i < pieces && t >= 0 && t < T) load8(v[u], xl + (size_t)t * C + 8 * (i % (C / 8)), 1.f);
      }
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int i = base + u * NTH;
        if (i < pieces)
          *reinterpret_cast<uint4*>(xw + ((i % (C / 8)) * XR + i / (C / 8)) * 8) = pack8(v[u]);
      }
    }
  }
  fence_async_smem();
  __syncthreads();

  // the warpgroup and warp through a shuffle: the wgmma below sit on no divergent path
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const bool lead = __shfl_sync(0xffffffffu, tid >> 5, 0) == 0;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const float* cl = cond + ((size_t)b * L + l) * C2;
  int it = 0;
  // after block `it` is issued: the arrival on the slot of block it − 1, and
  // warp 0's refill of that slot with block it − 1 + NS
  const auto release = [&](int prev) {
    mbar_arrive_if(empty + max(prev, 0), prev >= 0 && lane == 0);
    if (lead && it >= 1 && it - 1 + NS < total) {
      mbar_wait(empty + (it - 1) % NS, ((it - 1) / NS) & 1);
      stream_block(ring, full, w, it - 1 + NS, n_gate, NS, lane == 0);
    }
  };
  for (int jc = 0; jc < 3; ++jc) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);
    int prev = -1;
    // tap q / 3, input channels [64·(q % 3), +64): window row 64·wg + tap
    for (int q = 0; q < 3 * K; ++q, ++it) {
      const int slot = it % NS;
      mbar_wait(full + slot, (it / NS) & 1);
      const __nv_bfloat16* xa = xw + (8 * (q % 3) * XR + 64 * wg + q / 3) * 8;
      const __nv_bfloat16* wb = ring + slot * FWD_SLOT;
      wg_fence();
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wgmma_n128(acc, smem_desc(xa + 2 * k16 * XR * 8, XR * 16, 128),
                   smem_desc(wb + 2 * k16 * 64, 128, 1024));
      wg_commit();
      // the k block before is done with its slot once at most this one is pending
      wg_wait<1>();
      release(prev);
      prev = slot;
    }
    wg_wait<0>();
    fence_acc(acc);
    mbar_arrive_if(empty + prev, lane == 0);
    // z of this thread's rows and the chunk's columns, bf16 into the z tile
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int c = 64 * jc + 8 * n8 + 2 * tq;
      const float2 ct = *reinterpret_cast<const float2*>(cl + c);
      const float2 cs = *reinterpret_cast<const float2*>(cl + C + c);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int e = 4 * n8 + 2 * hr;
        const float z0 =
            tanh_approx(acc[e] + ct.x) * fmaf(0.5f, tanh_approx(0.5f * (acc[32 + e] + cs.x)), 0.5f);
        const float z1 = tanh_approx(acc[e + 1] + ct.y) *
                         fmaf(0.5f, tanh_approx(0.5f * (acc[33 + e] + cs.y)), 0.5f);
        const int r = 64 * wg + 16 * warp + g + 8 * hr;
        *reinterpret_cast<uint32_t*>(zs + ((8 * jc + n8) * ZR + r) * 8 + 2 * tq) = pack2(z0, z1);
      }
    }
  }
  fence_async_smem();
  __syncthreads();

  // columns [EQ·q, +EQ) of rows [t0, t0 + ROWS) of src (this item's rows;
  // rows past T read at T − 1) into stage q & 1
  const auto fetch = [&](const float* src, int q) {
    float* st = stage + (q & 1) * ROWS * SLD;
#pragma unroll
    for (int k = 0; k < ROWS * EQ / 4 / NTH; ++k) {
      const int i = tid + k * NTH, r = i / (EQ / 4), p = i % (EQ / 4);
      cp16(st + r * SLD + 4 * p, src + (size_t)min(t0 + r, T - 1) * C + EQ * q + 4 * p);
    }
    cp_commit();
  };
  float* xn = xs + ((size_t)b * L + l + 1) * T * C;   // written only below the last layer
  const size_t item = (size_t)b * T * C;
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    const float* src = h == 0 && !LAST ? xl : skip + item;
    fetch(src, 0);
    fetch(src, 1);
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    fence_acc(acc);
    int prev = -1;
    // z channels [32·kb, +32) with W_rs rows [32·kb, +32), columns [C·h, +C)
    for (int kb = 0; kb < 6; ++kb, ++it) {
      const int slot = it % NS;
      mbar_wait(full + slot, (it / NS) & 1);
      const __nv_bfloat16* za = zs + (4 * kb * ZR + 64 * wg) * 8;
      const __nv_bfloat16* wb = ring + slot * FWD_SLOT;
      wg_fence();
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16)
        wgmma_n192(acc, smem_desc(za + 2 * k16 * ZR * 8, ZR * 16, 128),
                   smem_desc(wb + 2 * k16 * 64, 128, 512));
      wg_commit();
      wg_wait<1>();
      release(prev);
      prev = slot;
    }
    wg_wait<0>();
    fence_acc(acc);
    mbar_arrive_if(empty + prev, lane == 0);
    // the epilogue, a quarter at a time: rows past T are never stored
    bool in[2];
    size_t o[2];
    float m[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + 64 * wg + 16 * warp + g + 8 * hr;
      in[hr] = t < T;
      o[hr] = (size_t)(in[hr] ? t : T - 1) * C;
      m[hr] = mask[(size_t)b * T + (in[hr] ? t : T - 1)];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < 3)
        cp_wait<1>();
      else
        cp_wait<0>();
      __syncthreads();
      const float* st = stage + (q & 1) * ROWS * SLD + (64 * wg + 16 * warp + g) * SLD + 2 * tq;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int j = 0; j < EQ / 8; ++j) {
          const int n8 = EQ / 8 * q + j, c = 8 * n8 + 2 * tq;
          const float2 v = *reinterpret_cast<const float2*>(st + 8 * hr * SLD + 8 * j);
          const float2 bias = *reinterpret_cast<const float2*>(b_rs + h * C + c);
          const float r0 = acc[4 * n8 + 2 * hr] + bias.x, r1 = acc[4 * n8 + 2 * hr + 1] + bias.y;
          if (h == 0 && !LAST)
            st2_if(xn + o[hr] + c, (v.x + r0) * m[hr], (v.y + r1) * m[hr], in[hr]);
          else if (LAST)
            st2_if(out + item + o[hr] + c, (v.x + r0) * m[hr], (v.y + r1) * m[hr], in[hr]);
          else
            st2_if(skip + item + o[hr] + c, v.x + r0, v.y + r1, in[hr]);
        }
      __syncthreads();
      if (q < 2) fetch(src, q + 2);
    }
  }
}

template <int WGS>
cudaError_t launch_layers(float* xs, float* skip, float* out, const float* mask,
                          const float* cond, const __nv_bfloat16* w, const float* b_rs, int B,
                          int T, int L, int K, cudaStream_t st) {
  using Tl = Tile<WGS>;
  const size_t w_l = (size_t)9 * K * ACT_SLOT + (size_t)C * C2;
  dim3 rows((T + Tl::ROWS - 1) / Tl::ROWS, B);
  for (int l = 0; l < L; ++l) {
    auto kernel = l == L - 1 ? layer_kernel<WGS, true> : layer_kernel<WGS, false>;
    kernel<<<rows, Tl::THREADS, Tl::SMEM, st>>>(xs, skip, out, mask, cond, w + l * w_l,
                                                b_rs + (size_t)l * C2, T, L, l, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace wf

}  // namespace

// Layout: xs [B, L, T, C] (xs[:, 0] = x, filled by the caller); skip, out
// [B, T, C]; mask [B, T]; cond [B, L, 2C]; w_in [K, C, 2C], w_rs [C, 2C],
// b_rs [2C] of layer l.  All f32, contiguous.  C = 192, K odd ≤ 7.
// Every entry returns a cudaError_t as int.
extern "C" int wn_train_row_tile() { return BM; }

// The f32 forward, layer l.
extern "C" int wn_train_fwd_layer(float* xs, float* skip, float* out, const float* mask,
                                  const float* cond, const float* w_in, const float* w_rs,
                                  const float* b_rs, int B, int T, int L, int l, int K,
                                  void* stream) {
  if (bad_k(K)) return (int)cudaErrorInvalidValue;
  auto kernel = fwd_layer<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, B);
  kernel<<<grid, THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      xs, skip, out, mask, cond, w_in, w_rs, b_rs, T, L, l, K);
  return (int)cudaGetLastError();
}

// w_rs_t: W_rs[l]ᵀ [2C, C].  dx_next is dL/dx_{l+1} [B, T, C] (not read at
// l = L−1).  Writes z [B, T, C], d_rs and dacts [B, T, 2C], and per-tile
// column sums part_dcond, part_db [B, ceil(T/BM), 2C].
extern "C" int wn_train_bwd_act(const float* xs, const float* mask, const float* cond,
                                const float* w_in, const float* w_rs_t, const float* dout,
                                const float* dx_next, float* z, float* d_rs, float* dacts,
                                float* part_dcond, float* part_db, int B, int T, int L, int l,
                                int K, void* stream) {
  if (bad_k(K)) return (int)cudaErrorInvalidValue;
  auto kernel = bwd_act<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)ACT_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, B);
  kernel<<<grid, THREADS, ACT_SMEM, static_cast<cudaStream_t>(stream)>>>(
      xs, mask, cond, w_in, w_rs_t, dout, dx_next, z, d_rs, dacts, part_dcond, part_db, T, L,
      l, K);
  return (int)cudaGetLastError();
}

// w_in_t: W_in[l]ᵀ per tap [K, 2C, C].  last = (l == L−1).
extern "C" int wn_train_bwd_dx(const float* dacts, const float* w_in_t, const float* dx_next,
                               const float* mask, float* dx, int B, int T, int K, int last,
                               void* stream) {
  if (bad_k(K)) return (int)cudaErrorInvalidValue;
  auto kernel = bwd_dx<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DX_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, B);
  kernel<<<grid, THREADS, DX_SMEM, static_cast<cudaStream_t>(stream)>>>(dacts, w_in_t, dx_next,
                                                                        mask, dx, T, K, last);
  return (int)cudaGetLastError();
}

// P: batch stride p_bstride, rows of Cp; Q: [B·T, N]; out: n_split partials
// of [taps·Cp, N], out_sstride apart.  Cp and N multiples of 64, P and Q
// 16-byte aligned.
extern "C" int wn_train_wgrad(const float* P, const float* Q, float* out, int p_bstride,
                              int taps, int Cp, int N, int B, int T, int n_split,
                              int out_sstride, void* stream) {
  if (Cp % WT || N % WT || n_split < 1) return (int)cudaErrorInvalidValue;
  const int rows = (B * T + n_split - 1) / n_split;
  dim3 grid(taps * Cp / WT, N / WT, n_split);
  auto kernel = wgrad<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, Q, out, p_bstride, taps, Cp, N, B, T, rows, out_sstride);
  return (int)cudaGetLastError();
}

// The bf16 forward on wgmma, every layer in order (K odd ≤ 5).
//   xs [B, L, T, C] f32 with xs[:, 0] = x; skip [B, T, C] f32, zeroed by the
//   caller; out [B, T, C]; mask [B, T], cond [B, L, 2C], b_rs [L, 2C]: f32.
//   w [L, 9K·8192 + C·2C]: prepare_fwd_weights (bf16).
extern "C" int wn_train_bf16_forward(float* xs, float* skip, float* out, const float* mask,
                                     const float* cond, const void* w, const float* b_rs, int B,
                                     int T, int L, int K, void* stream) {
  using wf::FWD_WGS;
  if (K % 2 == 0 || K / 2 > wg::PAD) return (int)cudaErrorInvalidValue;
  // the kernels' shared-memory limit, set once per loaded library
  static const cudaError_t ready = [] {
    const cudaError_t err = wg::set_smem(wf::layer_kernel<FWD_WGS, false>, wf::Tile<FWD_WGS>::SMEM);
    return err == cudaSuccess ? wg::set_smem(wf::layer_kernel<FWD_WGS, true>,
                                             wf::Tile<FWD_WGS>::SMEM)
                              : err;
  }();
  if (ready != cudaSuccess) return (int)ready;
  return (int)wf::launch_layers<FWD_WGS>(xs, skip, out, mask, cond,
                                         static_cast<const __nv_bfloat16*>(w), b_rs, B, T, L, K,
                                         static_cast<cudaStream_t>(stream));
}

// The bf16 backward on wgmma, every layer in reverse (the three entries above
// are the f32 backward's).  Per layer: bwd_act, bwd_dx, and the weight
// gradients.  K odd ≤ 5.
//   xs [B, L, T, C], mask [B, T], cond [B, L, 2C], dout [B, T, C]: f32.
//   w_act [L, 3, (3K + 3)·8192], w_dx [L, K, 6·64·C]: prepare_bwd_weights (bf16).
//   dx0, dx1 [B, T, C] f32: dL/dx_l, alternating from the last layer; the
//     input's gradient ends in dx0 when L is odd, else in dx1.
//   xb, z [B, C/8, Tp, 8], d_rs, dacts [B, 2C/8, Tp, 8]: bf16 scratch with Tp =
//     ceil(T / 128)·128 + 16, zeroed by the caller.
//   part_dcond, part_db [L, B, ceil(T / 128), 2C]; part_win [S, L, K·C, 2C],
//   part_wrs [S, L, C, 2C] f32, S = WGRAD_SPLITS: partial sums the caller
//     adds up in a fixed order.
extern "C" int wn_train_bf16_backward(const float* xs, const float* mask, const float* cond,
                                      const void* w_act, const void* w_dx, const float* dout,
                                      float* dx0, float* dx1, void* xb, void* z, void* d_rs,
                                      void* dacts, float* part_dcond, float* part_db,
                                      float* part_win, float* part_wrs, int B, int T, int L,
                                      int K, void* stream) {
  using bf = __nv_bfloat16;
  if (K % 2 == 0 || K / 2 > wg::PAD) return (int)cudaErrorInvalidValue;
  cudaError_t err = wg::set_smem(wg::act_kernel, wg::ACT_SMEM);
  if (err == cudaSuccess) err = wg::set_smem(wg::dx_kernel, wg::DX_SMEM);
  if (err == cudaSuccess) err = wg::set_smem(wg::wgrad_kernel, wg::WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (T + wg::TR - 1) / wg::TR, n_rk = tiles * (wg::TR / wg::RK);
  const size_t act_l = (size_t)3 * (3 * K + 3) * wg::ACT_SLOT, dx_l = (size_t)K * 6 * wg::DX_SLOT;
  const size_t part_l = (size_t)B * tiles * C2, win_l = (size_t)K * C * C2, wrs_l = (size_t)C * C2;
  dim3 rows(tiles, B);
  // the K + 1 products of the weight gradients, TAPG a block
  dim3 wgrid((K + wg::TAPG) / wg::TAPG * (C / 64), C2 / 128, wg::WGRAD_SPLITS);
  float* dx[2] = {dx0, dx1};
  for (int l = L - 1, cur = 0; l >= 0; --l, cur ^= 1) {
    const float* next = dx[cur ^ 1];   // dL/dx_{l+1}; not read at the last layer
    wg::act_kernel<<<rows, wg::ACT_NT, wg::ACT_SMEM, st>>>(
        xs, mask, cond, static_cast<const bf*>(w_act) + l * act_l, dout, next,
        static_cast<bf*>(xb), static_cast<bf*>(z), static_cast<bf*>(d_rs),
        static_cast<bf*>(dacts), part_dcond + l * part_l, part_db + l * part_l, T, L, l, K);
    wg::dx_kernel<<<rows, wg::NT, wg::DX_SMEM, st>>>(
        static_cast<const bf*>(dacts), static_cast<const bf*>(w_dx) + l * dx_l, next, mask,
        dx[cur], T, K, l == L - 1);
    wg::wgrad_kernel<<<wgrid, wg::WG_NT, wg::WG_SMEM, st>>>(
        static_cast<const bf*>(xb), static_cast<const bf*>(dacts), static_cast<const bf*>(z),
        static_cast<const bf*>(d_rs), part_win + l * win_l, part_wrs + l * wrs_l, C, K, B, n_rk,
        (size_t)L * win_l, (size_t)L * wrs_l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
