// Trainable dilation-1 WaveNet stack: forward and backward, f32 accumulators.
//
// Replaces vispeech_tpu/ops/pallas/wn_stack_train.py::wn_stack_train (custom
// VJP, bodies _fwd_kernel and _bwd_kernel).  The TPU kernels keep one batch
// item's [T, C] state in VMEM and walk the layers as a sequential grid axis.
// Here each layer is its own launch over blocks of BM = 32 frames with a
// halo of k//2 frames, so any depth fits and no halo is recomputed:
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
// BF16 = true rounds every matmul operand to bf16 (x_l, z, d_rs, dacts and
// the weights); accumulators, the gate, the residual carry and the skip sum
// stay f32, as the TPU kernel's bf16_compute does.
//
// Every product runs on the tensor cores as mma.sync m16n8k8 TF32.  A bf16
// value is exact in TF32, so BF16 takes one pass; f32 takes the 3-pass split
// a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi (kernel B's), which keeps f32
// accuracy.  A block's 8 warps split its 32 frames in two m16 tiles and the
// output columns in 4 groups; warp (m, n) owns n8 tiles n, n+4, ... of each
// C-wide half, so the tanh and sigmoid halves of a gate column, and dz of
// the same column, land in the same thread's registers.  Shared rows are
// padded (C + 4, 2C + 4, N + 8 floats) so fragment loads hit 32 banks.
//
// Bound: at B = 12, T = 1024, C = 192, k = 5 a layer is ~11 GFLOP forward
// and ~31 GFLOP backward against ~20 MB of activations: compute-bound.

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

}  // namespace

// Layout: xs [B, L, T, C] (xs[:, 0] = x, filled by the caller); skip, out
// [B, T, C]; mask [B, T]; cond [B, L, 2C]; w_in [K, C, 2C], w_rs [C, 2C],
// b_rs [2C] of layer l.  All f32, contiguous.  C = 192, K odd ≤ 7.
// Every entry returns a cudaError_t as int.
extern "C" int wn_train_row_tile() { return BM; }

extern "C" int wn_train_fwd_layer(float* xs, float* skip, float* out, const float* mask,
                                  const float* cond, const float* w_in, const float* w_rs,
                                  const float* b_rs, int B, int T, int L, int l, int K,
                                  int bf16, void* stream) {
  if (bad_k(K)) return (int)cudaErrorInvalidValue;
  auto kernel = bf16 ? fwd_layer<true> : fwd_layer<false>;
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
                                int K, int bf16, void* stream) {
  if (bad_k(K)) return (int)cudaErrorInvalidValue;
  auto kernel = bf16 ? bwd_act<true> : bwd_act<false>;
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
                               int bf16, void* stream) {
  if (bad_k(K)) return (int)cudaErrorInvalidValue;
  auto kernel = bf16 ? bwd_dx<true> : bwd_dx<false>;
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
                              int out_sstride, int bf16, void* stream) {
  if (Cp % WT || N % WT || n_split < 1) return (int)cudaErrorInvalidValue;
  const int rows = (B * T + n_split - 1) / n_split;
  dim3 grid(taps * Cp / WT, N / WT, n_split);
  auto kernel = bf16 ? wgrad<true> : wgrad<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, Q, out, p_bstride, taps, Cp, N, B, T, rows, out_sstride);
  return (int)cudaGetLastError();
}
