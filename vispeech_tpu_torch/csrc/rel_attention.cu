// Masked self-attention with a window-w relative-position bias, f32.
//
// Replaces vispeech_tpu/ops/pallas/flash_attention.py::relative_self_attention
// (body _attention_kernel).  The TPU kernel holds all of K and V of one
// batch-head in VMEM; here a CTA of 4 warps owns (batch-head, 64 query rows,
// one split of the keys) and streams its keys in tiles of 32 through shared
// memory with an online softmax, so the [T, T] scores never leave the chip.
//
//   s[t, j]  = (q[t]·scale)·k[j] + (|j−t| ≤ w ? (q[t]·scale)·rel_k[j−t+w] : 0)
//   s[t, j]  = key_mask[j] > 0 ? s[t, j] : −1e4        (masked *replace*)
//   s[t, j]  = −inf for j ≥ T
//   out[t]   = Σ_j p[t, j]·(v[j] + (|j−t| ≤ w ? rel_v[j−t+w] : 0))
//
// A row whose keys are all masked sees a uniform softmax and stays finite.
//
// What bounds it: 4·T²·d flops per batch-head (0.75 GFLOP per head at
// T = 1400, d = 96) against T·d·16 bytes: compute-bound.  The first version
// ran both products on the f32 CUDA cores, on 88 CTAs of 4 warps at
// T = 1400 (under one wave, 4 of an SM's 64 warp slots) and on 2–6 CTAs at
// the phoneme-level lengths.
//
// What the design does about it:
// - Tensor cores: QKᵀ and P·V are mma.sync m16n8k8 TF32 with the 3-pass
//   hi/lo split (a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi), which keeps f32
//   accuracy.  Each warp owns 16 query rows; their scaled, split Q fragments
//   stay in registers; the score fragments become P·V's A fragments with no
//   shuffle, because P·V reads the keys of each 8-key group in the order
//   (0, 2, 4, 6, 1, 3, 5, 7), the order the score fragment holds them in.
// - K, V and the key mask are staged by cp.async, double buffered, one tile
//   ahead of the products.
// - The relative terms: q·rel_kᵀ is one [64 × d]·[d × 2w+1] product per CTA
//   (f32, CUDA cores), added on the band of the scores.  The rel-v term keeps
//   each row's band probabilities by δ ∈ [−w, w] in registers, rescaled with
//   the running max like the accumulator, and adds one [rows × 2w+1] ·
//   [2w+1 × d] product at the end.
// - The keys are split across CTAs (blockIdx.z) when batch·heads·⌈T/64⌉
//   would leave the card idle: each split writes its rows' partial max, sum
//   and accumulator (the band term already in it) to scratch, and a second
//   small kernel rescales and sums them.  A band that straddles a split
//   boundary is handled by each split for the keys it owns.
// - q, k and v are read through their strides (the [B, H, T, d] views of
//   [B, T, H, d] projections), and the output is written as [B, T, H, d].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA: 4 warps of 16
constexpr int BK = 32;        // keys per tile
constexpr int NWARP = 4;
constexpr int MAXW = 9;       // 2w+1, w ≤ 4

struct Strides {  // element strides of a [B, H, T, d] view, d contiguous
  int b, h, t;
};

// v ≈ hi + lo for the 3-pass products: hi is v rounded to TF32 to nearest,
// ties away from zero (the result of cvt.rna.tf32.f32, in two integer
// instructions where cvt takes several), lo the exact f32 rest, which the
// tensor core reads truncated to TF32: |v − hi − lo| ≤ 2^-21·|v|
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global → shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
// 4 bytes global → shared; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n"); }

// rows [r0, r0 + n) of a [B, H, T, D] view into shared rows of lds floats;
// rows at or past T are zeros
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int lds, const float* __restrict__ src,
                                           int st, int r0, int n, int T) {
  for (int i = threadIdx.x; i < n * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4, t = r0 + r;
    const bool in = t < T;
    cp_async16(dst + r * lds + c, src + (size_t)(in ? t : 0) * st + c, in ? 16 : 0);
  }
}

// grid (⌈T/64⌉, B·H, splits); split z covers key tiles [z·tps, (z+1)·tps).
// splits = 1: out [B, T, H, D] final.  splits > 1: part_acc [splits, B·H, T, D]
// (unnormalised, band term in) and part_ml [splits, B·H, T, 2] (max, sum).
template <int D>
__global__ void __launch_bounds__(NWARP * 32)
rel_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Strides st,
                     const float* __restrict__ rel_k, const float* __restrict__ rel_v,
                     const float* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int T,
                     int n_rel, int window, int tps, float scale) {
  constexpr int LD = D + 4;   // padded rows: the fragment reads fall in distinct banks
  constexpr int KD = D / 8;   // k-steps of QKᵀ, n8 tiles of P·V
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BQ][LD]
  float* ks = qs + BQ * LD;           // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;       // [2][BK][LD]
  float* rks = vs + 2 * BK * LD;      // [MAXW][D]
  float* rvs = rks + MAXW * D;        // [MAXW][D]
  float* qr = rvs + MAXW * D;         // [BQ][MAXW]
  float* km = qr + BQ * MAXW;         // [2][BK]
  float* qlo = km + 2 * BK;           // [BQ][LD]: scaled Q's TF32 lo half; qs its hi half

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int W = 2 * window + 1;
  const int tile0 = split * tps;
  const int ntile = min(tps, (T + BK - 1) / BK - tile0);
  const size_t head = (size_t)b * st.b + (size_t)h * st.h;
  const float *qb = q + head, *kb = k + head, *vb = v + head;
  const float* mb = mask + (size_t)b * T;
  const float* rk = rel_k + (size_t)(n_rel > 1 ? h : 0) * W * D;
  const float* rv = rel_v + (size_t)(n_rel > 1 ? h : 0) * W * D;

  auto stage_tile = [&](int i, int buf) {
    const int key0 = (tile0 + i) * BK;
    stage_rows<D>(ks + buf * BK * LD, LD, kb, st.t, key0, BK, T);
    stage_rows<D>(vs + buf * BK * LD, LD, vb, st.t, key0, BK, T);
    if (tid < BK) {
      const bool in = key0 + tid < T;
      cp_async4(km + buf * BK + tid, mb + (in ? key0 + tid : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };

  // Q, the tables and tile 0 in one group, all in flight at once
  stage_rows<D>(qs, LD, qb, st.t, q0, BQ, T);
  for (int i = tid; i < W * D / 4; i += blockDim.x) {
    cp_async16(rks + 4 * i, rk + 4 * i, 16);
    cp_async16(rvs + 4 * i, rv + 4 * i, 16);
  }
  stage_tile(0, 0);
  cp_async_wait0();
  __syncthreads();
  // q·rel_kᵀ for the CTA's rows, the scale applied to q first: thread
  // (row tid / 2) sums the offsets m ≡ tid (mod 2) side by side
  {
    const int r = tid >> 1, m0 = tid & 1;
    float qrk[(MAXW + 1) / 2] = {};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qv = qs[r * LD + c] * scale;
#pragma unroll
      for (int i = 0; i < (MAXW + 1) / 2; ++i)
        if (m0 + 2 * i < W) qrk[i] += qv * rks[(m0 + 2 * i) * D + c];
    }
#pragma unroll
    for (int i = 0; i < (MAXW + 1) / 2; ++i)
      if (m0 + 2 * i < W) qr[r * MAXW + m0 + 2 * i] = qrk[i];
  }
  __syncthreads();
  // the scaled Q split once: its hi half in place, its lo half in qlo
  for (int i = tid; i < BQ * D; i += blockDim.x) {
    float* qp = qs + (i / D) * LD + i % D;
    uint32_t hi, lo;
    split_tf32(*qp * scale, hi, lo);
    *qp = __uint_as_float(hi);
    qlo[(i / D) * LD + i % D] = __uint_as_float(lo);
  }
  const int r0 = warp * 16 + g;       // this warp's rows r0 and r0 + 8 of the CTA

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float band[2][MAXW];
  float acc[KD][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int d = 0; d < MAXW; ++d) band[i][d] = 0.f;
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < ntile; ++i) {
    cp_async_wait0();
    __syncthreads();   // tile i landed for every thread; tile i − 1's buffers are free
    if (i + 1 < ntile) stage_tile(i + 1, (i + 1) & 1);
    const float* kt = ks + (i & 1) * BK * LD;
    const float* vt = vs + (i & 1) * BK * LD;
    const float* kmt = km + (i & 1) * BK;
    const int key0 = (tile0 + i) * BK;

    // scores of the warp's 16 rows against the tile's 4 groups of 8 keys;
    // each pass in its own accumulator, so every chain is KD long and
    // consecutive mma.sync instructions are independent
    float s[4][4], s_lh[4][4], s_hl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_lh[j][e] = s_hl[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float* qp = qs + r0 * LD + kk * 8 + tq;
      const float* qq = qlo + r0 * LD + kk * 8 + tq;
      const uint32_t ah[4] = {__float_as_uint(qp[0]), __float_as_uint(qp[8 * LD]),
                              __float_as_uint(qp[4]), __float_as_uint(qp[8 * LD + 4])};
      const uint32_t al[4] = {__float_as_uint(qq[0]), __float_as_uint(qq[8 * LD]),
                              __float_as_uint(qq[4]), __float_as_uint(qq[8 * LD + 4])};
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* kp = kt + (j * 8 + g) * LD + kk * 8 + tq;
        split_tf32(kp[0], bh[j][0], bl[j][0]);
        split_tf32(kp[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s_lh[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s_hl[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s[j], ah, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_lh[j][e] + s_hl[j][e];
    // bias band, mask, online softmax; element e of group j is row
    // r0 + 8·(e >> 1), key key0 + 8j + 2tq + (e & 1).  `band_tile`: the tile
    // meets the band of the warp's rows
    const int wq0 = q0 + warp * 16;
    const bool band_tile = key0 <= wq0 + 15 + window && key0 + BK - 1 >= wq0 - window;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), kj = j * 8 + 2 * tq + (e & 1);
        const int delta = key0 + kj - (q0 + r);
        float val = s[j][e];
        if (band_tile && delta >= -window && delta <= window) val += qr[r * MAXW + delta + window];
        if (kmt[kj] <= 0.f) val = -1e4f;
        if (key0 + kj >= T) val = -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      const float m_new = fmaxf(m[i2], mx[i2]);   // finite: a tile's first key is < T
      corr[i2] = expf(m[i2] - m_new);
      m[i2] = m_new;
      l[i2] *= corr[i2];
#pragma unroll
      for (int d = 0; d < MAXW; ++d) band[i2][d] *= corr[i2];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1;
        const float p = expf(s[j][e] - m[i2]);
        s[j][e] = p;
        l[i2] += p;
        if (band_tile) {
          const int delta = key0 + j * 8 + 2 * tq + (e & 1) - (q0 + r0 + 8 * i2);
#pragma unroll
          for (int d = 0; d < MAXW; ++d)
            if (delta == d - window) band[i2][d] += p;
        }
      }
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }
    // P·V: group j's keys in the order (2tq, 2tq + 1) ↔ k-index (tq, tq + 4)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* vp = vt + (j * 8 + 2 * tq) * LD + g;
      // in groups of four n8 tiles, the passes in turn
#pragma unroll
      for (int n0 = 0; n0 < KD; n0 += 4) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          split_tf32(vp[(n0 + n) * 8], bh[n][0], bl[n][0]);
          split_tf32(vp[LD + (n0 + n) * 8], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], ah, bh[n][0], bh[n][1]);
      }
    }
  }

  // the quad's row sums and band probabilities; then the band · rel_v term
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
#pragma unroll
    for (int d = 0; d < MAXW; ++d) {
      band[i2][d] += __shfl_xor_sync(0xffffffffu, band[i2][d], 1);
      band[i2][d] += __shfl_xor_sync(0xffffffffu, band[i2][d], 2);
    }
  }
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + 2 * tq + (e & 1);
      float t = 0.f;
#pragma unroll
      for (int d = 0; d < MAXW; ++d)
        if (d < W) t += band[e >> 1][d] * rvs[d * D + c];
      acc[n][e] += t;
    }
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int t = q0 + r0 + 8 * i2;
    if (t >= T) continue;
    if (nsplit == 1) {
      float* o = out + (((size_t)b * T + t) * H + h) * D;
      const float inv = 1.f / l[i2];
#pragma unroll
      for (int n = 0; n < KD; ++n)
        *reinterpret_cast<float2*>(o + n * 8 + 2 * tq) =
            make_float2(acc[n][2 * i2] * inv, acc[n][2 * i2 + 1] * inv);
    } else {
      const size_t row = ((size_t)split * gridDim.y + bh) * T + t;
      float* o = part_acc + row * D;
#pragma unroll
      for (int n = 0; n < KD; ++n)
        *reinterpret_cast<float2*>(o + n * 8 + 2 * tq) =
            make_float2(acc[n][2 * i2], acc[n][2 * i2 + 1]);
      if (tq == 0) *reinterpret_cast<float2*>(part_ml + row * 2) = make_float2(m[i2], l[i2]);
    }
  }
}

// out[b, t, h, c] = Σ_s e^{m_s − M}·acc_s / Σ_s e^{m_s − M}·l_s, M = max_s m_s
__global__ void rel_attention_merge(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml, float* __restrict__ out,
                                    int BH, int H, int T, int D, int nsplit) {
  const size_t n = (size_t)BH * T * D;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / D;
    const int c = (int)(i % D);
    float mmax = -INFINITY;
    for (int s = 0; s < nsplit; ++s) mmax = fmaxf(mmax, part_ml[(s * n / D + row) * 2]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t r = s * n / D + row;
      const float f = expf(part_ml[r * 2] - mmax);
      den += f * part_ml[r * 2 + 1];
      num += f * part_acc[r * D + c];
    }
    const int bh = (int)(row / T), t = (int)(row % T);
    out[(((size_t)(bh / H) * T + t) * H + bh % H) * D + c] = num / den;
  }
}

size_t smem_bytes(int D) {
  return (size_t)(2 * BQ * (D + 4) + 4 * BK * (D + 4) + 2 * MAXW * D + BQ * MAXW + 2 * BK) *
         sizeof(float);
}

template <int D>
int launch(const float* q, const float* k, const float* v, Strides st,
           const float* rel_k, const float* rel_v, const float* mask, float* out,
           float* part_acc, float* part_ml, int B, int H, int T, int n_rel, int window,
           int nsplit, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rel_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(D));
  if (attr != cudaSuccess) return (int)attr;
  const int ntiles = (T + BK - 1) / BK;
  const int tps = (ntiles + nsplit - 1) / nsplit;
  if ((ntiles + tps - 1) / tps != nsplit) return (int)cudaErrorInvalidValue;  // no empty split
  const dim3 grid((T + BQ - 1) / BQ, B * H, nsplit);
  rel_attention_kernel<D><<<grid, NWARP * 32, smem_bytes(D), stream>>>(
      q, k, v, st, rel_k, rel_v, mask, out, part_acc, part_ml, H, T, n_rel, window, tps,
      1.f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const size_t n = (size_t)B * H * T * D;
  const int blocks = (int)((n + 255) / 256);
  rel_attention_merge<<<blocks, 256, 0, stream>>>(part_acc, part_ml, out, B * H, H, T, D,
                                                  nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, H, T, d] f32 views with the same element strides (b, h, t)
// and d contiguous, 16-byte aligned rows; rel_k, rel_v: [n_rel, 2w+1, d], 16-byte
// aligned; mask: [B, T] f32; out: [B, T, H, d] f32.  nsplit key splits, each of
// ⌈⌈T/32⌉ / nsplit⌉ tiles and none empty; for nsplit > 1, part_acc
// [nsplit, B·H, T, d] and part_ml [nsplit, B·H, T, 2] f32 scratch.
// d ∈ {64, 96}; w ≤ 4.  Returns the launches' cudaError_t.
extern "C" int rel_attention_launch(const float* q, const float* k, const float* v, int sb,
                                    int sh, int st, const float* rel_k,
                                    const float* rel_v, const float* mask, float* out,
                                    float* part_acc, float* part_ml, int B, int H, int T, int d,
                                    int n_rel, int window, int nsplit, void* stream) {
  if (window > 4 || window < 0 || nsplit < 1) return (int)cudaErrorInvalidValue;
  const Strides strides{sb, sh, st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 96)
    return launch<96>(q, k, v, strides, rel_k, rel_v, mask, out, part_acc, part_ml, B, H, T,
                      n_rel, window, nsplit, s);
  if (d == 64)
    return launch<64>(q, k, v, strides, rel_k, rel_v, mask, out, part_acc, part_ml, B, H, T,
                      n_rel, window, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
