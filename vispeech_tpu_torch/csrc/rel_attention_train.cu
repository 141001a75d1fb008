// Trainable masked self-attention with a window-w relative-position bias and
// dropout on the probabilities: forward and backward, f32 accumulators.
//
// Replaces vispeech_tpu/ops/pallas/flash_attention_train.py::
// relative_self_attention_train (custom VJP, bodies _fwd_kernel and
// _bwd_kernel).  The TPU kernels hold a whole batch-head's K and V (and, in
// the backward, every q row) in VMEM and loop over q blocks inside one
// program.  Here every kernel streams 32-row tiles through shared memory:
//
//   s[t, j]  = q̂[t]·k[j] + (|j−t| ≤ w ? q̂[t]·rel_k[j−t+w] : 0),  q̂ = q/√d
//   s[t, j]  = mask[j] > 0 ? s[t, j] : −1e4
//   p = softmax_j(s),  lse[t] = log Σ_j exp s[t, j]
//   pd = p · keep(t, j) / (1 − rate)
//   out[t]   = Σ_j pd[t, j]·(v[j] + (|j−t| ≤ w ? rel_v[j−t+w] : 0))
//
//   fwd      one block per (batch·head, 32 query rows), keys in tiles of 32
//            with an online softmax (kernel A's scheme): out and lse.
//   bwd_q    one block per (batch·head, 32 query rows): D = rowsum(dO ∘ O),
//            q̂·rel_k and dO·rel_v per row (kept for bwd_kv), then over key
//            tiles p = exp(s − lse), dp = (dO·v + band dO·rel_v)·keep/(1−r),
//            ds = p·(dp − D); dq = (ds·k + band ds·rel_k)/√d, and the tile's
//            partial drel_k = Σ_t ds[t, t+δ]·q̂[t], drel_v = Σ_t pd[t, t+δ]·dO[t].
//   bwd_kv   one block per (batch·head, 32 keys), over query tiles:
//            dk = Σ_t ds[t, j]·q̂[t], dv = Σ_t pd[t, j]·dO[t].
//
// keep(t, j) = hash(seed, b·H + h, t, j) ≥ rate·2³² with the hash below, so
// the mask does not depend on the tiling and the backward regenerates the
// forward's mask bit for bit (the port's plain version computes the same).
//
// BF16 = true rounds every matmul operand to bf16 as the TPU kernel's
// bf16_compute does (q̂, k, v, dO, rel tables in their products, p and ds
// before their products); the softmax, lse and every accumulation stay f32.
// The forward rounds the online softmax's unnormalised weights, which agrees
// with rounding the normalised ones to one bf16 rounding.
//
// Bound: 4·T²·d flops forward and ~10·T²·d backward per batch-head against
// ~T·d·4·6 bytes: compute-bound.  f32 CUDA cores in this first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows (or keys) per block
constexpr int BK = 32;        // keys (or query rows) per streamed tile
constexpr int NWARP = 4;
constexpr int ROWS = BQ / NWARP;
constexpr int MAXW = 9;       // 2w+1, w ≤ 4
constexpr float NEG_FILL = -1e4f;

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, int bh, int t) {
  return fmix32(fmix32(seed ^ (uint32_t)(bh + 1) * 0x9E3779B1u) ^ (uint32_t)(t + 1) * 0x85EBCA77u);
}

// the dropout factor of (row key, key column): 0 or 1/(1 − rate); 1 at rate 0
__device__ __forceinline__ float keep_factor(uint32_t rk, int j, uint32_t thresh, float inv) {
  if (thresh == 0u) return 1.f;
  return fmix32(rk ^ (uint32_t)(j + 1) * 0xC2B2AE3Du) >= thresh ? inv : 0.f;
}

template <int D>
__device__ __forceinline__ float dot4(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll 4
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = a4[i], y = b4[i];
    s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return s;
}

// rows [r0, r0 + n) of a [T, D] slice into shared rows of `ld` floats,
// times `scale`, rounded; zeros past T
template <int D, bool BF16>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int r0, int T, float scale) {
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D, t = r0 + r;
    dst[r * ld + c] = t < T ? rnd<BF16>(src[(size_t)t * D + c] * scale) : 0.f;
  }
}

template <int D, bool BF16>
__global__ void __launch_bounds__(NWARP * 32)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ rel_k,
           const float* __restrict__ rel_v, const float* __restrict__ mask,
           float* __restrict__ out, float* __restrict__ lse, int H, int T, int n_rel,
           int window, uint32_t seed, uint32_t thresh, float inv_keep, float scale) {
  constexpr int KS = D + 4;
  constexpr int DPL = D / 32;
  __shared__ __align__(16) float qs[BQ][KS];
  __shared__ __align__(16) float ks[BK][KS];
  __shared__ float vs[BK][D];
  __shared__ float ps[NWARP][ROWS][BK];
  __shared__ float qr[BQ][MAXW];
  __shared__ float rvs[MAXW][D];
  __shared__ float km[BK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int W = 2 * window + 1;
  const size_t base = (size_t)bh * T * D;
  const float* rk = rel_k + (size_t)(n_rel > 1 ? h : 0) * W * D;
  const float* rv = rel_v + (size_t)(n_rel > 1 ? h : 0) * W * D;

  load_rows<D, BF16>(&qs[0][0], KS, q + base, q0, T, scale);
  for (int i = tid; i < W * D; i += blockDim.x) rvs[i / D][i % D] = rv[i];
  __syncthreads();
  for (int i = tid; i < BQ * W; i += blockDim.x) {
    const int r = i / W, w = i % W;
    float s = 0.f;
    for (int c = 0; c < D; ++c) s += qs[r][c] * rnd<BF16>(rk[w * D + c]);
    qr[r][w] = s;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
  uint32_t rkey[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    rkey[i] = row_key(seed, bh, q0 + warp * ROWS + i);
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += blockDim.x) {
      const int j = i / D, c = i % D, key = k0 + j;
      const bool in = key < T;
      ks[j][c] = in ? rnd<BF16>(k[base + (size_t)key * D + c]) : 0.f;
      vs[j][c] = in ? rnd<BF16>(v[base + (size_t)key * D + c]) : 0.f;
    }
    if (tid < BK) km[tid] = (k0 + tid < T) ? mask[(size_t)b * T + k0 + tid] : 0.f;
    __syncthreads();

    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i, t = q0 + r, delta = key - t;
      float s = dot4<D>(&qs[r][0], &ks[lane][0]);
      if (delta >= -window && delta <= window) s += qr[r][delta + window];
      if (km[lane] <= 0.f) s = NEG_FILL;
      if (key >= T) s = -INFINITY;
      float mt = s;
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      const float p = expf(s - m_new);
      float ls = p;
      for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      l[i] = l[i] * corr + ls;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      ps[warp][i][lane] = key < T ? p * keep_factor(rkey[i], key, thresh, inv_keep) : 0.f;
    }
    __syncwarp();

    const int nk = min(BK, T - k0);
    for (int j = 0; j < nk; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = vs[j][lane + 32 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = ps[warp][i][j], pr = rnd<BF16>(p);
        const int delta = k0 + j - (q0 + warp * ROWS + i);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] += pr * vv[c];
        if (delta >= -window && delta <= window) {
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[i][c] += p * rvs[delta + window][lane + 32 * c];
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + warp * ROWS + i;
    if (t < T) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < DPL; ++c) out[base + (size_t)t * D + lane + 32 * c] = acc[i][c] * inv;
      if (lane == 0) lse[(size_t)bh * T + t] = m[i] + logf(l[i]);
    }
  }
}

template <int D>
struct BwdQSmem {
  static constexpr int KS = D + 4;
  float qs[BQ][KS];         // q̂ rows, rounded
  float dos[BQ][KS];        // dO rows, rounded
  float ks[BK][KS];         // key tile, rounded
  float vs[BK][KS];         // value tile, rounded
  float rks[MAXW][D];       // rel_k, f32 (for dq's band term)
  float ps[NWARP][ROWS][BK];
  float qr[BQ][MAXW], dorv[BQ][MAXW], dsd[BQ][MAXW], pdd[BQ][MAXW];
  float lse[BQ], dd[BQ], km[BK];
};

template <int D, bool BF16>
__global__ void __launch_bounds__(NWARP * 32)
bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ rel_k,
             const float* __restrict__ rel_v, const float* __restrict__ mask,
             const float* __restrict__ o, const float* __restrict__ lse,
             const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ rowd,
             float* __restrict__ qrel, float* __restrict__ dorel, float* __restrict__ part_k,
             float* __restrict__ part_v, int H, int T, int n_rel, int window, uint32_t seed,
             uint32_t thresh, float inv_keep, float scale) {
  constexpr int KS = D + 4;
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) unsigned char raw[];
  BwdQSmem<D>& sm = *reinterpret_cast<BwdQSmem<D>*>(raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int W = 2 * window + 1;
  const size_t base = (size_t)bh * T * D;
  const float* rk = rel_k + (size_t)(n_rel > 1 ? h : 0) * W * D;
  const float* rv = rel_v + (size_t)(n_rel > 1 ? h : 0) * W * D;

  load_rows<D, BF16>(&sm.qs[0][0], KS, q + base, q0, T, scale);
  load_rows<D, BF16>(&sm.dos[0][0], KS, dout + base, q0, T, 1.f);
  for (int i = tid; i < W * D; i += blockDim.x) sm.rks[i / D][i % D] = rk[i];
  for (int i = tid; i < BQ * MAXW; i += blockDim.x) {
    sm.dsd[i / MAXW][i % MAXW] = 0.f;
    sm.pdd[i / MAXW][i % MAXW] = 0.f;
  }
  // D = rowsum(dO ∘ O), one warp per row
  for (int r = warp; r < BQ; r += NWARP) {
    const int t = q0 + r;
    float s = 0.f;
    if (t < T)
      for (int c = lane; c < D; c += 32) s += dout[base + (size_t)t * D + c] * o[base + (size_t)t * D + c];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      sm.dd[r] = s;
      sm.lse[r] = t < T ? lse[(size_t)bh * T + t] : 0.f;
      if (t < T) rowd[(size_t)bh * T + t] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * W; i += blockDim.x) {
    const int r = i / W, w = i % W, t = q0 + r;
    float a = 0.f, c2 = 0.f;
    for (int c = 0; c < D; ++c) {
      a += sm.qs[r][c] * rnd<BF16>(rk[w * D + c]);
      c2 += sm.dos[r][c] * rnd<BF16>(rv[w * D + c]);
    }
    sm.qr[r][w] = a;
    sm.dorv[r][w] = c2;
    if (t < T) {
      qrel[((size_t)bh * T + t) * W + w] = a;
      dorel[((size_t)bh * T + t) * W + w] = c2;
    }
  }

  float acc[ROWS][DPL];
  uint32_t rkey[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    rkey[i] = row_key(seed, bh, q0 + warp * ROWS + i);
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += blockDim.x) {
      const int j = i / D, c = i % D, key = k0 + j;
      const bool in = key < T;
      sm.ks[j][c] = in ? rnd<BF16>(k[base + (size_t)key * D + c]) : 0.f;
      sm.vs[j][c] = in ? rnd<BF16>(v[base + (size_t)key * D + c]) : 0.f;
    }
    if (tid < BK) sm.km[tid] = (k0 + tid < T) ? mask[(size_t)b * T + k0 + tid] : 0.f;
    __syncthreads();

    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i, t = q0 + r, delta = key - t;
      const bool band = delta >= -window && delta <= window;
      float s = dot4<D>(&sm.qs[r][0], &sm.ks[lane][0]);
      float dpd = dot4<D>(&sm.dos[r][0], &sm.vs[lane][0]);
      if (band) {
        s += sm.qr[r][delta + window];
        dpd += sm.dorv[r][delta + window];
      }
      if (sm.km[lane] <= 0.f) s = NEG_FILL;
      float ds = 0.f;
      if (key < T && t < T) {
        const float p = expf(s - sm.lse[r]);
        const float kf = keep_factor(rkey[i], key, thresh, inv_keep);
        ds = p * (dpd * kf - sm.dd[r]);
        if (band) {
          sm.dsd[r][delta + window] = ds;
          sm.pdd[r][delta + window] = p * kf;
        }
      }
      sm.ps[warp][i][lane] = rnd<BF16>(ds);
    }
    __syncwarp();
    const int nk = min(BK, T - k0);
    for (int j = 0; j < nk; ++j) {
      float kv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) kv[c] = sm.ks[j][lane + 32 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float ds = sm.ps[warp][i][j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] += ds * kv[c];
      }
    }
    __syncwarp();
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i, t = q0 + r;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      float v2 = acc[i][c];
      for (int w = 0; w < W; ++w) v2 += sm.dsd[r][w] * sm.rks[w][lane + 32 * c];
      dq[base + (size_t)t * D + lane + 32 * c] = v2 * scale;
    }
  }
  // this tile's share of drel_k, drel_v: [bh][tile][w][c]
  float* pk = part_k + ((size_t)bh * gridDim.x + blockIdx.x) * W * D;
  float* pv = part_v + ((size_t)bh * gridDim.x + blockIdx.x) * W * D;
  for (int i = tid; i < W * D; i += blockDim.x) {
    const int w = i / D, c = i % D;
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < BQ; ++r) {
      sk += rnd<BF16>(sm.dsd[r][w]) * sm.qs[r][c];
      sv += rnd<BF16>(sm.pdd[r][w]) * sm.dos[r][c];
    }
    pk[i] = sk;
    pv[i] = sv;
  }
}

template <int D>
struct BwdKVSmem {
  static constexpr int KS = D + 4;
  float qs[BK][KS];         // q̂ rows of the query tile, rounded
  float dos[BK][KS];        // dO rows, rounded
  float ks[BQ][D];          // this block's keys, rounded
  float vs[BQ][D];
  float pt[NWARP][ROWS][BK];  // rounded pd[t, j], j the warp's keys
  float st[NWARP][ROWS][BK];  // rounded ds[t, j]
  float qr[BK][MAXW], dorv[BK][MAXW];
  float lse[BK], dd[BK];
};

template <int D, bool BF16>
__global__ void __launch_bounds__(NWARP * 32)
bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ lse, const float* __restrict__ dout,
              const float* __restrict__ rowd, const float* __restrict__ qrel,
              const float* __restrict__ dorel, float* __restrict__ dk, float* __restrict__ dv,
              int H, int T, int n_rel, int window, uint32_t seed, uint32_t thresh,
              float inv_keep, float scale) {
  constexpr int KS = D + 4;
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) unsigned char raw[];
  BwdKVSmem<D>& sm = *reinterpret_cast<BwdKVSmem<D>*>(raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * BQ;
  const int W = 2 * window + 1;
  const size_t base = (size_t)bh * T * D;

  load_rows<D, BF16>(&sm.ks[0][0], D, k + base, j0, T, 1.f);
  load_rows<D, BF16>(&sm.vs[0][0], D, v + base, j0, T, 1.f);
  float kmask[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int j = j0 + warp * ROWS + i;
    kmask[i] = j < T ? mask[(size_t)b * T + j] : 0.f;
  }
  float gk[ROWS][DPL], gv[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DPL; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int t0 = 0; t0 < T; t0 += BK) {
    __syncthreads();
    load_rows<D, BF16>(&sm.qs[0][0], KS, q + base, t0, T, scale);
    load_rows<D, BF16>(&sm.dos[0][0], KS, dout + base, t0, T, 1.f);
    for (int i = tid; i < BK * W; i += blockDim.x) {
      const int r = i / W, w = i % W, t = t0 + r;
      sm.qr[r][w] = t < T ? qrel[((size_t)bh * T + t) * W + w] : 0.f;
      sm.dorv[r][w] = t < T ? dorel[((size_t)bh * T + t) * W + w] : 0.f;
    }
    if (tid < BK) {
      const int t = t0 + tid;
      sm.lse[tid] = t < T ? lse[(size_t)bh * T + t] : 0.f;
      sm.dd[tid] = t < T ? rowd[(size_t)bh * T + t] : 0.f;
    }
    __syncthreads();

    const int t = t0 + lane;  // this lane's query row
    const uint32_t rk = row_key(seed, bh, t);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int jl = warp * ROWS + i, j = j0 + jl, delta = j - t;
      const bool band = delta >= -window && delta <= window;
      float pd = 0.f, ds = 0.f;
      if (t < T && j < T) {
        float s = dot4<D>(&sm.qs[lane][0], &sm.ks[jl][0]);
        float dpd = dot4<D>(&sm.dos[lane][0], &sm.vs[jl][0]);
        if (band) {
          s += sm.qr[lane][delta + window];
          dpd += sm.dorv[lane][delta + window];
        }
        if (kmask[i] <= 0.f) s = NEG_FILL;
        const float p = expf(s - sm.lse[lane]);
        const float kf = keep_factor(rk, j, thresh, inv_keep);
        pd = p * kf;
        ds = p * (dpd * kf - sm.dd[lane]);
      }
      sm.pt[warp][i][lane] = rnd<BF16>(pd);
      sm.st[warp][i][lane] = rnd<BF16>(ds);
    }
    __syncwarp();
    const int nt = min(BK, T - t0);
    for (int r = 0; r < nt; ++r) {
      float qv[DPL], dov[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        qv[c] = sm.qs[r][lane + 32 * c];
        dov[c] = sm.dos[r][lane + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pw = sm.pt[warp][i][r], sw = sm.st[warp][i][r];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          gv[i][c] += pw * dov[c];
          gk[i][c] += sw * qv[c];
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int j = j0 + warp * ROWS + i;
    if (j >= T) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dk[base + (size_t)j * D + lane + 32 * c] = gk[i][c];
      dv[base + (size_t)j * D + lane + 32 * c] = gv[i][c];
    }
  }
}

template <typename F>
int prepare(F kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// q, k, v, out, dq, dk, dv, dout: [B, H, T, d]; rel_k, rel_v: [n_rel, 2w+1, d];
// mask: [B, T]; lse, rowd: [B, H, T]; qrel, dorel: [B, H, T, 2w+1]; part_k,
// part_v: [B·H, ceil(T/32), 2w+1, d].  All f32, contiguous.  d ∈ {64, 96},
// w ≤ 4.  thresh = rate·2³² (0: no dropout), inv_keep = 1/(1 − rate).
// Every entry returns a cudaError_t as int.
extern "C" int rel_attn_train_tile() { return BQ; }

extern "C" int rel_attn_train_fwd(const float* q, const float* k, const float* v,
                                  const float* rel_k, const float* rel_v, const float* mask,
                                  float* out, float* lse, int B, int H, int T, int d, int n_rel,
                                  int window, int bf16, uint32_t seed, uint32_t thresh,
                                  float rate, void* stream) {
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = d == 96 ? (bf16 ? fwd_kernel<96, true> : fwd_kernel<96, false>)
                        : (bf16 ? fwd_kernel<64, true> : fwd_kernel<64, false>);
  kernel<<<grid, NWARP * 32, 0, s>>>(q, k, v, rel_k, rel_v, mask, out, lse, H, T, n_rel, window,
                                     seed, thresh, inv, scale);
  return (int)cudaGetLastError();
}

extern "C" int rel_attn_train_bwd_q(const float* q, const float* k, const float* v,
                                    const float* rel_k, const float* rel_v, const float* mask,
                                    const float* o, const float* lse, const float* dout,
                                    float* dq, float* rowd, float* qrel, float* dorel,
                                    float* part_k, float* part_v, int B, int H, int T, int d,
                                    int n_rel, int window, int bf16, uint32_t seed,
                                    uint32_t thresh, float rate, void* stream) {
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = d == 96 ? sizeof(BwdQSmem<96>) : sizeof(BwdQSmem<64>);
  auto kernel = d == 96 ? (bf16 ? bwd_q_kernel<96, true> : bwd_q_kernel<96, false>)
                        : (bf16 ? bwd_q_kernel<64, true> : bwd_q_kernel<64, false>);
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, NWARP * 32, smem, s>>>(q, k, v, rel_k, rel_v, mask, o, lse, dout, dq, rowd, qrel,
                                        dorel, part_k, part_v, H, T, n_rel, window, seed, thresh,
                                        inv, scale);
  return (int)cudaGetLastError();
}

extern "C" int rel_attn_train_bwd_kv(const float* q, const float* k, const float* v,
                                     const float* mask, const float* lse, const float* dout,
                                     const float* rowd, const float* qrel, const float* dorel,
                                     float* dk, float* dv, int B, int H, int T, int d, int n_rel,
                                     int window, int bf16, uint32_t seed, uint32_t thresh,
                                     float rate, void* stream) {
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = d == 96 ? sizeof(BwdKVSmem<96>) : sizeof(BwdKVSmem<64>);
  auto kernel = d == 96 ? (bf16 ? bwd_kv_kernel<96, true> : bwd_kv_kernel<96, false>)
                        : (bf16 ? bwd_kv_kernel<64, true> : bwd_kv_kernel<64, false>);
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, NWARP * 32, smem, s>>>(q, k, v, mask, lse, dout, rowd, qrel, dorel, dk, dv, H,
                                        T, n_rel, window, seed, thresh, inv, scale);
  return (int)cudaGetLastError();
}
