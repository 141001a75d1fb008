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
//   fwd      (f32) one block per (batch·head, 32 query rows), keys in tiles
//            of 32 with an online softmax (kernel A's scheme): out and lse.
//   bwd_q    (f32) one block per (batch·head, 32 query rows): D = rowsum(dO ∘ O),
//            q̂·rel_k and dO·rel_v per row (kept for bwd_kv), then over key
//            tiles p = exp(s − lse), dp = (dO·v + band dO·rel_v)·keep/(1−r),
//            ds = p·(dp − D); dq = (ds·k + band ds·rel_k)/√d, and the tile's
//            partial drel_k = Σ_t ds[t, t+δ]·q̂[t], drel_v = Σ_t pd[t, t+δ]·dO[t].
//   bwd_kv   (f32) one block per (batch·head, 32 keys), over query tiles:
//            dk = Σ_t ds[t, j]·q̂[t], dv = Σ_t pd[t, j]·dO[t].
//
// keep(t, j) = hash(seed, b·H + h, t, j) ≥ rate·2³² with the hash below, so
// the mask does not depend on the tiling and the backward regenerates the
// forward's mask bit for bit (the port's plain version computes the same).
//
// bf16 operands (the bf16 forward and backward) round every matmul operand
// to bf16 as the TPU kernel's bf16_compute does (q̂, k, v, dO, rel tables in
// their products, p and ds before their products); the softmax, lse and
// every accumulation stay f32.  The bf16 forward rounds the online softmax's
// unnormalised weights, which agrees with rounding the normalised ones to
// one bf16 rounding.
//
// Bound: 4·T²·d flops forward and 10·T²·d backward per batch-head (five
// T×T products) against ~T·d·4·6 bytes: compute-bound.  The f32 forward and
// backward (fwd, bwd_q, bwd_kv) run on f32 CUDA cores.  The bf16 backward
// (namespace bwd16 below) runs its T×T products on wgmma bf16 with f32
// accumulators, over bf16 copies of q̂, k, v and dO made once a call; the
// bf16 forward (namespace fwd16) on wgmma bf16 too, reading q, k and v in
// place through their strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
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

template <int D>
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

  load_rows<D, false>(&qs[0][0], KS, q + base, q0, T, scale);
  for (int i = tid; i < W * D; i += blockDim.x) rvs[i / D][i % D] = rv[i];
  __syncthreads();
  for (int i = tid; i < BQ * W; i += blockDim.x) {
    const int r = i / W, w = i % W;
    float s = 0.f;
    for (int c = 0; c < D; ++c) s += qs[r][c] * rk[w * D + c];
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
      ks[j][c] = in ? k[base + (size_t)key * D + c] : 0.f;
      vs[j][c] = in ? v[base + (size_t)key * D + c] : 0.f;
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
        const float p = ps[warp][i][j];
        const int delta = k0 + j - (q0 + warp * ROWS + i);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] += p * vv[c];
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

template <int D>
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

  load_rows<D, false>(&sm.qs[0][0], KS, q + base, q0, T, scale);
  load_rows<D, false>(&sm.dos[0][0], KS, dout + base, q0, T, 1.f);
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
      a += sm.qs[r][c] * rk[w * D + c];
      c2 += sm.dos[r][c] * rv[w * D + c];
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
      sm.ks[j][c] = in ? k[base + (size_t)key * D + c] : 0.f;
      sm.vs[j][c] = in ? v[base + (size_t)key * D + c] : 0.f;
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
      sm.ps[warp][i][lane] = ds;
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
      sk += sm.dsd[r][w] * sm.qs[r][c];
      sv += sm.pdd[r][w] * sm.dos[r][c];
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

template <int D>
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

  load_rows<D, false>(&sm.ks[0][0], D, k + base, j0, T, 1.f);
  load_rows<D, false>(&sm.vs[0][0], D, v + base, j0, T, 1.f);
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
    load_rows<D, false>(&sm.qs[0][0], KS, q + base, t0, T, scale);
    load_rows<D, false>(&sm.dos[0][0], KS, dout + base, t0, T, 1.f);
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
      sm.pt[warp][i][lane] = pd;
      sm.st[warp][i][lane] = ds;
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

// ------------------------------------------------------ bf16 backward, wgmma
//
// Two launches a call: prep_kernel, then qkv_kernel, whose blocks take the q
// pass (blockIdx.z = 0) or the kv pass (1).  The passes read only what prep
// wrote, so they share one launch and its waves of blocks.
//   prep   one block per (64-row tile, batch·head): bf16 copies of q̂ =
//          bf16(q·scale), k, v and dO in a tiled layout, each tile of 64
//          rows [d/8][64][8] (so the 8 rows × 16 bytes of a core matrix of
//          wgmma are contiguous, for K-major and MN-major reads alike, and a
//          tile is one bulk copy); per row lse (+inf past T), D = rowsum(dO ∘
//          O) and the row's hash key; per row q̂·rel_k and dO·rel_v; per key
//          1 (kept), 0 (masked) or −1 (past T).  It reads q, k, v and dO as
//          bf16, the type the model hands over, through their strides.
//   q      a warpgroup owns 64 query rows and walks the key tiles, streamed by
//          bulk copies into two buffers: S = q̂·Kᵀ and dPd = dO·Vᵀ (m64n64k16,
//          both operands K-major), p, the keep hash, pd and ds in registers,
//          dQ += ds·K (m64n{d}k16, ds as A from registers, K read MN-major);
//          the band's ds and pd go to shared memory for dq's rel_k term and
//          the tile's partial drel_k, drel_v.
//   kv     a warpgroup owns 64 keys and walks the query tiles: the transposed
//          products Sᵀ = K·q̂ᵀ and dPdᵀ = V·dOᵀ, then dV += pdᵀ·dO and
//          dK += dsᵀ·q̂ with pdᵀ, dsᵀ as A from registers: the accumulator
//          layout of m64n64 is the A fragment layout of k16, so no bf16
//          intermediate goes through shared memory.
// Both passes recompute S and dPd (7 T×T products against the bound's 5) so
// that no sum needs atomics: the gradients are the same bits in every run.
// What bounds it: 10·T²·d bf16 flops per batch-head (25 µs at T = 1024,
// B·H = 24) and ~40 instructions of elementwise work per element and pass
// (exp, the keep hash, the band).  A warpgroup waits for its own products
// before its elementwise work and for that work before its next products;
// only the other block on the SM fills the waits
// (tools/ablate_rel_attention_train.py takes each part out).  The band's
// terms and stores are compiled only into the tile pairs the band crosses.
// ptxas serializes every wgmma of a kernel that calls a function, branches
// divergently or moves accumulators between two of them: the band, the key
// mask and the band's stores are selects, the choice of a banded tile pair
// is made uniform by a shuffle, the copies are predicated inside their asm,
// and 1/(1 − rate) and the scale come from the host.

namespace bwd16 {

constexpr int BT = 64;             // rows (or keys) of a tile: one wgmma M
constexpr int NT = 128;            // one warpgroup a block
constexpr int BAND = 2 * MAXW;     // a row's band record: q̂·rel_k[w], then dO·rel_v[w]
constexpr int BROW = 12;           // a row of the band's ds or pd in shared memory
constexpr uint32_t K_COL = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// one bulk copy global → shared by the thread where `pred` holds, its bytes
// completing on bar (one arrival); predicated inside the asm
__device__ __forceinline__ void bulk_load_if(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n}\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "r"((int)pred)
      : "memory");
}
// shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// × 16 contiguous bytes; lbo bytes between core matrices along K, sbo along
// M or N
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
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

// d (64 × 64, f32) += A (64 × 16) · B (16 × 64), bf16, both K-major in shared memory
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

// d (64 × N, f32) += A (64 × 16, bf16 fragments in registers) · B (16 × N),
// B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}
__device__ __forceinline__ void unpack8(float (&x)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
// 8 bf16 (16 bytes) of a row
__device__ __forceinline__ uint4 ldg8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the dropout factor of (row key, key column): 0 or 1/(1 − rate); 1 without dropout
template <bool DROP>
__device__ __forceinline__ float keep_f(uint32_t rk, uint32_t jk, uint32_t thresh, float inv) {
  if (!DROP) return 1.f;
  return fmix32(rk ^ jk) >= thresh ? inv : 0.f;
}

// one bf16 [B, H, T, d] operand of the call: its pointer and element strides
// of b, h and t (d's is 1)
struct Src {
  const void* p;
  long long sb, sh, st;
};
struct Srcs {
  Src q, k, v, dout;
};

__device__ __forceinline__ const __nv_bfloat16* row_of(const Src& s, int b, int h, int t) {
  return static_cast<const __nv_bfloat16*>(s.p) + b * s.sb + h * s.sh + t * s.st;
}

// prep: one block per (64-row tile, batch·head).  Writes the tile's rows of
// qh, kh, vh, doh ([B·H][Tp/64][d/8][64][8] bf16, zero past T), its part of
// stat ([B·H][Tp/64][3][64]: lse or +inf past T, D, the row's hash key as
// bits), of band ([B·H][Tp][2·MAXW]: q̂·rel_k[w], dO·rel_v[w], zero for
// w ≥ 2w+1) and, for h = 0, of kinfo ([B][Tp]).  q̂ = bf16(q·q_scale):
// q_scale is 1/√d, or 1 where the caller hands over q̂ itself.
template <int D>
__global__ void __launch_bounds__(NT)
prep_kernel(Srcs src, const float* __restrict__ o, const float* __restrict__ lse,
            const float* __restrict__ mask, const float* __restrict__ rel_k,
            const float* __restrict__ rel_v, __nv_bfloat16* __restrict__ qh,
            __nv_bfloat16* __restrict__ kh, __nv_bfloat16* __restrict__ vh,
            __nv_bfloat16* __restrict__ doh, float* __restrict__ stat, float* __restrict__ band,
            float* __restrict__ kinfo, int H, int T, int Tp, int n_rel, int window,
            uint32_t seed, float q_scale) {
  constexpr int NC = D / 8, TILE = NC * BT * 8, RS = D + 4;
  __shared__ __align__(16) __nv_bfloat16 qs[TILE], ds[TILE];
  __shared__ __align__(16) float rks[MAXW * RS], rvs[MAXW * RS];   // rows padded: the band
  __shared__ float dsum[BT][NC + 1];                                 // loop's w hit other banks
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, t0 = tile * BT;
  const int W = 2 * window + 1, nt = Tp / BT;
  const size_t at0 = ((size_t)bh * nt + tile) * TILE;
  // the copies, and D = rowsum(dO ∘ O) in f32 as 8-column partial sums
  for (int i = tid; i < BT * NC; i += NT) {
    const int r = i / NC, c = i - r * NC, t = t0 + r;
    uint4 pq = make_uint4(0, 0, 0, 0), pk = pq, pv = pq, pd = pq;
    float part = 0.f;
    if (t < T) {
      float x[8], y[8];
      unpack8(x, ldg8(row_of(src.q, b, h, t) + 8 * c));
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = pack2(x[2 * e] * q_scale, x[2 * e + 1] * q_scale);
      pq = make_uint4(w[0], w[1], w[2], w[3]);
      pk = ldg8(row_of(src.k, b, h, t) + 8 * c);
      pv = ldg8(row_of(src.v, b, h, t) + 8 * c);
      pd = ldg8(row_of(src.dout, b, h, t) + 8 * c);
      unpack8(x, pd);
      load8(y, o + ((size_t)bh * T + t) * D + 8 * c);
#pragma unroll
      for (int e = 0; e < 8; ++e) part += x[e] * y[e];
    }
    dsum[r][c] = part;
    const size_t at = ((size_t)c * BT + r) * 8;
    *reinterpret_cast<uint4*>(qh + at0 + at) = pq;
    *reinterpret_cast<uint4*>(kh + at0 + at) = pk;
    *reinterpret_cast<uint4*>(vh + at0 + at) = pv;
    *reinterpret_cast<uint4*>(doh + at0 + at) = pd;
    *reinterpret_cast<uint4*>(qs + at) = pq;
    *reinterpret_cast<uint4*>(ds + at) = pd;
  }
  const size_t rel = (size_t)(n_rel > 1 ? h : 0) * W * D;
  for (int i = tid; i < MAXW * D; i += NT) {
    const bool in = i < W * D;
    const int at = (i / D) * RS + i % D;
    rks[at] = in ? rnd<true>(rel_k[rel + i]) : 0.f;
    rvs[at] = in ? rnd<true>(rel_v[rel + i]) : 0.f;
  }
  __syncthreads();
  if (tid < BT) {
    const int t = t0 + tid;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) d += dsum[tid][c];
    float* st = stat + ((size_t)bh * nt + tile) * 3 * BT;
    const uint32_t bkey = fmix32(seed ^ (uint32_t)(bh + 1) * 0x9E3779B1u);
    st[tid] = t < T ? lse[(size_t)bh * T + t] : INFINITY;
    st[BT + tid] = d;
    st[2 * BT + tid] = __uint_as_float(fmix32(bkey ^ (uint32_t)(t + 1) * 0x85EBCA77u));
    if (h == 0)
      kinfo[(size_t)b * Tp + t] = t < T ? (mask[(size_t)b * T + t] > 0.f ? 1.f : 0.f) : -1.f;
  }
  // q̂·rel_k[w] and dO·rel_v[w] of each row, bf16 operands, f32 sums
  for (int i = tid; i < BT * MAXW; i += NT) {
    const int r = i / MAXW, w = i - r * MAXW;
    float sq = 0.f, sd = 0.f;
#pragma unroll 4
    for (int c = 0; c < NC; ++c) {
      float a[8], e[8];
      unpack8(a, *reinterpret_cast<const uint4*>(qs + (c * BT + r) * 8));
      unpack8(e, *reinterpret_cast<const uint4*>(ds + (c * BT + r) * 8));
      const float4* kq = reinterpret_cast<const float4*>(rks + w * RS + 8 * c);
      const float4* kd = reinterpret_cast<const float4*>(rvs + w * RS + 8 * c);
      const float4 k0 = kq[0], k1 = kq[1], d0 = kd[0], d1 = kd[1];
      sq += a[0] * k0.x + a[1] * k0.y + a[2] * k0.z + a[3] * k0.w + a[4] * k1.x + a[5] * k1.y +
            a[6] * k1.z + a[7] * k1.w;
      sd += e[0] * d0.x + e[1] * d0.y + e[2] * d0.z + e[3] * d0.w + e[4] * d1.x + e[5] * d1.y +
            e[6] * d1.z + e[7] * d1.w;
    }
    float* row = band + ((size_t)bh * Tp + t0 + r) * BAND;
    row[w] = sq;
    row[MAXW + w] = sd;
  }
}

template <int D>
struct QSmem {
  static constexpr int TILE = D / 8 * BT * 8;
  __nv_bfloat16 q[TILE], dout[TILE];      // this block's rows
  __nv_bfloat16 kv[2][2][TILE];           // key tiles, two buffers: k, v
  float ki[2][BT];                        // their kinfo
  float st[3][BT];                        // this block's rows: lse, D, hash key
  float band[BT][BAND];
  float rk[MAXW][D];                      // rel_k in f32, for dq's band term
  float dsd[BT][BROW], pdd[BT][BROW];     // the band's ds and pd, f32
  float sink[NT];                         // where the stores off the band go
  uint64_t bar[3];                        // own rows; key buffers 0 and 1
};

template <int D>
struct KVSmem {
  static constexpr int TILE = D / 8 * BT * 8;
  __nv_bfloat16 k[TILE], v[TILE];         // this block's keys
  __nv_bfloat16 q[2][TILE], dout[2][TILE];  // query tiles, two buffers
  float st[2][3][BT];
  float band[2][BT][BAND];
  float ki[BT];
  uint64_t bar[3];                        // keys; query buffers 0 and 1
};

static_assert(offsetof(QSmem<96>, ki) % 16 == 0 && offsetof(QSmem<96>, st) % 16 == 0 &&
              offsetof(QSmem<96>, band) % 16 == 0 && offsetof(QSmem<64>, band) % 16 == 0 &&
              offsetof(KVSmem<96>, st) % 16 == 0 && offsetof(KVSmem<96>, band) % 16 == 0 &&
              offsetof(KVSmem<96>, ki) % 16 == 0 && offsetof(KVSmem<64>, ki) % 16 == 0,
              "bulk copies need 16-byte aligned destinations");

// a tile pair the band crosses, or one it does not
template <bool B>
struct Banded {
  static constexpr bool value = B;
};

// the A fragments of a k16 step from an m64n64 accumulator's values, two
// n8 blocks (i = 2kk, 2kk + 1) a step: a[kk][2·(i & 1) + hr] holds rows
// g + 8·hr, columns 8i + 2tq and 8i + 2tq + 1
__device__ __forceinline__ void to_frag(uint32_t (&a)[4][4], int i, int hr, float x0, float x1) {
  a[i >> 1][2 * (i & 1) + hr] = pack2(x0, x1);
}

template <int D, bool DROP>
__device__ __forceinline__ void
q_pass(unsigned char* raw, const __nv_bfloat16* __restrict__ qh,
       const __nv_bfloat16* __restrict__ kh, const __nv_bfloat16* __restrict__ vh,
       const __nv_bfloat16* __restrict__ doh, const float* __restrict__ stat,
       const float* __restrict__ band, const float* __restrict__ kinfo,
       const float* __restrict__ rel_k, float* __restrict__ dq, float* __restrict__ part_k,
       float* __restrict__ part_v, int H, int T, int Tp, int n_rel, int window, uint32_t thresh,
       float inv_keep, float scale) {
  constexpr int TILE = QSmem<D>::TILE, NA = D / 2;
  QSmem<D>& sm = *reinterpret_cast<QSmem<D>*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, t0 = tile * BT;
  const int W = 2 * window + 1, nt = Tp / BT;
  const bool lead = tid == 0;
  if (lead) {
    mbar_init(&sm.bar[0], 4);
    mbar_init(&sm.bar[1], 3);
    mbar_init(&sm.bar[2], 3);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t own = ((size_t)bh * nt + tile) * TILE;
  bulk_load_if(sm.q, qh + own, TILE * 2, &sm.bar[0], lead);
  bulk_load_if(sm.dout, doh + own, TILE * 2, &sm.bar[0], lead);
  bulk_load_if(sm.st, stat + ((size_t)bh * nt + tile) * 3 * BT, 3 * BT * 4, &sm.bar[0], lead);
  bulk_load_if(sm.band, band + ((size_t)bh * Tp + t0) * BAND, BT * BAND * 4, &sm.bar[0], lead);
  // key tile kt into buffer kt & 1
  auto load_keys = [&](int kt, bool pred) {
    const size_t at = ((size_t)bh * nt + kt) * TILE;
    uint64_t* bar = &sm.bar[1 + (kt & 1)];
    bulk_load_if(sm.kv[kt & 1][0], kh + at, TILE * 2, bar, pred);
    bulk_load_if(sm.kv[kt & 1][1], vh + at, TILE * 2, bar, pred);
    bulk_load_if(sm.ki[kt & 1], kinfo + (size_t)b * Tp + kt * BT, BT * 4, bar, pred);
  };
  load_keys(0, lead);
  const size_t rel = (size_t)(n_rel > 1 ? h : 0) * W * D;
  for (int i = tid; i < MAXW * D; i += NT) (&sm.rk[0][0])[i] = i < W * D ? rel_k[rel + i] : 0.f;
  for (int i = tid; i < BT * BROW; i += NT) (&sm.dsd[0][0])[i] = (&sm.pdd[0][0])[i] = 0.f;
  __syncthreads();
  mbar_wait(&sm.bar[0], 0);

  int rl[2];
  float lse_r[2], dd_r[2];
  uint32_t rk_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rl[hr] = 16 * warp + g + 8 * hr;
    lse_r[hr] = sm.st[0][rl[hr]];
    dd_r[hr] = sm.st[1][rl[hr]];
    rk_r[hr] = __float_as_uint(sm.st[2][rl[hr]]);
  }
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  fence_acc(acc);

  for (int kt = 0; kt < nt; ++kt) {
    const int buf = kt & 1;
    load_keys(kt + 1, lead && kt + 1 < nt);
    mbar_wait(&sm.bar[1 + buf], (kt >> 1) & 1);
    const __nv_bfloat16* ks = sm.kv[buf][0];
    const __nv_bfloat16* vs = sm.kv[buf][1];
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_n64(s, smem_desc(sm.q + 2 * k * BT * 8, BT * 16, 128),
                smem_desc(ks + 2 * k * BT * 8, BT * 16, 128));
    wg_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_n64(dp, smem_desc(sm.dout + 2 * k * BT * 8, BT * 16, 128),
                smem_desc(vs + 2 * k * BT * 8, BT * 16, 128));
    wg_commit();
    wg_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    uint32_t a[4][4];
    const int k0 = kt * BT;
    // the elements of this tile pair: p, pd, ds; the band's terms and
    // stores only on the tiles it crosses (a warp-uniform choice)
    auto step = [&](auto tag) {
      constexpr bool banded = decltype(tag)::value;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float o2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * hr + e, jl = 8 * i + 2 * tq + e, j = k0 + jl;
            const int delta = j - (t0 + rl[hr]);
            const bool in_band = banded && delta >= -window && delta <= window;
            const int bi = min(max(delta + window, 0), MAXW - 1);
            const float kin = sm.ki[buf][jl];
            float sc = s[x] + (in_band ? sm.band[rl[hr]][bi] : 0.f);
            sc = kin > 0.f ? sc : NEG_FILL;
            const float p = kin >= 0.f ? __expf(sc - lse_r[hr]) : 0.f;
            const float kf = keep_f<DROP>(rk_r[hr], (uint32_t)(j + 1) * K_COL, thresh, inv_keep);
            const float dpd = dp[x] + (in_band ? sm.band[rl[hr]][MAXW + bi] : 0.f);
            const float dsv = p * (dpd * kf - dd_r[hr]);
            if (banded) {
              *(in_band ? &sm.dsd[rl[hr]][bi] : &sm.sink[tid]) = dsv;
              *(in_band ? &sm.pdd[rl[hr]][bi] : &sm.sink[tid]) = p * kf;
            }
            o2[e] = dsv;
          }
          to_frag(a, i, hr, o2[0], o2[1]);
        }
    };
    if (__shfl_sync(0xffffffffu, abs(kt - tile) <= 1, 0))
      step(Banded<true>{});
    else
      step(Banded<false>{});
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, a[kk], smem_desc(ks + 16 * kk * 8, 128, BT * 16));
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
    __syncthreads();
  }

  // dq = (ds·k + band(ds)·rel_k)·scale
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rl[hr], c = 8 * i + 2 * tq;
      float v0 = acc[4 * i + 2 * hr], v1 = acc[4 * i + 2 * hr + 1];
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        v0 += sm.dsd[r][w] * sm.rk[w][c];
        v1 += sm.dsd[r][w] * sm.rk[w][c + 1];
      }
      if (t0 + r < T)
        *reinterpret_cast<float2*>(dq + ((size_t)bh * T + t0 + r) * D + c) =
            make_float2(v0 * scale, v1 * scale);
    }
  // this tile's share of drel_k, drel_v: [B·H][Tp/64][2w+1][d], one column a thread
  if (tid < D) {
    const int c = tid;
    float sk[MAXW], sv[MAXW];
#pragma unroll
    for (int w = 0; w < MAXW; ++w) sk[w] = sv[w] = 0.f;
    for (int r = 0; r < BT; ++r) {
      const int at = ((c >> 3) * BT + r) * 8 + (c & 7);
      const float qv = bf(sm.q[at]), dv = bf(sm.dout[at]);
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        sk[w] += rnd<true>(sm.dsd[r][w]) * qv;
        sv[w] += rnd<true>(sm.pdd[r][w]) * dv;
      }
    }
    float* pk = part_k + ((size_t)bh * nt + tile) * W * D;
    float* pv = part_v + ((size_t)bh * nt + tile) * W * D;
#pragma unroll
    for (int w = 0; w < MAXW; ++w)
      if (w < W) {
        pk[w * D + c] = sk[w];
        pv[w * D + c] = sv[w];
      }
  }
}

template <int D, bool DROP>
__device__ __forceinline__ void
kv_pass(unsigned char* raw, const __nv_bfloat16* __restrict__ qh,
        const __nv_bfloat16* __restrict__ kh, const __nv_bfloat16* __restrict__ vh,
        const __nv_bfloat16* __restrict__ doh, const float* __restrict__ stat,
        const float* __restrict__ band, const float* __restrict__ kinfo, float* __restrict__ dk,
        float* __restrict__ dv, int H, int T, int Tp, int window, uint32_t thresh,
        float inv_keep) {
  constexpr int TILE = KVSmem<D>::TILE, NA = D / 2;
  KVSmem<D>& sm = *reinterpret_cast<KVSmem<D>*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / H, j0 = tile * BT;
  const int nt = Tp / BT;
  const bool lead = tid == 0;
  if (lead) {
    mbar_init(&sm.bar[0], 3);
    mbar_init(&sm.bar[1], 4);
    mbar_init(&sm.bar[2], 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t own = ((size_t)bh * nt + tile) * TILE;
  bulk_load_if(sm.k, kh + own, TILE * 2, &sm.bar[0], lead);
  bulk_load_if(sm.v, vh + own, TILE * 2, &sm.bar[0], lead);
  bulk_load_if(sm.ki, kinfo + (size_t)b * Tp + j0, BT * 4, &sm.bar[0], lead);
  // query tile qt into buffer qt & 1
  auto load_queries = [&](int qt, bool pred) {
    const size_t at = ((size_t)bh * nt + qt) * TILE;
    const int bf_ = qt & 1;
    uint64_t* bar = &sm.bar[1 + bf_];
    bulk_load_if(sm.q[bf_], qh + at, TILE * 2, bar, pred);
    bulk_load_if(sm.dout[bf_], doh + at, TILE * 2, bar, pred);
    bulk_load_if(sm.st[bf_], stat + ((size_t)bh * nt + qt) * 3 * BT, 3 * BT * 4, bar, pred);
    bulk_load_if(sm.band[bf_], band + ((size_t)bh * Tp + qt * BT) * BAND, BT * BAND * 4, bar,
                 pred);
  };
  load_queries(0, lead);
  mbar_wait(&sm.bar[0], 0);

  int jl[2];
  float kin[2];
  uint32_t jk[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    jl[hr] = 16 * warp + g + 8 * hr;
    kin[hr] = sm.ki[jl[hr]];
    jk[hr] = (uint32_t)(j0 + jl[hr] + 1) * K_COL;
  }
  float gk[NA], gv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) gk[i] = gv[i] = 0.f;
  fence_acc(gk);
  fence_acc(gv);

  for (int qt = 0; qt < nt; ++qt) {
    const int buf = qt & 1;
    load_queries(qt + 1, lead && qt + 1 < nt);
    mbar_wait(&sm.bar[1 + buf], (qt >> 1) & 1);
    const __nv_bfloat16* qs = sm.q[buf];
    const __nv_bfloat16* dos = sm.dout[buf];
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_n64(s, smem_desc(sm.k + 2 * k * BT * 8, BT * 16, 128),
                smem_desc(qs + 2 * k * BT * 8, BT * 16, 128));
    wg_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_n64(dp, smem_desc(sm.v + 2 * k * BT * 8, BT * 16, 128),
                smem_desc(dos + 2 * k * BT * 8, BT * 16, 128));
    wg_commit();
    wg_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    uint32_t apd[4][4], ads[4][4];
    const int t0 = qt * BT;
    auto step = [&](auto tag) {
      constexpr bool banded = decltype(tag)::value;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float pd2[2], ds2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * hr + e, tl = 8 * i + 2 * tq + e;
            const int delta = j0 + jl[hr] - (t0 + tl);
            const bool in_band = banded && delta >= -window && delta <= window;
            const int bi = min(max(delta + window, 0), MAXW - 1);
            float sc = s[x] + (in_band ? sm.band[buf][tl][bi] : 0.f);
            sc = kin[hr] > 0.f ? sc : NEG_FILL;
            const float p = kin[hr] >= 0.f ? __expf(sc - sm.st[buf][0][tl]) : 0.f;
            const float kf =
                keep_f<DROP>(__float_as_uint(sm.st[buf][2][tl]), jk[hr], thresh, inv_keep);
            const float dpd = dp[x] + (in_band ? sm.band[buf][tl][MAXW + bi] : 0.f);
            pd2[e] = p * kf;
            ds2[e] = p * (dpd * kf - sm.st[buf][1][tl]);
          }
          to_frag(apd, i, hr, pd2[0], pd2[1]);
          to_frag(ads, i, hr, ds2[0], ds2[1]);
        }
    };
    if (__shfl_sync(0xffffffffu, abs(qt - tile) <= 1, 0))
      step(Banded<true>{});
    else
      step(Banded<false>{});
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(gv, apd[kk], smem_desc(dos + 16 * kk * 8, 128, BT * 16));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(gk, ads[kk], smem_desc(qs + 16 * kk * 8, 128, BT * 16));
    wg_commit();
    wg_wait<0>();
    fence_acc(gk);
    fence_acc(gv);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = j0 + jl[hr], c = 8 * i + 2 * tq;
      if (j < T) {
        const size_t at = ((size_t)bh * T + j) * D + c;
        const int x = 4 * i + 2 * hr;
        *reinterpret_cast<float2*>(dk + at) = make_float2(gk[x], gk[x + 1]);
        *reinterpret_cast<float2*>(dv + at) = make_float2(gv[x], gv[x + 1]);
      }
    }
}

// both passes in one launch, so that they share the waves of blocks:
// blockIdx.z = 0 is the q pass, 1 the kv pass (a choice uniform in a block)
template <int D, bool DROP>
__global__ void __launch_bounds__(NT, 1)
qkv_kernel(const __nv_bfloat16* __restrict__ qh, const __nv_bfloat16* __restrict__ kh,
           const __nv_bfloat16* __restrict__ vh, const __nv_bfloat16* __restrict__ doh,
           const float* __restrict__ stat, const float* __restrict__ band,
           const float* __restrict__ kinfo, const float* __restrict__ rel_k,
           float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
           float* __restrict__ part_k, float* __restrict__ part_v, int H, int T, int Tp,
           int n_rel, int window, uint32_t thresh, float inv_keep, float scale) {
  extern __shared__ __align__(128) unsigned char raw[];
  if (blockIdx.z == 0)
    q_pass<D, DROP>(raw, qh, kh, vh, doh, stat, band, kinfo, rel_k, dq, part_k, part_v, H, T,
                    Tp, n_rel, window, thresh, inv_keep, scale);
  else
    kv_pass<D, DROP>(raw, qh, kh, vh, doh, stat, band, kinfo, dk, dv, H, T, Tp, window, thresh,
                     inv_keep);
}

template <int D>
constexpr size_t QKV_SMEM = sizeof(QSmem<D>) > sizeof(KVSmem<D>) ? sizeof(QSmem<D>)
                                                                  : sizeof(KVSmem<D>);

template <int D>
int backward(const Srcs& src, const float* o, const float* lse, const float* mask,
             const float* rel_k, const float* rel_v, __nv_bfloat16* qh, __nv_bfloat16* kh,
             __nv_bfloat16* vh, __nv_bfloat16* doh, float* stat, float* band, float* kinfo,
             float* dq, float* dk, float* dv, float* part_k, float* part_v, int B, int H, int T,
             int n_rel, int window, uint32_t seed, uint32_t thresh, float inv, float scale,
             float q_scale, cudaStream_t s) {
  const int Tp = (T + BT - 1) / BT * BT;
  const dim3 grid(Tp / BT, B * H);
  auto qkv = thresh ? qkv_kernel<D, true> : qkv_kernel<D, false>;
  const int err = prepare(qkv, QKV_SMEM<D>);
  if (err) return err;
  prep_kernel<D><<<grid, NT, 0, s>>>(src, o, lse, mask, rel_k, rel_v, qh, kh, vh, doh, stat, band,
                                     kinfo, H, T, Tp, n_rel, window, seed, q_scale);
  qkv<<<dim3(grid.x, grid.y, 2), NT, QKV_SMEM<D>, s>>>(qh, kh, vh, doh, stat, band, kinfo, rel_k,
                                                       dq, dk, dv, part_k, part_v, H, T, Tp,
                                                       n_rel, window, thresh, inv, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd16

// ------------------------------------------------------- bf16 forward, wgmma
//
// One launch a call.  A block owns FWD_ROWS query rows of one batch·head, 64
// a warpgroup, and walks the key tiles of 64 keys:
//   q̂ = bf16(q·q_scale) lands once in shared memory, in the [d/8][rows][8]
//   layout of the backward's tiles, and each row's band record q̂·rel_k[w]
//   comes from one more product (m64n16k16, rel_k in bf16, w ≥ 2w+1 zero);
//   key and value tiles, two buffers, arrive by 16-byte cp.async from the
//   strided bf16 rows (the step's [B, T, H, d] views are not contiguous, so
//   no bulk copy), zeros past T: tile kt + 1 is in flight while tile kt is
//   computed;
//   S = q̂·Kᵀ (m64n64k16, both operands K-major); the band's q̂·rel_k only
//   on the tile pairs it crosses; −1e4 for a masked key, −∞ past T; the
//   online max (a row's 64 columns lie in one quad: two shuffles) rescales
//   the accumulator and the thread's partial row sum; p = exp(s − m), times
//   the keep factor, rounded to bf16 into A fragments; O += P·V
//   (m64n{d}k16, V read MN-major);
//   the band's scores go to shared memory (−∞ where the key is dropped), and
//   the epilogue adds Σ_w exp(s_w − lse)·rel_v[w]/(1 − rate) in f32 once lse
//   is known: no band sum is rescaled in the loop.
// Epilogue: out = O/l plus the band term, lse = m + log l; rows past T are
// not stored.  The bound is 4·T²·d bf16 flops per batch-head (9.8 µs at
// T = 1024, B·H = 24); every block also reads each key and value tile of its
// batch·head from L2 (151 MB at T = 1024, B·H = 24).  What bounds it is the
// latency of a block's phases in turn (copies, products, the elementwise
// softmax with its keep hash, the band), which only the other block on the
// SM fills (239 registers a thread at d = 96): taking the products out
// saves a quarter of the time (tools/ablate_rel_attention_train.py takes
// each part out).  So a block keeps no more than its 64 rows, the band's
// terms are compiled only into the tile pairs it crosses, and the band
// record is a product, not a per-row loop.  ptxas keeps the wgmma
// unserialized as in the backward: selects, a shuffle-uniform choice of a
// banded tile pair, copies predicated inside their asm, an approximate
// reciprocal and log.

namespace fwd16 {

using namespace bwd16;

constexpr int FWD_WGS = 1;                   // warpgroups a block
constexpr int FWD_ROWS = BT * FWD_WGS;       // query rows a block, 64 a warpgroup
constexpr int FWD_THREADS = 128 * FWD_WGS;

// a small table of the call, f32 or bf16: rel_k, rel_v or the key mask
struct Tab {
  const void* p;
  int bf16;
};
__device__ __forceinline__ float tab_at(const Tab& t, size_t i) {
  return t.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(t.p)[i])
                : static_cast<const float*>(t.p)[i];
}

// 16 bytes global → shared by cp.async where pred holds, src_bytes of them
// read and the rest zero; predicated inside the asm
__device__ __forceinline__ void cp16_if(void* dst, const void* src, uint32_t src_bytes,
                                        bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes), "r"((int)pred) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, seen by wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 × 16, f32) += A (64 × 16) · B (16 × 16), bf16, both K-major in shared memory
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <int D>
struct Smem {
  static constexpr int TILE = D / 8 * BT * 8;
  __nv_bfloat16 q[D / 8 * FWD_ROWS * 8];  // q̂ of the block's rows, [d/8][rows][8]
  __nv_bfloat16 kv[2][2][TILE];           // key and value tiles, two buffers
  __nv_bfloat16 rk[D / 8 * 16 * 8];       // rel_k in bf16, [d/8][16][8], zero past 2w+1
  float rv[MAXW][D];                      // rel_v, f32
  float qr[FWD_ROWS][16];                 // each row's q̂·rel_k[w]
  float bs[FWD_ROWS][BROW];               // the band's scores, −∞ where dropped or absent
  float km[2][BT];                        // the key mask of each buffer's keys
  float sink[FWD_THREADS];                // where the stores off the band go
};

static_assert(offsetof(Smem<96>, kv) % 16 == 0 && offsetof(Smem<96>, rk) % 16 == 0 &&
              offsetof(Smem<64>, kv) % 16 == 0 && offsetof(Smem<64>, rk) % 16 == 0,
              "wgmma tiles need 16-byte alignment");

template <int D, bool DROP>
__global__ void __launch_bounds__(FWD_THREADS)
attn_kernel(Src q, Src k, Src v, Tab rel_k, Tab rel_v, Tab mask, float* __restrict__ out,
            float* __restrict__ lse, int H, int T, int n_rel, int window, uint32_t seed,
            uint32_t thresh, float inv_keep, float q_scale) {
  constexpr int NC = D / 8, NA = D / 2, ROWS = FWD_ROWS, NTH = FWD_THREADS;
  extern __shared__ __align__(128) unsigned char raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), wg = warp >> 2;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, t0 = blockIdx.x * ROWS;
  const int qtile = blockIdx.x * FWD_WGS + wg;     // this warpgroup's 64-row tile
  const int W = 2 * window + 1, nk = (T + BT - 1) / BT;

  // key and value tile kt into buffer kt & 1, in 16-byte pieces: two chunks
  // of a row to neighbouring threads (one 32-byte sector), zeros past T
  const __nv_bfloat16* kv0[2] = {row_of(k, b, h, 0), row_of(v, b, h, 0)};
  const long long kv_st[2] = {k.st, v.st};
  auto load_kv = [&](int kt, bool pred) {
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int it = 0; it < BT * NC / NTH; ++it) {
        const int i = tid + it * NTH, r = (i >> 1) % BT, c = (i / (2 * BT)) * 2 + (i & 1);
        const int t = kt * BT + r;
        cp16_if(sm.kv[kt & 1][x] + (c * BT + r) * 8, kv0[x] + min(t, T - 1) * kv_st[x] + 8 * c,
                t < T ? 16u : 0u, pred);
      }
    cp_commit();
  };
  // the key mask of this thread's key of tile kt (threads 64 apart share one)
  auto mask_of = [&](int kt) {
    return tab_at(mask, (size_t)b * T + min(kt * BT + (tid & (BT - 1)), T - 1));
  };
  load_kv(0, true);

  // q̂ of the block's rows, rounded once; the rel tables; the band's scores
  // start at −∞
#pragma unroll
  for (int it = 0; it < ROWS * NC / NTH; ++it) {
    const int i = tid + it * NTH, r = (i >> 1) % ROWS, c = (i / (2 * ROWS)) * 2 + (i & 1);
    const int t = t0 + r;
    float x[8];
    unpack8(x, ldg8(row_of(q, b, h, min(t, T - 1)) + 8 * c));
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = t < T ? pack2(x[2 * e] * q_scale, x[2 * e + 1] * q_scale) : 0u;
    *reinterpret_cast<uint4*>(sm.q + (c * ROWS + r) * 8) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const size_t rel = (size_t)(n_rel > 1 ? h : 0) * W * D;
  for (int i = tid; i < 16 * D; i += NTH) {
    const int w = i / D, c = i - w * D;
    const bool in = w < W;
    sm.rk[((c >> 3) * 16 + w) * 8 + (c & 7)] =
        __float2bfloat16_rn(in ? tab_at(rel_k, rel + i) : 0.f);
    if (w < MAXW) sm.rv[w][c] = in ? tab_at(rel_v, rel + i) : 0.f;
  }
  for (int i = tid; i < ROWS * BROW; i += NTH) (&sm.bs[0][0])[i] = -INFINITY;
  sm.km[0][tid & (BT - 1)] = mask_of(0);
  fence_async_smem();
  __syncthreads();

  int rl[2];
  float m_r[2], l_r[2];
  uint32_t rk_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rl[hr] = 16 * warp + g + 8 * hr;
    m_r[hr] = -INFINITY;
    l_r[hr] = 0.f;                 // this thread's share of the row sum
    rk_r[hr] = row_key(seed, bh, t0 + rl[hr]);
  }
  const __nv_bfloat16* qw = sm.q + wg * BT * 8;   // this warpgroup's rows
  // each row's q̂·rel_k[w]: bf16 operands, f32 sums
  {
    float qrr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) qrr[i] = 0.f;
    fence_acc(qrr);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_n16(qrr, smem_desc(qw + 2 * kc * ROWS * 8, ROWS * 16, 128),
                smem_desc(sm.rk + 2 * kc * 16 * 8, 16 * 16, 128));
    wg_commit();
    wg_wait<0>();
    fence_acc(qrr);
#pragma unroll
    for (int i = 0; i < 8; ++i) sm.qr[rl[(i >> 1) & 1]][8 * (i >> 2) + 2 * tq + (i & 1)] = qrr[i];
  }
  float o[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) o[i] = 0.f;
  fence_acc(o);

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_wait_all();        // this thread's pieces of tile kt
    fence_async_smem();
    __syncthreads();      // every thread's pieces and tile kt's mask; tile kt − 1's buffer free
    load_kv(kt + 1, kt + 1 < nk);
    const float mk = mask_of(kt + 1);    // stored once this tile is done
    const __nv_bfloat16* ks = sm.kv[buf][0];
    const __nv_bfloat16* vs = sm.kv[buf][1];
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_acc(s);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_n64(s, smem_desc(qw + 2 * kc * ROWS * 8, ROWS * 16, 128),
                smem_desc(ks + 2 * kc * BT * 8, BT * 16, 128));
    wg_commit();
    wg_wait<0>();
    fence_acc(s);

    uint32_t pf[4][4];
    float corr[2];
    const int k0 = kt * BT;
    // the tile's scores, the online softmax, p's fragments; the band's terms
    // and stores only on the tile pairs it crosses (a warp-uniform choice)
    auto softmax = [&](auto tag) {
      constexpr bool banded = decltype(tag)::value;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * hr + e, jl = 8 * i + 2 * tq + e, j = k0 + jl;
            const int delta = j - (t0 + rl[hr]);
            const bool in_band = banded && delta >= -window && delta <= window;
            const int bi = min(max(delta + window, 0), MAXW - 1);
            float sc = s[x] + (in_band ? sm.qr[rl[hr]][bi] : 0.f);
            sc = sm.km[buf][jl] > 0.f ? sc : NEG_FILL;
            s[x] = j < T ? sc : -INFINITY;
          }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mt = m_r[hr];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mt = fmaxf(mt, fmaxf(s[4 * i + 2 * hr], s[4 * i + 2 * hr + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        corr[hr] = __expf(m_r[hr] - mt);
        m_r[hr] = mt;
        l_r[hr] *= corr[hr];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float o2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * i + 2 * hr + e, j = k0 + 8 * i + 2 * tq + e;
            const int delta = j - (t0 + rl[hr]);
            const bool in_band = banded && delta >= -window && delta <= window;
            const int bi = min(max(delta + window, 0), MAXW - 1);
            const float p = __expf(s[x] - m_r[hr]);
            l_r[hr] += p;
            const float kf = keep_f<DROP>(rk_r[hr], (uint32_t)(j + 1) * K_COL, thresh, inv_keep);
            if (banded)
              *(in_band ? &sm.bs[rl[hr]][bi] : &sm.sink[tid]) = kf > 0.f ? s[x] : -INFINITY;
            o2[e] = p * kf;
          }
          to_frag(pf, i, hr, o2[0], o2[1]);
        }
    };
    if (__shfl_sync(0xffffffffu, abs(kt - qtile) <= 1, 0))
      softmax(Banded<true>{});
    else
      softmax(Banded<false>{});
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] *= corr[e >> 1];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, pf[kk], smem_desc(vs + 16 * kk * 8, 128, BT * 16));
    wg_commit();
    wg_wait<0>();
    fence_acc(o);
    sm.km[buf ^ 1][tid & (BT - 1)] = mk;
  }
  __syncthreads();        // the band's scores

  // out = O/l + Σ_w p_w·rel_v[w] with the band's p_w = exp(s_w − lse)/(1 − rate)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lse_r = m_r[hr] + __logf(l), inv_l = __fdividef(1.f, l);
    const int r = rl[hr], t = t0 + r;
    float pb[MAXW];
#pragma unroll
    for (int w = 0; w < MAXW; ++w) pb[w] = inv_keep * __expf(sm.bs[r][w] - lse_r);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + 2 * tq;
      float v0 = o[4 * i + 2 * hr] * inv_l, v1 = o[4 * i + 2 * hr + 1] * inv_l;
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        v0 += pb[w] * sm.rv[w][c];
        v1 += pb[w] * sm.rv[w][c + 1];
      }
      if (t < T)
        *reinterpret_cast<float2*>(out + ((size_t)bh * T + t) * D + c) = make_float2(v0, v1);
    }
    if (t < T && tq == 0) lse[(size_t)bh * T + t] = lse_r;
  }
}

template <int D, bool DROP>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(attn_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem<D>));
}

}  // namespace fwd16

}  // namespace

// q, k, v, out, dq, dk, dv, dout: [B, H, T, d]; rel_k, rel_v: [n_rel, 2w+1, d];
// mask: [B, T]; lse, rowd: [B, H, T]; qrel, dorel: [B, H, T, 2w+1]; part_k,
// part_v: [B·H, ceil(T/32), 2w+1, d].  All f32, contiguous.  d ∈ {64, 96},
// w ≤ 4.  thresh = rate·2³² (0: no dropout), inv_keep = 1/(1 − rate).
// rel_attn_train_fwd, _bwd_q and _bwd_kv are the f32 forward and backward;
// the bf16 ones are rel_attn_train_fwd_bf16 and rel_attn_train_bwd_bf16.
// Every entry returns a cudaError_t as int.
extern "C" int rel_attn_train_tile() { return BQ; }

extern "C" int rel_attn_train_fwd(const float* q, const float* k, const float* v,
                                  const float* rel_k, const float* rel_v, const float* mask,
                                  float* out, float* lse, int B, int H, int T, int d, int n_rel,
                                  int window, uint32_t seed, uint32_t thresh, float rate,
                                  void* stream) {
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = d == 96 ? fwd_kernel<96> : fwd_kernel<64>;
  kernel<<<grid, NWARP * 32, 0, s>>>(q, k, v, rel_k, rel_v, mask, out, lse, H, T, n_rel, window,
                                     seed, thresh, inv, scale);
  return (int)cudaGetLastError();
}

extern "C" int rel_attn_train_bwd_q(const float* q, const float* k, const float* v,
                                    const float* rel_k, const float* rel_v, const float* mask,
                                    const float* o, const float* lse, const float* dout,
                                    float* dq, float* rowd, float* qrel, float* dorel,
                                    float* part_k, float* part_v, int B, int H, int T, int d,
                                    int n_rel, int window, uint32_t seed, uint32_t thresh,
                                    float rate, void* stream) {
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = d == 96 ? sizeof(BwdQSmem<96>) : sizeof(BwdQSmem<64>);
  auto kernel = d == 96 ? bwd_q_kernel<96> : bwd_q_kernel<64>;
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
                                     int window, uint32_t seed, uint32_t thresh, float rate,
                                     void* stream) {
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = d == 96 ? sizeof(BwdKVSmem<96>) : sizeof(BwdKVSmem<64>);
  auto kernel = d == 96 ? bwd_kv_kernel<96> : bwd_kv_kernel<64>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, NWARP * 32, smem, s>>>(q, k, v, mask, lse, dout, rowd, qrel, dorel, dk, dv, H,
                                        T, n_rel, window, seed, thresh, inv, scale);
  return (int)cudaGetLastError();
}

// The bf16 backward on wgmma: prep, q and kv (namespace bwd16) in one call.
//   q, k, v, dout: [B, H, T, d], bf16, any strides whose rows start 16-byte
//     aligned: strides[4·i .. 4·i + 2] are operand i's element strides of b,
//     h and t (d's is 1; host memory).  q_scaled: q is already q̂ = q/√d.
//   o [B, H, T, d], lse [B, H, T], mask [B, T], rel_k, rel_v [n_rel, 2w+1, d]: f32.
//   qh, kh, vh, doh: bf16 [B·H, Tp·d], stat [B·H, Tp/64, 3, 64], band [B·H, Tp, 18],
//     kinfo [B, Tp]: scratch, every element written, Tp = ceil(T/64)·64.
//   dq, dk, dv [B, H, T, d]; part_k, part_v [B·H, Tp/64, 2w+1, d]: f32 out.
extern "C" int rel_attn_train_bwd_tile() { return bwd16::BT; }

extern "C" int rel_attn_train_bwd_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const long long* strides,
                                       const float* o, const float* lse, const float* mask,
                                       const float* rel_k, const float* rel_v, void* qh, void* kh,
                                       void* vh, void* doh, float* stat, float* band,
                                       float* kinfo, float* dq, float* dk, float* dv,
                                       float* part_k, float* part_v, int B, int H, int T, int d,
                                       int n_rel, int window, int q_scaled, uint32_t seed,
                                       uint32_t thresh, float rate, void* stream) {
  using bf = __nv_bfloat16;
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, dout};
  bwd16::Src s4[4];
  for (int i = 0; i < 4; ++i)
    s4[i] = bwd16::Src{ptrs[i], strides[4 * i], strides[4 * i + 1], strides[4 * i + 2]};
  const bwd16::Srcs src{s4[0], s4[1], s4[2], s4[3]};
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  auto run = d == 96 ? bwd16::backward<96> : bwd16::backward<64>;
  return run(src, o, lse, mask, rel_k, rel_v, static_cast<bf*>(qh), static_cast<bf*>(kh),
             static_cast<bf*>(vh), static_cast<bf*>(doh), stat, band, kinfo, dq, dk, dv, part_k,
             part_v, B, H, T, n_rel, window, seed, thresh, inv, scale, q_scaled ? 1.f : scale,
             static_cast<cudaStream_t>(stream));
}

// The bf16 forward on wgmma (namespace fwd16): one launch.
//   q, k, v: [B, H, T, d], bf16, any strides whose rows start 16-byte
//     aligned: strides[4·i .. 4·i + 2] are operand i's element strides of b,
//     h and t (d's is 1; host memory).  q_scaled: q is already q̂ = q/√d.
//   rel_k, rel_v [n_rel, 2w+1, d] and mask [B, T], contiguous: bit 0, 1 and 2
//     of bf16_tabs say which of them is bf16, the others are f32.
//   out [B, H, T, d], lse [B, H, T]: f32 out.
extern "C" int rel_attn_train_fwd_bf16(const void* q, const void* k, const void* v,
                                       const long long* strides, const void* rel_k,
                                       const void* rel_v, const void* mask, int bf16_tabs,
                                       float* out, float* lse, int B, int H, int T, int d,
                                       int n_rel, int window, int q_scaled, uint32_t seed,
                                       uint32_t thresh, float rate, void* stream) {
  using namespace fwd16;
  if (window > 4 || (d != 64 && d != 96)) return (int)cudaErrorInvalidValue;
  // the kernels' shared-memory limit, set once per loaded library
  static const cudaError_t ready = [] {
    const cudaError_t errs[4] = {set_smem<64, false>(), set_smem<64, true>(),
                                 set_smem<96, false>(), set_smem<96, true>()};
    for (const cudaError_t e : errs)
      if (e != cudaSuccess) return e;
    return cudaSuccess;
  }();
  if (ready != cudaSuccess) return (int)ready;
  const void* ptrs[3] = {q, k, v};
  Src src[3];
  for (int i = 0; i < 3; ++i)
    src[i] = Src{ptrs[i], strides[4 * i], strides[4 * i + 1], strides[4 * i + 2]};
  const Tab tk{rel_k, bf16_tabs & 1}, tv{rel_v, (bf16_tabs >> 1) & 1},
      tm{mask, (bf16_tabs >> 2) & 1};
  const float scale = 1.f / sqrtf((float)d), inv = 1.f / (1.f - rate);
  const dim3 grid((T + FWD_ROWS - 1) / FWD_ROWS, B * H);
  auto kernel = d == 96 ? (thresh ? attn_kernel<96, true> : attn_kernel<96, false>)
                        : (thresh ? attn_kernel<64, true> : attn_kernel<64, false>);
  const size_t smem = d == 96 ? sizeof(Smem<96>) : sizeof(Smem<64>);
  kernel<<<grid, FWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      src[0], src[1], src[2], tk, tv, tm, out, lse, H, T, n_rel, window, seed, thresh, inv,
      q_scaled ? 1.f : scale);
  return (int)cudaGetLastError();
}
