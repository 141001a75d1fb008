// Masked self-attention with a window-w relative-position bias, f32.
//
// Replaces vispeech_tpu/ops/pallas/flash_attention.py::relative_self_attention
// (body _attention_kernel).  The TPU kernel holds all of K and V of one
// batch-head in VMEM; here one block owns (batch-head, 32 query rows) and
// streams K/V in tiles of 32 keys through shared memory with an online
// softmax, so the [T, T] scores never leave the chip and any T fits.
//
//   s[t, j]  = (q[t]·scale)·k[j] + (|j−t| ≤ w ? (q[t]·scale)·rel_k[j−t+w] : 0)
//   s[t, j]  = key_mask[j] > 0 ? s[t, j] : −1e4        (masked *replace*)
//   out[t]   = Σ_j p[t, j]·(v[j] + (|j−t| ≤ w ? rel_v[j−t+w] : 0))
//
// The relative-value term rides in the same accumulator as P·V, so the
// running-max rescale and the final division by the row sum apply to it too.
// A row whose keys are all masked sees a uniform softmax and stays finite.
//
// Bound: at T = 1400, d = 96 the work is 4·T²·d flops per batch-head, about
// 0.75 GFLOP per head and layer, against T·d·4·4 bytes of I/O: compute-bound
// (f32 CUDA cores; no tensor cores in this first version).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 32;        // keys per tile (one per lane)
constexpr int NWARP = 4;
constexpr int ROWS = BQ / NWARP;
constexpr int MAXW = 9;       // 2w+1, w ≤ 4

template <int D>
__global__ void __launch_bounds__(NWARP * 32)
rel_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ rel_k,
                     const float* __restrict__ rel_v, const float* __restrict__ mask,
                     float* __restrict__ out, int H, int T, int n_rel, int window,
                     float scale) {
  constexpr int KS = D + 4;   // padded K row: float4 aligned, no bank conflicts
  constexpr int DPL = D / 32; // output dims per lane
  __shared__ __align__(16) float qs[BQ][D];
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

  for (int i = tid; i < BQ * D; i += blockDim.x) {
    int r = i / D, c = i % D, t = q0 + r;
    qs[r][c] = t < T ? q[base + (size_t)t * D + c] * scale : 0.f;
  }
  for (int i = tid; i < W * D; i += blockDim.x) rvs[i / D][i % D] = rv[i];
  __syncthreads();
  for (int i = tid; i < BQ * W; i += blockDim.x) {
    int r = i / W, w = i % W;
    float s = 0.f;
    for (int c = 0; c < D; ++c) s += qs[r][c] * rk[w * D + c];
    qr[r][w] = s;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += blockDim.x) {
      int j = i / D, c = i % D, key = k0 + j;
      bool in = key < T;
      ks[j][c] = in ? k[base + (size_t)key * D + c] : 0.f;
      vs[j][c] = in ? v[base + (size_t)key * D + c] : 0.f;
    }
    if (tid < BK) km[tid] = (k0 + tid < T) ? mask[(size_t)b * T + k0 + tid] : 0.f;
    __syncthreads();

    // scores of this warp's rows against key k0+lane
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(&ks[lane][0]);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 kv = kr[d4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float4 qv = reinterpret_cast<const float4*>(&qs[warp * ROWS + i][0])[d4];
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i, t = q0 + r, delta = key - t;
      if (delta >= -window && delta <= window) s[i] += qr[r][delta + window];
      if (km[lane] <= 0.f) s[i] = -1e4f;
      if (key >= T) s[i] = -INFINITY;
      float mt = s[i];
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      const float p = expf(s[i] - m_new);
      float ls = p;
      for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      l[i] = l[i] * corr + ls;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      ps[warp][i][lane] = p;
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
    }
  }
}

}  // namespace

// q, k, v, out: [B, H, T, d] f32 contiguous; rel_k, rel_v: [n_rel, 2w+1, d];
// mask: [B, T] f32.  d ∈ {64, 96}; w ≤ 4.  Returns cudaGetLastError().
extern "C" int rel_attention_launch(const float* q, const float* k, const float* v,
                                    const float* rel_k, const float* rel_v,
                                    const float* mask, float* out, int B, int H, int T,
                                    int d, int n_rel, int window, void* stream) {
  dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 96) {
    rel_attention_kernel<96><<<grid, NWARP * 32, 0, s>>>(q, k, v, rel_k, rel_v, mask, out,
                                                         H, T, n_rel, window, scale);
  } else if (d == 64) {
    rel_attention_kernel<64><<<grid, NWARP * 32, 0, s>>>(q, k, v, rel_k, rel_v, mask, out,
                                                         H, T, n_rel, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
