// Whole dilation-1 WaveNet stack in one launch, f32.
//
// Replaces vispeech_tpu/ops/pallas/wn_stack.py::wn_stack (body _wn_kernel).
// The TPU kernel keeps one batch item's whole [T, C] state in VMEM and
// walks the layers as a sequential grid axis.  Here a block owns a window of
// WIN = 48 frames: a tile of WIN − 2·halo frames plus a halo of
// halo = L·(k//2) frames on each side, and loops over the L layers inside the
// block, recomputing the halo.  The residual state lives in shared memory,
// the skip sum in registers; only x is read and the output written.
//
//   layer l:  a   = cond[b, l] + Σ_tap x[t + tap − k//2] · W_in[l, tap]
//             z   = tanh(a[:C]) · sigmoid(a[C:])
//             rs  = z · W_rs[l] + b_rs[l]
//             l < L−1:  x ← (x + rs[:C]) · mask,  skip += rs[C:]
//             l = L−1:  out = (skip + rs[:C]) · mask
//
// Frames outside [0, T) are zero (SAME padding); a window row whose conv
// reaches past the window edge is garbage that moves inward k//2 rows per
// layer and never reaches the tile.
//
// Both products run on the tensor cores as mma.sync m16n8k8 TF32 with the
// 3-pass split (a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, each part rounded
// to TF32), which keeps f32 accuracy.  Warp w owns channel columns
// [16w, 16w + 16) of both gate halves and of both res/skip halves, so the
// gate, the residual update and the skip sum all happen on its own
// accumulator registers.
//
// Bound: at T = 1400, C = 192, L = 4 the stack is about 5 GFLOP per batch
// item against ~2 MB of activations and 7 MB of weights: compute-bound.
// Weights are read from L2 by every block; the halo costs WIN / tile = 1.5×
// the flops at L = 4, and the split three times the tensor-core work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WIN = 48;           // window rows per block: 3 m16 tiles
constexpr int MT = WIN / 16;
constexpr int MAXC = 256;         // C / 16 warps

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][j] += A[rows of m-tile mt][k0 .. k0+8) · B[k0 .. k0+8)[cols[j] .. +8)
// A: smem rows of lda floats starting at `a`; B: global rows of ldb floats.
__device__ __forceinline__ void mma_step(float (*acc)[4][4], const float* a, int lda,
                                         const float* __restrict__ bmat, int ldb,
                                         const int cols[4], int g, int tq) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_tf32(__ldg(bmat + tq * ldb + cols[j] + g), bh[j][0], bl[j][0]);
    split_tf32(__ldg(bmat + (tq + 4) * ldb + cols[j] + g), bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* ar = a + (mt * 16 + g) * lda + tq;
    uint32_t ah[4], al[4];
    split_tf32(ar[0], ah[0], al[0]);
    split_tf32(ar[8 * lda], ah[1], al[1]);
    split_tf32(ar[4], ah[2], al[2]);
    split_tf32(ar[8 * lda + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_tf32(acc[mt][j], al, bh[j][0], bh[j][1]);
      mma_tf32(acc[mt][j], ah, bl[j][0], bl[j][1]);
      mma_tf32(acc[mt][j], ah, bh[j][0], bh[j][1]);
    }
  }
}

__global__ void __launch_bounds__(MAXC / 16 * 32)
wn_stack_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ cond, const float* __restrict__ w_in,
                const float* __restrict__ w_rs, const float* __restrict__ b_rs,
                float* __restrict__ out, int T, int C, int L, int K, int halo) {
  extern __shared__ float smem[];
  const int pad = K / 2;
  const int lds = C + 4;                    // rows 8 apart fall in other banks
  float* xs = smem;                         // [(WIN + 2·pad), lds], pad rows stay 0
  float* zs = xs + (WIN + 2 * pad) * lds;   // [WIN, lds]
  float* ms = zs + WIN * lds;               // [WIN] mask

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y;
  const int tile = WIN - 2 * halo;
  const int t0 = blockIdx.x * tile - halo;  // global frame of window row 0
  const int C2 = 2 * C;
  const float* xb = x + (size_t)b * T * C;

  for (int i = threadIdx.x; i < (WIN + 2 * pad) * C; i += blockDim.x) {
    const int r = i / C, c = i % C, t = t0 + r - pad;
    xs[r * lds + c] = (r >= pad && r < WIN + pad && t >= 0 && t < T) ? xb[(size_t)t * C + c] : 0.f;
  }
  for (int r = threadIdx.x; r < WIN; r += blockDim.x) {
    const int t = t0 + r;
    ms[r] = (t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.f;
  }
  __syncthreads();

  // this warp's n8 tiles: two in the first half (tanh / residual), the same
  // two in the second half (sigmoid / skip)
  const int c0 = warp * 16;
  const int cols[4] = {c0, c0 + 8, C + c0, C + c0 + 8};
  float skip[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) skip[mt][j][e] = 0.f;

  for (int l = 0; l < L; ++l) {
    float acc[MT][4][4];
    const float* cl = cond + ((size_t)b * L + l) * C2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v0 = cl[cols[j] + 2 * tq], v1 = cl[cols[j] + 2 * tq + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][j][0] = v0; acc[mt][j][1] = v1; acc[mt][j][2] = v0; acc[mt][j][3] = v1;
      }
    }
    for (int tap = 0; tap < K; ++tap) {
      const float* wl = w_in + ((size_t)l * K + tap) * C * C2;
      // window row r reads padded row r + tap
      for (int k0 = 0; k0 < C; k0 += 8) {
        mma_step(acc, xs + tap * lds + k0, lds, wl + (size_t)k0 * C2, C2, cols, g, tq);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + 8 * (e >> 1), c = cols[j] + 2 * tq + (e & 1);
          zs[r * lds + c] = tanhf(acc[mt][j][e]) * (1.f / (1.f + expf(-acc[mt][j + 2][e])));
        }
    __syncthreads();

    const float* wr = w_rs + (size_t)l * C * C2;
    const float* bl = b_rs + (size_t)l * C2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v0 = bl[cols[j] + 2 * tq], v1 = bl[cols[j] + 2 * tq + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][j][0] = v0; acc[mt][j][1] = v1; acc[mt][j][2] = v0; acc[mt][j][3] = v1;
      }
    }
    for (int k0 = 0; k0 < C; k0 += 8) {
      mma_step(acc, zs + k0, lds, wr + (size_t)k0 * C2, C2, cols, g, tq);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + 8 * (e >> 1), c = cols[j] + 2 * tq + (e & 1);
          if (l < L - 1) {
            float* xp = xs + (r + pad) * lds + c;
            *xp = (*xp + acc[mt][j][e]) * ms[r];
            skip[mt][j][e] += acc[mt][j + 2][e];
          } else if (r >= halo && r < WIN - halo && t0 + r < T) {
            out[((size_t)b * T + t0 + r) * C + c] = (skip[mt][j][e] + acc[mt][j][e]) * ms[r];
          }
        }
    __syncthreads();
  }
}

}  // namespace

// x, out: [B, T, C]; mask: [B, T]; cond: [B, L, 2C]; w_in: [L, K, C, 2C];
// w_rs: [L, C, 2C]; b_rs: [L, 2C]; all f32 contiguous.  C a multiple of 16,
// ≤ 256; K odd; L·(K//2) ≤ 16.  Returns cudaGetLastError().
extern "C" int wn_stack_launch(const float* x, const float* mask, const float* cond,
                               const float* w_in, const float* w_rs, const float* b_rs,
                               float* out, int B, int T, int C, int L, int K, void* stream) {
  const int halo = L * (K / 2);
  const int tile = WIN - 2 * halo;
  if (C > MAXC || C % 16 != 0 || K % 2 == 0 || tile < 16) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(2 * WIN + 2 * (K / 2)) * (C + 4) + WIN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wn_stack_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + tile - 1) / tile, B);
  wn_stack_kernel<<<grid, C / 16 * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, mask, cond, w_in, w_rs, b_rs, out, T, C, L, K, halo);
  return (int)cudaGetLastError();
}
