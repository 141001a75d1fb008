// Kernel D: one polyphase-folded HiFi-GAN multi-receptive-field (MRF) stage.
//
// Replaces vispeech_tpu/ops/pallas/mrf_stage.py::mrf_stack_folded (body
// _mrf_folded_kernel, conv _conv_offsets).  The stage's input [B, T, C] is
// read as [B, T/fold, fold·C] (fold samples packed into the channels, the
// same memory), and every conv is a folded conv given by its tap offsets
// -pad_lo .. pad_hi (weights from ops/folded_mrf.py::fold_conv_weights).
// Per branch and unit:
//
//   h = leaky(state); y = Σ_m Wf1[m]ᵀ h[t + m − pad_lo] + b1; h = leaky(y·valid);
//   y = Σ_m Wf2[m]ᵀ h[t + m − pad_lo] + b2; state += y·valid
//
// and the output is the mean of the branch states.  "valid" re-zeroes every
// folded frame outside [0, T/fold) after each conv (SAME zero padding).
//
// The kernel computes at CF = 128 folded channels; a narrower stage has its
// weights and biases zero-padded to 128 by the wrapper, and its padded
// channels stay 0.  A block owns a window of WIN = 192 folded frames: a tile
// of WIN − 2·halo frames plus a halo on each side that covers the deepest
// branch's folded receptive radius (19 frames at fold 4 for k = 3, 7, 11 and
// dilations 1, 3, 5).  As in kernel C, the branch state lives in shared
// memory in f32 and each conv computes only the rows its successors still
// need.  There is one conv-input buffer in the I/O dtype: a conv keeps its
// result in registers until every warp has read its input, then overwrites
// the buffer (the first conv of a unit) or adds into the state (the second).
// The branch sum stays in registers.
//
// Bound: at fold 4 the 18 folded convs hold 92 taps of 128 × 128; over
// T/fold folded frames that is 2·92·128² flops per folded frame, 540 GFLOP
// at 716 800 samples, 2.9× the 185 GFLOP of the unfolded stage — compute-
// bound.  In bf16 each conv is a GEMM on the tensor cores (mma.sync
// m16n8k16, f32 accumulate): warp w owns window rows [16w, 16w + 16) × all
// 128 columns; per tap, the slab's rows shifted by the tap offset (ldmatrix)
// times the tap's weight, which cp.async stages into shared memory one tap
// ahead (3.0 MB of bf16 weights per stage stream through each block from
// L2).  In f32 the convs run on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CF = 128;             // folded channels computed
constexpr int WIN = 192;            // window rows (folded frames) per block
constexpr int HROWS = WIN + 16;     // conv-input rows: the last 16-row slab may read past WIN
constexpr int LD = CF + 4;          // f32 row (state, f32 conv input)
constexpr int LDB = CF + 8;         // bf16 row (272 B): ldmatrix rows hit distinct banks
constexpr int NT = 384;             // 12 warps, one 16-row slab each
constexpr int PER = WIN * CF / NT;  // branch-sum elements per thread
constexpr int MAXB = 4, MAXU = 4;

template <typename T> struct Cfg {
  static constexpr int LDH = LD;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int LDH = LDB;
};

struct FoldSpec {
  int n_br, n_unit;
  int pad[MAXB][MAXU][2][2];  // [branch][unit][conv][pad_lo, pad_hi]
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy one tap's weight [128 cout][128 cin] bf16 from global into smem rows
// of LDB, 16 B per cp.async.
__device__ __forceinline__ void stage_tap(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  for (int i = threadIdx.x; i < CF * CF / 8; i += NT) {
    const int row = i / (CF / 8), chunk = i % (CF / 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst + row * LDB + chunk * 8)), "l"(src + row * CF + chunk * 8));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Window rows [lo, hi) of y = bias + Σ_tap h[r + tap − plo] · w[tap] on the
// tensor cores; w [taps][cout][cin] in global memory, staged through wbuf
// (2 × [128][LDB]).  MODE 0: h = leaky(y·valid) in place;  MODE 1: st += y·valid.
template <int MODE>
__device__ void conv_bf16(__nv_bfloat16* h, float* st, const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias, int plo, int taps, int lo, int hi,
                          int t0, int Tf, __nv_bfloat16* wbuf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = lo + warp * 16;
  const bool active = r0 < hi;
  float acc[CF / 8][4];
#pragma unroll
  for (int n = 0; n < CF / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  // ldmatrix row addresses: A rows (lane & 15), cin half (lane >> 4);
  // B: cout row (lane & 7) of n-tile pair member (lane >> 4), cin half ((lane >> 3) & 1)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 8;

  stage_tap(wbuf, w);
  for (int tap = 0; tap < taps; ++tap) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (tap + 1 < taps)
      stage_tap(wbuf + ((tap + 1) & 1) * CF * LDB, w + (size_t)(tap + 1) * CF * CF);
    if (active) {
      const __nv_bfloat16* wt = wbuf + (tap & 1) * CF * LDB;
      const __nv_bfloat16* arow = h + (r0 + tap - plo + a_row) * LDB + a_col;
#pragma unroll
      for (int kc = 0; kc < CF / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + kc * 16);
#pragma unroll
        for (int np = 0; np < CF / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, wt + (np * 16 + b_row) * LDB + kc * 16 + b_col);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  // every warp has read h and wbuf: MODE 0 overwrites h, the next conv restages wbuf
  __syncthreads();
  if (!active) return;
#pragma unroll
  for (int n = 0; n < CF / 8; ++n) {
    const int c = n * 8 + 2 * tq;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int r = r0 + g + 8 * hrow, t = t0 + r;
      if (r < hi) {
        const float valid = (t >= 0 && t < Tf) ? 1.f : 0.f;
        const float y0 = (acc[n][2 * hrow] + b0) * valid;
        const float y1 = (acc[n][2 * hrow + 1] + b1) * valid;
        if (MODE == 0) {
          *reinterpret_cast<__nv_bfloat162*>(h + r * LDB + c) =
              __floats2bfloat162_rn(leaky(y0), leaky(y1));
        } else {
          st[r * LD + c] += y0;
          st[r * LD + c + 1] += y1;
        }
      }
    }
  }
}

// The same conv on the CUDA cores in f32: w [taps][cin][cout] read through
// the read-only cache; lane l owns columns [4l, 4l + 4) of its warp's slab.
template <int MODE>
__device__ void conv_f32(float* h, float* st, const float* __restrict__ w,
                         const float* __restrict__ bias, int plo, int taps, int lo, int hi,
                         int t0, int Tf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = lane * 4;
  const int r0 = lo + warp * 16;
  const bool active = r0 < hi;
  float acc[16][4];
  if (active) {
    const float4 bv = *reinterpret_cast<const float4*>(bias + c0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[i][0] = bv.x; acc[i][1] = bv.y; acc[i][2] = bv.z; acc[i][3] = bv.w;
    }
    for (int tap = 0; tap < taps; ++tap) {
      const float* hrow = h + (r0 + tap - plo) * LD;
      const float* wt = w + (size_t)tap * CF * CF + c0;
#pragma unroll 2
      for (int ci = 0; ci < CF; ++ci) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wt + ci * CF));
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float hv = hrow[i * LD + ci];
          acc[i][0] += hv * wv.x;
          acc[i][1] += hv * wv.y;
          acc[i][2] += hv * wv.z;
          acc[i][3] += hv * wv.w;
        }
      }
    }
  }
  __syncthreads();  // every warp has read h: MODE 0 overwrites it
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i, t = t0 + r;
    if (r < hi) {
      const float valid = (t >= 0 && t < Tf) ? 1.f : 0.f;
      float* dst = (MODE == 0 ? h : st) + r * LD + c0;
      float4 v = *reinterpret_cast<float4*>(dst);
      if (MODE == 0) {
        v = make_float4(leaky(acc[i][0] * valid), leaky(acc[i][1] * valid),
                        leaky(acc[i][2] * valid), leaky(acc[i][3] * valid));
      } else {
        v.x += acc[i][0] * valid; v.y += acc[i][1] * valid;
        v.z += acc[i][2] * valid; v.w += acc[i][3] * valid;
      }
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

template <int MODE>
__device__ __forceinline__ void conv(float* h, float* st, const float* w, const float* bias,
                                     int plo, int taps, int lo, int hi, int t0, int Tf,
                                     __nv_bfloat16*) {
  conv_f32<MODE>(h, st, w, bias, plo, taps, lo, hi, t0, Tf);
}
template <int MODE>
__device__ __forceinline__ void conv(__nv_bfloat16* h, float* st, const __nv_bfloat16* w,
                                     const float* bias, int plo, int taps, int lo, int hi,
                                     int t0, int Tf, __nv_bfloat16* wbuf) {
  conv_bf16<MODE>(h, st, w, bias, plo, taps, lo, hi, t0, Tf, wbuf);
}

template <typename TIO>
__global__ void __launch_bounds__(NT, 1)
mrf_folded_kernel(const TIO* __restrict__ x, const TIO* __restrict__ w,
                  const float* __restrict__ bias, TIO* __restrict__ out, int Tf, int cf,
                  int halo, FoldSpec spec) {
  constexpr int LDH = Cfg<TIO>::LDH;
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);            // branch state, f32
  TIO* h = reinterpret_cast<TIO*>(st + WIN * LD);        // conv input, I/O dtype
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(h + HROWS * LDH);  // bf16 only
  const int tile = WIN - 2 * halo;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - halo;  // folded frame of window row 0
  const TIO* xb = x + (size_t)b * Tf * cf;

  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  size_t woff = 0, boff = 0;
  for (int br = 0; br < spec.n_br; ++br) {
    int rl = 0, rr = 0;
    for (int u = 0; u < spec.n_unit; ++u)
      for (int c = 0; c < 2; ++c) {
        rl += spec.pad[br][u][c][0];
        rr += spec.pad[br][u][c][1];
      }
    int lo = halo - rl, hi = halo + tile + rr;
    __syncthreads();
    for (int i = threadIdx.x; i < (hi - lo) * CF; i += NT) {
      const int r = lo + i / CF, c = i % CF, t = t0 + r;
      st[r * LD + c] = (t >= 0 && t < Tf && c < cf) ? to_f(xb[(size_t)t * cf + c]) : 0.f;
    }
    for (int u = 0; u < spec.n_unit; ++u) {
      const int plo1 = spec.pad[br][u][0][0], phi1 = spec.pad[br][u][0][1];
      const int plo2 = spec.pad[br][u][1][0], phi2 = spec.pad[br][u][1][1];
      const int taps1 = plo1 + phi1 + 1, taps2 = plo2 + phi2 + 1;
      __syncthreads();
      for (int i = threadIdx.x; i < (hi - lo) * CF; i += NT) {
        const int r = lo + i / CF, c = i % CF;
        h[r * LDH + c] = from_f<TIO>(leaky(st[r * LD + c]));
      }
      __syncthreads();
      conv<0>(h, st, w + woff, bias + boff, plo1, taps1, lo + plo1, hi - phi1, t0, Tf, wbuf);
      woff += (size_t)taps1 * CF * CF;
      boff += CF;
      conv<1>(h, st, w + woff, bias + boff, plo2, taps2, lo + plo1 + plo2, hi - phi1 - phi2,
              t0, Tf, wbuf);
      woff += (size_t)taps2 * CF * CF;
      boff += CF;
      lo += plo1 + plo2;
      hi -= phi1 + phi2;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NT;
      acc[j] += st[(i / CF) * LD + i % CF];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CF, c = i % CF, t = t0 + r;
    if (r >= halo && r < halo + tile && t < Tf && c < cf)
      out[((size_t)b * Tf + t) * cf + c] = from_f<TIO>(acc[j] / spec.n_br);
  }
}

template <typename TIO>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int Tf, int cf,
           int halo, const FoldSpec& spec, cudaStream_t stream) {
  const size_t wbuf = sizeof(TIO) == 2 ? (size_t)2 * CF * LDB * sizeof(TIO) : 0;
  const size_t smem = (size_t)WIN * LD * sizeof(float) +
                      (size_t)HROWS * Cfg<TIO>::LDH * sizeof(TIO) + wbuf;
  cudaError_t err = cudaFuncSetAttribute(mrf_folded_kernel<TIO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = WIN - 2 * halo;
  dim3 grid((Tf + tile - 1) / tile, B);
  mrf_folded_kernel<TIO><<<grid, NT, smem, stream>>>(
      static_cast<const TIO*>(x), static_cast<const TIO*>(w), bias, static_cast<TIO*>(out), Tf,
      cf, halo, spec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, Tf, cf] (the stage's [B, T, C] read folded) in the I/O dtype
// (is_bf16: bf16, else f32), contiguous; cf ≤ 128, a multiple of 16.
// w: per branch, per unit, conv1 then conv2, each [taps][128][128] in the
// I/O dtype (zero-padded past cf), laid out (tap, cin, cout) for f32 and
// (tap, cout, cin) for bf16, taps = pad_lo + pad_hi + 1; bias: f32, same
// order, [128] each.  pads: [n_br][n_unit][2 convs][pad_lo, pad_hi].  Every
// branch's summed pads on each side ≤ halo, and 192 − 2·halo ≥ 16.
// Returns cudaGetLastError().
extern "C" int mrf_stage_folded_launch(const void* x, const void* w, const float* bias,
                                       void* out, int B, int Tf, int cf, int n_br, int n_unit,
                                       const int* pads, int halo, int is_bf16, void* stream) {
  if (n_br < 1 || n_br > MAXB || n_unit < 1 || n_unit > MAXU || cf < 16 || cf > CF ||
      cf % 16 != 0 || halo < 0 || WIN - 2 * halo < 16)
    return (int)cudaErrorInvalidValue;
  FoldSpec spec{};
  spec.n_br = n_br;
  spec.n_unit = n_unit;
  for (int br = 0; br < n_br; ++br) {
    int rl = 0, rr = 0;
    for (int u = 0; u < n_unit; ++u)
      for (int c = 0; c < 2; ++c) {
        const int* p = pads + ((br * n_unit + u) * 2 + c) * 2;
        if (p[0] < 0 || p[1] < 0) return (int)cudaErrorInvalidValue;
        spec.pad[br][u][c][0] = p[0];
        spec.pad[br][u][c][1] = p[1];
        rl += p[0];
        rr += p[1];
      }
    if (rl > halo || rr > halo) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, bias, out, B, Tf, cf, halo, spec, s)
                 : launch<float>(x, w, bias, out, B, Tf, cf, halo, spec, s);
}
