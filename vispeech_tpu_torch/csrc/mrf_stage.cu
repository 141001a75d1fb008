// One fused HiFi-GAN multi-receptive-field (MRF) stage at C = 64.
//
// Replaces vispeech_tpu/ops/pallas/mrf_stage.py::mrf_stack (body
// _mrf_kernel, conv _conv_cm, halo from branch_halo).  Per branch
// (k = 3, 7, 11) and unit (dilation 1, 3, 5):
//
//   h = leaky(state); y = conv_{k,d}(h) + b1; h = leaky(y·valid);
//   y = conv_{k,1}(h) + b2; state += y·valid
//
// and the output is the mean of the branch states.  "valid" re-zeroes every
// position outside [0, T) after each conv, which is what SAME zero padding
// means for the unfused path.
//
// A block owns a tile of TT = 128 samples of one batch item plus a halo of
// 64 samples on each side (≥ the 60-sample receptive radius of the k = 11
// branch).  The branch state lives in shared memory in f32, the two conv
// inputs in the I/O dtype (bf16 on the serving path); each conv only
// computes the rows its successors still need, so the halo shrinks as the
// units go.  Convs accumulate in f32, as the TPU kernel does; the output is
// cast back to the I/O dtype.
//
// Bound: 2·k·C² flops per sample per conv, 18 convs: ~1.03 MFLOP per
// sample, ~370 GFLOP for a 1400-frame bucket (358 400 samples) against
// 2·T·C·2 bytes of I/O — compute-bound.  In bf16 each conv is a GEMM on the
// tensor cores (mma.sync m16n8k16, f32 accumulate): 16 warps each own a
// 16-row slab × 64 columns; per tap, the slab's rows shifted by the tap
// offset (ldmatrix from padded rows) times the tap's [64, 64] weight, which
// cp.async stages into shared memory one tap ahead.  The epilogue works on
// the accumulator registers.  In f32 the convs run on the CUDA cores.  The
// halo costs ~1.35× extra flops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;
constexpr int TT = 128;
constexpr int HALO = 64;
constexpr int WIN = TT + 2 * HALO;
constexpr int LD = C + 1;        // f32 smem row: rows 8 apart fall in other banks
constexpr int HROWS = WIN + 16;  // conv-input rows: the last 16-row slab may read past WIN
constexpr int LDB = C + 8;       // bf16 smem row (144 B): ldmatrix rows hit distinct banks
constexpr int MAXB = 4, MAXU = 4;

// threads per block: f32 SIMT 16 column groups × 16 row groups; bf16 one
// warp per 16-row slab of the 256-row window
template <typename T> struct Cfg {
  static constexpr int NT = 256, LDH = LD;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int NT = 512, LDH = LDB;
};

struct MrfSpec {
  int n_br, n_unit;
  int k[MAXB];
  int dil[MAXB][MAXU];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// Window rows [lo, hi) of y = bias + Σ_tap Σ_ci src[r + (tap − k/2)·d][ci]·w[tap][ci][:]
// on the CUDA cores (f32).  MODE 0: hdst = leaky(y·valid);  MODE 1: st += y·valid.
template <int MODE>
__device__ void conv_f32(const float* src, float* hdst, float* st, const float* __restrict__ w,
                         const float* __restrict__ bias, int k, int d, int lo, int hi, int t0,
                         int T) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c0 = tx * 4;
  const int half = (k - 1) / 2;
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bv[j] = bias[c0 + j];
  for (int base = lo; base < hi; base += 128) {
    const int r0 = base + ty * 8;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = bv[j];
    for (int tap = 0; tap < k; ++tap) {
      const int sh = (tap - half) * d;
      int off[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) off[i] = min(r0 + i + sh, WIN - 1) * LD;
      const float* wt = w + (size_t)tap * C * C + c0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(wt + ci * C);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float hv = src[off[i] + ci];
          acc[i][0] += hv * wv.x;
          acc[i][1] += hv * wv.y;
          acc[i][2] += hv * wv.z;
          acc[i][3] += hv * wv.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i, t = t0 + r;
      if (r < hi) {
        const float valid = (t >= 0 && t < T) ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = acc[i][j] * valid;
          if (MODE == 0) {
            hdst[r * LD + c0 + j] = leaky(y);
          } else {
            st[r * LD + c0 + j] += y;
          }
        }
      }
    }
  }
}

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

// Copy one tap's weight [64 cout][64 cin] bf16 from global into smem rows of
// LDB, 16 B per cp.async.
__device__ __forceinline__ void stage_tap(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  constexpr int NT = Cfg<__nv_bfloat16>::NT;
  for (int i = threadIdx.x; i < C * C / 8; i += NT) {
    const int row = i / (C / 8), chunk = i % (C / 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst + row * LDB + chunk * 8)), "l"(src + row * C + chunk * 8));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The same conv on the tensor cores: bf16 src [rows][LDB], w [k][cout][cin]
// in global memory, staged tap by tap through wbuf (2 × [64][LDB]).
template <int MODE>
__device__ void conv_bf16(const __nv_bfloat16* src, __nv_bfloat16* hdst, float* st,
                          const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                          int k, int d, int lo, int hi, int t0, int T, __nv_bfloat16* wbuf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int half = (k - 1) / 2;
  const int r0 = lo + warp * 16;
  const bool active = r0 < hi;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  // ldmatrix row addresses: A rows (lane & 15), cin half (lane >> 4);
  // B: cout row (lane & 7) of n-tile pair member (lane >> 4), cin half ((lane >> 3) & 1)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 8;

  stage_tap(wbuf, w);
  for (int tap = 0; tap < k; ++tap) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (tap + 1 < k) stage_tap(wbuf + ((tap + 1) & 1) * C * LDB, w + (size_t)(tap + 1) * C * C);
    if (active) {
      const __nv_bfloat16* wt = wbuf + (tap & 1) * C * LDB;
      const __nv_bfloat16* arow = src + (r0 + (tap - half) * d + a_row) * LDB + a_col;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + kc * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, wt + (np * 16 + b_row) * LDB + kc * 16 + b_col);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * tq;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int r = r0 + g + 8 * hrow, t = t0 + r;
      if (r < hi) {
        const float valid = (t >= 0 && t < T) ? 1.f : 0.f;
        const float y0 = (acc[n][2 * hrow] + b0) * valid;
        const float y1 = (acc[n][2 * hrow + 1] + b1) * valid;
        if (MODE == 0) {
          *reinterpret_cast<__nv_bfloat162*>(hdst + r * LDB + c) =
              __floats2bfloat162_rn(leaky(y0), leaky(y1));
        } else {
          st[r * LD + c] += y0;
          st[r * LD + c + 1] += y1;
        }
      }
    }
  }
}

template <int MODE>
__device__ __forceinline__ void conv(const float* src, float* hdst, float* st, const float* w,
                                     const float* bias, int k, int d, int lo, int hi, int t0,
                                     int T, float*) {
  conv_f32<MODE>(src, hdst, st, w, bias, k, d, lo, hi, t0, T);
}
template <int MODE>
__device__ __forceinline__ void conv(const __nv_bfloat16* src, __nv_bfloat16* hdst, float* st,
                                     const __nv_bfloat16* w, const float* bias, int k, int d,
                                     int lo, int hi, int t0, int T, __nv_bfloat16* wbuf) {
  conv_bf16<MODE>(src, hdst, st, w, bias, k, d, lo, hi, t0, T, wbuf);
}

template <typename TIO>
__global__ void __launch_bounds__(Cfg<TIO>::NT, 1)
mrf_stage_kernel(const TIO* __restrict__ x, const TIO* __restrict__ w,
                 const float* __restrict__ bias, TIO* __restrict__ out, int T, MrfSpec spec) {
  constexpr int NT = Cfg<TIO>::NT, LDH = Cfg<TIO>::LDH;
  constexpr int PER = TT * C / NT;  // centre elements per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);          // branch state, f32
  TIO* h = reinterpret_cast<TIO*>(st + WIN * LD);      // first conv input
  TIO* h2 = h + HROWS * LDH;                           // second conv input
  TIO* wbuf = h2 + HROWS * LDH;                        // staged tap weights (bf16 only)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT - HALO;  // global sample of window row 0
  const TIO* xb = x + (size_t)b * T * C;

  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  size_t woff = 0, boff = 0;
  for (int br = 0; br < spec.n_br; ++br) {
    const int k = spec.k[br], half = (k - 1) / 2;
    int radius = 0;
    for (int u = 0; u < spec.n_unit; ++u) radius += half * spec.dil[br][u] + half;
    int lo = HALO - radius, hi = HALO + TT + radius;
    __syncthreads();
    for (int i = threadIdx.x; i < (hi - lo) * C; i += NT) {
      const int r = lo + i / C, c = i % C, t = t0 + r;
      st[r * LD + c] = (t >= 0 && t < T) ? to_f(xb[(size_t)t * C + c]) : 0.f;
    }
    for (int u = 0; u < spec.n_unit; ++u) {
      const int d = spec.dil[br][u];
      __syncthreads();
      for (int i = threadIdx.x; i < (hi - lo) * C; i += NT) {
        const int r = lo + i / C, c = i % C;
        h[r * LDH + c] = from_f<TIO>(leaky(st[r * LD + c]));
      }
      __syncthreads();
      const int r1 = half * d, r2 = half;
      conv<0>(h, h2, st, w + woff, bias + boff, k, d, lo + r1, hi - r1, t0, T, wbuf);
      woff += (size_t)k * C * C;
      boff += C;
      __syncthreads();
      conv<1>(h2, h2, st, w + woff, bias + boff, k, 1, lo + r1 + r2, hi - r1 - r2, t0, T,
              wbuf);
      woff += (size_t)k * C * C;
      boff += C;
      lo += r1 + r2;
      hi -= r1 + r2;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NT;
      acc[j] += st[(HALO + i / C) * LD + i % C];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT, t = blockIdx.x * TT + i / C;
    if (t < T) out[((size_t)b * T + t) * C + i % C] = from_f<TIO>(acc[j] / spec.n_br);
  }
}

template <typename TIO>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int T,
           const MrfSpec& spec, cudaStream_t stream) {
  constexpr int LDH = Cfg<TIO>::LDH;
  const size_t wbuf = sizeof(TIO) == 2 ? (size_t)2 * C * LDB * sizeof(TIO) : 0;
  const size_t smem =
      (size_t)WIN * LD * sizeof(float) + 2 * (size_t)HROWS * LDH * sizeof(TIO) + wbuf;
  cudaError_t err = cudaFuncSetAttribute(mrf_stage_kernel<TIO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  mrf_stage_kernel<TIO><<<grid, Cfg<TIO>::NT, smem, stream>>>(
      static_cast<const TIO*>(x), static_cast<const TIO*>(w), bias, static_cast<TIO*>(out), T,
      spec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, T, 64] in the I/O dtype (is_bf16: bf16, else f32), contiguous.
// w: per branch, per unit, conv1 then conv2, each [k][64][64] in the I/O
// dtype, laid out (tap, cin, cout) for f32 and (tap, cout, cin) for bf16;
// bias: f32, same order, [64] each.  ks: [n_br]; dils: [n_br · n_unit].
// n_br, n_unit ≤ 4; every branch's receptive radius ≤ 64.  Returns
// cudaGetLastError().
extern "C" int mrf_stage_launch(const void* x, const void* w, const float* bias, void* out,
                                int B, int T, int n_br, int n_unit, const int* ks,
                                const int* dils, int is_bf16, void* stream) {
  if (n_br < 1 || n_br > MAXB || n_unit < 1 || n_unit > MAXU) return (int)cudaErrorInvalidValue;
  MrfSpec spec{};
  spec.n_br = n_br;
  spec.n_unit = n_unit;
  for (int br = 0; br < n_br; ++br) {
    spec.k[br] = ks[br];
    int radius = 0;
    for (int u = 0; u < n_unit; ++u) {
      spec.dil[br][u] = dils[br * n_unit + u];
      radius += (ks[br] - 1) / 2 * (spec.dil[br][u] + 1);
    }
    if (ks[br] % 2 == 0 || radius > HALO) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, bias, out, B, T, spec, s)
                 : launch<float>(x, w, bias, out, B, T, spec, s);
}
