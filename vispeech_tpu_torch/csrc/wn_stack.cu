// Whole dilation-1 WaveNet stack, f32, one window per thread-block cluster.
//
// Replaces vispeech_tpu/ops/pallas/wn_stack.py::wn_stack (body _wn_kernel).
// The TPU kernel keeps one batch item's whole [T, C] state in VMEM and walks
// the layers as a sequential grid axis.  Here a cluster of NCL = 4 CTAs on
// neighbouring SMs owns a window of WIN = 64 frames: a tile of WIN − 2·halo
// frames plus a halo of halo = L·(k//2) frames on each side, and loops over
// the L layers, recomputing the halo.
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
// What bounds it: the stack is compute-bound (at T = 1400, C = 192, L = 4
// about 5 GFLOP per batch item against ~2 MB of activations and 7 MB of
// weights; 15 GFLOP of tensor-core work with the 3-pass split).  The first
// version ran one window per SM, 12 warps each walking 3 m16 tiles through
// mma.sync: at batch 1 it left the card idle (4 of 132 SMs at T = 128, 44 at
// T = 1400), and mma.sync's TF32 rate on Hopper is a fraction of wgmma's.
//
// What the design does about it:
// - The channels of a window are split over the cluster.  CTA r owns the
//   columns [r·C/NCL, (r+1)·C/NCL) of both gate halves and of both res/skip
//   halves, so the gate, the residual update and the skip sum stay on its
//   own accumulators.  Every CTA keeps a full copy of the window's state x
//   and of z in shared memory: after the gate each CTA writes its slice of z
//   into its own copy, and after a cluster barrier reads the other three
//   slices from the other CTAs' shared memory (distributed shared memory,
//   16-byte loads); the same for the new x after the res/skip product (two
//   barriers per layer).
// - A CTA is one warpgroup.  Both products are wgmma m64n32k8 TF32 (64
//   window rows × one 32-column group of the CTA's slice per instruction),
//   A (the state or z, split at run time) from registers, B (the weights)
//   from shared memory, with the 3-pass split (a·b ≈ a_lo·b_hi + a_hi·b_lo
//   + a_hi·b_hi) that keeps f32 accuracy.
// - The weights arrive prepared (ops/kernels/wn_stack.py::prepare_weights):
//   split into TF32 hi and lo once, round-to-nearest-away as cvt.rna does,
//   and laid out per CTA column slice in wgmma's K-major core-matrix order,
//   so the kernel converts no B operand.  They stream through shared memory
//   in chunks of KCH k-steps (8, or 4 at C = 256), each one bulk copy by the
//   tensor memory accelerator into the other of two slots while the tensor
//   cores read one.
//
// Deep stacks (L·(k//2) > 16, the 16-layer posterior encoder) take the
// per-layer mode: one cluster launch per layer over tiles of WIN frames that
// read a k//2 halo of the previous layer's state from global memory (every
// CTA loads the whole window's rows), with the same channel split and one
// exchange of z per layer.  The residual state (ping-ponged between two
// buffers, since neighbouring clusters read it) and the skip sum stay in
// global memory in f32, L2-resident at T = 1400.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NCL = 4;            // CTAs per cluster: the channel split
constexpr int WIN = 64;           // window rows: wgmma's M
constexpr int THREADS = 128;      // one warpgroup

// v ≈ hi + lo for the 3-pass products: hi is v rounded to TF32 to nearest,
// ties away from zero (the result of cvt.rna.tf32.f32, in two integer
// instructions where cvt takes several), lo the exact f32 rest, which the
// tensor core reads truncated to TF32: |v − hi − lo| ≤ 2^-21·|v|
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the weight ring's barriers: one per slot, completed by the bytes of one
// bulk copy (the tensor memory accelerator) into it
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// rows [0, rows) × the other CTAs' column slices [q·Cn, (q+1)·Cn) of buf
// (row stride lds floats), copied from their shared memory into this CTA's:
// each CTA wrote only its own slice
template <int C>
__device__ __forceinline__ void pull_slices(float* buf, int lds, int rows, int rank) {
  constexpr int Cn = C / NCL, V = Cn / 4;   // float4 per row and slice
  constexpr int BATCH = 6;                  // loads in flight per thread
  const int n = (NCL - 1) * rows * V;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * blockDim.x) {
    float4 v[BATCH];
    float* dst[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        const int q = (rank + 1 + i / (rows * V)) % NCL, r = (i / V) % rows;
        dst[u] = buf + r * lds + q * Cn + (i % V) * 4;
        uint32_t remote;
        asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
            : "=r"(remote) : "r"(smem_addr(dst[u])), "r"(q));
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z), "=f"(v[u].w) : "r"(remote));
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i0 + u * blockDim.x < n) *reinterpret_cast<float4*>(dst[u]) = v[u];
  }
}

// shared-memory matrix descriptor of a B operand in the K-major core-matrix
// layout without swizzle: 8 columns × 4 k (16 bytes) per core matrix, the
// two along k 128 bytes apart (LBO), the next 8 columns 256 bytes on (SBO)
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// the compiler keeps the accumulators' reads and writes on their side of
// the asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d[j][e] (n8 tile j, fragment e) += A (this warp's 16 of the 64 rows,
// registers as mma.sync's m16n8k8 A fragment) · B (k 8 × 32 columns)
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t a[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc[s] += A · W over nsteps k-steps of 8, for the CTA's NSUB column groups
// s.  A: shared-memory rows of lds floats from this warp's first row; k-step
// st reads row offset st / steps_per_tap and columns (st % steps_per_tap)·8
// (the conv taps; a 1×1 product has one tap).  W: the CTA's prepared slice,
// per k-step [hi, lo][NSUB][4 n8 tiles][2 k-halves][8 columns][4 k], loaded
// KCH k-steps at a time by bulk copies into a ring of NSTAGE slots; `it`
// counts the chunks this CTA has taken through the ring, for the slots'
// barrier phases.
template <int NSUB, int NSTAGE, int KCH>
__device__ __forceinline__ void product(float (&acc)[NSUB][4][4], const float* a, int lds,
                                        int nsteps, int steps_per_tap,
                                        const float* __restrict__ w, float* wbuf,
                                        uint64_t* bars, uint32_t& it, int lane) {
  constexpr int STEP = 2 * NSUB * 256;      // floats per k-step: hi and lo
  constexpr int CHUNK = KCH * STEP;
  const int g = lane >> 2, tq = lane & 3;
  const int nchunks = nsteps / KCH;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NSTAGE - 1; ++c)
      if (c < nchunks) {
        const int slot = (it + c) % NSTAGE;
        bulk_load(wbuf + slot * CHUNK, w + (size_t)c * CHUNK, CHUNK * 4, bars + slot);
      }
  }
  for (int c = 0; c < nchunks; ++c, ++it) {
    // every wgmma of chunk c − 1 is done (waited below), so its slot takes
    // the chunk NSTAGE − 1 ahead
    __syncthreads();
    const int next = c + NSTAGE - 1;
    if (threadIdx.x == 0 && next < nchunks) {
      const int slot = (it + NSTAGE - 1) % NSTAGE;
      bulk_load(wbuf + slot * CHUNK, w + (size_t)next * CHUNK, CHUNK * 4, bars + slot);
    }
    uint32_t ah[KCH][4], al[KCH][4];
#pragma unroll
    for (int ks = 0; ks < KCH; ++ks) {
      const int st = c * KCH + ks;
      const int tap = st / steps_per_tap, k0 = (st - tap * steps_per_tap) * 8;
      const float* ar = a + (g + tap) * lds + k0 + tq;
      split_tf32(ar[0], ah[ks][0], al[ks][0]);
      split_tf32(ar[8 * lds], ah[ks][1], al[ks][1]);
      split_tf32(ar[4], ah[ks][2], al[ks][2]);
      split_tf32(ar[8 * lds + 4], ah[ks][3], al[ks][3]);
    }
    mbar_wait(bars + it % NSTAGE, (it / NSTAGE) & 1);
    const float* wb = wbuf + (it % NSTAGE) * CHUNK;
#pragma unroll
    for (int s = 0; s < NSUB; ++s) fence_acc(acc[s]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KCH; ++ks)
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
        const float* hi = wb + ks * STEP + s * 256;
        wgmma_n32(acc[s], al[ks], b_desc(hi));
        wgmma_n32(acc[s], ah[ks], b_desc(hi + NSUB * 256));
        wgmma_n32(acc[s], ah[ks], b_desc(hi));
      }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < NSUB; ++s) fence_acc(acc[s]);
  }
  __syncthreads();   // every warp is done with the ring before the next product fills it
}

constexpr int RING = 2;     // weight chunks in shared memory: one read, one loading

template <int NSUB>
__host__ __device__ constexpr int kch() {
  return NSUB == 4 ? 4 : 8;   // k-steps per chunk: C = 256 fits two chunks of 32 KB
}

// DEEP = false: the whole stack in one launch, halo = L·(k//2) recomputed.
// DEEP = true: layer `layer` only, halo = 0; x is that layer's input state,
// `out` the next layer's (the stack's output after the last layer), `skip`
// the skip sum so far (read from layer 1 on, written up to layer L − 2).
// Grid (NCL · windows, B), cluster (NCL, 1, 1), one warpgroup; C = 64·NSUB.
template <int NSUB, bool DEEP>
__global__ void __launch_bounds__(THREADS)
wn_stack_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ cond, const float* __restrict__ w_in,
                const float* __restrict__ w_rs, const float* __restrict__ b_rs,
                float* __restrict__ out, float* __restrict__ skip_g, int T, int L, int K,
                int halo, int layer) {
  constexpr int C = 64 * NSUB, C2 = 2 * C, Cn = C / NCL;
  constexpr int NS = RING, KCH = kch<NSUB>();
  constexpr int lds = C + 4;                // rows 8 apart fall in other banks
  constexpr int WSTEP = 2 * NSUB * 256;     // prepared floats per k-step and CTA
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int pad = K / 2;
  float* wbuf = smem;                       // NS chunks of KCH·WSTEP
  float* xs = wbuf + NS * KCH * WSTEP;      // [(WIN + 2·pad), lds], pad rows stay 0
  float* zs = xs + (WIN + 2 * pad) * lds;   // [WIN, lds]
  float* ms = zs + WIN * lds;               // [WIN] mask
  uint64_t* bars = reinterpret_cast<uint64_t*>(ms + WIN);   // [NS] the ring's barriers
  uint32_t it = 0;                          // chunks through the ring so far
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y;
  const int tile = WIN - 2 * halo;
  const int t0 = (blockIdx.x / NCL) * tile - halo;   // global frame of window row 0
  const float* xb = x + (size_t)b * T * C;

  // the window's rows by cp.async, all in flight at once; rows outside
  // [0, T) (and in the one-launch mode the conv's pad rows) are zeros
  for (int i = threadIdx.x; i < (WIN + 2 * pad) * (C / 4); i += blockDim.x) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4, t = t0 + r - pad;
    const bool in = (DEEP || (r >= pad && r < WIN + pad)) && t >= 0 && t < T;
    cp_async16(xs + r * lds + c, xb + (size_t)(in ? t : 0) * C + c, in ? 16 : 0);
  }
  cp_async_commit();
  for (int r = threadIdx.x; r < WIN; r += blockDim.x) {
    const int t = t0 + r;
    ms[r] = (t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.f;
  }
  cp_async_wait<0>();
  cluster.sync();   // every CTA of the cluster runs and has its window before any exchange

  // accumulator acc[s][j][e]: column group s of the CTA's slice, n8 tile j
  // (0, 1: tanh / residual columns; 2, 3: the same sigmoid / skip columns),
  // row row0 + 8·(e >> 1), column cols(s, j) + (e & 1)
  const int row0 = warp * 16 + g;
  auto col = [&](int s, int j) { return (j >> 1) * C + rank * Cn + 16 * s + 8 * (j & 1) + 2 * tq; };
  float skip[NSUB][2][4] = {};

  for (int l = DEEP ? layer : 0; l < (DEEP ? layer + 1 : L); ++l) {
    const float* cl = cond + ((size_t)b * L + l) * C2;
    const float* bl = b_rs + (size_t)l * C2;
    float acc[NSUB][4][4];
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(cl + col(s, j));
        acc[s][j][0] = v.x; acc[s][j][1] = v.y; acc[s][j][2] = v.x; acc[s][j][3] = v.y;
      }
    // window row r reads padded row r + tap
    product<NSUB, NS, KCH>(acc, xs + warp * 16 * lds, lds, K * C / 8, C / 8,
                      w_in + ((size_t)l * NCL + rank) * (K * C / 8) * WSTEP, wbuf, bars, it,
                      lane);
    // z of this CTA's columns into its zs; then the other slices from theirs
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(zs + (row0 + 8 * h) * lds + col(s, j)) = make_float2(
              tanhf(acc[s][j][2 * h]) * (1.f / (1.f + expf(-acc[s][j + 2][2 * h]))),
              tanhf(acc[s][j][2 * h + 1]) * (1.f / (1.f + expf(-acc[s][j + 2][2 * h + 1]))));
    cluster.sync();
    pull_slices<C>(zs, lds, WIN, rank);
    __syncthreads();

#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(bl + col(s, j));
        acc[s][j][0] = v.x; acc[s][j][1] = v.y; acc[s][j][2] = v.x; acc[s][j][3] = v.y;
      }
    product<NSUB, NS, KCH>(acc, zs + warp * 16 * lds, lds, C / 8, C / 8,
                      w_rs + ((size_t)l * NCL + rank) * (C / 8) * WSTEP, wbuf, bars, it, lane);
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, c = col(s, j);
          const float res0 = acc[s][j][2 * h], res1 = acc[s][j][2 * h + 1];
          const float sk0 = acc[s][j + 2][2 * h], sk1 = acc[s][j + 2][2 * h + 1];
          const float2 xo = *reinterpret_cast<const float2*>(xs + (r + pad) * lds + c);
          if constexpr (DEEP) {
            if (t0 + r < T) {
              const size_t o = ((size_t)b * T + t0 + r) * C + c;
              const float2 sp = l == 0 ? make_float2(0.f, 0.f)
                                       : *reinterpret_cast<const float2*>(skip_g + o);
              if (l < L - 1) {
                *reinterpret_cast<float2*>(out + o) =
                    make_float2((xo.x + res0) * ms[r], (xo.y + res1) * ms[r]);
                *reinterpret_cast<float2*>(skip_g + o) = make_float2(sp.x + sk0, sp.y + sk1);
              } else {
                *reinterpret_cast<float2*>(out + o) =
                    make_float2((sp.x + res0) * ms[r], (sp.y + res1) * ms[r]);
              }
            }
          } else if (l < L - 1) {
            *reinterpret_cast<float2*>(xs + (r + pad) * lds + c) =
                make_float2((xo.x + res0) * ms[r], (xo.y + res1) * ms[r]);
            skip[s][j][2 * h] += sk0;
            skip[s][j][2 * h + 1] += sk1;
          } else if (r >= halo && r < WIN - halo && t0 + r < T) {
            *reinterpret_cast<float2*>(out + ((size_t)b * T + t0 + r) * C + c) = make_float2(
                (skip[s][j][2 * h] + res0) * ms[r], (skip[s][j][2 * h + 1] + res1) * ms[r]);
          }
        }
    if (!DEEP && l < L - 1) {
      cluster.sync();
      pull_slices<C>(xs + pad * lds, lds, WIN, rank);
      __syncthreads();
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <int NSUB>
size_t smem_bytes(int K) {
  constexpr int C = 64 * NSUB;
  return ((size_t)RING * kch<NSUB>() * 2 * NSUB * 256 + (2 * WIN + 2 * (K / 2)) * (C + 4) +
          WIN) * sizeof(float) + RING * sizeof(uint64_t);
}

constexpr size_t MAX_SMEM = 232448;   // the most shared memory a CTA may have

template <int NSUB, bool DEEP>
int launch(const float* x, const float* mask, const float* cond, const float* w_in,
           const float* w_rs, const float* b_rs, float* out, float* skip, int B, int T, int L,
           int K, int layer, cudaStream_t stream) {
  const int halo = DEEP ? 0 : L * (K / 2);
  const int tile = WIN - 2 * halo;
  const size_t smem = smem_bytes<NSUB>(K);
  if (K % 2 == 0 || tile < 16 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // once per instantiation: the most any launch of it may ask for
  static const cudaError_t attr = cudaFuncSetAttribute(
      wn_stack_kernel<NSUB, DEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NCL * ((T + tile - 1) / tile), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = NCL;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, wn_stack_kernel<NSUB, DEEP>, x, mask, cond,
                                             w_in, w_rs, b_rs, out, skip, T, L, K, halo, layer);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool DEEP>
int launch_c(const float* x, const float* mask, const float* cond, const float* w_in,
             const float* w_rs, const float* b_rs, float* out, float* skip, int B, int T, int C,
             int L, int K, int layer, cudaStream_t stream) {
  switch (C) {
    case 64:
      return launch<1, DEEP>(x, mask, cond, w_in, w_rs, b_rs, out, skip, B, T, L, K, layer,
                             stream);
    case 128:
      return launch<2, DEEP>(x, mask, cond, w_in, w_rs, b_rs, out, skip, B, T, L, K, layer,
                             stream);
    case 192:
      return launch<3, DEEP>(x, mask, cond, w_in, w_rs, b_rs, out, skip, B, T, L, K, layer,
                             stream);
    case 256:
      return launch<4, DEEP>(x, mask, cond, w_in, w_rs, b_rs, out, skip, B, T, L, K, layer,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: [B, T, C]; mask: [B, T]; cond: [B, L, 2C]; b_rs: [L, 2C]; w_in,
// w_rs: prepare_weights' layouts, [L, NCL, K·C/8, 2, C/64, 4, 2, 8, 4] and
// [L, NCL, C/8, 2, C/64, 4, 2, 8, 4]; all f32 contiguous.  C ∈ {64, 128, 192,
// 256}; K odd; L·(K//2) ≤ 24; the shared memory (smem_bytes) within the
// CTA's 227 KB.  Returns the launch's cudaError_t.
extern "C" int wn_stack_launch(const float* x, const float* mask, const float* cond,
                               const float* w_in, const float* w_rs, const float* b_rs,
                               float* out, int B, int T, int C, int L, int K, void* stream) {
  return launch_c<false>(x, mask, cond, w_in, w_rs, b_rs, out, nullptr, B, T, C, L, K, 0,
                         static_cast<cudaStream_t>(stream));
}

// One layer of the per-layer mode, any L: x is layer `layer`'s input state,
// out receives the next layer's state, or the stack's output when layer =
// L − 1; skip [B, T, C] f32 carries the skip sum between launches (layer 0
// writes it; it must not alias x or out).  Shapes and rules as above, any L.
extern "C" int wn_stack_layer_launch(const float* x, const float* mask, const float* cond,
                                     const float* w_in, const float* w_rs, const float* b_rs,
                                     float* out, float* skip, int B, int T, int C, int L, int K,
                                     int layer, void* stream) {
  if (layer < 0 || layer >= L) return (int)cudaErrorInvalidValue;
  return launch_c<true>(x, mask, cond, w_in, w_rs, b_rs, out, skip, B, T, C, L, K, layer,
                        static_cast<cudaStream_t>(stream));
}
