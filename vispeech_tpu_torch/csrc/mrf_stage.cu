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
// What bounds it: 2·k·C² flops per sample per conv, 18 convs: ~1.03 MFLOP
// per sample, ~370 GFLOP for a 1400-frame bucket (358 400 samples) against
// 2·T·C·2 bytes of I/O and 1 MB of weights per block — tensor-core bound,
// 0.37 ms at the bf16 peak.  The halo makes the 64-row tiles cover 1.58×
// the centre's rows.
//
// What the bf16 design does about it:
// - Each conv is a GEMM on wgmma m64n64k16 (f32 accumulators in registers):
//   four consumer warpgroups take one 64-row M tile each.  A is the conv
//   input shifted by the tap's offset, read from shared memory by
//   descriptor: the inputs are kept as [C/8][rows][8] column chunks, so the
//   8 rows from any shift are one contiguous core matrix and no row shift
//   breaks the layout.  B is the tap's [cout][cin] tile.
// - The weights arrive prepared (ops/kernels/mrf_stage.py::prepare_weights):
//   every tap of every conv in the order the block uses them, as
//   [cout/8][cin/8][8][8] core matrices of 8 KB.  A producer warp streams
//   them by bulk copies (the tensor memory accelerator) into a ring of
//   NSLOT taps, each slot with a "full" mbarrier (the copy's bytes) and an
//   "empty" one (one arrival per consumer warp), so no block-wide barrier
//   separates the taps.  One commit group per tap, with the tap before
//   still in flight.
// - The second conv's epilogue adds into the state and writes the next
//   unit's input in one pass; the branch sum of the window centre stays in
//   registers of warpgroups 0 and 1.
// - ptxas serializes every wgmma of a kernel that calls a function, that
//   branches divergently between two of them, or that moves their
//   accumulators: the host passes 1 / n_br (no division), the warpgroup
//   index goes through a shuffle, the ring's arrivals are predicated inside
//   their asm, and the accumulators live only on the path of a warpgroup
//   that has a tile.
// f32 runs the same tiles on the CUDA cores (only the f32 checks use it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;
constexpr int TT = 128;
constexpr int HALO = 64;
constexpr int WIN = TT + 2 * HALO;
constexpr int LD = C + 1;        // f32 smem row: rows 8 apart fall in other banks
constexpr int MAXB = 4, MAXU = 4;

struct MrfSpec {
  int n_br, n_unit;
  int k[MAXB];
  int dil[MAXB][MAXU];
  float inv_br;   // 1 / n_br: a division is a call, and ptxas serializes every wgmma of a
                  // kernel that makes one
};

__device__ __forceinline__ int receptive_radius(const MrfSpec& spec, int br) {
  const int half = (spec.k[br] - 1) / 2;
  int radius = 0;
  for (int u = 0; u < spec.n_unit; ++u) radius += half * spec.dil[br][u] + half;
  return radius;
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


// ---------------------------------------------------------------- f32 path
// 256 threads: 16 column groups × 16 row groups; the conv inputs in f32.

constexpr int NT_F32 = 256;

__global__ void __launch_bounds__(NT_F32, 1)
mrf_stage_kernel_f32(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int T,
                     MrfSpec spec) {
  constexpr int PER = TT * C / NT_F32;  // centre elements per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);   // branch state
  float* h = st + WIN * LD;                     // first conv input
  float* h2 = h + WIN * LD;                     // second conv input
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT - HALO;  // global sample of window row 0
  const float* xb = x + (size_t)b * T * C;

  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  size_t woff = 0, boff = 0;
  for (int br = 0; br < spec.n_br; ++br) {
    const int k = spec.k[br], half = (k - 1) / 2;
    const int radius = receptive_radius(spec, br);
    int lo = HALO - radius, hi = HALO + TT + radius;
    __syncthreads();
    for (int i = threadIdx.x; i < (hi - lo) * C; i += NT_F32) {
      const int r = lo + i / C, c = i % C, t = t0 + r;
      st[r * LD + c] = (t >= 0 && t < T) ? xb[(size_t)t * C + c] : 0.f;
    }
    for (int u = 0; u < spec.n_unit; ++u) {
      const int d = spec.dil[br][u];
      __syncthreads();
      for (int i = threadIdx.x; i < (hi - lo) * C; i += NT_F32) {
        const int r = lo + i / C, c = i % C;
        h[r * LD + c] = leaky(st[r * LD + c]);
      }
      __syncthreads();
      const int r1 = half * d, r2 = half;
      conv_f32<0>(h, h2, st, w + woff, bias + boff, k, d, lo + r1, hi - r1, t0, T);
      woff += (size_t)k * C * C;
      boff += C;
      __syncthreads();
      conv_f32<1>(h2, h2, st, w + woff, bias + boff, k, 1, lo + r1 + r2, hi - r1 - r2, t0, T);
      woff += (size_t)k * C * C;
      boff += C;
      lo += r1 + r2;
      hi -= r1 + r2;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NT_F32;
      acc[j] += st[(HALO + i / C) * LD + i % C];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT_F32, t = blockIdx.x * TT + i / C;
    if (t < T) out[((size_t)b * T + t) * C + i % C] = acc[j] / spec.n_br;
  }
}

// --------------------------------------------------------------- bf16 path

constexpr int NWG = 4;               // consumer warpgroups: one 64-row M tile of a conv each
constexpr int NCW = NWG * 4;         // consumer warps
constexpr int NCT = NCW * 32;        // consumer threads
constexpr int NT_BF16 = NCT + 32;    // and the producer warp
constexpr int LDS = C + 8;           // f32 state row: a half-warp's float2s hit distinct banks
constexpr int NSLOT = 6;             // taps in the weight ring
constexpr int TAP = C * C;           // bf16 per tap: 8 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the consumers' barrier (named barrier 1): the producer warp never joins it
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
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
// one bulk copy (the tensor memory accelerator) global → shared, completing
// its bytes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// shared-memory matrix descriptor, K-major core matrices (8 rows × 16
// bytes, contiguous) without swizzle: lbo bytes between core matrices
// along K, sbo along M or N
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// the compiler keeps the accumulators' reads and writes on their side of
// the asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 rows × 64 columns, f32) += A (64 rows × 16 k, bf16) · B (16 k × 64
// columns, bf16), both from shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// The weight ring: the producer streams taps in the order the consumers
// take them; `it` counts the taps a consumer has taken (the same in every
// consumer thread), which names the slot and its barriers' phase.
struct Ring {
  const __nv_bfloat16* slots;   // NSLOT × TAP
  uint64_t* full;               // NSLOT: the tap's bytes have landed
  uint64_t* empty;              // NSLOT: every consumer warp is done with it
};

// A conv input or output, bf16, as wgmma reads its A operand: [C/8 column
// chunks][WIN rows][8 columns], so the 8 rows × 8 columns from any row on
// are one contiguous core matrix whatever the tap's row shift
__device__ __forceinline__ int hidx(int r, int c) { return ((c >> 3) * WIN + r) * 8 + (c & 7); }

// One conv over window rows [lo, hi): y = bias + Σ_tap Σ_ci src[r + (tap −
// k/2)·d][ci]·w[tap][ci][:], f32 accumulators in registers.  Warpgroup wg
// takes the conv's M tile wg (64 rows; the last tile ends at hi and
// overlaps the one before, whose rows it does not write); the taps come
// through the ring, each as 4 wgmma k-steps, one commit group per tap with
// the tap before still in flight.  Epilogue, rows [wlo, whi) of the tile:
//   MODE 0: dst = leaky(y·valid)
//   MODE 1: st += y·valid; dst = leaky(st) (the next unit's input) when
//           NEXT; osum += st on the branch's last conv (the window centre)
template <int MODE>
__device__ __forceinline__ void conv_bf16(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                          float* st, float (&osum)[32], const Ring& ring,
                                          uint32_t& it, const float* __restrict__ bias, int k,
                                          int d, int lo, int hi, int t0, int T, bool next) {
  // the warpgroup index through a shuffle, so the compiler knows it is the
  // same in every thread of a warp and the wgmma below sit on no divergent path
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int half = (k - 1) / 2;
  const int ntiles = (hi - lo + 63) >> 6;
  const bool active = wg < ntiles;
  const int start = wg < ntiles - 1 ? lo + 64 * wg : hi - 64;
  float2 bv[8];   // this thread's bias columns, loaded while the products run
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * tq);
  if (!active) {
    // no tile of this conv: take the taps through the ring all the same
    for (int tap = 0; tap < k; ++tap, ++it) {
      const int slot = it % NSLOT;
      mbar_wait(ring.full + slot, (it / NSLOT) & 1);
      mbar_arrive_if(ring.empty + slot, lane == 0);
    }
    return;
  }
  // the accumulators live on this path only: merged with values from a
  // path without the wgmma, they would be read by moves between two of them
  // (and ptxas would serialize every wgmma of the kernel)
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_acc(acc);
  int prev = -1;
  for (int tap = 0; tap < k; ++tap, ++it) {
    const int slot = it % NSLOT;
    mbar_wait(ring.full + slot, (it / NSLOT) & 1);
    const __nv_bfloat16* a = src + (start + (tap - half) * d) * 8;
    const __nv_bfloat16* b = ring.slots + slot * TAP;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks)
      wgmma_m64n64k16(acc, smem_desc(a + 2 * ks * WIN * 8, WIN * 16, 128),
                      smem_desc(b + 2 * ks * 64, 128, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the tap before is done with its slot once at most this tap's group is pending
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    mbar_arrive_if(ring.empty + max(prev, 0), prev >= 0 && lane == 0);
    prev = slot;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  mbar_arrive_if(ring.empty + prev, lane == 0);

  const int wlo = lo + 64 * wg, whi = min(wlo + 64, hi);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float b0 = bv[j].x, b1 = bv[j].y;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = start + 16 * warp + g + 8 * hr, t = t0 + r;
      if (r >= wlo && r < whi) {
        const float valid = (t >= 0 && t < T) ? 1.f : 0.f;
        float y0 = (acc[4 * j + 2 * hr] + b0) * valid;
        float y1 = (acc[4 * j + 2 * hr + 1] + b1) * valid;
        if (MODE == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + hidx(r, c)) =
              __floats2bfloat162_rn(leaky(y0), leaky(y1));
        } else {
          float2* sp = reinterpret_cast<float2*>(st + r * LDS + c);
          const float2 s = *sp;
          y0 += s.x;
          y1 += s.y;
          if (next) {
            *sp = make_float2(y0, y1);
            *reinterpret_cast<__nv_bfloat162*>(dst + hidx(r, c)) =
                __floats2bfloat162_rn(leaky(y0), leaky(y1));
          } else {
            // the branch's last conv covers exactly the centre: tiles 0 and 1
            osum[4 * j + 2 * hr] += y0;
            osum[4 * j + 2 * hr + 1] += y1;
          }
        }
      }
    }
  }
  fence_async_smem();
}

__global__ void __launch_bounds__(NT_BF16, 1)
mrf_stage_kernel_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int T,
                      MrfSpec spec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);                             // branch state, f32
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(st + WIN * LDS);    // first conv input
  __nv_bfloat16* h2 = h + WIN * C;                                        // second conv input
  __nv_bfloat16* slots = h2 + WIN * C;                                    // the weight ring
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + NSLOT * TAP);      // full, then empty
  const Ring ring{slots, bars, bars + NSLOT};
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, threadIdx.x >> 5, 0) == NCW) {
    // the producer warp: every tap of every conv, NSLOT ahead of the slowest consumer warp
    if (threadIdx.x == NCT) {
      int taps = 0;
      for (int br = 0; br < spec.n_br; ++br) taps += 2 * spec.n_unit * spec.k[br];
      for (int i = 0; i < taps; ++i) {
        const int slot = i % NSLOT;
        if (i >= NSLOT) mbar_wait(ring.empty + slot, ((i / NSLOT) - 1) & 1);
        bulk_load(slots + slot * TAP, w + (size_t)i * TAP, TAP * sizeof(__nv_bfloat16),
                  ring.full + slot);
      }
    }
    return;
  }

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT - HALO;  // global sample of window row 0
  const __nv_bfloat16* xb = x + (size_t)b * T * C;
  uint32_t it = 0;
  float osum[32];   // warpgroups 0 and 1: the branch sum of the window centre's rows
#pragma unroll
  for (int i = 0; i < 32; ++i) osum[i] = 0.f;

  size_t boff = 0;
  for (int br = 0; br < spec.n_br; ++br) {
    const int k = spec.k[br], half = (k - 1) / 2;
    const int radius = receptive_radius(spec, br);
    int lo = HALO - radius, hi = HALO + TT + radius;
    // state = x and the first conv's input leaky(x), 8 columns a thread
    consumer_sync();
    for (int i = threadIdx.x; i < (hi - lo) * (C / 8); i += NCT) {
      const int r = lo + i / (C / 8), c = (i % (C / 8)) * 8, t = t0 + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t >= 0 && t < T) raw = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + c);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float v[8];
      uint4 hv;
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(&hv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(xv[q]);
        v[2 * q] = f.x;
        v[2 * q + 1] = f.y;
        hp[q] = __floats2bfloat162_rn(leaky(f.x), leaky(f.y));
      }
      float4* sp = reinterpret_cast<float4*>(st + r * LDS + c);
      sp[0] = make_float4(v[0], v[1], v[2], v[3]);
      sp[1] = make_float4(v[4], v[5], v[6], v[7]);
      *reinterpret_cast<uint4*>(h + hidx(r, c)) = hv;
    }
    fence_async_smem();
    for (int u = 0; u < spec.n_unit; ++u) {
      const int d = spec.dil[br][u];
      const int r1 = half * d, r2 = half;
      consumer_sync();
      conv_bf16<0>(h, h2, st, osum, ring, it, bias + boff, k, d, lo + r1, hi - r1, t0, T,
                   true);
      boff += C;
      consumer_sync();
      conv_bf16<1>(h2, h, st, osum, ring, it, bias + boff, k, 1, lo + r1 + r2, hi - r1 - r2,
                   t0, T, u + 1 < spec.n_unit);
      boff += C;
      lo += r1 + r2;
      hi -= r1 + r2;
    }
  }
  // warpgroups 0 and 1 own the centre rows HALO + [0, 64) and HALO + [64, 128)
  const int wg = threadIdx.x >> 7;
  if (wg >= 2) return;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = blockIdx.x * TT + 64 * wg + 16 * warp + g + 8 * hr;
      if (t < T)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * T + t) * C + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(osum[4 * j + 2 * hr] * spec.inv_br,
                                  osum[4 * j + 2 * hr + 1] * spec.inv_br);
    }
}

constexpr size_t SMEM_BF16 = (size_t)WIN * LDS * sizeof(float) +
                             (size_t)2 * WIN * C * sizeof(__nv_bfloat16) +
                             (size_t)NSLOT * TAP * sizeof(__nv_bfloat16) +
                             2 * NSLOT * sizeof(uint64_t);

constexpr size_t SMEM_F32 = (size_t)3 * WIN * LD * sizeof(float);

template <typename TIO, typename K>
int launch(K kernel, int threads, size_t smem, const void* x, const void* w, const float* bias,
           void* out, int B, int T, const MrfSpec& spec, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const TIO*>(x), static_cast<const TIO*>(w),
                                          bias, static_cast<TIO*>(out), T, spec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, T, 64] in the I/O dtype (is_bf16: bf16, else f32), contiguous.
// w: prepare_weights' layout in the I/O dtype — per branch, per unit, conv1
// then conv2, each tap [cout/8][cin/8][8][8] for bf16 and [cin][cout] for
// f32; bias: f32, [convs][64].  ks: [n_br]; dils: [n_br · n_unit].  n_br,
// n_unit ≤ 4; every branch's receptive radius ≤ 64.  Returns the launch's
// cudaError_t.
extern "C" int mrf_stage_launch(const void* x, const void* w, const float* bias, void* out,
                                int B, int T, int n_br, int n_unit, const int* ks,
                                const int* dils, int is_bf16, void* stream) {
  if (n_br < 1 || n_br > MAXB || n_unit < 1 || n_unit > MAXU) return (int)cudaErrorInvalidValue;
  MrfSpec spec{};
  spec.n_br = n_br;
  spec.n_unit = n_unit;
  spec.inv_br = 1.f / n_br;
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
  return is_bf16 ? launch<__nv_bfloat16>(mrf_stage_kernel_bf16, NT_BF16, SMEM_BF16, x, w, bias,
                                         out, B, T, spec, s)
                 : launch<float>(mrf_stage_kernel_f32, NT_F32, SMEM_F32, x, w, bias, out, B, T,
                                 spec, s);
}
