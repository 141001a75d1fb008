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
// dilations 1, 3, 5).
//
// What bounds it: at fold 4 the 18 folded convs hold 92 taps of 128 × 128;
// over T/fold folded frames that is 2·92·128² flops per folded frame, 540
// GFLOP at 716 800 samples (0.55 ms at the bf16 peak), 2.9× the 185 GFLOP
// of the unfolded stage — tensor-core bound.  The halo makes a window cover
// 192 / 154 = 1.25× its tile.
//
// What the bf16 design does about it (kernel C's, csrc/mrf_stage.cu):
// - Each conv is a GEMM on wgmma m64n128k16 (N = the 128 folded channels,
//   f32 accumulators in registers).  Three warpgroups own one fixed 64-row
//   M tile of the window each, for every conv: the window's rows
//   [0, 64), [64, 128), [128, 192).  A row outside the part of the window a
//   conv still has to get right computes on the rows beside it and is never
//   read by a row that has to be right (the halo's accounting), so no tile
//   moves and the edge tiles read at most PADR rows of zeroed slack beyond
//   the window.
// - A is the conv input shifted by the tap's offset, read from shared memory
//   by descriptor: the input is kept as [CF/8][HR rows][8] column chunks, so
//   the 8 rows from any shift are one contiguous core matrix.  B is the tap's
//   [cout/8][cin/8][8][8] core-matrix tile (32 KB), laid out once by
//   ops/kernels/mrf_stage_folded.py::prepare_weights in the order the block
//   takes the taps.  The taps stream by bulk copies (the tensor memory
//   accelerator) into a ring of NSLOT = 3 slots, each with a "full" mbarrier
//   (the copy's bytes) and an "empty" one (one arrival per warp), so no
//   block-wide barrier separates two taps: while tap i's products run, warp
//   0 waits until every warp has left tap i − 1's slot and copies tap
//   i − 1 + NSLOT into it.  One commit group per tap, with the tap before
//   still in flight.  There is no producer warp: ptxas gives a block
//   registers by whole warpgroups, and a fourth would cut every thread to 128
//   registers (a first build spilled 692 bytes there and serialized the
//   wgmma, C7512); three give 168.
// - Every block reads the 3.0 MB of weights from L2, 3.5 GB a launch at
//   B = 1 (1 164 blocks): at 192 rows a block a tap's products need its
//   32 KB in ~1 500 cycles, about 5 TB/s over 132 SMs.  The ring's depth
//   hides it: on an H100 SXM 2 slots are ~1.3× slower than 3, and 4 or 5 no
//   faster (tools/ablate_mrf_stage_folded.py).  Two CTAs of a cluster
//   sharing each tap, each copying half of it into both by multicast, halved
//   the L2 reads and gained nothing (and with the ring's barriers at cluster
//   scope were ~1.5× slower), so a block streams its taps alone.
// - The branch state lives in registers, in the accumulators' own layout (64
//   f32 a thread): the second conv's epilogue adds into it and writes the
//   next unit's input in one pass, with no shared-memory round trip.  The
//   sum of the branches before the last lives in global memory, f32, the
//   block's own scratch (element i of thread j at i · 384 + j: coalesced,
//   touched twice per branch, and in L2 while the block runs); the last
//   branch's state goes straight to the output.  One conv input buffer: a
//   conv's epilogue overwrites it once every warpgroup's products have read
//   it (two block barriers per conv, none per tap).
// - Shared memory (bytes): conv input 128 × 208 × 2 = 53 248 (192 rows and 8
//   slack rows on each side); ring 3 × 32 768 = 98 304; barriers 48:
//   151 600 of the 232 448 a block may have.  A branch sum there (98 304)
//   would leave room for two slots; a state there (104 KB) for one.
// - ptxas serializes every wgmma of a kernel that calls a function, that
//   branches divergently between two of them, or that moves their
//   accumulators: the host passes 1 / n_br (no division), the warpgroup index
//   goes through a shuffle, the ring's arrivals are predicated inside their
//   asm, the loads of x are selects, and every warpgroup has a tile of every
//   conv (no path without the wgmma).
// f32 runs on the CUDA cores (only the f32 checks use it): each warp owns a
// 16-row slab of the rows a conv still needs, the state in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CF = 128;             // folded channels computed
constexpr int WIN = 192;            // window rows (folded frames) per block
constexpr int MAXB = 4, MAXU = 4;

struct FoldSpec {
  int n_br, n_unit;
  int pad[MAXB][MAXU][2][2];  // [branch][unit][conv][pad_lo, pad_hi]
  float inv_br;               // 1 / n_br: a division is a call, and ptxas serializes every
                              // wgmma of a kernel that makes one
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// ---------------------------------------------------------------- f32 path
// 384 threads, 12 warps, one 16-row slab each; state and conv input in f32.

constexpr int HROWS = WIN + 16;     // conv-input rows: the last 16-row slab may read past WIN
constexpr int LD = CF + 4;          // f32 row
constexpr int NT_F32 = 384;
constexpr int PER = WIN * CF / NT_F32;  // branch-sum elements per thread

// Window rows [lo, hi) of y = bias + Σ_tap h[r + tap − plo] · w[tap] on the
// CUDA cores: w [taps][cin][cout] read through the read-only cache; lane l
// owns columns [4l, 4l + 4) of its warp's slab.  MODE 0: h = leaky(y·valid)
// in place;  MODE 1: st += y·valid.
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

__global__ void __launch_bounds__(NT_F32, 1)
mrf_folded_kernel_f32(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ /* scratch: the bf16 kernel's */, int Tf, int cf,
                      int halo, FoldSpec spec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);   // branch state
  float* h = st + WIN * LD;                     // conv input
  const int tile = WIN - 2 * halo;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - halo;  // folded frame of window row 0
  const float* xb = x + (size_t)b * Tf * cf;

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
    for (int i = threadIdx.x; i < (hi - lo) * CF; i += NT_F32) {
      const int r = lo + i / CF, c = i % CF, t = t0 + r;
      st[r * LD + c] = (t >= 0 && t < Tf && c < cf) ? xb[(size_t)t * cf + c] : 0.f;
    }
    for (int u = 0; u < spec.n_unit; ++u) {
      const int plo1 = spec.pad[br][u][0][0], phi1 = spec.pad[br][u][0][1];
      const int plo2 = spec.pad[br][u][1][0], phi2 = spec.pad[br][u][1][1];
      const int taps1 = plo1 + phi1 + 1, taps2 = plo2 + phi2 + 1;
      __syncthreads();
      for (int i = threadIdx.x; i < (hi - lo) * CF; i += NT_F32) {
        const int r = lo + i / CF, c = i % CF;
        h[r * LD + c] = leaky(st[r * LD + c]);
      }
      __syncthreads();
      conv_f32<0>(h, st, w + woff, bias + boff, plo1, taps1, lo + plo1, hi - phi1, t0, Tf);
      woff += (size_t)taps1 * CF * CF;
      boff += CF;
      conv_f32<1>(h, st, w + woff, bias + boff, plo2, taps2, lo + plo1 + plo2,
                  hi - phi1 - phi2, t0, Tf);
      woff += (size_t)taps2 * CF * CF;
      boff += CF;
      lo += plo1 + plo2;
      hi -= phi1 + phi2;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NT_F32;
      acc[j] += st[(i / CF) * LD + i % CF];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * NT_F32;
    const int r = i / CF, c = i % CF, t = t0 + r;
    if (r >= halo && r < halo + tile && t < Tf && c < cf)
      out[((size_t)b * Tf + t) * cf + c] = acc[j] / spec.n_br;
  }
}

constexpr size_t SMEM_F32 = (size_t)WIN * LD * sizeof(float) + (size_t)HROWS * LD * sizeof(float);

// --------------------------------------------------------------- bf16 path

constexpr int NWG = WIN / 64;        // warpgroups: one fixed 64-row M tile each
constexpr int NCW = NWG * 4;         // warps
constexpr int NCT = NCW * 32;        // threads: whole warpgroups, so 168 registers a thread
constexpr int NACC = 64;             // f32 accumulators a thread: 64 rows × 128 columns / 128
constexpr int PADR = 8;              // slack rows on each side of the window: a conv's pads ≤ 8
constexpr int HR = WIN + 2 * PADR;   // conv-input rows
constexpr int NSLOT = 3;             // taps in the weight ring
constexpr int TAP = CF * CF;         // bf16 per tap: 32 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// one bulk copy (the tensor memory accelerator) global → shared by the
// thread where `pred` holds, completing its bytes on bar; predicated inside
// the asm, as the arrivals are
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

// shared-memory matrix descriptor, K-major core matrices (8 rows × 16
// bytes, contiguous) without swizzle: lbo bytes between core matrices
// along K, sbo along M or N
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// the compiler keeps the accumulators' reads and writes on their side of
// the asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 rows × 128 columns, f32) += A (64 rows × 16 k, bf16) · B (16 k ×
// 128 columns, bf16), both from shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[NACC], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The weight ring: every tap of every conv in the order the block takes
// them; `it` counts the taps a thread has taken (the same in every thread),
// which names the slot and its barriers' phase.  Tap i − 1 + NSLOT is copied
// into the slot tap i − 1 leaves, by warp 0 once every warp has left it.
struct Ring {
  const __nv_bfloat16* w;       // total × TAP, global
  __nv_bfloat16* slots;         // NSLOT × TAP
  uint64_t* full;               // NSLOT: the tap's bytes have landed
  uint64_t* empty;              // NSLOT: every warp is done with it
  uint32_t total;               // taps of the stage
};

// the copy of tap i into its slot, by the thread where `pred` holds
__device__ __forceinline__ void copy_tap(const Ring& ring, uint32_t i, bool pred) {
  bulk_load_if(ring.slots + (i % NSLOT) * TAP, ring.w + (size_t)i * TAP,
               TAP * sizeof(__nv_bfloat16), ring.full + i % NSLOT, pred);
}

// The conv input, bf16, as wgmma reads its A operand: [CF/8 column chunks]
// [HR rows][8 columns], window row r at row PADR + r, so the 8 rows × 8
// columns from any row on are one contiguous core matrix whatever the tap's
// row shift
__device__ __forceinline__ int hidx(int r, int c) {
  return ((c >> 3) * HR + PADR + r) * 8 + (c & 7);
}

// One conv: y = bias + Σ_tap h[r + tap − plo] · w[tap] over the warpgroup's
// rows [64·wg, 64·wg + 64), f32 accumulators in registers; the taps come
// through the ring, each as 8 wgmma k-steps, one commit group per tap with
// the tap before still in flight.  Then, once every warpgroup has read h:
//   MODE 0: h = leaky(y·valid)
//   MODE 1: st += y·valid; h = leaky(st) (the next unit's input)
// The thread's element i of st or the accumulators is row
// 64·wg + 16·warp + lane/4 + 8·((i/2) % 2), column 8·(i/4) + 2·(lane % 4) + i % 2.
template <int MODE>
__device__ __forceinline__ void conv_bf16(__nv_bfloat16* h, float (&st)[NACC], const Ring& ring,
                                          uint32_t& it, const float* __restrict__ bias, int plo,
                                          int taps, int wg, bool lead, int t0, int Tf) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  fence_acc(acc);
  const __nv_bfloat16* a0 = h + (PADR + 64 * wg - plo) * 8;
  int prev = -1;
  for (int tap = 0; tap < taps; ++tap, ++it) {
    const int slot = it % NSLOT;
    mbar_wait(ring.full + slot, (it / NSLOT) & 1);
    const __nv_bfloat16* a = a0 + tap * 8;
    const __nv_bfloat16* b = ring.slots + slot * TAP;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < CF / 16; ++ks)
      wgmma_m64n128k16(acc, smem_desc(a + 2 * ks * HR * 8, HR * 16, 128),
                       smem_desc(b + 2 * ks * 64, 128, (CF / 8) * 128));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the tap before is done with its slot once at most this tap's group is pending
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    mbar_arrive_if(ring.empty + max(prev, 0), prev >= 0 && lane == 0);
    prev = slot;
    // warp 0 refills the slot of tap it − 1 with tap it − 1 + NSLOT while this tap's
    // products run
    if (lead && it >= 1 && it - 1 + NSLOT < ring.total) {
      mbar_wait(ring.empty + (it - 1) % NSLOT, ((it - 1) / NSLOT) & 1);
      copy_tap(ring, it - 1 + NSLOT, lane == 0);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  mbar_arrive_if(ring.empty + prev, lane == 0);
  __syncthreads();   // every warpgroup's products have read h: the epilogue overwrites it

  float valid[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = t0 + 64 * wg + 16 * warp + g + 8 * hr;
    valid[hr] = (t >= 0 && t < Tf) ? 1.f : 0.f;
  }
#pragma unroll
  for (int j = 0; j < CF / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 64 * wg + 16 * warp + g + 8 * hr, e = 4 * j + 2 * hr;
      float y0 = (acc[e] + bv.x) * valid[hr];
      float y1 = (acc[e + 1] + bv.y) * valid[hr];
      if (MODE == 1) {
        y0 = st[e] += y0;
        y1 = st[e + 1] += y1;
      }
      *reinterpret_cast<__nv_bfloat162*>(h + hidx(r, c)) =
          __floats2bfloat162_rn(leaky(y0), leaky(y1));
    }
  }
  fence_async_smem();
  __syncthreads();   // the next conv's products read what every warpgroup wrote
}

__global__ void __launch_bounds__(NCT, 1)
mrf_folded_kernel_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ scratch, int Tf, int cf, int halo, FoldSpec spec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem);             // conv input
  __nv_bfloat16* slots = h + CF * HR;                                    // the weight ring
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + NSLOT * TAP);     // full, then empty
  uint32_t total = 0;
  for (int br = 0; br < spec.n_br; ++br)
    for (int u = 0; u < spec.n_unit; ++u)
      for (int c = 0; c < 2; ++c) total += spec.pad[br][u][c][0] + spec.pad[br][u][c][1] + 1;
  const Ring ring{w, slots, bars, bars + NSLOT, total};
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the slack rows beyond the window: the edge tiles' shifted taps read
  // them, nothing writes them
  for (int i = threadIdx.x; i < (CF / 8) * 2 * PADR; i += NCT) {
    const int chunk = i / (2 * PADR), k = i % (2 * PADR);
    const int row = k < PADR ? k : WIN + k;
    *reinterpret_cast<uint4*>(h + (chunk * HR + row) * 8) = make_uint4(0, 0, 0, 0);
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0)
    for (uint32_t i = 0; i < NSLOT && i < total; ++i) copy_tap(ring, i, true);

  // the warpgroup index through a shuffle, so the compiler knows it is the
  // same in every thread of a warp and the wgmma sit on no divergent path
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const bool lead = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0) == 0;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tile = WIN - 2 * halo;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - halo;  // folded frame of window row 0
  const __nv_bfloat16* xb = x + (size_t)b * Tf * cf;
  float st[NACC];   // the branch state of this thread's elements
  // the branch sum of branches before the last, this block's own part of
  // the scratch, element i of thread j at i · NCT + j: coalesced, and live
  // in L2 only while the block runs
  float* osum = scratch + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * NACC * NCT;
  uint32_t it = 0;
  const float* bb = bias;
  for (int br = 0; br < spec.n_br; ++br) {
    // state = x and the first conv's input leaky(x); selects, not branches
#pragma unroll
    for (int j = 0; j < CF / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 64 * wg + 16 * warp + g + 8 * hr, t = t0 + r, c = 8 * j + 2 * tq;
        const int e = 4 * j + 2 * hr;
        const bool ok = t >= 0 && t < Tf && c < cf;
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            xb + (ok ? (size_t)t * cf + c : 0)));
        st[e] = ok ? v.x : 0.f;
        st[e + 1] = ok ? v.y : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(h + hidx(r, c)) =
            __floats2bfloat162_rn(leaky(st[e]), leaky(st[e + 1]));
      }
    fence_async_smem();
    __syncthreads();
    for (int u = 0; u < spec.n_unit; ++u) {
      const int plo1 = spec.pad[br][u][0][0], taps1 = plo1 + spec.pad[br][u][0][1] + 1;
      const int plo2 = spec.pad[br][u][1][0], taps2 = plo2 + spec.pad[br][u][1][1] + 1;
      conv_bf16<0>(h, st, ring, it, bb, plo1, taps1, wg, lead, t0, Tf);
      conv_bf16<1>(h, st, ring, it, bb + CF, plo2, taps2, wg, lead, t0, Tf);
      bb += 2 * CF;
    }
    // the branch sum: written after the first branch, added to after the
    // others but the last, whose state stays in registers for the output
    if (br + 1 < spec.n_br) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        float* p = osum + i * NCT + threadIdx.x;
        *p = (br > 0 ? *p : 0.f) + st[i];
      }
    }
  }
  // the output: the earlier branches' sum (loaded whether or not the
  // element is stored, so the loads go out together) plus the last state
#pragma unroll
  for (int j = 0; j < CF / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 64 * wg + 16 * warp + g + 8 * hr, t = t0 + r, c = 8 * j + 2 * tq;
      const int e = 4 * j + 2 * hr;
      const float s0 = spec.n_br > 1 ? osum[e * NCT + threadIdx.x] : 0.f;
      const float s1 = spec.n_br > 1 ? osum[(e + 1) * NCT + threadIdx.x] : 0.f;
      if (r >= halo && r < halo + tile && t < Tf && c < cf)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * Tf + t) * cf + c) =
            __floats2bfloat162_rn((s0 + st[e]) * spec.inv_br, (s1 + st[e + 1]) * spec.inv_br);
    }
}

constexpr size_t SMEM_BF16 = (size_t)CF * HR * sizeof(__nv_bfloat16) +
                             (size_t)NSLOT * TAP * sizeof(__nv_bfloat16) +
                             2 * NSLOT * sizeof(uint64_t);
static_assert(SMEM_BF16 <= 232448, "kernel D's bf16 block exceeds the shared memory of an SM");
static_assert(WIN % 64 == 0, "the window is whole 64-row wgmma tiles");

template <typename TIO, typename K>
int launch(K kernel, int threads, size_t smem, const void* x, const void* w, const float* bias,
           void* out, float* scratch, int B, int Tf, int cf, int halo, const FoldSpec& spec,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = WIN - 2 * halo;
  dim3 grid((Tf + tile - 1) / tile, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const TIO*>(x), static_cast<const TIO*>(w),
                                          bias, static_cast<TIO*>(out), scratch, Tf, cf, halo,
                                          spec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, Tf, cf] (the stage's [B, T, C] read folded) in the I/O dtype
// (is_bf16: bf16, else f32), contiguous; cf ≤ 128, a multiple of 16.
// w: per branch, per unit, conv1 then conv2, each tap 128 × 128 in the I/O
// dtype (zero-padded past cf): bf16 as [cout/8][cin/8][8 cout][8 cin] core
// matrices, f32 as [cin][cout]; taps = pad_lo + pad_hi + 1; bias: f32, same
// order, [128] each.  pads: [n_br][n_unit][2 convs][pad_lo, pad_hi], each
// ≤ 8 for bf16.  Every branch's summed pads on each side ≤ halo, and
// 192 − 2·halo ≥ 16.  scratch (bf16 only; f32 may pass null): f32, 64 × 384
// a block of the grid, B · ⌈Tf / (192 − 2·halo)⌉ blocks.  Returns the
// launch's cudaError_t.
extern "C" int mrf_stage_folded_launch(const void* x, const void* w, const float* bias,
                                       void* out, float* scratch, int B, int Tf, int cf,
                                       int n_br, int n_unit, const int* pads, int halo,
                                       int is_bf16, void* stream) {
  if (n_br < 1 || n_br > MAXB || n_unit < 1 || n_unit > MAXU || cf < 16 || cf > CF ||
      cf % 16 != 0 || halo < 0 || WIN - 2 * halo < 16)
    return (int)cudaErrorInvalidValue;
  FoldSpec spec{};
  spec.n_br = n_br;
  spec.n_unit = n_unit;
  spec.inv_br = 1.f / n_br;
  for (int br = 0; br < n_br; ++br) {
    int rl = 0, rr = 0;
    for (int u = 0; u < n_unit; ++u)
      for (int c = 0; c < 2; ++c) {
        const int* p = pads + ((br * n_unit + u) * 2 + c) * 2;
        if (p[0] < 0 || p[1] < 0 || (is_bf16 && (p[0] > PADR || p[1] > PADR)))
          return (int)cudaErrorInvalidValue;
        spec.pad[br][u][c][0] = p[0];
        spec.pad[br][u][c][1] = p[1];
        rl += p[0];
        rr += p[1];
      }
    if (rl > halo || rr > halo) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch<__nv_bfloat16>(mrf_folded_kernel_bf16, NCT, SMEM_BF16, x, w, bias,
                                         out, scratch, B, Tf, cf, halo, spec, s)
                 : launch<float>(mrf_folded_kernel_f32, NT_F32, SMEM_F32, x, w, bias, out,
                                 scratch, B, Tf, cf, halo, spec, s);
}
