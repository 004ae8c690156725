// FiLM-SIREN field, `highest` (f32) precision, on Hopper tensor cores (sm_90a):
// every 256x256 product as three TF32 wgmma products (3xTF32), fed by a
// bulk-copy ring of pre-split weight stages. The port of
// e3dge_tpu/ops/pallas/siren_kernel.py::_siren_kernel (launched by
// siren_query_fused) for the precision of the f32 paths: the SDF grid and
// queries, the f32 image2image, and the field passes of both training stages.
// The `serving` (bf16) precision is siren_field_sm90.cu. Wrapper, host weight
// pack, plain version and launch counts: e3dge_torch/ops/siren_field.py.
//
// What it computes, per point (N = 64*64*24 = 98,304 per image at full width):
//   h_0   = sin(g_0 * (xyz W_0^T + b_0) + be_0)
//   h_i   = sin(g_i * (h_{i-1} W_i^T + b_i) + be_i)          i = 1 .. D-1
//   sdf   = h W_sigma^T + b_sigma                  (reads the UNMODULATED h)
//   h'    = (alpha + 1) * h + lbeta                (optional local SFT)
//   feat  = sin(g_v * (h' W_vh^T + dirs W_vd^T + b_v) + be_v)
//   rgb   = feat W_rgb^T + b_rgb
// FiLM vectors g/be per style row come from outside ([B, D+1, W]); one launch
// covers the batch. Two entries: siren_field_full (raw_h [B, N, W] an optional
// output) and siren_field_tex (SFT, view layer and rgb on a cached raw_h).
//
// Arithmetic (that of the plain version in `highest`, to f32 accuracy):
//   * each 256x256 product (layers 1..D-1, the view layer's h part) is
//     A_lo.B_hi + A_hi.B_lo + A_hi.B_hi on wgmma.m64n256k8 .f32.tf32.tf32, one
//     f32 accumulator: every small product of the layer first, then the big
//     ones (mma_layer says why). hi = rna(x) and lo = rna(x - hi)
//     (cvt.rna.tf32.f32): the card reads a 32-bit operand as TF32 by dropping
//     its low 13 bits, so both are rounded before use. The dropped lo.lo term
//     and lo's own rounding leave ~2^-22 relative per product.
//   * layer 0 (K=3), the view layer's dirs part (K=3) and the heads: f32 FMA.
//   * sinf (not __sinf: FiLM arguments reach tens of radians); the SFT
//     multiply then add, each rounded; everything else f32.
//
// What bounds it on an H100 SXM (495 TFLOP/s TF32 tensor cores, 67 TFLOP/s
// f32, 3.35 TB/s):
//   siren_field_full  1.05 MFLOP of 256x256 products per point: 103 GFLOP per
//                     image of 98,304 points, x3 for the split: 0.62 ms on the
//                     tensor cores. Bound by operations.
//   siren_field_tex   ~0.4 GB of f32 raw_h, alpha, lbeta in and feat out per
//                     image: 0.12 ms at 3.35 TB/s. Bound by bytes.
//
// Design (the serving kernel's pipeline; what changes is the A operand):
//   * A CTA is 2 consumer warpgroups + 1 producer warpgroup (setmaxnreg 240 /
//     24). Each consumer warpgroup owns 64 points of a 128-point tile through
//     all layers; the grid is persistent and walks (item, tile) pairs.
//   * A is fed from registers (the register-A wgmma form): an m64n256 f32
//     accumulator is 128 registers per thread, and two f32 A tiles split into
//     hi and lo (4 x 64 KB) would not fit in shared memory. Each thread keeps
//     its two rows of the layer's pre-activation z in a thread-private f32
//     tile in shared memory (64 KB per warpgroup, conflict-free 16-byte
//     slots): k8 block kk of thread t is one float4 at [kk][t]. The wgmma A
//     fragment of a thread (rows r0, r0+8; logical k = q, q+4) and its
//     accumulator (columns 2q, 2q+1 of each 8-column block) cover the same
//     (row, block) places, so the host permutes each 8-input block of the
//     weights (logical k <-> input [0,2,4,6,1,3,5,7][k]) and a layer's output
//     becomes the next layer's A operand with no exchange between threads.
//     Nothing crosses threads between layers: no warpgroup barrier.
//   * The next layer's activation, sin(g*(z+b)+be), runs where its A fragment
//     is loaded in the layer's first pass, two k8 blocks per ring stage, while
//     the tensor cores work on the stage before: the sines overlap the
//     products instead of following them (as a phase of its own between
//     layers it took 1.2 ms more on the H100 at B=4 x 98,304). A layer's
//     accumulator is stored as z after its last product.
//   * Weights are packed on the host (ops/siren_field.py::tf32_stages) into
//     24 stages per layer, one 128-byte row per output (K-major, 128-byte
//     swizzle), 32 KB each: 16 of [16 inputs' hi | their lo] for the first
//     pass, 8 of [32 inputs' hi] for the second (768 KB per layer per
//     128-point tile); one cp.async.bulk per stage into a 3-stage ring, full
//     and empty mbarriers per stage.
//   * raw_h, alpha, lbeta and feat move as 8-byte pieces of whole 32-byte
//     sectors (a quad covers 8 columns of a row); the heads are quad-shuffle
//     dot products.
//   Shared memory: 3 x 32 KB ring + 2 x 64 KB z tiles + 48 B barriers + 1 KB
//   alignment = 230,448 of the 232,448 bytes a block may use.
//   Registers per consumer thread (setmaxnreg 240; the producer keeps 24):
//   128 accumulator, 2 ring stages of A fragments (2 x 16), the next stage's
//   z and FiLM vectors (20), and sinf's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ring.cuh"

namespace {

using namespace sm90;

constexpr int W = 256;                          // hidden width
constexpr int ROWS = 64;                        // points per consumer warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups per CTA
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "register file");
constexpr int TILE = ROWS * CONSUMERS;          // points per CTA tile
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int KBLK = W / 8;                     // k8 blocks per layer
constexpr int SMALL_STAGES = W / 16;            // stages of a layer's first pass: 16 inputs' hi | lo per row
constexpr int BIG_STAGES = W / 32;              // stages of its second pass: 32 inputs' hi per row
constexpr int LAYER_STAGES = SMALL_STAGES + BIG_STAGES;
constexpr int NSTAGE = 3;                       // ring depth
constexpr uint32_t STAGE_BYTES = W * 128;       // 32 KB: one 128-byte row per output
constexpr int ZTILE_FLOAT4 = KBLK * 128;        // a warpgroup's z tile: [kk][thread] float4 (64 KB)
constexpr int SMEM_BYTES = 1024 + NSTAGE * STAGE_BYTES + CONSUMERS * ZTILE_FLOAT4 * 16 + 2 * NSTAGE * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory a block may use");

struct F32Args {
  const float* pts;       // [B, N, 3]  (full only)
  const float* dirs;      // [B, N, 3]
  const float* w0t;       // [3, W]
  const float* wring;     // [D-1, LAYER_STAGES, W, 32] TF32 stages of layers 1..D-1
  const float* wvring;    // [LAYER_STAGES, W, 32] stages of the view layer's h part
  const float* bst;       // [D, W]
  const float* wvdt;      // [3, W]
  const float* bv;        // [W]
  const float* wsig;      // [W]
  const float* wrgb;      // [3, W]
  const float* bheads;    // [4]
  const float* gamma;     // [B, film_rows, W]
  const float* beta;      // [B, film_rows, W]
  const float* alpha;     // [B, N, W] or null
  const float* lbeta;     // [B, N, W] or null
  const float* raw_h_in;  // [B, N, W] (tex only)
  float* feat;            // [B, N, W]
  float* out;             // [B, N, out_cols]
  float* raw_h_out;       // [B, N, W] or null (full only)
  int N, D, film_rows, out_cols, tiles_per_item, n_tiles;
};

// ------------------------------------------------------------------ wgmma

// acc (+)= A[64 x 8] * B[8 x 256]: A from registers (tf32, the fragment of
// rows r0, r0+8 and logical k q, q+4), B from shared memory (K-major, tf32)
__device__ __forceinline__ void wgmma_tf32(float (&d)[W / 2], const uint32_t (&a)[4], uint64_t db, int accumulate) {
#define WG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R16(i) WG_R4(i), WG_R4(i + 4), WG_R4(i + 8), WG_R4(i + 12)
#define WG_R64(i) WG_R16(i), WG_R16(i + 16), WG_R16(i + 32), WG_R16(i + 48)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : WG_R64(0), WG_R64(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
#undef WG_R64
#undef WG_R16
#undef WG_R4
}

// keeps the compiler from moving accumulator reads/writes across the async wgmma
__device__ __forceinline__ void fence_acc(float (&d)[W / 2]) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ----------------------------------------------------------------- arithmetic

__device__ __forceinline__ float2 ld_f2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }

__device__ __forceinline__ void st_f2(float* p, float x, float y) { *reinterpret_cast<float2*>(p) = make_float2(x, y); }

// round to the nearest TF32 value, ties away from zero (low 13 bits zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// z layout per thread (r0 = 16*warp + lane/4, q = lane % 4; c = 8kk + 2q):
//   float4 [kk] = {(r0, c), (r0, c+1), (r0+8, c), (r0+8, c+1)};
//   acc[4kk + e] holds the same four places in the same order.
// The A fragment's registers are {(r0, q), (r0+8, q), (r0, q+4), (r0+8, q+4)}
// in logical k, which the weight permutation maps to columns c, c, c+1, c+1.
__device__ __forceinline__ void split4(float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {v.x, v.z, v.y, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = to_tf32(x[i]);
    lo[i] = to_tf32(__fsub_rn(x[i], __uint_as_float(hi[i])));
  }
}

// sin(g * (z + b) + be), each operation rounded as the plain version rounds it
__device__ __forceinline__ float film(float z, float b, float g, float e) {
  return sinf(__fadd_rn(__fmul_rn(g, __fadd_rn(z, b)), e));
}

__device__ __forceinline__ void hi4(float4 v, uint32_t (&hi)[4]) {
  hi[0] = to_tf32(v.x);
  hi[1] = to_tf32(v.z);
  hi[2] = to_tf32(v.y);
  hi[3] = to_tf32(v.w);
}

// FiLM activation of a float4 of z at columns c, c+1
__device__ __forceinline__ float4 film4(float4 z, float2 b, float2 g, float2 e) {
  return make_float4(film(z.x, b.x, g.x, e.x), film(z.y, b.y, g.y, e.y), film(z.z, b.x, g.x, e.x),
                     film(z.w, b.y, g.y, e.y));
}

// f32 xyz of the thread's two rows (zero past the tile's valid rows)
__device__ __forceinline__ void load_rows3(float (&x)[2][3], const float* src, size_t row_base, int r0, int nvalid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int d = 0; d < 3; ++d) x[h][d] = r < nvalid ? __ldg(src + (row_base + r) * 3 + d) : 0.f;
  }
}

// z (+)= x . w over K = 3 at columns c, c+1 (w: [3, W] f32)
__device__ __forceinline__ float4 k3_fma(float4 z, const float (&x)[2][3], const float* w, int c) {
  const float2 w0 = ld_f2(w + c), w1 = ld_f2(w + W + c), w2 = ld_f2(w + 2 * W + c);
  z.x = fmaf(x[0][2], w2.x, fmaf(x[0][1], w1.x, fmaf(x[0][0], w0.x, z.x)));
  z.y = fmaf(x[0][2], w2.y, fmaf(x[0][1], w1.y, fmaf(x[0][0], w0.y, z.y)));
  z.z = fmaf(x[1][2], w2.x, fmaf(x[1][1], w1.x, fmaf(x[1][0], w0.x, z.z)));
  z.w = fmaf(x[1][2], w2.y, fmaf(x[1][1], w1.y, fmaf(x[1][0], w0.y, z.w)));
  return z;
}

// quad-reduced dot of the thread's two rows with w at its columns, accumulated
__device__ __forceinline__ void dot_acc(float (&s)[2], float4 h, float2 w) {
  s[0] = fmaf(h.y, w.y, fmaf(h.x, w.x, s[0]));
  s[1] = fmaf(h.w, w.y, fmaf(h.z, w.x, s[1]));
}

__device__ __forceinline__ void quad_sum(float (&s)[2]) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    s[rh] += __shfl_xor_sync(0xffffffffu, s[rh], 1);
    s[rh] += __shfl_xor_sync(0xffffffffu, s[rh], 2);
  }
}

// the layer's accumulator -> the thread's z tile
__device__ __forceinline__ void store_acc(const float (&acc)[W / 2], float4* zs, int tid) {
#pragma unroll
  for (int kk = 0; kk < KBLK; ++kk)
    zs[kk * 128 + tid] = make_float4(acc[4 * kk], acc[4 * kk + 1], acc[4 * kk + 2], acc[4 * kk + 3]);
}

// Releases ring stage s to the producer (one arrival per consumer warp).
__device__ __forceinline__ void release(const Ring& ring, uint32_t s, int lane) {
  if (lane == 0) mbar_arrive(ring.empty + 8 * (s % NSTAGE));
}

// Waits for ring stage s, then makes this thread's A fragment registers
// visible to wgmma. Returns the stage buffer's address.
__device__ __forceinline__ uint32_t stage_ready(const Ring& ring, uint32_t s) {
  mbar_wait(ring.full + 8 * (s % NSTAGE), (s / NSTAGE) & 1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  return ring.smem + (s % NSTAGE) * STAGE_BYTES;
}

// Commits stage s's wgmmas and waits for stage s-1's (one stage of A
// fragments stays in flight while the next is built), then releases s-1.
__device__ __forceinline__ void stage_done(const Ring& ring, uint32_t s, bool first, int lane) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  if (!first) {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    release(ring, s - 1, lane);
  }
}

__device__ __forceinline__ void drain(float (&acc)[W / 2], const Ring& ring, uint32_t s, int lane) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  release(ring, s, lane);
}

// One 256 -> 256 layer on the thread's z tile, in two passes over the ring.
// The tensor cores accumulate in f32 but not with round-to-nearest: each
// accumulation step loses low bits relative to the accumulator's magnitude
// (measured on the H100: the three products interleaved per k8 block read a
// max error of ~1.0e-4 against the plain version at B=4 x 98,304 points,
// this order 3.8e-5). So the 64 small products (A_lo.B_hi, A_hi.B_lo) go
// first, while the accumulator is ~2^-11 of its final size, and the 32 big
// ones (A_hi.B_hi) after them: the full-size accumulator sees 32 steps, not 96.
//   pass 1, SMALL_STAGES stages of [16 hi | 16 lo] inputs: the A fragments of
//     two k8 blocks per stage (the previous layer's FiLM activation applied
//     when ACT, and the activated value written back for pass 2), 2 x 2 wgmma;
//     the sines of one stage run while the tensor cores work on the stage
//     before;
//   pass 2, BIG_STAGES stages of [32 hi] inputs: 4 k8 blocks, 4 wgmma.
// Each stage is released once its wgmmas have completed; the producer
// refills it while the next stage's products run. A stage's z and FiLM
// vectors load before the stage before it has completed. The loops are
// unrolled by two so that the two stages' A fragments in flight have
// registers of their own.
template <bool ACT>
__device__ __forceinline__ void mma_layer(float (&acc)[W / 2], float4* zs, Ring& ring, int tid, int q, int lane,
                                          const float* bias, const float* gam, const float* bet) {
  float4 z[2];
  float2 fb[2], fg[2], fe[2];
  auto fetch = [&](int st) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = 2 * st + j, c = 8 * kk + 2 * q;
      z[j] = zs[kk * 128 + tid];
      if (ACT) {
        fb[j] = ld_f2(bias + c);
        fg[j] = ld_f2(gam + c);
        fe[j] = ld_f2(bet + c);
      }
    }
  };
  fetch(0);
#pragma unroll 2
  for (int st = 0; st < SMALL_STAGES; ++st) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (ACT) {
        z[j] = film4(z[j], fb[j], fg[j], fe[j]);
        zs[(2 * st + j) * 128 + tid] = z[j];
      }
      split4(z[j], hi[j], lo[j]);
    }
    if (st + 1 < SMALL_STAGES) fetch(st + 1);
    const uint32_t s = ring.s + st, b = stage_ready(ring, s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wgmma_tf32(acc, lo[j], sw128_desc(b + 32 * j), (st | j) != 0);  // A_lo . B_hi
      wgmma_tf32(acc, hi[j], sw128_desc(b + 64 + 32 * j), 1);         // A_hi . B_lo
    }
    stage_done(ring, s, st == 0, lane);
  }
  ring.s += SMALL_STAGES;
  drain(acc, ring, ring.s - 1, lane);
#pragma unroll 2
  for (int st = 0; st < BIG_STAGES; ++st) {
    uint32_t hi[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) hi4(zs[(4 * st + k) * 128 + tid], hi[k]);
    const uint32_t s = ring.s + st, b = stage_ready(ring, s);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_tf32(acc, hi[k], sw128_desc(b + 32 * k), 1);  // A_hi . B_hi
    stage_done(ring, s, st == 0, lane);
  }
  ring.s += BIG_STAGES;
  drain(acc, ring, ring.s - 1, lane);
}

template <bool TEX>
__global__ void __launch_bounds__(THREADS, 1) siren_field_tf32_kernel(const F32Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float4* ztiles = reinterpret_cast<float4*>(base + NSTAGE * STAGE_BYTES);
  Ring ring{smem_u32(base), smem_u32(ztiles + CONSUMERS * ZTILE_FLOAT4), 0, 0};
  ring.empty = ring.full + 8 * NSTAGE;  // NSTAGE full mbarriers, then NSTAGE empty ones
  const int wg = threadIdx.x >> 7;
  const int per_tile = TEX ? LAYER_STAGES : a.D * LAYER_STAGES;  // ring stages per tile

  ring_init(ring, NSTAGE, CONSUMERS * 4);  // one arrival per consumer warp
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the weight ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128)
      produce<NSTAGE, STAGE_BYTES>(ring, a.wring, a.wvring, per_tile, LAYER_STAGES, a.n_tiles);
  } else {
    // ---- consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x & 127, lane = tid & 31, q = lane & 3;
    const int r0 = 16 * (tid >> 5) + (lane >> 2);
    float4* zs = ztiles + wg * ZTILE_FLOAT4;
    const int film_v = a.film_rows - 1;
    float acc[W / 2];

    for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
      const int b = t / a.tiles_per_item;
      const int p0 = (t - b * a.tiles_per_item) * TILE + wg * ROWS;
      const int nvalid = min(ROWS, a.N - p0);  // <= 0: this warpgroup's rows are past N
      const size_t row_base = (size_t)b * a.N + p0;
      const float* gam = a.gamma + (size_t)b * a.film_rows * W;
      const float* bet = a.beta + (size_t)b * a.film_rows * W;
      const bool v0 = r0 < nvalid, v1 = r0 + 8 < nvalid;
      float x[2][3];
      float sdf[2] = {0.f, 0.f};

      if (!TEX) {
        // layer 0 reads xyz (K = 3); layers 1 .. D-1 on the tensor cores, each
        // applying the previous layer's activation to its A; the last layer's
        // activation is the operand pass's.
        load_rows3(x, a.pts, row_base, r0, nvalid);
#pragma unroll 4
        for (int kk = 0; kk < KBLK; ++kk)
          zs[kk * 128 + tid] = k3_fma(make_float4(0.f, 0.f, 0.f, 0.f), x, a.w0t, 8 * kk + 2 * q);
        for (int l = 1; l < a.D; ++l) {
          mma_layer<true>(acc, zs, ring, tid, q, lane, a.bst + (l - 1) * W, gam + (l - 1) * W, bet + (l - 1) * W);
          store_acc(acc, zs, tid);
        }
      }

      // the view layer's operand: the backbone's last activation (sdf head,
      // raw_h out) or the cached raw_h, then the SFT, into the tile
      {
        const int l = a.D - 1;
#pragma unroll 4
        for (int kk = 0; kk < KBLK; ++kk) {
          const int c = 8 * kk + 2 * q;
          const size_t g0 = (row_base + r0) * W + c, g1 = g0 + 8 * W;
          float4 h;
          if (TEX) {
            const float2 h0 = v0 ? ld_f2(a.raw_h_in + g0) : make_float2(0.f, 0.f);
            const float2 h1 = v1 ? ld_f2(a.raw_h_in + g1) : make_float2(0.f, 0.f);
            h = make_float4(h0.x, h0.y, h1.x, h1.y);
          } else {
            h = film4(zs[kk * 128 + tid], ld_f2(a.bst + l * W + c), ld_f2(gam + l * W + c), ld_f2(bet + l * W + c));
            dot_acc(sdf, h, ld_f2(a.wsig + c));
            if (a.raw_h_out) {
              if (v0) st_f2(a.raw_h_out + g0, h.x, h.y);
              if (v1) st_f2(a.raw_h_out + g1, h.z, h.w);
            }
          }
          if (a.alpha) {  // multiply, then add, each rounded (no FMA contraction)
            const float2 z2 = make_float2(0.f, 0.f);
            const float2 a0 = v0 ? ld_f2(a.alpha + g0) : z2, a1 = v1 ? ld_f2(a.alpha + g1) : z2;
            const float2 l0 = v0 ? ld_f2(a.lbeta + g0) : z2, l1 = v1 ? ld_f2(a.lbeta + g1) : z2;
            h = make_float4(__fadd_rn(__fmul_rn(a0.x + 1.f, h.x), l0.x), __fadd_rn(__fmul_rn(a0.y + 1.f, h.y), l0.y),
                            __fadd_rn(__fmul_rn(a1.x + 1.f, h.z), l1.x), __fadd_rn(__fmul_rn(a1.y + 1.f, h.w), l1.y));
          }
          zs[kk * 128 + tid] = h;
        }
      }

      // view layer: [h', dirs] (K = W + 3), then its activation, feat out and
      // the rgb head
      mma_layer<false>(acc, zs, ring, tid, q, lane, nullptr, nullptr, nullptr);
      store_acc(acc, zs, tid);
      load_rows3(x, a.dirs, row_base, r0, nvalid);
      float rgb[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int kk = 0; kk < KBLK; ++kk) {
        const int c = 8 * kk + 2 * q;
        const size_t g0 = (row_base + r0) * W + c, g1 = g0 + 8 * W;
        const float4 f = film4(k3_fma(zs[kk * 128 + tid], x, a.wvdt, c), ld_f2(a.bv + c), ld_f2(gam + film_v * W + c),
                               ld_f2(bet + film_v * W + c));
        if (v0) st_f2(a.feat + g0, f.x, f.y);
        if (v1) st_f2(a.feat + g1, f.z, f.w);
#pragma unroll
        for (int k = 0; k < 3; ++k) dot_acc(rgb[k], f, ld_f2(a.wrgb + k * W + c));
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) quad_sum(rgb[k]);
      if (!TEX) quad_sum(sdf);
      if (q == 0) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          if (!(rh ? v1 : v0)) continue;
          float* o = a.out + (row_base + r0 + 8 * rh) * a.out_cols;
#pragma unroll
          for (int k = 0; k < 3; ++k) o[k] = rgb[k][rh] + a.bheads[k];
          if (!TEX) o[3] = sdf[rh] + a.bheads[3];
        }
      }
    }
  }
}

template <bool TEX>
int launch(F32Args a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(siren_field_tf32_kernel<TEX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  a.tiles_per_item = (a.N + TILE - 1) / TILE;
  a.n_tiles = B * a.tiles_per_item;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  siren_field_tf32_kernel<TEX><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int siren_field_full(const float* pts, const float* dirs, const float* w0t, const float* wring, const float* bst,
                     const float* wvring, const float* wvdt, const float* bv, const float* wsig, const float* wrgb,
                     const float* bheads, const float* gamma, const float* beta, const float* alpha,
                     const float* lbeta, float* feat, float* rgb_sdf, float* raw_h, int B, int N, int D,
                     void* stream) {
  F32Args a{};
  a.pts = pts; a.dirs = dirs; a.w0t = w0t; a.wring = wring; a.bst = bst;
  a.wvring = wvring; a.wvdt = wvdt; a.bv = bv; a.wsig = wsig; a.wrgb = wrgb; a.bheads = bheads;
  a.gamma = gamma; a.beta = beta; a.alpha = alpha; a.lbeta = lbeta;
  a.feat = feat; a.out = rgb_sdf; a.raw_h_out = raw_h;
  a.N = N; a.D = D; a.film_rows = D + 1; a.out_cols = 4;
  return launch<false>(a, B, static_cast<cudaStream_t>(stream));
}

int siren_field_tex(const float* raw_h, const float* dirs, const float* wvring, const float* wvdt, const float* bv,
                    const float* wrgb, const float* bheads, const float* gamma_v, const float* beta_v,
                    const float* alpha, const float* lbeta, float* feat, float* rgb, int B, int N, void* stream) {
  F32Args a{};
  a.raw_h_in = raw_h; a.dirs = dirs; a.wvring = wvring; a.wvdt = wvdt; a.bv = bv; a.wrgb = wrgb;
  a.bheads = bheads; a.gamma = gamma_v; a.beta = beta_v; a.alpha = alpha; a.lbeta = lbeta;
  a.feat = feat; a.out = rgb;
  a.N = N; a.D = 1; a.film_rows = 1; a.out_cols = 3;
  return launch<true>(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
