// FiLM-SIREN field, `serving` precision, on Hopper tensor cores (sm_90a):
// wgmma on bf16 operands fed by a bulk-copy (TMA engine) ring of weight stages.
// The port of e3dge_tpu/ops/pallas/siren_kernel.py::_siren_kernel (launched by
// siren_query_fused) for the precision the serving path runs; the `highest`
// (f32) precision is siren_field.cu (3xTF32 on the same pipeline). Wrapper,
// host weight pack, plain version and launch counts:
// e3dge_torch/ops/siren_field.py; the ring and PTX helpers: sm90_ring.cuh.
//
// Arithmetic (that of the plain version, ops/siren_field.py, in `serving`):
// matmul operands bf16, f32 accumulation; act(x) = bf16(fast_sin(g*(x+b)+e));
// layer 0 (K=3) and the view layer's dirs part (K=3) on FMA; sdf from the
// unmodulated backbone h; the SFT (alpha+1)*h + lbeta, multiply then add, each
// rounded, the result rounded to bf16 as the view layer's operand.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
// f32, 3.35 TB/s):
//   siren_field_full  ~104 GFLOP of 256x256 products per image (N = 98,304):
//                     0.105 ms on the tensor cores; its epilogue, ~226 M
//                     FiLM sines at ~14 f32-pipe instructions each, is a
//                     floor of ~0.1 ms on the f32 pipe. Bound by operations.
//   siren_field_tex   ~13 GFLOP but ~204 MB of bf16 raw_h, alpha, lbeta in
//                     and feat out: 0.061 ms at 3.35 TB/s. Bound by bytes.
//
// Design:
//   * A CTA is 2 consumer warpgroups + 1 producer warpgroup (setmaxnreg: 232 /
//     40 registers). Each consumer warpgroup owns 64 points of a 128-point
//     tile through all D+1 layers; its layers chain on a warpgroup-local named
//     barrier, never __syncthreads. The grid is persistent (one CTA per SM)
//     and walks (item, tile) pairs, so a tile never straddles two items'
//     FiLM rows.
//   * Each 256->256 layer is 2 x 16 wgmma.m64n128k16 (bf16 x bf16 -> f32), one
//     output half after the other: A is the warpgroup's bf16 activation tile
//     [64][256] in shared memory, B the layer's weight, both K-major in the
//     128-byte swizzle. A half's accumulator (64 f32 per thread) stays in
//     registers; its epilogue packs it to bf16 pairs (32) before the other
//     half runs, which keeps the consumer under its 232 registers unspilled.
//   * Weights are packed on the host (ops/siren_field.py::sw128_stages) into
//     stages of 256 out x 64 in (32 KB), pre-swizzled, so one cp.async.bulk
//     per stage fills the ring (4 stages, 128 KB) with no tensor map. Full and
//     empty mbarriers per stage; the producer runs up to a layer ahead.
//   * The epilogue runs on the accumulator registers; the packed layer output
//     becomes the next layer's A tile (conflict-free in the swizzle). raw_h, the
//     SFT operand and feat move between global and shared memory in 16-byte
//     coalesced chunks; the heads are quad-shuffle dot products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ring.cuh"

namespace {

using namespace sm90;

constexpr int W = 256;                          // hidden width
constexpr int ROWS = 64;                        // points per consumer warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups per CTA
// registers per thread after setmaxnreg: 65,536 per SM shared by the roles
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "register file");
constexpr int TILE = ROWS * CONSUMERS;          // points per CTA tile
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int KB = 64;                          // K of one stage: one 128-byte swizzle row
constexpr int KBLOCKS = W / KB;                 // stages per layer
constexpr int NSTAGE = 4;                       // ring depth
constexpr uint32_t STAGE_BYTES = W * KB * 2;    // 32 KB
constexpr int ABLOCK_BYTES = ROWS * KB * 2;     // 8 KB: one K block of an A tile
constexpr int ATILE_BYTES = ROWS * W * 2;       // 32 KB
constexpr int HALF = W / 2;                     // output columns of one wgmma (n128)
constexpr int SMEM_BYTES = 1024 + NSTAGE * STAGE_BYTES + CONSUMERS * ATILE_BYTES + 2 * NSTAGE * 8;

struct TcArgs {
  const float* pts;                  // [B, N, 3]  (full only)
  const float* dirs;                 // [B, N, 3]
  const __nv_bfloat16* w0t;          // [3, W]
  const __nv_bfloat16* wring;        // [D-1, KBLOCKS, W, KB] swizzled stages of layers 1..D-1
  const __nv_bfloat16* wvring;       // [KBLOCKS, W, KB] swizzled stages of the view layer's h part
  const float* bst;                  // [D, W]
  const __nv_bfloat16* wvdt;         // [3, W]
  const float* bv;                   // [W]
  const __nv_bfloat16* wsig;         // [W]
  const __nv_bfloat16* wrgb;         // [3, W]
  const float* bheads;               // [4]
  const float* gamma;                // [B, film_rows, W]
  const float* beta;                 // [B, film_rows, W]
  const __nv_bfloat16* alpha;        // [B, N, W] or null
  const __nv_bfloat16* lbeta;        // [B, N, W] or null
  const __nv_bfloat16* raw_h_in;     // [B, N, W] (tex only)
  __nv_bfloat16* feat;               // [B, N, W]
  float* out;                        // [B, N, out_cols]
  __nv_bfloat16* raw_h_out;          // [B, N, W] or null (full only)
  int N, D, film_rows, out_cols, tiles_per_item, n_tiles;
};

// ------------------------------------------------------------------ wgmma

// acc (+)= A[64 x 16] * B[16 x 128], both from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[HALF / 2], uint64_t da, uint64_t db, int accumulate) {
#define WG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R16(i) WG_R4(i), WG_R4(i + 4), WG_R4(i + 8), WG_R4(i + 12)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_R16(0), WG_R16(16), WG_R16(32), WG_R16(48)
      : "l"(da), "l"(db), "r"(accumulate));
#undef WG_R16
#undef WG_R4
}

// keeps the compiler from moving accumulator reads/writes across the async wgmma
__device__ __forceinline__ void fence_acc(float (&d)[HALF / 2]) {
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ----------------------------------------------------------------- arithmetic

__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ float2 ld_f2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// ops/fast_math.py::fast_sin, the constants of siren_field.cu; rintf rounds
// half to even as torch.round does.
__device__ __forceinline__ float fast_sin(float x) {
  x = x - rintf(x * 0.15915494309189535f) * 6.283185307179586f;
  const float x2 = x * x;
  float p = -2.0362212395e-08f;
  p = p * x2 + 2.6997138342e-06f;
  p = p * x2 + -1.9808632629e-04f;
  p = p * x2 + 8.3324029612e-03f;
  p = p * x2 + -1.6666552631e-01f;
  p = p * x2 + 9.9999959991e-01f;
  return x * p;
}

// Register layouts, per thread of a consumer warpgroup (r0 = 16*warp + lane/4,
// q = lane % 4):
//   acc[4jj + e] (the m64n128 accumulator of output half hf): row r0 +
//     8*(e >> 1), column 128*hf + 8*jj + 2q + (e & 1), jj = 0 .. 15;
//   hp[2j + rh] (a layer's whole output, bf16 pairs): row r0 + 8*rh,
//     columns 8j + 2q and 8j + 2q + 1, j = 0 .. 31 (j = 16*hf + jj).
// A layer keeps one half's accumulator (64) beside the other's packed output
// (32) instead of a 256-wide accumulator (128).

// Loops over column groups load per-column vectors beside the accumulator; a
// __syncwarp every 8 groups keeps the scheduler from hoisting every group's
// loads at once (measured: the texture pass runs ~6% slower without it).
__device__ __forceinline__ void limit_hoist(int j) {
  if (j % 8 == 0 && j > 0) __syncwarp();
}

// hp[half hf] <- bf16(fast_sin(gamma * (acc + bias) + beta)) per column
__device__ __forceinline__ void film_epilogue(const float (&acc)[HALF / 2], uint32_t (&hp)[W / 4], int hf,
                                              const float* bias, const float* gam, const float* bet, int q) {
#pragma unroll
  for (int jj = 0; jj < HALF / 8; ++jj) {
    limit_hoist(jj);
    const int c = HALF * hf + 8 * jj + 2 * q;
    const float2 b = ld_f2(bias + c), g = ld_f2(gam + c), e = ld_f2(bet + c);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool hi = i & 1;
      v[i] = fast_sin((hi ? g.y : g.x) * (acc[4 * jj + i] + (hi ? b.y : b.x)) + (hi ? e.y : e.x));
    }
    hp[2 * (HALF / 8 * hf + jj)] = pack_bf2(v[0], v[1]);
    hp[2 * (HALF / 8 * hf + jj) + 1] = pack_bf2(v[2], v[3]);
  }
}

// acc[row][c..c+1] (+)= sum_k x[row][k] * w[k][c..c+1] over half hf's columns,
// K = 3 (w: [3, W] bf16)
__device__ __forceinline__ void k3_fma(float (&acc)[HALF / 2], const float (&x)[2][3], const __nv_bfloat16* w,
                                       int hf, int q, bool accumulate) {
#pragma unroll
  for (int jj = 0; jj < HALF / 8; ++jj) {
    limit_hoist(jj);
    const int c = HALF * hf + 8 * jj + 2 * q;
    const float2 w0 = ld_bf2(w + c), w1 = ld_bf2(w + W + c), w2 = ld_bf2(w + 2 * W + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool hi = i & 1;
      const float(&p)[3] = x[i >> 1];
      float& y = acc[4 * jj + i];
      const float first = accumulate ? fmaf(p[0], hi ? w0.y : w0.x, y) : p[0] * (hi ? w0.y : w0.x);
      y = fmaf(p[2], hi ? w2.y : w2.x, fmaf(p[1], hi ? w1.y : w1.x, first));
    }
  }
}

// bf16-rounded xyz of the thread's two rows (zero past the tile's valid rows)
__device__ __forceinline__ void load_rows3(float (&x)[2][3], const float* src, size_t row_base, int r0, int nvalid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      x[h][d] = r < nvalid ? __bfloat162float(__float2bfloat16(__ldg(src + (row_base + r) * 3 + d))) : 0.f;
  }
}

// byte offset in an A tile (K-major, 128-byte swizzle) of 16-byte chunk c
// (channels 8c .. 8c+7) of row r
__device__ __forceinline__ int a_chunk(int r, int c) {
  return (c >> 3) * ABLOCK_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// a layer's packed output -> the A tile; conflict-free: the 8 rows of a
// quarter warp land in 8 distinct 16-byte chunks
__device__ __forceinline__ void store_a(uint8_t* atile, const uint32_t (&hp)[W / 4], int r0, int q) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = r0 + 8 * rh;
      *reinterpret_cast<uint32_t*>(atile + a_chunk(r, j) + 4 * q) = hp[2 * j + rh];
    }
}

// sum over the row's 256 channels of h * w (w: [W] bf16), quad-reduced
__device__ __forceinline__ float2 head_dot(const uint32_t (&hp)[W / 4], const __nv_bfloat16* w, int q) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    limit_hoist(j);
    const float2 wj = ld_bf2(w + 8 * j + 2 * q);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float2 h = unpack_bf2(hp[2 * j + rh]);
      s[rh] = fmaf(h.y, wj.y, fmaf(h.x, wj.x, s[rh]));
    }
  }
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    s[rh] += __shfl_xor_sync(0xffffffffu, s[rh], 1);
    s[rh] += __shfl_xor_sync(0xffffffffu, s[rh], 2);
  }
  return make_float2(s[0], s[1]);
}

// (alpha + 1) * h + lbeta on 8 bf16 channels, multiply then add, each rounded
__device__ __forceinline__ uint4 sft8(uint4 h, uint4 al, uint4 lb) {
  uint4 out;
  const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&h);
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&al);
  const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&lb);
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 hf = __bfloat1622float2(hp[i]), af = __bfloat1622float2(ap[i]), bf = __bfloat1622float2(bp[i]);
    op[i] = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(af.x + 1.f, hf.x), bf.x),
                                  __fadd_rn(__fmul_rn(af.y + 1.f, hf.y), bf.y));
  }
  return out;
}

// One 256 -> 256 layer on the A tile: per output half, 16 wgmma over the
// layer's KBLOCKS ring stages, then (view layer) the dirs part on FMA, then the
// FiLM epilogue into hp. The second half releases each stage once the wgmmas
// that read it have completed; the producer then refills it with the next
// layer's stage while this layer's epilogue runs.
template <bool VIEW>
__device__ __forceinline__ void mma_layer(uint32_t (&hp)[W / 4], uint32_t a_addr, Ring& ring, int lane, int q,
                                          const float* bias, const float* gam, const float* bet,
                                          const float (&dirs)[2][3], const __nv_bfloat16* wvdt) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float acc[HALF / 2];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kb = 0; kb < KBLOCKS; ++kb) {
      const uint32_t s = ring.s + kb, stage = s % NSTAGE;
      mbar_wait(ring.full + 8 * stage, (s / NSTAGE) & 1);
#pragma unroll
      for (int k = 0; k < KB / 16; ++k)
        wgmma_m64n128k16(acc, sw128_desc(a_addr + kb * ABLOCK_BYTES + k * 32),
                         sw128_desc(ring.smem + stage * STAGE_BYTES + hf * (STAGE_BYTES / 2) + k * 32),
                         (kb | k) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (hf == 1 && kb > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) mbar_arrive(ring.empty + 8 * ((s - 1) % NSTAGE));
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (hf == 1 && lane == 0) mbar_arrive(ring.empty + 8 * ((ring.s + KBLOCKS - 1) % NSTAGE));
    if (VIEW) k3_fma(acc, dirs, wvdt, hf, q, true);
    film_epilogue(acc, hp, hf, bias, gam, bet, q);
  }
  ring.s += KBLOCKS;
}

template <bool TEX>
__global__ void __launch_bounds__(THREADS, 1) siren_field_tc_kernel(const TcArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* atiles = base + NSTAGE * STAGE_BYTES;
  Ring ring{smem_u32(base), smem_u32(atiles + CONSUMERS * ATILE_BYTES), 0, 0};
  ring.empty = ring.full + 8 * NSTAGE;  // NSTAGE full mbarriers, then NSTAGE empty ones
  const int wg = threadIdx.x >> 7;
  const int per_tile = TEX ? KBLOCKS : a.D * KBLOCKS;  // ring stages per tile

  ring_init(ring, NSTAGE, CONSUMERS * 4);  // one arrival per consumer warp
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the weight ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) produce<NSTAGE, STAGE_BYTES>(ring, a.wring, a.wvring, per_tile, KBLOCKS, a.n_tiles);
  } else {
    // ---- consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x & 127, lane = tid & 31, q = lane & 3;
    const int r0 = 16 * (tid >> 5) + (lane >> 2);
    const int bar = 1 + wg;
    uint8_t* atile = atiles + wg * ATILE_BYTES;
    const uint32_t a_addr = smem_u32(atile);
    const int film_v = a.film_rows - 1;
    uint32_t hp[W / 4];  // the current layer's output, bf16 pairs

    for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
      const int b = t / a.tiles_per_item;
      const int p0 = (t - b * a.tiles_per_item) * TILE + wg * ROWS;
      const int nvalid = min(ROWS, a.N - p0);  // <= 0: this warpgroup's rows are past N
      const size_t row_base = (size_t)b * a.N + p0;
      const float* gam = a.gamma + (size_t)b * a.film_rows * W;
      const float* bet = a.beta + (size_t)b * a.film_rows * W;
      float x[2][3];

      if (!TEX) {
        load_rows3(x, a.pts, row_base, r0, nvalid);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // layer 0 reads xyz (K = 3)
          float acc[HALF / 2];
          k3_fma(acc, x, a.w0t, hf, q, false);
          film_epilogue(acc, hp, hf, a.bst, gam, bet, q);
        }
        for (int l = 1; l < a.D; ++l) {
          store_a(atile, hp, r0, q);
          fence_async_smem();
          wg_bar(bar);
          mma_layer<false>(hp, a_addr, ring, lane, q, a.bst + l * W, gam + l * W, bet + l * W, x, nullptr);
          wg_bar(bar);  // every warp's wgmmas have read the A tile
        }
        // sdf from the unmodulated backbone
        const float2 sdf = head_dot(hp, a.wsig, q);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = r0 + 8 * rh;
          if (q == 0 && r < nvalid) a.out[(row_base + r) * a.out_cols + 3] = (rh ? sdf.y : sdf.x) + a.bheads[3];
        }
        store_a(atile, hp, r0, q);
      }

      // the view layer's operand: raw_h out, the SFT, or the cached raw_h in
      if (TEX || a.alpha || a.raw_h_out) {
        if (!TEX) wg_bar(bar);
        for (int i = tid; i < ROWS * (W / 8); i += 128) {
          const int r = i >> 5, c = i & 31;
          uint4* sp = reinterpret_cast<uint4*>(atile + a_chunk(r, c));
          const bool valid = r < nvalid;
          const size_t g = (row_base + r) * W + c * 8;
          uint4 h = make_uint4(0, 0, 0, 0);
          if (TEX) {
            if (valid) h = __ldg(reinterpret_cast<const uint4*>(a.raw_h_in + g));
          } else {
            h = *sp;
            if (a.raw_h_out && valid) *reinterpret_cast<uint4*>(a.raw_h_out + g) = h;
          }
          if (a.alpha) {
            uint4 al = make_uint4(0, 0, 0, 0), lb = make_uint4(0, 0, 0, 0);
            if (valid) {
              al = __ldg(reinterpret_cast<const uint4*>(a.alpha + g));
              lb = __ldg(reinterpret_cast<const uint4*>(a.lbeta + g));
            }
            h = sft8(h, al, lb);
          }
          if (TEX || a.alpha) *sp = h;
        }
      }
      fence_async_smem();
      wg_bar(bar);

      // view layer: [h', dirs] (K = W + 3)
      load_rows3(x, a.dirs, row_base, r0, nvalid);
      mma_layer<true>(hp, a_addr, ring, lane, q, a.bv, gam + film_v * W, bet + film_v * W, x, a.wvdt);
      wg_bar(bar);  // every warp's wgmmas have read the A tile
      store_a(atile, hp, r0, q);

      // rgb head on feat
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float2 v = head_dot(hp, a.wrgb + k * W, q);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = r0 + 8 * rh;
          if (q == 0 && r < nvalid) a.out[(row_base + r) * a.out_cols + k] = (rh ? v.y : v.x) + a.bheads[k];
        }
      }

      // feat out, 16-byte chunks of whole rows
      wg_bar(bar);
      for (int i = tid; i < ROWS * (W / 8); i += 128) {
        const int r = i >> 5, c = i & 31;
        if (r < nvalid)
          *reinterpret_cast<uint4*>(a.feat + (row_base + r) * W + c * 8) =
              *reinterpret_cast<const uint4*>(atile + a_chunk(r, c));
      }
      wg_bar(bar);  // the A tile is free for the next tile
    }
  }
}

template <bool TEX>
int launch(TcArgs a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(siren_field_tc_kernel<TEX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  a.tiles_per_item = (a.N + TILE - 1) / TILE;
  a.n_tiles = B * a.tiles_per_item;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  siren_field_tc_kernel<TEX><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int siren_field_full_sm90(const float* pts, const float* dirs, const void* w0t, const void* wring,
                          const float* bst, const void* wvring, const void* wvdt, const float* bv,
                          const void* wsig, const void* wrgb, const float* bheads, const float* gamma,
                          const float* beta, const void* alpha, const void* lbeta, void* feat, float* rgb_sdf,
                          void* raw_h, int B, int N, int D, void* stream) {
  using bf = __nv_bfloat16;
  TcArgs a{};
  a.pts = pts; a.dirs = dirs; a.w0t = static_cast<const bf*>(w0t);
  a.wring = static_cast<const bf*>(wring); a.wvring = static_cast<const bf*>(wvring);
  a.bst = bst; a.wvdt = static_cast<const bf*>(wvdt); a.bv = bv;
  a.wsig = static_cast<const bf*>(wsig); a.wrgb = static_cast<const bf*>(wrgb); a.bheads = bheads;
  a.gamma = gamma; a.beta = beta;
  a.alpha = static_cast<const bf*>(alpha); a.lbeta = static_cast<const bf*>(lbeta);
  a.feat = static_cast<bf*>(feat); a.out = rgb_sdf; a.raw_h_out = static_cast<bf*>(raw_h);
  a.N = N; a.D = D; a.film_rows = D + 1; a.out_cols = 4;
  return launch<false>(a, B, static_cast<cudaStream_t>(stream));
}

int siren_field_tex_sm90(const void* raw_h, const float* dirs, const void* wvring, const void* wvdt,
                         const float* bv, const void* wrgb, const float* bheads, const float* gamma_v,
                         const float* beta_v, const void* alpha, const void* lbeta, void* feat, float* rgb,
                         int B, int N, void* stream) {
  using bf = __nv_bfloat16;
  TcArgs a{};
  a.raw_h_in = static_cast<const bf*>(raw_h); a.dirs = dirs;
  a.wvring = static_cast<const bf*>(wvring); a.wvdt = static_cast<const bf*>(wvdt); a.bv = bv;
  a.wrgb = static_cast<const bf*>(wrgb); a.bheads = bheads; a.gamma = gamma_v; a.beta = beta_v;
  a.alpha = static_cast<const bf*>(alpha); a.lbeta = static_cast<const bf*>(lbeta);
  a.feat = static_cast<bf*>(feat); a.out = rgb;
  a.N = N; a.D = 0; a.film_rows = 1; a.out_cols = 3;
  return launch<true>(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
