// FiLM-SIREN field kernel, `highest` (f32) precision, for Hopper (sm_90a) — a
// port of the one TPU kernel of the JAX package,
// e3dge_tpu/ops/pallas/siren_kernel.py::_siren_kernel (launched by
// siren_query_fused). The `serving` (bf16) precision, which the serving path
// runs, is the tensor-core kernel of siren_field_sm90.cu. Wrapper, plain
// version and launch counts: e3dge_torch/ops/siren_field.py.
//
// What it computes, per point of the G0 render (N = 64*64*24 = 98,304 per image):
//   h_0   = sin(g_0 * (xyz W_0^T + b_0) + be_0)
//   h_i   = sin(g_i * (h_{i-1} W_i^T + b_i) + be_i)          i = 1 .. D-1
//   sdf   = h W_sigma^T + b_sigma                  (reads the UNMODULATED h)
//   h'    = (alpha + 1) * h + lbeta                (optional local SFT)
//   feat  = sin(g_v * (h' W_vh^T + dirs W_vd^T + b_v) + be_v)
//   rgb   = feat W_rgb^T + b_rgb
// with FiLM vectors g/be computed per style row outside the kernel
// ([B, D+1, W]; one launch covers the whole batch, where the JAX package loops
// over items). Two entry points:
//   siren_field_full : the whole field; optionally writes the backbone hidden
//                      raw_h [B, N, W] (the same-view re-render cache);
//   siren_field_tex  : the kernel's tail (SFT, view layer, rgb) on a cached
//                      raw_h — the texture-only second pass of image2image.
// f32 operands, f32 FMA, sinf; io tensors f32. TF32 tensor cores would change
// its numbers, and it is the f32 check mode, off the serving path.
//
// Bound on an H100 SXM (~67 TFLOP/s f32 outside the tensor cores): the full
// pass does 2*N*W*(3 + (D-1)*W + W + 3 + 4) ~ 104 GFLOP per image, ~1.6 ms in
// f32 FMA: bound by operations.
//
// Design: one block owns a tile of T = 64 points and keeps its activations on
// chip for all D+1 layers (shared memory, [W][T] f32 = 68 KB with padding,
// above the 48 KB default, hence the dynamic-shared-memory attribute): device
// memory sees one read of the inputs and one write of the outputs, as in the
// TPU kernel. Weights stream from L2 (each block reads each layer once,
// coalesced). Each thread accumulates a 16-point x 4-channel register tile
// with scalar FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 256;         // hidden width the kernel is built for
constexpr int T = 64;          // points per block
constexpr int THREADS = 256;
constexpr int PT = 16;         // points per thread
constexpr int CT = 4;          // channels per thread, strided by 64
constexpr int LDH = T + 4;     // row stride (floats) of the [W][T] activation tile
constexpr int SMEM_FLOATS = W * LDH + 2 * T * 4 + T;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

static_assert(THREADS == (W / CT) * (T / PT), "thread tile must cover the block tile");

struct FieldArgs {
  const float* pts;            // [B, N, 3]  (full only)
  const float* dirs;           // [B, N, 3]
  const float* w0t;            // [3, W]      first layer, transposed
  const float* wst;            // [D-1, W, W] layers 1..D-1, transposed (in, out)
  const float* bst;            // [D, W]
  const float* wvht;           // [W, W]      view layer, h part, transposed
  const float* wvdt;           // [3, W]      view layer, dirs part, transposed
  const float* bv;             // [W]
  const float* wsig;           // [W]
  const float* wrgb;           // [3, W]
  const float* bheads;         // [4]  rgb bias (3), sigma bias
  const float* gamma;          // [B, film_rows, W]
  const float* beta;           // [B, film_rows, W]
  const float* alpha;          // [B, N, W] or null (no SFT)
  const float* lbeta;          // [B, N, W] or null
  const float* raw_h_in;       // [B, N, W]  (tex only)
  float* feat;                 // [B, N, W]
  float* out;                  // [B, N, out_cols]  rgb (+ sdf)
  float* raw_h_out;            // [B, N, W] or null (full only)
  int N, D, film_rows, out_cols;
};

// acc[i][m] <- sum_k hs[k][16g+i] * wt[k][c + 64m]  (wt is [W, W] input-major)
__device__ __forceinline__ void tile_matmul(const float* __restrict__ hs,
                                            const float* __restrict__ wt,
                                            float (&acc)[PT][CT], int c, int g) {
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int m = 0; m < CT; ++m) acc[i][m] = 0.f;
#pragma unroll 2
  for (int k = 0; k < W; ++k) {
    float w[CT];
#pragma unroll
    for (int m = 0; m < CT; ++m) w[m] = wt[(size_t)k * W + c + 64 * m];
    const float4* hrow = reinterpret_cast<const float4*>(hs + k * LDH + g * PT);
    float hv[PT];
#pragma unroll
    for (int q = 0; q < PT / 4; ++q) {
      const float4 v = hrow[q];
      hv[4 * q] = v.x; hv[4 * q + 1] = v.y; hv[4 * q + 2] = v.z; hv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int m = 0; m < CT; ++m) acc[i][m] = fmaf(hv[i], w[m], acc[i][m]);
  }
}

// hs[c + 64m][16g + i] <- acc[i][m]; rows padded to LDH so the float4 stores of
// a quarter warp land in distinct banks.
__device__ __forceinline__ void store_tile(float* hs, const float (&acc)[PT][CT], int c, int g) {
#pragma unroll
  for (int m = 0; m < CT; ++m) {
    float4* row = reinterpret_cast<float4*>(hs + (c + 64 * m) * LDH + g * PT);
#pragma unroll
    for (int q = 0; q < PT / 4; ++q)
      row[q] = make_float4(acc[4 * q][m], acc[4 * q + 1][m], acc[4 * q + 2][m], acc[4 * q + 3][m]);
  }
}

// acc <- sin(gamma * (acc + bias) + beta)
__device__ __forceinline__ void film_epilogue(float (&acc)[PT][CT], const float* bias,
                                              const float* gam, const float* bet, int c) {
#pragma unroll
  for (int m = 0; m < CT; ++m) {
    const int j = c + 64 * m;
    const float bj = bias[j], gj = gam[j], ej = bet[j];
#pragma unroll
    for (int i = 0; i < PT; ++i) acc[i][m] = sinf(gj * (acc[i][m] + bj) + ej);
  }
}

template <bool TEX>
__global__ void __launch_bounds__(THREADS, 2) siren_field_kernel(FieldArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;              // [W][LDH] activation tile, k-major
  float* ps = hs + W * LDH;      // [T][4] points
  float* ds = ps + T * 4;        // [T][4] view dirs
  float* sdf_s = ds + T * 4;     // [T]

  const int tid = threadIdx.x;
  const int c = tid & 63;        // channel lane: channels c, c+64, c+128, c+192
  const int g = tid >> 6;        // point group: points 16g .. 16g+15 (uniform per warp)
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * T;
  const int nvalid = min(T, a.N - p0);
  const size_t row0 = (size_t)b * a.N + p0;
  const float* gam = a.gamma + (size_t)b * a.film_rows * W;
  const float* bet = a.beta + (size_t)b * a.film_rows * W;
  const int film_v = a.film_rows - 1;  // the view layer's FiLM row

  if (tid < T * 3) {
    const int p = tid / 3, d = tid % 3;
    float pv = 0.f, dv = 0.f;
    if (p < nvalid) {
      if (!TEX) pv = a.pts[(row0 + p) * 3 + d];
      dv = a.dirs[(row0 + p) * 3 + d];
    }
    ps[p * 4 + d] = pv;
    ds[p * 4 + d] = dv;
  }
  __syncthreads();

  float acc[PT][CT];
  if (!TEX) {
    // layer 0 reads xyz (K = 3)
    const float* w0t = a.w0t;
#pragma unroll
    for (int m = 0; m < CT; ++m) {
      const int j = c + 64 * m;
      const float w0 = w0t[j], w1 = w0t[W + j], w2 = w0t[2 * W + j];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const float* p = ps + (g * PT + i) * 4;
        acc[i][m] = fmaf(p[2], w2, fmaf(p[1], w1, p[0] * w0));
      }
    }
    film_epilogue(acc, a.bst, gam, bet, c);
    const float* wst = a.wst;
    for (int l = 1; l < a.D; ++l) {
      store_tile(hs, acc, c, g);
      __syncthreads();
      tile_matmul(hs, wst + (size_t)(l - 1) * W * W, acc, c, g);
      __syncthreads();
      film_epilogue(acc, a.bst + l * W, gam + l * W, bet + l * W, c);
    }
    if (a.raw_h_out) {
      float* rh = a.raw_h_out;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int p = g * PT + i;
        if (p < nvalid)
#pragma unroll
          for (int m = 0; m < CT; ++m) rh[(row0 + p) * W + c + 64 * m] = acc[i][m];
      }
    }
    // sdf from the unmodulated backbone: 4 lanes per point, shuffle-reduced
    store_tile(hs, acc, c, g);
    __syncthreads();
    {
      const float* wsig = a.wsig;
      const int p = tid >> 2, q = tid & 3;
      float s = 0.f;
      for (int k = q * (W / 4); k < (q + 1) * (W / 4); ++k) s = fmaf(hs[k * LDH + p], wsig[k], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) sdf_s[p] = s + a.bheads[3];
    }
    __syncthreads();
  } else {
    const float* rh = a.raw_h_in;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = g * PT + i;
#pragma unroll
      for (int m = 0; m < CT; ++m)
        acc[i][m] = p < nvalid ? rh[(row0 + p) * W + c + 64 * m] : 0.f;
    }
  }

  if (a.alpha) {  // local SFT of the texture branch
    const float* al = a.alpha;
    const float* lb = a.lbeta;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = g * PT + i;
      if (p < nvalid)
#pragma unroll
        for (int m = 0; m < CT; ++m) {
          const size_t o = (row0 + p) * W + c + 64 * m;
          // multiply, then add, each rounded (no FMA contraction)
          acc[i][m] = __fadd_rn(__fmul_rn(al[o] + 1.f, acc[i][m]), lb[o]);
        }
    }
  }

  // view layer: [h', dirs] (K = W + 3)
  store_tile(hs, acc, c, g);
  __syncthreads();
  tile_matmul(hs, a.wvht, acc, c, g);
  {
    const float* wvdt = a.wvdt;
#pragma unroll
    for (int m = 0; m < CT; ++m) {
      const int j = c + 64 * m;
      const float w0 = wvdt[j], w1 = wvdt[W + j], w2 = wvdt[2 * W + j];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const float* d = ds + (g * PT + i) * 4;
        acc[i][m] = fmaf(d[2], w2, fmaf(d[1], w1, fmaf(d[0], w0, acc[i][m])));
      }
    }
  }
  film_epilogue(acc, a.bv, gam + film_v * W, bet + film_v * W, c);
  {
    float* ft = a.feat;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = g * PT + i;
      if (p < nvalid)
#pragma unroll
        for (int m = 0; m < CT; ++m) ft[(row0 + p) * W + c + 64 * m] = acc[i][m];
    }
  }
  __syncthreads();
  store_tile(hs, acc, c, g);
  __syncthreads();

  // rgb head on feat: 4 lanes per point, shuffle-reduced
  {
    const float* wrgb = a.wrgb;
    const int p = tid >> 2, q = tid & 3;
    float r0 = 0.f, r1 = 0.f, r2 = 0.f;
    for (int k = q * (W / 4); k < (q + 1) * (W / 4); ++k) {
      const float f = hs[k * LDH + p];
      r0 = fmaf(f, wrgb[k], r0);
      r1 = fmaf(f, wrgb[W + k], r1);
      r2 = fmaf(f, wrgb[2 * W + k], r2);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, o);
      r1 += __shfl_xor_sync(0xffffffffu, r1, o);
      r2 += __shfl_xor_sync(0xffffffffu, r2, o);
    }
    if (q == 0 && p < nvalid) {
      float* o = a.out + (row0 + p) * a.out_cols;
      o[0] = r0 + a.bheads[0];
      o[1] = r1 + a.bheads[1];
      o[2] = r2 + a.bheads[2];
      if (!TEX) o[3] = sdf_s[p];
    }
  }
}

template <bool TEX>
int launch(const FieldArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(siren_field_kernel<TEX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + T - 1) / T, B);
  siren_field_kernel<TEX><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int siren_field_full(const float* pts, const float* dirs, const float* w0t, const float* wst,
                     const float* bst, const float* wvht, const float* wvdt, const float* bv,
                     const float* wsig, const float* wrgb, const float* bheads, const float* gamma,
                     const float* beta, const float* alpha, const float* lbeta, float* feat,
                     float* rgb_sdf, float* raw_h, int B, int N, int D, void* stream) {
  FieldArgs a{};
  a.pts = pts; a.dirs = dirs; a.w0t = w0t; a.wst = wst; a.bst = bst;
  a.wvht = wvht; a.wvdt = wvdt; a.bv = bv; a.wsig = wsig; a.wrgb = wrgb; a.bheads = bheads;
  a.gamma = gamma; a.beta = beta; a.alpha = alpha; a.lbeta = lbeta; a.raw_h_in = nullptr;
  a.feat = feat; a.out = rgb_sdf; a.raw_h_out = raw_h;
  a.N = N; a.D = D; a.film_rows = D + 1; a.out_cols = 4;
  return launch<false>(a, B, static_cast<cudaStream_t>(stream));
}

int siren_field_tex(const float* raw_h, const float* dirs, const float* wvht, const float* wvdt,
                    const float* bv, const float* wrgb, const float* bheads, const float* gamma_v,
                    const float* beta_v, const float* alpha, const float* lbeta, float* feat,
                    float* rgb, int B, int N, void* stream) {
  FieldArgs a{};
  a.dirs = dirs; a.wvht = wvht; a.wvdt = wvdt; a.bv = bv; a.wrgb = wrgb; a.bheads = bheads;
  a.gamma = gamma_v; a.beta = beta_v; a.alpha = alpha; a.lbeta = lbeta; a.raw_h_in = raw_h;
  a.feat = feat; a.out = rgb;
  a.N = N; a.D = 0; a.film_rows = 1; a.out_cols = 3;
  return launch<true>(a, B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
