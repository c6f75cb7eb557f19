// Deep ResnetBlock with int8 convs: K9 (pre-quantized activations) and
// K10b (JAX's in-kernel int8 mode), one chain with two sets of roundings.
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resnet.py:
//   K9   fused_resnet_block_deep_i8 (_fused_resnet_deep_i8pre:
//        _kernel_a_deep_i8 with _conv3x3_taps_i8pre, _kernel_glue_q_deep);
//   K10b fused_resnet_block_deep(int8=True) (_fused_resnet_deep with int8:
//        _kernel_a_deep and _kernel_b_deep with _conv3x3_taps_int8).
// Kernel C is K8's, shared from resnet_block.cu. The block runs as
//
//   x8 = quantize(x)   per batch element, one scale over the rows before
//                      the length (us_i8_quantize_rows: a pass of maxima,
//                      then the quantize); for cin > cout conv1 runs in
//                      bf16 instead (K8's kernel A), as in JAX
//   c1 = conv3x3_i8(x8) * (1/sx)(1/sw) + b1        -> bf16 + statistics
//   h8 = quantize(mish(GN1(c1)) + FiLM, masked)    two passes, below
//   c2 = conv3x3_i8(h8) * (1/sx2)(1/sw2) + b2      -> bf16 + statistics
//   out = mish(GN2(c2)) * mask + residual          (K8's kernel C)
//
// The two kernels differ only in their roundings (the `k10b` argument of
// the quantize and the glue): K9's scale is 127 / max(m, 1e-8) and its glue
// quantizes h in f32; K10b's is 127 / (m + 1e-8) (pallas_resnet.py:240) and
// its glue rounds h to bf16 before the maximum and the quantize
// (pallas_resnet.py:420). K10b's TPU kernel quantizes a window, the masked
// layer plus one zero frame above and below; K10b's "tile" is the whole
// layer of a batch element, so every row, halo frames included, takes the
// one scale of its batch element and the input quantizes once ahead of the
// conv, as K9's does. (K10a's halo rows take the scale of the tile they
// feed, which is why it keeps its own chain, csrc/resnet_block_i8.cu.)
//
// Scales: weights per output channel, computed once when the weights load
// (ops/fused_resnet_deep.quant_w: reciprocals, as _quant_w) and packed
// with them; activations per batch element, not per tensor as the flat
// int8 path has it. The glue's scale needs the abs-max of the whole layer
// before any value can round, so the glue runs twice: pass 0 writes h in
// f32 (K10b: its bf16 value) and one maximum of |h| a block, pass 1 reduces
// them (every block the same values, in the same order) and rounds h. A max
// does not depend on the order of its operands, so the scale is exact. The
// convs take sx and rsw and form (1 / sx) * rsw themselves, so no launch of
// its own reduces the maxima.
//
// What bounds it on the H100: each int8 conv is 6-24 GOP (3 rows at the
// 344-frame bucket) against 0.6-9.4 MB of int8 weights; at the int8 rate of
// 1979 TOP/s that is 3-12 us, so the tensor cores bound it, at half K8's
// operation time. Both int8 convs run on K8's Hopper loop (resnet_block.cu
// conv_tc with I8: per 128-channel chunk one TMA box shared by the 9 taps,
// a zero row past the length and the grid, A from ldmatrix registers, the
// weights packed at load into K-major BN x 128 int8 tiles in the 128-byte
// swizzle through an mbarrier ring, wgmma m64nNk32 s8 into s32). The loop's
// shared memory does not depend on Cout (a Cout tile of BN columns a
// block), so K10b's Cout = 1024 takes it as K8 does; its int8 convs have
// Cin <= 1024 (8 chunks), since Cin > Cout (2048 -> 512, 1024 -> 256) puts
// conv1 in bf16. The dequantize, bias and GroupNorm statistics ride in the
// conv's epilogue; the glue passes move c1 once, h in f32 twice and h8
// once. Every launch of the chain is a programmatic dependent launch
// (common.cuh launch_pdl). Rounding follows JAX: round half to even
// (rintf), clip to +-127, and the dequantize as one f32 multiply and one f32
// add (no fused multiply-add).
//
// On a frame slice of the seq axis or a column slice of the model axis
// (ops/fused_resnet_deep.py resnet_block_deep_i8_sharded) the chain keeps
// the global numbers of JAX's GSPMD, which runs the kernel on gathered
// operands: the two maxima a scale needs are split from their use
// (us_i8_absmax then us_i8_quantize_scaled; us_i8_glue_h then
// us_i8_glue_q), the host all-reduces them (MAX) in between, GroupNorm 1
// reads every rank's tile sums with the global row count, and the convs
// read a halo'd int8 input (resnet_block.cu us_resnet_conv3x3_i8_halo).
// These launches are plain (a collective runs between them); the
// unsharded chain keeps its programmatic dependent launches.
#include "common.cuh"

namespace {

constexpr int GLUE_ROWS = 64;  // rows of one glue block (a chunk)
constexpr int Q_ROWS = 8;      // rows of one quantize block (many blocks: a pass is latency-bound)

// The scale of a batch element from its maxima amax[0, n), each block the
// same reduction: K9's 127 / max(m, 1e-8), or K10b's 127 / (m + 1e-8) (one
// f32 add, one f32 division); NaN propagates, as torch.amax and jnp.max do.
US_DEV float act_scale(const float* amax, int n, float* scratch, int k10b) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = max_nan(m, amax[i]);
  m = block_max(m, scratch);
  if (k10b) return __fdiv_rn(127.f, __fadd_rn(m, 1e-8f));
  return 127.f / (m != m ? m : fmaxf(m, 1e-8f));
}

// amax[b, chunk] = max |x| over the rows of the chunk before lens[b] (0
// for a chunk past it), rows of amax ld apart. Grid (row chunks of Q_ROWS,
// B); 8 channels a thread.
__global__ void __launch_bounds__(256) i8_absmax(const bf16* x, const int* lens, float* amax,
                                                 int ld, int N, int C) {
  __shared__ float scratch[256];
  griddep_wait();
  griddep_launch();
  const int b = blockIdx.y, r0 = blockIdx.x * Q_ROWS;
  const int nr = max(0, min(Q_ROWS, min(N, lens[b]) - r0)), pieces = C / 8;
  float m = 0.f;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < nr * pieces; idx += blockDim.x) {
    float v[8];
    load8(x + ((size_t)b * N + r0 + idx / pieces) * C + (idx % pieces) * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = max_nan(m, fabsf(v[e]));
  }
  m = block_max(m, scratch);
  if (threadIdx.x == 0) amax[(size_t)b * ld + blockIdx.x] = m;
}

// x8 = clip(rint(x * sx[b]), -127, 127) on rows < lens[b], 0 after, with sx
// from the maxima amax (B, n_amax) in K9's or K10b's form. Grid (row chunks
// of Q_ROWS, B); block 0 of each b writes sx[b]. 8 channels a thread.
__global__ void __launch_bounds__(256) i8_quantize(const bf16* x, const int* lens,
                                                   const float* amax, int n_amax, float* sx,
                                                   int8_t* x8, int N, int C, int k10b) {
  __shared__ float scratch[256];
  griddep_wait();
  griddep_launch();
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * Q_ROWS, nr = min(Q_ROWS, N - r0), pieces = C / 8;
  const int len = lens[b], total = nr * pieces;
  float s = 0.f;
  for (int base = 0; base < total; base += 8 * blockDim.x) {  // the same trips in every thread
    // eight pieces loaded before any store (int8 stores may alias them)
    uint4 raw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + threadIdx.x + k * blockDim.x, m = r0 + idx / pieces;
      raw[k] = idx < total && m < len
                   ? __ldg(reinterpret_cast<const uint4*>(x + ((size_t)b * N + m) * C +
                                                          (idx % pieces) * 8))
                   : make_uint4(0, 0, 0, 0);
    }
    if (base == 0) {
      s = act_scale(amax + (size_t)b * n_amax, n_amax, scratch, k10b);
      if (blockIdx.x == 0 && threadIdx.x == 0) sx[b] = s;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + threadIdx.x + k * blockDim.x;
      if (idx >= total) continue;
      const int m = r0 + idx / pieces;
      uint2 q = make_uint2(0, 0);
      if (m < len) {
        int8_t* qe = reinterpret_cast<int8_t*>(&q);
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f2 = __bfloat1622float2(hv[i]);
          qe[2 * i] = quant_i8(f2.x, s);
          qe[2 * i + 1] = quant_i8(f2.y, s);
        }
      }
      *reinterpret_cast<uint2*>(x8 + ((size_t)b * N + m) * C + (idx % pieces) * 8) = q;
    }
  }
}

struct GlueArgs {
  const bf16* c;        // (B, N, C) conv1 output
  const float* part;    // (B, n_tiles, 2, C) conv1's tile sums and sums of squares
  const float* scale;   // (C)
  const float* shift;   // (C)
  const bf16* film;     // (B, C)
  const int* lens;      // (B)
  float* h;             // (B, N, C) pass 0 writes h, pass 1 reads it
  float* amax;          // (B, ld) maxima of |h|, one a pass-0 block
  float* sx;            // (B) pass 1 writes the scale
  int8_t* h8;           // pass 1: (B, N, C)
  int N, C, n_tiles, groups;
  int n_rows;           // the rows GroupNorm 1 pools over (N, or a frame slice's global rows)
  int ld;               // amax's row: the maxima pass 1 reduces a batch element
  float eps;
  int k10b;             // K10b's roundings: h to bf16, the scale 127 / (max + 1e-8)
};

// Pass 0: h = mish(GN1(c1) * scale + shift) + film, zero on rows >= lens
// (the JAX glue's arithmetic in f32, one rounding per operation; K10b then
// rounds it to bf16), written in f32 with one maximum of |h| a block.
// GroupNorm 1 comes from conv1's tile sums here (each block its groups, a
// warp a group, in one fixed order, so every block has the same values):
// no launch of its own. Block: 8 row lanes x 32 channel groups of 8; grid
// (channel blocks of 256, row chunks of GLUE_ROWS, B).
__global__ void __launch_bounds__(256) glue_h(GlueArgs p) {
  __shared__ float red[256], g_mu[32], g_iv[32];
  griddep_wait();
  griddep_launch();
  const int tid = threadIdx.x, lane_r = tid >> 5;
  const int c0 = (blockIdx.x * 32 + (tid & 31)) * 8;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int N = p.N, C = p.C;
  const int len = p.lens[b];
  const bool active = c0 < C;
  // the thread's rows, loaded first
  uint4 raw[GLUE_ROWS / 8];
  const int m_end = min(N, (chunk + 1) * GLUE_ROWS);
#pragma unroll
  for (int k = 0; k < GLUE_ROWS / 8; ++k) {
    const int m = chunk * GLUE_ROWS + lane_r + 8 * k;
    raw[k] = active && m < m_end
                 ? __ldg(reinterpret_cast<const uint4*>(p.c + ((size_t)b * N + m) * C + c0))
                 : make_uint4(0, 0, 0, 0);
  }
  const int cg = C / p.groups, g0 = blockIdx.x * 256 / cg;
  {
    const int lane = tid & 31, ng = min(256, C - blockIdx.x * 256) / cg;
    for (int gi = lane_r; gi < ng; gi += 8) {
      const int g = g0 + gi;
      float s1 = 0.f, s2 = 0.f;
      for (int idx = lane; idx < p.n_tiles * cg; idx += 32) {
        const float* pt = p.part + ((size_t)b * p.n_tiles + idx / cg) * 2 * C + g * cg + idx % cg;
        s1 += pt[0];
        s2 += pt[C];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const float cnt = (float)p.n_rows * (float)cg, mu = s1 / cnt;
      if (lane == 0) g_mu[gi] = mu, g_iv[gi] = 1.0f / sqrtf(s2 / cnt - mu * mu + p.eps);
    }
  }
  __syncthreads();
  float mx = 0.f;
  if (active) {
    const float mean = g_mu[c0 / cg - g0], inv = g_iv[c0 / cg - g0];
    float sc[8], sh[8], fi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[e] = p.scale[c0 + e];
      sh[e] = p.shift[c0 + e];
      fi[e] = __bfloat162float(p.film[b * C + c0 + e]);
    }
#pragma unroll
    for (int k = 0; k < GLUE_ROWS / 8; ++k) {
      const int m = chunk * GLUE_ROWS + lane_r + 8 * k;
      if (m >= m_end) continue;
      float h[8];
      const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(hv[i]);
        h[2 * i] = f2.x, h[2 * i + 1] = f2.y;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = __fmul_rn(__fsub_rn(h[e], mean), inv);
        v = __fadd_rn(__fmul_rn(v, sc[e]), sh[e]);
        v = __fadd_rn(mish_f32(v), fi[e]);
        h[e] = m < len ? (p.k10b ? bf16_round(v) : v) : 0.f;
        mx = max_nan(mx, fabsf(h[e]));
      }
      float4* dst = reinterpret_cast<float4*>(p.h + ((size_t)b * N + m) * C + c0);
      dst[0] = make_float4(h[0], h[1], h[2], h[3]);
      dst[1] = make_float4(h[4], h[5], h[6], h[7]);
    }
  }
  mx = block_max(mx, red);
  if (tid == 0) p.amax[(size_t)b * p.ld + chunk * gridDim.x + blockIdx.x] = mx;
}

// Pass 1: the batch element's scale from the maxima amax[b, 0 .. ld)
// (pass 0's, or on a slice those reduced over the axis; every block the same
// reduction; block 0 writes sx), then h8 = quantize(h). Grid as pass 0.
__global__ void __launch_bounds__(256) glue_q(GlueArgs p) {
  __shared__ float red[256];
  griddep_wait();
  griddep_launch();
  const int tid = threadIdx.x, lane_r = tid >> 5;
  const int c0 = (blockIdx.x * 32 + (tid & 31)) * 8;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int N = p.N, C = p.C;
  const bool active = c0 < C;
  const int m_end = min(N, (chunk + 1) * GLUE_ROWS);
  float4 hv[GLUE_ROWS / 8][2];  // the thread's rows, loaded before the reduction
#pragma unroll
  for (int k = 0; k < GLUE_ROWS / 8; ++k) {
    const int m = chunk * GLUE_ROWS + lane_r + 8 * k;
    const float4* src = reinterpret_cast<const float4*>(p.h + ((size_t)b * N + m) * C + c0);
    hv[k][0] = active && m < m_end ? __ldcg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    hv[k][1] = active && m < m_end ? __ldcg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float s = act_scale(p.amax + (size_t)b * p.ld, p.ld, red, p.k10b);
  if (blockIdx.x == 0 && chunk == 0 && tid == 0) p.sx[b] = s;
  if (!active) return;
#pragma unroll
  for (int k = 0; k < GLUE_ROWS / 8; ++k) {
    const int m = chunk * GLUE_ROWS + lane_r + 8 * k;
    if (m >= m_end) continue;
    const float h[8] = {hv[k][0].x, hv[k][0].y, hv[k][0].z, hv[k][0].w,
                        hv[k][1].x, hv[k][1].y, hv[k][1].z, hv[k][1].w};
    uint2 q;
    int8_t* qe = reinterpret_cast<int8_t*>(&q);
#pragma unroll
    for (int e = 0; e < 8; ++e) qe[e] = quant_i8(h[e], s);
    *reinterpret_cast<uint2*>(p.h8 + ((size_t)b * N + m) * C + c0) = q;
  }
}

GlueArgs glue_args(const void* c1, const float* part, int n_tiles, int groups, float eps,
                   const float* scale, const float* shift, const void* film, const int* lens,
                   float* h, float* amax, void* h8, float* sx, int N, int C, int n_rows, int ld,
                   int k10b) {
  GlueArgs p;
  p.c = static_cast<const bf16*>(c1);
  p.part = part;
  p.n_tiles = n_tiles;
  p.groups = groups;
  p.eps = eps;
  p.scale = scale;
  p.shift = shift;
  p.film = static_cast<const bf16*>(film);
  p.lens = lens;
  p.h = h;
  p.amax = amax;
  p.sx = sx;
  p.h8 = static_cast<int8_t*>(h8);
  p.N = N;
  p.C = C;
  p.n_rows = n_rows;
  p.ld = ld;
  p.k10b = k10b;
  return p;
}

bool glue_groups_ok(int C, int groups) {
  return !(C % groups || (C / groups) % 8 || 256 / (C / groups) > 32);
}

}  // namespace

extern "C" {


// Maxima the glue's pass 0 writes a batch element (its blocks).
int us_i8_glue_blocks(int N, int C) { return us_ceil_div(N, GLUE_ROWS) * us_ceil_div(C, 256); }

// The maxima the conv1-input quantize writes a batch element.
int us_i8_quantize_chunks(int N) { return us_ceil_div(N, Q_ROWS); }

// The conv1 input of K9 / K10b: amax (B, us_i8_quantize_chunks(N)) the
// maxima of |x| over the rows before the length, then the scale sx (B; K9's
// form, or K10b's with k10b) and x8 = quantize(x) (B, N, Cin) with rows >=
// lens zero. Cin % 8 == 0.
int us_i8_quantize_rows(const void* x, const int* lens, float* amax, void* x8, float* sx, int B,
                        int N, int Cin, int k10b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(us_ceil_div(N, Q_ROWS), B);
  int err = launch_pdl(i8_absmax, grid, 256, 0, st, static_cast<const bf16*>(x), lens, amax,
                       (int)grid.x, N, Cin);
  if (err) return err;
  return launch_pdl(i8_quantize, grid, 256, 0, st, static_cast<const bf16*>(x), lens,
                    static_cast<const float*>(amax), (int)grid.x, sx, static_cast<int8_t*>(x8),
                    N, Cin, k10b);
}

// The glue of K9 (_kernel_glue_q_deep) and, with k10b, K10b (the head of
// _kernel_b_deep): pass 0 reduces GroupNorm 1 from part (B, n_tiles, 2, C),
// writes h (B, N, C) f32 and the maxima of |h| to amax (B,
// us_i8_glue_blocks(N, C)); pass 1 reduces them to sx (B) and writes h8 =
// quantize(h). (C / groups) % 8 == 0, C / groups >= 8.
int us_i8_glue(const void* c1, const float* part, int n_tiles, int groups, float eps,
               const float* scale, const float* shift, const void* film, const int* lens,
               float* h, float* amax, void* h8, float* sx, int B, int N, int C, int k10b,
               void* stream) {
  if (!glue_groups_ok(C, groups)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GlueArgs p = glue_args(c1, part, n_tiles, groups, eps, scale, shift, film, lens, h, amax, h8,
                         sx, N, C, N, us_i8_glue_blocks(N, C), k10b);
  dim3 grid(us_ceil_div(C, 256), us_ceil_div(N, GLUE_ROWS), B);
  int err = launch_pdl(glue_h, grid, 256, 0, st, p);
  if (err) return err;
  return launch_pdl(glue_q, grid, 256, 0, st, p);
}

// --- the sharded chain (a frame slice of the seq axis and / or a column
// slice of the model axis): the two reductions of a batch element's scale
// split at their maximum, so that the maxima are reduced over the axis
// between the launches (one MAX all-reduce each). Plain launches: a
// collective runs between them.

// The input quantize's first half: amax (B, ld) the maxima of |x| over the
// rows before the length, us_i8_quantize_chunks(N) of them a row (the rest
// of a row untouched: the caller's zeros, which a maximum of |x| ignores).
int us_i8_absmax(const void* x, const int* lens, float* amax, int ld, int B, int N, int Cin,
                 void* stream) {
  const dim3 grid(us_ceil_div(N, Q_ROWS), B);
  if (ld < (int)grid.x) return (int)cudaErrorInvalidValue;
  i8_absmax<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x),
                                                                  lens, amax, ld, N, Cin);
  return (int)cudaGetLastError();
}

// Its second half: the scale sx (B; K9's form) from amax (B, ld) and x8 =
// quantize(x) (B, N, Cin), rows >= lens zero.
int us_i8_quantize_scaled(const void* x, const int* lens, const float* amax, int ld, void* x8,
                          float* sx, int B, int N, int Cin, void* stream) {
  const dim3 grid(us_ceil_div(N, Q_ROWS), B);
  i8_quantize<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), lens, amax, ld, sx, static_cast<int8_t*>(x8), N, Cin, 0);
  return (int)cudaGetLastError();
}

// The glue's pass 0 alone: GroupNorm 1 over n_rows rows from part (B,
// n_tiles, 2, C) (on a frame slice every rank's tile sums, gathered), h
// (B, N, C) f32 and the maxima of |h| into amax (B, ld), the first
// us_i8_glue_blocks(N, C) of a row. K9's roundings.
int us_i8_glue_h(const void* c1, const float* part, int n_tiles, int groups, float eps,
                 const float* scale, const float* shift, const void* film, const int* lens,
                 float* h, float* amax, int ld, int B, int N, int C, int n_rows, void* stream) {
  if (!glue_groups_ok(C, groups) || ld < us_i8_glue_blocks(N, C))
    return (int)cudaErrorInvalidValue;
  GlueArgs p = glue_args(c1, part, n_tiles, groups, eps, scale, shift, film, lens, h, amax,
                         nullptr, nullptr, N, C, n_rows, ld, 0);
  dim3 grid(us_ceil_div(C, 256), us_ceil_div(N, GLUE_ROWS), B);
  glue_h<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The glue's pass 1 alone: sx (B) from amax (B, ld) (the maxima reduced
// over the axis), and h8 = quantize(h) (B, N, C).
int us_i8_glue_q(const float* h, const float* amax, int ld, void* h8, float* sx, int B, int N,
                 int C, void* stream) {
  GlueArgs p = glue_args(nullptr, nullptr, 0, 1, 0.f, nullptr, nullptr, nullptr, nullptr,
                         const_cast<float*>(h), const_cast<float*>(amax), h8, sx, N, C, N, ld,
                         0);
  dim3 grid(us_ceil_div(C, 256), us_ceil_div(N, GLUE_ROWS), B);
  glue_q<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
