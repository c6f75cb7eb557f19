// Rezero linear attention (kernel K4).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_attention.py:
// fused_rezero_attention (_fused_rezero_attention: _phase1_kernel,
// _phase2_kernel). For x (B, N, C) bf16, heads 4 x dim 32:
//   ctx_h = softmax_over_tokens(x Wk_h)^T (x Wv_h)      (32 x 32 per head)
//   y     = mask * (x + g * ((x Wq_h) ctx_h) Wout + b_out)
// Keys are not length-masked: zero padding rows of the bucket enter the
// softmax, as in the reference; only the output rows at/after the length
// are zeroed.
//
// What bounds it on the H100: bytes and launch count, not products. The
// projections are small GEMMs (C <= 512 by 128/256 columns) on the tensor
// cores (mma.sync bf16, f32 accumulate); the activation is read twice and
// written once. The TPU kernel carried the online-softmax state
// (m, den, num) across sequential grid steps; here every 64-token tile
// writes its own (max, sum of exp, exp^T V) triple, a combine kernel merges
// the tiles of each batch element in a fixed order with the usual max
// rescaling, and phase 2 reads the merged context. Heads are handled as
// four 32 x 32 blocks directly, not as a masked 128 x 128 product.
#include "common.cuh"

namespace {

constexpr int TT = 64;  // tokens per tile
constexpr int NH = 4, DH = 32, HD = NH * DH;
constexpr int BK = 32;
constexpr int AST = BK + 8;
constexpr int NTHREADS = 256;
constexpr int KVS = 2 * HD + 4;  // f32 row stride of the K|V tile
constexpr int QS = HD + 4;       // f32 row stride of the Q tile
constexpr int ATS = HD + 8;      // bf16 row stride of the attn tile
constexpr int OST = 128 + 8;     // bf16 row stride of a staged Wout slice

// acc = x_tile (rows x C, row stride C) @ w[:, :BN_] (row stride ldw), f32.
// 8 warps as 2 (rows) x 4 (columns); warp tile 32 x BN_/4.
template <int BN_>
__device__ void tile_gemm_xw(float (&acc)[2][BN_ / 32][4], const bf16* xt, int rows, int C,
                             const bf16* w, int ldw, bf16* As, bf16* Bs) {
  constexpr int BST = BN_ + 8;
  constexpr int NT = BN_ / 32;
  constexpr int VPR = BN_ / 8;                      // 16-byte vectors per W row
  constexpr int BV = BK * VPR / NTHREADS;           // W vectors per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = C / BK;
  uint4 areg, breg[BV];
  auto load = [&](int kb) {
    int r = tid >> 2, kc = (tid & 3) * 8;
    areg = r < rows ? *reinterpret_cast<const uint4*>(xt + (size_t)r * C + kb * BK + kc)
                    : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int s = 0; s < BV; ++s) {
      int v = tid + s * NTHREADS;
      breg[s] = *reinterpret_cast<const uint4*>(w + (size_t)(kb * BK + v / VPR) * ldw +
                                                (v % VPR) * 8);
    }
  };
  load(0);
  for (int kb = 0; kb < nk; ++kb) {
    bf16* a = As + (kb & 1) * TT * AST;
    bf16* bs = Bs + (kb & 1) * BK * BST;
    *reinterpret_cast<uint4*>(a + (tid >> 2) * AST + (tid & 3) * 8) = areg;
#pragma unroll
    for (int s = 0; s < BV; ++s) {
      int v = tid + s * NTHREADS;
      *reinterpret_cast<uint4*>(bs + (v / VPR) * BST + (v % VPR) * 8) = breg[s];
    }
    __syncthreads();
    if (kb + 1 < nk) load(kb + 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      warp_mma_k16<2, NT>(acc, a + (wm * 32) * AST + kk * 16, AST,
                          bs + kk * 16 * BST + wn * (BN_ / 4), BST, lane);
  }
  __syncthreads();  // the staging buffers may be reused after return
}

constexpr size_t kPhase1Smem =
    (size_t)TT * KVS * 4 > (size_t)(2 * TT * AST + 2 * BK * (2 * HD + 8)) * 2
        ? (size_t)TT * KVS * 4
        : (size_t)(2 * TT * AST + 2 * BK * (2 * HD + 8)) * 2;

// Per tile: K|V projections, per-column max and exp-sum of K, and the
// per-head exp(K)^T V partial context.
__global__ void __launch_bounds__(NTHREADS) attn_phase1(const bf16* x, const bf16* wkv, int ldw,
                                                        int N, int C, float* part_m,
                                                        float* part_den, float* part_num) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * TT * AST;
  float* kv = reinterpret_cast<float*>(smem);  // reuses the staging area

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int tile = blockIdx.x, nt = gridDim.x, b = blockIdx.y;
  const int t0 = tile * TT, rows = min(TT, N - t0);

  float acc[2][8][4];
  tile_gemm_xw<2 * HD>(acc, x + ((size_t)b * N + t0) * C, rows, C, wkv, ldw, As, Bs);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = wm * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
        int c = wn * 64 + j * 8 + (lane & 3) * 2 + (e & 1);
        kv[r * KVS + c] = acc[i][j][e];
      }
  __syncthreads();

  const size_t pt = (size_t)b * nt + tile;
  if (tid < HD) {
    float mx = -INFINITY;
    for (int r = 0; r < rows; ++r) mx = fmaxf(mx, kv[r * KVS + tid]);
    float den = 0.f;
    for (int r = 0; r < TT; ++r) {
      float e = r < rows ? expf(kv[r * KVS + tid] - mx) : 0.f;
      kv[r * KVS + tid] = e;
      den += e;
    }
    part_m[pt * HD + tid] = mx;
    part_den[pt * HD + tid] = den;
  }
  __syncthreads();

  const int h = tid >> 6, i = (tid >> 1) & 31, j0 = (tid & 1) * 16;
  float a[16];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) a[jj] = 0.f;
  for (int r = 0; r < rows; ++r) {
    float e = kv[r * KVS + h * DH + i];
    const float* v = kv + r * KVS + HD + h * DH + j0;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) a[jj] += e * v[jj];
  }
  float* out = part_num + (pt * NH + h) * DH * DH + i * DH + j0;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) out[jj] = a[jj];
}

// Merge the tiles of one (batch, head): ctx = sum_t num_t e^(m_t - M) /
// sum_t den_t e^(m_t - M), in tile order.
__global__ void __launch_bounds__(NTHREADS) attn_combine(const float* part_m,
                                                         const float* part_den,
                                                         const float* part_num, int nt,
                                                         float* ctx) {
  __shared__ float M[DH], D[DH];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid < DH) {
    const int c = h * DH + tid;
    float mx = -INFINITY;
    for (int t = 0; t < nt; ++t) mx = fmaxf(mx, part_m[((size_t)b * nt + t) * HD + c]);
    float den = 0.f;
    for (int t = 0; t < nt; ++t) {
      size_t o = ((size_t)b * nt + t) * HD + c;
      den += part_den[o] * expf(part_m[o] - mx);
    }
    M[tid] = mx;
    D[tid] = den;
  }
  __syncthreads();
  for (int o = tid; o < DH * DH; o += NTHREADS) {
    const int i = o / DH;
    float a = 0.f;
    for (int t = 0; t < nt; ++t) {
      size_t pt = (size_t)b * nt + t;
      a += part_num[(pt * NH + h) * DH * DH + o] * expf(part_m[pt * HD + h * DH + i] - M[i]);
    }
    ctx[((size_t)b * NH + h) * DH * DH + o] = a / D[i];
  }
}

constexpr size_t kPhase2Smem = (size_t)2 * TT * AST * 2 + (size_t)2 * BK * (HD + 8) * 2 +
                               (size_t)TT * QS * 4 + (size_t)NH * DH * DH * 4 +
                               (size_t)TT * ATS * 2;

// Per tile: Q projection, attn = Q ctx (rounded to bf16), then
// y = mask * (x + g * (attn Wout + b_out)) in bf16 arithmetic.
__global__ void __launch_bounds__(NTHREADS) attn_phase2(const bf16* x, const bf16* wq, int ldw,
                                                        const float* ctx, const bf16* wo,
                                                        const float* bo, const float* g,
                                                        const int* lens, bf16* y, int N,
                                                        int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * TT * AST;                                 // [2][BK][HD + 8]
  float* Qs = reinterpret_cast<float*>(Bs + 2 * BK * (HD + 8));  // [TT][QS]
  float* Cs = Qs + TT * QS;                                      // [NH][DH][DH]
  bf16* At = reinterpret_cast<bf16*>(Cs + NH * DH * DH);         // [TT][ATS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int t0 = tile * TT, rows = min(TT, N - t0);
  const bf16* xt = x + ((size_t)b * N + t0) * C;

  for (int o = tid; o < NH * DH * DH; o += NTHREADS) Cs[o] = ctx[(size_t)b * NH * DH * DH + o];

  float acc[2][4][4];
  tile_gemm_xw<HD>(acc, xt, rows, C, wq, ldw, As, Bs);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = wm * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
        int c = wn * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
        Qs[r * QS + c] = acc[i][j][e];
      }
  __syncthreads();

  {
    const int c = tid & (HD - 1), h = c / DH, jj = c % DH;
    for (int r = tid / HD; r < TT; r += NTHREADS / HD) {
      float a = 0.f;
#pragma unroll 8
      for (int i = 0; i < DH; ++i) a += Qs[r * QS + h * DH + i] * Cs[(h * DH + i) * DH + jj];
      At[r * ATS + c] = __float2bfloat16(a);
    }
  }
  __syncthreads();

  const float gb = bf16_round(g[0]);
  const int len = lens[b];
  for (int n0 = 0; n0 < C; n0 += 128) {
    float acc2[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
    for (int kb = 0; kb < HD / BK; ++kb) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        int v = tid + s * NTHREADS;
        int kr = v >> 4, nc = (v & 15) * 8;
        *reinterpret_cast<uint4*>(Bs + kr * OST + nc) =
            *reinterpret_cast<const uint4*>(wo + (size_t)(kb * BK + kr) * C + n0 + nc);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        warp_mma_k16<2, 4>(acc2, At + (wm * 32) * ATS + kb * BK + kk * 16, ATS,
                           Bs + kk * 16 * OST + wn * 32, OST, lane);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r = wm * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
          if (r >= rows) continue;
          int c = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
          float o = bf16_round(acc2[i][j][e]);
          o = bf16_round(o + bf16_round(bo[c]));
          float xv = __bfloat162float(xt[(size_t)r * C + c]);
          float yv = bf16_round(xv + bf16_round(gb * o));
          y[((size_t)b * N + t0 + r) * C + c] = __float2bfloat16(t0 + r < len ? yv : 0.f);
        }
  }
}

}  // namespace

extern "C" {

int us_attn_n_tiles(int N) { return us_ceil_div(N, TT); }

// x (B, N, C) bf16; w_qkv (C, 3*128) bf16 [q|k|v]; w_out (128, C) bf16;
// b_out (C) f32; g (1) f32 the rezero gate; lens (B) valid rows. Scratch:
// part_m/part_den (B, nt, 128), part_num (B, nt, 4, 32, 32), ctx
// (B, 4, 32, 32), all f32. C must be a multiple of 128.
int us_rezero_attention(const void* x, const void* w_qkv, const void* w_out,
                        const float* b_out, const float* g, const int* lens, void* y,
                        float* part_m, float* part_den, float* part_num, float* ctx, int B,
                        int N, int C, void* stream) {
  static bool smem_set = false;
  int err;
  if (!smem_set) {
    err = (int)cudaFuncSetAttribute(attn_phase1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kPhase1Smem);
    if (err != 0) return err;
    err = (int)cudaFuncSetAttribute(attn_phase2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kPhase2Smem);
    if (err != 0) return err;
    smem_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w = static_cast<const bf16*>(w_qkv);
  const int nt = us_ceil_div(N, TT), ldw = 3 * HD;
  attn_phase1<<<dim3(nt, B), NTHREADS, kPhase1Smem, st>>>(xb, w + HD, ldw, N, C, part_m,
                                                          part_den, part_num);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  attn_combine<<<dim3(NH, B), NTHREADS, 0, st>>>(part_m, part_den, part_num, nt, ctx);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  attn_phase2<<<dim3(nt, B), NTHREADS, kPhase2Smem, st>>>(
      xb, w, ldw, ctx, static_cast<const bf16*>(w_out), b_out, g, lens,
      static_cast<bf16*>(y), N, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
