// Anti-aliased snake activation, alone (kernel K6) and followed by the
// dilated conv1d + bias (+ residual) of an AMP block (kernel K5).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_kernels.py:
// fused_aa_snake (_fused_aa_snake, body _aa_snake_kernel) and
// fused_aa_snake_conv (_fused_aa_snake_conv, bodies _aa_snake_conv_kernel*),
// both over the core _aa_core. Per channel, with a = alpha, ib = 1/(beta+1e-9):
//   y2[m]  = sum_k f_{m%2}[k] x[m/2 + off_{m%2} + k]     2x polyphase upsample
//   z[m]   = y2[m] + ib sin^2(a y2[m])                    snake / snakebeta
//   y[t]   = sum_i g[i] z[2t - 5 + i]                     2x downsample
//   out[t] = bias + sum_j W[j]^T y[t + (j - (k-1)/2) d] (+ residual)    (K5)
// with the edges of the plain path (ops/aa_snake.py, the XLA twin): x is
// replicate-padded before the upsample and z before the downsample (every
// index clamped to the signal), and the conv reads zeros outside [0, T).
// The Pallas kernel's extended-LTI edges are not copied.
//
// What bounds it on the H100. The conv is 2 k C^2 flops per sample: 136
// GFLOP over the 72 K5 launches of a 344-frame vocoder call, 0.14 ms at the
// bf16 tensor-core peak. The AA part is about 60 f32 operations per sample
// and channel (0.1 ms over the call at the f32 peak) and bytes are few: one
// read of x (and of the residual) and one write.
//
// Design: two launches a K5 call, each element's activation made once.
//  * aa_kernel: a block owns 64 samples x 32 channels of one batch
//    element. It stages the x window (clamped: the replicate pad; 4-byte
//    loads where the tile is interior) in shared memory, computes z once
//    per upsampled position, an even / odd pair from the same seven x
//    values (two pairs a thread in an interior tile), into two parity rows,
//    and the downsample from them, two samples a thread; snake sines by
//    range reduction and the SFU sine, all f32. K5 writes y = AA(x) in bf16
//    channels-last (B, T, C), 16 bytes of 8 channels a store, the
//    tensor-core operand (one rounding, as before); K6 writes (B, C, T).
//    (Measured and dropped, PERF.md: two 64-sample halves of a 128-sample
//    tile sharing z rows at 40 registers, six blocks an SM; 128-sample
//    tiles; the SM's carveout held at its maximum for the conv behind.)
//  * the conv, an implicit GEMM on wgmma, M = time, N = output channels,
//    K = taps x input channels, on the main loop of the U-Net convs
//    (csrc/hopper.cuh, csrc/resnet_block.cu conv_tc): per 64-channel chunk
//    TMA copies bring the box of y rows t0 - R .. t0 + 127 + R (R =
//    (k-1)/2 d) in the 128-byte swizzle, one copy up to R = 64 and pieces
//    of at most 256 rows above, their zero fill the conv's zero padding;
//    tap j of tile row r is box row r + j d, read by ldmatrix into wgmma's
//    A fragment; B is the weights packed once at load (ops/aa_snake.py
//    pack_conv_weight). Two consumer warpgroups of 64 rows and BN output
//    channels (conv_cols: 32, 64 or 128, a divisor of C). The ring form
//    (aa_conv_kernel): a block a (time tile, Cout tile), the weights
//    streamed through a ring of 4 stages by a producer warp. C <= 64
//    (aa_conv_resident_kernel, the narrow stages where a block's work is
//    a few microseconds), where every tap's weights and two boxes fit in
//    shared memory: the weights stay there and a persistent grid walks the
//    time tiles, the next tile's box in flight.
//    The epilogue stages the f32 tile transposed in shared memory and adds
//    the f32 bias and residual before one rounding, storing 16-byte runs of
//    8 samples of a channel into (B, C, T). The conv is a programmatic
//    dependent launch behind aa_kernel.
// The snake coefficients and f32 bias come packed at load; the filter taps
// are kernel parameters.
#include "hopper.cuh"

namespace {

constexpr int NU = 6;        // taps per upsample phase
constexpr int ND = 12;       // downsample taps
constexpr int UP_OFF0 = -3;  // y2[2u]   reads x[u - 3 .. u + 2]
constexpr int UP_OFF1 = -2;  // y2[2u+1] reads x[u - 2 .. u + 3]
constexpr int DN_OFF = -5;   // y[t]     reads z[2t - 5 .. 2t + 6]

struct Taps {
  float f0[NU], f1[NU], g[ND];
};

// sin(v): v reduced to [-pi, pi] by 2 pi in two f32 parts, then the SFU
// sine (absolute error about 5e-7 there).
US_DEV float snake_sin(float v) {
  const float k = rintf(v * 0.159154943f);
  const float r = fmaf(-k, -1.74845553e-7f, fmaf(-k, 6.28318548f, v));
  return __sinf(r);
}

// A block: 64 samples x 32 channels, 23 KB and 48 registers, five an SM;
// a 2.8 M-sample stage is 1376 blocks, 2.1 rounds of 660 slots (128-sample
// tiles: 688 blocks, 1.04 rounds, 9% slower a K5 call, PERF.md).
constexpr int AA_TT = 64;          // output samples a block
constexpr int AA_CB = 32;          // channels a block
constexpr int AA_THREADS = 256;
constexpr int AA_XW = AA_TT + 12;  // x window: x[t0 - 6 .. t0 + TT + 5]
constexpr int AA_QN = AA_TT + 6;   // upsample positions u = t0 - 3 + q: z[2u], z[2u + 1]
constexpr int AA_QW = AA_QN;       // z row stride: even, so pairs of z move as 8 bytes
static_assert(AA_QW % 2 == 0 && AA_XW % 2 == 0, "pairs of z and of x move together");

// z of the pair at u from x[uc - 3 .. uc + 3] (xv), uc = u clamped to the
// signal: (even phase, odd phase).
US_DEV float2 snake_pair(const float (&xv)[NU + 1], const Taps& tp, float ac, float ibc) {
  float e = 0.f, o = 0.f;
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    e = fmaf(tp.f0[k], xv[k], e);
    o = fmaf(tp.f1[k], xv[k + 1], o);
  }
  const float se = snake_sin(e * ac), so = snake_sin(o * ac);
  return make_float2(fmaf(ibc, se * se, e), fmaf(ibc, so * so, o));
}

// y at tile rows r and r + 1 (r even) of one channel:
// y[t0 + r] = sum_s g[2s] zo[r + s] + g[2s + 1] ze[r + 1 + s]
US_DEV float2 down_pair(const float* zor, const float* zer, const Taps& tp) {
  float zo[8], ze[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float2 a = *reinterpret_cast<const float2*>(zor + 2 * m);
    const float2 b = *reinterpret_cast<const float2*>(zer + 2 * m);
    zo[2 * m] = a.x, zo[2 * m + 1] = a.y, ze[2 * m] = b.x, ze[2 * m + 1] = b.y;
  }
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int k = 0; k < ND / 2; ++k) {
    y0 = fmaf(tp.g[2 * k + 1], ze[k + 1], fmaf(tp.g[2 * k], zo[k], y0));
    y1 = fmaf(tp.g[2 * k + 1], ze[k + 2], fmaf(tp.g[2 * k], zo[k + 1], y1));
  }
  return make_float2(y0, y1);
}

// OUT_CL: y (B, T, C) channels-last, 8 channels a store (C % 32 == 0);
// otherwise y (B, C, T).
template <bool OUT_CL>
__global__ void __launch_bounds__(AA_THREADS)
    aa_kernel(const bf16* __restrict__ x, const float* __restrict__ alpha,
              const float* __restrict__ ib, const Taps tp, bf16* __restrict__ y, int C, int T) {
  __shared__ __align__(16) bf16 xs[AA_CB][AA_XW];
  __shared__ __align__(16) float ze[AA_CB][AA_QW], zo[AA_CB][AA_QW];
  __shared__ float2 coef[AA_CB];  // (a, ib) of the block's channels
  // the conv behind it may start its prologue once every block has started
  griddep_launch();
  const int t0 = blockIdx.x * AA_TT, c0 = blockIdx.y * AA_CB, b = blockIdx.z;
  const int nch = min(AA_CB, C - c0);
  const bf16* xb = x + ((size_t)b * C + c0) * T;
  if (threadIdx.x < AA_CB)
    coef[threadIdx.x] = threadIdx.x < nch ? make_float2(alpha[c0 + threadIdx.x], ib[c0 + threadIdx.x])
                                          : make_float2(0.f, 0.f);
  // no index of the tile's windows leaves the signal: no clamping
  const bool inner = t0 >= 6 && t0 + AA_TT + 6 <= T && nch == AA_CB;
  if (inner && (T & 1) == 0) {
    for (int i = threadIdx.x; i < AA_CB * (AA_XW / 2); i += AA_THREADS) {
      const int c = i / (AA_XW / 2), j = i - c * (AA_XW / 2);
      reinterpret_cast<uint32_t*>(xs[c])[j] =
          *reinterpret_cast<const uint32_t*>(xb + (size_t)c * T + t0 - 6 + 2 * j);
    }
  } else {
    for (int i = threadIdx.x; i < AA_CB * AA_XW; i += AA_THREADS) {
      const int c = i / AA_XW, j = i - c * AA_XW;
      const int t = min(max(t0 - 6 + j, 0), T - 1);
      xs[c][j] = c < nch ? xb[(size_t)c * T + t] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  if (inner) {
    // two pairs a thread: u = t0 - 3 + q and u + 1 (q even) read
    // x[u - 3 .. u + 4] = xs[q .. q + 7]
    constexpr int QP = AA_QN / 2;
    for (int i = threadIdx.x; i < AA_CB * QP; i += AA_THREADS) {
      const int c = i / QP, q = 2 * (i - c * QP);
      float xv[8];
      const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(&xs[c][q]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 v = __bfloat1622float2(xr[m]);
        xv[2 * m] = v.x, xv[2 * m + 1] = v.y;
      }
      float w0[NU + 1], w1[NU + 1];
#pragma unroll
      for (int k = 0; k <= NU; ++k) w0[k] = xv[k], w1[k] = xv[k + 1];
      const float2 cf = coef[c];
      const float2 p0 = snake_pair(w0, tp, cf.x, cf.y), p1 = snake_pair(w1, tp, cf.x, cf.y);
      *reinterpret_cast<float2*>(&ze[c][q]) = make_float2(p0.x, p1.x);
      *reinterpret_cast<float2*>(&zo[c][q]) = make_float2(p0.y, p1.y);
    }
  } else {
    // one pair a thread, every index clamped; a position before 0 is z[0]
    // (the even phase at 0), one past 2T - 1 is z[2T - 1] (the odd phase at
    // T - 1)
    for (int i = threadIdx.x; i < AA_CB * AA_QN; i += AA_THREADS) {
      const int c = i / AA_QN, q = i - c * AA_QN;
      const int u = t0 - 3 + q, uc = min(max(u, 0), T - 1);
      const bf16* xr = &xs[c][uc - t0 + 3];
      float xv[NU + 1];
#pragma unroll
      for (int k = 0; k <= NU; ++k) xv[k] = __bfloat162float(xr[k]);
      const float2 cf = coef[c];
      float2 z = snake_pair(xv, tp, cf.x, cf.y);
      if (u < 0) z.y = z.x;
      if (u > T - 1) z.x = z.y;
      ze[c][q] = z.x;
      zo[c][q] = z.y;
    }
  }
  __syncthreads();
  if (OUT_CL) {
    // a warp: 32 row pairs of 8 channels; rows t and t + 1 as 16 bytes each
    for (int i = threadIdx.x; i < (AA_TT / 2) * (AA_CB / 8); i += AA_THREADS) {
      const int cg = i / (AA_TT / 2), r = 2 * (i - cg * (AA_TT / 2)), t = t0 + r;
      if (t >= T) continue;
      float v0[8], v1[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float2 v = down_pair(&zo[8 * cg + e][r], &ze[8 * cg + e][r], tp);
        v0[e] = v.x, v1[e] = v.y;
      }
      store8(y + ((size_t)b * T + t) * C + c0 + 8 * cg, v0);
      if (t + 1 < T) store8(y + ((size_t)b * T + t + 1) * C + c0 + 8 * cg, v1);
    }
  } else {
    for (int i = threadIdx.x; i < (AA_TT / 2) * nch; i += AA_THREADS) {
      const int c = i / (AA_TT / 2), r = 2 * (i - c * (AA_TT / 2)), t = t0 + r;
      if (t >= T) continue;
      const float2 v = down_pair(&zo[c][r], &ze[c][r], tp);
      bf16* yr = y + ((size_t)b * C + c0 + c) * T + t;
      yr[0] = __float2bfloat16(v.x);
      if (t + 1 < T) yr[1] = __float2bfloat16(v.y);
    }
  }
}

constexpr int CV_STAGES = 4;     // weight ring depth
constexpr int CV_MAX_BOXES = 3;  // box slots (fewer where there are fewer chunks)
constexpr int RS_BOXES = 2;      // box slots of the resident-weight form
constexpr int CV_THREADS = 288;  // two consumer warpgroups and the producer warp
constexpr int CV_BM = 128;       // time rows of a tile: 64 per consumer warpgroup
constexpr int CV_PIECE_MAX = 256; // rows of one TMA copy (a box dimension's limit)
constexpr int CV_LDS = CV_BM + 4;  // staging row stride (floats) of the epilogue

struct ConvArgs {
  const void* w;     // packed tiles (C / BN, chunks, k, BN, 64) bf16
  const float* bias; // (C)
  const bf16* res;   // (B, C, T) or null
  bf16* out;         // (B, C, T)
  int C, T, k, dil, reach, n_chunks, halves;
  int stage_bytes, box_rows, box_bytes, n_boxes;
  int pieces, piece_rows;        // a box: pieces TMA copies of piece_rows rows
  int box_off, st_off, bar_off;  // shared memory: boxes, epilogue staging, mbarriers
  int tiles_t, n_tiles;          // time tiles a batch element; tiles (resident form)
};

// One step of k16 pairs on fragment set `a`: the A fragments of this lane's
// box row (k16 steps 2 h, 2 h + 1), the products, and the wait that leaves
// only this group in flight.
template <int BN>
US_DEV void conv_step(float (&acc)[BN / 2], uint32_t (&a)[2][4], uint32_t row, uint32_t rx,
                      uint32_t hi, uint64_t desc, int h) {
  load_half(a, row, rx, hi, 2 * h);
  mma_half<BN>(acc, a, desc, 2 * h);
  wgmma_wait<1>();
}

// The epilogue of a tile: the f32 accumulator transposed into shared memory
// (st[n][r]), then per output channel runs of 8 samples: + bias (+ residual)
// in f32, one rounding, 16-byte stores into (B, C, T). The 256 consumer
// threads; `st` is free on entry.
template <int BN>
US_DEV void store_tile(const float (&acc)[BN / 2], float* st, const ConvArgs& p, int t0, int n0,
                       int b) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  {
    const int row0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st[col * CV_LDS + row0 + 8 * h] = acc[j * 4 + 2 * h];
        st[(col + 1) * CV_LDS + row0 + 8 * h] = acc[j * 4 + 2 * h + 1];
      }
    }
  }
  bar_sync_named(1, 256);
  const int T = p.T;
  const bool vec = (T & 7) == 0;
  for (int i = tid; i < BN * (CV_BM / 8); i += 256) {
    const int n = i >> 4, tg = i & 15, t = t0 + tg * 8;
    if (t >= T) continue;
    const float bv = __ldg(p.bias + n0 + n);
    const float4 a0 = *reinterpret_cast<const float4*>(st + n * CV_LDS + tg * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(st + n * CV_LDS + tg * 8 + 4);
    float v[8] = {a0.x + bv, a0.y + bv, a0.z + bv, a0.w + bv,
                  a1.x + bv, a1.y + bv, a1.z + bv, a1.w + bv};
    const size_t o = ((size_t)b * p.C + n0 + n) * T + t;
    if (vec) {
      if (p.res != nullptr) {
        float rv[8];
        load8(p.res + o, rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += rv[e];
      }
      store8(p.out + o, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (t + e >= T) break;
        float u = v[e];
        if (p.res != nullptr) u += __bfloat162float(p.res[o + e]);
        p.out[o + e] = __float2bfloat16(u);
      }
    }
  }
}

// The ring form: block (time tile, Cout tile, batch element);
// warps 0-7 consume (warpgroup g: tile rows 64 g .. 64 g + 63), warp 8
// streams the chunks' boxes and the weight stages.
template <int BN>
__global__ void __launch_bounds__(CV_THREADS, 1)
    aa_conv_kernel(const __grid_constant__ CUtensorMap ymap, ConvArgs p) {
  constexpr int S = CV_STAGES;
  uint8_t* ring = smem_base();
  uint8_t* box = ring + p.box_off;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(ring + p.bar_off);
  uint64_t* w_empty = w_full + S;
  uint64_t* x_full = w_empty + S;
  uint64_t* x_empty = x_full + CV_MAX_BOXES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * CV_BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  griddep_wait();  // y is aa_kernel's output
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&w_full[s], 1), mbar_init(&w_empty[s], 8);
    for (int s = 0; s < p.n_boxes; ++s) mbar_init(&x_full[s], 1), mbar_init(&x_empty[s], 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    const uint8_t* wsrc = static_cast<const uint8_t*>(p.w) +
                          (size_t)blockIdx.y * p.n_chunks * p.k * p.stage_bytes;
    produce_ring(&ymap, ring, box, w_full, w_empty, x_full, x_empty, S, p.k, p.stage_bytes,
                 p.stage_bytes, p.n_boxes, p.box_bytes, p.box_rows * 128, p.n_chunks, wsrc, 0,
                 t0 - p.reach, b, KC, p.pieces, p.piece_rows);
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  wgmma_fence_acc(acc);
  {
    uint32_t afr[2][2][4];  // two fragment sets, used in turn
    const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
    const uint32_t hi = lane >> 4;
    int ws = 0, xs = 0, pend = -1, par = 0;
    uint32_t wph = 0, xph = 0;
    for (int c = 0; c < p.n_chunks; ++c) {
      mbar_wait(&x_full[xs], xph);
      const uint32_t box_addr = smem_u32(box + xs * p.box_bytes);
      for (int j = 0; j < p.k; ++j) {
        const int R = r + j * p.dil;
        const uint32_t row = box_addr + R * 128, rx = R & 7;
        mbar_wait(&w_full[ws], wph);
        const uint64_t desc = wgmma_desc_sw128(ring + ws * p.stage_bytes);
        for (int h = 0; h < p.halves; ++h) {
          // the set about to be loaded was last read two groups back, which
          // the previous wait<1> has seen complete
          if (par == 0)
            conv_step<BN>(acc, afr[0], row, rx, hi, desc, h);
          else
            conv_step<BN>(acc, afr[1], row, rx, hi, desc, h);
          par ^= 1;
          // the previous tap's last group is done: its stage is free
          if (h == 0 && pend >= 0) release(&w_empty[pend]);
        }
        pend = ws;
        if (++ws == S) ws = 0, wph ^= 1;
      }
      release(&x_empty[xs]);
      if (++xs == p.n_boxes) xs = 0, xph ^= 1;
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
  }
  // the staging lies over the ring and the boxes, which every product has read
  bar_sync_named(1, 256);
  store_tile<BN>(acc, reinterpret_cast<float*>(ring + p.st_off), p, t0, n0, b);
}

// The resident form (C <= 64: one chunk, BN = C): every tap's weight tile
// stays in shared memory (11 x 8 KB at k = 11), and a persistent grid walks
// the (batch element, time tile) pairs, tile blockIdx.x + i gridDim.x; the
// producer warp keeps the next tile's box in flight while the consumers
// multiply and store the current one. Each tile's products and epilogue are
// the ring form's.
template <int BN>
__global__ void __launch_bounds__(CV_THREADS, 1)
    aa_conv_resident_kernel(const __grid_constant__ CUtensorMap ymap, ConvArgs p) {
  uint8_t* base = smem_base();
  uint8_t* box = base + p.box_off;
  float* st = reinterpret_cast<float*>(base + p.st_off);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(base + p.bar_off);
  uint64_t* x_full = w_full + 1;
  uint64_t* x_empty = x_full + RS_BOXES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  griddep_wait();  // y is aa_kernel's output
  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < RS_BOXES; ++s) mbar_init(&x_full[s], 1), mbar_init(&x_empty[s], 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      mbar_arrive_expect_tx(w_full, p.k * p.stage_bytes);
      for (int j = 0; j < p.k; ++j)
        bulk_g2s(base + j * p.stage_bytes, static_cast<const uint8_t*>(p.w) + j * p.stage_bytes,
                 p.stage_bytes, w_full);
    }
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int b = tile / p.tiles_t, t0 = (tile - b * p.tiles_t) * CV_BM;
      mbar_wait(&x_empty[s], ph ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&x_full[s], p.box_rows * 128);
        for (int i = 0; i < p.pieces; ++i)
          tma_load_4d(box + s * p.box_bytes + i * p.piece_rows * 128, &ymap, 0, 0,
                      t0 - p.reach + i * p.piece_rows, b, &x_full[s]);
      }
      __syncwarp();
      if (++s == RS_BOXES) s = 0, ph ^= 1;
    }
    return;
  }

  uint32_t afr[2][2][4];
  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
  const uint32_t hi = lane >> 4;
  int s = 0, par = 0;
  uint32_t ph = 0;
  mbar_wait(w_full, 0);
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int b = tile / p.tiles_t, t0 = (tile - b * p.tiles_t) * CV_BM;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    wgmma_fence_acc(acc);
    mbar_wait(&x_full[s], ph);
    const uint32_t box_addr = smem_u32(box + s * p.box_bytes);
    for (int j = 0; j < p.k; ++j) {
      const int R = r + j * p.dil;
      const uint32_t row = box_addr + R * 128, rx = R & 7;
      const uint64_t desc = wgmma_desc_sw128(base + j * p.stage_bytes);
      for (int h = 0; h < p.halves; ++h) {
        if (par == 0)
          conv_step<BN>(acc, afr[0], row, rx, hi, desc, h);
        else
          conv_step<BN>(acc, afr[1], row, rx, hi, desc, h);
        par ^= 1;
      }
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    release(&x_empty[s]);  // the producer may bring the tile after next
    if (++s == RS_BOXES) s = 0, ph ^= 1;
    bar_sync_named(1, 256);  // the previous tile's stores have read the staging
    store_tile<BN>(acc, st, p, t0, 0, b);
  }
}

// The launch plan of the conv. Returns false for widths the kernels do not
// take.
struct ConvPlan {
  ConvArgs a;
  dim3 grid;
  int smem;
  bool resident;
};

bool bn_ok(int BN, int C) { return (BN == 32 || BN == 64 || BN == 128) && C % BN == 0; }

using ConvKernel = void (*)(const CUtensorMap, ConvArgs);

ConvKernel conv_kernel(int BN, bool resident) {
  if (resident) return BN == 32 ? aa_conv_resident_kernel<32> : aa_conv_resident_kernel<64>;
  return BN == 32 ? aa_conv_kernel<32> : BN == 64 ? aa_conv_kernel<64> : aa_conv_kernel<128>;
}

// Blocks an SM holds of the kernel at this shared memory (0 on error),
// cached by (kernel, bytes); the first query of a kernel sets its
// shared-memory limit.
int plan_occupancy(int BN, bool resident, int smem) {
  static struct { ConvKernel k; int smem, per_sm; } cache[64];
  static int n_cached = 0;
  const ConvKernel kern = conv_kernel(BN, resident);
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].k == kern && cache[i].smem == smem) return cache[i].per_sm;
  int per_sm = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, CV_THREADS, smem) !=
          cudaSuccess)
    return 0;
  if (n_cached < 64) cache[n_cached++] = {kern, smem, per_sm};
  return per_sm;
}

bool make_conv_plan(int B, int C, int T, int k, int dil, int BN, ConvPlan* pl) {
  if (C % 32 != 0 || !bn_ok(BN, C) || k % 2 == 0 || dil < 1 || T < 1) return false;
  ConvArgs& a = pl->a;
  const int reach = (k - 1) / 2 * dil, rows = CV_BM + 2 * reach;
  a.C = C, a.T = T, a.k = k, a.dil = dil, a.reach = reach;
  a.n_chunks = us_ceil_div(C, KC);
  a.halves = C >= KC ? 2 : 1;  // C = 32: only the first two k16 steps hold channels
  a.stage_bytes = BN * 128;
  // pieces of whole swizzle atoms (8 rows), so each starts 1024-byte aligned
  a.pieces = us_ceil_div(rows, CV_PIECE_MAX);
  a.piece_rows = a.pieces == 1 ? rows : round_up(us_ceil_div(rows, a.pieces), 8);
  a.box_rows = a.pieces * a.piece_rows;
  a.box_bytes = round_up(a.box_rows * 128, 1024);
  a.tiles_t = us_ceil_div(T, CV_BM);
  a.n_tiles = a.tiles_t * B;
  const int staging = BN * CV_LDS * 4;
  pl->resident = false;
  if (C <= KC && BN == C) {
    a.n_boxes = RS_BOXES;
    a.box_off = k * a.stage_bytes;
    a.st_off = a.box_off + a.n_boxes * a.box_bytes;
    a.bar_off = a.st_off + staging;
    pl->smem = 1024 + a.bar_off + (1 + 2 * RS_BOXES) * 8;
    pl->resident = pl->smem <= SMEM_MAX;
  }
  if (!pl->resident) {
    a.n_boxes = a.n_chunks < CV_MAX_BOXES ? a.n_chunks : CV_MAX_BOXES;
    a.box_off = CV_STAGES * a.stage_bytes;
    const int data = a.box_off + a.n_boxes * a.box_bytes;
    a.st_off = 0;
    a.bar_off = data > staging ? data : staging;
    pl->smem = 1024 + a.bar_off + (2 * CV_STAGES + 2 * CV_MAX_BOXES) * 8;
    if (pl->smem > SMEM_MAX) return false;
  }
  const int per_sm = plan_occupancy(BN, pl->resident, pl->smem);
  if (per_sm < 1) return false;
  if (pl->resident) {
    const int slots = per_sm * n_sms();
    pl->grid = dim3(a.n_tiles < slots ? a.n_tiles : slots, 1, 1);
  } else {
    pl->grid = dim3(a.tiles_t, C / BN, B);
  }
  return true;
}

int launch_conv(const void* y, const ConvPlan& pl, int BN, int B, cudaStream_t st) {
  CUtensorMap map;
  int err = x_tensor_map(&map, y, B, pl.a.T, 1, pl.a.C, pl.a.piece_rows, 1);
  if (err != 0) return err;
  return launch_pdl(conv_kernel(BN, pl.resident), pl.grid, dim3(CV_THREADS), pl.smem, st, map,
                    pl.a);
}

// The activation pass of (B, C, T) x.
template <bool OUT_CL>
int launch_aa(const void* x, const float* alpha, const float* ib, const Taps& tp, void* y, int B,
              int C, int T, cudaStream_t st) {
  dim3 grid(us_ceil_div(T, AA_TT), us_ceil_div(C, AA_CB), B);
  aa_kernel<OUT_CL><<<grid, AA_THREADS, 0, st>>>(static_cast<const bf16*>(x), alpha, ib, tp,
                                                 static_cast<bf16*>(y), C, T);
  return (int)cudaGetLastError();
}

Taps taps_of(const float* host) {
  Taps t;
  for (int i = 0; i < NU; ++i) t.f0[i] = host[i], t.f1[i] = host[NU + i];
  for (int i = 0; i < ND; ++i) t.g[i] = host[2 * NU + i];
  return t;
}

}  // namespace

extern "C" {

// The offsets the kernels are written for; ops/aa_snake.py checks them
// against the filters it derives.
int us_aa_offsets(int which) { return which == 0 ? UP_OFF0 : which == 1 ? UP_OFF1 : DN_OFF; }

// x, out: (B, C, T) bf16; alpha, ib: (C,) f32 snake coefficients (alpha
// already exponentiated where log-scale; ib = 1 / (beta + 1e-9)); taps:
// host (24,) f32 = f0 | f1 | g.
int us_aa_snake(const void* x, const float* alpha, const float* ib, const float* taps, void* out,
                int B, int C, int T, void* stream) {
  return launch_aa<false>(x, alpha, ib, taps_of(taps), out, B, C, T,
                                             static_cast<cudaStream_t>(stream));
}

// The conv's plan at these widths: {box rows, box bytes, box slots, blocks,
// threads, dynamic shared memory, blocks an SM holds, resident form, TMA
// copies a box}.
int us_aa_conv_plan(int B, int C, int T, int k, int dil, int BN, int* info) {
  ConvPlan pl;
  if (!make_conv_plan(B, C, T, k, dil, BN, &pl)) return (int)cudaErrorInvalidValue;
  const int per_sm = plan_occupancy(BN, pl.resident, pl.smem);
  const int v[9] = {pl.a.box_rows, pl.a.box_bytes, pl.a.n_boxes,
                    (int)(pl.grid.x * pl.grid.y * pl.grid.z), CV_THREADS, pl.smem, per_sm,
                    (int)pl.resident, pl.a.pieces};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return 0;
}

// K5: aa_kernel writes y = AA(x) (B, T, C) bf16 into the scratch y, then
// the conv: w the tiles ops/aa_snake.py pack_conv_weight made with Cout
// tiles of BN, bias (C,) f32, res (B, C, T) bf16 or NULL, out (B, C, T).
// C % 32 == 0, BN 32, 64 or 128 dividing C; odd k; a box of 128 + (k-1) d
// rows that fits shared memory beside the weights (ops/aa_snake.py takes).
int us_aa_snake_conv(const void* x, const float* alpha, const float* ib, const float* taps,
                     void* y, const void* w, int BN, const float* bias, const void* res,
                     void* out, int B, int C, int T, int k, int dil, void* stream) {
  ConvPlan pl;
  if (!make_conv_plan(B, C, T, k, dil, BN, &pl)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  int err = launch_aa<true>(x, alpha, ib, taps_of(taps), y, B, C, T, st);
  if (err != 0) return err;
  pl.a.w = w;
  pl.a.bias = bias;
  pl.a.res = static_cast<const bf16*>(res);
  pl.a.out = static_cast<bf16*>(out);
  return launch_conv(y, pl, BN, B, st);
}

}  // extern "C"
