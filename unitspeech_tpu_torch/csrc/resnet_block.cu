// U-Net ResnetBlock and final block (kernels K1, K2 and K8), and the main
// loop of K9's and K10b's int8 convs (us_resnet_conv3x3_i8;
// csrc/resnet_deep_i8.cu).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resnet.py:
// fused_resnet_block (_fused_resnet: _kernel_a, _kernel_b, _kernel_c),
// fused_final_block (_fused_final: _kernel_a, _kernel_d) and
// fused_resnet_block_deep (_fused_resnet_deep: _kernel_a_deep,
// _kernel_b_deep, _kernel_c): us_resnet_block at the deep stages. Kernel A
// (us_resnet_conv3x3) and kernel C (us_resnet_out; us_resnet_out_none for
// JAX's res_mode "none") also run alone, as tools/bisect_deep_compile.py
// probes them.
//
// Layout: rows n = t*F + f of one batch element, channels last, bf16.
// conv3x3 is an implicit GEMM: M = rows, N = Cout, K = 9*Cin (tap order
// (dt, df) row-major). A +-1 shift that leaves the (T, F) grid reads zero,
// so no tap wraps into the neighbouring frame.
//
// Numbers (JAX's): bf16 products, an f32 accumulator plus the f32 bias,
// one rounding to bf16; GroupNorm statistics from the f32 values over every
// row of the padded bucket, rows at/after the length included
// (pallas_resnet.py:28-32), reduced in a fixed order (deterministic); input
// rows at/after the length read as zero.
//
// One block is five launches: kernel A (conv1 + bias -> c1 and per-tile
// column sums and sums of squares), gn_film (GroupNorm-1 statistics, then
// h = bf16(mish(GN1(c1) * scale + shift) + FiLM) * valid once per element,
// in place of c1), kernel B (kernel A on h), gn_finalize (GroupNorm-2
// statistics) and kernel C (mish(GN2(c2)) * valid plus the residual: the
// 1x1 conv on the same main loop with one tap, or x itself elementwise).
// JAX rounds h to bf16 once (_kernel_b); the transform used to run in kernel
// B's loader for each of the 9 taps and again for every Cout tile of the
// grid (144 mish evaluations per element at 1024 -> 1024): gn_film gives
// the same bf16 value once. Each gn_film block reduces its group's tile
// statistics itself, in gn_finalize's order, so the launch count stays.
// (Kernel B transforming each box in shared memory once it lands gave the
// same bits and was slower at every stage: PERF.md.)
//
// What bounds the convs on the H100: at 3 rows of the 344-frame bucket each
// is 1.6-24 GFLOP (1.6-25 us at 989 TFLOP/s) against 2-19 MB of weights and
// activations (0.6-6 us at 3.35 TB/s): the tensor cores. The main loop
// (conv_tc) is Hopper's: a block owns a 2-D row tile of TT frames x TF
// frequencies (at most 128 rows, conv_plan) and BN = 128 (or 64) output
// columns; two consumer warpgroups of 64 rows each run wgmma m64nBNk16 with
// A from registers, one producer warp feeds them (csrc/hopper.cuh):
//   * per 64-channel chunk one 4-D TMA copy brings the (TT+2) x (TF+2) box
//     the tile's 9 taps reach, in the 128-byte swizzle; its zero fill does
//     frames and frequencies -1, T, F and channels past Cin; rows at/after
//     the length go to a zero row through the ldmatrix address. Shifted rows
//     of a padded box form no canonical wgmma layout, so A comes from
//     registers (the ldmatrix fragment is wgmma's A fragment). Three box
//     slots let each box go out a whole chunk ahead of its use (two slots,
//     the box issued just ahead of its chunk's stages: 11% slower);
//   * B comes from a ring of 4 weight stages (one BN x 64 tile per tap and
//     chunk, packed once at load by ops/fused_resnet.py pack_conv_weight,
//     K-major in the same swizzle) kept full by bulk copies under full/empty
//     mbarriers; both warpgroups read each stage, so it crosses from L2
//     once per 128 rows (6 or 8 stages: no faster);
//   * the epilogue adds the bias, stages the f32 tile in shared memory,
//     writes whole 16-byte row pieces (one rounding) and the tile's column
//     sums and sums of squares (kernel C: GN2-apply + mish + mask of c2 plus
//     the residual, rounded once).
// The tile (conv_plan; chip_smoke.py prints it per site): TF divides F,
// TT = min(128 / TF, T), the fewest tiles first, then the smallest box: at
// F = 80 8 x 16 (a box of 10 x 18 rows), F = 40 16 x 8, F = 20 6 x 20 (8 x
// 22), F = 10 12 x 10 (14 x 12). The 1x1 residual takes rows 128 at a time
// (F = 1, no halo). One block an SM (288 threads; 130 registers a thread at
// BN = 128, no spills): at F = 10 and 430 rows a batch element a 1024-wide
// conv gives 4 x 8 x 3 = 96 blocks on 132 SMs, each re-reading its 2.4 MB
// of weight tiles from L2. Where 128-column tiles would leave more than half
// the SMs idle (the F = 10 convs to 512 channels: 48 blocks) the launch
// takes 64 columns of the 128-column packing (96 blocks; a stage is a slice
// of the packed one, as the swizzle repeats every 8 rows). Measured and
// dropped (PERF.md): 64-column tiles elsewhere, four k16 steps a commit
// group, a persistent grid, and at F = 10 clusters of 2 blocks that share
// each weight stage by multicast (half the L2 weight reads; 2.0-2.5x
// slower).
//
// The final block (K2) is two launches, as JAX's: kernel A as K1 runs it
// (conv + bias -> c1 and per-tile column sums), then final_tail, a
// programmatic dependent launch of one block an SM that sums the tile sums
// itself (in a fixed order), folds the group statistics in its prologue
// (as _kernel_d does), stages the per-channel affine and w_out, and reads
// c1 (21 MB at the served shape, just written, so mostly from the 50 MB
// L2) in 16-byte loads. No gn_finalize launch; kernel A is K1's own, so
// K1, K8 and K9 run the code they ran. (A completion ticket in kernel A's
// epilogue, its last block of each batch element reducing the tiles, cost
// kernel A 11-15 us at the served shape: PERF.md.)
//
// Cin % 8 != 0 (the estimator's first block, Cin = 2: rows of 4 bytes
// cannot be a TMA tensor) keeps the element-load implicit GEMM on mma.sync
// (conv_gemm, common.cuh igemm_bf16, 128 x 64 tiles of whole rows) for
// conv1 and its 1x1 residual, with the raw (taps*Cin, Cout) bf16 weights.
// Its GEMM is 0.4 GFLOP a call.
//
// On a frame slice of the seq axis (ops/fused_resnet.py, the sharded
// chain) kernels A and B read a halo'd input (us_resnet_conv3x3_halo): T + 2
// frames a batch element, the neighbours' edge frames around the slice's T
// (zeros at the global ends, masked by the sender). The tile plan is the
// interior T's, the box starts one frame later (the halo frame stands
// where the zero fill was), `lens` masks the interior rows only, and the
// epilogue writes and sums the T interior frames: the statistics count
// each global frame once. gn_film and the final tail take the global row
// count (n_rows) of the tile sums the host gathered from every rank.
//
// K10a's int8 convs (us_resnet_conv3x3_i8_tiles; csrc/resnet_block_i8.cu)
// run conv_tc with I8 in its tiled-input mode: the input is a per-TPU-tile
// quantized copy (B, n_tiles, fpt + 2, F, Cp) int8 that holds each tile's
// fpt frames and its two halo frames, so a row tile's box starts at copy
// frame to0 (the halo is in the copy), row tiles never cross a TPU tile
// (the tile is picked for fpt frames, TT <= fpt) and the epilogue
// dequantizes with the tile's own scale.
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

// --- element loads on mma.sync (Cin % 8 != 0) --------------------------------

constexpr int EL_BM = IG_BM, EL_BN = IG_BN, EL_BK = IG_BK;

struct ConvArgs {
  const bf16* x;       // (B, N, Cin)
  const bf16* w;       // (taps*Cin, Cout)
  const float* bias;   // (Cout)
  const int* lens;     // (B) valid rows; input rows at/after it read zero
  // kernel C epilogue: out = mish(GN(c2))*valid + (acc + bias)*valid
  const bf16* c2;         // (B, N, Cout)
  const float* o_mean;    // (B, Cout)
  const float* o_inv;
  const float* o_scale;   // (Cout)
  const float* o_shift;
  bf16* out;    // (B, N, Cout)
  float* part;  // (B, n_mtiles, 2, Cout)
  int N, F, Cin, Cout;
  int hin;      // 1: x holds a halo frame on each side ((N / F + 2) * F rows)
};

// The input row that output row m's tap reads, or -1 for a zero: outside
// the (T, F) grid (the halo frames -1 and T count as inside with hin) or an
// interior row at/after the length.
template <int TAPS>
__device__ __forceinline__ int source_row(int m, int tap, int T, int F, int len, int hin) {
  if (TAPS == 1) return m < len ? m : -1;
  int dt = tap / 3 - 1, df = tap % 3 - 1;
  int t = m / F, f = m - t * F;
  int tt = t + dt, ff = f + df;
  if (tt < -hin || tt >= T + hin || ff < 0 || ff >= F) return -1;
  if (tt >= 0 && tt < T && tt * F + ff >= len) return -1;
  return (tt + hin) * F + ff;
}

// TAPS: 9 (conv3x3) or 1 (1x1 residual). EPI: 0 writes bias-added output +
// tile statistics (kernel A); 1 writes the ResnetBlock output with the 1x1
// residual (kernel C). VEC: Cin % 8 == 0, 16-byte loads; otherwise element
// loads (Cin = 2).
template <int TAPS, int EPI, bool VEC>
__global__ void __launch_bounds__(IG_THREADS) conv_gemm(ConvArgs p) {
  __shared__ IgemmTiles tiles;
  __shared__ float red[4][2][EL_BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int mt = blockIdx.x, n0 = blockIdx.y * EL_BN, b = blockIdx.z;
  const int m0 = mt * EL_BM;
  const int N = p.N, F = p.F, Cin = p.Cin, Cout = p.Cout;
  const int T = N / F;
  const int len = p.lens[b];
  const int K = TAPS * Cin;
  const int nk = (K + EL_BK - 1) / EL_BK;
  const bf16* xb = p.x + (size_t)b * (N + 2 * F * p.hin) * Cin;

  auto load_a = [&](int kb, uint4 (&reg)[2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * IG_THREADS;
      int m = m0 + (v >> 2);
      int k = kb * EL_BK + (v & 3) * 8;
      reg[s] = make_uint4(0, 0, 0, 0);
      if (m >= N) continue;
      if (VEC) {
        if (k >= K) continue;
        int tap = k / Cin, ci = k - tap * Cin;
        int src = source_row<TAPS>(m, tap, T, F, len, p.hin);
        if (src < 0) continue;
        reg[s] = *reinterpret_cast<const uint4*>(xb + (size_t)src * Cin + ci);
      } else {
        bf16* r = reinterpret_cast<bf16*>(&reg[s]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int ke = k + e;
          if (ke >= K) break;
          int tap = ke / Cin, ci = ke - tap * Cin;
          int src = source_row<TAPS>(m, tap, T, F, len, p.hin);
          if (src < 0) continue;
          r[e] = xb[(size_t)src * Cin + ci];
        }
      }
    }
  };

  auto load_b = [&](int kb) -> uint4 {
    int k = kb * EL_BK + (tid >> 3);
    if (k >= K) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(p.w + (size_t)k * Cout + n0 + (tid & 7) * 8);
  };

  float acc[2][4][4];
  igemm_bf16(acc, tiles, nk, load_a, load_b);

  if (EPI == 0) {
    auto value = [&](float a, int, int n) -> float { return a + p.bias[n]; };
    store_tile_stats(acc, value, p.out, p.part, red, N, Cout, m0, n0, b);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int m = m0 + wm * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
          int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (m >= N) continue;
          float valid = m < len ? 1.f : 0.f;
          size_t o = ((size_t)b * N + m) * Cout + n;
          float h = (__bfloat162float(p.c2[o]) - p.o_mean[b * Cout + n]) * p.o_inv[b * Cout + n];
          h = mish_f32(h * p.o_scale[n] + p.o_shift[n]) * valid;
          float r = (acc[i][j][e] + p.bias[n]) * valid;
          p.out[o] = __float2bfloat16(h + r);
        }
  }
}

// --- the Hopper main loop (Cin % 8 == 0) ------------------------------------

// Kernel B's input, one element, as JAX's _kernel_b computes it before its
// one rounding: mish((c1 - mean) * inv * scale + shift) + film, mish with
// one exp (mish_f32), every operation rounded on its own so that no
// contraction into fused multiply-adds depends on where it is inlined.
US_DEV float gn_mish_film(float v, float mu, float iv, float scale, float shift, float film) {
  const float h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), iv), scale), shift);
  const float u = __fadd_rn(1.0f, expf(fminf(h, 30.0f)));
  const float t = __fmul_rn(u, u);
  const float m = h > 20.0f ? h : __fmul_rn(h, __fdiv_rn(__fsub_rn(t, 1.0f), __fadd_rn(t, 1.0f)));
  return __fadd_rn(m, film);
}


constexpr int TC_STAGES = 4;    // weight ring depth
constexpr int TC_BOXES = 3;     // box slots: each box goes out a chunk ahead
constexpr int TC_THREADS = 288; // two consumer warpgroups and the producer warp
constexpr int TC_BM = 128;      // rows of a tile: 64 per consumer warpgroup

struct TcArgs {
  const void* w;        // packed tiles (Cout / BN, chunks, TAPS, BN, 128 bytes)
  const float* bias;    // (Cout)
  // int8 (K9): the dequantize scale (1 / sx[b]) * rsw[n], sx (B), rsw (Cout)
  const float *sx, *rsw;
  const int* lens;      // (B) valid rows; input rows at/after it read zero
  bf16* out;            // (B, N, Cout)
  float* part;          // EPI 0: (B, n_tiles, 2, Cout)
  // EPI 1 (kernel C): out = mish(GN(c2)) * valid + (acc + bias) * valid
  const bf16* c2;       // (B, N, Cout)
  const float *o_mean, *o_inv;    // (B, Cout)
  const float *o_scale, *o_shift; // (Cout)
  int T, F, Cin, Cout;            // the (T, F) grid of rows, N = T * F
  int tt, tf, tiles_f, n_tiles;   // the row tile: TT frames x TF frequencies
  // tiled input (K10a): 0, or the TPU tile's frames; the row tiles of a TPU
  // tile (sub of them, each TT <= fpt frames) read its copy (fpt + 2 frames)
  int fpt, sub;
  int n_chunks, stage_bytes, box_bytes, data_bytes;
  // the packed weights: Cout tiles of `split` x BN columns, w_tile bytes
  // apart, their stages w_stride bytes apart (a BN-column stage is a slice
  // of the packed one: the swizzle repeats every 8 rows)
  int split, w_tile, w_stride;
  // 1: a halo'd input, T + 2 frames (the box starts one frame later; the
  // halo frames are read as they are, lens masks the interior rows)
  int hin;
};

US_DEV float acc_f32(float v) { return v; }
US_DEV float acc_f32(int v) { return __int2float_rn(v); }

// The conv over one tile: TAPS 9 (conv3x3, the box has a one-row halo) or
// 1 (the 1x1 residual); BN output columns (64 or 128); EPI 0 (kernels A
// and B: bias, one rounding, tile statistics) or 1 (kernel C); I8: int8
// input and weights (K9's convs: chunks of 128 channels, one 128-byte row
// as bf16's 64, s8 wgmma into s32, exact; the epilogue dequantizes as JAX,
// f32(acc) * ((1 / sx) * rsw) + bias, each operation rounded). Block (row
// tile, Cout tile, batch); warps 0-7 consume (warpgroup g: tile rows
// 64 g .. 64 g + 63), warp 8 loads. Tile row r = (tt, ff) = (r / TF, r % TF)
// is grid row (to0 + tt, fo0 + ff) when tt < TT and to0 + tt < T; its tap
// (dt, df) reads box row (tt + dt) * BF + ff + df, BF = TF + 2. Tiled input
// (p.fpt > 0, I8): block x's row tile is sub-tile s of TPU tile j; its rows
// are frames j fpt + to0 + tt < (j + 1) fpt, and its box comes from tile j's
// copy from copy frame to0 on (the copy's frame 0 is the halo frame above),
// which holds zeros wherever the TPU's window does; the dequantize takes
// sx[b, j].
template <int TAPS, int BN, int EPI, bool I8 = false>
__global__ void __launch_bounds__(TC_THREADS, 1)
    conv_tc(const __grid_constant__ CUtensorMap xmap, TcArgs p) {
  using Acc = typename std::conditional<I8, int, float>::type;
  constexpr int S = TC_STAGES;
  constexpr int HALO = TAPS == 9 ? 1 : 0;
  uint8_t* ring = smem_base();
  uint8_t* box = ring + S * p.stage_bytes;
  uint8_t* zero = ring + p.data_bytes;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(zero + 128);
  uint64_t* w_empty = w_full + S;
  uint64_t* x_full = w_empty + S;
  uint64_t* x_empty = x_full + TC_BOXES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = p.T, F = p.F, Cout = p.Cout, N = T * F;
  const int TT = p.tt, TF = p.tf, BF = TF + 2 * HALO;
  const int b = blockIdx.z, n0 = blockIdx.y * BN;
  const int tile_t = blockIdx.x / p.tiles_f, tile_f = blockIdx.x - tile_t * p.tiles_f;
  const bool tiled = I8 && p.fpt > 0;
  const int tj = tiled ? tile_t / p.sub : 0;  // the TPU tile (tiled input)
  const int to0 = (tiled ? tile_t - tj * p.sub : tile_t) * TT, fo0 = tile_f * TF;
  const int t_end = tiled ? p.fpt : T;        // the frames of the row tile's grid
  const int frame0 = tj * p.fpt;              // its first frame (tiled input)
  // K9's and K10a's chains launch it with launch_pdl (otherwise both are no-ops)
  griddep_wait();
  griddep_launch();
  const int len = tiled ? 0 : p.lens[b];  // a tiled input's copy is masked
  if (tid < 8) reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&w_full[s], 1), mbar_init(&w_empty[s], 8);
    for (int s = 0; s < TC_BOXES; ++s) mbar_init(&x_full[s], 1), mbar_init(&x_empty[s], 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    const uint8_t* wsrc = static_cast<const uint8_t*>(p.w) +
                          (size_t)(blockIdx.y / p.split) * p.w_tile +
                          (blockIdx.y % p.split) * BN * 128;
    produce_ring(&xmap, ring, box, w_full, w_empty, x_full, x_empty, S, TAPS, p.stage_bytes,
                 p.w_stride, TC_BOXES, p.box_bytes, (TT + 2 * HALO) * BF * 128, p.n_chunks,
                 wsrc, fo0 - HALO, tiled ? to0 : to0 - HALO + p.hin,
                 tiled ? b * (T / p.fpt) + tj : b, I8 ? 128 : KC);
    return;
  }

  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  wgmma_fence_acc(acc);
  uint32_t afr[2][2][4];  // two sets of two k16 steps' fragments
  {
    // this lane's ldmatrix row: which taps have input, and its box row
    const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
    const int tt = r / TF, ff = r - tt * TF;
    const bool row_ok = tt < TT && to0 + tt < t_end;
    uint32_t okm = 0;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int ti = to0 + tt + tap / 3 - HALO, fi = fo0 + ff + tap % 3 - HALO;
      // the copy of a tiled input holds its frames' zeros itself; a halo'd
      // input its halo frames (masked by the sender)
      const bool ok = row_ok && (unsigned)fi < (unsigned)F &&
                      (tiled || ((unsigned)(ti + p.hin) < (unsigned)(T + 2 * p.hin) &&
                                 (ti < 0 || ti >= T || ti * F + fi < len)));
      okm |= (uint32_t)ok << tap;
    }
    const int R0 = tt * BF + ff;
    const uint32_t hi = lane >> 4, zero_addr = smem_u32(zero);
    int ws = 0, xs = 0, pend = -1;
    uint32_t wph = 0, xph = 0;
    for (int c = 0; c < p.n_chunks; ++c) {
      mbar_wait(&x_full[xs], xph);
      const uint32_t box_addr = smem_u32(box + xs * p.box_bytes);
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const int R = R0 + (tap / 3) * BF + tap % 3;
        const bool ok = (okm >> tap) & 1;
        const uint32_t row = ok ? box_addr + R * 128 : zero_addr, rx = ok ? R & 7 : 0;
        // each half's fragment set was last read two groups back, which
        // the previous wait<1> has seen complete
        load_half(afr[0], row, rx, hi, 0);
        mbar_wait(&w_full[ws], wph);
        const uint64_t desc = wgmma_desc_sw128(ring + ws * p.stage_bytes);
        mma_half<BN>(acc, afr[0], desc, 0);
        wgmma_wait<1>();  // the previous tap's last group is done: its stage is free
        if (pend >= 0) release(&w_empty[pend]);
        load_half(afr[1], row, rx, hi, 2);
        mma_half<BN>(acc, afr[1], desc, 2);
        wgmma_wait<1>();
        pend = ws;
        if (++ws == S) ws = 0, wph ^= 1;
      }
      release(&x_empty[xs]);
      if (++xs == TC_BOXES) xs = 0, xph ^= 1;
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
  }

  // epilogue: the f32 tile in shared memory (over the ring and the boxes,
  // which every product has read), then whole 16-byte row pieces
  constexpr int LDS = BN + 4;                  // staging row stride (floats)
  constexpr int CPR = BN / 8, RG = 256 / CPR;  // 8-column pieces a row; row groups
  float* st = reinterpret_cast<float*>(ring);
  bar_sync_named(1, 256);
  {
    const int wl = warp & 3, row0 = (warp >> 2) * 64 + wl * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(st + (row0 + 8 * h) * LDS + col) =
            make_float2(acc_f32(acc[j * 4 + 2 * h]), acc_f32(acc[j * 4 + 2 * h + 1]));
    }
  }
  bar_sync_named(1, 256);
  const int ch = tid % CPR, rg = tid / CPR, n = n0 + ch * 8;
  float bias8[8], s8[8], q8[8], mean8[8], inv8[8], sc8[8], sh8[8], swe8[8];
  const float rsx = I8 ? 1.f / p.sx[tiled ? b * (T / p.fpt) + tj : b] : 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bias8[e] = __ldg(p.bias + n + e);
    if (I8) swe8[e] = __fmul_rn(rsx, __ldg(p.rsw + n + e));
    s8[e] = q8[e] = 0.f;
    if (EPI == 1) {
      mean8[e] = __ldg(p.o_mean + b * Cout + n + e);
      inv8[e] = __ldg(p.o_inv + b * Cout + n + e);
      sc8[e] = __ldg(p.o_scale + n + e);
      sh8[e] = __ldg(p.o_shift + n + e);
    }
  }
  for (int rr = rg; rr < TC_BM; rr += RG) {
    const int tt = rr / TF, ff = rr - tt * TF, to = to0 + tt;
    if (tt >= TT || to >= t_end) continue;
    const int m = (frame0 + to) * F + fo0 + ff;
    const float4 a0 = *reinterpret_cast<const float4*>(st + rr * LDS + ch * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(st + rr * LDS + ch * 8 + 4);
    float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const size_t o = ((size_t)b * N + m) * Cout + n;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = I8 ? __fadd_rn(__fmul_rn(v[e], swe8[e]), bias8[e])
                                          : v[e] + bias8[e];
    if (EPI == 0) {
      store8(p.out + o, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s8[e] += v[e], q8[e] += v[e] * v[e];
    } else {
      const float valid = m < len ? 1.f : 0.f;
      float cv[8];
      load8(p.c2 + o, cv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float h = (cv[e] - mean8[e]) * inv8[e];
        h = mish_f32(h * sc8[e] + sh8[e]) * valid;
        v[e] = h + v[e] * valid;
      }
      store8(p.out + o, v);
    }
  }
  if (EPI == 0) {
    // the tile's column sums: row groups summed in order (deterministic)
    float* red = st + TC_BM * LDS;  // [2][RG][BN]
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[rg * BN + ch * 8 + e] = s8[e];
      red[(RG + rg) * BN + ch * 8 + e] = q8[e];
    }
    bar_sync_named(1, 256);
    if (tid < 2 * BN) {
      const int k = tid / BN, cc = tid % BN;
      float s = 0.f;
      for (int g = 0; g < RG; ++g) s += red[(k * RG + g) * BN + cc];
      p.part[(((size_t)b * p.n_tiles + blockIdx.x) * 2 + k) * Cout + n0 + cc] = s;
    }
  }
}

// --- GroupNorm ----------------------------------------------------------------

// The GroupNorm mean and inverse std of group g of batch element b from the
// per-tile column sums (part (B, n_tiles, 2, C)), reduced in a fixed order
// by a block of 256 threads; every thread gets both.
US_DEV void group_mean_inv(const float* part, int n_tiles, int C, int cg, int g, int b,
                           int n_rows, float eps, float* scratch, float& mu, float& iv) {
  float s = 0.f, ss = 0.f;
  for (int idx = threadIdx.x; idx < n_tiles * cg; idx += blockDim.x) {
    int j = idx / cg, c = g * cg + idx % cg;
    const float* pt = part + ((size_t)b * n_tiles + j) * 2 * C;
    s += pt[c];
    ss += pt[C + c];
  }
  s = block_sum(s, scratch);
  ss = block_sum(ss, scratch);
  float m = (float)n_rows * (float)cg;
  mu = s / m;
  iv = 1.0f / sqrtf(ss / m - mu * mu + eps);
}

// Write the per-channel GroupNorm mean and inverse std. Grid (groups, B).
__global__ void __launch_bounds__(256) gn_finalize(const float* part, int n_tiles, int C,
                                                   int groups, int n_rows, float eps,
                                                   float* mean, float* inv) {
  __shared__ float scratch[256];
  griddep_wait();  // no-ops unless launched with launch_pdl (K9's chain)
  griddep_launch();
  const int g = blockIdx.x, b = blockIdx.y, cg = C / groups;
  float mu, iv;
  group_mean_inv(part, n_tiles, C, cg, g, b, n_rows, eps, scratch, mu, iv);
  for (int c = threadIdx.x; c < cg; c += blockDim.x) {
    mean[b * C + g * cg + c] = mu;
    inv[b * C + g * cg + c] = iv;
  }
}

// gn_finalize for GroupNorm 1 fused with kernel B's input transform, once
// per element: c1 (B, N, C) becomes h = bf16(gn_mish_film(c1)) on rows <
// lens[b] and 0 after, in place; the statistics are over n_rows rows (N,
// or a frame slice's global rows). Grid (row chunks of `rows`, groups, B);
// each block reduces its group's statistics itself (the same values, the
// same order), chunk 0 writes mean / inv. (C / groups) % 8 == 0.
__global__ void __launch_bounds__(256) gn_film(const float* part, int n_tiles, bf16* c1h,
                                               const int* lens, const float* scale,
                                               const float* shift, const bf16* film, int groups,
                                               float eps, float* mean, float* inv, int N, int C,
                                               int rows, int n_rows) {
  __shared__ float scratch[256];
  const int g = blockIdx.y, b = blockIdx.z, cg = C / groups, c_lo = g * cg;
  float mu, iv;
  group_mean_inv(part, n_tiles, C, cg, g, b, n_rows, eps, scratch, mu, iv);
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < cg; c += blockDim.x) {
      mean[b * C + c_lo + c] = mu;
      inv[b * C + c_lo + c] = iv;
    }
  const int len = lens[b], pieces = cg / 8;
  const int r0 = blockIdx.x * rows, nr = min(N - r0, rows);
  for (int idx = threadIdx.x; idx < nr * pieces; idx += blockDim.x) {
    const int m = r0 + idx / pieces, c0 = c_lo + (idx % pieces) * 8;
    bf16* ptr = c1h + ((size_t)b * N + m) * C + c0;
    float v[8];
    if (m < len) {
      load8(ptr, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = gn_mish_film(v[e], mu, iv, scale[c0 + e], shift[c0 + e],
                            __bfloat162float(film[b * C + c0 + e]));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    store8(ptr, v);
  }
}

// Kernel C without the 1x1 conv: mish(GN(c2))*valid + x*valid in bf16
// (RES, the identity residual), or mish(GN(c2))*valid alone in f32 (JAX's
// res_mode "none", which leaves the residual to the caller).
template <bool RES, typename TOut>
__global__ void __launch_bounds__(256) resnet_out_elementwise(
    const bf16* c2, const bf16* x, const float* mean, const float* inv,
    const float* scale, const float* shift, const int* lens, TOut* out, int B,
    int N, int C) {
  griddep_wait();  // a no-op unless launched with launch_pdl (K9's chain)
  size_t nvec = (size_t)B * N * C / 8;
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * blockDim.x) {
    size_t e0 = v * 8;
    int c0 = (int)(e0 % C);
    size_t row = e0 / C;
    int b = (int)(row / N), m = (int)(row % N);
    float valid = m < lens[b] ? 1.f : 0.f;
    float cv[8], xv[8], o[8];
    load8(c2 + e0, cv);
    if (RES) load8(x + e0, xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int c = c0 + e;
      float h = (cv[e] - mean[b * C + c]) * inv[b * C + c];
      h = mish_f32(h * scale[c] + shift[c]) * valid;
      o[e] = RES ? h + xv[e] * valid : h;
    }
    if constexpr (RES) {
      store8(out + e0, o);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e0 + e] = o[e];
    }
  }
}

int elementwise_blocks(int B, int N, int C) {
  size_t blocks = ((size_t)B * N * C / 8 + 255) / 256;
  return (int)(blocks > 65535 ? 65535 : blocks);
}

// --- the final block's tail (K2) ------------------------------------------

// mish with JAX's one exp (_mish_f32 takes fast_exp), without a branch: the
// exp and the reciprocal as the SFU's approximations (flush to zero), both
// run for every x (volatile), so that the select for x > 20 stays a select
// and the elements of a thread interleave (with `x > 20 ? x : ...` over
// expf and a divide, the compiler put a branch around every element's
// chain). e^min(x, 20): the factor is 1.0 in f32 from x = 20 on.
US_DEV float mish_fast(float x) {
  float e, r;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fminf(x, 20.0f) * 1.44269504f));
  const float u = 1.0f + e, t = u * u;
  asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t + 1.0f));
  return x > 20.0f ? x : x * ((t - 1.0f) * r);
}

constexpr int TAIL_THREADS = 1024;  // one block an SM
constexpr int TAIL_ROWS = 2;        // rows of a team in flight a round

// One batch element's tile sums, part (n_tiles, 2, C), summed into sum
// (2C) by the block: each (4-column piece, slice of consecutive tiles) in
// tile order, 8 loads a round in flight (a ragged round adds zeros), then
// the S = max(1, threads / (C / 2)) slices in order; red holds S * 2C
// floats. The order depends on n_tiles, C and the block's threads alone.
US_DEV void sum_tiles(const float* part, int n_tiles, int C, float* sum, float* red) {
  const int tid = threadIdx.x, threads = blockDim.x, P = C / 2;
  const int S = max(1, threads / P), per = (n_tiles + S - 1) / S;
  const float4* src = reinterpret_cast<const float4*>(part);
  float4* acc = reinterpret_cast<float4*>(red);
  for (int i = tid; i < S * P; i += threads) {
    const int pc = i % P, sl = i / P;
    const int j1 = min(n_tiles, (sl + 1) * per);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = sl * per; j < j1; j += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = j + u < j1 ? src[(size_t)(j + u) * P + pc] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) a.x += v[u].x, a.y += v[u].y, a.z += v[u].z, a.w += v[u].w;
    }
    acc[i] = a;
  }
  __syncthreads();
  for (int pc = tid; pc < P; pc += threads) {
    float4 t = acc[pc];
    for (int sl = 1; sl < S; ++sl) {
      const float4 v = acc[sl * P + pc];
      t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
    }
    reinterpret_cast<float4*>(sum)[pc] = t;
  }
}

// K2's tail (JAX's _kernel_d): GroupNorm-apply + mish + mask of c1, then
// the 1-channel 1x1 final_conv, f32 out (B, N); the statistics are over
// n_rows rows (N, or a frame slice's global rows). A programmatic dependent
// launch after kernel A, one block of TAIL_THREADS an SM: each block stages
// scale, shift and w_out (rounded to bf16, as JAX casts it) before
// griddep_wait, then sums batch element b's kernel-A tile sums (part (B,
// n_tiles, 2, C); every block of b the same values in the same order, 220
// KB at the served shape, from L2), folds each group's channels in order
// and stages a = inv * scale and b = shift - mean * a per channel. Grid
// (blocks, B): a block walks a run of rows of b, `tpr` threads a row (8
// channels a thread per 16-byte load; tpr in {8, 16, 32} divides 32) and
// TAIL_ROWS rows a team in flight, h = bf16(mish(c1 * a + b)) (0 at/after
// the length) summed against w_out in the thread in channel order, then
// across the row's threads by a butterfly of shuffles (a fixed order). The
// 10.6 M elements at the served shape make it bound by operations (two SFU
// operations and a conversion an element): mish_fast, h rounded to bf16
// two at a time, and ONE (C / 8 == tpr: one 8-channel piece a thread) keeps
// the thread's channel parameters in registers. (Clusters of 8 blocks that
// shared the tile sums through distributed shared memory were slower:
// PERF.md.) Dynamic shared memory: (5 + 2 S) C + 2 groups floats.
template <bool ONE>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
    final_tail(const bf16* c1, const float* part, int n_tiles, const float* scale,
               const float* shift, const float* wo, const float* bo, const int* lens, float* out,
               int N, int n_rows, int C, int groups, float eps, int tpr) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *stats = sm, *s_a = sm + 2 * C, *s_b = sm + 3 * C, *s_wo = sm + 4 * C;
  float* red = sm + 5 * C;  // sum_tiles' slices, then the groups' mean and inv
  const int b = blockIdx.y, tid = threadIdx.x;
  for (int c = tid; c < C; c += blockDim.x) {
    s_a[c] = scale[c];
    s_b[c] = shift[c];
    s_wo[c] = bf16_round(wo[c]);
  }
  griddep_wait();  // kernel A has finished: c1 and part are written
  sum_tiles(part + (size_t)b * n_tiles * 2 * C, n_tiles, C, stats, red);
  __syncthreads();
  const int cg = C / groups;
  float* g_mi = red;  // [2][groups]
  if (tid < groups) {
    float s = 0.f, ss = 0.f;
    for (int i = 0; i < cg; ++i) s += stats[tid * cg + i], ss += stats[C + tid * cg + i];
    const float m = (float)((long long)n_rows * cg);
    const float mu = s / m;
    g_mi[tid] = mu;
    g_mi[groups + tid] = rsqrtf(ss / m - mu * mu + eps);
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {  // h = c1 * a + b
    s_a[c] = g_mi[groups + c / cg] * s_a[c];
    s_b[c] -= g_mi[c / cg] * s_a[c];
  }
  __syncthreads();
  const int len = lens[b], pieces = C / 8, teams = blockDim.x / tpr;
  const int team = tid / tpr, tl = tid % tpr;
  const float b_out = bo[0];
  float r_a[8], r_b[8], r_wo[8];  // ONE: this thread's channels
  if (ONE) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      r_a[e] = s_a[tl * 8 + e];
      r_b[e] = s_b[tl * 8 + e];
      r_wo[e] = s_wo[tl * 8 + e];
    }
  }
  // a block's rows are one run of them; rows at/after the length (h = 0)
  // are neither read nor computed; whole warps run every round (the
  // shuffles take every lane)
  const int round = teams * TAIL_ROWS, chunk = (N + gridDim.x - 1) / gridDim.x;
  const int m_end = min(N, (blockIdx.x + 1) * chunk);
  for (int m0 = blockIdx.x * chunk; m0 < m_end; m0 += round) {
    float y[TAIL_ROWS];
    uint4 raw[TAIL_ROWS];
#pragma unroll
    for (int k = 0; k < TAIL_ROWS; ++k) y[k] = 0.f;
    for (int pc = tl; pc < pieces; pc += tpr) {
#pragma unroll
      for (int k = 0; k < TAIL_ROWS; ++k) {
        const int m = m0 + k * teams + team;
        raw[k] = m < m_end && m < len
                     ? *reinterpret_cast<const uint4*>(c1 + ((size_t)b * N + m) * C + pc * 8)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < TAIL_ROWS; ++k) {
        if (m0 + k * teams + team >= len) continue;
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float2 v = __bfloat1622float2(x2[e / 2]);
          float h[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = pc * 8 + e + i;
            h[i] = mish_fast(ONE ? fmaf(i ? v.y : v.x, r_a[e + i], r_b[e + i])
                                 : fmaf(i ? v.y : v.x, s_a[c], s_b[c]));
          }
          const float2 hb = __bfloat1622float2(__floats2bfloat162_rn(h[0], h[1]));
          y[k] += hb.x * (ONE ? r_wo[e] : s_wo[pc * 8 + e]);
          y[k] += hb.y * (ONE ? r_wo[e + 1] : s_wo[pc * 8 + e + 1]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < TAIL_ROWS; ++k) {
      for (int off = tpr / 2; off > 0; off >>= 1) y[k] += __shfl_xor_sync(0xffffffffu, y[k], off);
      const int m = m0 + k * teams + team;
      if (m < m_end && tl == 0) out[(size_t)b * N + m] = m < len ? y[k] + b_out : 0.f;
    }
  }
}

ConvArgs base_args(const void* x, const void* w, const float* bias, const int* lens,
                   void* out, int N, int F, int Cin, int Cout) {
  ConvArgs p = {};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.lens = lens;
  p.out = static_cast<bf16*>(out);
  p.N = N;
  p.F = F;
  p.Cin = Cin;
  p.Cout = Cout;
  return p;
}

// --- host side of the Hopper main loop ----------------------------------------

struct TcPlan {
  TcArgs a;
  int bn, box_t, box_f, smem;
  dim3 grid;
};

bool tc_bn_ok(int bn, int Cout) { return (bn == 64 || bn == 128) && Cout % bn == 0; }

// The row tile of a (T, F) grid: TF a divisor of F, TT = min(128 / TF, T);
// the fewest tiles, then the smallest box of (TT + 2 halo) x (TF + 2 halo).
void pick_tile(int T, int F, int halo, int& tt, int& tf) {
  long best_tiles = -1, best_box = 0;
  for (int d = 1; d <= F && d <= TC_BM; ++d) {
    if (F % d) continue;
    const int t = std::min(TC_BM / d, T);
    const long tiles = (long)((T + t - 1) / t) * (F / d);
    const long boxr = (long)(t + 2 * halo) * (d + 2 * halo);
    if (best_tiles < 0 || tiles < best_tiles || (tiles == best_tiles && boxr < best_box)) {
      best_tiles = tiles, best_box = boxr, tt = t, tf = d;
    }
  }
}

// taps 9: conv3x3 over the (T, F) grid; taps 1: the 1x1 conv over T*F rows
// (F = 1, no halo). pack_bn: the packed weights' Cout tile; the launch takes
// 64 columns from 128-column packing where 128 would leave more than half
// the SMs without a block (the F = 10 convs to 512 channels: 48 blocks).
// fpt > 0 (int8, K10a's tiled input): the row tile is picked for the fpt
// frames of a TPU tile, and each of the T / fpt TPU tiles takes sub =
// ceil(fpt / TT) row tiles of every frequency tile.
TcPlan make_tc_plan(int taps, int B, int T, int F, int Cin, int Cout, int pack_bn, int epi,
                    bool i8 = false, int fpt = 0) {
  TcPlan pl{};
  TcArgs& a = pl.a;
  if (taps == 1) T *= F, F = 1;
  const int halo = taps == 9 ? 1 : 0;
  a.T = T, a.F = F, a.Cin = Cin, a.Cout = Cout;
  pick_tile(fpt ? fpt : T, F, halo, a.tt, a.tf);
  a.tiles_f = F / a.tf;
  a.fpt = fpt;
  a.sub = fpt ? (fpt + a.tt - 1) / a.tt : 0;
  a.n_tiles = (fpt ? (T / fpt) * a.sub : (T + a.tt - 1) / a.tt) * a.tiles_f;
  a.n_chunks = (Cin + (i8 ? 128 : KC) - 1) / (i8 ? 128 : KC);
  int bn = pack_bn;
  if (pack_bn == 128 && 2 * a.n_tiles * B * (Cout / 128) <= n_sms()) bn = 64;
  a.split = pack_bn / bn;
  a.w_tile = a.n_chunks * taps * pack_bn * 128;
  a.w_stride = pack_bn * 128;
  pl.box_t = a.tt + 2 * halo;
  pl.box_f = a.tf + 2 * halo;
  a.box_bytes = round_up(pl.box_t * pl.box_f * KC * 2, 1024);
  a.stage_bytes = bn * KC * 2;
  // the ring and the boxes; after the products, the staged tile and (EPI 0)
  // its column sums over them
  const int pipe = TC_STAGES * a.stage_bytes + TC_BOXES * a.box_bytes;
  const int epi_bytes = TC_BM * (bn + 4) * 4 + (epi == 0 ? 2 * (256 / (bn / 8)) * bn * 4 : 0);
  a.data_bytes = round_up(std::max(pipe, epi_bytes), 128);
  pl.bn = bn;
  pl.smem = 1024 + a.data_bytes + 128 + (2 * TC_STAGES + 2 * TC_BOXES) * 8;
  pl.grid = dim3(a.n_tiles, Cout / bn, B);
  return pl;
}

typedef void (*TcKernel)(const CUtensorMap, TcArgs);

TcKernel tc_kernel(int taps, int bn, bool i8 = false) {
  if (i8) return bn == 128 ? conv_tc<9, 128, 0, true> : conv_tc<9, 64, 0, true>;
  if (taps == 9) return bn == 128 ? conv_tc<9, 128, 0> : conv_tc<9, 64, 0>;
  return bn == 128 ? conv_tc<1, 128, 1> : conv_tc<1, 64, 1>;
}

int tc_launch(int taps, TcPlan& pl, const void* x, int B, int Cin, cudaStream_t stream,
              bool i8 = false, bool pdl = false) {
  if (pl.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  // a tiled input is (B * n_tiles, fpt + 2, F, Cin): one tile's copy a batch row
  const int fpt = pl.a.fpt;
  int err = x_tensor_map(&xmap, x, fpt ? B * (pl.a.T / fpt) : B,
                         fpt ? fpt + 2 : pl.a.T + 2 * pl.a.hin, pl.a.F, Cin, pl.box_t, pl.box_f,
                         i8);
  if (err) return err;
  TcKernel k = tc_kernel(taps, pl.bn, i8);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return (int)e;
  if (pdl) return launch_pdl(k, pl.grid, TC_THREADS, pl.smem, stream, xmap, pl.a);
  k<<<pl.grid, TC_THREADS, pl.smem, stream>>>(xmap, pl.a);
  return (int)cudaGetLastError();
}

bool tc_takes(int Cin) { return Cin % 8 == 0; }

int n_row_tiles(int N) { return us_ceil_div(N, EL_BM); }

// Kernel A (conv3x3 + bias -> out, tile statistics -> part) on the Hopper
// loop for Cin % 8 == 0, else on element loads; hin: a halo'd input.
int conv3x3_launch(const void* x, const void* w, int BN, const float* bias, const int* lens,
                   void* out, float* part, int B, int N, int F, int Cin, int Cout, int hin,
                   int pdl, cudaStream_t st) {
  if (!tc_takes(Cin)) {
    if (Cout % EL_BN) return (int)cudaErrorInvalidValue;
    ConvArgs p = base_args(x, w, bias, lens, out, N, F, Cin, Cout);
    p.part = part;
    p.hin = hin;
    conv_gemm<9, 0, false><<<dim3(n_row_tiles(N), Cout / EL_BN, B), IG_THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (!tc_bn_ok(BN, Cout)) return (int)cudaErrorInvalidValue;
  TcPlan pl = make_tc_plan(9, B, N / F, F, Cin, Cout, BN, 0);
  pl.a.w = w;
  pl.a.bias = bias;
  pl.a.lens = lens;
  pl.a.out = static_cast<bf16*>(out);
  pl.a.part = part;
  pl.a.hin = hin;
  return tc_launch(9, pl, x, B, Cin, st, false, pdl);
}

// K9's int8 conv3x3 (hin: a halo'd input, launched plainly; else a
// programmatic dependent launch, K9's chain).
int conv3x3_i8_launch(const void* x8, const void* w8, int BN, const float* sx, const float* rsw,
                      const float* bias, const int* lens, void* out, float* part, int B, int N,
                      int F, int Cin, int Cout, int hin, cudaStream_t st) {
  if (!tc_bn_ok(BN, Cout) || Cin % 16) return (int)cudaErrorInvalidValue;
  TcPlan pl = make_tc_plan(9, B, N / F, F, Cin, Cout, BN, 0, true);
  pl.a.w = w8;
  pl.a.sx = sx;
  pl.a.rsw = rsw;
  pl.a.bias = bias;
  pl.a.lens = lens;
  pl.a.out = static_cast<bf16*>(out);
  pl.a.part = part;
  pl.a.hin = hin;
  return tc_launch(9, pl, x8, B, Cin, st, true, !hin);
}

}  // namespace

extern "C" {

int us_resnet_conv3x3_rows(const void* x, const void* w, const float* bias, const int* lens,
                           void* out, float* part, int B, int N, int F, int Cin, int Cout,
                           void* stream);
int us_final_tail(const void* c1, const float* part, int n_tiles, const float* scale,
                  const float* shift, const float* wo, const float* bo, const int* lens,
                  float* out, int B, int N, int n_rows, int C, int groups, float eps,
                  void* stream);
int us_gn_film_rows(const float* part, int n_tiles, void* c1h, const int* lens,
                    const float* scale, const float* shift, const void* film, float* mean,
                    float* inv, int B, int N, int C, int groups, int n_rows, float eps,
                    void* stream);
int us_resnet_out_rows(const void* c2, const void* x, const float* mean, const float* inv,
                       const float* scale, const float* shift, const void* wres,
                       const float* bres, const int* lens, void* out, int B, int N, int Cin,
                       int Cout, void* stream);

// The tiles (part's second dimension) us_resnet_conv3x3 writes for an
// input of Cin channels on the (N / F, F) grid.
int us_conv_n_tiles(int N, int F, int Cin) {
  if (!tc_takes(Cin)) return n_row_tiles(N);
  return make_tc_plan(9, 1, N / F, F, Cin, 64, 64, 0).a.n_tiles;
}

// The launch plan of a conv with `taps` (9 or 1) and weights packed in Cout
// tiles of BN: info = {TT, TF, the launch's Cout tile, blocks, threads,
// dynamic shared memory bytes, row tiles a batch element, blocks an SM
// holds}.
int us_conv_plan(int taps, int B, int T, int F, int Cin, int Cout, int BN, int* info) {
  if (!tc_bn_ok(BN, Cout) || !tc_takes(Cin) || (taps != 9 && taps != 1))
    return (int)cudaErrorInvalidValue;
  TcPlan pl = make_tc_plan(taps, B, T, F, Cin, Cout, BN, taps == 9 ? 0 : 1);
  TcKernel k = tc_kernel(taps, pl.bn);
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, TC_THREADS, pl.smem);
  const int v[8] = {pl.a.tt, pl.a.tf, pl.bn, (int)(pl.grid.x * pl.grid.y * pl.grid.z),
                    TC_THREADS, pl.smem, pl.a.n_tiles, per_sm};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return (int)e;
}

// Kernel A: conv3x3 + bias -> out (bf16) and per-tile statistics into part
// (B, us_conv_n_tiles(N, F, Cin), 2, Cout). Cin % 8 == 0: w packed by
// ops/fused_resnet.py pack_conv_weight in Cout tiles of BN (the Hopper
// loop); otherwise w is the raw (9*Cin, Cout) bf16 kernel (element loads).
// pdl: launch it with programmatic dependent launch (K9's chain: every
// kernel of the chain waits for its predecessor before reading).
int us_resnet_conv3x3(const void* x, const void* w, int BN, const float* bias, const int* lens,
                      void* out, float* part, int B, int N, int F, int Cin, int Cout, int pdl,
                      void* stream) {
  return conv3x3_launch(x, w, BN, bias, lens, out, part, B, N, F, Cin, Cout, 0, pdl,
                        static_cast<cudaStream_t>(stream));
}

// Kernel A on a halo'd input (a frame slice of the seq axis): x (B, N / F +
// 2, F, Cin), the slice's N rows with the neighbours' edge frame on each
// side (zeros at the global ends; masked by the sender); lens masks the
// interior rows; out, part and the launch plan are the N interior rows' (w
// and BN as us_resnet_conv3x3 takes them).
int us_resnet_conv3x3_halo(const void* x, const void* w, int BN, const float* bias,
                           const int* lens, void* out, float* part, int B, int N, int F, int Cin,
                           int Cout, void* stream) {
  return conv3x3_launch(x, w, BN, bias, lens, out, part, B, N, F, Cin, Cout, 1, 0,
                        static_cast<cudaStream_t>(stream));
}

// K9's int8 conv3x3 on the same loop: x8 (B, N, Cin) int8, zero at rows >=
// lens; w8 packed by ops/fused_resnet_deep.py pack_conv_weight_i8 in Cout
// tiles of BN (K-major tiles of BN x 128 int8 in the 128-byte swizzle);
// out = bf16(f32(acc) * ((1 / sx[b]) * rsw) + bias) and the tile statistics
// of that f32 value into part (B, us_conv_n_tiles(N, F, Cin), 2, Cout).
// Cin % 16 == 0.
int us_resnet_conv3x3_i8(const void* x8, const void* w8, int BN, const float* sx,
                         const float* rsw, const float* bias, const int* lens, void* out,
                         float* part, int B, int N, int F, int Cin, int Cout, void* stream) {
  return conv3x3_i8_launch(x8, w8, BN, sx, rsw, bias, lens, out, part, B, N, F, Cin, Cout, 0,
                           static_cast<cudaStream_t>(stream));
}

// The same conv on a halo'd int8 input (K9's sharded chain on a frame slice
// of the seq axis): x8 (B, N / F + 2, F, Cin), the slice's N rows with the
// neighbours' edge frame on each side, quantized with the same scale sx
// (zeros at the global ends and past their length); lens masks the
// interior rows; out, part and the launch plan are the N interior rows'.
// A plain launch (a collective runs before it).
int us_resnet_conv3x3_i8_halo(const void* x8, const void* w8, int BN, const float* sx,
                              const float* rsw, const float* bias, const int* lens, void* out,
                              float* part, int B, int N, int F, int Cin, int Cout,
                              void* stream) {
  return conv3x3_i8_launch(x8, w8, BN, sx, rsw, bias, lens, out, part, B, N, F, Cin, Cout, 1,
                           static_cast<cudaStream_t>(stream));
}

// K10a's int8 conv3x3 over a per-TPU-tile copy: x8t (B, N / (F fpt), fpt +
// 2, F, Cp) int8 (csrc/resnet_block_i8.cu tile_copy; Cp % 16 == 0, zero
// channels past the input's), w8 packed by pack_conv_weight_i8 for Cp input
// channels in Cout tiles of BN; out = bf16(f32(acc) * ((1 / sx[b, j]) * rsw)
// + bias) with j each row's TPU tile, and the tile statistics of that f32
// value into part (B, us_conv_i8_tiles_n_tiles(N, F, fpt), 2, Cout). A
// programmatic dependent launch.
int us_resnet_conv3x3_i8_tiles(const void* x8t, const void* w8, int BN, const float* sx,
                               const float* rsw, const float* bias, void* out, float* part, int B,
                               int N, int F, int Cp, int Cout, int fpt, void* stream) {
  if (!tc_bn_ok(BN, Cout) || Cp % 16 || fpt <= 0 || N % (F * fpt))
    return (int)cudaErrorInvalidValue;
  TcPlan pl = make_tc_plan(9, B, N / F, F, Cp, Cout, BN, 0, true, fpt);
  pl.a.w = w8;
  pl.a.sx = sx;
  pl.a.rsw = rsw;
  pl.a.bias = bias;
  pl.a.out = static_cast<bf16*>(out);
  pl.a.part = part;
  return tc_launch(9, pl, x8t, B, Cp, static_cast<cudaStream_t>(stream), true, true);
}

// The row tiles (part's second dimension) us_resnet_conv3x3_i8_tiles
// writes a batch element.
int us_conv_i8_tiles_n_tiles(int N, int F, int fpt) {
  return make_tc_plan(9, 1, N / F, F, 16, 64, 64, 0, true, fpt).a.n_tiles;
}

// Its launch plan: info = {TT, TF, the launch's Cout tile, blocks, threads,
// dynamic shared memory bytes, row tiles a batch element, blocks an SM
// holds, row tiles a TPU tile}.
int us_conv_plan_i8_tiles(int B, int T, int F, int Cp, int Cout, int BN, int fpt, int* info) {
  if (!tc_bn_ok(BN, Cout) || Cp % 16 || fpt <= 0 || T % fpt) return (int)cudaErrorInvalidValue;
  TcPlan pl = make_tc_plan(9, B, T, F, Cp, Cout, BN, 0, true, fpt);
  TcKernel k = tc_kernel(9, pl.bn, true);
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, TC_THREADS, pl.smem);
  const int v[9] = {pl.a.tt, pl.a.tf, pl.bn, (int)(pl.grid.x * pl.grid.y * pl.grid.z),
                    TC_THREADS, pl.smem, pl.a.n_tiles, per_sm, pl.a.sub};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return (int)e;
}

// K2, the final block: kernel A (conv3x3 + bias -> c1 (B, N, C) bf16 and
// its tile sums into part (B, us_conv_n_tiles(N, F, Cin), 2, C); w as
// us_resnet_conv3x3 takes it), then final_tail -> out (B, N) f32. Two
// launches. C % 64 == 0, (C / groups) % 8 == 0 (fused_resnet.takes).
int us_final_block(const void* x, const void* w, int BN, const float* bias, const int* lens,
                   void* c1, float* part, const float* scale, const float* shift,
                   const float* wo, const float* bo, float* out, int B, int N, int F, int Cin,
                   int C, int groups, float eps, void* stream) {
  if (C % 64 || C % groups || (C / groups) % 8) return (int)cudaErrorInvalidValue;
  int err = us_resnet_conv3x3(x, w, BN, bias, lens, c1, part, B, N, F, Cin, C, 0, stream);
  if (err) return err;
  return us_final_tail(c1, part, us_conv_n_tiles(N, F, Cin), scale, shift, wo, bo, lens, out, B,
                       N, N, C, groups, eps, stream);
}

// K2's tail alone: c1 (B, N, C) bf16 and the n_tiles tile sums part (B,
// n_tiles, 2, C) of n_rows rows (N, or on a frame slice of the seq axis
// every rank's tiles, gathered, and the global rows) -> out (B, N) f32. A
// programmatic dependent launch (it waits for the kernel before it).
int us_final_tail(const void* c1, const float* part, int n_tiles, const float* scale,
                  const float* shift, const float* wo, const float* bo, const int* lens,
                  float* out, int B, int N, int n_rows, int C, int groups, float eps,
                  void* stream) {
  if (C % 64 || C % groups || (C / groups) % 8) return (int)cudaErrorInvalidValue;
  // one block an SM, split among the batch elements
  const int tpr = C / 8 >= 32 ? 32 : C / 8 >= 16 ? 16 : 8;
  const bool one = C / 8 == tpr;  // one 8-channel piece a thread
  auto tail = one ? final_tail<true> : final_tail<false>;
  const int smem = ((5 + 2 * std::max(1, TAIL_THREADS / (C / 2))) * C + 2 * groups) * 4;
  static int smem_set[2] = {0, 0};  // the largest this process has allowed each
  if (smem > smem_set[one]) {
    cudaError_t e = cudaFuncSetAttribute(tail, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[one] = smem;
  }
  const int rows = TAIL_THREADS / tpr * TAIL_ROWS;  // a block's rows a round
  const int blocks = std::max(1, std::min(n_sms() / B, us_ceil_div(N, rows)));
  return launch_pdl(tail, dim3(blocks, B), TAIL_THREADS, smem, static_cast<cudaStream_t>(stream),
                    static_cast<const bf16*>(c1), part, n_tiles, scale, shift, wo, bo, lens, out,
                    N, n_rows, C, groups, eps, tpr);
}

int us_gn_finalize(const float* part, int B, int n_tiles, int C, int groups, int n_rows,
                   float eps, float* mean, float* inv, int pdl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pdl)
    return launch_pdl(gn_finalize, dim3(groups, B), 256, 0, st, part, n_tiles, C, groups,
                      n_rows, eps, mean, inv);
  gn_finalize<<<dim3(groups, B), 256, 0, st>>>(part, n_tiles, C, groups, n_rows, eps, mean, inv);
  return (int)cudaGetLastError();
}

// GroupNorm 1 and kernel B's input in one pass: mean/inv (B, C) from part
// (B, n_tiles, 2, C), and c1 (B, N, C) replaced by h = bf16(mish(GN1(c1) *
// scale + shift) + film) on rows < lens[b], 0 after. (C / groups) % 8 == 0.
int us_gn_film(const float* part, int n_tiles, void* c1h, const int* lens, const float* scale,
               const float* shift, const void* film, float* mean, float* inv, int B, int N,
               int C, int groups, float eps, void* stream) {
  return us_gn_film_rows(part, n_tiles, c1h, lens, scale, shift, film, mean, inv, B, N, C,
                         groups, N, eps, stream);
}

// us_gn_film with the statistics over n_rows rows: on a frame slice of the
// seq axis, part holds every rank's tiles (gathered) and n_rows is the
// global row count; N, c1h and lens are the slice's.
int us_gn_film_rows(const float* part, int n_tiles, void* c1h, const int* lens,
                    const float* scale, const float* shift, const void* film, float* mean,
                    float* inv, int B, int N, int C, int groups, int n_rows, float eps,
                    void* stream) {
  const int cg = C / groups;
  if (C % groups || cg % 8) return (int)cudaErrorInvalidValue;
  // about 8192 elements a block
  const int rows = std::max(1, 8192 / cg);
  gn_film<<<dim3(us_ceil_div(N, rows), groups, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, n_tiles, static_cast<bf16*>(c1h), lens, scale, shift, static_cast<const bf16*>(film),
      groups, eps, mean, inv, N, C, rows, n_rows);
  return (int)cudaGetLastError();
}

// Kernel C: GN2-apply + mish + mask + residual: the 1x1 conv when wres !=
// NULL (packed by pack_conv_weight in Cout tiles of BN for Cin % 8 == 0,
// else the raw (Cin, Cout) bf16 kernel), else the identity.
int us_resnet_out(const void* c2, const void* x, const float* mean, const float* inv,
                  const float* scale, const float* shift, const void* wres, int BN,
                  const float* bres, const int* lens, void* out, int B, int N, int Cin,
                  int Cout, int pdl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wres == nullptr) {
    if (pdl)
      return launch_pdl(resnet_out_elementwise<true, bf16>, elementwise_blocks(B, N, Cout), 256,
                        0, st, static_cast<const bf16*>(c2), static_cast<const bf16*>(x), mean,
                        inv, scale, shift, lens, static_cast<bf16*>(out), B, N, Cout);
    resnet_out_elementwise<true, bf16><<<elementwise_blocks(B, N, Cout), 256, 0, st>>>(
        static_cast<const bf16*>(c2), static_cast<const bf16*>(x), mean, inv, scale, shift,
        lens, static_cast<bf16*>(out), B, N, Cout);
    return (int)cudaGetLastError();
  }
  if (!tc_takes(Cin))
    return us_resnet_out_rows(c2, x, mean, inv, scale, shift, wres, bres, lens, out, B, N, Cin,
                              Cout, stream);
  if (!tc_bn_ok(BN, Cout)) return (int)cudaErrorInvalidValue;
  TcPlan pl = make_tc_plan(1, B, N, 1, Cin, Cout, BN, 1);
  pl.a.w = wres;
  pl.a.bias = bres;
  pl.a.lens = lens;
  pl.a.out = static_cast<bf16*>(out);
  pl.a.c2 = static_cast<const bf16*>(c2);
  pl.a.o_mean = mean;
  pl.a.o_inv = inv;
  pl.a.o_scale = scale;
  pl.a.o_shift = shift;
  return tc_launch(1, pl, x, B, Cin, st, false, pdl);
}

// Kernel C in JAX's res_mode "none": GN2-apply + mish + mask alone, f32
// out (B, N, C); the caller adds the residual.
int us_resnet_out_none(const void* c2, const float* mean, const float* inv, const float* scale,
                       const float* shift, const int* lens, float* out, int B, int N, int C,
                       void* stream) {
  resnet_out_elementwise<false, float>
      <<<elementwise_blocks(B, N, C), 256, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(c2), nullptr, mean, inv, scale, shift, lens, out, B, N, C);
  return (int)cudaGetLastError();
}

// One ResnetBlock (K1, and K8 at the deep stages) in one call: kernel A
// (conv1 + statistics), gn_film (GroupNorm 1 + mish + FiLM + mask, c1 ->
// h in place), kernel B (conv2 on h + statistics), its GroupNorm, kernel C
// (GN2 + mish + mask + residual; identity when wres == NULL). w1, w2, wres
// as us_resnet_conv3x3 / us_resnet_out take them, BN their Cout tile.
// Scratch: c1, c2 (B, N, Cout) bf16; part (B, max of us_conv_n_tiles(N, F,
// Cin) and (N, F, Cout), 2, Cout); mean/inv (B, Cout).
int us_resnet_block(const void* x, const void* w1, const float* b1, const float* s1,
                    const float* be1, const void* film, const void* w2, const float* b2,
                    const float* s2, const float* be2, const void* wres, const float* bres,
                    const int* lens, void* c1, void* c2, float* part, float* mean1, float* inv1,
                    float* mean2, float* inv2, void* out, int B, int N, int F, int Cin, int Cout,
                    int groups, float eps, int BN, void* stream) {
  int err = us_resnet_conv3x3(x, w1, BN, b1, lens, c1, part, B, N, F, Cin, Cout, 0, stream);
  if (err) return err;
  err = us_gn_film(part, us_conv_n_tiles(N, F, Cin), c1, lens, s1, be1, film, mean1, inv1, B, N,
                   Cout, groups, eps, stream);
  if (err) return err;
  err = us_resnet_conv3x3(c1, w2, BN, b2, lens, c2, part, B, N, F, Cout, Cout, 0, stream);
  if (err) return err;
  err = us_gn_finalize(part, B, us_conv_n_tiles(N, F, Cout), Cout, groups, N, eps, mean2, inv2,
                       0, stream);
  if (err) return err;
  return us_resnet_out(c2, x, mean2, inv2, s2, be2, wres, BN, bres, lens, out, B, N, Cin, Cout,
                       0, stream);
}

// The raw-weight kernels A and C (element loads on igemm_bf16: the Cin % 8
// != 0 convs of us_resnet_conv3x3 / us_resnet_out): w (9*Cin, Cout), wres
// (Cin, Cout) bf16 or NULL; part (B, ceil(N / 128), 2, Cout).
int us_resnet_conv3x3_rows(const void* x, const void* w, const float* bias, const int* lens,
                           void* out, float* part, int B, int N, int F, int Cin, int Cout,
                           void* stream) {
  if (Cout % EL_BN) return (int)cudaErrorInvalidValue;
  ConvArgs p = base_args(x, w, bias, lens, out, N, F, Cin, Cout);
  p.part = part;
  dim3 grid(n_row_tiles(N), Cout / EL_BN, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 8 == 0)
    conv_gemm<9, 0, true><<<grid, IG_THREADS, 0, st>>>(p);
  else
    conv_gemm<9, 0, false><<<grid, IG_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

int us_resnet_out_rows(const void* c2, const void* x, const float* mean, const float* inv,
                       const float* scale, const float* shift, const void* wres,
                       const float* bres, const int* lens, void* out, int B, int N, int Cin,
                       int Cout, void* stream) {
  if (wres == nullptr)
    return us_resnet_out(c2, x, mean, inv, scale, shift, nullptr, 0, bres, lens, out, B, N, Cin,
                         Cout, 0, stream);
  if (Cout % EL_BN) return (int)cudaErrorInvalidValue;
  ConvArgs p = base_args(x, wres, bres, lens, out, N, 1, Cin, Cout);
  p.c2 = static_cast<const bf16*>(c2);
  p.o_mean = mean;
  p.o_inv = inv;
  p.o_scale = scale;
  p.o_shift = shift;
  dim3 grid(n_row_tiles(N), Cout / EL_BN, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin % 8 == 0)
    conv_gemm<1, 1, true><<<grid, IG_THREADS, 0, st>>>(p);
  else
    conv_gemm<1, 1, false><<<grid, IG_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
