// The U-Net's strided resampling convs (kernels K11a and K11b), written for
// the H100: TMA copies, mbarrier rings and warpgroup products (wgmma).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resample.py:
// fused_downsample_conv (_fused_downsample: _downsample_kernel), conv3x3
// stride 2 'SAME', and fused_upsample_conv (_fused_upsample:
// _upsample_kernel), ConvTranspose 4x4 stride 2 with flax padding (2, 2),
// unflipped flax kernel. Input frames at/after the sequence length read as
// zero (the estimator skips its `h * mask` pass); the bias lands on every
// output row. With hb / ha > 0 the input is a frame slice of the seq axis
// with its neighbours' edge frames around it (the downsample reads the one
// before, the upsample one a side), read as the sender masked them.
// Products are bf16, the f32 accumulator takes the f32 bias and is rounded
// once to bf16.
//
// Layout: x (B, T, F, Cin) channels last, bf16. The weights arrive packed
// once at load (ops/resample.py pack_*_weight): for each Cout tile of BN
// columns, each 64-channel chunk of Cin and each weight stage, BN x 64
// K-major tiles in the 128-byte swizzle that wgmma reads, Cin padded to a
// multiple of 64 with zero rows. The packer chooses BN; the launch takes it
// from the packed weights and refuses one the kernels are not built for.
//
// What bounds them (bf16, batch 3 at the 344-frame bucket; 989 TFLOP/s and
// 3.35 TB/s): D1 (344, 80, 128) -> (172, 40, 128) is 6.09 GFLOP (6.2 us)
// against 26.7 MB (8.0 us), bytes; D2 (172, 40, 256) -> (86, 20, 256) is
// 6.09 GFLOP (6.2 us) against 14.4 MB (4.3 us), operations; U (172, 40, 128)
// -> (344, 80, 128) is 10.8 GFLOP (10.9 us) against 26.9 MB (8.0 us),
// operations. Each site is a few microseconds of work, so the design feeds
// the tensor cores from shared memory and moves each input byte once per
// tile:
//   * a block owns a 2-D tile of 64 rows (TT frames x TF frequencies, TF
//     the largest of 8, 4, 2, 1 dividing the frequency count, TT = 64 / TF)
//     and the whole Cout up to 256 (a wider Cout splits into tiles of 256,
//     128 or 64 columns);
//   * per 64-channel chunk, the input box the tile's taps reach (every
//     frame and frequency of it) arrives by one 4-D TMA copy in the
//     128-byte swizzle, shared by all taps and, in the upsample, all four
//     phases. The copy reads zero outside the tensor (frame or frequency
//     -1, F, T, channels past Cin); rows at/after the length are real data
//     that the consumers skip by pointing ldmatrix at a zero row;
//   * the downsample's stride 2 lives in the ldmatrix row addresses (rows
//     2 ff + df of frames 2 tt + dt); such rows form no canonical wgmma
//     layout, so A comes from registers (the ldmatrix fragment is wgmma's
//     A fragment) and B through a descriptor from a ring of weight tiles,
//     which one producer warp keeps filled by bulk copies under full/empty
//     mbarriers;
//   * products go out two k16 steps to a commit group, the next
//     group's fragments loaded while one group runs (two register sets);
//   * taps and chunks are loops with the row bases computed once per tile:
//     no division in the K loop;
//   * the epilogue adds the bias, rounds once, stages the tile in shared
//     memory and writes whole output rows with 16-byte stores.
// K11a: one consumer warpgroup (64 output rows x BN) and the producer warp,
// 160 threads; a ring of 3 weight tiles of BN x 64; the box of
// (2 TT + 1) x (2 TF + 1) input rows in 1 to 3 slots (the most that keep
// the blocks an SM of one slot; with three each box goes out a chunk ahead,
// hopper.cuh produce_ring). K11b: two consumer warpgroups, one per time
// phase a, each computing both frequency phases (a, b) of the tile's 64
// input positions (two 64 x BN accumulators), and the producer warp, 288
// threads; a ring of 2 stages of the four phases' BN x 64 tiles; the box of
// (TT + 2) x (TF + 2) input rows in slots chosen as K11a's; the epilogue interleaves the
// phases so that output frames 2 mt and 2 mt + 1 go out as runs of 2 TF
// whole rows.
// At the sites (us_resample_plan; chip_smoke.py prints them):
//   D1: 8 x 8 rows, BN 128, 330 blocks, 88 288 B of shared memory, one box
//       slot, two blocks an SM (three slots, one block an SM: 9% slower);
//   D2: 16 x 4 rows, BN 256, 90 blocks, 216 288 B, three box slots, one
//       block an SM (90 of the 132 SMs; clusters of 2 or 4 blocks sharing
//       each weight stage by multicast measured 2-3x slower, PERF.md);
//   U:  8 x 8 positions (256 output rows), BN 128, 330 blocks, 172 240 B,
//       three box slots, one block an SM (two slots: 1-4% slower at D2, U).
// nvcc -Xptxas -v (CUDA 12.8, sm_90a, on the H100 machine): downsample_conv
// BN 64 / 128 / 256 127 / 165 / 222 registers, no spills; upsample_conv
// BN 64 / 128 133 / 168 registers, the latter with 16 bytes of spill
// stores and its wgmma serialized for want of registers (C7512): 288
// threads cap a thread at 168, and two 64 x 128 accumulators take 128.
#include "hopper.cuh"

namespace {

constexpr int DOWN_STAGES = 3, UP_STAGES = 2;  // weight ring depths
constexpr int DOWN_THREADS = 160, UP_THREADS = 288;

struct RsArgs {
  const bf16* w;      // packed tiles (see the header)
  const float* bias;  // (Cout)
  const int* lens;    // (B) valid input frames
  bf16* out;
  int T, F, Cout;
  // a halo'd input (a frame slice of the seq axis): x holds hb frames before
  // the slice's T and ha after it, read as they are (the sender masked
  // them; zeros at the global ends); lens masks the T interior frames
  int hb, ha;
  int tt, tf, lg_tf, tiles_f;  // the row tile
  int n_chunks, nb, stage_bytes, box_bytes;
};

// Store a 64 x BN warpgroup accumulator plus bias as bf16 into the staging
// tile: fragment row i of warp `wl` goes to staging row row_of(i).
template <int BN, class RowOf>
US_DEV void stage_acc(const float (&acc)[BN / 2], const float* bias, uint8_t* st, int wl,
                      RowOf row_of) {
  const int lane = threadIdx.x & 31;
  constexpr int LD = BN * 2 + 16;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_of(wl * 16 + (lane >> 2) + h * 8);
      *reinterpret_cast<__nv_bfloat162*>(st + r * LD + col * 2) =
          __floats2bfloat162_rn(acc[j * 4 + 2 * h] + b0, acc[j * 4 + 2 * h + 1] + b1);
    }
  }
}

// Whether input frame ti (of the slice's T; -hb .. -1 and T .. T + ha - 1
// the halo frames) holds data: a halo frame always, an interior one before
// the length tlim.
US_DEV bool frame_ok(int ti, int T, int tlim, int hb, int ha) {
  return ti < 0 ? ti >= -hb : (ti < T ? ti < tlim : ti < T + ha);
}

// Shared memory of both kernels: the weight ring, the box slots, a zero
// row, then the barriers.
struct Smem {
  uint8_t *ring, *box, *zero;
  uint64_t *w_full, *w_empty, *x_full, *x_empty;
  __device__ Smem(const RsArgs& p, int stages) {
    ring = smem_base();
    box = ring + stages * p.stage_bytes;
    zero = box + p.nb * p.box_bytes;
    w_full = reinterpret_cast<uint64_t*>(zero + 128);
    w_empty = w_full + stages;
    x_full = w_empty + stages;
    x_empty = x_full + 3;
  }
  // each consumer warp arrives once on a slot it is done with
  US_DEV void init(const RsArgs& p, int stages, int consumer_warps) {
    if (threadIdx.x < 8) reinterpret_cast<uint4*>(zero)[threadIdx.x] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s)
        mbar_init(&w_full[s], 1), mbar_init(&w_empty[s], consumer_warps);
      for (int s = 0; s < p.nb; ++s)
        mbar_init(&x_full[s], 1), mbar_init(&x_empty[s], consumer_warps);
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// K11a. Block (row tile, Cout tile, batch); warps 0-3 consume, warp 4 loads.
// A row r = (tt, ff) is output row (to0 + tt, fo0 + ff); its tap (dt, df)
// reads box row (2 tt + dt) * BF + 2 ff + df.
template <int BN>
__global__ void __launch_bounds__(DOWN_THREADS, 1)
    downsample_conv(const __grid_constant__ CUtensorMap xmap, RsArgs p) {
  constexpr int S = DOWN_STAGES;
  Smem sm(p, S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = p.T, F = p.F, Cout = p.Cout, To = T / 2, Fo = F / 2;
  const int TF = p.tf, b = blockIdx.z, n0 = blockIdx.y * BN;
  const int tile_t = blockIdx.x / p.tiles_f, tile_f = blockIdx.x - tile_t * p.tiles_f;
  const int to0 = tile_t * p.tt, fo0 = tile_f * TF;
  const int ti0 = 2 * to0 - 1, fi0 = 2 * fo0 - 1, BF = 2 * TF + 1;
  sm.init(p, S, 4);

  if (warp == 4) {
    produce_ring(&xmap, sm.ring, sm.box, sm.w_full, sm.w_empty, sm.x_full, sm.x_empty, S, 9,
                 p.stage_bytes, p.stage_bytes, p.nb, p.box_bytes, (2 * p.tt + 1) * BF * KC * 2,
                 p.n_chunks, p.w + (size_t)blockIdx.y * p.n_chunks * 9 * BN * KC, fi0,
                 ti0 + p.hb, blockIdx.z);
  } else {
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    wgmma_fence_acc(acc);
    uint32_t afr[2][2][4];  // two sets of two k16 steps' fragments
    const int tlim = min(T, p.lens[b]);
    const int r = warp * 16 + (lane & 15);
    const int tt = r >> p.lg_tf, ff = r & (TF - 1);
    const uint32_t hi = lane >> 4, zero_addr = smem_u32(sm.zero);
    int ws = 0, xs = 0, pend = -1;
    uint32_t wph = 0, xph = 0;
    for (int c = 0; c < p.n_chunks; ++c) {
      mbar_wait(&sm.x_full[xs], xph);
      const uint32_t box_addr = smem_u32(sm.box + xs * p.box_bytes);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3, df = tap % 3;  // constants once unrolled
        const int R = (2 * tt + dt) * BF + 2 * ff + df;
        const bool ok = frame_ok(ti0 + 2 * tt + dt, T, tlim, p.hb, p.ha) &&
                        (unsigned)(fi0 + 2 * ff + df) < (unsigned)F;
        const uint32_t row = ok ? box_addr + R * 128 : zero_addr, rx = ok ? R & 7 : 0;
        // each half's fragment set was last read two groups back, which
        // the previous wait<1> has seen complete
        load_half(afr[0], row, rx, hi, 0);
        mbar_wait(&sm.w_full[ws], wph);
        const uint64_t desc = wgmma_desc_sw128(sm.ring + ws * p.stage_bytes);
        mma_half<BN>(acc, afr[0], desc, 0);
        wgmma_wait<1>();  // the previous tap's last group is done: its stage is free
        if (pend >= 0) release(&sm.w_empty[pend]);
        load_half(afr[1], row, rx, hi, 2);
        mma_half<BN>(acc, afr[1], desc, 2);
        wgmma_wait<1>();
        pend = ws;
        if (++ws == S) ws = 0, wph ^= 1;
      }
      release(&sm.x_empty[xs]);
      if (++xs == p.nb) xs = 0, xph ^= 1;
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    bar_sync_named(1, 128);  // every product has read the ring: stage the tile there
    uint8_t* st = sm.ring;
    stage_acc<BN>(acc, p.bias + n0, st, warp, [](int i) { return i; });
    bar_sync_named(1, 128);
    constexpr int CPR = BN / 8;  // 16-byte chunks per row
    for (int i = tid; i < 64 * CPR; i += 128) {
      const int rr = i / CPR, ch = i & (CPR - 1);
      const int to = to0 + (rr >> p.lg_tf), fo = fo0 + (rr & (TF - 1));
      if (to < To)
        *reinterpret_cast<uint4*>(p.out + ((size_t)(b * To + to) * Fo + fo) * Cout + n0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(st + rr * (BN * 2 + 16) + ch * 16);
    }
  }
}

// K11b. Block (row tile, Cout tile, batch); warpgroup a (warps 4a .. 4a+3)
// computes phases (a, 0) and (a, 1), warp 8 loads. Phase (a, b) at input
// position (mt0 + tt, mf0 + ff) and step q = (it, jf) reads box row
// (tt + it + a) * BF + ff + jf + b with kernel tap (a + 2 it, b + 2 jf) and
// writes output row (2 (mt0 + tt) + a, 2 (mf0 + ff) + b).
template <int BN>
__global__ void __launch_bounds__(UP_THREADS, 1)
    upsample_conv(const __grid_constant__ CUtensorMap xmap, RsArgs p) {
  constexpr int S = UP_STAGES;
  Smem sm(p, S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = p.T, F = p.F, Cout = p.Cout;
  const int TF = p.tf, b = blockIdx.z, n0 = blockIdx.y * BN;
  const int tile_t = blockIdx.x / p.tiles_f, tile_f = blockIdx.x - tile_t * p.tiles_f;
  const int mt0 = tile_t * p.tt, mf0 = tile_f * TF;
  const int ti0 = mt0 - 1, fi0 = mf0 - 1, BF = TF + 2;
  sm.init(p, S, 8);

  if (warp == 8) {
    produce_ring(&xmap, sm.ring, sm.box, sm.w_full, sm.w_empty, sm.x_full, sm.x_empty, S, 4,
                 p.stage_bytes, p.stage_bytes, p.nb, p.box_bytes, (p.tt + 2) * BF * KC * 2,
                 p.n_chunks, p.w + (size_t)blockIdx.y * p.n_chunks * 16 * BN * KC, fi0,
                 ti0 + p.hb, blockIdx.z);
  } else {
    const int pa = warp >> 2, wl = warp & 3;
    float acc0[BN / 2], acc1[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
    wgmma_fence_acc(acc0);
    wgmma_fence_acc(acc1);
    uint32_t afr[2][2][4];  // two sets of two k16 steps' fragments
    const int tlim = min(T, p.lens[b]);
    const int r = wl * 16 + (lane & 15);
    const int tt = r >> p.lg_tf, ff = r & (TF - 1);
    const uint32_t hi = lane >> 4, zero_addr = smem_u32(sm.zero);
    const int tile_bytes = BN * KC * 2;
    int ws = 0, xs = 0, pend = -1;
    uint32_t wph = 0, xph = 0;
    for (int c = 0; c < p.n_chunks; ++c) {
      mbar_wait(&sm.x_full[xs], xph);
      const uint32_t box_addr = smem_u32(sm.box + xs * p.box_bytes);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int bt = tt + (q >> 1) + pa, bf = ff + (q & 1);
        const bool t_ok = frame_ok(ti0 + bt, T, tlim, p.hb, p.ha);
        const int R = bt * BF + bf;  // phase b = 0; b = 1 reads R + 1
        const bool ok0 = t_ok && (unsigned)(fi0 + bf) < (unsigned)F;
        const bool ok1 = t_ok && (unsigned)(fi0 + bf + 1) < (unsigned)F;
        const uint32_t row0 = ok0 ? box_addr + R * 128 : zero_addr, rx0 = ok0 ? R & 7 : 0;
        const uint32_t row1 = ok1 ? box_addr + (R + 1) * 128 : zero_addr;
        const uint32_t rx1 = ok1 ? (R + 1) & 7 : 0;
        load_half(afr[0], row0, rx0, hi, 0);
        mbar_wait(&sm.w_full[ws], wph);
        uint8_t* stage = sm.ring + ws * p.stage_bytes + pa * 2 * tile_bytes;
        const uint64_t desc0 = wgmma_desc_sw128(stage), desc1 = wgmma_desc_sw128(stage + tile_bytes);
        mma_half<BN>(acc0, afr[0], desc0, 0);
        wgmma_wait<1>();  // the previous stage's last group is done: it is free
        if (pend >= 0) release(&sm.w_empty[pend]);
        load_half(afr[1], row0, rx0, hi, 2);
        mma_half<BN>(acc0, afr[1], desc0, 2);
        wgmma_wait<1>();
        load_half(afr[0], row1, rx1, hi, 0);
        mma_half<BN>(acc1, afr[0], desc1, 0);
        wgmma_wait<1>();
        load_half(afr[1], row1, rx1, hi, 2);
        mma_half<BN>(acc1, afr[1], desc1, 2);
        wgmma_wait<1>();
        pend = ws;
        if (++ws == S) ws = 0, wph ^= 1;
      }
      release(&sm.x_empty[xs]);
      if (++xs == p.nb) xs = 0, xph ^= 1;
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc0);
    wgmma_fence_acc(acc1);
    bar_sync_named(1, 256);
    // staging row (2 tt + a) * 2 TF + 2 ff + b: output frames 2 mt0 .. 2 mt0
    // + 2 TT - 1, each a run of 2 TF whole rows
    uint8_t* st = sm.ring;
    const int lg_tf = p.lg_tf;
    auto row_of = [lg_tf, TF, pa](int i, int pb) {
      return ((2 * (i >> lg_tf) + pa) << (lg_tf + 1)) + 2 * (i & (TF - 1)) + pb;
    };
    stage_acc<BN>(acc0, p.bias + n0, st, wl, [&](int i) { return row_of(i, 0); });
    stage_acc<BN>(acc1, p.bias + n0, st, wl, [&](int i) { return row_of(i, 1); });
    bar_sync_named(1, 256);
    constexpr int CPR = BN / 8;
    for (int i = tid; i < 256 * CPR; i += 256) {
      const int rr = i / CPR, ch = i & (CPR - 1);
      const int ot = 2 * mt0 + (rr >> (lg_tf + 1)), of = 2 * mf0 + (rr & (2 * TF - 1));
      if (ot < 2 * T)
        *reinterpret_cast<uint4*>(p.out + ((size_t)(b * 2 * T + ot) * 2 * F + of) * Cout + n0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(st + rr * (BN * 2 + 16) + ch * 16);
    }
  }
}

// --- host side -----------------------------------------------------------

struct Plan {
  RsArgs a;
  int bn, threads, smem, box_t, box_f;
  dim3 grid;
};

int pick_tf(int n) {
  for (int tf = 8; tf > 1; tf >>= 1)
    if (n % tf == 0) return tf;
  return 1;
}

// The Cout tiles the kernels are built for: 64 to 256 columns in the
// downsample, 64 or 128 in the upsample (two accumulators a thread).
bool bn_ok(bool up, int bn, int Cout) {
  return (bn == 64 || bn == 128 || (!up && bn == 256)) && Cout % bn == 0;
}

// bn: the packed weights' Cout tile (bn_ok holds).
Plan make_plan(bool up, int B, int T, int F, int Cin, int Cout, int bn) {
  Plan pl{};
  RsArgs& a = pl.a;
  a.T = T, a.F = F, a.Cout = Cout;
  const int rows_f = up ? F : F / 2, rows_t = up ? T : T / 2;
  a.tf = pick_tf(rows_f);
  a.tt = 64 / a.tf;
  a.lg_tf = __builtin_ctz(a.tf);
  a.tiles_f = rows_f / a.tf;
  a.n_chunks = (Cin + KC - 1) / KC;
  pl.box_t = up ? a.tt + 2 : 2 * a.tt + 1;
  pl.box_f = up ? a.tf + 2 : 2 * a.tf + 1;
  a.box_bytes = round_up(pl.box_t * pl.box_f * KC * 2, 1024);
  pl.bn = bn;
  a.stage_bytes = (up ? 4 : 1) * pl.bn * KC * 2;
  pl.threads = up ? UP_THREADS : DOWN_THREADS;
  const int stages = up ? UP_STAGES : DOWN_STAGES;
  auto smem_of = [&](int nb) {
    return 1024 + stages * a.stage_bytes + nb * a.box_bytes + 128 + (2 * stages + 6) * 8;
  };
  // the most box slots (three at most) that keep the blocks an SM of one
  auto per_sm = [](int s) { return SMEM_PER_SM / (s + 1024); };
  a.nb = 1;
  for (int nb = 3; nb > 1 && a.nb == 1; --nb)
    if (smem_of(nb) <= SMEM_MAX && per_sm(smem_of(nb)) >= per_sm(smem_of(1))) a.nb = nb;
  pl.smem = smem_of(a.nb);
  pl.grid = dim3(((rows_t + a.tt - 1) / a.tt) * a.tiles_f, Cout / pl.bn, B);
  return pl;
}

template <class K>
int launch(K kernel, const Plan& pl, const void* x, int B, int Cin, cudaStream_t stream) {
  if (pl.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  int err = x_tensor_map(&xmap, x, B, pl.a.T + pl.a.hb + pl.a.ha, pl.a.F, Cin, pl.box_t,
                         pl.box_f);
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<pl.grid, pl.threads, pl.smem, stream>>>(xmap, pl.a);
  return (int)cudaGetLastError();
}

void fill_io(Plan& pl, const void* w, const float* bias, const int* lens, void* out, int hb,
             int ha) {
  pl.a.w = static_cast<const bf16*>(w);
  pl.a.bias = bias;
  pl.a.lens = lens;
  pl.a.out = static_cast<bf16*>(out);
  pl.a.hb = hb;
  pl.a.ha = ha;
}

}  // namespace

extern "C" {

// K11a: x (B, hb + T + ha, F, Cin) -> out (B, (T/2)*(F/2), Cout); T, F
// even, Cin % 8 == 0, w packed by ops/resample.py pack_downsample_weight in
// Cout tiles of BN, lens (B) valid input frames of the T. hb = ha = 0: the
// whole sequence; on a frame slice of the seq axis (starting at an even
// frame) hb = 1, ha = 0: the neighbour's frame before it (output frame j
// reads input frames 2 j - 1 .. 2 j + 1), as the sender masked it.
int us_downsample_conv(const void* x, const void* w, const float* bias, const int* lens,
                       void* out, int B, int T, int F, int Cin, int Cout, int BN, int hb, int ha,
                       void* stream) {
  if (!bn_ok(false, BN, Cout) || hb < 0 || ha < 0) return (int)cudaErrorInvalidValue;
  Plan pl = make_plan(false, B, T, F, Cin, Cout, BN);
  fill_io(pl, w, bias, lens, out, hb, ha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl.bn) {
    case 256: return launch(downsample_conv<256>, pl, x, B, Cin, s);
    case 128: return launch(downsample_conv<128>, pl, x, B, Cin, s);
    default: return launch(downsample_conv<64>, pl, x, B, Cin, s);
  }
}

// K11b: x (B, hb + T + ha, F, Cin) -> out (B, 2T*2F, Cout); Cin % 8 == 0,
// w packed by ops/resample.py pack_upsample_weight in Cout tiles of BN, lens
// (B) valid frames of the T. hb = ha = 0: the whole sequence; on a frame
// slice of the seq axis hb = ha = 1: one frame of each neighbour (output
// frame o reads input frames (o - 2) / 2 .. (o + 1) / 2), as the sender
// masked them.
int us_upsample_conv(const void* x, const void* w, const float* bias, const int* lens,
                     void* out, int B, int T, int F, int Cin, int Cout, int BN, int hb, int ha,
                     void* stream) {
  if (!bn_ok(true, BN, Cout) || hb < 0 || ha < 0) return (int)cudaErrorInvalidValue;
  Plan pl = make_plan(true, B, T, F, Cin, Cout, BN);
  fill_io(pl, w, bias, lens, out, hb, ha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pl.bn == 128) return launch(upsample_conv<128>, pl, x, B, Cin, s);
  return launch(upsample_conv<64>, pl, x, B, Cin, s);
}

// The launch plan of a site with Cout tiles of BN: info = {TT, TF, BN,
// blocks, threads, dynamic shared memory bytes, box slots, blocks an SM
// holds}.
int us_resample_plan(int up, int B, int T, int F, int Cin, int Cout, int BN, int* info) {
  if (!bn_ok(up != 0, BN, Cout)) return (int)cudaErrorInvalidValue;
  Plan pl = make_plan(up != 0, B, T, F, Cin, Cout, BN);
  int per_sm = 0;
  void (*k)(const CUtensorMap, RsArgs);
  if (up)
    k = pl.bn == 128 ? upsample_conv<128> : upsample_conv<64>;
  else
    k = pl.bn == 256 ? downsample_conv<256>
                     : pl.bn == 128 ? downsample_conv<128> : downsample_conv<64>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, pl.threads, pl.smem);
  const int v[8] = {pl.a.tt, pl.a.tf, pl.bn, (int)(pl.grid.x * pl.grid.y * pl.grid.z),
                    pl.threads, pl.smem, pl.a.nb, per_sm};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return (int)e;
}

}  // extern "C"
