// Rezero linear attention (kernel K4).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_attention.py:
// fused_rezero_attention (_fused_rezero_attention: _phase1_kernel,
// _phase2_kernel). For x (B, N, C) bf16, heads 4 x dim 32:
//   ctx_h = softmax_over_tokens(x Wk_h)^T (x Wv_h)      (32 x 32 per head)
//   y     = mask * (x + g * ((x Wq_h) ctx_h) Wout + b_out)
// Keys are not length-masked: zero padding rows of the bucket enter the
// softmax, as in the reference; only the output rows at/after the length
// are zeroed. Rows past N (the last tile's TMA fill) stay out.
//
// What bounds it on the H100: bytes (x read twice, y written once; 0.5-4
// us a site at 3.35 TB/s) and, at the small sites, the three launches. The
// TPU kernel carried the online-softmax state (m, den, num) across its
// sequential grid steps; here each block of phase 1 carries it across the
// 128-row tiles it walks, so a batch element has P partials (the grid is
// about one wave: P ~ SMs / B, make_attn_plan), not one a
// tile. Three launches:
//   * attn_kv (grid P x 2 head pairs x B): per tile the K|V projection of
//     two heads (128 columns) on wgmma m64n128k16, x by TMA (one 128-row x
//     64-channel box per chunk through a ring, zero past N), the weights
//     packed once at load and staged once per block (above C = 512 they do
//     not fit beside the ring: each chunk's weight tile then rides in its x
//     box's ring slot, read again per tile from L2); the column max across
//     the tile, the rescale of the running (m, den, num) (exp as ex2.approx
//     of (k - m) log2 e: 1e-6 relative, far inside the output's bf16), and
//     exp(K)^T V on
//     mma.sync: the accumulator's e and V fragments are transposed in
//     registers (movmatrix) into the A and B fragments, each split into a
//     bf16 high and low part and multiplied three times (hi hi, hi lo, lo
//     hi) with f32 accumulation, so the context keeps f32 accuracy. Each
//     warp keeps the partial num of its rows; the block sums them once.
//   * attn_merge (grid 4 heads x 4 row groups x B): ctx = sum_p num_p
//     e^(m_p - M) / sum_p den_p e^(m_p - M), each rescale exp once, a thread
//     per (row, column) over the P partials. (Merging in the last phase-1
//     block to finish, behind a counter, was slower: PERF.md.)
//   * attn_out (grid P2 x B): per tile Q = x Wq on wgmma, attn = Q ctx on
//     mma.sync in the same three-product split (the accumulator is the A
//     fragment), attn rounded to bf16 is wgmma's A fragment of the output
//     projection, then bf16(out) + b_out, x + g * out, the mask. Wq and
//     Wout are staged once per block (at C = 512 Wout streams through one
//     slot: both do not fit with the ring; above, Wq's tiles ride the x
//     ring as in phase 1 and Wout streams through two slots).
// On a frame slice of the seq axis (ops/fused_attention.py) the three
// launches split in two calls: us_attn_kv writes the slice's P partials;
// the host gathers every rank's partials into one (B, 2, P_total, ...)
// buffer (attn_merge rescales each by its own maxima, so partials of any
// tokens merge); us_attn_merge_out merges them into the whole sequence's
// context and runs attn_out on the slice's rows.
// One block runs 2 warpgroups (64 tile rows each); thread 0 also sends
// the TMA and bulk copies (csrc/hopper.cuh), each into its ring slot once
// the 8 warps have released it. No producer warp: a block of 288 threads
// may hold only 168 registers a thread, which serialized the softmax's
// independent column chains (PERF.md); 256 threads may hold 255. The
// phases are bound by latency at one block an SM, not by bytes or the
// tensor cores.
#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int NH = 4, DH = 32, HD = NH * DH;
constexpr int TM = 128;            // rows of a tile
// two warpgroups; thread 0 also sends the copies (no producer warp: a
// block of 256 threads may hold 255 registers a thread, 288 only 168)
constexpr int THREADS = 256;
constexpr int XB = TM * KC * 2;    // one x box: 128 rows x 64 channels, 16 KB
constexpr int WT = 128 * KC * 2;   // one packed weight tile: 128 columns x 64 k, 16 KB
constexpr int KVC = 64;            // K columns of a head pair (phase 1)
constexpr int NB_FLOATS = 2 * DH * DH;  // a warp's partial num of a head pair
constexpr int CTS = DH + 8;        // bf16 row stride of the staged ctx^T
constexpr int P_MAX = 128;         // partials a (batch, head pair) at most
constexpr int P_MERGE = 1024;      // partials attn_merge takes: every seq rank's

US_DEV uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

US_DEV uint32_t bits(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }

US_DEV uint32_t pack_bf16(float a, float b) { return bits(__floats2bfloat162_rn(a, b)); }

// v[i] for a lane-dependent i in 0..3, without indexing a register array
US_DEV uint32_t sel4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// (a, b) = hi + lo, each a bf16 pair: hi the rounded value, lo the rounded
// remainder (a 16-bit mantissa in all; the products of two such splits
// leave out lo * lo, below 2^-16 relative).
US_DEV void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// c += a_hi b_hi + a_hi b_lo + a_lo b_hi (m16n8k16, f32 accumulate)
US_DEV void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                 uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_bf16_16816(c, ah, bh0, bh1);
  mma_bf16_16816(c, ah, bl0, bl1);
  mma_bf16_16816(c, al, bh0, bh1);
}

// The x ring: the producer's side (one box a chunk, zero past N) and the
// consumers' product of a tile with the weights, acc (64 x 128 per
// warpgroup) = x rows 64 g .. 64 g + 63 @ W, W's chunk c the packed tile at
// w + c * WT (resident), or, with `wsrc`, the tile wsrc + c * WT that the
// producer sends into the chunk's slot behind its x box (streamed).
struct Ring {
  uint8_t* buf;
  uint64_t *full, *empty;
  int n;
  // the block's chunks in order: tile k (grid tile t0 + k * dt) chunk c is
  // chunk k * nc + c of `total`; thread 0 sends them, each into its slot
  // once the 8 warps have released the slot's previous chunk
  const CUtensorMap* map;
  int nc, t0, dt, total, b;
  const uint8_t* wsrc = nullptr;  // the streamed weights; null: resident
  int s = 0, g_sent = 0;
  uint32_t ph = 0;
  US_DEV void next() {
    if (++s == n) s = 0, ph ^= 1;
  }
  US_DEV int slot_bytes() const { return wsrc ? XB + WT : XB; }
  US_DEV void send() {
    const int g = g_sent++, slot = g % n;
    uint8_t* dst = buf + slot * slot_bytes();
    if (g >= n) mbar_wait(&empty[slot], ((g / n) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[slot], slot_bytes());
    tma_load_4d(dst, map, (g % nc) * KC, (t0 + (g / nc) * dt) * TM, 0, b, &full[slot]);
    if (wsrc) bulk_g2s(dst + XB, wsrc + (size_t)(g % nc) * WT, WT, &full[slot]);
  }
  US_DEV void prime() {  // thread 0, at the start: the first n chunks
    while (g_sent < min(n, total)) send();
  }
  US_DEV void refill() {  // after a release: thread 0 sends the next chunk
    if (threadIdx.x == 0 && g_sent < total) send();
  }
  // DB: two fragment sets, the next chunk's loads overlapping this chunk's
  // products (phase 2); one set keeps phase 1's registers for its state
  template <bool DB>
  US_DEV void gemm(float (&acc)[64], const uint8_t* w, int nc) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int R = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
    const uint32_t hi = lane >> 4, rx = R & 7;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    wgmma_fence_acc(acc);
    // two fragment sets: a chunk's products run while the next chunk's
    // fragments load; a set is reloaded once the group that read it is done
    uint32_t a0[4][4], a1[4][4];
    int prev = -1;
    auto chunk = [&](uint32_t(&f)[4][4], int c) {
      mbar_wait(&full[s], ph);
      const uint8_t* sb = buf + s * slot_bytes();
      const uint32_t row = smem_u32(sb) + R * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_x4(f[kk], row + ((((2 * kk + hi) ^ rx) & 7) << 4));
      const uint64_t desc = wgmma_desc_sw128(wsrc ? sb + XB : w + c * WT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) WgmmaRS<128>::mma(acc, f[kk], desc + 2 * kk);
      wgmma_commit();
      if (DB) {
        wgmma_wait<1>();  // the previous chunk's group is done: its slot is free
        if (prev >= 0) release(&empty[prev]), refill();
        prev = s;
      } else {
        wgmma_wait<0>();
        release(&empty[s]);
        refill();
      }
      next();
    };
    for (int c = 0; c < nc; ++c) {
      if (DB && (c & 1))
        chunk(a1, c);
      else
        chunk(a0, c);
    }
    if (DB) {
      wgmma_wait<0>();
      release(&empty[prev]);
      refill();
    }
    wgmma_fence_acc(acc);
  }
};

// Phase 1. Block (p, hp, b): tiles p, p + P, ... of batch element b, heads
// 2 hp and 2 hp + 1. Packed columns of the head pair: [K | V] of each head,
// so accumulator column block j (8 columns) is K of head j / 8 for j % 8 <
// 4, else V. Writes the block's partial: m and den per K column (64), num
// (2 heads x 32 x 32). ws: the head pair's weight tiles ride the ring
// (kv_stream) instead of being staged.
__global__ void __launch_bounds__(THREADS, 1)
    attn_kv(const __grid_constant__ CUtensorMap xmap, const bf16* wkv, int N, int C, int P,
            int ws, float* part_m, float* part_den, float* part_num) {
  griddep_wait();  // the three launches are programmatic dependent launches
  griddep_launch();
  const int nc = C / KC, ntiles = (N + TM - 1) / TM;
  const int p = blockIdx.x, hp = blockIdx.y, b = blockIdx.z;
  const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(wkv) + (size_t)hp * nc * WT;
  uint8_t* w = smem_base();
  uint8_t* xr = ws ? w : w + nc * WT;
  float* red = reinterpret_cast<float*>(xr + 4 * (ws ? XB + WT : XB));  // [8 warps][64]
  float* m_run = red + 8 * KVC;                         // [64]
  float* m_new = m_run + KVC;
  float* scl = m_new + KVC;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(scl + KVC);
  uint64_t* x_full = w_full + 1;
  uint64_t* x_empty = x_full + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < 4; ++s) mbar_init(&x_full[s], 1), mbar_init(&x_empty[s], 8);
    mbar_fence_init();
  }
  if (tid < KVC) m_run[tid] = -INFINITY;
  __syncthreads();
  Ring ring{xr, x_full, x_empty, 4, &xmap, nc, p, P, ((ntiles - p + P - 1) / P) * nc, b,
            ws ? wsrc : nullptr};
  if (tid == 0) {
    if (!ws) {
      mbar_arrive_expect_tx(w_full, nc * WT);
      for (int c = 0; c < nc; ++c) bulk_g2s(w + c * WT, wsrc + (size_t)c * WT, WT, w_full);
    }
    ring.prime();
  }

  const int q4 = lane & 3, rq = lane >> 2;
  const int row_base = (warp >> 2) * 64 + (warp & 3) * 16 + rq;  // + 8 for the second half
  // the block's running max of each key column (m_run, in shared memory),
  // and per thread the exp-sum of its 16 key columns over its rows and num
  // of its fragment, over the warp's rows
  float den[2][4][2], num[2][2][4][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      den[hh][j][0] = den[hh][j][1] = 0.f;
#pragma unroll
      for (int ib = 0; ib < 2; ++ib)
#pragma unroll
        for (int e = 0; e < 4; ++e) num[hh][ib][j][e] = 0.f;
    }
  if (!ws) mbar_wait(w_full, 0);
  float acc[64];
  for (int t = p; t < ntiles; t += P) {
    ring.gemm<false>(acc, w, nc);
    const bool ok0 = t * TM + row_base < N, ok1 = t * TM + row_base + 8 < N;
    // the tile's column maxima: the thread's two rows, its 8-lane column
    // group, then the 8 warps
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = (8 * hh + jb) * 4 + e;
          float m = fmaxf(ok0 ? acc[a] : -INFINITY, ok1 ? acc[a + 2] : -INFINITY);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          if (rq == 0) red[warp * KVC + 32 * hh + 8 * jb + 2 * q4 + e] = m;
        }
    bar_sync_named(1, 256);
    if (tid < KVC) {
      float m = red[tid];
      for (int w8 = 1; w8 < 8; ++w8) m = fmaxf(m, red[w8 * KVC + tid]);
      const float mo = m_run[tid], mn = fmaxf(mo, m);
      m_new[tid] = mn;
      scl[tid] = __expf(mo - mn);
      m_run[tid] = mn;
    }
    bar_sync_named(1, 256);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // rescale the running sums, then e = exp(k - m) (0 past N)
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = 32 * hh + 8 * jb + 2 * q4 + e, a = (8 * hh + jb) * 4 + e;
          const float mn = m_new[kc];
          acc[a] = ok0 ? __expf(acc[a] - mn) : 0.f;
          acc[a + 2] = ok1 ? __expf(acc[a + 2] - mn) : 0.f;
          den[hh][jb][e] = den[hh][jb][e] * scl[kc] + (acc[a] + acc[a + 2]);
        }
#pragma unroll
      for (int ib = 0; ib < 2; ++ib)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float sc = scl[32 * hh + 16 * ib + 8 * h2 + rq];
#pragma unroll
          for (int jv = 0; jv < 4; ++jv)
#pragma unroll
            for (int e = 0; e < 2; ++e) num[hh][ib][jv][2 * h2 + e] *= sc;
        }
      // e^T (8 x 8 blocks: key column block jb, row half h2) and V^T
      // (value column block jv, row half h2), transposed in registers
      uint32_t eh[4][2], el[4][2], vh[4][2], vl[4][2];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int a = (8 * hh + jb) * 4 + 2 * h2, v = (8 * hh + 4 + jb) * 4 + 2 * h2;
          uint32_t hi, lo;
          split2(acc[a], acc[a + 1], hi, lo);
          eh[jb][h2] = movmatrix_t(hi), el[jb][h2] = movmatrix_t(lo);
          split2(acc[v], acc[v + 1], hi, lo);
          vh[jb][h2] = movmatrix_t(hi), vl[jb][h2] = movmatrix_t(lo);
        }
      // num (key rows i, value columns j) += e^T V over the warp's 16 rows
#pragma unroll
      for (int ib = 0; ib < 2; ++ib) {
        const uint32_t ah[4] = {eh[2 * ib][0], eh[2 * ib + 1][0], eh[2 * ib][1], eh[2 * ib + 1][1]};
        const uint32_t al[4] = {el[2 * ib][0], el[2 * ib + 1][0], el[2 * ib][1], el[2 * ib + 1][1]};
#pragma unroll
        for (int jv = 0; jv < 4; ++jv)
          mma3(num[hh][ib][jv], ah, al, vh[jv][0], vh[jv][1], vl[jv][0], vl[jv][1]);
      }
    }
  }

  // the block's partial: den over the rows, num over the 8 warps (in the
  // weights' and the ring's space, which every product has read: 64 KB, the
  // ring alone holds 128 KB when the weights stream)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int jb = 0; jb < 4; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float d = den[hh][jb][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (rq == 0) red[warp * KVC + 32 * hh + 8 * jb + 2 * q4 + e] = d;
      }
  bar_sync_named(1, 256);
  float* nb = reinterpret_cast<float*>(w);  // [8 warps][2 heads][32][32]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int ib = 0; ib < 2; ++ib)
#pragma unroll
      for (int jv = 0; jv < 4; ++jv)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * ib + rq + 8 * (e >> 1), j = 8 * jv + 2 * q4 + (e & 1);
          nb[warp * NB_FLOATS + hh * DH * DH + i * DH + j] = num[hh][ib][jv][e];
        }
  bar_sync_named(1, 256);
  const size_t pb = ((size_t)b * 2 + hp) * P + p;
  if (tid < KVC) {
    float d = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) d += red[w8 * KVC + tid];
    part_den[pb * KVC + tid] = d;
    part_m[pb * KVC + tid] = m_run[tid];
  }
  for (int o = tid; o < NB_FLOATS; o += 256) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) s += nb[w8 * NB_FLOATS + o];
    part_num[pb * NB_FLOATS + o] = s;
  }

}

// Merge the P partials of (batch b, head h) for 8 key rows: ctx[i][j] =
// sum_p num_p[i][j] w_p[i] / sum_p den_p[i] w_p[i], w_p[i] = e^(m_p[i] -
// M[i]), M the largest m_p, in partial order. Grid (4 heads, 4 row
// groups, B), a thread per (row, column).
__global__ void __launch_bounds__(256) attn_merge(const float* part_m, const float* part_den,
                                                  const float* part_num, int P, float* ctx) {
  __shared__ float wp[P_MERGE][8], M[8], D[8];
  griddep_wait();
  griddep_launch();
  const int h = blockIdx.x, hp = h >> 1, hh = h & 1, i0 = blockIdx.y * 8, b = blockIdx.z;
  const int tid = threadIdx.x, il = tid >> 5, j = tid & 31;
  const size_t pb = ((size_t)b * 2 + hp) * P;
  const int col = 32 * hh + i0;  // the rows' K columns in the partials
  if (tid < 8) {
    float m = -INFINITY;
#pragma unroll 8
    for (int q = 0; q < P; ++q) m = fmaxf(m, part_m[(pb + q) * KVC + col + tid]);
    M[tid] = m;
  }
  __syncthreads();
  for (int o = tid; o < P * 8; o += 256) {
    const int q = o >> 3, r = o & 7;
    wp[q][r] = expf(part_m[(pb + q) * KVC + col + r] - M[r]);
  }
  __syncthreads();
  if (tid < 8) {
    float d = 0.f;
#pragma unroll 8
    for (int q = 0; q < P; ++q) d += part_den[(pb + q) * KVC + col + tid] * wp[q][tid];
    D[tid] = d;
  }
  __syncthreads();
  const int i = i0 + il;
  float a = 0.f;
#pragma unroll 8
  for (int q = 0; q < P; ++q)
    a += part_num[(pb + q) * NB_FLOATS + hh * DH * DH + i * DH + j] * wp[q][il];
  ctx[(((size_t)b * NH + h) * DH + i) * DH + j] = a / D[il];
}

struct OutArgs {
  const bf16* x;      // (B, N, C): the residual
  const bf16* wq;     // packed (C / 64, 128, 64)
  const bf16* wo;     // packed (C / 128, 2, 128, 64)
  const float* ctx;   // (B, 4, 32, 32)
  const float* bo;    // (C)
  const float* g;     // (1)
  const int* lens;    // (B)
  bf16* y;            // (B, N, C)
  int N, C, P2, n_xs, n_os;  // x ring slots; Wout slots (C / 128: staged once)
  int wq_ring;               // Wq's tiles ride the x ring (out_slots)
};

// Phase 2. Block (p, b): tiles p, p + P2, ... of batch element b.
__global__ void __launch_bounds__(THREADS, 1)
    attn_out(const __grid_constant__ CUtensorMap xmap, OutArgs a) {
  griddep_wait();
  const int C = a.C, N = a.N, nc = C / KC, nt_out = C / 128, ntiles = (N + TM - 1) / TM;
  const bool stream_wo = a.n_os < nt_out, staged = !a.wq_ring || !stream_wo;
  const int p = blockIdx.x, b = blockIdx.y;
  uint8_t* wq = smem_base();
  uint8_t* wo = wq + (a.wq_ring ? 0 : nc * WT);
  uint8_t* xr = wo + a.n_os * 2 * WT;
  // [4][32 j][CTS] ctx^T high
  bf16* cth = reinterpret_cast<bf16*>(xr + a.n_xs * (a.wq_ring ? XB + WT : XB));
  bf16* ctl = cth + NH * DH * CTS;                         // low
  uint64_t* w_full = reinterpret_cast<uint64_t*>(ctl + NH * DH * CTS);
  uint64_t* o_full = w_full + 1;
  uint64_t* o_empty = o_full + 2;
  uint64_t* x_full = o_empty + 2;
  uint64_t* x_empty = x_full + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < 2; ++s) mbar_init(&o_full[s], 1), mbar_init(&o_empty[s], 8);
    for (int s = 0; s < 4; ++s) mbar_init(&x_full[s], 1), mbar_init(&x_empty[s], 8);
    mbar_fence_init();
  }
  __syncthreads();
  const int tiles = (ntiles - p + a.P2 - 1) / a.P2;  // the block's tiles
  Ring ring{xr, x_full, x_empty, a.n_xs, &xmap, nc, p, a.P2, tiles * nc, b,
            a.wq_ring ? reinterpret_cast<const uint8_t*>(a.wq) : nullptr};
  // Wout's 128-column tiles through n_os slots when they do not all fit:
  // thread 0 sends tile g % nt_out of the block's sequence into slot g %
  // n_os once its previous tile there is released
  const uint8_t* wo_src = reinterpret_cast<const uint8_t*>(a.wo);
  const int total_o = stream_wo ? tiles * nt_out : 0;
  int go_sent = 0;
  auto send_wo = [&]() {
    const int g = go_sent++, slot = g % a.n_os;
    if (g >= a.n_os) mbar_wait(&o_empty[slot], ((g / a.n_os) & 1) ^ 1);
    mbar_arrive_expect_tx(&o_full[slot], 2 * WT);
    bulk_g2s(wo + slot * 2 * WT, wo_src + (size_t)(g % nt_out) * 2 * WT, 2 * WT, &o_full[slot]);
  };
  if (tid == 0) {
    if (staged)
      mbar_arrive_expect_tx(w_full,
                            (a.wq_ring ? 0 : nc * WT) + (stream_wo ? 0 : nt_out * 2 * WT));
    if (!a.wq_ring)
      for (int c = 0; c < nc; ++c)
        bulk_g2s(wq + c * WT, reinterpret_cast<const uint8_t*>(a.wq) + (size_t)c * WT, WT,
                 w_full);
    if (!stream_wo)
      for (int n = 0; n < nt_out; ++n)
        bulk_g2s(wo + n * 2 * WT, wo_src + (size_t)n * 2 * WT, 2 * WT, w_full);
    ring.prime();
    while (go_sent < min(a.n_os, total_o)) send_wo();
  }

  // ctx^T of batch element b, split into bf16 high and low parts
  float cv[NH * DH * DH / 256];  // loaded before any is stored
#pragma unroll
  for (int k = 0; k < NH * DH * DH / 256; ++k)
    cv[k] = __ldg(a.ctx + (size_t)b * NH * DH * DH + tid + 256 * k);
#pragma unroll
  for (int k = 0; k < NH * DH * DH / 256; ++k) {
    const int o = tid + 256 * k, h = o / (DH * DH), i = (o / DH) % DH, j = o % DH;
    const float v = cv[k];
    const bf16 hi = __float2bfloat16(v);
    cth[(h * DH + j) * CTS + i] = hi;
    ctl[(h * DH + j) * CTS + i] = __float2bfloat16(v - __bfloat162float(hi));
  }
  bar_sync_named(1, 256);
  const int q4 = lane & 3, rq = lane >> 2;
  const int row_base = (warp >> 2) * 64 + (warp & 3) * 16 + rq;
  const __nv_bfloat162 g2 = __float2bfloat162_rn(a.g[0]);
  const int len = a.lens[b];
  int os = 0;
  uint32_t oph = 0;
  if (staged) mbar_wait(w_full, 0);
  float acc[64];
  for (int t = p; t < ntiles; t += a.P2) {
    ring.gemm<true>(acc, wq, nc);
    // attn_h = Q_h ctx_h: Q's accumulator is the A fragment (16 rows x 16
    // key columns per k16 step), ctx^T rows give B
    float at[NH][4][4];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) at[h][jn][e] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j0 = (4 * h + 2 * s) * 4, j1 = j0 + 4;
        uint32_t ah[4], al[4];
        split2(acc[j0], acc[j0 + 1], ah[0], al[0]);
        split2(acc[j0 + 2], acc[j0 + 3], ah[1], al[1]);
        split2(acc[j1], acc[j1 + 1], ah[2], al[2]);
        split2(acc[j1 + 2], acc[j1 + 3], ah[3], al[3]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int r = (h * DH + 8 * jn + rq) * CTS + 16 * s + 2 * q4;
          mma3(at[h][jn], ah, al, *reinterpret_cast<const uint32_t*>(cth + r),
               *reinterpret_cast<const uint32_t*>(cth + r + 8),
               *reinterpret_cast<const uint32_t*>(ctl + r),
               *reinterpret_cast<const uint32_t*>(ctl + r + 8));
        }
      }
    }
    // attn rounded to bf16: the A fragments of the output projection's 8
    // k16 steps
    uint32_t af[8][4];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int h = s >> 1, jn = 2 * (s & 1);
      af[s][0] = pack_bf16(at[h][jn][0], at[h][jn][1]);
      af[s][1] = pack_bf16(at[h][jn][2], at[h][jn][3]);
      af[s][2] = pack_bf16(at[h][jn + 1][0], at[h][jn + 1][1]);
      af[s][3] = pack_bf16(at[h][jn + 1][2], at[h][jn + 1][3]);
    }
    const size_t row0 = (size_t)b * N + t * TM;
    for (int n = 0; n < nt_out; ++n) {
      const uint8_t* wt = wo + (stream_wo ? os : n) * 2 * WT;
      // the residual and the bias of the thread's outputs, read (on the
      // read-only path, before any store) while the products run: in the
      // store layout, 8 columns 8 (4 k + q4) .. of the thread's two rows
      uint4 xr[2][4], bb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = n * 128 + 8 * (4 * k + q4);
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.bo + c));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.bo + c + 4));
        bb[k] = make_uint4(pack_bf16(b0.x, b0.y), pack_bf16(b0.z, b0.w), pack_bf16(b1.x, b1.y),
                           pack_bf16(b1.z, b1.w));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = row_base + 8 * h2;
          xr[h2][k] = t * TM + r < N
                          ? __ldg(reinterpret_cast<const uint4*>(a.x + (row0 + r) * C + c))
                          : make_uint4(0, 0, 0, 0);
        }
      }
      if (stream_wo) mbar_wait(&o_full[os], oph);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      wgmma_fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s)
        WgmmaRS<128>::mma(acc, af[s], wgmma_desc_sw128(wt + (s >> 2) * WT) + 2 * (s & 3));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_acc(acc);
      if (stream_wo) {
        release(&o_empty[os]);
        if (tid == 0 && go_sent < total_o) send_wo();
        if (++os == a.n_os) os = 0, oph ^= 1;
      }
      // bf16(out) + b_out, x + g * out, each rounded to bf16; 0 past the
      // length. The quad's four lanes trade their bf16 pairs so that each
      // holds 8 whole columns, and a warp stores 64 contiguous bytes a row.
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = row_base + 8 * h2, m = t * TM + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t pr[4], rv[4], v[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            pr[jj] = pack_bf16(acc[4 * (4 * k + jj) + 2 * h2], acc[4 * (4 * k + jj) + 2 * h2 + 1]);
          // rv[d]: lane q4 ^ d's pair of column block 4 k + q4
          rv[0] = sel4(pr, q4);
#pragma unroll
          for (int d = 1; d < 4; ++d) rv[d] = __shfl_xor_sync(0xffffffffu, sel4(pr, q4 ^ d), d);
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) v[qq] = sel4(rv, q4 ^ qq);
          if (m >= N) continue;
          const __nv_bfloat162* ov = reinterpret_cast<const __nv_bfloat162*>(v);
          const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr[h2][k]);
          const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&bb[k]);
          // bf16 pair arithmetic: each operation rounds its exact result
          // once, as the plain version's bf16 operations do
          uint32_t y[4] = {0u, 0u, 0u, 0u};
          if (m < len)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              y[i] = bits(__hadd2(xv[i], __hmul2(g2, __hadd2(ov[i], bv[i]))));
          *reinterpret_cast<uint4*>(a.y + (row0 + r) * C + n * 128 + 8 * (4 * k + q4)) =
              make_uint4(y[0], y[1], y[2], y[3]);
        }
      }
    }
  }
}

constexpr int BARS = 128;  // barrier space at the end of the shared memory

// The schedule at B rows of N tokens: 128-row tiles; phase 1 in P blocks a
// (batch element, head pair), about one wave of one block an SM, each
// walking tiles p, p + P, ... and writing one partial (2 P a batch element,
// O(SMs / B), not one a tile); phase 2 in P2 blocks a batch element, also
// about one wave.
struct AttnPlan {
  int tiles, p1, p2;
};

AttnPlan make_attn_plan(int B, int N) {
  const int tiles = us_ceil_div(N, TM), sms = n_sms();
  return {tiles, std::max(1, std::min({tiles, us_ceil_div(sms, 2 * B), P_MAX})),
          std::max(1, std::min(tiles, us_ceil_div(sms, B)))};
}

// Phase 1's shared memory: the C / 64 K|V tiles staged beside a ring of
// four x boxes, or, when they do not fit (C > 512: 324 KB at C = 1024),
// four ring slots of an x box and its chunk's weight tile.
int kv_smem_of(int C, bool ws) {
  return 1024 + (ws ? 4 * (XB + WT) : (C / KC) * WT + 4 * XB) + 11 * KVC * 4 + BARS;
}

bool kv_stream(int C) { return kv_smem_of(C, false) > SMEM_MAX; }

int kv_smem(int C) { return kv_smem_of(C, kv_stream(C)); }

int out_smem_of(int C, int n_xs, int n_os, int wq_ring) {
  return 1024 + (wq_ring ? 0 : (C / KC) * WT) + n_os * 2 * WT +
         n_xs * (wq_ring ? XB + WT : XB) + 2 * NH * DH * CTS * 2 + BARS;
}

// Phase 2's slots: Wq and Wout staged once beside a ring of four x boxes
// when they fit; else Wout through one streamed slot and two boxes (C =
// 512); else Wq's tiles ride a ring of four slots, each an x box and its
// chunk's tile, and Wout streams through two slots (C = 1024).
void out_slots(int C, int& n_xs, int& n_os, int& wq_ring) {
  wq_ring = 0, n_xs = 4, n_os = C / 128;
  if (out_smem_of(C, n_xs, n_os, wq_ring) <= SMEM_MAX) return;
  n_xs = 2, n_os = 1;
  if (out_smem_of(C, n_xs, n_os, wq_ring) <= SMEM_MAX) return;
  wq_ring = 1, n_xs = 4, n_os = std::min(2, C / 128);
}

int out_smem(int C) {
  int n_xs, n_os, wq_ring;
  out_slots(C, n_xs, n_os, wq_ring);
  return out_smem_of(C, n_xs, n_os, wq_ring);
}

// Raise the phases' shared memory limits once to the largest asked for.
int attn_smem(int C, int& s1, int& s2) {
  s1 = kv_smem(C), s2 = out_smem(C);
  if (s1 > SMEM_MAX || s2 > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int set1 = 0, set2 = 0;
  int err;
  if (s1 > set1) {
    if ((err = (int)cudaFuncSetAttribute(attn_kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         s1)) != 0)
      return err;
    set1 = s1;
  }
  if (s2 > set2) {
    if ((err = (int)cudaFuncSetAttribute(attn_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         s2)) != 0)
      return err;
    set2 = s2;
  }
  return 0;
}

}  // namespace

extern "C" {

// Phase 1 alone: x (B, N, C) bf16, wkv as us_rezero_attention takes it ->
// the P = us_attn_plan(B, N).p1 partials part_m / part_den (B, 2, P, 64),
// part_num (B, 2, P, 2, 32, 32) f32. A programmatic dependent launch.
int us_attn_kv(const void* x, const void* wkv, float* part_m, float* part_den, float* part_num,
               int B, int N, int C, void* stream) {
  if (C % KC || B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  int s1, s2, err = attn_smem(C, s1, s2);
  if (err) return err;
  const int P = make_attn_plan(B, N).p1;
  CUtensorMap xmap;
  if ((err = x_tensor_map(&xmap, x, B, 1, N, C, 1, TM))) return err;
  return launch_pdl(attn_kv, dim3(P, 2, B), THREADS, s1, static_cast<cudaStream_t>(stream), xmap,
                    static_cast<const bf16*>(wkv), N, C, P, (int)kv_stream(C), part_m, part_den,
                    part_num);
}

// The merge of P partials (any tokens' partials: a frame slice's P_total,
// every seq rank's gathered in the layout us_attn_kv writes, P_total <=
// 1024) into ctx (B, 4, 32, 32) f32, then phase 2 on x (B, N, C): y = mask *
// (x + g * (attn Wout + b_out)). Weights as us_rezero_attention takes them.
// Two programmatic dependent launches.
int us_attn_merge_out(const void* x, const void* wq, const void* wo, const float* b_out,
                      const float* g, const int* lens, void* y, const float* part_m,
                      const float* part_den, const float* part_num, int P, float* ctx, int B,
                      int N, int C, void* stream) {
  if (C % KC || B < 1 || N < 1 || P < 1 || P > P_MERGE) return (int)cudaErrorInvalidValue;
  int s1, s2, err = attn_smem(C, s1, s2);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap xmap;
  if ((err = x_tensor_map(&xmap, x, B, 1, N, C, 1, TM))) return err;
  if ((err = launch_pdl(attn_merge, dim3(NH, DH / 8, B), 256, 0, st, part_m, part_den, part_num,
                        P, ctx)))
    return err;
  OutArgs a;
  a.x = static_cast<const bf16*>(x);
  a.wq = static_cast<const bf16*>(wq);
  a.wo = static_cast<const bf16*>(wo);
  a.ctx = ctx;
  a.bo = b_out;
  a.g = g;
  a.lens = lens;
  a.y = static_cast<bf16*>(y);
  a.N = N, a.C = C, a.P2 = make_attn_plan(B, N).p2;
  out_slots(C, a.n_xs, a.n_os, a.wq_ring);
  return launch_pdl(attn_out, dim3(a.P2, B), THREADS, s2, st, xmap, a);
}

// x (B, N, C) bf16; wkv (2, C/64, 128, 64), wq (C/64, 128, 64), wo (C/128,
// 2, 128, 64) bf16, packed by ops/fused_attention.py pack_attention_weights;
// b_out (C) f32; g (1) f32 the rezero gate; lens (B) valid rows. Scratch,
// with P from us_attn_plan: part_m / part_den (B, 2, P, 64), part_num (B,
// 2, P, 2, 32, 32), ctx (B, 4, 32, 32), all f32. C % 64 == 0. Three
// launches: us_attn_kv, then us_attn_merge_out over its P partials; each
// launch starts as the one before drains (its kernel waits for it before
// reading anything).
int us_rezero_attention(const void* x, const void* wkv, const void* wq, const void* wo,
                        const float* b_out, const float* g, const int* lens, void* y,
                        float* part_m, float* part_den, float* part_num, float* ctx, int B,
                        int N, int C, void* stream) {
  int err = us_attn_kv(x, wkv, part_m, part_den, part_num, B, N, C, stream);
  if (err) return err;
  return us_attn_merge_out(x, wq, wo, b_out, g, lens, y, part_m, part_den, part_num,
                           make_attn_plan(B, N).p1, ctx, B, N, C, stream);
}

// K4's schedule at B rows of N tokens (make_attn_plan): info = {tiles, P
// (phase-1 blocks a (batch element, head pair), the partials' third
// dimension), P2 (phase-2 blocks a batch element)}.
int us_attn_plan(int B, int N, int* info) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const AttnPlan plan = make_attn_plan(B, N);
  info[0] = plan.tiles, info[1] = plan.p1, info[2] = plan.p2;
  return 0;
}

}  // extern "C"
