// The bf16 KNARPE cross-attention v3 forward B3 at the scaled preset's widths (D = R = 256, 8 heads): four blocks
// per source, each on two of the eight heads, the source's targets streamed through a ring of 32-target tiles and
// the softmax taken online over the tiles; no exchange between the blocks.
//
// Replaces, for bf16 operands at d_model = d_rpe = 256 with 8 heads, the only widths it is compiled for,
// trafficbotsv15_tpu/ops/pallas_knarpe.py _x3_fwd_kernel (:668-720, launched at :742), the forward of
// knarpe_cross_attention_v3. Contract as knarpe.cu's header says: B2's, with kk = x_j [W_k; W_rpe,k] + b_k rounded to
// bf16, q * kk rounded to bf16 and those products summed per head in float32; softmax, attn and the v half in
// float32. knarpe_staged.cuh keeps every shape it takes (the flagship's D = R = 128 up to K = 89); the general kernel
// of knarpe.cu the shapes both refuse (D = R = 128 at K >= 90, other widths).
//
// What bounds it. At the scaled eval shape (128 x 64 sources, K=89, D=R=256, H=8) a launch must read the targets and
// relative poses (89 x 1 KB per source) once: 756 MB with the rest, 0.226 ms at 3.35 TB/s; and its roundings need kk
// itself, a real [K, 512] x [512, 256] product per source, 191 GFLOP a launch, 0.19 ms at the tensor cores' 989
// TFLOP/s. Both bounds matter. B2's cluster kernel reassociates the logits as x (W_k q) and never forms k, so it does
// not carry over; the staged kernel keeps the whole bf16 [W_kv; W_rpe] (524,288 B) resident and refuses these widths;
// the general kernel accumulates 4 x 4 tiles of kk on the float32 CUDA cores with the weights through L1/L2, 113
// times its bound. Here:
//   - B3's heads are independent. Block b takes heads 2 qt, 2 qt + 1 (qt = b % 4) of the sources b / 4, b / 4 +
//     n_slots, ...: it keeps their 64 columns of [W_k; W_rpe,k] and of [W_v; W_rpe,v] over all 512 rows, 131,072 B
//     (rows XOR-swizzled), and needs nothing from the other three. The four blocks of a source run side by side in
//     the persistent grid, so x_j comes from device memory once and three times from L2;
//   - x = [tgt | rpe] does not fit beside the weights twice (91,136 B a source at K=89), so it streams in tiles of 32
//     targets, 32,768 B (eight 2-D tensor copies of 64 columns by 32 rows, the 128-byte swizzle), through a ring of
//     three stages that one producer thread refills as soon as a tile is consumed, across sources, and has L2 fetch
//     the tile three ahead (its quarter of the boxes, the other blocks of the source the rest). A tile that runs past
//     the source's K holds the next source's rows (or zeros past the tensor): their logits are masked, and the y step
//     reads the source's last row instead;
//   - per tile, two warps of the tile's stage form kk on the tensor cores (mma.sync.m16n8k16, bf16 operands, float32
//     sums; the bf16 products are exact, so only the order of the float32 sums differs from jnp.dot), one head each:
//     [32 targets x 32 columns] over the 512 rows, four k steps' fragments loaded first; then, as _x3_fwd_kernel,
//     + b_k, round to bf16, q * kk rounded to bf16, the 32 products of a head summed in float32, times the scale. The
//     same warp takes the tile's share of the softmax: its max m_t (a masked target, or one past K, counts as -1e9),
//     exp(logit - m_t) (0 where masked) and their sum s_t;
//   - four warps take the tiles in order, each on 128 columns of x, with no reduction in their chain: the running max
//     M and sum l (a tile that raises M rescales what came before by exp(M_old - M_new), and its own p by
//     exp(m_t - M_new); a source with no valid target ends with l = 0), then y_h += sum_j p_hj x_j as the product
//     P x with P = [P_hi; P_lo] (rows 0-1 the heads' bf16 hi halves, rows 8-9 their lo halves, p = hi + lo to 16
//     significant bits) and x by ldmatrix.trans;
//   - after a source's last tile, out_h = (y_h W_v[:, h]) / l_h + b_v,h (B2's reassociated v half): y from the
//     accumulators, split again into [Y_hi; Y_lo], straight into the A fragments of y W_v (the accumulator layout is
//     the operand layout), each warp on its 128 rows of W_v; the four partial outputs go through shared memory and
//     are summed in warp order, so results reach float32 level before the one rounding to bf16 at the output;
//   - mbarriers order everything: a stage's tensor copies (full), its tile's share of the softmax (lgt, by the two
//     kk warps), and its release by the four y warps (empty), after which the producer refills it. Nothing waits on a
//     whole-block barrier after the weights are in;
//   - the budget (a block may use 232,448 B): three stages 98,304 B, the weight quarter 131,072 B, exp(logit - m_t)
//     3 x 2 x 32 x 4 = 768 B and the tiles' max and sum 48 B, the partial outputs 4 x 64 x 4 = 1,024 B, nine
//     mbarriers 72 B, 1,024 B to align: 232,312 B, whatever K is: the ring is what streams, so no K is too large for
//     the shared memory.
// Decided by measurement (utils/ab_knarpe.py's B3 case against variants of this file, in turns, device time, on an
// H100 80GB HBM3 at 700 W): the four reads of x through L2 against one tensor copy multicast to a cluster of the
// four blocks, which ties their rings together (a stage is refilled once all four are done with it): 1.085 against
// 1.520 ms; one kk warp per tile on both heads, a quarter fewer shared-memory reads but half the warps: 1.227
// against 1.030 ms; the roles spread so that the sub-partitions carry equal shares of the products: 1.186 against
// 1.080 ms. The kernel is held back by the latency around its ring, not by shared-memory bytes or the tensor
// cores' rate: taking the softmax's reductions out of the y warps' chain (1.094 -> 1.035 ms) and the L2 prefetch
// (1.034 -> 0.996 ms) are what moved it.
// No atomics: every sum has a fixed order, so two launches on the same inputs give the same bits. A source with no
// valid target gets a zero output.

#pragma once

#include "knarpe_staged.cuh"

namespace heads_x3 {

using staged::kMask;
using staged::ldsm_x4;
using staged::ldsm_x4_t;
using staged::smem_u32;

constexpr int kHeads = 8, kWidth = 256;       // the widths it is compiled for: n_head, d_model = d_rpe
constexpr int kX = 2 * kWidth;                // columns of x_j = [tgt_j | rpe_j]
constexpr int kSplit = 4;                     // blocks per source, each on kHeads / kSplit heads
constexpr int kDQ = kWidth / kSplit;          // columns of k, v and out a block takes
constexpr int kDH = kWidth / kHeads;          // d_head
constexpr int kTile = 32;                     // targets per tile
constexpr int kSlots = 3;                     // tiles in the ring
constexpr int kPrefetch = 3;                  // the producer has L2 fetch the tile this many ahead of its copies
constexpr int kBox = kTile * 128;             // a tensor copy's box: 64 columns x 32 rows of bf16
constexpr int kSlotBytes = (kX / 64) * kBox;  // a tile: tgt's four boxes, then rpe's
constexpr int kWRow = 2 * kDQ * 2;            // bytes of a resident weight row: W_k's then W_v's 64 columns
constexpr int kKkWarps = 2 * kSlots;          // warp 2 i + e forms kk of stage i's tiles for head e
constexpr int kYWarps = 4;                    // the softmax, y and out warps, 128 columns of x each
constexpr int kYCols = kX / kYWarps;
constexpr int kWarps = kKkWarps + kYWarps + 1;  // and the producer warp
constexpr int kThreads = 32 * kWarps;
static_assert(kDQ == 64 && kDH == 32 && kYCols == 128, "a block's two heads are one 64-column box of k and v");

// Byte offsets from the block's 1024-byte aligned base in dynamic shared memory; kTotal counts the alignment's slack.
constexpr size_t kRing = 0;                                              // kSlots stages of kSlotBytes
constexpr size_t kW = kRing + static_cast<size_t>(kSlots) * kSlotBytes;  // [kX][kWRow]
constexpr size_t kLg = kW + static_cast<size_t>(kX) * kWRow;  // exp(logit - tile max) [stage][head][target] float32
constexpr size_t kStat = kLg + static_cast<size_t>(kSlots) * 2 * kTile * 4;  // tile max, tile sum [stage][head][2]
constexpr size_t kOpart = kStat + static_cast<size_t>(kSlots) * 2 * 2 * 4;  // partial outputs [y warp][kDQ]
constexpr size_t kBar = kOpart + static_cast<size_t>(kYWarps) * kDQ * 4;      // full, lgt, empty mbarriers
constexpr size_t kTotal = kBar + 3 * kSlots * 8 + 1024;

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::V3_HEADS_REFUSALS words each code (4, no block
// fits a multiprocessor, comes from the plan).
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (K < 1) return 1;
  if (!(D == kWidth && R == kWidth && H == kHeads)) return 2;
  if (kTotal > max_smem) return 3;
  return 0;
}

struct Params {
  CUtensorMap tm_t, tm_r;  // tgt and rpe [n_src K, 256]: boxes of 64 columns x kTile rows
  const __nv_bfloat16 *q, *w_kv, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16* out;
  int n_src, n_knn;
  float scale;
};

__device__ __forceinline__ void mbar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the box at columns c0, row c1 of map into L2 alone (no shared memory, nothing to wait for)
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void y_sync() {  // the y warps' own barrier
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * kYWarps) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1) knarpe_x3_heads_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: stages start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % kSplit, col0 = qt * kDQ;  // the block's quarter: heads 2 qt, 2 qt + 1
  const int n_slots = gridDim.x / kSplit, slot0 = blockIdx.x / kSplit;
  const int K = p.n_knn, n_tiles = (K + kTile - 1) / kTile;
  const uint32_t ring = smem_u32(smem + kRing), wsm = smem_u32(smem + kW), bar0 = smem_u32(smem + kBar);
  // stage i's mbarriers: its tile has landed (full), the tile's share of the softmax is written (lgt), the y warps are
  // done with it (empty)
  auto full = [&](int i) { return bar0 + 8 * i; };
  auto lgt = [&](int i) { return bar0 + 8 * (kSlots + i); };
  auto empty = [&](int i) { return bar0 + 8 * (2 * kSlots + i); };
  float* lg = reinterpret_cast<float*>(smem + kLg);
  float* stat = reinterpret_cast<float*>(smem + kStat);
  float* opart = reinterpret_cast<float*>(smem + kOpart);

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init_count(full(i), 1);
      mbar_init_count(lgt(i), 64);               // every thread of the stage's two kk warps
      mbar_init_count(empty(i), 32 * kYWarps);  // every thread of the y warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the weight quarter by cp.async: row i of [W_kv; W_rpe], W_k's 64 columns from col0 then W_v's (from 256 + col0),
  // 16-byte chunk c at c ^ (i & 7)
  for (int e = tid; e < kX * (kWRow / 16); e += kThreads) {
    const int i = e >> 4, c = e & 15;
    const __nv_bfloat16* row = i < kWidth ? p.w_kv + static_cast<size_t>(i) * 2 * kWidth
                                          : p.w_rpe + static_cast<size_t>(i - kWidth) * 2 * kWidth;
    staged::cp_async16(wsm + i * kWRow + ((c ^ (i & 7)) << 4), row + (c < 8 ? 0 : kWidth) + col0 + 8 * (c & 7));
  }
  staged::cp_wait_all();
  __syncthreads();

  // The block's tile tau is tile t = tau % n_tiles of its source n = tau / n_tiles, in stage tau % kSlots, that
  // stage's (tau / kSlots)-th fill. mma fragments: row group g, column pair tq; ldmatrix rows r16, chunk half hb
  const int g = lane >> 2, tq = lane & 3, r16 = lane & 15, hb = lane >> 4;

  if (warp == kWarps - 1) {  // the producer: one thread keeps the ring full, across sources
    if (lane == 0) {
      for (int tau = 0;; ++tau) {
        const int n = tau / n_tiles, t = tau - n * n_tiles, s = slot0 + n * n_slots, i = tau % kSlots;
        if (s >= p.n_src) break;
        if (tau >= kSlots) staged::mbar_wait(empty(i), ((tau / kSlots) - 1) & 1);
        staged::fence_proxy_async();
        staged::mbar_expect(full(i), kSlotBytes);
        const uint32_t dst = ring + i * kSlotBytes;
        const int row = s * K + kTile * t;
#pragma unroll
        for (int b = 0; b < kX / 64; ++b)
          staged::tma_load_2d(dst + b * kBox, b < 4 ? &p.tm_t : &p.tm_r, 64 * (b & 3), row, full(i));
        // the tile kPrefetch ahead into L2, this block's quarter of its boxes (the four blocks of a source share
        // them), so that its copies find it there
        const int ta = tau + kPrefetch, na = ta / n_tiles, sa = slot0 + na * n_slots;
        if (sa < p.n_src)
          for (int b = 2 * qt; b < 2 * qt + 2; ++b)
            tma_prefetch_2d(b < 4 ? &p.tm_t : &p.tm_r, 64 * (b & 3), sa * K + kTile * (ta - na * n_tiles));
      }
    }
    return;
  }

  if (warp < kKkWarps) {
    // kk of stage i's tiles for head e of the block: A = the staged rows (two 16-row tiles), B = W_k's 32 columns of
    // the head (four n tiles), 32 k steps, four at a time, loads first
    const int i = warp >> 1, e = warp & 1;
    uint32_t xa[4];  // chunk 2 t + hb of a row, swizzled (every row a lane addresses is lane mod 8)
#pragma unroll
    for (int t = 0; t < 4; ++t) xa[t] = static_cast<uint32_t>((2 * t + hb) ^ (lane & 7)) << 4;
    const uint32_t wb0 = static_cast<uint32_t>((4 * e + hb) ^ (lane & 7)) << 4;
    const uint32_t wb1 = static_cast<uint32_t>((4 * e + 2 + hb) ^ (lane & 7)) << 4;
    const uint32_t xrow = ring + i * kSlotBytes + r16 * 128, wrow = wsm + r16 * kWRow;
    float bk[4][2];  // b_k of this lane's columns 8 ni + 2 tq + c of the head
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(p.bias + col0 + kDH * e + 8 * ni + 2 * tq);
      bk[ni][0] = __low2float(v);
      bk[ni][1] = __high2float(v);
    }
    for (int tau = i;; tau += kSlots) {
      const int n = tau / n_tiles, t = tau - n * n_tiles, s = slot0 + n * n_slots;
      if (s >= p.n_src) break;
      // the head's q and this lane's four targets' mask, loaded before the wait
      float qv[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            p.q + static_cast<size_t>(s) * kWidth + col0 + kDH * e + 8 * ni + 2 * tq);
        qv[ni][0] = __low2float(v);
        qv[ni][1] = __high2float(v);
      }
      bool masked[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = kTile * t + 16 * mi + g + 8 * hr;
          masked[mi][hr] = j >= K || p.invalid[static_cast<size_t>(s) * K + j] != 0;
        }
      staged::mbar_wait(full(i), (tau / kSlots) & 1);
      float acc[2][4][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kX / 16; k0 += 4) {
        const uint32_t xb = xrow + (k0 >> 2) * kBox, wr = wrow + 16 * k0 * kWRow;
        uint32_t a[4][2][4], b[4][2][4];
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          ldsm_x4(a[t4][0], xb + xa[t4]);
          ldsm_x4(a[t4][1], xb + 16 * 128 + xa[t4]);
          ldsm_x4_t(b[t4][0], wr + 16 * t4 * kWRow + wb0);
          ldsm_x4_t(b[t4][1], wr + 16 * t4 * kWRow + wb1);
        }
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              staged::mma_bf16(acc[mi][2 * np], a[t4][mi], b[t4][np][0], b[t4][np][1]);
              staged::mma_bf16(acc[mi][2 * np + 1], a[t4][mi], b[t4][np][2], b[t4][np][3]);
            }
      }
      // + b_k, round kk, round q * kk, sum per head in float32 (as _x3_fwd_kernel): this lane's 8 columns, then
      // the four lanes of a row; each lane then holds the logits of its four rows
      float lgv[2][2], m = kMask;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float sum = 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float kk = staged::round_bf16(acc[mi][ni][2 * hr + c] + bk[ni][c]);
              sum += staged::round_bf16(qv[ni][c] * kk);
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          lgv[mi][hr] = sum * p.scale;
          m = fmaxf(m, masked[mi][hr] ? kMask : lgv[mi][hr]);
        }
      // the tile's share of the softmax, so that the y warps' chain has no reduction in it: its max m_t over the 32
      // targets (a masked one counts as -1e9), exp(logit - m_t) (0 where masked) and their sum
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float pt = masked[mi][hr] ? 0.f : expf(lgv[mi][hr] - m);
          sum += pt;
          if (tq == 0) lg[(2 * i + e) * kTile + 16 * mi + g + 8 * hr] = pt;
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        stat[(2 * i + e) * 2] = m;
        stat[(2 * i + e) * 2 + 1] = sum;
      }
      mbar_arrive(lgt(i));
    }
    return;
  }

  // The y warps: the online softmax, y on the warp's 128 columns of x, and after a source's last tile its out
  const int yw = warp - kKkWarps, c0 = kYCols * yw;
  const int d_out = 32 * yw + lane;  // the output column this thread writes (yw < 2)
  const float bv = d_out < kDQ ? __bfloat162float(p.bias[kWidth + col0 + d_out]) : 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[16][4] = {};  // y as P x: n tile nt covers columns c0 + 8 nt; rows g (hi part) and g + 8 (lo part)
  for (int tau = 0;; ++tau) {
    const int n = tau / n_tiles, t = tau - n * n_tiles, s = slot0 + n * n_slots, i = tau % kSlots;
    if (s >= p.n_src) break;
    const uint32_t parity = (tau / kSlots) & 1;
    staged::mbar_wait(lgt(i), parity);   // the tile's share of the softmax is written
    staged::mbar_wait(full(i), parity);  // (and its rows landed, which the kk warps waited for)
    // the online softmax for both heads, the same in every y warp: the running max M and sum l from the tile's max m_t
    // and sum s_t; the tile's p = exp(logit - m_t) exp(m_t - M)
    float alpha[2], beta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_t = stat[(2 * i + h) * 2], m = fmaxf(m_run[h], m_t);
      alpha[h] = expf(m_run[h] - m);
      beta[h] = expf(m_t - m);
      l_run[h] = l_run[h] * alpha[h] + stat[(2 * i + h) * 2 + 1] * beta[h];
      m_run[h] = m;
    }
    // A fragments of P [16 x 32 targets]: row h = the hi half of head h's p, row 8 + h its lo half (h < 2), rows of
    // lanes g >= 2 zero; targets 16 ks + 2 tq (+1) and + 8 (+9)
    const float* pt = lg + (2 * i + (g & 1)) * kTile + 2 * tq;
    const float bt = g & 1 ? beta[1] : beta[0];
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 v = *reinterpret_cast<const float2*>(pt + 16 * ks + 8 * half);
        uint32_t hi, lo;
        staged::split2(v.x * bt, v.y * bt, hi, lo);
        a[ks][2 * half] = g < 2 ? hi : 0u;
        a[ks][2 * half + 1] = g < 2 ? lo : 0u;
      }
    const float al = g & 1 ? alpha[1] : alpha[0];  // rows g and g + 8 are head g's (zero for g >= 2)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] *= al;
    // y += P x: B = x (k = target j, n = column) by ldmatrix.trans of the staged rows; rows past the source's K
    // read its last row (p is 0 there; the row holds this source's data)
    const int rows = K - kTile * t;
    const uint32_t xs = ring + i * kSlotBytes;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int j = min(16 * ks + r16, rows - 1);
      const uint32_t xr = xs + j * 128, sw = static_cast<uint32_t>(j & 7);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        const int col = c0 + 16 * np;
        uint32_t b[4];
        ldsm_x4_t(b, xr + (col >> 6) * kBox + (((((col & 63) >> 3) + hb) ^ sw) << 4));
        staged::mma_bf16(acc[2 * np], a[ks], b[0], b[1]);
        staged::mma_bf16(acc[2 * np + 1], a[ks], b[2], b[3]);
      }
    }
    mbar_arrive(empty(i));
    if (t != n_tiles - 1) continue;

    // out^T partial of the warp's 128 rows: y_h (lane g = h: rows g and g + 8 summed) split into [Y_hi; Y_lo] as
    // the A fragments of y W_v (rows h hi, 8 + h lo), B = W_v's 64 columns by ldmatrix.trans of the weight rows
    float o[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kYCols / 16; ++ks) {
      uint32_t hi0, lo0, hi1, lo1;
      staged::split2(acc[2 * ks][0] + acc[2 * ks][2], acc[2 * ks][1] + acc[2 * ks][3], hi0, lo0);
      staged::split2(acc[2 * ks + 1][0] + acc[2 * ks + 1][2], acc[2 * ks + 1][1] + acc[2 * ks + 1][3], hi1, lo1);
      const uint32_t af[4] = {g < 2 ? hi0 : 0u, g < 2 ? lo0 : 0u, g < 2 ? hi1 : 0u, g < 2 ? lo1 : 0u};
      const uint32_t wr = wsm + (c0 + 16 * ks + r16) * kWRow;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, wr + (static_cast<uint32_t>((8 + 2 * np + hb) ^ (lane & 7)) << 4));
        staged::mma_bf16(o[2 * np], af, b[0], b[1]);
        staged::mma_bf16(o[2 * np + 1], af, b[2], b[3]);
      }
    }
    // column d = 8 nt + 2 tq + c lies in head nt / 4: its hi row (lane g = head) plus its lo row
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (g == (nt >> 2)) {
        opart[yw * kDQ + 8 * nt + 2 * tq] = o[nt][0] + o[nt][2];
        opart[yw * kDQ + 8 * nt + 2 * tq + 1] = o[nt][1] + o[nt][3];
      }
    y_sync();  // every y warp's partial is in
    if (d_out < kDQ) {
      float v = opart[d_out];
#pragma unroll
      for (int w = 1; w < kYWarps; ++w) v += opart[w * kDQ + d_out];
      const float l = d_out < kDH ? l_run[0] : l_run[1];
      p.out[static_cast<size_t>(s) * kWidth + col0 + d_out] = __float2bfloat16_rn(l > 0.f ? v / l + bv : 0.f);
    }
    y_sync();  // the partials are read before the next source's are written
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[h] = -INFINITY;
      l_run[h] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
  }
}

}  // namespace heads_x3
