// The bf16 KNARPE KNN self-attention forward B4 at the scaled preset's widths (D = R = 256, 8 heads): four
// blocks per source, each on two of the eight heads, with no exchange between them.
//
// Replaces, for bf16 operands at d_model = d_rpe = 256 with 8 heads, the only widths it is compiled for,
// trafficbotsv15_tpu/ops/pallas_knarpe.py _fwd_kernel (:99-125, launched at :243), the forward of
// knarpe_attention. Contract as knarpe.cu's header says: k and v are rows of D at stride ld_kv (the halves of
// one [.., 2D] tensor, or two tensors). knarpe_attn_staged.cuh keeps every shape it takes (up to 4 heads: the
// flagship's D = R = 128); the general kernel of knarpe.cu the shapes both refuse (K > 40 here).
//
// Its bound is the bytes. At the scaled eval path's shape (4 x 1024 sources, K=32, D=R=256, H=8) a launch
// must read k, v and rpe (32 x 1.5 KB per source), q, the mask and the weights and write out: 205.9 MB,
// 0.0615 ms at 3.35 TB/s. The staged kernel keeps the whole bf16 W_rpe [R, 2D] resident; here that is
// 262,144 B against the 232,448 B a block may use, and its [U_hi | U_lo] takes 2H <= 8 columns, so it refuses
// the shape; the general kernel (one source at a time per block, k and rpe read one bf16 per lane, float32 FMA,
// W_rpe through L1/L2) takes what both refuse. B4's heads are independent: with u_h = W_k[:, h] q_h and
// y_h = sum_j a_hj rpe_j (knarpe.cu's reassociation),
//   q_h . (k_jh + rpe_k,jh) = rpe_j . u_h + k_jh . q_h + b_k,h . q_h,
//   out_h = y_h W_v[:, h] + sum_j a_hj v_jh + b_v,h sum_j a_hj,
// so a block that holds the W_rpe columns of two heads (its quarter: [W_k | W_v][:, 64 qt .. 64 qt + 64), all
// R rows, 65,536 B) computes their 64 columns of out from q, k and v's same 64 columns and all of rpe, alone:
//   - block b takes quarter qt = b % 4 of the sources b / 4, b / 4 + n_slots, ...: the four quarters of a source
//     run on neighbouring blocks of the persistent grid at the same pace, so each rpe row comes from device
//     memory once and three times from L2 (the live window, a few hundred sources, is a few MB of the 50 MB
//     L2). An exchange between the blocks (the cluster split of knarpe_cluster.cuh, by rows of W_rpe) would
//     cost a cluster barrier and the partial logits and outputs per source; this needs none;
//   - inside a block, knarpe_attn_staged.cuh's scheme at D' = 64, H' = 2: n_groups groups of four warps (five
//     up to K=32, four up to K=40: as many stages as the shared memory holds, and 640 threads use the register
//     file up), group c on the block's sources c, c + n_groups, ..., each in its own stage, which the group
//     refills itself in three parts, each on its own mbarrier: q's quarter (a bulk copy) once its logits step
//     is done (q's fragments stay in registers), k's quarter and rpe (2-D tensor copies: boxes of 64 columns
//     by K rows, the 128-byte swizzle) once its y step has read them, v's quarter after its out step; so the
//     group's next source lands while it computes this one. Steps are closed by the group's own named barrier,
//     five a source;
//   - every product on mma.sync.m16n8k16 (bf16 operands, float32 sums); the float32 u, attn and y split into
//     bf16 hi + lo, both halves through the product, so results reach float32 level before the one rounding to
//     bf16 at the output. Per source and block (columns of an n=8 tile: hi h0, hi h1, lo h0, lo h1, 0 x 4):
//       u     = W_k Q, Q [64, 8] the head-masked q quarter -> [U_hi | U_lo] [R][8]; c_h = b_k,h . q_h;
//       lgt   = rpe [U_hi | U_lo] + k Q, per 16 targets in two halves of the k steps (one warp each, the
//               partials summed in a fixed order by the softmax); a row past K - 1 reads other bytes of the
//               group's stage and its logit is dropped (a row of the product depends on its row of A alone);
//       softmax over K per head (a warp per head) -> [A_hi; A_lo] [8][K];
//       y^T   = rpe^T [A_hi; A_lo]^T (16 rows of R a tile: a quarter of the products of y = A rpe, whose 16 rows
//               would hold 4) -> [Y_hi | Y_lo] [R][8];
//       out^T = W_v^T [Y_hi | Y_lo] + v^T [A_hi; A_lo]^T (a warp per 16 columns d, all in one head), column h hi
//               + column 2 + h lo, + b_v Σa;
//     the loops run over compile-time widths, so a step is a few unrolled k steps a warp. What sets the time is
//     inside the SM, not device memory: per source and block the warps read 128 KB of shared memory by
//     ldmatrix (both weight halves, 64 KB; rpe twice; [Y_hi | Y_lo] by all four warps of the out step), and
//     each step is a short chain of dependent loads and products closed by a barrier, so the groups side by
//     side are what hides the latency. The addresses are lane constants plus compile-time offsets (every row
//     a lane addresses is lane mod 8, so the swizzle is too), a target tile's rows clamped to K - 1 only where
//     the tile passes K (the y and out steps: A is 0 there, the row must be data); the softmax warps load the
//     group's next mask a source ahead;
//   - the budget at K=32 (a block may use 232,448 B): a stage 25,600 B (six boxes of 4,096 B, q's quarter
//     128 B, rounded up to the 1,024 B the swizzle needs), five stages 128,000 B; the W_rpe quarter 65,536 B and
//     its bias 256 B; per group 5,280 B ([U_hi | U_lo] then [Y_hi | Y_lo] 4,096 B, the two partial logits 512 B,
//     [A_hi; A_lo] 640 B (8 rows of K padded to 32, + 8 so that rows fall on distinct banks), three per-head
//     scalars 24 B), five groups 26,400 B; the mbarriers 160 B (three a stage, 32 B apart); 1,024 B to align:
//     221,376 B. From K=33 the boxes take 5,120 B and five stages no longer fit (253,456 B); four do up to K=40
//     (216,576 B). From K=41 a box takes 6,144 B and four stages no longer fit either (241,216 B).
// No atomics: every sum has a fixed order, so two launches on the same inputs give the same bits. A source
// with no valid target gets a zero output.

#pragma once

#include "knarpe_staged.cuh"

namespace heads_attn {

using staged::a16;
using staged::a1024;
using staged::box_bytes;
using staged::kMask;
using staged::ldsm_x2;
using staged::ldsm_x2_t;
using staged::ldsm_x4;
using staged::ldsm_x4_t;
using staged::pad16;
using staged::smem_u32;

constexpr int kHeads = 8, kWidth = 256;  // the widths it is compiled for: n_head, d_model = d_rpe
constexpr int kSplit = 4;                // blocks per source, each on kHeads / kSplit heads
constexpr int kDQ = kWidth / kSplit;     // columns of q, k, v and out a block takes: one 64-column box
constexpr int kHQ = kHeads / kSplit;     // heads a block takes
constexpr int kDH = kWidth / kHeads;     // d_head
// groups of warps a block runs: as many as the shared memory holds stages for, from kMinGroups to kMaxGroups
constexpr int kMinGroups = 4, kMaxGroups = 5, kGroupWarps = 4;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kMaxThreads = kMaxGroups * kGroupThreads;
constexpr int kMaxK = 128;  // the softmax keeps K / 32 targets per lane in registers
constexpr int kRBoxes = kWidth / 64;
constexpr int kWRow = 2 * kDQ * 2;  // bytes of a resident weight row: [W_k | W_v] quarter
static_assert(kDQ == 64 && kHQ == 2 && kDH == 32, "a quarter is one tensor-copy box of two 32-column heads");

// Byte offsets from the block's 1024-byte aligned base in dynamic shared memory (total counts the alignment's
// slack): the groups' stages (a stage's fields k, v, r: boxes of box bytes; q: offsets inside it), the resident
// weight quarter and bias, the groups' scratch (gu, glg, ga, ghv: offsets inside a group's) and the mbarriers.
struct Layout {
  int n_groups;
  size_t box, k, v, r, q, slot_bytes, w, bias, grp, grp_bytes, gu, glg, ga, ghv, bar, total;
};

inline Layout make_layout(int K, int n_groups) {
  Layout L{};
  L.n_groups = n_groups;
  L.box = box_bytes(K);
  L.k = 0;
  L.v = L.box;
  L.r = 2 * L.box;
  L.q = L.r + kRBoxes * L.box;
  L.slot_bytes = a1024(L.q + kDQ * 2);
  size_t off = n_groups * L.slot_bytes;
  L.w = off;    off += static_cast<size_t>(kWidth) * kWRow;
  L.bias = off; off += 2 * kDQ * 2;
  L.gu = 0;                                                    // [U_hi | U_lo] [R][8], later [Y_hi | Y_lo]
  L.glg = static_cast<size_t>(kWidth) * 8 * 2;                 // partial logits [2][kHQ][K]
  L.ga = L.glg + a16(static_cast<size_t>(2) * kHQ * K * 4);    // [A_hi; A_lo; 0] [8][pad16(K) + 8]
  L.ghv = L.ga + static_cast<size_t>(8) * (pad16(K) + 8) * 2;  // c, sum attn, no-valid flag per head
  L.grp_bytes = a16(L.ghv + static_cast<size_t>(3) * kHQ * 4);
  L.grp = off;  off += n_groups * L.grp_bytes;
  L.bar = off;  off += static_cast<size_t>(32) * n_groups;  // per stage three mbarriers: its three parts
  L.total = off + 1024;
  return L;
}

// The most groups, kMinGroups to kMaxGroups, whose layout fits max_smem, or 0 if kMinGroups do not fit.
inline int group_count(int K, size_t max_smem) {
  for (int n = kMaxGroups; n >= kMinGroups; --n)
    if (make_layout(K, n).total <= max_smem) return n;
  return 0;
}

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::HEADS_REFUSALS words each code (4, no block
// fits a multiprocessor, comes from the plan).
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (K < 1 || K > kMaxK) return 1;
  if (!(D == kWidth && R == kWidth && H == kHeads)) return 2;
  if (group_count(K, max_smem) == 0) return 3;
  return 0;
}

struct Params {
  CUtensorMap tm_k, tm_v, tm_r;  // k, v (rows of D at stride ld_kv) and rpe [n_src K, R]: boxes of 64 x K
  const __nv_bfloat16 *q, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16* out;
  int n_src, n_knn;
  float scale;
  Layout L;
};

// shared address of 16-byte chunk c of row j in the boxes at shared address region
__device__ __forceinline__ uint32_t x_addr(uint32_t box, uint32_t region, int j, int c) {
  return region + (c >> 3) * box + j * 128 + (((c & 7) ^ (j & 7)) << 4);
}
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(kGroupThreads) : "memory");
}

// cp.async of the block's quarter of W_rpe (row i: W_k's then W_v's 64 columns from col0, 16-byte chunks
// XOR-swizzled by i & 7) and of the bias by every thread; the caller waits (cp_wait_all) and synchronises
__device__ __forceinline__ void load_weights(const __nv_bfloat16* w_rpe, const __nv_bfloat16* bias, int col0,
                                             uint32_t w, uint32_t b, int tid, int n_threads) {
  constexpr int kChunks = kWRow / 16;  // 8 of W_k, 8 of W_v
  for (int e = tid; e < kWidth * kChunks; e += n_threads) {
    const int i = e / kChunks, c = e % kChunks;
    const int col = (c < kChunks / 2 ? col0 : kWidth + col0) + 8 * (c % (kChunks / 2));
    staged::cp_async16(w + i * kWRow + ((c ^ (i & 7)) << 4), w_rpe + static_cast<size_t>(i) * 2 * kWidth + col);
  }
  if (tid < kChunks) {
    const int col = (tid < kChunks / 2 ? col0 : kWidth + col0) + 8 * (tid % (kChunks / 2));
    staged::cp_async16(b + tid * 16, bias + col);
  }
}

// The stage's parts, each on its own mbarrier 8 bytes apart: the quarter of q, read by the u step; the quarter of
// k and all of rpe, read by the logits and y steps; the quarter of v, read by the out step
enum Part { kPartQ = 0, kPartKR = 1, kPartV = 2 };

// Part `part` of source s into the stage at slot, by tensor copies (q by a bulk copy), counted on bar
__device__ __forceinline__ void stage_part(const Params& p, uint32_t slot, uint32_t bar, int s, int col0, int part) {
  const int K = p.n_knn;
  if (part == kPartQ) {
    staged::mbar_expect(bar, kDQ * 2);
    staged::bulk_copy(slot + static_cast<uint32_t>(p.L.q), p.q + static_cast<size_t>(s) * kWidth + col0, kDQ * 2,
                      bar);
  } else if (part == kPartV) {
    staged::mbar_expect(bar, static_cast<uint32_t>(K * 128));
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.v), &p.tm_v, col0, s * K, bar);
  } else {
    staged::mbar_expect(bar, static_cast<uint32_t>((1 + kRBoxes) * K * 128));
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.k), &p.tm_k, col0, s * K, bar);
    for (int b = 0; b < kRBoxes; ++b)
      staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.r + b * p.L.box), &p.tm_r, 64 * b, s * K, bar);
  }
}


__global__ void __launch_bounds__(kMaxThreads, 1) knarpe_attn_heads_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: stages start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / kGroupWarps, wg = warp % kGroupWarps, gt = tid % kGroupThreads, n_groups = p.L.n_groups;
  const int qt = blockIdx.x % kSplit, col0 = qt * kDQ;  // the block's quarter: heads 2 qt, 2 qt + 1
  const int n_slots = gridDim.x / kSplit, slot0 = blockIdx.x / kSplit;
  auto source = [&](int n) { return slot0 + n * n_slots; };  // the block's n-th source
  const int K = p.n_knn, n_mk = pad16(K) / 16, lda = pad16(K) + 8;
  const uint32_t box = static_cast<uint32_t>(p.L.box);
  const uint32_t slot = smem_u32(smem) + grp * static_cast<uint32_t>(p.L.slot_bytes);  // the group's stage
  const uint32_t xk = slot + static_cast<uint32_t>(p.L.k), xv = slot + static_cast<uint32_t>(p.L.v);
  const uint32_t xr = slot + static_cast<uint32_t>(p.L.r);
  const uint32_t wsm = smem_u32(smem + p.L.w);
  const uint32_t bar = smem_u32(smem + p.L.bar) + 32 * grp;  // the stage's part x at bar + 8 x

  if (gt == 0) {  // the group's stage barriers and its first source
    for (int part = kPartQ; part <= kPartV; ++part) staged::mbar_init(bar + 8 * part);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int part = kPartQ; part <= kPartV && source(grp) < p.n_src; ++part)
      stage_part(p, slot, bar + 8 * part, source(grp), col0, part);
  }
  load_weights(p.w_rpe, p.bias, col0, wsm, smem_u32(smem + p.L.bias), tid, blockDim.x);
  // the groups' scratch starts at zero: the padding of [U | .], [Y | .] and [A; .] stays so
  for (int e = tid; e < static_cast<int>(n_groups * p.L.grp_bytes / 16); e += blockDim.x)
    reinterpret_cast<uint4*>(smem + p.L.grp)[e] = make_uint4(0u, 0u, 0u, 0u);
  staged::cp_wait_all();
  __syncthreads();

  // mma fragments: row group g and column pair tq; ldmatrix rows r16 and chunk half hb (A, B by rows), arow and
  // hb2 (A by .trans: rows j or i of the stored matrix, chunk d)
  const int g = lane >> 2, tq = lane & 3, r16 = lane & 15, hb = lane >> 4;
  const int arow = (lane & 7) + 8 * (lane >> 4), hb2 = (lane >> 3) & 1;
  // every ldmatrix row a lane addresses is lane mod 8 (rows 16 m + r16, or 16 m + arow unless clamped to K - 1), so
  // the 128-byte swizzle of chunk c is c ^ (lane & 7) with lane constants: xa[t] for chunk 2 t + hb (by rows), xw
  // for chunk 2 wg + hb2 (.trans; the warp's 16 columns in every 64-column box)
  uint32_t xa[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) xa[t] = static_cast<uint32_t>((2 * t + hb) ^ (lane & 7)) << 4;
  const uint32_t xw = static_cast<uint32_t>((2 * wg + hb2) ^ (lane & 7)) << 4;
  const uint32_t wrow = wsm + (16 * wg + r16) * kWRow;  // the u step's weight rows
  const uint32_t xr_row = xr + r16 * 128, xk_row = xk + r16 * 128;  // the logits step's rpe and k rows
  uint32_t yrow[kRBoxes];  // the y step's rpe rows arow, chunk 2 wg + hb2, of each box
#pragma unroll
  for (int t = 0; t < kRBoxes; ++t) yrow[t] = xr + t * box + arow * 128 + xw;
  const uint32_t vrow = xv + arow * 128 + xw;  // the out step's v rows
  const int n_full = K / 16;  // 16-target tiles without a row past K - 1
  unsigned char* gs = smem + p.L.grp + grp * p.L.grp_bytes;
  __nv_bfloat16* ub = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gu);  // [U_hi | U_lo] [R][8], later [Y_hi | Y_lo]
  const uint32_t uaddr = smem_u32(ub);
  float* lg = reinterpret_cast<float*>(gs + p.L.glg);  // [part][h][j]
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(gs + p.L.ga);  // [8][lda]: A_hi row h, A_lo row 2 + h, 0
  const uint32_t a_b = smem_u32(ab + (lane & 7) * lda + 8 * hb2);  // this lane's row of a B fragment of A^T
  float* cvec = reinterpret_cast<float*>(gs + p.L.ghv);
  float* asum = cvec + kHQ;
  float* nvh = cvec + 2 * kHQ;
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // [b_k | b_v] quarters
  constexpr int kR = kMaxK / 32;
  // the softmax warps' mask bytes, target lane + 32 r, of the group's next source: loaded a source ahead, so the
  // load's latency passes while the group computes
  unsigned char inv_raw[kR] = {};
  auto fetch_mask = [&](int s) {
    if (wg < kHQ && s < p.n_src) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        inv_raw[r] = j < K ? p.invalid[static_cast<size_t>(s) * K + j] : 0;
      }
    }
  };
  fetch_mask(source(grp));

  for (int it = 0, n = grp; source(n) < p.n_src; ++it, n += n_groups) {
    const int s = source(n);
    const uint32_t parity = it & 1;
    uint32_t inv_bits = 0;  // the softmax warp's mask: bit r for target lane + 32 r
#pragma unroll
    for (int r = 0; r < kR; ++r) inv_bits |= (inv_raw[r] != 0 ? 1u : 0u) << r;
    fetch_mask(source(n + n_groups));
    const bool refill = source(n + n_groups) < p.n_src;  // the group's next source, into the same stage
    staged::mbar_wait(bar + 8 * kPartQ, parity);  // q of this source has landed
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(smem + grp * p.L.slot_bytes + p.L.q);
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qb);
    // B fragments of the head-masked q (column g = head g): k step ks covers columns 16 ks.., in head ks / 2
    uint32_t qf0[4], qf1[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bool mine = g == ks / 2;
      qf0[ks] = mine ? q2[8 * ks + tq] : 0u;
      qf1[ks] = mine ? q2[8 * ks + 4 + tq] : 0u;
    }

    // 1. u[i][h] = W_k[i, head h] . q_h: a warp per four 16-row tiles (wg + 4 t), two at a time, their four k
    //    steps loaded first (two chains of sums a tile); u split into [U_hi | U_lo]. Then c[h] = b_k,h . q_h
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2) {
      uint32_t af[2][4][4];
      float acc[2][2][4] = {};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t row = wrow + 16 * (8 * t2 + 4 * t) * kWRow;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldsm_x4(af[t][ks], row + xa[ks]);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int t = 0; t < 2; ++t) staged::mma_bf16(acc[t][ks & 1], af[t][ks], qf0[ks], qf1[ks]);
      if (tq == 0) {  // columns 0 and 1 (heads 0 and 1); the others are 0
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 16 * (wg + 8 * t2 + 4 * t) + g + 8 * hr;
            uint32_t hi, lo;
            staged::split2(acc[t][0][2 * hr] + acc[t][1][2 * hr], acc[t][0][2 * hr + 1] + acc[t][1][2 * hr + 1], hi,
                           lo);
            *reinterpret_cast<uint32_t*>(ub + i * 8) = hi;
            *reinterpret_cast<uint32_t*>(ub + i * 8 + 2) = lo;
          }
      }
    }
    if (wg < kHQ) {
      float c = __bfloat162float(bias[wg * kDH + lane]) * __bfloat162float(qb[wg * kDH + lane]);
      c = staged::warp_sum(c);
      if (lane == 0) cvec[wg] = c;
    }
    group_sync(grp);
    staged::mbar_wait(bar + 8 * kPartKR, parity);  // k and rpe of this source have landed

    // 2. logits per 16 targets and half of the k steps (item = 2 mt + half): rpe_j . u_h over rpe's columns
    //    [128 half, 128 half + 128) (A = the staged rpe rows, B = [U_hi | U_lo]) plus k_jh . q_h over head half's
    //    32 columns of k (A = the staged k rows, B = the head-masked q), four k steps loaded at a time
    for (int item = wg; item < 2 * n_mk; item += kGroupWarps) {
      const int mt = item >> 1, half = item & 1;
      // rows 16 mt + r16 unclamped: a row past K - 1 reads other bytes of the group's stage, and its logits are
      // dropped (a row of the product depends on its own row of A alone)
      const uint32_t rbase = xr_row + 2 * half * box + 2048 * mt;
      const uint32_t ubase = uaddr + (128 * half + r16) * 16;
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < 8; k0 += 4) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {  // k step 8 half + k0 + t: chunk 2 t + hb of rpe box 2 half + k0 / 4
          ldsm_x4(a[t], rbase + (k0 / 4) * box + xa[t]);
          ldsm_x2_t(b[t], ubase + 16 * (k0 + t) * 16);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) staged::mma_bf16(acc[t & 1], a[t], b[t][0], b[t][1]);
      }
      {
        uint32_t a[2][4];  // chunk 4 half + 2 t + hb of k's box
#pragma unroll
        for (int t = 0; t < 2; ++t) ldsm_x4(a[t], xk_row + 2048 * mt + (xa[t] ^ (half << 6)));
#pragma unroll
        for (int t = 0; t < 2; ++t)
          staged::mma_bf16(acc[t], a[t], half ? qf0[2 + t] : qf0[t], half ? qf1[2 + t] : qf1[t]);
      }
      // column e (hi of head e, plus k . q) in lane tq = 0, column 2 + e (lo) in lane tq = 1
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[0][2 * hr + e] + acc[1][2 * hr + e];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          if (tq == 0 && row < K) lg[(half * kHQ + e) * K + row] = v;
        }
      }
    }
    group_sync(grp);
    if (gt == 0 && refill) {  // q is read (its fragments are in registers): the group's next q streams in
      staged::fence_proxy_async();
      stage_part(p, slot, bar + 8 * kPartQ, source(n + n_groups), col0, kPartQ);
    }

    // 3. masked softmax over K, one warp per head, target lane + 32 r in registers (as
    //    pallas_knarpe.py:_fwd_core); attn as rows h (hi) and 2 + h (lo) of A
    if (wg < kHQ) {
      const float c = cvec[wg];
      float lv[kR];
      float m = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        const bool ok = j < K && !((inv_bits >> r) & 1u);
        lv[r] = ok ? (lg[wg * K + j] + lg[(kHQ + wg) * K + j] + c) * p.scale : -INFINITY;
        m = fmaxf(m, ok ? lv[r] : kMask);
      }
      m = staged::warp_max(m);
      float den = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        lv[r] = lv[r] == -INFINITY ? 0.f : expf(lv[r] - m);
        den += lv[r];
      }
      den = staged::warp_sum(den);
      const bool no_valid = den <= 0.f;
      const float rden = no_valid ? 1.f : 1.f / den;
      float as = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        if (j < K) {
          const float a = lv[r] * rden;
          const __nv_bfloat16 hi = __float2bfloat16_rn(a);
          ab[wg * lda + j] = hi;
          ab[(kHQ + wg) * lda + j] = __float2bfloat16_rn(a - __bfloat162float(hi));
          as += a;
        }
      }
      as = staged::warp_sum(as);
      if (lane == 0) {
        asum[wg] = as;
        nvh[wg] = no_valid ? 1.f : 0.f;
      }
    }
    group_sync(grp);

    // 4. y^T[i][n] = sum_j rpe_j[i] A[n][j]: a warp per four 16-row tiles of R (wg + 4 t), A = rpe^T (the staged
    //    rpe rows by ldmatrix.trans), B = [A_hi; A_lo]^T, shared by the four; column e (hi of head e) in lane
    //    tq = 0 and 2 + e (lo) in lane tq = 1 summed, then split again into [Y_hi | Y_lo]
    {
      float acc[4][4] = {};
      auto y_step = [&](int ks, const uint32_t (&addr)[4]) {
        uint32_t b[2], a[4][4];
        ldsm_x2(b, a_b + 32 * ks);
#pragma unroll
        for (int t = 0; t < 4; ++t) ldsm_x4_t(a[t], addr[t]);
#pragma unroll
        for (int t = 0; t < 4; ++t) staged::mma_bf16(acc[t], a[t], b[0], b[1]);
      };
      for (int ks = 0; ks < n_full; ++ks) {
        uint32_t addr[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) addr[t] = yrow[t] + 2048 * ks;
        y_step(ks, addr);
      }
      if (n_full < n_mk) {  // the last tile, its rows past K - 1 clamped to K - 1 (A is 0 there; the row is data)
        const int j = min(16 * n_full + arow, K - 1);
        uint32_t addr[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) addr[t] = x_addr(box, xr, j, 2 * (wg + 4 * t) + hb2);
        y_step(n_full, addr);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float v0 = acc[t][2 * hr], v1 = acc[t][2 * hr + 1];
          v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
          v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
          if (tq == 0) {
            const int i = 16 * (wg + 4 * t) + g + 8 * hr;
            uint32_t hi, lo;
            staged::split2(v0, v1, hi, lo);
            *reinterpret_cast<uint32_t*>(ub + i * 8) = hi;
            *reinterpret_cast<uint32_t*>(ub + i * 8 + 2) = lo;
          }
        }
    }
    group_sync(grp);
    if (gt == 0 && refill) {  // k and rpe are read: the group's next ones stream in
      staged::fence_proxy_async();
      stage_part(p, slot, bar + 8 * kPartKR, source(n + n_groups), col0, kPartKR);
    }

    // 5. out^T[d][n] = sum_i W_v[i][d] Y[i][n] + sum_j v_j[d] A[n][j]: a warp per 16 columns d (tile wg, in head
    //    wg / 2), A = W_v^T (the weight rows by ldmatrix.trans), then v^T (the staged v rows), B = [Y_hi | Y_lo],
    //    then [A_hi; A_lo]^T; column h hi (lane tq = 0) and 2 + h lo (lane tq = 1) summed, + b_v Σa
    staged::mbar_wait(bar + 8 * kPartV, parity);  // v of this source has landed
    {
      const int h = wg / 2;
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kWidth / 16; k0 += 4) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 16 * (k0 + t) + arow;
          ldsm_x4_t(a[t], wsm + i * kWRow + (((8 + 2 * wg + hb2) ^ (lane & 7)) << 4));
          ldsm_x2_t(b[t], uaddr + (16 * (k0 + t) + r16) * 16);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) staged::mma_bf16(acc[t & 1], a[t], b[t][0], b[t][1]);
      }
      auto v_step = [&](int ks, float (&c)[4]) {  // rows clamped to K - 1 in the last tile only
        uint32_t a[4], b[2];
        ldsm_x4_t(a, ks < n_full ? vrow + 2048 * ks : x_addr(box, xv, min(16 * ks + arow, K - 1), 2 * wg + hb2));
        ldsm_x2(b, a_b + 32 * ks);
        staged::mma_bf16(c, a, b[0], b[1]);
      };
      for (int ks = 0; ks < n_mk; ks += 2) {  // two chains of sums, each indexed at compile time
        v_step(ks, acc[0]);
        if (ks + 1 < n_mk) v_step(ks + 1, acc[1]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v = h == 0 ? acc[0][2 * hr] + acc[1][2 * hr] : acc[0][2 * hr + 1] + acc[1][2 * hr + 1];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (tq == 0) {
          const int d = 16 * wg + g + 8 * hr;
          const float o = v + __bfloat162float(bias[kDQ + d]) * asum[h];
          p.out[static_cast<size_t>(s) * kWidth + col0 + d] = __float2bfloat16_rn(nvh[h] != 0.f ? 0.f : o);
        }
      }
    }
    group_sync(grp);  // the group is done with the stage and its scratch
    if (gt == 0 && refill) {
      staged::fence_proxy_async();
      stage_part(p, slot, bar + 8 * kPartV, source(n + n_groups), col0, kPartV);
    }
  }
}

}  // namespace heads_attn
