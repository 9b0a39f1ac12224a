// The bf16 KNARPE KNN self-attention backward B4-bwd at the scaled preset's widths (D = R = 256, 8 heads): four
// blocks per source, each on two of the eight heads, and a second pass that sums drpe over the four.
//
// Replaces, for bf16 operands at d_model = d_rpe = 256 with 8 heads, the only widths it is compiled for,
// trafficbotsv15_tpu/ops/pallas_knarpe.py _bwd_kernel (:136-206, launched at :293), the backward of
// knarpe_attention. Contract as the headers of knarpe_bwd.cu and knarpe_attn_bwd_staged.cuh say: k and v are rows
// of D at stride ld_kv (the halves of one [.., 2D] tensor, or two tensors); per source it writes dq, dk, dv, drpe
// and its rows of pbuf, P = [scale z_h | scale sum dl_hj] and [y_h | sum attn_hj], and knarpe_bwd.cu's two
// weight-gradient passes follow it unchanged. knarpe_attn_bwd_staged.cuh keeps every shape it takes (up to 4 heads:
// the flagship's D = R = 128); the general kernel of knarpe_bwd.cu the shapes both refuse (K > 40 here).
//
// Its bound is the bytes. At the scaled training step's shape (1 x 1024 sources, K=32, D=R=256, H=8) a launch must
// read k, v, rpe, q, g, the mask and the weights and write dk, dv, drpe, dq and the weight gradients: 102.8 MB,
// 0.0307 ms at 3.35 TB/s. The staged backward keeps the whole bf16 W_rpe [R, 2D] resident (262,144 B here against
// the 232,448 B a block may use) and puts [U | W] hi and lo in one 16-column tile (2H <= 8), so it refuses the
// shape; the general kernel took it (one source at a time per block, float32 on the CUDA cores, the weights through
// L1/L2, rpe and k read twice from device memory, one bf16 stored per thread) in ~1.02 ms, above the library's
// backward. With knarpe_bwd.cu's reassociation (u_h = W_k[:, h] q_h, w_h = W_v[:, h] g_h) every term but drpe needs
// a head's own columns and all of rpe:
//   logit_hj = scale (rpe_j . u_h + k_jh . q_h + b_k,h . q_h),  dattn_hj = rpe_j . w_h + v_jh . g_h + b_v,h . g_h,
//   dl_hj = attn_hj (dattn_hj - sum_j attn_hj dattn_hj),  dk_jh = scale dl_hj q_h,  dv_jh = attn_hj g_h,
//   dq_h = z'_h W_k[:, h] + sum_j scale dl_hj k_jh + b_k,h sum_j scale dl_hj,  z'_h = sum_j scale dl_hj rpe_j,
// so, as in the forward (knarpe_attn_heads.cuh), a block that holds the W_rpe columns of two heads (its quarter:
// [W_k | W_v][:, 64 qt .. 64 qt + 64), all R rows, 65,536 B) computes their 64 columns of dq, dk and dv, and their
// rows of pbuf, alone. drpe_j = sum_h scale dl_hj u_h + attn_hj w_h runs over all eight heads: the one sum across the
// blocks. Each block writes its factors, F = [scale dl_h | attn_h] ([K, 4] float32) and G = [u_h | w_h] ([4, R]
// float32), into a float32 scratch after pbuf, and a second kernel forms drpe = F G over the sixteen columns of the
// four blocks, in block order, in float32, rounded once to bf16: 18 KB a source (18.9 MB at 1024 sources) written
// and read back, against a cluster of the four blocks that would make each group wait on the slowest of them.
//   - block b takes quarter qt = b % 4 of the sources b / 4, b / 4 + n_slots, ... (as the forward): the four quarters
//     of a source run on neighbouring blocks at the same pace, so each rpe row comes from device memory once;
//   - inside a block, the forward's scheme: n_groups groups of four warps (five up to K=32, four up to K=40), group
//     c on the block's sources c, c + n_groups, ..., each in its own stage, which the group refills itself in two
//     parts, each on its own mbarrier: q's and g's quarters (bulk copies), v's quarter and all of rpe (2-D tensor
//     copies: boxes of 64 columns by K rows, the 128-byte swizzle) once its dk/dv step is done, and k's quarter
//     after its dq step. Steps are closed by the group's own named barrier, five a source;
//   - every product on mma.sync.m16n8k16 (bf16 operands, float32 sums); the float32 u, w, scale dl, attn and z' split
//     into bf16 hi + lo, both halves through the product, so results reach float32 level before the one rounding to
//     bf16 at each output. Per source and block (the columns of an n=8 tile in brackets):
//       [u | w]       = W_k Q + W_v G, Q and G the head-masked quarters of q and g (columns 0-1 and 4-5)
//                       -> [U_hi | U_lo | W_hi | W_lo] [R][8] and G; c_h = b_k,h . q_h, e_h = b_v,h . g_h;
//       [lgt | dattn] = rpe [U_hi | U_lo | W_hi | W_lo] + k Q + v G, per 16 targets in two halves of the k steps
//                       (one warp each, the partials summed in a fixed order by the softmax); a row past K - 1
//                       reads other bytes of the group's stage and its results are dropped;
//       softmax, dl   over K per head (a warp per head) -> P = [sDL_hi | sDL_lo | A_hi | A_lo] [8][K] (sDL =
//                       scale dl), F, the sums;
//       [z' | y]^T    = rpe^T P^T (16 rows of R a tile) -> pbuf, and z' as [Z_hi | Z_lo] over [U_hi | U_lo];
//       dk, dv        on the CUDA cores, eight values a 16-byte store, a row's 64 columns in 128 bytes;
//       dq^T          = W_k^T [Z_hi | Z_lo] + k^T P^T (a warp per 16 columns d), column h hi + column 2 + h lo,
//                       + b_k sum scale dl;
//     a target tile's rows are clamped to K - 1 only where the tile passes K and the product sums over targets (the
//     y and dq steps: P is 0 there, the row must be data);
//   - the budget at K=32 (a block may use 232,448 B): a stage 25,600 B (six boxes of 4,096 B, q's and g's quarters
//     128 B each, rounded up to the 1,024 B the swizzle needs), five stages 128,000 B; the W_rpe quarter 65,536 B and
//     its bias 256 B; per group 6,304 B ([U | W], later Z, 4,096 B; the two partial [logits | dattn] 1,024 B; P 640 B
//     (8 rows of K padded to 32, + 8 so that rows fall on distinct banks); [scale dl | attn] in float32 512 B; four
//     per-head scalars 32 B), five groups 31,520 B; the mbarriers 80 B (two a stage, 16 B apart); 1,024 B to align:
//     226,416 B. From K=33 the boxes take 5,120 B and five stages no longer fit; four do up to K=40 (221,632 B). From
//     K=41 a box takes 6,144 B and four stages no longer fit either (246,400 B).
// No atomics: every sum has a fixed order, so two launches on the same inputs give the same bits. A source with no
// valid target gets attn = dl = 0, and so zero gradients.

#pragma once

#include "knarpe_attn_heads.cuh"

namespace heads_attn_bwd {

using heads_attn::group_sync;
using heads_attn::kDH;
using heads_attn::kDQ;
using heads_attn::kGroupThreads;
using heads_attn::kGroupWarps;
using heads_attn::kHeads;
using heads_attn::kHQ;
using heads_attn::kMaxGroups;
using heads_attn::kMaxThreads;
using heads_attn::kMinGroups;
using heads_attn::kRBoxes;
using heads_attn::kSplit;
using heads_attn::kWidth;
using heads_attn::kWRow;
using heads_attn::x_addr;
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

constexpr int kMaxK = 64;           // the softmax keeps K / 32 targets per lane in registers, at most two
constexpr int kFac = 4 * kSplit;    // drpe's factor columns: [scale dl | attn] and [u | w] of each block's two heads
constexpr int kR1 = kWidth + 1;     // a pbuf row: R inputs, then the bias's constant input
constexpr int kDrpeThreads = 256;   // the drpe pass: two columns a thread, two rows at a time

// floats of a source's drpe factors: F [K][kFac], then G [kFac][R]
__host__ __device__ inline size_t fac_floats(int K) {
  return static_cast<size_t>(K) * kFac + static_cast<size_t>(kFac) * kWidth;
}

// Byte offsets from the block's 1024-byte aligned base in dynamic shared memory (total counts the alignment's
// slack): the groups' stages (a stage's fields k, v, r: boxes of box bytes; q, g: offsets inside it), the resident
// weight quarter and bias, the groups' scratch (gu, glg, gp, gf, ghv: offsets inside a group's) and the mbarriers.
struct Layout {
  int n_groups;
  size_t box, k, v, r, q, g, slot_bytes, w, bias, grp, grp_bytes, gu, glg, gp, gf, ghv, bar, total;
};

inline Layout make_layout(int K, int n_groups) {
  Layout L{};
  L.n_groups = n_groups;
  L.box = box_bytes(K);
  L.k = 0;
  L.v = L.box;
  L.r = 2 * L.box;
  L.q = L.r + kRBoxes * L.box;
  L.g = L.q + kDQ * 2;
  L.slot_bytes = a1024(L.g + kDQ * 2);
  size_t off = n_groups * L.slot_bytes;
  L.w = off;    off += static_cast<size_t>(kWidth) * kWRow;
  L.bias = off; off += 2 * kDQ * 2;
  L.gu = 0;                                                    // [U_hi | U_lo | W_hi | W_lo] [R][8], later Z
  L.glg = static_cast<size_t>(kWidth) * 8 * 2;                 // partial [logits | dattn] [2][4][K]
  L.gp = L.glg + a16(static_cast<size_t>(2) * 4 * K * 4);      // P [8][pad16(K) + 8]
  L.gf = L.gp + static_cast<size_t>(8) * (pad16(K) + 8) * 2;   // [scale dl | attn] [4][K] in float32
  L.ghv = L.gf + a16(static_cast<size_t>(4) * K * 4);          // c, e, sum scale dl, sum attn per head
  L.grp_bytes = a16(L.ghv + static_cast<size_t>(4) * kHQ * 4);
  L.grp = off;  off += n_groups * L.grp_bytes;
  L.bar = off;  off += static_cast<size_t>(16) * n_groups;  // per stage two mbarriers: its two parts
  L.total = off + 1024;
  return L;
}

// The most groups, kMinGroups to kMaxGroups, whose layout fits max_smem, or 0 if kMinGroups do not fit.
inline int group_count(int K, size_t max_smem) {
  for (int n = kMaxGroups; n >= kMinGroups; --n)
    if (make_layout(K, n).total <= max_smem) return n;
  return 0;
}

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::ATTN_BWD_HEADS_REFUSALS words each code (4, no
// block fits a multiprocessor, comes from the plan).
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (!(D == kWidth && R == kWidth && H == kHeads)) return 2;
  if (K < 1 || K > kMaxK) return 1;
  if (group_count(K, max_smem) == 0) return 3;
  return 0;
}

struct Params {
  CUtensorMap tm_k, tm_v, tm_r;  // k, v (rows of D at stride ld_kv) and rpe [n_src K, R]: boxes of 64 x K
  const __nv_bfloat16 *q, *g, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16 *dq, *dk, *dv;
  float* pbuf;  // [n_src, 2, H, R + 1]
  float* fac;   // [n_src][fac_floats(K)]: drpe's factors
  int n_src, n_knn;
  float scale;
  Layout L;
};

// The stage's parts, each on its own mbarrier 8 bytes apart: q's, g's and v's quarters and all of rpe, read by the
// steps up to dk/dv; k's quarter, read by the logits and dq steps
enum Part { kPartA = 0, kPartK = 1 };

// Part `part` of source s into the stage at slot, by tensor copies (q and g by bulk copies), counted on bar
__device__ __forceinline__ void stage_part(const Params& p, uint32_t slot, uint32_t bar, int s, int col0, int part) {
  const int K = p.n_knn;
  if (part == kPartK) {
    staged::mbar_expect(bar, static_cast<uint32_t>(K * 128));
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.k), &p.tm_k, col0, s * K, bar);
    return;
  }
  staged::mbar_expect(bar, static_cast<uint32_t>((1 + kRBoxes) * K * 128 + 2 * kDQ * 2));
  const size_t qg = static_cast<size_t>(s) * kWidth + col0;
  staged::bulk_copy(slot + static_cast<uint32_t>(p.L.q), p.q + qg, kDQ * 2, bar);
  staged::bulk_copy(slot + static_cast<uint32_t>(p.L.g), p.g + qg, kDQ * 2, bar);
  staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.v), &p.tm_v, col0, s * K, bar);
  for (int b = 0; b < kRBoxes; ++b)
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.r + b * p.L.box), &p.tm_r, 64 * b, s * K, bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return staged::bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

__global__ void __launch_bounds__(kMaxThreads, 1) knarpe_attn_bwd_heads_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: stages start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / kGroupWarps, wg = warp % kGroupWarps, gt = tid % kGroupThreads, n_groups = p.L.n_groups;
  const int qt = blockIdx.x % kSplit, col0 = qt * kDQ;  // the block's quarter: heads 2 qt, 2 qt + 1
  const int n_slots = gridDim.x / kSplit, slot0 = blockIdx.x / kSplit;
  auto source = [&](int n) { return slot0 + n * n_slots; };  // the block's n-th source
  const int K = p.n_knn, n_mk = pad16(K) / 16, lda = pad16(K) + 8, n_full = K / 16;
  const float scale = p.scale;
  const uint32_t box = static_cast<uint32_t>(p.L.box);
  const uint32_t slot = smem_u32(smem) + grp * static_cast<uint32_t>(p.L.slot_bytes);  // the group's stage
  const uint32_t xk = slot + static_cast<uint32_t>(p.L.k), xv = slot + static_cast<uint32_t>(p.L.v);
  const uint32_t xr = slot + static_cast<uint32_t>(p.L.r);
  const uint32_t wsm = smem_u32(smem + p.L.w);
  const uint32_t bar = smem_u32(smem + p.L.bar) + 16 * grp;  // the stage's part x at bar + 8 x

  if (gt == 0) {  // the group's stage barriers and its first source
    staged::mbar_init(bar + 8 * kPartA);
    staged::mbar_init(bar + 8 * kPartK);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (source(grp) < p.n_src) {
      stage_part(p, slot, bar + 8 * kPartA, source(grp), col0, kPartA);
      stage_part(p, slot, bar + 8 * kPartK, source(grp), col0, kPartK);
    }
  }
  heads_attn::load_weights(p.w_rpe, p.bias, col0, wsm, smem_u32(smem + p.L.bias), tid, blockDim.x);
  // the groups' scratch starts at zero: P's columns past K - 1 stay so
  for (int e = tid; e < static_cast<int>(n_groups * p.L.grp_bytes / 16); e += blockDim.x)
    reinterpret_cast<uint4*>(smem + p.L.grp)[e] = make_uint4(0u, 0u, 0u, 0u);
  staged::cp_wait_all();
  __syncthreads();

  // mma fragments: row group g and column pair tq; ldmatrix rows r16 and chunk half hb (A, B by rows), arow and
  // hb2 (A by .trans: rows j or i of the stored matrix); every row a lane addresses is lane mod 8 (unless clamped to
  // K - 1), so the 128-byte swizzle of chunk c is c ^ (lane & 7): xa[t] for chunk 2 t + hb (by rows), xw for chunk
  // 2 wg + hb2 (.trans; the warp's 16 columns in every 64-column box)
  const int g = lane >> 2, tq = lane & 3, r16 = lane & 15, hb = lane >> 4;
  const int arow = (lane & 7) + 8 * (lane >> 4), hb2 = (lane >> 3) & 1;
  uint32_t xa[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) xa[t] = static_cast<uint32_t>((2 * t + hb) ^ (lane & 7)) << 4;
  const uint32_t xw = static_cast<uint32_t>((2 * wg + hb2) ^ (lane & 7)) << 4;
  const uint32_t xr_row = xr + r16 * 128, xk_row = xk + r16 * 128, xv_row = xv + r16 * 128;  // the logits step's rows
  uint32_t yrow[kRBoxes];  // the y step's rpe rows arow, chunk 2 wg + hb2, of each box
#pragma unroll
  for (int t = 0; t < kRBoxes; ++t) yrow[t] = xr + t * box + arow * 128 + xw;
  const uint32_t krow = xk + arow * 128 + xw;  // the dq step's k rows
  unsigned char* gs = smem + p.L.grp + grp * p.L.grp_bytes;
  __nv_bfloat16* ub = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gu);  // [U_hi | U_lo | W_hi | W_lo] [R][8], later Z
  const uint32_t uaddr = smem_u32(ub);
  float* lg = reinterpret_cast<float*>(gs + p.L.glg);  // [half][c][j]: logits of head c, dattn of head c - 2
  // [8][lda]: scale dl hi rows 0-1, lo 2-3, attn hi 4-5, lo 6-7 (one row a head); columns K.. zero
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gp);
  const uint32_t p_b = smem_u32(pb + (lane & 7) * lda + 8 * hb2);  // this lane's row of a B fragment of P^T
  float* fa = reinterpret_cast<float*>(gs + p.L.gf);  // [c][j]: scale dl of head c, attn of head c - 2
  float* hv = reinterpret_cast<float*>(gs + p.L.ghv);  // c_h, e_h, sum scale dl, sum attn: two heads each
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // [b_k | b_v] quarters
  constexpr int kR = kMaxK / 32;
  // the softmax warps' mask bytes, target lane + 32 r, of the group's next source: loaded a source ahead
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
    float* prow = p.pbuf + static_cast<size_t>(s) * 2 * kHeads * kR1;  // the source's pbuf rows
    float* fac = p.fac + static_cast<size_t>(s) * fac_floats(K);       // F [K][kFac], then G [kFac][R]
    staged::mbar_wait(bar + 8 * kPartA, parity);  // q, g, v and rpe of this source have landed
    const unsigned char* stage = smem + grp * p.L.slot_bytes;
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(stage + p.L.q);
    const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(stage + p.L.g);
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qb);
    const uint32_t* g2 = reinterpret_cast<const uint32_t*>(gb);
    // B fragments of the head-masked q (column g = head g) and g (column g = 4 + head): k step ks covers columns
    // 16 ks.., in head ks / 2
    uint32_t qf0[4], qf1[4], gf0[4], gf1[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bool mq = g == ks / 2, mg = g == 4 + ks / 2;
      qf0[ks] = mq ? q2[8 * ks + tq] : 0u;
      qf1[ks] = mq ? q2[8 * ks + 4 + tq] : 0u;
      gf0[ks] = mg ? g2[8 * ks + tq] : 0u;
      gf1[ks] = mg ? g2[8 * ks + 4 + tq] : 0u;
    }

    // 1. [u | w][i] = W_k[i, head h] . q_h (column h) + W_v[i, head h] . g_h (column 4 + h): a warp per four 16-row
    //    tiles of R (wg + 4 t), the k steps of both weight halves loaded first (two chains of sums); split into
    //    [U_hi | U_lo | W_hi | W_lo], and the float32 u and w into G's rows. Then c_h and e_h
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int tile = wg + 4 * t;
      const uint32_t row = wsm + (16 * tile + r16) * kWRow;
      uint32_t ak[4][4], av[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        ldsm_x4(ak[ks], row + xa[ks]);
        ldsm_x4(av[ks], row + 128 + xa[ks]);  // W_v's chunks 8.. of the row: chunk 8 + c lies 128 bytes on
      }
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        staged::mma_bf16(acc[ks & 1], ak[ks], qf0[ks], qf1[ks]);
        staged::mma_bf16(acc[ks & 1], av[ks], gf0[ks], gf1[ks]);
      }
      if ((tq & 1) == 0) {  // tq 0: u of heads 0, 1 (columns 0, 1); tq 2: w (columns 4, 5); the others are 0
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 16 * tile + g + 8 * hr;
          const float v0 = acc[0][2 * hr] + acc[1][2 * hr], v1 = acc[0][2 * hr + 1] + acc[1][2 * hr + 1];
          uint32_t hi, lo;
          staged::split2(v0, v1, hi, lo);
          *reinterpret_cast<uint32_t*>(ub + i * 8 + 2 * tq) = hi;
          *reinterpret_cast<uint32_t*>(ub + i * 8 + 2 * tq + 2) = lo;
          float* gcol = fac + K * kFac + (4 * qt + tq) * kWidth + i;  // G rows 4 qt + tq and 4 qt + tq + 1
          gcol[0] = v0;
          gcol[kWidth] = v1;
        }
      }
    }
    {  // c_h = b_k,h . q_h (warps 0, 1), e_h = b_v,h . g_h (warps 2, 3)
      const int h = wg & 1;
      const __nv_bfloat16* vec = wg < 2 ? qb : gb;
      float c = __bfloat162float(bias[(wg < 2 ? 0 : kDQ) + h * kDH + lane]) * __bfloat162float(vec[h * kDH + lane]);
      c = staged::warp_sum(c);
      if (lane == 0) hv[wg] = c;
    }
    group_sync(grp);
    staged::mbar_wait(bar + 8 * kPartK, parity);  // k of this source has landed

    // 2. [logits | dattn] per 16 targets and half of the k steps (item = 2 mt + half): half 0 rpe's columns [0, 128)
    //    and k . Q, half 1 rpe's [128, 256) and v . G; A = the staged rows, unclamped (a row past K - 1 reads other
    //    bytes of the group's stage, and its results are dropped: a row of the product depends on its own row of A
    //    alone), B = [U | W] hi and lo, then the head-masked q or g
    for (int item = wg; item < 2 * n_mk; item += kGroupWarps) {
      const int mt = item >> 1, half = item & 1;
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
        uint32_t a[4][4];  // the four k steps of k's (half 0) or v's (half 1) quarter
        const uint32_t xbase = (half ? xv_row : xk_row) + 2048 * mt;
#pragma unroll
        for (int t = 0; t < 4; ++t) ldsm_x4(a[t], xbase + xa[t]);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          staged::mma_bf16(acc[t & 1], a[t], half ? gf0[t] : qf0[t], half ? gf1[t] : qf1[t]);
      }
      // column 2 + c (lo) into column c (hi): logits of head e in lane tq = 0, dattn in lane tq = 2
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[0][2 * hr + e] + acc[1][2 * hr + e];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          if ((tq & 1) == 0 && row < K) lg[(half * 4 + tq + e) * K + row] = v;
        }
      }
    }
    group_sync(grp);

    // 3. masked softmax over K and dl = attn (dattn - sum attn dattn), one warp per head (as knarpe_bwd.cu), target
    //    lane + 32 r in registers; P's rows h, 2 + h (scale dl hi, lo) and 4 + h, 6 + h (attn hi, lo), the float32
    //    values for the dk/dv step and as F's columns 4 qt + h, 4 qt + 2 + h; the sums, also as pbuf's row R
    if (wg < kHQ) {
      const int h = wg;
      const float c = hv[h], ev = hv[2 + h];
      float lv[kR], dv[kR];
      float m = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        const bool ok = j < K && !((inv_bits >> r) & 1u);
        lv[r] = ok ? (lg[h * K + j] + lg[(4 + h) * K + j] + c) * scale : -INFINITY;
        dv[r] = j < K ? lg[(2 + h) * K + j] + lg[(6 + h) * K + j] + ev : 0.f;
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
      const float rden = den <= 0.f ? 1.f : 1.f / den;
      float sd = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        lv[r] *= rden;
        sd += lv[r] * dv[r];
      }
      sd = staged::warp_sum(sd);
      float as = 0.f, sds = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        if (j < K) {
          const float a = lv[r], v = scale * (a * (dv[r] - sd));
          const __nv_bfloat16 vh = __float2bfloat16_rn(v), ah = __float2bfloat16_rn(a);
          pb[h * lda + j] = vh;
          pb[(2 + h) * lda + j] = __float2bfloat16_rn(v - __bfloat162float(vh));
          pb[(4 + h) * lda + j] = ah;
          pb[(6 + h) * lda + j] = __float2bfloat16_rn(a - __bfloat162float(ah));
          fa[h * K + j] = v;
          fa[(2 + h) * K + j] = a;
          fac[j * kFac + 4 * qt + h] = v;
          fac[j * kFac + 4 * qt + 2 + h] = a;
          as += a;
          sds += v;
        }
      }
      as = staged::warp_sum(as);
      sds = staged::warp_sum(sds);
      if (lane == 0) {
        hv[4 + h] = sds;
        hv[6 + h] = as;
        prow[static_cast<size_t>(2 * qt + h) * kR1 + kWidth] = sds;           // k half: scale sum dl
        prow[static_cast<size_t>(kHeads + 2 * qt + h) * kR1 + kWidth] = as;   // v half: sum attn
      }
    }
    group_sync(grp);

    // 4. [z' | y]^T[i][c] = sum_j rpe_j[i] P[c][j]: a warp per four 16-row tiles of R (wg + 4 t), A = rpe^T (the
    //    staged rows by ldmatrix.trans), B = P^T, shared by the four; hi and lo columns summed (z' of head e in lane
    //    tq = 0, y in lane tq = 2) -> pbuf's rows, and z' split again into [Z_hi | Z_lo] over [U_hi | U_lo]
    {
      float acc[4][4] = {};
      auto y_step = [&](int ks, const uint32_t (&addr)[4]) {
        uint32_t b[2], a[4][4];
        ldsm_x2(b, p_b + 32 * ks);
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
      if (n_full < n_mk) {  // the last tile, its rows past K - 1 clamped to K - 1 (P is 0 there; the row is data)
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
          if ((tq & 1) == 0) {
            const int i = 16 * (wg + 4 * t) + g + 8 * hr;
            float* dst = prow + static_cast<size_t>((tq == 0 ? 0 : kHeads) + 2 * qt) * kR1 + i;  // k half z', v half y
            dst[0] = v0;
            dst[kR1] = v1;
            if (tq == 0) {
              uint32_t hi, lo;
              staged::split2(v0, v1, hi, lo);
              *reinterpret_cast<uint32_t*>(ub + i * 8) = hi;
              *reinterpret_cast<uint32_t*>(ub + i * 8 + 2) = lo;
            }
          }
        }
    }
    // 5. dk_jh = scale dl_hj q_h, dv_jh = attn_hj g_h: eight values of one row a thread, one 16-byte store; the 64
    //    columns of a row are eight threads' 128 bytes
    for (int e = gt; e < 2 * K * 8; e += kGroupThreads) {
      const int jr = e >> 3, c8 = e & 7;
      const bool is_v = jr >= K;
      const int j = is_v ? jr - K : jr;
      const float f = fa[((is_v ? 2 : 0) + (c8 >> 2)) * K + j];  // head c8 / 4: 32 columns, four chunks
      const uint4 src = *reinterpret_cast<const uint4*>((is_v ? gb : qb) + 8 * c8);
      const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&src);
      uint4 o;
      uint32_t* o2 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 x = __bfloat1622float2(s2[t]);
        o2[t] = pack_bf16(f * x.x, f * x.y);
      }
      *reinterpret_cast<uint4*>((is_v ? p.dv : p.dk) + (static_cast<size_t>(s) * K + j) * kWidth + col0 + 8 * c8) = o;
    }
    group_sync(grp);
    if (gt == 0 && refill) {  // q, g, v and rpe are read: the group's next ones stream in
      staged::fence_proxy_async();
      stage_part(p, slot, bar + 8 * kPartA, source(n + n_groups), col0, kPartA);
    }

    // 6. dq^T[d][c] = sum_i W_k[i][d] Z[i][c] + sum_j k_j[d] P[c][j]: a warp per 16 columns d (tile wg, in head
    //    wg / 2), A = W_k^T (the weight rows by ldmatrix.trans), then k^T (the staged k rows), B = [Z_hi | Z_lo],
    //    then P^T; column h hi (lane tq = 0) and 2 + h lo (lane tq = 1) summed, + b_k sum scale dl
    {
      const int h = wg >> 1;
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kWidth / 16; k0 += 4) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ldsm_x4_t(a[t], wsm + (16 * (k0 + t) + arow) * kWRow + xw);
          ldsm_x2_t(b[t], uaddr + (16 * (k0 + t) + r16) * 16);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) staged::mma_bf16(acc[t & 1], a[t], b[t][0], b[t][1]);
      }
      auto k_step = [&](int ks, float (&c)[4]) {  // rows clamped to K - 1 in the last tile only
        uint32_t a[4], b[2];
        ldsm_x4_t(a, ks < n_full ? krow + 2048 * ks : x_addr(box, xk, min(16 * ks + arow, K - 1), 2 * wg + hb2));
        ldsm_x2(b, p_b + 32 * ks);
        staged::mma_bf16(c, a, b[0], b[1]);
      };
      for (int ks = 0; ks < n_mk; ks += 2) {  // two chains of sums, each indexed at compile time
        k_step(ks, acc[0]);
        if (ks + 1 < n_mk) k_step(ks + 1, acc[1]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v = h == 0 ? acc[0][2 * hr] + acc[1][2 * hr] : acc[0][2 * hr + 1] + acc[1][2 * hr + 1];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (tq == 0) {
          const int d = 16 * wg + g + 8 * hr;
          p.dq[static_cast<size_t>(s) * kWidth + col0 + d] =
              __float2bfloat16_rn(v + __bfloat162float(bias[d]) * hv[4 + h]);
        }
      }
    }
    group_sync(grp);  // the group is done with the stage and its scratch
    if (gt == 0 && refill) {
      staged::fence_proxy_async();
      stage_part(p, slot, bar + 8 * kPartK, source(n + n_groups), col0, kPartK);
    }
  }
}

// drpe_j = sum_c F[j][c] G[c] over the sixteen factor columns of a source's four blocks, in their order, in float32,
// rounded once to bf16: a block per source at a time, two columns a thread (G's in registers), F staged in shared
// memory; a row of drpe is 128 threads' 512 bytes
__global__ void __launch_bounds__(kDrpeThreads) knarpe_attn_bwd_heads_drpe(const float* fac, __nv_bfloat16* drpe,
                                                                           int n_src, int K) {
  __shared__ float fs[kMaxK * kFac];
  constexpr int kPairs = kWidth / 2, kRows = kDrpeThreads / kPairs;
  const int tid = threadIdx.x, ip = tid % kPairs, j0 = tid / kPairs;
  for (int s = blockIdx.x; s < n_src; s += gridDim.x) {
    const float* f = fac + static_cast<size_t>(s) * fac_floats(K);
    const float* gm = f + K * kFac;
    float g0[kFac], g1[kFac];
#pragma unroll
    for (int c = 0; c < kFac; ++c) {
      const float2 v = *reinterpret_cast<const float2*>(gm + c * kWidth + 2 * ip);
      g0[c] = v.x;
      g1[c] = v.y;
    }
    __syncthreads();  // the previous source's F is read
    for (int e = tid; e < K * kFac; e += kDrpeThreads) fs[e] = f[e];
    __syncthreads();
    for (int j = j0; j < K; j += kRows) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int c = 0; c < kFac; ++c) {
        a0 = fmaf(fs[j * kFac + c], g0[c], a0);
        a1 = fmaf(fs[j * kFac + c], g1[c], a1);
      }
      *reinterpret_cast<uint32_t*>(drpe + (static_cast<size_t>(s) * K + j) * kWidth + 2 * ip) = pack_bf16(a0, a1);
    }
  }
}

}  // namespace heads_attn_bwd
