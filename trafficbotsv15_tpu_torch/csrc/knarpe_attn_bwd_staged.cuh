// The bf16 KNARPE KNN self-attention backward B4-bwd, redesigned for Hopper:
// the forward's four groups of warps with their own stages
// (knarpe_attn_staged.cuh), every per-source product on the tensor cores, and
// dk, dv and drpe written as full lines.
//
// Replaces, for bf16 operands, trafficbotsv15_tpu/ops/pallas_knarpe.py
// _bwd_kernel (:136-206, launched at :293), the backward of knarpe_attention.
// knarpe_bwd.cu keeps float32 B4-bwd and the bf16 shapes refused below (its
// general kernel), and the two weight-gradient passes that follow both
// routes. The algebra is knarpe_bwd.cu's with x_j = rpe_j: the [K, 2D] dkv is
// never formed, and per source the kernel writes dq, dk, dv, drpe and its rows
// of pbuf, P = [scale z_h | scale sum dl_hj] and [y_h | sum attn_hj].
//
// What bounds it: the bytes. At the training step's shape (8 x 1024 sources,
// K=32, D=R=128, H=4) a launch must read k, v, rpe, q, g, the mask and the
// weights and write dk, dv, drpe, dq and the weight gradients: 409.3 MB,
// 0.1222 ms at 3.35 TB/s; the reassociated work is ~160 K multiply-adds a
// source (2.6 GFLOP). The previous design (knarpe_bwd.cu's general kernel)
// walked one source at a time per SM at ~17 us a source behind seven block
// barriers, read rpe and k twice straight from device memory, wrote dk, dv and
// drpe one bf16 per thread and did every product on the CUDA cores: 11 % of
// the bound. Here, as in the forward:
//   - one persistent 512-thread block per SM, four groups of four warps, each
//     computing its own source behind its own named barrier (five a source),
//     in stages it owns (4 at the flagship, 8 where they fit) and refills
//     itself in two parts, each on its own mbarrier: v, rpe, q and g (part 0)
//     once only the dq step is left, k (part 1) after it; it waits on part 1
//     only before its logits step. k, v and rpe come by 2-D tensor copies
//     (boxes of 64 columns by K rows, 128-byte swizzle; k and v at stride
//     ld_kv), q and g by bulk copies. Every byte of a source is read from
//     device memory once: the logits and dq both read k from the stage;
//   - the bf16 W_rpe and the bias stay resident, rows XOR-swizzled;
//   - the products, on mma.sync.m16n8k16 with float32 sums, float32 operands
//     split into bf16 hi + lo (knarpe_bwd_staged.cuh's scheme):
//       [u | w]       = [W_k Q | W_v G] -> [U_hi W_hi | U_lo W_lo];
//       [lgt | dattn] = rpe [U | W] (one warp per 16 targets) + [k Q | v G]
//                       (another warp);
//       softmax and dl = attn (dattn - sum attn dattn), one warp per head,
//                       each lane's targets in registers -> P = [scale DL | A]
//                       hi/lo rows, [DL_hi; DL_lo], and scale dl, attn in
//                       float32;
//       [z'; y]       = P rpe -> pbuf, [Z_hi; Z_lo];
//       drpe          = [scale DL | A] [U; W], both operands split, each warp's
//                       16 x 16 tile through shared memory (stmatrix) to
//                       32-byte row pieces;
//       dq^T          = W_k^T Z'^T + k^T DL^T (16 columns d a tile, the 2H
//                       rows of Z and DL as the n of the product), column h(d)
//                       hi + lo kept, + b_k scale sum dl;
//     and on the CUDA cores dk_jh = scale dl_hj q_h, dv_jh = attn_hj g_h, one
//     float32 product a value, eight values (16 bytes) a store, so that a warp
//     writes whole 256-byte rows;
//   - the weight gradients stay with knarpe_bwd.cu's two passes over pbuf
//     (at [8 x 1024, K=32] 33.8 MB written and read back). Accumulating them in
//     the block instead would need a [R + 1, 2D] float32 partial per group,
//     4 x 132 KB, which neither the shared memory nor the registers hold;
//   - the budget at the flagship (a block may use 232,448 B): a stage 25,600 B
//     (six boxes of 4,096 B, q and g 256 B each, rounded up to 1,024 B), four
//     stages 102,400 B; W_rpe 65,536 B and the bias 512 B; per group 12,224 B
//     ([U | W] hi/lo 4,096 B, Z hi/lo 2,048 B, P 1,280 B (16 rows of K padded
//     to 32, + 8), [DL_hi; DL_lo] 640 B, the two partial [logits | dattn]
//     2,048 B, per-head scalars 64 B, four warps' drpe tiles 2,048 B), four
//     groups 48,896 B; the mbarriers 64 B; 1,024 B to align: 218,432 B.
// No atomics: every sum has a fixed order, so two launches on the same inputs
// give the same bits. A source with no valid target gets attn = dl = 0 and so
// zero gradients.

#pragma once

#include "knarpe_attn_staged.cuh"
#include "knarpe_bwd_staged.cuh"

namespace staged_attn_bwd {

using staged::a16;
using staged::a1024;
using staged::box_bytes;
using staged::kMask;
using staged::ldsm_x2;
using staged::ldsm_x2_t;
using staged::ldsm_x4;
using staged::ldsm_x4_t;
using staged::n_boxes;
using staged::pad16;
using staged::smem_u32;
using staged_attn::group_sync;
using staged_attn::kGroups;
using staged_attn::kGroupThreads;
using staged_attn::kGroupWarps;
using staged_attn::kMaxK;
using staged_attn::kMaxStages;
using staged_attn::kThreads;
using staged_attn::masked_b;
using staged_attn::w_addr;
using staged_attn::x_addr;
using staged_bwd::kUW;
using staged_bwd::uw_at;

// Byte offsets from the block's 1024-byte aligned base, as in knarpe_attn_staged.cuh: stages (k, v, r
// boxes; q, g), the resident weights, the groups' scratch (guw, gz, gp, glg, gst, gdx), the mbarriers.
struct Layout {
  int n_stages;
  size_t box, k, v, r, q, g, slot_bytes, w, bias, grp, grp_bytes, guw, gz, gp, gdl, glg, gst, gdx, bar, total;
};

inline Layout make_layout(int K, int D, int R, int H, int n_stages) {
  Layout L{};
  L.n_stages = n_stages;
  L.box = box_bytes(K);
  L.k = 0;
  L.v = n_boxes(D) * L.box;
  L.r = 2 * L.v;
  L.q = L.r + n_boxes(R) * L.box;
  L.g = L.q + a16(static_cast<size_t>(D) * 2);
  L.slot_bytes = a1024(L.g + static_cast<size_t>(D) * 2);
  size_t off = n_stages * L.slot_bytes;
  L.w = off;    off += static_cast<size_t>(R) * 2 * D * 2;
  L.bias = off; off += a16(static_cast<size_t>(D) * 2 * 2);
  L.guw = 0;                                                         // [U_hi W_hi | U_lo W_lo] [R][16]
  L.gz = L.guw + static_cast<size_t>(R) * kUW * 2;                   // [Z_hi; Z_lo] [8][R]
  L.gp = L.gz + static_cast<size_t>(8) * R * 2;                      // P [16][pad16(K) + 8]
  L.gdl = L.gp + static_cast<size_t>(16) * (pad16(K) + 8) * 2;       // [DL_hi; DL_lo] [8][pad16(K) + 8]
  L.glg = a16(L.gdl + static_cast<size_t>(8) * (pad16(K) + 8) * 2);  // [part][c][j], c < 2H
  L.gst = L.glg + a16(static_cast<size_t>(2) * 2 * H * K * 4);       // [b_k q_h | b_v g_h], sum attn, sum scale dl
  L.gdx = L.gst + a16(static_cast<size_t>(4) * H * 4);               // each warp's 16 x 16 drpe tile
  L.grp_bytes = L.gdx + static_cast<size_t>(kGroupWarps) * 16 * 16 * 2;
  L.grp = off;  off += kGroups * L.grp_bytes;
  L.bar = off;  off += static_cast<size_t>(16) * n_stages;  // two full mbarriers per stage: its two parts
  L.total = off + 1024;
  return L;
}

// The most stages, a multiple of kGroups up to kMaxStages, whose layout fits max_smem, or 0 if kGroups
// stages do not fit.
inline int stage_count(int K, int D, int R, int H, size_t max_smem) {
  for (int n = kMaxStages; n >= kGroups; n -= kGroups)
    if (make_layout(K, D, R, H, n).total <= max_smem) return n;
  return 0;
}

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::ATTN_BWD_STAGED_REFUSALS words each
// code (5, no block fits a multiprocessor, comes from the plan).
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (K < 1 || K > kMaxK) return 1;
  if (D % 16 || R % 16) return 2;
  if (H > 4) return 3;
  if (stage_count(K, D, R, H, max_smem) == 0) return 4;
  return 0;
}

struct Params {
  CUtensorMap tm_k, tm_v, tm_r;  // k, v (rows of D at stride ld_kv) and rpe [n_src K, R]: boxes of 64 x K
  const __nv_bfloat16 *q, *g, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16 *dq, *dk, *dv, *drpe;
  float* pbuf;  // [n_src, 2, H, R + 1]
  int n_src, n_knn, d_model, d_rpe;
  int mw;  // swizzle mask of the weight rows
  float scale;
  Layout L;
};

// Part 0 (v, rpe, q and g) or part 1 (k) of source s into the stage at slot, by tensor copies (q and g by
// bulk copies), counted on bar: a group refills part 0 of its stage once only the dq step is left to read
// k, and part 1 after it; it waits on part 1 only before its logits step.
__device__ __forceinline__ void stage_part(const Params& p, uint32_t slot, uint32_t bar, int s, int part) {
  const int K = p.n_knn, D = p.d_model, nd = n_boxes(D), nr = n_boxes(p.d_rpe);
  if (part == 1) {
    staged::mbar_expect(bar, static_cast<uint32_t>(nd * K * 128));
    for (int b = 0; b < nd; ++b)
      staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.k + b * p.L.box), &p.tm_k, 64 * b, s * K, bar);
    return;
  }
  staged::mbar_expect(bar, static_cast<uint32_t>((nd + nr) * K * 128 + 2 * D * 2));
  for (int b = 0; b < nd; ++b)
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.v + b * p.L.box), &p.tm_v, 64 * b, s * K, bar);
  for (int b = 0; b < nr; ++b)
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.r + b * p.L.box), &p.tm_r, 64 * b, s * K, bar);
  staged::bulk_copy(slot + static_cast<uint32_t>(p.L.q), p.q + static_cast<size_t>(s) * D, D * 2, bar);
  staged::bulk_copy(slot + static_cast<uint32_t>(p.L.g), p.g + static_cast<size_t>(s) * D, D * 2, bar);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1) knarpe_attn_bwd_staged_kernel(const __grid_constant__ Params p) {
  static_assert(H == 1 || H == 2 || H == 4, "[U | W] hi and lo share one 16-column tile: 2H <= 8");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.n_knn, D = p.d_model, R = p.d_rpe, R1 = R + 1, dh = D / H, NS = p.L.n_stages;
  const uint32_t slots = smem_u32(smem), wsm = smem_u32(smem + p.L.w);
  const uint32_t bar0 = smem_u32(smem + p.L.bar);  // stage st: part 0 at bar0 + 16 st, part 1 8 bytes on
  auto source = [&](int n) { return static_cast<int>(blockIdx.x + n * gridDim.x); };  // the block's n-th source
  const int grp = warp / kGroupWarps, wg = warp % kGroupWarps, gt = tid % kGroupThreads;

  if (gt == 0) {  // a group owns the stages st = grp, grp + kGroups, ...: their barriers, its first sources
    for (int st = grp; st < NS; st += kGroups) {
      staged::mbar_init(bar0 + 16 * st);
      staged::mbar_init(bar0 + 16 * st + 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = grp; n < NS && source(n) < p.n_src; n += kGroups)
      for (int part = 0; part < 2; ++part)
        stage_part(p, slots + n * static_cast<uint32_t>(p.L.slot_bytes), bar0 + 16 * n + 8 * part, source(n), part);
  }
  staged_attn::load_weights(p.w_rpe, p.bias, D, R, p.mw, wsm, smem_u32(smem + p.L.bias), tid);
  // the groups' scratch starts at zero: the padding of [U | W], Z and P stays so
  for (int e = tid; e < static_cast<int>(kGroups * p.L.grp_bytes / 16); e += kThreads)
    reinterpret_cast<uint4*>(smem + p.L.grp)[e] = make_uint4(0u, 0u, 0u, 0u);
  staged::cp_wait_all();
  __syncthreads();

  const int g = lane >> 2, tq = lane & 3;  // an mma fragment's row group and column pair
  const int kp = pad16(K), lda = kp + 8, my = staged::swizzle_mask(R >> 3);
  const float scale = p.scale;
  unsigned char* gs = smem + p.L.grp + grp * p.L.grp_bytes;
  __nv_bfloat16* uw = reinterpret_cast<__nv_bfloat16*>(gs + p.L.guw);  // [R][16]: [U_hi W_hi | U_lo W_lo]
  __nv_bfloat16* zb = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gz);   // [8][R]: Z_hi row h, Z_lo row H + h, swizzled
  // [16][lda]: rows [scale DL_hi | A_hi | 0] then [scale DL_lo | A_lo | 0], 8 rows each; columns K.. zero
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gp);
  __nv_bfloat16* dlb = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gdl);  // [8][lda]: scale DL_hi row h, DL_lo row H + h
  float* lp0 = reinterpret_cast<float*>(gs + p.L.glg);  // [c][j]: rpe_j . [u | w]_c
  float* lp1 = lp0 + 2 * H * K;  // [c][j]: k_jc . q_c (c < H), v_j(c-H) . g_(c-H); after the softmax scale dl, attn
  float* cst = reinterpret_cast<float*>(gs + p.L.gst);  // [0, H): b_k . q_h, [H, 2H): b_v . g_h
  float* asum = cst + 2 * H;                            // sum_j attn_hj
  float* sdl = cst + 3 * H;                             // sum_j scale dl_hj
  __nv_bfloat16* dxb = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gdx) + wg * 256;  // this warp's drpe tile
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // [b_k | b_v]
  constexpr int kR = kMaxK / 32;
  // this lane's B column in [u | w] and in [k Q | v G]: head g of q (g < H) or head g - H of g (H <= g < 2H)
  const int d_lo = (g < H ? g : g - H) * dh, d_hi = g < 2 * H ? d_lo + dh : d_lo;

  for (int n = grp; source(n) < p.n_src; n += kGroups) {
    const int s = source(n), st = n % NS;
    const uint32_t slot = slots + st * static_cast<uint32_t>(p.L.slot_bytes);
    const uint32_t xk = slot + static_cast<uint32_t>(p.L.k), xv = slot + static_cast<uint32_t>(p.L.v);
    const uint32_t xr = slot + static_cast<uint32_t>(p.L.r);
    uint32_t inv_bits = 0;  // the softmax warp's mask: bit r for target lane + 32 r
    if (wg < H) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        if (j < K && p.invalid[static_cast<size_t>(s) * K + j]) inv_bits |= 1u << r;
      }
    }
    float* prow = p.pbuf + static_cast<size_t>(s) * 2 * H * R1;
    const uint32_t bar = bar0 + 16 * st;
    const bool refill = source(n + NS) < p.n_src;  // the stage's next source, the group's too
    staged::mbar_wait(bar, (n / NS) & 1);  // part 0 of this source has landed
    const unsigned char* stage = smem + st * p.L.slot_bytes;
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(stage + p.L.q);
    const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(stage + p.L.g);
    const uint32_t* v2 = reinterpret_cast<const uint32_t*>(g < H ? qb : gb);

    // 1. [u | w][i][c] = W_k[i, head c] . q_c (c < H), W_v[i, head c - H] . g_(c-H) (H <= c < 2H): a warp per
    //    16 rows, two such tiles at a time, B = the head-masked q and g in columns that do not overlap;
    //    split into [U_hi W_hi | U_lo W_lo]. Then the bias terms.
    {
      auto store_uw = [&](int mt, const float (&x)[4], const float (&y)[4]) {
        const int c = 2 * tq;
        if (c < 2 * H) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 16 * mt + g + 8 * hr;
            uint32_t hi, lo;
            staged::split2(x[2 * hr] + y[2 * hr], x[2 * hr + 1] + y[2 * hr + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(uw_at(uw, i, c)) = hi;
            *reinterpret_cast<uint32_t*>(uw_at(uw, i, 8 + c)) = lo;
          }
        }
      };
      for (int mt = wg; mt < R / 16; mt += 2 * kGroupWarps) {  // tiles mt and mt1, four chains of sums
        const int mt1 = mt + kGroupWarps;
        const bool two_t = mt1 < R / 16;
        float u0[4] = {0.f, 0.f, 0.f, 0.f}, w0[4] = {0.f, 0.f, 0.f, 0.f};
        float u1[4] = {0.f, 0.f, 0.f, 0.f}, w1[4] = {0.f, 0.f, 0.f, 0.f};
        const int row0 = 16 * mt + (lane & 15), row1 = 16 * mt1 + (lane & 15);
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t k0[4], v0[4], k1[4], v1[4], b0, b1;
          ldsm_x4(k0, w_addr(wsm, D, p.mw, row0, 2 * ks + (lane >> 4)));
          ldsm_x4(v0, w_addr(wsm, D, p.mw, row0, D / 8 + 2 * ks + (lane >> 4)));
          if (two_t) {
            ldsm_x4(k1, w_addr(wsm, D, p.mw, row1, 2 * ks + (lane >> 4)));
            ldsm_x4(v1, w_addr(wsm, D, p.mw, row1, D / 8 + 2 * ks + (lane >> 4)));
          }
          masked_b(v2, ks, tq, d_lo, d_hi, b0, b1);
          const uint32_t qb0 = g < H ? b0 : 0u, qb1 = g < H ? b1 : 0u, gb0 = g < H ? 0u : b0, gb1 = g < H ? 0u : b1;
          staged::mma_bf16(u0, k0, qb0, qb1);
          staged::mma_bf16(w0, v0, gb0, gb1);
          if (two_t) {
            staged::mma_bf16(u1, k1, qb0, qb1);
            staged::mma_bf16(w1, v1, gb0, gb1);
          }
        }
        store_uw(mt, u0, w0);
        if (two_t) store_uw(mt1, u1, w1);
      }
    }
    for (int c = wg; c < 2 * H; c += kGroupWarps) {
      const int h = c < H ? c : c - H;
      const __nv_bfloat16* vec = c < H ? qb : gb;
      float acc = 0.f;
      for (int d = lane; d < dh; d += 32)
        acc += __bfloat162float(bias[(c < H ? 0 : D) + h * dh + d]) * __bfloat162float(vec[h * dh + d]);
      acc = staged::warp_sum(acc);
      if (lane == 0) cst[c] = acc;
    }
    group_sync(grp);
    staged::mbar_wait(bar + 8, (n / NS) & 1);  // part 1 (k) of this source has landed

    // 2. [logits | dattn] per 16 targets in two items: rpe_j . [u | w] (A = the staged rpe rows, B = [U_hi
    //    W_hi | U_lo W_lo], hi and lo tiles in one lane), and [k_j . Q | v_j . G] (A = the staged k, then v
    //    rows, B = the head-masked q, then g)
    for (int item = wg; item < 2 * (kp / 16); item += kGroupWarps) {
      const int mt = item >> 1, part = item & 1;
      const int arow = min(16 * mt + (lane & 15), K - 1);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (part == 0) {
        for (int ks = 0; ks < R / 16; ks += 2) {
          const bool two = ks + 1 < R / 16;
          uint32_t a0[4], b0[4], a1[4], b1[4];
          ldsm_x4(a0, x_addr(p.L.box, xr, arow, 2 * ks + (lane >> 4)));
          ldsm_x4_t(b0, smem_u32(uw_at(uw, 16 * ks + (lane & 15), 8 * (lane >> 4))));
          if (two) {
            ldsm_x4(a1, x_addr(p.L.box, xr, arow, 2 * ks + 2 + (lane >> 4)));
            ldsm_x4_t(b1, smem_u32(uw_at(uw, 16 * ks + 16 + (lane & 15), 8 * (lane >> 4))));
          }
          staged::mma_bf16(acc[0], a0, b0[0], b0[1]);
          staged::mma_bf16(acc[1], a0, b0[2], b0[3]);
          if (two) {
            staged::mma_bf16(acc[0], a1, b1[0], b1[1]);
            staged::mma_bf16(acc[1], a1, b1[2], b1[3]);
          }
        }
      } else {
        for (int ks = 0; ks < D / 16; ks += 2) {
          const bool two = ks + 1 < D / 16;
          uint32_t ak0[4], av0[4], ak1[4], av1[4], b0, b1, c0 = 0u, c1 = 0u;
          ldsm_x4(ak0, x_addr(p.L.box, xk, arow, 2 * ks + (lane >> 4)));
          ldsm_x4(av0, x_addr(p.L.box, xv, arow, 2 * ks + (lane >> 4)));
          if (two) {
            ldsm_x4(ak1, x_addr(p.L.box, xk, arow, 2 * ks + 2 + (lane >> 4)));
            ldsm_x4(av1, x_addr(p.L.box, xv, arow, 2 * ks + 2 + (lane >> 4)));
          }
          masked_b(v2, ks, tq, d_lo, d_hi, b0, b1);
          if (two) masked_b(v2, ks + 1, tq, d_lo, d_hi, c0, c1);
          staged::mma_bf16(acc[0], ak0, g < H ? b0 : 0u, g < H ? b1 : 0u);
          staged::mma_bf16(acc[1], av0, g < H ? 0u : b0, g < H ? 0u : b1);
          if (two) {
            staged::mma_bf16(acc[0], ak1, g < H ? c0 : 0u, g < H ? c1 : 0u);
            staged::mma_bf16(acc[1], av1, g < H ? 0u : c0, g < H ? 0u : c1);
          }
        }
      }
      float* lp = part == 0 ? lp0 : lp1;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * tq + e;
          if (row < K && c < 2 * H) lp[c * K + row] = acc[0][2 * hr + e] + acc[1][2 * hr + e];
        }
      }
    }
    group_sync(grp);

    // 3. masked softmax over K and dl = attn (dattn - sum attn dattn), one warp per head (as knarpe_bwd.cu);
    //    rows h, H + h of P take scale dl and attn, hi and lo 8 rows apart; lp1 keeps them in float32
    if (wg < H) {
      float lv[kR], dv[kR];
      float m = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        const bool ok = j < K && !((inv_bits >> r) & 1u);
        lv[r] = ok ? (lp0[wg * K + j] + lp1[wg * K + j] + cst[wg]) * scale : -INFINITY;
        dv[r] = j < K ? lp0[(H + wg) * K + j] + lp1[(H + wg) * K + j] + cst[H + wg] : 0.f;
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
          const __nv_bfloat16 vl = __float2bfloat16_rn(v - __bfloat162float(vh));
          pb[wg * lda + j] = vh;
          pb[(8 + wg) * lda + j] = vl;
          pb[(H + wg) * lda + j] = ah;
          pb[(8 + H + wg) * lda + j] = __float2bfloat16_rn(a - __bfloat162float(ah));
          dlb[wg * lda + j] = vh;
          dlb[(H + wg) * lda + j] = vl;
          lp1[wg * K + j] = v;
          lp1[(H + wg) * K + j] = a;
          as += a;
          sds += v;
        }
      }
      as = staged::warp_sum(as);
      sds = staged::warp_sum(sds);
      if (lane == 0) {
        asum[wg] = as;
        sdl[wg] = sds;
        prow[static_cast<size_t>(wg) * R1 + R] = sds;  // row R: the constant input of the bias
        prow[static_cast<size_t>(H + wg) * R1 + R] = as;
      }
    }
    group_sync(grp);

    // 4. [z'; y][c][i] = sum_j P[c][j] rpe_j[i] (z' = scale z): a warp per 16 inputs, A = P, B = the staged
    //    rpe rows; row c (hi) and row 8 + c (lo) sit in one lane. -> pbuf rows, and z' as [Z_hi; Z_lo] (rows
    //    h, H + h)
    for (int np = wg; np < R / 16; np += kGroupWarps) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < kp / 16; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, smem_u32(pb + (lane & 15) * lda + 16 * ks + 8 * (lane >> 4)));
        ldsm_x4_t(b, x_addr(p.L.box, xr, min(16 * ks + (lane & 15), K - 1), 2 * np + (lane >> 4)));
        staged::mma_bf16(acc[0], a, b[0], b[1]);
        staged::mma_bf16(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float v0 = acc[t][0] + acc[t][2], v1 = acc[t][1] + acc[t][3];
        const int i = 16 * np + 8 * t + 2 * tq;
        if (g < 2 * H) {  // pbuf's [2, H] rows: k half (z') for c < H, v half (y) after
          prow[static_cast<size_t>(g) * R1 + i] = v0;
          prow[static_cast<size_t>(g) * R1 + i + 1] = v1;
        }
        if (g < H) {
          uint32_t hi, lo;
          staged::split2(v0, v1, hi, lo);
          const int c = 2 * np + t;
          *reinterpret_cast<uint32_t*>(zb + g * R + 8 * (c ^ (g & my)) + 2 * tq) = hi;
          *reinterpret_cast<uint32_t*>(zb + (H + g) * R + 8 * (c ^ ((H + g) & my)) + 2 * tq) = lo;
        }
      }
    }
    // 5. drpe_j = sum_h scale dl_hj u_h + attn_hj w_h: a warp per 16 inputs (fixed B) and, in turn, each 16
    //    targets; A = [scale DL | A] (P read transposed), B = [U | W] ([R][16] read as rows);
    //    (A_hi + A_lo) B_hi, then (A_hi + A_lo) B_lo. The tile goes through the warp's buffer (stmatrix,
    //    32-byte rows swizzled like [U | W]) to one 32-byte piece of a drpe row per lane.
    for (int cp = wg; cp < R / 16; cp += kGroupWarps) {
      const int mi = lane >> 3, r8 = lane & 7, rr = lane >> 1;
      uint32_t b[4];  // B hi and lo of the pair's two 8-input tiles
      ldsm_x4(b, smem_u32(uw_at(uw, 16 * cp + r8 + 8 * (mi >> 1), 8 * (mi & 1))));
      __nv_bfloat16* dst_base = p.drpe + static_cast<size_t>(s) * K * R + 16 * cp + 8 * (lane & 1);
      for (int mt = 0; mt < kp / 16; ++mt) {
        uint32_t a[4];
        ldsm_x4_t(a, smem_u32(pb + (r8 + 8 * (mi >> 1)) * lda + 16 * mt + 8 * (mi & 1)));
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          staged::mma_bf16(acc[t], a, b[2 * t], b[2 * t]);
          staged::mma_bf16(acc[t], a, b[2 * t + 1], b[2 * t + 1]);
        }
        const int sr = r8 + 8 * (mi & 1), sc = mi >> 1;
        staged_bwd::stsm_x4(smem_u32(dxb + sr * 16 + 8 * (sc ^ ((sr >> 2) & 1))),
                            staged_bwd::pack_bf16(acc[0][0], acc[0][1]), staged_bwd::pack_bf16(acc[0][2], acc[0][3]),
                            staged_bwd::pack_bf16(acc[1][0], acc[1][1]), staged_bwd::pack_bf16(acc[1][2], acc[1][3]));
        __syncwarp();
        const int j = 16 * mt + rr;
        if (j < K)
          *reinterpret_cast<uint4*>(dst_base + static_cast<size_t>(j) * R) =
              *reinterpret_cast<const uint4*>(dxb + rr * 16 + 8 * ((lane & 1) ^ ((rr >> 2) & 1)));
        __syncwarp();
      }
    }
    // 6. dk_jh = scale dl_hj q_h, dv_jh = attn_hj g_h: eight values of one row a thread, one 16-byte store;
    //    the thread walks rows jr of [dk; dv] ([2K][D / 8] chunks) by a fixed step, without divisions
    {
      const int cpr = D >> 3, dj = kGroupThreads / cpr, dc = kGroupThreads - dj * cpr;
      const float rdh = 1.f / dh;  // (d + 0.5) rdh rounds down to d / dh for every column d < 2^20
      int jr = gt / cpr, c8 = gt - jr * cpr;
      for (; jr < 2 * K; jr += dj, c8 += dc) {
        if (c8 >= cpr) {
          c8 -= cpr;
          if (++jr >= 2 * K) break;
        }
        const bool is_v = jr >= K;
        const int j = is_v ? jr - K : jr, d0 = 8 * c8;
        const int h0 = static_cast<int>((d0 + 0.5f) * rdh), h1 = static_cast<int>((d0 + 4.5f) * rdh);  // dh % 4 == 0
        const uint4 src = *reinterpret_cast<const uint4*>((is_v ? gb : qb) + d0);
        const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&src);
        const float* f = lp1 + (is_v ? H : 0) * K + j;  // scale dl or attn of head h at f[h K]
        const float f0 = f[h0 * K], f1 = f[h1 * K];
        uint4 o;
        uint32_t* o2 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 x = __bfloat1622float2(s2[t]);
          const float ft = t < 2 ? f0 : f1;
          o2[t] = staged_bwd::pack_bf16(ft * x.x, ft * x.y);
        }
        *reinterpret_cast<uint4*>((is_v ? p.dv : p.dk) + (static_cast<size_t>(s) * K + j) * D + d0) = o;
      }
    }
    group_sync(grp);
    if (gt == 0 && refill) {  // v, rpe, q and g are read: part 0 of the stage's next source streams in
      staged::fence_proxy_async();
      stage_part(p, slot, bar, source(n + NS), 0);
    }

    // 7. dq[d] = z'_h(d) . W_k[:, d] + sum_j scale dl_h(d)j k_j[d] + b_k[d] sum_j scale dl_h(d)j, as dq^T =
    //    W_k^T Z'^T + k^T DL^T: a warp per 16 columns d, two such tiles at a time (four chains of sums), A =
    //    W_k^T (weight rows by ldmatrix.trans), then k^T (the staged k rows), B = [Z_hi; Z_lo] then [DL_hi;
    //    DL_lo] (8 rows c: hi h, lo H + h); column h(d) hi and lo are kept
    {
      const int r8 = lane & 7, hb = (lane >> 3) & 1, arow = r8 + 8 * (lane >> 4);
      auto store_dq = [&](int mt, const float (&x)[4], const float (&y)[4]) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int d = 16 * mt + g + 8 * hr, h = d / dh;
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // column c = 2 tq + e: hi of head c, or lo of head c - H
            float v = x[2 * hr + e] + y[2 * hr + e];
            if constexpr (H == 1) v = e == 0 ? v + x[2 * hr + 1] + y[2 * hr + 1] : 0.f;
            else v = staged::hi_plus_lo<H, true>(v, 0.f);
            if (2 * tq + e == h)
              p.dq[static_cast<size_t>(s) * D + d] = __float2bfloat16_rn(v + __bfloat162float(bias[d]) * sdl[h]);
          }
        }
      };
      for (int mt = wg; mt < D / 16; mt += 2 * kGroupWarps) {  // tiles mt and mt1, four chains of sums
        const int mt1 = mt + kGroupWarps;
        const bool two_t = mt1 < D / 16;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        // one k step of both tiles: A from the weights (W_k^T) or the staged k rows (k^T), B shared
        auto k_step = [&](bool from_w, int ks, float (&x)[4], float (&y)[4]) {
          uint32_t ax[4], ay[4], b[2];
          if (from_w) {
            ldsm_x4_t(ax, w_addr(wsm, D, p.mw, 16 * ks + arow, 2 * mt + hb));
            if (two_t) ldsm_x4_t(ay, w_addr(wsm, D, p.mw, 16 * ks + arow, 2 * mt1 + hb));
            const int c = 2 * ks + hb;
            ldsm_x2(b, smem_u32(zb + r8 * R + 8 * (c ^ (r8 & my))));
          } else {
            const int j = min(16 * ks + arow, K - 1);
            ldsm_x4_t(ax, x_addr(p.L.box, xk, j, 2 * mt + hb));
            if (two_t) ldsm_x4_t(ay, x_addr(p.L.box, xk, j, 2 * mt1 + hb));
            ldsm_x2(b, smem_u32(dlb + r8 * lda + 16 * ks + 8 * hb));
          }
          staged::mma_bf16(x, ax, b[0], b[1]);
          if (two_t) staged::mma_bf16(y, ay, b[0], b[1]);
        };
        for (int ks = 0; ks < R / 16; ks += 2) {
          k_step(true, ks, a0, c0);
          if (ks + 1 < R / 16) k_step(true, ks + 1, a1, c1);
        }
        for (int ks = 0; ks < kp / 16; ks += 2) {
          k_step(false, ks, a0, c0);
          if (ks + 1 < kp / 16) k_step(false, ks + 1, a1, c1);
        }
        store_dq(mt, a0, a1);
        if (two_t) store_dq(mt1, c0, c1);
      }
    }
    group_sync(grp);  // the group is done with the stage and its scratch
    if (gt == 0 && refill) {
      staged::fence_proxy_async();
      stage_part(p, slot, bar + 8, source(n + NS), 1);
    }
  }
}

}  // namespace staged_attn_bwd
