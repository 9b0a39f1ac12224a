// The bf16 KNARPE KNN self-attention forward B4, redesigned for Hopper: four
// groups of warps per SM, each computing its own source while the next one it
// will compute streams into its stages by 2-D tensor copies, and every
// per-source product on the tensor cores.
//
// Replaces, for bf16 operands, trafficbotsv15_tpu/ops/pallas_knarpe.py
// _fwd_kernel (:99-125, launched at :243), the forward of knarpe_attention.
// knarpe.cu keeps float32 B4 and the bf16 shapes refused below (its general
// kernel). Contract as knarpe.cu's header says: k and v are rows of D at
// stride ld_kv (the halves of one [.., 2D] tensor, or two tensors).
//
// What bounds it: the bytes. At the eval path's shape (4 x 1024 sources, K=32,
// D=R=128, H=4) a launch must read k, v and rpe (32 x 768 B per source), q,
// the mask and the weights and write out: 103.0 MB, 0.0307 ms at 3.35 TB/s
// (8 x 1024 sources in training: 0.061 ms). The reassociated algebra of
// knarpe.cu (x_j = rpe_j, u_h = W_k[:, h] q_h) needs ~74 K multiply-adds a
// source, 0.6 GFLOP a launch. The previous design (knarpe.cu's general
// kernel) walked one source at a time per SM behind six block barriers,
// read each target's k and rpe rows straight from device memory one bf16 per
// lane, rpe twice and v one element per thread, and did every product on the
// CUDA cores: ~8 us a source, 12 % of the bound. One source's work is a chain
// of short dependent steps (a phase-clock build put each at 1.5-5 K cycles),
// so here several sources are in flight per SM:
//   - one persistent 512-thread block per SM: four groups of four warps.
//     Group c takes the block's sources c, c + 4, c + 8, ..., each step
//     closed by the group's own named barrier (five a source), so while one
//     group waits, three others compute. Two groups gave each step only
//     ~15-25 % less time and the launch ~60 % more;
//   - n_stages source stages (4 at the flagship; 8, two a group, where they
//     fit), stage st owned by group st % 4: a group waits on its own stages'
//     mbarriers in order (a wait on a parity cannot tell a phase from the one
//     two later, so no group may wait on another's stage) and refills them
//     itself, so no producer warp is needed (a 17th warp capped the registers
//     at 96 a thread and spilled). A stage holds k, rpe and q (part 0) and v
//     (part 1), each on its own mbarrier: k, rpe and q are read by the y step,
//     so part 0 of the stage's next source is issued right after it, and v
//     after the out step, which alone waits on part 1. The group's next
//     source lands while it computes this one. k, v and rpe come by 2-D
//     tensor copies (cp.async.bulk.tensor, boxes of 64 columns by K rows with
//     the 128-byte swizzle, so that the eight rows an ldmatrix reads fall on
//     distinct banks; k and v each by their own tensor map at stride ld_kv,
//     so both layouts take this route), q by a bulk copy. Each byte is read
//     from device memory once;
//   - the bf16 W_rpe [R, 2D] and the bias stay resident, rows XOR-swizzled;
//   - every product runs as mma.sync.m16n8k16 (bf16 in, float32 sums); u is
//     float32, so it is split into bf16 hi + lo (16 significant bits) and both
//     halves go through the product, as knarpe_staged.cuh does, so results
//     reach float32 level before the single bf16 rounding. Per source and
//     group:
//       u     = W_k Q, Q [D, 8] the head-masked q in registers -> [U_hi | U_lo];
//       lgt   = rpe [U_hi | U_lo] (one warp) + k Q (another warp), per 16
//               targets, K padded to 16 by repeating row K-1, never stored;
//       softmax over K per head (one warp per head, each lane's targets in
//               registers), writing [A_hi; A_lo];
//       y     = [A_hi; A_lo] rpe -> [Y_hi; Y_lo];
//       out^T = W_v^T [Y_hi; Y_lo]^T + v^T [A_hi; A_lo]^T (16 columns d a tile,
//               the 2H rows of Y and A as the n of the product, so half the
//               products of out = Y W_v), column h(d) hi + lo kept, + b_v Σa;
//     each warp takes two 16-row tiles at a time in the u and out steps;
//   - the budget at the flagship (a block may use 232,448 B): a stage 25,600 B
//     (six boxes of 4,096 B, q 256 B, rounded up to the 1,024 B the swizzle
//     needs), four stages 102,400 B; W_rpe 65,536 B and the bias 512 B; per
//     group 4,400 B ([U_hi | U_lo] then [Y_hi; Y_lo] 2,048 B, the two partial
//     logits 1,024 B, [A_hi; A_lo] 1,280 B (16 rows of K padded to 32, + 8 so
//     that rows fall on distinct banks), three per-head scalars 48 B), four
//     groups 17,600 B; the mbarriers 64 B; 1,024 B to align: 187,136 B. Eight
//     stages would need 289,600 B.
// No atomics: every sum has a fixed order, so two launches on the same inputs
// give the same bits. A source with no valid target gets a zero output.

#pragma once

#include "knarpe_staged.cuh"

namespace staged_attn {

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

constexpr int kGroups = 4, kGroupWarps = 4;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kMaxK = 128;  // the softmax keeps K / 32 targets per lane in registers
constexpr int kMaxStages = 2 * kGroups;

// Byte offsets from the block's 1024-byte aligned base in dynamic shared memory (total counts the
// alignment's slack): n_stages stages, then the resident weights, the groups' scratch and the
// mbarriers. A stage's fields (k, v, r: boxes of box bytes; q) are offsets inside it, a group's (gu, glg,
// ga, ghv) offsets inside its scratch.
struct Layout {
  int n_stages;
  size_t box, k, v, r, q, slot_bytes, w, bias, grp, grp_bytes, gu, glg, ga, ghv, bar, total;
};

inline Layout make_layout(int K, int D, int R, int H, int n_stages) {
  Layout L{};
  L.n_stages = n_stages;
  L.box = box_bytes(K);
  L.k = 0;
  L.v = n_boxes(D) * L.box;
  L.r = 2 * L.v;
  L.q = L.r + n_boxes(R) * L.box;
  L.slot_bytes = a1024(L.q + static_cast<size_t>(D) * 2);
  size_t off = n_stages * L.slot_bytes;
  L.w = off;    off += static_cast<size_t>(R) * 2 * D * 2;
  L.bias = off; off += a16(static_cast<size_t>(D) * 2 * 2);
  L.gu = 0;                                                        // [U_hi | U_lo] [R][8], later [Y_hi; Y_lo] [8][R]
  L.glg = a16(static_cast<size_t>(R) * 8 * 2);                     // partial logits [2][H][K]
  L.ga = L.glg + a16(static_cast<size_t>(2) * H * K * 4);          // [A_hi; A_lo] [16][pad16(K) + 8]
  L.ghv = L.ga + static_cast<size_t>(16) * (pad16(K) + 8) * 2;     // c, sum attn, no-valid flag per head
  L.grp_bytes = a16(L.ghv + static_cast<size_t>(3) * H * 4);
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

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::ATTN_STAGED_REFUSALS words each code
// (5, no block fits a multiprocessor, comes from the plan).
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (K < 1 || K > kMaxK) return 1;
  if (D % 16 || R % 16) return 2;
  if (H > 4) return 3;
  if (stage_count(K, D, R, H, max_smem) == 0) return 4;
  return 0;
}

struct Params {
  CUtensorMap tm_k, tm_v, tm_r;  // k, v (rows of D at stride ld_kv) and rpe [n_src K, R]: boxes of 64 x K
  const __nv_bfloat16 *q, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16* out;
  int n_src, n_knn, d_model, d_rpe;
  int mw;  // swizzle mask of the weight rows
  float scale;
  Layout L;
};

// shared address of 16-byte chunk c of row j in the boxes at shared address region
__device__ __forceinline__ uint32_t x_addr(size_t box, uint32_t region, int j, int c) {
  return region + static_cast<uint32_t>((c >> 3) * box) + j * 128 + (((c & 7) ^ (j & 7)) << 4);
}
// shared address of 16-byte chunk c (of 2D / 8) of resident weight row i
__device__ __forceinline__ uint32_t w_addr(uint32_t w, int d_model, int mw, int i, int c) {
  return w + static_cast<uint32_t>(i * (d_model >> 2) + (c ^ (i & mw))) * 16;
}
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(kGroupThreads) : "memory");
}
// The head-masked B fragment of a vector v (bf16 pairs v2) for an mma column whose head's entries are
// [d_lo, d_hi): rows d0, d0 + 1 (b0) and d0 + 8, d0 + 9 (b1) of k step ks, zero outside the head.
__device__ __forceinline__ void masked_b(const uint32_t* v2, int ks, int tq, int d_lo, int d_hi, uint32_t& b0,
                                         uint32_t& b1) {
  const int d0 = 16 * ks + 2 * tq;
  b0 = d0 >= d_lo && d0 < d_hi ? v2[d0 >> 1] : 0u;
  b1 = d0 + 8 >= d_lo && d0 + 8 < d_hi ? v2[(d0 + 8) >> 1] : 0u;
}

// cp.async of the resident W_rpe (rows XOR-swizzled by mw) and the bias by every thread; the caller
// waits (cp_wait_all) and synchronises
__device__ __forceinline__ void load_weights(const __nv_bfloat16* w_rpe, const __nv_bfloat16* bias, int D, int R,
                                             int mw, uint32_t w, uint32_t b, int tid) {
  const int cw = D >> 2;
  for (int e = tid; e < R * cw; e += kThreads) {
    const int i = e / cw, c = e - i * cw;
    staged::cp_async16(w + (i * cw + (c ^ (i & mw))) * 16, w_rpe + static_cast<size_t>(i) * 2 * D + c * 8);
  }
  for (int c = tid; c < cw; c += kThreads) staged::cp_async16(b + c * 16, bias + c * 8);
}

// Part 0 (k, rpe and q) or part 1 (v) of source s into the stage at slot, by tensor copies (q by a bulk
// copy), counted on bar: a group refills part 0 of its stage once it has read k, rpe and q (after the y
// step) and part 1 after the out step, and waits on part 1 only before its out step.
__device__ __forceinline__ void stage_part(const Params& p, uint32_t slot, uint32_t bar, int s, int part) {
  const int K = p.n_knn, D = p.d_model, nd = n_boxes(D), nr = n_boxes(p.d_rpe);
  if (part == 1) {
    staged::mbar_expect(bar, static_cast<uint32_t>(nd * K * 128));
    for (int b = 0; b < nd; ++b)
      staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.v + b * p.L.box), &p.tm_v, 64 * b, s * K, bar);
    return;
  }
  staged::mbar_expect(bar, static_cast<uint32_t>((nd + nr) * K * 128 + D * 2));
  for (int b = 0; b < nd; ++b)
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.k + b * p.L.box), &p.tm_k, 64 * b, s * K, bar);
  for (int b = 0; b < nr; ++b)
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.r + b * p.L.box), &p.tm_r, 64 * b, s * K, bar);
  staged::bulk_copy(slot + static_cast<uint32_t>(p.L.q), p.q + static_cast<size_t>(s) * D, D * 2, bar);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1) knarpe_attn_staged_kernel(const __grid_constant__ Params p) {
  static_assert(H == 1 || H == 2 || H == 4, "[U_hi | U_lo] takes 2H <= 8 columns");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: stages start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.n_knn, D = p.d_model, R = p.d_rpe, dh = D / H, NS = p.L.n_stages;
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
  load_weights(p.w_rpe, p.bias, D, R, p.mw, wsm, smem_u32(smem + p.L.bias), tid);
  // the groups' scratch starts at zero: the padding of [U | .], [Y; .] and [A; .] stays so
  for (int e = tid; e < static_cast<int>(kGroups * p.L.grp_bytes / 16); e += kThreads)
    reinterpret_cast<uint4*>(smem + p.L.grp)[e] = make_uint4(0u, 0u, 0u, 0u);
  staged::cp_wait_all();
  __syncthreads();

  const int g = lane >> 2, tq = lane & 3;  // an mma fragment's row group and column pair
  const int kp = pad16(K), lda = kp + 8, my = staged::swizzle_mask(R >> 3);
  const float scale = p.scale;
  unsigned char* gs = smem + p.L.grp + grp * p.L.grp_bytes;
  __nv_bfloat16* ub = reinterpret_cast<__nv_bfloat16*>(gs + p.L.gu);  // [U_hi | U_lo] [R][8]
  __nv_bfloat16* yb = ub;  // later [Y_hi; Y_lo] [8][R] (hi row h, lo row H + h), chunks swizzled with the row
  float* lg = reinterpret_cast<float*>(gs + p.L.glg);  // [part][h][j]: rpe . u_h, then k_jh . q_h
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(gs + p.L.ga);  // [16][lda]: A_hi row h, A_lo row H + h, 0
  float* cvec = reinterpret_cast<float*>(gs + p.L.ghv);
  float* asum = cvec + H;
  float* nvh = cvec + 2 * H;
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // [b_k | b_v]
  constexpr int kR = kMaxK / 32;

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
    const uint32_t bar = bar0 + 16 * st;
    const bool refill = source(n + NS) < p.n_src;  // the stage's next source, the group's too
    staged::mbar_wait(bar, (n / NS) & 1);  // part 0 of this source has landed
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(smem + st * p.L.slot_bytes + p.L.q);
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qb);

    // 1. u[i][h] = W_k[i, head h] . q_h: a warp per 16 rows, two such tiles at a time (mt and mt + 4) and
    //    two k steps, loads first (four chains of sums); B = the head-masked q (column g = head g); u split
    //    into [U_hi | U_lo]. Then c[h] = b_k[head h] . q_h
    {
      auto store_u = [&](int mt, const float (&x)[4], const float (&y)[4]) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 16 * mt + g + 8 * hr, h = 2 * tq;
          if (h < H) {
            uint32_t hi, lo;
            staged::split2(x[2 * hr] + y[2 * hr], x[2 * hr + 1] + y[2 * hr + 1], hi, lo);
            if (h + 1 < H) {
              *reinterpret_cast<uint32_t*>(ub + i * 8 + h) = hi;
              *reinterpret_cast<uint32_t*>(ub + i * 8 + H + h) = lo;
            } else {  // H == 1
              ub[i * 8 + h] = __ushort_as_bfloat16(static_cast<unsigned short>(hi & 0xffffu));
              ub[i * 8 + H + h] = __ushort_as_bfloat16(static_cast<unsigned short>(lo & 0xffffu));
            }
          }
        }
      };
      for (int mt = wg; mt < R / 16; mt += 2 * kGroupWarps) {
        const int mt1 = mt + kGroupWarps;
        const bool two_t = mt1 < R / 16;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};  // tile mt, even and odd k steps
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};  // tile mt1
        const int row0 = 16 * mt + (lane & 15), row1 = 16 * mt1 + (lane & 15);
        for (int ks = 0; ks < D / 16; ks += 2) {
          const bool two_k = ks + 1 < D / 16;
          uint32_t x0[4], x1[4], y0[4], y1[4], b0, b1, e0 = 0u, e1 = 0u;
          ldsm_x4(x0, w_addr(wsm, D, p.mw, row0, 2 * ks + (lane >> 4)));
          if (two_k) ldsm_x4(x1, w_addr(wsm, D, p.mw, row0, 2 * ks + 2 + (lane >> 4)));
          if (two_t) {
            ldsm_x4(y0, w_addr(wsm, D, p.mw, row1, 2 * ks + (lane >> 4)));
            if (two_k) ldsm_x4(y1, w_addr(wsm, D, p.mw, row1, 2 * ks + 2 + (lane >> 4)));
          }
          masked_b(q2, ks, tq, g * dh, g * dh + dh, b0, b1);
          if (two_k) masked_b(q2, ks + 1, tq, g * dh, g * dh + dh, e0, e1);
          staged::mma_bf16(a0, x0, b0, b1);
          if (two_k) staged::mma_bf16(a1, x1, e0, e1);
          if (two_t) {
            staged::mma_bf16(c0, y0, b0, b1);
            if (two_k) staged::mma_bf16(c1, y1, e0, e1);
          }
        }
        store_u(mt, a0, a1);
        if (two_t) store_u(mt1, c0, c1);
      }
    }
    if (wg < H) {
      float acc = 0.f;
      for (int d = lane; d < dh; d += 32) acc += __bfloat162float(bias[wg * dh + d]) * __bfloat162float(qb[wg * dh + d]);
      acc = staged::warp_sum(acc);
      if (lane == 0) cvec[wg] = acc;
    }
    group_sync(grp);

    // 2. logits, per 16 targets in two items: rpe_j . u_h (A = the staged rpe rows, B = [U_hi | U_lo],
    //    column h hi and H + h lo) and k_jh . q_h (A = the staged k rows, B = the head-masked q); two k
    //    steps at a time, loads first
    for (int item = wg; item < 2 * (kp / 16); item += kGroupWarps) {
      const int mt = item >> 1, part = item & 1;
      const int arow = min(16 * mt + (lane & 15), K - 1);
      float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
      if (part == 0) {
        for (int ks = 0; ks < R / 16; ks += 2) {
          const bool two = ks + 1 < R / 16;
          uint32_t a0[4], a1[4], b0[2], b1[2];
          ldsm_x4(a0, x_addr(p.L.box, xr, arow, 2 * ks + (lane >> 4)));
          ldsm_x2_t(b0, smem_u32(ub + (16 * ks + (lane & 15)) * 8));
          if (two) {
            ldsm_x4(a1, x_addr(p.L.box, xr, arow, 2 * ks + 2 + (lane >> 4)));
            ldsm_x2_t(b1, smem_u32(ub + (16 * ks + 16 + (lane & 15)) * 8));
          }
          staged::mma_bf16(acc0, a0, b0[0], b0[1]);
          if (two) staged::mma_bf16(acc1, a1, b1[0], b1[1]);
        }
      } else {
        for (int ks = 0; ks < D / 16; ks += 2) {
          const bool two = ks + 1 < D / 16;
          uint32_t a0[4], a1[4], b0, b1, c0 = 0u, c1 = 0u;
          ldsm_x4(a0, x_addr(p.L.box, xk, arow, 2 * ks + (lane >> 4)));
          if (two) ldsm_x4(a1, x_addr(p.L.box, xk, arow, 2 * ks + 2 + (lane >> 4)));
          masked_b(q2, ks, tq, g * dh, g * dh + dh, b0, b1);
          if (two) masked_b(q2, ks + 1, tq, g * dh, g * dh + dh, c0, c1);
          staged::mma_bf16(acc0, a0, b0, b1);
          if (two) staged::mma_bf16(acc1, a1, c0, c1);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int h = 2 * tq + e;
          float v = acc0[2 * hr + e] + acc1[2 * hr + e];
          if (part == 0) {  // column h holds hi, column H + h lo
            if constexpr (H == 1) v = e == 0 ? v + acc0[2 * hr + 1] + acc1[2 * hr + 1] : 0.f;
            else v = staged::hi_plus_lo<H, true>(v, 0.f);
          }
          if (h < H && row < K) lg[(part * H + h) * K + row] = v;
        }
      }
    }
    group_sync(grp);

    // 3. masked softmax over K, one warp per head, target lane + 32 r in registers (as
    //    pallas_knarpe.py:_fwd_core); attn as rows h (hi) and H + h (lo) of A
    if (wg < H) {
      float lv[kR];
      float m = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        const bool ok = j < K && !((inv_bits >> r) & 1u);
        lv[r] = ok ? (lg[wg * K + j] + lg[(H + wg) * K + j] + cvec[wg]) * scale : -INFINITY;
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
          ab[(H + wg) * lda + j] = __float2bfloat16_rn(a - __bfloat162float(hi));
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

    // 4. y[h][i] = sum_j attn_hj rpe_j[i]: a warp per 16 inputs, A = [A_hi; A_lo], B = the staged rpe rows;
    //    row h holds hi and row H + h lo, summed, then split again into [Y_hi; Y_lo] (rows h, H + h)
    for (int np = wg; np < R / 16; np += kGroupWarps) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < kp / 16; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, smem_u32(ab + (lane & 15) * lda + 16 * ks + 8 * (lane >> 4)));
        ldsm_x4_t(b, x_addr(p.L.box, xr, min(16 * ks + (lane & 15), K - 1), 2 * np + (lane >> 4)));
        staged::mma_bf16(acc[0], a, b[0], b[1]);
        staged::mma_bf16(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float v0 = staged::hi_plus_lo<H, false>(acc[t][0], acc[t][2]);
        const float v1 = staged::hi_plus_lo<H, false>(acc[t][1], acc[t][3]);
        if (g < H) {
          uint32_t hi, lo;
          staged::split2(v0, v1, hi, lo);
          const int c = 2 * np + t;
          *reinterpret_cast<uint32_t*>(yb + g * R + 8 * (c ^ (g & my)) + 2 * tq) = hi;
          *reinterpret_cast<uint32_t*>(yb + (H + g) * R + 8 * (c ^ ((H + g) & my)) + 2 * tq) = lo;
        }
      }
    }
    group_sync(grp);
    if (gt == 0 && refill) {  // k, rpe and q are read: part 0 of the stage's next source streams in
      staged::fence_proxy_async();
      stage_part(p, slot, bar, source(n + NS), 0);
    }

    // 5. out[d] = y_h(d) . W_v[:, d] + sum_j attn_h(d)j v_j[d] + b_v[d] sum_j attn_h(d)j, as out^T =
    //    W_v^T Y^T + v^T A^T: a warp per 16 columns d, two such tiles at a time (four chains of sums), A =
    //    W_v^T (weight rows by ldmatrix.trans), then v^T (the staged v rows), B = [Y_hi; Y_lo] then [A_hi;
    //    A_lo] (8 rows c: hi h, lo H + h); column h(d) hi and lo are kept
    staged::mbar_wait(bar + 8, (n / NS) & 1);  // part 1 (v) of this source has landed
    {
      const int r8 = lane & 7, hb = (lane >> 3) & 1, arow = r8 + 8 * (lane >> 4);
      auto store_out = [&](int mt, const float (&x)[4], const float (&y)[4]) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int d = 16 * mt + g + 8 * hr, h = d / dh;
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // column c = 2 tq + e: hi of head c, or lo of head c - H
            float v = x[2 * hr + e] + y[2 * hr + e];
            if constexpr (H == 1) v = e == 0 ? v + x[2 * hr + 1] + y[2 * hr + 1] : 0.f;
            else v = staged::hi_plus_lo<H, true>(v, 0.f);
            if (2 * tq + e == h) {
              const float o = v + __bfloat162float(bias[D + d]) * asum[h];
              p.out[static_cast<size_t>(s) * D + d] = __float2bfloat16_rn(nvh[h] != 0.f ? 0.f : o);
            }
          }
        }
      };
      for (int mt = wg; mt < D / 16; mt += 2 * kGroupWarps) {  // tiles mt and mt1, four chains of sums
        const int mt1 = mt + kGroupWarps;
        const bool two_t = mt1 < D / 16;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        // one k step of both tiles: A from the weights (W_v^T) or the staged v rows (v^T), B shared
        auto k_step = [&](bool from_w, int ks, float (&x)[4], float (&y)[4]) {
          uint32_t ax[4], ay[4], b[2];
          if (from_w) {
            ldsm_x4_t(ax, w_addr(wsm, D, p.mw, 16 * ks + arow, D / 8 + 2 * mt + hb));
            if (two_t) ldsm_x4_t(ay, w_addr(wsm, D, p.mw, 16 * ks + arow, D / 8 + 2 * mt1 + hb));
            const int c = 2 * ks + hb;
            ldsm_x2(b, smem_u32(yb + r8 * R + 8 * (c ^ (r8 & my))));
          } else {
            const int j = min(16 * ks + arow, K - 1);
            ldsm_x4_t(ax, x_addr(p.L.box, xv, j, 2 * mt + hb));
            if (two_t) ldsm_x4_t(ay, x_addr(p.L.box, xv, j, 2 * mt1 + hb));
            ldsm_x2(b, smem_u32(ab + r8 * lda + 16 * ks + 8 * hb));
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
        store_out(mt, a0, a1);
        if (two_t) store_out(mt1, c0, c1);
      }
    }
    group_sync(grp);  // the group is done with the stage and its scratch
    if (gt == 0 && refill) {
      staged::fence_proxy_async();
      stage_part(p, slot, bar + 8, source(n + NS), 1);
    }
  }
}

}  // namespace staged_attn
