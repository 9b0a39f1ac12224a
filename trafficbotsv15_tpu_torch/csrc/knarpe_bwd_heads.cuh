// The bf16 KNARPE cross-attention backward B2/B3-bwd at the scaled preset's widths (D = R = 256, 8 heads): eight
// blocks per source, one on each head, and a second pass that sums dtgt | drpe over the eight.
//
// Replaces, for bf16 operands at d_model = d_rpe = 256 with 8 heads, the only widths it is compiled for,
// trafficbotsv15_tpu/ops/pallas_knarpe.py _x_bwd_kernel (:463-547, launched at :579 from _knarpe_x_bwd_pallas), the
// backward of knarpe_cross_attention (B2) and of knarpe_cross_attention_v3 (B3, whose backward is B2's, :778-783).
// Contract as knarpe_bwd.cu's header says: per source it writes dq, dtgt, drpe and its rows of pbuf,
// P = [scale z_h | scale sum dl_hj] and [y_h | sum attn_hj], and knarpe_bwd.cu's two weight-gradient passes follow it
// unchanged. knarpe_bwd_staged.cuh keeps every shape it takes (up to 4 heads: the flagship's D = R = 128); the general
// kernel of knarpe_bwd.cu the shapes both refuse (K > 128 here).
//
// Its bound is the bytes. At the scaled training step's shape (1 x 64 sources, K=89, D=R=256, H=8) a launch must read
// tgt, rpe, q, g, the mask and the weights and write dtgt, drpe, dq and the weight gradients: 12.8 MB, 0.0038 ms at
// 3.35 TB/s; the reassociated work is ~2.84 M multiply-adds per source. The staged backward puts [U | W] hi and lo of
// every head in one 16-column tile (2H <= 8), so it refuses 8 heads; the general kernel took the shape (one source per
// block, so 64 of the 132 SMs at work; float32 multiply-adds on the CUDA cores one output per thread; x_j read twice;
// the 512 KB [W_kv; W_rpe] through L1/L2) in ~0.28 ms, 1.4 % of the bound. With knarpe_bwd.cu's reassociation
// (x_j = [tgt_j | rpe_j], X = 512 inputs, u_h = W_k[:, h] q_h, w_h = W_v[:, h] g_h) every term but dx needs one head's
// columns of the weights, q and g, and all of x:
//   logit_hj = scale (x_j . u_h + b_k,h . q_h),  dattn_hj = x_j . w_h + b_v,h . g_h,
//   dl_hj = attn_hj (dattn_hj - sum_j attn_hj dattn_hj),  z'_h = sum_j scale dl_hj x_j,  y_h = sum_j attn_hj x_j,
//   dq_h = z'_h W_k[:, h] + b_k,h sum_j scale dl_hj,
// so a block that holds one head's columns of the weights ([W_k | W_v][:, 32 h .. 32 h + 32) over all X rows, 65,536
// B) computes that head's 32 columns of dq and its rows of pbuf alone. dx_j = sum_h scale dl_hj u_h + attn_hj w_h runs
// over all eight heads: the one sum across the blocks. Each block writes its factors, F = [scale dl_h | attn_h] ([K, 2]
// float32) and G = [u_h | w_h] ([2, X] float32), into a float32 scratch after pbuf, and a second kernel forms
// dx = F G over the sixteen columns of the eight blocks, in block order, in float32, rounded once to bf16: ~38 KB a
// source (2.4 MB at 64 sources) written and read back, against a cluster of the eight blocks, which would make each
// source wait on its slowest block (the finding of knarpe_attn_bwd_heads.cuh's drpe pass).
//   - block b takes head h = b % 8 of the sources b / 8, b / 8 + n_slots, ...: the eight heads of a source run on
//     neighbouring blocks of the persistent grid at the same pace, so each x row comes from device memory once and
//     seven times from L2; the blocks keep their head's weights resident across their sources;
//   - a block's sixteen warps work on one source at a time in one stage, filled by 2-D tensor copies of the source's
//     [tgt | rpe] rows (eight boxes of 64 columns by K rows, the 128-byte swizzle) on an mbarrier, and refilled with
//     the block's next source as soon as the z/y step has read it; that source is prefetched into L2 (each of its eight
//     blocks an eighth) when the current one starts. Where two blocks fit an SM (K <= 32 on an H100), two run there,
//     and one's chain of steps overlaps the other's (at K=24, 1.22x against a ring of four stages in one block, which
//     ran eight sources' chains back to back). A second stage does not fit beside the weights at K=89. q's and g's
//     head columns (64 B each) are loaded a source ahead by plain loads, so the u/w step runs while the stage lands.
//     Five block barriers a source;
//   - every product on mma.sync.m16n8k16 (bf16 operands, float32 sums); the float32 u, w, scale dl, attn and z' split
//     into bf16 hi + lo, both halves through the product, so results reach float32 level before the one rounding to
//     bf16 at each output. Per source and block (the columns of an n=8 tile in brackets; columns 4-7 stay empty, which
//     costs nothing that matters, since the bytes bound the kernel and not the tensor cores):
//       [u | w]       = W_k Q + W_v G, Q and G the head's q and g (columns 0 and 1) -> [U_hi | U_lo | W_hi | W_lo]
//                       [X][8] and G's rows; c_h = b_k,h . q_h, e_h = b_v,h . g_h;
//       [lgt | dattn] = x [U_hi | U_lo | W_hi | W_lo], per 16 targets and quarter of X (two boxes; the quarters'
//                       partials summed in a fixed order by the softmax); a row past K - 1 reads other bytes of the
//                       shared memory and its results are dropped (a row of the product depends on its row of A alone);
//       softmax, dl   over K (one warp) -> P = [sDL_hi; sDL_lo; A_hi; A_lo] [4][K] (sDL = scale dl), F, the sums;
//       [z' | y]^T    = x^T P^T (16 rows of X a tile) -> pbuf, and z' as [Z_hi | Z_lo] over [U_hi | U_lo];
//       dq^T          = W_k^T [Z_hi | Z_lo] (two 16-column tiles by eight quarters of the k steps, one warp each, the
//                       partials summed in order) + b_k sum scale dl;
//     a target tile's rows are clamped to K - 1 only where the tile passes K and the product sums over targets (the
//     z/y step: P is 0 there, the row must be data);
//   - the budget at K=89 (a block may use 232,448 B): a stage 98,304 B (eight boxes of 12,288 B: 89 rows of 128 B
//     rounded up to the 1,024 B the swizzle needs), one stage; the weights 65,536 B and the head's bias 128 B; [U | W],
//     later Z, 8,192 B; the partial [logits | dattn] 2,848 B; P 1,664 B (8 rows of K padded to 96, + 8 so that rows
//     fall on distinct banks); q and g of two sources 256 B; the dq partials 1,024 B; four scalars 16 B; the mbarrier
//     8 B; 1,024 B to align: 179,000 B. A second stage would need 277,312 B. K=128, the softmax's limit, takes
//     213,528 B; K=24 102,168 B, two blocks an SM.
// No atomics: every sum has a fixed order, so two launches on the same inputs give the same bits. A source with no
// valid target gets attn = dl = 0, and so zero gradients.

#pragma once

#include "knarpe_staged.cuh"

namespace heads_x_bwd {

using staged::a16;
using staged::box_bytes;
using staged::kMask;
using staged::ldsm_x2;
using staged::ldsm_x2_t;
using staged::ldsm_x4;
using staged::ldsm_x4_t;
using staged::pad16;
using staged::smem_u32;

constexpr int kHeads = 8, kWidth = 256;  // the widths it is compiled for: n_head, d_model = d_rpe
constexpr int kX = 2 * kWidth;           // inputs of a target: [tgt | rpe]
constexpr int kX1 = kX + 1;              // a pbuf row: X inputs, then the bias's constant input
constexpr int kDH = kWidth / kHeads;     // d_head: a block's columns of q, g, dq and of each weight half
constexpr int kBoxes = kX / 64;          // a stage's boxes: tgt's four, then rpe's four
constexpr int kWRow = 2 * kDH * 2;       // bytes of a resident weight row: the head's W_k, then W_v columns
constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kMaxK = 128;               // the softmax keeps K / 32 targets per lane in registers
constexpr int kParts = 4;                // the logits step's quarters of X: two boxes, eight k steps each
constexpr int kDqParts = kWarps / 2;     // the dq step's eighths of the k steps, per 16-column tile
constexpr int kFac = 2 * kHeads;         // dx's factor columns: [scale dl | attn] and [u | w] of each block's head
constexpr int kDxThreads = 256;          // the dx pass: two columns of X a thread
constexpr int kDxRows = 32;              // the dx pass's targets per work item
static_assert(kDH == 32 && kBoxes == 8 && kDqParts * 4 * 16 == kX, "a head is 32 columns; X is 32 k steps");

// floats of a source's dx factors: F [K][kFac], then G [kFac][X]
__host__ __device__ inline size_t fac_floats(int K) {
  return static_cast<size_t>(K) * kFac + static_cast<size_t>(kFac) * kX;
}

// Byte offsets from the block's 1024-byte aligned base in dynamic shared memory (total counts the alignment's slack):
// the stage (eight boxes from offset 0), the resident weights and bias, the scratch and the mbarrier.
struct Layout {
  size_t box, w, bias, ub, lg, pb, qg, dqp, hv, bar, total;
};

inline Layout make_layout(int K) {
  Layout L{};
  L.box = box_bytes(K);
  size_t off = kBoxes * L.box;
  L.w = off;    off += static_cast<size_t>(kX) * kWRow;
  L.bias = off; off += 2 * kDH * 2;
  L.ub = off;   off += static_cast<size_t>(kX) * 8 * 2;                 // [U_hi | U_lo | W_hi | W_lo] [X][8], later Z
  L.lg = off;   off += a16(static_cast<size_t>(kParts) * 2 * K * 4);    // partial [logits | dattn] [part][2][K]
  L.pb = off;   off += static_cast<size_t>(8) * (pad16(K) + 8) * 2;     // P [8][pad16(K) + 8], rows 4-7 zero
  L.qg = off;   off += 2 * 2 * kDH * 2;                                 // [source parity][q | g] of the head
  L.dqp = off;  off += static_cast<size_t>(kDqParts) * kDH * 4;         // dq's partial sums
  L.hv = off;   off += 16;                                              // c, e, sum scale dl, sum attn
  L.bar = off;  off += 8;                                               // the stage's mbarrier
  L.total = off + 1024;
  return L;
}

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::X_BWD_HEADS_REFUSALS words each code (4, no block
// fits a multiprocessor, comes from the plan).
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (!(D == kWidth && R == kWidth && H == kHeads)) return 2;
  if (K < 1 || K > kMaxK) return 1;
  if (make_layout(K).total > max_smem) return 3;
  return 0;
}

struct Params {
  CUtensorMap tm_t, tm_r;  // tgt [n_src K, D] and rpe [n_src K, R]: boxes of 64 x K, the 128-byte swizzle
  const __nv_bfloat16 *q, *g, *tgt, *rpe, *w_kv, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16* dq;
  float* pbuf;  // [n_src, 2, H, X + 1]
  float* fac;   // [n_src][fac_floats(K)]: dx's factors
  int n_src, n_knn;
  float scale;
  Layout L;
};

// Source s's eight boxes into the stage at slot by tensor copies, counted on bar; issued by one thread
__device__ __forceinline__ void stage_source(const Params& p, uint32_t slot, uint32_t bar, int s) {
  const int K = p.n_knn;
  staged::mbar_expect(bar, static_cast<uint32_t>(kBoxes * K * 128));
  for (int b = 0; b < kBoxes; ++b)
    staged::tma_load_2d(slot + static_cast<uint32_t>(b * p.L.box), b < kBoxes / 2 ? &p.tm_t : &p.tm_r,
                        64 * (b % (kBoxes / 2)), s * K, bar);
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return staged::bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

// (hi, lo) of one float32 value as a bf16 pair: v ~ hi + lo to 16 significant bits
__device__ __forceinline__ uint32_t hi_lo(float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  return staged::bf16x2_bits(__halves2bfloat162(hi, __float2bfloat16_rn(v - __bfloat162float(hi))));
}

__global__ void __launch_bounds__(kThreads, 2) knarpe_x_bwd_heads_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: stages start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % kHeads, col0 = h * kDH;  // the block's head and its columns of each weight half
  const int n_slots = gridDim.x / kHeads, slot0 = blockIdx.x / kHeads;
  auto source = [&](int n) { return slot0 + n * n_slots; };  // the block's n-th source
  const int K = p.n_knn, n_mk = pad16(K) / 16, lda = pad16(K) + 8, n_full = K / 16;
  const float scale = p.scale;
  const uint32_t box = static_cast<uint32_t>(p.L.box);
  const uint32_t slot = smem_u32(smem), wsm = smem_u32(smem + p.L.w), bar = smem_u32(smem + p.L.bar);
  const uint32_t uaddr = smem_u32(smem + p.L.ub), paddr = smem_u32(smem + p.L.pb);
  __nv_bfloat16* ub = reinterpret_cast<__nv_bfloat16*>(smem + p.L.ub);
  float* lg = reinterpret_cast<float*>(smem + p.L.lg);  // [part][0: logits, 1: dattn][j]
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(smem + p.L.pb);  // rows sDL_hi, sDL_lo, A_hi, A_lo, 0 x 4
  float* dqp = reinterpret_cast<float*>(smem + p.L.dqp);
  float* hv = reinterpret_cast<float*>(smem + p.L.hv);
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // b_k, b_v of the head
  const size_t sq = static_cast<size_t>(col0);  // the head's offset in a row of q or g

  // q's and g's head columns of source s into parity buffer b: four 16-byte loads each, by threads 0-7 of warp w
  auto load_qg = [&](int s, int b, int w) {
    if (warp == w && lane < 8 && s < p.n_src) {
      const __nv_bfloat16* src = (lane < 4 ? p.q : p.g) + static_cast<size_t>(s) * kWidth + sq + 8 * (lane & 3);
      reinterpret_cast<uint4*>(smem + p.L.qg + b * 128)[lane] = *reinterpret_cast<const uint4*>(src);
    }
  };

  if (tid == 0) {  // the stage's barrier and the block's first source
    staged::mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (source(0) < p.n_src) stage_source(p, slot, bar, source(0));
  }
  {  // the head's weight rows (W_k's, then W_v's 32 columns; 16-byte chunk c at c ^ (i & 7)) and bias, by cp.async
    constexpr int kChunks = kWRow / 16;
    for (int e = tid; e < kX * kChunks; e += kThreads) {
      const int i = e / kChunks, c = e % kChunks;
      const __nv_bfloat16* row = i < kWidth ? p.w_kv + static_cast<size_t>(i) * 2 * kWidth
                                            : p.w_rpe + static_cast<size_t>(i - kWidth) * 2 * kWidth;
      staged::cp_async16(wsm + i * kWRow + ((c ^ (i & 7)) << 4), row + (c < 4 ? 0 : kWidth) + col0 + 8 * (c & 3));
    }
    if (tid < kChunks)
      staged::cp_async16(smem_u32(smem + p.L.bias) + tid * 16, p.bias + (tid < 4 ? 0 : kWidth) + col0 + 8 * (tid & 3));
  }
  // the scratch starts at zero: P's rows 4-7 and its columns past K - 1 stay so
  for (int e = tid; e < static_cast<int>((p.L.bar - p.L.ub) / 16); e += kThreads)
    reinterpret_cast<uint4*>(smem + p.L.ub)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  load_qg(source(0), 0, 0);
  staged::cp_wait_all();
  __syncthreads();

  // mma fragments: row group g and column pair tq; ldmatrix rows r16 and chunk half hb (A, B by rows), arow and hb2
  // (A by .trans: rows of the stored matrix); every row a lane addresses is lane mod 8 (unless clamped to K - 1), so
  // the 128-byte swizzle of chunk c is c ^ sw
  const int g = lane >> 2, tq = lane & 3, r16 = lane & 15, hb = lane >> 4;
  const int arow = (lane & 7) + 8 * (lane >> 4), hb2 = (lane >> 3) & 1, sw = lane & 7;
  const uint32_t p_b = paddr + ((lane & 7) * lda + 8 * hb2) * 2;  // this lane's row of a B fragment of P^T
  constexpr int kR = kMaxK / 32;
  // warp 0's mask bytes, target lane + 32 r, of the block's next source: loaded a source ahead
  unsigned char inv_raw[kR] = {};
  auto fetch_mask = [&](int s) {
    if (warp == 0 && s < p.n_src) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        inv_raw[r] = j < K ? p.invalid[static_cast<size_t>(s) * K + j] : 0;
      }
    }
  };
  fetch_mask(source(0));

  for (int it = 0; source(it) < p.n_src; ++it) {
    const int s = source(it);
    uint32_t inv_bits = 0;  // warp 0's mask: bit r for target lane + 32 r
#pragma unroll
    for (int r = 0; r < kR; ++r) inv_bits |= (inv_raw[r] != 0 ? 1u : 0u) << r;
    fetch_mask(source(it + 1));
    if (tid == 0 && source(it + 1) < p.n_src) {  // an eighth of the next source's rows into L2
      const size_t rows = static_cast<size_t>(source(it + 1)) * K * kWidth + static_cast<size_t>(h) * K * (kWidth / 8);
      prefetch_l2(p.tgt + rows, static_cast<uint32_t>(K * kWidth / 8 * 2));
      prefetch_l2(p.rpe + rows, static_cast<uint32_t>(K * kWidth / 8 * 2));
    }
    float* prow = p.pbuf + static_cast<size_t>(s) * 2 * kHeads * kX1;  // the source's pbuf rows
    float* fac = p.fac + static_cast<size_t>(s) * fac_floats(K);       // F [K][kFac], then G [kFac][X]
    const unsigned char* qgb = smem + p.L.qg + (it & 1) * 128;
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qgb);
    const uint32_t* g2 = q2 + kDH / 2;

    // 1. [u | w][i] = W_k[i, head] . q_h (column 0) + W_v[i, head] . g_h (column 1): a warp per two 16-row tiles of X
    //    (warp, warp + 16), the two k steps of each weight half; split into [U_hi | U_lo | W_hi | W_lo], and the
    //    float32 u and w into G's rows 2 h, 2 h + 1. Then c_h and e_h
    {
      uint32_t bq[2][2], bg[2][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        bq[ks][0] = g == 0 ? q2[8 * ks + tq] : 0u;
        bq[ks][1] = g == 0 ? q2[8 * ks + 4 + tq] : 0u;
        bg[ks][0] = g == 1 ? g2[8 * ks + tq] : 0u;
        bg[ks][1] = g == 1 ? g2[8 * ks + 4 + tq] : 0u;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int tile = warp + kWarps * t;
        const uint32_t row = wsm + (16 * tile + r16) * kWRow;
        uint32_t a[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) ldsm_x4(a[c], row + (((2 * c + hb) ^ sw) << 4));
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        staged::mma_bf16(acc, a[0], bq[0][0], bq[0][1]);
        staged::mma_bf16(acc, a[1], bq[1][0], bq[1][1]);
        staged::mma_bf16(acc, a[2], bg[0][0], bg[0][1]);
        staged::mma_bf16(acc, a[3], bg[1][0], bg[1][1]);
        if (tq == 0) {  // columns 0 (u) and 1 (w) of rows g, g + 8
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 16 * tile + g + 8 * hr;
            const float u = acc[2 * hr], w = acc[2 * hr + 1];
            *reinterpret_cast<uint2*>(ub + i * 8) = make_uint2(hi_lo(u), hi_lo(w));
            fac[K * kFac + (2 * h) * kX + i] = u;
            fac[K * kFac + (2 * h + 1) * kX + i] = w;
          }
        }
      }
      if (warp < 2) {  // c_h = b_k,h . q_h (warp 0), e_h = b_v,h . g_h (warp 1)
        const __nv_bfloat16* vec = reinterpret_cast<const __nv_bfloat16*>(qgb) + warp * kDH;
        float c = __bfloat162float(bias[warp * kDH + lane]) * __bfloat162float(vec[lane]);
        c = staged::warp_sum(c);
        if (lane == 0) hv[warp] = c;
      }
    }
    __syncthreads();
    staged::mbar_wait(bar, it & 1);  // this source's rows have landed

    // 2. [logits | dattn] per 16 targets and quarter of X (item = kParts mt + part): A = the staged rows, unclamped (a
    //    row past K - 1 reads other bytes of the shared memory, and its results are dropped), B = [U | W] hi and lo;
    //    columns 0 + 1 (lane tq = 0) the logit's, 2 + 3 (tq = 1) dattn's partial sum
    for (int item = warp; item < kParts * n_mk; item += kWarps) {
      const int mt = item / kParts, part = item % kParts;
      const uint32_t rbase = slot + 2 * part * box + (16 * mt + r16) * 128;
      const uint32_t ubase = uaddr + (128 * part + r16) * 16;
      float acc[2][4] = {};
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ldsm_x4(a[t], rbase + bx * box + (((2 * t + hb) ^ sw) << 4));
          ldsm_x2_t(b[t], ubase + (64 * bx + 16 * t) * 16);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) staged::mma_bf16(acc[t & 1], a[t], b[t][0], b[t][1]);
      }
      if (tq < 2) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * mt + g + 8 * hr;
          if (row < K)
            lg[(2 * part + tq) * K + row] = (acc[0][2 * hr] + acc[1][2 * hr]) + (acc[0][2 * hr + 1] + acc[1][2 * hr + 1]);
        }
      }
    }
    __syncthreads();

    // 3. masked softmax over K and dl = attn (dattn - sum attn dattn) in warp 0 (as knarpe_bwd.cu), target lane + 32 r
    //    in registers; P's rows 0, 1 (scale dl hi, lo) and 2, 3 (attn hi, lo), F's columns 2 h, 2 h + 1, the sums, also
    //    as pbuf's row X
    if (warp == 0) {
      const float c = hv[0], ev = hv[1];
      float lv[kR], dv[kR];
      float m = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        const bool in = j < K, ok = in && !((inv_bits >> r) & 1u);
        float l = 0.f, d = 0.f;
        if (in) {
#pragma unroll
          for (int part = 0; part < kParts; ++part) {
            l += lg[(2 * part) * K + j];
            d += lg[(2 * part + 1) * K + j];
          }
        }
        lv[r] = ok ? (l + c) * scale : -INFINITY;
        dv[r] = in ? d + ev : 0.f;
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
          const uint32_t vb = hi_lo(v), abits = hi_lo(a);
          pb[j] = __ushort_as_bfloat16(static_cast<unsigned short>(vb & 0xffffu));
          pb[lda + j] = __ushort_as_bfloat16(static_cast<unsigned short>(vb >> 16));
          pb[2 * lda + j] = __ushort_as_bfloat16(static_cast<unsigned short>(abits & 0xffffu));
          pb[3 * lda + j] = __ushort_as_bfloat16(static_cast<unsigned short>(abits >> 16));
          *reinterpret_cast<float2*>(fac + j * kFac + 2 * h) = make_float2(v, a);
          as += a;
          sds += v;
        }
      }
      as = staged::warp_sum(as);
      sds = staged::warp_sum(sds);
      if (lane == 0) {
        hv[2] = sds;
        prow[static_cast<size_t>(h) * kX1 + kX] = sds;           // k half: scale sum dl
        prow[static_cast<size_t>(kHeads + h) * kX1 + kX] = as;   // v half: sum attn
      }
    }
    __syncthreads();

    // 4. [z' | y]^T[i][c] = sum_j x_j[i] P[c][j]: a warp per two 16-row tiles of X (warp, warp + 16), A = x^T (the
    //    staged rows by ldmatrix.trans), B = P^T; hi and lo columns summed (z' in lane tq = 0, y in tq = 1) -> pbuf's
    //    rows, and z' split again into [Z_hi | Z_lo] over [U_hi | U_lo]
    {
      float acc[2][4] = {};
      uint32_t ya[2];  // the tile's chunk in its box: rows arow, chunk 2 (tile % 4) + hb2
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int tile = warp + kWarps * t;
        ya[t] = slot + (tile >> 2) * box + arow * 128 + (((2 * (tile & 3) + hb2) ^ sw) << 4);
      }
      for (int ks = 0; ks < n_full; ++ks) {
        uint32_t b[2];
        ldsm_x2(b, p_b + 32 * ks);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          uint32_t a[4];
          ldsm_x4_t(a, ya[t] + 2048 * ks);
          staged::mma_bf16(acc[t], a, b[0], b[1]);
        }
      }
      if (n_full < n_mk) {  // the last tile, its rows past K - 1 clamped to K - 1 (P is 0 there; the row is data)
        const int j = min(16 * n_full + arow, K - 1);
        uint32_t b[2];
        ldsm_x2(b, p_b + 32 * n_full);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int tile = warp + kWarps * t;
          uint32_t a[4];
          ldsm_x4_t(a, slot + (tile >> 2) * box + j * 128 + (((2 * (tile & 3) + hb2) ^ (j & 7)) << 4));
          staged::mma_bf16(acc[t], a, b[0], b[1]);
        }
      }
      if (tq < 2) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 16 * (warp + kWarps * t) + g + 8 * hr;
            const float v = acc[t][2 * hr] + acc[t][2 * hr + 1];
            prow[static_cast<size_t>(tq == 0 ? h : kHeads + h) * kX1 + i] = v;  // k half z', v half y
            if (tq == 0) *reinterpret_cast<uint32_t*>(ub + i * 8) = hi_lo(v);
          }
      }
    }
    __syncthreads();
    if (tid == 0 && source(it + 1) < p.n_src) {  // the stage is read: the block's next source streams in
      staged::fence_proxy_async();
      stage_source(p, slot, bar, source(it + 1));
    }
    load_qg(source(it + 1), (it + 1) & 1, kWarps - 1);

    // 5. dq^T[d][c] = sum_i W_k[i][d] Z[i][c]: warp = 2 part + mt takes 16 columns d (tile mt) over the k steps
    //    4 part .. 4 part + 3, A = W_k^T (the weight rows by ldmatrix.trans), B = [Z_hi | Z_lo]; columns 0 + 1 (lane
    //    tq = 0) summed into the partial; then warp 0 adds the eight partials in order and b_k sum scale dl
    {
      const int mt = warp & 1, part = warp >> 1;
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i0 = 16 * (4 * part + t);
        ldsm_x4_t(a[t], wsm + (i0 + arow) * kWRow + (((2 * mt + hb2) ^ sw) << 4));
        ldsm_x2_t(b[t], uaddr + (i0 + r16) * 16);
      }
      float acc[2][4] = {};
#pragma unroll
      for (int t = 0; t < 4; ++t) staged::mma_bf16(acc[t & 1], a[t], b[t][0], b[t][1]);
      if (tq == 0) {
        dqp[part * kDH + 16 * mt + g] = (acc[0][0] + acc[1][0]) + (acc[0][1] + acc[1][1]);
        dqp[part * kDH + 16 * mt + g + 8] = (acc[0][2] + acc[1][2]) + (acc[0][3] + acc[1][3]);
      }
    }
    __syncthreads();
    if (warp == 0) {
      float v = 0.f;
#pragma unroll
      for (int part = 0; part < kDqParts; ++part) v += dqp[part * kDH + lane];
      p.dq[static_cast<size_t>(s) * kWidth + col0 + lane] = __float2bfloat16_rn(v + __bfloat162float(bias[lane]) * hv[2]);
    }
  }
}

// dx_j = sum_c F[j][c] G[c] over the sixteen factor columns of a source's eight blocks, in their order, in float32,
// rounded once to bf16 into dtgt (columns [0, 256)) and drpe ([256, 512)): a work item is kDxRows targets of one
// source, two columns a thread (G's in registers), F's rows staged in shared memory
__global__ void __launch_bounds__(kDxThreads) knarpe_x_bwd_heads_dx(const float* fac, __nv_bfloat16* dtgt,
                                                                     __nv_bfloat16* drpe, int n_src, int K) {
  __shared__ float fs[kDxRows * kFac];
  const int tid = threadIdx.x, i = 2 * tid;
  const int n_chunks = (K + kDxRows - 1) / kDxRows;
  __nv_bfloat16* dst = i < kWidth ? dtgt + i : drpe + (i - kWidth);
  for (int item = blockIdx.x; item < n_src * n_chunks; item += gridDim.x) {
    const int s = item / n_chunks, j0 = (item % n_chunks) * kDxRows, nj = min(kDxRows, K - j0);
    const float* f = fac + static_cast<size_t>(s) * fac_floats(K);
    const float* gm = f + K * kFac;
    float g0[kFac], g1[kFac];
#pragma unroll
    for (int c = 0; c < kFac; ++c) {
      const float2 v = *reinterpret_cast<const float2*>(gm + c * kX + i);
      g0[c] = v.x;
      g1[c] = v.y;
    }
    __syncthreads();  // the previous item's F is read
    for (int e = tid; e < nj * kFac; e += kDxThreads) fs[e] = f[j0 * kFac + e];
    __syncthreads();
    for (int jj = 0; jj < nj; ++jj) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int c = 0; c < kFac; ++c) {
        a0 = fmaf(fs[jj * kFac + c], g0[c], a0);
        a1 = fmaf(fs[jj * kFac + c], g1[c], a1);
      }
      *reinterpret_cast<uint32_t*>(dst + (static_cast<size_t>(s) * K + j0 + jj) * kWidth) = pack_bf16(a0, a1);
    }
  }
}

}  // namespace heads_x_bwd
