// The bf16 KNARPE cross-attention forward B2 at widths whose weights do not fit one block: a cluster of
// four blocks per source, each holding a quarter of [W_kv; W_rpe] and computing on a quarter of the
// source's [tgt | rpe] columns, the partial sums exchanged through distributed shared memory.
//
// Replaces, for bf16 operands at the scaled preset's D = R = 256 with 8 heads, the only widths it is compiled
// for, trafficbotsv15_tpu/ops/pallas_knarpe.py _x_fwd_kernel (:384-423, launched at :443), the forward of
// knarpe_cross_attention. Contract as knarpe.cu's header says; knarpe_staged.cuh's one-block kernel keeps
// every shape it takes (the flagship's D = R = 128, K <= 89), and the general kernel of knarpe.cu the
// shapes both refuse (among them D = R = 128 at K >= 90, and K >= 105 here).
//
// What bounds it: the bytes. At the scaled eval path's shape (128 x 64 sources, K=89, D=R=256, H=8) a launch
// must read the targets and relative poses (89 x 1 KB per source) once: 756 MB, 0.226 ms at 3.35 TB/s.
// knarpe_staged.cuh keeps the whole bf16 [W_kv; W_rpe] resident in one block; at D = R = 256 that is
// 512 x 512 x 2 = 524,288 B against the 232,448 B a block may use, so the shape ran on the general kernel
// (float32 FMA, x_j read twice, weights through L1/L2), 2.1 times slower than matmul +
// scaled_dot_product_attention. Streaming the weights through L2 instead would read 512 KB per source,
// ~4.3 GB a launch (~0.8 ms at L2's rate). Here the weights stay on chip, split over a cluster:
//   - block r of a cluster keeps rows [r XQ, (r + 1) XQ) of [W_kv; W_rpe] (XQ = (D + R) / 4, all 2D
//     columns, rows XOR-swizzled) and takes the same quarter of every source's x_j = [tgt_j | rpe_j]; a
//     quarter lies in tgt or in rpe and arrives by 2-D tensor copies (boxes of 64 columns by K rows, the
//     128-byte swizzle) into a ring of two stages: while source s is computed, the cluster's next source
//     streams into the other. Each x_j is read from device memory once, and no weight byte moves per source;
//   - one persistent cluster per four SMs (cudaOccupancyMaxActiveClusters of them) walks over sources;
//   - per source, knarpe_staged.cuh's reassociated products on the tensor cores (mma.sync.m16n8k16, bf16
//     operands, float32 sums; a float32 operand split into bf16 hi + lo, so results reach float32 level
//     before the one rounding at the output), each block on its quarter:
//       u   = W_k Q on its XQ rows (Q [D, 8] the head-masked q; heads 0..H/2-1 and H/2..H-1 lie in
//             disjoint halves of the k steps, so two warps share a 16-row tile) -> [U_hi | U_lo];
//             c_h = b_k[h] . q_h. Computed for the next source by warps 8.. while warps 0..H-1 run this
//             source's softmax, into the other of two U buffers;
//       P_r = x[:, quarter] [U_hi | U_lo], the block's partial logits [H, K] (K padded to 16 by repeating
//             row K-1, whose results are never stored), sent to every block of the cluster;
//       logits = (P_0 + P_1 + P_2 + P_3 + c) scale in rank order: the same in every block, bit for bit;
//             softmax over K per head (one warp per head, its targets in registers) -> [A_hi; A_lo];
//       y   = [A_hi; A_lo] x[:, quarter] -> [Y_hi; Y_lo] on the quarter;
//       O_r = the block's partial out, as O^T = W_v[quarter, :]^T [Y_hi; Y_lo]^T with only rows h(d) of Y
//             as the product's columns; each 16 columns d are sent to the block that owns them (D / 4
//             each), which sums the four in rank order, adds b_v Σa and writes them;
//   - the partials go by st.async into the receiving block's buffer for the source's parity, counted in
//     bytes on its mbarrier for that parity, which the receiver waits on. A cluster barrier (a relaxed
//     arrival, the wait one source later) orders only reuse: a block arrives once it has read this
//     source's logits partials and the previous source's out partials, and waits for everyone's previous
//     arrival before its next sends, so a buffer is rewritten two sources later, after every block read
//     it (cluster.sync, a full barrier, compiles to a GPU-scope fence and an L1 invalidation besides);
//   - each step is a few k steps a warp, so instructions, not the tensor cores, set its length: the loops
//     run over compile-time widths (D = R = 256, H = 8) with shared addresses from per-lane bases;
//   - the budget at the scaled eval shape (K=89, D=R=256, H=8; a block may use 232,448 B): two stages
//     2 x 25,600 B (two boxes of 12,288 B and the mask, rounded up to the 1,024 B the swizzle needs), the
//     weight quarter 131,072 B, the bias 1,024 B, q of two sources 1,024 B, two U buffers 2 x 4,096 B,
//     two sets of received partial logits 2 x 11,392 B ([4][H][K] float32) and of partial outs 2 x 1,024 B,
//     [A_hi; A_lo] 3,328 B (16 rows of K padded to 96, + 8 so that ldmatrix rows fall on distinct banks),
//     per-head scalars 192 B, six mbarriers 48 B, 1,024 B to align: 221,936 B. K up to 104 fits.
// No atomics: every sum has a fixed order, so two launches on the same inputs give the same bits. A source
// with no valid target gets a zero output.

#pragma once

#include <cooperative_groups.h>

#include "knarpe_staged.cuh"

namespace cluster_x {

namespace cg = cooperative_groups;
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
using staged::u_cols;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;
// the most targets a source may have: the softmax holds a head's logits in one warp's registers, at most four a
// lane (a block's quarter of a source is one tensor-copy box of K rows per 64 columns, at most 256 rows)
constexpr int kMaxK = 128;
constexpr int kHeads = 8, kWidth = 256;  // the widths it is compiled for: n_head, d_model = d_rpe

// Byte offsets from the block's 1024-byte aligned base in dynamic shared memory (total counts the
// alignment's slack). A stage holds the quarter's boxes (box bytes each), then the mask at offset inv. Every block of a cluster has the same layout, so an offset names the same field in each.
struct Layout {
  int xq;  // columns of [tgt | rpe] a block takes: (D + R) / 4
  size_t box, inv, slot_bytes, w, bias, qs, u, u_bytes, rl, rl_bytes, ro, a, hv, bar, total;
};

inline Layout make_layout(int K) {
  constexpr int D = kWidth, R = kWidth, H = kHeads;
  Layout L{};
  L.xq = (D + R) / kCluster;
  L.box = box_bytes(K);
  L.inv = n_boxes(L.xq) * L.box;
  L.slot_bytes = a1024(L.inv + a16(static_cast<size_t>(K)));
  size_t off = 2 * L.slot_bytes;
  L.w = off;    off += static_cast<size_t>(L.xq) * 2 * D * 2;
  L.bias = off; off += a16(static_cast<size_t>(D) * 2 * 2);
  L.qs = off;   off += a16(static_cast<size_t>(D) * 2 * 2);                 // q of the sources of the two U buffers
  L.u_bytes = a16(static_cast<size_t>(L.xq) * u_cols(H) * 2);
  L.u = off;    off += 2 * L.u_bytes;                                       // two [U_hi | U_lo] [Xq][NU], or [Y_hi; Y_lo]
  L.rl_bytes = a16(static_cast<size_t>(kCluster) * H * K * 4);
  L.rl = off;   off += 2 * L.rl_bytes;  // two sets of the cluster's partial logits [rank][h][j], by source parity
  L.ro = off;   off += 2 * a16(static_cast<size_t>(D) * 4);  // two of the partial out of its D / 4 columns [rank][t]
  L.a = off;    off += static_cast<size_t>(16) * (pad16(K) + 8) * 2;        // [A_hi; A_lo; 0] [16][pad16(K) + 8]
  L.hv = off;   off += a16(static_cast<size_t>(6) * H * 4);  // c, sum attn, no-valid flag per head, two of each
  L.bar = off;  off += 6 * 8;  // mbarriers: the two stages', then the partial logits' and the partial out's by parity
  L.total = off + 1024;
  return L;
}

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::CLUSTER_REFUSALS words each code
// (4, no cluster fits the device, comes from the plan).
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (K < 1 || K > kMaxK) return 1;
  if (!(D == kWidth && R == kWidth && H == kHeads)) return 2;  // the widths the kernel is compiled for
  if (make_layout(K).total > max_smem) return 3;
  return 0;
}

struct Params {
  CUtensorMap tm_t, tm_r;  // tgt [n_src K, D] and rpe [n_src K, R]: boxes of 64 columns x K rows
  const __nv_bfloat16 *q, *w_kv, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16* out;
  int n_src, n_knn;
  float scale;
  Layout L;
};

// the shared::cluster address of the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// v into the shared memory of a block of the cluster (addr), counted as 4 bytes on that block's mbarrier bar
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// the cluster barrier in two halves: an arrival that orders nothing (the data exchanged between the blocks is
// counted on mbarriers) and the wait for every block's arrival
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// The launch configuration of a grid of `blocks` blocks in clusters of kCluster; attr holds the cluster shape.
inline cudaLaunchConfig_t launch_config(int blocks, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The masked softmax over K of head h = warp, target lane + 32 r (r < NR, K <= 32 NR) in registers, as
// pallas_knarpe.py:_fwd_core: logits (P_0 + P_1 + P_2 + P_3 + c) scale from the partials rl [rank][h][j], in
// rank order; attn as rows h (hi) and H + h (lo) of A (ab, rows of lda), sum attn into *asum_h and the
// no-valid flag into *nvh_h (lane 0). Loads first, for every r at once (target indices past K clamped to K - 1,
// their results unused); a target past K or invalid adds 0 to the sums, so they are those over the valid ones.
template <int NR>
__device__ __forceinline__ void softmax_head(const float* rl, const uint8_t* inv, int K, int h, int lane, float c,
                                             float scale, __nv_bfloat16* ab, int lda, float* asum_h, float* nvh_h) {
  constexpr int H = kHeads;
  float lv[NR];
  bool ok[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int j = min(lane + 32 * r, K - 1);
    float v = rl[h * K + j];
#pragma unroll
    for (int rk = 1; rk < kCluster; ++rk) v += rl[(rk * H + h) * K + j];
    ok[r] = lane + 32 * r < K && !inv[j];
    lv[r] = (v + c) * scale;
  }
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < NR; ++r) m = fmaxf(m, ok[r] ? lv[r] : kMask);
  m = staged::warp_max(m);
  float den = 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    lv[r] = ok[r] ? expf(lv[r] - m) : 0.f;
    den += lv[r];
  }
  den = staged::warp_sum(den);
  const bool no_valid = den <= 0.f;
  const float rden = no_valid ? 1.f : 1.f / den;
  float as = 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int j = lane + 32 * r;
    const float a = lv[r] * rden;
    const __nv_bfloat16 hi = __float2bfloat16_rn(a);
    if (j < K) {
      ab[h * lda + j] = hi;
      ab[(H + h) * lda + j] = __float2bfloat16_rn(a - __bfloat162float(hi));
    }
    as += a;
  }
  as = staged::warp_sum(as);
  if (lane == 0) {
    *asum_h = as;
    *nvh_h = no_valid ? 1.f : 0.f;
  }
}

// Shared addresses of a k step's ldmatrix rows: loop-invariant bases per lane, compile-time offsets per
// k step, so that the index arithmetic of the unrolled loops costs an add and an XOR (the steps are
// short, and their instructions, not the tensor cores, set their length).
__global__ void __launch_bounds__(kThreads, 1) knarpe_x_cluster_kernel(const __grid_constant__ Params p) {
  constexpr int H = kHeads, D = kWidth, R = kWidth;
  constexpr int X = D + R, XQ = X / kCluster, NB = XQ / 64, DQ = D / kCluster, DH = D / H;
  constexpr int NU = 16;            // columns of [U_hi | U_lo] (u_cols(8)), rows of [Y_hi; Y_lo]
  constexpr int WROW = D / 4 * 16;  // bytes of a resident weight row (2D bf16)
  constexpr int N_MT = XQ / 16;     // 16-row tiles of the block's weight rows, 16-column k steps of its quarter
  constexpr int NKS = D / 16 / 2;   // the k steps of half the heads
  static_assert(XQ % 64 == 0 && D % XQ == 0 && R % XQ == 0 && DH % 16 == 0 && DQ % 16 == 0 && H % 2 == 0,
                "a block's quarter lies in tgt or rpe, in 64-column boxes; a 16-column tile lies in one head; the u "
                "step splits the heads in halves");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: stages start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cl = gridDim.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, hb = lane >> 4, r16 = lane & 15;  // mma fragment row group, column pair
  const int K = p.n_knn, n_mk = pad16(K) / 16, lda = pad16(K) + 8;
  const uint32_t box = static_cast<uint32_t>(p.L.box), slot_bytes = static_cast<uint32_t>(p.L.slot_bytes);
  const int x0 = rank * XQ;  // this block's first column of [tgt | rpe]
  const CUtensorMap* tmap = x0 < D ? &p.tm_t : &p.tm_r;
  const int col0 = x0 < D ? x0 : x0 - D;
  const uint32_t slots = smem_u32(smem), wsm = smem_u32(smem + p.L.w), bar0 = smem_u32(smem + p.L.bar);
  const uint32_t aa = smem_u32(smem + p.L.a), ub_bytes = static_cast<uint32_t>(p.L.u_bytes);
  const uint32_t rl_bytes = static_cast<uint32_t>(p.L.rl_bytes);
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(smem + p.L.a);  // [A_hi; A_lo; 0] [16][lda]
  // per head, of the sources of parity b: c (of the source U buffer b is for), sum attn, no-valid flag
  float* cvec = reinterpret_cast<float*>(smem + p.L.hv);  // [b][h]
  float* asum = cvec + 2 * H;
  float* nvh = cvec + 4 * H;
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // [b_k | b_v]
  // the partial logits' buffers and mbarriers of each block of the cluster (indexed by unrolled constants only)
  uint32_t rl_at[kCluster], rl_bar_at[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    rl_at[r] = map_rank(smem_u32(smem + p.L.rl), r);
    rl_bar_at[r] = map_rank(bar0 + 16, r);
  }

  // the quarter of source s into stage b, counted on the stage's mbarrier (one thread)
  auto fill = [&](int s, int b) {
    const uint32_t slot = slots + b * slot_bytes, bar = bar0 + 8 * b;
    staged::mbar_expect(bar, static_cast<uint32_t>(NB * K * 128));
#pragma unroll
    for (int i = 0; i < NB; ++i) staged::tma_load_2d(slot + i * box, tmap, col0 + 64 * i, s * K, bar);
  };

  // u[i][h] = W_k[x0 + i, head h] . q_h for the block's XQ rows, into U buffer ubuf, and c[h] = b_k[head h] .
  // q_h, by warps [w0, w0 + n_w): an item per 16 rows and half of the k steps, whose heads are
  // the first or the second half; A = the weight rows, B = the head-masked q of the source's
  // q buffer ubuf (column g = head g: a k step's 16 d lie in one head), four k steps at a time, loads first
  // (two chains of sums); u split into [U_hi | U_lo]
  auto compute_u = [&](int ubuf, int w0, int n_w) {
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.qs) + ubuf * D;
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qb);
    __nv_bfloat16* ub = reinterpret_cast<__nv_bfloat16*>(smem + p.L.u + ubuf * ub_bytes);
    for (int item = warp - w0; item < 2 * N_MT; item += n_w) {
      const int mt = item % N_MT, half = item / N_MT, row = 16 * mt + r16;
      const uint32_t wrow = wsm + row * WROW;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int t0 = 0; t0 < NKS; t0 += 4) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int t = 0; t < 4 && t0 + t < NKS; ++t) {
          const int ks = half * NKS + t0 + t;
          ldsm_x4(af[t], wrow + (((2 * ks + hb) ^ (row & 7)) << 4));
          const bool mine = g == 16 * ks / DH;
          bf[t][0] = mine ? q2[8 * ks + tq] : 0u;
          bf[t][1] = mine ? q2[8 * ks + 4 + tq] : 0u;
        }
#pragma unroll
        for (int t = 0; t < 4 && t0 + t < NKS; ++t) staged::mma_bf16(acc[t & 1], af[t], bf[t][0], bf[t][1]);
      }
      const int h = 2 * tq, h_lo = half * (H / 2), h_hi = h_lo + H / 2;
      if (h >= h_lo && h < h_hi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 16 * mt + g + 8 * hr;
          uint32_t hi, lo;
          staged::split2(acc[0][2 * hr] + acc[1][2 * hr], acc[0][2 * hr + 1] + acc[1][2 * hr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(ub + i * NU + h) = hi;
          *reinterpret_cast<uint32_t*>(ub + i * NU + H + h) = lo;
        }
      }
    }
    const int h = warp - w0;
    if (h >= 0 && h < H) {
      const __nv_bfloat16* qh = qb + h * DH;
      float acc = 0.f;
      for (int d = lane; d < DH; d += 32) acc += __bfloat162float(bias[h * DH + d]) * __bfloat162float(qh[d]);
      acc = staged::warp_sum(acc);
      if (lane == 0) cvec[ubuf * H + h] = acc;
    }
  };

  // out[d] of source s (the block's it-th) for its D / 4 columns: the four partials in rank order, + b_v Σa, by
  // threads [t0, t0 + n_t)
  auto finish = [&](int s, int it, int t0, int n_t) {
    const int b = it & 1;
    if (tid - t0 >= DQ) return;
    staged::mbar_wait(bar0 + 32 + 8 * b, (it >> 1) & 1);  // every block's partial out of source s is in
    const float* ro = reinterpret_cast<const float*>(smem + p.L.ro) + b * D;
    for (int t = tid - t0; t < DQ; t += n_t) {
      const int d = rank * DQ + t, h = d / DH;
      float o = ro[t];
#pragma unroll
      for (int r = 1; r < kCluster; ++r) o += ro[r * DQ + t];
      o += __bfloat162float(bias[D + d]) * asum[b * H + h];
      p.out[static_cast<size_t>(s) * D + d] = __float2bfloat16_rn(nvh[b * H + h] != 0.f ? 0.f : o);
    }
  };

  const int s0 = blockIdx.x / kCluster;
  if (tid == 0) {
    for (int i = 0; i < 6; ++i) staged::mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (s0 < p.n_src) fill(s0, 0);
  }
  {  // the weight quarter (rows x0.. of [W_kv; W_rpe], XOR-swizzled) and the bias, by cp.async
    constexpr int CW = D / 4;
    for (int e = tid; e < XQ * CW; e += kThreads) {
      const int i = e / CW, c = e % CW, gi = x0 + i;
      const __nv_bfloat16* row = gi < D ? p.w_kv + static_cast<size_t>(gi) * 2 * D
                                        : p.w_rpe + static_cast<size_t>(gi - D) * 2 * D;
      staged::cp_async16(wsm + i * WROW + ((c ^ (i & 7)) << 4), row + c * 8);
    }
    for (int c = tid; c < CW; c += kThreads) staged::cp_async16(smem_u32(smem + p.L.bias) + c * 16, p.bias + c * 8);
  }
  // [U | .], [Y; .] and [A; .] start at zero: their padding rows and columns stay so
  for (int e = tid; e < static_cast<int>(2 * ub_bytes / 16); e += kThreads)
    reinterpret_cast<uint4*>(smem + p.L.u)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < 16 * lda; e += kThreads) ab[e] = __float2bfloat16_rn(0.f);
  if (s0 < p.n_src && tid < K) smem[p.L.inv + tid] = p.invalid[static_cast<size_t>(s0) * K + tid];
  if (s0 < p.n_src)  // the first source's q, for its u
    for (int e = tid; e < D / 2; e += kThreads)
      reinterpret_cast<uint32_t*>(smem + p.L.qs)[e] = __ldg(reinterpret_cast<const uint32_t*>(p.q + static_cast<size_t>(s0) * D) + e);
  staged::cp_wait_all();
  __syncthreads();
  if (s0 < p.n_src) compute_u(0, 0, kWarps);
  cluster.sync();  // every block of the cluster has started, holds its weights and its first u, and its
                   // mbarriers are initialised

  for (int s = s0, it = 0; s < p.n_src; s += n_cl, ++it) {
    const int b = it & 1, sn = s + n_cl;
    unsigned char* cur = smem + b * slot_bytes;
    unsigned char* nxt = smem + (b ^ 1) * slot_bytes;
    if (tid == 0) {  // the partials of this source that every block sends this one
      staged::mbar_expect(bar0 + 16 + 8 * b, static_cast<uint32_t>(kCluster * H * K * 4));
      staged::mbar_expect(bar0 + 32 + 8 * b, static_cast<uint32_t>(D * 4));
    }
    const uint32_t ua = smem_u32(smem + p.L.u) + b * ub_bytes;  // U of this source, later its [Y_hi; Y_lo]
    __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(smem + p.L.u + b * ub_bytes);
    // the other stage was last read by the previous source's y step, before its last block barrier: the
    // next source streams into it, issued by the last warp, which has no item in the logits step (K <= 240)
    if (tid == kThreads - 32 && sn < p.n_src) {
      staged::fence_proxy_async();
      fill(sn, b ^ 1);
    }
    // the next source's q, for its u: read by warps 8.. into registers here, stored after the logits step
    const bool q_loader = tid >= 256 && tid - 256 < D / 2 && sn < p.n_src;
    uint32_t q_next = 0u;
    if (q_loader) q_next = __ldg(reinterpret_cast<const uint32_t*>(p.q + static_cast<size_t>(sn) * D) + (tid - 256));
    uint8_t inv_next = 0;
    if (sn < p.n_src && tid < K) inv_next = p.invalid[static_cast<size_t>(sn) * K + tid];
    staged::mbar_wait(bar0 + 8 * b, (it >> 1) & 1);  // this stage's (it / 2)-th fill has landed
    const uint32_t xs = slots + b * slot_bytes;
    const uint8_t* inv = cur + p.L.inv;

    // 1. the block's partial logits P[h][j] = x_j[quarter] . u_h[quarter] (hi + lo): a warp per 16 targets,
    //    A = the staged rows, B = [U_hi | U_lo] (column h hi, H + h lo), four k steps at a time, loads first;
    //    sent into rl[rank] of every block of the cluster
    for (int mt = warp; mt < n_mk; mt += kWarps) {
      const int arow = min(16 * mt + r16, K - 1);
      const uint32_t xrow = xs + arow * 128, ubase = ua + r16 * NU * 2 + hb * 16;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int t0 = 0; t0 < N_MT; t0 += 4) {
        uint32_t af[4][4], bf[4][4];
#pragma unroll
        for (int t = 0; t < 4 && t0 + t < N_MT; ++t) {
          const int ks = t0 + t;
          ldsm_x4(af[t], xrow + (ks >> 2) * box + (((((2 * ks) & 7) + hb) ^ (arow & 7)) << 4));
          ldsm_x4_t(bf[t], ubase + ks * 16 * NU * 2);
        }
#pragma unroll
        for (int t = 0; t < 4 && t0 + t < N_MT; ++t) {  // the two n tiles, hi and lo
          staged::mma_bf16(acc[0], af[t], bf[t][0], bf[t][1]);
          staged::mma_bf16(acc[1], af[t], bf[t][2], bf[t][3]);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[0][2 * hr + e];
          const float sum = staged::hi_plus_lo<H, true>(v, acc[1][2 * hr + e]);
          const int h = 2 * tq + e;
          if (h < H && row < K) {
            const uint32_t off = b * rl_bytes + ((rank * H + h) * K + row) * 4;
#pragma unroll
            for (int r = 0; r < kCluster; ++r) st_async(rl_at[r] + off, sum, rl_bar_at[r] + 8 * b);
          }
        }
      }
    }
    // every warp is past the previous source's out step, which read the U buffer that the next source's u
    // goes into, and past its store of this source's mask
    __syncthreads();

    // 2. logits = (P_0 + P_1 + P_2 + P_3 + c_h) scale, the partials in rank order; masked softmax over K,
    //    one warp per head, target lane + 32 r in registers (as pallas_knarpe.py:_fwd_core); attn as rows h
    //    (hi) and H + h (lo) of A. Meanwhile warps 8.. write the previous source's out and compute the next
    //    source's u into the other U buffer
    if (warp >= 8) {
      if (sn < p.n_src) {
        if (q_loader) reinterpret_cast<uint32_t*>(smem + p.L.qs)[(b ^ 1) * (D / 2) + tid - 256] = q_next;
        asm volatile("bar.sync 1, %0;\n" ::"r"(kThreads - 256) : "memory");  // warps 8.. : the q is in
      }
      if (it > 0) finish(s - n_cl, it - 1, 256, DQ);
      if (sn < p.n_src) compute_u(b ^ 1, 8, kWarps - 8);
    } else if (warp < H) {
      staged::mbar_wait(bar0 + 16 + 8 * b, (it >> 1) & 1);  // every block's partial logits of this source are in
      const float* rl = reinterpret_cast<const float*>(smem + p.L.rl + b * rl_bytes);
      const float c = cvec[b * H + warp];
      float* sums = asum + b * H + warp;
      switch ((K + 31) >> 5) {  // K <= kMaxK
        case 1: softmax_head<1>(rl, inv, K, warp, lane, c, p.scale, ab, lda, sums, sums + 2 * H); break;
        case 2: softmax_head<2>(rl, inv, K, warp, lane, c, p.scale, ab, lda, sums, sums + 2 * H); break;
        case 3: softmax_head<3>(rl, inv, K, warp, lane, c, p.scale, ab, lda, sums, sums + 2 * H); break;
        default: softmax_head<4>(rl, inv, K, warp, lane, c, p.scale, ab, lda, sums, sums + 2 * H); break;
      }
    }
    __syncthreads();
    // The cluster barrier, one a source, split: this block arrives once done with the partials it read of this
    // source (logits) and of the previous one (out), and waits for every block's previous arrival before its
    // next sends, so a buffer of parity b is rewritten two sources later only once every block has read it
    if (it > 0) cluster_wait();
    cluster_arrive_relaxed();

    // 3. y[h][i] = sum_j attn[h][j] x_j[i] on the quarter: a warp per 8 columns, A = [A_hi; A_lo], B = the
    //    staged rows, four k steps at a time, loads first (two chains of sums); y goes on as [Y_hi; Y_lo]
    for (int nt = warp; nt < XQ / 8; nt += kWarps) {
      const uint32_t abase = aa + r16 * lda * 2 + hb * 16, xcol = xs + (nt >> 3) * box;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < n_mk; k0 += 4) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (k0 + t < n_mk) {
            const int ks = k0 + t, j = min(16 * ks + r16, K - 1);
            ldsm_x4(af[t], abase + ks * 32);
            ldsm_x2_t(bf[t], xcol + j * 128 + (((nt & 7) ^ (j & 7)) << 4));
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k0 + t < n_mk) staged::mma_bf16(acc[t & 1], af[t], bf[t][0], bf[t][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] += acc[1][e];
      // row h holds hi, row H + h lo (rows 8.. for H = 8)
      const float v0 = staged::hi_plus_lo<H, false>(acc[0][0], acc[0][2]);
      const float v1 = staged::hi_plus_lo<H, false>(acc[0][1], acc[0][3]);
      if (g < H) {
        uint32_t hi, lo;
        staged::split2(v0, v1, hi, lo);
        *reinterpret_cast<uint32_t*>(yb + g * XQ + 8 * (nt ^ (g & 7)) + 2 * tq) = hi;
        *reinterpret_cast<uint32_t*>(yb + (H + g) * XQ + 8 * (nt ^ ((H + g) & 7)) + 2 * tq) = lo;
      }
    }
    __syncthreads();

    // 4. the block's partial out O[d] = y_h(d)[quarter] . W_v[quarter, d], as O^T = W_v^T Y^T: a warp per 16
    //    columns d, all of one head h, A = W_v^T (weight rows by ldmatrix.trans), B = the rows Y_hi[h] and
    //    Y_lo[h] as the columns n = 0 and 1 of the product (repeated in 2..7, whose results are never read),
    //    four k steps at a time, loads first (two chains of sums); n = 0 and 1 summed, sent into ro[rank] of
    //    the block owning d
    for (int mt = warp; mt < D / 16; mt += kWarps) {
      const int h = 16 * mt / DH, r8 = lane & 7, hl = (lane >> 3) & 1, arow = r8 + 8 * hb;
      const int yrow = (r8 & 1) ? H + h : h;
      const uint32_t wcol = wsm + arow * WROW + (((D / 8 + 2 * mt + hl) ^ r8) << 4);
      const uint32_t yrow_a = ua + yrow * XQ * 2;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int t0 = 0; t0 < N_MT; t0 += 4) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int t = 0; t < 4 && t0 + t < N_MT; ++t) {
          const int ks = t0 + t;
          ldsm_x4_t(af[t], wcol + ks * 16 * WROW);
          ldsm_x2(bf[t], yrow_a + (((2 * ks + hl) ^ (yrow & 7)) << 4));
        }
#pragma unroll
        for (int t = 0; t < 4 && t0 + t < N_MT; ++t) staged::mma_bf16(acc[t & 1], af[t], bf[t][0], bf[t][1]);
      }
      if (tq == 0) {
        const int owner = 16 * mt / DQ;
        const uint32_t dst = map_rank(smem_u32(smem + p.L.ro), owner) + (b * D + rank * DQ + 16 * mt - owner * DQ) * 4;
        const uint32_t bar = map_rank(bar0 + 32 + 8 * b, owner);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v = (acc[0][2 * hr] + acc[1][2 * hr]) + (acc[0][2 * hr + 1] + acc[1][2 * hr + 1]);
          st_async(dst + (g + 8 * hr) * 4, v, bar);
        }
      }
    }
    if (sn < p.n_src && tid < K) nxt[p.L.inv + tid] = inv_next;
  }
  const int n_it = s0 < p.n_src ? (p.n_src - 1 - s0) / n_cl + 1 : 0;
  if (n_it > 0) {
    cluster_wait();  // the last arrival's
    finish(s0 + (n_it - 1) * n_cl, n_it - 1, 0, kThreads);
  }
  cluster.sync();  // no block leaves while another may still send into its shared memory
}

}  // namespace cluster_x
