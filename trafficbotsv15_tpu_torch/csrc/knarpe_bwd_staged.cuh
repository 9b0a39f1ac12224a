// The bf16 KNARPE cross-attention backward B2/B3-bwd, redesigned for Hopper:
// each source is staged in shared memory by bulk copies and read from device
// memory once, and every per-source product runs on the tensor cores.
//
// Replaces, for bf16 operands, trafficbotsv15_tpu/ops/pallas_knarpe.py
// _x_bwd_kernel (:463-547, launched at :579), the backward of
// knarpe_cross_attention (B2) and of knarpe_cross_attention_v3 (B3, whose
// backward is B2's, :778-783). knarpe_bwd.cu keeps float32, B4-bwd and the
// bf16 shapes refused below (the general route), and the two weight-gradient
// passes that follow both routes. The algebra is knarpe_bwd.cu's: the [K, 2D]
// dkv is never formed, and per source the kernel writes dq, dtgt | drpe and
// its rows of pbuf, P = [scale z_h | scale sum dl_hj] and [y_h | sum attn_hj].
//
// What bounds it: the bytes. At the training step's shape (8 x 64 sources,
// K=89, D=R=128, H=4) a launch must read tgt, rpe, q, g, the mask and the
// weights and write dtgt, drpe, dq and the weight gradients: 47.4 MB, 0.0141 ms
// at 3.35 TB/s; the reassociated work is ~0.7 M multiply-adds per source
// (0.73 GFLOP, under 0.001 ms on the bf16 tensor cores). The previous design
// (knarpe_bwd.cu's CUDA-core kernel) read x_j twice per source, the second
// time through L2 with strided loads, did every product on the CUDA cores in
// float32 one output per thread, and reached ~6.5 % of the bound: latency
// held it back. Here:
//   - one persistent 512-thread block per SM walks over sources; its shared
//     memory holds the bf16 [W_kv; W_rpe] (X rows of 2D, XOR-swizzled) and
//     one source stage: the [tgt_j | rpe_j] rows, q, g and the mask. The
//     tensor memory accelerator fills the stage: tgt and rpe by 2-D tensor
//     copies (cp.async.bulk.tensor) of 64 columns by K rows, which land with
//     the 128-byte swizzle, so that the eight rows an ldmatrix reads fall on
//     distinct banks; q and g by 1-D bulk copies; all complete on one
//     mbarrier. One warp issues the six copies of a source. (One bulk copy
//     per row, 2K + 2 of them, kept the issuing warps waiting on the copy
//     engine for a large part of a source's time.) Both the logits/dattn
//     step and the y/z step read the staged rows;
//   - one stage, not two: at K=89, D=R=128, H=4 the weights take 131,072 B,
//     the bias 512 B, a stage 49,760 B (four boxes of 12,288 B, K x 128 B
//     rounded up to the 1,024 B the swizzle repeats over; q and g 256 B each,
//     the mask 96 B), the scratch below 26,736 B, and 1,024 B to align the
//     stage: 209,104 B of the block's 232,448 B. A second stage would need
//     258,864 B. Instead the next source is prefetched into L2
//     (cp.async.bulk.prefetch.L2) when a source starts, and its copies into
//     the stage are issued as soon as the y/z step has read the staged rows,
//     so they land while dx and dq are computed (neither reads the stage).
//     At 512 sources on 132 SMs each block sees ~4 sources, so a ring would
//     hide at most 3 copies in 4 anyway. One stage also takes K=128 at
//     D=R=128 (227,792 B), the softmax's limit;
//   - every per-source product runs as mma.sync.m16n8k16 with float32
//     accumulate, a float32 operand split into bf16 hi + lo (16 significant
//     bits, so float32-level results before the single bf16 rounding):
//       [u | w] = [W_k Q | W_v G], Q and G the head-masked q and g built in
//                registers (bf16 x bf16: exact products) -> [U | W] hi/lo;
//       [lgt | dattn] = x [U | W], K padded to 16 by repeating row K-1,
//                whose results are never stored;
//       softmax over K per head, one warp per head, float32 on the CUDA
//                cores, each lane's K / 32 targets in registers;
//                dl = attn (dattn - sum attn dattn); writes
//                P = [scale DL | A] hi/lo as bf16 rows;
//       [z'; y] = P x (z' = scale z), rows hi + lo summed -> pbuf and Z hi/lo;
//       dx = [scale DL | A] [U; W], both operands float32: A and B both split,
//                (A_hi + A_lo)(B_hi + B_lo) in two k steps, so float32-level
//                error before the one bf16 rounding; one buffer serves both
//                P products (ldmatrix and ldmatrix.trans), one [X][16]
//                buffer both [U | W] products. Each warp's 16 x 16 tile goes
//                through shared memory (stmatrix) to 32-byte row pieces;
//       dq = z'_h W_k[:, h]^T + b_k[h] scale sum dl, Z split hi/lo;
//   - scratch at K=89: [U | W] hi/lo 8,192 B, Z hi/lo 4,096 B, P 3,328 B
//     (16 rows of K padded to 96, + 8 so that rows fall on distinct banks),
//     logits and dattn 2 x 1,424 B, per-head scalars 64 B, the warps' dx
//     tiles 8,192 B, the mbarrier 16 B.
// The 4-wide RPE of pose_rpe "xy_dir" (d_rpe = 4) takes the same kernel, its
// rpe zero-padded to one k step as in knarpe_staged.cuh (X = D + 16 staged
// columns): an 8-byte row is no tensor map's row stride (a multiple of 16
// bytes), so thread j copies rpe row j by an 8-byte cp.async into the first
// half of chunk 0 of its 128-byte swizzled row, the rest of the row's 16
// columns zero, waited for at the source's last block barrier; W_rpe's rows
// 4-15 are zero in shared memory. pbuf keeps the D + 4 real inputs (the
// weight-gradient passes of knarpe_bwd.cu are those of any route), and the dx
// step writes each drpe row as one 8-byte store. At K=89, D=128, H=4 the bound
// is ~24.8 MB, 0.0074 ms at [8·64, K=89].
// Five block barriers per source. No atomics: every sum has a fixed order,
// so two launches on the same inputs give the same bits. A source with no
// valid target gets attn = dl = 0 and so zero gradients.

#pragma once

#include "knarpe_staged.cuh"

namespace staged_bwd {

using staged::a16;
using staged::kMask;
using staged::kThreads;
using staged::kWarps;
using staged::ldsm_x2;
using staged::ldsm_x2_t;
using staged::ldsm_x4;
using staged::ldsm_x4_t;
using staged::pad16;
using staged::smem_u32;

constexpr int kUW = 16;  // columns of [U_hi W_hi | U_lo W_lo]: 2H <= 8 per half

// The stage holds tgt and rpe as boxes of 64 columns by K rows (staged::box_bytes says how they land).
using staged::box_bytes;
using staged::n_boxes;

// Byte offsets from the block's 1024-byte aligned base in dynamic shared memory (total counts the
// alignment's slack); the stage's fields are offsets inside it.
struct Layout {
  size_t slot, slot_bytes, box, xt, xr, q, g, inv, w, bias, uw, zb, p, lg, da, st, dxb, bar, total;
};

inline Layout make_layout(int K, int D, int R, int H) {
  Layout L{};
  const int Rs = staged::rpe_cols(R);
  const size_t X = static_cast<size_t>(D) + Rs;
  L.box = box_bytes(K);
  L.xt = 0;
  L.xr = n_boxes(D) * L.box;
  L.q = L.xr + n_boxes(Rs) * L.box;
  L.g = L.q + a16(static_cast<size_t>(D) * 2);
  L.inv = L.g + a16(static_cast<size_t>(D) * 2);
  L.slot_bytes = L.inv + a16(static_cast<size_t>(K));
  size_t off = 0;
  L.slot = off; off += L.slot_bytes;
  L.w = off;    off += X * 2 * D * 2;
  L.bias = off; off += a16(static_cast<size_t>(D) * 2 * 2);
  L.uw = off;   off += X * kUW * 2;
  L.zb = off;   off += 8 * X * 2;
  L.p = off;    off += static_cast<size_t>(16) * (pad16(K) + 8) * 2;
  L.lg = off;   off += a16(static_cast<size_t>(H) * K * 4);
  L.da = off;   off += a16(static_cast<size_t>(H) * K * 4);
  L.st = off;   off += a16(static_cast<size_t>(4) * H * 4);
  L.dxb = off;  off += static_cast<size_t>(kWarps) * 16 * 16 * 2;
  L.bar = off;  off += 16;
  L.total = off + 1024;
  return L;
}

constexpr int kMaxK = 128;  // the softmax keeps K / 32 targets per lane in registers

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::BWD_STAGED_REFUSALS words each code.
inline int refusal(int K, int D, int R, int H, size_t max_smem) {
  if (K < 1 || K > kMaxK) return 1;
  if (D % 16 || (R % 16 && R != 4)) return 2;
  if (H > 4) return 3;
  if (make_layout(K, D, R, H).total > max_smem) return 4;
  return 0;
}

struct Params {
  CUtensorMap tm_t, tm_r;  // tgt [n_src K, D] and rpe [n_src K, R] as 2-D tensors, boxes of 64 x K, 128-byte swizzle
  const __nv_bfloat16 *q, *g, *tgt, *rpe, *w_kv, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16 *dq, *dtgt, *drpe;
  float* pbuf;  // [n_src, 2, H, D + r_in + 1]
  int n_src, n_knn, d_model, d_rpe;  // d_rpe: staged::rpe_cols(R), the staged width
  int r_in;  // R, the rpe columns in device memory (rpe, drpe, W_rpe): d_rpe, or 4 below its 16 staged ones
  int mw;  // swizzle mask of the weight rows
  float scale;
  Layout L;
};

// shared address of 16-byte chunk c (of X / 8) of target row j in the stage at shared address slot
__device__ __forceinline__ uint32_t x_addr(const Params& p, uint32_t slot, int j, int c) {
  const int ct = p.d_model >> 3;
  const bool t = c < ct;
  const int cc = t ? c : c - ct;
  return slot + static_cast<uint32_t>((t ? p.L.xt : p.L.xr) + (cc >> 3) * p.L.box) + j * 128 +
         (((cc & 7) ^ (j & 7)) << 4);
}

__device__ __forceinline__ void bulk_prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return staged::bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}
// element (i, c) of the [X][16] [U | W] buffer: 16-byte chunk c >> 3 of row i, the chunks swapped in
// rows 4-7 of every 8 so that ldmatrix's eight 32-byte rows fall on distinct banks
__device__ __forceinline__ __nv_bfloat16* uw_at(__nv_bfloat16* uw, int i, int c) {
  return uw + i * kUW + (((c >> 3) ^ ((i >> 2) & 1)) << 3) + (c & 7);
}

// Source s into the stage, issued by the lanes of one warp: lane b < n_boxes(D) copies tgt's box b (a
// tensor copy of K rows by 64 columns; columns past D are filled with zeros and never read), the next
// n_boxes(R) lanes rpe's, and the two after them q and g (bulk copies). Lane 0 also arrives on the
// mbarrier, expecting all of the boxes' bytes and q's and g's. Narrow rpe rows (r_in < d_rpe: 8 bytes, not a
// tensor map's row stride) are no tensor copies: stage_narrow_rpe copies them.
__device__ __forceinline__ void stage_source(const Params& p, uint32_t slot, uint32_t bar, int s, int lane) {
  const int K = p.n_knn, D = p.d_model, nt = n_boxes(D), nr = p.r_in == p.d_rpe ? n_boxes(p.d_rpe) : 0;
  if (lane == 0) staged::mbar_expect(bar, static_cast<uint32_t>((nt + nr) * K * 128 + 2 * D * 2));
  if (lane < nt) {
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.xt + lane * p.L.box), &p.tm_t, 64 * lane, s * K, bar);
  } else if (lane < nt + nr) {
    staged::tma_load_2d(slot + static_cast<uint32_t>(p.L.xr + (lane - nt) * p.L.box), &p.tm_r, 64 * (lane - nt), s * K, bar);
  } else if (lane < nt + nr + 2) {
    const bool is_q = lane == nt + nr;
    staged::bulk_copy(slot + static_cast<uint32_t>(is_q ? p.L.q : p.L.g), (is_q ? p.q : p.g) + static_cast<size_t>(s) * D,
                      D * 2, bar);
  }
}

// The narrow rpe rows of source s (r_in = 4 bf16, 8 bytes) into the stage's rpe box by 8-byte cp.async from thread
// j < K: the first 8 bytes of row j's 16-byte chunk 0 (at chunk j & 7 under the swizzle); its other 8 bytes and chunk
// 1, the rest of the 16 staged columns, stay zero (set once). The issuing threads wait (cp_wait_all) before the block
// barrier after which the stage is read.
__device__ __forceinline__ void stage_narrow_rpe(const Params& p, uint32_t slot, int s, int tid) {
  if (tid < p.n_knn) {
    const size_t row = static_cast<size_t>(s) * p.n_knn + tid;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(x_addr(p, slot, tid, p.d_model >> 3)),
                 "l"(p.rpe + row * 4) : "memory");
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1) knarpe_x_bwd_staged_kernel(const __grid_constant__ Params p) {
  static_assert(H == 1 || H == 2 || H == 4, "[U | W] hi and lo share one 16-column tile: 2H <= 8");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: the stage starts on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // an mma fragment's row group and column pair
  // X: the staged columns; Xr = D + r_in, of which pbuf's rows hold X1 = Xr + 1 (the last the bias's)
  const int K = p.n_knn, D = p.d_model, R = p.d_rpe, X = D + R, Xr = D + p.r_in, X1 = Xr + 1, dh = D / H;
  const bool narrow = p.r_in != R;
  const int kp = pad16(K), lda = kp + 8;
  const float scale = p.scale;
  __nv_bfloat16* uw = reinterpret_cast<__nv_bfloat16*>(smem + p.L.uw);  // [X][16]: [U_hi W_hi | U_lo W_lo]
  __nv_bfloat16* zb = reinterpret_cast<__nv_bfloat16*>(smem + p.L.zb);  // [8][X]: [Z_hi; Z_lo; 0], swizzled
  const int my = staged::swizzle_mask(X >> 3);
  // [16][lda]: rows [scale DL_hi | A_hi | 0] then [scale DL_lo | A_lo | 0], 8 rows each; columns K.. zero
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(smem + p.L.p);
  float* lg = reinterpret_cast<float*>(smem + p.L.lg);  // logits [h][j]
  float* da = reinterpret_cast<float*>(smem + p.L.da);  // dattn [h][j]
  float* cst = reinterpret_cast<float*>(smem + p.L.st);  // [0, H): b_k . q_h, [H, 2H): b_v . g_h
  float* asum = cst + 2 * H;                             // sum_j attn_hj
  float* sdl = cst + 3 * H;                              // sum_j scale dl_hj
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // [b_k | b_v]
  unsigned char* slot = smem + p.L.slot;
  const uint32_t slot_s = smem_u32(slot);
  const uint32_t bar = smem_u32(smem + p.L.bar);
  __nv_bfloat16* dxb = reinterpret_cast<__nv_bfloat16*>(smem + p.L.dxb) + warp * 256;  // this warp's dx tile

  if (tid == 0) {
    staged::mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int s = blockIdx.x;
  if (narrow) {  // bytes 8-15 of chunk 0 and all of chunk 1 of every narrow rpe row stay zero
    for (int j = tid; j < K; j += kThreads) {
      unsigned char* c0 = slot + p.L.xr + j * 128 + ((j & 7) << 4);
      *reinterpret_cast<uint2*>(c0 + 8) = make_uint2(0u, 0u);
      *reinterpret_cast<uint4*>(slot + p.L.xr + j * 128 + ((1 ^ (j & 7)) << 4)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (s < p.n_src) {  // the first source streams in with the weights
    if (warp == 0) stage_source(p, slot_s, bar, s, lane);
    if (narrow) stage_narrow_rpe(p, slot_s, s, tid);
    if (tid < K) slot[p.L.inv + tid] = p.invalid[static_cast<size_t>(s) * K + tid];
  }
  staged::load_weights(p, smem, tid);
  // the padding of [U | W], Z and P stays zero: the dx and dq products sum over it
  for (int e = tid; e < X * kUW; e += kThreads) uw[e] = __float2bfloat16_rn(0.f);
  for (int e = tid; e < 8 * X; e += kThreads) zb[e] = __float2bfloat16_rn(0.f);
  for (int e = tid; e < 16 * lda; e += kThreads) pb[e] = __float2bfloat16_rn(0.f);
  staged::cp_wait_all();
  __syncthreads();

  for (int it = 0; s < p.n_src; s += gridDim.x, ++it) {
    const int sn = s + gridDim.x;
    uint8_t inv_next = 0;
    if (sn < p.n_src) {  // the block's next source, into L2 while this one is computed
      if (tid == 0) {
        bulk_prefetch_l2(p.tgt + static_cast<size_t>(sn) * K * D, static_cast<uint32_t>(K * D * 2));
        // the source's rpe rows, widened to 16-byte bounds (narrow rows: K * 8 bytes from an 8-byte boundary)
        const uintptr_t r0 = reinterpret_cast<uintptr_t>(p.rpe + static_cast<size_t>(sn) * K * p.r_in);
        const uintptr_t lo = r0 & ~static_cast<uintptr_t>(15);
        const uintptr_t hi = (r0 + static_cast<size_t>(K) * p.r_in * 2 + 15) & ~static_cast<uintptr_t>(15);
        bulk_prefetch_l2(reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo));
      }
      if (tid < K) inv_next = p.invalid[static_cast<size_t>(sn) * K + tid];
    }
    staged::mbar_wait(bar, it & 1);  // this source's fill has landed
    const uint8_t* inv = slot + p.L.inv;
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(slot + p.L.q);
    const uint32_t* g2 = reinterpret_cast<const uint32_t*>(slot + p.L.g);
    float* prow = p.pbuf + static_cast<size_t>(s) * 2 * H * X1;  // [2, H, X1]

    // 1. [u | w][i][c] = W_k[i, head c] . q_c (c < H), W_v[i, head c - H] . g_{c-H} (H <= c < 2H): a warp per
    //    16 rows; B = the head-masked q (for W_k) and g (for W_v) in registers, in columns that do not
    //    overlap, so the two products (two chains of sums, to keep two mma in flight) add up to [u | w].
    //    Split into [U_hi W_hi | U_lo W_lo]. Then the bias terms.
    {
      // this lane's B column: u of head g (g < H) or w of head g - H (H <= g < 2H), over d in [d_lo, d_hi)
      const uint32_t* v2 = g < H ? q2 : g2;
      const int d_lo = (g < H ? g : g - H) * dh, d_hi = g < 2 * H ? d_lo + dh : d_lo;
      for (int mt = warp; mt < X / 16; mt += kWarps) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc_w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int ks = 0; ks < D / 16; ++ks) {
          const int d0 = 16 * ks + 2 * tq;  // B's rows d0, d0 + 1 and d0 + 8, d0 + 9 of column g
          const uint32_t b0 = d0 >= d_lo && d0 < d_hi ? v2[d0 >> 1] : 0u;
          const uint32_t b1 = d0 + 8 >= d_lo && d0 + 8 < d_hi ? v2[(d0 + 8) >> 1] : 0u;
          uint32_t a[4];
          ldsm_x4(a, smem_u32(staged::w_chunk(p, smem, 16 * mt + (lane & 15), 2 * ks + (lane >> 4))));
          staged::mma_bf16(acc, a, g < H ? b0 : 0u, g < H ? b1 : 0u);
          ldsm_x4(a, smem_u32(staged::w_chunk(p, smem, 16 * mt + (lane & 15), D / 8 + 2 * ks + (lane >> 4))));
          staged::mma_bf16(acc_w, a, g < H ? 0u : b0, g < H ? 0u : b1);
        }
        const int c = 2 * tq;
        if (c < 2 * H) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 16 * mt + g + 8 * hr;
            uint32_t hi, lo;
            staged::split2(acc[2 * hr] + acc_w[2 * hr], acc[2 * hr + 1] + acc_w[2 * hr + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(uw_at(uw, i, c)) = hi;
            *reinterpret_cast<uint32_t*>(uw_at(uw, i, 8 + c)) = lo;
          }
        }
      }
    }
    if (warp < 2 * H) {
      const int h = warp < H ? warp : warp - H;
      const __nv_bfloat16* vec = reinterpret_cast<const __nv_bfloat16*>(slot + (warp < H ? p.L.q : p.L.g));
      const int off = warp < H ? 0 : D;
      float acc = 0.f;
      for (int d = lane; d < dh; d += 32)
        acc += __bfloat162float(bias[off + h * dh + d]) * __bfloat162float(vec[h * dh + d]);
      acc = staged::warp_sum(acc);
      if (lane == 0) cst[warp] = acc;
    }
    __syncthreads();

    // 2. [logits | dattn][j][c] = x_j . [u | w][c] (+ the bias terms): a warp per 16 targets, A = the staged
    //    rows, B = [U_hi W_hi | U_lo W_lo]; column c of the hi tile and of the lo tile sit in one lane
    for (int mt = warp; mt < kp / 16; mt += kWarps) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int arow = min(16 * mt + (lane & 15), K - 1);
      for (int ks = 0; ks < X / 16; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, x_addr(p, slot_s, arow, 2 * ks + (lane >> 4)));
        ldsm_x4_t(b, smem_u32(uw_at(uw, 16 * ks + (lane & 15), 8 * (lane >> 4))));
        staged::mma_bf16(acc[0], a, b[0], b[1]);
        staged::mma_bf16(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mt + g + 8 * hr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * tq + e;
          const float v = acc[0][2 * hr + e] + acc[1][2 * hr + e];
          if (row < K && c < 2 * H) {
            if (c < H) lg[c * K + row] = (v + cst[c]) * scale;
            else da[(c - H) * K + row] = v + cst[c];
          }
        }
      }
    }
    __syncthreads();

    // 3. masked softmax over K and dl = attn (dattn - sum attn dattn), one warp per head (as
    //    knarpe_bwd.cu); rows h, H + h of P take scale dl and attn, hi and lo 8 rows apart
    if (warp < H) {  // target j = lane + 32 r of the head in registers (K <= kMaxK)
      constexpr int kR = kMaxK / 32;
      float lv[kR], dv[kR];
      float m = -INFINITY;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int j = lane + 32 * r;
        const bool ok = j < K && !inv[min(j, K - 1)];
        lv[r] = ok ? lg[warp * K + j] : -INFINITY;
        dv[r] = j < K ? da[warp * K + j] : 0.f;
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
          pb[warp * lda + j] = vh;
          pb[(8 + warp) * lda + j] = __float2bfloat16_rn(v - __bfloat162float(vh));
          pb[(H + warp) * lda + j] = ah;
          pb[(8 + H + warp) * lda + j] = __float2bfloat16_rn(a - __bfloat162float(ah));
          as += a;
          sds += v;
        }
      }
      as = staged::warp_sum(as);
      sds = staged::warp_sum(sds);
      if (lane == 0) {
        asum[warp] = as;
        sdl[warp] = sds;
        prow[static_cast<size_t>(warp) * X1 + Xr] = sds;     // column Xr: the constant input of the bias
        prow[static_cast<size_t>(H + warp) * X1 + Xr] = as;
      }
    }
    __syncthreads();

    // 4. [z'; y][c][i] = sum_j P[c][j] x_j[i] (z' = scale z): a warp per 16 inputs, A = P, B = the staged
    //    rows; row c (hi) and row 8 + c (lo) sit in one lane. -> pbuf rows, and z' as [Z_hi; Z_lo]
    for (int np = warp; np < X / 16; np += kWarps) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < kp / 16; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, smem_u32(pb + (lane & 15) * lda + 16 * ks + 8 * (lane >> 4)));
        ldsm_x4_t(b, x_addr(p, slot_s, min(16 * ks + (lane & 15), K - 1), 2 * np + (lane >> 4)));
        staged::mma_bf16(acc[0], a, b[0], b[1]);
        staged::mma_bf16(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float v0 = acc[t][0] + acc[t][2], v1 = acc[t][1] + acc[t][3];
        const int i = 16 * np + 8 * t + 2 * tq;
        if (g < 2 * H && i < Xr) {  // pbuf's [2, H] rows: k half (z') for c < H, v half (y) after; no padding
          prow[static_cast<size_t>(g) * X1 + i] = v0;
          prow[static_cast<size_t>(g) * X1 + i + 1] = v1;
        }
        if (g < H) {
          uint32_t hi, lo;
          staged::split2(v0, v1, hi, lo);
          const int c = 2 * np + t;
          *reinterpret_cast<uint32_t*>(zb + g * X + 8 * (c ^ (g & my)) + 2 * tq) = hi;
          *reinterpret_cast<uint32_t*>(zb + (H + g) * X + 8 * (c ^ ((H + g) & my)) + 2 * tq) = lo;
        }
      }
    }
    __syncthreads();

    // 5. The stage is read: the next source's copies go out now and land during dx and dq.
    if (sn < p.n_src) {
      if (warp == 0) stage_source(p, slot_s, bar, sn, lane);
      if (narrow) stage_narrow_rpe(p, slot_s, sn, tid);
      if (tid < K) slot[p.L.inv + tid] = inv_next;
    }
    // dx_j = sum_h scale dl_hj u_h + attn_hj w_h: a warp per 16 inputs (fixed B) and, in turn, each 16
    // targets; A = [scale DL | A] (P read transposed), B = [U | W] ([X][16] read as rows);
    // (A_hi + A_lo) B_hi, then (A_hi + A_lo) B_lo. The tile goes through the warp's buffer (stmatrix,
    // 32-byte rows swizzled like [U | W]) to one 32-byte piece of a dtgt / drpe row per lane.
    for (int cp = warp; cp < X / 16; cp += kWarps) {
      const int mi = lane >> 3, r8 = lane & 7;
      uint32_t b[4];  // B hi and lo of the pair's two 8-input tiles
      ldsm_x4(b, smem_u32(uw_at(uw, 16 * cp + r8 + 8 * (mi >> 1), 8 * (mi & 1))));
      const int col = 16 * cp + 8 * (lane & 1);
      const int rr = lane >> 1;
      __nv_bfloat16* dst_base = col < D ? p.dtgt + static_cast<size_t>(s) * K * D + col
                                        : p.drpe + static_cast<size_t>(s) * K * p.r_in + (col - D);
      const int ld = col < D ? D : p.r_in;
      // this lane's 8 columns: all of them, or of a narrow drpe row its 4 (8 bytes) or none (padding)
      const int n_cols = col < D ? 8 : min(8, p.r_in - (col - D));
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
        stsm_x4(smem_u32(dxb + sr * 16 + 8 * (sc ^ ((sr >> 2) & 1))), pack_bf16(acc[0][0], acc[0][1]),
                pack_bf16(acc[0][2], acc[0][3]), pack_bf16(acc[1][0], acc[1][1]), pack_bf16(acc[1][2], acc[1][3]));
        __syncwarp();
        const int j = 16 * mt + rr;
        const __nv_bfloat16* piece = dxb + rr * 16 + 8 * ((lane & 1) ^ ((rr >> 2) & 1));
        if (j < K && n_cols == 8)
          *reinterpret_cast<uint4*>(dst_base + static_cast<size_t>(j) * ld) = *reinterpret_cast<const uint4*>(piece);
        else if (j < K && n_cols == 4)
          *reinterpret_cast<uint2*>(dst_base + static_cast<size_t>(j) * ld) = *reinterpret_cast<const uint2*>(piece);
        __syncwarp();
      }
    }
    // dq[d] = z'_h(d) . W_k[:, d] + b_k[d] sum_j scale dl_hj: a warp per 8 columns, A = [Z_hi; Z_lo]
    // (rows 8.. zero), B = W_k; of the result, the rows of head h(d) are kept
    for (int nt = warp; nt < D / 8; nt += kWarps) {
      float acc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // even and odd k steps
      auto k_step = [&](int ks, float (&sum)[4]) {
        const int r = lane & 7, c = 2 * ks + ((lane >> 3) & 1);
        uint32_t a2[2], bw[2];
        ldsm_x2(a2, smem_u32(zb + r * X + 8 * (c ^ (r & my))));
        const uint32_t a[4] = {a2[0], 0u, a2[1], 0u};
        ldsm_x2_t(bw, smem_u32(staged::w_chunk(p, smem, 16 * ks + (lane & 15), nt)));
        staged::mma_bf16(sum, a, bw[0], bw[1]);
      };
      for (int ks = 0; ks < X / 16; ks += 2) {
        k_step(ks, acc2[0]);
        if (ks + 1 < X / 16) k_step(ks + 1, acc2[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = staged::hi_plus_lo<H, false>(acc2[0][e] + acc2[1][e], acc2[0][2 + e] + acc2[1][2 + e]);
        const int d = 8 * nt + 2 * tq + e, h = d / dh;
        if (g == h)
          p.dq[static_cast<size_t>(s) * D + d] = __float2bfloat16_rn(v + __bfloat162float(bias[d]) * sdl[h]);
      }
    }
    if (narrow) staged::cp_wait_all();
    __syncthreads();
  }
}

}  // namespace staged_bwd
