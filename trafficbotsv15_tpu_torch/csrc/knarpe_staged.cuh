// The bf16 KNARPE cross-attention forwards B2 and B3, redesigned for Hopper:
// each source's targets are staged in shared memory while the block computes
// the previous source, and the per-source products run on the tensor cores.
//
// Replaces, for bf16 operands, trafficbotsv15_tpu/ops/pallas_knarpe.py
// _x_fwd_kernel (B2, MODE 1) and _x3_fwd_kernel (B3, MODE 2); knarpe.cu keeps
// the float32 instantiations and B4. Contract as knarpe.cu's header says.
//
// What bounds them: the bytes. At the rollout's shape (8192 sources x K=89
// targets x [tgt 128 | rpe 128] bf16) a launch must read ~378 MB, 0.113 ms at
// 3.35 TB/s; B2's reassociated arithmetic (knarpe.cu) is ~2 G multiply-adds
// and B3's k projection 24 G. The previous design read each source's x_j
// straight from device memory, one source after another behind eight
// barriers, and reached ~9 % of the bound: latency, not bytes or arithmetic,
// held it back. Here:
//   - one persistent 512-thread block per SM walks over sources. Its shared
//     memory holds the bf16 [W_kv; W_rpe] (X rows of 2D) and a ring of two
//     source stages, each [tgt | rpe] rows (K x D and K x R), q and the mask.
//     While source s is computed, source s + grid is copied into the other
//     stage, so every x_j is read from device memory once and the copy of one
//     source hides behind the arithmetic of the previous one;
//   - the copies are bulk copies (cp.async.bulk, the 1-D TMA) completing on
//     the stage's mbarrier: a thread per row piece, no thread waits on them
//     until the stage is needed. Each row lands rotated by j & 7 of its
//     16-byte chunks (so in two pieces), which puts one chunk of eight
//     consecutive rows, as ldmatrix reads it, on eight distinct bank groups;
//     the resident weights and [Y_hi; Y_lo] are XOR-swizzled to the same end.
//     ~360 small copies per source keep the issuing threads busy for about as
//     long as a step, so warps that have no item in the logits step and the
//     softmax issue them;
//   - every per-source product runs as mma.sync.m16n8k16 (bf16 operands by
//     ldmatrix, float32 accumulate). A float32 operand (u, attn, y) is split
//     into bf16 hi + lo = hi + bf16(v - hi), 16 significant bits, and both
//     halves go through the product, so B2 keeps float32-level results
//     (relative error ~2^-17 per term) and rounds once at the output. B2 per
//     source:
//       u   = W_k Q, Q [D, 8] the head-masked q built in registers (X x D x 8);
//       lgt = x [U_hi | U_lo] + c, K padded to 16 by repeating row K-1, whose
//             results are never stored (K x X x 8, or x 16 for H = 8);
//       softmax over K per head (one warp per head), writing [A_hi; A_lo];
//       y   = [A_hi; A_lo] x (16 x K x X);
//       out = [Y_hi; Y_lo] W_v (16 x X x D), the rows of head h(d) kept, + b_v Σa;
//   - B3 forms kk = x @ [W_k; W_rpe,k] the same way (bf16 products are exact;
//     only the order of the float32 sums differs from jnp.dot), then, as
//     _x3_fwd_kernel: + b_k, round to bf16, q * kk rounded to bf16, summed per
//     head in float32; its v half is B2's y and out steps (no rounding);
//   - the budget, at the rollout's shape (K=89, D=R=128, H=4; a block may use
//     232,448 B): weights 131,072 B and bias 512 B, two stages 2 x 45,920 B
//     (tgt and rpe 22,784 B each, q 256 B, mask 96 B), [U_hi | U_lo] then
//     [Y_hi; Y_lo] 4,096 B, the logits 1,424 B, [A_hi; A_lo] 3,328 B (16 rows
//     of K padded to 96, + 8 so that ldmatrix rows fall on distinct banks),
//     three per-head scalars 48 B, two mbarriers 16 B: 232,336 B. Padded
//     stage rows would cost 5.7 KB more, so rows are rotated instead (below);
//     nothing keeps partial sums.
// The 4-wide RPE of pose_rpe "xy_dir" (d_rpe = 4) takes the same kernel in
// a variant of its own (NARROW). Its 8-byte rpe rows are below a bulk copy's
// 16 bytes and, at odd sources, off 16-byte alignment (K=89), so they come in
// by 8-byte cp.async, one thread a row, waited for at the source's last
// barrier; in the stage each lands at the start of a 32-byte row whose other
// 24 bytes stay zero, and W_rpe's rows 4-15 are zero in shared memory, so X =
// D + 16 and every product takes one k step more than over tgt alone (eight
// at R = 128), the padding adding exact zeros. At the flagship's widths (K=89,
// D=128, H=4) the bound is ~197 MB, 0.059 ms at [128·64, K=89]. There the
// wide kernel's scheme, one source a block of 16 warps and ~180 bulk copies a
// source (two a rotated tgt row), held 5.5 µs a source (0.342 ms on an H100).
// NARROW changes two things, each worth little alone and ~1.5x together
// (two groups with bulk copies 0.320 ms, one group with tensor copies 0.301
// ms, both 0.229 ms; the last two in turns): tgt comes in by 2-D tensor copies,
// one a box of 64 columns by K rows landing with the 128-byte swizzle (as
// knarpe_bwd_staged.cuh's), q by one bulk copy, three copies a source issued
// by one thread as the source before it starts; and where they fit (up to 4
// heads, K <= 256) two groups of 8 warps a block each run their own sources
// with their own ring of two stages and scratch, the weights shared, each
// group's steps separated by its own named barrier (`group_count`): 204,704 B
// at the flagship's widths (slots on 1,024-byte bounds, 28,672 B each).
// No atomics: every sum has a fixed order, so two launches on the same inputs
// give the same bits. Only bf16 comes here, and every bf16 B2 and B3 that the
// staged kernel takes does.

#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace staged {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kMask = -1e9f;

__host__ __device__ inline size_t a16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline int pad16(int k) { return (k + 15) & ~15; }
// rpe columns a staged row holds: R, or 16 for the 4-wide RPE of pose_rpe "xy_dir" (its 8-byte rows, below the
// bulk copies' 16 bytes, come in by 8-byte cp.async and are zero-padded to one k step of the tensor cores, as
// W_rpe's rows are: the padding adds exact zeros to every product)
__host__ __device__ inline int rpe_cols(int R) { return R == 4 ? 16 : R; }
// columns of [U_hi | U_lo] and rows of [Y_hi; Y_lo]: 2H padded to 8
__host__ __device__ inline int u_cols(int H) { return H <= 4 ? 8 : 16; }

// A 2-D tensor copy (encode_rows) lands rows of bf16 as boxes of 64 columns (128 bytes) by K rows with the
// 128-byte swizzle: 16-byte chunk c of row j at chunk c ^ (j & 7), rows 128 bytes apart, so the eight rows
// an ldmatrix reads fall on distinct banks. Boxes start 1024 bytes apart, the span the swizzle repeats over.
__host__ __device__ inline int n_boxes(int width) { return (width + 63) >> 6; }
__host__ __device__ inline size_t box_bytes(int K) { return (static_cast<size_t>(K) * 128 + 1023) & ~static_cast<size_t>(1023); }
__host__ __device__ inline size_t a1024(size_t x) { return (x + 1023) & ~static_cast<size_t>(1023); }

// Byte offsets into the dynamic shared memory of one block; the stage slots'
// fields are offsets inside a slot. With G groups of warps a block (each on
// its own sources), group g's two slots start at slot + 2 g slot_bytes and
// its scratch (u, lg, a, hv, bar) grp bytes after group 0's.
struct Layout {
  size_t w, bias, slot, slot_bytes, xt, xr, q, inv, u, lg, a, hv, bar, grp, box, total;
};

inline Layout make_layout(int K, int D, int R, int H, int groups = 1) {
  Layout L{};
  const int Rs = rpe_cols(R);
  const bool narrow = Rs != R;  // tgt in 2-D tensor copies' swizzled boxes, slots on 1024-byte bounds
  const size_t X = static_cast<size_t>(D) + Rs;
  size_t off = 0;
  L.w = off;    off += X * 2 * D * 2;
  L.bias = off; off += a16(static_cast<size_t>(D) * 2 * 2);
  L.xt = 0;
  L.box = box_bytes(K);  // narrow: one tgt box of 64 columns
  L.xr = narrow ? n_boxes(D) * L.box : a16(static_cast<size_t>(K) * D * 2);
  L.q = L.xr + a16(static_cast<size_t>(K) * Rs * 2);
  L.inv = L.q + a16(static_cast<size_t>(D) * 2);
  L.slot_bytes = L.inv + a16(static_cast<size_t>(K));
  if (narrow) {
    L.slot_bytes = a1024(L.slot_bytes);
    off = a1024(off);
  }
  L.slot = off; off += 2 * groups * L.slot_bytes;
  L.u = off;    off += a16(X * u_cols(H) * 2);
  L.lg = off;   off += a16(static_cast<size_t>(H) * K * 4);
  L.a = off;    off += static_cast<size_t>(16) * (pad16(K) + 8) * 2;
  L.hv = off;   off += a16(static_cast<size_t>(3) * H * 4);
  L.bar = off;  off += 2 * 8;  // one mbarrier per stage
  L.grp = off - L.u;
  off += (groups - 1) * L.grp;
  L.total = off + (narrow ? 1024 : 0);  // narrow: the slack to put the base on a 1024-byte bound
  return L;
}

// Groups of warps a block: two (8 warps each, each on its own sources with its own two stages, the resident
// weights shared) for the 4-wide rpe (K <= 256, refusal 7: a thread of the group a target) wherever they fit, with
// up to 4 heads (the softmax takes H warps of the group); else one (all 16 warps on one source). At the flagship's
// D = 128, R = 4, H = 4, K = 89 two groups take 204,704 B; at R = 128 the weights and four stages would need ~315 KB.
inline int group_count(int K, int D, int R, int H, size_t max_smem) {
  const bool two = R != rpe_cols(R) && H <= 4 && make_layout(K, D, R, H, 2).total <= max_smem;
  return two ? 2 : 1;
}

// XOR mask of a region with n_c 16-byte chunks per row: the largest power of two
// dividing n_c, at most 8, minus one, so that a swizzled chunk stays in its row
__host__ __device__ inline int swizzle_mask(int n_c) {
  const int p = n_c & -n_c;
  return (p < 8 ? p : 8) - 1;
}

// Why the kernel cannot take a shape (0 = it can); ops/knarpe.py::STAGED_REFUSALS words each code.
inline int refusal(int mode, int K, int D, int R, int H, size_t max_smem) {
  const int dh = D / H;
  if (K < 1 || K > kThreads) return 1;
  if (D % 16 || (R % 16 && R != 4)) return 2;
  if (R == 4 && K > 256) return 7;  // a tensor copy's box has at most 256 rows
  if (mode == 2) {  // B3's k projection: a warp on up to four 8-column tiles of whole heads
    const int nb = D / 8 < 4 ? D / 8 : 4;
    if (D % (8 * nb)) return 3;
    if (!(dh == 4 || (dh % 8 == 0 && (8 * nb) % dh == 0))) return 4;
  }
  if (make_layout(K, D, R, H).total > max_smem) return 5;
  return 0;
}

struct Params {
  const __nv_bfloat16 *q, *tgt, *rpe, *w_kv, *w_rpe, *bias;
  const uint8_t* invalid;
  __nv_bfloat16* out;
  int n_src, n_knn, d_model, d_rpe;  // d_rpe: rpe_cols(R), the staged width
  int r_in;  // R, the rpe columns in device memory: d_rpe, or 4 below its 16 staged ones
  int mt, mr, mw;  // rotation masks of the tgt and rpe rows, swizzle mask of the weight rows
  float scale;
  Layout L;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// the bulk copy engine (1-D TMA): bytes from global to shared memory, completion counted on an mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// the tensor copy (TMA) of the box at columns c0, row c1 of map into shared memory, counted on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
               ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// orders this thread's earlier generic-proxy accesses of shared memory before its later tensor copies
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// the one arrival of a phase, expecting `bytes` of bulk copies (which may land before or after it)
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred done;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link against libcuda); null if absent
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  });
  return fn;
}

// n_rows rows of `width` bf16 at base, ld elements apart, as a 2-D tensor whose boxes are 64 columns by
// box_rows rows, landing with the 128-byte swizzle (16-byte chunk c of box row j at chunk c ^ (j & 7));
// columns past width arrive as zeros. 0 or a CUDA error
inline int encode_rows(CUtensorMap* map, const void* base, long long n_rows, int width, long long ld, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
// (hi, lo) bf16 pairs of two float32 values: v ~ hi + lo to 16 significant bits
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
// d += a b: a 16 x 16 (row-major fragment), b 16 x 8 (column-major fragment), bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// where chunk c of a row of n_c chunks, rotated by rot, lies
__device__ __forceinline__ int rotated(int c, int rot, int n_c) { return c + rot < n_c ? c + rot : c + rot - n_c; }
// 16-byte chunk c (of X / 8) of target row j in a stage slot (of the forward's or the backward's Params)
template <class P>
__device__ __forceinline__ const uint4* x_chunk(const P& p, const unsigned char* slot, int j, int c) {
  const int ct = p.d_model >> 3;
  if (c < ct) return reinterpret_cast<const uint4*>(slot + p.L.xt) + j * ct + rotated(c, j & p.mt, ct);
  const int cr = p.d_rpe >> 3;
  return reinterpret_cast<const uint4*>(slot + p.L.xr) + j * cr + rotated(c - ct, j & p.mr, cr);
}
// 16-byte chunk c (of 2D / 8) of weight row i
template <class P>
__device__ __forceinline__ const uint4* w_chunk(const P& p, const unsigned char* smem, int i, int c) {
  const int cw = p.d_model >> 2;
  return reinterpret_cast<const uint4*>(smem + p.L.w) + i * cw + (c ^ (i & p.mw));
}

// cp.async of the resident [W_kv; W_rpe] (rows XOR-swizzled by p.mw) and the bias into shared memory, W_rpe's
// rows past r_in zero; the caller waits (cp_wait_all) and synchronises
template <class P>
__device__ __forceinline__ void load_weights(const P& p, unsigned char* smem, int tid) {
  const int D = p.d_model, X = D + p.d_rpe, cw = D >> 2;
  const uint32_t ws = smem_u32(smem + p.L.w);
  for (int e = tid; e < X * cw; e += kThreads) {
    const int i = e / cw, c = e - i * cw;
    if (i >= D + p.r_in) {
      *reinterpret_cast<uint4*>(smem + p.L.w + (static_cast<size_t>(i) * cw + c) * 16) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const __nv_bfloat16* row = i < D ? p.w_kv + static_cast<size_t>(i) * 2 * D : p.w_rpe + static_cast<size_t>(i - D) * 2 * D;
    cp_async16(ws + (i * cw + (c ^ (i & p.mw))) * 16, row + c * 8);
  }
  for (int c = tid; c < cw; c += kThreads) cp_async16(smem_u32(smem + p.L.bias) + c * 16, p.bias + c * 8);
}

// Pieces [e0, e1) of source s into a stage slot by bulk copies: pieces 2j, 2j + 1 are tgt row
// j, 2K + 2j, 2K + 2j + 1 rpe row j, 4K is q. A row lands rotated by j & mask chunks, so in two
// pieces (one when the rotation is 0). Worker w of n issues pieces e0 + w, e0 + w + n, ...; with
// `expect`, worker 0 also arrives on the stage's mbarrier, expecting all of the source's bytes.
__device__ __forceinline__ void stage_pieces(const Params& p, unsigned char* slot, uint32_t bar, int s, int e0, int e1,
                                             int w, int n, bool expect) {
  const int K = p.n_knn, D = p.d_model, R = p.d_rpe;
  if (expect && w == 0) mbar_expect(bar, static_cast<uint32_t>((K * (D + R) + D) * 2));
  for (int e = e0 + w; e < e1; e += n) {
    if (e == 4 * K) {
      bulk_copy(smem_u32(slot + p.L.q), p.q + static_cast<size_t>(s) * D, D * 2, bar);
      continue;
    }
    const bool is_t = e < 2 * K;
    const int j = (is_t ? e : e - 2 * K) >> 1, piece = e & 1, n_c = (is_t ? D : R) >> 3;
    const int rot = j & (is_t ? p.mt : p.mr);
    if (piece == 1 && rot == 0) continue;
    const char* src = reinterpret_cast<const char*>(is_t ? p.tgt + (static_cast<size_t>(s) * K + j) * D
                                                         : p.rpe + (static_cast<size_t>(s) * K + j) * R);
    const uint32_t row = smem_u32(slot + (is_t ? p.L.xt : p.L.xr)) + j * n_c * 16;
    // piece 0: chunks [0, n_c - rot) to [rot, n_c); piece 1: chunks [n_c - rot, n_c) to [0, rot)
    if (piece == 0) bulk_copy(row + rot * 16, src, (n_c - rot) * 16, bar);
    else bulk_copy(row, src + (n_c - rot) * 16, rot * 16, bar);
  }
}

// Narrow rpe (r_in = 4): source s's tgt into a stage slot by one 2-D tensor copy a box of 64 columns by K rows (tm:
// tgt [n_src K, D], boxes of 64 x K, 128-byte swizzle), and q by a bulk copy, issued by one thread, which also arrives
// on the stage's mbarrier expecting their bytes.
__device__ __forceinline__ void stage_tensor(const Params& p, const CUtensorMap* tm, unsigned char* slot, uint32_t bar,
                                             int s) {
  const int K = p.n_knn, D = p.d_model;
  mbar_expect(bar, static_cast<uint32_t>(n_boxes(D) * K * 128 + D * 2));
  for (int b = 0; b < n_boxes(D); ++b)
    tma_load_2d(smem_u32(slot + p.L.xt + b * p.L.box), tm, 64 * b, s * K, bar);
  bulk_copy(smem_u32(slot + p.L.q), p.q + static_cast<size_t>(s) * D, D * 2, bar);
}

// The narrow rpe rows of source s (r_in = 4 bf16, 8 bytes) into the first 8 bytes of their 32-byte rows of a stage
// slot, by 8-byte cp.async from thread j < K (the rows' other 24 bytes stay zero, set once); the issuing threads wait
// (cp_wait_all) before the barrier after which the slot is read.
__device__ __forceinline__ void stage_narrow_rpe(const Params& p, unsigned char* slot, int s, int tid) {
  if (tid < p.n_knn) {
    const size_t row = static_cast<size_t>(s) * p.n_knn + tid;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(slot + p.L.xr + tid * 32)),
                 "l"(p.rpe + row * 4) : "memory");
  }
}

// Sums the hi and lo halves of an mma result whose rows (COLS = false) or columns (COLS = true)
// hold [hi of heads 0..H-1 | lo of heads 0..H-1]: v is this lane's value at (row g | column 2tq + e),
// v8 its value 8 rows / one n-tile further. Returns hi + lo in the lanes that hold a hi entry.
template <int H, bool COLS>
__device__ __forceinline__ float hi_plus_lo(float v, float v8) {
  static_assert(!(COLS && H == 1), "H = 1 keeps hi and lo in one lane's two columns");
  if constexpr (H == 8) return v + v8;
  else return v + __shfl_xor_sync(0xffffffffu, v, COLS ? H / 2 : 4 * H);
}

// The barrier of one group of warps: the whole block's for one group, else named barrier 1 + grp over its threads.
template <int GROUPS>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (GROUPS == 1) __syncthreads();
  else asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(kThreads / GROUPS) : "memory");
}

// NARROW: the 4-wide rpe (r_in = 4, d_rpe = 16), tgt staged by tensor copies of tm_t, rpe by cp.async (see the
// header); else tm_t is not read.
template <int MODE, int H, int GROUPS, bool NARROW>
__global__ void __launch_bounds__(kThreads, 1) knarpe_x_staged_kernel(const Params p,
                                                                      const __grid_constant__ CUtensorMap tm_t) {
  static_assert(GROUPS == 1 || (NARROW && H <= 4), "two groups of 8 warps: the 4-wide rpe, up to 4 heads");
  constexpr int kGT = kThreads / GROUPS, kGW = kGT / 32;  // a group's threads and warps
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the tensor copies' 128-byte swizzle is a function of the shared address: narrow slots start on 1024 bytes
  unsigned char* smem = NARROW ? smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) : smem_raw;
  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = GROUPS == 1 ? 0 : tid / kGT, gtid = tid - grp * kGT, warp = gtid >> 5;  // group, its thread, warp
  const int g = lane >> 2, tq = lane & 3;  // an mma fragment's row group and column pair
  const int K = p.n_knn, D = p.d_model, R = p.d_rpe, X = D + R, dh = D / H;
  const int kp = pad16(K), lda = kp + 8, NU = u_cols(H);
  unsigned char* scratch = smem + grp * p.L.grp;  // this group's u, lg, a, hv and bar
  __nv_bfloat16* ub = reinterpret_cast<__nv_bfloat16*>(scratch + p.L.u);  // [U_hi | U_lo] [X][NU]
  __nv_bfloat16* yb = ub;  // later [Y_hi; Y_lo] [max(8, 2H)][X], chunks swizzled with the row
  const int my = swizzle_mask(X >> 3);
  float* lg = reinterpret_cast<float*>(scratch + p.L.lg);  // logits, then attn [h][j]
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(scratch + p.L.a);  // [A_hi; A_lo; 0] [16][lda]
  float* cvec = reinterpret_cast<float*>(scratch + p.L.hv);
  float* asum = cvec + H;
  float* nvh = cvec + 2 * H;
  const __nv_bfloat16* bias = reinterpret_cast<const __nv_bfloat16*>(smem + p.L.bias);  // [b_k | b_v]
  unsigned char* slot0 = smem + p.L.slot + grp * 2 * p.L.slot_bytes;  // this group's two slots
  const uint32_t bar0 = smem_u32(scratch + p.L.bar);

  load_weights(p, smem, tid);  // resident [W_kv; W_rpe] (swizzled) and bias
  // rows 2H.. of [A_hi; A_lo] and its columns K.. stay zero: the softmax writes only the rest
  for (int e = gtid; e < 16 * lda; e += kGT) ab[e] = __float2bfloat16_rn(0.f);
  int s = blockIdx.x * GROUPS + grp;
  // this source's 16-byte chunk c (of X / 8) of target row j in a slot, as a shared address
  auto x_at = [&](const unsigned char* slot, int j, int c) -> uint32_t {
    if constexpr (NARROW) {  // tgt in its swizzled boxes, rpe in 32-byte rows
      const int ct = D >> 3;
      return c < ct ? smem_u32(slot + p.L.xt + (c >> 3) * p.L.box + j * 128 + (((c & 7) ^ (j & 7)) << 4))
                    : smem_u32(slot + p.L.xr + j * 32 + (c - ct) * 16);
    } else {
      return smem_u32(x_chunk(p, slot, j, c));
    }
  };
  if constexpr (NARROW) {  // bytes 8-31 of every narrow rpe row of both slots stay zero; the first source's come in
    for (int e = gtid; e < 2 * K; e += kGT) {
      unsigned char* row = slot0 + (e / K) * p.L.slot_bytes + p.L.xr + (e % K) * 32;
      *reinterpret_cast<uint2*>(row + 8) = make_uint2(0u, 0u);
      *reinterpret_cast<uint4*>(row + 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (s < p.n_src) stage_narrow_rpe(p, slot0, s, gtid);
  }
  if (gtid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_wait_all();
  __syncthreads();
  if (s < p.n_src) {
    if constexpr (NARROW) {
      if (gtid == 0) stage_tensor(p, &tm_t, slot0, bar0, s);
    } else {
      stage_pieces(p, slot0, bar0, s, 0, 4 * K + 1, gtid, kGT, true);
    }
    if (gtid < K) slot0[p.L.inv + gtid] = p.invalid[static_cast<size_t>(s) * K + gtid];
  }

  for (int it = 0; s < p.n_src; s += gridDim.x * GROUPS, ++it) {
    const int b = it & 1;
    const unsigned char* cur = slot0 + b * p.L.slot_bytes;
    unsigned char* nxt = slot0 + (b ^ 1) * p.L.slot_bytes;
    const int sn = s + gridDim.x * GROUPS;
    const uint32_t bar_next = bar0 + 8 * (b ^ 1);
    // the next source streams in while this one is computed, its copies issued by warps that have
    // no item in the logits step (tgt rows) and in the softmax (the rest)
    const int busy = MODE == 1 ? min(kp / 16, kGW) : kGW;
    const int rest = busy < kGW ? 2 * K : 0;
    uint8_t inv_next = 0;
    if (sn < p.n_src && gtid < K) inv_next = p.invalid[static_cast<size_t>(sn) * K + gtid];
    if (NARROW && sn < p.n_src) {  // the next source's copies go out at once: its slot was read last source
      if (gtid == 0) {
        fence_proxy_async();
        stage_tensor(p, &tm_t, nxt, bar_next, sn);
      }
      stage_narrow_rpe(p, nxt, sn, gtid);  // waited for at the source's last barrier
    }
    mbar_wait(bar0 + 8 * b, (it >> 1) & 1);  // this stage's (it / 2)-th fill has landed
    const uint8_t* inv = cur + p.L.inv;
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(cur + p.L.q);
    const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qb);

    if (MODE == 1) {
      // u[i][h] = W_k[i, h-block] . q_h: a warp per 16 rows of W_k; B = Q, Q[d][h] = q[d] if d is in
      // head h, built in registers; u split into [U_hi | U_lo]. c[h] = b_k[h-block] . q_h
      const int g0 = g * dh;  // head g's first column
      for (int mt = warp; mt < X / 16; mt += kGW) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, smem_u32(w_chunk(p, smem, 16 * mt + (lane & 15), 2 * ks + (lane >> 4))));
          const int d0 = 16 * ks + 2 * tq;  // Q's rows d0, d0 + 1 and d0 + 8, d0 + 9 of column g
          const uint32_t b0 = d0 >= g0 && d0 < g0 + dh ? q2[d0 >> 1] : 0u;
          const uint32_t b1 = d0 + 8 >= g0 && d0 + 8 < g0 + dh ? q2[(d0 + 8) >> 1] : 0u;
          mma_bf16(acc, a, b0, b1);
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 16 * mt + g + 8 * hr, h = 2 * tq;
          if (h < H) {
            uint32_t hi, lo;
            split2(acc[2 * hr], acc[2 * hr + 1], hi, lo);
            if (h + 1 < H) {
              *reinterpret_cast<uint32_t*>(ub + i * NU + h) = hi;
              *reinterpret_cast<uint32_t*>(ub + i * NU + H + h) = lo;
            } else {  // H == 1
              ub[i * NU + h] = __ushort_as_bfloat16(static_cast<unsigned short>(hi & 0xffffu));
              ub[i * NU + H + h] = __ushort_as_bfloat16(static_cast<unsigned short>(lo & 0xffffu));
            }
          }
        }
      }
      if (warp < H) {
        float acc = 0.f;
        for (int d = lane; d < dh; d += 32) acc += __bfloat162float(bias[warp * dh + d]) * __bfloat162float(qb[warp * dh + d]);
        acc = warp_sum(acc);
        if (lane == 0) cvec[warp] = acc;
      }
      group_sync<GROUPS>(grp);
      if (!NARROW && sn < p.n_src && warp >= busy)
        stage_pieces(p, nxt, bar_next, sn, 0, rest, gtid - 32 * busy, kGT - 32 * busy, true);
      // logits[j][h] = x_j . u_h + c_h: a warp per 16 targets, A = the staged rows, B = [U_hi | U_lo]
      for (int mt = warp; mt < kp / 16; mt += kGW) {
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const int arow = min(16 * mt + (lane & 15), K - 1);
        // H <= 4: two chains of sums, even and odd k steps, to keep two mma in flight
        auto k_step = [&](int ks, float (&c0)[4], float (&c1)[4]) {
          uint32_t a[4];
          ldsm_x4(a, x_at(cur, arow, 2 * ks + (lane >> 4)));
          const uint32_t baddr = smem_u32(ub + (16 * ks + (lane & 15)) * NU + 8 * (lane >> 4));
          if (NU == 16) {
            uint32_t b[4];
            ldsm_x4_t(b, baddr);
            mma_bf16(c0, a, b[0], b[1]);
            mma_bf16(c1, a, b[2], b[3]);
          } else {
            uint32_t b[2];
            ldsm_x2_t(b, baddr);
            mma_bf16(c0, a, b[0], b[1]);
          }
        };
        for (int ks = 0; ks < X / 16; ks += 2) {
          k_step(ks, acc[0], acc[1]);
          if (ks + 1 < X / 16) {
            if (NU == 16) k_step(ks + 1, acc[0], acc[1]);
            else k_step(ks + 1, acc[1], acc[0]);
          }
        }
        if (NU == 8)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][e] += acc[1][e];
        // column h = 2tq + e holds hi, column H + h lo
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * mt + g + 8 * hr;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[0][2 * hr + e];
            float sum;
            if constexpr (H == 1) sum = e == 0 ? v + acc[0][2 * hr + 1] : 0.f;
            else sum = hi_plus_lo<H, true>(v, acc[1][2 * hr + e]);
            const int h = 2 * tq + e;
            if (h < H && row < K) lg[h * K + row] = (sum + cvec[h]) * p.scale;
          }
        }
      }
    } else {
      // B3: kk = x @ W_k on the tensor cores; a warp per (16 targets, nb x 8 columns) item
      const int nb = D / 8 < 4 ? D / 8 : 4, nblk = D / (8 * nb), n_items = nblk * (kp / 16);
      for (int item = warp; item < n_items; item += kGW) {
        const int m0 = (item / nblk) * 16, n0 = (item % nblk) * 8 * nb;
        float acc[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
        const int arow = min(m0 + (lane & 15), K - 1);
        for (int ks = 0; ks < X / 16; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, x_at(cur, arow, 2 * ks + (lane >> 4)));
          const int brow = 16 * ks + (lane & 15);
#pragma unroll
          for (int t = 0; t < 4; t += 2) {
            if (t >= nb) break;
            if (t + 1 < nb) {
              uint32_t b[4];
              ldsm_x4_t(b, smem_u32(w_chunk(p, smem, brow, n0 / 8 + t + (lane >> 4))));
              mma_bf16(acc[t], a, b[0], b[1]);
              mma_bf16(acc[t + 1], a, b[2], b[3]);
            } else {
              uint32_t b[2];
              ldsm_x2_t(b, smem_u32(w_chunk(p, smem, brow, n0 / 8 + t)));
              mma_bf16(acc[t], a, b[0], b[1]);
            }
          }
        }
        // + b_k, round kk, round q * kk, sum per head in float32 (as _x3_fwd_kernel)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + g + 8 * hr;
          float ps[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            ps[t] = 0.f;
            if (t < nb) {
              const int col = n0 + 8 * t + 2 * tq;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float kk = round_bf16(acc[t][2 * hr + e] + __bfloat162float(bias[col + e]));
                ps[t] += round_bf16(__bfloat162float(qb[col + e]) * kk);
              }
            }
            ps[t] += __shfl_xor_sync(0xffffffffu, ps[t], 1);
          }
          if (dh == 4) {  // lanes 2m and 2m + 1 of a column tile hold one head
#pragma unroll
            for (int t = 0; t < 4; ++t)
              if (t < nb && !(tq & 1) && row < K) lg[((n0 + 8 * t + 2 * tq) / 4) * K + row] = ps[t] * p.scale;
          } else {  // a column tile lies in one head, a head spans dh / 8 tiles
#pragma unroll
            for (int t = 0; t < 4; ++t) ps[t] += __shfl_xor_sync(0xffffffffu, ps[t], 2);
            const int tph = dh / 8;
            for (int t0 = 0; t0 < nb; t0 += tph) {
              float tot = 0.f;
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (t >= t0 && t < t0 + tph) tot += ps[t];
              if (tq == 0 && row < K) lg[((n0 + 8 * t0) / dh) * K + row] = tot * p.scale;
            }
          }
        }
      }
    }
    group_sync<GROUPS>(grp);

    // masked softmax over K, one warp per head (as pallas_knarpe.py:_fwd_core); attn also as
    // rows h (hi) and H + h (lo) of A
    if (!NARROW && sn < p.n_src && warp >= H)
      stage_pieces(p, nxt, bar_next, sn, rest, 4 * K + 1, gtid - 32 * H, kGT - 32 * H, rest == 0);
    if (warp < H) {
      float* lh = lg + warp * K;
      float m = -INFINITY;
      for (int j = lane; j < K; j += 32) m = fmaxf(m, inv[j] ? kMask : lh[j]);
      m = warp_max(m);
      float den = 0.f;
      for (int j = lane; j < K; j += 32) {
        const float e = inv[j] ? 0.f : expf(lh[j] - m);
        lh[j] = e;
        den += e;
      }
      den = warp_sum(den);
      const bool no_valid = den <= 0.f;
      const float rden = no_valid ? 1.f : 1.f / den;
      float as = 0.f;
      for (int j = lane; j < K; j += 32) {
        const float a = lh[j] * rden;
        const __nv_bfloat16 hi = __float2bfloat16_rn(a);
        lh[j] = a;
        ab[warp * lda + j] = hi;
        ab[(H + warp) * lda + j] = __float2bfloat16_rn(a - __bfloat162float(hi));
        as += a;
      }
      as = warp_sum(as);
      if (lane == 0) {
        asum[warp] = as;
        nvh[warp] = no_valid ? 1.f : 0.f;
      }
    }
    group_sync<GROUPS>(grp);

    // y[h][i] = sum_j attn[h][j] x_j[i]: a warp per 16 inputs, A = [A_hi; A_lo], B = the staged rows
    for (int np = warp; np < X / 16; np += kGW) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < kp / 16; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, smem_u32(ab + (lane & 15) * lda + 16 * ks + 8 * (lane >> 4)));
        ldsm_x4_t(b, x_at(cur, min(16 * ks + (lane & 15), K - 1), 2 * np + (lane >> 4)));
        mma_bf16(acc[0], a, b[0], b[1]);
        mma_bf16(acc[1], a, b[2], b[3]);
      }
      // row h holds hi, row H + h lo (rows 8.. for H = 8); y goes on as [Y_hi; Y_lo], the same split
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float v0 = hi_plus_lo<H, false>(acc[t][0], acc[t][2]);
        const float v1 = hi_plus_lo<H, false>(acc[t][1], acc[t][3]);
        if (g < H) {
          uint32_t hi, lo;
          split2(v0, v1, hi, lo);
          const int c = 2 * np + t;
          *reinterpret_cast<uint32_t*>(yb + g * X + 8 * (c ^ (g & my)) + 2 * tq) = hi;
          *reinterpret_cast<uint32_t*>(yb + (H + g) * X + 8 * (c ^ ((H + g) & my)) + 2 * tq) = lo;
        }
      }
    }
    group_sync<GROUPS>(grp);

    // out[d] = y_h(d) . W_v[:, d] + b_v[d] sum_j attn_hj: a warp per 8 columns, A = [Y_hi; Y_lo],
    // B = W_v; of the result, the rows of head h(d) are kept
    for (int nt = warp; nt < D / 8; nt += kGW) {
      float acc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // even and odd k steps
      auto k_step = [&](int ks, float (&sum)[4]) {
        uint32_t a[4];
        if constexpr (H == 8) {
          const int r = lane & 15, c = 2 * ks + (lane >> 4);
          ldsm_x4(a, smem_u32(yb + r * X + 8 * (c ^ (r & my))));
        } else {  // rows 8.. are zero: rows 0-7 at k 0-7 and 8-15
          const int r = lane & 7, c = 2 * ks + ((lane >> 3) & 1);
          uint32_t a2[2];
          ldsm_x2(a2, smem_u32(yb + r * X + 8 * (c ^ (r & my))));
          a[0] = a2[0]; a[1] = 0u; a[2] = a2[1]; a[3] = 0u;
        }
        uint32_t b[2];
        ldsm_x2_t(b, smem_u32(w_chunk(p, smem, 16 * ks + (lane & 15), D / 8 + nt)));
        mma_bf16(sum, a, b[0], b[1]);
      };
      for (int ks = 0; ks < X / 16; ks += 2) {
        k_step(ks, acc2[0]);
        if (ks + 1 < X / 16) k_step(ks + 1, acc2[1]);
      }
      float acc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = acc2[0][e] + acc2[1][e];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = hi_plus_lo<H, false>(acc[e], acc[2 + e]);
        const int d = 8 * nt + 2 * tq + e, h = d / dh;
        if (g == h) {
          const float o = v + __bfloat162float(bias[D + d]) * asum[h];
          p.out[static_cast<size_t>(s) * D + d] = __float2bfloat16_rn(nvh[h] != 0.f ? 0.f : o);
        }
      }
    }
    if (sn < p.n_src && gtid < K) nxt[p.L.inv + gtid] = inv_next;
    if (NARROW) cp_wait_all();
    group_sync<GROUPS>(grp);
  }
}

}  // namespace staged
