// Fused KNARPE attention forwards for Hopper (sm_90a): B4, B2 and B3.
//
// Replaces the forward Pallas kernels of trafficbotsv15_tpu/ops/pallas_knarpe.py:
//   mode 0, B4: knarpe_attention            (_fwd_kernel)
//       logits = q.(k + rpe_k)/sqrt(dh), rpe_kv = rpe @ W_rpe + b, out = sum attn (v + rpe_v)
//   mode 1, B2: knarpe_cross_attention      (_x_fwd_kernel)
//       kv = [tgt | rpe] @ [W_kv; W_rpe] + b, then B4's attention core
//   mode 2, B3: knarpe_cross_attention_v3   (_x3_fwd_kernel)
//       B2 with the k half rounded to the operand type T before q.k, and q*k rounded to T
// Masked softmax over the K targets per head, mask -1e9, float32 inside; a
// source with no valid target gets a zero output. T is float or bf16; the
// plain versions are ops/knarpe.py::*_reference.
//
// What bounds them on this card: the bytes. At the rollout's shape (B2:
// 8192 sources x K=89 targets x [tgt 128 | rpe 128] bf16) a launch must read
// ~373 MB and write 2 MB, 0.11 ms at 3.35 TB/s; the [K, 2D] projection is
// 95.6 GFLOP as a matrix product, ~0.1 ms even on the tensor cores. The
// Pallas kernels exist to keep that [K, 2D] projection out of HBM. Here it is
// never formed at all: the projection is linear, so it is reassociated with
// the attention per source and head h (dh = D/H, x_j = [tgt_j | rpe_j]):
//   q_h . k_jh = x_j . u_h + c_h,     u_h = W_k[:, h] q_h,  c_h = b_k[h] . q_h
//   out_h      = y_h W_v[:, h] + b_v[h] sum_j a_hj,        y_h = sum_j a_hj x_j
// which is 2 X D + 2 K X H multiply-adds per source instead of 2 K X 2D:
// ~250 K instead of ~5.8 M at the flagship (B4 adds the direct q.k and
// sum a v terms). That fits the CUDA cores with room to spare, so the kernel
// can stay a plain float32 FMA loop and still be limited by its loads:
//   - one persistent block per SM slot walks over sources; the weights
//     [W_kv; W_rpe] are staged once per block in shared memory (rows padded
//     to an odd word count so that a warp reading a column is free of bank
//     conflicts); when they do not fit (float32 B2, bf16 B2/B3 at
//     D = R = 256) they are read through L1/L2 instead;
//   - x_j is read straight from device memory twice per source (logits, then
//     y); while a source is computed, the block prefetches its next source's
//     inputs into L2, so the second read and the next source's first read
//     hit L2.
// B3 keeps the explicit k half (its roundings need kk itself): K x D dot
// products of length X per source, ~2.9 M multiply-adds per source. Only a
// script reaches B3 in the JAX package.
//
// Routes. bf16 B4 runs on the staged kernel of knarpe_attn_staged.cuh (a ring
// of source stages filled by tensor copies, four groups of warps each on its
// own source, every product on the tensor cores) wherever it takes the shape
// (knarpe_staged_route's code 0 in mode 0: up to 4 heads, D and R multiples
// of 16, K up to 128, four stages within the block's shared memory); at the
// scaled preset's D = R = 256 with 8 heads (K <= 40) on the heads kernel of
// knarpe_attn_heads.cuh (four blocks a source, each on two heads with its
// quarter of W_rpe, no exchange between them; knarpe_attn_heads_route's code
// 0); and on the kernel below otherwise. bf16 B2 and B3 run on the staged kernel of knarpe_staged.cuh (each
// source's targets copied into shared memory while the previous one is
// computed; every product on the tensor cores), whose header says how, for
// every shape it takes (knarpe_staged_route's code 0), the 4-wide RPE of
// pose_rpe "xy_dir" (d_rpe = 4) among them, zero-padded to 16 columns in
// shared memory. It keeps the whole bf16
// [W_kv; W_rpe] resident, so it refuses D = R = 256 (the scaled preset) and, at
// D = R = 128, K >= 90. bf16 B2 at D = R = 256 with 8 heads (K <= 104) runs on
// the cluster kernel of knarpe_cluster.cuh (four blocks a source, each with a
// quarter of the weights and of the source's columns; knarpe_cluster_route's
// code 0); bf16 B3 at D = R = 256 with 8 heads (any K) on the heads kernel of
// knarpe_v3_heads.cuh (four blocks a source, each on two heads with its quarter
// of the weights, the targets streamed in tiles of 32 with the softmax taken
// online; knarpe_v3_heads_route's code 0); B2 and B3 at the shapes these
// refuse (D = R = 128 at K >= 90 among them), run on the kernel below,
// instantiated for bf16 too (the general route; knarpe_general_route says
// whether it takes a shape). The route follows from the shape alone. The kernel below serves
// float32 B4, B2 and B3, and the general bf16 route. Its B3 accumulates 4 x 4 tiles of
// kk (4 targets x 4 columns of one head) in registers from the source's [K, X]
// inputs, staged in shared memory where they fit (float32 at D = R = 256, K = 89
// does not: then they are read from device memory): tensor cores would compute
// float32 in TF32, outside float32's tolerance.

#include "knarpe_attn_heads.cuh"
#include "knarpe_attn_staged.cuh"
#include "knarpe_cluster.cuh"
#include "knarpe_staged.cuh"
#include "knarpe_v3_heads.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
using staged::a16;
using staged::kMask;
using staged::warp_max;
using staged::warp_sum;
enum Mode { kAttn = 0, kCross = 1, kCrossV3 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ void prefetch_l2(const void* ptr, size_t bytes, int tid) {
  const char* c = static_cast<const char*>(ptr);
  for (size_t off = static_cast<size_t>(tid) * 128; off < bytes; off += static_cast<size_t>(kThreads) * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

// Byte offsets into the dynamic shared memory of one block.
struct Layout {
  size_t w, qs, inv, u, c, asum, nv, lg, ypart, opart, xs, kpart, total;
  int py, po;  // partial sums per output element in the y and out steps
};

Layout make_layout(int mode, size_t elem, int K, int D, int X, int H, int resident, int ldw, int stage_x) {
  Layout L{};
  size_t off = 0;
  L.w = off;
  off += resident ? a16(static_cast<size_t>(X) * ldw * elem) : 0;
  L.qs = off;   off += a16(static_cast<size_t>(D) * 4);
  L.inv = off;  off += a16(static_cast<size_t>(K));
  L.u = off;    off += a16(static_cast<size_t>(H) * X * 4);
  L.c = off;    off += a16(static_cast<size_t>(H) * 4);
  L.asum = off; off += a16(static_cast<size_t>(H) * 4);
  L.nv = off;   off += a16(static_cast<size_t>(H) * 4);
  L.lg = off;   off += a16(static_cast<size_t>(H) * K * 4);
  L.py = X < kThreads ? kThreads / X : 1;
  L.ypart = off; off += a16(static_cast<size_t>(L.py) * H * X * 4);
  L.po = D < kThreads ? kThreads / D : 1;
  L.opart = off; off += a16(static_cast<size_t>(L.po) * D * 4);
  L.xs = off;  // B3: the source's inputs [K, X] (when staged), then per-tile partial logits [K, D / 4]
  if (mode == kCrossV3 && stage_x) off += a16(static_cast<size_t>(K) * X * elem);
  L.kpart = off;
  if (mode == kCrossV3) off += a16(static_cast<size_t>(K) * (D / 4) * 4);
  L.total = off;
  return L;
}

struct Params {
  const void* q;
  const void* k;  // B4 only: rows of D at stride ld_kv
  const void* v;
  long long ld_kv;
  const void* tgt;  // B2/B3 only: [n_src * K, D]
  const void* rpe;  // [n_src * K, R]
  const uint8_t* invalid;  // [n_src, K]
  const void* w_kv;   // B2/B3 only: [D, 2D]
  const void* w_rpe;  // [R, 2D]
  const void* bias;   // [2D]
  void* out;          // [n_src, D]
  int n_src, n_knn, d_model, d_tgt, d_rpe;
  float scale;
  int resident;  // weights staged in shared memory (rows of ldw elements)
  int ldw;
  int stage_x;  // B3: the source's inputs staged in shared memory, else read from device memory
  Layout L;
};

template <typename T, int MODE, int H>
__global__ void __launch_bounds__(kThreads) knarpe_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.n_knn, D = p.d_model, Xt = p.d_tgt, R = p.d_rpe, X = Xt + R, D2 = 2 * D;
  const int dh = D / H;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const T* tgt = static_cast<const T*>(p.tgt);
  const T* rpe = static_cast<const T*>(p.rpe);
  const T* wg_t = static_cast<const T*>(p.w_kv);
  const T* wg_r = static_cast<const T*>(p.w_rpe);
  const T* bias = static_cast<const T*>(p.bias);
  T* outp = static_cast<T*>(p.out);

  T* w_s = reinterpret_cast<T*>(smem + p.L.w);
  float* qs = reinterpret_cast<float*>(smem + p.L.qs);
  uint8_t* inv = smem + p.L.inv;
  float* u = reinterpret_cast<float*>(smem + p.L.u);  // u[h][i]; later y[h][i]
  float* cvec = reinterpret_cast<float*>(smem + p.L.c);
  float* asum = reinterpret_cast<float*>(smem + p.L.asum);
  float* nvh = reinterpret_cast<float*>(smem + p.L.nv);
  float* lg = reinterpret_cast<float*>(smem + p.L.lg);  // logits, then attn [h][j]
  float* ypart = reinterpret_cast<float*>(smem + p.L.ypart);
  float* opart = reinterpret_cast<float*>(smem + p.L.opart);
  T* xs = reinterpret_cast<T*>(smem + p.L.xs);
  float* kpart = reinterpret_cast<float*>(smem + p.L.kpart);  // B3 only

  // row i of [W_kv; W_rpe] (or of W_rpe alone for B4, where Xt == 0): k half at
  // columns [0, D), v half at [D, 2D)
  auto wrow = [&](int i) -> const T* {
    if (p.resident) return w_s + static_cast<size_t>(i) * p.ldw;
    return i < Xt ? wg_t + static_cast<size_t>(i) * D2 : wg_r + static_cast<size_t>(i - Xt) * D2;
  };
  if (p.resident) {
    for (int e = tid; e < X * D2; e += kThreads) {
      const int row = e / D2, col = e - row * D2;
      w_s[static_cast<size_t>(row) * p.ldw + col] =
          row < Xt ? wg_t[static_cast<size_t>(row) * D2 + col] : wg_r[static_cast<size_t>(row - Xt) * D2 + col];
    }
  }

  for (int s = blockIdx.x; s < p.n_src; s += gridDim.x) {
    const size_t row0 = static_cast<size_t>(s) * K;  // first target row of this source
    const int sn = s + gridDim.x;
    if (sn < p.n_src) {  // the block's next source, into L2 while this one is computed
      const size_t rn = static_cast<size_t>(sn) * K;
      prefetch_l2(rpe + rn * R, static_cast<size_t>(K) * R * sizeof(T), tid);
      if (MODE == kAttn) {
        const size_t span = (static_cast<size_t>(K - 1) * p.ld_kv + D) * sizeof(T);
        prefetch_l2(kp + rn * p.ld_kv, span, tid);
        prefetch_l2(vp + rn * p.ld_kv, span, tid);
      } else {
        prefetch_l2(tgt + rn * Xt, static_cast<size_t>(K) * Xt * sizeof(T), tid);
      }
    }
    const T* xt = MODE == kAttn ? nullptr : tgt + row0 * Xt;
    const T* xr = rpe + row0 * R;
    for (int d = tid; d < D; d += kThreads) qs[d] = to_f(q[static_cast<size_t>(s) * D + d]);
    for (int j = tid; j < K; j += kThreads) inv[j] = p.invalid[row0 + j];
    __syncthreads();

    if (MODE != kCrossV3) {
      // u[h][i] = W_k[i, h-block] . q_h; c[h] = b_k[h-block] . q_h
      for (int e = tid; e < H * X; e += kThreads) {
        const int h = e / X, i = e - h * X;
        const T* wr = wrow(i) + h * dh;
        const float* qh = qs + h * dh;
        float acc = 0.f;
        for (int d = 0; d < dh; ++d) acc += to_f(wr[d]) * qh[d];
        u[e] = acc;
      }
      if (warp < H) {
        float acc = 0.f;
        for (int d = lane; d < dh; d += 32) acc += to_f(bias[warp * dh + d]) * qs[warp * dh + d];
        acc = warp_sum(acc);
        if (lane == 0) cvec[warp] = acc;
      }
      __syncthreads();
      // logits: one warp per target, lanes over the input features
      for (int j = warp; j < K; j += kWarps) {
        float part[H];
#pragma unroll
        for (int h = 0; h < H; ++h) part[h] = 0.f;
        if (MODE != kAttn) {
          const T* xj = xt + static_cast<size_t>(j) * Xt;
          for (int i = lane; i < Xt; i += 32) {
            const float x = to_f(xj[i]);
#pragma unroll
            for (int h = 0; h < H; ++h) part[h] += x * u[h * X + i];
          }
        }
        const T* rj = xr + static_cast<size_t>(j) * R;
        for (int i = lane; i < R; i += 32) {
          const float x = to_f(rj[i]);
#pragma unroll
          for (int h = 0; h < H; ++h) part[h] += x * u[h * X + Xt + i];
        }
        if (MODE == kAttn) {
          const T* kj = kp + (row0 + j) * p.ld_kv;
          for (int d = lane; d < D; d += 32) {
            const float kq = to_f(kj[d]) * qs[d];
            const int hd = d / dh;
#pragma unroll
            for (int h = 0; h < H; ++h)
              if (hd == h) part[h] += kq;
          }
        }
#pragma unroll
        for (int h = 0; h < H; ++h) part[h] = warp_sum(part[h]);
        if (lane == 0) {
#pragma unroll
          for (int h = 0; h < H; ++h) lg[h * K + j] = (part[h] + cvec[h]) * p.scale;
        }
      }
    } else {
      // B3: kk[j][d] rounded to T, then q*kk rounded to T, summed per head in float32
      if (p.stage_x) {
        for (int e = tid; e < K * X; e += kThreads) {
          const int j = e / X, i = e - j * X;
          xs[e] = i < Xt ? xt[static_cast<size_t>(j) * Xt + i] : xr[static_cast<size_t>(j) * R + (i - Xt)];
        }
      }
      __syncthreads();
      const int n_dt = D / 4, n_jt = (K + 3) / 4;  // 4 x 4 tiles; dh % 4 == 0, so a tile stays in one head
      for (int t = tid; t < n_jt * n_dt; t += kThreads) {
        const int jt = t / n_dt, dt = t - jt * n_dt, d0 = 4 * dt;
        // the tile's 4 targets (the last one repeated past K): their tgt and rpe rows, staged or not
        const T* bt[4];
        const T* br[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const size_t j = static_cast<size_t>(min(4 * jt + r, K - 1));
          bt[r] = p.stage_x ? xs + j * X : xt + j * Xt;
          br[r] = p.stage_x ? xs + j * X + Xt : xr + j * R;
        }
        // tgt @ W_kv and rpe @ W_rpe summed apart, then added, in _x3_fwd_kernel's order
        float acc_t[4][4] = {}, acc[4][4] = {};
        auto mac = [&](const T* const* base, int i, int wi, float (&a)[4][4]) {
          const T* wr = wrow(wi) + d0;
          float w[4], x[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) w[c] = to_f(wr[c]);
#pragma unroll
          for (int r = 0; r < 4; ++r) x[r] = to_f(base[r][i]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) a[r][c] += x[r] * w[c];
        };
        for (int i = 0; i < Xt; ++i) mac(bt, i, i, acc_t);
        for (int i = 0; i < R; ++i) mac(br, i, Xt + i, acc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * jt + r;
          if (j >= K) break;
          float ps = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float kk = round_to<T>((acc_t[r][c] + acc[r][c]) + to_f(bias[d0 + c]));
            ps += round_to<T>(qs[d0 + c] * kk);
          }
          kpart[j * n_dt + dt] = ps;
        }
      }
      __syncthreads();
      const int tiles_per_head = dh / 4;
      for (int e = tid; e < H * K; e += kThreads) {
        const int h = e / K, j = e - h * K;
        float acc = 0.f;
        for (int dt = h * tiles_per_head; dt < (h + 1) * tiles_per_head; ++dt) acc += kpart[j * n_dt + dt];
        lg[e] = acc * p.scale;
      }
    }
    __syncthreads();

    // masked softmax over K, one warp per head (as pallas_knarpe.py:_fwd_core)
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
      if (no_valid) den = 1.f;
      float as = 0.f;
      for (int j = lane; j < K; j += 32) {
        const float a = lh[j] / den;
        lh[j] = a;
        as += a;
      }
      as = warp_sum(as);
      if (lane == 0) {
        asum[warp] = as;
        nvh[warp] = no_valid ? 1.f : 0.f;
      }
    }
    __syncthreads();

    // y[h][i] = sum_j attn[h][j] x_j[i], in py partial sums over j
    for (int e = tid; e < X * p.L.py; e += kThreads) {
      const int part = e / X, i = e - part * X;
      const T* base = i < Xt ? xt + i : xr + (i - Xt);
      const size_t stride = i < Xt ? Xt : R;
      float acc[H];
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = 0.f;
      for (int j = part; j < K; j += p.L.py) {
        const float x = to_f(base[static_cast<size_t>(j) * stride]);
#pragma unroll
        for (int h = 0; h < H; ++h) acc[h] += lg[h * K + j] * x;
      }
#pragma unroll
      for (int h = 0; h < H; ++h) ypart[(part * H + h) * X + i] = acc[h];
    }
    __syncthreads();
    for (int e = tid; e < H * X; e += kThreads) {
      const int h = e / X, i = e - h * X;
      float acc = 0.f;
      for (int part = 0; part < p.L.py; ++part) acc += ypart[(part * H + h) * X + i];
      u[e] = acc;
    }
    __syncthreads();

    // out[d] = y_h . W_v[:, d] (+ sum_j attn v_j[d] for B4), in po partial sums
    {
      const int xc = (X + p.L.po - 1) / p.L.po, kc = (K + p.L.po - 1) / p.L.po;
      for (int e = tid; e < D * p.L.po; e += kThreads) {
        const int part = e / D, d = e - part * D, h = d / dh;
        float acc = 0.f;
        const int i1 = min(X, (part + 1) * xc);
        for (int i = part * xc; i < i1; ++i) acc += u[h * X + i] * to_f(wrow(i)[D + d]);
        if (MODE == kAttn) {
          const int j1 = min(K, (part + 1) * kc);
          for (int j = part * kc; j < j1; ++j) acc += lg[h * K + j] * to_f(vp[(row0 + j) * p.ld_kv + d]);
        }
        opart[part * D + d] = acc;
      }
      __syncthreads();
      for (int d = tid; d < D; d += kThreads) {
        const int h = d / dh;
        float o = 0.f;
        for (int part = 0; part < p.L.po; ++part) o += opart[part * D + d];
        o += to_f(bias[D + d]) * asum[h];
        outp[static_cast<size_t>(s) * D + d] = from_f<T>(nvh[h] != 0.f ? 0.f : o);
      }
      __syncthreads();
    }
  }
}

// What a launch of one instantiation needs besides its pointers, worked out
// once per (device, K, D, X): the rollout launches B2 360 times per call at one
// shape, and the attribute and occupancy queries would cost host time on each.
struct Plan {
  int dev, n_knn, d_model, x;
  int refused;  // 1: the layout exceeds the block's shared memory even with the weights read through L1/L2
  int ldw, resident, stage_x;
  Layout L;
  long long slots;  // resident blocks on the whole device
};

template <typename T, int MODE, int H>
int make_plan(Plan& pl) {
  // padded smem row: an odd number of 32-bit words, so a warp reading one column is conflict-free
  pl.ldw = 2 * pl.d_model;
  if ((pl.ldw * sizeof(T) / 4) % 2 == 0) pl.ldw += static_cast<int>(4 / sizeof(T));
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the first layout that fits: weights resident, then the weights read through L1/L2, then (B3)
  // the source's inputs read from device memory too
  const int tries[3][2] = {{1, 1}, {0, 1}, {0, 0}};  // {resident, stage_x}
  pl.refused = 1;
  for (const auto& t : tries) {
    pl.resident = t[0];
    pl.stage_x = t[1];
    pl.L = make_layout(MODE, sizeof(T), pl.n_knn, pl.d_model, pl.x, H, pl.resident, pl.ldw, pl.stage_x);
    if (pl.L.total <= static_cast<size_t>(max_smem)) {
      pl.refused = 0;
      break;
    }
  }
  if (pl.refused) return 0;
  auto kern = knarpe_kernel<T, MODE, H>;
  // the attribute belongs to the kernel function, not to this plan: set it to the device's
  // limit, so that a later plan needing less never lowers it under an earlier one needing more
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, pl.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * n_sm;
  return 0;
}

template <typename T, int MODE, int H>
int general_plan(int dev, int K, int D, int X, Plan* out) {
  static std::mutex mu;
  static std::vector<Plan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const Plan& c : plans) {
    if (c.dev == dev && c.n_knn == K && c.d_model == D && c.x == X) {
      *out = c;
      return 0;
    }
  }
  Plan pl{};
  pl.dev = dev; pl.n_knn = K; pl.d_model = D; pl.x = X;
  const int rc = make_plan<T, MODE, H>(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

template <typename T, int MODE, int H>
int launch_t(Params p, int dev, cudaStream_t stream) {
  Plan pl{};
  const int rc = general_plan<T, MODE, H>(dev, p.n_knn, p.d_model, p.d_tgt + p.d_rpe, &pl);
  if (rc != 0) return rc;
  if (pl.refused) return static_cast<int>(cudaErrorInvalidValue);
  p.ldw = pl.ldw;
  p.resident = pl.resident;
  p.stage_x = pl.stage_x;
  p.L = pl.L;
  const int grid = static_cast<int>(p.n_src < pl.slots ? p.n_src : pl.slots);
  knarpe_kernel<T, MODE, H><<<grid, kThreads, p.L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 0 if the general kernel takes the shape, 1 if even its smallest layout does not fit, or minus a CUDA error
// (-1 also for a head count it has no instantiation for).
template <typename T, int MODE>
int general_refusal(int K, int D, int X, int n_head, int dev) {
  Plan pl{};
  int rc = 0;
  switch (n_head) {
    case 1: rc = general_plan<T, MODE, 1>(dev, K, D, X, &pl); break;
    case 2: rc = general_plan<T, MODE, 2>(dev, K, D, X, &pl); break;
    case 4: rc = general_plan<T, MODE, 4>(dev, K, D, X, &pl); break;
    case 8: rc = general_plan<T, MODE, 8>(dev, K, D, X, &pl); break;
    default: return -1;
  }
  return rc != 0 ? -rc : pl.refused;
}

template <typename T, int MODE>
int by_heads(const Params& p, int n_head, int dev, cudaStream_t stream) {
  switch (n_head) {
    case 1: return launch_t<T, MODE, 1>(p, dev, stream);
    case 2: return launch_t<T, MODE, 2>(p, dev, stream);
    case 4: return launch_t<T, MODE, 4>(p, dev, stream);
    case 8: return launch_t<T, MODE, 8>(p, dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The staged kernel's plan per (device, K, D, R) and instantiation: its refusal code
// (staged::refusal; 0 = taken), groups of warps a block (staged::group_count), layout and resident blocks on the
// device.
struct StagedPlan {
  int dev, n_knn, d_model, d_rpe, refused, groups;
  staged::Layout L;
  long long slots;
};

// The staged kernel for a narrow rpe or not, with G groups of warps a block (two only narrow, up to 4 heads).
template <int MODE, int H>
auto staged_kernel(bool narrow, int groups) {
  if constexpr (H <= 4) {
    if (narrow && groups == 2) return staged::knarpe_x_staged_kernel<MODE, H, 2, true>;
  }
  return narrow ? staged::knarpe_x_staged_kernel<MODE, H, 1, true> : staged::knarpe_x_staged_kernel<MODE, H, 1, false>;
}

template <int MODE, int H>
int make_staged_plan(StagedPlan& pl) {
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.refused = staged::refusal(MODE, pl.n_knn, pl.d_model, pl.d_rpe, H, static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  pl.groups = staged::group_count(pl.n_knn, pl.d_model, pl.d_rpe, H, static_cast<size_t>(max_smem));
  pl.L = staged::make_layout(pl.n_knn, pl.d_model, pl.d_rpe, H, pl.groups);
  auto kern = staged_kernel<MODE, H>(pl.d_rpe != staged::rpe_cols(pl.d_rpe), pl.groups);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, staged::kThreads, pl.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) pl.refused = 6;
  pl.slots = static_cast<long long>(per_sm) * n_sm;
  return 0;
}

template <int MODE, int H>
int staged_plan(int dev, int K, int D, int R, StagedPlan* out) {
  static std::mutex mu;
  static std::vector<StagedPlan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const StagedPlan& c : plans) {
    if (c.dev == dev && c.n_knn == K && c.d_model == D && c.d_rpe == R) {
      *out = c;
      return 0;
    }
  }
  StagedPlan pl{};
  pl.dev = dev; pl.n_knn = K; pl.d_model = D; pl.d_rpe = R;
  const int rc = make_staged_plan<MODE, H>(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// Launches the staged kernel; a shape it refuses, or an operand that is not 16-byte aligned (the
// copies move 16-byte chunks), is cudaErrorInvalidValue.
template <int MODE, int H>
int staged_launch(const Params& g, int dev, cudaStream_t stream) {
  StagedPlan pl{};
  const int rc = staged_plan<MODE, H>(dev, g.n_knn, g.d_model, g.d_rpe, &pl);
  if (rc != 0) return rc;
  if (pl.refused || !(aligned16(g.q) && aligned16(g.tgt) && aligned16(g.rpe) && aligned16(g.w_kv) &&
                      aligned16(g.w_rpe) && aligned16(g.bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  staged::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(g.q);
  p.tgt = static_cast<const __nv_bfloat16*>(g.tgt);
  p.rpe = static_cast<const __nv_bfloat16*>(g.rpe);
  p.w_kv = static_cast<const __nv_bfloat16*>(g.w_kv);
  p.w_rpe = static_cast<const __nv_bfloat16*>(g.w_rpe);
  p.bias = static_cast<const __nv_bfloat16*>(g.bias);
  p.invalid = g.invalid;
  p.out = static_cast<__nv_bfloat16*>(g.out);
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.d_model = g.d_model; p.scale = g.scale;
  p.d_rpe = staged::rpe_cols(g.d_rpe);
  p.r_in = g.d_rpe;
  p.mt = staged::swizzle_mask(g.d_model / 8);
  p.mr = staged::swizzle_mask(p.d_rpe / 8);
  p.mw = staged::swizzle_mask(g.d_model / 4);
  p.L = pl.L;
  const bool narrow = p.r_in != p.d_rpe;
  CUtensorMap tm{};  // narrow: tgt by 2-D tensor copies, boxes of 64 columns by K rows
  if (narrow) {
    const int enc = staged::encode_rows(&tm, g.tgt, static_cast<long long>(g.n_src) * g.n_knn, g.d_model, g.d_model,
                                        g.n_knn);
    if (enc != 0) return enc;
  }
  const long long blocks = (g.n_src + pl.groups - 1) / pl.groups;  // each group on its own sources
  const int grid = static_cast<int>(blocks < pl.slots ? blocks : pl.slots);
  auto kern = staged_kernel<MODE, H>(narrow, pl.groups);
  kern<<<grid, staged::kThreads, p.L.total, stream>>>(p, tm);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int staged_by_heads(const Params& p, int n_head, int dev, cudaStream_t stream) {
  switch (n_head) {
    case 1: return staged_launch<MODE, 1>(p, dev, stream);
    case 2: return staged_launch<MODE, 2>(p, dev, stream);
    case 4: return staged_launch<MODE, 4>(p, dev, stream);
    case 8: return staged_launch<MODE, 8>(p, dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The staged kernel's code for a bf16 B2 (mode 1) or B3 (mode 2) shape: 0 if it takes the shape,
// else staged::refusal's code (6: no block fits an SM), or minus a CUDA error; -1 for another mode.
int staged_code(int mode, int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  StagedPlan pl{};
  int rc = 0;
  switch (mode * 16 + n_head) {
    case kCross * 16 + 1: rc = staged_plan<kCross, 1>(dev, n_knn, d_model, d_rpe, &pl); break;
    case kCross * 16 + 2: rc = staged_plan<kCross, 2>(dev, n_knn, d_model, d_rpe, &pl); break;
    case kCross * 16 + 4: rc = staged_plan<kCross, 4>(dev, n_knn, d_model, d_rpe, &pl); break;
    case kCross * 16 + 8: rc = staged_plan<kCross, 8>(dev, n_knn, d_model, d_rpe, &pl); break;
    case kCrossV3 * 16 + 1: rc = staged_plan<kCrossV3, 1>(dev, n_knn, d_model, d_rpe, &pl); break;
    case kCrossV3 * 16 + 2: rc = staged_plan<kCrossV3, 2>(dev, n_knn, d_model, d_rpe, &pl); break;
    case kCrossV3 * 16 + 4: rc = staged_plan<kCrossV3, 4>(dev, n_knn, d_model, d_rpe, &pl); break;
    case kCrossV3 * 16 + 8: rc = staged_plan<kCrossV3, 8>(dev, n_knn, d_model, d_rpe, &pl); break;
    default: return -1;
  }
  return rc != 0 ? -rc : pl.refused;
}

// The cluster kernel's plan per (device, K): its refusal code (cluster_x::refusal; 0 = taken, 4 = no cluster
// fits the device), layout and the clusters resident on the device.
struct ClusterPlan {
  int dev, n_knn, refused;
  cluster_x::Layout L;
  long long clusters;
};

int make_cluster_plan(ClusterPlan& pl) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.refused = cluster_x::refusal(pl.n_knn, cluster_x::kWidth, cluster_x::kWidth, cluster_x::kHeads,
                                  static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  pl.L = cluster_x::make_layout(pl.n_knn);
  auto kern = cluster_x::knarpe_x_cluster_kernel;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr{};
  const cudaLaunchConfig_t cfg = cluster_x::launch_config(cluster_x::kCluster, pl.L.total, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kern), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1) pl.refused = 4;
  pl.clusters = n;
  return 0;
}

int cluster_plan(int dev, int K, ClusterPlan* out) {
  static std::mutex mu;
  static std::vector<ClusterPlan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const ClusterPlan& c : plans) {
    if (c.dev == dev && c.n_knn == K) {
      *out = c;
      return 0;
    }
  }
  ClusterPlan pl{};
  pl.dev = dev; pl.n_knn = K;
  const int rc = make_cluster_plan(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

// The cluster kernel's code for a bf16 B2 shape: 0 if it takes the shape, else cluster_x::refusal's code (2 for
// widths it is not compiled for, without asking the device; 4: no cluster fits the device), or minus a CUDA error.
int cluster_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  const int code = cluster_x::refusal(n_knn, d_model, d_rpe, n_head, SIZE_MAX);
  if (code != 0) return code;
  ClusterPlan pl{};
  const int rc = cluster_plan(dev, n_knn, &pl);
  return rc != 0 ? -rc : pl.refused;
}

// Launches the cluster kernel at a shape cluster_code takes; an operand that is not 16-byte aligned (the tensor
// and bulk copies need it) is cudaErrorInvalidValue.
int cluster_launch(const Params& g, int dev, cudaStream_t stream) {
  ClusterPlan pl{};
  const int rc = cluster_plan(dev, g.n_knn, &pl);
  if (rc != 0) return rc;
  if (pl.refused || !(aligned16(g.q) && aligned16(g.tgt) && aligned16(g.rpe) && aligned16(g.w_kv) &&
                      aligned16(g.w_rpe) && aligned16(g.bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  constexpr int D = cluster_x::kWidth;
  cluster_x::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.w_kv = static_cast<const bf16*>(g.w_kv);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.out = static_cast<bf16*>(g.out);
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.scale = g.scale;
  p.L = pl.L;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_t, g.tgt, n_rows, D, D, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, D, D, g.n_knn);
  if (enc != 0) return enc;
  const long long n_cl = g.n_src < pl.clusters ? g.n_src : pl.clusters;
  cudaLaunchAttribute attr{};
  const cudaLaunchConfig_t cfg =
      cluster_x::launch_config(static_cast<int>(cluster_x::kCluster * n_cl), p.L.total, stream, &attr);
  void* args[] = {&p};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(cluster_x::knarpe_x_cluster_kernel), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The heads B3 kernel's plan per device: its refusal code (heads_x3::refusal; 0 = taken, 4 = no block fits an SM)
// and the slots of four blocks (one per quarter of the heads) resident on the device. Its layout does not depend on K.
struct V3HeadsPlan {
  int dev, refused;
  long long slots;
};

int make_v3_heads_plan(V3HeadsPlan& pl) {
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.refused = heads_x3::refusal(1, heads_x3::kWidth, heads_x3::kWidth, heads_x3::kHeads,
                                 static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  auto kern = heads_x3::knarpe_x3_heads_kernel;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, heads_x3::kThreads, heads_x3::kTotal);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.slots = static_cast<long long>(per_sm) * n_sm / heads_x3::kSplit;
  if (pl.slots < 1) pl.refused = 4;
  return 0;
}

int v3_heads_plan(int dev, V3HeadsPlan* out) {
  static std::mutex mu;
  static std::vector<V3HeadsPlan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const V3HeadsPlan& c : plans) {
    if (c.dev == dev) {
      *out = c;
      return 0;
    }
  }
  V3HeadsPlan pl{};
  pl.dev = dev;
  const int rc = make_v3_heads_plan(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

// The heads B3 kernel's code for a bf16 B3 shape: 0 if it takes the shape, else heads_x3::refusal's code (1 for
// K < 1 and 2 for widths it is not compiled for, without asking the device; 4: no block fits an SM), or minus a CUDA
// error.
int v3_heads_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  const int code = heads_x3::refusal(n_knn, d_model, d_rpe, n_head, SIZE_MAX);
  if (code != 0) return code;
  V3HeadsPlan pl{};
  const int rc = v3_heads_plan(dev, &pl);
  return rc != 0 ? -rc : pl.refused;
}

// Launches the heads B3 kernel at a shape v3_heads_code takes; an operand that is not 16-byte aligned (the tensor
// copies need it) is cudaErrorInvalidValue.
int v3_heads_launch(const Params& g, int dev, cudaStream_t stream) {
  V3HeadsPlan pl{};
  const int rc = v3_heads_plan(dev, &pl);
  if (rc != 0) return rc;
  if (pl.refused || !(aligned16(g.q) && aligned16(g.tgt) && aligned16(g.rpe) && aligned16(g.w_kv) &&
                      aligned16(g.w_rpe) && aligned16(g.bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  constexpr int D = heads_x3::kWidth;
  heads_x3::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.w_kv = static_cast<const bf16*>(g.w_kv);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.out = static_cast<bf16*>(g.out);
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.scale = g.scale;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_t, g.tgt, n_rows, D, D, heads_x3::kTile);
  if (enc == 0) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, D, D, heads_x3::kTile);
  if (enc != 0) return enc;
  const long long n_slots = g.n_src < pl.slots ? g.n_src : pl.slots;
  const int grid = static_cast<int>(heads_x3::kSplit * n_slots);
  heads_x3::knarpe_x3_heads_kernel<<<grid, heads_x3::kThreads, heads_x3::kTotal, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 B2 or B3: the staged kernel where it takes the shape; else, for B2, the cluster kernel and, for B3, the heads
// kernel where it takes the shape; else the general kernel.
template <int MODE>
int bf16_cross(const Params& p, int n_head, int dev, cudaStream_t stream) {
  const int code = staged_code(MODE, p.n_knn, p.d_model, p.d_rpe, n_head, dev);
  if (code < 0) return code == -1 ? static_cast<int>(cudaErrorInvalidValue) : -code;
  if (code == 0) return staged_by_heads<MODE>(p, n_head, dev, stream);
  const int wide = MODE == kCross ? cluster_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev)
                                  : v3_heads_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev);
  if (wide < 0) return -wide;
  if (wide == 0) return MODE == kCross ? cluster_launch(p, dev, stream) : v3_heads_launch(p, dev, stream);
  return by_heads<__nv_bfloat16, MODE>(p, n_head, dev, stream);
}

// The staged B4 kernel's plan per (device, K, D, R) and head count: its refusal code
// (staged_attn::refusal; 0 = taken, 5 = no block fits an SM), layout and resident blocks on the device.
struct AttnPlan {
  int dev, n_knn, d_model, d_rpe, refused;
  staged_attn::Layout L;
  long long slots;
};

template <int H>
int make_attn_plan(AttnPlan& pl) {
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.refused = staged_attn::refusal(pl.n_knn, pl.d_model, pl.d_rpe, H, static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  pl.L = staged_attn::make_layout(pl.n_knn, pl.d_model, pl.d_rpe, H,
                                  staged_attn::stage_count(pl.n_knn, pl.d_model, pl.d_rpe, H, max_smem));
  auto kern = staged_attn::knarpe_attn_staged_kernel<H>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, staged_attn::kThreads, pl.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) pl.refused = 5;
  pl.slots = static_cast<long long>(per_sm) * n_sm;
  return 0;
}

template <int H>
int attn_plan(int dev, int K, int D, int R, AttnPlan* out) {
  static std::mutex mu;
  static std::vector<AttnPlan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const AttnPlan& c : plans) {
    if (c.dev == dev && c.n_knn == K && c.d_model == D && c.d_rpe == R) {
      *out = c;
      return 0;
    }
  }
  AttnPlan pl{};
  pl.dev = dev; pl.n_knn = K; pl.d_model = D; pl.d_rpe = R;
  const int rc = make_attn_plan<H>(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

// The staged kernel's code for a bf16 B4 shape: 0 if it takes the shape, else staged_attn::refusal's code
// (5: no block fits an SM), or minus a CUDA error; -1 for a head count the wrapper does not take. Eight
// heads are refused (3) without asking the device.
int attn_staged_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  AttnPlan pl{};
  int rc = 0;
  switch (n_head) {
    case 1: rc = attn_plan<1>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 2: rc = attn_plan<2>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 4: rc = attn_plan<4>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 8: return staged_attn::refusal(n_knn, d_model, d_rpe, 8, SIZE_MAX);
    default: return -1;
  }
  return rc != 0 ? -rc : pl.refused;
}

// Launches the staged B4 kernel; a shape it refuses, an operand that is not 16-byte aligned or a k/v row
// stride that is no multiple of 16 bytes (the tensor copies need both) is cudaErrorInvalidValue.
template <int H>
int attn_staged_launch(const Params& g, int dev, cudaStream_t stream) {
  AttnPlan pl{};
  const int rc = attn_plan<H>(dev, g.n_knn, g.d_model, g.d_rpe, &pl);
  if (rc != 0) return rc;
  if (pl.refused || (g.ld_kv * 2) % 16 || !(aligned16(g.q) && aligned16(g.k) && aligned16(g.v) && aligned16(g.rpe) &&
                                            aligned16(g.w_rpe) && aligned16(g.bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  staged_attn::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.out = static_cast<bf16*>(g.out);
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.d_model = g.d_model; p.d_rpe = g.d_rpe; p.scale = g.scale;
  p.mw = staged::swizzle_mask(g.d_model / 4);
  p.L = pl.L;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_k, g.k, n_rows, g.d_model, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_v, g.v, n_rows, g.d_model, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, g.d_rpe, g.d_rpe, g.n_knn);
  if (enc != 0) return enc;
  const int grid = static_cast<int>(g.n_src < pl.slots ? g.n_src : pl.slots);
  staged_attn::knarpe_attn_staged_kernel<H><<<grid, staged_attn::kThreads, p.L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The heads B4 kernel's plan per (device, K): its refusal code (heads_attn::refusal; 0 = taken, 4 = no block
// fits an SM), layout and the slots of four blocks (one per quarter of the heads) resident on the device.
struct HeadsPlan {
  int dev, n_knn, refused;
  heads_attn::Layout L;
  long long slots;
};

int make_heads_plan(HeadsPlan& pl) {
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.refused = heads_attn::refusal(pl.n_knn, heads_attn::kWidth, heads_attn::kWidth, heads_attn::kHeads,
                                   static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  pl.L = heads_attn::make_layout(pl.n_knn, heads_attn::group_count(pl.n_knn, static_cast<size_t>(max_smem)));
  auto kern = heads_attn::knarpe_attn_heads_kernel;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, heads_attn::kGroupThreads * pl.L.n_groups,
                                                      pl.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.slots = static_cast<long long>(per_sm) * n_sm / heads_attn::kSplit;
  if (pl.slots < 1) pl.refused = 4;
  return 0;
}

int heads_plan(int dev, int K, HeadsPlan* out) {
  static std::mutex mu;
  static std::vector<HeadsPlan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const HeadsPlan& c : plans) {
    if (c.dev == dev && c.n_knn == K) {
      *out = c;
      return 0;
    }
  }
  HeadsPlan pl{};
  pl.dev = dev; pl.n_knn = K;
  const int rc = make_heads_plan(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

// The heads kernel's code for a bf16 B4 shape: 0 if it takes the shape, else heads_attn::refusal's code (2 for
// widths it is not compiled for, without asking the device; 4: no block fits an SM), or minus a CUDA error.
int heads_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  const int code = heads_attn::refusal(n_knn, d_model, d_rpe, n_head, SIZE_MAX);
  if (code != 0) return code;
  HeadsPlan pl{};
  const int rc = heads_plan(dev, n_knn, &pl);
  return rc != 0 ? -rc : pl.refused;
}

// Launches the heads B4 kernel at a shape heads_code takes; an operand that is not 16-byte aligned or a k/v row
// stride that is no multiple of 16 bytes (the tensor copies need both) is cudaErrorInvalidValue.
int heads_launch(const Params& g, int dev, cudaStream_t stream) {
  HeadsPlan pl{};
  const int rc = heads_plan(dev, g.n_knn, &pl);
  if (rc != 0) return rc;
  if (pl.refused || (g.ld_kv * 2) % 16 || !(aligned16(g.q) && aligned16(g.k) && aligned16(g.v) && aligned16(g.rpe) &&
                                            aligned16(g.w_rpe) && aligned16(g.bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  constexpr int D = heads_attn::kWidth;
  heads_attn::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.out = static_cast<bf16*>(g.out);
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.scale = g.scale;
  p.L = pl.L;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_k, g.k, n_rows, D, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_v, g.v, n_rows, D, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, D, D, g.n_knn);
  if (enc != 0) return enc;
  const long long n_slots = g.n_src < pl.slots ? g.n_src : pl.slots;
  const int grid = static_cast<int>(heads_attn::kSplit * n_slots);
  heads_attn::knarpe_attn_heads_kernel<<<grid, heads_attn::kGroupThreads * p.L.n_groups, p.L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 B4: the staged kernel where it takes the shape; else the heads kernel where it takes the shape; else the
// general kernel.
int bf16_attn(const Params& p, int n_head, int dev, cudaStream_t stream) {
  const int code = attn_staged_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev);
  if (code < 0) return code == -1 ? static_cast<int>(cudaErrorInvalidValue) : -code;
  if (code != 0) {
    const int heads = heads_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev);
    if (heads < 0) return -heads;
    if (heads == 0) return heads_launch(p, dev, stream);
    return by_heads<__nv_bfloat16, kAttn>(p, n_head, dev, stream);
  }
  switch (n_head) {
    case 1: return attn_staged_launch<1>(p, dev, stream);
    case 2: return attn_staged_launch<2>(p, dev, stream);
    default: return attn_staged_launch<4>(p, dev, stream);
  }
}

// Every mode on the general kernel in T.
template <typename T>
int general_by_mode(const Params& p, int mode, int n_head, int dev, cudaStream_t stream) {
  switch (mode) {
    case kAttn: return by_heads<T, kAttn>(p, n_head, dev, stream);
    case kCross: return by_heads<T, kCross>(p, n_head, dev, stream);
    case kCrossV3: return by_heads<T, kCrossV3>(p, n_head, dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// float32 runs every mode on the general kernel; bf16 runs B4 by bf16_attn, and B2 and B3 by bf16_cross, or with
// general on the general kernel too (knarpe_general_launch).
int by_mode(const Params& p, int mode, int dtype, int n_head, int dev, cudaStream_t stream, bool general) {
  if (dtype == 0) return general_by_mode<float>(p, mode, n_head, dev, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (general) return general_by_mode<__nv_bfloat16>(p, mode, n_head, dev, stream);
  switch (mode) {
    case kAttn: return bf16_attn(p, n_head, dev, stream);
    case kCross: return bf16_cross<kCross>(p, n_head, dev, stream);
    case kCrossV3: return bf16_cross<kCrossV3>(p, n_head, dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The body of knarpe_launch; with general, bf16 takes the general kernel too (knarpe_general_launch).
int launch_fwd(bool general, int mode, int dtype, const void* q, const void* k, const void* v, long long ld_kv,
               const void* tgt, const void* rpe, const void* invalid, const void* w_kv, const void* w_rpe,
               const void* bias, void* out, int n_src, int n_knn, int d_model, int d_tgt, int d_rpe, int n_head,
               float scale, int dev, void* stream) {
  // a calling thread with no current context yet (an autograd worker that has issued no CUDA call) gets the
  // device's: cuTensorMapEncodeTiled, which encodes the tensor maps, refuses to run without one
  const cudaError_t set = cudaSetDevice(dev);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{};
  p.q = q; p.k = k; p.v = v; p.ld_kv = ld_kv; p.tgt = tgt; p.rpe = rpe;
  p.invalid = static_cast<const uint8_t*>(invalid);
  p.w_kv = w_kv; p.w_rpe = w_rpe; p.bias = bias; p.out = out;
  p.n_src = n_src; p.n_knn = n_knn; p.d_model = d_model; p.d_tgt = d_tgt; p.d_rpe = d_rpe; p.scale = scale;
  return by_mode(p, mode, dtype, n_head, dev, static_cast<cudaStream_t>(stream), general);
}

}  // namespace

// Device pointers of tensors laid out as in ops/knarpe.py; dtype 0 = float32,
// 1 = bf16 for every operand and the output. B4 (mode 0) reads k/v rows of D
// elements at stride ld_kv and no tgt / w_kv (d_tgt = 0); B2/B3 read tgt and
// w_kv (d_tgt = d_model) and no k/v. n_head in {1, 2, 4, 8}, d_model even and
// divisible by n_head, for B3 d_model / n_head a multiple of 4; a bf16 B2/B3
// shape on the staged, cluster or heads route needs 16-byte aligned operands (checked
// by the Python wrapper, which also names the route: knarpe_staged_route, then
// for B2 knarpe_cluster_route and for B3 knarpe_v3_heads_route, then knarpe_general_route). dev is the current device, which owns the tensors and
// the stream. Returns cudaGetLastError(), or cudaErrorInvalidValue for a launch
// no kernel takes.
extern "C" int knarpe_launch(int mode, int dtype, const void* q, const void* k, const void* v, long long ld_kv,
                             const void* tgt, const void* rpe, const void* invalid, const void* w_kv,
                             const void* w_rpe, const void* bias, void* out, int n_src, int n_knn, int d_model,
                             int d_tgt, int d_rpe, int n_head, float scale, int dev, void* stream) {
  return launch_fwd(false, mode, dtype, q, k, v, ld_kv, tgt, rpe, invalid, w_kv, w_rpe, bias, out, n_src, n_knn,
                    d_model, d_tgt, d_rpe, n_head, scale, dev, stream);
}

// knarpe_launch on the general kernel whatever route the shape takes, so that a measurement can time it beside the
// staged kernel at the same shape (chip_smoke.py phase 3); the port never calls it.
extern "C" int knarpe_general_launch(int mode, int dtype, const void* q, const void* k, const void* v,
                                     long long ld_kv, const void* tgt, const void* rpe, const void* invalid,
                                     const void* w_kv, const void* w_rpe, const void* bias, void* out, int n_src,
                                     int n_knn, int d_model, int d_tgt, int d_rpe, int n_head, float scale, int dev,
                                     void* stream) {
  return launch_fwd(true, mode, dtype, q, k, v, ld_kv, tgt, rpe, invalid, w_kv, w_rpe, bias, out, n_src, n_knn,
                    d_model, d_tgt, d_rpe, n_head, scale, dev, stream);
}

// Whether a staged kernel takes a bf16 launch at this shape on device dev, given 16-byte aligned
// operands (and, for B4, a k/v row stride that is a multiple of 16 bytes): 0 if it does, else the
// refusal code of knarpe_attn_staged.cuh (B4, mode 0; staged_attn::refusal, 5: no block fits an SM) or
// knarpe_staged.cuh (B2, mode 1, or B3, mode 2; staged::refusal, 6: no block fits an SM), or minus a
// CUDA error; -1 for any other mode or dtype. knarpe_launch runs bf16 launches on the staged kernel
// where this is 0, else B4 and B3 on their heads kernels and B2 on the cluster kernel where their routes say 0,
// and on the general kernel otherwise.
extern "C" int knarpe_staged_route(int mode, int dtype, int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  if (dtype != 1) return -1;
  if (mode == kAttn) return attn_staged_code(n_knn, d_model, d_rpe, n_head, dev);
  if (mode != kCross && mode != kCrossV3) return -1;
  return staged_code(mode, n_knn, d_model, d_rpe, n_head, dev);
}

// Whether the cluster kernel of knarpe_cluster.cuh takes a bf16 B2 launch at this shape on device dev,
// given 16-byte aligned operands: 0 if it does, else cluster_x::refusal's code (2: widths other than
// d_model = d_rpe = 256 with 8 heads; 4: no cluster fits the device), or minus a CUDA error. knarpe_launch
// runs a bf16 B2 that knarpe_staged_route refuses on the cluster kernel where this is 0.
extern "C" int knarpe_cluster_route(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  return cluster_code(n_knn, d_model, d_rpe, n_head, dev);
}

// Whether the heads kernel of knarpe_attn_heads.cuh takes a bf16 B4 launch at this shape on device dev, given
// 16-byte aligned operands and a k/v row stride that is a multiple of 16 bytes: 0 if it does, else
// heads_attn::refusal's code (1: K outside [1, 128]; 2: widths other than d_model = d_rpe = 256 with 8 heads; 3:
// four stages exceed the shared memory; 4: no block fits an SM), or minus a CUDA error. knarpe_launch runs a bf16
// B4 that knarpe_staged_route refuses on the heads kernel where this is 0, and on the general kernel otherwise.
extern "C" int knarpe_attn_heads_route(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  return heads_code(n_knn, d_model, d_rpe, n_head, dev);
}

// Whether the heads kernel of knarpe_v3_heads.cuh takes a bf16 B3 launch at this shape on device dev, given 16-byte
// aligned operands: 0 if it does, else heads_x3::refusal's code (1: K < 1; 2: widths other than d_model = d_rpe = 256
// with 8 heads; 3: its layout exceeds the shared memory; 4: no block fits an SM), or minus a CUDA error. knarpe_launch
// runs a bf16 B3 that knarpe_staged_route refuses on the heads kernel where this is 0, and on the general kernel
// otherwise.
extern "C" int knarpe_v3_heads_route(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  return v3_heads_code(n_knn, d_model, d_rpe, n_head, dev);
}

// Whether the general kernel takes a bf16 B2 (mode 1) or B3 (mode 2) launch at this shape on device
// dev: 0 if it does, 1 if its layout exceeds the block's shared memory even with the weights (and
// B3's inputs) read through L1/L2, or minus a CUDA error; -1 for any other mode or dtype. The wrapper
// asks it for the shapes knarpe_staged_route (and knarpe_cluster_route for B2, knarpe_v3_heads_route for B3)
// refuses, and raises
// when this refuses too.
extern "C" int knarpe_general_route(int mode, int dtype, int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  if (dtype != 1) return -1;
  const int X = d_model + d_rpe;
  if (mode == kCross) return general_refusal<__nv_bfloat16, kCross>(n_knn, d_model, X, n_head, dev);
  if (mode == kCrossV3) return general_refusal<__nv_bfloat16, kCrossV3>(n_knn, d_model, X, n_head, dev);
  return -1;
}
