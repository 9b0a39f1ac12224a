// Fused KNARPE attention backwards for Hopper (sm_90a): B4-bwd and B2/B3-bwd.
//
// Replaces the backward Pallas kernels of trafficbotsv15_tpu/ops/pallas_knarpe.py:
//   mode 0, B4-bwd: backward of knarpe_attention          (_bwd_kernel, :136-206)
//   mode 1, B2-bwd: backward of knarpe_cross_attention    (_x_bwd_kernel, :463-547);
//           B3's backward is this one too (pallas_knarpe.py:778-783)
// Like the Pallas kernels, they recompute the forward per source (nothing is
// saved but the inputs) and emit every input gradient plus the weight and bias
// gradients summed over all sources. T is float or bf16 for every operand and
// gradient; sums and softmax statistics are float32; dW and db are summed in
// float32 and rounded once to T. The plain versions are autograd through
// ops/knarpe.py::*_reference.
//
// The forward's reassociation carries over (csrc/knarpe.cu; x_j = [tgt_j | rpe_j],
// u_h = W_k[:, h] q_h, w_h = W_v[:, h] g_h, per head h with dh = D / H):
//   logit_hj = scale (x_j . u_h + b_k[h] . q_h  [+ k_jh . q_h for B4])
//   dattn_hj = x_j . w_h + b_v[h] . g_h  [+ v_jh . g_h for B4]
//   dl_hj    = attn_hj (dattn_hj - sum_j attn_hj dattn_hj)
//   dx_j     = sum_h scale dl_hj u_h + attn_hj w_h           ([K, 2H] x [2H, X] per source)
//   dq_h     = scale (z_h W_k[:, h] + b_k[h] sum_j dl_hj  [+ sum_j dl_hj k_jh]),  z_h = sum_j dl_hj x_j
//   B4: dk_jh = scale dl_hj q_h, dv_jh = attn_hj g_h (written in full)
// so the [K, 2D] dkv of the Pallas kernel is never formed. The weight
// gradients are, per source, rank-1 per head:
//   dW_k[:, h] += (scale z_h) q_h^T,  dW_v[:, h] += y_h g_h^T,  y_h = sum_j attn_hj x_j,
// and db is the same with a constant input 1 (row X of the products). The
// per-source kernel writes P = [scale z_h | scale sum dl_hj] and [y_h | sum attn_hj]
// ([n_src, 2, H, X + 1] float32) to scratch; a second kernel reduces
// P^T [q | g] over fixed chunks of sources into per-chunk partial sums (a
// batched product [X + 1, n_src] x [n_src, dh] per half and head), and a third
// adds the chunks in order. No float atomics: the gradients are the same
// from run to run.
//
// What bounds them on this card: B2-bwd reads tgt and rpe and writes dtgt and
// drpe; at the training step's bf16 shape (8 x 64 sources, K = 89, D = R = 128)
// that is 47 MB (0.014 ms at 3.35 TB/s), while the reassociated work above is
// ~0.7 M multiply-adds per source, 0.73 GFLOP (under 0.001 ms on the bf16
// tensor cores), so its bytes bound it. B4-bwd writes dk and dv in full and is
// bound by its 409 MB at 8 x 1024 sources.
//
// Routes. bf16 B4-bwd runs its per-source step on the staged kernel of
// knarpe_attn_bwd_staged.cuh (the forward's ring of stages and four groups of
// warps, every product on the tensor cores, dk/dv/drpe written as full lines)
// wherever it takes the shape (knarpe_bwd_staged_route's code 0 in mode 0: up
// to 4 heads, D and R multiples of 16, K up to 128, four stages within the
// block's shared memory); at the scaled preset's D = R = 256 with 8 heads
// (K <= 40), which it refuses, on the heads kernel of knarpe_attn_bwd_heads.cuh
// (four blocks a source, each on two heads with its quarter of W_rpe, and a
// second pass that sums drpe over the four; knarpe_attn_bwd_heads_route's code
// 0). bf16 B2-bwd (B3's too) runs its per-source step on the staged
// kernel of knarpe_bwd_staged.cuh (each source staged in shared memory by bulk
// copies and read from device memory once, every product on the tensor cores;
// its header says how) wherever that kernel takes the shape
// (knarpe_bwd_staged_route's code 0: up to 4 heads, D a multiple of 16, R a
// multiple of 16 or 4 (the 4-wide RPE of pose_rpe "xy_dir", zero-padded to 16 columns in
// shared memory), one stage within the block's shared memory); at the scaled preset's
// D = R = 256 with 8 heads (K <= 128), which it refuses, on the heads kernel
// of knarpe_bwd_heads.cuh (eight blocks a source, one on each head with its
// columns of [W_kv; W_rpe], and a second pass that sums dtgt | drpe over the
// eight; knarpe_x_bwd_heads_route's code 0). The per-source kernel below
// serves float32 B4-bwd and B2-bwd and the bf16 shapes the staged kernels refuse
// (the general route): it reads x_j twice per source (the second time through
// L2) and does its multiply-adds on the CUDA cores in float32, one persistent
// 512-thread block per SM slot with [W_kv; W_rpe] staged in shared memory when
// it fits. The two weight-gradient passes follow every per-source kernel; at
// the training shapes they take ~6 % of the general route's device time, ~24 %
// of the staged B2 backward's and ~27 % of the staged B4 backward's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "knarpe_attn_bwd_staged.cuh"
#include "knarpe_attn_bwd_heads.cuh"
#include "knarpe_bwd_staged.cuh"
#include "knarpe_bwd_heads.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kMask = -1e9f;
enum Mode { kAttn = 0, kCross = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

__device__ __forceinline__ void prefetch_l2(const void* ptr, size_t bytes, int tid) {
  const char* c = static_cast<const char*>(ptr);
  for (size_t off = static_cast<size_t>(tid) * 128; off < bytes; off += static_cast<size_t>(kThreads) * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Byte offsets into the dynamic shared memory of one per-source block.
struct Layout {
  size_t w, qs, gs, inv, u, wv, c, e, stat, lg, da, ypart, zpart, dqpart, total;
  int py, po;  // partial sums per output element in the y/z and dq steps
};

Layout make_layout(size_t elem, int K, int D, int X, int H, int resident, int ldw) {
  Layout L{};
  size_t off = 0;
  L.w = off;     off += resident ? align16(static_cast<size_t>(X) * ldw * elem) : 0;
  L.qs = off;    off += align16(static_cast<size_t>(D) * 4);
  L.gs = off;    off += align16(static_cast<size_t>(D) * 4);
  L.inv = off;   off += align16(static_cast<size_t>(K));
  L.u = off;     off += align16(static_cast<size_t>(H) * X * 4);  // u, later z
  L.wv = off;    off += align16(static_cast<size_t>(H) * X * 4);  // w, later y
  L.c = off;     off += align16(static_cast<size_t>(H) * 4);
  L.e = off;     off += align16(static_cast<size_t>(H) * 4);
  L.stat = off;  off += align16(static_cast<size_t>(2 * H) * 4);  // sum attn, sum dl per head
  L.lg = off;    off += align16(static_cast<size_t>(H) * K * 4);  // logits, then attn
  L.da = off;    off += align16(static_cast<size_t>(H) * K * 4);  // dattn, then dl
  L.py = X < kThreads ? kThreads / X : 1;
  L.ypart = off; off += align16(static_cast<size_t>(L.py) * H * X * 4);
  L.zpart = off; off += align16(static_cast<size_t>(L.py) * H * X * 4);
  L.po = D < kThreads ? kThreads / D : 1;
  L.dqpart = off; off += align16(static_cast<size_t>(L.po) * D * 4);
  L.total = off;
  return L;
}

struct Params {
  const void* q;
  const void* k;  // B4 only: rows of D at stride ld_kv
  const void* v;
  long long ld_kv;
  const void* tgt;  // B2 only: [n_src * K, D]
  const void* rpe;  // [n_src * K, R]
  const uint8_t* invalid;  // [n_src, K]
  const void* w_kv;   // B2 only: [D, 2D]
  const void* w_rpe;  // [R, 2D]
  const void* bias;   // [2D]
  const void* g;      // [n_src, D]
  void* dq;           // [n_src, D]
  void* dk;           // B4 only: [n_src * K, D]
  void* dv;
  void* dtgt;         // B2 only: [n_src * K, D]
  void* drpe;         // [n_src * K, R]
  float* pbuf;        // [n_src, 2, H, X + 1]
  int n_src, n_knn, d_model, d_tgt, d_rpe;
  float scale;
  int resident, ldw;
  Layout L;
};

template <typename T, int MODE, int H>
__global__ void __launch_bounds__(kThreads) knarpe_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.n_knn, D = p.d_model, Xt = p.d_tgt, R = p.d_rpe, X = Xt + R, D2 = 2 * D, X1 = X + 1;
  const int dh = D / H;
  const float scale = p.scale;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const T* tgt = static_cast<const T*>(p.tgt);
  const T* rpe = static_cast<const T*>(p.rpe);
  const T* wg_t = static_cast<const T*>(p.w_kv);
  const T* wg_r = static_cast<const T*>(p.w_rpe);
  const T* bias = static_cast<const T*>(p.bias);
  const T* g = static_cast<const T*>(p.g);
  T* dqp = static_cast<T*>(p.dq);
  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
  T* dtgt = static_cast<T*>(p.dtgt);
  T* drpe = static_cast<T*>(p.drpe);

  T* w_s = reinterpret_cast<T*>(smem + p.L.w);
  float* qs = reinterpret_cast<float*>(smem + p.L.qs);
  float* gs = reinterpret_cast<float*>(smem + p.L.gs);
  uint8_t* inv = smem + p.L.inv;
  float* u = reinterpret_cast<float*>(smem + p.L.u);    // u[h][i]; later z[h][i]
  float* wv = reinterpret_cast<float*>(smem + p.L.wv);  // w[h][i]; later y[h][i]
  float* cvec = reinterpret_cast<float*>(smem + p.L.c);
  float* evec = reinterpret_cast<float*>(smem + p.L.e);
  float* stat = reinterpret_cast<float*>(smem + p.L.stat);  // [0, H): sum attn; [H, 2H): sum dl
  float* lg = reinterpret_cast<float*>(smem + p.L.lg);      // logits, then attn [h][j]
  float* da = reinterpret_cast<float*>(smem + p.L.da);      // dattn, then dl [h][j]
  float* ypart = reinterpret_cast<float*>(smem + p.L.ypart);
  float* zpart = reinterpret_cast<float*>(smem + p.L.zpart);
  float* dqpart = reinterpret_cast<float*>(smem + p.L.dqpart);

  // row i of [W_kv; W_rpe] (of W_rpe alone for B4, where Xt == 0): k half at [0, D), v half at [D, 2D)
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
    const size_t row0 = static_cast<size_t>(s) * K;
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
    for (int d = tid; d < D; d += kThreads) {
      qs[d] = to_f(q[static_cast<size_t>(s) * D + d]);
      gs[d] = to_f(g[static_cast<size_t>(s) * D + d]);
    }
    for (int j = tid; j < K; j += kThreads) inv[j] = p.invalid[row0 + j];
    __syncthreads();

    // u[h][i] = W_k[i, h-block] . q_h, w[h][i] = W_v[i, h-block] . g_h; c[h] = b_k[h] . q_h, e[h] = b_v[h] . g_h
    for (int e = tid; e < H * X; e += kThreads) {
      const int h = e / X, i = e - h * X;
      const T* wr = wrow(i) + h * dh;
      const float* qh = qs + h * dh;
      const float* gh = gs + h * dh;
      float acc_u = 0.f, acc_w = 0.f;
      for (int d = 0; d < dh; ++d) {
        acc_u += to_f(wr[d]) * qh[d];
        acc_w += to_f(wr[D + d]) * gh[d];
      }
      u[e] = acc_u;
      wv[e] = acc_w;
    }
    if (warp < 2 * H) {
      const int h = warp < H ? warp : warp - H;
      const float* vec = warp < H ? qs : gs;
      const int off = warp < H ? 0 : D;
      float acc = 0.f;
      for (int d = lane; d < dh; d += 32) acc += to_f(bias[off + h * dh + d]) * vec[h * dh + d];
      acc = warp_sum(acc);
      if (lane == 0) (warp < H ? cvec : evec)[h] = acc;
    }
    __syncthreads();

    // logits and dattn, one warp per target, lanes over the input features
    for (int j = warp; j < K; j += kWarps) {
      float pl[H], pd[H];
#pragma unroll
      for (int h = 0; h < H; ++h) pl[h] = pd[h] = 0.f;
      if (MODE != kAttn) {
        const T* xj = xt + static_cast<size_t>(j) * Xt;
        for (int i = lane; i < Xt; i += 32) {
          const float x = to_f(xj[i]);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            pl[h] += x * u[h * X + i];
            pd[h] += x * wv[h * X + i];
          }
        }
      }
      const T* rj = xr + static_cast<size_t>(j) * R;
      for (int i = lane; i < R; i += 32) {
        const float x = to_f(rj[i]);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          pl[h] += x * u[h * X + Xt + i];
          pd[h] += x * wv[h * X + Xt + i];
        }
      }
      if (MODE == kAttn) {
        const T* kj = kp + (row0 + j) * p.ld_kv;
        const T* vj = vp + (row0 + j) * p.ld_kv;
        for (int d = lane; d < D; d += 32) {
          const float kq = to_f(kj[d]) * qs[d];
          const float vg = to_f(vj[d]) * gs[d];
          const int hd = d / dh;
#pragma unroll
          for (int h = 0; h < H; ++h)
            if (hd == h) {
              pl[h] += kq;
              pd[h] += vg;
            }
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        pl[h] = warp_sum(pl[h]);
        pd[h] = warp_sum(pd[h]);
      }
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          lg[h * K + j] = (pl[h] + cvec[h]) * scale;
          da[h * K + j] = pd[h] + evec[h];
        }
      }
    }
    __syncthreads();

    // masked softmax over K and dl = attn (dattn - sum attn dattn), one warp per head;
    // a source with no valid target gets attn = 0, so every gradient below vanishes
    if (warp < H) {
      float* lh = lg + warp * K;
      float* dl = da + warp * K;
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
      if (den <= 0.f) den = 1.f;
      float sd = 0.f;
      for (int j = lane; j < K; j += 32) {
        const float a = lh[j] / den;
        lh[j] = a;
        sd += a * dl[j];
      }
      sd = warp_sum(sd);
      float as = 0.f, sdl = 0.f;
      for (int j = lane; j < K; j += 32) {
        const float a = lh[j];
        const float v = a * (dl[j] - sd);
        dl[j] = v;
        as += a;
        sdl += v;
      }
      as = warp_sum(as);
      sdl = warp_sum(sdl);
      if (lane == 0) {
        stat[warp] = as;
        stat[H + warp] = sdl;
      }
    }
    __syncthreads();

    // dx_j = sum_h scale dl_hj u_h + attn_hj w_h -> dtgt / drpe
    for (int e = tid; e < K * X; e += kThreads) {
      const int j = e / X, i = e - j * X;
      float acc = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) acc += scale * da[h * K + j] * u[h * X + i] + lg[h * K + j] * wv[h * X + i];
      if (i < Xt)
        dtgt[(row0 + j) * Xt + i] = from_f<T>(acc);
      else
        drpe[(row0 + j) * R + (i - Xt)] = from_f<T>(acc);
    }
    if (MODE == kAttn) {  // dk_jh = scale dl_hj q_h, dv_jh = attn_hj g_h
      for (int e = tid; e < K * D; e += kThreads) {
        const int j = e / D, d = e - j * D, h = d / dh;
        dkp[(row0 + j) * D + d] = from_f<T>(scale * da[h * K + j] * qs[d]);
        dvp[(row0 + j) * D + d] = from_f<T>(lg[h * K + j] * gs[d]);
      }
    }

    // y_h = sum_j attn_hj x_j, z_h = sum_j dl_hj x_j, in py partial sums over j
    for (int e = tid; e < X * p.L.py; e += kThreads) {
      const int part = e / X, i = e - part * X;
      const T* base = i < Xt ? xt + i : xr + (i - Xt);
      const size_t stride = i < Xt ? Xt : R;
      float ay[H], az[H];
#pragma unroll
      for (int h = 0; h < H; ++h) ay[h] = az[h] = 0.f;
      for (int j = part; j < K; j += p.L.py) {
        const float x = to_f(base[static_cast<size_t>(j) * stride]);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          ay[h] += lg[h * K + j] * x;
          az[h] += da[h * K + j] * x;
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        ypart[(part * H + h) * X + i] = ay[h];
        zpart[(part * H + h) * X + i] = az[h];
      }
    }
    __syncthreads();  // the dx step is done with u and w: they now take z and y
    float* prow = p.pbuf + static_cast<size_t>(s) * 2 * H * X1;
    for (int e = tid; e < H * X; e += kThreads) {
      const int h = e / X, i = e - h * X;
      float y = 0.f, z = 0.f;
      for (int part = 0; part < p.L.py; ++part) {
        y += ypart[(part * H + h) * X + i];
        z += zpart[(part * H + h) * X + i];
      }
      u[e] = z;
      wv[e] = y;
      prow[static_cast<size_t>(h) * X1 + i] = scale * z;            // k half
      prow[static_cast<size_t>(H + h) * X1 + i] = y;                // v half
    }
    if (tid < H) {  // row X: the constant input of the bias
      prow[static_cast<size_t>(tid) * X1 + X] = scale * stat[H + tid];
      prow[static_cast<size_t>(H + tid) * X1 + X] = stat[tid];
    }
    __syncthreads();

    // dq[d] = scale (z_h . W_k[:, d] + b_k[d] sum_j dl_hj [+ sum_j dl_hj k_jd]), in po partial sums
    {
      const int xc = (X + p.L.po - 1) / p.L.po, kc = (K + p.L.po - 1) / p.L.po;
      for (int e = tid; e < D * p.L.po; e += kThreads) {
        const int part = e / D, d = e - part * D, h = d / dh;
        float acc = 0.f;
        const int i1 = min(X, (part + 1) * xc);
        for (int i = part * xc; i < i1; ++i) acc += u[h * X + i] * to_f(wrow(i)[d]);
        if (MODE == kAttn) {
          const int j1 = min(K, (part + 1) * kc);
          for (int j = part * kc; j < j1; ++j) acc += da[h * K + j] * to_f(kp[(row0 + j) * p.ld_kv + d]);
        }
        dqpart[part * D + d] = acc;
      }
      __syncthreads();
      for (int d = tid; d < D; d += kThreads) {
        const int h = d / dh;
        float o = 0.f;
        for (int part = 0; part < p.L.po; ++part) o += dqpart[part * D + d];
        o += to_f(bias[d]) * stat[H + h];
        dqp[static_cast<size_t>(s) * D + d] = from_f<T>(scale * o);
      }
      __syncthreads();
    }
  }
}

// Weight gradients, pass 1: for one chunk of sources, one half (k or v) and one head h,
//   partial[chunk][i][half * D + h * dh + d] = sum_s pbuf[s][half][h][i] * r[s][h * dh + d]
// with r = q for the k half and r = g for the v half: a [X1, chunk] x [chunk, dh] product,
// in 64 x 32 output tiles, 16 sources at a time through shared memory.
constexpr int kWgThreads = 256, kTI = 64, kTC = 32, kTS = 16;

template <typename T>
__global__ void __launch_bounds__(kWgThreads)
    knarpe_wgrad_partial(const float* pbuf, const T* q, const T* g, float* partial, int n_src, int X1, int D,
                         int H, int src_per_chunk) {
  __shared__ float ps[kTS][kTI];
  __shared__ float rs[kTS][kTC];
  const int tid = threadIdx.x;
  const int dh = D / H, n_ct = (dh + kTC - 1) / kTC;
  const int i0 = blockIdx.x * kTI;
  const int bh = blockIdx.y / n_ct, ct = blockIdx.y - bh * n_ct;
  const int half = bh / H, h = bh - half * H, d0 = ct * kTC;
  const int s0 = blockIdx.z * src_per_chunk;
  const int s1 = min(n_src, s0 + src_per_chunk);
  const T* r = half ? g : q;
  const int ty = tid / 8, tx = tid % 8;  // rows 2ty, 2ty+1; columns 4tx .. 4tx+3
  float acc[2][4] = {};
  for (int sb = s0; sb < s1; sb += kTS) {
    for (int e = tid; e < kTS * kTI; e += kWgThreads) {
      const int ss = e / kTI, ii = e - ss * kTI, s = sb + ss, i = i0 + ii;
      ps[ss][ii] = (s < s1 && i < X1) ? pbuf[(static_cast<size_t>(s) * 2 * H + half * H + h) * X1 + i] : 0.f;
    }
    for (int e = tid; e < kTS * kTC; e += kWgThreads) {
      const int ss = e / kTC, cc = e - ss * kTC, s = sb + ss, d = d0 + cc;
      rs[ss][cc] = (s < s1 && d < dh) ? to_f(r[static_cast<size_t>(s) * D + h * dh + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ss = 0; ss < kTS; ++ss) {
      const float p0 = ps[ss][2 * ty], p1 = ps[ss][2 * ty + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float rv = rs[ss][4 * tx + c];
        acc[0][c] += p0 * rv;
        acc[1][c] += p1 * rv;
      }
    }
    __syncthreads();
  }
  const int D2 = 2 * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + 2 * ty + rr;
    if (i >= X1) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + 4 * tx + c;
      if (d < dh)
        partial[(static_cast<size_t>(blockIdx.z) * X1 + i) * D2 + half * D + h * dh + d] = acc[rr][c];
    }
  }
}

// Weight gradients, pass 2: the chunks' partial sums added in chunk order, rounded to T:
// rows [0, Xt) -> dW_kv, [Xt, X) -> dW_rpe, row X -> db.
template <typename T>
__global__ void knarpe_wgrad_reduce(const float* partial, int n_chunks, int X1, int Xt, int D2, T* dw_kv,
                                    T* dw_rpe, T* db) {
  const size_t n = static_cast<size_t>(X1) * D2;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += partial[static_cast<size_t>(c) * n + e];
    const int i = static_cast<int>(e / D2), col = static_cast<int>(e - static_cast<size_t>(i) * D2);
    if (i < Xt)
      dw_kv[static_cast<size_t>(i) * D2 + col] = from_f<T>(acc);
    else if (i < X1 - 1)
      dw_rpe[static_cast<size_t>(i - Xt) * D2 + col] = from_f<T>(acc);
    else
      db[col] = from_f<T>(acc);
  }
}

// The two weight-gradient passes over pbuf, after any per-source kernel (a staged one or the one
// above): dW_kv, dW_rpe and db.
template <typename T>
int wgrad_launch(const Params& p, int H, void* dw_kv, void* dw_rpe, void* db, float* partial, int n_chunks,
                 cudaStream_t stream) {
  const int X1 = p.d_tgt + p.d_rpe + 1, D = p.d_model, dh = D / H;
  const int src_per_chunk = (p.n_src + n_chunks - 1) / n_chunks;
  const dim3 wg_grid((X1 + kTI - 1) / kTI, 2 * H * ((dh + kTC - 1) / kTC), n_chunks);
  knarpe_wgrad_partial<T><<<wg_grid, kWgThreads, 0, stream>>>(
      p.pbuf, static_cast<const T*>(p.q), static_cast<const T*>(p.g), partial, p.n_src, X1, D, H, src_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = static_cast<long long>(X1) * 2 * D;
  const int red_grid = static_cast<int>((n_out + 255) / 256 < 1024 ? (n_out + 255) / 256 : 1024);
  knarpe_wgrad_reduce<T><<<red_grid, 256, 0, stream>>>(partial, n_chunks, X1, p.d_tgt, 2 * D,
                                                       static_cast<T*>(dw_kv), static_cast<T*>(dw_rpe),
                                                       static_cast<T*>(db));
  return static_cast<int>(cudaGetLastError());
}

// What a launch needs besides its pointers, worked out once per (device, K, D, X).
struct Plan {
  int dev, n_knn, d_model, x;
  int ldw, resident;
  Layout L;
  long long slots;  // resident per-source blocks on the whole device
};

template <typename T, int MODE, int H>
int make_plan(Plan& pl) {
  pl.ldw = 2 * pl.d_model;  // padded smem row: an odd number of 32-bit words
  if ((pl.ldw * sizeof(T) / 4) % 2 == 0) pl.ldw += static_cast<int>(4 / sizeof(T));
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.resident = 1;
  pl.L = make_layout(sizeof(T), pl.n_knn, pl.d_model, pl.x, H, 1, pl.ldw);
  if (pl.L.total > static_cast<size_t>(max_smem)) {
    pl.resident = 0;
    pl.L = make_layout(sizeof(T), pl.n_knn, pl.d_model, pl.x, H, 0, pl.ldw);
  }
  if (pl.L.total > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = knarpe_bwd_kernel<T, MODE, H>;
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
int launch_t(Params p, void* dw_kv, void* dw_rpe, void* db, float* partial, int n_chunks, int dev,
             cudaStream_t stream) {
  static std::mutex mu;
  static std::vector<Plan> plans;
  const int X = p.d_tgt + p.d_rpe;
  Plan pl{};
  {
    std::lock_guard<std::mutex> lock(mu);
    bool found = false;
    for (const Plan& c : plans) {
      if (c.dev == dev && c.n_knn == p.n_knn && c.d_model == p.d_model && c.x == X) {
        pl = c;
        found = true;
        break;
      }
    }
    if (!found) {
      pl.dev = dev; pl.n_knn = p.n_knn; pl.d_model = p.d_model; pl.x = X;
      const int rc = make_plan<T, MODE, H>(pl);
      if (rc != 0) return rc;
      plans.push_back(pl);
    }
  }
  p.ldw = pl.ldw;
  p.resident = pl.resident;
  p.L = pl.L;
  const int grid = static_cast<int>(p.n_src < pl.slots ? p.n_src : pl.slots);
  knarpe_bwd_kernel<T, MODE, H><<<grid, kThreads, p.L.total, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wgrad_launch<T>(p, H, dw_kv, dw_rpe, db, partial, n_chunks, stream);
}

template <typename T, int MODE>
int by_heads(const Params& p, int n_head, void* dw_kv, void* dw_rpe, void* db, float* partial, int n_chunks,
             int dev, cudaStream_t stream) {
  switch (n_head) {
    case 1: return launch_t<T, MODE, 1>(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    case 2: return launch_t<T, MODE, 2>(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    case 4: return launch_t<T, MODE, 4>(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    case 8: return launch_t<T, MODE, 8>(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_mode(const Params& p, int mode, int n_head, void* dw_kv, void* dw_rpe, void* db, float* partial,
            int n_chunks, int dev, cudaStream_t stream) {
  switch (mode) {
    case kAttn: return by_heads<T, kAttn>(p, n_head, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    case kCross: return by_heads<T, kCross>(p, n_head, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The staged kernel's plan per (device, K, D, R) and head count: its refusal code
// (staged_bwd::refusal; 0 = taken, 5 = no block fits an SM), layout and resident blocks on the device.
struct StagedPlan {
  int dev, n_knn, d_model, d_rpe, refused;
  staged_bwd::Layout L;
  long long slots;
};

template <int H>
int make_staged_plan(StagedPlan& pl) {
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.refused = staged_bwd::refusal(pl.n_knn, pl.d_model, pl.d_rpe, H, static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  pl.L = staged_bwd::make_layout(pl.n_knn, pl.d_model, pl.d_rpe, H);
  auto kern = staged_bwd::knarpe_x_bwd_staged_kernel<H>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, staged_bwd::kThreads, pl.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) pl.refused = 5;
  pl.slots = static_cast<long long>(per_sm) * n_sm;
  return 0;
}

template <int H>
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
  const int rc = make_staged_plan<H>(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

// The staged kernel's code for a bf16 B2 backward shape: 0 if it takes the shape, else
// staged_bwd::refusal's code (5: no block fits an SM), or minus a CUDA error; -1 for a head count
// the wrapper does not take. Eight heads are refused (3) without asking the device.
int staged_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  StagedPlan pl{};
  int rc = 0;
  switch (n_head) {
    case 1: rc = staged_plan<1>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 2: rc = staged_plan<2>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 4: rc = staged_plan<4>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 8: return staged_bwd::refusal(n_knn, d_model, d_rpe, 8, SIZE_MAX);
    default: return -1;
  }
  return rc != 0 ? -rc : pl.refused;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// Launches the staged kernel, then the weight-gradient passes; a shape it refuses, or an operand
// that is not 16-byte aligned (the copies and the dx stores move 16-byte chunks), is
// cudaErrorInvalidValue.
template <int H>
int staged_launch(const Params& g, void* dw_kv, void* dw_rpe, void* db, float* partial, int n_chunks, int dev,
                  cudaStream_t stream) {
  StagedPlan pl{};
  const int rc = staged_plan<H>(dev, g.n_knn, g.d_model, g.d_rpe, &pl);
  if (rc != 0) return rc;
  if (pl.refused || !(aligned16(g.q) && aligned16(g.g) && aligned16(g.tgt) && aligned16(g.rpe) &&
                      aligned16(g.w_kv) && aligned16(g.w_rpe) && aligned16(g.bias) && aligned16(g.dtgt) &&
                      aligned16(g.drpe)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  staged_bwd::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.g = static_cast<const bf16*>(g.g);
  p.tgt = static_cast<const bf16*>(g.tgt);
  p.rpe = static_cast<const bf16*>(g.rpe);
  p.w_kv = static_cast<const bf16*>(g.w_kv);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.dq = static_cast<bf16*>(g.dq);
  p.dtgt = static_cast<bf16*>(g.dtgt);
  p.drpe = static_cast<bf16*>(g.drpe);
  p.pbuf = g.pbuf;
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.d_model = g.d_model; p.scale = g.scale;
  p.d_rpe = staged::rpe_cols(g.d_rpe);
  p.r_in = g.d_rpe;
  p.mw = staged::swizzle_mask(g.d_model / 4);
  p.L = pl.L;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_t, g.tgt, n_rows, g.d_model, g.d_model, g.n_knn);
  // narrow rpe rows (8 bytes, no tensor map's row stride) come in by cp.async instead
  if (enc == 0 && p.r_in == p.d_rpe) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, g.d_rpe, g.d_rpe, g.n_knn);
  if (enc != 0) return enc;
  const int grid = static_cast<int>(g.n_src < pl.slots ? g.n_src : pl.slots);
  staged_bwd::knarpe_x_bwd_staged_kernel<H><<<grid, staged_bwd::kThreads, p.L.total, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wgrad_launch<bf16>(g, H, dw_kv, dw_rpe, db, partial, n_chunks, stream);
}

// The heads B2 backward's plan per (device, K): its refusal code (heads_x_bwd::refusal; 0 = taken, 4 = no block fits an
// SM), layout, the slots of eight blocks (one per head) resident on the device, and the SMs.
struct XHeadsPlan {
  int dev, n_knn, refused, n_sm;
  heads_x_bwd::Layout L;
  long long slots;
};

int make_x_heads_plan(XHeadsPlan& pl) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&pl.n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int W = heads_x_bwd::kWidth;
  pl.refused = heads_x_bwd::refusal(pl.n_knn, W, W, heads_x_bwd::kHeads, static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  auto kern = heads_x_bwd::knarpe_x_bwd_heads_kernel;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.L = heads_x_bwd::make_layout(pl.n_knn);
  int per_sm = 0;  // two where two blocks fit an SM (K <= 32 on an H100), else one
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, heads_x_bwd::kThreads, pl.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.slots = static_cast<long long>(per_sm) * pl.n_sm / heads_x_bwd::kHeads;
  if (pl.slots < 1) pl.refused = 4;
  return 0;
}

int x_heads_plan(int dev, int K, XHeadsPlan* out) {
  static std::mutex mu;
  static std::vector<XHeadsPlan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const XHeadsPlan& c : plans) {
    if (c.dev == dev && c.n_knn == K) {
      *out = c;
      return 0;
    }
  }
  XHeadsPlan pl{};
  pl.dev = dev; pl.n_knn = K;
  const int rc = make_x_heads_plan(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

// The heads B2 backward's code for a bf16 B2 backward shape: 0 if it takes the shape, else heads_x_bwd::refusal's code
// (2 for widths it is not compiled for, without asking the device; 4: no block fits an SM), or minus a CUDA error.
int x_heads_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  const int code = heads_x_bwd::refusal(n_knn, d_model, d_rpe, n_head, SIZE_MAX);
  if (code != 0) return code;
  XHeadsPlan pl{};
  const int rc = x_heads_plan(dev, n_knn, &pl);
  return rc != 0 ? -rc : pl.refused;
}

// Launches the heads B2 backward, its dx pass, then the weight-gradient passes, at a shape x_heads_code takes; an
// operand or output that is not 16-byte aligned (the tensor copies and the 16-byte loads need it) is
// cudaErrorInvalidValue. dx's factors go into pbuf past its [n_src, 2, H, X + 1] rows: the caller gives pbuf
// heads_x_bwd::fac_floats(K) more floats a source.
int x_heads_launch(const Params& g, void* dw_kv, void* dw_rpe, void* db, float* partial, int n_chunks, int dev,
                   cudaStream_t stream) {
  XHeadsPlan pl{};
  const int rc = x_heads_plan(dev, g.n_knn, &pl);
  if (rc != 0) return rc;
  if (pl.refused || !(aligned16(g.q) && aligned16(g.g) && aligned16(g.tgt) && aligned16(g.rpe) && aligned16(g.w_kv) &&
                      aligned16(g.w_rpe) && aligned16(g.bias) && aligned16(g.dtgt) && aligned16(g.drpe)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  constexpr int D = heads_x_bwd::kWidth;
  heads_x_bwd::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.g = static_cast<const bf16*>(g.g);
  p.tgt = static_cast<const bf16*>(g.tgt);
  p.rpe = static_cast<const bf16*>(g.rpe);
  p.w_kv = static_cast<const bf16*>(g.w_kv);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.dq = static_cast<bf16*>(g.dq);
  p.pbuf = g.pbuf;
  p.fac = g.pbuf + static_cast<size_t>(g.n_src) * 2 * heads_x_bwd::kHeads * heads_x_bwd::kX1;
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.scale = g.scale;
  p.L = pl.L;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_t, g.tgt, n_rows, D, D, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, D, D, g.n_knn);
  if (enc != 0) return enc;
  const long long n_slots = g.n_src < pl.slots ? g.n_src : pl.slots;
  const int grid = static_cast<int>(heads_x_bwd::kHeads * n_slots);
  heads_x_bwd::knarpe_x_bwd_heads_kernel<<<grid, heads_x_bwd::kThreads, p.L.total, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(g.n_src) * ((g.n_knn + heads_x_bwd::kDxRows - 1) / heads_x_bwd::kDxRows);
  const int dx_grid = static_cast<int>(items < 8LL * pl.n_sm ? items : 8LL * pl.n_sm);
  heads_x_bwd::knarpe_x_bwd_heads_dx<<<dx_grid, heads_x_bwd::kDxThreads, 0, stream>>>(
      p.fac, static_cast<bf16*>(g.dtgt), static_cast<bf16*>(g.drpe), g.n_src, g.n_knn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wgrad_launch<bf16>(g, heads_x_bwd::kHeads, dw_kv, dw_rpe, db, partial, n_chunks, stream);
}

// bf16 B2-bwd: the staged kernel where it takes the shape; else the heads kernel where it takes the shape; else the
// general kernel above.
int bf16_cross(const Params& p, int n_head, void* dw_kv, void* dw_rpe, void* db, float* partial, int n_chunks,
               int dev, cudaStream_t stream) {
  const int code = staged_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev);
  if (code < 0) return code == -1 ? static_cast<int>(cudaErrorInvalidValue) : -code;
  if (code != 0) {
    const int heads = x_heads_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev);
    if (heads < 0) return -heads;
    if (heads == 0) return x_heads_launch(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    return by_heads<__nv_bfloat16, kCross>(p, n_head, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
  }
  switch (n_head) {
    case 1: return staged_launch<1>(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    case 2: return staged_launch<2>(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
    default: return staged_launch<4>(p, dw_kv, dw_rpe, db, partial, n_chunks, dev, stream);
  }
}

// The staged B4 backward's plan per (device, K, D, R) and head count: its refusal code
// (staged_attn_bwd::refusal; 0 = taken, 5 = no block fits an SM), layout and resident blocks on the device.
struct AttnPlan {
  int dev, n_knn, d_model, d_rpe, refused;
  staged_attn_bwd::Layout L;
  long long slots;
};

template <int H>
int make_attn_plan(AttnPlan& pl) {
  int max_smem = 0, n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.refused = staged_attn_bwd::refusal(pl.n_knn, pl.d_model, pl.d_rpe, H, static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  pl.L = staged_attn_bwd::make_layout(pl.n_knn, pl.d_model, pl.d_rpe, H,
                                      staged_attn_bwd::stage_count(pl.n_knn, pl.d_model, pl.d_rpe, H, max_smem));
  auto kern = staged_attn_bwd::knarpe_attn_bwd_staged_kernel<H>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, staged_attn_bwd::kThreads, pl.L.total);
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

// The staged kernel's code for a bf16 B4 backward shape: 0 if it takes the shape, else
// staged_attn_bwd::refusal's code (5: no block fits an SM), or minus a CUDA error; -1 for a head count
// the wrapper does not take. Eight heads are refused (3) without asking the device.
int attn_staged_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  AttnPlan pl{};
  int rc = 0;
  switch (n_head) {
    case 1: rc = attn_plan<1>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 2: rc = attn_plan<2>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 4: rc = attn_plan<4>(dev, n_knn, d_model, d_rpe, &pl); break;
    case 8: return staged_attn_bwd::refusal(n_knn, d_model, d_rpe, 8, SIZE_MAX);
    default: return -1;
  }
  return rc != 0 ? -rc : pl.refused;
}

// Launches the staged B4 backward, then the weight-gradient passes; a shape it refuses, an operand or
// output that is not 16-byte aligned, or a k/v row stride that is no multiple of 16 bytes is
// cudaErrorInvalidValue.
template <int H>
int attn_staged_launch(const Params& g, void* dw_rpe, void* db, float* partial, int n_chunks, int dev,
                       cudaStream_t stream) {
  AttnPlan pl{};
  const int rc = attn_plan<H>(dev, g.n_knn, g.d_model, g.d_rpe, &pl);
  if (rc != 0) return rc;
  if (pl.refused || (g.ld_kv * 2) % 16 ||
      !(aligned16(g.q) && aligned16(g.g) && aligned16(g.k) && aligned16(g.v) && aligned16(g.rpe) &&
        aligned16(g.w_rpe) && aligned16(g.bias) && aligned16(g.dk) && aligned16(g.dv) && aligned16(g.drpe)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  staged_attn_bwd::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.g = static_cast<const bf16*>(g.g);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.dq = static_cast<bf16*>(g.dq);
  p.dk = static_cast<bf16*>(g.dk);
  p.dv = static_cast<bf16*>(g.dv);
  p.drpe = static_cast<bf16*>(g.drpe);
  p.pbuf = g.pbuf;
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.d_model = g.d_model; p.d_rpe = g.d_rpe; p.scale = g.scale;
  p.mw = staged::swizzle_mask(g.d_model / 4);
  p.L = pl.L;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_k, g.k, n_rows, g.d_model, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_v, g.v, n_rows, g.d_model, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, g.d_rpe, g.d_rpe, g.n_knn);
  if (enc != 0) return enc;
  const int grid = static_cast<int>(g.n_src < pl.slots ? g.n_src : pl.slots);
  staged_attn_bwd::knarpe_attn_bwd_staged_kernel<H><<<grid, staged_attn_bwd::kThreads, p.L.total, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wgrad_launch<bf16>(g, H, nullptr, dw_rpe, db, partial, n_chunks, stream);
}

// The heads B4 backward's plan per (device, K): its refusal code (heads_attn_bwd::refusal; 0 = taken, 4 = no block
// fits an SM), layout, the slots of four blocks (one per quarter of the heads) resident on the device, and the SMs.
struct AttnHeadsPlan {
  int dev, n_knn, refused, n_sm;
  heads_attn_bwd::Layout L;
  long long slots;
};

int make_attn_heads_plan(AttnHeadsPlan& pl) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&pl.n_sm, cudaDevAttrMultiProcessorCount, pl.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int W = heads_attn_bwd::kWidth;
  pl.refused = heads_attn_bwd::refusal(pl.n_knn, W, W, heads_attn_bwd::kHeads, static_cast<size_t>(max_smem));
  if (pl.refused) return 0;
  pl.L = heads_attn_bwd::make_layout(pl.n_knn, heads_attn_bwd::group_count(pl.n_knn, static_cast<size_t>(max_smem)));
  auto kern = heads_attn_bwd::knarpe_attn_bwd_heads_kernel;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);  // as make_plan
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, heads_attn_bwd::kGroupThreads * pl.L.n_groups,
                                                      pl.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.slots = static_cast<long long>(per_sm) * pl.n_sm / heads_attn_bwd::kSplit;
  if (pl.slots < 1) pl.refused = 4;
  return 0;
}

int attn_heads_plan(int dev, int K, AttnHeadsPlan* out) {
  static std::mutex mu;
  static std::vector<AttnHeadsPlan> plans;
  std::lock_guard<std::mutex> lock(mu);
  for (const AttnHeadsPlan& c : plans) {
    if (c.dev == dev && c.n_knn == K) {
      *out = c;
      return 0;
    }
  }
  AttnHeadsPlan pl{};
  pl.dev = dev; pl.n_knn = K;
  const int rc = make_attn_heads_plan(pl);
  if (rc != 0) return rc;
  plans.push_back(pl);
  *out = pl;
  return 0;
}

// The heads B4 backward's code for a bf16 B4 backward shape: 0 if it takes the shape, else heads_attn_bwd::refusal's
// code (2 for widths it is not compiled for, without asking the device; 4: no block fits an SM), or minus a CUDA error.
int attn_heads_code(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  const int code = heads_attn_bwd::refusal(n_knn, d_model, d_rpe, n_head, SIZE_MAX);
  if (code != 0) return code;
  AttnHeadsPlan pl{};
  const int rc = attn_heads_plan(dev, n_knn, &pl);
  return rc != 0 ? -rc : pl.refused;
}

// Launches the heads B4 backward, its drpe pass, then the weight-gradient passes, at a shape attn_heads_code takes;
// an operand or output that is not 16-byte aligned, or a k/v row stride that is no multiple of 16 bytes (the tensor
// copies and the 16-byte stores need both), is cudaErrorInvalidValue. drpe's factors go into pbuf past its
// [n_src, 2, H, R + 1] rows: the caller gives pbuf heads_attn_bwd::fac_floats(K) more floats a source.
int attn_heads_launch(const Params& g, void* dw_rpe, void* db, float* partial, int n_chunks, int dev,
                      cudaStream_t stream) {
  AttnHeadsPlan pl{};
  const int rc = attn_heads_plan(dev, g.n_knn, &pl);
  if (rc != 0) return rc;
  if (pl.refused || (g.ld_kv * 2) % 16 ||
      !(aligned16(g.q) && aligned16(g.g) && aligned16(g.k) && aligned16(g.v) && aligned16(g.rpe) &&
        aligned16(g.w_rpe) && aligned16(g.bias) && aligned16(g.dk) && aligned16(g.dv) && aligned16(g.drpe)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  constexpr int D = heads_attn_bwd::kWidth;
  heads_attn_bwd::Params p{};
  p.q = static_cast<const bf16*>(g.q);
  p.g = static_cast<const bf16*>(g.g);
  p.w_rpe = static_cast<const bf16*>(g.w_rpe);
  p.bias = static_cast<const bf16*>(g.bias);
  p.invalid = g.invalid;
  p.dq = static_cast<bf16*>(g.dq);
  p.dk = static_cast<bf16*>(g.dk);
  p.dv = static_cast<bf16*>(g.dv);
  p.pbuf = g.pbuf;
  p.fac = g.pbuf + static_cast<size_t>(g.n_src) * 2 * heads_attn_bwd::kHeads * heads_attn_bwd::kR1;
  p.n_src = g.n_src; p.n_knn = g.n_knn; p.scale = g.scale;
  p.L = pl.L;
  const long long n_rows = static_cast<long long>(g.n_src) * g.n_knn;
  int enc = staged::encode_rows(&p.tm_k, g.k, n_rows, D, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_v, g.v, n_rows, D, g.ld_kv, g.n_knn);
  if (enc == 0) enc = staged::encode_rows(&p.tm_r, g.rpe, n_rows, D, D, g.n_knn);
  if (enc != 0) return enc;
  const long long n_slots = g.n_src < pl.slots ? g.n_src : pl.slots;
  const int grid = static_cast<int>(heads_attn_bwd::kSplit * n_slots);
  heads_attn_bwd::knarpe_attn_bwd_heads_kernel<<<grid, heads_attn_bwd::kGroupThreads * p.L.n_groups, p.L.total,
                                                 stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int drpe_grid = g.n_src < 8 * pl.n_sm ? g.n_src : 8 * pl.n_sm;
  heads_attn_bwd::knarpe_attn_bwd_heads_drpe<<<drpe_grid, heads_attn_bwd::kDrpeThreads, 0, stream>>>(
      p.fac, static_cast<bf16*>(g.drpe), g.n_src, g.n_knn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wgrad_launch<bf16>(g, heads_attn_bwd::kHeads, nullptr, dw_rpe, db, partial, n_chunks, stream);
}

// bf16 B4-bwd: the staged kernel where it takes the shape; else the heads kernel where it takes the shape; else the
// general kernel above.
int bf16_attn(const Params& p, int n_head, void* dw_rpe, void* db, float* partial, int n_chunks, int dev,
              cudaStream_t stream) {
  const int code = attn_staged_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev);
  if (code < 0) return code == -1 ? static_cast<int>(cudaErrorInvalidValue) : -code;
  if (code != 0) {
    const int heads = attn_heads_code(p.n_knn, p.d_model, p.d_rpe, n_head, dev);
    if (heads < 0) return -heads;
    if (heads == 0) return attn_heads_launch(p, dw_rpe, db, partial, n_chunks, dev, stream);
    return by_heads<__nv_bfloat16, kAttn>(p, n_head, nullptr, dw_rpe, db, partial, n_chunks, dev, stream);
  }
  switch (n_head) {
    case 1: return attn_staged_launch<1>(p, dw_rpe, db, partial, n_chunks, dev, stream);
    case 2: return attn_staged_launch<2>(p, dw_rpe, db, partial, n_chunks, dev, stream);
    default: return attn_staged_launch<4>(p, dw_rpe, db, partial, n_chunks, dev, stream);
  }
}

// The body of knarpe_bwd_launch; with general, bf16 takes the general kernel too (knarpe_bwd_general_launch).
int launch_bwd(bool general, int mode, int dtype, const void* q, const void* k, const void* v, long long ld_kv,
               const void* tgt, const void* rpe, const void* invalid, const void* w_kv, const void* w_rpe,
               const void* bias, const void* g, void* dq, void* dk, void* dv, void* dtgt, void* drpe, void* dw_kv,
               void* dw_rpe, void* db, void* pbuf, void* partial, int n_src, int n_knn, int d_model, int d_tgt,
               int d_rpe, int n_head, float scale, int n_chunks, int dev, void* stream) {
  // a calling thread with no current context yet (an autograd worker that has issued no CUDA call) gets the
  // device's: cuTensorMapEncodeTiled, which encodes the tensor maps, refuses to run without one
  const cudaError_t set = cudaSetDevice(dev);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{};
  p.q = q; p.k = k; p.v = v; p.ld_kv = ld_kv; p.tgt = tgt; p.rpe = rpe;
  p.invalid = static_cast<const uint8_t*>(invalid);
  p.w_kv = w_kv; p.w_rpe = w_rpe; p.bias = bias; p.g = g;
  p.dq = dq; p.dk = dk; p.dv = dv; p.dtgt = dtgt; p.drpe = drpe;
  p.pbuf = static_cast<float*>(pbuf);
  p.n_src = n_src; p.n_knn = n_knn; p.d_model = d_model; p.d_tgt = d_tgt; p.d_rpe = d_rpe; p.scale = scale;
  if (n_chunks < 1 || n_src < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) return by_mode<float>(p, mode, n_head, dw_kv, dw_rpe, db, part, n_chunks, dev, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!general && mode == kCross) return bf16_cross(p, n_head, dw_kv, dw_rpe, db, part, n_chunks, dev, st);
  if (!general && mode == kAttn) return bf16_attn(p, n_head, dw_rpe, db, part, n_chunks, dev, st);
  return by_mode<__nv_bfloat16>(p, mode, n_head, dw_kv, dw_rpe, db, part, n_chunks, dev, st);
}

}  // namespace

// Device pointers of tensors laid out as in ops/knarpe.py; dtype 0 = float32, 1 = bf16
// for every operand and gradient. B4 (mode 0) reads k/v rows of D elements at stride
// ld_kv, writes dk/dv [n_src * K, D] and no dtgt / dw_kv (d_tgt = 0); B2 (mode 1) reads
// tgt and w_kv and writes dtgt and dw_kv. pbuf is float32 scratch [n_src, 2, H, X + 1],
// partial float32 scratch [n_chunks, X + 1, 2D] (X = d_tgt + d_rpe); a bf16 B4 launch at a shape
// knarpe_attn_bwd_heads_route takes needs pbuf n_src * (K * 16 + 16 * R) floats longer (the
// drpe factors of knarpe_attn_bwd_heads.cuh), a bf16 B2 launch at a shape knarpe_x_bwd_heads_route
// takes n_src * (K * 16 + 16 * X) (the dx factors of knarpe_bwd_heads.cuh); n_chunks >= 1 and
// n_src >= 1. n_head in {1, 2, 4, 8}, d_model even and divisible by n_head (checked by
// the Python wrapper). dev is the current device, which owns the tensors and the
// stream. bf16 B2 and B4 at a shape the staged or heads kernel takes need 16-byte aligned
// operands and outputs (checked by the Python wrapper, which also names the
// route: knarpe_bwd_staged_route, then knarpe_attn_bwd_heads_route or knarpe_x_bwd_heads_route).
// Three kernels are queued on the stream (four on the heads routes: the drpe or dx pass);
// returns cudaGetLastError(), or cudaErrorInvalidValue for a launch no kernel takes.
extern "C" int knarpe_bwd_launch(int mode, int dtype, const void* q, const void* k, const void* v, long long ld_kv,
                                 const void* tgt, const void* rpe, const void* invalid, const void* w_kv,
                                 const void* w_rpe, const void* bias, const void* g, void* dq, void* dk, void* dv,
                                 void* dtgt, void* drpe, void* dw_kv, void* dw_rpe, void* db, void* pbuf,
                                 void* partial, int n_src, int n_knn, int d_model, int d_tgt, int d_rpe,
                                 int n_head, float scale, int n_chunks, int dev, void* stream) {
  return launch_bwd(false, mode, dtype, q, k, v, ld_kv, tgt, rpe, invalid, w_kv, w_rpe, bias, g, dq, dk, dv, dtgt,
                    drpe, dw_kv, dw_rpe, db, pbuf, partial, n_src, n_knn, d_model, d_tgt, d_rpe, n_head, scale,
                    n_chunks, dev, stream);
}

// knarpe_bwd_launch on the general kernel whatever route the shape takes, so that a measurement can time it beside
// the staged or heads kernel at the same shape (chip_smoke.py phase 3); the port never calls it.
extern "C" int knarpe_bwd_general_launch(int mode, int dtype, const void* q, const void* k, const void* v,
                                         long long ld_kv, const void* tgt, const void* rpe, const void* invalid,
                                         const void* w_kv, const void* w_rpe, const void* bias, const void* g,
                                         void* dq, void* dk, void* dv, void* dtgt, void* drpe, void* dw_kv,
                                         void* dw_rpe, void* db, void* pbuf, void* partial, int n_src, int n_knn,
                                         int d_model, int d_tgt, int d_rpe, int n_head, float scale, int n_chunks,
                                         int dev, void* stream) {
  return launch_bwd(true, mode, dtype, q, k, v, ld_kv, tgt, rpe, invalid, w_kv, w_rpe, bias, g, dq, dk, dv, dtgt,
                    drpe, dw_kv, dw_rpe, db, pbuf, partial, n_src, n_knn, d_model, d_tgt, d_rpe, n_head, scale,
                    n_chunks, dev, stream);
}

// Whether a staged backward takes a bf16 launch at this shape on device dev, given 16-byte aligned
// operands (and, for B4, a k/v row stride that is a multiple of 16 bytes): 0 if it does, else the refusal
// code of knarpe_attn_bwd_staged.cuh (B4-bwd, mode 0; staged_attn_bwd::refusal) or knarpe_bwd_staged.cuh
// (B2-bwd, mode 1; staged_bwd::refusal), 5 for either when no block fits an SM, or minus a CUDA error; -1
// for any other mode or dtype. knarpe_bwd_launch runs bf16 launches on the staged kernel where this is 0
// and on the general kernel otherwise.
extern "C" int knarpe_bwd_staged_route(int mode, int dtype, int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  if (dtype != 1) return -1;
  if (mode == kAttn) return attn_staged_code(n_knn, d_model, d_rpe, n_head, dev);
  if (mode != kCross) return -1;
  return staged_code(n_knn, d_model, d_rpe, n_head, dev);
}

// Whether the heads kernel of knarpe_attn_bwd_heads.cuh takes a bf16 B4 backward at this shape on device dev, given
// 16-byte aligned operands and outputs and a k/v row stride that is a multiple of 16 bytes: 0 if it does, else
// heads_attn_bwd::refusal's code (2: widths other than d_model = d_rpe = 256 with 8 heads; 1: K outside [1, 64]; 3:
// four stages exceed the shared memory; 4: no block fits an SM), or minus a CUDA error. knarpe_bwd_launch runs a
// bf16 B4 backward that knarpe_bwd_staged_route refuses on the heads kernel where this is 0, and on the general
// kernel otherwise.
extern "C" int knarpe_attn_bwd_heads_route(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  return attn_heads_code(n_knn, d_model, d_rpe, n_head, dev);
}

// Whether the heads kernel of knarpe_bwd_heads.cuh takes a bf16 B2 (or B3) backward at this shape on device dev, given
// 16-byte aligned operands and outputs: 0 if it does, else heads_x_bwd::refusal's code (2: widths other than d_model =
// d_rpe = 256 with 8 heads; 1: K outside [1, 128]; 3: one source stage exceeds the shared memory; 4: no block fits an
// SM), or minus a CUDA error. knarpe_bwd_launch runs a bf16 B2 backward that knarpe_bwd_staged_route refuses on the
// heads kernel where this is 0, and on the general kernel otherwise.
extern "C" int knarpe_x_bwd_heads_route(int n_knn, int d_model, int d_rpe, int n_head, int dev) {
  return x_heads_code(n_knn, d_model, d_rpe, n_head, dev);
}
