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
//     [W_kv; W_rpe] are staged once per block in shared memory (bf16 B2:
//     132 KB, rows padded to an odd word count so that a warp reading a
//     column is free of bank conflicts); when they do not fit (float32 B2)
//     they are read through L1/L2 instead;
//   - x_j is read straight from device memory twice per source (logits, then
//     y); while a source is computed, the block prefetches its next source's
//     inputs into L2, so the second read and the next source's first read
//     hit L2.
// B3 keeps the explicit k half (its roundings need kk itself): K x D dot
// products of length X per source on the CUDA cores, ~2.9 M multiply-adds
// per source, so it is bound by operations, not bytes. The block stages the
// source's [K, X] inputs in shared memory and each thread accumulates a 4 x 4
// tile of kk (4 targets x 4 columns of one head) in registers, 16 FMAs for 8
// shared-memory loads. Only a script reaches B3 in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kMask = -1e9f;
enum Mode { kAttn = 0, kCross = 1, kCrossV3 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

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

// Byte offsets into the dynamic shared memory of one block.
struct Layout {
  size_t w, qs, inv, u, c, asum, nv, lg, ypart, opart, xs, kpart, total;
  int py, po;  // partial sums per output element in the y and out steps
};

Layout make_layout(int mode, size_t elem, int K, int D, int X, int H, int resident, int ldw) {
  Layout L{};
  size_t off = 0;
  L.w = off;
  off += resident ? align16(static_cast<size_t>(X) * ldw * elem) : 0;
  L.qs = off;   off += align16(static_cast<size_t>(D) * 4);
  L.inv = off;  off += align16(static_cast<size_t>(K));
  L.u = off;    off += align16(static_cast<size_t>(H) * X * 4);
  L.c = off;    off += align16(static_cast<size_t>(H) * 4);
  L.asum = off; off += align16(static_cast<size_t>(H) * 4);
  L.nv = off;   off += align16(static_cast<size_t>(H) * 4);
  L.lg = off;   off += align16(static_cast<size_t>(H) * K * 4);
  L.py = X < kThreads ? kThreads / X : 1;
  L.ypart = off; off += align16(static_cast<size_t>(L.py) * H * X * 4);
  L.po = D < kThreads ? kThreads / D : 1;
  L.opart = off; off += align16(static_cast<size_t>(L.po) * D * 4);
  L.xs = off;  // B3: the source's inputs [K, X], then per-tile partial logits [K, D / 4]
  if (mode == kCrossV3) off += align16(static_cast<size_t>(K) * X * elem);
  L.kpart = off;
  if (mode == kCrossV3) off += align16(static_cast<size_t>(K) * (D / 4) * 4);
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
      for (int e = tid; e < K * X; e += kThreads) {
        const int j = e / X, i = e - j * X;
        xs[e] = i < Xt ? xt[static_cast<size_t>(j) * Xt + i] : xr[static_cast<size_t>(j) * R + (i - Xt)];
      }
      __syncthreads();
      const int n_dt = D / 4, n_jt = (K + 3) / 4;  // 4 x 4 tiles; dh % 4 == 0, so a tile stays in one head
      for (int t = tid; t < n_jt * n_dt; t += kThreads) {
        const int jt = t / n_dt, dt = t - jt * n_dt, d0 = 4 * dt;
        int rows[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rows[r] = min(4 * jt + r, K - 1) * X;
        // tgt @ W_kv and rpe @ W_rpe summed apart, then added, in _x3_fwd_kernel's order
        float acc_t[4][4] = {}, acc[4][4] = {};
        auto mac = [&](int i, float (&a)[4][4]) {
          const T* wr = wrow(i) + d0;
          float w[4], x[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) w[c] = to_f(wr[c]);
#pragma unroll
          for (int r = 0; r < 4; ++r) x[r] = to_f(xs[rows[r] + i]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) a[r][c] += x[r] * w[c];
        };
        for (int i = 0; i < Xt; ++i) mac(i, acc_t);
        for (int i = Xt; i < X; ++i) mac(i, acc);
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
  int ldw, resident;
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
  pl.resident = 1;
  pl.L = make_layout(MODE, sizeof(T), pl.n_knn, pl.d_model, pl.x, H, 1, pl.ldw);
  if (pl.L.total > static_cast<size_t>(max_smem)) {
    pl.resident = 0;
    pl.L = make_layout(MODE, sizeof(T), pl.n_knn, pl.d_model, pl.x, H, 0, pl.ldw);
  }
  if (pl.L.total > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
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
int launch_t(Params p, int dev, cudaStream_t stream) {
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
  knarpe_kernel<T, MODE, H><<<grid, kThreads, p.L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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

template <typename T>
int by_mode(const Params& p, int mode, int n_head, int dev, cudaStream_t stream) {
  switch (mode) {
    case kAttn: return by_heads<T, kAttn>(p, n_head, dev, stream);
    case kCross: return by_heads<T, kCross>(p, n_head, dev, stream);
    case kCrossV3: return by_heads<T, kCrossV3>(p, n_head, dev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Device pointers of tensors laid out as in ops/knarpe.py; dtype 0 = float32,
// 1 = bf16 for every operand and the output. B4 (mode 0) reads k/v rows of D
// elements at stride ld_kv and no tgt / w_kv (d_tgt = 0); B2/B3 read tgt and
// w_kv (d_tgt = d_model) and no k/v. n_head in {1, 2, 4, 8}, d_model even and
// divisible by n_head, and for B3 d_model / n_head a multiple of 4 (checked by
// the Python wrapper). dev is the current device, which owns the tensors and
// the stream. Returns cudaGetLastError().
extern "C" int knarpe_launch(int mode, int dtype, const void* q, const void* k, const void* v, long long ld_kv,
                             const void* tgt, const void* rpe, const void* invalid, const void* w_kv,
                             const void* w_rpe, const void* bias, void* out, int n_src, int n_knn, int d_model,
                             int d_tgt, int d_rpe, int n_head, float scale, int dev, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.ld_kv = ld_kv; p.tgt = tgt; p.rpe = rpe;
  p.invalid = static_cast<const uint8_t*>(invalid);
  p.w_kv = w_kv; p.w_rpe = w_rpe; p.bias = bias; p.out = out;
  p.n_src = n_src; p.n_knn = n_knn; p.d_model = d_model; p.d_tgt = d_tgt; p.d_rpe = d_rpe; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_mode<float>(p, mode, n_head, dev, st);
  if (dtype == 1) return by_mode<__nv_bfloat16>(p, mode, n_head, dev, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
