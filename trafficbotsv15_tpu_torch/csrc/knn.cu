// Fused KNN select for Hopper (sm_90a): pairwise xy distance + the k
// smallest per source, in stable-sort order.
//
// Replaces trafficbotsv15_tpu/ops/pallas_knn.py::knn_xy_pallas (kernel body
// _knn_kernel). Contract, identical to that kernel and to the plain version
// ops/knn.py::knn_xy_reference:
//   dist = sqrt(dx*dx + dy*dy), each operation rounded on its own (no FMA),
//   +inf where the source or the target is invalid; the k smallest per
//   source, ascending, ties broken by ascending target index; rows with
//   fewer than k valid targets emit their +inf tail in ascending index order.
//
// What bounds it on the card. By the bound of chip_smoke.py it is the bytes:
// at the rollout's shape [n_rows=128, n_src=64, n_tgt=1024], k=64 the function
// must read ~1.2 MB and write ~4.2 MB, 1.6 us at 3.35 TB/s. What bounds this
// design is the instructions of the selection: the Pallas kernel's k
// min-extractions over the whole row (the TPU runs its grid in order over
// a VMEM tile) would cost a warp ~64 x 200 instructions and a chain of 64
// dependent warp-wide reductions. So the selection goes by threshold instead:
//   - a block stages its row's targets (xy and mask, 9 bytes each) in shared
//     memory once and gives each of its warps one source of that row; the
//     [n_src, n_tgt] distance tile never leaves the registers (ITEMS =
//     ceil(n_tgt / 32) keys per lane, a key being the float bits of the
//     distance: for non-negative floats the bit pattern is monotone, +inf
//     included);
//   - the k-th smallest key T is found bit by bit from the top (a radix
//     select with one-bit digits): each pass counts the keys below a
//     candidate prefix, ITEMS compares per lane and one warp-wide
//     __reduce_add_sync, and keeps the bit if fewer than k fall below. It
//     stops early when exactly k keys fall below a candidate, which is then
//     the threshold with no tie to break; at most 31 passes;
//   - the warp compacts every key below T and the first k - count(key < T)
//     keys equal to T, in ascending target order (a ballot prefix ranks the
//     ties), into a per-warp buffer in shared memory as (key << 32 | index),
//     whose order is the stable sort's; a bitonic network sorts those k
//     (padded to a power of two, at least 64); lanes store the row coalesced.
// Per source that is ~31 x (ITEMS + 6) instructions per lane for the select,
// ~15 x ITEMS for the compaction and ~21 compare-exchanges for k = 64, in
// place of ~64 x 200, and the dependent chain is at most 31 passes long.
// At the training shape [8, 64, 1024] there are only 512 sources, so the
// blocks shrink to 2 warps to spread them over the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;  // sources per block at most
constexpr int kStage = 8;     // target loads in flight per thread while staging (more would cost registers)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPadKey = 0xffffffffu;  // lanes past n_tgt: above every distance, never selected (k <= n_tgt)

__host__ __device__ inline size_t a16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

template <int ITEMS>
__global__ void __launch_bounds__(kMaxWarps * 32)
knn_xy_kernel(const float2* __restrict__ src_xy, const uint8_t* __restrict__ src_invalid,
              const float2* __restrict__ tgt_xy, const uint8_t* __restrict__ tgt_invalid,
              float* __restrict__ out_dist, int* __restrict__ out_idx, int n_src, int n_tgt, int k, int kpad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* txy = reinterpret_cast<float2*>(smem);
  uint8_t* tinv = smem + static_cast<size_t>(n_tgt) * sizeof(float2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(smem + a16(static_cast<size_t>(n_tgt) * 9)) + static_cast<size_t>(warp) * kpad;
  const long long row = blockIdx.y;

  // the row's targets into shared memory, kStage loads in flight per thread: a block of 2 warps
  // (the training shape) stages 1024 targets in two round trips to L2, not 16
  const float2* t_row = tgt_xy + row * n_tgt;
  const uint8_t* ti_row = tgt_invalid + row * n_tgt;
  for (int t0 = threadIdx.x; t0 < n_tgt; t0 += kStage * blockDim.x) {
    float2 v[kStage];
    uint8_t m[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < n_tgt) {
        v[u] = t_row[t];
        m[u] = ti_row[t];
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < n_tgt) {
        txy[t] = v[u];
        tinv[t] = m[u];
      }
    }
  }
  __syncthreads();
  const int s = blockIdx.x * n_warps + warp;
  if (s >= n_src) return;  // whole warp leaves together, after the block's only barrier
  const long long src_off = row * n_src + s;
  const float2 sp = src_xy[src_off];
  const bool s_inv = src_invalid[src_off] != 0;

  unsigned key[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int t = lane + 32 * j;
    unsigned kk = kPadKey;
    if (t < n_tgt) {
      const float2 tp = txy[t];
      const float dx = __fsub_rn(sp.x, tp.x);
      const float dy = __fsub_rn(sp.y, tp.y);
      float d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (s_inv || tinv[t] != 0) d = __int_as_float(0x7f800000);
      kk = __float_as_uint(d);
    }
    key[j] = kk;
  }

  // thr: the k-th smallest key, or a value with exactly k keys below it; n_below = count(key < thr)
  unsigned thr = 0;
  int n_below = 0;
  for (int b = 30; b >= 0; --b) {  // bit 31 is 0 in every distance
    const unsigned cand = thr | (1u << b);
    unsigned c[4] = {0u, 0u, 0u, 0u};  // four chains of adds, not one
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) c[j & 3] += key[j] < cand ? 1u : 0u;
    const int cnt = static_cast<int>(__reduce_add_sync(kFull, (c[0] + c[1]) + (c[2] + c[3])));
    if (cnt <= k) {
      thr = cand;
      n_below = cnt;
      if (cnt == k) break;  // warp-uniform
    }
  }

  // every key below thr, then the first (k - n_below) keys equal to it in target order
  const int need = k - n_below;
  const unsigned below_me = (1u << lane) - 1u;
  int taken = 0, eq_seen = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (taken == k) break;  // warp-uniform
    const unsigned kk = key[j];
    const bool eq = kk == thr;
    const unsigned b_eq = __ballot_sync(kFull, eq);
    const bool sel = kk < thr || (eq && eq_seen + __popc(b_eq & below_me) < need);
    const unsigned b_sel = __ballot_sync(kFull, sel);
    if (sel)
      buf[taken + __popc(b_sel & below_me)] =
          (static_cast<unsigned long long>(kk) << 32) | static_cast<unsigned>(lane + 32 * j);
    taken += __popc(b_sel);
    eq_seen += __popc(b_eq);
  }
  for (int p = k + lane; p < kpad; p += 32) buf[p] = ~0ull;
  __syncwarp();

  // bitonic sort of buf[0, kpad) ascending; (key << 32 | index) is unique, so this is the stable order
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < (kpad >> 1); i += 32) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = buf[lo], c = buf[hi];
        if ((a > c) == ((lo & size) == 0)) {
          buf[lo] = c;
          buf[hi] = a;
        }
      }
      __syncwarp();
    }
  }

  float* od = out_dist + src_off * k;
  int* oi = out_idx + src_off * k;
  for (int p = lane; p < k; p += 32) {
    const unsigned long long v = buf[p];
    od[p] = __uint_as_float(static_cast<unsigned>(v >> 32));
    oi[p] = static_cast<int>(v & 0xffffffffull);
  }
}

template <int ITEMS>
int launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream, const float2* sxy, const uint8_t* sinv,
           const float2* txy, const uint8_t* tinv, float* od, int* oi, int n_src, int n_tgt, int k, int kpad) {
  if (smem > 48 * 1024) {  // only for large k; the rollout's k = 64 takes ~13 KB
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(knn_xy_kernel<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  knn_xy_kernel<ITEMS><<<grid, block, smem, stream>>>(sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

}  // namespace

// Pointers are device pointers of contiguous tensors: src_xy [n_rows, n_src, 2]
// f32, src_invalid [n_rows, n_src] bool, tgt_xy [n_rows, n_tgt, 2] f32,
// tgt_invalid [n_rows, n_tgt] bool, out_dist [n_rows, n_src, k] f32,
// out_idx [n_rows, n_src, k] int32. Requires 0 < k <= n_tgt <= 2048 and
// n_rows <= 65535 (checked by the Python wrapper). Returns cudaGetLastError().
extern "C" int knn_xy_launch(const void* src_xy, const void* src_invalid, const void* tgt_xy,
                             const void* tgt_invalid, void* out_dist, void* out_idx, int n_rows,
                             int n_src, int n_tgt, int k, void* stream) {
  if (!(0 < k && k <= n_tgt && n_tgt <= 2048) || n_rows < 1 || n_rows > 65535 || n_src < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // fewer sources per block while the grid would leave SMs idle (the training shape: 512 sources)
  int warps = kMaxWarps;
  while (warps > 2 && static_cast<long long>(n_rows) * ((n_src + warps - 1) / warps) < 2LL * sm_count()) warps >>= 1;
  int kpad = 64;
  while (kpad < k) kpad <<= 1;
  const size_t smem = a16(static_cast<size_t>(n_tgt) * 9) + static_cast<size_t>(warps) * kpad * 8;
  const dim3 grid((n_src + warps - 1) / warps, n_rows);
  const dim3 block(warps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sxy = static_cast<const float2*>(src_xy);
  const auto* sinv = static_cast<const uint8_t*>(src_invalid);
  const auto* txy = static_cast<const float2*>(tgt_xy);
  const auto* tinv = static_cast<const uint8_t*>(tgt_invalid);
  auto* od = static_cast<float*>(out_dist);
  auto* oi = static_cast<int*>(out_idx);
  const int items = (n_tgt + 31) / 32;
  if (items <= 1) return launch<1>(grid, block, smem, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
  if (items <= 2) return launch<2>(grid, block, smem, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
  if (items <= 4) return launch<4>(grid, block, smem, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
  if (items <= 8) return launch<8>(grid, block, smem, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
  if (items <= 16) return launch<16>(grid, block, smem, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
  if (items <= 32) return launch<32>(grid, block, smem, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
  return launch<64>(grid, block, smem, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k, kpad);
}
