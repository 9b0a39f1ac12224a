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
// What bounds it on the card: the bytes. At the rollout's shape
// [n_rows=128, n_src=64, n_tgt=1024], k=64 the function must read ~1.2 MB of
// coordinates and masks and write ~4.2 MB of results; the 8.4 M distances
// are a few tens of MFLOP. The design keeps the [n_src, n_tgt] distance
// tile out of device memory altogether: one warp owns one source, holds
// its n_tgt packed keys in registers (ITEMS = ceil(n_tgt / 32) per lane)
// and extracts the k smallest with k warp-wide min reductions. A key is
// (float bits of dist) << 32 | target index: for non-negative floats the
// bit pattern is monotone, so ascending keys are exactly the stable sort's
// order, +inf included. The selection is O(k * n_tgt / 32) register work
// per lane and no shared memory; the targets of a row are re-read by each
// of its warps through L1/L2, not device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // sources per block

template <int ITEMS>
__global__ void __launch_bounds__(kWarps * 32)
knn_xy_kernel(const float2* __restrict__ src_xy, const uint8_t* __restrict__ src_invalid,
              const float2* __restrict__ tgt_xy, const uint8_t* __restrict__ tgt_invalid,
              float* __restrict__ out_dist, int* __restrict__ out_idx,
              int n_src, int n_tgt, int k) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_src) return;  // whole warp leaves together
  const long long row = blockIdx.y;
  const long long src_off = row * n_src + s;
  const float2 sp = src_xy[src_off];
  const bool s_inv = src_invalid[src_off] != 0;
  const float2* t_row = tgt_xy + row * n_tgt;
  const uint8_t* ti_row = tgt_invalid + row * n_tgt;

  unsigned long long key[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int t = lane + 32 * j;
    unsigned long long kk = ~0ull;  // padding: never selected while k <= n_tgt
    if (t < n_tgt) {
      const float2 tp = t_row[t];
      const float dx = __fsub_rn(sp.x, tp.x);
      const float dy = __fsub_rn(sp.y, tp.y);
      float d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (s_inv || ti_row[t] != 0) d = __int_as_float(0x7f800000);
      kk = (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | static_cast<unsigned>(t);
    }
    key[j] = kk;
  }

  float* od = out_dist + src_off * k;
  int* oi = out_idx + src_off * k;
  for (int p = 0; p < k; ++p) {
    unsigned long long m = key[0];
#pragma unroll
    for (int j = 1; j < ITEMS; ++j) m = key[j] < m ? key[j] : m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, m, off);
      m = o < m ? o : m;
    }
    // keys are unique (the index is in the low bits): exactly one lane drops it
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) key[j] = key[j] == m ? ~0ull : key[j];
    if (lane == (p & 31)) {
      od[p] = __uint_as_float(static_cast<unsigned>(m >> 32));
      oi[p] = static_cast<int>(m & 0xffffffffull);
    }
  }
}

template <int ITEMS>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const float2* sxy, const uint8_t* sinv,
            const float2* txy, const uint8_t* tinv, float* od, int* oi, int n_src, int n_tgt, int k) {
  knn_xy_kernel<ITEMS><<<grid, block, 0, stream>>>(sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
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
  const dim3 grid((n_src + kWarps - 1) / kWarps, n_rows);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sxy = static_cast<const float2*>(src_xy);
  const auto* sinv = static_cast<const uint8_t*>(src_invalid);
  const auto* txy = static_cast<const float2*>(tgt_xy);
  const auto* tinv = static_cast<const uint8_t*>(tgt_invalid);
  auto* od = static_cast<float*>(out_dist);
  auto* oi = static_cast<int*>(out_idx);
  const int items = (n_tgt + 31) / 32;
  if (items <= 1) launch<1>(grid, block, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
  else if (items <= 2) launch<2>(grid, block, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
  else if (items <= 4) launch<4>(grid, block, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
  else if (items <= 8) launch<8>(grid, block, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
  else if (items <= 16) launch<16>(grid, block, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
  else if (items <= 32) launch<32>(grid, block, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
  else if (items <= 64) launch<64>(grid, block, st, sxy, sinv, txy, tinv, od, oi, n_src, n_tgt, k);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
