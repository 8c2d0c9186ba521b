// Windowed run-start gather for the fused join->groupby (sm_90a).
//
// Replaces the Pallas TPU kernel cylon_tpu/ops/pallas_gather.py
// (_pallas_take / _kernel, public windowed_take_t).  Contract, identical to
// the TPU kernel's:
//
//   out[l, s] = lane_l[idx[s]]   for L 32-bit lanes of M words each and
//                                sorted int32 idx, S = len(idx), S % 256 == 0
//   per 256-row tile t: ws = min(floor(idx[256 t] / 128) * 128, M128 - W)
//                       with M128 = ceil(M / 128) * 128 (columns past M
//                       read as 0, like the TPU kernel's padding);
//   rows with idx - ws outside [0, W) come out 0;
//   *ok is cleared when a tile's LAST index satisfies idx - ws >= W.
//
// The TPU kernel selects rows with a bf16 one-hot matmul over four byte
// planes of ONE (L, M) matrix, because the TPU has no cheap gather; its
// caller stacked the lanes into that matrix.  Hopper gathers from L
// separate pointers just as well, so the lanes arrive as a device array of
// L lane pointers (the rows of a contiguous matrix are L pointers too) and
// the caller stacks nothing.  One CTA per 256-row output tile, one thread
// per output row: the CTA copies the L lane pointers into shared memory
// once, then each thread copies its word of every lane, the stores
// coalesced.  (Reading the pointers from the descriptor in every thread,
// or loading 8 lanes per batch, measured slower on the H100.)
//
// What bounds it: bytes.  At the main path's density (a run start every
// ~5 words) nearly every 32-byte sector of a lane's span holds a run
// start, so the HBM traffic is the sectors the sorted indices touch, not
// the useful words (chip_smoke.py prints both floors).  Staging each
// tile's span in shared memory reads every word of the span, no fewer
// bytes: a version that staged the lanes with cp.async ran slower than
// this direct gather on the H100 (PERF.md), so the direct gather stays.
//
// Plain C interface for ctypes: cylon_windowed_take returns the
// cudaGetLastError() code of the launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;

__device__ __forceinline__ long long floor_div128(long long v) {
  return v >= 0 ? v / 128 : -((-v + 127) / 128);
}

// The tile's window start, as the TPU wrapper computes it.
__device__ __forceinline__ long long window_start(long long head,
                                                  long long m128,
                                                  int window) {
  const long long ws = floor_div128(head) * 128;
  return ws < m128 - window ? ws : m128 - window;
}

__global__ void __launch_bounds__(kTile)
windowed_take_kernel(const long long* __restrict__ lanes, long long m,
                     int n_lanes, const int32_t* __restrict__ idx,
                     long long s_total, long long m128, int window,
                     uint32_t* __restrict__ out, int32_t* __restrict__ ok) {
  extern __shared__ const uint32_t* lane[];                 // [n_lanes]
  for (int l = threadIdx.x; l < n_lanes; l += blockDim.x) {
    lane[l] = reinterpret_cast<const uint32_t*>(lanes[l]);
  }
  __syncthreads();
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long s = tile0 + threadIdx.x;
  const long long ws = window_start(idx[tile0], m128, window);
  const long long i = idx[s];
  const long long rel = i - ws;
  const bool take = rel >= 0 && rel < window && i >= 0 && i < m;
  for (int l = 0; l < n_lanes; ++l) {
    out[static_cast<long long>(l) * s_total + s] =
        take ? __ldg(lane[l] + i) : 0u;
  }
  if (threadIdx.x == kTile - 1 && rel >= window) {
    *ok = 0;
  }
}

}  // namespace

// lanes: a device array of n_lanes pointers to 32-bit lanes of m words.
extern "C" int cylon_windowed_take(const void* lanes, long long m,
                                   int n_lanes, const void* idx,
                                   long long s_total, long long m128,
                                   int window, void* out, void* ok,
                                   void* stream) {
  if (s_total <= 0) {
    return 0;
  }
  const unsigned grid = static_cast<unsigned>(s_total / kTile);
  const size_t smem = static_cast<size_t>(n_lanes) * sizeof(void*);
  windowed_take_kernel<<<grid, kTile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(lanes), m, n_lanes,
      static_cast<const int32_t*>(idx), s_total, m128, window,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
