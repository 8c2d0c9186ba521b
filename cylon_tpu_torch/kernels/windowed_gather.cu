// Windowed run-start gather for the fused join->groupby (sm_90a).
//
// Replaces the Pallas TPU kernel cylon_tpu/ops/pallas_gather.py
// (_pallas_take / _kernel, public windowed_take_t).  Contract, identical to
// the TPU kernel's:
//
//   out[l, s] = mat[l, idx[s]]   for a lane-major (L, M) u32 matrix and
//                                sorted int32 idx, S = len(idx), S % 256 == 0
//   per 256-row tile t: ws = min(floor(idx[256 t] / 128) * 128, M128 - W)
//                       with M128 = ceil(M / 128) * 128 (columns past M
//                       read as 0, like the TPU kernel's padding);
//   rows with idx - ws outside [0, W) come out 0;
//   *ok is cleared when a tile's LAST index satisfies idx - ws >= W.
//
// The TPU kernel selects rows with a bf16 one-hot matmul over four byte
// planes because the TPU has no cheap gather.  Hopper gathers directly:
// one CTA per 256-row output tile, one thread per output row, each thread
// copying the 32-bit word of every lane.  Output stores are coalesced; the
// loads of one warp fall in a short run of each lane row, because idx is
// sorted and dense.  The kernel moves only bytes (no arithmetic to speak
// of), so HBM bandwidth bounds it.  Staging each tile's window in shared
// memory with TMA is left for later work.
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

__global__ void __launch_bounds__(kTile)
windowed_take_kernel(const uint32_t* __restrict__ mat, long long m,
                     int lanes, const int32_t* __restrict__ idx,
                     long long s_total, long long m128, int window,
                     uint32_t* __restrict__ out, int32_t* __restrict__ ok) {
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long s = tile0 + threadIdx.x;
  long long ws = floor_div128(static_cast<long long>(idx[tile0])) * 128;
  ws = ws < m128 - window ? ws : m128 - window;
  const long long i = idx[s];
  const long long rel = i - ws;
  const bool take = rel >= 0 && rel < window && i >= 0 && i < m;
  for (int l = 0; l < lanes; ++l) {
    const long long row = static_cast<long long>(l);
    out[row * s_total + s] = take ? __ldg(mat + row * m + i) : 0u;
  }
  if (threadIdx.x == kTile - 1 && rel >= window) {
    *ok = 0;
  }
}

}  // namespace

extern "C" int cylon_windowed_take(const void* mat, long long m, int lanes,
                                   const void* idx, long long s_total,
                                   long long m128, int window, void* out,
                                   void* ok, void* stream) {
  if (s_total <= 0) {
    return 0;
  }
  const unsigned grid = static_cast<unsigned>(s_total / kTile);
  windowed_take_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mat), m, lanes,
      static_cast<const int32_t*>(idx), s_total, m128, window,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
