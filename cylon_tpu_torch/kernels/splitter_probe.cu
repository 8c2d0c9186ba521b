// Splitter probe for the range-partitioned pipelined join (sm_90a).
//
// Replaces the Pallas TPU kernel cylon_tpu/ops/pallas_probe.py
// (count_ge_splitters / _kernel).  Contract, identical to the TPU kernel's:
//
//   out[r] = #{ j < S : splitter tuple j <= row tuple r }
//
// under the lexicographic order of K parallel key operands, i.e. exactly
// sum(rows_ge_splitters(ops, sops), axis=1) as int32.  Each operand is an
// int32 array (signed values), an int64 array holding an unsigned 32-bit
// value in [0, 2^32) (the port's image of the reference's uint32 operands),
// or a float64 array (an f64 key's 'f' operand: every NaN equal to every
// other and above +inf, -0.0 equal to +0.0).  Each maps onto one
// order-preserving unsigned image (int32: v ^ 2^31; u32: v; f64: the sign-
// folded bits, NaN the top value), so one unsigned compare serves every
// operand, as the TPU kernel's x ^ 0x80000000 rebase serves it in signed
// int32.  Images are 32-bit unless some operand is f64 (the `wide`
// argument), then 64-bit.
//
// The TPU kernel streams (8, 128) row tiles through VMEM with the splitters
// in SMEM.  Here each CTA copies the K x S splitter images into shared
// memory once and walks rows with a grid-stride loop, one row per thread at
// a time: the thread reads its row's K operands once (coalesced across the
// warp), keeps them in registers (the first kRegOps of them) and counts in a
// register with the TPU kernel's gt | eq chain.  No (rows, S) comparison
// matrix ever touches device memory.  The work is K*S compares per row
// against K operand reads and one 4-byte write, so HBM bandwidth bounds it:
// at the main path's K = 2 int32 operands that is 12 bytes a row.  S is
// bounded only by the shared memory the K x S images take.  A binary search
// over the sorted splitters would cut the compares; this kernel keeps the
// linear count the reference computes.
//
// The operands arrive through a device descriptor of 4K int64 entries:
// row pointers [0, K), splitter pointers [K, 2K), row width codes [2K, 3K),
// splitter width codes [3K, 4K) (0 = int32, 1 = int64 carrying u32,
// 2 = float64), so K is not bounded by the kernel's parameter space.
//
// Plain C interface for ctypes: cylon_count_ge_splitters returns the
// cudaError_t of the launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename Img>
__device__ __forceinline__ Img ordered(const void* base, long long code,
                                       long long i) {
  if (code == 0) {
    return static_cast<Img>(static_cast<uint32_t>(
               __ldg(static_cast<const int32_t*>(base) + i)) ^ 0x80000000u);
  }
  const long long bits = __ldg(static_cast<const long long*>(base) + i);
  if (code == 1) {
    return static_cast<Img>(static_cast<uint32_t>(bits));
  }
  // code 2 (float64) only reaches the 64-bit image
  const double d = __longlong_as_double(bits);
  if (d != d) {
    return static_cast<Img>(~0ull);          // every NaN, above +inf
  }
  if (d == 0.0) {
    return static_cast<Img>(1ull << 63);     // -0.0 == +0.0
  }
  const unsigned long long u = static_cast<unsigned long long>(bits);
  return static_cast<Img>((u >> 63) ? ~u : (u | (1ull << 63)));
}

template <typename Img, int kRegOps>
__global__ void __launch_bounds__(kThreads)
count_ge_splitters_kernel(const long long* __restrict__ desc, int k,
                          long long cap, int s, int32_t* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* row_ptr = smem;                        // [k]
  long long* row_code = reinterpret_cast<long long*>(smem + k);  // [k]
  Img* spl = reinterpret_cast<Img*>(smem + 2 * k);              // [k][s]

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    row_ptr[i] = static_cast<unsigned long long>(desc[i]);
    row_code[i] = desc[2 * k + i];
  }
  for (int t = threadIdx.x; t < k * s; t += blockDim.x) {
    const int i = t / s;
    const int j = t - i * s;
    spl[t] = ordered<Img>(reinterpret_cast<const void*>(desc[k + i]),
                          desc[3 * k + i], j);
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < cap; r += stride) {
    Img v[kRegOps];
#pragma unroll
    for (int i = 0; i < kRegOps; ++i) {
      v[i] = i < k ? ordered<Img>(reinterpret_cast<const void*>(row_ptr[i]),
                                  row_code[i], r)
                   : Img(0);
    }
    int cnt = 0;
    for (int j = 0; j < s; ++j) {
      bool gt = false;
      bool eq = true;
#pragma unroll
      for (int i = 0; i < kRegOps; ++i) {
        if (i < k) {
          const Img sv = spl[i * s + j];
          gt = gt | (eq & (v[i] > sv));
          eq = eq & (v[i] == sv);
        }
      }
      for (int i = kRegOps; i < k; ++i) {   // operands past the registers
        const Img x = ordered<Img>(reinterpret_cast<const void*>(row_ptr[i]),
                                   row_code[i], r);
        const Img sv = spl[i * s + j];
        gt = gt | (eq & (x > sv));
        eq = eq & (x == sv);
      }
      cnt += (gt | eq) ? 1 : 0;
    }
    out[r] = cnt;
  }
}

template <typename Img, int kRegOps>
int launch(const long long* desc, int k, long long cap, int s, int32_t* out,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * 16 +
                      static_cast<size_t>(k) * s * sizeof(Img);
  int device = 0;
  int sms = 132;
  int smem_max = 48 * 1024;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        count_ge_splitters_kernel<Img, kRegOps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const long long want = (cap + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(want < most ? want : most);
  count_ge_splitters_kernel<Img, kRegOps><<<grid, kThreads, smem, stream>>>(
      desc, k, cap, s, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Img>
int launch_k(const long long* desc, int k, long long cap, int s,
             int32_t* out, cudaStream_t stream) {
  if (k <= 2) {
    return launch<Img, 2>(desc, k, cap, s, out, stream);
  }
  if (k <= 4) {
    return launch<Img, 4>(desc, k, cap, s, out, stream);
  }
  return launch<Img, 8>(desc, k, cap, s, out, stream);
}

}  // namespace

extern "C" int cylon_count_ge_splitters(const void* desc, int k,
                                        long long cap, int s, int wide,
                                        void* out, void* stream) {
  if (cap <= 0) {
    return 0;
  }
  if (k <= 0 || s <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* d = static_cast<const long long*>(desc);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch_k<unsigned long long>(d, k, cap, s, o, st)
              : launch_k<uint32_t>(d, k, cap, s, o, st);
}
