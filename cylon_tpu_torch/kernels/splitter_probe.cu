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
// int32.
//
// What bounds it: K operand reads and one 4-byte write per row (at the main
// path's K = 2 int32 operands, 12 bytes a row), and per row K*S image
// compares.  On the H100 the lexicographic compare of K images against each
// of S splitters, not the bytes, held a version without packed keys to
// 1.96 TB/s (PERF.md).  So the host picks one of two paths per launch, and
// no row loop branches on an operand's type:
//
//   * packed (image_bytes = 0): one or two int32 operands, the main path.
//     The two 32-bit images of a row form one 64-bit key whose unsigned
//     order is the tuple order, so each splitter costs one 64-bit compare
//     per row.
//   * general: every other mix.  count_kernel compares the rows' images
//     lexicographically against the splitters'.  It reads 32-bit images
//     (64-bit when some operand is f64) from one row per operand: an int32
//     operand's own row, its image taken with a per-operand XOR mask held
//     in a register, or an image row that image_kernel wrote first for each
//     other operand (its type branch taken once per CTA, outside its row
//     loop).  With 64-bit images every operand gets an image row.
//
// Each thread takes a group of 4 consecutive rows per operand with one
// 16-byte load (int4; two longlong2 for 64-bit elements) and writes its 4
// counts as one int4.  An operand view that is not 16-byte aligned, and the
// cap % 4 tail, take a scalar path inside the same kernels.  One CTA per 256
// load groups covers the rows in one pass: a grid of the occupancy API's
// resident CTAs, looping over the rows, measured slower (PERF.md).
//
// The splitter images sit in shared memory (S is bounded only by it); each
// CTA builds them once.  The count stays the reference's linear one over the
// S splitters: at S = 5 its compares are far below the bytes.
//
// The operands arrive through a device descriptor of 5K int64 entries:
// row operand pointers [0, K), splitter pointers [K, 2K), row width codes
// [2K, 3K), splitter width codes [3K, 4K) (0 = int32, 1 = int64 carrying
// u32, 2 = float64), and the rows count_kernel reads [4K, 5K): an image
// row that image_kernel writes, or the operand itself where it is read
// directly (every operand of the packed path).  K is not bounded by the
// kernel's parameter space.
//
// Plain C interface for ctypes: cylon_count_ge_splitters returns the
// cudaError_t of the launches (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;          // consecutive rows per thread

__device__ __forceinline__ unsigned long long fold_f64(long long bits) {
  const double d = __longlong_as_double(bits);
  if (d != d) {
    return ~0ull;                            // every NaN, above +inf
  }
  if (d == 0.0) {
    return 1ull << 63;                       // -0.0 == +0.0
  }
  const unsigned long long u = static_cast<unsigned long long>(bits);
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

// One operand's element type and its order-preserving image.
struct OpI32 {
  using Elem = int32_t;
  using Img = uint32_t;
  __device__ static Img image(Elem v) {
    return static_cast<uint32_t>(v) ^ 0x80000000u;
  }
};
struct OpU32 {
  using Elem = long long;
  using Img = uint32_t;
  __device__ static Img image(Elem v) { return static_cast<uint32_t>(v); }
};
struct OpF64 {
  using Elem = long long;
  using Img = unsigned long long;
  __device__ static Img image(Elem v) { return fold_f64(v); }
};
template <typename T>
struct OpImg {                               // rows already hold images
  using Elem = T;
  using Img = T;
  __device__ static Img image(Elem v) { return v; }
};

// 4 consecutive elements from a 16-byte aligned address.
__device__ __forceinline__ void load4(const int32_t* p, int32_t (&v)[4]) {
  const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const uint32_t* p, uint32_t (&v)[4]) {
  const uint4 x = __ldcs(reinterpret_cast<const uint4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const long long* p, long long (&v)[4]) {
  const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const unsigned long long* p,
                                      unsigned long long (&v)[4]) {
  const ulonglong2 a = __ldcs(reinterpret_cast<const ulonglong2*>(p));
  const ulonglong2 b = __ldcs(reinterpret_cast<const ulonglong2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// The images of rows [r0, r0 + 4) of one operand; rows at or past cap read
// as 0 (their results are never stored).
template <typename Op>
__device__ __forceinline__ void load_group(const typename Op::Elem* p,
                                           long long r0, long long cap,
                                           bool vec,
                                           typename Op::Img (&img)[kGroup]) {
  typename Op::Elem v[kGroup];
  if (vec && r0 + kGroup <= cap) {
    load4(p + r0, v);
  } else {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      v[q] = r0 + q < cap ? __ldcs(p + r0 + q) : typename Op::Elem(0);
    }
  }
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    img[q] = Op::image(v[q]);
  }
}

// Stores the 4 counts of rows [r0, r0 + 4): one int4 unless the group
// holds the cap % 4 tail (out is 16-byte aligned).
__device__ __forceinline__ void store_group(int32_t* out, long long r0,
                                            long long cap,
                                            const int (&cnt)[kGroup]) {
  if (r0 + kGroup <= cap) {
    *reinterpret_cast<int4*>(out + r0) =
        make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (r0 + q < cap) {
        out[r0 + q] = cnt[q];
      }
    }
  }
}

// The image of splitter j of operand i, from its width code (the prologue
// only: never inside a row loop).
template <typename Img>
__device__ Img splitter_image(const long long* desc, int k, int i, int j) {
  const void* base = reinterpret_cast<const void*>(desc[k + i]);
  const long long code = desc[3 * k + i];
  if (code == 0) {
    return static_cast<Img>(
        OpI32::image(static_cast<const int32_t*>(base)[j]));
  }
  const long long bits = static_cast<const long long*>(base)[j];
  return code == 1 ? static_cast<Img>(OpU32::image(bits))
                   : static_cast<Img>(OpF64::image(bits));
}

// The first row of this thread's load group (one group per thread).
__device__ __forceinline__ long long group_row() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
         kGroup;
}

// One or two int32 operands (kK): the row tuple's images as one 64-bit key,
// the first operand's in the high word, so key order is tuple order and
// "splitter <= row" is one unsigned compare.
template <int kK>
__global__ void __launch_bounds__(kThreads)
packed_kernel(const long long* __restrict__ desc, long long cap, int s,
              int vec, int32_t* __restrict__ out) {
  extern __shared__ unsigned long long spl_key[];               // [s]
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    unsigned long long key =
        static_cast<unsigned long long>(splitter_image<uint32_t>(desc, kK, 0,
                                                                 j)) << 32;
    if (kK == 2) {
      key |= splitter_image<uint32_t>(desc, kK, 1, j);
    }
    spl_key[j] = key;
  }
  const auto* a = reinterpret_cast<const int32_t*>(desc[0]);
  const auto* b = reinterpret_cast<const int32_t*>(desc[kK - 1]);
  __syncthreads();

  const long long r0 = group_row();
  if (r0 >= cap) {
    return;
  }
  uint32_t hi[kGroup];
  uint32_t lo[kGroup] = {};
  load_group<OpI32>(a, r0, cap, vec != 0, hi);
  if (kK == 2) {
    load_group<OpI32>(b, r0, cap, vec != 0, lo);
  }
  unsigned long long key[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    key[q] = (static_cast<unsigned long long>(hi[q]) << 32) | lo[q];
  }
  int cnt[kGroup] = {};
  for (int j = 0; j < s; ++j) {
    const unsigned long long sk = spl_key[j];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      cnt[q] += key[q] >= sk ? 1 : 0;
    }
  }
  store_group(out, r0, cap, cnt);
}

// Writes the images of operand blockIdx.y into its image row; the type
// branch is taken once per CTA, outside the row loop.
template <typename Op, typename Img>
__device__ void image_rows(const long long* desc, int k, long long cap,
                           bool vec) {
  const long long r0 = group_row();
  if (r0 >= cap) {
    return;
  }
  const int i = blockIdx.y;
  const auto* src = reinterpret_cast<const typename Op::Elem*>(desc[i]);
  Img* dst = reinterpret_cast<Img*>(desc[4 * k + i]);
  typename Op::Img img[kGroup];
  load_group<Op>(src, r0, cap, vec, img);
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    if (r0 + q < cap) {                      // image rows are padded to 4:
      dst[r0 + q] = static_cast<Img>(img[q]);     // nothing past cap is read
    }
  }
}

template <typename Img>
__global__ void __launch_bounds__(kThreads)
image_kernel(const long long* __restrict__ desc, int k, long long cap,
             int vec) {
  const long long code = desc[2 * k + blockIdx.y];
  if (desc[4 * k + blockIdx.y] == desc[blockIdx.y]) {
    return;                                  // read directly by the count
  }
  if (code == 0) {
    image_rows<OpI32, Img>(desc, k, cap, vec != 0);
  } else if (code == 1) {
    image_rows<OpU32, Img>(desc, k, cap, vec != 0);
  } else {
    image_rows<OpF64, Img>(desc, k, cap, vec != 0);
  }
}

// The XOR that turns the Img-wide word count_kernel reads for operand i
// into its image: 2^31 for an int32 operand read directly, else 0 (an
// image row, or any 64-bit word: every 64-bit operand has an image row).
template <typename Img>
__device__ __forceinline__ Img row_mask(const long long* desc, int k, int i) {
  return sizeof(Img) == 4 && desc[4 * k + i] == desc[i]
             ? static_cast<Img>(0x80000000u)
             : Img(0);
}

// Any K: the lexicographic compare of the row's K images against each
// splitter's, the first kRegOps operands' images held in registers.
template <typename Img, int kRegOps>
__global__ void __launch_bounds__(kThreads)
count_kernel(const long long* __restrict__ desc, int k, long long cap, int s,
             int vec, int32_t* __restrict__ out) {
  using Op = OpImg<Img>;
  extern __shared__ unsigned long long smem[];
  Img* spl = reinterpret_cast<Img*>(smem);                  // [k][s]
  for (int t = threadIdx.x; t < k * s; t += blockDim.x) {
    const int i = t / s;
    spl[t] = splitter_image<Img>(desc, k, i, t - i * s);
  }
  const Img* rows[kRegOps];                  // rows and masks, in registers
  Img mask[kRegOps];
#pragma unroll
  for (int i = 0; i < kRegOps; ++i) {
    rows[i] = i < k ? reinterpret_cast<const Img*>(desc[4 * k + i])
                    : nullptr;
    mask[i] = i < k ? row_mask<Img>(desc, k, i) : Img(0);
  }
  __syncthreads();

  const long long r0 = group_row();
  if (r0 >= cap) {
    return;
  }
  Img v[kRegOps][kGroup];
#pragma unroll
  for (int i = 0; i < kRegOps; ++i) {
    if (i < k) {
      load_group<Op>(rows[i], r0, cap, vec != 0, v[i]);
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        v[i][q] ^= mask[i];
      }
    }
  }
  int cnt[kGroup] = {};
  for (int j = 0; j < s; ++j) {
    Img sv[kRegOps];
#pragma unroll
    for (int i = 0; i < kRegOps; ++i) {
      sv[i] = i < k ? spl[i * s + j] : Img(0);
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      bool gt = false;
      bool eq = true;
#pragma unroll
      for (int i = 0; i < kRegOps; ++i) {
        if (i < k) {
          gt = gt | (eq & (v[i][q] > sv[i]));
          eq = eq & (v[i][q] == sv[i]);
        }
      }
      // operands past the registers: read again for each splitter
      for (int i = kRegOps; i < k && r0 + q < cap; ++i) {
        const Img x =
            __ldg(reinterpret_cast<const Img*>(desc[4 * k + i]) + r0 + q) ^
            row_mask<Img>(desc, k, i);
        const Img y = spl[i * s + j];
        gt = gt | (eq & (x > y));
        eq = eq & (x == y);
      }
      cnt[q] += (gt | eq) ? 1 : 0;
    }
  }
  store_group(out, r0, cap, cnt);
}

// One CTA per kThreads load groups.
unsigned flat_grid(long long cap) {
  const long long n_groups = (cap + kGroup - 1) / kGroup;
  return static_cast<unsigned>((n_groups + kThreads - 1) / kThreads);
}

// Lets `kernel` hold `smem` bytes of splitter images, or refuses them
// beyond the card's opt-in shared memory.  Checked before any launch of a
// call, so a refused call launches nothing.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  int device = 0;
  int smem_optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) {
    return err;
  }
  if (smem > static_cast<size_t>(smem_optin)) {
    return cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

template <int kK>
cudaError_t packed(const long long* d, long long cap, int s, int vec,
                   int32_t* o, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(s) * 8;
  const cudaError_t err = allow_smem(packed_kernel<kK>, smem);
  if (err != cudaSuccess) {
    return err;
  }
  packed_kernel<kK><<<flat_grid(cap), kThreads, smem, st>>>(d, cap, s, vec,
                                                           o);
  return cudaGetLastError();
}

// The general path: the image rows written first (when some operand has
// one), then the count.
template <typename Img, int kRegOps>
cudaError_t general_k(const long long* d, int k, long long cap, int s,
                      int vec, bool images, int32_t* o, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(k) * s * sizeof(Img);
  cudaError_t err = allow_smem(count_kernel<Img, kRegOps>, smem);
  if (err != cudaSuccess) {
    return err;
  }
  if (images) {
    image_kernel<Img><<<dim3(flat_grid(cap), k), kThreads, 0, st>>>(
        d, k, cap, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
      return err;
    }
  }
  count_kernel<Img, kRegOps><<<flat_grid(cap), kThreads, smem, st>>>(
      d, k, cap, s, vec, o);
  return cudaGetLastError();
}

template <typename Img>
cudaError_t general(const long long* d, int k, long long cap, int s, int vec,
                    bool images, int32_t* o, cudaStream_t st) {
  if (k <= 2) {
    return general_k<Img, 2>(d, k, cap, s, vec, images, o, st);
  }
  if (k <= 4) {
    return general_k<Img, 4>(d, k, cap, s, vec, images, o, st);
  }
  return general_k<Img, 8>(d, k, cap, s, vec, images, o, st);
}

}  // namespace

// image_bytes: 0 for the packed path (one or two int32 operands), else the
// general path's image width, 4 or 8.  images: some operand has an image
// row to write first.  vec: every row operand is 16-byte aligned (image
// rows always are).
extern "C" int cylon_count_ge_splitters(const void* desc, int k,
                                        long long cap, int s, int vec,
                                        int image_bytes, int images,
                                        void* out, void* stream) {
  if (cap <= 0) {
    return 0;
  }
  if (k <= 0 || s <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* d = static_cast<const long long*>(desc);
  auto* o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (image_bytes == 0 && k == 1) {
    err = packed<1>(d, cap, s, vec, o, st);
  } else if (image_bytes == 0 && k == 2) {
    err = packed<2>(d, cap, s, vec, o, st);
  } else if (image_bytes == 4) {
    err = general<uint32_t>(d, k, cap, s, vec, images != 0, o, st);
  } else if (image_bytes == 8) {
    err = general<unsigned long long>(d, k, cap, s, vec, images != 0, o, st);
  }
  return static_cast<int>(err);
}
