// Host-side string hashing for high-cardinality string keys.
//
// Variable-length UTF-8 values arrive flattened into one (data buffer,
// offsets) pair — Arrow's large_string layout, built with numpy by
// cylon_tpu_torch/native/__init__.py — and each value maps to a stable
// 64-bit hash, its device-side code.  Joins, groupbys and set ops compare
// the codes; the values stay on the host and decode through a
// hash->value lookup.  Also the prefix lanes and the adjacent common
// prefix that give hashed keys a lexical sort.
//
// Hash: MurmurHash64A (Austin Appleby's public-domain algorithm) with a
// fixed seed, stable across processes.  A copy of cylon_tpu's
// native/strhash.cpp: both packages code every string identically.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 strhash.cpp -o libstrhash.so
// (done at first use by the loader, into cylon_tpu_torch/kernels/_build/).

#include <cstdint>
#include <cstddef>

namespace {

inline uint64_t murmur64a(const void* key, int len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (static_cast<uint64_t>(len) * m);

  const uint8_t* data = static_cast<const uint8_t*>(key);
  const uint8_t* end = data + (len & ~7);

  while (data != end) {
    uint64_t k;
    __builtin_memcpy(&k, data, 8);
    data += 8;
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }

  switch (len & 7) {
    case 7: h ^= static_cast<uint64_t>(data[6]) << 48; [[fallthrough]];
    case 6: h ^= static_cast<uint64_t>(data[5]) << 40; [[fallthrough]];
    case 5: h ^= static_cast<uint64_t>(data[4]) << 32; [[fallthrough]];
    case 4: h ^= static_cast<uint64_t>(data[3]) << 24; [[fallthrough]];
    case 3: h ^= static_cast<uint64_t>(data[2]) << 16; [[fallthrough]];
    case 2: h ^= static_cast<uint64_t>(data[1]) << 8;  [[fallthrough]];
    case 1: h ^= static_cast<uint64_t>(data[0]);
            h *= m;
  }

  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

constexpr uint64_t kSeed = 0x43594c4f4e545055ULL;  // "CYLONTPU"

}  // namespace

extern "C" {

// Hash n UTF-8 values laid out Arrow-style: value i occupies
// data[offsets[i] .. offsets[i+1]).  offsets has n+1 int64 entries.
// out receives n uint64 hashes.
void cylon_hash_strings(const uint8_t* data, const int64_t* offsets,
                        int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = offsets[i];
    const int64_t hi = offsets[i + 1];
    out[i] = murmur64a(data + lo, static_cast<int>(hi - lo), kSeed);
  }
}

// Order lanes for the lexical sort of hashed string keys: value i's
// first 4*n_lanes bytes packed BIG-ENDIAN into n_lanes uint32
// (missing bytes = 0, which sorts short strings before their
// extensions — bytewise UTF-8 order, matching Arrow's binary compare).
// out is row-major (n, n_lanes).  The lanes are value-stable: any process
// holding the same value computes the same lanes.
void cylon_prefix_lanes(const uint8_t* data, const int64_t* offsets,
                        int64_t n, int64_t n_lanes, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = offsets[i];
    const int64_t len = offsets[i + 1] - lo;
    const uint8_t* p = data + lo;
    for (int64_t l = 0; l < n_lanes; ++l) {
      uint32_t v = 0;
      const int64_t base = 4 * l;
      for (int64_t b = 0; b < 4; ++b) {
        v <<= 8;
        if (base + b < len) v |= p[base + b];
      }
      out[i * n_lanes + l] = v;
    }
  }
}

// Longest common prefix (bytes) over ADJACENT pairs of n values taken in
// ``order`` — for values in sorted order this equals the global max LCP
// over all DISTINCT pairs, i.e. how many prefix bytes separate every
// distinct value.  Returns max LCP; identical adjacent values are skipped
// (callers pass unique values).
int64_t cylon_max_adjacent_lcp(const uint8_t* data, const int64_t* offsets,
                               const int64_t* order, int64_t n) {
  int64_t best = 0;
  for (int64_t i = 0; i + 1 < n; ++i) {
    const int64_t a = order[i], b = order[i + 1];
    const uint8_t* pa = data + offsets[a];
    const uint8_t* pb = data + offsets[b];
    const int64_t la = offsets[a + 1] - offsets[a];
    const int64_t lb = offsets[b + 1] - offsets[b];
    const int64_t lim = la < lb ? la : lb;
    int64_t k = 0;
    while (k < lim && pa[k] == pb[k]) ++k;
    if (k == lim && la == lb) continue;  // equal values: no separation need
    if (k > best) best = k;
  }
  return best;
}

}  // extern "C"
