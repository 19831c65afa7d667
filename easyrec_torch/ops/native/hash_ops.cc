// String -> bucket hashing for the host feature pipeline of easyrec_torch.
//
// A copy of the string-hash part of easyrec_tpu/ops/native/native_ops.cc:
// the same MurmurHash64A and seed, so a string lands in the same bucket in
// both packages, and the same fused split-and-hash of delimited sequences.
// Called from Python through ctypes (easyrec_torch/ops/hashing.py), built
// with g++ at first use.

#include <cstdint>
#include <cstring>

namespace {

// MurmurHash64A (Austin Appleby, public domain) — a well-mixed 64-bit
// string hash; stands in for TF's farmhash fingerprint (bucket assignment
// only needs consistency, not farmhash equality).
inline uint64_t murmur64a(const char* key, int64_t len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (static_cast<uint64_t>(len) * m);

  const unsigned char* data = reinterpret_cast<const unsigned char*>(key);
  const unsigned char* end = data + (len & ~7LL);

  while (data != end) {
    uint64_t k;
    std::memcpy(&k, data, 8);
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
    data += 8;
  }

  switch (len & 7) {
    case 7: h ^= static_cast<uint64_t>(data[6]) << 48; [[fallthrough]];
    case 6: h ^= static_cast<uint64_t>(data[5]) << 40; [[fallthrough]];
    case 5: h ^= static_cast<uint64_t>(data[4]) << 32; [[fallthrough]];
    case 4: h ^= static_cast<uint64_t>(data[3]) << 24; [[fallthrough]];
    case 3: h ^= static_cast<uint64_t>(data[2]) << 16; [[fallthrough]];
    case 2: h ^= static_cast<uint64_t>(data[1]) << 8; [[fallthrough]];
    case 1: h ^= static_cast<uint64_t>(data[0]); h *= m;
  }

  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

constexpr uint64_t kSeed = 0xe17a1465ULL;

}  // namespace

extern "C" {

// Hash n strings (stored as one concatenated buffer + offsets[n+1]) into
// [0, num_buckets), writing int64 bucket ids to out[n].
void hash_strings_mod(const char* buf, const int64_t* offsets, int64_t n,
                      uint64_t num_buckets, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = offsets[i];
    const int64_t len = offsets[i + 1] - off;
    const uint64_t h = murmur64a(buf + off, len, kSeed);
    out[i] = static_cast<int64_t>(h % num_buckets);
  }
}

// Split n delimited strings into at most max_k non-empty pieces each and
// hash every piece into [0, num_buckets): ids[n*max_k], padded with pad_id,
// and counts[n]. A copy of split_hash_strings of the JAX package's
// native_ops.cc, so sequence ids agree between the two packages.
void split_hash_strings(const char* buf, const int64_t* offsets, int64_t n,
                        char sep, uint64_t num_buckets, int64_t max_k,
                        int64_t pad_id, int64_t* ids, int32_t* counts) {
  for (int64_t i = 0; i < n; ++i) {
    const char* p = buf + offsets[i];
    const char* lim = buf + offsets[i + 1];
    int64_t k = 0;
    int64_t* row = ids + i * max_k;
    while (p < lim && k < max_k) {
      const char* q = static_cast<const char*>(
          std::memchr(p, sep, static_cast<size_t>(lim - p)));
      const char* piece_end = q ? q : lim;
      if (piece_end > p) {
        row[k++] = static_cast<int64_t>(
            murmur64a(p, piece_end - p, kSeed) % num_buckets);
      }
      p = q ? q + 1 : lim;
    }
    counts[i] = static_cast<int32_t>(k);
    for (; k < max_k; ++k) row[k] = pad_id;
  }
}

}  // extern "C"
