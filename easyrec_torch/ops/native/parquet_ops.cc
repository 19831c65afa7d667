// The hot loops of the port's Parquet decoder (easyrec_torch/data/parquet.py).
//
// Built with g++ at first use by easyrec_torch/ops/parquet_ops.py, which
// holds a plain Python version of each function with the same semantics
// (the tests hold the two to each other bit for bit). Every function checks
// its reads and writes against the lengths it is given and returns -1 on
// malformed input; the caller raises.
//
//   pq_snappy_decompress       the Snappy raw format (the SNAPPY codec)
//   pq_rle_bp_decode           the RLE / bit-packed hybrid (levels,
//                              dictionary indices, RLE booleans)
//   pq_split_byte_array        PLAIN BYTE_ARRAY values -> one buffer and
//                              offsets
//   pq_gather_byte_array       a dictionary's byte arrays gathered by index
//   pq_delta_binary_packed     DELTA_BINARY_PACKED (also the lengths of
//                              DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY)
//   pq_delta_byte_array_build  DELTA_BYTE_ARRAY's prefixes and suffixes ->
//                              the values

#include <cstdint>
#include <cstring>

namespace {

// ULEB128 at src[*pos:end] into *out; false past end or beyond 64 bits.
bool read_uleb(const uint8_t* src, int64_t* pos, int64_t end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (true) {
    if (*pos >= end || shift > 63) return false;
    uint8_t b = src[(*pos)++];
    v |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = v;
  return true;
}

int64_t unzigzag(uint64_t v) {
  return int64_t(v >> 1) ^ -int64_t(v & 1);
}

}  // namespace

extern "C" {

// Decompress the Snappy raw-format block src[0:n] into dst[0:dst_len].
// Returns dst_len, or -1 if the preamble's length differs from dst_len or
// the block is malformed.
int64_t pq_snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t dst_len) {
  int64_t i = 0;
  uint64_t len = 0;
  if (!read_uleb(src, &i, n, &len) || int64_t(len) != dst_len) return -1;
  int64_t o = 0;
  while (i < n) {
    uint8_t tag = src[i++];
    int kind = tag & 3;
    if (kind == 0) {                              // literal
      int64_t size = tag >> 2;
      if (size >= 60) {
        int nb = int(size) - 59;
        if (i + nb > n) return -1;
        size = 0;
        for (int k = 0; k < nb; k++) size |= int64_t(src[i + k]) << (8 * k);
        i += nb;
      }
      size += 1;
      if (size > n - i || size > dst_len - o) return -1;
      std::memcpy(dst + o, src + i, size);
      i += size;
      o += size;
      continue;
    }
    int64_t size, off;
    if (kind == 1) {                              // copy, 1-byte offset
      if (i >= n) return -1;
      size = 4 + ((tag >> 2) & 7);
      off = (int64_t(tag >> 5) << 8) | src[i];
      i += 1;
    } else if (kind == 2) {                       // copy, 2-byte offset
      if (i + 2 > n) return -1;
      size = 1 + (tag >> 2);
      off = int64_t(src[i]) | (int64_t(src[i + 1]) << 8);
      i += 2;
    } else {                                      // copy, 4-byte offset
      if (i + 4 > n) return -1;
      size = 1 + (tag >> 2);
      off = int64_t(src[i]) | (int64_t(src[i + 1]) << 8) |
            (int64_t(src[i + 2]) << 16) | (int64_t(src[i + 3]) << 24);
      i += 4;
    }
    if (off == 0 || off > o || size > dst_len - o) return -1;
    for (int64_t k = 0; k < size; k++) dst[o + k] = dst[o + k - off];
    o += size;
  }
  return o == dst_len ? o : -1;
}

// Decode n values of the RLE / bit-packed hybrid at src[pos:end], each
// bit_width (0-32) bits, into out. A bit-packed run holds groups of 8
// values, least significant bit first; only the bytes of the values still
// needed must be present in a last run. Returns the position after the
// last run read (the end of its bytes, clipped to end), or -1.
int64_t pq_rle_bp_decode(const uint8_t* src, int64_t pos, int64_t end,
                         int bit_width, int64_t n, int32_t* out) {
  if (bit_width < 0 || bit_width > 32) return -1;
  const int vbytes = (bit_width + 7) / 8;
  const uint64_t mask = bit_width == 0 ? 0 : (~0ull >> (64 - bit_width));
  int64_t got = 0;
  while (got < n) {
    uint64_t h;
    if (!read_uleb(src, &pos, end, &h)) return -1;
    if (h & 1) {                                  // bit-packed groups
      int64_t count = int64_t(h >> 1) * 8;
      int64_t nbytes = int64_t(h >> 1) * bit_width;
      int64_t need = count < n - got ? count : n - got;
      if ((need * bit_width + 7) / 8 > end - pos) return -1;
      uint64_t acc = 0;
      int bits = 0;
      int64_t p = pos;
      for (int64_t k = 0; k < need; k++) {
        while (bits < bit_width) {
          acc |= uint64_t(src[p++]) << bits;
          bits += 8;
        }
        out[got++] = int32_t(uint32_t(acc & mask));
        acc >>= bit_width;
        bits -= bit_width;
      }
      pos = nbytes < end - pos ? pos + nbytes : end;
    } else {                                      // one value repeated
      int64_t count = int64_t(h >> 1);
      if (vbytes > end - pos) return -1;
      uint32_t v = 0;
      for (int k = 0; k < vbytes; k++) v |= uint32_t(src[pos + k]) << (8 * k);
      pos += vbytes;
      for (int64_t k = 0; k < count && got < n; k++) out[got++] = int32_t(v);
    }
  }
  return pos;
}

// n PLAIN BYTE_ARRAY values (a 4-byte little-endian length, then the
// bytes) at src[pos:end] -> their bytes concatenated into data (room for
// end - pos bytes) and offsets[0..n] into it. Returns the position after
// the last value, or -1.
int64_t pq_split_byte_array(const uint8_t* src, int64_t pos, int64_t end,
                            int64_t n, uint8_t* data, int64_t* offsets) {
  int64_t o = 0;
  offsets[0] = 0;
  for (int64_t k = 0; k < n; k++) {
    if (end - pos < 4) return -1;
    uint32_t size;
    std::memcpy(&size, src + pos, 4);
    pos += 4;
    if (int64_t(size) > end - pos) return -1;
    std::memcpy(data + o, src + pos, size);
    pos += size;
    o += size;
    offsets[k + 1] = o;
  }
  return pos;
}

// The byte arrays dict (bytes data, offsets[0..n_dict]) at the n indices
// idx -> out (room for cap bytes) and out_offsets[0..n]. Returns the bytes
// written, or -1 for an index outside the dictionary or past cap.
int64_t pq_gather_byte_array(const uint8_t* data, const int64_t* offsets,
                             int64_t n_dict, const int32_t* idx, int64_t n,
                             uint8_t* out, int64_t cap,
                             int64_t* out_offsets) {
  int64_t o = 0;
  out_offsets[0] = 0;
  for (int64_t k = 0; k < n; k++) {
    int64_t j = idx[k];
    if (j < 0 || j >= n_dict) return -1;
    int64_t size = offsets[j + 1] - offsets[j];
    if (size > cap - o) return -1;
    std::memcpy(out + o, data + offsets[j], size);
    o += size;
    out_offsets[k + 1] = o;
  }
  return o;
}

// One DELTA_BINARY_PACKED stream of n values at src[pos:end]: the header
// (block size, miniblocks a block, total count, first value), then blocks
// of a zigzag min delta, a bit width a miniblock and the miniblocks, each
// packed least significant bit first and as long as a full miniblock.
// Values wrap at width (32 or 64) bits and come out sign-extended into
// out[0..n]. Returns the position after the stream, or -1 (also where the
// header's count is not n).
int64_t pq_delta_binary_packed(const uint8_t* src, int64_t pos, int64_t end,
                               int width, int64_t n, int64_t* out) {
  uint64_t block, minis, total, first;
  if (width != 32 && width != 64) return -1;
  if (!read_uleb(src, &pos, end, &block) ||
      !read_uleb(src, &pos, end, &minis) ||
      !read_uleb(src, &pos, end, &total) ||
      !read_uleb(src, &pos, end, &first))
    return -1;
  if (minis == 0 || block == 0 || block % minis || (block / minis) % 8 ||
      block > (1u << 20))
    return -1;
  if (int64_t(total) != n || n < 0) return -1;
  if (total == 0) return pos;
  const uint64_t wmask = width == 32 ? 0xffffffffull : ~0ull;
  uint64_t prev = uint64_t(unzigzag(first)) & wmask;
  auto emit = [&](int64_t k, uint64_t v) {
    out[k] = width == 32 ? int64_t(int32_t(uint32_t(v))) : int64_t(v);
  };
  emit(0, prev);
  int64_t got = 1;
  const int64_t per_mini = int64_t(block / minis);
  while (got < int64_t(total)) {
    uint64_t zz;
    if (!read_uleb(src, &pos, end, &zz)) return -1;
    uint64_t min_delta = uint64_t(unzigzag(zz));
    if (int64_t(minis) > end - pos) return -1;
    const uint8_t* widths = src + pos;
    pos += int64_t(minis);
    for (uint64_t m = 0; m < minis && got < int64_t(total); m++) {
      int bw = widths[m];
      if (bw > width) return -1;
      int64_t nbytes = per_mini * bw / 8;
      if (nbytes > end - pos) return -1;
      unsigned __int128 acc = 0;
      int bits = 0;
      int64_t p = pos;
      const uint64_t mask = bw == 0 ? 0 : (~0ull >> (64 - bw));
      for (int64_t k = 0; k < per_mini && got < int64_t(total); k++) {
        while (bits < bw) {
          acc |= (unsigned __int128)src[p++] << bits;
          bits += 8;
        }
        uint64_t d = uint64_t(acc) & mask;
        acc >>= bw;
        bits -= bw;
        prev = (prev + min_delta + d) & wmask;
        emit(got++, prev);
      }
      pos += nbytes;
    }
  }
  return pos;
}

// DELTA_BYTE_ARRAY's values: value k is the first prefix[k] bytes of value
// k - 1, then suffix k (suffixes: bytes sdata, offsets soff[0..n]) -> out
// (room for cap bytes) and out_offsets[0..n]. Returns the bytes written,
// or -1 if a prefix is longer than the value before it or out is full.
int64_t pq_delta_byte_array_build(const int64_t* prefix, const uint8_t* sdata,
                                  const int64_t* soff, int64_t n,
                                  uint8_t* out, int64_t cap,
                                  int64_t* out_offsets) {
  int64_t o = 0, prev_start = 0, prev_len = 0;
  out_offsets[0] = 0;
  for (int64_t k = 0; k < n; k++) {
    int64_t pre = prefix[k];
    int64_t suf = soff[k + 1] - soff[k];
    if (pre < 0 || pre > prev_len || suf < 0 || pre + suf > cap - o)
      return -1;
    std::memmove(out + o, out + prev_start, pre);
    std::memcpy(out + o + pre, sdata + soff[k], suf);
    prev_start = o;
    prev_len = pre + suf;
    o += prev_len;
    out_offsets[k + 1] = o;
  }
  return o;
}

}  // extern "C"
