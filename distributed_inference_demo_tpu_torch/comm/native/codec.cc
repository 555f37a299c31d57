// Native wire codec: byte-identical to the Python reference implementation
// in ../wire.py (format "DWT1").  This is the host-side equivalent of
// the reference's cpp/utils.cpp:124-368 (SerializeTensorVectorToBytes /
// DeserializeTensorVectorFromBytes), with the portability defects fixed:
// explicit little-endian, fixed-width fields, magic+version header
// (reference used native endianness + size_t — SURVEY.md Appendix B #9).
//
// C ABI only (consumed from Python via ctypes — no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr char kMagic[4] = {'D', 'W', 'T', '1'};
constexpr uint8_t kVersion = 1;
constexpr size_t kHeaderSize = 4 + 1 + 1 + 2 + 4;
constexpr size_t kTensorHdrSize = 1 + 1 + 2 + 8;

// dtype -> element size; indices match wire.py DType.
constexpr int kItemSize[] = {4, 8, 2, 2, 1, 2, 4, 8, 1, 2, 4, 8, 1};
constexpr int kNumDTypes = 13;

// The wire is little-endian; so is every platform we build for (x86-64,
// arm64, TPU hosts).  Guard anyway so a big-endian port fails loudly.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "wire codec assumes a little-endian host");

inline void put_u16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void put_u32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline void put_u64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }
inline uint32_t get_u32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t get_u64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

struct TensorView {
  uint8_t dtype;
  uint8_t ndims;
  uint64_t nbytes;
  const uint8_t* dims;  // ndims x u64, little-endian, within the message
  const uint8_t* data;  // raw bytes within the message
};

struct Message {
  std::vector<uint8_t> owned;  // copy of the wire buffer
  std::vector<TensorView> tensors;
  uint8_t flags = 0;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Serialization.  Caller passes parallel arrays describing n tensors.
// ---------------------------------------------------------------------------

// Total wire size for the given tensor set; 0 on invalid input.
uint64_t dwt_serialized_size(uint32_t n, const uint8_t* dtypes,
                             const uint8_t* ndims,
                             const uint64_t* const* dims) {
  uint64_t total = kHeaderSize;
  for (uint32_t i = 0; i < n; ++i) {
    if (dtypes[i] >= kNumDTypes) return 0;
    uint64_t count = 1;
    for (uint8_t d = 0; d < ndims[i]; ++d) count *= dims[i][d];
    total += kTensorHdrSize + 8ull * ndims[i] + count * kItemSize[dtypes[i]];
  }
  return total;
}

// Write the message into out (of capacity out_len).  Returns bytes written,
// or 0 on error (bad dtype / insufficient capacity) — mirroring the
// reference serializer's size self-check (utils.cpp:250-261).
uint64_t dwt_serialize(uint32_t n, const uint8_t* dtypes, const uint8_t* ndims,
                       const uint64_t* const* dims,
                       const uint8_t* const* data, uint8_t flags,
                       uint8_t* out, uint64_t out_len) {
  uint64_t need = dwt_serialized_size(n, dtypes, ndims, dims);
  if (need == 0 || need > out_len) return 0;
  uint8_t* p = out;
  std::memcpy(p, kMagic, 4); p += 4;
  *p++ = kVersion;
  *p++ = flags;
  put_u16(p, 0); p += 2;
  put_u32(p, n); p += 4;
  for (uint32_t i = 0; i < n; ++i) {
    uint64_t count = 1;
    for (uint8_t d = 0; d < ndims[i]; ++d) count *= dims[i][d];
    uint64_t nbytes = count * kItemSize[dtypes[i]];
    *p++ = dtypes[i];
    *p++ = ndims[i];
    put_u16(p, 0); p += 2;
    put_u64(p, nbytes); p += 8;
    for (uint8_t d = 0; d < ndims[i]; ++d) { put_u64(p, dims[i][d]); p += 8; }
    std::memcpy(p, data[i], nbytes); p += nbytes;
  }
  return (uint64_t)(p - out) == need ? need : 0;
}

// ---------------------------------------------------------------------------
// Deserialization: open a message handle, then query tensors by index.
// ---------------------------------------------------------------------------

// Returns an opaque handle, or nullptr on malformed input.
void* dwt_open(const uint8_t* buf, uint64_t len) {
  if (len < kHeaderSize || std::memcmp(buf, kMagic, 4) != 0 ||
      buf[4] != kVersion) {
    return nullptr;
  }
  auto* msg = new Message();
  msg->owned.assign(buf, buf + len);
  const uint8_t* base = msg->owned.data();
  msg->flags = base[5];
  uint32_t n = get_u32(base + 6 + 2);
  uint64_t off = kHeaderSize;
  for (uint32_t i = 0; i < n; ++i) {
    if (off + kTensorHdrSize > len) { delete msg; return nullptr; }
    TensorView tv;
    tv.dtype = base[off];
    tv.ndims = base[off + 1];
    tv.nbytes = get_u64(base + off + 4);
    off += kTensorHdrSize;
    if (tv.dtype >= kNumDTypes || off + 8ull * tv.ndims > len) {
      delete msg; return nullptr;
    }
    tv.dims = base + off;
    // Overflow-safe element count: dims are attacker-controlled, so the
    // product must be checked against wrap before the nbytes comparison
    // (count*itemsize could wrap to a small value and "match").
    uint64_t count = 1;
    bool overflow = false;
    for (uint8_t d = 0; d < tv.ndims; ++d) {
      uint64_t dim = get_u64(tv.dims + 8 * d);
      if (dim != 0 && count > UINT64_MAX / dim) { overflow = true; break; }
      count *= dim;
    }
    uint64_t item = (uint64_t)kItemSize[tv.dtype];
    if (overflow || count > UINT64_MAX / item) { delete msg; return nullptr; }
    off += 8ull * tv.ndims;
    // off <= len is guaranteed above; compare against the remainder so a
    // huge nbytes cannot wrap off + nbytes back into range.
    if (count * item != tv.nbytes || tv.nbytes > len - off) {
      delete msg; return nullptr;
    }
    tv.data = base + off;
    off += tv.nbytes;
    msg->tensors.push_back(tv);
  }
  if (off != len) { delete msg; return nullptr; }  // trailing bytes
  return msg;
}

uint32_t dwt_ntensors(void* h) {
  return (uint32_t)static_cast<Message*>(h)->tensors.size();
}

uint8_t dwt_flags(void* h) { return static_cast<Message*>(h)->flags; }

// Fills dtype/ndims/nbytes and up to max_dims dims. Returns 0 on bad index.
int dwt_tensor_info(void* h, uint32_t i, uint8_t* dtype, uint8_t* ndims,
                    uint64_t* nbytes, uint64_t* dims_out, uint8_t max_dims) {
  auto* msg = static_cast<Message*>(h);
  if (i >= msg->tensors.size()) return 0;
  const TensorView& tv = msg->tensors[i];
  *dtype = tv.dtype;
  *ndims = tv.ndims;
  *nbytes = tv.nbytes;
  for (uint8_t d = 0; d < tv.ndims && d < max_dims; ++d) {
    dims_out[d] = get_u64(tv.dims + 8 * d);
  }
  return 1;
}

const uint8_t* dwt_tensor_data(void* h, uint32_t i) {
  auto* msg = static_cast<Message*>(h);
  if (i >= msg->tensors.size()) return nullptr;
  return msg->tensors[i].data;
}

void dwt_close(void* h) { delete static_cast<Message*>(h); }

// Token framing (reference utils.cpp:11-25), little-endian fixed.
void dwt_serialize_token(int32_t token, uint8_t out[4]) {
  std::memcpy(out, &token, 4);
}
int32_t dwt_deserialize_token(const uint8_t in[4]) {
  int32_t v; std::memcpy(&v, in, 4); return v;
}

}  // extern "C"
