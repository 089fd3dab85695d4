// Native frame plumbing: the host hot loops around the device plane.
//
// The port's own copy of the JAX package's native/framing.cpp, built by
// pushcdn_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC) into
// .build/torch_native/.
//
// The reference's native-performance-critical layer is its Rust transport +
// framing stack (cdn-proto/src/connection/protocols/mod.rs:309-394 —
// length-delimited u32 frames — and the per-message buffer handling). Here
// the equivalent C++ sits at exactly that seam (SURVEY.md §7 design stance,
// seam (a)): batch packing of variable-length payloads into the fixed-shape
// frame tensors the device router consumes, and batch scanning/encoding of
// length-delimited byte streams for the TCP edge.
//
// Exposed as a plain C ABI, loaded through ctypes.
//

#include <cstdint>
#include <cstring>

extern "C" {

// Pack n variable-length payloads (concatenated in `blob`, located by
// offsets/lengths) into a [capacity, frame_bytes] frame tensor + aligned
// metadata columns. Returns the number of frames packed (stops at capacity
// or at a payload that exceeds frame_bytes — the host path handles those).
// Topic masks are [n, topic_words] / [capacity, topic_words] u32 rows
// (topic_words=1 is the compact ≤32-topic layout; 8 covers the full u8
// topic space).
int32_t pushcdn_pack_frames(
    const uint8_t* blob, const int64_t* offsets, const int32_t* lengths,
    const int32_t* kinds, const uint32_t* tmasks, const int32_t* dests,
    int32_t n, int32_t capacity, int32_t frame_bytes, int32_t topic_words,
    uint8_t* out_frames, int32_t* out_kind, int32_t* out_len,
    uint32_t* out_tmask, int32_t* out_dest, uint8_t* out_valid) {
  int32_t packed = 0;
  for (int32_t i = 0; i < n && packed < capacity; ++i) {
    const int32_t len = lengths[i];
    if (len < 0 || len > frame_bytes) return packed;  // caller handles
    uint8_t* slot = out_frames + (int64_t)packed * frame_bytes;
    std::memcpy(slot, blob + offsets[i], (size_t)len);
    if (len < frame_bytes) std::memset(slot + len, 0, (size_t)(frame_bytes - len));
    out_kind[packed] = kinds[i];
    out_len[packed] = len;
    std::memcpy(out_tmask + (int64_t)packed * topic_words,
                tmasks + (int64_t)i * topic_words,
                (size_t)topic_words * sizeof(uint32_t));
    out_dest[packed] = dests[i];
    out_valid[packed] = 1;
    ++packed;
  }
  return packed;
}

// Scan a received byte stream for complete length-delimited frames
// (u32 big-endian length prefix; parity protocols/mod.rs:309-351).
// Writes (offset, length) of each complete frame; returns the number of
// bytes consumed (start of the first incomplete frame). Frames longer than
// max_frame_len abort the scan with *error = 1 (peer violation).
int64_t pushcdn_scan_frames(
    const uint8_t* buf, int64_t len, uint32_t max_frame_len,
    int64_t* out_offsets, int32_t* out_lengths, int32_t max_frames,
    int32_t* num_frames, int32_t* error) {
  int64_t pos = 0;
  int32_t count = 0;
  *error = 0;
  while (count < max_frames && len - pos >= 4) {
    const uint32_t flen = ((uint32_t)buf[pos] << 24) | ((uint32_t)buf[pos + 1] << 16) |
                          ((uint32_t)buf[pos + 2] << 8) | (uint32_t)buf[pos + 3];
    if (flen > max_frame_len) {
      *error = 1;
      break;
    }
    if (len - pos - 4 < (int64_t)flen) break;  // incomplete
    out_offsets[count] = pos + 4;
    out_lengths[count] = (int32_t)flen;
    ++count;
    pos += 4 + (int64_t)flen;
  }
  *num_frames = count;
  return pos;
}

// Encode n payloads into one contiguous length-delimited byte stream
// (u32 BE prefix per frame) — the writer-side batch: one buffer, one
// syscall. Returns total bytes written, or -1 if out_capacity is too small.
int64_t pushcdn_encode_frames(
    const uint8_t* blob, const int64_t* offsets, const int32_t* lengths,
    int32_t n, uint8_t* out, int64_t out_capacity) {
  int64_t pos = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t len = lengths[i];
    if (pos + 4 + (int64_t)len > out_capacity) return -1;
    out[pos] = (uint8_t)((uint32_t)len >> 24);
    out[pos + 1] = (uint8_t)((uint32_t)len >> 16);
    out[pos + 2] = (uint8_t)((uint32_t)len >> 8);
    out[pos + 3] = (uint8_t)len;
    std::memcpy(out + pos + 4, blob + offsets[i], (size_t)len);
    pos += 4 + (int64_t)len;
  }
  return pos;
}

// Same encode, but the payloads arrive as an array of pointers (ctypes
// c_char_p array built from the Python bytes objects — zero join, zero
// intermediate blob). The single copy is straight into `out`.
int64_t pushcdn_encode_frames_ptrs(
    const uint8_t* const* payloads, const int32_t* lengths,
    int32_t n, uint8_t* out, int64_t out_capacity) {
  int64_t pos = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t len = lengths[i];
    if (pos + 4 + (int64_t)len > out_capacity) return -1;
    out[pos] = (uint8_t)((uint32_t)len >> 24);
    out[pos + 1] = (uint8_t)((uint32_t)len >> 16);
    out[pos + 2] = (uint8_t)((uint32_t)len >> 8);
    out[pos + 3] = (uint8_t)len;
    std::memcpy(out + pos + 4, payloads[i], (size_t)len);
    pos += 4 + (int64_t)len;
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Device-plane egress engine (SURVEY.md §7 stage 8; the socket side of the
// socket⇄HBM pump). The router's delivery matrix says which (user, frame)
// pairs deliver; these two passes turn a whole step's matrix into per-user
// length-delimited byte streams with zero per-frame Python:
//
//   pass 1 (count):  per-user bytes + message totals,
//   pass 2 (fill):   one contiguous stream per user at caller-computed
//                    offsets (prefix sum over pass 1), each frame encoded
//                    as u32-BE length ‖ payload — exactly what the wire
//                    writer sends, so the stream is handed to the
//                    connection's writer as-is (one flush per user).
//
// The matrix rows are scanned 8 bytes at a time (numpy bool_ is one byte
// per cell; a zero uint64 word skips 8 frames), so sparse matrices cost
// ~N/8 loads per user. Frame payloads live in `nb` equally-shaped blocks
// (the per-shard host ring snapshots, in gather order): frame n is row
// (n % rows_per_block) of block (n / rows_per_block) — egress reads the
// SAME host buffers the step's H2D copy read, no device round-trip of
// frame bytes (the delivery decision, not the payload, is what crosses
// the mesh on the single-host topology).

static inline uint64_t load_u64(const uint8_t* p) {
  uint64_t w;
  std::memcpy(&w, p, 8);
  return w;
}

// Pass 1: per-user delivered bytes (4-byte prefix included) and counts.
void pushcdn_egress_count(
    const uint8_t* deliver,  // [U, N] row-major (numpy bool_)
    int32_t U, int32_t N,
    const int32_t* lengths,  // [N] frame payload lengths
    int64_t* out_bytes,      // [U]
    int32_t* out_msgs) {     // [U]
  const int32_t nwords = N / 8;
  for (int32_t u = 0; u < U; ++u) {
    const uint8_t* row = deliver + (int64_t)u * N;
    int64_t bytes = 0;
    int32_t msgs = 0;
    int32_t n = 0;
    for (int32_t w = 0; w < nwords; ++w, n += 8) {
      if (load_u64(row + n) == 0) continue;
      for (int32_t k = 0; k < 8; ++k) {
        if (row[n + k]) {
          bytes += 4 + (int64_t)lengths[n + k];
          ++msgs;
        }
      }
    }
    for (; n < N; ++n) {
      if (row[n]) {
        bytes += 4 + (int64_t)lengths[n];
        ++msgs;
      }
    }
    out_bytes[u] = bytes;
    out_msgs[u] = msgs;
  }
}

// Fused single-pass variant: count + prefix-sum + fill in ONE walk over the
// delivery matrix, into a caller-recycled buffer (the egress pool in
// pushcdn_tpu_torch/native). Writes per-user offsets/bytes/msgs as it goes and
// returns total bytes written, or -1 when the buffer is too small — the
// caller then sizes it with pushcdn_egress_count and retries; with a
// grow-only pooled buffer the retry happens once per high-water mark, so
// the steady state pays a single matrix walk and zero page faults.
int64_t pushcdn_egress_encode_fused(
    const uint8_t* deliver, int32_t U, int32_t N, const int32_t* lengths,
    const uint8_t* const* blocks, int32_t nb, int32_t rows_per_block,
    int64_t frame_stride,
    int64_t* out_offsets,  // [U] written: stream start per user
    int64_t* out_bytes,    // [U] written: stream size per user
    int32_t* out_msgs,     // [U] written: delivered count per user
    uint8_t* out, int64_t out_capacity) {
  const int32_t nwords = N / 8;
  int64_t pos = 0;
  for (int32_t u = 0; u < U; ++u) {
    const uint8_t* row = deliver + (int64_t)u * N;
    const int64_t start = pos;
    int32_t msgs = 0;
    int32_t n = 0;
    for (int32_t w = 0; w < nwords; ++w, n += 8) {
      if (load_u64(row + n) == 0) continue;
      for (int32_t k = 0; k < 8; ++k) {
        const int32_t f = n + k;
        if (!row[f]) continue;
        const int32_t len = lengths[f];
        if (pos + 4 + (int64_t)len > out_capacity) return -1;
        out[pos] = (uint8_t)((uint32_t)len >> 24);
        out[pos + 1] = (uint8_t)((uint32_t)len >> 16);
        out[pos + 2] = (uint8_t)((uint32_t)len >> 8);
        out[pos + 3] = (uint8_t)len;
        const uint8_t* src = blocks[f / rows_per_block] +
                             (int64_t)(f % rows_per_block) * frame_stride;
        std::memcpy(out + pos + 4, src, (size_t)len);
        pos += 4 + (int64_t)len;
        ++msgs;
      }
    }
    for (; n < N; ++n) {
      if (!row[n]) continue;
      const int32_t len = lengths[n];
      if (pos + 4 + (int64_t)len > out_capacity) return -1;
      out[pos] = (uint8_t)((uint32_t)len >> 24);
      out[pos + 1] = (uint8_t)((uint32_t)len >> 16);
      out[pos + 2] = (uint8_t)((uint32_t)len >> 8);
      out[pos + 3] = (uint8_t)len;
      const uint8_t* src = blocks[n / rows_per_block] +
                           (int64_t)(n % rows_per_block) * frame_stride;
      std::memcpy(out + pos + 4, src, (size_t)len);
      pos += 4 + (int64_t)len;
      ++msgs;
    }
    out_offsets[u] = start;
    out_bytes[u] = pos - start;
    out_msgs[u] = msgs;
  }
  return pos;
}

// Pass 2: fill per-user streams. Returns total bytes written, or -1 if any
// user's stream would overrun out_capacity (callers size `out` from pass 1,
// so -1 means the matrix changed between passes — it can't, both run on one
// snapshot, but the guard keeps the ABI memory-safe regardless).
int64_t pushcdn_egress_fill(
    const uint8_t* deliver, int32_t U, int32_t N, const int32_t* lengths,
    const uint8_t* const* blocks, int32_t nb, int32_t rows_per_block,
    int64_t frame_stride,
    const int64_t* offsets,  // [U] stream start offsets (prefix sum)
    uint8_t* out, int64_t out_capacity) {
  const int32_t nwords = N / 8;
  int64_t total = 0;
  for (int32_t u = 0; u < U; ++u) {
    const uint8_t* row = deliver + (int64_t)u * N;
    int64_t pos = offsets[u];
    int32_t n = 0;
    for (int32_t w = 0; w < nwords; ++w, n += 8) {
      if (load_u64(row + n) == 0) continue;
      for (int32_t k = 0; k < 8; ++k) {
        const int32_t f = n + k;
        if (!row[f]) continue;
        const int32_t len = lengths[f];
        if (pos + 4 + (int64_t)len > out_capacity) return -1;
        out[pos] = (uint8_t)((uint32_t)len >> 24);
        out[pos + 1] = (uint8_t)((uint32_t)len >> 16);
        out[pos + 2] = (uint8_t)((uint32_t)len >> 8);
        out[pos + 3] = (uint8_t)len;
        const uint8_t* src =
            blocks[f / rows_per_block] +
            (int64_t)(f % rows_per_block) * frame_stride;
        std::memcpy(out + pos + 4, src, (size_t)len);
        pos += 4 + (int64_t)len;
        total += 4 + (int64_t)len;
      }
    }
    for (; n < N; ++n) {
      if (!row[n]) continue;
      const int32_t len = lengths[n];
      if (pos + 4 + (int64_t)len > out_capacity) return -1;
      out[pos] = (uint8_t)((uint32_t)len >> 24);
      out[pos + 1] = (uint8_t)((uint32_t)len >> 16);
      out[pos + 2] = (uint8_t)((uint32_t)len >> 8);
      out[pos + 3] = (uint8_t)len;
      const uint8_t* src =
          blocks[n / rows_per_block] +
          (int64_t)(n % rows_per_block) * frame_stride;
      std::memcpy(out + pos + 4, src, (size_t)len);
      pos += 4 + (int64_t)len;
      total += 4 + (int64_t)len;
    }
  }
  return total;
}

}  // extern "C"
