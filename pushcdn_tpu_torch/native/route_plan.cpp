// Batch route plan: the broker's cut-through routing core (a host
// routine, not a kernel on the card).
//
// The port's own copy of the JAX package's native/route_plan.cpp, built by
// pushcdn_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC) into
// .build/torch_native/.
//
// The broker's forwarding floor is per-message Python, not the wire:
// transports deliver whole FrameChunk batches and egress is vectorized,
// but the scalar receive loops peel one frame at a time (deserialize ->
// hook -> route_*), materializing a Python message object per frame. This
// translation unit removes that: ONE call
// scans a chunk's frame headers in place (kind tag, topic words, dest key,
// length/offset), matches Broadcast topic bitmasks against a snapshot of
// the broker's interest table and Direct dest keys against a DirectMap
// hash snapshot, and returns a flat (peer, frame) fan-out pair list. The
// caller groups pairs per peer (stable sort keeps per-(sender->receiver)
// frame order identical to the scalar path) and hands the chunk's byte
// ranges straight to egress — payload bytes never become Python objects.
//
// Control frames (Subscribe/Sync/auth/malformed) STOP the plan at their
// index: the scalar path applies them (they mutate routing state, which
// invalidates this snapshot), then planning resumes. This is what keeps
// batch-vs-scalar semantics identical for mixes like
// [Subscribe(t), Broadcast(t)] arriving in one chunk.
//
// The table is INCREMENTALLY
// maintainable. pushcdn_route_table_apply takes a batch of typed deltas —
// absolute per-peer interest masks plus DirectMap upserts/removes — and
// applies them in place, O(delta) not O(users):
//
//   - per-peer masks are STORED, so an interest update diffs old vs new
//     and touches only the changed topics' lists;
//   - the inverted index is 256 per-topic dynamic arrays with LAZY
//     deletion: an unsubscribe just clears the stored mask bit (O(1));
//     plan() skips entries whose mask bit is gone, and the stamp dedupe
//     already tolerates the duplicate entries a re-subscribe appends.
//     Garbage is bounded by the caller's compaction policy (a full
//     rebuild when list_entries outgrows live_subs — see
//     pushcdn_route_table_stats);
//   - the DirectMap hash supports tombstoned removal and in-place
//     upsert, rehashing itself when load gets high; key bytes append to
//     a growable blob whose garbage is likewise compacted by rebuild.
//
// Peer indices are SLOTS: the caller manages a free-list so a connected
// peer keeps its index for its lifetime; n_users/n_brokers passed to
// build() are slot CAPACITIES (dead slots have zero masks and no dmap
// entries, so they can never be planned).
//
// Same discipline as the reference's "deserialize once per hop, forward
// raw bytes" rule (cdn-broker handler.rs hot path); plain C ABI for
// ctypes like framing.cpp.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

constexpr uint8_t KIND_DIRECT = 4;
constexpr uint8_t KIND_BROADCAST = 5;
// Kind-tag high bit: "16-byte trace block follows" (proto/message.py
// TRACE_FLAG). Traced frames take the instrumented scalar path so span
// emission lives OFF the batch plan — the plan stops at them exactly like
// it stops at control frames, and the rest of the chunk stays batched.
constexpr uint8_t KIND_TRACE_FLAG = 0x80;

constexpr int MASK_WORDS = 4;  // 4 x u64 = the full u8 topic space
constexpr int N_TOPICS = 256;

struct DirectSlot {
  uint64_t hash;     // 0 = never used (hash is forced non-zero)
  int64_t key_off;   // into keys blob
  int32_t key_len;   // -1 = tombstone (probing continues past it)
  int32_t peer;      // user peer slot, or >= n_users for a broker slot
};

struct RouteTable {
  int32_t n_users = 0;    // user slot CAPACITY
  int32_t n_brokers = 0;  // broker slot capacity
  uint64_t valid_mask[MASK_WORDS] = {0, 0, 0, 0};

  // stored per-peer interest masks — the diff base for incremental apply
  // and the liveness test for lazily-deleted index entries
  uint64_t* peer_masks = nullptr;  // [n_peers * MASK_WORDS]

  // inverted interest index: topic t -> dynamic array of peer slots
  // (users and brokers in one space: users [0, n_users), brokers
  // [n_users, n_users + n_brokers)). Entries may be stale (mask bit
  // cleared) or duplicated (re-subscribe after lazy delete) — plan()
  // filters on the stored mask and dedupes per frame via stamps.
  int32_t* topic_list[N_TOPICS] = {};
  int32_t topic_len[N_TOPICS] = {};
  int32_t topic_cap[N_TOPICS] = {};
  int64_t live_subs = 0;     // popcount over peer_masks (valid topics only)
  int64_t list_entries = 0;  // sum of topic_len (live + garbage + dups)

  // DirectMap snapshot: open-addressed hash of recipient key -> peer,
  // with tombstoned removal for in-place maintenance
  DirectSlot* dmap = nullptr;
  uint64_t dmap_mask = 0;  // table size - 1 (power of two)
  int64_t dmap_live = 0;
  int64_t dmap_tombstones = 0;
  uint8_t* keys_blob = nullptr;
  int64_t keys_blob_len = 0;  // bytes used
  int64_t keys_blob_cap = 0;
  int64_t blob_garbage = 0;   // bytes owned by removed/stale entries

  // per-frame dedupe stamps for broadcast fan-out (u64: a u32 would wrap
  // within hours at sustained multi-M frames/s on a stable deployment
  // that never rebuilds, and a wrapped stamp silently skips a peer)
  uint64_t* stamp = nullptr;
  uint64_t stamp_cur = 0;

  // topic byte -> flow class (0=control 1=consensus 2=live 3=bulk) for
  // per-class accounting. Survives rebuild/apply: the taxonomy
  // is deployment config, not routing state. Defaults to live.
  uint8_t topic_class[N_TOPICS];
};

uint64_t fnv1a(const uint8_t* data, int32_t len) {
  uint64_t h = 1469598103934665603ull;
  for (int32_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= 1099511628211ull;
  }
  return h ? h : 1ull;  // 0 is the empty-slot marker
}

void free_table_storage(RouteTable* t) {
  std::free(t->peer_masks);
  for (int i = 0; i < N_TOPICS; ++i) {
    std::free(t->topic_list[i]);
    t->topic_list[i] = nullptr;
    t->topic_len[i] = 0;
    t->topic_cap[i] = 0;
  }
  std::free(t->dmap);
  std::free(t->keys_blob);
  std::free(t->stamp);
  t->peer_masks = nullptr;
  t->dmap = nullptr;
  t->keys_blob = nullptr;
  t->stamp = nullptr;
  t->live_subs = t->list_entries = 0;
  t->dmap_live = t->dmap_tombstones = 0;
  t->keys_blob_len = t->keys_blob_cap = t->blob_garbage = 0;
}

bool topic_push(RouteTable* t, int tt, int32_t peer) {
  if (t->topic_len[tt] == t->topic_cap[tt]) {
    int32_t cap = t->topic_cap[tt] ? t->topic_cap[tt] * 2 : 8;
    int32_t* grown =
        (int32_t*)std::realloc(t->topic_list[tt], cap * sizeof(int32_t));
    if (grown == nullptr) return false;
    t->topic_list[tt] = grown;
    t->topic_cap[tt] = cap;
  }
  t->topic_list[tt][t->topic_len[tt]++] = peer;
  ++t->list_entries;
  return true;
}

// find the slot holding `key` (or ~first-insertable-slot if absent).
int64_t dmap_find(const RouteTable* t, const uint8_t* key, int32_t klen,
                  uint64_t h) {
  uint64_t slot = h & t->dmap_mask;
  int64_t first_free = -1;
  while (true) {
    const DirectSlot& s = t->dmap[slot];
    if (s.hash == 0) {
      return ~(first_free >= 0 ? first_free : (int64_t)slot);
    }
    if (s.key_len < 0) {  // tombstone: insertable, keep probing
      if (first_free < 0) first_free = (int64_t)slot;
    } else if (s.hash == h && s.key_len == klen &&
               std::memcmp(t->keys_blob + s.key_off, key, (size_t)klen)
                   == 0) {
      return (int64_t)slot;
    }
    slot = (slot + 1) & t->dmap_mask;
  }
}

bool dmap_rehash(RouteTable* t, uint64_t new_cap) {
  DirectSlot* fresh = (DirectSlot*)std::calloc(new_cap, sizeof(DirectSlot));
  if (fresh == nullptr) return false;
  DirectSlot* old = t->dmap;
  const uint64_t old_cap = t->dmap_mask + 1;
  const uint64_t mask = new_cap - 1;
  for (uint64_t i = 0; i < old_cap; ++i) {
    const DirectSlot& s = old[i];
    if (s.hash == 0 || s.key_len < 0) continue;
    uint64_t slot = s.hash & mask;
    while (fresh[slot].hash != 0) slot = (slot + 1) & mask;
    fresh[slot] = s;
  }
  std::free(old);
  t->dmap = fresh;
  t->dmap_mask = mask;
  t->dmap_tombstones = 0;
  return true;
}

bool blob_append(RouteTable* t, const uint8_t* key, int32_t klen,
                 int64_t* off_out) {
  if (t->keys_blob_len + klen > t->keys_blob_cap) {
    int64_t cap = t->keys_blob_cap ? t->keys_blob_cap : 256;
    while (cap < t->keys_blob_len + klen) cap *= 2;
    uint8_t* grown = (uint8_t*)std::realloc(t->keys_blob, (size_t)cap);
    if (grown == nullptr) return false;
    t->keys_blob = grown;
    t->keys_blob_cap = cap;
  }
  *off_out = t->keys_blob_len;
  std::memcpy(t->keys_blob + t->keys_blob_len, key, (size_t)klen);
  t->keys_blob_len += klen;
  return true;
}

}  // namespace

extern "C" {

void* pushcdn_route_table_create() {
  RouteTable* t = new (std::nothrow) RouteTable();
  if (t != nullptr) std::memset(t->topic_class, 2, N_TOPICS);  // live
  return t;
}

// Replace the topic -> flow-class map (256 bytes, values 0..3; higher
// bits are masked off at plan time). Returns 0, or -1 on a bad handle.
int32_t pushcdn_route_table_set_classes(void* handle,
                                        const uint8_t* classes) {
  RouteTable* t = (RouteTable*)handle;
  if (t == nullptr || classes == nullptr) return -1;
  std::memcpy(t->topic_class, classes, N_TOPICS);
  return 0;
}

void pushcdn_route_table_destroy(void* handle) {
  RouteTable* t = (RouteTable*)handle;
  if (t == nullptr) return;
  free_table_storage(t);
  delete t;
}

// (Re)build the routing snapshot from scratch (first build, version-gap /
// delta-overflow fallback, and COMPACTION — a rebuild purges the lazy
// deletions, duplicate index entries, dmap tombstones, and blob garbage
// the incremental path accrues).
//   n_users / n_brokers: slot CAPACITIES (free slots carry zero masks)
//   peer_masks:  [ (n_users + n_brokers) * 4 ] u64 interest bitmasks
//   valid_mask:  [4] u64 — the deployment's valid-topic set
//   dkeys_blob / dkey_offs / dkey_lens / dkey_owner: DirectMap entries
//     whose owner resolves to a CONNECTED peer (local user -> that user's
//     peer slot; remote owner -> its broker peer slot). Unresolvable
//     owners are omitted by the caller — a plan miss is a drop, exactly
//     like the scalar flush finding no connection.
// Returns 0 on success, -1 on allocation failure (table left empty; the
// caller must fall back to the scalar path).
int32_t pushcdn_route_table_build(
    void* handle, int32_t n_users, int32_t n_brokers,
    const uint64_t* valid_mask, const uint64_t* peer_masks,
    const uint8_t* dkeys_blob, const int64_t* dkey_offs,
    const int32_t* dkey_lens, const int32_t* dkey_owner, int32_t n_dkeys) {
  RouteTable* t = (RouteTable*)handle;
  if (t == nullptr || n_users < 0 || n_brokers < 0 || n_dkeys < 0) return -1;
  free_table_storage(t);
  t->n_users = n_users;
  t->n_brokers = n_brokers;
  t->stamp_cur = 0;
  std::memcpy(t->valid_mask, valid_mask, sizeof(t->valid_mask));
  const int64_t n_peers = (int64_t)n_users + n_brokers;

  // stored masks (the incremental-apply diff base)
  const int64_t mask_words = (n_peers ? n_peers : 1) * MASK_WORDS;
  t->peer_masks = (uint64_t*)std::malloc(mask_words * sizeof(uint64_t));
  if (t->peer_masks == nullptr) return -1;
  std::memcpy(t->peer_masks, peer_masks,
              (size_t)n_peers * MASK_WORDS * sizeof(uint64_t));

  // inverted index: count pass, then exact-size per-topic arrays
  int32_t counts[N_TOPICS] = {};
  int64_t total = 0;
  for (int64_t p = 0; p < n_peers; ++p) {
    const uint64_t* m = peer_masks + p * MASK_WORDS;
    for (int w = 0; w < MASK_WORDS; ++w)
      for (uint64_t bits = m[w]; bits; bits &= bits - 1) {
        ++counts[w * 64 + __builtin_ctzll(bits)];
        ++total;
      }
  }
  for (int tt = 0; tt < N_TOPICS; ++tt) {
    if (counts[tt] == 0) continue;
    t->topic_list[tt] = (int32_t*)std::malloc(counts[tt] * sizeof(int32_t));
    if (t->topic_list[tt] == nullptr) { free_table_storage(t); return -1; }
    t->topic_cap[tt] = counts[tt];
  }
  for (int64_t p = 0; p < n_peers; ++p) {
    const uint64_t* m = peer_masks + p * MASK_WORDS;
    for (int w = 0; w < MASK_WORDS; ++w)
      for (uint64_t bits = m[w]; bits; bits &= bits - 1) {
        const int tt = w * 64 + __builtin_ctzll(bits);
        t->topic_list[tt][t->topic_len[tt]++] = (int32_t)p;
      }
  }
  t->live_subs = total;
  t->list_entries = total;

  // direct-map hash (open addressing, power-of-two, 2x load headroom)
  uint64_t cap = 16;
  while (cap < (uint64_t)n_dkeys * 2 + 1) cap <<= 1;
  t->dmap = (DirectSlot*)std::calloc(cap, sizeof(DirectSlot));
  if (t->dmap == nullptr) { free_table_storage(t); return -1; }
  t->dmap_mask = cap - 1;
  int64_t blob_len = 0;
  for (int32_t i = 0; i < n_dkeys; ++i) blob_len += dkey_lens[i];
  t->keys_blob_cap = blob_len ? blob_len : 256;
  t->keys_blob = (uint8_t*)std::malloc((size_t)t->keys_blob_cap);
  if (t->keys_blob == nullptr) { free_table_storage(t); return -1; }
  for (int32_t i = 0; i < n_dkeys; ++i) {
    const uint8_t* key = dkeys_blob + dkey_offs[i];
    const int32_t klen = dkey_lens[i];
    const uint64_t h = fnv1a(key, klen);
    int64_t slot = dmap_find(t, key, klen, h);
    if (slot >= 0) {
      // duplicate key: last entry wins (caller emits each once); the
      // earlier copy's blob bytes become garbage
      t->blob_garbage += t->dmap[slot].key_len;
      int64_t off;
      if (!blob_append(t, key, klen, &off)) {
        free_table_storage(t);
        return -1;
      }
      t->dmap[slot].key_off = off;
      t->dmap[slot].key_len = klen;
      t->dmap[slot].peer = dkey_owner[i];
      continue;
    }
    slot = ~slot;
    int64_t off;
    if (!blob_append(t, key, klen, &off)) {
      free_table_storage(t);
      return -1;
    }
    DirectSlot& s = t->dmap[slot];
    s.hash = h;
    s.key_off = off;
    s.key_len = klen;
    s.peer = dkey_owner[i];
    ++t->dmap_live;
  }

  t->stamp = (uint64_t*)std::calloc(n_peers ? n_peers : 1, sizeof(uint64_t));
  if (t->stamp == nullptr) { free_table_storage(t); return -1; }
  return 0;
}

// Apply one batch of typed deltas IN PLACE — O(delta), never
// O(users):
//   upd_peer[i] / upd_masks[i*4..]: peer slot i's NEW absolute interest
//     mask (diffed against the stored mask; a freed slot passes zeros)
//   dkeys_* / dkey_owner: DirectMap upserts; owner == -1 removes the key
//     (tombstone), owner >= 0 sets/overwrites it
// Returns 0 on success, -1 on allocation failure or out-of-range peer
// (the caller must fall back to a full rebuild; the table stays usable
// in the sense that no partial write corrupts invariants — a half-applied
// batch is superseded by the rebuild anyway).
int32_t pushcdn_route_table_apply(
    void* handle, const int32_t* upd_peer, const uint64_t* upd_masks,
    int32_t n_upd, const uint8_t* dkeys_blob, const int64_t* dkey_offs,
    const int32_t* dkey_lens, const int32_t* dkey_owner, int32_t n_dkeys) {
  RouteTable* t = (RouteTable*)handle;
  if (t == nullptr || t->peer_masks == nullptr || n_upd < 0 || n_dkeys < 0)
    return -1;
  const int64_t n_peers = (int64_t)t->n_users + t->n_brokers;

  for (int32_t i = 0; i < n_upd; ++i) {
    const int64_t peer = upd_peer[i];
    if (peer < 0 || peer >= n_peers) return -1;
    uint64_t* stored = t->peer_masks + peer * MASK_WORDS;
    const uint64_t* fresh = upd_masks + (int64_t)i * MASK_WORDS;
    for (int w = 0; w < MASK_WORDS; ++w) {
      const uint64_t nw = fresh[w] & t->valid_mask[w];
      const uint64_t ow = stored[w];
      if (nw == ow) continue;
      for (uint64_t bits = nw & ~ow; bits; bits &= bits - 1) {
        // newly subscribed: append (a stale duplicate may already sit in
        // the list — the stamp dedupe makes that harmless)
        if (!topic_push(t, w * 64 + __builtin_ctzll(bits), (int32_t)peer))
          return -1;
        ++t->live_subs;
      }
      for (uint64_t bits = ow & ~nw; bits; bits &= bits - 1) {
        // lazy delete: the cleared mask bit is the deletion; the list
        // entry becomes garbage the next compaction rebuild purges
        --t->live_subs;
        (void)bits;
      }
      stored[w] = nw;
    }
  }

  for (int32_t i = 0; i < n_dkeys; ++i) {
    const uint8_t* key = dkeys_blob + dkey_offs[i];
    const int32_t klen = dkey_lens[i];
    const int32_t owner = dkey_owner[i];
    const uint64_t h = fnv1a(key, klen);
    int64_t slot = dmap_find(t, key, klen, h);
    if (owner < 0) {
      if (slot >= 0) {
        t->blob_garbage += t->dmap[slot].key_len;
        t->dmap[slot].key_len = -1;  // tombstone (hash stays for probing)
        --t->dmap_live;
        ++t->dmap_tombstones;
      }
      continue;
    }
    if (slot >= 0) {
      if (owner >= n_peers) return -1;
      t->dmap[slot].peer = owner;
      continue;
    }
    if (owner >= n_peers) return -1;
    // insert: keep load (live + tombstones) under half the table; a
    // rehash also purges tombstones
    const uint64_t cap = t->dmap_mask + 1;
    if ((uint64_t)(t->dmap_live + t->dmap_tombstones + 1) * 2 > cap) {
      uint64_t want = cap;
      while ((uint64_t)(t->dmap_live + 1) * 2 > want) want <<= 1;
      if (!dmap_rehash(t, want)) return -1;
      slot = dmap_find(t, key, klen, h);
      if (slot >= 0) return -1;  // can't happen: key was absent
    }
    slot = ~slot;
    int64_t off;
    if (!blob_append(t, key, klen, &off)) return -1;
    DirectSlot& s = t->dmap[slot];
    if (s.hash != 0) --t->dmap_tombstones;  // reusing a tombstoned slot
    s.hash = h;
    s.key_off = off;
    s.key_len = klen;
    s.peer = owner;
    ++t->dmap_live;
  }
  return 0;
}

// Occupancy/garbage counters for the caller's compaction policy:
// out[0..7] = {n_users, n_brokers, live_subs, list_entries, dmap_live,
//              dmap_tombstones, keys_blob_len, blob_garbage}.
void pushcdn_route_table_stats(void* handle, int64_t* out) {
  RouteTable* t = (RouteTable*)handle;
  if (t == nullptr) {
    std::memset(out, 0, 8 * sizeof(int64_t));
    return;
  }
  out[0] = t->n_users;
  out[1] = t->n_brokers;
  out[2] = t->live_subs;
  out[3] = t->list_entries;
  out[4] = t->dmap_live;
  out[5] = t->dmap_tombstones;
  out[6] = t->keys_blob_len;
  out[7] = t->blob_garbage;
}

// Plan frames [start, start+count) of one chunk.
//   mode 0: user-origin  (Direct forwards anywhere; Broadcast reaches
//           interested users AND brokers) — handler.rs user path
//   mode 1: broker-origin (Direct to OUR user only; Broadcast to local
//           users only — loop prevention) — handler.rs broker path
// Emits (peer, frame-index) pairs in frame order. Stops at the first
// frame that is not a well-formed Direct/Broadcast (*stop_reason = 1:
// the scalar path owns it) or when the pair buffer cannot be guaranteed
// to hold the next frame's worst-case fan-out (*stop_reason = 2: call
// again from the returned index). *stop_reason = 0 means the whole range
// was planned. Returns the number of frames consumed, or -1 on bad args.
//
// out_class (nullable): per-frame flow class, indexed by ABSOLUTE frame
// index — Broadcast takes the class of its FIRST topic byte, Direct is
// live, and 255 marks a consumed frame that reached no one (pruned-empty
// broadcast / unknown-recipient drop), excluded from ingress accounting.
// Only indices [start, start+consumed) are meaningful.
int64_t pushcdn_route_plan(
    void* handle, const uint8_t* buf, int64_t buf_len,
    const int64_t* offs, const int64_t* lens, int64_t start, int64_t count,
    int32_t mode, int32_t* out_peer, int32_t* out_frame, int64_t pair_cap,
    int64_t* n_pairs, int32_t* stop_reason, uint8_t* out_class) {
  RouteTable* t = (RouteTable*)handle;
  *n_pairs = 0;
  *stop_reason = 0;
  if (t == nullptr || t->peer_masks == nullptr || start < 0 || count < 0)
    return -1;
  int64_t pairs = 0;
  int64_t i = start;
  const int64_t end = start + count;
  for (; i < end; ++i) {
    const int64_t o = offs[i];
    const int64_t n = lens[i];
    if (o < 0 || n < 1 || o + n > buf_len) { *stop_reason = 1; break; }
    // Capacity is enforced EXACTLY, per emitted pair, with a rollback of
    // the current frame on overflow — the previous conservative guard
    // (reserve worst-case n_peers pairs per frame) collapsed batching to
    // one frame per plan call as soon as the peer table outgrew the pair
    // buffer (8K+ users), which is precisely the large-table regime.
    // The caller keeps pair_cap >= n_peers + 1, so a lone frame always
    // fits and STOP_CAPACITY can always make progress on retry.
    // (Stamps touched by a rolled-back frame are harmless: the retry
    // plans it under a fresh stamp value.)
    const int64_t frame_pairs = pairs;
    const uint8_t kind = buf[o];
    if (kind & KIND_TRACE_FLAG) { *stop_reason = 1; break; }  // traced: scalar
    if (kind == KIND_BROADCAST && n >= 3) {
      const int64_t nt = (int64_t)buf[o + 1] | ((int64_t)buf[o + 2] << 8);
      if (3 + nt > n) { *stop_reason = 1; break; }  // malformed: scalar
      uint64_t mask[MASK_WORDS] = {0, 0, 0, 0};
      for (int64_t k = 0; k < nt; ++k) {
        const uint8_t topic = buf[o + 3 + k];
        mask[topic >> 6] |= 1ull << (topic & 63);
      }
      bool any = false;
      for (int w = 0; w < MASK_WORDS; ++w) {
        mask[w] &= t->valid_mask[w];
        any |= mask[w] != 0;
      }
      if (out_class != nullptr)
        out_class[i] = any ? (uint8_t)(t->topic_class[buf[o + 3]] & 3)
                           : (uint8_t)255;
      if (!any) continue;  // pruned empty: drop (scalar parity)
      const uint64_t st = ++t->stamp_cur;
      bool overflow = false;
      for (int w = 0; w < MASK_WORDS && !overflow; ++w)
        for (uint64_t bits = mask[w]; bits && !overflow; bits &= bits - 1) {
          const int tt = w * 64 + __builtin_ctzll(bits);
          const int32_t hi = t->topic_len[tt];
          const int32_t* lst = t->topic_list[tt];
          for (int32_t k = 0; k < hi; ++k) {
            const int32_t peer = lst[k];
            // lazy-deletion filter: the stored mask is the truth — an
            // unsubscribed (or freed-slot) entry is garbage awaiting
            // compaction
            if (!(t->peer_masks[(int64_t)peer * MASK_WORDS + w] >> (tt & 63)
                  & 1ull))
              continue;
            if (mode == 1 && peer >= t->n_users) continue;  // users only
            if (t->stamp[peer] == st) continue;  // already gets this frame
            if (pairs == pair_cap) { overflow = true; break; }
            t->stamp[peer] = st;
            out_peer[pairs] = peer;
            out_frame[pairs] = (int32_t)i;
            ++pairs;
          }
        }
      if (overflow) {
        pairs = frame_pairs;  // roll this frame back; retry next call
        *stop_reason = 2;
        break;
      }
    } else if (kind == KIND_DIRECT && n >= 5) {
      const int64_t rlen = (int64_t)buf[o + 1] | ((int64_t)buf[o + 2] << 8) |
                           ((int64_t)buf[o + 3] << 16) |
                           ((int64_t)buf[o + 4] << 24);
      if (5 + rlen > n) { *stop_reason = 1; break; }  // malformed: scalar
      const uint8_t* key = buf + o + 5;
      const int64_t slot = dmap_find(t, key, (int32_t)rlen,
                                     fnv1a(key, (int32_t)rlen));
      if (out_class != nullptr)
        out_class[i] = slot < 0 ? (uint8_t)255 : (uint8_t)2;  // Direct: live
      if (slot < 0) continue;  // unknown recipient: drop
      const int32_t peer = t->dmap[slot].peer;
      if (mode == 1 && peer >= t->n_users) {
        // Broker-origin direct whose DirectMap owner is another broker:
        // the one-hop rule forbids re-forwarding, but the frame may
        // still be deliverable over a local `parting` connection (a
        // migration eviction raced the sender's stale DirectMap
        // replica). Rare by construction — hand it to the scalar path
        // (which chases parting) instead of silently dropping.
        *stop_reason = 1;
        break;
      }
      if (pairs == pair_cap) { *stop_reason = 2; break; }
      out_peer[pairs] = peer;
      out_frame[pairs] = (int32_t)i;
      ++pairs;
    } else {
      // control kind, short frame, or unknown tag: the scalar path owns
      // this frame (and everything after it until the caller re-plans)
      *stop_reason = 1;
      break;
    }
  }
  *n_pairs = pairs;
  return i - start;
}

// Gather a peer's fan-out into one wire-ready buffer: for each listed
// frame, write [u32 BE length][payload] — byte-identical to the transport
// framing the chunk arrived with. Returns bytes written, or -1 when `out`
// is too small / an index is out of range.
int64_t pushcdn_route_gather(
    const uint8_t* buf, int64_t buf_len, const int64_t* offs,
    const int64_t* lens, const int32_t* frame_idx, int64_t n_idx,
    uint8_t* out, int64_t out_cap) {
  int64_t pos = 0;
  for (int64_t k = 0; k < n_idx; ++k) {
    const int64_t i = frame_idx[k];
    const int64_t o = offs[i];
    const int64_t n = lens[i];
    if (o < 0 || n < 0 || o + n > buf_len || pos + 4 + n > out_cap) return -1;
    out[pos] = (uint8_t)(n >> 24);
    out[pos + 1] = (uint8_t)(n >> 16);
    out[pos + 2] = (uint8_t)(n >> 8);
    out[pos + 3] = (uint8_t)n;
    std::memcpy(out + pos + 4, buf + o, (size_t)n);
    pos += 4 + n;
  }
  return pos;
}

}  // extern "C"
