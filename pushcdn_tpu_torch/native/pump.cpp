// Fused data-plane pump: recv'd chunk -> route plan -> linked send SQEs
// in one native pass.
//
// The port's own copy of the JAX package's native/pump.cpp. It includes
// io_uring.cpp and route_plan.cpp from this directory (the build passes
// -I on it), and the library's name hashes all three sources.
//
// This TU *includes* the two layers it composes so it shares their types
// and helpers: the pcu_ring struct + SQE prep from io_uring.cpp and the
// RouteTable + pushcdn_route_plan kernel from route_plan.cpp. The pump
// library operates on handles CREATED BY the other libraries (the
// engine's pcu_ring*, the planner's RouteTable*): the structs hold all
// state (no file-scope globals), every .so is compiled from the same
// sources with the same flags, and malloc/free share libc — so the
// layouts interoperate across the dlopen boundary.
//
// Data model:
//   - pushcdn_pump_route_chunk runs the EXISTING plan kernel over the
//     chunk, then partitions the (peer, frame) pairs: peers mapped to an
//     engaged pump slot get per-peer zero-copy RUNS (maximal contiguous
//     frame spans of the pooled chunk — the wire bytes verbatim) queued
//     and submitted as one linked chain of plain SEND SQEs per peer;
//     everything else (unengaged peers, fenced peers, cross-shard peers
//     left unmapped by Python) is compacted into residual pair arrays
//     for the existing Python _send_plan, in frame order.
//   - A chunk with at least one staged run takes one CHUNK SLOT whose
//     refcount is one per run; Python parks the chunk's pool lease under
//     that slot and drops it when the slot shows up in
//     pushcdn_pump_take_released — batch-wise lease accounting
//     reconciled against proto/limiter.py. Released slots accumulate in
//     a bounded internal list (each slot releases exactly once per
//     in_use cycle), so a burst can never overflow them away.
//   - pushcdn_pump_drain replaces the engine's raw CQE peek: pump-tagged
//     CQEs (bit 63 of user_data) are accounted here, mirroring
//     UringStream._on_send_cqe exactly (WAITALL re-pump on a short lone
//     tail, poison on a short mid-chain link, EPIPE on zero-with-
//     remaining); everything else is compacted out for the Python
//     dispatcher. Peer state transitions (idle / error / quiesced)
//     return as flat int64 triples.
//
// Sends are plain IORING_OP_SEND (MSG_NOSIGNAL|MSG_WAITALL), not
// SEND_ZC: the run already points at the pooled chunk, so userspace
// copies are zero either way; the kernel copy to the socket buffer
// matches the non-ZC engine path this replaces.

#include "io_uring.cpp"
#include "route_plan.cpp"

namespace {

constexpr unsigned long long PUMP_UD_TAG = 1ull << 63;
constexpr int PUMP_CHAIN_MAX = 64;

#ifndef MSG_NOSIGNAL
#define MSG_NOSIGNAL 0x4000
#endif
#ifndef MSG_WAITALL
#define MSG_WAITALL 0x100
#endif
constexpr unsigned PUMP_MSG_FLAGS = MSG_NOSIGNAL | MSG_WAITALL;

struct PumpRun {
  unsigned long long addr;
  u32 len;
  u32 sent;
  s32 chunk_slot;
  // telemetry: stage stamps ride the run so completion can
  // observe recv->send latency with zero Python. All zero when the
  // ring's telemetry block is off.
  u64 t_recv = 0;    // recv-CQE stamp (drain wakeup that carried the chunk)
  u64 t_ready = 0;   // plan-done stamp (run queued, eligible to submit)
  u64 t_submit = 0;  // SQE-submit stamp (prep_chain staged the send)
  u32 cls_frames[PCU_TM_CLASSES] = {0, 0, 0, 0};
  u32 cls_bytes[PCU_TM_CLASSES] = {0, 0, 0, 0};
};

struct PumpPeer {
  int fd = -1;
  bool in_use = false;
  bool fenced = false;
  bool dead = false;   // drop_peer'd: slot frees on quiesce
  int err = 0;         // positive errno once the peer failed
  PumpRun *q = nullptr;
  u32 q_cap = 0, q_head = 0, q_len = 0;  // live runs: q[q_head .. +q_len)
  u32 inflight = 0;    // CQEs outstanding for the current chain
  // per-route_chunk staging (frame-ordered pair list indices)
  s32 stage_head = -1, stage_tail = -1;
  // telemetry: chain start stamp + claimed row in the bounded per-peer
  // counter table (-1 = unclaimed / table full)
  u64 chain_t0 = 0;
  s32 tm_row = -1;
};

struct ChunkSlot {
  u32 refs = 0;
  bool in_use = false;
};

struct Pump {
  pcu_ring *ring = nullptr;
  PumpPeer *peers = nullptr;
  u32 max_peers = 0;
  s32 *slot_map = nullptr;   // route peer slot -> pump id (or -1)
  u32 slot_n = 0, slot_cap = 0;
  ChunkSlot *chunks = nullptr;
  s32 *chunk_free = nullptr;
  u32 n_chunks = 0, n_chunk_free = 0;
  s32 *released = nullptr;   // slots whose refs hit 0, pending Python
  u32 n_released = 0;
  u32 sq_reserve = 0;        // SQ entries kept back for the Python engine
  // plan + staging scratch
  s32 *pr_peer = nullptr, *pr_frame = nullptr, *pr_next = nullptr;
  s32 *touched = nullptr;
  long pair_cap = 0;
  // stats
  u64 st_runs = 0, st_chains = 0, st_sqes = 0, st_cqes = 0;
  u64 st_bytes = 0, st_frames = 0, st_errors = 0, st_short_repump = 0;
  u64 st_ev_lost = 0;
  // telemetry: recv-CQE stamp from the last drain wakeup (one vdso clock
  // read per drain, shared by every route_chunk the wakeup fans into)
  u64 last_recv_ns = 0;
};

struct EvBuf {
  long long *ev;
  long cap, n;
};

enum { EV_PEER_IDLE = 1, EV_PEER_ERROR = 2, EV_PEER_QUIESCED = 3 };

void emit(Pump *p, EvBuf *eb, long long type, long long a, long long b) {
  if (eb == nullptr || eb->n + 3 > eb->cap) {
    p->st_ev_lost++;
    return;
  }
  eb->ev[eb->n] = type;
  eb->ev[eb->n + 1] = a;
  eb->ev[eb->n + 2] = b;
  eb->n += 3;
}

void chunk_decref(Pump *p, s32 slot) {
  if (slot < 0 || (u32)slot >= p->n_chunks) return;
  ChunkSlot &c = p->chunks[slot];
  if (!c.in_use || c.refs == 0) return;
  if (--c.refs == 0) {
    c.in_use = false;
    p->chunk_free[p->n_chunk_free++] = slot;
    p->released[p->n_released++] = slot;  // bounded: once per use cycle
  }
}

void pop_run(Pump *p, PumpPeer &pp) {
  chunk_decref(p, pp.q[pp.q_head].chunk_slot);
  pp.q_head++;
  pp.q_len--;
  if (pp.q_len == 0) pp.q_head = 0;
}

// Terminal fate for an abandoned run: fold its per-class frame counts
// into the shared fate_drop_frames block so the conservation ledger
// accounts pump drops with zero Python on the frame path. cls_frames is
// valid from enqueue time (unlike the t_* stamps), so runs dropped
// before submit — or queued while telemetry was off — still count.
void run_dropped(Pump *p, const PumpRun &r) {
  pcu_telem *tm = p->ring->telem;
  if (tm == nullptr) return;
  pcu_tm_begin(tm);
  for (int c = 0; c < PCU_TM_CLASSES; ++c)
    tm->fate_drop_frames[c] += r.cls_frames[c];
  pcu_tm_end(tm);
}

// Drop every queued-but-not-inflight run (peer failed or dropped). The
// inflight ones keep their refs until their CQEs drain.
void drop_tail_runs(Pump *p, PumpPeer &pp) {
  while (pp.q_len > pp.inflight) {
    const PumpRun &r = pp.q[pp.q_head + pp.q_len - 1];
    run_dropped(p, r);
    chunk_decref(p, r.chunk_slot);
    pp.q_len--;
  }
  if (pp.q_len == 0) pp.q_head = 0;
}

void free_peer_slot(Pump *p, u32 id) {
  PumpPeer &pp = p->peers[id];
  std::free(pp.q);
  pp = PumpPeer();
}

// Unlocked histogram add — callers batch several of these inside one
// pcu_tm_begin/pcu_tm_end seqlock section.
inline void tm_hist_add(pcu_hist *h, u64 ns, u64 n) {
  h->count += n;
  h->sum_ns += ns * n;
  h->bucket[pcu_log2_bucket(ns)] += n;
}

// Telemetry on a fully-delivered run: wire + total stage latencies,
// per-class delay/frames/bytes, bounded per-peer counters. One seqlock
// section per delivered run. Runs queued before telemetry was enabled
// carry zero stamps and are skipped.
void run_delivered(Pump *p, PumpPeer &pp, const PumpRun &r, u64 t_done) {
  pcu_telem *tm = p->ring->telem;
  if (tm == nullptr || r.t_submit == 0) return;
  const u64 wire = t_done > r.t_submit ? t_done - r.t_submit : 0;
  const u64 total =
      (r.t_recv != 0 && t_done > r.t_recv) ? t_done - r.t_recv : 0;
  u64 frames = 0;
  for (int c = 0; c < PCU_TM_CLASSES; ++c) frames += r.cls_frames[c];
  if (pp.tm_row < 0) {
    // claim (or rejoin, after re-engage) a row in the bounded per-peer
    // table, keyed by fd; table full -> stays unattributed (-1)
    for (u32 i = 0; i < tm->peer_used; ++i)
      if (tm->peer_fd[i] == (u64)pp.fd) { pp.tm_row = (s32)i; break; }
    if (pp.tm_row < 0 && tm->peer_used < (u64)PCU_TM_PEERS) {
      pp.tm_row = (s32)tm->peer_used;
      pcu_tm_begin(tm);
      tm->peer_fd[pp.tm_row] = (u64)pp.fd;
      tm->peer_used++;
      pcu_tm_end(tm);
    }
  }
  pcu_tm_begin(tm);
  tm_hist_add(&tm->stage[2], wire, 1);
  tm_hist_add(&tm->stage[3], total, 1);
  for (int c = 0; c < PCU_TM_CLASSES; ++c) {
    if (r.cls_frames[c] == 0) continue;
    tm_hist_add(&tm->class_delay[c], total, r.cls_frames[c]);
    tm->class_frames[c] += r.cls_frames[c];
    tm->class_bytes[c] += r.cls_bytes[c];
  }
  if (pp.tm_row >= 0) {
    tm->peer_frames[pp.tm_row] += frames;
    tm->peer_bytes[pp.tm_row] += r.len;
  }
  pcu_tm_end(tm);
}

void peer_fail(Pump *p, u32 id, int neg_errno, EvBuf *eb) {
  PumpPeer &pp = p->peers[id];
  if (pp.err == 0) {
    pp.err = -neg_errno;
    p->st_errors++;
    emit(p, eb, EV_PEER_ERROR, id, neg_errno);
  }
  drop_tail_runs(p, pp);
}

// Prep one linked chain for a peer whose previous chain finished.
// Returns SQEs prepped (0 when the SQ is too full to respect the
// engine's reserve — the drain sweep retries).
int prep_chain(Pump *p, u32 id) {
  PumpPeer &pp = p->peers[id];
  if (pp.inflight != 0 || pp.q_len == 0 || pp.err != 0 || pp.dead)
    return 0;
  int space = pcu_sq_space(p->ring) - (int)p->sq_reserve;
  if (space <= 0) return 0;
  u32 n = pp.q_len;
  if (n > (u32)PUMP_CHAIN_MAX) n = PUMP_CHAIN_MAX;
  if (n > (u32)space) n = (u32)space;
  const unsigned long long ud = PUMP_UD_TAG | id;
  u32 done = 0;
  for (u32 i = 0; i < n; ++i) {
    const PumpRun &r = pp.q[pp.q_head + i];
    const unsigned flags = (i + 1 < n) ? IOSQE_IO_LINK : 0;
    if (pcu_prep_send(p->ring, pp.fd, r.addr + r.sent, r.len - r.sent,
                      ud, flags, PUMP_MSG_FLAGS) != 0)
      break;  // SQ refused after the space check (defensive)
    done = i + 1;
  }
  if (done == 0) return 0;
  if (done < n) {
    // truncated: the previously prepped SQE carries IOSQE_IO_LINK and
    // would chain into an unrelated later SQE — clear it so the partial
    // chain stays well-formed
    pcu_ring *r = p->ring;
    r->sqes[(r->local_tail - 1) & r->sq_mask].flags &=
        (u8)~IOSQE_IO_LINK;
  }
  pp.inflight = done;
  p->st_chains++;
  p->st_sqes += done;
  if (p->ring->telem != nullptr) {
    pcu_telem *tm = p->ring->telem;
    const u64 t_sub = pcu_now_ns();
    pp.chain_t0 = t_sub;
    pcu_tm_begin(tm);
    for (u32 i = 0; i < done; ++i) {
      PumpRun &qr = pp.q[pp.q_head + i];
      qr.t_submit = t_sub;  // re-preps (ECANCELED requeue) restamp
      const u64 d =
          (qr.t_ready != 0 && t_sub > qr.t_ready) ? t_sub - qr.t_ready : 0;
      tm_hist_add(&tm->stage[1], d, 1);
    }
    pcu_tm_end(tm);
  }
  return (int)done;
}

// One CQE against a peer's head run — mirrors UringStream._on_send_cqe.
void pump_on_cqe(Pump *p, u32 id, int res, EvBuf *eb) {
  if (id >= p->max_peers) return;
  PumpPeer &pp = p->peers[id];
  if (!pp.in_use || pp.inflight == 0) return;  // stale/aborted
  pp.inflight--;
  p->st_cqes++;
  if (pp.inflight == 0 && pp.chain_t0 != 0 && p->ring->telem != nullptr) {
    // submit -> quiesce wall time for the chain that just finished
    const u64 now = pcu_now_ns();
    pcu_tm_observe(p->ring->telem, &p->ring->telem->chain[1],
                   now > pp.chain_t0 ? now - pp.chain_t0 : 0);
    pp.chain_t0 = 0;
  }
  if (pp.err != 0) {
    // draining a failed peer: every trailing CQE frees one head run
    if (pp.q_len > 0) {
      run_dropped(p, pp.q[pp.q_head]);
      pop_run(p, pp);
    }
  } else if (res < 0) {
    if (res == -ECANCELED) {
      // entry stays queued; a later chain re-sends it
    } else {
      peer_fail(p, id, res, eb);
      if (pp.q_len > 0) {
        run_dropped(p, pp.q[pp.q_head]);  // the failed head
        pop_run(p, pp);
      }
      drop_tail_runs(p, pp);
    }
  } else {
    PumpRun &r = pp.q[pp.q_head];
    if (res == 0 && r.sent < r.len) {
      peer_fail(p, id, -EPIPE, eb);
      if (pp.q_len > 0) {
        run_dropped(p, r);
        pop_run(p, pp);
      }
      drop_tail_runs(p, pp);
    } else {
      r.sent += (u32)res;
      if (r.sent >= r.len) {
        if (p->ring->telem != nullptr)
          run_delivered(p, pp, r, pcu_now_ns());
        pop_run(p, pp);
      } else if (pp.inflight > 0) {
        // short link mid-chain: later links already wrote past the gap
        // — the wire holds a torn frame; poison, never re-frame
        peer_fail(p, id, -EIO, eb);
        if (pp.q_len > 0) {
          run_dropped(p, pp.q[pp.q_head]);
          pop_run(p, pp);
        }
        drop_tail_runs(p, pp);
      } else {
        p->st_short_repump++;  // lone short tail: re-pump the residue
      }
    }
  }
  if (pp.inflight == 0 && pp.q_len == 0) {
    if (pp.err != 0 || pp.dead) {
      const bool was_dead = pp.dead;
      emit(p, eb, EV_PEER_QUIESCED, id, was_dead ? 1 : 0);
      if (was_dead) free_peer_slot(p, id);
    } else {
      emit(p, eb, EV_PEER_IDLE, id, 0);
    }
  }
  // inflight == 0 with q_len > 0 (re-pump / ECANCELED requeue) is
  // handled by the drain's chain sweep
}

}  // namespace

extern "C" {

void *pushcdn_pump_create(void *ring_handle, int max_peers, int chunk_slots,
                          int sq_reserve, long pair_cap) {
  if (ring_handle == nullptr || max_peers <= 0 || chunk_slots <= 0 ||
      pair_cap <= 0)
    return nullptr;
  Pump *p = new (std::nothrow) Pump();
  if (p == nullptr) return nullptr;
  p->ring = (pcu_ring *)ring_handle;
  p->max_peers = (u32)max_peers;
  p->n_chunks = (u32)chunk_slots;
  p->sq_reserve = sq_reserve > 0 ? (u32)sq_reserve : 0;
  p->pair_cap = pair_cap;
  p->peers = new (std::nothrow) PumpPeer[max_peers]();
  p->chunks = new (std::nothrow) ChunkSlot[chunk_slots]();
  p->chunk_free = (s32 *)std::malloc(sizeof(s32) * chunk_slots);
  p->released = (s32 *)std::malloc(sizeof(s32) * chunk_slots);
  p->pr_peer = (s32 *)std::malloc(sizeof(s32) * pair_cap);
  p->pr_frame = (s32 *)std::malloc(sizeof(s32) * pair_cap);
  p->pr_next = (s32 *)std::malloc(sizeof(s32) * pair_cap);
  p->touched = (s32 *)std::malloc(sizeof(s32) * max_peers);
  if (p->peers == nullptr || p->chunks == nullptr ||
      p->chunk_free == nullptr || p->released == nullptr ||
      p->pr_peer == nullptr || p->pr_frame == nullptr ||
      p->pr_next == nullptr || p->touched == nullptr) {
    delete[] p->peers;
    delete[] p->chunks;
    std::free(p->chunk_free);
    std::free(p->released);
    std::free(p->pr_peer);
    std::free(p->pr_frame);
    std::free(p->pr_next);
    std::free(p->touched);
    delete p;
    return nullptr;
  }
  for (int i = 0; i < chunk_slots; ++i)
    p->chunk_free[i] = chunk_slots - 1 - i;
  p->n_chunk_free = (u32)chunk_slots;
  return p;
}

void pushcdn_pump_destroy(void *handle) {
  Pump *p = (Pump *)handle;
  if (p == nullptr) return;
  for (u32 i = 0; i < p->max_peers; ++i) std::free(p->peers[i].q);
  delete[] p->peers;
  delete[] p->chunks;
  std::free(p->chunk_free);
  std::free(p->released);
  std::free(p->slot_map);
  std::free(p->pr_peer);
  std::free(p->pr_frame);
  std::free(p->pr_next);
  std::free(p->touched);
  delete p;
}

// Engage a connection: returns the pump id, or -1 when the table is full.
int pushcdn_pump_add_peer(void *handle, int fd) {
  Pump *p = (Pump *)handle;
  if (p == nullptr || fd < 0) return -1;
  for (u32 i = 0; i < p->max_peers; ++i) {
    PumpPeer &pp = p->peers[i];
    if (!pp.in_use) {
      pp = PumpPeer();
      pp.in_use = true;
      pp.fd = fd;
      return (int)i;
    }
  }
  return -1;
}

void pushcdn_pump_set_fence(void *handle, int id, int fenced) {
  Pump *p = (Pump *)handle;
  if (p == nullptr || id < 0 || (u32)id >= p->max_peers) return;
  p->peers[id].fenced = fenced != 0;
}

// Runs still owed to the wire (queued + inflight). 0 == fully drained.
long pushcdn_pump_peer_pending(void *handle, int id) {
  Pump *p = (Pump *)handle;
  if (p == nullptr || id < 0 || (u32)id >= p->max_peers) return 0;
  PumpPeer &pp = p->peers[id];
  return pp.in_use ? (long)pp.q_len : 0;
}

void pushcdn_pump_peer_stats(void *handle, int id, long long *out) {
  // out[6]: q_len, inflight, fenced, err, dead, in_use
  Pump *p = (Pump *)handle;
  std::memset(out, 0, 6 * sizeof(long long));
  if (p == nullptr || id < 0 || (u32)id >= p->max_peers) return;
  PumpPeer &pp = p->peers[id];
  out[0] = pp.q_len;
  out[1] = pp.inflight;
  out[2] = pp.fenced;
  out[3] = pp.err;
  out[4] = pp.dead;
  out[5] = pp.in_use;
}

// Disengage: drop queued-but-not-inflight runs NOW (their chunk refs
// land in take_released), mark the peer dead so trailing CQEs drain the
// rest, free the slot immediately when already quiesced. Returns 1 when
// the slot was freed synchronously, 0 when it frees on quiesce, -1 on a
// bad id.
int pushcdn_pump_drop_peer(void *handle, int id) {
  Pump *p = (Pump *)handle;
  if (p == nullptr || id < 0 || (u32)id >= p->max_peers) return -1;
  PumpPeer &pp = p->peers[id];
  if (!pp.in_use) return -1;
  drop_tail_runs(p, pp);
  pp.dead = true;
  if (pp.inflight == 0 && pp.q_len == 0) {
    free_peer_slot(p, (u32)id);
    return 1;
  }
  return 0;
}

// Chunk slots whose refcount hit zero since the last call: Python drops
// the parked pool leases. MUST be drained after every call that can
// release (drain / inject / drop_peer) and before the next route_chunk,
// or a reused slot would alias a fresh lease.
long pushcdn_pump_take_released(void *handle, int *out, long cap) {
  Pump *p = (Pump *)handle;
  if (p == nullptr) return 0;
  long n = (long)p->n_released;
  if (n > cap) n = cap;
  for (long i = 0; i < n; ++i) out[i] = p->released[i];
  if ((u32)n < p->n_released) {
    std::memmove(p->released, p->released + n,
                 sizeof(s32) * (p->n_released - (u32)n));
    p->n_released -= (u32)n;
  } else {
    p->n_released = 0;
  }
  return n;
}

// Replace the route-slot -> pump-id map (Python rebuilds it whenever the
// snapshot version moves; -1 = not pumped).
int pushcdn_pump_set_slots(void *handle, const int *slots, long n) {
  Pump *p = (Pump *)handle;
  if (p == nullptr || n < 0) return -1;
  if ((u32)n > p->slot_cap) {
    s32 *grown = (s32 *)std::realloc(p->slot_map, sizeof(s32) * n);
    if (grown == nullptr) return -1;
    p->slot_map = grown;
    p->slot_cap = (u32)n;
  }
  if (n) std::memcpy(p->slot_map, slots, sizeof(s32) * n);
  p->slot_n = (u32)n;
  return 0;
}

// out_meta (int64[16]):
//  0 consumed        1 stop            2 n_resid        3 chunk_slot (-1)
//  4 refs_added      5 sqes_prepped    6 pumped_pairs   7 pumped_user_pairs
//  8 pumped_broker_pairs  9 resid_unmapped  10 resid_fenced
// 11 resid_error    12 no_chunk_slot  13 pumped_runs   14 plan_pairs
int64_t pushcdn_pump_route_chunk(
    void *handle, void *table_handle, const unsigned char *buf,
    int64_t buf_len, const int64_t *offs, const int64_t *lens,
    int64_t start, int64_t count, int mode, int *resid_peer,
    int *resid_frame, int64_t resid_cap, int64_t *out_meta,
    unsigned char *out_class) {
  Pump *p = (Pump *)handle;
  RouteTable *t = (RouteTable *)table_handle;
  std::memset(out_meta, 0, 16 * sizeof(int64_t));
  out_meta[3] = -1;
  if (p == nullptr || t == nullptr) {
    out_meta[1] = 1;  // STOP_RESIDUAL: caller falls back
    return 0;
  }
  pcu_telem *tm = p->ring->telem;
  u64 t_recv = 0;
  if (tm != nullptr) {
    // recv stamp comes from the drain wakeup that delivered the chunk;
    // a stale stamp (cold start, >100ms old) falls back to "now" so an
    // idle gap never masquerades as plan latency
    const u64 now = pcu_now_ns();
    t_recv = (p->last_recv_ns != 0 && now >= p->last_recv_ns &&
              now - p->last_recv_ns < 100000000ull)
                 ? p->last_recv_ns
                 : now;
  }
  int64_t n_pairs = 0;
  int32_t stop = 0;
  int64_t consumed = pushcdn_route_plan(
      table_handle, buf, buf_len, offs, lens, start, count, mode,
      p->pr_peer, p->pr_frame, p->pair_cap, &n_pairs, &stop, out_class);
  if (consumed < 0) {
    out_meta[1] = 1;
    return 0;
  }
  u64 t_plan = 0;
  if (tm != nullptr && consumed > 0) {
    t_plan = pcu_now_ns();
    pcu_tm_observe(tm, &tm->stage[0], t_plan > t_recv ? t_plan - t_recv : 0);
  }
  out_meta[0] = consumed;
  out_meta[1] = stop;
  out_meta[14] = n_pairs;
  if (n_pairs == 0) return consumed;

  const bool have_chunk_slot = p->n_chunk_free > 0;
  if (!have_chunk_slot) out_meta[12] = 1;
  s32 chunk_slot = -1;
  u32 refs = 0;
  long n_touched = 0;
  int64_t n_resid = 0;
  const int n_users = t->n_users;

  // partition pairs: engaged peers stage onto per-peer frame-ordered
  // lists; everything else compacts into the residual arrays in frame
  // order (pairs already arrive frame-ordered from the plan)
  for (int64_t k = 0; k < n_pairs; ++k) {
    const s32 peer = p->pr_peer[k];
    s32 id = -1;
    if (have_chunk_slot && peer >= 0 && (u32)peer < p->slot_n)
      id = p->slot_map[peer];
    PumpPeer *pp = nullptr;
    if (id >= 0 && (u32)id < p->max_peers) {
      pp = &p->peers[id];
      if (!pp->in_use || pp->dead || pp->err != 0) {
        out_meta[11]++;
        pp = nullptr;
      } else if (pp->fenced) {
        out_meta[10]++;
        pp = nullptr;
      }
    } else if (have_chunk_slot) {
      out_meta[9]++;
    }
    if (pp != nullptr && pp->stage_head < 0) {
      // first pair for this peer this call: compact the queue to offset
      // 0 and make sure it can absorb the worst case (one run per
      // consumed frame) up front, so a failed realloc cleanly demotes
      // the peer to residual before any run is appended. Moving the
      // structs is safe mid-chain: the SQEs hold copies of addr/len and
      // accounting goes through q[q_head], which moves with them.
      if (pp->q_head > 0) {
        std::memmove(pp->q, pp->q + pp->q_head,
                     sizeof(PumpRun) * pp->q_len);
        pp->q_head = 0;
      }
      const u32 need = pp->q_len + (u32)consumed;
      if (need > pp->q_cap) {
        u32 cap = pp->q_cap ? pp->q_cap : 64;
        while (cap < need) cap *= 2;
        PumpRun *grown =
            (PumpRun *)std::realloc(pp->q, sizeof(PumpRun) * cap);
        if (grown == nullptr) {
          out_meta[11]++;
          pp = nullptr;
        } else {
          pp->q = grown;
          pp->q_cap = cap;
        }
      }
      if (pp != nullptr) {
        p->touched[n_touched++] = id;
        pp->stage_head = (s32)k;
        pp->stage_tail = (s32)k;
        p->pr_next[k] = -1;
      }
    } else if (pp != nullptr) {
      p->pr_next[pp->stage_tail] = (s32)k;
      p->pr_next[k] = -1;
      pp->stage_tail = (s32)k;
    }
    if (pp == nullptr) {
      if (n_resid < resid_cap) {
        resid_peer[n_resid] = peer;
        resid_frame[n_resid] = p->pr_frame[k];
        n_resid++;
      }
      continue;
    }
    out_meta[6]++;
    if (peer < n_users) out_meta[7]++; else out_meta[8]++;
  }
  out_meta[2] = n_resid;

  // build per-peer zero-copy runs (maximal contiguous frame spans) and
  // chain-submit for peers whose previous chain is idle
  int64_t prepped = 0, n_runs = 0;
  for (long i = 0; i < n_touched; ++i) {
    const u32 id = (u32)p->touched[i];
    PumpPeer &pp = p->peers[id];
    s32 k = pp.stage_head;
    while (k >= 0) {
      const s32 first = p->pr_frame[k];
      s32 last = first;
      s32 nk = p->pr_next[k];
      while (nk >= 0 && p->pr_frame[nk] == last + 1) {
        last = p->pr_frame[nk];
        nk = p->pr_next[nk];
      }
      if (chunk_slot < 0) {
        chunk_slot = p->chunk_free[--p->n_chunk_free];
        p->chunks[chunk_slot].in_use = true;
        p->chunks[chunk_slot].refs = 0;
        out_meta[3] = chunk_slot;
      }
      const int64_t a = offs[first] - 4;
      const int64_t b = offs[last] + lens[last];
      PumpRun &r = pp.q[pp.q_head + pp.q_len];
      r.addr = (unsigned long long)(uintptr_t)buf + (unsigned long long)a;
      r.len = (u32)(b - a);
      r.sent = 0;
      r.chunk_slot = chunk_slot;
      // the queue comes from realloc: always reset the telemetry fields
      // so a run queued while telemetry is off can't replay stale stamps
      // after a later enable
      r.t_recv = t_recv;
      r.t_ready = t_plan;
      r.t_submit = 0;
      for (int c = 0; c < PCU_TM_CLASSES; ++c) {
        r.cls_frames[c] = 0;
        r.cls_bytes[c] = 0;
      }
      if (out_class != nullptr) {
        for (s32 f = first; f <= last; ++f) {
          const int c = out_class[f] & (PCU_TM_CLASSES - 1);
          r.cls_frames[c]++;
          r.cls_bytes[c] += (u32)(lens[f] + 4);
        }
      }
      pp.q_len++;
      p->chunks[chunk_slot].refs++;
      refs++;
      n_runs++;
      p->st_bytes += (u64)(b - a);
      k = nk;
    }
    pp.stage_head = pp.stage_tail = -1;
    prepped += prep_chain(p, id);
  }
  p->st_runs += (u64)n_runs;
  p->st_frames += (u64)out_meta[6];
  out_meta[4] = refs;
  out_meta[5] = prepped;
  out_meta[13] = n_runs;
  return consumed;
}

// Drain the CQ: pump-tagged CQEs are accounted natively; the rest are
// compacted into (uds, ress, flagss) for the Python engine. Appends flat
// (type, a, b) event triples to `events`. Returns the count of non-pump
// CQEs; *n_prepped reports SQEs prepped by the post-drain chain sweep
// (the caller must schedule a submit when > 0). *n_events is the int64
// count written (triples * 3).
int pushcdn_pump_drain(void *handle, unsigned long long *uds, int *ress,
                       unsigned *flagss, int max, long long *events,
                       long ev_cap, long *n_events, long *n_prepped) {
  Pump *p = (Pump *)handle;
  *n_events = 0;
  *n_prepped = 0;
  if (p == nullptr) return 0;
  EvBuf eb{events, ev_cap, 0};
  pcu_ring *r = p->ring;
  if (r->telem != nullptr) p->last_recv_ns = pcu_now_ns();
  u32 head = *r->cq_khead;
  const u32 tail = LOAD_ACQ(r->cq_ktail);
  int n_out = 0;
  while (head != tail && n_out < max) {
    io_uring_cqe *cqe = &r->cqes[head & r->cq_mask];
    if (cqe->user_data & PUMP_UD_TAG) {
      pump_on_cqe(p, (u32)(cqe->user_data & 0xffffffffu), cqe->res, &eb);
    } else {
      uds[n_out] = cqe->user_data;
      ress[n_out] = cqe->res;
      flagss[n_out] = cqe->flags;
      n_out++;
    }
    head++;
  }
  STORE_REL(r->cq_khead, head);
  // chain sweep: any engaged peer with queued runs and an idle chain
  // (SQ was full at route_chunk time, a short-tail re-pump, ECANCELED
  // requeues) gets its next chain prepped now
  long prepped = 0;
  for (u32 i = 0; i < p->max_peers; ++i) {
    PumpPeer &pp = p->peers[i];
    if (pp.in_use && pp.err == 0 && !pp.dead && pp.inflight == 0 &&
        pp.q_len > 0)
      prepped += prep_chain(p, i);
  }
  *n_prepped = prepped;
  *n_events = eb.n;
  return n_out;
}

// Test hook: feed one synthetic completion through the pump's CQE
// accounting (the C twin of tests driving UringStream._on_send_cqe
// directly) — deterministic short-write / reset / mid-chain fault
// injection without a cooperating kernel.
int pushcdn_pump_inject_cqe(void *handle, int id, int res,
                            long long *events, long ev_cap,
                            long *n_events) {
  Pump *p = (Pump *)handle;
  *n_events = 0;
  if (p == nullptr || id < 0 || (u32)id >= p->max_peers) return -1;
  EvBuf eb{events, ev_cap, 0};
  pump_on_cqe(p, (u32)id, res, &eb);
  *n_events = eb.n;
  return 0;
}

void pushcdn_pump_stats(void *handle, unsigned long long *out) {
  // out[16]: runs, chains, sqes, cqes, bytes, frames, errors,
  //          short_repump, engaged, fenced, chunk_slots_free,
  //          queued_runs, ev_lost (rest reserved)
  Pump *p = (Pump *)handle;
  std::memset(out, 0, 16 * sizeof(unsigned long long));
  if (p == nullptr) return;
  out[0] = p->st_runs;
  out[1] = p->st_chains;
  out[2] = p->st_sqes;
  out[3] = p->st_cqes;
  out[4] = p->st_bytes;
  out[5] = p->st_frames;
  out[6] = p->st_errors;
  out[7] = p->st_short_repump;
  u64 engaged = 0, fenced = 0, queued = 0;
  for (u32 i = 0; i < p->max_peers; ++i) {
    PumpPeer &pp = p->peers[i];
    if (pp.in_use) {
      engaged++;
      if (pp.fenced) fenced++;
      queued += pp.q_len;
    }
  }
  out[8] = engaged;
  out[9] = fenced;
  out[10] = p->n_chunk_free;
  out[11] = queued;
  out[12] = p->st_ev_lost;
}

}  // extern "C"
