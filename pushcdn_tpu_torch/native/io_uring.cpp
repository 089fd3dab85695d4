// Raw io_uring submission/completion shim for the host data plane.
//
// Deliberately liburing-free: the three syscalls (io_uring_setup /
// io_uring_enter / io_uring_register) are invoked directly and every
// uapi struct is declared here, so the wheel carries zero native
// dependencies and builds on any glibc that can mmap. The Python side
// (pushcdn_tpu_torch/native/uring.py) drives this through ctypes; the ABI
// is plain C. One pcu_ring per event loop / shard worker.
//
// The port's own copy of the JAX package's native/io_uring.cpp, built by
// pushcdn_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC) into
// .build/torch_native/; pump.cpp beside it includes it.
//
// Responsibilities kept in C (everything the hot path touches per
// SQE/CQE): SQ tail/CQ head ring arithmetic with acquire/release
// ordering, SQE field layout, the provided-buffer ring (recv buffers
// the kernel picks from), and CQE batch extraction into flat arrays.
// Policy — what to submit, lifetime of buffers, ordering contracts —
// stays in Python where the writer queue lives.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <new>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using s32 = int32_t;

// ---- uapi mirror (linux/io_uring.h) ----------------------------------------

struct io_sqring_offsets {
    u32 head, tail, ring_mask, ring_entries, flags, dropped, array, resv1;
    u64 user_addr;
};
struct io_cqring_offsets {
    u32 head, tail, ring_mask, ring_entries, overflow, cqes, flags, resv1;
    u64 user_addr;
};
struct io_uring_params {
    u32 sq_entries, cq_entries, flags, sq_thread_cpu, sq_thread_idle;
    u32 features, wq_fd, resv[3];
    struct io_sqring_offsets sq_off;
    struct io_cqring_offsets cq_off;
};

struct io_uring_sqe {
    u8 opcode;
    u8 flags;
    u16 ioprio;
    s32 fd;
    union { u64 off; u64 addr2; };
    union { u64 addr; u64 splice_off_in; };
    u32 len;
    union {
        u32 rw_flags; u32 msg_flags; u32 accept_flags; u32 cancel_flags;
        u32 fsync_flags; u32 timeout_flags; u32 open_flags; u32 splice_flags;
    };
    u64 user_data;
    union { u16 buf_index; u16 buf_group; } __attribute__((packed));
    u16 personality;
    union { s32 splice_fd_in; u32 file_index; };
    u64 addr3;
    u64 __pad2[1];
};
static_assert(sizeof(io_uring_sqe) == 64, "sqe ABI drift");

struct io_uring_cqe {
    u64 user_data;
    s32 res;
    u32 flags;
};
static_assert(sizeof(io_uring_cqe) == 16, "cqe ABI drift");

struct io_uring_buf {
    u64 addr;
    u32 len;
    u16 bid;
    u16 resv;
};
// The pbuf ring is an array of io_uring_buf; the kernel-visible tail
// lives in the resv slot of entry 0 (uapi io_uring_buf_ring union).
struct io_uring_buf_reg {
    u64 ring_addr;
    u32 ring_entries;
    u16 bgid;
    u16 flags;
    u64 resv[3];
};
struct io_uring_rsrc_register {
    u32 nr;
    u32 flags;
    u64 resv2;
    u64 data;
    u64 tags;
};
struct io_uring_rsrc_update2 {
    u32 offset;
    u32 resv;
    u64 data;
    u64 tags;
    u32 nr;
    u32 resv2;
};
struct io_uring_probe_op {
    u8 op;
    u8 resv;
    u16 flags;  // IO_URING_OP_SUPPORTED
    u32 resv2;
};
struct io_uring_probe {
    u8 last_op;
    u8 ops_len;
    u16 resv;
    u32 resv2[3];
    struct io_uring_probe_op ops[64];
};

enum {
    IORING_OP_WRITE_FIXED = 5,
    IORING_OP_ACCEPT = 13,
    IORING_OP_ASYNC_CANCEL = 14,
    IORING_OP_SEND = 26,
    IORING_OP_RECV = 27,
    IORING_OP_SHUTDOWN = 34,
    IORING_OP_SEND_ZC = 47,
};
enum {
    IORING_SETUP_SQPOLL = 1u << 1,
    IORING_SETUP_CLAMP = 1u << 4,
};
enum {
    IORING_ENTER_GETEVENTS = 1u << 0,
    IORING_ENTER_SQ_WAKEUP = 1u << 1,
};
enum {
    IORING_SQ_NEED_WAKEUP = 1u << 0,
    IORING_SQ_CQ_OVERFLOW = 1u << 1,
};
enum {
    IORING_FEAT_SINGLE_MMAP = 1u << 0,
    IORING_FEAT_NODROP = 1u << 1,
};
enum {
    IOSQE_IO_LINK = 1u << 2,
    IOSQE_BUFFER_SELECT = 1u << 5,
};
enum {
    IORING_CQE_F_BUFFER = 1u << 0,
    IORING_CQE_F_MORE = 1u << 1,
    IORING_CQE_F_NOTIF = 1u << 3,
};
enum {
    IORING_RECVSEND_FIXED_BUF = 1u << 2,
    IORING_RECV_MULTISHOT = 1u << 1,
    IORING_ACCEPT_MULTISHOT = 1u << 0,
};
enum {
    IORING_REGISTER_BUFFERS2 = 15,
    IORING_REGISTER_BUFFERS_UPDATE = 16,
    IORING_REGISTER_PROBE = 8,
    IORING_REGISTER_EVENTFD = 4,
    IORING_REGISTER_EVENTFD_ASYNC = 7,
    IORING_UNREGISTER_EVENTFD = 5,
    IORING_REGISTER_PBUF_RING = 22,
    IORING_UNREGISTER_PBUF_RING = 23,
};
enum { IORING_RSRC_REGISTER_SPARSE = 1u << 0 };
enum { IO_URING_OP_SUPPORTED = 1u << 0 };

constexpr u64 IORING_OFF_SQ_RING = 0ULL;
constexpr u64 IORING_OFF_CQ_RING = 0x8000000ULL;
constexpr u64 IORING_OFF_SQES = 0x10000000ULL;

#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#define __NR_io_uring_enter 426
#define __NR_io_uring_register 427
#endif

static int sys_setup(unsigned entries, struct io_uring_params *p) {
    int r = (int)syscall(__NR_io_uring_setup, entries, p);
    return r < 0 ? -errno : r;
}
static long sys_enter(int fd, unsigned to_submit, unsigned min_complete,
                      unsigned flags) {
    long r = syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                     flags, nullptr, 0);
    return r < 0 ? -errno : r;
}
static int sys_register(int fd, unsigned opcode, void *arg, unsigned nr) {
    int r = (int)syscall(__NR_io_uring_register, fd, opcode, arg, nr);
    return r < 0 ? -errno : r;
}

#define LOAD_ACQ(p) __atomic_load_n((p), __ATOMIC_ACQUIRE)
#define STORE_REL(p, v) __atomic_store_n((p), (v), __ATOMIC_RELEASE)

}  // namespace

// ---- native telemetry block -------------------------------------------------
//
// A shared-memory stats block the data plane stamps with CLOCK_MONOTONIC
// (vdso — no syscall) at each stage boundary: recv-CQE -> plan-done ->
// SQE-submit -> send-CQE. Values accumulate into log2-ns bucket
// histograms + per-class / per-peer counters; a single sequence word
// makes whole-block snapshots torn-read-safe (the same commit-word
// scheme as the shard handoff ring): the writer bumps it to odd around
// every update, the reader retries until it observes the same even
// value on both sides of its copy. Single writer (the ring's event-loop
// thread), any number of snapshot readers.

enum {
    PCU_TM_BUCKETS = 64,  // bucket k counts durations in [2^(k-1), 2^k) ns
    PCU_TM_STAGES = 4,    // 0=plan 1=submit 2=wire 3=total
    PCU_TM_CHAIN = 2,     // 0=enter (io_uring_enter wall) 1=chain (submit->quiesce)
    PCU_TM_CLASSES = 4,   // 0=control 1=consensus 2=live 3=bulk
    PCU_TM_PEERS = 64,    // bounded per-peer counter table (fd-keyed)
};

struct pcu_hist {
    u64 count;
    u64 sum_ns;
    u64 bucket[PCU_TM_BUCKETS];
};

struct pcu_telem {
    u64 seq;  // seqlock commit word (odd = write in progress)
    // everything below `seq` is the snapshot payload, flat u64s
    pcu_hist stage[PCU_TM_STAGES];
    pcu_hist chain[PCU_TM_CHAIN];
    pcu_hist class_delay[PCU_TM_CLASSES];  // recv->send-CQE, per frame
    u64 class_frames[PCU_TM_CLASSES];      // pumped deliveries (dir=out)
    u64 class_bytes[PCU_TM_CLASSES];
    u64 peer_fd[PCU_TM_PEERS];
    u64 peer_frames[PCU_TM_PEERS];
    u64 peer_bytes[PCU_TM_PEERS];
    u64 peer_used;
    // frame-fate ledger: pumped frames DROPPED in C (peer
    // poisoned / send error / chain teardown), per class — appended at
    // the end so every prior snapshot offset stays stable
    u64 fate_drop_frames[PCU_TM_CLASSES];
};

static inline u64 pcu_now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (u64)ts.tv_sec * 1000000000ull + (u64)ts.tv_nsec;
}

// write_seqcount_begin/end: the fences are store-store barriers so the
// payload stores can never be observed outside the odd window
static inline void pcu_tm_begin(pcu_telem *t) {
    __atomic_store_n(&t->seq, t->seq + 1, __ATOMIC_RELAXED);
    __atomic_thread_fence(__ATOMIC_RELEASE);
}

static inline void pcu_tm_end(pcu_telem *t) {
    __atomic_store_n(&t->seq, t->seq + 1, __ATOMIC_RELEASE);
}

static inline int pcu_log2_bucket(u64 ns) {
    if (!ns) return 0;
    int b = 64 - __builtin_clzll(ns);
    return b >= PCU_TM_BUCKETS ? PCU_TM_BUCKETS - 1 : b;
}

// one observation: 2 sequence bumps + 3 plain adds (no lock, no syscall)
static inline void pcu_tm_observe(pcu_telem *t, pcu_hist *h, u64 ns) {
    pcu_tm_begin(t);
    h->count++;
    h->sum_ns += ns;
    h->bucket[pcu_log2_bucket(ns)]++;
    pcu_tm_end(t);
}

// weighted observation (per-class delay: one duration covers n frames)
static inline void pcu_tm_observe_n(pcu_telem *t, pcu_hist *h, u64 ns,
                                    u64 n) {
    if (!n) return;
    pcu_tm_begin(t);
    h->count += n;
    h->sum_ns += ns * n;
    h->bucket[pcu_log2_bucket(ns)] += n;
    pcu_tm_end(t);
}

struct pcu_ring {
    int fd = -1;
    unsigned sq_entries = 0, cq_entries = 0;
    unsigned features = 0, setup_flags = 0;

    void *sq_ptr = nullptr, *cq_ptr = nullptr;
    size_t sq_sz = 0, cq_sz = 0;
    io_uring_sqe *sqes = nullptr;
    size_t sqes_sz = 0;

    u32 *sq_khead = nullptr, *sq_ktail = nullptr, *sq_kflags = nullptr;
    u32 *sq_array = nullptr;
    u32 sq_mask = 0;
    u32 *cq_khead = nullptr, *cq_ktail = nullptr, *cq_koverflow = nullptr;
    io_uring_cqe *cqes = nullptr;
    u32 cq_mask = 0;

    u32 local_tail = 0;       // SQEs prepped
    u32 local_submitted = 0;  // SQEs handed to the kernel

    // provided-buffer ring (recv buffers), bgid 0
    io_uring_buf *pbuf_ring = nullptr;
    u8 *pbuf_slab = nullptr;
    unsigned pbuf_entries = 0, pbuf_len = 0;
    u16 *pbuf_tail = nullptr;

    // native telemetry block (null = telemetry off: one branch per site)
    pcu_telem *telem = nullptr;
};

extern "C" {

// One-shot capability probe: can this kernel/seccomp profile set up a
// ring at all, and does it speak the opcodes the data plane uses?
// Returns a bitmask (>0) on success: bit0 always, bit1 SEND_ZC
// supported. Returns -errno (ENOSYS under old kernels, EPERM under
// seccomp/sysctl io_uring_disabled) when denied.
long pcu_probe(void) {
    struct io_uring_params p;
    memset(&p, 0, sizeof(p));
    int fd = sys_setup(4, &p);
    if (fd < 0)
        return fd;
    long out = 1;
    struct io_uring_probe pr;
    memset(&pr, 0, sizeof(pr));
    if (sys_register(fd, IORING_REGISTER_PROBE, &pr, 64) == 0) {
        bool base_ok = true;
        const u8 need[] = {IORING_OP_SEND, IORING_OP_RECV, IORING_OP_ACCEPT,
                           IORING_OP_ASYNC_CANCEL, IORING_OP_WRITE_FIXED};
        for (u8 op : need)
            if (op > pr.last_op || !(pr.ops[op].flags & IO_URING_OP_SUPPORTED))
                base_ok = false;
        if (!base_ok) {
            close(fd);
            return -ENOSYS;
        }
        if (IORING_OP_SEND_ZC <= pr.last_op &&
            (pr.ops[IORING_OP_SEND_ZC].flags & IO_URING_OP_SUPPORTED))
            out |= 2;
    }
    close(fd);
    return out;
}

pcu_ring *pcu_create(unsigned entries, unsigned sqpoll,
                     unsigned sq_thread_idle_ms, int *err_out) {
    pcu_ring *r = new (std::nothrow) pcu_ring();
    if (!r) {
        if (err_out) *err_out = -ENOMEM;
        return nullptr;
    }
    struct io_uring_params p;
    memset(&p, 0, sizeof(p));
    p.flags = IORING_SETUP_CLAMP;
    if (sqpoll) {
        p.flags |= IORING_SETUP_SQPOLL;
        p.sq_thread_idle = sq_thread_idle_ms ? sq_thread_idle_ms : 50;
    }
    int fd = sys_setup(entries, &p);
    if (fd < 0) {
        if (err_out) *err_out = fd;
        delete r;
        return nullptr;
    }
    r->fd = fd;
    r->sq_entries = p.sq_entries;
    r->cq_entries = p.cq_entries;
    r->features = p.features;
    r->setup_flags = p.flags;

    r->sq_sz = p.sq_off.array + p.sq_entries * sizeof(u32);
    r->cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
        if (r->cq_sz > r->sq_sz) r->sq_sz = r->cq_sz;
        r->cq_sz = r->sq_sz;
    }
    r->sq_ptr = mmap(nullptr, r->sq_sz, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (r->sq_ptr == MAP_FAILED) goto fail;
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
        r->cq_ptr = r->sq_ptr;
    } else {
        r->cq_ptr = mmap(nullptr, r->cq_sz, PROT_READ | PROT_WRITE,
                         MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
        if (r->cq_ptr == MAP_FAILED) { r->cq_ptr = nullptr; goto fail; }
    }
    r->sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
    r->sqes = (io_uring_sqe *)mmap(nullptr, r->sqes_sz,
                                   PROT_READ | PROT_WRITE,
                                   MAP_SHARED | MAP_POPULATE, fd,
                                   IORING_OFF_SQES);
    if (r->sqes == MAP_FAILED) { r->sqes = nullptr; goto fail; }

    {
        u8 *sq = (u8 *)r->sq_ptr;
        r->sq_khead = (u32 *)(sq + p.sq_off.head);
        r->sq_ktail = (u32 *)(sq + p.sq_off.tail);
        r->sq_kflags = (u32 *)(sq + p.sq_off.flags);
        r->sq_array = (u32 *)(sq + p.sq_off.array);
        r->sq_mask = *(u32 *)(sq + p.sq_off.ring_mask);
        u8 *cq = (u8 *)r->cq_ptr;
        r->cq_khead = (u32 *)(cq + p.cq_off.head);
        r->cq_ktail = (u32 *)(cq + p.cq_off.tail);
        r->cq_koverflow = (u32 *)(cq + p.cq_off.overflow);
        r->cqes = (io_uring_cqe *)(cq + p.cq_off.cqes);
        r->cq_mask = *(u32 *)(cq + p.cq_off.ring_mask);
        // identity SQ index array: slot i always points at SQE i
        for (u32 i = 0; i <= r->sq_mask; i++) r->sq_array[i] = i;
    }
    if (err_out) *err_out = 0;
    return r;

fail:
    if (err_out) *err_out = -errno;
    if (r->sqes) munmap(r->sqes, r->sqes_sz);
    if (r->cq_ptr && r->cq_ptr != r->sq_ptr) munmap(r->cq_ptr, r->cq_sz);
    if (r->sq_ptr) munmap(r->sq_ptr, r->sq_sz);
    close(fd);
    delete r;
    return nullptr;
}

void pcu_destroy(pcu_ring *r) {
    if (!r) return;
    if (r->sqes) munmap(r->sqes, r->sqes_sz);
    if (r->cq_ptr && r->cq_ptr != r->sq_ptr) munmap(r->cq_ptr, r->cq_sz);
    if (r->sq_ptr) munmap(r->sq_ptr, r->sq_sz);
    if (r->fd >= 0) close(r->fd);
    free(r->pbuf_ring);
    free(r->pbuf_slab);
    if (r->telem) munmap(r->telem, sizeof(pcu_telem));
    delete r;
}

// ---- telemetry ABI ----------------------------------------------------------

// Allocate + attach the shm telemetry block (idempotent). MAP_SHARED |
// MAP_ANONYMOUS: same address space here, but the mapping survives a
// fork and is the natural substrate should a sibling process ever map
// it — and it is page-aligned and zero-filled by the kernel.
int pcu_telem_enable(pcu_ring *r) {
    if (r->telem) return 0;
    void *p = mmap(nullptr, sizeof(pcu_telem), PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return -errno;
    r->telem = (pcu_telem *)p;
    return 0;
}

int pcu_telem_enabled(pcu_ring *r) { return r->telem ? 1 : 0; }

// Snapshot payload size in u64 words (everything after the seq word).
long pcu_telem_words(void) {
    return (long)((sizeof(pcu_telem) - sizeof(u64)) / sizeof(u64));
}

// Torn-read-safe whole-block copy: retry until the sequence word reads
// the same even value on both sides. Returns words copied, 0 when
// telemetry is off, -1 on a too-small buffer, -2 if the writer never
// went quiet (callers keep their previous snapshot).
long pcu_telem_snapshot(pcu_ring *r, unsigned long long *out, long cap) {
    pcu_telem *t = r->telem;
    if (!t) return 0;
    const long words = pcu_telem_words();
    if (cap < words) return -1;
    for (int attempt = 0; attempt < 1000; attempt++) {
        u64 s1 = __atomic_load_n(&t->seq, __ATOMIC_ACQUIRE);
        if (s1 & 1) continue;
        memcpy(out, (const u8 *)t + sizeof(u64),
               (size_t)words * sizeof(u64));
        __atomic_thread_fence(__ATOMIC_ACQUIRE);
        u64 s2 = __atomic_load_n(&t->seq, __ATOMIC_RELAXED);
        if (s1 == s2) return words;
    }
    return -2;
}

// Test hook: drive one observation into a chosen histogram from Python
// (kind 0 = stage, 1 = chain, 2 = class_delay) so the seqlock and the
// log2 bucketing are testable without a live pumped ring.
int pcu_telem_test_observe(pcu_ring *r, int kind, int idx,
                           unsigned long long ns, unsigned long long n) {
    pcu_telem *t = r->telem;
    if (!t) return -1;
    pcu_hist *h;
    if (kind == 0 && idx >= 0 && idx < PCU_TM_STAGES) h = &t->stage[idx];
    else if (kind == 1 && idx >= 0 && idx < PCU_TM_CHAIN) h = &t->chain[idx];
    else if (kind == 2 && idx >= 0 && idx < PCU_TM_CLASSES)
        h = &t->class_delay[idx];
    else return -2;
    pcu_tm_observe_n(t, h, ns, n ? n : 1);
    return 0;
}

// Test hook: bump the flat per-class counters (which 0 = class_frames,
// 1 = fate_drop_frames) so the conservation-ledger fold in metrics.py
// is testable without a live pumped ring.
int pcu_telem_test_count(pcu_ring *r, int which, int idx,
                         unsigned long long n) {
    pcu_telem *t = r->telem;
    if (!t) return -1;
    if (idx < 0 || idx >= PCU_TM_CLASSES || which < 0 || which > 1)
        return -2;
    pcu_tm_begin(t);
    if (which == 0) t->class_frames[idx] += n;
    else t->fate_drop_frames[idx] += n;
    pcu_tm_end(t);
    return 0;
}

int pcu_ring_fd(pcu_ring *r) { return r->fd; }
unsigned pcu_sq_entries(pcu_ring *r) { return r->sq_entries; }

int pcu_register_eventfd(pcu_ring *r, int efd, int async_only) {
    unsigned op = async_only ? IORING_REGISTER_EVENTFD_ASYNC
                             : IORING_REGISTER_EVENTFD;
    int rc = sys_register(r->fd, op, &efd, 1);
    if (rc < 0 && async_only)  // pre-5.1-ASYNC kernels: plain eventfd
        rc = sys_register(r->fd, IORING_REGISTER_EVENTFD, &efd, 1);
    return rc;
}

// Sparse fixed-buffer table; individual slots are filled later as the
// egress pool hands buffers over (registration is a page-pinning
// operation — done once per pooled buffer, not per send).
int pcu_register_buf_table(pcu_ring *r, unsigned nslots) {
    struct io_uring_rsrc_register rr;
    memset(&rr, 0, sizeof(rr));
    rr.nr = nslots;
    rr.flags = IORING_RSRC_REGISTER_SPARSE;
    return sys_register(r->fd, IORING_REGISTER_BUFFERS2, &rr, sizeof(rr));
}

int pcu_update_buf(pcu_ring *r, unsigned slot, void *addr,
                   unsigned long len) {
    struct iovec { void *iov_base; size_t iov_len; } iov = {addr, len};
    u64 tag = 0;
    struct io_uring_rsrc_update2 up;
    memset(&up, 0, sizeof(up));
    up.offset = slot;
    up.data = (u64)(uintptr_t)&iov;
    up.tags = (u64)(uintptr_t)&tag;
    up.nr = 1;
    return sys_register(r->fd, IORING_REGISTER_BUFFERS_UPDATE, &up,
                        sizeof(up));
}

// Provided-buffer ring (bgid 0): the kernel picks a free buffer per
// multishot-recv completion; Python copies the payload out and recycles
// the bid immediately, so the slab is sized for in-flight CQEs only.
int pcu_pbuf_setup(pcu_ring *r, unsigned entries, unsigned buflen,
                   unsigned long long *base_out) {
    if (r->pbuf_ring) return -EEXIST;
    if (entries & (entries - 1)) return -EINVAL;
    io_uring_buf *ring = (io_uring_buf *)aligned_alloc(
        4096, entries * sizeof(io_uring_buf));
    u8 *slab = (u8 *)malloc((size_t)entries * buflen);
    if (!ring || !slab) { free(ring); free(slab); return -ENOMEM; }
    memset(ring, 0, entries * sizeof(io_uring_buf));
    struct io_uring_buf_reg reg;
    memset(&reg, 0, sizeof(reg));
    reg.ring_addr = (u64)(uintptr_t)ring;
    reg.ring_entries = entries;
    reg.bgid = 0;
    int rc = sys_register(r->fd, IORING_REGISTER_PBUF_RING, &reg, 1);
    if (rc < 0) { free(ring); free(slab); return rc; }
    r->pbuf_ring = ring;
    r->pbuf_slab = slab;
    r->pbuf_entries = entries;
    r->pbuf_len = buflen;
    r->pbuf_tail = &ring[0].resv;  // uapi: tail overlays entry 0's resv
    u16 tail = 0;
    for (unsigned i = 0; i < entries; i++) {
        io_uring_buf *e = &ring[tail & (entries - 1)];
        e->addr = (u64)(uintptr_t)(slab + (size_t)i * buflen);
        e->len = buflen;
        e->bid = (u16)i;
        tail++;
    }
    STORE_REL(r->pbuf_tail, tail);
    if (base_out) *base_out = (unsigned long long)(uintptr_t)slab;
    return 0;
}

void pcu_pbuf_recycle(pcu_ring *r, unsigned short bid) {
    u16 tail = *r->pbuf_tail;
    io_uring_buf *e = &r->pbuf_ring[tail & (r->pbuf_entries - 1)];
    e->addr = (u64)(uintptr_t)(r->pbuf_slab + (size_t)bid * r->pbuf_len);
    e->len = r->pbuf_len;
    e->bid = bid;
    STORE_REL(r->pbuf_tail, (u16)(tail + 1));
}

unsigned pcu_pbuf_buflen(pcu_ring *r) { return r->pbuf_len; }

// ---- SQE prep --------------------------------------------------------------

static io_uring_sqe *next_sqe(pcu_ring *r) {
    u32 head = LOAD_ACQ(r->sq_khead);
    if (r->local_tail - head >= r->sq_entries)
        return nullptr;  // SQ full: caller must submit first
    io_uring_sqe *sqe = &r->sqes[r->local_tail & r->sq_mask];
    memset(sqe, 0, sizeof(*sqe));
    r->local_tail++;
    return sqe;
}

int pcu_sq_space(pcu_ring *r) {
    u32 head = LOAD_ACQ(r->sq_khead);
    return (int)(r->sq_entries - (r->local_tail - head));
}

int pcu_prep_send(pcu_ring *r, int fd, unsigned long long addr, unsigned len,
                  unsigned long long ud, unsigned sqe_flags,
                  unsigned msg_flags) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_SEND;
    sqe->flags = (u8)sqe_flags;
    sqe->fd = fd;
    sqe->addr = addr;
    sqe->len = len;
    sqe->msg_flags = msg_flags;
    sqe->user_data = ud;
    return 0;
}

// MSG_ZEROCOPY send: posts the normal CQE (res = bytes, F_MORE) and a
// later F_NOTIF CQE once the kernel is done with the pages; buf_index
// >= 0 selects a registered fixed buffer.
int pcu_prep_send_zc(pcu_ring *r, int fd, unsigned long long addr,
                     unsigned len, unsigned long long ud,
                     unsigned sqe_flags, unsigned msg_flags, int buf_index) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_SEND_ZC;
    sqe->flags = (u8)sqe_flags;
    sqe->fd = fd;
    sqe->addr = addr;
    sqe->len = len;
    sqe->msg_flags = msg_flags;
    sqe->user_data = ud;
    if (buf_index >= 0) {
        sqe->ioprio = IORING_RECVSEND_FIXED_BUF;
        sqe->buf_index = (u16)buf_index;
    }
    return 0;
}

int pcu_prep_write_fixed(pcu_ring *r, int fd, unsigned long long addr,
                         unsigned len, int buf_index, unsigned long long ud,
                         unsigned sqe_flags) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_WRITE_FIXED;
    sqe->flags = (u8)sqe_flags;
    sqe->fd = fd;
    sqe->addr = addr;
    sqe->len = len;
    sqe->buf_index = (u16)buf_index;
    sqe->user_data = ud;
    return 0;
}

int pcu_prep_recv_multishot(pcu_ring *r, int fd, unsigned long long ud) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_RECV;
    sqe->flags = IOSQE_BUFFER_SELECT;
    sqe->ioprio = IORING_RECV_MULTISHOT;
    sqe->fd = fd;
    sqe->buf_group = 0;
    sqe->user_data = ud;
    return 0;
}

int pcu_prep_recv(pcu_ring *r, int fd, unsigned long long addr, unsigned len,
                  unsigned long long ud) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_RECV;
    sqe->fd = fd;
    sqe->addr = addr;
    sqe->len = len;
    sqe->user_data = ud;
    return 0;
}

int pcu_prep_accept_multishot(pcu_ring *r, int fd, unsigned long long ud) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_ACCEPT;
    sqe->ioprio = IORING_ACCEPT_MULTISHOT;
    sqe->fd = fd;
    sqe->user_data = ud;
    return 0;
}

int pcu_prep_cancel(pcu_ring *r, unsigned long long target_ud,
                    unsigned long long ud) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_ASYNC_CANCEL;
    sqe->addr = target_ud;
    sqe->fd = -1;
    sqe->user_data = ud;
    return 0;
}

int pcu_prep_shutdown(pcu_ring *r, int fd, int how, unsigned long long ud) {
    io_uring_sqe *sqe = next_sqe(r);
    if (!sqe) return -EBUSY;
    sqe->opcode = IORING_OP_SHUTDOWN;
    sqe->fd = fd;
    sqe->len = (u32)how;
    sqe->user_data = ud;
    return 0;
}

// ---- submit / complete -----------------------------------------------------

// Publish prepped SQEs. Non-SQPOLL: one io_uring_enter covering every
// SQE prepped since the last submit (the whole point — one syscall per
// loop tick, not per flush). SQPOLL: zero syscalls unless the poller
// thread went idle and needs a wakeup. Returns number consumed, or
// -errno.
long pcu_submit(pcu_ring *r, unsigned wait_nr) {
    u32 to_submit = r->local_tail - r->local_submitted;
    STORE_REL(r->sq_ktail, r->local_tail);
    if (r->setup_flags & IORING_SETUP_SQPOLL) {
        r->local_submitted = r->local_tail;
        unsigned flags = 0;
        if (LOAD_ACQ(r->sq_kflags) & IORING_SQ_NEED_WAKEUP)
            flags |= IORING_ENTER_SQ_WAKEUP;
        if (wait_nr) flags |= IORING_ENTER_GETEVENTS;
        if (!flags) return to_submit;  // poller awake: zero-syscall submit
        u64 t0 = r->telem ? pcu_now_ns() : 0;
        long rc = sys_enter(r->fd, 0, wait_nr, flags);
        if (r->telem)
            pcu_tm_observe(r->telem, &r->telem->chain[0],
                           pcu_now_ns() - t0);
        return rc < 0 ? rc : (long)to_submit;
    }
    if (!to_submit && !wait_nr) return 0;
    unsigned flags = wait_nr ? IORING_ENTER_GETEVENTS : 0;
    u64 t0 = r->telem ? pcu_now_ns() : 0;
    long rc = sys_enter(r->fd, to_submit, wait_nr, flags);
    if (r->telem)
        pcu_tm_observe(r->telem, &r->telem->chain[0], pcu_now_ns() - t0);
    if (rc < 0) return rc;
    r->local_submitted += (u32)rc;
    return rc;
}

int pcu_cq_overflowed(pcu_ring *r) {
    return (LOAD_ACQ(r->sq_kflags) & IORING_SQ_CQ_OVERFLOW) ? 1 : 0;
}

// Flush kernel-side overflowed CQEs back into the ring (NODROP path).
long pcu_flush_overflow(pcu_ring *r) {
    return sys_enter(r->fd, 0, 0, IORING_ENTER_GETEVENTS);
}

// Drain up to max CQEs into flat arrays (one ctypes call per drain, not
// per completion).
int pcu_peek_cqes(pcu_ring *r, unsigned long long *uds, int *ress,
                  unsigned *flagss, int max) {
    u32 head = *r->cq_khead;
    u32 tail = LOAD_ACQ(r->cq_ktail);
    int n = 0;
    while (head != tail && n < max) {
        io_uring_cqe *cqe = &r->cqes[head & r->cq_mask];
        uds[n] = cqe->user_data;
        ress[n] = cqe->res;
        flagss[n] = cqe->flags;
        n++;
        head++;
    }
    if (n) STORE_REL(r->cq_khead, head);
    return n;
}

}  // extern "C"
