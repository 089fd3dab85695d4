// LD_PRELOAD syscall-attribution interposer for the io-impl A/B bench.
//
// Counts the data-plane syscalls a process issues (write/send*/read/recv*/
// epoll_wait and io_uring_enter via the glibc syscall() wrapper) by
// interposing the libc PLT symbols. strace is absent from the bench
// container and /proc/self/io does not count socket ops, so this is the
// honest per-message attribution source: the bench child loads this very
// library via ctypes (dlopen of an already-LD_PRELOADed DSO returns the
// same mapping) and reads counter deltas around the measured loop.
//
// Only calls that cross a PLT are seen (glibc-internal calls bypass
// interposition) — exactly the set CPython and our native shim issue.
//
// The port's own copy of the JAX package's native/syscount.cpp, built by
// pushcdn_tpu_torch/native/syscount.py (g++ -O3 -shared -fPIC ... -ldl)
// into .build/torch_native/.

#define _GNU_SOURCE 1
#include <dlfcn.h>
#include <stdarg.h>
#include <stddef.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <sys/uio.h>

extern "C" {

enum {
    C_WRITE = 0, C_WRITEV, C_SEND, C_SENDTO, C_SENDMSG,
    C_READ, C_RECV, C_RECVFROM, C_RECVMSG,
    C_EPOLL_WAIT, C_EPOLL_PWAIT, C_URING_ENTER,
    C_COUNT
};

static unsigned long long g_counts[C_COUNT];

static inline void bump(int idx) {
    __atomic_fetch_add(&g_counts[idx], 1ull, __ATOMIC_RELAXED);
}

// counter access for the in-process reader (ctypes)
unsigned long long pcu_syscount(int idx) {
    if (idx < 0 || idx >= C_COUNT) return 0;
    return __atomic_load_n(&g_counts[idx], __ATOMIC_RELAXED);
}

int pcu_syscount_n(void) { return C_COUNT; }

#define REAL(name, ret, ...)                                              \
    typedef ret (*name##_fn)(__VA_ARGS__);                                \
    static name##_fn real_##name;                                         \
    static name##_fn get_##name(void) {                                   \
        if (!real_##name)                                                 \
            real_##name = (name##_fn)dlsym(RTLD_NEXT, #name);             \
        return real_##name;                                               \
    }

REAL(write, ssize_t, int, const void *, size_t)
REAL(writev, ssize_t, int, const struct iovec *, int)
REAL(send, ssize_t, int, const void *, size_t, int)
REAL(sendto, ssize_t, int, const void *, size_t, int,
     const struct sockaddr *, socklen_t)
REAL(sendmsg, ssize_t, int, const struct msghdr *, int)
REAL(read, ssize_t, int, void *, size_t)
REAL(recv, ssize_t, int, void *, size_t, int)
REAL(recvfrom, ssize_t, int, void *, size_t, int, struct sockaddr *,
     socklen_t *)
REAL(recvmsg, ssize_t, int, struct msghdr *, int)
REAL(epoll_wait, int, int, struct epoll_event *, int, int)
REAL(epoll_pwait, int, int, struct epoll_event *, int, int,
     const sigset_t *)
REAL(syscall, long, long, ...)

ssize_t write(int fd, const void *buf, size_t n) {
    bump(C_WRITE);
    return get_write()(fd, buf, n);
}

ssize_t writev(int fd, const struct iovec *iov, int cnt) {
    bump(C_WRITEV);
    return get_writev()(fd, iov, cnt);
}

ssize_t send(int fd, const void *buf, size_t n, int flags) {
    bump(C_SEND);
    return get_send()(fd, buf, n, flags);
}

ssize_t sendto(int fd, const void *buf, size_t n, int flags,
               const struct sockaddr *addr, socklen_t alen) {
    bump(C_SENDTO);
    return get_sendto()(fd, buf, n, flags, addr, alen);
}

ssize_t sendmsg(int fd, const struct msghdr *msg, int flags) {
    bump(C_SENDMSG);
    return get_sendmsg()(fd, msg, flags);
}

ssize_t read(int fd, void *buf, size_t n) {
    bump(C_READ);
    return get_read()(fd, buf, n);
}

ssize_t recv(int fd, void *buf, size_t n, int flags) {
    bump(C_RECV);
    return get_recv()(fd, buf, n, flags);
}

ssize_t recvfrom(int fd, void *buf, size_t n, int flags,
                 struct sockaddr *addr, socklen_t *alen) {
    bump(C_RECVFROM);
    return get_recvfrom()(fd, buf, n, flags, addr, alen);
}

ssize_t recvmsg(int fd, struct msghdr *msg, int flags) {
    bump(C_RECVMSG);
    return get_recvmsg()(fd, msg, flags);
}

int epoll_wait(int epfd, struct epoll_event *ev, int max, int timeout) {
    bump(C_EPOLL_WAIT);
    return get_epoll_wait()(epfd, ev, max, timeout);
}

int epoll_pwait(int epfd, struct epoll_event *ev, int max, int timeout,
                const sigset_t *sig) {
    bump(C_EPOLL_PWAIT);
    return get_epoll_pwait()(epfd, ev, max, timeout, sig);
}

#ifndef SYS_io_uring_enter
#define SYS_io_uring_enter 426
#endif

// The native uring shim issues io_uring_enter through glibc's variadic
// syscall() wrapper; forwarding six longs matches the SysV ABI for every
// syscall shape.
long syscall(long number, ...) {
    if (number == SYS_io_uring_enter) bump(C_URING_ENTER);
    va_list ap;
    va_start(ap, number);
    long a = va_arg(ap, long);
    long b = va_arg(ap, long);
    long c = va_arg(ap, long);
    long d = va_arg(ap, long);
    long e = va_arg(ap, long);
    long f = va_arg(ap, long);
    va_end(ap);
    return get_syscall()(number, a, b, c, d, e, f);
}

}  // extern "C"
