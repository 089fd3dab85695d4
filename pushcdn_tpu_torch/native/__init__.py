"""ctypes bindings for the host routines in C++ (``framing.cpp`` and
``pydecode.cpp`` beside this file): the ring packer, the wire scanner and
encoder, the device plane's egress encoder and the batch decoder.

The port's own copy of ``pushcdn_tpu.native``: it builds from the sources
in this directory and never from the JAX package's. These are host
routines, not kernels on the card, so ``g++`` builds them (``-O3 -shared
-fPIC``, plain C ABI through ctypes) at first use into
``.build/torch_native/`` at the repository root. Each library's file name
carries a hash of its source and flags (and, for the CPython-API decoder,
the interpreter's ``SOABI``), so an edited source is rebuilt and a stale
library never loads; a build writes a per-process temporary file and
moves it into place, so processes building at the same moment do not
race.

Without the libraries (``g++`` missing or failing) ``available()`` is
False and every routine answers None, so callers take their Python
branches, as the JAX package's do. The device planes do not accept that
on the card: there they require the engine at warm-up
(``broker.pump_common.require_native_egress``).

This module uses numpy and ctypes only: host-only processes import it
through the transport without importing torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the last build or load failed (None: no failure)
_build_errors: dict = {}


def library_path(name: str, extra_flags: tuple = (), tag: str = "") -> Path:
    """Where ``<name>.cpp`` builds to: keyed by the source, the flags and
    ``tag`` (the interpreter ABI for a CPython-API library)."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS + tuple(extra_flags)).encode())
    suffix = f"-{tag}" if tag else ""
    return BUILD_DIR / f"libpushcdn_{name}-{h.hexdigest()[:16]}{suffix}.so"


def _build_lib(name: str, loader, extra_flags: tuple = (), tag: str = ""):
    """Compile ``<name>.cpp`` when its library is missing and load it via
    ``loader`` (CDLL or PyDLL). Returns None on ANY failure (a compiler
    error, a load error), recorded in ``build_errors()``, so callers
    degrade to their Python branch."""
    try:
        out = library_path(name, extra_flags, tag)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = ["g++", *CXX_FLAGS, *extra_flags, str(SRC_DIR / f"{name}.cpp"),
                   "-o", str(tmp)]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=120)
                if r.returncode != 0:
                    raise OSError(f"g++ exited {r.returncode}: "
                                  f"{r.stderr[-2000:]}")
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
        return loader(str(out))
    except (subprocess.SubprocessError, OSError) as exc:
        _build_errors[name] = repr(exc)
        return None


def build_errors() -> dict:
    """Why each library that failed to build or load did (by source
    name); empty when nothing failed."""
    return dict(_build_errors)


def state() -> str:
    """``loaded``, ``failed`` or ``untried``: the framing library's state,
    read without building it."""
    if _lib is not None:
        return "loaded"
    return "failed" if _tried else "untried"


def _compile() -> Optional[ctypes.CDLL]:
    lib = _build_lib("framing", ctypes.CDLL)
    if lib is None:
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)

    lib.pushcdn_pack_frames.restype = ctypes.c_int32
    lib.pushcdn_pack_frames.argtypes = [
        u8p, i64p, i32p, i32p, u32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, i32p, i32p, u32p, i32p, u8p]
    lib.pushcdn_scan_frames.restype = ctypes.c_int64
    lib.pushcdn_scan_frames.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_uint32,
        i64p, i32p, ctypes.c_int32, i32p, i32p]
    lib.pushcdn_encode_frames.restype = ctypes.c_int64
    lib.pushcdn_encode_frames.argtypes = [
        u8p, i64p, i32p, ctypes.c_int32, u8p, ctypes.c_int64]
    lib.pushcdn_encode_frames_ptrs.restype = ctypes.c_int64
    lib.pushcdn_encode_frames_ptrs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i32p,
        ctypes.c_int32, u8p, ctypes.c_int64]
    lib.pushcdn_egress_count.restype = None
    lib.pushcdn_egress_count.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, i32p, i64p, i32p]
    lib.pushcdn_egress_fill.restype = ctypes.c_int64
    lib.pushcdn_egress_fill.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, i32p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, i64p, u8p, ctypes.c_int64]
    lib.pushcdn_egress_encode_fused.restype = ctypes.c_int64
    lib.pushcdn_egress_encode_fused.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, i32p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, i64p, i64p, i32p, u8p, ctypes.c_int64]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _compile()
                _tried = True
    return _lib


def available() -> bool:
    """Whether the framing library built and loaded (building it on the
    first call)."""
    return _get() is not None


# -- CPython-API batch decoder (pydecode.cpp) --------------------------------
#
# A SEPARATE library from the framing CDLL: it is loaded via PyDLL so calls
# keep the GIL (the decoder builds Python objects), whereas the framing
# lib's plain-C calls release it.

_pydecode_fn = None
_pydecode_tried = False


def _pydecode_flags() -> tuple:
    return ("-I", sysconfig.get_paths()["include"])


def _pydecode_abi() -> str:
    """The decoder's library name carries the interpreter ABI: it is a
    CPython-API library (tp_alloc, slot layouts), and loading one built
    against another interpreter's headers is undefined behaviour."""
    return sysconfig.get_config_var("SOABI") or "unknown-abi"


def library_paths() -> dict:
    """Where each of this module's libraries builds to, by source name."""
    return {"framing": library_path("framing"),
            "pydecode": library_path("pydecode", _pydecode_flags(),
                                     _pydecode_abi())}


def build() -> dict:
    """Build and load both libraries now (a no-op once loaded). Returns
    their paths; raises with the compiler's output when either failed."""
    ok = available() and pydecode() is not None
    if not ok:
        raise RuntimeError(f"native host routines failed to build: "
                           f"{build_errors()}")
    return library_paths()


def _compile_pydecode():
    lib = _build_lib("pydecode", ctypes.PyDLL, _pydecode_flags(),
                     _pydecode_abi())
    if lib is None:
        return None
    fn = lib.pushcdn_decode_frames_py
    fn.restype = ctypes.py_object
    fn.argtypes = [ctypes.py_object, ctypes.py_object, ctypes.py_object,
                   ctypes.c_ssize_t, ctypes.py_object, ctypes.py_object,
                   ctypes.py_object, ctypes.c_ssize_t]
    return fn


def pydecode():
    """The batch frame→Message decoder, or None when unavailable.

    Signature: ``fn(buf, offs, lens, start, Broadcast, Direct, fallback,
    zero_copy_min)`` → list of messages, or None when the inputs don't
    fit the C fast path (caller must then run the Python decoder). With
    ``zero_copy_min > 0``, hot payloads of at least that many bytes are
    memoryview slices over ``buf`` instead of owned copies
    (message.ZERO_COPY_MIN is the callers' threshold). Raises whatever
    ``fallback`` raises on malformed frames.
    """
    global _pydecode_fn, _pydecode_tried
    if _pydecode_fn is None and not _pydecode_tried:
        with _lock:
            if _pydecode_fn is None and not _pydecode_tried:
                _pydecode_fn = _compile_pydecode()
                _pydecode_tried = True
    return _pydecode_fn


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pack_frames_into(payloads: list[bytes], kinds: np.ndarray,
                     tmasks: np.ndarray, dests: np.ndarray,
                     out_frames: np.ndarray, out_kind: np.ndarray,
                     out_len: np.ndarray, out_tmask: np.ndarray,
                     out_dest: np.ndarray, out_valid: np.ndarray
                     ) -> Optional[int]:
    """Batch-pack payloads directly into caller-owned frame arrays via the
    C++ kernel (zero extra allocation on the pump path). Returns the number
    packed, or None if the native library is unavailable.

    ``tmasks``/``out_tmask`` may be 1-D (compact ≤32-topic masks) or 2-D
    ``[n, W]`` / ``[capacity, W]`` multi-word rows covering the full u8
    topic space — the two must agree on W.

    Preconditions (validated): metadata arrays as long as ``payloads``; no
    payload longer than a frame slot; out arrays contiguous with matching
    dtypes. ``out_valid`` must be uint8 (written 0/1). The out arrays may
    be sliced views starting at a ring's cursor (C-contiguous slices along
    axis 0), so a partially-filled ring can batch-pack into its tail.
    """
    lib = _get()
    if lib is None:
        return None
    n_in = len(payloads)
    if not (len(kinds) == len(tmasks) == len(dests) == n_in):
        raise ValueError("payloads/kinds/tmasks/dests length mismatch")
    words = 1 if out_tmask.ndim == 1 else out_tmask.shape[1]
    in_words = 1 if np.ndim(tmasks) == 1 else np.shape(tmasks)[1]
    if words != in_words:
        raise ValueError(
            f"tmasks width {in_words} != out_tmask width {words}")
    capacity, frame_bytes = out_frames.shape
    # lengths/offsets at C speed: map(len) + cumsum beat a Python loop by
    # ~400 ns/frame on the pump path
    lengths = np.fromiter(map(len, payloads), np.int32, count=n_in)
    if n_in and int(lengths.max(initial=0)) > frame_bytes:
        i = int(np.argmax(lengths > frame_bytes))
        raise ValueError(
            f"payload {i} is {lengths[i]} B > frame slot {frame_bytes} B; "
            "pre-filter oversized payloads to the host path")
    offsets = np.empty(n_in, np.int64)
    if n_in:
        offsets[0] = 0
        np.cumsum(lengths[:-1], dtype=np.int64, out=offsets[1:])
    blob = b"".join(payloads)
    blob_arr = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)

    n = lib.pushcdn_pack_frames(
        _ptr(blob_arr, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int32),
        _ptr(np.ascontiguousarray(kinds, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(tmasks, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(dests, np.int32), ctypes.c_int32),
        n_in, capacity, frame_bytes, words,
        _ptr(out_frames, ctypes.c_uint8), _ptr(out_kind, ctypes.c_int32),
        _ptr(out_len, ctypes.c_int32), _ptr(out_tmask, ctypes.c_uint32),
        _ptr(out_dest, ctypes.c_int32), _ptr(out_valid, ctypes.c_uint8))
    return int(n)


def scan_frames(buf: bytes, max_frame_len: int, max_frames: int = 4096
                ) -> Optional[Tuple[list[Tuple[int, int]], int, bool]]:
    """Find complete length-delimited frames in ``buf`` via the C++
    scanner. Returns ([(offset, length)...], consumed_bytes, error) or
    None if unavailable."""
    lib = _get()
    if lib is None:
        return None
    arr = np.frombuffer(buf, np.uint8) if buf else np.zeros(1, np.uint8)
    out_off = np.zeros(max_frames, np.int64)
    out_len = np.zeros(max_frames, np.int32)
    nframes = ctypes.c_int32(0)
    error = ctypes.c_int32(0)
    consumed = lib.pushcdn_scan_frames(
        _ptr(arr, ctypes.c_uint8), len(buf), max_frame_len,
        _ptr(out_off, ctypes.c_int64), _ptr(out_len, ctypes.c_int32),
        max_frames, ctypes.byref(nframes), ctypes.byref(error))
    frames = [(int(out_off[i]), int(out_len[i])) for i in range(nframes.value)]
    return frames, int(consumed), bool(error.value)


class FrameScanner:
    """Reusable scan state for one connection's reader loop: the (offset,
    length) output columns are allocated once and reused every chunk, and
    results come back as plain-int lists via one ``tolist()`` call — the
    per-frame Python cost of the wire scan is two list indexes.

    ``None``-safe construction: ``FrameScanner.create()`` returns None when
    the native library is unavailable (callers fall back to the Python
    struct scan).
    """

    __slots__ = ("_lib", "_off", "_len", "max_frames")

    def __init__(self, lib, max_frames: int):
        self._lib = lib
        self.max_frames = max_frames
        self._off = np.zeros(max_frames, np.int64)
        self._len = np.zeros(max_frames, np.int32)

    @classmethod
    def create(cls, max_frames: int = 8192) -> Optional["FrameScanner"]:
        lib = _get()
        return None if lib is None else cls(lib, max_frames)

    def scan(self, buf, max_frame_len: int):
        """Scan a ``bytearray``/``bytes`` carry buffer for complete frames.
        Returns (offsets, lengths, consumed, error) with offsets/lengths as
        plain-int lists pointing at payload starts."""
        blen = len(buf)
        if blen < 4:
            return (), (), 0, False
        arr = np.frombuffer(buf, np.uint8)  # zero-copy view
        nframes = ctypes.c_int32(0)
        error = ctypes.c_int32(0)
        consumed = self._lib.pushcdn_scan_frames(
            _ptr(arr, ctypes.c_uint8), blen, max_frame_len,
            _ptr(self._off, ctypes.c_int64), _ptr(self._len, ctypes.c_int32),
            self.max_frames, ctypes.byref(nframes), ctypes.byref(error))
        n = nframes.value
        return (self._off[:n].tolist(), self._len[:n].tolist(),
                int(consumed), bool(error.value))


class FrameEncoder:
    """Reusable writer-side batch encoder: length-delimits many payloads
    into one reusable output buffer with a single C call and a single copy
    (payload pointers are passed directly — no intermediate join)."""

    __slots__ = ("_lib", "_out", "_lens")

    def __init__(self, lib, capacity: int):
        self._lib = lib
        self._out = bytearray(capacity)
        self._lens = np.zeros(1024, np.int32)

    @classmethod
    def create(cls, capacity: int = 256 * 1024) -> Optional["FrameEncoder"]:
        lib = _get()
        return None if lib is None else cls(lib, capacity)

    def encode(self, payloads: list) -> Optional[memoryview]:
        """Encode ``payloads`` (bytes objects) as one length-delimited
        stream; returns a memoryview over the internal buffer (valid until
        the next call) or None when the batch doesn't fit."""
        n = len(payloads)
        if n > len(self._lens):
            self._lens = np.zeros(max(n, 2 * len(self._lens)), np.int32)
        lens = self._lens
        lens[:n] = np.fromiter(map(len, payloads), np.int32, count=n)
        total = int(lens[:n].sum()) + 4 * n
        if total > len(self._out):
            return None
        ptrs = (ctypes.c_char_p * n)(*payloads)
        out_ptr = (ctypes.c_uint8 * len(self._out)).from_buffer(self._out)
        wrote = self._lib.pushcdn_encode_frames_ptrs(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)),
            _ptr(lens, ctypes.c_int32), n,
            ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_uint8)), len(self._out))
        if wrote < 0:
            return None
        return memoryview(self._out)[:wrote]

    def encode_detached(self, payloads: list) -> Optional[bytearray]:
        """Encode ``payloads`` (bytes objects) into a FRESH exact-size
        bytearray the caller owns outright — the routing loops' pre-encode
        handoff: the batch becomes one ``PreEncoded`` writer entry, still
        one C call and one copy (the same count as the writer-side
        encoder), but flattening/probing moves off the writer task and
        the frames' pool permits release at encode time instead of after
        the wire flush. None when any payload is not ``bytes``."""
        n = len(payloads)
        if n == 0:
            return None
        if n > len(self._lens):
            self._lens = np.zeros(max(n, 2 * len(self._lens)), np.int32)
        lens = self._lens
        try:
            lens[:n] = np.fromiter(map(len, payloads), np.int32, count=n)
            ptrs = (ctypes.c_char_p * n)(*payloads)
        except TypeError:  # a non-bytes payload (memoryview/Bytes slipped in)
            return None
        total = int(lens[:n].sum()) + 4 * n
        out = bytearray(total)
        out_ptr = (ctypes.c_uint8 * total).from_buffer(out)
        wrote = self._lib.pushcdn_encode_frames_ptrs(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)),
            _ptr(lens, ctypes.c_int32), n,
            ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_uint8)), total)
        del out_ptr  # release the from_buffer export before handing out
        if wrote != total:
            return None
        return out


_shared_encoder: Optional[FrameEncoder] = None
_shared_encoder_tried = False


def shared_encoder() -> Optional[FrameEncoder]:
    """Process-wide :class:`FrameEncoder` for single-event-loop callers
    that only use :meth:`FrameEncoder.encode_detached` (no persistent
    output buffer is shared, so one instance serves every connection)."""
    global _shared_encoder, _shared_encoder_tried
    if _shared_encoder is None and not _shared_encoder_tried:
        _shared_encoder_tried = True
        _shared_encoder = FrameEncoder.create(capacity=1)
    return _shared_encoder


class _EgressLease:
    """Owns one pooled egress buffer; when the LAST reference to the lease
    drops (the :class:`EgressStreams` and every writer entry holding it),
    the buffer returns to the free pool instead of the allocator. This is
    what turns the per-step egress allocation — whose page-fault cost was
    ~2/3 of the engine's steady-state runtime — into a recycled buffer.

    Callers that hand stream views to asynchronous consumers (connection
    writers) must keep the lease alive alongside the view (the ``owner``
    seat on ``PreEncoded`` / ``send_encoded_nowait``); a view without its
    lease risks the pool recycling the buffer under a pending write."""

    __slots__ = ("_buf",)

    def __init__(self, buf: bytearray):
        self._buf = buf

    def __del__(self):
        buf = self._buf
        # drop buffers far above the (decaying) recent need instead of
        # pooling them: one anomalous spike step must not pin
        # spike-sized allocations for process lifetime
        if buf is not None and len(_EGRESS_POOL) < _EGRESS_POOL_MAX \
                and len(buf) <= 8 * _EGRESS_NEED_HW:
            _EGRESS_POOL.append(buf)


_EGRESS_POOL: list = []   # free bytearrays (bounded; newest last)
_EGRESS_POOL_MAX = 3
_EGRESS_NEED_HW = 1 << 20  # decaying high-water mark of real step sizes
# io_uring fixed-buffer hook: callbacks invoked once per pooled egress
# buffer (existing and future) so the engine can page-pin each buffer a
# single time at allocation instead of per send. Pool buffers are never
# resized in place (a too-small buffer rotates away and a fresh one is
# allocated), so a persistent registration stays valid for the buffer's
# whole life.
_EGRESS_REGISTRARS: list = []


def add_egress_registrar(fn) -> None:
    """Subscribe ``fn(buf)`` to every pooled egress buffer, replaying the
    current free pool immediately. ``fn`` must never raise."""
    _EGRESS_REGISTRARS.append(fn)
    for buf in list(_EGRESS_POOL):
        fn(buf)


def egress_pool_buffers() -> list:
    """Snapshot of the free egress pool (for fixed-buffer registration)."""
    return list(_EGRESS_POOL)


def _egress_note_need(nbytes: int) -> None:
    """Record a step's actual egress size (geometric decay: the
    high-water mark forgets a spike within ~tens of steps)."""
    global _EGRESS_NEED_HW
    _EGRESS_NEED_HW = max(nbytes, int(_EGRESS_NEED_HW * 0.9), 1 << 20)


def _egress_take(nbytes: int):
    """Take a pooled buffer of at least ``nbytes``, or allocate fresh.
    Returns (bytearray, lease). Lock-free on purpose: encode runs both on
    the event loop and in mesh-group worker threads, and the lease's
    ``__del__`` (which appends back) can fire inside any allocation's GC —
    so only GIL-atomic list ops are used, with a defensive retry."""
    pool = _EGRESS_POOL
    try:
        for _ in range(len(pool)):
            buf = pool.pop()
            if len(buf) >= nbytes:
                return buf, _EgressLease(buf)
            pool.insert(0, buf)  # too small for this step: rotate away
    except IndexError:  # raced another taker
        pass
    buf = bytearray(max(nbytes, 1 << 20))
    for fn in _EGRESS_REGISTRARS:
        fn(buf)
    return buf, _EgressLease(buf)


class EgressStreams:
    """One step's egress, encoded: per-user length-delimited streams laid
    out back-to-back in one buffer. ``users`` lists the slots with at least
    one delivery; ``stream(i)`` is the i-th listed user's bytes — already
    wire-framed, handed to the connection writer as-is (pass this object
    as the writer's ``owner`` so the pooled buffer outlives the flush)."""

    __slots__ = ("buf", "users", "offsets", "nbytes", "msgs", "total_msgs",
                 "lease")

    def __init__(self, buf, users, offsets, nbytes, msgs, lease=None):
        self.buf = buf
        self.users = users      # int list — user slots with deliveries
        self.offsets = offsets  # int64[U] stream starts (all slots)
        self.nbytes = nbytes    # int64[U] stream sizes (all slots)
        self.msgs = msgs        # int32[U] delivered count (all slots)
        self.total_msgs = int(msgs.sum())
        self.lease = lease      # pooled-buffer lease (None = plain alloc)

    def stream(self, slot: int) -> memoryview:
        off = int(self.offsets[slot])
        return memoryview(self.buf)[off:off + int(self.nbytes[slot])]


def egress_encode(deliver: np.ndarray, lengths: np.ndarray,
                  blocks: list) -> Optional[EgressStreams]:
    """Encode a delivery matrix into per-user wire streams via the C++
    engine (two passes: count → prefix-sum → fill). ``deliver`` is
    bool[U, N] (numpy bool_, row-major); ``lengths`` int32[N]; ``blocks``
    the per-shard frame tensors in gather order (each C-contiguous
    uint8[rows, frame_bytes], equal shapes) — frame n is row
    ``n % rows`` of block ``n // rows``. Returns None when the native
    library is unavailable (callers fall back to the per-frame path)."""
    lib = _get()
    if lib is None:
        return None
    U, N = deliver.shape
    rows = blocks[0].shape[0]
    stride = blocks[0].strides[0]  # row pitch (rows themselves contiguous)
    if rows * len(blocks) != N:
        raise ValueError(f"blocks cover {rows * len(blocks)} frames, "
                         f"deliver has {N}")
    for b in blocks:
        if b.shape[0] != rows or b.strides[0] != stride or b.strides[1] != 1:
            raise ValueError("egress blocks must share shape/stride with "
                             "byte-contiguous rows")
    if deliver.dtype == np.bool_ and deliver.flags.c_contiguous:
        deliver = deliver.view(np.uint8)  # free: bool_ is 1 byte/cell
    else:
        deliver = np.ascontiguousarray(deliver, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    per_bytes = np.zeros(U, np.int64)
    per_msgs = np.zeros(U, np.int32)
    offsets = np.zeros(U, np.int64)
    block_ptrs = (ctypes.c_void_p * len(blocks))(
        *(b.ctypes.data for b in blocks))

    # Fused single pass into a pooled buffer: count + prefix + fill in one
    # matrix walk, zero allocation in the steady state (the lease returns
    # the buffer once the streams and every pending writer entry drop).
    # A too-small buffer (first step, or a new high-water mark) sizes
    # exactly via the count pass and retries once.
    buf, lease = _egress_take(1)
    buf_np = np.frombuffer(buf, np.uint8)
    wrote = lib.pushcdn_egress_encode_fused(
        _ptr(deliver, ctypes.c_uint8), U, N, _ptr(lengths, ctypes.c_int32),
        block_ptrs, len(blocks), rows, stride,
        _ptr(offsets, ctypes.c_int64), _ptr(per_bytes, ctypes.c_int64),
        _ptr(per_msgs, ctypes.c_int32), _ptr(buf_np, ctypes.c_uint8),
        len(buf))
    if wrote < 0:
        lib.pushcdn_egress_count(
            _ptr(deliver, ctypes.c_uint8), U, N,
            _ptr(lengths, ctypes.c_int32),
            _ptr(per_bytes, ctypes.c_int64), _ptr(per_msgs, ctypes.c_int32))
        total = int(per_bytes.sum())
        del buf_np
        buf, lease = _egress_take(total)
        buf_np = np.frombuffer(buf, np.uint8)
        wrote = lib.pushcdn_egress_encode_fused(
            _ptr(deliver, ctypes.c_uint8), U, N,
            _ptr(lengths, ctypes.c_int32),
            block_ptrs, len(blocks), rows, stride,
            _ptr(offsets, ctypes.c_int64), _ptr(per_bytes, ctypes.c_int64),
            _ptr(per_msgs, ctypes.c_int32), _ptr(buf_np, ctypes.c_uint8),
            len(buf))
        if wrote != total:  # can't happen on one snapshot; stay safe
            return None
    _egress_note_need(int(wrote))
    users = np.nonzero(per_msgs)[0].tolist()
    return EgressStreams(buf, users, offsets, per_bytes, per_msgs,
                         lease=lease)


def encode_frames(payloads: list[bytes]) -> Optional[bytes]:
    """Batch-encode payloads as one length-delimited stream (writer-side
    batching: one buffer → one syscall). None if unavailable."""
    lib = _get()
    if lib is None:
        return None
    blob = b"".join(payloads)
    offsets = np.zeros(len(payloads), np.int64)
    lengths = np.zeros(len(payloads), np.int32)
    off = 0
    for i, p in enumerate(payloads):
        offsets[i] = off
        lengths[i] = len(p)
        off += len(p)
    blob_arr = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    cap = len(blob) + 4 * len(payloads)
    out = np.zeros(cap, np.uint8)
    n = lib.pushcdn_encode_frames(
        _ptr(blob_arr, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int32), len(payloads),
        _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        return None
    return out[:n].tobytes()
