"""ctypes bindings for the BLS-over-BN254 library (``bls_bn254.cpp`` beside
this file, which includes ``bls_generated.inc``).

The reference's signature scheme is BLS over BN254 from jellyfish
(cdn-proto/src/crypto/signature.rs:113-175); the pairing arithmetic is
native there and native here. The port's own copy of
``pushcdn_tpu.native.bls``: it builds from the sources in this directory
(byte-equal copies of the JAX package's) with ``g++`` at first use into
``.build/torch_native/``, through the package's ``_build_lib``, so the
library's name carries a hash of the source, of the ``.inc`` it includes
(``native.INCLUDES``) and of the flags. A ``-march=native`` build is worth
~10% on the Montgomery ladder, but a library built that way on one host
can die with SIGILL on another that shares the checkout, so that build's
name also carries a fingerprint of this host's CPU; where the flag is
refused, the portable build is tried. ``available()`` is False when both
fail; the binaries then refuse ``--scheme bls-bn254``.

This module uses ctypes only: the marshal, which verifies the signatures,
never imports torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import threading
from pathlib import Path
from typing import Optional

from pushcdn_tpu_torch import native as _native
from pushcdn_tpu_torch.native import _build_lib, library_path

NAME = "bls_bn254"
NATIVE_FLAGS = ("-march=native",)

SK_LEN = 32
PK_LEN = 128
SIG_LEN = 64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_path: Optional[Path] = None


def host_tag() -> str:
    """A fingerprint of this host's CPU (architecture, vendor, model and
    feature flags; not the clock, which moves): what a ``-march=native``
    library depends on."""
    fields = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("vendor_id", "model name", "flags", "Features",
                           "CPU implementer", "CPU part"):
                    fields.append(line.strip())
    except OSError:
        fields.append(platform.processor())
    return hashlib.sha256(
        "\n".join(sorted(set(fields))).encode()).hexdigest()[:12]


def library_paths() -> tuple:
    """Where the host-tuned and the portable builds go, in the order they
    are tried."""
    return (library_path(NAME, NATIVE_FLAGS, host_tag()), library_path(NAME))


def _compile() -> Optional[ctypes.CDLL]:
    global _path
    lib = _build_lib(NAME, ctypes.CDLL, NATIVE_FLAGS, host_tag())
    _path = library_paths()[0]
    if lib is None:
        lib = _build_lib(NAME, ctypes.CDLL)
        _path = library_paths()[1]
    if lib is None:
        _path = None
        return None
    _native._build_errors.pop(NAME, None)   # the portable build stood in

    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bls_keygen.restype = ctypes.c_int
    lib.bls_keygen.argtypes = [u8p, u8p, u8p]
    lib.bls_sign.restype = ctypes.c_int
    lib.bls_sign.argtypes = [u8p, ctypes.c_char_p, ctypes.c_longlong, u8p]
    lib.bls_verify.restype = ctypes.c_int
    lib.bls_verify.argtypes = [u8p, ctypes.c_char_p, ctypes.c_longlong, u8p]
    lib.bls_verify_cached.restype = ctypes.c_int
    lib.bls_verify_cached.argtypes = [
        u8p, ctypes.c_char_p, ctypes.c_longlong, u8p]
    lib.bls_verify_batch.restype = ctypes.c_int
    lib.bls_verify_batch.argtypes = [
        ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_longlong), u8p, u8p]
    lib.bls_verify_batch_cached.restype = ctypes.c_int
    lib.bls_verify_batch_cached.argtypes = lib.bls_verify_batch.argtypes
    lib.bls_pk_cache_stats.restype = None
    lib.bls_pk_cache_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.bls_pk_cache_configure.restype = ctypes.c_int
    lib.bls_pk_cache_configure.argtypes = [ctypes.c_longlong]
    lib.bls_pk_cache_clear.restype = None
    lib.bls_pk_cache_clear.argtypes = []
    lib.bls_self_test.restype = ctypes.c_int
    lib.bls_self_test.argtypes = []
    # PUSHCDN_BLS_PK_CACHE sizes the per-public-key Miller line-table LRU
    # (entries; ~17 KB each; 0 disables and the cached entrypoints take
    # the plain path). Default stays the library's 128 (~2.2 MB bound).
    env_cap = os.environ.get("PUSHCDN_BLS_PK_CACHE", "").strip()
    if env_cap:
        try:
            lib.bls_pk_cache_configure(int(env_cap))
        except ValueError:
            pass
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = _compile()
        return _lib


def available() -> bool:
    """Whether the library built and loaded (building it on the first
    call)."""
    return _get() is not None


def loaded() -> bool:
    """True when the library is ALREADY loaded — never triggers the
    compile. For callers on latency-sensitive paths (the /metrics
    pre-render hook) that must observe, not provoke, the g++ build."""
    return _lib is not None


def loaded_path() -> Optional[Path]:
    """The file the library was loaded from (None before a load)."""
    return _path if _lib is not None else None


def self_test() -> int:
    """0 = all pairing/scheme invariants hold (see bls_self_test)."""
    lib = _get()
    if lib is None:
        return -1
    return lib.bls_self_test()


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def keygen(seed32: bytes) -> tuple[bytes, bytes]:
    """Deterministic (private_key, public_key) from a 32-byte seed."""
    lib = _get()
    assert lib is not None, "native BLS unavailable"
    assert len(seed32) == 32
    sk = (ctypes.c_uint8 * SK_LEN)()
    pk = (ctypes.c_uint8 * PK_LEN)()
    rc = lib.bls_keygen(_buf(seed32), sk, pk)
    if rc != 0:
        raise ValueError(f"bls_keygen failed: {rc}")
    return bytes(sk), bytes(pk)


def sign(sk: bytes, message: bytes) -> bytes:
    lib = _get()
    assert lib is not None, "native BLS unavailable"
    if len(sk) != SK_LEN:
        raise ValueError("bad secret key length")
    sig = (ctypes.c_uint8 * SIG_LEN)()
    rc = lib.bls_sign(_buf(sk), bytes(message), len(message), sig)
    if rc != 0:
        raise ValueError(f"bls_sign failed: {rc}")
    return bytes(sig)


def verify_batch(items, seed32: bytes, cached: bool = True) -> bool:
    """Batch-verify ``[(pk, message, signature), ...]`` with one shared
    final exponentiation via random linear combination (bls_verify_batch).
    ``seed32`` seeds the per-item 128-bit weights — callers pass fresh
    randomness (os.urandom) so an adversary cannot target the
    combination. Falls back to False on malformed input.

    ``cached`` (default) routes through ``bls_verify_batch_cached``: each
    item's pk-side Miller loop replays that key's line table from the
    bounded LRU, and every item shares ONE squaring chain with the
    generator side — same accept/reject semantics, ~2x at batch size 8
    with warm tables."""
    lib = _get()
    assert lib is not None, "native BLS unavailable"
    assert len(seed32) == 32
    n = len(items)
    if n == 0:
        return True
    pks = bytearray()
    sigs = bytearray()
    msgs = []
    for pk, message, signature in items:
        if len(pk) != PK_LEN or len(signature) != SIG_LEN:
            return False
        pks += pk
        sigs += signature
        msgs.append(bytes(message))
    msg_arr = (ctypes.c_char_p * n)(*msgs)
    len_arr = (ctypes.c_longlong * n)(*(len(m) for m in msgs))
    fn = lib.bls_verify_batch_cached if cached else lib.bls_verify_batch
    return fn(
        n, _buf(bytes(pks)), msg_arr, len_arr, _buf(bytes(sigs)),
        _buf(seed32)) == 1


def verify(pk: bytes, message: bytes, signature: bytes) -> bool:
    lib = _get()
    assert lib is not None, "native BLS unavailable"
    if len(pk) != PK_LEN or len(signature) != SIG_LEN:
        return False
    return lib.bls_verify(_buf(pk), bytes(message), len(message),
                          _buf(signature)) == 1


def verify_cached(pk: bytes, message: bytes, signature: bytes) -> bool:
    """``verify`` through the per-public-key Miller line-table cache: a
    repeat connector's second and later verifications skip the pk-side
    Jacobian ladder, the G2 subgroup check, and the pk parse (the LRU key
    is the exact 128-byte encoding, validated before insert). Identical
    accept/reject semantics to :func:`verify` for every input —
    asserted by the in-library self-test including across LRU
    eviction/repopulation."""
    lib = _get()
    assert lib is not None, "native BLS unavailable"
    if len(pk) != PK_LEN or len(signature) != SIG_LEN:
        return False
    return lib.bls_verify_cached(_buf(pk), bytes(message), len(message),
                                 _buf(signature)) == 1


def pk_cache_stats() -> Optional[dict]:
    """Line-table cache counters, or None when the library is
    unavailable: hits/misses/evictions since start (or last clear),
    current entries, capacity, and resident table bytes."""
    lib = _get()
    if lib is None:
        return None
    out = (ctypes.c_uint64 * 6)()
    lib.bls_pk_cache_stats(out)
    return {"hits": int(out[0]), "misses": int(out[1]),
            "evictions": int(out[2]), "entries": int(out[3]),
            "capacity": int(out[4]), "bytes": int(out[5])}


def pk_cache_configure(capacity: int) -> None:
    """Resize the line-table LRU (entries, ~17 KB each; 0 disables —
    cached entrypoints then take the plain uncached path). Shrinking
    evicts least-recently-used tables immediately."""
    lib = _get()
    assert lib is not None, "native BLS unavailable"
    if lib.bls_pk_cache_configure(int(capacity)) != 0:
        raise ValueError(f"bad pk cache capacity {capacity!r}")


def pk_cache_clear() -> None:
    """Drop every cached table and zero the counters (test isolation)."""
    lib = _get()
    if lib is not None:
        lib.bls_pk_cache_clear()
