"""Pure-Python Ed25519 (RFC 8032) — dependency-gate fallback.

Used by :mod:`signature` only when the ``cryptography`` package (the
OpenSSL-backed default) is not installed in the image. Wire-compatible
with it: raw 32-byte keys, 64-byte signatures, identical deterministic
keygen from the same 32 seed bytes, so a fallback-signed handshake
verifies on a peer running the native backend and vice versa.

Implementation notes: extended homogeneous coordinates with the complete
twisted-Edwards addition law (RFC 8032 §5.1.4) — one unified formula for
add and double, no per-step inversions; a precomputed 2^i·B ladder makes
fixed-base multiplication (keygen/sign) ~2x a generic one. Verification
is the cofactorless strict check (s < L, canonical point encodings),
matching the OpenSSL behavior the rest of the stack assumes. Speed is
~1-3 ms per operation in CPython — three orders slower than OpenSSL but
well inside the auth path's 5 s timeout envelope; images that ship
``cryptography`` never import this module.

SECURITY TRADEOFF — not constant-time. Signing walks the secret scalar
with data-dependent branches and CPython bigint arithmetic, so execution
time correlates with private-key bits; a network attacker who can
trigger many handshakes and measure latency gains a classic timing side
channel that the OpenSSL backend does not have. This is an accepted
limitation of the dependency-gate fallback: it exists so dev/CI images
without the ``cryptography`` wheel can run the full stack. Production
deployments terminating auth for keys that matter must ship
``cryptography`` (or select the native BLS scheme) — do not serve
high-value Ed25519 keys through this module.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)

_IDENT = (0, 1, 1, 0)  # neutral element in extended coordinates


def _point_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _scalar_mult(s: int, p):
    q = _IDENT
    while s:
        if s & 1:
            q = _point_add(q, p)
        p = _point_add(p, p)
        s >>= 1
    return q


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
_B = (_BX, _BY, 1, _BX * _BY % P)

# fixed-base ladder: 2^i * B for i in [0, 256) — covers clamped scalars
# (bit 254 set) and any value reduced mod L
_B_LADDER = []
_tmp = _B
for _ in range(256):
    _B_LADDER.append(_tmp)
    _tmp = _point_add(_tmp, _tmp)
del _tmp


def _scalar_mult_base(s: int):
    q = _IDENT
    i = 0
    while s:
        if s & 1:
            q = _point_add(q, _B_LADDER[i])
        s >>= 1
        i += 1
    return q


def _compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(enc: bytes):
    if len(enc) != 32:
        return None
    val = int.from_bytes(enc, "little")
    sign, y = val >> 255, val & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    return (a & ((1 << 254) - 8)) | (1 << 254)


def _h(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def publickey(private_key: bytes) -> bytes:
    """Raw 32-byte public key for a raw 32-byte private key."""
    h = hashlib.sha512(private_key).digest()
    return _compress(_scalar_mult_base(_clamp(h[:32])))


def sign(private_key: bytes, message: bytes) -> bytes:
    h = hashlib.sha512(private_key).digest()
    a, prefix = _clamp(h[:32]), h[32:]
    pk = _compress(_scalar_mult_base(a))
    r = _h(prefix, message) % L
    r_enc = _compress(_scalar_mult_base(r))
    s = (r + _h(r_enc, pk, message) % L * a) % L
    return r_enc + int.to_bytes(s, 32, "little")


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    if len(signature) != 64 or len(public_key) != 32:
        return False
    a_pt = _decompress(public_key)
    r_pt = _decompress(signature[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False  # malleability rejection, parity with OpenSSL
    k = _h(signature[:32], public_key, message) % L
    lhs = _scalar_mult_base(s)
    rhs = _point_add(r_pt, _scalar_mult(k, a_pt))
    return _compress(lhs) == _compress(rhs)
