"""The port's BLS-over-BN254 scheme, its batching verifier and BLS
clusters, held against the JAX package's.

- The counterparts of ``tests/test_bls.py``'s cases, run on the port
  (``pushcdn_tpu_torch.native.bls``, ``proto.crypto.signature``,
  ``proto.crypto.batch`` and the port's in-process ``Cluster``), and
  ``production_run_def`` against the JAX package's.
- Cross-package: the same 32-byte seed gives byte-identical keys from both
  libraries, a signature from either verifies under the other and is
  byte-identical, a forgery fails under both, and ``verify_batch``,
  ``verify_cached`` and ``pk_cache_stats`` agree step by step on honest,
  forged and evicted sequences.
- The twin of ``tests/test_integration.py::
  test_bls_mesh_and_cross_broker_delivery`` on both packages, records
  compared, and the same flow on the port with dense planes on the CPU.
- The port's ``bls_bn254.cpp`` and ``bls_generated.inc`` are byte-equal
  copies of the root's, the ``.inc``'s bytes key the library's name, and a
  refused ``-march=native`` falls back to the portable build.

The port's library builds on first use (``g++``, ~4 s); the JAX
package's loads through ``_torch_libs.jax_bls_available``, which retries
a load that raced another process's build.
"""

import asyncio
import importlib
import os
from pathlib import Path
from types import SimpleNamespace

import pytest
from _torch_libs import jax_bls_available

from pushcdn_tpu_torch import native as tnative
from pushcdn_tpu_torch.native import bls
from pushcdn_tpu_torch.proto.crypto.signature import (
    BlsBn254Scheme,
    Ed25519Scheme,
    Namespace,
    _namespaced,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def built():
    assert bls.available(), tnative.build_errors()


@pytest.fixture
def jbls(built):
    assert jax_bls_available()
    from pushcdn_tpu.native import bls as jax_bls
    return jax_bls


# ---------------------------------------------------------------------------
# the counterparts of tests/test_bls.py, on the port
# ---------------------------------------------------------------------------


def test_pairing_self_test(built):
    """The library's internal invariants: e(G2,G1) != 1, bilinearity
    e(aQ,bP) == e(Q,P)^ab, keygen/sign/verify round trip, tamper
    rejection. rc pinpoints the failed invariant."""
    assert bls.self_test() == 0


def test_deterministic_keygen(built):
    kp1 = BlsBn254Scheme.generate_keypair(seed=7)
    kp2 = BlsBn254Scheme.generate_keypair(seed=7)
    kp3 = BlsBn254Scheme.generate_keypair(seed=8)
    assert kp1 == kp2
    assert kp1.public_key != kp3.public_key
    assert len(kp1.private_key) == 32
    assert len(kp1.public_key) == 128   # G2 affine, uncompressed
    random_kp = BlsBn254Scheme.generate_keypair()
    assert random_kp.public_key != kp1.public_key


def test_sign_verify_roundtrip(built):
    kp = BlsBn254Scheme.generate_keypair(seed=1)
    msg = b"the message"
    sig = BlsBn254Scheme.sign(kp.private_key, Namespace.USER_MARSHAL_AUTH, msg)
    assert len(sig) == 64               # G1 affine, uncompressed
    assert BlsBn254Scheme.verify(kp.public_key, Namespace.USER_MARSHAL_AUTH,
                                 msg, sig)


def test_namespace_separation(built):
    """A signature for the marshal must not verify for broker-broker auth
    (parity signature.rs:177-219)."""
    kp = BlsBn254Scheme.generate_keypair(seed=2)
    msg = b"1700000000"
    sig = BlsBn254Scheme.sign(kp.private_key, Namespace.USER_MARSHAL_AUTH, msg)
    assert BlsBn254Scheme.verify(kp.public_key, Namespace.USER_MARSHAL_AUTH,
                                 msg, sig)
    assert not BlsBn254Scheme.verify(kp.public_key,
                                     Namespace.BROKER_BROKER_AUTH, msg, sig)


def test_tamper_rejection(built):
    kp = BlsBn254Scheme.generate_keypair(seed=3)
    other = BlsBn254Scheme.generate_keypair(seed=4)
    msg = b"payload"
    sig = BlsBn254Scheme.sign(kp.private_key, Namespace.USER_MARSHAL_AUTH, msg)
    ns = Namespace.USER_MARSHAL_AUTH
    assert not BlsBn254Scheme.verify(kp.public_key, ns, b"payloaD", sig)
    assert not BlsBn254Scheme.verify(other.public_key, ns, msg, sig)
    flipped = bytearray(sig)
    flipped[10] ^= 1
    assert not BlsBn254Scheme.verify(kp.public_key, ns, msg, bytes(flipped))


def test_malformed_inputs_rejected_without_crash(built):
    kp = BlsBn254Scheme.generate_keypair(seed=5)
    ns = Namespace.USER_MARSHAL_AUTH
    sig = BlsBn254Scheme.sign(kp.private_key, ns, b"m")
    assert not BlsBn254Scheme.verify(b"", ns, b"m", sig)
    assert not BlsBn254Scheme.verify(kp.public_key, ns, b"m", b"short")
    # non-canonical field elements (>= p) must be rejected
    assert not BlsBn254Scheme.verify(b"\xff" * 128, ns, b"m", sig)
    assert not BlsBn254Scheme.verify(kp.public_key, ns, b"m", b"\xff" * 64)
    # all-zero encodings (the infinity encoding) are invalid
    assert not BlsBn254Scheme.verify(b"\x00" * 128, ns, b"m", sig)
    assert not BlsBn254Scheme.verify(kp.public_key, ns, b"m", b"\x00" * 64)
    # an Ed25519 signature is not a BLS signature
    ed = Ed25519Scheme.generate_keypair(seed=6)
    ed_sig = Ed25519Scheme.sign(ed.private_key, ns, b"m")
    assert not BlsBn254Scheme.verify(kp.public_key, ns, b"m", ed_sig)


def test_distinct_messages_distinct_signatures(built):
    kp = BlsBn254Scheme.generate_keypair(seed=9)
    ns = Namespace.USER_MARSHAL_AUTH
    sigs = {BlsBn254Scheme.sign(kp.private_key, ns, b"m%d" % i)
            for i in range(8)}
    assert len(sigs) == 8  # deterministic per message, distinct across them


async def test_end_to_end_cluster_on_bls(built):
    """Whole-system flow with BLS everywhere: the port's marshal verifies
    a BLS user signature, broker↔broker mutual auth signs with BLS, and a
    direct-message echo completes."""
    from pushcdn_tpu_torch.proto.message import Direct
    from pushcdn_tpu_torch.testing import Cluster

    cluster = await Cluster(num_brokers=2, scheme=BlsBn254Scheme).start()
    try:
        client = cluster.client(seed=21_000, topics=[0])
        await client.ensure_initialized()
        await client.send_direct_message(client.public_key, b"bls echo")
        got = await asyncio.wait_for(client.receive_message(), 10)
        assert isinstance(got, Direct)
        assert bytes(got.message) == b"bls echo"
        client.close()
    finally:
        await cluster.stop()


def test_cached_verify_matches_plain_cold_and_warm(built):
    """The per-pk line-table cache is invisible semantically: cold
    (miss+record), warm (table replay), tampered, wrong-key and malformed
    inputs all agree with the uncached pairing loop, and the counters
    move."""
    bls.pk_cache_clear()
    kp = BlsBn254Scheme.generate_keypair(seed=700)
    other = BlsBn254Scheme.generate_keypair(seed=701)
    ns = Namespace.USER_MARSHAL_AUTH
    msg = b"repeat connector"
    raw = _namespaced(ns, msg)
    sig = BlsBn254Scheme.sign(kp.private_key, ns, msg)
    for _ in range(3):  # miss, then hits
        assert bls.verify_cached(kp.public_key, raw, sig) \
            == bls.verify(kp.public_key, raw, sig) is True
    for bad_pk, bad_raw, bad_sig in [
            (kp.public_key, raw + b"x", sig),
            (other.public_key, raw, sig),
            (kp.public_key, raw, sig[:-1] + bytes([sig[-1] ^ 1])),
            (b"\xff" * 128, raw, sig),
            (kp.public_key, raw, b"\x00" * 64)]:
        assert bls.verify_cached(bad_pk, bad_raw, bad_sig) \
            == bls.verify(bad_pk, bad_raw, bad_sig) is False
    stats = bls.pk_cache_stats()
    assert stats["hits"] >= 2 and stats["misses"] >= 1
    assert stats["entries"] >= 1
    # the documented memory bound: ~17 KB per cached table
    assert stats["bytes"] <= stats["entries"] * 18 * 1024


def test_cache_eviction_and_repopulation(built):
    """At capacity 2 a third key evicts the least-recently-used table;
    the evicted key repopulates transparently and still verifies."""
    saved = bls.pk_cache_stats()["capacity"]
    bls.pk_cache_clear()
    bls.pk_cache_configure(2)
    try:
        ns = Namespace.USER_MARSHAL_AUTH
        kps, sigs = [], []
        for i in range(3):
            kp = BlsBn254Scheme.generate_keypair(seed=710 + i)
            kps.append(kp)
            sigs.append(BlsBn254Scheme.sign(kp.private_key, ns, b"evict"))
        for kp, sig in zip(kps, sigs):
            assert BlsBn254Scheme.verify(kp.public_key, ns, b"evict", sig)
            assert BlsBn254Scheme.verify(kp.public_key, ns, b"evict", sig)
        stats = bls.pk_cache_stats()
        assert stats["evictions"] >= 1
        assert stats["entries"] == 2 == stats["capacity"]
        assert BlsBn254Scheme.verify(kps[0].public_key, ns, b"evict",
                                     sigs[0])
        assert not BlsBn254Scheme.verify(kps[0].public_key, ns, b"evicT",
                                         sigs[0])
    finally:
        bls.pk_cache_clear()
        bls.pk_cache_configure(saved)


def test_cache_disabled_still_verifies(built):
    """Capacity 0 = cache off: the cached entrypoints take the plain path
    (``PUSHCDN_BLS_PK_CACHE=0`` deployments) with unchanged results."""
    saved = bls.pk_cache_stats()["capacity"]
    bls.pk_cache_clear()
    bls.pk_cache_configure(0)
    try:
        ns = Namespace.USER_MARSHAL_AUTH
        kp = BlsBn254Scheme.generate_keypair(seed=720)
        sig = BlsBn254Scheme.sign(kp.private_key, ns, b"off")
        assert BlsBn254Scheme.verify(kp.public_key, ns, b"off", sig)
        assert not BlsBn254Scheme.verify(kp.public_key, ns, b"ofF", sig)
        assert BlsBn254Scheme.verify_batch(
            [(kp.public_key, ns, b"off", sig)] * 2)
        assert bls.pk_cache_stats()["entries"] == 0  # nothing was cached
    finally:
        bls.pk_cache_configure(saved)


def test_batch_cached_matches_uncached(built):
    """The fused multi-table batch walk agrees with the plain per-item
    Miller-loop batch on honest and forged inputs, warm or cold."""
    bls.pk_cache_clear()
    ns = Namespace.USER_MARSHAL_AUTH
    items = []
    for i in range(5):
        kp = BlsBn254Scheme.generate_keypair(seed=730 + i)
        msg = b"fused %d" % i
        sig = BlsBn254Scheme.sign(kp.private_key, ns, msg)
        items.append((kp.public_key, _namespaced(ns, msg), sig))
    seed = os.urandom(32)
    for _ in range(2):  # cold tables, then warm
        assert bls.verify_batch(items, seed, cached=True) \
            == bls.verify_batch(items, seed, cached=False) is True
    forged = list(items)
    forged[2] = (forged[2][0], forged[2][1], forged[3][2])
    assert bls.verify_batch(forged, seed, cached=True) \
        == bls.verify_batch(forged, seed, cached=False) is False


def test_batch_verify_all_valid(built):
    ns = Namespace.USER_MARSHAL_AUTH
    items = []
    for i in range(5):
        kp = BlsBn254Scheme.generate_keypair(seed=400 + i)
        msg = b"storm auth %d" % i
        sig = BlsBn254Scheme.sign(kp.private_key, ns, msg)
        items.append((kp.public_key, ns, msg, sig))
    assert BlsBn254Scheme.verify_batch(items)


def test_batch_verify_rejects_one_forgery(built):
    ns = Namespace.USER_MARSHAL_AUTH
    items = []
    for i in range(4):
        kp = BlsBn254Scheme.generate_keypair(seed=500 + i)
        msg = b"storm auth %d" % i
        sig = BlsBn254Scheme.sign(kp.private_key, ns, msg)
        items.append([kp.public_key, ns, msg, sig])
    # swap two signatures: each is individually valid for the OTHER
    # message, so only a real pairing check catches it
    items[1][3], items[2][3] = items[2][3], items[1][3]
    assert not BlsBn254Scheme.verify_batch([tuple(it) for it in items])


def test_batch_verify_matches_single_semantics(built):
    ns = Namespace.USER_MARSHAL_AUTH
    kp = BlsBn254Scheme.generate_keypair(seed=600)
    msg = b"solo"
    sig = BlsBn254Scheme.sign(kp.private_key, ns, msg)
    assert BlsBn254Scheme.verify_batch([(kp.public_key, ns, msg, sig)])
    assert BlsBn254Scheme.verify_batch([])  # vacuous truth
    bad = bytearray(sig)
    bad[7] ^= 1
    assert not BlsBn254Scheme.verify_batch(
        [(kp.public_key, ns, msg, bytes(bad))])


async def test_marshal_batches_storm_verifications(built):
    """Under a connection storm the port's marshal amortizes pairing
    checks through its batching verifier: concurrent auths share one
    batched verification, and everyone authenticates end to end."""
    from pushcdn_tpu_torch.testing import Cluster

    cluster = await Cluster(num_brokers=1, scheme=BlsBn254Scheme).start()
    try:
        clients = [cluster.client(seed=95_000 + i, topics=[0])
                   for i in range(10)]
        await asyncio.gather(*(c.ensure_initialized() for c in clients))
        bv = cluster.marshal.batch_verifier
        assert bv.batches >= 1, (bv.batches, bv.singles)
        assert bv.batched_items >= 2
        await clients[0].send_broadcast_message([0], b"storm ok")
        for c in clients:
            got = await asyncio.wait_for(c.receive_message(), 10)
            assert bytes(got.message) == b"storm ok"
        for c in clients:
            c.close()
    finally:
        await cluster.stop()


async def test_batch_verifier_isolates_forgery(built):
    from pushcdn_tpu_torch.proto.crypto.batch import BatchVerifier

    bv = BatchVerifier(BlsBn254Scheme, max_batch=8)
    ns = Namespace.USER_MARSHAL_AUTH

    async def one(seed, forge):
        kp = BlsBn254Scheme.generate_keypair(seed=seed)
        msg = b"storm %d" % seed
        sig = BlsBn254Scheme.sign(kp.private_key, ns, msg)
        if forge:
            sig = bytes(sig[:-1]) + bytes([sig[-1] ^ 1])
        return await bv.verify(kp.public_key, ns, msg, sig)
    results = await asyncio.gather(
        one(1, False), one(2, True), one(3, False), one(4, False))
    assert results == [True, False, True, True]
    # adaptive batching: the first verified solo, 2-4 batched behind it
    assert bv.batches == 1 and bv.batched_items == 3
    assert bv.cache_stats() == bls.pk_cache_stats()


@pytest.mark.parametrize("offload", [False, True])
async def test_batch_verifier_offload_modes(built, offload):
    """Both offload policies (inline and ``to_thread``) verify honest
    items, reject forgeries, and still form batches behind an in-flight
    verification."""
    from pushcdn_tpu_torch.proto.crypto.batch import BatchVerifier

    bv = BatchVerifier(BlsBn254Scheme, max_batch=8, offload=offload)
    ns = Namespace.USER_MARSHAL_AUTH

    async def one(seed, forge):
        kp = BlsBn254Scheme.generate_keypair(seed=seed)
        msg = b"mode %d" % seed
        sig = BlsBn254Scheme.sign(kp.private_key, ns, msg)
        if forge:
            sig = bytes(sig[:-1]) + bytes([sig[-1] ^ 1])
        return await bv.verify(kp.public_key, ns, msg, sig)

    results = await asyncio.gather(
        one(11, False), one(12, False), one(13, True), one(14, False))
    assert results == [True, True, False, True]
    assert bv.batches >= 1
    assert bv.singles + bv.batched_items == 4


@pytest.mark.parametrize("env,offload", [("0", False), ("1", True),
                                         ("bogus", None)])
def test_batch_verifier_offload_policy_from_env(monkeypatch, env, offload):
    """``PUSHCDN_CRYPTO_OFFLOAD`` pins the policy as in the JAX package;
    an unrecognized value falls back to the autodetect, on both."""
    from pushcdn_tpu.proto.crypto.batch import BatchVerifier as JaxVerifier
    from pushcdn_tpu_torch.proto.crypto.batch import BatchVerifier

    monkeypatch.setenv("PUSHCDN_CRYPTO_OFFLOAD", env)
    port = BatchVerifier(Ed25519Scheme)
    assert port._offload == JaxVerifier(Ed25519Scheme)._offload
    if offload is not None:
        assert port._offload is offload
    # Ed25519 has no batch path: straight through, counted as a single
    assert not port._batchable and port.cache_stats() is None


def test_production_run_def_matches_the_jax_package(jbls):
    """``production_run_def`` wires BLS keys on both links, TCP between
    brokers, TCP+TLS for users and Redis discovery, as the JAX package's
    does; with the library built, neither falls back to Ed25519."""
    from pushcdn_tpu.proto.def_ import production_run_def as jax_def
    from pushcdn_tpu_torch.proto.def_ import production_run_def
    from pushcdn_tpu_torch.proto.discovery.redis import Redis
    from pushcdn_tpu_torch.proto.transport import Tcp, TcpTls

    port, jax = production_run_def(), jax_def()
    assert port.user_def.scheme is port.broker_def.scheme is BlsBn254Scheme
    assert (port.broker_def.protocol, port.user_def.protocol,
            port.discovery) == (Tcp, TcpTls, Redis)

    def shape(d):
        return ([x.__name__ for x in (d.broker_def.protocol,
                                      d.broker_def.scheme,
                                      d.user_def.protocol,
                                      d.user_def.scheme, d.discovery)],
                sorted(d.topics.valid), d.global_permits,
                d.strong_consistency)
    assert shape(port) == shape(jax)
    assert sorted(port.topics.valid) == list(range(256))


# ---------------------------------------------------------------------------
# the two libraries against each other
# ---------------------------------------------------------------------------

SEEDS = [bytes(32), bytes(range(32)), b"\xff" * 32,
         bytes.fromhex("5a" * 16 + "a5" * 16)]


@pytest.mark.parametrize("seed32", SEEDS, ids=["zero", "ramp", "ones", "mix"])
def test_keys_and_signatures_are_byte_identical(jbls, seed32):
    """The same 32-byte seed gives the same key pair from both libraries;
    each signs the same message to the same bytes."""
    sk, pk = bls.keygen(seed32)
    assert (sk, pk) == jbls.keygen(seed32)
    msg = _namespaced(Namespace.USER_MARSHAL_AUTH, b"same bytes")
    assert bls.sign(sk, msg) == jbls.sign(sk, msg)


def test_scheme_keypairs_match_across_packages(jbls):
    from pushcdn_tpu.proto.crypto.signature import (
        BlsBn254Scheme as JaxScheme,
    )
    for seed in (0, 1, 7, 2**40 + 3):
        port, jax = (BlsBn254Scheme.generate_keypair(seed=seed),
                     JaxScheme.generate_keypair(seed=seed))
        assert (port.public_key, port.private_key) \
            == (jax.public_key, jax.private_key)


def test_signatures_cross_verify_and_forgeries_fail_under_both(jbls):
    from pushcdn_tpu.proto.crypto.signature import (
        BlsBn254Scheme as JaxScheme,
    )
    from pushcdn_tpu.proto.crypto.signature import Namespace as JaxNamespace
    ns, jns = Namespace.USER_MARSHAL_AUTH, JaxNamespace.USER_MARSHAL_AUTH
    kp = BlsBn254Scheme.generate_keypair(seed=31)
    other = BlsBn254Scheme.generate_keypair(seed=32)
    port_sig = BlsBn254Scheme.sign(kp.private_key, ns, b"cross")
    jax_sig = JaxScheme.sign(kp.private_key, jns, b"cross")
    assert port_sig == jax_sig
    assert JaxScheme.verify(kp.public_key, jns, b"cross", port_sig)
    assert BlsBn254Scheme.verify(kp.public_key, ns, b"cross", jax_sig)
    flipped = port_sig[:-1] + bytes([port_sig[-1] ^ 1])
    forgeries = [(kp.public_key, b"cross", flipped),
                 (other.public_key, b"cross", port_sig),
                 (kp.public_key, b"crosS", port_sig),
                 (kp.public_key, b"cross", b"\x00" * 64),
                 (b"\xff" * 128, b"cross", port_sig)]
    for pk, msg, sig in forgeries:
        assert not BlsBn254Scheme.verify(pk, ns, msg, sig)
        assert not JaxScheme.verify(pk, jns, msg, sig)
    # a signature in the broker namespace is no marshal signature anywhere
    broker_sig = JaxScheme.sign(kp.private_key,
                                JaxNamespace.BROKER_BROKER_AUTH, b"cross")
    assert not BlsBn254Scheme.verify(kp.public_key, ns, b"cross", broker_sig)


def test_batch_verdicts_and_cache_stats_agree(jbls):
    """One sequence of cached verifies and batches on both libraries, the
    line-table LRU at capacity 3 so that it evicts: every verdict and the
    cache's counters after every step are equal."""
    ns = Namespace.USER_MARSHAL_AUTH
    keys = [bls.keygen(bytes([i]) * 32) for i in range(5)]
    items = []
    for i, (sk, pk) in enumerate(keys):
        msg = _namespaced(ns, b"seq %d" % i)
        items.append((pk, msg, bls.sign(sk, msg)))
    forged = list(items)
    forged[1] = (items[1][0], items[1][1], items[2][2])
    seed = bytes(range(32, 64))
    saved = (bls.pk_cache_stats()["capacity"],
             jbls.pk_cache_stats()["capacity"])
    steps = [("one", items[0]), ("one", items[1]), ("one", items[0]),
             ("batch", items[:3]), ("batch", forged[:3]), ("one", items[3]),
             ("one", items[4]),     # capacity 3: evicts
             ("one", forged[1]), ("batch", items), ("batch", forged),
             ("one", items[0]), ("batch", [])]
    try:
        for lib in (bls, jbls):
            lib.pk_cache_clear()
            lib.pk_cache_configure(3)
        for kind, arg in steps:
            verdicts = []
            for lib in (bls, jbls):
                if kind == "one":
                    verdicts.append((lib.verify_cached(*arg),
                                     lib.verify(*arg)))
                else:
                    verdicts.append((lib.verify_batch(arg, seed),
                                     lib.verify_batch(arg, seed,
                                                      cached=False)))
            assert verdicts[0] == verdicts[1], (kind, verdicts)
            assert verdicts[0][0] == verdicts[0][1]
            assert bls.pk_cache_stats() == jbls.pk_cache_stats(), kind
        stats = bls.pk_cache_stats()
        assert stats["evictions"] >= 1 and stats["hits"] >= 1
    finally:
        for lib, cap in zip((bls, jbls), saved):
            lib.pk_cache_clear()
            lib.pk_cache_configure(cap)


# ---------------------------------------------------------------------------
# the BLS mesh: tests/test_integration.py's case on both packages
# ---------------------------------------------------------------------------


def _pkg(name: str) -> SimpleNamespace:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]
    testing = importlib.import_module(f"{root}.testing")
    sig = importlib.import_module(f"{root}.proto.crypto.signature")
    msg = importlib.import_module(f"{root}.proto.message")
    plane = importlib.import_module(f"{root}.broker.device_plane") \
        if name == "port" else None
    return SimpleNamespace(name=name, testing=testing, msg=msg,
                           scheme=sig.BlsBn254Scheme, plane=plane)


def _kind(p, m) -> str:
    return ("broadcast" if isinstance(m, p.msg.Broadcast) else
            "direct" if isinstance(m, p.msg.Direct) else type(m).__name__)


async def bls_mesh(p, **cluster_kw) -> dict:
    """Regression: broker↔broker mutual auth is scheme-agnostic — the
    wire field packs ``u16 len || key || identity``, so 128-byte BLS keys
    pass the same-key check just like 32-byte Ed25519 keys. Alice on
    broker 1 broadcasts; Bob on broker 0 receives it over the
    BLS-authenticated link."""
    t = p.testing
    cluster = await t.Cluster(num_brokers=2, scheme=p.scheme,
                              **cluster_kw).start()
    try:
        await t.wait_until(
            lambda: all(b.connections.num_brokers == 1
                        for b in cluster.brokers), timeout=30)
        await cluster.steer_load(0, 100)
        await cluster.steer_load(1, 0)
        alice = cluster.client(seed=71, topics=[0])
        await alice.ensure_initialized()   # broker 1
        await cluster.steer_load(0, 0)
        await cluster.steer_load(1, 100)
        bob = cluster.client(seed=72, topics=[0])
        await bob.ensure_initialized()     # broker 0
        await t.wait_until(
            lambda: sum(b.connections.num_users
                        for b in cluster.brokers) == 2)
        await t.wait_mesh_interest(cluster, topic=0, links=1, timeout=30)
        await alice.send_broadcast_message([0], b"bls mesh works")
        got = await asyncio.wait_for(bob.receive_message(), 10)
        await bob.send_direct_message(alice.public_key, b"and back")
        back = await asyncio.wait_for(alice.receive_message(), 10)
        record = dict(
            users=[b.connections.num_users for b in cluster.brokers],
            links=[b.connections.num_brokers for b in cluster.brokers],
            got=[_kind(p, got), bytes(got.message)],
            back=[_kind(p, back), bytes(back.message)],
            keys=[len(alice.public_key), len(bob.public_key)])
        if "device_plane" in cluster_kw:
            record["routed"] = [b.device_plane.messages_routed
                                for b in cluster.brokers]
        alice.close()
        bob.close()
        return record
    finally:
        await cluster.stop()


async def test_bls_mesh_and_cross_broker_delivery(jbls):
    jax_rec = await asyncio.wait_for(bls_mesh(_pkg("jax")), 60)
    port_rec = await asyncio.wait_for(bls_mesh(_pkg("port")), 60)
    assert jax_rec["got"] == ["broadcast", b"bls mesh works"]
    assert jax_rec["keys"] == [128, 128]
    assert port_rec == jax_rec


async def test_bls_mesh_through_dense_cpu_planes(jbls):
    """The same flow on the port with a dense plane on each broker (on the
    CPU, no bypass): the deliveries equal the JAX package's, and the
    planes routed them."""
    p = _pkg("port")
    cfg = p.plane.DevicePlaneConfig(num_user_slots=8, ring_slots=8,
                                    frame_bytes=256, extra_lanes=(),
                                    bypass_max_items=0,
                                    delivery_impl="dense")
    port_rec = await asyncio.wait_for(
        bls_mesh(p, device_plane=cfg, device="cpu"), 60)
    jax_rec = await asyncio.wait_for(bls_mesh(_pkg("jax")), 60)
    routed = port_rec.pop("routed")
    assert port_rec == jax_rec
    assert sum(routed) >= 2, routed


# ---------------------------------------------------------------------------
# the sources and the library's name
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bls_bn254.cpp", "bls_generated.inc"])
def test_sources_are_byte_equal_copies(name):
    assert (tnative.SRC_DIR / name).read_bytes() \
        == (ROOT / "native" / name).read_bytes()
    assert tnative.SRC_DIR == ROOT / "pushcdn_tpu_torch" / "native"


def test_library_name_follows_the_inc_and_the_host(monkeypatch, tmp_path):
    """``bls_bn254.cpp`` includes ``bls_generated.inc``: an edit to either
    names a new library (a stale one never loads); the host-tuned build's
    name carries the host's CPU fingerprint, the portable one's does
    not."""
    for name in ("bls_bn254.cpp", "bls_generated.inc"):
        (tmp_path / name).write_bytes((tnative.SRC_DIR / name).read_bytes())
    monkeypatch.setattr(tnative, "SRC_DIR", tmp_path)
    native_path, portable = bls.library_paths()
    assert native_path.name.endswith(f"-{bls.host_tag()}.so")
    assert portable.name.startswith("libpushcdn_bls_bn254-")
    assert native_path.parent == portable.parent == tnative.BUILD_DIR
    inc = tmp_path / "bls_generated.inc"
    kept = inc.read_bytes()
    inc.write_bytes(kept + b"// edited\n")
    assert bls.library_paths()[0] != native_path
    assert bls.library_paths()[1] != portable
    inc.write_bytes(kept)
    assert bls.library_paths() == (native_path, portable)
    monkeypatch.setattr(bls, "host_tag", lambda: "another-host")
    assert bls.library_paths()[0] != native_path
    assert bls.library_paths()[1] == portable


def test_refused_host_flag_falls_back_to_the_portable_build(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tnative, "_build_errors", {})
    monkeypatch.setattr(bls, "NATIVE_FLAGS", ("-mno-such-flag",))
    monkeypatch.setattr(bls, "_lib", None)
    monkeypatch.setattr(bls, "_tried", False)
    monkeypatch.setattr(bls, "_path", None)
    assert bls.available()
    assert bls.loaded_path() == bls.library_paths()[1]
    assert bls.loaded_path().parent == tmp_path / "out"
    assert bls.self_test() == 0
    assert "bls_bn254" not in tnative.build_errors()
