"""The port's client pieces held against the JAX package's: the
full-jitter backoff, the live gap detector, the batch decoder of the
receive path, the typed shed errors and the reconnect loop.

Every case runs on both packages with the same seeds and inputs and
compares the results exactly.
"""

import asyncio
import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("jax", "port")


def _pkg(name: str) -> SimpleNamespace:
    root = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}[name]

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return SimpleNamespace(
        name=name, client=mod("client.client"), user=mod("proto.auth.user"),
        error=mod("proto.error"), msg=mod("proto.message"),
        memory=mod("proto.transport.memory"),
        sig=mod("proto.crypto.signature"))


def _both(fn):
    """``fn(package)`` on each package; asserts the results are equal and
    returns the port's."""
    out = {name: fn(_pkg(name)) for name in PACKAGES}
    assert out["port"] == out["jax"]
    return out["port"]


# ---------------------------------------------------------------------------
# the backoff policy
# ---------------------------------------------------------------------------


def _draws(p, seed, attempts, **kw):
    random.seed(seed)
    return [p.client.backoff_delay(a, **kw) for a in attempts
            for _ in range(50)]


@pytest.mark.parametrize("seed", [1207, 7, 3])
def test_backoff_is_full_jitter_in_both(seed):
    base, cap = 0.25, 30.0
    draws = _both(lambda p: _draws(p, seed, range(12), base_s=base,
                                   cap_s=cap))
    for attempt in range(12):
        ceiling = min(cap, base * (2 ** attempt))
        window = draws[attempt * 50:(attempt + 1) * 50]
        assert all(0.0 <= d <= ceiling for d in window)
        assert min(window) < 0.3 * ceiling and max(window) > 0.7 * ceiling


@pytest.mark.parametrize("attempt", [20, 40, 63])
def test_backoff_caps_growth_in_both(attempt):
    draws = _both(lambda p: _draws(p, attempt, [attempt], base_s=0.25,
                                   cap_s=3.0))
    assert all(d <= 3.0 for d in draws)


@pytest.mark.parametrize("hint", [5.0, 0.001])
def test_backoff_retry_after_is_a_floor_in_both(hint):
    attempt = 0 if hint > 1 else 8
    draws = _both(lambda p: _draws(p, 3, [attempt], retry_after_s=hint))
    assert min(draws) >= hint
    if hint < 1:   # a small hint never truncates the jitter
        assert max(draws) > 1.0


# ---------------------------------------------------------------------------
# the live gap detector
# ---------------------------------------------------------------------------


def _observations(seed: int):
    """Per stream a sequence with holes, late fills and duplicates."""
    rng = np.random.default_rng(seed)
    out = []
    for stream in range(4):
        seqs = np.arange(int(rng.integers(50, 400)))
        seqs = seqs[rng.random(len(seqs)) < 0.85]          # holes
        late = rng.choice(np.arange(len(seqs) * 2), 10)   # some heal
        dups = rng.choice(seqs, 8)
        order = np.concatenate([seqs, late, dups])
        # a local shuffle: reorders inside windows of 16
        keys = np.arange(len(order)) + rng.integers(0, 16, len(order))
        out += [(stream, int(s)) for s in order[np.argsort(keys)]]
    if seed % 2:
        out.append((9, 10_000))
        out.append((9, 10_000 + 5000))   # past MAX_OPEN holes at once
    return out


@pytest.mark.parametrize("seed", range(4))
def test_gap_detector_counts_as_jax(seed):
    def run(p):
        det = p.client.GapDetector()
        trail = []
        for stream, seq in _observations(seed):
            det.observe(stream, seq)
            trail.append((det.events, det.healed, det.unique,
                          det.duplicates))
        return trail, det.open_gaps

    trail, open_gaps = _both(run)
    events, healed, unique, dups = trail[-1]
    assert open_gaps <= events - healed
    assert dups > 0 and healed > 0 and unique > 0


# ---------------------------------------------------------------------------
# the receive path's batch decoder
# ---------------------------------------------------------------------------


def _frames(p, seed: int):
    rng = np.random.default_rng(seed)
    m = p.msg
    out = []
    for i in range(int(rng.integers(20, 120))):
        body = rng.integers(0, 256, int(rng.integers(0, 3000)),
                            dtype=np.uint8).tobytes()
        r = rng.random()
        if r < 0.45:
            msg = m.Broadcast([int(t) for t in rng.integers(0, 256, 2)], body)
        elif r < 0.9:
            msg = m.Direct(bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                           body)
        elif r < 0.95:
            msg = m.Subscribe([int(t) for t in rng.integers(0, 256, 3)])
        else:
            msg = m.AuthenticateResponse(permit=i, context="ctx %d" % i)
        out.append(m.serialize(msg))
    return out


@pytest.mark.parametrize("seed", range(3))
async def test_decode_received_matches_jax(seed):
    async def run(p):
        frames = _frames(p, seed)
        a, b = await p.memory.gen_testing_connection_pair()
        try:
            await a.send_raw_many(frames, flush=True)
            got = []
            async with asyncio.timeout(20):
                while len(got) < len(frames):
                    got += p.client.decode_received(await b.recv_frames())
            return [p.msg.serialize(m) for m in got]
        finally:
            a.close()
            b.close()

    out = {name: await run(_pkg(name)) for name in PACKAGES}
    assert out["port"] == out["jax"] == _frames(_pkg("port"), seed)


async def test_decode_received_raises_on_a_malformed_frame_as_jax():
    async def run(p):
        a, b = await p.memory.gen_testing_connection_pair()
        try:
            good = p.msg.serialize(p.msg.Direct(b"k", b"fine"))
            await a.send_raw_many([good, b"\xfe\x00\x01", good], flush=True)
            async with asyncio.timeout(10):
                while True:
                    try:
                        p.client.decode_received(await b.recv_frames())
                    except Exception as exc:
                        return type(exc).__name__, str(exc)
        finally:
            a.close()
            b.close()

    out = {name: await run(_pkg(name)) for name in PACKAGES}
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# typed sheds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("context", [
    "shed: budget reached; retry-after=5",
    "shed: x; retry-after=2.75 more",
    "shed: no hint here",
    "retry-after=abc",
])
def test_retry_after_hint_parsing_matches_jax(context):
    _both(lambda p: p.error.retry_after_hint(context))


@pytest.mark.parametrize("kind,context", [
    ("SHED", "broker shed the connection: shed: user connection budget 1 "
             "reached; retry-after=5"),
    ("AUTHENTICATION", "nope; retry-after=5"),
])
def test_shed_error_carries_retry_after_as_jax(kind, context):
    hint = _both(lambda p: p.error.Error(
        getattr(p.error.ErrorKind, kind), context).retry_after_s)
    assert (hint == 5.0) == (kind == "SHED")


@pytest.mark.parametrize("who,context", [
    ("broker", "shed: user connection budget 1 reached; retry-after=5"),
    ("marshal", "bad signature"),
    ("marshal", "shed"),
])
def test_bail_rejection_types_sheds_as_jax(who, context):
    def run(p):
        with pytest.raises(p.error.Error) as ei:
            p.user._bail_rejection(who, context)
        return ei.value.kind.name, ei.value.retry_after_s, str(ei.value)

    kind, _, _ = _both(run)
    assert (kind == "SHED") == context.startswith("shed")


@pytest.mark.parametrize("permit,context", [(0, "shed: slow down"),
                                            (0, ""), (0, "retry-after=3")])
def test_client_shed_error_matches_jax(permit, context):
    def run(p):
        c = p.client.Client(p.client.ClientConfig(
            marshal_endpoint="nowhere", protocol=p.memory.Memory,
            keypair=p.sig.DEFAULT_SCHEME.generate_keypair(seed=1)))
        err = c._shed_error(p.msg.AuthenticateResponse(permit=permit,
                                                       context=context))
        return err.kind.name, err.message, c._topics_dirty

    assert _both(run)[0] == "SHED"


async def test_reconnect_loop_uses_backoff_in_both(monkeypatch):
    """The reconnect loop feeds (attempt, server hint) into the policy:
    attempts count up from 0 in both packages."""
    async def run(p):
        delays = []

        def fake_backoff(attempt, retry_after_s=None, **kw):
            delays.append((attempt, retry_after_s))
            return 0.0

        monkeypatch.setattr(p.client, "backoff_delay", fake_backoff)
        c = p.client.Client(p.client.ClientConfig(
            marshal_endpoint=f"nowhere-{p.name}", protocol=p.memory.Memory,
            keypair=p.sig.DEFAULT_SCHEME.generate_keypair(seed=83_002)))
        task = asyncio.ensure_future(c._get_connection())
        async with asyncio.timeout(20):
            while len(delays) < 4:
                await asyncio.sleep(0.01)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return delays[:4]

    out = {name: await run(_pkg(name)) for name in PACKAGES}
    assert out["port"] == out["jax"] == [(a, None) for a in range(4)]
