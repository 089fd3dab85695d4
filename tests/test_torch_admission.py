"""The port's admission control held against the JAX package's.

Every case of ``tests/test_admission.py`` runs on both packages: the
token bucket, the connection budgets and the readiness window, the
subscribe-rate shed through a real broker on the cut-through plane and on
its scalar twin, the typed pre-auth refusal of a user over its budget,
and the client library's typed ``Error(SHED)``. Each run returns a record
of what it saw (decisions, typed notices, counter deltas, deliveries,
readiness), and the port's record must equal JAX's. Then the cases the
reference has no twin of: the knobs read from the environment, and a
seeded storm of subscribe mutations and broadcasts from several users,
whose sheds, notices, counters and deliveries must agree frame for frame.
"""

import asyncio
import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
from _torch_libs import jax_routeplan_available

from pushcdn_tpu_torch.native import routeplan as port_routeplan

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}
IMPLS = ("native", "python")
NATIVE_OK = jax_routeplan_available() and port_routeplan.available()


def _pkg(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{ROOTS[name]}.{path}")

    return SimpleNamespace(
        name=name, admission=mod("broker.admission"),
        cutthrough=mod("broker.tasks.cutthrough"),
        listeners=mod("broker.tasks.listeners"),
        harness=mod("broker.test_harness"), client=mod("client"),
        metrics=mod("proto.metrics"), sig=mod("proto.crypto.signature"),
        error=mod("proto.error"), msg=mod("proto.message"),
        base=mod("proto.transport.base"), tcp=mod("proto.transport.tcp"),
        memory=mod("proto.transport.memory"), flightrec=mod("proto.flightrec"))


PACKAGES = {name: _pkg(name) for name in ROOTS}


def _need(impl: str) -> None:
    if impl == "native" and not NATIVE_OK:
        pytest.skip("native route-plan library unavailable (no working g++)")


def _both(record) -> dict:
    """``record(p)`` on each package; the port's must equal JAX's."""
    out = {name: record(p) for name, p in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


async def _both_async(record, *args) -> dict:
    out = {}
    for name, p in PACKAGES.items():
        async with asyncio.timeout(50):
            out[name] = await record(p, *args)
    assert out["port"] == out["jax"], out
    return out["port"]


class _FakeConn:
    """Just enough surface for the token bucket + flight recorder."""

    def __init__(self, p):
        self.flightrec = p.flightrec.FlightRecorder("fake")


class _FakeBroker:
    def __init__(self, num_users=0, num_brokers=0):
        self.connections = SimpleNamespace(num_users=num_users,
                                           num_brokers=num_brokers)


def _adm(p, broker=None, **kw):
    adm = p.admission.AdmissionControl(broker or _FakeBroker())
    for k, v in kw.items():
        setattr(adm, k, v)
    return adm


# ---------------------------------------------------------------------------
# tests/test_admission.py: token bucket + budgets
# ---------------------------------------------------------------------------

def test_token_bucket_burst_then_refuse_then_refill():
    def record(p):
        adm = _adm(p, subscribe_rate=1.0, subscribe_burst=3.0)
        conn = _FakeConn(p)
        got = [adm.allow_subscribe(conn) for _ in range(4)]
        # refill: pretend the last update was 2.5 s ago -> 2 whole tokens
        conn._sub_bucket[1] -= 2.5
        got += [adm.allow_subscribe(conn) for _ in range(3)]
        return got
    assert _both(record) == [True, True, True, False, True, True, False]


def test_token_bucket_disabled_and_connless_always_allow():
    def record(p):
        off = _adm(p, subscribe_rate=0.0)
        on = _adm(p, subscribe_rate=1.0, subscribe_burst=1.0)
        # no seat to meter: never refuse
        return [off.allow_subscribe(_FakeConn(p)), on.allow_subscribe(None),
                on.allow_subscribe(None)]
    assert _both(record) == [True, True, True]


def test_connection_budgets_and_ready_window():
    adms = {name: _adm(p, _FakeBroker(num_users=2, num_brokers=1),
                       max_user_conns=2, max_broker_conns=2,
                       ready_window_s=0.2)
            for name, p in PACKAGES.items()}
    out = {}
    for name, adm in adms.items():
        ok0, _ = adm.readiness_check()
        reason = adm.admit_user()
        ok1, detail = adm.readiness_check()
        out[name] = [ok0, reason, adm.admit_broker(), ok1, detail]
    time.sleep(0.25)
    for name, adm in adms.items():
        # window elapsed: back in rotation
        out[name] += [adm.readiness_check()[0], adm.summary()["shed_counts"]]
    assert out["port"] == out["jax"], out
    ok0, reason, broker_reason, ok1, detail, ok2, counts = out["port"]
    assert ok0 and reason is not None and "shed" in reason
    assert broker_reason is None  # broker tier under budget
    assert not ok1 and "user_conn" in detail
    assert ok2 and counts == {"user_conn": 1}


def test_unconfigured_admission_is_always_ready():
    def record(p):
        adm = _adm(p, max_user_conns=0, max_broker_conns=0,
                   subscribe_rate=0.0)
        return [adm.admit_user(), adm.admit_broker(), adm.readiness_check()]
    user, broker, (ok, detail) = _both(record)
    assert user is None and broker is None
    assert ok and "disabled" in detail


# ---------------------------------------------------------------------------
# tests/test_admission.py: subscribe-rate shed through a real broker
# ---------------------------------------------------------------------------

async def _drain_frames(p, conn, settle_s=0.1):
    got = []
    while True:
        try:
            items = await asyncio.wait_for(conn.recv_frames(), settle_s)
        except (asyncio.TimeoutError, Exception):
            return got
        for item in items:
            if type(item) is p.base.FrameChunk:
                got.extend(bytes(mv) for mv in item.views())
            else:
                got.append(bytes(item.data))
            item.release()


async def _subscribe_shed(p) -> dict:
    m = p.msg
    run = await p.harness.TestDefinition(connected_users=[[], [1]]).run()
    adm = run.broker.admission
    adm.subscribe_rate = 0.001  # effectively no refill in-test
    adm.subscribe_burst = 2.0
    adm.ready_window_s = 5.0
    shed0 = p.metrics.ROUTE_SHED_SUBSCRIBE.value
    try:
        sender = run.user(0).remote
        # 2 allowed (burst), 3 shed; the broadcast AFTER the storm must
        # still deliver — shedding degrades, never disconnects
        frames = [m.serialize(m.Subscribe([0]))] * 2 \
            + [m.serialize(m.Subscribe([1])), m.serialize(m.Unsubscribe([0])),
               m.serialize(m.Subscribe([1]))] \
            + [m.serialize(m.Broadcast([1], b"still-alive"))]
        await sender.send_raw_many(frames, flush=True)
        await asyncio.sleep(0.2)
        conns = run.broker.connections
        out = dict(
            connected=conns.has_user(b"user-0"),
            topics=sorted(conns.user_topics.get_values_of_key(b"user-0")),
            back=await _drain_frames(p, sender),
            shed=p.metrics.ROUTE_SHED_SUBSCRIBE.value - shed0,
            ready=adm.readiness_check(),
            user1=await _drain_frames(p, run.user(1).remote))
        # recovery: age the shed stamps past the window (no sleeps)
        adm.last_shed = {tier: ts - 10.0
                         for tier, ts in adm.last_shed.items()}
        out["recovered"] = adm.readiness_check()[0]
        return out
    finally:
        await run.shutdown()


@pytest.mark.parametrize("impl", IMPLS)
async def test_subscribe_shed_end_to_end(impl, monkeypatch):
    _need(impl)
    for p in PACKAGES.values():
        monkeypatch.setattr(p.cutthrough, "ROUTE_IMPL", impl)
    out = await _both_async(_subscribe_shed)
    m = PACKAGES["port"].msg
    assert out["connected"]
    # the sheds were NOT applied: user-0 holds only topic 0
    assert out["topics"] == [0], out
    # exactly 3 typed notices back to the sender, none silent
    notices = [m.deserialize(f) for f in out["back"]]
    assert len(notices) == 3 and all(
        isinstance(n, m.AuthenticateResponse) and n.permit == 0
        and "shed" in n.context for n in notices), notices
    assert out["shed"] == 3
    ok, detail = out["ready"]
    assert not ok and "subscribe" in detail
    # user-1 (subscribed to 1) still got the broadcast
    assert m.serialize(m.Broadcast([1], b"still-alive")) in out["user1"]
    assert out["recovered"]


# ---------------------------------------------------------------------------
# tests/test_admission.py: user connection budget refused pre-auth
# ---------------------------------------------------------------------------

class _FakeUnfinalized:
    def __init__(self, conn):
        self._conn = conn

    async def finalize(self, limiter):
        return self._conn


async def _budget_refusal(p) -> list:
    run = await p.harness.TestDefinition(connected_users=[[0]]).run()
    adm = run.broker.admission
    adm.max_user_conns = 1  # already at capacity with the injected user
    try:
        local, remote = await p.memory.gen_testing_connection_pair(
            run.broker.limiter)
        await p.listeners.handle_user_connection(
            run.broker, _FakeUnfinalized(local))
        raw = await asyncio.wait_for(remote.recv_raw(), 2.0)
        frame = bytes(raw.data)
        raw.release()
        return [frame, adm.readiness_check(),
                run.broker.connections.num_users]
    finally:
        await run.shutdown()


async def test_user_connection_budget_typed_refusal():
    frame, (ok, detail), users = await _both_async(_budget_refusal)
    m = PACKAGES["port"].msg
    msg = m.deserialize(frame)
    # the refusal is typed: permit=0 + the shed reason, pre-auth
    assert isinstance(msg, m.AuthenticateResponse)
    assert msg.permit == 0 and "shed" in msg.context
    assert "PUSHCDN_MAX_CONNS_USER" in msg.context
    assert not ok and "user_conn" in detail
    assert users == 1  # no second user was registered


# ---------------------------------------------------------------------------
# tests/test_admission.py: the client library's typed Error(SHED)
# ---------------------------------------------------------------------------

class _StubConn:
    """Minimal Connection stand-in for the client receive paths."""

    is_closed = False

    def __init__(self, messages=None, items=None):
        self._messages = list(messages or [])
        self._items = items

    async def recv_message(self):
        return self._messages.pop(0)

    async def recv_frames(self, n=1024):
        items, self._items = self._items, []
        return items

    def close(self):
        self.is_closed = True


class _StubItem:
    def __init__(self, frame: bytes):
        self.data = frame

    def release(self):
        pass


def _client(p):
    return p.client.Client(p.client.ClientConfig(
        marshal_endpoint="127.0.0.1:1", protocol=p.tcp.Tcp,
        keypair=p.sig.DEFAULT_SCHEME.generate_keypair(seed=1)))


def _shed_record(p, exc) -> list:
    e = exc.value
    return [e.kind == p.error.ErrorKind.SHED, "shed" in str(e),
            e.is_reconnectable]


async def _receive_message_shed(p) -> list:
    m = p.msg
    client = _client(p)
    client._connection = _StubConn(messages=[
        m.AuthenticateResponse(permit=0, context="shed: subscribe rate")])
    with pytest.raises(p.error.Error) as ei:
        await client.receive_message()
    # NOT reconnectable, and the connection was NOT torn down
    return _shed_record(p, ei) + [client._connection is not None]


async def test_client_receive_message_raises_typed_shed():
    assert await _both_async(_receive_message_shed) == [
        True, True, False, True]


async def _never_loses(p) -> list:
    m = p.msg
    notice = m.serialize(m.AuthenticateResponse(permit=0, context="shed: x"))
    payload = m.serialize(m.Broadcast([0], b"real"))
    client = _client(p)
    client._connection = _StubConn(
        items=[_StubItem(payload), _StubItem(notice)])
    out = await client.receive_messages()
    # the real delivery is returned first, the shed raises on the next call
    got = [m.serialize(x) for x in out]
    with pytest.raises(p.error.Error) as ei:
        await client.receive_messages()
    return [got] + _shed_record(p, ei)


async def test_client_receive_messages_never_loses_deliveries():
    m = PACKAGES["port"].msg
    assert await _both_async(_never_loses) == [
        [m.serialize(m.Broadcast([0], b"real"))], True, True, False]


async def _only_notices(p) -> list:
    m = p.msg
    notice = m.serialize(m.AuthenticateResponse(permit=0, context="shed: y"))
    client = _client(p)
    client._connection = _StubConn(items=[_StubItem(notice)])
    with pytest.raises(p.error.Error) as ei:
        await client.receive_messages()
    return _shed_record(p, ei)


async def test_client_receive_messages_only_notices_raises_immediately():
    assert await _both_async(_only_notices) == [True, True, False]


async def _resends_verbatim(p) -> list:
    m = p.msg
    client = _client(p)
    stub = _StubConn(messages=[
        m.AuthenticateResponse(permit=0, context="shed: subscribe rate")])
    sent = []

    async def send_message(msg, flush=False):
        sent.append(m.serialize(msg))

    stub.send_message = send_message
    client._connection = stub
    # optimistic mirror says topic 5 is subscribed (the broker shed it)
    client._topics.add(5)
    await client.subscribe([5])
    before = list(sent)  # the delta filter suppresses the resend
    with pytest.raises(p.error.Error) as ei:
        await client.receive_message()
    # post-shed: the retry goes out verbatim despite the stale mirror
    await client.subscribe([5])
    await client.unsubscribe([7])  # not in the mirror either: still sent
    return [before, sent] + _shed_record(p, ei)[:1]


async def test_client_resends_verbatim_after_shed():
    m = PACKAGES["port"].msg
    assert await _both_async(_resends_verbatim) == [
        [], [m.serialize(m.Subscribe([5])), m.serialize(m.Unsubscribe([7]))],
        True]


# ---------------------------------------------------------------------------
# beyond the reference's cases: knobs, and a seeded storm on both packages
# ---------------------------------------------------------------------------

KNOBS = {"PUSHCDN_MAX_CONNS_USER": "64", "PUSHCDN_MAX_CONNS_BROKER": "3",
         "PUSHCDN_SUBSCRIBE_RATE": "20", "PUSHCDN_SHED_READY_S": "2"}


def test_admission_reads_the_same_knobs(monkeypatch):
    """The environment sets the same budgets on both packages (the burst
    defaults to max(8, 4 x rate), and a malformed value is ignored)."""
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PUSHCDN_SUBSCRIBE_BURST", "not-a-number")

    def record(p):
        adm = p.admission.AdmissionControl(_FakeBroker(num_users=64,
                                                       num_brokers=3))
        user, broker = adm.admit_user(), adm.admit_broker()
        return [adm.summary(), user, broker, adm.readiness_check()]
    summary, user, broker, (ok, detail) = _both(record)
    assert summary["enabled"] and summary["subscribe_burst"] == 80.0
    assert (summary["max_user_conns"], summary["max_broker_conns"]) == (64, 3)
    assert "retry-after=2" in user and "PUSHCDN_MAX_CONNS_BROKER" in broker
    assert summary["shed_counts"] == {"user_conn": 1, "broker_conn": 1}
    assert not ok and detail == \
        "load shedding active (broker_conn, user_conn)"


STORM_USERS, STORM_TOPICS, STORM_FRAMES = 6, 8, 40


def _storm(p, seed: int) -> list:
    """Per user, a seeded mix of Subscribe / Unsubscribe / SubscribeFrom
    (SEQ_LIVE) mutations and broadcasts, as wire frames."""
    m = p.msg
    rng = np.random.default_rng(7100 + seed)
    out = []
    for u in range(STORM_USERS):
        frames = []
        for i in range(STORM_FRAMES):
            kind = int(rng.integers(0, 4))
            t = int(rng.integers(0, STORM_TOPICS))
            if kind == 0:
                frames.append(m.serialize(m.Subscribe([t])))
            elif kind == 1:
                frames.append(m.serialize(m.Unsubscribe([t])))
            elif kind == 2:
                frames.append(m.serialize(m.SubscribeFrom(
                    topic=t, seq=m.SEQ_LIVE)))
            else:
                frames.append(m.serialize(m.Broadcast(
                    [t], b"u%d-f%d" % (u, i))))
        out.append(frames)
    return out


async def _storm_run(p, seed: int) -> dict:
    topics = importlib.import_module(f"{ROOTS[p.name]}.proto.topic")
    run = await p.harness.TestDefinition(
        connected_users=[[] for _ in range(STORM_USERS)],
        topics=topics.TopicSpace.range(STORM_TOPICS)).run()
    adm = run.broker.admission
    adm.subscribe_rate = 0.001  # no refill within the run: deterministic
    adm.subscribe_burst = 6.0
    shed0 = p.metrics.ROUTE_SHED_SUBSCRIBE.value
    try:
        # one user at a time, so the deliveries' order is the send order
        for u, frames in enumerate(_storm(p, seed)):
            await run.user(u).remote.send_raw_many(frames, flush=True)
            await asyncio.sleep(0.05)
        conns = run.broker.connections
        return dict(
            topics=[sorted(conns.user_topics.get_values_of_key(
                f"user-{u}".encode())) for u in range(STORM_USERS)],
            received=[await _drain_frames(p, run.user(u).remote)
                      for u in range(STORM_USERS)],
            shed=p.metrics.ROUTE_SHED_SUBSCRIBE.value - shed0,
            counts=adm.summary()["shed_counts"],
            users=conns.num_users)
    finally:
        await run.shutdown()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 1])
async def test_seeded_subscribe_storm_matches_jax(seed, impl, monkeypatch):
    """The same seeded storm through both packages' brokers: the same
    mutations applied and shed, the same typed notices in the same place
    of each user's stream, the same counters, and every user kept."""
    _need(impl)
    for p in PACKAGES.values():
        monkeypatch.setattr(p.cutthrough, "ROUTE_IMPL", impl)
    out = await _both_async(_storm_run, seed)
    m = PACKAGES["port"].msg
    notices = sum(isinstance(m.deserialize(f), m.AuthenticateResponse)
                  for box in out["received"] for f in box)
    mutations = sum(m.deserialize(f).__class__ is not m.Broadcast
                    for frames in _storm(PACKAGES["port"], seed)
                    for f in frames)
    assert out["users"] == STORM_USERS
    assert notices == out["shed"] == out["counts"]["subscribe"]
    # each user spends its burst of 6 tokens, and the rest is shed
    assert out["shed"] == mutations - 6 * STORM_USERS
