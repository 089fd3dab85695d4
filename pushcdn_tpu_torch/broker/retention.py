"""Durable topics: the topic namespace and wildcard interest.

A copy of the part of ``pushcdn_tpu.broker.retention`` that runs when no
topic is retained (``PUSHCDN_RETAIN_TOPICS`` empty):

- **Topic names** — ``PUSHCDN_TOPIC_NAMES`` (``"name=topic,..."``) binds
  hierarchical names (``consensus.vote``) onto wire topics through a
  :class:`~pushcdn_tpu_torch.proto.topic.TopicNamespace`, and the bound
  names install the flow-class table (``consensus.*`` → consensus,
  ``bulk.*`` → bulk) that the senders and the ledger account by.
- **Wildcard interest** — a pattern riding ``SubscribeFrom.pattern``
  compiles to the bound topics it covers and subscribes through the
  plain ``Connections.subscribe_user_to`` path, so the device plane's
  mirrors see ordinary per-topic updates. A *watch* keeps the union
  live: a name bound later subscribes the users whose pattern covers it.
- **Explicit ``SubscribeFrom``** — with nothing retained there is
  nothing to replay: the topic is a plain subscribe, and an unknown
  topic kicks as ``Subscribe`` does.

The retention rings, replay and the last-value cache are not copied: a
broker asked to retain topics refuses to start rather than run without
them.
"""

from __future__ import annotations

import logging
import os
from typing import TYPE_CHECKING, Iterable

from pushcdn_tpu_torch.proto import flowclass
from pushcdn_tpu_torch.proto.error import ErrorKind, bail
from pushcdn_tpu_torch.proto.topic import TopicNamespace

if TYPE_CHECKING:
    from pushcdn_tpu_torch.broker.broker import Broker

logger = logging.getLogger("pushcdn.broker")


class DurableTopics:
    """Per-broker durable-topic subsystem (see module docstring). Always
    constructed, since wildcard subscribe works without retention;
    ``enabled`` iff any topic is retained, which is never here."""

    def __init__(self, broker: "Broker", topics: Iterable[int] = ()):
        self.broker = broker
        self.topics = frozenset(int(t) for t in topics)
        if self.topics:
            bail(ErrorKind.PARSE,
                 "retained topics need the retention rings, which this "
                 "package does not have")
        space = broker.run_def.topics if broker.run_def is not None else None
        self.namespace = TopicNamespace(space)
        # wildcard watches: user key -> {pattern -> namespace watch handle}
        self._watches: dict = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_env(cls, broker: "Broker") -> "DurableTopics":
        retain = os.environ.get("PUSHCDN_RETAIN_TOPICS", "").strip()
        d = cls(broker, [0] if retain else ())
        names = os.environ.get("PUSHCDN_TOPIC_NAMES", "")
        for pair in names.split(","):
            pair = pair.strip()
            if not pair or "=" not in pair:
                continue
            name, topic = pair.rsplit("=", 1)
            try:
                d.namespace.bind(name.strip(), int(topic))
            except ValueError as exc:
                logger.warning("PUSHCDN_TOPIC_NAMES entry %r ignored: %s",
                               pair, exc)
        # the bound names imply the flow-class taxonomy ("consensus.*",
        # "bulk.*", ...): publish the compiled topic -> class table
        flowclass.install_table(flowclass.compile_table(d.namespace))
        return d

    @property
    def enabled(self) -> bool:
        return bool(self.topics)

    def close(self) -> None:
        for handles in self._watches.values():
            for h in handles.values():
                self.namespace.unwatch(h)
        self._watches.clear()

    # -- publish side --------------------------------------------------------

    def on_publish(self, pruned, message, raw, to_users_only: bool) -> bool:
        """Called at broadcast ingress with the pruned topic list. True:
        the caller routes the frame normally (nothing is retained)."""
        return True

    # -- subscribe side ------------------------------------------------------

    def handle_subscribe_from(self, public_key, msg, conn) -> bool:
        """Process one ``SubscribeFrom``: a pattern subscribes the bound
        topics it covers and keeps watching; an explicit topic is a plain
        subscribe. Returns False when the sender must be disconnected (an
        unknown explicit topic, ``Subscribe`` parity)."""
        conns = self.broker.connections
        space = self.broker.run_def.topics
        if msg.pattern:
            topics = [t for t in self.namespace.match(msg.pattern)
                      if t in space.valid]
            self._watch_pattern(public_key, msg.pattern)
        else:
            pruned, bad = space.prune([msg.topic])
            if bad:
                return False  # unknown topic ⇒ disconnect (Subscribe parity)
            topics = list(pruned)
        if topics:
            conns.subscribe_user_to(public_key, topics)
        return True  # nothing bound yet: a pattern watch keeps it live

    def _watch_pattern(self, public_key, pattern: str) -> None:
        """Keep a wildcard subscription live: future ``bind``/``unbind``
        calls matching the pattern subscribe/unsubscribe this user through
        the plain per-topic interest path."""
        key = bytes(public_key)
        per_user = self._watches.setdefault(key, {})
        if pattern in per_user:
            return

        def on_add(name, topic, _key=key):
            conns = self.broker.connections
            if conns.has_user(_key):
                if topic in self.broker.run_def.topics.valid:
                    conns.subscribe_user_to(_key, [topic])
            else:
                self.unwatch_user(_key)  # user gone: lazy cleanup

        def on_remove(name, topic, _key=key):
            conns = self.broker.connections
            if conns.has_user(_key):
                conns.unsubscribe_user_from(_key, [topic])
            else:
                self.unwatch_user(_key)

        per_user[pattern] = self.namespace.watch(pattern, on_add=on_add,
                                                 on_remove=on_remove)

    def unwatch_user(self, public_key) -> None:
        for h in self._watches.pop(bytes(public_key), {}).values():
            self.namespace.unwatch(h)
