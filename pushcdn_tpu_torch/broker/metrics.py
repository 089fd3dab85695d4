"""Broker gauges (parity cdn-broker/src/metrics.rs:13-21) and the device
plane's own counters."""

from pushcdn_tpu_torch.proto.metrics import Counter, Gauge

NUM_USERS_CONNECTED = Gauge("cdn_num_users_connected",
                            "Users currently connected to this broker")
NUM_BROKERS_CONNECTED = Gauge("cdn_num_brokers_connected",
                              "Peer brokers currently connected to this broker")

# device-plane observability (no reference analog — the data plane the
# reference doesn't have): steps run and messages routed on-device,
# updated by broker.update_metrics() from the attached plane's counters
DEVICE_STEPS = Gauge("cdn_device_steps",
                     "Routing steps executed by the attached device plane")
DEVICE_MESSAGES_ROUTED = Gauge(
    "cdn_device_messages_routed",
    "Messages delivered via the device plane's egress")

# The single-shard plane's pump, cut into phases that tile its wall time
# (broker/device_plane.py): one add per phase per pump iteration, and a
# render adds the open idle phase so far (DevicePlane.credit_idle).
PUMP_PHASES = ("idle", "wake", "coalesce", "snapshot", "handoff", "device",
               "encode", "resume", "egress")
PLANE_PUMP_SECONDS = Counter(
    "cdn_plane_pump_seconds",
    "Cumulative seconds of the device plane's pump by phase (idle, wake, "
    "coalesce, snapshot, handoff, device, encode, resume, egress); the "
    "phases tile the pump's wall time",
    labels=("phase",))
PLANE_PUMP_PHASE_SECONDS = tuple(PLANE_PUMP_SECONDS.labels(phase=p)
                                 for p in PUMP_PHASES)
# The plane's staging decisions, once per outcome per staging call:
# bypass is the idle bypass alone, ineligible every other host-path
# answer, full every attempt refused for want of a slot (retries too)
PLANE_STAGE_FRAMES = Counter(
    "cdn_plane_stage_frames",
    "Frames offered to the device plane's staging, by result "
    "(staged|bypass|ineligible|full)",
    labels=("result",))
PLANE_STAGED = PLANE_STAGE_FRAMES.labels(result="staged")
PLANE_BYPASS = PLANE_STAGE_FRAMES.labels(result="bypass")
PLANE_INELIGIBLE = PLANE_STAGE_FRAMES.labels(result="ineligible")
PLANE_FULL = PLANE_STAGE_FRAMES.labels(result="full")

# The broker-to-broker link, on the scalar receive loop and routing path
# (every broker with a device plane takes it; the cut-through plan's
# chunks are not counted). One stamp pair per batch of
# broker_receive_loop, from the batch's arrival to its egress flush:
# deserialize, hook, route and stage, the wait of a full ring included.
LINK_RECEIVE_SECONDS = Counter(
    "cdn_link_receive_seconds",
    "Cumulative seconds of broker_receive_loop's batches from their "
    "arrival to their egress flush (deserialize, hook, route, stage)")
# Direct and Broadcast frames received from peer brokers (dir=in, once
# per batch) and forwarded to them (dir=out, at the routing decision, as
# the ledger's per-link table counts them)
LINK_FRAMES = Counter(
    "cdn_link_frames",
    "Direct and Broadcast frames received from (dir=in) and forwarded to "
    "(dir=out) peer brokers, by kind (direct|broadcast)",
    labels=("dir", "kind"))
LINK_IN_DIRECT = LINK_FRAMES.labels(dir="in", kind="direct")
LINK_IN_BROADCAST = LINK_FRAMES.labels(dir="in", kind="broadcast")
LINK_OUT_DIRECT = LINK_FRAMES.labels(dir="out", kind="direct")
LINK_OUT_BROADCAST = LINK_FRAMES.labels(dir="out", kind="broadcast")
