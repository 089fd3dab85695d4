"""Broker gauges (parity cdn-broker/src/metrics.rs:13-21)."""

from pushcdn_tpu_torch.proto.metrics import Gauge

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
