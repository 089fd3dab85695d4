"""The readers of the plane's pump phases, its staging counters and the
TLS write seconds, on recorded ``/metrics`` texts: each differences the
scrapes at the window's two ends and sums over the brokers, and reads
nothing where the program has no such counter."""

from types import SimpleNamespace

import pytest

from cdnbench import common
from cdnbench.layers import (plane_bypass_pct, pump_device_ms, pump_idle_pct,
                             pump_wait_pct, tls_write_busy_pct)

BEFORE = """# TYPE cdn_plane_pump_seconds counter
cdn_plane_pump_seconds{phase="idle"} 10.0
cdn_plane_pump_seconds{phase="wake"} 1.0
cdn_plane_pump_seconds{phase="coalesce"} 0.5
cdn_plane_pump_seconds{phase="snapshot"} 0.25
cdn_plane_pump_seconds{phase="handoff"} 0.5
cdn_plane_pump_seconds{phase="device"} 2.0
cdn_plane_pump_seconds{phase="encode"} 0.5
cdn_plane_pump_seconds{phase="resume"} 0.5
cdn_plane_pump_seconds{phase="egress"} 1.0
cdn_plane_pump_seconds 16.25
cdn_device_steps 100
cdn_plane_stage_frames{result="staged"} 1000
cdn_plane_stage_frames{result="bypass"} 500
cdn_plane_stage_frames{result="ineligible"} 70
cdn_plane_stage_frames{result="full"} 3
cdn_plane_stage_frames 1573
cdn_stream_write_seconds{transport="tcp+tls"} 4.0
cdn_stream_write_seconds{transport="tcp"} 1.0
cdn_stream_write_seconds 5.0
"""

# 10 s later: 6 s idle, 1 s wake, 0.5 s handoff, 0.5 s resume, 2 s
# device over 200 steps, 600 frames staged and 200 bypassed, 1.5 s of
# TLS writes
AFTER = """cdn_plane_pump_seconds{phase="idle"} 16.0
cdn_plane_pump_seconds{phase="wake"} 2.0
cdn_plane_pump_seconds{phase="coalesce"} 0.5
cdn_plane_pump_seconds{phase="snapshot"} 0.25
cdn_plane_pump_seconds{phase="handoff"} 1.0
cdn_plane_pump_seconds{phase="device"} 4.0
cdn_plane_pump_seconds{phase="encode"} 0.5
cdn_plane_pump_seconds{phase="resume"} 1.0
cdn_plane_pump_seconds{phase="egress"} 1.0
cdn_plane_pump_seconds 26.25
cdn_device_steps 300
cdn_plane_stage_frames{result="staged"} 1600
cdn_plane_stage_frames{result="bypass"} 700
cdn_plane_stage_frames{result="ineligible"} 700
cdn_plane_stage_frames{result="full"} 3000
cdn_plane_stage_frames 6000
cdn_stream_write_seconds{transport="tcp+tls"} 5.5
cdn_stream_write_seconds{transport="tcp"} 9.0
cdn_stream_write_seconds 14.5
"""

# a program without the counters: only what the parent already serves
PARENT = """cdn_device_steps 100
cdn_device_messages_routed 10
"""


def run_of(before=BEFORE, after=AFTER, brokers=1):
    scrapes = {f"broker{i}": (common.parse_metrics(before),
                              common.parse_metrics(after))
               for i in range(brokers)}
    return SimpleNamespace(scrapes=scrapes, window_s=10.0, traces={})


@pytest.mark.parametrize("reader,want", [
    (pump_idle_pct, 60.0),           # 6 s of 10
    (pump_wait_pct, 20.0),           # 1 + 0.5 + 0.5 s of 10
    (pump_device_ms, 10.0),          # 2 s over 200 steps
    (plane_bypass_pct, 25.0),        # 200 of 800
    (tls_write_busy_pct, 15.0),      # 1.5 s of 10; the tcp series apart
])
def test_reader_differences_the_window(reader, want):
    assert reader.read(run_of()) == pytest.approx(want)


@pytest.mark.parametrize("reader,want", [
    (pump_idle_pct, 120.0), (pump_wait_pct, 40.0), (pump_device_ms, 10.0),
    (plane_bypass_pct, 25.0), (tls_write_busy_pct, 30.0)])
def test_reader_sums_over_brokers(reader, want):
    assert reader.read(run_of(brokers=2)) == pytest.approx(want)


@pytest.mark.parametrize("reader", [
    pump_idle_pct, pump_wait_pct, pump_device_ms, plane_bypass_pct,
    tls_write_busy_pct])
def test_reader_reads_nothing_without_its_counter(reader):
    assert reader.read(run_of(PARENT, PARENT)) is None
    assert reader.read(run_of(BEFORE, BEFORE)) is None


@pytest.mark.parametrize("reader", [pump_idle_pct, pump_wait_pct])
def test_pump_share_reads_zero_when_its_phases_stood_still(reader):
    # the pump stepped all through the window: no idle and no wait moved,
    # and the reading is 0, not nothing
    after = BEFORE.replace('phase="device"} 2.0', 'phase="device"} 9.0')
    assert reader.read(run_of(after=after)) == 0.0


def test_pump_device_ms_needs_steps():
    after = AFTER.replace("cdn_device_steps 300", "cdn_device_steps 100")
    assert pump_device_ms.read(run_of(after=after)) is None


def test_benchmark_lists_each_reader():
    names = {m["name"] for m in common.benchmark()["per_layer"]}
    for reader in ("pump_idle_pct", "pump_wait_pct", "pump_device_ms",
                   "plane_bypass_pct", "tls_write_busy_pct"):
        assert f"{reader}.rate" in names
