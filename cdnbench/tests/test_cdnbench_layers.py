"""The per-layer readers on recorded ``/metrics`` texts and trace
summaries, and the Prometheus helpers they use."""

import math
from types import SimpleNamespace

import pytest

from cdnbench import common
from cdnbench.layers import (dense_roofline, device_idle_pct,
                             egress_encode_busy_pct, plane_routed_pct,
                             writer_queue_delay_p99_ms)

BEFORE = """# HELP cdn_device_messages_routed Messages delivered via the plane
# TYPE cdn_device_messages_routed gauge
cdn_device_messages_routed 1000
cdn_egress_frames{peer="user"} 50
cdn_egress_frames{peer="broker"} 7
cdn_native_seconds{kernel="egress_encode"} 0.5
cdn_native_seconds{kernel="route_plan"} 9
cdn_writer_queue_delay_seconds_bucket{class="live",le="0.001"} 10
cdn_writer_queue_delay_seconds_bucket{class="live",le="0.005"} 10
cdn_writer_queue_delay_seconds_bucket{class="live",le="0.01"} 10
cdn_writer_queue_delay_seconds_bucket{class="live",le="+Inf"} 10
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="0.001"} 0
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="0.005"} 0
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="0.01"} 0
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="+Inf"} 0
"""

AFTER = """cdn_device_messages_routed 4000
cdn_egress_frames{peer="user"} 1050
cdn_egress_frames{peer="broker"} 70
cdn_native_seconds{kernel="egress_encode"} 2.5
cdn_native_seconds{kernel="route_plan"} 9
cdn_writer_queue_delay_seconds_bucket{class="live",le="0.001"} 60
cdn_writer_queue_delay_seconds_bucket{class="live",le="0.005"} 100
cdn_writer_queue_delay_seconds_bucket{class="live",le="0.01"} 110
cdn_writer_queue_delay_seconds_bucket{class="live",le="+Inf"} 110
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="0.001"} 0
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="0.005"} 0
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="0.01"} 0
cdn_writer_queue_delay_seconds_bucket{class="consensus",le="+Inf"} 0
"""


def run_of(**kw):
    scrapes = {"broker0": (common.parse_metrics(BEFORE),
                           common.parse_metrics(AFTER))}
    return SimpleNamespace(scrapes=scrapes, window_s=10.0, traces={}, **kw)


def test_parse_reads_labels_and_skips_comments():
    s = common.parse_metrics(BEFORE)
    assert common.metric_sum(s, "cdn_egress_frames", peer="user") == 50
    assert common.metric_sum(s, "cdn_egress_frames") == 57
    assert all(not n.startswith("#") for n, _, _ in s)


def test_writer_queue_p99_interpolates_in_its_bucket():
    # 100 new observations: 50 <= 1 ms, 40 in (1, 5] ms, 10 in (5, 10] ms;
    # rank 99 lies 9/10 of the way through the last bucket
    assert writer_queue_delay_p99_ms.read(run_of()) == \
        pytest.approx((0.005 + 0.9 * 0.005) * 1e3)


def test_writer_queue_p99_without_observations_reads_nothing():
    run = run_of()
    run.scrapes = {"b": (common.parse_metrics(BEFORE),
                         common.parse_metrics(BEFORE))}
    assert writer_queue_delay_p99_ms.read(run) is None


def test_histogram_quantile_top_bucket_reads_the_last_bound():
    assert common.histogram_quantile(0.99, {1.0: 0, math.inf: 5}) == 1.0


def test_plane_routed_share():
    # 3000 routed by the plane, 1000 by the bypass and the host path
    assert plane_routed_pct.read(run_of()) == pytest.approx(75.0)


def test_plane_routed_sums_over_brokers():
    run = run_of()
    run.scrapes["broker1"] = run.scrapes["broker0"]
    assert plane_routed_pct.read(run) == pytest.approx(75.0)


def test_egress_encode_busy_share():
    assert egress_encode_busy_pct.read(run_of()) == pytest.approx(20.0)


def _trace(**dense):
    return dict(window_s=10.0, busy_s=0.05, device_ops=40, dense=dense)


def test_dense_roofline_mean_bound_over_mean_time():
    run = run_of()
    run.traces = {"b0": _trace(launches=10, bound_s=10e-6,
                               trace_launches=11, trace_s=88e-6)}
    # 1 us of bound a launch over 8 us a launch
    assert dense_roofline.read(run) == pytest.approx(12.5)


def test_dense_roofline_without_profiled_launches_reads_nothing():
    run = run_of()
    run.traces = {"b0": _trace(launches=10, bound_s=10e-6,
                               trace_launches=0, trace_s=0.0)}
    assert dense_roofline.read(run) is None


def test_dense_roofline_without_launches_reads_nothing():
    run = run_of()
    run.traces = {"b0": _trace(launches=0, bound_s=0.0,
                               trace_launches=0, trace_s=0.0)}
    assert dense_roofline.read(run) is None


def test_device_idle_share():
    run = run_of(device_busy_s=lambda: 0.05, trace_window_s=lambda: 10.0)
    assert device_idle_pct.read(run) == pytest.approx(99.5)


def test_device_idle_without_a_source_reads_nothing():
    run = run_of(device_busy_s=lambda: None, trace_window_s=lambda: 10.0)
    assert device_idle_pct.read(run) is None


def test_union_and_gaps():
    from cdnbench.broker_launch import summarize, union_length
    busy, gaps = union_length([(0, 10, "a"), (5, 20, "b"), (30, 40, "c")])
    assert busy == pytest.approx(30e-6)
    assert gaps == [(10e-6, "b")]
    events = [dict(ph="X", cat="kernel", ts=0, dur=4,
                   name="void delivery_matrix_kernel<8>(Args)"),
              dict(ph="X", cat="gpu_memcpy", ts=10, dur=2, name="Memcpy HtoD"),
              dict(ph="X", cat="cuda_runtime", ts=0, dur=50, name="launch")]
    s = summarize(events, 1.0, {"launches": 1})
    assert s["busy_s"] == pytest.approx(6e-6)
    assert s["dense"]["trace_launches"] == 1
    assert s["dense"]["trace_s"] == pytest.approx(4e-6)


@pytest.mark.parametrize("family,q", [("delivery_latency_p50_ms", 0.50),
                                      ("delivery_latency_p99_ms", 0.99)])
def test_delivery_latency_reads_the_runs_latencies(family, q):
    import importlib
    import numpy as np
    from cdnbench.common import percentile
    reader = importlib.import_module(f"cdnbench.layers.{family}")
    lat = np.arange(1.0, 1001.0)
    run = SimpleNamespace(latencies_ms=lambda: lat)
    assert reader.read(run) == percentile(lat, q)
    assert reader.read(SimpleNamespace(
        latencies_ms=lambda: np.empty(0))) is None
