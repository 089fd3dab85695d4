"""The port's forwarding bench (``testing.routebench.forward_rate``) held
against the JAX package's at a small size: each row delivers every frame
to every receiver on both packages, through the path its ``impl`` names,
and a ``native`` row without the library is None, never a mislabelled
scalar row."""

import asyncio
import importlib

import pytest

from _torch_libs import jax_routeplan_available
from pushcdn_tpu_torch.native import routeplan as port_routeplan

pytestmark = pytest.mark.skipif(
    not (jax_routeplan_available() and port_routeplan.available()),
    reason="native route-plan library unavailable (no working g++)")

ROOTS = {"jax": "pushcdn_tpu", "port": "pushcdn_tpu_torch"}
SMALL = dict(receivers=3, msgs=128, trials=2, payload=64, batch=32)
PATHS = ("cutthrough", "residual", "scalar")


def _paths(root: str) -> dict:
    metrics = importlib.import_module(f"{root}.proto.metrics")
    return {p: metrics.ROUTE_FRAMES.labels(path=p).value for p in PATHS}


def _row(name: str, impl: str, **kw) -> tuple:
    """One forward_rate row and the frames it routed per path."""
    root = ROOTS[name]
    bench = importlib.import_module(f"{root}.testing.routebench")
    before = _paths(root)
    out = asyncio.run(bench.forward_rate(impl, **SMALL, **kw))
    after = _paths(root)
    return out, {p: after[p] - before[p] for p in PATHS}


@pytest.mark.parametrize("impl", ["native", "python"])
def test_forward_rate_delivers_as_jax(impl):
    rows = {name: _row(name, impl) for name in ROOTS}
    sent = SMALL["msgs"] * SMALL["trials"]
    for name, (out, paths) in rows.items():
        assert out["msgs"] == SMALL["msgs"] and len(out["trials"]) == 2
        assert out["receivers"] == SMALL["receivers"]
        assert out["delivered"] == out["median"] * SMALL["receivers"] > 0
        if impl == "native":
            assert paths["scalar"] == 0, (name, paths)
            assert paths["cutthrough"] + paths["residual"] == sent, \
                (name, paths)
        else:
            assert paths["cutthrough"] == paths["residual"] == 0
            assert paths["scalar"] == sent, (name, paths)


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "rebuild"])
def test_forward_rate_under_churn(incremental):
    """The churn row: a parked herd enlarges the table, a churner floods
    Subscribe / Unsubscribe, and the route state's summary says which
    maintenance ran."""
    out, _paths_ = _row("port", "native", parked_users=64, churn=True,
                        incremental=incremental)
    assert out["churn_ops"] > 0 and out["churn_ops_s"] > 0
    summary = out["route_summary"]
    assert summary["incremental"] is incremental
    assert summary["snapshot_users"] >= 64 + SMALL["receivers"]
    if incremental:
        assert summary["deltas_applied"] > 0
    else:
        assert summary["rebuilds"].get("incremental_disabled", 0) > 0


def test_native_row_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(port_routeplan, "_lib", None)
    monkeypatch.setattr(port_routeplan, "_tried", True)
    bench = importlib.import_module("pushcdn_tpu_torch.testing.routebench")
    assert asyncio.run(bench.forward_rate("native", **SMALL)) is None
    # auto still measures, on the scalar loops it then takes
    before = _paths("pushcdn_tpu_torch")
    out = asyncio.run(bench.forward_rate("auto", **SMALL))
    after = _paths("pushcdn_tpu_torch")
    assert out["msgs"] == SMALL["msgs"]
    assert after["cutthrough"] == before["cutthrough"]
    assert after["scalar"] - before["scalar"] == \
        SMALL["msgs"] * SMALL["trials"]
