"""The port's telemetry copy (``repro_torch.telemetry``) held against the
JAX package's ``repro.telemetry`` on the same inputs: registry quantiles and
exports, span nesting with live CommEvents from the port's dispatches, the
drift monitor's band, and ``observe_plan`` skipping a plan whose ``seconds``
the port leaves unset."""
import json
import warnings

import numpy as np
import pytest
import torch

from repro import telemetry as jax_telemetry
from repro.telemetry import metrics as jax_metrics

from repro_torch import telemetry
from repro_torch.core import planner
from repro_torch.core.hypercube import Hypercube
from repro_torch.telemetry import drift as drift_mod
from repro_torch.telemetry import metrics


class FakeClock:
    """Deterministic monotonic clock: +100us per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-4
        return self.t


@pytest.fixture(autouse=True)
def _reset_port_registry():
    yield
    metrics.disable()
    metrics.REGISTRY.reset()


@pytest.mark.parametrize("n,keep", [(1, 65536), (257, 65536), (300, 64)])
def test_registry_quantiles_match_jax(n, keep):
    """Exact quantiles while the reservoir holds every sample, bucket
    upper bounds past it: equal to the JAX registry's on the same samples;
    the exports are byte-equal too."""
    rng = np.random.RandomState(n)
    samples = np.exp(rng.randn(n) * 3 - 6)
    ours, ref = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    for reg in (ours, ref):
        h = reg._get("serve.token_seconds", "histogram",
                     buckets=metrics.DEFAULT_BUCKETS, keep_samples=keep)
        for v in samples:
            h.observe(float(v))
        reg.counter("serve.steps").inc(n)
        reg.gauge("serve.page_occupancy").set(0.25)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile("serve.token_seconds", q) == \
            ref.quantile("serve.token_seconds", q), q
    assert ours.to_jsonl() == ref.to_jsonl()
    assert ours.to_prometheus() == ref.to_prometheus()
    assert ours.snapshot() == ref.snapshot()


def test_declared_names_are_the_references():
    """Every metric the port declares is the JAX package's, same kind."""
    for name, (kind, _) in metrics.DECLARED.items():
        assert jax_metrics.DECLARED[name][0] == kind, name
    for prefix in ("serve.", "program.", "comm.", "planner.", "drift."):
        assert any(n.startswith(prefix) for n in metrics.DECLARED), prefix
    reg = metrics.MetricsRegistry()
    with pytest.raises(TypeError, match="declared as counter"):
        reg.gauge("serve.steps")


def test_module_helpers_default_off_and_scoped():
    metrics.inc("serve.steps")
    assert metrics.REGISTRY.snapshot() == {}
    with metrics.scoped_metrics() as outer:
        metrics.inc("serve.steps", 2)
        with metrics.scoped_metrics() as inner:
            metrics.observe("serve.step_seconds", 0.5)
        metrics.set_gauge("serve.page_occupancy", 0.5)
    assert not metrics.enabled()
    assert outer.value("serve.steps") == 2
    assert inner.quantile("serve.step_seconds", 0.5) == 0.5
    assert outer.get("serve.step_seconds") is None
    assert metrics.REGISTRY.snapshot() == {}


def test_spans_nest_and_ingest_port_comm_events():
    """Nested spans export in nesting order; a dispatch inside a span lands
    as a child ``comm:`` span carrying provenance, 0 us long (the port's
    estimates carry no seconds). The export is byte-deterministic."""
    cube = Hypercube.build({"d": 8})
    comm = cube.comm("1")
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    outs = []
    for _ in range(2):
        with telemetry.Tracer(clock=FakeClock()) as tr:
            with tr.span("step", cat="wall", step=0):
                with telemetry.maybe_span("inner", cat="trace"):
                    comm.all_reduce(x)
                telemetry.maybe_instant("mark", k=1)
        outs.append(tr.chrome_trace_json())
    assert outs[0] == outs[1]
    evs = json.loads(outs[0])["traceEvents"]
    names = [e["name"] for e in evs]
    assert names == ["step", "inner", "comm:all_reduce", "mark"]
    by = {e["name"]: e for e in evs}
    assert by["comm:all_reduce"]["dur"] == 0.0
    assert by["comm:all_reduce"]["args"]["flow"] == "im"
    assert by["step"]["dur"] > by["inner"]["dur"] > 0
    assert by["mark"]["ph"] == "i"
    text = tr.timeline()
    assert text.splitlines()[0].startswith("step [wall]")
    assert "  inner [trace]" in text and "    comm:all_reduce" in text
    # outside a tracer the helpers are no-ops and the comm stack is clean
    from repro_torch.core import comm as comm_mod
    assert tr not in comm_mod._TRACES
    with telemetry.maybe_span("nothing") as h:
        assert h is None


def test_observe_plan_skips_unpriced_plans():
    """The port's plans leave ``seconds`` unset: the monitor files nothing
    (and raises nothing) for one, even when tracking analytic plans."""
    cube = Hypercube.build({"d": 8})
    plan = planner.plan_program(cube, [planner.ProgramOpSpec(
        0, "broadcast", ("d",), 64.0)])
    assert plan.seconds is None
    mon = drift_mod.DriftMonitor(require_measured=False, min_samples=1)
    with drift_mod.install_monitor(mon) as m:
        assert drift_mod.active_monitor() is m
        m.observe_plan(plan, 1e-3)
    assert mon.residuals == {} and drift_mod.active_monitor() is None
    priced = planner.ProgramPlan(plan.estimates, plan.order, plan.levels,
                                 plan.ici_bytes, plan.dcn_bytes,
                                 seconds=1e-3)
    mon.observe_plan(priced, 2e-3)
    assert mon.medians() == {("direct", "naive", "ici"): 2.0}


def test_drift_monitor_matches_jax_band():
    """Same residual stream, same medians and the same single staleness
    warning per key as the JAX monitor."""
    rng = np.random.RandomState(0)
    stream = [("direct", "im", "ici", float(m), 1e-3)
              for m in rng.uniform(3e-3, 5e-3, 12)]
    results = []
    for mod in (drift_mod, jax_telemetry.drift):
        mon = mod.DriftMonitor(require_measured=False, min_samples=8)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for key in stream:
                mon.observe(*key)
        results.append((mon.medians(), mon.stale(), len(w),
                        mon.summary()["samples"]))
    assert results[0] == results[1]
    assert results[0][2] == 1 and results[0][1] == [("direct", "im", "ici")]
