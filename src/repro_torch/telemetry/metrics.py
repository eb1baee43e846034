"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The counterpart of ``repro.telemetry.metrics``, copied.  Zero-dependency
(stdlib only -- no torch, no numpy) so every layer of the stack can import
it unconditionally.  Two usage modes:

module-level instrumentation (default OFF)
    Hot paths call the module helpers (:func:`inc`, :func:`observe`,
    :func:`set_gauge`); each is a single ``if not _ENABLED: return`` branch
    when telemetry is off.  :func:`enable` /
    :func:`disable` flip the switch; the helpers write to the *active*
    registry -- the process-wide :data:`REGISTRY` unless a
    :func:`scoped_metrics` scope pushed a fresh one (dryrun records a
    per-cell snapshot this way without polluting the global registry).

owned registries (always on)
    Long-lived components that already do equivalent bookkeeping
    (``serving.ServeEngine``) hold their own :class:`MetricsRegistry` and
    talk to instruments directly; the enabled flag does not apply.

Exports are deterministic: :meth:`MetricsRegistry.to_jsonl` (one sorted
JSON object per line) and :meth:`MetricsRegistry.to_prometheus` (text
exposition format) emit byte-identical output for equal registry state.

Histograms are fixed-bucket (cumulative ``le`` counts) but additionally
retain up to ``keep_samples`` raw observations so
:meth:`Histogram.quantile` can answer exact percentiles for bounded runs
(the serving bench's p50/p99 cells); past the cap it falls back to bucket
upper-bound interpolation.

Every name the port's instrumentation uses is declared in
:data:`DECLARED` (the JAX package's names for the same layers).
"""
from __future__ import annotations

import contextlib
import json
import math
import threading

# Default histogram buckets: exponential sweep over seconds, microsecond
# resolution at the bottom (collective estimates) to minutes at the top
# (whole train steps on the CPU substrate).
DEFAULT_BUCKETS = tuple(10.0 ** e for e in range(-7, 3))

# name -> (kind, help).  The single source of truth for the docs table and
# the meta-test; instrumentation sites must use declared names.
DECLARED: dict[str, tuple[str, str]] = {
    # core/comm.py -- one increment per executed (non-recorded) dispatch
    "comm.dispatches": ("counter", "Collective dispatches executed (eager "
                        "or program-replayed; recorded ops excluded)"),
    "comm.est_source.analytic": ("counter", "Dispatches priced by the "
                                 "analytic constants"),
    "comm.est_source.measured": ("counter", "Dispatches priced by an "
                                 "installed measured CommProfile"),
    # core/program.py -- lower-cache traffic and rewrite-pass yield
    "program.lowered": ("counter", "CommPrograms lowered from scratch "
                        "(lower-cache misses)"),
    "program.lower_cache_hits": ("counter", "CommProgram lowerings served "
                                 "by the structural-fingerprint cache"),
    "program.fused_ops": ("counter", "Lowered ops produced by rs+ag fusion "
                          "or the all_reduce split rewrite"),
    "program.coalesced_ops": ("counter", "Lowered ops produced by "
                              "same-group small-message coalescing"),
    "program.chained_ops": ("counter", "Lowered ops produced by the "
                            "multi-dim all_to_all merge"),
    # core/planner.py -- joint-plan pricing
    "planner.plan_program_calls": ("counter", "plan_program invocations"),
    "planner.plan_seconds_us": ("histogram", "Jointly-planned program "
                                "seconds (overlap-priced budget), in us"),
    "planner.serial_seconds_us": ("histogram", "Serial (sum of per-op "
                                  "estimates) program seconds, in us"),
    "planner.est_source.analytic": ("counter", "Program plans priced "
                                    "entirely by analytic constants"),
    "planner.est_source.mixed": ("counter", "Program plans with partial "
                                 "measured coverage"),
    "planner.est_source.measured": ("counter", "Program plans priced "
                                    "entirely from measured models"),
    # runtime/trainer.py -- step loop (split phases only under
    # TrainConfig.telemetry_split)
    "train.steps": ("counter", "Optimizer steps completed"),
    "train.step_seconds": ("histogram", "Wall seconds per train step"),
    "train.straggler_steps": ("counter", "Steps exceeding the straggler "
                              "deadline"),
    "train.fwd_seconds": ("histogram", "Wall seconds of the forward pass "
                          "(telemetry_split mode; timed separately)"),
    "train.fwd_bwd_seconds": ("histogram", "Wall seconds of the fused "
                              "forward+backward phase (telemetry_split "
                              "mode; bwd alone is fwd_bwd minus fwd)"),
    "train.sync_seconds": ("histogram", "Wall seconds of the gradient-sync "
                           "phase (telemetry_split mode)"),
    "train.opt_seconds": ("histogram", "Wall seconds of the clip+AdamW "
                          "phase (telemetry_split mode)"),
    "train.sync_serial_est_us": ("gauge", "Planner estimate of the step's "
                                 "grad-sync wire time, all on the critical "
                                 "path (us; from the traced first step)"),
    "train.sync_exposed_est_us": ("gauge", "Planner estimate of the "
                                  "*exposed* grad-sync wire time under "
                                  "the overlap model: only the final "
                                  "bucket cannot hide under backward (us)"),
    # serving/engine.py -- per-engine registry (always on)
    "serve.steps": ("counter", "Engine decode steps"),
    "serve.generated_tokens": ("counter", "Generated (post-prefill) "
                               "tokens"),
    "serve.step_seconds": ("histogram", "Wall seconds per engine step"),
    "serve.token_seconds": ("histogram", "Per-token latency: the wall "
                            "seconds of the step that produced each "
                            "generated token"),
    "serve.tokens_per_s": ("gauge", "Aggregate decode throughput of the "
                           "last run() (tokens / wall second)"),
    "serve.admitted": ("counter", "Requests admitted into batch lanes "
                       "(re-admissions after preemption included)"),
    "serve.evicted": ("counter", "Finished requests evicted from lanes"),
    "serve.preempted": ("counter", "Preemptions (lazy admission: a dry "
                        "shard swapped out the youngest holder)"),
    "serve.page_occupancy": ("gauge", "Fraction of KV-cache pages in use "
                             "across all shard pools after this step's "
                             "allocation"),
    "serve.lower_cache_hit_ratio": ("gauge", "Cumulative hit ratio of the "
                                    "per-step program's lower-cache "
                                    "lookups"),
    # checkpoint/manager.py -- elastic checkpoint subsystem
    "ckpt.saves": ("counter", "Checkpoint saves dispatched"),
    "ckpt.restores": ("counter", "Checkpoint restores completed "
                      "(params-only restores included)"),
    "ckpt.save_seconds": ("histogram", "Wall seconds from save() dispatch "
                          "to the atomic rename (gather + write; runs on "
                          "the background executor when async)"),
    "ckpt.restore_seconds": ("histogram", "Wall seconds per restore: host "
                             "load plus program-scattered placement"),
    "ckpt.saved_bytes": ("gauge", "Host bytes gathered and written by the "
                         "last durable save"),
    "ckpt.restored_bytes": ("gauge", "Host bytes loaded and placed by the "
                            "last restore"),
    "ckpt.write_errors": ("counter", "Background save failures captured "
                          "for re-raise at wait()/next save()"),
    # telemetry/drift.py
    "drift.observations": ("counter", "meas_over_est residuals recorded by "
                           "the installed drift monitor"),
    "drift.stale_keys": ("counter", "(flow, stage, domain) keys whose "
                         "rolling median left the drift band"),
}


class Counter:
    """Monotonic counter."""

    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value."""

    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed cumulative buckets plus a bounded raw-sample reservoir.

    ``quantile`` is exact (sorted-sample index ``min(n-1, ceil(q*n)-1)``,
    matching the serving engine's historical percentile formula) while the
    reservoir holds every observation; once ``keep_samples`` is exceeded it
    degrades to bucket upper-bound interpolation.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "bucket_counts", "count", "sum",
                 "keep_samples", "samples")

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS,
                 keep_samples: int = 65536):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf last
        self.count = 0
        self.sum = 0.0
        self.keep_samples = keep_samples
        self.samples: list[float] = []

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.bucket_counts[i] += 1
                break
        else:
            self.bucket_counts[-1] += 1
        if len(self.samples) < self.keep_samples:
            self.samples.append(v)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if self.count <= len(self.samples):
            lat = sorted(self.samples)
            n = len(lat)
            return lat[min(n - 1, int(math.ceil(q * n)) - 1)]
        # truncated reservoir: cumulative-bucket upper bound
        target = int(math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            seen += c
            if seen >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else self.buckets[-1])
        return self.buckets[-1]

    def snapshot(self) -> dict:
        cum, out = 0, {}
        for le, c in zip(self.buckets, self.bucket_counts):
            cum += c
            out[f"{le:g}"] = cum
        out["+Inf"] = self.count
        return {"type": "histogram", "count": self.count,
                "sum": self.sum, "buckets": out}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """A named collection of instruments with deterministic exports."""

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------ get-or-create
    def _get(self, name: str, kind: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    decl = DECLARED.get(name)
                    if decl is not None and decl[0] != kind:
                        raise TypeError(
                            f"metric {name!r} is declared as {decl[0]}, "
                            f"requested as {kind}")
                    help = decl[1] if decl else ""
                    inst = _KINDS[kind](name, help, **kw)
                    self._instruments[name] = inst
        if inst.kind != kind:
            raise TypeError(f"metric {name!r} is a {inst.kind}, "
                            f"not a {kind}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str, *, buckets: tuple = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(name, "histogram", buckets=buckets)

    def get(self, name: str):
        """The instrument, or None when it was never touched."""
        return self._instruments.get(name)

    # ------------------------------------------------------- conveniences
    def value(self, name: str) -> float:
        inst = self._instruments.get(name)
        return float(inst.value) if inst is not None else 0.0

    def quantile(self, name: str, q: float) -> float:
        inst = self._instruments.get(name)
        return inst.quantile(q) if inst is not None else 0.0

    def reset(self) -> None:
        self._instruments.clear()

    # ------------------------------------------------------------ exports
    def snapshot(self) -> dict:
        """name -> snapshot dict, sorted by name (deterministic)."""
        return {name: self._instruments[name].snapshot()
                for name in sorted(self._instruments)}

    def to_jsonl(self) -> str:
        """One sorted-key JSON object per metric, one per line."""
        lines = []
        for name, snap in self.snapshot().items():
            lines.append(json.dumps(dict(snap, name=name), sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_prometheus(self, *, prefix: str = "repro_") -> str:
        """Prometheus text exposition format (0.0.4)."""
        out = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            pname = prefix + name.replace(".", "_").replace("-", "_")
            if inst.help:
                out.append(f"# HELP {pname} {inst.help}")
            out.append(f"# TYPE {pname} {inst.kind}")
            if inst.kind in ("counter", "gauge"):
                out.append(f"{pname} {_fmt(inst.value)}")
            else:
                cum = 0
                for le, c in zip(inst.buckets, inst.bucket_counts):
                    cum += c
                    out.append(f'{pname}_bucket{{le="{le:g}"}} {cum}')
                out.append(f'{pname}_bucket{{le="+Inf"}} {inst.count}')
                out.append(f"{pname}_sum {_fmt(inst.sum)}")
                out.append(f"{pname}_count {inst.count}")
        return "\n".join(out) + ("\n" if out else "")


def _fmt(v: float) -> str:
    return f"{v:.10g}"


# -------------------------------------------- process-wide default registry
REGISTRY = MetricsRegistry()

_ENABLED = False
_SCOPED: list[MetricsRegistry] = []


def enable() -> None:
    """Turn the module-level instrumentation helpers on."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def active_registry() -> MetricsRegistry:
    """The registry the module helpers write to: the innermost
    :func:`scoped_metrics` registry, else the process-wide one."""
    return _SCOPED[-1] if _SCOPED else REGISTRY


@contextlib.contextmanager
def scoped_metrics():
    """Enable telemetry into a fresh registry for the scope's duration;
    yields the registry (snapshot it on the way out).  Nests; restores the
    previous enabled state on exit."""
    global _ENABLED
    reg = MetricsRegistry()
    _SCOPED.append(reg)
    was = _ENABLED
    _ENABLED = True
    try:
        yield reg
    finally:
        _ENABLED = was
        _SCOPED.remove(reg)


def inc(name: str, value: float = 1.0) -> None:
    if not _ENABLED:
        return
    active_registry().counter(name).inc(value)


def observe(name: str, value: float) -> None:
    if not _ENABLED:
        return
    active_registry().histogram(name).observe(value)


def set_gauge(name: str, value: float) -> None:
    if not _ENABLED:
        return
    active_registry().gauge(name).set(value)


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DECLARED", "DEFAULT_BUCKETS", "active_registry", "disable", "enable",
    "enabled", "inc", "observe", "scoped_metrics", "set_gauge",
]
