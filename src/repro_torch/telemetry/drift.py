"""Plan-drift monitoring: is the installed CommProfile still telling the
truth?

The counterpart of ``repro.telemetry.drift`` (a copy: the port imports
nothing of the JAX package). A :class:`DriftMonitor` accumulates
``meas_over_est`` residuals per ``(flow, stage, domain)`` key -- the same
key shape the profile's fitted models use -- from live executions, and
raises exactly one structured :class:`ProfileStalenessWarning` per key
(naming the offending key, the rolling median, the band, and the retune
recipe) when the rolling median leaves a configurable band.

Residual sources:

* :meth:`DriftMonitor.observe_event` -- a live
  :class:`~repro_torch.core.comm.CommEvent` whose ``seconds`` estimate was
  priced by the installed profile, paired with a measured wall time;
* :meth:`DriftMonitor.observe_plan` -- a whole
  :class:`~repro_torch.core.planner.ProgramPlan` against the measured wall time
  of one execution (the serving engine feeds this each step): the shared
  ``wall / plan.seconds`` ratio is filed under every op's key;
* :meth:`DriftMonitor.observe` -- a raw (key, measured, estimated) pair.

By default only ``est_source == "measured"`` estimates are monitored
(``require_measured=True``): an analytic estimate going stale is not a
*profile* problem, and the analytic constants are deliberately loose.

The module also owns the canonical drift band so other consumers
(``launch/dryrun.comm_drift``) share one definition of "suspiciously far
from the estimate" instead of re-inventing thresholds.
"""
from __future__ import annotations

import collections
import contextlib
import statistics
import warnings

from repro_torch.telemetry import metrics as _metrics

# meas_over_est band: below 0.5 the profile over-prices (or the payload
# accounting under-counts); above 2.0 it under-prices.  Half/double is the
# historical dryrun byte-underrun threshold, now shared.
DEFAULT_BAND = (0.5, 2.0)


def outside_band(ratio: float, band=DEFAULT_BAND) -> bool:
    return ratio < band[0] or ratio > band[1]


def underrun(ratio: float, band=DEFAULT_BAND) -> bool:
    """The low edge only -- dryrun's historical byte-underrun check."""
    return ratio < band[0]


def _retune_recipe() -> str:
    return ("measure a new profile on the card (the port prices no "
            "estimate until its tuner measures one)")


class ProfileStalenessWarning(UserWarning):
    """Structured staleness signal: the rolling meas_over_est median for
    one (flow, stage, domain) key left the drift band."""

    def __init__(self, flow: str, stage: str, domain: str,
                 median: float, band: tuple, n: int):
        self.flow, self.stage, self.domain = flow, stage, domain
        self.median, self.band, self.n = median, band, n
        self.recipe = _retune_recipe()
        super().__init__(
            f"CommProfile looks stale for ({flow}, {stage}, {domain}): "
            f"rolling median meas_over_est={median:.3g} over {n} samples "
            f"is outside [{band[0]:g}, {band[1]:g}]; {self.recipe}")


class DriftMonitor:
    """Accumulates meas_over_est residuals and warns once per stale key.

    Parameters
    ----------
    band:
        ``(lo, hi)`` acceptance band for the rolling median.
    window:
        Residuals retained per key (rolling deque).
    min_samples:
        Median is not judged before a key has this many residuals.
    require_measured:
        Only monitor estimates priced by an installed profile
        (``est_source == "measured"``).  Set False to track analytic
        estimates too (unit tests, exploratory runs).
    """

    def __init__(self, *, band=DEFAULT_BAND, window: int = 64,
                 min_samples: int = 8, require_measured: bool = True):
        self.band = (float(band[0]), float(band[1]))
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.require_measured = bool(require_measured)
        self.residuals: dict[tuple, collections.deque] = {}
        self.warned: set[tuple] = set()

    # ------------------------------------------------------------ feeding
    def observe(self, flow: str, stage: str, domain: str,
                measured_s: float, estimated_s: float) -> None:
        if estimated_s <= 0.0 or measured_s < 0.0:
            return
        key = (flow, stage, domain)
        dq = self.residuals.get(key)
        if dq is None:
            dq = self.residuals[key] = collections.deque(maxlen=self.window)
        dq.append(measured_s / estimated_s)
        _metrics.inc("drift.observations")
        self._judge(key, dq)

    def observe_event(self, event, measured_s: float) -> None:
        """A live CommEvent paired with its measured wall seconds."""
        if self.require_measured and event.est_source != "measured":
            return
        domain = "dcn" if event.dcn_bytes > 0 else "ici"
        self.observe(event.flow, event.stage, domain,
                     measured_s, event.seconds)

    def observe_plan(self, plan, measured_s: float) -> None:
        """A whole ProgramPlan against one measured execution: the shared
        wall/plan ratio is filed under every op's (flow, stage, domain)."""
        if self.require_measured and plan.est_source != "measured":
            return
        # the port's plans leave ``seconds`` unset until a measured profile
        # prices them: nothing to compare against
        if plan.seconds is None or plan.seconds <= 0.0:
            return
        ratio = measured_s / plan.seconds
        for est in plan.estimates.values():
            key = (est.algorithm, est.stage, est.dominant())
            dq = self.residuals.get(key)
            if dq is None:
                dq = self.residuals[key] = \
                    collections.deque(maxlen=self.window)
            dq.append(ratio)
            _metrics.inc("drift.observations")
            self._judge(key, dq)

    # ------------------------------------------------------------ judging
    def _judge(self, key: tuple, dq: collections.deque) -> None:
        if key in self.warned or len(dq) < self.min_samples:
            return
        med = statistics.median(dq)
        if outside_band(med, self.band):
            self.warned.add(key)
            _metrics.inc("drift.stale_keys")
            warnings.warn(ProfileStalenessWarning(
                key[0], key[1], key[2], med, self.band, len(dq)),
                stacklevel=3)

    # ------------------------------------------------------------ reading
    def medians(self) -> dict:
        return {k: statistics.median(dq)
                for k, dq in sorted(self.residuals.items()) if dq}

    def stale(self) -> list:
        return sorted(self.warned)

    def summary(self) -> dict:
        """JSON-friendly snapshot (keys joined as flow/stage/domain)."""
        return {
            "band": list(self.band),
            "medians": {"/".join(k): round(v, 6)
                        for k, v in self.medians().items()},
            "samples": {"/".join(k): len(dq)
                        for k, dq in sorted(self.residuals.items())},
            "stale": ["/".join(k) for k in self.stale()],
        }


# ------------------------------------------------------ installed monitor
_MONITORS: list[DriftMonitor] = []


def active_monitor() -> DriftMonitor | None:
    return _MONITORS[-1] if _MONITORS else None


@contextlib.contextmanager
def install_monitor(monitor: DriftMonitor):
    """Make ``monitor`` the active drift monitor for the scope; live
    executions (serving engine steps) feed it automatically."""
    _MONITORS.append(monitor)
    try:
        yield monitor
    finally:
        _MONITORS.remove(monitor)


__all__ = [
    "DEFAULT_BAND", "DriftMonitor", "ProfileStalenessWarning",
    "active_monitor", "install_monitor", "outside_band", "underrun",
]
