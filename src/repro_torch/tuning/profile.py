"""Measured communication cost profiles: the tuning subsystem's data model.

The counterpart of ``repro.tuning.profile``, numpy and stdlib only (the
fingerprint asks torch, when it is taken, for its version and the device's
name). The port's planner carries no time constants: a candidate flow gets a time only
from a profile measured on the card this module describes.

  samples
      raw microbenchmark observations (one per (primitive, flow, size)
      cell), produced by :mod:`repro_torch.tuning.microbench` through the
      real ``Communicator`` dispatch.

  alpha-beta models
      per-(flow, stage, ICI/DCN-domain) latency/bandwidth fits:
      ``seconds ~= alpha + beta * bytes`` per domain, least-squares over the
      samples of that (flow, stage). The byte counts stay structural
      (properties of the flow, not of the hardware); only the time-per-byte
      and fixed-latency terms are fitted.

  overlap factors
      program-level measurements: ordered domain-pair serialization
      factors fitted from :func:`repro_torch.tuning.microbench.overlap_sweep`
      observations. ``factor("ici", "dcn")`` answers "when an ICI-dominant
      op is dispatched immediately before a DCN-dominant one, what fraction
      of the smaller op's time is *not* hidden?" -- 0.0 is perfect overlap,
      1.0 fully serial. ``planner.plan_program`` prices its interleaving
      order from these factors when the profile covers them.

  CommProfile
      a versioned, JSON-persistable bundle of fingerprint + samples +
      models (+ overlap). The topology fingerprint (PE count, hypercube
      shape, pod split, the torch version and the device's name) keys the
      profile: loading it against another topology, another runtime or
      another card is refused with a retune recipe, and profiles of the
      same fingerprint merge (union of samples, refit) so partial sweeps
      accumulate. The JSON layout is the reference's schema 2 (a schema-1
      file migrates in place), so a profile the reference wrote parses
      here, and is refused by its fingerprint.

A profile is consumed by :func:`repro_torch.core.planner.install_profile`
or the ``profile=`` arguments of ``plan``/``estimate``/``plan_program``:
when a model covers a candidate's (flow, stage, domains), the candidate is
priced from the fit and carries ``est_source="measured"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Mapping, Sequence

import numpy as np

# Bump whenever the JSON layout changes incompatibly; load() rejects newer
# versions with a retune recipe rather than mis-reading them.  Older
# versions with a defined migration load in place: v1 (pre-overlap) files
# are valid v2 profiles with an empty overlap section.
SCHEMA_VERSION = 2
_MIGRATABLE_VERSIONS = (1, 2)

# A fit is trusted ("confident") when it has at least this many samples and
# explains at least this fraction of the variance; below either bound the
# Tuner falls back to exhaustive measurement.
MIN_SAMPLES = 3
MIN_R2 = 0.5

RETUNE_RECIPE = ("regenerate it with "
                 "`repro_torch.tuning.Tuner(cache_dir).tune(cube)` on this "
                 "card")


def device_name(device) -> str:
    """The name a fingerprint records for ``device``: the card's own name
    on CUDA, the device type elsewhere."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def topology_fingerprint(cube, device="cuda") -> dict:
    """The identity a profile is valid for: measurements transfer across
    runs only when the substrate (PE count, hypercube shape, pod split),
    the torch runtime and the device are the same."""
    import torch
    fast = [d for d in cube.dim_names if d not in cube.dcn_dims]
    pod_split = int(np.prod([cube.size(d) for d in fast])) if fast else 1
    return {
        "ndev": int(cube.ndev),
        "dims": {n: int(s) for n, s in zip(cube.dim_names, cube.dim_sizes)},
        "dcn_dims": list(cube.dcn_dims),
        "pod_split": pod_split,
        "torch": torch.__version__,
        "device": device_name(device),
    }


def fingerprint_key(fingerprint: Mapping) -> str:
    """Stable short hash of a fingerprint -- used for cache file names."""
    blob = json.dumps(fingerprint, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class MeasuredSample:
    """One microbenchmark observation."""
    primitive: str
    algorithm: str          # planner candidate name (naive/direct/...)
    stage: str              # Table II stage of the executed flow
    bitmap: str             # dim selection measured
    nbytes: int             # per-device payload
    ici_bytes: float        # analytic per-device bytes of the flow
    dcn_bytes: float
    seconds: float          # measured median wall time

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Mapping) -> "MeasuredSample":
        return MeasuredSample(**d)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One fitted alpha-beta term: ``seconds = alpha + beta * bytes`` over
    one domain (ici or dcn) of one (flow, stage)."""
    alpha: float            # seconds (fixed latency)
    beta: float             # seconds per byte (inverse bandwidth)
    n: int                  # samples behind the fit
    r2: float               # goodness of the joint (flow, stage) fit

    def seconds(self, nbytes: float) -> float:
        return self.alpha + self.beta * nbytes

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Mapping) -> "LinkModel":
        return LinkModel(**d)


@dataclasses.dataclass(frozen=True)
class OverlapSample:
    """One program-level overlap observation: op A dispatched immediately
    before op B inside one compiled schedule, against each op timed alone.

    ``dom_a``/``dom_b`` are the analytic dominant domains ("ici"/"dcn") of
    the two flows -- the key the fitted factor generalizes over; the
    primitive/bitmap fields are provenance for debugging a bad fit."""
    dom_a: str
    dom_b: str
    primitive_a: str
    primitive_b: str
    bitmap_a: str
    bitmap_b: str
    nbytes: int             # per-device payload of each op
    seconds_a: float        # measured, op A alone
    seconds_b: float        # measured, op B alone
    seconds_pair: float     # measured, A-then-B in one schedule

    def factor(self) -> float:
        """Serialization fraction in [0, 1] implied by this observation:
        ``pair ~= max(a, b) + factor * min(a, b)`` -- 0 is perfect overlap
        (the smaller op hides entirely), 1 is fully serial."""
        lo = min(self.seconds_a, self.seconds_b)
        hi = max(self.seconds_a, self.seconds_b)
        if lo <= 0.0:
            return 1.0
        return float(np.clip((self.seconds_pair - hi) / lo, 0.0, 1.0))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Mapping) -> "OverlapSample":
        return OverlapSample(**d)


@dataclasses.dataclass(frozen=True)
class OverlapModel:
    """Fitted serialization factor for one *ordered* domain pair
    (``"{dom_a}->{dom_b}"``): the median of the observations' implied
    factors (median, not mean -- single-run wall times on a shared host
    have heavy-tailed noise)."""
    factor: float           # [0, 1]: 0 = perfect overlap, 1 = serial
    n: int                  # observations behind the fit

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Mapping) -> "OverlapModel":
        return OverlapModel(**d)


def overlap_key(dom_a: str, dom_b: str) -> str:
    return f"{dom_a}->{dom_b}"


def fit_overlap(samples: Sequence[OverlapSample]
                ) -> dict[str, OverlapModel]:
    """Fit one :class:`OverlapModel` per ordered domain pair present."""
    groups: dict[str, list[float]] = {}
    for s in samples:
        groups.setdefault(overlap_key(s.dom_a, s.dom_b),
                          []).append(s.factor())
    return {k: OverlapModel(factor=float(np.median(fs)), n=len(fs))
            for k, fs in sorted(groups.items())}


def _r2(y: np.ndarray, pred: np.ndarray) -> float:
    """Fit quality in [0, 1]: classic r^2, floored by relative predictive
    accuracy (1 - relative RMS error).  The floor matters for
    latency-dominated cells, where y is nearly constant: a constant-alpha
    model that predicts within noise deserves trust even though it
    explains no variance."""
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0.0 else \
        (1.0 if ss_res <= 1e-18 else 0.0)
    mean = float(np.mean(y))
    rrmse = float(np.sqrt(ss_res / len(y))) / mean if mean > 0.0 else 1.0
    return float(np.clip(max(r2, 1.0 - rrmse), 0.0, 1.0))


def _fit_group(rows: Sequence[MeasuredSample]) -> dict[str, LinkModel]:
    """Least-squares alpha-beta fit of one (flow, stage) sample group.

    Design matrix columns: intercept, ici_bytes and (when the flow moves any
    DCN traffic) dcn_bytes.  Negative coefficients -- possible on noisy or
    degenerate sweeps -- are clamped by dropping the column and refitting,
    so priced times stay monotone in payload size.
    """
    y = np.array([s.seconds for s in rows], dtype=np.float64)
    ici = np.array([s.ici_bytes for s in rows], dtype=np.float64)
    dcn = np.array([s.dcn_bytes for s in rows], dtype=np.float64)
    cols: list[tuple[str, np.ndarray]] = [("alpha", np.ones_like(y))]
    if float(ici.max(initial=0.0)) > 0.0:
        cols.append(("ici", ici))
    if float(dcn.max(initial=0.0)) > 0.0:
        cols.append(("dcn", dcn))

    while True:
        A = np.stack([c for _, c in cols], axis=1)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        bad = [i for i, c in enumerate(coef) if c < 0.0]
        if not bad or len(cols) == 1:
            break
        # drop the most negative column (never the intercept) and refit
        drop = max((i for i in bad if cols[i][0] != "alpha"),
                   key=lambda i: -coef[i], default=None)
        if drop is None:
            coef = np.clip(coef, 0.0, None)
            break
        del cols[drop]

    by_name = {name: float(c) for (name, _), c in zip(cols, coef)}
    alpha = max(by_name.get("alpha", 0.0), 0.0)
    beta_ici = max(by_name.get("ici", 0.0), 0.0)
    beta_dcn = max(by_name.get("dcn", 0.0), 0.0)
    pred = alpha + beta_ici * ici + beta_dcn * dcn
    r2 = _r2(y, pred)
    out = {"ici": LinkModel(alpha=alpha, beta=beta_ici, n=len(rows), r2=r2)}
    if float(dcn.max(initial=0.0)) > 0.0:
        out["dcn"] = LinkModel(alpha=0.0, beta=beta_dcn, n=len(rows), r2=r2)
    return out


def fit_models(samples: Sequence[MeasuredSample]
               ) -> dict[str, LinkModel]:
    """Fit every (flow, stage, domain) model present in ``samples``.

    Keys are ``"{algorithm}/{stage}/{domain}"`` -- the same key
    :meth:`CommProfile.seconds_for` resolves at pricing time."""
    groups: dict[tuple[str, str], list[MeasuredSample]] = {}
    for s in samples:
        groups.setdefault((s.algorithm, s.stage), []).append(s)
    models: dict[str, LinkModel] = {}
    for (alg, stage), rows in sorted(groups.items()):
        for domain, model in _fit_group(rows).items():
            models[f"{alg}/{stage}/{domain}"] = model
    return models


class ProfileMismatchError(ValueError):
    """A profile was loaded against the wrong schema or topology."""


class CommProfile:
    """Versioned bundle of measured samples + fitted alpha-beta models,
    keyed by a topology fingerprint.  See module docstring."""

    def __init__(self, fingerprint: Mapping,
                 samples: Sequence[MeasuredSample] = (),
                 models: Mapping[str, LinkModel] | None = None,
                 overlap_samples: Sequence[OverlapSample] = (),
                 overlap: Mapping[str, OverlapModel] | None = None):
        self.fingerprint = dict(fingerprint)
        self.samples = list(samples)
        self.models: dict[str, LinkModel] = (
            dict(models) if models is not None else fit_models(self.samples))
        self.overlap_samples = list(overlap_samples)
        self.overlap: dict[str, OverlapModel] = (
            dict(overlap) if overlap is not None
            else fit_overlap(self.overlap_samples))

    # ------------------------------------------------------------- pricing
    def seconds_for(self, algorithm: str, stage: str,
                    ici_bytes: float, dcn_bytes: float) -> float | None:
        """Measured-model price of one candidate, or None when the profile
        does not cover every domain the flow touches (the planner then
        falls back to the analytic constants for that candidate)."""
        mi = self.models.get(f"{algorithm}/{stage}/ici")
        if mi is None:
            return None
        t = mi.seconds(ici_bytes)
        if dcn_bytes > 0.0:
            md = self.models.get(f"{algorithm}/{stage}/dcn")
            if md is None:
                return None
            t += md.seconds(dcn_bytes)
        return t

    def overlap_factor(self, dom_a: str, dom_b: str) -> float | None:
        """Measured serialization factor for dispatching a ``dom_a``-
        dominant op immediately before a ``dom_b``-dominant one, or None
        when this ordered pair was never measured (the planner then falls
        back to its analytic overlap assumption for the pair)."""
        m = self.overlap.get(overlap_key(dom_a, dom_b))
        return m.factor if m is not None else None

    @property
    def has_overlap(self) -> bool:
        return bool(self.overlap)

    def token(self) -> str:
        """Content hash of the fitted models + overlap factors -- a cheap
        identity for caches (e.g. the program lower cache) that must not
        reuse a plan priced under a different profile."""
        blob = json.dumps(
            {"fp": self.fingerprint,
             "models": {k: m.to_json() for k, m in sorted(self.models.items())},
             "overlap": {k: m.to_json()
                         for k, m in sorted(self.overlap.items())}},
            sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]

    def confidence(self, algorithm: str, stage: str,
                   *, needs_dcn: bool = False) -> float:
        """[0, 1] trust in this candidate's fit: 0 when uncovered or
        under-sampled, else the fit's r^2."""
        needed = [f"{algorithm}/{stage}/ici"]
        if needs_dcn:
            needed.append(f"{algorithm}/{stage}/dcn")
        conf = 1.0
        for key in needed:
            m = self.models.get(key)
            if m is None or m.n < MIN_SAMPLES:
                return 0.0
            conf = min(conf, m.r2)
        return conf

    def is_confident(self, algorithm: str, stage: str,
                     *, needs_dcn: bool = False) -> bool:
        return self.confidence(algorithm, stage,
                               needs_dcn=needs_dcn) >= MIN_R2

    # ------------------------------------------------------------ identity
    def check_fingerprint(self, cube, device="cuda") -> None:
        """Raise unless this profile was measured on ``cube``'s topology,
        this torch and this device."""
        want = topology_fingerprint(cube, device)
        if self.fingerprint != want:
            diff = sorted(k for k in set(want) | set(self.fingerprint)
                          if want.get(k) != self.fingerprint.get(k))
            raise ProfileMismatchError(
                f"profile fingerprint mismatch on {diff}: profile was "
                f"measured on {self.fingerprint}, this substrate is {want}; "
                f"{RETUNE_RECIPE}")

    def merge(self, other: "CommProfile") -> "CommProfile":
        """Union of two partial sweeps over the *same* topology: samples
        (per-op and overlap) concatenate with exact duplicates dropped,
        models and overlap factors refit over the union."""
        if other.fingerprint != self.fingerprint:
            raise ProfileMismatchError(
                "cannot merge profiles of different topologies: "
                f"{self.fingerprint} vs {other.fingerprint}; {RETUNE_RECIPE}")

        def union(a, b):
            seen, out = set(), []
            for s in list(a) + list(b):
                key = json.dumps(s.to_json(), sort_keys=True)
                if key not in seen:
                    seen.add(key)
                    out.append(s)
            return out

        return CommProfile(
            self.fingerprint, union(self.samples, other.samples),
            overlap_samples=union(self.overlap_samples,
                                  other.overlap_samples))

    # --------------------------------------------------------- persistence
    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "fingerprint": self.fingerprint,
            "samples": [s.to_json() for s in self.samples],
            "models": {k: m.to_json()
                       for k, m in sorted(self.models.items())},
            "overlap_samples": [s.to_json() for s in self.overlap_samples],
            "overlap": {k: m.to_json()
                        for k, m in sorted(self.overlap.items())},
        }

    @staticmethod
    def from_json(data: Mapping) -> "CommProfile":
        version = data.get("schema_version")
        if version not in _MIGRATABLE_VERSIONS:
            raise ProfileMismatchError(
                f"profile schema v{version} is not readable by this build "
                f"(expects v{SCHEMA_VERSION} or a migratable "
                f"{_MIGRATABLE_VERSIONS}); {RETUNE_RECIPE}")
        # v1 -> v2 migration: pre-overlap profiles are valid v2 profiles
        # with an empty overlap section (the per-op fits carry over as-is;
        # plan_program simply keeps its analytic overlap assumption until
        # an overlap sweep lands).
        return CommProfile(
            fingerprint=data["fingerprint"],
            samples=[MeasuredSample.from_json(s) for s in data["samples"]],
            models={k: LinkModel.from_json(m)
                    for k, m in data["models"].items()},
            overlap_samples=[OverlapSample.from_json(s)
                             for s in data.get("overlap_samples", ())],
            overlap={k: OverlapModel.from_json(m)
                     for k, m in data.get("overlap", {}).items()}
            if "overlap" in data else None)

    def save(self, path: str | os.PathLike) -> str:
        """Write deterministic JSON (sorted keys, fixed layout): saving the
        same profile twice is byte-identical, so round-trips diff clean."""
        path = os.fspath(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @staticmethod
    def load(path: str | os.PathLike, *, cube=None,
             device="cuda") -> "CommProfile":
        """Load and (when ``cube`` is given) fingerprint-check a profile."""
        with open(path) as f:
            prof = CommProfile.from_json(json.load(f))
        if cube is not None:
            prof.check_fingerprint(cube, device)
        return prof

    def describe(self) -> str:
        dims = ",".join(f"{k}={v}"
                        for k, v in self.fingerprint["dims"].items())
        runtime = " ".join(f"{k}={self.fingerprint[k]}"
                           for k in ("torch", "jax", "device")
                           if k in self.fingerprint)
        return (f"CommProfile[{dims} {runtime} "
                f"samples={len(self.samples)} models={len(self.models)} "
                f"overlap={len(self.overlap)}]")


__all__ = [
    "SCHEMA_VERSION", "MIN_SAMPLES", "MIN_R2",
    "CommProfile", "LinkModel", "MeasuredSample", "OverlapModel",
    "OverlapSample", "ProfileMismatchError",
    "device_name", "fingerprint_key", "fit_models", "fit_overlap",
    "overlap_key", "topology_fingerprint",
]
