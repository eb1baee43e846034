"""Tuner front end: tune -> persist -> select, with a measurement fallback.

The counterpart of ``repro.tuning.tuner``:

  ``Tuner(cache_dir).tune(cube, sizes=...)``
      runs the :mod:`repro_torch.tuning.microbench` sweep on the device,
      fits the per-(flow, stage, domain) alpha-beta models, runs the
      overlap sweep (``overlap=True``, the default), merges into any cached
      profile of the same fingerprint (partial sweeps accumulate) and
      saves the result in the cache dir.

  ``tuner.select(primitive, nbytes, comm)``
      prices the candidate flows from the profile and returns the dispatch
      algorithm to request. When any candidate's fit is weak (uncovered,
      under-sampled or a poor r^2) it measures the candidates at the
      requested size instead, folds those samples into the cached profile
      and picks the measured winner.

  ``install(cube)``
      :func:`repro_torch.core.planner.install_profile` of the cube's
      profile, so ``algorithm="auto"`` anywhere in the scope prices from
      measurements::

          tuner = Tuner("build/tuning")
          profile = tuner.tune(cube)
          with planner.install_profile(profile):
              comm.all_reduce(x)

A tuner measures on one device (CUDA unless ``device="cpu"`` is asked
for), and its profiles carry that device's name in their fingerprint.
Cache layout: one JSON per fingerprint,
``{cache_dir}/commprofile-{fingerprint_hash}.json``.
"""
from __future__ import annotations

import os
from typing import Sequence

from repro_torch import resolve_device
from repro_torch.tuning import microbench
from repro_torch.tuning.profile import (
    CommProfile, MIN_R2, fingerprint_key, topology_fingerprint)

DEFAULT_CACHE_DIR = os.path.join("~", ".cache", "repro_torch", "tuning")

# planner candidate name -> the Communicator dispatch request executing it
_CANDIDATE_TO_DISPATCH = {
    "naive": "naive",
    "direct": "pidcomm",
    "hierarchical": "hierarchical",
    "compressed": "compressed",
}


class Tuner:
    """Measured-profile manager bound to one cache directory and one
    device."""

    def __init__(self, cache_dir: str | os.PathLike | None = None, *,
                 device=None):
        cache = cache_dir or os.environ.get("REPRO_TORCH_TUNING_CACHE") \
            or DEFAULT_CACHE_DIR
        self.cache_dir = os.path.expanduser(os.fspath(cache))
        self.device = resolve_device(device)
        self._profiles: dict[str, CommProfile] = {}   # by fingerprint hash

    # ----------------------------------------------------------- identity
    def fingerprint(self, cube) -> dict:
        return topology_fingerprint(cube, self.device)

    def profile_path(self, cube) -> str:
        key = fingerprint_key(self.fingerprint(cube))
        return os.path.join(self.cache_dir, f"commprofile-{key}.json")

    # --------------------------------------------------------------- tune
    def tune(self, cube, *,
             sizes: Sequence[int] = microbench.DEFAULT_SIZES,
             primitives: Sequence[str] | None = None,
             dims: Sequence | None = None,
             reps: int = 5, warmup: int = 2,
             overlap: bool = True,
             overlap_sizes: Sequence[int] = microbench.DEFAULT_OVERLAP_SIZES,
             save: bool = True, progress=None) -> CommProfile:
        """Sweep (over the selections ``dims``, default the reference's),
        fit, merge with any cached profile of this fingerprint, and save.
        Returns the merged profile (also kept for :meth:`select`).
        ``overlap=False`` skips the program-level domain-pair sweep."""
        samples = microbench.sweep(cube, sizes=sizes, primitives=primitives,
                                   dims=dims, reps=reps, warmup=warmup,
                                   device=self.device, progress=progress)
        overlap_samples = microbench.overlap_sweep(
            cube, sizes=overlap_sizes, reps=reps, warmup=warmup,
            device=self.device) if overlap else []
        prof = CommProfile(self.fingerprint(cube), samples,
                           overlap_samples=overlap_samples)
        existing = self._load_if_cached(cube)
        if existing is not None:
            prof = existing.merge(prof)
        if save:
            prof.save(self.profile_path(cube))
        self._profiles[fingerprint_key(prof.fingerprint)] = prof
        return prof

    def load(self, cube) -> CommProfile:
        """The cached profile of ``cube``'s fingerprint (raising
        ``FileNotFoundError`` when never tuned, ``ProfileMismatchError`` on
        schema or fingerprint drift)."""
        prof = CommProfile.load(self.profile_path(cube), cube=cube,
                                device=self.device)
        self._profiles[fingerprint_key(prof.fingerprint)] = prof
        return prof

    def _load_if_cached(self, cube) -> CommProfile | None:
        key = fingerprint_key(self.fingerprint(cube))
        if key in self._profiles:
            return self._profiles[key]
        try:
            return self.load(cube)
        except FileNotFoundError:
            return None

    def profile_for(self, cube, *, tune_if_missing: bool = False,
                    **tune_kwargs) -> CommProfile:
        """The cube's profile: kept, else loaded from the cache, else
        (opt-in) measured on the spot."""
        prof = self._load_if_cached(cube)
        if prof is None:
            if not tune_if_missing:
                raise FileNotFoundError(
                    f"no tuned profile for {cube.describe()} in "
                    f"{self.cache_dir}; run Tuner.tune(cube) first")
            prof = self.tune(cube, **tune_kwargs)
        return prof

    def install(self, cube, **kwargs):
        """``planner.install_profile`` scope of the cube's profile."""
        from repro_torch.core import planner
        return planner.install_profile(self.profile_for(cube, **kwargs))

    # ------------------------------------------------------------- select
    def select(self, primitive: str, nbytes: int, comm, *,
               op: str = "add", confidence: float = MIN_R2,
               reps: int = 3, warmup: int = 1) -> str:
        """The dispatch algorithm for one call site, from measured data.

        Prices the naive and direct candidates (and the hierarchical split
        of an additive all_reduce spanning both domains) through the
        profile; when every fit clears ``confidence`` returns the
        cheapest. Otherwise measures the candidates at exactly this size,
        merges the samples into the cached profile (so the next call is
        covered), and returns the measured winner's request."""
        from repro_torch.core import planner
        cube = comm.cube
        prof = self._load_if_cached(cube) or CommProfile(
            self.fingerprint(cube))
        algs = ["naive", "direct"]
        if primitive == "all_reduce" and op == "add" \
                and comm.fast_dims and comm.slow_dims:
            algs.append("pidcomm")      # resolves to the hierarchical split
        priced = []
        trusted = True
        for alg in algs:
            est = planner.estimate(cube, primitive, comm.dims, nbytes, alg,
                                   profile=prof)
            conf = prof.confidence(est.algorithm, est.stage,
                                   needs_dcn=est.dcn_bytes > 0)
            trusted = trusted and conf >= confidence
            priced.append(est)
        if trusted:
            best = min(priced, key=lambda e: (e.seconds,
                                              e.algorithm == "naive"))
            return _CANDIDATE_TO_DISPATCH[best.algorithm]

        samples = microbench.measure_cell(
            cube, primitive, comm.dims, nbytes,
            [_CANDIDATE_TO_DISPATCH[e.algorithm] for e in priced],
            reps=reps, warmup=warmup, device=self.device)
        if not samples:
            return "pidcomm"            # group of 1: nothing to choose
        merged = prof.merge(CommProfile(prof.fingerprint, samples))
        merged.save(self.profile_path(cube))
        self._profiles[fingerprint_key(merged.fingerprint)] = merged
        best = min(samples, key=lambda s: s.seconds)
        return _CANDIDATE_TO_DISPATCH[best.algorithm]


__all__ = ["DEFAULT_CACHE_DIR", "Tuner"]
