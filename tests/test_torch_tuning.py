"""The port's tuning subsystem (``repro_torch.tuning``) and the planner's
pricing from a profile, on the CPU with synthetic timings.

The first fourteen tests mirror ``tests/test_tuning.py`` on the port:
profile persistence (byte-identical round trip, schema and fingerprint
refusal with a retune recipe, merging partial sweeps), the alpha-beta fits,
a synthetic profile that flips ``plan``'s pick, ``algorithm="auto"`` and a
recorded program's plan (execution bit-identical to the NumPy oracles of
``repro.testing.oracles``), a tuning sweep through the real dispatch with
the timer replaced by synthetic times (``microbench.bench``), ``select``'s
exhaustive fallback and its trust in a confident profile, and a race under
partial coverage. The rest hold the port to ``repro.tuning`` and
``repro.core.planner`` on the same inputs: the fits (alpha, beta and r2
within 1e-12 relative), a profile JSON the reference wrote, and ``plan`` /
``plan_program`` under one synthetic profile (algorithm, order, seconds);
and the communicator's ``auto`` cache, which keys on the installed
profile.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from repro.core import planner as jax_planner
from repro.testing import oracles
from repro.testing.substrate import fake_cube, integer_payload
from repro import tuning as jax_tuning

from repro_torch.core import planner
from repro_torch.core.comm import CommTrace
from repro_torch.core.hypercube import Hypercube
from repro_torch.telemetry.drift import DriftMonitor
from repro_torch.tuning import (
    CommProfile, LinkModel, MeasuredSample, OverlapModel, OverlapSample,
    ProfileMismatchError, Tuner, fit_models, fit_overlap,
    topology_fingerprint)
from repro_torch.tuning import microbench
from repro_torch.tuning import profile as profile_mod

CPU = "cpu"
REL = 1e-12         # port vs reference fits and prices, relative


def _sample(**kw):
    base = dict(primitive="all_reduce", algorithm="direct", stage="im",
                bitmap="1", nbytes=1 << 20, ici_bytes=2.0 * (1 << 20) * 7 / 8,
                dcn_bytes=0.0, seconds=1e-3)
    base.update(kw)
    return MeasuredSample(**base)


def _fp(cube):
    return topology_fingerprint(cube, CPU)


@pytest.fixture()
def ring8():
    return Hypercube.build({"d": 8})


@pytest.fixture()
def rect():
    return Hypercube.build({"r": 2, "c": 4})


@pytest.fixture()
def synthetic_timer(monkeypatch):
    """``microbench.bench`` replaced: each timed callable runs once (so its
    dispatch is traced) and takes a synthetic time, 1e-4 s plus 1e-4 s per
    earlier call, so every cell's time is known and distinct."""
    calls = []

    def fake(fn, *, warmup=2, reps=5, device=CPU):
        fn()
        calls.append(fn)
        return 1e-4 * len(calls)

    monkeypatch.setattr(microbench, "bench", fake)
    return calls


# ------------------------------------------------------------- persistence
def test_roundtrip_deterministic(tmp_path, ring8):
    samples = [_sample(nbytes=n, ici_bytes=n * 7 / 8, seconds=n * 1e-9 + 5e-5)
               for n in (1 << 16, 1 << 18, 1 << 20)]
    prof = CommProfile(_fp(ring8), samples)
    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    prof.save(p1)
    CommProfile.load(p1).save(p2)
    assert p1.read_bytes() == p2.read_bytes()
    re = CommProfile.load(p1, cube=ring8, device=CPU)   # fingerprint-checked
    assert re.models == prof.models
    assert re.samples == prof.samples


def test_schema_version_bump_rejected(tmp_path, ring8):
    prof = CommProfile(_fp(ring8), [_sample()])
    path = prof.save(tmp_path / "prof.json")
    data = json.loads(open(path).read())
    data["schema_version"] = profile_mod.SCHEMA_VERSION + 1
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(ProfileMismatchError, match="schema"):
        CommProfile.load(path)
    with pytest.raises(ProfileMismatchError, match="tune"):
        CommProfile.load(path)      # the error carries a retune recipe


def test_fingerprint_mismatch_rejected(tmp_path, ring8, rect):
    prof = CommProfile(_fp(ring8), [_sample()])
    path = prof.save(tmp_path / "prof.json")
    with pytest.raises(ProfileMismatchError, match="fingerprint mismatch"):
        CommProfile.load(path, cube=rect, device=CPU)
    with pytest.raises(ProfileMismatchError, match="tune"):
        CommProfile.load(path, cube=rect, device=CPU)   # recipe present
    with pytest.raises(ProfileMismatchError, match="dims"):
        prof.check_fingerprint(rect, CPU)
    # the device is part of the identity: a profile of another device
    other = dict(_fp(ring8), device="NVIDIA H100 80GB HBM3")
    with pytest.raises(ProfileMismatchError, match="device"):
        CommProfile(other).check_fingerprint(ring8, CPU)


def test_merge_partial_sweeps(ring8, rect):
    fp = _fp(ring8)
    a = CommProfile(fp, [_sample(algorithm="naive", stage="naive")])
    b = CommProfile(fp, [_sample(algorithm="direct", stage="im"),
                         _sample(algorithm="naive", stage="naive")])  # dup
    merged = a.merge(b)
    assert len(merged.samples) == 2                # exact dup dropped
    assert "naive/naive/ici" in merged.models
    assert "direct/im/ici" in merged.models
    with pytest.raises(ProfileMismatchError, match="different topologies"):
        a.merge(CommProfile(_fp(rect), []))


def test_fit_recovers_alpha_beta():
    alpha, beta = 2e-4, 3e-9
    samples = [_sample(nbytes=n, ici_bytes=float(n),
                       seconds=alpha + beta * n)
               for n in (1 << 14, 1 << 16, 1 << 18, 1 << 20)]
    m = fit_models(samples)["direct/im/ici"]
    assert m.alpha == pytest.approx(alpha, rel=1e-3)
    assert m.beta == pytest.approx(beta, rel=1e-3)
    assert m.r2 > 0.99 and m.n == 4
    prof = CommProfile({"any": "fp"}, samples)
    t = prof.seconds_for("direct", "im", 1 << 19, 0.0)
    assert t == pytest.approx(alpha + beta * (1 << 19), rel=1e-3)
    assert prof.is_confident("direct", "im")
    # an uncovered flow prices as None: the planner leaves it unpriced
    assert prof.seconds_for("hierarchical", "im", 1.0, 0.0) is None
    assert prof.confidence("hierarchical", "im") == 0.0


def test_fit_dcn_domain_split():
    """A flow moving both ICI and DCN bytes gets both domain models, and
    DCN pricing needs the DCN model."""
    rng = [(1 << 16, 1 << 13), (1 << 18, 1 << 13), (1 << 18, 1 << 16),
           (1 << 20, 1 << 14)]
    samples = [_sample(algorithm="hierarchical", stage="im",
                       ici_bytes=float(i), dcn_bytes=float(d),
                       seconds=1e-5 + 2e-9 * i + 4e-8 * d)
               for i, d in rng]
    assert set(fit_models(samples)) == {"hierarchical/im/ici",
                                        "hierarchical/im/dcn"}
    prof = CommProfile({"fp": 1}, samples)
    t = prof.seconds_for("hierarchical", "im", 1e6, 1e5)
    assert t == pytest.approx(1e-5 + 2e-9 * 1e6 + 4e-8 * 1e5, rel=0.05)


# ----------------------------------------------- measured pricing / plan()
def _inverting_profile(cube):
    """A synthetic profile that makes the naive host flow the cheapest
    candidate, the opposite of the byte ranking."""
    return CommProfile(_fp(cube), models={
        "naive/naive/ici": LinkModel(alpha=0.0, beta=1e-12, n=8, r2=1.0),
        "direct/im/ici": LinkModel(alpha=1.0, beta=1e-6, n=8, r2=1.0),
        "direct/cm/ici": LinkModel(alpha=1.0, beta=1e-6, n=8, r2=1.0),
    })


def test_synthetic_profile_inverts_plan(ring8):
    payload = 512 * 1024
    byte_pick = planner.plan(ring8, "all_to_all", ("d",), payload)
    assert byte_pick.algorithm == "direct"
    assert byte_pick.est_source == "analytic" and byte_pick.seconds is None
    prof = _inverting_profile(ring8)
    measured = planner.plan(ring8, "all_to_all", ("d",), payload,
                            profile=prof)
    assert measured.algorithm == "naive"            # the pick flipped
    assert measured.est_source == "measured"
    assert measured.seconds == pytest.approx(1e-12 * measured.ici_bytes)
    with planner.install_profile(prof):
        assert planner.plan(ring8, "all_to_all", ("d",),
                            payload).algorithm == "naive"
    assert planner.active_profile() is None


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_measured_auto_dispatch_bit_identical(ring8):
    """With the inverting profile installed, ``auto`` executes another flow
    (naive instead of the cm swizzle), stays bit-identical to the oracle,
    and every event is measured-priced."""
    comm = ring8.comm("d")
    x = np.random.RandomState(7).randn(8, 2, 32).astype(np.float32)
    with CommTrace() as tr0:
        got0 = comm.all_to_all(_t(x), split_axis=1, concat_axis=1).numpy()
    assert tr0.events[0].flow == "cm"
    assert tr0.events[0].est_source == "analytic"
    with planner.install_profile(_inverting_profile(ring8)), \
            CommTrace() as tr:
        got = comm.all_to_all(_t(x), split_axis=1, concat_axis=1).numpy()
    assert [e.flow for e in tr.events] == ["naive"]
    assert all(e.est_source == "measured" for e in tr.events)
    assert tr.events[0].seconds is not None
    want = oracles.all_to_all(x, 1, (0,), split_axis=1, concat_axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got0, want)
    assert tr.summary()["est_sources"] == {"measured": 1}


def _fused_favoring_profile(cube):
    """A synthetic profile pricing the fused ring flows below every unfused
    candidate."""
    fast = LinkModel(alpha=0.0, beta=1e-12, n=8, r2=1.0)
    slow = LinkModel(alpha=1.0, beta=1e-6, n=8, r2=1.0)
    return CommProfile(_fp(cube), models={
        "ring_fused/cm/ici": fast, "rs_epilogue/cm/ici": fast,
        "naive/naive/ici": slow, "direct/im/ici": slow,
        "direct/cm/ici": slow})


def test_measured_auto_flips_mlp_call_site_to_fused(ring8):
    """At a tensor-parallel MLP call site (sequence all_gather, a matmul,
    reduce_scatter of the partial sums) a profile favoring the fused ring
    flows flips ``auto`` from the direct collectives to ``ring_fused`` +
    ``rs_epilogue``, bit-identical on integer payloads."""
    comm = ring8.comm("d")
    x = integer_payload(ring8, (4, 6), seed=21)                 # (8, 4, 6)
    w = np.random.RandomState(21).randint(-3, 4, (6, 6)).astype(np.float32)

    def mlp(v):
        h = comm.all_gather(v, axis=0)                        # (8, 32, 6)
        return comm.reduce_scatter(h @ _t(w), axis=0)

    with CommTrace() as tr0:
        got0 = mlp(_t(x)).numpy()
    assert [e.flow for e in tr0.events] == ["cm", "im"]
    with planner.install_profile(_fused_favoring_profile(ring8)), \
            CommTrace() as tr:
        got = mlp(_t(x)).numpy()
    assert [e.flow for e in tr.events] == ["ring_fused", "rs_epilogue"]
    assert all(e.est_source == "measured" for e in tr.events)
    np.testing.assert_array_equal(got, got0)
    want = oracles.reduce_scatter(
        oracles.all_gather(x, 1, (0,), axis=0) @ w, 1, (0,), axis=0)
    np.testing.assert_array_equal(got, want)


def test_measured_program_plan_and_execute(ring8):
    """The deferred path: the joint plan under the inverting profile picks
    naive for the recorded op, carries seconds, and execution emits
    measured events bit-identical to the oracle."""
    comm = ring8.comm("d")
    x = np.random.RandomState(9).randn(8, 2, 32).astype(np.float32)
    prog = ring8.program(name="tuned-aa")
    with prog:
        v = prog.input(torch.empty(8, 2, 32))
        prog.output(comm.all_to_all(v, split_axis=1, concat_axis=1))
    analytic = prog.lower()
    a_est = next(iter(analytic.plan.estimates.values()))
    assert a_est.algorithm == "direct" and a_est.est_source == "analytic"
    assert analytic.plan.seconds is None
    with planner.install_profile(_inverting_profile(ring8)):
        lowered = prog.lower()
        m_est = next(iter(lowered.plan.estimates.values()))
        assert m_est.algorithm == "naive" and m_est.est_source == "measured"
        assert lowered.plan.seconds == m_est.seconds
        assert lowered.plan.est_source == "measured"
        with CommTrace() as tr:
            got = lowered.execute(_t(x)).numpy()
    assert [e.flow for e in tr.events] == ["naive"]
    assert tr.events[0].program_id == "tuned-aa"
    np.testing.assert_array_equal(
        got, oracles.all_to_all(x, 1, (0,), split_axis=1, concat_axis=1))


# ------------------------------------------------------------ live tuning
def test_tune_cache_and_measured_plan(tmp_path, ring8, synthetic_timer):
    """A sweep through the real dispatch with synthetic times: tune ->
    save -> reload under the same fingerprint -> ``auto`` prices covered
    flows as measured; tuning again merges."""
    tuner = Tuner(cache_dir=tmp_path, device=CPU)
    prof = tuner.tune(ring8, sizes=(8192, 32768),
                      primitives=("all_reduce", "all_gather"),
                      reps=2, warmup=1)
    assert os.path.exists(tuner.profile_path(ring8))
    assert any(k.startswith("naive/naive/") for k in prof.models)
    # 2 sizes x (2 all_reduce + 4 all_gather candidates), then 2 overlap
    # sizes x (one solo + one pair)
    assert len(prof.samples) == 12 and len(synthetic_timer) == 16
    assert sorted(s.seconds for s in prof.samples) == pytest.approx(
        [1e-4 * i for i in range(1, 13)])
    fresh = Tuner(cache_dir=tmp_path, device=CPU)
    reloaded = fresh.load(ring8)
    est = planner.plan(ring8, "all_reduce", ("d",), 16384, profile=reloaded)
    assert est.est_source == "measured"
    n0 = len(reloaded.samples)
    prof2 = fresh.tune(ring8, sizes=(16384,), primitives=("all_reduce",),
                       reps=2, warmup=1)
    assert len(prof2.samples) > n0


def test_select_exhaustive_fallback(tmp_path, ring8, synthetic_timer):
    """An under-sampled profile (n < MIN_SAMPLES) is low-confidence, so
    ``select`` measures the candidates at the size asked and saves them."""
    tuner = Tuner(cache_dir=tmp_path, device=CPU)
    CommProfile(_fp(ring8), [
        _sample(algorithm="naive", stage="naive", seconds=1e-3),
        _sample(algorithm="direct", stage="im", seconds=2e-3),
    ]).save(tuner.profile_path(ring8))
    alg = tuner.select("all_reduce", 16384, ring8.comm("d"), reps=2,
                       warmup=1)
    assert alg == "naive"           # the first measured (fastest) candidate
    assert len(synthetic_timer) == 2
    grown = CommProfile.load(tuner.profile_path(ring8))
    assert len(grown.samples) > 2


def test_select_trusts_confident_profile(tmp_path, ring8):
    """With confident models covering every candidate, ``select`` prices
    without measuring."""
    tuner = Tuner(cache_dir=tmp_path, device=CPU)
    _inverting_profile(ring8).save(tuner.profile_path(ring8))
    assert tuner.select("all_to_all", 512 * 1024, ring8.comm("d")) \
        == "naive"
    assert len(CommProfile.load(tuner.profile_path(ring8)).samples) == 0


def test_partial_coverage_excludes_analytic_candidates():
    """On a pod-crossing all_reduce the ``direct`` candidate is never
    measured (the dispatcher escalates it away): with naive and
    hierarchical covered, the race picks among those two, and the
    uncovered one is out of it."""
    pod = Hypercube.build({"pod": 2, "dp": 2, "tp": 2}, pods=2)
    slow = LinkModel(alpha=1e-3, beta=1e-8, n=8, r2=1.0)
    prof = CommProfile(_fp(pod), models={
        "naive/naive/ici": slow, "naive/naive/dcn": slow,
        "hierarchical/im/ici": slow,
        "hierarchical/im/dcn": LinkModel(alpha=0.0, beta=1e-8, n=8, r2=1.0),
    })
    est = planner.plan(pod, "all_reduce", ("pod", "dp"), 1 << 20,
                       profile=prof)
    assert est.est_source == "measured"
    assert est.algorithm in ("naive", "hierarchical")


# ---------------------------------------------------- against the reference
def _random_samples(seed, algs=(("direct", "im"), ("naive", "naive"),
                                ("hierarchical", "im"))):
    rng = np.random.RandomState(seed)
    out = []
    for alg, stage in algs:
        for n in (1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22):
            ici = float(n * rng.uniform(0.5, 2))
            dcn = float(n * rng.uniform(0.01, 0.3)) \
                if alg == "hierarchical" else 0.0
            sec = float(rng.uniform(1e-5, 1e-4) + ici * rng.uniform(1e-10,
                                                                   1e-9)
                        + dcn * 2e-9 * rng.uniform(0.5, 1.5))
            out.append(dict(primitive="all_reduce", algorithm=alg,
                            stage=stage, bitmap="11", nbytes=n,
                            ici_bytes=ici, dcn_bytes=dcn, seconds=sec))
    return out


def _close_rel(a, b):
    assert a == pytest.approx(b, rel=REL, abs=1e-300)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fits_equal_the_reference(seed):
    rows = _random_samples(seed)
    if seed == 3:           # a noisy, degenerate group: negative slopes
        rows = [dict(r, seconds=2e-4 - r["ici_bytes"] * 1e-11) for r in rows]
    ours = fit_models([MeasuredSample(**r) for r in rows])
    ref = jax_tuning.fit_models([jax_tuning.MeasuredSample(**r)
                                 for r in rows])
    assert set(ours) == set(ref)
    for k, m in ours.items():
        for f in ("alpha", "beta", "r2"):
            _close_rel(getattr(m, f), getattr(ref[k], f))
        assert m.n == ref[k].n


def test_overlap_fit_equals_the_reference():
    rng = np.random.RandomState(4)
    rows = [dict(dom_a=a, dom_b=b, primitive_a="all_reduce",
                 primitive_b="all_reduce", bitmap_a="011", bitmap_b="100",
                 nbytes=1 << 18, seconds_a=float(rng.uniform(1, 2)),
                 seconds_b=float(rng.uniform(1, 2)),
                 seconds_pair=float(rng.uniform(1.5, 4)))
            for a, b in itertools.product(("ici", "dcn"), repeat=2)
            for _ in range(3)]
    ours = fit_overlap([OverlapSample(**r) for r in rows])
    ref = jax_tuning.fit_overlap([jax_tuning.OverlapSample(**r)
                                  for r in rows])
    assert set(ours) == set(ref)
    for k, m in ours.items():
        _close_rel(m.factor, ref[k].factor)
        assert m.n == ref[k].n


def _ref_cube():
    return fake_cube((2, 2, 2), ("pod", "data", "model"),
                     {"pod": 2, "dp": 2, "tp": 2})


def _pod_cube():
    return Hypercube.build({"pod": 2, "dp": 2, "tp": 2}, pods=2)


def test_reference_profile_json_parses_and_is_refused(tmp_path):
    """A schema-2 profile the reference wrote (its fingerprint names jax)
    parses to the same samples, models and overlap factors, and is refused
    against the port's own cube."""
    ref_cube = _ref_cube()
    rows = _random_samples(5)
    ref = jax_tuning.CommProfile(
        jax_tuning.topology_fingerprint(ref_cube),
        [jax_tuning.MeasuredSample(**r) for r in rows],
        overlap_samples=[jax_tuning.OverlapSample(
            dom_a="ici", dom_b="dcn", primitive_a="all_reduce",
            primitive_b="all_reduce", bitmap_a="011", bitmap_b="100",
            nbytes=1 << 18, seconds_a=1.0, seconds_b=2.0,
            seconds_pair=2.5)])
    path = ref.save(tmp_path / "reference.json")
    ours = CommProfile.load(path)
    assert [s.to_json() for s in ours.samples] == \
        [s.to_json() for s in ref.samples]
    assert {k: m.to_json() for k, m in ours.models.items()} == \
        {k: m.to_json() for k, m in ref.models.items()}
    assert ours.overlap_factor("ici", "dcn") == ref.overlap_factor("ici",
                                                                   "dcn")
    assert ours.token() == ref.token()
    with pytest.raises(ProfileMismatchError, match="fingerprint mismatch"):
        CommProfile.load(path, cube=_pod_cube(), device=CPU)


def test_reference_v1_profile_migrates(tmp_path):
    ref = jax_tuning.CommProfile(
        jax_tuning.topology_fingerprint(_ref_cube()),
        [jax_tuning.MeasuredSample(**r) for r in _random_samples(6)])
    data = ref.to_json()
    data["schema_version"] = 1
    for k in ("overlap", "overlap_samples"):
        del data[k]
    ours = CommProfile.from_json(data)
    assert not ours.has_overlap
    assert ours.models == CommProfile.from_json(ref.to_json()).models


# Every (algorithm, stage) the planner prices on the pod cube, with random
# models; the same JSON is loaded by both packages.
_POD_KEYS = [("naive", "naive"), ("direct", "im"), ("direct", "cm"),
             ("hierarchical", "im"), ("compressed", "cm"),
             ("ring_fused", "cm"), ("ag_prologue", "cm"),
             ("rs_epilogue", "cm")]


def _synthetic_pair(seed, overlap=True):
    rng = np.random.RandomState(seed)
    models = {}
    for alg, stage in _POD_KEYS:
        # measured times well above the reference's link-constant times,
        # so its analytic fallbacks never decide a price
        models[f"{alg}/{stage}/ici"] = LinkModel(
            alpha=float(rng.uniform(1e-3, 3e-3)),
            beta=float(rng.uniform(1e-9, 1e-8)), n=8, r2=1.0)
        models[f"{alg}/{stage}/dcn"] = LinkModel(
            alpha=0.0, beta=float(rng.uniform(1e-8, 1e-7)), n=8, r2=1.0)
    ov = {f"{a}->{b}": OverlapModel(factor=float(rng.uniform(0, 1)), n=3)
          for a, b in itertools.product(("ici", "dcn"), repeat=2)} \
        if overlap else {}
    ours = CommProfile(_fp(_pod_cube()), models=models, overlap=ov)
    data = ours.to_json()
    data["fingerprint"] = jax_tuning.topology_fingerprint(_ref_cube())
    return ours, jax_tuning.CommProfile.from_json(data)


_PLAN_CASES = [
    ("all_reduce", ("pod", "dp")), ("all_reduce", ("dp", "tp")),
    ("all_reduce", ("pod", "dp", "tp")), ("all_gather", ("pod", "dp")),
    ("all_gather", ("tp",)), ("reduce_scatter", ("pod", "tp")),
    ("all_to_all", ("pod", "dp", "tp")), ("all_to_all", ("dp",))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("primitive,dims", _PLAN_CASES)
def test_plan_under_a_profile_equals_the_reference(primitive, dims, seed):
    ours, ref = _synthetic_pair(seed)
    for payload in (1 << 14, 1 << 20, 3 << 22):
        for compressed in (False, True):
            got = planner.plan(_pod_cube(), primitive, dims, payload,
                               allow_compressed=compressed, profile=ours)
            want = jax_planner.plan(_ref_cube(), primitive, dims, payload,
                                    allow_compressed=compressed, profile=ref)
            assert (got.algorithm, got.stage, got.est_source) == \
                (want.algorithm, want.stage, want.est_source)
            assert (got.ici_bytes, got.dcn_bytes) == (want.ici_bytes,
                                                      want.dcn_bytes)
            _close_rel(got.seconds, want.seconds)


def _program_ops(mod, seed):
    """Two dependency levels: four independent ops of both domains, then
    two that consume some of them, with mixed requests."""
    rng = np.random.RandomState(seed)
    reqs = [("all_reduce", ("pod", "dp"), "auto"),
            ("all_gather", ("tp",), "auto"),
            ("all_reduce", ("dp", "tp"), "naive"),
            ("reduce_scatter", ("pod", "tp"), "auto"),
            ("all_to_all", ("dp",), "pidcomm"),
            ("all_reduce", ("pod", "dp", "tp"), "hierarchical")]
    deps = [(), (), (), (), (0, 2), (1,)]
    return [mod.ProgramOpSpec(
        op_id=i, primitive=p, dims=d,
        payload_bytes=float(rng.choice([1 << 16, 1 << 20, 1 << 22])),
        deps=deps[i], algorithm=a) for i, (p, d, a) in enumerate(reqs)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_plan_program_under_a_profile_equals_the_reference(seed):
    ours, ref = _synthetic_pair(seed)
    got = planner.plan_program(_pod_cube(), _program_ops(planner, seed),
                               profile=ours)
    want = jax_planner.plan_program(_ref_cube(),
                                    _program_ops(jax_planner, seed),
                                    profile=ref)
    for i, e in got.estimates.items():
        # the two dominance rules agree on these ops (the port's: any DCN
        # byte; the reference's: its link constants)
        assert e.dominant() == want.estimates[i].dominant()
        assert e.algorithm == want.estimates[i].algorithm
        _close_rel(e.seconds, want.estimates[i].seconds)
    assert got.order == want.order and got.levels == want.levels
    assert got.est_source == want.est_source == "measured"
    _close_rel(got.seconds, want.seconds)
    _close_rel(got.serial_seconds, want.serial_seconds)


def test_plan_program_without_overlap_factors_is_mixed():
    """Per-op seconds under the both-links budget: ``"mixed"`` in both
    packages, the same order; the port's budget sums each domain's
    measured legs."""
    ours, ref = _synthetic_pair(0, overlap=False)
    got = planner.plan_program(_pod_cube(), _program_ops(planner, 0),
                               profile=ours)
    want = jax_planner.plan_program(_ref_cube(),
                                    _program_ops(jax_planner, 0),
                                    profile=ref)
    assert got.est_source == want.est_source == "mixed"
    assert got.order == want.order
    assert got.serial_seconds >= got.seconds > 0
    for wave in got.levels:
        assert max(got.estimates[i].seconds for i in wave) <= got.seconds


def test_plan_program_with_no_profile_is_unpriced():
    got = planner.plan_program(_pod_cube(), _program_ops(planner, 0))
    assert got.seconds is None and got.serial_seconds is None
    assert got.est_source == "analytic"
    assert all(e.seconds is None for e in got.estimates.values())


def test_partly_covered_program_is_mixed_and_unpriced():
    """An op the profile does not cover leaves the plan without seconds
    (nothing to add it to), and the plan says "mixed"."""
    ours, _ = _synthetic_pair(1)
    models = {k: m for k, m in ours.models.items()
              if not k.startswith("naive/")}
    part = CommProfile(ours.fingerprint, models=models, overlap=ours.overlap)
    got = planner.plan_program(_pod_cube(), _program_ops(planner, 1),
                               profile=part)
    assert got.estimates[2].seconds is None           # the naive request
    assert got.seconds is None and got.est_source == "mixed"


def test_auto_cache_keys_on_the_installed_profile(ring8):
    """``auto`` picked before a profile is installed is not reused under
    it, and the profile's pick is not reused after it is gone."""
    comm = ring8.comm("d")
    x = torch.zeros(8, 64)

    def flow():
        with CommTrace() as tr:
            comm.all_to_all(x, split_axis=0, concat_axis=0)
        return tr.events[0].flow

    assert flow() == "cm"
    with planner.install_profile(_inverting_profile(ring8)):
        assert flow() == "naive"
        with planner.install_profile(_fused_favoring_profile(ring8)):
            # naive and direct priced alike: direct moves fewer bytes
            assert flow() == "cm"
    assert flow() == "cm"


def test_compressed_pick_runs_the_compressed_flow():
    """A pick the planner can now make under a profile -- the compressed
    flow of a pod-crossing all_reduce -- maps onto its registry flow."""
    pod = _pod_cube()
    comm = pod.comm(("pod", "dp"))
    cheap = LinkModel(alpha=0.0, beta=1e-15, n=8, r2=1.0)
    dear = LinkModel(alpha=1.0, beta=1e-6, n=8, r2=1.0)
    prof = CommProfile(_fp(pod), models={
        "compressed/cm/ici": cheap, "compressed/cm/dcn": cheap,
        "naive/naive/ici": dear, "naive/naive/dcn": dear,
        "hierarchical/im/ici": dear, "hierarchical/im/dcn": dear})
    with planner.install_profile(prof):
        flow, est = comm._resolve_flow_uncached("all_reduce", "auto", 4096,
                                                "add")
        # auto's race leaves the lossy flow out unless asked for
        assert flow == "hierarchical"
    got = planner.plan(pod, "all_reduce", ("pod", "dp"), 4096,
                       allow_compressed=True, profile=prof)
    assert got.algorithm == "compressed" and got.est_source == "measured"


def test_bench_on_the_cpu_is_a_wall_clock_median():
    calls = []
    t = microbench.bench(lambda: calls.append(1), warmup=2, reps=5,
                         device=CPU)
    assert len(calls) == 7 and 0.0 <= t < 1.0


def test_sweep_candidates_are_the_references():
    for dims in (("pod", "dp"), ("dp", "tp"), ("tp",)):
        for prim in microbench.PE_PRIMITIVES + microbench.ROOTED_PRIMITIVES:
            from repro.tuning import microbench as ref_mb
            assert microbench.candidates(_pod_cube(), prim, dims) == \
                ref_mb._candidates(_ref_cube(), prim, dims)


def test_measure_cell_records_the_executed_flow(ring8, synthetic_timer):
    """Each candidate of an all_to_all cell becomes one sample with the
    event's stage and bytes: naive and the cm swizzle (priced direct)."""
    cell = microbench.measure_cell(ring8, "all_to_all", ("d",), 4096,
                                   device=CPU)
    assert [(s.algorithm, s.stage) for s in cell] == [("naive", "naive"),
                                                      ("direct", "cm")]
    est = planner.estimate(ring8, "all_to_all", ("d",), 4096, "direct")
    assert cell[1].ici_bytes == est.ici_bytes and cell[1].nbytes == 4096


def test_drift_monitor_files_a_priced_plan(ring8):
    """``DriftMonitor.observe_plan`` files the measured/planned ratio of a
    plan priced under a profile (it returns early on an unpriced one)."""
    ops = [planner.ProgramOpSpec(op_id=0, primitive="all_to_all",
                                 dims=("d",), payload_bytes=1 << 16)]
    mon = DriftMonitor()
    mon.observe_plan(planner.plan_program(ring8, ops), 1e-3)
    assert not mon.residuals
    plan = planner.plan_program(ring8, ops,
                                profile=_inverting_profile(ring8))
    assert plan.est_source == "measured"
    mon.observe_plan(plan, 2 * plan.seconds)
    assert list(mon.medians().values()) == [pytest.approx(2.0)]


def test_trainer_prices_grad_sync_under_a_profile():
    """``Trainer._price_sync_estimates`` sets its gauges from grad-sync
    events once they carry seconds."""
    from repro_torch.core.comm import CommEvent
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.telemetry import metrics

    def ev(pid, seconds):
        return CommEvent(primitive="all_reduce", bitmap="1", dims=("d",),
                         algorithm="auto", flow="im", stage="im",
                         group_size=8, num_instances=1, payload_bytes=64,
                         ici_bytes=1.0, dcn_bytes=0.0, seconds=seconds,
                         program_id=pid, est_source="measured")

    metrics.enable()
    try:
        metrics.REGISTRY.reset()
        Trainer._price_sync_estimates(None, [ev("grad-sync-b0", 1e-3),
                                             ev("grad-sync-b1", 2e-3)])
        snap = metrics.REGISTRY.snapshot()
        gauges = {k: v for k, v in snap.items() if "sync_" in k}
        assert gauges["train.sync_serial_est_us"]["value"] == \
            pytest.approx(3e3)
        assert gauges["train.sync_exposed_est_us"]["value"] == \
            pytest.approx(2e3)
    finally:
        metrics.disable()
        metrics.REGISTRY.reset()


@pytest.mark.parametrize("factor", [0.0, 0.4, 1.0])
def test_wave_order_never_hides_an_op_twice(factor):
    """Adjacent-pair pricing caps each op's hidden time at its own length
    (a short op between two long ones hides once), as the reference's
    ``_wave_order_seconds`` does on the same estimates."""
    ours = {0: planner.CommEstimate("all_reduce", "direct", (), 0.0, 1e6,
                                    100e-6),
            1: planner.CommEstimate("all_gather", "direct", (), 1e6, 0.0,
                                    10e-6),
            2: planner.CommEstimate("all_reduce", "direct", (), 0.0, 1e6,
                                    100e-6)}
    ref = {i: jax_planner.CommEstimate(e.primitive, e.algorithm, (),
                                       e.ici_bytes, e.dcn_bytes, e.seconds)
           for i, e in ours.items()}
    got = planner._wave_order_seconds((0, 1, 2), ours, lambda a, b: factor)
    want = jax_planner._wave_order_seconds((0, 1, 2), ref,
                                           lambda a, b: factor)
    assert got == want
    if factor == 0.0:
        assert got[0] == pytest.approx(200e-6) and got[1:] == (2, 2)
