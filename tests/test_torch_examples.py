"""The port's example scripts (``examples_torch/``), one per script of the
JAX package's ``examples/``, run on the CPU through their ``main(argv)``
with ``--device cpu``: each finishes with its own asserts held (the JAX
script's) and returns the quantities it checks. ``train_100m`` runs a
small model (the script's defaults are the card's ~100M run); the others
run at their own sizes. No JAX example runs here: the modules the scripts
drive are held to the JAX package by their own tests."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.core import program
from repro_torch.telemetry import metrics as telemetry_metrics

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
ARGS = {"train_100m": ["--steps", "4", "--d-model", "64", "--layers", "2",
                       "--seq", "32"]}


@pytest.fixture(autouse=True)
def _reset_port_observability():
    """Each script counts lowerings from a cold lower cache, as a fresh
    process would; the telemetry registry starts empty."""
    program.clear_lower_cache()
    yield
    program.clear_lower_cache()
    telemetry_metrics.disable()
    telemetry_metrics.REGISTRY.reset()


def _main(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _check_serve_decode(r):
    assert r["lowered"] == 1 and r["hits"] >= r["steps"] - 1
    assert r["finished"] == r["requests"] == 10
    assert r["generated_tokens"] == sum(len(t) for t in
                                        r["out_tokens"].values())


def _check_dlrm_pipeline(r):
    assert set(r) == {"naive", "pidcomm"}
    # the two algorithms move the same blocks: the same scalar result
    assert r["naive"]["value"] == r["pidcomm"]["value"]
    assert all(v["ms_per_step"] > 0 for v in r.values())


def _check_fused_kernels(r):
    assert r["ring_err"] <= r["ring_tol"]
    assert r["ag_prologue_identical"] and r["rs_epilogue_identical"]
    assert r["flows_measured"] == ["ring_fused", "rs_epilogue"]
    assert r["flip_identical"]


def _check_train_100m(r):
    assert r["steps"] == 4 and len(r["losses"]) == 4
    assert all(l == l and 0 < l < 20 for l in r["losses"])  # finite


def _check_elastic_restore(r):
    assert r["save_hits"] >= 1 and r["saved_steps"] == [1, 2]
    assert "ckpt-restore-params" in r["restore_programs"]
    assert r["restore_identical"] and r["hf_identical"]


def _check_quickstart(r):
    assert r["program"]["fused_events"] == 1
    assert r["tuned"]["est_sources"] == {"measured": 1}
    assert r["overlap_plan"]["est_source"] == "measured"
    assert r["backward_overlap"]["bucket_order"] == ["grad-sync-b0",
                                                     "grad-sync-b1"]
    assert r["fused_kernels"]["flow"] == "ring_fused"
    assert r["serving"]["programs_recorded"] == r["serving"]["steps"]
    assert r["checkpoint"]["save_lower_cache_hits"] >= 1
    assert len(r["telemetry"]["stale"]) == 1


CHECKS = {"serve_decode": _check_serve_decode,
          "dlrm_pipeline": _check_dlrm_pipeline,
          "fused_kernels": _check_fused_kernels,
          "train_100m": _check_train_100m,
          "elastic_restore": _check_elastic_restore,
          "quickstart": _check_quickstart}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_example_runs_on_the_cpu(name):
    CHECKS[name](_main(name)(ARGS.get(name, []) + CPU))


def test_every_example_has_a_check():
    assert sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py")) \
        == sorted(CHECKS)


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device cpu`` a script asks for CUDA and raises where no
    GPU is visible, before it builds anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in sorted(CHECKS):
        with pytest.raises(RuntimeError, match="CUDA"):
            _main(name)(ARGS.get(name, []))
