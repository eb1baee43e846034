"""The port's perf harness (``repro_torch.launch.perf``) held against the
JAX package's on the CPU: the same twelve variants, each transform giving
the reference's config and knobs; the roofline terms of a fixed record on
the H100's rates; no TPU rate of ``benchmarks/roofline.py`` in the module;
one variant run end to end at smoke size."""
import dataclasses
import inspect
import json

import pytest

from repro import configs as jax_configs
from repro.launch import perf as jax_perf

from repro_torch import configs
from repro_torch.launch import dryrun, perf

# the TPU rates of benchmarks/roofline.py (peak, HBM, ICI, DCN), written
# here so the module under test need not name them
TPU_RATES = ("197e12", "819e9", "50e9", "3.125e9", "197", "819")


def test_variants_are_the_references():
    assert list(perf.VARIANTS) == list(jax_perf.VARIANTS)


@pytest.mark.parametrize("variant", sorted(jax_perf.VARIANTS))
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-1.7b"])
def test_each_transform_gives_the_references_config(arch, variant):
    tfm, kw = perf.VARIANTS[variant]
    jtfm, jkw = jax_perf.VARIANTS[variant]
    assert kw == jkw
    pcfg, jcfg = configs.get(arch), jax_configs.get(arch)
    if tfm is None:
        assert jtfm is None
        return
    got, want = dataclasses.asdict(tfm(pcfg)), dataclasses.asdict(jtfm(jcfg))
    assert got == want


FIXED = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "16x16",
         "params_active": 2_000_000_000,
         "cost_x": {"flops": 989e12 * 0.5, "bytes accessed": 3.35e12 * 0.1}}


def test_terms_of_a_fixed_record():
    t = perf.terms(FIXED)
    assert t["compute_s"] == pytest.approx(0.5)
    assert t["memory_s"] == pytest.approx(0.1)
    assert t["collective_s"] is None and t["dominant"] == "compute"
    model = 6 * 2e9 * 256 * 4096 / 256
    assert t["model_flops"] == pytest.approx(model)
    assert t["useful_ratio"] == pytest.approx(model / (989e12 * 0.5))
    assert t["roofline_frac"] == pytest.approx(model / 989e12 / 0.5)
    assert t["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    # a priced schedule enters the race; the multipod mesh has 512 PEs
    t = perf.terms(dict(FIXED, mesh="2x16x16", comm_seconds_x=2.0))
    assert t["collective_s"] == 2.0 and t["dominant"] == "collective"
    assert t["model_flops"] == pytest.approx(model / 2)
    assert t["roofline_frac"] == pytest.approx(model / 2 / 989e12 / 2.0)


def test_no_tpu_rate_in_the_module():
    src = inspect.getsource(perf)
    for rate in TPU_RATES:
        assert rate not in src, rate
    assert "benchmarks" not in src.split('"""', 2)[2]   # no import of it


def test_run_writes_the_record(tmp_path, monkeypatch):
    """One variant end to end at smoke size: the probe under the variant's
    knobs (mode 2 set for the traces, reset after), the record on disk."""
    smoke = dataclasses.replace(configs.get("qwen3-1.7b").scaled_for_smoke(),
                                n_layers=4)
    monkeypatch.setattr(configs, "get", lambda arch: smoke)
    from repro_torch.models import layers
    modes = []

    def cell(cfg, shape, pes, pods=1, **kw):
        modes.append(layers.LOWP)
        return dryrun.__dict__["_cell_real"](
            cfg, dict(shape, seq=32, batch=8), 8, 1, **kw)

    monkeypatch.setitem(dryrun.__dict__, "_cell_real", dryrun._cell)
    monkeypatch.setattr(dryrun, "_cell", cell)
    rec = perf.run("qwen3-1.7b", "train_4k", "lowp2", out=str(tmp_path))
    assert modes == [2, 2] and layers.LOWP == 0
    assert rec["n_units"] == 4 and rec["terms"]["collective_s"] is None
    on_disk = json.loads((tmp_path / "qwen3-1.7b_train_4k__lowp2.json")
                         .read_text())
    assert on_disk["terms"] == rec["terms"]
    assert on_disk["cost"]["flops"] > 0
