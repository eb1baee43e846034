"""Elastic checkpoint restore on the port: train-cube save -> serve-cube
restore.

A qwen3-family smoke model is initialized on the training topology
(data-parallel cube), checkpointed through a topology-bound
:class:`CheckpointManager` -- the device->host side is ONE recorded
rooted-gather CommProgram per section, and a second save hits the
structural-fingerprint lower cache -- then the **same checkpoint** is
restored onto the serving topology (maximal tensor parallelism, a
different cube) through a rooted-scatter program planned for that cube.
The restored params are bit-identical to directly initializing on the
serve topology, and every checkpoint collective carries ``program_id``
provenance into the CommTrace. The same planned-scatter path also places
a Hugging Face safetensors import.

    python3 examples_torch/elastic_restore.py [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (it raises when no GPU is
visible). The counterpart of ``examples/elastic_restore.py``.
"""
import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

# the repository's src/, for python3 examples_torch/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs, resolve_device  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, TrainState, hf_import)
from repro_torch.checkpoint.layout import flatten  # noqa: E402
from repro_torch.core.comm import CommTrace  # noqa: E402
from repro_torch.core.program import LOWER_STATS  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params, param_specs, to_global)
from repro_torch.models.topology import (  # noqa: E402
    build_serve_topology, build_topology)


def _identical(a, b) -> bool:
    """Two param trees with the same paths and bit-identical leaves."""
    fa, fb = list(flatten(a)), list(flatten(b))
    return ([p for p, _ in fa] == [p for p, _ in fb]
            and all(torch.equal(x.cpu(), y.cpu())
                    for (_, x), (_, y) in zip(fa, fb)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get("qwen3-1.7b").scaled_for_smoke()
    train_topo = build_topology(cfg, 8)
    serve_topo = build_serve_topology(cfg, 8)
    print("train cube:", train_topo.cube.describe())
    print("serve cube:", serve_topo.cube.describe())

    # ---- save on the training topology ----------------------------------
    params = init_params(cfg, train_topo, 0, device=dev)
    ckpt_dir = tempfile.mkdtemp(prefix="elastic-ckpt-")
    try:
        mgr = CheckpointManager(ckpt_dir, topo=train_topo, async_save=False,
                                device=dev,
                                specs={"params": param_specs(cfg, train_topo),
                                       "opt": None})
        hits0 = LOWER_STATS["cache_hits"]
        with CommTrace() as save_trace:
            mgr.save(1, TrainState(params=params))
            mgr.save(2, TrainState(params=params))
        save_hits = LOWER_STATS["cache_hits"] - hits0
        assert save_hits >= 1, \
            "second save must reuse the lowered gather program"
        n_leaves = len(list(flatten(params)))
        saved = mgr.all_steps()
        print(f"saved steps {saved}: {n_leaves} leaves per step "
              f"through program(s) {save_trace.summary()['programs']}, "
              f"{save_hits} lower-cache hit(s) on the repeat save")

        # ---- elastic restore onto the serving topology ------------------
        serve_specs = param_specs(cfg, serve_topo)
        with CommTrace() as restore_trace:
            restored = mgr.restore_params(2, serve_topo=serve_topo,
                                          specs=serve_specs)
        summary = restore_trace.summary()
        assert "ckpt-restore-params" in summary["programs"]
        print(f"restored params onto the serve cube via planned "
              f"program(s) {summary['programs']}: {summary['events']} "
              f"scatter ops, {summary['ici_bytes']:.0f} ICI bytes planned")

        direct = init_params(cfg, serve_topo, 0, device=dev)
        restore_identical = _identical(restored, direct)
        assert restore_identical
        print("elastic restore is bit-identical to direct init on the "
              "serve topology")

        # ---- the same scatter path places a Hugging Face import ---------
        host_params = to_global(restored, serve_specs, serve_topo.cube)
        sd = hf_import.export_state_dict(host_params, cfg)
        st_path = os.path.join(ckpt_dir, "model.safetensors")
        hf_import.write_safetensors(st_path, sd)
        imported = hf_import.import_checkpoint(st_path, cfg, serve_topo,
                                               specs=serve_specs, device=dev)
        hf_identical = _identical(
            to_global(imported, serve_specs, serve_topo.cube), host_params)
        assert hf_identical
        print(f"HF safetensors roundtrip ({len(sd)} tensors) placed through "
              "the same rooted-scatter program path, bit-identical")
    finally:
        shutil.rmtree(ckpt_dir)
    return {"save_hits": save_hits, "saved_steps": saved,
            "save_programs": save_trace.summary()["programs"],
            "restore_programs": summary["programs"],
            "restore_identical": restore_identical,
            "hf_tensors": len(sd), "hf_identical": hf_identical}


if __name__ == "__main__":
    main()
