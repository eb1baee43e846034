"""The paper's flagship application: DLRM on a 3D virtual hypercube
(Fig. 11), end-to-end with conventional vs PID-Comm collectives, on the
port: the all_to_alls' block reorders run on the hand-written reorder
kernel on the card.

    python3 examples_torch/dlrm_pipeline.py [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (it raises when no GPU is
visible). The counterpart of ``examples/dlrm_pipeline.py``.
"""
import argparse
import sys
import time
from pathlib import Path

# the repository's src/, for python3 examples_torch/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.apps.paper_apps import make_dlrm  # noqa: E402
from repro_torch.core.hypercube import Hypercube  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cube = Hypercube.build({"x": 2, "y": 2, "z": 2})
    print("DLRM hypercube (tables x rows x cols):", cube.describe())
    print("comm chain: lookup -> AlltoAll(xyz) -> ReduceScatter(y) -> "
          "AlltoAll(xz) -> MLP\n")

    out = {}
    for alg in ("naive", "pidcomm"):
        run = make_dlrm(cube, batch_per_shard=64, emb_dim=32, algorithm=alg,
                        device=dev)
        first = run()                 # warm; a step waits for the device
        t0 = time.monotonic()
        for _ in range(5):
            value = run()
        dt = (time.monotonic() - t0) / 5
        out[alg] = {"ms_per_step": dt * 1e3, "value": value,
                    "first": first}
        print(f"{alg:8s}: {dt*1e3:7.2f} ms/step")
    return out


if __name__ == "__main__":
    main()
