"""Collective-fused kernels on the PE hypercube, on the port: ring
attention and matmul comm epilogues (``repro_torch.kernels.collective``)
dispatched as first-class registry algorithms.

Three acts:
  1. explicit dispatch -- ``ring_attention`` rotates kv blocks around an
     8-PE ring while the flash kernel's partial form consumes them, checked
     against the gather-then-attend pipeline within the documented
     tolerance;
  2. the matmul fusions -- ``all_gather_matmul`` / ``matmul_reduce_scatter``
     are *bit-identical* to their unfused gather/scatter pipelines
     (integer-valued fp32 for the epilogue);
  3. ``algorithm="auto"`` -- a measured CommProfile that prices the fused
     ring flows cheaper flips an MLP call site from the direct collectives
     to ``ring_fused`` + ``rs_epilogue``, visible in the CommTrace.

    python3 examples_torch/fused_kernels.py [--device cpu]

Runs on CUDA unless ``--device cpu`` is given (it raises when no GPU is
visible). The counterpart of ``examples/fused_kernels.py``; inputs come
from NumPy seeds.
"""
import argparse
import sys
from pathlib import Path

# the repository's src/, for python3 examples_torch/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.comm import CommTrace  # noqa: E402
from repro_torch.core.hypercube import Hypercube  # noqa: E402
from repro_torch.kernels.collective import (  # noqa: E402
    RING_ATTN_TOL, all_gather_matmul, matmul_reduce_scatter, ring_attention)
from repro_torch.models.layers import chunked_attention, rms_norm  # noqa: E402
from repro_torch.tuning import (  # noqa: E402
    CommProfile, LinkModel, topology_fingerprint)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cube = Hypercube.build({"d": 8})
    comm = cube.comm("d")
    g = 8
    print(f"hypercube {cube.describe()} ({dev})")

    # ---- 1. ring attention: the full-sequence k/v never materializes ----
    B, S_loc, H, hd = 1, 32, 4, 16
    rng = np.random.RandomState(0)
    q, k, v = (t(rng.standard_normal((g, B, S_loc, H, hd))
                 .astype(np.float32)) for _ in range(3))
    ring = ring_attention(comm, q, k, v)
    kf = comm.all_gather(k, axis=1)                  # assemble the sequence
    vf = comm.all_gather(v, axis=1)
    q_off = (cube.axis_index("d", dev) * S_loc)[:, None]
    base = chunked_attention(q, kf, vf, causal=True, q_offset=q_off)
    err = float((ring - base).abs().max())
    assert err <= RING_ATTN_TOL["float32"], err
    print(f"ring attention vs gather-then-attend: max |err| {err:.2e} "
          f"(documented tol {RING_ATTN_TOL['float32']:g})")

    # ---- 2. matmul comm fusions: bit-identical contracts ----------------
    rng = np.random.RandomState(1)
    x = t(rng.randn(g, 2, 4, 6).astype(np.float32))
    gamma = t(rng.randn(6).astype(np.float32))
    wu = t(rng.randn(6, 5).astype(np.float32))

    def block_fn(b):
        return rms_norm(b, gamma, 1e-6) @ wu
    fused = all_gather_matmul(comm, x, axis=1, block_fn=block_fn)
    plain = block_fn(comm.all_gather(x, axis=1))
    ag_identical = bool(torch.equal(fused, plain))
    assert ag_identical
    print("ag_prologue (norm + up-proj in the gather ring): bit-identical")

    h = t(rng.randint(-3, 4, (g, 16, 4)).astype(np.float32))
    w = t(rng.randint(-3, 4, (4, 6)).astype(np.float32))
    w_pe = w.expand((g,) + tuple(w.shape))       # every PE's copy of w
    fused = matmul_reduce_scatter(comm, h, w_pe, axis=0)
    plain = comm.reduce_scatter(h @ w, axis=0)
    rs_identical = bool(torch.equal(fused, plain))
    assert rs_identical
    print("rs_epilogue (lazy-tile out-proj, integer fp32): bit-identical")

    # ---- 3. auto dispatch under a measured profile ----------------------
    fast = LinkModel(alpha=0.0, beta=1e-12, n=8, r2=1.0)
    slow = LinkModel(alpha=1.0, beta=1e-6, n=8, r2=1.0)
    prof = CommProfile(topology_fingerprint(cube, dev), models={
        "ring_fused/cm/ici": fast, "rs_epilogue/cm/ici": fast,
        "naive/naive/ici": slow, "direct/im/ici": slow,
        "direct/cm/ici": slow})

    def mlp(vv):                                 # a tensor-parallel MLP
        hh = comm.all_gather(vv, axis=0)
        return comm.reduce_scatter(hh @ w, axis=0)

    xin = t(rng.randint(-3, 4, (g, 4, 4)).astype(np.float32))
    with CommTrace() as tr0:
        out0 = mlp(xin)
    with planner.install_profile(prof), CommTrace() as tr1:
        out1 = mlp(xin)
    flows0 = [e.flow for e in tr0.events]
    flows1 = [e.flow for e in tr1.events]
    print(f"auto MLP flows: analytic {flows0} -> measured {flows1}")
    assert flows1 == ["ring_fused", "rs_epilogue"], flows1
    assert all(e.est_source == "measured" for e in tr1.events)
    flip_identical = bool(torch.equal(out0, out1))
    assert flip_identical                        # the flip is bit-identical
    print("measured profile flipped the call site to the fused ring flows; "
          "outputs bit-identical")
    return {"ring_err": err, "ring_tol": RING_ATTN_TOL["float32"],
            "ag_prologue_identical": ag_identical,
            "rs_epilogue_identical": rs_identical,
            "flows_analytic": flows0, "flows_measured": flows1,
            "flip_identical": flip_identical}


if __name__ == "__main__":
    main()
