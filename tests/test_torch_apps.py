"""The paper's five applications (§VII) on the port, held to the JAX
package's ``repro.apps.paper_apps`` at its default sizes on the cubes of
its benchmark (``benchmarks/apps.py``: (8,), (4, 2), (2, 2, 2)).

Each of the six ``APPS`` entries gives the JAX app's scalar under
``naive`` and ``pidcomm``: exactly for BFS and CC (their values are
integers below 2**24) and within a relative tolerance for the others --
1e-5, and 2e-5 for the two GNN variants, whose last step sums 131,072
equal f32 terms: JAX's reduction order lands 1.4e-5 from the f64 value of
the same computation, the port's 1e-6. Every port scalar is also held
within 1e-5 relative of a plain f64 NumPy evaluation of the app (the cube
flattened, the collectives those of ``repro.testing.oracles``), and the
port's ``naive`` and ``pidcomm`` runs agree with each other. DLRM, GNN and
MLP are held to the plain evaluation again with inputs drawn from a seed
(``seed=``), which the reference's constant inputs cannot be.
"""
import numpy as np
import pytest
import torch

from repro.apps import paper_apps as jax_apps
from repro.core.hypercube import Hypercube as JaxHypercube
from repro.launch.mesh import make_mesh
from repro.testing import oracles

from repro_torch.apps import paper_apps
from repro_torch.core.hypercube import Hypercube
from repro_torch.kernels.reorder import ops as reorder_ops

SHAPES = {1: (8,), 2: (4, 2), 3: (2, 2, 2)}
NAMES = ("x", "y", "z")
REL_TOL = {"dlrm": 1e-5, "gnn_rs_ar": 2e-5, "gnn_ar_ag": 2e-5, "bfs": 0.0,
           "cc": 0.0, "mlp": 1e-5}


def _cubes(ndims):
    shape, names = SHAPES[ndims], NAMES[:ndims]
    dims = dict(zip(names, shape))
    return (JaxHypercube.build(make_mesh(shape, names), dims),
            Hypercube.build(dims))


# ------------------------------------------------ plain f64 evaluations
def _plain_dlrm(sizes, batch_per_shard=64, emb_dim=32, n_tables=4,
                rows=512, inputs=None):
    """``inputs`` (the app's ``.inputs`` as f64 arrays), else the
    reference's constants."""
    nx, ny, nz = sizes
    G = nx * ny * nz
    Dl, b_l = max(emb_dim // nz, 1), max(batch_per_shard, G)
    F = n_tables * Dl
    C2 = F * G // ny // (nx * nz)
    inputs = inputs or {"tables": np.ones((n_tables, rows, Dl)),
                        "w0": np.full((C2, 64), 0.01),
                        "w1": np.full((64, 1), 0.01)}
    idx = np.arange(b_l * n_tables).reshape(n_tables, b_l) % rows
    emb = inputs["tables"][np.arange(n_tables)[:, None], idx]
    emb = np.broadcast_to(emb.transpose(1, 0, 2).reshape(b_l, F),
                          sizes + (b_l, F))      # every PE the same
    ex = oracles.all_to_all(emb, 3, (0, 1, 2), split_axis=0, concat_axis=1)
    red = oracles.reduce_scatter(ex, 3, (1,), axis=1)
    rel = oracles.all_to_all(red, 3, (0, 2), split_axis=1, concat_axis=0)
    out = np.maximum(rel @ inputs["w0"], 0) @ inputs["w1"]
    return out.sum(axis=(-2, -1)).sum()


def _plain_gnn(sizes, variant, n_nodes=2048, feat=256, inputs=None):
    nr, nc = sizes
    w_shape = (feat // nc, feat) if variant == "rs_ar" else (feat,
                                                             feat // nc)
    inputs = inputs or {"adj": np.full((n_nodes // nr, n_nodes // nc),
                                       1.0 / n_nodes),
                        "feats": np.ones((n_nodes // nc, feat)),
                        "w": np.full(w_shape, 0.01)}
    agg = nc * (inputs["adj"] @ inputs["feats"])  # summed over c
    if variant == "rs_ar":                       # member r: block r
        blocks = np.split(agg, nc, axis=1)
        out = sum(b @ inputs["w"] for b in blocks)
    else:
        comb = agg @ inputs["w"]
        out = np.concatenate([comb] * nc, axis=1)
    return np.maximum(out, 0).sum()


def _plain_graph(sizes, kind, n_nodes=4096, iters=8):
    ndev = int(np.prod(sizes))
    n_l = n_nodes // ndev
    i, j = np.arange(n_l)[:, None], np.arange(n_nodes)[None]
    if kind == "bfs":
        adj = ((i * 31 + j * 17) % 97 < 3).astype(np.float64)
        visited = np.zeros(n_nodes)
        visited[0] = 1.0
        for _ in range(iters):     # every PE relaxes the same rows
            visited = np.maximum(visited,
                                 np.tile((adj @ visited > 0) * 1.0, ndev))
        return visited.sum()
    adj = (i * 13 + j * 7) % 89 < 3
    labels = np.arange(n_nodes, dtype=np.float64)
    for _ in range(iters):
        neigh = np.where(adj, labels[None], n_nodes + 1.0).min(axis=1)
        labels = np.minimum(labels, np.tile(neigh, ndev))
    return labels.sum()


def _plain_mlp(sizes, features=2048, layers=5, batch=64, inputs=None):
    ndev = int(np.prod(sizes))
    f_l = features // ndev
    inputs = inputs or {"x": np.ones((batch, f_l)),
                        "ws": (np.full((f_l, features), 0.001),) * layers}
    h = np.broadcast_to(inputs["x"], (ndev, batch, f_l))  # each PE's block
    for w in inputs["ws"]:
        full = np.maximum(h @ w, 0).sum(0)          # reduce over the PEs
        h = np.stack(np.split(full, ndev, axis=1))  # PE r keeps block r
    return h[0].sum()


PLAIN = {
    "dlrm": lambda s, **kw: _plain_dlrm(s, **kw),
    "gnn_rs_ar": lambda s, **kw: _plain_gnn(s, "rs_ar", **kw),
    "gnn_ar_ag": lambda s, **kw: _plain_gnn(s, "ar_ag", **kw),
    "bfs": lambda s: _plain_graph(s, "bfs"),
    "cc": lambda s: _plain_graph(s, "cc"),
    "mlp": lambda s, **kw: _plain_mlp(s, **kw),
}


@pytest.mark.parametrize("algorithm", ["naive", "pidcomm"])
@pytest.mark.parametrize("name", sorted(paper_apps.APPS))
def test_app_scalar_matches_jax(name, algorithm):
    make, ndims = paper_apps.APPS[name]
    jcube, cube = _cubes(ndims)
    want = float(jax_apps.APPS[name][0](jcube, algorithm=algorithm)())
    got = make(cube, algorithm=algorithm, device="cpu")()
    assert isinstance(got, float)
    assert abs(got - want) <= REL_TOL[name] * abs(want)
    plain = PLAIN[name](SHAPES[ndims])
    assert abs(got - plain) <= (1e-5 if REL_TOL[name] else 0) * abs(plain)


@pytest.mark.parametrize("name", sorted(paper_apps.APPS))
def test_naive_and_pidcomm_agree(name):
    make, ndims = paper_apps.APPS[name]
    cube = _cubes(ndims)[1]
    a = make(cube, algorithm="naive", device="cpu")()
    b = make(cube, algorithm="pidcomm", device="cpu")()
    assert abs(a - b) <= (1e-6 if REL_TOL[name] else 0) * abs(a)


@pytest.mark.parametrize("algorithm", ["naive", "pidcomm"])
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("name", ["bfs", "cc"])
def test_graph_app_before_it_saturates(name, iters, algorithm):
    """At their defaults BFS visits every node and CC drives every label
    to 0 within 8 iterations, where a misplaced block changes nothing; 1
    and 2 iterations leave scalars that see each PE's slot: equal to the
    JAX app's and the plain evaluation's, and off the saturated value."""
    make = paper_apps.APPS[name][0]
    jcube, cube = _cubes(1)
    want = float(jax_apps.APPS[name][0](jcube, algorithm=algorithm,
                                        iters=iters)())
    got = make(cube, algorithm=algorithm, device="cpu", iters=iters)()
    assert got == want == _plain_graph(SHAPES[1], name, iters=iters)
    assert got != PLAIN[name](SHAPES[1])


def _f64(inputs):
    return {k: (tuple(t.double().numpy() for t in v) if isinstance(v, tuple)
                else v.double().numpy()) for k, v in inputs.items()}


@pytest.mark.parametrize("algorithm", ["naive", "pidcomm"])
@pytest.mark.parametrize("name", ["dlrm", "gnn_rs_ar", "gnn_ar_ag", "mlp"])
def test_seeded_app_matches_plain(name, algorithm):
    """With ``seed=`` the inputs are drawn, not constant, so the scalar
    sees where the collectives put each block: the port's scalar within
    1e-5 relative of the plain f64 evaluation on the app's own
    ``.inputs``, and off the scalar of the reference's constants."""
    make, ndims = paper_apps.APPS[name]
    cube = _cubes(ndims)[1]
    run = make(cube, algorithm=algorithm, device="cpu", seed=0)
    got = run()
    plain = PLAIN[name](SHAPES[ndims], inputs=_f64(run.inputs))
    assert abs(got - plain) <= 1e-5 * abs(plain)
    assert abs(got - PLAIN[name](SHAPES[ndims])) > 1e-3 * abs(plain)


def test_dlrm_pidcomm_runs_the_reorder_twice(monkeypatch):
    """Under pidcomm DLRM's AA(xyz) and AA(xz) are ``cm`` all_to_alls: one
    reorder each per call (none under naive)."""
    calls = []
    swizzle = reorder_ops.tile_swizzle

    def counting(x, perm, inv=None):
        calls.append(tuple(x.shape))
        return swizzle(x, perm, inv)

    monkeypatch.setattr(reorder_ops, "tile_swizzle", counting)
    cube = _cubes(3)[1]
    run = paper_apps.make_dlrm(cube, algorithm="pidcomm", device="cpu")
    run()
    run()
    assert len(calls) == 4
    paper_apps.make_dlrm(cube, algorithm="naive", device="cpu")()
    assert len(calls) == 4


def test_apps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    cube = _cubes(1)[1]
    with pytest.raises(RuntimeError, match="device"):
        paper_apps.make_bfs(cube)
