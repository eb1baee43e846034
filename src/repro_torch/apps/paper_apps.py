"""The paper's five benchmark applications (§VII) on the in-process cube.

The counterpart of ``repro.apps.paper_apps``: every inter-PE exchange goes
through the PID-Comm primitives with a selectable ``algorithm``
(``"naive"``: the host-mediated flow; ``"pidcomm"``: the optimized one),
the end-to-end experiment of Fig. 13/15. The communication structure, the
size keywords and their defaults are the reference's:

  DLRM  3D cube (x = tables, y = rows, z = cols): lookup -> AA(xyz) ->
        RS(y) -> AA(xz) -> MLP                          [Fig. 11]
  GNN   2D tiles: SpGEMM -> RS(c) -> GeMM -> AR(c)      (RS&AR variant)
        or        SpGEMM -> AR(c) -> GeMM -> AG(c)      (AR&AG variant) [Fig. 12]
  BFS   frontier relaxation, AllReduce(max) per iteration
  CC    min-label propagation, AllReduce(min) per iteration
  MLP   column-partitioned layers, ReduceScatter between layers

Per-PE data carries the cube's leading axes. The reference passes every
input replicated (each device holds the same array); here a replicated
input is held once and broadcast over the cube axes as a stride-0 view
(``expand``), and each PE's compute runs on that view. ``axis_index`` and
``dynamic_update_slice`` become each PE's cube coordinate and a scatter
at it. Each ``make_*`` takes ``device=`` (the card unless ``"cpu"``) and
returns a callable that runs the app once, synchronizes the device and
returns the app's scalar: PE 0's value (every PE holds the same one).

The reference fills DLRM's, GNN's and MLP's inputs with constants, which
leaves their scalars blind to where the collectives put the data. Those
three also take ``seed=``: an int draws each input from a generator
seeded with it instead (signed where the reference's constant is a table,
feature or weight; non-negative for GNN's adjacency and DLRM's last
weight, so the scalar stays a sum of non-negative terms). The callable
carries its inputs, unreplicated, as ``.inputs``, so a plain version can
run on the same data. ``seed=None`` is the reference's constants.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.hypercube import Hypercube
from repro_torch.models.layers import cube_matmul


def _replicated(cube: Hypercube, t: torch.Tensor) -> torch.Tensor:
    """``t`` on every PE: a stride-0 view ``(*cube.dim_sizes, *t.shape)``."""
    return t.expand(cube.dim_sizes + tuple(t.shape))


def _scalar(cube: Hypercube, per_pe: torch.Tensor) -> float:
    """PE 0's value of a per-PE scalar ``(*cube.dim_sizes,)``; the device
    is synchronized when it returns."""
    value = float(per_pe[(0,) * cube.ndim])
    if per_pe.is_cuda:
        torch.cuda.synchronize(per_pe.device)
    return value


def _input(shape, value: float, gen, dev, *, signed: bool = True):
    """The reference's constant ``value`` (``gen`` None), else a draw of
    the same scale: N(0, value^2) if ``signed``, else U[0, 2 value)."""
    if gen is None:
        return torch.full(shape, value, dtype=torch.float32, device=dev)
    if signed:
        return value * torch.randn(shape, generator=gen, device=dev)
    return 2 * value * torch.rand(shape, generator=gen, device=dev)


def _generator(seed, dev):
    return (None if seed is None
            else torch.Generator(device=dev).manual_seed(seed))


def _place_at_member(cube: Hypercube, comm, local: torch.Tensor,
                     fill: float) -> torch.Tensor:
    """(*cube, n_l) -> (*cube, G * n_l): each PE's ``local`` at its member
    slot ``me * n_l``, ``fill`` elsewhere (``dynamic_update_slice``)."""
    c = cube.ndim
    g, n_l = comm.group_size, local.shape[-1]
    me = comm.axis_index(local.device)
    upd = torch.full(cube.dim_sizes + (g, n_l), fill, dtype=local.dtype,
                     device=local.device)
    upd.scatter_(c, me[..., None, None].expand(cube.dim_sizes + (1, n_l)),
                 local.unsqueeze(c))
    return upd.reshape(cube.dim_sizes + (g * n_l,))


# ----------------------------------------------------------------- DLRM
def make_dlrm(cube: Hypercube, *, batch_per_shard=64, emb_dim=32,
              n_tables=4, rows=512, algorithm="pidcomm", device=None,
              seed=None):
    """3D hypercube; the communication chain of paper Fig. 11."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    dims = cube.dim_names[-3:]
    x, y, z = dims
    c_xyz = cube.comm(dims)
    c_y = cube.comm((y,))
    c_xz = cube.comm((x, z))
    nx, ny, nz = (cube.size(d) for d in dims)
    G = nx * ny * nz
    Dl = max(emb_dim // nz, 1)
    F = n_tables * Dl
    b_l = max(batch_per_shard, G)             # divisible by G
    C1 = F * G // ny                          # after AA(xyz) + RS(y)
    C2 = C1 // (nx * nz)                      # after AA(xz) feature width
    cn = cube.ndim

    inputs = {"tables": _input((n_tables, rows, Dl), 1.0, gen, dev),
              "w0": _input((C2, 64), 0.01, gen, dev),
              "w1": _input((64, 1), 0.01, gen, dev, signed=False)}
    tables, w0, w1 = (_replicated(cube, inputs[k])
                      for k in ("tables", "w0", "w1"))
    idx = (torch.arange(b_l * n_tables, device=dev).reshape(n_tables, b_l)
           % rows)
    tbl = torch.arange(n_tables, device=dev)[:, None]

    def step():
        # each PE's lookup: emb[t] = tables[t, idx[t] % rows]
        emb = tables[..., tbl, idx % rows, :]           # (*cube, T, b_l, Dl)
        emb = emb.movedim(cn, cn + 1).reshape(cube.dim_sizes + (b_l, F))
        ex = c_xyz.all_to_all(emb, split_axis=0, concat_axis=1,
                              algorithm=algorithm)      # (b_l/G, F*G)
        red = c_y.reduce_scatter(ex, axis=1, op="add",
                                 algorithm=algorithm)   # (b_l/G, C1)
        rel = c_xz.all_to_all(red, split_axis=1, concat_axis=0,
                              algorithm=algorithm)      # (b_l/G*nx*nz, C2)
        h = torch.relu(cube_matmul(rel, w0, cn))
        out = cube_matmul(h, w1, cn)
        total = c_xyz.all_reduce(out.sum(dim=(-2, -1)), algorithm=algorithm)
        return _scalar(cube, total)

    step.inputs = inputs
    return step


# ------------------------------------------------------------------ GNN
def make_gnn(cube: Hypercube, *, n_nodes=2048, feat=256, variant="rs_ar",
             algorithm="pidcomm", device=None, seed=None):
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    r, c = cube.dim_names[-2:]
    nr, nc = cube.size(r), cube.size(c)
    c_c = cube.comm((c,))
    cn = cube.ndim

    inputs = {"adj": _input((n_nodes // nr, n_nodes // nc), 1.0 / n_nodes,
                            gen, dev, signed=False),
              "feats": _input((n_nodes // nc, feat), 1.0, gen, dev)}
    adj, feats = _replicated(cube, inputs["adj"]), _replicated(
        cube, inputs["feats"])

    if variant == "rs_ar":
        inputs["w"] = _input((feat // nc, feat), 0.01, gen, dev)
        w = _replicated(cube, inputs["w"])

        def run():
            agg = cube_matmul(adj, feats, cn)               # partial over c
            agg = c_c.reduce_scatter(agg, axis=1, op="add",
                                     algorithm=algorithm)
            comb = cube_matmul(agg, w, cn)                  # partial over c
            out = c_c.all_reduce(comb, algorithm=algorithm)
            return _scalar(cube, torch.relu(out).sum(dim=(-2, -1)))
    else:
        inputs["w"] = _input((feat, feat // nc), 0.01, gen, dev)
        w = _replicated(cube, inputs["w"])

        def run():
            agg = c_c.all_reduce(cube_matmul(adj, feats, cn),
                                 algorithm=algorithm)
            comb = cube_matmul(agg, w, cn)                  # 2D tiled result
            out = c_c.all_gather(comb, axis=1, algorithm=algorithm)
            return _scalar(cube, torch.relu(out).sum(dim=(-2, -1)))

    run.inputs = inputs
    return run


# ------------------------------------------------------------- BFS / CC
def make_bfs(cube: Hypercube, *, n_nodes=4096, iters=8, algorithm="pidcomm",
             device=None):
    dev = resolve_device(device)
    comm = cube.comm(cube.dim_names)
    n_l = n_nodes // cube.ndev
    adj = ((torch.arange(n_l, device=dev)[:, None] * 31
            + torch.arange(n_nodes, device=dev)[None] * 17)
           % 97 < 3).to(torch.float32)

    def run():
        visited = torch.zeros(cube.dim_sizes + (n_nodes,), device=dev)
        visited[..., 0] = 1.0
        for _ in range(iters):
            # each PE's (adj @ visited) > 0, adj held once for all PEs
            local = (visited @ adj.T > 0).to(torch.float32)
            upd = _place_at_member(cube, comm, local, 0.0)
            new = comm.all_reduce(upd, op="max", algorithm=algorithm)
            visited = torch.maximum(visited, new)
        return _scalar(cube, visited.sum(-1))

    return run


def make_cc(cube: Hypercube, *, n_nodes=4096, iters=8, algorithm="pidcomm",
            device=None):
    dev = resolve_device(device)
    comm = cube.comm(cube.dim_names)
    n_l = n_nodes // cube.ndev
    adj = ((torch.arange(n_l, device=dev)[:, None] * 13
            + torch.arange(n_nodes, device=dev)[None] * 7) % 89 < 3)
    big = float(n_nodes + 1)

    def run():
        labels = torch.arange(n_nodes, dtype=torch.float32,
                              device=dev).expand(cube.dim_sizes + (n_nodes,))
        for _ in range(iters):
            neigh = torch.where(adj, labels[..., None, :],
                                big).amin(dim=-1)           # (*cube, n_l)
            upd = _place_at_member(cube, comm, neigh, big)
            new = comm.all_reduce(upd, op="min", algorithm=algorithm)
            labels = torch.minimum(labels, new)
        return _scalar(cube, labels.sum(-1))

    return run


# ------------------------------------------------------------------ MLP
def make_mlp(cube: Hypercube, *, features=2048, layers=5, batch=64,
             algorithm="pidcomm", device=None, seed=None):
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    comm = cube.comm(cube.dim_names)
    f_l = features // cube.ndev
    inputs = {"x": _input((batch, f_l), 1.0, gen, dev),
              "ws": tuple(_input((f_l, features), 0.001, gen, dev)
                          for _ in range(layers))}
    ws = inputs["ws"]
    x = _replicated(cube, inputs["x"])

    def run():
        h = x                                               # (*cube, batch, f_l)
        for w in ws:
            full = torch.relu(h @ w)                        # partial (.., F)
            h = comm.reduce_scatter(full, axis=1, op="add",
                                    algorithm=algorithm)
        return _scalar(cube, h.sum(dim=(-2, -1)))

    run.inputs = inputs
    return run


APPS = {
    "dlrm": (make_dlrm, 3),
    "gnn_rs_ar": (lambda cube, **kw: make_gnn(cube, variant="rs_ar", **kw), 2),
    "gnn_ar_ag": (lambda cube, **kw: make_gnn(cube, variant="ar_ag", **kw), 2),
    "bfs": (make_bfs, 1),
    "cc": (make_cc, 1),
    "mlp": (make_mlp, 1),
}

__all__ = ["APPS", "make_bfs", "make_cc", "make_dlrm", "make_gnn",
           "make_mlp"]
