"""On-disk checkpoint layout: step directories, manifest v2, fingerprints.

The counterpart of ``repro.checkpoint.layout``, in NumPy and the standard
library. One directory per step, written to a ``.tmp`` sibling and renamed
into place, so a partially written checkpoint is never visible:

    <root>/step_00000100.tmp/   -> renamed atomically to step_00000100/
        manifest.json           # schema below
        arr_<i>.npy             # one file per leaf, flat-order index

The flat order is the sorted-key flatten of ``{"opt": ..., "params": ...}``
(``flatten``: the order of ``jax.tree.flatten`` on the JAX package's
dicts, a ``None`` node an empty subtree): opt leaves occupy a contiguous
prefix and params leaves a contiguous suffix, so a params-only consumer
(restore-for-serving) addresses its section without an optimizer-state
skeleton.

Manifest v2 records one entry per leaf -- tree path, global shape, NumPy
dtype name -- plus a structural fingerprint over those entries, so a
checkpoint of the same tree has the same manifest in both packages.
Restore validates the target structure against the records and raises an
architecture-mismatch error instead of mis-loading; v1 manifests (no
``leaves`` key) skip validation.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Sequence

import numpy as np

MANIFEST = "manifest.json"
FORMAT = 2

# step directories are exactly step_<8 digits>; anything else in the root
# (foreign files, leftover .tmp dirs from a killed writer) is ignored
_STEP_RE = re.compile(r"^step_(\d{8})$")


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def list_steps(root: str) -> list[int]:
    """Steps with a completed (renamed) directory under ``root``, sorted.

    Only ``step_<8 digits>`` *directories* count, so stray files, ``.tmp``
    debris from a killed writer and unrelated subdirectories never break
    enumeration.
    """
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return []
    out = []
    for d in entries:
        m = _STEP_RE.match(d)
        if m and os.path.isdir(os.path.join(root, d)):
            out.append(int(m.group(1)))
    return sorted(out)


# ------------------------------------------------------------- tree order
def flatten(tree, path: tuple = ()):
    """(path, leaf) pairs of nested dicts in flat order: keys sorted, a
    ``None`` node an empty subtree, anything else (a tensor, an array, a
    spec tuple) a leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], path + (k,))
    else:
        yield path, tree


def dtype_name(leaf) -> str:
    """The NumPy name of a leaf's dtype (``float32``, ``int8``,
    ``bfloat16``); a Python scalar takes JAX's 32-bit default."""
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return "float32" if isinstance(leaf, float) else "int32"
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else \
        str(np.dtype(dtype))


# ------------------------------------------------------------- leaf records
def leaf_records(tree) -> list[dict]:
    """One record per leaf in flat order: ``{"path", "shape", "dtype"}``.
    ``tree`` holds global arrays (the host side of a save)."""
    return [{"path": list(path),
             "shape": [int(s) for s in getattr(leaf, "shape", ())],
             "dtype": dtype_name(leaf)}
            for path, leaf in flatten(tree)]


def fingerprint(records: Sequence[dict]) -> str:
    """Structural sha1 over leaf paths + shapes + dtypes (not values)."""
    blob = json.dumps(list(records), sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def tree_from_paths(paths: Sequence[Sequence], values: Sequence[Any]):
    """Nested dicts holding ``values`` at ``paths`` (a single leaf at the
    empty path is returned as is)."""
    if len(paths) != len(values):
        raise ValueError(f"{len(paths)} paths vs {len(values)} values")
    root: dict = {}
    for path, val in zip(paths, values):
        if not path:
            return val
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return root


def validate_records(saved: Sequence[dict], target: Sequence[dict], *,
                     section: str, step: int) -> None:
    """Raise an architecture-mismatch error when the saved section's
    structure does not match the restore target's."""
    if len(saved) != len(target):
        raise ValueError(
            f"checkpoint step {step} holds {len(saved)} {section} leaves "
            f"but the target structure has {len(target)} -- architecture "
            "mismatch between save and restore")
    diffs = []
    for s, t in zip(saved, target):
        if list(s["path"]) != list(t["path"]) \
                or list(s["shape"]) != list(t["shape"]) \
                or str(s["dtype"]) != str(t["dtype"]):
            diffs.append(
                f"  saved {s['path']} {s['shape']} {s['dtype']}"
                f" != target {t['path']} {t['shape']} {t['dtype']}")
        if len(diffs) >= 5:
            diffs.append("  ...")
            break
    if diffs:
        raise ValueError(
            f"checkpoint step {step} {section} structure does not match the "
            "restore target -- architecture mismatch between save and "
            "restore:\n" + "\n".join(diffs))


# ---------------------------------------------------------------- manifest
def build_manifest(step: int, records: Sequence[dict], *, n_opt: int,
                   cube_dims: dict | None = None,
                   extra: dict | None = None) -> dict:
    return {
        "format": FORMAT,
        "step": step,
        "n_leaves": len(records),
        "sections": {"opt": n_opt, "params": len(records) - n_opt},
        "fingerprint": fingerprint(records),
        "leaves": list(records),
        "cube": dict(cube_dims) if cube_dims else None,
        "extra": extra or {},
    }


def sync_file(f) -> None:
    """Flush an open file to the disk and drop its pages from the page
    cache (a checkpoint is written once and read at restore, if ever)."""
    f.flush()
    os.fsync(f.fileno())
    if hasattr(os, "posix_fadvise"):
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)


def write_manifest(directory: str, manifest: dict) -> None:
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(manifest, f)
        sync_file(f)


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)


def atomic_finalize(tmp: str, final: str) -> None:
    """Publish ``tmp`` (its files already on the disk) as ``final``: a
    reader sees the old complete checkpoint or the new complete checkpoint,
    never a partial one, and after the parent directory's sync so does a
    reader after a crash."""
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    fd = os.open(os.path.dirname(os.path.abspath(final)), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


__all__ = [
    "FORMAT", "MANIFEST", "atomic_finalize", "build_manifest", "dtype_name",
    "fingerprint", "flatten", "leaf_records", "list_steps", "read_manifest",
    "step_dir", "sync_file", "tree_from_paths", "validate_records",
    "write_manifest",
]
