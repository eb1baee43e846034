"""Virtual hypercube of PEs held in one process (PID-Comm §IV).

The counterpart of ``repro.core.hypercube`` without a device mesh: the cube
is its dim names and sizes, and a tensor that lives on it carries the cube's
leading axes, ``(*dim_sizes, *per_pe_shape)`` -- entry ``x[i0, ..., ik]`` is
PE ``(i0, ..., ik)``'s local block, the global layout of the NumPy oracles
(``repro.testing.oracles``). The pod (DCN) domain is topology that the
planner reads: ``pods`` says how many pods the PE set spans, and the
entangled-group rule keeps every intra-pod group off the pod boundary.

Dimension sizes must be powers of two except the outermost (the paper allows
one non-power-of-two dimension, at the slowest level of the hierarchy).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _spec_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Hypercube:
    """A logical hypercube of ``prod(dim_sizes)`` virtual PEs.

    Attributes:
      dim_names: logical dimension names, outermost first.
      dim_sizes: logical dimension sizes, outermost first.
      dcn_dims: logical dims that live (partly) in the DCN (pod) domain.
    """

    dim_names: tuple[str, ...]
    dim_sizes: tuple[int, ...]
    dcn_dims: tuple[str, ...]

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(dims: Mapping[str, int], *,
              pods: int | None = None) -> "Hypercube":
        """The logical hypercube ``dims`` (outermost -> innermost) over a PE
        set spanning ``pods`` pods (default: the size of a dim named
        ``pod``, else 1), PEs numbered major -> minor (the paper's
        hierarchy-order mapping: pod -> ici axis -> chip)."""
        if pods is None:
            pods = int(dims.get("pod", 1))
        names = tuple(dims.keys())
        sizes = tuple(int(s) for s in dims.values())
        ndev = math.prod(sizes)
        for name, size in zip(names[1:], sizes[1:]):
            if not _is_pow2(size):
                raise ValueError(
                    f"dim {name!r}={size} must be a power of two (only the "
                    "outermost dimension may be non-power-of-two)")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dim names in {names}")
        if pods < 1 or ndev % pods:
            raise ValueError(f"{ndev} PEs do not split into {pods} pods")

        # Entangled-group rule: the pod boundary must coincide with a logical
        # dim boundary -- PEs per pod is the product of a suffix of the dims.
        devices_per_pod = ndev // pods
        suffix = 1
        suffixes = {1}
        for s in reversed(sizes):
            suffix *= s
            suffixes.add(suffix)
        if devices_per_pod not in suffixes:
            raise ValueError(
                f"hypercube {dict(dims)} splits the pod boundary "
                f"({devices_per_pod} devices/pod is not a suffix product of "
                f"{sizes}); intra-pod groups would straddle DCN")

        # dims whose inner extent reaches a whole pod touch the DCN domain
        dcn_dims = []
        inner = 1
        for name, size in zip(reversed(names), reversed(sizes)):
            if inner >= devices_per_pod and size > 1:
                dcn_dims.append(name)
            inner *= size
        return Hypercube(dim_names=names, dim_sizes=sizes,
                         dcn_dims=tuple(reversed(dcn_dims)))

    # ------------------------------------------------------------- selections
    def dims_from_bitmap(self, bitmap: str) -> tuple[str, ...]:
        """PID-Comm dim selection, e.g. "010" -> the middle dimension
        (ordered like ``dim_names``, outermost first)."""
        if len(bitmap) != len(self.dim_names) or set(bitmap) - {"0", "1"}:
            raise ValueError(
                f"bitmap {bitmap!r} invalid for dims {self.dim_names}")
        sel = tuple(n for n, b in zip(self.dim_names, bitmap) if b == "1")
        if not sel:
            raise ValueError("empty dim selection")
        return sel

    def resolve_dims(self, dims) -> tuple[str, ...]:
        """Accept a bitmap string, a single name, or a sequence of names."""
        if isinstance(dims, str):
            if set(dims) <= {"0", "1"} and len(dims) == len(self.dim_names):
                return self.dims_from_bitmap(dims)
            if dims in self.dim_names:
                return (dims,)
            raise ValueError(f"unknown dim selection {dims!r}")
        sel = tuple(dims)
        for d in sel:
            if d not in self.dim_names:
                raise ValueError(f"unknown dim {d!r}; have {self.dim_names}")
        # preserve hypercube (major->minor) order regardless of input order
        return tuple(d for d in self.dim_names if d in sel)

    def group_size(self, dims) -> int:
        return math.prod(self.size(d) for d in self.resolve_dims(dims))

    def num_instances(self, dims) -> int:
        """Number of independent communication groups (cube slices)."""
        return self.ndev // self.group_size(dims)

    def size(self, name: str) -> int:
        return self.dim_sizes[self.dim_names.index(name)]

    def crosses_dcn(self, dims) -> bool:
        return any(d in self.dcn_dims for d in self.resolve_dims(dims))

    def split_fast_slow(self, dims) -> tuple[tuple[str, ...], tuple[str, ...]]:
        """Partition selected dims into (ICI dims, DCN dims)."""
        sel = self.resolve_dims(dims)
        fast = tuple(d for d in sel if d not in self.dcn_dims)
        slow = tuple(d for d in sel if d in self.dcn_dims)
        return fast, slow

    # ---------------------------------------------------------- communicator
    def comm(self, dims):
        """Bind a :class:`repro_torch.core.comm.Communicator` to a dim
        selection."""
        from repro_torch.core.comm import Communicator  # deferred: cycle
        return Communicator(self, dims)

    def program(self, *, name: str = ""):
        """Open a :class:`repro_torch.core.program.CommProgram` recording
        scope over this cube."""
        from repro_torch.core.program import CommProgram  # deferred: cycle
        return CommProgram(self, name=name)

    # ---------------------------------------------------------------- layout
    @property
    def ndim(self) -> int:
        return len(self.dim_sizes)

    @property
    def ndev(self) -> int:
        return math.prod(self.dim_sizes)

    def axis_index(self, dims, device=None) -> torch.Tensor:
        """Each PE's linearized index within its group over ``dims``, as an
        int64 tensor of shape ``dim_sizes`` (the in-process form of
        ``lax.axis_index``: member order is cube-major over the dims)."""
        idx = torch.zeros((), dtype=torch.int64, device=device)
        for d in self.resolve_dims(dims):
            a = self.dim_names.index(d)
            shape = [1] * self.ndim
            shape[a] = self.dim_sizes[a]
            idx = idx * self.dim_sizes[a] + torch.arange(
                self.dim_sizes[a], device=device).view(shape)
        return idx.expand(self.dim_sizes)

    def local_shape(self, shape, spec) -> tuple[int, ...]:
        """Per-PE block shape of a global ``shape`` under ``spec`` (one entry
        per axis: None / dim name / tuple of names; missing ones None)."""
        entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        out = []
        for axis, (n, e) in enumerate(zip(shape, entries)):
            g = math.prod(self.size(d) for d in _spec_names(e))
            if n % g:
                raise ValueError(f"axis {axis} of {tuple(shape)} not "
                                 f"divisible by {g} (spec entry {e!r})")
            out.append(n // g)
        return tuple(out)

    def _split_plan(self, ndim: int, spec):
        entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
        if len(entries) != ndim:
            raise ValueError(f"spec {spec} longer than rank {ndim}")
        names_at: list[str | None] = []
        for e in entries:
            names_at += list(_spec_names(e)) + [None]
        used = [n for n in names_at if n is not None]
        if len(set(used)) != len(used) or set(used) - set(self.dim_names):
            raise ValueError(f"bad spec {spec} for dims {self.dim_names}")
        return entries, names_at

    def to_cube(self, x: torch.Tensor, spec) -> torch.Tensor:
        """Place a global tensor on the cube under ``spec``: the result is
        ``(*dim_sizes, *local_shape)``, PE ``c`` holding the block a
        ``NamedSharding`` with this spec would give it (multi-name entries
        linearize with the first name slowest). Dims the spec does not name
        replicate as a stride-0 view: the result is read-only there."""
        y = self.place(x, spec)
        return y.expand(self.dim_sizes + tuple(y.shape[self.ndim:]))

    def place(self, x: torch.Tensor, spec) -> torch.Tensor:
        """:meth:`to_cube` before the replication: dims the spec does not
        name keep size 1 (a contiguous tensor)."""
        entries, names_at = self._split_plan(x.dim(), spec)
        local = self.local_shape(x.shape, spec)
        split = []
        for n, e in zip(local, entries):
            split += [self.size(d) for d in _spec_names(e)] + [n]
        y = x.reshape(split)
        cube_pos = {n: i for i, n in enumerate(names_at) if n is not None}
        perm = [cube_pos[d] for d in self.dim_names if d in cube_pos]
        perm += [i for i, n in enumerate(names_at) if n is None]
        y = y.permute(perm).contiguous()
        for a, d in enumerate(self.dim_names):
            if d not in cube_pos:
                y = y.unsqueeze(a)
        return y

    def from_cube(self, x: torch.Tensor, spec) -> torch.Tensor:
        """Assemble the global tensor from cube layout under ``spec`` (the
        inverse of :meth:`to_cube`; replicated dims read PE 0's copy)."""
        nc = self.ndim
        entries, names_at = self._split_plan(x.dim() - nc, spec)
        cube_pos = {n: i for i, n in enumerate(names_at) if n is not None}
        for a in reversed(range(nc)):
            if self.dim_names[a] not in cube_pos:
                x = x.select(a, 0)
        order = [cube_pos[d] for d in self.dim_names if d in cube_pos]
        order += [i for i, n in enumerate(names_at) if n is None]
        inv = sorted(range(len(order)), key=order.__getitem__)
        y = x.permute(inv)
        glob = []
        for j, e in enumerate(entries):
            glob.append(x.shape[x.dim() - len(entries) + j] * math.prod(
                self.size(d) for d in _spec_names(e)))
        return y.reshape(glob)

    def describe(self) -> str:
        parts = [f"{n}={s}" for n, s in zip(self.dim_names, self.dim_sizes)]
        return f"Hypercube[{','.join(parts)}; dcn={self.dcn_dims or '()'}]"
