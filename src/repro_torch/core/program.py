"""Deferred CommProgram IR: record -> optimize -> execute collective programs.

The counterpart of ``repro.core.program`` over the port's in-process cube:
values are cube tensors ``(*cube.dim_sizes, *payload)`` (host values for
the rooted scatter / broadcast), avals carry the full shape and a torch
dtype, and a coalesced bucket concatenates each PE's flattened payloads
along the last axis (``torch.cat`` where the reference concatenates the
local shards).

PID-Comm's headline gains come from *composed* communication -- applications
chain reduce_scatter / all_gather / all_to_all across hypercube dims, and the
framework wins by scheduling the whole pattern rather than one primitive at a
time (paper SVII apps, SIX-A hierarchy).  The eager ``Communicator`` plans
each call in isolation; this module adds the whole-program surface:

  recording
      ``cube.program()`` / ``comm.program()`` / ``topo.program()`` open a
      scope in which every ``Communicator`` primitive appends a
      :class:`CommOp` (abstract shape/dtype, group bitmap, data deps)
      instead of dispatching, and returns a symbolic :class:`ProgramValue`.
      Concrete tensors and arrays passed into a primitive are captured as
      program *constants*; ``prog.input(aval)`` declares
      placeholders bound positionally at ``execute(*inputs)``.

  ``program.lower()``
      runs the optimization pipeline:
        * peephole fusion -- a ``reduce_scatter`` whose only consumer is an
          ``all_gather`` on the same axis/group becomes one ``all_reduce``
          (and the reverse split when the cost model strictly prefers it);
        * same-group coalescing -- independent small all-reduces on the same
          (group, op, dtype, algorithm) flatten/concat into one bucketed
          dispatch;
        * joint planning -- one :func:`repro_torch.core.planner.plan_program`
          pass estimating every op's bytes and choosing an explicit
          interleaving order for independent ops.

  execution
      ``program.execute(*inputs)`` runs the optimized schedule through the
      existing algorithm registry (each op dispatches via
      ``Communicator._dispatch``, so stage resolution, planner estimates and
      CommTrace instrumentation are identical to the eager path); every
      emitted :class:`~repro_torch.core.comm.CommEvent` carries this program's
      ``program_id`` and the ``fused_from`` provenance of rewritten ops.
      ``execute_async()`` returns per-op :class:`CommFuture` s backed by
      dependency-ordered dispatch.

Eager single-op calls remain supported -- a one-op program executes the
identical registry body, so the conformance matrix is bit-identical through
both paths.

Repeated recordings with identical op structure (the serving engine's
per-step program, any re-recorded ``comm.program()`` scope) reuse one cached
lowered schedule -- rewrite passes, coalescing buckets and the joint plan
run once per structural fingerprint, not once per program instance (see
``_LOWER_CACHE`` / ``LOWER_STATS``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import threading
import weakref
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import comm as _comm
from repro_torch.core import planner
from repro_torch.telemetry import metrics as _telemetry
from repro_torch.telemetry import spans as _spans

# Coalescing folds all-reduces at or below this per-device payload into one
# bucketed dispatch (gradient-leaf scale; large tensors keep their own op).
DEFAULT_COALESCE_BYTES = 1 << 20

_PROGRAM_IDS = itertools.count()

# -------------------------------------------------- cross-program reuse
# Two programs with the same *structure* (op graph, avals, input/output
# wiring) lower to the same optimized schedule, so re-lowering every
# instance -- the serving engine records a fresh program every step --
# redoes identical rewrite passes, bucket construction and joint
# planning.  ``lower()`` therefore consults a cache keyed by the program's
# structural fingerprint plus everything else that shapes the result: the
# lowering knobs and the installed profile's content token (a plan priced
# under one profile must not serve another).  A hit rebinds the cached
# schedule to the new program, so its constants (e.g. the fresh step's
# control state) are picked up at execution while the ops, coalescing
# buckets and ProgramPlan are reused verbatim.
#
# Lifetime: cached entries hold *program-less* LoweredPrograms (retaining
# the recording program would pin its captured constants -- per-step
# host arrays, device tensors -- indefinitely), and the cache dict
# itself lives ON the cube object rather than in a module global: the
# cached ops reference the cube through their communicators anyway, so a
# module-level cache would pin every cube ever lowered against; attached
# to the cube, a discarded cube and its schedules form an internal cycle
# the garbage collector reclaims together.
_LOWER_CACHE_MAX = 256
# cubes holding a cache, by identity: equal cubes are distinct caches
_CACHED_CUBES: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()

# observability: how many schedules were actually built vs reused (the
# serving engine reads the per-step delta; tests assert reuse strictly
# reduces work)
LOWER_STATS = {"lowered": 0, "cache_hits": 0}


def _cube_lower_cache(cube) -> dict:
    cache = getattr(cube, "_lower_cache", None)
    if cache is None:
        cache = {}
        # Hypercube is a frozen dataclass; attach the mutable cache the
        # same way frozen __init__ does
        object.__setattr__(cube, "_lower_cache", cache)
        _CACHED_CUBES[id(cube)] = cube
    return cache


def clear_lower_cache() -> None:
    for cube in list(_CACHED_CUBES.values()):
        getattr(cube, "_lower_cache", {}).clear()


# Stack of CommPrograms currently recording.  ``Communicator._dispatch``
# consults :func:`active_program` on every call; execution temporarily
# suspends recording so a program can be executed from inside another scope.
# Both the stack and the suspension counter are thread-local: a background
# executor running a lowered program must not suppress — or record into — a program being built concurrently
# on the main thread.
_TLS = threading.local()


def _tls_state() -> "threading.local":
    if not hasattr(_TLS, "recording"):
        _TLS.recording = []  # list[CommProgram]
        _TLS.suspended = 0
    return _TLS


def active_program() -> "CommProgram | None":
    """The innermost recording scope on this thread, or None (also None
    mid-execution)."""
    tls = _tls_state()
    if tls.suspended or not tls.recording:
        return None
    return tls.recording[-1]


class _suspend_recording:
    def __enter__(self):
        _tls_state().suspended += 1

    def __exit__(self, *exc):
        _tls_state().suspended -= 1
        return False


# ------------------------------------------------------------------- values
class Aval(NamedTuple):
    """Abstract value: the full shape (cube axes included for a cube
    tensor) and a torch dtype."""
    shape: tuple
    dtype: torch.dtype


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class ProgramValue:
    """Symbolic SSA value inside a :class:`CommProgram` (abstract aval only).

    Mimics enough of the tensor protocol (shape/dtype/size/ndim/dim) that
    shape checks and payload accounting treat it like the tensor it stands
    for.
    """

    __slots__ = ("program", "vid")

    def __init__(self, program: "CommProgram", vid: int):
        self.program = program
        self.vid = vid

    @property
    def aval(self):
        return self.program._avals[self.vid]

    @property
    def shape(self):
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype

    @property
    def ndim(self) -> int:
        return len(self.aval.shape)

    def dim(self) -> int:
        return len(self.aval.shape)

    @property
    def size(self) -> int:
        return math.prod(self.aval.shape)

    def __repr__(self):
        return (f"ProgramValue(v{self.vid}: "
                f"{self.dtype}{list(self.shape)} of {self.program.program_id})")


def _aval_of(x) -> Aval:
    shape = tuple(int(n) for n in getattr(x, "shape", ()))
    dtype = getattr(x, "dtype", None)
    return Aval(shape, _torch_dtype(dtype if dtype is not None
                                    else torch.float32))


def _result_aval(comm, primitive: str, aval: Aval, kwargs) -> Aval:
    """Abstract output of one primitive (shape inference). PE<->PE
    primitives and gather / reduce take a cube tensor (payload axes follow
    the cube's); scatter / broadcast take a host value."""
    shape = list(aval.shape)
    cn, g = comm.cube.ndim, comm.group_size
    npay = len(shape) - cn

    def ax(name):
        return cn + kwargs[name] % npay

    if primitive == "all_reduce":
        pass
    elif primitive == "broadcast":
        shape = list(comm.cube.dim_sizes) + shape
    elif primitive == "scatter":
        if kwargs.get("spec") is not None:
            local = comm.cube.local_shape(tuple(shape), kwargs["spec"])
        else:
            a = kwargs["axis"] % len(shape)
            if shape[a] % g:
                raise ValueError(
                    f"scatter axis {a} of {tuple(shape)} not divisible by "
                    f"group size {g}")
            local = shape[:a] + [shape[a] // g] + shape[a + 1:]
        shape = list(comm.cube.dim_sizes) + list(local)
    elif primitive in ("gather", "reduce"):
        shape = list(_comm.host_shape(comm, tuple(shape), kwargs))
        if primitive == "reduce":
            del shape[kwargs["axis"] % len(shape)]
    elif primitive == "reduce_scatter":
        a = ax("axis")
        if shape[a] % g:
            raise ValueError(
                f"reduce_scatter axis {a - cn} of {tuple(shape[cn:])} not "
                f"divisible by group size {g}")
        shape[a] //= g
    elif primitive == "all_gather":
        shape[ax("axis")] *= g
    elif primitive == "all_to_all":
        s, c = ax("split_axis"), ax("concat_axis")
        if shape[s] % g:
            raise ValueError(
                f"all_to_all split axis {s - cn} of {tuple(shape[cn:])} not "
                f"divisible by group size {g}")
        shape[s] //= g
        shape[c] *= g
    else:
        raise ValueError(f"unknown primitive {primitive!r}")
    return Aval(tuple(shape), aval.dtype)


# ---------------------------------------------------------------------- ops
@dataclasses.dataclass
class CommOp:
    """One recorded (or rewritten) collective in the program IR."""
    op_id: int
    primitive: str
    comm: Any                      # repro_torch.core.comm.Communicator
    algorithm: str                 # requested ("auto", stage, registered)
    op: str                        # reducer name for reduction primitives
    kwargs: dict                   # axis / split_axis / concat_axis
    in_vids: tuple[int, ...]
    out_vids: tuple[int, ...]
    fused_from: tuple[int, ...] = ()   # provenance: recorded op ids
    coalesced: bool = False
    # multi-dim all_to_all chain (§VII DLRM pattern): per-stage
    # (communicator, kwargs, algorithm) triples.  A chained op is ONE IR op
    # -- jointly planned over the union of its dims -- whose execution
    # dispatches the stages in order, because the sequential per-dim chain
    # is what the recorded program computed (a single joint multi-dim
    # all_to_all permutes blocks differently and is NOT bit-identical).
    chain: tuple = ()

    @property
    def bitmap(self) -> str:
        return self.comm.bitmap

    def describe(self, program: "CommProgram") -> str:
        ins = ",".join(f"v{v}" for v in self.in_vids)
        outs = ",".join(f"v{v}" for v in self.out_vids)
        tag = ""
        if self.fused_from:
            kind = "coalesced" if self.coalesced else (
                "chained" if self.chain else "fused")
            tag = f" [{kind} from {list(self.fused_from)}]"
        return (f"op{self.op_id}: {outs} = {self.primitive}"
                f"[{self.bitmap}/{self.algorithm}]({ins}){tag}")


# ------------------------------------------------------------------ program
class CommProgram:
    """A recorded collective program over one hypercube.

    Use as a context manager; inside the scope every bound
    :class:`~repro_torch.core.comm.Communicator` of the same cube appends ops here
    instead of dispatching.  ``lower()`` optimizes + plans, ``execute()``
    runs the optimized schedule (lowering on first use).
    """

    def __init__(self, cube, *, name: str = ""):
        self.cube = cube
        self.program_id = name or f"prog{next(_PROGRAM_IDS)}"
        self._avals: list[Aval] = []
        self._consts: dict[int, Any] = {}
        self._input_vids: list[int] = []
        self._output_vids: list[int] = []
        self._ops: list[CommOp] = []
        self._open = False
        self._closed = False
        self._lowered: "LoweredProgram | None" = None

    # ------------------------------------------------------------ recording
    def __enter__(self) -> "CommProgram":
        if self._closed:
            raise RuntimeError(f"{self.program_id} already recorded")
        _tls_state().recording.append(self)
        self._open = True
        return self

    def __exit__(self, *exc):
        _tls_state().recording.remove(self)
        self._open = False
        self._closed = True
        return False

    def _new_value(self, aval) -> ProgramValue:
        self._avals.append(aval)
        return ProgramValue(self, len(self._avals) - 1)

    def input(self, x) -> ProgramValue:
        """Declare a positional input placeholder.  ``x`` is an
        :class:`Aval`, a tensor or array to take shape/dtype from, or a
        ``(shape, dtype)`` pair (a cube tensor's shape leads with the cube's
        axes)."""
        if isinstance(x, tuple) and len(x) == 2 and not hasattr(x, "dtype"):
            aval = Aval(tuple(int(n) for n in x[0]), _torch_dtype(x[1]))
        else:
            aval = _aval_of(x)
        v = self._new_value(aval)
        self._input_vids.append(v.vid)
        return v

    def output(self, *values: ProgramValue) -> None:
        """Declare program outputs (in ``execute`` return order).  Without
        any declaration, every op result not consumed by another op is an
        output, in creation order."""
        for v in values:
            if not isinstance(v, ProgramValue) or v.program is not self:
                raise ValueError(f"{v!r} is not a value of this program")
            self._output_vids.append(v.vid)

    def record_op(self, comm, primitive: str, x, *, algorithm: str,
                  op: str = "add", kwargs: dict | None = None
                  ) -> ProgramValue:
        """Append one op (called by ``Communicator._dispatch`` while this
        scope is active).  Non-ProgramValue payloads are captured as
        constants, bound at record time."""
        if not self._open:
            raise RuntimeError(f"{self.program_id} is not recording")
        if comm.cube is not self.cube:
            raise ValueError(
                f"communicator {comm.describe()} is bound to a different "
                f"cube than program {self.program_id}")
        kwargs = dict(kwargs or {})
        if isinstance(x, ProgramValue):
            if x.program is not self:
                raise ValueError(
                    f"value of {x.program.program_id} used inside "
                    f"{self.program_id}")
            vin = x.vid
        else:
            v = self._new_value(_aval_of(x))
            self._consts[v.vid] = x
            vin = v.vid
        out = self._new_value(
            _result_aval(comm, primitive, self._avals[vin], kwargs))
        self._ops.append(CommOp(
            op_id=len(self._ops), primitive=primitive, comm=comm,
            algorithm=algorithm, op=op, kwargs=kwargs,
            in_vids=(vin,), out_vids=(out.vid,)))
        return out

    # ------------------------------------------------------------- lowering
    def _default_outputs(self) -> tuple[int, ...]:
        if self._output_vids:
            return tuple(self._output_vids)
        consumed = {v for o in self._ops for v in o.in_vids}
        return tuple(v for o in self._ops for v in o.out_vids
                     if v not in consumed)

    def structural_fingerprint(self) -> str:
        """Stable hash of everything the lowering pipeline reads from this
        program *except* constant values: the op graph (primitive, dims,
        algorithm, reducer, kwargs, SSA wiring), every value's aval, and
        the input/output declarations.  Two programs with equal
        fingerprints lower to interchangeable schedules, which is what
        keys cross-program reuse (the serving engine records fresh control
        state as constants every step, but the structure never changes)."""
        blob = json.dumps({
            "avals": [(list(a.shape), str(a.dtype)) for a in self._avals],
            "consts": sorted(self._consts),
            "inputs": self._input_vids,
            "outputs": list(self._default_outputs()),
            "ops": [(o.primitive, list(o.comm.dims), o.algorithm, o.op,
                     sorted(o.kwargs.items()), list(o.in_vids),
                     list(o.out_vids))
                    for o in self._ops],
        }, sort_keys=True, default=str).encode()
        return hashlib.sha1(blob).hexdigest()

    def lower(self, *, fuse: bool = True, coalesce: bool = True,
              coalesce_bytes: int = DEFAULT_COALESCE_BYTES,
              split_all_reduce: str | bool = "cost",
              merge_a2a: bool = True, reuse: bool = True
              ) -> "LoweredProgram":
        """Optimize + jointly plan the recorded ops.

        ``split_all_reduce``: ``False`` never rewrites, ``True`` always
        splits an all_reduce into rs+ag (when the leading axis divides), and
        ``"cost"`` (default) splits only when the planner's estimate is
        strictly cheaper: fewer seconds where an installed profile prices
        all three flows, else fewer DCN bytes, then fewer ICI bytes -- on
        the byte model the flat split ties the fused collective, so there
        "cost" keeps the fused form.

        ``merge_a2a``: merge consecutive all_to_all ops over disjoint
        hypercube dims into one jointly-planned multi-dim chain op (§VII
        DLRM pattern); execution stays the bit-identical sequential chain.

        ``reuse``: consult the cross-program lower cache -- a structurally
        identical program lowered earlier (same cube, same knobs, same
        installed profile) hands back its schedule rebound to this
        program's constants instead of re-running the passes.
        """
        if self._open:
            raise RuntimeError(
                f"{self.program_id} is still recording; lower() after the "
                "with-block closes")
        key = cache = None
        # None: a profile without a content token, which disables caching
        token = planner.profile_token() if reuse else None
        if reuse and token is not None:
            cache = _cube_lower_cache(self.cube)
            key = (self.structural_fingerprint(), fuse, coalesce,
                   coalesce_bytes, str(split_all_reduce), merge_a2a, token)
            hit = cache.get(key)
            if hit is not None:
                LOWER_STATS["cache_hits"] += 1
                _telemetry.inc("program.lower_cache_hits")
                _spans.maybe_instant("lower-cache-hit",
                                     program_id=self.program_id)
                return dataclasses.replace(hit, program=self)
        LOWER_STATS["lowered"] += 1
        _telemetry.inc("program.lowered")
        with _spans.maybe_span(f"lower:{self.program_id}", cat="trace",
                               program_id=self.program_id,
                               ops=len(self._ops)):
            ops = [dataclasses.replace(o) for o in self._ops]
            out_vids = self._default_outputs()
            if fuse:
                ops = _fuse_rs_ag(self, ops, out_vids)
            if split_all_reduce:
                ops = _split_all_reduce(self, ops, mode=split_all_reduce)
            if merge_a2a:
                ops = _merge_all_to_all(self, ops, out_vids)
            if coalesce:
                ops = _coalesce(self, ops, max_bytes=coalesce_bytes)
            if _telemetry.enabled():
                for o in ops:
                    if not o.fused_from:
                        continue
                    if o.coalesced:
                        _telemetry.inc("program.coalesced_ops")
                    elif o.chain:
                        _telemetry.inc("program.chained_ops")
                    else:
                        _telemetry.inc("program.fused_ops")
            produced = (set(self._consts) | set(self._input_vids)
                        | {v for o in ops for v in o.out_vids})
            lost = [v for v in out_vids if v not in produced]
            if lost:
                raise RuntimeError(
                    f"lowering {self.program_id} lost output values {lost} "
                    "(optimization-pass bug)")
            plan = planner.plan_program(self.cube, [
                planner.ProgramOpSpec(
                    op_id=o.op_id, primitive=o.primitive, dims=o.comm.dims,
                    payload_bytes=_op_payload_bytes(self, o),
                    deps=_dep_ids(o, ops), algorithm=o.algorithm, op=o.op)
                for o in ops])
        order = {oid: i for i, oid in enumerate(plan.order)}
        ops = sorted(ops, key=lambda o: order[o.op_id])
        lowered = LoweredProgram(program=self, ops=tuple(ops), plan=plan,
                                 out_vids=out_vids)
        if key is not None:
            if len(cache) >= _LOWER_CACHE_MAX:
                cache.pop(next(iter(cache)))
            cache[key] = dataclasses.replace(lowered, program=None)
        return lowered

    # ------------------------------------------------------------ execution
    def _lowered_default(self) -> "LoweredProgram":
        if self._lowered is None:
            self._lowered = self.lower()
        return self._lowered

    def execute(self, *inputs):
        """Lower (with default pipeline) and run; returns the tuple of
        program outputs (a single value is returned bare)."""
        return self._lowered_default().execute(*inputs)

    def execute_async(self, *inputs) -> "ProgramExecution":
        return self._lowered_default().execute_async(*inputs)

    def describe(self) -> str:
        lines = [f"CommProgram[{self.program_id} on {self.cube.describe()} "
                 f"ops={len(self._ops)} inputs={len(self._input_vids)}]"]
        lines += ["  " + o.describe(self) for o in self._ops]
        return "\n".join(lines)


def _op_payload_bytes(program: CommProgram, op: CommOp) -> int:
    total = 0
    for v in op.in_vids:
        aval = program._avals[v]
        total += _comm.payload_bytes(op.comm, op.primitive, aval.shape,
                                     aval.dtype.itemsize, op.kwargs)
    return total


def _dep_ids(op: CommOp, ops: Sequence[CommOp]) -> tuple[int, ...]:
    producers = {v: o.op_id for o in ops for v in o.out_vids}
    return tuple(sorted({producers[v] for v in op.in_vids if v in producers}))


# ------------------------------------------------------- optimization passes
def _consumers(ops: Sequence[CommOp]) -> dict[int, list[CommOp]]:
    by_vid: dict[int, list[CommOp]] = {}
    for o in ops:
        for v in o.in_vids:
            by_vid.setdefault(v, []).append(o)
    return by_vid

def _next_op_id(ops: Sequence[CommOp], program: CommProgram) -> int:
    return max([o.op_id for o in ops] + [len(program._ops) - 1]) + 1


def _origin_ids(op: CommOp) -> tuple[int, ...]:
    """The *recorded* op ids behind ``op`` -- the fused_from contract always
    points at program._ops indices, so a rewrite of a rewrite chains its
    members' origins rather than the intermediate synthetic id."""
    return op.fused_from if op.fused_from else (op.op_id,)


def _fuse_rs_ag(program: CommProgram, ops: list[CommOp],
                out_vids: tuple[int, ...]) -> list[CommOp]:
    """Peephole: reduce_scatter -> all_gather on the same axis and group is
    one all_reduce (paper Table I algebra: AG(RS(x)) = AR(x))."""
    changed = True
    while changed:
        changed = False
        cons = _consumers(ops)
        for a in ops:
            if a.primitive != "reduce_scatter" or a.coalesced:
                continue
            v = a.out_vids[0]
            if v in out_vids:               # the shard itself is a result
                continue
            users = cons.get(v, [])
            if len(users) != 1:
                continue
            b = users[0]
            if (b.primitive != "all_gather" or b.comm.cube is not a.comm.cube
                    or b.comm.dims != a.comm.dims
                    or b.kwargs.get("axis") != a.kwargs.get("axis")):
                continue
            alg = a.algorithm if a.algorithm == b.algorithm else "auto"
            fused = CommOp(
                op_id=_next_op_id(ops, program), primitive="all_reduce",
                comm=a.comm, algorithm=alg, op=a.op, kwargs={},
                in_vids=a.in_vids, out_vids=b.out_vids,
                fused_from=_origin_ids(a) + _origin_ids(b))
            i = ops.index(a)
            ops = [o for o in ops if o is not a and o is not b]
            ops.insert(i, fused)
            changed = True
            break
    return ops


def _merge_all_to_all(program: CommProgram, ops: list[CommOp],
                      out_vids: tuple[int, ...]) -> list[CommOp]:
    """Peephole (§VII DLRM): consecutive all_to_all ops whose dim
    selections are *disjoint* -- the embedding-exchange chains that walk one
    hypercube dim group after another -- merge into one multi-dim chain op,
    planned jointly over the union of the dims.

    The merged op keeps sequential per-stage execution (see
    :class:`CommOp.chain`): a single joint all_to_all over the combined
    dims orders blocks differently, so chaining is the only rewrite that
    stays bit-identical to the unfused program.
    """
    changed = True
    while changed:
        changed = False
        cons = _consumers(ops)
        for a in ops:
            if a.primitive != "all_to_all" or a.coalesced:
                continue
            v = a.out_vids[0]
            if v in out_vids:           # the intermediate is a result
                continue
            users = cons.get(v, [])
            if len(users) != 1:
                continue
            b = users[0]
            if (b.primitive != "all_to_all" or b.coalesced
                    or b.comm.cube is not a.comm.cube
                    or set(a.comm.dims) & set(b.comm.dims)):
                continue
            chain = (a.chain or ((a.comm, a.kwargs, a.algorithm),)) \
                + (b.chain or ((b.comm, b.kwargs, b.algorithm),))
            union = tuple(d for d in a.comm.cube.dim_names
                          if d in a.comm.dims + b.comm.dims)
            merged = CommOp(
                op_id=_next_op_id(ops, program), primitive="all_to_all",
                comm=a.comm.cube.comm(union),
                algorithm=a.algorithm if a.algorithm == b.algorithm
                else "auto",
                op=a.op, kwargs={},     # per-stage kwargs live in the chain
                in_vids=a.in_vids, out_vids=b.out_vids,
                fused_from=_origin_ids(a) + _origin_ids(b), chain=chain)
            i = ops.index(a)
            ops = [o for o in ops if o is not a and o is not b]
            ops.insert(i, merged)
            changed = True
            break
    return ops


def _split_all_reduce(program: CommProgram, ops: list[CommOp],
                      *, mode) -> list[CommOp]:
    """Reverse rewrite: all_reduce -> reduce_scatter + all_gather over the
    first group-divisible axis, taken when the planner strictly prefers the
    split (fewer seconds where the installed profile prices all three,
    else fewer bytes), or always under ``mode=True``.  Ops created by
    fusion are left alone."""
    out = []
    for o in ops:
        aval = program._avals[o.in_vids[0]]
        g = o.comm.group_size
        payload = aval.shape[program.cube.ndim:]
        axis = next((i for i, n in enumerate(payload)
                     if n >= g and n % g == 0), None)
        eligible = (o.primitive == "all_reduce" and not o.fused_from
                    and not o.coalesced and axis is not None)
        if eligible and mode == "cost":
            payload = _op_payload_bytes(program, o)
            ar = planner.estimate(program.cube, "all_reduce", o.comm.dims,
                                  payload)
            rs = planner.estimate(program.cube, "reduce_scatter",
                                  o.comm.dims, payload)
            ag = planner.estimate(program.cube, "all_gather", o.comm.dims,
                                  payload / g)
            if None in (ar.seconds, rs.seconds, ag.seconds):
                eligible = ((rs.dcn_bytes + ag.dcn_bytes, rs.ici_bytes
                             + ag.ici_bytes) < (ar.dcn_bytes, ar.ici_bytes))
            else:       # all three priced by the installed profile
                eligible = rs.seconds + ag.seconds < ar.seconds
        if not eligible:
            out.append(o)
            continue
        shard = program._new_value(_result_aval(
            o.comm, "reduce_scatter", aval, {"axis": axis}))
        nid = _next_op_id(ops + out, program)
        out.append(CommOp(
            op_id=nid, primitive="reduce_scatter", comm=o.comm,
            algorithm=o.algorithm, op=o.op, kwargs={"axis": axis},
            in_vids=o.in_vids, out_vids=(shard.vid,),
            fused_from=_origin_ids(o)))
        out.append(CommOp(
            op_id=nid + 1, primitive="all_gather", comm=o.comm,
            algorithm=o.algorithm, op="add", kwargs={"axis": axis},
            in_vids=(shard.vid,), out_vids=o.out_vids,
            fused_from=_origin_ids(o)))
    return out


def _reachable(frm: CommOp, to: CommOp, producers, by_id) -> bool:
    """True when ``to`` transitively consumes a value produced by ``frm``."""
    stack, seen = [to], set()
    while stack:
        cur = stack.pop()
        if cur.op_id == frm.op_id:
            return True
        if cur.op_id in seen:
            continue
        seen.add(cur.op_id)
        for v in cur.in_vids:
            p = producers.get(v)
            if p is not None:
                stack.append(by_id[p])
    return False


def _coalesce(program: CommProgram, ops: list[CommOp],
              *, max_bytes: int) -> list[CommOp]:
    """Flatten independent small same-group all-reduces into one bucketed
    dispatch per (dims, reducer, dtype, requested algorithm)."""
    producers = {v: o.op_id for o in ops for v in o.out_vids}
    by_id = {o.op_id: o for o in ops}
    buckets: dict[tuple, list[CommOp]] = {}
    for o in ops:
        if (o.primitive != "all_reduce" or o.kwargs or o.coalesced
                or len(o.in_vids) != 1
                or _op_payload_bytes(program, o) > max_bytes):
            continue
        key = (o.comm.dims, o.op, o.algorithm,
               str(program._avals[o.in_vids[0]].dtype))
        group = buckets.setdefault(key, [])
        # only mutually independent ops share a bucket
        if all(not _reachable(m, o, producers, by_id)
               and not _reachable(o, m, producers, by_id) for m in group):
            group.append(o)
    replaced: dict[int, CommOp] = {}
    next_id = _next_op_id(ops, program)
    for group in buckets.values():
        if len(group) < 2:
            continue
        lead = group[0]
        fused = CommOp(
            op_id=next_id, primitive="all_reduce",
            comm=lead.comm, algorithm=lead.algorithm, op=lead.op, kwargs={},
            in_vids=tuple(v for m in group for v in m.in_vids),
            out_vids=tuple(v for m in group for v in m.out_vids),
            fused_from=tuple(i for m in group for i in _origin_ids(m)),
            coalesced=True)
        next_id += 1
        replaced.update({m.op_id: fused for m in group})
    out, emitted = [], set()
    for o in ops:
        r = replaced.get(o.op_id)
        if r is None:
            out.append(o)
        elif r.op_id not in emitted:
            emitted.add(r.op_id)
            out.append(r)
    return out


# ------------------------------------------------------------------ execute
@dataclasses.dataclass
class LoweredProgram:
    """Optimized ops in jointly-planned schedule order, plus the plan."""
    program: CommProgram
    ops: tuple[CommOp, ...]
    plan: "planner.ProgramPlan"
    out_vids: tuple[int, ...]

    def describe(self) -> str:
        lines = [f"LoweredProgram[{self.program.program_id} "
                 f"ops={len(self.ops)} ici={self.plan.ici_bytes:.0f}B "
                 f"dcn={self.plan.dcn_bytes:.0f}B "
                 f"est_source={self.plan.est_source}]"]
        lines += ["  " + o.describe(self.program) for o in self.ops]
        return "\n".join(lines)

    def _env(self, inputs) -> dict[int, Any]:
        prog = self.program
        if len(inputs) != len(prog._input_vids):
            raise ValueError(
                f"{prog.program_id} takes {len(prog._input_vids)} inputs, "
                f"got {len(inputs)}")
        env = dict(prog._consts)
        env.update(zip(prog._input_vids, inputs))
        return env

    def _run_op(self, op: CommOp, env: dict[int, Any],
                staged: dict[int, Any] | None = None) -> None:
        meta = (self.program.program_id, op.fused_from)
        with _suspend_recording():
            if op.chain:
                # merged all_to_all chain: dispatch the recorded stages in
                # order, all carrying the merged op's provenance
                val = env[op.in_vids[0]]
                for c_comm, c_kwargs, c_alg in op.chain:
                    val = c_comm._dispatch(
                        "all_to_all", val, algorithm=c_alg, op=op.op,
                        _meta=meta, **c_kwargs)
                env[op.out_vids[0]] = val
            elif op.coalesced:
                vals = [env[v] for v in op.in_vids]
                flat = staged.pop(op.op_id, None) if staged else None
                if flat is None:
                    flat = _flatten_bucket(vals, self.program.cube.ndim)
                red = op.comm._dispatch("all_reduce", flat,
                                        algorithm=op.algorithm, op=op.op,
                                        _meta=meta)
                cn, offset = self.program.cube.ndim, 0
                for v, vid in zip(vals, op.out_vids):
                    n = math.prod(v.shape[cn:])
                    env[vid] = red[..., offset:offset + n].reshape(v.shape)
                    offset += n
            else:
                kwargs = dict(op.kwargs)
                env[op.out_vids[0]] = op.comm._dispatch(
                    op.primitive, env[op.in_vids[0]],
                    algorithm=op.algorithm, op=op.op, _meta=meta, **kwargs)

    def execute(self, *inputs):
        """Run the optimized schedule; returns the program outputs as a
        tuple (bare when there is exactly one)."""
        env = self._env(inputs)
        for op in self.ops:
            self._run_op(op, env)
        outs = tuple(env[v] for v in self.out_vids)
        return outs[0] if len(outs) == 1 else outs

    def execute_async(self, *inputs) -> "ProgramExecution":
        """Per-op futures backed by dependency-ordered dispatch: forcing a
        future runs (and memoizes) exactly its dependency cone, in planned
        order."""
        return ProgramExecution(self, self._env(inputs))


def _flatten_bucket(vals, cn: int) -> torch.Tensor:
    """A coalesced bucket's payload: each PE's values flattened and
    concatenated along the last axis, (*cube, total)."""
    return torch.cat([v.reshape(tuple(v.shape[:cn]) + (-1,)) for v in vals],
                     dim=-1)


class CommFuture:
    """Handle on one scheduled op's result(s).

    ``out_vids`` restricts ``result()`` to a subset of the op's outputs --
    :meth:`ProgramExecution.future_for` uses it so a future resolved
    through coalescing provenance returns just the recorded op's own
    value, not the whole bucket.
    """

    def __init__(self, execution: "ProgramExecution", op: CommOp,
                 out_vids: tuple[int, ...] | None = None):
        self._execution = execution
        self.op = op
        self._out_vids = out_vids

    def done(self) -> bool:
        return self.op.op_id in self._execution._done

    def result(self):
        """Force this op (dispatching its unfinished dependencies first);
        returns the op's output value (tuple for coalesced ops)."""
        env = self._execution.force(self.op)
        outs = tuple(env[v] for v in (self._out_vids or self.op.out_vids))
        return outs[0] if len(outs) == 1 else outs


class ProgramExecution:
    """Dependency-ordered lazy run of a lowered program."""

    def __init__(self, lowered: LoweredProgram, env: dict[int, Any]):
        self.lowered = lowered
        self._env = env
        self._done: set[int] = set()
        self._staged: dict[int, Any] = {}
        self._producer = {v: o for o in lowered.ops for v in o.out_vids}
        self.futures = [CommFuture(self, o) for o in lowered.ops]

    def force(self, op: CommOp) -> dict[int, Any]:
        if op.op_id in self._done:
            return self._env
        for v in op.in_vids:
            dep = self._producer.get(v)
            if dep is not None and dep.op_id not in self._done:
                self.force(dep)
        self.lowered._run_op(op, self._env, self._staged)
        self._done.add(op.op_id)
        return self._env

    def stage(self) -> "ProgramExecution":
        """Pre-build the flattened/concatenated payload of every coalesced
        op whose inputs are already available -- the memory-side half of a
        bucketed dispatch -- without issuing any collective.  A
        double-buffered pipeline stages bucket k+1 here while bucket k's
        wire op is still in flight; ``force`` then consumes the staged
        payload instead of re-concatenating."""
        cn = self.lowered.program.cube.ndim
        for op in self.lowered.ops:
            if (not op.coalesced or op.op_id in self._done
                    or op.op_id in self._staged
                    or any(v not in self._env for v in op.in_vids)):
                continue
            self._staged[op.op_id] = _flatten_bucket(
                [self._env[v] for v in op.in_vids], cn)
        return self

    def future_for(self, handle) -> CommFuture:
        """Future for a *recorded* op -- by the :class:`ProgramValue` its
        primitive returned at record time, or by recorded op id --
        resolving through rewrite provenance: a recorded op consumed by
        fusion/coalescing maps (via ``fused_from``) to the lowered op that
        carries it.  When the rewrite preserved the recorded op's output
        value (coalescing does), the future returns exactly that value;
        when it did not (the reduce_scatter of a fused rs+ag pair has no
        shard anymore), the future resolves to the rewritten op's result.
        """
        prog = self.lowered.program
        if isinstance(handle, ProgramValue):
            if handle.program is not prog:
                raise ValueError(
                    f"{handle!r} belongs to {handle.program.program_id}, "
                    f"not {prog.program_id}")
            rec = next((o for o in prog._ops if handle.vid in o.out_vids),
                       None)
            if rec is None:
                raise KeyError(
                    f"v{handle.vid} is not produced by any recorded op of "
                    f"{prog.program_id}")
        else:
            rid = int(handle)
            if not 0 <= rid < len(prog._ops):
                raise KeyError(
                    f"{prog.program_id} has no recorded op {rid}")
            rec = prog._ops[rid]
        target = next((o for o in self.lowered.ops
                       if rec.op_id in _origin_ids(o)), None)
        if target is None:
            raise KeyError(
                f"recorded op {rec.op_id} of {prog.program_id} has no "
                "lowered counterpart (rewrite provenance lost)")
        keep = tuple(v for v in rec.out_vids if v in target.out_vids)
        return CommFuture(self, target, out_vids=keep or None)

    def outputs(self):
        """Force every op and return the program outputs."""
        for f in self.futures:
            f.result()
        outs = tuple(self._env[v] for v in self.lowered.out_vids)
        return outs[0] if len(outs) == 1 else outs


__all__ = [
    "Aval", "CommFuture", "CommOp", "CommProgram", "LoweredProgram",
    "LOWER_STATS", "ProgramExecution", "ProgramValue",
    "DEFAULT_COALESCE_BYTES", "active_program", "clear_lower_cache",
]
