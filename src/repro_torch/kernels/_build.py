"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source under ``repro_torch/kernels`` has a plain C
interface; it is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared`` into ``build/repro_torch/`` at the root of the checkout on first
use and loaded with ``ctypes``. A source listed in ``PARTS`` is compiled
as that many objects at once (``-DREPRO_PART=k``: each holds some of its
entry points and the template instances they reach) and linked into one
library, so its build takes the time of its largest part. The library's file name carries a hash of
its source and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time: the CPU tests import every module
and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent

# kernel library name -> its source, relative to repro_torch/kernels
SOURCES = {
    "flash": "attention/csrc/flash.cu",
    "flash_bwd": "attention/csrc/flash_bwd.cu",
    "reorder": "reorder/csrc/reorder.cu",
    "rwkv6": "rwkv6/csrc/rwkv6.cu",
    "rwkv6_bwd": "rwkv6/csrc/rwkv6_bwd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name -> the objects its source compiles into (REPRO_PART 1..n)
PARTS = {"flash": 3}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return _KERNELS.parents[2] / "build" / "repro_torch"


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch are built on the machine with the GPU")


def library_path(name: str) -> Path:
    src = _KERNELS / SOURCES[name]
    flags = " ".join(NVCC_FLAGS) + (f" parts {PARTS[name]}"
                                    if name in PARTS else "")
    digest = hashlib.sha1(src.read_bytes() + flags.encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _objects(name: str, tmp: Path) -> list[Path]:
    """The part objects of library ``name`` built into ``tmp`` (none for a
    source in one object)."""
    return [tmp.with_suffix(f".part{k}.o")
            for k in range(1, PARTS.get(name, 0) + 1)]


def _commands(name: str, tmp: Path) -> tuple[list, list | None]:
    """The compile commands of library ``name`` into ``tmp``, all to run at
    once, and the link command after them (None for a single object)."""
    src = str(_KERNELS / SOURCES[name])
    objs = _objects(name, tmp)
    if not objs:
        return [[nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]], None
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    compiles = [[nvcc(), *compile_flags, "-c", f"-DREPRO_PART={k}", "-o",
                 str(o), src] for k, o in enumerate(objs, 1)]
    link = [nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
            *map(str, objs)]
    return compiles, link


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel library (or ``names``) that is not built yet,
    one ``nvcc`` per source (per part of a source in ``PARTS``), all
    started together. Returns each library's compiler log (``ptxas``
    register / shared-memory report) ending in a line ``nvcc wall seconds:
    <s>`` (from the start of all builds to this one's end, its link
    included), or ``"cached"``; raises with the log if any build fails."""
    names = tuple(SOURCES) if names is None else tuple(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs, logs, codes = {}, {}, {}
    t0 = time.perf_counter()

    def start(cmd):
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compiles, link = _commands(name, tmp)
        jobs[name] = ([start(c) for c in compiles], link, tmp, out)

    def finish(name: str) -> None:
        procs, link, _, _ = jobs[name]
        outs = [p.communicate()[0] for p in procs]
        code = next((p.returncode for p in procs if p.returncode), 0)
        if code == 0 and link is not None:
            proc = start(link)
            outs.append(proc.communicate()[0])
            code = proc.returncode
        codes[name] = code
        logs[name] = ("\n".join(outs) + f"\nnvcc wall seconds: "
                      f"{time.perf_counter() - t0:.2f}\n")

    waits = [threading.Thread(target=finish, args=(n,)) for n in jobs]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    failed = []
    for name, (_, _, tmp, out) in jobs.items():
        log = logs[name]
        if codes[name] != 0:
            failed.append(f"{name} (nvcc exit {codes[name]}):\n{log}")
            continue
        for obj in _objects(name, tmp):
            obj.unlink()
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib
