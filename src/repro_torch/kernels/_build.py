"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source under ``repro_torch/kernels`` has a plain C
interface; it is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared`` into ``build/repro_torch/`` at the root of the checkout on first
use and loaded with ``ctypes``. The library's file name carries a hash of
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
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel library (or ``names``) that is not built yet,
    one ``nvcc`` per source, all started together. Returns each library's
    compiler log (``ptxas`` register / shared-memory report) ending in a
    line ``nvcc wall seconds: <s>`` (from the start of all builds to this
    one's end), or ``"cached"``; raises with the log if any build fails."""
    names = tuple(SOURCES) if names is None else tuple(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_KERNELS / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)

    def finish(name: str) -> None:
        log, _ = procs[name][0].communicate()
        logs[name] = (f"{log}\nnvcc wall seconds: "
                      f"{time.perf_counter() - t0:.2f}\n")

    waits = [threading.Thread(target=finish, args=(n,)) for n in procs]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log = logs[name]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
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
