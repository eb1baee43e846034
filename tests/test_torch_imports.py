"""The port stands alone: nothing under ``src/repro_torch/``, nothing under
``examples_torch/`` and nothing in ``chip_smoke.py`` imports ``jax`` (or
``jaxlib``) or the JAX package ``repro`` -- checked on the syntax tree, so
imports inside functions count too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + EXAMPLES + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value


def test_port_files_exist():
    assert len(FILES) > 10 and all(f.is_file() for f in FILES)
    # one port of each example script of the JAX package, by name
    assert [f.name for f in EXAMPLES] == sorted(
        f.name for f in (ROOT / "examples").glob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN or m.startswith("repro.")]
    assert not bad, f"{path.name} imports {bad}"


# the slices' modules: present, covered above, and importable in a process
# where ``jax``, ``repro`` and ``ml_dtypes`` (which ships with jax, not on
# the card's machine: the checkpoint's BF16 reader must not lean on it)
# cannot be imported at all
SLICE_MODULES = ["repro_torch.telemetry", "repro_torch.telemetry.metrics",
                 "repro_torch.telemetry.spans", "repro_torch.telemetry.drift",
                 "repro_torch.core.program", "repro_torch.core.planner",
                 "repro_torch.core.comm", "repro_torch.serving",
                 "repro_torch.serving.pages", "repro_torch.serving.engine",
                 "repro_torch.core.compress",
                 "repro_torch.kernels.collective.attention",
                 "repro_torch.kernels.collective",
                 "repro_torch.apps.paper_apps",
                 "repro_torch.kernels.attention.flash_bwd",
                 "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                 "repro_torch.runtime.trainer", "repro_torch.runtime.overlap",
                 "repro_torch.launch.train", "repro_torch.tuning",
                 "repro_torch.tuning.profile", "repro_torch.tuning.microbench",
                 "repro_torch.tuning.tuner", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.layout",
                 "repro_torch.checkpoint.reshard",
                 "repro_torch.checkpoint.manager",
                 "repro_torch.checkpoint.hf_import",
                 "repro_torch.kernels.rwkv6.rwkv6_bwd",
                 "repro_torch.kernels.rwkv6.ops",
                 "repro_torch.kernels.reorder.ops"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_without_jax(module):
    import subprocess
    import sys
    path = ROOT / "src" / Path(*module.split("."))
    assert (path.with_suffix(".py") in FILES
            or path / "__init__.py" in FILES), module
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            f"import {module}\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
