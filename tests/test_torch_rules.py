"""The port's standing rules: deeplearning4j_tpu_torch and chip_smoke.py
import neither jax nor the JAX package (the port keeps its own copy of
what it needs), nor h5py or tensorflow (the port runs where neither is
installed: Keras files go through its own HDF5 reader), nor urllib (the
port never downloads), and importing the port leaves jax, h5py and tensorflow
out of sys.modules (torch itself loads urllib)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu", "h5py", "tensorflow")
FORBIDDEN_IMPORTS = FORBIDDEN + ("urllib",)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_jax_package(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN_IMPORTS]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_leaves_jax_out_of_sys_modules():
    mods = ["deeplearning4j_tpu_torch"] + sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when
    torch.cuda.is_available() is false, and alone in a directory."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_scaleout_worker_imports_only_the_port():
    """The scale-out gang's worker (tests/fixtures/torch/) runs the port
    alone: no jax, no JAX package, and no tests/helpers worker."""
    worker = ROOT / "tests" / "fixtures" / "torch" / "scaleout_worker.py"
    roots = {mod for mod, _ in _imported_roots(worker)}
    assert not roots & set(FORBIDDEN_IMPORTS + ("distributed_worker",))
    assert "deeplearning4j_tpu_torch" in roots

