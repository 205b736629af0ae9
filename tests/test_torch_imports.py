"""The PyTorch port stands alone: no module of diff_qp_mpc_tpu_torch, and
not chip_smoke.py, imports JAX, flax, msgpack, the JAX package or the
repo-root benchmarks (the port has its own diff_qp_mpc_tpu_torch.benchmarks);
the package turns TF32 off; chip_smoke.py refuses to run without a card."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "diff_qp_mpc_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "optax", "diff_qp_mpc_tpu",
             "benchmarks"}


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_import(path):
    assert not FORBIDDEN & set(_imported_roots(path))


def test_clean_process_loads_no_jax_and_disables_tf32():
    """Importing every module of the port in a fresh interpreter loads none
    of the forbidden packages, and leaves TF32 off for matmuls and cuDNN."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "diff_qp_mpc_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys, torch\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        run = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
