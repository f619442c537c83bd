"""The port stands alone: no JAX, no optax, nothing of ``multigrad_tpu``,
and no silent move to the CPU when CUDA is absent."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "multigrad_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "multigrad_tpu")


def _python_files():
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO_ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import multigrad_tpu_torch, multigrad_tpu_torch.models\n"
        "import multigrad_tpu_torch.ops.binned\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_forbidden_import_in_sources():
    files = list(_python_files())
    assert len(files) > 10
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


@pytest.mark.parametrize("entry", ["make_smf_data", "resolve_device",
                                   "bounds_to_arrays"])
def test_default_device_is_cuda(entry):
    # device=None means the card: on a machine without one, the entry
    # points raise instead of computing on the CPU.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from multigrad_tpu_torch.models import make_smf_data
    from multigrad_tpu_torch.optim.transforms import bounds_to_arrays
    from multigrad_tpu_torch.utils.util import resolve_device
    call = {"make_smf_data": lambda: make_smf_data(100),
            "resolve_device": resolve_device,
            "bounds_to_arrays": lambda: bounds_to_arrays(None, 2)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
