"""The PyTorch port stands alone: no module of `deeplearning4j_tpu_torch`,
and neither `chip_smoke.py` nor the profilers under `tools/`, imports
JAX or the JAX package, and the whole port imports in a process where
`jax` cannot be imported at all."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_decode_profile.py",
    ROOT / "tools" / "torch_train_profile.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import deeplearning4j_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, 'deeplearning4j_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "leak = [m for m in sys.modules if m == 'deeplearning4j_tpu'\n"
        "        or m.startswith('deeplearning4j_tpu.')]\n"
        "assert not leak, leak\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_every_counted_kernel_has_a_source_and_a_tpu_body():
    """Each kernel the port counts launches of is named in
    `chip_smoke.py`'s summary with its CUDA source (which exists) and the
    TPU body it replaces, and every source `ops/cuda_build.py` builds is
    in the tree."""
    import importlib.util

    from deeplearning4j_tpu_torch.ops import (
        attention, banded_attention, conv_fused, cuda_build, fused_update,
        lstm,
    )

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    counted = set().union(*(m.LAUNCHES for m in (attention,
                                                 banded_attention,
                                                 conv_fused, fused_update,
                                                 lstm)))
    assert counted == set(smoke.SOURCES) == set(smoke.REPLACES)
    for src in smoke.SOURCES.values():
        assert (ROOT / src).is_file(), src
    for path in smoke.REPLACES.values():
        assert (ROOT / path.split(":")[0]).is_file(), path
    for stem in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{stem}.cu").is_file(), stem
