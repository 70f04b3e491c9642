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
    ROOT / "tools" / "torch_train_profile.py",
    ROOT / "tools" / "torch_parity_faults.py",
    ROOT / "tools" / "torch_b3a_exp_forms.py",
    ROOT / "tools" / "torch_path_l_steps.py",
    ROOT / "tools" / "torch_b6_splits.py",
    ROOT / "tools" / "torch_b1_variants.py",
    ROOT / "tools" / "torch_b1_updater.py",
    ROOT / "tools" / "torch_b5_splits.py",
    ROOT / "tools" / "torch_b5_phases.py",
    ROOT / "tools" / "torch_b4_exp_forms.py",
    ROOT / "tools" / "torch_b2c_phases.py",
    ROOT / "tools" / "torch_b2_bf16_phases.py",
    ROOT / "tools" / "torch_lstm_graph.py",
    ROOT / "tools" / "torch_c10_lenet.py",
    ROOT / "tools" / "torch_http_probe.py",
    ROOT / "tools" / "torch_b3_tf32.py",
    ROOT / "tools" / "torch_b3a_variants.py",
    ROOT / "tools" / "torch_b7_tf32.py"]


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


# ------------------------------------------------------ package surface

# Names of a JAX `__all__` the port does not resolve yet, each with its
# ROADMAP item (a name here must not resolve to a working object).
WAITING = {
    # utils/profiling.py with an H100 peak table: they resolve to
    # functions that raise naming the item
    "utils": {"ProfilerListener": "A8", "peak_flops": "A8",
              "peak_hbm_bytes": "A8", "peak_ici_bytes": "A8",
              "step_flops": "A8", "trace": "A8"},
    # the Pallas kernels' TPU-backend checks: no counterpart on the card
    "ops": {"banded_eligible": "TPU-only",
            "fused_update_available": "TPU-only"},
}
# Names that resolve to a module holding the exported object: the port's
# `ops.banded_attention` is the B4/B5/B6 kernel module, as every kernel
# module of `ops` is addressed by its name.
IN_MODULE = {"ops": {"banded_attention"}}
# the ported subpackages; `parallel`, `serving` and `observe` are ported
# in part and wait for A6, S5 and A8
SURFACE = ["", "nn", "nn.layers", "nn.config", "optim", "utils", "ops",
           "models", "zoo", "keras_import", "interop", "data", "eval"]


@pytest.mark.parametrize("sub", SURFACE, ids=[s or "root" for s in SURFACE])
def test_every_jax_export_resolves_in_the_port(sub):
    """A10: every name of the JAX subpackage's `__all__` resolves in the
    port's counterpart (`nn.config`: `GradientNormalization`, which JAX
    exports from the module itself), or is one of `WAITING`, which
    raise naming their item or do not exist."""
    import importlib

    jmod = importlib.import_module("deeplearning4j_tpu" + (
        "." + sub if sub else ""))
    pmod = importlib.import_module("deeplearning4j_tpu_torch" + (
        "." + sub if sub else ""))
    names = (["GradientNormalization", "NeuralNetConfiguration",
              "MultiLayerConfiguration"] if sub == "nn.config"
             else list(jmod.__all__))
    waiting = WAITING.get(sub, {})
    missing = []
    for name in names:
        if name in IN_MODULE.get(sub, ()):
            assert callable(getattr(getattr(pmod, name), name)), name
            continue
        if name in waiting:
            if waiting[name] == "TPU-only":
                assert not hasattr(pmod, name), name
            else:
                with pytest.raises(NotImplementedError,
                                   match=waiting[name]):
                    getattr(pmod, name)()
            continue
        if not hasattr(pmod, name):
            missing.append(name)
    assert not missing, f"{sub or 'root'}: {missing}"
    if hasattr(pmod, "__all__"):
        assert set(names) - set(waiting) - IN_MODULE.get(sub, set()) <= \
            set(pmod.__all__) | {"__version__"}
    if sub == "nn.config":
        assert pmod.GradientNormalization.CLIP_L2_PER_LAYER == \
            jmod.GradientNormalization.CLIP_L2_PER_LAYER


def test_package_import_is_lazy_and_needs_neither_h5py_nor_yaml():
    """`import deeplearning4j_tpu_torch` imports no submodule (so builds
    no kernel); the Keras importer, the zoo's pretrained loaders and the
    DL4J interop import with `jax`, `h5py` and `yaml` blocked (h5py is
    imported when a `.h5` file is opened, yaml for a YAML text)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'h5py', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import deeplearning4j_tpu_torch as p\n"
        "subs = [m for m in sys.modules\n"
        "        if m.startswith('deeplearning4j_tpu_torch.')]\n"
        "assert not subs, subs\n"
        "assert p.MultiLayerNetwork.__name__ == 'MultiLayerNetwork'\n"
        "import deeplearning4j_tpu_torch.keras_import as k\n"
        "import deeplearning4j_tpu_torch.interop as i\n"
        "import deeplearning4j_tpu_torch.models.transfer as t\n"
        "import deeplearning4j_tpu_torch.zoo as z\n"
        "import deeplearning4j_tpu_torch.serving.keras_gateway as g\n"
        "cb = sys.modules.get('deeplearning4j_tpu_torch.ops.cuda_build')\n"
        "assert cb is None or not cb._libs\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
