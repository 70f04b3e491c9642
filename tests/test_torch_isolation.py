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
    ROOT / "tools" / "torch_b7_tf32.py",
    ROOT / "tools" / "torch_dp_multicard.py"]


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


def test_observe_dump_cli_runs_with_jax_blocked(tmp_path):
    """`python -m deeplearning4j_tpu_torch.observe.dump` on a flight dump
    (its registry table) and on a span log, in a process where `jax`
    cannot be imported; the observe modules import there too."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "from deeplearning4j_tpu_torch import observe as o\n"
        "r = o.MetricsRegistry(); o.set_registry(r)\n"
        "r.counter('jit_compiles', owner='NetGraphs').inc(3)\n"
        "fr = o.FlightRecorder(dump_dir=sys.argv[1]); o.set_flight(fr)\n"
        "log = o.install_span_log(sys.argv[1] + '/spans.jsonl')\n"
        "with o.span('fit', epochs=1):\n"
        "    pass\n"
        "o.uninstall_span_log()\n"
        "path = fr.dump('cli')\n"
        "for arg in (path, sys.argv[1] + '/spans.jsonl'):\n"
        "    sys.argv = ['dump', arg]\n"
        "    try:\n"
        "        runpy.run_module('deeplearning4j_tpu_torch.observe.dump',\n"
        "                         run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "leak = [m for m in sys.modules if m.split('.')[0] in\n"
        "        ('jax', 'deeplearning4j_tpu') and sys.modules[m]]\n"
        "assert not leak, leak\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "jit_compiles" in out.stdout and "owner=NetGraphs" in out.stdout
    assert "fit" in out.stdout


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
    # the Pallas kernels' TPU-backend checks: no counterpart on the card
    "ops": {"banded_eligible": "TPU-only",
            "fused_update_available": "TPU-only"},
    # the jit cache wrapper has no counterpart (the port keeps no jit
    # cache); the witnesses are ported (slice 30)
    "observe": {
        "WatchedJitCache": "JAX-only"},
    # A6's second part: tensor, pipeline and expert parallelism, the
    # asynchronous parameter server, the training masters, the estimator
    "parallel": {n: "A6" for n in (
        "AsyncParameterServer", "AsyncTrainer", "PipelineParallel",
        "PipelinedNetwork", "make_pipeline_fn", "make_pipeline_1f1b_fn",
        "partition_for_pipeline", "stack_stage_params",
        "split_microbatches", "MoEFeedForward", "moe_ffn", "top_k_gating",
        "expert_sharding", "expert_mesh", "TrainingMaster",
        "ParameterAveragingTrainingMaster", "DistributedTrainingMaster",
        "PhaseStats", "NetworkEstimator", "distributed_evaluate",
        "export_timeline_html")},
}
# Names that resolve to a module holding the exported object: the port's
# `ops.banded_attention` is the B4/B5/B6 kernel module, as every kernel
# module of `ops` is addressed by its name.
IN_MODULE = {"ops": {"banded_attention"}}
# the ported subpackages (`parallel` in part: its `WAITING` names wait
# for A6's second part)
SURFACE = ["", "nn", "nn.layers", "nn.config", "optim", "utils", "ops",
           "models", "zoo", "keras_import", "interop", "data", "eval",
           "observe", "serving", "ui", "clustering", "nlp", "graph",
           "parallel"]


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
            if waiting[name] in ("TPU-only", "JAX-only"):
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


def test_fleet_exports_what_the_jax_fleet_exports():
    """Every name JAX's `serving/fleet/__init__.py` imports resolves in
    the port's `serving.fleet`, and so does `observe.fedmon`'s surface."""
    import importlib

    tree = ast.parse((ROOT / "deeplearning4j_tpu" / "serving" / "fleet" /
                      "__init__.py").read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) >= 9
    fleet = importlib.import_module("deeplearning4j_tpu_torch.serving.fleet")
    assert [n for n in names if not hasattr(fleet, n)] == []
    fedmon = importlib.import_module("deeplearning4j_tpu_torch.observe.fedmon")
    for name in ("FleetFederation", "quantile_from_buckets",
                 "default_fleet_slos", "ENV_STALE_S"):
        assert hasattr(fedmon, name), name


def test_replica_main_runs_with_jax_blocked():
    """`python -m deeplearning4j_tpu_torch.serving.fleet.replica_main` in a
    process where neither `jax` nor the JAX package can be imported: it
    reports ready, answers `/fleet/info` and streams a greedy request,
    and ends on SIGTERM."""
    import json
    import signal
    import urllib.request

    code = (
        "import sys, runpy\n"
        "for m in ('jax', 'jaxlib', 'deeplearning4j_tpu'):\n"
        "    sys.modules[m] = None\n"
        "runpy.run_module('deeplearning4j_tpu_torch.serving.fleet."
        "replica_main', run_name='__main__')\n")
    config = {"name": "iso0", "role": "decode", "decode_slots": 2,
              "prefill_chunk": 4, "page_len": 4,
              "model": {"kind": "bench_lm", "seed": 0, "vocab": 17,
                        "chunk": 4, "max_cache": 32, "blocks": 1}}
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               FLEET_REPLICA_PLATFORM="cpu",
               FLEET_REPLICA_CONFIG=json.dumps(config))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("FLEET_REPLICA_READY port="), \
            (line, proc.stderr.read() if proc.poll() is not None else "")
        url = f"http://127.0.0.1:{int(line.split('port=')[1])}"
        with urllib.request.urlopen(url + "/fleet/info", timeout=60) as r:
            info = json.loads(r.read())
        assert info["name"] == "iso0" and info["role"] == "decode"
        req = urllib.request.Request(
            url + "/generate", data=json.dumps({
                "prompt_ids": [3, 1, 4, 1, 5], "max_tokens": 3,
                "greedy": True, "stream": False}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["outcome"] == "completed" and len(out["tokens"]) == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_ui_and_clustering_run_with_jax_blocked():
    """A fit under the port's StatsListener, served by its UIServer, and
    k-means, t-SNE and the k-NN server, in a process where neither `jax`
    nor the JAX package can be imported."""
    code = (
        "import sys, json, urllib.request\n"
        "for m in ('jax', 'jaxlib', 'deeplearning4j_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch import ui, clustering\n"
        "from deeplearning4j_tpu_torch.models import MultiLayerNetwork\n"
        "from deeplearning4j_tpu_torch.nn.config import "
        "NeuralNetConfiguration\n"
        "from deeplearning4j_tpu_torch.nn.layers import DenseLayer, "
        "OutputLayer\n"
        "from deeplearning4j_tpu_torch.serving import "
        "NearestNeighborsServer\n"
        "conf = (NeuralNetConfiguration.builder().seed(1).list()\n"
        "        .layer(DenseLayer(n_in=4, n_out=8, activation='tanh'))\n"
        "        .layer(OutputLayer(n_in=8, n_out=3, activation='softmax'))"
        "\n        .build())\n"
        "net = MultiLayerNetwork(conf, device='cpu').init()\n"
        "st = ui.InMemoryStatsStorage()\n"
        "net.set_listeners(ui.StatsListener(st, 1, collect_histograms=True,"
        "\n                                   collect_activations=True))\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.standard_normal((64, 4)).astype(np.float32)\n"
        "y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]\n"
        "net.fit(x, y, epochs=1, batch_size=32)\n"
        "srv = ui.UIServer(port=0); srv.attach(st)\n"
        "o = json.loads(urllib.request.urlopen(\n"
        "    f'http://127.0.0.1:{srv.port}/train/overview').read())\n"
        "srv.stop()\n"
        "assert len(o['scores']) == 2, o\n"
        "km = clustering.KMeansClustering(3, device='cpu').fit(x)\n"
        "emb = clustering.BarnesHutTsne(n_iter=5, perplexity=5,\n"
        "                               device='cpu').fit_transform(x)\n"
        "assert km.centroids.shape == (3, 4) and emb.shape == (64, 2)\n"
        "knn = NearestNeighborsServer(x, port=0); knn.start(); knn.stop()\n"
        "leak = [m for m in sys.modules if m.split('.')[0] in\n"
        "        ('jax', 'deeplearning4j_tpu') and sys.modules[m]]\n"
        "assert not leak, leak\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
