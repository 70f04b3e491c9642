"""Transfer learning, pretrained loading, the DL4J zip container and the
Keras gateway of the port against the JAX package's, on the CPU.

- `TransferLearning`: the same builder calls (fine-tune configuration,
  `set_feature_extractor`, `n_out_replace` with its weight init,
  removing and adding layers) give JAX's configuration JSON and JAX's
  kept parameters bit for bit, in tensors of the new network's own;
  with JAX's re-initialized layers carried across, three Adam steps
  agree within 1e-8 (float64; the port's Adam takes its bias-corrected
  rate as a float32 scalar, as the card's kernel B1a does) and the
  frozen layers stay bit-equal to what they were. `TransferLearningHelper.featurize` equals JAX's within
  1e-12 (a dense stack and a LeNet-shaped convolution stack with its
  preprocessors), and `fit_featurized` trains the tail as JAX's does.
- `zoo/pretrained.py`: the catalog equals JAX's (URLs, Adler32 values),
  `adler32_of` equals zlib's, `sniff_format` tells the three formats
  apart, a bad checksum removes the file, a failed download raises
  `IOError` naming the URL and the cache path (the download is
  replaced by a failing function throughout this file: nothing here
  reaches the network), and `load_pretrained` / `init_pretrained` load
  a native zip, a DL4J zip and a Keras `.h5`, each written by the JAX
  package, with JAX's predictions within 1e-6.
- `interop/dl4j.py`: the ND4J codec writes JAX's bytes and reads both
  orders; a zip written by JAX's `export_dl4j_model` (dense, CNN with
  batch norm, LSTM and GravesLSTM, a graph) imports in the port with
  JAX's configuration and predictions, and the port's export is JAX's
  file entry for entry (configuration, coefficients, updater state); the
  committed DL4J-layout fixtures predict their recorded oracles, and
  dropping the LSTM column permutation breaks the GravesLSTM oracle.
- `serving/keras_gateway.py`: import, fit and predict over HTTP on
  127.0.0.1."""

import io
import json
import os
import urllib.request
import zipfile
import zlib

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import interop as jinterop
from deeplearning4j_tpu.models import ComputationGraph as JaxGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.models import serialize as jserialize
from deeplearning4j_tpu.models import transfer as jtransfer
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JaxMLConf
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.inputs import InputType as JaxIT
from deeplearning4j_tpu.optim import updaters as ju
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.zoo import pretrained as jpre
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.interop import dl4j as pdl4j
from deeplearning4j_tpu_torch.models import (
    ComputationGraph, MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.models import transfer
from deeplearning4j_tpu_torch.models.convert import (
    params_from_numpy, state_from_numpy, updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.optim import updaters as pu
from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.zoo import pretrained

TOL = dict(rtol=1e-10, atol=1e-10)
STEP_TOL = dict(rtol=0, atol=1e-8)
OUT_TOL = dict(rtol=1e-6, atol=1e-6)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.fixture(autouse=True)
def _no_network(monkeypatch):
    """Every download in this file fails at once, without a socket."""
    def refuse(url, dest):
        raise OSError(f"downloads are disabled in these tests ({url})")

    monkeypatch.setattr(pretrained, "_download", refuse)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _host(t):
    t = t[0] if isinstance(t, (list, tuple)) else t
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(port, ref, path="", **tol):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _close(port[k], ref[k], f"{path}/{k}", **tol)
    elif isinstance(port, tuple):
        assert port == () and len(ref) == 0, path
    else:
        np.testing.assert_allclose(_host(port), np.asarray(ref),
                                   **(tol or TOL), err_msg=path)


def _equal(port, ref, path=""):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _equal(port[k], ref[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(_host(port), np.asarray(ref),
                                      err_msg=path)


def _port_of(jnet):
    """The port's twin of a JAX net: its JSON and its trees."""
    if hasattr(jnet.conf, "vertices"):
        pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
            jnet.conf.to_json()), device="cpu").init()
    else:
        pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jnet.conf.to_json()), device="cpu").init()
    params_from_numpy(pnet, _np(jnet.params_tree))
    state_from_numpy(pnet, _np(jnet.state_tree))
    updater_state_from_numpy(pnet, _np(jnet.updater_state))
    return pnet


def _mlp(dtype="float64"):
    return JaxNet(
        JaxNNC.builder().seed(3).dtype(dtype).updater(ju.Adam(1e-2))
        .activation("tanh")
        .list(jl.DenseLayer(n_out=8), jl.DenseLayer(n_out=7),
              jl.DenseLayer(n_out=5),
              jl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(JaxIT.feed_forward(6)).build()).init()


def _xy(n=8, f=6, classes=3, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(dtype)
    y = np.eye(classes, dtype=dtype)[rng.integers(0, classes, n)]
    return x, y


# ------------------------------------------------------------ transfer


def _builders(jnet, pnet, build):
    return (build(jtransfer.TransferLearning.builder(jnet), jtransfer, ju),
            build(transfer.TransferLearning.builder(pnet), transfer, pu))


def _freeze_replace(b, mod, upd):
    return (b.fine_tune_configuration(mod.FineTuneConfiguration(
                updater=upd.Adam(5e-3), l2=1e-3))
            .set_feature_extractor(1)
            .n_out_replace(2, 4, weight_init="xavier")
            .build())


def _remove_add(b, mod, upd):
    return (b.set_feature_extractor(0)
            .remove_output_layer_and_below(1)
            .add_layer(jl.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent")
                       if mod is jtransfer else
                       pl.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
            .build())


@pytest.mark.parametrize("case", ["freeze_replace", "remove_add"])
def test_transfer_builder_matches_jax(case):
    build = {"freeze_replace": _freeze_replace,
             "remove_add": _remove_add}[case]
    jsrc = _mlp()
    psrc = _port_of(jsrc)
    src = _np(jsrc.params_tree)   # JAX's fit donates the shared arrays
    jnew, pnew = _builders(jsrc, psrc, build)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    reinit = {"freeze_replace": {2, 3}, "remove_add": {3}}[case]
    for i, n in enumerate(l.name for l in pnew.layers):
        if i in reinit:
            assert tuple(pnew.params_tree[n]["W"].shape) == \
                np.asarray(jnew.params_tree[n]["W"]).shape
            continue
        _equal(pnew.params_tree[n], _np(jnew.params_tree[n]), n)
        for k, t in pnew.params_tree[n].items():   # copies, not aliases
            assert t.data_ptr() != psrc.params_tree[n][k].data_ptr()
    # carry JAX's re-initialized layers across, then train both
    params_from_numpy(pnew, _np(jnew.params_tree))
    frozen = {l.name: {k: t.clone() for k, t in
                       pnew.params_tree[l.name].items()}
              for l in pnew.layers if l.frozen}
    assert len(frozen) == (2 if case == "freeze_replace" else 1)
    n_out = pnew.layers[-1].n_out
    x, y = _xy(classes=n_out, seed=1)
    jnew.fit(x, y, epochs=3, batch_size=8)
    pnew.fit(x, y, epochs=3, batch_size=8)
    _close(pnew.params_tree, _np(jnew.params_tree), **STEP_TOL)
    for n, p in frozen.items():
        for k, t in p.items():
            assert torch.equal(pnew.params_tree[n][k], t), (n, k)
    # the source network was not moved by the new one's training
    _equal(psrc.params_tree, src)


def _lenet64():
    d = json.loads(jzoo.LeNet(num_classes=4).conf().to_json())
    d["dtype"] = "float64"
    return JaxNet(JaxMLConf.from_json(json.dumps(d))).init()


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_helper_featurize_and_fit_featurized_match_jax(net):
    jsrc = _mlp() if net == "mlp" else _lenet64()
    psrc = _port_of(jsrc)
    freeze = 1 if net == "mlp" else 3

    def frozen(b, mod, upd):
        return b.set_feature_extractor(freeze).build()

    jnew, pnew = _builders(jsrc, psrc, frozen)
    jh = jtransfer.TransferLearningHelper(jnew)
    ph = transfer.TransferLearningHelper(pnew)
    assert ph.split == jh.split == freeze + 1
    if net == "mlp":
        x, y = _xy(seed=2)
    else:
        x, _ = _xy(n=6, f=784, seed=2)
        y = np.eye(4)[[0, 1, 2, 3, 0, 1]]
    fj, fp = jh.featurize(x), ph.featurize(x)
    assert isinstance(fp, np.ndarray) and fp.shape == fj.shape
    np.testing.assert_allclose(fp, fj, rtol=1e-12, atol=1e-12)
    before = {n: {k: t.clone() for k, t in pnew.params_tree[n].items()}
              for n in [l.name for l in pnew.layers[:ph.split]]}
    jh.fit_featurized(x, y, epochs=2, batch_size=len(x))
    ph.fit_featurized(x, y, epochs=2, batch_size=len(x))
    _close(pnew.params_tree, _np(jnew.params_tree), **STEP_TOL)
    for n, p in before.items():
        for k, t in p.items():
            assert torch.equal(pnew.params_tree[n][k], t)


def test_helper_refuses_a_network_without_frozen_layers():
    with pytest.raises(ValueError, match="No frozen layers"):
        transfer.TransferLearningHelper(_port_of(_mlp()))


# ---------------------------------------------------------- pretrained


def test_catalog_is_jax_catalog():
    assert set(pretrained.PRETRAINED_CATALOG) == set(jpre.PRETRAINED_CATALOG)
    for key, e in jpre.PRETRAINED_CATALOG.items():
        p = pretrained.PRETRAINED_CATALOG[key]
        assert (p.url, p.adler32) == (e.url, e.adler32)
    assert vars(pretrained.PretrainedType).keys() >= {
        "IMAGENET", "MNIST", "CIFAR10", "VGGFACE"}
    assert zoo.VGG16().pretrained_available("imagenet")
    assert not zoo.AlexNet().pretrained_available("imagenet")


def test_adler32_and_sniffing(tmp_path):
    blob = tmp_path / "blob.bin"
    data = b"deeplearning4j" * 1000
    blob.write_bytes(data)
    assert pretrained.adler32_of(str(blob)) == \
        zlib.adler32(data) & 0xFFFFFFFF == jpre.adler32_of(str(blob))
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="unrecognized"):
        pretrained.sniff_format(str(junk))
    other = tmp_path / "other.zip"
    with zipfile.ZipFile(other, "w") as zf:
        zf.writestr("readme.txt", "x")
    with pytest.raises(ValueError, match="neither"):
        pretrained.sniff_format(str(other))
    dl4j = os.path.join(FIXTURES, "dl4j", "mlp_dl4j_layout.zip")
    assert pretrained.sniff_format(dl4j) == jpre.sniff_format(dl4j) == "dl4j"


def test_fetch_checks_the_checksum_and_names_url_and_path(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(pretrained, "cache_dir", lambda: str(tmp_path))
    bad = tmp_path / "lenet_dl4j_mnist_inference.zip"
    bad.write_bytes(b"not the real weights")
    with pytest.raises(IOError, match="Checksum mismatch"):
        pretrained.fetch_pretrained("LeNet", "mnist")
    assert not bad.exists()
    url = pretrained.PRETRAINED_CATALOG[("LeNet", "mnist")].url
    with pytest.raises(IOError) as e:
        pretrained.fetch_pretrained("LeNet", "mnist")
    assert url in str(e.value) and str(bad) in str(e.value)
    assert not bad.exists()
    with pytest.raises(ValueError, match="not available"):
        pretrained.fetch_pretrained("AlexNet", "imagenet")
    with pytest.raises(IOError, match="Could not download"):
        zoo.LeNet().init_pretrained("mnist", device="cpu")


def _native_pair(tmp_path):
    jnet = _mlp("float32")
    p = str(tmp_path / "native.zip")
    jserialize.save_model(jnet, p)
    return jnet, p


def test_load_pretrained_native_dl4j_and_h5_written_by_jax(tmp_path):
    from keras_fixtures import make_dense_sequential_h5

    from deeplearning4j_tpu.keras_import import (
        import_keras_model_and_weights,
    )

    jnet, native = _native_pair(tmp_path)
    dl4j = str(tmp_path / "dl4j.zip")
    jinterop.export_dl4j_model(jnet, dl4j)
    h5 = str(tmp_path / "k.h5")
    make_dense_sequential_h5(h5)
    x = _xy(f=6, seed=3, dtype=np.float32)[0]
    for path, fmt, ref in ((native, "native", jnet),
                           (dl4j, "dl4j", jinterop.import_dl4j_model(dl4j)),
                           (h5, "keras_h5",
                            import_keras_model_and_weights(h5))):
        assert pretrained.sniff_format(path) == fmt
        net = pretrained.load_pretrained(path, device="cpu")
        xin = x if fmt != "keras_h5" else np.resize(x, (8, 8))
        np.testing.assert_allclose(_host(net.output(xin)),
                                   np.asarray(ref.output(xin)), **OUT_TOL)


def test_init_pretrained_explicit_path_and_cache_file(tmp_path,
                                                      monkeypatch):
    jnet, native = _native_pair(tmp_path)
    x = _xy(f=6, seed=4, dtype=np.float32)[0]
    want = np.asarray(jnet.output(x))
    net = zoo.LeNet().init_pretrained(path=native, device="cpu")
    np.testing.assert_allclose(_host(net.output(x)), want, **OUT_TOL)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "data"))
    local = zoo.LeNet().pretrained_path("mnist")
    assert local == os.path.join(str(tmp_path / "data"), "zoo",
                                 "lenet_mnist.zip")
    os.makedirs(os.path.dirname(local))
    os.replace(native, local)
    net = zoo.LeNet().init_pretrained("mnist", device="cpu")
    np.testing.assert_allclose(_host(net.output(x)), want, **OUT_TOL)


def test_imagenet_labels_match_jax(tmp_path, monkeypatch):
    data = {str(i): [f"n{i:08d}", f"name_{i}"] for i in range(5)}
    p = tmp_path / "imagenet_class_index.json"
    p.write_text(json.dumps(data))
    jlab = jzoo.ImageNetLabels(str(p), allow_download=False)
    plab = zoo.ImageNetLabels(str(p), allow_download=False)
    probs = np.random.default_rng(0).random((3, 5)).astype(np.float32)
    assert plab.decode_predictions(torch.tensor(probs), top=3) == \
        jlab.decode_predictions(probs, top=3)
    assert (plab.get_label(2), plab.wnid(4), len(plab)) == \
        (jlab.get_label(2), jlab.wnid(4), len(jlab))
    monkeypatch.setattr(pretrained, "cache_dir",
                        lambda: str(tmp_path / "empty"))
    os.makedirs(tmp_path / "empty")
    synth = zoo.ImageNetLabels()    # the download is refused: fallback
    assert synth.synthetic and synth.get_label(7) == "class_7"


# -------------------------------------------------------------- interop


@pytest.mark.parametrize("shape,dtype", [((7,), "FLOAT"), ((3, 4), "FLOAT"),
                                         ((2, 3, 4, 5), "FLOAT"),
                                         ((4, 5), "DOUBLE")])
def test_nd4j_codec_writes_jax_bytes(shape, dtype):
    arr = np.random.default_rng(0).standard_normal(shape)
    bp, bj = io.BytesIO(), io.BytesIO()
    interop.write_nd4j_array(bp, arr, dtype=dtype)
    jinterop.write_nd4j_array(bj, arr, dtype=dtype)
    assert bp.getvalue() == bj.getvalue()
    np.testing.assert_array_equal(interop.read_nd4j_array(bp.getvalue()),
                                  jinterop.read_nd4j_array(bj.getvalue()))
    f_order = io.BytesIO()
    pdl4j._write_buffer(f_order, np.asarray([2, 2, 3, 1, 2, 0, 1, ord("f")],
                                            ">i4"), "INT")
    pdl4j._write_buffer(f_order, np.arange(6, dtype=np.float32), "FLOAT")
    np.testing.assert_array_equal(interop.read_nd4j_array(
        f_order.getvalue()), np.arange(6).reshape((2, 3), order="F"))


def _jax_nets():
    b = JaxNNC.builder().seed(0).updater(ju.Adam(1e-2))
    nets = {
        "mlp": (JaxNet(b.activation("relu").list(
            jl.DenseLayer(n_out=16), jl.DenseLayer(n_out=8),
            jl.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JaxIT.feed_forward(5)).build()).init(),
            (6, 5), None),
        "cnn_bn": (JaxNet(JaxNNC.builder().seed(0).updater(ju.Sgd(0.01))
                          .activation("relu").list(
            jl.ConvolutionLayer(n_out=4, kernel=(3, 3)),
            jl.BatchNormalization(),
            jl.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
            jl.LocalResponseNormalization(),
            jl.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(JaxIT.convolutional(8, 8, 1)).build()).init(),
            (3, 8, 8, 1), InputType.convolutional(8, 8, 1)),
    }
    for cls in (jl.LSTM, jl.GravesLSTM):
        nets[cls.__name__] = (JaxNet(b.activation("tanh").list(
            cls(n_out=6), jl.RnnOutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JaxIT.recurrent(4)).build()).init(),
            (2, 5, 4), None)
    g = (JaxNNC.builder().seed(1).updater(ju.Adam(1e-2)).graph_builder()
         .add_inputs("in").set_input_types(JaxIT.feed_forward(6)))
    g.add_layer("a", jl.DenseLayer(n_out=5, activation="tanh"), "in")
    g.add_layer("b", jl.DenseLayer(n_out=4, activation="relu"), "in")
    from deeplearning4j_tpu.nn.graph import MergeVertex, ScaleVertex

    g.add_vertex("cat", MergeVertex(), "a", "b")
    g.add_vertex("s", ScaleVertex(scale=0.5), "cat")
    g.add_layer("out", jl.OutputLayer(n_out=3, activation="softmax"), "s")
    g.set_outputs("out")
    nets["graph"] = (JaxGraph(g.build()).init(), (4, 6), None)
    return nets


def _trained(jnet, shape):
    """Two `fit` steps of the JAX net (parameters, running statistics and
    updater state away from their initial values); returns the input."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    out = _host(jnet.output(x))
    y = np.eye(out.shape[-1], dtype=np.float32)[
        rng.integers(0, out.shape[-1], out.shape[:-1])]
    jnet.fit(x, y, epochs=2, batch_size=shape[0])
    return x


@pytest.mark.parametrize("name", ["mlp", "cnn_bn", "LSTM", "GravesLSTM",
                                  "graph"])
def test_dl4j_zip_both_ways(name, tmp_path):
    jnet, shape, it = _jax_nets()[name]
    jit = (None if it is None else JaxIT.convolutional(8, 8, 1))
    x = _trained(jnet, shape)
    jzip = str(tmp_path / "jax.zip")
    jinterop.export_dl4j_model(jnet, jzip, save_updater=True)
    jback = jinterop.import_dl4j_model(jzip, input_type=jit)
    pback = interop.import_dl4j_model(jzip, input_type=it, device="cpu")
    assert pback.conf.to_json() == jback.conf.to_json()
    _equal(pback.params_tree, _np(jback.params_tree))
    _equal(pback.state_tree, _np(jback.state_tree))
    np.testing.assert_array_equal(pback.dl4j_updater_state,
                                  jback.dl4j_updater_state)
    np.testing.assert_allclose(_host(pback.output(x)),
                               _host(jback.output(x)), **OUT_TOL)
    # the port's export of the same network is JAX's file, entry by entry
    pnet = _port_of(jnet)
    pzip = str(tmp_path / "port.zip")
    interop.export_dl4j_model(pnet, pzip, save_updater=True)
    with zipfile.ZipFile(jzip) as a, zipfile.ZipFile(pzip) as b:
        assert a.namelist() == b.namelist()
        for n in a.namelist():
            assert a.read(n) == b.read(n), n
    back = jinterop.import_dl4j_model(pzip, input_type=jit)
    np.testing.assert_allclose(_host(back.output(x)),
                               _host(jnet.output(x)), **OUT_TOL)


def test_committed_dl4j_fixtures_predict_their_oracles():
    import sys

    base = os.path.join(FIXTURES, "dl4j")
    net = interop.import_dl4j_model(os.path.join(base, "mlp_dl4j_layout.zip"),
                                    device="cpu")
    rec = np.load(os.path.join(base, "mlp_dl4j_layout_expected.npz"))
    np.testing.assert_allclose(_host(net.output(rec["x"])), rec["y"],
                               rtol=1e-5, atol=1e-6)
    zdir = os.path.join(FIXTURES, "dl4j_zoo")
    lstm = interop.import_dl4j_model(
        os.path.join(zdir, "graveslstm_dl4j_inference.v1.zip"), device="cpu")
    blob = np.load(os.path.join(zdir, "graveslstm_expected.npz"))
    np.testing.assert_allclose(_host(lstm.output(blob["x"])), blob["y"],
                               rtol=1e-4, atol=1e-5)
    sys.path.insert(0, zdir)
    try:
        mg = __import__("make_graph_fixture")
        mm = __import__("make_fixture")
    finally:
        sys.path.pop(0)
    for mod, zname in ((mg, "minigraph_dl4j_inference.v1.zip"),
                       (mm, "minimlp_dl4j_inference.v1.zip")):
        net = pretrained.load_pretrained(os.path.join(zdir, zname),
                                         device="cpu")
        x = np.random.default_rng(7).standard_normal(
            (5, mod.N_IN)).astype(np.float32)
        np.testing.assert_allclose(_host(net.output(x)),
                                   mod.expected_output(x),
                                   rtol=1e-5, atol=1e-6)


def test_dropping_the_lstm_permutation_breaks_the_graves_oracle(
        monkeypatch):
    zdir = os.path.join(FIXTURES, "dl4j_zoo")
    monkeypatch.setattr(pdl4j, "_lstm_col_perm",
                        lambda h, to_framework: np.arange(4 * h))
    net = interop.import_dl4j_model(
        os.path.join(zdir, "graveslstm_dl4j_inference.v1.zip"), device="cpu")
    blob = np.load(os.path.join(zdir, "graveslstm_expected.npz"))
    assert np.abs(_host(net.output(blob["x"])) - blob["y"]).max() > 1e-2


def test_short_coefficients_raise_as_jax(tmp_path):
    conf = {"confs": [{"layer": {"dense": {
        "activationFn": {"@class":
                         "org.nd4j.linalg.activations.impl.ActivationTanH"},
        "nin": 3, "nout": 2}}}]}
    p = tmp_path / "bad.zip"
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        buf = io.BytesIO()
        jinterop.write_nd4j_array(buf, np.zeros((1, 5), np.float32))
        zf.writestr("coefficients.bin", buf.getvalue())
    with pytest.raises(ValueError, match="coefficients.bin") as ej:
        jinterop.import_dl4j_model(p)
    with pytest.raises(ValueError, match="coefficients.bin") as ep:
        interop.import_dl4j_model(p, device="cpu")
    assert str(ep.value) == str(ej.value)


# -------------------------------------------------------------- gateway


def test_keras_gateway_import_fit_predict_over_http(tmp_path):
    from keras_fixtures import make_dense_sequential_h5

    from deeplearning4j_tpu_torch.keras_import import (
        import_keras_model_and_weights,
    )
    from deeplearning4j_tpu_torch.serving import KerasGatewayServer

    h5 = str(tmp_path / "model.h5")
    make_dense_sequential_h5(h5, scale=0.3)
    direct = import_keras_model_and_weights(h5, device="cpu")
    gw = KerasGatewayServer(device="cpu")
    port = gw.start()
    try:
        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        mid = post("/import", {"path": h5})["model_id"]
        rng = np.random.default_rng(1)
        x = rng.standard_normal((64, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
        out = np.asarray(post("/predict", {
            "model_id": mid, "features": x[:4].tolist()})["output"])
        np.testing.assert_allclose(out, _host(direct.output(x[:4])),
                                   rtol=1e-6, atol=1e-7)
        s1 = post("/fit", {"model_id": mid, "features": x.tolist(),
                           "labels": y.tolist(), "epochs": 1})["score"]
        s2 = post("/fit", {"model_id": mid, "features": x.tolist(),
                           "labels": y.tolist(), "epochs": 10})["score"]
        assert s2 < s1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/models",
                                    timeout=10) as r:
            assert json.loads(r.read())["models"] == [mid]
    finally:
        gw.stop()
