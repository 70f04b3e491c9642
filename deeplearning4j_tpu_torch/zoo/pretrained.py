"""Pretrained-weight catalog + fetch/verify/load machinery for the zoo
(port of `deeplearning4j_tpu/zoo/pretrained.py`: the catalog, the
Adler32 check and the format sniffing are copied, the loaders are the
port's own).

Reference parity: `zoo/ZooModel.java:28-75` — `initPretrained(type)`
resolves a per-model URL (`pretrainedUrl`), downloads to
`~/.deeplearning4j/`, verifies an Adler32 checksum
(`pretrainedChecksum`), and restores via ModelSerializer. The catalog
below carries the reference's own published URLs and Adler32 checksums
verbatim, so a file fetched for DL4J validates identically here.

Loading understands three formats (sniffed from the file):
- this framework's native checkpoint zip (models/serialize.py),
- the reference's DL4J zip container (interop/dl4j.py — the
  `configuration.json` + `coefficients.bin` layout the published zoo
  files use),
- Keras .h5 (keras_import/) for weights converted via Keras.

Zero-egress environments: the download step raises with the exact URL +
cache path so the file can be fetched out-of-band and dropped in place —
never a silent failure. A loaded network lives on `device` (CUDA by
default).
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
import zlib
from typing import Dict, Optional, Tuple


class PretrainedType:
    """Reference: `zoo/PretrainedType.java` enum."""

    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"


@dataclasses.dataclass(frozen=True)
class PretrainedEntry:
    url: str
    adler32: int       # 0 = unverified (reference convention)


# (model class name, pretrained type) → entry. URLs + Adler32 checksums are
# the reference's published values (VGG16.java:58-78, VGG19.java:56-68,
# ResNet50.java:56-68, LeNet.java:54-66, GoogLeNet.java:58-70).
PRETRAINED_CATALOG: Dict[Tuple[str, str], PretrainedEntry] = {
    ("VGG16", PretrainedType.IMAGENET): PretrainedEntry(
        "http://blob.deeplearning4j.org/models/vgg16_dl4j_inference.zip",
        3501732770),
    ("VGG16", PretrainedType.CIFAR10): PretrainedEntry(
        "http://blob.deeplearning4j.org/models/"
        "vgg16_dl4j_cifar10_inference.v1.zip", 2192260131),
    ("VGG16", PretrainedType.VGGFACE): PretrainedEntry(
        "http://blob.deeplearning4j.org/models/"
        "vgg16_dl4j_vggface_inference.v1.zip", 2706403553),
    ("VGG19", PretrainedType.IMAGENET): PretrainedEntry(
        "http://blob.deeplearning4j.org/models/vgg19_dl4j_inference.zip",
        2782932419),
    ("ResNet50", PretrainedType.IMAGENET): PretrainedEntry(
        "http://blob.deeplearning4j.org/models/resnet50_dl4j_inference.zip",
        1982516793),
    ("LeNet", PretrainedType.MNIST): PretrainedEntry(
        "http://blob.deeplearning4j.org/models/"
        "lenet_dl4j_mnist_inference.zip", 3337733202),
    # GoogLeNet.java:68 repeats LeNet's checksum verbatim — an apparent
    # copy-paste bug in the reference (two distinct zips cannot share an
    # Adler32). Kept unverified (0) so a genuine download isn't rejected.
    ("GoogLeNet", PretrainedType.IMAGENET): PretrainedEntry(
        "http://blob.deeplearning4j.org/models/googlenet_dl4j_inference.zip",
        0),
}


def cache_dir() -> str:
    from deeplearning4j_tpu_torch.data.datasets import data_dir

    d = os.path.join(data_dir(), "zoo")
    os.makedirs(d, exist_ok=True)
    return d


def adler32_of(path: str) -> int:
    """Reference: ZooModel.initPretrained's Adler32 over the file."""
    value = 1
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            value = zlib.adler32(chunk, value)
    return value & 0xFFFFFFFF


def fetch_pretrained(model_name: str, kind: str,
                     dest: Optional[str] = None) -> str:
    """Resolve from cache or download + checksum-verify. Returns the local
    path. Reference: `ZooModel.initPretrained:40-75`."""
    entry = PRETRAINED_CATALOG.get((model_name, kind))
    if entry is None:
        raise ValueError(
            f"Pretrained {kind!r} weights are not available for "
            f"{model_name} (reference parity: pretrainedUrl returns null)")
    dest = dest or os.path.join(cache_dir(), os.path.basename(entry.url))
    if not os.path.exists(dest):
        try:
            _download(entry.url, dest)
        except Exception as e:
            if os.path.exists(dest):
                os.remove(dest)
            raise IOError(
                f"Could not download {entry.url} ({e}). Fetch it out-of-band "
                f"and place it at {dest} — this environment may have no "
                f"egress.") from e
    if entry.adler32:
        got = adler32_of(dest)
        if got != entry.adler32:
            os.remove(dest)  # keep the cache clean so a retry re-downloads
            raise IOError(
                f"Checksum mismatch for {dest}: adler32 {got} != expected "
                f"{entry.adler32} — corrupt download removed; retry")
    return dest


def _download(url: str, dest: str) -> None:
    """Fetch a catalog URL to `dest` (the one place the zoo reaches the
    network)."""
    import urllib.request

    urllib.request.urlretrieve(url, dest)  # nosec - catalog URL


def sniff_format(path: str) -> str:
    """native | dl4j | keras_h5 — decided by file contents, not extension."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
        if "metadata.json" in names and "coefficients.npz" in names:
            return "native"
        if "configuration.json" in names and "coefficients.bin" in names:
            return "dl4j"
        raise ValueError(
            f"{path}: zip is neither a native checkpoint "
            "(metadata.json+coefficients.npz) nor a DL4J container "
            "(configuration.json+coefficients.bin)")
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"\x89HDF"):
        return "keras_h5"
    raise ValueError(f"{path}: unrecognized checkpoint format")


def load_pretrained(path: str, device=None):
    """Load a checkpoint of any supported format into a network on
    `device` (CUDA by default)."""
    fmt = sniff_format(path)
    if fmt == "native":
        from deeplearning4j_tpu_torch.models.serialize import load_model

        return load_model(path, device=device)
    if fmt == "dl4j":
        from deeplearning4j_tpu_torch.interop import import_dl4j_model

        return import_dl4j_model(path, device=device)
    from deeplearning4j_tpu_torch.keras_import import (
        import_keras_model_and_weights,
    )

    return import_keras_model_and_weights(path, device=device)
