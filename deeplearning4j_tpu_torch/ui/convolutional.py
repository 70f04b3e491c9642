"""Convolutional-activations UI module: feature-map rendering (port of
`deeplearning4j_tpu/ui/convolutional.py`).

Reference parity: `ui/module/convolutional/ConvolutionalListenerModule.java:29-52`
(+ `ui/weights/ConvolutionalIterationListener.java`): a listener renders
the conv layers' activations for the current minibatch into one tiled
grayscale image, posts it as static info typed "ConvolutionalListener",
and the UI serves the latest image at /activations (+ /activations/data).

The listener runs one extra forward (`feed_forward`, no gradient) on a
slice of the last training batch on the model's device, and reads back
only the 4-D (NHWC) activations it draws, packed into one copy. The
tiling and the PNG encoder are the JAX package's numpy and stdlib code,
so the same activations give the same PNG bytes in both packages (the
reference uses BufferedImage/ImageIO jpg).
"""

from __future__ import annotations

import base64
import struct
import zlib
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optim.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.storage import Persistable

TYPE_ID = "ConvolutionalListener"

# 1x1 transparent-ish placeholder served before any report lands
# (reference returns empty bytes; an actual tiny PNG renders cleanly)
_EMPTY: Optional[bytes] = None


def encode_grayscale_png(img: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG encoder (pure stdlib). `img` is
    [H, W] uint8."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def empty_png() -> bytes:
    global _EMPTY
    if _EMPTY is None:
        _EMPTY = encode_grayscale_png(np.zeros((1, 1), np.uint8))
    return _EMPTY


def tile_feature_maps(act: np.ndarray, *, max_maps: int = 64,
                      pad: int = 1, example: int = 0) -> np.ndarray:
    """Tile one example's [H, W, C] feature maps into a near-square
    [rows*H', cols*W'] uint8 grid, each map min-max normalized (the
    reference normalizes per-map before drawing into the grid)."""
    if act.ndim == 4:
        act = act[example]
    h, w, c = act.shape
    c = min(c, max_maps)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    out = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad),
                   np.uint8)
    for i in range(c):
        m = np.asarray(act[:, :, i], np.float32)
        lo, hi = float(m.min()), float(m.max())
        scaled = ((m - lo) / (hi - lo) * 255.0 if hi > lo
                  else np.zeros_like(m)).astype(np.uint8)
        r, col = divmod(i, cols)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        out[y0:y0 + h, x0:x0 + w] = scaled
    return out


def render_activation_grid(acts: List[np.ndarray], *,
                           max_maps: int = 64,
                           examples: int = 1) -> bytes:
    """Stack each conv layer's tiled grid vertically into one PNG (the
    reference's single combined BufferedImage); with examples > 1 each
    layer contributes one tiled grid per rendered example."""
    tiles = [tile_feature_maps(np.asarray(a), max_maps=max_maps,
                               example=e)
             for a in acts
             for e in range(min(examples, np.asarray(a).shape[0])
                            if np.asarray(a).ndim == 4 else 1)]
    if not tiles:
        return empty_png()
    width = max(t.shape[1] for t in tiles)
    sep = 3
    rows = []
    for t in tiles:
        if t.shape[1] < width:
            t = np.pad(t, ((0, 0), (0, width - t.shape[1])))
        rows.append(t)
        rows.append(np.full((sep, width), 32, np.uint8))  # separator band
    return encode_grayscale_png(np.concatenate(rows[:-1]))


class ConvolutionalIterationListener(TrainingListener):
    """Reference: `ui/weights/ConvolutionalIterationListener.java` — every
    `frequency` iterations, render the conv-layer activations of (a slice
    of) the current minibatch and post them as a static-info Persistable
    the ConvolutionalListenerModule serves."""

    def __init__(self, router, frequency: int = 10, *,
                 session_id: Optional[str] = None, worker_id: str = "local",
                 max_maps: int = 64, examples: int = 1):
        import uuid

        self.router = router
        self.frequency = max(frequency, 1)
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id
        self.max_maps = max_maps
        self.examples = examples
        self._count = 0

    def iteration_done(self, model, iteration, epoch, score):
        self._count += 1
        if self._count % self.frequency:
            return
        feats = getattr(model, "_last_features", None)
        ff = getattr(model, "feed_forward", None)
        if feats is None or ff is None:
            return
        acts = ff(feats[:self.examples])
        layers = getattr(model.conf, "layers", [])
        conv, names = [], []
        for layer, a in zip(layers, acts):
            if a.ndim == 4:  # NHWC feature maps
                conv.append(a)
                names.append(layer.name)
        if not conv:
            return
        # one read-back of every drawn map, widened to float32 (exact
        # from bfloat16) as the JAX package's tiling reads them
        flat = torch.cat([a.reshape(-1).float() for a in conv]).cpu()
        sizes = [a.numel() for a in conv]
        conv_acts = [c.numpy().reshape(a.shape) for c, a in
                     zip(torch.split(flat, sizes), conv)]
        import time

        png = render_activation_grid(conv_acts, max_maps=self.max_maps,
                                     examples=self.examples)
        self.router.put_static_info(Persistable(
            session_id=self.session_id, type_id=TYPE_ID,
            worker_id=self.worker_id, timestamp=time.time(),
            content={
                "iteration": int(iteration),
                "layers": names,
                "png_b64": base64.b64encode(png).decode("ascii"),
            }))


def latest_activation_png(storage) -> bytes:
    """The newest ConvolutionalListener static record's PNG across all
    sessions (reference getImage(): latest PostStaticInfo event wins;
    empty image when none)."""
    best = None
    for sid in storage.list_session_ids():
        for wid in storage.list_worker_ids(sid, TYPE_ID):
            p = storage.get_static_info(sid, TYPE_ID, wid)
            if p is not None and (best is None
                                  or p.timestamp > best.timestamp):
                best = p
    if best is None or "png_b64" not in best.content:
        return empty_png()
    return base64.b64decode(best.content["png_b64"])
