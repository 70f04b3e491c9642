"""Word-vector serialization — text + Google binary word2vec formats.

A copy of `deeplearning4j_tpu/nlp/serializer.py`,
which imports nothing of JAX: the port keeps its own.

Reference parity: `models/embeddings/loader/WordVectorSerializer.java`
(2,829 LoC): writeWordVectors/loadTxtVectors (text: "word v1 v2 ...") and
the Google word2vec binary format (header "V D\\n", then per word: name,
space, D float32 little-endian). Both formats interop with the reference
and with original word2vec/gensim tooling.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord


def write_word_vectors(model, path: str) -> None:
    """Text format. Reference: WordVectorSerializer.writeWordVectors."""
    with open(path, "w", encoding="utf-8") as f:
        for i in range(len(model.vocab)):
            vec = " ".join(f"{v:.6f}" for v in model.syn0[i])
            f.write(f"{model.vocab.word_at(i)} {vec}\n")


def read_word_vectors(path: str) -> Tuple[VocabCache, np.ndarray]:
    """Reference: WordVectorSerializer.loadTxtVectors."""
    words, rows = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            words.append(parts[0])
            rows.append(np.array([float(x) for x in parts[1:]], np.float32))
    vocab = VocabCache()
    for w in words:
        vocab.add(VocabWord(word=w, count=1))
    return vocab, np.stack(rows)


def write_binary(model, path: str) -> None:
    """Google word2vec binary format. Reference:
    WordVectorSerializer.writeWordVectors(binary=true)."""
    V, D = model.syn0.shape
    with open(path, "wb") as f:
        f.write(f"{V} {D}\n".encode())
        for i in range(V):
            f.write(model.vocab.word_at(i).encode("utf-8") + b" ")
            f.write(model.syn0[i].astype("<f4").tobytes())
            f.write(b"\n")


def read_binary(path: str) -> Tuple[VocabCache, np.ndarray]:
    """Reference: WordVectorSerializer.loadGoogleModel(binary=true).

    Hot path: the body is parsed by the native C++ codec
    (`native.w2v_parse` — one scan, bulk vector memcpy, the host-side
    equivalent of the reference's buffered-stream loader for GB-scale
    files); byte-by-byte Python remains as the no-toolchain fallback."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip().split()
        V, D = int(header[0]), int(header[1])
        body_start = f.tell()
        from deeplearning4j_tpu_torch import native

        parsed = native.w2v_parse(f.read(), V, D) if native.available() \
            else None
        if parsed is not None:
            words, mat = parsed
            vocab = VocabCache()
            for w in words:
                vocab.add(VocabWord(word=w, count=1))
            return vocab, mat
        f.seek(body_start)
        vocab = VocabCache()
        mat = np.zeros((V, D), np.float32)
        for i in range(V):
            word = bytearray()
            while True:
                ch = f.read(1)
                if ch in (b" ", b""):
                    break
                if ch not in (b"\n", b"\r"):   # CRLF files: match native
                    word.extend(ch)
            mat[i] = np.frombuffer(f.read(4 * D), "<f4")
            nl = f.read(1)
            if nl not in (b"\n", b""):
                f.seek(-1, 1)
            vocab.add(VocabWord(word=word.decode("utf-8"), count=1))
    return vocab, mat
