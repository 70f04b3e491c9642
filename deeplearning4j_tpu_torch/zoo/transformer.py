"""Transformer zoo model (port of `deeplearning4j_tpu/zoo/transformer.py`):
the GPT-style causal byte LM built from EmbeddingSequenceLayer +
PositionEmbeddingLayer + TransformerEncoderBlock + RnnOutputLayer, with
the same options (RoPE, RMSNorm, SwiGLU, GQA, per-block windows, rolling
cache) and the same configuration for the same arguments, its default
updater `Adam(3e-4)` included."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingSequenceLayer, PositionEmbeddingLayer, RnnOutputLayer,
    TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.optim.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel, register_zoo


@register_zoo
class TextGenerationTransformer(ZooModel):
    """GPT-style causal byte/char LM: token ids [batch, time, 1] in,
    per-timestep softmax over the vocabulary out."""

    num_classes = 256
    input_shape = (256, 1)

    def __init__(self, *args, d_model: int = 256, num_heads: int = 8,
                 num_kv_heads=None, num_blocks: int = 4, n_experts: int = 0,
                 pos_encoding: str = "learned", max_decode: int = 0,
                 norm: str = "layer", ffn_activation: str = "gelu",
                 window=None, rolling_cache: bool = False, **kw):
        super().__init__(*args, **kw)
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.num_blocks = num_blocks
        self.n_experts = n_experts
        self.norm = norm
        self.ffn_activation = ffn_activation
        self.window = window
        if isinstance(window, (list, tuple)):
            if len(window) != num_blocks:
                raise ValueError(
                    f"per-block window list has {len(window)} entries "
                    f"for {num_blocks} blocks")
            if rolling_cache and any(w is None for w in window):
                raise ValueError(
                    "rolling_cache needs a window on EVERY block")
        if rolling_cache and (window is None or pos_encoding != "rope"):
            raise ValueError(
                "rolling_cache needs window=w and pos_encoding='rope'")
        if rolling_cache and max_decode:
            raise ValueError("rolling_cache makes generation length "
                             "unbounded; drop max_decode")
        self.rolling_cache = rolling_cache
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding must be 'learned' or 'rope', "
                             f"got {pos_encoding!r}")
        if max_decode and pos_encoding != "rope":
            raise ValueError("max_decode needs pos_encoding='rope'")
        self.pos_encoding = pos_encoding
        self.max_decode = max_decode

    def conf(self):
        t = self.input_shape[0]
        vocab = self.num_classes
        rope = self.pos_encoding == "rope"
        per_block = (list(self.window)
                     if isinstance(self.window, (list, tuple))
                     else [self.window] * self.num_blocks)

        def block_cache(w):
            if self.rolling_cache:
                return t + w - 1     # prefill + window ring slots
            return max(t, self.max_decode) if rope else t

        blocks = [
            TransformerEncoderBlock(
                num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
                causal=True, n_experts=self.n_experts,
                max_cache=block_cache(w), rope=rope, norm=self.norm,
                ffn_activation=self.ffn_activation, window=w,
                rolling_cache=self.rolling_cache)
            for w in per_block
        ]
        pos = [] if rope else [PositionEmbeddingLayer(max_length=t)]
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.kw.get("updater", Adam(3e-4)))
                .activation("identity")
                .weight_init("xavier")
                .list(
                    EmbeddingSequenceLayer(n_in=vocab, n_out=self.d_model,
                                           activation="identity"),
                    *pos,
                    *blocks,
                    RnnOutputLayer(n_out=vocab, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.recurrent(1, t))
                .build())
