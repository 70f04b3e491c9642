"""Special layers: FrozenLayer, CenterLossOutputLayer, the variational
autoencoder and the RBM (port of `deeplearning4j_tpu/nn/layers/special.py`).

The random draws of the pretraining objectives come from two private
helpers, `_eps` (the VAE's reparametrisation noise) and `_bernoulli`
(the RBM's hidden samples), so that a test can feed JAX's draws in
their place. Both draw from the explicit generator they are given, on
its device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation, softplus
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
from deeplearning4j_tpu_torch.optim.updaters import tree_map


def _eps(gen, shape, dtype, device) -> torch.Tensor:
    """Standard normal noise of `shape` (the VAE's reparametrisation)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _bernoulli(gen, p: torch.Tensor) -> torch.Tensor:
    """0/1 samples with probabilities `p`, in p's dtype."""
    u = torch.rand(p.shape, generator=gen, dtype=p.dtype, device=p.device)
    return (u < p).to(p.dtype)


@register_layer
@dataclasses.dataclass(frozen=True)
class FrozenLayer(Layer):
    """An inner layer whose parameters do not train: the runtimes give
    it the NoOp updater (`frozen`), so no fused update touches its
    leaves, and `apply` detaches them, so no gradient reaches them
    either. Its parameter tree is the inner layer's."""

    layer: Optional[Any] = None
    frozen: bool = True

    def infer_n_in(self, input_type: InputType):
        return dataclasses.replace(self,
                                   layer=self.layer.infer_n_in(input_type))

    def with_defaults(self, **defaults):
        return dataclasses.replace(self,
                                   layer=self.layer.with_defaults(**defaults))

    def output_type(self, input_type: InputType) -> InputType:
        return self.layer.output_type(input_type)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return self.layer.init_params(gen, input_type, dtype)

    def apply(self, params, x, **kw):
        return self.layer.apply(tree_map(torch.detach, params), x, **kw)


@register_layer
@dataclasses.dataclass(frozen=True)
class CenterLossOutputLayer(OutputLayer):
    """Output layer with center loss (Wen et al.; DL4J's
    `CenterLossOutputLayer`): the class loss plus `lambda_` times half
    the mean squared distance of each example's input to its class
    center. The centers ([n_out, n_in]) are layer state, moved by an EMA
    (rate `alpha`) toward the batch's per-class mean offset in
    `score_and_state`; the plain `score` reads no centers."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_params(self, gen, input_type, dtype=torch.float32):
        params, _ = super().init_params(gen, input_type, dtype)
        return params, {"centers": torch.zeros((self.n_out, self.n_in),
                                               dtype=dtype)}

    def score_and_state(self, params, x, labels, state, mask=None):
        """(loss with the center term, {"centers": the EMA-moved
        centers, detached})."""
        base = super().score(params, x, labels, mask)
        centers = state["centers"]
        lab = labels.to(centers.dtype)
        diff = x - lab @ centers                              # [B, n_in]
        center_loss = 0.5 * torch.mean(torch.sum(diff * diff, dim=-1))
        counts = torch.clamp(lab.sum(dim=0), min=1.0)          # [n_out]
        delta = (lab.T @ diff.detach()) / counts[:, None]
        new_centers = centers + self.alpha * delta
        return base + self.lambda_ * center_loss, {"centers": new_centers}


@register_layer
@dataclasses.dataclass(frozen=True)
class VariationalAutoencoder(Layer):
    """VAE as a layer, pretrainable by its ELBO (DL4J's
    `VariationalAutoencoder`): encoder MLP (`encoder_sizes`, the layer's
    activation, tanh by default) to the latent mean and log-variance,
    decoder MLP (`decoder_sizes`) to the reconstruction distribution's
    parameters, gaussian (mean and log-variance) or bernoulli (logits).
    The supervised forward emits the latent mean. Parameters are nested:
    `enc` / `dec` (blocks "0", "1", ... of `W`, `b`), `mu`, `logvar`,
    `rec`, as in JAX."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None            # latent size
    encoder_sizes: Sequence[int] = (64,)
    decoder_sizes: Sequence[int] = (64,)
    reconstruction_distribution: str = "gaussian"   # gaussian | bernoulli
    num_samples: int = 1

    @property
    def is_pretrainable(self) -> bool:
        return True

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def _dense(self, gen, a, b, dtype):
        return {"W": self._winit()(gen, (a, b), dtype),
                "b": torch.zeros((b,), dtype=dtype)}

    def init_params(self, gen, input_type, dtype=torch.float32):
        enc_sizes = [self.n_in, *self.encoder_sizes]
        dec_sizes = [self.n_out, *self.decoder_sizes]
        enc = {str(i): self._dense(gen, a, b, dtype)
               for i, (a, b) in enumerate(zip(enc_sizes[:-1], enc_sizes[1:]))}
        dec = {str(i): self._dense(gen, a, b, dtype)
               for i, (a, b) in enumerate(zip(dec_sizes[:-1], dec_sizes[1:]))}
        eh, dh = enc_sizes[-1], dec_sizes[-1]
        rec_out = self.n_in * (2 if self.reconstruction_distribution ==
                               "gaussian" else 1)
        return {"enc": enc, "dec": dec,
                "mu": self._dense(gen, eh, self.n_out, dtype),
                "logvar": self._dense(gen, eh, self.n_out, dtype),
                "rec": self._dense(gen, dh, rec_out, dtype)}, {}

    def _mlp(self, blocks, x):
        act = Activation.get(self.activation or "tanh")
        for i in range(len(blocks)):
            p = blocks[str(i)]
            x = act(x @ p["W"] + p["b"])
        return x

    def encode(self, params, x):
        h = self._mlp(params["enc"], x)
        mu = h @ params["mu"]["W"] + params["mu"]["b"]
        logvar = h @ params["logvar"]["W"] + params["logvar"]["b"]
        return mu, logvar

    def decode(self, params, z):
        h = self._mlp(params["dec"], z)
        return h @ params["rec"]["W"] + params["rec"]["b"]

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        mu, _ = self.encode(params, x)
        return mu, state

    def reconstruction_score(self, params, x, *, rng=None):
        """The negative ELBO (to minimize), averaged over the batch: the
        reconstruction's negative log-likelihood, averaged over
        `num_samples` latent draws, plus the KL term."""
        mu, logvar = self.encode(params, x)
        total = 0.0
        for _ in range(self.num_samples):
            eps = _eps(rng, mu.shape, mu.dtype, mu.device)
            out = self.decode(params, mu + torch.exp(0.5 * logvar) * eps)
            if self.reconstruction_distribution == "bernoulli":
                # -log p under Bernoulli(sigmoid(out))
                nll = torch.sum(softplus(out) - x * out, dim=-1)
            else:
                rmu, rlogvar = torch.chunk(out, 2, dim=-1)
                nll = 0.5 * torch.sum(
                    rlogvar + (x - rmu) ** 2 / torch.exp(rlogvar)
                    + math.log(2 * math.pi), dim=-1)
            total = total + torch.mean(nll)
        rec = total / self.num_samples
        kl = -0.5 * torch.mean(torch.sum(1 + logvar - mu ** 2
                                         - torch.exp(logvar), dim=-1))
        return rec + kl


@register_layer
@dataclasses.dataclass(frozen=True)
class RBM(Layer):
    """Bernoulli restricted Boltzmann machine, pretrained by CD-k (DL4J's
    `RBM`). The supervised forward is the hidden probabilities
    (propup)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    k: int = 1   # CD-k steps

    @property
    def is_pretrainable(self) -> bool:
        return True

    def infer_n_in(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._winit()(gen, (self.n_in, self.n_out), dtype),
                "hb": torch.zeros((self.n_out,), dtype=dtype),
                "vb": torch.zeros((self.n_in,), dtype=dtype)}, {}

    def propup(self, params, v):
        return torch.sigmoid(v @ params["W"] + params["hb"])

    def propdown(self, params, h):
        return torch.sigmoid(h @ params["W"].T + params["vb"])

    def apply(self, params, x, *, state=None, train=False, rng=None,
              mask=None):
        return self.propup(params, x), state

    def reconstruction_score(self, params, v0, *, rng=None):
        """The CD-k surrogate: mean free energy of the data minus that of
        the k-step Gibbs chain's end v_k, with v_k detached, so its
        gradient is the contrastive-divergence update."""
        def free_energy(v):
            wx = v @ params["W"] + params["hb"]
            return -v @ params["vb"] - torch.sum(softplus(wx), dim=-1)

        vk = v0
        for _ in range(self.k):
            h = _bernoulli(rng, self.propup(params, vk))
            vk = self.propdown(params, h)
        vk = vk.detach()
        return torch.mean(free_energy(v0) - free_energy(vk))
