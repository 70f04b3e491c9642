#!/usr/bin/env python3
"""Where `chip_smoke.lenet_parity`'s card-vs-CPU gap comes from
(ROADMAP C10).

    python3 tools/torch_c10_lenet.py [--seeds 0 1 2] [--steps 8]

`lenet_parity`'s setup: the zoo's LeNet in float32 from one
configuration JSON and one seeded init, one fixed batch of 64 drawn from
`np.random.default_rng(seed)` as `lenet_parity` draws it, `steps` steps
of `fit` under Sgd(0.1), Adam(1e-3, eps 1e-3) and Nesterovs(0.01, 0.9),
cuDNN's deterministic algorithms on, TF32 off. For every seed and
updater, after every step, the largest absolute parameter difference of:

- (a) `f32_vs_f64`: the port in float32 against the port in float64, both
  on the CPU, from the same weights: the problem's own conditioning,
  with no card involved;
- (b) `card_vs_cpu`: the card against the CPU, both free-running (what
  `lenet_parity` checks);
- (c) `one_step`: the card against the CPU when the CPU's parameters
  and optimizer state are copied onto the card before each step: the
  gap one step makes;
- (d) `pool_flips`: during (c), the max-pool windows (both pooling
  layers) whose argmax differs between the card's and the CPU's input
  to the layer, and each one's top-two gap on the CPU (0 for an exact
  tie) and its gap on the card (the card's top value less the card's
  value at the CPU's argmax: above 0 where the card's own values, not a
  rule for ties, pick its index), with the smallest top-two gap of all
  windows beside it; and the ReLU units (the dense layer) active on one
  side only, each with its value on the active side;
- (e) `f64_flips`: the same count between the port in float64 and in
  float32 on the CPU, each step from the float32 run's state: where (a)
  stays small while (b) drifts, whether float64 left the windows alone
  that the card flipped.

Ties themselves route alike on both runtimes and in JAX:
`tests/test_torch_maxpool_ties.py`.

Prints one JSON line a (seed, updater), then a summary line with the
card's name and power limit. `--device cpu` rehearses it without a card
(the "card" is then a second CPU net, every gap 0).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def updaters():
    from deeplearning4j_tpu_torch.optim.updaters import Adam, Nesterovs, Sgd

    return {"sgd": Sgd(0.1), "adam": Adam(1e-3, epsilon=1e-3),
            "nesterovs": Nesterovs(0.01, 0.9)}


def make_net(js: str, device, dtype="float32"):
    import dataclasses

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration

    conf = MultiLayerConfiguration.from_json(js)
    if dtype != "float32":
        conf = dataclasses.replace(conf, dtype=dtype)
    return MultiLayerNetwork(conf, device=device).init()


def leaves(tree):
    from deeplearning4j_tpu_torch.optim.updaters import tree_leaves

    return tree_leaves(tree)


def copy_into(dst, src) -> None:
    """Copy `src`'s parameters, optimizer state and iteration count (Adam's
    bias correction reads it) into `dst` in place."""
    dst.iteration = src.iteration
    for a, b in zip(leaves(dst.params_tree), leaves(src.params_tree)):
        a.copy_(b)
    for a, b in zip(leaves(dst.updater_state), leaves(src.updater_state)):
        a.copy_(b)


def gap(x, y) -> float:
    return max((a.double().cpu() - b.double().cpu()).abs().max().item()
               for a, b in zip(leaves(x.params_tree), leaves(y.params_tree)))


def pool_inputs(net, x):
    """The input of every max-pooling layer for features `x`."""
    out = {}
    for i, layer in enumerate(net.layers):
        if type(layer).__name__ == "SubsamplingLayer" and \
                layer.pooling == "max":
            with torch.no_grad():
                h, _ = net._forward(net.params_tree, x, stop=i)
            out[layer.name] = (h, layer)
    return out


def windows(h, layer):
    """[N, k*k] values of every pooling window of NHWC `h` (truncate
    mode, no padding: LeNet's)."""
    k, s = layer.kernel, layer.stride
    u = F.unfold(h.permute(0, 3, 1, 2).double(), k, stride=s)
    B, C = h.shape[0], h.shape[3]
    kk = k[0] * k[1]
    return u.reshape(B, C, kk, -1).permute(0, 1, 3, 2).reshape(-1, kk)


def pool_flips(card, cpu, x_card, x_cpu) -> dict:
    got = pool_inputs(card, x_card)
    want = pool_inputs(cpu, x_cpu)
    out = relu_flips(card, cpu, x_card, x_cpu)
    for name, (h_cpu, layer) in want.items():
        w_cpu = windows(h_cpu, layer)
        w_card = windows(got[name][0].cpu(), layer)
        top2 = torch.topk(w_cpu, 2, dim=1).values
        gaps = top2[:, 0] - top2[:, 1]
        am = w_cpu.argmax(1)
        flip = w_card.argmax(1) != am
        card_gaps = (w_card.max(1).values
                     - w_card.gather(1, am[:, None])[:, 0])
        out[name] = {"windows": int(w_cpu.shape[0]),
                     "flips": int(flip.sum()),
                     "flip_gaps": gaps[flip].tolist()[:16],
                     "flip_card_gaps": card_gaps[flip].tolist()[:16],
                     "ties": int((gaps == 0).sum()),
                     "min_gap": float(gaps.min()),
                     "max_abs_input_err": float(
                         (w_card - w_cpu).abs().max())}
    return out


def relu_flips(card, cpu, x_card, x_cpu) -> dict:
    """The ReLU units (of every ReLU layer) active on one side and not on
    the other, each with its output on the side where it is active (how
    far above 0 the unit lies)."""
    out = {}
    for i, layer in enumerate(cpu.layers):
        if getattr(layer, "activation", None) != "relu":
            continue
        with torch.no_grad():
            h_cpu, _ = cpu._forward(cpu.params_tree, x_cpu, stop=i + 1)
            h_card, _ = card._forward(card.params_tree, x_card, stop=i + 1)
        h_card = h_card.cpu()
        flip = (h_card > 0) != (h_cpu > 0)
        out[layer.name] = {"units": int(h_cpu.numel()),
                           "flips": int(flip.sum()),
                           "flip_values": torch.maximum(
                               h_card, h_cpu)[flip].tolist()[:16]}
    return out


def run(seed, name, u, steps, device):
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.default_rng(seed)
    ds = DataSet(rng.random((64, 784), dtype=np.float32),
                 np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)])
    js = cs.lenet_conf("float32", updater=u).to_json()
    cpu32, cpu64 = make_net(js, "cpu"), make_net(js, "cpu", "float64")
    copy_into(cpu64, cpu32)
    card, follow = make_net(js, device), make_net(js, device)
    follow64 = make_net(js, "cpu", "float64")
    for n in (card, follow):
        copy_into(n, cpu32)
    x_cpu = torch.from_numpy(ds.features)
    x_card = x_cpu.to(device)
    a, b, c, d, e = [], [], [], [], []
    for _ in range(steps):
        # (c), (d) and (e): the CPU's state onto the followers
        copy_into(follow, cpu32)
        copy_into(follow64, cpu32)
        d.append(pool_flips(follow, cpu32, x_card, x_cpu))
        e.append(pool_flips(follow64, cpu32, x_cpu.double(), x_cpu))
        for n in (cpu32, cpu64, card, follow):
            n.fit(ds, epochs=1, batch_size=64)
        a.append(gap(cpu32, cpu64))
        b.append(gap(card, cpu32))
        c.append(gap(follow, cpu32))
    return {"seed": seed, "updater": name, "steps": steps,
            "f32_vs_f64": a, "card_vs_cpu": b, "one_step": c,
            "pool_flips": d, "f64_flips": e,
            "max": {"f32_vs_f64": max(a), "card_vs_cpu": max(b),
                    "one_step": max(c),
                    "pool_flips": sum(v["flips"] for st in d
                                      for v in st.values()),
                    "f64_flips": sum(v["flips"] for st in e
                                     for v in st.values())}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_c10_lenet: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    card = (cs.gpu_name_and_limit() if args.device == "cuda"
            else "cpu rehearsal")
    rows = []
    for seed in args.seeds:
        for name, u in updaters().items():
            rows.append(run(seed, name, u, args.steps, args.device))
            print(json.dumps(rows[-1]), flush=True)
    summary = {"card": card, "by_seed_updater": {
        f"{r['seed']}/{r['updater']}": r["max"] for r in rows}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
