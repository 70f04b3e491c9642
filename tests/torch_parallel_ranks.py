"""Rank processes for the port's data-parallel tests.

`launch(suite, world, directory)` starts WORLD processes of this file
(`python tests/torch_parallel_ranks.py SUITE RANK WORLD PORT DIR`),
which join one gloo group on 127.0.0.1 and run every case of
`DIR/cases.json` for SUITE, each writing its results to
`DIR/<case>-<rank>.npz` (and `<case>-<rank>.json` where a case has a
document). The test process writes the inputs first (`DIR/inputs.npz`: the
JAX package's initial weights and the data, by key) and compares after.
These processes import torch and the port only; every join and
collective has its own timeout, so a lost rank fails in seconds.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 30.0


# ------------------------------------------------------------ launching
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(suite: str, world: int, directory: str,
           timeout: float = 150.0) -> None:
    """Run SUITE on WORLD ranks; raise with the ranks' stderr if one
    fails or the group outlives `timeout`."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r),
         str(world), str(port), directory],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"{suite}: the ranks outlived {timeout} s")
    bad = [(r, p.returncode, outs[r][1][-4000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"{suite}: ranks failed: {bad}")


def results(directory: str, case: str, world: int):
    """Every rank's arrays of `case` (a list of dicts)."""
    return [dict(np.load(os.path.join(directory, f"{case}-{r}.npz")))
            for r in range(world)]


def document(directory: str, case: str, rank: int = 0):
    with open(os.path.join(directory, f"{case}-{rank}.json")) as f:
        return json.load(f)


def _write_doc(out: str, doc) -> None:
    """A rank's JSON document beside its arrays (`<case>-<rank>.json`)."""
    with open(out[:-len(".npz")] + ".json", "w") as f:
        json.dump(doc, f)


def assemble(parts, key: str, world: int):
    """A moment's global value from every rank's slice of it (each rank
    saved `<key>` and `<key>@bounds`)."""
    shape = [hi for _, hi in parts[0][key + "@global"]]
    out = np.zeros(shape, parts[0][key].dtype)
    for r in range(world):
        b = parts[r][key + "@bounds"]
        out[tuple(slice(lo, hi) for lo, hi in b)] = parts[r][key]
    return out


# ----------------------------------------------------------- rank side
def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif hasattr(tree, "shape"):
        out[prefix.rstrip("/")] = tree
    return out


def _dump(net, path, extra=None):
    """params, the rank's moment slices with their bounds, state."""
    import torch

    arrays = {}
    for k, v in _flat(net.params_tree).items():
        arrays[f"params/{k}"] = v.detach().double().numpy()
    for k, v in _flat(net.state_tree).items():
        arrays[f"state/{k}"] = v.detach().double().numpy()
    pl = (net._placements or {}).get("updater", {})
    for k, v in _flat(net.updater_state).items():
        key = f"updater/{k}"
        arrays[key] = v.detach().double().numpy()
        shape, bounds = pl.get(k, (list(v.shape),
                                   [[0, d] for d in v.shape]))
        arrays[key + "@bounds"] = np.asarray(bounds, np.int64)
        arrays[key + "@global"] = np.asarray([[0, d] for d in shape],
                                             np.int64)
    for k, v in (extra or {}).items():
        arrays[k] = v.detach().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    np.savez(path, **arrays)


def _losses():
    """A listener keeping every step's loss (a host read a step)."""
    from deeplearning4j_tpu_torch.optim.listeners import TrainingListener

    class Losses(TrainingListener):
        def __init__(self):
            self.values = []

        def iteration_done(self, model, iteration, epoch, score):
            self.values.append(float(score))

    return Losses()


def _net(case, inputs):
    from deeplearning4j_tpu_torch.models import (
        ComputationGraph, MultiLayerNetwork,
    )
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration,
    )

    if case.get("graph"):
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            case["conf"]), device="cpu").init()
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            case["conf"]), device="cpu").init()
    w = case["weights"] + "/"
    tree = {layer: {} for layer in net.params_tree}   # parameterless too
    for k in inputs.files:
        if k.startswith(w):
            layer, pname = k[len(w):].split("/", 1)
            tree.setdefault(layer, {})[pname] = inputs[k]
    params_from_numpy(net, tree)
    return net


def _wrapper(net, case):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    return ParallelWrapper(net, prefetch_buffer=0,
                           shard_opt_state=case.get("shard", True))


def _case_fit(case, inputs, out, rank):
    """A ParallelWrapper fit; its losses, params and moment slices."""
    net = _net(case, inputs)
    pw = _wrapper(net, case)
    losses = _losses()
    net.listeners.append(losses)
    pw.fit(inputs[case["x"]], inputs[case["y"]], epochs=case["epochs"],
           batch_size=case["batch"], steps_per_dispatch=case.get("k", 1),
           device_prefetch=case.get("prefetch", True))
    _dump(net, out, {"losses": np.asarray(losses.values)})


def _case_spine(case, inputs, out, rank):
    """The spine's placements of a tree of shapes."""
    import torch

    from deeplearning4j_tpu_torch.parallel.mesh import MeshContext, make_mesh
    from deeplearning4j_tpu_torch.parallel.sharding import fsdp_rules

    doc = {}
    for rules_name in ("none", "fsdp"):
        rules = fsdp_rules(["a", "b"]) if rules_name == "fsdp" else None
        ctx = MeshContext(make_mesh({"data": -1}, device_type="cpu"), rules)
        tree = {layer: {p: torch.zeros(shape) for p, shape in sub.items()}
                for layer, sub in case["shapes"].items()}
        specs = {}
        for layer, sub in tree.items():
            for p, leaf in sub.items():
                sh = ctx.opt_shardings({layer: {"m": {p: leaf}}})
                specs[f"{layer}/{p}"] = {
                    "moment": list(ctx.moment_spec(layer, p, leaf)),
                    "param": list(ctx.param_shardings(
                        {layer: {p: leaf}})[layer][p].spec),
                    "bounds": sh[layer]["m"][p].bounds(leaf.shape)}
        doc[rules_name] = specs
    x = torch.arange(12.0).reshape(6, 2)
    doc["batch_rows"] = ctx.put_batch(x)[:, 0].tolist()
    _write_doc(out, doc)
    np.savez(out, rows=np.asarray(doc["batch_rows"]))


def _case_earlystopping(case, inputs, out, rank):
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator

    net = _net(case, inputs)
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(3)])
    it = ArrayDataSetIterator(inputs[case["x"]], inputs[case["y"]],
                              case["batch"])
    res = es.EarlyStoppingParallelTrainer(cfg, net, it).fit()
    _dump(net, out)
    _write_doc(out, {"reason": res.termination_reason,
                     "epochs": res.total_epochs,
                     "best_epoch": res.best_model_epoch,
                     "scores": {str(k): v for k, v in
                                res.score_vs_epoch.items()}})


def _case_ledger(case, inputs, out, rank):
    """One wrapper step's ledger and the watchdog's totals."""
    from deeplearning4j_tpu_torch.observe.commsmon import get_comm_ledger
    from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog

    net = _net(case, inputs)
    pw = _wrapper(net, case)
    ledger = get_comm_ledger()
    mark = ledger.mark()
    pw.fit(inputs[case["x"]], inputs[case["y"]], epochs=1,
           batch_size=case["batch"], device_prefetch=False)
    _write_doc(out, {"ops": ledger.since(mark),
                     "owner": get_watchdog().owner_comm_totals(pw.owner_tag),
                     "comm_totals": get_watchdog().comm_totals(),
                     "collectives": get_watchdog().snapshot()["per_owner"]
                     .get(pw.owner_tag, {}).get("collectives")})
    _dump(net, out)


def _case_elastic(case, inputs, out, rank):
    """An ElasticTrainer preempted by its stop_fn at an iteration, and
    the same fit uninterrupted, writing sharded checkpoints."""
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer

    net = _net(case, inputs)
    stop_at = case.get("stop_at")
    trainer = ElasticTrainer(
        net, case["ckpt"], checkpoint_every=case["every"],
        stop_fn=(lambda: net.iteration >= stop_at) if stop_at else None)
    losses = _losses()
    net.listeners.append(losses)
    res = trainer.fit(inputs[case["x"]], inputs[case["y"]],
                      epochs=case["epochs"], batch_size=case["batch"])
    _dump(net, out, {"losses": np.asarray(losses.values)})
    _write_doc(out, res)


CASES = {"fit": _case_fit, "spine": _case_spine,
         "earlystopping": _case_earlystopping, "ledger": _case_ledger,
         "elastic": _case_elastic}


def main(suite, rank, world, port, directory):
    import torch

    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           backend="gloo", timeout_s=JOIN_TIMEOUT_S)
    with open(os.path.join(directory, "cases.json")) as f:
        cases = json.load(f)[suite]
    inputs = np.load(os.path.join(directory, "inputs.npz"))
    for case in cases:
        CASES[case["kind"]](case, inputs, os.path.join(
            directory, f"{case['name']}-{rank}.npz"), rank)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    suite, rank, world, port, directory = sys.argv[1:6]
    main(suite, int(rank), int(world), int(port), directory)
