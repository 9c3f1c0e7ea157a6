"""The sharded engine's test cases, shared by ``test_torch_sharded.py``
(one rank, in process) and ``test_torch_sharded_spawn.py`` (gloo ranks
started by ``repro_torch.launch.start``).

This module imports torch and the port only, never JAX: the spawned ranks
import it, and the reference's draws reach them as tensors made by the
parent (``tests/_jax_draws.py``), through the ``Replay*`` classes below.

A case is ``(model, strategy, knobs)``: the tiny MLP or a reduced
GN-LeNet (width 4, 8 x 8 images), dense Morph, Static or FC or sparse
Morph, and the runner's knobs (``collective``, ``compress``, ``net``
given as ``"wan"``, ``stream`` for a ``DeviceDataStream``).  Every run is
11 rounds, evaluations at 0, 5 and 10, on the reference tests' data.
"""
from collections import OrderedDict

import numpy as np

import repro_torch.core as tcore
import repro_torch.netsim as tnet
import repro_torch.sparse as tsp
from repro_torch.data import (DeviceDataStream, StackedBatcher,
                              dirichlet_partition, make_image_classification,
                              train_test_split)
from repro_torch.dlrt import DecentralizedRunner, RunnerConfig
from repro_torch.models import cnn_loss, mlp_loss
from repro_torch.netsim import profiles
from repro_torch.optim import sgd
from repro_torch.tree import params_from_jax

ROUNDS, EVAL_EVERY, K = 11, 5, 2
WAN_ROUND_S = 0.05          # two-slot ring for the tiny MLP's payload
MODELS = ("mlp", "cnn")


def static_degree(n):
    """A regular degree every n takes (n * degree even)."""
    return 4 if n % 2 else 3


def data(n):
    """The reference tests' dataset, split and Dirichlet(0.5) shards."""
    ds = make_image_classification(400, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, n, 0.5, np.random.default_rng(0))
    return tr, {"images": te.images, "labels": te.labels}, parts


def wan(n):
    """The WAN profile as the dense network model, two slots deep."""
    return profiles.dense_network("wan", n, round_s=WAN_ROUND_S)


class ReplayMorph(tcore.InGraphMorphStrategy):
    """Port Morph fed given draws, one set per negotiation."""

    def __init__(self, draws, **kw):
        super().__init__(**kw)
        self._draws = iter(draws)

    def graph_round(self, gstate, rnd, sim, noise=None):
        if rnd % self.delta_r == 0:
            noise = next(self._draws)
        return super().graph_round(gstate, rnd, sim, noise=noise)


class ReplaySparseMorph(tsp.SparseMorphStrategy):
    """Port sparse Morph fed given draws (round -> ``SparseDraws``)."""

    def __init__(self, draws, **kw):
        super().__init__(**kw)
        self._given = draws

    def draw(self, rnd):
        return self._given[rnd]


class ReplayNet(tnet.DenseNetwork):
    """Port network model fed given uniforms (round -> ``NetDraws``)."""

    def __init__(self, draws, *a, **kw):
        super().__init__(*a, **kw)
        self._given = draws

    def draws(self, rnd, n, device="cuda"):
        d = self._given[rnd]
        return tnet.NetDraws(*(None if u is None else u.to(device)
                               for u in d))


def strategy(name, n, draws=None):
    """The port strategy ``name`` at ``n`` nodes on the CPU, fed the
    reference's draws where ``draws`` has them (``"morph"``, ``"sparse"``)
    and its own otherwise."""
    if name == "morph":
        kw = dict(n=n, k=K, view_size=4, seed=0, device="cpu")
        return tcore.InGraphMorphStrategy(**kw) if draws is None \
            else ReplayMorph(draws["morph"], **kw)
    if name == "static":
        return tcore.InGraphStaticStrategy(n=n, degree=static_degree(n),
                                           seed=0, device="cpu")
    if name == "fc":
        return tcore.InGraphFullyConnectedStrategy(n=n, device="cpu")
    kw = dict(n=n, k=K, seed=0, device="cpu")
    return tsp.SparseMorphStrategy(**kw) if draws is None \
        else ReplaySparseMorph(draws["sparse"], **kw)


def runner(model, name, n, params, draws=None, *, stream=False, net=None,
           **cfg):
    """The port's runner for a case on the CPU (not run): ``params`` the
    reference's initial parameters as numpy, ``net="wan"`` the WAN model
    (fed ``draws["net"]`` where given)."""
    tr, test, parts = data(n)
    batcher = DeviceDataStream(tr, parts, 8, seed=3, device="cpu") \
        if stream else StackedBatcher(tr, parts, 8, seed=3)
    if net == "wan":
        net = wan(n)
        if draws is not None:
            net = ReplayNet(draws["net"], net.profile, round_s=WAN_ROUND_S)
    loss = mlp_loss if model == "mlp" else cnn_loss
    return DecentralizedRunner(
        init_fn=None, loss_fn=loss, eval_fn=loss, optimizer=sgd(0.05),
        batcher=batcher, test_batch=test, strategy=strategy(name, n, draws),
        cfg=RunnerConfig(n_nodes=n, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         engine="sparse" if name == "sparse" else "dense",
                         net=net, **cfg),
        params=params_from_jax(params), device="cpu")


def summary(r):
    """What a run leaves, as host values: edges, parameters, records,
    comm bytes and network counters."""
    return {
        "edges": np.stack(r.edge_history),
        "delivered": np.stack(r.delivered_history)
        if r.delivered_history else None,
        "params": OrderedDict((k, v.numpy().copy())
                              for k, v in r.params.items()),
        "count": int(r.opt_state["count"]),
        "records": [(x.rnd, x.comm_bytes, x.isolated, x.mean_accuracy,
                     x.mean_loss, x.internode_variance,
                     x.per_node_accuracy.tolist()) for x in r.log.records],
        "net_stats": None if r.net_stats is None else {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in r.net_stats.items()},
    }


def run_case(case, n, params, draws, **mesh):
    """Run one case (``mesh`` empty: the single-device engine) and return
    its :func:`summary`."""
    model, name, knobs = case
    r = runner(model, name, n, params, draws, **knobs, **mesh)
    r.run()
    return summary(r)


def rank_main(batches):
    """One rank of a spawned run: for each ``(n, cases, params, draws)``
    batch, every case through the sharded engine on the default process
    group and, on rank 0, the same case on the single-device engine in the
    same process too (for the bitwise check).  Returns, per batch, the
    ``(sharded, single)`` summaries, one per case (``single`` empty off
    rank 0)."""
    import torch.distributed as dist
    out = []
    for n, cases, params, draws in batches:
        sharded, alone = [], []
        for case in cases:
            sharded.append(run_case(case, n, params[case[0]], draws,
                                    mesh_devices=0))
            if dist.get_rank() == 0:
                knobs = {k: v for k, v in case[2].items()
                         if k != "collective"}
                alone.append(run_case((case[0], case[1], knobs), n,
                                      params[case[0]], draws))
        out.append((sharded, alone))
    return out
