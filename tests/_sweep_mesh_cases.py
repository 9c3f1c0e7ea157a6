"""The sweep mesh's test cases, shared by ``test_torch_sweep_mesh.py`` (in
process on a 1 x 1 mesh, and as the parent of the gloo ranks) and the
ranks it starts through ``repro_torch.launch.start``.

This module imports torch and the port only, never JAX: the ranks import
it, and the reference's draws reach them as tensors the parent made
(``tests/_jax_draws.py``), through the ``Replay*`` classes below, which
``tests/test_torch_sweep.py`` builds from JAX directly.

A case is a dict: ``model`` (``"mlp"``, the tiny MLP, or ``"cnn"``, a
reduced GN-LeNet of width 4 on 8 x 8 images), ``strategy`` (``"morph"``
or ``"static"``), ``delta_r`` (a Morph ``delta_r`` axis, or None) and
``net`` (a ``SweepNetwork`` of mixed profiles, or not).  Every run is E =
4 experiments (seeds 0 to 3) of n = 7 nodes for 11 rounds, evaluations at
rounds 4 and 9 and 10, from the reference's initial parameters.
"""
from collections import OrderedDict

import numpy as np
import torch

import repro_torch.core as tcore
import repro_torch.netsim as tnet
from repro_torch import fold_seed
from repro_torch.core.morph import stack_noise
from repro_torch.data import (DeviceDataStream, dirichlet_partition,
                              make_image_classification, train_test_split)
from repro_torch.dlrt import RunnerConfig, SweepSpec, SweepSuperstep
from repro_torch.models import cnn_loss, cnn_params, mlp_loss, mlp_params
from repro_torch.optim import sgd

N, ROUNDS, EVAL_EVERY, SIM_EVERY, K, BATCH = 7, 11, 5, 2, 2, 4
SEEDS = (0, 1, 2, 3)
DELTA_R = (2, 3, 5, 2)
# The network's profiles, one an experiment: their depths differ at this
# round_s (the shared ring is the deepest).
PROFILES = ("ideal", "wan", "lan", "wan")
NET_KW = dict(round_s=0.05, max_staleness=4)
# Static's graph seed, the same for every experiment: the reference's
# sweep runs experiment 0's graph for all of them (ROADMAP queue 3), so a
# shared graph keeps the two comparable.
STATIC_SEED = 0

CASES = {
    "mlp-morph-dr": dict(model="mlp", strategy="morph", delta_r=DELTA_R),
    "mlp-static": dict(model="mlp", strategy="static"),
    "mlp-morph-net": dict(model="mlp", strategy="morph", net=True),
    "cnn-morph-dr": dict(model="cnn", strategy="morph", delta_r=DELTA_R),
    "cnn-static": dict(model="cnn", strategy="static"),
}


def data():
    """The dataset, its Dirichlet(0.5) shards and the test batch."""
    ds = make_image_classification(200, num_classes=4, image_size=8, seed=0)
    tr, te = train_test_split(ds, 0.25)
    parts = dirichlet_partition(tr.labels, N, 0.5, np.random.default_rng(0))
    return tr, parts, {"images": te.images[:24], "labels": te.labels[:24]}


def profile_seeds():
    """Each experiment's network profile seed."""
    return [10 + e for e in range(len(SEEDS))]


class HostSlots(DeviceDataStream):
    """A stream whose slots come from a CPU generator keyed by its seed
    and the round: the same batches on every device (a stream's own
    generator lives on its device)."""

    def slots(self, rnd):
        gen = torch.Generator().manual_seed(fold_seed(self.seed, rnd))
        sizes = self.sizes.cpu()[:, None]
        u = torch.rand((self.n, self.batch), generator=gen)
        return torch.minimum((u * sizes).long(), sizes - 1).to(self.device)


class ReplayStream(DeviceDataStream):
    """A stream whose slots are given (``(seed, rnd) -> [n, b]``)."""

    def __init__(self, takes, *a, **kw):
        super().__init__(*a, **kw)
        self._takes = takes

    def slots(self, rnd):
        return self._takes[self.seed, rnd].long()


class ReplayMorph(tcore.InGraphMorphStrategy):
    """Morph whose stacked rounds take given draws: :meth:`replay` with
    one list of ``MorphNoise`` an experiment of the stack, in order."""

    def replay(self, draws):
        self._draws = [iter(d) for d in draws]
        return self

    def sweep_graph_round(self, gstate, rnd, sim, delta_r=None, beta=None,
                          noise=None):
        if noise is None and hasattr(self, "_draws"):
            E = gstate.known.shape[0]
            drs = [self.delta_r] * E if delta_r is None else delta_r
            due = [e for e in range(E) if rnd % drs[e] == 0]
            if due:
                noise = stack_noise([next(self._draws[e]) for e in due])
        return super().sweep_graph_round(gstate, rnd, sim, delta_r=delta_r,
                                         beta=beta, noise=noise)


class ReplaySweepNet(tnet.SweepNetwork):
    """A sweep network fed given uniforms (profile seed -> round ->
    ``(jitter, drop)``)."""

    def __init__(self, uniforms, nets):
        super().__init__(nets)
        self._uniforms = uniforms

    def draws(self, rnd, n, device="cpu"):
        return [tnet.NetDraws(*(u.to(device) for u in
                                self._uniforms[net.profile.seed][rnd]))
                for net in self.nets]


def network(uniforms=None):
    """The case's ``SweepNetwork`` (replayed where ``uniforms`` given)."""
    nets = [tnet.DenseNetwork(tnet.profiles.get_profile(p, N, s), **NET_KW)
            for p, s in zip(PROFILES, profile_seeds())]
    if uniforms is None:
        return tnet.SweepNetwork(nets)
    return ReplaySweepNet(uniforms, nets)


def sweep(case, params, draws=None, mesh=None, device="cpu"):
    """The port's sweep of ``case`` (not run) from ``params`` (one
    node-stacked dict an experiment, or None: each seed's own draw),
    replaying ``draws`` where given (``"takes"``, ``"morph"``: seed ->
    list, ``"net"``), else with :class:`HostSlots` streams."""
    tr, parts, test = data()
    loss = mlp_loss if case["model"] == "mlp" else cnn_loss
    init = mlp_params if case["model"] == "mlp" else (
        lambda g: cnn_params(g, in_channels=3, num_classes=4, image_size=8,
                             width=4))
    delta_r = case.get("delta_r")
    drs = delta_r or (2,) * len(SEEDS)
    if case["strategy"] == "morph":
        cls = ReplayMorph if draws is not None \
            else tcore.InGraphMorphStrategy
        strategies = [cls(n=N, k=K, view_size=K + 2, seed=s, delta_r=d,
                          device=device) for s, d in zip(SEEDS, drs)]
    else:
        strategies = [tcore.InGraphStaticStrategy(
            n=N, degree=4, seed=STATIC_SEED, device=device) for _ in SEEDS]
    if draws is None:
        streams = [HostSlots(tr, parts, BATCH, seed=s, device=device)
                   for s in SEEDS]
    else:
        streams = [ReplayStream(draws["takes"], tr, parts, BATCH, seed=s,
                                device=device) for s in SEEDS]
    net = None
    if case.get("net"):
        net = network(None if draws is None else draws["net"])
    sw = SweepSuperstep(
        spec=SweepSpec(seeds=SEEDS, delta_r=delta_r), init_fn=init,
        loss_fn=loss, eval_fn=loss, optimizer=sgd(0.05), streams=streams,
        test_batch=test, strategies=strategies,
        cfg=RunnerConfig(n_nodes=N, rounds=ROUNDS, eval_every=EVAL_EVERY,
                         sim_every=SIM_EVERY),
        params=params, net=net, mesh=mesh, device=device)
    if draws is not None and case["strategy"] == "morph":
        sw.strategy.replay([draws["morph"][SEEDS[e]]
                            for e in sw.experiments])
    return sw


def summary(sw):
    """What a run leaves, as host values: every experiment's edges,
    delivered masks, logical parameters, records, comm bytes and network
    counters (a collective under a mesh: every rank calls it)."""
    params = sw.logical_params()
    return {
        "edges": np.stack([np.stack(h) for h in sw.edge_history]),
        "delivered": np.stack([np.stack(h) for h in sw.delivered_history])
        if sw.net is not None else None,
        "params": OrderedDict((k, v.cpu().numpy().copy())
                              for k, v in params.items()),
        "records": [[(r.rnd, r.comm_bytes, r.isolated, r.mean_accuracy,
                      r.mean_loss, r.internode_variance,
                      r.per_node_accuracy.tolist()) for r in log.records]
                    for log in sw.log],
        "comm_bytes": [sw.comm_bytes(e) for e in range(sw.E)],
        "net_stats": None if sw.net_stats is None else [
            {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in st.items()} for st in sw.net_stats],
        "local": (len(sw.experiments), sw.n_local),
    }


def run_case(case, params, draws, mesh=None, device="cpu"):
    """Run one case and return its :func:`summary`."""
    sw = sweep(case, params, draws, mesh=mesh, device=device)
    sw.run()
    return summary(sw)


def rank_main(sizes, jobs, meshless=(), device="cpu"):
    """One rank: every ``(name, case, params, draws)`` job on a
    :func:`~repro_torch.launch.make_sweep_mesh` of ``sizes``, then the
    meshless runs of ``meshless`` (names) this rank takes (every
    ``world``-th job, from its rank).  Returns ``({name: meshed summary},
    {name: meshless summary})``."""
    import torch.distributed as dist
    from repro_torch.launch import make_sweep_mesh
    torch.backends.cudnn.deterministic = True
    mesh = make_sweep_mesh(*sizes, device=device)
    meshed = {name: run_case(case, params, draws, mesh, mesh.device)
              for name, case, params, draws in jobs}
    rank, world = dist.get_rank(), dist.get_world_size()
    alone = {name: run_case(case, params, draws, device=mesh.device)
             for i, (name, case, params, draws) in enumerate(jobs)
             if name in meshless and i % world == rank}
    mesh.close()
    return meshed, alone
