"""The reference's side of ``tests/test_torch_mesh_train.py``: its train
step jitted with ``train_state_sharding``'s shardings in and out on a
``jax.make_mesh`` of the case's layout (auto axes), as
``repro.launch.train --mesh`` runs it, over the CPU devices XLA is told to
make:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_mesh_reference.py CASES.json OUT.npz

``CASES.json`` maps a name to a case of ``tests/_mesh_cases.py`` (without
its noise: the reference draws from its own key, whose draws the port is
handed).  Each case starts from the parameters the port's ranks draw
(``model.init_params(cfg, i)`` for node i), the optimizer's fresh state
and Morph on the ring with the key ``init_train_state(PRNGKey(0), ...)``
gives it, and sees the ranks' batches.  ``OUT.npz`` holds, per case,
every round's edges and per-node losses and the last round's parameters
by dotted path.
"""
import json
import sys
from pathlib import Path

import jax
import numpy as np
from jax.sharding import AxisType

sys.path.insert(0, str(Path(__file__).resolve().parent))

import repro.configs as jconfigs                             # noqa: E402
from repro.core import init_state                            # noqa: E402
from repro.dlrt import distributed as jdist                  # noqa: E402
from repro.optim import adamw, chain_clip, sgd               # noqa: E402
from repro_torch.tree import flatten                         # noqa: E402

import _mesh_cases as mc                                     # noqa: E402
from _zoo_parity import FAST_XLA, port_params                # noqa: E402


def optimizer(name):
    return sgd(mc.LR) if name == "sgd" else \
        chain_clip(adamw(mc.ADAM_LR), mc.CLIP)


def run(case):
    jcfg = jconfigs.get_config(case["arch"]).reduced()
    n = case["n"]
    params = port_params(mc.config(case["arch"]), 0, n=n)
    opt = optimizer(case["opt"])
    ring = np.roll(np.eye(n, dtype=bool), 1, 1) \
        | np.roll(np.eye(n, dtype=bool), -1, 1)
    _, key = jax.random.split(jax.random.PRNGKey(0))

    def build(p):
        return jdist.TrainState(p, jax.vmap(opt.init)(p),
                                init_state(key, ring))
    # Auto axes: the partitioner the reference was written for (jax 0.9's
    # make_mesh makes explicit axes by default, under which its vmap over
    # a node-sharded state and an unsharded batch is refused).
    mesh = jax.make_mesh(tuple(case["sizes"]), tuple(case["axes"]),
                         axis_types=(AxisType.Auto,) * len(case["axes"]))
    sh = jdist.train_state_sharding(mesh, jcfg, jax.eval_shape(build, params))
    # The state made by one program, laid out as the step takes it (an
    # eager vmap of the optimizer's init compiles every op on its own).
    state = jax.jit(build, out_shardings=sh).lower(params).compile(
        compiler_options=FAST_XLA)(params)
    batches = mc.batches(mc.config(case["arch"]), n, case["batch"],
                         case["rounds"])
    steps = {topo: jax.jit(jdist.make_train_step(
        jcfg, opt, jdist.MorphHParams(**mc.HP),
        microbatch=case["microbatch"], do_topology=topo),
        in_shardings=(sh, None), out_shardings=(sh, None)).lower(
            state, batches[0]).compile(compiler_options=FAST_XLA)
        for topo in {r % case["delta_r"] == 0
                     for r in range(case["rounds"])}}
    out = {}
    for rnd, batch in enumerate(batches):
        state, m = steps[rnd % case["delta_r"] == 0](state, batch)
        out[f"round{rnd}/edges"] = np.asarray(state.morph.edges)
        out[f"round{rnd}/per_node_loss"] = np.asarray(m["per_node_loss"])
    for path, leaf in flatten(jax.tree_util.tree_map(
            np.asarray, state.params)).items():
        out[f"params/{path}"] = leaf
    return out


def main(cases_path, out_path):
    cases = json.loads(Path(cases_path).read_text())
    out = {}
    for name, case in cases.items():
        out.update({f"{name}/{k}": v for k, v in run(case).items()})
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
