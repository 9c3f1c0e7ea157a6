"""The reference's side of ``tests/test_torch_mesh_serve.py``: its serve
step jitted with the dry run's shardings (``params_sharding``,
``cache_sharding``, the tokens as ``batch_sharding`` lays out their first
two dims, ``pos`` replicated; ``kv_spec=serve_kv_spec(...)``), and its
prefill (a vmapped ``forward(..., last_only=True)``) with
``params_sharding`` and ``batch_sharding``, on a ``jax.make_mesh`` of the
case's layout (auto axes), over the CPU devices XLA is told to make:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_mesh_serve_reference.py CASES.json OUT.npz

``CASES.json`` maps a name to a case of ``tests/_mesh_serve_cases.py``.
Each case starts from the parameters the port's ranks draw (its
``params`` file where it names one) and decodes their tokens from
position 0 into fresh caches.  ``OUT.npz`` holds, per
case, every step's logits, the last caches by dotted path and, where
asked, the prefill's logits.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent))

import repro.configs as jconfigs                             # noqa: E402
from repro.dlrt import distributed as jdist                  # noqa: E402
from repro.models import model as jmodel                     # noqa: E402
from repro_torch.tree import flatten, params_to_numpy        # noqa: E402

import _mesh_serve_cases as sc                               # noqa: E402
from _zoo_parity import FAST_XLA, port_params                # noqa: E402


def run(case):
    jcfg = jconfigs.get_config(case["arch"]).reduced()
    n, b, steps = case["n"], case["b"], case["steps"]
    window = sc.window_of(case)
    mesh = jax.make_mesh(tuple(case["sizes"]), tuple(case["axes"]),
                         axis_types=(AxisType.Auto,) * len(case["axes"]))
    # Compiled from the shapes first, so that the parameters may still be
    # drawing meanwhile; every program (the fresh caches too) compiled
    # once, and the inputs given as numpy arrays, so that no eager op
    # compiles one of its own.
    shapes = jdist.abstract_stacked_params(jcfg, n)
    params_sh = jdist.params_sharding(mesh, jcfg, shapes)
    cache = jdist.abstract_cache(jcfg, n, b, case["max_len"])
    cache_sh = jdist.cache_sharding(mesh, jcfg, cache)
    fresh = jax.jit(lambda i: jax.vmap(lambda _: jmodel.init_cache(
        jcfg, b, case["max_len"]))(i), out_shardings=cache_sh).lower(
            np.arange(n)).compile(compiler_options=FAST_XLA)
    base = tuple(jdist.batch_sharding(mesh, jcfg, n, b).spec)
    tok_sh = NamedSharding(mesh, P(*(base[:2] + (None,))))
    serve = jdist.make_serve_step(jcfg, window=window,
                                  kv_spec=jdist.serve_kv_spec(mesh, jcfg, b))
    toks = sc.tokens(sc.config(case), case).astype(np.int32)
    step = jax.jit(serve, in_shardings=(params_sh, cache_sh, tok_sh,
                                        jdist.replicated(mesh))).lower(
        shapes, cache, toks[..., :1], np.int32(0)).compile(
            compiler_options=FAST_XLA)
    batch = {k: v.astype(np.int32) if k == "tokens" else v
             for k, v in sc.prefill_batch(sc.config(case), case).items()}
    if case.get("prefill"):
        def prefill(p, batch):
            return jax.vmap(lambda q, bb: jmodel.forward(
                q, bb, jcfg, window=window, last_only=True)[0])(p, batch)
        # The dry run's input shardings: batch_sharding's spec, the
        # trailing dims replicated.
        batch_sh = {k: NamedSharding(mesh, P(*base, *(None,) * (v.ndim - 3)))
                    for k, v in batch.items()}
        fn = jax.jit(prefill, in_shardings=(params_sh, batch_sh)).lower(
            shapes, batch).compile(compiler_options=FAST_XLA)
    params = (params_to_numpy(flatten(sc.params_of(case)))
              if case.get("params") else
              port_params(sc.config(case), 0, n=n))
    params = jax.device_put(params, params_sh)
    cache = fresh(np.arange(n))
    out, logits = {}, []
    for t in range(steps):
        got, cache = step(params, cache, toks[..., t:t + 1], np.int32(t))
        logits.append(np.asarray(got))
    out["logits"] = np.stack(logits)
    for path, leaf in flatten(jax.tree_util.tree_map(np.asarray,
                                                     cache)).items():
        out[f"cache/{path}"] = leaf
    if case.get("prefill"):
        out["prefill"] = np.asarray(fn(params, batch))
    return out


def main(cases_path, out_path):
    cases = json.loads(Path(cases_path).read_text())
    out = {}
    for name, case in cases.items():
        out.update({f"{name}/{k}": v for k, v in run(case).items()})
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
