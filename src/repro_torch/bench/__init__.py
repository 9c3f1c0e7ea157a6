"""The port's own benchmark scripts, run as modules
(``python -m repro_torch.bench.fig3``, ``python -m repro_torch.bench.fig13``),
writing the reference harness's JSON schema without JAX."""
