"""The port's own benchmark scripts, run as modules
(``python -m repro_torch.bench.fig3``, ``fig13``, ``table1``, ``fig4``,
``fig5``, ``fig8``, ``fig11``), writing the reference harness's JSON schema without JAX, and
the one-off ``divergence`` (where a card's and the CPU's host loops part);
:mod:`repro_torch.bench.common` is their shared experiment harness."""
