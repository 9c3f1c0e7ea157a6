"""The port's own benchmark scripts, run as modules
(``python -m repro_torch.bench.fig3``, ``fig13``, ``table1``, ``fig4``,
``fig5``, ``fig8``, ``fig11``, ``fig14``, ``fig2``, ``fig67``,
``fig3_curves``, ``fig9``, ``fig12``, ``fig10``), writing the reference
harness's JSON schema without JAX, and
the one-off ``divergence`` (where a card's and the CPU's host loops part);
:mod:`repro_torch.bench.common` is their shared experiment harness."""
