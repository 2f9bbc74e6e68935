"""The Alpaca harness over a tiny GPT-NeoX (Pythia) directory in both
packages on the CPU: ``test_torch_run_alpaca_families.py``'s run and checks,
with its tolerances.  Every linear is adapted, the untied ``embed_out``
head included, as JAX's ``find_all_linear_names`` (which leaves out only
``lm_head``) picks them: four a layer and the head."""

from test_torch_run_alpaca_families import check_family_run, run_family


def test_torch_alpaca_over_gpt_neox_matches_jax(tmp_path):
    check_family_run(run_family(tmp_path, "gpt_neox"), 2 * 4 + 1)
