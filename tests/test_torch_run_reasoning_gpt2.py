"""The reasoning harness over a tiny GPT-2 directory in both packages on the
CPU, with ``--all_linear=False``: the harnesses adapt GPT-2's fused
``c_attn`` alone (ROADMAP.md C.18), 2 layers.
``test_torch_run_reasoning_families.py``'s run and checks, with its
tolerances."""

from test_torch_run_reasoning_families import check_family_run


def test_torch_reasoning_over_gpt2_matches_jax(tmp_path):
    check_family_run(tmp_path, "gpt2", ["--all_linear=False"], 2)
