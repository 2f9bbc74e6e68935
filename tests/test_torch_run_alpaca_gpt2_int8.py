"""The Alpaca harness over a tiny GPT-2 directory at ``--bits 8`` in both
packages on the CPU: JAX's ``run_alpaca`` quantizes the GPT-2 base (the
eight Monarch layers' frozen ``dense``, biases kept in float), and the port
does the same: the int8 codes and scales cross by the bridge into a port
model quantized alike.  ``test_torch_run_alpaca_families.py``'s run and
checks, with its tolerances."""

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from test_torch_run_alpaca_families import check_family_run, run_family


def test_torch_alpaca_over_gpt2_int8_matches_jax(tmp_path):
    run = run_family(tmp_path, "gpt2", ["--bits", "8"])
    check_family_run(run, 2 * 4)
    layers = [m for m in run["built"]["port_model"].modules() if isinstance(m, MonarchLinear)]
    assert len(layers) == 8 and all(m.quant_bits == 8 and m.bias is not None for m in layers)
