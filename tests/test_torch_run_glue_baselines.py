"""The port's GLUE harness with the paper's baselines and options against the
JAX harness (``run_glue.py`` at the root) on the CPU, as
``test_torch_run_glue.py`` runs them (``--smoke=True``, the tiny RoBERTa, 3
steps, the loss logged at each, dropout off, the JAX harness's initial
weights carried across by ``utils/jax_bridge``):

  * ``--monarch=False --lora=True`` on ``lora_roberta_glue/cola.json``;
  * ``--monarch=False --boft=True`` on ``boft_roberta_glue/cola.json`` (the
    task's ``oft_dropout`` 0.05 reaches the peft config; both packages' BOFT
    dropout is then set to 0 on the built model, since they draw other
    masks);
  * ``--svd_init=True`` and ``--adapter=False`` (projection mode) on the
    Monarch CoLA recipe.

The port's ``build`` seam builds the tiny model, adapts it with the
harness's own ``adapt_model`` and loads the state of the JAX harness's
model built at the same point (one a trial, in order: ``run_both`` serves
``test_torch_run_glue_tune.py``'s searches too).  Held: the logged losses
and ``eval_loss`` within ``TOLERANCES["f32_logits"]``; the classification
metrics and TSV files equal.
"""

import os
import sys

import pytest
from flax import nnx

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft.boft import BOFTLinear
from sparse_matrix_fine_tuning_torch.peft.surgery import ScaledLoRA
from sparse_matrix_fine_tuning_torch.scripts import run_glue as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from sparse_matrix_fine_tuning_tpu.peft.boft import BOFTLinear as JaxBOFTLinear
from test_torch_run_glue import FAST, NO_DROPOUT, check_run, config, flat_state, losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_glue as jax_harness  # noqa: E402  (the JAX harness at the root)

LOGITS = TOLERANCES["f32_logits"]
CUT = ["--smoke=True", "--max_steps=3", "--logging_steps=1"]


def run_both(config_path: str, out, extra=(), cut=CUT):
    """The JAX harness's ``main`` and the port's ``run`` on one argv;
    returns (JAX results, port GlueRun, JAX task dir, port task dir, the
    peft configs the port built with)."""
    states, seen = [], []
    real_build = jax_harness.build_model

    def jax_build(*a, **kw):
        model = real_build(*a, **kw)
        for _, m in nnx.iter_modules(model):
            if isinstance(m, nnx.Dropout):
                m.rate = 0.0
            if isinstance(m, JaxBOFTLinear):
                m.dropout_p = 0.0
        states.append(flat_state(model))
        return model

    def build(args, data_args, peft_config, num_labels, seed):
        seen.append(dict(peft_config))
        model = RobertaForSequenceClassification(
            RobertaConfig.tiny(num_labels=num_labels, vocab_size=port.SMOKE_VOCAB, **NO_DROPOUT),
            device="cpu")
        port.adapt_model(model, args, dict(peft_config, boft_dropout=0.0), seed)
        load_jax_state(model, states.pop(0))
        return model

    argv = [config_path, *cut, *extra]
    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["run_glue.py", *argv, f"--output_dir={out / 'jax'}"]
        want = jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build
    got = port.run([*argv, f"--output_dir={out / 'port'}", "--platform=cpu"], build=build)
    assert not states  # every JAX build was matched by one of the port's
    task = next(iter(want))
    return want, got, out / "jax" / task, out / "port" / task, seen


CASES = {
    "lora": ("lora_roberta_glue", ["--monarch=False", "--lora=True"]),
    "boft": ("boft_roberta_glue", ["--monarch=False", "--boft=True"]),
    "svd_init": ("monarch_roberta_glue", ["--svd_init=True"]),
    "projection": ("monarch_roberta_glue", ["--adapter=False"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_run_glue_baseline_matches_jax(tmp_path, case):
    family, flags = CASES[case]
    want, got, jax_dir, port_dir, seen = run_both(config(family, "cola"), tmp_path,
                                                  [*FAST, *flags])
    check_run(want, got, jax_dir, port_dir, ["CoLA.tsv"])
    model = got.trainer.model
    layers = [m for m in model.modules()
              if isinstance(m, (ScaledLoRA, BOFTLinear, MonarchLinear))]
    assert len(layers) == 3 * model.config.num_hidden_layers
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    if case == "lora":
        assert all(isinstance(m, ScaledLoRA) and m.scaling == 2.0 for m in layers)
        assert {n.rsplit(".", 1)[-1] for n in trained} >= {"lora_a", "lora_b"}
    elif case == "boft":
        assert seen[0]["boft_dropout"] == 0.05  # the task's oft_dropout
        assert all(isinstance(m, BOFTLinear) and m.n_factors == 2 for m in layers)
        assert not any(n.endswith(".bias") and "attention" in n for n in trained)
    else:
        assert all(isinstance(m, MonarchLinear) for m in layers)
        if case == "projection":  # sqrt-factor blocks, no dense base
            assert all(m.dense is None and m.nblocks == 4 and not m.as_adapter for m in layers)
        else:
            assert all(m.dense is not None and m.svd_init for m in layers)
