"""The port's reasoning harness (``scripts/run_reasoning.py``) with a local
checkpoint and its refusals, on the CPU: ``--model <tiny HF dir>`` (written
by ``transformers``) goes through ``models/hf_convert`` in bfloat16 with
``--gradient_checkpointing`` and ``--remat_policy`` in the model's config,
its weights unchanged under the adapters; each refused option stops
before any work."""

import pytest
import torch

from sparse_matrix_fine_tuning_torch.scripts import run_reasoning as port
from test_torch_hf_convert import write_hf_llama


@pytest.mark.parametrize("flags,remat,policy", [([], True, "nothing"),
                                                (["--remat_policy=dots"], True, "dots"),
                                                (["--gradient_checkpointing=False"], False,
                                                 "nothing")])
def test_torch_reasoning_loads_a_local_checkpoint(tmp_path, flags, remat, policy):
    """``--model <dir>``: the checkpoint's weights in bfloat16 under the
    adapters, the remat flags in its config, a short commonsense run."""
    hf = write_hf_llama(tmp_path / "ckpt", vocab_size=port.HASH_VOCAB)
    seen = {}

    def build(args, peft_config):
        seen["model"] = port.build_model(args, peft_config)
        return seen["model"]

    results = port.main(["-task", "commonsense", "--model", str(tmp_path / "ckpt"), "-e", "1",
                         "-batch_size", "2", "-gradient_accumulation_steps", "1",
                         "--max_steps=1", "--max_n_train_example=2", "-eval_dataset", "boolq",
                         "--max_n_eval_example=2", f"--output_dir={tmp_path / 'out'}",
                         "--platform=cpu", *flags], build=build)
    model = seen["model"]
    cfg = model.config
    assert (cfg.remat, cfg.remat_policy, cfg.dtype, cfg.num_hidden_layers) == \
        (remat, policy, "bfloat16", 2)
    assert torch.equal(model.model.embed_tokens.weight,
                       hf.model.embed_tokens.weight.to(torch.bfloat16))
    assert torch.equal(model.model.layers[1].mlp.down_proj.dense,
                       hf.model.layers[1].mlp.down_proj.weight.to(torch.bfloat16))
    assert set(results) == {"eval/boolq", "eval/average"}


@pytest.mark.parametrize("extra,raised,match", [
    (["--mesh_fsdp=4"], ValueError, "torchrun --nproc_per_node 4"),
    (["--pack=True", "--intervention_type", "LoreftIntervention"], SystemExit,
     "incompatible with ReFT"),
])
def test_torch_reasoning_refusals(tmp_path, extra, raised, match):
    """Each refused option stops before any work: nothing is built and the
    output directory is never made (``--pack`` with an intervention exits
    as the JAX harness does)."""
    def never(args, peft_config):
        raise AssertionError("built a model")

    out = tmp_path / "out"
    with pytest.raises(raised, match=match):
        port.main(["--smoke=True", "--platform=cpu", f"--output_dir={out}", *extra], build=never)
    assert not out.exists()
