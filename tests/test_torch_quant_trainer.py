"""Training over a quantized frozen base, the port against the JAX package
on the CPU in float32: one ``Trainer`` step's loss and gradients against
``nnx.value_and_grad``, the trainable set, ``param_stats`` and
``trainable.npz`` in both directions.  The models are the tiny quantized
Llamas of ``test_torch_quant_llama.py`` (``quantized_pair``).
Tolerances: loss and gradients 1e-4 (``TOLERANCES["f32_logits"]``: float32
sums in another order through two layers and the loss); checkpoints bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer, TrainingArgs
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import (
    load_jax_state,
    read_jax_trainable,
    write_jax_trainable,
)
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.peft.surgery import trainable_filter as jax_trainable_filter
from sparse_matrix_fine_tuning_tpu.training import checkpoint as jckpt
from test_torch_quant_llama import PEFT, _flat_state, quantized_pair

LOGITS = TOLERANCES["f32_logits"]


def test_torch_quantized_trainer_step_matches_jax_gradient(tmp_path):
    """One Trainer step over an int4 base (the ``run_alpaca --bits 4``
    path): the loss and the gradient of every trainable parameter (the 28
    factors and the float LM head, JAX's default filter) against
    ``nnx.value_and_grad`` on the same batch, as tests/quant/test_quant.py
    trains; clipping off, so the gradients are the raw ones."""
    jm, tm = quantized_pair(4, seed=2)
    ids = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(np.int32)
    filt = jax_trainable_filter()

    def loss_fn(m, x):
        return m.loss(m(x), x)

    want_loss, grads = nnx.value_and_grad(loss_fn, argnums=nnx.DiffState(0, filt))(
        jm, jnp.array(ids))
    want = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(grads)}
    args = TrainingArgs(output_dir=str(tmp_path / "port"), learning_rate=1e-3, max_steps=1,
                        per_device_train_batch_size=2, max_grad_norm=0.0, logging_steps=0,
                        log_param_steps=0, merged_training="on")
    tr = Trainer(tm.train(), args, train_data={"input_ids": ids, "labels": ids}, device="cpu")
    assert tr._n_merged == 0  # merged training leaves quantized layers unmerged
    batch, _ = next(tr._batches(tr.train_data, 2, shuffle=False))
    loss = float(tr.train_step(batch))
    np.testing.assert_allclose(loss, float(want_loss), **LOGITS)
    got = {n: p for n, p in tm.named_parameters() if p.requires_grad}
    assert len(want) == len(got) == 29
    for name, value in want.items():
        port = got[name.replace("lm_head.kernel", "lm_head.weight")]
        grad = port.grad.T if name == "lm_head.kernel" else port.grad
        np.testing.assert_allclose(to_numpy(grad), value, **LOGITS)
    assert tm.model.layers[0].self_attn.q_proj.dense.grad is None


def test_torch_quantized_trainable_set_is_the_factors(tmp_path):
    """With the default extra paths (which take every parameter under
    ``lm_head``) and an Int8LMHead, the trainable set is the 28 factors
    alone: codes and scales are buffers or integer parameters.  param_stats
    counts the codes and scales as the JAX package does; JAX's filter also
    takes the head's int8 codes, the port's does not."""
    jm, tm = quantized_pair(8, head="w8a8", seed=4)
    args = TrainingArgs(output_dir=str(tmp_path / "port"), max_steps=1, logging_steps=0,
                        log_param_steps=0)
    tr = Trainer(tm, args, train_data={"input_ids": np.zeros((2, 4), np.int32),
                                       "labels": np.zeros((2, 4), np.int32)}, device="cpu")
    names = [n for n, _ in tr.trainable_parameters()]
    assert len(names) == 28 and all(n.endswith(("blkdiag1", "blkdiag2")) for n in names)
    assert sorted(surgery.trainable_filter(tm, ("__all__",))) == sorted(
        n for n, p in tm.named_parameters() if p.is_floating_point())
    total, trainable = surgery.param_stats(tm, verbose=False)
    jtotal, jtrainable = jpeft.param_stats(jm, verbose=False)
    assert total == jtotal
    assert trainable == jtrainable - jm.lm_head.kernel_q[...].size
    _, tm4 = quantized_pair(4, seed=4)
    jm4, _ = quantized_pair(4, seed=4)
    assert surgery.param_stats(tm4, verbose=False) == jpeft.param_stats(jm4, verbose=False)


def test_torch_quantized_trainable_npz_crosses_between_packages(tmp_path):
    """trainable.npz over an int4 base, written by each package and loaded
    by the other, bit for bit; the codes and scales are not in it."""
    jm, tm = quantized_pair(4, seed=5)
    _, other = quantized_pair(4, seed=6)  # other factor values, same structure
    surgery.trainable_filter(other)
    jfile = str(tmp_path / "jax_trainable.npz")
    jckpt._save_tree(jfile, nnx.state(jm, jax_trainable_filter()))
    assert len(read_jax_trainable(jfile, other)) == 29
    for name, p in other.named_parameters():
        if p.requires_grad:
            src = dict(tm.named_parameters())[name]
            assert torch.equal(p, src), name
    with torch.no_grad():
        for _, p in other.named_parameters():
            if p.requires_grad:
                p.mul_(-0.5)
    tfile = str(tmp_path / "port_trainable.npz")
    keys = write_jax_trainable(tfile, other)
    assert keys == sorted(np.load(jfile).files)
    assert not any("dense" in k or "scales" in k for k in keys)
    restored = jckpt._load_tree(tfile, nnx.state(jm, jax_trainable_filter()), strict=True)
    nnx.update(jm, restored)
    params = dict(other.named_parameters())
    for path, v in nnx.to_flat_state(nnx.state(jm, jax_trainable_filter())):
        name = ".".join(str(getattr(p, "key", p)) for p in path)
        port = params[name.replace("lm_head.kernel", "lm_head.weight")]
        port = port.T if name == "lm_head.kernel" else port
        np.testing.assert_array_equal(to_numpy(port), np.asarray(v[...]))


def test_torch_bridge_refuses_codes_into_a_float_model():
    jm, _ = quantized_pair(8, seed=7)
    plain = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(plain, PEFT)
    with pytest.raises((ValueError, KeyError)):
        load_jax_state(plain, _flat_state(jm))
    flat = _flat_state(jm)
    _, tm = quantized_pair(8, seed=7)
    flat.pop(("model", "layers", 0, "mlp", "up_proj", "dense_scales"))
    with pytest.raises(KeyError, match="dense_scales"):
        load_jax_state(tm, flat)


@pytest.mark.parametrize("impl", ["dequant", "w8a8"])
def test_torch_chunked_loss_takes_the_int8_head(impl):
    """``ops/losses.py`` takes the head as a callable: with an Int8LMHead
    the chunked loss (3 tokens a chunk) equals the full-logits loss, and
    its factor gradients too (float32, 1e-5)."""
    import dataclasses

    _, tm = quantized_pair(4, head=impl, seed=8)
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 7)))
    full = tm.loss(tm(ids), ids)
    (g_full,) = torch.autograd.grad(full, tm.model.layers[1].mlp.up_proj.blkdiag2)
    tm.config = dataclasses.replace(tm.config, loss_chunk=3)
    chunked = tm.training_loss(ids, ids)
    (g_chunked,) = torch.autograd.grad(chunked, tm.model.layers[1].mlp.up_proj.blkdiag2)
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_chunked, g_full, rtol=1e-5, atol=1e-5)
