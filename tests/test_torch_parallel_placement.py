"""The port's mesh arithmetic, placement rule and data split against the
JAX package's (``parallel/mesh.py``, ``sharding.param_spec``,
``multihost.shard_data_for_process``), in one process, and the refusals
that need no process group.

Placement is compared on every parameter of JAX ``tests/parallel/
test_tp.py``'s flagship at (fsdp, tp) in {(8, 1), (4, 2), (2, 2), (1, 4)}:
the port's spec, in the port's (out, in) layout, is JAX's on the
corresponding flax path, transposed for a linear's ``kernel`` (in, out).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import _torch_parallel_worker as w
from sparse_matrix_fine_tuning_tpu.models import LlamaConfig as JLlamaConfig
from sparse_matrix_fine_tuning_tpu.models import LlamaForCausalLM as JLlama
from sparse_matrix_fine_tuning_tpu.parallel import make_mesh as jax_make_mesh
from sparse_matrix_fine_tuning_tpu.parallel import multihost as jax_multihost
from sparse_matrix_fine_tuning_tpu.parallel.sharding import param_spec as jax_param_spec
from sparse_matrix_fine_tuning_tpu.peft import init_monarch as jax_init_monarch
from sparse_matrix_fine_tuning_tpu.utils.testing import fresh_model
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.parallel import (
    get_activation_mesh,
    make_mesh,
    multihost,
    shard_model,
    shard_tokens,
)
from sparse_matrix_fine_tuning_torch.parallel.mesh import mesh_shape
from sparse_matrix_fine_tuning_torch.parallel.sharding import param_spec, placement
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
from sparse_matrix_fine_tuning_torch.quant import quantize_frozen_base
from sparse_matrix_fine_tuning_torch.training.adam8bit import jax_paths
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name

MESH_CASES = [(8, None, None, None), (8, 2, None, None), (8, None, 2, None),
              (8, None, None, 2), (8, 2, 2, 2), (8, 1, 8, 1), (4, None, None, 4),
              (4, 2, 2, 1), (2, None, 1, 2), (1, None, None, None),
              # JAX's assertions: tp not dividing the devices, a product off them
              (8, None, None, 3), (8, 3, None, None), (4, 2, 4, 1)]
PLACEMENTS = [(8, 1), (4, 2), (2, 2), (1, 4)]


@pytest.mark.parametrize("n,dp,fsdp,tp", MESH_CASES)
def test_torch_parallel_mesh_shape_is_jax_make_mesh(n, dp, fsdp, tp):
    """Shapes, defaults and assertion messages of ``make_mesh`` over n
    devices, against JAX's on the conftest's virtual CPU devices."""
    try:
        want = jax_make_mesh(dp, fsdp, tp, devices=jax.devices()[:n]).shape
    except AssertionError as exc:
        with pytest.raises(AssertionError) as got:
            mesh_shape(n, dp, fsdp, tp)
        assert str(got.value) == str(exc)
        return
    assert mesh_shape(n, dp, fsdp, tp) == (want["dp"], want["fsdp"], want["tp"])


def _jax_flagship():
    model = fresh_model(JLlama, JLlamaConfig(**w.FLAGSHIP))
    jax_init_monarch(model, w.PEFT, rngs=nnx.Rngs(1))
    return model


def _port_flagship():
    model = LlamaForCausalLM(LlamaConfig(**w.FLAGSHIP), device="cpu")
    init_monarch(model, w.PEFT)
    return model


@pytest.mark.parametrize("fsdp,tp", PLACEMENTS)
def test_torch_parallel_param_spec_is_jax_on_every_parameter(fsdp, tp):
    port = _port_flagship()
    params = dict(port.named_parameters())
    paths = jax_paths(port)
    seen = set()
    for path, v in nnx.to_flat_state(nnx.state(_jax_flagship(), nnx.Param)):
        keys = tuple(getattr(p, "key", p) for p in path)
        path_str = "".join(f"[{k!r}]" for k in keys) + ".value"  # jax.tree_util.keystr's form
        want = tuple(jax_param_spec(v[...], fsdp, tp, path_str))
        name, transposed = _port_name(keys)
        p = params[name]
        got = param_spec(p.shape, p.dtype, paths[name], fsdp, tp)
        assert got == (want[::-1] if transposed else want), name
        seen.add(name)
    assert seen == set(params)


# JAX test_tp.py:26-46 and :49-68 (the rule in isolation), in the port's
# names and layout: (JAX-layout shape, dtype, JAX path, fsdp, tp, transposed)
RULE_CASES = [
    ((512, 512), jnp.float32, "model/layers/0/self_attn/q_proj/dense", 2, 2, False),
    ((512, 512), jnp.float32, "model/layers/0/self_attn/o_proj/dense", 2, 2, False),
    ((512, 512), jnp.float32, "lm_head/kernel", 2, 2, True),
    ((512, 512), jnp.float32, "model/layers/0/mlp/down_proj/kernel", 2, 2, True),
    ((128, 256), jnp.float32, "model/layers/0/self_attn/k_proj/dense", 2, 2, False),  # small
    ((512, 512), jnp.float32, "model/embed_tokens/embedding", 2, 2, False),  # fsdp only
    ((512, 512), jnp.float32, "model/layers/0/self_attn/q_proj/dense", 2, 1, False),  # tp 1
    ((130, 512), jnp.float32, "model/layers/0/self_attn/q_proj/dense", 2, 4, False),  # backoff
    ((256, 512), jnp.uint8, "model/layers/0/self_attn/q_proj/dense", 2, 2, False),  # int4 codes
    ((512, 512), jnp.int8, "model/layers/0/mlp/down_proj/dense", 2, 2, False),  # int8 codes
    ((8, 512), jnp.float32, "model/layers/0/self_attn/q_proj/dense_scales", 2, 2, False),
]
_TORCH = {jnp.float32: torch.float32, jnp.uint8: torch.uint8, jnp.int8: torch.int8}


@pytest.mark.parametrize("shape,dtype,path,fsdp,tp,transposed", RULE_CASES)
def test_torch_parallel_param_spec_rule_cases(shape, dtype, path, fsdp, tp, transposed):
    jax_path = "".join(f"[{k!r}]" for k in path.split("/")) + ".value"
    want = tuple(jax_param_spec(jnp.zeros(shape, dtype), fsdp, tp, jax_path))
    port_shape = shape[::-1] if transposed else shape
    got = param_spec(port_shape, _TORCH[dtype], path, fsdp, tp)
    assert got == (want[::-1] if transposed else want)


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("nproc", [1, 2, 3, 4])
def test_torch_parallel_split_rows_is_jax_shard_data(monkeypatch, nproc, drop):
    """Every process's rows, in both remainder modes, on a ragged dataset of
    10 rows, against JAX's ``shard_data_for_process`` under a patched
    process count and index."""
    data = {"input_ids": np.arange(30).reshape(10, 3),
            "labels": np.arange(10) * 7}
    monkeypatch.setattr(jax_multihost.jax, "process_count", lambda: nproc)
    for pid in range(nproc):
        monkeypatch.setattr(jax_multihost.jax, "process_index", lambda pid=pid: pid)
        want = jax_multihost.shard_data_for_process(data, drop_remainder=drop)
        got = multihost.split_rows(data, nproc, pid, drop_remainder=drop)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shape", [(1, 4, 1), (2, 2, 1), (1, 2, 2), (1, 1, 4), (2, 1, 2)])
def test_torch_parallel_data_rank_of_tp_peers(shape):
    """A rank's data rank is its index over (dp, fsdp): tp peers share it,
    and with tp = 1 it is the rank (JAX's split by process)."""
    dp, fsdp, tp = shape
    layout = np.arange(dp * fsdp * tp).reshape(shape)  # make_mesh's row-major layout
    ranks = {int(layout[c]): multihost.data_coords(c, shape) for c in np.ndindex(*shape)}
    assert all(parts == dp * fsdp for parts, _ in ranks.values())
    for r, (_, part) in ranks.items():
        assert part == (r if tp == 1 else r // tp)
        assert all(ranks[q][1] == part for q in range(r - r % tp, r - r % tp + tp))


def test_torch_parallel_initialize_needs_a_card_or_the_cpu_asked():
    """No card and no ``device_type="cpu"``: ``initialize`` and ``make_mesh``
    raise, nothing falls back to the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.resolve_device_type(None)
    assert multihost.resolve_device_type("cpu") == "cpu"
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()


def test_torch_parallel_shard_tokens_noop_without_mesh():
    x = torch.ones(2, 8, 4)
    assert shard_tokens(x) is x
    assert get_activation_mesh() is None


def _fake_mesh(size):
    """What ``shard_model`` reads of a mesh before a quantized base is
    refused or run unsharded."""
    return types.SimpleNamespace(mesh=torch.zeros(1, size, 1), size=lambda: size)


@pytest.mark.parametrize("bits", [8, 4])
def test_torch_parallel_quantized_base_refused_on_more_than_one_rank(bits):
    """A quantized base on a mesh of more than one rank cites item 28b; on a
    one-rank mesh it runs as unsharded (nothing wrapped)."""
    model = _port_flagship()
    assert quantize_frozen_base(model, bits=bits) > 0
    with pytest.raises(NotImplementedError, match="item 28b"):
        shard_model(model, _fake_mesh(4))
    assert placement(model) is None
    one = _fake_mesh(1)
    assert shard_model(model, one) is model
    assert placement(model).wrapped is False and placement(model).mesh is one
    assert type(model.model.layers[0].self_attn.q_proj.dense) is torch.nn.Parameter
