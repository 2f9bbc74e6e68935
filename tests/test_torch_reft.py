"""The port's interventions (``interventions/reft.py``) against the JAX
package's on the CPU: every class of ``INTERVENTION_TYPES``, in float32 and
bfloat16, with the JAX module's weights carried by
``utils/jax_bridge.load_jax_state``: outputs, the gradient of every
parameter and of the inputs (and the source).  Then ``apply_at_positions``
with overlapping and -1 locations, dropout, the package-level names and the
Backpack refusal.

Tolerances: ``TOLERANCES["f32_op"]`` in float32; in bfloat16 ``bf16_atol``
(two bf16 ulps of the reference's scale) on outputs and 2^-4 of the
reference's largest magnitude on gradients: each is a reduction over the
batch, which XLA's backward sums in bfloat16 and torch's in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.interventions import reft as treft
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft

F32 = TOLERANCES["f32_op"]
D, R, B, P = 16, 4, 3, 5
CLASSES = sorted(set(jreft.INTERVENTION_TYPES) - {"Nothing"})
_rng = np.random.default_rng(11)
EXTRA = {
    "PCARotatedSpaceIntervention": {
        "pca_components": _rng.standard_normal((R, D)).astype(np.float32),
        "pca_mean": _rng.standard_normal(D).astype(np.float32),
        "pca_std": (1.0 + _rng.random(D)).astype(np.float32)},
    "NoiseIntervention": {"positions": P},
}


def state_of(module, *filters) -> dict:
    """{path: array} of an NNX module's parameters and variables, without
    random-number state."""
    state = nnx.state(module, *(filters or (nnx.Not(nnx.RngState),)))
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(state)}


def pair_of(name: str, dim: int = D, rank: int = R, **kw):
    """The JAX intervention (random nonzero trainable values) and the port's
    with its weights."""
    kw = {**EXTRA.get(name, {}), **kw}
    jcls, tcls = jreft.INTERVENTION_TYPES[name], treft.INTERVENTION_TYPES[name]
    if name == "NoIntervention":
        return jcls(), tcls()
    jm = jcls(dim, low_rank_dimension=rank, rngs=nnx.Rngs(3), **kw)
    rng = np.random.default_rng(5)
    for _, v in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        if name not in ("BoundlessRotatedSpaceIntervention", "SigmoidMaskRotatedSpaceIntervention"):
            v.set_value(v[...] + jnp.array(rng.normal(0, 0.1, v[...].shape), v[...].dtype))
    tm = tcls(dim, low_rank_dimension=rank, generator=torch.Generator().manual_seed(0), **kw)
    load_jax_state(tm, state_of(jm))
    return jm, tm


def jax_run(jm, h, src, cot, sub=None):
    """The JAX output and the gradients of sum(out * cot) for the
    parameters, h and the source."""
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def f(params, h, src):
        m = nnx.merge(graphdef, params, rest)
        kw = {} if sub is None else {"subspaces": sub}
        out = m(h, **kw) if src is None else m(h, source=src, **kw)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, h, src)
    g_params = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...], np.float32)
                for path, v in nnx.to_flat_state(grads[0])}
    return np.asarray(out, np.float32), g_params, grads[1], grads[2]


def port_run(tm, h, src, cot, sub=None):
    h = h.clone().requires_grad_(True)
    src = None if src is None else src.clone().requires_grad_(True)
    kw = {} if sub is None else {"subspaces": sub}
    out = tm(h, **kw) if src is None else tm(h, source=src, **kw)
    (out.float() * cot).sum().backward()
    g = {n: p.grad for n, p in tm.named_parameters()}
    return out, g, h.grad, None if src is None else src.grad


def takes_source(name):
    return issubclass(treft.INTERVENTION_TYPES[name], treft.SOURCE_BASED + (
        treft.SkipIntervention,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CLASSES)
def test_torch_intervention_matches_jax(name, dtype):
    jm, tm = pair_of(name)
    rng = np.random.default_rng(7)
    h = rng.standard_normal((B, P, D)).astype(np.float32)
    src = rng.standard_normal((B, P, D)).astype(np.float32) if takes_source(name) else None
    cot = rng.standard_normal((B, P, D)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want, jg, jgh, jgs = jax_run(jm, jnp.array(h, jdt), None if src is None else
                                 jnp.array(src, jdt), jnp.array(cot))
    got, tg, tgh, tgs = port_run(tm, to_torch(h, tdt), None if src is None else
                                 to_torch(src, tdt), to_torch(cot))
    assert got.dtype == tdt

    def close(a, b, grad=True):
        b = np.asarray(b, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(to_numpy(a), b, **F32)
        else:
            atol = 2.0 ** -4 * np.abs(b).max() if grad else bf16_atol(b)
            np.testing.assert_allclose(to_numpy(a), b, rtol=0, atol=atol + 1e-6)

    close(got, want, grad=False)
    close(tgh, jgh)
    if src is not None:
        close(tgs, jgs)
    trainable = set(getattr(tm, "adapter_params", ()))
    for sub in ("rotate_layer", "learned_source"):
        if hasattr(tm, sub):
            trainable |= {f"{sub}.weight"}
    assert set(tg) == set(jg) == trainable | {n for n in tg if n.endswith("bias")}
    for n in jg:
        close(tg[n], jg[n])


@pytest.mark.parametrize("name,sub", [("VanillaIntervention", [0, 3, 9]),
                                      ("RotatedSpaceIntervention", [1, 2]),
                                      ("LowRankRotatedSpaceIntervention", [0, 2]),
                                      ("ZeroIntervention", [4])])
def test_torch_intervention_subspaces_match_jax(name, sub):
    jm, tm = pair_of(name)
    rng = np.random.default_rng(8)
    h, src, cot = (rng.standard_normal((B, P, D)).astype(np.float32) for _ in range(3))
    want, jg, jgh, _ = jax_run(jm, jnp.array(h), jnp.array(src), jnp.array(cot), sub)
    got, tg, tgh, _ = port_run(tm, to_torch(h), to_torch(src), to_torch(cot), sub)
    np.testing.assert_allclose(to_numpy(got), want, **F32)
    np.testing.assert_allclose(to_numpy(tgh), np.asarray(jgh), **F32)
    for n in jg:
        np.testing.assert_allclose(to_numpy(tg[n]), jg[n], **F32)


def test_torch_apply_at_positions_overlapping_and_padded_matches_jax():
    """Repeated positions (f and l overlapping on a short prompt) sum their
    changes; a -1 pad adds nothing at position 0; the gradients of both."""
    jm, tm = pair_of("LoreftIntervention")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 7, D)).astype(np.float32)
    cot = rng.standard_normal((3, 7, D)).astype(np.float32)
    locs = np.array([[1, 1, 3, 6], [0, -1, -1, -1], [2, 5, 2, 2]], np.int32)
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def f(params, x):
        out = jreft.apply_at_positions(x, jnp.array(locs), nnx.merge(graphdef, params, rest))
        return jnp.sum(out * cot), out

    (_, want), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.array(x))
    xt = to_torch(x).requires_grad_(True)
    got = treft.apply_at_positions(xt, to_torch(locs), tm)
    (got * to_torch(cot)).sum().backward()
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **F32)
    np.testing.assert_allclose(to_numpy(xt.grad), np.asarray(jgx), **F32)
    for path, v in nnx.to_flat_state(jgp):
        np.testing.assert_allclose(to_numpy(getattr(tm, path[-1]).grad), np.asarray(v[...]),
                                   **F32)
    untouched = np.ones(7, bool)
    untouched[[0, 1, 3, 6]] = False
    np.testing.assert_array_equal(to_numpy(got)[0, untouched], x[0, untouched])
    np.testing.assert_array_equal(to_numpy(got)[1, 1:], x[1, 1:])
    np.testing.assert_array_equal(
        to_numpy(treft.gather_positions(to_torch(x), to_torch(locs))),
        np.asarray(jreft.gather_positions(jnp.array(x), jnp.array(locs))))


@pytest.mark.parametrize("name", ["LoreftIntervention", "NoreftIntervention",
                                  "MoReIntervention"])
def test_torch_intervention_dropout_acts_in_training(name):
    """Dropout acts in ``train()`` only (the JAX trainer switches every
    nnx.Dropout on); two modules of one seed draw the same masks."""
    def build():
        return treft.INTERVENTION_TYPES[name](D, low_rank_dimension=R, dropout=0.5,
                                              generator=torch.Generator().manual_seed(4))
    a, b = build(), build()
    h = torch.randn(B, P, D)
    with torch.no_grad():
        assert torch.equal(a.eval()(h), b.eval()(h))
        ta, tb = a.train()(h), b.train()(h)
        assert torch.equal(ta, tb)
        assert not torch.equal(ta, a.eval()(h))
        assert (ta == 0).float().mean() > 0.3


def test_torch_reft_package_names_match_jax():
    from sparse_matrix_fine_tuning_torch import interventions as tpkg
    from sparse_matrix_fine_tuning_tpu import interventions as jpkg

    assert tpkg.__all__ == jpkg.__all__
    assert set(treft.INTERVENTION_TYPES) == set(jreft.INTERVENTION_TYPES)
    assert [c.__name__ for c in treft.SOURCE_BASED] == [c.__name__ for c in jreft.SOURCE_BASED]


def test_torch_reft_refuses_the_backpack_site():
    from sparse_matrix_fine_tuning_torch.models.toy import MLPModel, ToyConfig

    base = MLPModel(ToyConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 25"):
        treft.ReftModel(base, treft.ReftConfig(representations=[
            {"layer": 0, "component": "sense_network_output",
             "intervention": "LoreftIntervention"}]))
