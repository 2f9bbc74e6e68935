"""Where remat's wall time goes on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.probe_remat [--layers N]
[--rounds R]``.

At TinyLlama-1.1B widths (bf16, Monarch adapters on all seven projections,
random seeded factors), one training micro-batch (bs 4 x seq 512) of
``training_loss``, forward and backward, timed on the wall with the card
synchronised around it, the variants in turns, ``--rounds`` rounds after a
warm-up micro-batch each:

  none               no remat;
  nothing            remat "nothing" (``torch.utils.checkpoint``,
                     non-reentrant, as ``models/llama.py`` calls it);
  dots               remat "dots" (the selective contexts that keep
                     ``aten.mm``/``addmm`` outputs);
  nothing, no check  "nothing" with ``determinism_check="none"``;
  nothing, no rng    "nothing" with ``preserve_rng_state=False``;
  dots, keep none    the selective contexts with a policy that keeps
                     nothing: their dispatch mode's cost without the
                     saving.

Then the ATen ops each of none, nothing and dots dispatches a micro-batch
(counted by a ``TorchDispatchMode``), and ``cProfile``'s top functions by
their own time over one micro-batch under dots and under nothing.  The
variants patch ``models/llama.py``'s ``checkpoint`` and ``remat_context``
for their own micro-batches only.  It needs a CUDA card and fails without
one.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import dataclasses
import functools
import io
import pstats
import statistics
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from sparse_matrix_fine_tuning_torch.models import llama
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch, trainable_filter
from sparse_matrix_fine_tuning_torch.utils import benchlib

WIDTHS = dict(vocab_size=32000, hidden_size=2048, num_attention_heads=32, num_key_value_heads=4,
              intermediate_size=5632)  # TinyLlama-1.1B (bench.py:130-140)
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
BS, SEQ = 4, 512


def _keep_none(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.PREFER_RECOMPUTE


# variant -> (remat_policy or None, checkpoint's keyword arguments, context)
VARIANTS = {
    "none": (None, {}, None),
    "nothing": ("nothing", {}, None),
    "dots": ("dots", {}, None),
    "nothing, no check": ("nothing", {"determinism_check": "none"}, None),
    "nothing, no rng": ("nothing", {"preserve_rng_state": False}, None),
    "dots, keep none": ("dots", {}, functools.partial(create_selective_checkpoint_contexts,
                                                      _keep_none)),
}


def build(layers: int):
    cfg = LlamaConfig(**WIDTHS, num_hidden_layers=layers, param_dtype="bfloat16",
                      dtype="bfloat16", max_position_embeddings=SEQ)
    g = torch.Generator(device="cuda").manual_seed(0)
    model = llama.LlamaForCausalLM(cfg, device="cuda", generator=g)
    init_monarch(model, PEFT, generator=g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "blkdiag2" in name:
                p.normal_(0.0, 0.02, generator=g)
    trainable_filter(model, ())
    return model


@contextlib.contextmanager
def variant(model, name: str):
    """``model`` set up as ``name`` for the block, and put back after it."""
    policy, kwargs, context = VARIANTS[name]
    kept = (model.config, llama.checkpoint, llama.remat_context)
    cfg = dataclasses.replace(model.config, remat=policy is not None,
                              remat_policy=policy or "nothing")
    model.config = model.model.config = cfg
    if kwargs:
        llama.checkpoint = functools.partial(kept[1], **kwargs)
    if context is not None:
        llama.remat_context = lambda policy: context
    try:
        yield
    finally:
        model.config = model.model.config = kept[0]
        llama.checkpoint, llama.remat_context = kept[1], kept[2]


def micro_batch(model, ids) -> None:
    model.zero_grad(set_to_none=True)
    model.training_loss(ids, ids).backward()


def timed_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def run(layers: int = 22, rounds: int = 5) -> dict:
    card = benchlib.require_card("probe_remat")
    print(benchlib.card_line(), flush=True)
    model = build(layers)
    model.train()
    ids = torch.randint(3, WIDTHS["vocab_size"], (BS, SEQ), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    times = {name: [] for name in VARIANTS}
    for name in VARIANTS:
        with variant(model, name):
            micro_batch(model, ids)  # warm-up
    for _ in range(rounds):
        for name in VARIANTS:
            with variant(model, name):
                times[name].append(timed_ms(lambda: micro_batch(model, ids)))
    out = {"card": card, "layers": layers, "ms": {}, "aten_ops": {}}
    base = statistics.median(times["none"])
    for name, ms in times.items():
        med = statistics.median(ms)
        out["ms"][name] = med
        print(f"[remat] {name:18s} {med:9.2f} ms a micro-batch on the wall (median of {rounds}; "
              f"{med - base:+.2f} against none; all {[round(x, 2) for x in ms]})", flush=True)
    for name in ("none", "nothing", "dots"):
        with variant(model, name), CountOps() as mode:
            micro_batch(model, ids)
        torch.cuda.synchronize()
        out["aten_ops"][name] = sum(mode.ops.values())
        print(f"[remat] {name}: {out['aten_ops'][name]} ATen ops dispatched a micro-batch",
              flush=True)
    for name in ("nothing", "dots"):
        prof = cProfile.Profile()
        with variant(model, name):
            torch.cuda.synchronize()
            prof.enable()
            micro_batch(model, ids)
            torch.cuda.synchronize()
            prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
        print(f"[remat] cProfile, one micro-batch under {name} (own time):", flush=True)
        print("\n".join(line for line in text.getvalue().splitlines()
                        if line.strip() and not line.startswith("   Ordered")), flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=22)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    return run(args.layers, args.rounds)


if __name__ == "__main__":
    main()
