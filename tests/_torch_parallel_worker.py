"""A rank of the CPU gloo worlds that the ``test_torch_parallel_*`` files
start: one world a file, at most 4 ranks of one torch thread each, every
case of the file inside it.

The parent starts the ranks with ``spawn`` and then writes the inputs into
the work directory (``put_inputs``: the JAX model's flat state as {path:
array}, the data, the cases), so the ranks' start overlaps its own work;
each rank waits for them, runs the suite's cases in order and writes
``rank<r>.pt``, which the parent reads with ``collect``.  This module
imports torch and the port, never JAX.

argv: suite rank world port workdir
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import traceback

WORLD = 4
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "v_proj", "k_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj"]}
# JAX tests/parallel/test_tp.py:84-97's flagship
FLAGSHIP = dict(vocab_size=128, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=512, max_position_embeddings=64)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(suite: str, workdir: str, world: int = WORLD) -> list:
    """Start the ranks of one world (they run until their suite ends)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    port = free_port()
    procs = []
    for r in range(world):
        with open(os.path.join(workdir, f"log{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, suite, str(r), str(world), str(port), workdir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def put_inputs(workdir: str, inputs: dict) -> None:
    """Hand the ranks their inputs (written whole, then renamed)."""
    import torch

    tmp = os.path.join(workdir, "inputs.tmp")
    torch.save(inputs, tmp)
    os.replace(tmp, os.path.join(workdir, "inputs.pt"))


def _inputs(workdir: str, timeout: float = 120) -> dict:
    import time

    import torch

    path = os.path.join(workdir, "inputs.pt")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.02)
    return torch.load(path, weights_only=False)


def _log(workdir: str, rank: int) -> str:
    with open(os.path.join(workdir, f"log{rank}.txt")) as f:
        return f.read()[-4000:]


def collect(procs: list, workdir: str, timeout: float = 120) -> list:
    """Wait for the ranks; their records, rank order.  The first rank to
    fail stops the others (they may wait in a collective) and fails the
    call with its log."""
    import time

    import torch

    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
                p.wait()
            raise AssertionError(f"rank {(failed or [0])[0]} failed or timed out:\n"
                                 f"{_log(workdir, (failed or [0])[0])}")
        time.sleep(0.05)
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{_log(workdir, r)}"
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


# -- inside a rank ---------------------------------------------------------------------

def _path(key: str) -> tuple:
    return tuple(int(p) if p.isdigit() else p for p in key.split("/"))


def port_model(state: dict, *, loss_chunk: int = 0, attention_impl: str = "einsum",
               remat: str | None = None):
    """The flagship of the port with the JAX model's state (``{"a/b/0/c":
    array}``) loaded; ``remat``: a remat policy (None: off)."""
    import dataclasses

    import torch

    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
    from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state

    cfg = dataclasses.replace(LlamaConfig(**FLAGSHIP), loss_chunk=loss_chunk,
                              attention_impl=attention_impl, remat=remat is not None,
                              remat_policy=remat or "nothing")
    model = LlamaForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    init_monarch(model, PEFT, generator=torch.Generator().manual_seed(1))
    load_jax_state(model, {_path(k): v for k, v in state.items()})
    return model


# adapter variants under tensor parallelism: a Scaler (its LayerNorm is not
# linear) and the multiplicative factor (square q/o only); dropout is held
# layer by layer (``dropout_layers``): each data rank draws its own masks
VARIANTS = {"scaler": {**PEFT, "scaler": True},
            "mult": {**PEFT, "use_mult_factor": True, "target_modules": ["q_proj", "o_proj"]}}


def dropout_layers(mesh) -> dict:
    """A column- and a row-parallel adapter layer with dropout 0.1 in
    training mode, on the same input on every rank and the random state
    seeded alike: the tp peers' summed (gathered) outputs against the whole
    layer's on this rank; the largest difference each."""
    import copy

    import torch

    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
    from sparse_matrix_fine_tuning_torch.parallel.annotate import (
        tensor_parallel, tp_gather, tp_reduce)
    from sparse_matrix_fine_tuning_torch.parallel.sharding import _shard_weight

    tp = tensor_parallel(mesh)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 8, 256, generator=g)
    out = {}
    for style, n_out in (("col", 512), ("row", 256)):
        layer = MonarchLinear(256, n_out, weights=torch.randn(n_out, 256, generator=g) * 0.05,
                              peft_config={**PEFT, "dropout": 0.1},
                              generator=torch.Generator().manual_seed(6))
        with torch.no_grad():
            layer.blkdiag2.normal_(0.0, 0.05, generator=g)
        layer.train()
        torch.manual_seed(0)
        ref = layer(x)
        part = copy.deepcopy(layer)
        _shard_weight(part, "dense", 0 if style == "col" else 1, tp, mesh["tp"])
        part.set_tensor_parallel(tp, style)
        torch.manual_seed(0)
        if style == "col":
            got = tp_gather(part(x), tp, -1)
        else:
            got = tp_reduce(part(x.chunk(tp.size, -1)[tp.rank]), tp)
        out[style] = float((got - ref).abs().max())
    return out


def variant_model(peft: dict):
    """The flagship of the port with ``peft``'s adapters, its weights drawn
    from seeded CPU generators and every adapter factor nonzero."""
    import torch

    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    model = LlamaForCausalLM(LlamaConfig(**FLAGSHIP), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    init_monarch(model, peft, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("blkdiag2", "scaler.scaler", "blkdiag_mult")):
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def variant_steps(model, data: dict, mesh, bs: int, output_dir: str) -> dict:
    """Eval, two steps and eval, the torch random state seeded first (the
    dropout masks)."""
    import torch

    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    tr = Trainer(model, train_args(output_dir, bs), train_data=data, eval_data=data,
                 loss_fn=lm_loss, mesh=mesh, device="cpu")
    torch.manual_seed(0)
    e0 = tr.evaluate()["eval_loss"]
    losses = two_steps(tr, data, bs)
    return {"eval": (e0, tr.evaluate()["eval_loss"]), "losses": losses,
            "adapters": {n: p.detach().clone() for n, p in model.named_parameters()
                         if p.requires_grad}}


def lm_loss(model, batch, train):
    """JAX test_tp.py's ``_lm_loss``: the full logits' CE, pad rows masked."""
    logits = model(batch["input_ids"], attention_mask=batch["attention_mask"])
    return model.loss(logits, batch["labels"], weights=batch.get("_valid"))


def train_args(output_dir: str, bs: int, **kw):
    from sparse_matrix_fine_tuning_torch.training.trainer import TrainingArgs

    return TrainingArgs(output_dir=output_dir, learning_rate=1e-3, max_steps=2,
                        per_device_train_batch_size=bs, per_device_eval_batch_size=8,
                        logging_steps=0, log_param_steps=0, **kw)


def two_steps(tr, data: dict, bs: int) -> list:
    """The first two optimizer steps of ``train()`` (its epoch-0 batches)."""
    tr.model.train()
    losses = []
    for batch, _ in tr._batches(data, bs, shuffle=True, seed=tr.args.seed):
        losses.append(float(tr.train_step(batch)))
        if len(losses) == 2:
            return losses
    raise AssertionError("fewer than two batches")


def spec_of(param) -> tuple:
    """A parameter's placement as a ``param_spec`` tuple, read from the
    DTensor FSDP2 and tensor parallelism made of it."""
    from torch.distributed.tensor import DTensor

    if not isinstance(param, DTensor):
        return ()
    spec = [None] * param.ndim
    for name, pl in zip(param.device_mesh.mesh_dim_names, param.placements):
        dim = getattr(pl, "dim", None)
        if dim is not None:
            spec[dim] = name
    return tuple(spec) if any(spec) else ()


def suite_train(rank: int, inputs: dict, workdir: str) -> dict:
    """Each mesh of ``inputs["meshes"]``: eval, two steps, eval."""
    import torch

    from sparse_matrix_fine_tuning_torch.parallel import get_activation_mesh, make_mesh, multihost
    from sparse_matrix_fine_tuning_torch.parallel.sharding import placement
    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    out = {}
    for tag, (shape, sp, merged, remat) in inputs["meshes"].items():
        mesh = make_mesh(*shape, device_type="cpu")
        parts, _ = multihost.data_rank(mesh)
        local = multihost.shard_data_for_process(inputs["data"], mesh=mesh)
        model = port_model(inputs["state"], remat=remat)
        bs = inputs["global_bs"] // parts
        args = train_args(os.path.join(workdir, tag), bs, sequence_parallel=sp,
                          merged_training=merged)
        tr = Trainer(model, args, train_data=local, eval_data=local, loss_fn=lm_loss, mesh=mesh,
                     device="cpu")
        e0 = tr.evaluate()["eval_loss"]
        losses = two_steps(tr, local, bs)
        e1 = tr.evaluate()["eval_loss"]
        params = dict(model.named_parameters())
        out[tag] = {
            "eval": (e0, e1), "losses": losses,
            "adapters": {n: p.detach().clone() for n, p in params.items() if p.requires_grad},
            "specs": placement(model).specs,
            "placed": {n: spec_of(params[n]) for n in placement(model).specs},
            "adapters_plain": all(spec_of(p) == () and type(p.data) is torch.Tensor
                                  for p in params.values() if p.requires_grad),
            "mesh_left": get_activation_mesh() is not None}
    return out


def suite_decode(rank: int, inputs: dict, workdir: str) -> dict:
    """Sharded greedy and beam decoding, the chunked loss under a
    column-parallel head, checkpoints and resume, the refusals, the
    activation layout and the data helpers, in one world."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import monarch_mm
    from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
    from sparse_matrix_fine_tuning_torch.parallel import (
        activation_mesh, get_activation_mesh, make_mesh, multihost, shard_model, shard_tokens)
    from sparse_matrix_fine_tuning_torch.parallel.sharding import placement
    from sparse_matrix_fine_tuning_torch.peft.surgery import trainable_filter
    from sparse_matrix_fine_tuning_torch.training import checkpoint as ckpt_lib
    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    out = {}
    ids, mask = torch.from_numpy(inputs["ids"]), torch.from_numpy(inputs["mask"])
    meshes = {"fsdp4": make_mesh(device_type="cpu"),
              "fsdp2_tp2": make_mesh(1, 2, 2, device_type="cpu")}
    out["mesh_shapes"] = {k: (tuple(m.mesh.shape), m.mesh_dim_names) for k, m in meshes.items()}
    out["data_rank"] = {k: multihost.data_rank(m) for k, m in meshes.items()}

    # greedy (and beam) decoding on the sharded model; under tp the frozen
    # head is column-parallel and the cache holds the rank's kv heads
    for tag, mesh in meshes.items():
        model = port_model(inputs["state"])
        trainable_filter(model, () if tag == "fsdp2_tp2" else ("lm_head",))
        shard_model(model, mesh)
        for beams in (1, 2):
            cfg = GenerationConfig(max_new_tokens=8, eos_token_id=None, pad_token_id=0,
                                   num_beams=beams)
            out[f"tokens/{tag}/{beams}"] = generate(model, ids, mask, cfg)
        out[f"kv_shards/{tag}"] = placement(model).kv_shards
        out[f"head/{tag}"] = type(model.lm_head.weight).__name__

    # the adapter variants at fsdp 2 x tp 2
    mesh = meshes["fsdp2_tp2"]
    local = multihost.shard_data_for_process(inputs["data"], mesh=mesh)
    out["variants"] = {tag: variant_steps(variant_model(peft), local, mesh, 4,
                                          os.path.join(workdir, tag))
                       for tag, peft in VARIANTS.items()}
    out["dropout_layers"] = dropout_layers(mesh)

    # the chunked loss with a column-parallel lm_head: eval, two steps, eval
    mesh = meshes["fsdp2_tp2"]
    local = multihost.shard_data_for_process(inputs["data"], mesh=mesh)
    model = port_model(inputs["state"], loss_chunk=16)
    tr = Trainer(model, train_args(os.path.join(workdir, "chunk"), 4), train_data=local,
                 eval_data=local, mesh=mesh, extra_trainable_paths=(), device="cpu")
    e0 = tr.evaluate()["eval_loss"]
    losses = two_steps(tr, local, 4)
    out["chunked"] = {"eval": (e0, tr.evaluate()["eval_loss"]), "losses": losses,
                      "head_tp": model.lm_head.tp_style}

    # checkpoints: rank 0 alone writes; every rank returns the same path;
    # a resume from a shared directory agrees; one rank elsewhere diverges
    writes = []
    real = ckpt_lib.write_jax_trainable
    ckpt_lib.write_jax_trainable = lambda *a, **k: (writes.append(a[0]), real(*a, **k))[1]
    shared = os.path.join(workdir, "ckpt")
    mesh = meshes["fsdp4"]
    local = multihost.shard_data_for_process(inputs["data"], mesh=mesh)

    def trainer(steps, output_dir):
        model = port_model(inputs["state"])
        args = train_args(output_dir, 2, save_steps=1, lr_scheduler_type="constant",
                          warmup_ratio=0.0)
        args.max_steps = steps
        return Trainer(model, args, train_data=local, loss_fn=lm_loss, mesh=mesh, device="cpu")

    first = trainer(1, shared)
    first.train()
    out["ckpt_path"] = first.save_checkpoint(tag="mh")
    first.load_checkpoint(out["ckpt_path"])
    out["ckpt_writes"] = list(writes)
    resumed = trainer(2, shared)
    resumed.train(resume=True)
    out["resumed"] = (resumed.step, {n: p.detach().clone() for n, p
                                     in resumed.model.named_parameters() if p.requires_grad})
    straight = trainer(2, os.path.join(workdir, f"straight{rank}"))
    straight.train()
    out["straight"] = {n: p.detach().clone() for n, p in straight.model.named_parameters()
                       if p.requires_grad}
    ckpt_lib.write_jax_trainable = real
    diverged = trainer(2, shared if rank != 1 else os.path.join(workdir, "elsewhere"))
    try:
        diverged.train(resume=True)
        out["divergence"] = None
    except RuntimeError as exc:
        out["divergence"] = str(exc)

    # the refusals that need a real mesh
    refusals = {}
    small = port_model(inputs["state"])
    trainable_filter(small)
    try:
        shard_model(small, make_mesh(1, 1, 4, device_type="cpu"))
    except ValueError as exc:
        refusals["kv_heads"] = str(exc)
    x = DTensor.from_local(torch.ones(4, 256), meshes["fsdp4"]["fsdp"], [Replicate()])
    w1, w2 = torch.ones(4, 4, 64), torch.ones(4, 64, 4)
    try:
        monarch_mm(x, w1, w2)
    except TypeError as exc:
        refusals["dtensor"] = str(exc)
    out["refusals"] = refusals

    # the sequence-parallel layout and its guards (JAX test_sp.py)
    x = torch.arange(8 * 16 * 4, dtype=torch.float32).reshape(8, 16, 4)
    with activation_mesh(meshes["fsdp2_tp2"]):
        sharded = shard_tokens(x)
        layout = {"split": torch.equal(sharded, x.chunk(2, 1)[mesh_coord(meshes, "tp")]),
                  "again": shard_tokens(sharded, 16) is sharded,
                  "odd_seq": shard_tokens(torch.ones(8, 7, 4)).shape == (8, 7, 4),
                  "not_3d": shard_tokens(torch.ones(8, 16)).shape == (8, 16)}
    layout["restored"] = get_activation_mesh() is None
    with activation_mesh(meshes["fsdp4"]):
        layout["tp1"] = shard_tokens(x) is x
    out["layout"] = layout

    # the batch contract: global_batch, and group_by_length's trim over ranks
    mesh = meshes["fsdp2_tp2"]
    local = multihost.shard_data_for_process(inputs["data"], mesh=mesh)
    out["global_batch"] = multihost.global_batch({k: v[:2] for k, v in local.items()}, mesh)
    lens = np.asarray([4, 12, 6, 16, 9, 3, 14, 7] * 2)
    gdata = dict(inputs["data"], attention_mask=(np.arange(16)[None] < lens[:, None]).astype(
        np.int32))
    glocal = multihost.shard_data_for_process(gdata, mesh=mesh)
    gtr = Trainer(port_model(inputs["state"]), train_args(os.path.join(workdir, "gbl"), 2,
                                                          group_by_length=True, length_bucket=4),
                  train_data=glocal, loss_fn=lm_loss, mesh=mesh, device="cpu")
    out["gbl_shapes"] = [tuple(b["input_ids"].shape) for b, _ in
                         gtr._batches(glocal, 2, shuffle=True, seed=0)]
    return out


def suite_reasoning(rank: int, inputs: dict, workdir: str) -> dict:
    """``run_reasoning --mesh_fsdp <world>``: rank 0 into the shared output
    directory, the others into their own, which must stay empty."""
    from sparse_matrix_fine_tuning_torch.scripts import run_reasoning

    record = {}
    for tag, argv in inputs["argvs"].items():
        out = os.path.join(workdir, tag, "out" if rank == 0 else f"out_rank{rank}")
        run = run_reasoning.run([*argv, f"--output_dir={out}"])
        record[tag] = {"results": run.results, "step": run.trainer.step,
                       "files": sorted(os.path.relpath(os.path.join(d, f), out)
                                       for d, _, fs in os.walk(out) for f in fs)}
    return record


def mesh_coord(meshes: dict, axis: str) -> int:
    return int(meshes["fsdp2_tp2"][axis].get_local_rank())


def main() -> None:
    suite, rank, world, port, workdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from sparse_matrix_fine_tuning_torch.parallel import multihost

    inputs = _inputs(workdir)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    try:
        record = SUITES[suite](rank, inputs, workdir)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other ranks may wait in a collective: do not hang on the group
    torch.save(record, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()


SUITES = {"train": suite_train, "decode": suite_decode, "reasoning": suite_reasoning}

if __name__ == "__main__":
    main()
