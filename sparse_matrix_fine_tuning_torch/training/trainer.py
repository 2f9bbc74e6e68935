"""Training loop of the port: the counterpart of the JAX ``Trainer``.

``sparse_matrix_fine_tuning_tpu/training/trainer.py`` runs a jitted step;
this one runs eagerly on the card (or on the CPU when ``device="cpu"``).
What it keeps of the JAX trainer:
  * ``TrainingArgs`` with the same fields and defaults;
  * the same batch order for a seed (``_batches``: numpy's shuffle, the
    ragged tail padded with copies of the last row and masked by
    ``_valid``, optional length grouping, whose trimming of the time axis
    leaves a ReFT batch's ``intervention_locations`` (b, n, p) alone);
  * gradient accumulation: each micro-batch's loss is backpropagated, the
    summed gradients divided by the number of micro-batches, and the
    merged-training operands refreshed once per optimizer step, before
    its first micro-batch;
  * the 3-group AdamW (or 8-bit AdamW, ``optim="adamw8bit"``) with its
    schedule and global-norm clipping (``training/optim.py``);
  * only the trainable filter's parameters train (``peft/surgery.py``):
    adapters (a ``ReftModel``'s interventions among them) and the extra
    paths, the LM head by default (MoReFT GLUE passes the classifier or
    none);
  * logging (every ``log_param_steps``, ``param_stats`` and, to the
    logger, ``utils/logging.watch_layers``), ``evaluate``, trainable-only
    checkpoints, ``load_checkpoint`` and ``load_best_model_at_end``;
  * mid-epoch-exact resume (``train(resume=True)``, the JAX trainer's
    ``_maybe_resume``): the newest numbered checkpoint in ``output_dir``
    restores the factors, the optimizer, the random state, the step, the
    best metric and checkpoint and ``log_history.json``; the run goes on at
    epoch ``step // steps_per_epoch`` with ``_batches(skip=...)``, which
    passes over the batches already taken without building them, so the
    resumed run sees the batches an uninterrupted one would.  A run found
    completed at this budget is loaded and not trained again; a completed
    shorter run is continued.

A mesh (``mesh=``, a ``parallel.make_mesh`` over the ranks of the process
group; JAX trainer.py:53-56, :224-237): the trainer places the model with
``parallel.shard_model`` (the frozen base FSDP2-sharded over "fsdp" and
tensor-parallel over "tp", the adapters and the optimizer's state
replicated), after ``trainable_filter``.  Each rank gives the trainer its
own rows (``parallel.multihost.shard_data_for_process``) and the per-rank
batch size; the global batch is that times the data ranks.  Under the mesh
the losses are the global batch's (``multihost.data_parallel_loss``), the
gradients are summed over tp where partial and averaged over the data ranks
before the clipping and the step (``sharding.sync_gradients``), every rank
reports the global train and eval losses, ``group_by_length`` trims every
rank's batch to the longest over the ranks, a resume checks that every rank
found what rank 0 found (and raises where not), and only rank 0 writes
checkpoints (``training/checkpoint.py``).  ``sequence_parallel`` "auto"
turns Megatron SP on where the mesh has tp > 1, "on" forces it (a no-op
without a mesh, as in JAX), "off" keeps it off; the activation mesh is
installed around the trainer's own steps only (JAX trainer.py:329-341).

Set aside, raising ``NotImplementedError``: ``state_split=False`` (the JAX
package's split of the frozen base out of the jitted step; in eager
PyTorch the frozen base is never copied, which is what ``True`` buys
there).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.parallel import multihost, sharding
from sparse_matrix_fine_tuning_torch.parallel.annotate import activation_mesh
from sparse_matrix_fine_tuning_torch.peft.surgery import (
    DEFAULT_TRAINABLE_PATHS,
    disable_merged_training,
    enable_merged_training,
    param_stats,
    refresh_merged,
    trainable_filter,
)
from sparse_matrix_fine_tuning_torch.training import checkpoint as ckpt_lib
from sparse_matrix_fine_tuning_torch.training.adam8bit import jax_paths
from sparse_matrix_fine_tuning_torch.training.optim import build_optimizer
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device
from sparse_matrix_fine_tuning_torch.utils.logging import watch_layers

@dataclasses.dataclass
class TrainingArgs:
    output_dir: str = "results/run"
    learning_rate: float = 5e-5
    num_train_epochs: float = 3.0
    max_steps: int = -1
    per_device_train_batch_size: int = 16
    per_device_eval_batch_size: int = 32
    gradient_accumulation_steps: int = 1
    weight_decay: float = 0.0
    warmup_ratio: float = 0.06
    lr_scheduler_type: str = "linear"
    max_grad_norm: float = 1.0
    seed: int = 42
    logging_steps: int = 50
    eval_steps: int = 0            # 0 = eval at epoch end only
    save_steps: int = 0            # 0 = save at end only
    save_total_limit: int = 1
    load_best_model_at_end: bool = False
    metric_for_best_model: str = "loss"
    greater_is_better: Optional[bool] = None
    large_lr: bool = False
    new_lr: float = 5e-3
    use_scaler: bool = False
    optim: str = "adamw"           # or "adamw8bit" (training/adam8bit.py)
    log_param_steps: int = 900
    bf16: bool = False
    # "on" merges every eligible adapter into its dense operand for training
    # (kernels/merged.py); "auto" is "off" in the port until the H100 sets
    # its rule (the JAX package's threshold is a TPU measurement); "off".
    merged_training: str = "auto"
    state_split: bool = True       # False raises: see the module docstring
    group_by_length: bool = False
    length_bucket: int = 64
    # Megatron sequence parallelism (parallel/annotate.py): "auto" on where
    # the mesh has tp > 1; "on" / "off" force it (no mesh: nothing to do).
    sequence_parallel: str = "auto"


class Trainer:
    """PEFT trainer.

    Args:
      model: a model of the port with adapters already in place.
      args: ``TrainingArgs``.
      train_data / eval_data: dict of numpy arrays with equal leading dims.
      loss_fn: (model, batch, train) -> scalar loss; the default is
        ``model.training_loss`` (``model.loss`` over the logits otherwise).
      compute_metrics: (model, eval_data) -> dict, optional.
      mesh: optional ("dp", "fsdp", "tp") ``DeviceMesh`` (the module
        docstring); train_data and eval_data are then this rank's rows.
      device: where batches go; the card when None.
      step_context: step -> context manager, optional, entered around each
        optimizer step's ``train_step`` in ``train`` (a caller's timing or
        profiling of the run's own steps).
    """

    def __init__(self, model: nn.Module, args: TrainingArgs,
                 train_data: Optional[dict] = None, eval_data: Optional[dict] = None,
                 loss_fn: Optional[Callable] = None, compute_metrics: Optional[Callable] = None,
                 mesh=None, logger=None,
                 extra_trainable_paths: Iterable[str] = DEFAULT_TRAINABLE_PATHS,
                 device=None, step_context: Optional[Callable] = None):
        if args.sequence_parallel not in ("auto", "on", "off"):
            raise ValueError(f"sequence_parallel must be auto, on or off, got "
                             f"{args.sequence_parallel!r}")
        if not args.state_split:
            raise NotImplementedError(
                "state_split=False: the JAX package's jitted-step state split is on "
                "ROADMAP.md's 'Do not port' list; the eager port never copies the frozen base")
        if args.merged_training not in ("auto", "on", "off"):
            raise ValueError(f"merged_training must be auto, on or off, got "
                             f"{args.merged_training!r}")
        self.model = model
        self.args = args
        self.mesh = mesh
        tp = int(mesh.mesh.shape[-1]) if mesh is not None else 1
        sp_on = args.sequence_parallel == "on" or (args.sequence_parallel == "auto" and tp > 1)
        self._sp_mesh = mesh if sp_on else None
        self.device = resolve_device(device)
        self.train_data = train_data
        self.eval_data = eval_data
        self.loss_fn = loss_fn or self._default_loss
        self.compute_metrics = compute_metrics
        self.logger = logger
        self.step_context = step_context or (lambda step: contextlib.nullcontext())
        self.extra_paths = tuple(extra_trainable_paths)
        self.step = 0
        self.log_history: list[dict] = []
        self.best_metric = None
        self.best_ckpt = None
        self._build()

    # ------------------------------------------------------------------
    @staticmethod
    def _default_loss(model, batch, train: bool):
        kwargs = {}
        if "attention_mask" in batch:
            kwargs["attention_mask"] = batch["attention_mask"]
        lkw = {"weights": batch["_valid"]} if "_valid" in batch else {}
        if hasattr(model, "training_loss"):
            return model.training_loss(batch["input_ids"], batch["labels"], **kwargs, **lkw)
        logits = model(batch["input_ids"], **kwargs)
        return model.loss(logits, batch["labels"], **lkw)

    def _n_examples(self, data) -> int:
        return len(next(iter(data.values())))

    def num_training_steps(self) -> int:
        if self.args.max_steps > 0:
            return self.args.max_steps
        return int(math.ceil(self.steps_per_epoch() * self.args.num_train_epochs))

    def steps_per_epoch(self) -> int:
        n = self._n_examples(self.train_data)
        per_step = self.args.per_device_train_batch_size
        return math.ceil(n / per_step / max(self.args.gradient_accumulation_steps, 1))

    def trainable_parameters(self) -> list[tuple[str, torch.Tensor]]:
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def _build(self) -> None:
        a = self.args
        trainable_filter(self.model, self.extra_paths)
        if self.mesh is not None:
            sharding.shard_model(self.model, self.mesh)
        # "auto" resolves to "off": the JAX rule (ga >= 2 and min(in, out) >=
        # 4096) rests on a TPU measurement; the H100's rule is ROADMAP.md
        # queue A item 11.
        self._n_merged = enable_merged_training(self.model) if a.merged_training == "on" else 0
        total = self.num_training_steps() if self.train_data is not None else 1
        named = self.trainable_parameters()
        self.optimizer = build_optimizer(
            named, learning_rate=a.learning_rate, total_steps=total,
            warmup_ratio=a.warmup_ratio, lr_scheduler_type=a.lr_scheduler_type,
            weight_decay=a.weight_decay, large_lr=a.large_lr, new_lr=a.new_lr,
            use_scaler=a.use_scaler, max_grad_norm=a.max_grad_norm, optim=a.optim,
            jax_paths=jax_paths(self.model, [n for n, _ in named]) if a.optim == "adamw8bit"
            else None)

    def _scope(self):
        """The contexts of a step or an evaluation under the mesh: the global
        batch's loss and, where SP is on, the activation mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(multihost.data_parallel_loss(self.mesh))
        stack.enter_context(activation_mesh(self._sp_mesh))
        return stack

    def close(self) -> None:
        """Drop the merged-training operands (one dense-sized matrix per layer)."""
        disable_merged_training(self.model)
        self._n_merged = 0

    # ------------------------------------------------------------------
    _TIME_KEYS = ("input_ids", "attention_mask", "labels", "token_type_ids",
                  "position_ids", "segment_ids")

    def _length_grouped_order(self, data, idx, macro):
        """Sort the shuffled order by true length within megabatches of 8
        optimizer steps, longest first."""
        lengths = np.asarray(data["attention_mask"]).sum(axis=1)
        mega = macro * 8
        out = []
        for s in range(0, len(idx), mega):
            chunk = idx[s:s + mega]
            out.append(chunk[np.argsort(-lengths[chunk], kind="stable")])
        return np.concatenate(out) if out else idx

    def _trim_batch(self, batch):
        """Trim the time axis to the batch's longest row, rounded up to a
        multiple of ``length_bucket``."""
        if "attention_mask" not in batch:
            return batch
        t = batch["attention_mask"].shape[-1]
        q = max(self.args.length_bucket, 1)
        maxlen = min(-(-int(batch["attention_mask"].sum(axis=1).max()) // q) * q, t)
        if self.mesh is not None:
            # every rank's batch the same length (JAX trainer.py:386-390)
            maxlen = multihost.all_max(maxlen)
        if maxlen >= t:
            return batch
        return {k: (v[:, :maxlen] if k in self._TIME_KEYS and v.ndim >= 2 and v.shape[1] == t
                    else v) for k, v in batch.items()}

    def _batches(self, data, batch_size, shuffle=True, seed=0, accum=1, skip=0):
        """Yield (batch, n_valid), batches as tensors on the device.  With
        accum > 1 each leaf is (accum, batch_size, ...): one optimizer step.
        ``skip``: start after the first ``skip`` batches without building
        them; the order is a function of ``seed`` alone (mid-epoch resume)."""
        n = self._n_examples(data)
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        macro = batch_size * max(accum, 1)
        group = self.args.group_by_length and shuffle and "attention_mask" in data
        if group:
            idx = self._length_grouped_order(data, idx, macro)
        for start in range(skip * macro, n, macro):
            sel = idx[start:start + macro]
            batch = {k: v[sel] for k, v in data.items()}
            if group:
                batch = self._trim_batch(batch)
            if len(sel) < macro:
                pad = macro - len(sel)
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                         for k, v in batch.items()}
                batch["_valid"] = np.concatenate(
                    [np.ones(len(sel), np.int32), np.zeros(pad, np.int32)])
            if accum > 1:
                batch = {k: v.reshape(accum, batch_size, *v.shape[1:]) for k, v in batch.items()}
            yield {k: self._to_device(v) for k, v in batch.items()}, len(sel)

    def _to_device(self, v) -> torch.Tensor:
        t = torch.from_numpy(np.array(v, copy=True))
        if t.dtype in (torch.int32, torch.int16, torch.uint8):
            t = t.long()
        return t.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on one batch (leaves (G, bs, ...) when
        ``gradient_accumulation_steps`` G > 1); returns the mean loss of its
        micro-batches, on the device."""
        g = max(self.args.gradient_accumulation_steps, 1)
        if self._n_merged:
            refresh_merged(self.model)
        self.optimizer.zero_grad()
        micro = [batch] if g == 1 else [{k: v[i] for k, v in batch.items()} for i in range(g)]
        total = None
        with self._scope():
            for mb in micro:
                loss = self.loss_fn(self.model, mb, True)
                loss.backward()
                total = loss.detach() if total is None else total + loss.detach()
        if g > 1:
            with torch.no_grad():
                for _, p in self.trainable_parameters():
                    if p.grad is not None:
                        p.grad.div_(g)
        if self.mesh is not None:
            sharding.sync_gradients(self.model)
            total = sharding.all_mean(total, self.model)
        self.optimizer.step()
        return total / g

    def train(self, resume: bool = False) -> dict:
        """Train to the step budget; ``resume``: go on from the newest
        checkpoint in ``output_dir`` where there is one."""
        a = self.args
        if resume:
            self._maybe_resume()
        total_steps = self.num_training_steps()
        bs = a.per_device_train_batch_size
        if a.max_steps > 0:
            epochs = int(math.ceil(total_steps / max(self.steps_per_epoch(), 1)))
        else:
            epochs = int(math.ceil(a.num_train_epochs))
        g = max(a.gradient_accumulation_steps, 1)
        t0 = time.time()
        running: list[torch.Tensor] = []
        tokens, window_t0 = 0, t0
        done = False
        self.model.train()
        # the restored step sets the epoch and the batch within it
        spe = max(self.steps_per_epoch(), 1)
        start_epoch = min(self.step // spe, max(epochs - 1, 0))
        skip = self.step - start_epoch * spe
        for epoch in range(start_epoch, epochs):
            if done:
                break
            for batch, _ in self._batches(self.train_data, bs, shuffle=True, seed=a.seed + epoch,
                                          accum=g, skip=skip if epoch == start_epoch else 0):
                with self.step_context(self.step):
                    loss = self.train_step(batch)
                if a.logging_steps:
                    running.append(loss)
                    tokens += int(batch["input_ids"].numel())
                self.step += 1
                if a.logging_steps and self.step % a.logging_steps == 0:
                    mean_loss = float(torch.stack(running).mean())
                    running = []
                    now = time.time()
                    rec = {"step": self.step, "loss": round(mean_loss, 5),
                           "tokens_per_s": round(tokens / max(now - window_t0, 1e-9)),
                           "elapsed_s": round(now - t0, 1)}
                    tokens, window_t0 = 0, now
                    self.log_history.append(rec)
                    print(json.dumps(rec))
                    if self.logger is not None:
                        self.logger.log(rec)
                if a.log_param_steps and self.step % a.log_param_steps == 0:
                    param_stats(self.model, extra_paths=self.extra_paths)
                    if self.logger is not None:
                        watch_layers(self.model, self.logger)
                if a.eval_steps and self.step % a.eval_steps == 0 and self.eval_data is not None:
                    self._do_eval()
                    self.model.train()
                if a.save_steps and self.step % a.save_steps == 0:
                    self.save_checkpoint()
                if self.step >= total_steps:
                    done = True
                    break
            if not a.eval_steps and self.eval_data is not None and not done:
                self._do_eval()
                self.model.train()
        self.model.eval()
        if self._n_merged:
            # the merged operands trail the last update until refreshed
            refresh_merged(self.model)
        metrics = self._do_eval() if self.eval_data is not None else {}
        self.save_checkpoint(final=True)
        if a.load_best_model_at_end and self.best_ckpt is not None:
            self.load_checkpoint(self.best_ckpt)
        return metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, eval_data: Optional[dict] = None) -> dict:
        data = eval_data if eval_data is not None else self.eval_data
        if self._n_merged:
            refresh_merged(self.model)
        self.model.eval()
        losses, counts = [], []
        for batch, n_valid in self._batches(data, self.args.per_device_eval_batch_size,
                                            shuffle=False):
            with self._scope():
                loss = self.loss_fn(self.model, batch, False)
            if self.mesh is not None:
                loss = sharding.all_mean(loss, self.model)  # the global batch's, every rank
            losses.append(float(loss))
            counts.append(n_valid)
        loss = float(np.average(losses, weights=counts)) if losses else float("nan")
        metrics = {"eval_loss": round(loss, 5)}
        if self.compute_metrics is not None:
            extra = self.compute_metrics(self.model, data)
            metrics.update({k if k.startswith("eval_") else f"eval_{k}": v
                            for k, v in extra.items()})
        return metrics

    def _do_eval(self) -> dict:
        metrics = self.evaluate()
        metrics["step"] = self.step
        self.log_history.append(metrics)
        print(json.dumps(metrics))
        if self.logger is not None:
            self.logger.log(metrics)
        a = self.args
        key = (a.metric_for_best_model if a.metric_for_best_model.startswith("eval_")
               else f"eval_{a.metric_for_best_model}")
        if key in metrics and a.load_best_model_at_end:
            val = metrics[key]
            greater = a.greater_is_better
            if greater is None:
                greater = not key.endswith("loss")
            if (self.best_metric is None
                    or (val > self.best_metric if greater else val < self.best_metric)):
                self.best_metric = val
                self.best_ckpt = self.save_checkpoint(tag="best")
        return metrics

    # ------------------------------------------------------------------
    def save_checkpoint(self, tag: Optional[str] = None, final: bool = False) -> str:
        spe = max(self.steps_per_epoch(), 1) if self.train_data is not None else 1
        return ckpt_lib.save(
            self.args.output_dir, self.step, self.model, self.optimizer, tag=tag,
            save_total_limit=self.args.save_total_limit, log_history=self.log_history,
            final=final,
            extra_meta={"epoch": self.step // spe, "batch_in_epoch": self.step % spe,
                        "data_seed": self.args.seed, "best_metric": self.best_metric,
                        "best_ckpt": self.best_ckpt})

    def load_checkpoint(self, path: str) -> None:
        meta = ckpt_lib.load(path, self.model, self.optimizer)
        if meta.get("step"):
            self.step = meta["step"]
        if self._n_merged:
            # stale merged operands would serve the weights from before the load
            refresh_merged(self.model)

    def _maybe_resume(self) -> None:
        """Load the newest numbered checkpoint of ``output_dir`` and the run's
        bookkeeping, as the JAX trainer's ``_maybe_resume``; nothing there:
        a fresh start."""
        last, completed = ckpt_lib.get_last_checkpoint(self.args.output_dir,
                                                       even_if_completed=True)
        step = 0
        if last is not None and os.path.exists(os.path.join(last, "meta.json")):
            with open(os.path.join(last, "meta.json")) as f:
                step = json.load(f).get("step", 0)
        if multihost.process_count() > 1:
            # every rank must take rank 0's decision, or the ranks' collectives
            # part ways (JAX trainer.py:629-643); every rank raises where any
            # rank's view differs
            local, root, differ = multihost.agree([last is not None, completed, step])
            if differ:
                raise RuntimeError(
                    f"multi-process resume divergence: rank {multihost.process_index()} sees "
                    f"(found={bool(local[0])}, completed={bool(local[1])}, step={local[2]}) in "
                    f"{self.args.output_dir!r} but rank 0 sees (found={bool(root[0])}, "
                    f"completed={bool(root[1])}, step={root[2]}) (some rank's view differs); "
                    "checkpoints must live on storage visible to every process")
        if last is None:
            return
        if completed and step >= self.num_training_steps():
            # finished at this budget: load it, and train() takes no step
            print(f"Run already completed at {last}; loading it")
        else:
            if completed and multihost.is_primary():
                # a longer budget: continue the finished shorter run
                os.remove(os.path.join(self.args.output_dir, "completed"))
            print(f"Resuming from {last}")
        self.load_checkpoint(last)
        self._restore_run_state(last)

    def _restore_run_state(self, last: str) -> None:
        """The best metric and checkpoint from ``last``'s meta and the log
        history written beside the checkpoints, so that a resumed run
        compares against the best before it and appends to its history."""
        with open(os.path.join(last, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("best_metric") is not None:
            self.best_metric = meta["best_metric"]
            best = meta.get("best_ckpt")
            if best is not None and os.path.isdir(best):
                self.best_ckpt = best
        hist_path = os.path.join(self.args.output_dir, "log_history.json")
        if not self.log_history and os.path.exists(hist_path):
            with open(hist_path) as f:
                self.log_history = json.load(f)
