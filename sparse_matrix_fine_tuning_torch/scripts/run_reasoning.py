"""Reasoning and instruction fine-tuning (commonsense, math, gsm8k, alpaca,
instruct, ultrafeedback) with generation-based evaluation:
``python -m sparse_matrix_fine_tuning_torch.scripts.run_reasoning [flags]``.

Counterpart of the JAX harness ``run_reasoning.py`` at the repository's root
(the reference's pyreft/loreft/train.py, driven by reasoning_scripts/
{math,common_sense}_monarch.sh): the same flags and defaults.  It builds a
Llama from a local HF-format directory (``--model <dir>``, through
``models/hf_convert.from_pretrained_causal_lm`` in bfloat16, with
``--gradient_checkpointing`` and ``--remat_policy``) or the JAX harness's
tiny random Llama, puts Monarch adapters on the attention and MLP
projections, trains with the masked causal-LM loss through the port's
``Trainer`` (``--pack`` bin-packs the rows), then scores each eval dataset
of the task by generation, greedy or with the task's other
``generation_args`` (beam 4, sampling, penalties and n-gram bans).  It
writes ``eval_results.json``, ``generations.json`` and ``metrics.jsonl``
into ``<output_dir>/<task>``.  It runs on the card; ``--platform=cpu``
runs it on the CPU, on the kernels' plain versions.

Without ``--smoke`` the hash tokenizer has 32000 ids and the tiny model as
many (the JAX harness keeps 1024 in its model and feeds it the larger ids:
ROADMAP.md C.12).  A directory that holds an HF tokenizer is refused
(``data/tokenizer.get_tokenizer``).  The task's non-greedy math and
commonsense evals (beam-sample with top-k and top-p) are refused as in the
JAX package; ``-top_k 0 -top_p 1.0`` gives their beam-sample at the task's
temperature (ROADMAP.md C.13).

``main`` and ``run`` take ``build``, a callable ``(args, peft_config) ->
model`` in place of ``build_model``, and ``run`` takes ``step_context``, the
``Trainer``'s hook around each step; tests and ``chip_smoke.py`` pass them.
``run`` returns a ``ReasoningRun`` whose ``evaluate`` is the harness's own
evaluation of the trained model.

``--do_tune`` searches the lr (log-uniform in [5e-5, 1e-3]), blk_r (2, 4, 8)
and nblocks (2, 4) with ``training/hpo.py`` on ``eval/average``, each
trial trained in ``trial_<id>/`` and scored there by greedy generation, up
to ``-e`` epochs; the final run trains with the best.  On an open-ended task
(alpaca, instruct, ultrafeedback), which scores no exact match, it exits
before any work, as the JAX harness does: tune on ``tune_math`` or
``tune_commonsense``.

Refused with ``NotImplementedError`` before any work, each naming its
ROADMAP.md queue A item: ``--task glue`` (20, 24), an ``--intervention_type``
other than Nothing (24) and ``--mesh_fsdp`` (28).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch.data.alpaca import pack_tokenized
from sparse_matrix_fine_tuning_torch.data.reasoning import (
    TASK_CONFIG,
    load_data_items,
    tokenize_reasoning,
)
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer, get_tokenizer
from sparse_matrix_fine_tuning_torch.evaluation.reasoning import compute_reasoning_metrics
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.hf_convert import from_pretrained_causal_lm
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch, param_stats
from sparse_matrix_fine_tuning_torch.training.hpo import (
    choice,
    hyperparameter_search,
    loguniform,
)
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer, TrainingArgs
from sparse_matrix_fine_tuning_torch.utils import profiling
from sparse_matrix_fine_tuning_torch.utils.config import (
    load_best_hp,
    load_json,
    override_config,
    save_best_hp,
)
from sparse_matrix_fine_tuning_torch.utils.device import harness_device, trial_devices
from sparse_matrix_fine_tuning_torch.utils.logging import RunLogger, get_run_group, watch_layers

SMOKE_VOCAB = 1024
HASH_VOCAB = 32000  # the hash tokenizer's vocabulary without --smoke
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PEFT_CONFIG = os.path.join(REPO, "task_configs", "llama", "peft_config.json")
NO_INTERVENTION = ("Nothing", "NoIntervention")
ATTENTION_TARGETS = ["q_proj", "k_proj", "v_proj", "o_proj"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Reasoning fine-tuning (MoRe, PyTorch port)")
    p.add_argument("-task", "--task", default="math",
                   choices=["commonsense", "math", "alpaca", "gsm8k", "instruct",
                            "ultrafeedback", "glue", "tune_math", "tune_commonsense"])
    p.add_argument("-model", "--model", default="llama-2-7b",
                   help="a local HF-format checkpoint directory, or a name (random tiny init)")
    p.add_argument("-data_dir", "--data_dir", default="dataset")
    p.add_argument("-seed", "--seed", default=42, type=int)
    p.add_argument("-p", "--position", default="f7+l7")
    p.add_argument("-e", "--epochs", default=3.0, type=float)
    p.add_argument("-lr", "--lr", default=5e-4, type=float)
    p.add_argument("-batch_size", "--batch_size", default=2, type=int)
    p.add_argument("-eval_batch_size", "--eval_batch_size", default=8, type=int)
    p.add_argument("-gradient_accumulation_steps", "--gradient_accumulation_steps",
                   default=16, type=int)
    p.add_argument("-max_length", "--max_length", default=512, type=int)
    p.add_argument("-max_n_train_example", "--max_n_train_example", default=None, type=int)
    p.add_argument("-max_n_eval_example", "--max_n_eval_example", default=None, type=int)
    p.add_argument("--schedule", default="linear")
    p.add_argument("--warmup_ratio", default=0.06, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--dropout", default=None, type=float)
    p.add_argument("--greedy_decoding", default=True, type=eval)
    p.add_argument("--intervention_type", default="Nothing",
                   help="ReFT intervention; only Nothing (ROADMAP.md queue A item 24)")
    p.add_argument("-l", "--layers", default="all",
                   help="intervention layers (with an intervention only)")
    p.add_argument("-rank", "--rank", default=4, type=int,
                   help="intervention low-rank dimension (with an intervention only)")
    p.add_argument("-sw", "--share_weights", nargs="?", const=True, default=False, type=eval,
                   help="tie the first-n and last-n position interventions")
    p.add_argument("-train_dataset", "--train_dataset", default=None,
                   help="override the task's default train dataset")
    p.add_argument("-eval_dataset", "--eval_dataset", default=None,
                   help="restrict eval to one dataset (default: all of the task's)")
    p.add_argument("-test_split", "--test_split", default="test")
    p.add_argument("-allow_cls_grad", "--allow_cls_grad", action="store_true",
                   help="glue task only (refused: ROADMAP.md queue A items 20, 24)")
    p.add_argument("--metric_for_best_model", default=None, help="glue task only")
    p.add_argument("-t", "--temperature", default=None, type=float)
    p.add_argument("-top_p", "--top_p", default=None, type=float)
    p.add_argument("-top_k", "--top_k", default=None, type=int)
    p.add_argument("--max_steps", default=-1, type=int)
    p.add_argument("--all_linear", default=True, type=eval)
    p.add_argument("--pack", default=False, type=eval,
                   help="sequence packing of training rows (segment-masked attention)")
    p.add_argument("--do_tune", default=False, type=eval,
                   help="ASHA search of lr, blk_r and nblocks on eval/average")
    p.add_argument("--parallel_trials", default=1, type=int)
    p.add_argument("--n_trials", default=6, type=int)
    p.add_argument("--gradient_checkpointing", default=True, type=eval,
                   help="remat decoder layers of local weights (the reference's 7B default)")
    p.add_argument("--remat_policy", default="nothing", choices=["nothing", "dots"],
                   help="what remat saves: 'nothing' = full recompute (minimum memory); "
                        "'dots' = keep the base products' outputs")
    p.add_argument("--loss_chunk", default=0, type=int,
                   help="compute the CE loss in token chunks of this size (0 = off)")
    p.add_argument("--smoke", default=False, type=eval)
    p.add_argument("--output_dir", default="results/reasoning")
    p.add_argument("--logging_steps", default=10, type=int)
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the training run, into "
                        "<output_dir>/<task>/profile")
    p.add_argument("--platform", default=None, choices=[None, "cuda", "cpu"],
                   help="where to run: the card when unset")
    p.add_argument("--mesh_fsdp", default=0, type=int,
                   help="FSDP-shard the frozen base; refused (ROADMAP.md queue A item 28)")
    return p.parse_known_args(argv)


# tasks scored by generation dumps, with no exact match to tune on
OPEN_ENDED = ("alpaca", "instruct", "ultrafeedback")


def check_supported(args) -> None:
    """Raise ``NotImplementedError`` for an option the port has not yet,
    naming its ROADMAP.md queue A item; exit, as the JAX harness does, for
    ``--do_tune`` on an open-ended task."""
    refused = []
    if args.task == "glue":
        refused.append("--task glue (MoReFT classification): items 20 and 24")
    if args.intervention_type not in NO_INTERVENTION:
        refused.append(f"--intervention_type {args.intervention_type} (ReFT): item 24")
    if args.mesh_fsdp:
        refused.append("--mesh_fsdp (a sharded base): item 28")
    if refused:
        raise NotImplementedError("run_reasoning: " + "; ".join(refused) + " (ROADMAP.md queue A)")
    if args.do_tune and args.task.replace("tune_", "") in OPEN_ENDED:
        raise SystemExit(
            f"--do_tune is meaningless for open-ended task {args.task!r}: it "
            "produces alpaca_eval generation dumps, not an EM metric, so "
            "every trial would tie at 'worst'.  Tune on tune_math / "
            "tune_commonsense, or the alpaca flow's MMLU metric via "
            "run_alpaca.py --do_tune (reference tunes qlora on "
            "eval_mmlu_eval_accuracy)")


def local_weights(args) -> bool:
    return not args.smoke and os.path.isdir(args.model)


def build_model(args, peft_config: dict):
    """The checkpoint of ``--model <dir>`` in bfloat16 on the harness's
    device, remat as ``--gradient_checkpointing`` and ``--remat_policy``
    say; else the JAX harness's tiny random Llama, drawn on the CPU from a
    generator seeded ``seed`` (with ``SMOKE_VOCAB`` ids under ``--smoke``,
    else ``HASH_VOCAB``).  Monarch adapters go on the peft config's targets
    (the attention projections with ``--all_linear=False``), their factors
    from a generator seeded ``seed + 1`` on the model's device."""
    device = harness_device(args)
    if local_weights(args):
        model = from_pretrained_causal_lm(args.model, dtype="bfloat16", device=device,
                                          remat=args.gradient_checkpointing,
                                          remat_policy=args.remat_policy)
    else:
        if not args.smoke:
            print(f"[reasoning] no local weights at {args.model!r}; random tiny init")
        cfg = LlamaConfig.tiny(vocab_size=SMOKE_VOCAB if args.smoke else HASH_VOCAB,
                               hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                               num_key_value_heads=2, intermediate_size=256,
                               max_position_embeddings=1024)
        model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(args.seed))
    if not args.all_linear:
        peft_config = dict(peft_config, target_modules=ATTENTION_TARGETS)
    at = next(model.parameters()).device
    adapted = init_monarch(model, peft_config,
                           generator=torch.Generator(device=at).manual_seed(args.seed + 1))
    print(f"[reasoning] adapted {len(adapted)} layers with Monarch")
    if args.loss_chunk:
        model.config = dataclasses.replace(model.config, loss_chunk=args.loss_chunk)
    param_stats(model)
    return model.to(device)


@dataclasses.dataclass
class ReasoningRun:
    """What ``run`` leaves: the eval results ``main`` returns, the trained
    model's trainer, and ``evaluate(greedy=True, max_new=None, out=None)``,
    the harness's evaluation over every eval dataset, which writes
    ``generations.json`` into ``out`` (the task's directory when None); with
    ``--do_tune`` the search's result (``training/hpo.py``)."""
    args: argparse.Namespace
    results: dict
    trainer: Trainer
    tokenizer: SimpleTokenizer
    evaluate: Callable[..., dict]
    search: Optional[dict] = None


def run(argv=None, *, build: Optional[Callable] = None,
        step_context: Optional[Callable] = None) -> ReasoningRun:
    args, overrides = parse_args(argv)
    check_supported(args)
    device = harness_device(args)
    peft_config = load_json(PEFT_CONFIG)
    if args.dropout is not None:
        peft_config["dropout"] = args.dropout
    extra = override_config([peft_config, args], overrides)
    if extra:
        print(f"[reasoning] unmatched overrides: {extra}")

    task = args.task
    tcfg = TASK_CONFIG[task]
    out_dir = os.path.join(args.output_dir, task)
    tokenizer = SimpleTokenizer(vocab_size=SMOKE_VOCAB) if args.smoke \
        else get_tokenizer(args.model, vocab_size=HASH_VOCAB)

    # one intervention's locations, as the JAX harness builds them without
    # one; no caller reads them
    tok_kw = dict(position=args.position, share_weights=args.share_weights,
                  num_interventions=1)
    train_items = load_data_items(
        task, args.train_dataset or tcfg["train_datasets"][0], args.data_dir, split="train",
        max_n_example=args.max_n_train_example, seed=args.seed, smoke=args.smoke)
    train_data = tokenize_reasoning(task, train_items, tokenizer, max_length=args.max_length,
                                    split="train", **tok_kw)
    train_data = {k: v for k, v in train_data.items()
                  if k in ("input_ids", "attention_mask", "labels")}
    if args.pack:
        n_before = len(train_data["input_ids"])
        train_data, eff = pack_tokenized(train_data, args.max_length)
        print(f"[reasoning] packed {n_before} examples into "
              f"{len(train_data['input_ids'])} rows ({eff:.0%} token efficiency)")

    def lm_loss(model, batch, train):
        # the fused forward and CE; chunked when --loss_chunk > 0
        return model.training_loss(
            batch["input_ids"], batch["labels"], attention_mask=batch["attention_mask"],
            segment_ids=batch.get("segment_ids"), weights=batch.get("_valid"))

    def make_trainer(hp=None, epochs=None, logger=None):
        pc = dict(peft_config)
        ta = TrainingArgs(
            output_dir=out_dir, learning_rate=args.lr,
            num_train_epochs=epochs if epochs is not None else args.epochs,
            per_device_train_batch_size=args.batch_size,
            per_device_eval_batch_size=args.eval_batch_size,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
            lr_scheduler_type=args.schedule, logging_steps=args.logging_steps,
            max_steps=args.max_steps, log_param_steps=0, seed=args.seed)
        if hp:
            override_config([ta, pc], hp)
        model = (build or build_model)(args, pc)
        return Trainer(model, ta, train_data=train_data, loss_fn=lm_loss, logger=logger,
                       device=device, step_context=step_context)

    def eval_all(model, greedy: bool = True, max_new: Optional[int] = None,
                 out: Optional[str] = None) -> dict:
        out = out or out_dir
        results, all_gen = {}, []
        for ds in ([args.eval_dataset] if args.eval_dataset else tcfg["eval_datasets"]):
            items = load_data_items(task, ds, args.data_dir, split=args.test_split,
                                    is_eval=True, max_n_example=args.max_n_eval_example,
                                    seed=args.seed, smoke=args.smoke)
            eval_data = tokenize_reasoning(task, items, tokenizer, max_length=args.max_length,
                                           split="test", **tok_kw)
            gens, metrics = compute_reasoning_metrics(
                task, ds, model, tokenizer, eval_data, items,
                batch_size=args.eval_batch_size, greedy_decoding=greedy,
                max_new_tokens=max_new, temperature=args.temperature, top_p=args.top_p,
                top_k=args.top_k)
            results.update(metrics)
            all_gen.extend(gens)
        if results:
            results["eval/average"] = float(np.mean(list(results.values())))
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "generations.json"), "w") as f:
            json.dump(all_gen[:200], f, indent=1)
        return results

    smoke_new = 8 if args.smoke else None
    search = None
    if args.do_tune:
        space = {"learning_rate": loguniform(5e-5, 1e-3), "blk_r": choice([2, 4, 8]),
                 "nblocks": choice([2, 4])}

        def run_trial(hp, epochs, trial_id):
            # a trial's own directory (checkpoints, generations), resumed at
            # each rung
            trial_dir = os.path.join(out_dir, f"trial_{trial_id}")
            t = make_trainer(dict(hp, output_dir=trial_dir), epochs)
            t.train(resume=True)
            return eval_all(t.model, greedy=True, max_new=smoke_new, out=trial_dir)

        search = hyperparameter_search(
            run_trial, space, n_trials=args.n_trials, parallel_trials=args.parallel_trials,
            devices=trial_devices(args.parallel_trials, device), target_metric="eval/average",
            mode="max", max_epochs=float(args.epochs))
        hp = search["best_hyperparams"]
        save_best_hp(hp, out_dir)
        print(json.dumps({"best_hyperparams": hp, "best_metric": search["best_metric"]}))
    else:
        hp = load_best_hp(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    logger = RunLogger(out_dir, group=get_run_group(task_name=task, do_tune=args.do_tune),
                       name=f"{task}_final", config={"task": task, "hp": hp or {}})
    try:
        trainer = make_trainer(hp, logger=logger)
        watch_layers(trainer.model, logger)
        profile = (profiling.trace(os.path.join(out_dir, "profile")) if args.profile
                   else contextlib.nullcontext())
        with profile:
            trainer.train()
        results = eval_all(trainer.model, greedy=args.greedy_decoding, max_new=smoke_new)
        # the keys are already "eval/<dataset>": logged verbatim, so that
        # metrics.jsonl matches eval_results.json
        logger.log({"step": trainer.step, **{k: v for k, v in results.items()
                                             if isinstance(v, (int, float))}})
        watch_layers(trainer.model, logger)
    finally:
        logger.finish()
    print(json.dumps(results))
    with open(os.path.join(out_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=1)

    def evaluate(greedy: bool = True, max_new: Optional[int] = None,
                 out: Optional[str] = None) -> dict:
        return eval_all(trainer.model, greedy=greedy,
                        max_new=smoke_new if max_new is None else max_new, out=out)

    return ReasoningRun(args, results, trainer, tokenizer, evaluate, search)


def main(argv=None, *, build: Optional[Callable] = None) -> dict:
    """Run the harness; returns the eval results it prints last and writes
    to ``eval_results.json``."""
    return run(argv, build=build).results


if __name__ == "__main__":
    main()
