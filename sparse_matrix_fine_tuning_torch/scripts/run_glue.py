"""GLUE fine-tuning with Monarch adapters on RoBERTa or DeBERTa:
``python -m sparse_matrix_fine_tuning_torch.scripts.run_glue <task config> [flags]``.

Counterpart of the JAX harness ``run_glue.py`` at the repository's root (the
reference's run_glue.py, the paper's headline experiment), with its flags
and defaults: the task JSON (``task_configs/{monarch_roberta_glue,
deberta_glue}/<task>.json``) gives the data and training arguments, the
``peft_config.json`` beside it the adapters, and free-form ``--key=value``
overrides apply to all three.  It tokenizes GLUE (HF ``datasets`` from the
local cache only, else the learnable synthetic splits; ``--smoke`` uses
them and the hash tokenizer's 1024 ids), builds the encoder the config's
``model_name_or_path`` names ("deberta" in it: DeBERTa-v2/v3, else
RoBERTa; from a local HF-format directory through ``models/hf_convert``, or
randomly initialised as the JAX harness does), adapts the peft config's
targets, trains through the port's ``Trainer`` (length grouping on, bucket
32), evaluates with the task's GLUE metrics (MNLI: matched and mismatched)
and, with ``do_predict``, writes the GLUE server's TSV files (MNLI: two).
``metrics.jsonl`` and the run group go into ``<output_dir>/<task>``.  It
runs on the card; ``--platform=cpu`` runs it on the CPU, on the kernels'
plain versions.

Adapters: Monarch (``--monarch``, the default; the peft config's
``adapter: false`` is projection mode and ``svd_init`` the SVD
initialisation, ``layers/monarch_linear.py``), BOFT (``--boft``, the
``boft_roberta_glue`` recipes; a task's ``oft_dropout`` sets the peft
config's ``boft_dropout``) or LoRA (``--lora``, the ``lora_roberta_glue``
recipe).  ``--boft`` and ``--lora`` win over ``--monarch``.  Here the JAX
harness differs: its ``--lora`` builds LoRA only with ``--monarch=False``,
and alone adapts nothing (the LoRA recipe's ``monarch: false`` makes its
Monarch surgery a no-op; ROADMAP C.15).

``--do_tune`` runs the ASHA search of ``training/hpo.py`` over the method's
space (``build_search_space``: Monarch a quantised lr and the batch size,
blk_r and nblocks pinned or, with ``--tune_blk_config``, searched; BOFT the
lr; otherwise the reference's lr x batch grid) within the task's budget
(``task_configs/hpo_budgets.json``), each trial in ``trial_<id>/`` of the
task's directory and resumed there at each rung; the best hyperparameters
go to ``best_hyperparams.json`` (and beside the recipe with
``--as_base_hp``), and the final run trains with them.  ``--tune_grace``
sets the first rung's epochs; 0 is taken as 0 (the JAX harness reads 0 as
unset, ROADMAP C.5).  ``--parallel_trials`` > 1 runs trials on threads,
each pinned to one of the host's cards.

``main`` and ``run`` take ``build``, a callable ``(args, data_args,
peft_config, num_labels, seed) -> model`` in place of ``build_model``; ``run``
also takes ``step_context``, the ``Trainer``'s hook around each step, and
returns a ``GlueRun`` with the trained model's trainer, the tokenized
splits and the search's result.  Tests and ``chip_smoke.py`` pass them;
they are not flags.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
from typing import Callable, Optional

import torch

from sparse_matrix_fine_tuning_torch.data.glue import TASK_NUM_LABELS, load_glue_raw, tokenize_glue
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer, get_tokenizer
from sparse_matrix_fine_tuning_torch.evaluation.predict import predict_classes
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.deberta import (
    DebertaV2Config,
    DebertaV2ForSequenceClassification,
)
from sparse_matrix_fine_tuning_torch.models.hf_convert import (
    from_pretrained_deberta,
    from_pretrained_roberta,
)
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft.boft import init_boft
from sparse_matrix_fine_tuning_torch.peft.surgery import init_lora, init_monarch, param_stats
from sparse_matrix_fine_tuning_torch.training.hpo import (
    choice,
    grid,
    hyperparameter_search,
    quniform,
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
from sparse_matrix_fine_tuning_torch.utils.logging import (
    RunLogger,
    get_run_group,
    persist_run_group,
    watch_layers,
)
from sparse_matrix_fine_tuning_torch.utils.metrics import GLUE_TARGET_METRIC, glue_compute

SMOKE_VOCAB = 1024  # the smoke tokenizer's and model's vocabulary
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
                "target_modules": ["query", "value", "key"]}
# GLUE leaderboard submission file names (reference run_glue.py:106-117)
TASK_TO_SUBMIT = {"cola": "CoLA", "sst2": "SST-2", "mrpc": "MRPC", "qqp": "QQP",
                  "stsb": "STS-B", "mnli": "MNLI-m", "mnli-mm": "MNLI-mm",
                  "qnli": "QNLI", "rte": "RTE", "wnli": "WNLI"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run GLUE (MoRe, PyTorch port)")
    p.add_argument("config_path", help="task config JSON path")
    p.add_argument("--monarch", default=True, type=eval)
    p.add_argument("--lora", default=False, type=eval, help="the LoRA baseline")
    p.add_argument("--boft", default=False, type=eval, help="the BOFT baseline")
    p.add_argument("--do_tune", default=False, type=eval, help="ASHA hyperparameter search")
    p.add_argument("--n_trials", default=None, type=int,
                   help="HPO trials; default the method's budget (monarch 25, BOFT 15; "
                        "full fine-tuning runs its fixed grid); an explicit value wins")
    p.add_argument("--parallel_trials", default=1, type=int,
                   help="concurrent trials a rung, each on a card of its own")
    p.add_argument("--smoke", default=False, type=eval,
                   help="synthetic data + tiny model (no pretrained weights)")
    p.add_argument("--tune_blk_config", default=False, type=eval,
                   help="also search blk_r and blk_sz (Monarch)")
    p.add_argument("--tune_lr_scale", default=1.0, type=float,
                   help="multiply the HPO lr bounds (1.0: the reference's space)")
    p.add_argument("--tune_grace", default=None, type=float,
                   help="the first rung's epochs in place of the task's ASHA grace "
                        "(0 is taken as 0)")
    p.add_argument("--as_base_hp", default=False, type=eval,
                   help="also write the best hyperparameters beside the recipe")
    p.add_argument("--resume", default=False, type=eval,
                   help="go on from the newest checkpoint in the output directory")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the training run, into "
                        "<output_dir>/<task>/profile")
    p.add_argument("--bf16_compute", default=False, type=eval)
    p.add_argument("--wandb", default=True, type=eval,
                   help="mirror metrics to wandb where WANDB_API_KEY is set "
                        "(metrics.jsonl is always written)")
    p.add_argument("--group", default="", help="extra run-group component")
    p.add_argument("--notes", default="", help="notes folded into the group")
    p.add_argument("--project", default=None, help="wandb project override")
    p.add_argument("--time", default=None,
                   help="group timestamp override (joins an existing group)")
    p.add_argument("--load_group", default=False, type=eval,
                   help="rejoin the group in output_dir/full_group.txt")
    p.add_argument("--platform", default=None, choices=[None, "cuda", "cpu"],
                   help="where to run: the card when unset")
    return p.parse_known_args(argv)


@dataclasses.dataclass
class DataArgs:
    task_name: str = "cola"
    model_name_or_path: str = "roberta-large"
    max_seq_length: int = 128
    do_predict: bool = False


def random_encoder(path: str, num_labels: int, dtype: Optional[str], smoke: bool,
                   generator: torch.Generator):
    """The JAX harness's randomly initialised encoder for ``path``: DeBERTa-v3
    base where "deberta" is in it, else RoBERTa large where "large" is, else
    RoBERTa base; their tiny configs with ``SMOKE_VOCAB`` ids under
    ``smoke``.  Built on the CPU."""
    if "deberta" in path.lower():
        cfg = (DebertaV2Config.tiny(num_labels=num_labels, dtype=dtype, vocab_size=SMOKE_VOCAB)
               if smoke else DebertaV2Config(num_labels=num_labels, dtype=dtype))
        return DebertaV2ForSequenceClassification(cfg, device="cpu", generator=generator)
    if smoke:
        cfg = RobertaConfig.tiny(num_labels=num_labels, dtype=dtype, vocab_size=SMOKE_VOCAB)
    elif "large" in path:
        cfg = RobertaConfig.large(num_labels=num_labels, dtype=dtype)
    else:
        cfg = RobertaConfig.base(num_labels=num_labels, dtype=dtype)
    return RobertaForSequenceClassification(cfg, device="cpu", generator=generator)


def adapt_model(model, args, peft_config: dict, seed: int):
    """The adapters on the peft config's targets, in place: BOFT with
    ``--boft`` (its dropout draws seeded ``seed + 1``), else LoRA with
    ``--lora``, else Monarch with ``--monarch``, their init from a generator
    seeded ``seed + 1`` on the model's device (a projection runs its SVD
    there); then ``param_stats``.  Returns the model."""
    at = next(model.parameters()).device
    if args.boft:
        adapted = init_boft(model, peft_config, generator=torch.Generator().manual_seed(seed + 1))
        print(f"[run_glue] adapted {len(adapted)} layers with BOFT")
    elif args.lora:
        adapted = init_lora(model, peft_config,
                            generator=torch.Generator(device=at).manual_seed(seed + 1))
        print(f"[run_glue] adapted {len(adapted)} layers with LoRA")
    elif args.monarch:
        adapted = init_monarch(model, peft_config,
                               generator=torch.Generator(device=at).manual_seed(seed + 1))
        for name, dense_shape, s1, s2 in adapted[:3]:
            print(f"Adapted {name} {dense_shape} -> {s1}, {s2}")
        print(f"[run_glue] adapted {len(adapted)} layers with Monarch")
    param_stats(model)
    return model


def build_model(args, data_args: DataArgs, peft_config: dict, num_labels: int, seed: int = 0):
    """The encoder of ``data_args.model_name_or_path`` on the harness's
    device, computing in bfloat16 with ``--bf16_compute``: a local HF-format
    directory loaded there (its missing head drawn from a generator seeded
    ``seed`` on that device), or ``random_encoder`` drawn on the CPU from a
    generator seeded ``seed`` and then moved, so that a seed gives one model
    on the card and on the CPU; adapted by ``adapt_model``."""
    device = harness_device(args)
    dtype = "bfloat16" if args.bf16_compute else None
    path = data_args.model_name_or_path
    if not args.smoke and os.path.isdir(path):
        load = from_pretrained_deberta if "deberta" in path.lower() else from_pretrained_roberta
        model = load(path, num_labels=num_labels, dtype=dtype, device=device,
                     generator=torch.Generator(device=device).manual_seed(seed))
    else:
        if not args.smoke:
            print(f"[run_glue] no local weights at {path!r}; using random init")
        model = random_encoder(path, num_labels, dtype, args.smoke,
                               torch.Generator().manual_seed(seed))
    return adapt_model(model, args, peft_config, seed).to(device)


def glue_metrics_fn(task: str) -> Callable:
    """The trainer's ``compute_metrics``: the task's GLUE metrics of the
    model's predictions (``evaluation/predict.py``)."""
    def compute(model, data):
        return glue_compute(task, predict_classes(model, data), data["labels"])
    return compute


def glue_label_list(task: str) -> list:
    """Class index -> label string, as the GLUE server pins them
    (``task_configs/labels.json``)."""
    with open(os.path.join(REPO, "task_configs", "labels.json")) as f:
        return json.load(f)[task]


def predict_tsv(model, data, task: str, out_dir: str, submit_task: Optional[str] = None) -> str:
    """The GLUE server's TSV of ``data``'s predictions: class indices through
    the task's label list, STS-B's scores as %3.3f, the file named as the
    leaderboard names it; returns its path."""
    is_regression = task == "stsb"
    preds = predict_classes(model, data)
    os.makedirs(out_dir, exist_ok=True)
    submit_task = submit_task or task
    label_list = None if is_regression else glue_label_list(submit_task)
    path = os.path.join(out_dir, f"{TASK_TO_SUBMIT.get(submit_task, submit_task)}.tsv")
    with open(path, "w") as f:
        f.write("index\tprediction\n")
        for i, p in enumerate(preds):
            if is_regression:
                f.write(f"{i}\t{p:3.3f}\n")
            else:
                f.write(f"{i}\t{label_list[int(p)]}\n")
    print(f"[run_glue] wrote {path}")
    return path


def predict_splits(task: str) -> list[tuple[str, str]]:
    """(split, submission task) pairs that ``do_predict`` writes; MNLI's
    matched and mismatched test splits."""
    return ([("test_matched", "mnli"), ("test_mismatched", "mnli-mm")] if task == "mnli"
            else [("test", task)])


def load_hpo_budget(task: str) -> dict:
    """The task's ASHA budget, ``{"max_t", "grace"}`` in epochs
    (``task_configs/hpo_budgets.json``: its default, then the task's)."""
    with open(os.path.join(REPO, "task_configs", "hpo_budgets.json")) as f:
        table = json.load(f)
    return {**table["default"], **table.get(task, {})}


def build_search_space(args, peft_config: dict, train_args: TrainingArgs) -> tuple[dict, int]:
    """(space, n_trials) of the method, as the JAX harness's (the reference's
    run_glue.py:595-636): BOFT a quantised lr, 15 trials; Monarch a quantised
    lr and the batch size with seed, weight decay, schedule, blk_r and
    nblocks pinned, 25 trials (``--tune_blk_config``: blk_r and blk_sz
    searched, 10 more); otherwise the lr x batch grid.  ``--tune_lr_scale``
    scales the lr bounds; ``--n_trials`` replaces the count."""
    s = args.tune_lr_scale
    if args.boft:
        return ({"seed": train_args.seed,
                 "learning_rate": quniform(8e-5 * s, 8e-4 * s, 4e-5 * s)},
                args.n_trials or 15)
    if args.monarch:
        space = {
            "seed": train_args.seed,
            "learning_rate": quniform(1e-4 * s, 6.6e-4 * s, 2e-5 * s),
            "per_device_train_batch_size": choice([16, 32]),
            "weight_decay": train_args.weight_decay,
            "lr_scheduler_type": "cosine",
            "blk_r": peft_config.get("blk_r", 4),
            "nblocks": peft_config.get("nblocks", 4),
        }
        n_trials = args.n_trials or 25
        if args.tune_blk_config:
            space["blk_r"] = choice([1, 2, 4, 8])
            space["blk_sz"] = choice([64, 128, 512])
            del space["nblocks"]  # blk_sz sets the block count
            if args.n_trials is None:
                n_trials += 10
        return space, n_trials
    return {
        "learning_rate": grid([1e-5, 2e-5, 3e-5]),
        "per_device_train_batch_size": grid([16, 32]),
        "weight_decay": 0.1,
        "lr_scheduler_type": grid(["cosine"]),
    }, args.n_trials or 1


@dataclasses.dataclass
class GlueRun:
    """What ``run`` leaves: the results ``main`` returns, the trained model's
    trainer, the tokenized splits, the TSV files written and, with
    ``--do_tune``, the search's result (``training/hpo.py``)."""
    args: argparse.Namespace
    results: dict
    trainer: Trainer
    data: dict
    tsv_paths: list
    search: Optional[dict] = None


def run(argv=None, *, build: Optional[Callable] = None,
        step_context: Optional[Callable] = None) -> GlueRun:
    args, overrides = parse_args(argv)
    device = harness_device(args)
    task_cfg = load_json(args.config_path)
    cfg_dir = os.path.dirname(args.config_path)
    peft_path = os.path.join(cfg_dir, "peft_config.json")
    peft_config = load_json(peft_path) if os.path.exists(peft_path) else dict(DEFAULT_PEFT)

    data_args = DataArgs(
        task_name=task_cfg.get("task_name", "cola"),
        model_name_or_path=task_cfg.get("model_name_or_path", "roberta-large"),
        max_seq_length=task_cfg.get("max_seq_length", 128),
        do_predict=task_cfg.get("do_predict", False))
    train_args = TrainingArgs(
        output_dir=task_cfg.get("output_dir", "results/glue"),
        learning_rate=task_cfg.get("learning_rate", 3e-5),
        num_train_epochs=task_cfg.get("num_train_epochs", 3),
        per_device_train_batch_size=task_cfg.get("per_device_train_batch_size", 16),
        weight_decay=task_cfg.get("weight_decay", 0.0),
        warmup_ratio=task_cfg.get("warmup_ratio", 0.06),
        lr_scheduler_type=task_cfg.get("lr_scheduler_type", "linear"),
        logging_steps=task_cfg.get("logging_steps", 100),
        eval_steps=task_cfg.get("eval_steps", 0),
        save_steps=task_cfg.get("save_steps", 0),
        save_total_limit=task_cfg.get("save_total_limit", 1),
        load_best_model_at_end=task_cfg.get("load_best_model_at_end", False),
        # GLUE sentences are short but pad to max_seq_length: batches trimmed
        # to their longest row, rounded up to the bucket
        group_by_length=task_cfg.get("group_by_length", True),
        length_bucket=task_cfg.get("length_bucket", 32),
        seed=task_cfg.get("seed", 42))
    extra = override_config([data_args, train_args, peft_config], overrides)
    if extra:
        print(f"[run_glue] unmatched overrides: {extra}")
    if "oft_dropout" in task_cfg:
        # a BOFT task's dropout replaces the family's peft config value
        # (reference run_glue.py:414)
        peft_config["boft_dropout"] = task_cfg["oft_dropout"]
    task = data_args.task_name
    train_args.output_dir = os.path.join(train_args.output_dir, task)
    train_args.metric_for_best_model = GLUE_TARGET_METRIC[task]
    train_args.greater_is_better = True
    train_args.use_scaler = bool(peft_config.get("scaler", False))
    train_args.large_lr = bool(peft_config.get("large_lr", False))
    train_args.new_lr = float(peft_config.get("new_lr", 5e-3))

    num_labels = TASK_NUM_LABELS[task]
    tokenizer = (SimpleTokenizer(vocab_size=SMOKE_VOCAB) if args.smoke
                 else get_tokenizer(data_args.model_name_or_path))
    raw = load_glue_raw(task, smoke=args.smoke)
    data = tokenize_glue(task, raw, tokenizer, data_args.max_seq_length)
    val_key = "validation_matched" if task == "mnli" else "validation"
    run_group = persist_run_group(
        train_args.output_dir,
        get_run_group(task_name=task, do_tune=args.do_tune, group=args.group,
                      cur_time=args.time, notes=args.notes or None),
        resume=args.resume or args.load_group)

    def make_trainer(hp=None, epochs=None, logger=None):
        ta = dataclasses.replace(train_args)
        pc = dict(peft_config)
        if hp:
            override_config([ta, pc], hp)
        if epochs is not None:
            ta.num_train_epochs = epochs
        model = (build or build_model)(args, data_args, pc, num_labels, ta.seed)
        return Trainer(model, ta, train_data=data["train"], eval_data=data[val_key],
                       compute_metrics=glue_metrics_fn(task), logger=logger, device=device,
                       step_context=step_context)

    search = None
    if args.do_tune:
        space, n_trials = build_search_space(args, peft_config, train_args)
        budget = load_hpo_budget(task)
        max_ep = min(float(budget["max_t"]), float(train_args.num_train_epochs))
        grace = budget["grace"] if args.tune_grace is None else args.tune_grace
        min_ep = min(float(grace), max_ep)

        def run_trial(hp, epochs, trial_id):
            # a trial's directory, resumed at each rung: a survivor's next
            # budget goes on from its last checkpoint
            hp = dict(hp, output_dir=os.path.join(train_args.output_dir, f"trial_{trial_id}"))
            t = make_trainer(hp, epochs)
            t.train(resume=True)
            return t.evaluate()

        os.makedirs(train_args.output_dir, exist_ok=True)
        search = hyperparameter_search(
            run_trial, space, n_trials=n_trials, target_metric=f"eval_{GLUE_TARGET_METRIC[task]}",
            mode="max", min_epochs=min_ep, max_epochs=max_ep, parallel_trials=args.parallel_trials,
            devices=trial_devices(args.parallel_trials, device),
            state_path=(os.path.join(train_args.output_dir, "hpo_state.jsonl")
                        if args.resume else None))
        hp = search["best_hyperparams"]
        save_best_hp(hp, train_args.output_dir, cfg_dir if args.as_base_hp else None)
        print(json.dumps({"best_hyperparams": hp, "best_metric": search["best_metric"]}))
    else:
        hp = load_best_hp(train_args.output_dir, cfg_dir)
    logger = RunLogger(train_args.output_dir, group=run_group, name=f"{task}_final",
                       project=args.project, use_wandb=args.wandb,
                       config={"task": task, "peft_config": peft_config, "hp": hp or {}})
    try:
        trainer = make_trainer(hp, logger=logger)
        watch_layers(trainer.model, logger)
        profile = (profiling.trace(os.path.join(train_args.output_dir, "profile"))
                   if args.profile else contextlib.nullcontext())
        with profile:
            metrics = trainer.train(resume=args.resume)
        logger.log({"step": trainer.step, **metrics})
        watch_layers(trainer.model, logger)
    finally:
        logger.finish()
    results = {task: metrics}
    if task == "mnli" and "validation_mismatched" in data:
        results["mnli-mm"] = trainer.evaluate(data["validation_mismatched"])
    tsv_paths = []
    if data_args.do_predict:
        for test_key, submit_task in predict_splits(task):
            if test_key in data:
                tsv_paths.append(predict_tsv(trainer.model, data[test_key], task,
                                             os.path.join(train_args.output_dir, "predict"),
                                             submit_task=submit_task))
    print(json.dumps(results))
    return GlueRun(args, results, trainer, data, tsv_paths, search)


def main(argv=None, *, build: Optional[Callable] = None) -> dict:
    """Run the harness; returns the results it prints last:
    ``{task: metrics}``, and for MNLI ``"mnli-mm"``'s too."""
    return run(argv, build=build).results


if __name__ == "__main__":
    main()
