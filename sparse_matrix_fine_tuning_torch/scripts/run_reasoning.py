"""Reasoning and instruction fine-tuning (commonsense, math, gsm8k, alpaca,
instruct, ultrafeedback) with generation-based evaluation:
``python -m sparse_matrix_fine_tuning_torch.scripts.run_reasoning [flags]``.

Counterpart of the JAX harness ``run_reasoning.py`` at the repository's root
(the reference's pyreft/loreft/train.py, driven by reasoning_scripts/
{math,common_sense}_monarch.sh): the same flags and defaults.  It builds a
causal LM of any family the port has (Llama, Mistral, Qwen2, Gemma, GPT-2,
GPT-Neo, GPT-NeoX, Backpack-GPT-2) from a local HF-format directory
(``--model <dir>``, through ``models/hf_convert.from_pretrained_causal_lm``
in bfloat16, with ``--gradient_checkpointing`` and ``--remat_policy``, which
the GPT families ignore) or the JAX harness's tiny random Llama, puts
Monarch adapters on the peft config's projections, trains with the masked
causal-LM loss through the port's ``Trainer`` (``--pack`` bin-packs the
rows), then scores each eval dataset of the task by generation, greedy or
with the task's other ``generation_args`` (beam 4, sampling, penalties and
n-gram bans).  It writes ``eval_results.json``, ``generations.json`` and
``metrics.jsonl`` into ``<output_dir>/<task>``.  It runs on the card; ``--platform=cpu``
runs it on the CPU, on the kernels' plain versions.

Without ``--smoke`` the hash tokenizer has 32000 ids and the tiny model as
many (the JAX harness keeps 1024 in its model and feeds it the larger ids:
ROADMAP.md C.12).  A directory whose ``tokenizer.json`` holds a BPE model
is tokenized by it (``data/tokenizer.get_tokenizer``, pure Python); one with
another HF tokenizer (WordPiece, Unigram, ``tokenizer.model``) is refused
(ROADMAP.md queue A item 13).  The task's non-greedy math and
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

ReFT (``--intervention_type`` other than Nothing): the Monarch-adapted
Llama is wrapped in ``interventions.ReftModel`` with one intervention a
layer of ``-l`` (all, or "3;9;18"), doubled for untied ``f+l`` positions,
of rank ``-rank`` and with ``--dropout``; each training row and eval prompt
carries its ``intervention_locations``, the loss is the intervened
forward's, and the eval generates with the interventions on each prompt.
The number of interventions comes from the checkpoint's layer count.
``--pack`` with an intervention exits before any work, as the JAX harness
does.

``--task glue`` is MoReFT classification (the reference's
reasoning_scripts/moreft_glue.sh): a RoBERTa (``--model <dir>``, or the
JAX harness's tiny one) wrapped in ``ReftModel`` (MoReIntervention where
the type is Nothing; no Monarch surgery: the interventions are the
adapter), trained on ``-train_dataset`` (cola) with the interventions' and,
with ``--allow_cls_grad``, the classifier's parameters, then scored on the
validation split; it writes ``metrics.json`` into
``<output_dir>/glue_<dataset>``.  Its ``build`` seam is ``(args,
num_labels, vocab_size) -> ReftModel``.

``--mesh_fsdp N`` trains over an fsdp mesh of the launched world's N ranks
(``torchrun --nproc_per_node N -m
sparse_matrix_fine_tuning_torch.scripts.run_reasoning ... --mesh_fsdp N``;
``parallel/``): the frozen base FSDP2-sharded, each rank on its data rank's
rows of the training split (``multihost.shard_data_for_process``), then
evaluates by generating on the sharded model (every rank the whole eval
set); only rank 0 writes the results, the generations, the metrics log and
the checkpoints.  Refused before any work: an N other than the world size,
and, under a mesh, ``--do_tune`` and ``--task glue`` (ROADMAP.md queue A
item 28b).
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
from sparse_matrix_fine_tuning_torch.data.glue import TASK_NUM_LABELS, load_glue_raw
from sparse_matrix_fine_tuning_torch.data.reasoning import (
    TASK_CONFIG,
    load_data_items,
    tokenize_glue_reft,
    tokenize_reasoning,
)
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer, get_tokenizer
from sparse_matrix_fine_tuning_torch.evaluation.predict import predict_classes
from sparse_matrix_fine_tuning_torch.evaluation.reasoning import compute_reasoning_metrics
from sparse_matrix_fine_tuning_torch.interventions.reft import ReftConfig, get_reft_model
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig, RobertaConfig
from sparse_matrix_fine_tuning_torch.models.gpt2 import GPT2LMHeadModel
from sparse_matrix_fine_tuning_torch.models.hf_convert import (
    from_pretrained_causal_lm,
    from_pretrained_roberta,
)
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.parallel import make_mesh, multihost
from sparse_matrix_fine_tuning_torch.parallel.sharding import ITEM_28B
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
from sparse_matrix_fine_tuning_torch.utils.metrics import GLUE_TARGET_METRIC, glue_compute

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
                   help="ReFT intervention: Nothing | LoreftIntervention | NoreftIntervention | "
                        "ConsreftIntervention | MoReIntervention")
    p.add_argument("-l", "--layers", default="all",
                   help="intervention layers: 'all' or semicolon ints, e.g. 3;9;18")
    p.add_argument("-rank", "--rank", default=4, type=int,
                   help="intervention low-rank dimension")
    p.add_argument("-sw", "--share_weights", nargs="?", const=True, default=False, type=eval,
                   help="tie the first-n and last-n position interventions (False doubles "
                        "the intervention count for f+l)")
    p.add_argument("-train_dataset", "--train_dataset", default=None,
                   help="override the task's default train dataset")
    p.add_argument("-eval_dataset", "--eval_dataset", default=None,
                   help="restrict eval to one dataset (default: all of the task's)")
    p.add_argument("-test_split", "--test_split", default="test")
    p.add_argument("-allow_cls_grad", "--allow_cls_grad", action="store_true",
                   help="glue task: the classification head trains too")
    p.add_argument("--metric_for_best_model", default=None,
                   help="glue task: the reported target metric (default: the task's GLUE "
                        "metric)")
    p.add_argument("-t", "--temperature", default=None, type=float)
    p.add_argument("-top_p", "--top_p", default=None, type=float)
    p.add_argument("-top_k", "--top_k", default=None, type=int)
    p.add_argument("--max_steps", default=-1, type=int)
    p.add_argument("--all_linear", default=True, type=eval)
    p.add_argument("--pack", default=False, type=eval,
                   help="sequence packing of training rows (segment-masked attention; not "
                        "with an intervention)")
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
                   help="FSDP-shard the frozen base over the launched world's N ranks "
                        "(torchrun --nproc_per_node N)")
    return p.parse_known_args(argv)


# tasks scored by generation dumps, with no exact match to tune on
OPEN_ENDED = ("alpaca", "instruct", "ultrafeedback")


def uses_reft(args) -> bool:
    return args.intervention_type not in NO_INTERVENTION


def world_size() -> int:
    """The launched world's size: the process group's, else torchrun's
    ``WORLD_SIZE`` (1 when unset)."""
    if multihost.process_count() > 1:
        return multihost.process_count()
    return int(os.environ.get("WORLD_SIZE", 1))


def check_supported(args) -> None:
    """Refuse ``--mesh_fsdp`` other than the world size (``ValueError``), and
    under a mesh ``--do_tune`` and ``--task glue`` (``NotImplementedError``,
    ROADMAP.md queue A item 28b); exit, as the JAX harness does, for
    ``--pack`` with an intervention and ``--do_tune`` on an open-ended
    task."""
    if args.mesh_fsdp:
        world = world_size()
        if args.mesh_fsdp != world:
            raise ValueError(
                f"run_reasoning: --mesh_fsdp {args.mesh_fsdp} shards over that many ranks, one "
                f"process a card, but this world has {world}: launch it with torchrun "
                f"--nproc_per_node {args.mesh_fsdp} -m "
                "sparse_matrix_fine_tuning_torch.scripts.run_reasoning ... "
                f"--mesh_fsdp {args.mesh_fsdp}")
        if args.do_tune or args.task == "glue":
            raise NotImplementedError(
                f"run_reasoning: --mesh_fsdp with {'--do_tune' if args.do_tune else '--task glue'}"
                f": {ITEM_28B}")
    if args.pack and uses_reft(args) and args.task != "glue":
        raise SystemExit("--pack is incompatible with ReFT interventions (position "
                         "bookkeeping assumes unpacked rows); use --intervention_type Nothing")
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


def model_layers(args) -> int:
    """The layer count of the model ``build_model`` gives: the checkpoint's
    (``num_hidden_layers``, GPT-2's ``n_layer`` or GPT-Neo's ``num_layers``;
    the JAX harness reads the first alone, ROADMAP.md C.19), or the tiny
    model's 2."""
    if local_weights(args):
        with open(os.path.join(args.model, "config.json")) as f:
            hf = json.load(f)
        return next(hf[k] for k in ("num_hidden_layers", "n_layer", "num_layers") if k in hf)
    return 2


def build_reft_reps(args, n_model_layers: int, intervention_type: str) -> tuple[list, list]:
    """(layers, representations) of the ReFT wrapper: ``-l``'s layers,
    doubled for untied ``f+l`` positions (reference loreft/train.py:304-305;
    the locations list the first-n half then the last-n half), each with
    ``-rank`` and the dropout (reference train.py:147, 166)."""
    layers = (list(range(n_model_layers)) if args.layers == "all"
              else [int(x) for x in str(args.layers).split(";")])
    if "+" in args.position and not args.share_weights:
        layers = layers + layers
    reps = [{"layer": layer, "component": "block_output", "intervention": intervention_type,
             "low_rank_dimension": args.rank, "dropout": args.dropout or 0.0}
            for layer in layers]
    return layers, reps


def wrap_reft(model, args, intervention_type: str):
    """``model`` in a ``ReftModel`` of ``build_reft_reps``, the
    interventions drawn on the CPU from a generator seeded ``seed + 2``."""
    layers, reps = build_reft_reps(args, model.config.num_hidden_layers, intervention_type)
    model = get_reft_model(model, ReftConfig(representations=reps),
                           generator=torch.Generator().manual_seed(args.seed + 2))
    print(f"[reasoning] ReFT {intervention_type} on layers {layers}")
    return model


def build_model(args, peft_config: dict, dtype: str = "bfloat16"):
    """The checkpoint of ``--model <dir>`` in ``dtype`` (the JAX harness's
    bfloat16; ``chip_smoke.py`` passes float32 to hold the card to the CPU)
    on the harness's device, remat as ``--gradient_checkpointing`` and ``--remat_policy``
    say; else the JAX harness's tiny random Llama, drawn on the CPU from a
    generator seeded ``seed`` (with ``SMOKE_VOCAB`` ids under ``--smoke``,
    else ``HASH_VOCAB``).  Monarch adapters go on the peft config's targets,
    the Llama's seven names whatever the family (with ``--all_linear=False``
    the attention projections: GPT-2's ``c_attn``, else the Llama's four),
    as the JAX harness chooses them (ROADMAP.md C.18), their factors drawn
    on the CPU from a generator seeded ``seed + 1`` (a card's run gets the
    CPU run's); with an intervention, wrapped by ``wrap_reft``."""
    device = harness_device(args)
    if local_weights(args):
        model = from_pretrained_causal_lm(args.model, dtype=dtype, device=device,
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
        # GPT-2's fused c_attn; every other family, Backpack's included, is
        # given the Llama's names, as in the JAX harness (ROADMAP.md C.18)
        peft_config = dict(peft_config, target_modules=(
            ["c_attn"] if isinstance(model, GPT2LMHeadModel) else ATTENTION_TARGETS))
    # a CPU generator: a checkpoint loaded on the card gets the CPU run's factors
    adapted = init_monarch(model, peft_config,
                           generator=torch.Generator().manual_seed(args.seed + 1))
    print(f"[reasoning] adapted {len(adapted)} layers with Monarch")
    if args.loss_chunk:
        model.config = dataclasses.replace(model.config, loss_chunk=args.loss_chunk)
    if uses_reft(args):
        model = wrap_reft(model, args, args.intervention_type)
    param_stats(model)
    return model.to(device)


def glue_intervention_type(args) -> str:
    """MoReFT GLUE's intervention: MoReIntervention where the type is
    Nothing (the interventions carry the adaptation)."""
    return "MoReIntervention" if not uses_reft(args) else args.intervention_type


def build_glue_model(args, num_labels: int, vocab_size: int):
    """MoReFT GLUE's model on the harness's device: the RoBERTa of
    ``--model <dir>`` (float32), or the JAX harness's tiny one with the
    tokenizer's vocabulary, drawn on the CPU from a generator seeded
    ``seed``; wrapped by ``wrap_reft``."""
    device = harness_device(args)
    if local_weights(args):
        model = from_pretrained_roberta(args.model, num_labels=num_labels, device=device,
                                        generator=torch.Generator(device=device)
                                        .manual_seed(args.seed))
    else:
        if not args.smoke:
            print(f"[moreft-glue] no local weights at {args.model!r}; random tiny init")
        model = RobertaForSequenceClassification(
            RobertaConfig.tiny(num_labels=num_labels, vocab_size=vocab_size), device="cpu",
            generator=torch.Generator().manual_seed(args.seed))
    model = wrap_reft(model, args, glue_intervention_type(args))
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


def moreft_glue_run(args, *, build: Optional[Callable] = None,
                    step_context: Optional[Callable] = None) -> ReasoningRun:
    """MoReFT GLUE (the JAX ``moreft_glue_main``): see the module docstring.
    Its ``evaluate()`` predicts the validation split again and returns its
    metrics."""
    device = harness_device(args)
    task = args.train_dataset or "cola"
    out_dir = os.path.join(args.output_dir, f"glue_{task}")
    num_labels = TASK_NUM_LABELS[task]
    tokenizer = SimpleTokenizer(vocab_size=SMOKE_VOCAB) if args.smoke \
        else get_tokenizer(args.model, vocab_size=50265)
    model = (build or build_glue_model)(args, num_labels, tokenizer.vocab_size)
    data = tokenize_glue_reft(task, load_glue_raw(task, smoke=args.smoke), tokenizer,
                              position=args.position,
                              num_interventions=len(model.interventions),
                              share_weights=args.share_weights, max_seq_length=args.max_length)
    # MNLI names its splits validation_matched/mismatched
    eval_split = "validation_matched" if task == "mnli" else "validation"
    val = data.get(eval_split if eval_split in data else args.test_split)

    def cls_loss(model, batch, train):
        logits = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                       intervention_locations=batch["intervention_locations"])
        return model.loss(logits, batch["labels"], weights=batch.get("_valid"))

    ta = TrainingArgs(
        output_dir=out_dir, learning_rate=args.lr, num_train_epochs=args.epochs,
        per_device_train_batch_size=args.batch_size,
        per_device_eval_batch_size=args.eval_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        lr_scheduler_type=args.schedule, logging_steps=args.logging_steps,
        max_steps=args.max_steps, log_param_steps=0, seed=args.seed)
    trainer = Trainer(model, ta, train_data=data["train"], loss_fn=cls_loss,
                      extra_trainable_paths=("classifier",) if args.allow_cls_grad else (),
                      device=device, step_context=step_context)
    trainer.train()

    def evaluate(**_) -> dict:
        if val is None:
            return {}
        preds = predict_classes(trainer.model, val, batch_size=args.eval_batch_size,
                                locations=val["intervention_locations"])
        return glue_compute(task, preds, np.asarray(val["labels"]))

    metrics = evaluate()
    if metrics:
        target = args.metric_for_best_model or GLUE_TARGET_METRIC[task]
        print(json.dumps({f"eval_{k}": round(float(v), 5) for k, v in metrics.items()}
                         | {"target": target}))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    return ReasoningRun(args, metrics, trainer, tokenizer, evaluate)


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
    if args.task == "glue":
        return moreft_glue_run(args, build=build, step_context=step_context)

    task = args.task
    tcfg = TASK_CONFIG[task]
    out_dir = os.path.join(args.output_dir, task)
    tokenizer = SimpleTokenizer(vocab_size=SMOKE_VOCAB) if args.smoke \
        else get_tokenizer(args.model, vocab_size=HASH_VOCAB)

    # interventions an example: one a layer, doubled for untied f+l
    # positions; one (unread) without an intervention, as the JAX harness
    use_reft = uses_reft(args)
    n_locs = model_layers(args) if args.layers == "all" else len(str(args.layers).split(";"))
    if "+" in args.position and not args.share_weights:
        n_locs *= 2
    tok_kw = dict(position=args.position, share_weights=args.share_weights,
                  num_interventions=n_locs if use_reft else 1)
    train_items = load_data_items(
        task, args.train_dataset or tcfg["train_datasets"][0], args.data_dir, split="train",
        max_n_example=args.max_n_train_example, seed=args.seed, smoke=args.smoke)
    train_data = tokenize_reasoning(task, train_items, tokenizer, max_length=args.max_length,
                                    split="train", **tok_kw)
    keep = ("input_ids", "attention_mask", "labels") + (
        ("intervention_locations",) if use_reft else ())
    train_data = {k: v for k, v in train_data.items() if k in keep}
    if args.pack:
        n_before = len(train_data["input_ids"])
        train_data, eff = pack_tokenized(train_data, args.max_length)
        print(f"[reasoning] packed {n_before} examples into "
              f"{len(train_data['input_ids'])} rows ({eff:.0%} token efficiency)")
    mesh = None
    if args.mesh_fsdp:
        kind = "cpu" if device.type == "cpu" else None
        multihost.initialize(device_type=kind)
        mesh = make_mesh(fsdp=args.mesh_fsdp, device_type=kind)
        train_data = multihost.shard_data_for_process(train_data, mesh=mesh)
    primary = multihost.is_primary()

    def lm_loss(model, batch, train):
        if "intervention_locations" in batch:
            # the intervened forward and the CE over its full logits
            logits = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                           intervention_locations=batch["intervention_locations"])
            return model.loss(logits, batch["labels"], weights=batch.get("_valid"))
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
                       mesh=mesh, device=device, step_context=step_context)

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
        if primary:
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
    logger = None
    if primary:
        os.makedirs(out_dir, exist_ok=True)
        logger = RunLogger(out_dir, group=get_run_group(task_name=task, do_tune=args.do_tune),
                           name=f"{task}_final", config={"task": task, "hp": hp or {}})
    try:
        trainer = make_trainer(hp, logger=logger)
        watch_layers(trainer.model, logger)
        profile = (profiling.trace(os.path.join(out_dir, "profile")) if args.profile and primary
                   else contextlib.nullcontext())
        with profile:
            trainer.train()
        results = eval_all(trainer.model, greedy=args.greedy_decoding, max_new=smoke_new)
        # the keys are already "eval/<dataset>": logged verbatim, so that
        # metrics.jsonl matches eval_results.json
        if logger is not None:
            logger.log({"step": trainer.step, **{k: v for k, v in results.items()
                                                 if isinstance(v, (int, float))}})
        watch_layers(trainer.model, logger)
    finally:
        if logger is not None:
            logger.finish()
    print(json.dumps(results))
    if primary:
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
