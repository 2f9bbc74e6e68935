"""AG News classification, Monarch adapters against LoRA and full fine-tuning:
``python -m sparse_matrix_fine_tuning_torch.scripts.run_agnews --method monarch|lora|full [flags]``.

Counterpart of the JAX harness ``run_agnews.py`` at the repository's root
(the reference's agnews_train_scripts): RoBERTa-base on 4-way news topics,
with its flags and defaults.  The data come from HF ``datasets``' local
cache only (``data/glue.load_dataset_offline``), else the synthetic topic
items (``--smoke`` uses them, the hash tokenizer's 1024 ids and the tiny
RoBERTa).  ``--method monarch`` puts adapters on query/key/value and trains
them and the head; ``lora`` LoRA of rank 8 on query and value (the JAX
harness's ``init_lora`` config), with the head; ``full`` trains every
parameter.  Length grouping (bucket 32) and a cosine schedule, as there.  It
runs on the card; ``--platform=cpu`` runs it on the CPU.

``main`` and ``run`` take ``build``, a callable ``(args) -> model`` (adapted
for the method) in place of ``build_model``; ``run`` also takes
``step_context`` and returns the trainer beside the result.  Tests and
``chip_smoke.py`` pass them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch.data.glue import load_dataset_offline
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer, get_tokenizer
from sparse_matrix_fine_tuning_torch.evaluation.predict import predict_classes
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.hf_convert import from_pretrained_roberta
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft.surgery import init_lora, init_monarch, param_stats
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer, TrainingArgs
from sparse_matrix_fine_tuning_torch.utils.device import harness_device
from sparse_matrix_fine_tuning_torch.utils.logging import RunLogger, get_run_group, watch_layers
from sparse_matrix_fine_tuning_torch.utils.metrics import accuracy

SMOKE_VOCAB = 1024
MONARCH_PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
                "target_modules": ["query", "value", "key"]}
LORA_PEFT = {"target_modules": ["query", "value"], "r": 8}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AG News (MoRe, PyTorch port)")
    p.add_argument("--method", default="monarch", choices=["monarch", "lora", "full"])
    p.add_argument("--model", default="roberta-base")
    p.add_argument("--smoke", default=False, type=eval)
    p.add_argument("-e", "--epochs", default=2.0, type=float)
    p.add_argument("-lr", "--lr", default=1e-4, type=float)
    p.add_argument("-batch_size", "--batch_size", default=32, type=int)
    p.add_argument("--max_seq_length", default=128, type=int)
    p.add_argument("--output_dir", default="results/agnews")
    p.add_argument("--logging_steps", default=50, type=int)
    p.add_argument("--platform", default=None, choices=[None, "cuda", "cpu"],
                   help="where to run: the card when unset")
    return p.parse_known_args(argv)


def load_agnews(tokenizer, max_seq_length: int, smoke: bool = False, smoke_n: int = 256) -> dict:
    """The 4-class news topic splits (train, test), tokenized; synthetic
    items with topic marker words without a local copy (the JAX function's,
    bit for bit)."""
    if not smoke:
        try:
            raw = load_dataset_offline("ag_news")
            out = {}
            for split in ("train", "test"):
                ids, mask = tokenizer.encode_batch(raw[split]["text"],
                                                   max_length=max_seq_length)
                out[split] = {"input_ids": ids, "attention_mask": mask,
                              "labels": np.asarray(raw[split]["label"], np.int32)}
            return out
        except Exception as e:
            print(f"[agnews] synthetic fallback ({type(e).__name__})")
    topics = ["world politics nations", "sports game team", "business market stock",
              "science tech computer"]
    rng = np.random.default_rng(0)
    out = {}
    for split, n in (("train", smoke_n), ("test", max(smoke_n // 4, 32))):
        texts, labels = [], []
        for _ in range(n):
            y = int(rng.integers(0, 4))
            filler = " ".join(str(x) for x in rng.integers(0, 50, 5))
            texts.append(topics[y] + " " + filler)
            labels.append(y)
        ids, mask = tokenizer.encode_batch(texts, max_length=max_seq_length)
        out[split] = {"input_ids": ids, "attention_mask": mask,
                      "labels": np.asarray(labels, np.int32)}
    return out


def extra_paths(args) -> tuple:
    """The paths that train beside the adapters: every parameter for ``full``."""
    return ("__all__",) if args.method == "full" else ("classifier",)


def build_model(args):
    """The tiny RoBERTa with ``--smoke``, a local HF-format ``--model``
    directory, else RoBERTa-base randomly initialised; 4 labels, drawn on
    the CPU from a generator seeded 0 (a directory loads on the device), then
    Monarch adapters for ``--method monarch`` or LoRA for ``lora`` from a
    generator seeded 1 on the model's device; on the harness's device."""
    device = harness_device(args)
    if args.smoke:
        model = RobertaForSequenceClassification(
            RobertaConfig.tiny(num_labels=4, vocab_size=SMOKE_VOCAB), device="cpu",
            generator=torch.Generator().manual_seed(0))
    elif os.path.isdir(args.model):
        model = from_pretrained_roberta(args.model, num_labels=4, device=device,
                                        generator=torch.Generator(device=device).manual_seed(0))
    else:
        model = RobertaForSequenceClassification(
            RobertaConfig.base(num_labels=4), device="cpu",
            generator=torch.Generator().manual_seed(0))
    at = next(model.parameters()).device
    if args.method == "monarch":
        init_monarch(model, MONARCH_PEFT, generator=torch.Generator(device=at).manual_seed(1))
    elif args.method == "lora":
        init_lora(model, LORA_PEFT, generator=torch.Generator(device=at).manual_seed(1))
    return model.to(device)


@dataclasses.dataclass
class AgnewsRun:
    """What ``run`` leaves: the result ``main`` returns and the trainer."""
    args: argparse.Namespace
    result: dict
    trainer: Trainer


def run(argv=None, *, build: Optional[Callable] = None,
        step_context: Optional[Callable] = None) -> AgnewsRun:
    args, _ = parse_args(argv)
    device = harness_device(args)
    tokenizer = (SimpleTokenizer(vocab_size=SMOKE_VOCAB) if args.smoke
                 else get_tokenizer(args.model))
    data = load_agnews(tokenizer, args.max_seq_length, smoke=args.smoke)
    model = (build or build_model)(args)
    paths = extra_paths(args)
    total, trainable = param_stats(model, extra_paths=paths)

    def compute_metrics(model, data):
        return {"accuracy": accuracy(predict_classes(model, data), data["labels"])}

    ta = TrainingArgs(
        output_dir=os.path.join(args.output_dir, args.method),
        learning_rate=args.lr, num_train_epochs=args.epochs,
        per_device_train_batch_size=args.batch_size,
        logging_steps=args.logging_steps, log_param_steps=0,
        lr_scheduler_type="cosine",
        # headlines vary widely in length: batches trimmed to their longest
        # row, rounded up to the bucket
        group_by_length=True, length_bucket=32)
    logger = RunLogger(ta.output_dir, group=get_run_group(task_name="agnews"),
                       name=f"agnews_{args.method}", config={"method": args.method})
    try:
        trainer = Trainer(model, ta, train_data=data["train"], eval_data=data["test"],
                          compute_metrics=compute_metrics, extra_trainable_paths=paths,
                          logger=logger, device=device, step_context=step_context)
        if args.method != "full":
            watch_layers(trainer.model, logger)
        metrics = trainer.train()
        logger.log({"step": trainer.step, **metrics})
    finally:
        logger.finish()
    result = {"method": args.method, "trainable_params": int(trainable),
              "total_params": int(total), **metrics}
    print(json.dumps(result))
    return AgnewsRun(args, result, trainer)


def main(argv=None, *, build: Optional[Callable] = None) -> dict:
    """Run the harness; returns the result it prints last."""
    return run(argv, build=build).result


if __name__ == "__main__":
    main()
