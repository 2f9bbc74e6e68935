"""Instruction tuning on Alpaca-style data with 5-shot MMLU evaluation:
``python -m sparse_matrix_fine_tuning_torch.scripts.run_alpaca [flags]``.

Counterpart of the JAX harness ``run_alpaca.py`` at the repository's root
(the reference's qlora harness, qlora/qlora_monarch.py:202-865): the same
flags and defaults, the same data pipeline (Alpaca items formatted,
collated with independent source/target truncation, a held-out eval split,
length-grouped micro-batches), Monarch adapters on every linear over a
frozen base that ``--bits 8|4`` quantizes (or, with ``--adapter lora``, the
qlora.py baseline: LoRA of rank 4 x blk_r on every linear, the base left
unquantized as the JAX harness leaves it), training through the port's
``Trainer``, eval loss and k-shot MMLU scoring at the A/B/C/D logits, and
continuations of the eval split with ``--do_predict`` (greedy, or with
sampling, beams, repetition penalties and n-gram bans, as the JAX harness's
``GenerationConfig`` takes them).  It runs on the card; ``--platform=cpu``
runs it on the CPU, on the kernels' plain versions.

``--model <dir>`` loads a local HF-format checkpoint of any causal family
the port has (Llama, Mistral, Qwen2, Gemma, GPT-2, GPT-Neo, GPT-NeoX,
Backpack-GPT-2) in bfloat16 through
``models/hf_convert.from_pretrained_causal_lm``, with
``--gradient_checkpointing`` and ``--remat_policy`` (ignored by the GPT
families, as in JAX); otherwise the model is the JAX harness's tiny random
Llama.  Every linear but one named ``lm_head`` is adapted, Pythia's
``embed_out`` included, as JAX's ``find_all_linear_names`` picks them.
``main`` and ``run`` take ``build``, a callable ``(args, peft_config) ->
model`` in place of ``build_model``; tests and ``chip_smoke.py`` pass it,
it is not a flag.
``run`` also takes ``step_context``, the ``Trainer``'s hook around each
training step (``chip_smoke.py`` times and profiles the run's steps with it).
``adapt_model`` is the part of ``build_model`` after the base model:
adapters, quantization and the loss settings.

Beyond the JAX harness's metrics, ``eval_mmlu_runtime`` and
``predict_runtime`` give the wall seconds of each MMLU scoring and of the
predictions (HF Trainer's ``*_runtime`` keys).

``--pack`` bin-packs the training examples into rows of ``--pack_max_len``
tokens (default source + target max len) with ``segment_ids`` (JAX
run_alpaca.py:265-275); the eval split stays unpacked.  ``--resume`` goes
on from the newest checkpoint in the output directory (``Trainer``'s
mid-epoch-exact resume).

``--do_tune`` searches the lr (log-uniform in [5e-5, 1e-3]) and blk_r (4, 8,
16) with ``training/hpo.py`` on the MMLU accuracy, each trial in
``trial_<id>/``, up to ``--epochs``; the final run trains with the best.

``--optim adamw8bit`` trains with 8-bit optimizer state
(``training/adam8bit.py``).  ``generate`` refuses beams with penalties or
n-gram bans, and beam-sample with top-k or top-p, as the JAX package does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch.data.alpaca import (
    collate_causal_lm,
    format_items,
    pack_causal_lm,
    train_eval_split,
)
from sparse_matrix_fine_tuning_torch.data.mmlu import (
    load_mmlu_items,
    mmlu_choice_logits,
    mmlu_scores,
)
from sparse_matrix_fine_tuning_torch.data.reasoning import load_data_items
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer, get_tokenizer
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
from sparse_matrix_fine_tuning_torch.models.hf_convert import from_pretrained_causal_lm
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft.surgery import (
    find_all_linear_names,
    init_lora,
    init_monarch,
    param_stats,
)
from sparse_matrix_fine_tuning_torch.quant import quantize_frozen_base, quantize_lm_head
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Alpaca + MMLU (MoRe, PyTorch port)")
    p.add_argument("-model", "--model", default="llama-2-7b")
    p.add_argument("--dataset", default="alpaca",
                   choices=["alpaca", "chip2", "self-instruct", "hh-rlhf", "oasst1"])
    p.add_argument("--dataset_format", default=None,
                   choices=[None, "alpaca", "alpaca-clean", "chip2",
                            "self-instruct", "hh-rlhf", "oasst1",
                            "input-output"])
    p.add_argument("-data_dir", "--data_dir", default="dataset")
    p.add_argument("--bits", default=16, type=int, choices=[16, 8, 4])
    p.add_argument("--quant_lm_head", default=False, type=eval,
                   help="also int8-quantize the (frozen, untied) lm_head; "
                        "OFF by default like bitsandbytes' "
                        "llm_int8_skip_modules=['lm_head'] that the "
                        "reference qlora flow inherits")
    p.add_argument("--adapter", default="monarch", choices=["monarch", "lora"],
                   help="monarch (qlora_monarch.py flow) or lora (qlora.py baseline)")
    p.add_argument("-seed", "--seed", default=42, type=int)
    p.add_argument("-e", "--epochs", default=1.0, type=float)
    p.add_argument("-lr", "--lr", default=5.4e-4, type=float)
    p.add_argument("-batch_size", "--batch_size", default=4, type=int)
    p.add_argument("-gradient_accumulation_steps", "--gradient_accumulation_steps",
                   default=16, type=int)
    p.add_argument("--source_max_len", default=1024, type=int)
    p.add_argument("--target_max_len", default=256, type=int)
    p.add_argument("--train_on_source", default=False, type=eval,
                   help="compute loss on the prompt too (reference qlora flag)")
    p.add_argument("--group_by_length", default=True, type=eval,
                   help="co-batch similar lengths and trim the time axis to "
                        "bucketed maxima (reference qlora default)")
    p.add_argument("--pack", default=False, type=eval,
                   help="sequence packing: bin-pack examples into full rows "
                        "with segment-masked attention")
    p.add_argument("--pack_max_len", default=None, type=int,
                   help="packed row length (default source+target max len)")
    p.add_argument("--do_eval", default=True, type=eval)
    p.add_argument("--eval_dataset_size", default=1024, type=int,
                   help="held-out examples for eval loss (reference qlora.py)")
    p.add_argument("--do_mmlu_eval", default=True, type=eval)
    p.add_argument("--mmlu_kshot", default=5, type=int)
    p.add_argument("--do_predict", default=False, type=eval,
                   help="generate continuations for the eval split and "
                        "write predictions.jsonl (reference qlora.py:848-856)")
    p.add_argument("--max_new_tokens", default=256, type=int)
    p.add_argument("--do_tune", default=False, type=eval,
                   help="ASHA search of lr and blk_r on the MMLU accuracy")
    p.add_argument("--parallel_trials", default=1, type=int)
    p.add_argument("--n_trials", default=4, type=int)
    p.add_argument("--mmlu_split", default="eval", choices=["eval", "test"],
                   help="which MMLU split the callback scores (reference "
                        "qlora mmlu_split)")
    p.add_argument("--max_mmlu_samples", default=None, type=int)
    p.add_argument("--max_eval_samples", default=None, type=int)
    p.add_argument("--optim", default="adamw", choices=["adamw", "adamw8bit"],
                   help="adamw8bit = int8 optimizer moments, embeddings "
                        "fp32 (reference bitsandbytes Adam8bit + override)")
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--warmup_ratio", default=0.03, type=float)
    p.add_argument("--lr_scheduler_type", default="constant")
    p.add_argument("--max_grad_norm", default=0.3, type=float,
                   help="reference qlora default 0.3")
    p.add_argument("--max_steps", default=-1, type=int)
    p.add_argument("--save_steps", default=0, type=int)
    p.add_argument("--save_total_limit", default=1, type=int)
    p.add_argument("--resume", default=False, type=eval,
                   help="go on from the newest checkpoint in the output directory")
    p.add_argument("--gradient_checkpointing", default=True, type=eval,
                   help="remat decoder layers of local weights (reference "
                        "qlora default)")
    p.add_argument("--remat_policy", default="nothing",
                   choices=["nothing", "dots"],
                   help="what remat saves, for local weights")
    p.add_argument("--loss_chunk", default=0, type=int,
                   help="compute the CE loss in token chunks of this size "
                        "so full (B,T,V) logits are never materialised "
                        "(0 = off)")
    p.add_argument("--temperature", default=None, type=float)
    p.add_argument("--top_p", default=None, type=float)
    p.add_argument("--top_k", default=None, type=int)
    p.add_argument("--num_beams", default=1, type=int)
    p.add_argument("--do_sample", default=False, type=eval)
    p.add_argument("--repetition_penalty", default=1.0, type=float)
    p.add_argument("--no_repeat_ngram_size", default=0, type=int)
    p.add_argument("--smoke", default=False, type=eval)
    p.add_argument("--output_dir", default="results/alpaca")
    p.add_argument("--logging_steps", default=10, type=int)
    p.add_argument("--max_n_train_example", default=None, type=int)
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the training run, into "
                        "<output_dir>/<dataset>/profile")
    p.add_argument("--platform", default=None, choices=[None, "cuda", "cpu"],
                   help="where to run: the card when unset")
    return p.parse_known_args(argv)


def adapt_model(model, args, peft_config: dict):
    """Monarch adapters (``--adapter lora``: LoRA of rank 4 x blk_r) on every
    linear but the head (the reference's find_all_linear_names,
    qlora_monarch.py:245-248), their init drawn on the CPU from a generator
    seeded ``seed + 1`` (a model on the card gets the CPU run's numbers); then ``--bits`` (Monarch layers' bases only, as the JAX
    package), ``--quant_lm_head`` and ``--loss_chunk``.  Returns the model."""
    peft_config = dict(peft_config, target_modules=find_all_linear_names(model))
    generator = torch.Generator().manual_seed(args.seed + 1)  # the CPU's numbers on any device
    if args.adapter == "lora":
        adapted = init_lora(model, dict(peft_config, r=peft_config.get("blk_r", 8) * 4),
                            generator=generator)
        print(f"[alpaca] adapted {len(adapted)} layers with LoRA (qlora baseline)")
    else:
        adapted = init_monarch(model, peft_config, generator=generator)
        print(f"[alpaca] adapted {len(adapted)} layers with Monarch")
    if args.bits in (4, 8):
        n = quantize_frozen_base(model, bits=args.bits)
        print(f"[alpaca] quantized {n} frozen base matrices to int{args.bits}")
    if args.quant_lm_head and quantize_lm_head(model):
        print("[alpaca] quantized lm_head to int8")
    if args.loss_chunk:
        model.config = dataclasses.replace(model.config, loss_chunk=args.loss_chunk)
    param_stats(model)
    return model


def build_model(args, peft_config: dict, dtype: str = "bfloat16"):
    """The checkpoint of ``--model <dir>`` in ``dtype`` (the JAX harness's
    bfloat16; ``chip_smoke.py`` passes float32 to hold the card to the CPU)
    on the harness's device, remat as ``--gradient_checkpointing`` and ``--remat_policy``
    say, adapted by ``adapt_model`` there.  Else the JAX harness's tiny
    random Llama, adapted by ``adapt_model``, with the tokenizer's
    vocabulary: 1024 with ``--smoke``, else the hash tokenizer's 32000 (the
    JAX harness keeps 1024 there, and its gather fills the larger ids
    silently; an embedding here would fail on them).  It is drawn on the
    CPU from generators seeded ``seed`` and ``seed + 1`` and then moved to
    the harness's device, so that a seed gives one model on the card and on
    the CPU (a card's generator draws other numbers)."""
    if not args.smoke and os.path.isdir(args.model):
        model = from_pretrained_causal_lm(args.model, dtype=dtype,
                                          device=harness_device(args),
                                          remat=args.gradient_checkpointing,
                                          remat_policy=args.remat_policy)
        return adapt_model(model, args, peft_config)
    if not args.smoke:
        print(f"[alpaca] no local weights at {args.model!r}; random tiny init")
    vocab = SMOKE_VOCAB if args.smoke else HASH_VOCAB
    cfg = LlamaConfig.tiny(vocab_size=vocab, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=256,
                           max_position_embeddings=2048)
    model = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(args.seed))
    return adapt_model(model, args, peft_config).to(harness_device(args))


def predict_generations(model, tokenizer, eval_items, args, out_dir, *, src_len):
    """Continuations of the eval split into ``predictions.jsonl``, with the
    decoding flags (``generator=None``: sampling draws from a generator
    seeded 0 a batch, as the JAX harness's default key):
    each row is the source example plus ``prediction_with_input`` (the full
    decoded sequence) and ``prediction`` (the continuation only), as
    reference qlora.py:844-856 writes them."""
    batch_data = collate_causal_lm(
        eval_items, tokenizer, source_max_len=src_len, target_max_len=0,
        predict_with_generate=True)
    ids, mask = batch_data["input_ids"], batch_data["attention_mask"]
    gc = GenerationConfig(
        max_new_tokens=min(args.max_new_tokens, 16 if args.smoke else 10**9),
        num_beams=args.num_beams, do_sample=args.do_sample,
        temperature=args.temperature if args.temperature is not None else 1.0,
        top_p=args.top_p if args.top_p is not None else 1.0,
        top_k=args.top_k if args.top_k is not None else 0,
        repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size,
        eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id)
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    bs, n = args.batch_size, len(ids)
    rows = []
    for s in range(0, n, bs):
        b_ids, b_mask = ids[s:s + bs], mask[s:s + bs]
        if len(b_ids) < bs:  # the tail batch filled by repeats, as the JAX harness
            reps = bs - len(b_ids)
            b_ids = np.concatenate([b_ids, np.repeat(b_ids[-1:], reps, 0)])
            b_mask = np.concatenate([b_mask, np.repeat(b_mask[-1:], reps, 0)])
        out = generate(model, torch.from_numpy(b_ids).long().to(device),
                       torch.from_numpy(b_mask).long().to(device), gc).cpu().numpy()
        for j in range(min(bs, n - s)):
            toks = [t for t in out[j] if t != tokenizer.pad_token_id]
            new = [t for t in out[j, ids.shape[1]:] if t != tokenizer.pad_token_id]
            row = dict(eval_items[s + j])
            row["prediction_with_input"] = tokenizer.decode(toks).strip()
            row["prediction"] = tokenizer.decode(new).strip()
            rows.append(row)
    seconds = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "predictions.jsonl")
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(f"[alpaca] wrote {len(rows)} predictions to {path}")
    return {"predict_samples": len(rows), "predict_runtime": round(seconds, 4)}


def mmlu_kwargs(args) -> dict:
    """The MMLU scoring's k-shot and token budget."""
    return {"k_shot": 1 if args.smoke else args.mmlu_kshot,
            "max_length": 256 if args.smoke else 2048}


@dataclasses.dataclass
class AlpacaRun:
    """What ``run`` leaves: the metrics ``main`` returns, and the trained
    model's trainer with the data it scored, for callers that measure it;
    with ``--do_tune`` the search's result (``training/hpo.py``)."""
    args: argparse.Namespace
    metrics: dict
    trainer: Trainer
    tokenizer: SimpleTokenizer
    mmlu_eval: Optional[list]
    mmlu_dev: Optional[list]
    search: Optional[dict] = None

    def choice_logits(self) -> Optional[np.ndarray]:
        """The trained model's (n, 4) MMLU choice logits, as scored."""
        if self.mmlu_eval is None:
            return None
        return mmlu_choice_logits(self.trainer.model, self.tokenizer, self.mmlu_eval,
                                  self.mmlu_dev, **mmlu_kwargs(self.args))


def run(argv=None, *, build: Optional[Callable] = None,
        step_context: Optional[Callable] = None) -> AlpacaRun:
    args, overrides = parse_args(argv)
    device = harness_device(args)
    peft_config = load_json(PEFT_CONFIG)
    extra = override_config([peft_config, args], overrides)
    if extra:
        print(f"[alpaca] unmatched overrides: {extra}")

    out_dir = os.path.join(args.output_dir, args.dataset)
    tokenizer = SimpleTokenizer(vocab_size=SMOKE_VOCAB) if args.smoke \
        else get_tokenizer(args.model, vocab_size=HASH_VOCAB)

    all_items = load_data_items(
        "alpaca", args.dataset if args.dataset != "alpaca" else "alpaca_data_cleaned",
        args.data_dir, split="train", max_n_example=args.max_n_train_example,
        seed=args.seed, smoke=args.smoke)
    # per-dataset raw-row normalisation (reference format_dataset); smoke
    # items are already alpaca-shaped
    if not args.smoke:
        all_items = format_items(all_items, args.dataset_format, args.dataset)
    if args.do_eval or args.do_predict:
        # the eval split is built when either flag is set, and predicted on
        # (reference qlora.py:658-664)
        train_items, eval_items = train_eval_split(
            all_items, args.eval_dataset_size, seed=args.seed)
    else:
        train_items, eval_items = all_items, None
    src_len, tgt_len = ((128, 64) if args.smoke
                        else (args.source_max_len, args.target_max_len))

    def collate(items):
        return collate_causal_lm(items, tokenizer, source_max_len=src_len,
                                 target_max_len=tgt_len, train_on_source=args.train_on_source)

    if args.pack:
        train_data, eff = pack_causal_lm(
            train_items, tokenizer, max_len=args.pack_max_len or (src_len + tgt_len),
            source_max_len=src_len, target_max_len=tgt_len,
            train_on_source=args.train_on_source)
        print(f"[alpaca] packed {len(train_items)} examples into "
              f"{len(train_data['input_ids'])} rows ({eff:.0%} token efficiency)")
    else:
        train_data = collate(train_items)
    eval_data = collate(eval_items) if (eval_items and args.do_eval) else None

    mmlu_eval = mmlu_dev = None
    if args.do_mmlu_eval:
        mmlu_eval = load_mmlu_items(args.data_dir, args.mmlu_split,
                                    smoke=args.smoke, seed=args.seed)
        if args.max_mmlu_samples:
            mmlu_eval = mmlu_eval[:args.max_mmlu_samples]
        mmlu_dev = load_mmlu_items(args.data_dir, "dev", smoke=args.smoke,
                                   seed=args.seed + 1, smoke_n=8)
    if eval_items and args.max_eval_samples:
        eval_items = eval_items[:args.max_eval_samples]
        if eval_data is not None:
            eval_data = {k: v[:args.max_eval_samples] for k, v in eval_data.items()}

    def lm_loss(model, batch, train):
        # the fused forward and CE; chunked (never the full logits) when
        # --loss_chunk > 0
        return model.training_loss(
            batch["input_ids"], batch["labels"], attention_mask=batch["attention_mask"],
            segment_ids=batch.get("segment_ids"), weights=batch.get("_valid"))

    def mmlu_metrics(model, _data):
        if mmlu_eval is None:
            return {}
        t0 = time.perf_counter()
        logits = mmlu_choice_logits(model, tokenizer, mmlu_eval, mmlu_dev, **mmlu_kwargs(args))
        metrics = mmlu_scores(mmlu_eval, logits)
        metrics["mmlu_runtime"] = round(time.perf_counter() - t0, 4)
        return metrics

    def make_trainer(hp=None, epochs=None, logger=None):
        pc = dict(peft_config)
        ta = TrainingArgs(
            output_dir=out_dir, learning_rate=args.lr,
            num_train_epochs=epochs if epochs is not None else args.epochs,
            max_steps=args.max_steps, per_device_train_batch_size=args.batch_size,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            lr_scheduler_type=args.lr_scheduler_type, optim=args.optim,
            warmup_ratio=args.warmup_ratio, weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm, save_steps=args.save_steps,
            save_total_limit=args.save_total_limit,
            logging_steps=args.logging_steps, log_param_steps=0, seed=args.seed,
            group_by_length=args.group_by_length,
            metric_for_best_model="mmlu_eval_accuracy", greater_is_better=True)
        if hp:
            override_config([ta, pc], hp)
        model = (build or build_model)(args, pc)
        return Trainer(model, ta, train_data=train_data, eval_data=eval_data,
                       loss_fn=lm_loss, compute_metrics=mmlu_metrics, logger=logger,
                       device=device, step_context=step_context)

    def ensure_mmlu(metrics, model):
        """--do_eval=False skips the loss-eval loop (no eval_data), but an
        explicitly requested MMLU eval still runs (the reference runs the
        MMLU callback independently of do_eval, qlora_monarch.py:671-715)."""
        if mmlu_eval is not None and not any("mmlu" in k for k in metrics):
            metrics = dict(metrics)
            metrics.update({f"eval_{k}": v for k, v in mmlu_metrics(model, None).items()})
        return metrics

    search = None
    if args.do_tune:
        space = {"learning_rate": loguniform(5e-5, 1e-3), "blk_r": choice([4, 8, 16])}

        def run_trial(hp, epochs, trial_id):
            # a trial's own directory, resumed at each rung
            hp = dict(hp, output_dir=os.path.join(out_dir, f"trial_{trial_id}"))
            t = make_trainer(hp, epochs)
            return ensure_mmlu(t.train(resume=True), t.model)

        search = hyperparameter_search(
            run_trial, space, n_trials=args.n_trials, parallel_trials=args.parallel_trials,
            devices=trial_devices(args.parallel_trials, device),
            target_metric="eval_mmlu_eval_accuracy", mode="max", max_epochs=float(args.epochs))
        hp = search["best_hyperparams"]
        save_best_hp(hp, out_dir)
        print(json.dumps({"best_hyperparams": hp, "best_metric": search["best_metric"]}))
    else:
        hp = load_best_hp(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    logger = RunLogger(out_dir, group=get_run_group(task_name=args.dataset,
                                                    do_tune=args.do_tune),
                       name=f"{args.dataset}_final",
                       config={"dataset": args.dataset, "bits": args.bits, "hp": hp or {}})
    try:
        trainer = make_trainer(hp, logger=logger)
        watch_layers(trainer.model, logger)
        profile = (profiling.trace(os.path.join(out_dir, "profile")) if args.profile
                   else contextlib.nullcontext())
        with profile:
            metrics = trainer.train(resume=args.resume)
        metrics = ensure_mmlu(metrics, trainer.model)
        if args.do_predict:
            metrics.update(predict_generations(trainer.model, tokenizer, eval_items, args,
                                               out_dir, src_len=src_len))
        logger.log({"step": trainer.step, **metrics})
        watch_layers(trainer.model, logger)
    finally:
        logger.finish()
    print(json.dumps(metrics))
    with open(os.path.join(out_dir, "eval_results.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    return AlpacaRun(args, metrics, trainer, tokenizer, mmlu_eval, mmlu_dev, search)


def main(argv=None, *, build: Optional[Callable] = None) -> dict:
    """Run the harness; returns the metrics it prints last and writes to
    ``eval_results.json``."""
    return run(argv, build=build).metrics


if __name__ == "__main__":
    main()
