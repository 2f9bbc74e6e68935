"""Smoke test of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives the port's serving path (greedy ``generate`` on a TinyLlama-1.1B-shaped
Llama with unmerged Monarch adapters on all seven projections, random seeded
weights) through the hand-written CUDA kernels, and checks it:

  1. device: a CUDA card of compute capability 9.0, its name and power limit;
  2. build: the kernels are compiled from ``kernels/csrc/`` in this checkout;
  3. kernels against their plain PyTorch versions at the slice's shapes, in
     bfloat16 and float32, with times from CUDA events;
  4. the slice in float32 against a copy with the adapters merged on the CPU
     (no kernel in it): prefill logits and greedy tokens;
  5. the slice in bfloat16, timed as ``bench.py`` times the JAX one, with the
     launch counts that show the main path went through the kernels.

Any failed check exits non-zero.  The line before the last is one JSON object
on the kernels; the last is ``{"ok": true, "device": {...}}``.  It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

try:
    import torch

    from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
    from sparse_matrix_fine_tuning_torch.kernels.build import build
except ImportError as exc:  # run outside a checkout of the repository
    print(f"chip_smoke: cannot import the port ({exc}); run it from the repository root",
          file=sys.stderr)
    sys.exit(2)

SEED = 0
# TinyLlama-1.1B widths (bench.py:130-140) and its Monarch adapters.
MODEL = dict(vocab_size=32000, hidden_size=2048, num_hidden_layers=22,
             num_attention_heads=32, num_key_value_heads=4, intermediate_size=5632)
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
# (name, in, out) of the adapted projections of one decoder layer.
PROJECTIONS = [("q", 2048, 2048), ("k", 2048, 256), ("v", 2048, 256), ("o", 2048, 2048),
               ("gate", 2048, 5632), ("up", 2048, 5632), ("down", 5632, 2048)]
ROWS = (4, 65, 256, 2048)
N_ADAPTED = 7 * MODEL["num_hidden_layers"]
BATCH, PROMPT, NEW = 4, 64, 128  # bench.py:128
PROMPT_LENS = (64, 48, 33, 17)
F32_NEW = 32
# f32 prefill logits, kernel path against the merged reference: 22 layers of
# fp32 sums taken in another order (x W^T + monarch(x) against x (W + M)^T)
F32_LOGIT_TOL = 1e-3
SOURCE = "sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu"
REPLACES = {"monarch_kernel": "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:157",
            "monarch_add": "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:164"}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True).stdout.strip()
    return out.splitlines()[0]


def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), got {cap}")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build(verbose=True)
    monarch_cuda.load_ops()
    print(f"[build] {time.perf_counter() - t0:.1f} s, {lib}", flush=True)


def time_ms(fn, reps: int = 50, rounds: int = 5) -> tuple[float, float]:
    """(device ms, call ms) per call: medians over rounds of `reps`
    back-to-back calls between two CUDA events, after a warmup.

    call ms: the queue is empty when the start event is recorded, so it
    includes the host's cost of each call, as an eager decode step sees it.
    device ms: a spin kernel (``torch.cuda._sleep``) holds the queue for
    twice the host time of the calls, so the calls run back to back on the
    card and the events see device time only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run(stall_cycles: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if stall_cycles:
            torch.cuda._sleep(stall_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    call_ms = statistics.median(run(0) for _ in range(rounds))
    stall = int(2 * call_ms * reps * 2.0e6)  # ms -> cycles at up to 2 GHz
    device_ms = statistics.median(run(stall) for _ in range(rounds))
    return device_ms, call_ms


def moved_bytes(n_in: int, n_out: int, m_rows: int, dtype: torch.dtype, add: bool) -> int:
    """Bytes a kernel must move: x, out (and base), and both factors."""
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    elems = m_rows * (n_in + n_out * (2 if add else 1)) + nb * r * (n_in // nb + n_out // nb)
    return elems * (2 if dtype == torch.bfloat16 else 4)


def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """f32: the two sum in another order, 1e-5 of the output's scale.
    bf16: the intermediate may round one ulp apart, and the output rounds
    once more, so two bf16 ulps of the output's scale (2**-6 of it)."""
    scale = float(ref.float().abs().max())
    return scale * (1e-5 if dtype == torch.float32 else 2.0 ** -6)


def phase_kernels(card: str) -> dict:
    """Both kernels against their plain versions at the slice's shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    worst = {"monarch_kernel": 0.0, "monarch_add": 0.0}
    layer_ms = {name: {"ms": 0.0, "plain_ms": 0.0} for name in worst}
    print(f"[kernels] card: {card}", flush=True)
    print("[kernels] kernel    proj  in->out     M     dtype    max_abs_err  tol        "
          "dev_ms    plain_dev_ms  call_ms   plain_call_ms  GB/s", flush=True)
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for m_rows in ROWS:
                for proj, n_in, n_out in PROJECTIONS:
                    p, s = n_in // nb, n_out // nb
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(dtype)
                    w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
                    w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
                    base = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
                    cases = {
                        "monarch_kernel": (lambda: monarch_cuda.monarch_kernel(x, w1, w2),
                                           lambda: monarch_cuda.monarch_kernel_reference(x, w1, w2)),
                        "monarch_add": (lambda: monarch_cuda.monarch_add(base, x, w1, w2),
                                        lambda: monarch_cuda.monarch_add_reference(base, x, w1, w2)),
                    }
                    for name, (kern, plain) in cases.items():
                        got, ref = kern(), plain()
                        torch.cuda.synchronize()
                        require(got.shape == ref.shape and got.dtype == ref.dtype,
                                f"{name} {proj} M={m_rows}: {got.shape}/{got.dtype} vs "
                                f"{ref.shape}/{ref.dtype}")
                        err = float((got.float() - ref.float()).abs().max())
                        tol = tolerance(dtype, ref)
                        (ms, call), (plain_ms, plain_call) = time_ms(kern), time_ms(plain)
                        gbs = moved_bytes(n_in, n_out, m_rows, dtype, name == "monarch_add") / ms / 1e6
                        print(f"[kernels] {name:13s} {proj:5s} {n_in}->{n_out:<5d} {m_rows:5d} "
                              f"{str(dtype)[6:]:8s} {err:.3e}  {tol:.3e}  {ms:.5f}  {plain_ms:.5f}"
                              f"       {call:.5f}   {plain_call:.5f}        {gbs:.1f}", flush=True)
                        require(err <= tol and bool(torch.isfinite(got).all()),
                                f"{name} {proj} M={m_rows} {dtype}: max_abs_err {err} > tol {tol}")
                        worst[name] = max(worst[name], err)
                        if dtype == torch.bfloat16 and m_rows == 4:
                            layer_ms[name]["ms"] += ms
                            layer_ms[name]["plain_ms"] += plain_ms
    print(f"[kernels] {card}: device time per decoder layer at decode (M=4, bf16, "
          "7 projections): "
          + ", ".join(f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f} ms)"
                      for k, v in layer_ms.items()), flush=True)
    return {"worst": worst, "layer_ms": layer_ms}


def slice_config(dtype: str):
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig

    return LlamaConfig(**MODEL, param_dtype=dtype, dtype=dtype,
                       max_position_embeddings=PROMPT + 3 * NEW)


def build_model(dtype: str, state=None):
    """The slice's model on the card, with Monarch adapters on all seven
    projections; random seeded weights, or ``state`` where given."""
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = LlamaForCausalLM(slice_config(dtype), device="cuda", generator=g)
    adapted = init_monarch(model, PEFT, generator=g)
    require(len(adapted) == N_ADAPTED, f"{len(adapted)} adapted linears, expected {N_ADAPTED}")
    if state is not None:
        model.load_state_dict(state)
    return model.eval()


@torch.no_grad()
def randomize_adapters(model) -> float:
    """Seeded random nonzero factors (the plain-adapter init zeroes blkdiag2,
    which would hide a kernel that writes zeros), scaled so that
    |monarch(x)| / |dense(x)| is about 0.1 for q_proj at layer 0 on the
    prompts' real input.  Returns that ratio."""
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    layers = [m for m in model.modules() if isinstance(m, MonarchLinear)]
    for m in layers:
        m.blkdiag1.normal_(0.0, 1.0, generator=g).div_(m.in_blksz ** 0.5)
        m.blkdiag2.normal_(0.0, 1.0, generator=g).div_(m.blk_r ** 0.5)
    ids, mask = prompts(torch.Generator(device="cuda").manual_seed(SEED + 2))
    layer0 = model.model.layers[0]
    x = layer0.input_layernorm(model.model.embed_tokens(ids))[mask.bool()]
    q = layer0.self_attn.q_proj

    def ratio():
        mon = monarch_cuda.monarch_kernel_reference(x, q.blkdiag1.to(x.dtype), q.blkdiag2.to(x.dtype))
        return float(mon.float().norm() / q._dense_forward(x).float().norm())

    scale = 0.1 / ratio()
    for m in layers:
        m.blkdiag2.mul_(scale)
    return ratio()


def prompts(g: torch.Generator):
    """Four left-padded prompts of lengths 64, 48, 33 and 17, padded to 64."""
    vocab = MODEL["vocab_size"]
    ids = torch.randint(3, vocab, (len(PROMPT_LENS), PROMPT), generator=g, device="cuda")
    mask = torch.zeros_like(ids)
    for row, n in enumerate(PROMPT_LENS):
        mask[row, PROMPT - n:] = 1
    return ids * mask, mask


def phase_f32() -> dict:
    """The slice in float32 against a copy with no kernel in it: the
    adapters merged on the CPU by the plain functions, then moved to the card."""
    import copy

    from sparse_matrix_fine_tuning_torch.models.generate import (
        GenerationConfig,
        _positions_from_mask,
        generate,
    )
    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products in both
    torch.backends.cudnn.allow_tf32 = False
    model = build_model("float32")
    ratio = randomize_adapters(model)
    print(f"[f32] |monarch(x)|/|dense(x)| at layer 0 q_proj: {ratio:.4f}", flush=True)
    ref = copy.deepcopy(model).cpu()
    require(merge_all_adapters(ref) == N_ADAPTED, "merge on the CPU missed adapters")
    ref = ref.to("cuda")
    ids, mask = prompts(torch.Generator(device="cuda").manual_seed(SEED + 2))
    monarch_cuda.reset_launch_counts()
    with torch.inference_mode():
        got = model(ids, attention_mask=mask)
        want = ref(ids, attention_mask=mask)
    torch.cuda.synchronize()
    require(monarch_cuda.LAUNCHES["monarch_add"] == N_ADAPTED,
            f"prefill launched {monarch_cuda.LAUNCHES}; expected {N_ADAPTED} fused adds")
    valid = mask.bool()
    err = float((got - want)[valid].abs().max())
    scale = float(want[valid].abs().max())
    tol = F32_LOGIT_TOL * scale
    print(f"[f32] prefill logits {tuple(got.shape)}: max_abs_err {err:.3e}, tol {tol:.3e} "
          f"({F32_LOGIT_TOL:g} of max|logit| {scale:.3f})", flush=True)
    require(bool(torch.isfinite(got).all()), "non-finite f32 logits")
    require(err <= tol, f"f32 prefill logits differ: {err} > {tol}")

    gc = GenerationConfig(max_new_tokens=F32_NEW)
    toks = generate(model, ids, mask, gc)
    ref_toks = generate(ref, ids, mask, gc)
    require(tuple(toks.shape) == (len(PROMPT_LENS), PROMPT + F32_NEW), f"tokens {toks.shape}")
    for row in range(toks.shape[0]):
        diff = (toks[row] != ref_toks[row]).nonzero()
        if len(diff) == 0:
            continue
        # the first divergence must be a true near-tie of the reference's logits
        at = int(diff[0])
        seq = ref_toks[row:row + 1, :at]
        m = torch.cat([mask[row:row + 1], torch.ones_like(seq[:, PROMPT:])], dim=-1)
        with torch.inference_mode():
            last = ref(seq, attention_mask=m, positions=_positions_from_mask(m))[0, -1]
        gap = float(last[ref_toks[row, at]] - last[toks[row, at]])
        print(f"[f32] row {row} diverges at step {at - PROMPT}: logit gap {gap:.3e} "
              f"(tol {tol:.3e})", flush=True)
        require(gap <= tol, f"f32 tokens differ at row {row}, step {at - PROMPT}, gap {gap}")
    same = int((toks == ref_toks).all(dim=-1).sum())
    print(f"[f32] greedy {F32_NEW} tokens: {same}/{toks.shape[0]} rows identical to the "
          "merged reference", flush=True)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, ref
    torch.cuda.empty_cache()
    return {"logits": got.detach(), "mask": mask, "ids": ids, "state": state}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def profile_decode(model, ids, mask, steps: int = 8) -> None:
    """Device time by kernel over `steps` decode forwards after a prefill,
    from torch.profiler, and the device's busy share of the window's wall
    time (the profiler's own host cost is in that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from sparse_matrix_fine_tuning_torch.models.generate import _positions_from_mask
    from sparse_matrix_fine_tuning_torch.models.llama import init_caches

    b, t = ids.shape
    caches = init_caches(model.config, b, t + steps + 1, torch.bfloat16, "cuda")
    mask_full = torch.cat([mask, mask.new_zeros(b, steps + 1)], dim=-1)
    pos = _positions_from_mask(mask)
    logits, caches = model(ids, attention_mask=mask_full, positions=pos, caches=caches,
                           cache_index=0)
    tok, pos = logits[:, -1].argmax(-1)[:, None], pos[:, -1:] + 1

    def step(i):
        mask_full[:, t + i] = 1
        return model(tok, attention_mask=mask_full, positions=pos + i, caches=caches,
                     cache_index=t + i)

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    busy_ms = sum(r[0] for r in rows) / steps
    if busy_ms == 0:
        print("[profile] device time: not measured (the profiler saw no device time)", flush=True)
        return None
    print(f"[profile] {steps} decode steps under the profiler: wall {wall_ms / steps:.3f} ms/step "
          f"(profiler on), device busy {busy_ms:.3f} ms/step", flush=True)
    for dev_ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile]   {dev_ms / steps:8.4f} ms/step  {count // steps:5d} launches/step  "
              f"{key[:90]}", flush=True)
    return busy_ms


def phase_bf16(f32: dict, card: str) -> dict:
    """The slice in bfloat16, timed as bench.py times the JAX one: batch 4,
    prompt 64, 128 new tokens, no EOS.  The counted main path is: unmerged
    greedy generate (K2 on every adapted linear), merge of the adapters on
    the card (K1), greedy generate of the merged model."""
    from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    model = build_model("bfloat16", f32.pop("state"))
    with torch.inference_mode():
        logits = model(f32["ids"], attention_mask=f32["mask"])
    valid = f32["mask"].bool()
    require(bool(torch.isfinite(logits).all()), "non-finite bf16 logits")
    cos = float(torch.nn.functional.cosine_similarity(
        logits[valid].float().flatten(), f32["logits"][valid].float().flatten(), dim=0))
    print(f"[bf16] prefill logits cosine to f32: {cos:.5f} (need >= 0.99)", flush=True)
    require(cos >= 0.99, f"bf16 prefill logits cosine {cos} < 0.99")

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    mask = torch.ones(BATCH, PROMPT, dtype=torch.long, device="cuda")

    def fresh_ids():
        return torch.randint(2, MODEL["vocab_size"], (BATCH, PROMPT), generator=g, device="cuda")

    gc = GenerationConfig(max_new_tokens=NEW, eos_token_id=None)
    gc1 = GenerationConfig(max_new_tokens=1, eos_token_id=None)
    steps = NEW - 1  # decode forwards: one per new token after the prefill's

    def gen_s(new_cfg):
        ids = fresh_ids()
        return timed(lambda: generate(model, ids, mask, new_cfg))[1]

    generate(model, fresh_ids(), mask, GenerationConfig(max_new_tokens=8, eos_token_id=None))
    prefill = [gen_s(gc1) for _ in range(5)]
    gens = [gen_s(gc) for _ in range(3)]
    busy_ms = profile_decode(model, fresh_ids(), mask)
    probe = fresh_ids()
    with torch.inference_mode():
        unmerged_logits = model(probe, attention_mask=mask)

    monarch_cuda.reset_launch_counts()  # the counted main path starts here
    ids = fresh_ids()
    toks, main_s = timed(lambda: generate(model, ids, mask, gc))
    adds = monarch_cuda.LAUNCHES["monarch_add"]
    _, merge_s = timed(lambda: merge_all_adapters(model))
    merged_toks, merged_main_s = timed(lambda: generate(model, ids, mask, gc))
    launches = dict(monarch_cuda.LAUNCHES)  # the counted main path ends here

    require(tuple(toks.shape) == (BATCH, PROMPT + NEW), f"tokens {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < MODEL["vocab_size"])).all()), "token out of range")
    want = N_ADAPTED * (1 + steps)
    print(f"[bf16] launches in the main path: {launches}; monarch_add in the unmerged "
          f"generate {adds}, expected {N_ADAPTED} x (1 + {steps}) = {want}", flush=True)
    require(adds == want == launches["monarch_add"], "fused-add launches do not match")
    require(launches["monarch_kernel"] == N_ADAPTED,
            f"merge launched monarch_kernel {launches['monarch_kernel']} times, "
            f"expected {N_ADAPTED}")

    with torch.inference_mode():
        merged_logits = model(probe, attention_mask=mask)
    merged_cos = float(torch.nn.functional.cosine_similarity(
        merged_logits.float().flatten(), unmerged_logits.float().flatten(), dim=0))
    agree = float((merged_toks[:, PROMPT:] == toks[:, PROMPT:]).float().mean())
    merged_prefill = [gen_s(gc1) for _ in range(3)]
    merged_gens = [merged_main_s] + [gen_s(gc) for _ in range(2)]

    med = statistics.median
    prefill_ms = med(prefill) * 1e3
    gen_med = med(gens + [main_s])
    decode_ms = (gen_med * 1e3 - prefill_ms) / steps
    merged_prefill_ms = med(merged_prefill) * 1e3
    merged_decode_ms = (med(merged_gens) * 1e3 - merged_prefill_ms) / steps
    print(f"[bf16] {card}: batch {BATCH}, prompt {PROMPT}, {NEW} new tokens, unmerged adapters: "
          f"prefill {prefill_ms:.3f} ms (median of {len(prefill)}), decode {decode_ms:.4f} "
          f"ms/step, {BATCH * NEW / gen_med:.1f} tokens/s (generate median of "
          f"{len(gens) + 1}: {gen_med:.4f} s; all {[round(x, 4) for x in gens + [main_s]]})",
          flush=True)
    if busy_ms is not None:
        print(f"[bf16] {card}: decode device busy {busy_ms:.3f} ms/step (profiled) of {decode_ms:.3f} "
              f"ms/step (unprofiled): idle share {1 - busy_ms / decode_ms:.3f}", flush=True)
    print(f"[bf16] {card}: merged on the card in {merge_s * 1e3:.1f} ms; merged: prefill "
          f"{merged_prefill_ms:.3f} ms, decode {merged_decode_ms:.4f} ms/step, "
          f"{BATCH * NEW / med(merged_gens):.1f} tokens/s; prefill logits cosine merged to "
          f"unmerged {merged_cos:.5f}; greedy tokens agree on {agree:.3f} of positions",
          flush=True)
    require(merged_cos >= 0.99, f"merged bf16 logits cosine {merged_cos} < 0.99")
    return {"launches": launches}


def main() -> None:
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    f32 = phase_f32()
    bf16 = phase_bf16(f32, card)
    lines = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
              "launches": bf16["launches"][name], "max_abs_err": kernels["worst"][name],
              "ms": kernels["layer_ms"][name]["ms"],
              "plain_ms": kernels["layer_ms"][name]["plain_ms"]}
             for name in ("monarch_kernel", "monarch_add")]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
