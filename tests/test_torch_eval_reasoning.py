"""The port's generation-based evaluation (``evaluation/reasoning.py``)
against the JAX package's on the CPU in float32: ``compute_reasoning_metrics``
over the same model (``test_torch_generate.py``'s), the same synthetic items
and batch size, with a ragged tail batch (5 items in batches of 3): equal
generations and equal accuracies, greedy (math), with the instruct task's
penalty and 5-gram ban (its alpaca_eval dump), and commonsense's beam-4
sample near temperature 0 (``-top_k 0 -top_p 1.0``; equal to beam search,
so equal in both packages).  Then the answer extraction and
``score_generation`` on hand-made generations."""

import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.data import reasoning as treasoning
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer
from sparse_matrix_fine_tuning_torch.evaluation import reasoning as teval
from sparse_matrix_fine_tuning_tpu.data import reasoning as jreasoning
from sparse_matrix_fine_tuning_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from sparse_matrix_fine_tuning_tpu.evaluation import reasoning as jeval
from test_torch_generate import pair  # noqa: F401  (the module's fixture)

VOCAB = 256  # the pair's
N_ITEMS, BATCH = 5, 3


def metrics(package, model, task: str, tokenize=None, **kw):
    """(generations, metrics) of ``package``'s evaluation with its own
    tokenizer and tokenizing (``tokenize``: more of its keywords), as its
    harness runs them."""
    data, ev, tok = ((jreasoning, jeval, JaxTokenizer(VOCAB)) if package == "jax"
                     else (treasoning, teval, SimpleTokenizer(VOCAB)))
    items = data.load_data_items(task, "MultiArith", "unused", smoke=True, smoke_n=N_ITEMS,
                                 seed=1)
    eval_data = data.tokenize_reasoning(task, items, tok, max_length=64, split="test",
                                        **(tokenize or {}))
    return ev.compute_reasoning_metrics(task, "MultiArith", model, tok, eval_data, items,
                                        batch_size=BATCH, **kw)


@pytest.mark.parametrize("task,kw", [
    ("math", dict(max_new_tokens=6)),
    ("instruct", dict(greedy_decoding=False, max_new_tokens=6)),
    ("commonsense", dict(greedy_decoding=False, max_new_tokens=5, top_k=0, top_p=1.0,
                         temperature=1e-6)),
], ids=["math-greedy", "instruct-penalty-ngram", "commonsense-beam-sample"])
def test_torch_reasoning_metrics_match_jax(pair, task, kw):
    jm, tm = pair
    got_gens, got = metrics("port", tm, task, **kw)
    want_gens, want = metrics("jax", jm, task, **kw)
    assert len(got_gens) == N_ITEMS
    assert got_gens == want_gens
    assert got == want
    if task == "instruct":
        assert got == {} and {g["dataset"] for g in got_gens} == {"MultiArith"}
    else:
        assert set(got) == {"eval/MultiArith"}


def test_torch_generation_config_matches_jax_args():
    """The task's generation_args with the overrides; alpaca-shaped tasks
    turn their total budget into new tokens against the prompt's width."""
    tok = SimpleTokenizer(VOCAB)
    gc = teval.generation_config("math", tok, 30, greedy_decoding=False, top_k=0, top_p=1.0)
    assert (gc.num_beams, gc.do_sample, gc.temperature, gc.top_k, gc.top_p,
            gc.max_new_tokens) == (4, True, 0.3, 0, 1.0, 512)
    gc = teval.generation_config("alpaca", tok, 48, greedy_decoding=False)
    assert (gc.max_new_tokens, gc.repetition_penalty, gc.no_repeat_ngram_size) == \
        (2048 - 48, 1.1, 5)
    gc = teval.generation_config("gsm8k", tok, 10, greedy_decoding=False)
    assert (gc.do_sample, gc.top_k, gc.top_p, gc.temperature, gc.num_beams) == \
        (True, 40, 0.95, 0.8, 1)
    assert (gc.eos_token_id, gc.pad_token_id) == (tok.eos_token_id, tok.pad_token_id)


GENERATIONS = ["The answer is 7", "so 1,234.5 apples", "no number here", "(B) because",
               "answer: -3.0 then 4", "true", " false ", "The final answer is: 12"]
EXAMPLES = [("math", {"answer": "7"}), ("math", {"answer": "1234.5"}), ("math", {"answer": "B"}),
            ("commonsense", {"answer": "true"}), ("commonsense", {"answer": "false"}),
            ("gsm8k", {"answer": "steps #### 12"}), ("tune_math", {"answer": "4"})]


@pytest.mark.parametrize("text", GENERATIONS)
def test_torch_answer_extraction_matches_jax(text):
    assert teval.extract_answer_number(text) == jeval.extract_answer_number(text)
    assert teval.extract_answer_letter(text) == jeval.extract_answer_letter(text)
    for trigger in ("", "answer", "### Response:"):
        assert teval.extract_output(text, trigger) == jeval.extract_output(text, trigger)
    for task, example in EXAMPLES:
        assert teval.score_generation(task, text, example) == \
            jeval.score_generation(task, text, example), (task, example)


def test_torch_score_generation_refuses_an_open_task():
    with pytest.raises(ValueError, match="no EM scoring"):
        teval.score_generation("alpaca", "x", {})
