"""``run_reasoning --mesh_fsdp 2`` in a 2-rank gloo world on the CPU.

The harness's smoke run at a learning rate of 0, with Monarch adapters and
with a LoReFT intervention over them, trains over an fsdp mesh of the
launched world (each rank on its data rank's rows) and evaluates by
generating on the sharded model; the weights never move, so its eval
results and generations equal the unsharded harness run's, and only rank 0
writes the results, the generations, the metrics log and the checkpoints.
"""

import json
import os

import pytest

import _torch_parallel_worker as w
from sparse_matrix_fine_tuning_torch.scripts import run_reasoning

ARGV = ["-task", "math", "--smoke=True", "-e", "1", "-batch_size", "2", "--lr=0.0",
        "--logging_steps=1", "--dropout=0.0", "--max_n_train_example=8",
        "--max_n_eval_example=4", "--max_steps=2", "--platform=cpu"]
RUNS = {"monarch": ARGV,
        "loreft": [*ARGV, "--intervention_type", "LoreftIntervention", "-rank", "4"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_reasoning")
    procs = w.spawn("reasoning", str(tmp), world=2)
    try:
        w.put_inputs(str(tmp), {"argvs": {tag: [*argv, "--mesh_fsdp=2"]
                                          for tag, argv in RUNS.items()}})
        plain = {tag: run_reasoning.run([*argv, f"--output_dir={tmp / tag / 'plain'}"]).results
                 for tag, argv in RUNS.items()}
    finally:
        ranks = w.collect(procs, str(tmp))
    return ranks, plain, tmp


@pytest.mark.parametrize("tag", list(RUNS))
def test_torch_parallel_reasoning_eval_matches_unsharded(world, tag):
    """The results and every generated text."""
    ranks, plain, tmp = world
    assert plain[tag] and set(plain[tag]) >= {"eval/average"}
    for rec in ranks:
        assert rec[tag]["results"] == plain[tag]
        assert rec[tag]["step"] == 2

    def generations(out):
        with open(os.path.join(out, "math", "generations.json")) as f:
            return json.load(f)

    assert generations(tmp / tag / "out") == generations(tmp / tag / "plain")
    assert generations(tmp / tag / "plain")


@pytest.mark.parametrize("tag", list(RUNS))
def test_torch_parallel_reasoning_primary_writes_alone(world, tag):
    ranks, _, _ = world
    files = ranks[0][tag]["files"]
    assert "math/eval_results.json" in files and "math/generations.json" in files
    assert "math/metrics.jsonl" in files
    assert any(f.startswith("math/checkpoint-") for f in files)
    assert ranks[1][tag]["files"] == []
