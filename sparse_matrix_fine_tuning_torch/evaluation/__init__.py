"""Evaluation of the PyTorch port: generation-based exact match for the
reasoning harness (``evaluation/reasoning.py``).  ``evaluation/predict.py``
(classification heads) waits for ROADMAP.md queue A item 20."""

from sparse_matrix_fine_tuning_torch.evaluation.reasoning import (
    compute_reasoning_metrics,
    extract_answer_letter,
    extract_answer_number,
    extract_output,
    score_generation,
)

__all__ = [
    "compute_reasoning_metrics",
    "extract_answer_letter",
    "extract_answer_number",
    "extract_output",
    "score_generation",
]
