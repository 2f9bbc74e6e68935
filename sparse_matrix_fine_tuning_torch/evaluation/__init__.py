"""Evaluation of the PyTorch port: generation-based exact match for the
reasoning harness (``evaluation/reasoning.py``) and batched prediction of
the classification heads (``evaluation/predict.py``)."""

from sparse_matrix_fine_tuning_torch.evaluation.predict import (
    predict_classes,
    predict_logits,
)
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
    "predict_classes",
    "predict_logits",
    "score_generation",
]
