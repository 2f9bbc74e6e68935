"""models of the PyTorch port; see the JAX package's models/ for the reference.

The exports are the JAX package's (its models/__init__.py)."""

from sparse_matrix_fine_tuning_torch.models.backpack_gpt2 import (
    BackpackGPT2Config,
    BackpackGPT2LMHeadModel,
)
from sparse_matrix_fine_tuning_torch.models.blip import (
    BlipForImageTextRetrieval,
    BlipForQuestionAnswering,
    BlipITMWrapper,
    BlipModelConfig,
    BlipWrapper,
)
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig, RobertaConfig
from sparse_matrix_fine_tuning_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from sparse_matrix_fine_tuning_torch.models.gpt_neo import GPTNeoConfig, GPTNeoForCausalLM
from sparse_matrix_fine_tuning_torch.models.gpt_neox import GPTNeoXConfig, GPTNeoXForCausalLM
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM, LlamaModel
from sparse_matrix_fine_tuning_torch.models.roberta import (
    RobertaForSequenceClassification,
    RobertaModel,
)
from sparse_matrix_fine_tuning_torch.models.toy import GRUModel, MLPModel, ToyConfig

__all__ = [
    "BackpackGPT2Config",
    "BackpackGPT2LMHeadModel",
    "BlipForImageTextRetrieval",
    "BlipForQuestionAnswering",
    "BlipITMWrapper",
    "BlipModelConfig",
    "BlipWrapper",
    "GPT2Config",
    "GPT2LMHeadModel",
    "GPTNeoConfig",
    "GPTNeoForCausalLM",
    "GPTNeoXConfig",
    "GPTNeoXForCausalLM",
    "LlamaConfig",
    "RobertaConfig",
    "LlamaForCausalLM",
    "LlamaModel",
    "RobertaForSequenceClassification",
    "RobertaModel",
    "GRUModel",
    "MLPModel",
    "ToyConfig",
]
