"""Model configuration for the port: ``LlamaConfig``.

Counterpart of ``LlamaConfig`` in ``sparse_matrix_fine_tuning_tpu/models/
config.py``, with the same field names, defaults and presets, so that one
configuration describes both models.  ``compute_dtype`` and
``params_dtype`` return torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder-only causal-LM config (Llama-2 defaults); see the JAX
    ``LlamaConfig`` for what each knob selects."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None -> MHA
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    tie_word_embeddings: bool = False
    head_dim: Optional[int] = None
    attention_qkv_bias: bool = False
    mlp_activation: str = "silu"
    sliding_window: Optional[int] = None
    rmsnorm_unit_offset: bool = False
    scale_embeddings: bool = False
    dtype: Optional[str] = None  # compute dtype, e.g. "bfloat16"
    attention_impl: str = "einsum"
    param_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "nothing"
    loss_chunk: int = 0

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_width(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return _resolve_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return _resolve_dtype(self.param_dtype) or torch.float32

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2,
                 intermediate_size=128, max_position_embeddings=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(**kw)

    @classmethod
    def mistral_7b(cls, **kw):
        d = dict(num_key_value_heads=8, intermediate_size=14336,
                 max_position_embeddings=32768, sliding_window=4096,
                 rms_norm_eps=1e-5, rope_theta=10000.0)
        d.update(kw)
        return cls(**d)

    @classmethod
    def gemma_2b(cls, **kw):
        d = dict(vocab_size=256000, hidden_size=2048, num_hidden_layers=18,
                 num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                 intermediate_size=16384, max_position_embeddings=8192,
                 rms_norm_eps=1e-6, mlp_activation="gelu_tanh",
                 rmsnorm_unit_offset=True, scale_embeddings=True,
                 tie_word_embeddings=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def qwen2_7b(cls, **kw):
        d = dict(vocab_size=152064, hidden_size=3584, num_hidden_layers=28,
                 num_attention_heads=28, num_key_value_heads=4,
                 intermediate_size=18944, max_position_embeddings=32768,
                 rms_norm_eps=1e-6, rope_theta=1000000.0,
                 attention_qkv_bias=True)
        d.update(kw)
        return cls(**d)
