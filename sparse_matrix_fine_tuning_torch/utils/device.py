"""The port's default device.

Every entry point that creates tensors from nothing (``LlamaForCausalLM``,
``MonarchLinear`` without ``weights``, ``init_caches``, ``Trainer``, ...)
builds on the card unless its caller passes ``device="cpu"``, as the CPU
tests do.  The default does not look for a card: where there is none, the
first tensor made on it fails, and nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``torch.device("cuda")`` when None."""
    return torch.device("cuda") if device is None else torch.device(device)


def harness_device(args) -> torch.device:
    """A harness's device: the card unless its ``--platform`` is "cpu"."""
    return resolve_device("cpu" if args.platform == "cpu" else None)


def seeded_generator(device: torch.device, generator: Optional[torch.Generator] = None,
                     seed: int = 0) -> torch.Generator:
    """``generator``, or a fresh one on ``device`` seeded with ``seed``."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def trial_devices(parallel_trials: int, device: torch.device) -> Optional[list]:
    """The cards that a search's concurrent trials are pinned to
    (``training/hpo.py``): every card of the host where more than one trial
    runs at a time on the card, else None."""
    if parallel_trials > 1 and device.type == "cuda":
        return list(range(torch.cuda.device_count()))
    return None
