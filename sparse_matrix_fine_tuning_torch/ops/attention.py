"""Causal attention's plain versions: the splash kernels' arithmetic (K17-K19).

The JAX model's ``_splash_attention`` (``sparse_matrix_fine_tuning_tpu/
models/llama.py:57``) runs JAX's splash-attention Pallas kernels: the
forward ``flash_attention_kernel``, ``_flash_attention_dq_kernel`` and
``_flash_attention_dkv_kernel`` (``jax/experimental/pallas/ops/tpu/
splash_attention/splash_attention_kernel.py``).  These functions compute
what those kernels compute, rounding where they round, over the whole
sequence at once; ``kernels/attention_cuda.py`` holds the CUDA kernels that
replace them and holds them against these.

Layout as the JAX function's: q, k, v and dout (b, t, heads, head_dim),
heads equal (the GQA repeat is the caller's), q already scaled by
``1/sqrt(head_dim)``; ``lse`` and ``di`` are float32 (b, heads, t).  The
mask is purely causal: key u attends to query s where u <= s.

  forward: s = q k^T with fp32 sums; p = exp(s - max) in fp32; v cast to
           fp32 for p v; o = (p v) * (1 / l) rounded once to q's dtype;
           lse = log l + max in fp32 (splash_attention_kernel.py:768-843).
  dq:      p = exp(s - lse); dp = dout v^T with fp32 sums; ds = p (dp - di);
           dq = round(ds) k with fp32 sums, rounded to q's dtype (:1384-1395).
  dk, dv:  dv = round(p)^T dout, dk = round(ds)^T q, fp32 sums, rounded to
           k's and v's dtype (:1788-1810).

``round`` is to the working dtype (a no-op in float32).  ``attention_di``
is ``di = rowsum(o * dout)`` in fp32, which the JAX backward computes
outside its kernels (:2285).  ``attention_cost`` counts what each kernel,
and a forward and backward step, must move and compute (their bounds).
"""

from __future__ import annotations

import torch


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Causal fp32 scores (b, h, t, t), -inf above the diagonal."""
    t = q.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def _probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """p = exp(s - lse), 0 where masked."""
    return torch.exp(_scores(q, k) - lse[..., None])


def attention_di(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * dout) in fp32: (b, t, h, d) -> (b, h, t)."""
    return (o.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


def causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K17's plain version: ``(o, lse)``, o in q's dtype, lse fp32 (b, h, t)."""
    s = _scores(q, k)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bhtd", p, v.float()) * (1.0 / l)
    return o.transpose(1, 2).to(q.dtype), (torch.log(l) + m).squeeze(-1)


def attention_dq_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor,
                           di: torch.Tensor) -> torch.Tensor:
    """K18's plain version: dq in q's dtype."""
    p = _probs(q, k, lse)
    dp = torch.einsum("bthd,bshd->bhts", dout.to(v.dtype).float(), v.float())
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def attention_dkv_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor,
                            di: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K19's plain version: ``(dk, dv)`` in k's and v's dtype."""
    p = _probs(q, k, lse)
    dof = dout.float()
    dv = torch.einsum("bhts,bthd->bshd", p.to(dout.dtype).float(), dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, v.float())
    ds = p * (dp - di[..., None])
    dk = torch.einsum("bhts,bthd->bshd", ds.to(dout.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_cost(name: str, shape: tuple, dtype: torch.dtype) -> tuple[float, float]:
    """(bytes, operations) of one K17 (``"splash_fwd"``), K18 (``"splash_dq"``)
    or K19 (``"splash_dkv"``) call at ``shape`` (b, t, heads, head_dim), or
    of a ``"step"``, the three together as a function of q, k and v.  Each
    (b, t, h, d) tensor read or written once (K17: q, k, v in, o out; K18:
    q, k, v, dout in, dq out; K19: the same in, dk and dv out; a step: q, k,
    v in, dq, dk, dv out) and the fp32 lse (and di) rows; the causal
    products over the t (t + 1) / 2 query-key pairs, two operations a
    multiply-add (K17: q k^T and P v; K18: those of s, dp and dq; K19: s,
    dp, dv and dk; a step: the forward's two and the backward's four, dv,
    dp, dq and dk)."""
    b, t, h, d = shape
    act, rows = b * t * h * d * torch.finfo(dtype).bits // 8, 4 * b * h * t
    pair_ops = 2 * d * b * h * t * (t + 1) / 2
    return {"splash_fwd": (4 * act + rows, 2 * pair_ops),
            "splash_dq": (5 * act + 2 * rows, 3 * pair_ops),
            "splash_dkv": (6 * act + 2 * rows, 4 * pair_ops),
            "step": (6 * act, 6 * pair_ops)}[name]
