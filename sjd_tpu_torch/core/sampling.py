"""Window-vectorized sampling primitives (sjd_tpu/core/sampling.py).

Sampling is Gumbel-max over the whole [B, W, V] window in float32. The
random draws are inputs, not hidden state: callers draw them from one
``torch.Generator`` per slot (:func:`slot_uniform`, :func:`slot_gumbel`,
:func:`slot_randint`), so a slot's trajectory depends on its own generator
alone, and a test can hand the JAX package's draws to the port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

Tensor = torch.Tensor
NEG_INF = float(torch.finfo(torch.float32).min)
_TINY = float(torch.finfo(torch.float32).tiny)


def slot_uniform(gens: Sequence[torch.Generator], shape, device) -> Tensor:
    """[B, *shape] float32 uniforms in [0, 1), row b from generator b."""
    return torch.stack([torch.rand(shape, generator=g, device=device) for g in gens])


def slot_gumbel(gens: Sequence[torch.Generator], shape, device) -> Tensor:
    """[B, *shape] standard Gumbel noise, -log(-log(u)) with u floored at the
    smallest normal float32 (jax.random.gumbel's form)."""
    u = slot_uniform(gens, shape, device).clamp_min_(_TINY)
    return -torch.log(-torch.log(u))


def slot_randint(gens: Sequence[torch.Generator], low: int, high: int, shape,
                 device) -> Tensor:
    """[B, *shape] int32 draws in [low, high)."""
    return torch.stack([
        torch.randint(low, high, shape, generator=g, device=device) for g in gens
    ]).to(torch.int32)


def sample_from_logits(gumbel: Tensor, logits: Tensor) -> Tensor:
    """Categorical sample over the last axis by Gumbel-max; ``gumbel`` has
    the shape of ``logits``."""
    safe = torch.clamp_min(logits.float(), NEG_INF)
    return torch.argmax(safe + gumbel, dim=-1).to(torch.int32)


def sample_from_probs(gumbel: Tensor, probs: Tensor) -> Tensor:
    """Categorical sample from (possibly unnormalized) probabilities."""
    logp = torch.log(torch.clamp_min(probs.float(), 1e-38))
    logp = torch.where(probs > 0, logp, NEG_INF)
    return sample_from_logits(gumbel, logp)


def kth_largest(scores: Tensor, k: Union[int, Tensor],
                k_max: Optional[int] = None) -> Tensor:
    """Exact per-row k-th largest value over the last axis: the value the
    sort-based k-th element has, ties included. ``k`` broadcasts against the
    row shape; ``k_max`` (an upper bound of k) is needed when k is a tensor.
    The JAX package's radix select was shaped for the TPU; ``torch.topk``
    gives the same value."""
    if isinstance(k, int):
        k_max = k
        k = torch.full(scores.shape[:-1], k, device=scores.device)
    vals = torch.topk(scores, k_max, dim=-1, sorted=True).values
    idx = torch.broadcast_to(k, scores.shape[:-1]).long() - 1
    return torch.gather(vals, -1, idx[..., None])[..., 0]


def top_k_dual(scores: Tensor, image_mode: Tensor, image_top_k: int,
               text_top_k: int) -> Tensor:
    """Interleaved top-k: image_top_k inside an image, else text_top_k,
    per sample. scores [B, W, V] f32, image_mode [B] bool."""
    V = scores.shape[-1]
    k_img, k_txt = min(image_top_k, V), min(text_top_k, V)
    k_row = torch.where(image_mode[:, None], k_img, k_txt)
    k_row = torch.broadcast_to(k_row, scores.shape[:-1])
    thr = kth_largest(scores, k_row, max(k_img, k_txt))
    return torch.where(scores < thr[..., None], NEG_INF, scores)


def top_p(scores: Tensor, p: float, min_tokens_to_keep: int = 1) -> Tensor:
    """Nucleus filter over the last axis (sjd_tpu's ``top_p``): sort
    ascending, take the softmax's running sum, remove the tail whose sum
    stays <= 1 - p (never the last ``min_tokens_to_keep``), and threshold at
    the smallest kept score. A sort, a cumsum and a gather: no host read,
    so the decode step's graph captures it."""
    sorted_scores = torch.sort(scores, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_scores, dim=-1), dim=-1)
    remove = cum <= (1.0 - p)
    if min_tokens_to_keep > 0:
        remove[..., -min_tokens_to_keep:] = False
    V = scores.shape[-1]
    n_removed = remove.sum(-1, keepdim=True).clamp_max(V - 1)
    thr = torch.gather(sorted_scores, -1, n_removed)
    return torch.where(scores < thr, NEG_INF, scores)


def onehot_probs(tokens: Tensor, vocab_size: int) -> Tensor:
    """One-hot 'distribution' at each token (fresh drafts' draft dist). A
    comparison rather than ``F.one_hot``, which checks the ids' range on the
    host on some devices: the decode step must never wait on the device."""
    vocab = torch.arange(vocab_size, device=tokens.device)
    return (tokens.long()[..., None] == vocab).float()
