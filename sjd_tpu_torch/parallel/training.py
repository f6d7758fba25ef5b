"""Sharded fine-tuning (sjd_tpu/parallel/training.py).

What it computes is the JAX package's train step:

  * CE with z-loss (the mean over labelled positions of logsumexp^2) and the
    optional image-logit mask;
  * optax's ``chain(clip_by_global_norm, adamw)`` with the warmup-cosine
    schedule, wrapped in ``MultiSteps`` when ``grad_accum > 1``:
      - the weight-decay mask is ``x.ndim >= 2`` on the STACKED tree, so the
        per-layer norms ``[L, d]`` and qk-norm leaves ``[L, H, Dh]`` are
        decayed and only ``final_norm`` is not;
      - the gradients are scaled by ``max_norm / norm`` only when
        ``norm >= max_norm`` (no epsilon);
      - the schedule is read at the optimizer's count before the update,
        so the first update has the schedule's value at 0;
      - ``k`` micro-gradients are averaged and the update happens on every
        ``k``-th call, where the schedule's count advances once; the
        metrics' ``grad_norm`` is the micro-batch's, before clipping;
  * moments in the parameters' dtype, no f32 master copy.

The update itself is ``torch.optim.AdamW`` (fused on CUDA), whose
arithmetic is optax's in another order of operations. ``make_train_step``
lays the parameters out on a ``parallel.mesh`` mesh by
``parallel.sharding``'s specs; on a 1 x 1 mesh they stay plain tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..models import transformer
from ..models.transformer import DecoderConfig
from . import sharding as sharding_lib
from .mesh import mesh_shape
from .sharding import _named_leaves

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    min_lr_ratio: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    z_loss_weight: float = 1e-5
    grad_accum: int = 1
    # image-token logits set to the dtype's minimum before the loss
    # (text-only fine-tuning); the span is Chameleon's
    mask_image_logits: bool = False
    image_vocab_start: int = 4
    image_vocab_end: int = 8195


def _f32(x) -> Tensor:
    return torch.tensor(x, dtype=torch.float32)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable:
    """optax's ``warmup_cosine_decay_schedule``, step for step in float32:
    a linear ramp from ``init_value`` over ``warmup_steps``, then a cosine
    from ``peak_value`` to ``end_value`` over ``decay_steps - warmup_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine decay needs positive steps, got "
                         f"{decay_steps - warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def warmup(count: int) -> Tensor:
        if warmup_steps <= 0:
            return _f32(init_value)
        c = torch.tensor(min(max(count, 0), warmup_steps), dtype=torch.int32)
        frac = 1 - c / warmup_steps
        return _f32(init_value - peak_value) * frac + _f32(peak_value)

    def cosine(count: int) -> Tensor:
        c = torch.minimum(torch.tensor(count, dtype=torch.int32).float(), _f32(cos_steps))
        decay = _f32(0.5) * (1 + torch.cos(_f32(math.pi) * c / _f32(cos_steps)))
        return _f32(peak_value) * (_f32(1 - alpha) * decay + _f32(alpha))

    def schedule(count: int) -> float:
        return float(warmup(count) if count < warmup_steps else cosine(count - warmup_steps))

    return schedule


def make_lr_schedule(cfg: TrainConfig) -> Callable:
    # the warmup clamped below half the run (optax refuses a cosine of no steps)
    warmup = min(cfg.warmup_steps, max(cfg.total_steps // 2, 1))
    return warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup, cfg.total_steps,
                                        cfg.learning_rate * cfg.min_lr_ratio)


class Optimizer:
    """The optax chain of :func:`make_optimizer` with its state: AdamW's
    moments (made at once, as ``tx.init`` makes them), MultiSteps'
    ``mini_step`` and ``gradient_step`` (the schedule's count), and the
    accumulated gradients, which live in the parameters' ``.grad`` as a
    sum until the k-th call divides them by k."""

    def __init__(self, cfg: TrainConfig, params: PyTree):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.names = dict(_named_leaves(params))
        self.sharded = any(map(_is_dtensor, self.names.values()))
        fused = not self.sharded and next(iter(self.names.values())).is_cuda
        self.adamw = torch.optim.AdamW(
            [{"params": [p for p in self.names.values() if p.ndim >= 2],
              "weight_decay": cfg.weight_decay},
             {"params": [p for p in self.names.values() if p.ndim < 2], "weight_decay": 0.0}],
            lr=0.0, betas=(0.9, 0.95), eps=1e-8, fused=fused or None)
        for p in self.names.values():
            self.adamw.state[p] = {
                "step": (torch.zeros((), dtype=torch.float32, device=p.device) if fused
                         else torch.tensor(0.0, dtype=torch.float32)),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        self.mini_step = 0
        self.gradient_step = 0

    def update(self) -> None:
        """One call's share of the chain, after the micro-batch's backward
        has added its gradients to ``.grad``."""
        k = self.cfg.grad_accum
        self.mini_step += 1
        if self.mini_step < k:
            return
        grads = [p.grad for p in self.names.values()]
        if k > 1:
            for g in grads:
                g.div_(k)
        norm = float(global_norm(grads))
        if not norm < self.cfg.grad_clip:
            for g in grads:  # t / norm in t's dtype, then * max_norm (optax)
                g.div_(float(torch.tensor(norm, dtype=g.dtype))).mul_(self.cfg.grad_clip)
        lr = self.schedule(self.gradient_step)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.mini_step = 0
        self.gradient_step += 1

    def state_dict(self) -> dict:
        """Tensors that share storage with the state (a checkpoint's
        template); with accumulation also the gradients summed so far
        (zeros between updates)."""
        out = {"mini_step": torch.tensor(self.mini_step),
               "gradient_step": torch.tensor(self.gradient_step),
               "moments": {n: {k: v.detach() for k, v in self.adamw.state[p].items()}
                           for n, p in self.names.items()}}
        if self.cfg.grad_accum > 1:
            out["acc_grads"] = {n: torch.zeros_like(p.detach()) if p.grad is None else p.grad
                                for n, p in self.names.items()}
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Take over ``sd``, a :meth:`state_dict` whose tensors were loaded in
        place: the counters, and the accumulated gradients mid-window."""
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])
        for n, p in self.names.items():
            p.grad = sd["acc_grads"][n] if self.mini_step else None


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _sq_norm(g: Tensor) -> Tensor:
    """This rank's share of ``sum(g**2)`` in float32: a DTensor's local
    shard, divided by the ranks that hold the same shard."""
    if not _is_dtensor(g):
        return torch.linalg.vector_norm(g, dtype=torch.float32).square()
    from torch.distributed.tensor import Replicate

    copies = math.prod(g.device_mesh.mesh.shape[i] for i, pl in enumerate(g.placements)
                       if isinstance(pl, Replicate))
    return torch.linalg.vector_norm(g.to_local(), dtype=torch.float32).square() / copies


def _sum_over_ranks(x: Tensor, group) -> Tensor:
    """The sum of ``x`` over ``group``'s ranks; ``None``: this rank alone."""
    if group is not None and dist.is_initialized() and dist.get_world_size(group) > 1:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x


def _norm_from_squares(squares: list, sharded: bool) -> Tensor:
    local = sum(squares)
    return torch.sqrt(_sum_over_ranks(local, dist.group.WORLD) if sharded else local)


def global_norm(grads) -> Tensor:
    """optax's ``global_norm``: sqrt of the sum of every element squared,
    over every rank's shards."""
    return _norm_from_squares([_sq_norm(g) for g in grads], any(map(_is_dtensor, grads)))


def make_optimizer(cfg: TrainConfig, params: PyTree) -> Optimizer:
    return Optimizer(cfg, params)


def _loss_sums(logits: Tensor, labels: Tensor, train_cfg: TrainConfig):
    """(-sum of the labelled tokens' log-probabilities, sum of their
    logsumexp^2, count of labelled tokens) of next-token prediction."""
    if train_cfg.mask_image_logits:
        v = torch.arange(logits.shape[-1], device=logits.device)
        is_img = (v >= train_cfg.image_vocab_start) & (v <= train_cfg.image_vocab_end)
        logits = torch.where(is_img, torch.finfo(logits.dtype).min, logits)
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    valid = targets != -100
    tgt = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    tok_logp = logits.gather(-1, tgt[..., None])[..., 0] - logz
    return -(tok_logp * valid).sum(), ((logz ** 2) * valid).sum(), valid.sum()


def loss_fn(params: PyTree, model_cfg: DecoderConfig, train_cfg: TrainConfig, ids: Tensor,
            labels: Tensor, attn_mask: Optional[Tensor], rope_table: Tensor
            ) -> Tuple[Tensor, dict]:
    """(loss, {"ce", "z_loss", "n_tokens"}): CE plus ``z_loss_weight`` times
    the mean of logsumexp^2 over the labelled positions (-100 = ignored);
    the logits at position t predict the label at t + 1."""
    B, T = ids.shape
    positions = torch.arange(T, device=ids.device)[None].expand(B, T)
    logits = transformer.forward_train(params, model_cfg, ids, positions,
                                       attn_mask=attn_mask, rope_table=rope_table)
    nll, z, n = _loss_sums(logits, labels, train_cfg)
    ce, z_loss = nll / torch.clamp_min(n, 1), z / torch.clamp_min(n, 1)
    return ce + train_cfg.z_loss_weight * z_loss, {"ce": ce, "z_loss": z_loss, "n_tokens": n}


class TrainState(NamedTuple):
    params: PyTree
    opt_state: Optimizer
    step: int

    def state_dict(self) -> dict:
        """Tensors sharing storage with the state: what a checkpoint holds."""
        return {"step": torch.tensor(self.step),
                "params": {n: p.detach() for n, p in _named_leaves(self.params)},
                "opt_state": self.opt_state.state_dict()}

    def load_state_dict(self, sd: dict) -> "TrainState":
        """This state after ``sd``'s tensors were loaded into
        :meth:`state_dict`'s: the counters taken over."""
        self.opt_state.load_state_dict(sd["opt_state"])
        return self._replace(step=int(sd["step"]))


def make_train_step(mesh, model_cfg: DecoderConfig, train_cfg: TrainConfig, *,
                    tp: bool = True, fsdp: bool = True, device=None
                    ) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn).

    ``init_fn(rng, params=None)``: a :class:`TrainState` whose parameters
    (drawn by ``transformer.init_params`` from ``rng``, a seed or a
    ``torch.Generator``, or the global tree ``params``) are laid out by the
    TP/FSDP specs on ``mesh``.

    ``step_fn(state, ids, labels, attn_mask) -> (state, metrics)``: the
    global batch on every rank; each keeps the rows of its 'data' index.
    The loss is the global batch's, its gradient summed over 'data', the
    update applied in place (the state passed in is consumed, as the JAX
    step donates it). ``metrics``: ``loss``, ``grad_norm``, ``ce``,
    ``z_loss``, ``n_tokens``; ``state.step`` counts calls."""
    dev = resolve_device(device)
    shape = mesh_shape(mesh)
    data = shape["data"]
    pspecs = sharding_lib.decoder_param_specs(model_cfg, tp=tp, fsdp=fsdp, data_size=data)
    rope = transformer.make_rope_table(model_cfg, device=dev)
    data_group = mesh.get_group("data") if dist.is_initialized() and data > 1 else None
    data_rank = mesh.get_local_rank("data") if data_group is not None else 0
    sq_norms: list = []

    def init_fn(rng=0, params: Optional[PyTree] = None) -> TrainState:
        if params is None:
            params = transformer.init_params(rng, model_cfg, device=dev)
        params = sharding_lib.apply_named_sharding(mesh, params, pspecs)
        for _, p in _named_leaves(params):
            p.requires_grad_(True)
            p.register_hook(lambda g: sq_norms.append(_sq_norm(g)))
        return TrainState(params=params, opt_state=make_optimizer(train_cfg, params), step=0)

    def step_fn(state: TrainState, ids: Tensor, labels: Tensor, attn_mask: Tensor):
        B = ids.shape[0]
        if B % data:
            raise ValueError(f"batch {B} does not split over data={data}")
        rows = slice(data_rank * (B // data), (data_rank + 1) * (B // data))
        ids, labels, attn_mask = (x[rows].to(dev) for x in (ids, labels, attn_mask))
        positions = torch.arange(ids.shape[1], device=dev)[None].expand(ids.shape)
        logits = transformer.forward_train(state.params, model_cfg, ids, positions,
                                           attn_mask=attn_mask, rope_table=rope)
        nll, z, n = _loss_sums(logits, labels, train_cfg)
        n_all = _sum_over_ranks(n.detach(), data_group)
        ce = nll / torch.clamp_min(n_all, 1)
        z_loss = z / torch.clamp_min(n_all, 1)
        loss = ce + train_cfg.z_loss_weight * z_loss
        sq_norms.clear()
        loss.backward()
        gnorm = _norm_from_squares(sq_norms, state.opt_state.sharded)
        state.opt_state.update()
        parts = _sum_over_ranks(torch.stack([loss.detach(), ce.detach(), z_loss.detach()]),
                                data_group)
        metrics = {"loss": parts[0], "grad_norm": gnorm, "ce": parts[1], "z_loss": parts[2],
                   "n_tokens": n_all}
        return state._replace(step=state.step + 1), metrics

    return init_fn, step_fn
