"""Sharding rules for the decoder parameter tree (sjd_tpu/parallel/sharding.py).

A spec is a tuple of None / "data" / "model", one entry per tensor
dimension, equal to ``tuple(P)`` of the JAX package's PartitionSpec.
Megatron-style tensor parallelism falls out of the stacked-layer layout:

  wq/wk/wv  [L, H*Dh, d]  -> shard heads (out dim) on 'model'
  wo        [L, d, H*Dh]  -> shard the contracting dim on 'model' (sum)
  w_gate/up [L, ff, d]    -> shard ff (out dim) on 'model'
  w_down    [L, d, ff]    -> shard the contracting dim on 'model' (sum)
  qk-norm   [L, H, Dh]    -> per-head params shard with the heads
  embed / lm_head         -> shard vocab on 'model'

FSDP ('data'-axis parameter sharding) takes the largest unsharded dimension
that the data axis divides. ``apply_named_sharding`` lays a tree out as
DTensors; ``local_compute`` is how ``transformer.forward_train`` computes
with such a tree, where the JAX package leaves it to GSPMD: each leaf is
gathered over 'data' (FSDP's all-gather, once per forward, its backward a
reduce-scatter of the gradient) and stays split over 'model', where the
layer's collectives are explicit (:class:`ModelAxis`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.transformer import DecoderConfig, init_params
from .mesh import AXES, mesh_shape, shard

PyTree = Any
Spec = Tuple[Optional[str], ...]


def decoder_param_specs(cfg: DecoderConfig, *, tp: bool = True, fsdp: bool = False,
                        data_size: int = 0) -> Dict:
    m = "model" if tp else None
    layers = {
        "attn_norm": (None, None),
        "wq": (None, m, None),
        "wk": (None, m, None),
        "wv": (None, m, None),
        "wo": (None, None, m),
        "mlp_norm": (None, None),
        "w_gate": (None, m, None),
        "w_up": (None, m, None),
        "w_down": (None, None, m),
    }
    if cfg.qk_norm:
        for name in ("q_norm_scale", "q_norm_bias", "k_norm_scale", "k_norm_bias"):
            layers[name] = (None, m, None)
    specs = {"embed": (m, None), "layers": layers, "final_norm": (None,)}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (m, None)
    if fsdp:
        specs = add_fsdp_axis(_decoder_param_shapes(cfg), specs, data_size)
    return specs


def _decoder_param_shapes(cfg: DecoderConfig) -> Dict:
    """``init_params``' shapes without its memory (``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _tree_map(lambda t: tuple(t.shape), init_params(0, cfg, device="cpu"))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def add_fsdp_axis(shapes: PyTree, specs: PyTree, data_size: int) -> PyTree:
    """Add 'data' to the largest unsharded dimension of each leaf that
    ``data_size`` divides (FSDP FULL_SHARD that respects the 'model' axes
    already given); ``shapes``' leaves are shapes or tensors."""
    if data_size <= 0:
        raise ValueError("fsdp specs need data_size (the 'data' axis length)")

    def per_leaf(shape_leaf, spec: Spec) -> Spec:
        shape = _shape(shape_leaf)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        best, best_dim = 0, None
        for d, size in enumerate(shape):
            if parts[d] is None and size % data_size == 0 and size > best:
                best, best_dim = size, d
        if best_dim is not None:
            parts[best_dim] = "data"
        return tuple(parts)

    return _tree_map(per_leaf, shapes, specs)


def batch_specs() -> Spec:
    return ("data",)


def kv_cache_specs(*, tp: bool = True) -> Spec:
    """KV buffers [S, layers, L, Hkv, D]: batch on 'data', kv heads on 'model'."""
    return ("data", None, None, "model" if tp else None, None)


def _is_qdict(t) -> bool:
    return isinstance(t, dict) and ("q" in t or "q4p" in t)


def expand_specs_for_quantized(params: PyTree, specs: PyTree) -> PyTree:
    """Match name -> spec trees to quantized parameter trees: over a
    quantized leaf ({"q" or "q4p", "s"}) the values keep the weight's spec
    and the per-out-channel scales keep its leading entries."""
    if _is_qdict(params):
        key = "q" if "q" in params else "q4p"
        return {key: specs, "s": tuple(specs)[:params["s"].ndim]}
    if isinstance(params, dict):
        return {k: expand_specs_for_quantized(v, specs[k]) for k, v in params.items()}
    return specs


def apply_named_sharding(mesh, params: PyTree, specs: PyTree) -> PyTree:
    """Lay a tree out on ``mesh`` as DTensors, each leaf by its spec
    (``mesh.shard``'s placements). Every rank passes the same global tree.
    On a one-process mesh without a process group the tree comes back as
    it is."""
    if mesh.mesh.numel() == 1 and not dist.is_initialized():
        return params
    from torch.distributed.tensor import distribute_tensor

    return _tree_map(lambda x, s: distribute_tensor(x.detach(), mesh, shard(mesh, s)),
                     params, specs)


# ---------------------------------------------------------------------------
# Computing with a sharded tree
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the model axis' sum of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The model axis' sum forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model axis' shards joined along the last dimension forward; this
    rank's shard of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None, None, None


class ModelAxis:
    """Megatron-style collectives of the 'model' axis for
    ``transformer.train_layer``: a column-parallel block's input enters
    through :meth:`enter`, a row-parallel block's partial output leaves
    through :meth:`reduce`; the vocabulary-parallel embedding masks the ids
    outside this rank's rows and sums, the vocabulary-parallel head's
    logits are gathered whole."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def enter(self, x):
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x):
        return _ReduceFromModel.apply(x, self.group)

    def gather_vocab(self, logits):
        return _GatherFromModel.apply(logits, self.group, self.rank, self.size)

    def embed(self, table, ids, dtype):
        n = table.shape[0]
        local = ids.long() - self.rank * n
        inside = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
        return self.reduce(rows.to(dtype))


def _named_leaves(tree, prefix: str = ""):
    """("embed", t), ("layers.wq", t), ... of a nested dict; a quantized
    leaf's tensors as "layers.wq.q", "layers.wq.s"."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def local_compute(params: PyTree, cfg: DecoderConfig):
    """(tree of local tensors, :class:`ModelAxis` or None) for a forward.
    A tree without DTensors comes back as it is. Each DTensor leaf is
    gathered over 'data' and keeps its 'model' shard; its gradient flows
    back as a sum over 'data' (the ranks hold different rows of the batch),
    reduce-scattered into the leaf's own layout. The 'model' axis computes
    tensor-parallel when the leaves are split on it as
    ``decoder_param_specs(tp=True)`` says; a tree replicated over 'model'
    runs whole on each of its ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    leaves = list(_named_leaves(params))
    sharded = [t for _, t in leaves if isinstance(t, DTensor)]
    if not sharded:
        return params, None
    if len(sharded) != len(leaves):
        raise ValueError("a parameter tree is either all DTensors or none")
    mesh = sharded[0].device_mesh
    if tuple(mesh.mesh_dim_names) != AXES:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names}, not {AXES}")
    m = mesh_shape(mesh)["model"]
    tp_on = any(isinstance(t.placements[1], Shard) for t in sharded)
    if tp_on:
        if cfg.num_heads % m or cfg.num_kv_heads % m:
            raise ValueError(f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads "
                             f"do not split over model={m}")
        expected = dict(_named_leaves(decoder_param_specs(cfg, tp=True)))
        for name, t in leaves:
            if name.rsplit(".", 1)[-1] in ("q", "q4p", "s"):
                raise NotImplementedError("quantized leaves run tensor-parallel only in "
                                          "the JAX package; here they run on one process")
            if shard(mesh, expected[name])[1] != t.placements[1]:
                raise ValueError(f"{name} is laid out {t.placements}, not as "
                                 f"decoder_param_specs(tp=True) says")
            pl = t.placements[1]
            if isinstance(pl, Shard) and t.shape[pl.dim] % m:
                raise ValueError(f"{name}: dim {pl.dim} of {tuple(t.shape)} "
                                 f"does not split over model={m}")

    def local(t):
        keep = t.placements[1]
        return t.redistribute(mesh, (Replicate(), keep)).to_local(
            grad_placements=(Partial(), keep))

    out = _tree_map(local, params)
    tp = ModelAxis(mesh.get_group("model"), mesh.get_local_rank("model"), m) if tp_on else None
    return out, tp
