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

For decoding, ``shard_params`` (or ``init_params_sharded``, the
counterpart of ``jax.jit(init_params, out_shardings=...)``) gives each rank
its own :class:`LocalParams`: plain tensors, the rank's shard of every leaf
and the :class:`ModelAxis` of its mesh, which ``transformer.forward`` takes
as it is (``local_tree`` makes one from a DTensor tree). A packed int4 leaf
split on its contracting dimension (``wo``, ``w_down``) is repacked: its
bytes hold columns j and j + K/2 together, so a slice of the bytes is not
a slice of the columns; the rank's columns are unpacked, sliced and packed
again, split-half within the slice (JAX's GSPMD unpacks the logical array
instead).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..models.transformer import DecoderConfig, check_kernel_head_dim, init_params
from ..ops.quant_linear import unpack_int4
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


class _MaxFromModel(torch.autograd.Function):
    """The model axis' maximum forward; the gradient to the ranks whose
    value is the maximum backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(x == out)
        return out

    @staticmethod
    def backward(ctx, g):
        (held,) = ctx.saved_tensors
        return g * held.to(g.dtype), None


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
    ``transformer.forward`` and ``transformer.train_layer``: a
    column-parallel block's input enters through :meth:`enter`, a
    row-parallel block's partial output leaves through :meth:`reduce`; the
    vocabulary-parallel embedding masks the ids outside this rank's rows and
    sums, the vocabulary-parallel head's logits are gathered whole
    (:meth:`gather_vocab`), and a row-parallel int8-activation product takes
    its per-token amax over the whole row (:meth:`amax`). With autograd on
    they are the autograd Functions above; under ``torch.no_grad`` (the
    decode forward) plain in-place ``all_reduce`` / ``all_gather_into_tensor``
    on the tensor given, which the caller hands over."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def enter(self, x):
        return _CopyToModel.apply(x, self.group) if torch.is_grad_enabled() else x

    def reduce(self, x):
        if torch.is_grad_enabled():
            return _ReduceFromModel.apply(x, self.group)
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def amax(self, a):
        """The maximum over the model axis of a per-token amax [..., 1]."""
        if torch.is_grad_enabled() and a.requires_grad:
            return _MaxFromModel.apply(a, self.group)
        a = a.contiguous()
        dist.all_reduce(a, op=dist.ReduceOp.MAX, group=self.group)
        return a

    def gather_vocab(self, logits):
        if torch.is_grad_enabled():
            return _GatherFromModel.apply(logits, self.group, self.rank, self.size)
        x = logits.contiguous()
        out = self._gather(x)
        return torch.movedim(out, 0, -2).reshape(*x.shape[:-1], -1)

    def _gather(self, x):
        """[size, *x.shape]: every rank's ``x`` (gloo takes the output
        concatenated along dimension 0)."""
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out.view((self.size,) + tuple(x.shape))

    def embed(self, table, ids, dtype):
        """The vocabulary-parallel lookup from a bf16 table or the int8 one
        ({"q", "s"}: the rows dequantized as ``transformer.embed_lookup``
        does): rows outside this rank's shard are zero, so the sum over the
        axis is exact."""
        q = table["q"] if isinstance(table, dict) else table
        n = q.shape[0]
        local = ids.long() - self.rank * n
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        if isinstance(table, dict):
            rows = q[idx].float() * table["s"][idx].float()[..., None]
        else:
            rows = q[idx]
        rows = rows * inside[..., None].to(rows.dtype)
        return self.reduce(rows.to(dtype))

    def check_equal(self, t, what: str) -> None:
        """Raise unless ``t`` is the same on every rank of the axis (the
        decode loop's end-of-call check: ranks that drift apart are a
        fault, never averaged away)."""
        x = t.to(torch.int64 if not t.is_floating_point() else t.dtype).reshape(1, -1)
        out = self._gather(x.contiguous())
        if not bool((out == out[:1]).all()):
            raise RuntimeError(f"the model axis' ranks disagree on {what}: a host-side "
                               "choice differed between them")


class LocalParams(dict):
    """One rank's parameter tree of plain tensors (its shard of each leaf)
    with the :class:`ModelAxis` of its mesh (``axis``, None when the model
    axis has one rank): what ``transformer.forward`` computes with."""

    def __init__(self, tree, axis: Optional[ModelAxis] = None, mesh=None):
        super().__init__(tree)
        self.axis = axis
        self.mesh = mesh

    @property
    def model_size(self) -> int:
        return 1 if self.axis is None else self.axis.size


def _named_leaves(tree, prefix: str = ""):
    """("embed", t), ("layers.wq", t), ... of a nested dict; a quantized
    leaf's tensors as "layers.wq.q", "layers.wq.s"."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# Each rank's shard as plain tensors (the decode path)
# ---------------------------------------------------------------------------


def _coords(mesh) -> Dict[str, Tuple[int, int]]:
    """{axis: (this rank's index, the axis' size)}."""
    shape = mesh_shape(mesh)
    return {a: (mesh.get_local_rank(a) if n > 1 else 0, n) for a, n in shape.items()}


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 codes in [-8, 7] -> [..., K/2] uint8, split-half: byte
    column j holds column j in its low nibble and column j + K/2 in its
    high one (``transformer.quantize_int4``'s packing)."""
    K = codes.shape[-1]
    lo, hi = codes[..., : K // 2], codes[..., K // 2:]
    return (lo & 0xF).to(torch.uint8) | (hi.to(torch.uint8) << 4)


def packed_column_shard(q4p: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """Columns [index K/size, (index + 1) K/size) of a packed int4 leaf
    [.., N, K/2], packed split-half within the slice: what the rank's K1
    product multiplies its local columns with. One layer at a time, so the
    unpacked temporaries stay one layer's size."""
    K = 2 * q4p.shape[-1]
    if K % (2 * size):
        raise ValueError(f"{K} packed int4 columns do not split into {size} even halves")
    n = K // size

    def one(t):
        return pack_int4(unpack_int4(t).narrow(-1, index * n, n))

    if q4p.dim() == 3:
        return torch.stack([one(t) for t in q4p])
    return one(q4p)


def _shard_tensor(t: torch.Tensor, spec: Spec, coords, packed: bool = False) -> torch.Tensor:
    """This rank's shard of one tensor by its spec, as a tensor of its own
    (a view would keep the global leaf alive); ``packed``: the last
    dimension is packed int4 (:func:`packed_column_shard`)."""
    out = t
    for d, axis in enumerate(spec):
        index, size = coords[axis] if axis is not None else (0, 1)
        if size == 1:
            continue
        if packed and d == t.dim() - 1:
            out = packed_column_shard(out, index, size)
            continue
        if out.shape[d] % size:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over "
                             f"{axis}={size}")
        n = out.shape[d] // size
        out = out.narrow(d, index * n, n)
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def _model_axis(mesh, coords) -> Optional[ModelAxis]:
    index, size = coords["model"]
    return ModelAxis(mesh.get_group("model"), index, size) if size > 1 else None


def shard_params(params: PyTree, mesh, specs: PyTree,
                 cfg: Optional[DecoderConfig] = None) -> LocalParams:
    """This rank's :class:`LocalParams` of a global tree that every rank
    holds: each leaf's shard by ``specs`` (``decoder_param_specs``; quantized
    leaves take ``expand_specs_for_quantized``'s), the per-row scales of a
    row-parallel leaf whole, a packed int4 leaf split on its contracting
    dimension repacked. The tree is consumed leaf by leaf: each global leaf
    is taken out of its dict once its shard is made, so a rank's peak is its
    shard plus one global leaf when no one else holds the tree (pass
    ``copy_tree(params)`` to keep it). With ``cfg`` the head split is
    checked against the kernels first (``check_kernel_head_dim``)."""
    coords = _coords(mesh)
    if cfg is not None:
        check_kernel_head_dim(cfg, mesh.device_type, model_size=coords["model"][1])
    specs = expand_specs_for_quantized(params, specs)

    def walk(tree, spec, packed=False):
        out = {}
        for k in list(tree):
            v = tree.pop(k)
            if isinstance(v, dict):
                out[k] = walk(v, spec[k], packed="q4p" in v)
            else:
                out[k] = _shard_tensor(v, spec[k], coords, packed and k == "q4p")
            del v
        return out

    return LocalParams(walk(params, specs), _model_axis(mesh, coords), mesh)


def copy_tree(tree: PyTree) -> PyTree:
    """The nested dicts of a tree anew, over the same tensors."""
    return _tree_map(lambda t: t, tree)


_DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed", "lm_head")


def init_params_sharded(rng, cfg: DecoderConfig, mesh, *, device=None) -> LocalParams:
    """``init_params`` drawn straight into this rank's shards by
    ``decoder_param_specs(cfg, tp=True)`` (the counterpart of
    ``jax.jit(init_params, out_shardings=...)``): every rank draws the same
    global weights from the same seed, one stacked leaf at a time, and
    keeps its shard of each as soon as it is drawn."""
    dev = resolve_device(device)
    specs = decoder_param_specs(cfg, tp=True)
    coords = _coords(mesh)
    check_kernel_head_dim(cfg, dev, model_size=coords["model"][1])
    by_name = {name.rsplit(".", 1)[-1]: spec for name, spec in _named_leaves(specs)}
    tree = init_params(rng, cfg, device=dev,
                       leaf_fn=lambda name, w: _shard_tensor(w, by_name[name], coords))
    # the leaves drawn without leaf_fn: norms and qk-norm affines
    for name in list(tree["layers"]):
        if name not in _DENSE:
            tree["layers"][name] = _shard_tensor(tree["layers"][name],
                                                 specs["layers"][name], coords)
    return LocalParams(tree, _model_axis(mesh, coords), mesh)


# ---------------------------------------------------------------------------
# Computing with a DTensor tree
# ---------------------------------------------------------------------------


def _tree_cfg(params: PyTree, cfg: Optional[DecoderConfig]):
    """What ``decoder_param_specs`` reads of a config, from the tree when
    no config is given."""
    if cfg is not None:
        return cfg
    import types

    return types.SimpleNamespace(qk_norm="q_norm_scale" in params["layers"],
                                 tie_word_embeddings="lm_head" not in params)


def local_compute(params: PyTree, cfg: Optional[DecoderConfig] = None):
    """(tree of local tensors, :class:`ModelAxis` or None) for a forward.
    A tree without DTensors comes back as it is. Each DTensor leaf is
    gathered over 'data' and keeps its 'model' shard; its gradient flows
    back as a sum over 'data' (the ranks hold different rows of the batch),
    reduce-scattered into the leaf's own layout. The 'model' axis computes
    tensor-parallel when the leaves are split on it as
    ``decoder_param_specs(tp=True)`` says (quantized leaves as
    ``expand_specs_for_quantized`` says); a tree replicated over 'model'
    runs whole on each of its ranks. A packed int4 leaf split on 'model'
    along its contracting dimension is gathered whole and its rank's
    columns repacked (:func:`packed_column_shard`). A :class:`LocalParams`
    comes back with its axis. ``cfg`` (optional: the forward checks the
    heads itself) checks the head split up front."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if isinstance(params, LocalParams):
        return params, params.axis
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
    packed_cols = set()
    if tp_on:
        if cfg is not None and (cfg.num_heads % m or cfg.num_kv_heads % m):
            raise ValueError(f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads "
                             f"do not split over model={m}")
        expected = dict(_named_leaves(expand_specs_for_quantized(
            params, decoder_param_specs(_tree_cfg(params, cfg), tp=True))))
        for name, t in leaves:
            if shard(mesh, expected[name])[1] != t.placements[1]:
                raise ValueError(f"{name} is laid out {t.placements}, not as "
                                 f"decoder_param_specs(tp=True) says")
            pl = t.placements[1]
            if isinstance(pl, Shard) and t.shape[pl.dim] % m:
                raise ValueError(f"{name}: dim {pl.dim} of {tuple(t.shape)} "
                                 f"does not split over model={m}")
            if name.endswith(".q4p") and isinstance(pl, Shard) and pl.dim == t.dim() - 1:
                packed_cols.add(id(t))
    rank = mesh.get_local_rank("model") if m > 1 else 0

    def local(t):
        if id(t) in packed_cols:
            return packed_column_shard(t.full_tensor(), rank, m)
        keep = t.placements[1]
        return t.redistribute(mesh, (Replicate(), keep)).to_local(
            grad_placements=(Partial(), keep))

    out = _tree_map(local, params)
    tp = ModelAxis(mesh.get_group("model"), rank, m) if tp_on else None
    return out, tp


def local_tree(params: PyTree, cfg: Optional[DecoderConfig] = None) -> PyTree:
    """What ``transformer.forward`` computes with: a :class:`LocalParams`
    as it is, a DTensor tree made local (:func:`local_compute`, without
    autograd) with its mesh's :class:`ModelAxis`, a plain tree as it is.
    The engine calls it once per params object and keeps the result."""
    if isinstance(params, LocalParams) or not _has_dtensors(params):
        return params
    with torch.no_grad():
        local, tp = local_compute(params, cfg)
    first = next(t for _, t in _named_leaves(params))
    return LocalParams(local, tp, first.device_mesh)


def _has_dtensors(params: PyTree) -> bool:
    from torch.distributed.tensor import DTensor

    if not isinstance(params, dict) or "embed" not in params:
        return False
    e = params["embed"]
    return isinstance(e["q"] if isinstance(e, dict) else e, DTensor)
