"""Checkpoint reading and porting (sjd_tpu/utils/port.py): torch / HF state
dicts on disk -> the port's parameter trees.

Reading needs no package beyond torch and numpy:

  * ``.safetensors`` is parsed here (an 8-byte little-endian header length,
    a JSON header, then the raw bytes). :class:`SafetensorsFile` reads a
    tensor from disk only when it is indexed, into a buffer of its own, so
    a port that copies each tensor to the device as it goes holds one
    tensor on the host at a time, and bf16 stays bf16 (the JAX package
    goes through f32, since numpy has no bf16).
  * ``.bin``, ``.pt``, ``.pth`` and ``.ckpt`` go through ``torch.load``
    (memory-mapped), unwrapping a ``model`` / ``module`` / ``state_dict``
    nesting.

Porting covers the HF LLaMA-family naming (Chameleon / Lumina-mGPT, Anole,
Emu3) and LlamaGen's gpt-fast naming. Every stacked ``[NL, ...]`` leaf is
allocated on the target device and filled one layer at a time.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from collections import ChainMap
from typing import Any, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

Tensor = torch.Tensor

# safetensors dtype -> torch dtype (BF16 is read as raw bytes and viewed)
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


class SafetensorsFile(Mapping):
    """A ``.safetensors`` file as a read-only mapping of name -> CPU tensor.
    The header is parsed when the file is opened; each tensor is read from
    disk when it is indexed (a fresh tensor per access, nothing cached)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._base = 8 + n
        self._meta = {k: v for k, v in header.items() if k != "__metadata__"}
        for name, m in self._meta.items():
            if m["dtype"] not in SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {m['dtype']}, which "
                                 f"is not one of {sorted(SAFETENSORS_DTYPES)}")

    def __getitem__(self, name: str) -> Tensor:
        m = self._meta[name]
        dtype = SAFETENSORS_DTYPES[m["dtype"]]
        start, end = m["data_offsets"]
        buf = torch.empty((end - start,), dtype=torch.uint8)
        if end > start:
            with open(self.path, "rb") as f:
                f.seek(self._base + start)
                got = f.readinto(memoryview(buf.numpy()))
            if got != end - start:
                raise ValueError(f"{self.path}: tensor {name!r} is truncated")
        return buf.view(dtype).reshape(m["shape"])

    def __iter__(self) -> Iterator[str]:
        return iter(self._meta)

    def __len__(self) -> int:
        return len(self._meta)


def load_torch_checkpoint(path: str) -> Mapping[str, Any]:
    """A checkpoint file as a name -> tensor mapping: ``.safetensors`` lazily
    (:class:`SafetensorsFile`), anything else through ``torch.load`` on the
    CPU, memory-mapped, with the DDP / deepspeed / Lightning nesting
    (``module`` / ``model`` / ``state_dict``) removed."""
    if path.endswith(".safetensors"):
        return SafetensorsFile(path)
    blob = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    for key in ("model", "module", "state_dict"):
        if isinstance(blob, dict) and key in blob:
            blob = blob[key]
            break
    return blob


def checkpoint_files(ckpt_dir: str) -> List[str]:
    """The checkpoint's files, in the JAX loader's precedence:
    ``*.safetensors``, then ``pytorch_model*.bin``, then ``*.pt``, then
    ``*.pth``."""
    files = sorted(
        glob.glob(os.path.join(ckpt_dir, "*.safetensors"))
        or glob.glob(os.path.join(ckpt_dir, "pytorch_model*.bin"))
        or glob.glob(os.path.join(ckpt_dir, "*.pt"))
        or glob.glob(os.path.join(ckpt_dir, "*.pth")))
    if not files:
        raise FileNotFoundError(f"no checkpoint files under {ckpt_dir}")
    return files


def load_sharded_state(ckpt_dir: str) -> Mapping[str, Any]:
    """Every shard of a checkpoint directory as one mapping (later shards
    win on a repeated name, as the JAX loader's ``dict.update``)."""
    return ChainMap(*reversed([load_torch_checkpoint(f) for f in checkpoint_files(ckpt_dir)]))


# ---------------------------------------------------------------------------
# porting
# ---------------------------------------------------------------------------


def as_tensor(x) -> Tensor:
    """A state-dict value (torch tensor or numpy array) as a torch tensor."""
    if isinstance(x, Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _leaf(x, dtype, device) -> Tensor:
    return as_tensor(x).to(device=device, dtype=dtype)


def stack_to(sd: Mapping[str, Any], keys: Sequence[str], dtype: torch.dtype, device,
             fn=None) -> Tensor:
    """Stack the state dict's ``keys`` into one ``[len(keys), ...]`` tensor on
    ``device``, reading one at a time (``fn`` maps each tensor first)."""
    out = None
    for i, k in enumerate(keys):
        t = as_tensor(sd[k])
        if fn is not None:
            t = fn(t)
        if out is None:
            out = torch.empty((len(keys), *t.shape), dtype=dtype, device=device)
        out[i].copy_(t)
    return out


def _interleaved_to_splithalf_rows(w: Tensor, n_heads: int, head_dim: int) -> Tensor:
    """Permute a [out, in] projection's output rows so that a checkpoint
    trained with interleaved-pair RoPE (rotating (2i, 2i+1), LlamaGen/Meta)
    gives the same attention under split-half RoPE (rotating (i, i + D/2),
    HF/LLaMA): split-half row j reads interleaved row 2j in the first half
    and 2(j - D/2) + 1 in the second."""
    if w.shape[0] != n_heads * head_dim:
        raise ValueError(f"{tuple(w.shape)} rows for {n_heads} heads of {head_dim}")
    idx = torch.arange(head_dim)
    perm = torch.where(idx < head_dim // 2, 2 * idx, 2 * (idx - head_dim // 2) + 1)
    full = (torch.arange(n_heads)[:, None] * head_dim + perm[None, :]).reshape(-1)
    return w[full]


def port_hf_llama_like(sd: Mapping[str, Any], cfg, *, prefix: str = "model.",
                       device=None) -> dict:
    """HF LLaMA-family naming (Chameleon, Anole, Emu3) -> the port's
    decoder tree, in ``cfg.dtype`` on ``device``. Handles both qk-norm
    layouts: the vendored ChameleonLayerNorm's ``[model_parallel, D]``
    (repeated across each shard's heads) and upstream HF's ``[H, D]``;
    GQA (``cfg.num_kv_heads``) and tied embeddings (no ``lm_head``)."""
    dev = resolve_device(device)
    n, H, Hkv, D, dt = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.dtype)

    def per_layer(name: str, fn=None) -> Tensor:
        return stack_to(sd, [f"{prefix}layers.{i}.{name}" for i in range(n)], dt, dev, fn)

    def heads(count: int):
        def fn(w: Tensor) -> Tensor:
            w = w.reshape(-1, D)
            if w.shape[0] != count:
                if count % w.shape[0]:
                    raise ValueError(f"qk-norm of {w.shape[0]} rows for {count} heads")
                w = w.repeat_interleave(count // w.shape[0], dim=0)
            return w
        return fn

    layers = {
        "attn_norm": per_layer("input_layernorm.weight"),
        "wq": per_layer("self_attn.q_proj.weight"),
        "wk": per_layer("self_attn.k_proj.weight"),
        "wv": per_layer("self_attn.v_proj.weight"),
        "wo": per_layer("self_attn.o_proj.weight"),
        "mlp_norm": per_layer("post_attention_layernorm.weight"),
        "w_gate": per_layer("mlp.gate_proj.weight"),
        "w_up": per_layer("mlp.up_proj.weight"),
        "w_down": per_layer("mlp.down_proj.weight"),
    }
    if cfg.qk_norm:
        for name, count in (("q", H), ("k", Hkv)):
            layers[f"{name}_norm_scale"] = per_layer(f"self_attn.{name}_norm.weight",
                                                     heads(count))
            layers[f"{name}_norm_bias"] = per_layer(f"self_attn.{name}_norm.bias",
                                                    heads(count))
    params = {
        "embed": _leaf(sd[f"{prefix}embed_tokens.weight"], dt, dev),
        "layers": layers,
        "final_norm": _leaf(sd[f"{prefix}norm.weight"], dt, dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _leaf(sd["lm_head.weight"], dt, dev)
    return params


def port_llamagen(sd: Mapping[str, Any], cfg, *, device=None) -> Tuple[dict, dict]:
    """gpt-fast naming (LlamaGen) -> (decoder tree, condition tree): the
    fused wqkv split, q/k rows permuted to split-half RoPE, and the class
    table (``{"kind": "c2i", "label_table"}``) or caption projection
    (``{"kind": "t2i", "fc1", "fc2", "uncond_embedding"}``, ``fc*`` as
    [in, out]) in f32."""
    dev = resolve_device(device)
    n, H, Hkv, D, dt = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.dtype)
    q_dim, kv_dim = H * D, Hkv * D

    def per_layer(name: str, fn=None) -> Tensor:
        return stack_to(sd, [f"layers.{i}.{name}" for i in range(n)], dt, dev, fn)

    qkv = "attention.wqkv.weight"
    params = {
        "embed": _leaf(sd["tok_embeddings.weight"], dt, dev),
        "layers": {
            "attn_norm": per_layer("attention_norm.weight"),
            "wq": per_layer(qkv, lambda w: _interleaved_to_splithalf_rows(w[:q_dim], H, D)),
            "wk": per_layer(qkv, lambda w: _interleaved_to_splithalf_rows(
                w[q_dim:q_dim + kv_dim], Hkv, D)),
            "wv": per_layer(qkv, lambda w: w[q_dim + kv_dim:]),
            "wo": per_layer("attention.wo.weight"),
            "mlp_norm": per_layer("ffn_norm.weight"),
            "w_gate": per_layer("feed_forward.w1.weight"),
            "w_up": per_layer("feed_forward.w3.weight"),
            "w_down": per_layer("feed_forward.w2.weight"),
        },
        "final_norm": _leaf(sd["norm.weight"], dt, dev),
        "lm_head": _leaf(sd["output.weight"], dt, dev),
    }
    f32 = torch.float32
    cond: dict = {}
    if "cls_embedding.embedding_table.weight" in sd:
        cond = {"kind": "c2i",
                "label_table": _leaf(sd["cls_embedding.embedding_table.weight"], f32, dev)}
    elif "cls_embedding.cap_proj.fc1.weight" in sd:
        cond = {"kind": "t2i",
                "fc1": _leaf(sd["cls_embedding.cap_proj.fc1.weight"], f32, dev).t().contiguous(),
                "fc2": _leaf(sd["cls_embedding.cap_proj.fc2.weight"], f32, dev).t().contiguous(),
                "uncond_embedding": _leaf(sd["cls_embedding.uncond_embedding"], f32, dev)}
    return params, cond

