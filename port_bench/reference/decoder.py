"""The decoder in float32: embedding, layers (attention with optional
per-head LayerNorm on q and k, split-half RoPE, SwiGLU), final norm and
head, over whole sequences with the causal mask, and over
branches: short runs of other tokens that follow a prefix of a sequence
(a decode step's drafts past the tokens it committed), each seeing that
prefix and itself causally. Weights are drawn again layer by layer from
their seed and dequantized as the configuration states (int4 projections,
int8 head, bf16 embedding); the KV rows are rounded to int8 where the
configuration keeps an int8 cache. TF32 is off while it runs.

A layer is pre-norm (RMSNorm on the attention's and the MLP's inputs) or,
with ``swin_norm``, post-norm as Chameleon-34B's: each sublayer's input
unnormalised and its output RMS-normalised before the residual add. A
configuration that states structure the reference does not model is
refused by name (:func:`refuse_unmodelled`): it would compute another
model silently."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import weights
from .quant import dequant_rows, kv_int8

BITS = {"w4a16": 4}
KV_CACHES = ("int8", "bfloat16")
# top-level keys of a configuration file that the reference reads or that
# state nothing about the computation (names, provenance, notes)
MODELLED = frozenset({
    "name", "source", "model_type", "reduced", "assumed", "serving",
    "hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads",
    "num_hidden_layers", "vocab_size", "rope_theta", "rms_norm_eps", "qk_layernorm",
    "swin_norm", "max_position_embeddings", "tie_word_embeddings", "head_dim", "rope_style",
})


def refuse_unmodelled(cfg: dict) -> None:
    """Raise ``ValueError``, naming the key, on a configuration the
    reference does not model: a top-level key outside ``MODELLED``, tied
    embeddings, RoPE other than 1-D, a head width other than
    ``hidden_size / num_attention_heads``, weights or a KV cache of
    another kind."""
    for key in cfg:
        if key not in MODELLED:
            raise ValueError(f"the reference does not model the configuration key {key!r}")
    for key in ("qk_layernorm", "swin_norm", "tie_word_embeddings"):
        if not isinstance(cfg.get(key, False), bool):
            raise ValueError(f"{key!r} must be true or false, not {cfg[key]!r}")
    if cfg.get("tie_word_embeddings", False):
        raise ValueError("the reference does not model 'tie_word_embeddings': true")
    if cfg.get("rope_style", "1d") != "1d":
        raise ValueError(f"the reference does not model 'rope_style': {cfg['rope_style']!r}")
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if d % H or cfg.get("head_dim", d // H) != d // H:
        raise ValueError(f"the reference does not model 'head_dim': {cfg.get('head_dim')!r} "
                         f"with hidden_size {d} over {H} heads")
    if H % cfg["num_key_value_heads"]:
        raise ValueError(f"'num_key_value_heads' {cfg['num_key_value_heads']} does not "
                         f"divide {H} query heads")
    srv = cfg["serving"]
    if srv["weights"] not in BITS:
        raise ValueError(f"the reference does not model 'serving.weights': {srv['weights']!r}")
    if srv["kv_cache"] not in KV_CACHES:
        raise ValueError(f"the reference does not model 'serving.kv_cache': "
                         f"{srv['kv_cache']!r}")


@contextlib.contextmanager
def strict_f32():
    """float32 products without TF32, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def _head_ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, H, D], split-half rotation at positions ``pos`` [n]."""
    D = x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = pos.double()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return x * cos + torch.cat([-b, a], dim=-1) * sin


def _attend(q, k, v, block: int = 1024):
    """Causal attention, q [n, H, D], k/v [n, Hkv, D]; query blocks."""
    n, H, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1).permute(1, 2, 0)  # [H, D, n]
    v = v.repeat_interleave(group, dim=1).permute(1, 0, 2)  # [H, n, D]
    outs = []
    for t0 in range(0, n, block):
        t1 = min(n, t0 + block)
        s = torch.matmul(q[t0:t1].permute(1, 0, 2), k) / math.sqrt(D)  # [H, b, n]
        causal = torch.arange(n, device=q.device)[None, :] <= torch.arange(
            t0, t1, device=q.device)[:, None]
        s = s.masked_fill(~causal[None], float("-inf"))
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v).permute(1, 0, 2))
    return torch.cat(outs, dim=0)


def _attend_branches(q, kb, vb, k, v, start, budget: int = 1 << 27):
    """Branch attention: q [nb, m, H, D], kb/vb [nb, m, Hkv, D]; branch b
    sees the sequence's rows [0, start[b]) of k/v [n, Hkv, D], then its own
    rows causally. Branches in blocks of at most ``budget`` scores."""
    nb, m, H, D = q.shape
    n, group = k.shape[0], H // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    kb, vb = kb.repeat_interleave(group, 2), vb.repeat_interleave(group, 2)
    scale = 1.0 / math.sqrt(D)
    seen = torch.arange(n, device=q.device)[None, :] < start[:, None]  # [nb, n]
    causal = torch.arange(m, device=q.device)[None, :] <= torch.arange(m, device=q.device)[:, None]
    step = max(1, budget // (H * m * (n + m)))
    outs = []
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        qq = q[b0:b1]
        s1 = torch.einsum("cmhd,nhd->chmn", qq, k) * scale
        s1 = s1.masked_fill(~seen[b0:b1, None, None, :], float("-inf"))
        s2 = torch.einsum("cmhd,cjhd->chmj", qq, kb[b0:b1]) * scale
        s2 = s2.masked_fill(~causal[None, None], float("-inf"))
        p = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
        outs.append(torch.einsum("chmn,nhd->cmhd", p[..., :n], v)
                    + torch.einsum("chmj,cjhd->cmhd", p[..., n:], vb[b0:b1]))
    return torch.cat(outs, dim=0)


class Decoder:
    """The configuration's decoder, its weights drawn again."""

    def __init__(self, cfg: dict, device):
        refuse_unmodelled(cfg)
        self.cfg, self.seed, self.device = cfg, weights.seed_of(cfg), torch.device(device)
        srv = cfg["serving"]
        self.bits = BITS[srv["weights"]]
        self.kv8 = srv["kv_cache"] == "int8"
        self.H, self.Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.D = cfg["hidden_size"] // self.H
        self.eps = cfg["rms_norm_eps"]
        self.qk_norm = bool(cfg.get("qk_layernorm", False))
        self.swin = bool(cfg.get("swin_norm", False))
        self.qk_eps = srv.get("qk_norm_eps", 1e-5)
        self._head = None

    def _w(self, name: str, layer: int) -> torch.Tensor:
        return dequant_rows(weights.layer_weight(self.cfg, self.seed, name, layer,
                                                 self.device), self.bits)

    def hidden(self, seqs: Sequence[tuple],
               branches: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]] = None) -> tuple:
        """(ids [n], positions [n]) per sequence, and per sequence index
        groups of branches (ids [nb, m], prefix rows [nb]: branch b's row j
        stands at position prefix[b] + j and sees the sequence's first
        prefix[b] rows) -> the final-norm inputs' normalised rows, float32:
        [n, d] per sequence, and [nb, m, d] per branch group, as given."""
        branches = branches or {}
        with strict_f32(), torch.no_grad():
            emb = weights.table_weight(self.cfg, self.seed, "embed", self.device)
            hs = [emb[ids.to(self.device).long()].float() for ids, _ in seqs]
            bs = {i: [(emb[t.to(self.device).long()].float(), p.to(self.device).long())
                      for t, p in groups] for i, groups in branches.items()}
            del emb
            pos = [p.to(self.device) for _, p in seqs]
            H, Hkv, D = self.H, self.Hkv, self.D
            theta = self.cfg["rope_theta"]
            swin, eps = self.swin, self.eps

            def pre(x):  # a sublayer's input
                return x if swin else _rms(x, eps)

            def post(x):  # a sublayer's output, before the residual add
                return _rms(x, eps) if swin else x

            def qkv(w, h, positions):
                n = h.shape[0]
                a = pre(h)
                q = (a @ w["wq"].t()).view(n, H, D)
                k = (a @ w["wk"].t()).view(n, Hkv, D)
                v = (a @ w["wv"].t()).view(n, Hkv, D)
                if self.qk_norm:
                    q, k = _head_ln(q, self.qk_eps), _head_ln(k, self.qk_eps)
                q, k = _rope(q, positions, theta), _rope(k, positions, theta)
                if self.kv8:
                    k, v = kv_int8(k), kv_int8(v)
                return q, k, v

            def mlp(w, h):
                m = pre(h)
                g, u = m @ w["w_gate"].t(), m @ w["w_up"].t()
                return h + post((F.silu(g) * u) @ w["w_down"].t())

            for layer in range(self.cfg["num_hidden_layers"]):
                w = {n: self._w(n, layer) for n in weights.decoder_shapes(self.cfg)}
                for i, h in enumerate(hs):
                    n = h.shape[0]
                    q, k, v = qkv(w, h, pos[i])
                    h = h + post(_attend(q, k, v).reshape(n, H * D) @ w["wo"].t())
                    hs[i] = mlp(w, h)
                    for g_i, (bh, start) in enumerate(bs.get(i, [])):
                        nb, m, d = bh.shape
                        bpos = (start[:, None] + torch.arange(m, device=bh.device)).reshape(-1)
                        bq, bk, bv = qkv(w, bh.reshape(nb * m, d), bpos)
                        o = _attend_branches(bq.view(nb, m, H, D), bk.view(nb, m, Hkv, D),
                                             bv.view(nb, m, Hkv, D), k, v, start)
                        bh = bh + post(o.reshape(nb * m, H * D) @ w["wo"].t()).view(nb, m, d)
                        bs[i][g_i] = (mlp(w, bh), start)
                del w
            return ([_rms(h, self.eps) for h in hs],
                    {i: [_rms(bh, self.eps) for bh, _ in groups] for i, groups in bs.items()})

    def logits(self, rows: torch.Tensor) -> torch.Tensor:
        """Normalised rows [m, d] -> float32 logits [m, V]."""
        with strict_f32(), torch.no_grad():
            if self._head is None:
                self._head = dequant_rows(
                    weights.table_weight(self.cfg, self.seed, "lm_head", self.device), 8)
            return rows @ self._head.t()

    def release(self) -> None:
        self._head = None
