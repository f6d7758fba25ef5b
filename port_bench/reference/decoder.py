"""The decoder in float32: embedding, pre-norm layers (RMSNorm, attention
with optional per-head LayerNorm on q and k, split-half RoPE, SwiGLU),
final norm and head, over whole sequences with the causal mask, and over
branches: short runs of other tokens that follow a prefix of a sequence
(a decode step's drafts past the tokens it committed), each seeing that
prefix and itself causally. Weights are drawn again layer by layer from
their seed and dequantized as the configuration states (int4 projections,
int8 head, bf16 embedding); the KV rows are rounded to int8 where the
configuration keeps an int8 cache. TF32 is off while it runs."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import weights
from .quant import dequant_rows, kv_int8

BITS = {"w4a16": 4}


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
        self.cfg, self.seed, self.device = cfg, weights.seed_of(cfg), torch.device(device)
        srv = cfg["serving"]
        self.bits = BITS[srv["weights"]]
        self.kv8 = srv["kv_cache"] == "int8"
        self.H, self.Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.D = cfg["hidden_size"] // self.H
        self.eps = cfg["rms_norm_eps"]
        self.qk_norm = bool(cfg.get("qk_layernorm", False))
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

            def qkv(w, h, positions):
                n = h.shape[0]
                a = _rms(h, self.eps)
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
                m = _rms(h, self.eps)
                g, u = m @ w["w_gate"].t(), m @ w["w_up"].t()
                return h + (F.silu(g) * u) @ w["w_down"].t()

            for layer in range(self.cfg["num_hidden_layers"]):
                w = {n: self._w(n, layer) for n in weights.decoder_shapes(self.cfg)}
                for i, h in enumerate(hs):
                    n = h.shape[0]
                    q, k, v = qkv(w, h, pos[i])
                    h = h + _attend(q, k, v).reshape(n, H * D) @ w["wo"].t()
                    hs[i] = mlp(w, h)
                    for g_i, (bh, start) in enumerate(bs.get(i, [])):
                        nb, m, d = bh.shape
                        bpos = (start[:, None] + torch.arange(m, device=bh.device)).reshape(-1)
                        bq, bk, bv = qkv(w, bh.reshape(nb * m, d), bpos)
                        o = _attend_branches(bq.view(nb, m, H, D), bk.view(nb, m, Hkv, D),
                                             bv.view(nb, m, Hkv, D), k, v, start)
                        bh = bh + (o.reshape(nb * m, H * D) @ w["wo"].t()).view(nb, m, d)
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
