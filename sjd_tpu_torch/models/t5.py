"""T5 text encoder for LlamaGen t2i (sjd_tpu/models/t5.py): the flan-t5
encoder stack (a relative position bias shared by every layer, gated-GELU
MLP, RMSNorm, no 1/sqrt(d) score scale), the caption cleaning LlamaGen
applies before tokenizing, and the flip of each caption's rows to the end
(left padding) that its caption embedder expects.

The encoder's products and attention are plain PyTorch, as the JAX package
leaves them to XLA: no kernel of its own. Weights come from an HF
checkpoint directory read by ``utils/port.py``; the sentencepiece
tokenizer is the caller's (any callable with HF's call signature that
returns ``input_ids`` and ``attention_mask``), since neither
``transformers`` nor ``sentencepiece`` is a dependency of the port.
``clean_caption`` uses ``ftfy`` and ``bs4`` where they import and
pure-Python stand-ins where they do not, as the JAX module does.
"""

from __future__ import annotations

import dataclasses
import html
import json
import math
import os
import re
import unicodedata
import urllib.parse as ul
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device

Tensor = torch.Tensor

# exact reference construction (llamagen/language/t5.py:17): the class is
# {# ® • © ™ & @ · º ½ ¾ ¿ ¡ § ~ ( ) [ ] { } | \ / *}
_BAD_PUNCT = re.compile(
    r"[" + "#®•©™&@·º½¾¿¡§~" + "\\)" + "\\(" + "\\]" + "\\[" + "\\}" + "\\{"
    + "\\|" + "\\\\" + "\\/" + "\\*" + r"]{1,}"
)

# ---------------------------------------------------------------------------
# ftfy / bs4 seams: the reference's basic_clean runs ftfy.fix_text and its
# html stripping runs BeautifulSoup (t5.py:94-98, 113). Both are optional in
# this environment, so each gets a small pure-python fallback; when the real
# library is importable the exact reference path is used, keeping
# clean_caption bit-identical to the reference there.
# ---------------------------------------------------------------------------

_LIGATURES = {
    "Ĳ": "IJ", "ĳ": "ij", "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl", "ﬃ": "ffi",
    "ﬄ": "ffl", "ﬅ": "ft", "ﬆ": "st",
}
_CURLY_QUOTES = {"‘": "'", "’": "'", "‛": "'", "“": '"', "”": '"', "„": '"'}
_LINE_BREAKS = {"\r\n": "\n", "\r": "\n", "\u2028": "\n", "\u2029": "\n",
                "\u0085": "\n"}
_TERMINAL_ESCAPES = re.compile(r"\x1b\[[0-9;]*[mK]")
_HTML_ENTITY = re.compile(r"&#?\w{1,24};")


def fix_text_fallback(text: str) -> str:
    """Vendor-light stand-in for ftfy.fix_text's *deterministic* transforms
    (mojibake re-decoding is out of scope for caption cleaning): auto html
    unescape, terminal-escape removal, latin ligatures, fullwidth->ASCII
    width folding, quote uncurling, line-break and control-char
    normalization, NFC — the documented fix_text default pipeline."""
    if "<" not in text and _HTML_ENTITY.search(text):
        text = html.unescape(text)
    text = _TERMINAL_ESCAPES.sub("", text)
    for k, v in _LIGATURES.items():
        text = text.replace(k, v)
    # character width: fullwidth/halfwidth forms fold via NFKC per char
    text = "".join(
        unicodedata.normalize("NFKC", ch)
        if "\uff01" <= ch <= "\uffee" else ch
        for ch in text
    )
    for k, v in _CURLY_QUOTES.items():
        text = text.replace(k, v)
    for k, v in _LINE_BREAKS.items():
        text = text.replace(k, v)
    text = "".join(
        ch for ch in text
        if ch in "\n\t" or unicodedata.category(ch) != "Cc"
    )
    return unicodedata.normalize("NFC", text)


try:  # pragma: no cover - environment dependent
    from ftfy import fix_text as _fix_text
except ImportError:
    _fix_text = fix_text_fallback


def _strip_html_fallback(text: str) -> str:
    """BeautifulSoup(caption, 'html.parser').text without bs4: stdlib
    HTMLParser collecting text nodes (same convert_charrefs=True entity
    behavior as bs4's html.parser tree builder)."""
    from html.parser import HTMLParser

    class _Extract(HTMLParser):
        def __init__(self):
            super().__init__(convert_charrefs=True)
            self.parts: list = []

        def handle_data(self, d):
            self.parts.append(d)

    p = _Extract()
    p.feed(text)
    return "".join(p.parts)


try:  # pragma: no cover - environment dependent
    from bs4 import BeautifulSoup as _BS

    def _strip_html(text: str) -> str:
        return _BS(text, features="html.parser").text
except ImportError:
    _strip_html = _strip_html_fallback


def basic_clean(text: str) -> str:
    """ftfy fix + double html unescape + strip (reference t5.py:94-98)."""
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def clean_caption(caption: str) -> str:
    """FULL port of the reference's caption normalization, transform-for-
    transform in the reference order (llamagen/language/t5.py:100-204):
    url/unquote + lowercase, url and html stripping, @-handle removal, CJK
    unicode-range scrubs, dash/quote canonicalization, entity remnants, IP
    addresses, article ids, hashtag/serial-number scrubs, filename and
    watermark-phrase removal, punctuation-run collapses, ftfy basic_clean,
    alphanumeric-id scrubs, dimension strings, spacing fixes, and edge
    quote/punctuation trims."""
    caption = str(caption)
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    caption = re.sub("<person>", "person", caption)
    # urls:
    caption = re.sub(
        r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",  # noqa: E501
        "", caption)
    caption = re.sub(
        r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",  # noqa: E501
        "", caption)
    # html:
    caption = _strip_html(caption)

    # @<nickname>
    caption = re.sub(r"@[\w\d]+\b", "", caption)

    # CJK Strokes .. CJK Unified Ideographs (the reference's 7 range scrubs)
    caption = re.sub(r"[\u31c0-\u31ef]+", "", caption)
    caption = re.sub(r"[\u31f0-\u31ff]+", "", caption)
    caption = re.sub(r"[\u3200-\u32ff]+", "", caption)
    caption = re.sub(r"[\u3300-\u33ff]+", "", caption)
    caption = re.sub(r"[\u3400-\u4dbf]+", "", caption)
    caption = re.sub(r"[\u4dc0-\u4dff]+", "", caption)
    caption = re.sub(r"[\u4e00-\u9fff]+", "", caption)

    # all types of dash -> "-"
    caption = re.sub(
        r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A\u2E3B\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+",  # noqa: E501
        "-", caption)

    # quotes to one standard
    caption = re.sub(r"[`´«»“”¨]", '"', caption)
    caption = re.sub(r"[‘’]", "'", caption)

    # &quot; / &amp remnants
    caption = re.sub(r"&quot;?", "", caption)
    caption = re.sub(r"&amp", "", caption)

    # ip addresses:
    caption = re.sub(r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}", " ", caption)

    # article ids:
    caption = re.sub(r"\d:\d\d\s+$", "", caption)

    # \n
    caption = re.sub(r"\\n", " ", caption)

    # "#123" / "#12345.." / "123456.."
    caption = re.sub(r"#\d{1,3}\b", "", caption)
    caption = re.sub(r"#\d{5,}\b", "", caption)
    caption = re.sub(r"\b\d{6,}\b", "", caption)
    # filenames:
    caption = re.sub(
        r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)", "", caption)

    caption = re.sub(r"[\"\']{2,}", r'"', caption)  # """AUSVERKAUFT"""
    caption = re.sub(r"[\.]{2,}", r" ", caption)

    caption = _BAD_PUNCT.sub(r" ", caption)  # ***AUSVERKAUFT***, #AUSVERKAUFT
    caption = re.sub(r"\s+\.\s+", r" ", caption)  # " . "

    # this-is-my-cute-cat / this_is_my_cute_cat
    regex2 = re.compile(r"(?:\-|\_)")
    if len(re.findall(regex2, caption)) > 3:
        caption = re.sub(regex2, " ", caption)

    caption = basic_clean(caption)

    caption = re.sub(r"\b[a-zA-Z]{1,3}\d{3,15}\b", "", caption)  # jc6640
    caption = re.sub(r"\b[a-zA-Z]+\d+[a-zA-Z]+\b", "", caption)  # jc6640vc
    caption = re.sub(r"\b\d+[a-zA-Z]+\d+\b", "", caption)  # 6640vc231

    caption = re.sub(r"(worldwide\s+)?(free\s+)?shipping", "", caption)
    caption = re.sub(r"(free\s)?download(\sfree)?", "", caption)
    caption = re.sub(r"\bclick\b\s(?:for|on)\s\w+", "", caption)
    caption = re.sub(
        r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?", "",
        caption)
    caption = re.sub(r"\bpage\s+\d+\b", "", caption)

    caption = re.sub(
        r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", r" ", caption)  # j2d1a2a

    caption = re.sub(r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", "", caption)

    caption = re.sub(r"\b\s+\:\s+", r": ", caption)
    caption = re.sub(r"(\D[,\./])\b", r"\1 ", caption)
    caption = re.sub(r"\s+", " ", caption)

    # (the reference calls caption.strip() here WITHOUT assignment — a no-op
    # kept out rather than "fixed", to stay byte-identical)

    caption = re.sub(r"^[\"\']([\w\W]+)[\"\']$", r"\1", caption)
    caption = re.sub(r"^[\'\_,\-\:;]", r"", caption)
    caption = re.sub(r"[\'\_,\-\:\-\+]$", r"", caption)
    caption = re.sub(r"^\.\S+$", "", caption)

    return caption.strip()


def flip_padding_to_left(
    embs: np.ndarray, mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Move each row's valid span to the end (left padding), as the LlamaGen
    caller does before feeding the caption embedder (test_llamagen.py:135-148)."""
    B, T = mask.shape
    out_e = np.zeros_like(embs)
    out_m = np.zeros_like(mask)
    for b in range(B):
        n = int(mask[b].sum())
        out_e[b, T - n :] = embs[b, :n]
        out_m[b, T - n :] = 1
    return out_e, out_m


# ---------------------------------------------------------------------------
# The flan-t5 encoder stack
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    """flan-t5-xl's encoder by default (caption_dim 2048)."""

    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    num_heads: int = 32
    d_ff: int = 5120
    num_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any], dtype: torch.dtype = torch.float32):
        return cls(
            vocab_size=cfg["vocab_size"], d_model=cfg["d_model"], d_kv=cfg["d_kv"],
            num_heads=cfg["num_heads"], d_ff=cfg["d_ff"], num_layers=cfg["num_layers"],
            rel_buckets=cfg.get("relative_attention_num_buckets", 32),
            rel_max_distance=cfg.get("relative_attention_max_distance", 128),
            layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-6), dtype=dtype,
        )


def _t5_rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    """T5LayerNorm: no mean subtraction, statistics in f32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (w * (xf * torch.rsqrt(var + eps)).to(x.dtype)).to(x.dtype)


def _gelu_tanh(x: Tensor) -> Tensor:
    """The tanh GELU of flan-t5's gated-gelu MLP."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * torch.pow(x, 3.0))))


def relative_position_bucket(rel_pos: Tensor, num_buckets: int, max_distance: int) -> Tensor:
    """Bidirectional log-spaced buckets of (key_pos - query_pos): half the
    buckets for each sign, exact below num_buckets // 4, log-spaced up to
    max_distance beyond."""
    nb = num_buckets // 2
    bucket = (rel_pos > 0).to(torch.int32) * nb
    n = rel_pos.abs()
    max_exact = nb // 2
    is_small = n < max_exact
    scale = (nb - max_exact) / math.log(max_distance / max_exact)
    log_val = max_exact + (
        torch.log(torch.clamp_min(n, 1).float() / max_exact) * scale).to(torch.int32)
    log_val = torch.clamp_max(log_val, nb - 1)
    return bucket + torch.where(is_small, n.to(torch.int32), log_val)


def t5_position_bias(rel_bias: Tensor, seq_len: int, cfg: T5EncoderConfig) -> Tensor:
    """[1, H, T, T] additive attention bias from the shared [buckets, H]
    table."""
    pos = torch.arange(seq_len, dtype=torch.int32, device=rel_bias.device)
    rel = pos[None, :] - pos[:, None]  # key - query
    buckets = relative_position_bucket(rel, cfg.rel_buckets, cfg.rel_max_distance)
    return rel_bias[buckets.long()].permute(2, 0, 1)[None].to(cfg.dtype)


def t5_encode(params: Mapping[str, Tensor], cfg: T5EncoderConfig, ids: Tensor,
              mask: Tensor) -> Tensor:
    """The encoder's last hidden state [B, T, d_model] for ids [B, T] under
    mask [B, T] (True = a real token); the layers loop over the stacked
    weights."""
    B, T = ids.shape
    H, Dk = cfg.num_heads, cfg.d_kv
    x = params["embed"][ids.long()].to(cfg.dtype)
    neg = torch.finfo(torch.float32).min
    attn_mask = torch.where(mask[:, None, None, :].bool(), 0.0, neg)
    bias = t5_position_bias(params["rel_bias"], T, cfg).float() + attn_mask  # [B, H, T, T]

    def heads(t):
        return t.reshape(B, T, H, Dk).transpose(1, 2)

    for i in range(cfg.num_layers):
        h = _t5_rms_norm(x, params["attn_norm"][i], cfg.layer_norm_eps)
        q, k, v = (heads(h @ params[w][i].T) for w in ("wq", "wk", "wv"))
        # no 1/sqrt(d): T5 folds the scale into its initialisation
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) + bias
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        x = x + ctx.transpose(1, 2).reshape(B, T, H * Dk) @ params["wo"][i].T
        h = _t5_rms_norm(x, params["ffn_norm"][i], cfg.layer_norm_eps)
        ff = _gelu_tanh(h @ params["wi0"][i].T) * (h @ params["wi1"][i].T)
        x = x + ff @ params["wo_ff"][i].T
    return _t5_rms_norm(x, params["final_norm"], cfg.layer_norm_eps)


def init_t5_params(rng: Union[int, torch.Generator], cfg: T5EncoderConfig, *,
                   device=None) -> Dict[str, Tensor]:
    """Random parameters with the JAX package's tree, shapes and scales
    (the layout of :func:`port_t5_encoder`), from a ``torch.Generator`` (a
    seed makes one on ``device``)."""
    dev = resolve_device(device)
    if isinstance(rng, torch.Generator):
        gen = rng
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng))
    n, d, hd, ff = cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff

    def norm(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                * scale).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": norm((cfg.vocab_size, d), 1.0),
        "rel_bias": norm((cfg.rel_buckets, cfg.num_heads), 0.5),
        "attn_norm": ones((n, d)),
        "wq": norm((n, hd, d), (d * cfg.d_kv) ** -0.5),
        "wk": norm((n, hd, d), d ** -0.5),
        "wv": norm((n, hd, d), d ** -0.5),
        "wo": norm((n, d, hd), hd ** -0.5),
        "ffn_norm": ones((n, d)),
        "wi0": norm((n, ff, d), d ** -0.5),
        "wi1": norm((n, ff, d), d ** -0.5),
        "wo_ff": norm((n, d, ff), ff ** -0.5),
        "final_norm": ones((d,)),
    }


def port_t5_encoder(sd: Mapping[str, Any], cfg: T5EncoderConfig, *,
                    device=None) -> Dict[str, Tensor]:
    """An HF T5EncoderModel state dict (tensors or arrays; bare
    "encoder.block..." or prefixed "encoder.encoder.block..." names) -> the
    stacked tree, each stacked leaf filled one layer at a time on
    ``device``."""
    dev = resolve_device(device)

    def leaf(k):
        for pre in ("", "encoder."):
            if pre + k in sd:
                return torch.as_tensor(sd[pre + k]).to(device=dev, dtype=cfg.dtype)
        raise KeyError(k)

    def stack(fmt):
        first = leaf(fmt.format(i=0))
        out = torch.empty((cfg.num_layers, *first.shape), dtype=cfg.dtype, device=dev)
        out[0] = first
        for i in range(1, cfg.num_layers):
            out[i] = leaf(fmt.format(i=i))
        return out

    blk = "encoder.block.{i}.layer"
    return {
        "embed": leaf("shared.weight"),
        "rel_bias": leaf("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "attn_norm": stack(blk + ".0.layer_norm.weight"),
        "wq": stack(blk + ".0.SelfAttention.q.weight"),
        "wk": stack(blk + ".0.SelfAttention.k.weight"),
        "wv": stack(blk + ".0.SelfAttention.v.weight"),
        "wo": stack(blk + ".0.SelfAttention.o.weight"),
        "ffn_norm": stack(blk + ".1.layer_norm.weight"),
        "wi0": stack(blk + ".1.DenseReluDense.wi_0.weight"),
        "wi1": stack(blk + ".1.DenseReluDense.wi_1.weight"),
        "wo_ff": stack(blk + ".1.DenseReluDense.wo.weight"),
        "final_norm": leaf("final_layer_norm.weight"),
    }


class T5Embedder:
    """Captions -> left-padded T5 features for LlamaGen's caption embedder.

    ``model_dir`` holds ``config.json`` and the encoder's shards
    (``*.safetensors`` or ``pytorch_model*.bin``); without it the encoder
    is random (seed 3) at ``config``'s widths, flan-t5-xl's by default. ``tokenizer`` is called as HF's is,
    ``tokenizer(texts, max_length=, padding="max_length", truncation=True,
    return_tensors="np")``, and must return ``input_ids`` and
    ``attention_mask`` of [B, max_length]."""

    def __init__(self, model_dir: Optional[str], tokenizer: Callable, *,
                 max_length: int = 120, dtype: torch.dtype = torch.float32,
                 config: Optional[T5EncoderConfig] = None, device=None):
        from ..utils.port import load_sharded_state

        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.max_length = max_length
        if model_dir:
            with open(os.path.join(model_dir, "config.json")) as f:
                self.config = T5EncoderConfig.from_hf_config(json.load(f), dtype)
            self.params = port_t5_encoder(load_sharded_state(model_dir), self.config,
                                          device=self.device)
        else:
            self.config = config if config is not None else T5EncoderConfig(dtype=dtype)
            self.params = init_t5_params(3, self.config, device=self.device)

    def tokenize(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Each text cleaned twice, as LlamaGen does, then tokenized to
        (input_ids, attention_mask) of [B, max_length]."""
        texts = [clean_caption(clean_caption(t)) for t in texts]
        enc = self.tokenizer(texts, max_length=self.max_length, padding="max_length",
                             truncation=True, return_tensors="np")
        return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

    def get_text_embeddings(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """texts -> (features [B, max_length, d_model] with each caption's
        rows moved to the end, mask [B, max_length])."""
        ids, mask = self.tokenize(texts)
        with torch.no_grad():
            out = t5_encode(self.params, self.config,
                            torch.as_tensor(ids, device=self.device),
                            torch.as_tensor(mask, device=self.device))
        embs = out.float().cpu().numpy() * mask[:, :, None]
        return flip_padding_to_left(embs, mask)
