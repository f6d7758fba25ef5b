"""The Emu3 tiktoken-BPE tokenizer (sjd_tpu/utils/emu3_tokenizer.py), read
from the checkpoint's two vocabulary files with no ``transformers``:

  emu3.tiktoken          - base64 BPE ranks, one "token rank" pair per line
  emu3_vision_tokens.txt - the <|visual token NNNNNN|> names

Special tokens (<|endoftext|>, <|im_start|>, <|im_end|>, 205 <|extra_N|>,
then the vision tokens) rank on from the text vocabulary. Roles:
bos=<|extra_203|>, eos=<|extra_204|>, pad=<|endoftext|>, eol=<|extra_200|>,
eof=<|extra_201|>.

``Emu3Tokenizer`` needs the ``tiktoken`` package, imported when one is
made (an ImportError otherwise); ``tiktoken`` is no dependency of the port.
Where it is missing, hand the loaders any object with ``encode`` instead
(``load_emu3(tokenizer=)``), as ``chip_smoke.py`` does.

The default positive suffix and negative prompt of the reference's quality
setup live here too.
"""

from __future__ import annotations

import base64
import unicodedata
from typing import Dict, List, Optional

PAT_STR = (
    r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"""
    r"""| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
)
ENDOFTEXT = "<|endoftext|>"
IMSTART = "<|im_start|>"
IMEND = "<|im_end|>"
N_EXTRAS = 205

DEFAULT_POSITIVE_SUFFIX = " masterpiece, film grained, best quality."
DEFAULT_NEGATIVE_PROMPT = (
    "lowres, bad anatomy, bad hands, text, error, missing fingers, extra "
    "digit, fewer digits, cropped, worst quality, low quality, normal "
    "quality, jpeg artifacts, signature, watermark, username, blurry."
)


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    with open(path, "rb") as f:
        contents = f.read()
    return {base64.b64decode(token): int(rank)
            for token, rank in (line.split() for line in contents.splitlines() if line)}


class Emu3Tokenizer:
    """encode/decode over the Emu3 vocabulary (text BPE and special tokens)."""

    def __init__(self, vocab_file: str, special_tokens_file: str, *,
                 errors: str = "replace", bos_token: str = "<|extra_203|>",
                 eos_token: str = "<|extra_204|>", pad_token: str = ENDOFTEXT,
                 img_token: str = "<|image token|>", boi_token: str = "<|image start|>",
                 eoi_token: str = "<|image end|>", eol_token: str = "<|extra_200|>",
                 eof_token: str = "<|extra_201|>",
                 special_start_id: Optional[int] = None):
        try:
            import tiktoken
        except ImportError as e:
            raise ImportError("the native Emu3 tokenizer needs the `tiktoken` package") from e

        self.errors = errors
        self.mergeable_ranks = load_tiktoken_ranks(vocab_file)
        with open(special_tokens_file) as f:
            vision_tokens = [t.strip() for t in f if t.strip()]
        start = (special_start_id if special_start_id is not None
                 else len(self.mergeable_ranks))
        names = ((ENDOFTEXT, IMSTART, IMEND)
                 + tuple(f"<|extra_{i}|>" for i in range(N_EXTRAS)) + tuple(vision_tokens))
        self.special_tokens = {tok: start + i for i, tok in enumerate(names)}
        self.enc = tiktoken.Encoding("Emu3", pat_str=PAT_STR,
                                     mergeable_ranks=self.mergeable_ranks,
                                     special_tokens=self.special_tokens)
        self.bos_token, self.eos_token, self.pad_token = bos_token, eos_token, pad_token
        self.img_token, self.boi_token, self.eoi_token = img_token, boi_token, eoi_token
        self.eol_token, self.eof_token = eol_token, eof_token
        self.eod_id = self.special_tokens[ENDOFTEXT]

    def token_to_id(self, token: str) -> int:
        if token in self.special_tokens:
            return self.special_tokens[token]
        return self.mergeable_ranks[token.encode()]

    def _id(self, token: str) -> int:
        return self.special_tokens[token]

    bos_id = property(lambda self: self._id(self.bos_token))
    eos_id = property(lambda self: self._id(self.eos_token))
    pad_id = property(lambda self: self._id(self.pad_token))
    boi_id = property(lambda self: self._id(self.boi_token))
    eoi_id = property(lambda self: self._id(self.eoi_token))
    eol_id = property(lambda self: self._id(self.eol_token))
    eof_id = property(lambda self: self._id(self.eof_token))
    img_id = property(lambda self: self._id(self.img_token))

    @property
    def vocab_size(self) -> int:
        return self.enc.n_vocab

    def __len__(self) -> int:
        return self.enc.n_vocab

    def encode(self, text: str, *, allowed_special="all", disallowed_special=()) -> List[int]:
        return self.enc.encode(unicodedata.normalize("NFC", text),
                               allowed_special=allowed_special,
                               disallowed_special=disallowed_special)

    def decode(self, ids, *, skip_special_tokens: bool = False) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = [i for i in ids if i < self.eod_id]
        return self.enc.decode(ids, errors=self.errors)
