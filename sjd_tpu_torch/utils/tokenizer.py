"""Tokenizer wrapper (sjd_tpu/utils/tokenizer.py): a HuggingFace tokenizer
directory or ``tokenizer.json`` (the Chameleon format), or a SentencePiece
model file, behind one encode/decode interface with explicit BOS/EOS.

``transformers`` and ``sentencepiece`` are imported when a tokenizer is
made, not with this module. Where neither is installed, pass any object
with ``encode(text) -> ids`` and ``get_vocab() -> {name: id}`` wherever the
port takes a tokenizer.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


class Tokenizer:
    def __init__(self, path: str):
        self.backend: str
        if os.path.isdir(path) or path.endswith(".json"):
            from transformers import AutoTokenizer

            self.tok = AutoTokenizer.from_pretrained(
                path if os.path.isdir(path) else os.path.dirname(path))
            self.backend = "huggingface"
            self.bos_id = self.tok.bos_token_id
            self.eos_id = self.tok.eos_token_id
        else:
            from sentencepiece import SentencePieceProcessor

            self.tok = SentencePieceProcessor(model_file=path)
            self.backend = "sentencepiece"
            self.bos_id = self.tok.bos_id()
            self.eos_id = self.tok.eos_id()

    @property
    def vocab_size(self) -> int:
        if self.backend == "huggingface":
            return len(self.tok)
        return self.tok.vocab_size()

    def encode(self, text: str, *, bos: bool = False, eos: bool = False) -> List[int]:
        if self.backend == "huggingface":
            ids = self.tok.encode(text, add_special_tokens=False)
        else:
            ids = self.tok.encode(text)
        if bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        if eos and self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        return self.tok.decode(ids)

    def get_vocab(self) -> Dict[str, int]:
        """name -> id (the source of the IMGIMG image-token mapping)."""
        if self.backend == "huggingface":
            return self.tok.get_vocab()
        return {self.tok.id_to_piece(i): i for i in range(self.tok.vocab_size())}

    def token_to_id(self, token: str) -> Optional[int]:
        if self.backend == "huggingface":
            return self.tok.convert_tokens_to_ids(token)
        return self.tok.piece_to_id(token)
