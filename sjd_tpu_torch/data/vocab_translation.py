"""Chameleon BPE <-> VQ-codebook vocabulary translation
(sjd_tpu/data/vocab_translation.py), host-side numpy.

The Chameleon / Lumina LM does not emit codebook ids: its image tokens are
BPE entries whose names spell the codebook id. ``IMGIMG<letters>Z`` maps to
the codebook row whose decimal digits are the letters (A = 0 .. J = 9), so
BPE id -> codebook id is a name-derived permutation, not an offset. Both
directions are exact dense lookup tables.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np

IMG_PREFIX = "IMGIMG"


class VocabMapping(NamedTuple):
    """bpe2img: [max_bpe_id + 1] codebook id per BPE id (0 elsewhere);
    img2bpe: [codebook_size] BPE id per codebook id; image_bpe_ids: the LM's
    image-token ids, sorted."""

    bpe2img: np.ndarray
    img2bpe: np.ndarray
    image_bpe_ids: np.ndarray


def codebook_id_from_name(name: str) -> int:
    """``IMGIMG<letters>Z`` -> codebook id (letters A..J decode as 0..9,
    other characters pass through)."""
    body = name[len(IMG_PREFIX):-1]
    return int("".join(str(ord(c) - ord("A")) if "A" <= c <= "J" else c for c in body))


def image_token_name(codebook_id: int) -> str:
    """Inverse of :func:`codebook_id_from_name`."""
    return IMG_PREFIX + "".join(chr(ord("A") + int(d)) for d in str(codebook_id)) + "Z"


def mapping_from_vocab(vocab_map: Mapping[str, int]) -> VocabMapping:
    """The translation from a tokenizer vocabulary (name -> id), e.g.
    ``tokenizer.get_vocab()``."""
    bpe2img_d: Dict[int, int] = {tok: codebook_id_from_name(name)
                                 for name, tok in vocab_map.items()
                                 if name.startswith(IMG_PREFIX)}
    if not bpe2img_d:
        raise ValueError("vocabulary contains no IMGIMG image tokens")
    bpe_ids = np.asarray(sorted(bpe2img_d), np.int32)
    bpe2img = np.zeros(int(bpe_ids.max()) + 1, np.int32)
    img2bpe = np.zeros(max(bpe2img_d.values()) + 1, np.int32)
    for bpe, img in bpe2img_d.items():
        bpe2img[bpe] = img
        img2bpe[img] = bpe
    return VocabMapping(bpe2img=bpe2img, img2bpe=img2bpe, image_bpe_ids=bpe_ids)


def mapping_from_tokenizer(tokenizer) -> VocabMapping:
    """Any tokenizer with ``get_vocab()``."""
    return mapping_from_vocab(tokenizer.get_vocab())


def identity_mapping(codebook_size: int = 8192, bpe_offset: int = 4) -> VocabMapping:
    """Offset-only fallback (codebook id k <-> BPE id k + offset) for random
    weights without a tokenizer. NOT the real Chameleon permutation."""
    img = np.arange(codebook_size, dtype=np.int32)
    bpe = img + bpe_offset
    bpe2img = np.zeros(codebook_size + bpe_offset, np.int32)
    bpe2img[bpe] = img
    return VocabMapping(bpe2img=bpe2img, img2bpe=bpe, image_bpe_ids=bpe)


def bpe_to_img(mapping: VocabMapping, ids) -> np.ndarray:
    """LM image-token ids -> VQ codebook ids. Raises when an id is not an
    image token (a silent clamp would decode a corrupted image)."""
    arr = np.asarray(ids)
    bad = ~np.isin(arr, mapping.image_bpe_ids)
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} ids are not LM image tokens (e.g. "
            f"{np.unique(arr[bad])[:8].tolist()}): the generation likely "
            "terminated inside an image")
    return np.take(mapping.bpe2img, arr)


def img_to_bpe(mapping: VocabMapping, ids) -> np.ndarray:
    """VQ codebook ids -> LM image-token ids. Raises on an id outside the
    codebook."""
    arr = np.asarray(ids)
    table = mapping.img2bpe
    if arr.size and (arr.min() < 0 or arr.max() >= table.shape[0]):
        raise ValueError(f"codebook ids out of range [0, {table.shape[0]}): "
                         f"min={arr.min()}, max={arr.max()}")
    return np.take(table, arr)
