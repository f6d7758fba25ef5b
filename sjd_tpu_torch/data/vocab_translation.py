"""Chameleon BPE <-> VQ-codebook vocabulary translation
(sjd_tpu/data/vocab_translation.py), host-side numpy: the identity-offset
fallback for tokenizer-free runs and the checked BPE -> codebook lookup.
Building the mapping from a tokenizer's IMGIMG names is not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class VocabMapping(NamedTuple):
    """bpe2img: [max_bpe_id + 1] codebook id per BPE id (0 elsewhere);
    img2bpe: [codebook_size] BPE id per codebook id; image_bpe_ids: the LM's
    image-token ids, sorted."""

    bpe2img: np.ndarray
    img2bpe: np.ndarray
    image_bpe_ids: np.ndarray


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
