"""The plain reference against the port at tiny sizes on the CPU: it
follows the configuration's layer structure (pre-norm, or swin-norm as
Chameleon-34B's), its pre-norm outputs are the earlier reference's bit for
bit, and it refuses by name what it does not model."""

import dataclasses
import hashlib

import pytest
import torch

from port_bench import families, weights
from port_bench.reference.decoder import Decoder
from port_bench.tests import tiny

# bf16 activations and products in the port (a rounding moves a value by up
# to 2^-9 of it) through two layers leave logits of spread 1 up to 0.075
# apart from the float32 reference (both structures, this seed); the other
# layer structure reads 1.96, 26 times as far
LOGITS_TOL = 0.15
PROMPT, WINDOW, STEPS = 12, 4, 3


def _ids(cfg, n):
    lo, hi = cfg["serving"]["text_ids"]
    return torch.randint(lo, hi, (n,), generator=torch.Generator().manual_seed(3))


def _port_logits(cfg, ids):
    """The port's plain path: a prefill, then decode windows through the
    int8 cache; f32 logits of every row."""
    from sjd_tpu_torch.models.adapter import decoder_model_fns

    mcfg = dataclasses.replace(families.model_config(cfg), attn_impl="plain")
    fns = decoder_model_fns(mcfg, max_positions=256, device="cpu")
    params = families.program_params(cfg, weights.seed_of(cfg), "cpu")
    kv = fns.init_cache(1, 64)
    valid = torch.ones((1, 64), dtype=torch.bool)
    out = []
    for s, t in [(0, PROMPT)] + [(PROMPT + WINDOW * k, WINDOW) for k in range(STEPS)]:
        logits, kv = fns.forward(params, ids[None, s:s + t].int(),
                                 torch.arange(s, s + t)[None].int(), kv,
                                 torch.tensor([s], dtype=torch.int32), valid)
        out.append(logits[0])
    return torch.cat(out)


def _ref_logits(cfg, ids):
    dec = Decoder(cfg, "cpu")
    hid, _ = dec.hidden([(ids, torch.arange(len(ids)))])
    return dec.logits(hid[0])


@pytest.fixture(scope="module", params=[True, False], ids=["swin", "pre"])
def readings(request):
    """(the port's logits, the reference's, the reference's with
    ``swin_norm`` flipped) on a tiny 34B-shaped configuration, group 8."""
    cfg = dict(tiny.shaped_34b(tiny.config("lumina-mgpt-7b-w4a16")), swin_norm=request.param)
    ids = _ids(cfg, PROMPT + WINDOW * STEPS)
    return (_port_logits(cfg, ids), _ref_logits(cfg, ids),
            _ref_logits(dict(cfg, swin_norm=not request.param), ids))


def test_port_agrees_with_reference(readings):
    port, ref, _ = readings
    assert float((port - ref).abs().max()) < LOGITS_TOL


def test_flipped_structure_fails_by_tenfold(readings):
    port, _, flipped = readings
    assert float((port - flipped).abs().max()) > 10 * LOGITS_TOL


# sha256 of the float32 logits below, from the pre-norm reference before
# swin-norm was modelled (torch 2.13 on the CPU, any thread count)
GOLDEN = {
    "lumina-mgpt-7b-w4a16": "b06c02b72bff73be2d56f051b0ca4618feae1573593fc2376cc0e9f9b6463084",
    "emu3-gen-8b-w4a16": "8a5d3d68b16166c475f0f10d4df9d59793c7098cbbd5ca90f94c29708c343ce7",
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_pre_norm_reference_unchanged(name):
    """A sequence and a group of branches on the tiny A and B
    configurations: the same bits as before."""
    cfg = tiny.config(name)
    g = torch.Generator().manual_seed(5)
    lo, hi = cfg["serving"]["text_ids"]
    ids = torch.randint(lo, hi, (12,), generator=g)
    branch = torch.randint(lo, hi, (3, 4), generator=g)
    dec = Decoder(cfg, "cpu")
    hid, bhid = dec.hidden([(ids, torch.arange(12))], {0: [(branch, torch.tensor([4, 7, 11]))]})
    out = torch.cat([dec.logits(hid[0]), dec.logits(bhid[0][0].reshape(-1, hid[0].shape[-1]))])
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == GOLDEN[name]


@pytest.mark.parametrize("over,key", [
    ({"tie_word_embeddings": True}, "tie_word_embeddings"),
    ({"rope_style": "2d"}, "rope_style"),
    ({"attention_bias": False}, "attention_bias"),
    ({"head_dim": 128}, "head_dim"),
    ({"swin_norm": "yes"}, "swin_norm"),
], ids=["tied", "rope_2d", "unknown_key", "head_dim", "swin_not_bool"])
def test_refuses_what_it_does_not_model(over, key):
    cfg = dict(tiny.config("lumina-mgpt-7b-w4a16"), **over)
    with pytest.raises(ValueError, match=key):
        Decoder(cfg, "cpu")
