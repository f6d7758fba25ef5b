"""Operations and bytes of K1, attention and the whole step against shapes
worked by hand, and the window arithmetic: the rate read at chunk
boundaries."""

import pytest

from port_bench import account
from port_bench.recorder import Call
from port_bench.roofline import attention, k1, peaks, step
from port_bench.roofline.shapes import model_dims

LUMINA = {"hidden_size": 4096, "intermediate_size": 11008, "num_attention_heads": 32,
          "num_key_value_heads": 32, "num_hidden_layers": 32, "vocab_size": 65536,
          "serving": {"kv_cache": "int8"}}
EMU3 = {"hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
        "num_key_value_heads": 8, "num_hidden_layers": 32, "vocab_size": 184622,
        "serving": {"kv_cache": "bfloat16"}}


def test_k1_launch_by_hand():
    # wq at M = 32: 2 * 32 * 4096 * 4096 operations; 4096 * 4096 / 2 bytes of
    # packed weight, 8192 of scales, 262144 in, 262144 out
    ops, nbytes = k1.launch(32, 4096, 4096, 4)
    assert ops == 2 * 32 * 4096 * 4096 == 1073741824
    assert nbytes == 8388608 + 8192 + 262144 + 262144
    # the int8 head: a byte per weight
    assert k1.launch(32, 65536, 4096, 8)[1] == 268435456 + 131072 + 262144 + 4194304


def test_k1_forward_launches():
    m = model_dims(LUMINA)
    ls = k1.forward_launches(m, 160, 160)
    assert len(ls) == 32 * 7 + 1
    assert ls[-1] == (160, 65536, 4096, 8)
    e = model_dims(EMU3)
    assert k1.forward_launches(e, 96, 96)[1] == (96, 1024, 4096, 4)  # wk: 8 heads of 128


def test_bound_is_the_larger():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    # K1's wq at M = 32 is bytes-bound: 8921088 bytes over 3.35 TB/s
    assert k1.bound([(32, 4096, 4096, 4)]) == pytest.approx(8921088 / 3.35e12)


def test_attention_by_hand():
    m = model_dims(LUMINA)
    # one sample, window 16, 1000 live rows, int8 K and V with bf16 scales:
    # 2 * 1000 * 32 * (128 + 2) bytes of cache, q and out 2 * 16 * 32 * 128 * 2
    ops, nbytes = attention.layer_call(m, 16, [1000])
    assert nbytes == 2 * 1000 * 32 * 130 + 2 * 16 * 32 * 128 * 2
    assert ops == 4 * 16 * 32 * 128 * 1000
    e = model_dims(EMU3)  # bf16 cache, 8 KV heads, no scales
    assert attention.layer_call(e, 16, [1000])[1] == 2 * 1000 * 8 * 256 + 2 * 16 * 32 * 128 * 2


def test_step_flops_by_hand():
    m = model_dims(LUMINA)
    per_row = 2 * (4 * 4096 * 4096 + 3 * 4096 * 11008) * 32 + 2 * 65536 * 4096
    attn = 4 * 16 * 32 * 128 * 500 * 32
    assert step.decode_flops(m, 1, 16, [500]) == 16 * per_row + attn
    pre = step.prefill_flops(m, 2, 100, 2)
    assert pre == (200 * 2 * (4 * 4096 * 4096 + 3 * 4096 * 11008) * 32
                   + 2 * 2 * 65536 * 4096 + 2 * 32 * 128 * 100 * 100 * 2 * 32)


def _call(kind, len0, len1, nfe0, nfe1, refilled=0, hist=(0, 4, 2)):
    return Call(kind=kind, t0=0.0, t1=0.5, nfe0=nfe0, nfe1=nfe1, len0=list(len0),
                len1=list(len1), refilled=refilled, hist=list(hist), prompt_rows=100,
                slots=len(len1))


def test_rate_at_chunk_boundaries():
    calls = [
        _call("resume", [150, 300], [180, 330], 10, 30),
        # slot 0 finished at 180 and is re-armed: its prefill commits a token
        _call("refill", [180, 330], [101, 330], 30, 31, refilled=1, hist=(0, 0, 0)),
        _call("resume", [101, 330], [125, 352], 31, 51),
    ]
    w = account.from_calls(calls, 16, 2, wall_s=2.0)
    assert w.tokens == 30 + 30 + 1 + 24 + 22
    assert w.forwards == 20 + 1 + 20
    assert w.prefills == [(4, 100, 4)]
    n, S, T, fills = w.decodes[0]
    # slot 0 grows 150 -> 180: each forward reads length - 1 + 16 rows
    assert (n, S, T) == (20, 4, 16) and fills[0] == pytest.approx(20 * (165 - 1 + 16))
    assert fills[2] == fills[0]  # the uncond half reads the same rows
    assert w.hist == [0, 8, 4]
    assert w.engine_s == pytest.approx(1.5)
