"""Engine configurations held against sjd_tpu (the port of the cases of
tests/test_engine_edges.py:14 and :113, and the other edges of the engine
loop): interval gating, repeat_horizon drafts, the jacobi scheme, a
left-padded prompt, CFG by prompt masking and by a negative prompt shorter
or longer than the positive one, and windows of 2 and 1.

Both packages decode greedily on the same parameters (tests/helpers.py's
TINY through params_from_jax) and the port replays the JAX engine's draft
seeds (engine.py:641-642, 715-718), so the generated tokens, NFE,
accept_hist and steps_multi must be equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import TINY, make_engine, tiny_params
from sjd_tpu.core import SamplingParams as JaxSamplingParams
from sjd_tpu.core.sampling import split_rows
from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax
from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine, StepDraws
from sjd_tpu_torch.core.grammar import GrammarSpec
from sjd_tpu_torch.core.processors import SamplingParams
from sjd_tpu_torch.models.adapter import decoder_model_fns

CFG = decoder_config_from_jax(TINY)

# name: (engine keywords, prompt rows, prompt mask, negative prompt rows)
CASES = {
    "interval_gating": (dict(window=6, interval_r=8), [[1, 2, 3], [4, 5, 6]], None, None),
    "repeat_horizon": (dict(window=6, init="repeat_horizon"), [[1, 2, 3], [7, 8, 9]], None,
                       None),
    "jacobi": (dict(window=4, scheme="jacobi"), [[5, 6, 7]], None, None),
    "left_padded": (dict(window=4, scheme="jacobi"), [[0, 0, 5, 6, 7], [9, 8, 7, 6, 5]],
                    [[False, False, True, True, True], [True] * 5], None),
    "mask_prompt_cfg": (dict(window=5, cfg_mode="mask_prompt"), [[1, 2, 3, 4], [4, 3, 2, 1]],
                        None, None),
    "neg_prompt_shorter": (dict(window=4, cfg_mode="neg_prompt"), [[1, 2, 3, 4, 5, 6]], None,
                           [[9, 10]]),
    "neg_prompt_longer": (dict(window=4, cfg_mode="neg_prompt"), [[1, 2, 3, 4]], None,
                          [list(range(1, 41))]),
    "window_2": (dict(window=2), [[1, 2, 3]], None, None),
    "window_1": (dict(window=1), [[1, 2, 3]], None, None),
}


def _replayed_seeds(key, B, W, lo, hi):
    """The fresh draft seeds the JAX engine draws at each decode step."""
    rng = split_rows(jax.random.split(key, B), 2)[:, 0]
    while True:
        ks = split_rows(rng, 4)
        rng = ks[:, 0]
        yield torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.randint(k, (W - 1,), lo, hi + 1, jnp.int32))(ks[:, 1])))


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_engine_edge_equals_jax(case):
    kw, prompt, mask, neg = CASES[case]
    kw = dict(dict(scheme="speculative_jacobi", init="random", cfg_mode="none",
                   interval_r=10**9), **kw)
    max_len = 24
    do_cfg = kw["cfg_mode"] != "none"
    jeng = make_engine(max_len=max_len, sampling=JaxSamplingParams(
        do_cfg=do_cfg, guidance_scale=2.0, image_top_k=64, text_top_k=64, greedy=True), **kw)
    eng = SJDEngine(
        decoder_model_fns(CFG, max_positions=512, device="cpu"),
        EngineConfig(max_len=max_len, **kw),
        GrammarSpec(kind="none", image_vocab_start=0, image_vocab_end=63),
        SamplingParams(do_cfg=do_cfg, guidance_scale=2.0, image_top_k=64, text_top_k=64,
                       greedy=True))
    jparams = tiny_params()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), CFG, device="cpu")

    key = jax.random.PRNGKey(3)
    jkw, tkw = {}, {}
    if mask is not None:
        jkw["prompt_mask"] = jnp.asarray(mask)
        tkw["prompt_mask"] = torch.tensor(mask)
    if neg is not None:
        jkw["neg_prompt"] = jnp.asarray(neg, jnp.int32)
        tkw["neg_prompt"] = torch.tensor(neg)
    want = jeng.generate(jparams, key, jnp.asarray(prompt, jnp.int32), **jkw)

    B, W = len(prompt), kw["window"]
    seeds = _replayed_seeds(key, B, W, 0, 63)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(B, W - 1), None)
    got = eng.generate(params, 0, torch.tensor(prompt), **tkw)

    for b in range(B):
        n = int(want.length[b])
        assert int(got.length[b]) == n, (b, int(got.length[b]), n)
        np.testing.assert_array_equal(got.tokens[b, :n].numpy(), np.asarray(want.tokens[b, :n]))
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    np.testing.assert_array_equal(got.steps_multi.numpy(), np.asarray(want.steps_multi))
    np.testing.assert_array_equal(got.gen_count.numpy(), np.asarray(want.gen_count))
