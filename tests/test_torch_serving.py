"""The port's chunked generation, refill and continuous batching
(sjd_tpu_torch/core/engine.py resume/refill, core/serving.py) against
tests/test_continuous_batching.py's properties and against sjd_tpu itself,
at its tiny shapes (tests/helpers.py: 2 layers, d=32, vocab 64, the tiny
image grammar, eos = the image end so a slot's length is its grid).

All checks are exact: chunking and refill only regroup the same steps, and
greedy decoding makes tokens independent of the random draws. Where NFE is
compared with sjd_tpu, the port replays the JAX engine's draft seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import TINY, TINY_GRAMMAR, make_engine, tiny_params
from sjd_tpu.core import SamplingParams as JaxSamplingParams
from sjd_tpu.core.sampling import split_rows
from sjd_tpu.core.serving import ContinuousBatcher as JaxContinuousBatcher
from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax
from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine, StepDraws
from sjd_tpu_torch.core.grammar import GrammarSpec
from sjd_tpu_torch.core.processors import SamplingParams
from sjd_tpu_torch.core.serving import ContinuousBatcher, seed_generators
from sjd_tpu_torch.models.adapter import decoder_model_fns

PSPEC = GrammarSpec(**{f: getattr(TINY_GRAMMAR, f) for f in (
    "kind", "image_start_id", "image_end_id", "newline_id", "image_vocab_start",
    "image_vocab_end", "size_token_base", "grid_scale", "header_len")})
CFG = decoder_config_from_jax(TINY)
W = 5


@pytest.fixture(scope="module")
def jax_params():
    return tiny_params()


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), CFG, device="cpu")


def engine(greedy=False, cfg_mode="none"):
    """The port of test_continuous_batching.py's grammar_engine."""
    model = decoder_model_fns(CFG, max_positions=512, device="cpu")
    return SJDEngine(
        model, EngineConfig(window=W, scheme="speculative_jacobi", max_len=64, eos_id=49,
                            cfg_mode=cfg_mode),
        PSPEC, SamplingParams(do_cfg=cfg_mode != "none", guidance_scale=2.0,
                              image_top_k=44, text_top_k=60, greedy=greedy))


def grid_prompt(size_tok):
    return [1, 2, 48, size_tok, size_tok]  # 48 opens the image; size 53 -> 2x2, 54 -> 4x4


def assert_grid(toks, size_tok):
    """``toks`` after the prompt: rows of image tokens and <eol>, then <end>."""
    side = (size_tok - 52) * 2
    i = 0
    for _ in range(side):
        assert all(4 <= t <= 47 for t in toks[i:i + side]), toks
        assert toks[i + side] == 50, toks
        i += side + 1
    assert toks[i] == 49, toks


def rows(state_or_result, b):
    return state_or_result.tokens[b, :int(state_or_result.length[b])].numpy().copy()


def run_chunked(eng, params, state, chunk, limit=200):
    for _ in range(limit):
        if bool(state.finished.all()):
            return state
        _, state = eng.resume(params, state, max_steps=chunk, return_state=True)
    raise AssertionError("generation did not finish")


@pytest.mark.parametrize("chunk", [1, 4])
def test_chunked_resume_equals_one_generate(params, chunk):
    """generate(max_steps=k) + resume chunks == one uninterrupted generate:
    tokens, lengths, NFE, accept_hist, steps_multi (sampled, per-slot
    generators)."""
    eng = engine()
    prompts = torch.tensor([grid_prompt(53), grid_prompt(54)])
    want = eng.generate(params, 7, prompts)
    _, state = eng.generate(params, 7, prompts, max_steps=3, return_state=True)
    assert state.nfe == 3
    state = run_chunked(eng, params, state, chunk)
    for b in range(2):
        np.testing.assert_array_equal(rows(state, b), rows(want, b))
    assert state.nfe == want.nfe
    assert torch.equal(state.accept_hist, want.accept_hist)
    assert torch.equal(state.steps_multi, want.steps_multi)


def test_state_is_reused_and_results_survive(params):
    """The engine keeps its state while the shape holds: a second generate
    writes into the same tensors, and the first call's GenerateResult (a
    copy) stays."""
    eng = engine()
    prompts = torch.tensor([grid_prompt(53), grid_prompt(54)])
    first, s1 = eng.generate(params, 1, prompts, return_state=True)
    kept = first.tokens.clone()
    ptrs = [t.data_ptr() for t in (s1.tokens, s1.kv.k, s1.valid, s1.carried_probs)]
    _, s2 = eng.generate(params, 2, prompts, max_steps=2, return_state=True)
    assert s2 is s1
    assert [t.data_ptr() for t in (s2.tokens, s2.kv.k, s2.valid, s2.carried_probs)] == ptrs
    assert torch.equal(first.tokens, kept)


def test_new_prompt_width_releases_the_old_state(params):
    """The engine holds one state, not one per shape: a generate of another
    prompt width replaces it, a resume or refill of the released state
    raises, and going back to the first width allocates anew."""
    eng = engine()
    _, s5 = eng.generate(params, 1, torch.tensor([grid_prompt(53)] * 2), max_steps=2,
                         return_state=True)
    _, s7 = eng.generate(params, 1, torch.tensor([[0, 0] + grid_prompt(53)] * 2),
                         max_steps=2, return_state=True)
    assert eng._state is s7 and s7.tokens.shape[1] == s5.tokens.shape[1] + 2
    with pytest.raises(ValueError, match="no longer the engine's own"):
        eng.resume(params, s5, max_steps=1)
    with pytest.raises(ValueError, match="no longer the engine's own"):
        eng.refill(params, s5, torch.tensor([grid_prompt(53)] * 2), [True, False])
    _, again = eng.generate(params, 1, torch.tensor([grid_prompt(53)] * 2), max_steps=2,
                            return_state=True)
    assert eng._state is again and again is not s5


def _replayed_seeds(key, B, lo, hi):
    """The fresh draft seeds the JAX engine draws at each decode step, from
    one [2] key split by batch position (engine.py:641-642, 715-718)."""
    rng = split_rows(jax.random.split(key, B), 2)[:, 0]
    while True:
        ks = split_rows(rng, 4)
        rng = ks[:, 0]
        yield torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.randint(k, (W - 1,), lo, hi + 1, jnp.int32))(ks[:, 1])))


def test_greedy_resume_chunks_equal_jax(jax_params, params):
    """Greedy generate(max_steps=3) then resume(max_steps=4) chunks: the
    port and sjd_tpu agree on every row and on NFE at every chunk boundary,
    and on accept_hist at the end."""
    jeng = make_engine(window=W, scheme="speculative_jacobi", max_len=64, cfg_mode="none",
                       grammar=TINY_GRAMMAR, eos_id=49,
                       sampling=JaxSamplingParams(do_cfg=False, image_top_k=44,
                                                  text_top_k=60, greedy=True))
    eng = engine(greedy=True)
    prompts = [grid_prompt(53), grid_prompt(54)]
    key = jax.random.PRNGKey(3)
    seeds = _replayed_seeds(key, 2, PSPEC.image_vocab_start, PSPEC.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(2, W - 1), None)

    jres, jstate = jeng.generate(jax_params, key, jnp.asarray(prompts, jnp.int32),
                                 max_steps=3, return_state=True)
    res, state = eng.generate(params, 0, torch.tensor(prompts), max_steps=3,
                              return_state=True)
    for _ in range(100):
        assert res.nfe == int(jres.nfe)
        for b in range(2):
            n = int(jres.length[b])
            assert int(res.length[b]) == n
            np.testing.assert_array_equal(res.tokens[b, :n].numpy(),
                                          np.asarray(jres.tokens[b, :n]))
        if bool(np.asarray(jstate.finished).all()):
            break
        jres, jstate = jeng.resume(jax_params, jstate, max_steps=4, return_state=True)
        res, state = eng.resume(params, state, max_steps=4, return_state=True)
    assert bool(state.finished.all())
    np.testing.assert_array_equal(res.accept_hist.numpy(), np.asarray(jres.accept_hist))


def test_refill_preserves_live_slots_bit_exactly(params):
    """Slot 0 finishes early (2x2 grid), slot 1 runs long (4x4): refilling
    slot 0 mid-flight changes nothing of slot 1's tokens."""
    eng = engine()
    prompts = torch.tensor([grid_prompt(53), grid_prompt(54)])
    want = rows(eng.generate(params, 0, prompts), 1)
    _, state = eng.generate(params, 0, prompts, max_steps=4, return_state=True)
    refilled = False
    for _ in range(64):
        fin = state.finished.numpy()
        if fin.all():
            break
        if fin[0] and not refilled:
            state = eng.refill(params, state, torch.tensor([grid_prompt(53)] * 2),
                               np.asarray([True, False]))
            refilled = True
        _, state = eng.resume(params, state, max_steps=4, return_state=True)
    assert refilled, "slot 0 never finished: test setup broken"
    np.testing.assert_array_equal(rows(state, 1), want)


def test_refill_slot_regenerates_valid_grammar(params):
    """The refilled slot produces a whole grid for its new prompt (fresh KV
    prefill, grammar re-armed)."""
    eng = engine()
    _, state = eng.generate(params, 0, torch.tensor([grid_prompt(53), grid_prompt(54)]),
                            max_steps=200, return_state=True)
    assert bool(state.finished[0])
    state = eng.refill(params, state, torch.tensor([grid_prompt(54)] * 2),
                       np.asarray([True, False]))
    _, state = eng.resume(params, state, max_steps=400, return_state=True)
    assert bool(state.finished.all())
    assert_grid(rows(state, 0)[5:], 54)


@pytest.mark.parametrize("seeded", [False, True], ids=["derived", "seeded"])
def test_refill_counts_one_forward_and_keeps_live_generators(params, seeded):
    """NFE rises by exactly 1; the live slot's generator is the same object
    in the same position; the refilled slot gets the caller's generator, or
    one derived without advancing any."""
    eng = engine()
    prompts = torch.tensor([grid_prompt(53), grid_prompt(53)])
    _, state = eng.generate(params, 0, prompts, max_steps=200, return_state=True)
    nfe0 = state.nfe
    live, old = state.gens[1], state.gens[0]
    live_pos, old_pos = live.get_state(), old.get_state()
    given = seed_generators([5, 6], "cpu") if seeded else None
    state = eng.refill(params, state, prompts, np.asarray([True, False]), rng=given)
    assert state.nfe == nfe0 + 1
    assert state.gens[1] is live and torch.equal(live.get_state(), live_pos)
    assert torch.equal(old.get_state(), old_pos)
    if seeded:
        assert state.gens[0] is given[0]
    else:
        assert state.gens[0] is not old


def test_refill_under_neg_prompt_cfg(params):
    """Emu3-style CFG (a separate left-padded negative prompt): refill
    rebuilds both halves of the doubled batch for the refilled slot and
    leaves the live slot's cond and uncond KV untouched."""
    eng = engine(cfg_mode="neg_prompt")
    prompts = torch.tensor([grid_prompt(53), grid_prompt(54)])
    neg = torch.tensor([[7, 8, 48, 53, 53], [7, 8, 48, 54, 54]])
    want = rows(eng.generate(params, 0, prompts, neg_prompt=neg), 1)
    _, state = eng.generate(params, 0, prompts, neg_prompt=neg, max_steps=4,
                            return_state=True)
    refilled = False
    for _ in range(64):
        fin = state.finished.numpy()
        if fin.all():
            break
        if fin[0] and not refilled:
            state = eng.refill(params, state, torch.tensor([grid_prompt(53)] * 2),
                               np.asarray([True, False]),
                               neg_prompt=torch.stack([neg[0], neg[0]]))
            refilled = True
        _, state = eng.resume(params, state, max_steps=4, return_state=True)
    assert refilled
    np.testing.assert_array_equal(rows(state, 1), want)
    assert_grid(rows(state, 0)[5:], 53)


def test_continuous_batcher_stream(params):
    """6 prompts through 2 slots: every prompt completes with a valid grid
    for its own size token, in stream order; the stream refilled."""
    sizes = [53, 54, 53, 54, 53, 53]
    batcher = ContinuousBatcher(engine(), params, chunk_steps=8)
    done = batcher.run(0, np.asarray([grid_prompt(s) for s in sizes]), batch=2)
    assert [c.prompt_index for c in done] == list(range(6))
    for c, s in zip(done, sizes):
        assert_grid(c.tokens[5:], s)
        assert c.gen_count == len(c.tokens) - 5
    assert len(batcher.last_refills) >= 2
    # every decode step of a live slot lands in one bin of accept_hist
    assert batcher.last_nfe > 0 and int(batcher.last_accept_hist[1:].sum()) > 0


def test_continuous_batcher_single_chunk_tail(params):
    """Queue shorter than the batch: the batch shrinks to it."""
    done = ContinuousBatcher(engine(), params, chunk_steps=16).run(
        1, np.asarray([grid_prompt(53)]), batch=4)
    assert len(done) == 1 and done[0].prompt_index == 0


def test_continuous_batcher_per_prompt_seeds(params):
    """With per-prompt seeds, prompt i's tokens are a function of
    (prompts[i], seeds[i]) alone: identical at batch widths 2 and 3."""
    sizes = [53, 54, 53, 54, 53]
    prompts = np.asarray([grid_prompt(s) for s in sizes])
    seeds = [11, 22, 33, 44, 55]
    batcher = ContinuousBatcher(engine(), params, chunk_steps=8)
    got2 = batcher.run(0, prompts, batch=2, seeds=seeds)
    got3 = batcher.run(9, prompts, batch=3, seeds=seeds)
    for c2, c3 in zip(got2, got3):
        assert c2.prompt_index == c3.prompt_index
        np.testing.assert_array_equal(c2.tokens, c3.tokens)


def test_greedy_continuous_batcher_equals_jax(jax_params, params):
    """Greedy ContinuousBatcher: per request, the port's tokens equal
    sjd_tpu's ContinuousBatcher's on the same parameters."""
    jeng = make_engine(window=W, scheme="speculative_jacobi", max_len=64, cfg_mode="none",
                       grammar=TINY_GRAMMAR, eos_id=49,
                       sampling=JaxSamplingParams(do_cfg=False, image_top_k=44,
                                                  text_top_k=60, greedy=True))
    prompts = np.asarray([grid_prompt(s) for s in [53, 54, 53, 54, 53]], np.int32)
    want = JaxContinuousBatcher(jeng, jax_params, chunk_steps=8).run(
        jax.random.PRNGKey(0), prompts, batch=2)
    got = ContinuousBatcher(engine(greedy=True), params, chunk_steps=8).run(
        0, prompts, batch=2)
    assert [c.prompt_index for c in got] == [c.prompt_index for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.gen_count == w.gen_count
