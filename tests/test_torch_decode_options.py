"""The decode options of the JAX engine, in the port, held against sjd_tpu
on the same numpy inputs: the top-p filter (and ``approx_top_k``), the
``sample_horizon`` draft seeds, the sequential window decomposer, the
live-prefix chunked attention (``attn_buckets``) and the 1-token AR fast
path (``ar_fast_path``).

Exact functions are held bit for bit (masks, tokens, one-hot scores, draft
distributions); probabilities after a softmax to f32 rtol 1e-6 (the two
frameworks sum in another order); f32 logits of the chunked attention to
rtol 1e-5 of the unchunked forward (an online softmax reassociates the
sums). Where the JAX side draws random numbers the port replays them;
sampled decomposer rows, whose noise comes from another generator, are
held by distribution (a chi-square test)."""

import dataclasses

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from helpers import TINY, TINY_GRAMMAR, tiny_params
from sjd_tpu.core import EngineConfig as JaxEngineConfig
from sjd_tpu.core import SamplingParams as JaxSamplingParams
from sjd_tpu.core import SJDEngine as JaxSJDEngine
from sjd_tpu.core import decomposer as jdec
from sjd_tpu.core import drafts as jd
from sjd_tpu.core import grammar as jg
from sjd_tpu.core import processors as jp
from sjd_tpu.core import sampling as js
from sjd_tpu.models import decoder_model_fns as jax_model_fns
from sjd_tpu.models import transformer as jt
from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax
from sjd_tpu_torch.core import DecomposeResult, sequential_decompose
from sjd_tpu_torch.core import drafts as pd
from sjd_tpu_torch.core import grammar as pg
from sjd_tpu_torch.core import processors as pp
from sjd_tpu_torch.core import sampling as ps
from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine, StepDraws
from sjd_tpu_torch.models import transformer as pt
from sjd_tpu_torch.models.adapter import decoder_model_fns
from test_torch_lumina_slice import _replayed_seeds

V = 64
PSPEC = pg.GrammarSpec(**{f: getattr(TINY_GRAMMAR, f) for f in (
    "kind", "image_start_id", "image_end_id", "newline_id", "image_vocab_start",
    "image_vocab_end", "size_token_base", "grid_scale", "header_len")})
NONE_SPEC = pg.GrammarSpec(kind="none", image_vocab_start=0, image_vocab_end=V - 1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _states(img_count, h=4, w=4, in_image=True, size_known=True):
    B = len(img_count)
    arrs = dict(in_image=np.full(B, in_image), size_known=np.full(B, size_known),
                h_lat=np.full(B, h, np.int32), w_lat=np.full(B, w, np.int32),
                img_count=np.asarray(img_count, np.int32),
                header_seen=np.full(B, 2, np.int32))
    return (jg.GrammarState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            pg.GrammarState(**{k: _t(v) for k, v in arrs.items()}))


def _sampling(**kw):
    """The same sampling parameters for both packages."""
    return JaxSamplingParams(**kw), pp.SamplingParams(**kw)


def _away_from_boundary(scores, p, margin=1e-4):
    """Whether no row's ascending softmax cumsum lies within ``margin`` of
    1 - p, so that f32 reassociation cannot move a token across the cut."""
    s = np.sort(scores.astype(np.float64), axis=-1)
    e = np.exp(s - s.max(-1, keepdims=True))
    cum = np.cumsum(e / e.sum(-1, keepdims=True), axis=-1)
    return bool(np.abs(cum - (1.0 - p)).min() > margin)


def _scores(seed, shape, p, masked=0):
    """Normal scores drawn away from the top-p cut, with ``masked`` entries
    of each row already at NEG_INF (as after top-k)."""
    for s in range(seed, seed + 100):
        rng = np.random.default_rng(s)
        x = (2.0 * rng.standard_normal(shape)).astype(np.float32)
        if masked:
            idx = np.argsort(x, axis=-1)[..., :masked]
            np.put_along_axis(x, idx, ps.NEG_INF, axis=-1)
        if _away_from_boundary(np.where(x <= ps.NEG_INF, -np.inf, x), p):
            return x
    raise AssertionError("no draw away from the top-p boundary")


@pytest.mark.parametrize("p,masked", [(0.5, 0), (0.9, 0), (0.95, 20), (0.99, 40)])
def test_top_p_equals_jax(p, masked):
    """The filter alone over [B, W, V]: the same kept scores, the same
    NEG_INF elsewhere, bit for bit."""
    x = _scores(int(p * 100) + masked, (3, 5, V), p, masked)
    want = np.asarray(js.top_p(jnp.asarray(x), p))
    got = ps.top_p(_t(x), p).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > ps.NEG_INF).sum(-1).min() >= 1


def test_top_p_keeps_nucleus():
    """tests/test_drafts_processors.py:96 on the port: 0.5 + 0.3 = 0.8 kept,
    the tail dropped; equal to the JAX filter."""
    logits = np.log(np.asarray([[0.5, 0.3, 0.15, 0.05]], np.float32))
    out = ps.top_p(_t(logits), 0.8).numpy()
    assert np.isfinite(out[0, :2]).all() and out[0, 3] < -1e30
    np.testing.assert_array_equal(out, np.asarray(js.top_p(jnp.asarray(logits), 0.8)))


@pytest.mark.parametrize("top_p,approx", [(0.9, False), (0.8, True), (None, True)])
def test_top_p_through_processors_equals_jax(top_p, approx):
    """process_window_logits (CFG, grammar, top-k, top-p) and
    process_residual_logits against the JAX pipeline: the same support
    exactly, the probabilities within f32 rtol 1e-6. ``approx_top_k`` is
    the JAX package's TPU switch; the port's threshold stays exact, so it
    is held against the JAX exact path."""
    B, W = 3, 5
    rng = np.random.default_rng(11)
    logits = (2.0 * rng.standard_normal((2 * B, W, V))).astype(np.float32)
    residual = (2.0 * rng.standard_normal((B, V))).astype(np.float32)
    jst, pst = _states([3, 8, 14])
    kw = dict(do_cfg=True, guidance_scale=2.0, image_top_k=30, text_top_k=20, top_p=top_p)
    jparams, _ = _sampling(**kw)
    pparams = pp.SamplingParams(approx_top_k=approx, **kw)
    force = np.asarray([False, True, False])
    want = np.asarray(jp.process_window_logits(
        jnp.asarray(logits), TINY_GRAMMAR, jst, jparams, force_no_cfg=jnp.asarray(force)))
    got = pp.process_window_logits(_t(logits), PSPEC, pst, pparams,
                                   force_no_cfg=_t(force)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    off = np.asarray([0, 2, 4], np.int32)
    want = np.asarray(jp.process_residual_logits(
        jnp.asarray(residual), TINY_GRAMMAR, jst, jparams, jnp.asarray(off)))
    got = pp.process_residual_logits(_t(residual), PSPEC, pst, pparams, _t(off)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if top_p is not None:  # the filter did remove tokens
        assert (got > 0).sum(-1).max() < 30


@pytest.mark.parametrize("counts", [(0, 2, 5), (0, 0, 0), (3, 1, 5)])
def test_build_window_sample_horizon_equals_jax(counts):
    """build_window(scheme="sample_horizon") with the JAX engine's fresh
    seeds replayed: tokens and p_draft exact. A slot with no carried
    source falls back to the argmax of ``last_prob``, which differs here
    from the last committed token (the sampled one)."""
    B, W, L = 3, 6, 40
    rng = np.random.default_rng(sum(counts) + 2)
    tokens = rng.integers(4, 48, (B, L)).astype(np.int32)
    length = np.asarray([12, 20, 31], np.int32)
    last_prob = rng.random((B, V)).astype(np.float32)
    last_prob[:, 30] = 2.0  # its argmax, an image token
    tokens[np.arange(B), length - 1] = 9  # the token sampled from it
    carried = rng.integers(4, 48, (B, W)).astype(np.int32)
    carried_probs = rng.random((B, W, V)).astype(np.float32)
    count = np.asarray(counts, np.int32)
    jst, pst = _states([3, 8, 14])
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    lo, hi = pd.draft_range(PSPEC, V)
    rand = jax.vmap(lambda k: jax.random.randint(k, (W - 1,), lo, hi + 1, jnp.int32))(keys)
    common = dict(scheme="sample_horizon", window=W, vocab_size=V, grammar_seed=True)
    want = jd.build_window(
        keys, spec=TINY_GRAMMAR, gstate=jst, tokens=jnp.asarray(tokens),
        length=jnp.asarray(length), last_prob=jnp.asarray(last_prob),
        carried_tokens=jnp.asarray(carried), carried_probs=jnp.asarray(carried_probs),
        carried_count=jnp.asarray(count), **common)
    got = pd.build_window(
        _t(rand), spec=PSPEC, gstate=pst, tokens=_t(tokens), length=_t(length),
        last_prob=_t(last_prob), carried_tokens=_t(carried),
        carried_probs=_t(carried_probs), carried_count=_t(count), **common)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.p_draft.numpy(), np.asarray(want.p_draft))
    if counts == (0, 0, 0):  # every grid-column slot seeds from last_prob's argmax
        assert (got.x[:, 1:] == 30).any() and not (got.x[:, 1:] == 9).any()


def _port_loop_greedy(scores, spec, gstate, params):
    """The port's per-token oracle: apply_grammar_single with the current
    state, top-k, argmax, update_state (tests/test_decomposer.py:29)."""
    B, W, _ = scores.shape
    g = gstate
    toks = []
    for i in range(W):
        s = pg.apply_grammar_single(spec, g, scores[:, i], torch.zeros(B, dtype=torch.int32))
        s = ps.top_k_dual(s[:, None], g.in_image, params.image_top_k,
                          params.text_top_k)[:, 0]
        tok = torch.argmax(torch.softmax(s, -1), -1).to(torch.int32)
        g = pg.update_state(spec, g, tok[:, None], torch.ones(B, dtype=torch.int32))
        toks.append(tok)
    return torch.stack(toks, 1), g


def _midwindow_logits():
    """tests/test_decomposer.py:69: rows that greedily emit <image_start>
    <h=54> <w=53>, then prefer a text token the armed grammar suppresses."""
    W = 9
    logits = np.full((1, W, V), -10.0, np.float32)
    logits[0, 0, 48], logits[0, 1, 54], logits[0, 2, 53] = 10.0, 10.0, 10.0
    logits[0, 3:, 60], logits[0, 3:, 7] = 10.0, 5.0
    return logits


@pytest.mark.parametrize("case", ["in_image", "mid_window_header", "cfg", "top_p"])
def test_sequential_decompose_greedy_equals_jax(case):
    """Greedy tokens, the one-hot scores and the advanced grammar state
    against sjd_tpu's sequential_decompose and decompose_window_sequential
    (fix_logits on and off) and against the per-token loop."""
    kw = dict(do_cfg=False, image_top_k=64, text_top_k=64)
    if case == "mid_window_header":
        logits = _midwindow_logits()
        jst, pst = jg.init_state(1), pg.init_state(1)
    else:
        logits = np.random.default_rng(1).standard_normal((2, 8, V)).astype(np.float32)
        jst, pst = _states([2, 0], h=4, w=4)
        if case == "cfg":
            kw.update(do_cfg=True, guidance_scale=3.0)
            logits = np.concatenate([logits, 0.5 * logits[::-1]], axis=0)
        if case == "top_p":
            kw.update(top_p=0.7)
    jparams, pparams = _sampling(**kw)
    want = jdec.sequential_decompose(jax.random.PRNGKey(0), jnp.asarray(logits),
                                     TINY_GRAMMAR, jst, jparams, greedy=True)
    got = sequential_decompose(None, _t(logits), PSPEC, pst, pparams, greedy=True)
    assert isinstance(got, DecomposeResult)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.fixed_scores.numpy(), np.asarray(want.fixed_scores))
    for a, b in zip(got.gstate, want.gstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case == "mid_window_header":  # the header armed the later rows
        assert got.tokens[0].tolist() == [48, 54, 53, 7, 7, 50, 7, 7, 50]
    if case in ("cfg", "top_p"):
        return
    loop_toks, loop_g = _port_loop_greedy(_t(logits), PSPEC, pst, pparams)
    np.testing.assert_array_equal(got.tokens.numpy(), loop_toks.numpy())
    gparams = dataclasses.replace(pparams, greedy=True)
    jgparams = dataclasses.replace(jparams, greedy=True)
    for fix in (True, False):
        w_out, w_tok = jp.decompose_window_sequential(
            jax.random.PRNGKey(0), jnp.asarray(logits), TINY_GRAMMAR, jst, jgparams,
            fix_logits=fix)
        g_out, g_tok = pp.decompose_window_sequential(None, _t(logits), PSPEC, pst, gparams,
                                                      fix_logits=fix)
        np.testing.assert_array_equal(g_tok.numpy(), np.asarray(w_tok))
        np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))


@pytest.mark.parametrize("fn", ["sequential_decompose", "decompose_window_sequential"])
def test_sequential_rows_sample_the_constrained_distribution(fn):
    """Sampled rows (Gumbel noise from a torch generator, which JAX's
    threefry stream cannot replay): over 6000 draws each row's tokens follow
    the constrained distribution, the grammar advanced by the row's offset
    inside a 4 x 4 grid (a chi-square test at p = 1e-4), and the <eol>
    rows are exact."""
    N, W = 6000, 6
    base = np.random.default_rng(5).standard_normal((1, W, V)).astype(np.float32)
    jparams, pparams = _sampling(do_cfg=False, image_top_k=12, text_top_k=12)
    jst, pst = _states([0] * N)
    g = torch.Generator().manual_seed(0)
    gumbel = -torch.log(-torch.log(torch.rand((N, W, V), generator=g).clamp_min(1e-38)))
    logits = _t(np.repeat(base, N, axis=0))
    if fn == "sequential_decompose":
        toks = sequential_decompose(gumbel, logits, PSPEC, pst, pparams).tokens.numpy()
    else:
        toks = pp.decompose_window_sequential(gumbel, logits, PSPEC, pst, pparams)[1].numpy()
    j1, _ = _states([0])
    for i in range(W):
        # the JAX pipeline's distribution of row i: its grammar at offset i
        row = jp.process_residual_logits(jnp.asarray(base[:, i]), TINY_GRAMMAR, j1, jparams,
                                         jnp.asarray([i], jnp.int32))
        p = np.asarray(row[0], np.float64)
        counts = np.bincount(toks[:, i], minlength=V)
        if (i + 1) % 5 == 0:  # the grid's row end: <eol> forced
            assert counts[50] == N and p[50] == 1.0
            continue
        support = p > 0
        assert counts[~support].sum() == 0
        chi2 = ((counts[support] - N * p[support]) ** 2 / (N * p[support])).sum()
        assert chi2 < scipy.stats.chi2.ppf(1 - 1e-4, support.sum() - 1), (i, chi2)


def _jax_engine(jcfg, sampling, fast=False, **kw):
    return JaxSJDEngine(jax_model_fns(jcfg, max_positions=512), JaxEngineConfig(**kw),
                        jg.GrammarSpec(kind="none", image_vocab_start=0, image_vocab_end=V - 1),
                        sampling, ar_fast_path=fast)


def _port_engine(cfg, **kw):
    sampling = kw.pop("sampling", pp.SamplingParams(do_cfg=False, image_top_k=64,
                                                    text_top_k=64, greedy=True))
    fast = kw.pop("ar_fast_path", False)
    return SJDEngine(decoder_model_fns(cfg, max_positions=512, device="cpu"),
                     EngineConfig(**kw), NONE_SPEC, sampling, ar_fast_path=fast)


def _replay(eng, key, B):
    W = eng.config.window
    seeds = _replayed_seeds(key, B, W, 0, V - 1)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(B, W - 1), None)


def _assert_results_equal(got, want):
    for b in range(got.tokens.shape[0]):
        n = int(want.length[b])
        assert int(got.length[b]) == n
        np.testing.assert_array_equal(got.tokens[b, :n].numpy(), np.asarray(want.tokens[b, :n]))
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    np.testing.assert_array_equal(got.steps_multi.numpy(), np.asarray(want.steps_multi))


def test_attn_buckets_greedy_equals_jax_and_unchunked():
    """tests/test_engine_edges.py:85 on the port: attn_buckets=8 over a
    multi-chunk buffer (max_len 30, W 5, P 3: kv_buf a multiple of 8, four
    chunks) gives the JAX engine's greedy tokens, NFE and accept_hist with
    its draft seeds replayed, and the port's own unchunked run."""
    jparams = tiny_params()
    prompt = [[1, 2, 3], [4, 5, 6]]
    key = jax.random.PRNGKey(3)
    jeng = _jax_engine(dataclasses.replace(TINY, attn_buckets=8),
                       JaxSamplingParams(do_cfg=False, greedy=True, image_top_k=64,
                                         text_top_k=64),
                       window=5, scheme="speculative_jacobi", max_len=30)
    want = jeng.generate(jparams, key, jnp.asarray(prompt, jnp.int32))
    outs = {}
    for buckets in (8, 0):
        cfg = decoder_config_from_jax(dataclasses.replace(TINY, attn_buckets=buckets))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        eng = _port_engine(cfg, window=5, scheme="speculative_jacobi", max_len=30)
        _replay(eng, key, 2)
        outs[buckets] = eng.generate(params, 0, torch.tensor(prompt))
        assert eng._state.valid.shape[1] % 8 == 0 and eng._state.valid.shape[1] > 8
        _assert_results_equal(outs[buckets], want)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_chunked_forward_logits_equal_unchunked(kv_quant, monkeypatch):
    """The forward with attn_buckets against the unchunked one and against
    the JAX chunked forward, f32: a 13-row prefill (in query blocks of 4,
    over the chunks up to each block's causal edge) and then a 5-row window
    over a 32-row buffer in chunks of 8; logits within rtol 1e-5, the cache
    rows equal. Sample 1's first 3 prompt rows are masked padding: their
    queries see no key at all, so their outputs are the softmax of nothing,
    which each path averages over the rows it reads; no valid row reads
    them, and they are left out of the comparison, as in the engine. The
    int8 codes of the later layer may move by one step with the f32 sums."""
    monkeypatch.setattr(pt, "ATTEND_BLOCK_ROWS", 4)
    S, L, P, T = 2, 32, 13, 5
    jcfg = dataclasses.replace(TINY, kv_quant=kv_quant)
    rng = np.random.default_rng(7)
    ids_p = rng.integers(0, V, (S, P)).astype(np.int32)
    ids_w = rng.integers(0, V, (S, T)).astype(np.int32)
    valid = np.ones((S, L), bool)
    valid[1, :3] = False
    pos_p = np.maximum(np.cumsum(valid[:, :P], 1) - 1, 0).astype(np.int32)
    jparams = tiny_params()
    rope_j = jt.make_rope_table(jcfg, 64)
    results = {}
    for buckets in (8, 0):
        cfg = decoder_config_from_jax(dataclasses.replace(jcfg, attn_buckets=buckets))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        rope = pt.make_rope_table(cfg, 64, device="cpu")
        kv = pt.init_kv_cache(cfg, S, L, device="cpu")
        out = []
        for ids, pos, end in ((ids_p, pos_p, 0), (ids_w, pos_p[:, -1:] + 1 + np.arange(T), P)):
            res = pt.forward(params, cfg, _t(ids), _t(pos.astype(np.int32)), kv,
                             torch.full((S,), end, dtype=torch.int32), _t(valid), rope)
            out.append(res.logits.numpy())
        results[buckets] = out, kv
    rows = [valid[:, :P], np.ones((S, T), bool)]  # the queries that see a key
    for a, b, r in zip(results[8][0], results[0][0], rows):
        np.testing.assert_allclose(a[r], b[r], rtol=1e-5, atol=1e-5)
    for a, b in zip(results[8][1], results[0][1]):
        if a is not None:
            keep = _t(valid)[:, None, :, None]  # [S, NL, L, H(, D)]: the valid rows
            tol = 1 if a.dtype == torch.int8 else 1e-5
            a, b = (x.float() * keep.reshape(keep.shape + (1,) * (x.dim() - 4)) for x in (a, b))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=tol)
    # the JAX chunked path on the same inputs
    jcfg8 = dataclasses.replace(jcfg, attn_buckets=8)
    jkv = jt.init_kv_cache(jcfg8, S, L)
    for (ids, pos, end), got in zip(((ids_p, pos_p, 0),
                                     (ids_w, pos_p[:, -1:] + 1 + np.arange(T), P)),
                                    results[8][0]):
        res = jt.forward(jparams, jcfg8, jnp.asarray(ids), jnp.asarray(pos, jnp.int32), jkv,
                         jnp.full((S,), end, jnp.int32), jnp.asarray(valid), rope_j)
        jkv = res.kv
        r = valid[:, :ids.shape[1]] if end == 0 else np.ones(ids.shape, bool)
        np.testing.assert_allclose(got[r], np.asarray(res.logits)[r], rtol=1e-5, atol=1e-5)


AR_CASES = {
    # tests/test_advice_r1.py:134: interval_r 8, the steps past it are AR
    "advice_r1": (dict(window=6, max_len=28, interval_r=8), [[3, 5, 7, 9]], "none"),
    # two slots at other fills, CFG by prompt masking: a slot outside the
    # interval keeps the wide step while the other is inside
    "two_slots_cfg": (dict(window=5, max_len=30, interval_l=3, interval_r=12),
                      [[3, 5, 7, 9, 11], [0, 0, 4, 6, 8]], "mask_prompt"),
}


@pytest.mark.parametrize("case", list(AR_CASES))
def test_ar_fast_path_equals_jax_and_wide_steps(case):
    """ar_fast_path=True on the CPU in f32, greedy, the JAX engine's seeds
    replayed: the same tokens, NFE, accept_hist and steps_multi as the JAX
    engine with ar_fast_path=True, and as the port's own always-wide run.
    Both step widths ran."""
    kw, prompt, cfg_mode = AR_CASES[case]
    kw = dict(scheme="speculative_jacobi", cfg_mode=cfg_mode, **kw)
    do_cfg = cfg_mode != "none"
    sp = dict(do_cfg=do_cfg, guidance_scale=2.0, image_top_k=64, text_top_k=64, greedy=True)
    jparams = tiny_params()
    key = jax.random.PRNGKey(0)
    jeng = _jax_engine(TINY, JaxSamplingParams(**sp), fast=True, **kw)
    want = jeng.generate(jparams, key, jnp.asarray(prompt, jnp.int32))
    cfg = decoder_config_from_jax(TINY)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    B = len(prompt)
    for fast in (True, False):
        eng = _port_engine(cfg, sampling=pp.SamplingParams(**sp), ar_fast_path=fast, **kw)
        _replay(eng, key, B)
        got = eng.generate(params, 0, torch.tensor(prompt))
        _assert_results_equal(got, want)
        widths = eng.stats.eager_by_width
        assert set(widths) == ({kw["window"], 1} if fast else {kw["window"]}), widths
        assert sum(widths.values()) == got.nfe - 1


def test_ar_fast_path_resume_and_refill_keep_the_width_choice():
    """Chunked resume on the fast path equals one generate call, and a
    refilled slot's next steps pick their width from its own fill."""
    cfg = decoder_config_from_jax(TINY)
    params = params_from_jax(jax.tree.map(np.asarray, tiny_params()), cfg, device="cpu")
    kw = dict(window=5, max_len=24, interval_r=8, scheme="speculative_jacobi")
    whole = _port_engine(cfg, ar_fast_path=True, **kw).generate(params, 3, torch.tensor(
        [[3, 5, 7], [2, 4, 6]]))
    eng = _port_engine(cfg, ar_fast_path=True, **kw)
    res, st = eng.generate(params, 3, torch.tensor([[3, 5, 7], [2, 4, 6]]), max_steps=4,
                           return_state=True)
    while not bool(st.finished.all()):
        res, st = eng.resume(params, st, max_steps=3, return_state=True)
    assert torch.equal(res.tokens, whole.tokens) and res.nfe == whole.nfe
    np.testing.assert_array_equal(res.accept_hist.numpy(), whole.accept_hist.numpy())
    st = eng.refill(params, st, torch.tensor([[9, 9, 9], [0, 0, 0]]), [True, False])
    before = dict(eng.stats.eager_by_width)
    res, st = eng.resume(params, st, return_state=True)
    grew = {w: n - before.get(w, 0) for w, n in eng.stats.eager_by_width.items()}
    assert grew.get(5, 0) > 0 and grew.get(1, 0) > 0, grew
    assert int(res.gen_count[0]) >= kw["max_len"]
