"""Port of the SJD core (sjd_tpu_torch/core) against sjd_tpu/core: grammar
masks and state, draft windows, top-k, speculative and Jacobi acceptance.
These are exact functions, so the port must match bit for bit; where the
JAX side draws random numbers, the test replays its draws (from the same
keys) into the port. The sampled path is held to the unbiasedness law of
tests/test_acceptance.py:103 with the port's own generator."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from helpers import TINY_GRAMMAR
from sjd_tpu.core import acceptance as ja
from sjd_tpu.core import drafts as jd
from sjd_tpu.core import grammar as jg
from sjd_tpu.core import sampling as js
from sjd_tpu_torch.core import acceptance as pa
from sjd_tpu_torch.core import drafts as pd
from sjd_tpu_torch.core import grammar as pg
from sjd_tpu_torch.core import sampling as ps

V = 64
PSPEC = pg.GrammarSpec(**{f: getattr(TINY_GRAMMAR, f) for f in (
    "kind", "image_start_id", "image_end_id", "newline_id", "image_vocab_start",
    "image_vocab_end", "size_token_base", "grid_scale", "header_len")})


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


def _assert_state_equal(p, j):
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("in_image,size_known", [(True, True), (True, False),
                                                 (False, False)])
def test_grammar_masks_equal_every_window_phase(in_image, size_known):
    """Every (img_count, window row) phase of a 4x4 grid, including the
    <eol> rows and the <image_end> row, plus the residual single-row form
    and the forced-token table."""
    W = 6
    counts = list(range(0, 22))
    jst, pst = _states(counts, in_image=in_image, size_known=size_known)
    scores = np.random.default_rng(0).standard_normal((len(counts), W, V)).astype(np.float32)
    want = jg.apply_grammar(TINY_GRAMMAR, jst, jnp.asarray(scores))
    got = pg.apply_grammar(PSPEC, pst, _t(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off = np.arange(len(counts), dtype=np.int32) % W
    want1 = jg.apply_grammar_single(TINY_GRAMMAR, jst, jnp.asarray(scores[:, 0]),
                                    jnp.asarray(off))
    got1 = pg.apply_grammar_single(PSPEC, pst, _t(scores[:, 0]), _t(off))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    o = np.asarray(counts, np.int32)[:, None] + np.arange(W, dtype=np.int32)
    for g, w in zip(pg.forced_token_at(PSPEC, pst, _t(o)),
                    jg.forced_token_at(TINY_GRAMMAR, jst, jnp.asarray(o))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grammar_state_updates_equal():
    """A prompt scanned by mask, then windows committed by count, through a
    whole 4x2 image and past its end."""
    prompt = np.asarray([[0, 9, 9, 48, 54, 53], [9, 9, 9, 48, 54, 53]], np.int32)
    pmask = np.ones_like(prompt, bool)
    pmask[0, 0] = False
    js_ = jg.update_state(TINY_GRAMMAR, jg.init_state(2), jnp.asarray(prompt),
                          jnp.asarray(pmask))
    ps_ = pg.update_state(PSPEC, pg.init_state(2), _t(prompt), _t(pmask))
    _assert_state_equal(ps_, js_)
    rng = np.random.default_rng(1)
    for _ in range(6):
        committed = rng.integers(4, 12, (2, 5)).astype(np.int32)
        committed[:, 2] = 50
        committed[1, 4] = 49
        n = rng.integers(0, 6, 2).astype(np.int32)
        js_ = jg.update_state(TINY_GRAMMAR, js_, jnp.asarray(committed), jnp.asarray(n))
        ps_ = pg.update_state(PSPEC, ps_, _t(committed), _t(n))
        _assert_state_equal(ps_, js_)


@pytest.mark.parametrize("scheme", ["random", "repeat_horizon"])
def test_build_window_equal_with_replayed_draws(scheme):
    B, W, L = 3, 6, 40
    rng = np.random.default_rng(2)
    tokens = rng.integers(4, 48, (B, L)).astype(np.int32)
    length = np.asarray([12, 20, 31], np.int32)
    last_prob = rng.random((B, V)).astype(np.float32)
    carried = rng.integers(4, 48, (B, W)).astype(np.int32)
    carried_probs = rng.random((B, W, V)).astype(np.float32)
    count = np.asarray([0, 2, 5], np.int32)
    jst, pst = _states([3, 8, 14])
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    lo, hi = pd.draft_range(PSPEC, V)
    rand = jax.vmap(lambda k: jax.random.randint(k, (W - 1,), lo, hi + 1, jnp.int32))(keys)
    common = dict(scheme=scheme, window=W, vocab_size=V, grammar_seed=True)
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


@pytest.mark.parametrize("k", [1, 10, V])
def test_top_k_dual_equal_with_ties(k):
    rng = np.random.default_rng(k)
    # coarse values: many exact ties around every threshold
    scores = np.round(rng.standard_normal((2, 4, V)), 1).astype(np.float32)
    scores[0, 0, :8] = js.NEG_INF
    image_mode = np.asarray([True, False])
    want = js.top_k_dual(jnp.asarray(scores), jnp.asarray(image_mode), k, max(1, k // 2))
    got = ps.top_k_dual(_t(scores), _t(image_mode), k, max(1, k // 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _accept_inputs(seed, B, W, Vs):
    rng = np.random.default_rng(seed)
    p_new = rng.dirichlet(np.full(Vs, 0.3), (B, W)).astype(np.float32)
    p_draft = rng.dirichlet(np.full(Vs, 0.3), (B, W)).astype(np.float32)
    x = rng.integers(0, Vs, (B, W)).astype(np.int32)
    y = rng.integers(0, Vs, (B, W)).astype(np.int32)
    x[:, 1:3] = y[:, 0:2]  # some Jacobi matches
    active = np.asarray([W, W - 2, 1, W][:B], np.int32)
    return p_new, p_draft, x, y, active


def test_speculative_accept_equal_with_replayed_draws():
    B, W, Vs = 4, 6, 16
    p_new, p_draft, x, y, active = _accept_inputs(5, B, W, Vs)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    # the JAX function's own key schedule (acceptance.py:76-81), replayed
    ks = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (W - 1,), jnp.float32))(ks[:, 0])
    g = jax.vmap(lambda k: jax.random.gumbel(k, (Vs,), jnp.float32))(ks[:, 1])

    want = ja.speculative_accept(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(p_draft), jnp.asarray(p_new),
        jnp.asarray(active), lambda r, logits, row: js.sample_from_logits(r, logits))
    got = pa.speculative_accept(
        _t(u), _t(x), _t(y), _t(p_draft), _t(p_new), _t(active),
        lambda logits, row: ps.sample_from_logits(_t(g), logits))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_jacobi_accept_equal():
    B, W, Vs = 4, 6, 16
    p_new, _, x, y, active = _accept_inputs(7, B, W, Vs)
    want = ja.jacobi_accept(jnp.asarray(x), jnp.asarray(y), jnp.asarray(p_new),
                            jnp.asarray(active))
    got = pa.jacobi_accept(_t(x), _t(y), _t(p_new), _t(active))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_speculative_distribution_is_unbiased():
    """The committed token at the test slot is distributed ~ p_new whatever
    the draft distribution, with the port's own generator draws."""
    trials, vocab = 4000, 4
    p_draft_row = torch.tensor([0.46, 0.04, 0.25, 0.25])
    p_new_row = torch.tensor([0.1, 0.4, 0.3, 0.2])
    gen = torch.Generator().manual_seed(7)
    xs = torch.multinomial(p_draft_row, trials, replacement=True, generator=gen)
    x = torch.stack([torch.zeros(trials, dtype=torch.int32), xs.to(torch.int32)], 1)
    y = torch.zeros((trials, 2), dtype=torch.int32)
    u = torch.rand((trials, 1), generator=gen)
    g = -torch.log(-torch.log(torch.rand((trials, vocab), generator=gen)
                              .clamp_min(torch.finfo(torch.float32).tiny)))
    res = pa.speculative_accept(
        u, x, y, p_draft_row.expand(trials, 2, vocab), p_new_row.expand(trials, 2, vocab),
        torch.full((trials,), 2, dtype=torch.int32),
        lambda logits, row: ps.sample_from_logits(g, logits))
    counts = np.bincount(res.out_tokens[:, 0].numpy(), minlength=vocab) / trials
    np.testing.assert_allclose(counts, p_new_row.numpy(), atol=0.035)


class _NoHostReads(TorchDispatchMode):
    """Fails on the ops that hand a device value to the host (.item(),
    bool(), boolean-mask indexing): a CUDA-graph capture of code that runs
    one fails, and eager code syncs on it."""

    _READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
              torch.ops.aten.masked_select.default}
    _INDEXING = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default,
                 torch.ops.aten.index_put.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self._READS:
            raise AssertionError(f"the step reads a device value on the host: {func}")
        if func in self._INDEXING and any(
                t is not None and t.dtype == torch.bool for t in args[1]):
            raise AssertionError(f"the step indexes with a boolean mask: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("scheme,init,greedy,cfg_mode", [
    ("speculative_jacobi", "random", False, "none"),
    ("speculative_jacobi", "repeat_horizon", False, "neg_prompt"),
    ("jacobi", "random", True, "none"),
])
def test_step_writes_in_place_and_reads_nothing_on_the_host(scheme, init, greedy, cfg_mode):
    """The decode step the engine captures as a CUDA graph: it writes its
    results into the state's own tensors (no field is rebound, no address
    moves), advances what a step advances, and never reads a device value
    on the host, which is what lets it be captured."""
    import dataclasses

    from helpers import TINY, tiny_params
    from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax
    from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine
    from sjd_tpu_torch.core.processors import SamplingParams
    from sjd_tpu_torch.models.adapter import decoder_model_fns

    cfg = decoder_config_from_jax(TINY)
    params = params_from_jax(jax.tree.map(np.asarray, tiny_params()), cfg, device="cpu")
    eng = SJDEngine(
        decoder_model_fns(cfg, max_positions=512, device="cpu"),
        EngineConfig(window=5, scheme=scheme, init=init, max_len=64, cfg_mode=cfg_mode),
        PSPEC, SamplingParams(do_cfg=cfg_mode != "none", guidance_scale=2.0,
                              image_top_k=44, text_top_k=60, greedy=greedy))
    prompt = torch.tensor([[1, 2, 48, 54, 54], [0, 3, 48, 53, 53]])
    neg = torch.tensor([[7, 48, 54, 54], [7, 48, 53, 53]]) if cfg_mode != "none" else None
    _, st = eng.generate(params, 0, prompt, neg_prompt=neg, max_steps=3, return_state=True)

    def tensors(s):
        out = {}
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                if isinstance(t, torch.Tensor):
                    out[(f.name, i)] = t
        return out

    before = {k: (t, t.data_ptr(), t.clone()) for k, t in tensors(st).items()}
    draws = eng._draws(st)
    with torch.no_grad(), _NoHostReads():
        eng._step_into(params, st, draws)
    after = tensors(st)
    assert after.keys() == before.keys()
    for k, (t, ptr, _) in before.items():
        assert after[k] is t and t.data_ptr() == ptr, k
    changed = {k[0] for k, (t, _, old) in before.items() if not torch.equal(t, old)}
    assert {"tokens", "length", "kv", "accept_hist"} <= changed
    assert not changed & {"n_pad", "valid", "prompt_len"}
    assert int(st.accept_hist.sum() - before[("accept_hist", 0)][2].sum()) == 2
