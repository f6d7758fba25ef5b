"""The port's StreamingBatcher (sjd_tpu_torch/core/serving.py) against
tests/test_continuous_batching.py:336, :378 and :399 and against sjd_tpu's
StreamingBatcher, at tests/helpers.py's tiny shapes (the tiny image grammar,
eos = the image end, so a request's length is its grid).

Greedy tokens must equal sjd_tpu's per request (greedy decoding makes them
independent of the random draws); sampled tokens must equal the port's own
solo run of the same request and seed, whatever the arrival order and the
co-scheduled load. Every wait has a timeout, so a hang fails instead of
stalling the suite."""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from helpers import TINY_GRAMMAR, make_engine
from sjd_tpu.core import SamplingParams as JaxSamplingParams
from sjd_tpu.core.serving import StreamingBatcher as JaxStreamingBatcher
from sjd_tpu_torch.core.serving import PendingResult, StreamingBatcher, seed_generators
from test_torch_serving import assert_grid, engine, grid_prompt

WAIT_S = 120


@pytest.fixture(scope="module")
def jax_params():
    from helpers import tiny_params

    return tiny_params()


@pytest.fixture(scope="module")
def params(jax_params):
    from sjd_tpu_torch.convert import params_from_jax
    from test_torch_serving import CFG

    return params_from_jax(jax.tree.map(np.asarray, jax_params), CFG, device="cpu")


def solo(eng, params, prompt, seed, width):
    """One request alone, left-padded into the bucket as the batcher pads it."""
    pad = width - len(prompt)
    ids = torch.tensor([[0] * pad + prompt])
    mask = torch.tensor([[False] * pad + [True] * len(prompt)])
    res = eng.generate(params, seed_generators([seed], "cpu"), ids, prompt_mask=mask)
    return res.tokens[0, :int(res.length[0])].numpy()


def test_streaming_batcher_online_submissions(params):
    """Requests submitted over time from another thread share 2 slots; each
    completes with a valid grid for its own size token, including those
    that arrive mid-flight (a refill of an idle or a finished slot)."""
    sb = StreamingBatcher(engine(), params, batch=2, chunk_steps=8, prompt_width=5)
    sizes = [53, 54, 53, 53, 54]
    handles = [sb.submit(grid_prompt(sizes[0]), seed=0)]

    def late_submitter():
        for s in sizes[1:]:
            time.sleep(0.3)
            handles.append(sb.submit(grid_prompt(s), seed=1))

    t = threading.Thread(target=late_submitter)
    t.start()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    results = [h.wait(timeout=WAIT_S) for h in handles]
    stats = sb.stats()
    sb.close()
    for res, size_tok in zip(results, sizes):
        assert_grid(res.tokens[5:], size_tok)
        assert res.gen_count == len(res.tokens) - 5
    assert [r.prompt_index for r in results] == list(range(5))
    assert stats["submitted"] == stats["completed"] == 5 and stats["pending"] == 0
    assert stats["tokens_generated"] == sum(r.gen_count for r in results)
    assert stats["latency_s_median"] > 0


def test_streaming_batcher_short_prompt_padding(params):
    """A prompt shorter than the bucket is left-padded with mask False and
    still gives a valid grid, equal to its solo run."""
    eng = engine()
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=8, prompt_width=9)
    res = sb.submit(grid_prompt(53), seed=4).wait(timeout=WAIT_S)
    sb.close()
    assert_grid(res.tokens[9:], 53)
    np.testing.assert_array_equal(res.tokens, solo(engine(), params, grid_prompt(53), 4, 9))


def test_streaming_batcher_seed_reproducible_across_interleavings(params):
    """submit(prompt, seed=s) gives the same tokens under two arrival orders
    with other companions, and the same as the request run alone."""
    eng = engine()

    def run(order):
        sb = StreamingBatcher(eng, params, batch=2, chunk_steps=4, prompt_width=5)
        handles = {k: sb.submit(grid_prompt(k[0]), seed=k[1]) for k in order}
        out = {k: h.wait(timeout=WAIT_S).tokens for k, h in handles.items()}
        sb.close()
        return out

    a = run([(54, 7), (53, 11), (54, 5), (53, 3)])
    b = run([(53, 99), (54, 7), (53, 3), (54, 42), (53, 11)])
    ref = engine()
    for key in ((54, 7), (53, 11), (53, 3)):
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], solo(ref, params, grid_prompt(key[0]), key[1], 5))


def test_idle_slot_is_rearmed_mid_flight(params):
    """A request that arrives while another is live takes the idle slot by
    a refill at the next chunk boundary, and both equal their solo runs
    (each resume chunk is slowed so that the first request is surely live)."""
    eng = engine()
    real = eng.resume

    def slow_resume(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    eng.resume = slow_resume
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=1, prompt_width=5)
    first = sb.submit(grid_prompt(54), seed=21)
    deadline = time.time() + WAIT_S
    while sb.stats()["chunks"] < 2 and time.time() < deadline:
        time.sleep(0.005)
    second = sb.submit(grid_prompt(53), seed=22)
    got = [first.wait(timeout=WAIT_S), second.wait(timeout=WAIT_S)]
    stats = sb.stats()
    sb.close()
    assert stats["refills"] == 1 and stats["completed"] == 2
    ref = engine()
    for res, (size, seed) in zip(got, ((54, 21), (53, 22))):
        np.testing.assert_array_equal(res.tokens, solo(ref, params, grid_prompt(size), seed, 5))


def test_streaming_batcher_negative_prompts(params):
    """neg_width: each request brings its own negative prompt (the engine's
    neg_prompt CFG), left-padded into its own bucket; each equals its solo
    run with the same negative prompt."""
    eng = engine(cfg_mode="neg_prompt")
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=4, prompt_width=5, neg_width=6)
    with pytest.raises(ValueError, match="negative prompt"):
        sb.submit(grid_prompt(53))
    reqs = [(53, [7, 8, 48, 53, 53], 31), (54, [9, 7, 8, 48, 54, 54], 32), (53, [5], 33)]
    handles = [sb.submit(grid_prompt(size), neg_prompt_ids=neg, seed=seed)
               for size, neg, seed in reqs]
    got = [h.wait(timeout=WAIT_S).tokens for h in handles]
    sb.close()
    ref = engine(cfg_mode="neg_prompt")
    for toks, (size, neg, seed) in zip(got, reqs):
        pad = 6 - len(neg)
        res = ref.generate(params, seed_generators([seed], "cpu"), torch.tensor([grid_prompt(size)]),
                           neg_prompt=torch.tensor([[0] * pad + neg]),
                           neg_mask=torch.tensor([[False] * pad + [True] * len(neg)]))
        np.testing.assert_array_equal(toks, res.tokens[0, :int(res.length[0])].numpy())
        assert_grid(toks[6:], size)  # both prompts padded to the wider bucket


def test_greedy_streaming_batcher_equals_jax(jax_params, params):
    """Greedy: per request, the port's tokens equal sjd_tpu's
    StreamingBatcher's on the same parameters and submissions, prompts of
    two widths in one bucket."""
    jeng = make_engine(window=5, scheme="speculative_jacobi", max_len=64, cfg_mode="none",
                       grammar=TINY_GRAMMAR, eos_id=49,
                       sampling=JaxSamplingParams(do_cfg=False, image_top_k=44,
                                                  text_top_k=60, greedy=True))
    sizes = [53, 54, 53, 54, 53]
    got, want = [], []
    for batcher, out in ((JaxStreamingBatcher(jeng, jax_params, batch=2, chunk_steps=8,
                                              prompt_width=7), want),
                         (StreamingBatcher(engine(greedy=True), params, batch=2, chunk_steps=8,
                                           prompt_width=7), got)):
        handles = [batcher.submit(grid_prompt(s)[i % 2:], seed=i) for i, s in enumerate(sizes)]
        out.extend(h.wait(timeout=WAIT_S) for h in handles)
        batcher.close()
    for g, w in zip(got, want):
        assert g.prompt_index == w.prompt_index
        # up to the image end: a last multi-token step may commit tokens past
        # it, as many as its drafts (random draws) let through
        n = 7 + list(g.tokens[7:]).index(49) + 1
        np.testing.assert_array_equal(g.tokens[:n], np.asarray(w.tokens)[:n])


def test_streaming_batcher_refuses_what_it_does_not_take(params):
    """A row_sharding that is neither a mesh nor a data group; a prompt
    over the bucket; embeddings in token mode, and ids or embeddings of the
    wrong width in embedding mode."""
    eb = StreamingBatcher(engine(), params, prompt_width=5, embed_dim=8)
    with pytest.raises(ValueError, match="prompt_embeds"):
        eb.submit([1, 2])
    with pytest.raises(ValueError, match="expected"):
        eb.submit(prompt_embeds=np.zeros((1, 7), np.float32),
                  neg_prompt_embeds=np.zeros((1, 7), np.float32))
    eb.close()
    with pytest.raises(ValueError, match="row_sharding"):
        StreamingBatcher(engine(), params, prompt_width=5, row_sharding=object())
    sb = StreamingBatcher(engine(), params, batch=2, prompt_width=5)
    with pytest.raises(ValueError, match="bucket"):
        sb.submit(list(range(6)))
    with pytest.raises(ValueError, match="prompt_ids"):
        sb.submit([1], prompt_embeds=np.zeros((1, 8), np.float32))
    sb.close()
    with pytest.raises(RuntimeError, match="closed"):
        sb.submit(grid_prompt(53))


def test_failed_batch_fails_its_requests_and_serving_goes_on(params):
    """An engine error fails the requests of that batch only; the next
    request is served by a fresh batch."""
    eng = engine()
    real = eng.generate
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(*a, **kw)

    eng.generate = flaky
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=8, prompt_width=5)
    first = sb.submit(grid_prompt(53), seed=1)
    with pytest.raises(RuntimeError, match="injected"):
        first.wait(timeout=WAIT_S)
    second = sb.submit(grid_prompt(54), seed=2).wait(timeout=WAIT_S)
    sb.close()
    assert_grid(second.tokens[5:], 54)
    assert sb.stats()["in_flight"] == 0


def test_pending_result_wait_times_out():
    h = PendingResult(0)
    with pytest.raises(TimeoutError):
        h.wait(timeout=0.01)
    assert not h.done()


def test_drive_thread_failure_fails_queued_requests(params):
    """An error outside a batch stops the drive thread: the queued requests
    fail instead of waiting forever, and the batcher takes no more."""

    class Broken(StreamingBatcher):
        def _drive_loop(self):
            with self._lock:
                while not self._pending:
                    self._wake.wait(timeout=1)
            raise RuntimeError("drive broke")

    sb = Broken(engine(), params, batch=2, prompt_width=5)
    with pytest.raises(RuntimeError, match="drive broke"):
        sb.submit(grid_prompt(53)).wait(timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="closed"):
        sb.submit(grid_prompt(53))
    sb.close()


def test_profiling_and_logging_helpers(params):
    """GenerationStats from a result, time_block, SmoothedValue and
    MetricLogger, as the JAX package's helpers report them."""
    from sjd_tpu.utils.logging import SmoothedValue as JaxSmoothedValue
    from sjd_tpu_torch.utils.logging import MetricLogger, SmoothedValue, set_logger
    from sjd_tpu_torch.utils.profiling import GenerationStats, host_peak_rss_bytes, time_block

    eng = engine()
    held = {}
    with time_block("", held):
        res = eng.generate(params, 3, torch.tensor([grid_prompt(53)]))
    stats = GenerationStats.from_result(res, held["elapsed"])
    assert stats.nfe == res.nfe and stats.tokens == int(res.gen_count.max())
    assert stats.accept_rate == stats.tokens / stats.nfe and stats.wall_s > 0
    assert sum(stats.accept_hist) == res.nfe - 1  # one bin per decode step
    assert "NFE" in str(GenerationStats.from_result(res, 1.0))
    assert host_peak_rss_bytes() > 0
    got, want = SmoothedValue(window_size=3), JaxSmoothedValue(window_size=3)
    for v in (4.0, 1.0, 3.0, 8.0):
        got.update(v)
        want.update(v)
    assert (got.median, got.avg, got.global_avg, str(got)) == (
        want.median, want.avg, want.global_avg, str(want))
    ml = MetricLogger()
    ml.update(loss=2.0, lr=0.5)
    assert list(ml.log_every(range(3), 2, logger=set_logger())) == [0, 1, 2]
    assert "loss: 2.0000" in str(ml)
