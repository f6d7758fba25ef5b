"""Tensor- and data-parallel decoding through the port
(sjd_tpu_torch.parallel.sharding, transformer.forward on a head shard,
decode_attention_tp, the engine and both batchers with row_sharding), on
four CPU processes over gloo, against sjd_tpu's sharded runs
(tests/test_sharded_decode.py, test_parallel.py:95-123,
test_continuous_batching.py:269-300) and against the port's one-process
runs.

The four workers are one spawn for the whole file (a 2 x 2 mesh: data 2,
model 2), with a timeout of its own; JAX runs in the parent only, on the
conftest's 8 virtual devices, while the workers run. Where NFE is held to
sjd_tpu's, the port replays the JAX engine's draft seeds. Tolerances: f32
tokens exactly; f32 logits of quantized windows within 2e-5 (the
row-parallel products sum their K halves across ranks, in another order
than one full-K sum); forward_train within the JAX test's 2e-5.

In-process cases (no spawn): decode_attention_tp per head shard against
JAX's decode_attention_tp, the int4 repack of a row-parallel leaf against
the logical K slice, and the real Chameleon-34B config sharded under
FakeTensorMode at TP 2, 4 and 8."""

import dataclasses
import os
import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine, StepDraws
from sjd_tpu_torch.core.grammar import GrammarSpec
from sjd_tpu_torch.core.processors import SamplingParams
from sjd_tpu_torch.models import transformer as pt
from sjd_tpu_torch.models.adapter import decoder_model_fns
from sjd_tpu_torch.parallel import sharding as psh

WORLD = 4
TIMEOUT_S = 240
F32_TOL = dict(rtol=2e-5, atol=2e-5)

# tests/helpers.py's TINY, sjd_tpu's swin GQA config (test_sharded_decode.py:71)
# and tests/test_parallel.py's CFG, as the port's configs
TINY = pt.DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=8, qk_norm=True,
                        dtype=torch.float32, max_position_embeddings=512)
SWIN = pt.DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                        num_heads=8, num_kv_heads=2, head_dim=8, qk_norm=True, swin_norm=True,
                        dtype=torch.float32, max_position_embeddings=256)
PAR = pt.DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=4, head_dim=8, qk_norm=True,
                       dtype=torch.float32, max_position_embeddings=64)
NONE_GRAMMAR = GrammarSpec(kind="none", image_vocab_start=0, image_vocab_end=63)
# tests/helpers.py's TINY_GRAMMAR
IMAGE_GRAMMAR = GrammarSpec(kind="lumina", image_start_id=48, image_end_id=49, newline_id=50,
                            image_vocab_start=4, image_vocab_end=47, size_token_base=52,
                            grid_scale=2)
DP_PROMPTS = [[1, 2, 3], [5, 6, 7], [2, 4, 6], [9, 8, 7]]
BATCH_SIZES = [53, 54, 53, 54, 53, 53, 54, 53]  # test_continuous_batching.py:282
STREAM_SIZES = [53, 54, 53, 54, 53]
QUANT = {"w8a16": (8, "bf16"), "w4a16": (4, "bf16"), "w8a8": (8, "int8")}


def grid_prompt(size_tok):
    return [1, 2, 48, size_tok, size_tok]


def _engine(cfg, *, window, scheme, max_len, greedy, grammar=NONE_GRAMMAR, eos_id=-1,
            top_k=64):
    return SJDEngine(
        decoder_model_fns(cfg, max_positions=cfg.max_position_embeddings, device="cpu"),
        EngineConfig(window=window, scheme=scheme, max_len=max_len, eos_id=eos_id),
        grammar, SamplingParams(do_cfg=False, greedy=greedy, image_top_k=top_k,
                                text_top_k=top_k if top_k == 64 else 60))


def _batch_engine(greedy):
    """test_continuous_batching.py's grammar_engine."""
    return _engine(TINY, window=5, scheme="speculative_jacobi", max_len=64, greedy=greedy,
                   grammar=IMAGE_GRAMMAR, eos_id=49, top_k=44)


def _replay(eng, seeds, rows=slice(None)):
    """Make ``eng`` draw the JAX engine's draft seeds (rows ``rows`` of each
    step's [B, W-1]); greedy jacobi draws nothing else."""
    it = iter(seeds)
    eng._draws = lambda st: StepDraws(next(it)[rows], None, None, None)
    return eng


def _window_logits(params, cfg, ids, model_size=1):
    """Prefill ids[:, :8], then one 5-token window at cache row 8: the
    window's f32 logits."""
    S = ids.shape[0]
    kv = pt.init_kv_cache(cfg, S, 32, device="cpu", model_size=model_size)
    rope = pt.make_rope_table(cfg, 64, device="cpu")
    valid = torch.ones((S, 32), dtype=torch.bool)
    pos = torch.arange(13)[None].expand(S, 13)
    with torch.no_grad():
        pt.forward(params, cfg, ids[:, :8], pos[:, :8], kv, torch.zeros(S, dtype=torch.int32),
                   valid, rope)
        return pt.forward(params, cfg, ids[:, 8:], pos[:, 8:], kv,
                          torch.full((S,), 8, dtype=torch.int32), valid, rope).logits


def _quantized(params, kind):
    bits, aq = QUANT[kind]
    return pt.quantize_weights(params, bits=bits, config=PAR), dataclasses.replace(
        PAR, act_quant=aq)


def _completions(done):
    return [(c.prompt_index, c.tokens.tolist(), c.gen_count) for c in done]


# ---------------------------------------------------------------------------
# The four workers
# ---------------------------------------------------------------------------


def _worker(rank: int, port: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    from sjd_tpu_torch.core.serving import ContinuousBatcher, StreamingBatcher
    from sjd_tpu_torch.parallel import make_mesh

    inp = torch.load(os.path.join(tmp, "inputs.pt"))
    mesh = make_mesh(data=2, model=2, device="cpu")
    d = mesh.get_local_rank("data")
    rows = slice(2 * d, 2 * d + 2)
    tp_specs = {n: psh.decoder_param_specs(c, tp=True) for n, c in
                (("tiny", TINY), ("swin", SWIN), ("par", PAR))}

    def local(name, tree=None):
        tree = inp["params"][name] if tree is None else tree
        cfg = {"tiny": TINY, "swin": SWIN}.get(name, PAR)
        return psh.shard_params(psh.copy_tree(tree), mesh, tp_specs.get(name, tp_specs["par"]),
                                cfg=cfg)

    out = {"coord": (d, mesh.get_local_rank("model"))}
    tiny = local("tiny")
    out["shares"] = {n: tuple(t.shape) for n, t in psh._named_leaves(tiny)}
    eng = _replay(_engine(TINY, window=5, scheme="jacobi", max_len=28, greedy=True),
                  inp["seeds"]["tiny"])
    res = eng.generate(tiny, 0, torch.tensor([[1, 2, 3]]))
    out["tiny"] = (res.tokens[0, :int(res.length[0])].tolist(), res.nfe)
    # the same run from a DTensor tree, which the engine makes local once
    dtensors = psh.apply_named_sharding(mesh, inp["params"]["tiny"], tp_specs["tiny"])
    eng = _replay(_engine(TINY, window=5, scheme="jacobi", max_len=28, greedy=True),
                  inp["seeds"]["tiny"])
    res = eng.generate(dtensors, 0, torch.tensor([[1, 2, 3]]))
    out["tiny_dtensor"] = (res.tokens[0, :int(res.length[0])].tolist(), res.nfe)
    eng = _replay(_engine(SWIN, window=5, scheme="jacobi", max_len=24, greedy=True),
                  inp["seeds"]["swin"])
    res = eng.generate(local("swin"), 0, torch.tensor([[1, 2, 3]]))
    out["swin"] = (res.tokens[0, :int(res.length[0])].tolist(), res.nfe)
    eng = _replay(_engine(TINY, window=4, scheme="jacobi", max_len=20, greedy=True),
                  inp["seeds"]["dp"], rows)
    out["dp"] = eng.generate(tiny, 0, torch.tensor(DP_PROMPTS[rows])).tokens
    for name, cfg in (("sampled", TINY), ("int8_kv", dataclasses.replace(TINY, kv_quant=True))):
        eng = _engine(cfg, window=5, scheme="speculative_jacobi", max_len=24, greedy=False)
        res = eng.generate(tiny, 5, torch.tensor([[1, 2, 3], [4, 5, 6]]))
        out[name] = (res.tokens, res.nfe)
    for kind in QUANT:
        qparams, qcfg = _quantized(inp["params"]["par"], kind)
        out[kind] = _window_logits(local("par", qparams), qcfg, inp["ids"], model_size=2)
    for bits in (8, 4):
        qparams = pt.quantize_weights(inp["params"]["par"], bits=bits, config=PAR)
        specs = psh.expand_specs_for_quantized(qparams, tp_specs["par"])
        sharded = psh.apply_named_sharding(mesh, qparams, specs)
        with torch.no_grad():
            out[f"train{bits}"] = pt.forward_train(
                sharded, PAR, inp["train_ids"][rows], torch.arange(10)[None].expand(2, 10),
                rope_table=pt.make_rope_table(PAR, 64, device="cpu"), remat=False)
    for greedy in (True, False):
        batcher = ContinuousBatcher(_batch_engine(greedy), tiny, chunk_steps=8,
                                    row_sharding=mesh)
        done = batcher.run(0, np.asarray([grid_prompt(s) for s in BATCH_SIZES]), batch=4)
        out[f"batcher_greedy{greedy}"] = (_completions(done), batcher.last_nfe,
                                          batcher.last_accept_hist.tolist())
    sb = StreamingBatcher(_batch_engine(False), tiny, batch=2, chunk_steps=8, prompt_width=5,
                          row_sharding=mesh)
    if d == 0:
        handles = [sb.submit(grid_prompt(s), seed=10 + i) for i, s in enumerate(STREAM_SIZES)]
        out["stream"] = [h.wait(timeout=120).tokens.tolist() for h in handles]
        out["stream_stats"] = sb.stats()
    sb.close(timeout=120)
    torch.save(out, os.path.join(tmp, f"{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_seeds(key, B, W, lo, hi, steps=40):
    """The fresh draft seeds the JAX engine draws at each of ``steps``
    decode steps, from one key split by batch position
    (tests/test_torch_serving.py), in one jitted scan."""
    import jax
    import jax.numpy as jnp

    from sjd_tpu.core.sampling import split_rows

    def step(rng, _):
        ks = split_rows(rng, 4)
        return ks[:, 0], jax.vmap(
            lambda k: jax.random.randint(k, (W - 1,), lo, hi + 1, jnp.int32))(ks[:, 1])

    rng = split_rows(jax.random.split(key, B), 2)[:, 0]
    seeds = jax.jit(lambda r: jax.lax.scan(step, r, None, length=steps)[1])(rng)
    return list(torch.from_numpy(np.array(seeds)))


def _jax_params():
    """sjd_tpu's parameters (TINY, the swin GQA config, test_parallel.py's
    CFG), the port's conversions of them, and the replayed draft seeds:
    what the workers need, made before they start."""
    import jax
    import jax.numpy as jnp

    from helpers import TINY as JTINY
    from helpers import tiny_params
    from sjd_tpu.models import DecoderConfig as JDecoderConfig
    from sjd_tpu.models import init_params
    from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax

    def port(jp, jcfg):
        return params_from_jax(jax.tree.map(np.asarray, jp), decoder_config_from_jax(jcfg),
                               device="cpu")

    jswin_cfg = JDecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                               num_layers=2, num_heads=8, num_kv_heads=2, head_dim=8,
                               qk_norm=True, swin_norm=True, dtype=jnp.float32,
                               max_position_embeddings=256)
    jpar_cfg = JDecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                              num_layers=2, num_heads=4, num_kv_heads=4, head_dim=8,
                              qk_norm=True, dtype=jnp.float32, max_position_embeddings=64)
    jax_side = {"tiny": (tiny_params(), JTINY),
                "swin": (jax.jit(lambda k: init_params(k, jswin_cfg))(jax.random.PRNGKey(7)),
                         jswin_cfg),
                "par": (init_params(jax.random.PRNGKey(0), jpar_cfg), jpar_cfg)}
    key = jax.random.PRNGKey(0)
    inp = {"params": {n: port(jp, jcfg) for n, (jp, jcfg) in jax_side.items()},
           "seeds": {"tiny": _jax_seeds(key, 1, 5, 0, 63), "dp": _jax_seeds(key, 4, 4, 0, 63)},
           "train_ids": torch.from_numpy(np.random.RandomState(1).randint(0, 64, (4, 10))),
           "ids": torch.from_numpy(np.random.RandomState(2).randint(0, 64, (2, 13)))}
    inp["seeds"]["swin"] = inp["seeds"]["tiny"]
    return jax_side, inp


def _jax_side(jax_side, train_ids):
    """sjd_tpu's sharded runs (8 virtual devices, mesh data 4 x model 2),
    its greedy batcher and its unsharded quantized forward_train."""
    import jax
    import jax.numpy as jnp

    from helpers import TINY_GRAMMAR, make_engine
    from sjd_tpu.core import EngineConfig as JEngineConfig
    from sjd_tpu.core import GrammarSpec as JGrammarSpec
    from sjd_tpu.core import SamplingParams as JSampling
    from sjd_tpu.core import SJDEngine as JEngine
    from sjd_tpu.core.serving import ContinuousBatcher as JBatcher
    from sjd_tpu.models import decoder_model_fns as jmodel_fns
    from sjd_tpu.models import forward_train, make_rope_table
    from sjd_tpu.models.transformer import quantize_weights
    from sjd_tpu.parallel import apply_named_sharding, decoder_param_specs, make_mesh

    greedy = JSampling(do_cfg=False, greedy=True, image_top_k=64, text_top_k=64)
    mesh = make_mesh(data=4, model=2)
    out = {}

    def sharded_generate(eng, name, prompt):
        jp, jcfg = jax_side[name]
        sharded = apply_named_sharding(mesh, jp, decoder_param_specs(jcfg, tp=True))
        with jax.set_mesh(mesh):
            if prompt.shape[0] > 1:
                prompt = jax.device_put(prompt, jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec("data")))
            return eng.generate(sharded, jax.random.PRNGKey(0), prompt)

    res = sharded_generate(make_engine(window=5, scheme="jacobi", max_len=28, sampling=greedy),
                           "tiny", jnp.asarray([[1, 2, 3]], jnp.int32))
    out["tiny"] = (np.asarray(res.tokens[0, :int(res.length[0])]).tolist(), int(res.nfe))
    res = sharded_generate(make_engine(window=4, scheme="jacobi", max_len=20, sampling=greedy),
                           "tiny", jnp.asarray(DP_PROMPTS, jnp.int32))
    out["dp"] = np.asarray(res.tokens)
    jswin_cfg = jax_side["swin"][1]
    jeng = JEngine(jmodel_fns(jswin_cfg, max_positions=256),
                   JEngineConfig(window=5, scheme="jacobi", max_len=24, cfg_mode="none"),
                   JGrammarSpec(kind="none", image_vocab_start=0, image_vocab_end=63), greedy)
    res = sharded_generate(jeng, "swin", jnp.asarray([[1, 2, 3]], jnp.int32))
    out["swin"] = (np.asarray(res.tokens[0, :int(res.length[0])]).tolist(), int(res.nfe))

    # the greedy batcher (test_continuous_batching.py:269-300's prompts)
    jbatch = make_engine(window=5, scheme="speculative_jacobi", max_len=64, cfg_mode="none",
                         grammar=TINY_GRAMMAR, eos_id=49,
                         sampling=JSampling(do_cfg=False, image_top_k=44, text_top_k=60,
                                            greedy=True))
    done = JBatcher(jbatch, jax_side["tiny"][0], chunk_steps=8).run(
        jax.random.PRNGKey(0), np.asarray([grid_prompt(s) for s in BATCH_SIZES], np.int32),
        batch=4)
    out["batcher"] = [(c.prompt_index, np.asarray(c.tokens).tolist(), int(c.gen_count))
                      for c in done]

    # test_parallel.py:95-123's reference: the unsharded quantized forward_train
    jpar, jpar_cfg = jax_side["par"]
    pos = jnp.arange(10, dtype=jnp.int32)[None].repeat(4, 0)
    for bits in (8, 4):
        jq = quantize_weights(jpar, bits=bits, config=jpar_cfg)
        out[f"train{bits}"] = np.asarray(forward_train(
            jq, jpar_cfg, jnp.asarray(train_ids.numpy()), pos,
            rope_table=make_rope_table(jpar_cfg, 64), remat=False))
    return out


def _port_one_process(inp):
    """The port's unsharded runs of what the workers shard."""
    from sjd_tpu_torch.core.serving import ContinuousBatcher, StreamingBatcher

    tiny = inp["params"]["tiny"]
    out = {}
    for name, cfg in (("sampled", TINY), ("int8_kv", dataclasses.replace(TINY, kv_quant=True))):
        eng = _engine(cfg, window=5, scheme="speculative_jacobi", max_len=24, greedy=False)
        res = eng.generate(tiny, 5, torch.tensor([[1, 2, 3], [4, 5, 6]]))
        out[name] = (res.tokens, res.nfe)
    for kind in QUANT:
        qparams, qcfg = _quantized(inp["params"]["par"], kind)
        out[kind] = _window_logits(qparams, qcfg, inp["ids"])
    for greedy, name in ((True, "batcher_greedy"), (False, "batcher_sampled")):
        batcher = ContinuousBatcher(_batch_engine(greedy), tiny, chunk_steps=8)
        done = batcher.run(0, np.asarray([grid_prompt(s) for s in BATCH_SIZES]), batch=4)
        out[name] = (_completions(done), batcher.last_nfe, batcher.last_accept_hist.tolist())
    sb = StreamingBatcher(_batch_engine(False), tiny, batch=2, chunk_steps=8, prompt_width=5)
    handles = [sb.submit(grid_prompt(s), seed=10 + i) for i, s in enumerate(STREAM_SIZES)]
    out["stream"] = [h.wait(timeout=120).tokens.tolist() for h in handles]
    sb.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the port's one-process results, each worker's): the
    workers start as soon as their inputs exist, and JAX and the port's
    one-process runs go on in the parent meanwhile."""
    tmp = tmp_path_factory.mktemp("sharded_decode")
    jax_side, inp = _jax_params()
    torch.save(inp, tmp / "inputs.pt")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(tmp))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        want = _jax_side(jax_side, inp["train_ids"])
        one = _port_one_process(inp)
    finally:
        for p in procs:
            p.join(TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
    assert not alive, f"{len(alive)} workers still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return want, one, [torch.load(tmp / f"{r}.pt") for r in range(WORLD)]


def test_shards_are_even_and_local_heads(runs):
    """Each rank holds half of each model-sharded leaf (2 of 4 query heads,
    1 of 2 KV heads, half the MLP width and vocabulary)."""
    _, _, outs = runs
    spec = dict(psh._named_leaves(psh.decoder_param_specs(TINY, tp=True)))
    full = {n: tuple(t.shape) for n, t in psh._named_leaves(pt.init_params(0, TINY,
                                                                           device="cpu"))}
    for out in outs:
        for name, shape in out["shares"].items():
            want = list(full[name])
            for dim, axis in enumerate(spec[name]):
                if axis == "model":
                    want[dim] //= 2
            assert list(shape) == want, name
    assert outs[0]["shares"]["layers.wk"][1] == 1 * TINY.head_dim


@pytest.mark.parametrize("case", ["tiny", "swin_gqa"])
def test_tp_greedy_generate_equals_jax_sharded(runs, case):
    """TP=2 greedy jacobi (window 5): tokens and NFE equal sjd_tpu's sharded
    run (test_sharded_decode.py:16-36 and the swin-norm GQA config, 8
    heads over 2, :63-98) on every rank."""
    want, _, outs = runs
    key = "tiny" if case == "tiny" else "swin"
    for out in outs:
        assert out[key] == want[key]


def test_tp_generate_from_a_dtensor_tree_equals_jax_sharded(runs):
    """The TP=2 greedy run of test_tp_greedy_generate_equals_jax_sharded
    from a DTensor tree (apply_named_sharding; the engine makes it local
    once): the same tokens and NFE."""
    want, _, outs = runs
    for out in outs:
        assert out["tiny_dtensor"] == want["tiny"]


def test_dp_batch_equals_jax_sharded(runs):
    """A 4-prompt batch over data=2 (each data rank TP=2 on its 2 rows)
    equals sjd_tpu's batch sharded over its data axis (:39-60)."""
    want, _, outs = runs
    for out in outs:
        d = out["coord"][0]
        np.testing.assert_array_equal(out["dp"].numpy(), want["dp"][2 * d:2 * d + 2])


@pytest.mark.parametrize("case", ["sampled", "int8_kv"])
def test_tp_speculative_sampled_equals_one_process(runs, case):
    """Speculative sampled decoding under TP=2, with a bf16-free f32 cache
    and with the int8 KV cache (each rank quantizes its own heads): the
    tokens and NFE of the port's unsharded run, from the same seed."""
    _, one, outs = runs
    for out in outs:
        assert torch.equal(out[case][0], one[case][0])
        assert out[case][1] == one[case][1]


@pytest.mark.parametrize("kind", list(QUANT))
def test_tp_quantized_window_logits(runs, kind):
    """W8A16, W4A16 (wo and w_down repacked per rank) and W8A8 (the
    per-token amax taken over the model axis) windows under TP=2: the f32
    logits of the unsharded run within 2e-5, equal on both model ranks."""
    _, one, outs = runs
    for out in outs:
        np.testing.assert_allclose(out[kind].numpy(), one[kind].numpy(), **F32_TOL)
    assert torch.equal(outs[0][kind], outs[1][kind])


@pytest.mark.parametrize("bits", [8, 4])
def test_tp_quantized_forward_train_equals_jax(runs, bits):
    """forward_train on quantized DTensor trees at TP=2 (data 2): sjd_tpu's
    unsharded quantized logits within 2e-5, as test_parallel.py:95-123
    holds its own sharded forward."""
    want, _, outs = runs
    for out in outs:
        d = out["coord"][0]
        np.testing.assert_allclose(out[f"train{bits}"].numpy(),
                                   want[f"train{bits}"][2 * d:2 * d + 2], **F32_TOL)


def test_continuous_batcher_row_sharding_greedy_equals_jax(runs):
    """Greedy ContinuousBatcher(row_sharding=mesh) over data=2 (4 slots, 2 a
    rank, each rank TP=2), on every rank: completion order, tokens and
    gen_count equal the port's one-process batcher, and the completion
    order and each image through its end token equal sjd_tpu's batcher
    (test_continuous_batching.py:269-300's prompts; the tokens a last
    multi-token step commits past the end depend on the drafts, which the
    two packages draw differently)."""
    want, one, outs = runs
    for out in outs:
        got = out["batcher_greedyTrue"][0]
        assert got == one["batcher_greedy"][0]
        assert [c[0] for c in got] == [c[0] for c in want["batcher"]]
        for (_, g, _), (_, w, _) in zip(got, want["batcher"]):
            n = 5 + g[5:].index(49) + 1
            assert g[:n] == w[:n]


def test_continuous_batcher_row_sharding_sampled_equals_one_process(runs):
    """Sampled, with refill's derived generators: the stream, the NFE (the
    longest rank's per chunk) and accept_hist (summed over the ranks) equal
    the port's one-process batcher."""
    _, one, outs = runs
    for out in outs:
        assert out["batcher_greedyFalse"] == one["batcher_sampled"]


def test_streaming_batcher_row_sharding_equals_one_process(runs):
    """StreamingBatcher(row_sharding=mesh): 5 requests submitted on data
    rank 0 through 2 slots (one a rank) complete with the tokens of the
    one-process stream, up to the image end."""
    _, one, outs = runs
    got = outs[0]["stream"]
    assert outs[0]["stream_stats"]["completed"] == len(STREAM_SIZES)
    for g, w in zip(got, one["stream"]):
        n = 5 + g[5:].index(49) + 1
        assert g[:n] == w[:n]


def test_dryrun_multihost_agrees():
    """Two processes over gloo: two FSDP train steps and a TP greedy decode,
    losses and tokens bit-equal across the processes."""
    from sjd_tpu_torch.parallel.multihost_dryrun import dryrun_multihost

    rep = dryrun_multihost(2, timeout=240, device="cpu")
    assert rep["process_count"] == 2 and rep["global_devices"] == 2
    assert all(np.isfinite(x) and x > 0 for x in rep["losses"])
    assert len(rep["tokens"]) == 20 and rep["tokens"][:4] == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# In-process cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True])
def test_decode_attention_tp_per_shard_equals_jax(quantize):
    """Each rank's head shard through decode_attention_tp, concatenated,
    equals sjd_tpu's decode_attention_tp (interpret mode, a 2-device model
    axis) within 2e-5: the f32 cache in the 4-D layout, the int8 cache in
    the stacked 5-D layout (layer 1 of 2)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sjd_tpu.models.transformer import _quantize_rows
    from sjd_tpu.ops.decode_attention import decode_attention_tp as jax_tp
    from sjd_tpu_torch.ops.decode_attention import decode_attention_tp

    S, W, H, Hkv, D, L = 2, 4, 8, 4, 8, 64
    rng = np.random.default_rng(3)
    cache = (S, 2, L, Hkv, D) if quantize else (S, L, Hkv, D)
    q = rng.standard_normal((S, W, H, D)).astype(np.float32)
    k = rng.standard_normal(cache).astype(np.float32)
    v = rng.standard_normal(cache).astype(np.float32)
    ce = np.asarray([10, 30], np.int32)
    valid = np.ones((S, L), bool)
    valid[1, :3] = False
    jk, jv, jks, jvs = jnp.asarray(k), jnp.asarray(v), None, None
    if quantize:
        jk, jks = _quantize_rows(jk)
        jv, jvs = _quantize_rows(jv)
    layer = 1 if quantize else None
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("model",))
    want = np.asarray(jax_tp(jnp.asarray(q), jk, jv, jks, jvs, jnp.asarray(ce),
                             jnp.asarray(valid), window=W, layer=layer, mesh=mesh, chunk=16,
                             interpret=True))
    t = [None if x is None else torch.from_numpy(np.array(np.asarray(x.astype(jnp.float32)
                                                                     if x.dtype == jnp.bfloat16
                                                                     else x)))
         for x in (jk, jv, jks, jvs)]
    if quantize:
        t[2], t[3] = t[2].to(torch.bfloat16), t[3].to(torch.bfloat16)
    axis = types.SimpleNamespace(size=2)
    parts = []
    for r in range(2):
        hq, hk = slice(r * H // 2, (r + 1) * H // 2), slice(r * Hkv // 2, (r + 1) * Hkv // 2)
        kv = [None if x is None else x[..., hk, :].contiguous() if x.dim() == len(cache)
              else x[..., hk].contiguous() for x in t]
        parts.append(decode_attention_tp(
            torch.from_numpy(q[:, :, hq]).contiguous(), kv[0], kv[1], kv[2], kv[3],
            torch.from_numpy(ce), torch.from_numpy(valid), window=W, layer=layer, axis=axis,
            num_heads=H, num_kv_heads=Hkv))
    np.testing.assert_allclose(torch.cat(parts, dim=2).numpy(), want, **F32_TOL)


def test_decode_attention_tp_refuses_uneven_splits():
    """A local GQA group that does not divide, or local heads that are not
    the model's heads over the axis, raise."""
    from sjd_tpu_torch.ops.decode_attention import decode_attention_tp

    q = torch.zeros(1, 2, 3, 8)
    k = torch.zeros(1, 16, 2, 8)
    ce, valid = torch.zeros(1, dtype=torch.int32), torch.ones(1, 16, dtype=torch.bool)
    axis = types.SimpleNamespace(size=2)
    with pytest.raises(ValueError, match="GQA"):
        decode_attention_tp(q, k, k, None, None, ce, valid, window=2, axis=axis)
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="even split"):
        decode_attention_tp(q, k, k, None, None, ce, valid, window=2, axis=axis, num_heads=6,
                            num_kv_heads=4)


@pytest.mark.parametrize("m", [2, 4])
def test_int4_repack_gives_the_logical_k_slice(m):
    """A packed int4 leaf's column shard (unpacked, sliced, repacked
    split-half within the slice) multiplies as the logical K slice does, and
    the ranks' partial products sum to the full product; cutting the packed
    bytes instead does not."""
    from sjd_tpu_torch.ops.quant_linear import quant_linear_a16_plain, unpack_int4

    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32))
    leaf = pt.quantize_int4(w)
    codes = unpack_int4(leaf["q4p"])
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    full = quant_linear_a16_plain(x, leaf["q4p"][1], leaf["s"][1], bits=4)
    total = torch.zeros_like(full)
    n = 64 // m
    for r in range(m):
        shard = psh.packed_column_shard(leaf["q4p"], r, m)
        assert shard.shape == (2, 16, n // 2)
        assert torch.equal(unpack_int4(shard), codes[..., r * n:(r + 1) * n])
        total += quant_linear_a16_plain(x[:, r * n:(r + 1) * n], shard[1], leaf["s"][1], bits=4)
    np.testing.assert_allclose(total.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)
    naive = leaf["q4p"][..., : n // 2]
    assert not torch.equal(unpack_int4(naive), codes[..., :n])


class _StubMesh:
    """What shard_params reads of a mesh: the axes, this rank's coordinates
    (rank r of the model axis) and the device type."""

    def __init__(self, model, rank):
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.zeros(1, model)
        self.device_type = "cuda"
        self._rank = rank

    def get_local_rank(self, axis):
        return self._rank if axis == "model" else 0

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("m", [2, 4, 8])
def test_chameleon_34b_shards_at_tp(m):
    """The real Chameleon-34B config (48 layers, d 8192, 64 query heads over
    8 KV heads of 128, swin-norm, vocab 65536) in bf16 and at W4A16 through
    shard_params under FakeTensorMode, on the first and the last rank of a
    model axis of m: even shards, 64/m query over 8/m KV heads of 128 (the
    kernels' width, GQA group 8), and int4 shards the K1 kernel takes
    (16-byte rows), the row-parallel scales whole (the counterpart of
    test_chameleon_34b_tp8_decode_compiles_spmd)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from sjd_tpu_torch.models.chameleon import chameleon_config

    cfg = chameleon_config("34B")
    specs = psh.decoder_param_specs(cfg, tp=True)
    with FakeTensorMode():
        bf16 = pt.init_params(0, cfg, device="cpu")
        w4 = pt.quantize_weights(bf16, bits=4, head_bits=8, equilibrate=False)
        for rank in (0, m - 1):
            for tree in (bf16, w4):
                local = psh.shard_params(psh.copy_tree(tree), _StubMesh(m, rank), specs, cfg=cfg)
                assert local.model_size == m
                lay = local["layers"]
                rows = {k: (v["q4p"] if isinstance(v, dict) and "q4p" in v else
                            v["q"] if isinstance(v, dict) else v).shape for k, v in lay.items()}
                assert rows["wq"][1] == 64 // m * 128 and rows["wk"][1] == 8 // m * 128
                assert (rows["wq"][1] // 128) // (rows["wk"][1] // 128) == 8
                assert rows["w_gate"][1] == cfg.intermediate_size // m
                assert local["embed"].shape[0] == 65536 // m
                if tree is w4:
                    for name in pt.QUANTIZED:
                        assert lay[name]["q4p"].shape[-1] % 16 == 0, name
                    assert lay["wo"]["q4p"].shape[-1] == 8192 // m // 2
                    assert lay["w_down"]["q4p"].shape[-1] == 22016 // m // 2
                    assert lay["w_down"]["s"].shape == (48, 8192)
