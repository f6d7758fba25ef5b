"""The port's meshes and sharding rules (sjd_tpu_torch.parallel) against
sjd_tpu's, and its sharded train step on four CPU processes over gloo: the
specs leaf by leaf against JAX's PartitionSpecs, and on meshes 4 x 1
(FSDP), 1 x 4 (TP) and 2 x 2 each rank's share of each sharded leaf, the
sharded forward_train and two step_fn calls against one process, and a
checkpoint saved under 4 x 1 restored under 2 x 2 (the counterpart of
tests/test_parallel.py). JAX runs in the parent process only; the four
workers are one spawn for the whole file, with a timeout of its own."""

import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sjd_tpu_torch.models import transformer as pt
from sjd_tpu_torch.parallel import sharding as psh
from sjd_tpu_torch.parallel.sharding import _named_leaves
from sjd_tpu_torch.parallel.training import TrainConfig

WORLD = 4
B, T = 4, 10
# mesh name: (data, model, tp, fsdp)
MESHES = {"fsdp_4x1": (4, 1, False, True), "tp_1x4": (1, 4, True, False),
          "both_2x2": (2, 2, True, True)}
TCFG = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
            grad_clip=1.0, z_loss_weight=1e-4)
TIMEOUT_S = 240


def _cfg():
    # tests/test_parallel.py's configuration
    return pt.DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                            num_heads=4, num_kv_heads=4, head_dim=8, qk_norm=True,
                            dtype=torch.float32, max_position_embeddings=64)


def _batch():
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, 64, (B, T)))
    labels = ids.clone()
    labels[:, :2] = -100
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[1, -3:] = False
    labels[~mask] = -100
    return ids, labels, mask


def _positions():
    return torch.arange(T)[None].expand(B, T)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _run_one(params, mesh, tp=False, fsdp=False):
    """forward_train's logits, then two step_fn calls: (logits, metrics,
    final params as global tensors, the state)."""
    from sjd_tpu_torch.parallel import make_train_step

    cfg = _cfg()
    init_fn, step_fn = make_train_step(mesh, cfg, TrainConfig(**TCFG), tp=tp, fsdp=fsdp,
                                       device="cpu")
    state = init_fn(params=_clone(params))
    ids, labels, mask = _batch()
    data = mesh.mesh.shape[0]
    rank = mesh.get_local_rank("data") if data > 1 else 0
    rows = slice(rank * B // data, (rank + 1) * B // data)
    with torch.no_grad():
        logits = pt.forward_train(state.params, cfg, ids[rows], _positions()[rows],
                                  attn_mask=mask[rows])
    metrics = []
    for _ in range(2):
        state, m = step_fn(state, ids, labels, mask)
        metrics.append({k: float(v) for k, v in m.items()})
    full = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
            for n, p in _named_leaves(state.params)}
    return logits, (rows.start, rows.stop), metrics, full, state


def _worker(rank: int, port: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    from sjd_tpu_torch.parallel import make_mesh
    from sjd_tpu_torch.utils import checkpoints as ckpt

    params = torch.load(os.path.join(tmp, "params.pt"))
    out = {}
    for name, (data, model, tp, fsdp) in MESHES.items():
        mesh = make_mesh(data=data, model=model, device="cpu")
        logits, rows, metrics, full, state = _run_one(params, mesh, tp, fsdp)
        shares = {n: (p.to_local().numel(), p.numel())
                  for n, p in _named_leaves(state.params)}
        out[name] = dict(logits=logits, rows=rows, metrics=metrics, shares=shares,
                         coord=(mesh.get_local_rank("data"), mesh.get_local_rank("model")),
                         params=full if rank == 0 else None)
        if name == "fsdp_4x1":
            mgr = ckpt.make_manager(os.path.join(tmp, "ck"), max_keep=1)
            ckpt.save(mgr, 2, state)
        if name == "both_2x2":
            from sjd_tpu_torch.parallel import make_train_step

            init_fn, _ = make_train_step(mesh, _cfg(), TrainConfig(**TCFG), tp=tp, fsdp=fsdp,
                                         device="cpu")
            back = ckpt.restore(ckpt.make_manager(os.path.join(tmp, "ck")), init_fn(7))
            out["restored"] = dict(step=back.step, params={
                n: p.full_tensor() for n, p in _named_leaves(back.params)})
    torch.save(out, os.path.join(tmp, f"{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_params():
    import jax

    from sjd_tpu.models import DecoderConfig, init_params
    from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax

    jcfg = DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=4, head_dim=8, qk_norm=True,
                         dtype=jax.numpy.float32, max_position_embeddings=64)
    jp = init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                     decoder_config_from_jax(jcfg), device="cpu")


@pytest.fixture(scope="module")
def quantized_trees():
    """{bits: (sjd_tpu's quantized tree, the port's)} at int8 and int4."""
    import jax

    from sjd_tpu.models.transformer import quantize_weights
    from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax

    jcfg, jp, _ = _jax_params()
    out = {}
    for bits in (8, 4):
        jq = quantize_weights(jp, bits=bits, config=jcfg)
        out[bits] = jq, params_from_jax(jax.tree.map(np.asarray, jq),
                                        decoder_config_from_jax(jcfg), device="cpu")
    return out


@pytest.mark.parametrize("tp,fsdp,data", [(True, False, 0), (False, True, 4),
                                          (True, True, 2), (True, True, 8), (False, True, 3)])
def test_specs_equal_jax(quantized_trees, tp, fsdp, data):
    """decoder_param_specs / add_fsdp_axis, and expand_specs_for_quantized
    over int8 and int4 trees, equal tuple(P) of sjd_tpu's, leaf by leaf."""
    import dataclasses

    import jax
    from jax.sharding import PartitionSpec as P

    from sjd_tpu.parallel import sharding as jsh
    from sjd_tpu_torch.convert import decoder_config_from_jax

    def as_tuples(tree):
        return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))

    jcfg = _jax_params()[0]
    for cfg in (jcfg, dataclasses.replace(jcfg, tie_word_embeddings=True)):
        want = jsh.decoder_param_specs(cfg, tp=tp, fsdp=fsdp, data_size=data)
        got = psh.decoder_param_specs(decoder_config_from_jax(cfg), tp=tp, fsdp=fsdp,
                                      data_size=data)
        assert got == as_tuples(want)
    want_specs = jsh.decoder_param_specs(jcfg, tp=tp, fsdp=fsdp, data_size=data)
    got_specs = psh.decoder_param_specs(decoder_config_from_jax(jcfg), tp=tp, fsdp=fsdp,
                                        data_size=data)
    for jq, pq in quantized_trees.values():
        want = jsh.expand_specs_for_quantized(jq, want_specs)
        assert psh.expand_specs_for_quantized(pq, got_specs) == as_tuples(want)


def test_sharded_train_step_on_four_gloo_processes(tmp_path):
    """Each rank holds 1/4 (4 x 1, 1 x 4) or 1/2 or 1/4 (2 x 2) of each
    sharded leaf; the sharded forward_train's logits, and the loss and grad
    norm of two step_fn calls, equal one process within rtol 2e-5, and so do
    the parameters after them, with an absolute tolerance of 1e-2 of the
    1e-2 rate: Adam divides each gradient by its own running scale, so the
    float32 noise of another summation order in a near-zero gradient element
    reaches that element's update at that scale (one element of w_up moved
    4.5e-5 off in 4096 under 1 x 4). A checkpoint of the 4 x 1 state
    restores bit-equal under 2 x 2."""
    from sjd_tpu_torch.parallel import make_mesh

    _, _, params = _jax_params()
    torch.save(params, tmp_path / "params.pt")
    want_logits, _, want_metrics, want_params, _ = _run_one(params, make_mesh(device="cpu"))

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(tmp_path))) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} workers still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    outs = [torch.load(tmp_path / f"{r}.pt") for r in range(WORLD)]

    specs = {name: psh.decoder_param_specs(_cfg(), tp=tp, fsdp=fsdp, data_size=data)
             for name, (data, _, tp, fsdp) in MESHES.items()}
    for name, (data, model, _, _) in MESHES.items():
        spec = dict(_named_leaves(specs[name]))
        for out in outs:
            r = out[name]
            for leaf, (local, total) in r["shares"].items():
                split = (data if "data" in spec[leaf] else 1) * (model if "model" in spec[leaf]
                                                                 else 1)
                assert local * split == total, (name, leaf, spec[leaf])
            lo, hi = r["rows"]
            np.testing.assert_allclose(r["logits"].numpy(), want_logits[lo:hi].numpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=name)
            for got, want in zip(r["metrics"], want_metrics):
                for k in ("loss", "grad_norm", "ce", "z_loss"):
                    np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=(name, k))
                assert got["n_tokens"] == want["n_tokens"]
        for leaf, t in outs[0][name]["params"].items():
            np.testing.assert_allclose(t.numpy(), want_params[leaf].numpy(), rtol=2e-5,
                                       atol=1e-2 * TCFG["learning_rate"], err_msg=(name, leaf))
        # every leaf that the specs shard is split on some rank
        assert any(spec[leaf] != (None,) * len(spec[leaf]) for leaf in spec), name
    for out in outs:
        assert out["restored"]["step"] == 2
        for leaf, t in out["restored"]["params"].items():
            assert torch.equal(t, outs[0]["fsdp_4x1"]["params"][leaf]), leaf
