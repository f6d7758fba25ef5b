"""The port's training path (sjd_tpu_torch.models.transformer.forward_train,
sjd_tpu_torch.parallel.training) against sjd_tpu's on the same numpy
inputs and the same parameters (sjd_tpu's init_params through
convert.params_from_jax): forward_train's logits, loss_fn and its
gradients, the LR schedule against optax, and four calls of the train step
against JAX's make_train_step on a 1 x 1 mesh."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sjd_tpu.models import DecoderConfig, forward_train as jax_forward_train
from sjd_tpu.models import init_params as jax_init_params, make_rope_table as jax_rope
from sjd_tpu.models.transformer import quantize_weights as jax_quantize_weights
from sjd_tpu.parallel import TrainConfig as JaxTrainConfig
from sjd_tpu.parallel import loss_fn as jax_loss_fn
from sjd_tpu.parallel import make_mesh as jax_make_mesh
from sjd_tpu.parallel import make_train_step as jax_make_train_step
from sjd_tpu.parallel.training import make_lr_schedule as jax_lr_schedule
from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax, train_config_from_jax
from sjd_tpu_torch.models import transformer as pt
from sjd_tpu_torch.parallel import make_mesh, make_train_step
from sjd_tpu_torch.parallel import training as ptrain

# tests/test_parallel.py's configuration
CFG = DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=4, head_dim=8, qk_norm=True,
                    dtype=jnp.float32, max_position_embeddings=64)
B, T = 4, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jparams, jcfg):
    return params_from_jax(_np(jparams), decoder_config_from_jax(jcfg), device="cpu")


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 64, (B, T)).astype(np.int32)
    labels = ids.copy()
    labels[:, :2] = -100
    mask = np.ones((B, T), bool)
    mask[1, -3:] = False  # a right-padded row
    labels[~mask] = -100
    return ids, labels, mask


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and not ("q" in v or "q4p" in v):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("case", ["qk_norm", "qk_norm_padded", "swin_norm_padded", "int8"])
def test_forward_train_equals_jax(case):
    import dataclasses

    jcfg = dataclasses.replace(CFG, swin_norm=True) if case.startswith("swin") else CFG
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    if case == "int8":
        jp = jax_quantize_weights(jp, bits=8, config=jcfg)
    ids, _, mask = _batch()
    mask = mask if case.endswith("padded") else None
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    rope = jax_rope(jcfg, 64)
    want = jax_forward_train(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                             attn_mask=None if mask is None else jnp.asarray(mask),
                             rope_table=rope, remat=False)
    got = pt.forward_train(_port(jp, jcfg), decoder_config_from_jax(jcfg),
                           torch.from_numpy(ids), torch.from_numpy(pos.copy()),
                           attn_mask=None if mask is None else torch.from_numpy(mask),
                           rope_table=torch.from_numpy(np.array(rope)))
    assert got.dtype == torch.float32 and got.shape == (B, T, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_remat_changes_no_value():
    """remat=True recomputes each layer in the backward: logits and every
    gradient bit-equal to remat=False."""
    cfg = decoder_config_from_jax(CFG)
    ids, _, mask = (torch.from_numpy(x) for x in _batch())
    pos = torch.arange(T)[None].expand(B, T)
    out = []
    for remat in (False, True):
        p = _port(jax_init_params(jax.random.PRNGKey(0), CFG), CFG)
        for _, t in _leaves(p):
            t.requires_grad_(True)
        logits = pt.forward_train(p, cfg, ids, pos, attn_mask=mask, remat=remat)
        (logits.square().mean() + logits[:, -1].logsumexp(-1).sum()).backward()
        out.append((logits.detach(), {n: t.grad for n, t in _leaves(p)}))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(g, out[1][1][name]), name


@pytest.mark.parametrize("mask_image_logits", [False, True])
def test_loss_fn_and_grads_equal_jax(mask_image_logits):
    """loss, ce, z_loss and n_tokens, and the gradient of every leaf, against
    jax.value_and_grad of sjd_tpu's loss_fn (the masked span holds no
    label, so the loss stays finite)."""
    jtc = JaxTrainConfig(z_loss_weight=1e-2, mask_image_logits=mask_image_logits,
                         image_vocab_start=4, image_vocab_end=20)
    jp = jax_init_params(jax.random.PRNGKey(0), CFG)
    ids, labels, mask = _batch()
    labels = np.where(labels >= 0, 21 + labels % 43, labels).astype(np.int32)
    rope = jax_rope(CFG)
    (jloss, jaux), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jp, CFG, jtc, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask), rope)
    p = _port(jp, CFG)
    for _, t in _leaves(p):
        t.requires_grad_(True)
    loss, aux = ptrain.loss_fn(p, decoder_config_from_jax(CFG), train_config_from_jax(jtc),
                               torch.from_numpy(ids), torch.from_numpy(labels),
                               torch.from_numpy(mask), torch.from_numpy(np.array(rope)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    for k in ("ce", "z_loss"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-4)
    assert int(aux["n_tokens"]) == int(jaux["n_tokens"]) == int((labels[:, 1:] != -100).sum())
    jg = dict(_leaves(_np(jgrads)))
    for name, t in _leaves(p):
        scale = np.abs(jg[name]).max()
        np.testing.assert_allclose(t.grad.numpy(), jg[name], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("lr,warmup,total,min_ratio", [
    (1e-3, 10, 50, 0.1),
    (2e-5, 100, 400, 0.0),
    (3e-4, 100, 30, 0.0),  # total < 2 * warmup: the warmup clamps to 15
])
def test_lr_schedule_equals_optax(lr, warmup, total, min_ratio):
    """Every step within two float32 ulps of the peak rate of optax's value,
    evaluated eagerly and as the train step evaluates it (under jit): the
    port computes optax's float32 expression, and differs only by the last
    bit of XLA's and torch's cos (amplified near the end, where 1 + cos
    cancels) and by XLA's rewriting of the expression under jit (1.5 ulps
    of the peak at most in these settings)."""
    kw = dict(learning_rate=lr, warmup_steps=warmup, total_steps=total, min_lr_ratio=min_ratio)
    want_fn = jax_lr_schedule(JaxTrainConfig(**kw))
    got_fn = ptrain.make_lr_schedule(ptrain.TrainConfig(**kw))
    steps = np.arange(total + 5)
    got = np.array([got_fn(int(s)) for s in steps], np.float32)
    eager = np.asarray(jax.vmap(want_fn)(jnp.asarray(steps, jnp.int32)), np.float32)
    jitted = np.array([jax.jit(want_fn)(jnp.int32(s)) for s in steps], np.float32)
    ulp = float(np.spacing(np.float32(lr)))
    for want in (eager, jitted):
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)
    assert got[0] == 0.0 and got.max() == np.float32(lr)


def test_decay_mask_is_ndim_on_the_stacked_tree():
    """optax's mask ``x.ndim >= 2`` on the stacked tree decays the per-layer
    norms and the qk-norm scales and biases; only final_norm is not (the
    reference exempts every norm: a known difference, kept)."""
    p = _port(jax_init_params(jax.random.PRNGKey(0), CFG), CFG)
    opt = ptrain.make_optimizer(ptrain.TrainConfig(), p)
    decayed, kept = ({n for n, q in opt.names.items()
                      if any(q is x for x in g["params"])} for g in opt.adamw.param_groups)
    assert opt.adamw.param_groups[0]["weight_decay"] == 0.1
    assert opt.adamw.param_groups[1]["weight_decay"] == 0.0
    assert kept == {"final_norm"}
    assert {"layers.attn_norm", "layers.mlp_norm", "layers.q_norm_scale", "layers.q_norm_bias",
            "layers.k_norm_scale", "layers.k_norm_bias", "embed", "lm_head"} <= decayed
    jmask = dict(_leaves(jax.tree.map(lambda x: x.ndim >= 2,
                                      jax_init_params(jax.random.PRNGKey(0), CFG))))
    assert {n for n, m in jmask.items() if m} == decayed


@pytest.mark.parametrize("case", [
    dict(grad_accum=1, grad_clip=1e3, weight_decay=0.0),  # clip does not trigger
    dict(grad_accum=2, grad_clip=1e3, weight_decay=0.0),
    dict(grad_accum=1, grad_clip=0.05, weight_decay=0.0),  # clip triggers
    dict(grad_accum=2, grad_clip=1.0, weight_decay=0.5),
], ids=["accum1", "accum2", "clip", "decay"])
def test_train_step_equals_jax(case):
    """Four step_fn calls on four batches: loss and grad_norm of each call,
    then every parameter, within rtol 1e-4 of JAX's make_train_step. The
    parameters' absolute tolerance is 2e-3 of the 1e-2 rate: Adam divides
    each gradient by its own running scale, so the float32 noise of the
    smallest gradients (the k-norm biases', whose effect the softmax all
    but cancels: they shift every key of a row alike up to RoPE's turn)
    reaches their updates at that scale."""
    jtc = JaxTrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10,
                         z_loss_weight=1e-4, **case)
    jmesh = jax_make_mesh(data=1, model=1, devices=jax.devices()[:1])
    jinit, jstep = jax_make_train_step(jmesh, CFG, jtc, tp=False, fsdp=True)
    batches = [_batch(seed) for seed in range(4)]
    with jax.set_mesh(jmesh):
        jstate = jinit(jax.random.PRNGKey(0))
        start = _np(jstate.params)
        jmetrics = []
        for ids, labels, mask in batches:
            jstate, m = jstep(jstate, *(jnp.asarray(x) for x in (ids, labels, mask)))
            jmetrics.append({k: float(v) for k, v in m.items()})
        jfinal = dict(_leaves(_np(jstate.params)))
    init_fn, step_fn = make_train_step(make_mesh(device="cpu"), decoder_config_from_jax(CFG),
                                       train_config_from_jax(jtc), device="cpu")
    state = init_fn(params=params_from_jax(start, decoder_config_from_jax(CFG), device="cpu"))
    for (ids, labels, mask), jm in zip(batches, jmetrics):
        state, m = step_fn(state, *(torch.from_numpy(x) for x in (ids, labels, mask)))
        for k in ("loss", "grad_norm", "ce", "z_loss"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4, err_msg=k)
        assert int(m["n_tokens"]) == int(jm["n_tokens"])
    assert state.step == 4 and state.opt_state.gradient_step == 4 // case["grad_accum"]
    for name, t in _leaves(state.params):
        np.testing.assert_allclose(t.detach().numpy(), jfinal[name], rtol=1e-4,
                                   atol=2e-3 * jtc.learning_rate, err_msg=name)
