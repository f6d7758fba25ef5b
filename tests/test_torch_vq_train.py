"""VQGAN tokenizer training in the port (sjd_tpu_torch.models.vq: train,
lpips, discriminator, discriminator_stylegan, vq_train) against sjd_tpu on
the CPU, at tests/test_vq_train.py's small VQ (ch 32, ch_mult (1, 2), 16 px,
32 codes of 4 dims), PatchGAN ndf 8, StyleGAN at image_size 16 and LPIPS at
VGG16's full widths. Parameters are drawn by sjd_tpu's init functions and
carried over by ``convert``; pixels are seeded numpy.

Tolerances: LPIPS distances, patch maps and StyleGAN logits within 1e-5 of
the largest magnitude; the GAN losses to f32 rounding on the same logits
(1e-6 relative);
codebook ids and usage equal; G and D gradients each leaf within 1e-4 of
its largest magnitude; one Adam update from the same gradients within 1e-6
of optax's; the EMA within 1e-6; ``disc_w`` equal; three alternating
g_step/d_step pairs each aux value within 1e-3 relative (the logits' means,
near 0 on random weights, within 1e-4 absolute); the synthetic batches
bit-equal.

JAX's gradients come out of its own jitted steps: while the step sets are
built, sjd_tpu's train module sees an optax whose ``adam`` also keeps the
step's gradients in its state. Each JAX step set is built once per module
(each compiles in 7-15 s on a CPU)."""

import ast
import dataclasses
import importlib
import importlib.util
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sjd_tpu.models.vq import VQConfig, encode as j_encode, init_vq_params
from sjd_tpu.models.vq import train as jtrain
from sjd_tpu.models.vq.discriminator import (
    PatchGANConfig as JPatchGANConfig, init_patchgan_params, patchgan_logits as j_patchgan)
from sjd_tpu.models.vq.discriminator_stylegan import (
    StyleGANDiscConfig as JStyleGANConfig, init_stylegan_disc_params,
    stylegan_disc_logits as j_stylegan)
from sjd_tpu.models.vq.lpips import (
    VGG16_PLAN as J_VGG16_PLAN, _TV_CONV_IDX, init_lpips_params, lpips as j_lpips,
    port_lpips as j_port_lpips)
from sjd_tpu_torch import convert
from sjd_tpu_torch.models.vq import discriminator as pdisc
from sjd_tpu_torch.models.vq import discriminator_stylegan as pstyle
from sjd_tpu_torch.models.vq import taming as ptaming
from sjd_tpu_torch.models.vq import train as ptrain
from sjd_tpu_torch.models.vq import vq_train as pcli

# the package exports the function lpips, which hides the module of that name
plpips = importlib.import_module("sjd_tpu_torch.models.vq.lpips")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = VQConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16, z_channels=32,
                embed_dim=4, n_embed=32, dtype=jnp.float32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jit0(fn, *args, static=()):
    """``fn(*args)`` compiled by XLA at optimization level 0: the same
    program (draws and one-off forwards) in about a third of the compile."""
    compiled = jax.jit(fn, static_argnums=static).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    return compiled(*[a for i, a in enumerate(args) if i not in static])


def pixels(seed, side=16, batch=2):
    return np.tanh(np.random.RandomState(seed).randn(batch, side, side, 3)).astype(np.float32)


def port_cfg(l2: bool):
    return convert.vq_config_from_jax(dataclasses.replace(JCFG, l2_norm_codebook=l2))


def vq_port(tree, l2=False):
    return convert.vq_params_from_jax(tree, port_cfg(l2), device="cpu")


def trainable(tree):
    for t in ptrain.tree_leaves(tree):
        t.requires_grad_(True)
    return tree


def within_max(got, want, rel, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, (what, err, bound)


def leaf_names(tree, prefix=""):
    """Paths of ``tree_leaves``'s leaves, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]] if isinstance(tree, torch.Tensor) else []


@pytest.fixture(scope="module")
def vq_np():
    return np_tree(jit0(init_vq_params, jax.random.PRNGKey(0), JCFG, static=(1,)))


@pytest.fixture(scope="module")
def lpips_np():
    tree = np_tree(jit0(lambda k: {n: v for n, v in init_lpips_params(k).items()
                                   if n != "calibrated"}, jax.random.PRNGKey(1)))
    return dict(tree, calibrated=False)


# sjd_tpu's alternating steps, built once, run in the background


def _capturing(tx):
    """optax ``tx`` whose state also holds the last gradients it was given."""
    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, p=None):
        u, inner = tx.update(g, state[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(init, update)


class _CapturingOptax:
    @staticmethod
    def adam(*a, **k):
        return _capturing(optax.adam(*a, **k))

    apply_updates = staticmethod(optax.apply_updates)


# A: PatchGAN with LPIPS and the adaptive weight, hinge; B: StyleGAN, no
# perceptual term, L2-normalised codebook, vanilla D and non-saturating G.
# The rates are tests/test_vqgan_adversarial.py's: Adam's first update is
# about lr * sign(g), so a gradient element at f32 noise level moves its
# weight by up to 2 lr between two correct runs, and the pairs' aux drift
# grows with lr.
SETS = {
    "patchgan_lpips_adaptive": dict(
        l2=False, disc_type="patchgan", lpips=True,
        tcfg=dict(learning_rate=1e-4, disc_lr=2e-4, disc_start=1, disc_weight=0.5,
                  perceptual_weight=1.0, recon_loss="l2", disc_adaptive_weight=True)),
    "stylegan_l2": dict(
        l2=True, disc_type="stylegan", lpips=False,
        tcfg=dict(learning_rate=1e-4, disc_lr=2e-4, disc_start=1, disc_weight=0.5,
                  perceptual_weight=0.0, recon_loss="l1", disc_loss="vanilla",
                  gen_adv_loss="non-saturating", ema_decay=0.9)),
}
PAIRS = 3


def _disc_cfgs(disc_type):
    if disc_type == "stylegan":
        return JStyleGANConfig(image_size=16), pstyle.StyleGANDiscConfig(image_size=16)
    return JPatchGANConfig(ndf=8, n_layers=2), pdisc.PatchGANConfig(ndf=8, n_layers=2)


def _d_from_jax(disc_type, tree):
    conv = (convert.stylegan_disc_params_from_jax if disc_type == "stylegan"
            else convert.patchgan_params_from_jax)
    return conv(tree, device="cpu")


def _jax_d_grad(spec, jt):
    """jax.grad of sjd_tpu's d_step loss, disc_w * d_loss(D(real), D(recon)),
    in the D parameters, on given real and recon pixels."""
    jd_cfg = _disc_cfgs(spec["disc_type"])[0]
    logits = j_stylegan if spec["disc_type"] == "stylegan" else j_patchgan

    def loss(dp, real, fake, disc_w):
        return disc_w * jtrain._D_LOSSES[jt.disc_loss](logits(dp, real, jd_cfg),
                                                      logits(dp, fake, jd_cfg))

    return jax.jit(jax.grad(loss))


def _jax_pairs(spec, steps, vq_np):
    """PAIRS alternating pairs through sjd_tpu's steps, recording the trees
    and the captured gradients of every step, and for the first two the
    recon sjd_tpu's forward makes from the parameters its g_step returned
    with the D loss's gradient on it (in a worker thread: XLA's compile
    releases the GIL, so it overlaps the port's tests)."""
    init_fn, g_step, d_step = steps
    jt = jtrain.VQTrainConfig(**spec["tcfg"])
    jcfg = dataclasses.replace(JCFG, l2_norm_codebook=spec["l2"])
    g_opt, d_params, d_opt, ema = init_fn(vq_np, jax.random.PRNGKey(2))
    d0 = np_tree(d_params)
    params = vq_np
    xs = [pixels(20 + i) for i in range(PAIRS)]
    x0, i0, w0 = jnp.asarray(xs[0]), jnp.int32(0), jnp.float32(0)
    # the four programs compile at once (the same ones the calls would)
    with ThreadPoolExecutor(4) as pool:
        compiled = [pool.submit(lambda f, *a: f.lower(*a).compile(), *job) for job in (
            (g_step, params, g_opt, ema, d_params, x0, i0),
            (d_step, d_params, d_opt, params, x0, i0),
            (jax.jit(lambda p, x: jtrain._vq_forward(p, jcfg, x)[0]), params, x0),
            (_jax_d_grad(spec, jt), d_params, x0, x0, w0))]
        g_step, d_step, forward, d_grad = (c.result() for c in compiled)
    records = []
    for i, x in enumerate(xs):
        rec = {"params": np_tree(params), "d_params": np_tree(d_params), "ema": np_tree(ema)}
        params, g_opt, ema, g_aux = g_step(params, g_opt, ema, d_params, jnp.asarray(x),
                                           jnp.int32(i))
        rec.update(g_grads=np_tree(g_opt[1]), params_after=np_tree(params),
                   ema_after=np_tree(ema))
        if i < 2:
            recon = forward(params, jnp.asarray(x))
            disc_w = jnp.float32(jt.disc_weight if i >= jt.disc_start else 0.0)
            rec.update(recon=np.array(recon), d_grads=np_tree(
                d_grad(d_params, jnp.asarray(x), recon, disc_w)))
        d_params, d_opt, d_aux = d_step(d_params, d_opt, params, jnp.asarray(x), jnp.int32(i))
        rec["aux"] = {k: float(v) for k, v in {**g_aux, **d_aux}.items()}
        records.append(rec)
    return xs, d0, records


@pytest.fixture(scope="module", autouse=True)
def jax_pairs(vq_np, lpips_np):
    """sjd_tpu's step sets, built here (under the capturing optax) and run
    in worker threads from the module's start; torch keeps half the cores
    meanwhile (its spinning workers would starve the compiles)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    steps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "optax", _CapturingOptax)
        for name, spec in SETS.items():
            steps[name] = jtrain.make_vqgan_train_steps(
                dataclasses.replace(JCFG, l2_norm_codebook=spec["l2"]),
                jtrain.VQTrainConfig(**spec["tcfg"]),
                lpips_params=lpips_np if spec["lpips"] else None,
                disc_cfg=_disc_cfgs(spec["disc_type"])[0], disc_type=spec["disc_type"])
    try:
        with ThreadPoolExecutor(len(SETS)) as pool:
            yield {name: pool.submit(_jax_pairs, SETS[name], steps[name], vq_np)
                   for name in SETS}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(SETS))
def step_set(request, vq_np, lpips_np, jax_pairs):
    """sjd_tpu's pairs, and PAIRS pairs through the port's steps from the
    same parameters and pixels."""
    spec = SETS[request.param]
    xs, d0, jax_rec = jax_pairs[request.param].result()
    tcfg = ptrain.VQTrainConfig(**spec["tcfg"])
    assert tcfg == convert.vq_train_config_from_jax(jtrain.VQTrainConfig(**spec["tcfg"]))
    pd_cfg = _disc_cfgs(spec["disc_type"])[1]
    lp = convert.lpips_params_from_jax(lpips_np, device="cpu") if spec["lpips"] else None
    cfg = port_cfg(spec["l2"])
    p_init, p_g, p_d = ptrain.make_vqgan_train_steps(cfg, tcfg, lpips_params=lp,
                                                     disc_cfg=pd_cfg,
                                                     disc_type=spec["disc_type"])
    p_params = vq_port(vq_np, spec["l2"])
    p_gopt, p_dparams, p_dopt, p_ema = p_init(p_params, 0)
    with torch.no_grad():  # the port's D starts from sjd_tpu's draw
        for t, v in zip(ptrain.tree_leaves(p_dparams),
                        ptrain.tree_leaves(_d_from_jax(spec["disc_type"], d0))):
            t.copy_(v)
    port_aux, stray = [], []
    for i, x in enumerate(xs):
        p_params, p_gopt, p_ema, g_aux = p_g(p_params, p_gopt, p_ema, p_dparams,
                                             torch.from_numpy(x), i)
        stray += [t for t in ptrain.tree_leaves(p_dparams) if t.grad is not None]
        p_dparams, p_dopt, d_aux = p_d(p_dparams, p_dopt, p_params, torch.from_numpy(x), i)
        stray += [t for t in ptrain.tree_leaves(p_params) if t.grad is not None]
        port_aux.append({k: float(v) for k, v in {**g_aux, **d_aux}.items()})
    return dict(spec=spec, tcfg=tcfg, cfg=cfg, lpips=lp, pd_cfg=pd_cfg, xs=xs, jax=jax_rec,
                port_aux=port_aux, stray=stray)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def _decode_before(params, cfg, ids, grid_hw):
    """taming.decode as it was before decode_latents split it."""
    z = ptaming.codebook_lookup(cfg, params["codebook"], ids, grid_hw).to(cfg.dtype)
    z = z.permute(0, 3, 1, 2)
    z = ptaming.conv2d(z, params["post_quant_conv_w"], params["post_quant_conv_b"])
    d = params["decoder"]
    h = ptaming.conv2d(z, d["conv_in_w"], d["conv_in_b"])
    h = ptaming.resnet_block(d["mid_block1"], h)
    h = ptaming.attn_block(d["mid_attn"], h)
    h = ptaming.resnet_block(d["mid_block2"], h)
    for level in d["up"]:
        for j in range(cfg.num_res_blocks + 1):
            h = ptaming.resnet_block(level["res"][j], h)
            if level.get("attn"):
                h = ptaming.attn_block(level["attn"][j], h)
        if "upsample" in level:
            h = ptaming.upsample(level["upsample"], h)
    h = ptaming.group_norm(h, d["norm_out_scale"], d["norm_out_bias"])
    h = ptaming.conv2d(ptaming.swish(h), d["conv_out_w"], d["conv_out_b"])
    return h.permute(0, 2, 3, 1)


@pytest.mark.parametrize("l2", [False, True], ids=["plain", "l2"])
def test_decode_stays_bit_equal(vq_np, l2):
    cfg, params = port_cfg(l2), vq_port(vq_np, l2)
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 32, (2, 64)))
    assert torch.equal(ptaming.decode(params, cfg, ids, (8, 8)),
                       _decode_before(params, cfg, ids, (8, 8)))


@pytest.mark.parametrize("l2", [False, True], ids=["plain", "l2"])
def test_vq_forward_matches_jax(vq_np, l2):
    jcfg = dataclasses.replace(JCFG, l2_norm_codebook=l2)
    x = pixels(0)
    recon, parts = jit0(jtrain._vq_forward, vq_np, jcfg, jnp.asarray(x), static=(1,))
    ids = jit0(j_encode, vq_np, jcfg, jnp.asarray(x), static=(1,))
    with torch.no_grad():
        got, got_parts = ptrain._vq_forward(vq_port(vq_np, l2), port_cfg(l2), torch.from_numpy(x))
    np.testing.assert_array_equal(got_parts["ids"].numpy(), np.asarray(ids))
    assert float(got_parts["usage"]) == float(parts["usage"])
    within_max(got, recon, 1e-5, "recon")
    for k in ("codebook", "commit"):
        np.testing.assert_allclose(float(got_parts[k]), float(parts[k]), rtol=1e-4)


@pytest.mark.parametrize("l2", [False, True], ids=["plain", "l2"])
def test_vq_loss_fn_matches_jax(vq_np, l2):
    jcfg = dataclasses.replace(JCFG, l2_norm_codebook=l2)
    jt = jtrain.VQTrainConfig(recon_loss="l1" if l2 else "l2")
    x = pixels(1)
    _, want = jit0(jtrain.vq_loss_fn, vq_np, jcfg, jt, jnp.asarray(x), static=(1, 2))
    with torch.no_grad():
        _, got = ptrain.vq_loss_fn(vq_port(vq_np, l2), port_cfg(l2),
                                   convert.vq_train_config_from_jax(jt), torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


GAN_LOSSES = ["hinge_d_loss", "vanilla_d_loss", "non_saturating_d_loss", "hinge_gen_loss",
              "non_saturating_gen_loss"]


@pytest.mark.parametrize("name", GAN_LOSSES)
def test_gan_losses_match_jax(name):
    rs = np.random.RandomState(3)
    real, fake = (rs.randn(4, 5, 5, 1).astype(np.float32) * 3 for _ in range(2))
    jfn, pfn = getattr(jtrain, name), getattr(ptrain, name)
    args = (real, fake) if "_d_" in name else (fake,)
    want = float(jfn(*map(jnp.asarray, args)))
    got = float(pfn(*map(torch.from_numpy, args)))
    # f32 rounding: the means sum 100 logits in another order than XLA's
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def test_non_saturating_d_loss_passes_no_gradient_to_fake_logits():
    real, fake = (torch.randn(3, 4, requires_grad=True) for _ in range(2))
    g_real, g_fake = torch.autograd.grad(ptrain.non_saturating_d_loss(real, fake), (real, fake))
    assert torch.all(g_fake == 0) and torch.all(g_real != 0)


def test_lpips_matches_jax(lpips_np):
    x, y = pixels(4), pixels(5)
    want = np.asarray(jit0(j_lpips, lpips_np, jnp.asarray(x), jnp.asarray(y)))
    params = convert.lpips_params_from_jax(lpips_np, device="cpu")
    got = plpips.lpips(params, torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,)
    within_max(got, want, 1e-5, "lpips")
    assert torch.all(plpips.lpips(params, torch.from_numpy(x), torch.from_numpy(x)) == 0)
    feats = plpips.vgg16_slices(params, torch.zeros(1, 64, 64, 3))
    assert [tuple(f.shape) for f in feats] == [
        (1, 64, 64, 64), (1, 32, 32, 128), (1, 16, 16, 256), (1, 8, 8, 512), (1, 4, 4, 512)]
    assert plpips.VGG16_PLAN == J_VGG16_PLAN


def test_lpips_ports_from_synthesized_state_dicts(lpips_np):
    """port_vgg16_features / port_lpips_lins on a torchvision-layout VGG16
    state_dict and a taming-layout vgg.pth, synthesized from the random
    draw (no real weights are in the repository)."""
    rs = np.random.RandomState(6)
    vgg = {}
    for i, c in zip(_TV_CONV_IDX, lpips_np["convs"]):
        vgg[f"features.{i}.weight"] = np.array(c["w"].transpose(3, 2, 0, 1))  # HWIO -> OIHW
        vgg[f"features.{i}.bias"] = rs.randn(*c["b"].shape).astype(np.float32) * 0.1
    lins = {f"lin{k}.model.1.weight": rs.rand(1, p[-1], 1, 1).astype(np.float32)
            for k, p in enumerate(J_VGG16_PLAN)}
    jp = j_port_lpips(lins, vgg)
    pp = plpips.port_lpips({k: torch.from_numpy(v) for k, v in lins.items()},
                           {k: torch.from_numpy(v) for k, v in vgg.items()}, device="cpu")
    assert jp["calibrated"] and pp["calibrated"]
    x, y = pixels(7), pixels(8)
    within_max(plpips.lpips(pp, torch.from_numpy(x), torch.from_numpy(y)),
               np.asarray(jit0(j_lpips, {k: v for k, v in jp.items() if k != "calibrated"},
                               jnp.asarray(x), jnp.asarray(y))), 1e-5, "ported")
    random_backbone = plpips.port_lpips({k: torch.from_numpy(v) for k, v in lins.items()},
                                        device="cpu")
    assert not random_backbone["calibrated"]


@pytest.mark.parametrize("n_layers,side", [(2, 16), (3, 32)])
def test_patchgan_matches_jax(n_layers, side):
    jcfg = JPatchGANConfig(ndf=8, n_layers=n_layers)
    tree = np_tree(jit0(init_patchgan_params, jax.random.PRNGKey(3), jcfg, static=(1,)))
    x = pixels(9, side)
    want = np.asarray(jit0(j_patchgan, tree, jnp.asarray(x), jcfg, static=(2,)))
    got = pdisc.patchgan_logits(convert.patchgan_params_from_jax(tree, device="cpu"),
                                torch.from_numpy(x), pdisc.PatchGANConfig(ndf=8, n_layers=n_layers))
    within_max(got, want, 1e-5, "patch map")
    with pytest.raises(ValueError, match="empty"):
        pdisc.patchgan_logits(convert.patchgan_params_from_jax(tree, device="cpu"),
                              torch.zeros(1, side // 2, side // 2, 3))


def test_patchgan_draw_has_the_jax_shapes():
    jcfg = JPatchGANConfig(ndf=8, n_layers=3)
    want = convert.patchgan_params_from_jax(
        np_tree(jit0(init_patchgan_params, jax.random.PRNGKey(0), jcfg, static=(1,))),
        device="cpu")
    got = pdisc.init_patchgan_params(0, pdisc.PatchGANConfig(ndf=8, n_layers=3), device="cpu")
    assert [t.shape for t in ptrain.tree_leaves(got)] == [
        t.shape for t in ptrain.tree_leaves(want)]
    assert pdisc.patchgan_logits(got, torch.zeros(1, 64, 64, 3),
                                 pdisc.PatchGANConfig(ndf=8)).shape == (1, 6, 6, 1)


def test_stylegan_matches_jax():
    jcfg = JStyleGANConfig(image_size=16)
    tree = np_tree(jit0(init_stylegan_disc_params, jax.random.PRNGKey(4), jcfg, static=(1,)))
    x = pixels(10)
    want = np.asarray(jit0(j_stylegan, tree, jnp.asarray(x), jcfg, static=(2,)))
    params = convert.stylegan_disc_params_from_jax(tree, device="cpu")
    got = pstyle.stylegan_disc_logits(params, torch.from_numpy(x),
                                      pstyle.StyleGANDiscConfig(image_size=16))
    assert got.shape == (2, 1)
    within_max(got, want, 1e-5, "stylegan")
    drawn = pstyle.init_stylegan_disc_params(0, pstyle.StyleGANDiscConfig(image_size=16),
                                             device="cpu")
    assert [t.shape for t in ptrain.tree_leaves(drawn)] == [
        t.shape for t in ptrain.tree_leaves(params)]


def test_adam_update_matches_optax(vq_np):
    """Two updates of init_fn's G optimizer against optax.adam(b1=0.5,
    b2=0.9) from the same gradients (seeded, each leaf at its own scale).
    Adam is elementwise, so optax runs on the leaves laid end to end."""
    rs = np.random.RandomState(11)
    grads = [jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 10.0 ** rs.uniform(-7, 0)).astype(np.float32), vq_np)
        for _ in range(2)]
    tcfg = ptrain.VQTrainConfig(learning_rate=3e-4)
    params = vq_port(vq_np)
    init_fn, _, _ = ptrain.make_vqgan_train_steps(port_cfg(False), tcfg)
    g_opt, *_ = init_fn(params, 0)

    def flat(tree):
        return np.concatenate([t.detach().reshape(-1).numpy() for t in ptrain.tree_leaves(tree)])

    tx = optax.adam(tcfg.learning_rate, b1=0.5, b2=0.9)
    jp = jnp.asarray(flat(params))
    state = tx.init(jp)
    for g in grads:
        for p, t in zip(ptrain.tree_leaves(params), ptrain.tree_leaves(vq_port(g))):
            p.grad = t
        g_opt.step()
        u, state = tx.update(jnp.asarray(flat(vq_port(g))), state, jp)
        jp = optax.apply_updates(jp, u)
    assert np.abs(flat(params) - np.asarray(jp)).max() <= 1e-6


# ---------------------------------------------------------------------------
# the alternating steps, against sjd_tpu's jitted ones
# ---------------------------------------------------------------------------


def test_alternating_pairs_match_jax(step_set):
    assert not step_set["stray"], "a step left gradients on the other network's parameters"
    for i, (got, rec) in enumerate(zip(step_set["port_aux"], step_set["jax"])):
        want = rec["aux"]
        assert set(got) == set(want)
        for k, w in want.items():
            # the logits' means are near 0 on random weights, where a relative
            # bound means nothing: 1e-4 absolute for them
            tol = 1e-4 if k.startswith("logits_") else 1e-3 * abs(w)
            assert abs(got[k] - w) <= tol, (i, k, got[k], w)


def test_disc_w_gates_at_disc_start(step_set):
    tcfg = step_set["tcfg"]
    for i, (got, rec) in enumerate(zip(step_set["port_aux"], step_set["jax"])):
        want = rec["aux"]["disc_w"]
        if i < tcfg.disc_start:
            assert got["disc_w"] == want == 0.0 and got["d_loss"] == 0.0
        elif tcfg.disc_adaptive_weight:
            assert want > 0 and abs(got["disc_w"] - want) <= 1e-3 * want
        else:
            assert got["disc_w"] == want == tcfg.disc_weight


@pytest.mark.parametrize("at", [0, 1], ids=["before_disc_start", "after"])
def test_generator_gradients_match_jax(step_set, at):
    """The G loss's gradient on sjd_tpu's parameters of step ``at``; with
    the adaptive weight and the perceptual term in one set, without both in
    the other."""
    rec, spec = step_set["jax"][at], step_set["spec"]
    params = trainable(vq_port(rec["params"], spec["l2"]))
    d_params = _d_from_jax(spec["disc_type"], rec["d_params"])
    loss, aux = ptrain.generator_loss(
        params, d_params, torch.from_numpy(step_set["xs"][at]), at, step_set["cfg"],
        step_set["tcfg"], lpips_params=step_set["lpips"], disc_type=spec["disc_type"],
        disc_cfg=step_set["pd_cfg"])
    assert abs(float(aux["disc_w"]) - rec["aux"]["disc_w"]) <= 1e-3 * rec["aux"]["disc_w"]
    names = leaf_names(params)
    grads = torch.autograd.grad(loss, ptrain.tree_leaves(params))
    want = ptrain.tree_leaves(vq_port(rec["g_grads"], spec["l2"]))
    top = max(float(w.abs().max()) for w in want)
    for name, g, w in zip(names, grads, want):
        if w.abs().max() <= 1e-6 * top:
            # a gradient that is 0 in exact arithmetic, f32 noise on both sides:
            # an attention key bias (softmax ignores a per-query constant), a
            # conv bias before a group norm of one channel per group
            assert g.abs().max() <= 1e-6 * top, name
        else:
            within_max(g, w, 1e-4, f"G {name}")


@pytest.mark.parametrize("at", [0, 1], ids=["before_disc_start", "after"])
def test_discriminator_gradients_match_jax(step_set, at):
    """The D loss's gradient on sjd_tpu's D parameters of step ``at``, both
    sides on the same real pixels and the same recon (sjd_tpu's, from the
    parameters its g_step returned): a near tie in the quantizer resolved
    one way on one side and the other way on the other would change the
    recon of one latent, and D's gradient with it. sjd_tpu's side is its
    d_step's loss, disc_w * d_loss(D(real), D(recon)) (``_jax_d_grad``)."""
    rec, spec, tcfg = step_set["jax"][at], step_set["spec"], step_set["tcfg"]
    x = step_set["xs"][at]
    d_params = trainable(_d_from_jax(spec["disc_type"], rec["d_params"]))
    loss, _ = ptrain.discriminator_loss(d_params, torch.from_numpy(x),
                                        torch.from_numpy(rec["recon"]), at, tcfg,
                                        disc_type=spec["disc_type"],
                                        disc_cfg=step_set["pd_cfg"])
    grads = torch.autograd.grad(loss, ptrain.tree_leaves(d_params))
    want = ptrain.tree_leaves(_d_from_jax(spec["disc_type"], rec["d_grads"]))
    if at < tcfg.disc_start:  # the D loss is multiplied by 0
        assert all(torch.all(g == 0) for g in grads) and all(torch.all(w == 0) for w in want)
    for name, g, w in zip(leaf_names(d_params), grads, want):
        within_max(g, w, 1e-4, f"D {name}")


def test_ema_matches_jax(step_set):
    rec, spec = step_set["jax"][0], step_set["spec"]
    ema = vq_port(rec["ema"], spec["l2"])
    ptrain._ema_update(ema, vq_port(rec["params_after"], spec["l2"]), step_set["tcfg"].ema_decay)
    for i, (e, w) in enumerate(zip(ptrain.tree_leaves(ema),
                                   ptrain.tree_leaves(vq_port(rec["ema_after"], spec["l2"])))):
        assert (e - w).abs().max() <= 1e-6, i


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_vq_train",
                                                  os.path.join(ROOT, "examples", "vq_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_log_keys():
    """The keys of the JSON line examples/vq_train.py prints."""
    tree = ast.parse(open(os.path.join(ROOT, "examples", "vq_train.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in examples/vq_train.py")


def test_synthetic_and_image_batches_equal_jax(tmp_path):
    jcli = _jax_cli()
    want = jcli._synthetic_batches(32, 2, np.random.RandomState(5))
    got = pcli.synthetic_batches(32, 2, np.random.RandomState(5))
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    from sjd_tpu_torch.utils.image_io import write_png

    rs = np.random.RandomState(6)
    for i in range(3):
        write_png(str(tmp_path / f"{i}.png"), (rs.rand(16, 16, 3) * 255).astype(np.uint8))
    want = jcli._image_batches(str(tmp_path), 16, 4, np.random.RandomState(7))
    got = pcli.image_batches(str(tmp_path), 16, 4, np.random.RandomState(7))
    for _ in range(2):
        assert np.array_equal(next(got), next(want))
    assert [pcli.patchgan_layers(s) for s in (16, 32, 64, 256)] == [1, 2, 3, 3]


def test_command_line_keys_and_checkpoint(tmp_path, capsys):
    from sjd_tpu_torch.utils.checkpoints import make_manager, restore

    out = str(tmp_path / "ck")
    pcli.main(["--synthetic", "--steps", "3", "--size", "32", "--batch", "1",
               "--save-every", "3", "--out", out, "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [0, 2]
    for ln in lines:
        assert list(ln) == _jax_log_keys()
        assert all(np.isfinite(v) for v in ln.values())
    assert make_manager(out).all_steps() == [3]
    cfg = dataclasses.replace(ptaming.LLAMAGEN_VQ16, dtype=torch.float32)
    drawn = ptaming.init_vq_params(0, cfg, device="cpu")
    template = {"params": ptrain._tree_map(torch.zeros_like, drawn),
                "ema": ptrain._tree_map(torch.zeros_like, drawn),
                "disc": pdisc.init_patchgan_params(2, pdisc.PatchGANConfig(n_layers=2),
                                                   device="cpu")}
    back = restore(make_manager(out), template)
    moved = [float((a - b).abs().max()) for a, b in zip(ptrain.tree_leaves(back["params"]),
                                                         ptrain.tree_leaves(drawn))]
    assert max(moved) > 0 and all(np.isfinite(moved))
    ema_moved = [float((a - b).abs().max()) for a, b in zip(ptrain.tree_leaves(back["ema"]),
                                                             ptrain.tree_leaves(drawn))]
    assert 0 < max(ema_moved) < max(moved)


def test_make_vq_train_step_reduces_recon(vq_np):
    """tests/test_vq_train.py's check, on the port's plain trainer."""
    cfg = port_cfg(False)
    params = vq_port(vq_np)
    init, step = ptrain.make_vq_train_step(cfg, ptrain.VQTrainConfig(learning_rate=3e-4))
    opt, ema = init(params)
    x = torch.from_numpy(pixels(0))
    recons = []
    for _ in range(8):
        params, opt, ema, aux = step(params, opt, ema, x)
        recons.append(float(aux["recon"]))
    assert np.isfinite(float(aux["loss"])) and recons[-1] < recons[0]
    assert 0.0 < float(aux["usage"]) <= 1.0
