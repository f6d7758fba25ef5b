"""VQGAN tokenizer training, the LlamaGen ``vq_train`` capability
(sjd_tpu/models/vq/train.py).

For the taming VQ of :mod:`.taming`:
  * the straight-through estimator through the quantizer;
  * reconstruction (L1/L2) plus codebook and commitment losses;
  * adversarial training (:func:`make_vqgan_train_steps`): alternating
    generator and discriminator steps with the PatchGAN
    (:mod:`.discriminator`) or StyleGAN (:mod:`.discriminator_stylegan`)
    discriminator, the LPIPS perceptual loss (:mod:`.lpips`), the hinge,
    vanilla and the reference's non-saturating losses, ``disc_start``
    gating and the optional adaptive generator weight;
  * an EMA of the generator's parameters.

Both optimizers are ``torch.optim.Adam(betas=(0.5, 0.9), eps=1e-8)`` with
no decay (optax's ``adam``: the same update), fused on CUDA. Both step
every call, as the JAX steps do: before ``disc_start`` the D loss is
multiplied by 0, and its Adam still counts the step. Each step takes its
gradients with ``torch.autograd.grad`` for its own leaves only, so the G
step leaves no gradient on D's parameters and the D step none on G's.

Precision: parameters and activations are f32, as in the JAX trainer. On
CUDA the convolutions run in cuDNN under PyTorch's defaults:
``torch.backends.cudnn.allow_tf32`` is True, so they multiply in TF32 and
accumulate in f32; the attention's and the codebook's products are
``torch.matmul``, which stays f32 (``torch.backends.cuda.matmul.allow_tf32``
is False by default). On an H100 at VQ-16's widths (a 64px pair) the
card's losses were within 6.4e-5 of the CPU's, relative, with TF32 off and
2.5e-3 with it on; its gradients within 2.3e-3 and 0.27 of each leaf's
largest magnitude, the worst at leaves whose gradient cancels to 1e-3 of
the largest (``PERF.md``, VQ training).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .discriminator import PatchGANConfig, init_patchgan_params, patchgan_logits
from .discriminator_stylegan import (
    StyleGANDiscConfig, init_stylegan_disc_params, stylegan_disc_logits)
from .lpips import lpips
from .taming import VQConfig, decode_latents, encode_latents

Tensor = torch.Tensor
PyTree = Any

# log1p(e^-1): the constant of the reference's swapped-argument BCE
_LOG1P_EM1 = 0.31326168751822286
_LOG2 = 0.6931471805599453


@dataclasses.dataclass(frozen=True)
class VQTrainConfig:
    learning_rate: float = 1e-4
    beta_commit: float = 0.25
    recon_weight: float = 1.0
    recon_loss: str = "l1"  # | "l2"
    gan_weight: float = 0.0  # > 0 enables make_vq_train_step's adversarial term
    ema_decay: float = 0.999
    # the full VQGAN options (the reference vq_train.py's defaults)
    perceptual_weight: float = 1.0
    disc_weight: float = 0.5
    disc_start: int = 20000
    disc_loss: str = "hinge"  # | "vanilla" | "non-saturating"
    gen_adv_loss: str = "hinge"  # | "non-saturating"
    disc_adaptive_weight: bool = False
    disc_lr: float = 1e-4


def tree_leaves(tree: PyTree) -> List[Tensor]:
    """The tensors of a nested dict/list tree, dict keys sorted (JAX's
    pytree order, whatever order a tree was built in)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree] if isinstance(tree, Tensor) else []


def _tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, Tensor) else tree


def _vq_forward(params: Dict, cfg: VQConfig, pixels: Tensor) -> Tuple[Tensor, Dict]:
    """encode -> quantize -> decode: (recon f32, parts) with the codebook
    and commitment losses, the batch's codebook usage and the ids [B, h*w]
    (the first index on a tie)."""
    z_e = encode_latents(params, cfg, pixels).float()
    cb = params["codebook"].float()
    if cfg.l2_norm_codebook:
        cbn = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        z_en = z_e / z_e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    else:
        cbn, z_en = cb, z_e
    flat = z_en.reshape(-1, cfg.embed_dim)
    d = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ cbn.t()
         + (cbn ** 2).sum(1)[None, :])
    ids = torch.argmin(d, dim=1)
    z_q = cbn[ids].reshape(z_en.shape)
    parts = {
        "codebook": ((z_q - z_en.detach()) ** 2).mean(),
        "commit": ((z_q.detach() - z_en) ** 2).mean(),
        "usage": (torch.bincount(ids, minlength=cfg.n_embed) > 0).float().mean(),
        "ids": ids.reshape(pixels.shape[0], -1),
    }
    z_st = z_en + (z_q - z_en).detach()  # straight-through
    return decode_latents(params, cfg, z_st).float(), parts


def _recon_loss(tcfg: VQTrainConfig, recon: Tensor, pixels: Tensor) -> Tensor:
    if tcfg.recon_loss == "l1":
        return (recon - pixels).abs().mean()
    return ((recon - pixels) ** 2).mean()


def vq_loss_fn(params: Dict, cfg: VQConfig, tcfg: VQTrainConfig, pixels: Tensor,
               disc_fn: Optional[Callable[[Tensor], Tensor]] = None) -> Tuple[Tensor, Dict]:
    """The plain trainer's loss: recon + codebook + beta * commit, plus
    ``gan_weight`` times ``-mean(disc_fn(recon))`` when both are given."""
    recon, parts = _vq_forward(params, cfg, pixels)
    rec_loss = _recon_loss(tcfg, recon, pixels)
    loss = tcfg.recon_weight * rec_loss + parts["codebook"] + tcfg.beta_commit * parts["commit"]
    aux = {"recon": rec_loss, "codebook": parts["codebook"], "commit": parts["commit"],
           "usage": parts["usage"]}
    if disc_fn is not None and tcfg.gan_weight > 0:
        g = -disc_fn(recon).mean()
        loss = loss + tcfg.gan_weight * g
        aux["gan_g"] = g
    aux["loss"] = loss
    return loss, aux


def hinge_d_loss(real_logits: Tensor, fake_logits: Tensor) -> Tensor:
    return 0.5 * (F.relu(1.0 - real_logits).mean() + F.relu(1.0 + fake_logits).mean())


def vanilla_d_loss(real_logits: Tensor, fake_logits: Tensor) -> Tensor:
    return 0.5 * (F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean())


def non_saturating_d_loss(real_logits: Tensor, fake_logits: Tensor) -> Tensor:
    """The reference's 'non-saturating' D loss, exactly: it passes
    BCE-with-logits its arguments swapped (the constant as the input, the
    logits as the target), so the real term is 1 - logits + log1p(e^-1) and
    the fake term the constant log 2: no gradient reaches the fake logits.
    The textbook loss is 'vanilla'."""
    real = (1.0 - real_logits + _LOG1P_EM1).mean()
    fake = _LOG2 + 0.0 * fake_logits.mean()
    return 0.5 * (real + fake)


def hinge_gen_loss(fake_logits: Tensor) -> Tensor:
    return -fake_logits.mean()


def non_saturating_gen_loss(fake_logits: Tensor) -> Tensor:
    """The reference's swapped-argument form: 1 - logits + log1p(e^-1),
    linear in the logits (hinge_gen_loss's gradient)."""
    return (1.0 - fake_logits + _LOG1P_EM1).mean()


_D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss,
             "non-saturating": non_saturating_d_loss}
_G_LOSSES = {"hinge": hinge_gen_loss, "non-saturating": non_saturating_gen_loss}
_DISCS = {"patchgan": (PatchGANConfig, init_patchgan_params, patchgan_logits),
          "stylegan": (StyleGANDiscConfig, init_stylegan_disc_params, stylegan_disc_logits)}


def disc_fns(disc_type: str = "patchgan", disc_cfg=None):
    """(config, init, logits) of the discriminator ``disc_type``; the
    config defaults to its class's."""
    cls, init, logits = _DISCS[disc_type]
    return disc_cfg or cls(), init, logits


def _disc_w(tcfg: VQTrainConfig, step, device) -> Tensor:
    return torch.tensor(tcfg.disc_weight if int(step) >= tcfg.disc_start else 0.0,
                        device=device)


def generator_loss(params: Dict, d_params: Dict, pixels: Tensor, step, cfg: VQConfig,
                   tcfg: VQTrainConfig, *, lpips_params: Optional[Dict] = None,
                   disc_type: str = "patchgan", disc_cfg=None) -> Tuple[Tensor, Dict]:
    """The G step's loss and aux, on one forward:
    recon + perceptual + codebook + beta * commit + disc_w * gen_adv(D(recon)),
    disc_w = disc_weight from ``disc_start`` on, else 0, times the adaptive
    weight ||d nll/d w|| / (||d adv/d w|| + 1e-4) on the decoder's last
    convolution w (clipped to [0, 1e4], detached) when
    ``disc_adaptive_weight`` is set, before ``disc_start`` too. The
    adaptive weight needs that leaf to require grad."""
    disc_cfg, _, disc_logits = disc_fns(disc_type, disc_cfg)
    recon, parts = _vq_forward(params, cfg, pixels)
    rec = _recon_loss(tcfg, recon, pixels)
    nll = tcfg.recon_weight * rec
    p_loss = torch.zeros((), device=pixels.device)
    if lpips_params is not None and tcfg.perceptual_weight > 0:
        p_loss = lpips(lpips_params, pixels, recon).mean()
        nll = nll + tcfg.perceptual_weight * p_loss
    adv = _G_LOSSES[tcfg.gen_adv_loss](disc_logits(d_params, recon, disc_cfg))
    disc_w = _disc_w(tcfg, step, pixels.device)
    if tcfg.disc_adaptive_weight:
        w_last = params["decoder"]["conv_out_w"]
        g_nll, = torch.autograd.grad(nll, w_last, retain_graph=True)
        g_adv, = torch.autograd.grad(adv, w_last, retain_graph=True)
        disc_w = disc_w * (g_nll.norm() / (g_adv.norm() + 1e-4)).clamp(0.0, 1e4).detach()
    loss = nll + parts["codebook"] + tcfg.beta_commit * parts["commit"] + disc_w * adv
    aux = {"loss": loss, "recon": rec, "perceptual": p_loss, "codebook": parts["codebook"],
           "commit": parts["commit"], "usage": parts["usage"], "gan_g": adv, "disc_w": disc_w}
    return loss, aux


def discriminator_loss(d_params: Dict, pixels: Tensor, recon: Tensor, step,
                       tcfg: VQTrainConfig, *, disc_type: str = "patchgan",
                       disc_cfg=None) -> Tuple[Tensor, Dict]:
    """The D step's loss, disc_w * d_loss(D(real), D(recon)), and aux. D runs
    twice, so each batch norms over its own statistics."""
    disc_cfg, _, disc_logits = disc_fns(disc_type, disc_cfg)
    lr_ = disc_logits(d_params, pixels, disc_cfg)
    lf_ = disc_logits(d_params, recon, disc_cfg)
    loss = _disc_w(tcfg, step, pixels.device) * _D_LOSSES[tcfg.disc_loss](lr_, lf_)
    return loss, {"d_loss": loss, "logits_real": lr_.mean(), "logits_fake": lf_.mean()}


def _adam(leaves: List[Tensor], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(leaves, lr=lr, betas=(0.5, 0.9), eps=1e-8,
                            fused=leaves[0].is_cuda)


def _apply(opt: torch.optim.Optimizer, loss: Tensor, leaves: List[Tensor]) -> None:
    """One optimizer step on the gradients of ``loss`` for ``leaves`` alone
    (a leaf the loss does not reach gets zeros, as under jax.grad). Each
    gradient takes its leaf's strides, as ``backward`` would give it: fused
    Adam refuses others (cuDNN's weight gradient of a 1x1 convolution may
    stride its unit dimensions differently)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p, g in zip(leaves, grads):
        if g is None:
            g = torch.zeros_like(p)
        elif g.stride() != p.stride():
            g = torch.empty_like(p).copy_(g)
        p.grad = g
    opt.step()
    for p in leaves:
        p.grad = None


@torch.no_grad()
def _ema_update(ema: Dict, params: Dict, decay: float) -> None:
    for e, p in zip(tree_leaves(ema), tree_leaves(params)):
        if e.dtype in (torch.float32, torch.bfloat16):
            e.copy_(e * decay + p.to(e.dtype) * (1 - decay))
        else:
            e.copy_(p)


def _trainable(tree: Dict) -> List[Tensor]:
    leaves = tree_leaves(tree)
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def _detached(aux: Dict) -> Dict:
    return {k: v.detach() for k, v in aux.items()}


def make_vqgan_train_steps(cfg: VQConfig, tcfg: VQTrainConfig,
                           lpips_params: Optional[Dict] = None, disc_cfg=None,
                           disc_type: str = "patchgan"):
    """Alternating generator and discriminator steps (the reference's
    VQLoss two-optimizer protocol). Returns (init_fn, g_step, d_step):

      init_fn(params, rng) -> (g_opt, d_params, d_opt, ema)
      g_step(params, g_opt, ema, d_params, pixels, step) -> (params, g_opt, ema, aux)
      d_step(d_params, d_opt, params, pixels, step) -> (d_params, d_opt, aux)

    ``rng`` seeds the discriminator's draw (an int or a ``torch.Generator``),
    on the device of ``params``. The steps update the trees and optimizers
    in place and return them. ``d_step`` runs the generator forward again
    with the parameters ``g_step`` returned, without a graph."""
    disc_cfg, init_disc, _ = disc_fns(disc_type, disc_cfg)
    kw = dict(disc_type=disc_type, disc_cfg=disc_cfg)

    def init_fn(params: Dict, rng):
        g_leaves = _trainable(params)
        d_params = init_disc(rng, disc_cfg, device=g_leaves[0].device)
        ema = _tree_map(lambda t: t.detach().clone(), params)
        return (_adam(g_leaves, tcfg.learning_rate), d_params,
                _adam(_trainable(d_params), tcfg.disc_lr), ema)

    def g_step(params, g_opt, ema, d_params, pixels, step):
        loss, aux = generator_loss(params, d_params, pixels, step, cfg, tcfg,
                                   lpips_params=lpips_params, **kw)
        _apply(g_opt, loss, tree_leaves(params))
        _ema_update(ema, params, tcfg.ema_decay)
        return params, g_opt, ema, _detached(aux)

    def d_step(d_params, d_opt, params, pixels, step):
        with torch.no_grad():
            recon, _ = _vq_forward(params, cfg, pixels)
        loss, aux = discriminator_loss(d_params, pixels, recon, step, tcfg, **kw)
        _apply(d_opt, loss, tree_leaves(d_params))
        return d_params, d_opt, _detached(aux)

    return init_fn, g_step, d_step


def make_vq_train_step(cfg: VQConfig, tcfg: VQTrainConfig, disc_fn=None):
    """The plain generator step over :func:`vq_loss_fn`; ``disc_fn`` (a
    frozen discriminator's logits) adds the adversarial term when
    ``gan_weight`` > 0. Returns (init, step): ``init(params) -> (opt, ema)``,
    ``step(params, opt, ema, pixels) -> (params, opt, ema, aux)``."""

    def init(params: Dict):
        return _adam(_trainable(params), tcfg.learning_rate), _tree_map(
            lambda t: t.detach().clone(), params)

    def step(params, opt, ema, pixels):
        loss, aux = vq_loss_fn(params, cfg, tcfg, pixels, disc_fn=disc_fn)
        _apply(opt, loss, tree_leaves(params))
        _ema_update(ema, params, tcfg.ema_decay)
        return params, opt, ema, _detached(aux)

    return init, step
