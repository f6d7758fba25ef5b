"""Per-decode-step latency budget at the flagship configuration
(examples/latency_budget.py): Lumina-mGPT-7B, int4 W4A16 with the int8 head,
CFG batch 2, window 16, the int8 KV cache. Attributes one SJD decode step:

  weights_floor   every decode weight through the port's product (``linear``,
                  so K1 on CUDA) with one [32, .] activation, nothing else:
                  the weight-read floor
  fwd             the whole window forward (trunk and head): attention,
                  norms, RoPE, the KV write, logits
  fwd_half_layers the forward with half the layers (per-layer attribution)
  fwd_small_head  an 8192-row head (the head's read and logits)
  sampling        process_window_logits, the sample and speculative
                  acceptance on [2, 16, V] (grammar, CFG, top-k, accept)
  dispatch        the host's cost of replaying a one-kernel CUDA graph,
                  chained: what every probe above pays once per call, while
                  the engine pays it once per step
  engine_step     ms per forward inside ``generate`` (short runs at a low
                  and a high cache fill): forward + sampling + the engine's
                  bookkeeping + the host

Each component but engine_step is one CUDA graph, replayed (the three
forwards through ``eval/latency.decode_step_latencies`` at the engine's
buffer length). Prints one JSON object with the JAX script's keys. Run it
alone on the card:

    python -m sjd_tpu_torch.examples.latency_budget [--device cuda]

``BUDGET_WINDOW`` in the environment sets the window (default 16).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import resolve_device
from ..eval.latency import decode_step_latencies, seconds_per_call
from ..models.chameleon import IMAGE_START_ID, SIZE_TOKEN_BASE, lumina_engine
from ..models.transformer import QUANTIZED, init_params, layer_params, linear, quantize_leaf

ITERS = 30
# engine_step: (label, text tokens before the image header); each prompt's
# generate runs WARM_STEPS forwards once, then TIMED_STEPS timed
FILLS = (("lowfill", 50), ("highfill", 1200))
WARM_STEPS, TIMED_STEPS = 40, 200


def w4a16_params(seed: int, cfg, device):
    """Random weights (seed ``seed``) quantized leaf by leaf as drawn: packed
    int4 projections, an int8 head (the loader's ``quantize=4``)."""
    return init_params(seed, cfg, device=device, leaf_fn=lambda name, w: quantize_leaf(
        name, w, bits=4, head_bits=8))


def main(argv=None) -> None:
    from ..core import acceptance, grammar, processors, sampling

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    window = int(os.environ.get("BUDGET_WINDOW", "16"))
    eng = lumina_engine(target_size=768, window=window, guidance_scale=3.0, image_top_k=2000,
                        text_top_k=10, init="repeat_horizon", kv_quant=True,
                        max_len=48 * 49 + 5, device=dev)
    cfg = eng.model_cfg
    params = w4a16_params(0, cfg, dev)
    B, W = 2, window  # the CFG-doubled batch of one image
    out: dict = {}

    # ---- weights_floor: every decode weight read once, nothing else -------
    slices = [layer_params(params["layers"], i) for i in range(cfg.num_layers)]
    inputs: dict = {}

    def x_of(k_in):  # one constant activation per input width
        if k_in not in inputs:
            inputs[k_in] = torch.ones((B * W, k_in), dtype=cfg.dtype, device=dev)
        return inputs[k_in]

    def in_width(w):
        return w["q4p"].shape[-1] * 2 if "q4p" in w else w["q"].shape[-1]

    chain = [(x_of(in_width(lp[name])), lp[name]) for lp in slices for name in QUANTIZED]
    chain.append((x_of(cfg.hidden_size), params["lm_head"]))

    def weight_chain():
        for x, w in chain:
            linear(x, w)

    out["weights_floor_ms"] = seconds_per_call(weight_chain, dev, ITERS) * 1e3

    # ---- the window forward, at the engine's KV-buffer sizing ---------------
    buf_len = eng.config.resolved_buf_len(64) + window + 1
    buf_len = (buf_len + 511) // 512 * 512
    fwd = decode_step_latencies(
        cfg, params, batch=B, window=W, buf_len=buf_len, cache_fill=1200, iters=ITERS,
        variants={"fwd": {}, "fwd_half_layers": {"num_layers": cfg.num_layers // 2},
                  "fwd_small_head": {"vocab_size": 8192}},
        params_fn=lambda c: w4a16_params(1, c, dev), device=dev)
    out.update({f"{name}_ms": s * 1e3 for name, s in fwd.items()})

    # ---- sampling: grammar + CFG + top-k + acceptance ----------------------
    V = cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(2)
    i32 = dict(dtype=torch.int32, device=dev)
    gstate = grammar.GrammarState(
        in_image=torch.ones((1,), dtype=torch.bool, device=dev),
        size_known=torch.ones((1,), dtype=torch.bool, device=dev),
        h_lat=torch.full((1,), 48, **i32), w_lat=torch.full((1,), 48, **i32),
        img_count=torch.full((1,), 600, **i32), header_seen=torch.full((1,), 2, **i32))
    logits = torch.randn((B, W, V), generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(torch.rand((1, W, V), generator=gen, device=dev)))
    u = torch.rand((1, W - 1), generator=gen, device=dev)
    pred_pos = torch.arange(W, **i32)[None] + 653
    begin = torch.full((1,), 53, **i32)
    draft_tok = torch.full((1, W), 5, **i32)
    draft_probs = torch.full((1, W, V), 1.0 / V, device=dev)
    active_w = torch.full((1,), W, **i32)

    def samp():
        probs = processors.process_window_logits(
            logits, eng.spec, gstate, eng.sampling,
            force_no_cfg=torch.zeros((1,), dtype=torch.bool, device=dev),
            pred_pos=pred_pos, begin_pos=begin)
        y = sampling.sample_from_probs(gumbel, probs)
        return acceptance.speculative_accept(
            u, draft_tok, y, draft_probs, probs, active_w,
            lambda rl, row: torch.argmax(rl, -1).to(torch.int32))

    out["sampling_ms"] = seconds_per_call(samp, dev, ITERS) * 1e3

    # ---- the host's cost per replayed graph ---------------------------------
    x = torch.zeros((8, 128), device=dev)
    out["dispatch_ms"] = seconds_per_call(lambda: x.add_(1.0), dev, 2 * ITERS) * 1e3

    # ---- engine step (short generates) --------------------------------------
    # low fill: the cache fills from ~53 rows; high fill: a ~1200-token
    # prompt starts decoding near the mean fill of a 768px image
    size_tok = SIZE_TOKEN_BASE + 24
    for tag, text_len in FILLS:
        prompt = torch.tensor([[9000 + (i % 50) for i in range(text_len)]
                               + [IMAGE_START_ID, size_tok, size_tok]], **i32)
        eng.generate(params, 0, prompt, max_steps=WARM_STEPS)
        t0 = time.perf_counter()
        res = eng.generate(params, 1, prompt, max_steps=TIMED_STEPS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        out[f"engine_step_{tag}_ms"] = dt / int(res.nfe) * 1e3
        out[f"nfe_sampled_{tag}"] = int(res.nfe)
    out["config"] = {"model": "lumina-7B int4 W4A16 (int8 head)", "batch_cfg": B,
                     "window": W, "kv_quant": True, "head": "lm_head"}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
