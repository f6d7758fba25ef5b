"""Smoke run of the PyTorch/CUDA port (sjd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (JSON where it carries numbers):

  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
               versions;
  2. build   - nvcc builds every kernel of sjd_tpu_torch/csrc into build/;
  3. kernels - each kernel against its plain PyTorch version at the main
               path's shapes, on the card: max abs difference against the
               stated tolerance, median time, the plain version's time, the
               least time the card could take (bound), and a one-call
               PyTorch yardstick where one exists;
  4. forward - a 2-layer decoder with 128-wide heads through the kernels
               against the plain path (the check of the composed forward);
  5. generate - Lumina-mGPT-7B at full width and depth (32 layers, d=4096,
               vocab 65536; bf16 random weights from a seed, int8 KV cache)
               generates one 768px image through load_lumina_mgpt(...)
               .sample_fn: prefill, SJD decode loop (window 16, CFG 3.0,
               speculative Jacobi) and VQ decode. The kernels' launch
               counters are set to 0 just before and read just after.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}. Any failed phase raises
and the script exits non-zero before that line; without CUDA it exits
non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor cores
F32_FLOPS = 67e12  # f32 outside the tensor cores
TARGET_SIZE = 768
KERNEL_NAMES = ("fused_epilogue", "decode_attention")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, *, reps: int = 20, trials: int = 11) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    the graph replayed ``trials`` times between CUDA events, the median
    replay over ``reps``. The graph takes the host's launch path out of the
    number; :func:`eager_ms` keeps it in."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def eager_ms(fn, *, reps: int = 20, trials: int = 11) -> float:
    """Time of one call issued from Python back to back (host launch path
    included), median over ``trials`` batches of ``reps``, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], count=torch.cuda.device_count())
    return smi.splitlines()[0]


def phase_build():
    from sjd_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build_all(KERNEL_NAMES)
    for name in KERNEL_NAMES:
        _build.load(name)
    usage = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", seconds=round(time.time() - t0, 3), built=sorted(logs),
         dir=str(_build.BUILD_DIR), ptxas=usage)


def phase_epilogue(dev):
    import torch

    from sjd_tpu_torch.ops.fused_epilogue import (
        fused_epilogue_into_cache, fused_epilogue_into_cache_plain)

    S, T, H, Hkv, D, NL, L, layer = 2, 16, 32, 32, 128, 32, 2560, 17
    ends = (1200, 37)
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    qp, kp, vp = (r(S, T, n * D).to(torch.bfloat16) for n in (H, Hkv, Hkv))
    norms = ((1 + 0.1 * r(H, D)).to(torch.bfloat16), (0.1 * r(H, D)).to(torch.bfloat16),
             (1 + 0.1 * r(Hkv, D)).to(torch.bfloat16), (0.1 * r(Hkv, D)).to(torch.bfloat16))
    ang = 3 * torch.rand((S, T, D), generator=g, device=dev)
    cache_end = torch.tensor(ends, dtype=torch.int32, device=dev)
    # sentinels the kernel never writes: code -128, scale -1
    sentinel = [torch.full((S, NL, L, Hkv, D), -128, dtype=torch.int8, device=dev),
                torch.full((S, NL, L, Hkv), -1.0, dtype=torch.bfloat16, device=dev)]
    caches = {who: [sentinel[0].clone(), sentinel[0].clone(), sentinel[1].clone(),
                    sentinel[1].clone()] for who in ("kernel", "plain")}
    args = (qp, kp, vp, *norms, ang.cos().contiguous(), ang.sin().contiguous())
    kw = dict(layer=layer, num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=True)
    call = lambda: fused_epilogue_into_cache(*args, *caches["kernel"], cache_end, **kw)  # noqa: E731
    plain = lambda: fused_epilogue_into_cache_plain(  # noqa: E731
        *args, *caches["plain"], cache_end, **kw)
    q, q_want = call(), plain()
    torch.cuda.synchronize()
    # the whole caches: window rows within tolerance of the plain version,
    # every other row still the sentinel
    win = [(s, layer, slice(e, e + T)) for s, e in enumerate(ends)]
    errs = {"q": (q.float() - q_want.float()).abs().max().item()}
    peaks, untouched = {}, True
    for name, got, want, sent in zip(("k_code", "v_code", "k_scale", "v_scale"),
                                     caches["kernel"], caches["plain"],
                                     sentinel[:1] * 2 + sentinel[1:] * 2):
        gw = torch.stack([got[i] for i in win]).float()
        ww = torch.stack([want[i] for i in win]).float()
        errs[name] = (gw - ww).abs().max().item()
        peaks[name] = ww.abs().max().item()
        rest = got.clone()
        for i in win:
            rest[i] = sent[i]
        untouched = untouched and torch.equal(rest, sent)
    # tolerance: one bf16 rounding of q at its largest magnitude, one int8
    # step for K/V codes, one bf16 rounding of the scales
    tol_q = 2 ** -7 * q_want.float().abs().max().item()
    tol_s = 2 ** -7 * max(peaks["k_scale"], peaks["v_scale"])
    ok = (errs["q"] <= tol_q and max(errs["k_code"], errs["v_code"]) <= 1
          and max(errs["k_scale"], errs["v_scale"]) <= tol_s and untouched)
    ms = time_ms(call)
    call_ms = eager_ms(call)
    plain_ms = time_ms(plain)
    # each input read once, each output written once: the window's K/V
    # codes and scales go straight into the cache, nothing is read back
    n_in = (2 * S * T * (H + 2 * Hkv) * D + 2 * 2 * (H + Hkv) * D + 2 * 4 * S * T * D
            + 4 * S)
    n_out = 2 * S * T * H * D + 2 * S * T * Hkv * D + 2 * 2 * S * T * Hkv
    # per element: ~8 norm ops (q, k), 3 rope ops (q, k), ~4 quantize ops (k, v)
    n_ops = S * T * D * (11 * (H + Hkv) + 4 * 2 * Hkv)
    b_ms, b_by = bound_ms(n_in + n_out, n_ops, F32_FLOPS)
    emit("kernel", name="fused_epilogue",
         shape=dict(S=S, T=T, H=H, Hkv=Hkv, D=D, NL=NL, L=L, layer=layer, cache_end=ends),
         max_abs_err=errs, tolerance=dict(q=tol_q, codes=1, scales=tol_s),
         other_rows_unchanged=untouched, ok=ok, ms=ms, eager_ms=call_ms, plain_ms=plain_ms,
         bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms, bytes=n_in + n_out)
    check(ok, "fused_epilogue disagrees with its plain version, or wrote outside "
              "the window")
    return dict(name="fused_epilogue", route="cuda", source="sjd_tpu_torch/csrc/fused_epilogue.cu",
                replaces="sjd_tpu/ops/fused_epilogue.py:35", max_abs_err=max(errs.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase_attention(dev):
    import torch
    import torch.nn.functional as F

    from sjd_tpu_torch.ops.decode_attention import (
        _entry, decode_attention, decode_attention_plain, decode_masks)
    from sjd_tpu_torch.ops.fused_epilogue import quantize_rows

    S, W, H, Hkv, D, NL, L = 2, 16, 32, 32, 128, 32, 2560
    P, layer = 15, 17
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((S, W, H, D), generator=g, device=dev).to(torch.bfloat16)
    caches = {}
    kq, ks = quantize_rows(torch.randn((S, NL, L, Hkv, D), generator=g, device=dev))
    vq, vs = quantize_rows(torch.randn((S, NL, L, Hkv, D), generator=g, device=dev))
    caches["int8"] = (kq, vq, ks, vs)
    kb = (kq[:, layer:layer + 1].float() * ks[:, layer:layer + 1, ..., None].float())
    vb = (vq[:, layer:layer + 1].float() * vs[:, layer:layer + 1, ..., None].float())
    # the bf16 cache: one live layer (the dequantized one) in a zero stack
    kbf = torch.zeros((S, NL, L, Hkv, D), dtype=torch.bfloat16, device=dev)
    vbf = torch.zeros_like(kbf)
    kbf[:, layer], vbf[:, layer] = kb[:, 0].to(torch.bfloat16), vb[:, 0].to(torch.bfloat16)
    caches["bf16"] = (kbf, vbf, None, None)
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    valid[1, :P - 1] = False  # the CFG uncond half masks its prompt rows
    results, worst = [], 0.0
    for kind, (k, v, kscale, vscale) in caches.items():
        for fill in (150, 1200, 2400, L - W):
            cache_end = torch.full((S,), fill, dtype=torch.int32, device=dev)
            call = lambda: decode_attention(q, k, v, kscale, vscale, cache_end,  # noqa: E731
                                            valid, window=W, layer=layer)
            got = call()
            want = decode_attention_plain(q, k, v, kscale, vscale, cache_end, valid,
                                          layer=layer)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            # tolerance: one bf16 rounding of the output at its largest
            # magnitude plus f32 reassociation
            tol = 2 ** -7 * want.float().abs().max().item() + 1e-3
            ok = bool(torch.isfinite(got.float()).all()) and err <= tol
            worst = max(worst, err)
            ms = time_ms(call)
            call_ms = eager_ms(call)
            plain_ms = time_ms(lambda: decode_attention_plain(
                q, k, v, kscale, vscale, cache_end, valid, layer=layer), reps=3, trials=5)
            # the yardstick: SDPA over the dequantized bf16 layer, same mask
            qs = q.transpose(1, 2)
            kd = kbf[:, layer].transpose(1, 2)
            vd = vbf[:, layer].transpose(1, 2)
            mask = decode_masks(cache_end, valid, W, L)[:, None]
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask))
            rows = S * min(fill + W, L)
            kv_bytes = 1 if kind == "int8" else 2
            n_bytes = (2 * rows * Hkv * D * kv_bytes + (2 * rows * Hkv * 2 if kscale is not None
                                                       else 0)
                       + 2 * 2 * S * W * H * D + S * L + 4 * S)
            n_ops = 4 * S * W * H * D * min(fill + W, L)
            b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
            # the grid covers every split of the buffer; blocks of dead
            # splits return at once
            split_rows = _entry()[1]
            splits = math.ceil(L / split_rows)
            live_blocks = math.ceil(W * H // Hkv / 16) * Hkv * S * math.ceil(
                min(fill + W, L) / split_rows)
            row = dict(name="decode_attention", cache=kind, fill=fill,
                       shape=dict(S=S, W=W, H=H, Hkv=Hkv, D=D, NL=NL, L=L, layer=layer),
                       max_abs_err=err, tolerance=tol, ok=ok, ms=ms, eager_ms=call_ms,
                       plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                       splits=splits, live_blocks=live_blocks, bound_share=b_ms / ms)
            emit("kernel", **row)
            check(ok, f"decode_attention ({kind} cache, fill {fill}) disagrees with "
                      "its plain version")
            results.append(row)
    main = next(r for r in results if r["cache"] == "int8" and r["fill"] == 1200)
    return dict(name="decode_attention", route="cuda",
                source="sjd_tpu_torch/csrc/decode_attention.cu",
                replaces="sjd_tpu/ops/decode_attention.py:38", max_abs_err=worst,
                ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"])


def phase_forward(dev):
    import dataclasses

    import torch

    from sjd_tpu_torch.models import transformer as pt

    cfg = pt.DecoderConfig(vocab_size=65536, hidden_size=512, intermediate_size=1024,
                           num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                           qk_norm=True, kv_quant=True, max_position_embeddings=512)
    params = pt.init_params(0, cfg, device=dev)
    rope = pt.make_rope_table(cfg, 512, device=dev)
    S, P, W, L = 2, 15, 16, 512
    gen = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(0, 65536, (S, P + W), generator=gen, device=dev)
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    valid[1, :P - 1] = False
    pos = torch.clamp_min(torch.cumsum(valid[:, :P].int(), 1) - 1, 0)
    pos_w = pos[:, -1:] + 1 + torch.arange(W, device=dev)
    logits = []
    with torch.no_grad():
        for c in (cfg, dataclasses.replace(cfg, attn_impl="plain")):
            kv = pt.init_kv_cache(c, S, L, device=dev)
            zero = torch.zeros((S,), dtype=torch.int32, device=dev)
            pt.forward(params, c, ids[:, :P], pos, kv, zero, valid, rope)
            logits.append(pt.forward(params, c, ids[:, P:], pos_w, kv, zero + P, valid,
                                     rope).logits)
    err = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    # tolerance: bf16 activations round at other points once the attention
    # sums in another order; 5% of the largest logit
    ok = math.isfinite(err) and err <= 0.05 * scale
    emit("forward", layers=cfg.num_layers, head_dim=cfg.head_dim, max_abs_err=err,
         max_abs_logit=scale, tolerance=0.05 * scale, ok=ok)
    check(ok, "kernel forward disagrees with the plain forward")


def phase_generate(dev):
    import torch

    from sjd_tpu_torch.data.item_processor import split_generation
    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.ops.decode_attention import decode_attention
    from sjd_tpu_torch.ops.fused_epilogue import fused_epilogue_into_cache, write_kv_layer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = load_lumina_mgpt(target_size=TARGET_SIZE, device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    cfg = model.engine.model_cfg
    check((cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.kv_quant)
          == (32, 4096, 65536, True), f"not the 7B config: {cfg}")

    fused_epilogue_into_cache.launches = 0
    decode_attention.launches = 0
    write_kv_layer.calls = 0
    t0 = time.time()
    img = model.sample_fn("a photo of a red fox in the snow", 0)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = {"fused_epilogue": fused_epilogue_into_cache.launches,
                "decode_attention": decode_attention.launches}
    kv_writes = write_kv_layer.calls

    res = model.extras["last_result"]
    toks = res.tokens[0, : int(res.length[0])].tolist()
    t0 = time.time()
    again = model.extras["decode_image_fn"](toks)
    torch.cuda.synchronize()
    vq_s = time.time() - t0
    nfe = int(res.nfe)
    spans = [s for kind, s in split_generation(toks) if kind == "image"]
    emit("generate", target_size=TARGET_SIZE, layers=cfg.num_layers,
         hidden=cfg.hidden_size, vocab=cfg.vocab_size, window=model.engine.config.window,
         tokens_generated=int(res.gen_count[0]), nfe=nfe,
         accept_hist=res.accept_hist.tolist(), wall_s=wall_s, vq_decode_s=vq_s,
         ms_per_forward=1e3 * (wall_s - vq_s) / nfe, load_s=load_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         image_shape=list(img.shape), image_dtype=str(img.dtype),
         image_tokens=len(spans[-1]) if spans else 0, launches=launches,
         launches_expected=cfg.num_layers * nfe, write_kv_layer_calls=kv_writes,
         smoke_reasons=model.extras["smoke_reasons"])
    check(tuple(img.shape) == (TARGET_SIZE, TARGET_SIZE, 3) and str(img.dtype) == "uint8",
          f"image is {img.shape} {img.dtype}")
    check((img == again).all(), "a second VQ decode of the same tokens differs")
    for name, n in launches.items():
        # every forward here has T <= 32 (a 15-token prompt, then windows of
        # 16), so each layer of each forward launches each kernel once
        check(n > 0, f"{name} was never launched on the main path")
        check(n == cfg.num_layers * nfe, f"{name}: {n} launches for {nfe} forwards")
    # the epilogue kernel writes the window's K/V rows itself
    check(kv_writes == 0, f"write_kv_layer ran {kv_writes} times on the kernel path")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import sjd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the sjd_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    smi = phase_device()
    phase_build()
    kernels = [phase_epilogue(dev), phase_attention(dev)]
    phase_forward(dev)
    launches = phase_generate(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit("done", seconds=time.time() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
