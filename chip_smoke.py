"""Smoke run of the PyTorch/CUDA port (sjd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (JSON where it carries numbers):

  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
               versions;
  2. build   - nvcc builds every kernel of sjd_tpu_torch/csrc into build/;
  3. kernels - each kernel against its plain PyTorch version at the shapes
               of both paths that run it (generate: S = 2; serve: S = 4, a
               left-padded prompt bucket, per-slot fills), on the card: max
               abs difference against the stated tolerance, median time,
               the plain version's time, the least time the card could
               take (bound), and a one-call PyTorch yardstick where one
               exists;
  4. forward - a 2-layer decoder with 128-wide heads through the kernels
               against the plain path (the check of the composed forward);
  5. load    - Lumina-mGPT-7B at full width and depth (32 layers, d=4096,
               vocab 65536; bf16 random weights from a seed, int8 KV cache)
               through load_lumina_mgpt; the phases below share its weights;
  6. graph   - 32 decode steps of the 7B at 768px run eagerly
               (cuda_graph=False) and 32 replayed from the captured step,
               from the same seed: tokens, lengths, accept_hist and every
               byte of the KV cache must be equal; ms per forward of both;
               each kernel's launches 32 per forward on both engines; then
               two replays under torch.profiler, which must show each
               kernel run 32 times per replay on the device;
  7. generate - one 768px image through load_lumina_mgpt(...).sample_fn on
               the graph path: prefill, SJD decode loop (window 16, CFG 3.0,
               speculative Jacobi) and VQ decode;
  8. serve   - ContinuousBatcher: 3 requests at 512px through 2 slots with
               per-request seeds, chunks of 64 steps; each result decodes
               to an image, a refill happens while a request is live, and
               that request's tokens equal those of an eager run with the
               same companion and no refill;
  9. widths_bf16 - one request through ContinuousBatcher at batch widths 1,
               2 and 5 (256px): whether its tokens change, reported;

and the quantized weights (csrc/quant_linear.cu):

  3b. quant_kernels - K1 (W4A16/W8A16) and K2 (W4A8/W8A8) against their
               plain versions at the 7B's four weight shapes and the rows
               of a generate window (32), a serve window (64) and a prefill
               (30), with their times, bounds and library yardsticks, the
               block's weight rows, the splits and blocks per launch; the
               profiler must see each call run one kernel on the device;
  4b. quant_forward - phase 4's decoder on W4A16 and W4A8 weights;
  10. quant_serve - W4A8 with the int8 embedding, quantized on the card from
               phase 5's bf16 weights: phase 6's check (32 replayed steps
               bit-equal to 32 eager ones, launches, profile);
  11. quant_load, quant_graph, quant_generate - load_lumina_mgpt(quantize=4)
               (W4A16, int8 head), phase 6's check and one 768px image,
               with the weights' bytes at rest and peak memory;
  12. widths_w4a16 - phase 9 on W4A16 weights, held: the tokens must not
               change with the width.

and checkpoints from disk, image prompts, streaming and the 34B:

  13. ckpt    - Lumina-mGPT-7B written as 3 safetensors shards at full width
               and depth (seeded random bf16 weights, HF names, qk-norm in
               the [mp, D] layout) and the full Chameleon VQGAN as a
               "state_dict"-nested .ckpt, under build/ (removed after),
               then read by load_lumina_mgpt(ckpt_dir=, vq_ckpt=,
               tokenizer=) with a duck-typed IMGIMG tokenizer: no fallback,
               both trees on the card bit-equal to the written ones; bytes,
               write and load seconds (warm page cache), host RSS peak
               during the load, peak device memory;
  14. ckpt_load_w4a16, ckpt_generate - the same files with quantize=4
               (equilibrated W4A16, int8 head), one 768px image as in 7;
  15. image_input - a 512 x 512 array through the VQ encoder on the card
               into a FlexAR block (header against grid and a direct
               encode; codebook rows encode to their own ids), then
               sample_i2i_fn to a 768px image;
  16. stream  - StreamingBatcher on that model: 3 slots, chunks of 64, 6
               requests at 256px from 2 threads at staggered times, one
               prompt left-padded; each equal to its solo run;
  17. chameleon_34b - the 34B at W4A16 on random weights: both TPU kernels
               at its shapes (64 query heads over 8 KV heads, 48 layers,
               int8 cache, fills 150 and 2400), then phase 6's check of 32
               replayed steps at 768px.

and Emu3-Gen 8B at 720px and Anole-7B:

  3c. epilogue_emu3, attention_emu3 - the epilogue with no qk-norm and
               the attention at GQA group 4 over the 720px image's
               8704-row int8 buffer (fills 150, 4000, 8190), and K1 at
               Emu3's weight shapes (in quant_kernels), each against its
               plain version;
  18. emu3_load - load_emu3(quantize=4): the 8B at full width and depth on
               random weights drawn a layer at a time (int4 projections,
               int8 head), the full random Emu3VisionVQ, a duck tokenizer;
  19. emu3_forward, emu3_graph - the kernel forward within 5% of the plain
               one (W4A16 at full depth; bf16 cut to 2 layers), and phase
               6's check of 32 replayed steps with the negative prompt;
  20. emu3_generate - one 720px image (90 x 90 grid, CFG 3.0 against the
               negative prompt, window 16, repeat_horizon drafts): the
               image, the grammar's offsets, the launches per forward;
  21. emu3_understand - understand_fn once: the 8318-row prompt bucket
               prefilled on the plain path in blocks of query rows;
  22. anole  - load_anole(quantize=4): one image-only 512px image (1024
               tokens and <eoi>) with its launches per forward, a short
               interleaved run, encode_image_fn against a direct encode.
  (Emu3 and Anole pass kv_quant=True: their loaders' default cache is
  bf16, as the JAX loaders'; 3c times the bf16 attention too.)

and LlamaGen GPT-XL (20 heads of 64, 36 layers, 2-D RoPE, bf16 cache):

  3d. epilogue_llamagen, attention_llamagen - both TPU kernels at GPT-XL's
               shapes over the 512px image's 1536-row buffer, bf16 and int8,
               the cos/sin rows from the 2-D table, the caption's left
               padding masked (attention fills 150, 600 and 1140);
  23. llamagen_load - load_llamagen(name="GPT-XL", model_type="t2i",
               latent_size=32): random GPT, caption embedder and VQ-16, and
               a random T5 encoder at flan-t5-xl's widths (f32) behind a stub
               tokenizer; the caption's T5 encode time;
  24. llamagen_forward, llamagen_graph - the kernel forward within 5% of the
               plain one at full depth, and phase 6's check of 32 replayed
               steps from the caption's embeddings;
  25. llamagen_t2i - one 512px image (CFG 7.5, window 16, top-k 1000): 1024
               image tokens, 36 launches of each TPU kernel per decode
               forward (the 120-row prefill takes the plain path);
  26. llamagen_bench - bench.py:bench_llamagen's row: 256px t2i from
               stand-in T5 features, SJD and AR (window 1) on the same card;
  27. llamagen_stream - StreamingBatcher in embedding mode: 3 captions
               through 2 slots at 256px on W4A16 weights, each equal to its
               solo run, one capture for the whole stream;
  28. llamagen_c2i - load_llamagen(model_type="c2i", quantize=4): the W4A16
               kernel forward (K1 at d 1280) within 5%, one image of class
               207 at 256px with every kernel's launches per forward.

and the decode options, and LlamaGen GPT-3B (32 heads of 100, 24 layers):

  9b. ar_fast_path - lumina_engine(ar_fast_path=True) on the bf16 7B at
               768px against the default engine, in turns (wide, fast,
               fast, wide) from the same seed: the replays of each graph,
               the ms per forward of each width, the whole-image seconds,
               the count of equal tokens;
  9c. decompose - sequential_decompose on one window of the 7B's logits,
               24 steps into the image, against a per-token loop of
               apply_grammar_single + update_state;
  12b. ar_fast_path_w4a16 - 9b on the W4A16 7B at 256px, greedy, once
               each: the tokens, NFE and accept_hist held equal;
  21b. emu3_understand_chunked - phase 21's 8318-row prefill with and
               without attn_buckets=512: seconds, peak memory, the first
               answer logits within 5% of the unchunked run's;
  3e. epilogue_llamagen_3b, attention_llamagen_3b - both TPU kernels at
               GPT-3B's shapes over the 384px c2i image's 1024-row buffer,
               bf16 and int8 (attention fills 150, 400, 600);
  29. llamagen_3b_load, llamagen_3b_graph - load_llamagen(name="GPT-3B",
               latent_size=24, model_type="c2i") at full width and depth on
               random bf16 weights, and phase 6's check of 32 replayed
               steps from the class embedding;
  30. llamagen_3b_c2i - one class-207 image at 384px: 576 tokens, each TPU
               kernel 24 times per forward;
  31. llamagen_3b_options - the same with init="sample_horizon" and
               top_p=0.95.

and evaluation (sjd_tpu_torch/eval), its files under build/chip_smoke_eval/
(removed at the end):

  9d. eval_latency - decode_step_latencies on the bf16 7B (batch 2, window
               16, a 2500-row cache filled to 1200): full, half_layers and
               small_head, each captured once and replayed, with each TPU
               kernel's launches per forward (32, 16, 32);
  9e. eval_harness_tokens - a 4-row Parti-layout TSV split into 2 workers:
               one shard through run_prompt_set(sample_fn), the other
               through run_prompt_set_batched (2 slots) at 768px, then both
               again (every image skipped); images per minute of each;
  31b. eval_harness_embeds - 4 class ids through run_prompt_set_batched on
               GPT-3B in embedding mode at 384px;
  32. eval_scores - FID and IS (random InceptionV3 in torchvision's layout)
               and CLIPScore (random ViT-B/32 at full width) on those
               images: each tower on the card against the CPU, and its
               time; the values are no quality figures;
  33. eval_cli - python -m sjd_tpu_torch.eval.eval_model (W4A16 7B, 512px,
               2 slots, FID) and python -m sjd_tpu_torch.eval.recon_eval
               (chameleon at 512px, VQ-16 at 256px) as processes, started
               together, that must exit 0 with the JAX scripts' JSON keys.

and fine-tuning (sjd_tpu_torch/parallel, the data path, utils/checkpoints),
its files under build/chip_smoke_train/ (removed at the end), with every
earlier model freed (under 1 GB allocated before train_7b):

  34. train_data - 4 seeded 768px images through the taming encoder at full
               width, pre-tokenized with 4 captions (run_pretokenize,
               splits=2, both ranks; concat_records), read back through
               FinetuneDataset and LengthClusteredSampler(batch_size=1,
               grad_accum=2): 2369-token records;
  35. train_7b - Chameleon-7B at full width and depth (bf16 parameters and
               moments) through make_train_step on the 1 x 1 mesh, lr 1e-3,
               grad_accum 2: 4 calls, 2 optimizer steps; the parameters
               bit-equal to the initial ones after calls 1-3 and moved
               after call 4; seconds per call, tokens per second, the
               model-FLOP share, peak memory;
  36. train_serve - the trained 7B: 256 rows prefilled by transformer.forward,
               then a 16-token window through both TPU kernels (32 launches
               of each), against forward_train's logits;
  37. train_ckpt - 2 layers at the 7B's widths: save mid-accumulation, a
               fresh state restored and run on, bit-equal to the
               uninterrupted run; max_keep prunes;
  38. train_cli - python -m sjd_tpu_torch.parallel.finetune (tiny model,
               20 steps) as a process, then resumed to 30.

and VQGAN tokenizer training (sjd_tpu_torch/models/vq: train, lpips, the
two discriminators, vq_train; no kernel lies on it, and each training phase
holds the kernels' launch counts at 0), under build/chip_smoke_vq/ (removed
at the end):

  38b. vq_train - LlamaGen VQ-16 at full width (f32) at 256px, batch 8,
               with random VGG16 LPIPS and PatchGAN (n_layers 3, ndf 64), the
               adaptive weight and hinge, as the command line builds them:
               1 warm-up and 5 timed G/D pairs with cuDNN's TF32 on (the
               default): G and D seconds, images per second, peak memory,
               FLOPs per pair, losses and usage; the EMA and D move;
  38c. vq_train_stylegan - the same with the StyleGAN discriminator at
               image_size 256, 2 timed pairs;
  38d. vq_train_card_cpu - a 64px, batch-2 pair's losses and gradients on
               the card (TF32 off, held; TF32 on, reported) against the CPU;
  38e. vq_train_cli - python -m sjd_tpu_torch.models.vq.vq_train twice as
               processes (--synthetic, and --images over PNGs written by
               write_png), 4 steps at 64px: the JAX script's JSON keys, the
               checkpoint restored.

and tensor- and data-parallel decoding (sjd_tpu_torch/parallel: shard_params,
decode_attention_tp, the TP forward, row_sharding), two ranks spawned on the
one card over gloo (NCCL refuses two ranks on one device), every earlier
model freed; the unsharded references are computed in this process while
phases 5 and 11 hold their models, under build/chip_smoke_tp/ (removed at
the end):

  3f. kernels_tp - both TPU kernels at one rank's local shapes under TP=2:
               the 7B's 16 of 32 heads (int8 cache of the 512px image) and
               the 34B's 32 query heads over 4 KV heads (bf16, S = 1, W = 4);
  39. tp_collectives - the gloo round trip of the 7B's all-reduce and of
               its logits' all-gather, on the card's tensors;
  40. tp_window - the 7B on a 1 x 2 mesh, bf16 and W4A16, each rank its
               shard (shard_params): the prompt prefilled, one 16-token
               window; each rank's logits within 5% of the largest
               unsharded logit and the argmax equal at 14 of 16 positions,
               the ranks bit-equal, each TPU kernel 32 launches per rank in
               the window's forward (and K1 225 on W4A16);
  41. tp_generate - one 512px image on the bf16 shards cut to their first 2
               layers (each layer costs two gloo round trips per forward),
               cuda_graph=False: the ranks' tokens equal, 1024 image tokens,
               the image decoded on rank 0, 2 launches of each TPU kernel
               per forward per rank; NFE, ms per forward, wall and the
               summed peak memory;
  42. tp_34b - python -m torch.distributed.run --nproc-per-node 2 -m
               sjd_tpu_torch.parallel.tp_decode --layers 24 --backend gloo
               --max-len 64 (Chameleon-34B's full width at 24 of 48 layers:
               both ranks on one card): exit 0, grammar_ok, the ranks'
               tokens equal, 24 launches of each TPU kernel per forward;
  43. dp_serve - the W4A16 7B on a 2 x 1 mesh, each data rank its own graph
               engine: 6 requests at 256px through 4 slots with
               ContinuousBatcher(row_sharding=mesh), completions and refills
               on every rank equal to the one-process batcher's.

and the user-facing entry points (sjd_tpu_torch/examples), under
build/chip_smoke_cli/ (removed at the end):

  44. demo_server - the demo server in-process on the W4A16 7B at 256px
               (a tokenizer, the bf16 VQ): --slots 2 over StreamingBatcher,
               3 concurrent /generate requests each equal to its solo run,
               /health, the page, i2i refused; then --slots 1 answering
               /generate_i2i with a 500 x 400 PNG (fitted without PIL) and
               /freeform, and refusing a JPEG while PIL cannot be imported;
  45. cli_generate - generate_lumina_mgpt (768px W4A16, 2 repeats),
               generate_emu3 (8B, 256 x 256), generate_llamagen (GPT-XL
               c2i), generate_image2image (512px) and quant_fidelity (8
               layers at the 7B's widths), started together as processes:
               exit 0, images of the stated shapes, the JAX keys and KL
               int8 <= int4_equil < int4_raw;
  46. cli_demo_server - python -m sjd_tpu_torch.examples.demo_server with
               its defaults (GPT-B): its start-up line (0 nvcc builds, the
               libraries loaded from build/, one capture), /health and one
               /generate, then terminated;
  47. latency_budget - the W4A16 7B decode step split into the JAX
               script's components, alone on the card;
  48. hbm_bw_probe - the read ceiling against K1's rate (JAX keys), no
               rate above 105% of the spec sheet's 3350 GB/s.

Each of the paths 6-8, 9b, 9e, 10-11, 12b, 14-17, 19-22, 24-31, 31b, 36, 40-43 and 44 starts from kernel launch counts of 0 and
reads them just after. A wrapper counts a launch when Python calls it, so a
capture counts the launches it records and a replay none; the launches that
ran are the counters minus the capture's records plus each replay's
(GraphStats.executed, which each graph check's profile holds to the
device's trace). They must be per_forward()'s per forward with T <= 32: one of each TPU
kernel per layer (32 on the 7B, 48 on the 34B), and on quantized weights
7 quantized products per layer and the head (225 on the 7B, 337 on the
34B), each one launch of quant_linear_kernel: the profile must show no
reduce_splits_kernel. A prefill over 32 tokens (image_input's) takes the
plain path, with the quantized products still on the kernel.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}. Any failed phase raises
and the script exits non-zero before that line; without CUDA it exits
non-zero at once.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor cores
INT8_TENSOR_OPS = 1979e12  # dense int8 tensor cores
F32_FLOPS = 67e12  # f32 outside the tensor cores
TARGET_SIZE = 768
SOURCES = ("fused_epilogue", "decode_attention", "quant_linear")  # csrc/<name>.cu


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
    logs = _build.build_all(SOURCES)
    for name in SOURCES:
        _build.load(name)
    usage = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", seconds=round(time.time() - t0, 3), built=sorted(logs),
         dir=str(_build.BUILD_DIR), ptxas=usage)


def _epilogue_case(dev, case: str, S: int, L: int, ends, seed: int, H: int = 32,
                   Hkv: int = 32, NL: int = 32, layer: int = 17, qk_norm: bool = True,
                   D: int = 128, quantize: bool = True, rope=None, T: int = 16):
    """``fused_epilogue_into_cache`` against its plain version over a whole
    ``NL``-layer cache (int8 with scales, or bf16 without ``quantize``)
    filled with sentinels, at ``S`` rows and per-row fills ``ends``, with or
    without the qk LayerNorm, on random angles or on ``rope``'s (cos, sin)
    rows: the window's rows within tolerance, every other row unchanged.
    Times both; returns the case's row."""
    import torch

    from sjd_tpu_torch.ops.fused_epilogue import (
        fused_epilogue_into_cache, fused_epilogue_into_cache_plain)

    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    qp, kp, vp = (r(S, T, n * D).to(torch.bfloat16) for n in (H, Hkv, Hkv))
    norms = ((1 + 0.1 * r(H, D)).to(torch.bfloat16), (0.1 * r(H, D)).to(torch.bfloat16),
             (1 + 0.1 * r(Hkv, D)).to(torch.bfloat16), (0.1 * r(Hkv, D)).to(torch.bfloat16))
    ang = 3 * torch.rand((S, T, D), generator=g, device=dev)
    cos, sin = (ang.cos().contiguous(), ang.sin().contiguous()) if rope is None else rope
    cache_end = torch.tensor(ends, dtype=torch.int32, device=dev)
    # sentinels the kernel never writes: code -128 and scale -1, or -3.0
    if quantize:
        sentinel = [torch.full((S, NL, L, Hkv, D), -128, dtype=torch.int8, device=dev),
                    torch.full((S, NL, L, Hkv), -1.0, dtype=torch.bfloat16, device=dev)]
        caches = {who: [sentinel[0].clone(), sentinel[0].clone(), sentinel[1].clone(),
                        sentinel[1].clone()] for who in ("kernel", "plain")}
    else:
        sentinel = [torch.full((S, NL, L, Hkv, D), -3.0, dtype=torch.bfloat16, device=dev)]
        caches = {who: [sentinel[0].clone(), sentinel[0].clone(), None, None]
                  for who in ("kernel", "plain")}
    args = (qp, kp, vp, *norms, cos, sin)
    if not qk_norm:  # no affines: the kernel reads none
        args = (qp, kp, vp, None, None, None, None, *args[7:])
    kw = dict(layer=layer, num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=qk_norm)
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
    names = ("k_code", "v_code", "k_scale", "v_scale") if quantize else ("k", "v")
    for name, got, want, sent in zip(names, caches["kernel"], caches["plain"],
                                     sentinel[:1] * 2 + sentinel[1:] * 2):
        gw = torch.stack([got[i] for i in win]).float()
        ww = torch.stack([want[i] for i in win]).float()
        errs[name] = (gw - ww).abs().max().item()
        peaks[name] = ww.abs().max().item()
        rest = got.clone()
        for i in win:
            rest[i] = sent[i]
        untouched = untouched and torch.equal(rest, sent)
        del rest
    # tolerance: one bf16 rounding of q (and of bf16 K/V) at its largest
    # magnitude, one int8 step for K/V codes, one bf16 rounding of the scales
    tol_q = 2 ** -7 * q_want.float().abs().max().item()
    if quantize:
        tol_s = 2 ** -7 * max(peaks["k_scale"], peaks["v_scale"])
        tol = dict(q=tol_q, codes=1, scales=tol_s)
        ok = (errs["q"] <= tol_q and max(errs["k_code"], errs["v_code"]) <= 1
              and max(errs["k_scale"], errs["v_scale"]) <= tol_s and untouched)
    else:
        tol = dict(q=tol_q, k=2 ** -7 * peaks["k"], v=2 ** -7 * peaks["v"])
        ok = all(errs[k] <= t for k, t in tol.items()) and untouched
    ms = time_ms(call)
    call_ms = eager_ms(call)
    plain_ms = time_ms(plain)
    # each input read once, each output written once: the window's K/V
    # codes and scales go straight into the cache, nothing is read back
    n_in = (2 * S * T * (H + 2 * Hkv) * D + qk_norm * 2 * 2 * (H + Hkv) * D
            + 2 * 4 * S * T * D + 4 * S)
    # q in bf16; K/V as int8 codes with bf16 scales, or in bf16
    n_out = (2 * S * T * H * D + (2 * S * T * Hkv * D + 2 * 2 * S * T * Hkv if quantize
                                  else 2 * 2 * S * T * Hkv * D))
    # per element: ~8 norm ops (q, k), 3 rope ops (q, k), ~4 quantize ops (k, v)
    n_ops = S * T * D * ((8 * qk_norm + 3) * (H + Hkv) + 4 * 2 * Hkv * quantize)
    b_ms, b_by = bound_ms(n_in + n_out, n_ops, F32_FLOPS)
    row = dict(name="fused_epilogue", case=case, cache="int8" if quantize else "bf16",
               shape=dict(S=S, T=T, H=H, Hkv=Hkv, D=D, NL=NL, L=L, layer=layer,
                          cache_end=list(ends)), qk_norm=qk_norm,
               max_abs_err=errs, tolerance=tol,
               other_rows_unchanged=untouched, ok=ok, ms=ms, eager_ms=call_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
               bytes=n_in + n_out)
    emit("kernel", **row)
    check(ok, f"fused_epilogue ({case}) disagrees with its plain version, or wrote "
              "outside the window")
    del sentinel, caches
    torch.cuda.empty_cache()
    return row


def phase_epilogue(dev):
    """The epilogue at the shapes of both paths that run it: ``generate``
    (one slot, CFG: S = 2) and ``serve`` (two slots: S = 4, a 2048-row
    buffer, each slot at its own fill, cond and uncond halves alike)."""
    main = _epilogue_case(dev, "generate", 2, 2560, (1200, 37), 0)
    serve = _epilogue_case(dev, "serve", 4, 2048, (690, 1731, 690, 1731), 3)
    return dict(name="fused_epilogue", route="cuda", source="sjd_tpu_torch/csrc/fused_epilogue.cu",
                replaces="sjd_tpu/ops/fused_epilogue.py:35",
                max_abs_err=max(max(r["max_abs_err"].values()) for r in (main, serve)),
                ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None)


def _attention_cases(dev, case: str, S: int, L: int, valid, fills, kinds, seed: int,
                     H: int = 32, Hkv: int = 32, NL: int = 32, layer: int = 17,
                     D: int = 128, W: int = 16):
    """``decode_attention`` against its plain version on an ``NL``-layer
    cache of ``S`` rows and ``L`` rows each, under the mask ``valid``, for
    each per-row fill in ``fills`` and each cache kind; times the kernel,
    the plain version and SDPA (its GQA form where Hkv < H) on the same
    layer. Returns the rows."""
    import torch
    import torch.nn.functional as F

    from sjd_tpu_torch.ops.decode_attention import (
        _entry, decode_attention, decode_attention_plain, decode_masks)
    from sjd_tpu_torch.ops.fused_epilogue import quantize_rows

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, W, H, D), generator=g, device=dev).to(torch.bfloat16)
    kq, ks = quantize_rows(torch.randn((S, NL, L, Hkv, D), generator=g, device=dev))
    vq, vs = quantize_rows(torch.randn((S, NL, L, Hkv, D), generator=g, device=dev))
    # the attended layer dequantized: SDPA's operands, and the bf16 cache's
    # one live layer (in a zero stack)
    kd = (kq[:, layer].float() * ks[:, layer, ..., None].float()).to(torch.bfloat16)
    vd = (vq[:, layer].float() * vs[:, layer, ..., None].float()).to(torch.bfloat16)
    caches = {"int8": (kq, vq, ks, vs)}
    if "bf16" in kinds:
        kbf = torch.zeros((S, NL, L, Hkv, D), dtype=torch.bfloat16, device=dev)
        vbf = torch.zeros_like(kbf)
        kbf[:, layer], vbf[:, layer] = kd, vd
        caches["bf16"] = (kbf, vbf, None, None)
    split_rows = _entry()[1]
    results = []
    for kind in kinds:
        k, v, kscale, vscale = caches[kind]
        for ends in fills:
            cache_end = torch.tensor(ends, dtype=torch.int32, device=dev)
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
            ms = time_ms(call)
            call_ms = eager_ms(call)
            plain_ms = time_ms(lambda: decode_attention_plain(
                q, k, v, kscale, vscale, cache_end, valid, layer=layer), reps=3, trials=5)
            # the yardstick: SDPA over the dequantized bf16 layer, same mask
            qs, kt, vt = q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)
            mask = decode_masks(cache_end, valid, W, L)[:, None]
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, enable_gqa=Hkv < H))
            live = [min(e + W, L) for e in ends]  # each row's attended cache rows
            kv_bytes = 1 if kind == "int8" else 2
            n_bytes = (2 * sum(live) * Hkv * D * kv_bytes
                       + (2 * sum(live) * Hkv * 2 if kscale is not None else 0)
                       + 2 * 2 * S * W * H * D + S * L + 4 * S)
            n_ops = 4 * W * H * D * sum(live)
            b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
            # the grid covers every split of the buffer; blocks of dead
            # splits return at once
            live_blocks = math.ceil(W * H // Hkv / 16) * Hkv * sum(
                math.ceil(n / split_rows) for n in live)
            row = dict(name="decode_attention", case=case, cache=kind, fill=list(ends),
                       shape=dict(S=S, W=W, H=H, Hkv=Hkv, D=D, NL=NL, L=L, layer=layer),
                       masked_rows=(~valid).sum(1).tolist(),
                       max_abs_err=err, tolerance=tol, ok=ok, ms=ms, eager_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms, splits=math.ceil(L / split_rows),
                       live_blocks=live_blocks, bound_share=b_ms / ms)
            emit("kernel", **row)
            check(ok, f"decode_attention ({case}, {kind} cache, fill {ends}) disagrees "
                      "with its plain version")
            results.append(row)
    del caches, kq, vq, kd, vd
    torch.cuda.empty_cache()
    return results


def phase_attention(dev):
    """The attention at the shapes of both paths that run it: ``generate``
    (S = 2: one slot and its uncond half, whose prompt is masked down to its
    last token) over a range of fills, in both cache kinds; and ``serve``
    (S = 4, a 2048-row int8 buffer behind a 675-row left-padded prompt
    bucket: slot 0's prompt fills it, slot 1's 15-token prompt leaves 660
    pad rows, both uncond halves mask all but the last prompt row; each
    slot at its own fill, as after a refill)."""
    import torch

    S, L, P = 2, 2560, 15
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    valid[1, :P - 1] = False  # the CFG uncond half masks its prompt rows
    fills = [(f, f) for f in (150, 1200, 2400, L - 16)]
    main_rows = _attention_cases(dev, "generate", S, L, valid, fills, ("int8", "bf16"), 1)
    S, L, P, pad = 4, 2048, 675, 660
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    valid[1, :pad] = False  # slot 1's left padding
    valid[2:, :P - 1] = False  # the uncond halves
    fills = [(700, 1400, 700, 1400), (1900, 1010, 1900, 1010), (L - 16, 676, L - 16, 676)]
    serve_rows = _attention_cases(dev, "serve", S, L, valid, fills, ("int8",), 4)
    main = next(r for r in main_rows if r["cache"] == "int8" and r["fill"][0] == 1200)
    return dict(name="decode_attention", route="cuda",
                source="sjd_tpu_torch/csrc/decode_attention.cu",
                replaces="sjd_tpu/ops/decode_attention.py:38",
                max_abs_err=max(r["max_abs_err"] for r in main_rows + serve_rows),
                ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"])


# the 7B's quantized weights (N, K): the attention projections, the MLP's
# gate/up and down projections, the head
QUANT_SHAPES = {"wq": (4096, 4096), "w_gate": (11008, 4096), "w_down": (4096, 11008),
                "lm_head": (65536, 4096)}
# rows: a decode window of the generate path (S = 2, W = 16) and of the
# serve path (S = 4), the generate path's prefill (2 x 15 prompt rows); and,
# K1 only, the benchmark cells' decode windows (5 and 3 slots, both CFG
# halves, W = 16) and a refill's prefill in the 5-slot cell
QUANT_ROWS = {"generate": 32, "serve": 64, "prefill": 30, "serve5": 160, "serve3": 96,
              "refill": 990}
K1_ONLY_ROWS = ("serve5", "serve3", "refill")
# Emu3-Gen 8B's weights (N, K) for K1: wk/wv, w_gate/w_up, w_down (int4) and
# the int8 head of 184622 rows (not a multiple of K1's 128-row block)
EMU3_QUANT_SHAPES = {"emu3_wk": (1024, 4096), "emu3_w_gate": (14336, 4096),
                     "emu3_w_down": (4096, 14336), "emu3_lm_head": (184622, 4096)}
L2_BYTES = 50 * 2 ** 20  # the H100's L2


def _copies(t):
    """An endless cycle over ``t`` and enough copies of it that twelve
    consecutive calls (``_quant_case``'s timing) read over twice the L2."""
    import itertools

    n = min(12, math.ceil(2 * L2_BYTES / (t.numel() * t.element_size())))
    return itertools.cycle([t] + [t.clone() for _ in range(n - 1)])


def _quant_case(dev, weight: str, bits: int, a8: bool, case: str, seed: int):
    """One quantized product against its plain version at one of the 7B's
    weight shapes: A16 within one bf16 rounding of the largest output plus
    f32 reassociation, A8 bit-equal. Times the kernel (graph and eager), the
    plain version, and the library yardsticks (never called by the port):
    bf16 F.linear on the dequantized weight, torch._int_mm for W8A8 and
    torch.ops.aten._weight_int8pack_mm for W8A16 where they run."""
    import torch
    import torch.nn.functional as F

    from sjd_tpu_torch.models.transformer import _quantize_act, quantize_int4, quantize_int8
    from sjd_tpu_torch.ops import quant_linear as ql

    (N, K), M = {**QUANT_SHAPES, **EMU3_QUANT_SHAPES}[weight], QUANT_ROWS[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((N, K), generator=g, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    leaf = quantize_int4(w) if bits == 4 else quantize_int8(w)
    q, s = leaf["q4p" if bits == 4 else "q"], leaf["s"]
    del w
    # the forward reads each weight once, from HBM: every timed call below
    # takes the next of enough copies of its weight to overflow the L2
    qs = _copies(q)
    if a8:
        xq, xs = _quantize_act(x)
        call = lambda: ql.quant_linear_a8(xq, xs, next(qs), s, bits=bits)  # noqa: E731
        plain = lambda: ql.quant_linear_a8_plain(xq, xs, q, s, bits=bits)  # noqa: E731
    else:
        call = lambda: ql.quant_linear_a16(x, next(qs), s, bits=bits)  # noqa: E731
        plain = lambda: ql.quant_linear_a16_plain(x, q, s, bits=bits)  # noqa: E731
    got, want = call(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 0.0 if a8 else 2 ** -7 * want.float().abs().max().item() + 1e-3
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol
    # one product, one launch: the device runs the one kernel and nothing else
    ran, traces = _device_kernels(call)
    one_launch = list(ran.values()) == [1] and "::quant_linear_kernel" in next(iter(ran))
    tiles_n, tiles_m, splits = ql.grid(M, N, K, bits, a8)
    ms, call_ms = time_ms(call, reps=12, trials=7), eager_ms(call, reps=12, trials=7)
    plain_ms = time_ms(plain, reps=2, trials=3)
    codes = ql.unpack_int4(q) if bits == 4 else q
    # the bf16 yardstick's weight
    wds = _copies((codes.float() * s.float()[:, None]).to(torch.bfloat16))
    library = {"F.linear_bf16": time_ms(lambda: F.linear(x, next(wds)), reps=12, trials=7)}
    if a8 and bits == 8:
        try:
            qts = _copies(q.t())
            library["torch._int_mm"] = time_ms(lambda: torch._int_mm(xq, next(qts)), reps=12,
                                               trials=7)
        except RuntimeError as e:  # a yardstick that does not run here is reported
            library["torch._int_mm"] = f"does not run: {str(e).splitlines()[0][:120]}"
    # not at Emu3's head (52 ms a call) nor at the K1-only rows (96 ms a call at
    # 990 rows, after which the profiler missed the next case's lone kernel)
    if not a8 and bits == 8 and not weight.startswith("emu3") and case not in K1_ONLY_ROWS:
        try:
            library["aten._weight_int8pack_mm"] = time_ms(
                lambda: torch.ops.aten._weight_int8pack_mm(x, next(qs), s), reps=12, trials=7)
        except RuntimeError as e:
            library["aten._weight_int8pack_mm"] = f"does not run: {str(e).splitlines()[0][:120]}"
    del wds, qs, codes
    # each input read once, each output written once
    wbytes = q.numel() + 2 * N
    xbytes = M * K + 4 * M if a8 else 2 * M * K
    n_bytes = wbytes + xbytes + 2 * M * N
    b_ms, b_by = bound_ms(n_bytes, 2 * M * N * K, INT8_TENSOR_OPS if a8 else BF16_TENSOR_FLOPS)
    row = dict(name="quant_linear_a8" if a8 else "quant_linear_a16", weight=weight, bits=bits,
               case=case, shape=dict(M=M, N=N, K=K), tile=ql.tile(a8)[0], splits=splits,
               blocks=tiles_n * tiles_m * splits if a8 else None,  # K1's M tiles: up to 256 rows
               resident_blocks=ql.resident(bits, a8),
               kernels_per_call=ran, profile_traces=traces, max_abs_err=err, tolerance=tol,
               ok=ok, ms=ms, eager_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               bound_share=b_ms / ms, bytes=n_bytes, library_ms=library)
    emit("quant_kernel", **row)
    check(ok, f"{row['name']} (int{bits}, {weight}, {case}) disagrees with its plain version")
    check(one_launch, f"{row['name']} (int{bits}, {weight}, {case}) ran {ran} on the device, "
                      "not one quant_linear_kernel")
    torch.cuda.empty_cache()
    return row


def phase_quant_kernels(dev):
    """K1 at bits 4 on the projections and bits 8 on the projections and the
    head; K2 the same; each at the generate and serve windows' rows and the
    generate prefill's, K1 at the benchmark cells' rows too; then K1 at
    Emu3-Gen 8B's four weight shapes at the generate and serve rows.
    Returns the kernels' JSON rows, whose numbers are the main case's: the
    4096 x 4096 projection, int4, at the generate window (Emu3's row: its
    14336 x 4096 int4 w_gate)."""
    rows = []
    seed = 10
    for a8 in (False, True):
        for bits in (4, 8):
            for weight in QUANT_SHAPES:
                if weight == "lm_head" and bits == 4:
                    continue  # the loaders quantize the head to int8
                for case in QUANT_ROWS:
                    if a8 and case in K1_ONLY_ROWS:
                        continue
                    seed += 1
                    rows.append(_quant_case(dev, weight, bits, a8, case, seed))
    # K1 at Emu3's shapes, on the generate and serve windows' rows
    for weight in EMU3_QUANT_SHAPES:
        for case in ("generate", "serve"):
            seed += 1
            rows.append(_quant_case(dev, weight, 8 if weight == "emu3_lm_head" else 4, False,
                                    case, seed))
    emu3 = next(r for r in rows if r["weight"] == "emu3_w_gate" and r["case"] == "generate")
    out = []
    for name, line in (("quant_linear_a16", 478), ("quant_linear_a8", 484)):
        mine = [r for r in rows if r["name"] == name and not r["weight"].startswith("emu3")]
        main = next(r for r in mine if r["weight"] == "wq" and r["bits"] == 4
                    and r["case"] == "generate")
        out.append(dict(name=name, route="cuda", source="sjd_tpu_torch/csrc/quant_linear.cu",
                        replaces=f"sjd_tpu/models/transformer.py:{line}",
                        max_abs_err=max(r["max_abs_err"] for r in mine), ms=main["ms"],
                        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                        bound_by=main["bound_by"],
                        library_ms=main["library_ms"]["F.linear_bf16"]))
    mine = [r for r in rows if r["weight"].startswith("emu3")]
    out.append(dict(name="quant_linear_a16", case="emu3", route="cuda",
                    source="sjd_tpu_torch/csrc/quant_linear.cu",
                    replaces="sjd_tpu/models/transformer.py:478",
                    max_abs_err=max(r["max_abs_err"] for r in mine), ms=emu3["ms"],
                    plain_ms=emu3["plain_ms"], bound_ms=emu3["bound_ms"],
                    bound_by=emu3["bound_by"],
                    library_ms=emu3["library_ms"]["F.linear_bf16"]))
    return out


def _forward_pair(dev, cfg, params):
    """A 15-token prefill and a 16-row window of a small decoder through the
    kernels and through attn_impl="plain": the two windows' logits, and the
    quantized products the kernel path launched."""
    import torch

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.ops import launch_counts

    rope = pt.make_rope_table(cfg, 512, device=dev)
    S, P, W, L = 2, 15, 16, 512
    gen = torch.Generator(device=dev).manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (S, P + W), generator=gen, device=dev)
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    valid[1, :P - 1] = False
    pos = torch.clamp_min(torch.cumsum(valid[:, :P].int(), 1) - 1, 0)
    pos_w = pos[:, -1:] + 1 + torch.arange(W, device=dev)
    logits, launched = [], {}
    with torch.no_grad():
        for c in (cfg, dataclasses.replace(cfg, attn_impl="plain")):
            before = launch_counts()
            kv = pt.init_kv_cache(c, S, L, device=dev)
            zero = torch.zeros((S,), dtype=torch.int32, device=dev)
            pt.forward(params, c, ids[:, :P], pos, kv, zero, valid, rope)
            logits.append(pt.forward(params, c, ids[:, P:], pos_w, kv, zero + P, valid,
                                     rope).logits)
            launched[c.attn_impl] = {k: n - before[k] for k, n in launch_counts().items()}
    return logits, launched


def _small_decoder(dev, **kw):
    from sjd_tpu_torch.models import transformer as pt

    cfg = pt.DecoderConfig(vocab_size=65536, hidden_size=512, intermediate_size=1024,
                           num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                           qk_norm=True, kv_quant=True, max_position_embeddings=512, **kw)
    return cfg, pt.init_params(0, cfg, device=dev)


def phase_forward(dev):
    cfg, params = _small_decoder(dev)
    logits, _ = _forward_pair(dev, cfg, params)
    err = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    # tolerance: bf16 activations round at other points once the attention
    # sums in another order; 5% of the largest logit
    ok = math.isfinite(err) and err <= 0.05 * scale
    emit("forward", layers=cfg.num_layers, head_dim=cfg.head_dim, max_abs_err=err,
         max_abs_logit=scale, tolerance=0.05 * scale, ok=ok)
    check(ok, "kernel forward disagrees with the plain forward")


def phase_quant_forward(dev):
    """phase_forward's decoder on equilibrated W4A16 and W4A8 weights (int8
    head): the kernel forward (both TPU kernels and the quantized products)
    against the plain forward (plain attention, plain products)."""
    from sjd_tpu_torch.models import transformer as pt

    for act, kernel in (("bf16", "quant_linear_a16"), ("int8", "quant_linear_a8")):
        cfg, params = _small_decoder(dev, act_quant=act)
        params = pt.quantize_weights(params, bits=4, head_bits=8, config=cfg)
        logits, launched = _forward_pair(dev, cfg, params)
        err = (logits[0] - logits[1]).abs().max().item()
        scale = logits[1].abs().max().item()
        # the same 5% as phase_forward: the products sum in another order
        # too (and under W4A8 an activation code may move by one)
        ok = math.isfinite(err) and err <= 0.05 * scale
        want = 2 * (7 * cfg.num_layers + 1)  # two forwards: 7 products per layer, the head
        emit("quant_forward", act_quant=act, bits=4, layers=cfg.num_layers, max_abs_err=err,
             max_abs_logit=scale, tolerance=0.05 * scale, ok=ok, launches=launched,
             launches_expected={kernel: want})
        check(ok, f"W4 {act} kernel forward disagrees with the plain forward")
        check(launched["auto"][kernel] == want and launched["plain"][kernel] == 0,
              f"{kernel}: launches {launched}, not {want} on the kernel path and 0 on the "
              "plain one")


PROMPT = "a photo of a red fox in the snow"


def lumina_ids(size: int) -> list:
    """A Lumina prompt for a ``size`` px image: 12 text ids, then
    <image_start> and the two size tokens the grammar arms its grid from."""
    from sjd_tpu_torch.data.item_processor import size_token_id
    from sjd_tpu_torch.models.chameleon import IMAGE_START_ID

    return list(range(9000, 9012)) + [IMAGE_START_ID, size_token_id(size), size_token_id(size)]


def phase_load(dev, quantize=False, label: str = "load"):
    """Lumina-mGPT-7B through load_lumina_mgpt at full width and depth, in
    bf16 or with ``quantize``'s weights (drawn and quantized leaf by leaf on
    the card)."""
    import torch

    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.models.transformer import weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = load_lumina_mgpt(target_size=TARGET_SIZE, quantize=quantize, device=dev)
    torch.cuda.synchronize()
    cfg = model.engine.model_cfg
    wq = model.params["layers"]["wq"]
    emit(label, seconds=time.time() - t0, quantize=quantize, act_quant=cfg.act_quant,
         layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
         kv_quant=cfg.kv_quant, weight_bytes=weight_bytes(model.params),
         wq_leaf=sorted(wq) if isinstance(wq, dict) else str(wq.dtype),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         smoke_reasons=model.extras["smoke_reasons"])
    check((cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.kv_quant)
          == (32, 4096, 65536, True), f"not the 7B config: {cfg}")
    if quantize:
        check(isinstance(wq, dict) and isinstance(model.params["lm_head"], dict)
              and "q" in model.params["lm_head"], "the quantized load kept bf16 weights")
    return model


def phase_widths(dev, params, cfg, label: str, hold: bool, size: int = 256,
                 chunk_steps: int = 64):
    """The same request (prompt and seed) through ContinuousBatcher at batch
    widths 1, 2 and 5, with companions of the same prompt length: its tokens
    must not change with the width when ``hold`` (the quantized path, whose
    products sum in an order fixed by the weight's shape); on bf16 weights,
    where cuBLAS picks its kernels by the row count, the result is
    reported."""
    import numpy as np
    import torch

    from sjd_tpu_torch.core.serving import ContinuousBatcher
    from sjd_tpu_torch.data.item_processor import size_token_id
    from sjd_tpu_torch.models.chameleon import IMAGE_END_ID, IMAGE_START_ID, lumina_engine

    rng = np.random.default_rng(11)
    header = [IMAGE_START_ID, size_token_id(size), size_token_id(size)]
    prompts = np.asarray([list(map(int, rng.integers(9000, 13000, 12))) + header
                          for _ in range(5)], np.int32)
    seeds = [401, 402, 403, 404, 405]
    eng = lumina_engine(target_size=size, model_cfg=cfg, device=dev)
    eng.config = dataclasses.replace(eng.config, eos_id=IMAGE_END_ID)
    tokens, nfe = {}, {}
    t0 = time.time()
    for width in (1, 2, 5):
        batcher = ContinuousBatcher(eng, params, chunk_steps=chunk_steps)
        done = batcher.run(None, prompts[:width], batch=width, seeds=seeds[:width])
        tokens[width] = done[0].tokens
        nfe[width] = batcher.last_nfe
    same = {w: bool(np.array_equal(tokens[w], tokens[1])) for w in (2, 5)}
    emit(label, act_quant=cfg.act_quant, quantized=isinstance(params["layers"]["wq"], dict),
         size=size, widths=[1, 2, 5], request_tokens=len(tokens[1]), nfe=nfe,
         equal_to_width_1=same, held=hold, seconds=time.time() - t0)
    if hold:
        check(all(same.values()), f"the request's tokens change with the batch width: {same}")
    del eng
    torch.cuda.empty_cache()


def _state_diff(a, b):
    """The first EngineState tensor (by name) whose bytes differ, or None."""
    import torch

    for name in ("tokens", "length", "accept_hist", "steps_multi", "finished",
                 "carried_tokens", "carried_count", "carried_probs", "last_prob"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            return name
    for name, x, y in zip(("k", "v", "k_scale", "v_scale"), a.kv, b.kv):
        if x is not None and not torch.equal(x, y):
            return f"kv.{name}"
    return None if a.nfe == b.nfe else "nfe"


def _zero_launch_counts() -> None:
    from sjd_tpu_torch.ops.decode_attention import decode_attention
    from sjd_tpu_torch.ops.fused_epilogue import fused_epilogue_into_cache, write_kv_layer
    from sjd_tpu_torch.ops.quant_linear import quant_linear_a8, quant_linear_a16

    fused_epilogue_into_cache.launches = 0
    decode_attention.launches = 0
    quant_linear_a16.launches = 0
    quant_linear_a8.launches = 0
    write_kv_layer.calls = 0


def per_forward(params, cfg) -> dict:
    """Each kernel's launches in one forward of T <= 32 rows: each TPU
    kernel once per layer; on quantized weights, one quantized product per
    projection (7 per layer) and one for a quantized head, through K1
    (act_quant "bf16") or K2 ("int8")."""
    n_quant = (7 * cfg.num_layers * isinstance(params["layers"]["wq"], dict)
               + isinstance(params.get("lm_head"), dict))
    a8 = cfg.act_quant == "int8"
    return {"fused_epilogue": cfg.num_layers, "decode_attention": cfg.num_layers,
            "quant_linear_a16": 0 if a8 else n_quant, "quant_linear_a8": n_quant if a8 else 0}


# the kernels' symbols as the profiler names them (csrc/*.cu), with the
# launch table's entry each counts once per launch: the epilogue's, the
# attention's split and merge kernels, the quantized products' one kernel
# (K2's quant_linear_kernel, K1's quant_linear_kernel_wg)
KERNEL_SYMBOLS = {"::epilogue_kernel<": "fused_epilogue",
                  "::flash_decode_split_kernel<": "decode_attention",
                  "::merge_splits_kernel<": "decode_attention",
                  "::quant_linear_kernel": ("quant_linear_a16", "quant_linear_a8")}
# symbols that must not run: the second launch that added the quantized
# products' split partials before the split sum moved into the one kernel
GONE_SYMBOLS = ("reduce_splits_kernel",)


def _device_kernels(run, tries: int = 3) -> tuple[dict, int]:
    """Every kernel the device ran during ``run()``, by name, with its
    count, as torch.profiler traces them (replayed graph nodes included),
    and the number of traces taken. A trace of one lone kernel has, rarely,
    come back with no device event at all: such a trace is the tracer's
    miss, not a result
    (the callers hold the output and the launch counters too): ``run()`` is
    traced again, at most ``tries`` times in all. Each trace also leaves the
    device idle for a few milliseconds on either side of ``run()``, since
    the tracer drops device events outside its capture window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.005)
            run()
            torch.cuda.synchronize()
            time.sleep(0.005)
        ran = {ev.key: ev.count for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")}
        if ran:
            break
    return ran, attempt


def _profiled_launches(run) -> tuple[dict, int]:
    """The kernels' launches the device ran during ``run()``, by symbol
    (KERNEL_SYMBOLS, then GONE_SYMBOLS), and the number of traces taken."""
    ran, traces = _device_kernels(run)
    return {sym: sum(n for key, n in ran.items() if sym in key)
            for sym in (*KERNEL_SYMBOLS, *GONE_SYMBOLS)}, traces


def phase_graph(dev, params, cfg, prompt_ids, label: str = "graph", steps: int = 32,
                profiled_steps: int = 2, make_engine=None, neg_ids=None, embeds=None):
    """The captured decode step against the eager one on the 7B: the same
    seed and calls, ``steps`` timed decode steps each after one untimed
    step (on the graph engine: replays of a graph captured beforehand).
    Each engine's run starts from launch counts of 0; the launches that ran
    must be :func:`per_forward`'s per forward on both. Then
    ``profiled_steps`` more replays under torch.profiler: each must run each
    kernel as often on the device, which is what GraphStats.executed
    assumes of a replay.

    ``make_engine(cuda_graph)`` builds the engine (the 7B's lumina_engine by
    default) and ``neg_ids`` is the negative prompt of a ``neg_prompt`` CFG
    engine; ``embeds`` (generate's ``prompt_embeds``, ``neg_prompt_embeds``
    and ``prompt_mask``) replaces ``prompt_ids`` for an embedding prompt. A
    prefill over KERNEL_MAX_T rows takes the plain path: no TPU kernel
    launches there."""
    import torch

    from sjd_tpu_torch.models.chameleon import lumina_engine
    from sjd_tpu_torch.models.transformer import KERNEL_MAX_T
    from sjd_tpu_torch.ops import launch_counts

    if make_engine is None:
        def make_engine(graph):
            return lumina_engine(target_size=TARGET_SIZE, cuda_graph=graph, model_cfg=cfg,
                                 device=dev)
    if embeds is not None:
        ids, gkw, width = None, embeds, embeds["prompt_embeds"].shape[1]
    else:
        ids = torch.tensor([prompt_ids], dtype=torch.int32, device=dev)
        gkw = {} if neg_ids is None else {
            "neg_prompt": torch.tensor([neg_ids], dtype=torch.int32, device=dev)}
        width = max(len(prompt_ids), len(neg_ids or ()))
    long_prefill = width > KERNEL_MAX_T
    table = per_forward(params, cfg)
    runs, launched = {}, {}
    for graph in (False, True):
        eng = make_engine(graph)
        _zero_launch_counts()
        # a throwaway run: on the graph engine the warm-up step and the
        # capture. Both engines make it, so that their caches hold the same
        # rows outside the live prefix too (the uncond half's masked prompt
        # rows attend to the whole buffer, so their K/V depend on it)
        forwards = eng.generate(params, 0, ids, max_steps=3, **gkw).nfe
        _, st = eng.generate(params, 0, ids, max_steps=2, return_state=True, **gkw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = eng.resume(params, st, max_steps=steps, return_state=True)
        torch.cuda.synchronize()
        runs[graph] = (eng, st, 1e3 * (time.perf_counter() - t0) / steps)
        forwards += st.nfe
        # every decode forward has T <= 32 (windows of 16) and launches each
        # kernel as the table says; the two prefills too when their prompt
        # has no more than KERNEL_MAX_T rows (only the quantized products
        # otherwise)
        launched[graph] = dict(executed=eng.stats.executed(launch_counts()), expected={
            k: n * (forwards - (2 if long_prefill and not k.startswith("quant") else 0))
            for k, n in table.items()})
    (e_eng, e_st, e_ms), (g_eng, g_st, g_ms) = runs[False], runs[True]
    diff = _state_diff(e_st, g_st)
    first = None
    if diff is not None:
        # step both again from the prefill, one decode step per call, to
        # name the first step and tensor that differ
        sts = [eng.generate(params, 0, ids, max_steps=1, return_state=True, **gkw)[1]
               for eng in (e_eng, g_eng)]
        for i in range(1, steps + 2):
            for eng, st in zip((e_eng, g_eng), sts):
                eng.resume(params, st, max_steps=1)
            name = _state_diff(*sts)
            if name is not None:
                first = {"decode_step": i, "tensor": name}
                break
    replays = g_eng.stats.replays
    profiled, traces = _profiled_launches(
        lambda: g_eng.resume(params, g_st, max_steps=profiled_steps))
    profiled_replays = g_eng.stats.replays - replays
    emit(label, act_quant=cfg.act_quant, launches_per_forward=table, steps=steps, nfe=g_st.nfe, eager_ms_per_forward=e_ms,
         graph_ms_per_forward=g_ms, speedup=e_ms / g_ms, equal=diff is None,
         first_difference=first, tokens=int(g_st.length[0]),
         accept_hist=g_st.accept_hist.tolist(), captures=g_eng.stats.captures,
         capture_s=g_eng.stats.capture_s, graph_replays=g_eng.stats.replays,
         eager_steps=g_eng.stats.eager_steps,
         launches={"eager" if not k else "graph": v for k, v in launched.items()},
         profiled_replays=profiled_replays, profiled_kernel_launches=profiled,
         profile_traces=traces)
    check(diff is None, f"graph and eager decode steps differ: first at {first}, "
                        f"after {steps} steps in {diff}")
    # replays: one in the throwaway run, one in the step before the window
    check(g_eng.stats.captures == 1 and replays == steps + 2, f"graph engine: {g_eng.stats}")
    for path, got in launched.items():
        for name, n in got["executed"].items():
            check(n == got["expected"][name], f"{name}: {n} launches ran on the "
                  f"{'graph' if path else 'eager'} engine, not {got['expected'][name]}")
    # each trace taken (a trace that saw nothing is taken again) replays
    check(profiled_replays == profiled_steps * traces,
          f"{profiled_replays} replays profiled in {traces} traces")
    for sym, n in profiled.items():
        names = KERNEL_SYMBOLS.get(sym)
        if names is None:
            check(n == 0, f"the profiler saw {n} launches of {sym}, which is gone")
            continue
        want = sum(table[k] for k in ((names,) if isinstance(names, str) else names))
        check(n == want * profiled_steps,
              f"the profiler saw {n} launches of {sym} in {profiled_steps} replays, "
              f"not {want * profiled_steps}")
    del runs, e_eng, g_eng, e_st, g_st
    torch.cuda.empty_cache()
    return launched[True]["executed"]


def phase_generate(dev, model, label: str = "generate"):
    """One 768px image through ``model.sample_fn`` on the graph path; the
    launches that ran must be :func:`per_forward`'s per forward, and no KV
    row written outside the epilogue kernel."""
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.data.item_processor import split_generation
    from sjd_tpu_torch.models.transformer import weight_bytes
    from sjd_tpu_torch.ops import launch_counts
    from sjd_tpu_torch.ops.fused_epilogue import write_kv_layer

    cfg = model.engine.model_cfg
    table = per_forward(model.params, cfg)
    torch.cuda.reset_peak_memory_stats()
    model.engine.stats = GraphStats()
    _zero_launch_counts()
    t0 = time.time()
    img = model.sample_fn(PROMPT, 0)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    stats = model.engine.stats
    counted = launch_counts()
    launches = stats.executed(counted)
    kv_writes = write_kv_layer.calls

    res = model.extras["last_result"]
    toks = res.tokens[0, : int(res.length[0])].tolist()
    t0 = time.time()
    again = model.extras["decode_image_fn"](toks)
    torch.cuda.synchronize()
    vq_s = time.time() - t0
    nfe = int(res.nfe)
    spans = [s for kind, s in split_generation(toks) if kind == "image"]
    emit(label, quantize=model.extras.get("quantize"), act_quant=cfg.act_quant,
         weight_bytes=weight_bytes(model.params), target_size=TARGET_SIZE,
         layers=cfg.num_layers,
         hidden=cfg.hidden_size, vocab=cfg.vocab_size, window=model.engine.config.window,
         tokens_generated=int(res.gen_count[0]), nfe=nfe,
         accept_hist=res.accept_hist.tolist(), wall_s=wall_s, vq_decode_s=vq_s,
         ms_per_forward=1e3 * (wall_s - vq_s) / nfe,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         image_shape=list(img.shape), image_dtype=str(img.dtype),
         image_tokens=len(spans[-1]) if spans else 0, launches=launches,
         launches_counted=counted,
         launches_expected={k: n * nfe for k, n in table.items()},
         captures=stats.captures, graph_replays=stats.replays,
         eager_steps=stats.eager_steps, capture_s=stats.capture_s,
         write_kv_layer_calls=kv_writes)
    check(tuple(img.shape) == (TARGET_SIZE, TARGET_SIZE, 3) and str(img.dtype) == "uint8",
          f"image is {img.shape} {img.dtype}")
    check((img == again).all(), "a second VQ decode of the same tokens differs")
    check(stats.captures >= 1 and stats.replays > 0, f"the graph path did not run: {stats}")
    check(stats.eager_steps + stats.replays + 1 == nfe, f"{stats} for {nfe} forwards")
    for name, n in launches.items():
        # every forward here has T <= 32 (a 15-token prompt, then windows of
        # 16), so each forward launches each kernel as the table says
        check(n > 0 or table[name] == 0, f"{name} was never launched on the main path")
        check(n == table[name] * nfe, f"{name}: {n} launches for {nfe} forwards, not "
                                      f"{table[name] * nfe}")
    # the epilogue kernel writes the window's K/V rows itself
    check(kv_writes == 0, f"write_kv_layer ran {kv_writes} times on the kernel path")
    return launches


def phase_serve(dev, model, size: int = 512, chunk_steps: int = 64, rows_given: int = 20):
    """Continuous batching on the 7B: 3 requests at ``size`` px through 2
    slots, stopping each at its image's end. Request 0 continues an image
    whose first ``rows_given`` rows are in its prompt, so it ends some 200
    forwards before request 1 (more than a chunk): its slot is refilled
    with request 2 while request 1 is live. This traffic is shaped for that
    check: three requests, one of them a part image, give no serving rate;
    the generated tokens per second are printed as a smoke figure only.

    The launch counts start at 0 just before the batcher runs and are read
    just after: each decode forward (T <= 32) runs each kernel once per
    layer; the 675-row prefills take the plain path. The live request's
    tokens are then held against a run of the same two requests with no
    refill on an engine that steps eagerly (cuda_graph=False), so neither
    the graph nor the refill is in the reference."""
    import numpy as np
    import torch

    from sjd_tpu_torch.core.serving import ContinuousBatcher, seed_generators
    from sjd_tpu_torch.data.item_processor import size_token_id
    from sjd_tpu_torch.models.chameleon import (
        IMAGE_END_ID, IMAGE_START_ID, IMAGE_VOCAB_END, IMAGE_VOCAB_START, NEW_LINE_ID,
        lumina_engine)
    from sjd_tpu_torch.ops import launch_counts

    rng = np.random.default_rng(7)
    grid = size // 16
    header = [IMAGE_START_ID, size_token_id(size), size_token_id(size)]
    given = rng.integers(IMAGE_VOCAB_START, IMAGE_VOCAB_END + 1, (rows_given, grid))
    body = [int(t) for row in given for t in (*row, NEW_LINE_ID)]
    reqs = [list(map(int, rng.integers(9000, 13000, 12))) + header + (body if i == 0 else [])
            for i in range(3)]
    P = max(map(len, reqs))
    prompts = np.asarray([[0] * (P - len(r)) + r for r in reqs], np.int32)
    masks = np.asarray([[False] * (P - len(r)) + [True] * len(r) for r in reqs])
    seeds = [101, 202, 303]

    def engine(cuda_graph):
        eng = lumina_engine(target_size=size, cuda_graph=cuda_graph,
                            model_cfg=model.engine.model_cfg, device=dev)
        # stop each request at its image's end
        eng.config = dataclasses.replace(eng.config, eos_id=IMAGE_END_ID)
        return eng

    eng = engine(True)
    held_gb = torch.cuda.memory_allocated() / 1e9  # weights, the generate engine's state
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(eng, model.params, chunk_steps=chunk_steps)
    _zero_launch_counts()
    t0 = time.time()
    done = batcher.run(None, prompts, prompt_masks=masks, batch=2, seeds=seeds)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = eng.stats.executed(launch_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    stats = dict(captures=eng.stats.captures, graph_replays=eng.stats.replays,
                 eager_steps=eng.stats.eager_steps, capture_s=eng.stats.capture_s)
    decode_forwards = eng.stats.eager_steps + eng.stats.replays
    table = per_forward(model.params, model.engine.model_cfg)
    t0 = time.time()
    images = [model.extras["decode_image_fn"](c.tokens.tolist()) for c in done]
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    gen_tokens = sum(c.gen_count for c in done)

    live = [i for r in batcher.last_refills for i in r["live"]]
    same, first_diff, across = None, None, None
    if live:
        k = live[0]
        # the live request again, with the same companion at the same batch
        # width and no refill: one uninterrupted generate, stepped eagerly
        ref = engine(False)
        want = ref.generate(model.params, seed_generators(seeds[:2], dev),
                            torch.as_tensor(prompts[:2], device=dev),
                            prompt_mask=torch.as_tensor(masks[:2], device=dev))
        del ref
        want_k = want.tokens[k, :int(want.length[k])].cpu().numpy()
        same = bool(np.array_equal(want_k, done[k].tokens))
        if not same:
            n = min(len(want_k), len(done[k].tokens))
            at = np.flatnonzero(want_k[:n] != done[k].tokens[:n])
            first_diff = int(at[0]) if at.size else n
        # and alone, at batch width 1 (reported, not held: cuBLAS may pick
        # other kernels for another width and change low bits)
        alone = eng.generate(model.params, seed_generators([seeds[k]], dev),
                             torch.as_tensor(prompts[k:k + 1], device=dev),
                             prompt_mask=torch.as_tensor(masks[k:k + 1], device=dev))
        n1 = int(alone.length[0])
        across = bool(np.array_equal(alone.tokens[0, :n1].cpu().numpy(), done[k].tokens))
    emit("serve", size=size, requests=len(reqs), slots=2, chunk_steps=chunk_steps,
         prompt_rows=P, rows_given=rows_given, seeds=seeds, nfe=batcher.last_nfe,
         decode_forwards=decode_forwards, accept_hist=batcher.last_accept_hist.tolist(),
         gen_counts=[c.gen_count for c in done], refills=batcher.last_refills,
         serve_s=serve_s, vq_decode_s=decode_s,
         smoke_gen_tokens_per_s=gen_tokens / serve_s,
         peak_mem_gb=peak, held_before_gb=held_gb,
         image_shapes=[list(im.shape) for im in images], launches=launches,
         launches_expected={k: n * decode_forwards for k, n in table.items()},
         live_request_equal_to_eager_without_refill=same,
         first_differing_token=first_diff,
         live_request_equal_at_width_1=across, **stats)
    check([c.prompt_index for c in done] == [0, 1, 2], "not every request completed")
    for im in images:
        check(tuple(im.shape) == (size, size, 3) and str(im.dtype) == "uint8",
              f"image is {im.shape} {im.dtype}")
    check(len(batcher.last_refills) >= 1, "no refill happened")
    check(bool(live), f"no request was live across a refill: {batcher.last_refills}")
    check(same, f"the request live across the refill differs from the eager run "
                f"without refill at token {first_diff}")
    check(stats["captures"] == 1, f"the serve engine recaptured: {stats}")
    # forwards: the prefill, one per refill, the rest decode steps
    check(decode_forwards == batcher.last_nfe - 1 - len(batcher.last_refills),
          f"{decode_forwards} decode forwards of {batcher.last_nfe}")
    for name, n in launches.items():
        check(n == table[name] * decode_forwards,
              f"{name}: {n} launches ran in serve for {decode_forwards} decode forwards")


# -- checkpoints from disk, image prompts, streaming, the 34B -----------------

CKPT_SHARDS = 3


class ImgTokenizer:
    """A tokenizer for the phases below, with the Chameleon layout the
    loader reads: ``get_vocab`` names every codebook id as an IMGIMG token,
    a seeded permutation onto the image-token span [4, 4 + 8192), and
    ``encode`` gives 12 text ids (9000 + 4000 classes) from a hash of the
    whole text, so every text prompt is 15 tokens with its image header."""

    def __init__(self, n_embed: int = 8192, seed: int = 3):
        import numpy as np

        from sjd_tpu_torch.data.vocab_translation import image_token_name

        perm = np.random.default_rng(seed).permutation(n_embed)
        self._vocab = {image_token_name(i): int(4 + p) for i, p in enumerate(perm)}

    def get_vocab(self):
        return dict(self._vocab)

    def encode(self, text):
        import zlib

        return [9000 + zlib.crc32(f"{i}:{text}".encode()) % 4000 for i in range(12)]


def _hf_items(src: dict, cfg, mp: int):
    """The HF (Chameleon) state dict of a port decoder tree, one tensor at a
    time: (name, tensor on the card); qk-norm affines in the vendored
    ``[mp, D]`` layout (the tree's heads repeat each shard's row)."""
    lay = src["layers"]
    yield "model.embed_tokens.weight", src["embed"]
    for i in range(cfg.num_layers):
        base = f"model.layers.{i}."
        for ours, theirs in (("attn_norm", "input_layernorm"), ("mlp_norm",
                                                                "post_attention_layernorm")):
            yield base + theirs + ".weight", lay[ours][i]
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                             ("wo", "o_proj")):
            yield base + f"self_attn.{theirs}.weight", lay[ours][i]
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
            yield base + f"mlp.{theirs}.weight", lay[ours][i]
        for name, heads in (("q", cfg.num_heads), ("k", cfg.num_kv_heads)):
            for part, suffix in (("scale", "weight"), ("bias", "bias")):
                t = lay[f"{name}_norm_{part}"][i]  # [heads, D]
                yield base + f"self_attn.{name}_norm.{suffix}", t[:: heads // mp]
    yield "model.norm.weight", src["final_norm"]
    yield "lm_head.weight", src["lm_head"]


def _write_safetensors(path: str, items) -> int:
    """A ``.safetensors`` file written here (not by the reader under test):
    the 8-byte header length, the JSON header padded to 8 bytes, each
    tensor's bytes in order. ``items``: (name, tensor) pairs, each copied to
    the host only when written. Returns the bytes written."""
    import struct

    import torch

    dtypes = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": dtypes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for _, t in items:
            f.write(t.detach().contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def _taming_state_dict(vq: dict, cfg) -> dict:
    """The taming-named VQGAN state dict of a port VQ tree (CPU tensors)."""
    n = cfg.num_resolutions
    sd = {"quantize.embedding.weight": vq["codebook"]}

    def conv(name, w, b):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = w, b

    def res(base, p):
        for k in ("1", "2"):
            conv(f"{base}.norm{k}", p[f"norm{k}_scale"], p[f"norm{k}_bias"])
            conv(f"{base}.conv{k}", p[f"conv{k}_w"], p[f"conv{k}_b"])
        if "nin_w" in p:
            conv(f"{base}.nin_shortcut", p["nin_w"], p["nin_b"])

    def attn(base, p):
        conv(f"{base}.norm", p["norm_scale"], p["norm_bias"])
        for ours, theirs in (("q", "q"), ("k", "k"), ("v", "v"), ("proj", "proj_out")):
            conv(f"{base}.{theirs}", p[f"{ours}_w"], p[f"{ours}_b"])

    for part, levels, key in (("encoder", "down", "downsample"), ("decoder", "up", "upsample")):
        p = vq[part]
        conv(f"{part}.conv_in", p["conv_in_w"], p["conv_in_b"])
        res(f"{part}.mid.block_1", p["mid_block1"])
        attn(f"{part}.mid.attn_1", p["mid_attn"])
        res(f"{part}.mid.block_2", p["mid_block2"])
        conv(f"{part}.norm_out", p["norm_out_scale"], p["norm_out_bias"])
        conv(f"{part}.conv_out", p["conv_out_w"], p["conv_out_b"])
        for idx, level in enumerate(p[levels]):
            base = f"{part}.{levels}.{idx if part == 'encoder' else n - 1 - idx}"
            for j, r in enumerate(level["res"]):
                res(f"{base}.block.{j}", r)
            for j, a in enumerate(level.get("attn", [])):
                attn(f"{base}.attn.{j}", a)
            if key in level:
                conv(f"{base}.{key}.conv", level[key]["conv_w"], level[key]["conv_b"])
    for name in ("quant_conv", "post_quant_conv"):
        conv(name, vq[f"{name}_w"], vq[f"{name}_b"])
    return {k: v.detach().cpu() for k, v in sd.items()}


def _tree_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


class _RssSampler:
    """The process's largest resident set seen every 10 ms while it runs
    (``/proc/self/statm``): a load's own host peak, which ``ru_maxrss``
    (the process's peak since it started) cannot give."""

    def __init__(self):
        import threading

        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while not self._stop.is_set():
            with open("/proc/self/statm") as f:
                self.peak = max(self.peak, int(f.read().split()[1]) * page)
            self._stop.wait(0.01)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)


def phase_ckpt(dev, root: str):
    """Lumina-mGPT-7B as checkpoint files at full width and depth (seeded
    random bf16 weights, HF names, qk-norm in the [mp, D] layout with mp = 1,
    CKPT_SHARDS safetensors shards written by _write_safetensors) and the
    full Chameleon VQGAN as a "state_dict"-nested .ckpt, then both through
    load_lumina_mgpt(ckpt_dir=, vq_ckpt=, tokenizer=): no fallback left,
    and the decoder and VQ trees on the card bit-equal to the trees the
    files were written from. Returns (ckpt_dir, vq_path, tokenizer)."""
    import torch

    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.models.chameleon import chameleon_config
    from sjd_tpu_torch.models.transformer import init_params
    from sjd_tpu_torch.models.vq import CHAMELEON_VQ, init_vq_params
    from sjd_tpu_torch.utils.profiling import host_peak_rss_bytes, time_block

    cfg = chameleon_config("7B")
    src = init_params(5, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)

    def near_one(*shape):
        return (1 + 0.1 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)

    lay, n, D = src["layers"], cfg.num_layers, cfg.head_dim
    lay["attn_norm"], lay["mlp_norm"] = near_one(n, cfg.hidden_size), near_one(n, cfg.hidden_size)
    src["final_norm"] = near_one(cfg.hidden_size)
    for name, heads in (("q", cfg.num_heads), ("k", cfg.num_kv_heads)):
        lay[f"{name}_norm_scale"] = near_one(n, 1, D).expand(n, heads, D).contiguous()
        lay[f"{name}_norm_bias"] = (near_one(n, 1, D) - 1).expand(n, heads, D).contiguous()
    ckpt_dir = os.path.join(root, "lumina_mgpt_7b")
    os.makedirs(ckpt_dir, exist_ok=True)
    items = list(_hf_items(src, cfg, mp=1))
    sizes = [t.numel() * t.element_size() for _, t in items]
    per_shard = sum(sizes) / CKPT_SHARDS
    shards, cur, acc = [], [], 0
    for item, size in zip(items, sizes):
        if cur and acc + size > per_shard * (len(shards) + 1) and len(shards) < CKPT_SHARDS - 1:
            shards.append(cur)
            cur = []
        cur.append(item)
        acc += size
    shards.append(cur)
    vq_src = init_vq_params(7, CHAMELEON_VQ, device=dev)
    vq_path = os.path.join(root, "vqgan.ckpt")
    times: dict = {}
    with time_block("write", times):
        written = sum(_write_safetensors(
            os.path.join(ckpt_dir, f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"), sh)
            for k, sh in enumerate(shards))
        torch.save({"state_dict": _taming_state_dict(vq_src, CHAMELEON_VQ)}, vq_path)
    written += os.path.getsize(vq_path)
    del items, shards, cur
    tok = ImgTokenizer()
    torch.cuda.reset_peak_memory_stats()
    rss_before = host_peak_rss_bytes()
    with _RssSampler() as rss, time_block("load", times):
        model = load_lumina_mgpt(ckpt_dir=ckpt_dir, vq_ckpt=vq_path, tokenizer=tok,
                                 target_size=TARGET_SIZE, device=dev)
    equal = _tree_equal(model.params, src)
    vq_equal = _tree_equal(model.extras["vq_params"], vq_src)
    emit("ckpt", layers=cfg.num_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
         files=sorted(os.listdir(ckpt_dir)) + [os.path.basename(vq_path)],
         bytes_written=written, write_s=times["write"],
         load_s=times["load"], load_note="files just written: the page cache is warm",
         load_gb_per_s=written / times["load"] / 1e9,
         host_rss_peak_during_load_gb=rss.peak / 1e9,
         host_ru_maxrss_gb_before=rss_before / 1e9,
         host_ru_maxrss_gb_after=host_peak_rss_bytes() / 1e9,
         peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         smoke=model.smoke, smoke_reasons=model.extras["smoke_reasons"],
         decoder_bit_equal=equal, vq_bit_equal=vq_equal)
    check(model.smoke is False, f"the checkpoint load kept fallbacks: "
                                f"{model.extras['smoke_reasons']}")
    check(equal, "the decoder read from disk differs from the tree written")
    check(vq_equal, "the VQGAN read from disk differs from the tree written")
    del model, src, vq_src
    gc.collect()
    torch.cuda.empty_cache()
    return ckpt_dir, vq_path, tok


def phase_ckpt_load_w4a16(dev, ckpt_dir, vq_path, tok):
    """The same files with quantize=4: equilibrated W4A16 with an int8 head,
    quantized on the card after the port."""
    import torch

    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.models.transformer import weight_bytes
    from sjd_tpu_torch.utils.profiling import time_block

    torch.cuda.reset_peak_memory_stats()
    times: dict = {}
    with time_block("load", times):
        model = load_lumina_mgpt(ckpt_dir=ckpt_dir, vq_ckpt=vq_path, tokenizer=tok,
                                 target_size=TARGET_SIZE, quantize=4, device=dev)
    wq = model.params["layers"]["wq"]
    emit("ckpt_load_w4a16", load_s=times["load"], weight_bytes=weight_bytes(model.params),
         peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         wq_leaf=sorted(wq), smoke=model.smoke)
    check(model.smoke is False and set(wq) == {"q4p", "s"}
          and set(model.params["lm_head"]) == {"q", "s"}, "not a W4A16 checkpoint load")
    return model


def _executed(eng):
    from sjd_tpu_torch.ops import launch_counts

    return eng.stats.executed(launch_counts())


def phase_image_input(dev, model, size: int = 512):
    """An image prompt on the checkpoint's W4A16 model: a ``size`` x ``size``
    array through the port's VQ encoder on the card (full Chameleon VQ
    widths) into a FlexAR block, then sample_i2i_fn to a 768px image. Holds
    the block's size header to its grid and to a direct encode, the
    codebook's own rows to their ids, and the launches: each TPU kernel per
    decode forward (the ~1080-token prefill takes the plain path) and every
    quantized product on every forward."""
    import numpy as np
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.data.item_processor import image_grid_from_block, size_token_id
    from sjd_tpu_torch.models.vq import codebook_encode, encode
    from sjd_tpu_torch.utils.profiling import GenerationStats, time_block

    proc, vq, vq_cfg = (model.extras[k] for k in ("item_processor", "vq_params", "vq_cfg"))
    rng = np.random.default_rng(12)
    # a smooth image with noise, in [-1, 1]
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([np.sin(6 * xx), np.cos(5 * yy), xx * yy * 2 - 1], -1)
    img = np.clip(img + 0.1 * rng.standard_normal(img.shape), -1, 1).astype(np.float32)
    times: dict = {}
    with time_block("encode", times):
        block = proc.process_image(img)
    grid = image_grid_from_block(block, mapping=model.extras["mapping"])
    with torch.no_grad():
        direct = encode(vq, vq_cfg, torch.from_numpy(img[None]).to(dev))[0].cpu().numpy()
        rows = torch.as_tensor(rng.choice(vq_cfg.n_embed, 512, replace=False), device=dev)
        own = codebook_encode(vq_cfg, vq["codebook"], vq["codebook"][rows].reshape(1, 1, 512, -1))
    own_ok = bool(torch.equal(own[0].long(), rows))
    f = size // 16
    header_ok = (block[1] == block[2] == size_token_id(size) and grid.shape == (f, f)
                 and len(block) == 3 + f * (f + 1) + 1)
    eng = model.engine
    table = per_forward(model.params, eng.model_cfg)
    eng.stats = GraphStats()
    _zero_launch_counts()
    with time_block("generate", times):
        out = model.extras["sample_i2i_fn"]("<|image|> the same scene at night", [img], 0)
    res = model.extras["last_result"]
    launches = _executed(eng)
    nfe = int(res.nfe)
    stats = GenerationStats.from_result(res, times["generate"])
    expected = {k: n * (nfe if k.startswith("quant") else nfe - 1) for k, n in table.items()}
    emit("image_input", image=[size, size], block_tokens=len(block),
         header=block[:3], grid=list(grid.shape), encode_s=times["encode"],
         grid_equals_direct_encode=bool(np.array_equal(grid.reshape(-1), direct)),
         codebook_rows_own_ids=own_ok, prompt_tokens=int(res.length[0]) - int(res.gen_count[0]),
         nfe=nfe, tokens_generated=stats.tokens, accept_rate=stats.accept_rate,
         wall_s=stats.wall_s, image_shape=list(out.shape), launches=launches,
         launches_expected=expected, captures=eng.stats.captures,
         graph_replays=eng.stats.replays)
    check(header_ok, f"the block's header {block[:3]} and grid {grid.shape} disagree")
    check(int(res.length[0]) - int(res.gen_count[0]) > len(block), "the prompt lacks the block")
    check(bool(np.array_equal(grid.reshape(-1), direct)), "the block's grid is not the encode")
    check(own_ok, "codebook rows did not encode to their own ids")
    check(tuple(out.shape) == (TARGET_SIZE, TARGET_SIZE, 3) and str(out.dtype) == "uint8",
          f"image is {out.shape} {out.dtype}")
    for name, n in launches.items():
        check(n == expected[name], f"{name}: {n} launches in image_input, not {expected[name]}")


def phase_stream(dev, model, size: int = 256, slots: int = 3, chunk_steps: int = 64):
    """StreamingBatcher on the checkpoint's W4A16 model: 6 requests at
    ``size`` px from 2 threads at staggered times, one prompt shorter than
    the bucket (left-padded), each with its own seed. Each request's tokens
    must equal the same request run alone with the same seed (W4A16 rows do
    not depend on the batch width). The launch counts start at 0 before the
    batcher and are read after its close: each kernel per forward (every
    forward here has T <= 32) times the forwards (prefills, refills, decode
    steps). Tokens per second is a smoke figure only."""
    import threading

    import numpy as np
    import torch

    from sjd_tpu_torch.core.serving import StreamingBatcher, seed_generators
    from sjd_tpu_torch.data.item_processor import size_token_id
    from sjd_tpu_torch.models.chameleon import IMAGE_END_ID, IMAGE_START_ID, lumina_engine

    tok = model.extras["item_processor"]
    header = [IMAGE_START_ID, size_token_id(size), size_token_id(size)]
    captions = ["a red fox", "a lighthouse at dusk", "three green apples", "a city in rain",
                "an old map", "a small boat"]
    prompts = [tok.t2i_prompt_ids(c, size) + header for c in captions]
    prompts[3] = prompts[3][4:]  # a short prompt: 11 tokens in a 15-token bucket
    width = max(map(len, prompts))
    seeds = [501 + i for i in range(6)]
    eng = lumina_engine(target_size=size, model_cfg=model.engine.model_cfg, device=dev)
    eng.config = dataclasses.replace(eng.config, eos_id=IMAGE_END_ID)
    table = per_forward(model.params, eng.model_cfg)
    _zero_launch_counts()
    handles = {}
    t0 = time.time()
    sb = StreamingBatcher(eng, model.params, batch=slots, chunk_steps=chunk_steps,
                          prompt_width=width)

    def client(which, delay):
        for k in which:
            time.sleep(delay)
            handles[k] = sb.submit(prompts[k], seed=seeds[k])

    threads = [threading.Thread(target=client, args=([0, 2, 4], 0.2)),
               threading.Thread(target=client, args=([1, 3, 5], 0.7))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    done = {k: h.wait(timeout=600) for k, h in handles.items()}
    stats = sb.stats()
    sb.close()
    serve_s = time.time() - t0
    launches = _executed(eng)
    forwards = eng.stats.eager_steps + eng.stats.replays + stats["batches"] + stats["refills"]
    same = {}
    for k in range(6):
        pad = width - len(prompts[k])
        ids = torch.tensor([[0] * pad + prompts[k]], dtype=torch.int32, device=dev)
        mask = torch.tensor([[False] * pad + [True] * len(prompts[k])], device=dev)
        alone = eng.generate(model.params, seed_generators([seeds[k]], dev), ids,
                             prompt_mask=mask)
        want = alone.tokens[0, :int(alone.length[0])].cpu().numpy()
        same[k] = bool(np.array_equal(want, done[k].tokens))
    gen_tokens = sum(d.gen_count for d in done.values())
    emit("stream", size=size, slots=slots, chunk_steps=chunk_steps, requests=6,
         prompt_width=width, prompt_lengths=[len(p) for p in prompts], seeds=seeds,
         stats=stats, gen_counts=[done[k].gen_count for k in range(6)],
         equal_to_solo=same, serve_s=serve_s, smoke_gen_tokens_per_s=gen_tokens / serve_s,
         forwards=forwards, launches=launches,
         launches_expected={k: n * forwards for k, n in table.items()},
         captures=eng.stats.captures, graph_replays=eng.stats.replays,
         eager_steps=eng.stats.eager_steps)
    check(sorted(done) == list(range(6)) and stats["completed"] == 6,
          f"not every request completed: {stats}")
    check(all(same.values()), f"requests differ from their solo runs: {same}")
    for name, n in launches.items():
        check(n == table[name] * forwards, f"{name}: {n} launches in stream for {forwards} "
                                           "forwards")
    del eng
    torch.cuda.empty_cache()


def phase_chameleon_34b(dev):
    """Chameleon-34B (48 layers, 64 query heads over 8 KV heads, d 8192, ff
    22016, swin-norm) at W4A16 on random weights, quantized leaf by leaf as
    drawn: both TPU kernels against their plain versions at its shapes
    (int8 cache, fills 150 and 2400), then phase_graph's check of 32
    replayed decode steps at 768px against 32 eager ones, with each
    kernel's launches per forward (48 of each TPU kernel, 337 of K1)."""
    import torch

    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.models.transformer import weight_bytes
    from sjd_tpu_torch.utils.profiling import time_block

    torch.cuda.reset_peak_memory_stats()
    times: dict = {}
    with time_block("load", times):
        model = load_lumina_mgpt(size="34B", quantize=4, target_size=TARGET_SIZE, device=dev)
    cfg = model.engine.model_cfg
    H, Hkv, NL = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    emit("chameleon_34b_load", load_s=times["load"], layers=NL, heads=H, kv_heads=Hkv,
         hidden=cfg.hidden_size, ff=cfg.intermediate_size, swin_norm=cfg.swin_norm,
         weight_bytes=weight_bytes(model.params),
         peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check((NL, H, Hkv, cfg.hidden_size, cfg.swin_norm) == (48, 64, 8, 8192, True),
          f"not the 34B config: {cfg}")
    S, L, P = 2, 2560, 15
    rows = [_epilogue_case(dev, "34b", S, L, (2400, 150), 21, H=H, Hkv=Hkv, NL=NL, layer=47)]
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    valid[1, :P - 1] = False
    rows += _attention_cases(dev, "34b", S, L, valid, [(150, 150), (2400, 2400)], ("int8",),
                             22, H=H, Hkv=Hkv, NL=NL, layer=47)
    ids = model.extras["prompt_ids_fn"](PROMPT)
    torch.cuda.reset_peak_memory_stats()
    phase_graph(dev, model.params, cfg, ids, label="chameleon_34b")
    emit("chameleon_34b_memory", peak_device_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# -- Emu3-Gen 8B at 720px and Anole-7B ----------------------------------------

EMU3_GRID = 90  # 720px at the VQ's factor 8
# rows of the 720px image's KV buffer: the generated 8318 and two windows
# past the 67-row negative prompt, rounded up to 512
EMU3_L = 8704


class Emu3Tok:
    """A tokenizer for the Emu3 phases: ``encode`` gives one text id (in
    [1000, 101000), below the special ids) per 4 characters from a hash of
    the whole text, so the default negative prompt (245 characters) is
    longer than a caption with its positive suffix."""

    def encode(self, text):
        import zlib

        return [1000 + zlib.crc32(f"{i}:{text}".encode()) % 100000
                for i in range(len(text) // 4 + 1)]


# Emu3-Gen 8B's attention: 32 query heads over 8 KV heads of 128 (group 4),
# 32 layers, no qk-norm
EMU3_HEADS = dict(H=32, Hkv=8, NL=32, layer=31)


def phase_epilogue_emu3(dev):
    """The epilogue at Emu3-Gen 8B's shapes with no qk-norm, over the 720px
    image's EMU3_L-row int8 buffer, into the last layer. Returns the
    kernel's row."""
    ep = _epilogue_case(dev, "emu3", 2, EMU3_L, (8190, 40), 31, qk_norm=False, **EMU3_HEADS)
    return dict(name="fused_epilogue", case="emu3", route="cuda",
                source="sjd_tpu_torch/csrc/fused_epilogue.cu",
                replaces="sjd_tpu/ops/fused_epilogue.py:35",
                max_abs_err=max(ep["max_abs_err"].values()), ms=ep["ms"],
                plain_ms=ep["plain_ms"], bound_ms=ep["bound_ms"], bound_by=ep["bound_by"],
                library_ms=None)


def phase_attention_emu3(dev):
    """The attention at GQA group 4 over the 720px image's EMU3_L-row buffer
    at fills 150, 4000 and 8190, int8 (the phases below) and bf16 (the
    loader's default), the negative prompt's half left-padded by 4 rows.
    Returns the kernel's row (int8, fill 8190's numbers)."""
    import torch

    valid = torch.ones((2, EMU3_L), dtype=torch.bool, device=dev)
    valid[1, :4] = False
    att = _attention_cases(dev, "emu3", 2, EMU3_L, valid, [(f, f) for f in (150, 4000, 8190)],
                           ("int8", "bf16"), 32, **EMU3_HEADS)
    main = next(r for r in att if r["cache"] == "int8" and r["fill"][0] == 8190)
    return dict(name="decode_attention", case="emu3", route="cuda",
                source="sjd_tpu_torch/csrc/decode_attention.cu",
                replaces="sjd_tpu/ops/decode_attention.py:38",
                max_abs_err=max(r["max_abs_err"] for r in att), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"])


def phase_emu3_load(dev):
    """Emu3-Gen 8B through load_emu3(quantize=4, kv_quant=True) at full width
    and depth: random weights drawn a layer at a time and quantized as drawn
    (packed int4 projections, int8 head, no equilibration), the int8 cache
    (the loader's default is bf16), the random Emu3VisionVQ at its full
    widths, the duck tokenizer, init="repeat_horizon"."""
    import torch

    from sjd_tpu_torch.loader import load_emu3
    from sjd_tpu_torch.models.transformer import weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = load_emu3(quantize=4, tokenizer=Emu3Tok(), init="repeat_horizon", kv_quant=True,
                      device=dev)
    torch.cuda.synchronize()
    cfg = model.engine.model_cfg
    wq, head = model.params["layers"]["wq"], model.params["lm_head"]
    vq_bytes = weight_bytes(model.extras["vq_params"])
    emit("emu3_load", seconds=time.time() - t0, layers=cfg.num_layers, hidden=cfg.hidden_size,
         ff=cfg.intermediate_size, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         vocab=cfg.vocab_size, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
         kv_quant=cfg.kv_quant, weight_bytes=weight_bytes(model.params), vq_bytes=vq_bytes,
         wq_leaf=sorted(wq), lm_head_leaf=sorted(head),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         smoke_reasons=model.extras["smoke_reasons"])
    check((cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
           cfg.num_kv_heads, cfg.vocab_size, cfg.rope_theta, cfg.qk_norm, cfg.kv_quant)
          == (32, 4096, 14336, 32, 8, 184622, 1e6, False, True), f"not the 8B config: {cfg}")
    check(set(wq) == {"q4p", "s"} and set(head) == {"q", "s"}, "not W4A16 with an int8 head")
    return model


def phase_emu3_forward(dev, model):
    """The kernel forward against the plain forward at Emu3's widths: on the
    loaded W4A16 weights at full depth, and on random bf16 weights at full
    width cut to 2 layers (full depth on bf16 would be a second 16 GB
    draw); both within phase_forward's 5%."""
    import torch

    from sjd_tpu_torch.models import transformer as pt

    cfg = model.engine.model_cfg
    bf16_cfg = dataclasses.replace(cfg, num_layers=2)
    for label, c, params in (("w4a16", cfg, model.params),
                             ("bf16_2_layers", bf16_cfg, None)):
        if params is None:
            params = pt.init_params(5, c, device=dev)
        logits, launched = _forward_pair(dev, c, params)
        err = (logits[0] - logits[1]).abs().max().item()
        scale = logits[1].abs().max().item()
        ok = math.isfinite(err) and err <= 0.05 * scale
        want = 2 * (7 * c.num_layers + 1) if label == "w4a16" else 0
        emit("emu3_forward", weights=label, layers=c.num_layers, max_abs_err=err,
             max_abs_logit=scale, tolerance=0.05 * scale, ok=ok, launches=launched)
        check(ok, f"Emu3 {label} kernel forward disagrees with the plain forward")
        check(launched["auto"]["quant_linear_a16"] == want
              and launched["auto"]["decode_attention"] == 2 * c.num_layers,
              f"Emu3 {label}: launches {launched}")
        del params, logits
        torch.cuda.empty_cache()


def phase_emu3_generate(dev, model):
    """One 720px image through load_emu3's sample_fn: a 90 x 90 grid, CFG 3.0
    against the negative prompt, window 16, init="repeat_horizon", on the
    graph path. Holds the image's shape, the grammar's offsets (<eol> after
    each of the 90 rows, then eof, <|image end|>, eos) and the launches: each
    kernel per forward as per_forward() says (the prefill of the 67-row
    negative prompt takes the plain path: no TPU kernel there)."""
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.models import emu3
    from sjd_tpu_torch.models.transformer import KERNEL_MAX_T, weight_bytes
    from sjd_tpu_torch.ops import launch_counts

    eng, ex = model.engine, model.extras
    cfg = eng.model_cfg
    table = per_forward(model.params, cfg)
    ids, neg = ex["prompt_ids_fn"](PROMPT), ex["neg_ids_fn"]()
    long_prefill = max(len(ids), len(neg)) > KERNEL_MAX_T
    torch.cuda.reset_peak_memory_stats()
    eng.stats = GraphStats()
    _zero_launch_counts()
    t0 = time.time()
    img = model.sample_fn(PROMPT, 0)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = eng.stats.executed(launch_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = ex["last_result"]
    n = int(res.length[0])
    toks = res.tokens[0, :n].tolist()
    gen = toks[n - int(res.gen_count[0]):]
    t0 = time.time()
    again = ex["decode_image_fn"](toks)
    torch.cuda.synchronize()
    vq_s = time.time() - t0
    nfe = int(res.nfe)
    g = EMU3_GRID
    end = g * (g + 1)
    eols = [gen[r * (g + 1) + g] if len(gen) > r * (g + 1) + g else None for r in range(g)]
    tail = gen[end:end + 3]
    visual = all(emu3.VISUAL_START <= gen[r * (g + 1) + c] <= emu3.VISUAL_END
                 for r in range(g) for c in range(g)) if len(gen) >= end else False
    expected = {k: v * (nfe - (1 if long_prefill and not k.startswith("quant") else 0))
                for k, v in table.items()}
    kv_rows = eng._state.kv.k.shape[2]
    emit("emu3_generate", grid=[g, g], prompt_tokens=len(ids), neg_prompt_tokens=len(neg),
         tokens_generated=int(res.gen_count[0]), nfe=nfe,
         tokens_per_forward=int(res.gen_count[0]) / nfe,
         accept_hist=res.accept_hist.tolist(), wall_s=wall_s, vq_decode_s=vq_s,
         ms_per_forward=1e3 * (wall_s - vq_s) / nfe, peak_mem_gb=peak,
         weight_bytes=weight_bytes(model.params), kv_buffer_rows=kv_rows,
         image_shape=list(img.shape), image_dtype=str(img.dtype),
         eol_rows=sum(t == emu3.EOL_ID for t in eols), tail=tail, rows_visual=visual,
         launches=launches, launches_expected=expected, captures=eng.stats.captures,
         graph_replays=eng.stats.replays, eager_steps=eng.stats.eager_steps,
         capture_s=eng.stats.capture_s)
    check(tuple(img.shape) == (8 * g, 8 * g, 3) and str(img.dtype) == "uint8",
          f"image is {img.shape} {img.dtype}")
    check((img == again).all(), "a second VQ decode of the same tokens differs")
    check(all(t == emu3.EOL_ID for t in eols), f"<eol> missing at a row end: {eols[:5]}...")
    check(tail == [emu3.EOF_ID, emu3.EOI_ID, emu3.EOS_ID], f"the image ends {tail}")
    check(visual, "a non-visual token inside the grid")
    check(kv_rows == EMU3_L, f"the KV buffer has {kv_rows} rows, the kernel phases {EMU3_L}")
    check(eng.stats.captures >= 1 and eng.stats.replays > 0, f"graph path idle: {eng.stats}")
    for name, k in launches.items():
        check(k > 0 or table[name] == 0, f"{name} was never launched on the Emu3 path")
        check(k == expected[name], f"{name}: {k} launches for {nfe} forwards, not "
                                   f"{expected[name]}")
    return launches


def phase_emu3_understand(dev, model):
    """Image understanding once at full size: a 720px image through the
    Emu3VisionVQ encoder into the left-padded 8318-row prompt bucket (the
    image's 90 x 91 rows and the chat text), prefilled on the plain path
    in blocks of ATTEND_BLOCK_ROWS query rows, then a short answer."""
    import numpy as np
    import torch

    from sjd_tpu_torch.models.transformer import ATTEND_BLOCK_ROWS

    g = EMU3_GRID
    yy, xx = np.mgrid[0:8 * g, 0:8 * g] / (8 * g)
    img = np.stack([np.sin(6 * xx), np.cos(5 * yy), xx * yy * 2 - 1], -1).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    t0 = time.time()
    ans = model.extras["understand_fn"]("describe this picture", img, 0, max_new_tokens=32)
    torch.cuda.synchronize()
    secs = time.time() - t0
    res = model.extras["last_understand_result"]
    bucket = int(res.length[0]) - len(ans)
    emit("emu3_understand", seconds=secs, prompt_bucket=bucket, answer_tokens=len(ans),
         nfe=int(res.nfe), block_rows=ATTEND_BLOCK_ROWS, held_before_gb=held,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(bucket == g * (g + 1) + 128, f"prompt bucket {bucket}")
    check(len(ans) >= 1 and all(0 <= t < model.engine.model_cfg.vocab_size for t in ans),
          f"answer {ans[:8]}")


def phase_anole(dev):
    """Anole-7B through load_anole(quantize=4, kv_quant=True) on random
    weights (the int8 cache; the loader's default is bf16): one
    image-only 512px image (1024 image tokens, then <eoi>) on the graph
    path with each kernel's launches per forward; a short interleaved run
    on the same weights; encode_image_fn on a 512px image against a direct
    VQ encode, decoded back through decode_image_fn."""
    import numpy as np
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.data.vocab_translation import img_to_bpe
    from sjd_tpu_torch.loader import load_anole
    from sjd_tpu_torch.models import anole
    from sjd_tpu_torch.models.transformer import weight_bytes
    from sjd_tpu_torch.models.vq import encode as vq_encode
    from sjd_tpu_torch.ops import launch_counts

    t0 = time.time()
    model = load_anole(quantize=4, kv_quant=True, device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    eng, ex = model.engine, model.extras
    cfg = eng.model_cfg
    table = per_forward(model.params, cfg)
    torch.cuda.reset_peak_memory_stats()
    eng.stats = GraphStats()
    _zero_launch_counts()
    t0 = time.time()
    img = model.sample_fn(PROMPT, 0)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = eng.stats.executed(launch_counts())
    res = ex["last_result"]
    nfe, n = int(res.nfe), int(res.length[0])
    ids = ex["prompt_ids_fn"](PROMPT)
    gen = res.tokens[0, len(ids):n].tolist()
    isl = eng.image_seq_length
    emit("anole", mode="image-only", load_s=load_s, weight_bytes=weight_bytes(model.params),
         prompt_tokens=len(ids), tokens_generated=int(res.gen_count[0]), nfe=nfe,
         tokens_per_forward=int(res.gen_count[0]) / nfe, accept_hist=res.accept_hist.tolist(),
         wall_s=wall_s, ms_per_forward=1e3 * wall_s / nfe,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, image_shape=list(img.shape),
         launches=launches, launches_expected={k: v * nfe for k, v in table.items()},
         captures=eng.stats.captures, graph_replays=eng.stats.replays)
    check(tuple(img.shape) == (512, 512, 3) and str(img.dtype) == "uint8",
          f"image is {img.shape} {img.dtype}")
    check(ids[-1] == anole.BOI_ID and len(gen) > isl and gen[isl] == anole.EOI_ID
          and all(anole.IMAGE_VOCAB_START <= t <= anole.IMAGE_VOCAB_END for t in gen[:isl]),
          f"not {isl} image tokens and <eoi>: {gen[isl - 2:isl + 2]}")
    for name, k in launches.items():
        check(k == table[name] * nfe, f"{name}: {k} launches in anole for {nfe} forwards")

    # interleaved: no <boi> in the prompt, text allowed outside images
    ieng = anole.anole_engine(multimodal_generation_mode="interleaved", max_len=48,
                              model_cfg=cfg, device=dev)
    t0 = time.time()
    ires = ieng.generate(model.params, 1, torch.tensor([ids[:-1]], device=dev))
    torch.cuda.synchronize()
    igen = ires.tokens[0, len(ids) - 1:int(ires.length[0])].tolist()
    opened = anole.BOI_ID in igen
    stray = sum(anole.IMAGE_VOCAB_START <= t <= anole.IMAGE_VOCAB_END or t == anole.EOI_ID
                for t in (igen if not opened else igen[:igen.index(anole.BOI_ID)]))
    emit("anole_interleaved", tokens_generated=int(ires.gen_count[0]), nfe=int(ires.nfe),
         seconds=time.time() - t0, opened_image=opened, image_tokens_outside_an_image=stray)
    check(int(ires.gen_count[0]) >= 1 and stray == 0,
          f"interleaved: {stray} image tokens outside an image")
    del ieng

    # encode_image_fn on a 512px image
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:512, 0:512] / 512
    arr = np.stack([np.cos(4 * xx), np.sin(7 * yy), xx - yy], -1)
    arr = np.clip(arr + 0.1 * rng.standard_normal(arr.shape), -1, 1).astype(np.float32)
    t0 = time.time()
    bpe = ex["encode_image_fn"](arr)
    torch.cuda.synchronize()
    enc_s = time.time() - t0
    with torch.no_grad():
        direct = vq_encode(ex["vq_params"], ex["vq_cfg"],
                           torch.from_numpy(arr[None]).to(dev))[0].cpu().numpy()
    same = bpe == img_to_bpe(ex["mapping"], direct.astype(np.int32)).tolist()
    back = ex["decode_image_fn"]([anole.BOI_ID] + bpe + [anole.EOI_ID])
    emit("anole_encode", image=[512, 512], tokens=len(bpe), encode_s=enc_s,
         equals_direct_encode=same, decoded_shape=list(back.shape))
    check(len(bpe) == isl and same, "encode_image_fn disagrees with the VQ encode")
    check(tuple(back.shape) == (512, 512, 3), f"decoded {back.shape}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# LlamaGen GPT-XL: 20 heads of 64 (MHA), 36 layers, no qk-norm, bf16 cache
# (the JAX default); a 512px image (32 x 32 latents) behind the 120 caption
# rows: 1024 + 2 x 16 + 120 rows, rounded up to 512 with the window's
LLAMAGEN_HEADS = dict(H=20, Hkv=20, NL=36, layer=35, D=64)
LLAMAGEN_L = 1536
LLAMAGEN_CAPTION = "a photo of a red fox in the snow at dawn"
# the stub tokenizer's rows for that caption: 11 words and </s>, so 108 of
# the 120 caption rows are left padding, masked in the cond half
LLAMAGEN_PAD = 108


class T5Tok:
    """A tokenizer for the LlamaGen phases, called as HF's T5 tokenizer is:
    one id per word (in [2, 32128), from a hash), then </s> (1),
    right-padded with 0 to ``max_length``."""

    def __call__(self, texts, max_length, padding, truncation, return_tensors):
        import zlib

        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for b, text in enumerate(texts):
            toks = [2 + zlib.crc32(w.encode()) % 32126 for w in text.split()]
            toks = toks[:max_length - 1] + [1]
            ids[b, :len(toks)] = toks
            mask[b, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def phase_epilogue_llamagen(dev):
    """The epilogue at GPT-XL's shapes (heads of 64, no qk-norm) into the
    512px image's LLAMAGEN_L-row cache's last layer, on the 2-D table's
    rows at each sample's fill (fill 100 lies in the caption rows, which do
    not rotate): bf16 at fills (1140, 100) and (150, 600), int8 at (1140,
    100). Returns the kernel's row (bf16, (1140, 100))."""
    import torch

    from sjd_tpu_torch.models.llamagen import llamagen_config
    from sjd_tpu_torch.models.transformer import make_rope_table

    table = make_rope_table(llamagen_config("GPT-XL", block_size=1024, cls_token_num=120),
                            LLAMAGEN_L, device=dev)
    rows = []
    for kind, ends in (("bf16", (1140, 100)), ("bf16", (150, 600)), ("int8", (1140, 100))):
        pos = torch.tensor(ends, device=dev)[:, None] + torch.arange(16, device=dev)
        rope = (table[pos, 0].contiguous(), table[pos, 1].contiguous())
        rows.append(_epilogue_case(dev, "llamagen", 2, LLAMAGEN_L, ends, 40 + len(rows),
                                   qk_norm=False, quantize=kind == "int8", rope=rope,
                                   **LLAMAGEN_HEADS))
    main = rows[0]
    return dict(name="fused_epilogue", case="llamagen", route="cuda",
                source="sjd_tpu_torch/csrc/fused_epilogue.cu",
                replaces="sjd_tpu/ops/fused_epilogue.py:35",
                max_abs_err=max(max(r["max_abs_err"].values()) for r in rows), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None)


def phase_attention_llamagen(dev):
    """The attention at GPT-XL's shapes (MHA, 20 heads of 64) over the 512px
    image's LLAMAGEN_L-row buffer, the cond half's caption left-padded by
    LLAMAGEN_PAD rows, at fills 150, 600 and 1140 (the last window of the
    image), bf16 (the main path's cache) and int8. Returns the kernel's row
    (bf16, fill 1140)."""
    import torch

    valid = torch.ones((2, LLAMAGEN_L), dtype=torch.bool, device=dev)
    valid[0, :LLAMAGEN_PAD] = False
    att = _attention_cases(dev, "llamagen", 2, LLAMAGEN_L, valid,
                           [(f, f) for f in (150, 600, 1140)], ("bf16", "int8"), 41,
                           **LLAMAGEN_HEADS)
    main = next(r for r in att if r["cache"] == "bf16" and r["fill"][0] == 1140)
    return dict(name="decode_attention", case="llamagen", route="cuda",
                source="sjd_tpu_torch/csrc/decode_attention.cu",
                replaces="sjd_tpu/ops/decode_attention.py:38",
                max_abs_err=max(r["max_abs_err"] for r in att), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"])


def phase_llamagen_load(dev):
    """LlamaGen GPT-XL t2i through load_llamagen at full width and depth on
    random weights: the GPT (36 layers, d 1280, 20 heads of 64, ff 3584,
    vocab 16384, 2-D RoPE over 120 caption rows and a 32 x 32 grid) in bf16
    with a bf16 cache, its caption embedder, the VQ-16 decoder, and the T5
    encoder at flan-t5-xl's widths (24 layers, d 2048, 32 heads of 64, ff
    5120, vocab 32128, f32) behind the stub tokenizer. Then the caption's
    T5 encode, timed after one untimed run."""
    import numpy as np
    import torch

    from sjd_tpu_torch.loader import load_llamagen
    from sjd_tpu_torch.models.t5 import T5EncoderConfig
    from sjd_tpu_torch.models.transformer import weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = load_llamagen(name="GPT-XL", model_type="t2i", latent_size=32,
                          t5_tokenizer=T5Tok(), device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    cfg, t5 = model.engine.model_cfg, model.extras["t5"]
    t5.get_text_embeddings([LLAMAGEN_CAPTION])
    torch.cuda.synchronize()
    t0 = time.time()
    feats, mask = t5.get_text_embeddings([LLAMAGEN_CAPTION])
    torch.cuda.synchronize()
    t5_s = time.time() - t0
    emit("llamagen_load", seconds=load_s, layers=cfg.num_layers, hidden=cfg.hidden_size,
         ff=cfg.intermediate_size, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.head_dim, vocab=cfg.vocab_size, rope_style=cfg.rope_style,
         rope_2d=[cfg.rope_2d_cls_len, cfg.rope_2d_grid_side], kv_quant=cfg.kv_quant,
         weight_bytes=weight_bytes(model.params), t5_bytes=weight_bytes(t5.params),
         vq_bytes=weight_bytes(model.extras["vq_params"]),
         cond_bytes=weight_bytes({k: v for k, v in model.extras["cond"].items()
                                  if k != "kind"}),
         t5_encode_s=t5_s, caption_rows=int(mask.sum()), t5_feature_shape=list(feats.shape),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         smoke_reasons=model.extras["smoke_reasons"])
    check((cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
           cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size, cfg.rope_style,
           cfg.rope_2d_cls_len, cfg.rope_2d_grid_side, cfg.kv_quant)
          == (36, 1280, 3584, 20, 20, 64, 16384, "2d", 120, 32, False),
          f"not the GPT-XL 512px t2i config: {cfg}")
    check(t5.config == T5EncoderConfig(), f"not flan-t5-xl's widths: {t5.config}")
    check(feats.shape == (1, 120, 2048) and bool(np.isfinite(feats).all())
          and int(mask.sum()) == 120 - LLAMAGEN_PAD, f"T5 features {feats.shape}, mask "
          f"{int(mask.sum())} rows")
    model.extras["t5_encode_s"] = t5_s
    return model


def phase_llamagen_forward(dev, model):
    """The kernel forward against the plain forward on GPT-XL's bf16
    weights at full depth (both TPU kernels at heads of 64, the 2-D table),
    within phase_forward's 5%."""
    cfg = model.engine.model_cfg
    logits, launched = _forward_pair(dev, cfg, model.params)
    err = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    ok = math.isfinite(err) and err <= 0.05 * scale
    emit("llamagen_forward", layers=cfg.num_layers, head_dim=cfg.head_dim, max_abs_err=err,
         max_abs_logit=scale, tolerance=0.05 * scale, ok=ok, launches=launched)
    check(ok, "GPT-XL kernel forward disagrees with the plain forward")
    check(launched["auto"]["decode_attention"] == 2 * cfg.num_layers
          and launched["plain"]["decode_attention"] == 0, f"GPT-XL launches {launched}")


def phase_llamagen_generate(dev, model):
    """One 512px image through load_llamagen's sample_fn on the graph path:
    the caption through T5 and the caption embedder, CFG 7.5 against the
    uncond caption, window 16, top-k 1000, then the VQ-16 decode. Holds the
    image, its 1024 image tokens and each TPU kernel's launches: 36 per
    decode forward (the 120-row prefill takes the plain path). ms per
    forward leaves out the T5 encode and the VQ decode, timed apart."""
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.models.llamagen import VOCAB_SIZE
    from sjd_tpu_torch.models.transformer import KERNEL_MAX_T, weight_bytes
    from sjd_tpu_torch.ops import launch_counts

    eng, ex = model.engine, model.extras
    cfg = eng.model_cfg
    table = per_forward(model.params, cfg)
    torch.cuda.reset_peak_memory_stats()
    eng.stats = GraphStats()
    _zero_launch_counts()
    t0 = time.time()
    img = model.sample_fn(LLAMAGEN_CAPTION, 0)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = eng.stats.executed(launch_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = ex["last_result"]
    n, nfe = int(res.length[0]), int(res.nfe)
    toks = res.tokens[0, :n].tolist()
    gen = toks[ex["prompt_width"]:]
    t0 = time.time()
    again = ex["decode_image_fn"](toks)
    torch.cuda.synchronize()
    vq_s = time.time() - t0
    long_prefill = ex["prompt_width"] > KERNEL_MAX_T
    expected = {k: v * (nfe - (1 if long_prefill and not k.startswith("quant") else 0))
                for k, v in table.items()}
    kv_rows = eng._state.kv.k.shape[2]
    emit("llamagen_t2i", size=512, caption_rows=ex["prompt_width"],
         tokens_generated=int(res.gen_count[0]), nfe=nfe,
         tokens_per_forward=int(res.gen_count[0]) / nfe,
         accept_hist=res.accept_hist.tolist(), wall_s=wall_s, vq_decode_s=vq_s,
         t5_encode_s=ex["t5_encode_s"],
         ms_per_forward=1e3 * (wall_s - vq_s - ex["t5_encode_s"]) / nfe, peak_mem_gb=peak,
         weight_bytes=weight_bytes(model.params), kv_buffer_rows=kv_rows,
         kv_dtype=str(eng._state.kv.k.dtype), image_shape=list(img.shape),
         image_dtype=str(img.dtype), launches=launches, launches_expected=expected,
         captures=eng.stats.captures, graph_replays=eng.stats.replays,
         eager_steps=eng.stats.eager_steps, capture_s=eng.stats.capture_s)
    check(tuple(img.shape) == (512, 512, 3) and str(img.dtype) == "uint8",
          f"image is {img.shape} {img.dtype}")
    check((img == again).all(), "a second VQ decode of the same tokens differs")
    check(len(gen) == 1024 and int(res.gen_count[0]) == 1024
          and all(0 <= t < VOCAB_SIZE for t in gen), f"{len(gen)} image tokens")
    check(kv_rows == LLAMAGEN_L and eng._state.kv.k_scale is None,
          f"the KV buffer has {kv_rows} rows (the kernel phases {LLAMAGEN_L}), "
          f"{eng._state.kv.k.dtype}")
    check(eng.stats.captures >= 1 and eng.stats.replays > 0, f"graph path idle: {eng.stats}")
    for name, k in launches.items():
        check(k > 0 or table[name] == 0, f"{name} was never launched on the LlamaGen path")
        check(k == expected[name], f"{name}: {k} launches for {nfe} forwards, not "
                                   f"{expected[name]}")
    return launches


def phase_llamagen_bench(dev, model):
    """bench.py:bench_llamagen's row on the card: GPT-XL t2i at 256px (256
    tokens) from 120 rows of seeded stand-in T5 features, CFG 7.5, window
    16, top-k 1000, bf16, SJD and then AR (window 1) on the same weights;
    each a warm-up run (seed 0: the graph's capture), then a timed one
    (seed 1)."""
    import torch

    from sjd_tpu_torch.models.llamagen import embed_caption, embed_uncond_caption
    from sjd_tpu_torch.models.llamagen import llamagen_engine

    cond = model.extras["cond"]
    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn((1, 120, 2048), generator=g, device=dev)
    kw = dict(prompt_embeds=embed_caption(cond, feats, torch.bfloat16),
              neg_prompt_embeds=embed_uncond_caption(cond, 1, torch.bfloat16))
    out = {}
    for label, window in (("sjd", 16), ("ar", 1)):
        eng = llamagen_engine(name="GPT-XL", latent_size=16, cls_token_num=120, window=window,
                              device=dev)
        eng.generate(model.params, 0, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        res = eng.generate(model.params, 1, **kw)
        torch.cuda.synchronize()
        latency = time.time() - t0
        out[label] = dict(latency_s=latency, nfe=int(res.nfe),
                          tokens=int(res.gen_count[0]), ms_per_forward=1e3 * latency / res.nfe,
                          accept_hist=res.accept_hist.tolist(), captures=eng.stats.captures)
        del eng
        torch.cuda.empty_cache()
    sjd, ar = out["sjd"], out["ar"]
    emit("llamagen_bench", name="GPT-XL", size=256, mode="t2i", tokens=sjd["tokens"],
         latency_s=sjd["latency_s"], nfe=sjd["nfe"], ms_per_forward=sjd["ms_per_forward"],
         accept_hist=sjd["accept_hist"], ar_latency_s=ar["latency_s"], ar_nfe=ar["nfe"],
         ar_ms_per_forward=ar["ms_per_forward"],
         step_reduction_vs_ar=ar["nfe"] / sjd["nfe"], latency_vs_ar=ar["latency_s"]
         / sjd["latency_s"], captures=[sjd["captures"], ar["captures"]])
    check(sjd["tokens"] == ar["tokens"] == 256, f"tokens {sjd['tokens']}, {ar['tokens']}")
    check(ar["nfe"] == ar["tokens"] and sjd["nfe"] < ar["nfe"],
          f"NFE: SJD {sjd['nfe']}, AR {ar['nfe']}")


def phase_llamagen_stream(dev, model, chunk_steps: int = 64):
    """StreamingBatcher in embedding mode: 3 captions (of 5, 9 and 2 words)
    through the T5 encoder and the caption embedder, submitted as host rows
    to 2 slots at 256px on W4A16 weights (quantized on the card from the
    bf16 GPT: its rows do not depend on the batch width), chunks of 64, one
    refill. Each request's tokens must equal the same request run alone
    with the same seed. Launches: each TPU kernel per decode forward, the
    quantized products per forward (the 120-row prefills and refills take
    the plain path otherwise). The batch is captured once: the refill
    changes its state in place."""
    import numpy as np
    import torch

    from sjd_tpu_torch.core.serving import StreamingBatcher, seed_generators
    from sjd_tpu_torch.models.llamagen import llamagen_engine
    from sjd_tpu_torch.models.transformer import quantize_weights

    params = quantize_weights(model.params, bits=4, head_bits=8, equilibrate=False)
    eng = llamagen_engine(name="GPT-XL", latent_size=16, cls_token_num=120, device=dev)
    captions = ["a lighthouse at dusk in winter", "three green apples on a wooden table "
                "beside a window", "old map"]
    seeds = [601, 602, 603]
    reqs = []
    for c in captions:
        pe, ne, mask = model.extras["embed_prompt_fn"](c)
        reqs.append((pe[0].cpu(), ne[0].cpu(), mask[0].cpu()))
    torch.cuda.synchronize()
    table = per_forward(params, eng.model_cfg)
    _zero_launch_counts()
    t0 = time.time()
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=chunk_steps, prompt_width=120,
                          embed_dim=eng.model_cfg.hidden_size)
    handles = [sb.submit(prompt_embeds=pe, neg_prompt_embeds=ne, prompt_mask=m, seed=sd)
               for (pe, ne, m), sd in zip(reqs, seeds)]
    done = [h.wait(timeout=600) for h in handles]
    stats = sb.stats()
    sb.close()
    serve_s = time.time() - t0
    launches = _executed(eng)
    stream_captures = eng.stats.captures
    decode = eng.stats.eager_steps + eng.stats.replays
    prefills = stats["batches"] + stats["refills"]
    expected = {k: n * (decode + (prefills if k.startswith("quant") else 0))
                for k, n in table.items()}
    same = []
    for (pe, ne, m), sd, d in zip(reqs, seeds, done):
        alone = eng.generate(params, seed_generators([sd], dev), prompt_embeds=pe[None].to(dev),
                             neg_prompt_embeds=ne[None].to(dev), prompt_mask=m[None].to(dev))
        same.append(bool(np.array_equal(alone.tokens[0, :int(alone.length[0])].cpu().numpy(),
                                        d.tokens)))
    emit("llamagen_stream", size=256, slots=2, chunk_steps=chunk_steps, requests=3,
         caption_rows=[int(m.sum()) for _, _, m in reqs], seeds=seeds, stats=stats,
         gen_counts=[d.gen_count for d in done], equal_to_solo=same, serve_s=serve_s,
         decode_forwards=decode, prefills=prefills, launches=launches,
         launches_expected=expected, stream_captures=stream_captures,
         captures=eng.stats.captures, graph_replays=eng.stats.replays)
    check(stats["completed"] == 3 and all(d.gen_count == 256 for d in done),
          f"not every request completed: {stats}")
    # the refill re-arms a slot under the captured step: no second capture
    check(stats["refills"] >= 1 and stream_captures == 1,
          f"{stream_captures} captures for {stats['refills']} refills")
    check(all(same), f"requests differ from their solo runs: {same}")
    for name, n in launches.items():
        check(n == expected[name], f"{name}: {n} launches in llamagen_stream, not "
                                   f"{expected[name]}")
    del eng, params
    torch.cuda.empty_cache()


def phase_llamagen_c2i(dev):
    """LlamaGen GPT-XL c2i at 256px through load_llamagen(quantize=4): W4A16
    projections (K1 at d 1280: 1280 x 1280, 3584 x 1280, 1280 x 3584) and
    the int8 head (16384 x 1280). The kernel forward within 5% of the
    plain one, then one image of class 207 with every kernel's launches per
    forward (the one-row prefill takes the kernels too)."""
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.loader import load_llamagen
    from sjd_tpu_torch.models.llamagen import VOCAB_SIZE
    from sjd_tpu_torch.models.transformer import weight_bytes
    from sjd_tpu_torch.ops import launch_counts

    t0 = time.time()
    model = load_llamagen(name="GPT-XL", model_type="c2i", latent_size=16, quantize=4,
                          device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    eng, ex = model.engine, model.extras
    cfg = eng.model_cfg
    wq, head = model.params["layers"]["wq"], model.params["lm_head"]
    check(set(wq) == {"q4p", "s"} and set(head) == {"q", "s"}, "not W4A16 with an int8 head")
    logits, launched = _forward_pair(dev, cfg, model.params)
    err = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    fwd_ok = math.isfinite(err) and err <= 0.05 * scale
    table = per_forward(model.params, cfg)
    torch.cuda.reset_peak_memory_stats()
    eng.stats = GraphStats()
    _zero_launch_counts()
    t0 = time.time()
    img = model.sample_fn(207, 0)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = eng.stats.executed(launch_counts())
    res = ex["last_result"]
    nfe = int(res.nfe)
    gen = res.tokens[0, 1:int(res.length[0])].tolist()
    emit("llamagen_c2i", size=256, label=207, load_s=load_s,
         weight_bytes=weight_bytes(model.params), forward_max_abs_err=err,
         forward_max_abs_logit=scale, forward_ok=fwd_ok, forward_launches=launched,
         tokens_generated=int(res.gen_count[0]), nfe=nfe,
         accept_hist=res.accept_hist.tolist(), wall_s=wall_s, ms_per_forward=1e3 * wall_s / nfe,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, image_shape=list(img.shape),
         launches=launches, launches_expected={k: v * nfe for k, v in table.items()},
         captures=eng.stats.captures, graph_replays=eng.stats.replays)
    check(fwd_ok, "GPT-XL W4A16 kernel forward disagrees with the plain forward")
    check(launched["auto"]["quant_linear_a16"] == 2 * (7 * cfg.num_layers + 1),
          f"GPT-XL W4A16 forward launches {launched}")
    check(tuple(img.shape) == (256, 256, 3) and str(img.dtype) == "uint8",
          f"image is {img.shape} {img.dtype}")
    check(len(gen) == 256 and all(0 <= t < VOCAB_SIZE for t in gen), f"{len(gen)} tokens")
    for name, k in launches.items():
        check(k == table[name] * nfe and (k > 0 or table[name] == 0),
              f"{name}: {k} launches in llamagen_c2i for {nfe} forwards")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# LlamaGen GPT-3B c2i at 384px: 32 heads of 100 (MHA), 24 layers, one class
# row and a 24 x 24 grid (576 tokens), bf16 weights and cache; the engine's
# buffer, 1 + 576 + 2 x 16 rows and the window's, rounded up to 512
LLAMAGEN_3B_HEADS = dict(H=32, Hkv=32, NL=24, layer=23, D=100)
LLAMAGEN_3B_L = 1024
LLAMAGEN_3B_CLASS = 207


def _llamagen_3b_engine(dev, cfg, **kw):
    from sjd_tpu_torch.models.llamagen import llamagen_engine

    return llamagen_engine(name="GPT-3B", latent_size=24, cls_token_num=1, model_cfg=cfg,
                           device=dev, **kw)


def _kernel_row(row: dict, **fields) -> dict:
    """A kernel case's entry of the ``kernels`` line."""
    keep = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "bound_share")
    return dict(fields, **{k: row[k] for k in keep}, library_ms=row.get("library_ms"))


def phase_epilogue_llamagen_3b(dev):
    """The epilogue at GPT-3B's shapes (heads of 100, no qk-norm: the
    kernel's lane mapping for D % 64 != 0) into the 384px c2i buffer's last
    layer, on the 2-D table's rows (cls 1, grid 24): bf16 at fills (600, 1)
    and (150, 400), int8 at (600, 1). Returns the kernel's row (bf16,
    (600, 1))."""
    import torch

    from sjd_tpu_torch.models.llamagen import llamagen_config
    from sjd_tpu_torch.models.transformer import make_rope_table

    table = make_rope_table(llamagen_config("GPT-3B", block_size=576, cls_token_num=1),
                            LLAMAGEN_3B_L, device=dev)
    rows = []
    for kind, ends in (("bf16", (600, 1)), ("bf16", (150, 400)), ("int8", (600, 1))):
        pos = torch.tensor(ends, device=dev)[:, None] + torch.arange(16, device=dev)
        rope = (table[pos, 0].contiguous(), table[pos, 1].contiguous())
        rows.append(_epilogue_case(dev, "llamagen_3b", 2, LLAMAGEN_3B_L, ends, 50 + len(rows),
                                   qk_norm=False, quantize=kind == "int8", rope=rope,
                                   **LLAMAGEN_3B_HEADS))
    return _kernel_row(rows[0], name="fused_epilogue", case="llamagen_3b", route="cuda",
                       source="sjd_tpu_torch/csrc/fused_epilogue.cu",
                       replaces="sjd_tpu/ops/fused_epilogue.py:35",
                       max_abs_err=max(max(r["max_abs_err"].values()) for r in rows))


def phase_attention_llamagen_3b(dev):
    """The attention at GPT-3B's shapes (MHA, 32 heads of 100: 200-byte bf16
    and 100-byte int8 head rows, padded to 128 columns in shared memory)
    over the 384px c2i buffer at fills 150, 400 and 600 (the image's last
    window), bf16 (the main path's cache) and int8. Returns the kernel's
    row (bf16, fill 600)."""
    import torch

    valid = torch.ones((2, LLAMAGEN_3B_L), dtype=torch.bool, device=dev)
    att = _attention_cases(dev, "llamagen_3b", 2, LLAMAGEN_3B_L, valid,
                           [(f, f) for f in (150, 400, 600)], ("bf16", "int8"), 51,
                           **LLAMAGEN_3B_HEADS)
    main = next(r for r in att if r["cache"] == "bf16" and r["fill"][0] == 600)
    return _kernel_row(main, name="decode_attention", case="llamagen_3b", route="cuda",
                       source="sjd_tpu_torch/csrc/decode_attention.cu",
                       replaces="sjd_tpu/ops/decode_attention.py:38",
                       max_abs_err=max(r["max_abs_err"] for r in att))


def phase_llamagen_3b_load(dev):
    """LlamaGen GPT-3B c2i at 384px through load_llamagen at full width and
    depth on seeded random weights: 24 layers, d 3200, 32 heads of 100, ff
    8704, vocab 16384, the 2-D RoPE over one class row and a 24 x 24 grid,
    bf16 weights and cache, the class table and the VQ-16 decoder."""
    import torch

    from sjd_tpu_torch.loader import load_llamagen
    from sjd_tpu_torch.models.transformer import weight_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = load_llamagen(name="GPT-3B", latent_size=24, model_type="c2i", device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    cfg = model.engine.model_cfg
    emit("llamagen_3b_load", seconds=load_s, layers=cfg.num_layers, hidden=cfg.hidden_size,
         ff=cfg.intermediate_size, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.head_dim, vocab=cfg.vocab_size, rope_style=cfg.rope_style,
         rope_2d=[cfg.rope_2d_cls_len, cfg.rope_2d_grid_side], kv_quant=cfg.kv_quant,
         weight_dtype=str(model.params["layers"]["wq"].dtype),
         weight_bytes=weight_bytes(model.params),
         vq_bytes=weight_bytes(model.extras["vq_params"]),
         cond_bytes=weight_bytes({k: v for k, v in model.extras["cond"].items()
                                  if k != "kind"}),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         smoke_reasons=model.extras["smoke_reasons"])
    check((cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
           cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size, cfg.rope_style,
           cfg.rope_2d_cls_len, cfg.rope_2d_grid_side, cfg.kv_quant, cfg.attn_impl)
          == (24, 3200, 8704, 32, 32, 100, 16384, "2d", 1, 24, False, "auto"),
          f"not the GPT-3B 384px c2i config: {cfg}")
    check(model.params["layers"]["wq"].dtype == torch.bfloat16, "not bf16 weights")
    return model


def _llamagen_3b_image(dev, model, eng, label: str, seed: int = 0, **fields):
    """One class-207 image on ``eng`` from launch counts of 0: its tokens
    (576, in the VQ-16 codebook), the uint8 (384, 384, 3) image, NFE, ms per
    forward, seconds, peak memory and each kernel's launches per forward
    (the one-row prefill takes the kernels too). Returns the launches."""
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.models.llamagen import VOCAB_SIZE
    from sjd_tpu_torch.ops import launch_counts

    cfg = eng.model_cfg
    table = per_forward(model.params, cfg)
    pe, ne, mask = model.extras["embed_prompt_fn"](LLAMAGEN_3B_CLASS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.stats = GraphStats()
    _zero_launch_counts()
    t0 = time.time()
    res = eng.generate(model.params, seed, prompt_embeds=pe, neg_prompt_embeds=ne,
                       prompt_mask=mask)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    launches = eng.stats.executed(launch_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    toks = res.tokens[0, :int(res.length[0])].tolist()
    t0 = time.time()
    img = model.extras["decode_image_fn"](toks)
    torch.cuda.synchronize()
    vq_s = time.time() - t0
    nfe, gen = int(res.nfe), toks[1:]
    kv_rows = eng._state.kv.k.shape[2]
    emit(label, size=384, label=LLAMAGEN_3B_CLASS, tokens_generated=int(res.gen_count[0]),
         nfe=nfe, tokens_per_forward=int(res.gen_count[0]) / nfe,
         accept_hist=res.accept_hist.tolist(), generate_s=gen_s, vq_decode_s=vq_s,
         wall_s=gen_s + vq_s, ms_per_forward=1e3 * gen_s / nfe, peak_mem_gb=peak,
         kv_buffer_rows=kv_rows, kv_dtype=str(eng._state.kv.k.dtype),
         image_shape=list(img.shape), image_dtype=str(img.dtype), launches=launches,
         launches_expected={k: v * nfe for k, v in table.items()},
         captures=eng.stats.captures, graph_replays=eng.stats.replays,
         eager_steps=eng.stats.eager_steps, **fields)
    check(tuple(img.shape) == (384, 384, 3) and str(img.dtype) == "uint8",
          f"image is {img.shape} {img.dtype}")
    check(len(gen) == 576 and int(res.gen_count[0]) == 576
          and all(0 <= t < VOCAB_SIZE for t in gen), f"{len(gen)} image tokens")
    check(kv_rows == LLAMAGEN_3B_L and eng._state.kv.k_scale is None,
          f"the KV buffer has {kv_rows} rows (the kernel phases {LLAMAGEN_3B_L}), "
          f"{eng._state.kv.k.dtype}")
    check(eng.stats.captures >= 1 and eng.stats.replays > 0, f"graph path idle: {eng.stats}")
    for name, k in launches.items():
        check(k > 0 or table[name] == 0, f"{name} was never launched on the {label} path")
        check(k == table[name] * nfe, f"{name}: {k} launches in {label} for {nfe} forwards, "
                                      f"not {table[name] * nfe}")
    return launches


def phase_llamagen_3b_c2i(dev, model):
    """One class-207 image at 384px through the loader's engine on the graph
    path (CFG 7.5 against the unconditional class, window 16, top-k 1000):
    both TPU kernels 24 times per forward at heads of 100."""
    return _llamagen_3b_image(dev, model, model.engine, "llamagen_3b_c2i")


def phase_llamagen_3b_options(dev, model):
    """The same model through an engine with the decode options the port
    took last: init="sample_horizon" (the draft seeds from the argmax of
    the carried distributions) and top_p=0.95 (the nucleus filter inside the
    captured step). A valid image, with its NFE and accept_hist."""
    eng = _llamagen_3b_engine(dev, model.engine.model_cfg, init="sample_horizon", top_p=0.95)
    check(eng.sampling.top_p == 0.95 and eng.config.init == "sample_horizon",
          "the options did not reach the engine")
    _llamagen_3b_image(dev, model, eng, "llamagen_3b_options", init=eng.config.init,
                       top_p=eng.sampling.top_p)
    del eng


def _image_by_width(eng, params, ids, seed: int = 0, chunk: int = 32) -> dict:
    """One image on ``eng`` in resume calls of ``chunk`` steps, each timed
    to its synchronize; a call whose steps all replayed one width's graph
    (no warm-up step, no capture) counts toward that width's ms per
    forward. Returns the result, the whole wall, the ms per forward by
    width and the replays by width."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, st = eng.generate(params, seed, ids, max_steps=1, return_state=True)
    spent: dict = {}
    while not bool(st.finished.all()):
        stats = eng.stats
        before = (dict(stats.replays_by_width), stats.eager_steps, stats.captures)
        t = time.perf_counter()
        res, st = eng.resume(params, st, max_steps=chunk, return_state=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        grew = {w: n - before[0].get(w, 0) for w, n in stats.replays_by_width.items()
                if n > before[0].get(w, 0)}
        if len(grew) == 1 and (stats.eager_steps, stats.captures) == before[1:]:
            (w, n), = grew.items()
            secs, steps = spent.get(w, (0.0, 0))
            spent[w] = (secs + dt, steps + n)
    wall = time.perf_counter() - t0
    return dict(result=res, wall_s=wall, replays_by_width=dict(eng.stats.replays_by_width),
                captures_by_width=dict(eng.stats.captures_by_width),
                ms_per_forward_by_width={w: 1e3 * s / n for w, (s, n) in spent.items()},
                timed_forwards_by_width={w: n for w, (_, n) in spent.items()})


def phase_ar_fast_path(dev, model, ids, label: str, size: int = TARGET_SIZE,
                       greedy: bool = False, hold: bool = False, turns: bool = False):
    """The 1-token AR fast path on the 7B through lumina_engine's interval
    (the steps past jacobi_interval_r(size) generated tokens run as width-1
    forwards): images on the default engine ("wide") and with
    ar_fast_path=True ("fast"), from the same seed, each from launch counts
    of 0, in turns wide, fast, fast, wide with ``turns`` (else wide, fast).
    Reports each graph's replays, the ms per forward of each width and the
    whole-image seconds; with ``hold`` (greedy, on weights whose products
    keep a row's result whatever the rows beside it) the first fast run's
    tokens, NFE and accept_hist must equal the first wide run's, else their
    count of equal tokens is reported."""
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.models.chameleon import jacobi_interval_r, lumina_engine
    from sjd_tpu_torch.ops import launch_counts

    cfg = model.engine.model_cfg
    table = per_forward(model.params, cfg)
    ids = torch.tensor([ids], dtype=torch.int32, device=dev)
    runs = {"wide": [], "fast": []}
    for key in ("wide", "fast", "fast", "wide") if turns else ("wide", "fast"):
        eng = lumina_engine(target_size=size, model_cfg=cfg, greedy=greedy,
                            ar_fast_path=key == "fast", device=dev)
        eng.stats = GraphStats()
        _zero_launch_counts()
        run = _image_by_width(eng, model.params, ids)
        run["launches"] = eng.stats.executed(launch_counts())
        runs[key].append(run)
        del eng
    wide, fast = runs["wide"][0], runs["fast"][0]
    n = int(max(wide["result"].length[0], fast["result"].length[0]))
    equal = int((wide["result"].tokens[0, :n] == fast["result"].tokens[0, :n]).sum())
    out = {}
    for key, key_runs in runs.items():
        res = key_runs[0]["result"]
        out[key] = dict(nfe=int(res.nfe), tokens_generated=int(res.gen_count[0]),
                        accept_hist=res.accept_hist.tolist(), steps_multi=int(res.steps_multi),
                        wall_s=[r["wall_s"] for r in key_runs],
                        ms_per_forward=[1e3 * r["wall_s"] / int(r["result"].nfe)
                                        for r in key_runs],
                        ms_per_forward_by_width=[r["ms_per_forward_by_width"] for r in key_runs],
                        timed_forwards_by_width=[r["timed_forwards_by_width"]
                                                 for r in key_runs],
                        replays_by_width=[r["replays_by_width"] for r in key_runs],
                        captures_by_width=[r["captures_by_width"] for r in key_runs],
                        launches=[r["launches"] for r in key_runs])
    mean = {k: statistics.mean(v["wall_s"]) for k, v in out.items()}
    emit(label, size=size, act_quant=cfg.act_quant,
         quantized=isinstance(model.params["layers"]["wq"], dict), greedy=greedy,
         interval_r=jacobi_interval_r(size), window=16, order=list(
             ("wide", "fast", "fast", "wide") if turns else ("wide", "fast")),
         tokens_compared=n, equal_tokens=equal, held=hold,
         wall_vs_wide=mean["fast"] / mean["wide"], **out)
    for run in runs["fast"]:
        check(run["captures_by_width"] == {16: 1, 1: 1} and run["replays_by_width"].get(1, 0) > 0,
              f"the fast path did not replay its width-1 graph: {run['captures_by_width']}, "
              f"{run['replays_by_width']}")
    for run in runs["wide"]:
        check(run["captures_by_width"] == {16: 1}, f"the wide engine: {run['captures_by_width']}")
    for key, key_runs in runs.items():
        for run in key_runs:
            nfe = int(run["result"].nfe)
            for name, k in run["launches"].items():
                check(k == table[name] * nfe and (k > 0 or table[name] == 0),
                      f"{name}: {k} launches in {label} ({key}) for {nfe} forwards")
    if hold:
        check(equal == n and out["wide"]["nfe"] == out["fast"]["nfe"]
              and out["wide"]["accept_hist"] == out["fast"]["accept_hist"],
              f"the fast path's greedy run differs from the wide path's: {equal} of {n} "
              f"tokens, NFE {out['wide']['nfe']} and {out['fast']['nfe']}")
    torch.cuda.empty_cache()


def phase_decompose(dev, model, ids):
    """sequential_decompose on one window of the 7B's logits on the card:
    a state 24 steps into the 768px image, the window after its last token
    through the forward (CFG halves), then the rows in order with the
    grammar advanced by each sampled token. Its greedy tokens must equal a
    per-token loop of apply_grammar_single + top-k + argmax + update_state
    over the same CFG-mixed logits."""
    import torch

    from sjd_tpu_torch.core import grammar as G
    from sjd_tpu_torch.core import sampling as S
    from sjd_tpu_torch.core.decomposer import sequential_decompose
    from sjd_tpu_torch.core.processors import cfg_mix
    from sjd_tpu_torch.models.chameleon import lumina_engine

    eng = lumina_engine(target_size=TARGET_SIZE, model_cfg=model.engine.model_cfg,
                        greedy=True, device=dev)
    params, spec, W = model.params, eng.spec, eng.config.window
    _, st = eng.generate(params, 0, torch.tensor([ids], dtype=torch.int32, device=dev),
                         max_steps=24, return_state=True)
    # the window: the last committed token, then the carried drafts
    x = torch.cat([st.tokens.gather(1, st.length.long()[:, None] - 1),
                   st.carried_tokens[:, :W - 1]], dim=1)
    i = torch.arange(W, device=dev, dtype=torch.int32)[None]
    pos = (eng._tile(st.length)[:, None] - 1 - st.n_pad[:, None]) + i
    with torch.no_grad():
        logits, _ = eng.model.forward(params, eng._tile(x), pos.to(torch.int32), st.kv,
                                      eng._tile(st.length - 1).to(torch.int32), st.valid)
    force = ~st.gstate.in_image
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sequential_decompose(None, logits, spec, st.gstate, eng.sampling, greedy=True,
                               force_no_cfg=force)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    scores = cfg_mix(logits, eng.sampling.guidance_scale, force)
    g, loop = st.gstate, []
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    for r in range(W):
        s = G.apply_grammar_single(spec, g, scores[:, r], 0 * one)
        s = S.top_k_dual(s[:, None], g.in_image, eng.sampling.image_top_k,
                         eng.sampling.text_top_k)[:, 0]
        tok = torch.argmax(torch.softmax(s, -1), -1).to(torch.int32)
        g = G.update_state(spec, g, tok[:, None], one)
        loop.append(tok)
    loop = torch.stack(loop, 1)
    o = int(st.gstate.img_count[0])
    w1 = int(st.gstate.w_lat[0]) + 1
    emit("decompose", window=W, img_count=o, row_width=w1,
         eol_rows=[r for r in range(W) if (o + r + 1) % w1 == 0],
         tokens=res.tokens[0].tolist(), loop_tokens=loop[0].tolist(), seconds=secs,
         equal=bool(torch.equal(res.tokens, loop)),
         gstate_equal=all(torch.equal(a, b) for a, b in zip(res.gstate, g)))
    check(torch.equal(res.tokens, loop) and all(torch.equal(a, b)
                                                for a, b in zip(res.gstate, g)),
          "sequential_decompose differs from the per-token loop")
    check(bool(st.gstate.in_image[0]) and bool(torch.isfinite(logits).all()),
          "the window is not inside the image")
    del eng, st
    torch.cuda.empty_cache()


def phase_emu3_understand_chunked(dev, model, chunk: int = 512):
    """The understanding prefill of phase_emu3_understand (the 720px
    image's codes and the chat text in the 8318-row left-padded bucket, on
    the plain path) twice on the W4A16 8B: with the whole-buffer attention
    (blocks of ATTEND_BLOCK_ROWS query rows against the 8704-row buffer)
    and with attn_buckets=``chunk`` (each block reads the 512-row chunks up
    to its causal edge). Seconds and peak memory of each; the answer's
    first-token logits within phase_forward's bf16 tolerance (5% of the
    largest logit) of the unchunked run, and the same argmax."""
    import numpy as np
    import torch

    from sjd_tpu_torch.data.emu3_processor import build_understanding_prompt
    from sjd_tpu_torch.models.adapter import decoder_model_fns
    from sjd_tpu_torch.models.emu3 import PAD_ID
    from sjd_tpu_torch.models.transformer import ATTEND_BLOCK_ROWS
    from sjd_tpu_torch.models.vq.emu3_vq import encode as emu3_encode

    g = EMU3_GRID
    yy, xx = np.mgrid[0:8 * g, 0:8 * g] / (8 * g)
    img = np.stack([np.sin(6 * xx), np.cos(5 * yy), xx * yy * 2 - 1], -1).astype(np.float32)
    vq, vq_cfg = model.extras["vq_params"], model.extras["vq_cfg"]
    with torch.no_grad():
        grid = emu3_encode(vq, vq_cfg, torch.from_numpy(img[None]).to(dev))[0].cpu().numpy()
    ids = build_understanding_prompt("describe this picture", grid.astype(np.int32),
                                     lambda s: list(Emu3Tok().encode(s)))
    bucket = g * (g + 1) + 128
    pad = bucket - len(ids)
    prompt = torch.tensor([[PAD_ID] * pad + ids], dtype=torch.int32, device=dev)
    mask = torch.tensor([[False] * pad + [True] * len(ids)], device=dev)
    # the understanding engine's buffer: the bucket, 32 answer tokens and two
    # windows, then the window's rows, rounded up to 512
    rows = ((bucket + 32 + 2 * 16 + 16 + 1 + 511) // 512) * 512
    valid = torch.ones((1, rows), dtype=torch.bool, device=dev)
    valid[:, :bucket] = mask
    pos = torch.clamp_min(torch.cumsum(mask.int(), 1) - 1, 0).to(torch.int32)
    out = {}
    for buckets in (0, chunk):
        cfg = dataclasses.replace(model.engine.model_cfg, attn_buckets=buckets)
        fns = decoder_model_fns(cfg, max_positions=bucket + 64, device=dev)
        kv = fns.init_cache(1, rows)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = fns.forward(model.params, prompt, pos, kv,
                                    torch.zeros((1,), dtype=torch.int32, device=dev), valid,
                                    logits_tail=1)
        torch.cuda.synchronize()
        out[buckets] = dict(seconds=time.perf_counter() - t0, held_gb=held,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                            logits=logits[0, -1].float())
        del kv, fns
        torch.cuda.empty_cache()
    a, b = out[chunk]["logits"], out[0]["logits"]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    ok = math.isfinite(err) and err <= 0.05 * scale and int(a.argmax()) == int(b.argmax())
    emit("emu3_understand_chunked", prompt_bucket=bucket, buffer_rows=rows,
         block_rows=ATTEND_BLOCK_ROWS, attn_buckets=chunk,
         seconds={k: v["seconds"] for k, v in out.items()},
         peak_mem_gb={k: v["peak_gb"] for k, v in out.items()},
         held_before_gb={k: v["held_gb"] for k, v in out.items()},
         max_abs_err=err, max_abs_logit=scale, tolerance=0.05 * scale,
         argmax_equal=int(a.argmax()) == int(b.argmax()), ok=ok)
    check(ok, f"the chunked prefill's logits differ from the unchunked ones: {err} of {scale}")
    check(rows % chunk == 0, f"{chunk} does not divide the {rows}-row buffer")


# -- evaluation (sjd_tpu_torch/eval) -------------------------------------------

EVAL_DIR = os.path.join(HERE, "build", "chip_smoke_eval")
# the JSON keys that the JAX package's command lines print: examples/
# eval_model.py prints run_prompt_set's or run_prompt_set_batched's stats and
# evaluate_quantitative_scores' scores (FID only with --inception-ckpt);
# examples/recon_eval.py:153-160 its one line
SOLO_STATS_KEYS = {"generated", "skipped_existing", "mean_latency_s"}
BATCHED_STATS_KEYS = {"generated", "skipped_existing", "slots", "wall_s", "images_per_min"}
FID_SCORE_KEYS = {"n_images", "fid"}
RECON_KEYS = ["tokenizer", "n", "rfid", "psnr_db", "smoke_weights", "smoke_extractor"]
PARTI_TSV = ("Prompt\tCategory\tChallenge\tNote\n"
             "a red fox in the snow\tAnimals\tBasic\t\n"
             '"a lighthouse at dusk, ""long exposure""\tbeside the sea"\tOutdoor Scenes\t'
             "Imagination\tquoted, with a tab\n"
             "three green apples on a wooden table\tProduce & Plants\tQuantity\t\n"
             "an old map of a harbour town\tArtifacts\tFine-grained Detail\t\n")


class ClipTok:
    """A CLIP BPE stand-in with HF's call signature: a word -> an id in
    1..49405, then <|endoftext|> (49407, the largest id), zeros after."""

    def __call__(self, texts, padding, max_length, truncation, return_tensors):
        import zlib

        import numpy as np

        rows = []
        for t in texts:
            ids = [1 + zlib.crc32(w.encode()) % 49405 for w in t.split()][: max_length - 1]
            ids.append(49407)
            rows.append(ids + [0] * (max_length - len(ids)))
        return {"input_ids": np.asarray(rows, np.int64)}


def _forward_counter(eng) -> dict:
    """Count the engine's prefill forwards (generate and refill calls: each
    one forward) from now on, by wrapping the two methods on the instance."""
    calls = {"generate": 0, "refill": 0}

    def wrap(name):
        real = getattr(eng, name)

        def counted(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)

        setattr(eng, name, counted)

    wrap("generate")
    wrap("refill")
    return calls


def phase_eval_latency(dev, model, iters: int = 50):
    """eval.latency.decode_step_latencies on the bf16 7B (batch 2, window 16,
    a 2500-row int8 cache filled to 1200): the window forward captured once
    per variant and replayed ``iters`` times, for the full model, half the
    layers and an 8192-row head (the two ablated ones on fresh random
    weights), each variant twice in turns (full, half, small, small, half,
    full). Each call's launches come from one eager warm-up forward and one
    captured forward: each TPU kernel once per layer of the variant (32,
    16, 32)."""
    import torch

    from sjd_tpu_torch.eval.latency import decode_step_latencies, default_variants
    from sjd_tpu_torch.ops import launch_counts

    cfg = model.engine.model_cfg
    variants = default_variants(cfg)
    order = list(variants) + list(variants)[::-1]
    ms, per_fwd, peak = {n: [] for n in variants}, {}, {}
    for name in order:
        overrides = variants[name]
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        sec = decode_step_latencies(cfg, model.params, batch=2, window=16, buf_len=2500,
                                    cache_fill=1200, iters=iters,
                                    variants={name: overrides}, device=dev)
        ms[name].append(1e3 * sec[name])
        per_fwd[name] = {k: n / 2 for k, n in launch_counts().items()}
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        layers = overrides.get("num_layers", cfg.num_layers)
        want = {"fused_epilogue": layers, "decode_attention": layers, "quant_linear_a16": 0,
                "quant_linear_a8": 0}
        check(per_fwd[name] == want, f"eval_latency {name}: {per_fwd[name]} launches per "
                                     f"forward, not {want}")
    mean = {n: statistics.mean(v) for n, v in ms.items()}
    emit("eval_latency", batch=2, window=16, buf_len=2500, cache_fill=1200, iters=iters,
         ms_in_turns=ms, ms=mean, half_layers_share=mean["half_layers"] / mean["full"],
         small_head_saving_ms=mean["full"] - mean["small_head"],
         launches_per_forward=per_fwd, peak_mem_gb=peak)
    check(all(math.isfinite(v) and v > 0 for v in mean.values()), f"latencies {ms}")


def _read_pngs(d: str, n: int, shape) -> dict:
    import numpy as np

    from sjd_tpu_torch.utils.image_io import read_png

    names = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    arrs = {f: read_png(os.path.join(d, f)) for f in names}
    check(len(arrs) == n, f"{d}: {len(arrs)} PNGs, not {n}")
    for f, a in arrs.items():
        check(a.shape == tuple(shape) and a.dtype == np.uint8, f"{d}/{f} is {a.shape} {a.dtype}")
    return arrs


def phase_eval_harness_tokens(dev, model, root: str) -> str:
    """The generation harness on the bf16 7B at 768px: a 4-row Parti-layout
    TSV (one prompt quoted, with a doubled quote and a tab) read by
    eval.datasets and split into 2 workers; worker 0's shard through
    run_prompt_set(model.sample_fn), worker 1's through
    run_prompt_set_batched(model, slots=2, chunk_steps=192), each from
    launch counts of 0: each TPU kernel 32 times per forward (prefills and
    refills included); then both again, which must skip every image. Every
    PNG reads back as (768, 768, 3) uint8, and the last solo one equals the
    array sample_fn returned for it. Returns the images' directory."""
    import numpy as np
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.eval.datasets import load_parti_prompts, shard_prompts
    from sjd_tpu_torch.eval.harness import run_prompt_set, run_prompt_set_batched
    from sjd_tpu_torch.ops import launch_counts

    tsv = os.path.join(root, "parti.tsv")
    with open(tsv, "w") as f:
        f.write(PARTI_TSV)
    records = load_parti_prompts(tsv)
    check(len(records) == 4 and records[1].prompt ==
          'a lighthouse at dusk, "long exposure"\tbeside the sea', f"{records}")
    shards = [shard_prompts(records, worker_id=w, num_workers=2) for w in (0, 1)]
    wd = os.path.join(root, "lumina_768")
    eng = model.engine
    table = per_forward(model.params, eng.model_cfg)

    # worker 0: one prompt at a time
    made, nfes = [], []

    def sample_fn(prompt):
        img = model.sample_fn(prompt)
        made.append(img)
        nfes.append(int(model.extras["last_result"].nfe))
        return img

    eng.stats = GraphStats()
    _zero_launch_counts()
    solo = run_prompt_set(sample_fn, shards[0], wd, log_every=0)
    torch.cuda.synchronize()
    solo_launches = eng.stats.executed(launch_counts())
    solo_nfe = sum(nfes)

    # worker 1: two slots of a StreamingBatcher
    eng.stats = GraphStats()
    calls = _forward_counter(eng)
    _zero_launch_counts()
    batched = run_prompt_set_batched(model, shards[1], wd, slots=2, chunk_steps=192,
                                     log_every=0)
    torch.cuda.synchronize()
    batched_launches = eng.stats.executed(launch_counts())
    forwards = eng.stats.eager_steps + eng.stats.replays + calls["generate"] + calls["refill"]
    del eng.generate, eng.refill  # the instance's wrappers

    again = [run_prompt_set(sample_fn, shards[0], wd, log_every=0),
             run_prompt_set_batched(model, shards[1], wd, slots=2, log_every=0)]
    arrs = _read_pngs(wd, 4, (TARGET_SIZE, TARGET_SIZE, 3))
    last = f"{shards[0][-1].index}.png"
    emit("eval_harness_tokens", size=TARGET_SIZE, records=len(records),
         shards=[[r.index for r in s] for s in shards], solo=solo, batched=batched,
         rerun=again, solo_nfe=nfes, solo_images_per_min=60.0 / solo["mean_latency_s"],
         batched_images_per_min=batched["images_per_min"], batched_forwards=forwards,
         batched_prefills=calls, solo_launches=solo_launches,
         batched_launches=batched_launches,
         launches_expected={"solo": {k: n * solo_nfe for k, n in table.items()},
                            "batched": {k: n * forwards for k, n in table.items()}},
         graph_replays=eng.stats.replays, captures=eng.stats.captures)
    check(solo["generated"] == 2 and batched["generated"] == 2,
          f"generated {solo['generated']} solo, {batched['generated']} batched")
    check(set(solo) == SOLO_STATS_KEYS and set(batched) == BATCHED_STATS_KEYS,
          f"stats keys {sorted(solo)}, {sorted(batched)}")
    check([a["generated"] for a in again] == [0, 0]
          and [a["skipped_existing"] for a in again] == [2, 2], f"the rerun made {again}")
    check(np.array_equal(arrs[last], made[-1]), f"{last} differs from sample_fn's array")
    check(eng.stats.captures >= 1 and eng.stats.replays > 0, f"graph path idle: {eng.stats}")
    for name, n in table.items():
        check(solo_launches[name] == n * solo_nfe,
              f"{name}: {solo_launches[name]} launches for {solo_nfe} solo forwards")
        check(batched_launches[name] == n * forwards,
              f"{name}: {batched_launches[name]} launches for {forwards} batched forwards")
    return wd


def phase_eval_harness_embeds(dev, model, root: str) -> str:
    """run_prompt_set_batched in embedding mode on GPT-3B c2i at 384px: 4
    class-id records through 2 slots (rows made by embed_prompt_fn, sent to
    the batcher from the host in a wave), each a (384, 384, 3) PNG; each TPU
    kernel 24 times per forward (the one-row prefills and refills
    included). Returns the images' directory."""
    import torch

    from sjd_tpu_torch.core.engine import GraphStats
    from sjd_tpu_torch.eval.datasets import PromptRecord
    from sjd_tpu_torch.eval.harness import run_prompt_set_batched
    from sjd_tpu_torch.ops import launch_counts

    wd = os.path.join(root, "llamagen_3b_384")
    recs = [PromptRecord(index=i, prompt=str(c)) for i, c in enumerate((207, 360, 387, 974))]
    eng = model.engine
    table = per_forward(model.params, eng.model_cfg)
    eng.stats = GraphStats()
    calls = _forward_counter(eng)
    _zero_launch_counts()
    stats = run_prompt_set_batched(model, recs, wd, slots=2, log_every=0)
    torch.cuda.synchronize()
    launches = eng.stats.executed(launch_counts())
    forwards = eng.stats.eager_steps + eng.stats.replays + calls["generate"] + calls["refill"]
    del eng.generate, eng.refill
    _read_pngs(wd, 4, (384, 384, 3))
    emit("eval_harness_embeds", size=384, classes=[r.prompt for r in recs], stats=stats,
         forwards=forwards, prefills=calls, launches=launches,
         launches_expected={k: n * forwards for k, n in table.items()},
         captures=eng.stats.captures, graph_replays=eng.stats.replays)
    check(stats["generated"] == 4 and set(stats) == BATCHED_STATS_KEYS, f"{stats}")
    check(eng.stats.captures >= 1 and eng.stats.replays > 0, f"graph path idle: {eng.stats}")
    for name, n in table.items():
        check(launches[name] == n * forwards,
              f"{name}: {launches[name]} launches for {forwards} forwards")
    return wd


def phase_eval_scores(dev, root: str, gen_dir: str, ref_dir: str) -> dict:
    """FID, IS and CLIPScore on the harness images, on seeded random weights
    (no real Inception or CLIP weights exist here, so the values are no
    quality figures):
      * a random InceptionV3 state dict with torchvision's names and shapes,
        torch.save'd and read by make_inception_extractor_from_ckpt: pool3
        features of the 768px images and the 384px ones on the card against
        the CPU (f32, TF32 off) within rtol 2e-3 / atol 2e-4 of the largest
        feature; FID and IS (pixel probs) finite; ms per image at batch 16;
      * a ViT-B/32 checkpoint directory at full width (12 + 12 layers, 768 /
        512 wide, projection 512; HF names, config.json, pytorch_model.bin)
        through NativeCLIP with a stand-in tokenizer: image and text
        embeddings card against CPU within 1e-3 of the largest; CLIPScore
        finite; ms per batch of 32 images and of 64 texts.
    Returns the checkpoint paths for the command lines."""
    import json as _json

    import numpy as np
    import torch

    from sjd_tpu_torch.eval import clip as pclip
    from sjd_tpu_torch.eval.datasets import load_parti_prompts
    from sjd_tpu_torch.eval.inception import (
        make_inception_extractor_from_ckpt, pool3_features, port_inception_v3,
        synth_inception_state_dict)
    from sjd_tpu_torch.eval.metrics import (
        clip_score, evaluate_clip_score, evaluate_quantitative_scores, load_image_dir,
        make_pixel_probs)

    # InceptionV3
    inc_path = os.path.join(root, "inception.pt")
    torch.save({k: torch.from_numpy(v) for k, v in synth_inception_state_dict(0).items()},
               inc_path)
    card = make_inception_extractor_from_ckpt(inc_path, device=dev)
    cpu = make_inception_extractor_from_ckpt(inc_path, device="cpu")
    feats = {}
    for name, d in (("768", gen_dir), ("384", ref_dir)):
        x = load_image_dir(d)
        feats[name] = (card(x), cpu(x))
    inc_err = max(float(np.abs(a - b).max()) for a, b in feats.values())
    inc_scale = max(float(np.abs(b).max()) for _, b in feats.values())
    t0 = time.time()
    scores = evaluate_quantitative_scores(gen_dir, ref_dir, feature_fn=card,
                                          probs_fn=make_pixel_probs())
    scores_s = time.time() - t0
    params = port_inception_v3(synth_inception_state_dict(0), device=dev)
    batch = torch.rand((16, 299, 299, 3), device=dev)
    with torch.no_grad():
        inc_ms = eager_ms(lambda: pool3_features(params, batch), reps=5, trials=5) / 16
    del params, batch

    # CLIP ViT-B/32
    cfg = pclip.CLIPConfig.vit_b32()
    clip_dir = os.path.join(root, "clip_vit_b32")
    os.makedirs(clip_dir, exist_ok=True)
    with open(os.path.join(clip_dir, "config.json"), "w") as f:
        _json.dump(pclip.hf_config(cfg), f)
    torch.save({k: torch.from_numpy(v) for k, v in pclip.synth_clip_state_dict(cfg, 0).items()},
               os.path.join(clip_dir, "pytorch_model.bin"))
    prompts = [r.prompt for r in load_parti_prompts(os.path.join(root, "parti.tsv"))]
    clips = [pclip.NativeCLIP(clip_dir, tokenizer=ClipTok(), device=d)
             for d in (dev, torch.device("cpu"))]
    x = load_image_dir(gen_dir, size=224)
    (img_card, txt_card), (img_cpu, txt_cpu) = [
        (c.image_embeds(x), c.text_embeds(prompts)) for c in clips]
    clip_err = max(float(np.abs(img_card - img_cpu).max()), float(np.abs(txt_card - txt_cpu).max()))
    clip_scale = max(float(np.abs(img_cpu).max()), float(np.abs(txt_cpu).max()))
    cs = clip_score(img_card, txt_card)
    cs_dir = evaluate_clip_score(gen_dir, prompts, clip_dir, tokenizer=ClipTok(), device=dev)
    native = clips[0]
    px = torch.from_numpy(pclip.preprocess_images(np.concatenate([x] * 8)[:32])).to(dev)
    ids = torch.from_numpy(ClipTok()(prompts * 16, "max_length", 77, True, "np")["input_ids"]
                           ).to(dev)
    with torch.no_grad():
        img_ms = eager_ms(lambda: pclip.clip_image_features(native.params, cfg, px), reps=5,
                          trials=5)
        txt_ms = eager_ms(lambda: pclip.clip_text_features(native.params, cfg, ids), reps=5,
                          trials=5)
    del clips, native, px, ids
    torch.cuda.empty_cache()
    emit("eval_scores", weights="seeded random (no quality figure)",
         inception_card_vs_cpu_max_abs_err=inc_err, inception_feature_scale=inc_scale,
         fid_768_vs_384=scores.get("fid"), inception_score_pixel_probs=scores.get(
             "inception_score"), scores=scores, scores_s=scores_s,
         inception_ms_per_image_b16=inc_ms, clip_card_vs_cpu_max_abs_err=clip_err,
         clip_embed_scale=clip_scale, clip_score=cs, clip_score_dir=cs_dir,
         clip_image_ms_b32=img_ms, clip_text_ms_b64=txt_ms)
    check(inc_err <= 2e-4 + 2e-3 * inc_scale, f"Inception card against CPU: {inc_err}")
    check(all(np.isfinite(v) for v in scores.values()), f"scores {scores}")
    check(clip_err <= 1e-3 * clip_scale, f"CLIP card against CPU: {clip_err}")
    check(math.isfinite(cs) and math.isfinite(cs_dir), f"CLIPScore {cs}, {cs_dir}")
    return {"inception": inc_path, "clip": clip_dir}


def _run_modules(arg_lists, logs: str, timeout: int = 600) -> list:
    """``python -m args...`` for each of ``arg_lists``, all at once, from the
    repository's root, their output in files under ``logs``: [(its JSON
    lines, its seconds)]; a non-zero exit or the timeout fails the phase."""
    os.makedirs(logs, exist_ok=True)
    t0 = time.time()
    runs = []
    for i, args in enumerate(arg_lists):
        out = open(os.path.join(logs, f"{i}.out"), "w+")
        err = open(os.path.join(logs, f"{i}.err"), "w+")
        runs.append((args, out, err, subprocess.Popen([sys.executable, "-m", *args], cwd=HERE,
                                                      stdout=out, stderr=err, text=True)))
    done: dict = {}
    try:
        while len(done) < len(runs):
            check(time.time() - t0 < timeout, f"{timeout} s passed with {len(done)} of "
                                              f"{len(runs)} command lines done")
            for i, (_, _, _, proc) in enumerate(runs):
                if i not in done and proc.poll() is not None:
                    done[i] = time.time() - t0
            time.sleep(0.2)
    finally:
        for _, _, _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for i, (args, out, err, proc) in enumerate(runs):
        out.seek(0)
        err.seek(0)
        text, errors = out.read(), err.read()
        out.close()
        err.close()
        check(proc.returncode == 0, f"{' '.join(args[:3])} exited {proc.returncode}: "
                                    f"{errors[-3000:]}")
        results.append(([json.loads(ln) for ln in text.splitlines() if ln.startswith("{")],
                        done[i]))
    return results


def phase_eval_cli(dev, root: str, gen_dir: str, ref_dir: str, ckpts: dict):
    """The two command lines as a user runs them, each a process of its own
    (the three started together) that must exit 0 and print the JAX
    scripts' JSON keys:
      * python -m sjd_tpu_torch.eval.eval_model on Lumina-mGPT-7B at W4A16
        (random weights) at 512px: 2 COCO captions through 2 slots, then
        FID against the 384px images through the random Inception file;
      * python -m sjd_tpu_torch.eval.recon_eval with the random chameleon
        VQGAN at 512px on the 768px images and the random VQ-16 at 256px on
        the 384px ones, with the same Inception file."""
    import numpy as np

    coco = os.path.join(root, "captions.json")
    with open(coco, "w") as f:
        json.dump({"annotations": [{"image_id": 9, "caption": "a red fox in the snow "},
                                   {"image_id": 4, "caption": "a lighthouse at dusk"},
                                   {"image_id": 4, "caption": "a lighthouse at dusk by the sea"},
                                   {"image_id": 7, "caption": "three green apples"}]}, f)
    wd = os.path.join(root, "cli_lumina_512")
    recon_cases = (("chameleon", 512, gen_dir), ("llamagen", 256, ref_dir))
    # the three processes at once: each is mostly its own start-up
    (lines, model_s), *recon_runs = _run_modules([[
        "sjd_tpu_torch.eval.eval_model", "--model", "lumina_mgpt", "--target-size", "512",
        "--quantize", "4", "--dataset", "coco", "--dataset-path", coco, "--max-prompts", "2",
        "--slots", "2", "--workdir", wd, "--fid-reference-dir", ref_dir,
        "--inception-ckpt", ckpts["inception"]]] + [
        ["sjd_tpu_torch.eval.recon_eval", "--images", images, "--tokenizer", tok,
         "--size", str(size), "--inception-ckpt", ckpts["inception"], "--batch", "4"]
        for tok, size, images in recon_cases], os.path.join(root, "cli_logs"))
    check(len(lines) == 2, f"eval_model printed {lines}")
    stats, scores = lines
    recon = {}
    for (tok, _, _), (out, sec) in zip(recon_cases, recon_runs):
        check(len(out) == 1, f"recon_eval printed {out}")
        recon[tok] = dict(out[0], seconds=sec)
    _read_pngs(wd, 2, (512, 512, 3))
    emit("eval_cli", eval_model_stats=stats, eval_model_scores=scores, eval_model_s=model_s,
         recon_eval=recon, weights="seeded random (no quality figure)")
    check(set(stats) == BATCHED_STATS_KEYS and stats["generated"] == 2, f"stats {stats}")
    check(set(scores) == FID_SCORE_KEYS and np.isfinite(scores["fid"]), f"scores {scores}")
    for tok, r in recon.items():
        check(list(r)[:-1] == RECON_KEYS and r["n"] == 4 and r["smoke_weights"]
              and not r["smoke_extractor"] and np.isfinite([r["rfid"], r["psnr_db"]]).all(),
              f"recon_eval {tok}: {r}")


TRAIN_DIR = os.path.join(HERE, "build", "chip_smoke_train")
TRAIN_CAPTIONS = ("a red fox in the snow", "a lighthouse at dusk by the sea",
                  "three green apples on a wooden table", "an old map of a harbour town")
PARAMS_7B = 7.0e9  # Chameleon-7B's parameters, embedding and head included (model-FLOP share)


def phase_train_data(dev, root: str) -> list:
    """The fine-tuning data path at 768px: 4 seeded images through the
    taming encoder at full width on the card, pre-tokenized with 4 captions
    by run_pretokenize (splits=2, both ranks) and concat_records, read back
    through FinetuneDataset and LengthClusteredSampler(batch_size=1,
    grad_accum=2). Returns the sampler's 4 batches (pad_batch)."""
    import numpy as np
    import torch

    from sjd_tpu_torch.data.dataset import FinetuneDataset, pad_batch
    from sjd_tpu_torch.data.pre_tokenize import concat_records, run_pretokenize
    from sjd_tpu_torch.data.sampler import LengthClusteredSampler
    from sjd_tpu_torch.data.vocab_translation import mapping_from_vocab
    from sjd_tpu_torch.models.vq import CHAMELEON_VQ, encode, init_vq_params

    t0 = time.time()
    vq = init_vq_params(7, CHAMELEON_VQ, device=dev)
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:TARGET_SIZE, 0:TARGET_SIZE] / TARGET_SIZE
    f = TARGET_SIZE // 16
    grids = []
    with torch.no_grad():
        for i in range(len(TRAIN_CAPTIONS)):
            img = np.stack([np.sin((6 + i) * xx), np.cos((5 + i) * yy), xx * yy * 2 - 1], -1)
            img = np.clip(img + 0.1 * rng.standard_normal(img.shape), -1, 1).astype(np.float32)
            ids = encode(vq, CHAMELEON_VQ, torch.from_numpy(img[None]).to(dev))[0]
            grids.append(ids.reshape(f, f).cpu().numpy())
    encode_s = time.time() - t0
    del vq
    tok = ImgTokenizer()
    items = [{"caption": c, "grid": g} for c, g in zip(TRAIN_CAPTIONS, grids)]
    out = os.path.join(root, "pretokenized")
    t1 = time.time()
    for rank in range(2):
        run_pretokenize(items, out, encode_text=tok.encode, pixels=TARGET_SIZE, splits=2,
                        rank=rank, mapping=mapping_from_vocab(tok.get_vocab()))
    records = concat_records(out, 2)
    meta = os.path.join(root, "meta.json")
    with open(meta, "w") as fh:
        json.dump([{"path": records, "type": "t2i"}], fh)
    ds = FinetuneDataset(meta)
    sampler = LengthClusteredSampler(ds.lengths(), batch_size=1, grad_accum=2, seed=0)
    order = list(sampler)
    batches = [pad_batch([ds[i]]) for i in order]
    tokenize_s = time.time() - t1
    lengths = ds.lengths()
    want = 12 + 3 + f * (f + 1) + 1 + 1  # prompt, header, rows with <eol>, <eoi>, sep
    emit("train_data", images=len(grids), pixels=TARGET_SIZE, record_lengths=lengths,
         sampler_order=order, encode_s=encode_s, pretokenize_and_read_s=tokenize_s,
         labelled_tokens=[int((b[1] != -100).sum()) for b in batches])
    check(sorted(order) == list(range(len(TRAIN_CAPTIONS))), f"sampler order {order}")
    check(lengths == [want] * len(TRAIN_CAPTIONS), f"record lengths {lengths}, not {want}")
    for ids, labels, mask in batches:
        check(ids.shape == (1, want) and bool(mask.all()) and int(ids.max()) < 65536
              and int((labels == -100).sum()) == 12, "a padded record is malformed")
    gc.collect()
    torch.cuda.empty_cache()
    return batches


def _device_time_by_kernel(run) -> dict:
    """{kernel name: (launches, device ms)} of ``run()`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "device_time_total", None)
            out[ev.key] = (ev.count, (ev.cuda_time_total if us is None else us) / 1e3)
    return out


# kernel-name classes of the train step's device time (cuBLAS/cuBLASLt
# products, softmax, the fused AdamW, the rest)
TRAIN_CLASSES = (("products", ("gemm", "nvjet", "cutlass", "xmma")), ("softmax", ("softmax",)),
                 ("adamw", ("adam",)))


def _train_breakdown(kernels: dict) -> dict:
    classes = {name: 0.0 for name, _ in TRAIN_CLASSES}
    classes["other"] = 0.0
    for key, (_, ms) in kernels.items():
        low = key.lower()
        name = next((c for c, subs in TRAIN_CLASSES if any(x in low for x in subs)), "other")
        classes[name] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return {"device_ms": sum(ms for _, ms in kernels.values()), "by_class_ms": classes,
            "kernels": sum(n for n, _ in kernels.values()),
            "top": [{"name": k[:120], "launches": n, "ms": ms} for k, (n, ms) in top]}


def _equal_to(state, host: dict) -> bool:
    import torch

    return all(torch.equal(p.detach(), host[n].to(p.device))
               for n, p in state.opt_state.names.items())


def phase_train_7b(dev, batches):
    """Chameleon-7B at full width and depth (chameleon_config("7B"), bf16
    parameters and moments) through make_train_step on the 1 x 1 mesh with
    TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=8,
    grad_accum=2): 4 calls on the train_data records, 2 optimizer steps.
    The parameters are bit-equal to the initial ones after calls 1-3 (1 and 3
    only accumulate; call 2's update runs at the schedule's count 0, where
    the rate is 0) and move after call 4 in most elements of every weight
    matrix (of the embedding, in the rows the records use; the norms' ones
    are below bf16's half-ulp from a 1e-3 step). Returns (state, cfg)."""
    import numpy as np
    import torch

    from sjd_tpu_torch.models.chameleon import chameleon_config
    from sjd_tpu_torch.models.transformer import QUANTIZED
    from sjd_tpu_torch.parallel import TrainConfig, make_mesh, make_train_step

    gc.collect()
    with_workspaces = torch.cuda.memory_allocated()
    # cuBLAS keeps a workspace for every stream it ran on (the timing
    # helpers' side streams, the batchers' threads), in the caching
    # allocator and never freed by empty_cache
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    if resident >= 1e9:
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape), str(o.dtype))
                       for o in gc.get_objects()
                       if isinstance(o, torch.Tensor) and o.is_cuda), reverse=True)
        print(json.dumps({"phase": "train_7b_resident", "with_workspaces": with_workspaces,
                          "resident": resident, "largest": live[:20]}), flush=True)
    check(resident < 1e9, f"{resident / 1e9:.2f} GB still allocated before train_7b "
                          f"({with_workspaces / 1e9:.2f} GB with cuBLAS's workspaces)")
    cfg = chameleon_config("7B")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=8, grad_accum=2)
    init_fn, step_fn = make_train_step(make_mesh(device=dev), cfg, tcfg, device=dev)
    t0 = time.time()
    state = init_fn(11)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in state.opt_state.names.values())
    host = {n: p.detach().to("cpu", copy=True) for n, p in state.opt_state.names.items()}
    calls, peaks, equal_after = [], [], []
    for i, (ids, labels, mask) in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.time()
        state, m = step_fn(state, *(torch.from_numpy(x) for x in (ids, labels, mask)))
        torch.cuda.synchronize()
        calls.append(dict(seconds=time.time() - t, tokens=int(mask.sum()),
                          **{k: float(v) for k, v in m.items()}))
        peaks.append(torch.cuda.max_memory_allocated())
        if i < 3:
            equal_after.append(_equal_to(state, host))
    changed = {}
    used = torch.unique(torch.from_numpy(np.concatenate([b[0].reshape(-1) for b in batches])))
    for n, p in state.opt_state.names.items():
        ref, d = host[n].to(dev), p.detach()
        if n == "embed":
            d, ref = d[used.to(dev).long()], ref[used.to(dev).long()]
        changed[n] = torch.count_nonzero(d != ref).item() / d.numel()
        del ref, d
    # where a call's device time goes: a fifth call (an accumulating one,
    # its gradients dropped after) under torch.profiler
    ids, labels, mask = (torch.from_numpy(x) for x in batches[0])
    kernels = _device_time_by_kernel(lambda: step_fn(state, ids, labels, mask))
    state.opt_state.adamw.zero_grad(set_to_none=True)
    state.opt_state.mini_step = 0
    breakdown = _train_breakdown(kernels)
    timed = calls[1:]  # after the warm-up call
    sec = sum(c["seconds"] for c in timed) / len(timed)
    tokens = sum(c["tokens"] for c in timed) / len(timed)
    emit("train_7b", resident_before_gb=resident / 1e9,
         resident_with_cublas_workspaces_gb=with_workspaces / 1e9,
         layers=cfg.num_layers, hidden=cfg.hidden_size, heads=cfg.num_heads,
         ff=cfg.intermediate_size, vocab=cfg.vocab_size, params=n_params, init_s=init_s,
         calls=calls, optimizer_steps=state.opt_state.gradient_step,
         seconds_per_call_after_warmup=sec, tokens_per_s=tokens / sec,
         model_flop_share=6 * PARAMS_7B * tokens / sec / BF16_TENSOR_FLOPS,
         peak_mem_gb=max(peaks) / 1e9, peak_mem_gb_by_call=[p / 1e9 for p in peaks],
         params_equal_after_calls_1_3=equal_after, changed_share_after_call_4=changed,
         profiled_accumulating_call=breakdown)
    for c in calls:
        check(math.isfinite(c["loss"]) and math.isfinite(c["grad_norm"]), f"call {c}")
    check(state.step == 4 and state.opt_state.gradient_step == 2, "not 2 optimizer steps")
    check(all(equal_after), f"parameters moved before the first real update: {equal_after}")
    for n in [f"layers.{w}" for w in QUANTIZED] + ["lm_head", "embed"]:
        check(changed[n] > 0.5, f"{n}: {changed[n]:.3f} of its elements moved after call 4")
    del host
    return state, cfg


def phase_train_serve(dev, params, cfg, batch, prefix: int = 256, window: int = 16):
    """The trained 7B through the serving path: transformer.forward
    prefills ``prefix`` rows of a record into a bf16 cache (plain path),
    then one 16-token window through both TPU kernels; its logits against
    forward_train's at the same positions (5% of the largest logit, as
    phase_forward, and the argmax at 14 of 16 positions), and each
    kernel's launches 32 for the window."""
    import torch

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.ops import launch_counts

    n = prefix + window
    ids = torch.from_numpy(batch[0][:, :n]).to(dev).long()
    pos = torch.arange(n, device=dev)[None]
    rope = pt.make_rope_table(cfg, device=dev)
    with torch.no_grad():
        want = pt.forward_train(params, cfg, ids, pos, rope_table=rope, remat=False)[:, prefix:]
        kv = pt.init_kv_cache(cfg, 1, 512, device=dev)
        valid = torch.ones((1, 512), dtype=torch.bool, device=dev)
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        pt.forward(params, cfg, ids[:, :prefix], pos[:, :prefix], kv, zero, valid, rope)
        _zero_launch_counts()
        got = pt.forward(params, cfg, ids[:, prefix:], pos[:, prefix:], kv, zero + prefix,
                         valid, rope).logits
        launches = launch_counts()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    emit("train_serve", prefix=prefix, window=window, cache="bf16", max_abs_err=err,
         max_abs_logit=scale, tolerance=0.05 * scale, rel_l2=rel_l2, argmax_agree=agree,
         launches=launches)
    check(math.isfinite(err) and err <= 0.05 * scale, "the window disagrees with forward_train")
    check(agree >= 14, f"argmax agrees at {agree} of {window} positions")
    for k in ("fused_epilogue", "decode_attention"):
        check(launches[k] == cfg.num_layers, f"{k}: {launches[k]} launches for the window")


def phase_train_ckpt(dev, batches, root: str):
    """Checkpoints at the 7B's widths with 2 layers: 3 calls (grad_accum=2,
    so the third is mid-accumulation), save, 3 more; a fresh state from
    another seed restored from the save runs the same 3 calls; parameters,
    moments, AdamW's counts, the accumulation counters and the step are
    bit-equal to the uninterrupted run's; max_keep=1 prunes the first step
    when the second is saved."""
    import torch

    from sjd_tpu_torch.models.chameleon import chameleon_config
    from sjd_tpu_torch.parallel import TrainConfig, make_mesh, make_train_step
    from sjd_tpu_torch.utils import checkpoints as ckpt

    cfg = dataclasses.replace(chameleon_config("7B"), num_layers=2)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=8, grad_accum=2)
    init_fn, step_fn = make_train_step(make_mesh(device=dev), cfg, tcfg, device=dev)
    feed = [tuple(torch.from_numpy(x) for x in batches[i % len(batches)]) for i in range(6)]
    mgr = ckpt.make_manager(os.path.join(root, "ckpt"), max_keep=1)
    a = init_fn(13)
    for b in feed[:3]:
        a, _ = step_fn(a, *b)
    torch.cuda.synchronize()
    t0 = time.time()
    ckpt.save(mgr, 3, a)
    save_s = time.time() - t0
    on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(mgr.path(3))
                  for f in fs)
    for b in feed[3:]:
        a, _ = step_fn(a, *b)
    t0 = time.time()
    b_state = ckpt.restore(mgr, init_fn(14))
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    restored_step = b_state.step
    for b in feed[3:]:
        b_state, _ = step_fn(b_state, *b)
    sa, sb = a.state_dict(), b_state.state_dict()
    flat = lambda sd: {f"{n}.{k}": t for n, v in sd["opt_state"]["moments"].items()
                       for k, t in v.items()} | {f"param.{n}": t for n, t in sd["params"].items()}
    fa, fb = flat(sa), flat(sb)
    unequal = [k for k in fa if not torch.equal(fa[k], fb[k].to(fa[k].device))]
    counters = [(int(sa[k]), int(sb[k])) for k in ("step",)] + [
        (int(sa["opt_state"][k]), int(sb["opt_state"][k])) for k in ("mini_step", "gradient_step")]
    ckpt.save(mgr, 6, a)
    emit("train_ckpt", layers=cfg.num_layers, hidden=cfg.hidden_size, bytes_on_disk=on_disk,
         save_s=save_s, restore_s=restore_s, restored_step=restored_step,
         tensors_compared=len(fa), unequal=unequal, counters=counters, kept=mgr.all_steps())
    check(restored_step == 3, f"restored step {restored_step}")
    check(not unequal, f"resumed run differs in {unequal[:5]}")
    check(all(x == y for x, y in counters), f"counters {counters}")
    check(mgr.all_steps() == [6], f"max_keep=1 left {mgr.all_steps()}")
    del a, b_state, sa, sb, fa, fb
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_cli(dev, root: str):
    """python -m sjd_tpu_torch.parallel.finetune --synthetic --model tiny
    --steps 20 --save-interval 10 on the card as a process, then the same
    with --resume --steps 30: both exit 0, the second resumes at step 20,
    and its final loss is finite."""
    ckpt_dir = os.path.relpath(os.path.join(root, "cli"), HERE)
    runs = []
    for extra in ([], ["--resume", "--steps", "30"]):
        t0 = time.time()
        out = subprocess.run(
            [sys.executable, "-m", "sjd_tpu_torch.parallel.finetune", "--synthetic",
             "--model", "tiny", "--steps", "20", "--save-interval", "10", "--ckpt-dir",
             ckpt_dir, *extra], cwd=HERE, capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"finetune {extra} exited {out.returncode}: "
                                   f"{out.stderr[-3000:]}")
        final = json.loads(out.stdout[out.stdout.rindex('{"final_loss"'):].splitlines()[0])
        runs.append(dict(args=extra, seconds=time.time() - t0, final=final,
                         resumed=[ln.split("INFO ")[-1] for ln in out.stdout.splitlines()
                                  if "resumed at step" in ln]))
    emit("train_cli", runs=runs)
    check(runs[1]["resumed"] == ["resumed at step 20"], f"resume logged {runs[1]['resumed']}")
    check(runs[1]["final"]["steps"] == 30 and math.isfinite(runs[1]["final"]["final_loss"]),
          f"final {runs[1]['final']}")


# -- VQGAN tokenizer training -----------------------------------------------------

VQ_DIR = os.path.join(HERE, "build", "chip_smoke_vq")
VQ_SIZE, VQ_BATCH = 256, 8  # vq_train's cell: LlamaGen VQ-16 at 256px, batch 8
VQ_CLI_KEYS = ["step", "loss", "recon", "perceptual", "gan_g", "d_loss", "usage", "img_per_s"]
TF32_TFLOPS = 495e12  # dense TF32 tensor cores


def _vq_configs(disc_type: str, size: int):
    """The command line's configuration on LLAMAGEN_VQ16 in f32 (recon l2,
    perceptual 1.0, disc_start 0, disc_weight 0.5, the adaptive weight,
    hinge) with PatchGAN at n_layers 3, ndf 64, or StyleGAN at image_size
    ``size``: (cfg, tcfg, dcfg)."""
    import torch

    from sjd_tpu_torch.models.vq.discriminator import PatchGANConfig
    from sjd_tpu_torch.models.vq.discriminator_stylegan import StyleGANDiscConfig
    from sjd_tpu_torch.models.vq.taming import LLAMAGEN_VQ16
    from sjd_tpu_torch.models.vq.train import VQTrainConfig

    cfg = dataclasses.replace(LLAMAGEN_VQ16, dtype=torch.float32)
    tcfg = VQTrainConfig(recon_loss="l2", perceptual_weight=1.0, disc_start=0,
                         disc_weight=0.5, disc_adaptive_weight=True)
    dcfg = (StyleGANDiscConfig(image_size=size) if disc_type == "stylegan"
            else PatchGANConfig(n_layers=3, ndf=64))
    return cfg, tcfg, dcfg


def _vq_trainer(dev, disc_type: str, size: int):
    """_vq_configs' trainer with random VGG16 LPIPS on ``dev``: (cfg, steps,
    params)."""
    from sjd_tpu_torch.models.vq.lpips import init_lpips_params
    from sjd_tpu_torch.models.vq.taming import init_vq_params
    from sjd_tpu_torch.models.vq.train import make_vqgan_train_steps

    cfg, tcfg, dcfg = _vq_configs(disc_type, size)
    steps = make_vqgan_train_steps(cfg, tcfg, lpips_params=init_lpips_params(1, device=dev),
                                   disc_cfg=dcfg, disc_type=disc_type)
    return cfg, steps, init_vq_params(0, cfg, device=dev)


def phase_vq_train_pairs(dev, label: str, disc_type: str, timed: int,
                         size: int = VQ_SIZE, batch: int = VQ_BATCH) -> dict:
    """One warm-up G/D pair, then ``timed`` pairs of the VQ-16 trainer on
    the command line's synthetic batches, with cuDNN's TF32 on (PyTorch's
    default, as the command line runs): G and D seconds apart (CUDA events),
    the pair's host seconds, images per second, peak memory, the losses
    (finite), usage, the model FLOPs of a pair (torch's FlopCounterMode, one
    more pair) against TF32's peak; the EMA and D must move, and no kernel
    of sjd_tpu_torch/csrc may launch (none lies on this path)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sjd_tpu_torch.models.vq.train import tree_leaves
    from sjd_tpu_torch.models.vq.vq_train import synthetic_batches
    from sjd_tpu_torch.ops import launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg, (init_fn, g_step, d_step), params = _vq_trainer(dev, disc_type, size)
    g_opt, d_params, d_opt, ema = init_fn(params, 2)
    ema0 = [t.detach().clone() for t in tree_leaves(ema)]
    d0 = [t.detach().clone() for t in tree_leaves(d_params)]
    batches = synthetic_batches(size, batch, np.random.RandomState(0))
    xs = [torch.from_numpy(next(batches)).to(dev) for _ in range(timed + 2)]
    _zero_launch_counts()
    pairs = []
    for i, x in enumerate(xs[:timed + 1]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.time()
        ev[0].record()
        params, g_opt, ema, g_aux = g_step(params, g_opt, ema, d_params, x, i)
        ev[1].record()
        d_params, d_opt, d_aux = d_step(d_params, d_opt, params, x, i)
        ev[2].record()
        torch.cuda.synchronize()
        pairs.append(dict(pair_s=time.time() - t0, g_s=ev[0].elapsed_time(ev[1]) / 1e3,
                          d_s=ev[1].elapsed_time(ev[2]) / 1e3,
                          aux={k: float(v) for k, v in {**g_aux, **d_aux}.items()}))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as counter:
        g_step(params, g_opt, ema, d_params, xs[-1], timed + 1)
        d_step(d_params, d_opt, params, xs[-1], timed + 1)
    flops = counter.get_total_flops()
    timed_pairs = pairs[1:]
    pair_s = statistics.median(p["pair_s"] for p in timed_pairs)
    out = dict(disc_type=disc_type, size=size, batch=batch, timed_pairs=timed,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               g_params=sum(t.numel() for t in tree_leaves(params)),
               d_params=sum(t.numel() for t in tree_leaves(d_params)),
               warmup_pair_s=pairs[0]["pair_s"], g_s=statistics.median(
                   p["g_s"] for p in timed_pairs),
               d_s=statistics.median(p["d_s"] for p in timed_pairs), pair_s=pair_s,
               pair_s_all=[p["pair_s"] for p in timed_pairs], images_per_s=batch / pair_s,
               peak_mem_gb=peak / 1e9, resident_before_gb=base / 1e9,
               flops_per_pair=flops, tf32_peak_share=flops / pair_s / TF32_TFLOPS,
               aux=[p["aux"] for p in pairs], kernel_launches=launches,
               ema_moved=any(not torch.equal(a, b) for a, b in zip(ema0, tree_leaves(ema))),
               d_moved=any(not torch.equal(a, b) for a, b in zip(d0, tree_leaves(d_params))))
    emit(label, **out)
    for p in pairs:
        check(all(math.isfinite(v) for v in p["aux"].values()), f"{label}: aux {p['aux']}")
        check(0 < p["aux"]["usage"] <= 1 and p["aux"]["disc_w"] > 0, f"{label}: {p['aux']}")
    check(out["ema_moved"] and out["d_moved"], f"{label}: EMA or D did not move")
    check(not any(launches.values()), f"{label}: kernels launched on the VQ path: {launches}")
    return out


def _vq_pair_parts(dev, size: int = 64, batch: int = 2):
    """One G/D pair's losses and gradients from weights drawn on the CPU:
    (G aux, G grads, recon, D inputs)."""
    import numpy as np
    import torch

    from sjd_tpu_torch.models.vq import train as vt
    from sjd_tpu_torch.models.vq.discriminator import init_patchgan_params
    from sjd_tpu_torch.models.vq.lpips import init_lpips_params
    from sjd_tpu_torch.models.vq.taming import init_vq_params

    cfg, tcfg, dcfg = _vq_configs("patchgan", size)

    def move(tree):
        return vt._tree_map(lambda t: t.to(dev).requires_grad_(True), tree)

    params = move(init_vq_params(0, cfg, device="cpu"))
    d_params = move(init_patchgan_params(2, dcfg, device="cpu"))
    lp = vt._tree_map(lambda t: t.to(dev), init_lpips_params(1, device="cpu"))
    x = torch.from_numpy(np.tanh(np.random.RandomState(0).randn(batch, size, size, 3))
                         .astype(np.float32)).to(dev)
    loss, g_aux = vt.generator_loss(params, d_params, x, 0, cfg, tcfg, lpips_params=lp,
                                    disc_cfg=dcfg)
    g_grads = torch.autograd.grad(loss, vt.tree_leaves(params))
    with torch.no_grad():
        recon, _ = vt._vq_forward(params, cfg, x)
    return vt._tree_map(torch.detach, g_aux), g_grads, recon, (d_params, x, tcfg, dcfg)


def _vq_d_parts(recon, d_args):
    import torch

    from sjd_tpu_torch.models.vq import train as vt

    d_params, x, tcfg, dcfg = d_args
    loss, d_aux = vt.discriminator_loss(d_params, x, recon.to(x.device), 0, tcfg, disc_cfg=dcfg)
    return vt._tree_map(torch.detach, d_aux), torch.autograd.grad(loss, vt.tree_leaves(d_params))


def _leaf_names(tree, prefix: str = "") -> list:
    """Paths of train.tree_leaves' leaves, in its order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]] if hasattr(tree, "shape") else []


def _vq_errors(want, got, names) -> dict:
    """Each aux value's relative error (the logits' means: absolute), and
    each gradient set's largest leaf error over that leaf's largest
    magnitude (a leaf under 1e-6 of the set's largest, 0 in exact
    arithmetic, over that floor), with the three worst leaves: (name, error,
    the leaf's largest magnitude over the set's)."""
    (w_aux, w_grads), (g_aux, g_grads) = want, got
    aux = {k: abs(float(g_aux[k]) - float(w)) / (1.0 if k.startswith("logits_") else abs(float(w)))
           for k, w in w_aux.items()}
    top = max(float(w.abs().max()) for w in w_grads)
    errs = sorted(((float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-6 * top),
                    n, float(w.abs().max()) / top) for n, w, g in zip(names, w_grads, g_grads)),
                  reverse=True)
    return dict(aux=aux, grad=errs[0][0], worst=[(n, e, m) for e, n, m in errs[:3]])


def phase_vq_train_card_cpu(dev) -> dict:
    """A 64px, batch-2 pair of the VQ-16 trainer's losses and gradients on
    the card and on the CPU from the same weights and pixels (the D half on
    the CPU's recon), with cuDNN's TF32 off (f32, as the JAX trainer) and
    on (PyTorch's default). TF32 off is held: each loss within 1e-3
    relative (the logits' means 1e-4 absolute), each gradient leaf within
    1e-2 of its largest magnitude (the leaves whose gradient cancels to
    1e-3-1e-4 of the largest, biases before a normalization, come to 2.3e-3
    in f32). TF32 on is reported; its losses must be finite and within 5e-2
    relative of the CPU's (recon, perceptual, loss)."""
    import torch

    want_g, want_gg, recon, want_d_args = _vq_pair_parts("cpu")
    want_d, want_dg = _vq_d_parts(recon, want_d_args)
    from sjd_tpu_torch.models.vq.discriminator import init_patchgan_params
    from sjd_tpu_torch.models.vq.taming import init_vq_params

    cfg, _, dcfg = _vq_configs("patchgan", 64)
    g_names = _leaf_names(init_vq_params(0, cfg, device="cpu"))
    d_names = _leaf_names(init_patchgan_params(2, dcfg, device="cpu"))
    out = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        got_g, got_gg, _, got_d_args = _vq_pair_parts(dev)
        got_d, got_dg = _vq_d_parts(recon, got_d_args)
        out["tf32" if tf32 else "f32"] = dict(
            g=_vq_errors((want_g, want_gg), (got_g, got_gg), g_names),
            d=_vq_errors((want_d, want_dg), (got_d, got_dg), d_names),
            card_aux={k: float(v) for k, v in {**got_g, **got_d}.items()})
    out["cpu_aux"] = {k: float(v) for k, v in {**want_g, **want_d}.items()}
    emit("vq_train_card_cpu", **out)
    for half in ("g", "d"):
        f32 = out["f32"][half]
        check(all(e <= (1e-4 if k.startswith("logits_") else 1e-3) for k, e in f32["aux"].items()),
              f"vq_train_card_cpu f32 {half} aux {f32['aux']}")
        check(f32["grad"] <= 1e-2, f"vq_train_card_cpu f32 {half} grad error {f32['worst']}")
    check(all(math.isfinite(v) for v in out["tf32"]["card_aux"].values()), "tf32 aux")
    check(all(out["tf32"]["g"]["aux"][k] <= 5e-2 for k in ("loss", "recon", "perceptual")),
          f"vq_train_card_cpu tf32 aux {out['tf32']['g']['aux']}")
    return out


def phase_vq_train_cli(dev, root: str) -> dict:
    """python -m sjd_tpu_torch.models.vq.vq_train as two processes started
    together: --synthetic, and --images over 6 PNGs written by write_png
    (80px, resized to 64), each --steps 4 --size 64 --batch 2 --save-every 2
    --log-every 1: exit 0, four JSON lines with the JAX script's keys, all
    finite, checkpoints at steps 2 and 4, the latest restored on the card
    with finite, trained parameters."""
    import numpy as np
    import torch

    from sjd_tpu_torch.models.vq.discriminator import PatchGANConfig, init_patchgan_params
    from sjd_tpu_torch.models.vq.taming import LLAMAGEN_VQ16, init_vq_params
    from sjd_tpu_torch.models.vq.train import _tree_map, tree_leaves
    from sjd_tpu_torch.utils.checkpoints import make_manager, restore
    from sjd_tpu_torch.utils.image_io import write_png

    images = os.path.join(root, "images")
    os.makedirs(images)
    rs = np.random.RandomState(3)
    for i in range(6):
        field = np.repeat(np.repeat(rs.rand(20, 20, 3), 4, axis=0), 4, axis=1)
        write_png(os.path.join(images, f"{i}.png"), (field * 255).astype(np.uint8))
    common = ["--steps", "4", "--size", "64", "--batch", "2", "--save-every", "2",
              "--log-every", "1"]
    outs = {"synthetic": os.path.join(root, "ck_synthetic"), "images": os.path.join(root, "ck_images")}
    results = _run_modules([
        ["sjd_tpu_torch.models.vq.vq_train", "--synthetic", *common, "--out", outs["synthetic"]],
        ["sjd_tpu_torch.models.vq.vq_train", "--images", images, *common, "--out",
         outs["images"]]], os.path.join(root, "logs"))
    cfg = dataclasses.replace(LLAMAGEN_VQ16, dtype=torch.float32)
    drawn = init_vq_params(0, cfg, device=dev)
    report = {}
    for (name, out_dir), (lines, sec) in zip(outs.items(), results):
        steps = make_manager(out_dir).all_steps()
        template = {"params": _tree_map(torch.zeros_like, drawn),
                    "ema": _tree_map(torch.zeros_like, drawn),
                    "disc": init_patchgan_params(2, PatchGANConfig(n_layers=3), device=dev)}
        back = restore(make_manager(out_dir), template)
        moved = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(back["params"]),
                                                                tree_leaves(drawn)))
        finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(back))
        report[name] = dict(seconds=sec, lines=lines, checkpoint_steps=steps,
                            restored_max_change=moved, restored_finite=finite)
        check([ln.get("step") for ln in lines] == [0, 1, 2, 3], f"vq_train_cli {name}: {lines}")
        check(all(list(ln) == VQ_CLI_KEYS and all(math.isfinite(v) for v in ln.values())
                  for ln in lines), f"vq_train_cli {name}: {lines}")
        check(steps == [2, 4] and finite and moved > 0, f"vq_train_cli {name}: {report[name]}")
    emit("vq_train_cli", **report)
    return report


# -- tensor- and data-parallel decoding ----------------------------------------

TP_DIR = os.path.join(HERE, "build", "chip_smoke_tp")
TP_RANKS = 2
TP_SIZE = 512  # tp_generate's image
# tp_generate's depth: each layer costs two gloo round trips per forward,
# 1.2-13.1 ms each between two ranks on one H100 80GB HBM3 (PERF.md §5), so
# the 512px image took 105-209 s at 32 layers and 141 s at 8; tp_window
# keeps all 32
TP_GENERATE_LAYERS = 2
DP_SIZE = 256  # dp_serve's images
DP_REQUESTS, DP_SLOTS = 6, 4
# the 34B command line's layers: both ranks share one card, and all 48 bf16
# layers (68.6 GB) would leave under 10 GB for two CUDA contexts, cuBLAS
# workspaces, the draw's temporaries and the caches
TP_34B_LAYERS = 24


def _window_logits(params, cfg, dev, prompt_ids, L: int = 512):
    """The prompt prefilled (row 1 its CFG uncond half, the prompt masked
    down to its last token), then one TP_WINDOW-token window of image
    tokens drawn from a fixed seed: (the window's f32 logits [2, W, V] on
    the host, each kernel's launches in that window's forward). ``params``
    may be one rank's shard (``parallel.shard_params``); its cache then
    holds the rank's KV heads."""
    import torch

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.chameleon import IMAGE_VOCAB_END, IMAGE_VOCAB_START
    from sjd_tpu_torch.ops import launch_counts

    S, P, W = 2, len(prompt_ids), 16
    g = torch.Generator().manual_seed(5)  # on the host: the same window everywhere
    win = torch.randint(IMAGE_VOCAB_START, IMAGE_VOCAB_END + 1, (1, W), generator=g)
    ids = torch.cat([torch.tensor([prompt_ids]), win], 1).expand(S, P + W).to(dev)
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    valid[1, :P - 1] = False
    pos = torch.clamp_min(torch.cumsum(valid[:, :P].int(), 1) - 1, 0)
    pos_w = pos[:, -1:] + 1 + torch.arange(W, device=dev)
    rope = pt.make_rope_table(cfg, L, device=dev)
    with torch.no_grad():
        kv = pt.init_kv_cache(cfg, S, L, device=dev,
                              model_size=getattr(params, "model_size", 1))
        zero = torch.zeros((S,), dtype=torch.int32, device=dev)
        pt.forward(params, cfg, ids[:, :P], pos, kv, zero, valid, rope)
        _zero_launch_counts()
        logits = pt.forward(params, cfg, ids[:, P:], pos_w, kv, zero + P, valid, rope).logits
        torch.cuda.synchronize()
        launches = launch_counts()
    return logits.cpu(), launches


def phase_tp_reference(dev, model, label: str) -> None:
    """The unsharded window of ``tp_window`` on the model this process
    holds, saved under TP_DIR for the ranks' check."""
    import torch

    ids = model.extras["prompt_ids_fn"](PROMPT)
    t0 = time.time()
    logits, launches = _window_logits(model.params, model.engine.model_cfg, dev, ids)
    os.makedirs(TP_DIR, exist_ok=True)
    torch.save({"ids": ids, "logits": logits}, os.path.join(TP_DIR, f"window_{label}.pt"))
    emit("tp_reference", weights=label, prompt_rows=len(ids), launches=launches,
         seconds=time.time() - t0)


def _dp_requests():
    """dp_serve's 6 requests at DP_SIZE px (12 text ids and the image
    header each) and their seeds."""
    import numpy as np

    rng = np.random.default_rng(17)
    prompts = np.asarray([list(map(int, rng.integers(9000, 13000, 12)))
                          + lumina_ids(DP_SIZE)[12:] for _ in range(DP_REQUESTS)], np.int32)
    return prompts, [601 + i for i in range(DP_REQUESTS)]


def _dp_serve(dev, params, cfg, row_sharding=None) -> dict:
    """The 6 requests through ContinuousBatcher (DP_SLOTS slots, chunks of
    64, each stopped at its image's end) on a graph engine: completions,
    refills, NFE, the engine's steps and the launches that ran."""
    import torch

    from sjd_tpu_torch.core.serving import ContinuousBatcher
    from sjd_tpu_torch.models.chameleon import IMAGE_END_ID, lumina_engine
    from sjd_tpu_torch.ops import launch_counts

    prompts, seeds = _dp_requests()
    eng = lumina_engine(target_size=DP_SIZE, model_cfg=cfg, device=dev)
    eng.config = dataclasses.replace(eng.config, eos_id=IMAGE_END_ID)
    batcher = ContinuousBatcher(eng, params, chunk_steps=64, row_sharding=row_sharding)
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.time()
    done = batcher.run(None, prompts, batch=DP_SLOTS, seeds=seeds)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    st = eng.stats
    return dict(done=[(c.prompt_index, c.tokens.tolist(), int(c.gen_count)) for c in done],
                refills=[(sorted(r["refilled"].items()), r["live"]) for r in batcher.last_refills],
                nfe=batcher.last_nfe, accept_hist=batcher.last_accept_hist.tolist(),
                seconds=seconds, launches=st.executed(launch_counts()), captures=st.captures,
                replays=st.replays, eager_steps=st.eager_steps,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, table=per_forward(params, cfg))


def phase_dp_reference(dev, model) -> None:
    """dp_serve's stream on one process, on the W4A16 7B this process
    holds, saved under TP_DIR."""
    import torch

    out = _dp_serve(dev, model.params, model.engine.model_cfg)
    torch.save(out, os.path.join(TP_DIR, "dp_reference.pt"))
    emit("dp_reference", requests=DP_REQUESTS, slots=DP_SLOTS, size=DP_SIZE, nfe=out["nfe"],
         gen_counts=[c[2] for c in out["done"]], seconds=out["seconds"])


def _collective_ms(dev, group, reps: int = 50) -> dict:
    """Host-clock ms of one gloo collective over ``group`` on the card's
    tensors, as the TP forward issues them on the 7B: the all-reduce of a
    window's [2, 16, 4096] bf16 partial sum, and the all-gather of its
    [2, 16, 32768] f32 vocabulary shard (gloo stages both through host
    memory)."""
    import torch
    import torch.distributed as dist

    x = torch.ones((2, 16, 4096), dtype=torch.bfloat16, device=dev)
    part = torch.ones((2 * 16, 32768), dtype=torch.float32, device=dev)
    whole = torch.empty((TP_RANKS * 2 * 16, 32768), dtype=torch.float32, device=dev)
    out = {}
    for name, call in (("all_reduce_bf16_2x16x4096", lambda: dist.all_reduce(x, group=group)),
                       ("all_gather_f32_2x16x32768",
                        lambda: dist.all_gather_into_tensor(whole, part, group=group))):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def _tp_generate(dev, model, params, cfg) -> dict:
    """One TP_SIZE px image on the first TP_GENERATE_LAYERS layers of this
    rank's shard, every step eager: tokens, NFE, the launches that ran,
    wall seconds, peak memory; rank 0 decodes the image."""
    import torch
    import torch.distributed as dist

    from sjd_tpu_torch.data.item_processor import split_generation
    from sjd_tpu_torch.models.chameleon import IMAGE_END_ID, lumina_engine
    from sjd_tpu_torch.ops import launch_counts
    from sjd_tpu_torch.parallel import LocalParams

    n = TP_GENERATE_LAYERS
    params = LocalParams(dict(params, layers={k: v[:n] for k, v in params["layers"].items()}),
                         params.axis, params.mesh)
    cfg = dataclasses.replace(cfg, num_layers=n)

    eng = lumina_engine(target_size=TP_SIZE, cuda_graph=False, model_cfg=cfg, device=dev)
    eng.config = dataclasses.replace(eng.config, eos_id=IMAGE_END_ID)
    ids = model.extras["prompt_ids_fn"](PROMPT)
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.time()
    res = eng.generate(params, 0, torch.tensor([ids], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    toks = res.tokens[0, :int(res.length[0])].tolist()
    spans = [s for kind, s in split_generation(toks) if kind == "image"]
    out = dict(tokens=toks, nfe=int(res.nfe), wall_s=wall, ms_per_forward=1e3 * wall / res.nfe,
               launches=launches, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               table=per_forward(params, cfg),
               image_span=spans[-1] if spans else [], image_shape=None)
    if dist.get_rank() == 0:
        out["image_shape"] = list(model.extras["decode_image_fn"](toks).shape)
    return out


def _tp_rank(dev, out_dir: str) -> dict:
    """One rank of the 1 x TP_RANKS mesh: the gloo round trips, then the
    bf16 7B (the window and one image) and the W4A16 7B (the window), each
    loaded whole from the seed, sharded and freed."""
    import torch

    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.parallel import decoder_param_specs, make_mesh, shard_params

    mesh = make_mesh(data=1, model=TP_RANKS, device=dev)
    out = {"collective_ms": _collective_ms(dev, mesh.get_group("model"))}
    for label, quantize in (("bf16", False), ("w4a16", 4)):
        ref = torch.load(os.path.join(out_dir, f"window_{label}.pt"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        model = load_lumina_mgpt(target_size=TP_SIZE, quantize=quantize, device=dev)
        cfg = model.engine.model_cfg
        local = shard_params(model.params, mesh, decoder_param_specs(cfg, tp=True), cfg=cfg)
        load_s = time.time() - t0
        logits, launches = _window_logits(local, cfg, dev, ref["ids"])
        out[f"window_{label}"] = dict(logits=logits, launches=launches, load_s=load_s,
                                      peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                      layers=cfg.num_layers, table=per_forward(local, cfg))
        if label == "bf16":
            out["generate"] = _tp_generate(dev, model, local, cfg)
        del model, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _dp_rank(dev) -> dict:
    """One data rank of the TP_RANKS x 1 mesh: the whole W4A16 7B and its
    own graph engine, the stream through ContinuousBatcher(row_sharding)."""
    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=TP_RANKS, model=1, device=dev)
    model = load_lumina_mgpt(target_size=DP_SIZE, quantize=4, device=dev)
    out = _dp_serve(dev, model.params, model.engine.model_cfg, row_sharding=mesh)
    out["data_rank"] = mesh.get_local_rank("data")
    return out


def _rank_main(rank: int, world: int, port: int, job: str, out_dir: str) -> None:
    """A spawned rank: joins the gloo group (every rank on the one card),
    runs ``job`` ("tp" or "dp") and saves its results under ``out_dir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from sjd_tpu_torch.parallel.dist import init_distributed

    torch.cuda.set_device(0)  # before any CUDA work: the ranks share the card
    dev = torch.device("cuda", 0)
    init_distributed(f"127.0.0.1:{port}", world, rank, device=dev, backend="gloo")
    t0 = time.time()
    out = _tp_rank(dev, out_dir) if job == "tp" else _dp_rank(dev)
    out.update(rank=rank, seconds=time.time() - t0)
    torch.save(out, os.path.join(out_dir, f"{job}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(job: str, timeout: int = 600) -> list:
    """TP_RANKS spawned processes running ``job`` together; each rank's
    results. A rank that fails or outlives ``timeout`` fails the phase, and
    no rank outlives the call."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, TP_RANKS, port, job, TP_DIR))
             for r in range(TP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"{job} ranks exited {[p.exitcode for p in procs]} (timeout {timeout} s)")
    return [torch.load(os.path.join(TP_DIR, f"{job}_rank{r}.pt")) for r in range(TP_RANKS)]


def phase_tp(dev) -> dict:
    """tp_window and tp_generate: the ranks of a 1 x 2 mesh on one card
    over gloo. Each rank loads the 7B whole from the seed and keeps its
    shard (shard_params). tp_window: the prompt prefilled, then one
    16-token window, bf16 and W4A16; each rank's logits within 5% of the
    largest unsharded logit (phase_tp_reference's) with the argmax equal at
    14 of 16 positions of each row, the ranks' logits bit-equal, and each
    rank's window forward launching each TPU kernel once per layer (and K1
    225 times on W4A16). tp_generate: one 512px image on the bf16 shards'
    first TP_GENERATE_LAYERS layers, every step eager (cuda_graph=False
    under a model axis): the ranks' tokens equal, 1024 image tokens in
    grammar, the image decoded on rank 0, each TPU kernel once per layer
    per forward on each rank. Returns rank 0's generate launches."""
    import torch

    t0 = time.time()
    ranks = _spawn_ranks("tp")
    seconds = time.time() - t0
    emit("tp_collectives", backend="gloo", ranks=TP_RANKS,
         ms_per_collective=[r["collective_ms"] for r in ranks])
    for label in ("bf16", "w4a16"):
        want = torch.load(os.path.join(TP_DIR, f"window_{label}.pt"))["logits"]
        scale = want.abs().max().item()
        got = [r[f"window_{label}"] for r in ranks]
        errs = [(g["logits"] - want).abs().max().item() for g in got]
        agree = [(g["logits"].argmax(-1) == want.argmax(-1)).sum(-1).tolist() for g in got]
        # where a rank's argmax differs: how far below the unsharded top
        # logit the unsharded logit of the rank's choice lies (a near-tie
        # is within the error)
        top = want.max(-1).values
        gaps = [(top - want.gather(-1, g["logits"].argmax(-1, keepdim=True))[..., 0])
                .max().item() for g in got]
        equal = all(torch.equal(g["logits"], got[0]["logits"]) for g in got)
        table = got[0]["table"]
        emit("tp_window", weights=label, mesh=[1, TP_RANKS], layers=got[0]["layers"],
             max_abs_err=errs, max_abs_logit=scale, tolerance=0.05 * scale,
             argmax_agree=agree, argmax_gap=gaps, ranks_bit_equal=equal,
             launches=[g["launches"] for g in got], launches_expected=table,
             load_s=[g["load_s"] for g in got], peak_gb=[g["peak_gb"] for g in got],
             peak_gb_sum=sum(g["peak_gb"] for g in got))
        check(all(math.isfinite(e) and e <= 0.05 * scale for e in errs),
              f"tp_window {label}: the ranks' logits are {errs} from the unsharded forward")
        check(all(n >= 14 for a in agree for n in a), f"tp_window {label}: argmax agrees {agree}")
        check(equal, f"tp_window {label}: the ranks' logits differ")
        for g in got:
            for k, n in table.items():
                check(g["launches"][k] == n, f"tp_window {label}: {k} launched "
                                             f"{g['launches'][k]} times, not {n}")
    gen = [r["generate"] for r in ranks]
    toks = gen[0]["tokens"]
    span = gen[0]["image_span"]
    grid = TP_SIZE // 16
    image_tokens = sum(4 <= t <= 8195 for t in span)
    table = gen[0]["table"]
    emit("tp_generate", mesh=[1, TP_RANKS], size=TP_SIZE, layers=TP_GENERATE_LAYERS,
         cuda_graph=False,
         tokens_generated=len(toks) - len(lumina_ids(TP_SIZE)), nfe=gen[0]["nfe"],
         ms_per_forward=[g["ms_per_forward"] for g in gen], wall_s=[g["wall_s"] for g in gen],
         peak_gb=[g["peak_gb"] for g in gen], peak_gb_sum=sum(g["peak_gb"] for g in gen),
         image_tokens=image_tokens,
         image_shape=gen[0]["image_shape"], launches=[g["launches"] for g in gen],
         launches_expected={k: n * gen[0]["nfe"] for k, n in table.items()},
         ranks_equal=all(g["tokens"] == toks for g in gen), phase_s=seconds)
    check(all(g["tokens"] == toks and g["nfe"] == gen[0]["nfe"] for g in gen),
          "tp_generate: the ranks generated different tokens")
    check(image_tokens == grid * grid and span[-1] == 8196,
          f"tp_generate: {image_tokens} image tokens, not {grid * grid} and <eoss>")
    check(gen[0]["image_shape"] == [TP_SIZE, TP_SIZE, 3],
          f"tp_generate: image {gen[0]['image_shape']}")
    for g in gen:
        for k, n in table.items():
            check(g["launches"][k] == n * g["nfe"],
                  f"tp_generate: {k} launched {g['launches'][k]} times in {g['nfe']} forwards")
    return gen[0]["launches"]


def phase_tp_34b(dev, layers: int = TP_34B_LAYERS, max_len: int = 64) -> dict:
    """python -m torch.distributed.run --nproc-per-node 2 -m
    sjd_tpu_torch.parallel.tp_decode --layers 24 --backend gloo --max-len 64:
    Chameleon-34B's full width at 24 of its 48 layers, both ranks on the
    card. It must exit 0 with grammar_ok, both ranks' tokens equal and each
    TPU kernel launched once per layer per forward on each rank. Returns
    rank 0's launches."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(TP_RANKS),
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         "-m", "sjd_tpu_torch.parallel.tp_decode", "--layers", str(layers), "--backend",
         "gloo", "--max-len", str(max_len)],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"tp_decode exited {out.returncode}: {out.stderr[-3000:]}")
    rep = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
    ranks = rep["ranks"]
    emit("tp_34b", seconds=time.time() - t0,
         **{k: v for k, v in rep.items() if k != "ranks"},
         ranks=ranks, peak_gb_sum=sum(r["peak_bytes"] for r in ranks) / 1e9)
    check(rep["grammar_ok"] and rep["ranks_equal"], f"tp_34b: grammar_ok "
          f"{rep['grammar_ok']}, ranks_equal {rep['ranks_equal']}")
    for r in ranks:
        for k in ("fused_epilogue", "decode_attention"):
            check(r["launches"][k] == layers * rep["nfe"],
                  f"tp_34b rank {r['rank']}: {k} launched {r['launches'][k]} times in "
                  f"{rep['nfe']} forwards of {layers} layers")
    return ranks[0]["launches"]


def phase_dp_serve(dev) -> None:
    """dp_serve: the W4A16 7B on a 2 x 1 mesh, each data rank the whole
    model and its own graph engine over its 2 of the 4 slots; the 6
    requests' completions (order, tokens, gen_count) and the refills (which
    slot took which request, and which were live) on every rank equal the
    one-process batcher's (phase_dp_reference); each rank's launches one
    per layer per forward it ran (its prefill, its refills, its steps)."""
    import torch

    t0 = time.time()
    ranks = _spawn_ranks("dp")
    want = torch.load(os.path.join(TP_DIR, "dp_reference.pt"))
    same = [r["done"] == want["done"] for r in ranks]
    same_refills = [r["refills"] == want["refills"] for r in ranks]
    forwards = []
    for r in ranks:
        mine = range(r["data_rank"] * DP_SLOTS // TP_RANKS,
                     (r["data_rank"] + 1) * DP_SLOTS // TP_RANKS)
        refills = sum(any(b in mine for b, _ in slots) for slots, _ in r["refills"])
        forwards.append(1 + refills + r["eager_steps"] + r["replays"])
    emit("dp_serve", mesh=[TP_RANKS, 1], requests=DP_REQUESTS, slots=DP_SLOTS, size=DP_SIZE,
         chunk_steps=64, equal_to_one_process=same, refills_equal=same_refills,
         nfe=[r["nfe"] for r in ranks], nfe_one_process=want["nfe"],
         gen_counts=[c[2] for c in ranks[0]["done"]], serve_s=[r["seconds"] for r in ranks],
         serve_s_one_process=want["seconds"], captures=[r["captures"] for r in ranks],
         replays=[r["replays"] for r in ranks], forwards=forwards,
         launches=[r["launches"] for r in ranks], peak_gb=[r["peak_gb"] for r in ranks],
         peak_gb_sum=sum(r["peak_gb"] for r in ranks), phase_s=time.time() - t0)
    check(all(same), "dp_serve: the data-parallel stream differs from one process'")
    check(all(same_refills), "dp_serve: the refills differ from one process'")
    for r, n in zip(ranks, forwards):
        for k, per in r["table"].items():
            check(r["launches"][k] == per * n,
                  f"dp_serve: {k} launched {r['launches'][k]} times in {n} forwards")


def phase_kernels_tp(dev) -> list:
    """Both TPU kernels at one rank's local shapes under TP=2 (what
    decode_attention_tp and the epilogue see on each rank): the 7B of
    tp_generate (16 query over 16 KV heads, 32 layers, int8 cache, the 512px
    buffer of 1536 rows, S = 2, W = 16) and the 34B of tp_34b (32 query
    heads over 4 KV heads, GQA group 8, swin-norm's qk-norm, 24 layers, bf16
    cache, S = 1, W = 4, an 88-row buffer). Returns the two cases' rows of
    the kernels line."""
    import torch

    src = dict(route="cuda")
    seven = dict(H=16, Hkv=16, NL=32, layer=31)
    ep7 = _epilogue_case(dev, "tp2_7b", 2, 1536, (700, 700), 61, **seven)
    valid = torch.ones((2, 1536), dtype=torch.bool, device=dev)
    valid[1, :14] = False  # the CFG uncond half masks its prompt rows
    at7 = _attention_cases(dev, "tp2_7b", 2, 1536, valid, [(150, 150), (700, 700), (1040, 1040)],
                           ("int8",), 62, **seven)
    big = dict(H=32, Hkv=4, NL=TP_34B_LAYERS, layer=TP_34B_LAYERS - 1)
    ep34 = [_epilogue_case(dev, "tp2_34b", 1, 88, (e,), 63 + i, quantize=False, T=4, **big)
            for i, e in enumerate((11, 80))]
    at34 = _attention_cases(dev, "tp2_34b", 1, 88, torch.ones((1, 88), dtype=torch.bool,
                                                              device=dev),
                            [(11,), (80,)], ("bf16",), 65, W=4, **big)
    main7 = next(r for r in at7 if r["fill"][0] == 700)
    return [
        _kernel_row(ep7, name="fused_epilogue", case="tp2_7b",
                    source="sjd_tpu_torch/csrc/fused_epilogue.cu",
                    replaces="sjd_tpu/ops/fused_epilogue.py:35",
                    max_abs_err=max(ep7["max_abs_err"].values()), **src),
        _kernel_row(main7, name="decode_attention", case="tp2_7b",
                    source="sjd_tpu_torch/csrc/decode_attention.cu",
                    replaces="sjd_tpu/ops/decode_attention.py:268",
                    max_abs_err=max(r["max_abs_err"] for r in at7), **src),
        _kernel_row(ep34[1], name="fused_epilogue", case="tp2_34b",
                    source="sjd_tpu_torch/csrc/fused_epilogue.cu",
                    replaces="sjd_tpu/ops/fused_epilogue.py:35",
                    max_abs_err=max(max(r["max_abs_err"].values()) for r in ep34), **src),
        _kernel_row(at34[1], name="decode_attention", case="tp2_34b",
                    source="sjd_tpu_torch/csrc/decode_attention.cu",
                    replaces="sjd_tpu/ops/decode_attention.py:268",
                    max_abs_err=max(r["max_abs_err"] for r in at34), **src),
    ]


# --------------------------------------------------------------------------
# the user-facing entry points (sjd_tpu_torch/examples)
# --------------------------------------------------------------------------

CLI_DIR = os.path.join(HERE, "build", "chip_smoke_cli")
DEMO_SIZE = 256  # the served images: 16 x 17 tokens, so that solo reruns are short
DEMO_CAPTIONS = {601: "a red fox in the snow", 602: "a lighthouse at dusk",
                 603: "three green apples"}
# examples/latency_budget.py:104-262, examples/hbm_bw_probe.py:75-155
BUDGET_KEYS = {"weights_floor_ms", "fwd_ms", "fwd_half_layers_ms", "fwd_small_head_ms",
               "sampling_ms", "dispatch_ms", "engine_step_lowfill_ms", "nfe_sampled_lowfill",
               "engine_step_highfill_ms", "nfe_sampled_highfill", "config"}
PROBE_KEYS = {"stream_bf16_gbps", "stream_bf16_ms", "stream_s4_gbps", "stream_s4_ms",
              "dot_s4_gbps", "dot_s4_ms", "stream_s8_gbps", "stream_s8_ms_half",
              "dot_s8_gbps", "dot_s8_ms_half"}
QUANT_FIDELITY_VARIANTS = ["int8", "int4_equil", "int4_raw", "int4_a8"]


class _Served:
    """A demo_server.build_server server on a free port, serving from a
    thread, with JSON requests."""

    def __init__(self, model, *flags):
        import threading

        from sjd_tpu_torch.examples import demo_server

        self.args = demo_server.parse_args(["--model", "lumina_mgpt", "--port", "0",
                                            "--target-size", str(DEMO_SIZE), *flags])
        t0 = time.time()
        self.server = demo_server.build_server(model, self.args)
        self.build_s = time.time() - t0
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=120)
        check(not self.thread.is_alive(), "the demo server's thread did not stop")

    def request(self, path, body=None, timeout=300):
        return _http(self.url + path, body, timeout)


def _http(url, body=None, timeout=300):
    """(status, body bytes) of a GET, or of a POST of ``body`` as JSON."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_demo_server(dev):
    """demo_server: sjd_tpu_torch.examples.demo_server in-process on
    Lumina-mGPT-7B at W4A16 with a tokenizer and the bf16 VQ (as --slots 2
    loads it), at 256px. A --slots 2 server (StreamingBatcher, prompt
    bucket 15 + 256, chunk 64): its start-up warm-up request, then 3
    concurrent POST /generate with their own seeds, each PNG equal to the
    same request run alone on the same engine (the same left-padded prompt
    and per-request generator: W4A16 rows do not depend on the batch
    width); /health counting 3 served; the page; /generate_i2i refused with
    500. The launch counts start at 0 before the server and are read after
    its close: each TPU kernel 32 per decode forward (the 271-row prefills
    and refills take the plain path) and K1 225 per forward. Then a --slots
    1 server on the same model answers /generate_i2i with a 500 x 400 PNG
    upload (fitted to its 1120 x 896 crop without PIL) and /freeform,
    and refuses a JPEG upload with 500 naming PIL while PIL cannot be
    imported (the card's machine may have PIL: it is blocked for the
    request)."""
    import base64
    import importlib.util
    import threading

    import numpy as np
    import torch

    from sjd_tpu_torch.core.serving import seed_generators
    from sjd_tpu_torch.loader import load_lumina_mgpt
    from sjd_tpu_torch.utils.image_io import decode_png, encode_png

    t_phase = time.time()
    model = load_lumina_mgpt(target_size=DEMO_SIZE, quantize=4, tokenizer=ImgTokenizer(),
                             vq_dtype=torch.bfloat16, device=dev)
    eng = model.engine
    table = per_forward(model.params, eng.model_cfg)
    _zero_launch_counts()
    slots = _Served(model, "--slots", "2", "--chunk-steps", "64")
    out = {}

    def client(seed):
        out[seed] = slots.request("/generate", {"prompt": DEMO_CAPTIONS[seed], "seed": seed})

    try:
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(s,)) for s in DEMO_CAPTIONS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        serve_s = time.time() - t0
        check(not any(t.is_alive() for t in threads), "a demo_server client hung")
        health = json.loads(slots.request("/health")[1])
        page_status, page = slots.request("/")
        i2i_status, i2i_body = slots.request("/generate_i2i", {"prompt": "x <|image|>",
                                                               "images": []})
    finally:
        slots.close()
    launches = _executed(eng)
    stats = slots.server.streamer.stats()
    decode_fwd = eng.stats.eager_steps + eng.stats.replays
    prefill_fwd = stats["batches"] + stats["refills"]
    expected = {k: n * (decode_fwd + prefill_fwd if k.startswith("quant") else decode_fwd)
                for k, n in table.items()}
    same, width = {}, slots.server.streamer.P
    for seed, caption in DEMO_CAPTIONS.items():
        status, body = out[seed]
        check(status == 200, f"demo_server /generate {seed}: HTTP {status} {body[:300]}")
        ids = model.extras["prompt_ids_fn"](caption)
        pad = width - len(ids)
        alone = eng.generate(model.params, seed_generators([seed], dev),
                             torch.tensor([[0] * pad + ids], dtype=torch.int32, device=dev),
                             prompt_mask=torch.tensor([[False] * pad + [True] * len(ids)],
                                                      device=dev))
        want = model.extras["decode_image_fn"](alone.tokens[0, :int(alone.length[0])].tolist())
        got = decode_png(body)
        same[seed] = bool(got.shape == want.shape and np.array_equal(got, want))

    serial = _Served(model, "--slots", "1")
    try:
        yy, xx = np.mgrid[0:400, 0:500] / 500
        upload = np.clip(np.stack([np.sin(6 * xx), np.cos(5 * yy), xx * yy * 2 - 1], -1)
                         * 100 + 128, 0, 255).astype(np.uint8)
        t0 = time.time()
        up_status, up_body = serial.request("/generate_i2i", {
            "prompt": "<|image|> the same scene at night", "seed": 3,
            "images": [base64.b64encode(encode_png(upload)).decode()]})
        i2i_s = time.time() - t0
        i2i_prompt = int(model.extras["last_result"].length[0]
                         - model.extras["last_result"].gen_count[0])
        ff_status, ff_body = serial.request("/freeform", {
            "qas": [["draw a fox", "a fox"], ["now the fox at night", None]], "seed": 4})
        # a JPEG upload with PIL unimportable, as on a machine without it
        jpeg = {"prompt": "<|image|>", "seed": 5}
        pil = sys.modules.get("PIL")
        sys.modules["PIL"] = None
        try:
            jpeg_status, jpeg_body = serial.request("/generate_i2i", dict(jpeg, images=[
                base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(64)).decode()]))
        finally:
            if pil is None:
                del sys.modules["PIL"]
            else:
                sys.modules["PIL"] = pil
        serial_health = json.loads(serial.request("/health")[1])
    finally:
        serial.close()
    emit("demo_server", size=DEMO_SIZE, slots=2, requests=len(DEMO_CAPTIONS),
         build_s=slots.build_s, warmup_s=slots.server.warmup_s, serve_s=serve_s,
         health=health, equal_to_solo=same, prompt_width=width, stats=stats,
         decode_forwards=decode_fwd, prefill_forwards=prefill_fwd, launches=launches,
         launches_expected=expected, captures=eng.stats.captures,
         i2i_under_slots=[i2i_status, json.loads(i2i_body)],
         serial_build_s=serial.build_s, i2i_upload=[500, 400], i2i_status=up_status,
         i2i_s=i2i_s, i2i_prompt_tokens=i2i_prompt, freeform_status=ff_status,
         jpeg_status=jpeg_status, jpeg_error=json.loads(jpeg_body) if jpeg_status != 200
         else None, pil_installed=importlib.util.find_spec("PIL") is not None,
         serial_health=serial_health,
         phase_s=time.time() - t_phase)
    check(all(same.values()), f"demo_server: PNGs differ from their solo runs: {same}")
    check(health["served"] == 3 and health["completed"] == 4,
          f"demo_server: /health {health}")
    check(page_status == 200 and b"/generate_i2i" in page, "demo_server: no page at /")
    check(i2i_status == 500 and "--slots > 1" in json.loads(i2i_body)["error"],
          "demo_server: /generate_i2i was not refused under --slots 2")
    for name, n in launches.items():
        check(n == expected[name], f"demo_server: {name} launched {n} times, not "
                                   f"{expected[name]}")
    for status, body, what in ((up_status, up_body, "/generate_i2i"),
                               (ff_status, ff_body, "/freeform")):
        check(status == 200 and decode_png(body).shape == (DEMO_SIZE, DEMO_SIZE, 3),
              f"demo_server {what}: HTTP {status} {body[:300]}")
    # the 500 x 400 upload fitted to 1120 x 896: 56 rows of 70 latents and a
    # <new_line>, the header and <image_end>, beside the text
    check(i2i_prompt > 56 * 71 + 4, f"demo_server: an i2i prompt of {i2i_prompt} tokens")
    check(jpeg_status == 500 and "PIL" in json.loads(jpeg_body)["error"],
          f"demo_server: a JPEG without PIL gave {jpeg_status} {jpeg_body[:300]}")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_cli(dev, root: str):
    """cli_generate and cli_demo_server: the command lines as a user runs
    them, as processes. First python -m sjd_tpu_torch.examples.demo_server
    with its defaults (LlamaGen GPT-B c2i, latent 8, one slot) on a free
    port; then, started together, generate_lumina_mgpt at 768px W4A16 with
    --num-repeats 2, generate_emu3 (the 8B at full width and depth, its
    W8A16 default, --image-area 65536), generate_llamagen (GPT-XL, latent
    16, class 207), generate_image2image at 512px (bf16) and quant_fidelity
    (8 layers at the 7B's widths): each exits 0 with its image of the
    stated shape, quant_fidelity with the JAX script's keys and KL int8 <=
    int4_equil < int4_raw. Then the server, up since, answers /health and
    one /generate; its start-up line shows 0 nvcc builds (the build phase
    built the kernels) and the libraries loaded from build/; it is
    terminated."""
    import numpy as np

    from sjd_tpu_torch.utils.image_io import decode_png, read_png

    t_phase = time.time()
    port = _free_port()
    log = open(os.path.join(root, "demo_server.out"), "w+")
    server = subprocess.Popen([sys.executable, "-m", "sjd_tpu_torch.examples.demo_server",
                               "--port", str(port)], cwd=HERE, stdout=log,
                              stderr=subprocess.STDOUT, text=True)
    try:
        shapes = {"lumina": (TARGET_SIZE, 2 * TARGET_SIZE, 3), "emu3": (256, 256, 3),
                  "llamagen": (256, 256, 3), "i2i": (512, 512, 3)}
        outs = {k: os.path.join(root, f"{k}.png") for k in shapes}
        runs = _run_modules([
            ["sjd_tpu_torch.examples.generate_lumina_mgpt", "--target-size", "768",
             "--quantize", "4", "--num-repeats", "2", "--out", outs["lumina"]],
            ["sjd_tpu_torch.examples.generate_emu3", "--image-area", "65536",
             "--out", outs["emu3"]],
            ["sjd_tpu_torch.examples.generate_llamagen", "--gpt-model", "GPT-XL",
             "--latent-size", "16", "--prompt", "207", "--out", outs["llamagen"]],
            ["sjd_tpu_torch.examples.generate_image2image", "--target-size", "512",
             "--out", outs["i2i"]],
            ["sjd_tpu_torch.examples.quant_fidelity"]], os.path.join(root, "logs"))
        cli_s = time.time() - t_phase
        images = {k: read_png(p) for k, p in outs.items()}
        (qf,), qf_s = runs[-1]
        kl = {k: v["kl"] for k, v in qf["variants"].items()}
        emit("cli_generate", seconds={k: s for k, (_, s) in zip(
                 ["lumina", "emu3", "llamagen", "i2i", "quant_fidelity"], runs)},
             phase_s=cli_s, shapes={k: list(a.shape) for k, a in images.items()},
             quant_fidelity=qf)
        for k, a in images.items():
            check(a.shape == shapes[k] and a.dtype == np.uint8,
                  f"cli_generate {k}: an image of {a.shape} {a.dtype}, not {shapes[k]}")
        check(list(qf) == ["mode", "config", "variants"]
              and list(qf["variants"]) == QUANT_FIDELITY_VARIANTS
              and all(list(v) == ["kl", "top1_agree", "rel_mse_last_layer",
                                  "rel_mse_per_layer"] for v in qf["variants"].values()),
              f"quant_fidelity printed {qf}")
        check(qf["config"] == "4096d/11008ff/65536V x 8L", f"quant_fidelity: {qf['config']}")
        check(kl["int8"] <= kl["int4_equil"] < kl["int4_raw"], f"quant_fidelity KL: {kl}")

        t0 = time.time()
        while True:
            log.seek(0)
            text = log.read()
            if "serving " in text or server.poll() is not None:
                break
            check(time.time() - t0 < 300, "demo_server did not start within 300 s")
            time.sleep(0.5)
        check(server.poll() is None, f"demo_server exited {server.returncode}: {text[-3000:]}")
        startup = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
        check(len(startup) == 1, f"demo_server printed {startup}")
        startup = startup[0]
        url = f"http://127.0.0.1:{port}"
        h_status, health = _http(url + "/health")
        t0 = time.time()
        g_status, png = _http(url + "/generate", {"prompt": "207", "seed": 1})
        generate_s = time.time() - t0
    finally:
        server.terminate()
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        log.close()
    health = json.loads(health)
    emit("cli_demo_server", startup=startup, health=health, generate_s=generate_s,
         phase_s=time.time() - t_phase)
    check(h_status == 200 and health["model"] == "llamagen-GPT-B" and health["slots"] == 1,
          f"demo_server /health: {h_status} {health}")
    check(g_status == 200 and decode_png(png).shape == (128, 128, 3),
          f"demo_server /generate: HTTP {g_status}")
    check(startup["builds"] == 0 and startup["library_hits"] >= 2
          and startup["captures"] == 1 and startup["warmup_steps"] == 1,
          f"demo_server start-up: {startup}")


def _in_process(main, argv) -> dict:
    """The one JSON object a command line's ``main(argv)`` prints."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"expected one JSON line, got {buf.getvalue()[-2000:]}")
    return lines[0]


def phase_latency_budget(dev):
    """latency_budget: python -m sjd_tpu_torch.examples.latency_budget's
    main, alone on the card (W4A16 7B with the int8 head, CFG batch 2,
    window 16, int8 KV): every JAX key present and finite; weights_floor
    beside the bytes bound of the weights it reads."""
    import numpy as np

    from sjd_tpu_torch.examples import latency_budget

    t0 = time.time()
    got = _in_process(latency_budget.main, ["--device", "cuda"])
    # what weights_floor reads: per layer the packed int4 codes and bf16
    # scales of 4 [4096, 4096], 2 [11008, 4096] and 1 [4096, 11008]
    # projections, then the int8 [65536, 4096] head and its scales
    shapes = [(4096, 4096)] * 4 + [(11008, 4096)] * 2 + [(4096, 11008)]
    read = 32 * sum(n * k // 2 + 2 * n for n, k in shapes) + 65536 * 4096 + 2 * 65536
    emit("latency_budget", **got, weights_read_gb=read / 1e9,
         weights_bound_ms=read / HBM_BYTES_PER_S * 1e3, phase_s=time.time() - t0)
    check(set(got) == BUDGET_KEYS, f"latency_budget keys: {sorted(got)}")
    check(all(np.isfinite(v) and v > 0 for k, v in got.items() if k != "config"),
          f"latency_budget: {got}")


def phase_hbm_bw_probe(dev):
    """hbm_bw_probe: python -m sjd_tpu_torch.examples.hbm_bw_probe's main,
    alone on the card: every JAX key present and finite, and no rate above
    105% of the spec sheet's 3350 GB/s. Beside it, the rate of PyTorch's
    sum over the same 1.6 GB as int8 elements, which goes through a float
    copy of the buffer (the probe reads the bytes as bf16 pairs)."""
    import numpy as np
    import torch

    from sjd_tpu_torch.eval.latency import seconds_per_call
    from sjd_tpu_torch.examples import hbm_bw_probe

    t0 = time.time()
    got = _in_process(hbm_bw_probe.main, ["--device", "cuda"])
    w8 = torch.ones((hbm_bw_probe.BLOCKS // 2, hbm_bw_probe.N, hbm_bw_probe.K),
                    dtype=torch.int8, device=dev)
    acc = torch.zeros((), device=dev)
    byte_s = seconds_per_call(lambda: acc.add_(torch.sum(w8, dtype=torch.float32)), dev, 10)
    emit("hbm_bw_probe", **got, spec_gbps=HBM_BYTES_PER_S / 1e9,
         int8_elements_sum_gbps=w8.numel() / byte_s / 1e9, phase_s=time.time() - t0)
    del w8
    check(set(got) == PROBE_KEYS, f"hbm_bw_probe keys: {sorted(got)}")
    check(all(np.isfinite(v) and v > 0 for v in got.values()), f"hbm_bw_probe: {got}")
    for k, v in got.items():
        check(not k.endswith("_gbps") or v <= 1.05 * HBM_BYTES_PER_S / 1e9,
              f"hbm_bw_probe: {k} = {v} GB/s, over 105% of the spec sheet")


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
    kernels += phase_quant_kernels(dev)
    kernels += [phase_epilogue_emu3(dev), phase_attention_emu3(dev)]
    kernels += [phase_epilogue_llamagen(dev), phase_attention_llamagen(dev)]
    kernels += [phase_epilogue_llamagen_3b(dev), phase_attention_llamagen_3b(dev)]
    kernels += phase_kernels_tp(dev)
    phase_forward(dev)
    phase_quant_forward(dev)
    # the unsharded references of the tensor- and data-parallel phases at the
    # end, computed while this process holds the models, under TP_DIR
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    model = phase_load(dev)
    ids = model.extras["prompt_ids_fn"](PROMPT)
    cfg = model.engine.model_cfg
    phase_tp_reference(dev, model, "bf16")
    phase_graph(dev, model.params, cfg, ids)
    launches = phase_generate(dev, model)
    phase_serve(dev, model)
    phase_widths(dev, model.params, cfg, "widths_bf16", hold=False)
    phase_ar_fast_path(dev, model, ids, "ar_fast_path", turns=True)
    phase_decompose(dev, model, ids)
    # evaluation on the bf16 7B: the latency probes and the harness
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    os.makedirs(EVAL_DIR)
    phase_eval_latency(dev, model)
    gen_dir = phase_eval_harness_tokens(dev, model, EVAL_DIR)
    # W4A8 with the int8 embedding, quantized on the card from the bf16
    # weights (no second draw), as load_lumina_mgpt(quantize="w4a8",
    # embed_bits=8) would hold them
    from sjd_tpu_torch.models.transformer import quantize_weights

    w4a8 = quantize_weights(model.params, bits=4, head_bits=8, equilibrate=False,
                            embed_bits=8)
    cfg8 = dataclasses.replace(cfg, act_quant="int8")
    a8 = phase_graph(dev, w4a8, cfg8, ids, label="quant_serve")
    del model, w4a8
    gc.collect()
    torch.cuda.empty_cache()
    qmodel = phase_load(dev, quantize=4, label="quant_load")
    qcfg = qmodel.engine.model_cfg
    phase_tp_reference(dev, qmodel, "w4a16")
    phase_dp_reference(dev, qmodel)
    phase_graph(dev, qmodel.params, qcfg, ids, label="quant_graph")
    a16 = phase_generate(dev, qmodel, label="quant_generate")
    phase_widths(dev, qmodel.params, qcfg, "widths_w4a16", hold=True)
    phase_ar_fast_path(dev, qmodel, lumina_ids(256), "ar_fast_path_w4a16", size=256,
                       greedy=True, hold=True)
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    # checkpoints from disk: written under build/ (git-ignored), removed
    # once read
    root = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    try:
        ckpt_dir, vq_path, tok = phase_ckpt(dev, root)
        cmodel = phase_ckpt_load_w4a16(dev, ckpt_dir, vq_path, tok)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_generate(dev, cmodel, label="ckpt_generate")
    phase_image_input(dev, cmodel)
    phase_stream(dev, cmodel)
    del cmodel
    gc.collect()
    torch.cuda.empty_cache()
    phase_chameleon_34b(dev)
    # Emu3-Gen 8B at 720px, then Anole-7B
    from sjd_tpu_torch.models.emu3 import emu3_engine

    emodel = phase_emu3_load(dev)
    ecfg = emodel.engine.model_cfg
    phase_emu3_forward(dev, emodel)
    phase_graph(dev, emodel.params, ecfg, emodel.extras["prompt_ids_fn"](PROMPT),
                label="emu3_graph", neg_ids=emodel.extras["neg_ids_fn"](),
                make_engine=lambda graph: emu3_engine(cuda_graph=graph, model_cfg=ecfg,
                                                      init="repeat_horizon", device=dev))
    e_launches = phase_emu3_generate(dev, emodel)
    phase_emu3_understand(dev, emodel)
    phase_emu3_understand_chunked(dev, emodel)
    del emodel
    gc.collect()
    torch.cuda.empty_cache()
    phase_anole(dev)
    # LlamaGen GPT-XL: t2i at 512px with the T5 encoder, the 256px bench
    # row, the embedding-mode stream, then c2i on W4A16 weights
    from sjd_tpu_torch.models.llamagen import llamagen_engine

    lmodel = phase_llamagen_load(dev)
    lcfg = lmodel.engine.model_cfg
    phase_llamagen_forward(dev, lmodel)
    pe, ne, mask = lmodel.extras["embed_prompt_fn"](LLAMAGEN_CAPTION)
    phase_graph(dev, lmodel.params, lcfg, None, label="llamagen_graph",
                embeds=dict(prompt_embeds=pe, neg_prompt_embeds=ne, prompt_mask=mask),
                make_engine=lambda graph: llamagen_engine(
                    name="GPT-XL", latent_size=32, cls_token_num=120, cuda_graph=graph,
                    model_cfg=lcfg, device=dev))
    l_launches = phase_llamagen_generate(dev, lmodel)
    phase_llamagen_bench(dev, lmodel)
    phase_llamagen_stream(dev, lmodel)
    del lmodel
    gc.collect()
    torch.cuda.empty_cache()
    phase_llamagen_c2i(dev)
    # LlamaGen GPT-3B c2i at 384px: heads of 100 through both kernels
    m3 = phase_llamagen_3b_load(dev)
    m3cfg = m3.engine.model_cfg
    pe, ne, mask = m3.extras["embed_prompt_fn"](LLAMAGEN_3B_CLASS)
    phase_graph(dev, m3.params, m3cfg, None, label="llamagen_3b_graph",
                embeds=dict(prompt_embeds=pe, neg_prompt_embeds=ne, prompt_mask=mask),
                make_engine=lambda graph: _llamagen_3b_engine(dev, m3cfg, cuda_graph=graph))
    l3_launches = phase_llamagen_3b_c2i(dev, m3)
    phase_llamagen_3b_options(dev, m3)
    ref_dir = phase_eval_harness_embeds(dev, m3, EVAL_DIR)
    del m3
    gc.collect()
    torch.cuda.empty_cache()
    # the scores and the command lines (which load their own 7B) on the
    # harness images, with the card to themselves
    try:
        ckpts = phase_eval_scores(dev, EVAL_DIR, gen_dir, ref_dir)
        gc.collect()
        torch.cuda.empty_cache()
        phase_eval_cli(dev, EVAL_DIR, gen_dir, ref_dir, ckpts)
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
    # fine-tuning: the data path, Chameleon-7B's train step, the trained
    # weights through both kernels, checkpoints and the command line, under
    # build/chip_smoke_train/ (removed at the end)
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    try:
        batches = phase_train_data(dev, TRAIN_DIR)
        state, cfg7 = phase_train_7b(dev, batches)
        phase_train_serve(dev, state.params, cfg7, batches[0])
        del state
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_ckpt(dev, batches, TRAIN_DIR)
        phase_train_cli(dev, TRAIN_DIR)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    # VQGAN tokenizer training (no kernel lies on it): VQ-16 at 256px with
    # PatchGAN, then StyleGAN, with cuDNN's TF32 on as the command line runs;
    # the card against the CPU; the command line, under build/chip_smoke_vq/
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(VQ_DIR, ignore_errors=True)
    os.makedirs(VQ_DIR)
    try:
        torch.backends.cudnn.allow_tf32 = True
        phase_vq_train_pairs(dev, "vq_train", "patchgan", timed=5)
        phase_vq_train_pairs(dev, "vq_train_stylegan", "stylegan", timed=2)
        phase_vq_train_card_cpu(dev)
        torch.backends.cudnn.allow_tf32 = False
        phase_vq_train_cli(dev, VQ_DIR)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        shutil.rmtree(VQ_DIR, ignore_errors=True)
    # tensor and data parallelism: ranks spawned on the one card over gloo,
    # every earlier model freed
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    try:
        tp_launches = phase_tp(dev)
        tp34_launches = phase_tp_34b(dev)
        phase_dp_serve(dev)
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)
    # the user-facing entry points (sjd_tpu_torch/examples): the demo server
    # in-process, the command lines as processes, then the two probes alone
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    try:
        phase_demo_server(dev)
        phase_cli(dev, CLI_DIR)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_latency_budget(dev)
    phase_hbm_bw_probe(dev)
    by_case = {"emu3": e_launches, "llamagen": l_launches, "llamagen_3b": l3_launches,
               "tp2_7b": tp_launches, "tp2_34b": tp34_launches}
    for k in kernels:
        if k.get("case") in by_case:
            k["launches"] = by_case[k["case"]][k["name"]]
            continue
        k["launches"] = {"quant_linear_a16": a16, "quant_linear_a8": a8}.get(
            k["name"], launches)[k["name"]]
    emit("done", seconds=time.time() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
