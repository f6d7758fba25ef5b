"""The readings that the limits of ``correct`` are set from, on the chip.

    python3 -m port_bench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--control-only]

For each seed, in one process, two windows of the cell as a benchmark run
makes them (the control's alone with ``--control-only``), each checked as
a run checks it:

- the program's (``program``): the lower readings;
- the control's (``control``): the same window served by the port's own
  W4A8 path (per-token int8 activations, the nearest precision below the
  configuration's bf16 activations), its tokens judged by the same
  reference; and, where the cell decodes images, the port's VQ decode in
  bf16 (the precision below its float32) over the program's tokens against
  the reference's pixels. These are the upper readings.

The weights are made once and shared by both sides. Each seed prints one
JSON line.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

import numpy as np
import torch

from . import families, weights
from .recorder import Recorder
from .reference import taming
from .reference.check import check_tokens
from .reference.decoder import strict_f32
from .reference.grammar import image_codes
from .run import Ctx, load_spec


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def side(spec, seed: int, seconds: float, device, params, act_quant: str) -> tuple:
    """One window served with ``act_quant`` activations, then its check:
    (numbers, the window's items)."""
    cfg, mix = spec["cfg"], spec["mix"]
    system = families.build(cfg, mix, device, act_quant=act_quant, params=params)
    ctx = Ctx(cfg=cfg, mix=mix, seed=seed, seconds=seconds, device=device, system=system,
              rec=Recorder(), tracer=None)
    window = importlib.import_module(f"{__package__}.entries.{mix['entry']}").run(ctx)
    ctx.system = system = None  # the decode state and its graphs go first
    _free(device)
    res = check_tokens(cfg, mix, device, window.items)
    res["in_flight"] = sum(bool(it.get("in_flight")) for it in window.items)
    res["requests"] = len(window.items)
    res["tokens_per_s"] = window.work.tokens / window.seconds
    return res, window.items


def vq_readings(cfg, mix, items, device) -> dict:
    """Mean and largest |difference| in uint8 levels against the reference's
    pixels: the program's images, and the port's decode in bf16."""
    fam = __import__(f"{__package__}.families.{cfg['serving']['family']}",
                     fromlist=["image_decoder"])
    decode_bf16 = fam.image_decoder(cfg, mix, device, dtype=torch.bfloat16)
    tree = weights.taming_decoder_tree(cfg["serving"]["vq"], weights.seed_of(cfg), device)
    res = {"program": [0.0, 0], "control": [0.0, 0]}
    for it in items:
        codes = torch.as_tensor(image_codes(cfg, mix, it["gen"]), device=device)
        with strict_f32(), torch.no_grad():
            ref = taming.to_uint8(taming.decode(tree, codes[None])[0]).astype(np.int16)
        for who, img in (("program", it["image"]),
                          ("control", decode_bf16(it["prompt"], it["gen"]))):
            d = np.abs(ref - np.asarray(img).astype(np.int16))
            res[who] = [max(res[who][0], float(d.mean())), max(res[who][1], int(d.max()))]
    return res


def one_seed(spec, seed: int, seconds: float, device, params=None,
             program: bool = True) -> dict:
    device = torch.device(device)
    cfg, mix = spec["cfg"], spec["mix"]
    if params is None:
        params = families.program_params(cfg, weights.seed_of(cfg), device)
    ctrl, items = side(spec, seed, seconds, device, params, "int8")
    out = {"seed": seed, "control": ctrl}
    if program:
        out["program"], items = side(spec, seed, seconds, device, params, "bf16")
    finished = [it for it in items if not it.get("in_flight")]
    if program and mix.get("decode_images") and finished:
        vq = vq_readings(cfg, mix, finished, device)
        out["program"].update(vq_mean_abs=vq["program"][0], vq_max_abs=vq["program"][1])
        ctrl.update(vq_mean_abs=vq["control"][0], vq_max_abs=vq["control"][1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = load_spec(args.workload)
    dev = torch.device("cuda")
    params = families.program_params(spec["cfg"], weights.seed_of(spec["cfg"]), dev)
    for seed in args.seeds:
        print(json.dumps(one_seed(spec, seed, args.seconds, dev, params,
                                  program=not args.control_only)), flush=True)
        _free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
