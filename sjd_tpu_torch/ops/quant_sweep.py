"""Sweep of the quantized-product kernel's tile and ring, on one GPU.

    python3 sjd_tpu_torch/ops/quant_sweep.py [--variants NAME ...] [--cases REGEX]
                                             [--against DIR]

``csrc/quant_linear.cu`` keeps its block shapes and rings as plain
constants (K1's ``kWgMaxStages``; K2's ``kWarpsNA8``, ``kWarpsKA8``,
``kStages``, ``kBlocksPerSM``; both kernels' ``kMaxSplits``), and three
that only a timing copy changes: ``kStageX`` false skips the activation
loads, ``kWgMma`` false K1's wgmmas, ``kWgWiden`` false K1's widening of the
weight bytes (``loads_only`` skips both: what is left is the ring, its
barriers and the loop).
For each variant in ``VARIANTS`` this copies the package into
``build/quant_sweep/<variant>/`` at the repository root, sets the constants
in the copy and builds every copy at once (one ``nvcc`` each, through each
tree's own ``ops/_build.py``). Then one process loads every library and
times them in turns (the variants in order, then in the reverse order; the
smaller of the two times is kept) at the 7B's, Emu3-Gen 8B's and
Lumina-mGPT-34B's weight shapes (``CASES``): each call on the next of
enough weight copies to overflow the L2, timed as ``chip_smoke.py`` times
its kernels. Each case
carries every variant's largest difference from the plain version and
whether it is within tolerance (A16 one bf16 rounding, A8 none), which the
timing variants are not. ``--cases`` keeps the cases whose name (as printed,
such as ``a16_int4_34b_wq_m32``) the expression matches.

``--against DIR``: DIR is the root of another checkout of the repository
(for example the parent commit, unpacked with ``git archive``). Its kernel
is timed in the same turns, and its outputs are compared bit for bit with
every variant's wherever both split the K range alike.

Prints one JSON line per variant, then one per case.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SWEEP_DIR = REPO / "build" / "quant_sweep"

# each variant: the constants it sets in a copy; the others keep the
# source's (K1: a ring of at most 8 chunks; K2: 4 warps of 16 weight rows,
# 2 along K, 4 stages, 2 blocks per SM; both at most 4 splits). The timing
# variants split K1's time a chunk: loads_only is the ring alone, no_wgmma
# adds the widening, no_widen the wgmmas.
VARIANTS = {
    "default": {},
    "default_nox": dict(kStageX="false"),
    "no_wgmma": dict(kWgMma="false"),
    "no_widen": dict(kWgWiden="false"),
    "loads_only": dict(kWgMma="false", kWgWiden="false"),
    "wg_stages4": dict(kWgMaxStages=4),
    "default_g8": dict(kMaxSplits=8),
    "a8_n128_w16_k1": dict(kWarpsNA8=8, kWarpsKA8=1),
}

# (kernel, bits, weight, rows): the 7B's and Emu3-Gen 8B's weights (N, K)
# at the solo generate window's rows (32), the serve path's (64), the
# benchmark cells' decode windows (96: Emu3, 3 slots; 160: Lumina, 5
# slots) and a refill's prefill (990); Lumina-mGPT-34B's (d 8192: wq and
# wo, wk and wv, w_gate and w_up, w_down, the head) at the solo window
SHAPES = {"wq": (4096, 4096), "w_gate": (11008, 4096), "w_down": (4096, 11008),
          "lm_head": (65536, 4096), "emu3_w_gate": (14336, 4096),
          "emu3_lm_head": (184622, 4096), "34b_wq": (8192, 8192), "34b_wk": (1024, 8192),
          "34b_w_gate": (22016, 8192), "34b_w_down": (8192, 22016),
          "34b_lm_head": (65536, 8192)}
CASES = ([("a16", 4, w, m) for m in (32, 64, 96, 160, 990) for w in ("wq", "w_gate", "w_down")]
         + [("a16", 8, "wq", 32)] + [("a16", 8, "lm_head", m) for m in (32, 96, 160)]
         + [("a16", 4, "emu3_w_gate", 96), ("a16", 8, "emu3_lm_head", 96)]
         + [("a8", 4, "wq", 32), ("a8", 4, "w_gate", 32), ("a8", 4, "w_down", 32),
            ("a8", 8, "lm_head", 32)]
         + [("a16", 4, w, 32) for w in ("34b_wq", "34b_wk", "34b_w_gate", "34b_w_down")]
         + [("a16", 8, "34b_lm_head", 32)])


def make_copy(name: str, constants: dict) -> Path:
    """The package copied into SWEEP_DIR/name with ``constants`` set in its
    quant_linear.cu; returns the copy's root."""
    root = SWEEP_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "sjd_tpu_torch", root / "sjd_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / "sjd_tpu_torch" / "csrc" / "quant_linear.cu"
    src = cu.read_text()
    for const, value in constants.items():
        src, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;", rf"\g<1>{value};", src)
        if n != 1:
            raise SystemExit(f"quant_sweep: {const} is not one plain constant of {cu}")
    cu.write_text(src)
    return root


# the ptxas lines a build reports: each kernel's name, registers and spills,
# and any warning (wgmma serialized)
_PTXAS_KEYS = ("Compiling entry", "registers", "spill", "wgmma", "arning")


def _build_child(root: str) -> None:
    """In a process of its own: build the kernel of the tree at ``root``
    with that tree's ``ops/_build.py``; prints its library and ptxas report."""
    sys.path[:] = [root] + [p for p in sys.path[1:] if p != root]
    from sjd_tpu_torch.ops import _build

    logs = _build.build_all(["quant_linear"])
    print(json.dumps({"lib": str(_build.library_path("quant_linear")),
                      "ptxas": [ln.strip() for log in logs.values() for ln in log.splitlines()
                                if any(k in ln for k in _PTXAS_KEYS)]}))


class Kernel:
    """One built library of csrc/quant_linear.cu, called through its C
    interface: the one with arrival counters, or the one before it (no
    counters; a second launch adds the split partials)."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        self.counted = hasattr(lib, "sjd_quant_linear_tile")
        lib.sjd_quant_linear.restype = ctypes.c_int
        lib.sjd_quant_linear.argtypes = ([ctypes.c_void_p] * (7 if self.counted else 6)
                                         + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.sjd_quant_linear_splits.restype = ctypes.c_int
        lib.sjd_quant_linear_splits.argtypes = [ctypes.c_int] * (4 if self.counted else 3)
        if self.counted:
            lib.sjd_quant_linear_tile.argtypes = [ctypes.c_int] * 2
        if hasattr(lib, "sjd_quant_linear_scratch"):
            lib.sjd_quant_linear_scratch.restype = ctypes.c_longlong
            lib.sjd_quant_linear_scratch.argtypes = [ctypes.c_int] * 5
        self.lib = lib

    def splits(self, N: int, K: int, bits: int, a8: bool) -> int:
        extra = (int(a8),) if self.counted else ()
        return self.lib.sjd_quant_linear_splits(N, K, bits, *extra)

    def rows(self, a8: bool) -> int:
        """The block's weight rows."""
        return self.lib.sjd_quant_linear_tile(0, int(a8)) if self.counted else 64

    def bind(self, x, xs, q, s, bits: int, a8: bool):
        """(call, y, splits): a call without arguments that runs the kernel
        once into buffers of its own, its output, its split count."""
        import torch

        M, K = x.shape
        N = q.shape[0]
        g = self.splits(N, K, bits, a8)
        y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        numel = (self.lib.sjd_quant_linear_scratch(M, N, K, bits, int(a8))
                 if hasattr(self.lib, "sjd_quant_linear_scratch") else g * M * N)
        part = torch.empty(max(numel, 1), dtype=torch.int32 if a8 else torch.float32,
                           device=x.device)
        count = torch.zeros(-(-N // self.rows(a8)) * -(-M // 32), dtype=torch.int32,
                            device=x.device)
        ptrs = [x.data_ptr(), xs.data_ptr() if a8 else 0, q.data_ptr(), s.data_ptr(),
                y.data_ptr(), part.data_ptr() if g > 1 else 0]
        if self.counted:
            ptrs.append(count.data_ptr() if g > 1 else 0)

        def call():
            stream = torch.cuda.current_stream().cuda_stream
            rc = self.lib.sjd_quant_linear(*ptrs, M, N, K, bits, int(a8), stream)
            if rc:
                raise RuntimeError(f"quant_linear launch failed: CUDA error {rc}")

        call.buffers = (y, part, count)  # alive as long as the call
        return call, y, g


def _result(proc) -> dict:
    """The child's JSON line, or its error (a variant that does not build is
    reported, and the sweep goes on)."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        return {"error": err[-2000:]}
    return json.loads(out.strip().splitlines()[-1])


def case_name(case: tuple) -> str:
    kind, bits, weight, M = case
    return f"{kind}_int{bits}_{weight}_m{M}"


def sweep(trees: dict, cases: list = CASES) -> None:
    """Build every tree at once, then time every library in turns over
    ``cases``."""
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke
    from sjd_tpu_torch.models.transformer import _quantize_act, quantize_int4, quantize_int8
    from sjd_tpu_torch.ops import quant_linear as ql

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    procs = {name: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--build", str(root)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, root in trees.items()}
    builds = {name: _result(proc) for name, proc in procs.items()}
    kernels = {name: Kernel(b["lib"]) for name, b in builds.items() if "lib" in b}
    for name, b in builds.items():
        print(json.dumps({"variant": name, "device": smi,
                          "constants": VARIANTS.get(name, {"tree": str(trees[name])}),
                          "tile_rows": [kernels[name].rows(a8) for a8 in (False, True)]
                          if name in kernels else None,
                          **b}), flush=True)
    dev = torch.device("cuda")
    for i, (kind, bits, weight, M) in enumerate(CASES):
        if (kind, bits, weight, M) not in cases:
            continue
        N, K = SHAPES[weight]
        a8 = kind == "a8"
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((N, K), generator=g, device=dev) / math.sqrt(K)).to(torch.bfloat16)
        leaf = quantize_int4(w) if bits == 4 else quantize_int8(w)
        q, s = leaf["q4p" if bits == 4 else "q"], leaf["s"]
        del w
        xq, xs = _quantize_act(x)
        if a8:
            want = ql.quant_linear_a8_plain(xq, xs, q, s, bits=bits)
        else:
            want = ql.quant_linear_a16_plain(x, q, s, bits=bits)
        tol = 0.0 if a8 else 2 ** -7 * want.float().abs().max().item() + 1e-3
        # as chip_smoke._copies: enough weight copies that twelve
        # consecutive calls read over twice the L2; every library cycles
        # over the same ones
        n_copies = min(12, math.ceil(2 * chip_smoke.L2_BYTES / q.numel()))
        copies = [q] + [q.clone() for _ in range(n_copies - 1)]
        rows, ys, calls = {}, {}, {}
        for name, kern in kernels.items():
            binds = [kern.bind(xq if a8 else x, xs, c, s, bits, a8) for c in copies]
            binds[0][0]()
            torch.cuda.synchronize()
            ys[name] = binds[0][1].clone()
            err = (ys[name].float() - want.float()).abs().max().item()
            cycle = itertools.cycle([b[0] for b in binds])
            calls[name] = lambda cycle=cycle: next(cycle)()
            rows[name] = dict(splits=binds[0][2], max_abs_err=err, ok=err <= tol, ms=[])
        order = list(kernels)
        for turn in (order, order[::-1]):
            for name in turn:
                rows[name]["ms"].append(chip_smoke.time_ms(calls[name], reps=12, trials=7))
        for name, r in rows.items():
            r["ms"] = min(r["ms"])
            if "against" in ys and r["splits"] == rows["against"]["splits"]:
                r["equal_to_against"] = bool(torch.equal(ys[name], ys["against"]))
        print(json.dumps({"case": case_name((kind, bits, weight, M)), "M": M, "N": N, "K": K,
                          "tolerance": tol, "variants": rows}), flush=True)
        del copies, calls, ys, q, x, xq
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--against", default=None, help="root of another checkout to time and "
                    "compare with")
    ap.add_argument("--cases", default=None, help="a regular expression: only the cases whose "
                    "name (such as a16_int4_34b_wq_m32) it matches")
    ap.add_argument("--build", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        _build_child(args.build)
        return 0
    trees = {name: make_copy(name, VARIANTS[name]) for name in args.variants}
    if args.against:
        trees["against"] = Path(args.against).resolve()
    cases = [c for c in CASES if args.cases is None or re.search(args.cases, case_name(c))]
    if not cases:
        raise SystemExit(f"quant_sweep: no case matches {args.cases!r}")
    sweep(trees, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
