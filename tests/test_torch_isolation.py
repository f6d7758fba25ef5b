"""sjd_tpu_torch imports neither JAX (nor optax or orbax) nor any module of
sjd_tpu, and none of safetensors, transformers, tokenizers, sentencepiece, PIL, tiktoken, pandas
and torchvision when its modules are imported (the Emu3, Anole, LlamaGen,
T5, evaluation, training, tensor-parallel decoding and VQ training modules, the
command lines included): the machine with the
GPU has none of them, so such an import would break the port there."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import sjd_tpu_torch

_PROBE = r"""
import importlib, json, pkgutil, sys
# any import of these now raises ImportError
for blocked in ("jax", "jaxlib", "optax", "orbax", "safetensors", "transformers", "tokenizers",
                "sentencepiece", "PIL", "tiktoken", "pandas", "torchvision"):
    sys.modules[blocked] = None
import sjd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sjd_tpu_torch.__path__, "sjd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "sjd_tpu" or m.startswith("sjd_tpu."))
print(json.dumps({"n_modules": len(names), "names": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_sjd_tpu():
    root = Path(sjd_tpu_torch.__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    expected = len(list(pkgutil.walk_packages(sjd_tpu_torch.__path__, "sjd_tpu_torch.")))
    assert seen["n_modules"] == expected >= 69
    for name in ("models.emu3", "models.anole", "models.vq.emu3_vq", "models.vq.emu3_port",
                 "data.emu3_processor", "utils.emu3_tokenizer", "models.llamagen",
                 "models.t5", "core.decomposer", "eval.datasets", "eval.metrics",
                 "eval.inception", "eval.clip", "eval.harness", "eval.latency",
                 "eval.eval_model", "eval.recon_eval", "utils.image_io", "parallel.mesh",
                 "parallel.sharding", "parallel.dist", "parallel.training", "parallel.finetune",
                 "data.dataset", "data.sampler", "data.pre_tokenize", "utils.checkpoints",
                 "parallel.multihost_dryrun", "parallel.tp_decode", "models.vq.train",
                 "models.vq.lpips", "models.vq.discriminator",
                 "models.vq.discriminator_stylegan", "models.vq.vq_train"):
        assert f"sjd_tpu_torch.{name}" in seen["names"], name
    assert seen["leaked"] == [], f"sjd_tpu modules imported: {seen['leaked']}"
