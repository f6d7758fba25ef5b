"""The benchmark is driven by its files: a cell, a mix and a metric added
as new files in a copy are found by name; and no module of it loads JAX or
the JAX package, nor does the reference load the port."""

import ast
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports (whole names)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "sjd_tpu"}


def test_whole_names_compared():
    from port_bench.run import FORBIDDEN

    # the port's name begins with the JAX package's: a prefix test is wrong
    assert "sjd_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    """The reference and the benchmark modules it loads (the weights, the
    traffic's grid) name no module of the port."""
    ref = sorted((HERE / "reference").glob("*.py")) + [HERE / "weights.py",
                                                       HERE / "traffic" / "generator.py"]
    for path in ref:
        assert "sjd_tpu_torch" not in _imports(path), path
        rel = {n.module for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.ImportFrom) and n.level}
        assert rel <= {None, "decoder", "quant", "grammar", "check", "taming", "sampling",
                       "traffic.generator"}, rel


def test_added_files_are_found(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a cell and a per-layer metric added as
    files and entries of a copy: the copy's harness finds each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "lumina-mgpt-7b-w4a16.json").read_text())
    cfg["name"] = "lumina-mgpt-7b-w4a16-copy"
    (root / HERE.name / "configs" / "lumina-mgpt-7b-w4a16-copy.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "mixes" / "batch5-768.json").read_text())
    mix["image_px"] = 256
    (root / HERE.name / "traffic" / "mixes" / "batch5-256.json").write_text(json.dumps(mix))
    (root / HERE.name / "workloads" / "lumina7b-copy.batch5-256.json").write_text(
        json.dumps({"limits": {"logit_gap": 0.5}}))
    (root / HERE.name / "metrics" / "refill_rows.py").write_text(
        "def read(run):\n    return 7.0\n")
    bench["configs"].append({"name": "lumina-mgpt-7b-w4a16-copy", "source": "x",
                             "file": "port_bench/configs/lumina-mgpt-7b-w4a16-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "lumina7b-copy.batch5-256",
                               "config": "lumina-mgpt-7b-w4a16-copy",
                               "traffic": "batch5-256", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "refill_rows", "unit": "rows", "better": "lower",
                               "source": "program_counter", "layer": "serving",
                               "moves": "gen_tokens_per_s",
                               "workloads": ["lumina7b-copy.batch5-256"]})
    bench["end_to_end"][0]["workloads"].append("lumina7b-copy.batch5-256")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from port_bench import run

    spec = run.load_spec("lumina7b-copy.batch5-256", root=root)
    assert spec["mix"]["image_px"] == 256
    assert spec["cfg"]["name"] == "lumina-mgpt-7b-w4a16-copy"
    assert spec["cellfile"]["limits"] == {"logit_gap": 0.5}
    names = [m["name"] for m in spec["per_layer"]]
    assert names == ["refill_rows"]
    assert "gen_tokens_per_s" in [m["name"] for m in spec["end_to_end"]]
    assert run.reader("refill_rows", root)(None) == 7.0
    # and the cells already there are unchanged
    assert run.load_spec("lumina7b-w4a16.batch5-768", root=root)["mix"]["image_px"] == 768


def test_benchmark_json_names_only_known_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert (HERE / "workloads" / f"{w['name']}.json").exists()
        assert (HERE / "traffic" / "mixes" / f"{w['traffic']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    assert sys.modules.get("jax") is None
