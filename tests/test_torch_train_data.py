"""The port's fine-tuning data path, checkpoints, process setup and command
line against sjd_tpu's: LengthClusteredSampler's indices, FinetuneDataset
and pad_batch, pre-tokenized files byte for byte, checkpoint save / prune /
restore, the rendezvous resolution, and python -m
sjd_tpu_torch.parallel.finetune resumed against an uninterrupted run."""

import json
import pickle
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from sjd_tpu.data import dataset as jds
from sjd_tpu.data import pre_tokenize as jpre
from sjd_tpu.data import sampler as jsampler
from sjd_tpu.data import vocab_translation as jvocab
from sjd_tpu.parallel import dist as jdist
from sjd_tpu_torch.data import dataset as pds
from sjd_tpu_torch.data import pre_tokenize as ppre
from sjd_tpu_torch.data import sampler as psampler
from sjd_tpu_torch.data import vocab_translation as pvocab
from sjd_tpu_torch.parallel import dist as pdist
from sjd_tpu_torch.parallel import finetune
from sjd_tpu_torch.utils import checkpoints as ckpt

ROOT = Path(__file__).resolve().parents[1]


def _lengths(n=37, seed=0):
    return list(np.random.RandomState(seed).randint(5, 400, n))


@pytest.mark.parametrize("kw", [
    dict(batch_size=2),
    dict(batch_size=2, num_replicas=2, grad_accum=2, bucket_size=8),
    dict(batch_size=1, grad_accum=2, groups=["a"] * 20 + ["b"] * 17,
         group_ratios={"a": 0.5, "b": 1.5}, bucket_size=5),
], ids=["plain", "ranks_accum", "ratios"])
def test_sampler_yields_jax_indices(kw):
    """Every epoch 0-2, every rank, from the start and from a mid-epoch
    start_iter: the same index lists and lengths as sjd_tpu's sampler."""
    for rank in range(kw.get("num_replicas", 1)):
        args = dict(kw, rank=rank, seed=3)
        want = jsampler.LengthClusteredSampler(_lengths(), **args)
        got = psampler.LengthClusteredSampler(_lengths(), **args)
        for epoch in range(3):
            for start_iter in (0, 2):
                want.set_epoch(epoch, start_iter)
                got.set_epoch(epoch, start_iter)
                w = list(want)
                assert w and list(got) == w and len(got) == len(want)


def _records(tmp: Path, encode):
    """Two record files: one pickled by sjd_tpu's pre_tokenize, one inline
    (one record without "len"), and a meta listing both with ratios."""
    rs = np.random.RandomState(0)
    items = [{"caption": f"caption {i}", "grid": rs.randint(0, 8192, (4, 4))} for i in range(3)]
    rec = jpre.run_pretokenize(items, str(tmp / "pre"), encode_text=encode, pixels=64)
    inline = [{"input_ids": list(range(i, i + 5 + i)), "labels": [-100] * 2 + list(range(3 + i))}
              for i in range(3)] + [{"input_ids": [7, 8, 9]}]
    with open(tmp / "inline.json", "w") as f:
        json.dump(inline, f)
    meta = tmp / "meta.json"
    with open(meta, "w") as f:
        json.dump([{"path": rec, "type": "t2i", "ratio": 2.0},
                   {"path": str(tmp / "inline.json"), "type": "text"}], f)
    return str(meta)


def _encode(text):
    return [100 + (ord(c) * 7) % 300 for c in text[:9]]


def test_dataset_and_pad_batch_equal_jax(tmp_path):
    meta = _records(tmp_path, _encode)
    want, got = jds.FinetuneDataset(meta), pds.FinetuneDataset(meta)
    assert len(got) == len(want) == 7
    assert (got.types, got.ratios) == (want.types, want.ratios)
    assert got.lengths() == want.lengths()
    items = [got[i] for i in range(len(got))]
    assert items == [want[i] for i in range(len(want))]
    for max_len in (None, 12):
        for a, b in zip(pds.pad_batch(items, max_len=max_len),
                        jds.pad_batch(items, max_len=max_len)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mapped", [False, True])
def test_pretokenize_files_byte_equal(tmp_path, mapped):
    """run_pretokenize (2 splits, both ranks) and concat_records write the
    same bytes as sjd_tpu's into the same directory."""
    rs = np.random.RandomState(1)
    items = [{"caption": f"a red fox {i}", "grid": rs.randint(0, 8192, (4, 4))}
             for i in range(5)]
    perm = np.random.default_rng(3).permutation(8192)
    vocab = {jvocab.image_token_name(i): int(4 + p) for i, p in enumerate(perm)}
    out = tmp_path / "out"

    def run(pkg, vt):
        shutil.rmtree(out, ignore_errors=True)
        mapping = vt.mapping_from_vocab(vocab) if mapped else None
        for rank in range(2):
            pkg.run_pretokenize(items, str(out), encode_text=_encode, pixels=64, sep_id=8710,
                                splits=2, rank=rank, mapping=mapping)
        pkg.concat_records(str(out), 2)
        return {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*"))
                if p.is_file()}

    want = run(jpre, jvocab)
    got = run(ppre, pvocab)
    assert sorted(got) == sorted(want) and len(got) == 5 + 3
    assert got == want
    first = pickle.loads(got["files/0-0.pkl"])
    assert first["len"] == len(first["input_ids"]) == len(_encode("x" * 9)) + 3 + 4 * 5 + 1 + 1


def test_checkpoints_save_prune_restore(tmp_path):
    from sjd_tpu_torch.models.transformer import DecoderConfig
    from sjd_tpu_torch.parallel import TrainConfig, make_mesh, make_train_step

    cfg = DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                        num_heads=4, num_kv_heads=4, head_dim=8, qk_norm=True,
                        dtype=torch.float32, max_position_embeddings=64)
    init_fn, step_fn = make_train_step(make_mesh(device="cpu"), cfg, TrainConfig(
        learning_rate=1e-2, warmup_steps=1, total_steps=10, grad_accum=2), device="cpu")
    mgr = ckpt.make_manager(str(tmp_path / "ck"), max_keep=2)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(mgr, init_fn(0))
    rs = np.random.RandomState(0)
    batch = [torch.from_numpy(x) for x in (rs.randint(0, 64, (2, 10)),) * 2] + [
        torch.ones(2, 10, dtype=torch.bool)]
    state = init_fn(0)
    for step in range(1, 4):  # 3 calls: the last one mid-accumulation
        state, _ = step_fn(state, *batch)
        ckpt.save(mgr, step, state)
    assert mgr.all_steps() == [2, 3] and not list(Path(mgr.directory).glob(".tmp-*"))
    fresh = ckpt.restore(mgr, init_fn(1))
    assert fresh.step == 3 and fresh.opt_state.mini_step == 1
    for a, b in zip(state.state_dict()["params"].values(), fresh.state_dict()["params"].values()):
        assert torch.equal(a, b)
    for _ in range(2):  # both continue identically
        state, m1 = step_fn(state, *batch)
        fresh, m2 = step_fn(fresh, *batch)
        assert float(m1["loss"]) == float(m2["loss"])
    sd1, sd2 = state.state_dict(), fresh.state_dict()
    flat = lambda sd: [t for v in sd["opt_state"]["moments"].values() for t in v.values()]
    for a, b in zip(list(sd1["params"].values()) + flat(sd1),
                    list(sd2["params"].values()) + flat(sd2)):
        assert torch.equal(a, b)
    assert ckpt.restore(mgr, init_fn(2), step=2).step == 2


@pytest.mark.parametrize("nodes", ["nid[001-004,007]", "gpu-a[12,15]", "host1,host2", "solo"])
def test_first_slurm_node_equals_jax(nodes):
    assert pdist._first_slurm_node(nodes) == jdist._first_slurm_node(nodes)


@pytest.mark.parametrize("env,args", [
    ({}, {}),
    ({"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "2950", "WORLD_SIZE": "4", "RANK": "3"}, {}),
    ({"MASTER_ADDR": "10.0.0.2", "WORLD_SIZE": "2"}, {}),
    ({"SLURM_JOB_NODELIST": "nid[001-004]", "SLURM_NTASKS": "4", "SLURM_PROCID": "2"}, {}),
    ({"MASTER_ADDR": "10.0.0.2", "WORLD_SIZE": "4", "RANK": "1"},
     dict(coordinator_address="c:1", num_processes=2, process_id=1)),
], ids=["none", "torchrun", "torchrun_defaults", "slurm", "explicit"])
def test_init_distributed_resolves_as_jax(monkeypatch, env, args):
    """The rendezvous each package starts, with jax.distributed.initialize
    and torch.distributed.init_process_group recorded instead of run."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "SLURM_JOB_NODELIST",
              "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.update(jax=kw))
    monkeypatch.setattr(pdist.dist, "init_process_group", lambda backend, init_method,
                        world_size, rank: seen.update(torch=dict(
                            backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank)))
    jout = jdist.init_distributed(**args)
    pout = pdist.init_distributed(**args, device="cpu")
    if "jax" not in seen:
        assert "torch" not in seen
        assert pout == {"process_index": 0, "process_count": 1, "local_devices": 1,
                        "global_devices": 1}
        assert jout["process_index"] == 0 and jout["process_count"] == 1
        return
    j = seen["jax"]
    assert seen["torch"] == dict(backend="gloo", init_method=f"tcp://{j['coordinator_address']}",
                                 world_size=j["num_processes"], rank=j["process_id"])


def _cli(*args, cwd=ROOT):
    out = subprocess.run([sys.executable, "-m", "sjd_tpu_torch.parallel.finetune",
                          "--device", "cpu", *args], cwd=cwd, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _inline_meta(tmp: Path) -> str:
    rs = np.random.RandomState(5)
    recs = []
    for _ in range(16):
        n = int(rs.randint(10, 30))
        ids = [int(x) for x in rs.randint(0, 512, n)]
        recs.append({"input_ids": ids, "labels": [-100] * 4 + ids[4:]})
    with open(tmp / "recs.json", "w") as f:
        json.dump(recs, f)
    with open(tmp / "meta.json", "w") as f:
        json.dump([{"path": str(tmp / "recs.json")}], f)
    return str(tmp / "meta.json")


def _final_state(ckpt_dir: Path):
    from sjd_tpu_torch.parallel import TrainConfig, make_mesh, make_train_step

    init_fn, _ = make_train_step(make_mesh(device="cpu"), finetune.model_config("tiny", 32),
                                 TrainConfig(warmup_steps=2, total_steps=6), device="cpu")
    return ckpt.restore(ckpt.make_manager(str(ckpt_dir)), init_fn(9))


def test_finetune_cli_resume_equals_uninterrupted(tmp_path):
    """python -m sjd_tpu_torch.parallel.finetune --device cpu on records:
    6 steps with a checkpoint at 3; then the checkpoint at 3 resumed to 6
    in a new process. The two final states are bit-equal."""
    meta = _inline_meta(tmp_path)
    common = ["--meta-path", meta, "--model", "tiny", "--batch-size", "2", "--max-seq-len", "32",
              "--steps", "6", "--save-interval", "3", "--warmup", "2", "--log-every", "1"]
    out = _cli(*common, "--ckpt-dir", str(tmp_path / "a"))
    assert '"final_loss"' in out and "saved checkpoint @ 3" in out
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "6")
    out = _cli(*common, "--ckpt-dir", str(tmp_path / "b"), "--resume")
    assert "resumed at step 3" in out and "step 2 " not in out and "step 3 " in out
    a, b = _final_state(tmp_path / "a"), _final_state(tmp_path / "b")
    assert a.step == b.step == 6
    sa, sb = a.state_dict(), b.state_dict()
    for name, t in sa["params"].items():
        assert torch.equal(t, sb["params"][name]), name
        for k, m in sa["opt_state"]["moments"][name].items():
            assert torch.equal(m, sb["opt_state"]["moments"][name][k]), (name, k)


def test_resume_skip_under_accumulation_is_the_jax_clis(tmp_path):
    """With grad_accum > 1 the command line's resume skips start_step
    sampler iterations of batch_size * grad_accum items (sampler.py), where
    the run consumed start_step micro-batches of batch_size: the resumed
    stream starts grad_accum times too far (the JAX command line's skip,
    kept; ROADMAP Queue 3 has the fix)."""
    meta = _inline_meta(tmp_path)
    args = SimpleNamespace(synthetic=False, meta_path=meta, batch_size=1, grad_accum=2,
                           seed=0, max_seq_len=32)
    ds = pds.FinetuneDataset(meta)
    stream = finetune.batches(args, 512, 0)
    fresh = [next(stream)[0] for _ in range(8)]
    resumed = next(finetune.batches(args, 512, 2))[0]
    assert np.array_equal(resumed, fresh[2 * 2]) and not np.array_equal(resumed, fresh[2])
    # the JAX command line's arithmetic on sjd_tpu's sampler gives that item
    sampler = jsampler.LengthClusteredSampler(ds.lengths(), batch_size=1, grad_accum=2, seed=0)
    steps_per_epoch = max(len(sampler) // 1, 1)
    sampler.set_epoch(2 // steps_per_epoch, 2 % steps_per_epoch)
    first = next(iter(sampler))
    assert np.array_equal(resumed, jds.pad_batch([ds[first]], max_len=32)[0])
