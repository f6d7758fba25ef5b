"""The port's demo server (sjd_tpu_torch/examples/demo_server.py) and its
start-up accounting (sjd_tpu_torch/utils/compile_watch.py), on the CPU:

  * ``ModelWorker``'s routes, as tests/test_data_eval.py:140-163 holds the
    JAX worker's;
  * HTTP round trips on 127.0.0.1 with a tiny Lumina model (the FlexAR
    layout, a tokenizer with the IMGIMG names): serial mode, where the
    /generate PNG equals ``sample_fn(prompt, seed)`` bit for bit, an upload
    of a size no crop has (fitted without PIL), /freeform, a JPEG with PIL
    blocked (500 naming PIL), the page and /health's keys; slots mode,
    where 3 concurrent requests each equal their solo run (the same
    left-padded prompt and per-request generator on the same engine), i2i
    is refused with 500, and an expired wait is a 503;
  * ``compile_watch``: snapshot and delta arithmetic, the build's counters
    (a stand-in compiler writes the library), a library hit, and no
    capture on CPU engines (their steps run eagerly).

The server builds its model once per module; the whole file runs in about
36 s here alone, on one torch thread."""

import base64
import dataclasses
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ckpt_synth import ChameleonFakeTokenizer
from sjd_tpu_torch.core.serving import seed_generators
from sjd_tpu_torch.data.image_processing import generate_crop_size_list
from sjd_tpu_torch.examples import demo_server
from sjd_tpu_torch.loader import load_lumina_mgpt
from sjd_tpu_torch.models.chameleon import IMAGE_END_ID
from sjd_tpu_torch.models.transformer import DecoderConfig
from sjd_tpu_torch.models.vq import VQConfig
from sjd_tpu_torch.ops import _build
from sjd_tpu_torch.utils import compile_watch
from sjd_tpu_torch.utils.image_io import decode_png, encode_png
from test_torch_examples import one_torch_thread  # noqa: F401 - an autouse fixture

TINY = DecoderConfig(vocab_size=65536, hidden_size=16, intermediate_size=32, num_layers=2,
                     num_heads=2, num_kv_heads=2, head_dim=8, qk_norm=True,
                     dtype=torch.float32, max_position_embeddings=512)
TINY_VQ = VQConfig(ch=32, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, z_channels=32,
                   embed_dim=16, n_embed=8192)
TARGET = 64
WAIT_S = 120


def tiny_lumina():
    """A 64px Lumina model that stops at <image_end> (random weights would
    write text up to max_len after it) and whose item processor fits
    uploads to crops of at most 4 patches of 32 px (the loader's 1024
    would make a ~4000-token image prompt)."""
    model = load_lumina_mgpt(target_size=TARGET, model_cfg=TINY, vq_cfg=TINY_VQ,
                             tokenizer=ChameleonFakeTokenizer(), device="cpu")
    eng = model.engine
    eng.config = dataclasses.replace(eng.config, eos_id=IMAGE_END_ID)
    model.extras["item_processor"].crop_size_list = generate_crop_size_list(4, 32)
    return model


@pytest.fixture(scope="module")
def model():
    return tiny_lumina()


class Running:
    """A built server on a free port, serving from a thread."""

    def __init__(self, model, *flags):
        self.args = demo_server.parse_args(["--model", "lumina_mgpt", "--port", "0",
                                            "--device", "cpu", *flags])
        self.server = demo_server.build_server(model, self.args)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=WAIT_S)
        assert not self.thread.is_alive()

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=WAIT_S) as r:
            return r.status, r.headers["Content-Type"], r.read()

    def post(self, path, body):
        req = urllib.request.Request(self.url + path, data=json.dumps(body).encode(),
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()


@pytest.fixture(scope="module")
def serial(model):
    s = Running(model)
    yield s
    s.close()


def test_model_worker_routes():
    calls = []

    def dispatch(kind, req):
        calls.append((kind, tuple(sorted(req))))
        return f"img:{kind}"

    w = demo_server.ModelWorker(dispatch)
    w.start()
    w.ready.wait()
    assert w.generate("t2i", {"prompt": "x"})[:2] == ("ok", "img:t2i")
    assert w.generate("i2i", {"prompt": "x", "images": []})[1] == "img:i2i"
    assert w.generate("freeform", {"qas": []})[1] == "img:freeform"
    assert [k for k, _ in calls] == ["t2i", "i2i", "freeform"]

    def failing(kind, req):
        raise TimeoutError("wedged") if kind == "t2i" else ValueError("bad")

    w = demo_server.ModelWorker(failing, serialize=False)
    w.start()
    w.ready.wait()
    assert w.generate("t2i", {})[:2] == ("timeout", "wedged")
    assert w.generate("i2i", {})[:2] == ("error", "bad")


def test_serial_round_trip_equals_sample_fn(serial, model):
    status, body = serial.post("/generate", {"prompt": "a red fox", "seed": 7})
    assert status == 200
    got = decode_png(body)
    assert got.shape == (TARGET, TARGET, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, model.sample_fn("a red fox", 7))


def test_serial_image_routes(serial, monkeypatch):
    upload = (np.random.RandomState(0).rand(40, 50, 3) * 255).astype(np.uint8)
    b64 = base64.b64encode(encode_png(upload)).decode()
    status, body = serial.post("/generate_i2i", {"prompt": "redraw <|image|>",
                                                 "images": [b64], "seed": 1})
    assert status == 200 and decode_png(body).shape == (TARGET, TARGET, 3)
    status, body = serial.post("/freeform", {"qas": [["draw a cat", "a cat"],
                                                     ["now a dog", None]], "seed": 2})
    assert status == 200 and decode_png(body).shape == (TARGET, TARGET, 3)
    buf = io.BytesIO()
    Image.fromarray(upload).save(buf, format="JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    status, body = serial.post("/generate_i2i", {"prompt": "redraw <|image|>", "seed": 1,
                                                 "images": [base64.b64encode(
                                                     buf.getvalue()).decode()]})
    assert status == 500 and "PIL" in json.loads(body)["error"]
    status, ctype, page = serial.get("/")
    assert status == 200 and ctype.startswith("text/html") and b"/generate_i2i" in page
    status, _, health = serial.get("/health")
    h = json.loads(health)
    assert {"status", "model", "slots", "smoke", "served", "last_latency_s"} <= set(h)
    assert h["status"] == "ok" and h["model"] == "lumina_mgpt" and h["slots"] == 1
    assert h["smoke"] is True


def test_slots_mode_equals_solo_runs(model):
    s = Running(model, "--slots", "2", "--chunk-steps", "8", "--prompt-bucket", "8")
    prompts = {101: "a lighthouse", 102: "three apples", 103: "a boat at dusk"}
    out = {}

    def client(seed):
        out[seed] = s.post("/generate", {"prompt": prompts[seed], "seed": seed})

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        status, body = s.post("/generate_i2i", {"prompt": "x <|image|>", "images": []})
        assert status == 500 and "--slots > 1" in json.loads(body)["error"]
        h = json.loads(s.get("/health")[2])
        assert h["served"] == 3 and h["slots"] == 2
        # the batcher's counters: the warm-up and the 3 requests
        assert h["completed"] == 4 and h["submitted"] == 4
        s.args.wait_timeout = 1e-4  # the handlers read it per request
        status, body = s.post("/generate", {"prompt": "late", "seed": 9})
        assert status == 503 and "not finished" in json.loads(body)["error"]
    finally:
        s.close()
    eng, width = model.engine, s.server.streamer.P
    for seed, prompt in prompts.items():
        status, body = out[seed]
        assert status == 200
        ids = model.extras["prompt_ids_fn"](prompt)
        pad = width - len(ids)
        alone = eng.generate(model.params, seed_generators([seed], "cpu"),
                             torch.tensor([[0] * pad + ids]),
                             prompt_mask=torch.tensor([[False] * pad + [True] * len(ids)]))
        want = model.extras["decode_image_fn"](alone.tokens[0, :int(alone.length[0])].tolist())
        np.testing.assert_array_equal(decode_png(body), want)


def test_compile_watch_snapshot_and_delta():
    since = compile_watch.snapshot()
    assert set(since) == {"build_s", "builds", "library_hits", "captures", "capture_s",
                          "warmup_steps"}
    compile_watch.add(builds=2, build_s=1.25, captures=1)
    d = compile_watch.delta(since)
    assert (d["builds"], d["build_s"], d["captures"], d["library_hits"]) == (2, 1.25, 1, 0)
    assert compile_watch.delta(compile_watch.snapshot())["builds"] == 0


def test_compile_watch_counts_builds_and_hits(tmp_path, monkeypatch):
    """A stand-in compiler that writes the library: the first build_all
    counts one build and its seconds, load() of the library then counts a
    hit; the CPU engine captures nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc_cmd", lambda name, out: [
        sys.executable, "-c", f"open({str(out)!r}, 'w').close()"])
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    since = compile_watch.snapshot()
    _build.build_all(["fused_epilogue"])
    _build.build_all(["fused_epilogue"])  # built already: no compile
    d = compile_watch.delta(since)
    assert d["builds"] == 1 and d["build_s"] > 0 and d["library_hits"] == 0
    assert _build.load("fused_epilogue") == str(_build.library_path("fused_epilogue"))
    assert compile_watch.delta(since)["library_hits"] == 1


def test_cpu_engines_capture_nothing(model):
    since = compile_watch.snapshot()
    model.sample_fn("a cat", 3)
    d = compile_watch.delta(since)
    assert (d["captures"], d["capture_s"], d["warmup_steps"]) == (0, 0.0, 0)
    assert model.engine.stats.eager_steps > 0 and model.engine.stats.captures == 0
