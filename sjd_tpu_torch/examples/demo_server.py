"""Image-generation demo service (examples/demo_server.py): a model worker
behind a minimal HTTP API and a one-page browser UI.

  POST /generate {"prompt": "...", "seed": 42}  -> PNG bytes
                 (seed-reproducible in --slots mode too: each request's
                  slot carries its own generator seeded from "seed",
                  core/serving.StreamingBatcher)
  POST /generate_i2i {"prompt": "edit <|image|> ...",
                      "images": [<base64 PNG>...], "seed": 42} -> PNG bytes
                     (Lumina only)
  POST /freeform {"qas": [["describe <|image|>", "a cat"],
                          ["now redraw it", null]],
                  "images": [<base64 PNG>...], "seed": 42} -> PNG bytes
                 (Lumina only)
  GET  /health                                   -> {"status": "ok", ...}
  GET  /                                         -> the page

    python -m sjd_tpu_torch.examples.demo_server --port 7860 \\
        [--model lumina_mgpt --ckpt-dir ... --vq-ckpt ...] [--slots 4] [--device cuda]

Threads: one thread owns the engine. With ``--slots 1`` that is the
worker, which runs every request in turn (the generation and the VQ
decode). With ``--slots > 1`` it is the ``StreamingBatcher``'s drive
thread: ``/generate`` handlers only submit host data and wait, then
VQ-decode their own tokens. The server runs one request through its path
before it listens (the kernel libraries' load or build, the warm-up step
and the CUDA-graph capture), so no capture ever runs beside a handler's
device work, which would break it. It then prints one JSON line (the load
and warm-up seconds and ``utils.compile_watch``'s counters), then
``serving <model> on :<port>``.

Responses are PNGs from ``utils.image_io.encode_png``. Uploads are PNGs,
read by ``decode_png`` without PIL; another format (a JPEG) needs PIL, and
without it the request fails with HTTP 500 naming PIL. An upload of any
size is fitted to the nearest crop size as PIL would fit it.
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..loader import load_pretrained_model
from ..utils import compile_watch
from ..utils.image_io import encode_png, image_from_bytes

WARMUP_REQUEST = {"prompt": "0", "seed": 0}  # a class id for LlamaGen, text elsewhere


class ModelWorker(threading.Thread):
    """The worker: requests are run in turn from a queue (the reference's
    request/response queue pair, in-process)."""

    def __init__(self, dispatch, serialize: bool = True):
        super().__init__(daemon=True)
        self.dispatch = dispatch  # dispatch(kind, request_dict) -> uint8 image
        self.requests: queue.Queue = queue.Queue()
        self.ready = threading.Event()
        # serialize=False (--slots > 1): t2i requests run on the HTTP
        # handler threads, which only submit to the StreamingBatcher and
        # wait on their own handle, so concurrent clients share the batch;
        # i2i and freeform still go through the queue
        self.serialize = serialize

    def run(self):
        self.ready.set()
        while True:
            kind, req, reply = self.requests.get()
            try:
                t0 = time.time()
                img = self.dispatch(kind, req)
                reply.put(("ok", img, time.time() - t0))
            except Exception as e:  # noqa: BLE001 - the worker must outlive a failed request
                reply.put(("error", str(e), 0.0))

    def generate(self, kind: str, req: dict):
        if not self.serialize and kind == "t2i":
            try:
                t0 = time.time()
                return ("ok", self.dispatch(kind, req), time.time() - t0)
            except TimeoutError as e:
                # a wedged drive loop sheds requests (HTTP 503) instead of
                # pinning handler threads
                return ("timeout", str(e) or "generation timed out", 0.0)
            except Exception as e:  # noqa: BLE001
                return ("error", str(e), 0.0)
        reply: queue.Queue = queue.Queue()
        self.requests.put((kind, req, reply))
        return reply.get()


_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>sjd_tpu_torch demo</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:780px;margin:2rem auto;padding:0 1rem}
 fieldset{margin-bottom:1rem;border:1px solid #ccc;border-radius:6px}
 textarea{width:100%;box-sizing:border-box}
 img.out{max-width:100%;border:1px solid #ddd;margin-top:.5rem}
 .row{display:flex;gap:.75rem;align-items:center;flex-wrap:wrap;margin:.4rem 0}
 button{padding:.4rem 1.1rem}  #status{color:#555}
</style></head><body>
<h2>sjd_tpu_torch — speculative Jacobi decoding demo</h2>
<p id="health">checking server…</p>
<fieldset><legend>mode</legend>
 <div class="row">
  <label><input type="radio" name="mode" value="t2i" checked> text→image</label>
  <label><input type="radio" name="mode" value="i2i"> image+text→image</label>
  <label><input type="radio" name="mode" value="freeform"> freeform QA</label>
 </div></fieldset>
<fieldset><legend>request</legend>
 <textarea id="prompt" rows="3" placeholder="prompt (or one QA question per line in freeform)"></textarea>
 <div class="row">
  <label>seed <input id="seed" type="number" value="42" style="width:7rem"></label>
  <label id="imgrow" style="display:none">image(s)
    <input id="imgs" type="file" accept="image/*" multiple></label>
  <button id="go">generate</button> <span id="status"></span>
 </div></fieldset>
<div id="result"></div>
<script>
const $=id=>document.getElementById(id);
fetch('/health').then(r=>r.json()).then(h=>{
  $('health').textContent='model: '+h.model+' · slots: '+h.slots+
    (h.smoke?' · SMOKE (random weights)':'');
}).catch(()=>{$('health').textContent='server unreachable'});
document.querySelectorAll('input[name=mode]').forEach(r=>r.onchange=()=>{
  $('imgrow').style.display =
    document.querySelector('input[name=mode]:checked').value==='t2i'?'none':'';
});
const b64=f=>new Promise(res=>{const rd=new FileReader();
  rd.onload=()=>res(rd.result.split(',')[1]);rd.readAsDataURL(f);});
$('go').onclick=async()=>{
  const mode=document.querySelector('input[name=mode]:checked').value;
  const body={seed:+$('seed').value};
  let path='/generate';
  if(mode==='t2i'){body.prompt=$('prompt').value;}
  else{
    body.images=await Promise.all([...$('imgs').files].map(b64));
    if(mode==='i2i'){path='/generate_i2i';body.prompt=$('prompt').value;}
    else{path='/freeform';
         body.qas=$('prompt').value.split('\\n').filter(x=>x).map(q=>[q,null]);}
  }
  $('status').textContent='generating…';$('go').disabled=true;
  const t0=performance.now();
  try{
    const r=await fetch(path,{method:'POST',body:JSON.stringify(body)});
    if(!r.ok){$('status').textContent='error: '+(await r.text());return;}
    const blob=await r.blob();
    const img=new Image();img.className='out';
    img.src=URL.createObjectURL(blob);
    $('result').prepend(img);
    $('status').textContent=((performance.now()-t0)/1000).toFixed(1)+' s';
  }catch(e){$('status').textContent='request failed: '+e;}
  finally{$('go').disabled=false;}
};
</script></body></html>
"""


def make_handler(worker: ModelWorker, stats: dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._reply(200, "text/html; charset=utf-8", _INDEX_HTML.encode())
            elif self.path == "/health":
                streamer = stats.get("_streamer")
                extra = streamer.stats() if streamer is not None else {}
                with stats["_lock"]:
                    own = {k: v for k, v in stats.items() if not k.startswith("_")}
                self._reply(200, "application/json",
                            json.dumps({"status": "ok", **extra, **own}).encode())
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            routes = {"/generate": "t2i", "/generate_i2i": "i2i", "/freeform": "freeform"}
            if self.path not in routes:
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            status, img, dt = worker.generate(routes[self.path], req)
            if status != "ok":
                # 503 for timeouts (retryable; the batcher may be wedged),
                # 500 for generation errors
                self._reply(503 if status == "timeout" else 500, "application/json",
                            json.dumps({"error": img}).encode())
                return
            body = encode_png(np.asarray(img))
            # handler threads run concurrently in --slots mode
            with stats["_lock"]:
                stats["served"] = stats.get("served", 0) + 1
                stats["last_latency_s"] = round(dt, 2)
            self._reply(200, "image/png", body)

    return Handler


class DemoServer(ThreadingHTTPServer):
    """The HTTP server over the worker; closing it closes the batcher too.
    ``warmup_s``: the seconds of the request run before listening."""

    def __init__(self, address, handler, streamer, warmup_s: float):
        super().__init__(address, handler)
        self.streamer = streamer
        self.warmup_s = warmup_s

    def server_close(self):
        super().server_close()
        if self.streamer is not None:
            self.streamer.close()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--model", default="llamagen")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--target-size", type=int, default=768)
    ap.add_argument("--gpt-model", default="GPT-B")
    ap.add_argument("--latent-size", type=int, default=8)
    ap.add_argument("--slots", type=int, default=1,
                    help="continuous-batching slots for /generate (>1 serves "
                         "concurrent requests through one StreamingBatcher)")
    ap.add_argument("--prompt-bucket", type=int, default=256,
                    help="extra prompt-token headroom over a minimal prompt in "
                         "--slots mode (longer prompts 500)")
    ap.add_argument("--chunk-steps", type=int, default=192)
    ap.add_argument("--wait-timeout", type=float, default=900.0,
                    help="per-request generation timeout in --slots mode; "
                         "expirations return HTTP 503 instead of pinning handler "
                         "threads on a wedged drive loop")
    ap.add_argument("--emu3-grid", type=int, default=90,
                    help="Emu3 latent grid side (90 = 720px)")
    ap.add_argument("--quantize", default=None, help="w4a8 recommended for --slots > 1")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_model(args):
    """The model ``args`` name, through ``loader.load_pretrained_model``."""
    if "lumina" in args.model:
        kwargs = dict(ckpt_dir=args.ckpt_dir, vq_ckpt=args.vq_ckpt,
                      target_size=args.target_size)
    elif "llamagen" in args.model:
        kwargs = dict(gpt_ckpt=args.ckpt_dir, vq_ckpt=args.vq_ckpt, name=args.gpt_model,
                      latent_size=args.latent_size)
    elif "emu3" in args.model:
        kwargs = dict(ckpt_dir=args.ckpt_dir, vq_ckpt_dir=args.vq_ckpt,
                      h=args.emu3_grid, w=args.emu3_grid)
    else:  # anole
        kwargs = dict(ckpt_dir=args.ckpt_dir, vq_ckpt=args.vq_ckpt)
    if args.quantize:  # every loader takes quantize (w4a8 / 8 / 4)
        kwargs["quantize"] = args.quantize if args.quantize == "w4a8" else int(args.quantize)
    if args.slots > 1 and ("lumina" in args.model or "emu3" in args.model):
        import torch

        # the bf16 VQ decode: its fp32 transients beside a full slot batch
        kwargs["vq_dtype"] = torch.bfloat16
    return load_pretrained_model(args.model, device=args.device, **kwargs)


def _decode_images(req) -> list:
    """The request's base64 uploads -> uint8 RGB arrays (a PNG without PIL);
    the item processor fits any size to its crop list."""
    return [image_from_bytes(base64.b64decode(b64), f"upload {i}")
            for i, b64 in enumerate(req.get("images", []))]


def build_server(model, args) -> DemoServer:
    """The server for a loaded model (``args`` from :func:`parse_args`): the
    worker, the batcher with ``--slots > 1``, one warm-up request through
    the /generate path, then the listening socket on ``args.port`` (0 picks
    a free one: ``server.server_address[1]``)."""
    streamer = None
    neg_ids = None
    embed_mode = False
    if args.slots > 1:
        from ..core.serving import StreamingBatcher

        if "llamagen" in args.model:
            # embedding-conditioned: class or caption rows per request
            embed_mode = True
            streamer = StreamingBatcher(
                model.engine, model.params, batch=args.slots, chunk_steps=args.chunk_steps,
                prompt_width=model.extras["prompt_width"],
                embed_dim=model.extras["embed_dim"])
        else:
            if not any(k in args.model for k in ("lumina", "emu3", "anole")):
                raise ValueError("--slots > 1 serves lumina / emu3 / anole / llamagen")
            prompt_ids_fn = model.extras["prompt_ids_fn"]
            if "emu3" in args.model:
                # Emu3's CFG needs the full negative generation prompt per slot
                neg_ids = model.extras["neg_ids_fn"]()
            # bucket = a minimal prompt + --prompt-bucket headroom; shorter
            # prompts are left-padded, longer ones refused (HTTP 500)
            streamer = StreamingBatcher(
                model.engine, model.params, batch=args.slots, chunk_steps=args.chunk_steps,
                prompt_width=len(prompt_ids_fn("x")) + args.prompt_bucket,
                neg_width=len(neg_ids) + 48 if neg_ids is not None else 0,
                make_gstate=model.extras.get("make_gstate"))

    def dispatch(kind, req):
        seed = int(req.get("seed", 42))
        if kind == "t2i":
            if streamer is None:
                return model.sample_fn(req.get("prompt", ""), seed)
            if embed_mode:
                pe, ne, pm = model.extras["embed_prompt_fn"](req.get("prompt", ""))
                handle = streamer.submit(
                    prompt_embeds=pe[0].cpu(), neg_prompt_embeds=ne[0].cpu(),
                    prompt_mask=pm[0].cpu() if pm is not None else None, seed=seed)
            else:
                ids = model.extras["prompt_ids_fn"](req.get("prompt", ""))
                handle = streamer.submit(ids, neg_prompt_ids=neg_ids, seed=seed)
            return model.extras["decode_image_fn"](
                handle.wait(timeout=args.wait_timeout).tokens.tolist())
        # the image-input flows run a second B = 1 engine state, which does
        # not fit beside a full slot batch: refused up front in batched mode
        if streamer is not None:
            raise ValueError("/generate_i2i and /freeform are unavailable with --slots > 1 "
                             "(a second engine state does not fit beside the slot batch); "
                             "run a separate --slots 1 server for image-input flows")
        if kind == "i2i":
            fn = model.extras.get("sample_i2i_fn")
            if fn is None:
                raise ValueError(f"{model.name} has no image-input path")
            return fn(req.get("prompt", ""), _decode_images(req), seed)
        fn = model.extras.get("sample_freeform_fn")
        if fn is None:
            raise ValueError(f"{model.name} has no freeform path")
        return fn(req.get("qas", []), _decode_images(req), seed)

    worker = ModelWorker(dispatch, serialize=streamer is None)
    worker.start()
    worker.ready.wait()
    t0 = time.perf_counter()
    status, err, _ = worker.generate("t2i", dict(WARMUP_REQUEST))
    if status != "ok":
        if streamer is not None:
            streamer.close()
        raise RuntimeError(f"the warm-up request failed: {err}")
    warmup_s = time.perf_counter() - t0
    stats = {"model": model.name, "slots": args.slots, "_streamer": streamer,
             "_lock": threading.Lock(), "smoke": bool(model.extras.get("smoke"))}
    return DemoServer(("0.0.0.0", args.port), make_handler(worker, stats), streamer, warmup_s)


def main(argv=None) -> None:
    args = parse_args(argv)
    since = compile_watch.snapshot()
    t0 = time.perf_counter()
    model = load_model(args)
    load_s = time.perf_counter() - t0
    server = build_server(model, args)
    print(json.dumps({"model": model.name, "load_s": load_s, "warmup_s": server.warmup_s,
                      **compile_watch.delta(since)}), flush=True)
    print(f"serving {model.name} on :{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
