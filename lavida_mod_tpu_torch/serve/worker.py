"""Model worker: HTTP generation endpoint and heartbeat, the port of
lavida_mod_tpu/serve/worker.py.

Capability parity with reference llava/serve/model_worker.py:44-245: a
queue semaphore, a heartbeat thread to the controller, base64 image
decoding (PIL), a generate endpoint wrapping the model, an OpenAI-style
/v1/chat/completions, and the browser page (serve/web.py) on GET.  The
model calls are the port's eval.adapter.LavidaEvalModel: one request
through `generate_until` (LaViDa.generate_fused), a merged batch through
`generate_until_batch` (eval.adapter.generate_batch).

Usage:
  python -m lavida_mod_tpu_torch.serve.worker --model-path DIR
      [--mixed | --int4] [--kv8 | --kv4] [--decode-batch N]
      [--batch-window-ms 20] [--gen-len-hint 32] [--device cuda]
      [--host 0.0.0.0] [--port 21002] [--controller-address URL
      --worker-address URL] [--model-name lavida-llada]
      [--conv-template llada] [--limit-model-concurrency 2] [--tiny]

The LM's serving layout is the JAX worker's (worker.py:409-422): weight-
only int8 by default, --int4 the grouped W4A8 layout, --mixed (implies
--int4) the int8 prefill tree beside the int4 decode tree; the fused
decode layout only when `--int4 and --decode-batch <= 1 and --gen-len-hint
<= 32`, so a batching worker (--decode-batch N > 1) keeps the llama blocks
unfused, every int4 linear on kernel #4.  --kv8 decodes over the int8 KV
cache, --kv4 over the int4 one (it wins over --kv8, as in the JAX worker).
The model is loaded onto --device (the card unless `--device cpu`, where
every kernel runs its plain version).  --tiny (or no --model-path) serves
a random 2-layer toy model without a tokenizer.  --tp N with --model-path
serves the bf16 checkpoint tensor-parallel over N ranks (worker.py:
391-402, `LaViDa.shard`): run it under torchrun with N processes, one
card each; rank 0 serves HTTP and the heartbeat, and each of its model
calls is broadcast and made by every rank together
(parallel/lockstep.py).  As the JAX worker, --tp refuses --int4 /
--mixed and --kv8 / --kv4.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from typing import Optional

from .controller import json_handler

HEART_BEAT_INTERVAL = 15


class DecodeBatcher:
    """Micro-batching of concurrent requests: the denoise loop reads every
    weight once a step whatever the batch, so requests that arrive within
    a small window are merged into one batched decode.  The reference
    worker has no batching (model_worker.py wraps single-request
    generate).

    Requests are grouped by identical gen_kwargs; each group is served
    through the adapter's generate_until_batch (bucket-padded prefixes,
    merged decode), a lone request through generate_until.

    Batch sizes are rounded UP to power-of-2 buckets (1, 2, 4, ...,
    max_batch) by duplicating the last request, as the JAX worker does:
    the worker serves a bounded set of batch shapes, and a pad row costs
    little in a decode that is bound by its weight reads."""

    def __init__(self, eval_model, max_batch: int = 4,
                 window_ms: float = 20.0):
        self.eval_model = eval_model
        self.max_batch = max_batch
        self.window = window_ms / 1e3
        self.served_sizes: list[tuple[int, int]] = []  # (real, padded)
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def submit(self, text: str, images: list, gen_kwargs: dict) -> str:
        item = {
            "text": text, "images": images, "gen_kwargs": gen_kwargs,
            "done": threading.Event(), "result": None, "error": None,
        }
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self) -> None:
        """Stop the batching thread once the queue is empty."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join()

    @staticmethod
    def _key(item: dict) -> str:
        return json.dumps(item["gen_kwargs"], sort_keys=True)

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return
            time.sleep(self.window)  # let concurrent arrivals accumulate
            with self._cv:
                key = self._key(self._queue[0])
                batch = [it for it in self._queue
                         if self._key(it) == key][: self.max_batch]
                for it in batch:
                    self._queue.remove(it)
            try:
                if len(batch) == 1:
                    preds = [self.eval_model.generate_until(
                        batch[0]["text"], batch[0]["images"],
                        batch[0]["gen_kwargs"])]
                    self.served_sizes.append((1, 1))
                else:
                    padded = batch + [batch[-1]] * (
                        self._bucket(len(batch)) - len(batch))
                    preds = self.eval_model.generate_until_batch(
                        [it["text"] for it in padded],
                        [it["images"] for it in padded],
                        batch[0]["gen_kwargs"])
                    self.served_sizes.append((len(batch), len(padded)))
                for it, pred in zip(batch, preds):
                    it["result"] = pred
            except Exception as e:  # noqa: BLE001
                for it in batch:
                    it["error"] = e
            for it in batch:
                it["done"].set()


class ModelWorker:
    def __init__(
        self,
        eval_model,                      # eval.adapter.LavidaEvalModel
        model_name: str = "lavida-llada",
        controller_addr: Optional[str] = None,
        worker_addr: Optional[str] = None,
        limit_concurrency: int = 2,
        decode_batch: int = 0,           # >1 enables micro-batching
        batch_window_ms: float = 20.0,
    ):
        self.eval_model = eval_model
        self.model_name = model_name
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.semaphore = threading.Semaphore(
            max(limit_concurrency, decode_batch))
        self.queue_length = 0
        self.batcher = (
            DecodeBatcher(eval_model, max_batch=decode_batch,
                          window_ms=batch_window_ms)
            if decode_batch > 1 else None
        )
        self._stop = threading.Event()
        if controller_addr and worker_addr:
            self.register()
            t = threading.Thread(target=self._heartbeat_loop, daemon=True)
            t.start()

    # ------------------------------------------------------------------

    def _post_controller(self, path: str, payload: dict):
        req = urllib.request.Request(
            self.controller_addr + path, json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    def status(self) -> dict:
        return {
            "model_names": [self.model_name],
            "speed": 1.0,
            "queue_length": self.queue_length,
        }

    def register(self):
        self._post_controller("/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status(),
        })

    def _heartbeat_loop(self):
        while not self._stop.wait(HEART_BEAT_INTERVAL):
            try:
                self._post_controller("/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self.queue_length,
                })
            except Exception:
                try:
                    self.register()
                except Exception:
                    pass

    def close(self) -> None:
        """Stop the heartbeat and the batcher's thread."""
        self._stop.set()
        if self.batcher is not None:
            self.batcher.close()

    # ------------------------------------------------------------------

    def generate(self, params: dict) -> dict:
        self.queue_length += 1
        try:
            with self.semaphore:
                images = []
                for b64 in params.get("images", []):
                    from PIL import Image

                    images.append(
                        Image.open(io.BytesIO(base64.b64decode(b64)))
                    )
                text = params.get("prompt", "")
                gen_kwargs = params.get("gen_kwargs", {})
                t0 = time.perf_counter()
                if self.batcher is not None:
                    out = self.batcher.submit(text, images, gen_kwargs)
                else:
                    out = self.eval_model.generate_until(
                        text, images, gen_kwargs)
                return {
                    "text": out,
                    "error_code": 0,
                    "latency_s": time.perf_counter() - t0,
                }
        except Exception as e:  # noqa: BLE001
            return {"text": "", "error_code": 1, "error": str(e)}
        finally:
            self.queue_length -= 1

    def openai_chat(self, payload: dict) -> dict:
        """OpenAI-compatible /v1/chat/completions (the sglang_worker
        analogue, reference llava/serve/sglang_worker.py): messages with
        text and image_url (data: URIs) content parts."""
        text_parts: list[str] = []
        images: list[str] = []
        for msg in payload.get("messages", []):
            if msg.get("role") != "user":
                continue
            content = msg.get("content", "")
            if isinstance(content, str):
                text_parts.append(content)
                continue
            for part in content:
                if part.get("type") == "text":
                    text_parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = part["image_url"]["url"]
                    if url.startswith("data:"):
                        images.append(url.split(",", 1)[1])
        gen_kwargs = {}
        if "max_tokens" in payload:
            gen_kwargs["max_new_tokens"] = int(payload["max_tokens"])
        if payload.get("temperature"):
            gen_kwargs["temperature"] = float(payload["temperature"])
        out = self.generate({
            "prompt": "\n".join(text_parts),
            "images": images,
            "gen_kwargs": gen_kwargs,
        })
        if out.get("error_code"):
            return {"error": {"message": out.get("error", "generation failed")}}
        return {
            "object": "chat.completion",
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out["text"]},
                "finish_reason": "stop",
            }],
            "usage": {"latency_s": out.get("latency_s")},
        }

    def handle(self, path: str, payload: dict) -> dict:
        if path == "/worker_get_status":
            return self.status()
        if path in ("/worker_generate", "/worker_generate_stream"):
            return self.generate(payload)
        if path == "/v1/chat/completions":
            return self.openai_chat(payload)
        return {"error": f"unknown path {path}", "error_code": 1}

    def server(self, host: str = "0.0.0.0",
               port: int = 21002) -> ThreadingHTTPServer:
        """The HTTP server, bound (port 0: any free port, in
        `server_address`) and not yet serving: POST runs `handle`, GET
        returns the browser page."""
        from .web import PAGE

        class Handler(json_handler(self.handle)):
            def do_GET(self):
                self._send(PAGE.encode(), "text/html; charset=utf-8")

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, host: str = "0.0.0.0", port: int = 21002):
        server = self.server(host, port)
        print(f"[worker] {self.model_name} listening on "
              f"{host}:{server.server_address[1]}")
        server.serve_forever()


def _load_tokenizer(model_path):
    """The checkpoint's tokenizer (data/tokenizer.py::load_tokenizer) where
    the directory has a tokenizer.json, else None."""
    import os

    if os.path.exists(os.path.join(model_path, "tokenizer.json")):
        from ..data.tokenizer import load_tokenizer

        return load_tokenizer(model_path)
    return None


def parse_args(argv=None):
    """The worker's flags (the JAX worker's, plus --device)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--controller-address", default=None)
    ap.add_argument("--worker-address", default=None)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--model-name", default="lavida-llada")
    ap.add_argument("--conv-template", default="llada")
    ap.add_argument("--limit-model-concurrency", type=int, default=2)
    ap.add_argument("--decode-batch", type=int, default=0,
                    help=">1 merges concurrent requests into one batched "
                         "denoise (the weight reads amortize)")
    ap.add_argument("--batch-window-ms", type=float, default=20.0)
    ap.add_argument("--int4", action="store_true",
                    help="grouped-int4 W4A8 LM serving layout; the default "
                         "stays weight-only int8")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-precision serving (implies --int4): the "
                         "int8 LM tree for the prefill next to the int4 "
                         "decode tree")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache + decode attention kernel #8")
    ap.add_argument("--kv4", action="store_true",
                    help="int4 KV cache (#8 over int4 codes)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel bf16 serving over N ranks "
                         "(torchrun; with --model-path, as LaViDa.shard)")
    ap.add_argument("--gen-len-hint", type=int, default=32,
                    help="expected max_new_tokens of the serving traffic; "
                         "the fused int4 decode layout is applied only "
                         "when this is <= 32 (and --decode-batch <= 1)")
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny model (no checkpoint; smoke/dev)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.mixed:
        args.int4 = True  # the mixed split rides the int4 decode tree
    return args


def build_eval_model(args):
    """The model of `args` on its device in its serving layout (or sharded
    under --tp), its tokenizer, as a LavidaEvalModel."""
    import torch

    from ..eval.adapter import LavidaEvalModel
    from ..models.lavida import LaViDa
    from ..predict import tiny_config

    device = torch.device(args.device)
    if args.tiny or not args.model_path:
        model = LaViDa.random_init(tiny_config(), 0, torch.float32, device)
        tokenizer = None
        print("[worker] tiny random model (no checkpoint)")
    elif args.tp > 1:
        # worker.py:391-402: multi-card bf16 serving, in its words
        if args.int4 or args.mixed:
            raise SystemExit("--tp is bf16 serving; drop --int4/--mixed")
        if args.kv8 or args.kv4:
            raise SystemExit("--tp is bf16 serving; drop --kv8/--kv4")
        from ..parallel import maybe_init_distributed

        maybe_init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        model = LaViDa.load(args.model_path, None, torch.bfloat16,
                            device=device).shard(tp=args.tp)
        tokenizer = _load_tokenizer(args.model_path)
    else:
        model = LaViDa.load(args.model_path, None, torch.bfloat16,
                            device=device)
        # the fused layout serves one short request at a time; a batching
        # worker or long generations keep the blocks unfused
        model.to_serving_layout(
            quant=("mixed" if args.mixed else
                   "int4" if args.int4 else "int8"),
            fuse=(args.int4 and args.decode_batch <= 1
                  and args.gen_len_hint <= 32),
        )
        tokenizer = _load_tokenizer(args.model_path)
    return LavidaEvalModel(model, tokenizer,
                           conv_template=args.conv_template,
                           kv8=(4 if args.kv4 else args.kv8))


MODEL_CALLS = ("generate_until", "generate_until_batch")


def build_worker(args, eval_model=None) -> ModelWorker:
    """A ModelWorker over `eval_model` (default: `build_eval_model(args)`),
    registered with the controller when both addresses are given."""
    if eval_model is None:
        eval_model = build_eval_model(args)
    return ModelWorker(
        eval_model, args.model_name,
        controller_addr=args.controller_address,
        worker_addr=args.worker_address,
        limit_concurrency=args.limit_model_concurrency,
        decode_batch=args.decode_batch,
        batch_window_ms=args.batch_window_ms,
    )


def main(argv=None):
    """`python -m lavida_mod_tpu_torch.serve.worker` — the reference's
    `python -m llava.serve.model_worker` analogue (model_worker.py CLI:
    --host/--port/--controller-address/--worker-address/--model-path/
    --limit-model-concurrency), plus the micro-batching and layout
    flags."""
    from ..parallel.lockstep import Lockstep, follow, is_distributed, rank

    args = parse_args(argv)
    eval_model = build_eval_model(args)
    if rank() != 0:         # a --tp rank: rank 0's model calls, replayed
        follow(eval_model)
        return
    lock = Lockstep(eval_model, MODEL_CALLS) if is_distributed() else None
    try:
        build_worker(args, lock or eval_model).serve(args.host, args.port)
    finally:
        if lock is not None:
            lock.close()


if __name__ == "__main__":
    main()
