"""The port's serving layer (lavida_mod_tpu_torch.serve) against the JAX
package's lavida_mod_tpu/serve, on the CPU.

  - The micro-batcher, the controller's dispatch and the worker's HTTP
    surface: the cases of tests/test_decode_batcher.py (7),
    tests/test_serve_dispatch.py (4) and tests/test_video_web.py's worker
    and register_worker tests, against the port's classes, on ephemeral
    ports.
  - The port's controller and JAX's given the same sequence of
    registrations, heartbeats, dispatches and expiries (the
    clock and the lottery's random numbers shared) give the same answers
    and end in the same registry.
  - A worker built by the port's CLI (`build_worker`) from a tiny
    reference-layout checkpoint with its tokenizer (rehearse_8b_load's
    writer), `--device cpu --kv4 --decode-batch 4`, registered with a live
    controller: four concurrent image requests merge into one batch of 4
    whose answers are generate_until_batch's on the same model and order,
    a lone request and an OpenAI chat request are generate_until's, and a
    request dispatched through the controller is answered too; the int4
    cache is what the decode ran over.
  - The terminal chat answers a turn of the tiny model.
"""

import base64
import io
import json
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

from lavida_mod_tpu_torch.serve import controller as tc
from lavida_mod_tpu_torch.serve import worker as tw
from lavida_mod_tpu_torch.serve.controller import Controller, WorkerInfo
from lavida_mod_tpu_torch.serve.worker import DecodeBatcher, ModelWorker

torch.set_num_threads(2)


class FakeEval:
    def __init__(self):
        self.batch_sizes = []
        self.single_calls = 0
        self.lock = threading.Lock()

    def generate_until(self, text, images, gen_kwargs=None):
        with self.lock:
            self.single_calls += 1
        return f"one:{text}"

    def generate_until_batch(self, texts, images, gen_kwargs=None):
        with self.lock:
            self.batch_sizes.append(len(texts))
        time.sleep(0.01)
        return [f"batch:{t}" for t in texts]


def _submit_concurrent(batcher, reqs):
    results = [None] * len(reqs)

    def run(i, text, kw):
        results[i] = batcher.submit(text, [], kw)

    threads = [threading.Thread(target=run, args=(i, t, kw))
               for i, (t, kw) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return results


# ---------------------------------------------------------------------------
# the micro-batcher (tests/test_decode_batcher.py's cases)
# ---------------------------------------------------------------------------

def test_concurrent_requests_merge():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=4, window_ms=300)
    kw = {"max_new_tokens": 8}
    res = _submit_concurrent(b, [(f"q{i}", kw) for i in range(4)])
    assert sorted(res) == [f"batch:q{i}" for i in range(4)]
    assert ev.batch_sizes == [4]
    assert ev.single_calls == 0
    b.close()


def test_mismatched_kwargs_split_groups():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=4, window_ms=300)
    res = _submit_concurrent(b, [
        ("a", {"max_new_tokens": 8}),
        ("b", {"max_new_tokens": 8}),
        ("c", {"max_new_tokens": 32}),
    ])
    assert res[0] == "batch:a" and res[1] == "batch:b"
    assert res[2] == "one:c"             # the lone group: the single path
    assert ev.batch_sizes == [2]
    assert ev.single_calls == 1


def test_single_request_uses_single_path():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=4, window_ms=10)
    assert b.submit("solo", [], {}) == "one:solo"
    assert ev.batch_sizes == [] and ev.single_calls == 1
    b.close()
    assert not b._thread.is_alive()


def test_error_propagates():
    class Boom(FakeEval):
        def generate_until(self, *a, **k):
            raise RuntimeError("boom")

    b = DecodeBatcher(Boom(), max_batch=2, window_ms=10)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit("x", [], {})


def test_worker_routes_through_batcher():
    ev = FakeEval()
    w = ModelWorker(ev, "m", decode_batch=4, batch_window_ms=300)
    out = [None, None]

    def call(i):
        out[i] = w.generate({"prompt": f"p{i}", "gen_kwargs": {}})

    ts = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert {out[0]["text"], out[1]["text"]} == {"batch:p0", "batch:p1"}
    assert ev.batch_sizes == [2]
    w.close()


def test_batch_padded_to_power_of_two_bucket():
    """3 concurrent requests serve as a 4-row padded batch (the last
    request duplicated); the results map back to the 3 real requests."""
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=8, window_ms=300)
    kw = {"max_new_tokens": 8}
    res = _submit_concurrent(b, [(f"q{i}", kw) for i in range(3)])
    assert sorted(res) == [f"batch:q{i}" for i in range(3)]
    assert ev.batch_sizes == [4]
    assert b.served_sizes == [(3, 4)]


def test_bucket_capped_at_max_batch():
    ev = FakeEval()
    b = DecodeBatcher(ev, max_batch=3, window_ms=300)
    kw = {"max_new_tokens": 8}
    res = _submit_concurrent(b, [(f"q{i}", kw) for i in range(3)])
    assert sorted(res) == [f"batch:q{i}" for i in range(3)]
    assert ev.batch_sizes == [3]


# ---------------------------------------------------------------------------
# the controller (tests/test_serve_dispatch.py's cases)
# ---------------------------------------------------------------------------

def _mk(ctrl, name, queue, speed=1.0, models=("m",)):
    ctrl.worker_info[name] = WorkerInfo(list(models), speed, queue, True,
                                        time.time())


def test_shortest_queue_dispatch():
    c = Controller("shortest_queue")
    _mk(c, "w1", queue=5)
    _mk(c, "w2", queue=1)
    _mk(c, "w3", queue=9)
    assert c.get_worker_address("m") == "w2"
    assert c.worker_info["w2"].queue_length == 2
    c2 = Controller("shortest_queue")
    _mk(c2, "slow", queue=1, speed=0.1)
    _mk(c2, "fast", queue=4, speed=10.0)
    assert c2.get_worker_address("m") == "fast"


def test_lottery_respects_model_filter():
    c = Controller("lottery")
    _mk(c, "a", queue=0, models=("x",))
    _mk(c, "b", queue=0, models=("m",))
    for _ in range(10):
        assert c.get_worker_address("m") == "b"
    assert c.get_worker_address("nope") == ""


def test_stale_worker_removal():
    c = Controller()
    _mk(c, "old", queue=0)
    c.worker_info["old"].last_heart_beat = time.time() - 10_000
    _mk(c, "new", queue=0)
    c.remove_stale_workers()
    assert "old" not in c.worker_info and "new" in c.worker_info
    assert c.list_models() == ["m"]


def test_heartbeat_updates_queue():
    c = Controller()
    _mk(c, "w", queue=0)
    assert c.receive_heart_beat("w", 7)
    assert c.worker_info["w"].queue_length == 7
    assert not c.receive_heart_beat("ghost", 1)


@pytest.mark.parametrize("method", ["shortest_queue", "lottery"])
def test_controller_follows_jax_on_one_event_sequence(method):
    """The same events through both controllers, with the clock and the
    lottery's random numbers shared: every answer and the registry after
    every event are the same."""
    from lavida_mod_tpu.serve import controller as jc

    def status(models, speed, q):
        return {"model_names": models, "speed": speed, "queue_length": q}

    events = [
        ("/register_worker", {"worker_name": "w1", "check_heart_beat": True,
                              "worker_status": status(["m"], 1.0, 3)}),
        ("/register_worker", {"worker_name": "w2", "check_heart_beat": True,
                              "worker_status": status(["m", "n"], 4.0, 5)}),
        ("/register_worker", {"worker_name": "w3",
                              "check_heart_beat": False,
                              "worker_status": status(["n"], 0.5, 0)}),
        ("/get_worker_address", {"model": "m"}),
        ("/get_worker_address", {"model": "m"}),
        ("/get_worker_address", {"model": "n"}),
        ("/receive_heart_beat", {"worker_name": "w1", "queue_length": 0}),
        ("/receive_heart_beat", {"worker_name": "ghost"}),
        ("/get_worker_address", {"model": "m"}),
        ("/get_worker_address", {"model": "x"}),
        ("tick", 100.0),        # past HEART_BEAT_EXPIRATION of w2 and w1
        ("/receive_heart_beat", {"worker_name": "w1", "queue_length": 2}),
        ("/list_models", {}),
        ("/get_worker_address", {"model": "m"}),
        ("/get_worker_address", {"model": "n"}),
        ("/worker_generate_stream", {"model": "x"}),
        ("/nope", {}),
    ]
    results = []
    for mod in (jc, tc):
        ctrl = mod.Controller(method)
        rng = np.random.default_rng(0)
        now = [1000.0]
        out = []
        with mock.patch.object(mod.time, "time", lambda: now[0]), \
                mock.patch.object(mod.random, "random",
                                  lambda: float(rng.random())):
            for path, payload in events:
                if path == "tick":
                    now[0] += payload
                    continue
                out.append(ctrl.handle(path, payload))
                out.append({n: (w.model_names, w.speed, w.queue_length,
                                w.check_heart_beat, w.last_heart_beat)
                            for n, w in ctrl.worker_info.items()})
        results.append(out)
    assert results[0] == results[1]
    assert results[1][-10] == {"models": ["m", "n"]}   # w2 expired
    assert set(results[1][-9]) == {"w1", "w3"}


# ---------------------------------------------------------------------------
# the worker's HTTP surface (tests/test_video_web.py's worker cases)
# ---------------------------------------------------------------------------

def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, payload, timeout=600):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _png(size, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                       dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_worker_serves_web_ui():
    class Eval:
        def generate_until(self, text, images, gen_kwargs=None):
            return "ok"

    server = ModelWorker(Eval(), "m").server("127.0.0.1", 0)
    url = _start(server)
    try:
        with urllib.request.urlopen(url + "/") as r:
            page = r.read().decode()
        assert "LaViDa" in page and "worker_generate" in page
        assert "TPU" not in page
        out = _post(url + "/worker_generate", {"prompt": "hi"})
        assert out["text"] == "ok" and out["error_code"] == 0
    finally:
        server.shutdown()
        server.server_close()


def test_openai_chat_endpoint():
    class Eval:
        def generate_until(self, text, images, gen_kwargs=None):
            return f"saw {len(images)} image(s): {text[:20]}"

    server = ModelWorker(Eval(), "m").server("127.0.0.1", 0)
    url = _start(server)
    try:
        body = {"model": "m", "max_tokens": 8, "messages": [
            {"role": "user", "content": [
                {"type": "text", "text": "what is this?"},
                {"type": "image_url", "image_url": {
                    "url": f"data:image/png;base64,{_png((10, 10))}"}}]}]}
        out = _post(url + "/v1/chat/completions", body)
        assert out["choices"][0]["message"]["content"].startswith("saw 1")
        assert out["object"] == "chat.completion"
    finally:
        server.shutdown()
        server.server_close()


def test_register_worker_cli():
    """register_worker posts a manual registration (worker_status None),
    so the controller asks the worker's /worker_get_status."""
    from lavida_mod_tpu_torch.serve import register_worker

    c = Controller()
    cs = c.server("127.0.0.1", 0)
    curl = _start(cs)
    ws = ModelWorker(FakeEval(), "m").server("127.0.0.1", 0)
    wurl = _start(ws)
    try:
        out = register_worker.main(["--controller-address", curl,
                                    "--worker-name", wurl])
        assert out == {"exist": True}
        assert c.worker_info[wurl].model_names == ["m"]
    finally:
        for s in (cs, ws):
            s.shutdown()
            s.server_close()


# ---------------------------------------------------------------------------
# a real tiny worker over HTTP, built from its CLI flags
# ---------------------------------------------------------------------------

SIZES = [(100, 60), (60, 100), (112, 112), (50, 50)]
GEN_KW = {"max_new_tokens": 16, "step_per_block": 8}


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A reference-layout checkpoint of the tiny geometry with LLaDA's
    vocab and special ids, and the BPE tokenizer rehearse_8b_load writes."""
    from lavida_mod_tpu_torch import rehearse_8b_load as r
    from lavida_mod_tpu_torch.config import tiny_llada_config
    from lavida_mod_tpu_torch.predict import tiny_config

    cfg = tiny_config().replace(llada=tiny_llada_config(
        vocab_size=126464, embedding_size=126464, mask_token_id=126336,
        eos_token_id=126081, pad_token_id=126081))
    path = tmp_path_factory.mktemp("ckpt")
    r.synthesize(torch, str(path), cfg, "cpu")
    return str(path)


def test_tiny_worker_answers_http_as_the_eval_model(tiny_checkpoint):
    from PIL import Image

    c = Controller()
    cs = c.server("127.0.0.1", 0)
    curl = _start(cs)
    args = tw.parse_args(["--model-path", tiny_checkpoint, "--device", "cpu",
                          "--kv4", "--decode-batch", "4",
                          "--batch-window-ms", "2000"])
    assert args.kv4 and not args.int4 and args.decode_batch == 4
    worker = tw.build_worker(args)
    em = worker.eval_model
    assert em.kv8 == 4 and em.tokenizer is not None
    assert em.model.device.type == "cpu"
    blk = em.model.llada.blocks[0]
    assert type(getattr(blk, blk.linear_names[0])).__name__ == "Int8Linear"
    ws = worker.server("127.0.0.1", 0)
    wurl = _start(ws)
    worker.controller_addr, worker.worker_addr = curl, wurl
    worker.register()

    # what the batch ran: its requests in the order the batcher took them
    seen = []
    batch_fn = em.generate_until_batch

    def recording(texts, images, gen_kwargs=None):
        out = batch_fn(texts, images, gen_kwargs)
        seen.append((list(texts), list(images), out))
        return out

    em.generate_until_batch = recording
    from lavida_mod_tpu_torch.ops import kv8_attention as tk

    quantize = tk.quantize_kv
    widths = []

    def spy(x, bits=8, reciprocal=False):
        widths.append(bits)
        return quantize(x, bits, reciprocal)

    try:
        texts = [f"Describe picture {i} in detail." for i in range(4)]
        pngs = [_png(s, i) for i, s in enumerate(SIZES)]
        answers = [None] * 4

        def call(i):
            answers[i] = _post(wurl + "/worker_generate", {
                "prompt": texts[i], "images": [pngs[i]],
                "gen_kwargs": GEN_KW})

        with mock.patch("lavida_mod_tpu_torch.generation.diffusion."
                        "quantize_kv", spy):
            ts = [threading.Thread(target=call, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
        assert worker.batcher.served_sizes == [(4, 4)]
        assert widths and set(widths) == {4}
        assert all(a["error_code"] == 0 for a in answers), answers
        (btexts, bimages, bout), = seen
        assert sorted(btexts) == sorted(texts)
        by_text = dict(zip(btexts, bout))
        for t, a in zip(texts, answers):
            assert isinstance(a["text"], str)
            assert a["text"] == by_text[t]
        # the same batch again, directly: the same answers
        assert batch_fn(btexts, bimages, GEN_KW) == bout

        # a lone request (the batcher's B = 1 route) and an OpenAI chat
        one = _post(wurl + "/worker_generate", {
            "prompt": texts[0], "images": [pngs[0]], "gen_kwargs": GEN_KW})
        img0 = Image.open(io.BytesIO(base64.b64decode(pngs[0])))
        assert one["text"] == em.generate_until(texts[0], [img0], GEN_KW)
        chat = _post(wurl + "/v1/chat/completions", {
            "model": "lavida-llada", "max_tokens": 16,
            "messages": [{"role": "user", "content": "Say hello."}]})
        assert chat["choices"][0]["message"]["content"] == \
            em.generate_until("Say hello.", [], {"max_new_tokens": 16})
        assert worker.batcher.served_sizes == [(4, 4), (1, 1), (1, 1)]

        # dispatched by the controller to the registered worker
        assert _post(curl + "/list_models", {}) == {
            "models": ["lavida-llada"]}
        via = _post(curl + "/worker_generate_stream", {
            "model": "lavida-llada", "prompt": "Say hello.",
            "gen_kwargs": {"max_new_tokens": 16}})
        assert via["error_code"] == 0 and via["text"] == \
            chat["choices"][0]["message"]["content"]
    finally:
        worker.close()
        for s in (cs, ws):
            s.shutdown()
            s.server_close()


def test_worker_cli_flags(tmp_path):
    """The flags; --tp is bf16 serving, refused with a quantized layout
    or KV cache in the JAX worker's words (worker.py:391-400) before the
    checkpoint is read."""
    args = tw.parse_args(["--mixed", "--kv8"])
    assert args.int4 and args.mixed and args.device == "cuda"
    assert tw.parse_args(["--tp", "2"]).tp == 2
    ckpt = str(tmp_path / "none")
    for extra, words in ((["--int4"], "drop --int4/--mixed"),
                         (["--mixed"], "drop --int4/--mixed"),
                         (["--kv4"], "drop --kv8/--kv4")):
        with pytest.raises(SystemExit, match=words):
            tw.build_eval_model(tw.parse_args(
                ["--model-path", ckpt, "--tp", "2", "--device", "cpu",
                 *extra]))


def test_terminal_chat_answers_a_turn(capsys):
    from lavida_mod_tpu_torch.serve import cli

    turns = iter(["hello there"])

    def fake_input(prompt=""):
        try:
            return next(turns)
        except StopIteration:
            raise EOFError

    with mock.patch("builtins.input", fake_input):
        cli.main(["--tiny", "--device", "cpu", "--max-new-tokens", "8"])
    out = capsys.readouterr().out
    assert "ASSISTANT:" in out and "tiny random model" in out
    # --tp is bf16 serving (the JAX chat's refusal, cli.py:59-60)
    with pytest.raises(SystemExit, match="--tp is bf16 serving; use "
                       "--quant none"):
        cli.main(["--model-path", "none", "--device", "cpu", "--tp", "2"])
