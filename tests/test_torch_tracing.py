"""The serving path's spans (`lavida_mod_tpu_torch/utils/profiling.py`):
off outside a profiler, and while one records, one tree per batch whose
shape follows the work (requests, prefill chunks, control-table rows),
nested by host stamps on the profiler's own clock.  A tiny LaViDa in f32
on the CPU; the CUDA events and the span-to-kernel skew on the card.

    python -m pytest --noconftest -k cuda tests/test_torch_tracing.py
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lavida_mod_tpu_torch.config import GenerationConfig
from lavida_mod_tpu_torch.data.anyres import anyres_grid_shape
from lavida_mod_tpu_torch.eval.adapter import generate_batch
from lavida_mod_tpu_torch.generation import diffusion
from lavida_mod_tpu_torch.models.lavida import LaViDa
from lavida_mod_tpu_torch.predict import tiny_config
from lavida_mod_tpu_torch.utils import profiling

GEN = GenerationConfig(max_new_tokens=16, block_length=16, steps=8)
CLOCK_SLACK_NS = 50_000


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    model = LaViDa.random_init(cfg, 0, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    S = cfg.vision.siglip.image_size
    reqs = []
    for i, size in enumerate([(100, 60), (60, 100), (112, 112)]):
        nw, nh = anyres_grid_shape(size, cfg.vision.grid_pinpoints, S)
        views = rng.uniform(-1, 1, (1 + nw * nh, 3, S, S)).astype(np.float32)
        text = rng.integers(3, 200, size=10 + 3 * i)
        reqs.append((np.concatenate([text[:4], [-200], text[4:]]), [views],
                     [size]))
    return model, reqs


def traced(fn, *args, **kw):
    """fn's result and the spans it recorded under a CPU profiler, with
    the profiler's events."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, profiling.spans(), prof.profiler.kineto_results.events()


def children(spans):
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s["parent"]].append(s)
    return kids


def n_steps(B, prompt_len=0):
    x0 = np.full((B, prompt_len + GEN.max_new_tokens), 500, np.int64)
    x0[:, :prompt_len] = 0
    return diffusion.build_control_table(x0, prompt_len, GEN.max_new_tokens,
                                         GEN, 500)[0].shape[0]


def test_span_is_one_shared_noop_when_off():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("x"), profiling.span("y", row=3, device=True)
    assert a is b
    profiling.clear()
    with a:
        with b:
            pass
    assert profiling.spans() == []


def test_off_records_nothing_and_tokens_match_traced(setup):
    model, reqs = setup
    profiling.clear()
    plain, _ = generate_batch(model, reqs, GEN, prefix_bucket=16)
    assert profiling.spans() == []
    (out, walls), spans, _ = traced(generate_batch, model, reqs, GEN,
                                    prefix_bucket=16)
    assert spans and set(walls) == {"encode", "generate"}
    np.testing.assert_array_equal(out, plain)


def test_one_tree_per_batch(setup):
    model, reqs = setup
    B = len(reqs)
    _, spans, _ = traced(generate_batch, model, reqs, GEN, prefix_bucket=16)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s)
    (root,) = by_name["serve.batch"]
    assert root["parent"] is None
    assert all(s["root"] == root["id"] for s in spans)
    assert sorted(s["row"] for s in by_name["vision.encode"]) == list(range(B))
    for name in ("serve.sync", "serve.pack", "lm.plan", "lm.prefill",
                 "lm.denoise", "serve.readback"):
        assert len(by_name[name]) == 1, name
    kids = children(spans)
    for enc in by_name["vision.encode"]:
        names = [k["name"] for k in kids[enc["id"]]]
        # one image: its upload, tower and anyres merge, then the splice
        assert names == ["vision.upload", "vision.tower", "vision.merge",
                         "vision.merge"], names
    (pre,) = by_name["lm.prefill"]
    assert [k["name"] for k in kids[pre["id"]]] == ["lm.prefill.chunk"]
    (den,) = by_name["lm.denoise"]
    steps = kids[den["id"]]
    assert len(steps) == n_steps(B) and \
        {s["name"] for s in steps} == {"lm.step"}
    for st in steps:
        assert [k["name"] for k in kids[st["id"]]] == ["lm.forward",
                                                        "lm.commit"]
    # every child inside its parent's stamps; no device events on the CPU
    ids = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            p = ids[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]


def _prefix(model, B, P=24):
    g = torch.Generator().manual_seed(1)
    return torch.randn(B, P, model.cfg.llada.d_model, generator=g) * 0.1


@pytest.mark.parametrize("route", ["cached", "chunked", "readonly", "full",
                                   "dllm"])
def test_every_route_emits_steps(setup, route):
    """denoise_cached (chunked too), denoise_readonly (the verbose route),
    denoise_full (no cache) and generate_dllm each emit one `lm.step` per
    row of the control table, each holding one forward and one commit."""
    model, _ = setup
    B = 1 if route == "dllm" else 3
    pre = _prefix(model, B)
    gen, kw = GEN, {}
    if route == "chunked":
        kw = {"chunk": 2}
    elif route == "readonly":
        kw = {"verbose": True}
    elif route == "full":
        gen = GEN.replace(prefix_lm=False)
    elif route == "dllm":
        kw = {"dllm_cache": 4}
    _, spans, _ = traced(diffusion.generate, model.llada, pre, gen, **kw)
    kids = children(spans)
    steps = [s for s in spans if s["name"] == "lm.step"]
    assert len(steps) == n_steps(B)
    for st in steps:
        assert [k["name"] for k in kids[st["id"]]] == ["lm.forward",
                                                        "lm.commit"]
        parent = next(s for s in spans if s["id"] == st["parent"])
        assert parent["name"] == "lm.denoise"
    prefills = [s for s in spans if s["name"] == "lm.prefill"]
    assert len(prefills) == (0 if route == "full" else 1)
    chunks = [s for s in spans if s["name"] == "lm.prefill.chunk"]
    assert len(chunks) == {"cached": 1, "chunked": 2, "dllm": 1}.get(route, 0)


def test_span_stamps_share_the_profilers_clock(setup):
    """Each aten op the profiler records inside a span's record_function
    lies within the span's host stamps, widened by 50 us: the stamps are
    on the clock of the trace's events."""
    model, reqs = setup
    _, spans, events = traced(generate_batch, model, reqs[:2], GEN,
                              prefix_bucket=16)
    names = {s["name"] for s in spans}
    ranges = collections.defaultdict(list)
    ops = []
    for e in events:
        if e.name() in names:
            ranges[e.name()].append((e.start_ns(), e.end_ns()))
        elif e.name().startswith("aten::"):
            ops.append((e.start_ns(), e.end_ns()))
    ops.sort()
    checked = 0
    for name in names:
        mine = sorted((s["start_ns"], s["end_ns"]) for s in spans
                      if s["name"] == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (a, b), (ra, rb) in zip(mine, theirs):
            inside = [(oa, ob) for oa, ob in ops if ra <= oa and ob <= rb]
            for oa, ob in inside:
                assert a - CLOCK_SLACK_NS <= oa and ob <= b + CLOCK_SLACK_NS
            checked += len(inside)
    assert checked > 100


def test_the_kept_spans_are_bounded():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.CAP + 5):
            with profiling.span("x", row=i):
                pass
    got = profiling.spans()
    assert len(got) == profiling.CAP
    assert got[0]["row"] == 5 and got[-1]["row"] == profiling.CAP + 4
    profiling.clear()
    assert profiling.spans() == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA events and kernels")
    return torch.device("cuda")


@pytest.mark.parametrize("acts", ["cpu+cuda", "cuda"])
def test_device_span_on_cuda(cuda, acts):
    """A span with device=True around a lone sleep kernel: its CUDA events
    time the kernel, and the kernel lies within the span's host stamps on
    the trace's clock, to within 100 us, with or without the profiler's
    CPU activity."""
    activities = [ProfilerActivity.CUDA]
    if acts == "cpu+cuda":
        activities.append(ProfilerActivity.CPU)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=activities) as prof:
        with profiling.span("probe", device=True):
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
    (s,) = profiling.spans()
    k = [(e.start_ns(), e.end_ns())
         for e in prof.profiler.kineto_results.events()
         if e.device_type() == torch.autograd.DeviceType.CUDA
         and not e.is_user_annotation()]
    assert len(k) == 1, "the sleep kernel alone"
    ka, kb = k[0]
    assert s["device_ms"] >= (kb - ka) / 1e6 * 0.99
    assert abs(ka - s["start_ns"]) < 100_000 and abs(s["end_ns"] - kb) < 100_000
