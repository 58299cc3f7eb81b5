"""The video route and the eval model's inputs, the port against the JAX
package on the CPU:

  - data/video.py: `sample_frame_indices` on a sweep, a GIF and a frame
    directory load the same frames (pixels), `frames_to_views` gives the
    same views, and an mp4 without `av` raises the same ImportError;
  - `multimodal.encode_video` on a tiny f32 model (the port on JAX's
    weights through LaViDa.from_jax) is JAX's within the band of the
    existing encode_views parity test, atol 1e-5;
  - `LavidaEvalModel`'s video request builds JAX `_generate_video`'s ids
    and block (atol 1e-5) and calls the generation with JAX's arguments;
  - one tiny eval document per route (image, several images, video,
    log-likelihood) hands the model the inputs JAX's adapter hands it
    (ids exactly, views exactly, prefix embeddings atol 1e-5);
  - whole generations of the image and video routes give JAX's text, and
    an `evaluate` over is_video documents JAX's predictions and scores.
    The LLaDA weights are scaled x10 (tests/test_torch_models.py), so the
    logits spread and the f32 commits have no near-ties: free-running
    tokens agree (asserted, so a tie would show as a failure here, not
    pass unnoticed).
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.data import SigLIPImageProcessor as JProcessor
from lavida_mod_tpu.data import video as jvideo
from lavida_mod_tpu.eval import adapter as jadapter
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import multimodal as jmm
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.data import SigLIPImageProcessor as TProcessor
from lavida_mod_tpu_torch.data import video as tvideo
from lavida_mod_tpu_torch.eval import adapter as tadapter
from lavida_mod_tpu_torch.models import multimodal as tmm
from lavida_mod_tpu_torch.models.lavida import LaViDa

torch.set_num_threads(2)

CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
GEN_KW = {"max_new_tokens": 8, "block_length": 8, "step_per_block": 8}


class WordTokenizer:
    """Characters in, words out (so scores depend on the tokens)."""

    bos_token_id = 1
    chat_template = None
    WORDS = ["yes", "no", "A", "B", "C", "D", "2", "dog", "cat", "the"]

    def __call__(self, text):
        class R:
            input_ids = [1] + [10 + (ord(c) % 80) for c in text[:24]]

        return R()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.WORDS[int(i) % len(self.WORDS)] for i in ids)


@pytest.fixture(scope="module")
def pair():
    """(the JAX LaViDa, f32, LLaDA weights x10 and unstacked; the port
    model on the same weights)."""
    jm = JLaViDa.random_init(CFG, 0, jnp.float32)
    jm.params["llada"] = jl.unstack_blocks(jax.tree.map(
        lambda a: a * 10.0 if a.ndim >= 2 else a, jm.params["llada"]))
    tm = LaViDa.from_jax(CFG, jax.tree.map(np.asarray, jm.params), "cpu")
    return jm, tm


def _frames(n, size=(60, 44), seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                         dtype=np.uint8)) for _ in range(n)]


def _same_frames(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.size == y.size and x.mode == y.mode
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# data/video.py
# ---------------------------------------------------------------------------

def test_sample_frame_indices_equal_jax():
    for total in range(0, 90, 7):
        for n in (1, 2, 5, 8, 32, 33):
            assert tvideo.sample_frame_indices(total, n) == \
                jvideo.sample_frame_indices(total, n)
    assert tvideo.sample_frame_indices(64, 32) == list(range(0, 64, 2))


@pytest.mark.parametrize("n", [3, 32])
def test_gif_and_frame_dir_load_as_jax(tmp_path, n):
    frames = _frames(40)
    gif = tmp_path / "v.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:],
                   duration=40, loop=0)
    got = tvideo.load_video_frames(str(gif), n)
    _same_frames(got, jvideo.load_video_frames(str(gif), n))
    assert len(got) == min(n, 40)
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames[:12]):
        f.save(d / f"{i:03d}.png")
    (d / "notes.txt").write_text("not a frame")
    got = tvideo.load_video_frames(str(d), n)
    _same_frames(got, jvideo.load_video_frames(str(d), n))
    np.testing.assert_array_equal(
        tvideo.frames_to_views(got, TProcessor(size=56)),
        jvideo.frames_to_views(got, JProcessor(size=56)))


def test_video_av_path_gated():
    """An mp4 goes to the pyav decoder; without `av` both packages raise
    the same ImportError (tests/test_video_web.py:140)."""
    try:
        import av  # noqa: F401

        pytest.skip("av present; decode path exercised implicitly")
    except ImportError:
        pass
    msgs = []
    for mod in (tvideo, jvideo):
        with pytest.raises(ImportError, match="pyav") as e:
            mod.load_video_frames("/nonexistent/clip.mp4")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the video encode and the adapter's requests
# ---------------------------------------------------------------------------

def _views(frames):
    return tvideo.frames_to_views(frames, TProcessor(
        size=CFG.vision.siglip.image_size))


def test_encode_video_equals_jax(pair):
    jm, tm = pair
    views = _views(_frames(5))
    with torch.no_grad():
        got = tmm.encode_video(tm, torch.from_numpy(views))
    want = jmm.encode_video(jm.params, CFG, jnp.asarray(views))
    # 5 frames x (2x2 pooled from 4x4) 4 tokens + one newline
    assert got.shape == want.shape == (5 * 4 + 1, CFG.llada.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got[-1].numpy(),
                                  tm.image_newline.detach().numpy())


def _capture(monkeypatch, cls, name, store, result):
    def fake(self, *args, **kw):
        store.append((args, kw))
        return result
    monkeypatch.setattr(cls, name, fake)


def _gen_fields(g):
    return dataclasses.asdict(g)


def test_video_request_equals_jax(pair, monkeypatch):
    """generate_until(video=True): JAX's ids, block and generate call
    (prefix_bucket 128, kv8, image_features=[block])."""
    jm, tm = pair
    frames = _frames(6, (50, 70), seed=3)
    calls = {"jax": [], "port": []}
    out = np.array([3, 4, 5], np.int64)
    _capture(monkeypatch, JLaViDa, "generate", calls["jax"], out)
    _capture(monkeypatch, LaViDa, "generate", calls["port"], out)
    texts = []
    for ev in (jadapter.LavidaEvalModel(jm, WordTokenizer(), kv8=True),
               tadapter.LavidaEvalModel(tm, WordTokenizer(), kv8=True)):
        texts.append(ev.generate_until("What happens?", frames, GEN_KW,
                                       video=True))
        assert len(ev.latencies) == 1
    assert texts[0] == texts[1] and texts[0]
    (ja, jk), (ta, tk) = calls["jax"][0], calls["port"][0]
    np.testing.assert_array_equal(ta[0], ja[0])
    assert list(ta[0]).count(-200) == 1
    jblock, tblock = jk.pop("image_features"), tk.pop("image_features")
    assert len(jblock) == len(tblock) == 1
    np.testing.assert_allclose(tblock[0].numpy(), np.asarray(jblock[0]),
                               atol=1e-5, rtol=0)
    assert tblock[0].shape[0] == 6 * 4 + 1
    assert _gen_fields(tk.pop("gen")) == _gen_fields(jk.pop("gen"))
    assert tk == jk == {"prefix_bucket": 128, "kv8": True}
    ids, views = tadapter.LavidaEvalModel(tm, WordTokenizer()).video_inputs(
        "What happens?", frames)
    np.testing.assert_array_equal(ids, ja[0])
    assert views.shape == (6, 3, 56, 56)


@pytest.mark.parametrize("route", ["image", "two_images", "loglikelihood"])
def test_eval_document_inputs_equal_jax(pair, monkeypatch, route):
    """The inputs each adapter hands the model for one eval document:
    generate_fused's ids, views, sizes and arguments (an image; two
    images in the "pad" mode), the MC estimator's prefix embeddings and
    answer ids (a log-likelihood document)."""
    jm, tm = pair
    imgs = _frames(2, (90, 50), seed=5)[:1 if route != "two_images" else 2]
    calls = {"jax": [], "port": []}
    if route == "loglikelihood":
        def fake_ll(store):
            def run(*args, **kw):
                store.append((args, kw))
                return -1.5
            return run
        monkeypatch.setattr(jadapter, "get_log_likelihood",
                            fake_ll(calls["jax"]))
        monkeypatch.setattr(tadapter, "get_log_likelihood",
                            fake_ll(calls["port"]))
    else:
        out = np.array([6, 7], np.int64)
        _capture(monkeypatch, JLaViDa, "generate_fused", calls["jax"], out)
        _capture(monkeypatch, LaViDa, "generate_fused", calls["port"], out)
    answers = []
    for ev in (jadapter.LavidaEvalModel(jm, WordTokenizer()),
               tadapter.LavidaEvalModel(tm, WordTokenizer())):
        if route == "loglikelihood":
            answers.append(ev.loglikelihood("Which?", imgs, "a dog"))
        else:
            answers.append(ev.generate_until("Which?", imgs, GEN_KW))
    assert answers[0] == answers[1]
    (ja, jk), (ta, tk) = calls["jax"][0], calls["port"][0]
    if route == "loglikelihood":
        # (lm params, cfg, prefix, answer) in JAX; (lm, prefix, answer)
        np.testing.assert_allclose(ta[1].numpy(), np.asarray(ja[2]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ta[2], ja[3])
        assert tk["mc_num"] == jk["mc_num"] == 16
        assert tk["act_int8"] == jk["act_int8"] is False
        return
    np.testing.assert_array_equal(ta[0], ja[0])
    assert len(ta[1]) == len(ja[1]) == len(imgs)
    for tv, jv in zip(ta[1], ja[1]):
        np.testing.assert_array_equal(tv, jv)
    assert [tuple(s) for s in ta[2]] == [tuple(s) for s in ja[2]]
    assert _gen_fields(ta[3]) == _gen_fields(ja[3])
    assert tk == jk == {"prefix_bucket": 128, "kv8": False}


# ---------------------------------------------------------------------------
# whole generations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("video", [False, True])
def test_generation_text_equals_jax(pair, video):
    jm, tm = pair
    frames = _frames(4 if video else 1, (64, 48), seed=9)
    texts = [ev.generate_until("Describe it.", frames, GEN_KW, video=video)
             for ev in (jadapter.LavidaEvalModel(jm, WordTokenizer()),
                        tadapter.LavidaEvalModel(tm, WordTokenizer()))]
    assert texts[1] == texts[0] and len(texts[0].split()) >= 1


def test_evaluate_video_documents_equal_jax(pair, tmp_path):
    """evaluate() over two is_video documents (GIFs, 6 frames each) of
    `videomme` with the real tiny model: JAX's predictions and scores."""
    from lavida_mod_tpu.eval.evaluator import evaluate as jevaluate
    from lavida_mod_tpu.eval.tasks import get_task as jget
    from lavida_mod_tpu_torch.eval.evaluator import evaluate
    from lavida_mod_tpu_torch.eval.tasks import get_task
    from lavida_mod_tpu_torch.tools import eval_smoke_all as smoke

    jm, tm = pair
    imgs = smoke.write_images(str(tmp_path), n=4)
    path = smoke.write_docs("videomme", str(tmp_path), imgs, video_frames=6)
    outs = []
    for ev, task, m in ((jevaluate, jget("videomme"), jm),
                        (evaluate, get_task("videomme"), tm)):
        docs = task.load_docs(path, limit=2)
        assert all(d["is_video"] for d in docs)
        adapter = (jadapter.LavidaEvalModel if m is jm else
                   tadapter.LavidaEvalModel)(m, WordTokenizer())
        out = ev(adapter, task, docs, {"max_new_tokens": 4},
                 log_samples=True, progress=False)
        assert len(adapter.latencies) == 2
        outs.append(out)
    assert outs[1]["samples"] == outs[0]["samples"]
    assert outs[1]["results"]["acc"] == outs[0]["results"]["acc"]
    assert os.path.exists(path)


def test_video_route_does_not_record_autograd(pair):
    """A video request on a model whose parameters require gradients (the
    in-training eval's) records nothing and leaves them as they were."""
    _, tm = pair
    m = copy.deepcopy(tm)
    for p in m.parameters():
        p.requires_grad_(True)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    ev = tadapter.LavidaEvalModel(m, WordTokenizer())
    ev.generate_until("Describe it.", _frames(3), GEN_KW, video=True)
    for n, p in m.named_parameters():
        assert p.grad is None and torch.equal(p.detach(), before[n]), n
