"""The port's training data pipeline (lavida_mod_tpu_torch.data.preprocess,
.dataset, .native and tools/make_synthetic_data.py) against the JAX
package's on the CPU: the same ids, labels, records, batches and numpy rng
draws for the same inputs and seeds (the cases of tests/test_data.py),
and the native BPE merge engine built into the port's build directory."""

import json
import random
import runpy
import sys

import numpy as np
import pytest

from lavida_mod_tpu.config import VisionConfig as JVisionConfig
from lavida_mod_tpu.config import tiny_siglip_config as j_tiny_siglip
from lavida_mod_tpu.data import dataset as jds
from lavida_mod_tpu.data import preprocess as jpp
from lavida_mod_tpu_torch.config import VisionConfig, tiny_siglip_config
from lavida_mod_tpu_torch.data import dataset as tds
from lavida_mod_tpu_torch.data import native
from lavida_mod_tpu_torch.data import preprocess as tpp


class CharTokenizer:
    """tests/test_data.py's toy tokenizer: one id per character."""

    bos_token_id = 1

    def __call__(self, text):
        class R:
            input_ids = [2 + (ord(c) % 200) for c in text]

        return R()


SRC = [
    {"from": "human", "value": "what is this?"},
    {"from": "gpt", "value": "a cat sitting on a warm red mat by the door"},
    {"from": "human", "value": "and this?"},
    {"from": "gpt", "value": "a dog that runs after the ball in the park"},
]

PRE_CASES = {   # style, has_image, is_infill_model, turns
    "llada": ("llada", False, False, SRC),
    "llada_image": ("llada", True, False, SRC[:2]),
    "dream": ("dream", False, False, SRC),
    "llada_fim": ("llada", False, True, SRC),
    "dream_fim_image": ("dream", True, True, SRC),
    "system_first": ("llada", False, False,
                     [{"role": "system", "content": "be brief"}] + SRC[:2]),
}


def _same_item(a, b):
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert a["input_ids"].dtype == b["input_ids"].dtype


@pytest.mark.parametrize("name", list(PRE_CASES))
def test_preprocess_diffusion_matches_jax(name):
    """20 draws from one rng: ids, labels and the rng's state after each."""
    style, has_image, fim, src = PRE_CASES[name]
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        a = jpp.preprocess_diffusion(src, CharTokenizer(), style,
                                     has_image=has_image, rng=rj,
                                     is_infill_model=fim)
        b = tpp.preprocess_diffusion(src, CharTokenizer(), style,
                                     has_image=has_image, rng=rt,
                                     is_infill_model=fim)
        _same_item(a, b)
        assert rj.bit_generator.state == rt.bit_generator.state


@pytest.mark.parametrize("template", ["v1", "qwen_1_5", "mpt", "llama_2",
                                      "gemma_instruct", "llava_llama_3",
                                      "plain"])
def test_preprocess_ar_matches_jax(template):
    src = SRC[:2] if template == "plain" else SRC
    for has_image in (False, True):
        _same_item(jpp.preprocess_ar(src, CharTokenizer(), template,
                                     has_image=has_image),
                   tpp.preprocess_ar(src, CharTokenizer(), template,
                                     has_image=has_image))


def _write_sources(tmp_path):
    a = [{"id": f"a{i}", "conversations": SRC[:2], "image": f"i{i}.png"}
         for i in range(10)]
    b = [{"id": f"b{i}", "conversations": SRC[2:]} for i in range(6)]
    (tmp_path / "a.json").write_text(json.dumps(a))
    with open(tmp_path / "b.jsonl", "w") as f:
        for r in b:
            f.write(json.dumps(r) + "\n")
    (tmp_path / "x1.json").write_text(json.dumps(a[:2]))
    (tmp_path / "x2.json").write_text(json.dumps(b[:3]))
    (tmp_path / "mix.yaml").write_text(f"""
datasets:
  - json_path: {tmp_path}/a.json
    sampling_strategy: first:4
    image_root: /imgs/a
  - json_path: {tmp_path}/b.jsonl
    sampling_strategy: "random:50%"
  - json_path: {tmp_path}/a.json
    sampling_strategy: end:3
  - json_path: {tmp_path}/b.jsonl
""")


@pytest.mark.parametrize("source", ["a.json", "b.jsonl", "{x1,x2}.json",
                                    "mix.yaml"])
def test_load_mixture_matches_jax(tmp_path, source):
    """Record order and sampling; the yaml's random strategy given the same
    shuffle state (the port takes a random.Random, JAX the global one)."""
    if source.endswith(".yaml"):
        pytest.importorskip("yaml")
    _write_sources(tmp_path)
    path = str(tmp_path / source)
    state = random.getstate()
    try:
        random.seed(11)
        want = jds.load_mixture(path)
        random.seed(11)
        default = tds.load_mixture(path)
    finally:
        random.setstate(state)
    assert tds.load_mixture(path, random.Random(11)) == want
    assert default == want
    if source.endswith(".yaml"):
        assert len(want) == 4 + 3 + 3 + 6
        assert want[0]["image"] == "/imgs/a/i0.png"


def _image_data(tmp_path, n=5):
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for k in range(n - 1):
        Image.new("RGB", (90 + 7 * k, 60 + 11 * k),
                  (k * 40, 128, 255 - k)).save(img_dir / f"i{k}.png")
    recs = [{"conversations": SRC[:2], "image": f"i{k}.png"}
            for k in range(n - 1)] + [{"conversations": SRC}]
    (tmp_path / "d.json").write_text(json.dumps(recs))
    return str(tmp_path / "d.json"), str(img_dir)


def _vision(pkg):
    kw = dict(grid_pinpoints=((56, 112), (112, 56), (112, 112)))
    if pkg == "jax":
        return JVisionConfig(siglip=j_tiny_siglip(), **kw)
    return VisionConfig(siglip=tiny_siglip_config(), **kw)


def _same_items(xs, ys):
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        _same_item(a, b)
        assert a["image_sizes"] == b["image_sizes"]
        assert len(a["images"]) == len(b["images"])
        for va, vb in zip(a["images"], b["images"]):
            np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("fim", [False, True])
def test_dataset_items_and_get_batch_match_jax(tmp_path, fim):
    """SupervisedDataset's items (views, sizes, ids, labels, lengths) are
    JAX's, and get_batch with a decode pool equals the items taken one by
    one (the rng-bound preprocess stays in index order)."""
    from concurrent.futures import ThreadPoolExecutor

    path, img_dir = _image_data(tmp_path)

    def build(mod, pkg):
        return mod.SupervisedDataset(path, CharTokenizer(), _vision(pkg),
                                     image_folder=img_dir, seed=7,
                                     is_infill_model=fim)

    j, t = build(jds, "jax"), build(tds, "torch")
    assert t.lengths == j.lengths
    assert t.modality_lengths == j.modality_lengths
    idx = [2, 0, 4, 1, 3, 2]
    want = [j[i] for i in idx]
    _same_items(want, [t[i] for i in idx])
    t = build(tds, "torch")
    with ThreadPoolExecutor(max_workers=3) as pool:
        _same_items(want, t.get_batch(idx, pool=pool))
    _same_items(want, build(tds, "torch").get_batch(idx))


def test_retry_policy_as_jax(tmp_path):
    """A record whose image is missing fails three times, then its
    neighbour is taken (train.py:1418-1448); the last record re-raises."""
    path, img_dir = _image_data(tmp_path)
    recs = json.loads(open(path).read())
    recs[1]["image"] = "missing.png"
    recs.append({"conversations": SRC[:2], "image": "gone.png"})
    (tmp_path / "d.json").write_text(json.dumps(recs))
    j = jds.SupervisedDataset(path, CharTokenizer(), _vision("jax"),
                              image_folder=img_dir, seed=3)
    t = tds.SupervisedDataset(path, CharTokenizer(), _vision("torch"),
                              image_folder=img_dir, seed=3)
    _same_items([j[1]], [t[1]])
    assert j.rng.bit_generator.state == t.rng.bit_generator.state
    with pytest.raises(FileNotFoundError):
        t[len(recs) - 1]


@pytest.mark.parametrize("extra_pad", [None, 7, -5])
def test_collate_batch_matches_jax(extra_pad):
    rng = np.random.default_rng(0)
    items = [{"input_ids": rng.integers(0, 600, n),
              "labels": rng.integers(-100, 600, n), "images": [],
              "image_sizes": []} for n in (9, 14, 3)]
    items[0]["input_ids"][4] = 501
    for max_len in (None, 10):
        rj, rt = np.random.default_rng(1), np.random.default_rng(1)
        a = jds.collate_batch(items, 501, 501, max_len, extra_pad, rj)
        b = tds.collate_batch(items, 501, 501, max_len, extra_pad, rt)
        for k in ("input_ids", "labels", "attention_mask"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["image_sizes"] == b["image_sizes"]
        assert rj.bit_generator.state == rt.bit_generator.state


def test_length_grouped_indices_matches_jax():
    lengths = [10, 200, 30, 150, -40, 5, -300, 80, 120, 60, 90, 45] * 5
    for bs, mega in ((2, 3), (4, 50)):
        assert tds.length_grouped_indices(
            lengths, bs, np.random.default_rng(2), mega) == \
            jds.length_grouped_indices(lengths, bs,
                                       np.random.default_rng(2), mega)


def test_synthetic_data_matches_scripts(tmp_path, monkeypatch):
    """tools/make_synthetic_data.py writes scripts/make_synthetic_data.py's
    json and pixels for the same arguments."""
    from PIL import Image

    from lavida_mod_tpu_torch.tools.make_synthetic_data import make

    monkeypatch.setattr(sys, "argv", ["make_synthetic_data.py",
                                      str(tmp_path / "ref"), "--n", "5",
                                      "--size", "40"])
    runpy.run_path("scripts/make_synthetic_data.py", run_name="__main__")
    path = make(str(tmp_path / "port"), n=5, size=40)
    assert json.loads(open(path).read()) == json.loads(
        (tmp_path / "ref" / "data.json").read_text())
    for i in range(5):
        name = f"images/img_{i:04d}.png"
        a = np.asarray(Image.open(tmp_path / "ref" / name))
        b = np.asarray(Image.open(tmp_path / "port" / name))
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the native host library
# ---------------------------------------------------------------------------

def _bpe_pair():
    from lavida_mod_tpu.data.tokenizer import ByteLevelBPE as JBPE
    from lavida_mod_tpu_torch.data.tokenizer import (ByteLevelBPE,
                                                     bytes_to_unicode)

    b2u = bytes_to_unicode()
    vocab = {u: i for i, u in enumerate(b2u.values())}
    merges = []
    for a, b in (("t", "h"), ("th", "e"), ("i", "n"), ("a", "n"),
                 ("Ġ", "t"), ("Ġt", "he"), ("e", "r"), ("o", "n"),
                 ("in", "g"), ("Ġ", "a"), ("an", "d"), ("Ġa", "nd")):
        vocab.setdefault(a + b, len(vocab))
        merges.append((a, b))
    special = {"<|eot_id|>": len(vocab)}
    return (ByteLevelBPE(vocab, merges, special),
            JBPE(vocab, merges, special))


TEXTS = ["the thing and another thing", "Then, in the end: ING!",
         "naïve café — 日本語 then<|eot_id|>there", "", "  the\n\nthe  "]


def test_native_bpe_is_built_in_the_port_and_matches_jax():
    port, jax_bpe = _bpe_pair()
    assert port._native is not None, "the native merge engine did not load"
    path = native.library_path("bpe")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert "lavida_mod_tpu_torch" in str(path)
    rng = np.random.default_rng(0)
    words = ["the", "then", "and", "thing", "in", "er", "on", "Ω", " "]
    texts = TEXTS + [" ".join(rng.choice(words, 12)) for _ in range(30)]
    for text in texts:
        ids = port.encode(text)
        assert ids == jax_bpe.encode(text), text
        native_engine, port._native = port._native, None
        try:
            assert port.encode(text) == ids, text     # the Python loop
        finally:
            port._native = native_engine


def test_native_image_prep_matches_jax():
    from lavida_mod_tpu.data import native as jnative

    img = np.random.default_rng(1).integers(0, 256, (37, 53, 3), np.uint8)
    for f in (native.FILTER_BILINEAR, native.FILTER_BICUBIC,
              native.FILTER_LANCZOS):
        a = native.prep_view_native(img, (24, 30), filter_id=f)
        assert a is not None
        b = jnative.prep_view_native(img, (24, 30), filter_id=f)
        if b is not None:
            np.testing.assert_array_equal(a, b)
        c = native.prep_pad_view_native(img, (32, 32), (20, 28), (6, 2),
                                        filter_id=f)
        d = jnative.prep_pad_view_native(img, (32, 32), (20, 28), (6, 2),
                                         filter_id=f)
        assert c is not None and c.shape == (3, 32, 32)
        if d is not None:
            np.testing.assert_array_equal(c, d)


def test_auto_tokenizer_matches_the_pure_bpe(tmp_path):
    """The rehearsal's trained tokenizer (chip_smoke phase 7) through
    load_hf_or_offline, which takes transformers' AutoTokenizer given the
    tokenizer_class the published LLaDA config names, and through the pure
    loader (native merge engine): equal ids on the prompt and on decoded
    strings."""
    pytest.importorskip("transformers")
    from lavida_mod_tpu_torch.data.tokenizer import (load_hf_or_offline,
                                                     load_tokenizer)
    from lavida_mod_tpu_torch.rehearse_8b_load import (build_prompt,
                                                       write_tokenizer)

    write_tokenizer(str(tmp_path))
    cfg_path = tmp_path / "tokenizer_config.json"
    tcfg = json.loads(cfg_path.read_text())
    tcfg["tokenizer_class"] = "PreTrainedTokenizerFast"
    cfg_path.write_text(json.dumps(tcfg))
    hf = load_hf_or_offline(str(tmp_path))
    assert type(hf).__module__.startswith("transformers")
    pure = load_tokenizer(str(tmp_path), prefer_pure=True)
    assert pure._native is not None
    rng = np.random.default_rng(14)
    texts = [build_prompt(pure)[0]] + [
        pure.decode(rng.integers(0, len(pure.vocab), 48).tolist(),
                    skip_special_tokens=False) for _ in range(100)]
    for t in texts:
        assert hf.encode(t, add_special_tokens=False) == pure.encode(t), t
