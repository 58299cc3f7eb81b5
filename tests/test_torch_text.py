"""The port's text half against the JAX package's, on the CPU: the
tokenizer, every conversation template, `tokenizer_image_token`, the infill
corruption, `gen_kwargs_to_config`, `decode_output` and the eval adapter's
`generate_until`.

The tokenizers are trained here with the `tokenizers` runtime, as
tests/test_tokenizer.py does: one with its GPT-2 ByteLevel pre-tokenizer
(both pure-Python BPEs given that pattern, as that file does) and one with
the Qwen/Dream split the pure BPE uses by default.  The port's
`ByteLevelBPE` (its pre-tokenization on the standard library's `re`) must
give the ids of the JAX package's `ByteLevelBPE` (on `regex`) and of the
runtime, and decode them back, on texts with special tokens, runs of
spaces and non-ASCII.

`generate_until` runs a tiny bf16 model (LLaDA weights x10 so the tokens
vary) on a PIL image: the JAX adapter in a child process without XLA's
excess precision (tests/torch_jax_strict.py), its vision attention and its
prefill through its Pallas kernels in interpret mode, as the TPU runs them
and as the port runs its own; the port's text must be JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch

from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.data import conversation as jconv
from lavida_mod_tpu.data import infill as jinfill
from lavida_mod_tpu.data import prompts as jprompts
from lavida_mod_tpu.data import tokenizer as jtok
from lavida_mod_tpu.eval.adapter import gen_kwargs_to_config as jgen_kwargs
from lavida_mod_tpu.models.lavida import LaViDa as JLaViDa
from lavida_mod_tpu_torch.config import as_port_config
from lavida_mod_tpu_torch.data import conversation as tconv
from lavida_mod_tpu_torch.data import infill as tinfill
from lavida_mod_tpu_torch.data import prompts as tprompts
from lavida_mod_tpu_torch.data import tokenizer as ttok
from lavida_mod_tpu_torch.eval import adapter as tadapter
from lavida_mod_tpu_torch.models.lavida import LaViDa
from torch_jax_strict import strict_jax

torch.set_num_threads(2)

CORPUS = [
    "Hello world! This is a test.",
    "  leading spaces and\nnewlines\n\n  mixed\t\ttabs   ",
    "Numbers 123, 4,567 and 3.14e-2; contractions don't I'll WE'RE",
    "unicode: café über naïve 中文测试 \U0001f600 ß ² Ⅷ",
    "code: def f(x):\n    return x ** 2  # comment",
    "<|im_start|>user\nembedded special tokens<|im_end|>\n",
    "<image>\nDescribe the image.<|im_end|><|im_start|>",
]
GPT2_PATTERN = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
                r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
CHAT = ("{% for message in messages %}<|im_start|>{{ message['role'] }}\n"
        "{{ message['content'] }}<|im_end|>\n{% endfor %}"
        "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
CFG = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))


def _train(d, split, vocab_size, bos=False):
    """A byte-level BPE trained by the `tokenizers` runtime, saved as
    tokenizer.json (+ tokenizer_config.json with eos, optionally bos, and a
    chat template)."""
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, trainers)

    tok = Tokenizer(models.BPE())
    if split:
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(jtok.PRETOKENIZE_REGEX), "isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)])
    else:
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                                     use_regex=True)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS * 20, trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=["<|im_start|>", "<|im_end|>", "<s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    os.makedirs(d, exist_ok=True)
    tok.save(os.path.join(d, "tokenizer.json"))
    tcfg = {"eos_token": "<|im_end|>", "chat_template": CHAT}
    if bos:
        tcfg["bos_token"] = "<s>"
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump(tcfg, f)
    return d


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    return {"gpt2": _train(str(root / "gpt2"), False, 600),
            "split": _train(str(root / "split"), True, 600),
            "bos": _train(str(root / "bos"), True, 600, bos=True),
            "small": _train(str(root / "small"), True, 300)}


def _pair(d, pattern=None):
    """(the port's pure BPE, the JAX package's), with `pattern` set."""
    t, j = ttok.load_pure_bpe(d), jtok.load_pure_bpe(d)
    if pattern is not None:
        import regex

        t.pat = ttok.compile_pattern(pattern)
        j.pat = regex.compile(pattern)
    return t, j


@pytest.mark.parametrize("kind", ["gpt2", "split"])
def test_bpe_token_exact_vs_jax_and_the_runtime(tok_dirs, kind):
    from tokenizers import Tokenizer

    d = tok_dirs[kind]
    fast = Tokenizer.from_file(os.path.join(d, "tokenizer.json"))
    t, j = _pair(d, GPT2_PATTERN if kind == "gpt2" else None)
    for text in CORPUS + ["".join(CORPUS)]:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert ids == fast.encode(text, add_special_tokens=False).ids, text
        for skip in (True, False):
            assert t.decode(ids, skip) == j.decode(ids, skip)
        assert t.decode(ids, skip_special_tokens=False) == text
        assert t.decode(ids) == fast.decode(ids, skip_special_tokens=True)


def test_load_tokenizer_paths_agree(tok_dirs, monkeypatch):
    import sys

    d = tok_dirs["split"]
    fast, pure = ttok.load_tokenizer(d), ttok.load_tokenizer(d, True)
    assert type(fast).__name__ == "_FastWrapper"
    assert isinstance(pure, ttok.ByteLevelBPE)
    jfast = jtok.load_tokenizer(d)
    monkeypatch.setitem(sys.modules, "transformers", None)
    offline = ttok.load_hf_or_offline(d)     # no transformers: the fallback
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    no_runtime = ttok.load_tokenizer(d)      # no tokenizers: the pure BPE
    assert type(offline).__name__ == "_FastWrapper"
    assert isinstance(no_runtime, ttok.ByteLevelBPE)
    for text in CORPUS:
        assert fast.encode(text) == pure.encode(text) == jfast.encode(text)
        assert offline.encode(text) == no_runtime.encode(text) == \
            pure.encode(text)
    assert pure.eos_token_id == jfast.eos_token_id is not None
    msgs = [{"role": "user", "content": "hi"}]
    for tok in (fast, pure):
        assert tok.apply_chat_template(msgs) == \
            "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n"
        assert tok.apply_chat_template(msgs, tokenize=True) == \
            pure.encode(tok.apply_chat_template(msgs))


def test_vocab_and_merges_files(tok_dirs, tmp_path):
    """vocab.json + merges.txt, added tokens from tokenizer.json."""
    data = json.load(open(os.path.join(tok_dirs["split"], "tokenizer.json")))
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(data["model"]["vocab"], f)
    with open(tmp_path / "merges.txt", "w") as f:
        f.write("#version: 0.2\n")
        f.writelines(" ".join(m if isinstance(m, list) else m.split(" "))
                     + "\n" for m in data["model"]["merges"])
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump({"added_tokens": data["added_tokens"]}, f)
    t, j = _pair(str(tmp_path))
    for text in CORPUS:
        assert t.encode(text) == j.encode(text)
    assert t.special == j.special and t.special


def test_pattern_translation_matches_regex():
    import regex

    pat = ttok.compile_pattern(ttok.PRETOKENIZE_REGEX)
    ref = regex.compile(ttok.PRETOKENIZE_REGEX)
    text = ("a\x1cb\x1d c d e　 \u0085x 12²Ⅷ "
            "٠١ é́ don't\r\n\r\n  end  \t")
    assert pat.findall(text) == ref.findall(text)
    with pytest.raises(ValueError):
        ttok.compile_pattern(r"[\S]")


# code points assigned after Unicode 15.0 (Python 3.12's unicodedata):
# Telugu U+0C5C, Cyrillic U+1C89, Arabic U+088F; letters to `regex`
NEW_LETTERS = "\u0c5c\u1c89\u088f"


def _generated_strings(n, seed=0):
    """Seeded strings over letters old and new, digits, punctuation,
    white space, combining marks, CJK and emoji."""
    alphabet = (list("abcXYZ019 .,!?'-_\t\n\r") + list("éßÅñ²Ⅷ٣") +
                ["\u0301", "\u3000", "\xa0", "中", "文", "\U0001f600",
                 "'s", "'ll", " ", "  "] + list(NEW_LETTERS) * 3)
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(alphabet, size=rng.integers(1, 40)))
            for _ in range(n)]


def test_bpe_new_unicode_letters_as_jax(tok_dirs):
    """With `regex` importable the port pre-tokenizes with it, as the JAX
    package does: letters assigned after Unicode 15.0 split as letters,
    and seeded strings give the JAX ByteLevelBPE's ids.  The standard
    library fallback (`compile_pattern`) cannot know them."""
    regex = pytest.importorskip("regex")
    d = tok_dirs["split"]
    t, j = ttok.load_pure_bpe(d), jtok.load_pure_bpe(d)
    assert isinstance(t.pat, type(regex.compile("")))
    text = f"word{NEW_LETTERS}word {NEW_LETTERS[1]}x9"
    assert t.pat.findall(text) == j.pat.findall(text) == [
        f"word{NEW_LETTERS}word", f" {NEW_LETTERS[1]}x", "9"]
    assert ttok.compile_pattern(ttok.PRETOKENIZE_REGEX).findall(text) != \
        t.pat.findall(text)
    for text in _generated_strings(300) + [NEW_LETTERS, "".join(CORPUS)]:
        ids = t.encode(text)
        assert ids == j.encode(text), repr(text)
        assert t.decode(ids, skip_special_tokens=False) == \
            j.decode(ids, skip_special_tokens=False)


def _messages(conv):
    conv.append_message(conv.roles[0], "<image>\nWhat is this?")
    conv.append_message(conv.roles[1], "A cat on a mat.")
    conv.append_message(conv.roles[0], "And its color?")
    conv.append_message(conv.roles[1], None)
    return conv


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_conversation_template_renders_as_jax(name):
    assert sorted(tconv.conv_templates) == sorted(jconv.conv_templates)
    t = _messages(tconv.get_conv_template(name))
    j = _messages(jconv.get_conv_template(name))
    assert t.get_prompt() == j.get_prompt()
    assert t.stop_token_ids == j.stop_token_ids
    assert t.stop_str == j.stop_str


def test_conversation_fallback_and_chat_template(tok_dirs):
    with pytest.warns(UserWarning):
        t = tconv.get_conv_template("no-such-template")
    assert t.name == "llada"
    t = _messages(tconv.get_conv_template("qwen_1_5"))
    j = _messages(jconv.get_conv_template("qwen_1_5"))
    t.tokenizer = ttok.load_pure_bpe(tok_dirs["split"])
    j.tokenizer = jtok.load_pure_bpe(tok_dirs["split"])
    assert t.get_prompt() == j.get_prompt()
    assert t.get_prompt().startswith("<|im_start|>system\n")


@pytest.mark.parametrize("kind", ["split", "bos"])
@pytest.mark.parametrize("prompt", [
    "<image>\nDescribe the image.",
    "Look: <image> and <image>, which differ?",
    "no image at all", "<image>"])
def test_tokenizer_image_token_as_jax(tok_dirs, kind, prompt):
    t, j = _pair(tok_dirs[kind])
    got = tprompts.tokenizer_image_token(prompt, t)
    want = jprompts.tokenizer_image_token(prompt, j)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert (got == -200).sum() == prompt.count("<image>")
    if kind == "bos":
        assert got[0] == t.bos_token_id and got[1] != t.bos_token_id


@pytest.mark.parametrize("seed", range(6))
def test_infill_as_jax(seed):
    text = ("The quick brown fox jumps over the lazy dog while seven "
            "small birds watch from the old oak tree near the river")
    for n, k in ((4, 5), (10, 2), (1, 0)):
        assert tinfill.insert_infill_substrings(
            text, n, k, np.random.default_rng(seed)) == \
            jinfill.insert_infill_substrings(
                text, n, k, np.random.default_rng(seed))
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for content in (text, "too short", text[:40], text * 3):
        assert tinfill.maybe_corrupt_assistant_turn(content, rt) == \
            jinfill.maybe_corrupt_assistant_turn(content, rj)
    assert tinfill.count_num_words(text) == jinfill.count_num_words(text)


@pytest.mark.parametrize("kw", [
    {}, {"max_new_tokens": 64, "steps": 32, "block_length": 32},
    {"max_new_tokens": 256, "schedule": "shift", "schedule__shift": 0.33,
     "step_ratio": 0.5, "temperature": None, "remasking": "random"},
    {"max_new_tokens": 16, "step_per_block": 4, "prefix_lm": False,
     "temperature": 0.7, "schedule": "cosine"}])
def test_gen_kwargs_to_config_as_jax(kw):
    assert tadapter.gen_kwargs_to_config(kw) == as_port_config(
        jgen_kwargs(kw))


def test_gen_kwargs_dream_is_not_ported():
    """Dream's gen_kwargs (ported since: the name is the test's history)
    give JAX's DreamGenerationConfig, field for field."""
    from lavida_mod_tpu_torch.config import DreamGenerationConfig

    for kw in ({}, {"max_new_tokens": 64, "steps": 32, "alg": "entropy"},
               {"max_new_tokens": 128, "schedule": "shift",
                "schedule__shift": 0.33, "step_ratio": 0.5,
                "temperature": 0.2, "alg_temp": 0.1, "top_p": 0.95,
                "top_k": 40, "prefix_lm": True}):
        got = tadapter.gen_kwargs_to_config(kw, "dream")
        assert type(got) is DreamGenerationConfig
        assert got == as_port_config(jgen_kwargs(kw, "dream")), kw


def test_decode_output_as_jax(tok_dirs):
    t, j = _pair(tok_dirs["split"])
    tm, jm = LaViDa(CFG, "meta"), JLaViDa(CFG, {})
    ids = t.encode("Hello world! <|im_end|> more text")
    eos = CFG.llada.eos_token_id
    im_end = t.special["<|im_end|>"]
    for row, stops in ((ids, None), (ids, [im_end]),
                       (ids[:3] + [eos] + ids[3:], None),
                       (np.asarray(ids + [eos]), [im_end, 7])):
        assert tm.decode_output(row, t, stops) == \
            jm.decode_output(row, j, stops)
    assert tm.decode_output(ids, t, [im_end]) == "Hello world!"


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(4)
    path = tmp_path_factory.mktemp("img") / "img.png"
    Image.fromarray(rng.integers(0, 255, (60, 100, 3), dtype=np.uint8)).save(
        path)
    return str(path)


GEN_KW = {"max_new_tokens": 16, "block_length": 16, "step_per_block": 8}
QUESTION = "Describe the image in detail."


def _unflatten(flat: dict) -> dict:
    """{"a/b/0/c": array} -> {"a": {"b": [{"c": array}]}}."""
    tree: dict = {}
    for key, a in flat.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}

    return lists(tree)


@pytest.fixture(scope="module")
def jax_ref(tok_dirs, image, tmp_path_factory):
    """The JAX adapter's generate_until of a tiny bf16 model in the strict
    child (its vision attention and prefill through the Pallas kernels,
    as on the TPU), with the model's params (as f32, exact) and the
    request's inputs."""
    return strict_jax(f"""
import functools
import jax, jax.numpy as jnp
from PIL import Image
from lavida_mod_tpu.config import (LaViDaConfig, VisionConfig,
                                   tiny_llada_config, tiny_siglip_config)
from lavida_mod_tpu.data.tokenizer import load_tokenizer
from lavida_mod_tpu.eval.adapter import LavidaEvalModel
from lavida_mod_tpu.models import llada as jl
from lavida_mod_tpu.models import siglip as jsg
from lavida_mod_tpu.models.lavida import LaViDa
from lavida_mod_tpu.ops.short_attention import short_attention

jsg.vision_attention = lambda q, k, v, mesh=None: short_attention(
    q, k, v, interpret=True)
LaViDa.generate_fused = functools.partialmethod(
    LaViDa.generate_fused, use_flash_prefill=True)
cfg = LaViDaConfig(
    llada=tiny_llada_config(),
    vision=VisionConfig(siglip=tiny_siglip_config(), mm_hidden_size=32,
                        grid_pinpoints=((56, 112), (112, 56), (112, 112))))
jm = LaViDa.random_init(cfg, 0, jnp.bfloat16)
jm.params["llada"] = jl.unstack_blocks(jax.tree.map(
    lambda a: a * 10.0 if a.ndim >= 2 else a, jm.params["llada"]))
for path, a in jax.tree_util.tree_leaves_with_path(jm.params):
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path)
    OUT["param/" + key] = np.asarray(a.astype(jnp.float32))
ev = LavidaEvalModel(jm, load_tokenizer({tok_dirs["small"]!r}))
img = Image.open({image!r})
text = ev.generate_until({QUESTION!r}, [img], {GEN_KW!r})
OUT["text"] = np.frombuffer(text.encode(), np.uint8)
ids, views, sizes, _ = ev._build_inputs({QUESTION!r}, [img])
OUT["ids"], OUT["views"] = ids, views[0]
""", tmp_path_factory.mktemp("strict"))


@pytest.fixture(scope="module")
def model(jax_ref):
    params = _unflatten({k[len("param/"):]: v for k, v in jax_ref.items()
                         if k.startswith("param/")})
    return LaViDa.from_jax(CFG, params, "cpu", dtype=torch.bfloat16)


def test_generate_until_text_as_jax(tok_dirs, image, model, jax_ref):
    from PIL import Image

    ev = tadapter.LavidaEvalModel(model, ttok.load_tokenizer(
        tok_dirs["small"]))
    ids, views, sizes, _ = ev._build_inputs(QUESTION, [Image.open(image)])
    np.testing.assert_array_equal(ids, jax_ref["ids"])
    np.testing.assert_array_equal(views[0], jax_ref["views"])
    text = ev.generate_until(QUESTION, [Image.open(image)], GEN_KW)
    assert text == jax_ref["text"].tobytes().decode()
    assert text and len(ev.latencies) == 1 and ev.avg_latency > 0


def test_generate_until_batch_decodes_generate_batch(tok_dirs, image,
                                                     model):
    from PIL import Image

    tm = model
    tok = ttok.load_tokenizer(tok_dirs["small"])
    ev = tadapter.LavidaEvalModel(tm, tok)
    img = Image.open(image)
    texts = ["Describe the image.", "What colors are there?",
             "Compare the two images."]
    images = [[img], [img.resize((40, 120))], [img, img.resize((50, 50))]]
    got = ev.generate_until_batch(texts, images, GEN_KW)
    requests = [ev._build_inputs(t, im) for t, im in zip(texts, images)]
    assert requests[2][3].cfg.vision.image_aspect_ratio == "pad"
    ids, _ = tadapter.generate_batch(
        tm, requests, tadapter.gen_kwargs_to_config(GEN_KW))
    assert got == [tm.decode_output(row, tok) for row in ids]
    assert len(ev.latencies) == 3
    ll = ev.loglikelihood("q", [img], "a")     # the MC estimator
    assert np.isfinite(ll) and ll < 0
    # two frames through the video route (encode_video, one block)
    out = ev.generate_until("q", [img, img], GEN_KW, video=True)
    assert isinstance(out, str) and len(ev.latencies) == 4
