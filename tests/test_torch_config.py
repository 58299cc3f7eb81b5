"""The port's own copies of the JAX package's jax-free modules
(lavida_mod_tpu_torch.config, .constants, .data) and the rule that the
port imports nothing of lavida_mod_tpu.

  - every config dataclass has the JAX one's fields and defaults, field for
    field, and so do the tiny fixtures; `as_port_config` maps a JAX config
    onto the port's by field name;
  - the constants, `anyres_grid_shape` and `unpad_slice` agree on a sweep
    of sizes;
  - the whole port (and chip_smoke.py's imports) loads in a child process
    where `jax` and `lavida_mod_tpu` cannot be imported;
  - no module of lavida_mod_tpu_torch, and not chip_smoke.py, has an import
    of lavida_mod_tpu or jax in its syntax tree.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest

import lavida_mod_tpu.config as jc
import lavida_mod_tpu.constants as jconst
from lavida_mod_tpu.data import anyres as janyres
from lavida_mod_tpu_torch import config as tc
from lavida_mod_tpu_torch import constants as tconst
from lavida_mod_tpu_torch.data import anyres as tanyres

REPO = pathlib.Path(__file__).resolve().parents[1]
CLASSES = ["LLaDAConfig", "SigLIPConfig", "VisionConfig", "LaViDaConfig",
           "GenerationConfig", "DreamGenerationConfig"]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _flat(obj):
    """Field values with nested configs flattened to their fields."""
    return {k: (_flat(v) if dataclasses.is_dataclass(v) else v)
            for k, v in _fields(obj).items()}


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_defaults_equal_jax(name):
    jcls, tcls = getattr(jc, name), getattr(tc, name)
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    assert _flat(tcls()) == _flat(jcls())
    assert dataclasses.is_dataclass(tcls) and tcls.__dataclass_params__.frozen


@pytest.mark.parametrize("fn,kw", [
    ("tiny_llada_config", {}),
    ("tiny_llada_config", dict(d_model=512, n_heads=4, n_kv_heads=4,
                               mlp_hidden_size=1024)),
    ("tiny_siglip_config", {}),
    ("tiny_siglip_config", dict(hidden_size=128, intermediate_size=200)),
])
def test_tiny_configs_equal_jax(fn, kw):
    assert _flat(getattr(tc, fn)(**kw)) == _flat(getattr(jc, fn)(**kw))


def test_properties_and_pinpoints_equal_jax():
    assert tc.DEFAULT_GRID_PINPOINTS == jc.DEFAULT_GRID_PINPOINTS
    for t, j in ((tc.LLaDAConfig(), jc.LLaDAConfig()),
                 (tc.tiny_llada_config(), jc.tiny_llada_config())):
        for p in ("effective_n_kv_heads", "head_dim", "hidden_size",
                  "num_embeddings"):
            assert getattr(t, p) == getattr(j, p)
    t, j = tc.SigLIPConfig(), jc.SigLIPConfig()
    for p in ("n_layers_used", "num_patches_per_side", "num_patches",
              "head_dim"):
        assert getattr(t, p) == getattr(j, p)


def test_as_port_config_maps_jax_configs():
    j = jc.LaViDaConfig(llada=jc.tiny_llada_config(block_type="sequential"),
                        vision=jc.VisionConfig(siglip=jc.tiny_siglip_config()),
                        tokenizer_model_max_length=77)
    t = tc.as_port_config(j)
    assert type(t) is tc.LaViDaConfig and type(t.llada) is tc.LLaDAConfig
    assert type(t.vision.siglip) is tc.SigLIPConfig
    assert _flat(t) == _flat(j)
    assert tc.as_port_config(t) is t and tc.as_port_config(None) is None
    g = tc.as_port_config(jc.GenerationConfig(max_new_tokens=7))
    assert type(g) is tc.GenerationConfig and g.max_new_tokens == 7
    d = tc.as_port_config(jc.DreamGenerationConfig(alg="topk_margin",
                                                   top_k=5))
    assert type(d) is tc.DreamGenerationConfig
    assert _flat(d) == _flat(jc.DreamGenerationConfig(alg="topk_margin",
                                                      top_k=5))
    unknown = dataclasses.make_dataclass("TrainConfig", [("lr", float)])
    with pytest.raises(TypeError):
        tc.as_port_config(unknown(1e-3))


def test_constants_equal_jax():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names and all(getattr(tconst, n) == getattr(jconst, n)
                         for n in names)


def test_anyres_geometry_equals_jax():
    pins = [jc.DEFAULT_GRID_PINPOINTS, ((56, 112), (112, 56), (112, 112))]
    sizes = [(w, h) for w in (40, 100, 383, 640, 800, 1024, 1100, 448)
             for h in (40, 60, 380, 512, 600, 640, 896)]
    for p, patch in zip(pins, (384, 56)):
        for s in sizes:
            assert tanyres.select_best_resolution(s, p) == \
                janyres.select_best_resolution(s, p)
            assert tanyres.anyres_grid_shape(s, p, patch) == \
                janyres.anyres_grid_shape(s, p, patch)
            assert tanyres.fit_within(s, (768, 384)) == \
                janyres.fit_within(s, (768, 384))
            for hw in ((28, 56), (56, 28), (42, 42), (14, 14)):
                assert tanyres.unpad_slice(s, hw) == janyres.unpad_slice(s, hw)


# packages the port imports only inside the functions that use them: no
# module of the port, nor chip_smoke, needs one to import
OPTIONAL = ("safetensors", "tokenizers", "transformers", "jinja2", "PIL",
            "ml_dtypes", "regex")


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lavida_mod_tpu'] = None\n"
        f"for m in {OPTIONAL!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, lavida_mod_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'lavida_mod_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 25


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_package_import_in_the_port():
    files = sorted((REPO / "lavida_mod_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 25
    bad = [(f.relative_to(REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("lavida_mod_tpu", "jax", "jaxlib")]
    assert not bad, bad


def test_import_scans_cover_the_training_slice():
    """The two scans above walk the whole package: the training slice's
    modules are among the files and the walked module names."""
    files = {f.relative_to(REPO).as_posix()
             for f in (REPO / "lavida_mod_tpu_torch").rglob("*.py")}
    assert {"lavida_mod_tpu_torch/train/__init__.py",
            "lavida_mod_tpu_torch/train/loss.py",
            "lavida_mod_tpu_torch/train/step.py",
            "lavida_mod_tpu_torch/ops/prefix_flash.py"} <= files
    import pkgutil

    import lavida_mod_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(
        p.__path__, "lavida_mod_tpu_torch.")}
    assert {"lavida_mod_tpu_torch.train.loss",
            "lavida_mod_tpu_torch.train.step"} <= names


CHECKPOINT_AND_TEXT = (
    "tools/__init__.py", "tools/safetensors_io.py", "tools/weights.py",
    "models/llada_loader.py", "data/tokenizer.py", "data/conversation.py",
    "data/prompts.py", "data/infill.py", "rehearse_8b_load.py")


def test_import_scans_cover_the_checkpoint_and_text_slice():
    """The scans above walk the checkpoint and text slice's modules too."""
    files = {f.relative_to(REPO / "lavida_mod_tpu_torch").as_posix()
             for f in (REPO / "lavida_mod_tpu_torch").rglob("*.py")}
    assert set(CHECKPOINT_AND_TEXT) <= files
    import pkgutil

    import lavida_mod_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(
        p.__path__, "lavida_mod_tpu_torch.")}
    assert {"lavida_mod_tpu_torch." + f[:-3].replace("/", ".")
            for f in CHECKPOINT_AND_TEXT
            if not f.endswith("__init__.py")} <= names


def test_checkpoint_and_text_path_runs_without_the_optional_packages(
        tmp_path):
    """Write a small reference-layout checkpoint and its tokenizer with
    the port's own code, load it, tokenize, generate and decode, with
    every optional package and jax blocked: the path chip_smoke drives
    needs none of them."""
    code = (
        "import sys\n"
        f"for m in {OPTIONAL + ('jax', 'lavida_mod_tpu')!r}:\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from lavida_mod_tpu_torch.config import tiny_llada_config\n"
        "from lavida_mod_tpu_torch.predict import tiny_config\n"
        "from lavida_mod_tpu_torch import rehearse_8b_load as r\n"
        "cfg = tiny_config().replace(llada=tiny_llada_config(\n"
        "    vocab_size=126464, embedding_size=126464,\n"
        "    mask_token_id=126336, eos_token_id=126081,\n"
        "    pad_token_id=126081))\n"
        f"out = r.rehearse(torch, 'cpu', {str(tmp_path / 'ckpt')!r},\n"
        "                  log=lambda s: None, cfg=cfg)\n"
        "print(out['prompt_ids'], len(out['tokens']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["49", "32"]
    assert not (tmp_path / "ckpt").exists()


TRAINING_CLI = (
    "train/cli.py", "train/__main__.py", "utils/__init__.py",
    "utils/checkpoint.py", "utils/logging.py", "utils/profiling.py",
    "data/preprocess.py", "data/dataset.py", "data/native.py",
    "tools/make_synthetic_data.py")


def test_import_scans_cover_the_training_cli_slice():
    """The scans above walk the training CLI's modules too."""
    files = {f.relative_to(REPO / "lavida_mod_tpu_torch").as_posix()
             for f in (REPO / "lavida_mod_tpu_torch").rglob("*.py")}
    assert set(TRAINING_CLI) <= files
    import pkgutil

    import lavida_mod_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(
        p.__path__, "lavida_mod_tpu_torch.")}
    assert {"lavida_mod_tpu_torch." + f[:-3].replace("/", ".")
            for f in TRAINING_CLI
            if not f.endswith("__init__.py")} <= names
