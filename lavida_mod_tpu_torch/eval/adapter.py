"""The eval-model adapter of lavida_mod_tpu/eval/adapter.py:
`gen_kwargs_to_config`, `LavidaEvalModel` and the batched
`generate_batch`.

`LavidaEvalModel` (adapter.py:63) builds each request's prompt from the
conversation template and the tokenizer (`_build_inputs`: "<image>\n"
per image, the template's own chat template where the tokenizer has one,
`tokenizer_image_token`; several images switch the model's view to the
"pad" aspect mode, adapter.py:102-129), preprocesses the PIL images, and
answers in text: `generate_until` through `LaViDa.generate_fused` (the
prefix-cache mode) or `LaViDa.generate` (gen_kwargs {"prefix_lm": false},
the no-cache mode, and a LaViDa-Dream model's requests:
`gen_kwargs_to_config(.., "dream")` gives a `DreamGenerationConfig`,
which `generate` runs through the Dream sampler, adapter.py:131-160),
`generate_until_batch` through `generate_batch` (the LLaDA sampler only;
without the cache at any B, unchunked, and refused in the mixed layout,
adapter.py:269-277), each cut and decoded by `decode_output`, the latency
of each request kept for `avg_latency`.  `loglikelihood` scores a
continuation (truncated to 300 tokens) with the MC estimator
(generation/log_likelihood.py, `mc_num` 16) over the prompt's prefix, in
the mixed layout on the int8 prefill tree, weight-only unless
`loglik_act_int8` (adapter.py:202-223); it raises for Dream as the JAX
adapter does (its AR-shifted head has no MC estimator).  A video request
(`generate_until(video=True)`, the eval's is_video documents) goes through
`_generate_video` (adapter.py:165-199): the frames behind ONE <image>
placeholder, each a square view in the "pad" aspect mode, encoded by
`multimodal.encode_video` (per-frame encode and pool, flattened, one
newline row) and spliced as one block by `LaViDa.generate(image_features=
[block])`.

The serve worker (serve/worker.py) answers its requests through this
class: one request through `generate_until`, a merged batch through
`generate_until_batch`.  `kv8` takes the JAX package's values: False,
True (the int8 KV cache, `--kv8`) or 4 (the int4 one, `--kv4`).

`generate_batch` (adapter.py:245-318) is the path of the serve worker's
`--decode-batch N` and of bench.py's throughput mode.  It takes requests
already tokenized (ids with -200 image markers) and preprocessed (one
[V, C, S, S] view stack per image).  Per request it runs
`LaViDa.encode_prompt` (one
vision encode per image, the fused ViT-MLP kernel by the model's policy);
the prefixes are front-padded to a common multiple of the bucket with a
`valid` mask, then one generation serves the batch:
  - B > 4: `generate_chunked_prefill` with chunk 2 (adapter.py:284-302);
  - else `diffusion.generate`, in the mixed layout with the int8 tree
    prefilling (adapter.py:303-318).
The prefill attention is the short-attention kernel throughout (the JAX
adapter's use_flash_prefill on the TPU).
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DreamGenerationConfig, GenerationConfig, as_port_config
from ..data import SigLIPImageProcessor, process_images
from ..data.conversation import get_conv_template
from ..data.prompts import tokenizer_image_token
from ..generation import diffusion
from ..generation.log_likelihood import get_log_likelihood
from ..models import multimodal
from ..utils.profiling import span


def gen_kwargs_to_config(gen_kwargs: dict, lm_family: str = "llada"):
    """lmms-eval gen_kwargs -> GenerationConfig, or DreamGenerationConfig
    for lm_family "dream" (adapter.py:26-61): the `schedule__*` keys
    become schedule kwargs (llava_llada.py:598-604); block_length
    defaults to min(128, max_new_tokens) (:606); Dream's steps default
    to 512 and its alg to topk_margin."""
    kw = dict(gen_kwargs)
    schedule_kwargs = {k[len("schedule__"):]: kw.pop(k)
                       for k in list(kw) if k.startswith("schedule__")}
    max_new = int(kw.pop("max_new_tokens", 32))
    common = dict(
        max_new_tokens=max_new,
        schedule=kw.pop("schedule", None),
        schedule_shift=float(schedule_kwargs.get("shift", 3.0)),
        step_ratio=kw.pop("step_ratio", None),
        prefix_lm=bool(kw.pop("prefix_lm", True)),
        temperature=float(kw.pop("temperature", 0.0) or 0.0))
    if lm_family == "dream":
        return DreamGenerationConfig(
            steps=int(kw.pop("steps", 512)),
            alg=kw.pop("alg", "topk_margin"),
            alg_temp=kw.pop("alg_temp", None),
            top_p=kw.pop("top_p", None),
            top_k=kw.pop("top_k", None),
            **common)
    return GenerationConfig(
        block_length=int(kw.pop("block_length", min(128, max_new))),
        steps=kw.pop("steps", None),
        step_per_block=kw.pop("step_per_block", None),
        remasking=kw.pop("remasking", "low_confidence"),
        **common)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate_batch(
    model,
    requests: Sequence[tuple],
    gen: Optional[GenerationConfig] = None,
    *,
    prefix_bucket: Optional[int] = 128,
    kv8: bool | int = False,
    generator: Optional[torch.Generator] = None,
) -> tuple[np.ndarray, dict]:
    """requests: (input_ids, [views per image], [(width, height) per
    image]) each, and optionally a fourth item, the view of `model` that
    encodes the request (`LavidaEvalModel`'s "pad" mode for several
    images).  kv8: False, True (the int8 KV cache) or 4 (the int4 one).
    Returns (ids [B, G], walls {"encode": s, "generate": s}); the walls end
    in a device synchronize."""
    gen = as_port_config(gen) or GenerationConfig()
    device = model.device
    with span("serve.batch"):
        t0 = time.perf_counter()
        prefixes = [(r[3] if len(r) > 3 else model).encode_prompt(
            *r[:3], row=b)[0] for b, r in enumerate(requests)]
        with span("serve.sync"):
            _sync(device)
        t_enc = time.perf_counter()
        with span("serve.pack"):
            bucket = prefix_bucket or 128
            Pb = max(-(-p.shape[0] // bucket) * bucket for p in prefixes)
            B, D = len(prefixes), prefixes[0].shape[-1]
            batch = prefixes[0].new_zeros(B, Pb, D)
            valid = torch.zeros(B, Pb, dtype=torch.bool, device=device)
            for b, p in enumerate(prefixes):
                batch[b, Pb - p.shape[0]:] = p          # front-pad (masked)
                valid[b, Pb - p.shape[0]:] = True
        del prefixes
        if model.mixed and not gen.prefix_lm:
            raise NotImplementedError(
                "mixed decode_params needs the prefix-cache mode "
                "(prefix_lm=True) — the no-cache path has no "
                "prefill/decode split; drop --mixed or prefix_lm=False")
        kw = dict(prefix_valid=valid, generator=generator,
                  act_int8_prefill=model.mixed, kv8=kv8)
        if B > 4 and gen.prefix_lm:
            out = diffusion.generate_chunked_prefill(model.llada, batch, gen,
                                                     chunk=2, **kw)
        else:
            out = diffusion.generate(model.llada, batch, gen, **kw)
        with span("serve.readback"):
            out = out.cpu().numpy()
        t_gen = time.perf_counter()
    return out, {"encode": t_enc - t0, "generate": t_gen - t_enc}


class LavidaEvalModel:
    """generate_until over (text, images) requests, in text."""

    def __init__(self, model, tokenizer, conv_template: str = "llada",
                 prefix_bucket: Optional[int] = 128,
                 kv8: bool | int = False, mc_num: int = 16,
                 loglik_act_int8: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.conv_template = conv_template
        # the MC estimator's samples per continuation, and its opt-in
        # int8 activations (an activation-quantization error can flip a
        # close multiple-choice ranking, so weight-only is the default)
        self.mc_num = mc_num
        self.loglik_act_int8 = loglik_act_int8
        # pad prompt lengths to buckets (the JAX adapter's compile reuse;
        # the port's tokens do not depend on it)
        self.prefix_bucket = prefix_bucket
        self.kv8 = kv8
        self.processor = SigLIPImageProcessor(
            size=model.cfg.vision.siglip.image_size)
        self.latencies: list[float] = []

    def _build_inputs(self, text: str, images: Sequence):
        conv = get_conv_template(self.conv_template)
        if getattr(self.tokenizer, "chat_template", None):
            conv.tokenizer = self.tokenizer
        msg = ("<image>\n" * len(images)) + text if images else text
        conv.append_message(conv.roles[0], msg)
        input_ids = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
        model = self.model
        if len(images) > 1:
            # several images use the "pad" aspect mode (llava_llada.py,
            # llava_dream.py:289): a view of the same weights under that
            # config, for the preprocessing and the encode alike
            model = copy.copy(self.model)
            model.cfg = model.cfg.replace(vision=model.cfg.vision.replace(
                image_aspect_ratio="pad"))
        views = process_images(list(images), self.processor,
                               model.cfg.vision)
        return input_ids, views, [im.size for im in images], model

    def _stop_ids(self):
        return get_conv_template(self.conv_template).stop_token_ids

    def generate_until(self, text: str, images: Sequence,
                       gen_kwargs: Optional[dict] = None,
                       video: bool = False) -> str:
        gen = gen_kwargs_to_config(gen_kwargs or {}, self.model.lm_family)
        if video and images:
            return self._generate_video(text, images, gen)
        dream = isinstance(gen, DreamGenerationConfig)
        input_ids, views, sizes, model = self._build_inputs(text, images)
        t0 = time.perf_counter()
        if not dream and gen.prefix_lm:
            out = model.generate_fused(input_ids, views, sizes, gen,
                                       prefix_bucket=self.prefix_bucket,
                                       kv8=self.kv8)
        else:
            # the Dream sampler takes no prefix bucket (lavida.py:500-503)
            out = model.generate(
                input_ids, views, sizes, gen,
                prefix_bucket=None if dream else self.prefix_bucket)
        self.latencies.append(time.perf_counter() - t0)
        return model.decode_output(out, self.tokenizer, self._stop_ids())

    def video_inputs(self, text: str, frames: Sequence):
        """A video request's prompt ids (one <image> placeholder) and its
        frames as square views [F, C, S, S] (the "pad" mode: no anyres
        tiling per frame)."""
        conv = get_conv_template(self.conv_template)
        if getattr(self.tokenizer, "chat_template", None):
            conv.tokenizer = self.tokenizer
        conv.append_message(conv.roles[0], "<image>\n" + text)
        input_ids = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
        pad_cfg = self.model.cfg.vision.replace(image_aspect_ratio="pad")
        views = np.concatenate(
            process_images(list(frames), self.processor, pad_cfg), axis=0)
        return input_ids, views

    @torch.no_grad()
    def _generate_video(self, text: str, frames: Sequence, gen) -> str:
        """Video request: all frames behind ONE <image> placeholder,
        encoded by the video path (per-frame encode + 2x2 pool, frames
        flattened, one newline token -- multimodal.encode_video,
        llava_arch.py:600-610).  The reference eval model does the same
        for "video" modality visuals (llava_llada.py:327-345) instead of
        the multi-image pad mode.  The latency counts the generation, not
        the encode (as adapter.py:190-198)."""
        input_ids, views = self.video_inputs(text, frames)
        block = multimodal.encode_video(
            self.model, torch.as_tensor(views, device=self.model.device))
        t0 = time.perf_counter()
        out = self.model.generate(
            input_ids, gen=gen, image_features=[block],
            prefix_bucket=(self.prefix_bucket
                           if not isinstance(gen, DreamGenerationConfig)
                           else None),
            kv8=self.kv8)
        self.latencies.append(time.perf_counter() - t0)
        return self.model.decode_output(out, self.tokenizer,
                                        self._stop_ids())

    def loglikelihood(self, text: str, images: Sequence,
                      continuation: str) -> float:
        if self.model.lm_family == "dream":
            # Dream's AR-shifted head has no MC estimator (llava_dream.py:
            # 366-376 raises); the LLaDA one would mis-score its logits
            raise NotImplementedError(
                "loglikelihood is not supported for the Dream backbone")
        input_ids, views, sizes, model = self._build_inputs(text, images)
        prefix = model.encode_prompt(input_ids, views, sizes)
        ans = np.asarray(self.tokenizer(continuation).input_ids[:300])
        # mc_num full bidirectional forwards: prefill-shaped work, so the
        # mixed layout scores on its int8 prefill tree (adapter.py:215-223)
        return get_log_likelihood(
            self.model.llada, prefix, ans, mc_num=self.mc_num,
            act_int8=self.loglik_act_int8, prefill_tree=self.model.mixed)

    def generate_until_batch(self, texts: Sequence[str],
                             images_list: Sequence[Sequence],
                             gen_kwargs: Optional[dict] = None) -> list[str]:
        """The requests in one batch (`generate_batch`), each answer
        decoded; every request is charged the batch's wall / B."""
        gen = gen_kwargs_to_config(gen_kwargs or {}, self.model.lm_family)
        if isinstance(gen, DreamGenerationConfig):
            raise NotImplementedError("the batched path implements the "
                                      "LLaDA sampler (adapter.py:242)")
        t0 = time.perf_counter()
        requests = []
        for text, images in zip(texts, images_list):
            requests.append(self._build_inputs(text, images))
        out, _ = generate_batch(self.model, requests, gen,
                                prefix_bucket=self.prefix_bucket,
                                kv8=self.kv8)
        res = [self.model.decode_output(row, self.tokenizer) for row in out]
        dt = time.perf_counter() - t0
        self.latencies.extend([dt / len(res)] * len(res))
        return res

    @property
    def avg_latency(self) -> float:
        return float(np.mean(self.latencies)) if self.latencies else 0.0
