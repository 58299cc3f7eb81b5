"""Q-Former resampler, BLIP-2's BERT with cross-attention, ported from
lavida_mod_tpu/models/qformer.py (reference multimodal_resampler/
qformer.py, configured at :1102-1133).

  - bert-base geometry (`QformerConfig`: hidden 768, 12 layers, 12 heads,
    intermediate 3072, post-LN, eps 1e-12), no word or position
    embeddings: the input is the learned query bank [num_query_tokens,
    768] through the embeddings' LayerNorm;
  - the image features through `ln_vision` (eps 1e-5);
  - every layer: self-attention over the queries, cross-attention to the
    features in the layers with layer % cross_attention_freq == 0, then
    the query FFN (intermediate_query / output_query), each a post-LN
    residual (`_attention`, :89; `apply`, :103-122).

Its attention is plain XLA in the JAX package (scores in f32, the
softmax's probabilities cast to v's dtype), so plain torch ops are its
port.  So is its layer norm, which computes in the input's dtype
(`_ln`, :46-49).  `convert_qformer_state_dict` (:125) reads the torch
module's names.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import QformerConfig, as_port_config
from ..ops.activations import gelu_erf
from ..ops.linear import linear
from .clip import init_tower, load_named


def _ln(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * weight + bias


class QLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ln(x, self.weight, self.bias, self.eps)


class QAttention(nn.Module):
    """BertAttention (self or cross) with its post-LN BertSelfOutput."""

    def __init__(self, D: int, kv_width: int, eps: float, device,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(D, D, **kw)
        self.k = nn.Linear(kv_width, D, **kw)
        self.v = nn.Linear(kv_width, D, **kw)
        self.out = nn.Linear(D, D, **kw)
        self.ln = QLayerNorm(D, eps, **kw)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                nh: int) -> torch.Tensor:
        B, Tq, D = x_q.shape
        S, hd = x_kv.shape[1], D // nh
        q = linear(x_q, self.q).view(B, Tq, nh, hd).transpose(1, 2)
        k = linear(x_kv, self.k).view(B, S, nh, hd).transpose(1, 2)
        v = linear(x_kv, self.v).view(B, S, nh, hd).transpose(1, 2)
        scores = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(hd)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = (probs @ v).transpose(1, 2).reshape(B, Tq, D)
        return self.ln(linear(ctx, self.out) + x_q)


class QformerLayer(nn.Module):
    def __init__(self, cfg: QformerConfig, cross: bool, device, dtype=None):
        super().__init__()
        D, I, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.self_attn = QAttention(D, D, eps, **kw)
        self.cross_attn = (QAttention(D, cfg.encoder_width, eps, **kw)
                           if cross else None)
        self.fc1 = nn.Linear(D, I, **kw)
        self.fc2 = nn.Linear(I, D, **kw)
        self.ffn_ln = QLayerNorm(D, eps, **kw)


class Qformer(nn.Module):
    def __init__(self, cfg: QformerConfig, device, dtype=None):
        super().__init__()
        cfg = as_port_config(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        D, W = cfg.hidden_size, cfg.encoder_width
        self.query_tokens = nn.Parameter(torch.zeros(cfg.num_query_tokens,
                                                     D, **kw))
        self.emb_ln = QLayerNorm(D, cfg.layer_norm_eps, **kw)
        self.ln_vision = QLayerNorm(W, 1e-5, **kw)
        self.layers = nn.ModuleList(
            QformerLayer(cfg, li % cfg.cross_attention_freq == 0, **kw)
            for li in range(cfg.num_hidden_layers))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "Qformer":
        """Seeded weights as qformer.init_params draws them: N(0, 0.02)
        linears and query bank, zero biases, norms at one."""
        init_tower(self, generator, norm_types=(QLayerNorm,))
        return self

    def forward(self, image_features: torch.Tensor) -> torch.Tensor:
        """[B, N, W] image features -> [B, num_query_tokens, hidden]."""
        nh = self.cfg.num_attention_heads
        feats = self.ln_vision(image_features)
        x = self.query_tokens[None].expand(feats.shape[0], -1, -1)
        x = self.emb_ln(x)
        for layer in self.layers:
            x = layer.self_attn(x, x, nh)
            if layer.cross_attn is not None:
                x = layer.cross_attn(x, feats, nh)
            z = gelu_erf(linear(x, layer.fc1))
            x = layer.ffn_ln(linear(z, layer.fc2) + x)
        return x


def convert_qformer_state_dict(state: dict, cfg: QformerConfig,
                               dtype=torch.float32,
                               device="cuda") -> Qformer:
    """The torch Qformer module's state dict -> the port's module
    (qformer.py:125-171)."""
    cfg = as_port_config(cfg)
    model = Qformer(cfg, device, dtype)

    def g(name):
        return torch.as_tensor(np.asarray(state[name]))

    named = {"query_tokens": g("query_tokens")[0]}
    for ours, theirs in (("emb_ln", "Qformer.bert.embeddings.LayerNorm"),
                         ("ln_vision", "ln_vision")):
        for leaf in ("weight", "bias"):
            named[f"{ours}.{leaf}"] = g(f"{theirs}.{leaf}")
    for li, layer in enumerate(model.layers):
        b = f"Qformer.bert.encoder.layer.{li}"
        names = {"self_attn.q": "attention.self.query",
                 "self_attn.k": "attention.self.key",
                 "self_attn.v": "attention.self.value",
                 "self_attn.out": "attention.output.dense",
                 "self_attn.ln": "attention.output.LayerNorm",
                 "fc1": "intermediate_query.dense",
                 "fc2": "output_query.dense",
                 "ffn_ln": "output_query.LayerNorm"}
        if layer.cross_attn is not None:
            names.update({"cross_attn.q": "crossattention.self.query",
                          "cross_attn.k": "crossattention.self.key",
                          "cross_attn.v": "crossattention.self.value",
                          "cross_attn.out": "crossattention.output.dense",
                          "cross_attn.ln":
                              "crossattention.output.LayerNorm"})
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                named[f"layers.{li}.{ours}.{leaf}"] = g(
                    f"{b}.{theirs}.{leaf}")
    load_named(model, named, "qformer")
    return model.eval()

