"""The plain float32 reference of LaViDa: the SigLIP so400m tower, the
mlp2x_gelu projector, the 2x2 bilinear pool, the anyres "spatial_unpad"
merge with its newline rows, the splice at the image marker, and the
masked-diffusion LM of either family (LLaDA-8B, or Dream-7B with its QKV
bias and grouped KV heads), written from the published descriptions
(LLaVA-NeXT's llava_arch.py and mm_utils.py, LLaDA's modeling_llada.py,
Qwen2's attention for Dream) in plain torch operations.

It imports nothing of the program and takes nothing the program made: the
weights come from `W(name)`, the harness's seeded leaves by name (the
same values the program was given), and every derived form of them (the
int4 codes and scales of the serving layout, the fp8 control's scales) is
worked out here again.

`precision` of the LM's products:
  - "f32": plain float32 (the training reference);
  - "w4a8": the serving layout's arithmetic, grouped int4 weights (group
    128 along K, scale amax / 7, codes in [-7, 7]) and per-row int8
    activations (scale amax / 127), every product in float32;
  - "w4a4": the serving control, the same with per-row int4 activations;
  - "fp8": the training control, weights and activations of every linear
    (tower, projector, LM, head) rounded to float8 e4m3 with one scale
    per tensor (amax / 448).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_TOKEN = -200
GROUP = 128

Weights = Callable[[str], torch.Tensor]


def exact_f32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# precisions
# ---------------------------------------------------------------------------

def w4_dequant(w: torch.Tensor) -> torch.Tensor:
    """[N, K] float -> its grouped int4 values in float32 (K zero-padded to
    the group)."""
    N, K = w.shape
    Kp = -(-K // GROUP) * GROUP
    wg = F.pad(w.float(), (0, Kp - K)).reshape(N, Kp // GROUP, GROUP)
    scale = torch.clamp_min(wg.abs().amax(dim=-1, keepdim=True) / 7.0, 1e-8)
    codes = torch.clamp(torch.round(wg / scale), -7, 7)
    return (codes * scale).reshape(N, Kp)[:, :K]


def act_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-row symmetric fake quantization of x [..., K] to `bits`."""
    qmax = 2 ** (bits - 1) - 1
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8) / qmax
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the tensor; the
    gradient passes the rounding unchanged (fp8 training's convention)."""
    s = torch.clamp_min(t.detach().abs().amax(), 1e-12) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t.detach())


class Linear:
    """y = act(x) @ w^T + b with the weight prepared once for `mode`
    ("f32", "w4a8", "w4a4", "fp8")."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor],
                 mode: str = "f32"):
        w = w.float()
        if mode in ("w4a8", "w4a4"):
            w = w4_dequant(w)
        elif mode == "fp8":
            w = fp8(w)
        self.w, self.mode = w, mode
        self.b = None if b is None else b.float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "w4a8":
            x = act_rows(x, 8)
        elif self.mode == "w4a4":
            x = act_rows(x, 4)
        elif self.mode == "fp8":
            x = fp8(x)
        y = x @ self.w.t()
        return y if self.b is None else y + self.b


def linear(W: Weights, name: str, mode: str = "f32",
           bias: bool = True) -> Linear:
    return Linear(W(f"{name}.weight"), W(f"{name}.bias") if bias else None,
                  mode)


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of x [B, T, H, hd] at positions [T], the half
    rotation of LLaMA / LLaDA / Qwen2, in float32."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = positions.float()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def attend(q, k, v, allowed: Optional[torch.Tensor] = None):
    """Softmax attention of q [B, T, H, hd] over k, v [B, S, Hkv, hd]
    (each KV head shared by H / Hkv query heads); allowed [B, T, S] bool."""
    H, Hkv = q.shape[2], k.shape[2]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    if allowed is not None:
        s = s.masked_fill(~allowed[:, None], float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


# ---------------------------------------------------------------------------
# vision: tower, projector, pool, anyres merge
# ---------------------------------------------------------------------------

class Vision:
    """SigLIP (pre-LN ViT, no CLS token, learned positions, the last layer
    dropped, no post-layernorm), then the projector [Linear, exact GELU,
    Linear], then the bilinear pool to ceil(g / 2) a side."""

    def __init__(self, W: Weights, vcfg: dict, mode: str = "f32"):
        self.cfg = vcfg
        self.patch_w = W("siglip.patch_embed.weight").float()
        self.patch_b = W("siglip.patch_embed.bias").float()
        self.pos = W("siglip.pos_embed").float()
        self.layers = []
        for i in range(vcfg["num_hidden_layers"] - 1):
            p = f"siglip.layers.{i}"
            self.layers.append({
                "ln1": (W(f"{p}.ln1.weight").float(),
                        W(f"{p}.ln1.bias").float()),
                "ln2": (W(f"{p}.ln2.weight").float(),
                        W(f"{p}.ln2.bias").float()),
                **{n: linear(W, f"{p}.{n}", mode)
                   for n in ("q_proj", "k_proj", "v_proj", "out_proj",
                             "fc1", "fc2")}})
        self.proj = [linear(W, "projector.layers.0", mode),
                     linear(W, "projector.layers.1", mode)]
        self.mode = mode

    def tower(self, pix: torch.Tensor) -> torch.Tensor:
        """[V, 3, S, S] -> [V, g * g, width]."""
        c = self.cfg
        P, D = c["patch_size"], c["hidden_size"]
        w = self.patch_w.reshape(D, c["num_channels"], P, P)
        pix = pix.float()
        if self.mode == "fp8":
            w, pix = fp8(w), fp8(pix)
        x = F.conv2d(pix, w, self.patch_b, stride=P)
        x = x.flatten(2).transpose(1, 2) + self.pos[None]
        H = c["num_attention_heads"]
        eps = c["layer_norm_eps"]
        V, T, _ = x.shape
        for L in self.layers:
            z = layer_norm(x, *L["ln1"], eps)
            q, k, v = (L[n](z).view(V, T, H, -1)
                       for n in ("q_proj", "k_proj", "v_proj"))
            x = x + L["out_proj"](attend(q, k, v).reshape(V, T, D))
            x = x + L["fc2"](gelu_tanh(L["fc1"](layer_norm(x, *L["ln2"],
                                                           eps))))
        return x

    def project(self, feats: torch.Tensor) -> torch.Tensor:
        return self.proj[1](F.gelu(self.proj[0](feats)))

    def pool(self, feats: torch.Tensor) -> torch.Tensor:
        V, T, D = feats.shape
        g = int(round(math.sqrt(T)))
        grid = feats.transpose(1, 2).reshape(V, D, g, g)
        go = -(-g // 2)
        out = F.interpolate(grid, size=(go, go), mode="bilinear",
                            align_corners=False, antialias=False)
        return out.reshape(V, D, go * go).transpose(1, 2)

    def features(self, pix: torch.Tensor) -> torch.Tensor:
        """Pooled projected features [V, g'^2, D_lm]."""
        return self.pool(self.project(self.tower(pix)))


def best_resolution(size, pinpoints):
    """LLaVA's select_best_resolution: the pinpoint that keeps the most of
    the image at the least waste; sizes (width, height)."""
    ow, oh = size
    best, best_eff, best_waste = None, 0, float("inf")
    for w, h in pinpoints:
        s = min(w / ow, h / oh)
        eff = min(int(ow * s) * int(oh * s), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def tile_grid(size, pinpoints, tile: int) -> tuple[int, int]:
    """(tiles across, tiles down) of an image of `size` = (w, h)."""
    w, h = best_resolution(size, pinpoints)
    return w // tile, h // tile


def unpad(grid: torch.Tensor, size) -> torch.Tensor:
    """LLaVA's unpad_image on a [H, W, D] feature grid: cut the letterbox
    that the resize to the tile canvas left, by the original (w, h)."""
    ow, oh = size
    H, W = grid.shape[:2]
    if ow / oh > W / H:
        nh = int(oh * (W / ow))
        pad = (H - nh) // 2
        return grid[pad:H - pad]
    nw = int(ow * (H / oh))
    pad = (W - nw) // 2
    return grid[:, pad:W - pad]


def merge_image(feats: torch.Tensor, size, vcfg: dict,
                newline: torch.Tensor) -> torch.Tensor:
    """One image's pooled views [V, g'^2, D] -> its token block: the base
    view's tokens, then the unpadded tile grid row by row, each row closed
    by the newline row."""
    V, T, D = feats.shape
    g = int(round(math.sqrt(T)))
    nw, nh = tile_grid(size, vcfg["grid_pinpoints"], vcfg["image_size"])
    if nw * nh != V - 1:
        raise ValueError(f"{V} views for a {nw} x {nh} grid")
    grid = feats[1:].reshape(nh, nw, g, g, D).permute(0, 2, 1, 3, 4)
    grid = unpad(grid.reshape(nh * g, nw * g, D), size)
    rows = torch.cat([grid, newline.expand(grid.shape[0], 1, D)], dim=1)
    return torch.cat([feats[0], rows.reshape(-1, D)])


def splice(ids: Sequence[int], blocks: Sequence[torch.Tensor],
           wte: torch.Tensor) -> torch.Tensor:
    """Token ids with IMAGE_TOKEN markers -> embeddings [n, D], each
    marker replaced by the next image's block."""
    out, it = [], iter(blocks)
    ids = np.asarray(ids)
    start = 0
    for i in np.flatnonzero(ids == IMAGE_TOKEN).tolist() + [len(ids)]:
        if i > start:
            out.append(wte[torch.as_tensor(ids[start:i], dtype=torch.long,
                                           device=wte.device)].float())
        if i < len(ids):
            out.append(next(it))
        start = i + 1
    return torch.cat(out)


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------

def lm_geometry(family: str, lm: dict) -> dict:
    """The published config's sizes under one set of names."""
    if family == "llada":
        return dict(D=lm["d_model"], H=lm["n_heads"],
                    Hkv=lm.get("n_kv_heads") or lm["n_heads"],
                    L=lm["n_layers"], F=lm["mlp_hidden_size"],
                    V=lm.get("embedding_size") or lm["vocab_size"],
                    theta=lm["rope_theta"], eps=lm["rms_norm_eps"],
                    qkv_bias=bool(lm.get("include_qkv_bias")),
                    mask_id=lm["mask_token_id"])
    if family == "dream":
        return dict(D=lm["hidden_size"], H=lm["num_attention_heads"],
                    Hkv=lm["num_key_value_heads"],
                    L=lm["num_hidden_layers"], F=lm["intermediate_size"],
                    V=lm["vocab_size"], theta=lm["rope_theta"],
                    eps=lm["rms_norm_eps"], qkv_bias=True,
                    mask_id=lm["mask_token_id"])
    raise ValueError(f"family {family!r}")


class LM:
    """The bidirectional masked-diffusion transformer: RMSNorm, RoPE,
    softmax attention, SwiGLU (silu of ff_proj times up_proj), the final
    norm and the head; leaves under the port's names ("llada.*")."""

    def __init__(self, W: Weights, geo: dict, mode: str = "f32"):
        self.g, self.mode = geo, mode
        self.wte = W("llada.wte.weight")
        self.blocks = []
        for i in range(geo["L"]):
            p = f"llada.blocks.{i}"
            blk = {"attn_norm": W(f"{p}.attn_norm.weight").float(),
                   "ff_norm": W(f"{p}.ff_norm.weight").float()}
            for n in ("q_proj", "k_proj", "v_proj"):
                blk[n] = linear(W, f"{p}.{n}", mode, geo["qkv_bias"])
            for n in ("attn_out", "ff_proj", "up_proj", "ff_out"):
                blk[n] = linear(W, f"{p}.{n}", mode, False)
            self.blocks.append(blk)
        self.ln_f = W("llada.ln_f.weight").float()
        self.head = linear(W, "llada.ff_out", mode, False)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.wte[ids].float()

    def block(self, i: int, x, positions, past=None, allowed=None):
        """x [B, T, D] -> (x, (k, v)); past: (k, v) of earlier rows that
        these rows also attend to (placed before their own)."""
        g, blk = self.g, self.blocks[i]
        B, T, _ = x.shape
        h = rms_norm(x, blk["attn_norm"], g["eps"])
        q = rope(blk["q_proj"](h).view(B, T, g["H"], -1), positions,
                 g["theta"])
        k = rope(blk["k_proj"](h).view(B, T, g["Hkv"], -1), positions,
                 g["theta"])
        v = blk["v_proj"](h).view(B, T, g["Hkv"], -1)
        kk, vv = (k, v) if past is None else (torch.cat([past[0], k], 1),
                                              torch.cat([past[1], v], 1))
        x = x + blk["attn_out"](attend(q, kk, vv, allowed).reshape(B, T, -1))
        h2 = rms_norm(x, blk["ff_norm"], g["eps"])
        x = x + blk["ff_out"](F.silu(blk["ff_proj"](h2)) * blk["up_proj"](h2))
        return x, (k, v)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(rms_norm(x, self.ln_f, self.g["eps"]))

    def set_mode(self, mode: str) -> None:
        """Switch the activations' precision between "w4a8" and "w4a4"
        (the weights' grouped int4 values are the same for both)."""
        if {mode, self.mode} - {"w4a8", "w4a4"}:
            raise ValueError(f"{self.mode} -> {mode}")
        for blk in self.blocks:
            for m in blk.values():
                if isinstance(m, Linear):
                    m.mode = mode
        self.head.mode = self.mode = mode

    # -- serving: the prefix once, then the answer rows over it -----------

    @torch.no_grad()
    def prefill(self, prefix: torch.Tensor) -> list:
        """prefix [n, D] -> per-layer (k, v) of its rows, each row seeing
        every prefix row."""
        x = prefix[None].float()
        pos = torch.arange(x.shape[1], device=x.device)
        kv = []
        for i in range(len(self.blocks)):
            x, c = self.block(i, x, pos)
            kv.append(c)
        return kv

    @torch.no_grad()
    def answer_logits(self, ids: torch.Tensor, kv: list) -> torch.Tensor:
        """Logits [G, V] of the answer rows ids [G] after the prefix whose
        cache is kv, each row seeing the prefix and every answer row."""
        n = kv[0][0].shape[1]
        x = self.embed(ids)[None]
        pos = torch.arange(n, n + ids.shape[0], device=x.device)
        for i in range(len(self.blocks)):
            x, _ = self.block(i, x, pos, past=kv[i])
        return self.logits(x)[0]


def served_gaps(lm: LM, prefix: torch.Tensor, states: torch.Tensor,
                k_steps: Sequence[int], control: Optional[str] = None
                ) -> dict:
    """The served answer held to the reference at each of its denoise
    steps.  `states` [S + 1, G]: the answer's tokens before each step and
    after the last (all [MASK] first), as the program committed them.
    At each step the reference scores the state the program was in, and
    two gaps are read over the positions the program committed there:
      - "gap": how far the committed token's logit lies below the
        reference's best at that position (temperature 0: the argmax);
      - "order": how far the reference's confidence (log of the softmax's
        largest probability) of a committed position lies below that of
        the best position left masked (LLaDA's low-confidence remasking
        commits the most confident positions).
    A step that commits another count than `k_steps` gives, or a [MASK]
    left at the end, reads inf.  With `control` (a precision of
    `LM.set_mode`) the same gaps of what the LM in that precision would
    commit from the same states are read too.  Returns the four maxima."""
    mask_id = lm.g["mask_id"]
    S = len(k_steps)
    inf = {"gap": float("inf"), "order": float("inf"),
           "control_gap": None, "control_order": None}
    if states.shape[0] != S + 1 or (states[0] != mask_id).any() or \
            (states[-1] == mask_id).any():
        return inf
    mode = lm.mode
    kv = lm.prefill(prefix)
    ckv = None
    if control is not None:
        lm.set_mode(control)
        ckv = lm.prefill(prefix)
        lm.set_mode(mode)
    out = {"gap": 0.0, "order": 0.0, "control_gap": None,
           "control_order": None}
    if control is not None:
        out["control_gap"] = out["control_order"] = 0.0
    for s, k in enumerate(k_steps):
        x, nxt = states[s], states[s + 1]
        masked = x == mask_id
        new = nxt != x
        if int(new.sum()) != k or (new & ~masked).any():
            return inf
        lg = lm.answer_logits(x, kv)
        best = lg.max(dim=-1).values
        conf = best - torch.logsumexp(lg, dim=-1)

        def read(pick, tok):
            gap = (best[pick] - lg[pick, tok]).max().item()
            rest = masked & ~pick
            order = 0.0
            if rest.any():
                order = max(0.0, (conf[rest].max() - conf[pick].min()).item())
            return gap, order

        g, o = read(new, nxt[new])
        out["gap"], out["order"] = max(out["gap"], g), max(out["order"], o)
        if control is not None:
            lm.set_mode(control)
            cl = lm.answer_logits(x, ckv)
            lm.set_mode(mode)
            cconf = cl.max(dim=-1).values - torch.logsumexp(cl, dim=-1)
            cconf = torch.where(masked, cconf, torch.full_like(cconf, -1e30))
            cpick = torch.zeros_like(masked)
            cpick[torch.argsort(-cconf, stable=True)[:k]] = True
            g, o = read(cpick, cl.argmax(dim=-1)[cpick])
            out["control_gap"] = max(out["control_gap"], g)
            out["control_order"] = max(out["control_order"], o)
    return out


# ---------------------------------------------------------------------------
# training: the complementary-masking loss and AdamW on the projector
# ---------------------------------------------------------------------------

def lm_hidden_train(lm: LM, embeds: torch.Tensor,
                    prefix_len: torch.Tensor) -> torch.Tensor:
    """The LM's blocks over embeds [B, T, D] with the prefix-LM mask (key
    j is visible from query i when j < prefix_len or i >= prefix_len),
    each block checkpointed so that autograd keeps one block's inputs."""
    from torch.utils.checkpoint import checkpoint

    B, T, _ = embeds.shape
    idx = torch.arange(T, device=embeds.device)
    pl = prefix_len[:, None, None]
    allowed = (idx[None, None, :] < pl) | (idx[None, :, None] >= pl)
    pos = idx
    x = embeds
    for i in range(len(lm.blocks)):
        x = checkpoint(lambda h, i=i: lm.block(i, h, pos, allowed=allowed)[0],
                       x, use_reentrant=False)
    return rms_norm(x, lm.ln_f, lm.g["eps"])


def diffusion_loss(lm: LM, embeds: torch.Tensor, labels: torch.Tensor,
                   masked: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """LLaDA's SFT loss with LaViDa's complementary masking: the batch
    twice, once with the masked supervised positions replaced by the
    [MASK] embedding and once with the others; the mean cross entropy
    over every supervised position of both, without 1 / p weighting;
    the prefix of each row is everything before its first supervised
    position."""
    sup = labels != -100
    sel = (masked & sup, ~masked & sup)
    mask_emb = lm.embed(torch.tensor([lm.g["mask_id"]],
                                     device=embeds.device))[0]
    x = torch.cat([torch.where(s[..., None], mask_emb, embeds) for s in sel])
    tgt = torch.cat([torch.where(s, labels, -100) for s in sel])
    pl = torch.argmax(sup.int(), dim=1)
    h = lm_hidden_train(lm, x, torch.cat([pl, pl]))
    keep = tgt != -100
    rows, t = h[keep], tgt[keep]
    total = h.new_zeros(())
    for i in range(0, rows.shape[0], chunk):
        lg = lm.head(rows[i:i + chunk])
        total = total + F.cross_entropy(lg, t[i:i + chunk], reduction="sum")
    return total / max(int(keep.sum()), 1)


TRAINABLE = ("projector.layers.0.weight", "projector.layers.0.bias",
             "projector.layers.1.weight", "projector.layers.1.bias",
             "image_newline")


def train_steps(W: Weights, vcfg: dict, lm: LM, batches: Sequence[dict],
                opt: dict, mode: str = "f32") -> dict:
    """Stage-1 steps (the projector and the newline train, the rest is
    frozen) over `batches`, each {"views": [[V, 3, S, S] per sample],
    "sizes", "ids" (with the marker), "labels" (per id, -100 where not
    supervised), "T" (the padded length), "masked" [B, T] bool}: embed,
    loss, gradient, clip by the group's global norm, AdamW (optax's order,
    `opt` = lr, b1, b2, eps, weight_decay, grad_clip; a constant LR).
    Returns {"loss": [per step], "grad": {leaf: norm of the first step's
    gradient as the optimizer takes it}, "grad_vec": {leaf: that
    gradient}, "change": {leaf: norm of the change after the last
    step}}."""
    vision = Vision(W, vcfg, mode)
    p0 = {n: W(n).float() for n in TRAINABLE}
    params = {n: t.clone().requires_grad_() for n, t in p0.items()}
    mu = {n: torch.zeros_like(t) for n, t in p0.items()}
    nu = {n: torch.zeros_like(t) for n, t in p0.items()}
    out = {"loss": [], "grad": None, "change": None}
    act = fp8 if mode == "fp8" else (lambda t: t)
    wgt = fp8 if mode == "fp8" else (lambda t: t)
    for step, b in enumerate(batches):
        embeds, labels = [], []
        for views, size, ids, lab in zip(b["views"], b["sizes"], b["ids"],
                                         b["labels"]):
            with torch.no_grad():
                feats = vision.tower(views)
            h = act(feats) @ wgt(params["projector.layers.0.weight"]).t() \
                + params["projector.layers.0.bias"]
            h = act(F.gelu(h)) @ wgt(params["projector.layers.1.weight"]).t() \
                + params["projector.layers.1.bias"]
            block = merge_image(vision.pool(h), size, vcfg,
                                params["image_newline"])
            e = splice(ids, [block], lm.wte)
            m = int(np.flatnonzero(np.asarray(ids) == IMAGE_TOKEN)[0])
            lab = np.concatenate([lab[:m], np.full(block.shape[0], -100),
                                  lab[m + 1:]])
            pad = b["T"] - e.shape[0]
            embeds.append(F.pad(e, (0, 0, 0, pad)))
            labels.append(np.pad(lab, (0, pad), constant_values=-100))
        dev = embeds[0].device
        loss = diffusion_loss(lm, torch.stack(embeds),
                              torch.as_tensor(np.stack(labels), device=dev),
                              b["masked"].to(dev))
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if norm >= opt["grad_clip"]:
            grads = {n: g / norm * opt["grad_clip"] for n, g in grads.items()}
        if step == 0:
            out["grad"] = {n: g.norm().item() for n, g in grads.items()}
            out["grad_vec"] = {n: g.detach().clone() for n, g in grads.items()}
        n_upd = step + 1
        bc1 = 1 - opt["b1"] ** n_upd
        bc2 = 1 - opt["b2"] ** n_upd
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                mu[n] = (1 - opt["b1"]) * g + opt["b1"] * mu[n]
                nu[n] = (1 - opt["b2"]) * g * g + opt["b2"] * nu[n]
                u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + opt["eps"])
                p.add_(-opt["lr"] * (u + opt["weight_decay"] * p))
        out["loss"].append(loss.item())
    out["change"] = {n: (params[n].detach() - p0[n]).norm().item()
                     for n in TRAINABLE}
    return out
