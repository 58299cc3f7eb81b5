"""Operations and bytes of the work a cell asks for, term by term, from
the shapes its traffic gives (never from a kernel's own plan).

Products count 2 operations per multiply-add.  Attention counts the live
(query, key) pairs of its mask: 2 products of 2 * hd operations per pair
and head forward, 4 more backward (dS and dP, dQ, dK, dV), and the flash
backward's recompute of S adds one.  Bytes count each input read once and
each output written once.  The peaks are one H100 SXM's (NVIDIA's data
sheet, dense): 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK = {"bf16": 989e12, "int8": 1979e12, "hbm": 3.35e12}


def bound_s(ops: float, nbytes: float, precision: str) -> tuple[float, str]:
    """(least seconds, "ops" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = ops / PEAK[precision], nbytes / PEAK["hbm"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def w4_grouped(T: int, K: int, N: int) -> tuple[float, float]:
    """#4, x [T, K] bf16 @ grouped int4 W [K, N] (scales f32 per 128 rows
    of K) -> [T, N] bf16: (int8 operations, bytes)."""
    ops = 2.0 * T * K * N
    nbytes = 2 * T * K + K * N / 2 + (K // 128) * N * 4 + 2 * T * N
    return ops, nbytes


def attention_fwd(pairs: float, H: int, hd: int, Hkv: int, Tq: int,
                  Tk: int, B: int = 1) -> tuple[float, float]:
    """Softmax attention forward over `pairs` live (query, key) pairs a
    head: (bf16 operations, bytes of q, k, v read and o written)."""
    ops = 4.0 * hd * H * pairs
    nbytes = 2 * B * (Tq * H * hd * 2 + Tk * Hkv * hd * 2)
    return ops, nbytes


def attention_bwd(pairs: float, H: int, hd: int, Hkv: int, T: int,
                  B: int) -> tuple[float, float]:
    """The flash backward (S recomputed; dP, dV, dQ, dK): 5 products a
    pair and head; reads q, k, v, o, dO and the f32 row statistics,
    writes dq, dk, dv."""
    ops = 10.0 * hd * H * pairs
    nbytes = 2 * B * T * (3 * H * hd + 2 * Hkv * hd) + 4 * B * T * H \
        + 2 * B * T * (H * hd + 2 * Hkv * hd)
    return ops, nbytes


def prefix_pairs(L: int, prefix: int) -> int:
    """Live pairs of the prefix-LM mask over L rows: the prefix rows see
    the prefix, every later row sees all L."""
    return prefix * prefix + (L - prefix) * L


# ---------------------------------------------------------------------------
# model pieces: operations of one forward
# ---------------------------------------------------------------------------

def lm_linear_params(geo: dict) -> int:
    """Weights of one block's linears (q, k, v, out, gate, up, down)."""
    D, F = geo["D"], geo["F"]
    kvD = geo["Hkv"] * (D // geo["H"])
    return 2 * D * D + 2 * D * kvD + 3 * D * F


def lm_forward_ops(geo: dict, rows: int, pairs: float,
                   head_rows: int) -> dict:
    """{"linear": products of the blocks, "attention": the score and value
    products, "head": the logits' product} of one forward."""
    hd = geo["D"] // geo["H"]
    return {"linear": 2.0 * rows * lm_linear_params(geo) * geo["L"],
            "attention": 4.0 * hd * geo["H"] * pairs * geo["L"],
            "head": 2.0 * head_rows * geo["D"] * geo["V"]}


def tower_forward_ops(vcfg: dict, views: int) -> dict:
    """SigLIP over `views` views: the patch embedding ("patch"), the
    layers' linears, their attention (every token sees every token of its
    view)."""
    W, I = vcfg["hidden_size"], vcfg["intermediate_size"]
    P = vcfg["patch_size"]
    T = (vcfg["image_size"] // P) ** 2
    layers = vcfg["num_hidden_layers"] - 1
    rows = views * T
    return {"linear": 2.0 * rows * (4 * W * W + 2 * W * I) * layers,
            "patch": 2.0 * rows * W * vcfg["num_channels"] * P * P,
            "attention": 4.0 * W * views * T * T * layers}


def projector_forward_ops(vcfg: dict, D: int, views: int) -> float:
    T = (vcfg["image_size"] // vcfg["patch_size"]) ** 2
    return 2.0 * views * T * (vcfg["hidden_size"] * D + D * D)


def pool_forward_ops(vcfg: dict, D: int, views: int) -> float:
    """The bilinear 2x2 pool as its two products (rows, then columns)."""
    g = vcfg["image_size"] // vcfg["patch_size"]
    go = -(-g // 2)
    return 2.0 * views * (go * g * g * D + go * go * g * D)


def tower_tokens(vcfg: dict) -> int:
    return (vcfg["image_size"] // vcfg["patch_size"]) ** 2


def ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m
