"""The work counts: the MFU counts of both families against
torch.utils.flop_counter over the program's own training step at a tiny
size (no remat, dense attention: every pair of the square is computed,
so the count takes the whole square), the serving forward against the
reference's, and the rooflines' operations and bytes against the same
shapes counted by hand."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import program, traffic
from harness.train_step import program_feed
from harness.weights import leaf_shapes
from reference import lavida as ref
from work import counts as C
from work import serve as ws
from work import train as wt


def _cell(family):
    conf = tiny.tiny_config(family)
    geo = ref.lm_geometry(family, conf)
    vcfg = dict(conf["vision"], grid_pinpoints=[
        tuple(p) for p in conf["composition"]["image_grid_pinpoints"]])
    return conf, geo, vcfg


@pytest.mark.parametrize("family", ["llada", "dream"])
def test_train_mfu_count_matches_flop_counter(family):
    from lavida_mod_tpu_torch.train.step import (
        init_train_state, make_freeze_optimizer, make_multimodal_train_step)

    conf, geo, vcfg = _cell(family)
    mix = dict(tiny.TRAIN, image_sizes=[[112, 112]], caption_tokens=[7, 7],
               seq_bucket=1)
    model = program.build_model(conf, leaf_shapes(geo, vcfg), 3, "cpu")
    model = model.float()
    opt = make_freeze_optimizer("mm_mlp_adapter", lr=1e-3,
                                schedule="constant")
    state = init_train_state(model, opt, None)
    cfg = program.port_config(conf)
    step = make_multimodal_train_step(cfg, opt, remat=False,
                                      attention_impl="dense")
    batch = traffic.train_batch(mix, vcfg, 3, 0)
    feed = program_feed(batch, cfg, mix, "cpu")
    with FlopCounterMode(display=False) as fc:
        step(state, feed["batch"], masked_indices=feed["masked"])
    d = wt.step_desc(batch)
    assert d["T"] == max(d["L"]) == min(d["L"])
    d["prefix"] = [0] * d["B"]          # the whole square, as computed
    want = wt.model_ops(d, geo, vcfg)
    # the tower attention's VJP (ops/short_attention.py) runs the forward
    # again: a recompute, which the MFU does not count
    recompute = sum(C.tower_forward_ops(vcfg, V)["attention"]
                    for V in d["views"])
    assert fc.get_total_flops() == want + recompute


def test_serve_forward_count_matches_flop_counter():
    conf, geo, vcfg = _cell("llada")
    shapes = leaf_shapes(geo, vcfg)
    from harness.weights import Leaves

    lm = ref.LM(Leaves(shapes, torch.float32, "cpu", 1), geo, "f32")
    P, G = 37, 8
    with FlopCounterMode(display=False) as fc:
        kv = lm.prefill(torch.randn(P, geo["D"]))
    pre = C.lm_forward_ops(geo, P, P * P, 0)
    assert fc.get_total_flops() == pre["linear"] + pre["attention"]
    with FlopCounterMode(display=False) as fc:
        lm.answer_logits(torch.zeros(G, dtype=torch.long), kv)
    step = C.lm_forward_ops(geo, G, G * (P + G), G)
    assert fc.get_total_flops() == sum(step.values())


def test_w4_grouped_by_hand():
    T, K, N = 2304, 4096, 12288
    ops, nbytes = C.w4_grouped(T, K, N)
    assert ops == 2 * 2304 * 4096 * 12288
    # x bf16, int4 codes, f32 scale per 128 rows of K and column, out bf16
    assert nbytes == 2304 * 4096 * 2 + 4096 * 12288 // 2 \
        + 32 * 12288 * 4 + 2304 * 12288 * 2
    s, by = C.bound_s(ops, nbytes, "int8")
    assert by == "ops" and s == ops / 1979e12
    s, by = C.bound_s(*C.w4_grouped(64, 4096, 4096), "int8")
    assert by == "bytes"


def test_attention_pairs_by_hand():
    L, p = 11, 4
    i = np.arange(L)
    live = (i[None, :] < p) | (i[:, None] >= p)
    assert C.prefix_pairs(L, p) == int(live.sum())
    assert C.prefix_pairs(L, 0) == L * L
    ops, nbytes = C.attention_fwd(100, 32, 128, 8, 64, 96, B=2)
    assert ops == 4 * 128 * 32 * 100
    assert nbytes == 2 * 2 * (64 * 32 * 128 * 2 + 96 * 8 * 128 * 2)
    ops, nbytes = C.attention_bwd(100, 28, 128, 4, 64, 8)
    assert ops == 10 * 128 * 28 * 100
    # reads q, o, dO (28 heads), k, v (4) and the f32 statistics; writes
    # dq (28), dk, dv (4)
    assert nbytes == 2 * 8 * 64 * (3 * 28 + 2 * 4) * 128 + 4 * 8 * 64 * 28 \
        + 2 * 8 * 64 * (28 + 2 * 4) * 128


def test_serve_launches_by_hand():
    conf, geo, vcfg = _cell("llada")
    mix = dict(tiny.SERVE)
    batch = traffic.serve_batch(mix, vcfg, 5, 0)
    d = ws.batch_desc(batch, mix, geo)
    n = sum(x[3] for x in ws.w4_launches(d, geo))
    chunks = -(-d["B"] // 2)
    # 7 linears a layer per prefill chunk and per step; the head takes #4
    # only past 128 answer rows (up to them it is fused into #5)
    head = d["steps"] if d["B"] * d["G"] > 128 else 0
    assert n == 7 * geo["L"] * (chunks + d["steps"]) + head
    big = dict(d, B=32, G=32, chunk=2, P=d["P"] * 6, views=d["views"] * 6)
    assert ws.w4_launches(big, geo)[-1] == (1024, geo["D"], geo["V"],
                                            d["steps"])
    sa = ws.short_attention_launches(d, geo, vcfg)
    assert sum(a["n"] for a in sa) == (vcfg["num_hidden_layers"] - 1) \
        * d["B"] + geo["L"] * chunks
