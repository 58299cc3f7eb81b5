"""Sharding rules for the port's LaViDa / LLaDA parameters, and the
collectives that run a sharded model: the port of
lavida_mod_tpu/parallel/sharding.py.

The rule table is JAX's (sharding.py:31-50), first match wins, written on
the port's per-layer names and its [out, in] weight layout (JAX stacks
[L, in, out] kernels):

  LLaDA blocks
    q/k/v/ff_proj/up_proj/att_proj  col-parallel  (tp on out, fsdp on in)
    attn_out/ff_out                 row-parallel  (fsdp on out, tp on in)
    biases, norms                   replicated
  wte [E, D]            (tp, fsdp)   the vocab-sharded embedding
  head ff_out [E, D]    (tp, fsdp)   (JAX's [D, E] kernel as (fsdp, tp))
  ln_f                  replicated
  SigLIP layers         the same col / row pattern; the rest replicated
  projector, image_newline and every leaf no rule names (LoRA factors
  among them): replicated.

A rule is trimmed to the leaf's rank (`_fit`), and an axis whose size does
not divide its dim is dropped for that leaf (JAX's GSPMD pads instead).

How a sharded model runs (`shard_params`).  Each sharded parameter becomes
a DTensor on the mesh with its rule's placements; a replicated one stays a
plain tensor, the same on every rank.  Compute runs on plain local
tensors, Megatron's way: a linear's weight is gathered over fsdp where it
is used (`compute_weight`; the gather's backward sums the gradient over
the fsdp ranks and keeps this rank's slice), a col-parallel linear gives
this rank's heads / hidden columns, the attention (and every hand-written
kernel on the path: #1, #10, #2) runs on the rank's local heads, and a
row-parallel linear's partial sums are all-reduced over tp.  Where tp does
not divide a block's heads (GQA's KV heads), its q/k/v outputs are
gathered over tp and the attention runs on every head.  The embedding
looks up its vocab rows and all-reduces; the head's vocab-sharded logits
are gathered.  Every collective is an autograd function with its true
adjoint (all-reduce <-> all-reduce, all-gather <-> all-reduce and slice),
so the backward of sum_r L_r is exact: the training step gives each rank
the loss of its rows over tp (`1 / tp`), then sums each gradient over the
mesh dims its parameter is replicated on (`sync_grad`).
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import bmm_f32
from ..ops.quant import LoRALinear, has_lora
from .mesh import AXES

_COL = ("tp", "fsdp")        # [out, in]: tp on out, fsdp on in
_ROW = ("fsdp", "tp")

# (regex over the state-dict name, the axis per tensor dim) -- first match
_RULES: list[tuple[str, tuple]] = [
    (r"(^|\.)blocks\.\d+\.(q_proj|k_proj|v_proj|ff_proj|up_proj|att_proj)"
     r"\.weight$", _COL),
    (r"(^|\.)blocks\.\d+\.(attn_out|ff_out)\.weight$", _ROW),
    (r"(^|\.)blocks\.\d+\..*\.bias$", ()),
    (r"(^|\.)blocks\.\d+\.(attn_norm|ff_norm|q_norm|k_norm)\..*$", ()),
    (r"(^|\.)wte\.weight$", ("tp", "fsdp")),
    (r"(^|\.)ff_out\.weight$", ("tp", "fsdp")),
    (r"(^|\.)ln_f\..*$", ()),
    (r"(^|\.)siglip\.layers\.\d+\.(q_proj|k_proj|v_proj|fc1)\.weight$",
     _COL),
    (r"(^|\.)siglip\.layers\.\d+\.(out_proj|fc2)\.weight$", _ROW),
    (r"(^|\.)siglip\..*$", ()),
    (r"(^|\.)projector\..*$", ()),
    (r"(^|\.)image_newline$", ()),
]

def _fit(spec: tuple, ndim: int) -> tuple:
    """Trim a spec to the leaf's rank (sharding.py:75-81)."""
    parts = (list(spec) + [None] * ndim)[:ndim]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_for(name: str, ndim: int) -> tuple:
    """The axis name (or None) per tensor dim of the leaf `name`."""
    for pat, spec in _RULES:
        if re.search(pat, name):
            return _fit(spec, ndim)
    return ()


def _placements(spec: tuple):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(spec.index(a)) if a in spec else Replicate()
                 for a in AXES)


def param_specs(model: nn.Module) -> dict:
    """{state-dict name: DTensor placements per mesh dim (dp, fsdp, tp)}
    by the rules, before any divisibility trim."""
    return {n: _placements(spec_for(n, p.dim()))
            for n, p in model.named_parameters()}


def spec_axes(placements, ndim: int) -> tuple:
    """Placements per mesh dim -> the axis per tensor dim (JAX's
    PartitionSpec entries, trailing Nones trimmed)."""
    parts = [None] * ndim
    for axis, pl in zip(AXES, placements):
        if pl.is_shard():
            parts[pl.dim] = axis
    return _fit(tuple(parts), ndim)


def batch_spec():
    """The batch dim sharded over dp x fsdp (sharding.py:98-101)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Shard(0), Replicate())


# ---------------------------------------------------------------------------
# collectives with their adjoints
# ---------------------------------------------------------------------------

def _size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist

        n = dist.get_world_size(group)
        ctx.dim, ctx.group, ctx.n = dim, group, n
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` (autograd: the gradient summed over it too); the
    identity on one rank."""
    if group is None or _size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the ranks' x along `dim` (autograd: the gradient summed
    over `group`, this rank's slice kept); the identity on one rank."""
    if group is None or _size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group)


# ---------------------------------------------------------------------------
# sharded parameters at run time
# ---------------------------------------------------------------------------

_DTENSOR = []


def is_dtensor(t) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def local(t):
    """A DTensor's local shard (differentiable), else t."""
    return t.to_local() if is_dtensor(t) else t


def _dims(p):
    mesh = p.device_mesh
    return [(mesh.mesh_dim_names[i], pl, mesh.get_group(i), mesh.size(i))
            for i, pl in enumerate(p.placements)]


def compute_weight(p, whole: bool = False):
    """The weight as this rank computes with it: a DTensor's local shard
    gathered over every sharded mesh dim but tp (`whole`: tp too, the
    full weight on every rank); a plain tensor as is."""
    if not is_dtensor(p):
        return p
    w = p.to_local()
    for name, pl, group, n in _dims(p):
        if pl.is_shard() and (whole or name != "tp") and n > 1:
            w = all_gather(w, pl.dim, group)
    return w


def tp_split(p) -> Optional[tuple]:
    """(tensor dim, tp group, tp size, tp rank) where the DTensor `p` is
    sharded over a tp of more than one rank, else None."""
    if not is_dtensor(p):
        return None
    mesh = p.device_mesh
    i = mesh.mesh_dim_names.index("tp")
    pl = p.placements[i]
    if not pl.is_shard() or mesh.size(i) == 1:
        return None
    return pl.dim, mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i)


def embedding(ids: torch.Tensor, w) -> torch.Tensor:
    """wte lookup on the vocab-sharded embedding: each tp rank fills the
    rows of its vocab slice (zeros elsewhere) and the tp all-reduce adds
    them -- exact, one term per row."""
    wl = compute_weight(w)
    tp = tp_split(w)
    if tp is None:
        return F.embedding(ids, wl)
    _, group, _, rank = tp
    lo = rank * wl.shape[0]
    inside = (ids >= lo) & (ids < lo + wl.shape[0])
    e = F.embedding(torch.where(inside, ids - lo, 0), wl)
    return all_reduce(torch.where(inside[..., None], e, 0), group)


def vocab_logits(fn, w) -> torch.Tensor:
    """fn(weight) -> logits [..., V_local] on the head weight `w` [V, D];
    a vocab-sharded head's slices gathered over tp."""
    y = fn(compute_weight(w))
    tp = tp_split(w)
    return y if tp is None else all_gather(y, -1, tp[1])


class ParallelLinear(LoRALinear):
    """A float linear whose weight is a DTensor: `linear(x)` gathers the
    weight over fsdp and, by its tp placement, runs col-parallel (this
    rank's output columns; `gather_out` concatenates them) or row-parallel
    (this rank's input columns, `scatter_in` taking them from a full x;
    the partial sums all-reduced over tp, then the bias).  The bias and
    LoRA factors are replicated and sliced where the weight is.  On a
    mesh where tp is one rank the ops are the unsharded linear's, in its
    order."""

    base_cls = nn.Linear
    gather_out = False
    scatter_in = False

    def linear(self, x: torch.Tensor, fuse_bias: bool = False
               ) -> torch.Tensor:
        w = compute_weight(self.weight)
        b = self.bias
        tp = tp_split(self.weight)
        if tp is None:
            if fuse_bias and not has_lora(self):
                return F.linear(x, w, b)
            return _lora_bias(self, x, F.linear(x, w), None, b)
        dim, group, n, rank = tp
        if dim == 0:                                  # col-parallel
            cols = slice(rank * w.shape[0], (rank + 1) * w.shape[0])
            bl = None if b is None else b[cols]
            if fuse_bias and not has_lora(self):
                y = F.linear(x, w, bl)
            else:
                y = _lora_bias(self, x, F.linear(x, w), (None, cols), bl)
            return all_gather(y, -1, group) if self.gather_out else y
        rows = slice(rank * w.shape[1], (rank + 1) * w.shape[1])
        if self.scatter_in:
            x = x[..., rows]
        # the partial sums in f32, rounded to x's dtype once after the
        # all-reduce, as the whole product rounds once
        lead = x.shape[:-1]
        y = bmm_f32(x.reshape(1, -1, x.shape[-1]), w.t()[None]).view(
            *lead, -1)
        y = all_reduce(_lora_bias(self, x, y, (rows, None), None),
                       group).to(x.dtype)
        return y if b is None else y + b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x, fuse_bias=self.base_cls is nn.Linear)


def _lora_bias(m, x, y, slices, b):
    """y + ((x @ A) @ B) * scale (quant.py's order) with A's rows / B's
    columns sliced, then the bias."""
    if has_lora(m):
        a, bb = m.lora_a, m.lora_b
        if slices is not None:
            rows, cols = slices
            a = a if rows is None else a[rows]
            bb = bb if cols is None else bb[:, cols]
        dt = x.dtype
        delta = (x @ a.to(dt)) @ bb.to(dt)
        y = y + delta.to(y.dtype) * m.lora_scale.to(y.dtype)
    return y if b is None else y + b


# ---------------------------------------------------------------------------
# placing a model on a mesh
# ---------------------------------------------------------------------------

def _trim(placements, shape, mesh):
    """Drop each Shard whose mesh dim's size does not divide the dim."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if pl.is_shard()
                 and shape[pl.dim] % mesh.size(i) else pl
                 for i, pl in enumerate(placements))


def _chunk(full: torch.Tensor, placements, mesh) -> torch.Tensor:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is outside the mesh")
    for i, pl in enumerate(placements):
        if pl.is_shard():
            full = full.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return full.contiguous()


def distribute(full: torch.Tensor, placements, mesh):
    """A DTensor of this rank's chunk of `full` (no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(_chunk(full, placements, mesh), mesh,
                              placements, run_check=False)


def _heads(block) -> Optional[tuple]:
    cfg = getattr(block, "cfg", None)
    if hasattr(cfg, "n_heads"):
        return cfg.n_heads, cfg.effective_n_kv_heads
    if hasattr(cfg, "num_attention_heads"):
        return cfg.num_attention_heads, cfg.num_attention_heads
    return None


@torch.no_grad()
def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Place `model`'s parameters on `mesh` by the rules, in place: each
    sharded leaf becomes a DTensor holding this rank's chunk, each float
    linear with a sharded weight a `ParallelLinear`, and each attention
    block whose heads tp does not divide gathers its q/k/v outputs.  The
    model gets `mesh`; an LLaDA its `kv_heads` per rank (the cache's).
    Takes float layouts only (the quantized and fused serving layouts
    have no rules, as in the JAX package)."""
    from ..ops.quant import Int4Linear, Int8Linear

    if any(isinstance(m, (Int8Linear, Int4Linear)) for m in model.modules()):
        raise ValueError("shard the float model: the quantized serving "
                         "layouts have no sharding rules")
    specs = param_specs(model)
    for name, p in list(model.named_parameters()):
        pl = _trim(specs[name], p.shape, mesh)
        if all(x.is_replicate() for x in pl):
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        setattr(mod, leaf, nn.Parameter(distribute(p.detach(), pl, mesh),
                                        requires_grad=p.requires_grad))
    for m in model.modules():
        if isinstance(m, nn.Linear) and is_dtensor(m.weight) \
                and not isinstance(m, ParallelLinear):
            base = type(m)
            m.__class__ = ParallelLinear
            m.base_cls = base
    tp = mesh.size(AXES.index("tp"))
    for m in model.modules():
        heads = _heads(m)
        if heads is None or not hasattr(m, "q_proj"):
            continue
        out = getattr(m, "attn_out", None) or m.out_proj
        qkv = [m.q_proj, m.k_proj, m.v_proj]
        whole = (all(tp_split(l.weight) is not None for l in qkv)
                 and tp_split(out.weight) is not None
                 and heads[0] % tp == 0 and heads[1] % tp == 0)
        for l in qkv:
            l.gather_out = not whole
        out.scatter_in = not whole
        m.local_heads = whole
    llada = getattr(model, "llada", model)
    if hasattr(llada, "blocks"):
        blk = llada.blocks[0]
        kv = llada.cfg.effective_n_kv_heads
        llada._kv_heads = kv // tp if getattr(blk, "local_heads", False) \
            else kv
    model.mesh = mesh
    return model


# ---------------------------------------------------------------------------
# gradients, norms and full tensors
# ---------------------------------------------------------------------------

def _replicated_groups(p, mesh):
    """The groups of the mesh dims `p` is replicated on (size > 1); none
    without a mesh."""
    if mesh is None:
        return []
    if is_dtensor(p):
        return [g for _, pl, g, n in _dims(p) if pl.is_replicate() and n > 1]
    return [mesh.get_group(i) for i in range(mesh.ndim) if mesh.size(i) > 1]


def sync_grad(p, mesh) -> torch.Tensor:
    """Sum p's gradient, in place, over the mesh dims p is replicated on
    (the dims it is sharded on were summed by the gathers' adjoints);
    returns the local gradient."""
    import torch.distributed as dist

    g = local(p.grad)
    for group in _replicated_groups(p, mesh):
        dist.all_reduce(g, group=group)
    return g


def _shard_groups(p) -> list:
    if not is_dtensor(p):
        return []
    return [g for _, pl, g, n in _dims(p) if pl.is_shard() and n > 1]


def sharded_sum(p, part: torch.Tensor) -> torch.Tensor:
    """A per-rank partial sum over p's local shard (a 0-d f32 tensor)
    summed over the ranks that shard p: the sum over the whole of p."""
    import torch.distributed as dist

    groups = _shard_groups(p)
    if groups:
        part = part.clone()
        for g in groups:
            dist.all_reduce(part, group=g)
    return part


def sharded_norm(p, g: torch.Tensor) -> torch.Tensor:
    """The f32 norm of the whole gradient whose local shard is g."""
    n = torch.linalg.vector_norm(g, dtype=torch.float32)
    if not _shard_groups(p):
        return n
    return torch.sqrt(sharded_sum(p, n.square()))


def full_tree(tree):
    """A nested dict with every DTensor gathered to its full tensor (a
    collective: every rank of the mesh calls it)."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if is_dtensor(tree):
        return tree.full_tensor()
    return tree


def copy_full_(dst, full: torch.Tensor) -> None:
    """dst <- full: a DTensor takes its chunk, a plain tensor the whole."""
    if is_dtensor(dst):
        dst.to_local().copy_(_chunk(full.to(dst.device), dst.placements,
                                    dst.device_mesh))
    else:
        dst.copy_(full)


def data_rank(mesh, batch_axes=("dp", "fsdp")) -> tuple:
    """(index, count) of this rank among the data shards over
    `batch_axes`."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for a in batch_axes:
        if a in mesh.mesh_dim_names:
            i = mesh.mesh_dim_names.index(a)
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx, n


def data_groups(mesh, batch_axes=("dp", "fsdp")) -> list:
    return [mesh.get_group(a) for a in batch_axes
            if a in mesh.mesh_dim_names
            and mesh.size(mesh.mesh_dim_names.index(a)) > 1]


def reduce_sum(t: torch.Tensor, groups) -> torch.Tensor:
    """A detached sum of t over each group in turn."""
    import torch.distributed as dist

    t = t.detach().clone()
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def tp_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(AXES.index("tp"))
