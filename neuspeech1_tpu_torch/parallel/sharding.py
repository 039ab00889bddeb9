"""FSDP and Megatron-style tensor parallelism of the PyTorch port: the port
of ``neuspeech1_tpu/parallel/sharding.py``.

The JAX package states which dims of each weight a mesh axis splits
(``PartitionSpec``s) and lets GSPMD place the collectives. Here the same
rules (`spec_for`) split the port's modules, and the collectives are
written out, on the ``Ring``s of the ambient mesh's ``fsdp`` and ``tensor``
axes (``parallel/mesh.py``), so that one code path runs over ``LocalRing``
threads, gloo processes and a ``DeviceMesh``:

- q, k, v (self- and cross-attention) and fc1 are column-parallel: the
  output dim is split over ``tensor``, the input dim over ``fsdp``, their
  biases over ``tensor``. Each tensor rank computes its heads (its block of
  fc1's features); the backward sums the input's gradient over ``tensor``
  (Megatron's "f", `copy_to_tensor`).
- ``out`` and fc2 are row-parallel: the input dim is split over ``tensor``,
  the output dim over ``fsdp``. Each rank's product is a partial sum, added
  over ``tensor`` in the forward (Megatron's "g", `reduce_from_tensor`);
  the bias is replicated and added once, after the sum.
- ``decoder.token_embed`` is split on its feature dim over ``tensor`` (the
  vocabulary, 51865, is odd). The decoder gathers it whole once per call
  (`whole_embedding`) for the lookup and the tied logits: a training
  step's partial logits would be [B, T, 51865] f32 to sum (1.7 GB at batch
  64 x 128 labels) where the table is 53 MB in bf16, and every tensor rank
  then computes the same logits, so the gather's backward takes this
  rank's columns of the gradient and needs no collective.
- The stem, conv2, the position tables, the layer norms and every LoRA or
  AdaLoRA leaf (A, B, E, masks) are replicated.

FSDP: a weight split over ``fsdp`` is gathered whole along that dim before
each use (`gather_fsdp`) and its gradient reduce-scattered back to the
shard in the backward (ZeRO-3). The batch's rows are split over ``data`` x
``fsdp`` (``parallel/mesh.py::batch_sharding``); the ranks of a tensor
group share rows.

The port's layout differs from the JAX package's: a JAX linear weight is
``[L, d_in, d_out]``, an ``nn.Linear`` weight ``[d_out, d_in]`` with one
module per layer; a spec here is one axis name (or None) per dim of the
port's tensor. `shard_params` replaces each split parameter of a model by
this rank's block and records the split on its module (``shard``) and on
the model (``leaf_specs``, by leaf path), where ``models/whisper.py::
linear``, the training step, the optimizer's norm and the checkpoints read
it; attention layers keep their local head count. `gather_params` gives
the whole model back, `gather_leaf` and `shard_leaf` one tensor.

The split linears run alike in the plain stack, in ring attention's layers
(``seq_parallel_axis``: each ring then carries its tensor rank's heads)
and in pipeline stages (``pipeline_axis``: each tick gathers its stage's
weights and reduce-scatters their gradients, so the ticks' reduce-scatters
add up to that of the summed gradient), as GSPMD composes the JAX
package's splits with its ring and its pipeline.

The collectives inside autograd's backward ("f", FSDP's reduce-scatter,
remat's recompute of "g") need one autograd engine per rank: a
``LocalRing`` of CUDA tensors refuses them at once
(``ring_attention.py::check_backward``); on the card each rank is a
process.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from neuspeech1_tpu_torch.parallel import mesh as pmesh
from neuspeech1_tpu_torch.parallel.ring_attention import check_backward

Spec = Tuple[Optional[str], ...]
# the leaves replicated over ``tensor`` that a tensor-split product reads:
# each tensor rank's gradient for them is a partial sum (A of a
# column-parallel projection: its dy B^T covers this rank's columns; the
# rows of A and all of B of a row-parallel one; AdaLoRA's E). Every adapted
# linear is tensor-split, so every adapter leaf.
TENSOR_PARTIAL_PREFIXES = ("lora/",)
_COLUMN = ("q", "k", "v", "fc1")


def spec_for(path: str, ndim: int) -> Spec:
    """The split of the leaf at ``path`` (its path in the combined
    ``{"model", "lora"}`` tree, ``train/optimizer.py::named_leaves``), one
    axis name or None per dim of the port's tensor: the JAX package's
    ``_spec_for`` in the port's layout."""
    keys = path.split("/")
    none = (None,) * ndim
    if keys[0] == "lora":
        return none
    last = keys[-1]
    if last != "w":
        if "token_embed" in keys:
            return (None, "tensor")
        if last == "b" and any(k in keys for k in _COLUMN):
            return ("tensor",)  # a column-parallel bias rides the shard
        return none
    if "stem" in keys or "conv2" in keys:
        return none
    for attn in ("self_attn", "cross_attn"):
        if attn in keys:
            if keys[keys.index(attn) + 1] == "out":
                return ("fsdp", "tensor")  # row-parallel [d_out, d_in]
            return ("tensor", "fsdp")
    if "fc1" in keys:
        return ("tensor", "fsdp")
    if "fc2" in keys:
        return ("fsdp", "tensor")
    return none


def param_specs(model: nn.Module, lora=None) -> Dict[str, Spec]:
    """`spec_for` of every leaf of ``model`` and ``lora``, by path."""
    from neuspeech1_tpu_torch.train.optimizer import named_leaves

    return {p: spec_for(p, t.dim())
            for p, t in named_leaves(model, lora).items()}


def restrict_spec(spec: Spec, mesh=None) -> Spec:
    """``spec`` without the axes ``mesh`` (default: the ambient mesh) lacks
    or holds one rank of: those dims are whole."""
    mesh = pmesh.get_mesh() if mesh is None else mesh
    names = pmesh.axis_names(mesh) if mesh is not None else ()

    def keep(a):
        return a if a in names and pmesh.axis_size(a, mesh) > 1 else None

    return tuple(keep(a) for a in spec)


def _block(t, dim: int, ring):
    n = t.shape[dim]
    if n % ring.size:
        raise ValueError(f"dim {dim} of size {n} does not split over the "
                         f"{ring.size} ranks of a mesh axis")
    size = n // ring.size
    return t.narrow(dim, ring.rank * size, size)


def shard_leaf(t, spec: Spec, mesh=None):
    """This rank's block of the whole tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = _block(t, dim, pmesh.axis_ring(axis, mesh))
    return t.contiguous()


def gather_leaf(t, spec: Spec, mesh=None):
    """The whole tensor of which ``t`` is this rank's block under ``spec``
    (a collective: every rank of the split axes calls it)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = pmesh.axis_ring(axis, mesh).all_gather(t.contiguous(), dim)
    return t


def _modules(model: nn.Module):
    """(leaf path prefix, module) of every module holding weights, with
    the paths of ``named_leaves``."""
    def walk(module, prefix):
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.LayerNorm,
                               nn.Embedding)):
            yield prefix, module
            return
        if isinstance(module, nn.ModuleList):
            for i, layer in enumerate(module):
                yield from walk(layer, f"{prefix}/{i}")
            return
        for name, child in module.named_children():
            yield from walk(child, f"{prefix}/{name}")

    return walk(model, "model")


def _leaf_names(module: nn.Module, prefix: str) -> Dict[str, str]:
    """{parameter attribute: leaf path} of a weight-holding module."""
    if isinstance(module, nn.Embedding):
        return {"weight": prefix}
    if isinstance(module, nn.LayerNorm):
        return {"weight": f"{prefix}/scale", "bias": f"{prefix}/bias"}
    out = {"weight": f"{prefix}/w"}
    if module.bias is not None:
        out["bias"] = f"{prefix}/b"
    return out


def shard_params(model: nn.Module, mesh=None) -> nn.Module:
    """Splits ``model`` (a whole ``Whisper``) in place into this rank's
    shards over ``mesh``'s ``fsdp`` and ``tensor`` axes (default: the
    ambient mesh; axes it lacks or holds one rank of split nothing) and
    returns it. Each split parameter becomes a new ``nn.Parameter`` of this
    rank's block, keeping ``requires_grad``; its module records the split
    (``shard``: the weight's and bias's specs and ``kind``, "column" or
    "row"), the model all of them (``leaf_specs``), and attention layers
    their local head count (``n_heads``). Adapter trees stay whole."""
    mesh = pmesh.get_mesh() if mesh is None else mesh
    specs: Dict[str, Spec] = {}
    for prefix, module in _modules(model):
        shard = {}
        for attr, path in _leaf_names(module, prefix).items():
            param = getattr(module, attr)
            spec = restrict_spec(spec_for(path, param.dim()), mesh)
            if any(spec):
                module._parameters[attr] = nn.Parameter(
                    shard_leaf(param.detach(), spec, mesh),
                    requires_grad=param.requires_grad)
                specs[path] = spec
            shard[attr] = spec
        if any(any(s) for s in shard.values()) and isinstance(module,
                                                              nn.Linear):
            shard["kind"] = ("row" if shard["weight"][1] == "tensor"
                             else "column")
        if any(any(s) for s in shard.values()):
            module.shard = shard
    tensor = restrict_spec(("tensor",), mesh)[0]
    if tensor is not None:
        n = pmesh.axis_size(tensor, mesh)
        for module in model.modules():
            if hasattr(module, "n_heads"):
                if module.n_heads % n:
                    raise ValueError(f"{module.n_heads} heads do not split "
                                     f"over {n} tensor ranks")
                module.n_heads //= n
    model.leaf_specs = specs
    return model


def leaf_specs(model: nn.Module) -> Dict[str, Spec]:
    """The split leaves of a model from `shard_params`, by path ({} for a
    whole model)."""
    return getattr(model, "leaf_specs", {})


def gather_params(model: nn.Module, mesh=None) -> nn.Module:
    """A whole ``Whisper`` with ``model``'s weights (a collective: every
    rank calls it): a new module on the model's device and dtype, its
    parameters frozen, for checkpoints, merges and exports. A whole model
    comes back as it is."""
    specs = leaf_specs(model)
    if not specs:
        return model
    from neuspeech1_tpu_torch.models.whisper import Whisper
    from neuspeech1_tpu_torch.train.optimizer import named_leaves

    leaves = named_leaves(model)
    ref = next(model.parameters())
    whole = Whisper(model.config, model.stem_config).to(
        device=ref.device, dtype=ref.dtype).eval().requires_grad_(False)
    with torch.no_grad():
        for path, t in named_leaves(whole).items():
            src = leaves[path].detach()
            if path in specs:
                src = gather_leaf(src, specs[path], mesh)
            t.copy_(src)
    return whole


# --------------------------------------------------------------------------
# the collectives of the forward and backward
# --------------------------------------------------------------------------

def _guard(ring, x) -> None:
    """Raises at once where this op's backward would need a collective a
    ``LocalRing`` of CUDA tensors cannot run (see the module docstring)."""
    if torch.is_grad_enabled() and x.requires_grad:
        check_backward(ring, x)


class _CopyToTensor(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the ring."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.all_reduce_sum(g.contiguous()), None


class _ReduceFromTensor(torch.autograd.Function):
    """Sums the ranks' partial products; every rank holds the whole
    gradient, which passes through."""

    @staticmethod
    def forward(ctx, x, ring):
        return ring.all_reduce_sum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherShard(torch.autograd.Function):
    """All-gathers a weight's shards along ``dim``; the backward
    reduce-scatters the gradient back to this rank's shard (FSDP)."""

    @staticmethod
    def forward(ctx, w, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return ring.all_gather(w.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.reduce_scatter_sum(g.contiguous(), ctx.dim), None, \
            None


class _GatherCopy(torch.autograd.Function):
    """All-gathers a weight's shards along ``dim`` for a computation every
    rank repeats: each rank's gradient is already whole, so the backward
    takes this rank's block of it."""

    @staticmethod
    def forward(ctx, w, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return ring.all_gather(w.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.ring).contiguous(), None, None


def copy_to_tensor(x, ring):
    """Megatron's "f": ``x`` as it is; its gradient summed over ``ring``."""
    if ring is None:
        return x
    _guard(ring, x)
    return _CopyToTensor.apply(x, ring)


def reduce_from_tensor(x, ring):
    """Megatron's "g": the sum of every rank's ``x``."""
    return x if ring is None else _ReduceFromTensor.apply(x, ring)


def gather_fsdp(w, spec: Spec):
    """The weight ``w`` gathered whole along its ``fsdp`` dim (if any):
    differentiable, the gradient reduce-scattered back to the shard."""
    if "fsdp" not in spec:
        return w
    ring = pmesh.axis_ring("fsdp")
    dim = spec.index("fsdp")
    if not (torch.is_grad_enabled() and w.requires_grad):
        return ring.all_gather(w.contiguous(), dim)
    _guard(ring, w)
    return _GatherShard.apply(w, ring, dim)


def whole_embedding(module: nn.Embedding):
    """The embedding table whole: gathered over ``tensor`` along its
    feature dim when split (see the module docstring)."""
    w = module.weight
    spec = getattr(module, "shard", {}).get("weight")
    if not spec or "tensor" not in spec:
        return w
    ring = pmesh.axis_ring("tensor")
    dim = spec.index("tensor")
    if not (torch.is_grad_enabled() and w.requires_grad):
        return ring.all_gather(w.contiguous(), dim)
    return _GatherCopy.apply(w, ring, dim)


def entry_block(entry: dict, spec: Spec) -> dict:
    """An adapter entry (A [d_in, r], B [r, d_out]) cut to the block of a
    weight [d_out, d_in] split by ``spec``: B's columns by the output dim's
    axis, A's rows by the input dim's. Differentiable views: the whole
    leaves' gradients are zero outside the block."""
    out_axis, in_axis = spec
    entry = dict(entry)
    if out_axis is not None:
        entry["B"] = _block(entry["B"], 1, pmesh.axis_ring(out_axis))
    if in_axis is not None:
        entry["A"] = _block(entry["A"], 0, pmesh.axis_ring(in_axis))
    return entry


def sharded_linear(x, module: nn.Linear, lora, dense):
    """``module``'s product on a split weight: the FSDP gather, then
    ``dense(x, weight, bias, lora)`` (``models/whisper.py``'s one-device
    linear: the fold, int8 and the per-token delta) on this rank's tensor
    block with the adapter cut to it, between "f" and "g" as the split's
    ``kind`` says."""
    shard = module.shard
    w = gather_fsdp(module.weight, shard["weight"])
    local = tuple(a if a == "tensor" else None for a in shard["weight"])
    entry = None if lora is None else entry_block(lora, local)
    ring = pmesh.axis_ring("tensor") if "tensor" in local else None
    if shard["kind"] == "column":
        return dense(copy_to_tensor(x, ring), w, module.bias, entry)
    y = reduce_from_tensor(dense(x, w, None, entry), ring)
    if module.bias is not None:
        y = y + module.bias.to(y.dtype)
    return y


# --------------------------------------------------------------------------
# the training step's reductions
# --------------------------------------------------------------------------

def global_norm(grads: Dict[str, torch.Tensor], specs: Dict[str, Spec]
                ) -> torch.Tensor:
    """The global norm of whole gradients from this rank's shards: each
    split leaf's sum of squares summed over the axes that split it, each
    replicated leaf counted once; the same bits on every rank. ``grads``
    are the training step's reduced gradients: a pipeline stage's leaves
    after the sum over ``pipe`` and the encoder's after the sum over
    ``seq`` are the same on every rank of those rings, which the norm
    therefore does not sum over. Leaves are
    grouped by their split axes, each group one sum (and one collective
    per axis), the groups added in sorted order."""
    groups: Dict[tuple, list] = {}
    for k, g in grads.items():
        axes = tuple(sorted(a for a in specs.get(k, ()) if a is not None))
        groups.setdefault(axes, []).append(g.float().pow(2).sum())
    total = None
    for axes in sorted(groups):
        s = torch.stack(groups[axes]).sum()
        for a in axes:
            s = pmesh.axis_ring(a).all_reduce_sum(s)
        total = s if total is None else total + s
    return torch.sqrt(total)
