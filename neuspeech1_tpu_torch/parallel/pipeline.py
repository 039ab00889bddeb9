"""GPipe pipeline parallelism over a ``Ring``: the port of
``neuspeech1_tpu/parallel/pipeline.py`` (``pipeline_scan``).

A homogeneous stack of L layers is split over the P ranks of a ring along
the pipeline axis: stage s runs layers [s L/P, (s+1) L/P). The batch is cut
into M microbatches of B/M contiguous rows (M defaults to P), which flow
through the stages in the classic microbatch ring:

  forward   tick t = 0 .. M+P-2: stage s runs its layers on microbatch
            t - s when that is one (stage 0 takes it from the batch, the
            others from what the previous stage sent last tick), then every
            stage sends its activation one hop on (``Ring.permute``). The
            last stage keeps the outputs; they are broadcast to every rank.
  backward  the ticks in reverse: stage s receives the gradient of its
            output for microbatch t - s from stage s+1 (``Ring.permute_back``;
            the last stage takes the output gradient), runs
            ``torch.autograd.backward`` on that tick's outputs, and sends
            the gradient of the tick's input back. Stage 0's input
            gradients are broadcast to every rank.

Each tick's stage runs on leaves detached from the caller's tensors, so
each tick's graph is the stage's alone: the hops happen between the
``torch.autograd.backward`` calls, never inside one. That is what lets the
ranks of a ``LocalRing`` on one CUDA device (whose autograd runs every
backward node on one worker thread) run the schedule: `pipeline_fwd` and
`pipeline_bwd` are its plain bodies. `pipeline` wraps them in an autograd
Function for the CPU and for a ``DistRing``, where collectives may run
inside a backward.

The body may run collectives of its own on other rings of the mesh: ring
attention's rounds over ``seq`` (SP inside the stages), FSDP's weight
gathers and tensor parallelism's sums, and in a tick's
``torch.autograd.backward`` their backward collectives (the ring's K/V
rounds and dk/dv hops, FSDP's reduce-scatters, tensor parallelism's "f").
Those rings join ranks of one pipe coordinate, which run the same
schedule: the same ticks, the same microbatches, idle at the same ticks,
so their collectives meet in the same order. A ``LocalRing`` of CUDA
tensors refuses the backward ones (``ring_attention.py::check_backward``);
on the card such a stage runs one process per rank.

The bubble is (P-1)/(M+P-1). Unlike the JAX schedule the idle ticks run no
layers (JAX runs them on zeros and never reads the result). The layers'
weights stay whole on every rank (the caller passes every layer; each rank
reads its own stage's): the gradients of a stage's layers land on that
stage only, and the training step sums them over the ring. Per-sample
constants (``sample_consts``, [B, ...], such as the decoder's encoder
states) are sliced per microbatch on each stage and never ride the ring;
their gradients are summed over the ring. ``consts`` (such as a causal
mask) take no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from neuspeech1_tpu_torch.parallel.ring_attention import Ring


def check_schedule(n_layers: int, n_stages: int, batch: int,
                   num_microbatches: Optional[int] = None,
                   sample_consts: Sequence[torch.Tensor] = ()) -> int:
    """M, the microbatch count (``num_microbatches`` or P); raises the JAX
    package's ValueErrors for a depth P does not divide, a batch M does not
    divide, or a per-sample constant of another batch."""
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {n_stages} pipeline stages")
    m = num_microbatches or n_stages
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    for c in sample_consts:
        if c.shape[0] != batch:
            raise ValueError(
                f"sample_consts leaf batch {c.shape[0]} != carry batch {batch}")
    return m


def stage_layers(xs: Sequence[Any], ring: Ring) -> list:
    """The layers of this rank's stage: xs[s L/P : (s+1) L/P]."""
    per = len(xs) // ring.size
    return list(xs[ring.rank * per:(ring.rank + 1) * per])


@dataclasses.dataclass
class Saved:
    """What `pipeline_bwd` needs of a `pipeline_fwd` run: the ring, the
    microbatch count, the stage's leaves in flatten order, and per
    microbatch this stage ran: (input leaf, per-sample constant leaves,
    output)."""

    ring: Ring
    m: int
    leaves: list
    ticks: dict
    sample_consts: list
    batch_shape: tuple


def _leaf(t, grad: bool):
    if not isinstance(t, torch.Tensor):
        return t
    return t.detach().requires_grad_(grad and t.requires_grad)


def pipeline_fwd(body: Callable, stage_xs: Sequence[Any], h: torch.Tensor,
                 ring: Ring, num_microbatches: int, consts: Sequence = (),
                 sample_consts: Sequence[torch.Tensor] = ()):
    """The forward schedule on this rank's stage: ``stage_xs`` are its
    layers' pytrees, ``h`` the whole [B, ...] batch (read on stage 0).
    ``body(carry, layer_xs, *sample_consts_mb, *consts) -> carry``.
    Returns (the stack's output [B, ...] on every rank, `Saved`). With
    grad mode on it records each tick's graph for `pipeline_bwd`."""
    s, p, m = ring.rank, ring.size, num_microbatches
    grad = torch.is_grad_enabled()
    flat, spec = tree_flatten(list(stage_xs))
    leaves = [_leaf(t, grad) for t in flat]
    layers = tree_unflatten(leaves, spec)
    hm = h.reshape(m, h.shape[0] // m, *h.shape[1:])
    scm = [c.reshape(m, c.shape[0] // m, *c.shape[1:]) for c in sample_consts]
    ticks, outs, recv = {}, [None] * m, None
    for t in range(m + p - 1):
        mb = t - s
        if 0 <= mb < m:
            x = (hm[mb] if s == 0 else recv).detach().requires_grad_(grad)
            sc = [_leaf(c[mb], grad) for c in scm]
            y = x
            for layer in layers:
                y = body(y, layer, *sc, *consts)
            ticks[mb] = (x, sc, y)
            send = y.detach()
            if s == p - 1:
                outs[mb] = send
        else:
            send = torch.zeros_like(hm[0])
        if t < m + p - 2:
            (recv,) = ring.permute(send)
    out = torch.cat(outs) if s == p - 1 else torch.zeros_like(h)
    out = ring.broadcast(out, p - 1)
    return out, Saved(ring, m, leaves, ticks, list(sample_consts),
                      tuple(h.shape))


def pipeline_bwd(saved: Saved, g_out: torch.Tensor):
    """The backward schedule: from the output gradient [B, ...] (the same
    on every rank) to (the input's gradient on every rank, the per-sample
    constants' gradients summed over the ring, the stage leaves' gradients
    in flatten order, None where a leaf takes none)."""
    ring, m = saved.ring, saved.m
    s, p = ring.rank, ring.size
    gm = g_out.reshape(m, g_out.shape[0] // m, *g_out.shape[1:])
    dx: List[Optional[torch.Tensor]] = [None] * m
    dsc = [[None] * m for _ in saved.sample_consts]
    send = None
    for u in range(m + p - 1):
        mb = m + p - 2 - u - s
        if u > 0:
            (recv,) = ring.permute_back(send)
        if 0 <= mb < m:
            x, sc, y = saved.ticks.pop(mb)
            gy = gm[mb] if s == p - 1 else recv
            if y.requires_grad:
                torch.autograd.backward(y, gy)
            send = x.grad if x.grad is not None else torch.zeros_like(x)
            dx[mb] = send
            for i, c in enumerate(sc):
                dsc[i][mb] = (c.grad if c.grad is not None
                              else torch.zeros_like(c))
        else:
            send = torch.zeros_like(gm[0])
    dh = torch.cat(dx) if s == 0 else g_out.new_zeros(saved.batch_shape)
    dh = ring.broadcast(dh, 0)
    d_sample = []
    for c, parts in zip(saved.sample_consts, dsc):
        local = (torch.cat(parts) if all(x is not None for x in parts)
                 else torch.zeros_like(c))
        d_sample.append(ring.all_reduce_sum(local))
    d_leaves = [t.grad if isinstance(t, torch.Tensor) else None
                for t in saved.leaves]
    return dh, d_sample, d_leaves


# marks the places of the stage's tensors among its flat leaves
_TENSOR = object()


@dataclasses.dataclass
class _Plan:
    body: Callable
    spec: Any
    others: list  # the flat stage leaves, _TENSOR where a tensor is passed
    ring: Ring
    m: int
    consts: tuple
    n_sample: int


class _Pipeline(torch.autograd.Function):
    """out = _Pipeline.apply(plan, h, *sample_consts, *stage_tensors):
    `pipeline_fwd` recording each tick's graph, `pipeline_bwd` for the
    gradients of h, the per-sample constants and the stage's tensors."""

    @staticmethod
    def forward(ctx, plan, h, *tensors):
        sample = tensors[:plan.n_sample]
        it = iter(tensors[plan.n_sample:])
        flat = [next(it) if o is _TENSOR else o for o in plan.others]
        stage_xs = tree_unflatten(flat, plan.spec)
        with torch.enable_grad():
            out, saved = pipeline_fwd(plan.body, stage_xs, h, plan.ring,
                                      plan.m, plan.consts, sample)
        ctx.saved = saved
        ctx.tensor_pos = [i for i, o in enumerate(plan.others)
                          if o is _TENSOR]
        return out

    @staticmethod
    def backward(ctx, g):
        dh, d_sample, d_leaves = pipeline_bwd(ctx.saved, g.contiguous())
        del ctx.saved
        return (None, dh, *d_sample, *(d_leaves[i] for i in ctx.tensor_pos))


def pipeline(body: Callable, xs: Sequence[Any], h: torch.Tensor, ring: Ring,
             num_microbatches: Optional[int] = None, consts: Sequence = (),
             sample_consts: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """``for layer in xs: h = body(h, layer, *sample_consts, *consts)``,
    pipeline-parallel over ``ring`` (the JAX ``pipeline_scan``). ``xs``:
    one pytree per layer, every layer on every rank; ``h``: [B, ...].
    Differentiable in ``h``, the per-sample constants and the tensors of
    this rank's stage. P = 1 is the plain loop."""
    m = check_schedule(len(xs), ring.size, h.shape[0], num_microbatches,
                       sample_consts)
    if ring.size == 1:
        for layer in xs:
            h = body(h, layer, *sample_consts, *consts)
        return h
    if not torch.is_grad_enabled():
        return pipeline_fwd(body, stage_layers(xs, ring), h, ring, m, consts,
                            sample_consts)[0]
    flat, spec = tree_flatten(stage_layers(xs, ring))
    tensors = [t for t in flat if isinstance(t, torch.Tensor)]
    others = [_TENSOR if isinstance(t, torch.Tensor) else t for t in flat]
    plan = _Plan(body, spec, others, ring, m, tuple(consts),
                 len(sample_consts))
    return _Pipeline.apply(plan, h, *sample_consts, *tensors)
