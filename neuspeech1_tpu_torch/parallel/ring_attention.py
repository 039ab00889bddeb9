"""Ring (sequence-parallel) flash self-attention: the port of
``neuspeech1_tpu/parallel/ring_attention.py``.

The sequence dim of non-causal self-attention is split over the n ranks of
a ``Ring``. Each rank keeps its q shard while the K/V shards and their bias
rows travel one hop per round (``Ring.permute``: to rank + 1, from rank - 1,
as ``lax.ppermute`` with the JAX package's ``_ring_perm``):

  forward   round r: (o_r, lse_r) = K4's forward on the block in hand, with
            the block's explicit bias row (``ops/flash_attention.py::
            flash_bias_fwd``); the partials merge in f32 log space:
              lse = logaddexp(lse_a, lse_b)
              o   = o_a exp(lse_a - lse) + o_b exp(lse_b - lse)
            A fully masked block gives o = NaN with weight exp(-inf) = 0;
            the merge gates those terms on lse == -inf.
  backward  round r: K4's backward against the block in hand with the GLOBAL
            lse and o, so each block's grads are partial sums of the global
            ones; dq accumulates locally in f32, dk and dv ride the ring
            with their block and arrive home after n hops.

Rings: ``DistRing`` over a ``torch.distributed`` process group (its hops
of CUDA tensors over gloo, which sends host tensors only, go through
pinned host memory and are counted in the ``ring.staged_*`` counters), and
``LocalRing``, n ranks as n Python threads on one device, the counterpart of
the JAX tests' virtual CPU mesh (``LocalRing.run_mesh`` builds a grid of
them, one ring per mesh axis). Besides the hop to rank + 1 a ring has the
reverse hop (``permute_back``, the pipeline's backward), an all-gather, a
sum and a reduce-scatter (FSDP and tensor parallelism,
``parallel/sharding.py``), a broadcast, a barrier and a gather of host
objects. A ``LocalRing`` of CUDA tensors refuses to exchange inside
autograd's backward: its threads' backward passes would all run on the
device's one autograd worker thread and wait on each other until the
barrier's timeout. A ring of one communicates nothing in
``permute``. The JAX shard contract is kept on purpose, so that both
packages pad alike: T % n == 0, T / n a multiple of 128, D in {32, 64, 128}.

Entry points: ``ring_flash_attention`` on global [B, T, H, D] tensors (each
rank takes its shard and gathers the output), ``ring_attention_local`` on a
rank's own [B, T/n, H, D] shard (the encoder), and the bodies ``ring_fwd`` and
``ring_bwd``, which a caller that cannot run autograd's backward per rank
(CUDA runs a device's backward nodes on one worker thread, so LocalRing's
threads would wait on each other there) calls directly.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from neuspeech1_tpu_torch.ops import flash_attention as fa
from neuspeech1_tpu_torch.train.profiling import count

# the shard quantum of the sequence dim (the JAX package's 128-lane block)
SHARD_QUANTUM = 128
# the longest a LocalRing rank waits for the others at one exchange: a rank
# that never arrives (a deadlock, a rank stuck elsewhere) breaks the barrier
# instead of hanging the process
BARRIER_TIMEOUT_S = 600.0


class Ring:
    """The ranks 0..size-1 of one ring; this object is rank ``rank``."""

    rank: int
    size: int

    def permute(self, *tensors) -> tuple:
        """Sends each tensor to rank + 1 and returns those of rank - 1."""
        raise NotImplementedError

    def permute_back(self, *tensors) -> tuple:
        """Sends each tensor to rank - 1 and returns those of rank + 1."""
        raise NotImplementedError

    def all_gather(self, x, dim: int):
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        raise NotImplementedError

    def all_reduce_sum(self, x):
        """The sum of every rank's ``x``, the same on every rank."""
        raise NotImplementedError

    def reduce_scatter_sum(self, x, dim: int):
        """This rank's block of the sum of every rank's ``x``: the sum cut
        into ``size`` equal blocks along ``dim`` (which ``size`` divides),
        block ``rank`` (the backward of `all_gather`)."""
        raise NotImplementedError

    def broadcast(self, x, src: int):
        """Rank ``src``'s ``x`` on every rank (the others' ``x`` gives the
        shape and dtype)."""
        raise NotImplementedError

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        raise NotImplementedError

    def barrier(self) -> None:
        """Returns once every rank has called it."""
        raise NotImplementedError


class DistRing(Ring):
    """A ring over a ``torch.distributed`` process group (NCCL on the card,
    gloo on the CPU): ``permute`` is one ``batch_isend_irecv`` of a send and
    a receive per tensor, ``all_gather`` the dim-0 collective into a flat
    buffer, ``all_reduce_sum`` ``all_reduce``."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)

    def permute(self, *tensors) -> tuple:
        return self._shift(tensors, 1)

    def permute_back(self, *tensors) -> tuple:
        return self._shift(tensors, -1)

    def _shift(self, tensors, hop: int) -> tuple:
        """Sends each tensor to rank + hop; returns those of rank - hop.
        CUDA tensors on a gloo group go through pinned host memory
        (`_staged_shift`): gloo sends and receives host tensors only."""
        if self.size == 1:
            return tensors
        if host_staged(self.group, tensors):
            return _staged_shift(self, tensors, hop)
        return self._send_recv(tensors, hop)

    def _send_recv(self, tensors, hop: int, outs=None) -> tuple:
        """One ``batch_isend_irecv`` of a send to rank + hop and a receive
        from rank - hop per tensor, into ``outs`` (default: new tensors
        like ``tensors``)."""
        import torch.distributed as dist

        dst = dist.get_global_rank(self.group, (self.rank + hop) % self.size)
        src = dist.get_global_rank(self.group, (self.rank - hop) % self.size)
        if outs is None:
            outs = tuple(torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in tensors)
        ops = []
        for t, out in zip(tensors, outs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, self.group))
            ops.append(dist.P2POp(dist.irecv, out, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def all_gather(self, x, dim: int):
        import torch.distributed as dist

        x = x.contiguous()
        # a flat [n * B, ...] buffer: gloo refuses an [n, B, ...] one
        flat = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        # the name torch 2.11 and later versions both accept
        dist.all_gather_into_tensor(flat, x, group=self.group)
        parts = flat.view(self.size, *x.shape).movedim(0, dim)
        return parts.flatten(dim, dim + 1)

    def all_reduce_sum(self, x):
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def reduce_scatter_sum(self, x, dim: int):
        import torch.distributed as dist

        if self.size == 1:
            return x
        # the blocks along dim 0, as the collective splits its input
        flat = x.movedim(dim, 0).contiguous()
        out = flat.new_empty((flat.shape[0] // self.size, *flat.shape[1:]))
        dist.reduce_scatter_tensor(out, flat, group=self.group)
        return out.movedim(0, dim)

    def broadcast(self, x, src: int):
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, dist.get_global_rank(self.group, src),
                       group=self.group)
        return out

    def gather_objects(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)


def host_staged(group, tensors) -> bool:
    """Whether a hop of ``tensors`` over ``group`` stages them through
    host memory: CUDA tensors on a gloo group. Under NCCL the hop stays a
    send and receive on the device."""
    import torch.distributed as dist

    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == dist.Backend.GLOO)


def _pinned(t):
    """An empty pinned host tensor of ``t``'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _synchronize(t) -> None:
    """Waits until the work queued on ``t``'s device stream is done."""
    torch.cuda.current_stream(t.device).synchronize()


def _staged_shift(ring: "DistRing", tensors, hop: int) -> tuple:
    """`DistRing._shift` of device tensors over gloo: each tensor copied to
    pinned host memory, the host copies sent and received, the received
    ones copied back to the tensor's device. Counted always, tracing or
    not (``train/profiling.py::count``): ``ring.staged_hops``,
    ``ring.staged_bytes`` sent, and ``ring.staged_ms`` on the host clock,
    from the device's stream being idle to the received tensors being back
    on the device."""
    _synchronize(tensors[0])
    t0 = time.perf_counter()
    sends = tuple(_pinned(t).copy_(t) for t in tensors)
    outs = ring._send_recv(sends, hop, tuple(_pinned(t) for t in tensors))
    outs = tuple(o.to(t.device) for o, t in zip(outs, tensors))
    count("ring.staged_hops", always=True)
    count("ring.staged_bytes",
          sum(t.numel() * t.element_size() for t in tensors), always=True)
    count("ring.staged_ms", 1e3 * (time.perf_counter() - t0), always=True)
    return outs


class _LocalState:
    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=BARRIER_TIMEOUT_S)
        self.slots: List[object] = [None] * n


def _total(parts):
    """The sum of ``parts`` in list order."""
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def _on_cuda(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    return isinstance(value, (tuple, list)) and any(map(_on_cuda, value))


def check_backward(ring: Ring, value) -> None:
    """Raises for a collective of CUDA tensors on a ``LocalRing`` of more
    than one rank: called where such a collective would run inside
    autograd's backward. A device runs every thread's backward on its one
    autograd worker thread, so the ranks would wait on each other until
    the barrier's timeout. Run such a step one process per rank
    (``DistRing``), or call the backward bodies directly."""
    if isinstance(ring, LocalRing) and ring.size > 1 and _on_cuda(value):
        raise RuntimeError(
            "a collective inside autograd's backward on a LocalRing of CUDA "
            "tensors would deadlock (one autograd worker thread per device "
            "runs every rank's backward): run the ranks as processes over "
            "torch.distributed (DistRing)")


class LocalRing(Ring):
    """n ranks as n Python threads of one process, on one device, meeting at
    a barrier: the port's counterpart of the virtual CPU mesh the JAX tests
    run on. Tensors pass by reference (every thread uses the device's
    default stream, so work stays in the order it was queued). Sums are
    taken in rank order on every rank, so they are equal bit for bit. Used
    by tests and ``chip_smoke.py``, never by an entry point."""

    def __init__(self, state: _LocalState, rank: int):
        self._state = state
        self.rank = rank
        self.size = state.n

    def _exchange(self, value, combine: Callable[[list], object]):
        """Posts ``value``, then returns ``combine(every rank's value)``,
        computed before any rank may post again. Raises inside autograd's
        backward when ``value`` holds a CUDA tensor (`check_backward`)."""
        if self.size > 1 and torch._C._current_graph_task_id() != -1:
            check_backward(self, value)
        st = self._state
        st.slots[self.rank] = value
        st.barrier.wait()
        out = combine(list(st.slots))
        st.barrier.wait()
        return out

    def permute(self, *tensors) -> tuple:
        if self.size == 1:
            return tensors
        return self._exchange(tensors, lambda s: s[(self.rank - 1) % self.size])

    def permute_back(self, *tensors) -> tuple:
        if self.size == 1:
            return tensors
        return self._exchange(tensors, lambda s: s[(self.rank + 1) % self.size])

    def all_gather(self, x, dim: int):
        return self._exchange(x, lambda s: torch.cat(s, dim))

    def all_reduce_sum(self, x):
        return self._exchange(x, _total)

    def reduce_scatter_sum(self, x, dim: int):
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        # the block of the rank-order sum: the bits of all_reduce_sum's
        return self._exchange(x, lambda s: _total(s).narrow(
            dim, self.rank * n, n).contiguous())

    def broadcast(self, x, src: int):
        # a copy per rank: each rank's result is its own tensor
        return self._exchange(x, lambda s: s[src].clone())

    def gather_objects(self, obj) -> list:
        return self._exchange(obj, list)

    def barrier(self) -> None:
        self._exchange(None, lambda s: None)

    @staticmethod
    def run(fn: Callable[[Ring], object], n: int) -> list:
        """Runs ``fn(ring)`` for ranks 0..n-1 in n threads; returns their
        results in rank order. If one rank raises, the barrier is broken so
        that the others stop too, and the first error is raised; a rank
        that waits longer than BARRIER_TIMEOUT_S at an exchange breaks it
        as well."""
        return LocalRing.run_mesh(lambda mesh: fn(mesh["ring"]), ring=n)

    @staticmethod
    def run_mesh(fn: Callable[[Dict[str, Ring]], object], **axes: int
                 ) -> list:
        """Runs ``fn(mesh)`` in one thread per point of the grid of
        ``axes`` (sizes by name, the first the slowest-varying, as a
        ``DeviceMesh``'s dims): ``mesh`` is ``{axis: LocalRing}``, each ring
        holding the threads that share every other coordinate, the mapping
        ``parallel/mesh.py::set_mesh`` takes. Returns the results in
        row-major order of the grid; errors as `run`."""
        names, sizes = tuple(axes), tuple(axes.values())
        n = math.prod(sizes)
        coords = list(itertools.product(*(range(s) for s in sizes)))
        states: Dict[tuple, _LocalState] = {}
        for c in coords:
            for i, name in enumerate(names):
                key = (name,) + c[:i] + c[i + 1:]
                if key not in states:
                    states[key] = _LocalState(sizes[i])
        results: List[object] = [None] * n
        errors: List[Exception] = []

        def body(t):
            c = coords[t]
            mesh = {name: LocalRing(states[(name,) + c[:i] + c[i + 1:]],
                                    c[i]) for i, name in enumerate(names)}
            try:
                results[t] = fn(mesh)
            except Exception as e:  # re-raised in the caller's thread below
                errors.append(e)
                for st in states.values():
                    st.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            first = next((e for e in errors
                          if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0])
            raise first
        return results


# --------------------------------------------------------------------------
# the ring's math
# --------------------------------------------------------------------------

def _weighted(o, w):
    """o [B, T, H, D] times per-(b, h, t) weights w [B, H, T], zero-gated so
    that the NaN rows of a fully masked partial (weight 0) add nothing."""
    w = w.transpose(1, 2)[..., None]
    return torch.where(w > 0, o * w, 0.0)


def merge(o, lse, o_r, lse_r):
    """Merges two normalised partials (o [B, T, H, D] f32, lse [B, H, T])
    in log space (the JAX package's ``_merge``)."""
    new_lse = torch.logaddexp(lse, lse_r)
    # -inf - -inf = nan where a row is masked in both partials: weight 0
    ninf = float("-inf")
    w_old = torch.where(lse == ninf, 0.0, torch.exp(lse - new_lse))
    w_new = torch.where(lse_r == ninf, 0.0, torch.exp(lse_r - new_lse))
    return _weighted(o, w_old) + _weighted(o_r, w_new), new_lse


def _kernels(on: bool):
    """K4's entries, or its plain versions (``flash_attention: "off"``)."""
    if on:
        return fa.flash_bias_fwd, fa.flash_bias_bwd
    return fa.flash_bias_fwd_plain, fa.flash_bias_bwd_plain


def ring_fwd(q, k, v, bias, ring: Ring, kernels: bool = True):
    """The forward body on a rank's shard: q, k, v [B, T/n, H, D] and this
    rank's bias row [T/n] f32 -> (o in q's dtype, global lse [B, H, T/n]
    f32). n rounds of K4's forward."""
    fwd, _ = _kernels(kernels)
    b, t_loc, h, d = q.shape
    o = torch.zeros((b, t_loc, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t_loc), float("-inf"), device=q.device)
    for r in range(ring.size):
        o_r, lse_r = fwd(q, k, v, bias)
        o, lse = merge(o, lse, o_r.float(), lse_r)
        if r < ring.size - 1:
            k, v, bias = ring.permute(k, v, bias)
    return o.to(q.dtype), lse


def ring_bwd(q, k, v, bias, o, lse, do, ring: Ring, kernels: bool = True):
    """The backward body: (dq, dk, dv) in q's dtype for this rank's shard,
    from the forward's global o and lse and the output gradient do. n
    rounds of K4's backward; dk and dv come home with their block."""
    _, bwd = _kernels(kernels)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for r in range(ring.size):
        dq_r, dk_r, dv_r = bwd(q, k, v, o, do, lse, bias)
        dq = dq + dq_r.float()
        dk = dk + dk_r.float()
        dv = dv + dv_r.float()
        # after the last round only the grads still have a hop to make
        if r < ring.size - 1:
            k, v, bias, dk, dv = ring.permute(k, v, bias, dk, dv)
        else:
            dk, dv = ring.permute(dk, dv)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class RingAttention(torch.autograd.Function):
    """o = RingAttention.apply(q, k, v, bias, ring, kernels): `ring_fwd`
    saving q, k, v, bias, o and the global lse, `ring_bwd` for the grads
    (the JAX package's ``custom_vjp`` ``_ring``). The bias gets none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, ring, kernels):
        o, lse = ring_fwd(q, k, v, bias, ring, kernels)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.ring, ctx.kernels = ring, kernels
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_bwd(q, k, v, bias, o, lse, do.contiguous(),
                              ctx.ring, ctx.kernels)
        return dq, dk, dv, None, None, None


def _check_head_dim(d: int) -> None:
    if d not in fa.HEAD_DIMS:
        raise ValueError(f"d_head {d} unsupported (ring attention takes "
                         f"{fa.HEAD_DIMS})")


def shard_bias(t_loc: int, rank: int, kv_valid_len: Optional[int], device):
    """This rank's bias row [t_loc] f32: 0 where the global position is below
    ``kv_valid_len``, ``NEG_INF`` at or past it."""
    pos = rank * t_loc + torch.arange(t_loc, device=device)
    limit = rank * t_loc + t_loc if kv_valid_len is None else kv_valid_len
    return torch.where(pos < limit, 0.0, fa.NEG_INF).to(torch.float32)


def ring_attention_local(q, k, v, ring: Ring,
                         kv_valid_len: Optional[int] = None,
                         kernels: bool = True):
    """Ring attention on this rank's shard: q, k, v [B, T/n, H, D] (rank r
    holds global rows r T/n .. (r+1) T/n - 1) -> o [B, T/n, H, D] in q's
    dtype. Key rows at global positions >= ``kv_valid_len`` are masked.
    Differentiable through `RingAttention` when an input requires grad.
    ``kernels=False`` runs K4's plain versions on any device."""
    t_loc, d = q.shape[1], q.shape[3]
    _check_head_dim(d)
    if t_loc % SHARD_QUANTUM:
        raise ValueError(f"local sequence shard {t_loc} must be a multiple of "
                         f"the {SHARD_QUANTUM}-row shard quantum")
    bias = shard_bias(t_loc, ring.rank, kv_valid_len, q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return RingAttention.apply(q, k, v, bias, ring, kernels)
    return ring_fwd(q, k, v, bias, ring, kernels)[0]


class _ShardSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        t = x.shape[1] // ring.size
        return x[:, ring.rank * t:(ring.rank + 1) * t].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.all_gather(g.contiguous(), 1), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.all_gather(x.contiguous(), 1)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        t = g.shape[1] // ring.size
        return g[:, ring.rank * t:(ring.rank + 1) * t].contiguous(), None


def shard_seq(x, ring: Ring):
    """This rank's slice of dim 1 of ``x``, the same on every rank. Its
    backward all-gathers the gradient: every rank's slice of it."""
    return x if ring.size == 1 else _ShardSeq.apply(x, ring)


def gather_seq(x, ring: Ring):
    """Every rank's ``x`` concatenated along dim 1. Its backward takes this
    rank's slice of the gradient, which every rank holds whole."""
    return x if ring.size == 1 else _GatherSeq.apply(x, ring)


def ring_flash_attention(q, k, v, ring: Ring,
                         kv_valid_len: Optional[int] = None):
    """Sequence-parallel non-causal self-attention on global q, k, v [B, T,
    H, D], the same on every rank (the JAX entry's GLOBAL arrays): each rank
    takes its shard, runs the ring, and gathers the output [B, T, H, D].
    Rows at positions >= ``kv_valid_len`` are masked out of the attention.
    Differentiable; the grads of q, k, v come back whole on every rank."""
    t, d = q.shape[1], q.shape[3]
    _check_head_dim(d)
    n = ring.size
    if t % n:
        raise ValueError(f"T={t} not divisible by the ring's {n} ranks")
    if (t // n) % SHARD_QUANTUM:
        raise ValueError(f"local sequence shard {t // n} must be a multiple "
                         f"of the {SHARD_QUANTUM}-row shard quantum")
    q_l, k_l, v_l = (shard_seq(x, ring) for x in (q, k, v))
    o = ring_attention_local(q_l, k_l, v_l, ring, kv_valid_len)
    return gather_seq(o, ring)

