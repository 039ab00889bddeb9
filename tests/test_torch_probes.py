"""The port's probe functions (neuspeech1_tpu_torch/perf/*, on the CPU their
plain versions in ops/probe_fwd.py, probe_bwd.py, probe_dot.py) against the
JAX package's TPU tuning probes under perf/, run through their own Pallas
bodies in interpret mode on the same seeded inputs.

perf/kernel_probe.py and perf/mxu_probe.py run their TPU sweeps when they
are imported, so no probe module is imported: each file is parsed and only
its ``make_*`` definitions are executed, into a namespace holding small
module constants and a ``pl`` whose ``pallas_call`` runs in interpret mode
(without the TPU-only ``compiler_params``)."""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from neuspeech1_tpu_torch.ops import probe_bwd as tpb
from neuspeech1_tpu_torch.ops import probe_fwd as tpf
from neuspeech1_tpu_torch.perf import btc_probe, bwd_probe, kernel_probe
from neuspeech1_tpu_torch.perf import mxu_probe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, T, TK, D = 1, 4, 200, 256, 64
BQ = 128  # the TPU probes' block_q here: two q blocks of TK
RTOL, ATOL = 1e-4, 2e-4  # f32 inputs
BF16_REL = 1e-2          # bf16 roundings: of the largest |value|


class _InterpretPl:
    """``pl`` with ``pallas_call`` in interpret mode, without the TPU-only
    ``compiler_params``."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        kw.pop("compiler_params", None)
        return pl.pallas_call(*args, interpret=True, **kw)


def _probe(name):
    """The ``make_*`` functions of perf/<name>.py, bound to small constants."""
    path = os.path.join(REPO, "perf", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("make_")]
    ns = dict(jax=jax, jnp=jnp, np=np, functools=functools, pl=_InterpretPl(),
              pltpu=pltpu, NEG_INF=-1e30, B=B, H=H, T=T, TK=TK, D=D,
              C=H * D, HP=2 * D)
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return {n.name: ns[n.name] for n in defs}


@pytest.fixture(scope="module")
def probes():
    return {name: _probe(name) for name in
            ("kernel_probe", "mxu_probe", "btc_probe", "bwd_probe")}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(ours, ref, bf16=False):
    ours = np.asarray(torch.as_tensor(ours).float())
    ref = np.asarray(ref, np.float32)
    if bf16:
        assert np.abs(ours - ref).max() <= BF16_REL * np.abs(ref).max()
    else:
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def _fwd(fn, arrays):
    return fn(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("mode", kernel_probe.MODES)
@pytest.mark.parametrize("block_q", [256, 512])
def test_make_kernel_matches_probe(probes, mode, block_q):
    qkv = _inputs(0, *[(B * H, TK, D)] * 3)
    ref = probes["kernel_probe"]["make_kernel"](mode, BQ)(
        *(jnp.asarray(a) for a in qkv))
    ours = _fwd(kernel_probe.make_kernel(mode, block_q, t_valid=T), qkv)
    _close(ours, ref, bf16=mode == "bf16exp")


@pytest.mark.parametrize("n_kb", [2, 4])
def test_make_online_matches_probe_and_base(probes, n_kb):
    qkv = _inputs(1, *[(B * H, TK, D)] * 3)
    ref = probes["kernel_probe"]["make_online"](BQ, n_kb)(
        *(jnp.asarray(a) for a in qkv))
    ours = _fwd(kernel_probe.make_online(512, n_kb, t_valid=T), qkv)
    _close(ours, ref)
    _close(ours, _fwd(kernel_probe.make_kernel("base", 512, t_valid=T), qkv))


@pytest.mark.parametrize("sem", [("parallel", "parallel"),
                                 ("parallel", "arbitrary")])
def test_make_semantics_matches_probe_and_base(probes, sem):
    qkv = _inputs(2, *[(B * H, TK, D)] * 3)
    ref = probes["kernel_probe"]["make_semantics"](BQ, sem)(
        *(jnp.asarray(a) for a in qkv))
    ours = _fwd(kernel_probe.make_semantics(512, sem, t_valid=T), qkv)
    _close(ours, ref)
    _close(ours, _fwd(kernel_probe.make_kernel("base", 512, t_valid=T), qkv))


def test_nomask_differs_from_base():
    qkv = _inputs(3, *[(B * H, TK, D)] * 3)
    base = _fwd(kernel_probe.make_kernel("base", 512, t_valid=T), qkv)
    nomask = _fwd(kernel_probe.make_kernel("nomask", 512, t_valid=T), qkv)
    assert (base - nomask).abs().max() > 100 * ATOL


@pytest.mark.parametrize("n_sub", [1, 2, 4])
def test_make_fwd_matches_probe_and_base(probes, n_sub):
    qkv = _inputs(4, *[(B * H, TK, D)] * 3)
    ref = probes["mxu_probe"]["make_fwd"](BQ, n_sub)(
        *(jnp.asarray(a) for a in qkv))
    ours = _fwd(mxu_probe.make_fwd(512, n_sub, t_valid=T), qkv)
    _close(ours, ref)
    _close(ours, _fwd(kernel_probe.make_kernel("base", 512, t_valid=T), qkv))


@pytest.mark.parametrize("kdim", [64, 128])
def test_make_dot_matches_probe(probes, kdim):
    a, b = _inputs(5, (2, 512, kdim), (2, kdim, TK))
    ref = probes["mxu_probe"]["make_dot"](kdim, 2)(jnp.asarray(a),
                                                  jnp.asarray(b))
    ours = mxu_probe.make_dot(kdim, 2)(torch.from_numpy(a),
                                       torch.from_numpy(b))
    assert ours.dtype == torch.bfloat16
    _close(ours, ref, bf16=True)


@pytest.mark.parametrize("sem", [None, ("parallel", "parallel", "arbitrary"),
                                 ("arbitrary", "arbitrary", "arbitrary")])
def test_make_fwd_btc_matches_probe(probes, sem):
    """o and lse on [B, TK, H*64]: the port's lse [B, H, TK] against the
    TPU layout's first of 8 replicated rows per head."""
    qkv = _inputs(6, *[(B, TK, H * D)] * 3)
    jq = [jnp.asarray(a) for a in qkv]
    if sem is None:
        ref_o, ref_lse = probes["btc_probe"]["make_fwd_btc"](BQ)(*jq)
        o, lse = _fwd(btc_probe.make_fwd_btc(512, t_valid=T), qkv)
    else:
        ref_o, ref_lse = probes["btc_probe"]["make_fwd_btc_sem"](BQ, sem)(*jq)
        o, lse = _fwd(btc_probe.make_fwd_btc_sem(512, sem, t_valid=T), qkv)
    assert tuple(lse.shape) == (B, H, TK)
    _close(o, ref_o)
    _close(lse, np.asarray(ref_lse)[:, ::8])
    base_o, base_lse = _fwd(btc_probe.make_fwd_btc(256, t_valid=T), qkv)
    _close(o, base_o)
    _close(lse, base_lse)
    # the same function as the [B*H, TK, 64] forward
    heads = [tpf.heads_view(torch.from_numpy(a), True) for a in qkv]
    _close(tpf.heads_view(o, True),
           kernel_probe.make_kernel("base", 512, t_valid=T)(*heads))


def _bwd_inputs(seed, shape, lse_shape):
    arrays = _inputs(seed, *[shape] * 5)
    lse = (np.random.default_rng(seed + 100).standard_normal(lse_shape)
           * 0.1 + 8.0).astype(np.float32)
    return arrays, lse


@pytest.mark.parametrize("bf16_ops", [False, True])
@pytest.mark.parametrize("block_q", [256, 512])
def test_make_bwd_matches_probe(probes, bf16_ops, block_q):
    """The backward from the given lse: the probe reads row 0 of its 8
    replicated rows, the port takes that row."""
    arrays, lse8 = _bwd_inputs(7, (B * H, TK, D), (B * H, 8, TK))
    lse8[:] = lse8[:, :1]
    ref = probes["bwd_probe"]["make_bwd"](BQ, bf16_ops=bf16_ops)(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(lse8))
    ours = bwd_probe.make_bwd(block_q, bf16_ops=bf16_ops, t_valid=T)(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(lse8[:, 0]))
    for g, r in zip(ours, ref):
        _close(g, r, bf16=bf16_ops)
    # masked keys get no gradient
    assert not ours[1][:, T:].any() and not ours[2][:, T:].any()


@pytest.mark.parametrize("block_q", [512, 192])
def test_make_bwd_btc_matches_probe(probes, block_q):
    arrays, lse8 = _bwd_inputs(8, (B, TK, H * D), (B, 8 * H, TK))
    lse8 = np.repeat(lse8[:, ::8], 8, axis=1)
    ref = probes["btc_probe"]["make_bwd_btc"](BQ)(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(lse8))
    ours = btc_probe.make_bwd_btc(block_q, t_valid=T)(
        *(torch.from_numpy(a) for a in arrays),
        torch.from_numpy(np.ascontiguousarray(lse8[:, ::8])))
    for g, r in zip(ours, ref):
        _close(g, r)


def test_bwd_uses_the_given_lse():
    """p = exp(s - lse) from the lse handed in, not a recomputed one: a
    shift of lse by c scales every gradient by exp(-c)."""
    arrays, lse = _bwd_inputs(9, (B * H, TK, D), (B * H, TK))
    t = [torch.from_numpy(a) for a in arrays]
    g0 = tpb.probe_bwd_plain(*t, torch.from_numpy(lse), T, "f32")
    g1 = tpb.probe_bwd_plain(*t, torch.from_numpy(lse + 1.0), T, "f32")
    for a, b in zip(g0, g1):
        _close(b, a.numpy() * np.exp(-1.0))


@pytest.mark.parametrize("case", ["rows48", "rows256", "n_sub2_rows64",
                                  "tk_not_tiled", "n_kb5"])
def test_schedules_the_card_cannot_run_raise_on_the_cpu(case):
    """The wrapper refuses what the kernel does not take, on every device:
    rows that are not whole warpgroups of 64 (48); more consumer
    warpgroups than a CTA is built with (four, rows 256); turns with one
    warpgroup (n_sub 2 at rows 64); K tiles that do not cover TK (1000 is
    no multiple of 64); more column blocks than the block maxima a thread
    keeps (n_kb 5, and 1536 is no multiple of 64 * 5)."""
    tk = {"tk_not_tiled": 1000}.get(case, 1536)
    q = torch.zeros((1, tk, D))
    kw = {"rows48": dict(rows=48), "rows256": dict(rows=256),
          "n_sub2_rows64": dict(rows=64, n_sub=2),
          "tk_not_tiled": {}, "n_kb5": dict(n_kb=5)}[case]
    with pytest.raises(ValueError, match={
            "rows48": "whole warpgroups", "rows256": "one or two",
            "n_sub2_rows64": "turns", "tk_not_tiled": "multiple of",
            "n_kb5": "column blocks"}[case]):
        tpf.probe_fwd(q, q, q, 100, **kw)
    assert tpf.plan(128, 1, 1536)["smem_bytes"] <= tpf.MAX_SMEM_BYTES
