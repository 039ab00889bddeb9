"""A/B timing of variants of the decode kernels' sources on the card.

    python -m neuspeech1_tpu_torch.perf.decode_variants [VARIANT ...]

Writes each variant of ``csrc/decode_cross.cu`` (K6) or
``csrc/decode_step_multi.cu`` (K8) (the ring's depth, the copies' L2
prefetch, the registers per thread changed, or the wrapper's plan given
another CTA target) into the build directory, builds them all with nvcc
at once, and times its kernel at chip_smoke.py's cases (K6 at
``DECODE_CROSS_CASES``, K8 at ``DECODE_STEP_MULTI_CASES``) with each, in
two rounds, by the profiler's device time, each call on the next of four
caches (more than the L2 holds). Each line says how far the variant is
from the plain version. One JSON line per variant, case and round, then
the card's name and power limit. Needs one GPU and nvcc.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from neuspeech1_tpu_torch.ops import decode_cross as dc
from neuspeech1_tpu_torch.ops import decode_step as ds
from neuspeech1_tpu_torch.perf import common
from neuspeech1_tpu_torch.perf.flash_trees import (ACCEPTED_SHARE,
                                                   CACHE_COPIES,
                                                   DECODE_CROSS_CASES,
                                                   DECODE_HEAD_DIM,
                                                   DECODE_HEADS,
                                                   DECODE_STEP_MULTI_CASES)

_K6, _K8 = "decode_cross", "decode_step_multi"
_K6_STAGES3 = ("constexpr int kStages = 2;", "constexpr int kStages = 3;")
_K6_RINGS4 = ("constexpr int rings(int mt) { return mt == 1 ? 4 : 8; }",
              "constexpr int rings(int) { return 4; }")
_PLAIN_C1 = ("  cfg.numAttrs = 1;", "  cfg.numAttrs = cluster_x > 1 ? 1 : 0;")
# name -> (source, (old, new) substitutions each matching the source once,
# the wrapper's plan constants to change)
VARIANTS = {
    "base": (_K6, (), {}),
    # three chunks in each ring instead of two
    "stages3": (_K6, (_K6_STAGES3,), {}),
    # clusters until the call has this many CTAs (the base: 1 per SM)
    "ctas_264": (_K6, (), {"MIN_CTAS": 2 * 132}),
    "ctas_66": (_K6, (), {"MIN_CTAS": 66}),
    # query groups of 16 rows: every call on 4-warp CTAs (Tq = 20 reads
    # the cache twice, the second time mostly from the L2)
    "group16": (_K6, (("constexpr int kGroupRows = 32;",
                       "constexpr int kGroupRows = 16;"),
                      ("  if (t_q <= 16) {", "  if (true) {")),
                {"GROUP_ROWS": 16}),
    # two m16 tiles on four rings (eight warps, two CTAs an SM)
    "rings4": (_K6, (_K6_RINGS4,), {}),
    # a cluster of one CTA launched as a plain grid (no cluster attribute)
    "plain_c1": (_K6, (_PLAIN_C1,), {}),
    "k8_base": (_K8, (), {}),
    # two or eight tiles in K8's ring instead of four
    "k8_stages2": (_K8, (("constexpr int kStages = 4;",
                          "constexpr int kStages = 2;"),), {}),
    "k8_stages8": (_K8, (("constexpr int kStages = 4;",
                          "constexpr int kStages = 8;"),), {}),
    # clusters of more or fewer CTAs (4 and 1 at 16 rows x 8 heads)
    "k8_ctas_264": (_K8, (), {"MIN_CTAS": 264}),
    "k8_ctas_66": (_K8, (), {"MIN_CTAS": 66}),
    "k8_plain_c1": (_K8, (_PLAIN_C1,), {}),
}


def variant_source(name: str) -> str:
    """The variant's kernel source with its substitutions applied."""
    source, subs, _ = VARIANTS[name]
    return common.variant_source(source, name, subs)


def _build_variant(name: str):
    """(the variant's library, ptxas's lines on registers and spills)."""
    lib, log = common.build_variant(VARIANTS[name][0], name,
                                    variant_source(name))
    notes = sorted({ln.split("ptxas info    :")[-1].strip()
                    for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln})
    return lib, notes


def _device_ms(fn, prefix: str, calls: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if prefix in e.key) / 1e3 / calls


def _cases(gen):
    """(kernel, case, call on the next cache, the call's error against the
    plain version) at chip_smoke.py's decode cases."""
    from neuspeech1_tpu_torch.decode.spec import verify_mask

    h, d = DECODE_HEADS, DECODE_HEAD_DIM
    out = []
    for name, b, t_q, t, kv_len, layout in DECODE_CROSS_CASES:
        q = (torch.randn((b, t_q, h * d), generator=gen, device="cuda")
             .to(torch.bfloat16).view(b, t_q, h, d))
        shape = (b, t, h * d) if layout == "btc" else (b, h, t, d)
        caches = [tuple(torch.randn(shape, generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(2))
                  for _ in range(CACHE_COPIES)]
        views = [tuple(x.view(b, t, h, d).transpose(1, 2) for x in kv)
                 if layout == "btc" else kv for kv in caches]
        cycle = itertools.cycle(views)

        def err(q=q, kv=views[0], kv_len=kv_len):
            o = dc.decode_cross(q, *kv, kv_len)
            ref = dc.decode_cross_plain(q, *kv, kv_len)
            return ((o.float() - ref.float()).abs().max()
                    / ref.float().abs().max()).item()

        out.append((_K6, name, lambda q=q, kv_len=kv_len, cycle=cycle:
                    dc.decode_cross(q, *next(cycle), kv_len), err))
    for name, rows, g, t_max, idx, kind in DECODE_STEP_MULTI_CASES:
        q, kn, vn = (torch.randn((rows, g, h * d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     .view(rows, g, h, d) for _ in range(3))
        caches = [tuple(torch.randn((rows, h, d, t_max), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                        for _ in range(2)) for _ in range(CACHE_COPIES)]
        if kind == "broadcast":
            valid = torch.zeros((1, t_max), dtype=torch.bool, device="cuda")
        else:
            valid = torch.rand((rows, t_max), generator=gen,
                               device="cuda") < ACCEPTED_SHARE
        valid[:, :4] = True
        valid[:, idx:] = False
        mask = verify_mask(valid, idx, g)
        cycle = itertools.cycle(caches)

        def err(q=q, kn=kn, vn=vn, mask=mask, kv=caches[0], idx=idx):
            ctx = ds.decode_step_multi(q, kn, vn, mask, *kv, idx)
            ref = ds.decode_step_multi_plain(q, kn, vn, mask,
                                             *(x.clone() for x in kv), idx)
            return (ctx.float() - ref.float()).abs().max().item()

        out.append((_K8, name, lambda q=q, kn=kn, vn=vn, mask=mask, idx=idx,
                    cycle=cycle: ds.decode_step_multi(
                        q, kn, vn, mask, *next(cycle), idx), err))
    return out


def _use(name: str, lib):
    """Points the kernel's wrapper at ``lib`` and the variant's plan
    constants; returns what restores them."""
    source, _, plan = VARIANTS[name]
    mod, attr = (dc, "_lib") if source == _K6 else (ds, "_multi_lib")
    saved = (getattr(mod, attr), {k: getattr(mod, k) for k in plan})
    setattr(mod, attr, lib)
    for key, value in plan.items():
        setattr(mod, key, value)
    dc.plan.cache_clear()
    ds.multi_plan.cache_clear()

    def restore():
        setattr(mod, attr, saved[0])
        for key, value in saved[1].items():
            setattr(mod, key, value)
        dc.plan.cache_clear()
        ds.multi_plan.cache_clear()
    return restore


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("decode_variants needs a CUDA GPU", file=sys.stderr)
        return 1
    names = argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build_variant, names)))
    for name, (_, notes) in built.items():
        print(json.dumps({"variant": name, "ptxas": notes}), flush=True)
    real = {_K6: dc._library(), _K8: ds._multi_library()}
    entries = {_K6: dc._NAME[1], _K8: ds._MULTI_NAME[1]}
    for name, (lib, _) in built.items():
        source = VARIANTS[name][0]
        fn, ref = getattr(lib, entries[source]), getattr(real[source],
                                                         entries[source])
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    cases = _cases(torch.Generator(device="cuda").manual_seed(0))
    for rnd in range(2):
        for name, (lib, _) in built.items():
            restore = _use(name, lib)
            for source, case, fn, err in cases:
                if source != VARIANTS[name][0]:
                    continue
                print(json.dumps({
                    "variant": name, "case": case, "round": rnd,
                    "device_ms": _device_ms(fn, source), "err": err()}),
                    flush=True)
            restore()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
