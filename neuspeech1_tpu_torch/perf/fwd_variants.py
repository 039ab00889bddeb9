"""A/B timing of variants of the flash forward's source on the card.

    python -m neuspeech1_tpu_torch.perf.fwd_variants [VARIANT ...]

Writes each variant of ``csrc/flash_fwd_btc.cu`` (the tile, the ring or the
CTA's warpgroups changed, or one step dropped to take its work out) into the build
directory, builds them all with nvcc at once, and times K1 at the training
shape (B=64, T=1500, H=8, D=64), at the decoder's cross attention (Tq=64)
and at the serving encoder (B=8), and K4's forward at the SP step's
(T=1536, 36 keys masked), with each, in two rounds, by CUDA events and by
the profiler's device time. Each line says how far the variant is from the
plain version: an ablation computes something else, so only the base and
the tile variants must agree. One JSON line per variant, case and
round, then the card's name and power limit. Needs one GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from neuspeech1_tpu_torch.ops import flash_attention as fa
from neuspeech1_tpu_torch.perf import common
from neuspeech1_tpu_torch.perf.bwd_variants import _rel_err
from neuspeech1_tpu_torch.perf.common import cuda_ms

_NARROW = ("if (p.t_q > 64 && wide_ctas >= 2 * sm_count(dev)) {",
           "if (false) {")
_NO_SOFTMAX = ("  auto softmax_tile = [&](int j, int c) {\n",
               "  auto softmax_tile = [&](int j, int c) {\n    return;\n")
_NO_PV = ("      wgmma_rs<D>(oacc, pa[kk],", "      if (0) wgmma_rs<D>(oacc, pa[kk],")
# name -> (old, new) substitutions, each of which must match the source once
VARIANTS = {
    "base": (),
    # wide CTAs of two consumer warpgroups (128 q rows) instead of three;
    # narrow CTAs (one warpgroup, two CTAs per SM) at every shape
    "wide2": (("constexpr int kWideWarpgroups = 3;",
               "constexpr int kWideWarpgroups = 2;"),),
    "narrow": (_NARROW,),
    # a ring of six stages in the wide CTA (four at D=128)
    "wide_stages6": (("kStages = WG == 1 ? 3 : 4;",
                      "kStages = WG == 1 ? 3 : D == 128 ? 4 : 6;"),),
    # 64 K/V rows per tile at every D (three narrow CTAs per SM)
    "bk64": (("return D == 128 ? 64 : 128;", "return 64;"),),
    # K4 with O's product running on under the softmax, as K1 (its wide
    # instantiation at D=64 spills)
    "bias_overlap": (("      wgmma_wait<HAS_BIAS ? 0 : 1>();",
                      "      wgmma_wait<1>();"),),
    # work taken out (timing only): the exponentials (p = the shifted
    # score), the whole softmax (p = s), the PV product; in wide CTAs, and
    # in narrow ones
    "no_exp": (("        sacc[4 * nt + e] = exp2_approx(\n"
                "            fmaf(sacc[4 * nt + e], scale_log2, e < 2 ? "
                "-sh_lo : -sh_hi));",
                "        sacc[4 * nt + e] =\n"
                "            fmaf(sacc[4 * nt + e], scale_log2, e < 2 ? "
                "-sh_lo : -sh_hi);"),),
    "no_softmax": (_NO_SOFTMAX,),
    "no_pv": (_NO_PV,),
    "narrow_no_softmax": (_NARROW, _NO_SOFTMAX),
    "narrow_no_pv": (_NARROW, _NO_PV),
}


def variant_source(name: str) -> str:
    """The forward's source with ``VARIANTS[name]`` applied."""
    return common.variant_source("flash_fwd_btc", name, VARIANTS[name])


def _build_variant(name: str):
    """(the variant's library, ptxas's lines on registers, spills and
    serialized wgmmas)."""
    lib, log = common.build_variant("flash_fwd_btc", name,
                                    variant_source(name))
    notes = sorted({ln.split("ptxas info    :")[-1].strip()
                    for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln or "C7515" in ln})
    return lib, notes


def _device_ms(fn, calls: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "flash_fwd" in e.key) / 1e3 / calls


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("fwd_variants needs a CUDA GPU", file=sys.stderr)
        return 1
    names = argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build_variant, names)))
    libs = {name: lib for name, (lib, _) in built.items()}
    for name, (_, notes) in built.items():
        print(json.dumps({"variant": name, "ptxas": notes}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def bthd(b, t):
        return (torch.randn((b, t, 512), generator=gen, device="cuda")
                .to(torch.bfloat16).view(b, t, 8, 64))

    q, k, v = bthd(64, 1500), bthd(64, 1500), bthd(64, 1500)
    qe, ke, ve = bthd(8, 1500), bthd(8, 1500), bthd(8, 1500)
    qc = bthd(64, 64)
    bias = torch.zeros(1536, device="cuda")
    bias[1500:] = fa.NEG_INF
    qb, kb, vb = bthd(64, 1536), bthd(64, 1536), bthd(64, 1536)
    cases = {
        "train_encoder": (lambda: fa._flash_fwd_cuda(q, k, v, False, 1500),
                          fa.flash_attention_bthd_plain(q, k, v)),
        "train_cross": (lambda: fa._flash_fwd_cuda(qc, k, v, False, 1500),
                        fa.flash_attention_bthd_plain(qc, k, v)),
        "encoder": (lambda: fa._flash_fwd_cuda(qe, ke, ve, False, 1500),
                    fa.flash_attention_bthd_plain(qe, ke, ve)),
        "sp_step_n1": (lambda: fa._flash_bias_fwd_cuda(qb, kb, vb, bias),
                       fa.flash_bias_fwd_plain(qb, kb, vb, bias)[0]),
    }
    real = fa._library()
    for lib in libs.values():
        for entry in (fa._FWD[1], fa._FWD_BIAS):
            getattr(lib, entry).argtypes = getattr(real, entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
    for rnd in range(2):
        for name, lib in libs.items():
            fa._lib = lib
            for case, (fn, plain) in cases.items():
                o = fn()[0]
                torch.cuda.synchronize()
                print(json.dumps({
                    "variant": name, "case": case, "round": rnd,
                    "ms": cuda_ms(fn), "device_ms": _device_ms(fn),
                    "o_rel_err": _rel_err(o, plain)}), flush=True)
    fa._lib = real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
