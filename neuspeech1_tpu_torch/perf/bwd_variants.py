"""A/B timing of variants of the flash backward's source on the card.

    python -m neuspeech1_tpu_torch.perf.bwd_variants [VARIANT ...]

Writes each variant of ``csrc/flash_bwd_btc.cu`` (a tile size changed, or
one statement dropped to take its work out) into the build directory,
builds them all with nvcc at once, and times K2 at the training shape (B=64,
T=1500, H=8, D=64) and K4's backward at the SP step's (T=1536, 36 keys
masked) with each, in two rounds, with the time split over the three
kernels under torch.profiler. Each line says how far the variant is from
the plain version: an ablation computes something else, so only the base
and the tile variants must agree. One JSON line per variant, case and
round, then the card's name and power limit. Needs one GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from neuspeech1_tpu_torch.ops import flash_attention as fa
from neuspeech1_tpu_torch.perf import common
from neuspeech1_tpu_torch.perf.common import cuda_ms

_NO_DV = ("wgmma_rs<D>(dv_acc, pa[kk]", "if (0) wgmma_rs<D>(dv_acc, pa[kk]")
# name -> (old, new) substitutions, each of which must match the source once
VARIANTS = {
    "base": (),
    # the dk/dv kernel with 32 q rows per tile (fewer registers)
    "dkdv_bq32": (("kBlockQ = D == 128 ? 32 : 64;", "kBlockQ = 32;"),),
    # the exp of each kernel's unmasked tiles taken out (p = s)
    "no_exp_dkdv": (
        ("x = exp2_approx(x * scale_log2 - lse_l2);", "(void)0;"),),
    "no_exp_dq": (("y = exp2_approx(x * scale_log2 - lse_r);", "y = x;"),),
    # the dk/dv kernel's barrier per tile taken out (racy: timing only)
    "no_barrier_dkdv": (
        ("are done\n      __syncthreads();", "are done\n"),),
    # the dv product, then the dv and dk products, taken out
    "no_dv": (_NO_DV,),
    "no_dv_dk": (_NO_DV, ("wgmma_rs<D>(dk_acc, da[kk]",
                          "if (0) wgmma_rs<D>(dk_acc, da[kk]")),
    # the dk/dv products waited for in their own tile
    "dkdv_wait": (("wgmma_commit();  // dv and dk run on into the next tile",
                   "wgmma_commit();\n      wgmma_wait<0>();"),),
    # dk from p instead of ds (no ds work), and ds without waiting for dp
    "dk_from_p": (("pack_a<BQ>(da, dpacc);", "pack_a<BQ>(da, sacc);"),),
    "no_dp_wait": (("wgmma_wait<1>();  // dp^T is ready; dv runs on",
                    "(void)0;"),),
    # the register-A products reading B K-major, as the score products do
    # (the wrong operand: timing only)
    "rs_kmajor": tuple(
        (f"%{r}}}, %{r + 1}, p, 1, 1, 1;", f"%{r}}}, %{r + 1}, p, 1, 1, 0;")
        for r in (19, 35, 67)) + (
        ("desc_mn<D, BQ>(st + L::kTileQ, kk)",
         "desc_k<D, BQ>(st + L::kTileQ, 0, kk)"),
        ("desc_mn<D, BQ>(st + L::kQs, kk)",
         "desc_k<D, BQ>(st + L::kQs, 0, kk)"),
        ("desc_mn<D, BK>(st + L::kKs, kk)",
         "desc_k<D, BK>(st + L::kKs, 0, kk)")),
    # three warpgroups (192 K/V rows) per dk/dv CTA, at most 168 registers
    "dkdv_wg3": (("kDkdvWarpgroups = 2;", "kDkdvWarpgroups = 3;"),),
    # lse scaled to log2 units once per tile by the thread that copied it
    "lse_prescaled": (
        ("const float lse_l2 = lse_s[cl] * kLog2e;",
         "const float lse_l2 = lse_s[cl];"),
        ("      fence_proxy_async();\n      // tile i landed",
         "      if (threadIdx.x < BQ) {\n"
         "        reinterpret_cast<float*>(st_ptr + L::kLse)[threadIdx.x] *="
         " kLog2e;\n      }\n"
         "      fence_proxy_async();\n      // tile i landed")),
    # the dq product left running into the next tile, as dv and dk are
    "dq_deferred": (
        ("    wgmma_commit();\n    wgmma_wait<0>();\n"
         "    fence_regs(dq_acc);\n  }\n",
         "    wgmma_commit();\n  }\n  wgmma_wait<0>();\n"
         "  fence_regs(dq_acc);\n"),),
}


def variant_source(name: str) -> str:
    """The backward's source with ``VARIANTS[name]`` applied."""
    return common.variant_source("flash_bwd_btc", name, VARIANTS[name])


def _build_variant(name: str):
    """(the variant's library, ptxas's performance notes by kernel)."""
    lib, log = common.build_variant("flash_bwd_btc", name,
                                    variant_source(name))
    notes = []
    for line in log.splitlines():
        if "Performance Loss" in line:
            fn = re.search(r"(flash_bwd_(?:dkdv|dq)_kernel)ILi(\d+)ELb(\d)",
                           line)
            why = line.split("Performance Loss:")[-1].split(" in the ")[0]
            notes.append(f"{fn and '<'.join(fn.groups())}>:"
                         f"{why.strip()[:110]}")
    return lib, notes


def _split_ms(fn, calls: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for part in ("delta", "dkdv", "dq"):
            if f"flash_bwd_{part}_kernel" in e.key:
                split[part] = e.self_device_time_total / 1e3 / calls
    return split


def _rel_err(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bwd_variants needs a CUDA GPU", file=sys.stderr)
        return 1
    names = argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build_variant, names)))
    libs = {name: lib for name, (lib, _) in built.items()}
    for name, (_, notes) in built.items():
        print(json.dumps({"variant": name, "ptxas_notes": notes}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def bthd(t):
        return (torch.randn((64, t, 512), generator=gen, device="cuda")
                .to(torch.bfloat16).view(64, t, 8, 64))

    q, k, v, do = bthd(1500), bthd(1500), bthd(1500), bthd(1500)
    o, lse = fa.flash_attention_bthd(q, k, v, return_lse=True)
    k2 = (q, k, v, o, do, lse, False, 1500)
    bias = torch.zeros(1536, device="cuda")
    bias[1500:] = fa.NEG_INF
    qb, kb, vb, dob = bthd(1536), bthd(1536), bthd(1536), bthd(1536)
    ob, lseb = fa.flash_bias_fwd(qb, kb, vb, bias)
    k4 = (qb, kb, vb, ob, dob, lseb, bias)
    cases = {"K2": (lambda: fa._flash_bwd_cuda(*k2),
                    fa.flash_attention_bthd_bwd_plain(*k2)),
             "K4_bwd": (lambda: fa._flash_bias_bwd_cuda(*k4),
                        fa.flash_bias_bwd_plain(*k4))}
    real = fa._bwd_library()
    for lib in libs.values():
        for entry in (fa._BWD[1], fa._BWD_BIAS):
            getattr(lib, entry).argtypes = getattr(real, entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
    for rnd in range(2):
        for name, lib in libs.items():
            fa._bwd_lib = lib
            for case, (fn, plain) in cases.items():
                grads = fn()
                torch.cuda.synchronize()
                print(json.dumps({
                    "variant": name, "case": case, "round": rnd,
                    "ms": cuda_ms(fn), "split_ms": _split_ms(fn),
                    "rel_err": max(_rel_err(g, p)
                                   for g, p in zip(grads, plain))}),
                    flush=True)
    fa._bwd_lib = real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
