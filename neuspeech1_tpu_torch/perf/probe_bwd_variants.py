"""A/B timing of variants of the probes' attention backward (P-bwd) on the
card.

    python -m neuspeech1_tpu_torch.perf.probe_bwd_variants [VARIANT ...]

Writes each variant of ``csrc/probe_bwd.cu`` (a ring size changed, or one
statement dropped to take its work out) into the build directory, builds
them all with nvcc at once, and times the backward at the probes' shape
(B*H = 512, TK = 1536, 1500 kept, lse ~ N(8, 0.1^2)) with bf16 operands at
R = 64 and 32 and with f32 operands at R = 64, in two rounds, with the time
split over the three kernels (delta, dk/dv, dq) under torch.profiler. Each
line says how far the variant is from the plain version: an ablation
computes something else, so only the base and the ring variants must
agree. One JSON line per variant, case and round, then the card's name and
power limit. Needs one GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from neuspeech1_tpu_torch.ops import probe_bwd as tpb
from neuspeech1_tpu_torch.perf import common
from neuspeech1_tpu_torch.perf.common import cuda_ms

BH, TK, T = 512, 1536, 1500
_EXP_DKDV = "pr = exp2_approx(fmaf(x, scale_log2, -l * kLog2e));"
_EXP_DQ = "pr = exp2_approx(fmaf(x, scale_log2, -l));"
# 2^x on the FMA pipe, for x <= 0: x = j + f with j = round(x) (from the
# low bits of x + 1.5 * 2^23) and |f| <= 1/2; 2^f by its degree-4 Taylor
# polynomial (relative error under 6e-5), 2^j added to the exponent bits
_EXP2_FMA = """__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float y = fmaf(0.00961813f, f, 0.0555041f);
  y = fmaf(y, f, 0.240227f);
  y = fmaf(y, f, 0.693147f);
  y = fmaf(y, f, 1.f);
  return __int_as_float(__float_as_int(y) + (__float_as_int(t) << 23));
}

// The f32 values of a packed bf16 pair's low and high halves."""


def _fma_exp(every: int):
    """bf16 mode: every ``every``-th 8-column group of a tile takes its
    exponentials on the FMA pipe instead of MUFU."""
    def on_fma(line):
        arg = line[len("pr = exp2_approx("):-len(");")]
        return (f"pr = nt % {every} == {every - 1} ? exp2_fma({arg}) : "
                f"exp2_approx({arg});")
    return (("// The f32 values of a packed bf16 pair's low and high halves.",
             _EXP2_FMA), (_EXP_DKDV, on_fma(_EXP_DKDV)),
            (_EXP_DQ, on_fma(_EXP_DQ)))


# name -> (old, new) substitutions, each of which must match the source once
VARIANTS = {
    "base": (),
    # the ring's streamed rows: 4 (8 at R = 32) or 6 (12) stages
    "ring_256": (("kRingRows = 512;", "kRingRows = 256;"),),
    "ring_384": (("kRingRows = 512;", "kRingRows = 384;"),),
    # the consumer warpgroups issuing free of each other, or taking turns
    # on every product of a tile (the base: on each tile's scores)
    "free": (("auto turn_begin = [&]() { bar_sync(1 + wg, 256); };",
              "auto turn_begin = [&]() {};"),
             ("auto turn_end = [&]() { bar_arrive(2 - wg, 256); };",
              "auto turn_end = [&]() {};")),
    "turns_all": (
        ("          passes_rs<P, BN>(acc1, pa, st + L::kTileN);\n"
         "          wgmma_commit();\n",
         "          turn_begin();\n"
         "          passes_rs<P, BN>(acc1, pa, st + L::kTileN);\n"
         "          wgmma_commit();\n          turn_end();\n"),
        ("        passes_rs<P, BN>(acc0, da, st);\n"
         "        wgmma_commit();  // runs on into the next tile\n",
         "        turn_begin();\n        passes_rs<P, BN>(acc0, da, st);\n"
         "        wgmma_commit();  // runs on into the next tile\n"
         "        turn_end();\n")),
    # bf16: every second or fourth 8-column group's exponentials on the FMA
    # pipe
    "fma_exp2": _fma_exp(2),
    "fma_exp4": _fma_exp(4),
    # the exponentials taken out (p = s)
    "no_exp": (("pr = expf(x * scale - l);", "pr = x;"),
               (_EXP_DKDV, "pr = x;"), (_EXP_DQ, "pr = x;")),
    # the dv product taken out
    "no_dv": (("passes_rs<P, BN>(acc1, pa, st + L::kTileN);", "(void)pa;"),),
    # the dq product waited for in its own tile
    "dq_wait": (("wgmma_commit();  // runs on into the next tile",
                 "wgmma_commit();\n        if constexpr (!DKDV) "
                 "wgmma_wait<0>();"),),
    # f32: the dk passes issued while dv's three still run
    "f32_no_dv_wait": (
        ("          // dv's three passes done: their fragments' registers "
         "are free\n          wgmma_wait<0>();", "          (void)0;"),),
}
# (case, ops, rows)
CASES = (("bwd_bq512_bf16ops", "bf16", 64), ("bwd_bq256_bf16ops", "bf16", 32),
         ("bwd_bq512_f32ops", "f32", 64))


def variant_source(name: str) -> str:
    """The backward's source with ``VARIANTS[name]`` applied."""
    return common.variant_source("probe_bwd", name, VARIANTS[name])


def _build_variant(name: str):
    """(the variant's library, ptxas's spills and performance notes)."""
    lib, log = common.build_variant("probe_bwd", name, variant_source(name))
    notes = [ln.strip()[:160] for ln in log.splitlines()
             if "Performance Loss" in ln or re.search(r"[1-9]\d* bytes spill",
                                                      ln)]
    return lib, notes


def _split_ms(fn, calls: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        for part, key in (("delta", "delta_kernel"),
                          ("dkdv", "probe_bwd_kernel<true"),
                          ("dq", "probe_bwd_kernel<false")):
            if key in e.key:
                split[part] = split.get(part, 0.0) + \
                    e.self_device_time_total / 1e3 / calls
    return split


def _rel_err(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_bwd_variants needs a CUDA GPU", file=sys.stderr)
        return 1
    names = argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build_variant, names)))
    libs = {name: lib for name, (lib, _) in built.items()}
    for name, (_, notes) in built.items():
        print(json.dumps({"variant": name, "ptxas_notes": notes}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = [torch.randn((BH, TK, 64), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(5)]
    args.append(8.0 + 0.1 * torch.randn((BH, TK), generator=gen,
                                        device="cuda"))
    plain = {ops: tpb.probe_bwd_plain(*args, T, ops) for ops in tpb.OPS}
    real = tpb._library()
    for lib in libs.values():
        fn = getattr(lib, tpb._FN)
        fn.argtypes = getattr(real, tpb._FN).argtypes
        fn.restype = ctypes.c_int
    for rnd in range(2):
        for name, lib in libs.items():
            tpb._lib = lib
            for case, ops, rows in CASES:
                def run(ops=ops, rows=rows):
                    return tpb.probe_bwd(*args, T, ops=ops, rows=rows)

                grads = run()
                torch.cuda.synchronize()
                print(json.dumps({
                    "variant": name, "case": case, "round": rnd,
                    "ms": cuda_ms(run), "split_ms": _split_ms(run),
                    "rel_err": max(_rel_err(g, p)
                                   for g, p in zip(grads, plain[ops]))}),
                    flush=True)
    tpb._lib = real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
