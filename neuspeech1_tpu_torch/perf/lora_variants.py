"""A/B timing of variants of the LoRA adapter backward (K3) on the card.

    python -m neuspeech1_tpu_torch.perf.lora_variants [VARIANT ...]

Writes each variant of ``csrc/lora_bwd.cu`` (ablations that leave out the
products, the cluster exchange or its parts, or everything but the loads,
and other cluster sizes and ring depths through the wrapper's plan) into the
build directory, builds them all with nvcc at once, and times K3 at
chip_smoke.py's ``LORA_CASES`` with each, in two rounds, by the profiler's
device time (both of the call's launches). Each line gives the plan, the clusters the card
holds at once and how far the variant is from the plain version (the
ablations are wrong by design). One JSON line per variant, case and round,
then the card's name and power limit. Needs one GPU and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from neuspeech1_tpu_torch.ops import lora_bwd as lb
from neuspeech1_tpu_torch.perf import common
from neuspeech1_tpu_torch.perf.flash_trees import LORA_CASES

_SOURCE = "lora_bwd"
# the loop after a tile's wait: its products, the exchange, the loads
_STEP1 = "    // 1. This warpgroup's partial u (x panels) and t1 (dy panels)."
_STEP2 = "    // 2. The CTA's partial [64][t1 | u]: warpgroup 1's, then 0's added."
_STEP5 = ("    fence_proxy_async();\n    __syncthreads();\n\n"
          "    // 5. dA[panel] += x_panel^T bf16(t1)")
_WGMMA = ("          wgmma_ss<RP>(uacc,", "          wgmma_ss<RP>(tacc,",
          "            wgmma_rs<RP>(acc[jj],")
_RS_READ = "const float* px = cl.map_shared_rank(xch, c) + row * XS + col;"
_AG_READ = "        *local = *cl.map_shared_rank(local, c);"
_SYNC2 = "    cl.sync();\n\n    // 4. The other CTAs' rows"
_SYNC1 = "    cl.sync();\n\n    // 3. Rows"


def _stages(n: int):
    return ("constexpr int kStages = 2;", f"constexpr int kStages = {n};")


# name -> ((old, new) substitutions each matching the source once, the
# wrapper's plan constants to change)
VARIANTS = {
    "base": ((), {}),
    # each tile's loads and waits only: the rate of the TMA ring
    "loads_only": (((_STEP1, "    if (true) {\n      __syncthreads();\n"
                     "      if (tid == 0 && it + kStages < nt) "
                     "issue(it + kStages);\n      continue;\n    }\n"
                     + _STEP1),), {}),
    # no exchange: no cluster barriers, no DSMEM (t1 and u stay unsummed)
    "no_exchange": (((_STEP2, "#if 0\n" + _STEP2),
                     (_STEP5, "#endif\n" + _STEP5)), {}),
    # no products: the loads and the exchange (each wgmma call skipped)
    "no_products": (tuple((w, w.replace("wgmma_", "if (false) wgmma_", 1))
                          for w in _WGMMA), {}),
    # the exchange without its reads of other CTAs' shared memory (each CTA
    # sums its own partial; no copies of the other rows), with one cluster
    # barrier instead of two, or with neither
    "local_rs": (((_RS_READ, _RS_READ.replace(
        "cl.map_shared_rank(xch, c)", "xch")),), {}),
    "no_ag": (((_AG_READ, "        *local = *local;"),), {}),
    "one_barrier": (((_SYNC2, _SYNC2.replace("    cl.sync();\n", "")),),
                    {}),
    "no_barriers": (((_SYNC1, _SYNC1.replace("    cl.sync();\n", "")),
                     (_SYNC2, _SYNC2.replace("    cl.sync();\n", ""))), {}),
    # clusters of 8 CTAs (5 panels each at fc1), 2 or 4 tiles in flight
    "c8": ((), {"CLUSTERS": (8,)}),
    "c8_stages4": ((_stages(4),), {"CLUSTERS": (8,), "STAGES": 4}),
}


def variant_source(name: str) -> str:
    """The variant's kernel source with its substitutions applied."""
    return common.variant_source(_SOURCE, name, VARIANTS[name][0])


def _build_variant(name: str):
    """(the variant's library, ptxas's lines on registers and spills)."""
    lib, log = common.build_variant(_SOURCE, name, variant_source(name))
    notes = sorted({ln.split("ptxas info    :")[-1].strip()
                    for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln})
    return lib, notes


def _device_ms(fn, calls: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "lora_" in e.key) / 1e3 / calls


def _use(name: str, lib):
    """Points the wrapper at ``lib`` and the variant's plan constants;
    returns what restores them."""
    plan = VARIANTS[name][1]
    saved = (lb._lib, {k: getattr(lb, k) for k in plan})
    lb._lib = lib
    for key, value in plan.items():
        setattr(lb, key, value)

    def restore():
        lb._lib = saved[0]
        for key, value in saved[1].items():
            setattr(lb, key, value)
    return restore


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("lora_variants needs a CUDA GPU", file=sys.stderr)
        return 1
    names = argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build_variant, names)))
    for name, (_, notes) in built.items():
        print(json.dumps({"variant": name, "ptxas": notes}), flush=True)
    real = lb._library()
    for lib, _ in built.values():
        for entry in (lb._FN, lb._WIDE_FN, "nsp_lora_bwd_resident"):
            fn, ref = getattr(lib, entry), getattr(real, entry)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for case, n, din, dout, r in LORA_CASES:
        x, dy = (torch.randn((n, w), generator=gen, device="cuda")
                 .to(torch.bfloat16) for w in (din, dout))
        a, bm = ((0.1 * torch.randn(s, generator=gen, device="cuda"))
                 .to(torch.bfloat16) for s in ((din, r), (r, dout)))
        ref = lb.lora_adapter_bwd_plain(x, dy, a, bm)
        cases.append((case, (x, dy, a, bm), ref))
    for rnd in range(2):
        for name, (lib, _) in built.items():
            restore = _use(name, lib)
            for case, args, ref in cases:
                got = lb.lora_adapter_bwd(*args)
                err = max(((g - p).abs().max() / p.abs().max()).item()
                          for g, p in zip(got, ref))
                pl = lb.plan(*args[0].shape, args[1].shape[1],
                             args[2].shape[1], lb._sm_count(0))
                print(json.dumps({
                    "variant": name, "case": case, "round": rnd,
                    "device_ms": _device_ms(lambda: lb.lora_adapter_bwd(
                        *args)),
                    "rel_err": err, "plan": pl._asdict(),
                    "resident_clusters": lb.resident_clusters(pl)}),
                    flush=True)
            restore()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
