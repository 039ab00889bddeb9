"""Runs chip_smoke.py's end-to-end phases from one checkout.

    python3 neuspeech1_tpu_torch/perf/serve_trees.py CHECKOUT TAG [WHICH]

imports ``chip_smoke`` and ``neuspeech1_tpu_torch`` from the checkout
CHECKOUT (so it builds that tree's kernels) and runs its ``slice``
(greedy), ``beam``, ``spec``, ``lora`` and ``bench`` phases on one
whisper-base model made from a seed (WHICH ``serve``, the default), or its
``train`` and ``ring`` phases (WHICH ``train``: the training step and the
sequence-parallel step), each printing its JSON lines, then one line
``{"tree": TAG, "phases": [...]}``. To compare two commits on one card,
unpack both and run them in one call, parent and change in turns.
"""

import json
import sys
import tempfile


def main(checkout: str, tag: str, which: str = "serve") -> None:
    sys.path.insert(0, checkout)
    import chip_smoke as c

    c.phase_build()
    if which == "train":
        c.phase_ring(c.phase_train())
        print(json.dumps({"tree": tag, "phases": ["train", "ring"]}),
              flush=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        model = c.serving_model(tmp)
        c.phase_slice(model)
        c.phase_beam(model)
        c.phase_spec(model)
        c.phase_lora(model)
    c.phase_bench()
    print(json.dumps({"tree": tag, "phases": ["slice", "beam", "spec", "lora",
                                              "bench"]}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:4])
