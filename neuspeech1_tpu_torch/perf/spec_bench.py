"""Self-speculative greedy serving against greedy: the counterpart of the
JAX package's root ``perf/spec_bench.py``.

    python -m neuspeech1_tpu_torch.perf.spec_bench [base|byte|large]
        [--gammas 2,4] [--batch 64] [--new_tokens 48] [--repeats 4]

At the serving geometry (whisper-base EEG with random weights from a seed,
batch 64, the int8 cross cache, 48 new tokens) one JSON line for greedy
(``greedy_int8kv``: one token an iteration) and one per gamma for
``decode/spec.py::spec_greedy_decode`` drafting from each row's own prefix
(``spec_greedy_int8kv_g{gamma}``), with the JAX script's keys: ``config``,
``batch``, ``new_tokens``, ``ms_per_batch`` (median of ``repeats`` calls
after one warm-up, host clock, each ending in the tokens' copy to the
host), ``utterances_per_sec`` and ``loop_iters`` (the iterations the call
ran; greedy's is ``new_tokens``). After each gamma an analysis line:
``iter_cost_ratio_vs_greedy_step`` (ms an iteration over greedy's ms a
step), ``mean_accepted_per_iter`` (new tokens over iterations) and the
``speedup_formula``. ``byte`` takes the byte-layout vocabulary of the
flagship serving geometry, ``large`` whisper-large-v3 with the speech stem
at batch 8. With random weights the greedy continuation
often cycles, which flatters the drafter: the cost ratio is the number
that carries over to a trained checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import torch

from neuspeech1_tpu_torch.config import (StemConfig, WhisperConfig,
                                         preset_config)
from neuspeech1_tpu_torch.perf import serve_bench

BATCH = 64
NEW_TOKENS = 48
GAMMAS = (2, 4)


def run(config: WhisperConfig, stem: StemConfig, batch: int = BATCH,
        new_tokens: int = NEW_TOKENS, gammas=GAMMAS,
        repeats: int = serve_bench.REPEATS, device="cuda",
        emit=print) -> List[dict]:
    """The lines, each passed to ``emit`` as a JSON string when made."""
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      greedy_decode)
    from neuspeech1_tpu_torch.decode.spec import spec_greedy_decode

    model, feats, prompt = serve_bench.model_and_inputs(config, stem, batch,
                                                        device)
    gen = GenerationConfig.for_model(
        config, max_length=prompt.shape[1] + new_tokens, int8_kv_cache=True)
    out = []

    def add(rec):
        out.append(rec)
        emit(json.dumps(rec))

    with torch.no_grad():
        base = serve_bench.timed(
            lambda f: greedy_decode(model, f, prompt, gen), feats, repeats)
        add(serve_bench.line("greedy_int8kv", batch, new_tokens, base,
                             loop_iters=new_tokens))
        for gamma in gammas:
            iters = []

            def spec(f, g=gamma):
                tokens, n = spec_greedy_decode(model, f, prompt, gen, gamma=g)
                iters.append(int(n))
                return tokens

            times = serve_bench.timed(spec, feats, repeats)
            rec = serve_bench.line(f"spec_greedy_int8kv_g{gamma}", batch,
                                   new_tokens, times, loop_iters=iters[-1])
            add(rec)
            ratio = ((rec["ms_per_batch"] / rec["loop_iters"])
                     / (out[0]["ms_per_batch"] / new_tokens))
            add({"config": f"spec_g{gamma}_analysis",
                 "iter_cost_ratio_vs_greedy_step": ratio,
                 "mean_accepted_per_iter": new_tokens / rec["loop_iters"],
                 "speedup_formula": "tps_rel = mean_accepted / cost_ratio"})
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = serve_bench.arguments(__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="base",
                    choices=("base", "byte", "large"))
    ap.add_argument("--gammas", default=",".join(map(str, GAMMAS)))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--new_tokens", type=int, default=NEW_TOKENS)
    args = ap.parse_args(argv)
    config, stem = serve_bench.model_config(args.model)
    batch = BATCH
    if args.mode == "byte":
        config = dataclasses.replace(config,
                                     **WhisperConfig.layout_for_vocab(256))
    elif args.mode == "large":
        config, stem, batch = preset_config("large"), StemConfig("speech"), 8
    run(config, stem, args.batch or batch, args.new_tokens,
        tuple(int(g) for g in args.gammas.split(",")), args.repeats,
        torch.device(args.device), emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
