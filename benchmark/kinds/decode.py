"""Traffic kind ``decode``: the eval's batched beam search as one closed-loop
client sends it.

Set-up draws the serving model (the compute dtype, no masters) and a host
pool of clips from the seed. Each request takes the pool's next ``batch``
clips in turn and makes the calls ``serve.Transcriber.transcribe`` makes for
a batch: ``cli/common.py::upload_features`` from host numpy, then
``decode/generate.py::generate_over_mesh`` without a mesh, and the tokens'
copy to the host. A request's latency runs from the host numpy clips to
its tokens on the host. One request warms every shape up; the window sends
the next request as soon as the last has come back, until ``--seconds``
have passed. Once it has closed and the program is freed, the reference
reads the served tokens of a seeded sample of the finished requests
(``reference/decode.py``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.lib import data, program, trace, weights
from benchmark.lib.harness import Outcome, Run, free, process_seconds
from benchmark.reference import decode as ref_decode


def build(r: Run, int8: bool = False, num_beams: int = None):
    """(request, pool): ``request(i) -> (tokens [batch, L] numpy, upload
    seconds, latency seconds)`` for the program's served model, and the
    host pool. ``int8``: the program's int8 serving path, the control (the
    weights after ``models/quantize.py``'s int8 round trip, as
    ``Transcriber(int8_weights=True)`` serves them, and the int8 cross
    cache). ``num_beams``: another beam count than the mix's, a fault."""
    import torch
    from neuspeech1_tpu_torch.cli.common import upload_features
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      generate_over_mesh)
    from neuspeech1_tpu_torch.models.convert import module_from_params

    cfg, tr = r.config, r.traffic
    device = torch.device(r.device)
    config, stem = program.whisper_config(cfg)
    tree = weights.param_tree(cfg, r.seed, device)
    if int8:
        from neuspeech1_tpu_torch.models.quantize import (dequantize_params,
                                                          quantize_params)

        tree = dequantize_params(quantize_params(_host(tree)))
    model = module_from_params(tree, config, stem, device=device)
    del tree
    pool = data.decode_pool(cfg, tr, r.seed, device)
    prompt_ids = data.prompt_ids(cfg)
    batch = tr["batch"]
    prompt = torch.as_tensor([prompt_ids] * batch, device=device)
    gen = GenerationConfig.for_model(
        config, max_length=len(prompt_ids) + tr["new_tokens"],
        num_beams=num_beams or tr["num_beams"],
        repetition_penalty=tr["repetition_penalty"],
        no_repeat_ngram_size=tr["no_repeat_ngram_size"],
        int8_kv_cache=int8)

    def request(i: int):
        lo = (i * batch) % pool.shape[0]
        chunk = pool[lo:lo + batch]
        with trace.span("request"):
            t0 = time.perf_counter()
            with trace.span("upload"):
                feats = upload_features(chunk, model.dtype, device)
            t1 = time.perf_counter()
            with trace.span("generate"):
                out = generate_over_mesh(model, feats, prompt, gen)
            with trace.span("tokens_to_host"):
                tokens = out.cpu().numpy()
        return tokens, t1 - t0, time.perf_counter() - t0

    return request, pool


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def numbers(r: Run, served: list, pool: np.ndarray,
            detail: dict = None, control: bool = False) -> dict:
    """The numbers that decide ``correct``, once the program is freed, over
    a seeded sample of the requests ``served`` (their tokens, in order):
    the widest gap of a served token below the reference's 2K-th best,
    and the share of the sampled hypotheses that never leave their rows'
    best by a beam's detour (`reference/decode.py`). ``control``: the fp8
    reference's first choices read on the same prompts and tokens.
    ``detail``, where given, takes the sample and the reference's
    readings."""
    import torch

    tr = r.traffic
    rng = data.rng(r.seed, 21)
    picked = rng.choice(len(served), min(tr["checked_requests"],
                                         len(served)), replace=False)
    clips, tokens = [], []
    for i in sorted(picked):
        rows = np.sort(rng.choice(tr["batch"], tr["checked_clips_per_request"],
                                  replace=False))
        clips.append(((i * tr["batch"]) % pool.shape[0]) + rows)
        tokens.append(served[i][rows])
    clips, tokens = np.concatenate(clips), np.concatenate(tokens)
    device = torch.device(r.device)
    gaps, below_best, scores = ref_decode.token_gaps(
        weights.param_tree(r.config, r.seed, device), r.config, tr,
        pool[clips], tokens, device, control)
    if detail is not None:
        detail.update(clips=clips, tokens=tokens, gaps=gaps,
                      below_best=below_best, scores=scores)
    return {"token_gap": float(np.nanmax(gaps)),
            "greedy_share": ref_decode.greedy_share(below_best)}


def run(r: Run) -> Outcome:
    import torch

    tr = r.traffic
    if tr["pool_clips"] % tr["batch"]:
        raise ValueError("a decode mix's pool holds whole requests")
    if r.device != "cpu":
        program.build_kernels()
    request, pool = build(r)
    request(0)                           # warms every shape up
    r.sync()
    if r.device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    slice_ = trace.Slice(r.trace, tr["trace_after_requests"],
                         tr["trace_requests"])
    setup_s = process_seconds()
    served, uploads, latencies = [], [], []
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < r.seconds:
            tokens, up, lat = request(len(served))
            served.append(tokens)
            uploads.append(up)
            latencies.append(lat)
            slice_.tick(len(served) - 1)
        window_s = time.perf_counter() - t0
        r.profile = slice_.read()
    finally:
        slice_.close()
    peak = torch.cuda.max_memory_allocated() if r.device != "cpu" else 0
    touched = slice_.touched()
    outside = [i for i in range(len(served)) if i not in touched]
    r.stats.update(
        batch=tr["batch"], requests=len(served),
        requests_outside=len(outside),
        seconds_outside=float(np.sum(np.asarray(latencies)[outside])),
        upload_s=float(np.mean(uploads)),
        prompt_len=served[0].shape[1] - tr["new_tokens"])
    del request
    free()
    return Outcome(
        metrics={"decode_utt_per_s": len(served) * tr["batch"] / window_s,
                 "decode_p80_ms": float(np.percentile(latencies, 80)) * 1e3,
                 "setup_s": setup_s},
        attempted=len(served), failed=0,
        numbers=numbers(r, served, pool),
        memory_peak_bytes=int(peak))
