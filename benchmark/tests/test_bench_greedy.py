"""The greedy decode cell's kind at the tiny size on the CPU, against the
real cell's limits: a sound run is correct, and a search that serves its
rows' second-best token passes ``token_gap`` but fails
``non_greedy_share``."""

import pytest

from benchmark.lib import spec
from benchmark.run import execute
from benchmark.tests import tiny

CELL = "base-greedy-b256"


def run(seed: int = 2 ** 31 + 7):
    """A tiny run of the cell's traffic: its kind and search, the decode
    mix's cut sizes."""
    r = tiny.run("decode", spec.load_json(
        spec.BENCH_DIR / "limits" / f"{CELL}.json"), seed=seed)
    greedy = spec.load_json(spec.BENCH_DIR / "traffic"
                            / "greedy-b256-t48.json")
    r.traffic.update({k: greedy[k] for k in (
        "kind", "num_beams", "repetition_penalty", "no_repeat_ngram_size")})
    return r


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 3260005000])
def test_sound_run_is_correct(seed):
    out = execute(run(seed))
    assert out["correct"], out["check"]
    assert out["check"]["non_greedy_share"]["value"] == 0.0


def test_second_best_tokens(monkeypatch):
    """Each row's best token banned at every position but the last: every
    served token lies within its row's two best and the last is the best,
    so ``token_gap`` reads 0; the greedy number catches it."""
    import torch

    from neuspeech1_tpu_torch.decode import generate

    real = generate._process_logits

    def second_best(logits, tokens, cur_len, gen, *a, **k):
        scores = real(logits, tokens, cur_len, gen, *a, **k)
        if cur_len + 1 == gen.max_length:
            return scores
        return scores.scatter(-1, scores.argmax(-1, keepdim=True),
                              -torch.inf)

    monkeypatch.setattr(generate, "_process_logits", second_best)
    check = execute(run())["check"]
    assert check["token_gap"]["value"] <= check["token_gap"]["limit"]
    assert check["non_greedy_share"]["value"] > \
        check["non_greedy_share"]["limit"]


def test_kind_refuses_beams():
    r = run()
    r.traffic["num_beams"] = 2
    with pytest.raises(ValueError):
        execute(r)
