"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, at the tiny size on the CPU, against the real
cells' limits (the look for a chip is the only part of a run skipped).
The cells run on one chip, so no exchange between chips can be left out."""

import pytest
import torch

from benchmark.lib import spec
from benchmark.run import execute
from benchmark.tests import tiny


def limits(cell):
    return spec.load_json(spec.BENCH_DIR / "limits" / f"{cell}.json")


def test_train_sound_run_is_correct():
    assert execute(tiny.run("train_step", limits("base-train-b64")))[
        "correct"]


def test_train_state_left_unchanged(monkeypatch):
    from neuspeech1_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.Optimizer, "update",
                        lambda self, *a, **k: None)
    out = execute(tiny.run("train_step", limits("base-train-b64")))
    assert not out["correct"]
    assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch(monkeypatch):
    from neuspeech1_tpu_torch.train import trainstep

    make = trainstep.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def run(state, frozen, batch):
            return step(state, frozen,
                        {n: v[:v.shape[0] // 2] for n, v in batch.items()})
        return run

    monkeypatch.setattr(trainstep, "make_train_step", halved)
    assert not execute(tiny.run("train_step",
                                limits("base-train-b64")))["correct"]


def _broken_generate(monkeypatch, fault):
    from neuspeech1_tpu_torch.decode import generate

    real = generate.generate_over_mesh

    def broken(model, feats, prompt, gen, **kw):
        return fault(real, model, feats, prompt, gen, **kw)

    monkeypatch.setattr(generate, "generate_over_mesh", broken)


def test_decode_sound_run_is_correct():
    assert execute(tiny.run("decode", limits("base-beam-b128")))["correct"]


def test_decode_token_altered(monkeypatch):
    def fault(real, model, feats, prompt, gen, **kw):
        out = real(model, feats, prompt, gen, **kw).clone()
        col = prompt.shape[1] + 1
        out[:, col] = (out[:, col] + model.config.vocab_size // 2) % \
            model.config.eot_id
        return out

    _broken_generate(monkeypatch, fault)
    assert not execute(tiny.run("decode",
                                limits("base-beam-b128")))["correct"]


def test_decode_greedy_tokens(monkeypatch):
    """Greedy tokens served for the beam's keep the token rule (every
    token within its row's 2K best, the last the row's best) and fail the
    greedy share."""
    import dataclasses

    def fault(real, model, feats, prompt, gen, **kw):
        return real(model, feats, prompt,
                    dataclasses.replace(gen, num_beams=1), **kw)

    _broken_generate(monkeypatch, fault)
    check = execute(tiny.run("decode", limits("base-beam-b128")))["check"]
    assert check["token_gap"]["value"] <= check["token_gap"]["limit"]
    assert check["greedy_share"]["value"] > check["greedy_share"]["limit"]


def test_decode_half_the_batch(monkeypatch):
    def fault(real, model, feats, prompt, gen, **kw):
        half = feats.shape[0] // 2
        out = real(model, feats[:half], prompt[:half], gen, **kw)
        return torch.cat([out, out])

    _broken_generate(monkeypatch, fault)
    assert not execute(tiny.run("decode",
                                limits("base-beam-b128")))["correct"]
