"""The plain reference against the program at tiny widths on the CPU, in
float32: the checked training steps and the served beam tokens agree to
rounding, and the reference's own beam search finds the hypotheses the
program served; and the control, the reference computed in fp8 in the
program's place, comes out not correct."""

import pytest

from benchmark.kinds import decode as decode_kind
from benchmark.lib import harness, spec
from benchmark.run import execute
from benchmark.tests import tiny
from benchmark.tools import readings

TIGHT = {"train_step": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                        "change_gap": 1e-5},
         "decode": {"token_gap": 1e-5}}


def test_train_step_agrees_with_the_reference():
    r = tiny.run("train_step", TIGHT["train_step"])
    out = execute(r)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["check"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_beam_request_agrees_with_the_reference():
    r = tiny.run("decode", TIGHT["decode"])
    out = execute(r)
    assert out["correct"], out["check"]
    assert out["check"]["token_gap"]["value"] == 0.0


def test_reference_beam_search_serves_what_the_program_serves():
    """The reference search and the program's, both in float32, choose the
    same hypothesis for every clip."""
    import numpy as np
    import torch

    from benchmark.lib import data, weights
    from benchmark.reference import decode as ref_decode

    r = tiny.run("decode", TIGHT["decode"])
    request, pool = decode_kind.build(r)
    served = request(0)[0]
    tree = weights.param_tree(r.config, r.seed, torch.device("cpu"))
    _, found = ref_decode.searched(tree, r.config, r.traffic,
                                   pool[:served.shape[0]],
                                   data.prompt_ids(r.config), "cpu")
    np.testing.assert_array_equal(found, served)


@pytest.mark.parametrize("kind", ["train_step", "decode"])
def test_control_is_not_correct(kind):
    """At this size the program computes in float32 and reads gaps of
    rounding, under TIGHT; the control, the reference computed in fp8 in
    its place, fails TIGHT by far (on the card the limits come from the
    bf16 program's readings and the control's: PERF.md)."""
    reading = (readings.train_reading if kind == "train_step"
               else readings.decode_reading)
    tight = TIGHT[kind]
    sound = reading(tiny.run(kind, tight), "sound")
    control = reading(tiny.run(kind, tight), "fp8_reference")
    assert harness.checked(sound, tight)[0], sound
    assert not harness.checked(control, tight)[0], control
    assert max(control[k] / max(sound[k], 1e-12) for k in tight) > 100
