"""The port's eval CLI against the JAX package's (same argv, f32 on the CPU,
result files byte for byte, metrics exactly): the scientific controls
(teacher forcing, noise input with the random-choice baseline), the text
post-processing, the speculative greedy decode and the pipeline depth;
then the flag combinations the JAX CLI refuses exit before any model loads,
and --decode_buckets is not a flag of the port. (Sampling, contrastive
search and timestamps, refused until they were ported, are held against
the JAX CLI in tests/test_torch_eval_modes.py.)"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli import common as jax_common
from neuspeech1_tpu.config import StemConfig as JaxStem
from neuspeech1_tpu.decode import generate as jg
from neuspeech1_tpu.utils.tokenizer import make_tokenizer as jtok
from neuspeech1_tpu_torch.cli import common as port_common
from neuspeech1_tpu_torch.cli.evaluation import main as port_main
from neuspeech1_tpu_torch.config import StemConfig as PortStem
from neuspeech1_tpu_torch.config import WhisperConfig as PortConfig
from neuspeech1_tpu_torch.decode import generate as tg
from neuspeech1_tpu_torch.utils.tokenizer import make_tokenizer as ttok
from test_model_parity import hf_model, small_cfg
from test_torch_eval_cli import make_eval_setup, preds, run_both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_eval_setup(str(tmp_path_factory.mktemp("eval_controls")))


CASES = {
    "teacher_forcing": ["--teacher_forcing=True"],
    "noise_random_choice": ["--noise=True", "--random_choice=True"],
    "post_processing_remove_pun": ["--post_processing=True",
                                   "--remove_pun=True", "--to_simple=True",
                                   "--extra_name=pp"],
    "spec_gamma": ["--num_beams=1", "--repetition_penalty=1.0",
                   "--no_repeat_ngram_size=0", "--spec_gamma=4"],
    "bf16_full_upload": ["--upload_dtype=bfloat16", "--compact_upload=False",
                         "--num_workers=1"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_controls_files_equal_jax(setup, case):
    argv = setup["common"] + [f"--model_path={setup['model_dir']}"] \
        + CASES[case]
    out, metrics = run_both(setup, argv, case)
    tag = {"teacher_forcing": "tf", "noise_random_choice":
           "beam5_noise_random", "post_processing_remove_pun": "beam5_pp",
           "spec_gamma": "beam1", "bf16_full_upload": "beam5"}[case]
    assert os.path.exists(os.path.join(out, f"all_{tag}.jsonl"))
    assert len(preds(out)) == 8


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_depth_files_equal_jax(setup, depth):
    """The JAX CLI at its default depth 2 against the port at depth 1 and
    at depth 2: the same files."""
    argv = setup["common"] + [f"--model_path={setup['model_dir']}"]
    run_both(setup, argv, f"depth{depth}",
             port_extra=[f"--pipeline_depth={depth}"])


def _no_model_load(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a model was loaded")

    for name in ("load_full_model", "load_base_params", "commit_params"):
        monkeypatch.setattr(port_common, name, refuse)


REFUSED = {
    # the modes of these cases are ported; what stays refused is each one
    # combined with a flag that contradicts it, as in the JAX CLI
    "do_sample": (["--do_sample=True", "--penalty_alpha=0.6", "--top_k=4"],
                  "requires --do_sample=False"),
    "beam_sample": (["--do_sample=True", "--num_beams=5", "--spec_gamma=4"],
                    "plain greedy"),
    "penalty_alpha": (["--penalty_alpha=0.6", "--top_k=1",
                       "--num_beams=1"], "top_k > 1"),
    "timestamps": (["--timestamps=True", "--prompt_text=the",
                    "--prompt_from_labels=True"], "mutually exclusive"),
    "alpha_needs_top_k": (["--penalty_alpha=0.6"], "top_k"),
    "spec_needs_greedy": (["--spec_gamma=4"], "plain greedy"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_modes_exit_before_loading(setup, monkeypatch, case):
    """Each refused combination exits with its message before any model
    loads."""
    flags, msg = REFUSED[case]
    _no_model_load(monkeypatch)
    with pytest.raises(SystemExit, match=msg):
        port_main(setup["common"] + [f"--model_path={setup['model_dir']}",
                                     "--device=cpu"] + flags)


def test_decode_buckets_is_not_a_flag(setup, capsys):
    with pytest.raises(SystemExit) as exc:
        port_main(setup["common"] + [f"--model_path={setup['model_dir']}",
                                     "--device=cpu", "--decode_buckets=auto"])
    assert exc.value.code == 2  # argparse's usage error
    assert "--decode_buckets" in capsys.readouterr().err


def test_device_cuda_without_cuda_raises(setup, monkeypatch):
    """The default device is the card; without CUDA the CLI exits and never
    decodes on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _no_model_load(monkeypatch)
    with pytest.raises(SystemExit, match="--device=cpu"):
        port_main(setup["common"] + [f"--model_path={setup['model_dir']}"])


def test_prompt_and_hf_generation_defaults_equal_jax(setup, tmp_path):
    spec = next(a.split("=", 1)[1] for a in setup["common"]
                if a.startswith("--tokenizer="))
    for kw in (dict(), dict(language="English", task="translate",
                            timestamps=True)):
        a = jg.build_prompt(jtok(spec), **kw)
        b = tg.build_prompt(ttok(spec), **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for cfg in ({"suppress_tokens": [1, 2, 3], "begin_suppress_tokens": [7]},
                {"suppress_tokens": [], "begin_suppress_tokens": None}, {}):
        path = tmp_path / "generation_config.json"
        path.write_text(json.dumps(cfg))
        assert tg.load_hf_generation_defaults(str(path)) == \
            jg.load_hf_generation_defaults(str(path))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_base_params_from_hf_dir_equal_jax(tmp_path, fmt):
    """A local HF whisper directory as --base_model: with the speech stem
    the whole tree equals the JAX package's; with an EEG stem both swap in
    a fresh stem of the EEG geometry (each from its own generator) and
    port the body alike."""
    jcfg = small_cfg()
    tcfg = PortConfig(**dataclasses.asdict(jcfg))
    sd = {k: v.detach().clone().contiguous()
          for k, v in hf_model(jcfg).state_dict().items()}
    if fmt.endswith(".bin"):
        torch.save(sd, tmp_path / fmt)
    else:
        from safetensors.torch import save_file

        save_file(sd, str(tmp_path / fmt))
    for kind, ch in (("speech", 80), ("base", 12)):
        ours = dict(_leaves(port_common.load_base_params(
            str(tmp_path), tcfg, PortStem(kind, in_channels=ch))))
        ref = dict(_leaves(jax_common.load_base_params(
            str(tmp_path), jcfg, JaxStem(kind, in_channels=ch))))
        assert sorted(ours) == sorted(ref)
        for name in ref:
            assert ours[name].shape == ref[name].shape, name
            if kind == "speech" or "/stem/" not in name:
                assert np.array_equal(ours[name], ref[name]), name
        if kind == "base":
            assert ours["/encoder/stem/conv_a/w"].shape == (jcfg.d_model, 12, 3)
