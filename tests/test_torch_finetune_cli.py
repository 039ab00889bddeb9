"""The port's fine-tune and merge CLIs (neuspeech1_tpu_torch/cli/finetune.py,
merge_lora.py) against the JAX package's, in f32 on the CPU, on the eval
CLI tests' corpus, word vocabulary and full model (the same npz weights for
both): the same output files and metrics.jsonl keys; adapter_final.npz
with the same keys and shapes; each package's merge_lora and eval CLI read
the other's adapter (merged weights within rtol 1e-6 / atol 1e-6 of the
other package's merge, eval result files byte for byte equal); the HF
export; --fine_tune_layers; --resume_from_checkpoint by step and latest;
and the refused flags raising before any model loads."""

import json
import os

import numpy as np
import pytest
import torch

from neuspeech1_tpu.cli.finetune import main as jax_finetune
from neuspeech1_tpu.cli.merge_lora import main as jax_merge
from neuspeech1_tpu_torch.cli import common as tcommon
from neuspeech1_tpu_torch.cli.finetune import main as port_finetune
from neuspeech1_tpu_torch.cli.merge_lora import main as port_merge
from neuspeech1_tpu_torch.models.convert import load_npz
from tests.test_torch_eval_cli import GEO, make_eval_setup, run_both

torch.set_num_threads(1)

MERGE_RTOL = MERGE_ATOL = 1e-6
GEO_FLAGS = [f"--{k}={v}" for k, v in GEO.items()]


def _train_argv(s, out, *extra):
    return [f"--train_data={s['corpus']}/train.jsonl",
            f"--val_data={s['corpus']}/val.jsonl",
            f"--base_model={s['model_dir']}/params.npz",
            f"--tokenizer={s['common'][1].split('=', 1)[1]}", "--eeg_ch=4",
            "--max_audio_len=0.64", "--min_audio_len=0.5", "--max_steps=6",
            "--per_device_train_batch_size=2", "--learning_rate=0.01",
            "--warmup_steps=2", "--eval_steps=3", "--save_steps=3",
            "--logging_steps=3", "--label_max_length=24", "--bf16=False",
            "--remat=False", "--mesh_data=1", "--adalora_tinit=1",
            "--adalora_tfinal=2", "--adalora_deltaT=1", "--eval_wer=True",
            "--export_full_model=True", f"--output_dir={out}", *GEO_FLAGS,
            *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both finetune CLIs at their defaults (AdaLoRA, orth 0.5, the fold)
    on the same argv and weights."""
    s = make_eval_setup(str(tmp_path_factory.mktemp("finetune_cli")))
    out = {"jax": os.path.join(s["root"], "ft_jax"),
           "port": os.path.join(s["root"], "ft_port")}
    jax_finetune(_train_argv(s, out["jax"]))
    port_finetune(_train_argv(s, out["port"], "--device=cpu"))
    return s, out


def _log(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_same_output_files(runs):
    """The JAX trainer's files but ``tb/``: its TensorBoard scalars, which
    it writes where tensorflow imports and the port does not write at all
    (`train/trainer.py`)."""
    _, out = runs
    names = {k: sorted(set(os.listdir(v)) - {"tb"}) for k, v in out.items()}
    assert names["port"] == names["jax"]
    assert "tb" not in os.listdir(out["port"])
    assert {"adapter_final.npz", "metrics.jsonl", "checkpoints",
            "full_model"} <= set(names["port"])
    steps = {k: sorted(d for d in os.listdir(os.path.join(v, "checkpoints"))
                       if d.isdigit()) for k, v in out.items()}
    assert steps["port"] == steps["jax"] == ["3", "6"]
    assert sorted(os.listdir(os.path.join(out["port"], "full_model"))) == \
        sorted(os.listdir(os.path.join(out["jax"], "full_model")))


def test_same_metrics_keys(runs):
    """The same kinds of record, each with the same keys in the same order
    (whether a gated save happens depends on each run's eval loss, and the
    two runs' adapters start from different draws)."""
    _, out = runs
    keys = {k: {tuple(r) for r in _log(v)} for k, v in out.items()}
    assert keys["port"] == keys["jax"] == {
        ("step", "loss", "grad_norm", "samples_per_sec", "epoch"),
        ("step", "eval_loss", "eval_wer", "eval_bleu1"),
        ("step", "saved", "best_eval")}


def test_adapter_keys_and_shapes_equal(runs):
    _, out = runs
    files = {k: np.load(os.path.join(v, "adapter_final.npz"))
             for k, v in out.items()}
    assert sorted(files["port"].files) == sorted(files["jax"].files)
    for name in files["jax"].files:
        assert files["port"][name].shape == files["jax"][name].shape, name
        assert files["port"][name].dtype == files["jax"][name].dtype, name
    assert "lora/encoder/layers/fc1/E" in files["port"].files
    assert "model/encoder/stem/conv_a/w" in files["port"].files


@pytest.mark.parametrize("adapter_of", ["jax", "port"])
def test_merges_read_each_others_adapter(runs, adapter_of):
    """Each package's merge_lora on the same adapter gives the same full
    model; the HF exports agree too."""
    s, out = runs
    adapter = os.path.join(out[adapter_of], "adapter_final.npz")
    argv = [f"--lora_model={adapter}",
            f"--base_model={s['model_dir']}/params.npz",
            f"--tokenizer={s['common'][1].split('=', 1)[1]}", "--eeg_ch=4",
            "--export_hf=True", *GEO_FLAGS]
    dirs = {"jax": jax_merge(argv + [
                f"--output_dir={s['root']}/merged_jax_{adapter_of}"]),
            "port": port_merge(argv + [
                "--device=cpu",
                f"--output_dir={s['root']}/merged_port_{adapter_of}"])}
    for name in ("params.npz", "hf_state_dict.npz"):
        got = np.load(os.path.join(dirs["port"], name))
        ref = np.load(os.path.join(dirs["jax"], name))
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            np.testing.assert_allclose(got[k], ref[k], rtol=MERGE_RTOL,
                                       atol=MERGE_ATOL, err_msg=k)
    with open(os.path.join(dirs["port"], "config.json")) as f:
        port_cfg = json.load(f)
    with open(os.path.join(dirs["jax"], "config.json")) as f:
        assert port_cfg == json.load(f)
    # the adapters moved the merged weights off the base
    base = load_npz(f"{s['model_dir']}/params.npz")
    merged = load_npz(os.path.join(dirs["port"], "params.npz"))
    assert not np.array_equal(
        merged["encoder"]["layers"]["fc1"]["w"],
        base["encoder"]["layers"]["fc1"]["w"])


@pytest.mark.parametrize("adapter_of", ["jax", "port"])
def test_eval_clis_read_each_others_adapter(runs, adapter_of):
    """Both eval CLIs on the base model with the other package's
    --lora_model write the same files byte for byte."""
    s, out = runs
    adapter = os.path.join(out[adapter_of], "adapter_final.npz")
    run_both(s, s["common"] + s["base"] + [f"--lora_model={adapter}",
                                           "--num_beams=1"],
             f"ft_{adapter_of}")


def test_export_full_model_equals_merge(runs):
    """--export_full_model writes the base with the trained adapters
    folded: the merge CLI's model from adapter_final.npz."""
    s, out = runs
    exported = load_npz(os.path.join(out["port"], "full_model", "params.npz"))
    merged = load_npz(os.path.join(port_merge([
        f"--lora_model={out['port']}/adapter_final.npz",
        f"--base_model={s['model_dir']}/params.npz",
        f"--tokenizer={s['common'][1].split('=', 1)[1]}", "--eeg_ch=4",
        "--device=cpu", f"--output_dir={s['root']}/export_check",
        *GEO_FLAGS]), "params.npz"))
    for path in (("encoder", "layers", "fc1", "w"),
                 ("encoder", "layers", "self_attn", "q", "w"),
                 ("encoder", "stem", "conv_a", "w")):
        a, b = exported, merged
        for p in path:
            a, b = a[p], b[p]
        np.testing.assert_allclose(a, b, rtol=MERGE_RTOL, atol=MERGE_ATOL,
                                   err_msg="/".join(path))


def test_fine_tune_layers_adapts_first_n(runs, tmp_path):
    """--fine_tune_layers=1 on two encoder layers: nonzero alpha only on
    layer 0 (tests/test_cli.py::test_fine_tune_layers_adapts_first_n)."""
    s, _ = runs
    out = str(tmp_path / "ftl")
    geo2 = [g if not g.startswith("--encoder_layers")
            else "--encoder_layers=2" for g in _train_argv(s, out)]
    # the base npz has one encoder layer: draw the port's own weights
    geo2 = [g if not g.startswith("--base_model") else "--base_model=random"
            for g in geo2]
    port_finetune(geo2 + ["--max_steps=2", "--use_adalora=False",
                          "--fine_tune_layers=1", "--lora_rank=2",
                          "--eval_wer=False", "--export_full_model=False",
                          "--device=cpu"])
    adapter = tcommon.load_adapter(f"{out}/adapter_final.npz")
    for name in ("q", "k", "v", "out"):
        alpha = np.asarray(adapter["lora"]["encoder"]["layers"]["self_attn"]
                           [name]["alpha"]).ravel()
        assert alpha[0] != 0.0 and np.all(alpha[1:] == 0.0), alpha
    fc1 = adapter["lora"]["encoder"]["layers"]["fc1"]
    assert fc1["A"].shape == (2, GEO["d_model"], 2)


@pytest.mark.parametrize("resume,first", [("latest", 6), ("3", 3)])
def test_resume_from_checkpoint(runs, tmp_path, resume, first, capsys):
    """--resume_from_checkpoint=latest picks the newest step, an integer
    that step; the run continues from it to --max_steps."""
    s, out = runs
    run = str(tmp_path / "resume")
    import shutil

    shutil.copytree(out["port"], run)
    state = port_finetune(_train_argv(
        s, run, "--device=cpu", "--max_steps=8", "--eval_wer=False",
        "--export_full_model=False", f"--resume_from_checkpoint={resume}"))
    assert state.step == 8
    assert f"[train] resumed from step {first}" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="saved steps"):
        port_finetune(_train_argv(
            s, run, "--device=cpu", "--max_steps=8",
            "--resume_from_checkpoint=4"))


REFUSED = {
    "mesh_fsdp": ["--mesh_fsdp=2"],
    "mesh_fsdp_beside_data": ["--mesh_data=2", "--mesh_fsdp=2"],
    "mesh_tensor_with_coordinator": ["--coordinator=localhost:1234",
                                     "--mesh_tensor=2"],
    "mesh_tensor": ["--mesh_tensor=4"],
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_flags_raise_before_loading(case, monkeypatch, tmp_path):
    """A mesh the one-process world cannot hold is refused before any
    rendezvous or model load (FSDP and tensor parallelism run since they
    were ported: tests/test_torch_fsdp.py)."""
    def no_load(*a, **k):
        raise AssertionError("a model was loaded")

    monkeypatch.setattr(tcommon, "load_base_params", no_load)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="ranks"):
        port_finetune(["--train_data=missing.jsonl", "--device=cpu",
                       f"--output_dir={tmp_path}", *REFUSED[case]])
    assert not os.listdir(tmp_path)
