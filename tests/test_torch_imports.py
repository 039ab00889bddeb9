"""The PyTorch port never imports JAX, nor anything of the JAX package
neuspeech1_tpu (not even a module that does not import JAX): the machine it
serves and trains on has neither."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, sys, tempfile

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            # the JAX package, and the root bench.py and perf/ probes
            if name in ("jax", "neuspeech1_tpu", "bench", "perf") or \
                    name.startswith(("jax.", "jaxlib", "neuspeech1_tpu.",
                                     "perf.")):
                raise ImportError(f"the port imported {name}")
            return None

    def check_clean(after):
        bad = [m for m in sys.modules
               if m in ("jax", "neuspeech1_tpu", "bench", "perf")
               or m.startswith(("jax.", "neuspeech1_tpu.", "perf."))]
        assert not bad, (after, bad)

    sys.meta_path.insert(0, NoJax())

    import numpy as np
    import torch
    import neuspeech1_tpu_torch
    from neuspeech1_tpu_torch.config import StemConfig, tiny_config

    names = [m.name for m in pkgutil.walk_packages(
        neuspeech1_tpu_torch.__path__, "neuspeech1_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    assert {"neuspeech1_tpu_torch.bench",
            "neuspeech1_tpu_torch.perf.kernel_probe",
            "neuspeech1_tpu_torch.perf.mxu_probe",
            "neuspeech1_tpu_torch.perf.btc_probe",
            "neuspeech1_tpu_torch.perf.bwd_probe",
            "neuspeech1_tpu_torch.ops.probe_fwd",
            "neuspeech1_tpu_torch.ops.probe_bwd",
            "neuspeech1_tpu_torch.ops.probe_dot"} <= set(names), names
    check_clean("importing every module")

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.models.init import init_params
    from neuspeech1_tpu_torch.serve import Transcriber

    torch.set_num_threads(1)
    config = tiny_config()
    stem = StemConfig("base", in_channels=4)
    with tempfile.TemporaryDirectory() as tmp:
        common.save_full_model(tmp, init_params(config, stem, seed=0),
                               config, stem)
        texts = Transcriber(tmp, batch_size=2, max_new_tokens=4,
                            device="cpu").transcribe(
            np.ones((3, 4, 400), np.float32))
        assert len(texts) == 3, texts
        check_clean("greedy Transcriber")
        texts = Transcriber(tmp, batch_size=2, max_new_tokens=4,
                            num_beams=3, repetition_penalty=5.0,
                            no_repeat_ngram_size=2, device="cpu").transcribe(
            np.ones((3, 4, 400), np.float32))
        assert len(texts) == 3, texts
        check_clean("beam Transcriber")
        manifest = os.path.join(tmp, "train.jsonl")
        with open(manifest, "w") as f:
            f.write('{"sentence": "a b a b a c"}\\n')
        texts = Transcriber(tmp, batch_size=2, max_new_tokens=4,
                            spec_gamma=3, spec_draft_from=manifest,
                            device="cpu").transcribe(
            np.ones((3, 4, 400), np.float32))
        assert len(texts) == 3, texts
        check_clean("speculative Transcriber")
        texts = Transcriber(tmp, batch_size=2, max_new_tokens=4,
                            int8_kv_cache=True, device="cpu").transcribe(
            np.ones((3, 4, 400), np.float32))
        assert len(texts) == 3, texts
        check_clean("int8-cache Transcriber")

        # the eval CLI end to end on the CPU: manifest, native or Python
        # loader, beam decode with a sequence bias, metrics, result files
        from neuspeech1_tpu_torch.cli import evaluation
        from neuspeech1_tpu_torch.data.synthetic import make_synthetic_corpus
        corpus = os.path.join(tmp, "corpus")
        make_synthetic_corpus(corpus, n_clips=5, n_channels=4, seed=1,
                              min_dur=0.5, max_dur=1.0, with_audio=False)
        metrics = evaluation.main([
            f"--test_data={corpus}/all.jsonl", f"--model_path={tmp}",
            "--eeg_ch=4", "--batch_size=2", "--max_new_tokens=4",
            "--num_beams=3", "--max_audio_len=2.0", "--per_sentence=True",
            "--sequence_bias=True", f"--train_data={corpus}/train.jsonl",
            "--device=cpu", f"--output_dir={tmp}/eval"])
        assert "wer" in metrics and "meteor" in metrics, metrics
        assert sorted(os.listdir(f"{tmp}/eval")) == [
            "all_beam3.json", "all_beam3.jsonl", "all_beam3.txt",
            "all_beam3_per_sentence.jsonl"], os.listdir(f"{tmp}/eval")
        check_clean("eval CLI")

    # one LoRA training step (fold_lora, the 'fc' regime) on the CPU
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.train import optimizer, trainstep
    assert {"neuspeech1_tpu_torch.models.lora",
            "neuspeech1_tpu_torch.train.optimizer",
            "neuspeech1_tpu_torch.train.trainstep",
            "neuspeech1_tpu_torch.decode.spec",
            "neuspeech1_tpu_torch.models.quantize",
            "neuspeech1_tpu_torch.data.manifest",
            "neuspeech1_tpu_torch.cli.evaluation",
            "neuspeech1_tpu_torch.data.collate",
            "neuspeech1_tpu_torch.data.dataset",
            "neuspeech1_tpu_torch.data.loader",
            "neuspeech1_tpu_torch.data.native_loader",
            "neuspeech1_tpu_torch.data.synthetic",
            "neuspeech1_tpu_torch.decode.sequence_bias",
            "neuspeech1_tpu_torch.decode.yake",
            "neuspeech1_tpu_torch.metrics.battery",
            "neuspeech1_tpu_torch.metrics.bertscore",
            "neuspeech1_tpu_torch.metrics.bleu",
            "neuspeech1_tpu_torch.metrics.edit",
            "neuspeech1_tpu_torch.metrics.meteor",
            "neuspeech1_tpu_torch.metrics.perplexity",
            "neuspeech1_tpu_torch.metrics.rouge",
            "neuspeech1_tpu_torch.utils.args",
            "neuspeech1_tpu_torch.utils.text",
            "neuspeech1_tpu_torch.utils.zh_t2s"} <= set(names)
    model = module_from_params(init_params(config, stem, seed=0), config,
                               stem, device="cpu", dtype=torch.float32)
    tx = optimizer.make_optimizer(warmup_steps=0)
    state, frozen = trainstep.init_train_state(
        model, init_lora(config, rank=4, alpha=8, device="cpu"), tx)
    step = trainstep.make_train_step(config, stem, tx, fold_lora=True)
    metrics = step(state, frozen, {
        "input_features": torch.ones((2, 4, 400)),
        "labels": torch.ones((2, 5), dtype=torch.long),
        "decoder_input_ids": torch.ones((2, 5), dtype=torch.long)})
    assert float(metrics["grad_norm"]) > 0, metrics
    check_clean("training step")

    # one sequence-parallel step, the encoder on a LocalRing of 2 threads
    import dataclasses
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel.ring_attention import LocalRing
    assert {"neuspeech1_tpu_torch.parallel.mesh",
            "neuspeech1_tpu_torch.parallel.ring_attention"} <= set(names)
    sp_config = dataclasses.replace(config, seq_parallel_axis="seq")

    def sp_rank(ring):
        model = module_from_params(init_params(config, stem, seed=0),
                                   sp_config, stem, device="cpu",
                                   dtype=torch.float32)
        state, frozen = trainstep.init_train_state(
            model, init_lora(config, rank=4, alpha=8, device="cpu"), tx)
        step = trainstep.make_train_step(sp_config, stem, tx, fold_lora=True)
        with pmesh.set_mesh({"seq": ring}):
            return float(step(state, frozen, {
                "input_features": torch.ones((2, 4, 400)),
                "labels": torch.ones((2, 5), dtype=torch.long),
                "decoder_input_ids": torch.ones((2, 5), dtype=torch.long),
            })["grad_norm"])

    norms = LocalRing.run(sp_rank, 2)
    assert norms[0] == norms[1] > 0, norms
    check_clean("sequence-parallel training step")
    print("modules", len(names))
""")


def test_port_runs_without_jax():
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split("modules")[-1])
    assert n_modules >= 12, proc.stdout
