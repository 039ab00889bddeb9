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
            if name in ("jax", "neuspeech1_tpu") or name.startswith(
                    ("jax.", "jaxlib", "neuspeech1_tpu.")):
                raise ImportError(f"the port imported {name}")
            return None

    def check_clean(after):
        bad = [m for m in sys.modules
               if m in ("jax", "neuspeech1_tpu")
               or m.startswith(("jax.", "neuspeech1_tpu."))]
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

    # one LoRA training step (fold_lora, the 'fc' regime) on the CPU
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.train import optimizer, trainstep
    assert {"neuspeech1_tpu_torch.models.lora",
            "neuspeech1_tpu_torch.train.optimizer",
            "neuspeech1_tpu_torch.train.trainstep",
            "neuspeech1_tpu_torch.decode.spec",
            "neuspeech1_tpu_torch.models.quantize",
            "neuspeech1_tpu_torch.data.manifest"} <= set(names)
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
