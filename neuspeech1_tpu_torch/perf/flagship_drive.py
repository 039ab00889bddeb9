"""Convergence drives on the card: the counterpart of the JAX package's root
``perf/flagship_drive.py``, through the port's fine-tune CLI.

    python -m neuspeech1_tpu_torch.perf.flagship_drive [A|B|C|S|ABCS]
        --root DIR [--device cuda] [--clips 240] [FINETUNE_FLAG ...]

Phase A: whisper-base --ft_full from random weights on a 240-clip
208-channel separable synthetic corpus (`data/synthetic.py::
make_separable_corpus`: a word is a sinusoid's frequency over its span; the
held-out split is disjoint), batch 32, lr 5e-4, 600 steps, eval loss and
held-out WER at 300 and 600, gated checkpoints, the merged model exported.

Phase B: the reference's published adapter config (AdaLoRA init_r 12 ->
target_r 4, tinit 200, tfinal 1000, deltaT 10, alpha 32, orthogonality
0.5), 1600 steps on phase A's merged model, on the same vocabulary and
frequencies under a permuted word -> frequency assignment (a shift in
signal space with the text unchanged, which the encoder adapters and the
stem can learn with the decoder frozen).

Phase C: the reference's other adapter config, plain LoRA r=32 alpha=64,
600 steps on phase B's corpus and phase A's model.

Phase S: the Schoffelen transfer recipe (``scripts/reproduce_schoffelen.sh``)
on synthetic recordings, in Dutch. The recipe's language needs a tokenizer
with Whisper's language block (Dutch is language 12; the byte tokenizer's
layout has 2), so phase S runs phases A and C again on a word vocabulary
of 50257 entries, the corpora's words first, which keeps whisper-base's
special-token layout: the base (phase A's recipe, the recipe's pretrained
model) and a 208-channel adapter (phase C's flags on a shifted 208-channel
corpus). Then the recipe's fine-tune flags (``--lora_model`` with
``--lora_eeg_ch 208 --eeg_ch 273 --channel_slice schoffelen --language
Dutch --use_adalora True``, batch 64, lr 1e-3) on a 301-channel separable
corpus under another shift, cut to the schoffelen slice's 273 channels:
the adapter merged into the base first, the stem re-initialized for 273
channels; then ``cli.merge_lora`` of the final adapter onto the base, as
the script does, and ``cli.evaluation`` at beam 5, repetition penalty
5.0, no-repeat-ngram 2. The transfer's schedule is cut to the drive: 600
steps, warmup 100, AdaLoRA tinit 100 and tfinal 200, evals every 300 (the
recipe's 500 epochs of real recordings are not here).

Each phase ends in the JAX script's ``_summarize`` JSON line (the loop's
median samples/s, the held-out WER, BLEU-1 and eval-loss trajectories, the
last kept best eval); phase S prints its eval CLI's metrics and result
files first. Flags after the phases go to every fine-tune run (a test cuts
steps and geometry with them; geometry flags also reach ``merge_lora``).
Phases B and C read phase A's outputs under the same root.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Optional

CLIPS = 240
# the flags that fix the model's geometry: merge_lora takes them too
GEOMETRY = ("d_model", "encoder_layers", "decoder_layers", "encoder_heads",
            "decoder_heads", "encoder_ffn", "decoder_ffn",
            "max_source_positions", "max_target_positions")
# a vocabulary this long keeps whisper-base's special-token layout
WORD_VOCAB = 50257


def _summarize(tag: str, out_dir: str, emit: Callable[[str], None]) -> dict:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    sps = [r["samples_per_sec"] for r in recs if "samples_per_sec" in r]
    best = [r.get("best_eval") for r in recs
            if r.get("best_eval") is not None]
    out = {
        "phase": tag,
        "sustained_samples_per_sec": (sorted(sps)[len(sps) // 2]
                                      if sps else None),
        "heldout_wer_trajectory": [(r["step"], r["eval_wer"]) for r in recs
                                   if "eval_wer" in r],
        "bleu1_trajectory": [(r["step"], r.get("eval_bleu1", 0.0))
                             for r in recs if "eval_bleu1" in r],
        "eval_loss_trajectory": [(r["step"], r["eval_loss"]) for r in recs
                                 if "eval_loss" in r],
        "best_eval_kept": best[-1] if best else None,
    }
    emit(json.dumps(out))
    return out


class Drive:
    """The phases' shared settings: output ``root``, ``device``, corpus
    size, and the ``extra`` flags every fine-tune run takes last."""

    def __init__(self, root: str, device: str = "cuda", clips: int = CLIPS,
                 extra: Optional[List[str]] = None,
                 emit: Callable[[str], None] = print):
        self.root, self.device, self.clips = root, device, clips
        self.extra = list(extra or [])
        self.emit = emit
        os.makedirs(root, exist_ok=True)

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def corpus(self, name: str, **kw) -> str:
        from neuspeech1_tpu_torch.data.synthetic import make_separable_corpus

        corpus = self.path(name)
        if not os.path.exists(os.path.join(corpus, "train.jsonl")):
            make_separable_corpus(corpus, n_clips=self.clips, **kw)
        return corpus

    def finetune(self, argv: List[str]) -> None:
        from neuspeech1_tpu_torch.cli.finetune import main as finetune

        finetune(argv + [f"--device={self.device}"] + self.extra)

    def geometry(self) -> List[str]:
        return [a for a in self.extra
                if a.lstrip("-").split("=")[0] in GEOMETRY]

    def base(self) -> str:
        base = self.path("runA", "full_model", "params.npz")
        if not os.path.exists(base):
            raise FileNotFoundError(f"run phase A first ({base} missing)")
        return base


def phase_a(d: Drive) -> dict:
    corpus = d.corpus("corpusA", n_channels=208, seed=3)
    out = d.path("runA")
    d.finetune([
        f"--train_data={corpus}/train.jsonl",
        f"--val_data={corpus}/test.jsonl",
        "--base_model=random", "--tokenizer=byte", "--eeg_ch=208",
        "--max_steps=600", "--per_device_train_batch_size=32",
        "--per_device_eval_batch_size=32",
        "--ft_full=True", "--learning_rate=0.0005", "--warmup_steps=50",
        "--eval_steps=300", "--save_steps=300", "--logging_steps=50",
        "--label_max_length=32", "--eval_wer=True", "--remat=False",
        "--export_full_model=True",
        f"--output_dir={out}",
    ])
    return _summarize("A_ft_full", out, d.emit)


def _shifted_corpus(d: Drive) -> str:
    # the same vocabulary and frequency ladder, the assignment permuted
    return d.corpus("corpusB", n_channels=208, seed=11,
                    freq_order=[3, 0, 4, 1, 5, 2])


def phase_b(d: Drive) -> dict:
    base, corpus = d.base(), _shifted_corpus(d)
    out = d.path("runB")
    d.finetune([
        f"--train_data={corpus}/train.jsonl",
        f"--val_data={corpus}/test.jsonl",
        f"--base_model={base}", "--tokenizer=byte", "--eeg_ch=208",
        "--max_steps=1600", "--per_device_train_batch_size=32",
        "--per_device_eval_batch_size=32",
        # the published AdaLoRA config (reference finetune.py:205-208)
        "--use_adalora=True", "--lora_rank=12", "--lora_alpha=32",
        "--adalora_target_r=4", "--adalora_tinit=200",
        "--adalora_tfinal=1000", "--adalora_deltaT=10",
        "--orth_reg_weight=0.5",
        "--learning_rate=0.001", "--warmup_steps=100",
        "--eval_steps=400", "--save_steps=400", "--logging_steps=50",
        "--label_max_length=32", "--eval_wer=True", "--remat=False",
        f"--output_dir={out}",
    ])
    return _summarize("B_adalora_published", out, d.emit)


# the published plain-LoRA config (reference finetune.py:210-211)
LORA_FLAGS = ("--use_adalora=False", "--lora_rank=32", "--lora_alpha=64",
              "--learning_rate=0.001", "--warmup_steps=100")


def phase_c(d: Drive) -> dict:
    base, corpus = d.base(), _shifted_corpus(d)
    out = d.path("runC")
    d.finetune([
        f"--train_data={corpus}/train.jsonl",
        f"--val_data={corpus}/test.jsonl",
        f"--base_model={base}", "--tokenizer=byte", "--eeg_ch=208",
        "--max_steps=600", "--per_device_train_batch_size=32",
        "--per_device_eval_batch_size=32", *LORA_FLAGS,
        "--eval_steps=300", "--save_steps=300", "--logging_steps=50",
        "--label_max_length=32", "--eval_wer=True", "--remat=False",
        f"--output_dir={out}",
    ])
    return _summarize("C_lora_published", out, d.emit)


def word_vocab(path: str) -> str:
    """A ``word:`` tokenizer spec: the synthetic corpora's words, then
    fillers up to ``WORD_VOCAB`` entries."""
    from neuspeech1_tpu_torch.data.synthetic import _WORDS

    words = list(dict.fromkeys(_WORDS))
    words += [f"<w{i}>" for i in range(WORD_VOCAB - len(words))]
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")
    return f"word:{path}"


def phase_s(d: Drive) -> dict:
    from neuspeech1_tpu_torch.cli.evaluation import main as evaluation
    from neuspeech1_tpu_torch.cli.merge_lora import main as merge_lora

    tokenizer = word_vocab(d.path("vocabS.txt"))
    c208 = d.corpus("corpusS208", n_channels=208, seed=13, language="Dutch")
    c208b = d.corpus("corpusS208b", n_channels=208, seed=11,
                     language="Dutch", freq_order=[3, 0, 4, 1, 5, 2])
    # 301 channels, of which the schoffelen slice keeps 28..300
    c273 = d.corpus("corpusS273", n_channels=301, seed=17, language="Dutch",
                    freq_order=[1, 2, 0, 5, 3, 4])
    common = [f"--tokenizer={tokenizer}", "--language=Dutch",
              "--max_steps=600", "--eval_steps=300", "--save_steps=300",
              "--logging_steps=50", "--label_max_length=32",
              "--eval_wer=True", "--remat=False"]
    run_base, run208, run273 = (d.path(r) for r in ("runS", "runS208",
                                                    "runS273"))
    # the recipe's pretrained base: phase A's recipe in this layout
    d.finetune([f"--train_data={c208}/train.jsonl",
                f"--val_data={c208}/test.jsonl", "--base_model=random",
                "--eeg_ch=208", "--per_device_train_batch_size=32",
                "--per_device_eval_batch_size=32", "--ft_full=True",
                "--learning_rate=0.0005", "--warmup_steps=50",
                "--export_full_model=True", *common,
                f"--output_dir={run_base}"])
    _summarize("S_base_208", run_base, d.emit)
    base = os.path.join(run_base, "full_model", "params.npz")
    # the 208-channel run whose adapter the recipe transfers: phase C's
    d.finetune([f"--train_data={c208b}/train.jsonl",
                f"--val_data={c208b}/test.jsonl", f"--base_model={base}",
                "--eeg_ch=208", "--per_device_train_batch_size=32",
                "--per_device_eval_batch_size=32", *LORA_FLAGS, *common,
                f"--output_dir={run208}"])
    _summarize("S_adapter_208", run208, d.emit)
    slice_flags = ["--eeg_ch=273", "--channel_slice=schoffelen",
                   "--language=Dutch"]
    d.finetune([f"--train_data={c273}/train.jsonl",
                f"--val_data={c273}/test.jsonl", f"--base_model={base}",
                f"--lora_model={run208}/adapter_final.npz",
                "--lora_eeg_ch=208", *slice_flags, "--use_adalora=True",
                "--per_device_train_batch_size=64",
                "--per_device_eval_batch_size=64", "--learning_rate=0.001",
                "--warmup_steps=100", "--adalora_tinit=100",
                "--adalora_tfinal=200", *common,
                f"--output_dir={run273}"])
    merged = merge_lora([f"--lora_model={run273}/adapter_final.npz",
                         f"--base_model={base}", f"--tokenizer={tokenizer}",
                         "--eeg_ch=273", f"--device={d.device}",
                         *d.geometry()])
    eval_dir = os.path.join(run273, "eval")
    metrics = evaluation([f"--test_data={c273}/test.jsonl",
                          f"--model_path={merged}",
                          f"--tokenizer={tokenizer}", *slice_flags,
                          "--num_beams=5", "--repetition_penalty=5.0",
                          "--no_repeat_ngram_size=2",
                          f"--output_dir={eval_dir}",
                          f"--device={d.device}"])
    d.emit(json.dumps({"phase": "S_eval", "merged_model": merged,
                       "metrics": {k: float(v) for k, v in metrics.items()},
                       "result_files": sorted(os.listdir(eval_dir))}))
    return _summarize("S_transfer_273", run273, d.emit)


PHASES = {"A": phase_a, "B": phase_b, "C": phase_c, "S": phase_s}

# the CPU-scale gate of the JAX package's tests/test_convergence.py: the
# held-out WER at step 400 at most this
CONVERGENCE_WER = 0.15


def convergence_argv(corpus: str, out: str) -> List[str]:
    """tests/test_convergence.py's fine-tune argv on ``corpus``
    (``make_separable_corpus(corpus, n_clips=300, n_channels=8, seed=3)``),
    400 steps at a d_model-48 geometry."""
    return [
        f"--train_data={corpus}/train.jsonl",
        f"--val_data={corpus}/test.jsonl",   # gate on the held-out split
        "--base_model=random", "--tokenizer=byte", "--eeg_ch=8",
        "--max_audio_len=1.6", "--min_audio_len=0.5",
        "--max_steps=400", "--per_device_train_batch_size=16",
        "--per_device_eval_batch_size=16",
        "--ft_full=True", "--learning_rate=0.002", "--warmup_steps=20",
        "--eval_steps=400", "--save_steps=400", "--logging_steps=100",
        "--label_max_length=32", "--eval_wer=True",
        f"--output_dir={out}",
        "--d_model=48", "--encoder_layers=2", "--decoder_layers=2",
        "--encoder_heads=2", "--decoder_heads=2", "--encoder_ffn=96",
        "--decoder_ffn=96", "--max_source_positions=80",
        "--max_target_positions=48", "--bf16=False", "--remat=False",
        "--mesh_data=1", "--num_workers=2",
    ]


def main(argv: Optional[List[str]] = None,
         emit: Callable[[str], None] = lambda s: print(s, flush=True)
         ) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="?", default="AB",
                    help="the phases to run, in order (default AB)")
    ap.add_argument("--root", required=True, help="output root")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clips", type=int, default=CLIPS,
                    help="clips of each synthetic corpus")
    args, extra = ap.parse_known_args(argv)
    d = Drive(args.root, args.device, args.clips, extra, emit)
    return {p: PHASES[p](d) for p in args.phases.upper()}


if __name__ == "__main__":
    main()
