"""Speech-modality eval CLI of the PyTorch port: the counterpart of
``neuspeech1_tpu/cli/evaluation_speech.py`` (the reference's
`evaluation_speech.py`).

    python -m neuspeech1_tpu_torch.cli.evaluation_speech \
        --test_data=test.jsonl --model_path=full_model [--device=cuda]

Pipeline sanity check: run the (stock-weight) Whisper speech model on the
paired 16 kHz audio of the same jsonl manifests, decode, score. Validates
data/labels independently of the EEG stem. The JAX CLI's flags and
defaults (beam 5, batch 8, 128 new tokens, punctuation removed) and its
result files ``{base}_speech.{txt,jsonl,json}``; in f32 on the CPU, on the
same manifest, weights and flags, they are the JAX CLI's byte for byte.

Differences from the JAX CLI:
- ``--device`` (default ``cuda``) picks the card or, when asked, the CPU;
  with ``cuda`` and no CUDA it exits with an error, and it never falls
  back.
- ``--base_model=random`` draws the port's own seeded weights, not the JAX
  package's (`cli/common.py::load_base_params`).
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from neuspeech1_tpu_torch.utils.args import add_arguments

    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("test_data", str, None, "test jsonl manifest (needs speech paths)")
    add_arg("model_path", str, None, "full model dir (config.json+params.npz)")
    add_arg("base_model", str, "random", "base params (npz/HF dir/'random')")
    add_arg("tokenizer", str, "byte", "'byte' or HF tokenizer dir")
    add_arg("model_size", str, None, "whisper preset: tiny|base|small|medium|large")
    add_arg("language", str, "English", "decode language")
    add_arg("task", str, "transcribe",
            "decode-prefix task token: transcribe|translate")
    add_arg("remove_pun", bool, True,
            "strip punctuation from preds+labels before metrics (the "
            "reference's speech eval applies it unconditionally, "
            "evaluation_speech.py:146-147)")
    add_arg("batch_size", int, 8, "decode batch size")
    add_arg("num_workers", int, 4, "loader threads")
    add_arg("num_beams", int, 5, "beam width")
    add_arg("repetition_penalty", float, 1.0, "repetition penalty")
    add_arg("no_repeat_ngram_size", int, 0, "ngram ban")
    add_arg("max_new_tokens", int, 128, "decode budget")
    add_arg("suppress_tokens", str, "default",
            "'default' (HF lists derived from the tokenizer vocab), "
            "'none', or comma-separated ids")
    add_arg("output_dir", str, "eval_output/", "results dir")
    add_arg("bf16", bool, True, "bf16 compute (without --model_path)")
    for name in ("d_model", "encoder_layers", "decoder_layers", "encoder_heads",
                 "decoder_heads", "encoder_ffn", "decoder_ffn",
                 "max_source_positions", "max_target_positions"):
        add_arg(name, int, None, f"override {name}")
    add_arg("device", str, "cuda", "'cuda' (the card) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device={args.device}: CUDA is not available; pass "
            "--device=cpu to decode on the CPU")
    from neuspeech1_tpu_torch.utils.args import print_arguments

    print_arguments(args)

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.config import StemConfig
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import SpeechDataset
    from neuspeech1_tpu_torch.data.loader import DataLoader
    from neuspeech1_tpu_torch.decode.generate import (GenerationConfig,
                                                      generate)
    from neuspeech1_tpu_torch.metrics.battery import (compute_battery,
                                                      write_results)

    if args.model_path:
        params, config, stem = common.load_full_model(args.model_path)
        tokenizer = common.resolve_tokenizer(args.tokenizer, config)
    else:
        config = common.parse_config_overrides(args)
        stem = StemConfig("speech")
        tokenizer = common.resolve_tokenizer(args.tokenizer, config)
        config = tokenizer.config
        params = common.load_base_params(args.base_model, config, stem)
    # the model moves to the device once, in its compute dtype
    model = common.commit_params(params, config, stem, device)

    ds = SpeechDataset(args.test_data, tokenizer, language=args.language,
                       task=args.task, n_mels=config.num_mel_bins)
    collator = Collator(pad_id=tokenizer.pad_id, decoder_start_id=config.sot_id,
                        max_label_len=128)
    loader = DataLoader(ds, collator, args.batch_size, shuffle=False,
                        drop_last=False, num_threads=args.num_workers,
                        prefetch=2)

    prompt = np.asarray(
        [tokenizer.prefix_tokens(args.language, args.task)], np.int32
    )
    gen = GenerationConfig.for_model(
        config,
        max_length=prompt.shape[1] + args.max_new_tokens,
        num_beams=args.num_beams,
        repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size,
        **common.suppress_kwargs(args.suppress_tokens, tokenizer),
    )

    preds, refs = [], []
    for batch in loader:
        feats = batch["input_features"]
        b = feats.shape[0]
        # model-dtype upload halves the copy's bytes (exact: the encoder
        # casts on entry). compact=False: log-mel padding is the mel floor,
        # not zeros, so the zero-tail crop does not apply to speech features.
        out = generate(
            model,
            common.upload_features(feats, model.dtype, device, compact=False),
            torch.as_tensor(np.repeat(prompt, b, 0), dtype=torch.long,
                            device=device),
            gen)
        preds.extend(tokenizer.batch_decode(out.cpu().numpy()))
        for i in range(b):
            refs.append(tokenizer.decode(batch["labels"][i]))

    if args.remove_pun:
        from neuspeech1_tpu_torch.utils import text as tx

        preds, refs = tx.remove_punctuation(preds), tx.remove_punctuation(refs)
    metrics = compute_battery(preds, refs)
    base = os.path.splitext(os.path.basename(args.test_data))[0]
    files = write_results(
        os.path.join(args.output_dir, f"{base}_speech"), preds, refs, metrics
    )
    print({k: round(float(v), 4) for k, v in metrics.items()})
    print(f"[evaluation_speech] wrote {files}")
    return metrics


if __name__ == "__main__":
    main()
