"""Merge CLI of the PyTorch port: the counterpart of
``neuspeech1_tpu/cli/merge_lora.py`` (the reference's `merge_lora.py`).

    python -m neuspeech1_tpu_torch.cli.merge_lora \
        --lora_model=out/adapter_final.npz --base_model=base.npz [--device=cuda]

Folds an adapter npz (either package's ``adapter_final.npz``: the stem
overrides and the LoRA or AdaLoRA tree) into the base weights and writes
``full_model/`` (``params.npz`` + ``config.json``, which both packages' eval
CLIs read) next to the adapter unless ``--output_dir`` says otherwise; with
``--export_hf`` also ``hf_state_dict.npz`` in HF whisper's names. The merge
runs in f32 on ``--device`` (default ``cuda``; ``cpu`` when asked), with the
JAX package's order of operations. ``--base_model=random`` draws the port's
own seeded weights, not the JAX package's.
"""

from __future__ import annotations

import argparse
import functools
import os


def build_parser() -> argparse.ArgumentParser:
    from neuspeech1_tpu_torch.utils.args import add_arguments

    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("lora_model", str, None, "adapter npz produced by finetune")
    add_arg("base_model", str, "random", "base params (npz/HF dir/'random')")
    add_arg("tokenizer", str, "byte", "'byte' or HF tokenizer dir")
    add_arg("model_size", str, None, "whisper preset: tiny|base|small|medium|large")
    add_arg("stem_kind", str, "base", "projection stem kind")
    add_arg("eeg_ch", int, 208, "signal channels of the stem")
    add_arg("output_dir", str, None, "output dir (default <lora>/full_model)")
    add_arg("export_hf", bool, False, "also write an HF-layout state dict npz")
    for name in ("d_model", "encoder_layers", "decoder_layers", "encoder_heads",
                 "decoder_heads", "encoder_ffn", "decoder_ffn",
                 "max_source_positions", "max_target_positions"):
        add_arg(name, int, None, f"override {name}")
    add_arg("device", str, "cuda", "'cuda' (the card) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from neuspeech1_tpu_torch.utils.args import print_arguments

    print_arguments(args)
    assert args.lora_model and os.path.exists(args.lora_model), (
        f"adapter not found: {args.lora_model}")

    import numpy as np
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device={args.device}: CUDA is not available; pass "
            "--device=cpu to merge on the CPU")

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.config import StemConfig
    from neuspeech1_tpu_torch.models.convert import params_to_hf_state_dict

    config = common.parse_config_overrides(args)
    stem = StemConfig(args.stem_kind, in_channels=args.eeg_ch)
    config = common.resolve_tokenizer(args.tokenizer, config).config

    params = common.load_base_params(args.base_model, config, stem)
    params, lora = common.apply_adapter(params,
                                        common.load_adapter(args.lora_model))
    if lora:
        params = common.merge_params(params, lora, device=device)
        print("[merge_lora] adapters folded into base weights")

    out_dir = args.output_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.lora_model)), "full_model")
    common.save_full_model(out_dir, params, config, stem)
    if args.export_hf:
        np.savez(os.path.join(out_dir, "hf_state_dict.npz"),
                 **params_to_hf_state_dict(params, stem))
    print(f"[merge_lora] full model saved to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
