"""Evaluation CLI of the PyTorch port: the counterpart of
``neuspeech1_tpu/cli/evaluation.py`` (the reference's `evaluation.py`).

    python -m neuspeech1_tpu_torch.cli.evaluation --test_data=test.jsonl \
        --model_path=full_model [--device=cuda]

Decodes a test manifest with beam search (num_beams=5,
repetition_penalty=5.0, no_repeat_ngram_size=2 defaults, mirroring
`evaluation.py:369-386`), or in the JAX CLI's other modes: sampling and
beam-sample (--do_sample with --temperature, --top_k, --top_p), contrastive
search (--penalty_alpha with --top_k > 1, at one beam), self-speculative
greedy (--spec_gamma) and whisper's timestamp grammar (--timestamps); scores
with the metric battery and writes the reference's result files, tagged as
the JAX CLI tags them. On the same manifest, weights and flags, in f32 on
the CPU, they are the JAX CLI's byte for byte (for sampling, where no noise
decides). The scientific controls are the JAX CLI's: noise input (--noise),
random-choice baseline (--random_choice), teacher forcing
(--teacher_forcing).

Differences from the JAX CLI:
- ``--device`` (default ``cuda``) picks the card or, when asked, the CPU;
  with ``cuda`` and no CUDA it raises, and it never falls back.
- ``--do_sample`` draws from a ``torch.Generator`` on the device seeded
  with ``--sample_seed`` once per run, whose draws go on from batch to
  batch (the JAX CLI hands every batch the same ``jax.random`` key): a
  seed gives the same files from run to run, not the JAX CLI's draws.
- ``--decode_buckets`` is absent: length buckets only bound the fixed buffer
  shapes of XLA's decode loops and leave the tokens unchanged; the port's
  eager loops have no such buffers (ROADMAP.md "Not to port").
- ``--base_model=random`` draws the port's own seeded weights, not the JAX
  package's (`cli/common.py::load_base_params`).
- Decoding is eager and returns when its loop ends, so no decode is held
  in flight: ``--pipeline_depth`` keeps the JAX CLI's order (that many
  batches decoded before the oldest is detokenized) but overlaps nothing;
  the loader's threads prepare the next batches and the upload is pinned
  and asynchronous at any depth. Depth 1 and 2 write the same files.
"""

from __future__ import annotations

import argparse
import functools
import os
import time
from collections import deque

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    from neuspeech1_tpu_torch.utils.args import add_arguments

    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("test_data", str, None, "test jsonl manifest")
    add_arg("model_path", str, None, "full model dir (config.json+params.npz)")
    add_arg("base_model", str, None, "base model (npz/HF dir/'random')")
    add_arg("lora_model", str, None, "adapter npz to apply+merge")
    add_arg("tokenizer", str, "byte", "'byte' or HF tokenizer dir")
    add_arg("model_size", str, None, "whisper preset: tiny|base|small|medium|large")
    add_arg("stem_kind", str, "base", "projection stem kind")
    add_arg("eeg_ch", int, 208, "signal channels")
    add_arg("channel_slice", str, None, "named channel preset")
    add_arg("language", str, "English", "decode language")
    add_arg("task", str, "transcribe",
            "decode-prefix task token: transcribe|translate")
    add_arg("timestamps", bool, False, "timestamped labels")
    add_arg("filter_dataset", bool, False, "ZINNEN filter")
    add_arg("subj", int, None, "subject filter")
    add_arg("batch_size", int, 16, "decode batch size")
    add_arg("num_workers", int, 4,
            "loader threads (reference evaluation.py:32)")
    add_arg("min_audio_len", float, 0.5, "min clip seconds")
    add_arg("max_audio_len", float, 30.0,
            "max clip seconds (capped by the model's frame geometry)")
    add_arg("num_beams", int, 5, "beam width")
    add_arg("repetition_penalty", float, 5.0, "repetition penalty")
    add_arg("no_repeat_ngram_size", int, 2, "ngram ban size")
    add_arg("max_new_tokens", int, 128, "decode budget after the prompt")
    add_arg("do_sample", bool, False,
            "multinomial sampling (reference process_str.py strategies); "
            "with --num_beams>1 this is HF beam-sample — the reference "
            "runs its sampling strategies at num_beams=20; use "
            "--num_beams=1 for single-sequence sampling")
    add_arg("temperature", float, 1.0, "sampling temperature")
    add_arg("top_k", int, 0, "sampling top-k (0 = off); contrastive "
            "search's candidate count")
    add_arg("top_p", float, 1.0, "sampling top-p (1.0 = off)")
    add_arg("sample_seed", int, 0, "generator seed for --do_sample")
    add_arg("penalty_alpha", float, 0.0,
            "contrastive search degeneration penalty (reference "
            "contrastiveSearch strategy: alpha=1 with --top_k=5; active "
            "when > 0 and top_k > 1, HF mode-selection semantics)")
    add_arg("spec_gamma", int, 0,
            "self-speculative multi-token greedy decode: gamma-token "
            "draft-verify steps, token-exact vs plain greedy (>=2 "
            "activates; plain greedy only — no beams/sampling/penalties)")
    add_arg("spec_draft_from", str, None,
            "train jsonl whose text builds the corpus n-gram drafter "
            "tables for --spec_gamma (default: self-prefix lookup)")
    add_arg("teacher_forcing", bool, False, "argmax under gold prefix")
    add_arg("noise", bool, False, "replace inputs with noise (ablation)")
    add_arg("random_choice", bool, False, "random-label baseline")
    add_arg("prompt_text", str, None,
            "<|startofprev|> text prompt prepended to the decode prefix")
    add_arg("sequence_bias", bool, False, "train-set keyword bias")
    add_arg("bias_extract_type", str, "phrase_word",
            "sequence-bias entries: word|phrase|phrase_word")
    add_arg("train_data", str, None, "train jsonl (for --sequence_bias)")
    add_arg("bias_weight", float, -1.0, "sequence bias value")
    add_arg("suppress_tokens", str, "default",
            "'default' (HF lists derived from the tokenizer vocab), "
            "'none', or comma-separated ids")
    add_arg("post_processing", bool, False, "ascii+lowercase post-processing")
    add_arg("remove_pun", bool, False,
            "strip punctuation from preds+labels before metrics")
    add_arg("to_simple", bool, False,
            "traditional->simplified Chinese before metrics")
    add_arg("extra_name", str, None,
            "extra token in the result basename "
            "(reference evaluation.py:332)")
    add_arg("per_sentence", bool, False, "also write per-sentence metric rows")
    add_arg("timing", bool, False,
            "print a wall-clock phase breakdown (setup / load / decode / "
            "detokenize / metrics) at the end")
    add_arg("upload_dtype", str, "auto",
            "feature host->device upload dtype: 'auto' = the model compute "
            "dtype (exact: the encoder casts on entry), or "
            "'float32'/'bfloat16'")
    add_arg("int8_kv_cache", bool, False,
            "store the decode cross K/V cache int8 (not bit-exact vs the "
            "floating-point cache)")
    add_arg("pipeline_depth", int, 2,
            "batches decoded before the oldest is detokenized (the JAX "
            "CLI's order; the eager decode overlaps nothing at any depth)")
    add_arg("compact_upload", bool, True,
            "crop trailing zero-padding from each batch before the "
            "host->device feature upload and zero-pad back on the device "
            "(exact: clips are zero-padded to the input length)")
    add_arg("prompt_from_labels", bool, False,
            "use each sample's own label prefix as the decode prompt "
            "(reference's non-English path, evaluation.py:357-359)")
    add_arg("bertscore_model", str, None, "local encoder dir for BERTScore")
    add_arg("perplexity_model", str, None, "local causal-LM dir for ppl")
    add_arg("output_dir", str, "eval_output/", "results directory")
    add_arg("bf16", bool, True, "bf16 compute")
    add_arg("device", str, "cuda", "'cuda' (the card) or 'cpu'")
    # geometry overrides for non-base models (byte-tokenizer smoke runs)
    for name in ("d_model", "encoder_layers", "decoder_layers", "encoder_heads",
                 "decoder_heads", "encoder_ffn", "decoder_ffn",
                 "max_source_positions", "max_target_positions"):
        add_arg(name, int, None, f"override {name}")
    return parser


def _refuse(args) -> None:
    """The JAX CLI's contradiction checks, all before any model loads."""
    if args.penalty_alpha > 0:
        if args.do_sample:
            raise SystemExit(
                "--penalty_alpha (contrastive search) requires "
                "--do_sample=False: contrastive is a deterministic mode "
                "(HF mode-selection semantics); drop one of the flags")
        if args.top_k <= 1:
            raise SystemExit(
                "--penalty_alpha needs --top_k > 1 (the candidate count; "
                "the reference's contrastiveSearch uses top_k=5) — with "
                f"top_k={args.top_k} contrastive search never activates")
    if args.spec_gamma >= 2 and (
            args.do_sample or args.num_beams > 1 or args.penalty_alpha > 0
            or args.teacher_forcing or args.repetition_penalty != 1.0
            or args.no_repeat_ngram_size):
        raise SystemExit(
            "--spec_gamma (speculative decode) only applies to plain "
            "greedy: set --num_beams=1 --repetition_penalty=1.0 "
            "--no_repeat_ngram_size=0 (the eval defaults are beams=5, "
            "rp=5.0, ngram=2) and drop --do_sample/--penalty_alpha/"
            "--teacher_forcing (spec._check_supported would otherwise "
            "refuse mid-run)")
    if args.prompt_text and args.prompt_from_labels:
        raise SystemExit(
            "--prompt_text and --prompt_from_labels are mutually exclusive: "
            "the per-sample gold-prefix path assumes the 4-token special "
            "prefix, while a text prompt lengthens it (and slicing gold "
            "prefixes of that length would leak labels into the decode)")


def main(argv=None):
    t_start = time.perf_counter()
    args = build_parser().parse_args(argv)
    _refuse(args)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device={args.device}: CUDA is not available; pass "
            "--device=cpu to decode on the CPU")
    from neuspeech1_tpu_torch.utils.args import print_arguments

    print_arguments(args)

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.config import (LABEL_IGNORE_ID,
                                             SIGNAL_SAMPLE_RATE, StemConfig)
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import EEGDataset
    from neuspeech1_tpu_torch.data.loader import DataLoader
    from neuspeech1_tpu_torch.data.native_loader import native_available
    from neuspeech1_tpu_torch.decode.generate import (
        GenerationConfig, build_prompt, generate, teacher_forcing_predict)
    from neuspeech1_tpu_torch.metrics.battery import (
        compute_battery, per_sentence_metrics, random_choice_baseline,
        write_results)
    from neuspeech1_tpu_torch.utils import text as tx

    # ---- model -------------------------------------------------------
    lora = None
    if args.model_path:
        params, config, stem = common.load_full_model(args.model_path)
        tokenizer = common.resolve_tokenizer(args.tokenizer, config)
    else:
        config = common.parse_config_overrides(args)
        stem = StemConfig(args.stem_kind, in_channels=args.eeg_ch)
        tokenizer = common.resolve_tokenizer(args.tokenizer, config)
        config = tokenizer.config
        if not args.bf16:
            import dataclasses

            config = dataclasses.replace(config, dtype="float32")
        params = common.load_base_params(args.base_model, config, stem)
        if args.lora_model:
            adapter = common.load_adapter(args.lora_model)
            params, lora = common.apply_adapter(params, adapter)
    # the adapter is merged into the f32 weights, then the model moves to
    # the device once, in its compute dtype
    model = common.commit_params(params, config, stem, device, lora=lora)

    # ---- data --------------------------------------------------------
    # clip padding matches the model geometry: the stem strides by 4
    # (1500 frames <-> 6000 samples at 200 Hz)
    max_dur = min(args.max_audio_len,
                  config.max_source_positions * 4 / SIGNAL_SAMPLE_RATE)
    ds = EEGDataset(
        args.test_data, tokenizer, mode="test", modal_ch=args.eeg_ch,
        channel_slice=args.channel_slice, language=args.language,
        task=args.task, min_duration=args.min_audio_len,
        filter_dataset=args.filter_dataset, timestamps=args.timestamps,
        subj=args.subj, max_duration=max_dur,
    )
    collator = Collator(
        pad_id=tokenizer.pad_id, decoder_start_id=config.sot_id,
        max_label_len=min(128, config.max_target_positions),
        eot_id=config.eot_id,
    )
    native = native_available() and ds.supports_native_signals()
    loader = DataLoader(ds, collator, args.batch_size, shuffle=False,
                        drop_last=False, num_threads=args.num_workers,
                        prefetch=2, native_signals=native)

    bias_spec = None
    if args.sequence_bias and args.train_data:
        from neuspeech1_tpu_torch.decode.sequence_bias import (
            build_sequence_bias)

        bias_spec = build_sequence_bias(
            args.train_data, tokenizer, bias=args.bias_weight,
            extract_type=args.bias_extract_type,
        )

    if args.prompt_text:
        # <|startofprev|> text-prompt conditioning (reference
        # `utils/load_model.py:1258-1294` prompt_ids path)
        prompt = np.asarray(
            [tokenizer.prefix_tokens_with_prompt(
                args.prompt_text, args.language, args.task,
                timestamps=args.timestamps)],
            np.int32,
        )
    else:
        prompt = build_prompt(tokenizer, args.language, args.task,
                              args.timestamps)
    gen = GenerationConfig.for_model(
        config,
        max_length=prompt.shape[1] + args.max_new_tokens,
        # contrastive is single-sequence by construction; sampling keeps
        # the requested beam count (HF beam-sample when > 1)
        num_beams=1 if args.penalty_alpha > 0 else args.num_beams,
        penalty_alpha=args.penalty_alpha,
        repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size,
        timestamps=args.timestamps,  # whisper timestamp grammar
        do_sample=args.do_sample, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        spec_gamma=args.spec_gamma,
        int8_kv_cache=args.int8_kv_cache,
        **common.suppress_kwargs(args.suppress_tokens, tokenizer),
    )
    generator = (torch.Generator(device=device).manual_seed(args.sample_seed)
                 if args.do_sample else None)
    draft_table = None
    if args.spec_gamma >= 2 and args.spec_draft_from:
        from neuspeech1_tpu_torch.data.manifest import read_jsonlines
        from neuspeech1_tpu_torch.decode.spec import build_draft_table

        texts = [r["sentence"] for r in read_jsonlines(args.spec_draft_from)]
        draft_table = {
            k: torch.as_tensor(v, device=device)
            for k, v in build_draft_table(
                texts, tokenizer, config.vocab_size).items()
        }

    preds, refs = [], []
    rng = np.random.default_rng(0)
    # --timing phase accounting: 'decode' spans the feature upload, the
    # decode and the output fetch; 'load' is manifest -> collated batch
    # (np.load + pad + tokenize on the loader's thread); detok/metrics are
    # pure host
    timing = {"setup": time.perf_counter() - t_start, "load": 0.0,
              "decode": 0.0, "detok": 0.0, "metrics": 0.0}
    up_dtype = (model.dtype if args.upload_dtype == "auto"
                else getattr(torch, args.upload_dtype))

    def _prep(batch):
        """Host-side batch prep + feature upload (pinned, asynchronous on
        CUDA): the cast to the compute dtype happens on the host (the
        encoder's first step is that cast), and the trailing zero-padding
        is cropped before the copy and restored on the device."""
        feats = batch["input_features"]
        if args.noise:  # noise-input ablation (evaluation.py:354-355)
            feats = rng.standard_normal(feats.shape).astype(np.float32)
        b = feats.shape[0]
        # the final partial batch is padded to the batch size by repeating
        # its last row, as in the JAX CLI; outputs are trimmed after
        if b < args.batch_size and not args.teacher_forcing:
            pad_n = args.batch_size - b
            feats = np.concatenate(
                [feats, np.repeat(feats[-1:], pad_n, axis=0)], axis=0
            )
        return batch, b, common.upload_features(
            feats, up_dtype, device, compact=args.compact_upload)

    def _dispatch(prepped):
        """Decode a prepped batch (eagerly: the loops wait on the device
        once per step)."""
        batch, b, feats_dev = prepped
        if args.teacher_forcing:
            out_dev = teacher_forcing_predict(
                model, feats_dev,
                torch.as_tensor(batch["decoder_input_ids"], dtype=torch.long,
                                device=device))
        else:
            if args.prompt_from_labels:
                # per-sample prompt [sot, lang, task(, nots)] from the gold
                # prefix (reference labels[:, :4] path)
                P = prompt.shape[1]
                bp = np.asarray(batch["decoder_input_ids"][:, :P], np.int32)
                if bp.shape[0] < feats_dev.shape[0]:
                    bp = np.concatenate(
                        [bp, np.repeat(bp[-1:],
                                       feats_dev.shape[0] - bp.shape[0],
                                       axis=0)], axis=0)
            else:
                bp = np.repeat(prompt, feats_dev.shape[0], axis=0)
            out_dev = generate(model, feats_dev,
                               torch.as_tensor(bp, dtype=torch.long,
                                               device=device),
                               gen, bias_spec=bias_spec,
                               draft_table=draft_table, generator=generator)
        return batch, b, out_dev

    def _batches():
        """The loader's batches, prepped and uploaded ('load')."""
        batch_iter = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batch_iter, None)
            if batch is None:
                return
            prepped = _prep(batch)
            timing["load"] += time.perf_counter() - t0
            yield prepped

    def _finish(batch, b, out_dev, n_done):
        """Fetch one batch's tokens, then detokenize them."""
        labels = batch["labels"]
        t_phase = time.perf_counter()
        out = out_dev.cpu().numpy()
        timing["decode"] += time.perf_counter() - t_phase
        if args.timing:
            print(f"[evaluation] batch {n_done}: "
                  f"fetch {time.perf_counter() - t_phase:.2f}s "
                  f"(decode phase so far {timing['decode']:.2f}s)",
                  flush=True)
        t_phase = time.perf_counter()
        if args.teacher_forcing:
            # shift: prediction at position t-1 predicts token t
            for i in range(b):
                lab = labels[i]
                n = int((lab != LABEL_IGNORE_ID).sum())
                preds.append(tokenizer.decode(out[i][: n]))
        else:
            if args.prompt_text:
                # drop the prompt span so its words don't leak into preds
                out = out[:, prompt.shape[1]:]
            preds.extend(tokenizer.batch_decode(out[:b]))
        for i in range(b):
            refs.append(tokenizer.decode(labels[i]))
        timing["detok"] += time.perf_counter() - t_phase

    # --pipeline_depth batches are decoded before the oldest is fetched and
    # detokenized (the JAX CLI's order); the eager decode has ended by then
    pending: deque = deque()
    for n_batch, prepped in enumerate(_batches()):
        t0 = time.perf_counter()
        pending.append(_dispatch(prepped) + (n_batch,))
        timing["decode"] += time.perf_counter() - t0
        if len(pending) >= max(1, args.pipeline_depth):
            _finish(*pending.popleft())
    while pending:
        _finish(*pending.popleft())

    if args.random_choice:  # evaluation.py:461-476
        preds = random_choice_baseline(refs, seed=0)

    if args.post_processing:  # evaluation.py:417-421
        preds = tx.convert_lower_text(tx.filter_ascii_list(preds))
        refs = tx.convert_lower_text(tx.filter_ascii_list(refs))
    if args.remove_pun:
        preds, refs = tx.remove_punctuation(preds), tx.remove_punctuation(refs)
    if args.to_simple:
        preds, refs = tx.to_simple(preds), tx.to_simple(refs)

    t_phase = time.perf_counter()
    metrics = compute_battery(
        preds, refs,
        bertscore_model=args.bertscore_model,
        perplexity_model=args.perplexity_model,
    )
    timing["metrics"] = time.perf_counter() - t_phase
    base = os.path.splitext(os.path.basename(args.test_data))[0]
    if args.teacher_forcing:
        tag = "tf"
    elif args.penalty_alpha > 0 and args.top_k > 1 and not args.do_sample:
        tag = f"contrastive{args.top_k}"
    elif args.do_sample:
        tag = (f"beam_sample{gen.num_beams}" if gen.num_beams > 1
               else "sample")
    else:
        tag = f"beam{gen.num_beams}"
    if args.noise:
        tag += "_noise"
    if args.random_choice:
        tag += "_random"
    if args.extra_name:
        tag += f"_{args.extra_name}"
    out_prefix = os.path.join(args.output_dir, f"{base}_{tag}")
    files = write_results(out_prefix, preds, refs, metrics)
    if args.per_sentence:  # reference metrics/each_sentence_metrics.py
        import json

        t_phase = time.perf_counter()
        rows = per_sentence_metrics(preds, refs)
        ps_path = out_prefix + "_per_sentence.jsonl"
        with open(ps_path, "w", encoding="utf-8") as f:
            for pred, ref, row in zip(preds, refs, rows):
                f.write(json.dumps({"pred": pred, "label": ref, **row}) + "\n")
        files["per_sentence"] = ps_path
        timing["per_sentence"] = time.perf_counter() - t_phase
    if args.timing:
        timing["total"] = time.perf_counter() - t_start
        print("[evaluation] timing "
              + str({k: round(v, 2) for k, v in timing.items()}))
        print(f"[evaluation] native loader: {native}")
    print({k: round(float(v), 4) for k, v in metrics.items()})
    print(f"[evaluation] wrote {files}")
    return metrics


if __name__ == "__main__":
    main()
