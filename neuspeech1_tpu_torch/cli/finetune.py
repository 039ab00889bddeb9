"""Fine-tune CLI of the PyTorch port: the counterpart of
``neuspeech1_tpu/cli/finetune.py`` (the reference's `finetune.py`).

    python -m neuspeech1_tpu_torch.cli.finetune --train_data=train.jsonl \
        --val_data=val.jsonl --output_dir=out [--device=cuda]

The JAX CLI's flags and defaults: AdaLoRA (init_r 12, target_r 4,
orthogonality weight 0.5), ``--remat=auto``, ``--device_cache=auto``,
``--fold_lora_in_step=True``, best-eval-gated checkpoints and resume. It
writes the JAX CLI's files (but TensorBoard's ``tb/``, see
``train/trainer.py``): ``metrics.jsonl``, ``checkpoints/`` (the port's
own format, ``train/checkpoint.py``), ``adapter_final.npz`` (the JAX
package's keys and layout, so either package's ``merge_lora`` and eval CLI
read it) and, with ``--export_full_model``, ``full_model/``.

Differences from the JAX CLI:
- ``--device`` (default ``cuda``) picks the card or, when asked, the CPU;
  with ``cuda`` and no CUDA it raises, and it never falls back.
- Data parallelism runs one process per rank, as torchrun starts them
  (``torchrun --nproc_per_node=N -m neuspeech1_tpu_torch.cli.finetune
  ...``: rank, world size and ``MASTER_ADDR``/``MASTER_PORT`` in the
  environment), or from ``--coordinator=host:port`` with ``RANK`` and
  ``WORLD_SIZE`` in the environment: NCCL on ``cuda:<LOCAL_RANK>``, gloo
  with ``--device=cpu``; a process group already up when ``main`` runs is
  used as it is. The mesh is ``{data, fsdp, tensor}`` as the JAX CLI's
  ``make_mesh``: ``--mesh_data`` (-1: the world size over fsdp x tensor),
  ``--mesh_fsdp`` and ``--mesh_tensor``; a mesh that does not fit the
  world (``WORLD_SIZE``) is refused before any rendezvous. The model is
  split over ``fsdp`` and ``tensor`` (``parallel/sharding.py``). As in the
  JAX CLI ``--per_device_train_batch_size`` is the global batch: each
  process takes its strided rows of every batch by its batch coordinate
  over ``data`` x ``fsdp`` (``data/loader.py``; the ranks of a tensor group
  take the same rows), and the device caches are off when the world is
  larger than one. The mesh's first rank alone writes the logs,
  checkpoints (whole tensors), adapter and exported model.
- ``--modal=speech`` trains the ``speech`` stem (in place of
  ``--stem_kind``) on ``SpeechDataset``'s log-mel features [80, 3000],
  computed per item on the host; as in the JAX CLI the native loader and
  the device caches are off, and of ``--augment_config_path`` only the
  train step's part (noise, mask, taylor) applies.
- ``--augment_config_path`` is split as in the JAX CLI: ``shift`` goes to
  the train dataset (per item on the host; with its probability above 0
  the device caches are off, and with any augment config the native
  loader is: ``--native_loader=on`` raises), ``noise``, ``mask`` and
  ``taylor`` to the train step, which draws them on the device from the
  state's ``torch.Generator`` (``ops/augment.py``), not from
  ``jax.random``.
- ``--base_model=random`` draws the port's own seeded weights, and the
  adapters (and a stem re-initialized for ``--lora_eeg_ch``) come from a
  ``torch.Generator``: for the same seed they differ from the JAX
  package's ``jax.random`` draws. Runs that compare the packages hand both
  the same npz weights.
- The device cache draws its batch order on the device with a
  ``torch.Generator`` (``data/device_cache.py``); the rotating cache and
  the threaded loader keep the JAX package's numpy orders.
- The memory plan behind ``--remat=auto`` reads the CUDA device's memory
  (``train/memory.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os


def build_parser() -> argparse.ArgumentParser:
    from neuspeech1_tpu_torch.utils.args import add_arguments

    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    # data (reference finetune.py:25-42)
    add_arg("train_data", str, None, "train jsonl manifest")
    add_arg("val_data", str, None, "validation jsonl manifest")
    add_arg("test_data", str, None, "optional test jsonl manifest")
    add_arg("language", str, "English", "dataset language (None = per-row)")
    add_arg("task", str, "transcribe",
            "label-prefix task token: transcribe|translate "
            "(reference finetune.py:51)")
    add_arg("timestamps", bool, False, "train with timestamp labels")
    add_arg("combine_sentences", bool, False, "random sentence combining aug")
    add_arg("split_sentences", bool, False, "random sentence splitting aug")
    add_arg("filter_dataset", bool, False, "keep only ZINNEN <30s rows")
    add_arg("subj", int, None, "restrict to one subject id")
    add_arg("data_ratio", float, 1.0, "use the first fraction of the data")
    add_arg("augment_config_path", str, None, "augmentation JSON path")
    add_arg("eeg_ch", int, 208, "signal channels (208 gwilliams/273 schoffelen)")
    add_arg("channel_slice", str, None, "named channel preset or None")
    add_arg("min_audio_len", float, 0.5, "min clip seconds")
    add_arg("max_audio_len", float, 30.0, "max clip seconds")
    # model
    add_arg("base_model", str, "random", "npz / HF dir / 'random'")
    add_arg("tokenizer", str, "byte", "'byte' or HF tokenizer dir")
    add_arg("model_size", str, None, "whisper preset: tiny|base|small|medium|large")
    add_arg("stem_kind", str, "base", "projection stem: base|replace|speech")
    add_arg("modal", str, "eeg", "eeg or speech")
    add_arg("d_model", int, None, "override d_model")
    add_arg("encoder_layers", int, None, "override encoder layers")
    add_arg("decoder_layers", int, None, "override decoder layers")
    add_arg("encoder_heads", int, None, "override encoder heads")
    add_arg("decoder_heads", int, None, "override decoder heads")
    add_arg("encoder_ffn", int, None, "override encoder ffn")
    add_arg("decoder_ffn", int, None, "override decoder ffn")
    add_arg("max_source_positions", int, None, "override source positions")
    add_arg("max_target_positions", int, None, "override target positions")
    add_arg("bf16", bool, True, "bf16 compute (fp32 otherwise)")
    add_arg("remat", str, "auto",
            "rematerialize encoder layers: auto|true|false (auto = remat "
            "only when the faster no-remat step won't fit the device's "
            "memory; train/memory.py)")
    # adapters (reference finetune.py:189-212)
    add_arg("use_adalora", bool, True, "AdaLoRA (True) or plain LoRA (False)")
    add_arg("lora_rank", int, None, "LoRA rank (default 32; AdaLoRA init_r 12)")
    add_arg("lora_alpha", float, None, "LoRA alpha (default 64; AdaLoRA 32)")
    add_arg("adalora_target_r", int, 4, "AdaLoRA target rank")
    add_arg("adalora_tinit", int, 200, "AdaLoRA warmup steps")
    add_arg("adalora_tfinal", int, 1000, "AdaLoRA final steps")
    add_arg("adalora_deltaT", int, 10, "AdaLoRA reallocation interval")
    add_arg("orth_reg_weight", float, 0.5, "AdaLoRA orthogonal reg weight")
    add_arg("ft_full", bool, False, "full fine-tune (no adapters)")
    add_arg("fine_tune_layers", int, None,
            "adapt only the FIRST n encoder layers (reference "
            "finetune.py:190 range(n) semantics)")
    add_arg("lora_model", str, None, "pretrained adapter npz to merge first")
    add_arg("lora_eeg_ch", int, None, "channel count of --lora_model's stem")
    # training (reference finetune.py:231-253)
    add_arg("output_dir", str, "output/", "checkpoints + logs dir")
    add_arg("learning_rate", float, 1e-3, "peak lr")
    add_arg("warmup_steps", int, 500, "lr warmup steps")
    add_arg("num_train_epochs", int, 500, "epochs (ignored if max_steps)")
    add_arg("max_steps", int, None, "hard step limit")
    add_arg("per_device_train_batch_size", int, 64, "train batch per device")
    add_arg("per_device_eval_batch_size", int, 64, "eval batch per device")
    add_arg("gradient_accumulation_steps", int, 1,
            "optax MultiSteps-style accumulation")
    add_arg("eval_steps", int, 1000, "eval interval")
    add_arg("save_steps", int, 1000, "save interval")
    add_arg("logging_steps", int, 100, "log interval")
    add_arg("save_total_limit", int, 5, "max checkpoints kept")
    add_arg("resume_from_checkpoint", str, None,
            "resume: True/latest = newest saved step, an integer = that "
            "step (reference takes a checkpoint path, finetune.py:53)")
    add_arg("eval_wer", bool, False,
            "greedy-decode the val set at each eval and log WER/BLEU-1")
    add_arg("export_full_model", bool, False,
            "also write output_dir/full_model with adapters merged "
            "(reference SaveFullModelCallback, utils/callback.py:55-72)")
    add_arg("fold_lora_in_step", bool, True,
            "merge the attention adapters into the weights once per step "
            "and run the fc adapters through the folded linear")
    add_arg("int8_matmul", str, "off",
            "int8 training matmuls: off|fwd|full (fwd = forward dots "
            "quantized; full = backward dots too)")
    add_arg("num_workers", int, 4, "loader threads")
    add_arg("device_cache", str, "auto",
            "stage the whole train set on the device and sample there: "
            "auto|on|off (auto = when it fits the budget and no per-item "
            "signal transforms are active)")
    add_arg("device_cache_budget_mb", int, 4096,
            "device memory budget for --device_cache=auto")
    add_arg("device_cache_shard_repeats", int, 4,
            "bigger-than-budget corpora rotate through device-resident "
            "shards; passes per resident shard while the next stages")
    add_arg("native_loader", str, "auto",
            "C++ batch signal loader: auto|on|off (auto = use when no "
            "per-item augmentation and the toolchain builds)")
    add_arg("weight_decay", float, 0.0, "AdamW weight decay")
    add_arg("max_grad_norm", float, 1.0, "gradient clipping")
    add_arg("label_max_length", int, 128, "static label pad length")
    # mesh
    add_arg("coordinator", str, None,
            "coordinator address host:port of a multi-process run (rank "
            "and world size from RANK and WORLD_SIZE)")
    add_arg("mesh_data", int, -1, "data-parallel mesh axis (-1 = all)")
    add_arg("mesh_fsdp", int, 1, "fsdp mesh axis")
    add_arg("mesh_tensor", int, 1, "tensor-parallel mesh axis")
    add_arg("seed", int, 0, "global seed")
    add_arg("device", str, "cuda", "'cuda' (the card) or 'cpu'")
    return parser


def mesh_axes(args) -> dict:
    """The mesh's axis sizes for the world this process belongs to (the
    process group's, else ``WORLD_SIZE``, else 1); raises ValueError where
    the flags do not fit it."""
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel.mesh import resolve_axes

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    return resolve_axes(world, data=args.mesh_data, fsdp=args.mesh_fsdp,
                        tensor=args.mesh_tensor)


def parse_resume(resume):
    """--resume_from_checkpoint: False, True (the latest step) or a step."""
    if isinstance(resume, str):
        if resume.lower() in ("false", "none", ""):
            return False
        if resume.lower() in ("true", "latest"):
            return True
        return int(resume)  # a specific saved step (0 is valid)
    return False if resume is None else resume


def split_augment(path):
    """(dataset config, step config) of the augment JSON at ``path``:
    ``shift`` needs the transcript realigned per item on the host; noise,
    mask and taylor run on the device inside the train step. Either is
    None when empty."""
    if not path:
        return None, None
    import json

    with open(path) as f:
        config = json.load(f)
    if not config:
        return None, None
    host = {k: v for k, v in config.items() if k == "shift"}
    device = {k: v for k, v in config.items()
              if k in ("noise", "mask", "taylor")} or None
    return host, device


def main(argv=None):
    args = build_parser().parse_args(argv)
    from neuspeech1_tpu_torch.utils.args import print_arguments

    print_arguments(args)
    mesh_axes(args)

    import torch
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device={args.device}: CUDA is not available; pass "
            "--device=cpu to train on the CPU")
    if args.coordinator:
        # the JAX CLI's rendezvous address, as torchrun passes it
        host, port = args.coordinator.rsplit(":", 1)
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port)
    started = not dist.is_initialized() and pmesh.initialize_distributed(
        "nccl" if device.type == "cuda" else "gloo")
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        axes = mesh_axes(args)
        mesh = None
        if dist.is_initialized():
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            mesh = pmesh.make_mesh(device.type, **axes)
        with pmesh.set_mesh(mesh):
            return _train(args, device, world)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, device, world: int):
    """The run on this process's ``device``, one of ``world`` ranks, under
    the ambient mesh."""
    import torch

    from neuspeech1_tpu_torch.cli import common
    from neuspeech1_tpu_torch.config import StemConfig
    from neuspeech1_tpu_torch.data.collate import Collator
    from neuspeech1_tpu_torch.data.dataset import EEGDataset, SpeechDataset
    from neuspeech1_tpu_torch.data.loader import DataLoader
    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.models.init import init_stem
    from neuspeech1_tpu_torch.models.lora import init_lora
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel import sharding
    from neuspeech1_tpu_torch.train import memory as trainmem
    from neuspeech1_tpu_torch.train import optimizer as opt
    from neuspeech1_tpu_torch.train import trainstep as ts
    from neuspeech1_tpu_torch.train.trainer import Trainer

    config = common.parse_config_overrides(args)
    if args.modal == "speech":
        stem = StemConfig("speech")
    else:
        stem = StemConfig(args.stem_kind, in_channels=args.eeg_ch)
    tokenizer = common.resolve_tokenizer(args.tokenizer, config)
    config = tokenizer.config
    if args.int8_matmul not in ("off", "fwd", "full"):
        raise ValueError(f"--int8_matmul={args.int8_matmul}: off|fwd|full")
    host_augment, device_augment = split_augment(args.augment_config_path)
    shift_on = bool(host_augment
                    and host_augment.get("shift", {}).get("prob", 0))

    # ---- datasets ---------------------------------------------------
    def make_ds(path, mode):
        if args.modal == "speech":
            # no per-item augmentation: the shift realigns EEG transcripts
            return SpeechDataset(path, tokenizer, language=args.language,
                                 task=args.task,
                                 n_mels=config.num_mel_bins, mode=mode)
        return EEGDataset(
            path, tokenizer, mode=mode, modal_ch=args.eeg_ch,
            channel_slice=args.channel_slice, language=args.language,
            task=args.task, filter_dataset=args.filter_dataset,
            timestamps=args.timestamps, min_duration=args.min_audio_len,
            max_duration=args.max_audio_len,
            combine_sentences=args.combine_sentences,
            split_sentences=args.split_sentences, subj=args.subj,
            augment_config=host_augment if mode == "train" else None,
            seed=args.seed)

    train_ds = make_ds(args.train_data, "train")
    if args.data_ratio < 1.0:
        train_ds.rows = train_ds.rows[: int(len(train_ds.rows)
                                            * args.data_ratio)]
    val_ds = make_ds(args.val_data, "eval") if args.val_data else None

    collator = Collator(
        pad_id=tokenizer.pad_id, decoder_start_id=config.sot_id,
        max_label_len=args.label_max_length,
        feature_dtype="bfloat16" if args.bf16 else "float32",
        eot_id=config.eot_id)

    def use_native(ds) -> bool:
        if args.native_loader == "off" or args.modal == "speech":
            return False
        if not ds.supports_native_signals():
            if args.native_loader == "on":
                raise ValueError("--native_loader=on but augmentation is "
                                 "active")
            return False
        from neuspeech1_tpu_torch.data.native_loader import native_available

        ok = native_available()
        if args.native_loader == "on" and not ok:
            raise RuntimeError("--native_loader=on but the C++ loader "
                               "failed to build")
        return ok

    def corpus_bytes(ds) -> int:
        # bf16 features dominate
        return len(ds) * args.eeg_ch * int(args.max_audio_len * 200) * 2

    # ---- remat: the fast no-remat step iff params + optimizer + cached
    # corpus + saved activations fit the device (train/memory.py) ----
    # the device caches hold EEG clips only, and one process's whole batch
    eligible = (args.modal == "eeg" and not shift_on
                and not args.combine_sentences and not args.split_sentences
                and world == 1)
    cache_eligible = args.device_cache != "off" and eligible
    would_cache = cache_eligible and (
        corpus_bytes(train_ds) <= args.device_cache_budget_mb * 2**20)
    remat = trainmem.resolve_remat(
        args.remat, config, stem, args.per_device_train_batch_size,
        trainable_count=trainmem.trainable_count_estimate(
            config, stem, ft_full=args.ft_full, lora_rank=args.lora_rank,
            adalora=args.use_adalora),
        corpus_bytes=corpus_bytes(train_ds) if would_cache else 0,
        label_len=args.label_max_length, device=device)
    if str(args.remat).lower() == "auto":
        print(f"[finetune] --remat=auto -> remat={remat}", flush=True)
    if remat != config.remat:
        config = dataclasses.replace(config, remat=remat)

    # this process's rows of a global batch: those of its batch coordinate
    # over data x fsdp, shared within a tensor group
    index, count = pmesh.batch_coordinate()
    use_cache = False
    use_rotating = False
    budget_mb = args.device_cache_budget_mb
    if args.modal == "eeg" and args.device_cache != "off":
        if not remat and budget_mb > 1536:
            # without remat the saved activations claim most of the
            # device's memory: cap the AUTO cache budget
            budget_mb = 1536
            if args.device_cache == "auto":
                print("[finetune] --remat=False: device_cache auto budget "
                      f"capped at {budget_mb} MB (activations need the "
                      "memory; pass --device_cache_budget_mb to override "
                      "with --device_cache=on)", flush=True)
        fits = corpus_bytes(train_ds) <= budget_mb * 2**20
        if args.device_cache == "on":
            if not eligible:
                raise ValueError("--device_cache=on needs per-item signal "
                                 "transforms off (shift/combine/split)")
            use_cache = True
        else:
            use_cache = eligible and fits
        # a corpus over budget rotates device-resident shards
        use_rotating = (not use_cache) and eligible and not fits

    if use_cache:
        from neuspeech1_tpu_torch.data.device_cache import DeviceCache

        print(f"[finetune] staging {len(train_ds)} clips "
              f"(~{corpus_bytes(train_ds)/2**20:.0f} MB) on {device}",
              flush=True)
        cache = DeviceCache.build(train_ds, collator, device=device)
        train_loader = cache.loader(args.per_device_train_batch_size,
                                    seed=args.seed)
    elif use_rotating:
        from neuspeech1_tpu_torch.data.rotating_cache import (
            RotatingDeviceCache)

        per_clip = corpus_bytes(train_ds) // max(len(train_ds), 1)
        shard_clips = RotatingDeviceCache.shards_for_budget(
            budget_mb * 2**20, per_clip)
        shard_clips = max(shard_clips, args.per_device_train_batch_size)
        print(f"[finetune] corpus (~{corpus_bytes(train_ds)/2**20:.0f} MB) "
              f"exceeds the {budget_mb} MB cache budget: rotating "
              f"{shard_clips}-clip device shards x"
              f"{args.device_cache_shard_repeats} repeats", flush=True)
        train_loader = RotatingDeviceCache(
            train_ds, collator, shard_clips=shard_clips,
            batch_size=args.per_device_train_batch_size, device=device,
            seed=args.seed, shard_repeats=args.device_cache_shard_repeats)
    else:
        # the global batch, of which this process takes its rows
        train_loader = DataLoader(
            train_ds, collator, args.per_device_train_batch_size,
            shuffle=True, seed=args.seed, num_threads=args.num_workers,
            prefetch=2, native_signals=use_native(train_ds),
            process_index=index, process_count=count)
    val_loader = (
        DataLoader(val_ds, collator, args.per_device_eval_batch_size,
                   shuffle=False, drop_last=False,
                   num_threads=args.num_workers, prefetch=2,
                   native_signals=use_native(val_ds),
                   process_index=index, process_count=count)
        if val_ds else None)

    # ---- model + adapters -------------------------------------------
    params = common.load_base_params(args.base_model, config, stem, args.seed)
    if args.lora_model:  # cross-dataset transfer (finetune.py:150-163)
        params, prev_lora = common.apply_adapter(
            params, common.load_adapter(args.lora_model))
        if prev_lora:
            params = common.merge_params(params, prev_lora, device=device)
        if args.lora_eeg_ch is not None and args.lora_eeg_ch != args.eeg_ch:
            # re-initialize the stem for the new channel count
            params["encoder"]["stem"] = init_stem(config, stem,
                                                  seed=args.seed + 1)
            print(f"[finetune] stem re-initialized: {args.lora_eeg_ch} -> "
                  f"{args.eeg_ch} channels")

    lora = None
    adalora_cfg = None
    if not args.ft_full:
        layer_range = None
        if args.fine_tune_layers is not None:
            # the reference adapts the FIRST n encoder layers
            layer_range = (0, min(args.fine_tune_layers,
                                  config.encoder_layers))
        if args.use_adalora:
            rank = args.lora_rank or 12
            lora = init_lora(config, rank=rank, alpha=args.lora_alpha or 32.0,
                             adalora=True, seed=args.seed + 2, device=device,
                             layer_range=layer_range)
            adalora_cfg = {
                "init_r": rank, "target_r": args.adalora_target_r,
                "tinit": args.adalora_tinit, "tfinal": args.adalora_tfinal,
                "deltaT": args.adalora_deltaT,
                "total_steps": args.max_steps or 10_000,
            }
        else:
            lora = init_lora(config, rank=args.lora_rank or 32,
                             alpha=args.lora_alpha or 64.0,
                             seed=args.seed + 2, device=device,
                             layer_range=layer_range)

    # f32 masters on the device; compute in config.dtype; this rank's
    # shards under mesh fsdp/tensor axes
    model = sharding.shard_params(module_from_params(
        params, config, stem, device=device, dtype=torch.float32))
    total_steps = args.max_steps or (
        args.num_train_epochs * max(len(train_loader), 1))
    tx = opt.make_optimizer(
        peak_lr=args.learning_rate, warmup_steps=args.warmup_steps,
        total_steps=total_steps, weight_decay=args.weight_decay,
        grad_clip=args.max_grad_norm,
        accum_steps=args.gradient_accumulation_steps)
    state, frozen = ts.init_train_state(
        model, lora, tx, opt.default_trainable_pred(ft_full=args.ft_full),
        seed=args.seed + 3)

    trainer = Trainer(
        config, stem, tx, state, frozen,
        train_loader=train_loader, eval_loader=val_loader,
        output_dir=args.output_dir, max_steps=args.max_steps,
        num_epochs=None if args.max_steps else args.num_train_epochs,
        eval_steps=args.eval_steps, save_steps=args.save_steps,
        logging_steps=args.logging_steps, max_to_keep=args.save_total_limit,
        orth_reg_weight=(args.orth_reg_weight
                         if (lora is not None and args.use_adalora) else 0.0),
        adalora=adalora_cfg,
        fold_lora=args.fold_lora_in_step,
        int8_matmul=args.int8_matmul,
        augment_config=device_augment,
        generate_eval_tokenizer=tokenizer if args.eval_wer else None,
        generate_eval_language=args.language,
        generate_eval_task=args.task)
    state = trainer.train(
        resume_from_checkpoint=parse_resume(args.resume_from_checkpoint))

    # whole weights on every rank (a collective), written by one
    whole = sharding.gather_params(model)
    if trainer.writer:
        _save_final(args, common, state, whole, lora, config, stem, device)
    pmesh.barrier()
    trainer.ckpt.close()
    return state


def _save_final(args, common, state, model, lora, config, stem, device):
    """adapter_final.npz and, with --export_full_model, full_model/, from
    the whole ``model``."""
    # the final adapter (the PEFT checkpoint's counterpart)
    final = os.path.join(args.output_dir, "adapter_final.npz")
    common.save_adapter(final, common.trainable_tree(state.trainable, model,
                                                     lora))
    print(f"[finetune] final adapter saved to {final}")
    if args.export_full_model:
        from neuspeech1_tpu_torch.models.convert import (
            params_from_lora, params_from_module)

        merged = params_from_module(model)
        if lora:
            merged = common.merge_params(merged, params_from_lora(lora),
                                         device=device)
        out = common.save_full_model(
            os.path.join(args.output_dir, "full_model"), merged, config,
            stem)
        print(f"[finetune] merged full model saved to {out}")


if __name__ == "__main__":
    main()
