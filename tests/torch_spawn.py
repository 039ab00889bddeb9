"""Process bodies that tests start with ``torch.multiprocessing.spawn``.

This module imports neither JAX nor the JAX package, so that the processes
spawn starts, which import it to find their function, stay quick."""

import os
import socket


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def finetune_rank(rank, world, port, argv, coordinator):
    """One process of a multi-process fine-tune CLI run: rank and world
    size in the environment, as torchrun gives them, with the rendezvous
    from torchrun's MASTER_ADDR/MASTER_PORT or, with ``coordinator``, from
    ``--coordinator``."""
    import torch

    from neuspeech1_tpu_torch.cli.finetune import main

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if coordinator:
        argv = [*argv, f"--coordinator=127.0.0.1:{port}"]
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    main(argv)


def dp_step_rank(rank, world, store_path, out_dir, params, shards, config,
                 stem):
    """One process of a data-parallel train step over gloo: the full
    fine-tune step on this process's loader shard of the global batch; the
    trainable leaves after the step and the loss go to
    ``out_dir/rank{rank}.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from neuspeech1_tpu_torch.models.convert import module_from_params
    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.train import optimizer as topt
    from neuspeech1_tpu_torch.train import trainstep as tts

    torch.set_num_threads(1)
    pmesh.initialize_distributed("gloo", store=dist.FileStore(store_path,
                                                              world),
                                 rank=rank, world_size=world)
    try:
        model = module_from_params(params, config, stem, device="cpu",
                                   dtype=torch.float32)
        tx = topt.make_optimizer(peak_lr=1e-3, warmup_steps=0, total_steps=4,
                                 grad_clip=None)
        state, frozen = tts.init_train_state(
            model, None, tx, topt.default_trainable_pred(ft_full=True))
        step = tts.make_train_step(config, stem, tx)
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 shards[rank].items()}
        for k in ("labels", "decoder_input_ids"):
            batch[k] = batch[k].long()
        with pmesh.set_mesh(pmesh.make_mesh("cpu", data=-1)):
            m = step(state, frozen, batch)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 loss=float(m["loss"]),
                 **{k.replace("/", "."): t.detach().numpy()
                    for k, t in state.trainable.items()})
    finally:
        dist.destroy_process_group()


def staged_hop_rank(rank, world, store_path, out_dir):
    """One process of a gloo group hopping tensors around the ring both
    ways, once on the group's own send and receive and once through the
    host staging that CUDA tensors take over gloo (here host tensors stand
    in for device ones: the staging's device checks and copies are
    replaced); the results and the staging's counters go to
    ``out_dir/rank{rank}.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from neuspeech1_tpu_torch.parallel import mesh as pmesh
    from neuspeech1_tpu_torch.parallel import ring_attention as ra
    from neuspeech1_tpu_torch.train import profiling

    torch.set_num_threads(1)
    pmesh.initialize_distributed("gloo", store=dist.FileStore(store_path,
                                                              world),
                                 rank=rank, world_size=world)
    try:
        ring = pmesh.axis_ring("seq", pmesh.make_mesh("cpu", seq=world))
        x = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank
        y = torch.full((4,), rank, dtype=torch.int64)
        assert not ra.host_staged(ring.group, (x, y))
        plain = ring.permute(x, y) + ring.permute_back(x, y)
        before = profiling.counters()
        ra.host_staged = lambda group, tensors: True
        ra._pinned = lambda t: torch.empty(t.shape, dtype=t.dtype)
        ra._synchronize = lambda t: None
        staged = ring.permute(x, y) + ring.permute_back(x, y)
        got = profiling.counter_changes(before)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 plain=np.stack([t.double().numpy().ravel()[:4]
                                 for t in plain]),
                 staged=np.stack([t.double().numpy().ravel()[:4]
                                  for t in staged]),
                 counts=np.asarray([got["ring.staged_hops"],
                                    got["ring.staged_bytes"],
                                    got["ring.staged_ms"] > 0]))
    finally:
        dist.destroy_process_group()
