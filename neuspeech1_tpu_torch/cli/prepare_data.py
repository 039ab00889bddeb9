"""Offline preprocessing CLI: raw BIDS datasets -> clip corpora + splits.
The port's copy of ``neuspeech1_tpu/cli/prepare_data.py`` (host only).

Counterparts of `process_dataset/gwilliams2023_process.py:234-283` and
`process_dataset/schoffelen_process.py:389-427`:

  python -m neuspeech1_tpu_torch.cli.prepare_data gwilliams \
      --data_root /data/gwilliams2023/download --out_root /data/gw_prep \
      --num_workers 8
  python -m neuspeech1_tpu_torch.cli.prepare_data schoffelen \
      --data_root /data/schoffelen/DSC_3011020.09_236_v1 \
      --out_root /data/sch_prep

Real .con/.ds recordings need MNE (optional 'preprocess' extra) and the
BIDS events tables need pandas; the slicing/scaling/manifest machinery
itself is MNE-free (`data/preprocess.py`) and imports both only where a
function reads such a file.

Differences from the JAX CLI: ``--num_workers`` above 1 spawns its worker
processes (the JAX CLI forks them).
"""

from __future__ import annotations

import argparse
import os
from functools import partial
from typing import List


def _find_files(root: str, suffix: str) -> List[str]:
    out = []
    for r, _, files in os.walk(root):
        for f in files:
            if f.endswith(suffix):
                out.append(os.path.join(r, f))
    return sorted(out)


def _finish(all_lines, out_root: str, seed: int):
    from neuspeech1_tpu_torch.data import manifest as mf

    mf.write_jsonlines(os.path.join(out_root, "info.jsonl"), all_lines)
    tr, va, te = mf.split_train_val_test(all_lines, seed=seed)
    split_dir = os.path.join(out_root, "split1")
    os.makedirs(split_dir, exist_ok=True)
    mf.write_jsonlines(os.path.join(split_dir, "train.jsonl"), tr)
    mf.write_jsonlines(os.path.join(split_dir, "val.jsonl"), va)
    mf.write_jsonlines(os.path.join(split_dir, "test.jsonl"), te)
    print(f"[prepare] {len(all_lines)} clips -> split1 "
          f"{len(tr)}/{len(va)}/{len(te)} under {out_root}")


def _gwilliams_one(tsv_path: str, data_root: str, out_root: str):
    from neuspeech1_tpu_torch.data import preprocess as pp

    rel = os.path.relpath(os.path.dirname(tsv_path), data_root)
    out_dir = os.path.join(out_root, rel)
    meg_path = tsv_path[: -len("events.tsv")] + "meg.con"
    loader = partial(pp.load_raw_kit, meg_path)
    try:
        return pp.process_gwilliams_events(
            tsv_path, out_dir, loader, audio_root=data_root
        )
    except Exception as e:  # per-file failure tolerance (reference swallows)
        print(f"[prepare] FAILED {tsv_path}: {e}")
        return []


def _schoffelen_one(tsv_path: str, data_root: str, out_root: str,
                    stimuli_path: str, audio_dir: str):
    from neuspeech1_tpu_torch.data import preprocess as pp

    rel = os.path.relpath(os.path.dirname(tsv_path), data_root)
    out_dir = os.path.join(out_root, rel)
    meg_path = tsv_path.replace("events.tsv", "meg.ds")
    loader = partial(pp.load_raw_ctf, meg_path)
    stimuli = pp.read_stimuli_dict(stimuli_path)
    try:
        return pp.process_schoffelen_events(
            tsv_path, out_dir, loader, stimuli, audio_dir
        )
    except Exception as e:
        print(f"[prepare] FAILED {tsv_path}: {e}")
        return []


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="dataset", required=True)
    for name in ("gwilliams", "schoffelen"):
        sp = sub.add_parser(name)
        sp.add_argument("--data_root", required=True)
        sp.add_argument("--out_root", required=True)
        sp.add_argument("--num_workers", type=int, default=8)
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--limit", type=int, default=None,
                        help="process only the first N recordings")
        if name == "schoffelen":
            sp.add_argument("--stimuli", default=None,
                            help="stimuli.txt path (default <root>/stimuli/stimuli.txt)")
            sp.add_argument("--audio_dir", default=None,
                            help="stimulus audio dir (default <root>/stimuli/audio_files)")
    args = p.parse_args(argv)

    tsvs = _find_files(args.data_root, "events.tsv")
    if args.limit:
        tsvs = tsvs[: args.limit]
    print(f"[prepare] {len(tsvs)} events.tsv files")

    if args.dataset == "gwilliams":
        work = partial(_gwilliams_one, data_root=args.data_root,
                       out_root=args.out_root)
    else:
        stim = args.stimuli or os.path.join(args.data_root, "stimuli",
                                            "stimuli.txt")
        adir = args.audio_dir or os.path.join(args.data_root, "stimuli",
                                              "audio_files")
        work = partial(_schoffelen_one, data_root=args.data_root,
                       out_root=args.out_root, stimuli_path=stim,
                       audio_dir=adir)

    if args.num_workers > 1:
        import multiprocessing

        # spawned workers: the port imports torch, whose threads make a
        # forked child unsafe
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.num_workers) as pool:
            results = pool.map(work, tsvs)
    else:
        results = [work(t) for t in tsvs]

    all_lines = [l for lines in results for l in lines]
    os.makedirs(args.out_root, exist_ok=True)
    _finish(all_lines, args.out_root, args.seed)


if __name__ == "__main__":
    main()
