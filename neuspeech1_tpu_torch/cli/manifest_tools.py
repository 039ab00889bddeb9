"""Manifest utilities CLI: combine, filter, add-language, split.
The port's copy of ``neuspeech1_tpu/cli/manifest_tools.py``.

Counterparts of `process_dataset/combine_jsonls.py`,
`process_dataset/filter_schoffelen_jsonl.py`, and the `add_language.py`
referenced-but-missing in the reference's `combine_jsonls.sh`.

  python -m neuspeech1_tpu_torch.cli.manifest_tools combine a.jsonl b.jsonl -o out.jsonl
  python -m neuspeech1_tpu_torch.cli.manifest_tools filter-zinnen in.jsonl -o out.jsonl
  python -m neuspeech1_tpu_torch.cli.manifest_tools add-language in.jsonl --language Dutch -o out.jsonl
  python -m neuspeech1_tpu_torch.cli.manifest_tools split all.jsonl -o outdir/
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from neuspeech1_tpu_torch.data import manifest as mf

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("combine", help="concatenate + shuffle manifests")
    c.add_argument("inputs", nargs="+")
    c.add_argument("-o", "--output", required=True)
    c.add_argument("--no-shuffle", action="store_true")
    c.add_argument("--seed", type=int, default=0)

    f = sub.add_parser("filter-zinnen", help="keep ZINNEN rows under 30 s")
    f.add_argument("input")
    f.add_argument("-o", "--output", required=True)

    a = sub.add_parser("add-language", help="stamp a language on every row")
    a.add_argument("input")
    a.add_argument("--language", required=True)
    a.add_argument("-o", "--output", required=True)

    s = sub.add_parser("split", help="random 8:1:1 train/val/test split")
    s.add_argument("input")
    s.add_argument("-o", "--outdir", required=True)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--ratios", default="0.8,0.1,0.1")

    args = p.parse_args(argv)
    if args.cmd == "combine":
        n = mf.combine_manifests(args.inputs, args.output,
                                 shuffle=not args.no_shuffle, seed=args.seed)
        print(f"combined {len(args.inputs)} manifests -> {args.output} ({n} rows)")
    elif args.cmd == "filter-zinnen":
        rows = mf.filter_schoffelen_sentences(mf.read_jsonlines(args.input))
        mf.write_jsonlines(args.output, rows)
        print(f"kept {len(rows)} ZINNEN rows -> {args.output}")
    elif args.cmd == "add-language":
        rows = mf.add_language(mf.read_jsonlines(args.input), args.language)
        mf.write_jsonlines(args.output, rows)
        print(f"stamped language={args.language} on {len(rows)} rows")
    elif args.cmd == "split":
        ratios = tuple(float(x) for x in args.ratios.split(","))
        rows = mf.read_jsonlines(args.input)
        tr, va, te = mf.split_train_val_test(rows, ratios=ratios, seed=args.seed)
        os.makedirs(args.outdir, exist_ok=True)
        for name, part in (("train", tr), ("val", va), ("test", te)):
            mf.write_jsonlines(os.path.join(args.outdir, f"{name}.jsonl"), part)
        print(f"split {len(rows)} rows -> {len(tr)}/{len(va)}/{len(te)}")


if __name__ == "__main__":
    main()
