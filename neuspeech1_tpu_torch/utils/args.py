"""argparse helpers: the port's copy of ``neuspeech1_tpu/utils/args.py``
(reference `utils/utils.py:74-105` parity), so that both packages' CLIs
take the same argv.

`--flag=False` string coercion and `--x=None` -> None are part of the
reference CLI contract (`strtobool` / `str_none`)."""

from __future__ import annotations

import argparse
from typing import Any


def strtobool(val: str) -> bool:
    val = val.lower()
    if val in ("y", "yes", "t", "true", "on", "1"):
        return True
    if val in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {val!r}")


def str_none(val: str):
    return None if val == "None" else val


def add_arguments(argname: str, type: Any, default: Any, help: str,
                  argparser: argparse.ArgumentParser, **kwargs) -> None:
    type = strtobool if type == bool else type
    type = str_none if type == str else type
    argparser.add_argument(
        "--" + argname, default=default, type=type,
        help=help + f" Default: %(default)s.", **kwargs,
    )


def print_arguments(args) -> None:
    print("-----------  Configuration Arguments -----------")
    for arg, value in sorted(vars(args).items()):
        print(f"{arg}: {value}")
    print("------------------------------------------------")
