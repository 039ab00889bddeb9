"""``torch._int_mm`` by operand layout on the card, at the int8 training
step's shapes (``ops/int8_matmul.py``).

    python -m neuspeech1_tpu_torch.perf.int_mm_layouts

For each [m, k] @ [k, n] shape and each layout of the two int8 operands
(row- or column-major), one JSON line: whether the int32 result equals a
float64 product of the same operands, its ms (CUDA events, 10 calls after
one) beside a bf16 product's, or the error the call raised. Then the
quantization pass of ``ops/int8_matmul.py::_quant`` at the encoder's fc1
input, and the card's name and power limit.
"""

from __future__ import annotations

import itertools
import json
import subprocess

import torch

from neuspeech1_tpu_torch.ops.int8_matmul import _quant
from neuspeech1_tpu_torch.perf.common import cuda_ms

# the encoder's projections and fc1/fc2 at whisper-base batch 64 (96,000
# tokens), 'full''s weight gradients contracting over the tokens, the
# decoder's tokens at 64 labels, and two small shapes at the card's limits
SHAPES = ((96000, 512, 2048), (96000, 2048, 512), (512, 96000, 2048),
          (2048, 96000, 512), (4096, 512, 512), (24, 16, 8), (17, 24, 40))


def main() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def layouts(m, k):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        return {"row": a, "col": a.t().contiguous().t()}

    for m, k, n in SHAPES:
        lhs, rhs = layouts(m, k), layouts(k, n)
        for la, lb in itertools.product(lhs, rhs):
            a, b = lhs[la], rhs[lb]
            rec = {"m": m, "k": k, "n": n, "a": la, "b": lb}
            try:
                y = torch._int_mm(a, b)
                rec["exact"] = torch.equal(y.double(),
                                           a.double() @ b.double())
                rec["ms"] = cuda_ms(lambda: torch._int_mm(a, b), iters=10,
                                    warmup=1)
                if m * k * n > 1e9:
                    rec["bf16_ms"] = cuda_ms(
                        lambda: a.bfloat16() @ b.bfloat16(), iters=10,
                        warmup=1)
            except RuntimeError as exc:
                rec["error"] = str(exc).splitlines()[0][:200]
            print(json.dumps(rec), flush=True)
    x = torch.randn(96000, 512, generator=gen, device="cuda").bfloat16()
    print(json.dumps({"quant_rows_ms": cuda_ms(lambda: _quant(x, 1)),
                      "quant_cols_ms": cuda_ms(lambda: _quant(x, 0))}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
