#!/usr/bin/env python3
"""How the card's cuBLAS rounds f32 operands in TF32 mode, measured.

    python benchmarks_torch/tf32_rounding.py

With ``torch.backends.cuda.matmul.fp32_precision = "tf32"``:

* operand rounding: ``A @ I`` and ``I @ A.T`` for A (64x1024, standard
  normal, 1024 exact ties planted in its first 16 columns) give A's
  rounded entries back exactly; the count of entries that differ from
  A rounded to nearest-even, nearest-away, toward zero and not at all;
* accumulation: ``ones @ B`` for B (1024x64) already in TF32, against
  the exact column sums and the sequential f32 ones;
* general operands (standard normal and uniform(0, 1)) at 256x1024x256,
  1024^3 and 256x64x256: the card's product against the products of
  the rounded operands in f64 (max |d| / max |entry|).

Prints one JSON line per part with the card's name and power limit.
This is the evidence behind ``utils/debug.CARD_TF32_ROUNDING``;
``chip_smoke.py`` phase 5b holds the emulation to the card on every run.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import tf32  # noqa: E402

ROUNDINGS = {"nearest-even": tf32.tf32_rne, "nearest-away": tf32.tf32_rna,
             "toward zero": tf32.tf32_rz, "none": lambda x: x}
SHAPES = ((256, 1024, 256), (1024, 1024, 1024), (256, 64, 256))


def on_card(a, b):
    return (a.cuda() @ b.cuda()).cpu()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tf32_rounding.py needs a CUDA card")
    card = cs.card()
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32))
    bits = A[:, :16].contiguous().view(torch.int32)
    A[:, :16] = ((bits & ~0x1FFF) | 0x1000).view(torch.float32)  # exact ties
    eye = torch.eye(1024)
    for side, got in (("left", on_card(A, eye)), ("right", on_card(eye, A.T.contiguous()).T)):
        print(json.dumps({"card": card, "part": f"operand rounding, A on the {side}",
                          "entries": A.numel(), "planted ties": 16 * 64,
                          "mismatches": {k: int((got != f(A)).sum()) for k, f in ROUNDINGS.items()},
                          "mismatches at ties": {k: int((got[:, :16] != f(A)[:, :16]).sum())
                                                 for k, f in ROUNDINGS.items()}}), flush=True)
    B = tf32.tf32_rne(torch.from_numpy(rng.standard_normal((1024, 64)).astype(np.float32)))
    got = on_card(torch.ones(64, 1024), B)[0].double()
    print(json.dumps({"card": card, "part": "accumulation, ones @ B, B in TF32",
                      "max |column sum|": float(B.double().sum(0).abs().max()),
                      "max |d| from the exact sums": float((got - B.double().sum(0)).abs().max()),
                      "max |d| from sequential f32 sums":
                      float((got - B.cumsum(0)[-1].double()).abs().max())}), flush=True)
    for m, k, n in SHAPES:
        for dist in ("normal", "uniform"):
            draw = rng.standard_normal if dist == "normal" else rng.uniform
            a = torch.from_numpy(draw(size=(m, k)).astype(np.float32))
            b = torch.from_numpy(draw(size=(k, n)).astype(np.float32))
            got = on_card(a, b).double()
            scale = float(got.abs().max())
            print(json.dumps({"card": card, "part": f"general operands {m}x{k}x{n} {dist}",
                              "max |d| / max |entry| from the f64 product of operands "
                              "rounded": {name: float((got - f(a).double() @ f(b).double())
                                                      .abs().max() / scale)
                                          for name, f in ROUNDINGS.items()}}), flush=True)


if __name__ == "__main__":
    main()
