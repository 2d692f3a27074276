"""The tensor cores' f32 arithmetic, modelled in plain PyTorch on the CPU.

TF32 keeps f32's sign and 8-bit exponent and 10 of its 23 mantissa bits.
The fused kernels (``csrc/fused.cu``, ``csrc/fused_dma.cu``) feed the
tensor cores in 3xTF32: each f32 operand x is split into hi = tf32(x) and
lo = tf32(x - hi), rounded to nearest with ties away from zero as
``cvt.rna.tf32.f32`` rounds (:func:`tf32_rna`), and a product is
lo*hi + hi*lo + hi*hi with f32 accumulation (:func:`mm3`).  cuBLAS GEMMs
under ``torch.backends.cuda.matmul.fp32_precision = "tf32"`` run one TF32
product of the operands (:func:`mm1`), which the H100's cuBLAS rounds to
nearest with ties to even (:func:`tf32_rne`; ``chip_smoke.py``'s
numerics phase holds it to the card).

``tests/test_torch_tf32.py`` holds this model against f64, and
``utils.debug.emulate_card_matmul_numerics`` applies it to the port's own
CPU matmuls.  The kernels' plain versions mark their products with
:func:`kernel_products`, which changes nothing outside the emulation.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

TF32_MASK = -0x2000  # 0xFFFFE000 as an int32: sign, exponent, 10 mantissa bits

_KERNEL_PRODUCTS = contextvars.ContextVar("nmf_kernel_products", default=False)


def tf32_rna(x):
    """Round f32 to TF32 on the float's bits: add half of the dropped 13
    bits' range, then drop them (nearest, ties away from zero)."""
    return ((x.view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)


def tf32_rne(x):
    """Round f32 to TF32 on the float's bits, nearest with ties to even:
    add just under half of the dropped range, plus the kept last bit."""
    bits = x.view(torch.int32)
    return ((bits + 0x0FFF + ((bits >> 13) & 1)) & TF32_MASK).view(torch.float32)


def tf32_rz(x):
    """Truncate f32 to TF32 (toward zero): drop the 13 low mantissa bits."""
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def split(x):
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi), both nearest."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a, b, product=torch.matmul):
    """``product(a, b)`` in 3xTF32: the two small products first, then
    hi*hi; ``product`` is any function linear in each operand."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (product(al, bh) + product(ah, bl)) + product(ah, bh)


def mm1(a, b, rounding=tf32_rna):
    """a @ b in plain TF32 (one product of the rounded operands)."""
    return rounding(a) @ rounding(b)


@contextlib.contextmanager
def kernel_products():
    """Marks a kernel's plain version: inside the card-numerics emulation
    its f32 products run in 3xTF32, as the kernel's do; elsewhere nothing
    changes."""
    token = _KERNEL_PRODUCTS.set(True)
    try:
        yield
    finally:
        _KERNEL_PRODUCTS.reset(token)


def in_kernel_products() -> bool:
    """True inside :func:`kernel_products`."""
    return _KERNEL_PRODUCTS.get()
