"""The one generator of the benchmark's inputs, driven by a traffic file.

Everything a run feeds the program comes from ``--seed`` through here, on
the device, in a few large calls:

* V: a planted non-negative product plus non-negative noise,
  ``V = A B / r + noise * U + floor``, where the entries of A (m x r)
  and B (r x n) are ``u ** power`` and those of U (m x n) are u, for u
  uniform on [0, 1), so every entry is at least ``floor`` > 0 (a
  divergence with a logarithm needs V > 0) and a power above 1 makes the
  planted factors skewed, as spectra and counts are;
* M: per-entry weights in {0, 1}, each 0 with probability
  ``mask_zero_share`` (the traffic's missing entries), or none;
* the solves' inits: the solver's ``make_init``, one set per solve,
  each from its own stream of the seed (:func:`generator`), so solve j of
  a seed gets the same inits in every run;
* the stop rule's tolerance: ``rel_tol`` times the solver's cost of the
  planted model ``A B / r + mean(noise * U) + floor``, so that
  ``rel_tol`` reads as a decrease relative to the cost a good fit
  reaches.

The parameters are the traffic file's ``assumed.generator``.  A function
that takes ``solver=None`` uses the solver module of ``cfg``
(``cells.solver``).
"""
from __future__ import annotations

import contextlib
import hashlib

import torch

from . import cells

INIT_FLOOR = 1e-30  # no init entry is exactly 0 (a multiplicative zero stays zero)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products of f32 operands in TF32 (``tf32=True``) or in full f32,
    whatever the caller had set; the caller's setting comes back on exit.
    (The plain references carry their own copy: they import nothing of
    the benchmark.)"""
    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        saved = mm.fp32_precision
        mm.fp32_precision = "tf32" if tf32 else "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = saved
    else:
        saved = mm.allow_tf32
        mm.allow_tf32 = tf32
        try:
            yield
        finally:
            mm.allow_tf32 = saved


def substream(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    text = ":".join(str(t) for t in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(substream(seed, *tags))


def planted(cfg, traffic, seed, device):
    """(A, B / r) of the planted product, their entries U ** power, and the
    generator that goes on to the noise."""
    p = traffic["assumed"]["generator"]
    m, n, r = cfg["m"], cfg["n"], int(p["planted_rank"])
    power = float(p["power"])
    g = generator(device, seed, "planted")
    A = torch.rand((m, r), generator=g, device=device).pow_(power)
    B = torch.rand((r, n), generator=g, device=device).pow_(power).div_(r)
    return A, B, g


def make_v(cfg, traffic, seed, device):
    """V (m x n, f32) and its planted cost's parts; products in full f32."""
    p = traffic["assumed"]["generator"]
    A, B, g = planted(cfg, traffic, seed, device)
    noise, floor = float(p["noise"]), float(p["floor"])
    with matmul_precision(False):
        V = torch.rand((cfg["m"], cfg["n"]), generator=g, device=device)
        V = torch.addmm(V, A, B, beta=noise)
    V.add_(floor)
    return V, (A, B, 0.5 * noise + floor)


def make_mask(cfg, traffic, seed, device):
    share = traffic.get("mask_zero_share")
    if not share:
        return None
    g = generator(device, seed, "mask")
    M = torch.rand((cfg["m"], cfg["n"]), generator=g, device=device)
    return (M >= float(share)).to(torch.float32)


def make_init(cfg, seed, j, device, solver=None):
    """The inits of solve ``j``."""
    return (solver or cells.solver(cfg)).make_init(cfg, seed, j, device)


def tolerance(cfg, traffic, V, parts, M=None, solver=None) -> float:
    """The stop rule's absolute tolerance: ``rel_tol`` times the planted
    model's cost."""
    solver = solver or cells.solver(cfg)
    return float(traffic["rel_tol"]) * solver.planted_cost(cfg, V, parts, M)
