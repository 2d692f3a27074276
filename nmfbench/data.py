"""The one generator of the benchmark's inputs, driven by a traffic file.

Everything a run feeds the program comes from ``--seed`` through here, on
the device, in a few large calls:

* V: a planted non-negative product plus non-negative noise,
  ``V = A B / r + noise * U + floor``, where the entries of A (m x r)
  and B (r x n) are ``u ** power`` and those of U (m x n) are u, for u
  uniform on [0, 1), so every entry is at least ``floor`` > 0 (KL needs
  V > 0) and a power above 1 makes the planted factors skewed, as
  spectra and counts are;
* M: per-entry weights in {0, 1}, each 0 with probability
  ``mask_zero_share`` (the traffic's missing entries), or none;
* the solves' inits: W0 (m x k) and H0 (k x n) uniform on [0, 1) with a
  floor, one pair per solve, each from its own stream of the seed, so
  solve j of a seed gets the same inits in every run;
* the stop rule's tolerance: ``rel_tol`` times the cost of the planted
  model ``A B / r + mean(noise * U) + floor``, so that ``rel_tol`` reads
  as a decrease relative to the cost a good fit reaches.

The parameters are the traffic file's ``assumed.generator``.
"""
from __future__ import annotations

import hashlib

import torch

from .reference.mu import ROW_BLOCK, matmul_precision

INIT_FLOOR = 1e-30  # no init entry is exactly 0 (an MU zero stays zero)


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


def make_init(cfg, seed, j, device):
    """W0 (m x k), H0 (k x n) of solve ``j``: uniform on [0, 1) with a floor."""
    g = generator(device, seed, "init", j)
    W0 = torch.rand((cfg["m"], cfg["k"]), generator=g, device=device)
    H0 = torch.rand((cfg["k"], cfg["n"]), generator=g, device=device)
    return W0.clamp_min_(INIT_FLOOR), H0.clamp_min_(INIT_FLOOR)


def planted_cost(V, parts, divergence, M=None):
    """The cost of the planted model, block by block, in f64."""
    A, B, const = parts
    total = torch.zeros((), dtype=torch.float64, device=V.device)
    with torch.no_grad(), matmul_precision(False):
        for r0 in range(0, V.shape[0], ROW_BLOCK):
            Vb = V[r0:r0 + ROW_BLOCK].double()
            S = (A[r0:r0 + ROW_BLOCK] @ B).double() + const
            if divergence == "euclidean":
                term = 0.5 * (Vb - S) ** 2
            elif divergence == "kl":
                term = Vb * torch.log(Vb / S) - Vb + S
            else:
                raise ValueError(f"no planted cost for {divergence!r}")
            if M is not None:
                term = term * M[r0:r0 + ROW_BLOCK].double()
            total += torch.sum(term)
    return float(total)


def tolerance(cfg, traffic, V, parts, M=None) -> float:
    """The stop rule's absolute tolerance: ``rel_tol`` times the planted
    model's cost."""
    return float(traffic["rel_tol"]) * planted_cost(V, parts, cfg["divergence"], M)
