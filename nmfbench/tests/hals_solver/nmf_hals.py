"""A second solver, for the tests only: the port's ``nmf_hals``.

Copied by the tests into a throwaway root as ``nmfbench/solvers/nmf_hals.py``
beside a configuration that names it, to show that a solver is new files
alone (the contract: ``nmfbench/solvers/nmf.py``).  One HALS iteration
sweeps W's columns against ``H H'`` and ``V H'`` and H's rows against
``W' W`` and ``W' V``; its least FLOPs are the two products over V,
``4 m n k``, and the k x k work, ``4 k^2 (m + n)``, once per sweep.
"""
from __future__ import annotations

import torch

from nmfbench import data

F32 = 4


def make_init(cfg, seed, j, device):
    g = data.generator(device, seed, "init", j)
    W0 = torch.rand((cfg["m"], cfg["k"]), generator=g, device=device)
    H0 = torch.rand((cfg["k"], cfg["n"]), generator=g, device=device)
    return W0.clamp_min_(data.INIT_FLOOR), H0.clamp_min_(data.INIT_FLOOR)


def solve(cfg, traffic, V, init, tolerance, maxiter, M=None, mesh=None, **options):
    import nmf_toolbox_tpu_torch as nt
    W0, H0 = init
    return nt.nmf_hals(V, int(cfg["k"]), W_init=W0, H_init=H0, tolerance=tolerance,
                       maxiter=maxiter, weights=M, mesh=mesh, **options)


def reference_solve(ref, cfg, traffic, V, init, tolerance, M=None, snapshots=(), tf32=False):
    if M is not None:
        raise ValueError("the HALS reference takes no weights")
    W0, H0 = init
    inner = int((traffic.get("options") or {}).get("inner_iters", 1))
    return ref.solve(V, W0, H0, tolerance, int(traffic["cap"]), inner=inner,
                     snapshots=snapshots, tf32=tf32)


def launches():
    return {}


def flops_per_iter(cfg, traffic) -> float:
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    sweeps = int((traffic.get("options") or {}).get("inner_iters", 1))
    return float(4 * m * n * k + 4 * k * k * (m + n) * sweeps)


def bytes_per_iter(cfg, traffic) -> float:
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    return float(F32 * (2 * (m * n + m * k + k * n) + m * k + k * n))


def planted_cost(cfg, V, parts, M=None):
    A, B, const = parts
    term = 0.5 * (V.double() - ((A @ B).double() + const)) ** 2
    if M is not None:
        term = term * M.double()
    return float(torch.sum(term))
