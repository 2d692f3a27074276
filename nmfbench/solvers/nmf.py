"""The solver ``nmf``: the port's multiplicative updates, as a cell calls them.

A solver module is what the harness knows of one entry point of the
port.  ``cells.solver`` finds it by the configuration's ``"solver"``
(``nmf`` for a configuration with none) and the harness calls:

* ``make_init(cfg, seed, j, device)``: the inits of solve ``j``, from
  their own stream of the seed;
* ``solve(cfg, traffic, V, init, tolerance, maxiter, M, mesh, **options)``:
  one call of the entry point, the traffic file's ``"options"`` passed
  on unchanged; returns the port's ``Result``;
* ``reference_solve(ref, cfg, traffic, V, init, tolerance, M, snapshots,
  tf32)``: the same solve by the plain reference ``ref`` (the module
  the configuration's ``"reference"`` names), as ``reference/mu.py:
  solve`` returns it;
* ``flops_per_iter(cfg, traffic)``, ``bytes_per_iter(cfg, traffic)``:
  the least work of one iteration (``work.py`` holds the card's peaks);
* ``planted_cost(cfg, V, parts, M)``: the planted model's cost, which
  the stop rule's tolerance is relative to;
* ``launches()``: the port's launch counters of hand-written kernels,
  {name in the trace: count}, which the harness sets beside a traced
  solve.

Least work of one MU iteration, counted from the shapes whatever
implements it, so that a change to the program cannot move the
yardstick:

* FLOPs count the products an iteration cannot do without (2 per
  multiply-add); elementwise work is not counted.
  - KL: the reconstruction W H before each of the two updates and the
    field's product in each, ``8 m n k``; the cost reuses the
    reconstruction that the next W update needs.  The program's fused
    kernels do ``10 m n k`` (their cost pass rebuilds W H); the extra is
    not counted.
  - KL with weights M: also ``M H'`` and ``W' M``, ``12 m n k``.
  - Euclidean (Gram form): ``V H'`` and ``W' V``, ``4 m n k``, and the
    k x k work ``H H'``, ``W (H H')``, ``W' W``, ``(W' W) H``,
    ``4 k^2 (m + n)``.
* Bytes: each of the two updates reads V (and M) once, W and H once, and
  writes the factor it updates once; f32 throughout.  V cannot be read
  fewer than twice: the H update needs all of the new W, which needs all
  of V.

On a mesh the work is the whole problem's, spread over the chips' peaks.
"""
from __future__ import annotations

import torch

from nmfbench import data

F32 = 4
ROW_BLOCK = 8192  # rows of V per block of the planted cost


def make_init(cfg, seed, j, device):
    """W0 (m x k), H0 (k x n) of solve ``j``: uniform on [0, 1) with a floor."""
    g = data.generator(device, seed, "init", j)
    W0 = torch.rand((cfg["m"], cfg["k"]), generator=g, device=device)
    H0 = torch.rand((cfg["k"], cfg["n"]), generator=g, device=device)
    return W0.clamp_min_(data.INIT_FLOOR), H0.clamp_min_(data.INIT_FLOOR)


def solve(cfg, traffic, V, init, tolerance, maxiter, M=None, mesh=None, **options):
    import nmf_toolbox_tpu_torch as nt
    W0, H0 = init
    kw = {"divergence": cfg["divergence"], "W_init": W0, "H_init": H0,
          "tolerance": tolerance, "maxiter": maxiter}
    if traffic.get("method"):
        kw["method"] = traffic["method"]
    if M is not None:
        kw["weights"] = M
    if mesh is not None:
        kw["mesh"] = mesh
    return nt.nmf(V, int(cfg["k"]), **kw, **options)


def reference_solve(ref, cfg, traffic, V, init, tolerance, M=None, snapshots=(), tf32=False):
    W0, H0 = init
    return ref.solve(V, W0, H0, cfg["divergence"], tolerance, int(traffic["cap"]), M=M,
                     snapshots=snapshots, tf32=tf32)


def launches():
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
    from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk
    return {"phase_kernel": fk.phi_dot_ht_launches + fk.wt_dot_phi_launches,
            "cost_kernel": fk.cost_terms_launches,
            "kl_field_kernel": nk.kl_field_launches,
            "kl_cost_kernel": nk.kl_cost_launches}


def flops_per_iter(cfg, traffic) -> float:
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    div = cfg["divergence"]
    if div == "kl":
        return float((12 if traffic.get("mask_zero_share") else 8) * m * n * k)
    if div == "euclidean":
        if traffic.get("mask_zero_share"):
            raise ValueError("no least-work count for a weighted Euclidean solve")
        return float(4 * m * n * k + 4 * k * k * (m + n))
    raise ValueError(f"no least-work count for divergence {div!r}")


def bytes_per_iter(cfg, traffic) -> float:
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    fields = 2 if traffic.get("mask_zero_share") else 1  # V, and M
    per_update = fields * m * n + m * k + k * n  # read once
    return float(F32 * (2 * per_update + m * k + k * n))  # + each factor written once


def planted_cost(cfg, V, parts, M=None):
    """The cost of the planted model, block by block, in f64."""
    A, B, const = parts
    divergence = cfg["divergence"]
    total = torch.zeros((), dtype=torch.float64, device=V.device)
    with torch.no_grad(), data.matmul_precision(False):
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
