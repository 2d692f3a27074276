"""Carry factors between the JAX package and this port.

Both directions go through NumPy: a JAX ``Result`` or checkpoint holds
NumPy arrays, and this module turns them into tensors that the port's
solvers take as inits (``W_init``, ``H_init``, ``G_init``, ``S_init``,
``Z_init``) and ``resume_state``.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import complex_dtype_of, resolve_device, torch_dtype


def factors_from_numpy(obj, *, device=None, dtype=None, fields=("W", "H")):
    """Tensors of the factors ``fields`` (default W and H), in that order,
    from a JAX ``Result`` or a mapping that holds them.

    Each factor is a NumPy array or a per-source list of them, as the JAX
    package returns; lists stay lists.  Tensors land on ``device``
    (default: the CUDA card; with no card this raises, so pass
    ``device="cpu"``) in ``dtype`` (default: the arrays' own dtype), ready
    to pass as a solver's inits: ``W_init=``/``H_init=``, chnmf's and
    convexnmf's ``G_init=``/``S_init=``, constrainednmf's ``Z_init=``,
    symnmf's (n, k) ``H_init=``, ``nmf_streaming``'s ``W_init=``, and the
    convolutive family's 3-D factors: cnmf's and nmf2d's W (m, k, T)
    (also the dictionary of ``cnmf_encode`` / ``nmf2d_encode``), nmf2d's
    H (k, n, P) and chcnmf's G (p, k, T), and cmfwisa's complex P
    (``fields=("W", "H", "P")``; a real ``dtype`` gives P its complex
    partner: float64 -> complex128) as ``P_init=``.
    """
    get = obj.get if isinstance(obj, dict) else (lambda f: getattr(obj, f, None))
    found = [get(f) for f in fields]
    missing = [f for f, x in zip(fields, found) if x is None]
    if missing:
        raise ValueError(f"need the factors {list(fields)}; missing {missing}")
    device = resolve_device(None, device)
    dt = None if dtype is None else torch_dtype(dtype)

    def convert(x):
        if isinstance(x, (list, tuple)):
            return [convert(a) for a in x]
        t = torch.tensor(np.asarray(x), device=device)  # a copy: JAX arrays are read-only
        if dt is None:
            return t
        # a complex factor (cmfwisa's P) keeps its imaginary part
        return t.to(complex_dtype_of(dt) if t.is_complex() else dt)
    return tuple(convert(x) for x in found)


def resume_state_from_numpy(rs, *, device=None, dtype=None) -> dict:
    """The port's ``resume_state`` from a JAX ``Result.resume_state``.

    Two kinds of state exist.  JAX's extrapolated ``nmf_hals`` returns
    its momentum as NumPy arrays ``Wy``, ``Hy`` and floats ``beta``,
    ``beta_bar``, ``prev_err``: the arrays become tensors on ``device``
    (default: the card, as in :func:`factors_from_numpy`) in ``dtype``
    (default: their own dtype) and the scalars stay floats, ready for
    ``nmf_hals(..., extrapolate=True, resume_state=...)``.  ``nmfsc`` and
    ``cnmfsc`` return their line-search stepsizes ``step_w`` and
    ``step_h``: floats, except cnmfsc's per-frame (T,) ``step_w``, which
    stays a NumPy array (the port keeps stepsizes on the host).  Pass
    either with the Result's W and H as ``W_init``/``H_init``.
    """
    if {"step_w", "step_h"} <= set(rs):
        step_w = np.asarray(rs["step_w"])
        return {"step_w": float(step_w) if step_w.ndim == 0 else step_w.copy(),
                "step_h": float(rs["step_h"])}
    missing = {"Wy", "Hy", "beta", "beta_bar", "prev_err"} - set(rs)
    if missing:
        raise ValueError(f"resume_state lacks {sorted(missing)} (nor is it "
                         "nmfsc's or cnmfsc's {'step_w', 'step_h'})")
    Wy, Hy = factors_from_numpy({"W": rs["Wy"], "H": rs["Hy"]},
                                device=device, dtype=dtype)
    return {"Wy": Wy, "Hy": Hy,
            **{key: float(rs[key]) for key in ("beta", "beta_bar", "prev_err")}}


def load_factors_npz(path) -> dict:
    """Read a checkpoint written by ``nmf_toolbox_tpu.utils.save_factors``.

    The format: one array per factor, or ``name__len`` plus ``name__0``,
    ``name__1``, ... for a per-source list; ``__fields__`` names the
    Result's fields in order and ``__n_iters__`` its iteration count;
    ``extra__*`` entries are the caller's own.  Returns a dict from each
    field (every non-metadata name when ``__fields__`` is absent) to its
    NumPy array or list of arrays, plus ``n_iters`` when stored.  Read
    with NumPy alone, without unpickling.
    """
    with np.load(path, allow_pickle=False) as z:
        files = set(z.files)
        lists = {f[: -len("__len")] for f in files if f.endswith("__len")}
        if "__fields__" in files:
            names = [str(s) for s in z["__fields__"]]
        else:
            names = sorted(lists | {f for f in files if "__" not in f})
        out = {}
        for name in names:
            if name in lists:
                out[name] = [z[f"{name}__{s}"]
                             for s in range(int(z[f"{name}__len"]))]
            elif name in files:
                out[name] = z[name]
        if "__n_iters__" in files:
            out["n_iters"] = int(z["__n_iters__"])
    return out
