"""Carry factors between the JAX package and this port.

Both directions go through NumPy: a JAX ``Result`` or checkpoint holds
NumPy arrays, and this module turns them into tensors that ``nmf`` and
``nmf_hals`` take as ``W_init``/``H_init`` and ``resume_state``.  Nothing
here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import resolve_device, torch_dtype


def factors_from_numpy(obj, *, device=None, dtype=None):
    """(W, H) tensors from a JAX ``Result`` or a mapping with "W" and "H".

    Each factor is a NumPy array or a per-source list of them, as the JAX
    package returns; lists stay lists.  Tensors land on ``device``
    (default: the CUDA card; with no card this raises, so pass
    ``device="cpu"``) in ``dtype`` (default: the arrays' own dtype), ready
    to pass as ``W_init=``/``H_init=``.
    """
    get = obj.get if isinstance(obj, dict) else (lambda f: getattr(obj, f, None))
    W, H = get("W"), get("H")
    if W is None or H is None:
        raise ValueError("need both W and H factors")
    device = resolve_device(None, device)
    dt = None if dtype is None else torch_dtype(dtype)

    def convert(x):
        if isinstance(x, (list, tuple)):
            return [convert(a) for a in x]
        t = torch.tensor(np.asarray(x), device=device)  # a copy: JAX arrays are read-only
        return t if dt is None else t.to(dt)
    return convert(W), convert(H)


def resume_state_from_numpy(rs, *, device=None, dtype=None) -> dict:
    """The port's ``resume_state`` from a JAX ``Result.resume_state``.

    JAX's extrapolated ``nmf_hals`` returns the momentum state as NumPy
    arrays ``Wy``, ``Hy`` and floats ``beta``, ``beta_bar``,
    ``prev_err``.  The arrays become tensors on ``device`` (default: the
    card, as in :func:`factors_from_numpy`) in ``dtype`` (default: their
    own dtype) and the scalars stay floats, ready to pass
    as ``nmf_hals(..., extrapolate=True, resume_state=...)`` together
    with the Result's W and H as ``W_init``/``H_init``.
    """
    missing = {"Wy", "Hy", "beta", "beta_bar", "prev_err"} - set(rs)
    if missing:
        raise ValueError(f"resume_state lacks {sorted(missing)}")
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
