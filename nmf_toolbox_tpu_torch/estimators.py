"""Scikit-learn-style estimator facade (PyTorch counterpart of
``nmf_toolbox_tpu/estimators.py``).

The functional solvers follow the reference's MATLAB conventions
(V is features x samples).  This module wraps them in the fit/transform
idiom most Python users expect — X is (n_samples, n_features), like
sklearn.decomposition.NMF — so migrating pipelines need no re-orientation.
The solvers run on the CUDA card unless ``device=`` says otherwise, and
everything the estimator returns or stores is NumPy, as in sklearn.
"""
from __future__ import annotations

from . import models
from .core import to_host


class NMF:
    """NMF estimator over the framework's solvers.

    Parameters
    ----------
    n_components : rank k, or "auto" (default) to pick it at fit time
        from the randomized-SVD energy curve (config: rank_energy=0.9,
        rank_max=64); the chosen rank lands in ``n_components_``.
    solver : 'mu' (reference-parity multiplicative updates), 'hals'
        (fast time-to-tolerance), or any solver name from the package
        ('nmfsc', 'cnmf', ... — extra positional config like context_len
        goes in solver_args).
    divergence, max_iter, tol, random_state : usual meanings.
    solver_args : tuple of extra positional args (e.g. (context_len,)).
    **config : forwarded to the solver (W_sparsity, mesh, dtype, method,
        device, ...).  ``device`` ("cpu", "cuda", ...; default the card,
        or this rank's device of a ``mesh``) also places the auto-rank
        estimate.  With ``mesh`` every rank fits the same X and holds the
        same fitted estimator.
        ``weights`` is taken in the SAME orientation as X —
        (n_samples, n_features) — and transposed alongside it.

    Attributes: components_ (n_components, n_features), n_iter_,
    reconstruction_err_ (final cost), cost_trace_.
    """

    def __init__(self, n_components: int | str = "auto", *, solver: str = "mu",
                 divergence: str | None = None, max_iter: int = 200,
                 tol: float = 1e-4, random_state: int = 0,
                 solver_args: tuple = (), **config):
        # "auto": pick the rank at fit time from the randomized-SVD
        # energy curve (rank.estimate_rank_svd; config keys rank_energy /
        # rank_max control the target fraction and search cap).  The
        # chosen value lands in n_components_ (sklearn convention).
        self.n_components = (n_components if n_components == "auto"
                             else int(n_components))
        self.solver = solver
        self.divergence = divergence
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.random_state = int(random_state)
        self.solver_args = tuple(solver_args)
        self.config = dict(config)

    def _fn(self):
        name = {"mu": "nmf", "hals": "nmf_hals"}.get(self.solver, self.solver)
        return getattr(models, name)

    def _device(self):
        mesh = self.config.get("mesh")
        return self.config.get("device") or getattr(mesh, "device", None)

    def _cfg(self):
        cfg = dict(self.config)
        cfg.pop("rank_energy", None)   # consumed by the auto-rank path,
        cfg.pop("rank_max", None)      # not solver config
        cfg.update(maxiter=self.max_iter, tolerance=self.tol,
                   seed=self.random_state)
        if self.divergence is not None:
            cfg["divergence"] = self.divergence
        return cfg

    def fit(self, X, y=None):
        self.fit_transform(X)
        return self

    def fit_transform(self, X, y=None):
        V = to_host(X).T  # sklearn rows-are-samples -> reference layout
        if self.n_components == "auto":
            from .rank import estimate_rank_svd
            k, _ = estimate_rank_svd(
                V, energy=float(self.config.get("rank_energy", 0.9)),
                max_rank=int(self.config.get("rank_max", 64)),
                seed=self.random_state, device=self._device())
            self.n_components_ = int(k)
        else:
            self.n_components_ = int(self.n_components)
        cfg = self._cfg()
        if cfg.get("weights") is not None:
            # ADVICE r2: the facade converts X to solver layout; weights
            # given in the same sklearn orientation (n_samples, n_features)
            # must ride along, or a square X would silently misapply them.
            cfg["weights"] = to_host(cfg["weights"]).T
        res = self._fn()(V, self.n_components_, *self.solver_args, **cfg)
        W = to_host(res.W)
        if W.ndim != 2:
            raise ValueError(
                f"solver '{self.solver}' learns a {W.ndim}-D basis; the "
                "sklearn facade supports 2-D-basis solvers only — use the "
                "functional API (nmf_toolbox_tpu_torch.cnmf, ...) for convolutive "
                "models")
        self.components_ = W.T
        self.n_iter_ = res.n_iters
        self.cost_trace_ = to_host(res.cost)
        # final_cost handles per-solver trace semantics (offset traces,
        # lnmf zero-padding) and correctly reports an exact-fit 0.0.
        self.reconstruction_err_ = float(res.final_cost)
        self._result = res
        return to_host(res.H).T

    def transform(self, X):
        """Encode new samples against the learned basis (W held fixed).

        Uses the MU solver's W_fixed path (hals has no fixed-factor mode;
        its basis is still a valid euclidean basis for MU encoding)."""
        if not hasattr(self, "components_"):
            raise RuntimeError("fit before transform")
        if self.solver not in ("mu", "hals", "nmf", "nmfsc", "lnmf"):
            # Solvers without a W_init/W_fixed surface (convexnmf, chnmf,
            # ...) would silently REFIT from scratch — refuse instead.
            raise NotImplementedError(
                f"transform is not supported for solver '{self.solver}' "
                "(no fixed-basis encoding path); use the functional API")
        V = to_host(X).T
        cfg = self._cfg()
        # encoding passes the learned basis explicitly; fit-time-only
        # options (init seeding, per-entry weights shaped like fit-X)
        # must not be forwarded
        cfg.pop("init", None)
        cfg.pop("weights", None)
        cfg.update(W_init=self.components_.T, W_fixed=True)
        fn = models.nmf if self.solver in ("mu", "hals") else self._fn()
        res = fn(V, self.components_.shape[0], *self.solver_args, **cfg)
        return to_host(res.H).T

    def inverse_transform(self, Ht):
        return to_host(Ht) @ self.components_

    # sklearn plumbing (enables clone()/Pipeline/GridSearchCV)
    def get_params(self, deep=True):
        return {"n_components": self.n_components, "solver": self.solver,
                "divergence": self.divergence, "max_iter": self.max_iter,
                "tol": self.tol, "random_state": self.random_state,
                "solver_args": self.solver_args, **self.config}

    def set_params(self, **params):
        for key in ("n_components", "solver", "divergence", "max_iter",
                    "tol", "random_state", "solver_args"):
            if key in params:
                setattr(self, key, params.pop(key))
        self.config.update(params)
        return self
