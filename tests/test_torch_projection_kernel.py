"""The projection's card path against the JAX package, on the CPU.

On a card ``ops/projection.project_rows`` is one launch of the Hoyer
projection kernel with a budget of N + 1 passes, ``valid`` and targets
per vector, and the kernel is held against its plain version,
``ops/kernels/hoyer.hoyer_project_reference``
(tests/test_torch_hoyer_emulated.py, and on the card
tests/test_torch_projection_card.py).  Here, in f64 on seeded NumPy
inputs, both that plain version at the kernel's budget and
``project_rows`` itself are held against the JAX package's
``project_columns`` (its on-device while_loop) within 1e-10 of the
largest entry, with JAX's pass counts: padded vectors (``valid``),
targets per vector, both together, and a batch of candidates as a line
search projects them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmf_toolbox_tpu.ops import projection as jproj  # noqa: E402
from nmf_toolbox_tpu_torch.ops import projection as tproj  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk  # noqa: E402

RTOL = 1e-10  # of the largest entry


def columns(seed, N, B, lo=-0.5):
    return np.random.default_rng(seed).uniform(lo, 1.0, (N, B))


def targets(seed, N, B):
    """Per-column (k1, k2): sparsities 0.3-0.9 scaled to L2 norms 0.5-2."""
    rng = np.random.default_rng(seed)
    k2 = rng.uniform(0.25, 4.0, B)
    k1 = np.array([tproj.hoyer_l1_target(N, s) for s in rng.uniform(0.3, 0.9, B)])
    return k1 * np.sqrt(k2), k2


def jax_columns(S, k1, k2, valid):
    vj, itj = jproj.project_columns(jnp.asarray(S), jnp.asarray(k1), jnp.asarray(k2),
                                    valid=valid)
    return np.asarray(vj), np.asarray(itj)


def held(v, iters, vj, itj):
    v = v.numpy()
    assert v.shape == vj.shape
    assert np.max(np.abs(v - vj)) <= RTOL * np.max(np.abs(vj))
    np.testing.assert_array_equal(iters.numpy(), itj)


CASES = [  # (N, B, valid, per-vector targets)
    (40, 7, 31, False), (40, 7, None, True), (64, 5, 50, True), (300, 4, 211, True),
    (17, 9, 17, True)]


@pytest.mark.parametrize("N,B,valid,per_vector", CASES)
def test_plain_version_at_the_kernels_budget_matches_jax(N, B, valid, per_vector):
    """hoyer_project_reference(S, k1, k2, N + 1, valid), what the kernel is
    held against, is JAX's while_loop: rows of S' are JAX's columns."""
    S = columns(N + B, N, B)
    k1, k2 = targets(N, N if valid is None else valid, B) if per_vector else (
        tproj.hoyer_l1_target(N if valid is None else valid, 0.6), 1.0)
    vj, itj = jax_columns(S, k1, k2, valid)
    as_t = (lambda k: torch.from_numpy(np.asarray(k)) if np.ndim(k) else k)
    v, done, iters = hk.hoyer_project_reference(torch.from_numpy(S.T.copy()), as_t(k1),
                                                as_t(k2), N + 1, valid)
    assert bool(done.all())
    held(v.T, iters, vj, itj)
    if valid is not None:
        assert not v[:, valid:].any()


@pytest.mark.parametrize("N,B,valid,per_vector", CASES)
def test_project_rows_valid_and_targets_match_jax(N, B, valid, per_vector):
    """project_rows on the CPU (the loop of passes), on a strided W.mT-like
    view, against JAX's project_columns of the same columns."""
    S = columns(2 * N + B, N, B)
    k1, k2 = targets(N + 1, N if valid is None else valid, B) if per_vector else (
        tproj.hoyer_l1_target(N if valid is None else valid, 0.5), 1.0)
    vj, itj = jax_columns(S, k1, k2, valid)
    as_t = (lambda k: torch.from_numpy(np.asarray(k)) if np.ndim(k) else k)
    W = torch.from_numpy(S)  # (N, B): its columns are the vectors
    v, iters = tproj.project_rows(W.mT, as_t(k1), as_t(k2), valid)
    held(v.mT, iters, vj, itj)


def test_project_rows_batched_candidates_match_jax():
    """A line search's batch (J, B, N) with targets per vector broadcast
    over the candidates, against JAX column by candidate."""
    N, B, J = 50, 6, 3
    S = np.stack([columns(70 + j, N, B) for j in range(J)])  # (J, N, B)
    k1, k2 = targets(9, N, B)
    v, iters = tproj.project_rows(torch.from_numpy(S).mT, torch.from_numpy(k1),
                                  torch.from_numpy(k2))
    for j in range(J):
        held(v[j].mT, iters[j], *jax_columns(S[j], k1, k2, None))
