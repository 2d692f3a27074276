"""Port's shared layer (nmf_toolbox_tpu_torch/ops) against the JAX package.

Same inputs, made with NumPy from a seed, go through both packages in
f64.  The two sides run the same elementwise formulas, so they agree to
a few ulps: rtol 1e-12 leaves room only for summation order in the
reductions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmf_toolbox_tpu.ops import divergence as jdv  # noqa: E402
from nmf_toolbox_tpu.ops import gram as jgram  # noqa: E402
from nmf_toolbox_tpu.ops import loop as jloop  # noqa: E402
from nmf_toolbox_tpu.ops import masking as jmask  # noqa: E402
from nmf_toolbox_tpu.ops import normalize as jnorm  # noqa: E402
from nmf_toolbox_tpu_torch.ops import divergence as tdv  # noqa: E402
from nmf_toolbox_tpu_torch.ops import gram as tgram  # noqa: E402
from nmf_toolbox_tpu_torch.ops import loop as tloop  # noqa: E402
from nmf_toolbox_tpu_torch.ops import masking as tmask  # noqa: E402
from nmf_toolbox_tpu_torch.ops import normalize as tnorm  # noqa: E402

RTOL = 1e-12  # f64, same formulas; only reduction order differs


def close(t, j, rtol=RTOL):
    if t is None or j is None:
        assert t is None and j is None
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


def _problem(seed=0, m=12, n=17):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (m, n))
    V_hat = rng.uniform(0.1, 1.0, (m, n))
    weights = rng.uniform(0.0, 1.0, (m, n))
    weights[rng.uniform(size=(m, n)) < 0.2] = 0.0  # missing entries
    mask = np.zeros((m, n), bool)
    mask[: m - 3, : n - 5] = True
    return V, V_hat, weights, mask


DIVS = [("euclidean", 1.0, 1.0), ("kl", 1.0, 1.0), ("is", 1.0, 1.0),
        ("ab", 0.5, 1.5), ("ab", 0.0, 0.7)]


@pytest.mark.parametrize("div,alpha,beta", DIVS)
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("use_weights", [False, True])
def test_fields_and_cost(div, alpha, beta, use_mask, use_weights):
    V, V_hat, weights, mask = _problem()
    jw = jnp.asarray(weights) if use_weights else None
    tw = torch.from_numpy(weights) if use_weights else None
    jm = jnp.asarray(mask) if use_mask else None
    tm = torch.from_numpy(mask) if use_mask else None
    jf = jdv.fields(div, jnp.asarray(V), jnp.asarray(V_hat), alpha, beta,
                    mask=jm, weights=jw)
    tf = tdv.fields(div, torch.from_numpy(V), torch.from_numpy(V_hat), alpha,
                    beta, mask=tm, weights=tw)
    close(tf[0], jf[0])
    close(tf[1], jf[1])
    assert tf[2] == jf[2]
    jc = jdv.cost(div, jnp.asarray(V), jnp.asarray(V_hat), alpha, beta,
                  mask=jm, weights=jw)
    tc = tdv.cost(div, torch.from_numpy(V), torch.from_numpy(V_hat), alpha,
                  beta, mask=tm, weights=tw)
    close(tc, jc)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1.0, 0.0), (0.3, 0.7),
                                        (1.2, 0.8), (0.0, 0.5), (1.5, -0.5)])
@pytest.mark.parametrize("use_weights", [False, True])
def test_ab_fields(alpha, beta, use_weights):
    V, V_hat, weights, mask = _problem(1)
    jw = jnp.asarray(weights) if use_weights else None
    tw = torch.from_numpy(weights) if use_weights else None
    jf = jdv.ab_fields(jnp.asarray(V), jnp.asarray(V_hat), alpha, beta,
                       mask=jnp.asarray(mask), weights=jw)
    tf = tdv.ab_fields(torch.from_numpy(V), torch.from_numpy(V_hat), alpha,
                       beta, mask=torch.from_numpy(mask), weights=tw)
    close(tf[0], jf[0])
    close(tf[1], jf[1])
    assert tf[2] == jf[2]


def test_canon_ab_params_apply_power():
    for name in jdv.DIVERGENCES:
        assert tdv.canon(name) == jdv.canon(name)
        assert tdv.ab_params(name, 0.4, 0.6) == jdv.ab_params(name, 0.4, 0.6)
    with pytest.raises(ValueError):
        tdv.canon("hellinger")
    x = np.random.default_rng(2).uniform(0.1, 1, (4, 5))
    for p in (None, 1.0, 0.5, 2.0):
        close(tdv.apply_power(torch.from_numpy(x), p),
              jdv.apply_power(jnp.asarray(x), p))


def test_gram():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(6, 6))
    V = rng.uniform(size=(9, 11))
    W = rng.uniform(size=(9, 4))
    H = rng.uniform(size=(4, 11))
    for t, j in zip(tgram.pos_neg_split(torch.from_numpy(A)),
                    jgram.pos_neg_split(jnp.asarray(A))):
        close(t, j)
    close(tgram.sq_norm(torch.from_numpy(V)), jgram.sq_norm(jnp.asarray(V)))
    v_sq = float(np.sum(V * V))
    close(tgram.euclidean_cost_gram(v_sq, torch.from_numpy(W.T @ V),
                                    torch.from_numpy(W.T @ W), torch.from_numpy(H)),
          jgram.euclidean_cost_gram(v_sq, jnp.asarray(W.T @ V),
                                    jnp.asarray(W.T @ W), jnp.asarray(H)))
    close(tgram.euclidean_cost_gram_w(v_sq, torch.from_numpy(V @ H.T),
                                      torch.from_numpy(H @ H.T), torch.from_numpy(W)),
          jgram.euclidean_cost_gram_w(v_sq, jnp.asarray(V @ H.T),
                                      jnp.asarray(H @ H.T), jnp.asarray(W)))
    # The clamp at zero: an exact fit gives 0, not a rounding negative.
    assert float(tgram.euclidean_cost_gram(
        0.0, torch.zeros(4, 11, dtype=torch.float64),
        torch.zeros(4, 4, dtype=torch.float64), torch.from_numpy(H))) == 0.0
    W3 = rng.uniform(size=(9, 4, 3))
    Hs = rng.uniform(size=(3, 4, 11))
    close(tgram.conv_cross_grams_w(torch.from_numpy(W3)),
          jgram.conv_cross_grams_w(jnp.asarray(W3)))
    close(tgram.conv_cross_grams_h(torch.from_numpy(Hs)),
          jgram.conv_cross_grams_h(jnp.asarray(Hs)))


def test_normalize():
    rng = np.random.default_rng(4)
    W = rng.uniform(0.1, 1, (8, 5))
    H = rng.uniform(0.1, 1, (5, 7))
    W3 = rng.uniform(0.1, 1, (8, 5, 3))
    H3 = rng.uniform(0.1, 1, (2, 5, 7))
    tW, tH, tW3, tH3 = (torch.from_numpy(x) for x in (W, H, W3, H3))
    jW, jH, jW3, jH3 = (jnp.asarray(x) for x in (W, H, W3, H3))
    close(tnorm.unit_l2_columns(tW), jnorm.unit_l2_columns(jW))
    close(tnorm.unit_sum_columns(tW), jnorm.unit_sum_columns(jW))
    for Wt, Wj in ((tW, jW), (tW3, jW3)):
        for t, j in zip(tnorm.row_l2_transfer(tH, Wt), jnorm.row_l2_transfer(jH, Wj)):
            close(t, j)
    for kw in ({}, {"context_len": 2}):
        for Ht, Hj in ((tH, jH), (tH3, jH3), (None, None)):
            t = tnorm.cross_frame_norm(tW3, Ht, **kw)
            j = jnorm.cross_frame_norm(jW3, Hj, **kw)
            close(t[0], j[0])
            close(t[1], j[1])
    t = tnorm.cross_frame_norm(tW3, return_norms=True)
    j = jnorm.cross_frame_norm(jW3, return_norms=True)
    close(t[1], j[1])


def test_masking():
    for shape, valid in (((5, 7), (3, 4)), ((2, 5, 7), (5, 2)), ((4, 4), None)):
        t = tmask.region_mask(shape, valid)
        j = jmask.region_mask(shape, valid)
        if valid is None:
            assert t is None and j is None
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tmask.col_mask(6, 4).numpy(),
                                  np.asarray(jmask.col_mask(6, 4)))
    assert tmask.col_mask(6, None) is None


# ---------------------------------------------------------------------------
# The loop: a synthetic step whose cost falls geometrically, so the stop
# rule fires at a known iteration, run through both loops in f64.
# ---------------------------------------------------------------------------

LOOP_CASES = [
    # (cost_every, maxiter, tolerance, offset, inclusive, terminate_at)
    (1, 40, 1e-3, 0, False, None),   # tolerance fires
    (1, 12, 1e-9, 0, False, None),   # runs out
    (3, 40, 1e-3, 0, False, None),   # cadence: stops on a check iteration
    (4, 10, 1e-9, 0, False, None),   # cadence, runs out (last is a check)
    (1, 40, 1e-3, 1, False, None),   # nmfsc-style initial cost slot
    (1, 40, 1e-3, 0, True, None),    # lnmf's inclusive rule
    (3, 40, 1e-3, 0, True, None),    # inclusive rule under the cadence
    (1, 40, 1e-9, 1, False, 6),      # line-search termination
]


def _j_step(ce, maxiter, terminate_at):
    finish = jloop.cost_cadence(ce, maxiter)

    def step(carry, i):
        x = carry[0] * 0.8 + 0.1
        term = (i == terminate_at) if terminate_at is not None else jnp.asarray(False)
        new, c, _ = finish((x,), carry, i, lambda: jnp.sum(x * x) / 7.0)
        return new, c, term
    return step


def _t_step(ce, maxiter, terminate_at):
    finish = tloop.cost_cadence(ce, maxiter)

    def step(carry, i):
        x = carry[0] * 0.8 + 0.1
        new, c, _ = finish((x,), carry, i, lambda: torch.sum(x * x) / 7.0)
        return new, c, i == terminate_at
    return step


@pytest.mark.parametrize("ce,maxiter,tol,offset,inclusive,term_at", LOOP_CASES)
def test_loop_cadence_and_trim(ce, maxiter, tol, offset, inclusive, term_at):
    x0 = np.random.default_rng(5).uniform(1.0, 2.0, 6)
    init = float(np.sum(x0 * x0) / 7.0) if offset else None
    jout = jloop.run(_j_step(ce, maxiter, term_at),
                     jloop.cadence_state((jnp.asarray(x0),), ce, jnp.float64),
                     maxiter, tol, offset=offset, initial_cost=init,
                     inclusive=inclusive, cost_dtype=jnp.float64, cost_every=ce)
    tout = tloop.run(_t_step(ce, maxiter, term_at),
                     tloop.cadence_state((torch.from_numpy(x0),), ce, torch.float64),
                     maxiter, tol, offset=offset, initial_cost=init,
                     inclusive=inclusive, cost_dtype=torch.float64, cost_every=ce)
    assert tout.n_iters == int(jout.n_iters)
    assert tout.stopped == bool(jout.stopped)
    assert tout.terminated == bool(jout.terminated)
    jc = jloop.trim_cost(jout, maxiter, offset=offset)
    tc = tloop.trim_cost(tout, maxiter, offset=offset)
    assert tc.shape == jc.shape
    np.testing.assert_allclose(tc, jc, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(tloop.trim_cost(tout, maxiter, trim=False).shape,
                                  jloop.trim_cost(jout, maxiter, trim=False).shape)
    close(tout.state[0], jout.state[0])


def test_loop_checks_only_on_cadence():
    """With cost_every > 1 the stop rule is read on check iterations only,
    and a stop lands on one."""
    ce, maxiter = 5, 60
    out = tloop.run(_t_step(ce, maxiter, None),
                    tloop.cadence_state((torch.ones(3, dtype=torch.float64) * 3,),
                                        ce, torch.float64),
                    maxiter, 1e-4, cost_dtype=torch.float64, cost_every=ce)
    assert out.stopped
    assert tloop.is_check(out.n_iters - 1, ce, maxiter)
    assert [i for i in range(12) if tloop.is_check(i, ce, 12)] == [0, 4, 9, 11]
