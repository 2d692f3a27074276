"""The naive KL step's field and cost passes (ops/kernels/naive_kl.py).

On the CPU the wrappers run their plain versions (the KL expressions of
``ops/divergence.py``), the naive step keeps ``dv.fields`` and
``dv.cost`` (the goldens hold), and the routed step, forced on with the
wrappers' plain versions, gives the same bits as the torch chain, alone
and on a two-rank Gloo mesh.  Tests
marked ``cuda`` hold each kernel against the torch chain on a card: the
field ``torch.equal``, the cost within 1e-7 of an f64 sum, a weighted
solve's W and H ``torch.equal`` to the same solve on the plain versions,
with the launch counters showing the kernels ran.  They import no JAX,
so a machine with a card and no JAX runs them with

    python -m pytest tests/test_torch_naive_kl.py -m cuda --noconftest
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk  # noqa: E402

GOLD = pathlib.Path(__file__).parent / "goldens"
COST_RTOL = 1e-7  # the card's f64 sum, rounded once to f32
WRAPPERS = ("kl_field", "kl_cost_terms")


def make(m, n, weighted, seed=0, device="cpu"):
    """V, V_hat in (0.05, 2); with weights, M in {0} u (0.1, 1], zero
    weights over a V = NaN and a V = 0 entry."""
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.05, 2, (m, n)).astype(np.float32)
    Vh = rng.uniform(0.05, 2, (m, n)).astype(np.float32)
    M = None
    if weighted:
        M = np.where(rng.uniform(size=(m, n)) < 0.2, 0, rng.uniform(0.1, 1, (m, n)))
        M = M.astype(np.float32)
        M.flat[0], V.flat[0] = 0, np.nan
        M.flat[-1], V.flat[-1] = 0, 0  # (on a 1x1 input: the same entry)
    return tuple(None if x is None else torch.from_numpy(x).to(device) for x in (V, Vh, M))


def counts():
    return nk.kl_field_launches, nk.kl_cost_launches


def f64_cost(V, Vh, M):
    """The f64 sum of the torch chain's f32 terms."""
    t = V * torch.log(V / Vh) - V + Vh
    if M is not None:
        t = torch.where(M > 0, M * t, torch.zeros((), dtype=t.dtype, device=t.device))
    return float(torch.sum(t.double()))


def solve(V, M, k, maxiter, seed=0, **kw):
    rng = np.random.default_rng(seed)
    W0 = rng.uniform(0.1, 1, (V.shape[0], k)).astype(np.float32)
    H0 = rng.uniform(0.1, 1, (k, V.shape[1])).astype(np.float32)
    return tt.nmf(V, k, W_init=W0, H_init=H0, weights=M, divergence="kl",
                  maxiter=maxiter, tolerance=0.0, **kw)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_wrapper_is_its_plain_version_on_cpu(weighted):
    V, Vh, M = make(30, 41, weighted)
    before = counts()
    if weighted:
        assert torch.equal(nk.kl_field(V, Vh, M), nk.kl_field_reference(V, Vh, M))
        # the plain version is ops/divergence.py's weighted KL field
        phi = torch.where(M > 0, M * (V / Vh), torch.zeros(()))
        assert torch.equal(nk.kl_field_reference(V, Vh, M), phi)
    else:  # the unweighted field is V / V_hat, one torch pass: no kernel
        with pytest.raises(TypeError, match="unweighted"):
            nk.kl_field(V, Vh, None)
    assert torch.equal(nk.kl_cost_terms(V, Vh, M), nk.kl_cost_terms_reference(V, Vh, M))
    assert counts() == before  # CPU tensors never launch a kernel
    cost = nk.kl_cost_terms_reference(V, Vh, M)
    assert cost.dtype == torch.float32 and cost.ndim == 0
    assert abs(float(cost) - f64_cost(V, Vh, M)) <= 1e-5 * abs(float(cost))


@pytest.mark.parametrize("name", WRAPPERS)
def test_input_checks(name):
    fn = getattr(nk, name)
    V, Vh, M = make(20, 30, True)
    with pytest.raises(TypeError):
        fn(V.double(), Vh.double(), M.double())
    with pytest.raises(TypeError):
        fn(V, Vh, M.double())
    with pytest.raises(TypeError):
        fn(V[0], Vh[0], M[0])
    with pytest.raises(ValueError, match="shape"):
        fn(V, Vh[:, :29], M)
    with pytest.raises(ValueError, match="shape"):
        fn(V, Vh, M.T.contiguous())
    with pytest.raises(ValueError, match="one device"):
        fn(V, Vh, M.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fn(V.to("meta"), Vh.to("meta"), M.to("meta"))


def test_takes_only_card_f32_without_a_mask():
    V = torch.ones(4, 5)
    assert not nk.takes(V)  # the CPU keeps ops/divergence.py
    assert not nk.takes(V.to("meta"))
    assert not nk.takes(V.double())
    assert not nk.takes(V, mask=torch.ones(4, 5, dtype=torch.bool))


def test_weighted_kl_on_cpu_keeps_the_torch_chain(monkeypatch):
    """A CPU solve never reaches the wrappers; the golden holds."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU solve reached a naive KL wrapper")
    for name in WRAPPERS:
        monkeypatch.setattr(nk, name, refuse)
    g = np.load(GOLD / "nmf_weighted_kl.npz")
    r = tt.nmf(g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"],
               weights=g["M"], divergence="kl", maxiter=15, tolerance=1e-12,
               dtype=np.float64, device="cpu")
    np.testing.assert_allclose(r.W.numpy(), g["W"], atol=1e-9)
    np.testing.assert_allclose(r.H.numpy(), g["H"], atol=1e-9)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)
    r32 = tt.nmf(g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"],
                 weights=g["M"], divergence="kl", maxiter=15, tolerance=1e-12,
                 dtype=np.float32, device="cpu")
    np.testing.assert_allclose(r32.cost, g["cost"], rtol=1e-4)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("cost_every", [1, 3])
def test_routed_step_is_the_torch_chain_on_cpu(monkeypatch, weighted, cost_every):
    """The naive step routed through the wrappers (forced on, so that on
    the CPU they run their plain versions) gives the torch chain's bits:
    W, H and the cost trace equal, two weighted fields an iteration (the
    unweighted field stays V / V_hat), one cost a check iteration."""
    V, _, M = make(40, 33, weighted, seed=3)
    V = torch.nan_to_num(V, nan=0.5)
    kw = dict(cost_every=cost_every, device="cpu")
    plain = solve(V, M, 4, 12, **kw)
    calls = {name: 0 for name in WRAPPERS}

    def spy(name):
        fn = getattr(nk, name)

        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted
    monkeypatch.setattr(nk, "takes", lambda V, mask=None: mask is None)
    for name in WRAPPERS:
        monkeypatch.setattr(nk, name, spy(name))
    routed = solve(V, M, 4, 12, **kw)
    assert torch.equal(routed.W, plain.W) and torch.equal(routed.H, plain.H)
    np.testing.assert_array_equal(routed.cost, plain.cost)
    assert routed.n_iters == plain.n_iters == 12
    # costs on iterations {1, N, 2N, ..., maxiter} (ops/loop.cost_cadence)
    assert calls == {"kl_field": 24 if weighted else 0,
                     "kl_cost_terms": {1: 12, 3: 5}[cost_every]}


def routed_on_mesh(V, M, k, maxiter, kind):
    """Rank side: a KL solve of the full V (and M) on the mesh of
    ``kind``, once on the torch chain and once with the naive step routed
    through the wrappers (forced on, so that on the CPU they run their
    plain versions); both results and the wrapper calls on this rank."""
    from torch_mesh import call
    V, M = torch.from_numpy(V), None if M is None else torch.from_numpy(M)
    kw = dict(mesh=kind, maxiter=maxiter, tolerance=0.0, divergence="kl",
              W_init=np.full((V.shape[0], k), 0.5, np.float32), device="cpu",
              H_init=np.linspace(0.2, 1, k * V.shape[1], dtype=np.float32).reshape(k, -1))
    plain = call("nmf_toolbox_tpu_torch.nmf", V, k, weights=M, **kw)
    calls = {name: 0 for name in WRAPPERS}
    orig = {name: getattr(nk, name) for name in WRAPPERS + ("takes",)}

    def spy(name):
        def counted(*args):
            calls[name] += 1
            return orig[name](*args)
        return counted
    nk.takes = lambda V, mask=None: mask is None
    for name in WRAPPERS:
        setattr(nk, name, spy(name))
    try:
        routed = call("nmf_toolbox_tpu_torch.nmf", V, k, weights=M, **kw)
    finally:
        for name, fn in orig.items():
            setattr(nk, name, fn)
    return plain, routed, calls


@pytest.fixture(scope="module")
def two_ranks():
    from torch_mesh import Ranks
    r = Ranks(2)
    yield r
    r.close()


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_routed_step_is_the_torch_chain_on_a_mesh(two_ranks, kind, weighted):
    """On two Gloo ranks with no padding (40 x 34 splits evenly), the
    routed step sums the ranks' cost terms once: W, H and the cost trace
    equal the unrouted mesh solve's on every rank, with two weighted
    fields a rank an iteration and one cost a rank an iteration."""
    V, _, M = make(40, 34, weighted, seed=5)
    V = np.nan_to_num(V.numpy(), nan=0.5)
    M = None if M is None else M.numpy()
    maxiter = 6
    got = two_ranks.run(routed_on_mesh, V, M, 3, maxiter, kind)
    for plain, routed, calls in got:
        for f in ("W", "H", "cost"):
            np.testing.assert_array_equal(routed[f], plain[f], err_msg=f)
        assert routed["n_iters"] == plain["n_iters"] == maxiter
        assert calls == {"kl_field": 2 * maxiter if weighted else 0,
                         "kl_cost_terms": maxiter}
        np.testing.assert_array_equal(plain["cost"], got[0][0]["cost"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def misaligned(x):
    """``x`` copied to a contiguous tensor 4 bytes past a 16-byte boundary."""
    if x is None:
        return None
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    out = buf.view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


# (m, n, aligned): the cell's 40 000 x 10 000, one entry, n odd, ragged
# blocks, float4s with a tail; the scalar path (pointers 4 bytes off a
# 16-byte boundary) at the small shapes.
SMALL = [(1, 1), (3, 5), (37, 51), (257, 203)]
CARD_CASES = [(40_000, 10_000, True)] + [(m, n, a) for m, n in SMALL for a in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("m,n,aligned", CARD_CASES)
def test_kernels_match_torch_chain_on_card(cuda, m, n, aligned, weighted):
    V, Vh, M = make(m, n, weighted, seed=m + n, device=cuda)
    if not aligned:
        V, Vh, M = map(misaligned, (V, Vh, M))
    before = counts()
    if weighted:  # the unweighted field is V / V_hat, one torch pass
        phi = nk.kl_field(V, Vh, M)
    c = nk.kl_cost_terms(V, Vh, M)
    torch.cuda.synchronize()
    assert counts() == (before[0] + weighted, before[1] + 1)
    if weighted:
        assert phi.device == V.device and phi.shape == V.shape
        assert torch.equal(phi, nk.kl_field_reference(V, Vh, M))
    want = f64_cost(V, Vh, M)
    assert c.dtype == torch.float32 and c.ndim == 0 and c.device == V.device
    assert abs(float(c) - want) <= COST_RTOL * abs(want)
    assert torch.equal(nk.kl_cost_terms(V, Vh, M), c)  # fixed order: same bits


@pytest.mark.cuda
def test_card_rejects_non_contiguous(cuda):
    V, Vh, M = make(30, 40, True, device=cuda)
    for name in WRAPPERS:
        with pytest.raises(ValueError, match="contiguous"):
            getattr(nk, name)(V.T.contiguous().T, Vh, M)
        with pytest.raises(ValueError, match="contiguous"):
            getattr(nk, name)(V, Vh, M.T.contiguous().T)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [True, False])
def test_solve_is_bit_identical_to_plain_versions_on_card(cuda, monkeypatch, weighted):
    """A 2 000 x 1 500 r20 KL solve: W and H equal to the same solve with
    the wrappers swapped for their plain versions; two field launches an
    iteration (weighted) and one cost launch at cost_every=1."""
    V, _, M = make(2000, 1500, weighted, seed=7, device=cuda)
    V = torch.nan_to_num(V, nan=0.5)
    maxiter = 25
    before = counts()
    got = solve(V, M, 20, maxiter)
    torch.cuda.synchronize()
    assert got.n_iters == maxiter
    assert counts() == (before[0] + 2 * maxiter * weighted, before[1] + maxiter)
    monkeypatch.setattr(nk, "kl_field", nk.kl_field_reference)
    monkeypatch.setattr(nk, "kl_cost_terms", nk.kl_cost_terms_reference)
    want = solve(V, M, 20, maxiter)
    assert torch.equal(got.W, want.W) and torch.equal(got.H, want.H)
    np.testing.assert_allclose(got.cost, want.cost, rtol=2e-6)
