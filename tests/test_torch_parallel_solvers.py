"""mesh= for the Gram/MU family, cmfwisa and nmf_streaming, the CLI's
--mesh over every solver and the estimator's mesh, against the JAX
package on the same mesh shapes.

Four Gloo ranks on the CPU (tests/torch_mesh.py) run each case on a 1-D
mesh of 4 and a 2-D mesh of 2x2; the JAX package runs it on
``make_mesh(4)`` / ``make_mesh(shape=(2, 2))`` of the conftest's virtual
devices, and the port once more with no mesh.  Inputs come from a seeded
NumPy generator, in f64 with injected inits; the padded cases take
shapes that no mesh axis divides.  Tolerances are the JAX tests' (atol
1e-10 on the factors and rtol 1e-10 on the cost, tests/test_parallel.py;
1e-9 for cmfwisa and streaming, tests/test_parallel_padded.py), and
every rank's result must be bit-identical to rank 0's.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu import parallel as jpar  # noqa: E402
from nmf_toolbox_tpu.models import streaming as jstream  # noqa: E402

from torch_mesh import Ranks, RankError, estimator, run_cli, streaming  # noqa: E402

tstream = importlib.import_module("nmf_toolbox_tpu_torch.models.streaming")

CPU = {"device": "cpu"}
F64 = dict(dtype=np.float64, tolerance=1e-12)
KINDS = ("1d", "2d")
K = 4


def jmesh(kind):
    return jpar.make_mesh(4) if kind == "1d" else jpar.make_mesh(shape=(2, 2))


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def arr(x):
    if isinstance(x, (list, tuple)):
        return [arr(v) for v in x]
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, fields, atol=1e-10, rtol=1e-10):
    """``got`` (a rank's NumPy fields) against a Result's."""
    for f in fields:
        a, b = got[f], arr(getattr(want, f))
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            np.testing.assert_allclose(x, y, atol=atol, err_msg=f)
    np.testing.assert_allclose(got["cost"], arr(want.cost), rtol=rtol)


def gram_case(solver, m, n, seed=0):
    """(positional args, keyword args, compared fields) of a solver of the
    Gram/MU family at (m, n), with injected inits."""
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (m, n))
    W0, H0 = rng.uniform(size=(m, K)), rng.uniform(size=(K, n))
    kw = dict(maxiter=12, **F64)
    if solver == "lnmf":
        return (V, K), dict(W_init=W0, H_init=H0, **kw), ("W", "H")
    if solver == "seminmf":  # mixed-sign V and W
        return (V - 0.5, K), dict(W_init=W0 - 0.5, H_init=H0 + 0.2, **kw), ("W", "H")
    if solver == "constrainednmf":
        labels = rng.integers(0, 3, n)
        labels[rng.choice(n, n // 3, replace=False)] = -1  # labeled on every rank
        C = len(np.unique(labels[labels >= 0]))
        Z0 = rng.uniform(size=(K, n // 3 + C))
        return ((V, labels, K), dict(W_init=W0, Z_init=Z0, divergence="kl", **kw),
                ("W", "H", "Z"))
    if solver == "symnmf":
        return (V.T @ V, 3), dict(H_init=rng.uniform(size=(n, 3)), **kw), ("H",)
    if solver == "convexnmf":  # mixed-sign V: the general step
        return ((V - 0.4, K), dict(G_init=rng.uniform(size=(n, K)), H_init=H0, **kw),
                ("W", "H", "G"))
    if solver == "chnmf":
        return ((V, K), dict(S_init=V[:, :6], G_init=rng.uniform(size=(6, K)),
                             H_init=H0, H_sparsity=0.1, **kw), ("W", "H", "G"))
    raise KeyError(solver)


GRAM = ("lnmf", "seminmf", "constrainednmf", "symnmf", "convexnmf", "chnmf")


def run_sharded(ranks, solver, args, kw, fields, kind):
    got = ranks.solve(f"nmf_toolbox_tpu_torch.{solver}", *args, mesh=kind,
                      fields=fields + ("cost",), **kw)
    return got, getattr(jt, solver)(*args, mesh=jmesh(kind), **kw), \
        getattr(tt, solver)(*args, **kw, **CPU)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("solver", GRAM)
def test_gram_family_sharded(ranks, solver, kind):
    args, kw, fields = gram_case(solver, 16, 64)
    got, jax_res, plain = run_sharded(ranks, solver, args, kw, fields, kind)
    close(got, jax_res, fields)
    close(got, plain, fields)


@pytest.mark.parametrize("solver", GRAM)
def test_gram_family_padded(ranks, solver):
    """15 x 61 divides by no axis of the 2 x 2 mesh (symnmf: n pads to
    the least common multiple of both axes)."""
    args, kw, fields = gram_case(solver, 15, 61, seed=1)
    got, jax_res, plain = run_sharded(ranks, solver, args, kw, fields, "2d")
    close(got, jax_res, fields)
    close(got, plain, fields)


def test_symnmf_pads_for_a_1d_mesh(ranks):
    args, kw, fields = gram_case("symnmf", 15, 30, seed=2)  # n = 30 on 4 ranks
    got, jax_res, plain = run_sharded(ranks, "symnmf", args, kw, fields, "1d")
    close(got, jax_res, fields)
    close(got, plain, fields)


def test_lnmf_inclusive_stop_on_mesh(ranks):
    """lnmf's <= rule reads the summed cost: every rank stops at the
    iteration the unmeshed run stops at."""
    args, kw, fields = gram_case("lnmf", 16, 64, seed=3)
    kw.update(maxiter=300, tolerance=0.05)
    got, jax_res, plain = run_sharded(ranks, "lnmf", args, kw, fields, "2d")
    assert plain.converged and got["n_iters"] == plain.n_iters < 300
    close(got, plain, fields)
    close(got, jax_res, fields)


# ---------------------------------------------------------------------------
# cmfwisa
# ---------------------------------------------------------------------------

def complex_case(m, n, seed=4):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
    kw = dict(W_init=[rng.uniform(size=(m, 2)), rng.uniform(size=(m, 3))],
              H_init=[rng.uniform(size=(2, n)), rng.uniform(size=(3, n))],
              H_sparsity=[0.0, 0.1], maxiter=8, tolerance=1e-12, dtype=np.complex128)
    return V, kw


VBAR_FLOOR = 0.1  # |V_bar| below which a phase is held at PHASE_ATOL_NEAR_ZERO
PHASE_ATOL_NEAR_ZERO = 1e-4


def last_vbar_abs(V, kw):
    """|V_bar_i| = |W_i H_i P_i + beta_i (V - V_hat)| of cmfwisa's last
    step (cmfwisa.m:177-179), (S, m, n): from the port's no-mesh run one
    iteration short, whose state that step reads."""
    prev = tt.cmfwisa(V, [2, 3], **dict(kw, maxiter=kw["maxiter"] - 1), **CPU)
    WH = torch.stack([w @ h for w, h in zip(prev.W, prev.H)])
    P = torch.stack(list(prev.P))
    V_hat = torch.sum(WH * P, dim=0)
    beta = WH / torch.sum(WH, dim=0, keepdim=True)
    return torch.abs(WH * P + beta * (torch.as_tensor(V) - V_hat)).numpy()


CMF_CASES = [((16, 64), "1d"), ((16, 64), "2d"), ((15, 61), "2d")]


@pytest.mark.parametrize("shape,kind", CMF_CASES)
def test_cmfwisa_sharded(ranks, shape, kind):
    """W, H and the cost at the JAX test's 1e-9; the phases P at 1e-9
    wherever |V_bar| >= VBAR_FLOOR, and at 1e-4 below it.  V_bar is the
    small difference of O(1) terms there, so its phase carries rounding
    forward with a gain of about 1/|V_bar| per iteration: after 8
    iterations the JAX package's and the port's no-mesh phases differ
    by 2e-5 at the entry of least |V_bar| (0.0165), and the mesh run's
    gaps are of that size at the same entries."""
    V, kw = complex_case(*shape)
    got = ranks.solve("nmf_toolbox_tpu_torch.cmfwisa", V, [2, 3], mesh=kind,
                      fields=("W", "H", "P", "cost"), **kw)
    small = last_vbar_abs(V, kw) < VBAR_FLOOR
    assert small.mean() < 0.1  # the loose entries are few (3-7 % per source)
    for want in (jt.cmfwisa(V, [2, 3], mesh=jmesh(kind), **kw),
                 tt.cmfwisa(V, [2, 3], **kw, **CPU)):
        close(got, want, ("W", "H"), atol=1e-9, rtol=1e-9)
        for s, (a, b) in enumerate(zip(got["P"], arr(want.P))):
            np.testing.assert_allclose(a[~small[s]], b[~small[s]], atol=1e-9)
            np.testing.assert_allclose(a[small[s]], b[small[s]], atol=PHASE_ATOL_NEAR_ZERO)


# ---------------------------------------------------------------------------
# nmf_streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,kind", [((16, 64), "1d"), ((16, 64), "2d"),
                                        ((15, 61), "2d")])
def test_streaming_sharded(ranks, shape, kind, monkeypatch):
    """Each block is zero-padded to the mesh's multiples; the block inits
    are the same arrays in both packages (their generators differ)."""
    m, n = shape
    rng = np.random.default_rng(5)
    V = rng.uniform(0.1, 1.0, (m, n))
    block = 24
    draws = [rng.uniform(size=(3, min(block, n - a))) for a in range(0, n, block)]
    kw = dict(W_init=rng.uniform(size=(m, 3)), block_size=block, epochs=3,
              return_H=True, tolerance=1e-12, dtype=np.float64)
    got = ranks.run(streaming, V, 3, draws, kind, **kw)[0]
    for module, wrap in ((jstream, np.asarray), (tstream, torch.from_numpy)):
        it = iter(draws)
        monkeypatch.setattr(module, "uniform_init",
                            lambda *a, _it=it, _wrap=wrap, **k: _wrap(next(_it)))
        want = (jt.nmf_streaming(V, 3, mesh=jmesh(kind), **kw) if module is jstream
                else tt.nmf_streaming(V, 3, **kw, **CPU))
        close(got, want, ("W", "H"), atol=1e-9, rtol=1e-9)


def test_encode_streaming_refuses_mesh(ranks):
    """The one-device out-of-core encode refuses a mesh as the JAX
    package's does."""
    V, W = np.ones((4, 6)), np.ones((4, 2))
    with pytest.raises(ValueError, match="single-device"):
        jt.nmf_encode_streaming(V, W, mesh=jmesh("1d"))
    with pytest.raises(RankError, match="single-device"):
        ranks.solve("nmf_toolbox_tpu_torch.nmf_encode_streaming", V, W, mesh="1d")


# ---------------------------------------------------------------------------
# The CLI's --mesh and the estimator
# ---------------------------------------------------------------------------

CLI_ARGS = {
    "nmf": [], "nmf_hals": [], "nmfsc": ["--h-sparsity", "0.5"],
    "cnmf": ["--context-len", "3"], "cnmfsc": ["--context-len", "3"],
    "cmfwisa": [], "lnmf": [], "convexnmf": [], "seminmf": [], "chnmf": [],
    "chcnmf": ["--context-len", "3"], "constrainednmf": ["--labels", None],
    "nmf2d": ["--context-len", "3", "--pitch-len", "2"], "symnmf": [],
    "streaming": ["--streaming", "--block-size", "16"],  # f32: it takes no --dtype
}


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_mesh")
    rng = np.random.default_rng(6)
    V = rng.uniform(0.1, 1.0, (12, 32))  # nmf_hals takes no padding
    np.save(d / "V.npy", V)
    np.save(d / "A.npy", V.T @ V)
    labels = rng.integers(0, 2, 32)
    labels[::3] = -1
    np.save(d / "labels.npy", labels)
    return d


@pytest.mark.parametrize("solver", sorted(CLI_ARGS))
def test_cli_mesh_every_solver(ranks, cli_files, solver):
    """``--mesh 4`` on four ranks: every solver of the CLI and ``nmf
    --streaming`` run sharded; rank 0 writes --out, and its factors equal
    the unsharded run's."""
    name = "nmf" if solver == "streaming" else solver
    data = cli_files / ("A.npy" if solver == "symnmf" else "V.npy")
    extra = [str(cli_files / "labels.npy") if a is None else a for a in CLI_ARGS[solver]]
    f64 = solver != "streaming"
    base = [name, str(data), "--k", "3", "--maxiter", "4", "--device", "cpu"] + extra
    base += ["--dtype", "float64"] if f64 else []
    plain, meshed = (str(cli_files / f"{solver}_{t}.npz") for t in ("plain", "mesh"))
    outs = ranks.run(run_cli, base + ["--mesh", "4", "--out", meshed])
    assert all(rc == 0 for rc, _ in outs), outs
    assert outs[0][1] and not any(text for _, text in outs[1:])  # rank 0 prints
    assert run_cli(base + ["--out", plain])[0] == 0
    with np.load(plain) as a, np.load(meshed) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            if a[key].dtype.kind in "fc":
                np.testing.assert_allclose(b[key], a[key], atol=1e-9 if f64 else 1e-5,
                                           err_msg=key)


def test_cli_mesh_separate(ranks, tmp_path):
    """separate --mesh: the solo fits and the mixture's W_fixed fit run
    sharded, plain and phase-aware; rank 0 writes the stems."""
    rng = np.random.default_rng(7)
    sig = [rng.normal(size=4000) for _ in range(2)]
    paths = []
    for i, s in enumerate(sig + [sig[0] + sig[1]]):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], s)
    for extra in ([], ["--phase-aware"]):
        args = ["separate", paths[2], "--solos", f"{paths[0]},{paths[1]}", "--ks", "3",
                "--n-fft", "64", "--maxiter", "4", "--dtype", "float64",
                "--device", "cpu"] + extra
        outs = ranks.run(run_cli, args + ["--mesh", "4", "--out", str(tmp_path / "m")])
        assert all(rc == 0 for rc, _ in outs), outs
        assert run_cli(args + ["--out", str(tmp_path / "p")])[0] == 0
        for i in range(2):
            np.testing.assert_allclose(np.load(tmp_path / f"m_source{i}.npy"),
                                       np.load(tmp_path / f"p_source{i}.npy"), atol=1e-9)


@pytest.mark.parametrize("solver", ["lnmf", "cnmf"])
def test_estimator_mesh_reaches_the_solver(ranks, solver):
    """estimators.NMF forwards mesh= to a newly meshed solver: lnmf fits
    the unsharded estimator's components; cnmf's sharded solve runs and
    the facade then refuses its 3-D basis, as without a mesh."""
    from nmf_toolbox_tpu_torch.estimators import NMF
    X = np.random.default_rng(8).uniform(0.1, 1.0, (40, 12))
    kw = dict(n_components=3, solver=solver, max_iter=6, dtype=np.float64,
              solver_args=(2,) if solver == "cnmf" else ())
    if solver == "cnmf":
        with pytest.raises(RankError, match="3-D basis"):
            ranks.run(estimator, X, "2d", **kw)
        with pytest.raises(ValueError, match="3-D basis"):
            NMF(**kw, **CPU).fit(X)
        return
    comps, H, trace = ranks.run(estimator, X, "2d", **kw)[0]
    est = NMF(**kw, **CPU)
    np.testing.assert_allclose(H, est.fit_transform(X), atol=1e-10)
    np.testing.assert_allclose(comps, est.components_, atol=1e-10)
    np.testing.assert_allclose(trace, est.cost_trace_, rtol=1e-10)


def phase_gaps():
    """Print, for each case of test_cmfwisa_sharded and each source, the
    largest |P| gap of the mesh run from the JAX mesh run and from the
    port's no-mesh run (and of the two no-mesh runs from each other),
    the |V_bar| at that entry, and the largest |V_bar| among the entries
    whose gap exceeds 1e-9:  PYTHONPATH=. python tests/test_torch_parallel_solvers.py"""
    r = Ranks(4)
    try:
        for shape, kind in CMF_CASES:
            V, kw = complex_case(*shape)
            got = r.solve("nmf_toolbox_tpu_torch.cmfwisa", V, [2, 3], mesh=kind,
                          fields=("W", "H", "P", "cost"), **kw)
            vbar = last_vbar_abs(V, kw)
            plain = arr(tt.cmfwisa(V, [2, 3], **kw, **CPU).P)
            pairs = {"mesh - JAX mesh": (got["P"], arr(jt.cmfwisa(V, [2, 3], mesh=jmesh(kind),
                                                                   **kw).P)),
                     "mesh - port no mesh": (got["P"], plain),
                     "port no mesh - JAX no mesh": (plain, arr(jt.cmfwisa(V, [2, 3], **kw).P))}
            for label, (ps, qs) in pairs.items():
                for s, (a, b) in enumerate(zip(ps, qs)):
                    d = np.abs(a - b)
                    i = np.unravel_index(np.argmax(d), d.shape)
                    print(f"{shape} {kind} {label}, source {s}: max |dP| {d[i]:.3g} at "
                          f"|V_bar| {vbar[s][i]:.4g} (least {vbar[s].min():.4g}); largest "
                          f"|V_bar| with |dP| > 1e-9: {vbar[s][d > 1e-9].max(initial=0):.4g}; "
                          f"entries below {VBAR_FLOOR}: {np.mean(vbar[s] < VBAR_FLOOR):.3f}")
    finally:
        r.close()


if __name__ == "__main__":
    import conftest  # noqa: F401  (the JAX package on the CPU's virtual devices)
    phase_gaps()
