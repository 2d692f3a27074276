"""The port's debug helpers (``nmf_toolbox_tpu_torch.utils.debug``)
against the JAX package's: iteration_logger through nmf(callback=),
check_finite (lists included) and profile_to / trace on the CPU, and
emulate_card_matmul_numerics (tests/test_tpu_emulation.py's checks,
for the card's TF32 GEMMs and the kernels' 3xTF32)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
from nmf_toolbox_tpu.utils import debug as jdebug  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch import core  # noqa: E402
from nmf_toolbox_tpu_torch.utils import debug  # noqa: E402

F64 = {"dtype": np.float64, "device": "cpu"}


def _problem(seed=5, m=16, n=20, k=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 1, (m, n)), rng.uniform(size=(m, k)), rng.uniform(size=(k, n))


def test_iteration_logger_lines_equal_jax(capsys):
    V, W0, H0 = _problem()
    kw = dict(W_init=W0, H_init=H0, maxiter=6, tolerance=1e-30, divergence="kl")
    tt.nmf(V, 2, callback=debug.iteration_logger("it"), **kw, **F64)
    port = capsys.readouterr().out.splitlines()
    res = jt.nmf(V, 2, dtype=np.float64, **kw)
    log = jdebug.iteration_logger("it")
    for i, c in enumerate(np.asarray(res.cost)):
        log(i, c)
    jax_lines = capsys.readouterr().out.splitlines()
    assert len(port) == 6 and port == jax_lines
    assert port[0].startswith("it 1: cost = ")


@pytest.mark.parametrize("where", ["W", "H", "cost", "list"])
def test_check_finite_raises_on_nan(where):
    V, W0, H0 = _problem()
    res = tt.nmf(V, [1, 1] if where == "list" else 2, maxiter=3, seed=0, **F64)
    debug.check_finite(res)
    jdebug.check_finite(jt.nmf(V, 2, maxiter=3, dtype=np.float64))
    if where == "list":
        res.H[1] = res.H[1].clone()
        res.H[1][0, 0] = float("nan")
    elif where == "cost":
        res.cost = res.cost.copy()
        res.cost[-1] = np.inf
    else:
        bad = getattr(res, where).clone()
        bad[0, 0] = float("nan")
        setattr(res, where, bad)
    with pytest.raises(FloatingPointError, match=f"'{'H' if where == 'list' else where}'"):
        debug.check_finite(res)


def test_profile_capture(tmp_path):
    """profile_to writes a Chrome trace holding the run's ops and a
    trace() label."""
    V, _, _ = _problem()
    with debug.profile_to(str(tmp_path / "prof")):
        with debug.trace("nmf-span"):
            tt.nmf(V, 2, maxiter=3, **F64)
    produced = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(produced) == 1
    events = json.loads(produced[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "nmf-span" in names
    assert any(str(n).startswith("aten::mm") for n in names)


def test_emulation_helper_is_not_ported():
    """The counterpart of the TPU matmul emulation exists and sits where
    JAX's does: in utils.debug, outside utils.__all__ in both packages."""
    import nmf_toolbox_tpu.utils as jutils
    import nmf_toolbox_tpu_torch.utils as tutils
    assert hasattr(jdebug, "emulate_tpu_matmul_numerics")
    assert callable(debug.emulate_card_matmul_numerics)
    assert "emulate_tpu_matmul_numerics" not in jutils.__all__
    assert "emulate_card_matmul_numerics" not in tutils.__all__


# ---------------------------------------------------------------------------
# emulate_card_matmul_numerics: the checks of tests/test_tpu_emulation.py,
# recast for the card's TF32 GEMMs and the kernels' 3xTF32.
# ---------------------------------------------------------------------------

TF32_BITS = np.uint32(0xFFFFE000)


def rounded_tf32(x):
    """x rounded to TF32, nearest with ties to even as the card's cuBLAS
    rounds, on NumPy's view of the bits (independent of
    ops/kernels/tf32.py)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    odd = (bits >> np.uint32(13)) & np.uint32(1)
    return ((bits + np.uint32(0x0FFF) + odd) & TF32_BITS).view(np.float32)


@pytest.fixture
def precision():
    """Sets torch.backends.cuda.matmul.fp32_precision; restores it after."""
    backend = torch.backends.cuda.matmul
    saved = backend.fp32_precision

    def set_to(value):
        backend.fp32_precision = value
    yield set_to
    backend.fp32_precision = saved


def _operands(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
                 for _ in range(2))


def _rel(a, b, scale):
    return float((a.double() - b.double()).abs().max() / scale)


def test_card_emulation_numerics(precision):
    A, B = _operands()
    ref = A.double() @ B.double()
    scale = float(ref.abs().max())
    expect = torch.from_numpy(rounded_tf32(A.numpy()) @ rounded_tf32(B.numpy()))
    precision("tf32")
    with debug.emulate_card_matmul_numerics():
        emu = A @ B
        forms = [torch.einsum("ij,jk->ik", A, B), torch.mm(A, B), torch.matmul(A, B),
                 torch.addmm(torch.zeros(64, 64), A, B), torch.bmm(A[None], B[None])[0],
                 torch.einsum("ij,jk->ik", [A, B]), B.__rmatmul__(A)]
        vec = A @ B[:, 0], A @ B[:, :1], A[:1] @ B, torch.addmv(B[0], A, B[1])
        with core.full_f32_matmul():
            full = A @ B
    # GEMMs get the card's TF32 rounding: not a no-op...
    assert _rel(emu, ref, scale) > 1e-4, "emulation was a no-op"
    # ...and the right error model: the independently rounded operands'
    # product, to f32 accumulation order
    assert _rel(emu, expect, scale) < 1e-5, "wrong error model"
    for got in forms:
        assert _rel(got, expect, scale) < 1e-5
    # a product with a vector operand or out, a GEMV on the card: full f32
    for got, want in zip(vec, (ref[:, :1].T, ref[:, :1], ref[:1])):
        assert _rel(got.reshape(want.shape), want, scale) < 1e-6
    assert torch.equal(vec[3], torch.addmv(B[0], A, B[1]))
    # full_f32_matmul blocks stay full f32, as on the card
    assert torch.equal(full, A @ B)


def test_card_emulation_leaves_ieee_and_other_dtypes(precision):
    A, B = _operands(1)
    for setting in ("ieee", "none"):
        precision(setting)
        with debug.emulate_card_matmul_numerics():
            got = A @ B, A.double() @ B.double(), A.bfloat16() @ B.bfloat16()
        assert torch.equal(got[0], A @ B)
        assert torch.equal(got[1], A.double() @ B.double())
        assert torch.equal(got[2], A.bfloat16() @ B.bfloat16())


def test_card_emulation_runs_kernel_twins_in_3xtf32(precision):
    """The fused kernels' plain versions compute their products in the
    kernels' 3xTF32 inside the emulation, at either precision setting,
    and in plain f32 outside it."""
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk, fused_dma as dk
    from nmf_toolbox_tpu_torch.ops.kernels.tf32 import mm3
    rng = np.random.default_rng(2)
    V, W, H = (torch.from_numpy(rng.uniform(0.1, 1, s).astype(np.float32))
               for s in ((48, 40), (48, 6), (6, 40)))
    phi = V / mm3(W, H)
    want = {"phi_dot_ht": mm3(phi, H.T), "wt_dot_phi": mm3(W.T, phi),
            "kl_phi_dot_ht_dma": mm3(phi, H.T)}
    for setting in ("ieee", "tf32"):
        precision(setting)
        with debug.emulate_card_matmul_numerics():
            got = {"phi_dot_ht": fk.phi_dot_ht(V, W, H, "kl"),
                   "wt_dot_phi": fk.wt_dot_phi(V, W, H, "kl"),
                   "kl_phi_dot_ht_dma": dk.kl_phi_dot_ht_dma(V, W, H)}
        for name, g in got.items():
            torch.testing.assert_close(g, want[name], rtol=1e-6, atol=0)
    precision("ieee")
    plain = fk.phi_dot_ht(V, W, H, "kl")
    assert torch.equal(plain, fk.phi_dot_ht_reference(V, W, H, "kl"))
    assert not torch.equal(plain, got["phi_dot_ht"])


def test_card_emulation_composes_with_solvers(precision):
    """Inside a solver loop: gram nmf in TF32 moves off plain f32 and stays
    finite; fused KL runs its kernels' twins in 3xTF32, within 1e-4 of
    plain f32; nmfsc (under full_f32_matmul) is untouched."""
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 1, (40, 30)).astype(np.float32)
    W0, H0 = rng.uniform(size=(40, 4)).astype(np.float32), rng.uniform(size=(4, 30)).astype(np.float32)
    kw = dict(W_init=W0, H_init=H0, maxiter=20, tolerance=1e-30, device="cpu")
    precision("tf32")
    with debug.emulate_card_matmul_numerics():
        gram = tt.nmf(V, 4, **kw)
        fused = tt.nmf(V, 4, divergence="kl", method="fused", **kw)
        sparse = tt.nmfsc(V, 4, H_sparsity=0.5, **{**kw, "maxiter": 5})
    plain = {"gram": tt.nmf(V, 4, **kw),
             "fused": tt.nmf(V, 4, divergence="kl", method="fused", **kw),
             "sparse": tt.nmfsc(V, 4, H_sparsity=0.5, **{**kw, "maxiter": 5})}
    assert np.isfinite(gram.cost).all() and np.isfinite(fused.cost).all()
    assert _rel(gram.W, plain["gram"].W, 1.0) > 1e-5
    assert not torch.equal(fused.W, plain["fused"].W)
    np.testing.assert_allclose(fused.cost, plain["fused"].cost, rtol=1e-4)
    assert torch.equal(sparse.W, plain["sparse"].W)
    np.testing.assert_array_equal(sparse.cost, plain["sparse"].cost)


def test_card_emulation_leaks_nothing(precision):
    A, B = _operands(4)
    plain = A @ B
    precision("tf32")
    with pytest.raises(ValueError, match="inside"):
        with debug.emulate_card_matmul_numerics():
            A @ B
            raise ValueError("inside")
    assert torch.equal(A @ B, plain)
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"  # the caller's, kept
    with debug.emulate_card_matmul_numerics():  # enters again: no state left behind
        assert not torch.equal(A @ B, plain)
    assert torch.equal(A @ B, plain)
    assert not torch.overrides._get_current_function_mode_stack()


def test_card_emulation_guard_raises(precision):
    """Raises where the emulation would be doubled: nested, or with
    oneDNN rounding the CPU's own f32 matmuls."""
    precision("tf32")
    with debug.emulate_card_matmul_numerics():
        with pytest.raises(RuntimeError, match="already active"):
            with debug.emulate_card_matmul_numerics():
                pass
    onednn = torch.backends.mkldnn.matmul
    saved = onednn.fp32_precision
    try:
        for setting in ("tf32", "bf16"):
            onednn.fp32_precision = setting
            with pytest.raises(RuntimeError, match="mkldnn"):
                with debug.emulate_card_matmul_numerics():
                    pass
        onednn.fp32_precision = saved
        A, B = _operands(5)
        with pytest.raises(RuntimeError, match="mkldnn"):
            with debug.emulate_card_matmul_numerics():
                onednn.fp32_precision = "tf32"
                A @ B
    finally:
        onednn.fp32_precision = saved
