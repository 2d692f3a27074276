"""The port's debug helpers (``nmf_toolbox_tpu_torch.utils.debug``)
against the JAX package's: iteration_logger through nmf(callback=),
check_finite (lists included) and profile_to / trace on the CPU."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
from nmf_toolbox_tpu.utils import debug as jdebug  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
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
    """The TPU matmul emulation models the TPU's bf16 matrix unit; the
    port's numerics model is tests/test_torch_tf32.py."""
    assert hasattr(jdebug, "emulate_tpu_matmul_numerics")
    assert not hasattr(debug, "emulate_tpu_matmul_numerics")
