"""The 3xTF32 arithmetic of the fused kernels (csrc/fused.cu), on the CPU.

The W- and H-phase kernels run both GEMMs of a tile, and the cost kernel
its one GEMM, on TF32 tensor cores: each f32
operand x is split into hi = tf32(x) and lo = tf32(x - hi), rounded to
nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds, and a
product is lo*hi + hi*lo + hi*hi with f32 accumulation, which the tensor
cores truncate toward zero at every mma.  This module
emulates that arithmetic in plain PyTorch and holds it against f64, so the
error budget of the design is checked where no card is needed.  Imports
no JAX.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmf_toolbox_tpu_torch.ops.kernels import fused as fk  # noqa: E402

# f32 accumulation over a few thousand terms, well under the 1e-4 gate
# that the kernels are held to against their f32 plain versions.
REL_TOL = 2e-5
TF32_MASK = -0x2000  # 0xFFFFE000 as an int32: sign, exponent, 10 mantissa bits
# f64 bits that f32 lacks (29 of the 52 mantissa bits): clearing them
# truncates a value in f32's normal range to f32, toward zero.
F32_IN_F64_MASK = ~((1 << 29) - 1)
# The cost kernels' gate against the f32 plain version on the card.
COST_REL_TOL = 1e-4


def tf32_rna(x):
    """Round f32 to TF32 on the float's bits: add half of the dropped 13
    bits' range, then drop them (nearest, ties away from zero)."""
    return ((x.view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: the two small products first, then hi*hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a, b):
    """a @ b in plain TF32 (one product of the rounded operands)."""
    return tf32_rna(a) @ tf32_rna(b)


def fields(V, V_hat, mode):
    if mode == "kl":
        return (V / V_hat,)
    return V / (V_hat * V_hat), 1.0 / V_hat


def emulated(name, V, W, H, mode, mm):
    """phi_dot_ht / wt_dot_phi with both GEMMs done by ``mm`` and the
    field formed in f32 from the f32 product, as the kernels do."""
    phis = fields(V, mm(W, H), mode)
    if name == "phi_dot_ht":
        return tuple(mm(phi, H.T.contiguous()) for phi in phis)
    return tuple(mm(W.T.contiguous(), phi) for phi in phis)


def make(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0.1, 1, s).astype(np.float32)
                 for s in ((m, n), (m, k), (k, n)))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))


def test_tf32_rounding_on_the_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    exact = tf32_rna(x)
    # TF32 values have their 13 low bits clear and do not move.
    assert torch.all((exact.view(torch.int32) & 0x1FFF) == 0)
    assert torch.equal(tf32_rna(exact), exact)
    # Nearest: never more than half a TF32 step (2^-11 relative) away.
    assert float(((exact - x).abs() / x.abs()).max()) <= 2.0 ** -11
    # Ties (the dropped bits exactly 0x1000) go away from zero, on both
    # signs; just below a tie goes toward zero.
    one = torch.tensor([1.0], dtype=torch.float32)
    step = 2.0 ** -10  # one TF32 step at 1.0
    bits = one.view(torch.int32)
    tie = (bits + 0x1000).view(torch.float32)
    below = (bits + 0x0FFF).view(torch.float32)
    assert float(tf32_rna(tie)) == 1.0 + step
    assert float(tf32_rna(-tie)) == -(1.0 + step)
    assert float(tf32_rna(below)) == 1.0
    assert float(tf32_rna(-below)) == -1.0


def test_split_recovers_x():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1e3, 1e3, 1 << 16).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22


@pytest.mark.parametrize("name", ["phi_dot_ht", "wt_dot_phi"])
@pytest.mark.parametrize("mode", ["kl", "is"])
@pytest.mark.parametrize("m,n,k", [(300, 700, 40), (1000, 2000, 100)])
def test_emulated_3xtf32_matches_f64(name, mode, m, n, k):
    arrays = make(m, n, k, seed=m + k + (7 if mode == "is" else 0))
    V, W, H = (torch.from_numpy(x) for x in arrays)
    want = getattr(fk, f"{name}_reference")(*(torch.from_numpy(x).double() for x in arrays), mode)
    want = want if isinstance(want, tuple) else (want,)
    got3 = emulated(name, V, W, H, mode, mm3)
    got1 = emulated(name, V, W, H, mode, mm1)
    err3 = max(rel(g.numpy(), w.numpy()) for g, w in zip(got3, want))
    err1 = max(rel(g.numpy(), w.numpy()) for g, w in zip(got1, want))
    print(f"{name} {mode} {m}x{n} k={k}: 3xTF32 {err3:.3g}, 1xTF32 {err1:.3g} "
          "(max relative error against f64)")
    assert all(g.dtype == torch.float32 and g.shape == w.shape for g, w in zip(got3, want))
    assert err3 < REL_TOL


@functools.cache
def truncating_vhat(m, n, k, seed):
    """V and W @ H as the cost kernel forms it: per k-step of 8, the
    products lo*hi, then hi*lo, then hi*hi, each of 8 terms summed exactly
    (f64) and added to the f32 accumulator, which is truncated toward zero
    (one chain per output, 3 k / 8 truncating adds)."""
    V, W, H = (torch.from_numpy(x) for x in make(m, n, k, seed))
    (wh, wl), (hh, hl) = split(W), split(H)
    wh, wl, hh, hl = (x.double() for x in (wh, wl, hh, hl))
    acc, prod = torch.zeros((m, n), dtype=torch.float64), torch.empty((m, n), dtype=torch.float64)
    for k0 in range(0, k, 8):
        ks = slice(k0, k0 + 8)
        for a, b in ((wl, hh), (wh, hl), (wh, hh)):
            torch.matmul(a[:, ks], b[ks], out=prod)
            acc.add_(prod)
            acc.view(torch.int64).bitwise_and_(F32_IN_F64_MASK)
    return V, W, H, acc.float()


@pytest.mark.parametrize("mode", ["kl", "is"])
@pytest.mark.parametrize("m,n,k", [(300, 700, 40), (2000, 3000, 1024)])
def test_emulated_3xtf32_cost_terms_match_f64(mode, m, n, k):
    """cost_terms' sums over the emulated V_hat, with f32 terms summed in
    f64 as the kernel forms them, stay within the 1e-4 gate of f64."""
    V, W, H, V_hat = truncating_vhat(m, n, k, seed=m + k)
    if mode == "kl":
        got = ((V * torch.log(V_hat)).double().sum(),)
    else:
        got = (torch.log(V_hat).double().sum(), (V / V_hat).double().sum())
    want = fk.cost_terms_reference(V.double(), W.double(), H.double(), mode)
    want = want if isinstance(want, tuple) else (want,)
    err = max(abs(float(g) - float(w)) / abs(float(w)) for g, w in zip(got, want))
    print(f"cost_terms {mode} {m}x{n} k={k}: 3xTF32 with truncating "
          f"accumulation {err:.3g} (relative error against f64)")
    assert err < COST_REL_TOL


def test_h_phase_is_the_transposed_w_phase():
    """wt_dot_phi(V, W, H) == phi_dot_ht(V', H', W')': one kernel body
    serves both phases."""
    V, W, H = (torch.from_numpy(x).double() for x in make(50, 70, 9, seed=3))
    for mode in ("kl", "is"):
        want = fk.wt_dot_phi_reference(V, W, H, mode)
        got = fk.phi_dot_ht_reference(V.T, H.T, W.T, mode)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.T, w, rtol=1e-12, atol=0)
