"""The port's bounded probe of the cards
(``nmf_toolbox_tpu_torch.utils.deviceprobe``) and ``chip_smoke.py`` behind
it, on the CPU: a real subprocess probe finds no card and says so within
its timeout, the probe leaves ``jax`` out (module and subprocess), the
two packages keep separate caches, and ``chip_smoke.main`` stops with a
non-zero exit on a dead probe before it touches CUDA, with no CPU path.
The retry window and the cache rules are the JAX package's own tests
(``tests/test_deviceprobe.py``), run against this module in
``tests/test_torch_jax_suite_tools.py``."""
import pathlib
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from nmf_toolbox_tpu.utils import deviceprobe as jdp  # noqa: E402
from nmf_toolbox_tpu_torch.utils import deviceprobe as dp  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_real_probe_finds_no_card_within_its_timeout(monkeypatch, tmp_path, capsys):
    """No card here: the subprocess says so and the verdict is (None, 0),
    never "cpu", well inside the timeout; the dead verdict is cached."""
    monkeypatch.setattr(dp, "CACHE_PATH", str(tmp_path / "cache.json"))
    t0 = time.monotonic()
    assert dp.probe_auto(no_wait=True) == (None, 0)
    assert time.monotonic() - t0 < dp.PROBE_TIMEOUT_S
    assert "no CUDA card" in capsys.readouterr().err
    assert dp._cache_read(60) == (None, 0, dp.PROBE_TIMEOUT_S)


def test_probe_timeout_kills_a_hung_child(monkeypatch, tmp_path):
    """A probe that hangs (here: one that sleeps) is cut at its timeout."""
    monkeypatch.setattr(dp, "CACHE_PATH", str(tmp_path / "cache.json"))
    monkeypatch.setattr(dp, "_PROBE_SRC", "import time; time.sleep(60)")
    t0 = time.monotonic()
    assert dp.probe_once(timeout=1.0) == (None, 0)
    assert time.monotonic() - t0 < 10


def test_probe_reads_the_last_line(monkeypatch, tmp_path):
    """The card names may come first; the verdict is the last line."""
    monkeypatch.setattr(dp, "CACHE_PATH", str(tmp_path / "cache.json"))
    monkeypatch.setattr(dp, "_PROBE_SRC", "print('NVIDIA H100 80GB HBM3; NVIDIA H100 "
                                          "80GB HBM3'); print('cuda', 2)")
    assert dp.probe_once(timeout=30) == ("cuda", 2)


def test_probe_retry_window_with_a_stub(monkeypatch):
    """A stub probe_once drives the retry window: a card that comes back on
    the third attempt is found; progress goes to stderr."""
    calls = []

    def flaky(timeout=None):
        calls.append(timeout)
        return (None, 0) if len(calls) < 3 else ("cuda", 4)

    monkeypatch.setattr(dp, "probe_once", flaky)
    assert dp.probe_with_retry(window_s=30, interval_s=0.01, probe_timeout_s=7) == ("cuda", 4)
    assert calls == [7, 7, 7]
    monkeypatch.setattr(dp, "probe_once", lambda timeout=None: (None, 0))
    assert dp.probe_with_retry(window_s=0.05, interval_s=0.02) == (None, 0)


def test_probe_leaves_jax_out():
    """Neither the module nor its subprocess imports jax: the subprocess
    runs under -X importtime, which names every module it imports."""
    code = ("import sys; from nmf_toolbox_tpu_torch.utils import deviceprobe; "
            "print('jax' in sys.modules, 'nmf_toolbox_tpu' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert p.stdout.split() == ["False", "False"], p.stderr[-2000:]
    p = subprocess.run([sys.executable, "-X", "importtime", "-c", dp._PROBE_SRC],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    imported = {line.rsplit("|", 1)[-1].strip() for line in p.stderr.splitlines()
                if line.startswith("import time:")}
    assert "torch" in imported
    assert not any(m == "jax" or m.startswith("jax.") or m.startswith("nmf_toolbox_tpu")
                   for m in imported)
    assert "import jax" not in dp._PROBE_SRC and "import torch" in dp._PROBE_SRC


def test_caches_and_settings_are_the_ports_own():
    assert dp.CACHE_PATH != jdp.CACHE_PATH
    assert "nmf_torch_probe_cache" in dp.CACHE_PATH
    src = pathlib.Path(dp.__file__).read_text()
    assert "NMF_TPU_PROBE" not in src and "NMF_TORCH_PROBE_TIMEOUT_S" in src


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


@pytest.mark.parametrize("verdict", [(None, 0), ("cuda", 0)])
def test_chip_smoke_stops_on_a_dead_probe(monkeypatch, capsys, verdict):
    """chip_smoke.main runs the probe first; a dead verdict ends it with a
    non-zero exit and the probe's words, before phase 0 touches CUDA, and
    prints no result line."""
    cs = _chip_smoke()
    calls = []
    monkeypatch.setattr(dp, "probe_auto", lambda no_wait=False, **kw: (
        calls.append(no_wait), verdict)[1])
    touched = []
    monkeypatch.setattr(cs, "phase0_device", lambda *a, **k: touched.append("phase 0"))
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: touched.append("is_available") or False)
    with pytest.raises(SystemExit) as exc:
        cs.main()
    assert exc.value.code not in (0, None)
    assert calls == [True] and not touched
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "probe" in str(exc.value.code) + out.err


def test_chip_smoke_exits_nonzero_here():
    """``python3 chip_smoke.py`` with no card: a non-zero exit, the
    probe's words, and no result line."""
    p = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert p.returncode != 0
    assert "probe" in p.stderr and '"ok"' not in p.stdout
