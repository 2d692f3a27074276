"""The benchmark of ``nmf_toolbox_tpu_torch`` on NVIDIA cards.

One run of one cell, from the root of a checkout::

    python3 nmfbench/run.py --workload kl40k.fused --seed 7 --seconds 51 --trace 0

prints one JSON line (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``).  ``BENCHMARK.json`` names the cells; each configuration,
traffic mix and metric is a file of its own here (``configs/``,
``traffic/``, ``metrics/``), and so is each solver of the port that a
configuration names (``solvers/``) and its plain reference
(``reference/``).  ``control.py`` takes the readings the limits of
``check.py`` were set from.  The CPU tests:
``python -m pytest nmfbench/tests -q``; those marked ``cuda`` run on a
card.  Nothing here imports JAX or the JAX package.
"""
