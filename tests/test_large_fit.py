"""Large-scale accuracy regression: the 1 Gbp parameter-recovery bound.

A full two-stage `estimate` on 1 Gbp of simulated data from a known smooth
truth must recover log N(t) within the bounds below.  The run needs the
cached simulated contigs (~1 Gbp on disk) and either a GPU or ~CPU-hours,
so it is opt-in: set SMCPP_JAX_RUN_LARGE=1 with the cache prepped
(`benchmarks/large_fit_validation.py --prep`).

The reference's analogous accuracy claims are its paper-scale fits
(/root/reference/smcpp/commands/cite.py:8-9) — never re-run in CI either.
"""

import glob
import json
import os
import subprocess
import sys

import pytest

CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache",
    "large_fit",
)
BENCH = os.path.join(
    os.path.dirname(os.path.dirname(__file__)),
    "benchmarks", "large_fit_validation.py",
)

# Regression bounds with headroom for EM run-to-run variation — a
# regression that matters (e.g. a broken E-step) blows these by integer
# factors.
MEDIAN_BOUND = 0.25
P90_BOUND = 0.55


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("SMCPP_JAX_RUN_LARGE") != "1",
    reason="1 Gbp fit: opt-in via SMCPP_JAX_RUN_LARGE=1 (needs prepped "
    "cache + GPU or CPU-hours)",
)
def test_large_fit_accuracy_bound():
    assert len(glob.glob(os.path.join(CACHE, "sim*.smc.gz"))) == 4, (
        "run benchmarks/large_fit_validation.py --prep first"
    )
    out = subprocess.run(
        [sys.executable, BENCH, "--run"],
        capture_output=True, text=True, timeout=7200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["median_abs_log_err"] <= MEDIAN_BOUND, res
    assert res["p90_abs_log_err"] <= P90_BOUND, res
