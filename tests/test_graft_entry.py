"""Regression tests for __graft_entry__: the multi-device dryrun runs
cold within a time budget, and the single-device entry step compiles.

The dryrun is run in a SUBPROCESS with a FRESH compile cache so a warm
developer cache can't mask a regression, on four virtual CPU devices; it
must run clean (no f64-truncation UserWarning: x64 is enabled before any
trace) and within a hard budget.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRYRUN_BUDGET_S = 240


@pytest.mark.slow
def test_dryrun_multichip_cold_budget():
    """dryrun_multichip(4) must finish COLD (fresh cache) within budget
    and emit no f64-truncation warnings."""
    code = (
        "import warnings, time\n"
        "warnings.simplefilter('error', UserWarning)\n"
        "t0 = time.time()\n"
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(4)\n"
        "print('DRYRUN_OK %.1f' % (time.time() - t0))\n"
    )
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ)
        env["JAX_COMPILATION_CACHE_DIR"] = cache  # fresh: cold compile
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        proc = subprocess.run(
            [sys.executable, "-c", code],
            cwd=REPO,
            env=env,
            capture_output=True,
            text=True,
            timeout=_DRYRUN_BUDGET_S,
        )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DRYRUN_OK" in proc.stdout, (proc.stdout, proc.stderr[-2000:])


def test_entry_compiles_single_chip():
    """entry() returns a jittable step + args that compile and produce
    finite outputs on the test backend."""
    import jax
    import numpy as np

    from __graft_entry__ import entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    llk, llk0, llk_ab, llk_00 = out
    assert llk.shape[0] == llk_ab.shape[0]
    for t in out:
        assert np.all(np.isfinite(np.asarray(t)))
