"""The driver entry points in ``__graft_entry__.py``."""

import os
import sys

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as g  # noqa: E402
from jax_spmv.ops import spmv_cpu_csr  # noqa: E402


def test_entry_is_jittable_and_correct():
    fn, args = g.entry()
    y = np.asarray(jax.jit(fn)(*args))
    csr, _ = g._demo_csr()
    ref = spmv_cpu_csr(csr, np.asarray(args[-1]))
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)


def test_dryrun_multichip_checks_against_oracle():
    g.dryrun_multichip(min(4, len(jax.devices())))
