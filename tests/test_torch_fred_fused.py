"""The port's fused FRED path (K-event windows) against a live run of the
JAX reference: the one-kernel path in both kernel modes, the materialized
reductions with the kernel off, the gradient cache under gating, and the
round-robin dispatcher.  Same method and tolerances as test_torch_fred.py,
whose helpers this file uses."""
import pytest

from test_torch_fred import (check_against_reference, one_thread,  # noqa: F401
                             setup)

FUSED = dict(num_clients=16, batch_size=8, seed=3, events_per_step=8,
             apply_mode="fused")
CASES = {
    "fasgd_fused_kernel": dict(
        sim=FUSED, server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True)),
    "fasgd_fused_plain": dict(
        sim=FUSED, server=dict(rule="fasgd", lr=0.01)),
    "fasgd_fused_gated_cache": dict(
        sim=dict(FUSED, seed=7),
        server=dict(rule="fasgd", lr=0.01, use_fused_kernel=True),
        bandwidth=dict(c_push=2.0, c_fetch=2.0, drop_policy="cache")),
    "sasgd_fused_kernel_roundrobin": dict(
        sim=dict(FUSED, dispatcher="roundrobin"),
        server=dict(rule="sasgd", lr=0.05, use_fused_kernel=True)),
    "sasgd_fused_materialized": dict(
        sim=dict(FUSED, fused_mode="materialized"),
        server=dict(rule="sasgd", lr=0.05)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_run_simulation_matches_reference(setup, name):  # noqa: F811
    check_against_reference(setup, name, CASES[name])
