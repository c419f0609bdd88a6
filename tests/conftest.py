"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so the multi-chip
sharding paths compile and execute without TPU hardware (the driver
separately dry-runs them; see __graft_entry__.py).  Set MOIP_TEST_TPU=1 to
run against the real device instead.
"""

import os

if not os.environ.get("MOIP_TEST_TPU"):
    os.environ.setdefault(
        "XLA_FLAGS",
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
else:  # pragma: no cover
    import jax

jax.config.update("jax_enable_x64", True)

import pytest

# pin the general AIRA engine: the knapsack-DP shortcut (solver/kp_front.py)
# would otherwise absorb every KP-family golden test and silently drop the
# engine coverage.  DP-path tests opt back in with solve_front(dp="on").
os.environ.setdefault("MOIP_DP", "off")

EXAMPLES = "/root/reference/Examples"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running golden tests (set MOIP_RUN_SLOW=1)"
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() "
        "is False",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("MOIP_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow golden test; set MOIP_RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
