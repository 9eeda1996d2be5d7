"""Test configuration: run everything on a virtual 8-device CPU mesh.

This is the idiomatic JAX stand-in for several accelerators (SURVEY.md §4):
sharding semantics, collectives, and mesh layouts compile and execute
identically on virtual CPU devices.

The suite forces the CPU backend, whatever the machine holds, before any
backend is used.  ``CPX_TEST_ON_CARD=1`` leaves the backend alone instead:
``chip_smoke.py`` sets it when it runs the ``gpu``-marked tests on the card.
"""

import os

if os.environ.get("CPX_TEST_ON_CARD") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()
