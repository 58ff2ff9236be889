"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests and benches must see
the single real CPU device (the 512-device placeholder count is set only
inside launch/dryrun.py)."""
import jax
import pytest

from repro.configs import get_config
from repro.models.model import LM

# Lock the backend to the single real CPU device BEFORE any test module
# imports repro.launch.dryrun (which sets the 512-placeholder XLA_FLAGS
# for its own __main__ use; once the backend is initialised the flag is
# inert for this process).
assert len(jax.devices()) >= 1


@pytest.fixture(scope="session")
def slm():
    cfg = get_config("floe-slm-2b").reduced()
    lm = LM(cfg, remat=False)
    params = lm.init(jax.random.key(0))
    return lm, params


@pytest.fixture(scope="session")
def llm():
    cfg = get_config("floe-llm-7b").reduced()
    lm = LM(cfg, remat=False)
    params = lm.init(jax.random.key(1))
    return lm, params


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU and nvcc (skips without them)")
