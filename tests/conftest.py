import os

# Tests run on a virtual 8-device CPU mesh unless JAX_PLATFORMS says
# otherwise (the card's own tests: ``JAX_PLATFORMS=cuda pytest -m gpu``).
# Must be set before jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless JAX's default backend is a GPU.
    Decided here, at run time, never while test modules are imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run with JAX_PLATFORMS=cuda "
                    "pytest -m gpu)")


@pytest.fixture(autouse=True)
def _isolate_cwd(tmp_path, monkeypatch):
    """Run every test from a scratch cwd so writers with the default
    ``work_dir='.'`` (reference parity: the Fortran code writes to cwd)
    never litter the repo root with fit_*/chi2fit_* output files."""
    monkeypatch.chdir(tmp_path)
    yield
