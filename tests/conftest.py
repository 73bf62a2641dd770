"""Lock the jax backend to this container's single CPU device before any
test can import repro.launch.dryrun (which sets the 512-fake-device XLA flag
for the dry-run entry point — that flag must never apply to tests).

Also pins ``REPRO_PROFILE_DIR`` to a non-existent scratch path *before*
repro imports: tier-1 tests assert the cost model's behavior on
``DEFAULT_CONSTANTS``, so a machine profile persisted in the developer's
user cache (``core.profile``) must never leak in and re-rank
``choose_method`` picks under the suite.  Tests that exercise measured
profiles install them explicitly via ``profile.set_profile``/tmp dirs.

Also re-exports the shared ``bit_identical`` CSC-equality helper
(``from conftest import bit_identical``; the single implementation lives
in ``repro.sparse.format.csc_bit_identical``)."""

import os
import tempfile

os.environ.setdefault(
    "REPRO_PROFILE_DIR",
    os.path.join(tempfile.gettempdir(), "repro-test-profiles-unwritten"))
os.environ.pop("REPRO_PROFILE_FILE", None)
os.environ.pop("REPRO_AUTO_CALIBRATE", None)

import jax

from repro.sparse.format import csc_bit_identical as bit_identical  # noqa: F401


def pytest_configure(config):
    jax.devices()  # initializes the backend with the default device count
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA); skipped without one")
