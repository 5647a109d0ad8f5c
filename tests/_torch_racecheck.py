"""The port's race-sanitizer fixture, shared by the port's tests.

``torch_racecheck`` yields a fresh ``repro_torch.analysis.racecheck``
``LockRegistry``.  A test wires it into real objects with that module's
``instrument_*`` helpers before it starts any thread, then runs its
threaded scenario; at teardown the fixture fails the test on any
unguarded write or lock-order cycle the registry recorded.  Import it
into a test module (``from _torch_racecheck import torch_racecheck``) to
use it there.  The reference's ``racecheck`` fixture in
``tests/conftest.py`` builds the reference's registry, for the
reference's tests.
"""
import pytest

from repro_torch.analysis.racecheck import LockRegistry


@pytest.fixture
def torch_racecheck():
    """The port's registry; fails the test on any race or cycle."""
    registry = LockRegistry()
    try:
        yield registry
    finally:
        problems = registry.problems()
        registry.close()
        if problems:
            pytest.fail("racecheck: " + "; ".join(problems))
