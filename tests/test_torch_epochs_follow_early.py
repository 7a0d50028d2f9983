"""Phase 11's follower on the plain path, epochs 2-13 of
``chip_smoke.epoch_changes`` on ``map_tree3`` (the follower applies every
delta; ``map_all`` is held to both packages' scalar pipeline at these
epochs).  See ``test_torch_epochs.follow``; the plain walk takes 0.2-0.5
s a ``map_all`` on the CPU, so the 24 epochs are split over two files."""

import pytest

import test_torch_epochs as te
from test_torch_epochs import _port_gates  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def stream():
    return te.run_epochs("map_tree3")


def test_follower_keeps_refreshes_rebuilds(stream):
    first, epochs = stream
    assert te.follow(epochs, first, range(2, 14)) == \
        {"reuse", "refresh", "rebuild"}
