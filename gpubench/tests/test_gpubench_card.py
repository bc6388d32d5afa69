"""On the card: a short run of the one-card cell, correct, with its
metrics on the card's name.  Skips where no card is visible."""

import pytest

from gpubench import run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    import xrspatial_torch as xt
    xt.set_default_device("cuda")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(card):
    r = run.run("dem16k-terrain", 2 ** 33 + 17, 1.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["kind"] == card
    assert r["metrics"]["mpix_s"]["value"] > 0
