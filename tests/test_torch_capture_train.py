"""The cross-package hold of whole-step train captures: one update
(forward, backward and AdamW) of each of the 4 training configs at batch
4 against ``repro.capture.zoo.get_capture`` (the rules and the named
deviations: ``tests/_torch_capture_hold.py``)."""

import pytest

from _torch_capture_hold import TRAIN, hold


@pytest.mark.parametrize("config,mode,batch", TRAIN,
                         ids=[f"{c}.{m}" for c, m, _ in TRAIN])
def test_hold_against_reference_capture(config, mode, batch):
    hold(config, mode, batch)
