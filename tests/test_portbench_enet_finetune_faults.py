"""Each fault planted in the port's fine-tune step drives a run of the
benchmark's ``enet_finetune.clip_steps`` cell to ``correct`` false, on the
CPU at slim sizes through ``run.execute`` (as
``test_portbench_enet_finetune.py`` runs the sound cell): the perceptual
or the identity term reported but left out of the loss, each step on half
of its batch, and a frozen leaf trained beside the style convs. The faults
are ``portbench/calibrate_finetune.py``'s own (``planted``), which reads
them on the card."""

from __future__ import annotations

import pytest

from portbench.calibrate_finetune import planted
from test_portbench_enet_finetune import limits, run_cell, values
from torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("kind", ["fault_no_perceptual", "fault_no_identity", "fault_half_batch",
                                  "fault_frozen_trained"],
                         ids=["no_perceptual", "no_identity", "half_batch", "frozen_trained"])
def test_a_faulty_step_is_not_correct(kind, tmp_path, monkeypatch):
    with planted(kind):
        out = run_cell(tmp_path, monkeypatch)
    v, lim = values(out), limits()
    assert not out["correct"]
    assert any(v[k] > lim[k] for k in v), v
