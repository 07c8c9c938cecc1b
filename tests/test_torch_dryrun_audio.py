"""The dry run (``repro_torch/launch/dryrun.py``) of the audio family's
training cell: whisper-small reduced to one encoder and one decoder layer,
a batch of 8 x 32 in Q = 2 micro-batches, on a (data 2 x model 2) fake
mesh: every record key of the reference's present and every number
finite (the other families' cells are in ``test_torch_dryrun.py``)."""

import pytest
import torch

from test_torch_dryrun import _check_record, trace


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_audio_training_cell_traces():
    rec = trace("whisper-small", "train_4k", (2, 2), num_layers=1,
                encoder_layers=1)
    _check_record(rec)
    assert rec["kind"] == "train" and rec["devices"] == 4
