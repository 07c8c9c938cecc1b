"""The port's trainer (``repro_torch.launch.train``) on the CPU.

* The counterpart of ``tests/test_system.py::test_lm_trainer_loss_decreases``
  with the same call and assertion: the mean loss of the last 4 of 16 steps
  is below that of the first 4.
* A restart: a run that checkpoints (asynchronously every 2 steps, and at
  its end) and a relaunch that restores the latest checkpoint resume at the
  saved step and give the same losses, bit for bit, as one uninterrupted
  run (the data stream resumes at the restored step too).
* ``token_lm_batches`` is bit-equal to the reference's for the same seed.
"""

import numpy as np
import pytest
import torch

from repro.data import token_lm_batches as r_batches

from repro_torch.checkpoint import latest_step
from repro_torch.data import token_lm_batches
from repro_torch.launch.train import main, train


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the reduced model's small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lm_trainer_loss_decreases():
    losses = train("qwen3-0.6b", reduced=True, steps=16, batch=16, seq=32,
                   microbatches=4, lr=2e-3, log_every=100, device="cpu")
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_restart_resumes_at_the_saved_step_with_the_same_losses(arch,
                                                                tmp_path):
    kw = dict(reduced=True, batch=4, seq=16, microbatches=2, lr=2e-3,
              log_every=100, device="cpu")
    whole = train(arch, steps=6, **kw)
    first = train(arch, steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert latest_step(str(tmp_path)) == 3
    rest = train(arch, steps=6, ckpt_dir=str(tmp_path), **kw)
    assert len(rest) == 2 and latest_step(str(tmp_path)) == 5
    assert first + rest == whole


def test_main_runs_on_the_cpu(capsys):
    main(["--steps", "2", "--batch", "4", "--seq", "8", "--microbatches",
          "2", "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("seed", [0, 5])
def test_token_lm_batches_equal_reference(seed):
    got = token_lm_batches(batch=3, seq_len=20, vocab=97, seed=seed)
    want = r_batches(batch=3, seq_len=20, vocab=97, seed=seed)
    for _ in range(3):
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
