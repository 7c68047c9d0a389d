"""``Ensemble.predict``'s answers on the card: pinned host memory from
torch's caching host allocator, filled by asynchronous copies.

The file imports no JAX, so it runs on the card machine with
``python -m pytest tests/test_torch_predict_card.py -m card --noconftest -q``
(``tests/conftest.py`` imports JAX); elsewhere its test skips.  The CPU
path's tests are in ``tests/test_torch_eval.py``.
"""

import numpy as np
import pytest
import torch

from mimo_unet_torch.models.ensemble import Ensemble, fetch_counts, fold_in, reset_fetch_counts
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.transforms import compute_uncertainties

H = W = 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.card
def test_answers_are_pinned_bitwise_and_kept(card):
    """Five frames in batches of 2 on the kernel route: the answers are
    bitwise ``.cpu()`` copies of the chunks' forwards, pinned, and counted
    chunk by chunk; a first call's answers, held, survive three later
    calls of the same size, each of which reuses the blocks the one before
    it dropped."""
    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=2,
                        filter_base_count=4, compute_dtype="bfloat16", seed=7)
    ens = Ensemble([(task, task.build_model(device=card))])
    rng = np.random.default_rng(0)
    images = [rng.random((5, H, W, 3), dtype=np.float32) for _ in range(4)]

    reset_fetch_counts()
    first = ens.predict(images[0], batch_size=2)
    nbytes = sum(a.nbytes for a in first)
    assert fetch_counts() == {"pinned": 3, "host": 0, "pinned_bytes": nbytes}
    want = []
    for start in (0, 2, 4):
        chunk = images[0][start:start + 2]
        real = len(chunk)
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], 2 - real, axis=0)])
        p1, p2 = ens.raw_forward(torch.from_numpy(chunk).to(card), fold_in(0, start))
        want.append([t[:real].cpu().numpy() for t in compute_uncertainties(ens.loss_fn, p1, p2)])
    for a, parts in zip(first, zip(*want)):
        assert torch.from_numpy(a).is_pinned()
        assert a.dtype == np.float32 and a.shape == (5, H, W, 1)
        np.testing.assert_array_equal(a, np.concatenate(parts))

    kept = [a.copy() for a in first]
    dropped = None
    for other in images[1:]:
        answers = ens.predict(other, batch_size=2)
        ptrs = {a.ctypes.data for a in answers}
        if dropped is not None:
            assert ptrs == dropped
        dropped = ptrs
        del answers
    for a, b in zip(first, kept):
        np.testing.assert_array_equal(a, b)
