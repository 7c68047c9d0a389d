"""The port's offline evaluation held against the JAX package (CPU).

* ``fgsm_attack`` bitwise.
* ``make_fgsm_fn``, ``make_predictions`` and ``make_predictions_evidential``
  on a tiny dataset (3 images of 32x256 in batches of 2: the last one
  padded), f32 on the plain modules (``ct_kernels="off"``), the same
  weights in both packages: predictions within 2e-4; the perturbed pixels
  equal wherever |grad| exceeds 1e-6 * max|grad| (elsewhere the sign of a
  rounding-level gradient decides, and the two packages may differ); FGSM
  raises the NLL it ascends.
* The curves and ``write_artifacts``: the same arrays through both
  packages' functions give equal ``.npy`` files, ``metrics.pkl`` frames
  and ``.csv`` files within 1e-12.
* ``Ensemble.from_checkpoints``: the port's checkpoint directories and a
  reference ``.ckpt`` in concatenation order, mixed losses and an
  evidential member refused; with MC passes the FGSM gradient and the
  prediction draw the same masks.
* MC serving and evaluation draw each batch's masks from (seed, member,
  batch start): repeated ``predict`` and ``make_predictions`` calls are
  bitwise equal, whatever ran before them.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mimo_unet_tpu.eval import artifacts as jax_artifacts
from mimo_unet_tpu.eval.fgsm import fgsm_attack as jax_fgsm_attack
from mimo_unet_tpu.eval.fgsm import make_fgsm_fn as jax_make_fgsm_fn
from mimo_unet_tpu.models.ensemble import Ensemble as JaxEnsemble
from mimo_unet_tpu.tasks.evidential import EvidentialUnetTask as JaxEvTask
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask, TrainState as JaxState
import mimo_unet_tpu.train.checkpoint as jax_checkpoint

from mimo_unet_torch.data.core import ArrayDataset
from mimo_unet_torch.eval import (
    create_calibration,
    create_precision_recall,
    convert_to_dataframe,
    fgsm_attack,
    make_fgsm_fn,
    make_predictions,
    make_predictions_evidential,
    write_artifacts,
)
from mimo_unet_torch.eval.fgsm import input_gradient
from mimo_unet_torch.models.ensemble import Ensemble
from mimo_unet_torch.tasks import EvidentialUnetTask, MimoUnetTask
from mimo_unet_torch.train import checkpoint
from mimo_unet_torch.transforms import repeat_subnetworks

from test_torch_evidential import EV, ev_weights, port_model
from test_torch_slice import BASE, jax_weights, torch_model

TASK = dict(BASE, loss="laplace_nll", ct_kernels="off")
SEEDS = (0, 1)  # two members


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: torch's intra-op threads cost more than they give,
    most of all beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(seed=3, n=3):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (n, 32, 256, 3)).astype(np.float32)
    return ArrayDataset({"image": image,
                         "label": image.mean(-1, keepdims=True) ** 2})


@pytest.fixture(scope="module")
def ensembles():
    """The JAX Ensemble and the port's over the same two f32 members (the
    JAX one loads them through a stand-in for its checkpoint reader)."""
    members = {f"m{s}": jax_weights(seed=s)[1:] for s in SEEDS}
    jtask = JaxTask(**TASK)

    def load(path, steps_per_epoch=1):
        params, state = members[path]
        return jtask, JaxState(step=0, params=params, model_state=state,
                               opt_state=None, loss_buffer=None)

    real = jax_checkpoint.load_checkpoint
    jax_checkpoint.load_checkpoint = load
    try:
        jens = JaxEnsemble(list(members), return_raw_predictions=True)
    finally:
        jax_checkpoint.load_checkpoint = real
    task = MimoUnetTask(**TASK)
    ens = Ensemble([(task, torch_model(dataclasses.asdict(task.model_config), *m))
                    for m in members.values()], return_raw_predictions=True)
    return jens, ens


def test_fgsm_attack_bitwise_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32) * (rng.uniform(0, 1, x.shape) > 0.3)
    for eps in (0.0, 0.01, 0.04, 0.5):
        want = np.asarray(jax_fgsm_attack(jnp.asarray(x), eps, jnp.asarray(g)))
        got = fgsm_attack(torch.from_numpy(x), eps, torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(got, want)


def _jax_grad(jens, image, label):
    """d NLL / d image through the JAX ensemble (f32 XLA)."""
    label_rep = jax.numpy.repeat(label[:, None], jens.output_width, axis=1)

    def nll(img):
        p1, p2 = jens.raw_forward(img, jax.random.key(0))
        return jens.loss_fn(p1, p2, label_rep)

    return np.asarray(jax.grad(nll)(image))


def _assert_perturbed_equal(got, want, grad):
    strong = np.abs(grad) > 1e-6 * np.abs(grad).max()
    assert strong.mean() > 0.9
    np.testing.assert_array_equal(got[strong], want[strong])


@pytest.mark.parametrize("eps", [0.0, 0.02])
def test_make_fgsm_fn_matches_jax(ensembles, eps):
    jens, ens = ensembles
    batch = _dataset()[np.arange(2)]
    image, label = jnp.asarray(batch["image"]), jnp.asarray(batch["label"])
    x_j, p1_j, p2_j = jax_make_fgsm_fn(jens, eps)(image, label, jax.random.key(0))
    x, p1, p2 = make_fgsm_fn(ens, eps)(torch.from_numpy(batch["image"]),
                                      torch.from_numpy(batch["label"]))
    if eps == 0.0:
        np.testing.assert_array_equal(x.numpy(), batch["image"])
    else:
        _assert_perturbed_equal(x.numpy(), np.asarray(x_j), _jax_grad(jens, image, label))
        assert float(x.min()) >= 0 and float(x.max()) <= 1
    for a, b in ((p1, p1_j), (p2, p2_j)):
        assert tuple(a.shape) == (2, 4, 32, 256, 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=0)


def test_fgsm_raises_the_nll(ensembles):
    """tests/test_eval.py test_epsilon_increases_nll, on the port."""
    _, ens = ensembles
    batch = _dataset()[np.arange(2)]
    image, label = torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"])
    label_rep = repeat_subnetworks(label, ens.output_width)
    nll = {}
    for eps in (0.0, 0.04):
        x, p1, p2 = make_fgsm_fn(ens, eps)(image, label)
        nll[eps] = float(ens.loss_fn(p1, p2, label_rep))
    assert nll[0.04] > nll[0.0], nll


@pytest.mark.parametrize("eps", [0.0, 0.02])
def test_make_predictions_matches_jax(ensembles, eps):
    jens, ens = ensembles
    ds = _dataset()
    want = jax_artifacts.make_predictions(jens, ds, batch_size=2, epsilon=eps)
    got = make_predictions(ens, ds, batch_size=2, epsilon=eps)
    assert len(got) == len(want) == 6
    if eps == 0.0:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        # the last batch as the function runs it: padded with its last row
        grads = [_jax_grad(jens, jnp.asarray(b["image"]), jnp.asarray(b["label"]))
                 for b in (ds[np.arange(2)], ds[np.array([2, 2])])]
        _assert_perturbed_equal(got[0], want[0], np.concatenate(grads)[:3])
    for name, a, b in zip(("y_pred", "y_true", "ale", "epi", "comb"), got[1:], want[1:]):
        assert a.shape == b.shape == (3, 32, 256), name
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("eps", [0.0, 0.02])
def test_make_predictions_evidential_matches_jax(eps):
    _, params, state = ev_weights()
    ds = _dataset(4)
    jtask = JaxEvTask(**EV, ct_kernels="off")
    want = jax_artifacts.make_predictions_evidential(jtask, params, state, ds,
                                                     batch_size=2, epsilon=eps)
    task = EvidentialUnetTask(**EV, ct_kernels="off")
    model = port_model(task, params, state).train()  # run in eval mode anyway
    got = make_predictions_evidential(task, model, ds, batch_size=2, epsilon=eps)
    assert model.training
    if eps == 0.0:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        loss = jtask.loss_fn
        grads = []
        for b in (ds[np.arange(2)], ds[np.array([2, 2])]):  # the last one padded
            def nll(img, lab=jnp.asarray(b["label"])):
                out, _ = jtask.forward(params, state, img, train=False)
                return loss(out, lab, reduce_mean=True)
            grads.append(np.asarray(jax.jit(jax.grad(nll))(jnp.asarray(b["image"]))))
        _assert_perturbed_equal(got[0], want[0], np.concatenate(grads)[:3])
    for name, a, b in zip(("y_pred", "y_true", "ale", "epi", "comb"), got[1:], want[1:]):
        assert a.shape == b.shape == (3, 32, 256), name
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4, err_msg=name)
    assert (got[3] > 0).all() and (got[4] > 0).all()


def _arrays(seed=5, n=(4, 16, 16)):
    rng = np.random.default_rng(seed)
    y_pred, y_true = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    ale, epi = rng.uniform(1e-4, 0.05, n), rng.uniform(0, 0.01, n)
    inputs = rng.uniform(0, 1, n + (3,))
    return tuple(a.astype(np.float32) for a in (inputs, y_pred, y_true, ale, epi, ale + epi))


@pytest.mark.parametrize("subsample", [None, 0.5])
def test_curves_match_jax(subsample):
    arrays = _arrays()
    df = convert_to_dataframe(*arrays[1:])
    df_j = jax_artifacts.convert_to_dataframe(*arrays[1:])
    pd.testing.assert_frame_equal(df, df_j)
    pd.testing.assert_frame_equal(create_precision_recall(df),
                                  jax_artifacts.create_precision_recall(df_j),
                                  check_exact=False, rtol=1e-12, atol=1e-12)
    pd.testing.assert_frame_equal(create_calibration(df, subsample=subsample),
                                  jax_artifacts.create_calibration(df_j, subsample=subsample),
                                  check_exact=False, rtol=1e-12, atol=1e-12)


def test_write_artifacts_matches_jax(tmp_path):
    arrays = _arrays(6)
    got = write_artifacts(str(tmp_path / "port"), "nyuv2", 0.02, arrays)
    want = jax_artifacts.write_artifacts(str(tmp_path / "jax"), "nyuv2", 0.02, arrays)
    assert got.keys() == want.keys() and len(got) == 8
    for suffix in got:
        assert os.path.basename(got[suffix]) == os.path.basename(want[suffix])
        if suffix.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got[suffix]), np.load(want[suffix]))
        elif suffix.endswith(".pkl"):
            pd.testing.assert_frame_equal(pd.read_pickle(got[suffix]),
                                          pd.read_pickle(want[suffix]))
        else:
            a, b = pd.read_csv(got[suffix]), pd.read_csv(want[suffix])
            assert list(a.columns) == list(b.columns)
            np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=0, atol=1e-12)


# ------------------------------------------------------------------ the port

SMALL = dict(in_channels=3, out_channels=2, filter_base_count=4, ct_kernels="off")


def _saved(tmp_path, name, task):
    path = str(tmp_path / name)
    checkpoint.save_checkpoint(path, task.init_state(1, "cpu"), task.hparams())
    return path


def test_ensemble_from_checkpoints_in_order(tmp_path):
    """Two port checkpoints and a reference .ckpt (Lightning's 'model.'
    prefix), loaded in order: the raw predictions are the members' own,
    concatenated in that order."""
    tasks = [MimoUnetTask(**SMALL, num_subnetworks=2, seed=1),
             MimoUnetTask(**SMALL, num_subnetworks=1, seed=2),
             MimoUnetTask(**SMALL, num_subnetworks=2, seed=3)]
    paths = [_saved(tmp_path, "a", tasks[0]), _saved(tmp_path, "b", tasks[1])]
    ref = tasks[2].build_model("cpu")
    paths.append(str(tmp_path / "ref.ckpt"))
    torch.save({"state_dict": {f"model.{k}": v for k, v in ref.state_dict().items()},
                "hyper_parameters": dataclasses.asdict(tasks[2])}, paths[-1])
    ens = Ensemble.from_checkpoints(paths, return_raw_predictions=True, device="cpu")
    assert [t for t, _ in ens.members] == tasks and ens.output_width == 5
    image = torch.from_numpy(_dataset()[np.arange(2)]["image"][:, :32, :32])
    p1, p2 = ens(image)
    want = [Ensemble([(t, m)], return_raw_predictions=True)(image)
            for t, m in zip(tasks, [tasks[0].build_model("cpu"), tasks[1].build_model("cpu"),
                                    ref])]
    torch.testing.assert_close(p1, torch.cat([w[0] for w in want], 1), rtol=0, atol=0)
    torch.testing.assert_close(p2, torch.cat([w[1] for w in want], 1), rtol=0, atol=0)


def test_ensemble_from_checkpoints_refuses(tmp_path):
    a = _saved(tmp_path, "a", MimoUnetTask(**SMALL, num_subnetworks=1))
    b = _saved(tmp_path, "b", MimoUnetTask(**SMALL, num_subnetworks=1, loss="gaussian_nll"))
    with pytest.raises(ValueError, match="loss"):
        Ensemble.from_checkpoints([a, b], device="cpu")
    ev = _saved(tmp_path, "ev", EvidentialUnetTask(in_channels=3, filter_base_count=4))
    with pytest.raises(ValueError, match="loss"):
        Ensemble.from_checkpoints([a, ev], device="cpu")
    with pytest.raises(ValueError, match="evidential"):
        Ensemble.from_checkpoints([ev], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        Ensemble.from_checkpoints([], device="cpu")


def _mc_ensemble(members=1, **kw):
    """An MC ensemble of ``members`` small members with live decoder
    dropout, two passes each."""
    tasks = [MimoUnetTask(**SMALL, num_subnetworks=2, decoder_dropout_rate=0.3,
                          seed=10 + m) for m in range(members)]
    return Ensemble([(t, t.build_model("cpu")) for t in tasks], monte_carlo_steps=2,
                    return_raw_predictions=True, **kw)


def _small_batch(n=2):
    batch = _dataset(n=n)[np.arange(n)]
    return (torch.from_numpy(batch["image"][:, :32, :32]),
            torch.from_numpy(batch["label"][:, :32, :32]))


def test_fgsm_with_mc_passes_shares_the_masks():
    """With MC passes, the prediction on the perturbed input draws the
    masks the gradient drew: it equals a raw forward of the perturbed
    input with the same seed.  An ensemble given its own generator is set
    back between the two: the prediction equals a raw forward from the
    generator state the attack started from, and the generator ends where
    that forward leaves it."""
    ens = _mc_ensemble()
    image, label = _small_batch()
    x, p1, _ = make_fgsm_fn(ens, 0.02)(image, label, 7)
    assert not torch.equal(x, image)
    q1, _ = ens.raw_forward(x, 7)
    torch.testing.assert_close(p1, q1, rtol=0, atol=0)
    # the masks are live: another seed moves the predictions
    assert not torch.equal(ens.raw_forward(x, 8)[0], q1)

    own = _mc_ensemble(generator=torch.Generator().manual_seed(3))
    start = own.generator.get_state()
    x, p1, _ = make_fgsm_fn(own, 0.02)(image, label)
    end = own.generator.get_state()
    own.generator.set_state(start)
    q1, _ = own.raw_forward(x)
    torch.testing.assert_close(p1, q1, rtol=0, atol=0)
    assert torch.equal(own.generator.get_state(), end)
    assert not torch.equal(own.raw_forward(x)[0], q1)


def test_mc_predict_is_a_function_of_its_inputs():
    """Two MC ``predict`` calls on the same images are bitwise equal,
    whatever ran between them and in a fresh ensemble over the same
    members; the batch at ``start`` is the ensemble's answer to that batch
    alone with seed ``fold_in(seed, start)``; another seed moves it."""
    from mimo_unet_torch.models.ensemble import fold_in

    ens = _mc_ensemble(members=2)
    images = np.random.default_rng(9).uniform(0, 1, (5, 32, 32, 3)).astype(np.float32)
    first = ens.predict(images, batch_size=2)
    ens.predict(images[::-1].copy(), batch_size=2)
    ens.raw_forward(torch.from_numpy(images[:2]))
    again = ens.predict(images, batch_size=2)
    fresh = Ensemble(ens.members, monte_carlo_steps=2).predict(images, batch_size=2)
    alone = Ensemble(ens.members, monte_carlo_steps=2)(torch.from_numpy(images[2:4]),
                                                      fold_in(0, 2))
    for a, b, c, d in zip(first, again, fresh, alone):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a[2:4], d.numpy())
    other = ens.predict(images, batch_size=2, seed=1)
    assert not np.array_equal(other[0], first[0])


@pytest.mark.parametrize("eps", [0.0, 0.01])
def test_make_predictions_draws_each_batch_from_its_start(eps):
    """Two MC ``make_predictions`` calls are bitwise equal, and each batch
    draws the masks of ``fold_in(seed, start)``, at eps 0 as at eps 0.01:
    the predictions are the raw forwards of the returned inputs with those
    seeds, so both epsilons of a sweep see the same masks for a batch."""
    from mimo_unet_torch.models.ensemble import fold_in

    ens = _mc_ensemble(members=2)
    image, label = _small_batch(4)
    ds = ArrayDataset({"image": image.numpy(), "label": label.numpy()})
    got = make_predictions(ens, ds, batch_size=2, epsilon=eps)
    again = make_predictions(ens, ds, batch_size=2, epsilon=eps)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    if eps == 0.0:
        np.testing.assert_array_equal(got[0], image.numpy())
    p1 = torch.cat([ens.raw_forward(torch.from_numpy(got[0][s:s + 2]), fold_in(0, s))[0]
                    for s in (0, 2)]).numpy()
    np.testing.assert_array_equal(got[1], p1.clip(0, 1).mean(axis=1)[..., 0])
    other = make_predictions(ens, ds, batch_size=2, epsilon=eps, seed=1)
    assert not np.array_equal(other[1], got[1])


def test_input_gradient_runs_the_plain_modules_under_no_grad():
    """An FGSM gradient taken inside ``torch.no_grad`` (as ``predict``
    runs) still flows, through the plain modules."""
    task = MimoUnetTask(**SMALL, num_subnetworks=1)
    ens = Ensemble([(task, task.build_model("cpu"))], return_raw_predictions=True)
    image = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    label = torch.rand(1, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        g = input_gradient(lambda x: ens.loss_fn(*ens.raw_forward_grad(x),
                                                 repeat_subnetworks(label, 1)), image)
    assert g.shape == image.shape and float(g.abs().max()) > 0
