"""The port's regression metrics (``mimo_unet_torch/metrics.py``) held
against the JAX package's (``mimo_unet_tpu/metrics.py``) on the CPU.

The five public functions take ``(y_hat, y, weights=None)`` as the JAX
package's and the reference's (mimo/metrics.py:7-19) do, called directly
and through ``get_metric``, without weights and with 0/1 weights that keep
padded rows out, at docs/PARITY.md's 2e-4.  ``compute_regression_metrics``
(weighted sums through a reduction over ranks) is held to the same
functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_unet_tpu import metrics as jax_metrics

from mimo_unet_torch import metrics

NAMES = ("mae", "mse", "rmse", "r2", "mape")
FUNCTIONS = {"mae": "mean_absolute_error", "mse": "mean_squared_error",
             "rmse": "root_mean_squared_error", "r2": "r2_score",
             "mape": "mean_absolute_percentage_error"}


def _inputs(weighted: bool):
    """(y_hat, y, weights or None) flattened, as ``compute_regression_metrics``
    passes them: 4 rows of 6x5, the last row padded (weight 0) and far off."""
    rng = np.random.default_rng(0)
    y = rng.uniform(0.1, 1.0, (4, 6, 5)).astype(np.float32)
    y_hat = (y + rng.normal(0, 0.2, y.shape)).astype(np.float32)
    y_hat[3] += 50.0
    if not weighted:
        return y_hat.reshape(-1), y.reshape(-1), None
    w = np.broadcast_to(np.array([1, 1, 1, 0], np.float32)[:, None, None], y.shape)
    return y_hat.reshape(-1), y.reshape(-1), np.ascontiguousarray(w).reshape(-1)


def _jax(name, y_hat, y, w):
    return float(jax_metrics.get_metric(name)(
        jnp.asarray(y_hat), jnp.asarray(y), None if w is None else jnp.asarray(w)))


def _port(fn, y_hat, y, w):
    args = [torch.from_numpy(y_hat), torch.from_numpy(y)]
    if w is not None:
        args.append(torch.from_numpy(w))
    return float(fn(*args))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", NAMES)
def test_get_metric_matches_jax(name, weighted):
    y_hat, y, w = _inputs(weighted)
    np.testing.assert_allclose(_port(metrics.get_metric(name), y_hat, y, w),
                               _jax(name, y_hat, y, w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", NAMES)
def test_public_function_matches_jax(name, weighted):
    y_hat, y, w = _inputs(weighted)
    fn = getattr(metrics, FUNCTIONS[name])
    assert metrics.get_metric(name) is fn
    np.testing.assert_allclose(_port(fn, y_hat, y, w), _jax(name, y_hat, y, w),
                               rtol=2e-4, atol=2e-4)


def test_weights_keep_padded_rows_out():
    y_hat, y, w = _inputs(True)
    kept = w > 0
    for name in NAMES:
        fn = metrics.get_metric(name)
        np.testing.assert_allclose(_port(fn, y_hat, y, w), _port(fn, y_hat[kept], y[kept], None),
                                   rtol=1e-5)


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="Unknown metric: mad"):
        metrics.get_metric("mad")
    with pytest.raises(ValueError, match="Unknown metric: mad"):
        metrics.compute_regression_metrics(torch.zeros(3), torch.ones(3), metrics=["mad"])


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_compute_regression_metrics_matches_the_functions(weighted):
    """The sums-based table gives the five functions' values, and the JAX
    package's ``compute_regression_metrics``; the default names are r2,
    mae, mse, rmse."""
    y_hat, y, w = _inputs(weighted)
    shape = (4, 6, 5)
    t_w = None if w is None else torch.from_numpy(w.reshape(shape)[:, :1, :1].copy())
    got = metrics.compute_regression_metrics(
        torch.from_numpy(y_hat.reshape(shape)), torch.from_numpy(y.reshape(shape)),
        metrics=list(NAMES), weights=t_w)
    want = jax_metrics.compute_regression_metrics(
        jnp.asarray(y_hat.reshape(shape)), jnp.asarray(y.reshape(shape)), metrics=list(NAMES),
        weights=None if t_w is None else jnp.asarray(t_w.numpy()))
    for name in NAMES:
        np.testing.assert_allclose(float(got[name]), _port(metrics.get_metric(name), y_hat, y, w),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=2e-4, atol=2e-4)
    assert list(metrics.compute_regression_metrics(torch.ones(3), torch.ones(3))) == [
        "r2", "mae", "mse", "rmse"]
