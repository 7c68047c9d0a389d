"""The port's data layer held against the JAX package (CPU).

* The loaders (``mimo_unet_torch/data/{nyuv2,sen12tp,make3d,muad}.py``)
  on the same synthetic real-schema files, written here: every array
  bitwise the JAX loader's (an NYUv2 h5 at float32 and uint8 staging, and
  the lossy sources the uint8 staging refuses; SEN12TP tiles as ``.npz``,
  ``.npy`` and ``.tif`` with ``bands.json``; Make3D; MUAD), the data
  modules' splits and batches, and their CLI flags.
* The native host gather (``data/_native``) against numpy, and the path
  that served each gather, counted.
* ``DeviceDataset.gather`` on ``device="cpu"`` bitwise the JAX
  ``DeviceDataset.gather``; ``PartialDeviceDataset.epoch_batches`` the
  JAX stream element for element over two epochs.
* ``Trainer.fit(device_cache=True)`` bitwise the host-fed fit over two
  epochs (both draw the same permutation); past its budget the partial
  cache feeds cached and host batches and visits every row once an
  epoch.

``import mimo_unet_torch`` and its data modules import no file reader
(h5py, cv2, imageio) and no JAX.  No JAX ``Trainer.fit`` runs here.
"""

import argparse
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from make_fixtures import make_make3d, make_muad, make_nyuv2_h5, make_sen12tp_tiles

from mimo_unet_tpu.data import core as jax_core
from mimo_unet_tpu.data import make3d as jax_make3d
from mimo_unet_tpu.data import muad as jax_muad
from mimo_unet_tpu.data import nyuv2 as jax_nyuv2
from mimo_unet_tpu.data import sen12tp as jax_sen12tp

from mimo_unet_torch.data import _native, core, make3d, muad, nyuv2, sen12tp
from mimo_unet_torch.tasks.mimo import MimoUnetTask
from mimo_unet_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: torch's intra-op threads cost more than they give,
    most of all beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    """Two datasets (or batch dicts) with the same keys and bitwise equal
    arrays of the same dtype."""
    got = got.data if hasattr(got, "data") else got
    want = want.data if hasattr(want, "data") else want
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_import_needs_no_file_readers():
    code = (
        "import importlib, sys\n"
        "for m in ('mimo_unet_torch', 'mimo_unet_torch.data', 'mimo_unet_torch.data.nyuv2',\n"
        "          'mimo_unet_torch.data.sen12tp', 'mimo_unet_torch.data.make3d',\n"
        "          'mimo_unet_torch.data.muad', 'mimo_unet_torch.data._native',\n"
        "          'mimo_unet_torch.train.trainer'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('h5py', 'cv2', 'imageio', 'jax', 'mimo_unet_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ NYUv2

@pytest.fixture(scope="module")
def nyu_dir(tmp_path_factory):
    return make_nyuv2_h5(str(tmp_path_factory.mktemp("nyu")), n=10, h=16, w=24)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(normalize=False),
    dict(host_dtype="uint8"),
    dict(shuffle_on_load=True, seed=3),
    dict(use_fraction=0.5, seed=0),
    dict(use_fraction=0.7, shuffle_on_load=True, seed=1, host_dtype="uint8"),
])
def test_nyuv2_loader_matches_jax(nyu_dir, kw):
    path = os.path.join(nyu_dir, "depth_train.h5")
    _same(nyuv2.load_nyuv2_depth(path, **kw), jax_nyuv2.load_nyuv2_depth(path, **kw))


def test_nyuv2_uint8_staging_refuses_lossy_sources(tmp_path):
    """Float or wide-integer h5 data is refused, with the JAX loader's
    messages, not truncated."""
    import h5py

    path = str(tmp_path / "depth_train.h5")
    rng = np.random.default_rng(0)
    sources = [
        (rng.random((2, 8, 8, 3)).astype(np.float32),
         rng.random((2, 8, 8, 1)).astype(np.float32), "integer"),
        (rng.integers(0, 1000, (2, 8, 8, 3)).astype(np.uint16),
         rng.integers(0, 255, (2, 8, 8, 1), dtype=np.uint8), r"\[0, 255\]"),
        (rng.integers(0, 255, (2, 8, 8, 3), dtype=np.uint8), None, "implies"),
    ]
    msgs = []
    for image, depth, match in sources:
        with h5py.File(path, "w") as f:
            f.create_dataset("image", data=image)
            f.create_dataset("depth", data=image[..., :1] if depth is None else depth)
        kw = dict(host_dtype="uint8", normalize=depth is not None)
        for load in (nyuv2.load_nyuv2_depth, jax_nyuv2.load_nyuv2_depth):
            with pytest.raises(ValueError, match=match) as err:
                load(path, **kw)
            msgs.append(str(err.value))
    assert msgs[0::2] == msgs[1::2]


def test_nyuv2_datamodule_matches_jax(nyu_dir):
    parsed = []
    for mod in (nyuv2, jax_nyuv2):
        parser = mod.NYUv2DepthDataModule.add_model_specific_args(argparse.ArgumentParser())
        parsed.append(parser.parse_args(["--dataset_dir", nyu_dir, "--batch_size", "4",
                                         "--train_dataset_fraction", "0.8",
                                         "--host_dtype", "uint8"]))
    assert vars(parsed[0]) == vars(parsed[1])
    parsed[0].seed = parsed[1].seed = 2
    dms = [mod.NYUv2DepthDataModule.from_args(a) for mod, a in zip((nyuv2, jax_nyuv2), parsed)]
    for dm in dms:
        dm.setup()
    got, want = dms
    for split in ("train_dataset", "val_dataset", "test_dataset"):
        _same(getattr(got, split)(), getattr(want, split)())
    a, b = list(got.train_batches(1, seed=5)), list(want.train_batches(1, seed=5))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        _same(x, y)


# ---------------------------------------------------------------- SEN12TP

def _tiles(root, container):
    """Two 96x96 SEN12TP tiles in ``container`` (npz, npy or tif; the last
    two with ``bands.json``), under ``root/train`` and ``root/val``."""
    make_sen12tp_tiles(root, n_tiles=2, size=96, seed=4)
    if container == "npz":
        return root
    for split in ("train", "val"):
        d = os.path.join(root, split)
        for f in sorted(os.listdir(d)):
            with np.load(os.path.join(d, f)) as z:
                names = list(z.files)
                arr = np.stack([z[k] for k in names], axis=-1)
            os.remove(os.path.join(d, f))
            stem = os.path.join(d, f[:-len(".npz")])
            if container == "npy":
                np.save(stem + ".npy", arr)
            else:
                import imageio.v3 as iio

                iio.imwrite(stem + ".tif", arr)
        with open(os.path.join(d, "bands.json"), "w") as fh:
            json.dump(names, fh)
    return root


@pytest.mark.parametrize("container", ["npz", "npy", "tif"])
def test_sen12tp_matches_jax(tmp_path, container):
    root = _tiles(str(tmp_path), container)
    train = os.path.join(root, "train")
    first = os.path.join(train, sorted(f for f in os.listdir(train) if f != "bands.json")[0])
    _same(sen12tp._load_tile(first), jax_sen12tp._load_tile(first))
    for patch, kw in (((32, 32), dict(stride=30)),
                      ((48, 40), dict(stride=25, model_inputs=["VV_sigma0", "VH_sigma0", "B02"],
                                      model_targets=["NDVI", "EVI"]))):
        clip = "model_targets" in kw
        got = sen12tp.Sen12tpDataset(
            train, patch_size=sen12tp.Patchsize(*patch),
            clip_transform=sen12tp.default_clipping_transform if clip else None, **kw)
        want = jax_sen12tp.Sen12tpDataset(
            train, patch_size=jax_sen12tp.Patchsize(*patch),
            clip_transform=jax_sen12tp.default_clipping_transform if clip else None, **kw)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.index, want.index)
        idx = np.random.default_rng(0).permutation(len(got))
        _same(got[idx], want[idx])
        _same(got[3], want[3])
    assert sen12tp.CLIP_RANGES == jax_sen12tp.CLIP_RANGES
    assert sen12tp.MINMAX_RANGES == jax_sen12tp.MINMAX_RANGES
    np.testing.assert_array_equal(sen12tp.window_positions(2000, 256, 249),
                                  jax_sen12tp.window_positions(2000, 256, 249))


def test_sen12tp_transforms_match_jax():
    rng = np.random.default_rng(1)
    raw = {k: rng.uniform(-50, 12000, (6, 5)).astype(np.float32)
           for k in ("VV_sigma0", "VH_sigma0", "B02", "B04", "B05", "B08", "B11", "dem")}
    _same(sen12tp.default_clipping_transform(raw), jax_sen12tp.default_clipping_transform(raw))
    _same(sen12tp.min_max_transform(raw), jax_sen12tp.min_max_transform(raw))
    wanted = ["VV_sigma0", "NDVI", "NDRE", "NDWI_GAO", "EVI"]
    _same(sen12tp.compute_bands(raw, wanted, clip_transform=sen12tp.default_clipping_transform),
          jax_sen12tp.compute_bands(raw, wanted,
                                    clip_transform=jax_sen12tp.default_clipping_transform))
    with pytest.raises(KeyError, match="not in tile"):
        sen12tp.compute_bands(raw, ["B99"])
    with pytest.raises(ValueError, match="unsupported"):
        sen12tp._load_tile("tile.jp2")


def test_sen12tp_datamodule_matches_jax(tmp_path):
    root = _tiles(str(tmp_path), "npz")
    argv = ["--dataset_dir", root, "--batch_size", "4", "--patch_size", "32", "--stride",
            "30", "-i", "VV_sigma0", "-i", "VH_sigma0", "-t", "NDVI",
            "--training_set_percentage", "0.5"]
    dms = []
    for mod in (sen12tp, jax_sen12tp):
        args = mod.add_datamodule_args(argparse.ArgumentParser()).parse_args(argv)
        dms.append(mod.get_datamodule(args))
    got, want = dms
    assert got.model_inputs == want.model_inputs == ["VV_sigma0", "VH_sigma0"]
    assert len(got.train_dataset()) == len(want.train_dataset()) == 9
    assert len(got.val_dataset()) == len(want.val_dataset()) == 18
    assert got.test_dataset() is None and want.test_dataset() is None
    for x, y in zip(got.train_batches(0, seed=1), want.train_batches(0, seed=1)):
        _same(x, y)


# ---------------------------------------------------------- Make3D and MUAD

@pytest.mark.parametrize("kw", [dict(), dict(with_mask=False, normalize=False),
                                dict(shuffle_on_load=True, use_fraction=0.5, seed=2)])
def test_make3d_matches_jax(tmp_path_factory, kw):
    root = make_make3d(str(tmp_path_factory.mktemp("make3d")), n=3, splits=("train", "test"))
    path = os.path.join(root, "train")
    _same(make3d.load_make3d_depth(path, **kw), jax_make3d.load_make3d_depth(path, **kw))
    if not kw:
        dms = [mod.Make3dDepthDataModule(dataset_dir=root, batch_size=2, seed=0)
               for mod in (make3d, jax_make3d)]
        for dm in dms:
            dm.setup()
        for split in ("train_dataset", "val_dataset", "test_dataset"):
            _same(getattr(dms[0], split)(), getattr(dms[1], split)())
        parsed = [vars(mod.Make3dDepthDataModule.add_model_specific_args(
            argparse.ArgumentParser()).parse_args(["--dataset_dir", root]))
            for mod in (make3d, jax_make3d)]
        assert parsed[0] == parsed[1]


def test_muad_matches_jax(tmp_path):
    import imageio.v3 as iio

    root = make_muad(str(tmp_path), n=3, size=24, splits=("train", "val"))
    rng = np.random.default_rng(5)
    seg = os.path.join(root, "train", "leftLabel")
    os.makedirs(seg)
    for i in range(3):
        iio.imwrite(os.path.join(seg, f"{i:05d}_leftLabel.png"),
                    rng.integers(0, 19, (24, 24), dtype=np.uint8))
    train = os.path.join(root, "train")
    for kw in (dict(), dict(dsize=(16, 12), shuffle_on_load=True, seed=1),
               dict(normalize=False)):
        _same(muad.load_muad_depth(train, **kw), jax_muad.load_muad_depth(train, **kw))
        _same(muad.load_muad_segmentation(train, **kw),
              jax_muad.load_muad_segmentation(train, **kw))
    dms = [mod.MUADDepthDataModule(dataset_dir=root, batch_size=2, dsize=(16, 16), seed=0)
           for mod in (muad, jax_muad)]
    for dm in dms:
        dm.setup()
    for split in ("train_dataset", "val_dataset"):
        _same(getattr(dms[0], split)(), getattr(dms[1], split)())
    assert dms[0].test_dataset() is None
    depth = np.array([[0.5, np.inf], [np.nan, 0.25]], np.float32)
    for a, b in zip(muad.fix_scaled_depth_map(depth), jax_muad.fix_scaled_depth_map(depth)):
        np.testing.assert_array_equal(a, b)
    assert muad.get_filename_id("00042_leftImg8bit.png") == 42
    with pytest.raises(ValueError, match="not a directory"):
        muad.load_muad_depth(str(tmp_path / "nope"))


# ------------------------------------------------------------- native gather

def test_native_gather_matches_numpy_and_counts_its_path():
    assert _native.available(), _native.build_error
    rng = np.random.default_rng(0)
    _native.reset_counts()
    for dtype in (np.uint8, np.float32, np.float64, np.int32):
        src = (rng.standard_normal((40, 7, 5, 3)) * 50).astype(dtype)
        idx = rng.integers(0, 40, size=23)
        np.testing.assert_array_equal(_native.gather_rows(src, idx, num_threads=3), src[idx])
    assert _native.counts[("gather_rows", "native")] == 4
    # declined (counted as numpy): a strided array, one thread
    assert _native.gather_rows(src[:, ::2], np.arange(3), num_threads=2) is None
    assert _native.gather_rows(src, np.arange(3), num_threads=1) is None
    assert _native.counts[("gather_rows", "numpy")] == 2
    tiles = rng.standard_normal((3, 40, 50, 2)).astype(np.float32)
    t, ys, xs = (rng.integers(0, 3, 25), rng.integers(0, 25, 25), rng.integers(0, 35, 25))
    want = np.stack([tiles[a, b:b + 16, c:c + 16] for a, b, c in zip(t, ys, xs)])
    np.testing.assert_array_equal(_native.gather_patches(tiles, t, ys, xs, 16, 16), want)
    assert _native.counts[("gather_patches", "native")] == 1
    # an ArrayDataset's 1-D index goes through it
    ds = core.ArrayDataset({"x": rng.standard_normal((30, 4, 4, 3)).astype(np.float32),
                            "y": np.arange(30)})
    idx = rng.integers(0, 30, 9)
    _same(ds[idx], jax_core.ArrayDataset(ds.data)[idx])
    assert _native.counts[("gather_rows", "native")] == 6
    # the counts under threads gathering at once, switching often
    _native.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [ds[idx] for _ in range(20)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _native.counts == {("gather_rows", "native"): 16 * 20 * 2}


# ---------------------------------------------------------- the device cache

def _frames(n, seed, hw=(8, 12)):
    rng = np.random.default_rng(seed)
    return core.ArrayDataset({
        "image": rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8),
        "label": rng.integers(0, 256, (n, *hw, 1), dtype=np.uint8),
        "mask": rng.random((n, *hw, 1)).astype(np.float32),
    })


def test_device_dataset_gather_matches_jax():
    ds = _frames(10, 0)
    got, want = core.DeviceDataset(ds, device="cpu"), jax_core.DeviceDataset(ds)
    assert len(got) == len(want) == 10 and got.nbytes == want.nbytes
    assert all(v.dtype == torch.uint8 for k, v in got.data.items() if k != "mask")
    for idx in (np.array([3, 1, 7, 3]), np.arange(10)[::-1].copy(),
                np.random.default_rng(1).integers(0, 10, 6).astype(np.int32)):
        a = got.gather(idx)
        b = jax.jit(want.gather)(idx)
        _same({k: v.numpy() for k, v in a.items()}, {k: np.asarray(v) for k, v in b.items()})
        _same({k: v.numpy() for k, v in a.items()}, ds[idx])
    assert core.device_cache_budget_bytes("cpu") is None
    assert jax_core.device_cache_budget_bytes() is None


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (True, False), (False, False)])
def test_partial_device_dataset_stream_matches_jax(shuffle, drop_last):
    ds = _frames(23, 2)
    budget = 9 * (8 * 12 * 4 + 8 * 12 * 4)  # 9 rows' bytes
    got = core.PartialDeviceDataset(ds, budget, device="cpu", seed=4)
    want = jax_core.PartialDeviceDataset(ds, budget, seed=4)
    assert got.n_cached == want.n_cached == 9 and got.nbytes == want.nbytes
    np.testing.assert_array_equal(got.cached_rows, want.cached_rows)
    np.testing.assert_array_equal(got.host_rows, want.host_rows)
    for epoch in (0, 1):
        a = list(got.epoch_batches(4, seed=7, epoch=epoch, shuffle=shuffle, drop_last=drop_last))
        b = list(want.epoch_batches(4, seed=7, epoch=epoch, shuffle=shuffle,
                                    drop_last=drop_last))
        assert [k for k, _ in a] == [k for k, _ in b]
        assert {k for k, _ in a} == {"cached", "host"}
        for (kind, x), (_, y) in zip(a, b):
            if kind == "cached":
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
                _same({k: v.numpy() for k, v in got.cached.gather(x).items()},
                      ds[got.cached_rows[x]])
            else:
                _same(x, y)


SMALL = dict(in_channels=3, out_channels=2, num_subnetworks=2, filter_base_count=4)


class Frames(core.DataModule):
    """uint8 NYUv2-schema frames: ``n_train`` train and 4 val images of
    32x32, batches of 2."""

    batch_size = 2

    def __init__(self, n_train):
        self.n_train = n_train

    def setup(self):
        rng = np.random.default_rng(6)

        def split(n):
            return core.ArrayDataset({
                "image": rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                "label": rng.integers(0, 256, (n, 32, 32, 1), dtype=np.uint8)})

        self.train, self.val = split(self.n_train), split(4)

    def train_dataset(self):
        return self.train

    def val_dataset(self):
        return self.val


class Recording:
    """A task that records the images of every train batch it is fed."""

    def __init__(self, task):
        self.task, self.images = task, []

    def __getattr__(self, name):
        return getattr(self.task, name)

    def train_step(self, state, batch, **kw):
        self.images.append(batch["image"].clone())
        return self.task.train_step(state, batch, **kw)


def _fit(tmp_path, name, n_train, **kw):
    task = Recording(MimoUnetTask(**SMALL, decoder_dropout_rate=0.1))
    trainer = Trainer(task, Frames(n_train), max_epochs=2, checkpoint_path=str(tmp_path / name),
                      log_every_n_steps=3, log_images=False, device="cpu", **kw)
    return trainer, trainer.fit()


def test_device_cache_fit_is_bitwise_the_host_fed_fit(tmp_path):
    """9 train frames in batches of 2: 4 steps an epoch, a one-row tail
    dropped."""
    host, a = _fit(tmp_path, "host", 9)
    cached, b = _fit(tmp_path, "cached", 9, device_cache=True)
    assert host.batches_fed == {"host": 8} and cached.batches_fed == {"cached": 8}
    assert len(host.task.images) == len(cached.task.images) == 8
    for x, y in zip(host.task.images, cached.task.images):
        assert torch.equal(x, y)
    assert a.step == b.step == 8
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for pa, pb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(a.loss_buffer.buffer, b.loss_buffer.buffer)
    assert [h["val_loss"] for h in host.history] == [h["val_loss"] for h in cached.history]


def test_partial_device_cache_fit_visits_every_row_once_an_epoch(tmp_path):
    """8 train frames, a budget of 4: 2 cached and 2 host batches an
    epoch, every row once."""
    dm = Frames(8)
    dm.setup()
    row_bytes = core.dataset_nbytes(dm.train) // len(dm.train)
    trainer, state = _fit(tmp_path, "partial", 8, device_cache=True,
                          device_cache_budget=4 * row_bytes)
    assert trainer.batches_fed == {"cached": 4, "host": 4} and state.step == 8
    rows = {dm.train.data["image"][i].tobytes(): i for i in range(len(dm.train))}
    for epoch in (0, 1):
        seen = sorted(rows[img.numpy().tobytes()]
                      for batch in trainer.task.images[4 * epoch:4 * epoch + 4]
                      for img in batch)
        assert seen == list(range(8))
