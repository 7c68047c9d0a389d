"""The port's CLIs held against the JAX package's (CPU).

``mimo_unet_torch/cli.py``, the nine scripts of ``mimo_unet_torch/scripts``
and ``mimo_unet_torch/examples/nyuv2_minimal.py``:

* Flags: each script's parser against the JAX script's, built by running
  the JAX script's ``__main__`` block up to its ``main`` call (the same
  argument-group functions in the same order); the same option strings,
  types, defaults, choices and required flags.  The only differences
  allowed are ``ALLOWED``'s: ``--device`` selects the torch device (the
  card by default), and the train scripts gain it.
* Hyperparameters: ``build_mimo_task`` and ``build_evidential_task`` give
  the JAX tasks' hparams for the same argv.
* The train path: ``train_nyuv2_depth.main`` at S=2, fbc 4 on a 32x32 h5
  fixture, f32 on the CPU; its ``last/`` bitwise a direct ``Trainer.fit``
  of the same task and data module.
* The eval path: one reference-format Lightning ``.ckpt`` of seeded
  weights per family (MIMO S=2, evidential) and input width (3 for
  NYUv2, 2 for SEN12TP, the first CPU run of ``in_channels=2``); the port's
  and the JAX package's four test scripts' ``main`` on it and on the same
  fixtures give the same files, shapes and dtypes, every eps-0 array and
  per-pixel frame column within 2e-4; at eps > 0 the inputs within 2e-4
  where the input gradient stands clear of rounding (|g| > 1e-6 max|g|, as
  tests/test_torch_eval.py holds FGSM), every other array and column
  within 2e-4 everywhere; the curves (.csv, order statistics of the frame)
  as the JAX package's curve functions make them from the port's frame.
* The latency script on the CPU prints both lines; the example trains 3
  steps with a falling loss; every script and the example run as
  ``python -m`` and by path.

Torch runs on one thread (small shapes).
"""

import argparse
import ast
import functools
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from make_fixtures import make_nyuv2_h5, make_sen12tp_tiles

from mimo_unet_tpu import cli as jax_cli
from mimo_unet_tpu.eval import artifacts as jax_artifacts
from mimo_unet_tpu.models.mimo_unet import mimo_unet_init
from mimo_unet_tpu.tasks.evidential import EvidentialUnetTask as JaxEvTask
from mimo_unet_tpu.tasks.mimo import MimoUnetTask as JaxTask

from mimo_unet_torch import cli
from mimo_unet_torch.data.nyuv2 import NYUv2DepthDataModule, load_nyuv2_depth
from mimo_unet_torch.eval.fgsm import input_gradient
from mimo_unet_torch.examples import nyuv2_minimal
from mimo_unet_torch.interop import jax_pytree_to_state_dict
from mimo_unet_torch.models.ensemble import Ensemble
from mimo_unet_torch.models.mimo_unet import eval_mode
from mimo_unet_torch.scripts.test import measure_inference_speed
from mimo_unet_torch.scripts.test.test_ndvi import load_dataset
from mimo_unet_torch.scripts.train import train_nyuv2_depth
from mimo_unet_torch.tasks import EvidentialUnetTask, MimoUnetTask
from mimo_unet_torch.train.checkpoint import load_checkpoint
from mimo_unet_torch.train.trainer import Trainer
from mimo_unet_torch.transforms import repeat_subnetworks

from test_torch_slice import _leaf_values
from test_torch_trainer import _assert_states_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["train_nyuv2_depth", "train_nyuv2_depth_evidential", "train_ndvi",
         "train_ndvi_evidential"]
TEST = ["test_nyuv2_depth", "test_nyuv2_depth_evidential", "test_ndvi",
        "test_ndvi_evidential", "measure_inference_speed"]
SCRIPTS = [f"train/{s}" for s in TRAIN] + [f"test/{s}" for s in TEST]
# the port's flags that differ from the JAX script's: (option strings,
# what differs, the port's default)
ALLOWED = {"train": (("--device",), "new", "cuda"),
           "test": (("--device",), "default", "cuda")}
FBC = 4     # filter base count of every model here
EVAL_B = 3  # eval batch size: the last batch of 4 windows or frames is padded


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: torch's intra-op threads cost more than they give,
    most of all beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ flags

@functools.lru_cache(maxsize=None)
def _jax_script(name):
    """The JAX script ``scripts/<name>.py`` as a module (run as imported:
    its ``__main__`` block does not run), with the environment and
    ``sys.path`` it changes put back."""
    path = os.path.join(REPO, "scripts", name + ".py")
    env, path_before = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_script_" + name.replace("/", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path_before
    return module, path


def _jax_parser(name) -> argparse.ArgumentParser:
    """The JAX script's parser: its ``if __name__ == "__main__"`` block,
    every statement up to the ``main(...)`` call, run in its module."""
    module, path = _jax_script(name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    block = next(node for node in tree.body if isinstance(node, ast.If)
                 and ast.unparse(node.test) == "__name__ == '__main__'")
    body = [st for st in block.body
            if not (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)
                    and ast.unparse(st.value.func) == "main")]
    assert len(body) == len(block.body) - 1, "no main(...) call in the block"
    ns = dict(vars(module))
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns["parser"]


def _port_module(name):
    return importlib.import_module("mimo_unet_torch.scripts." + name.replace("/", "."))


def _flags(parser):
    """{option strings: what argparse keeps of the flag}; a type function
    by its name (the packages each have their ``dir_path``)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        typ = a.type if a.type in (None, int, float, str, bool) else a.type.__name__
        out[tuple(a.option_strings)] = dict(
            dest=a.dest, type=typ, default=a.default, required=a.required,
            nargs=a.nargs, choices=a.choices, action=type(a).__name__, const=a.const)
    return out


@pytest.mark.parametrize("name", SCRIPTS)
def test_flags_match_the_jax_script(name):
    want = _flags(_jax_parser(name))
    got = _flags(_port_module(name).build_parser())
    opts, kind, default = ALLOWED[name.split("/")[0]]
    assert got[opts]["default"] == default and got[opts]["type"] is str
    if kind == "new":
        assert opts not in want
        del got[opts]
    else:
        assert want[opts]["default"] == "tpu"
        want[opts]["default"] = default
    assert got == want


# ------------------------------------------------------------ hyperparameters

def _argv(tmp_path, extra):
    return ["--checkpoint_path", str(tmp_path), "--dataset_dir", str(tmp_path),
            "--seed", "5", *extra]


MIMO_ARGV = ["--num_subnetworks", "2", "--filter_base_count", "21", "--loss", "gaussian_nll",
             "--learning_rate", "0.002", "--weight_decay", "0.01", "--loss_buffer_size", "4",
             "--loss_buffer_temperature", "0.3", "--input_repetition_probability", "0.25",
             "--batch_repetitions", "2", "--scheduler_step_size", "7",
             "--scheduler_gamma", "0.1", "--decoder_dropout_rate", "0.1",
             "--precision", "f32"]
EV_ARGV = ["--filter_base_count", "16", "--learning_rate", "0.0005", "--weight_decay", "0.001",
           "--center_dropout_rate", "0.2", "--final_dropout_rate", "0.1",
           "--scheduler_step_size", "3", "--scheduler_gamma", "0.9"]


@pytest.mark.parametrize("family,extra", [("mimo", []), ("mimo", MIMO_ARGV),
                                          ("evidential", []), ("evidential", EV_ARGV)])
def test_tasks_match_the_jax_cli(tmp_path, family, extra):
    script = "train/train_nyuv2_depth" + ("_evidential" if family == "evidential" else "")
    argv = _argv(tmp_path, extra)
    args = _port_module(script).build_parser().parse_args(argv)
    jargs = _jax_parser(script).parse_args(argv)
    if family == "mimo":
        got, want = cli.build_mimo_task(args, 3, 2), jax_cli.build_mimo_task(jargs, 3, 2)
        assert isinstance(got, MimoUnetTask)
    else:
        got = cli.build_evidential_task(args, 2, 4)
        want = jax_cli.build_evidential_task(jargs, 2, 4)
        assert isinstance(got, EvidentialUnetTask)
    assert got.hparams() == want.hparams()
    assert args.device == "cuda" and vars(args).keys() - vars(jargs).keys() == {"device"}


# --------------------------------------------------------------- train path

@pytest.fixture(scope="module")
def nyu_dir(tmp_path_factory):
    """depth_train.h5 (8 frames) and depth_test.h5 (4) of 32x32."""
    return make_nyuv2_h5(str(tmp_path_factory.mktemp("nyu")), n=8, h=32, w=32, seed=3)


@pytest.fixture(scope="module")
def sen_dir(tmp_path_factory):
    """One 64x64 SEN12TP tile: 4 windows of 32 at stride 32."""
    root = str(tmp_path_factory.mktemp("sen"))
    make_sen12tp_tiles(root, n_tiles=1, size=64, seed=4, splits=("test",))
    return os.path.join(root, "test")


def test_train_script_is_trainer_fit(tmp_path, nyu_dir):
    """The CLI's run is Trainer.fit of the task it names: last/ bitwise."""
    ckpt = tmp_path / "cli"
    ckpt.mkdir()
    args = train_nyuv2_depth.build_parser().parse_args([
        "--checkpoint_path", str(ckpt), "--dataset_dir", nyu_dir, "--seed", "1",
        "--max_epochs", "1", "--batch_size", "4", "--num_subnetworks", "2",
        "--filter_base_count", str(FBC), "--precision", "f32", "--device", "cpu",
        "--log_every_n_steps", "1"])
    trainer, state = train_nyuv2_depth.main(args)
    task = MimoUnetTask(in_channels=3, out_channels=2, num_subnetworks=2,
                        filter_base_count=FBC, seed=1)
    assert trainer.task == task and state.step == 2
    assert trainer.device == torch.device("cpu")
    direct = Trainer(task, NYUv2DepthDataModule(nyu_dir, batch_size=4, seed=1), max_epochs=1,
                     checkpoint_path=str(tmp_path / "direct"), log_every_n_steps=1, seed=1,
                     device="cpu").fit()
    _assert_states_equal(load_checkpoint(str(ckpt / "last"), 2, device="cpu")[1], direct)
    with open(ckpt / "last" / "hparams.json") as f:
        assert json.load(f) == task.hparams()
    rows = [json.loads(line) for line in open(ckpt / "metrics.tsv")]
    assert [r["step"] for r in rows if "train_loss" in r] == [0, 1]
    assert os.listdir(ckpt / "images")  # the depth monitor's grids


# ---------------------------------------------------------------- eval path

@functools.lru_cache(maxsize=None)
def _seeded(family, in_channels):
    """(hparams of a reference .ckpt, JAX params, JAX state): seeded values
    in the JAX package's pytree (BatchNorm statistics and affine too)."""
    if family == "mimo":
        hp = dict(in_channels=in_channels, out_channels=2, num_subnetworks=2,
                  filter_base_count=FBC, loss="laplace_nll", weight_decay=0.0,
                  learning_rate=1e-3, seed=1, loss_buffer_size=10,
                  loss_buffer_temperature=1.0, task="mimo_unet")
        cfg = JaxTask(**{k: v for k, v in hp.items() if k != "task"}).model_config
    else:
        hp = dict(in_channels=in_channels, out_channels=4, filter_base_count=FBC,
                  weight_decay=0.0, learning_rate=1e-3, seed=2, task="evidential_unet")
        cfg = JaxEvTask(**{k: v for k, v in hp.items() if k != "task"}).model_config
    seed = 10 * in_channels + (family == "mimo")
    shapes = jax.eval_shape(lambda k: mimo_unet_init(k, cfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params, state = jax.tree_util.tree_map_with_path(
        lambda path, sd: jnp.asarray(_leaf_values(path, sd.shape, rng), sd.dtype), shapes)
    return hp, params, state


def _reference_ckpt(path, family, in_channels):
    """A reference-format Lightning .ckpt (``model._orig_mod.`` keys, the
    reference's hyper_parameters and ``task``), as
    tests/test_torch_evidential.py writes one."""
    hp, params, state = _seeded(family, in_channels)
    kind = MimoUnetTask if family == "mimo" else EvidentialUnetTask
    cfg = kind(**{k: v for k, v in hp.items() if k != "task"}).model_config
    sd = jax_pytree_to_state_dict(params, state, cfg)
    torch.save({"state_dict": {f"model._orig_mod.{k}": v for k, v in sd.items()},
                "hyper_parameters": hp, "epoch": 3}, path)
    return path


def _input_grads(family, ckpt, dataset):
    """d NLL / d image at each eval batch (the last padded with its last
    row, as the predictions pad it), through the port's plain modules in
    f32: it only marks the pixels whose gradient stands clear of
    rounding."""
    n = len(dataset)
    batches = [np.minimum(np.arange(s, s + EVAL_B), n - 1) for s in range(0, n, EVAL_B)]
    if family == "mimo":
        ens = Ensemble.from_checkpoints([ckpt], return_raw_predictions=True, device="cpu")

        def nll(img, label):
            return ens.loss_fn(*ens.raw_forward_grad(img),
                               repeat_subnetworks(label, ens.output_width))
    else:
        task, state = load_checkpoint(ckpt, device="cpu")

        def nll(img, label):
            with eval_mode(state.model):
                return task.loss_fn(task.forward(state.model, img), label, reduce_mean=True)

    grads = []
    for idx in batches:
        b = {k: torch.from_numpy(v) for k, v in dataset[idx].items()}
        grads.append(input_gradient(lambda x: nll(x, b["label"]), b["image"]).numpy())
    return np.concatenate(grads)[:n]


def _frame(path):
    return pd.read_pickle(path) if path.endswith(".pkl") else pd.read_csv(path)


def _assert_curve(got, got_dir, name):
    """A .csv curve as the JAX package's curve function makes it from the
    port's own per-pixel frame (held against the JAX script's within
    2e-4), within 1e-12.  Not against the JAX script's curve: a curve is an
    order statistic of the frame, which pixels whose uncertainties differ
    by rounding reorder (seen: 4.3e-4 at eps 0)."""
    if name.startswith("test_"):  # NYUv2: {dataset}_{eps}_..., no subsample
        frame = os.path.join(got_dir, "_".join(name.split("_")[:2]) + "_metrics.pkl")
        subsample = None
    else:  # SEN12TP
        frame, subsample = os.path.join(got_dir, "df_pixels.pkl"), 0.5
    frame = pd.read_pickle(frame)
    if name.endswith("precision_recall.csv"):
        want = jax_artifacts.create_precision_recall(frame)
    else:
        want = jax_artifacts.create_calibration(frame, subsample=subsample)
    assert list(got.columns) == list(want.columns), name
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), atol=1e-12, rtol=0,
                               err_msg=name)


def _compare_dirs(got_dir, want_dir, grad=None):
    """Same files; .npy shapes and dtypes, frames' columns and dtypes;
    values within 2e-4, but at eps > 0 the inputs only where |grad| > 1e-6
    max|grad|; the curves by ``_assert_curve``."""
    files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == files
    for name in files:
        got_path, want_path = os.path.join(got_dir, name), os.path.join(want_dir, name)
        eps = float(name.split("_")[1]) if name.startswith("test_") else 0.0
        if name.endswith(".npy"):
            got, want = np.load(got_path), np.load(want_path)
            assert got.shape == want.shape and got.dtype == want.dtype, name
            if name.endswith("inputs.npy") and eps > 0:
                strong = np.abs(grad) > 1e-6 * np.abs(grad).max()
                assert strong.mean() > 0.9
                got, want = got[strong], want[strong]
        else:
            got, want = _frame(got_path), _frame(want_path)
            assert list(got.columns) == list(want.columns), name
            assert list(got.dtypes) == list(want.dtypes) and got.shape == want.shape, name
            if name.endswith(".csv"):
                _assert_curve(got, got_dir, name)
                continue
            got, want = got.to_numpy(), want.to_numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0, err_msg=name)


EVAL_CASES = [("test_nyuv2_depth", "mimo", 3), ("test_nyuv2_depth_evidential", "evidential", 3),
              ("test_ndvi", "mimo", 2), ("test_ndvi_evidential", "evidential", 2)]


@pytest.mark.parametrize("script,family,in_channels", EVAL_CASES)
def test_eval_script_matches_jax(tmp_path, nyu_dir, sen_dir, script, family, in_channels):
    ckpt = _reference_ckpt(str(tmp_path / "ref.ckpt"), family, in_channels)
    ndvi = script.startswith("test_ndvi")
    argv = ["--model_checkpoint_path" + ("s" if family == "mimo" else ""), ckpt,
            "--dataset_dir", sen_dir if ndvi else nyu_dir, "--batch_size", str(EVAL_B)]
    if ndvi:
        argv += ["--patch_size", "32", "--stride", "32"]
    name = "test/" + script
    jax_module, _ = _jax_script(name)
    jax_module.main(_jax_parser(name).parse_args(argv + ["--result_dir", str(tmp_path / "jax")]))
    _port_module(name).main(_port_module(name).build_parser().parse_args(
        argv + ["--result_dir", str(tmp_path / "port"), "--device", "cpu"]))
    if ndvi:
        args = argparse.Namespace(dataset_dir=sen_dir, patch_size=32, stride=32)
        assert load_dataset(args)[np.arange(4)]["image"].shape == (4, 32, 32, in_channels)
        grad = None
    else:
        grad = _input_grads(family, ckpt, load_nyuv2_depth(
            os.path.join(nyu_dir, "depth_test.h5"), normalize=True))
    _compare_dirs(str(tmp_path / "port"), str(tmp_path / "jax"), grad)
    with pytest.raises(FileExistsError):  # result_dir is made with exist_ok=False
        _port_module(name).main(_port_module(name).build_parser().parse_args(
            argv + ["--result_dir", str(tmp_path / "port"), "--device", "cpu"]))


def test_extra_dataset_gets_every_noise_level(tmp_path, nyu_dir):
    """--extra_dataset NAME=PATH: the full artifact set under its name."""
    ckpt = _reference_ckpt(str(tmp_path / "ref.ckpt"), "mimo", 3)
    module = _port_module("test/test_nyuv2_depth")
    out = tmp_path / "out"
    module.main(module.build_parser().parse_args([
        "--model_checkpoint_paths", ckpt, "--result_dir", str(out), "--dataset_dir", nyu_dir,
        "--batch_size", "4", "--device", "cpu",
        "--extra_dataset", "ood=" + os.path.join(nyu_dir, "depth_test.h5")]))
    for eps in module.NOISE_LEVELS:
        np.testing.assert_array_equal(np.load(out / f"ood_{eps}_y_preds.npy"),
                                      np.load(out / f"test_{eps}_y_preds.npy"))
    assert len(os.listdir(out)) == 2 * 3 * 8
    with pytest.raises(SystemExit):
        module.main(module.build_parser().parse_args([
            "--model_checkpoint_paths", ckpt, "--result_dir", str(tmp_path / "bad"),
            "--dataset_dir", nyu_dir, "--device", "cpu", "--extra_dataset", "ood"]))


# ------------------------------------------------- speed script, example, entry

def test_measure_inference_speed_prints_both_lines(tmp_path, capsys):
    ckpt = _reference_ckpt(str(tmp_path / "ref.ckpt"), "mimo", 3)
    args = measure_inference_speed.build_parser().parse_args([
        "--model_checkpoint_paths", ckpt, "--in_channels", "3", "--height", "32",
        "--width", "32", "--repetitions", "3", "--device", "cpu"])
    timings, per_exec = measure_inference_speed.main(args)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("mean: ") and " ms, std: " in lines[-2]
    assert lines[-1].startswith("per-exec (host clock): ") and lines[-1].endswith(" ms (cpu)")
    assert len(timings) == 3 and per_exec > 0


def test_example_trains_with_a_falling_loss():
    args = nyuv2_minimal.build_parser().parse_args(["--steps", "3", "--batch_size", "4",
                                                    "--device", "cpu"])
    losses = nyuv2_minimal.main(args)
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


ENTRY = [f"mimo_unet_torch.scripts.{s.replace('/', '.')}" for s in SCRIPTS] + [
    "mimo_unet_torch.examples.nyuv2_minimal"]


def test_every_entry_runs_by_module_and_by_path(tmp_path):
    """``--help`` of each script and the example, as ``python -m`` and by
    its path from outside the repository (each run by path makes the
    package importable itself), in one process."""
    code = (
        "import runpy, sys\n"
        f"repo = {REPO!r}\n"
        f"entries = {ENTRY!r}\n"
        "base = list(sys.path)\n"
        "for name in entries:\n"
        "    for how in ('path', 'module'):\n"
        "        for m in [m for m in sys.modules if m.startswith('mimo_unet_torch')]:\n"
        "            del sys.modules[m]\n"
        "        sys.path[:] = base + ([repo] if how == 'module' else [])\n"
        "        sys.argv = [name, '--help']\n"
        "        try:\n"
        "            if how == 'module':\n"
        "                runpy.run_module(name, run_name='__main__', alter_sys=True)\n"
        "            else:\n"
        "                path = repo + '/' + name.replace('.', '/') + '.py'\n"
        "                runpy.run_path(path, run_name='__main__')\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (name, how, e.code)\n"
        "        else:\n"
        "            raise AssertionError((name, how, 'no exit'))\n"
        "        print('ok', how, name)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("ok ") == 2 * len(ENTRY), proc.stdout
