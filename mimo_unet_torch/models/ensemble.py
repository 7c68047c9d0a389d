"""Inference-time ensembling over MIMO U-Net members, with MC dropout.

Counterpart of ``mimo_unet_tpu/models/ensemble.py`` (reference
mimo/models/ensemble.py:35-115): members are ``(task, model)`` pairs, or
checkpoint paths through ``Ensemble.from_checkpoints`` (the port's
checkpoint directories and reference Lightning ``.ckpt`` files, by
``train/checkpoint.py`` ``load_checkpoint``).  Every member
runs ``max(1, monte_carlo_steps)`` passes, all
predictions concatenate on the subnetwork axis, and the result is the raw
(p1, p2) or the uncertainty decomposition.  With ``monte_carlo_steps`` > 0
the dropout sites are live at eval (BatchNorm stays in eval mode) and the
passes fold into the batch of one forward, whose masks are drawn per image:
the prediction axis is mc-major per member (JAX ensemble.py:112-136).
The masks of member m's forward come from a generator seeded with
``fold_in(seed, m)``, and ``predict`` first folds each batch's start into
the seed, as the JAX package folds them into its key (``rng=None`` being
``key(0)``, JAX ensemble.py:168,193,217,228): one input gives one answer,
call after call, whatever ran before it.  The bits are torch's, not
JAX's.  ``predict`` serves any number of images in fixed-size batches,
padding the last one.  ``mc_counts()`` counts the MC forwards, passes and
masks served.

Every member runs this member loop (the eval kernels where they apply).
The JAX package serves a run of same-architecture members off its
kernel route through one program over their stacked parameters
(ensemble.py:141-199), which saves XLA dispatches.  The port does not:
on the H100 such a program (``torch.func.vmap`` over the stacked
members) gave the loop's predictions but took 1.22-1.24x the loop's
device time in bf16 and 2.44-2.50x in f32 (ROADMAP A.4).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mimo_unet_torch.models.mimo_unet import eval_mode
from mimo_unet_torch.ops.dropout import DropoutSource, draw_counts, reset_draw_counts
from mimo_unet_torch.train.profiling import span
from mimo_unet_torch.transforms import compute_uncertainties, repeat_subnetworks

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed drawn from (seed, data), the role of
    ``jax.random.fold_in``: splitmix64's finaliser of the pair."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


class Ensemble:
    """Callable ensemble of ``(task, model)`` members.  MC-dropout masks
    are derived from each call's ``seed`` (default 0, as the JAX package's
    default ``key(0)``); a ``generator`` given here replaces that: every
    MC forward then draws on from it, on the members' device, and the
    caller owns its state."""

    def __init__(self, members: Sequence[Tuple[object, torch.nn.Module]],
                 return_raw_predictions: bool = False,
                 monte_carlo_steps: int = 0,
                 generator: Optional[torch.Generator] = None):
        if not members:
            raise ValueError("need at least one member")
        self.members = list(members)
        names = {task.loss_fn.name for task, _ in self.members}
        if len(names) > 1:
            raise ValueError(f"ensemble members disagree on loss: {names}")
        if names == {"evidential"}:
            raise ValueError("an evidential task is no ensemble member: its "
                             "predictions are (mu, v, alpha, beta), see "
                             "eval.make_predictions_evidential")
        self.loss_fn = self.members[0][0].loss_fn
        self.return_raw_predictions = return_raw_predictions
        self.monte_carlo_steps = monte_carlo_steps
        self.generator = generator

    @property
    def num_subnetworks(self) -> int:
        """The members' subnetworks summed (reference ensemble.py:68-70)."""
        return sum(task.num_subnetworks for task, _ in self.members)

    @classmethod
    def from_checkpoints(cls, checkpoint_paths: Sequence[str],
                         monte_carlo_steps: int = 0,
                         return_raw_predictions: bool = False,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> "Ensemble":
        """Members loaded from checkpoint paths, in order, on ``device``
        (the card when None): the port's checkpoint directories and
        reference ``.ckpt`` files (``load_checkpoint``), as the JAX
        package's ``Ensemble(checkpoint_paths)``; members whose losses
        disagree are refused."""
        from mimo_unet_torch.train.checkpoint import load_checkpoint

        if not checkpoint_paths:
            raise ValueError("need at least one checkpoint")
        members = []
        for path in checkpoint_paths:
            task, state = load_checkpoint(path, device=device)
            members.append((task, state.model.eval()))
        return cls(members, return_raw_predictions=return_raw_predictions,
                   monte_carlo_steps=monte_carlo_steps, generator=generator)

    @property
    def output_width(self) -> int:
        """Predictions per image: the members' subnetworks times the MC
        passes."""
        return self.num_subnetworks * max(1, self.monte_carlo_steps)

    def _source(self, seed: int, member: int, device) -> Optional[DropoutSource]:
        """Member ``member``'s masks: the ensemble's generator where it has
        one, else a generator seeded with ``fold_in(seed, member)``."""
        if self.monte_carlo_steps <= 0:
            return None
        if self.generator is not None:
            return DropoutSource(generator=self.generator)
        gen = torch.Generator(device).manual_seed(fold_in(seed, member))
        return DropoutSource(generator=gen)

    @torch.no_grad()
    def raw_forward(self, image: torch.Tensor, seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B,H,W,C] -> (p1, p2) each [B, output_width, H, W, C_out/2].
        Each member runs in eval mode, whatever mode it is in (restored
        after): BatchNorm by its running statistics, which stay as they
        are; the MC passes' dropout is live through ``mc_dropout``, its
        masks drawn from ``seed`` and the member's index."""
        return self.raw_forward_grad(image, seed)

    def raw_forward_grad(self, image: torch.Tensor, seed: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``raw_forward`` as autograd sees it: with grad enabled and an
        ``image`` that requires it, every member runs its plain modules
        (the eval kernels carry no gradient; ``MimoUNet.forward``), so an
        input gradient (FGSM, ``eval/fgsm.py``) flows."""
        mc = max(1, self.monte_carlo_steps)
        live = self.monte_carlo_steps > 0
        b = image.shape[0]
        if live:
            _MC["passes"] += b * mc
            _MC["forwards"] += len(self.members)
        p1s, p2s = [], []
        for m, (task, model) in enumerate(self.members):
            source = self._source(seed, m, image.device)
            x = repeat_subnetworks(image, task.num_subnetworks)
            if mc > 1:
                x = x.repeat(mc, 1, 1, 1, 1)  # pass-major batch
            with eval_mode(model):
                p1, p2 = task.forward(model, x, mc_dropout=live, dropout=source)
            if mc > 1:
                # [mc*B, S, ...] -> [B, mc*S, ...]: column j*S + s is pass j
                # of subnetwork s
                p1, p2 = (p.reshape(mc, b, *p.shape[1:]).transpose(0, 1)
                          .reshape(b, -1, *p.shape[2:]) for p in (p1, p2))
            p1s.append(p1)
            p2s.append(p2)
        return torch.cat(p1s, dim=1), torch.cat(p2s, dim=1)

    def __call__(self, image: torch.Tensor, seed: int = 0):
        p1, p2 = self.raw_forward(image, seed)
        if self.return_raw_predictions:
            return p1, p2
        return compute_uncertainties(self.loss_fn, p1, p2)

    def predict(self, images, batch_size: int = 32,
                device: Optional[torch.device] = None, seed: int = 0):
        """Run any number of images [N,H,W,C] through the ensemble in
        ``batch_size`` batches (the last one padded with copies of its last
        image, then trimmed); the batch at ``start`` draws its masks from
        ``fold_in(seed, start)``.  Returns numpy (mean, aleatoric_var,
        epistemic_var) over all inputs.

        Each answer is allocated whole once the first batch's shapes are
        known, and every batch's rows are copied into it in place.  On a
        CUDA device the answers are pinned host memory from torch's caching
        host allocator, filled by asynchronous copies with one wait at the
        end: a block the caller drops goes back to that cache for a later
        call, and an answer the caller keeps is never written again."""
        with span("mimo.predict"):
            with span("mimo.predict.in"):
                if device is None:
                    device = next(self.members[0][1].parameters()).device
                images = torch.as_tensor(np.asarray(images))
            n = images.shape[0]
            answers, pinned = (), False
            for start in range(0, n, batch_size):
                with span("mimo.predict.in"):
                    chunk = images[start:start + batch_size]
                    real = chunk.shape[0]
                    if real < batch_size:
                        pad = chunk[-1:].expand(batch_size - real, *chunk.shape[1:])
                        chunk = torch.cat([chunk, pad])
                    x = chunk.to(device)
                with span("mimo.predict.forward"):
                    p1, p2 = self.raw_forward(x, fold_in(seed, start))
                    del x  # the input's card memory is free for what follows
                    parts = compute_uncertainties(self.loss_fn, p1, p2)
                with span("mimo.predict.fetch"):
                    pinned = parts[0].device.type == "cuda"
                    if not answers:
                        answers = tuple(torch.empty((n, *t.shape[1:]), dtype=t.dtype,
                                                    pin_memory=pinned) for t in parts)
                    for out, t in zip(answers, parts):
                        out[start:start + real].copy_(t[:real], non_blocking=pinned)
                    _FETCHES["pinned" if pinned else "host"] += 1
                    if pinned:
                        _FETCHES["pinned_bytes"] += sum(t[:real].nbytes for t in parts)
            with span("mimo.predict.assemble"):
                if pinned:
                    torch.cuda.current_stream(parts[0].device).synchronize()
                return tuple(a.numpy() for a in answers)


_FETCHES = {"pinned": 0, "host": 0, "pinned_bytes": 0}


def reset_fetch_counts() -> None:
    for k in _FETCHES:
        _FETCHES[k] = 0


def fetch_counts() -> dict:
    """``predict``'s answer chunks fetched by path, ``"pinned"`` (async
    copies into pinned host memory, on a CUDA device) or ``"host"`` (copies
    into plain host memory), and ``"pinned_bytes"``, the bytes fetched into
    pinned memory, since the last ``reset_fetch_counts``."""
    return dict(_FETCHES)


_MC = {"forwards": 0, "passes": 0}


def reset_mc_counts() -> None:
    for k in _MC:
        _MC[k] = 0
    reset_draw_counts()


def mc_counts() -> dict:
    """MC-dropout work since the last ``reset_mc_counts``: ``"forwards"``,
    the members' forwards with live dropout; ``"passes"``, the passes those
    calls served (a call's images times ``monte_carlo_steps``, padded rows
    included, once whatever the members); ``"masks"`` and
    ``"mask_elements"``, the keep masks ``DropoutSource.draw`` handed out
    and their elements (``ops/dropout.py`` ``draw_counts``: a train step's
    masks too)."""
    return {**_MC, **draw_counts()}
