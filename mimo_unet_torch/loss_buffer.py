"""Subnetwork loss re-weighting buffer.

Counterpart of ``mimo_unet_tpu/loss_buffer.py`` (reference
mimo/models/mimo_components/loss_buffer.py:18-74): a ring of the last
``buffer_size`` per-subnetwork loss vectors; weights = softmax(mean_loss /
temperature) * S, so lagging subnetworks get up-weighted.  The state is a
``[max(size, 1), S]`` float32 tensor and a ring index, kept on the device
of the train step; ``loss_buffer_add`` writes in place.

``buffer_size == 0`` disables re-weighting: the buffer is never written
and the weights are exactly 1.
"""

from __future__ import annotations

import dataclasses

import torch


def softmax_temperature(x: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """softmax(x / temperature) along the last axis."""
    if temperature <= 0:
        raise ValueError("Temperature should be positive.")
    return torch.softmax(x / temperature, dim=-1)


@dataclasses.dataclass
class LossBufferState:
    buffer: torch.Tensor  # [max(buffer_size, 1), S] float32
    index: int            # ring pointer


def loss_buffer_init(subnetworks: int, buffer_size: int,
                     device=None) -> LossBufferState:
    return LossBufferState(
        buffer=torch.zeros((max(buffer_size, 1), subnetworks),
                           dtype=torch.float32, device=device),
        index=0)


@torch.no_grad()
def loss_buffer_add(state: LossBufferState, loss: torch.Tensor,
                    buffer_size: int) -> LossBufferState:
    """Write the latest per-subnetwork loss [S] at the ring position (in
    place) and advance the pointer."""
    if buffer_size == 0:
        return state
    state.buffer[state.index] = loss.detach().float()
    state.index = (state.index + 1) % buffer_size
    return state


def loss_buffer_weights(state: LossBufferState, temperature: float,
                        buffer_size: int) -> torch.Tensor:
    """Weights [S]: softmax(mean_loss / T) * S (uniform == all ones)."""
    s = state.buffer.shape[1]
    if buffer_size == 0:
        return torch.ones((s,), dtype=torch.float32, device=state.buffer.device)
    return softmax_temperature(state.buffer.mean(dim=0), temperature) * s
