"""Adaptive per-segment curriculum sampler.

Counterpart of ``add_gym_tpu/learning/sampler.py``: each (clip, segment)
keeps an EMA of tracking error; reset start times are sampled from a
softmax over segment errors (harder segments sampled more).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplerState:
    errors: torch.Tensor  # [num_clips, num_segments] EMA of tracking error


def init_sampler(num_clips: int, num_segments: int, device="cpu") -> SamplerState:
    return SamplerState(errors=torch.ones((num_clips, num_segments), device=device))


def segment_stats(state: SamplerState, seg_sizes, clip_ids, timesteps, tracking_errors):
    """Per-segment (error sum, sample count), each flat [num_clips *
    num_segments]: what :func:`update_errors_from_stats` merges, and what
    data parallelism sums over the ranks first."""
    num_clips, num_segments = state.errors.shape
    sizes = torch.clamp_min(seg_sizes[clip_ids], 1e-6)
    seg_idx = torch.clamp((timesteps / sizes).to(torch.int64), 0, num_segments - 1)
    flat = clip_ids * num_segments + seg_idx

    total = torch.zeros(num_clips * num_segments, dtype=state.errors.dtype,
                        device=state.errors.device).index_add_(0, flat, tracking_errors)
    count = torch.zeros_like(total).index_add_(0, flat, torch.ones_like(tracking_errors))
    return total, count


def update_errors(state: SamplerState, seg_sizes, clip_ids, timesteps,
                  tracking_errors) -> SamplerState:
    """EMA-update segment errors from rollout data."""
    return update_errors_from_stats(
        state, *segment_stats(state, seg_sizes, clip_ids, timesteps, tracking_errors))


def update_errors_from_stats(state: SamplerState, total, count) -> SamplerState:
    """EMA-update the segments that have samples with their mean error."""
    mean = (total / torch.clamp_min(count, 1.0)).reshape(state.errors.shape)
    mask = (count > 0).reshape(state.errors.shape)
    return SamplerState(errors=torch.where(mask, 0.9 * state.errors + 0.1 * mean, state.errors))


def segment_probs(state: SamplerState, clip_ids, temperature=None):
    """Softmax over segment errors (default temperature = max error over
    the selected clips)."""
    clip_errors = state.errors[clip_ids]
    if temperature is None:
        temperature = torch.max(clip_errors) + 1e-6
    return torch.softmax(clip_errors / temperature, dim=-1)


def sample_start_time(
    state: SamplerState, clip_ids, seg_sizes, dt: float, min_start_time: float,
    temperature=None, generator: torch.Generator | None = None,
):
    """Difficulty-weighted start time, dt-quantized."""
    probs = segment_probs(state, clip_ids, temperature)
    segments = torch.multinomial(probs, 1, generator=generator)[:, 0]
    sizes = seg_sizes[clip_ids]
    u = torch.rand(clip_ids.shape, generator=generator, device=sizes.device)
    t = segments * sizes + u * sizes
    t = torch.floor(t / dt) * dt
    return torch.clamp_min(t, min_start_time)
