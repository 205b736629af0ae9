"""Expert-trajectory data pipeline (port of diff_qp_mpc_tpu.learning.data,
without its reference-checkpoint adapter).

Reads and writes the reference's pickled datasets (``data/expert_traj_<type>-
<spec_id>_new.pkl``: a list of trajectories, each a list of (state, action)
pairs, numpy arrays or torch tensors). The sampler takes uniform random
start indices into the concatenated data; windows crossing an episode end
are masked from the crossing on (cumulative product of the per-step masks),
and windows running past the data end are zero-padded. Sampling is numpy
on the host; the batch is moved to the device by the caller.
"""
from __future__ import annotations

import pickle
from typing import Dict, Sequence, Tuple

import numpy as np

from diff_qp_mpc_tpu_torch import runtime

Array = np.ndarray


def _to_numpy(a) -> Array:
    if hasattr(a, "detach"):  # torch tensor in a reference pickle
        return a.detach().cpu().numpy()
    return np.asarray(a)


def merge_trajectories(trajs: Sequence[Sequence[Tuple]]) -> Dict[str, Array]:
    """List of trajectories -> flat float32 arrays and a mask (0 marks each
    episode's last step)."""
    states, actions, mask = [], [], []
    for traj in trajs:
        for state, action in traj:
            states.append(_to_numpy(state).reshape(-1))
            actions.append(_to_numpy(action).reshape(-1))
            mask.append(1.0)
        mask[-1] = 0.0
    return {"state": np.asarray(states, np.float32),
            "action": np.asarray(actions, np.float32),
            "mask": np.asarray(mask, np.float32)}


def load_expert_pickle(path: str) -> Dict[str, Array]:
    """Load a reference-format expert pickle and merge it. ``path`` may be a
    comma-separated list; the datasets are concatenated (each episode keeps
    its terminating mask 0, so no window crosses a dataset boundary)."""
    if "," in path:
        parts = [load_expert_pickle(p) for p in path.split(",") if p]
        return {k: np.concatenate([d[k] for d in parts], axis=0)
                for k in parts[0]}
    with open(path, "rb") as f:
        trajs = pickle.load(f)
    if isinstance(trajs, dict):  # already merged
        return {k: _to_numpy(v) for k, v in trajs.items()}
    return merge_trajectories(trajs)


def save_expert_pickle(path: str, trajs: Sequence[Sequence[Tuple]]) -> None:
    """Write trajectories (lists of (state, action) numpy pairs) in the
    reference pickle format that ``load_expert_pickle`` reads."""
    with open(path, "wb") as f:
        pickle.dump([list(t) for t in trajs], f)


def sample_window_batch(data: Dict[str, Array], bsz: int, T: int,
                        rng: np.random.RandomState,
                        use_native: bool = True) -> Dict[str, Array]:
    """``bsz`` random T-windows with the cumulative mask. The native sampler
    (``runtime``, seeded by one draw from ``rng``) unless ``use_native`` is
    False, then numpy on ``rng``; the two draw different windows."""
    if use_native:
        return runtime.sample_window_batch_native(
            data, bsz, T, int(rng.randint(0, 2**31)))
    N = len(data["state"])
    states, actions, masks = [], [], []
    while len(states) < bsz:
        i = int(rng.randint(0, N))
        if data["mask"][i] == 0:  # never start at an episode end
            continue
        if i + T <= N:
            s = data["state"][i:i + T]
            a = data["action"][i:i + T]
            m = data["mask"][i:i + T]
        else:
            pad = i + T - N
            z = lambda arr: np.concatenate(
                [arr[i:], np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)
            s, a, m = z(data["state"]), z(data["action"]), z(data["mask"])
        states.append(s)
        actions.append(a)
        masks.append(m)
    return {"state": np.stack(states), "action": np.stack(actions),
            # once masked, stay masked
            "mask": np.cumprod(np.stack(masks), axis=1)}


def unwrap_window_angles(states: Array, mode: str) -> Array:
    """Phase-align wrapped angle coordinates along each sampled window
    [bsz, T, nx], so each trajectory lives in one winding (the reference's
    pickles store env-wrapped angles).

    mode "pendulum": the angle at coordinate 0; a jump above π/2 shifts the
    offender by −sign(θ_t)·2π. "cartpole": the angles at coordinates
    1 .. nx/2 − 1, shifted toward the previous angle.
    """
    s = np.array(states, copy=True)
    if mode == "pendulum":
        cols = [0]
        sign = lambda cur, prev: np.sign(cur)
    elif mode == "cartpole":
        cols = list(range(1, s.shape[2] // 2))
        sign = lambda cur, prev: np.sign(cur - prev)
    else:
        raise ValueError(f"unknown unwrap mode {mode!r}")
    prev = s[:, 0, cols]
    for t in range(s.shape[1]):
        cur = s[:, t, cols]
        jump = np.abs(cur - prev) > np.pi / 2
        s[:, t, cols] = np.where(jump, cur - sign(cur, prev) * 2 * np.pi, cur)
        prev = s[:, t, cols]
    return s
