"""Clustered event scenes: the generator of the ``*.clustered`` mixes.

Each lane watches three blobs of events (Gaussian, ``sigma_px``) whose
centres start at places drawn from the seed and drift ``drift_px`` a frame
(wrapping at the frame's edges), so that the scene-adaptive selection
leaves part of the windows unkept. A frame window is 50 ms of events with
sorted timestamps; its polarity is a fair coin.

The number of events of each frame is one of a fixed set, log-uniform from
``events_min`` to ``events_max``: every seed gets the same sizes, in
another order, so that the seed changes the scene and not the work.
Events are drawn on the card in a few large calls and handed to the
program as host arrays in a camera decoder's types (x, y uint16, p uint8,
t int64 microseconds), as the program's users hand them in.

``serve_pool``: ``pool_frames`` frames per lane, which a stream plays
forward and back (``pool_index``) so that the blobs move on continuously.
``train_pool``: ``pool_batches`` batches of ``lanes`` clips of ``seq_len``
frames, as stacked histograms (via the reference's histogram) with 1-5
boxes on each of up to ``labeled_frames`` labeled frames.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

FRAME_US = 50_000


def sizes_of(mix: dict, count: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = np.log(mix["events_min"]), np.log(mix["events_max"])
    return rng.permutation(np.round(np.exp(np.linspace(lo, hi, count))).astype(np.int64))


def _events(mix: dict, hw, counts: np.ndarray, centres: torch.Tensor, gen, device):
    """Events of ``len(counts)`` frames on the card: frame ``f`` has
    ``counts[f]`` events around its three ``centres[f]`` (F, 3, 2) x/y.
    Returns (x, y, p, t_in_frame) sorted by frame, then time, and the
    frames' offsets."""
    h, w = hw
    n = torch.from_numpy(counts).to(device)
    frame = torch.repeat_interleave(torch.arange(len(counts), device=device), n)
    N = int(counts.sum())
    blob = torch.randint(0, 3, (N,), generator=gen, device=device)
    xy = centres[frame, blob] + torch.randn((N, 2), generator=gen, device=device) * mix["sigma_px"]
    x = torch.remainder(xy[:, 0].round(), w).to(torch.int64)
    y = torch.remainder(xy[:, 1].round(), h).to(torch.int64)
    p = torch.randint(0, 2, (N,), generator=gen, device=device)
    t = torch.randint(0, FRAME_US, (N,), generator=gen, device=device)
    order = torch.argsort(frame * FRAME_US + t)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return x[order], y[order], p[order], t[order], offsets


def _centres(rng: np.random.Generator, lanes: int, hw) -> np.ndarray:
    h, w = hw
    return rng.uniform(0.15, 0.85, (lanes, 3, 2)) * (w, h)


def serve_pool(mix: dict, sensor_hw, seed: int, device) -> List[List[Dict[str, np.ndarray]]]:
    """``lanes`` lists of ``pool_frames`` frames (dicts of x, y, p, t)."""
    lanes, P = mix["lanes"], mix["pool_frames"]
    rng = np.random.Generator(np.random.PCG64(seed))
    counts = sizes_of(mix, lanes * P, rng)
    start = torch.from_numpy(_centres(rng, lanes, sensor_hw)).to(device)
    step = torch.arange(P, device=device, dtype=torch.float64)[:, None, None] * mix["drift_px"]
    centres = (start[:, None] + step[None]).reshape(lanes * P, 3, 2)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    x, y, p, t, off = _events(mix, sensor_hw, counts, centres, gen, device)
    frame_of = torch.repeat_interleave(torch.arange(lanes * P, device=device),
                                       torch.from_numpy(counts).to(device))
    t = t + (frame_of % P) * FRAME_US
    host = [a.cpu().numpy() for a in (x.to(torch.int32), y.to(torch.int32), p, t)]
    x, y, p, t = host[0].astype(np.uint16), host[1].astype(np.uint16), host[2].astype(np.uint8), host[3]
    pool = []
    for lane in range(lanes):
        frames = []
        for f in range(P):
            a, b = off[lane * P + f], off[lane * P + f + 1]
            frames.append(dict(x=x[a:b], y=y[a:b], p=p[a:b], t=t[a:b]))
        pool.append(frames)
    return pool


def pool_index(mix: dict, lane: int, batch: int) -> int:
    """The pool frame that ``lane`` plays at ``batch``: forward through the
    pool and back, each lane from its own phase."""
    P = mix["pool_frames"]
    k = (batch + lane * 7) % (2 * P - 2)
    return k if k < P else 2 * P - 2 - k


def resets(mix: dict, batch: int) -> np.ndarray:
    """(lanes,) bool: the lanes whose stream starts anew at ``batch``, every
    ``reset_frames`` frames, staggered evenly over the lanes."""
    lanes, period = mix["lanes"], mix["reset_frames"]
    offsets = (np.arange(lanes) * period) // lanes
    return (batch + offsets) % period == 0


def train_pool(mix: dict, sizes, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``pool_batches`` training batches in the program's layout: ev_repr
    (T, B, H, W * C) uint8 at the sensor's resolution, frame_tidx,
    frame_valid, gt_boxes (cxcywh, model pixels), gt_classes, gt_valid,
    is_first (the first batch of the pool starts every lane's stream; the
    later ones continue it)."""
    from perfbench.reference.detector import stacked_histogram

    B, T, L, G = mix["lanes"], mix["seq_len"], mix["labeled_frames"], mix["max_gt"]
    nb = mix["pool_batches"]
    h, w = sizes.sensor_hw
    H, W = sizes.model_hw
    rng = np.random.Generator(np.random.PCG64(seed))
    start = torch.from_numpy(_centres(rng, B, sizes.sensor_hw)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    E = mix["events_max"]
    batches = []
    for b in range(nb):
        counts = sizes_of(mix, T * B, rng)
        frames = (b * T + torch.arange(T, device=device, dtype=torch.float64))
        centres = start[None] + frames[:, None, None, None] * mix["drift_px"]  # (T, B, 3, 2)
        x, y, p, t, off = _events(mix, sizes.sensor_hw, counts, centres.reshape(T * B, 3, 2),
                                  gen, device)
        packed = torch.zeros((T * B, E, 4), dtype=torch.int32, device=device)
        for i in range(T * B):
            a, z = off[i], off[i + 1]
            packed[i, :z - a] = torch.stack((x[a:z], y[a:z], p[a:z], t[a:z]), dim=1).to(torch.int32)
        rep = stacked_histogram(packed, torch.from_numpy(counts).to(device), sizes.bins, h, w,
                                sizes.count_cutoff)
        ev = rep.reshape(T, B, h, w * sizes.in_ch).cpu().numpy()
        tidx = np.zeros((B, L), np.int32)
        fvalid = np.zeros((B, L), bool)
        boxes = np.zeros((B, L, G, 4), np.float32)
        classes = np.zeros((B, L, G), np.int32)
        gvalid = np.zeros((B, L, G), bool)
        for lane in range(B):
            n = rng.integers(1, L + 1)
            ts = np.sort(rng.choice(T, size=n, replace=False))
            tidx[lane, :n], fvalid[lane, :n] = ts, True
            for slot in range(n):
                k = rng.integers(1, 6)
                bw, bh = rng.uniform(12, W / 3, k), rng.uniform(12, H / 3, k)
                cx, cy = rng.uniform(bw / 2, W - bw / 2), rng.uniform(bh / 2, H - bh / 2)
                boxes[lane, slot, :k] = np.stack([cx, cy, bw, bh], axis=-1)
                classes[lane, slot, :k] = rng.integers(0, sizes.num_classes, k)
                gvalid[lane, slot, :k] = True
        batches.append(dict(ev_repr=ev, frame_tidx=tidx, frame_valid=fvalid, gt_boxes=boxes,
                            gt_classes=classes, gt_valid=gvalid, is_first=np.full((B,), b == 0)))
    return batches
