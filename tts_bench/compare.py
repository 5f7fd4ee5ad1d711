"""How far served audio lies from the reference's audio of the same sentence.

Served and reference audio are analysed alike (reference/audio.py's magnitudes and
mel filterbank), in decibels floored 60 dB below the reference sentence's loudest
mel bin. A duration rounded the other way in the served precision moves every later
frame by one, so the two frame sequences are aligned by dynamic time warping before
they are compared: the cost of a pair of frames is the mean over the mel bins of
their difference in dB. Along the alignment each reference frame gets the mean cost
of the frames it is paired with. Of a sentence this gives:

  * `gap_db`: the largest mean of those costs over `SPAN` consecutive reference
    frames (the worst stretch of about a phoneme);
  * `sum_db`, `ref_frames`: their sum over the sentence, and its reference frames
    (their quotient is the sentence's mean gap);
  * `frames`: the difference in length, in frames.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .reference import audio

SPAN = 4  # frames (4 * 256 samples at 24 kHz: 43 ms)
FLOOR_DB = 60.0


def mel_db(wav: np.ndarray, s: dict, device, peak=None):
    """(mel in dB [frames, n_mels], its floor reference peak) of float audio."""
    hop = s["hop_length"]
    x = torch.as_tensor(np.asarray(wav, np.float32)[: len(wav) // hop * hop], device=device)
    fb = torch.as_tensor(
        audio.mel_filterbank(s["sample_rate"], s["n_fft"], s["n_mels"], s["fmin"], s["fmax"]),
        dtype=torch.float32, device=device,
    )
    mel = audio.magnitudes(x, s["n_fft"], hop) @ fb
    if peak is None:
        peak = float(mel.max())
    return 20.0 * torch.log10(torch.clamp(mel, min=max(peak, 1e-6) * 10 ** (-FLOOR_DB / 20))), peak


def dtw_costs(cost: np.ndarray) -> np.ndarray:
    """Per column (reference frame) mean cost along the least-cost monotone
    alignment of a [served, reference] cost matrix (steps right, down, diagonal)."""
    n, m = cost.shape
    acc = np.empty((n, m))
    back = np.empty((n, m), dtype=np.int8)  # 0 diagonal, 1 from above, 2 from the left
    s = np.cumsum(cost[0])
    acc[0], back[0, 0], back[0, 1:] = s, 0, 2
    for i in range(1, n):
        diag = np.concatenate([[np.inf], acc[i - 1, :-1]])
        up = acc[i - 1]
        a = cost[i] + np.minimum(diag, up)
        # acc[i, j] = min(a[j], cost[i, j] + acc[i, j - 1]) in closed form:
        # S[j] + min_{k <= j} (a[k] - S[k]) with S the row's running sum.
        srow = np.cumsum(cost[i])
        run = np.minimum.accumulate(a - srow)
        acc[i] = srow + run
        from_left = np.concatenate([[False], (a - srow)[1:] > run[1:]])
        back[i] = np.where(from_left, 2, np.where(diag <= up, 0, 1))
    total = np.zeros(m)
    count = np.zeros(m)
    i, j = n - 1, m - 1
    while True:
        total[j] += cost[i, j]
        count[j] += 1
        if i == 0 and j == 0:
            break
        step = back[i, j]
        if i == 0:
            step = 2
        elif j == 0:
            step = 1
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return total / np.maximum(count, 1)


def sentence_gap(served: np.ndarray, ref: np.ndarray, s: dict, device) -> Dict[str, float]:
    """`gap_db`, `sum_db`, `ref_frames` and `frames` of one sentence (see the module
    docstring)."""
    hop = s["hop_length"]
    r_db, peak = mel_db(ref, s, device)
    s_db, _ = mel_db(served, s, device, peak)
    frames = abs(len(served) // hop - len(ref) // hop)
    if s_db.shape[0] == 0 or r_db.shape[0] == 0:
        return {"gap_db": float("inf"), "sum_db": float("inf"), "ref_frames": max(1, r_db.shape[0]), "frames": float(frames)}
    cost = (torch.cdist(s_db, r_db, p=1) / s_db.shape[1]).cpu().numpy().astype(np.float64)
    per_frame = dtw_costs(cost)
    span = min(SPAN, len(per_frame))
    window = np.convolve(per_frame, np.ones(span) / span, mode="valid")
    return {"gap_db": float(window.max()), "sum_db": float(per_frame.sum()), "ref_frames": len(per_frame),
            "frames": float(frames)}
