#!/usr/bin/env python3
"""bf16 parity gate of the PyTorch port: bf16 kernel-path audio vs f32 plain-path audio.

The port's counterpart of `parity.py`, with its workload (three texts, the 64-token
bucket, fixed durations 5, speaker zeros, exaggeration 0.5), its function
(`acoustic.forward`, then `tts.vocode`) and its gate: mel MSE < 1e-2, MCD < 1.0 dB,
multi-resolution STFT loss < 0.3. The reference is the f32 plain path; the
candidate is the bf16 path with both stack kernels on (`acoustic_pallas`,
`vocos_pallas`), as the engine serves on the card.

    python3 parity_gpu.py                   # on CUDA
    python3 parity_gpu.py --device cpu      # kernel wrappers run their plain versions

prints three JSON lines with parity.py's keys (`metric`, `mel_mse`, `mcd_db`,
`vocoder_mrstft`, `pass`), the weights, the device and each stack kernel's
launches during the line's bf16 run: the gate on a random init (seed 0), the gate
on the demo checkpoint, and the engine's bf16 two-stage audio graded against the
bf16 one-shot pipeline's (`one_shot`: `tts.synthesize` on the engine's weights)
on the demo checkpoint, at the same texts and bucket, with the same three metrics
(on the log-mels of the two audios). Exits 1 if a gate fails or, on CUDA, a line's
run launched either stack kernel no time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from gonova_tts_tpu_torch import ops
from gonova_tts_tpu_torch.audio.mel import mcd, mel_mse, mel_spectrogram
from gonova_tts_tpu_torch.config import ModelConfig
from gonova_tts_tpu_torch.device import resolve_device
from gonova_tts_tpu_torch.models import acoustic, params, tts
from gonova_tts_tpu_torch.text import text_to_ids
from gonova_tts_tpu_torch.train.losses import multi_resolution_stft_loss

TEXTS = [
    "The weather today looks bright and clear over the hills.",
    "Please remember to close the windows before you leave.",
    "Numbers like 42 and 3.14 get verbalized first.",
]
BUCKET = 64
DURATION = 5
MEL_MSE_LIMIT, MCD_LIMIT, MRSTFT_LIMIT = 1e-2, 1.0, 0.3
DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "checkpoints", "demo_ema_f16.npz")


def workload(cfg: ModelConfig):
    """parity.py's inputs: (tokens, mask, speaker, exaggeration, durations), numpy."""
    tokens = np.zeros((len(TEXTS), BUCKET), np.int32)
    mask = np.zeros((len(TEXTS), BUCKET), np.float32)
    for i, t in enumerate(TEXTS):
        ids = text_to_ids(t)[:BUCKET]
        tokens[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1.0
    spk = np.zeros((len(TEXTS), cfg.speaker_dim), np.float32)
    exagg = np.full((len(TEXTS),), 0.5, np.float32)
    dur = np.full(tokens.shape, DURATION, np.int32)
    return tokens, mask, spk, exagg, dur


def gate(mel_cand, mel_ref, wav_cand, wav_ref, metric: str = "parity_bf16_vs_f32") -> dict:
    """parity.py's metrics and pass rule on f32 tensors."""
    mse = float(mel_mse(mel_cand, mel_ref))
    mcd_db = float(mcd(mel_cand, mel_ref))
    mrstft = float(multi_resolution_stft_loss(wav_cand, wav_ref))
    return {
        "metric": metric,
        "mel_mse": round(mse, 6),
        "mcd_db": round(mcd_db, 4),
        "vocoder_mrstft": round(mrstft, 4),
        "pass": bool(mse < MEL_MSE_LIMIT and mcd_db < MCD_LIMIT and mrstft < MRSTFT_LIMIT),
    }


def run(model, cfg: ModelConfig, dtype, inputs):
    """acoustic.forward at the fixed durations, then tts.vocode: (mel, wav) in f32."""
    with torch.inference_mode():
        tokens, mask, spk, exagg, dur = inputs
        ac = acoustic.forward(model["acoustic"], tokens, mask, spk, exagg, cfg, durations=dur, dtype=dtype)
        wav = tts.vocode(model, ac["mel"], cfg, dtype=dtype)
        return ac["mel"].float(), wav.float()


STACKS = ("transformer_stack", "vocos_stack")


def stack_launches(fn):
    """(fn(), {stack kernel: launches during fn()})."""
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in STACKS}


def parity(model, cfg: ModelConfig) -> dict:
    """f32 plain path vs bf16 with both stack kernels, on `model`'s device."""
    dev = next(model.parameters()).device
    inputs = [torch.as_tensor(a, device=dev) for a in workload(cfg)]
    plain = cfg.model_copy(update={"acoustic_pallas": False, "vocos_pallas": False})
    kernels = cfg.model_copy(update={"acoustic_pallas": True, "vocos_pallas": True})
    mel_ref, wav_ref = run(model, plain, torch.float32, inputs)
    (mel_cand, wav_cand), launches = stack_launches(lambda: run(model, kernels, torch.bfloat16, inputs))
    return {**gate(mel_cand, mel_ref, wav_cand, wav_ref), "launches": launches}


def one_shot(engine, texts, speakers=None, exaggerations=None) -> list:
    """What `engine.synthesize_batch` returns, from the one-shot pipeline instead:
    `tts.synthesize` on the engine's weights (replica 0's) and the engine's batch
    inputs, every row decoded and vocoded at the token bucket's worst-case frame
    count, packed and unpacked as the engine packs its audio. One float32 waveform
    per text, each cut to its row's samples."""
    tokens, mask, spk, exagg, _, _ = engine._batch_inputs([text_to_ids(t) for t in texts], speakers, exaggerations)
    with torch.inference_mode():
        out = tts.synthesize(engine.params, *engine._tensors(tokens, mask, spk, exagg), engine.mcfg,
                             engine.compute_dtype)
        audio = engine._to_f32(engine._pack(out["audio"]).cpu().numpy())
        total = out["total_samples"].cpu().numpy()
    return [audio[i, : int(total[i])].astype(np.float32) for i in range(len(texts))]


def engine_parity(engine) -> dict:
    """The engine's bf16 two-stage audio vs the bf16 one-shot pipeline's
    (`one_shot`) at TEXTS: rows zero-padded to the longest, then the gate's metrics
    on their log-mels and audio. Rows of unequal length fail the line. `launches`
    counts the engine's pass alone."""
    one = one_shot(engine, TEXTS)
    two, launches = stack_launches(lambda: engine.synthesize_batch(TEXTS))
    same_lengths = [len(a) for a in one] == [len(b) for b in two]
    n = max(len(a) for a in one + two)

    def stack(rows):
        out = np.zeros((len(rows), n), np.float32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return torch.as_tensor(out, device=engine.device)

    m = engine.mcfg
    a_one, a_two = stack(one), stack(two)
    with torch.inference_mode():
        mel_one, mel_two = (
            mel_spectrogram(a, sr=m.sample_rate, n_fft=m.n_fft, hop_length=m.hop_length,
                            win_length=m.win_length, n_mels=m.n_mels, fmin=m.fmin, fmax=m.fmax)
            for a in (a_one, a_two)
        )
        out = gate(mel_two, mel_one, a_two, a_one, metric="parity_bf16_two_stage_vs_one_shot")
    out["max_abs_diff"] = float((a_two - a_one).abs().max())
    out["same_lengths"] = same_lengths
    out["pass"] = out["pass"] and same_lengths
    out["launches"] = launches
    return out


def demo_engine(device=None, cfg: Optional[ModelConfig] = None):
    """A TTSEngine on the demo checkpoint in bf16 with both stack kernels on,
    warmed up at the gate's bucket. `cfg` (default `ModelConfig()`) must fit the
    checkpoint."""
    from gonova_tts_tpu_torch.config import Config, EngineConfig
    from gonova_tts_tpu_torch.engine import TTSEngine

    full = Config()
    full.model = (cfg or ModelConfig()).model_copy(
        update={"model_path": DEMO, "compute_dtype": "bfloat16", "vocos_pallas": True}
    )
    full.engine = EngineConfig(acoustic_pallas=True, warmup_shapes=[[4, BUCKET]])
    engine = TTSEngine(full, device=device)
    engine.load(warmup=True)
    return engine


def main(argv=None, cfg: Optional[ModelConfig] = None) -> int:
    """`cfg` replaces `ModelConfig()` as the models' config (the CPU test passes a
    small one, with a checkpoint of that size in place of the demo's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = cfg or ModelConfig()
    weights = os.path.basename(DEMO)
    model = tts.TTS(cfg, torch.Generator().manual_seed(0)).to(dev)
    lines = [{**parity(model, cfg), "weights": "random seed 0"}]
    model, dcfg = params.load_checkpoint(DEMO, cfg, dev)
    lines.append({**parity(model, dcfg), "weights": weights})
    del model
    lines.append({**engine_parity(demo_engine(dev, cfg)), "weights": weights})
    for line in lines:
        line["device"] = str(dev)
        print(json.dumps(line), flush=True)
    launched = dev.type != "cuda" or all(n > 0 for line in lines for n in line["launches"].values())
    return 0 if launched and all(line["pass"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
