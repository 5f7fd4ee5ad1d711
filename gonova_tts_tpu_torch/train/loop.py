"""The training loop: dataset → train step → EMA checkpoints + metric logs.

Counterpart of `gonova_tts_tpu/train/loop.py`: the joint phase and, with
`gan=True`, the adversarial vocoder phase after it, on one device or sharded over
a ('data', 'model') mesh. Entry points: `gonova-tts-torch train` (cli.py) or
`python -m gonova_tts_tpu_torch.train.loop`. It runs on CUDA unless the caller
passes `device="cpu"`.

Sharding (`n_data > 1`, `n_model > 1`, or a multi-host launch under the
TTS_COORDINATOR / TTS_NUM_PROCESSES / TTS_PROCESS_ID contract of
`parallel/mesh.py::init_distributed`) runs one worker process per device: called
from a plain process, `train` starts them itself (`parallel/launch.py`: NCCL on
CUDA, gloo on the CPU, a `file://` store on one host), each worker runs `train`
inside the process group, and the call returns rank 0's metrics (every rank's are
the global batch's). On the CPU each worker process is one mesh position, whatever
the core count. Rank 0 gathers the parameters' blocks and writes the same f32
checkpoints as one device does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, load_config
from ..device import resolve_device
from ..engine import multi
from ..models import layers, tts, vocoder
from ..parallel import launch
from ..parallel import mesh as pmesh
from ..utils import get_logger
from . import step as tstep
from .checkpoint import save_params

logger = get_logger("gonova.train")


def _serve_params(ema):
    """An EMA shadow without the aligner: it exists to extract durations in
    training; serving never runs it."""
    return {k: v for k, v in ema.items() if not k.startswith("aligner.")}


def make_speaker_fn(params, mcfg):
    """(audio[T] f32 at any rate, sr) → speaker embedding from the (frozen)
    speaker encoder, with engine.embed_voice's static 10 s buffer and masked mean,
    so train-time conditioning matches serve-time cloning."""
    from ..audio.mel import mel_spectrogram
    from ..audio.resample import resample_np

    dev = next(params.parameters()).device
    max_samples = int(10.0 * mcfg.sample_rate)
    max_samples -= max_samples % mcfg.hop_length

    def speaker_fn(wav: np.ndarray, sr: int) -> np.ndarray:
        if sr != mcfg.sample_rate:
            wav = resample_np(np.asarray(wav, np.float32), sr, mcfg.sample_rate)
        n = min(len(wav), max_samples)
        buf = np.zeros((max_samples,), np.float32)
        buf[:n] = wav[:n]
        with torch.no_grad():
            mel = mel_spectrogram(
                torch.as_tensor(buf, device=dev)[None], sr=mcfg.sample_rate, n_fft=mcfg.n_fft,
                hop_length=mcfg.hop_length, win_length=mcfg.win_length,
                n_mels=mcfg.n_mels, fmin=mcfg.fmin, fmax=mcfg.fmax,
            )
            mask = (torch.arange(mel.shape[1], device=dev)[None] < n // mcfg.hop_length).float()
            return tts.embed_speaker(params, mel, mask)[0].cpu().numpy()

    return speaker_fn


def _launch_workers(args: dict, dev: torch.device) -> dict:
    """Run `train(**args)` in this host's workers, one per mesh position, inside one
    process group; returns the metrics of this host's first worker.

    Multi-host (TTS_COORDINATOR set): one worker per local device, joining the
    coordinator (`init_distributed`). One host: n_data x n_model workers, `n_data`
    None resolved as `make_mesh` resolves it, over `multi.local_devices`; on the CPU
    an explicit `n_data` is not bounded by them (each worker process is a position)."""
    devices = multi.local_devices(dev)
    if os.environ.get("TTS_COORDINATOR"):
        return launch.spawn(_train_worker, len(devices), dev.type, args, multi_host=True)[0]
    n_data, n_model = args["n_data"], args["n_model"]
    if dev.type == "cpu" and n_data is not None:
        devices = [dev] * (n_data * n_model)
    n_data, n_model = pmesh.mesh_shape(n_data, n_model, len(devices))
    return launch.spawn(_train_worker, n_data * n_model, dev.type, {**args, "n_data": n_data})[0]


def _train_worker(args: dict) -> dict:
    return train(**args)


def train(
    config: Optional[Config] = None,
    manifest: Optional[str] = None,
    steps: int = 1000,
    batch_size: int = 8,
    lr: float = 2e-4,
    warmup: int = 1000,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 500,
    n_data: Optional[int] = None,
    n_model: int = 1,
    seed: int = 0,
    ema_decay: float = 0.999,
    speaker_conditioning: bool = True,
    resident: bool = False,
    chunk: int = 50,
    history_path: Optional[str] = None,
    learn_alignment: Optional[bool] = None,
    gan: bool = False,
    gan_steps: Optional[int] = None,
    gan_lr: float = 2e-4,
    device=None,
) -> dict:
    """Run `steps` optimization steps; returns the final metrics.

    `resident=True` stacks the whole (small) manifest corpus on the device and
    runs `chunk` steps a call (step.make_resident_train_chunk). `history_path`
    appends one JSON line of metrics per logging point. `learn_alignment` None =
    auto: learned in the step (MAS aligner) when the manifest has no duration
    column. Checkpoints are the zero-seeded, debiased EMA without the aligner,
    `checkpoint_dir/step_NNNNNNNN.npz` in f32.

    `gan=True` (needs a manifest) appends the adversarial vocoder phase (HiFi-GAN
    objective: MPD and MSD critics, LSGAN + feature matching + 45 x mel L1) for
    `gan_steps` (default `steps`) d/g pairs at `gan_lr`: the joint EMA is saved at
    `steps` first (the baseline the phase is graded against), only the vocoder
    trains, and its debiased EMA replaces the vocoder in the checkpoint at
    `steps + gan_steps`. `device` defaults to `config.model.device`.

    `n_data`/`n_model` > 1 or a multi-host launch shard both phases over a mesh
    (the module docstring); `resident` is single-device and refuses them."""
    args = dict(locals())
    if gan and not manifest:
        raise ValueError("adversarial training needs a manifest corpus")
    distributed = bool(os.environ.get("TTS_COORDINATOR")) or dist.is_initialized()
    use_mesh = (n_data or 0) > 1 or n_model > 1 or distributed
    if resident and use_mesh:
        # Never silently drop requested parallelism: the resident chunk runner is
        # single-device by construction.
        raise ValueError(
            "resident mode is single-device; drop --resident to train with "
            f"n_data={n_data}/n_model={n_model} sharding"
        )
    config = config or load_config()
    dev = resolve_device(device if device is not None else config.model.device)
    if use_mesh and not dist.is_initialized():
        return _launch_workers(args, dev)
    mesh = None
    if use_mesh:
        multi_host = pmesh.n_hosts() > 1
        mesh = pmesh.make_hybrid_mesh(n_model=n_model) if multi_host else pmesh.make_mesh(n_data, n_model)
        dev = pmesh.rank_device()
    lead = mesh is None or dist.get_rank() == 0  # logs, history, checkpoints
    # Training runs the plain layers: the kernels have no backward.
    mcfg = config.model.model_copy(update={"acoustic_pallas": False, "vocos_pallas": False})
    if resident and steps % chunk != 0:
        # The chunk runner executes whole chunks; round the budget up front so the
        # step accounting (logs, schedule, checkpoint names) matches what runs.
        rounded = ((steps + chunk - 1) // chunk) * chunk
        logger.info("steps_rounded_to_chunk", requested=steps, actual=rounded)
        steps = rounded
    manifest_entries = None
    if manifest:
        from .data import load_manifest

        manifest_entries = load_manifest(manifest)
    if learn_alignment is None:
        learn_alignment = manifest_entries is not None and not any(
            "durations" in e for e in manifest_entries
        )
    elif learn_alignment and not manifest:
        raise ValueError(
            "--learn-alignment requires --manifest: alignment is learned from "
            "(text, audio) pairs; synthetic batches have no audio features"
        )
    model = tts.TTS(mcfg, torch.Generator().manual_seed(seed), with_aligner=learn_alignment).to(dev)
    # Cosine decay over the actual run length: a short run otherwise sits at peak
    # learning rate for its whole duration.
    optimizer = tstep.make_optimizer(lr=lr, warmup=warmup, decay_steps=max(steps, warmup + 1))
    state = tstep.init_state(model, optimizer)

    t_prep = time.perf_counter()
    if manifest:
        from .data import ManifestDataset

        if resident:
            # One stacked [N, ...] corpus: every batch takes the smallest bucket
            # that fits the corpus' longest sentence.
            from ..text import pick_bucket, text_to_ids

            longest = max(len(text_to_ids(e["text"])) for e in manifest_entries)
            buckets = (pick_bucket(longest, config.engine.token_buckets),)
        else:
            buckets = tuple(config.engine.token_buckets)
        dataset = ManifestDataset(
            manifest, mcfg, batch_size=batch_size, token_buckets=buckets, seed=seed,
            ref_mel=speaker_conditioning, learn_alignment=learn_alignment,
            entries=manifest_entries,
        )
        logger.info("alignment_mode", learned=learn_alignment)

        def batches():
            epoch = 0
            while True:
                yield from dataset.epoch(epoch)
                epoch += 1
    else:
        synthetic = tstep.synthetic_batch(mcfg, batch=batch_size, tokens=32, seed=seed, device=dev)

        def batches():
            while True:
                yield synthetic

    history = None
    if history_path and lead:
        os.makedirs(os.path.dirname(os.path.abspath(history_path)), exist_ok=True)
        history = open(history_path, "a")

    def log_point(step_no, metrics, t0):
        vals = {k: round(float(v), 5) for k, v in metrics.items()}
        elapsed = time.perf_counter() - t0
        if not lead:
            return
        logger.info(
            "train_step", step=step_no, total=vals["total"], mel=vals["ac_mel"],
            stft=vals["stft"], steps_per_sec=round(step_no / elapsed, 2), elapsed_s=elapsed,
        )
        if history:
            history.write(json.dumps({"step": step_no, **vals}) + "\n")
            history.flush()

    split_dims = {}  # a sharded state's {name: split dimension}

    def save(snap, n_updates, kind="ema"):
        if mesh is not None:  # every rank gathers (collective); rank 0 writes
            snap = pmesh.gather_params(snap, split_dims)
        if lead:
            path = save_params(checkpoint_dir, _serve_params(snap), step=n_updates)
            logger.info("checkpoint_saved", path=path, kind=kind)
        if mesh is not None:
            dist.barrier()

    try:
        metrics = {}
        if resident:
            if not manifest:
                raise ValueError("resident mode needs a manifest corpus")
            # One epoch's batches, a fixed grouping, cycled.
            epoch_batches = list(dataset.epoch(0))
            logger.info(
                "resident_corpus", batches=len(epoch_batches),
                bucket=int(epoch_batches[0]["tokens"].shape[1]),
                prep_s=time.perf_counter() - t_prep,
            )
            run_chunk, corpus = tstep.make_resident_train_chunk(
                mcfg, epoch_batches, chunk=chunk, ema_decay=ema_decay,
                learn_alignment=learn_alignment, device=dev,
            )
            # Zero-seeded, debiased EMA: a params-seeded shadow would keep
            # decay^t of the random init in every checkpoint.
            ema = tstep.ema_init_zeros(state.params)
            t0 = time.perf_counter()
            done = 0
            while done < steps:
                state, ema, metrics = run_chunk(state, ema, done, corpus)
                done += chunk
                log_point(done, metrics, t0)
                if checkpoint_dir and done % checkpoint_every < chunk and done < steps:
                    save(tstep.ema_debias(ema, ema_decay, done), done)
        else:
            if mesh is not None:
                example = next(iter(batches()))
                step_fn, state = tstep.make_sharded_train_step(
                    mcfg, optimizer, mesh, state, example, learn_alignment=learn_alignment
                )
                split_dims = pmesh.split_dims(state.params)
                logger.info("train_sharded", mesh=list(mesh.shape), rank=dist.get_rank())
            else:
                step_fn = tstep.make_train_step(mcfg, learn_alignment=learn_alignment)
            ema = tstep.ema_init_zeros(state.params)
            t0 = time.perf_counter()
            for i, batch in enumerate(batches()):
                if i >= steps:
                    break
                batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
                state, metrics = step_fn(state, batch)
                ema = tstep.ema_update(ema, state.params, ema_decay)
                if (i + 1) % 50 == 0 or i == 0:
                    log_point(i + 1, metrics, t0)
                if checkpoint_dir and (i + 1) % checkpoint_every == 0:
                    save(tstep.ema_debias(ema, ema_decay, i + 1), i + 1)
        # From here on the joint EMA is read (baseline save, GAN merge, final
        # save): its bias-corrected form, once.
        ema = tstep.ema_debias(ema, ema_decay, steps)
        metrics = {k: float(v) for k, v in metrics.items()}
        n_gan = 0
        if gan:
            n_gan = gan_steps or steps
            if resident and n_gan % chunk != 0:
                n_gan = ((n_gan + chunk - 1) // chunk) * chunk
            if checkpoint_dir:
                # The joint-phase EMA is the L1-only baseline the GAN result is
                # graded against; persist it before the vocoder diverges.
                save(ema, steps, kind="ema_pre_gan")
            gm = _gan_phase(
                state, mcfg, n_gan, gan_lr, seed, ema_decay, chunk,
                epoch_batches if resident else None, batches, dev, history, ema, mesh,
            )
            metrics.update({f"gan_{k}": float(v) for k, v in gm.items()})
        if checkpoint_dir:
            save(ema, steps + n_gan)
    finally:
        if history:
            history.close()
    return metrics


def _gan_phase(
    state, mcfg, n_gan, gan_lr, seed, ema_decay, chunk, epoch_batches, batches, dev, history, ema, mesh=None,
):
    """`n_gan` discriminator/generator step pairs on the trained vocoder; its
    debiased EMA replaces `ema`'s vocoder entries in place. Resident when
    `epoch_batches` is given (`chunk` pairs a call), else per step from `batches()`,
    sharded over `mesh` when there is one. Returns the last logged metrics (chunk
    means when resident)."""
    opt = dict(lr=gan_lr, warmup=min(200, max(n_gan // 10, 1)), decay_steps=max(n_gan, 2))
    g_opt, d_opt = tstep.make_optimizer(**opt), tstep.make_optimizer(**opt)
    # The generator is the trained vocoder subtree only: the acoustic and speaker
    # weights get no adversarial gradient, and AdamW's decay would erode them.
    gen_state = tstep.init_state(layers.group(vocoder=state.params.vocoder), g_opt)
    critics = vocoder.discriminators_init(
        torch.Generator().manual_seed(seed + 101), torch.Generator().manual_seed(seed + 102),
        width=mcfg.disc_width,
    ).to(dev)
    disc_state = tstep.init_state(critics, d_opt)
    lead = mesh is None or dist.get_rank() == 0
    if lead:
        logger.info("gan_phase_start", steps=n_gan, lr=gan_lr)

    def log_gan(step_no, gm, t0):
        vals = {k: round(float(v), 5) for k, v in gm.items()}
        if not lead:
            return
        logger.info("gan_step", step=step_no, elapsed_s=time.perf_counter() - t0, **vals)
        if history:
            history.write(json.dumps({"phase": "gan", "step": step_no, **vals}) + "\n")
            history.flush()

    if mesh is not None:
        # The adversarial phase shards over the mesh too: never silently drop
        # requested parallelism.
        d_step, g_step, gen_state, disc_state = tstep.make_sharded_gan_steps(
            mcfg, g_opt, d_opt, mesh, gen_state, disc_state
        )
    elif epoch_batches is None:
        d_step, g_step = tstep.make_gan_steps(mcfg)
    ema_voc = tstep.ema_init_zeros(gen_state.params)
    gm = {}
    t0 = time.perf_counter()
    if epoch_batches is not None:
        run_gan, corpus = tstep.make_resident_gan_chunk(
            mcfg, epoch_batches, chunk=chunk, ema_decay=ema_decay, device=dev
        )
        done = 0
        while done < n_gan:
            gen_state, disc_state, ema_voc, gm = run_gan(gen_state, disc_state, ema_voc, done, corpus)
            done += chunk
            log_gan(done, gm, t0)
    else:
        for i, batch in enumerate(batches()):
            if i >= n_gan:
                break
            mel, audio, fmask = (torch.as_tensor(batch[k]).to(dev) for k in ("mel", "audio", "frame_mask"))
            disc_state, d_loss = d_step(disc_state, gen_state.params, mel, audio)
            gen_state, g_metrics = g_step(gen_state, disc_state.params, mel, audio, fmask)
            ema_voc = tstep.ema_update(ema_voc, gen_state.params, ema_decay)
            gm = {"d": d_loss, **g_metrics}
            if (i + 1) % 50 == 0 or i == 0:
                log_gan(i + 1, gm, t0)
    # The adversarially trained vocoder's EMA (debiased) replaces the joint
    # phase's vocoder in the serving weights.
    ema.update(tstep.ema_debias(ema_voc, ema_decay, gen_state.step))
    return gm


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="train the gonova TTS pipeline (PyTorch port)")
    ap.add_argument("--manifest", default=None, help="wav|text manifest (default: synthetic batch)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=1000)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--n-data", type=int, default=None)
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--config", default=None)
    ap.add_argument("--resident", action="store_true",
                    help="device-resident corpus, `--chunk` steps a call (small corpora)")
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--no-speaker-conditioning", action="store_true")
    ap.add_argument("--history", default=None, help="append per-interval metrics JSONL here")
    ap.add_argument("--learn-alignment", dest="learn_alignment", action="store_true",
                    default=None, help="force MAS alignment learning on")
    ap.add_argument("--no-learn-alignment", dest="learn_alignment", action="store_false",
                    help="force the uniform-duration bootstrap (default: auto — learn "
                         "alignment when the manifest has no duration column)")
    ap.add_argument("--gan", action="store_true",
                    help="adversarial vocoder fine-tune after the joint phase")
    ap.add_argument("--gan-steps", type=int, default=None)
    ap.add_argument("--gan-lr", type=float, default=2e-4)
    args = ap.parse_args(argv)
    out = train(
        config=load_config(args.config),
        manifest=args.manifest,
        steps=args.steps,
        batch_size=args.batch_size,
        lr=args.lr,
        warmup=args.warmup,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        n_data=args.n_data,
        n_model=args.n_model,
        resident=args.resident,
        chunk=args.chunk,
        speaker_conditioning=not args.no_speaker_conditioning,
        history_path=args.history,
        learn_alignment=args.learn_alignment,
        gan=args.gan,
        gan_steps=args.gan_steps,
        gan_lr=args.gan_lr,
    )
    print(out)


if __name__ == "__main__":
    main()
