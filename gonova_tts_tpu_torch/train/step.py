"""Train steps: the joint TTS loss under autograd, optax's optimizer in torch.optim.

Counterpart of `gonova_tts_tpu/train/step.py`: the joint step and the adversarial
(HiFi-GAN) phase's discriminator and generator steps, on one device or sharded
over a ('data', 'model') mesh (`parallel/mesh.py`). Steps run the plain PyTorch
layers: the CUDA kernels of `ops/` (like the JAX package's Pallas kernels) have no
backward, so a config with either kernel switch on is refused and a step launches
no kernel.

Sharded, each rank is one process on one device. It takes its contiguous block of
the global batch's rows, holds its block of every parameter the rules shard over
'model' (the layers run tensor-parallel, `parallel/tp.py`), computes the global
loss (the losses' batch reductions all-reduced over 'data') and sums the gradients
over 'data' before the optimizer; AdamW's moments follow their parameters.

The optimizer is the JAX package's `optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule, b1=0.9, b2=0.98, weight_decay=0.01))`:

  * the clip is written here, as optax defines it: g * (max_norm / ||g||) when
    ||g|| >= max_norm, with no epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6);
  * `torch.optim.AdamW` is optax's adamw update (decay of the old parameter, eps
    outside the square root after bias correction), over ONE parameter group, so
    the decay applies to every leaf; a leaf without a gradient gets a zero one,
    as in JAX, so its moments and decay still move;
  * the schedule is optax's, evaluated at the update count from 0 (the first
    update has learning rate schedule(0) = 0), through `LambdaLR`.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..models import acoustic, aligner, layers, tts, vocoder
from ..parallel import mesh as pmesh
from ..parallel import tp
from . import losses
from ._jax_prng import crop_offset


@dataclass(frozen=True)
class Optimizer:
    """The optimizer's hyperparameters; `init` builds its state over a model."""

    lr: float = 2e-4
    weight_decay: float = 0.01
    warmup: int = 1000
    decay_steps: int = 500_000
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-8
    max_norm: float = 1.0

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0 → lr over `warmup` updates, then
        cosine to 0.05 * lr at `decay_steps`)."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        steps = self.decay_steps - self.warmup
        t = min(count - self.warmup, steps)
        alpha = 0.05
        return self.lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / steps)) + alpha)

    def init(self, params: Sequence[nn.Parameter]) -> "OptState":
        return OptState(self, list(params))


class OptState:
    """AdamW and its schedule over one parameter group, with the global-norm clip."""

    def __init__(self, optimizer: Optimizer, params: List[nn.Parameter]):
        self.optimizer = optimizer
        self.params = params
        self.adamw = torch.optim.AdamW(
            params, lr=optimizer.lr, betas=(optimizer.b1, optimizer.b2), eps=optimizer.eps,
            weight_decay=optimizer.weight_decay,
        )
        self.lr_schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: optimizer.schedule(count) / optimizer.lr
        )

    def zero_grad(self) -> None:
        for p in self.params:
            if p.grad is not None:
                p.grad.zero_()

    def update(self) -> None:
        """Clip the gradients by their global norm, take one AdamW step, advance
        the schedule. No host synchronization."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.sync_grads()
        self.apply()

    def sync_grads(self) -> None:
        """One device: the gradients are complete."""

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        return global_norm(grads)

    def apply(self) -> None:
        grads = [p.grad for p in self.params]
        clip_by_global_norm_(grads, self.grad_norm(grads), self.optimizer.max_norm)
        self.adamw.step()
        self.lr_schedule.step()


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all the tensors together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * (max_norm / norm) when norm >= max_norm."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class ShardedOptState(OptState):
    """OptState of one rank of a mesh: the gradients summed over 'data' first, and
    the clip's global norm over the whole model, each sharded leaf's squared norm
    summed over 'model' and each replicated leaf counted once."""

    def __init__(self, optimizer: Optimizer, params: List[nn.Parameter], mesh):
        super().__init__(optimizer, params)
        sizes = pmesh.axis_sizes(mesh)
        self.n_data, self.n_model = sizes[pmesh.DATA_AXIS], sizes[pmesh.MODEL_AXIS]
        self.data_group = mesh.get_group(pmesh.DATA_AXIS) if self.n_data > 1 else None
        self.model_group = mesh.get_group(pmesh.MODEL_AXIS) if self.n_model > 1 else None

    def sync_grads(self) -> None:
        if self.n_data == 1:
            return
        grads = [p.grad for p in self.params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)])

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        def squared(gs):
            if not gs:
                return torch.zeros((), device=grads[0].device)
            return torch.stack(torch._foreach_norm(gs)).square().sum()

        split = squared([g for p, g in zip(self.params, grads) if tp.split_dim(p) is not None])
        if self.n_model > 1:
            dist.all_reduce(split, group=self.model_group)
        return torch.sqrt(split + squared([g for p, g in zip(self.params, grads) if tp.split_dim(p) is None]))


def make_optimizer(
    lr: float = 2e-4,
    weight_decay: float = 0.01,
    warmup: int = 1000,
    decay_steps: int = 500_000,
) -> Optimizer:
    return Optimizer(lr=lr, weight_decay=weight_decay, warmup=warmup, decay_steps=decay_steps)


@dataclass
class TrainState:
    """The model (trained in place), its optimizer state and the update count."""

    params: tts.TTS
    opt_state: OptState
    step: int = 0


def init_state(params: tts.TTS, optimizer: Optimizer) -> TrainState:
    """Turn gradients on for `params` (parameters are built frozen) and build the
    optimizer state over all of them."""
    params.requires_grad_(True)
    params.train()
    return TrainState(params=params, opt_state=optimizer.init(params.parameters()), step=0)


# ---------------------------------------------------------------- joint TTS step


# Diagonal-prior anneal for alignment learning (aligner.diagonal_prior): full
# strength at step 0, linearly off by ALIGN_PRIOR_STEPS. Without it the
# forward-sum objective stalls in off-diagonal optima.
ALIGN_PRIOR_SIGMA = 0.12
ALIGN_PRIOR_STEPS = 2000


def tts_loss_fn(
    params: Mapping,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    dtype=torch.float32,
    learn_alignment: bool = False,
    align_step: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Joint acoustic + vocoder loss on a supervised batch.

    batch keys: tokens [B,L], token_mask [B,L], speaker [B,S], exaggeration [B],
    durations [B,L], pitch [B,L], mel [B,T,n_mels], frame_mask [B,T], audio [B,T*hop];
    optional ref_mel [B,T_ref,n_mels] + ref_mask [B,T_ref] (the speaker embedding is
    then computed in the step, so the speaker encoder trains jointly); with
    learn_alignment, pitch_frames [B,T] and optionally align_mel [B,T,n_mels].

    learn_alignment=True: duration targets come from MAS over the aligner's scores
    (detached), the forward-sum and bin losses train the aligner, and pitch
    targets are re-pooled per token under the MAS segmentation."""
    if "ref_mel" in batch:
        spk = tts.embed_speaker(params, batch["ref_mel"], batch["ref_mask"], dtype=dtype)
    else:
        spk = batch["speaker"]
    align_metrics: Dict[str, torch.Tensor] = {}
    l_align = 0.0
    if learn_alignment:
        w = 1.0 if align_step is None else min(max(1.0 - float(align_step) / ALIGN_PRIOR_STEPS, 0.0), 1.0)
        prior = w * aligner.diagonal_prior(batch["token_mask"], batch["frame_mask"], sigma=ALIGN_PRIOR_SIGMA)
        log_p = aligner.log_probs(
            params["aligner"], batch["tokens"], batch.get("align_mel", batch["mel"]),
            batch["token_mask"], dtype, prior=prior, frame_mask=batch["frame_mask"],
        )
        l_fs = aligner.forward_sum_loss(log_p, batch["token_mask"], batch["frame_mask"])
        durations = aligner.mas_durations(log_p.detach(), batch["token_mask"], batch["frame_mask"])
        l_bin = aligner.bin_loss(log_p, durations, batch["frame_mask"])
        pitch_tok = aligner.token_pitch(batch["pitch_frames"], durations, batch["frame_mask"])
        l_align = l_fs + 0.1 * l_bin
        # Serving clamps predicted durations to max_frames_per_token: report the
        # share of real tokens whose MAS target is above that cap.
        real_tok = batch["token_mask"] > 0
        over_cap = (durations > cfg.max_frames_per_token) & real_tok
        align_metrics = {
            "align_fs": l_fs,
            "align_bin": l_bin,
            "dur_over_cap": tp.global_sum(over_cap.sum().float())
            / torch.clamp(tp.global_sum(real_tok.sum().float()), min=1.0),
        }
    else:
        durations = batch["durations"]
        pitch_tok = batch["pitch"]
    ac = acoustic.forward(
        params["acoustic"], batch["tokens"], batch["token_mask"], spk, batch["exaggeration"], cfg,
        durations=durations, dtype=dtype,
    )
    l_ac, ac_parts = losses.acoustic_loss(ac, batch["mel"], durations, pitch_tok, batch["token_mask"])
    # The vocoder trains on the ground-truth mel (teacher forcing), per HiFi-GAN.
    wav_pred = tts.vocode(params, batch["mel"], cfg, dtype=dtype)
    l_stft = losses.multi_resolution_stft_loss(wav_pred, batch["audio"])
    l_vmel = losses.mel_reconstruction_loss(wav_pred, batch["mel"], batch["frame_mask"], cfg)
    total = l_ac + l_stft + 5.0 * l_vmel + l_align
    metrics = {
        **{f"ac_{k}": v for k, v in ac_parts.items()},
        **align_metrics,
        "stft": l_stft,
        "voc_mel": l_vmel,
        "total": total,
    }
    return total, metrics


def _refuse_kernels(cfg: ModelConfig) -> None:
    if cfg.acoustic_pallas or cfg.vocos_pallas:
        raise ValueError(
            "training runs the plain layers: the acoustic_pallas/vocos_pallas kernels "
            "have no backward; turn both off in the training config"
        )


def make_train_step(cfg: ModelConfig, dtype=torch.float32, learn_alignment: bool = False):
    """`train_step(state, batch) -> (state, metrics)`: one update of `state` in
    place, after which the model's kernel-weight memos (`layers.cached`) are
    dropped. Metrics stay on the device (detached); reading one synchronizes."""
    _refuse_kernels(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return _train_update(state, batch, cfg, dtype, learn_alignment)

    return train_step


def _train_update(state: TrainState, batch, cfg, dtype, learn_alignment):
    state.opt_state.zero_grad()
    loss, metrics = tts_loss_fn(state.params, batch, cfg, dtype, learn_alignment, align_step=state.step)
    loss.backward()
    state.opt_state.update()
    layers.clear_derived(state.params)  # kernel-weight memos of the old parameters
    state.step += 1
    return state, {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------- sharded steps


def _state_shardings(state: TrainState, mesh) -> Dict[str, Tuple]:
    """{parameter name: axis tuple} of the state's parameters, by the mesh rules.
    AdamW's moments follow their parameters (`_place_state`), the step count and
    the schedule are replicated. Keyed by name, as the JAX package matches the
    moment trees by structure: same-shaped parameters can carry different specs."""
    return pmesh.param_shardings(state.params, mesh)


def _place_state(state: TrainState, mesh, optimizer: Optimizer) -> TrainState:
    """The state on this rank: its blocks of the parameters (`shard_params`), a
    ShardedOptState over them with each AdamW moment cut like its parameter, and
    the schedule's count."""
    model = pmesh.shard_params(state.params, mesh, specs=_state_shardings(state, mesh))
    model.requires_grad_(True)
    model.train()
    opt_state = ShardedOptState(optimizer, list(model.parameters()), mesh)
    old = state.opt_state
    for p_old, p_new in zip(old.params, opt_state.params):
        moments = old.adamw.state.get(p_old)
        if not moments:
            continue
        dim = tp.split_dim(p_new)
        cut = dim is not None and tp.split_dim(p_old) is None
        opt_state.adamw.state[p_new] = {
            k: (tp.own_slice(v, dim) if cut and v.ndim else v.clone()).to(p_new.device) for k, v in moments.items()
        }
    opt_state.lr_schedule.load_state_dict(old.lr_schedule.state_dict())
    for g in opt_state.adamw.param_groups:
        g["lr"] = old.adamw.param_groups[0]["lr"]
    return TrainState(params=model, opt_state=opt_state, step=state.step)


def _data_parallel(mesh):
    """The context in which a rank's losses are the global batch's."""
    n = pmesh.axis_sizes(mesh)[pmesh.DATA_AXIS]
    if n == 1:
        return nullcontext
    group = mesh.get_group(pmesh.DATA_AXIS)
    return lambda: tp.data_parallel(group, n)


def make_sharded_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    mesh,
    state: TrainState,
    batch_example: Mapping[str, torch.Tensor],
    dtype=torch.float32,
    learn_alignment: bool = False,
):
    """The train step of one rank of `mesh`. Returns (sharded_step, sharded_state):
    `sharded_step(state, batch)` takes the GLOBAL batch (every rank the same rows,
    as `batch_example`'s batch size) and uses its own block of rows; the metrics are
    the global batch's, the same on every rank."""
    _refuse_kernels(cfg)
    placed = _place_state(state, mesh, optimizer)
    rows = pmesh.local_rows(mesh, len(next(iter(batch_example.values()))))
    data_parallel = _data_parallel(mesh)

    def sharded_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with data_parallel():
            return _train_update(state, {k: v[rows] for k, v in batch.items()}, cfg, dtype, learn_alignment)

    return sharded_step, placed


# ------------------------------------------------------- device-resident trainer


def make_resident_train_chunk(
    cfg: ModelConfig,
    batches: Sequence[Dict[str, np.ndarray]],
    chunk: int = 50,
    ema_decay: float = 0.999,
    dtype=torch.float32,
    learn_alignment: bool = False,
    device=None,
):
    """`chunk` optimization steps a call over a corpus resident on the device.

    The whole (small) corpus is stacked once ([N, ...] leading batch axis) and
    copied to `device` (CUDA unless the caller asks for the CPU); a call runs
    `chunk` steps cycling a fixed grouping with a modular index and updates the EMA
    after each, with no host synchronization: the metrics come back as device
    tensors, averaged over the chunk.

    Returns (run_chunk, stacked) where
      run_chunk(state, ema, start_step, corpus) -> (state, ema, mean_metrics).
    All batches must share one (bucket, frame-cap) shape."""
    dev = resolve_device(device)
    stacked = {
        k: torch.as_tensor(np.stack([np.asarray(b[k]) for b in batches])).to(dev) for k in batches[0]
    }
    n = len(batches)
    step_fn = make_train_step(cfg, dtype, learn_alignment)

    def run_chunk(state: TrainState, ema, start: int, corpus):
        acc: Dict[str, torch.Tensor] = {}
        for i in range(chunk):
            batch = {k: v[(start + i) % n] for k, v in corpus.items()}
            state, metrics = step_fn(state, batch)
            ema = ema_update(ema, state.params, ema_decay)
            acc = metrics if not acc else {k: acc[k] + v for k, v in metrics.items()}
        return state, ema, {k: v / chunk for k, v in acc.items()}

    return run_chunk, stacked


# ---------------------------------------------------------------- GAN steps (vocoder)


GAN_SEGMENT_SAMPLES = 8192  # HiFi-GAN trains its discriminators on ~0.34 s crops
_CRITICS = ((vocoder.mpd_apply, "mpd"), (vocoder.msd_apply, "msd"))


def _crop_pair(real: torch.Tensor, fake: torch.Tensor, step: int):
    """The same GAN_SEGMENT_SAMPLES crop of both signals. Its offset is the JAX
    package's draw for this step (`_jax_prng.crop_offset`), so both packages train
    on the same samples; a signal no longer than the segment is not cropped."""
    t = real.shape[1]
    seg = min(GAN_SEGMENT_SAMPLES, t)
    if seg == t:
        return real, fake
    off = crop_offset(int(step), t - seg + 1)
    return real[:, off : off + seg], fake[:, off : off + seg]


def _gan_loss_fns(cfg: ModelConfig, dtype=torch.float32):
    """(d_loss_fn, g_loss_fn) of the adversarial phase.

    The adversarial and feature-matching terms run on a per-step crop of
    GAN_SEGMENT_SAMPLES (segment training, as in the paper); the mel-reconstruction
    term stays full-length, on the plain log-mel. The discriminator loss sees the
    generator's audio without its gradient."""

    def d_loss_fn(disc_params, gen_params, mel, audio_real, step):
        with torch.no_grad():
            audio_fake = tts.vocode(gen_params, mel, cfg, dtype=dtype)
        audio_real, audio_fake = _crop_pair(audio_real, audio_fake, step)
        loss = 0.0
        for apply_fn, key in _CRITICS:
            real_outs = apply_fn(disc_params[key], audio_real, dtype=dtype)
            fake_outs = apply_fn(disc_params[key], audio_fake, dtype=dtype)
            loss = loss + losses.lsgan_discriminator_loss(real_outs, fake_outs)
        return loss

    def g_loss_fn(gen_params, disc_params, mel, audio_real, frame_mask, step):
        audio_fake = tts.vocode(gen_params, mel, cfg, dtype=dtype)
        adv = 0.0
        fm = 0.0
        real_seg, fake_seg = _crop_pair(audio_real, audio_fake, step)
        for apply_fn, key in _CRITICS:
            with torch.no_grad():  # the real audio's taps are constants of this loss
                real_outs = apply_fn(disc_params[key], real_seg, dtype=dtype)
            fake_outs = apply_fn(disc_params[key], fake_seg, dtype=dtype)
            adv = adv + losses.lsgan_generator_loss(fake_outs)
            fm = fm + losses.feature_matching_loss(real_outs, fake_outs)
        # HiFi-GAN eq(7): L_G = L_adv + 2 L_fm + 45 L_mel (the mel L1 is also the
        # metric the checkpoint eval grades).
        l_mel = losses.mel_reconstruction_loss(audio_fake, mel, frame_mask, cfg)
        total = adv + 2.0 * fm + 45.0 * l_mel
        return total, {"adv": adv, "fm": fm, "mel": l_mel}

    return d_loss_fn, g_loss_fn


def _apply_grads(state: TrainState, loss: torch.Tensor) -> None:
    """Gradients of `loss` for `state`'s parameters alone (the other network's
    weights get none), one optimizer update, and the step count."""
    params = state.opt_state.params
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = g
    state.opt_state.update()
    layers.clear_derived(state.params)
    state.step += 1


def make_gan_steps(cfg: ModelConfig, dtype=torch.float32):
    """The adversarial phase's alternating steps:

      d_step(disc_state, gen_params, mel, audio_real) -> (disc_state, d_loss)
      g_step(gen_state, disc_params, mel, audio_real, frame_mask) -> (gen_state, metrics)

    The generator's state holds the `{"vocoder"}` subtree only; the discriminators'
    holds `{"mpd", "msd"}`. Each step updates its state in place; the crop offset
    follows that state's own step count, as in the JAX package."""
    _refuse_kernels(cfg)
    d_loss_fn, g_loss_fn = _gan_loss_fns(cfg, dtype)

    def d_step(disc_state: TrainState, gen_params, mel, audio_real):
        loss = d_loss_fn(disc_state.params, gen_params, mel, audio_real, disc_state.step)
        _apply_grads(disc_state, loss)
        return disc_state, loss.detach()

    def g_step(gen_state: TrainState, disc_params, mel, audio_real, frame_mask):
        loss, metrics = g_loss_fn(gen_state.params, disc_params, mel, audio_real, frame_mask, gen_state.step)
        _apply_grads(gen_state, loss)
        return gen_state, {k: v.detach() for k, v in metrics.items()}

    return d_step, g_step


def make_sharded_gan_steps(
    cfg: ModelConfig,
    g_opt: Optimizer,
    d_opt: Optimizer,
    mesh,
    gen_state: TrainState,
    disc_state: TrainState,
    dtype=torch.float32,
):
    """The adversarial phase's steps on one rank of `mesh`: (mel, audio) split over
    'data' by rows (the callers pass the global batch), the generator's parameters
    by the vocoder rules and the critics' conv stacks by out-channels over 'model'.
    The crop offset follows the step count, so every rank crops the same samples.
    Returns (d_step, g_step, placed_gen_state, placed_disc_state)."""
    _refuse_kernels(cfg)
    d_loss_fn, g_loss_fn = _gan_loss_fns(cfg, dtype)
    gen, disc = _place_state(gen_state, mesh, g_opt), _place_state(disc_state, mesh, d_opt)
    data_parallel = _data_parallel(mesh)

    def rows_of(x):
        return x[pmesh.local_rows(mesh, len(x))]

    def d_step(disc_state: TrainState, gen_params, mel, audio_real):
        with data_parallel():
            loss = d_loss_fn(disc_state.params, gen_params, rows_of(mel), rows_of(audio_real), disc_state.step)
            _apply_grads(disc_state, loss)
        return disc_state, loss.detach()

    def g_step(gen_state: TrainState, disc_params, mel, audio_real, frame_mask):
        with data_parallel():
            loss, metrics = g_loss_fn(
                gen_state.params, disc_params, rows_of(mel), rows_of(audio_real), rows_of(frame_mask),
                gen_state.step,
            )
            _apply_grads(gen_state, loss)
        return gen_state, {k: v.detach() for k, v in metrics.items()}

    return d_step, g_step, gen, disc


def make_resident_gan_chunk(
    cfg: ModelConfig,
    batches: Sequence[Dict[str, np.ndarray]],
    chunk: int = 50,
    ema_decay: float = 0.999,
    dtype=torch.float32,
    device=None,
):
    """The adversarial phase over a corpus resident on the device (as
    make_resident_train_chunk): (mel, audio, frame_mask) of every batch stacked once
    on `device`, `chunk` d/g step pairs a call cycling the batches, the generator's
    EMA updated after each pair, metrics averaged over the chunk on the device.

    Returns (run_chunk, stacked) where
      run_chunk(gen_state, disc_state, ema, start, corpus) ->
          (gen_state, disc_state, ema, mean_metrics)."""
    dev = resolve_device(device)
    keys = ("mel", "audio", "frame_mask")
    stacked = {k: torch.as_tensor(np.stack([np.asarray(b[k]) for b in batches])).to(dev) for k in keys}
    n = len(batches)
    d_step, g_step = make_gan_steps(cfg, dtype)

    def run_chunk(gen_state: TrainState, disc_state: TrainState, ema, start: int, corpus):
        acc: Dict[str, torch.Tensor] = {}
        for i in range(chunk):
            batch = {k: v[(start + i) % n] for k, v in corpus.items()}
            disc_state, d_loss = d_step(disc_state, gen_state.params, batch["mel"], batch["audio"])
            gen_state, g_metrics = g_step(
                gen_state, disc_state.params, batch["mel"], batch["audio"], batch["frame_mask"]
            )
            ema = ema_update(ema, gen_state.params, ema_decay)
            metrics = {"d": d_loss, **g_metrics}
            acc = metrics if not acc else {k: acc[k] + v for k, v in metrics.items()}
        return gen_state, disc_state, ema, {k: v / chunk for k, v in acc.items()}

    return run_chunk, stacked


# ---------------------------------------------------------------- EMA
#
# An EMA shadow is a flat dict of tensors keyed by parameter name
# ("acoustic.encoder.blocks.0.attn.q.w"), the model's `named_parameters`.


def _named(params: Any) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return {k: p.detach() for k, p in params.named_parameters()}
    return dict(params)


def ema_init(params: Any) -> Dict[str, torch.Tensor]:
    """A params-seeded shadow. The train loop uses the debiased pair
    `ema_init_zeros` + `ema_debias` instead: a params-seeded shadow keeps decay^t
    of the random init in every checkpoint."""
    return {k: v.clone() for k, v in _named(params).items()}


def ema_init_zeros(params: Any) -> Dict[str, torch.Tensor]:
    """Zero-seeded shadow, read through ema_debias."""
    return {k: torch.zeros_like(v) for k, v in _named(params).items()}


def ema_update(ema: Dict[str, torch.Tensor], params: Any, decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """ema = ema * decay + params * (1 - decay), in place; returns ema."""
    named = _named(params)
    shadow = list(ema.values())
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, [named[k].to(v.dtype) for k, v in ema.items()], alpha=1.0 - decay)
    return ema


def ema_debias(ema: Dict[str, torch.Tensor], decay: float, num_updates: int) -> Dict[str, torch.Tensor]:
    """Bias-corrected read of a zero-seeded EMA after `num_updates` updates."""
    scale = 1.0 / (1.0 - decay ** max(int(num_updates), 1))
    return {k: v * scale for k, v in ema.items()}


def synthetic_batch(
    cfg: ModelConfig, batch: int = 4, tokens: int = 16, seed: int = 0, device=None
) -> Dict[str, torch.Tensor]:
    """Deterministic synthetic supervised batch (dry runs, tests), drawn from a
    seeded `torch.Generator` on the host and moved to `device`."""
    g = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    l = tokens
    t = l * cfg.max_frames_per_token
    hop = 1
    for r in cfg.upsample_rates:
        hop *= r
    out = {
        "tokens": torch.randint(1, min(64, cfg.vocab_size), (batch, l), generator=g, dtype=torch.int32),
        "token_mask": torch.ones((batch, l)),
        "speaker": torch.randn((batch, cfg.speaker_dim), generator=g),
        "exaggeration": torch.full((batch,), 0.5),
        "durations": torch.full((batch, l), min(4, cfg.max_frames_per_token), dtype=torch.int32),
        "pitch": torch.randn((batch, l), generator=g),
        "mel": torch.randn((batch, t, cfg.n_mels), generator=g),
        "frame_mask": torch.ones((batch, t)),
        "audio": 0.1 * torch.randn((batch, t * hop), generator=g),
    }
    return {k: v.to(dev) for k, v in out.items()}
