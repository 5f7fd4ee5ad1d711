"""TTSEngine for the port: bucketed batch synthesis and streaming on one CUDA device.

Counterpart of `gonova_tts_tpu/engine/engine.py` `TTSEngine`, with the same public
surface (`load`, `warmup`, `embed_voice`, `embed_voice_file`, `synthesize_batch`,
`synthesize_stream`, `health_check`, `get_stats`) and the same dispatch rules:

  * token and batch buckets, so every device pass has one of a few shapes;
  * every pass in two stages: `encode_acoustic`, one [B]-int32 readback of the
    frame counts, then `decode_vocode` at the smallest configured frame bucket
    covering `total_frames.max()` and the vocoder's reach past it, at least
    `stream_context_frames` (`tts.reach_frames`); `tts.synthesize`, the one-shot
    pipeline, is what these passes reproduce;
  * PCM16 transfer: the device packs `clip(wav * 32767, ±32767)` with a
    truncating int16 cast, the host unpacks `/ 32768` (`utils/native.i16_to_f32`:
    the C audio runtime, or its numpy form);
  * streaming by context-padded vocoder windows that reproduce the one-shot audio;
  * any vocoder family (`model.vocoder_family`: NovaVocos; the HiFi-GAN
    generator, which no kernel serves; BigVGAN-v2, whose activations run through
    `ops.snake_aa`): `vocos_pallas` applies to NovaVocos alone, while
    `acoustic_pallas` runs both acoustic stacks through the kernel for every family;
  * voice embedding: reference audio → 24 kHz → a fixed 10 s zero-padded analysis
    buffer → log-mel of `model.voice_n_mels` bands (the fused kernel on CUDA under
    `engine.mel_pallas`) → speaker encoder;
  * F5-TTS (`model.acoustic_family` "f5", models/f5.py): a voice is a transcribed
    prompt (`make_prompt`), a row's frame count L is known on the host
    (`plan`), so a pass has no encode stage and no readback before its audio:
    rows padded to a frame bucket of `engine.f5_frame_buckets` and a batch bucket,
    `f5.sample` (one graph per stage, the Euler step's replayed `f5_nfe_steps`
    times), then the vocoder over each row's generated frames. Each row's x_0 is a
    function of the row alone (`f5.noise`), so its audio does not depend on its
    batch-mates or its bucket. Streaming runs each sentence as a one-row pass and
    yields its audio in chunks.

PyTorch runs eagerly, so there is no compile cache. On a card with one replica,
`warmup` captures every warmed shape as CUDA graphs (`models/graphs.py`) and a
pass replays them: the token-domain half per (batch, token bucket), the acoustic
decode per (batch, token bucket, frame bucket), the vocoder per (batch, frame
bucket), the request's inputs copied into the graphs' static inputs through pinned
host buffers. Other passes run eagerly, as do streaming and voice embedding;
without graphs (the CPU, data parallelism) `warmup` runs the warmup shapes once.
`engine.data_parallel` resolves as in the JAX engine (0 = every
device of `multi.local_devices`; more than exist raises). With two or more, each
device holds a replica (`engine/multi.py`) and a batch, rounded up to a multiple of
the device count, is split into contiguous row blocks, one per replica: every
shard is enqueued before any is read back. The frame bucket comes from the whole
batch's frame counts, as the JAX engine's sharded encode sees them.
Streaming and voice embedding run on replica 0.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.mel import mel_spectrogram
from ..audio.resample import resample
from .. import ops
from ..config import Config
from ..device import resolve_device
from ..models import f5, graphs
from ..models import params as params_mod
from ..models import tts
from ..text import batch_to_bucket, pick_bucket, segment_text, text_to_ids
from ..ops.mel_spectrogram import mel_spectrogram as mel_spectrogram_fused
from ..utils import Tracer, native, read_wav
from . import multi

logger = logging.getLogger("gonova_tts_tpu_torch.engine")

NO_PROMPT = ("an F5 model speaks only in a voice it clones from a transcribed prompt: register one with "
             "reference_text, or set voice_cloning.default_voice_text for the default voice")


@dataclass(frozen=True)
class Plan:
    """A sentence as a pass takes it, planned on the host against its voice: `ids`
    (token ids; F5: the character ids of transcript and sentence), `bucket` (the
    token bucket; F5: the frame bucket of the row's L), by which the batcher groups
    sentences into passes, and F5's `row`."""

    ids: List[int]
    bucket: int
    row: Optional[f5.Row] = None


class TTSEngine:
    def __init__(self, config: Optional[Config] = None, seed: int = 0, device=None):
        self.config = config or Config()
        self.mcfg = self.config.model
        self.ecfg = self.config.engine
        self.device = resolve_device(device if device is not None else self.mcfg.device)
        if self.ecfg.acoustic_pallas and not self.mcfg.acoustic_pallas and self.device.type == "cuda":
            # Serving on the card: run the acoustic stacks through the fused kernel
            # (inference only; a trainer builds its own ModelConfig).
            self.mcfg = self.mcfg.model_copy(update={"acoustic_pallas": True})
        self.seed = seed
        self.f5 = self.mcfg.acoustic_family == "f5"
        self.params: Optional[tts.TTS] = None
        self.replicas: List[tts.TTS] = []  # one per data-parallel device; [0] is self.params
        self._dp: Optional[multi.DataParallel] = None
        self.is_loaded = False
        self.hop = self.mcfg.hop_length
        self.sample_rate = self.mcfg.sample_rate
        self.compute_dtype = (
            torch.bfloat16 if self.mcfg.compute_dtype == "bfloat16" else torch.float32
        )
        # The span recorder the service and the batcher share (utils/prof.py).
        self.tracer = Tracer(self.config.monitoring.trace_spans)
        self._lock = threading.Lock()  # device work is serialized per engine
        self._stats_lock = threading.Lock()
        self._busy_since: float = 0.0
        self.stats = {
            "syntheses": 0,
            "total_latency": 0.0,
            "first_chunk_latency": 0.0,
            "errors": 0,
            "batches": 0,
            "batched_requests": 0,
            "compiles": 0,  # distinct device shapes run (no compile step in eager PyTorch)
            "real_tokens": 0,
            "padded_tokens": 0,
            "vocode_frames_executed": 0,
            "vocode_frames_worstcase": 0,
            "truncated_sentences": 0,
            "graph_passes": 0,  # passes whose graphed parts all replayed
            "eager_passes": 0,
            "graphs_captured": 0,
            # F5 passes: Σ L of the rows, batch bucket x frame bucket, Σ prompt frames
            # (ref_len) of the rows, and DiT row-evaluations of real rows (two guidance
            # rows a row for each Euler step the sampler launched)
            "f5_real_frames": 0,
            "f5_padded_frames": 0,
            "f5_prompt_frames": 0,
            "f5_evaluations": 0,
        }
        self._vocode_shapes_seen: set = set()
        self._graphs: Optional[graphs.GraphSet] = None
        # (batch, token bucket) → (pinned host buffers, the graphs' static inputs)
        self._staged: dict = {}

    @contextmanager
    def _device_section(self):
        """Device-lock holder that timestamps itself, so health_check can tell busy
        from wedged."""
        with self.tracer.span("engine.lock_wait"):
            self._lock.acquire()
        try:
            self._busy_since = time.time()
            yield
        finally:
            self._busy_since = 0.0
            self._lock.release()

    # ------------------------------------------------------------ loading

    def load(self, warmup: bool = True) -> None:
        """Restore (`model.model_path`: a `.npz`, or a training root whose newest
        step is taken) or seed-initialize the weights, then optionally warm up."""
        t0 = time.time()
        self.data_parallel = self._resolve_data_parallel()
        if self.mcfg.model_path:
            self.params, self.mcfg = params_mod.load_checkpoint(
                self.mcfg.model_path, self.mcfg, self.device
            )
            logger.info("params restored from %s", self.mcfg.model_path)
        else:
            g = torch.Generator().manual_seed(self.seed)
            self.params = tts.TTS(self.mcfg, g).to(self.device)
            logger.info("params initialized, seed %d", self.seed)
        self.params.eval()
        if self._dp is not None:
            self.replicas = self._dp.place_params(self.params)
            self.params, self.device = self.replicas[0], self._dp.devices[0]
            logger.info("data parallel over %s", [str(d) for d in self._dp.devices])
        else:
            self.replicas = [self.params]
        on_card = self.device.type == "cuda" and self._dp is None
        self._graphs = graphs.GraphSet(self.device) if on_card else None
        self._staged = {}
        self.stats["graphs_captured"] = 0
        self.is_loaded = True
        if warmup:
            self.warmup()
        logger.info("engine loaded in %.2f s", time.time() - t0)

    def _resolve_data_parallel(self) -> int:
        """`engine.data_parallel` as the JAX engine reads it: 0 means every device of
        `multi.local_devices` (each CUDA card, or the one CPU); more than exist
        raises; two or more serve through `multi.DataParallel`."""
        devices = multi.local_devices(self.device)
        n = self.ecfg.data_parallel or len(devices)
        if n > 1 and self.f5:
            raise ValueError("an F5 model serves one replica per engine (engine.data_parallel 1)")
        self._dp = multi.DataParallel(n, devices) if n > 1 else None
        return n

    @property
    def two_stage_enabled(self) -> bool:
        """Every pass is two-stage."""
        return True

    # ------------------------------------------------------------ device stages

    def _pack(self, wav: torch.Tensor) -> torch.Tensor:
        if self.ecfg.transfer_dtype == "int16":
            return torch.clamp(wav * 32767.0, -32767.0, 32767.0).to(torch.int16)
        return wav

    def _readback(self, audio: torch.Tensor) -> np.ndarray:
        """One blocking device→host copy."""
        with self.tracer.span("engine.readback"):
            return audio.cpu().numpy()

    def _to_f32(self, host: np.ndarray) -> np.ndarray:
        return native.i16_to_f32(host) if self.ecfg.transfer_dtype == "int16" else host.astype(np.float32)

    def _tensors(self, tokens, mask, spk, exagg, device=None):
        dev = device or self.device
        return (
            torch.as_tensor(tokens, device=dev), torch.as_tensor(mask, device=dev),
            torch.as_tensor(spk, device=dev), torch.as_tensor(exagg, device=dev),
        )

    def _stage(self, arrays):
        """A warmed shape's static inputs (made at warm-up) holding `arrays`: each is
        copied into its pinned host buffer, then to the device without blocking. A
        pass reads its audio back before the next one writes the buffers."""
        host, dev = self._staged[arrays[0].shape]
        for h, d, a in zip(host, dev, arrays):
            h.numpy()[...] = a
            d.copy_(h, non_blocking=True)
        return dev

    def _make_staged(self, arrays) -> None:
        pin = self.device.type == "cuda"
        host = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, pin_memory=pin) for a in arrays)
        dev = tuple(torch.empty(a.shape, dtype=h.dtype, device=self.device) for a, h in zip(arrays, host))
        self._staged[arrays[0].shape] = (host, dev)

    def _shards(self, tokens, mask, spk, exagg):
        """[(replica, its device tensors)]: the whole batch on the one replica (in
        the static inputs of its shape's graphs, where it has them), or each
        data-parallel replica's contiguous block of rows."""
        if self._dp is None:
            if tokens.shape in self._staged:
                return [(self.params, self._stage((tokens, mask, spk, exagg)))]
            return [(self.params, self._tensors(tokens, mask, spk, exagg))]
        parts = [self._dp.shard_rows(a) for a in (tokens, mask, spk, exagg)]
        return [
            (rep, self._tensors(*(p[i] for p in parts), device=dev))
            for i, (rep, dev) in enumerate(zip(self.replicas, self._dp.devices))
        ]

    def _frame_buckets(self, bucket: int) -> List[int]:
        """The frame buckets a pass at this token bucket can dispatch."""
        t_full = bucket * self.mcfg.max_frames_per_token
        return [x for x in self.ecfg.vocode_frame_buckets if x < t_full] + [t_full]

    def _zeros(self, batch: int, bucket: int):
        return (
            np.zeros((batch, bucket), np.int32), np.ones((batch, bucket), np.float32),
            np.zeros((batch, self.mcfg.speaker_dim), np.float32), np.zeros((batch,), np.float32),
        )

    def warmup(self) -> None:
        """Run each configured (batch, token-bucket) shape once — encode plus
        decode_vocode at every frame bucket the shape can dispatch — and the
        streaming window shape. Under data parallelism the batch is rounded as
        serving rounds it and every replica runs its shard's shape. With graphs (a
        card, one replica) each shape is captured instead, after `_prime`, and its
        readbacks read nothing yet; the engine captures nothing after warm-up."""
        if self.f5:
            return self._warmup_f5()
        dtype = self.compute_dtype
        # The device lock (without its span) keeps a health probe's launch out of a capture.
        with self._lock, torch.inference_mode():
            if self._graphs is not None:
                self._prime(dtype)
            with graphs.active(self._graphs, capture=True):
                for batch, bucket in self.ecfg.warmup_shapes:
                    t0 = time.time()
                    if self._dp is not None:
                        batch = self._dp.round_batch(batch)
                    arrays = self._zeros(batch, bucket)
                    if self._graphs is not None and (batch, bucket) not in self._staged:
                        self._make_staged(arrays)
                    shards = self._shards(*arrays)
                    encs = [tts.encode_acoustic(rep, *args, self.mcfg, dtype) for rep, args in shards]
                    for e in encs:
                        e["total_frames"].cpu()
                    self.stats["compiles"] += 1
                    t_full = bucket * self.mcfg.max_frames_per_token
                    for fb in self._frame_buckets(bucket):
                        outs = [
                            tts.decode_vocode(
                                rep, e["enc"], e["spk"], e["durations"], args[1], fb,
                                self.mcfg, dtype, local_attention_from=t_full,
                            )
                            for (rep, args), e in zip(shards, encs)
                        ]
                        for out in outs:
                            out["total_samples"].cpu()
                        self._vocode_shapes_seen.add((batch, bucket, fb))
                        self.stats["compiles"] += 1
                    logger.info("warmup batch %d bucket %d: %.2f s", batch, bucket, time.time() - t0)
            self.stats["graphs_captured"] = len(self._graphs or ())
            stride = self.ecfg.stream_chunk_frames
            ctx = min(self.ecfg.stream_context_frames, stride)
            rf_exact = tts.reach_frames(self.mcfg)
            if ctx < rf_exact:
                logger.warning(
                    "stream context %d is below the exactness bound %d (configured %d)",
                    ctx, rf_exact, self.ecfg.stream_context_frames,
                )
            mel = torch.zeros((1, stride + 2 * ctx, self.mcfg.n_mels), dtype=dtype, device=self.device)
            self._pack(tts.vocode(self.params, mel, self.mcfg, dtype)).cpu()
            self.stats["compiles"] += 1

    def _prime(self, dtype) -> None:
        """Before the captures, on the capture stream: at batch 1, an eager encode
        per warmed token bucket and a decode_vocode at the fewest and the most frames
        warmed (the two sides of the kernels' length limits). It builds what a first
        call builds on the host (position tables, packed weights, fold selectors, the
        libraries' per-stream state), which a capture may not copy to the device."""
        buckets = sorted({bucket for _, bucket in self.ecfg.warmup_shapes})
        ends = {(buckets[0], self._frame_buckets(buckets[0])[0]),
                (buckets[-1], self._frame_buckets(buckets[-1])[-1])}
        with self._graphs.side_stream():
            for bucket in buckets:
                args = self._tensors(*self._zeros(1, bucket))
                e = tts.encode_acoustic(self.params, *args, self.mcfg, dtype)
                for fb in sorted(fb for b, fb in ends if b == bucket):
                    tts.decode_vocode(
                        self.params, e["enc"], e["spk"], e["durations"], args[1], fb, self.mcfg, dtype,
                        local_attention_from=bucket * self.mcfg.max_frames_per_token,
                    )["total_samples"].cpu()
                e["total_frames"].cpu()

    # ------------------------------------------------------------ voice embedding

    def analysis_buffer(self, audio: np.ndarray, sr: int):
        """Reference audio → (the fixed [1, max_samples] f32 analysis buffer on the
        engine's device, the number of valid frames). Stereo is averaged, the clip is
        resampled to the model rate and cut or zero-padded to 10 s (the validation
        rules' maximum), rounded down to a hop multiple. The zero tail is part of
        the function: the right reflect pad mirrors zeros, and frames past the clip
        are masked out, not absent."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        wav = resample(torch.as_tensor(audio, device=self.device), sr, self.sample_rate)
        max_samples = int(10.0 * self.sample_rate)
        max_samples -= max_samples % self.hop
        n = min(wav.shape[0], max_samples)
        buf = torch.zeros((1, max_samples), dtype=torch.float32, device=self.device)
        buf[0, :n] = wav[:n]
        return buf, n // self.hop

    def embed_voice(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Reference audio → speaker embedding [speaker_dim]. The mel is always f32;
        the encoder runs in the engine's compute dtype."""
        if not self.is_loaded:
            raise RuntimeError("Engine not loaded. Call load() first")
        if self.f5:
            raise ValueError("an F5 model clones from a transcribed prompt (make_prompt), not an embedding")
        fused = self.ecfg.mel_pallas and self.device.type == "cuda"
        span = self.tracer.span
        with self._device_section(), span("engine.embed_voice"), torch.inference_mode():
            with span("engine.embed.resample"):
                buf, valid = self.analysis_buffer(audio, sr)
            with span("engine.embed.mel"):
                mel = (mel_spectrogram_fused if fused else mel_spectrogram)(
                    buf, sr=self.sample_rate, n_fft=self.mcfg.n_fft, hop_length=self.hop,
                    win_length=self.mcfg.win_length, n_mels=self.mcfg.voice_n_mels, fmin=self.mcfg.fmin,
                    fmax=self.mcfg.fmax,
                )
            with span("engine.embed.encoder"):
                mask = (torch.arange(mel.shape[1], device=self.device)[None] < valid).float()
                emb = tts.embed_speaker(self.params, mel, mask, dtype=self.compute_dtype)
            return self._readback(emb[0].float())

    def embed_voice_file(self, path: str) -> np.ndarray:
        audio, sr = read_wav(path)
        return self.embed_voice(np.asarray(audio, np.float32), sr)

    def default_speaker(self) -> np.ndarray:
        return np.zeros((self.mcfg.speaker_dim,), np.float32)

    def make_prompt(self, audio: np.ndarray, sr: int, transcript: str) -> f5.Prompt:
        """A reference recording and its transcript → an F5 voice prompt."""
        if not self.is_loaded:
            raise RuntimeError("Engine not loaded. Call load() first")
        with self._device_section(), self.tracer.span("engine.f5.prompt"), torch.inference_mode():
            return f5.make_prompt(audio, sr, transcript, self.mcfg, self.device)

    def voice_from_file(self, path: str, transcript: Optional[str] = None):
        """A recording as the model's voice: its speaker embedding (the transcript
        unused); an F5 model's prompt, which needs the transcript (ValueError)."""
        if not self.f5:
            return self.embed_voice_file(path)
        if not (transcript or "").strip():
            raise ValueError(NO_PROMPT)
        audio, sr = read_wav(path)
        return self.make_prompt(np.asarray(audio, np.float32), sr, transcript)

    def plan(self, text: str, voice=None, to_ids=text_to_ids) -> Plan:
        """A sentence against its voice (a speaker embedding or None; F5: a prompt,
        which it needs: ValueError): its ids (by `to_ids`; F5: characters) and
        bucket."""
        if not self.f5:
            ids = list(to_ids(text))
            return Plan(ids, pick_bucket(len(ids), self.ecfg.token_buckets))
        if voice is None:
            raise ValueError(NO_PROMPT)
        row = f5.plan(text, voice, self.mcfg)
        return Plan(row.ids, self.f5_bucket(row.frames), row)

    def f5_bucket(self, frames: int) -> int:
        """The frame bucket of a row of `frames` frames: the smallest configured one
        that holds it, else `frames` rounded up to a multiple of 256 (not warmed)."""
        return next((b for b in self.ecfg.f5_frame_buckets if b >= frames), -(-frames // 256) * 256)

    # ------------------------------------------------------------ batch synthesis

    def synthesize_batch(
        self,
        texts: Sequence[str],
        speakers: Optional[Sequence[np.ndarray]] = None,
        exaggerations: Optional[Sequence[float]] = None,
        id_lists: Optional[Sequence[Sequence[int]]] = None,
        pass_id: int = 0,
        plans: Optional[Sequence[Plan]] = None,
    ) -> List[np.ndarray]:
        """One chunk of text per request in a single device pass; one float32
        waveform per input. `id_lists` takes precomputed token ids, `plans` the
        texts' `plan`s; `pass_id`, the id of the pass's `engine.pass` span, drawn by
        a caller that names the pass in its own spans. An F5 model reads `speakers`
        as prompts (`make_prompt`)."""
        if not self.is_loaded:
            raise RuntimeError("Engine not loaded. Call load() first")
        if not texts:
            return []
        if self.f5:
            plans = plans or [self.plan(t, v) for t, v in zip(texts, speakers or [None] * len(texts))]
            return self._synthesize_f5([p.row for p in plans], pass_id)
        t0 = time.time()
        b = len(texts)
        if plans is not None:
            id_lists = [p.ids for p in plans]
        if id_lists is None:
            id_lists = [text_to_ids(t) for t in texts]
        elif len(id_lists) != b:
            raise ValueError(f"{len(id_lists)} id lists for {b} texts")
        tokens, mask, spk, exagg, lengths, bucket = self._batch_inputs(id_lists, speakers, exaggerations)
        batch_bucket = tokens.shape[0]
        truncated = sum(len(ids) > bucket for ids in id_lists)
        if truncated:
            with self._stats_lock:
                self.stats["truncated_sentences"] += truncated
            logger.warning("%d token sequences cut to bucket %d", truncated, bucket)

        t_full = int(bucket * self.mcfg.max_frames_per_token)
        span = self.tracer.span
        # `engine.pass` opens with the device lock held and, with its `engine.unpack`,
        # closes after the results are sliced, which runs with the lock released: the
        # lock covers the host copies and their f32 conversion only.
        with ExitStack() as open_spans:
            with self._device_section(), torch.inference_mode():
                pass_span = open_spans.enter_context(span("engine.pass", id=pass_id))
                with graphs.active(self._graphs) as graph_set:
                    host, total, fb = self._pass(tokens, mask, spk, exagg, bucket, batch_bucket, t_full)
                graphed = graph_set is not None and graph_set.eager == 0 and graph_set.replayed > 0
                if pass_span:
                    pass_span.set(batch=b, batch_bucket=batch_bucket, token_bucket=bucket, frame_bucket=fb,
                                  real_tokens=int(np.sum(lengths)), graphed=graphed)
                open_spans.enter_context(span("engine.unpack"))
                audio = np.concatenate([self._to_f32(h) for h in host])
            results = [audio[i, : int(total[i])].astype(np.float32) for i in range(b)]
        dt = time.time() - t0
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batched_requests"] += b
            self.stats["syntheses"] += b
            self.stats["total_latency"] += dt
            self.stats["real_tokens"] += int(np.sum(lengths))
            self.stats["padded_tokens"] += int(batch_bucket * bucket)
            self.stats["graph_passes" if graphed else "eager_passes"] += 1
        return results

    def _batch_inputs(self, id_lists, speakers=None, exaggerations=None):
        """A pass's host inputs: the token ids at their token bucket, the rows padded
        to the batch bucket (rounded for data parallelism), the mask, the speaker rows
        (zero where none) and the exaggerations (0.5 on padded rows). Returns
        (tokens, mask, spk, exagg, lengths, bucket)."""
        b = len(id_lists)
        tokens_np, lengths, bucket = batch_to_bucket(id_lists, self.ecfg.token_buckets)
        batch_bucket = pick_bucket(b, self.ecfg.batch_buckets)
        if b > batch_bucket:
            logger.warning("batch %d exceeds the largest bucket %d", b, batch_bucket)
            batch_bucket = b
        if self._dp is not None:
            batch_bucket = self._dp.round_batch(batch_bucket)

        tokens = np.zeros((batch_bucket, bucket), np.int32)
        tokens[:b] = tokens_np
        all_lengths = np.concatenate([lengths, np.zeros(batch_bucket - b, np.int32)])
        mask = (np.arange(bucket)[None, :] < all_lengths[:, None]).astype(np.float32)
        spk = np.zeros((batch_bucket, self.mcfg.speaker_dim), np.float32)
        if speakers is not None:
            for i, s in enumerate(speakers):
                if s is not None:
                    spk[i] = s
        exagg = np.full((batch_bucket,), 0.5, np.float32)  # the streaming/reference default
        if exaggerations is not None:
            exagg[:b] = np.asarray(exaggerations, np.float32)
        return tokens, mask, spk, exagg, lengths, bucket

    def _pass(self, tokens, mask, spk, exagg, bucket: int, batch_bucket: int, t_full: int):
        """The device work of one `synthesize_batch` pass, under the device lock:
        the host copies of the audio (PCM16 or f32), the samples per row and the
        frame bucket vocoded. Every shard is enqueued before any is read back, so
        the devices overlap."""
        dtype = self.compute_dtype
        span = self.tracer.span
        shards = self._shards(tokens, mask, spk, exagg)
        with span("engine.encode"):
            encs = [tts.encode_acoustic(rep, *args, self.mcfg, dtype) for rep, args in shards]
        # The one [B] readback; the frame bucket covers the whole batch.
        with span("engine.readback"):
            total_frames = np.concatenate([e["total_frames"].cpu().numpy() for e in encs])
        # Zero frames past the longest sentence, so that no sample of it sees the
        # bucket's edge (the JAX engine adds stream_context_frames alone).
        need = int(total_frames.max()) + max(self.ecfg.stream_context_frames, tts.reach_frames(self.mcfg))
        fb = min((x for x in self.ecfg.vocode_frame_buckets if x >= need), default=t_full)
        fb = min(fb, t_full)
        if (batch_bucket, bucket, fb) not in self._vocode_shapes_seen:
            self._vocode_shapes_seen.add((batch_bucket, bucket, fb))
            self.stats["compiles"] += 1
        with span("engine.decode_vocode"):
            packed = [
                self._pack(tts.decode_vocode(
                    rep, e["enc"], e["spk"], e["durations"], args[1], fb, self.mcfg,
                    dtype, local_attention_from=t_full,
                )["audio"])
                for (rep, args), e in zip(shards, encs)
            ]
        host = [self._readback(a) for a in packed]
        with self._stats_lock:
            self.stats["vocode_frames_executed"] += int(fb * batch_bucket)
            self.stats["vocode_frames_worstcase"] += int(t_full * batch_bucket)
        return host, total_frames * self.hop, fb

    # ------------------------------------------------------------ F5 passes

    def _f5_arrays(self, rows: Sequence[f5.Row], batch: int, bucket: int):
        """A pass's host inputs (`f5.sample`'s, then the output gain): rows past the
        given ones are filler with one frame."""
        m = self.mcfg.n_mels
        ids1 = np.zeros((batch, bucket), np.int64)
        cond = np.zeros((batch, bucket, m), np.float32)
        x0 = np.zeros((batch, bucket, m), np.float32)
        lens = np.ones((batch,), np.int64)
        prompt_frames = np.zeros((batch,), np.int64)
        ref_len = np.zeros((batch,), np.int64)
        gain = np.ones((batch,), np.float32)
        for i, r in enumerate(rows):
            n = min(len(r.ids), r.frames)
            ids1[i, :n] = np.asarray(r.ids[:n]) + 1
            cond[i, : r.prompt.frames] = r.prompt.mel
            x0[i, : r.frames] = f5.noise(r.ids, r.frames, m)
            lens[i], prompt_frames[i], ref_len[i], gain[i] = r.frames, r.prompt.frames, r.prompt.ref_len, r.prompt.gain
        return ids1, cond, x0, lens, prompt_frames, ref_len, gain

    def _f5_pass(self, arrays, on_step=None) -> np.ndarray:
        """The device work of one F5 pass: the staged inputs (or fresh tensors for an
        unwarmed shape), the sampler (`on_step` called as each step is launched), the
        vocoder, the PCM16 readback."""
        dtype, span = self.compute_dtype, self.tracer.span
        if arrays[0].shape in self._staged:
            ids1, cond, x0, lens, prompt_frames, ref_len, gain = self._stage(arrays)
        else:
            ids1, cond, x0, lens, prompt_frames, ref_len, gain = (torch.as_tensor(a, device=self.device) for a in arrays)
        with span("engine.f5.sample"):
            mel = f5.sample(self.params["acoustic"], ids1, cond, x0, lens, prompt_frames, ref_len, self.mcfg, dtype,
                            on_step)
        with span("engine.f5.vocode"):
            wav = tts.vocode(self.params, mel, self.mcfg, dtype)
        return self._readback(self._pack(wav * gain[:, None]))

    def _synthesize_f5(self, rows: Sequence[f5.Row], pass_id: int) -> List[np.ndarray]:
        t0 = time.time()
        b = len(rows)
        bucket = max(self.f5_bucket(r.frames) for r in rows)
        batch_bucket = max(b, pick_bucket(b, self.ecfg.batch_buckets))
        arrays = self._f5_arrays(rows, batch_bucket, bucket)
        real = sum(r.frames for r in rows)
        steps = []  # one entry a step the sampler launched
        span = self.tracer.span
        with ExitStack() as open_spans:
            with self._device_section(), torch.inference_mode():
                pass_span = open_spans.enter_context(span("engine.pass", id=pass_id))
                with graphs.active(self._graphs) as graph_set:
                    host = self._f5_pass(arrays, lambda: steps.append(1))
                graphed = graph_set is not None and graph_set.eager == 0 and graph_set.replayed > 0
                if pass_span:
                    pass_span.set(batch=b, batch_bucket=batch_bucket, frame_bucket=bucket, real_frames=real,
                                  graphed=graphed)
                open_spans.enter_context(span("engine.unpack"))
                audio = self._to_f32(host)
            results = [audio[i, : (r.frames - r.prompt.ref_len) * self.hop].astype(np.float32)
                       for i, r in enumerate(rows)]
        with self._stats_lock:
            st = self.stats
            st["batches"] += 1
            st["batched_requests"] += b
            st["syntheses"] += b
            st["total_latency"] += time.time() - t0
            st["f5_real_frames"] += real
            st["f5_padded_frames"] += batch_bucket * bucket
            st["f5_prompt_frames"] += sum(r.prompt.ref_len for r in rows)
            st["f5_evaluations"] += 2 * b * len(steps)
            st["graph_passes" if graphed else "eager_passes"] += 1
        return results

    def _warmup_f5(self) -> None:
        """Each warm-up shape (batch, frame bucket) once: with graphs, after an eager
        pass at batch 1 at the smallest and the largest bucket (which builds the
        weights' cast and the constants on the capture stream), captured instead."""
        shapes = [(b, self.f5_bucket(fb)) for b, fb in self.ecfg.warmup_shapes]
        with self._lock, torch.inference_mode():
            if self._graphs is not None and shapes:
                ends = sorted({fb for _, fb in shapes})
                with self._graphs.side_stream():
                    for fb in {ends[0], ends[-1]}:
                        self._f5_pass(self._f5_arrays([], 1, fb))
            with graphs.active(self._graphs, capture=True):
                for batch, bucket in shapes:
                    t0 = time.time()
                    arrays = self._f5_arrays([], batch, bucket)
                    if self._graphs is not None and arrays[0].shape not in self._staged:
                        self._make_staged(arrays)
                    self._f5_pass(arrays)
                    self.stats["compiles"] += 1
                    logger.info("warmup batch %d frames %d: %.2f s", batch, bucket, time.time() - t0)
            self.stats["graphs_captured"] = len(self._graphs or ())

    # ------------------------------------------------------------ streaming synthesis

    def synthesize_stream(
        self, text: str, speaker: Optional[np.ndarray] = None, exaggeration: float = 0.5
    ) -> Iterator[np.ndarray]:
        """Generator: sentences → acoustic pass → windowed vocoding. Yields float32
        audio chunks; first audio follows one acoustic pass and one window."""
        if not self.is_loaded:
            raise RuntimeError("Engine not loaded. Call load() first")
        t0 = time.time()
        first = True
        stream = self._stream_f5 if self.f5 else self._stream_sentence
        try:
            for sentence in segment_text(text):
                for chunk in stream(sentence, speaker, exaggeration):
                    if first:
                        with self._stats_lock:
                            self.stats["first_chunk_latency"] += time.time() - t0
                        first = False
                    yield chunk
            with self._stats_lock:
                self.stats["syntheses"] += 1
                self.stats["total_latency"] += time.time() - t0
        except Exception:
            with self._stats_lock:
                self.stats["errors"] += 1
            raise

    def _stream_f5(self, sentence: str, prompt: Optional[f5.Prompt], exaggeration: float) -> Iterator[np.ndarray]:
        """An F5 sentence makes its mel all at once: one one-row pass, its audio in
        chunks of `stream_chunk_frames` frames."""
        audio = self.synthesize_batch([sentence], [prompt])[0]
        step = self.ecfg.stream_chunk_frames * self.hop
        for i in range(0, len(audio), step):
            yield audio[i : i + step]

    def _stream_sentence(
        self, sentence: str, speaker: Optional[np.ndarray], exaggeration: float
    ) -> Iterator[np.ndarray]:
        ids = text_to_ids(sentence)
        bucket = pick_bucket(len(ids), self.ecfg.token_buckets)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, : min(len(ids), bucket)] = ids[:bucket]
        mask = (np.arange(bucket)[None, :] < min(len(ids), bucket)).astype(np.float32)
        spk = np.zeros((1, self.mcfg.speaker_dim), np.float32)
        if speaker is not None:
            spk[0] = speaker
        exagg = np.asarray([exaggeration], np.float32)
        dtype = self.compute_dtype

        with self._device_section(), self.tracer.span("engine.stream.acoustic"), torch.inference_mode():
            ac = tts.acoustic_mel(self.params, *self._tensors(tokens, mask, spk, exagg), self.mcfg, dtype)
            mel = ac["mel"]
            total_frames = int(ac["total_frames"][0])
        if total_frames <= 0:
            return

        stride = self.ecfg.stream_chunk_frames
        ctx = min(self.ecfg.stream_context_frames, stride)  # window starts stay >= 0
        w = stride + 2 * ctx
        hop = self.hop
        total_samples = total_frames * hop
        # Window 0 starts at frame 0 (no synthetic left context); window k >= 1 takes
        # ctx real frames of left context. The right pad covers the last window's
        # overrun with zero frames, which the one-shot pass also sees.
        n_windows = -(-total_frames // stride)
        mel = F.pad(mel, (0, 0, 0, stride + 2 * ctx))
        emitted = 0
        for k in range(n_windows):
            start = 0 if k == 0 else k * stride - ctx
            lead = 0 if k == 0 else ctx
            window = mel[:, start : start + w]
            with self._device_section(), self.tracer.span("engine.stream.window"), torch.inference_mode():
                wav = self._to_f32(self._readback(self._pack(tts.vocode(self.params, window, self.mcfg, dtype))))[0]
            body = wav[lead * hop : (lead + stride) * hop]
            chunk = body[: max(0, total_samples - emitted)]
            if len(chunk):
                emitted += len(chunk)
                yield chunk.astype(np.float32)
            if emitted >= total_samples:
                break

    # ------------------------------------------------------------ health

    def health_check(self, deadline_s: float = 5.0, stall_after_s: float = 300.0) -> dict:
        """Device liveness probe: one small op end to end, with a deadline; a device
        section held past `stall_after_s` reports degraded."""
        if not self.is_loaded:
            return {"status": "unloaded"}
        if not self._lock.acquire(blocking=False):
            since = self._busy_since
            busy_for = (time.time() - since) if since else 0.0
            if busy_for > stall_after_s:
                return {"status": "degraded", "reason": "device section stalled", "busy_for_s": round(busy_for, 1)}
            return {"status": "ok", "note": "busy serving"}
        t0 = time.time()
        try:
            val = float((torch.ones((8, 128), device=self.device) * 2.0 + 1.0).sum().item())
            latency = time.time() - t0
            if latency > deadline_s:
                return {"status": "degraded", "probe_latency_s": round(latency, 3)}
            if not np.isfinite(val):
                return {"status": "unhealthy", "reason": "non-finite device output"}
            return {"status": "ok", "probe_latency_s": round(latency, 3)}
        except RuntimeError as e:  # a device fault surfaces as a RuntimeError
            return {"status": "unhealthy", "reason": str(e)}
        finally:
            self._lock.release()

    # ------------------------------------------------------------ stats / misc

    def get_stats(self) -> dict:
        stats = dict(self.stats)
        n = stats["syntheses"]
        stats["avg_latency"] = stats["total_latency"] / n if n else 0.0
        stats["avg_first_chunk"] = stats["first_chunk_latency"] / n if n else 0.0
        stats["compiled_shapes"] = self.stats["compiles"]
        stats["padding_efficiency"] = (
            round(self.stats["real_tokens"] / self.stats["padded_tokens"], 4)
            if self.stats["padded_tokens"] else 1.0
        )
        stats["timers"] = self.tracer.summary()
        # The hand kernels' launches in this process (replays included): every engine
        # of the process shares these counters.
        stats["kernel_launches"] = ops.launch_counts()
        from ..text import g2p

        stats["g2p_tiers"] = g2p.get_tier_counts()
        return stats

    def cleanup(self) -> None:
        self.params = None
        self.replicas = []
        self.is_loaded = False
