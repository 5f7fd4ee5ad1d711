"""Configuration system (the port's own copy of `gonova_tts_tpu/config.py`).

Field names and defaults are the JAX package's, so one config.yaml drives either
package; only `model.device` defaults to "cuda" here.


The reference ships a config.yaml whose schema is never actually loaded by any module
(reference: services/tts/config.yaml:1-62; startup() hardcodes everything,
services/tts/server.py:402-408).  Here the same schema IS loaded and honored, extended
with `model`/`engine` sections for the in-repo model stack.

Precedence: explicit kwargs > environment (TTS_PORT, TTS_INSTANCE_ID — the only env vars
the reference honors, server.py:487-488) > config.yaml > defaults.
"""

from __future__ import annotations

import os
from typing import List, Literal, Optional

import yaml
from pydantic import BaseModel, ConfigDict, Field


class _SectionModel(BaseModel):
    """Every section validates on assignment (so env/kwarg overrides are coerced
    and type-checked, not stored verbatim)."""

    model_config = ConfigDict(validate_assignment=True)


class ModelConfig(_SectionModel):
    """Reference `model:` section (config.yaml:4-10) + model hyperparameters."""

    model_path: Optional[str] = None  # a .npz or a training root (its newest step); None: seeded init
    device: str = "cuda"  # "cuda" or "cpu" (tests)
    device_index: int = 0
    chunk_size: int = 50  # accepted-but-unused in the reference too (synthesizer.py:226)
    sample_rate: int = 24000

    # --- acoustic model (FastPitch-class) ---
    n_mels: int = 80
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    fmin: float = 0.0
    fmax: float = 12000.0
    vocab_size: int = 256  # phoneme symbol table size (padded to a power of two)
    d_model: int = 256
    n_heads: int = 4
    d_ff: int = 1024
    encoder_layers: int = 4
    decoder_layers: int = 4
    conv_kernel: int = 3
    speaker_dim: int = 256
    max_frames_per_token: int = 8
    # Decoder attention over mel frames: blocked local attention with this window
    # (each block attends to itself + both neighbors; span = 3*window). Full T×T
    # attention holds B*H*T^2 logits a layer, quadratic in the frame bucket; frame
    # dependencies after length regulation are local. None = full attention.
    decoder_attention_window: Optional[int] = 64
    # Local attention only for frame counts >= this; shorter decoder stacks take full
    # attention, on the plain path and in the CUDA kernel alike. The threshold is the
    # JAX package's and has not been decided on the card (tools.bench_tstack times
    # the kernel with local attention at T=768 only).
    local_attention_min_frames: int = 1024

    # Mel bands of the voice path (the speaker encoder's input and `embed_voice`'s
    # log-mel); None: `n_mels`. A vocoder trained on another mel than the speaker
    # encoder (BigVGAN-v2 at 100 bands beside an 80-band encoder) sets it.
    speaker_n_mels: Optional[int] = None

    # --- vocoder family selection ---
    # "vocos": iSTFT-head frame-rate vocoder (the default; every product >= 512 wide)
    # "hifigan": transposed-conv + MRF generator (HiFi-GAN parity family)
    # "bigvgan": BigVGAN-v2's generator (models/bigvgan.py): transposed convs and
    #   AMP blocks with the anti-aliased Snake-beta of ops/snake_aa.py; it reads the
    #   upsample_* and resblock_* fields below
    vocoder_family: str = "vocos"
    vocos_dim: int = 512
    vocos_ff: int = 1536
    vocos_layers: int = 8
    # STFT-head parametrization (models/vocos.py):
    #   "cartesian": head emits (log-mag, x, y); complex via mag * (x,y)/|(x,y)|.
    #   "polar":     head emits (log-mag, phase); complex via mag*cos/sin(phase).
    # The cartesian head replaces cos/sin over [B, T, 513] with one rsqrt and
    # products; it is the JAX package's default, trained to the same eval grades as
    # the polar head (TRAIN_EVAL.md). On an NVIDIA H100 80GB HBM3 at 700.00 W it is
    # not the faster one: tools.bench_vocos_attr read head + iSTFT at B=16 T=320 in
    # 1.45-1.84 ms of device time (cartesian) against 1.21-1.55 ms (polar), five
    # runs. A checkpoint fixes the head.
    # Must match the head a checkpoint was trained with (param shapes differ);
    # the engine infers this from the restored head width, so the setting only
    # governs fresh inits/training. "polar" remains for back-compat checkpoints.
    vocos_head: Literal["polar", "cartesian"] = "cartesian"
    # Run the Vocos ConvNeXt stack through the CUDA kernel (ops.vocos_stack,
    # csrc/vocos_stack.cu) when the pass runs on a card; on the CPU the switch runs
    # the kernel's plain twin. A pass longer than the kernel's MAX_T frames takes the
    # plain blocks. Inference only: the training step refuses it. Off by default:
    # the JAX package's default, not yet decided on the card.
    vocos_pallas: bool = False
    # iSTFT inverse-DFT product precision: "auto" | "default" | "high" | "highest".
    # Kept so one config.yaml drives either package: the JAX package picks the
    # passes of its f32 matmul with it. The port computes the iDFT in full f32
    # whatever the value: with TF32 off (device.resolve_device) a CUDA f32 product
    # is exact f32, below the PCM16 LSB.
    istft_precision: Literal["auto", "default", "high", "highest"] = "auto"
    # Run the acoustic encoder and decoder stacks through the CUDA kernel
    # (ops.transformer_stack, csrc/transformer_stack.cu: every layer and the final
    # LN in one call) when the pass runs on a card; on the CPU the switch runs the
    # kernel's plain twin. Inference only (no backward): the training step refuses
    # it. The engine turns it on for its own ModelConfig copy when serving on a card
    # with EngineConfig.acoustic_pallas.
    acoustic_pallas: bool = False

    # Discriminator (MPD/MSD) channel-width multiplier for adversarial training:
    # 1.0 = HiFi-GAN paper capacity. Training-only (discriminators never enter
    # serving checkpoints); tests and tiny-corpus demos use fractions.
    disc_width: float = 1.0

    # --- vocoder (HiFi-GAN generator class) ---
    upsample_rates: List[int] = Field(default_factory=lambda: [8, 8, 2, 2])
    upsample_kernels: List[int] = Field(default_factory=lambda: [16, 16, 4, 4])
    upsample_initial_channel: int = 256
    resblock_kernels: List[int] = Field(default_factory=lambda: [3, 7, 11])
    resblock_dilations: List[List[int]] = Field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    # Lane-folded HiFi-GAN execution (models/vocoder_folded.py): the narrow-channel
    # MRF/upsample convs as 128-lane folded convs, the layout the JAX package shaped
    # for its accelerator (numerically identical). Plain convs and differentiable, so
    # it serves and trains. Falls back to the plain layout per stage when shapes
    # don't divide. On by default as in the JAX package; not yet decided on the card,
    # where the fold loses: tools.bench_hifigan read the generator at B=16 T=320 in
    # 29.4-30.0 ms folded against 25.2-26.0 ms plain, 0.86-0.87x, five runs (NVIDIA
    # H100 80GB HBM3, 700.00 W).
    hifigan_folded: bool = True

    compute_dtype: str = "bfloat16"  # the engine's compute dtype; CPU tests use "float32"

    # --- acoustic family ---
    # "nova": the FastPitch-class model above (phonemes + speaker embedding → mel).
    # "f5": F5-TTS v1's DiT (models/f5.py): characters of the prompt's transcript and
    #   the sentence, the prompt's log-mel and Gaussian noise → mel by `f5_nfe_steps`
    #   Euler steps of guided flow matching, then Vocos over the generated frames.
    #   A voice is a transcribed prompt (register_voice's `reference_text`), not a
    #   speaker embedding; `exaggeration` is accepted and ignored; the engine groups
    #   rows by `engine.f5_frame_buckets` and reads back nothing before the audio.
    #   It reads the f5_* fields below with the Vocos fields (`n_mels` 100, a polar
    #   head at Vocos's published widths); the published guidance, sway and prompt
    #   level are models/f5.py's constants.
    acoustic_family: Literal["nova", "f5"] = "nova"
    f5_dim: int = 1024
    f5_depth: int = 22
    f5_heads: int = 16
    f5_ff_mult: int = 2
    f5_text_dim: int = 512
    f5_conv_layers: int = 4
    f5_nfe_steps: int = 32

    @property
    def voice_n_mels(self) -> int:
        """Mel bands of the voice path: `speaker_n_mels`, else `n_mels`."""
        return self.speaker_n_mels or self.n_mels


class VoiceCloningConfig(_SectionModel):
    """Reference `voice_cloning:` section (config.yaml:13-24)."""

    enabled: bool = True
    cache_dir: str = "./voices"
    max_cached_voices: int = 100
    default_voice_path: Optional[str] = "./voices/default.wav"
    # The default voice's transcript, which a model that clones from a transcribed
    # prompt (`model.acoustic_family` "f5") needs; without it such a model has no
    # default voice and a request without a registered voice is refused.
    default_voice_text: Optional[str] = None
    min_duration: float = 3.0
    max_duration: float = 10.0
    min_snr: float = 5.0


class SynthesisConfig(_SectionModel):
    """Reference `synthesis:` section (config.yaml:27-30)."""

    default_exaggeration: float = 0.5
    default_cfg_weight: float = 3.0
    enable_streaming: bool = True


class ServerConfig(_SectionModel):
    """Reference `server:` section (config.yaml:33-37)."""

    host: str = "0.0.0.0"
    port: int = 8002
    max_connections: int = 50
    connection_timeout: float = 300.0


class QueueConfig(_SectionModel):
    """Reference `queues:` section (config.yaml:40-42)."""

    input_queue_size: int = 500
    output_queue_size: int = 2000
    # Admission put timeout (reference: 2.0 s, core/queue_manager.py:131-171).
    # Configurable so timing-sensitive tests can widen their margins (a contended
    # single-core host racing a 2.0 s constant against real sleeps is the flake
    # source VERDICT r3 #9 names); production default unchanged.
    put_timeout_s: float = 2.0


class RateLimitConfig(_SectionModel):
    """Reference `rate_limiting:` section (config.yaml:45-48)."""

    enabled: bool = True
    max_requests_per_minute: int = 100
    window_seconds: int = 60


class LoggingConfig(_SectionModel):
    """Reference `logging:` section (config.yaml:51-57)."""

    level: str = "INFO"
    format: str = "json"
    file: Optional[str] = None
    log_syntheses: bool = True
    log_voice_registrations: bool = True


class MonitoringConfig(_SectionModel):
    """Reference `monitoring:` section (config.yaml:60-62)."""

    enable_health_endpoint: bool = True
    enable_metrics_endpoint: bool = True
    # Spans into an in-memory ring, and `record_function` ranges while a
    # torch.profiler records (utils/prof.py); off, only the histograms of the
    # engine's passes, embeddings and stream steps fill. In a YAML config:
    # `trace_spans: true` under `monitoring:`. Either way
    # /metrics?format=prometheus carries `gonova_tts_span_seconds` histograms.
    trace_spans: bool = False


class EncodingConfig(_SectionModel):
    """Reference `encoding:` section (README.md:296-300 — promised there, never
    implemented; audio/encode.py implements it here via the system codecs)."""

    default_format: Literal["pcm", "wav", "mp3", "opus"] = "pcm"
    mp3_bitrate: int = 192  # kbps
    opus_bitrate: int = 64  # kbps


class EngineConfig(_SectionModel):
    """Engine extension: bucketing, batching, streaming (no reference analog —
    replaces the serialized single worker, reference server.py:110-186)."""

    token_buckets: List[int] = Field(default_factory=lambda: [32, 64, 128, 192])
    batch_buckets: List[int] = Field(default_factory=lambda: [1, 4, 8, 16])
    max_batch: int = 16
    batch_window_ms: float = 10.0  # admission window for dynamic batching
    stream_chunk_frames: int = 64  # mel frames emitted per streaming vocoder pass
    # Context frames each side of a streaming window. Streamed == one-shot needs
    # ctx >= vocos RF + 2 (RF = 3*(layers+1); the iSTFT overlap-add draws on
    # frames up to 2 before / 1 after each emitted sample — measured: error hits
    # the float-noise floor only from RF+2). Default = 29 for the 8-layer flagship.
    stream_context_frames: int = 29
    warmup_shapes: List[List[int]] = Field(
        default_factory=lambda: [[1, 32], [4, 32], [1, 64], [4, 64], [8, 64], [16, 64]]
    )  # (batch, token_bucket) pairs compiled at startup — cover the hot buckets:
    # a request mix hitting an unwarmed shape pays its first-run costs mid-request
    # Device→host audio transfer dtype. "int16" halves the transfer (and is exact
    # 16-bit PCM, inaudible vs float32); host converts back via the native runtime.
    transfer_dtype: str = "int16"
    # Fused mel-feature kernel for the voice-embedding path (the JAX package's field
    # name; here it selects `ops.mel_spectrogram`'s CUDA kernel when the engine's
    # device is CUDA, and the plain `audio.mel_spectrogram` otherwise).
    mel_pallas: bool = True
    # The transformer-stack CUDA kernel for the acoustic encoder/decoder on the
    # serving path (see ModelConfig.acoustic_pallas). The engine turns the model
    # flag on for its own config copy when this is True and its device is a card.
    # Off by default: the JAX package's default, not yet decided on the card. On an
    # NVIDIA H100 80GB HBM3 at 700.00 W, tools.bench_acoustic (batch 16, bf16; six
    # runs) read the acoustic pass 3.5-4.8 ms with the kernel against 10.9-21.5 ms
    # plain, and the whole pipeline 35.9-53.7 ms against 43.6-70.6: a gain smaller
    # than the spread between runs, which the vocoder's host-side launches set.
    acoustic_pallas: bool = False
    # Data-parallel serving: number of local devices to drive from this engine
    # (1 = one device; 0 = all local devices). Params replicate, batch shards.
    data_parallel: int = 1
    # Bounded frame-bucket set for the decode after a pass's frame-count readback:
    # the dispatch picks the smallest entry covering the batch, falling back to the
    # worst case (bucket * max_frames_per_token) when none does — so the device shapes
    # are capped at |buckets|+1 per batch bucket. Warmup always runs these (for
    # warmup_shapes' batch sizes).
    vocode_frame_buckets: List[int] = Field(
        default_factory=lambda: [128, 192, 256, 320, 384, 448]
    )
    # The frame buckets of an F5 pass (`model.acoustic_family` "f5"): a row of L
    # frames (prompt and sentence) runs in the smallest bucket >= L; a warm-up shape
    # (batch, bucket) names one of these. 4096 is the text positions' limit.
    f5_frame_buckets: List[int] = Field(
        default_factory=lambda: [1024, 1152, 1280, 1408, 1536, 1664, 1792, 1920, 2048, 2560, 4096]
    )


class Config(_SectionModel):
    model: ModelConfig = Field(default_factory=ModelConfig)
    voice_cloning: VoiceCloningConfig = Field(default_factory=VoiceCloningConfig)
    synthesis: SynthesisConfig = Field(default_factory=SynthesisConfig)
    server: ServerConfig = Field(default_factory=ServerConfig)
    queues: QueueConfig = Field(default_factory=QueueConfig)
    rate_limiting: RateLimitConfig = Field(default_factory=RateLimitConfig)
    logging: LoggingConfig = Field(default_factory=LoggingConfig)
    monitoring: MonitoringConfig = Field(default_factory=MonitoringConfig)
    encoding: EncodingConfig = Field(default_factory=EncodingConfig)
    engine: EngineConfig = Field(default_factory=EngineConfig)


def load_config(path: Optional[str] = None, **overrides) -> Config:
    """Load config.yaml (if present) and apply env + keyword overrides."""
    data: dict = {}
    if path is None:
        candidate = os.path.join(os.getcwd(), "config.yaml")
        path = candidate if os.path.exists(candidate) else None
    elif not os.path.exists(path):
        # An EXPLICIT path must exist — silently serving defaults after a typo'd
        # --config is a misconfiguration trap (auto-discovery above may miss).
        raise FileNotFoundError(f"config file not found: {path}")
    if path is not None and os.path.exists(path):
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        if not isinstance(loaded, dict):
            raise ValueError(f"config file {path} must contain a mapping")
        data = loaded

    cfg = Config.model_validate(data)

    # Env overrides honored by the reference (server.py:487-488).
    if "TTS_PORT" in os.environ:
        cfg.server.port = int(os.environ["TTS_PORT"])

    for dotted, value in overrides.items():
        section, _, key = dotted.partition(".")
        if not key:
            raise KeyError(f"override must be 'section.key', got {dotted!r}")
        if not hasattr(cfg, section):
            raise KeyError(f"unknown config section: {section!r}")
        target = getattr(cfg, section)
        if not hasattr(target, key):
            raise KeyError(f"unknown config key: {dotted}")
        setattr(target, key, value)  # validate_assignment coerces/rejects
    return cfg
