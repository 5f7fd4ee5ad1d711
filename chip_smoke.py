#!/usr/bin/env python3
"""Drive the PyTorch port (gonova_tts_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase parallel   # phase 11 alone (after the build), for a multi-card machine
    python3 chip_smoke.py --phase snake      # the Snake-beta kernel and BigVGAN-v2's convs alone (after the build)

Phases; any failure exits non-zero before the final line:
  1. device: name and power limit (nvidia-smi); no card → exit 3, no result.
  2. build: every gonova_tts_tpu_torch/csrc/*.cu with nvcc for sm_90a, and csrc/audio_runtime.cpp
     with the host compiler, in parallel.
  3. kernels: first the bf16 tensor-core GEMM both stacks share, alone, at the six
     serving products and four row counts (`gemm case:` lines: device time from a
     replayed CUDA graph, the bound, and one `torch.matmul` of the bare product as a
     yardstick the port never calls). Then each hand-written kernel vs its plain
     PyTorch version on the card, at the serving path's shapes, f32 and bf16: max
     |error| against a stated bound,
     kernel and plain times (CUDA events around eager calls: `ms` includes the host's
     launch cost, which is most of a small stack's time; `device_ms` of the two stacks
     is the same call replayed from a CUDA graph), and the least time the card could take.
     A bf16 decoder stack at T = 320 and the same sequences padded to T = 448 must
     give bit-equal valid rows (`shape_independent_bf16`).
     The mel and the block cases also give `device_ms` and `matmul_ms`, the bare
     products alone in one `torch.matmul` each (the block's two MLP products; the
     mel's frames @ [wcos | wsin] in full f32): a yardstick, not `library_ms`.
     The single ConvNeXt block is also chained over the checkpoint's eight blocks,
     with its launch count read: in f32 against the stack kernel, in bf16 (x and MLP,
     the tensor-core route) against eight calls of its plain version, where
     torch.profiler also counts the device kernels the chain ran (two of the shared
     GEMM's `gemm_tc_kernel` a block).
     BigVGAN-v2's anti-aliased Snake-beta (`ops.snake_aa`, no TPU counterpart) at B=4
     T=256 frames and B=16 T=448 frames, at stages 1 (768 channels, 4 samples a frame)
     and 5 (48 channels, 128 samples a frame), bf16 (and f32 at one shape), against its
     plain version (SNAKE_BF16_STEP); its bound counts 58 operations and, in bf16,
     2 + 2 bytes a sample (`snake_cost`). Its launches are counted on the bigvgan
     cell's path, in the phase after `service` (below). With `--phase snake` also
     every dilated conv of that generator alone, dilated and phase-split
     (`conv_cases`: device ms, TFLOP/s, the top kernel, the error), and one whole
     forward with its phase-split convs against all dilated (`bigvgan_phase_error`).
  4. engine: the demo checkpoint (assets/checkpoints/demo_ema_f16.npz, full width,
     30.1 M parameters) in bf16 with both kernel switches on — batches through the
     engine, streaming, a 128-token sentence whose decoder takes the plain
     local-attention route — with launch counts reset just before and read just
     after; then agreement checks against the one-shot pipeline
     (`parity_gpu.one_shot`, run outside the count window) and audio-seconds per
     second.
  5. voice: the cloning path through the service facade — StreamingSynthesizer,
     VoiceManager.register_voice (assets/default_voice.wav), embed_voice_file,
     VoiceEmbeddingCache, 48 kHz and 44.1 kHz references through
     extract_voice_embedding, cloned speech streamed and batched (DynamicBatcher) —
     again with launch counts reset just before and read just after.
  6. service: the WS protocol end to end. A TTSService on the demo checkpoint (bf16,
     both stack kernels, default voice assets/default_voice.wav) served through
     `handle_connection` over an in-memory socket (the service's path without aiohttp):
     register_voice (the default voice's samples declared at 30 kHz, a higher
     voice), synthesize with that voice, with an unknown voice (the default
     voice), list_voices, wav and each of mp3/opus the host offers, metadata,
     cancel; time to first audio (TTFA) and to synthesis_complete over 16 requests at
     concurrency 1 and 4 rounds of 4 connections; synthesize_full (REST without HTTP);
     the /health and /metrics bodies; shutdown. Launch counts reset after start() and
     read before shutdown: the mel, transformer and Vocos kernels each launched.
     Then BigVGAN-v2 on the bigvgan-narrate cell's path (`run_bigvgan_service`): a
     TTSService (bf16, CUDA graphs captured at warm-up) over the demo checkpoint's
     acoustic model and speaker encoder, a 100-band mel head and the published
     generator from seed 0; counts from zero just before eight synthesize_full calls
     and read after: every pass replayed, 109 `snake_aa` launches and the rule's
     phase-split convs (`conv_phased`) a pass.
  7. parity: parity_gpu.py's bf16 gate (parity.py's workload and limits: mel MSE <
     1e-2, MCD < 1.0 dB, MR-STFT < 0.3), f32 plain path vs bf16 with both stack
     kernels, on random weights (seed 0) and on the demo checkpoint; and the engine's
     bf16 two-stage audio vs the bf16 one-shot pipeline's, graded by the same metrics.
     Launch counts set to 0 just before each line's run and read just after: each
     line must have launched both stacks. The phase's wall time.
     A gate that fails fails the run.
  8. train: (a) three f32 steps of make_train_step at full width on the card and on
     the CPU from one seeded tree and one synthetic batch: loss parts agree within
     TRAIN_CARD_VS_CPU_RTOL per step, and no kernel launches. (b) the demo corpus
     (4 speakers x 12 sentences, variable durations, 2 held out), then
     `train.loop.train` resident at full width on the card (TRAIN_STEPS steps,
     chunk 50, warmup 50, batch 8, lr 2e-4, the MAS aligner learned in the step):
     every logged metric finite, `total` falling, no kernel launched; data
     preparation and training wall time, ms per step, peak device memory, the
     step-200 losses beside the JAX package's run in assets/train_history_demo_r3.jsonl.
     (c) the checkpoint root served by a TTSEngine in bf16 with both stack kernels
     (counts reset just before, read just after): a held-out sentence in a corpus
     speaker's cloned voice, finite and not silent, both stacks launched. (d) one
     warm training step profiled: the MAS loops alone, device busy and idle share,
     host-to-device copies, the top kernels.
  9. hifigan: NovaGAN at full width (`ModelConfig(vocoder_family="hifigan")`: the demo
     checkpoint's acoustic and speaker subtrees with a HiFi-GAN generator seeded from
     0). f32: the generator at B=1 T=64 on the card vs the CPU, and folded vs plain on
     the card; TTSEngine with the kernel switches on, two-stage vs the one-shot
     pipeline within one int16 step. bf16 (launch counts from 0 just before, read just
     after): batches 1/4/16 through the engine and the one-shot pipeline, a stream, a
     cloned voice (assets/default_voice.wav): `transformer_stack` must launch,
     `vocos_stack` must not. Then the engine's audio-s/s per batch, the batch-4
     profile, the generator alone at B=4 T=320 in both layouts and dtypes against its
     FLOP bound (`generator_work`), and parity_gpu's gate metrics for bf16 vs f32 on
     this config (readings: the vocoder is random).
 10. gan: (a) three d/g pairs of make_gan_steps at a small config (disc_width 0.25,
     the crop firing) on the card vs the CPU: losses within GAN_CARD_VS_CPU_RTOL, no
     kernel launched; (b) `train(gan=True)` on the demo corpus at full width with the
     Vocos generator and the critics at width 1.0 (resident, chunk 50, batch 8,
     GAN_JOINT_STEPS joint steps + GAN_PAIRS pairs): GAN metrics finite, the generator
     moved, checkpoints at the joint steps and at the end and nothing else, no kernel
     launched; ms per pair, peak memory, the chunk means beside the JAX run's GAN lines;
     the final checkpoint served in bf16 with both kernels (`vocos_stack` launches);
     (c) five pairs of the full-width HiFi-GAN generator at batch 8 x 512 frames.
 11. parallel: (a) data-parallel serving: the demo checkpoint with both kernel switches
     on and `engine.data_parallel = DP_REPLICAS`, on distinct cards where there are
     enough, else every replica on cuda:0 (through `multi.local_devices`; the line
     says how many devices are distinct), against a one-replica engine in this
     process and against the one-shot pipeline on one replica: batch DP_BATCH in f32
     (max |error| within DP_F32_BOUND) and in bf16 (parity.py's three limits), then
     one stream and one `embed_voice_file`; launch counts from 0 just before the bf16 run and read just
     after, and each stack launch attributed to the replica whose weights it got:
     both stacks on every replica; batch latencies of both engines. (b) sharded
     training: a 1x1 mesh (NCCL, this process) runs SHARDED_STEPS steps of
     make_sharded_train_step and then one sharded GAN pair at full width on one
     demo-corpus batch (8 x 512 frames, learned alignment) against make_train_step
     and make_gan_steps from the same state: losses and parameters within
     SHARDED_RTOL; no kernel launched. With two cards also 2x1 and 1x2, with four
     also 2x2, in spawned workers: losses within MULTI_CARD_RTOL of one card's.
 12. native: the C audio runtime (gonova_tts_tpu_torch/csrc/audio_runtime.cpp, built by
     `build_all` with the host compiler) loaded, not the numpy forms; each of its five
     entry points against its numpy form on 10 s of audio (f32_to_i16 within 1 LSB,
     i16_to_f32 exact, crossfade_join within 1e-6 at overlaps 0, 1 and 64, audio_stats
     within 1e-12 relative, declick within 1 ulp and a read-only input untouched),
     with host ms of both; one served request's int16 PCM unpacked by the library
     bit-equal to numpy's unpack of the same PCM. A library that did not build fails.
 13. g2p: the G2P model on the card at full width. The vendored primary (192-d 3+3)
     and `_e3` (256-d 4+4) greedy-decode the 1,255 held-out words against the numpy
     serving decoder at beam 1: a mismatch passes only where the top-2 logit gap at
     the first differing step is below G2P_NEAR_TIE, and each is printed (`g2p
     near-tie:` lines). Then tools/train_g2p.py's default recipe from seed 0
     (G2P_STEPS steps, cut from 4,000): ms a step, the device's idle share over G2P_PROFILE_STEPS
     profiled steps, the loss at steps 0, 250, ... and the last, peak memory, the
     held-out report beside the vendored primary's (graded alone by the same code);
     the exact match above the LTS rules' 0.3554; the member saved under build/ in
     JAX's format, reloaded, the same ids at f16.
 14. grade: tools.eval_checkpoint on the demo checkpoint against the train phase's demo
     corpus, in f32 and bf16 with both kernel switches on, and tools.clone_eval on its
     synthetic voices (bf16), each JSON printed (`grade:` lines): streamed vs batch
     0 int16 LSB in f32, eval_checkpoint's clone margin positive in both dtypes, and (counts
     from 0 just before the runs, read just after) the transformer, Vocos and mel
     kernels launched.
 15. tools: the repo's four diagnostics as the port runs them (`tools:` lines):
     g2p_coverage on its sample (exact coverage >= 0.97, morph > 0.2, the bounds of
     tests/test_morph.py); jitter_floor on the demo corpus (both floors > 0.1, both
     length ratios in 0.7-1.3) and its wall time; align_diag on the demo corpus for
     ALIGN_STEPS steps graded every ALIGN_EVAL_EVERY (every loss finite, the last
     below the first; the grades are readings), with its ms a step, launches a step
     and device idle share (torch.profiler over one warm step); ws_smoke on the demo
     checkpoint in bf16 with both kernel switches on, over the transport the host
     offers (aiohttp's test server where aiohttp imports) and again over the in-memory
     socket with aiohttp hidden (each: health "healthy" on backend "cuda", finite
     audio above NOT_SILENT_RMS in at least one chunk; the two runs' chunks and audio
     seconds equal, rms and peak within one int16 LSB; TTFA, steady TTFA and the
     realtime factor as readings). Counts from 0 at the phase's start, read at its
     end: the transformer, Vocos and mel kernels launched.
 16. bench: the port's measurement tools at full width (`bench:` lines and the suite's
     `{"config": ...}` lines). tools.bench at ModelConfig(), batch 16, bf16 (the default
     config: no stack kernel switched on): its detail line and its four-key contract
     line, the value finite and positive, TTFA p50 <= p90; tools.mfu on the two
     throughputs bench printed (both MFUs in (0, 100) %); the five bench_suite configs
     on the production config (audio in 1-4, batching seen in 2, no new device shape in
     4, TTFA in 5); bench_tstack's three cases and bench_acoustic's kernel on/off A/B
     (each kernel output within KERNEL_BF16_BOUND of the plain path, and
     `transformer_stack` launched by each), bench_vocos_attr and bench_hifigan (every
     time positive). Counts from 0 just before each tool, read just after; repetition
     cuts at BENCH_REPS.
 17. output: a `kernels` JSON line (every kernel with its launches on each path,
     `launches_hifigan_path`, `launches_gan_phase`, `launches_dp_path`,
     `launches_g2p_phase`, `launches_grade_path`, `launches_tools_phase` and
     `launches_bench_phase` included), the nvidia-smi line, then the `ok` JSON line.

Bounds (max |error| unless named):
  kernels f32: KERNEL_F32_BOUND (summation order through up to 8 layers);
  the GEMM alone, bf16: one bf16 ulp (2^-7 relative) per rounding of the epilogue (one
    for bias and ReLU, two for the others), of |output|, or of |output| + |resid| for
    a residual epilogue (the rounded term may cancel in the sum), plus GEMM_ATOL;
  kernels bf16: KERNEL_BF16_BOUND (a one-ulp bf16 flip at a rounding point, ~0.4%,
    carried through the later layers);
  two-stage vs the one-shot pipeline, streamed vs one-shot: see ENGINE_BOUNDS;
  bf16 kernel path vs f32 plain path: relative L2 error of the audio at the same
    durations, BF16_VS_F32_REL_L2;
  log-mel kernel: |error| <= MEL_ATOL + MEL_RTOL * |plain| (f32-grade products, here
    split TF32, under a log; the JAX kernel test's bound);
  ConvNeXt block chained 8 times vs the stack kernel, f32: CHAIN_VS_STACK_BOUND; in
    bf16 vs eight plain blocks: KERNEL_BF16_BOUND;
  voice path: see VOICE_BOUNDS;
  NovaGAN: see HIFIGAN_BOUNDS; GAN pairs card vs CPU: GAN_CARD_VS_CPU_RTOL (relative);
  service: WS audio vs batcher.submit of the same sentence and embedding,
    VOICE_BOUNDS["cloned_batch_vs_stream"]; wav framing vs pcm framing of the same
    text, one int16 step; an unknown voice vs the default voice, SERVICE_FALLBACK_BOUND.
"""

from __future__ import annotations

import asyncio
import base64
import json
import math
import os
import subprocess
import sys
import tempfile
import time

KERNEL_F32_BOUND = 1e-4
KERNEL_BF16_BOUND = 0.1
GEMM_RTOL, GEMM_ATOL = 2.0 ** -7, 1e-2
# Audio is PCM16 in [-1, 1]; one LSB is 1/32767. In bf16 the kernels give the same
# rows at any frame bucket, but cuBLAS and cuDNN pick other algorithms for other
# shapes (the mel and STFT-head products, the embed conv), and a bf16 rounding flip
# there moves the audio by tens of LSB; in f32 the same dispatch stays within 2 LSB.
ENGINE_BOUNDS = {
    "two_stage_vs_one_shot": 0.08,
    "two_stage_vs_one_shot_plain_local": 0.1,
    "stream_vs_one_shot": 0.03,
    "f32_two_stage_vs_one_shot": 2.01 / 32767,
}
BF16_VS_F32_REL_L2 = 0.1
MEL_ATOL, MEL_RTOL = 2e-4, 1e-4
CHAIN_VS_STACK_BOUND = 3e-4
VOICE_BOUNDS = {
    # Embeddings have unit L2 norm. Kernel mel vs plain mel differ by f32 summation
    # order (~1e-6 in the log-mel); in bf16 that can flip a rounding of the encoder's
    # input, which three convs carry on.
    "embedding_kernel_mel_vs_plain_mel_f32": 1e-3,
    "embedding_kernel_mel_vs_plain_mel_bf16": 2e-2,
    "embedding_unit_norm": 1e-3,
    "resample_card_vs_cpu": 1e-4,  # f32 polyphase FIR, cuDNN vs CPU summation order
    # The batcher's passes are two-stage; the stream is one acoustic pass + windows.
    "cloned_batch_vs_stream": ENGINE_BOUNDS["two_stage_vs_one_shot"],
}
VOICE_WAV = os.path.join("assets", "default_voice.wav")
# The same sentence, voice and batch shape twice through the service: the same kernels
# on the same inputs, so within one PCM16 step.
SERVICE_FALLBACK_BOUND = 1.01 / 32767
SERVICE_SHUTDOWN_S = 35.0
# f32 with TF32 off on the card: the same products as the CPU in another summation
# order, carried through three Adam steps.
TRAIN_CARD_VS_CPU_RTOL = 1e-3
TRAIN_STEPS = 200
JAX_HISTORY = os.path.join("assets", "train_history_demo_r3.jsonl")
NOT_SILENT_RMS = 1e-4  # about three PCM16 steps

# One bf16 rounding step between two f32 results of the same activation (kernel and
# plain, the kernel's sine the hardware's), plus the f32 noise of values near 0.
SNAKE_BF16_STEP = (2.0 ** -7, 1e-4)
SNAKE_F32_REL = 2e-6
SNAKE_OPS_PER_SAMPLE = 58  # 24 upsampling, 10 Snake, 24 downsampling (the benchmark's count)

H100_BYTES_PER_S = 3.35e12
# Dense tensor-core bf16; f32 off the tensor cores; f32-grade products as split TF32 on
# the tensor cores, three TF32 products each (495 / 3 TFLOP/s): the mel kernel's route.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32_split": 495e12 / 3}
DEMO = os.path.join("assets", "checkpoints", "demo_ema_f16.npz")
SENTENCES = [  # 25, 42, 45 and 60 tokens: one batch in the 64-token bucket
    "Hello there, how are you today?",
    "The quick brown fox jumps over the lazy dog.",
    "Please call Stella and ask her to bring these things.",
    "We paid $42.50 for 17 widgets.",
]
STREAM_TEXT = "Streaming starts before the sentence ends. A second sentence follows the first one."
LONG_SENTENCE = (  # 97 tokens: the 128-token bucket, 1024 one-shot frames
    "This longer sentence keeps going with many more words, so that its phoneme count "
    "lands in the next bucket up."
)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def name_of(dtype) -> str:
    return str(dtype).split(".")[-1]


def bound(bytes_moved: int, flops: float, dtype_name: str):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ phase 3


def gemm_cases(torch, dev, rng):
    """The six serving products of the two stacks, bf16, at M = B*T rows for B = 4 and
    T = 64, 320, 512, 2048, through `ops.gemm_tc` with each product's own epilogue."""
    import numpy as np

    from gonova_tts_tpu_torch.ops import gemm_tc as g
    from gonova_tts_tpu_torch.ops.gemm_tc_sweep import PRODUCTS, graph_ms

    bf = lambda a: torch.as_tensor(a.astype(np.float32), device=dev).bfloat16()  # noqa: E731
    cases = []
    for name, cin, taps, n, epi in PRODUCTS:
        k = taps * cin
        w = bf(rng.standard_normal((k, n)) / np.sqrt(k))
        wt = w.t().contiguous()
        bias = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
        gamma = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=dev)
        for t in (64, 320, 512, 2048):
            b = 4
            m = b * t
            a, resid = bf(rng.standard_normal((b, t, cin))), bf(rng.standard_normal((b, t, n)))
            mask = torch.ones((b, t), device=dev)
            mask[1, t // 2:] = 0.0
            args = (a, w, epi, bias, resid, mask, gamma, taps)
            out, ref = g.gemm_tc(*args, wt=wt), g.gemm_tc_plain(*args)
            torch.cuda.synchronize()
            scale = ref.float().abs() + (resid.float().abs() if epi in (g.EPI_RESID_MASK, g.EPI_GAMMA_RESID) else 0.0)
            roundings = 1 if epi in (g.EPI_BIAS, g.EPI_BIAS_RELU) else 2
            err = (out.float() - ref.float()).abs()
            rows = g.im2col3(a).reshape(m, k) if taps == 3 else a.reshape(m, k)
            flops = 2.0 * m * k * n
            extra = nbytes(resid) if epi in (g.EPI_RESID_MASK, g.EPI_GAMMA_RESID) else 0
            bound_ms, bound_by = bound(nbytes(a, w, out, bias) + extra, flops, "bfloat16")
            ms = graph_ms(lambda: g.gemm_tc(*args, wt=wt))
            seqs, t_len = (b, t) if taps == 3 else (1, m)
            cases.append({
                "case": f"{name} {taps}x{cin}->{n} M={m}", "dtype": "bfloat16", "plan": list(g.plan(seqs, t_len, n, k)),
                "max_abs_err": float(err.max()), "tolerance": f"{GEMM_ATOL} + {roundings} * 2^-7 * scale",
                "ok": bool(torch.isfinite(out.float()).all()) and bool((err <= GEMM_ATOL + roundings * GEMM_RTOL * scale).all()),
                "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "matmul_ms": graph_ms(lambda: torch.matmul(rows, w)),
                "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
            })
    return cases


def kernel_reads(packed, bf16: bool):
    """The packed tensors a stack kernel reads: in bf16 the [N, K] copy of a weight,
    not the [K, N] one the plain version reads."""
    return [v for k, v in packed.items() if not (bf16 and k + "_t" in packed)]


def shape_independent_bf16(model, torch, dev, rng) -> bool:
    """The checkpoint's decoder stack in bf16 on a prefix-masked batch at T = 320 and
    on the same sequences padded to T = 448: bit-equal valid rows. No sequence fills
    T = 320, so the frame after a sequence's end is a masked frame at both lengths."""
    import numpy as np

    from gonova_tts_tpu_torch.ops import transformer_stack as ts

    packed = ts.pack_params(model.acoustic.decoder, torch.bfloat16)
    lengths = [300, 250, 97, 1]
    mask = torch.as_tensor((np.arange(448)[None] < np.asarray(lengths)[:, None]).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.standard_normal((4, 448, 256)).astype(np.float32), device=dev) * mask[..., None]
    short = ts.transformer_stack(x[:, :320].contiguous(), mask[:, :320].contiguous(), packed, 4, None, True)
    long = ts.transformer_stack(x, mask, packed, 4, None, True)
    torch.cuda.synchronize()
    return bool(torch.isfinite(long.float()).all()) and all(
        torch.equal(short[i, :n], long[i, :n]) for i, n in enumerate(lengths)
    )


def transformer_cases(model, torch, dev, rng):
    """Encoder B=4 T=64; decoder B=4 T=512 (full attention); decoder B=4 T=256
    with local attention w=64. Real checkpoint weights, prefix masks."""
    import numpy as np

    from gonova_tts_tpu_torch.ops import transformer_stack as ts
    from gonova_tts_tpu_torch.ops.gemm_tc_sweep import graph_ms

    cases = []
    for name, stack, b, t, window in (
        ("encoder", model.acoustic.encoder, 4, 64, None),
        ("decoder", model.acoustic.decoder, 4, 512, None),
        ("decoder_local", model.acoustic.decoder, 4, 256, 64),
    ):
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            packed = ts.pack_params(stack, dt)
            lengths = np.array([t, t - t // 4, t // 2, t // 3 + 5])[:b]
            mask = torch.as_tensor((np.arange(t)[None] < lengths[:, None]).astype(np.float32), device=dev)
            x = (torch.as_tensor(rng.standard_normal((b, t, 256)).astype(np.float32), device=dev) * mask[..., None]).to(dt)
            out = ts.transformer_stack(x, mask, packed, 4, window, bf16)
            ref = ts.transformer_stack_plain(x, mask, packed, 4, window, bf16)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.isfinite(out.float()).all()) and err <= (KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND)
            d, f, n_layers = 256, packed["w1"].shape[-1], packed["w1"].shape[0]
            m = b * t
            span = 3 * window if window and 2 * window < t else t
            flops = n_layers * (
                2 * m * d * 3 * d + 4 * b * t * span * d + 2 * m * d * d + 2 * m * 3 * d * f * 2
            )
            moved = nbytes(x, mask, out, *kernel_reads(packed, bf16))
            bound_ms, bound_by = bound(moved, flops, name_of(dt))
            cases.append({
                "case": f"{name} B={b} T={t}" + (f" w={window}" if window else ""),
                "dtype": name_of(dt), "max_abs_err": err,
                "tolerance": KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND, "ok": ok,
                "ms": cuda_ms(lambda: ts.transformer_stack(x, mask, packed, 4, window, bf16), 10),
                "device_ms": graph_ms(lambda: ts.transformer_stack(x, mask, packed, 4, window, bf16), 4),
                "plain_ms": cuda_ms(lambda: ts.transformer_stack_plain(x, mask, packed, 4, window, bf16), 10),
                "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            })
    return cases


def vocos_cases(model, torch, dev, rng):
    """B=4 T=320 (a two-stage frame bucket) and B=1 T=122 (the streaming window)."""
    from gonova_tts_tpu_torch.ops import vocos_stack as vs
    from gonova_tts_tpu_torch.ops.gemm_tc_sweep import graph_ms

    cases = []
    for b, t in ((4, 320), (1, 122)):
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            packed = vs.pack_params(model.vocoder.blocks, dt)
            x = torch.as_tensor(rng.standard_normal((b, t, 512)).astype("float32"), device=dev).to(dt)
            out = vs.vocos_stack(x, packed, bf16)
            ref = vs.vocos_stack_plain(x, packed, bf16)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.isfinite(out.float()).all()) and err <= (KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND)
            c, f, n_layers = 512, packed["w1"].shape[-1], packed["w1"].shape[0]
            flops = n_layers * b * t * (4 * c * f + 2 * 7 * c)
            moved = nbytes(x, out, *kernel_reads(packed, bf16))
            bound_ms, bound_by = bound(moved, flops, name_of(dt))
            cases.append({
                "case": f"B={b} T={t}", "dtype": name_of(dt), "max_abs_err": err,
                "tolerance": KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND, "ok": ok,
                "ms": cuda_ms(lambda: vs.vocos_stack(x, packed, bf16), 10),
                "device_ms": graph_ms(lambda: vs.vocos_stack(x, packed, bf16), 4),
                "plain_ms": cuda_ms(lambda: vs.vocos_stack_plain(x, packed, bf16), 10),
                "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            })
    return cases


def mel_cases(torch, dev, rng):
    """f32 only. Seeded noise [4, 32768]; the reference voice zero-padded to the
    engine's 10 s analysis buffer [1, 239872] (a silent tail: both floors); frame
    counts 2, 127, 128, 129; and the hop=64 framing (n_fft / hop = 16). The bound is
    taken at the split-TF32 rate (`bound_ms`) and, for the record, at the f32 rate of
    the CUDA cores (`bound_ms_f32`)."""
    import numpy as np

    from gonova_tts_tpu_torch.audio.stft import reflect_pad
    from gonova_tts_tpu_torch.ops import mel_spectrogram as mel
    from gonova_tts_tpu_torch.ops.gemm_tc_sweep import graph_ms
    from gonova_tts_tpu_torch.utils import read_wav

    voice, sr = read_wav(VOICE_WAV)
    if sr != 24000 or voice.ndim != 1:
        fail(f"{VOICE_WAV}: expected 24 kHz mono, got {sr} Hz, shape {voice.shape}")
    buf = np.zeros((1, 239872), np.float32)
    buf[0, : len(voice)] = voice
    noise = lambda b, t: 0.1 * rng.standard_normal((b, t)).astype(np.float32)  # noqa: E731
    inputs = [("noise B=4 T=32768", noise(4, 32768), 256), ("voice B=1 T=239872", buf, 256)]
    inputs += [(f"noise B=2 frames={n}", noise(2, max(n * 256, 512)), 256) for n in (2, 127, 128, 129)]
    inputs += [("noise B=2 T=8192 hop=64", noise(2, 8192), 64)]
    cases = []
    for name, x_np, hop in inputs:
        x = torch.as_tensor(x_np, device=dev)
        out = mel.mel_spectrogram(x, hop_length=hop)
        ref = mel.mel_spectrogram_plain(x, hop_length=hop)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        ok = (
            out.shape == (x.shape[0], x.shape[1] // hop, 80) and bool(torch.isfinite(out).all())
            and bool((err <= MEL_ATOL + MEL_RTOL * ref.abs()).all())
        )
        n_fft, n_bins, n_mels = 1024, 513, 80
        frames = x.shape[0] * (x.shape[1] // hop)
        flops = frames * (2 * 2 * n_fft * n_bins + 2 * n_bins * n_mels)
        moved = nbytes(x, out) + 4 * (2 * n_fft * n_bins + n_bins * n_mels)
        bound_ms, bound_by = bound(moved, flops, "tf32_split")
        frames = reflect_pad(x, n_fft, hop).unfold(-1, n_fft, hop)[:, : x.shape[1] // hop].reshape(-1, n_fft).contiguous()
        wcat = torch.cat(mel.folded_bases(n_fft, 1024, dev), dim=1)
        cases.append({
            "case": name, "dtype": "float32", "max_abs_err": float(err.max()),
            "tolerance": f"{MEL_ATOL} + {MEL_RTOL} * |plain|", "ok": ok,
            "ms": cuda_ms(lambda: mel.mel_spectrogram(x, hop_length=hop), 10),
            "device_ms": graph_ms(lambda: mel.mel_spectrogram(x, hop_length=hop), 10),
            "plain_ms": cuda_ms(lambda: mel.mel_spectrogram_plain(x, hop_length=hop), 10),
            "matmul_ms": graph_ms(lambda: torch.matmul(frames, wcat), 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_ms_f32": bound(moved, flops, "float32")[0],
            "gflop": flops / 1e9,
        })
    return cases


def snake_cost(b: int, c: int, t: int, elem: int):
    """(operations, bytes) of one anti-aliased activation over [B, T, C]: x read and y
    written once, alpha and 1 / beta in f32."""
    return SNAKE_OPS_PER_SAMPLE * b * c * t, 2 * elem * b * c * t + 8 * c


def snake_cases(torch, dev):
    """`ops.snake_aa` against its plain version at the bigvgan-narrate cell's shapes:
    the six stages of the published generator at (B=4, 256 frames) and (B=16, 448
    frames), bf16, x [B, T, C] contiguous as the convs leave it, the bias of the conv
    before it added as it loads; stage 5 at B=4 in f32. Each bf16 case also times
    every (channels a lane, outputs a lane) plan the kernel builds (`plans`: device
    ms from a replayed graph), from which `snake_aa.PLAN` is chosen."""
    from gonova_tts_tpu_torch.ops import snake_aa as sa
    from gonova_tts_tpu_torch.ops.gemm_tc_sweep import graph_ms

    cases = []
    shapes = [(b, frames, stage, c, per) for b, frames in ((4, 256), (16, 448))
              for stage, (c, per) in enumerate(zip((768, 384, 192, 96, 48, 24), (4, 16, 32, 64, 128, 256)), 1)]
    for (b, frames, stage, c, per), dtype in [(s, torch.bfloat16) for s in shapes] + [(shapes[4], torch.float32)]:
        t = frames * per
        g = torch.Generator(device=dev).manual_seed(b * 7 + stage)
        x = (torch.randn((b, t, c), generator=g, device=dev) * 2.0).to(dtype)
        consts = sa.constants(torch.randn(c, generator=g, device=dev) * 0.1, torch.randn(c, generator=g, device=dev) * 0.1)
        bias = torch.randn(c, generator=g, device=dev) * 0.1
        out, ref = sa.snake_aa(x, *consts, bias), sa.snake_aa_plain(x, *consts, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        if dtype == torch.bfloat16:
            rel, atol = SNAKE_BF16_STEP
            ok, tol = bool((err <= rel * ref.float().abs() + atol).all()), f"{rel} * |plain| + {atol}"
        else:
            ok = float(err.max()) <= SNAKE_F32_REL * max(1.0, float(ref.abs().max()))
            tol = f"{SNAKE_F32_REL} * max(1, |plain|)"
        ops_n, moved = snake_cost(b, c, t, x.element_size())
        bound_ms, bound_by = bound(moved, ops_n, "float32")
        device_ms = graph_ms(lambda: sa.snake_aa(x, *consts, bias), 10)
        case = {
            "case": f"stage {stage} C={c} B={b} T={frames} frames ({t} samples)", "dtype": name_of(dtype),
            "max_abs_err": float(err.max()), "tolerance": tol,
            "ok": ok and out.shape == x.shape and out.is_contiguous(), "plan": list(sa.PLAN),
            "ms": cuda_ms(lambda: sa.snake_aa(x, *consts, bias), 10), "device_ms": device_ms,
            "plain_ms": cuda_ms(lambda: sa.snake_aa_plain(x, *consts, bias), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share_pct": 100.0 * bound_ms / device_ms,
            "gbytes": moved / 1e9,
        }
        if dtype == torch.bfloat16:
            case["plans"] = {f"{v}x{sg}": graph_ms(lambda: sa._launch(x, *consts, bias, plan=(v, sg)), 10)
                             for v, sg in sa.PLANS}
        cases.append(case)
        del x, out, ref, err
        torch.cuda.empty_cache()
    return cases


BIGVGAN_V2 = dict(vocoder_family="bigvgan", n_mels=100, speaker_n_mels=80, upsample_initial_channel=1536,
                  upsample_rates=[4, 4, 2, 2, 2, 2], upsample_kernels=[8, 8, 4, 4, 4, 4],
                  resblock_kernels=[3, 7, 11], resblock_dilations=[[1, 3, 5]] * 3)


def conv_cases(torch, dev):
    """Every dilated conv of the published BigVGAN-v2 generator alone (C of each stage,
    k 3/7/11, d 3/5), bf16 at B=16 and 448 frames, and those of stages 0-2 again at
    B=4 and 256 frames; x [B, T, C] contiguous as the activation leaves it, the
    weights packed once (`layers._nwc_weights`, built before the timing) as in a
    served forward, the bias left to the activation after it: run dilated
    (`layers.conv1d_nwc`) and phase-split (`layers.conv1d_phased`), both
    channels-last, and dilated through the channels-first `layers.conv1d` as a
    yardstick (`ncw`: its weight cast per call, its bias added, cuDNN's layout
    conversions at both ends). Each path: the call's device ms from a replayed graph
    and its TFLOP/s (2 B C² k T operations), the kernel with the most device time in
    one profiled call (its name and ms), and, for the two channels-last paths, the
    error against the f32 sum of the same bf16 operands. The phase path against the
    dilated conv: both round the conv's f32 sum to bf16, so they may differ by a bf16
    step (2^-7) of it, plus the f32 noise of values near 0 (1e-4 of the largest). And
    whether the model's rule (`bigvgan.phase_split`) takes the phase path there."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import bigvgan, layers
    from gonova_tts_tpu_torch.ops.gemm_tc_sweep import graph_ms
    from gonova_tts_tpu_torch.utils.prof import device_events

    def top_kernel(fn):
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = device_events(prof)
        return (rows[0].key[:90], rows[0].self_device_time_total / 1e3) if rows else ("not measured", None)

    cfg = ModelConfig(**BIGVGAN_V2)
    per = [math.prod(cfg.upsample_rates[: i + 1]) for i in range(len(cfg.upsample_rates))]
    cases = []
    for b, frames, stage in [(16, 448, i) for i in range(len(per))] + [(4, 256, i) for i in range(3)]:
        c, t = cfg.upsample_initial_channel // 2 ** (stage + 1), frames * per[stage]
        g = torch.Generator(device=dev).manual_seed(stage)
        x = torch.randn((b, t, c), generator=g, device=dev).to(torch.bfloat16)
        for k in cfg.resblock_kernels:
            p = layers.leaf(w=torch.randn((k, c, c), generator=g, device=dev) * 0.01,
                            b=torch.randn(c, generator=g, device=dev) * 0.1)
            w32 = p["w"].bfloat16().float()
            flops = 2 * b * c * c * k * t
            for d in sorted({d for rd in cfg.resblock_dilations for d in rd if d > 1}):
                case = {"stage": stage, "C": c, "k": k, "d": d, "B": b, "T": t, "gflop": flops / 1e9,
                        "rule": bigvgan.phase_split(c, k, d)}
                paths = {"dilated": lambda: layers.conv1d_nwc(p, x, torch.bfloat16, dilation=d, bias=False),
                         "phased": lambda: layers.conv1d_phased(p, x, d, torch.bfloat16),
                         "ncw": lambda: layers.conv1d(p, x, dilation=d, dtype=torch.bfloat16)}
                for name, fn in paths.items():
                    fn()
                    ms = graph_ms(fn, 5)
                    kernel, kernel_ms = top_kernel(fn)
                    case[name] = {"device_ms": ms, "tflops": flops / ms / 1e9, "kernel": kernel, "kernel_ms": kernel_ms}
                ref, out = paths["dilated"](), paths["phased"]()
                with torch.backends.cudnn.flags(allow_tf32=False):
                    exact = layers._conv1d(w32, x.float(), 1, torch.float32, 1, d)
                torch.cuda.synchronize()
                err, ref = (out.float() - ref.float()).abs(), ref.float()
                for name, y in (("dilated", ref), ("phased", out.float())):
                    case[name]["max_err_vs_f32"] = float((y - exact).abs().max())
                rel, atol = SNAKE_BF16_STEP
                tol = rel * ref.abs() + atol * float(ref.abs().max())
                case.update(max_abs_err=float(err.max()), ref_max=float(ref.abs().max()),
                            ok=out.shape == ref.shape and out.is_contiguous() and bool((err <= tol).all()),
                            speedup=case["dilated"]["device_ms"] / case["phased"]["device_ms"])
                cases.append(case)
                del ref, out, err, exact, tol
                torch.cuda.empty_cache()
        del x
    return cases


def bigvgan_phase_error(torch, dev) -> dict:
    """One bf16 forward of the published generator (seed 0) at B=16 and 448 frames,
    its rule as it is against every dilated conv run dilated: the waveforms within
    the bound `tests/test_torch_bigvgan.py::test_generator_in_bf16_stays_within_its_bound`
    holds bf16 to (3% of the peak), and the phase-split convs counted."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import bigvgan

    cfg = ModelConfig(**BIGVGAN_V2)
    gen = bigvgan.init(torch.Generator().manual_seed(0), cfg).to(dev)
    mel = torch.randn((16, 448, 100), generator=torch.Generator(device=dev).manual_seed(1), device=dev) * 2.0
    before = ops.launch_counts().get("conv_phased", 0)
    with torch.no_grad():
        got = bigvgan.forward(gen, mel, cfg, torch.bfloat16)
        phased = ops.launch_counts().get("conv_phased", 0) - before
        rule = bigvgan.phase_split
        bigvgan.phase_split = lambda c, k, d: False
        try:
            want = bigvgan.forward(gen, mel, cfg, torch.bfloat16)
        finally:
            bigvgan.phase_split = rule
    torch.cuda.synchronize()
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    del gen
    torch.cuda.empty_cache()
    return {"case": "generator B=16 T=448 frames bf16, the rule vs all dilated", "max_abs_err": err, "peak": peak,
            "tolerance": f"0.03 * {peak}", "phased_convs": phased, "rule_convs": len(bigvgan.phased_convs(cfg)),
            "ok": err <= 0.03 * peak and phased == len(bigvgan.phased_convs(cfg))}


def run_bigvgan_service(torch, np, report):
    """BigVGAN-v2 on the path the bigvgan-narrate cell serves: a TTSService (bf16,
    the acoustic kernels, the engine's default dispatch and its CUDA graphs captured at
    warm-up) over the demo checkpoint's acoustic model and speaker encoder, with a
    100-band mel head and the published generator from seed 0. Launch counts and the
    engine's pass counters from zero just before eight synthesize_full calls (the REST
    method), read just after: every pass replayed, and 109 `snake_aa` launches, 116
    channels-last convs (`conv_nwc`) and `len(bigvgan.phased_convs(cfg))` phase-split
    convs for each pass's one vocoder forward."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
    from gonova_tts_tpu_torch.models import bigvgan
    from gonova_tts_tpu_torch.service import TTSService

    mcfg = ModelConfig(**BIGVGAN_V2, compute_dtype="bfloat16")
    demo = np.load(DEMO)
    tree = {k: demo[k] for k in demo.files if k.startswith(("acoustic/", "speaker/")) and "mel_out" not in k}
    g = torch.Generator().manual_seed(0)
    gen = bigvgan.init(g, mcfg)
    tree.update({f"vocoder/{k.replace('.', '/')}": v.half().numpy() for k, v in gen.state_dict().items()})
    d_model = demo["acoustic/mel_out/w"].shape[0]
    tree["acoustic/mel_out/w"] = (torch.randn((d_model, 100), generator=g) * (2.0 / (d_model + 100)) ** 0.5).half().numpy()
    tree["acoustic/mel_out/b"] = np.zeros((100,), np.float16)
    del gen
    out = {}

    async def drive(path):
        cfg = Config()
        cfg.model = mcfg.model_copy(update={"model_path": path})
        # Every batch bucket at the sentences' token buckets, so that each pass has a graph.
        cfg.engine = EngineConfig(acoustic_pallas=True, warmup_shapes=[[b, t] for b in (1, 4, 8, 16) for t in (32, 64)])
        cfg.voice_cloning.default_voice_path = None
        cfg.logging.level = "WARNING"
        t0 = time.perf_counter()
        svc = TTSService(cfg)
        await svc.start()
        out["start_s"] = time.perf_counter() - t0
        eng = svc.synthesizer.engine
        out["graphs_captured"] = eng.stats["graphs_captured"]
        before = {k: eng.stats[k] for k in ("graph_passes", "eager_passes")}
        ops.reset_launch_counts()
        docs = [" ".join(SENTENCES[i:] + SENTENCES[:i]) for i in range(len(SENTENCES))] * 2
        audio = await asyncio.gather(*[svc.synthesize_full(d) for d in docs])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        passes = {k: eng.stats[k] - v for k, v in before.items()}
        await svc.shutdown()
        return audio, launches, passes

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bigvgan_v2.npz")
        np.savez(path, **tree)
        del tree
        audio, launches, passes = asyncio.run(drive(path))
    forwards = passes["graph_passes"] + passes["eager_passes"]
    out.update(requests=len(audio), passes=passes, vocoder_forwards=forwards, launches=launches,
               audio_s=sum(a.size for a in audio) / 24000)
    checks = {
        "bigvgan_audio_finite_nonempty": all(a.size > 0 and np.isfinite(a).all() for a in audio),
        "bigvgan_every_pass_replayed": forwards > 0 and passes["eager_passes"] == 0,
        "bigvgan_snake_aa_109_a_forward": launches.get("snake_aa", 0) == 109 * forwards,
        "bigvgan_conv_phased_a_forward": launches.get("conv_phased", 0) == len(bigvgan.phased_convs(mcfg)) * forwards,
        "bigvgan_conv_nwc_a_forward": launches.get("conv_nwc", 0) == bigvgan.convs(mcfg) * forwards,
    }
    out["checks"] = checks
    report["bigvgan"] = out
    return launches, checks


def snake_entry(cases, bigvgan: dict) -> dict:
    """`launches`: the count on the bigvgan service path (`run_bigvgan_service`)."""
    rep = next(c for c in cases if c["case"].startswith("stage 1 C=768 B=16") and c["dtype"] == "bfloat16")
    return {
        "name": "snake_aa", "route": "cuda", "source": "gonova_tts_tpu_torch/csrc/snake_aa.cu",
        "replaces": None, "launches": bigvgan["launches"].get("snake_aa", 0),
        "vocoder_forwards": bigvgan["vocoder_forwards"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **{k: rep[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "at": f"{rep['case']} bfloat16", "cases": cases,
    }


def block_weights(blk):
    return (blk["dw"], blk["dw_b"], blk["ln"]["g"], blk["ln"]["b"], blk["pw1"]["w"], blk["pw1"]["b"],
            blk["pw2"]["w"], blk["pw2"]["b"], blk["gamma"])


def convnext_cases(model, torch, dev, rng):
    """The checkpoint's block 0 at B=4 T=320 and B=1 T=300, for (x f32, MLP f32),
    (x f32, MLP bf16) and (x bf16, MLP bf16)."""
    from gonova_tts_tpu_torch.ops import convnext_block as cb
    from gonova_tts_tpu_torch.ops.gemm_tc_sweep import graph_ms

    w = block_weights(model.vocoder.blocks[0])
    cases = []
    for b, t in ((4, 320), (1, 300)):
        for x_dt, bf16 in ((torch.float32, False), (torch.float32, True), (torch.bfloat16, True)):
            x = torch.as_tensor(rng.standard_normal((b, t, 512)).astype("float32"), device=dev).to(x_dt)
            out = cb.convnext_block(x, *w, bf16=bf16)
            ref = cb.convnext_block_plain(x, *w, bf16=bf16)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = KERNEL_BF16_BOUND if bf16 else KERNEL_F32_BOUND
            ok = out.dtype == x_dt and bool(torch.isfinite(out.float()).all()) and err <= tol
            c, f = 512, w[4].shape[-1]
            flops = b * t * (4 * c * f + 2 * 7 * c)
            esz = 2 if bf16 else 4  # the MLP weights are read in the MLP dtype
            moved = nbytes(x, out) + esz * 2 * c * f + 4 * (7 * c + 5 * c + f)
            mlp = "bfloat16" if bf16 else "float32"
            bound_ms, bound_by = bound(moved, flops, mlp)
            md = torch.bfloat16 if bf16 else torch.float32
            rows, w1, w2 = torch.zeros((b * t, c), dtype=md, device=dev), w[4].to(md), w[6].to(md)
            hid = torch.zeros((b * t, f), dtype=md, device=dev)
            cases.append({
                "case": f"B={b} T={t}", "dtype": f"x {name_of(x_dt)}, mlp {mlp}", "max_abs_err": err,
                "tolerance": tol, "ok": ok,
                "ms": cuda_ms(lambda: cb.convnext_block(x, *w, bf16=bf16), 10),
                "device_ms": graph_ms(lambda: cb.convnext_block(x, *w, bf16=bf16), 10),
                "plain_ms": cuda_ms(lambda: cb.convnext_block_plain(x, *w, bf16=bf16), 10),
                "matmul_ms": graph_ms(lambda: (torch.matmul(rows, w1), torch.matmul(hid, w2)), 10),
                "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            })
    return cases


def convnext_chain(model, torch, dev, rng):
    """The single-block kernel's own path: the vocoder body as eight launches of
    `convnext_block` (f32, B=4 T=320, checkpoint weights), launch count from zero,
    against the stack kernel on the same input."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.ops import convnext_block as cb
    from gonova_tts_tpu_torch.ops import vocos_stack as vs

    x = torch.as_tensor(rng.standard_normal((4, 320, 512)).astype("float32"), device=dev)
    packed = vs.pack_params(model.vocoder.blocks, torch.float32)
    ops.reset_launch_counts()
    y = x
    for blk in model.vocoder.blocks:
        y = cb.convnext_block(y, *block_weights(blk), bf16=False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["convnext_block"]
    err = float((y - vs.vocos_stack(x, packed, False)).abs().max())
    ok = launches == len(model.vocoder.blocks) and bool(torch.isfinite(y).all()) and err <= CHAIN_VS_STACK_BOUND
    return {"case": "8 blocks chained vs vocos_stack B=4 T=320", "dtype": "float32", "max_abs_err": err,
            "tolerance": CHAIN_VS_STACK_BOUND, "launches": launches, "ok": ok}


def device_kernels(torch, fn):
    """(fn(), the names of the device kernels it ran) from one torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def convnext_chain_bf16(model, torch, dev, rng):
    """The same chain with x and the MLP in bf16, the tensor-core route: the block's
    launch count from zero, and the device kernels it ran from the profiler (each block
    one dwconv_ln and two of the shared GEMM's gemm_tc_kernel), against eight plain
    blocks."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.ops import convnext_block as cb

    def chain(x):
        for blk in model.vocoder.blocks:
            x = cb.convnext_block(x, *block_weights(blk), bf16=True)
        return x

    x = torch.as_tensor(rng.standard_normal((4, 320, 512)).astype("float32"), device=dev).bfloat16()
    ops.reset_launch_counts()
    y, names = device_kernels(torch, lambda: chain(x))
    launches = ops.launch_counts()["convnext_block"]
    tc_kernels = sum("gemm_tc_kernel" in k for k in names)
    dw_kernels = sum("dwconv_ln_kernel" in k for k in names)
    ref = x
    for blk in model.vocoder.blocks:
        ref = cb.convnext_block_plain(ref, *block_weights(blk), bf16=True)
    err = float((y.float() - ref.float()).abs().max())
    n = len(model.vocoder.blocks)
    ok = (launches == n and tc_kernels == 2 * n and dw_kernels == n and y.dtype == torch.bfloat16
          and bool(torch.isfinite(y.float()).all()) and err <= KERNEL_BF16_BOUND)
    return {"case": "8 blocks chained vs 8 plain blocks B=4 T=320", "dtype": "x bfloat16, mlp bfloat16",
            "max_abs_err": err, "tolerance": KERNEL_BF16_BOUND, "launches": launches,
            "gemm_tc_kernels": tc_kernels, "dwconv_ln_kernels": dw_kernels, "ok": ok}


# ------------------------------------------------------------------ phase 4


def engine_config(dtype: str, kernels: bool):
    from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig

    cfg = Config()
    cfg.model = ModelConfig(model_path=DEMO, compute_dtype=dtype, vocos_pallas=kernels)
    cfg.engine = EngineConfig(acoustic_pallas=kernels, warmup_shapes=[[1, 32], [4, 32], [4, 64]])
    return cfg


def max_diff(a_list, b_list) -> float:
    worst = 0.0
    for a, b in zip(a_list, b_list):
        if a.shape != b.shape:
            return float("inf")
        worst = max(worst, float(abs(a - b).max()) if a.size else 0.0)
    return worst


def run_engine(torch, np, report):
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.engine import TTSEngine
    from gonova_tts_tpu_torch.models import tts
    from parity_gpu import one_shot

    t0 = time.perf_counter()
    eng = TTSEngine(engine_config("bfloat16", kernels=True))
    eng.load(warmup=True)
    report["engine_load_s"] = time.perf_counter() - t0
    if not (eng.mcfg.acoustic_pallas and eng.mcfg.vocos_pallas):
        fail("kernel switches did not reach the model config")

    # The one-shot references first, outside the window.
    one = one_shot(eng, SENTENCES)
    long_one = one_shot(eng, [LONG_SENTENCE])
    # The main path: launch counts from zero, read right after.
    ops.reset_launch_counts()
    two = eng.synthesize_batch(SENTENCES)
    chunks = list(eng.synthesize_stream(STREAM_TEXT))
    long_two = eng.synthesize_batch([LONG_SENTENCE])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    n_requests = len(SENTENCES) + 1 + 1
    report["main_path"] = {"requests": n_requests, "launches": launches}

    from gonova_tts_tpu_torch.text import batch_to_bucket, pick_bucket, segment_text, text_to_ids

    long_bucket = pick_bucket(len(text_to_ids(LONG_SENTENCE)), eng.ecfg.token_buckets)
    streamed = np.concatenate(chunks)
    # One-shot reference: each sentence alone, at the shapes the stream used.
    whole = np.concatenate([one_shot(eng, [s])[0] for s in segment_text(STREAM_TEXT)])
    checks = {
        "finite_nonempty": all(np.isfinite(w).all() and w.size > 0 for w in one + two + chunks + long_one + long_two),
        "launches_positive": all(launches.get(k, 0) > 0 for k in ("transformer_stack", "vocos_stack")),
        "long_sentence_bucket_128": long_bucket == 128,
    }
    diffs = {
        "two_stage_vs_one_shot": max_diff(one, two),
        "two_stage_vs_one_shot_plain_local": max_diff(long_one, long_two),
        "stream_vs_one_shot": max_diff([streamed], [whole]),
    }
    for k, v in diffs.items():
        checks[k] = v <= ENGINE_BOUNDS[k]

    # bf16 kernel path vs f32 plain path, at the same durations: f32 encode, then
    # decode + vocode in both modes from the same token-domain result.
    ref = TTSEngine(engine_config("float32", kernels=False))
    ref.load(warmup=False)
    ids = [text_to_ids(s) for s in SENTENCES]
    tokens, lengths, bucket = batch_to_bucket(ids, eng.ecfg.token_buckets)
    dev = eng.device
    tok = torch.as_tensor(tokens, device=dev)
    mask = torch.as_tensor((np.arange(bucket)[None] < lengths[:, None]).astype(np.float32), device=dev)
    spk = torch.zeros((len(ids), eng.mcfg.speaker_dim), device=dev)
    ex = torch.full((len(ids),), 0.5, device=dev)
    t_full = bucket * eng.mcfg.max_frames_per_token
    with torch.inference_mode():
        e = tts.encode_acoustic(ref.params, tok, mask, spk, ex, ref.mcfg, torch.float32)
        e_bf = tts.encode_acoustic(eng.params, tok, mask, spk, ex, eng.mcfg, torch.bfloat16)
        a32 = tts.decode_vocode(ref.params, e["enc"], e["spk"], e["durations"], mask, t_full, ref.mcfg, torch.float32)["audio"]
        abf = tts.decode_vocode(
            eng.params, e["enc"].bfloat16(), e["spk"].bfloat16(), e["durations"], mask, t_full, eng.mcfg,
            torch.bfloat16,
        )["audio"].float()
    rel = float(torch.linalg.norm(abf - a32) / torch.linalg.norm(a32))
    enc_rel = float(torch.linalg.norm(e_bf["enc"].float() - e["enc"]) / torch.linalg.norm(e["enc"]))
    same_durations = int((e_bf["durations"] == e["durations"]).all(dim=1).sum())
    checks["bf16_vs_f32"] = rel <= BF16_VS_F32_REL_L2

    # The dispatch rule itself, in f32 through the kernels: two-stage == one-shot.
    ref.mcfg = ref.mcfg.model_copy(update={"acoustic_pallas": True, "vocos_pallas": True})
    k = "f32_two_stage_vs_one_shot"
    diffs[k] = max_diff(one_shot(ref, SENTENCES), ref.synthesize_batch(SENTENCES))
    checks[k] = diffs[k] <= ENGINE_BOUNDS[k]
    report["agreement"] = {
        **diffs, "bounds": ENGINE_BOUNDS,
        "bf16_kernel_vs_f32_plain_audio_rel_l2_same_durations": rel,
        "bf16_vs_f32_bound": BF16_VS_F32_REL_L2,
        "bf16_vs_f32_encoder_rel_l2": enc_rel,
        "bf16_vs_f32_rows_with_equal_durations": f"{same_durations}/{len(ids)}",
    }
    report["checks"] = checks

    # Serving speed, warm.
    speed = {}
    for b in (1, 4, 16):
        texts = [SENTENCES[i % len(SENTENCES)] for i in range(b)]
        eng.synthesize_batch(texts)
        torch.cuda.synchronize()
        reps, t0, samples = 5, time.perf_counter(), 0
        for _ in range(reps):
            samples += sum(w.size for w in eng.synthesize_batch(texts))
        dt = time.perf_counter() - t0
        speed[f"batch{b}"] = {
            "audio_s_per_s": samples / eng.sample_rate / dt, "latency_ms_per_batch": dt / reps * 1e3,
        }
    t0 = time.perf_counter()
    gen = eng.synthesize_stream(STREAM_TEXT)
    next(gen)
    speed["stream_first_chunk_ms"] = (time.perf_counter() - t0) * 1e3
    list(gen)
    report["speed"] = speed
    report["profile_batch4_two_stage"] = profile(eng, torch, speed["batch4"]["latency_ms_per_batch"])
    return launches, checks


def profile(eng, torch, unprofiled_ms: float) -> dict:
    """Device time by kernel over one warm batch-4 request. The first
    profiled run pays the tracer's start-up and is discarded; the idle share is
    taken against the request's unprofiled latency."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from gonova_tts_tpu_torch.utils.prof import device_events

    for _ in range(2):
        eng.synthesize_batch(SENTENCES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.synthesize_batch(SENTENCES)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_events(prof)
    if not rows:
        return {"note": "the profiler saw no device time: not measured"}
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return {
        "profiled_wall_ms": wall_ms, "unprofiled_latency_ms": unprofiled_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / unprofiled_ms),
        "top": top_events(rows[:14]),
    }


def top_events(events, per: int = 1) -> list:
    """The events' names, device ms and calls, each divided by `per` (steps)."""
    return [{"kernel": e.key[:70], "ms": e.self_device_time_total / 1e3 / per, "calls": e.count / per}
            for e in events]


# ------------------------------------------------------------------ phase 5


def test_signal(np, sr: int, seconds: float, seed: int):
    """A seeded voiced-like reference: three harmonics under a slow envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    tone = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 140.0), (0.15, 280.0), (0.08, 420.0)))
    return ((0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)) * tone + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def run_voice(torch, np, report):
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.audio import resample
    from gonova_tts_tpu_torch.engine import DynamicBatcher, TTSEngine, VoiceEmbeddingCache
    from gonova_tts_tpu_torch.models import tts
    from gonova_tts_tpu_torch.ops.mel_spectrogram import mel_spectrogram_plain
    from gonova_tts_tpu_torch.service import StreamingSynthesizer, VoiceManager
    from gonova_tts_tpu_torch.utils import read_wav

    with open(VOICE_WAV, "rb") as fh:
        payload = base64.b64encode(fh.read()).decode()
    signals = {sr: test_signal(np, sr, 3.0, sr) for sr in (48000, 44100)}
    synth = StreamingSynthesizer(engine_config("bfloat16", kernels=True))
    out = {}

    async def stream(text, voice):
        return np.concatenate([c async for c in synth.synthesize_streaming(text, voice_embedding=voice, exaggeration=0.5)])

    async def drive(voice_dir):
        await synth.load()
        eng = synth.engine
        if not (eng.ecfg.mel_pallas and eng.device.type == "cuda"):
            fail("the voice path would not take the mel kernel")
        voices, cache = VoiceManager(cache_dir=voice_dir), VoiceEmbeddingCache()
        # A window only a full batch ends: the four submits always share it.
        batcher = DynamicBatcher(eng, max_batch=len(SENTENCES), window_ms=5000.0)
        await batcher.start()
        # The main path: launch counts from zero, read right after.
        ops.reset_launch_counts()
        await voices.register_voice("smoke-voice", payload)
        path = await voices.get_voice("smoke-voice")
        t0 = time.perf_counter()
        emb = eng.embed_voice_file(path)
        out["embed_voice_cold_ms"] = (time.perf_counter() - t0) * 1e3
        cache.put("smoke-voice", emb)
        t0 = time.perf_counter()
        again = eng.embed_voice_file(path)
        out["embed_voice_warm_ms"] = (time.perf_counter() - t0) * 1e3
        resampled = {sr: await synth.extract_voice_embedding(sig, sr) for sr, sig in signals.items()}
        cloned = [await stream(s, cache.get("smoke-voice")) for s in SENTENCES]
        by_path = await stream(SENTENCES[0], path)
        batched = await asyncio.gather(*[batcher.submit(s, speaker=cache.get("smoke-voice")) for s in SENTENCES])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        await batcher.stop()
        default = await stream(SENTENCES[0], None)
        return eng, path, emb, again, resampled, cloned, by_path, batched, default, launches, batcher.metrics

    with tempfile.TemporaryDirectory() as voice_dir:
        eng, path, emb, again, resampled, cloned, by_path, batched, default, launches, metrics = asyncio.run(drive(voice_dir))
        audio, sr = read_wav(path)

    # The embedding through the kernel's mel vs through the plain mel, f32 and bf16.
    ref = TTSEngine(engine_config("float32", kernels=False))
    ref.load(warmup=False)
    emb_diff = {}
    with torch.inference_mode():
        for name, e, dt in (("f32", ref, torch.float32), ("bf16", eng, torch.bfloat16)):
            buf, valid = e.analysis_buffer(np.asarray(audio, np.float32), sr)
            mask = (torch.arange(buf.shape[1] // e.hop, device=e.device)[None] < valid).float()
            plain = tts.embed_speaker(e.params, mel_spectrogram_plain(buf), mask, dtype=dt)[0].float().cpu().numpy()
            emb_diff[name] = float(np.abs(e.embed_voice(np.asarray(audio, np.float32), sr) - plain).max())
        resample_diff = max(
            float((resample(torch.as_tensor(sig, device=eng.device), sr_in, 24000).cpu()
                   - resample(torch.as_tensor(sig), sr_in, 24000)).abs().max())
            for sr_in, sig in signals.items()
        )
    embeddings = [emb, again, *resampled.values()]
    norm_err = max(abs(float(np.linalg.norm(e)) - 1.0) for e in embeddings)
    batch_vs_stream = max_diff(list(batched), cloned)
    b = VOICE_BOUNDS
    checks = {
        "voice_launches_positive": all(launches.get(k, 0) > 0 for k in ("mel_spectrogram", "transformer_stack", "vocos_stack")),
        "embeddings_finite_shape": all(e.shape == (eng.mcfg.speaker_dim,) and np.isfinite(e).all() for e in embeddings),
        "embeddings_unit_norm": norm_err <= b["embedding_unit_norm"],
        "embedding_repeats": bool(np.array_equal(emb, again)),
        "embedding_depends_on_voice": float(np.abs(emb - resampled[48000]).max()) > 1e-3,
        "embedding_kernel_mel_vs_plain_mel_f32": emb_diff["f32"] <= b["embedding_kernel_mel_vs_plain_mel_f32"],
        "embedding_kernel_mel_vs_plain_mel_bf16": emb_diff["bf16"] <= b["embedding_kernel_mel_vs_plain_mel_bf16"],
        "resample_card_vs_cpu": resample_diff <= b["resample_card_vs_cpu"],
        "cloned_finite_nonempty": all(np.isfinite(w).all() and w.size > 0 for w in cloned + [by_path] + list(batched)),
        "cloned_differs_from_default_speaker": cloned[0].shape != default.shape or float(np.abs(cloned[0] - default).max()) > 1e-3,
        "path_and_array_embeddings_same_audio": bool(np.array_equal(cloned[0], by_path)),
        "cloned_batch_vs_stream": batch_vs_stream <= b["cloned_batch_vs_stream"],
        "batcher_coalesced": metrics["requests"] == len(SENTENCES) and metrics["batches"] < len(SENTENCES),
    }
    report["voice_path"] = {
        "requests": {"embed": 4, "stream": len(SENTENCES) + 1, "batched": len(SENTENCES)}, "launches": launches,
        **out, "embedding_kernel_mel_vs_plain_mel": emb_diff, "embedding_unit_norm_err": norm_err,
        "resample_card_vs_cpu": resample_diff, "cloned_batch_vs_stream": batch_vs_stream,
        "batcher": metrics, "bounds": VOICE_BOUNDS, "checks": checks,
    }
    return launches, checks


# ------------------------------------------------------------------ phase 6


def synthesis_ok(frames, metadata=False) -> bool:
    """Binary frames then synthesis_complete with chunk_id = their count (after a
    synthesis_started where metadata was asked)."""
    kinds = [k for _, k, _ in frames]
    if metadata:
        if not frames or frames[0][2] != {"type": "synthesis_started"}:
            return False
        frames, kinds = frames[1:], kinds[1:]
    n = len(frames) - 1
    return (n > 0 and kinds[:n] == ["binary"] * n
            and frames[-1][2] == {"type": "synthesis_complete", "chunk_id": n})


def pcm_of(np, frames):
    return [np.frombuffer(p, np.float32) for _, k, p in frames if k == "binary"]


def percentiles(np, xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)), "p95": float(np.percentile(xs, 95)), "n": len(xs)}


def run_service(torch, np, report):
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.audio import encode
    from gonova_tts_tpu_torch.service import TTSService
    from gonova_tts_tpu_torch.service.memory_socket import MemorySocket
    from gonova_tts_tpu_torch.utils import read_wav, write_wav

    # The registered voice is the default voice's samples declared at 30 kHz: the same
    # speaker a quarter higher and 4 s long, so the clone must differ from the default.
    voice, _ = read_wav(VOICE_WAV)
    payload = base64.b64encode(write_wav(None, voice, 30000)).decode()
    formats = encode.available_formats(24000)
    out = {"formats_offered": formats}

    async def timed_request(sock, message):
        """(frames, ms to the first binary frame or None, ms to the last frame, seconds
        of pcm audio)."""
        t0, frames = await sock.request(message, ("synthesis_complete", "error"))
        first = [t for t, k, _ in frames if k == "binary"][:1]
        pcm = message.get("format", "pcm") == "pcm"
        audio_s = sum(p.size for p in pcm_of(np, frames)) / 24000 if pcm else 0.0
        return frames, (first[0] - t0) * 1e3 if first else None, (frames[-1][0] - t0) * 1e3, audio_s

    async def drive(voice_dir):
        cfg = engine_config("bfloat16", kernels=True)
        cfg.voice_cloning.cache_dir = voice_dir
        cfg.voice_cloning.default_voice_path = VOICE_WAV
        cfg.logging.level = "WARNING"
        t0 = time.perf_counter()
        svc = TTSService(cfg)
        await svc.start()
        out["start_s"] = time.perf_counter() - t0
        eng = svc.synthesizer.engine
        if not (eng.device.type == "cuda" and eng.mcfg.acoustic_pallas and eng.mcfg.vocos_pallas and eng.ecfg.mel_pallas):
            fail("the service would not take the kernels")
        checks = {"default_voice_loaded": svc._default_speaker is not None}
        # Each device pass the batcher dispatches, timed on the host clock (the engine
        # returns host arrays, so a pass ends after its readback): (start, end, batch).
        passes, run_batch = [], eng.synthesize_batch

        def timed_batch(texts, *args, **kwargs):
            start = time.perf_counter()
            result = run_batch(texts, *args, **kwargs)
            passes.append((start, time.perf_counter(), len(texts)))
            return result

        eng.synthesize_batch = timed_batch
        # The main path: launch counts from zero, read right after.
        ops.reset_launch_counts()

        sock = MemorySocket()
        conn = asyncio.create_task(svc.handle_connection(sock, "smoke-0"))
        _, reg = await sock.request({"type": "register_voice", "voice_id": "smoke-voice", "reference_audio": payload},
                                    ("voice_registered", "error"))
        checks["voice_registered"] = reg[-1][2] == {"type": "voice_registered", "voice_id": "smoke-voice"}
        say = {"type": "synthesize", "text": SENTENCES[0]}
        cloned, *_ = await timed_request(sock, {**say, "voice_id": "smoke-voice"})
        nobody, *_ = await timed_request(sock, {**say, "voice_id": "nobody"})
        default, *_ = await timed_request(sock, say)
        _, listed = await sock.request({"type": "list_voices"}, ("voice_list",))
        checks["voice_list"] = any(v["voice_id"] == "smoke-voice" for v in listed[-1][2]["voices"])
        encoded = {}
        for fmt in [f for f in ("wav", "mp3", "opus") if f in formats]:
            encoded[fmt], *_ = await timed_request(sock, {**say, "voice_id": "smoke-voice", "format": fmt})
        announced, *_ = await timed_request(sock, {**say, "metadata": True})
        _, cancelled = await sock.request({"type": "cancel"}, ("cancelled",))
        checks["cancelled"] = cancelled[-1][2] == {"type": "cancelled"}

        # TTFA at concurrency 1: 16 requests in turn on one connection.
        mark = len(passes)
        c1 = [await timed_request(sock, {"type": "synthesize", "text": SENTENCES[i % 4]}) for i in range(16)]
        c1_passes = [(e - b) * 1e3 for b, e, _ in passes[mark:]]
        await sock.end()
        await conn

        # Concurrency 4: four connections at once, one sentence each, four rounds.
        c4, c4_wall, c4_audio, c4_rounds = [], 0.0, 0.0, []
        for r in range(4):
            socks = [MemorySocket() for _ in SENTENCES]
            conns = [asyncio.create_task(svc.handle_connection(s, f"smoke-{r}-{i}")) for i, s in enumerate(socks)]
            mark, t0 = len(passes), time.perf_counter()
            rs = await asyncio.gather(*[timed_request(s, {"type": "synthesize", "text": t}) for s, t in zip(socks, SENTENCES)])
            c4_wall += time.perf_counter() - t0
            c4_rounds.append({  # ms from the round's first send
                "ttfa_ms": [x[1] for x in rs],
                "passes_start_end_batch": [((b - t0) * 1e3, (e - t0) * 1e3, n) for b, e, n in passes[mark:]],
            })
            c4_audio += sum(x[3] for x in rs)
            c4 += rs
            for s in socks:
                await s.end()
            await asyncio.gather(*conns)

        full = await svc.synthesize_full(STREAM_TEXT)
        spk = svc.voice_embeddings.get("smoke-voice")
        direct = await svc.batcher.submit(SENTENCES[0], spk, cfg.synthesis.default_exaggeration)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        health_status, health = svc.health()
        metrics, prom = svc.metrics(), svc.metrics_prometheus()
        batcher = dict(svc.batcher.metrics)
        t0 = time.perf_counter()
        await svc.shutdown()
        out["shutdown_s"] = time.perf_counter() - t0

        requests = [cloned, nobody, default, announced, *encoded.values()] + [x[0] for x in c1 + c4]
        pcm_requests = [cloned, nobody, default] + [x[0] for x in c1 + c4]
        checks["frame_order"] = all(synthesis_ok(f) for f in requests if f is not announced) and synthesis_ok(announced, True)
        checks["pcm_finite_nonempty"] = all(
            p.size > 0 and np.isfinite(p).all() for f in pcm_requests + [announced] for p in pcm_of(np, f)
        )
        ws_cloned, ws_nobody, ws_default = (np.concatenate(pcm_of(np, f)) for f in (cloned, nobody, default))
        checks["cloned_differs_from_default_voice"] = (
            ws_cloned.shape != ws_default.shape or float(np.abs(ws_cloned - ws_default).max()) > 1e-3)
        fallback = max_diff([ws_nobody], [ws_default])
        checks["unknown_voice_is_default_voice"] = fallback <= SERVICE_FALLBACK_BOUND
        ws_vs_batcher = max_diff([ws_cloned], [direct])
        checks["cloned_ws_vs_batcher"] = ws_vs_batcher <= VOICE_BOUNDS["cloned_batch_vs_stream"]
        wav = b"".join(p for _, k, p in encoded.get("wav", []) if k == "binary")
        wav_pcm = np.frombuffer(wav[44:], np.int16).astype(np.int32)
        pcm16 = np.clip(ws_cloned * 32767.0, -32767.0, 32767.0).astype(np.int16).astype(np.int32)
        checks["wav_framing_matches_pcm"] = (
            wav[:4] == b"RIFF" and wav_pcm.shape == pcm16.shape and int(np.abs(wav_pcm - pcm16).max()) <= 1)
        blobs = {f: b"".join(p for _, k, p in fr if k == "binary") for f, fr in encoded.items()}
        checks["encoded_formats"] = all(synthesis_ok(fr) for fr in encoded.values()) and (
            "mp3" not in blobs or (blobs["mp3"][0] == 0xFF and (blobs["mp3"][1] & 0xE0) == 0xE0)) and (
            "opus" not in blobs or (blobs["opus"][:4] == b"OggS" and b"OpusHead" in blobs["opus"][:64]))
        full_s = full.size / 24000
        checks["synthesize_full"] = bool(np.isfinite(full).all()) and 1.0 < full_s < 20.0
        checks["health"] = (health_status == 200 and health["status"] == "healthy"
                            and health["tpu"]["backend"] == "cuda" and health["tpu"]["device_count"] >= 1)
        checks["metrics"] = metrics["requests_received"] >= len(requests) and "gonova_tts_batcher_batches" in prom
        checks["shutdown"] = out["shutdown_s"] < SERVICE_SHUTDOWN_S and svc.active_connections == 0
        checks["service_launches_positive"] = all(
            launches.get(k, 0) > 0 for k in ("mel_spectrogram", "transformer_stack", "vocos_stack"))
        checks["ttfa_every_request"] = all(x[1] is not None for x in c1 + c4)
        c1_audio, c1_wall = sum(x[3] for x in c1), sum(x[2] for x in c1) / 1e3
        ttfa = lambda rs: percentiles(np, [x[1] for x in rs if x[1] is not None] or [float("nan")])  # noqa: E731
        out.update({
            "ttfa_ms": {"concurrency1": ttfa(c1), "concurrency4": ttfa(c4)},
            "complete_ms": {"concurrency1": percentiles(np, [x[2] for x in c1]), "concurrency4": percentiles(np, [x[2] for x in c4])},
            "audio_s_per_s": {"concurrency1": c1_audio / c1_wall, "concurrency4": c4_audio / c4_wall},
            "engine_pass_ms_concurrency1": percentiles(np, c1_passes), "concurrency4_rounds": c4_rounds,
            "synthesize_full_audio_s": full_s, "unknown_voice_vs_default": fallback,
            "cloned_ws_vs_batcher": ws_vs_batcher, "batcher": batcher, "launches": launches,
            "health": {k: health[k] for k in ("status", "device", "tpu", "device_health")},
            "checks": checks,
        })
        return launches, checks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as voice_dir:
        launches, checks = asyncio.run(drive(voice_dir))
    out["phase_s"] = time.perf_counter() - t0
    report["service"] = out
    return launches, checks


# ------------------------------------------------------------------ phase 7


def run_parity(torch, np, report):
    """parity_gpu's three lines. Launch counts are set to 0 just before each line's
    run and read just after (the demo engine's load and warm-up fall outside), and
    every line must have launched both stack kernels."""
    import parity_gpu
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import params, tts

    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def counted(fn, weights):
        ops.reset_launch_counts()
        line = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        return {**line, "weights": weights, "launches": {k: counts.get(k, 0) for k in parity_gpu.STACKS}}

    model = tts.TTS(ModelConfig(), torch.Generator().manual_seed(0)).to(dev)
    lines = [counted(lambda: parity_gpu.parity(model, ModelConfig()), "random seed 0")]
    model, cfg = params.load_checkpoint(parity_gpu.DEMO, ModelConfig(), dev)
    lines.append(counted(lambda: parity_gpu.parity(model, cfg), "demo_ema_f16.npz"))
    del model
    eng = parity_gpu.demo_engine(dev)
    lines.append(counted(lambda: parity_gpu.engine_parity(eng), "demo_ema_f16.npz"))
    launches = {k: sum(line["launches"][k] for line in lines) for k in parity_gpu.STACKS}
    names = ("parity_random_init", "parity_demo_checkpoint", "parity_two_stage_vs_one_shot")
    checks = {}
    for name, line in zip(names, lines):
        checks[name] = line["pass"]
        checks[name + "_launched_both_stacks"] = all(line["launches"][k] > 0 for k in parity_gpu.STACKS)
    report["parity"] = {"lines": lines, "launches": launches, "phase_s": time.perf_counter() - t0, "checks": checks}
    return launches, checks


# ------------------------------------------------------------------ phase 8


class LogRecords:
    """Collects the trainer's structured log events (event name, fields)."""

    def __init__(self, name):
        import logging

        self.events = []
        self.logger = logging.getLogger(name)
        self.logger.setLevel(logging.INFO)  # the service phase set the root to WARNING
        self.handler = logging.Handler()
        self.handler.emit = lambda r: self.events.append((r.getMessage(), dict(getattr(r, "_fields", {}))))
        self.logger.addHandler(self.handler)

    def close(self):
        self.logger.removeHandler(self.handler)


def train_card_vs_cpu(torch, np, smi):
    """Three f32 steps on the card and on the CPU from one tree and one batch."""
    import copy

    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import tts
    from gonova_tts_tpu_torch.train import step as tstep

    cfg = ModelConfig()
    model = tts.TTS(cfg, torch.Generator().manual_seed(1))
    batch = tstep.synthetic_batch(cfg, batch=4, tokens=16, seed=2, device="cpu")
    runs, times = {}, {}
    for where in ("cpu", "cuda"):
        state = tstep.init_state(copy.deepcopy(model).to(where), tstep.make_optimizer(lr=2e-4, warmup=1, decay_steps=10))
        step = tstep.make_train_step(cfg)
        moved = {k: v.to(where) for k, v in batch.items()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        runs[where] = [{k: float(v) for k, v in step(state, moved)[1].items()} for _ in range(3)]
        times[where] = (time.perf_counter() - t0) / 3 * 1e3
        if any(ops.launch_counts().values()):
            fail(f"a training step launched a kernel: {ops.launch_counts()}")
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(runs["cuda"], runs["cpu"]) for k in b)
    return {
        "config": "ModelConfig() full width, f32, synthetic_batch(batch=4, tokens=16)",
        "steps": runs, "worst_rel_diff": worst, "bound": TRAIN_CARD_VS_CPU_RTOL,
        "ms_per_step": times, "device": smi,
    }, worst <= TRAIN_CARD_VS_CPU_RTOL


def profile_train_step(torch, np, batch: dict) -> dict:
    """Where one warm demo-corpus training step's time goes (full width, f32, the
    aligner learned): the step's host-clock time, the MAS aligner's two frame loops
    alone (the forward sum with its backward, and the Viterbi durations) on the
    step's own scores, and one torch.profiler trace of the step (device busy time
    and idle share, host-to-device copies, kernel count, the top kernels)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from gonova_tts_tpu_torch.utils.prof import device_events

    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import aligner, tts
    from gonova_tts_tpu_torch.train import step as tstep

    cfg = ModelConfig()
    state = tstep.init_state(
        tts.TTS(cfg, torch.Generator().manual_seed(0), with_aligner=True).cuda(),
        tstep.make_optimizer(lr=2e-4, warmup=50, decay_steps=TRAIN_STEPS),
    )
    step = tstep.make_train_step(cfg, learn_alignment=True)
    b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    step_ms = host_ms(lambda: step(state, b))
    tm, fm = b["token_mask"], b["frame_mask"]
    prior = aligner.diagonal_prior(tm, fm, sigma=tstep.ALIGN_PRIOR_SIGMA)
    log_p = aligner.log_probs(state.params.aligner, b["tokens"], b["align_mel"], tm, prior=prior, frame_mask=fm)
    leaf = log_p.detach().requires_grad_(True)
    fs_ms = host_ms(lambda: aligner.forward_sum_loss(leaf, tm, fm).backward())
    mas_ms = host_ms(lambda: aligner.mas_durations(leaf.detach(), tm, fm))
    for _ in range(2):  # the first trace pays the tracer's start-up
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, b)
            torch.cuda.synchronize()
    dev_events = device_events(prof)
    if not dev_events:
        return {"step_ms": step_ms, "note": "the profiler saw no device time: not measured"}
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    h2d = [e for e in dev_events if "HtoD" in e.key]
    return {
        "frames": int(fm.shape[1]), "tokens": int(tm.shape[1]), "batch": int(tm.shape[0]),
        "step_ms": step_ms, "forward_sum_fwd_bwd_ms": fs_ms, "mas_durations_ms": mas_ms,
        "device_busy_ms": busy_ms, "device_idle_share": max(0.0, 1 - busy_ms / step_ms),
        "device_launches": sum(e.count for e in dev_events),
        "h2d_copies": sum(e.count for e in h2d), "h2d_ms": sum(e.self_device_time_total for e in h2d) / 1e3,
        "top": top_events(dev_events[:10]),
    }


def run_train(torch, np, report, smi, corpus: str):
    """Phase 8; writes the demo corpus into `corpus`, which the grade phase reads."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
    from gonova_tts_tpu_torch.engine import TTSEngine
    from gonova_tts_tpu_torch.text import text_to_ids
    from gonova_tts_tpu_torch.train.loop import train
    from gonova_tts_tpu_torch.train.synth_corpus import DEFAULT_SENTENCES, generate_corpus

    t_phase = time.perf_counter()
    out, checks = {}, {}
    out["card_vs_cpu"], checks["train_card_vs_cpu"] = train_card_vs_cpu(torch, np, smi)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        generate_corpus(corpus, variable=True, holdout=2)
        out["corpus_s"] = time.perf_counter() - t0
        hist = os.path.join(tmp, "history.jsonl")
        ckpt = os.path.join(tmp, "ckpt")
        cfg = Config()
        cfg.model = ModelConfig()
        logs = LogRecords("gonova.train")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            final = train(
                cfg, manifest=os.path.join(corpus, "manifest_train.txt"), resident=True, chunk=50,
                steps=TRAIN_STEPS, warmup=50, batch_size=8, lr=2e-4, checkpoint_dir=ckpt,
                history_path=hist, device="cuda",
            )
        finally:
            logs.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_launches = ops.launch_counts()
        history = [json.loads(x) for x in open(hist)]
        steps = {f["step"]: f["elapsed_s"] for e, f in logs.events if e == "train_step"}
        prep = next(f["prep_s"] for e, f in logs.events if e == "resident_corpus")
        first, last = history[0], history[-1]
        # Steady state: from the first logging point (its chunk pays the first-call costs).
        steady = (steps[TRAIN_STEPS] - steps[50]) / (TRAIN_STEPS - 50) * 1e3
        with open(JAX_HISTORY) as f:
            jax_lines = [json.loads(x) for x in f]
        jax_line = next(x for x in jax_lines if x.get("step") == TRAIN_STEPS and "phase" not in x)
        out["demo_corpus"] = {
            "recipe": "gonova-tts train --demo-corpus: 4 speakers x 12 sentences, variable durations, "
                      "2 held out; full width f32, resident, chunk 50, warmup 50, batch 8, lr 2e-4, "
                      "MAS aligner learned",
            "steps": TRAIN_STEPS, "data_prep_s": prep, "train_wall_s": wall,
            "ms_per_step_overall": (wall - prep) / TRAIN_STEPS * 1e3, "ms_per_step_steady": steady,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device": smi, "history": history, "final": final,
            "step200_port": last if last["step"] == 200 else None,
            "step200_jax_package_run_r3": jax_line,
            "step200_note": "loss values only (chunk means; the JAX run used chunk 200): not a speed comparison",
            "launches_during_training": train_launches,
        }
        checks["train_metrics_finite"] = all(np.isfinite(v) for h in history for v in h.values())
        checks["train_total_falls"] = last["total"] < first["total"]
        checks["train_launches_no_kernel"] = not any(train_launches.values())

        serve = Config()
        serve.model = ModelConfig(model_path=ckpt, compute_dtype="bfloat16", vocos_pallas=True)
        serve.engine = EngineConfig(acoustic_pallas=True, warmup_shapes=[[1, 32]])
        eng = TTSEngine(serve)
        eng.load(warmup=True)
        held_out = DEFAULT_SENTENCES[-1]
        ops.reset_launch_counts()
        voice = eng.embed_voice_file(os.path.join(corpus, "ref_spk_mid.wav"))
        wav = eng.synthesize_batch([held_out], speakers=[voice])[0]
        torch.cuda.synchronize()
        serve_launches = ops.launch_counts()
        rms = float(np.sqrt(np.mean(wav**2))) if wav.size else 0.0
        out["serving"] = {
            "text": held_out, "tokens": len(text_to_ids(held_out)), "audio_s": wav.size / eng.sample_rate,
            "rms": rms, "peak": float(np.abs(wav).max()) if wav.size else 0.0, "launches": serve_launches,
        }
        checks["trained_checkpoint_serves"] = bool(wav.size > 0 and np.isfinite(wav).all() and rms > NOT_SILENT_RMS)
        checks["trained_checkpoint_launches_stacks"] = all(
            serve_launches.get(k, 0) > 0 for k in ("transformer_stack", "vocos_stack"))
        del eng
        from gonova_tts_tpu_torch.train.data import ManifestDataset

        one = next(ManifestDataset(
            os.path.join(corpus, "manifest_train.txt"), ModelConfig(), batch_size=8, token_buckets=(64,),
            ref_mel=True, learn_alignment=True,
        ).epoch(0))
        out["step_profile"] = profile_train_step(torch, np, one)
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["train"] = out
    return train_launches, serve_launches, checks


# ------------------------------------------------------------------ phase 9


HIFIGAN = {"vocoder_family": "hifigan"}  # ModelConfig() fields: full width, folded layout
HIFIGAN_BOUNDS = {
    "vocoder_card_vs_cpu_f32": 1e-4,  # cuDNN vs the CPU's summation order, f32 through 40 convs
    "folded_vs_plain_f32": (2e-5, 1e-5),  # (atol, rtol): the JAX package's pin for its own fold
    "f32_two_stage_vs_one_shot": 1.01 / 32767,  # the JAX engine's pin: one int16 step
}


def generator_work(cfg, batch: int, t_mel: int):
    """(FLOPs, parameter count) of one plain HiFi-GAN forward: 2 * output length *
    k * C_in * C_out for each conv (a transposed conv: its input length)."""
    flops, t, ch = 0, t_mel, cfg.upsample_initial_channel
    flops += 2 * t * 7 * cfg.n_mels * ch
    for i, (rate, kernel) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        c_in, c_out = ch // 2**i, ch // 2 ** (i + 1)
        flops += 2 * t * kernel * c_in * c_out
        t *= rate
        flops += sum(2 * t * k * c_out * c_out * 2 * len(d) for k, d in zip(cfg.resblock_kernels, cfg.resblock_dilations))
    flops += 2 * t * 7 * (ch // 2 ** len(cfg.upsample_rates))
    return batch * flops


def novagan_checkpoint(torch, tmp: str, mcfg) -> str:
    """The demo checkpoint's acoustic and speaker subtrees with a HiFi-GAN vocoder
    seeded from 0 (the repository ships no trained one), as one f32 .npz."""
    from gonova_tts_tpu_torch.models import params, vocoder
    from gonova_tts_tpu_torch.train.checkpoint import save_params_npz

    tree, meta = params.load_npz(DEMO)
    gen = vocoder.init(torch.Generator().manual_seed(0), mcfg)
    tree = {
        "acoustic": tree["acoustic"], "speaker": tree["speaker"],
        "vocoder": params.unflatten({k.replace(".", "/"): v.numpy() for k, v in gen.state_dict().items()}),
    }
    return save_params_npz(os.path.join(tmp, "novagan_demo_seed0.npz"), tree, dtype="float32", meta=meta)


def run_hifigan(torch, np, report, smi, dev="cuda"):
    """Phase 9: NovaGAN served through TTSEngine at full width. Returns the kernel
    launches of the bf16 serving run (counts set to 0 just before it) and checks."""
    import copy

    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
    from gonova_tts_tpu_torch.engine import TTSEngine
    from gonova_tts_tpu_torch.models import vocoder, vocoder_folded

    import parity_gpu
    from parity_gpu import one_shot

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)  # dev="cpu": a rehearsal
    out, checks = {"device": smi}, {}
    mcfg = ModelConfig(**HIFIGAN)
    with tempfile.TemporaryDirectory() as tmp:
        path = novagan_checkpoint(torch, tmp, mcfg)

        # f32: the generator on the card vs the CPU, and folded vs plain on the card.
        gen_cpu = vocoder.init(torch.Generator().manual_seed(0), mcfg)
        gen = copy.deepcopy(gen_cpu).to(dev)
        mel = torch.as_tensor(np.random.default_rng(9).normal(-4.0, 2.0, (1, 64, mcfg.n_mels)).astype(np.float32))
        with torch.inference_mode():
            want = vocoder.forward(gen_cpu, mel, mcfg)
            plain = vocoder.forward(gen, mel.to(dev), mcfg)
            folded = vocoder_folded.forward(gen, mel.to(dev), mcfg)
        atol, rtol = HIFIGAN_BOUNDS["folded_vs_plain_f32"]
        card_err = float((plain.cpu() - want).abs().max())
        fold_excess = float(((folded - plain).abs() - rtol * plain.abs()).max())
        out["vocoder_f32"] = {"B": 1, "T": 64, "card_vs_cpu_max_abs": card_err,
                              "folded_vs_plain_max_abs": float((folded - plain).abs().max()),
                              "bounds": HIFIGAN_BOUNDS}
        checks["hifigan_vocoder_card_vs_cpu"] = card_err <= HIFIGAN_BOUNDS["vocoder_card_vs_cpu_f32"]
        checks["hifigan_folded_vs_plain"] = fold_excess <= atol
        del gen_cpu

        def engine(dtype):
            cfg = Config()
            cfg.model = ModelConfig(**HIFIGAN, model_path=path, compute_dtype=dtype, vocos_pallas=True)
            cfg.engine = EngineConfig(acoustic_pallas=True, warmup_shapes=[[1, 32], [4, 64]])
            eng = TTSEngine(cfg, device=dev)
            eng.load(warmup=True)
            return eng

        # f32 with the kernel switches on: two-stage vs one-shot within one int16 step.
        eng = engine("float32")
        one = one_shot(eng, SENTENCES)
        ops.reset_launch_counts()
        two = eng.synthesize_batch(SENTENCES)
        sync()
        f32_launches = ops.launch_counts()
        k = "f32_two_stage_vs_one_shot"
        out[k] = max_diff(one, two)
        checks["hifigan_" + k] = out[k] <= HIFIGAN_BOUNDS[k]
        del eng

        # bf16: the serving run (launch counts from 0, read right after).
        eng = engine("bfloat16")
        voice = eng.embed_voice_file(VOICE_WAV)
        ops.reset_launch_counts()
        served = []
        for b in (1, 4, 16):
            served += eng.synthesize_batch([SENTENCES[i % len(SENTENCES)] for i in range(b)])
        chunks = list(eng.synthesize_stream(STREAM_TEXT))
        cloned = eng.synthesize_batch([SENTENCES[1]], speakers=[eng.embed_voice_file(VOICE_WAV)])
        sync()
        launches = ops.launch_counts()
        checks["hifigan_served_finite"] = all(w.size > 0 and np.isfinite(w).all() for w in served + chunks + cloned)
        checks["hifigan_transformer_stack_launched"] = launches.get("transformer_stack", 0) > 0
        checks["hifigan_vocos_stack_not_launched"] = launches.get("vocos_stack", 0) == 0
        checks["hifigan_f32_transformer_stack_launched"] = f32_launches.get("transformer_stack", 0) > 0
        checks["hifigan_f32_vocos_stack_not_launched"] = f32_launches.get("vocos_stack", 0) == 0
        out["main_path"] = {"launches": launches, "f32_launches": f32_launches, "stream_chunks": len(chunks),
                            "cloned_voice_audio_s": cloned[0].size / eng.sample_rate,
                            "voice_embedding_norm": float(np.linalg.norm(voice))}

        speed = {}
        for b in (1, 4, 16):
            texts = [SENTENCES[i % len(SENTENCES)] for i in range(b)]
            eng.synthesize_batch(texts)
            sync()
            reps, t0, samples = 3, time.perf_counter(), 0
            for _ in range(reps):
                samples += sum(w.size for w in eng.synthesize_batch(texts))
            dt = time.perf_counter() - t0
            speed[f"batch{b}"] = {
                "audio_s_per_s": samples / eng.sample_rate / dt, "latency_ms_per_batch": dt / reps * 1e3}
        out["speed_bf16"] = speed
        if dev == "cuda":
            out["profile_batch4_two_stage"] = profile(eng, torch, speed["batch4"]["latency_ms_per_batch"])

        # The generator alone at B=4, T=320: both layouts, bf16 and f32, against its bound.
        mel = torch.as_tensor(np.random.default_rng(10).normal(-4.0, 2.0, (4, 320, mcfg.n_mels)).astype(np.float32),
                              device=dev)
        flops = generator_work(mcfg, 4, 320)
        n_params = sum(p.numel() for p in gen.parameters())
        gen_times = {}
        for dtype in (torch.bfloat16, torch.float32):
            # The f32 mel read once, the weights once in the compute dtype, the f32 audio written once.
            moved = nbytes(mel) + n_params * (2 if dtype == torch.bfloat16 else 4) \
                + 4 * 320 * vocoder.upsample_factor(mcfg) * 4
            b_ms, b_by = bound(moved, flops, name_of(dtype))
            for name, fn in (("plain", vocoder.forward), ("folded", vocoder_folded.forward)):
                with torch.inference_mode():
                    ms = cuda_ms(lambda: fn(gen, mel, mcfg, dtype), 5) if dev == "cuda" else float("nan")
                gen_times[f"{name} {name_of(dtype)}"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}
        out["generator_B4_T320"] = {"gflop_plain": flops / 1e9, "params": n_params, "times": gen_times}

        # parity.py's gate metrics, bf16 vs f32, on this config (random vocoder: readings).
        out["parity_bf16_vs_f32_random_vocoder"] = parity_gpu.parity(eng.params, eng.mcfg)
        del eng
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["hifigan"] = out
    return launches, checks


# ------------------------------------------------------------------ phase 10


GAN_CARD_VS_CPU_RTOL = 1e-4
GAN_JOINT_STEPS, GAN_PAIRS, GAN_CHUNK = 50, 100, 50
GAN_DEMO_MODEL = {}  # ModelConfig() fields of the demo-corpus run: full width, the Vocos generator
GAN_SMALL = dict(  # the card-vs-CPU config: the GAN path at a few layers and narrow widths
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    vocoder_family="hifigan", upsample_initial_channel=32, disc_width=0.25,
)
GAN_FULL_HIFIGAN = {"vocoder_family": "hifigan"}  # full width, disc_width 1.0
GAN_FULL_FRAMES = 512


def gan_batch(np, cfg, b: int, frames: int, seed: int):
    """A batch padded as the dataset pads: log-mel at the log(1e-5) floor and zero
    audio past each utterance (the second one is 7 frames short)."""
    rng = np.random.default_rng(seed)
    fm = (np.arange(frames)[None] < np.array([[frames - 7 * (i % 2)] for i in range(b)])).astype(np.float32)
    mel = np.where(fm[..., None] > 0, rng.normal(-4.0, 2.0, (b, frames, cfg.n_mels)), np.log(1e-5))
    audio = 0.1 * rng.normal(size=(b, frames * cfg.hop_length)) * np.repeat(fm, cfg.hop_length, axis=1)
    return {"mel": mel.astype(np.float32), "audio": audio.astype(np.float32), "frame_mask": fm}


def gan_states(torch, cfg, dev, lr=2e-4):
    from gonova_tts_tpu_torch.models import layers, tts, vocoder
    from gonova_tts_tpu_torch.train import step as tstep

    model = tts.TTS(cfg, torch.Generator().manual_seed(3)).to(dev)
    opt = tstep.make_optimizer(lr=lr, warmup=1, decay_steps=10)
    gen = tstep.init_state(layers.group(vocoder=model.vocoder), opt)
    critics = vocoder.discriminators_init(
        torch.Generator().manual_seed(101), torch.Generator().manual_seed(102), cfg.disc_width).to(dev)
    return gen, tstep.init_state(critics, opt)


def gan_pairs(torch, np, cfg, dev, batch, n: int):
    """n d/g pairs of make_gan_steps from seeded weights: (losses per pair, host ms
    per pair from the second on, peak device memory GiB)."""
    from gonova_tts_tpu_torch.train import step as tstep

    gen, disc = gan_states(torch, cfg, dev)
    d_step, g_step = tstep.make_gan_steps(cfg)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs, stamps = [], []
    for _ in range(n):
        disc, dl = d_step(disc, gen.params, b["mel"], b["audio"])
        gen, m = g_step(gen, disc.params, b["mel"], b["audio"], b["frame_mask"])
        runs.append({"d": float(dl), **{k: float(v) for k, v in m.items()}})  # reading synchronizes
        stamps.append(time.perf_counter())
    ms = (stamps[-1] - stamps[0]) / (n - 1) * 1e3 if n > 1 else float("nan")
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else float("nan")
    return runs, ms, peak


def run_gan(torch, np, report, smi, dev="cuda"):
    """Phase 10: the adversarial phase on the card. Returns the kernel launches
    during the GAN training run and checks."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
    from gonova_tts_tpu_torch.engine import TTSEngine
    from gonova_tts_tpu_torch.models import params
    from gonova_tts_tpu_torch.train.loop import train
    from gonova_tts_tpu_torch.train.synth_corpus import DEFAULT_SENTENCES, generate_corpus

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)  # dev="cpu": a rehearsal
    out, checks = {"device": smi}, {}

    # (a) three pairs on the card vs the CPU, f32, a small config, the crop firing.
    small = ModelConfig(**GAN_SMALL, device="cpu")
    batch = gan_batch(np, small, 2, 40, seed=4)
    ops.reset_launch_counts()
    cpu_runs = gan_pairs(torch, np, small, "cpu", batch, 3)[0]
    card_runs = gan_pairs(torch, np, small, dev, batch, 3)[0]
    pair_launches = ops.launch_counts()
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(card_runs, cpu_runs) for k in b)
    out["card_vs_cpu"] = {"config": GAN_SMALL, "batch": "2 x 40 frames (crop fires)", "cpu": cpu_runs,
                          "card": card_runs, "worst_rel_diff": worst, "bound": GAN_CARD_VS_CPU_RTOL}
    checks["gan_card_vs_cpu"] = worst <= GAN_CARD_VS_CPU_RTOL
    checks["gan_pairs_launch_no_kernel"] = not any(pair_launches.values())

    # (b) the demo corpus, the Vocos generator at full width: joint steps, then GAN pairs.
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, variable=True, holdout=2)
        hist, ckpt = os.path.join(tmp, "history.jsonl"), os.path.join(tmp, "ckpt")
        cfg = Config()
        cfg.model = ModelConfig(**GAN_DEMO_MODEL)
        logs = LogRecords("gonova.train")
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            final = train(
                cfg, manifest=os.path.join(tmp, "manifest_train.txt"), resident=True, chunk=GAN_CHUNK,
                steps=GAN_JOINT_STEPS, warmup=50, batch_size=8, lr=2e-4, checkpoint_dir=ckpt,
                history_path=hist, gan=True, gan_steps=GAN_PAIRS, device=dev,
            )
        finally:
            logs.close()
        sync()
        wall = time.perf_counter() - t0
        gan_launches = ops.launch_counts()
        gan_lines = [x for x in map(json.loads, open(hist)) if x.get("phase") == "gan"]
        # Steady state: from the first logged chunk (it pays the first-call costs) to the last.
        stamps = sorted((f["step"], f["elapsed_s"]) for e, f in logs.events if e == "gan_step")
        steady = (stamps[-1][1] - stamps[0][1]) / (stamps[-1][0] - stamps[0][0]) * 1e3 if len(stamps) > 1 else None
        with open(JAX_HISTORY) as f:
            jax_gan = [x for x in map(json.loads, f) if x.get("phase") == "gan"]
        names = sorted(os.listdir(ckpt))
        want = [f"step_{GAN_JOINT_STEPS:08d}.npz", f"step_{GAN_JOINT_STEPS + GAN_PAIRS:08d}.npz"]
        base, _ = params.load_npz(os.path.join(ckpt, want[0]))
        tuned, _ = params.load_npz(os.path.join(ckpt, want[1]))
        fb, ft = params.flatten(base), params.flatten(tuned)
        moved = max(float(np.abs(ft[k] - fb[k]).max()) for k in ft if k.startswith("vocoder/"))
        out["demo_corpus_vocos"] = {
            "recipe": f"demo corpus, ModelConfig() full width f32, disc_width 1.0, resident, chunk {GAN_CHUNK}, batch 8: "
                      f"{GAN_JOINT_STEPS} joint steps (lr 2e-4, warmup 50) + {GAN_PAIRS} GAN pairs (gan_lr 2e-4), "
                      "cut from the TRAIN_EVAL.md recipe's 6000 + 2000",
            "train_wall_s": wall, "gan_ms_per_pair_steady": steady,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else None,
            "gan_lines_port": gan_lines, "gan_lines_jax_package_run_r3_tpu": jax_gan[:2],
            "gan_lines_note": "loss values only (chunk means; the JAX run used chunk 200 on a TPU v5e): not a speed comparison",
            "final": final, "checkpoints": names, "vocoder_max_abs_move": moved,
            "launches_during_training": gan_launches,
        }
        checks["gan_metrics_finite"] = bool(gan_lines) and all(
            np.isfinite(v) for x in gan_lines for k, v in x.items() if k != "phase") and all(
            np.isfinite(v) for k, v in final.items() if k.startswith("gan_"))
        checks["gan_generator_moved"] = moved > 0
        checks["gan_checkpoints_at_steps_and_end"] = names == want
        checks["gan_launches_no_kernel"] = not any(gan_launches.values())

        serve = Config()
        serve.model = ModelConfig(**GAN_DEMO_MODEL, model_path=ckpt, compute_dtype="bfloat16", vocos_pallas=True)
        serve.engine = EngineConfig(acoustic_pallas=True, warmup_shapes=[[1, 32]])
        eng = TTSEngine(serve, device=dev)
        eng.load(warmup=True)
        ops.reset_launch_counts()
        wav = eng.synthesize_batch([DEFAULT_SENTENCES[-1]])[0]
        sync()
        serve_launches = ops.launch_counts()
        out["gan_checkpoint_serving"] = {"audio_s": wav.size / eng.sample_rate, "launches": serve_launches,
                                         "rms": float(np.sqrt(np.mean(wav**2))) if wav.size else 0.0}
        checks["gan_checkpoint_serves_finite"] = bool(wav.size and np.isfinite(wav).all())
        checks["gan_checkpoint_launches_vocos_stack"] = serve_launches.get("vocos_stack", 0) > 0
        del eng

    # (c) the HiFi-GAN generator at full width: five pairs, batch 8 x 512 frames.
    full = ModelConfig(**GAN_FULL_HIFIGAN)
    ops.reset_launch_counts()
    runs, ms, peak = gan_pairs(torch, np, full, dev, gan_batch(np, full, 8, GAN_FULL_FRAMES, seed=5), 5)
    out["hifigan_full_width"] = {"batch": f"8 x {GAN_FULL_FRAMES} frames, f32, folded layout", "pairs": runs,
                                 "ms_per_pair": ms, "max_memory_allocated_gib": peak,
                                 "launches": ops.launch_counts()}
    checks["gan_hifigan_full_width_finite"] = all(np.isfinite(v) for r in runs for v in r.values())
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["gan"] = out
    return gan_launches, checks


# ------------------------------------------------------------------ phase 11


DP_REPLICAS = 2
DP_BATCH = 16
DP_F32_BOUND = 3e-3  # tests/test_multi_serving.py's bound between dp and one device
SHARDED_STEPS = 3
SHARDED_RTOL = 1e-5  # 1x1 mesh vs make_train_step: losses and parameters (relative L2)
MULTI_CARD_RTOL = 1e-4  # 2x1, 1x2, 2x2 vs one device: losses, NCCL's summation order
PARALLEL_MODEL = {}  # ModelConfig() fields of the sharded steps: full width


def replica_launches(eng, fn):
    """fn() with each stack launch attributed to the replica whose packed weights it
    was given (each replica keeps its own `layers.cached` memos). Returns (fn's
    result, {replica: {stack: launches}})."""
    from gonova_tts_tpu_torch.ops import transformer_stack as ts_op
    from gonova_tts_tpu_torch.ops import vocos_stack as vs_op

    seen = []
    wrapped = {(ts_op, "transformer_stack"): 1, (vs_op, "vocos_stack"): 0}  # index of `packed` after x
    originals = {key: getattr(*key) for key in wrapped}

    def spy(key):
        def call(x, *args, **kw):
            seen.append((key[1], id(args[wrapped[key]])))
            return originals[key](x, *args, **kw)
        return call

    for key in wrapped:
        setattr(*key, spy(key))
    try:
        result = fn()
    finally:
        for key, f in originals.items():
            setattr(*key, f)
    owner = {id(v): r for r, rep in enumerate(eng.replicas) for m in rep.modules()
             for v in m.__dict__.get("_derived", {}).values()}
    counts = {r: {"transformer_stack": 0, "vocos_stack": 0} for r in range(len(eng.replicas))}
    for name, key in seen:
        counts[owner[key]][name] += 1
    return result, counts


def graded(torch, eng, cand, ref, metric):
    """parity.py's three metrics (parity_gpu.gate) on two lists of audio rows, each
    zero-padded to the longest row."""
    import parity_gpu
    from gonova_tts_tpu_torch.audio.mel import mel_spectrogram

    n = max(len(a) for a in cand + ref)
    m = eng.mcfg

    def stacked(rows):
        out = torch.zeros((len(rows), n), device=eng.device)
        for i, r in enumerate(rows):
            out[i, : len(r)] = torch.as_tensor(r, device=eng.device)
        return out

    a, b = stacked(cand), stacked(ref)
    with torch.inference_mode():
        mels = [mel_spectrogram(x, sr=m.sample_rate, n_fft=m.n_fft, hop_length=m.hop_length, win_length=m.win_length,
                                n_mels=m.n_mels, fmin=m.fmin, fmax=m.fmax) for x in (a, b)]
        out = parity_gpu.gate(mels[0], mels[1], a, b, metric=metric)
    out["max_abs_diff"] = float((a - b).abs().max())
    out["same_lengths"] = [len(x) for x in cand] == [len(x) for x in ref]
    out["pass"] = out["pass"] and out["same_lengths"]
    return out


def dp_engines(torch, dtype: str, dev: str):
    """(data_parallel=2 engine, one-replica engine) on the demo checkpoint with both
    kernel switches on."""
    from gonova_tts_tpu_torch.engine import TTSEngine

    engines = []
    for n in (DP_REPLICAS, 1):
        cfg = engine_config(dtype, kernels=True)
        cfg.engine.data_parallel = n
        eng = TTSEngine(cfg, device=dev)
        eng.load(warmup=True)
        engines.append(eng)
    return engines


def timed_batches(torch, eng, texts, reps=3):
    eng.synthesize_batch(texts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.synthesize_batch(texts)
    return (time.perf_counter() - t0) / reps * 1e3


def sharded_vs_plain(torch, np, cfg, batch, mesh, dev):
    """SHARDED_STEPS steps of make_sharded_train_step on `mesh` and of
    make_train_step, from one seeded state, on one corpus batch (learned
    alignment); then one GAN d/g pair of each (the Vocos generator, critics at
    width 1.0). Returns the runs (per-step losses, ms per step, the GAN pair's
    losses), the largest relative loss differences of the steps and of the pair,
    and the parameters' difference after the steps (relative L2 over all of them,
    and the largest element: a gradient that is zero in exact arithmetic, as the
    attention key bias's, takes Adam's step at either sign)."""
    import copy

    from gonova_tts_tpu_torch.models import layers, tts, vocoder
    from gonova_tts_tpu_torch.train import step as tstep

    model = tts.TTS(cfg, torch.Generator().manual_seed(7), with_aligner=True).to(dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    opt = tstep.make_optimizer(lr=2e-4, warmup=1, decay_steps=10)
    runs = {}
    for name in ("sharded", "plain"):
        state = tstep.init_state(copy.deepcopy(model), opt)
        if name == "sharded":
            step, state = tstep.make_sharded_train_step(cfg, opt, mesh, state, b, learn_alignment=True)
        else:
            step = tstep.make_train_step(cfg, learn_alignment=True)
        losses, stamps = [], [time.perf_counter()]
        for _ in range(SHARDED_STEPS):
            state, m = step(state, b)
            losses.append({k: float(v) for k, v in m.items()})  # reading synchronizes
            stamps.append(time.perf_counter())
        gen = tstep.init_state(layers.group(vocoder=state.params.vocoder), opt)
        critics = vocoder.discriminators_init(
            torch.Generator().manual_seed(101), torch.Generator().manual_seed(102), cfg.disc_width).to(dev)
        disc = tstep.init_state(critics, opt)
        if name == "sharded":
            d_step, g_step, gen, disc = tstep.make_sharded_gan_steps(cfg, opt, opt, mesh, gen, disc)
        else:
            d_step, g_step = tstep.make_gan_steps(cfg)
        disc, dl = d_step(disc, gen.params, b["mel"], b["audio"])
        gen, gm = g_step(gen, disc.params, b["mel"], b["audio"], b["frame_mask"])
        runs[name] = {
            "losses": losses, "ms_per_step": [(t1 - t0) * 1e3 for t0, t1 in zip(stamps, stamps[1:])],
            "gan_pair": {"d": float(dl), **{k: float(v) for k, v in gm.items()}},
            "params": {k: p.detach() for k, p in state.params.named_parameters()},
        }
    worst_loss = max(abs(a[k] - p[k]) / max(abs(p[k]), 1e-12)
                     for a, p in zip(runs["sharded"]["losses"], runs["plain"]["losses"]) for k in p)
    worst_gan = max(abs(runs["sharded"]["gan_pair"][k] - v) / max(abs(v), 1e-12)
                    for k, v in runs["plain"]["gan_pair"].items())
    a, p = (torch.cat([v.reshape(-1) for v in runs[n].pop("params").values()]) for n in ("sharded", "plain"))
    param_diff = {"rel_l2": float(torch.linalg.norm(a - p) / torch.linalg.norm(p)), "max_abs": float((a - p).abs().max())}
    return runs, worst_loss, worst_gan, param_diff


def _mesh_losses(n_data, n_model, batch, model_fields):
    """One rank of a multi-card mesh: SHARDED_STEPS sharded steps from the seeded
    state of `sharded_vs_plain`; rank 0 returns the losses per step."""
    import torch

    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import tts
    from gonova_tts_tpu_torch.parallel import make_mesh, rank_device
    from gonova_tts_tpu_torch.train import step as tstep

    cfg, dev = ModelConfig(**model_fields), rank_device()
    model = tts.TTS(cfg, torch.Generator().manual_seed(7), with_aligner=True).to(dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    opt = tstep.make_optimizer(lr=2e-4, warmup=1, decay_steps=10)
    step, state = tstep.make_sharded_train_step(
        cfg, opt, make_mesh(n_data, n_model), tstep.init_state(model, opt), b, learn_alignment=True)
    losses = []
    for _ in range(SHARDED_STEPS):
        state, m = step(state, b)
        losses.append({k: float(v) for k, v in m.items()})
    return losses if torch.distributed.get_rank() == 0 else None


def run_parallel(torch, np, report, smi, dev="cuda"):
    """Phase 11: data-parallel serving and sharded training. Returns the kernel
    launches of the dp path (counts from 0 just before, read just after) and checks."""
    import torch.distributed as dist

    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.engine import multi
    from gonova_tts_tpu_torch.parallel import launch, make_mesh
    from gonova_tts_tpu_torch.parallel import mesh as pmesh
    from gonova_tts_tpu_torch.train.data import ManifestDataset
    from gonova_tts_tpu_torch.train.synth_corpus import generate_corpus
    from parity_gpu import one_shot

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)  # dev="cpu": a rehearsal
    out, checks = {"device": smi}, {}
    n_cards = torch.cuda.device_count() if dev == "cuda" else 0

    # (a) dp serving: two replicas, on two cards where there are two, else both on cuda:0.
    devices = multi.local_devices(dev)
    real_local_devices = multi.local_devices
    if len(devices) < DP_REPLICAS:
        devices = [devices[0]] * DP_REPLICAS
        multi.local_devices = lambda device: devices
    try:
        texts = [SENTENCES[i % len(SENTENCES)] for i in range(DP_BATCH)]
        dp32, one32 = dp_engines(torch, "float32", dev)
        got32 = dp32.synthesize_batch(texts)
        f32 = {"one_shot": max_diff(got32, one_shot(one32, texts)),
               "two_stage": max_diff(got32, one32.synthesize_batch(texts))}
        del dp32, one32
        dp, one = dp_engines(torch, "bfloat16", dev)
    finally:
        multi.local_devices = real_local_devices
    replicas = [str(d) for d in dp._dp.devices]
    ops.reset_launch_counts()

    def dp_path():
        got = dp.synthesize_batch(texts)
        chunks = list(dp.synthesize_stream(STREAM_TEXT))
        emb = dp.embed_voice_file(VOICE_WAV)
        sync()
        return got, chunks, emb

    (got, chunks, emb), per_replica = replica_launches(dp, dp_path)
    dp_launches = ops.launch_counts()
    want = {"one_shot": one_shot(one, texts), "two_stage": one.synthesize_batch(texts)}
    lines = {key: graded(torch, dp, got, rows, f"dp{DP_REPLICAS}_vs_one_replica_bf16") for key, rows in want.items()}
    stream_ref = list(one.synthesize_stream(STREAM_TEXT))
    emb_ref = one.embed_voice_file(VOICE_WAV)
    timing = {}
    if dev == "cuda":
        timing = {f"{n}_ms_per_batch{DP_BATCH}": timed_batches(torch, e, texts)
                  for n, e in (("dp", dp), ("one_replica", one))}
    out["dp_serving"] = {
        "checkpoint": DEMO, "batch": DP_BATCH, "replica_devices": replicas, "distinct_devices": len(set(replicas)),
        "note": "two replicas on one card measure the mechanism (sharding, per-replica launches), not scaling"
                if len(set(replicas)) == 1 else "replicas on distinct cards",
        "f32_max_abs_diff_vs_one_replica": f32, "f32_bound": DP_F32_BOUND,
        "bf16_vs_one_replica": lines, "launches": dp_launches, "launches_per_replica": per_replica,
        "stream_max_abs_diff_vs_one_replica": max_diff([np.concatenate(chunks)], [np.concatenate(stream_ref)]),
        "embed_max_abs_diff_vs_one_replica": float(np.abs(emb - emb_ref).max()), "timing": timing,
    }
    checks["dp_f32_within_bound"] = max(f32.values()) <= DP_F32_BOUND
    checks["dp_bf16_parity"] = all(line["pass"] for line in lines.values())
    checks["dp_stacks_launch_on_every_replica"] = all(v > 0 for c in per_replica.values() for v in c.values())
    checks["dp_finite"] = all(np.isfinite(w).all() and w.size > 0 for w in got) and all(
        np.isfinite(c).all() for c in chunks) and bool(np.isfinite(emb).all())
    checks["dp_embed_launches_mel"] = dp_launches.get("mel_spectrogram", 0) > 0
    del dp, one

    # (b) sharded training: a 1x1 mesh in this process (NCCL on the card), full width,
    # one demo-corpus batch of 8 x 512 frames; wider meshes where there are cards.
    cfg = ModelConfig(**PARALLEL_MODEL)
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, variable=True, holdout=2)
        batch = next(ManifestDataset(
            os.path.join(tmp, "manifest_train.txt"), cfg, batch_size=8, token_buckets=(64,), ref_mel=True,
            learn_alignment=True,
        ).epoch(0))
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # both runs take the same convolution algorithms
        pmesh.init_group("file://" + os.path.join(tmp, "store"), 1, 0, 0, 1, dev)
        try:
            ops.reset_launch_counts()
            runs, worst_loss, worst_gan, param_diff = sharded_vs_plain(torch, np, cfg, batch, make_mesh(1, 1), dev)
            train_launches = ops.launch_counts()
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = deterministic
    meshes = {"1x1": {"backend": "nccl" if dev == "cuda" else "gloo", "worst_loss_rel": worst_loss,
                      "worst_gan_rel": worst_gan, "params_after_steps": param_diff, "runs": runs}}
    checks["sharded_1x1_losses"] = worst_loss <= SHARDED_RTOL
    checks["sharded_1x1_params"] = param_diff["rel_l2"] <= SHARDED_RTOL
    checks["sharded_1x1_gan_pair"] = worst_gan <= SHARDED_RTOL
    checks["sharded_launches_no_kernel"] = not any(train_launches.values())
    wider = [(2, 1), (1, 2)] * (n_cards >= 2) + [(2, 2)] * (n_cards >= 4)
    if dev == "cpu":  # a rehearsal: the spawned path on gloo
        wider = [(2, 1)]
    for n_data, n_model in wider:
        losses = launch.spawn(_mesh_losses, n_data * n_model, dev, n_data, n_model, batch, PARALLEL_MODEL)[0]
        worst = max(abs(a[k] - p[k]) / max(abs(p[k]), 1e-12)
                    for a, p in zip(losses, runs["plain"]["losses"]) for k in p)
        meshes[f"{n_data}x{n_model}"] = {"worst_loss_rel": worst, "losses": losses}
        checks[f"sharded_{n_data}x{n_model}_losses"] = worst <= MULTI_CARD_RTOL
    out["sharded_training"] = {
        "config": "ModelConfig() full width, f32, learned alignment; one demo-corpus batch of 8 x 512 frames; "
                  f"{SHARDED_STEPS} steps (lr 2e-4, warmup 1) then one GAN pair (critics at width 1.0)",
        "meshes_ran": sorted(meshes), "cards": n_cards, "meshes": meshes, "bounds": {
            "1x1": SHARDED_RTOL, "multi_card_losses": MULTI_CARD_RTOL},
        "launches": train_launches,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["parallel"] = out
    return dp_launches, checks


# ------------------------------------------------------------------ phases 12-14

NATIVE_SECONDS = 10  # the entry points' inputs: 10 s of 24 kHz audio
# The JAX trainer's default recipe cut from 4,000 steps: at 4,000 the phase took 198.5 s
# (37.4 ms a step, host-bound; H100 80GB HBM3, 700 W). 2,000 is the shortest run measured
# whose held-out exact match clears the LTS rules' (1,000: 0.227, 1,500: 0.334, 2,000: 0.403).
G2P_STEPS = 2000
G2P_PROFILE_STEPS = 20
G2P_NEAR_TIE = 1e-3  # a card-vs-numpy mismatch is allowed only below this top-2 logit gap
G2P_MEMBERS = ("g2p_weights.npz", "g2p_weights_e3.npz")  # the primary (192-d 3+3) and a 256-d 4+4 member
LTS_HELD_OUT_EXACT = 0.3554  # the LTS rules on the held-out split (tools/g2p_eval.py, both packages)


def run_native(torch, np, report, dev="cuda"):
    """Phase 12: the C audio runtime built from gonova_tts_tpu_torch/csrc/audio_runtime.cpp
    (by build_all, with the kernels) and loaded; each of its five entry points against
    the numpy forms at the bounds of tests/test_torch_native.py; one served request's
    PCM through the library and through numpy."""
    from gonova_tts_tpu_torch.engine import TTSEngine
    from gonova_tts_tpu_torch.ops import _build
    from gonova_tts_tpu_torch.utils import native

    t_phase = time.perf_counter()
    out, checks = {"library": os.path.relpath(_build._lib_path("audio_runtime")), "error": native.native_error()}, {}
    checks["native_library_loaded"] = native.native_available()
    if not checks["native_library_loaded"]:
        report["native"] = {**out, "checks": checks}
        return checks
    rng = np.random.default_rng(0)
    x = (0.7 * rng.standard_normal(24000 * NATIVE_SECONDS)).astype(np.float32)
    pcm = native.f32_to_i16(x)

    def host_ms(fn, reps=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    cases = {}

    def case(name, err, bound, lib_fn, np_fn):
        cases[name] = {"max_err": err, "bound": bound, "ms": host_ms(lib_fn), "numpy_ms": host_ms(np_fn)}
        checks[f"native_{name}"] = err <= bound

    case("f32_to_i16", int(np.abs(pcm.astype(np.int32) - native.f32_to_i16_numpy(x).astype(np.int32)).max()), 1,
         lambda: native.f32_to_i16(x), lambda: native.f32_to_i16_numpy(x))
    case("i16_to_f32", float(np.abs(native.i16_to_f32(pcm) - native.i16_to_f32_numpy(pcm)).max()), 0.0,
         lambda: native.i16_to_f32(pcm), lambda: native.i16_to_f32_numpy(pcm))
    a, b = x[: len(x) // 2], x[len(x) // 2 - 4800:]
    for overlap in (0, 1, 64):
        case(f"crossfade_join_{overlap}",
             float(np.abs(native.crossfade_join(a, b, overlap) - native.crossfade_join_numpy(a, b, overlap)).max()),
             1e-6, lambda: native.crossfade_join(a, b, overlap), lambda: native.crossfade_join_numpy(a, b, overlap))
    stats, stats_np = native.audio_stats(x), native.audio_stats_numpy(x)
    case("audio_stats", max(abs(p - q) / max(abs(q), 1e-300) for p, q in zip(stats, stats_np)), 1e-12,
         lambda: native.audio_stats(x), lambda: native.audio_stats_numpy(x))
    faded, faded_np = native.declick(x.copy(), 64), native.declick_numpy(x.copy(), 64)
    case("declick_ulps", float((np.abs(faded - faded_np) / np.spacing(np.abs(faded_np))).max()), 1.0,
         lambda: native.declick(x.copy(), 64), lambda: native.declick_numpy(x.copy(), 64))
    raw = x.tobytes()
    view = np.frombuffer(raw, np.float32)
    checks["native_declick_read_only_untouched"] = native.declick(view, 64) is not view and raw == x.tobytes()
    out["cases"] = cases

    # One served request (the demo checkpoint, bf16, both kernels, int16 transfer):
    # the engine's unpack goes through the library; the same PCM through numpy.
    cfg = engine_config("bfloat16", kernels=True)
    cfg.model.device = dev
    eng = TTSEngine(cfg)
    eng.load(warmup=False)
    host = []
    readback = eng._readback
    eng._readback = lambda audio: host.append(audio.cpu().numpy()) or readback(audio)
    served = eng.synthesize_batch([SENTENCES[0]])[0]
    del eng
    n = served.size
    via_numpy = native.i16_to_f32_numpy(host[0])[0, :n]
    out["served"] = {"transfer_dtype": str(host[0].dtype), "samples": n}
    checks["native_served_pcm_int16"] = host[0].dtype == np.int16
    checks["native_served_pcm_bit_equal_to_numpy"] = bool(np.array_equal(served, via_numpy))
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["native"] = out
    return checks


def g2p_divergences(torch, np, ng, model, chars, ids, ref_ids, words):
    """Each word whose card ids and reference ids differ up to their first EOS: the
    first differing step and the top-2 logit gap there, from the card model's logits
    for its own prefix (one teacher-forced pass gives every step's: causal)."""
    with torch.no_grad():
        logits = ng.teacher_logits(model, chars, ids).float().cpu().numpy()
    out = []
    for i, (a, b) in enumerate(zip(ids.cpu().numpy(), ref_ids)):
        if ng.decode_ids(a) == ng.decode_ids(b):
            continue
        t = int(np.nonzero(a != b)[0][0])
        top2 = np.sort(logits[i, t])[-2:]
        out.append({"word": words[i], "step": t, "top2_gap": float(top2[1] - top2[0]),
                    "card": " ".join(ng.decode_ids(a)), "numpy": " ".join(ng.decode_ids(b))})
    return out


def g2p_idle_share(torch, model, x, y, ms_per_step: float) -> dict:
    """Device busy time over G2P_PROFILE_STEPS warm steps of a copy of the model
    (torch.profiler), and the idle share against the main run's ms a step."""
    import copy

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from gonova_tts_tpu_torch.utils.prof import device_events

    from gonova_tts_tpu_torch.tools import train_g2p

    twin = copy.deepcopy(model)
    train_g2p.train(twin, x, y, steps=3, log=None)  # warm
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_g2p.train(twin, x, y, steps=G2P_PROFILE_STEPS, log=None)
        torch.cuda.synchronize()
    dev_events = device_events(prof)
    if not dev_events:
        return {"note": "the profiler saw no device time: not measured"}
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3 / G2P_PROFILE_STEPS
    return {
        "steps": G2P_PROFILE_STEPS, "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1 - busy / ms_per_step),
        "device_launches_per_step": sum(e.count for e in dev_events) / G2P_PROFILE_STEPS,
        "top_per_step": top_events(dev_events[:8], per=G2P_PROFILE_STEPS),
    }


def run_g2p(torch, np, report, smi, dev="cuda"):
    """Phase 13: the G2P model on the card at full width. (1) The primary and the
    `_e3` member greedy-decode the 1,255 held-out words against the numpy serving
    decoder at beam 1; (2) the JAX trainer's default recipe from seed 0 (192-d 3+3,
    batch 256, lr 3e-4, wd 3e-3, label smoothing 0.1), cut to G2P_STEPS steps; (3) its
    held-out report beside the vendored primary's, graded by the same code; (4) the
    trained member saved in JAX's format under build/, reloaded, the same ids at f16.
    Returns the four kernels' launches over the phase (none expected) and checks."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.ops import _build
    from gonova_tts_tpu_torch.text import neural_g2p as ng
    from gonova_tts_tpu_torch.tools import train_g2p

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)  # dev="cpu": a rehearsal
    out, checks = {"device": smi}, {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x, y, held = train_g2p.build_dataset()
    out["data"] = {"train_pairs": len(x), "held_out": len(held), "build_s": time.perf_counter() - t0}
    words = sorted(held)
    chars_np = np.stack([ng.encode_word(w) for w in words])
    chars = torch.as_tensor(chars_np, dtype=torch.long, device=dev)

    members = {}
    for name in G2P_MEMBERS:
        tree = ng.load_weights(os.path.join(os.path.dirname(ng.WEIGHTS_PATH), name))
        model = ng.from_numpy_tree(tree, dev)
        ng.greedy_decode(model, chars[:8])
        sync()
        t0 = time.perf_counter()
        ids = ng.greedy_decode(model, chars)
        sync()
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = ng._np_predict_batch([ng._prepare(tree)], chars_np, beam=1)
        numpy_s = time.perf_counter() - t0
        mism = g2p_divergences(torch, np, ng, model, chars, ids, ref, words)
        for m in mism:
            print("g2p near-tie: " + json.dumps({"member": name, **m}), flush=True)
        members[name] = {
            "d_model": int(tree["char_embed"]["table"].shape[1]), "layers": [len(tree["enc"]), len(tree["dec"])],
            "parameters": sum(p.numel() for p in model.parameters()), "words": len(words),
            "card_decode_ms": decode_ms, "numpy_beam1_s": numpy_s, "mismatches": len(mism),
            "worst_gap": max((m["top2_gap"] for m in mism), default=None),
        }
        checks[f"g2p_{name}_card_vs_numpy"] = all(m["top2_gap"] < G2P_NEAR_TIE for m in mism)
        del model
    out["vendored_members"] = members

    model = ng.init(torch.Generator().manual_seed(0), device=dev)
    torch.cuda.reset_peak_memory_stats() if dev == "cuda" else None
    sync()
    t0 = time.perf_counter()
    losses = train_g2p.train(model, x, y, steps=G2P_STEPS, log=None)
    sync()
    wall = time.perf_counter() - t0
    ms_per_step = wall / G2P_STEPS * 1e3
    out["train"] = {
        "recipe": "tools/train_g2p.py defaults: 192-d 3+3, batch 256, lr 3e-4 warmup-cosine, wd 3e-3, "
                  f"label smoothing 0.1, seed 0, f32; {G2P_STEPS} steps (cut from 4,000)",
        "steps": G2P_STEPS, "wall_s": wall, "ms_per_step": ms_per_step,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else None,
        "losses": losses,
    }
    if dev == "cuda":
        out["train"]["profile"] = g2p_idle_share(torch, model, x, y, ms_per_step)
    checks["g2p_losses_finite"] = all(np.isfinite(v) for v in losses.values())
    checks["g2p_loss_falls"] = losses[G2P_STEPS - 1] < losses[0]

    trained = train_g2p.held_out_report(model, held)
    vendored = train_g2p.held_out_report(ng.from_numpy_tree(ng.load_weights(), dev), held)
    out["held_out_trained"], out["held_out_vendored_primary"] = trained, vendored
    checks["g2p_trained_above_lts"] = trained["held_out_neural_stressless"]["exact_match"] > LTS_HELD_OUT_EXACT

    path = os.path.join(_build.BUILD, "g2p", "chip_smoke_g2p_weights.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ng.save_weights(model, path)
    with torch.no_grad():  # the trained weights as the file holds them
        for p in model.parameters():
            p.copy_(p.half().float())
    reloaded = ng.from_numpy_tree(ng.load_weights(path), dev)
    same = torch.equal(ng.greedy_decode(model, chars), ng.greedy_decode(reloaded, chars))
    with np.load(path) as f:
        out["saved"] = {"path": os.path.relpath(path), "kib": os.path.getsize(path) // 1024,
                        "meta_layers": f["meta_layers"].tolist(), "leaves": len(f.files) - 1}
    checks["g2p_saved_reloaded_same_ids_f16"] = bool(same)
    out["launches"] = ops.launch_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["g2p"] = out
    return out["launches"], checks


def run_grade(torch, np, report, corpus: str, dev="cuda"):
    """Phase 14: tools.eval_checkpoint on the demo checkpoint against the demo corpus
    (the train phase's), in f32 and in bf16, with both kernel switches on, then
    tools.clone_eval on its synthetic voices (bf16; its margin is a reading: the tones
    are no voice the demo checkpoint knows, and the JAX tool has no exit rule). Launch
    counts from 0 just before the runs and read just after."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.tools import clone_eval, eval_checkpoint

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    out, checks = {}, {}
    ops.reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        argv = ["--checkpoint", DEMO, "--corpus", corpus, "--device", dev] + (["--f32"] if dtype == "float32" else [])
        res = eval_checkpoint.evaluate(eval_checkpoint.parse_args(argv), engine_config(dtype, kernels=True))
        sync()
        out[f"eval_checkpoint_{dtype}"] = {**res, "wall_s": time.perf_counter() - t0}
        print(f"grade: eval_checkpoint {dtype}: " + json.dumps(res), flush=True)
        checks[f"grade_clone_margin_positive_{dtype}"] = res["clone_margin"] > 0
    checks["grade_stream_vs_batch_0_lsb_f32"] = out["eval_checkpoint_float32"]["stream_vs_batch_max_lsb"] == 0.0
    t0 = time.perf_counter()
    clone = clone_eval.evaluate(clone_eval.parse_args(["--checkpoint", DEMO, "--device", dev]),
                                engine_config("bfloat16", kernels=True))
    sync()
    out["clone_eval_bfloat16"] = {**clone, "wall_s": time.perf_counter() - t0}
    print("grade: clone_eval: " + json.dumps(clone), flush=True)
    launches = ops.launch_counts()
    out["launches"] = launches
    if dev == "cuda":
        checks["grade_launches_serving_kernels"] = all(
            launches.get(k, 0) > 0 for k in ("transformer_stack", "vocos_stack", "mel_spectrogram"))
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["grade"] = out
    return launches, checks


# ------------------------------------------------------------------ phase 15

# tools.align_diag on the demo corpus: 200 steps (cut from the JAX tool's 2,000; 40 s
# on an H100 at 157.5 ms a step), graded every 50 so the first loss read is step 49's.
ALIGN_STEPS = 200
ALIGN_EVAL_EVERY = 50
COVERAGE_EXACT, COVERAGE_MORPH = 0.97, 0.2  # tests/test_morph.py::test_coverage_harness_runs
FLOOR_MIN, LEN_RATIO = 0.1, (0.7, 1.3)  # tests/test_train_data.py::test_jitter_floor_tool


def run_tools(torch, np, report, corpus: str, dev="cuda"):
    """Phase 15: the repo's four diagnostics, ported, on the card: g2p_coverage on its
    sample, jitter_floor and align_diag on the demo corpus (the train phase's), then
    ws_smoke on the demo checkpoint in bf16 with both kernel switches on, registering
    the corpus' ref_spk_mid.wav, --repeat 2, once over each transport. Launch counts
    from 0 at the phase's start, read at its end (only ws_smoke serves)."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.tools import align_diag, g2p_coverage, jitter_floor, ws_smoke

    t_phase = time.perf_counter()
    out, checks = {}, {}
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    cov = {k: v for k, v in g2p_coverage.evaluate(g2p_coverage.parse_args([])).items() if k != "misses"}
    out["g2p_coverage"] = {**cov, "wall_s": time.perf_counter() - t0}
    print("tools: g2p_coverage " + json.dumps(out["g2p_coverage"]), flush=True)
    checks["tools_coverage_exact"] = cov["exact_coverage"] >= COVERAGE_EXACT
    checks["tools_coverage_morph"] = cov["morph"] > COVERAGE_MORPH

    t0 = time.perf_counter()
    floor = jitter_floor.evaluate(jitter_floor.parse_args(["--corpus", corpus, "--device", dev]))
    out["jitter_floor"] = {**floor, "wall_s": time.perf_counter() - t0}
    print("tools: jitter_floor " + json.dumps(out["jitter_floor"]), flush=True)
    checks["tools_jitter_floors"] = "error" not in floor and all(
        floor[k] > FLOOR_MIN for k in ("floor_alt_jitter_mel_l1", "floor_mean_dur_mel_l1")) and all(
        LEN_RATIO[0] < floor[k] < LEN_RATIO[1] for k in ("alt_len_ratio", "mean_len_ratio"))

    t0 = time.perf_counter()
    align = align_diag.run(
        align_diag.parse_args(["--corpus", corpus, "--steps", str(ALIGN_STEPS), "--eval-every",
                               str(ALIGN_EVAL_EVERY), "--device", dev]),
        emit=lambda line: print("tools: align_diag " + line, flush=True),
    )
    out["align_diag"] = {**align, "wall_s": time.perf_counter() - t0}
    print("tools: align_diag readings " + json.dumps({k: v for k, v in out["align_diag"].items() if k != "lines"}),
          flush=True)
    losses = [x["loss"] for x in align["lines"] if x["loss"] is not None]
    checks["tools_align_losses_finite"] = bool(losses) and all(np.isfinite(losses))
    checks["tools_align_loss_falls"] = len(losses) >= 2 and losses[-1] < losses[0]

    # ws_smoke over the transport the host offers (aiohttp's test server where aiohttp
    # imports), then over the in-memory socket with aiohttp's test utilities hidden.
    ws, saved = {}, sys.modules.get("aiohttp.test_utils")
    for transport in ("installed", "memory"):
        if transport == "memory":
            sys.modules["aiohttp.test_utils"] = None  # its import fails: no aiohttp
        t0 = time.perf_counter()
        try:
            ws[transport] = ws_smoke.run(ws_smoke.parse_args(
                ["--checkpoint", DEMO, "--corpus", corpus, "--repeat", "2", "--device", dev]),
                engine_config("bfloat16", kernels=True))
        finally:
            if saved is None:
                sys.modules.pop("aiohttp.test_utils", None)
            else:
                sys.modules["aiohttp.test_utils"] = saved
        if dev == "cuda":
            torch.cuda.synchronize()
        out[f"ws_smoke_{transport}"] = {**ws[transport], "phase_wall_s": time.perf_counter() - t0}
        print(f"tools: ws_smoke {transport} " + json.dumps(out[f"ws_smoke_{transport}"]), flush=True)
        checks[f"tools_ws_health_{transport}"] = ws[transport]["health"] == "healthy" and ws[transport]["backend"] == dev
        checks[f"tools_ws_signal_{transport}"] = (ws[transport]["finite"] and ws[transport]["rms"] > NOT_SILENT_RMS
                                                  and ws[transport]["chunks"] >= 1)
    launches = ops.launch_counts()
    first, mem = ws["installed"], ws["memory"]
    checks["tools_ws_memory_transport"] = mem["transport"] == "memory"
    checks["tools_ws_transports_agree"] = all(first[k] == mem[k] for k in ("chunks", "final_chunk_id", "audio_s")) and all(
        abs(first[k] - mem[k]) <= 1.0 / 32767 for k in ("rms", "peak"))
    if dev == "cuda":
        checks["tools_ws_launches_serving_kernels"] = all(
            launches.get(k, 0) > 0 for k in ("transformer_stack", "vocos_stack", "mel_spectrogram"))
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["tools"] = out
    return launches, checks


# ------------------------------------------------------------------ phase 16

# Repetition cuts that keep the phase near two minutes (the tools' own defaults in
# brackets): bench's timed repeats 3 (5); bench_tstack's repeats 3 (5); bench_acoustic's
# K 16 (64) and repeats 3 (5). The suite, bench_vocos_attr and bench_hifigan run as
# their tools do.
BENCH_REPS = 3
TSTACK_REPEATS = 3
ACOUSTIC_K, ACOUSTIC_REPEATS = 16, 3


def run_bench(torch, np, report, dev="cuda"):
    """Phase 16: the port's measurement tools at full width. tools.bench (ModelConfig(),
    batch 16, bf16: the default config, which switches no stack kernel on), tools.mfu on
    its two throughputs, the suite's five configs at the production config, then the four
    microbenchmarks; bench_tstack's and bench_acoustic's kernel outputs against the plain
    path within KERNEL_BF16_BOUND. Launch counts from 0 just before each tool, read just
    after: both microbenchmarks of the stack must launch it."""
    from gonova_tts_tpu_torch import ops
    from gonova_tts_tpu_torch.config import EngineConfig, ModelConfig
    from gonova_tts_tpu_torch.tools import (
        bench, bench_acoustic, bench_hifigan, bench_suite, bench_tstack, bench_vocos_attr, mfu,
    )

    t_phase = time.perf_counter()
    out, checks, launches = {}, {}, {}

    def counted(name, fn, *args, **kwargs):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if dev == "cuda":
            torch.cuda.synchronize()
        launches[name] = ops.launch_counts()
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        return result

    detail, line = counted("bench", bench.run, ModelConfig(), EngineConfig(), dev, reps=BENCH_REPS)
    out["bench"] = {"detail": detail, "result": line}
    print("bench: " + json.dumps({"detail": detail}), flush=True)
    print("bench: " + json.dumps(line), flush=True)
    checks["bench_contract_keys"] = set(line) == {"metric", "value", "unit", "vs_baseline"}
    checks["bench_value_positive"] = bool(np.isfinite(line["value"]) and line["value"] > 0)
    checks["bench_ttfa_positive"] = 0 < detail["ttfa_p50_ms"] <= detail["ttfa_p90_ms"]

    peak = mfu.peak_tflops(torch.device(dev), None)
    out["mfu"] = mfu.report(ModelConfig(), EngineConfig(), detail["one_graph"], detail["two_stage_compute"], peak)
    print("bench: mfu " + json.dumps(out["mfu"]), flush=True)
    rows = out["mfu"]["rows"]
    checks["bench_mfu_in_range"] = len(rows) == 2 and all(0 < r["mfu_pct"] < 100 for r in rows)

    eng = counted("suite_load", bench_suite.make_engine, False, dev)
    suite = {n: counted(f"suite_{n}", fn, eng) for n, fn in bench_suite.BENCHES.items()}
    del eng
    out["suite"] = suite
    checks["bench_suite_audio"] = all(suite[n]["audio_s"] > 0 for n in (1, 2, 3, 4))
    checks["bench_suite_batched"] = suite[2]["max_batch_seen"] > 1
    checks["bench_suite_no_recompiles"] = suite[4]["recompiles"] == 0
    checks["bench_suite_ttfa"] = 0 < suite[5]["p50_ttfa_ms"] <= suite[5]["p90_ttfa_ms"]

    out["bench_tstack"] = counted("bench_tstack", bench_tstack.run, dev, repeats=TSTACK_REPEATS)
    out["bench_acoustic"] = counted("bench_acoustic", bench_acoustic.run, dev, k=ACOUSTIC_K,
                                    repeats=ACOUSTIC_REPEATS)
    print("bench: bench_acoustic " + json.dumps(out["bench_acoustic"]), flush=True)
    out["bench_vocos_attr"] = counted("bench_vocos_attr", bench_vocos_attr.run, dev)
    out["bench_hifigan"] = counted("bench_hifigan", bench_hifigan.run, dev)
    checks["bench_tstack_within_bound"] = all(
        c["max_abs_err"] <= KERNEL_BF16_BOUND for c in out["bench_tstack"].values())
    checks["bench_acoustic_within_bound"] = out["bench_acoustic"]["acoustic_max_abs_err"] <= KERNEL_BF16_BOUND
    if dev == "cuda":
        checks["bench_tstack_launched"] = launches["bench_tstack"].get("transformer_stack", 0) > 0
        checks["bench_acoustic_launched"] = launches["bench_acoustic"].get("transformer_stack", 0) > 0
    checks["bench_times_positive"] = all(
        v > 0 for tool in ("bench_vocos_attr", "bench_hifigan") for k, v in out[tool].items()
        if k.endswith("_ms") and not k.endswith("device_ms"))
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    out["launches"], out["launches_by_tool"] = total, launches
    out["phase_s"] = time.perf_counter() - t_phase
    out["checks"] = checks
    report["bench"] = out
    return total, checks


def main() -> None:
    only_parallel = sys.argv[1:] == ["--phase", "parallel"]  # the cross-card phase alone, on a multi-card machine
    only_snake = sys.argv[1:] == ["--phase", "snake"]
    try:
        import numpy as np
        import torch

        from gonova_tts_tpu_torch.config import ModelConfig
        from gonova_tts_tpu_torch.device import resolve_device
        from gonova_tts_tpu_torch.models import params
        from gonova_tts_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the root of a checkout", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device", 3)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated: f32 products and yardsticks in full f32
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    try:
        built = _build.build_all()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    print(f"build: {json.dumps({k: round(v, 1) for k, v in built.items()})} in {time.perf_counter() - t0:.1f} s", flush=True)

    report = {}
    if only_parallel:
        parallel_checks = run_parallel(torch, np, report, smi)[1]
        print("parallel: " + json.dumps(report["parallel"]), flush=True)
        if not all(parallel_checks.values()):
            fail(f"checks failed: {[k for k, v in parallel_checks.items() if not v]}")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}), flush=True)
        return
    if only_snake:
        sn_cases = snake_cases(torch, dev)
        for c in sn_cases:
            print("kernel case: " + json.dumps(c), flush=True)
        cv_cases = conv_cases(torch, dev)
        for c in cv_cases:
            print("conv case: " + json.dumps(c), flush=True)
        phase_error = bigvgan_phase_error(torch, dev)
        print("conv phase error: " + json.dumps(phase_error), flush=True)
        report = {}
        _, bigvgan_checks = run_bigvgan_service(torch, np, report)
        print("bigvgan: " + json.dumps(report["bigvgan"]), flush=True)
        snake = snake_entry(sn_cases, report["bigvgan"])
        print(json.dumps({"kernels": [snake]}), flush=True)
        bad = [f"{c['case']} {c['dtype']}" for c in sn_cases if not c["ok"]]
        bad += [f"conv B={c['B']} C={c['C']} k={c['k']} d={c['d']}" for c in cv_cases if not c["ok"]]
        bad += [phase_error["case"]] if not phase_error["ok"] else []
        bad += [k for k, v in bigvgan_checks.items() if not v]
        bad += ["snake_aa never launched on its path"] if snake["launches"] <= 0 else []
        if bad:
            fail(f"checks failed: {bad}")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}),
              flush=True)
        return
    model, _ = params.load_checkpoint(DEMO, ModelConfig(), dev)
    rng = np.random.default_rng(0)
    gm_cases = gemm_cases(torch, dev, np.random.default_rng(1))  # its own stream: the kernel cases keep their inputs
    for c in gm_cases:
        print("gemm case: " + json.dumps(c), flush=True)
    ts_cases = transformer_cases(model, torch, dev, rng)
    vs_cases = vocos_cases(model, torch, dev, rng)
    mel_cs = mel_cases(torch, dev, rng)
    cb_cases = convnext_cases(model, torch, dev, rng)
    chain = convnext_chain(model, torch, dev, rng)
    chain_bf16 = convnext_chain_bf16(model, torch, dev, rng)
    sn_cases = snake_cases(torch, dev)
    for c in ts_cases + vs_cases + mel_cs + cb_cases + [chain, chain_bf16] + sn_cases:
        print("kernel case: " + json.dumps(c), flush=True)
    kernel_checks = {"shape_independent_bf16": shape_independent_bf16(model, torch, dev, rng)}
    print("kernel checks: " + json.dumps(kernel_checks), flush=True)
    del model
    launches, checks = run_engine(torch, np, report)
    print("engine: " + json.dumps(report), flush=True)
    voice_launches, voice_checks = run_voice(torch, np, report)
    print("voice: " + json.dumps(report["voice_path"]), flush=True)
    print("embed_voice latency: cold {embed_voice_cold_ms:.1f} ms, warm {embed_voice_warm_ms:.2f} ms".format(
        **report["voice_path"]), flush=True)
    service_launches, service_checks = run_service(torch, np, report)
    print("service: " + json.dumps(report["service"]), flush=True)
    _, bigvgan_checks = run_bigvgan_service(torch, np, report)
    print("bigvgan: " + json.dumps(report["bigvgan"]), flush=True)
    parity_launches, parity_checks = run_parity(torch, np, report)
    print("parity: " + json.dumps(report["parity"]), flush=True)
    corpus_dir = tempfile.TemporaryDirectory()  # the demo corpus: the train phase writes it, grade and tools read it
    corpus = corpus_dir.name
    train_launches, trained_serve_launches, train_checks = run_train(torch, np, report, smi, corpus)
    print("train: " + json.dumps(report["train"]), flush=True)
    hifigan_launches, hifigan_checks = run_hifigan(torch, np, report, smi)
    print("hifigan: " + json.dumps(report["hifigan"]), flush=True)
    gan_launches, gan_checks = run_gan(torch, np, report, smi)
    print("gan: " + json.dumps(report["gan"]), flush=True)
    dp_launches, parallel_checks = run_parallel(torch, np, report, smi)
    par = report["parallel"]
    print("parallel: " + json.dumps(par), flush=True)
    print("parallel: dp replicas on {} ({} distinct), sharded meshes run: {}".format(
        par["dp_serving"]["replica_devices"], par["dp_serving"]["distinct_devices"],
        par["sharded_training"]["meshes_ran"]), flush=True)
    native_checks = run_native(torch, np, report)
    print("native: " + json.dumps(report["native"]), flush=True)
    g2p_launches, g2p_checks = run_g2p(torch, np, report, smi)
    print("g2p: " + json.dumps(report["g2p"]), flush=True)
    grade_launches, grade_checks = run_grade(torch, np, report, corpus)
    print("grade: " + json.dumps({k: v for k, v in report["grade"].items() if not k.startswith(("eval", "clone"))}),
          flush=True)
    tools_launches, tools_checks = run_tools(torch, np, report, corpus)
    corpus_dir.cleanup()
    print("tools: " + json.dumps({k: v for k, v in report["tools"].items() if not k.startswith(("align", "ws"))}),
          flush=True)
    bench_launches, bench_checks = run_bench(torch, np, report)
    print("bench: " + json.dumps({k: v for k, v in report["bench"].items() if k.endswith("_wall_s")
                                  or k in ("launches", "launches_by_tool", "checks", "phase_s")}), flush=True)
    mel_voice = next(c for c in mel_cs if c["case"] == "voice B=1 T=239872")
    print("mel kernel at the voice path's shape: " + json.dumps(
        {k: mel_voice[k] for k in ("ms", "device_ms", "plain_ms", "matmul_ms", "bound_ms", "gflop")}), flush=True)

    def entry(name, replaces, cases, main_case, dtype, n_launches, **extra):
        """`launches` is the count from the kernel's main path: the engine run for the
        two stacks, the voice run for the mel, the two chained-block runs for the block."""
        rep = next(c for c in cases if c["case"] == main_case and c["dtype"] == dtype)
        return {
            "name": name, "route": "cuda", "source": f"gonova_tts_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": None,
            **{k: rep[k] for k in ("device_ms", "matmul_ms") if k in rep},
            "at": f"{main_case} {dtype}", **extra,
            "launches_hifigan_path": hifigan_launches.get(name, 0), "launches_gan_phase": gan_launches.get(name, 0),
            "launches_dp_path": dp_launches.get(name, 0), "launches_g2p_phase": g2p_launches.get(name, 0),
            "launches_grade_path": grade_launches.get(name, 0), "launches_tools_phase": tools_launches.get(name, 0),
            "launches_bench_phase": bench_launches.get(name, 0),
            "cases": cases,
        }

    kernels = [
        entry("transformer_stack", "gonova_tts_tpu/ops/transformer_stack_kernel.py:332", ts_cases,
              "decoder B=4 T=512", "bfloat16", launches.get("transformer_stack", 0),
              launches_voice_path=voice_launches.get("transformer_stack", 0),
              launches_service_path=service_launches.get("transformer_stack", 0),
              launches_parity_path=parity_launches.get("transformer_stack", 0),
              launches_training=train_launches.get("transformer_stack", 0),
              launches_trained_checkpoint_serving=trained_serve_launches.get("transformer_stack", 0)),
        entry("vocos_stack", "gonova_tts_tpu/ops/vocos_stack_kernel.py:143", vs_cases,
              "B=4 T=320", "bfloat16", launches.get("vocos_stack", 0),
              launches_voice_path=voice_launches.get("vocos_stack", 0),
              launches_service_path=service_launches.get("vocos_stack", 0),
              launches_parity_path=parity_launches.get("vocos_stack", 0),
              launches_training=train_launches.get("vocos_stack", 0),
              launches_trained_checkpoint_serving=trained_serve_launches.get("vocos_stack", 0)),
        entry("mel_spectrogram", "gonova_tts_tpu/ops/mel_kernel.py:151", mel_cs,
              "voice B=1 T=239872", "float32", voice_launches.get("mel_spectrogram", 0),
              launches_service_path=service_launches.get("mel_spectrogram", 0),
              launches_training=train_launches.get("mel_spectrogram", 0),
              launches_trained_checkpoint_serving=trained_serve_launches.get("mel_spectrogram", 0)),
        entry("convnext_block", "gonova_tts_tpu/ops/convnext_kernel.py:146", cb_cases + [chain, chain_bf16],
              "B=4 T=320", "x bfloat16, mlp bfloat16", chain["launches"] + chain_bf16["launches"],
              launches_f32_chain=chain["launches"], launches_bf16_chain=chain_bf16["launches"],
              gemm_tc_kernels_bf16_chain=chain_bf16["gemm_tc_kernels"]),
        snake_entry(sn_cases, report["bigvgan"]),
    ]
    bad = [f"{c['case']} {c['dtype']}" for c in gm_cases + ts_cases + vs_cases + mel_cs + cb_cases + [chain, chain_bf16]
           + sn_cases if not c["ok"]]
    bad += [k for k, v in {**kernel_checks, **checks, **voice_checks, **service_checks, **bigvgan_checks, **parity_checks,
                           **train_checks, **hifigan_checks, **gan_checks, **parallel_checks, **native_checks,
                           **g2p_checks, **grade_checks, **tools_checks, **bench_checks}.items() if not v]
    bad += [f"{k['name']} never launched on its path" for k in kernels if k["launches"] <= 0]
    if bad:
        print(json.dumps({"kernels": kernels}), flush=True)
        fail(f"checks failed: {bad}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
