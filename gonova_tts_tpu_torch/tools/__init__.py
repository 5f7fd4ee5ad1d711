"""Command-line tools of the port, each runnable as `python -m gonova_tts_tpu_torch.tools.<name>`:

  g2p_eval         pronunciation accuracy of the text frontend (held-out split, OOV path)
  train_g2p        train one neural G2P member (CUDA by default, `--device cpu`)
  eval_checkpoint  grade a trained TTS checkpoint through the engine
  clone_eval       same-voice vs cross-voice speaker similarity of synthesized speech
  align_diag       the MAS aligner trained alone, graded against the corpus' true durations
  jitter_floor     the irreducible mel-L1 floor of the held-out grades
  ws_smoke         a checkpoint served through the WS protocol: TTFA, realtime factor, signal
  g2p_coverage     how running text resolves through the frontend's tiers (host only)
  bench            the headline benchmark: audio-s/s at batch 16 and TTFA (`gonova-tts-torch bench`)
  bench_suite      the five workload configs: latency, batching, long form, voices, request rate
  mfu              model FLOP utilization of the bench's two modes
  bench_tstack     the transformer-stack kernel against the plain stack
  bench_acoustic   the acoustic pass and the pipeline with `acoustic_pallas` off and on
  bench_vocos_attr where a Vocos pass spends its time
  bench_hifigan    NovaGAN's two layouts, its MRF stages, a fixed-FLOP conv sweep
"""
