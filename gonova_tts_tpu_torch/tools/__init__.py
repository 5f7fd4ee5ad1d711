"""Command-line tools of the port, each runnable as `python -m gonova_tts_tpu_torch.tools.<name>`:

  g2p_eval         pronunciation accuracy of the text frontend (held-out split, OOV path)
  train_g2p        train one neural G2P member (CUDA by default, `--device cpu`)
  eval_checkpoint  grade a trained TTS checkpoint through the engine
  clone_eval       same-voice vs cross-voice speaker similarity of synthesized speech
  align_diag       the MAS aligner trained alone, graded against the corpus' true durations
  jitter_floor     the irreducible mel-L1 floor of the held-out grades
  ws_smoke         a checkpoint served through the WS protocol: TTFA, realtime factor, signal
  g2p_coverage     how running text resolves through the frontend's tiers (host only)
"""
