"""The benchmark of gonova_tts_tpu_torch: one cell a run, driven by the data files
beside this package (configs/, traffic/, workloads/, metrics/); see run.py."""
