"""Training for one device: losses, the train step, the data pipeline, npz
checkpoints, the formant corpus and the loop (counterpart of `gonova_tts_tpu/train/`)."""

from .checkpoint import latest_step_dir, restore_params, save_params

__all__ = ["latest_step_dir", "restore_params", "save_params"]
