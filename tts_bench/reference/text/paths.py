"""Where the frontend's data lives: the lexicon and the neural G2P ensemble weights,
read in place by file path from the repository's text data directory."""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
DATA_DIR = os.path.join(_ROOT, "gonova_tts_tpu", "text", "data")
