"""Where the text frontend's data lives.

The lexicon and the neural G2P ensemble weights (~46 MB) belong to the JAX
package's text frontend. The port reads them in place, by file path, and never
imports that package: one copy of the data serves both frontends, so the two
cannot drift apart.
"""

from __future__ import annotations

import os

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gonova_tts_tpu",
    "text",
    "data",
)
