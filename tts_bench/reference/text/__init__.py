"""A frozen copy of the served text frontend (normalize, segment, lexicon and rule
G2P, morphology, stress, and the numpy beam decoder of the neural G2P ensemble),
so that the reference works out the token ids of a text on its own.

It reads the same data files by path and imports nothing of the served program.
The copy is the frontend as it was when the benchmark was defined: a change to the
served frontend that changes ids shows as a gap against it.
"""

from .frontend import batch_to_bucket, pick_bucket, segment_text, text_to_ids
