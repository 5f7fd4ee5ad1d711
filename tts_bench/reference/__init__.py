"""The plain float32 reference that decides `correct`: model.py (text frontend copy
in text/), audio.py. It imports nothing of the served program."""
