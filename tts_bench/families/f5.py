"""The f5 family: F5-TTS v1's DiT sampled by guided flow matching (`acoustic_family`
"f5", `models/f5.py` of the port), with Vocos (`vocoder_family` "vocos", a polar
head) over the generated frames. A voice is a transcribed prompt: its transcript is
prompts.py's, a function of the recording. Its plain reference is reference/f5.py
inside check.Judge.

Operations (2 per multiply-add of every product, as flops.py counts them) of a pass
at batch bucket B and frame bucket L, the pass key ("f5", B, L) that `install`
counts: 2B rows (each sentence's conditional and null row) of the text embedding
once, then at each of the `f5_nfe_steps` steps the DiT over every row (input
projection, position convs, per block q/k/v/o, attention's two products and the
MLP, the output projection), plus the adaLN products once a step (every row shares
t); and Vocos over [B, L] frames (flops.py's count). Bytes of the DiT: its weights
in bf16 once an evaluation and once for the text embedding, and what each step
reads and writes (x_t and the velocity in f32, the conditioning in bf16).
"""

from __future__ import annotations

from tts_bench import check, flops, prompts
from tts_bench.reference import audio as ref_audio
from tts_bench.reference import f5 as reference
from tts_bench.weights import f5 as weights

VOCODER_FORWARDS = ("vocos",)


def _known(m: dict) -> dict:
    if m.get("acoustic_family") != "f5" or m["vocoder_family"] != "vocos":
        raise ValueError("the f5 family is the F5 DiT (acoustic_family f5) over Vocos")
    return m


class Judge(check.Judge):
    """check.Judge with reference/f5.py: a speaker is the prompt of its recording and
    the recording's transcript (prompts.py)."""

    def __init__(self, model: dict, engine: dict, checkpoint: str, device, numerics: str = "fp32"):
        super().__init__(_known(model), engine, checkpoint, device, numerics)
        self.ref = reference.Reference(self.ref.tree, self.s, device, self.ref.num)

    def speaker(self, key: str, wav_bytes: bytes) -> dict:
        if key not in self._speakers:
            x, sr = ref_audio.read_wav(wav_bytes)
            self._speakers[key] = self.ref.prompt(x, sr, prompts.transcript(wav_bytes))
        return self._speakers[key]

    def speak(self, sentence: str, speaker: dict, exaggeration: float):
        return self.ref.speak(sentence, speaker)


def judge(model: dict, engine: dict, checkpoint: str, device, numerics: str = "fp32") -> Judge:
    return Judge(model, engine, checkpoint, device, numerics)


def text_ops(m: dict, rows: int, length: int) -> int:
    td = m["f5_text_dim"]
    block = flops.conv1d(rows, length, 7, td, td, groups=td) + 2 * flops.linear(rows * length, td, 2 * td)
    return m["f5_conv_layers"] * block


def eval_ops(m: dict, rows: int, length: int) -> int:
    """One DiT evaluation of `rows` rows of `length` frames, the adaLN left out."""
    d, n_mels, ff = m["f5_dim"], m["n_mels"], m["f5_ff_mult"] * m["f5_dim"]
    block = (flops.linear(rows * length, d, 3 * d) + flops.attention(rows, length, d)
             + flops.linear(rows * length, d, d) + flops.linear(rows * length, d, ff) + flops.linear(rows * length, ff, d))
    return (flops.linear(rows * length, 2 * n_mels + m["f5_text_dim"], d) + 2 * flops.conv1d(rows, length, 31, d, d, groups=16)
            + m["f5_depth"] * block + flops.linear(rows * length, d, n_mels))


def adaln_ops(m: dict) -> int:
    """A step's time embedding and modulation products, once for every row."""
    d = m["f5_dim"]
    return flops.linear(1, 256, d) + flops.linear(1, d, d) + m["f5_depth"] * flops.linear(1, d, 6 * d) + flops.linear(1, d, 2 * d)


def dit_ops(m: dict, b: int, length: int) -> int:
    steps = _known(m)["f5_nfe_steps"]
    return text_ops(m, 2 * b, length) + steps * (eval_ops(m, 2 * b, length) + adaln_ops(m))


def dit_bytes(m: dict, b: int, length: int) -> int:
    steps, n_mels, td = m["f5_nfe_steps"], m["n_mels"], m["f5_text_dim"]
    weight_bytes = 2 * weights.dit_params(m)
    text_out = 2 * 2 * b * length * (n_mels + td)
    per_step = weight_bytes + 4 * b * length * n_mels * 3 + text_out
    return weight_bytes + 8 * b * length + text_out + steps * per_step


def pass_ops(m: dict, key: tuple) -> int:
    _, b, length = key
    return dit_ops(m, b, length) + vocoder_ops(m, b, length)


def vocoder_ops(m: dict, b: int, frames: int) -> int:
    return flops.vocoder(_known(m), b, frames)


def vocoder_bytes(m: dict, b: int, frames: int) -> int:
    return flops.vocoder_bytes(_known(m), b, frames)


def install(svc, probe) -> None:
    """Count each pass under ("f5", B, L) and range its sampler as
    `tts_bench.f5:BxL`."""
    from torch.profiler import record_function

    from gonova_tts_tpu_torch.models import f5

    sample = f5.sample

    def counted(params, ids1, *args, **kw):
        b, length = ids1.shape
        probe.passes[("f5", b, length)] += 1
        with record_function(f"tts_bench.f5:{b}x{length}"):
            return sample(params, ids1, *args, **kw)

    probe.patch(f5, "sample", counted)
