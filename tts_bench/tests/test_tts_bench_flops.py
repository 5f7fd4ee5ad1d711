"""flops.py against hand counts and against PyTorch's FlopCounterMode."""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from tts_bench import flops


def _counted(fn, *args):
    with FlopCounterMode(display=False) as m:
        fn(*args)
    return m.get_total_flops()


def test_linear_by_hand():
    # [3, 5] @ [5, 4]: 3 * 4 outputs of 5 multiply-adds each
    assert flops.linear(3, 5, 4) == 2 * 3 * 4 * 5 == 120
    assert flops.linear(3, 5, 4) == _counted(lambda: torch.randn(3, 5) @ torch.randn(5, 4))


def test_k7_conv_by_hand():
    b, t, k, cin, cout = 2, 9, 7, 3, 4
    macs = sum(k * cin for _ in itertools.product(range(b), range(t), range(cout)))
    assert flops.conv1d(b, t, k, cin, cout) == 2 * macs
    x, w = torch.randn(b, cin, t), torch.randn(cout, cin, k)
    assert flops.conv1d(b, t, k, cin, cout) == _counted(lambda: F.conv1d(x, w, padding=3))
    assert flops.conv1d(b, t, k, 8, 8, groups=8) == _counted(lambda: F.conv1d(torch.randn(b, 8, t), torch.randn(8, 1, k), padding=3, groups=8))


def test_transposed_conv_by_hand():
    b, t, k, s, cin, cout = 2, 5, 4, 2, 3, 2
    # every input sample scatters k taps into the output for every channel pair
    macs = 0
    for _bb, i, _ci, _co in itertools.product(range(b), range(t), range(cin), range(cout)):
        macs += sum(1 for j in range(k) if 0 <= i * s + j < (t - 1) * s + k)
    assert flops.conv_transpose1d(b, t, k, cin, cout) == 2 * macs
    x, w = torch.randn(b, cin, t), torch.randn(cin, cout, k)
    assert flops.conv_transpose1d(b, t, k, cin, cout) == _counted(lambda: F.conv_transpose1d(x, w, stride=s))


def test_pass_matches_the_plain_path():
    """A two-stage pass of the plain model at a small config, counted by
    FlopCounterMode on the meta device, equals flops.pass_flops. With autograd on,
    the vocoder takes each product whole: a serving pass cuts it into 128-row tiles
    and pads the last, work that flops.py does not count; and the HiFi-GAN
    generator is counted in its plain layout, whose products are the model's (the
    served lane-folded layout multiplies through zero blocks, work not counted)."""
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import tts

    for family in ("vocos", "hifigan"):
        cfg = ModelConfig(d_model=64, n_heads=2, d_ff=128, encoder_layers=2, decoder_layers=2, speaker_dim=32,
                          vocos_dim=64, vocos_ff=128, vocos_layers=2, upsample_initial_channel=32,
                          vocoder_family=family, local_attention_min_frames=256, hifigan_folded=False)
        with torch.device("meta"):
            model = tts.TTS(cfg, None)
        m = cfg.model_dump()
        for b, length, frames in ((2, 32, 128), (3, 64, 192)):
            tokens = torch.zeros(b, length, dtype=torch.long, device="meta")
            mask = torch.ones(b, length, device="meta")
            spk, ex = torch.zeros(b, cfg.speaker_dim, device="meta"), torch.zeros(b, device="meta")
            durations = torch.ones(b, length, dtype=torch.int32, device="meta")
            with FlopCounterMode(display=False) as counter, torch.enable_grad():
                e = tts.encode_acoustic(model, tokens, mask, spk, ex, cfg)
                tts.decode_vocode(model, e["enc"], e["spk"], durations, mask, frames, cfg,
                                  local_attention_from=length * cfg.max_frames_per_token)
            assert counter.get_total_flops() == flops.pass_flops(m, b, length, frames), (family, b, length)


def test_vocoder_params_count():
    from gonova_tts_tpu_torch.config import ModelConfig
    from gonova_tts_tpu_torch.models import tts

    for family, extra in (("vocos", {}), ("hifigan", {"upsample_initial_channel": 64})):
        cfg = ModelConfig(vocoder_family=family, **extra)
        with torch.device("meta"):
            voc = tts._vocoder_mod(cfg).init(None, cfg)
        assert sum(p.numel() for p in voc.parameters()) == flops.vocoder_params(cfg.model_dump())
