"""Command-line interface of the port: serve / synth / voices / info.

The counterpart of `gonova_tts_tpu/cli.py`, over the port's modules. The device is
the config file's `model.device` ("cuda" unless the file says "cpu"). `bench` and
`train` are not ported yet.

    gonova-tts-torch serve [--port 8002]          # or python -m gonova_tts_tpu_torch.cli
    gonova-tts-torch synth "Hello." -o hello.wav [--voice-wav ref.wav]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_serve(args: argparse.Namespace) -> int:
    from .config import load_config
    from .service.server import aiohttp_web, create_app

    config = load_config(args.config)
    if args.model_path:
        config.model.model_path = args.model_path
    if args.port is not None:
        config.server.port = args.port  # TTS_PORT already applied by load_config
    app = create_app(config)
    aiohttp_web().run_app(app, host=config.server.host, port=config.server.port)
    return 0


def cmd_synth(args: argparse.Namespace) -> int:
    from .audio import stitch
    from .config import load_config
    from .engine import TTSEngine
    from .utils import write_wav

    config = load_config(args.config)
    if args.model_path:
        config.model.model_path = args.model_path
    engine = TTSEngine(config)
    engine.load(warmup=False)
    speaker = None
    if args.voice_wav:
        speaker = engine.embed_voice_file(args.voice_wav)
    t0 = time.time()
    chunks = list(
        engine.synthesize_stream(args.text, speaker=speaker, exaggeration=args.exaggeration)
    )
    wall = time.time() - t0
    audio = stitch(chunks)
    write_wav(args.output, audio, engine.sample_rate)
    secs = len(audio) / engine.sample_rate
    print(
        f"wrote {args.output}: {secs:.2f}s audio in {wall:.2f}s "
        f"({secs / max(wall, 1e-9):.2f}x realtime)",
        file=sys.stderr,
    )
    return 0


def cmd_voices(args: argparse.Namespace) -> int:
    from .config import load_config
    from .service.voice_manager import VoiceManager

    config = load_config(args.config)
    vm = VoiceManager(cache_dir=config.voice_cloning.cache_dir)
    print(json.dumps(vm.list_voices(), indent=2))
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    import torch

    from . import __version__
    from .models import registry

    cuda = torch.cuda.is_available()
    info = {
        "version": __version__,
        # The JAX CLI's key, kept so tools that read it work unchanged.
        "jax_backend": "cuda" if cuda else "cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else ["cpu"],
        "model_families": {
            name: {"kind": f.kind, "description": f.description}
            for name, f in registry.available().items()
        },
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gonova-tts-torch", description="Streaming TTS on PyTorch and CUDA"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("serve", help="run the WS/REST service (needs aiohttp)")
    p.add_argument("--config", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--model-path", default=None, dest="model_path",
                   help="checkpoint: a compact .npz")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("synth", help="offline synthesis to a WAV file")
    p.add_argument("text")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--voice-wav", default=None, help="reference WAV for voice cloning")
    p.add_argument("--exaggeration", type=float, default=0.5)
    p.add_argument("--config", default=None)
    p.add_argument("--model-path", default=None, dest="model_path",
                   help="checkpoint: a compact .npz")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("voices", help="list registered voices")
    p.add_argument("--config", default=None)
    p.set_defaults(fn=cmd_voices)

    p = sub.add_parser("info", help="framework/device info")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
