"""Command-line interface of the port: serve / synth / bench / train / voices / info.

The counterpart of `gonova_tts_tpu/cli.py`, over the port's modules. The device is
the config file's `model.device` ("cuda" unless the file says "cpu"); `bench` runs
`tools.bench` in process (a module of the package, so an installed wheel has it too)
on CUDA unless `--device cpu`.

    gonova-tts-torch serve [--port 8002]          # or python -m gonova_tts_tpu_torch.cli
    gonova-tts-torch synth "Hello." -o hello.wav [--voice-wav ref.wav]
    gonova-tts-torch bench [--device cpu]
    gonova-tts-torch train --demo-corpus corpus_r3/ --checkpoint-dir ckpts/ --steps 200 [--gan]
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


def cmd_bench(args: argparse.Namespace) -> int:
    from .tools import bench

    return bench.main([] if args.device is None else ["--device", args.device])


def cmd_train(args: argparse.Namespace) -> int:
    from .config import load_config
    from .train.loop import train

    manifest = args.manifest
    resident = args.resident
    if args.demo_corpus and args.manifest:
        # Training on the generated corpus while the user passed their own data
        # would be a surprise: refuse the combination.
        print("--demo-corpus and --manifest are mutually exclusive", file=sys.stderr)
        return 1
    if args.demo_corpus:
        # One-command demo: generate the deterministic formant corpus (variable
        # per-token durations, 2 sentences per speaker held out) if absent, and
        # train device-resident on its training split, alignment learned.
        import os

        from .train.synth_corpus import generate_corpus

        manifest = os.path.join(args.demo_corpus, "manifest_train.txt")
        if not os.path.exists(manifest):
            generate_corpus(args.demo_corpus, variable=True, holdout=2)
        resident = True
    out = train(
        config=load_config(args.config),
        manifest=manifest,
        steps=args.steps,
        batch_size=args.batch_size,
        lr=args.lr,
        warmup=args.warmup,
        checkpoint_dir=args.checkpoint_dir,
        n_data=args.n_data,
        n_model=args.n_model,
        resident=resident,
        chunk=args.chunk,
        history_path=args.history,
        learn_alignment=args.learn_alignment,
        gan=args.gan,
    )
    print(json.dumps(out))
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
                   help="checkpoint: a .npz, or a training root (its newest step)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("synth", help="offline synthesis to a WAV file")
    p.add_argument("text")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--voice-wav", default=None, help="reference WAV for voice cloning")
    p.add_argument("--exaggeration", type=float, default=0.5)
    p.add_argument("--config", default=None)
    p.add_argument("--model-path", default=None, dest="model_path",
                   help="checkpoint: a .npz, or a training root (its newest step)")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("bench", help="run the headline benchmark (tools/bench.py)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("train", help="train the pipeline on one device (see train/loop.py)")
    p.add_argument("--manifest", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--n-data", type=int, default=None)
    p.add_argument("--n-model", type=int, default=1)
    p.add_argument("--config", default=None)
    p.add_argument("--resident", action="store_true",
                   help="device-resident corpus, --chunk steps a call (small corpora)")
    p.add_argument("--chunk", type=int, default=200)
    p.add_argument("--history", default=None, help="append per-interval metrics JSONL")
    p.add_argument("--learn-alignment", dest="learn_alignment", action="store_true",
                   default=None, help="force MAS alignment learning on")
    p.add_argument("--no-learn-alignment", dest="learn_alignment", action="store_false",
                   help="force the uniform-duration bootstrap (default: auto)")
    p.add_argument("--gan", action="store_true",
                   help="adversarial fine-tune of the vocoder (HiFi-GAN objective)")
    p.add_argument("--demo-corpus", default=None, metavar="DIR",
                   help="generate the deterministic formant corpus here (if absent) "
                        "and train device-resident on it")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("voices", help="list registered voices")
    p.add_argument("--config", default=None)
    p.set_defaults(fn=cmd_voices)

    p = sub.add_parser("info", help="framework/device info")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
