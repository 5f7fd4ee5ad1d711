"""The control of the comparison that decides `correct`: the reference itself (of
the configuration's model family, `families/<family>.py`), put in the served
program's place and computed in float8 (e4m3, a scale per tensor)
where the configuration serves bfloat16, judged by check.py against the float32
reference exactly as a run judges the served audio. It has to come out not correct.

    python3 tts_bench/control.py --workload <cell> --seeds 11,12,13 [--numerics fp8]

For each seed: the requests the cell's generator sends first (`pool` sentences or
more), their sentences as the reference splits them, the same sample a run draws
(check.sample: `sample` sentences and the longest), and the numbers check.judge
compares, printed as one JSON line per seed. `--numerics fp32` runs the float32
reference against itself (every number 0). The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_seed(cell, seed: int, numerics: str, device: str, pool: int = 60) -> dict:
    import numpy as np

    from tts_bench import check, drive, loadgen, serve, spec

    with tempfile.TemporaryDirectory(prefix="tts_bench_control_") as tmp:
        cfg = serve.port_config(cell, seed, device, tmp)
        gen = loadgen.Generator(cell.mix, seed)
        voices = serve.make_voices(cell, seed)
        family = spec.family(cell)
        ref = family.judge(cfg.model.model_dump(), cfg.engine.model_dump(), cfg.model.model_path, device)
        ctl = family.judge(cfg.model.model_dump(), cfg.engine.model_dump(), cfg.model.model_path, device, numerics)
        loop = spec.loop(cell)
        requests = loop.requests(gen, cell.mix)
        voice_of = check.voice_of(voices, open(cfg.voice_cloning.default_voice_path, "rb").read())

        results, n = [], 0
        t0 = time.perf_counter()
        while n < pool:
            req = next(requests)
            res = drive.Result(req, len(results), 0.0, voice_id=loop.voice_id(req, len(results)))
            key, wav = voice_of(res)
            spk = ref.speaker(key, wav)
            res.parts = [np.rint(ref.speak(s, spk, cell.mix["exaggeration"]) * 32768.0).astype(np.int16)
                         for s in ref.sentences(req.text)]
            results.append(res)
            n += len(res.parts)
        picked = check.sample(results, cell.mix, seed)

        def served_of(res, i):
            key, wav = voice_of(res)
            return ctl.speak(ref.sentences(res.request.text)[i], ctl.speaker(key, wav), cell.mix["exaggeration"])

        numbers, other = check.judge(results, picked, ref, voice_of, cell.mix["exaggeration"], cell.limits, served_of)
    return {"cell": cell.name, "seed": seed, "numerics": numerics, "correct": check.correct(numbers),
            "numbers": numbers, "gap_db": other["gap_db"], "worst": other["worst"], "compared": other["compared"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--numerics", default="fp8", choices=("fp8", "fp32"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from tts_bench import spec

    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read_seed(cell, seed, args.numerics, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
