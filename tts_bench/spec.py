"""Finding a cell's parts by name.

`BENCHMARK.json` at the root of the checkout names the cells and the metrics. Each
part of a cell sits in a file of its own under this folder, found by its name:

  * `workloads/<cell>.json`: the cell: `config`, `traffic`, `chips`, `why`,
    `params` that override the mix's parameters for this cell, and the `limits`
    of the numbers that decide `correct` (check.py);
  * `configs/<config>.json`: a model configuration: the port `Config` fields it
    sets (`model`, `engine`), its checkpoint, the weights the benchmark makes,
    its source and what was cut or assumed, and the model family it belongs to
    (`family`; without the key, `nova`);
  * `families/<family>.py`: what the benchmark knows of a model family, beside the
    port's code of it: `judge(model, engine, checkpoint, device, numerics)` (its
    plain reference, with check.Judge's surface), `pass_ops(m, key)` (the
    operations of a pass trace.py counted), `vocoder_ops(m, b, frames)` and
    `vocoder_bytes(m, b, frames)` (its vocoder's roofline), `VOCODER_FORWARDS` (the
    modules of `gonova_tts_tpu_torch.models` whose `forward` trace.py ranges), and
    optionally `install(svc, probe)` (its own counting, after trace.py's);
  * `traffic/<mix>.json`: a traffic mix: the parameters of its text (`loadgen.py`)
    and of its loop, named by `loop`;
  * `loops/<loop>.py`: how a mix's requests arrive and which entry of the service
    they call: `voice_rates(mix)`, `voice_id(request, index)`, `requests(gen, mix)`
    (the requests in the order a run sends them), `warm(svc, mix, voices)` (set-up),
    `trace_at(gen, mix, t0, w0, seconds)` (where the traced sub-window starts, or
    None) and `run(svc, gen, mix, voices, t0, seconds)` (the window: a `drive.Window`);
  * `weights/<kind>.py`: weights a configuration's `generate` section makes;
  * `metrics/<metric>.py`: the reader of a metric; a name with a dot falls back
    to the reader of its first part (`batch_fill.live` → `metrics/batch_fill.py`).

Adding a cell, a mix, a loop, a configuration, a model family or a metric adds files
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    why: str
    config: dict
    mix: dict  # the mix's parameters, with the cell's overrides applied
    limits: dict  # the limits of the numbers that decide `correct`
    here: str = HERE  # the folder its files were found in
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def reports(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether `cell` reports `metric`: listed in its `workloads`, or, without that
    key, a per-layer metric whose end-to-end metric the cell reports (an end-to-end
    metric without it: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def load_cell(name: str, here: str = HERE, bench: dict = None) -> Cell:
    path = os.path.join(here, "workloads", f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no cell {name!r}: {path} does not exist")
    c = _read(path)
    config = _read(os.path.join(here, "configs", f"{c['config']}.json"))
    mix = dict(_read(os.path.join(here, "traffic", f"{c['traffic']}.json")))
    mix.update(c.get("params", {}))
    cell = Cell(name, c["config"], c["traffic"], int(c["chips"]), c["why"], config, mix, c["limits"], here)
    if bench is not None:
        cell.end_to_end = [m for m in bench["end_to_end"] if reports(m, name, [])]
        e2e = [m["name"] for m in cell.end_to_end]
        cell.per_layer = [m for m in bench["per_layer"] if reports(m, name, e2e)]
    return cell


def module(kind: str, name: str, here: str = HERE):
    """The module `<here>/<kind>/<name>.py`, loaded as a part of this package."""
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} module {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"tts_bench.{kind}.{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: str = HERE):
    """The module that reads `metric` (see the module docstring)."""
    for stem in (metric, metric.split(".")[0]):
        if os.path.isfile(os.path.join(here, "metrics", f"{stem}.py")):
            return module("metrics", stem, here)
    raise KeyError(f"no reader for metric {metric!r} under {here}/metrics")


def loop(cell: Cell):
    """The module of a cell's loop (see the module docstring)."""
    return module("loops", cell.mix["loop"], cell.here)


def family(cell: Cell):
    """The module of the model family a cell's configuration names (see the module
    docstring)."""
    return module("families", cell.config.get("family", "nova"), cell.here)


def names(kind: str, here: str = HERE) -> List[str]:
    """Every name of a kind of file: `workloads`, `configs`, `traffic`, `loops`,
    `families`, `weights`, `metrics`."""
    ext = ".py" if kind in ("metrics", "loops", "families", "weights") else ".json"
    d = os.path.join(here, kind)
    return sorted(f[: -len(ext)] for f in os.listdir(d) if f.endswith(ext) and not f.startswith("_"))


def as_entry(cell_name: str, here: str = HERE) -> Dict:
    """The `workloads` entry of BENCHMARK.json that a cell file stands for."""
    c = _read(os.path.join(here, "workloads", f"{cell_name}.json"))
    return {"name": cell_name, "config": c["config"], "traffic": c["traffic"], "chips": c["chips"], "why": c["why"]}
