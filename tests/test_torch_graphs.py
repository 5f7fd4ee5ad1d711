"""CUDA-graph dispatch of the port's engine (`models/graphs.py`), on the CPU.

On the CPU every pass runs eagerly. The graph path itself is exercised here through
`ReplayGraphs`, a `GraphSet` whose "graph" reruns the captured body and writes its
results into the outputs it returned at capture, as a CUDA graph's replay does:
that holds the engine's plumbing (static inputs, keys, counters, the calls the
benchmark's probe patches) to the eager pass sample for sample without a card. The
card's own tests are in `test_torch_cuda.py`.
"""

import asyncio
import collections

import numpy as np
import pytest
import torch

from gonova_tts_tpu_torch.audio.stft import hann_window, idft_bases
from gonova_tts_tpu_torch.config import Config, EngineConfig, ModelConfig
from gonova_tts_tpu_torch.engine import TTSEngine
from gonova_tts_tpu_torch.models import graphs, layers, tts, vocos
from gonova_tts_tpu_torch.text import text_to_ids

MODEL = dict(
    d_model=64, n_heads=2, d_ff=128, encoder_layers=1, decoder_layers=1, speaker_dim=32,
    upsample_initial_channel=32, vocos_dim=128, vocos_ff=256, vocos_layers=2,
    compute_dtype="float32", device="cpu",
)
ENGINE = dict(
    token_buckets=[32, 64, 128], batch_buckets=[1, 4], max_batch=4, batch_window_ms=5.0,
    stream_chunk_frames=24, stream_context_frames=12, warmup_shapes=[[1, 32], [4, 32]],
    vocode_frame_buckets=[128, 192],
)
TEXTS = ["Hello there world.", "A second one here.", "Third one.", "Four."]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    torch.set_num_threads(1)


def _config(model=None, engine=None) -> Config:
    cfg = Config()
    cfg.model = ModelConfig(**{**MODEL, **(model or {})})
    cfg.engine = EngineConfig(**{**ENGINE, **(engine or {})})
    cfg.logging.level = "WARNING"
    return cfg


class _Replay:
    """A stand-in for a captured CUDA graph: `replay` reruns the body and writes its
    results into the tensors the capture returned."""

    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        new = self.fn()
        pairs = [(self.out[k], new[k]) for k in self.out] if isinstance(self.out, dict) else [(self.out, new)]
        for static, fresh in pairs:
            static.copy_(fresh)
        self.replays += 1


class _Done:
    """A stand-in for the event recorded after a replay: a replay on the CPU has
    ended when it returns. `log` gets ("wait", n) for each wait on the n-th."""

    def __init__(self, log, n):
        self.log, self.n = log, n

    def synchronize(self):
        self.log.append(("wait", self.n))


class ReplayGraphs(graphs.GraphSet):
    def __init__(self, device):  # no CUDA pool or stream
        self.device, self.graphs = device, {}
        self.capturing = self.open = False
        self.replayed = self.eager = 0
        self.side_streams = 0
        self._queued, self.log = collections.deque(), []

    def _mark(self):
        self.log.append(("replay", len([e for e in self.log if e[0] == "replay"])))
        return _Done(self.log, self.log[-1][1])

    def side_stream(self):
        self.side_streams += 1
        return torch.no_grad()

    def capture(self, name, fn):
        self.open = True
        try:
            out = fn()
        finally:
            self.open = False
        for t in out.values() if isinstance(out, dict) else [out]:
            t.fill_(float("nan")) if t.is_floating_point() else t.fill_(-7)  # a capture computes nothing
        return _Replay(fn, out), out


def _engines(model=None, engine=None):
    """(an engine with replayed graphs, an eager engine), one set of weights."""
    cfg = _config(model, engine)
    graphed = TTSEngine(cfg, device="cpu")
    graphed.load(warmup=False)
    graphed._graphs = ReplayGraphs(graphed.device)
    graphed.warmup()
    eager = TTSEngine(_config(model, engine), device="cpu")
    eager.load(warmup=False)
    eager.params = graphed.params
    return graphed, eager


@pytest.fixture(scope="module")
def pair():
    return _engines()


# ---------------------------------------------------------------- device constants


@pytest.mark.parametrize("n_fft", [64, 1024])
def test_synthesis_bases_equal_the_numpy_build_bit_for_bit_once_per_key(n_fft):
    icos, isin = idft_bases(n_fft)
    want = torch.as_tensor(np.concatenate([icos, -isin], axis=0) * hann_window(n_fft)[None, :])
    with torch.inference_mode():
        got = vocos.synthesis_bases(n_fft, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert vocos.synthesis_bases(n_fft, torch.device("cpu")) is got
    assert not got.is_inference()  # a later training pass may save it for backward


@pytest.mark.parametrize("length,dim", [(32, 64), (192, 256), (7, 10)])
def test_position_table_equals_the_numpy_build_bit_for_bit_once_per_key(length, dim):
    want = torch.as_tensor(layers.sinusoidal_positions(length, dim))
    got = layers.positions_on(length, dim, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert layers.positions_on(length, dim, "cpu") is got
    assert layers.positions_on(length + 1, dim, "cpu") is not got


def test_a_pass_copies_no_host_constant(pair, monkeypatch):
    """After warm-up, a pass builds neither table from numpy again."""
    graphed, _ = pair
    calls = []
    real = layers.sinusoidal_positions
    monkeypatch.setattr(layers, "sinusoidal_positions", lambda *a, **k: calls.append(a) or real(*a, **k))
    monkeypatch.setattr(vocos, "idft_bases", lambda *a, **k: calls.append(a) or idft_bases(*a, **k))
    graphed.synthesize_batch(TEXTS[:1])
    assert calls == []


# ---------------------------------------------------------------- the CPU engine


def test_on_the_cpu_every_pass_is_eager():
    eng = TTSEngine(_config(), device="cpu")
    eng.load(warmup=True)
    assert eng._graphs is None
    eng.synthesize_batch(TEXTS[:1])
    eng.synthesize_batch(TEXTS[:3])
    stats = eng.get_stats()
    assert stats["graph_passes"] == 0 and stats["eager_passes"] == 2 and stats["graphs_captured"] == 0


def test_stats_and_prometheus_carry_the_graph_counters(tmp_path):
    from gonova_tts_tpu_torch.service.server import TTSService

    cfg = _config()
    cfg.voice_cloning.cache_dir = str(tmp_path / "voices")
    cfg.voice_cloning.default_voice_path = None

    async def run():
        svc = TTSService(cfg)
        await svc.start()
        try:
            await svc.synthesize_full(TEXTS[0])
            return svc.synthesizer.engine.get_stats(), svc.metrics_prometheus()
        finally:
            await svc.shutdown()

    stats, text = asyncio.run(run())
    assert {"graph_passes", "eager_passes", "graphs_captured"} <= set(stats)
    assert stats["eager_passes"] >= 1 and stats["graph_passes"] == 0
    for key in ("graph_passes", "eager_passes"):
        assert f"# TYPE gonova_tts_engine_{key} counter" in text
    assert "# TYPE gonova_tts_engine_graphs_captured gauge" in text
    assert f"gonova_tts_engine_eager_passes {stats['eager_passes']}" in text
    assert "gonova_tts_engine_graphs_captured 0" in text


@pytest.mark.parametrize("replayed", [False, True])
def test_the_engine_pass_span_says_whether_it_replayed(pair, replayed):
    graphed, eager = pair
    eng = graphed if replayed else eager
    eng.tracer.on = True
    try:
        eng.synthesize_batch(TEXTS[:1])
        (span,) = [s for s in eng.tracer.spans() if s.name == "engine.pass"][-1:]
    finally:
        eng.tracer.on = False
    assert span.attrs["graphed"] is replayed


# ---------------------------------------------------------------- the graph path, replayed on the CPU


def test_warmup_captures_every_shape_after_an_eager_prime(pair):
    graphed, _ = pair
    # per batch: the encode, and the decode and the vocoder at 128, 192 and 256 frames
    assert graphed.get_stats()["graphs_captured"] == len(graphed._graphs) == 2 * (1 + 2 * 3)
    assert graphed._graphs.side_streams == 1
    assert set(graphed._staged) == {(1, 32), (4, 32)}
    names = sorted({key[0] for key in graphed._graphs.graphs})
    assert names == ["acoustic.decode", "acoustic.encode", "vocos.forward"]


@pytest.mark.parametrize("texts", [TEXTS[:1], TEXTS[:2], TEXTS, TEXTS[2:3]])
def test_replayed_passes_equal_the_eager_pass_sample_for_sample(pair, texts):
    graphed, eager = pair
    before = dict(graphed.stats)
    got = graphed.synthesize_batch(texts, exaggerations=[0.3] * len(texts))
    want = eager.synthesize_batch(texts, exaggerations=[0.3] * len(texts))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert graphed.stats["graph_passes"] == before["graph_passes"] + 1
    assert graphed.stats["eager_passes"] == before["eager_passes"]
    assert graphed.stats["graphs_captured"] == before["graphs_captured"]


def test_an_unwarmed_shape_runs_eagerly_and_counts_so(pair):
    graphed, eager = pair
    captured = len(graphed._graphs)
    long_text = " ".join(["word"] * 30)  # past 32 tokens: a bucket not warmed
    before = graphed.stats["eager_passes"]
    got = graphed.synthesize_batch([long_text])
    assert np.array_equal(got[0], eager.synthesize_batch([long_text])[0])
    assert graphed.stats["eager_passes"] == before + 1
    assert len(graphed._graphs) == captured == graphed.get_stats()["graphs_captured"]
    assert set(graphed._staged) == {(1, 32), (4, 32)}


def test_replays_go_through_the_calls_the_benchmark_probe_patches(pair, monkeypatch):
    """The probe counts passes at `tts.encode_acoustic` / `decode_vocode` and ranges
    the vocoder's `forward`: a replayed pass still makes each of those calls."""
    graphed, _ = pair
    seen = []
    for mod, name in ((tts, "encode_acoustic"), (tts, "decode_vocode"), (vocos, "forward")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: seen.append(_n) or _r(*a, **k))
    before = graphed.stats["graph_passes"]
    graphed.synthesize_batch(TEXTS[:2])
    assert seen == ["encode_acoustic", "decode_vocode", "forward"]
    assert graphed.stats["graph_passes"] == before + 1


def test_streaming_stays_eager_and_matches_the_one_shot_pass(pair):
    graphed, _ = pair
    replays = graphed._graphs.replayed
    passes = dict(graphed.stats)
    streamed = np.concatenate(list(graphed.synthesize_stream(TEXTS[0])))
    assert graphed.stats["graph_passes"] == passes["graph_passes"]
    assert graphed._graphs.replayed == replays
    one_shot = graphed.synthesize_batch([TEXTS[0]])[0]
    assert streamed.shape == one_shot.shape
    assert float(np.abs(streamed - one_shot).max()) <= 2.5 / 32768


def test_the_hifigan_family_replays_its_forward():
    graphed, eager = _engines(model=dict(vocoder_family="hifigan"), engine=dict(warmup_shapes=[[1, 32]]))
    assert "vocoder_folded.forward" in {key[0] for key in graphed._graphs.graphs}
    got = graphed.synthesize_batch(TEXTS[:1])[0]
    assert np.array_equal(got, eager.synthesize_batch(TEXTS[:1])[0])
    assert graphed.stats["graph_passes"] == 1


def test_no_active_set_or_autograd_runs_the_body_eagerly():
    calls = []
    fn = lambda: calls.append(1) or torch.ones(2)  # noqa: E731
    assert torch.equal(graphs.run("f", fn, None, ()), torch.ones(2))
    gs = ReplayGraphs(torch.device("cpu"))
    with graphs.active(gs, capture=True):
        with torch.enable_grad():
            graphs.run("f", fn, None, ())
    assert len(calls) == 2 and len(gs) == 0 and gs.eager == 0
    with torch.no_grad(), graphs.active(gs, capture=True):
        graphs.run("f", fn, None, ())
    assert len(gs) == 1


def test_one_vocoder_graph_serves_a_frame_bucket_from_every_token_bucket():
    graphed, eager = _engines(engine=dict(warmup_shapes=[[1, 32], [1, 64]]))
    keys = graphed._graphs.graphs
    # frame buckets 128, 192, 256 at 32 tokens and 128, 192, 512 at 64
    assert sum(k[0] == "vocos.forward" for k in keys) == 4
    assert sum(k[0] == "acoustic.decode" for k in keys) == 6 and len(keys) == 12
    texts = ["Hello there world.", " ".join(["word"] * 8)]
    assert len(text_to_ids(texts[0])) <= 32 < len(text_to_ids(texts[1])) <= 64
    for text in texts + texts[::-1]:
        assert np.array_equal(graphed.synthesize_batch([text])[0], eager.synthesize_batch([text])[0])
    assert graphed.stats["graph_passes"] == 4 and graphed.stats["eager_passes"] == 0


def test_inputs_that_lie_elsewhere_are_copied_into_the_graph(pair):
    """A caller's own tensors of a captured shape replay that graph, read in place."""
    graphed, eager = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 200, size=(4, 32)).astype(np.int32)
    args = [torch.as_tensor(a) for a in (tokens, np.ones((4, 32), np.float32),
                                         rng.standard_normal((4, 32)).astype(np.float32), np.zeros(4, np.float32))]
    with torch.inference_mode():
        want = tts.encode_acoustic(eager.params, *args, eager.mcfg, torch.float32)
        with graphs.active(graphed._graphs) as gs:
            got = tts.encode_acoustic(graphed.params, *args, graphed.mcfg, torch.float32)
    assert gs.replayed == 1 and gs.eager == 0
    assert got["enc"].data_ptr() != want["enc"].data_ptr()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_a_replay_runs_inside_a_profiler_op_under_the_callers_range(pair):
    """The benchmark's probe reads the device time of the kernels inside its
    `record_function` range around the vocoder; a replay opens an op there
    (`graph:vocos.forward`) for the replayed kernels to be attributed to."""
    from torch.profiler import ProfilerActivity, profile, record_function

    graphed, _ = pair
    with torch.inference_mode(), graphs.active(graphed._graphs):
        args = graphed._shards(*graphed._zeros(1, 32))[0][1]
        e = tts.encode_acoustic(graphed.params, *args, graphed.mcfg, torch.float32)
        d = tts.acoustic.decode(graphed.params["acoustic"], e["enc"], e["spk"], e["durations"], args[1], 128,
                                graphed.mcfg, torch.float32, local_attention_from=256)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("probe.vocoder"):
                vocos.forward(graphed.params["vocoder"], d["mel"], graphed.mcfg, torch.float32)
    (op,) = [ev for ev in prof.events() if ev.name == "graph:vocos.forward"]
    assert op.cpu_parent is not None and op.cpu_parent.name == "probe.vocoder"


class _Silent:
    def replay(self):
        pass


class SilentGraphs(ReplayGraphs):
    """A capture runs the body once and a replay runs nothing, as on the card."""

    def capture(self, name, fn):
        return _Silent(), fn()


def test_replays_count_the_hand_kernels_launches_and_captures_do_not():
    from gonova_tts_tpu_torch import ops

    counter = ops.counter("transformer_stack")

    def body():  # two launches of the stack kernel, as the wrapper counts them
        counter.count += 2
        return torch.zeros(1)

    gs = SilentGraphs(torch.device("cpu"))
    start = counter.count
    with torch.no_grad():
        with graphs.active(gs, capture=True):
            graphs.run("f", body, None, ())
        assert counter.count == start
        for _ in range(3):
            with graphs.active(gs):
                graphs.run("f", body, None, ())
    assert counter.count == start + 6 and gs.replayed == 1


@pytest.mark.parametrize("queued", [1, 3])
def test_a_set_waits_for_its_oldest_unfinished_replay_before_it_launches_more(queued, monkeypatch):
    """At most `graphs.QUEUED` replays of a set are unfinished: a long run of replays
    (F5's Euler steps) never fills the card's command buffer, where a launch blocks."""
    monkeypatch.setattr(graphs, "QUEUED", queued)
    gs = SilentGraphs(torch.device("cpu"))
    with torch.no_grad():
        with graphs.active(gs, capture=True):
            graphs.run("f", lambda: torch.zeros(1), None, ())
        with graphs.active(gs):
            for _ in range(5):
                graphs.run("f", lambda: torch.zeros(1), None, ())
    want = []
    for k in range(5):
        if k >= queued:
            want.append(("wait", k - queued))
        want.append(("replay", k))
    assert gs.log == want and len(gs._queued) == queued


def test_a_profiler_that_starts_during_a_replay_fails_no_pass(pair):
    """A traced window may open while a replay's launch is under way (the profiler is
    started from another thread): the replay's profiler op is opened only while a
    profiler records, so its close finds what its open found, and the pass serves."""
    from torch.profiler import ProfilerActivity, profile

    graphed, eager = pair
    started = []

    class StartsAProfiler(_Replay):
        def replay(self):
            if not started:
                started.append(profile(activities=[ProfilerActivity.CPU]))
                started[0].__enter__()
            super().replay()

    table = graphed._graphs.graphs
    saved = dict(table)
    for key, (graph, inputs, out, launches) in saved.items():
        table[key] = (StartsAProfiler(graph.fn, graph.out), inputs, out, launches)
    try:
        got = graphed.synthesize_batch(TEXTS[:1])
    finally:
        table.update(saved)
        if started:
            started[0].__exit__(None, None, None)
    assert started and np.array_equal(got[0], eager.synthesize_batch(TEXTS[:1])[0])
