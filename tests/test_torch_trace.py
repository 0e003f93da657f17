"""The port's spans and counters (``utils/trace.py:span``, the CSS and FET
engines, the MC's range loops) on the CPU: a span times into its
``RunSummary`` stage and opens ``record_function`` only while a profiler
records; every engine and MC span lands in the profiler's chrome trace,
nested as the layers are; tracing changes no output; ``mc_ranges`` and
``mc_perms_run`` are what the ranges run give, and ``h2d_bytes`` counts
an upload once."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from divergence_tpu_torch.config import CssConfig, FetConfig
from divergence_tpu_torch.engine import SnpPair, run_css_multi, run_fet_multi
from divergence_tpu_torch.kernels import perm as kperm
from divergence_tpu_torch.tools.synth import make_panel
from divergence_tpu_torch.utils import trace
from divergence_tpu_torch.utils.summary import RunSummary

REGEND = 15_000
CSS_SPANS = ("css_dispatch", "css_plan", "css_upload", "css_phase1_enqueue",
             "css_phase1_sync", "css_collect", "css_mc", "css_assemble")
MC_SPANS = ("mc_keys", "mc_range", "mc_compact", "mc_fetch")
FET_SPANS = ("fet_dispatch", "fet_plan", "fet_upload", "fet_sync", "fet_scatter")
CFG = CssConfig(mc_runs=2_000, precision="fast")


def _pairs():
    out = {}
    for i, seed in enumerate((1, 2)):
        pos, am, bm = make_panel(300, REGEND, 11, 10, seed=seed)
        out[f"chr{i}"] = (SnpPair(pos, am, bm), REGEND)
    return out


def _annotations(prof, tmp_path) -> dict:
    """name -> [(start, end)] of the trace's user annotations."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return spans


def _inside(inner, outer) -> bool:
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


@pytest.fixture(scope="module")
def css_runs(tmp_path_factory):
    """(outputs, summary) untraced, and (outputs, summary, spans) traced."""
    plain = RunSummary()
    out_plain = run_css_multi(_pairs(), CFG, device="cpu", summary=plain)
    traced = RunSummary()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out_traced = run_css_multi(_pairs(), CFG, device="cpu", summary=traced)
    spans = _annotations(prof, tmp_path_factory.mktemp("css_trace"))
    return (out_plain, plain), (out_traced, traced, spans)


class _CountingRecord:
    calls = 0

    def __init__(self, name):
        type(self).calls += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_without_profiler_times_and_never_records(monkeypatch):
    monkeypatch.setattr(_CountingRecord, "calls", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRecord)
    summary = RunSummary()
    for _ in range(3):
        with trace.span("x_stage", summary):
            pass
        with trace.span("y_stage"):
            pass
    assert _CountingRecord.calls == 0
    assert set(summary.timings_s) == {"x_stage"} and summary.timings_s["x_stage"] > 0.0


def test_span_under_profiler_records_once(monkeypatch):
    monkeypatch.setattr(_CountingRecord, "calls", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRecord)
    summary = RunSummary()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("x_stage", summary):
            pass
    assert _CountingRecord.calls == 1 and "x_stage" in summary.timings_s


def test_span_keeps_the_stage_on_error():
    summary = RunSummary()
    with pytest.raises(KeyError):
        with trace.span("x_stage", summary):
            raise KeyError("x")
    assert "x_stage" in summary.timings_s


def test_css_trace_holds_every_span_nested(css_runs):
    _, (_, summary, spans) = css_runs
    assert set(CSS_SPANS + MC_SPANS) <= set(spans)
    assert len(spans["css_plan"]) == len(spans["css_upload"]) == 2     # a chromosome each
    for name in ("css_plan", "css_upload", "css_phase1_enqueue"):
        assert _inside(spans[name], spans["css_dispatch"]), name
    for name in MC_SPANS:
        assert _inside(spans[name], spans["css_mc"]), name
    assert _inside(spans["mc_compact"], spans["mc_range"])
    assert len(spans["mc_range"]) == summary.counters["mc_ranges"]
    # the engine's spans are its summary's stages
    assert set(CSS_SPANS) == set(summary.timings_s)


def test_outputs_with_and_without_profiler_byte_equal(css_runs):
    (out_plain, plain), (out_traced, traced, _) = css_runs
    assert out_plain.keys() == out_traced.keys()
    for seqid in out_plain:
        for a, b in zip(out_plain[seqid], out_traced[seqid]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert plain.counters == traced.counters
    assert set(plain.timings_s) == set(traced.timings_s)


def test_engine_counters_are_the_ranges_run(monkeypatch):
    """The engine's mc_ranges and mc_perms_run are what ``significance``
    put in its ``ranges=`` list: the ranges, and running windows x chunks
    x chunk summed over them."""
    seen = []
    real = kperm.significance

    def spy(*args, ranges=None, **kw):
        out = real(*args, ranges=ranges, **kw)
        seen.append(list(ranges))
        return out

    monkeypatch.setattr(kperm, "significance", spy)
    summary = RunSummary()
    run_css_multi(_pairs(), CFG, device="cpu", summary=summary)
    (ranges,) = seen
    assert summary.counters["mc_ranges"] == len(ranges) > 1
    assert summary.counters["mc_perms_run"] == sum(
        nk * nact for _, nk, nact in ranges) * CFG.mc_chunk
    assert summary.counters["mc_perms_run"] >= summary.counters["mc_permutations"] > 0


def _mc_inputs(B=24, a=6, b=5, seed=3):
    g = torch.Generator().manual_seed(seed)
    m = a + b
    x = torch.rand((B, m, 2), generator=g, dtype=torch.float64)
    dist = torch.cdist(x, x)
    # observed scores spread over the null, so that windows stop early and late
    scores = torch.linspace(0.0, 0.6, B, dtype=torch.float64).numpy()
    return dist, scores, a, b


def _window_chunks_from(ranges, nsc, chunk):
    """Per window, the chunks of every range it ran in: up to the end of
    the range that holds its last consumed permutation."""
    ends = np.array([k + nk for k, nk, _ in ranges])
    last = (np.asarray(nsc, dtype=np.int64) - 1) // chunk
    return ends[np.searchsorted(ends, last, side="right")]


@pytest.mark.parametrize("chunk", [64, 256])
def test_mc_shared_ranges_on_cpu_tensors(chunk):
    """mc_shared on CPU tensors: its ``ranges=`` list gives the ranges and
    permutations run that each window's stop implies."""
    dist, scores, a, b = _mc_inputs()
    B, m = dist.shape[0], a + b
    key = torch.tensor([7, 11], dtype=torch.int64)
    ranges = []
    nsc, _ = kperm.mc_shared(dist.to(torch.float32).reshape(B, m * m).contiguous(),
                             torch.as_tensor(scores).float(), key, a, b, chunk, 6_000, 10,
                             ranges=ranges)
    assert len(ranges) > 1 and ranges[0][2] == B
    per_window = _window_chunks_from(ranges, nsc.numpy(), chunk)
    assert sum(nk * nact for _, nk, nact in ranges) == int(per_window.sum())
    assert len(ranges) == int(np.searchsorted([k + nk for k, nk, _ in ranges],
                                              per_window.max())) + 1


@pytest.mark.parametrize("stream", ["shared", "window"])
def test_plain_loop_reports_chunks_as_ranges(stream):
    """The CPU's chunk loop: a range of one chunk per chunk, each window
    in every chunk up to the one it stopped in."""
    dist, scores, a, b = _mc_inputs()
    ranges = []
    res = kperm.significance(dist, scores, a, b, 10, 6_000, torch.tensor([7, 11]),
                             chunk=128, stream=stream, ranges=ranges)
    chunks = -(-res.nscores // 128)
    assert [nk for _, nk, _ in ranges] == [1] * len(ranges)
    assert [k for k, _, _ in ranges] == list(range(len(ranges)))
    assert len(ranges) == chunks.max()
    assert sum(nact for _, _, nact in ranges) == chunks.sum()


def test_h2d_bytes_counted_once_per_upload():
    pos, am, bm = make_panel(300, REGEND, 11, 10, seed=1)
    pair = SnpPair(pos, am, bm)
    summary = RunSummary()
    t = pair.to_device("cpu", summary=summary)
    assert summary.counters["h2d_bytes"] == t.nbytes == 300 * 21 * 2     # int16 codes
    assert pair.to_device("cpu", summary=summary) is t
    assert summary.counters["h2d_bytes"] == t.nbytes
    # through the engine: a second call on the same pairs finds them cached
    pairs = {"chr0": (pair, REGEND)}
    run_css_multi(pairs, CFG, device="cpu", summary=summary)
    run_css_multi(pairs, CFG, device="cpu", summary=summary)
    assert summary.counters["h2d_bytes"] == t.nbytes
    fresh = RunSummary()
    run_css_multi(_pairs(), CFG, device="cpu", summary=fresh)
    assert fresh.counters["h2d_bytes"] == 2 * t.nbytes


def test_fet_trace_holds_its_spans(tmp_path):
    summary = RunSummary()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_fet_multi(_pairs(), FetConfig(precision="fast"), device="cpu", summary=summary)
    spans = _annotations(prof, tmp_path)
    assert set(FET_SPANS) <= set(spans)
    for name in ("fet_plan", "fet_upload"):
        assert _inside(spans[name], spans["fet_dispatch"]), name
    assert set(FET_SPANS) <= set(summary.timings_s)
    assert summary.counters["h2d_bytes"] == 2 * 300 * 21 * 2
