"""The program's spans read from a profile made by hand
(``servebench/core/spans.py``): kernels put down to the span that launched
them through the correlation id, the five readings and the two breakdown
entries by hand, and the harness's own reading of the trace untouched by
the spans."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from servebench.core import spans, spec, trace as tr
from servebench.core.counting import H100
from servebench.core.traffic import Call

MS = 1_000_000  # ns
HOST, CUDA = DeviceType.CPU, DeviceType.CUDA
THREAD = 7


def _event(name, start, end, device=HOST, corr=0, annotation=False,
           thread=THREAD):
    return SimpleNamespace(
        name=name, start_ns=int(start), duration_ns=int(end - start),
        device_type=device, is_user_annotation=annotation,
        correlation_id=corr, start_thread_id=thread)


SPANS = [("repro.prefill", 0.5, 10.5), ("repro.layer", 1.1, 5),
         ("repro.rms_norm", 1.2, 2), ("repro.mlp.gate", 3, 4),
         ("repro.layer", 5, 9), ("repro.rope", 6, 7),
         ("repro.logits", 9.2, 10.2)]
# (correlation id, the call's start, its kernel's start and end), in ms
LAUNCHES = [(11, 1.5, 2, 3),       # in rms_norm; runs after it closed
            (12, 3.5, 4, 5),       # in the gating; runs after it closed
            (13, 4.5, 5, 6),       # the first layer's own
            (14, 6.5, 7.5, 8),     # in RoPE; runs after it closed
            (15, 8, 8.5, 9),       # the second layer's own
            (16, 9.5, 10, 10.5),   # in the logits, after the layers
            (17, 12, 13, 14)]      # outside every span


def _events(with_spans=True):
    out = [_event(tr.SPAN, 0, 20 * MS),
           _event("servebench.prefill", 0, 11 * MS),
           _event("servebench.first_token", 11 * MS, 14 * MS),
           # an ATen op whose own correlation id is a kernel's number
           _event("aten::mul", 3.2 * MS, 3.8 * MS, corr=12),
           _event(tr.SPIN, -2 * MS, -1 * MS, device=CUDA, corr=99),
           # the device-side copy of a span the profiler draws
           _event("repro.layer", 2 * MS, 6 * MS, device=CUDA,
                  annotation=True)]
    for corr, call, start, end in LAUNCHES:
        name = "cuLaunchKernel" if corr == 16 else "cudaLaunchKernel"
        out.append(_event(name, call * MS, call * MS + 50_000, corr=corr))
        out.append(_event(f"kernel_{corr}", start * MS, end * MS,
                          device=CUDA, corr=corr))
    if with_spans:
        out += [_event(n, s * MS, e * MS) for n, s, e in SPANS]
    return out


def _tracer_records(events):
    """The harness's own reading of the same profile."""
    fake = SimpleNamespace(prof=SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events))))
    return tr.Tracer.records(fake)


def test_collect_keeps_the_harness_records_and_links_each_kernel():
    st = spans.collect(_events())
    harness = _tracer_records(_events())
    assert st.records.window == harness.window
    assert st.records.device == harness.device
    assert st.records.host == [r for r in harness.host
                               if not r[0].startswith("repro.")]
    assert st.launch == [11, 12, 13, 14, 15, 16, 17]
    assert st.calls[12] == (3.5 * MS, THREAD)     # the call, not aten::mul
    assert sorted(s[0] for s in st.spans) == sorted(n for n, _, _ in SPANS)


def test_a_kernel_counts_to_the_span_that_launched_it():
    seconds, counts = spans.collect(_events()).device_by_span()
    assert seconds == pytest.approx({
        "repro.rms_norm": 0.001, "repro.mlp.gate": 0.001,
        "repro.layer": 0.0015, "repro.rope": 0.0005,
        "repro.logits": 0.0005, spans.NO_SPAN: 0.001})
    assert counts == {"repro.rms_norm": 1, "repro.mlp.gate": 1,
                      "repro.layer": 2, "repro.rope": 1,
                      "repro.logits": 1, spans.NO_SPAN: 1}
    gated, _ = spans.collect(_events()).device_by_span(
        lambda n: n in ("kernel_12", "kernel_17"))
    assert gated == pytest.approx({"repro.mlp.gate": 0.001,
                                   spans.NO_SPAN: 0.001})
    # every device second is someone's: the spans' plus the rest
    assert sum(seconds.values()) == pytest.approx(
        sum(spans.collect(_events()).records.kernel_seconds().values()))


def test_a_launch_on_another_thread_is_not_in_this_threads_spans():
    events = _events()
    for e in events:
        if e.name == "cudaLaunchKernel" and e.correlation_id == 11:
            e.start_thread_id = THREAD + 1
    seconds, _ = spans.collect(events).device_by_span()
    assert "repro.rms_norm" not in seconds
    assert seconds[spans.NO_SPAN] == pytest.approx(0.002)


def test_the_readings_by_hand():
    st = spans.collect(_events())
    got = spans.readings(st, positions=1000)
    assert got == pytest.approx({
        "rms_norm.us_per_token": 1.0, "rope.us_per_token": 0.5,
        "mlp_gate.us_per_token": 1.0,
        # idle inside the prefill: 0.5-2, 3-4, 6-7.5, 8-8.5 and 9-10 ms
        # of 20
        "prefill.idle_share": 100 * 5.5 / 20,
        # kernels 11-15 under the two layers; 16 after them
        "layer.launches": 2.5})


def test_idle_gaps_are_named_by_the_innermost_span_else_as_before():
    got = spans.breakdown(spans.collect(_events()))
    assert dict((k, v) for k, v in got["idle_by_span"]) == pytest.approx({
        "repro.prefill": 0.002, "repro.logits": 0.001, "repro.mlp.gate": 0.001,
        "repro.rope": 0.0015, "repro.layer": 0.0005,
        "servebench.first_token": 0.0025, "(no host record)": 0.006})
    assert got["device_by_span"][0] == ["repro.layer", pytest.approx(0.0015)]


def _work(rows, positions):
    return {"linear_flops": 1e12, "model_flops": 4e12,
            "attention": [(rows, positions, 32, 8, 128, 2)],
            "ssd": [(rows, positions, 80, 1, 64, 64, 256, 3)]}


def _readers(records):
    view = tr.view(records, [Call(0, 1, 100, 24)], _work, H100)
    return {m: spec.load_reader(m).read(view) for m in (
        "device_idle_share", "prefill_mfu", "gemm.peak_share",
        "other_kernels.us_per_token", "flash_attention_roofline")}


def test_the_spans_leave_the_harness_reading_as_it_was():
    bare = spans.collect(_events(with_spans=False))
    spanned = spans.collect(_events())
    assert bare.records == _tracer_records(_events(with_spans=False))
    assert spanned.records == bare.records
    assert tr.breakdown(spanned.records) == tr.breakdown(bare.records)
    assert _readers(spanned.records) == _readers(bare.records)
    # the harness as it stands keeps the spans among its host records: its
    # metrics and its device operations read the same
    harness = _tracer_records(_events())
    assert _readers(harness) == _readers(bare.records)
    assert tr.breakdown(harness)["device_ops"] == \
        tr.breakdown(bare.records)["device_ops"]


def test_with_no_spans_there_is_nothing_to_read():
    st = spans.collect(_events(with_spans=False))
    assert spans.readings(st, positions=1000) == {}
    got = spans.breakdown(st)
    assert got["idle_by_span"] == tr.breakdown(st.records)["idle_gaps"]
    assert got["device_by_span"] == [[spans.NO_SPAN, pytest.approx(0.0055)]]
