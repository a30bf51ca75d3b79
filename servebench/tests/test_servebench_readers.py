"""The trace reduction and the per-layer readers on a trace made by hand."""
import pytest

from servebench.core import spec, trace as tr
from servebench.core.counting import H100, bound_of, flash_bound, ssd_bound
from servebench.core.traffic import Call

MS = 1_000_000  # ns


def _records():
    device = [("nvjet_tst_256x128", 0 * MS, 4 * MS),
              ("(anonymous namespace)::flash_tc128_kernel", 3 * MS, 6 * MS),
              ("void at::native::elementwise_kernel<...>", 8 * MS, 9 * MS),
              ("void (anonymous namespace)::ssd_out_kernel<64, 2>",
               9 * MS, 10 * MS),
              ("Memcpy DtoH (Device -> Pageable)", 12 * MS, 13 * MS),
              ("outside the window", 30 * MS, 31 * MS)]
    host = [("servebench.prefill", 0, 11 * MS),
            ("aten::mm", 6 * MS + MS // 2, 7 * MS + MS // 2),
            ("aten::einsum", 5 * MS, 8 * MS),
            ("servebench.first_token", 11 * MS, 14 * MS),
            ("cudaStreamSynchronize", 11 * MS + MS // 2, 14 * MS)]
    return tr.Records((0, 20 * MS), device, host)


def test_busy_time_is_the_union_of_device_records_in_the_window():
    r = _records()
    assert r.busy_intervals() == [(0, 6 * MS), (8 * MS, 10 * MS),
                                  (12 * MS, 13 * MS)]
    assert r.idle_gaps() == [(6 * MS, 8 * MS), (10 * MS, 12 * MS),
                             (13 * MS, 20 * MS)]


def test_idle_time_is_named_by_the_innermost_host_record():
    got = _records().idle_by_host()
    assert got == pytest.approx({"aten::mm": 0.002,
                                 "servebench.first_token": 0.002,
                                 "(no host record)": 0.007})
    assert tr.breakdown(_records())["idle_gaps"][0] == \
        ["(no host record)", pytest.approx(0.007)]


def _view(calls, work):
    return tr.view(_records(), calls, work, H100)


def _work(rows, positions):
    return {"linear_flops": 1e12, "model_flops": 4e12,
            "attention": [(rows, positions, 32, 8, 128, 2)],
            "ssd": [(rows, positions, 80, 1, 64, 64, 256, 3)]}


def test_readers_on_a_trace_made_by_hand():
    v = _view([Call(0, 1, 1000, 24), Call(1, 2, 100, 0)], _work)
    read = {m: spec.load_reader(m).read(v) for m in (
        "device_idle_share", "prefill_mfu", "gemm.peak_share",
        "other_kernels.us_per_token", "flash_attention_roofline",
        "ssd_scan_roofline")}
    assert v.window_s == pytest.approx(0.020)
    assert v.busy_s == pytest.approx(0.009)
    assert read["device_idle_share"] == pytest.approx(55.0)
    assert read["prefill_mfu"] == pytest.approx(
        100 * 8e12 / 0.020 / H100["bf16_flops"])
    assert read["gemm.peak_share"] == pytest.approx(
        100 * 2e12 / 0.004 / H100["bf16_flops"])
    # the elementwise kernel and the copy, over 1024 + 2 x 100 positions
    assert read["other_kernels.us_per_token"] == pytest.approx(2000 / 1224)
    flash = sum(2 * bound_of(*flash_bound(r, s, 32, 8, 128, 2))["bound_ms"]
                for r, s in ((1, 1024), (2, 100)))
    assert read["flash_attention_roofline"] == pytest.approx(
        100 * flash / 3)
    ssd = sum(3 * bound_of(*ssd_bound(r, s, 80, 1, 64, 64, 256, 2)
                           )["bound_ms"] for r, s in ((1, 1024), (2, 100)))
    assert read["ssd_scan_roofline"] == pytest.approx(100 * ssd / 1)


def test_a_reader_with_nothing_to_read_returns_nothing():
    r = tr.Records((0, 10 * MS), [("nvjet", 0, MS)], [])
    v = tr.view(r, [Call(0, 1, 10, 0)], _work, H100)
    assert spec.load_reader("flash_attention_roofline").read(v) is None
    assert spec.load_reader("ssd_scan_roofline").read(v) is None
