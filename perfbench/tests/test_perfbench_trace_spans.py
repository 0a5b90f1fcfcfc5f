"""The traces' arithmetic on a hand-made profiler trace and hand-made
records: ``trace.read_device_trace``'s sums, ``spans.read_annotations``'
splits by annotation, and what every per-layer metric reads from them."""

from __future__ import annotations

import json

import pytest

from perfbench import harness, spans, trace

US = 1e-6
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, x>"


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


# The window [0, 1000] us. The benchmark's cgra_run holds the program's
# exec.run, which holds exec.inputs (an aten::copy_ inside it), the fill and
# the launch; stores_to_host comes after. Device: busy [200, 240] (HtoD),
# [320, 480] (fill, kernel), [750, 780] (DtoH), [900, 910] (a memset no call
# enqueued); a kernel after the window; gaps [0, 200], [240, 320], [480,
# 750], [780, 900], [910, 1000].
EVENTS = [
    _x("user_annotation", trace.WINDOW_SPAN, 0, 1000),
    _x("user_annotation", "cgra_run", 20, 680),
    _x("user_annotation", "exec.run", 30, 660),
    _x("user_annotation", "exec.inputs", 40, 200),
    _x("cpu_op", "aten::copy_", 50, 190),
    _x("cuda_runtime", "cudaMemcpyAsync", 60, 5, correlation=1),
    _x("user_annotation", "cgra_sim.fill", 300, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 310, 5, correlation=2),
    _x("user_annotation", "cgra_sim.launch", 390, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 400, 5, correlation=3),
    _x("user_annotation", "stores_to_host", 710, 100),
    _x("cuda_runtime", "cudaMemcpyAsync", 720, 5, correlation=4),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200, 40, correlation=1),
    _x("kernel", FILL, 320, 100, correlation=2),
    _x("kernel", "cgra_sim_kernel(int const*)", 420, 60, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 750, 30, correlation=4),
    _x("gpu_memset", "Memset (Device)", 900, 10, correlation=99),
    _x("gpu_user_annotation", "exec.run", 200, 300),
    _x("kernel", "cgra_sim_kernel(int const*)", 1200, 60, correlation=5),
]


@pytest.fixture
def profile_json(tmp_path):
    def write(events):
        path = tmp_path / "profile.json"
        path.write_text(json.dumps({"traceEvents": events}))
        return str(path)
    return write


def test_the_device_trace_sums_are_todays(profile_json):
    dev = trace.read_device_trace(profile_json(EVENTS))
    assert dev.window_s == pytest.approx(1000 * US)
    assert dev.busy_s == pytest.approx(240 * US)
    assert dev.op_s == pytest.approx({
        "Memcpy HtoD (Pageable -> Device)": 40 * US, FILL: 100 * US,
        "cgra_sim_kernel(int const*)": 60 * US,
        "Memcpy DtoH (Device -> Pageable)": 30 * US, "Memset (Device)": 10 * US})
    assert dev.idle_s == pytest.approx({
        "aten::copy_": 200 * US, "exec.run": 350 * US,
        "host, outside any span or op": 210 * US})
    assert dev.htod_s == pytest.approx(40 * US) and dev.htod_count == 1


def test_the_splits_by_annotation(profile_json):
    idle, op_s = spans.read_annotations(profile_json(EVENTS))
    assert idle == pytest.approx({"exec.inputs": 200 * US, "exec.run": 350 * US,
                                  spans.OUTSIDE: 210 * US})
    assert op_s == pytest.approx({
        "exec.inputs": 40 * US, "cgra_sim.fill": 100 * US, "cgra_sim.launch": 60 * US,
        "stores_to_host": 30 * US, "no enqueuing call in the trace": 10 * US})


def test_what_the_exec_metrics_read(profile_json):
    dev = trace.read_device_trace(profile_json(EVENTS))
    record = {"device": dev, "batches": 2, "bound_s": 80 * US}
    want = {"exec.python_wait_ms": 0.175, "exec.h2d_ms": 0.02, "cgra_sim_roofline": 50.0,
            "device.idle": 76.0}
    for name, value in want.items():
        assert harness.read_metric(name, record) == pytest.approx(value), name
    idle = trace.read_device_trace(profile_json(
        [e for e in EVENTS if e["cat"] not in trace.DEVICE_CATS]))
    for name in want:
        assert harness.read_metric(name, {}) is None, name
        assert harness.read_metric(name, {"device": idle, "batches": 2,
                                          "bound_s": 80 * US}) is None, name


def _row(ok, windows, time_s, space_s, nodes):
    return {"ok": ok, "windows_opened": windows, "time_phase_s": time_s,
            "space_phase_s": space_s, "space_nodes_visited": nodes}


def _span(name, dur_s, **args):
    return {"ph": "X", "name": name, "ts": 0, "dur": dur_s * 1e6, "pid": 7, "tid": 1,
            "args": args}


COMPILE = {
    "workers": 2,
    "passes": [
        {"compile_s": 10.0, "jobs": [_row(True, 3, 1.0, 4.0, 1000),
                                     _row(True, 2, 2.0, 1.0, 500)]},
        {"compile_s": 10.0, "jobs": [_row(True, 1, 1.0, 1.0, 500),
                                     _row(False, 9, 0.0, 0.0, 0)]},
    ],
    "obs_events": [
        _span("job", 8.0), _span("job", 6.0),
        _span("space.probe", 1.0, outcome="found"),
        _span("space.probe", 2.0, outcome="timeout"),
        _span("space.probe", 0.5, outcome="node_budget"),
        _span("space.probe", 0.5, outcome="exhausted"),
        _span("space.probe", 9.0, found=False),
        _span("time.probe", 0.25, outcome="found"),
        _span("time.probe", 0.25, outcome="found"),
        _span("time.probe", 1.0, outcome="exhausted"),
        _span("time.probe", 3.0, outcome="timeout"),
    ],
}


def test_what_the_compile_metrics_read():
    want = {"service.busy_share": 35.0, "mapper.windows": 3.0, "time.s": 2.0,
            "space.s": 3.0, "space.nodes_per_s": 2000 / 6, "space.found_share": 25.0,
            "time.sat_share": 50.0}
    for name, value in want.items():
        assert harness.read_metric(name, COMPILE) == pytest.approx(value), name
    # a program whose probes carry no outcome
    bare = {**COMPILE, "obs_events": [
        {**e, "args": {}} for e in COMPILE["obs_events"]]}
    for name in ("space.found_share", "time.sat_share"):
        assert harness.read_metric(name, {}) is None
        assert harness.read_metric(name, bare) is None


def test_probe_outcomes_per_pass():
    split = spans.probe_outcomes(COMPILE["obs_events"], passes=2)
    assert split["space.probe"]["timeout"] == pytest.approx([0.5, 1.0])
    assert split["space.probe"]["none"] == pytest.approx([0.5, 4.5])
    assert split["time.probe"]["found"] == pytest.approx([1.0, 0.25])
