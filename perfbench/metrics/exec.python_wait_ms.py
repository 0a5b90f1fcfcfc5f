"""exec.python_wait_ms (ms per batch): device-idle time in which the host ran
the executor's own Python, per batch of the window.

The profiler's idle gaps (``DeviceTrace.idle_s``) are labelled by the
innermost host span or op over each gap's midpoint; this sums the gaps whose
label is one of the port's executor spans (``exec.*`` from
``kernels/ops.py::cgra_run``, ``cgra_sim.*`` from
``kernels/cgra_sim.py::cgra_sim``): table lowering, the call's Python and
the launch. The ``aten`` ops inside those spans are not counted: the host
side of the pageable copies stays under ``aten::copy_``. The executor's
whole idle time by annotation, ops included, is
``spans.read_annotations``' reading. None without device operations, or
where the program has no such spans."""

SPANS = ("exec.", "cgra_sim.")


def read(record):
    dev, batches = record.get("device"), record.get("batches")
    if dev is None or not batches or dev.busy_s <= 0:
        return None
    waits = [s for name, s in dev.idle_s.items() if name.startswith(SPANS)]
    return 1e3 * sum(waits) / batches if waits else None
