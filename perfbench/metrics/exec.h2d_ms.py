"""exec.h2d_ms (ms per batch): device time of the host-to-device copies
(the profiler's ``Memcpy HtoD`` events) over the window's batches."""


def read(record):
    dev, batches = record.get("device"), record.get("batches")
    if dev is None or not batches or dev.htod_count == 0:
        return None
    return 1e3 * dev.htod_s / batches
