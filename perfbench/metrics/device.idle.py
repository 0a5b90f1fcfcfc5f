"""device.idle (%): the share of the traced window in which no operation
ran on the device, from the profiler's trace."""


def read(record):
    dev = record.get("device")
    if dev is None or dev.window_s <= 0 or dev.busy_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
