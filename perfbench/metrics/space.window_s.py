"""space.window_s (s per pass): the seconds of the window engine's searches
on the centred sub-mesh, summed over the suite, per pass.

The ``space.window`` spans of the compile service's workers (their ``obs``
shards), one around each exact search on the window inside a
``space.probe`` (``core/space_backends/window.py``). None where there is
none."""


def read(record):
    passes, events = record.get("passes"), record.get("obs_events")
    if not passes or not events:
        return None
    us = sum(e["dur"] for e in events if e.get("name") == "space.window" and e.get("ph") == "X")
    return us / 1e6 / len(passes) if us > 0 else None
