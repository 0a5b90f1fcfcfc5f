"""time.sat_share (%): the time probes that returned a schedule over all
time probes, in the compile service's workers over the traced window.

Each ``time.probe`` span of the workers' ``obs`` shards carries its
``outcome`` (``found``, ``exhausted`` when the window is proven empty, or
``timeout`` when the solver's step budget or deadline ran out;
``core/time_smt.py``). None where no probe carries one."""


def read(record):
    outcomes = [e["args"]["outcome"] for e in record.get("obs_events") or []
                if e.get("name") == "time.probe" and e.get("ph") == "X"
                and "outcome" in e.get("args", {})]
    if not outcomes:
        return None
    return 100.0 * outcomes.count("found") / len(outcomes)
