"""space.found_share (%): the space probes that found a placement over all
space probes, in the compile service's workers over the traced window.

Each ``space.probe`` span of the workers' ``obs`` shards carries its
``outcome`` (``found``, ``exhausted``, ``node_budget``, ``timeout`` or
``cancelled``; ``core/mapper.py``). None where no probe carries one."""


def read(record):
    outcomes = [e["args"]["outcome"] for e in record.get("obs_events") or []
                if e.get("name") == "space.probe" and e.get("ph") == "X"
                and "outcome" in e.get("args", {})]
    if not outcomes:
        return None
    return 100.0 * outcomes.count("found") / len(outcomes)
