"""service.busy_share (%): how much of the compile service's worker time
went to jobs, in the compile cells' traced run.

The ``job`` spans that ``compile_many``'s workers record (one per kernel, in
their ``obs`` shards) over the workers times each pass's wall time from
submitting the suite to its last result."""


def read(record):
    passes, events = record.get("passes"), record.get("obs_events")
    if not passes or not events:
        return None
    job_s = sum(e["dur"] for e in events if e.get("name") == "job" and e.get("ph") == "X") / 1e6
    capacity_s = sum(record["workers"] * p["compile_s"] for p in passes)
    return 100.0 * job_s / capacity_s if job_s > 0 else None
