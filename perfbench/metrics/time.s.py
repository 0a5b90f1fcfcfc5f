"""time.s (s per pass): the time backends' phase time summed over the
suite, per pass; ``CompileResult.phases.time_s`` / ``JobReport.time_phase_s``."""


def read(record):
    passes = record.get("passes")
    if not passes:
        return None
    return sum(r["time_phase_s"] for p in passes for r in p["jobs"]) / len(passes)
