"""space.s (s per pass): the space engine's phase time summed over the
suite, per pass; ``CompileResult.phases.space_s`` / ``JobReport.space_phase_s``."""


def read(record):
    passes = record.get("passes")
    if not passes:
        return None
    return sum(r["space_phase_s"] for p in passes for r in p["jobs"]) / len(passes)
