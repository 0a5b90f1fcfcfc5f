"""mapper.windows (count per pass): (II, slack) windows the portfolio mapper
opened, summed over the suite, per pass; ``CompileResult.trace`` /
``JobReport.windows_opened``."""


def read(record):
    passes = record.get("passes")
    if not passes:
        return None
    return sum(r["windows_opened"] for p in passes for r in p["jobs"] if r["ok"]) / len(passes)
