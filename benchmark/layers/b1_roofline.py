"""B1 (the mean-form bisection kernel): the least time its launches'
work needs on an H100 (benchmark/roofline.py, trips from the reference)
over its device time by kernel name in the trace, in percent. Nothing
when the trace holds no B1 time, or when a launched row matched no
reference lane (its work would go uncounted)."""


def read(rec: dict):
    dev = rec.get("trace", {}).get("kernel_s", {}).get("B1", 0.0)
    least = rec.get("least_s", {}).get("B1", 0.0)
    unmatched = rec.get("rows", {}).get("B1", {}).get("unmatched", 0)
    if not dev > 0 or not least > 0 or unmatched:
        return None
    return 100.0 * least / dev
