"""Engine: wall time of each ``run_iteration`` of the window that ran a
verify batch (the benchmark's own span around the call), their mean."""


def read(r):
    its = [it["end"] - it["start"] for it in r.iterations
           if it["kind"] == "verify"]
    return sum(its) / len(its) if its else None
