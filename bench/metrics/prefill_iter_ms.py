"""Engine: wall time of each ``run_iteration`` of the window that ran a
prefill batch (the benchmark's own span around the call), their mean."""


def read(r):
    its = [it["end"] - it["start"] for it in r.iterations
           if it["kind"] == "prefill"]
    return sum(its) / len(its) if its else None
