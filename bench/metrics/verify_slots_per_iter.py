"""Scheduler: slots packed into each of the window's verify iterations
(``VerificationAwareScheduler.verify_occupancy``), their mean."""


def read(r):
    its = [it["slots"] for it in r.iterations if it["kind"] == "verify"]
    return sum(its) / len(its) if its else None
