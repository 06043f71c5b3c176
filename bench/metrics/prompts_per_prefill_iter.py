"""Scheduler: prompts admitted by each of the window's prefill
iterations (its ``prefill_done`` events), their mean."""


def read(r):
    its = [it["events"] for it in r.iterations if it["kind"] == "prefill"]
    return sum(its) / len(its) if its else None
