"""Kernels: the forward ``grouped_mm`` kernel's share of its roofline
over the traced stretch, in percent: the least time of each recorded
call (``bench_counts.grouped_mm_cost``: the rows up to the last group
end, each expert with rows read once), summed, over the device time of
its kernels (the tile walk and the split-K sum)."""
import bench_counts as K

KERNELS = ("grouped_mm",)


def read(r):
    calls = (r.calls or {}).get("grouped_mm")
    if not calls or r.trace is None:
        return None
    spent = r.trace.kernel_seconds(*KERNELS)
    if spent <= 0:
        return None
    need = sum(K.roofline_seconds(*K.grouped_mm_cost(m, k, n, ends, e))
               for m, k, n, ends, e in calls)
    return 100.0 * need / spent
