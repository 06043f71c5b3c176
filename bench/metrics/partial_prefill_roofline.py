"""Kernels: the dense ``partial_prefill`` kernel's share of its roofline
over the traced stretch, in percent: the least time of each recorded
call (``bench_counts.partial_prefill_cost``, the larger of its
operations at the bf16 peak and its bytes at the HBM bandwidth), summed,
over the device time of its kernels (the tile loop and the split
merge)."""
import bench_counts as K

KERNELS = ("partial_prefill_kernel", "combine_splits_kernel")


def read(r):
    calls = (r.calls or {}).get("partial_prefill")
    if not calls or r.trace is None:
        return None
    spent = r.trace.kernel_seconds(*KERNELS)
    if spent <= 0:
        return None
    need = sum(K.roofline_seconds(*K.partial_prefill_cost(qs, ks, qp, e))
               for qs, ks, qp, e in calls)
    return 100.0 * need / spent
