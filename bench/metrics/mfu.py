"""Model step: the useful operations of the window's iterations (every
real token through the configured layers, its attention at its context,
and the head, counted by ``bench_counts.model_flops``) over the
window's seconds at the H100's bf16 peak, in percent.  A run with no
device trace (on the CPU) reports none: the peak is the card's."""
import bench_counts as K


def read(r):
    if not r.useful_flops or r.trace is None:
        return None
    return 100.0 * r.useful_flops / (r.window_s * K.PEAK_BF16_FLOPS)
