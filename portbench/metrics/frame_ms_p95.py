"""frame_ms_p95: the 95th percentile of the latency of every unit of the
window, in ms (host clock from the request to its output on the
device)."""

from portbench.common import percentile


def read(ctx):
    if not ctx.latencies:
        return None
    return 1e3 * percentile(ctx.latencies, 95)
