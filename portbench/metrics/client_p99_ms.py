"""99th percentile of the window's request latencies as the load generator
saw them (ext_proc frontend and batcher together, from the client)."""

from portbench.stats import percentile


def read(run):
    lat = run.latencies_ms
    return percentile(lat, 99) if lat else None
