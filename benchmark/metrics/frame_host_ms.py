"""frame_host_ms.<cell>: host ms per ``render_frame`` call in the measured
window, around the call alone (no wait inside), averaged over the frames."""

from benchmark.metrics._common import mean


def read(record: dict, work: dict):
    return mean(record.get("frame_host_ms"))
