"""CUDA-graph launches (``cudaGraphLaunch*`` runtime calls, on any thread)
a request inside the program's range ``nmrf::predict``, from the traced
requests: how many graphs replay a request's forward.  0 where the forward
runs eagerly."""

import bisect

from benchmark import arith, spans

RANGE = "nmrf::predict"
GRAPH_LAUNCH = "cudaGraphLaunch"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device:
        return None
    found = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in spans.ranges(rec["trace"], (RANGE,)))
    if not found:
        return None
    starts = [a for a, _ in found]
    count = 0
    for e in rec["trace"].events:
        if e.get("cat") in arith.LAUNCH_CATS \
                and e["name"].startswith(GRAPH_LAUNCH):
            i = bisect.bisect_right(starts, float(e["ts"])) - 1
            count += i >= 0 and float(e["ts"]) <= found[i][1]
    return count / rec["traced_frames"]
