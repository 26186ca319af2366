"""The 95th percentile of the latencies of all requests completed in the
window (host clock around each ``predict`` call)."""

from benchmark import arith


def read(rec):
    lat = rec.get("latencies_ms")
    return arith.percentile(lat, 95) if lat else None
