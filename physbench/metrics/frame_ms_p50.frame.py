"""The median frame time of the window: from the call that steps a frame
to its positions on the host (the same frames as ``frame_ms_p95``)."""

LAYER = "driver (driver.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frame_ms_p95"
READS = "the window's frame times"


def read(ctx):
    import statistics
    frames = ctx.get("frame_ms")
    return statistics.median(frames) if frames else None
