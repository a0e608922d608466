"""The streaming core's own inferno_stream_lag_seconds (a load change
observed -> its allocation published): sum / count over the window, ms."""


def read(rec: dict):
    s = rec.get("stream", {})
    if not s.get("lag_count"):
        return None
    return 1e3 * s["lag_sum"] / s["lag_count"]
