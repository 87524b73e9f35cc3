"""idle_share.serve: share of the profiled slice in which no kernel, copy
or memset ran on the card, in percent."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
