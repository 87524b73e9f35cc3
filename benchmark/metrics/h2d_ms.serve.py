"""h2d_ms.serve: device time of the host-to-device copies per batch in the
profiled slice (the uint8 batch that deploy_decode moves to the card)."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    t = sum(v for k, v in tr["memcpy"].items() if "HtoD" in k)
    return t / tr["iters"] * 1e3 if t > 0 else None
