"""residual_fused.serve: the share of the BottleRep shortcuts that joined
their second conv's epilogue pass (the residual form of the op
`yololp_torch::bias_act`, of the kernel csrc/bias_act.cu on the card), from
the program's own counters over the profiled slice: `block.residual_fused` over
`block.residual`, in percent. Nothing when the program keeps no such
counters, or its model has no shortcut BottleRep."""

from benchmark.program_spans import counters


def read(rec):
    c = counters()
    if not c.get("block.residual"):
        return None
    return c.get("block.residual_fused", 0) / c["block.residual"] * 100.0
