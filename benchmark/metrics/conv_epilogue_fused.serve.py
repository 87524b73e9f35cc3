"""conv_epilogue_fused.serve: the share of the biased convs whose bias add
and activation ran as one epilogue op (`yololp_torch::bias_act`), from the
program's own counters over the profiled slice: `conv.epilogue_fused` over
`conv.biased`, in percent. Nothing when the program keeps no such
counters."""

from benchmark.program_spans import counters


def read(rec):
    c = counters()
    if not c.get("conv.biased"):
        return None
    return c.get("conv.epilogue_fused", 0) / c["conv.biased"] * 100.0
