"""setup_s: seconds from the process's start to the end of warm-up (imports,
weights and inputs from the seed, the program's set-up, the gate, and the
warm-up of the cell's own shapes, which builds the kernels on a checkout's
first run)."""


def read(rec):
    return rec["setup_s"]
