"""setup_s: seconds from process start to the first timed step (loading,
the nvcc build in a fresh checkout, making the cell, set-up sweeps or
updates and warming the cell's shapes). Host clock."""


def read(run):
    return run["setup_s"]
