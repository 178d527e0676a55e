"""Set-up seconds on the host clock, from the start of the process to the
opening of the window: torch and the CUDA context, the kernels (built in the
first run of a checkout), the operands every request draws from, and one
request of the cell's shapes."""


def read(run):
    return run.setup_s
