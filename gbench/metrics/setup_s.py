"""Set-up: from the process's start to the window's first second (the
graph made and ingested, the scheduler built, the warm-up jobs run, and
in a first run the kernels compiled)."""


def read(run):
    return run["setup_s"]
