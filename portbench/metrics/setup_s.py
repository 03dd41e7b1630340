"""Set-up seconds: from the process start to the window's start (imports,
card start, inputs, kernel build, every shape's first and second call)."""


def read(run):
    return run.setup_s
