"""The window's seconds over the stitches it completed."""


def read(run):
    return run.window.seconds_per_call()
