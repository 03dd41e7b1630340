"""Seconds of the set-up's second call of the cell's key: the capture of
its program and the program's first replay."""


def read(run):
    return run.setup_parts.get("capture")
