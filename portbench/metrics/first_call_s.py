"""Seconds of the set-up's first call of the cell's key: eager, every
launch from the host, as a process that stitches once pays it."""


def read(run):
    return run.setup_parts.get("first call")
