"""Panoramas the window completed over its seconds."""


def read(run):
    return run.window.panoramas_per_second()
