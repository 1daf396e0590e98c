"""Frames whose image reached host memory inside the window, over its seconds."""


def read(run):
    return run.units / run.seconds if run.kind == "serve" else None
