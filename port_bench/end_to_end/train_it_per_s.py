"""Training iterations of the window's fixed stretch over its seconds (graph
captures and densify events inside it count)."""


def read(run):
    return run.units / run.seconds if run.kind == "train" else None
