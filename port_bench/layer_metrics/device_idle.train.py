"""Share of the traced chunk (and the densify event or capture at its
ends) in which no device operation ran."""
from port_bench.harness.readers import idle


def read(run):
    return idle(run) if run.kind == "train" else None
