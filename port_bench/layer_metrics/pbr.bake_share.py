"""Share of the window spent baking: the seconds of the program's
`mgh.pbr.bake` phases (`utils/profiling.py::PHASES`, one per camera's
bake, each waiting for the card at its start and its end), the difference
of their totals at the window's ends (set-up bakes too), over the
window's seconds. None where the program keeps no such phase."""


def read(run):
    if run.kind != "train" or not run.extra.get("bakes"):
        return None
    return 100.0 * run.extra["bake_s"] / run.seconds
