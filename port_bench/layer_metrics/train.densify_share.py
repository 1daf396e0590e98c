"""Share of the window spent in the loop's densify events: the seconds of
the program's `mgh.train.densify` phases (`utils/profiling.py::PHASES`,
train/trainer.py::train_loop: capacity growth, the event, the reads of its
counts) over the window's seconds.

`PHASES` is process-wide and the harness reads it once, after the run, not
at the window's start and end. That is the window's share only because a
run drives one `train_loop` in its process, whose first event comes after
set-up's three iterations and whose last comes before the callback that
closes the window. A harness that ran a second loop in the process would
have to take the difference of the totals at the window's end and start.
None where the window holds no event, or where the program keeps no such
counter.
"""
import sys


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    profiling = sys.modules.get("mygauhuman_torch.utils.profiling")
    phases = getattr(profiling, "PHASES", None)
    if phases is None or not phases.counts.get("mgh.train.densify"):
        return None
    return 100.0 * phases.totals["mgh.train.densify"] / run.seconds
