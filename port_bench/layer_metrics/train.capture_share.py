"""Share of the window spent in the captured step's graph warm-ups and
captures (`train/graph.py::GraphedTrainStep.record()["capture_s"]`)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return 100.0 * run.capture_s / run.seconds
